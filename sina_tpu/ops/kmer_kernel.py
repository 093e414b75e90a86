"""Batched k-mer scoring: S[b, s] = Σ_l P[kmer[b, l], s].

This is the famfinder hot loop (/root/reference/src/kmer_search.cpp:
366-420 + idset.h:315-337) recast as an embedding-bag gather-sum over a
device-resident incidence matrix, in plain jax (lax.scan over k-mer
chunks): ``kmer_scores_packed_xla`` over the bitpacked matrix the
pipeline uses, ``kmer_scores_xla`` over the dense int8 matrix.  The
scan is a byte-bound gather: per batch it reads B x L x row-bytes.

Invalid/padding k-mer slots must point at the all-zero final row of P.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("chunk",))
def kmer_scores_xla(P, kmers, chunk: int = 32):
    """P: (R+1, S) int8; kmers: (B, L) int32 -> (B, S) int32."""
    B, L = kmers.shape
    S = P.shape[1]
    pad = (-L) % chunk
    kmers = jnp.pad(kmers, ((0, 0), (0, pad)), constant_values=P.shape[0] - 1)
    nchunks = (L + pad) // chunk
    kc = kmers.reshape(B, nchunks, chunk).transpose(1, 0, 2)

    def step(acc, kk):
        rows = jnp.take(P, kk, axis=0).astype(jnp.int32)  # (B, chunk, S)
        return acc + rows.sum(axis=1), None

    # derive the carry from both inputs so its varying-manual-axes
    # match under shard_map (jax vma rules for scan carries)
    acc0 = (
        jnp.zeros((B, S), dtype=jnp.int32)
        + (kmers[:, :1] * 0)
        + (P[:1, :1].astype(jnp.int32) * 0)
    )
    acc, _ = jax.lax.scan(step, acc0, kc)
    return acc


@functools.partial(jax.jit, static_argnames=("chunk",))
def kmer_scores_packed_xla(Pp, kmers, chunk: int = 32):
    """Bitpacked scoring: Pp (R+1, Sb) uint8 (bit b of byte j =
    sequence 8j+b, KmerIndex.dense_packed) -> scores (B, Sb*8)
    int32."""
    B, L = kmers.shape
    Sb = Pp.shape[1]
    pad = (-L) % chunk
    kmers = jnp.pad(
        kmers, ((0, 0), (0, pad)), constant_values=Pp.shape[0] - 1
    )
    nchunks = (L + pad) // chunk
    kc = kmers.reshape(B, nchunks, chunk).transpose(1, 0, 2)
    bitw = jnp.arange(8, dtype=jnp.uint8)

    def step(acc, kk):
        rows = jnp.take(Pp, kk, axis=0)          # (B, chunk, Sb) u8
        bits = (rows[..., None] >> bitw) & jnp.uint8(1)
        return acc + bits.astype(jnp.int32).sum(axis=1), None

    acc0 = (
        jnp.zeros((B, Sb, 8), dtype=jnp.int32)
        + (kmers[:, :1, None] * 0)
        + (Pp[:1, :1, None].astype(jnp.int32) * 0)
    )
    acc, _ = jax.lax.scan(step, acc0, kc)
    return acc.reshape(B, Sb * 8)


def kmer_scores(P, kmers):
    """Dispatch on matrix layout: uint8 = bitpacked, int8 = dense."""
    if P.dtype == jnp.uint8:
        return kmer_scores_packed_xla(P, kmers)
    return kmer_scores_xla(P, kmers)


def grouped_top_k(scores, k_top: int, c_groups: int | None = None):
    """EXACT top-k over (B, S) via a group-max hierarchy: per-8
    group maxima -> top `c_groups` groups -> top-k within their 8*C
    members.  With c_groups >= k_top the top-k VALUES are provably
    exact: at most k-1 groups can have a maximum above the k-th
    score, so the true top-k always fit inside the selected groups
    (ties at the k-th value resolve by group rank instead of lowest
    id).  lax.top_k over the full 100k+ sequence axis is a large
    fraction of the famfinder step at SILVA scale; this runs it over
    an 8x smaller axis plus a k-sized cleanup."""
    B, S = scores.shape
    Sb = S // 8
    C = c_groups if c_groups is not None else max(k_top, 256)
    C = min(C, Sb)
    if S % 8 or C * 8 * 2 >= S:  # little to gain: plain top-k
        return jax.lax.top_k(scores, min(k_top, S))
    g = scores.reshape(B, Sb, 8)
    gm = g.max(axis=2)
    _, cand = jax.lax.top_k(gm, C)
    sub = jnp.take_along_axis(g, cand[:, :, None], axis=1)
    vals, sel = jax.lax.top_k(
        sub.reshape(B, C * 8), min(k_top, C * 8)
    )
    ids = (
        jnp.take_along_axis(cand, sel // 8, axis=1) * 8 + sel % 8
    )
    return vals, ids


@functools.partial(jax.jit, static_argnames=("k",))
def top_k_scores(scores, k: int):
    """Per-query top-k: returns (values, indices) sorted descending.

    Tie-break deviates from the reference (which prefers higher ids,
    kmer_search.cpp:412): lax.top_k prefers lower indices.
    """
    return jax.lax.top_k(scores, k)
