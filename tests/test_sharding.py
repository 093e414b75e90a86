"""Multi-device sharding tests on the 8-virtual-CPU-device mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sina_tpu import testing
from sina_tpu.ops.kmer import query_kmers_padded
from sina_tpu.ops.kmer_index import KmerIndex
from sina_tpu.ops.kmer_kernel import kmer_scores_xla
from sina_tpu.parallel.sharding import (
    make_mesh, sharded_search, shard_index_matrix,
)


@pytest.fixture(scope="module")
def problem():
    db = testing.make_reference(
        n_seqs=64, n_core=300, width=500, seed=31
    )
    idx = KmerIndex.build(db, k=8, fast=True)
    P = idx.dense()
    masks = [s.masks for s in db.sequences[:8]]
    kmers, _ = query_kmers_padded(masks, 8, fast=True, pad_to=512)
    return P, kmers


def test_make_mesh_shapes():
    mesh = make_mesh(jax.devices())
    assert mesh.shape["dp"] * mesh.shape["mp"] == len(jax.devices())


def test_sharded_search_matches_single_device(problem):
    P, kmers = problem
    mesh = make_mesh(jax.devices())
    fn = sharded_search(mesh, k_top=10)
    Pm = shard_index_matrix(mesh, P)
    vals, ids = fn(Pm, jnp.asarray(kmers))
    vals, ids = np.asarray(vals), np.asarray(ids)

    ref_scores = np.asarray(kmer_scores_xla(jnp.asarray(P), kmers))
    rv, ri = jax.lax.top_k(jnp.asarray(ref_scores), 10)
    rv = np.asarray(rv)
    # same top scores per query (ids may differ on ties)
    np.testing.assert_array_equal(np.sort(vals, 1), np.sort(rv, 1))
    # the sharded ids really have those scores
    for b in range(vals.shape[0]):
        for k in range(10):
            assert ref_scores[b, ids[b, k]] == vals[b, k]


def test_sharded_search_self_retrieval(problem):
    P, kmers = problem
    mesh = make_mesh(jax.devices())
    fn = sharded_search(mesh, k_top=5)
    Pm = shard_index_matrix(mesh, P)
    vals, ids = fn(Pm, jnp.asarray(kmers))
    vals, ids = np.asarray(vals), np.asarray(ids)
    for b in range(8):
        assert b in ids[b], f"query {b} did not retrieve itself"


def test_make_mesh_rejects_nondividing_dp():
    with pytest.raises(ValueError):
        make_mesh(jax.devices(), dp=3)  # 8 % 3 != 0


def test_make_mesh_logs_odd_fallback(caplog):
    import logging

    with caplog.at_level(logging.WARNING, logger="sina.sharding"):
        mesh = make_mesh(jax.devices()[:5])
    assert mesh.shape["dp"] == 1 and mesh.shape["mp"] == 5
    assert any("odd" in r.message for r in caplog.records)


@pytest.fixture(scope="module")
def midscale_index():
    """~20k-ref synthetic index (CSR built directly — a real db build
    at this scale is too slow for CI) with n_seqs NOT a multiple of
    the packing granularity, so both the byte-axis padding and the
    shard-boundary id arithmetic are exercised."""
    rng = np.random.default_rng(42)
    k, fast = 6, True
    n_rows = 4 ** (k - 1)
    n_seqs = 20_000  # 20000 % 1024 != 0 -> padded packed columns
    per = 30
    lists = [
        np.unique(rng.integers(0, n_rows, size=per).astype(np.int32))
        for _ in range(n_seqs)
    ]
    offsets = np.zeros(n_seqs + 1, dtype=np.int64)
    np.cumsum([len(v) for v in lists], out=offsets[1:])
    idx = KmerIndex(k, fast, n_seqs, np.concatenate(lists), offsets)
    # queries: each row samples 3 seqs' posting lists + noise
    B, L = 8, 96
    sink = n_rows  # all-zero final row
    kmers = np.full((B, L), sink, dtype=np.int32)
    for b in range(B):
        src = np.concatenate(
            [lists[int(i)] for i in rng.integers(0, n_seqs, 3)]
        )
        m = min(L, len(src))
        kmers[b, :m] = src[:m]
    return idx, kmers


def test_sharded_midscale_matches_single_device(midscale_index):
    """Mid-scale numerics parity of the sharded path: the famfinder
    layout (packed bytes padded to an mp multiple) + per-shard top-k
    + all-gather merge vs the single-device packed oracle."""
    idx, kmers = midscale_index
    mesh = make_mesh(jax.devices())
    mp = mesh.shape["mp"]
    k_top = 40

    Pp = idx.dense_packed()
    Sb = Pp.shape[1]
    Pm = np.pad(Pp, ((0, 0), (0, -(-Sb // mp) * mp - Sb)))
    fn = sharded_search(mesh, k_top=k_top)
    vals, ids = fn(shard_index_matrix(mesh, Pm), jnp.asarray(kmers))
    vals, ids = np.asarray(vals), np.asarray(ids)

    from sina_tpu.ops.kmer_kernel import kmer_scores_packed_xla

    ref_scores = np.asarray(
        kmer_scores_packed_xla(jnp.asarray(Pp), jnp.asarray(kmers))
    )
    rv = np.asarray(
        jax.lax.top_k(jnp.asarray(ref_scores), k_top)[0]
    )
    np.testing.assert_array_equal(vals, rv)
    assert (vals > 0).all()
    # every returned id really achieves its score and is a real seq
    for b in range(vals.shape[0]):
        for j in range(k_top):
            i = ids[b, j]
            assert i < idx.n_seqs, (b, j, i)
            assert ref_scores[b, i] == vals[b, j]


def test_sharded_flat_uneven_bytes():
    """Flat packed path with Sb % mp != 0 after the famfinder-style
    pad: shard-boundary arithmetic must still map local->global ids
    correctly (VERDICT r4 #7)."""
    rng = np.random.default_rng(7)
    R, Sb = 257, 136  # Sb % 4 == 0 but not a lane multiple
    mesh = make_mesh(jax.devices())
    mp = mesh.shape["mp"]
    Sb_pad = -(-Sb // mp) * mp
    P = rng.integers(0, 256, size=(R, Sb), dtype=np.uint8)
    P[-1] = 0  # sink row
    Pp = np.pad(P, ((0, 0), (0, Sb_pad - Sb)))
    kmers = rng.integers(0, R - 1, size=(8, 32)).astype(np.int32)

    fn = sharded_search(mesh, k_top=16)
    Pm = shard_index_matrix(mesh, Pp)
    vals, ids = fn(Pm, jnp.asarray(kmers))
    vals, ids = np.asarray(vals), np.asarray(ids)

    from sina_tpu.ops.kmer_kernel import kmer_scores_packed_xla

    ref = np.asarray(
        kmer_scores_packed_xla(jnp.asarray(Pp), jnp.asarray(kmers))
    )
    rv = np.asarray(jax.lax.top_k(jnp.asarray(ref), 16)[0])
    np.testing.assert_array_equal(vals, rv)
    for b in range(8):
        for j in range(16):
            assert ref[b, ids[b, j]] == vals[b, j]


def test_graft_entry_single():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert out[0].shape[0] == args[1].shape[0]


def test_graft_entry_multichip():
    import __graft_entry__ as ge

    ge.dryrun_multichip(len(jax.devices()))
