"""Multi-chip sharding of the search index and query batches.

The reference scales out with a pool of PT-server processes talking
AISC RPC over sockets (/root/reference/src/query_pt.cpp:692-790) and
byte-range input sharding for multi-process runs (rw_fasta.cpp:209-242).
Here there is no RPC at all: the k-mer incidence matrix lives in device
memory, sharded over the reference-sequence axis ("mp"), query batches
are data-parallel over "dp", and the per-shard top-k candidates are
merged with an all-gather — XLA inserts the collectives from shard_map
specs.
"""

from __future__ import annotations

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

logger = logging.getLogger("sina.sharding")


def make_mesh(devices=None, dp: int | None = None) -> Mesh:
    """Build a (dp, mp) mesh over the given devices.

    Multi-host runs (jax.process_count() > 1, after
    parallel.multihost.initialize): "dp" spans hosts so the
    query-batch axis crosses hosts (each host feeds its own
    --fasta-block shard, no cross-host traffic on the data axis) and
    "mp" stays within a host so the index-shard all-gather merge
    stays on the host's own interconnect.
    jax.devices() orders devices grouped by process, so the reshape
    below produces exactly that layout.

    An explicitly requested dp that does not divide the device count
    raises (no silent config-swallowing); an inferred fallback to
    dp=1 on an odd device count >= 3 is logged loudly."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if dp is not None:
        if dp < 1 or n % dp != 0:
            raise ValueError(
                f"requested dp={dp} does not divide the "
                f"{n}-device mesh"
            )
    else:
        try:
            nproc = jax.process_count()
        except RuntimeError:  # pragma: no cover - pre-init
            nproc = 1
        if nproc > 1 and n % nproc == 0:
            dp = nproc
        else:
            dp = 2 if n % 2 == 0 and n >= 4 else 1
            if dp == 1 and n >= 3:
                logger.warning(
                    "make_mesh: %d devices is odd — using a (1, %d) "
                    "mesh (no data-parallel axis); pass dp= "
                    "explicitly to override", n, n,
                )
    mp = n // dp
    arr = np.asarray(devices[: dp * mp]).reshape(dp, mp)
    return Mesh(arr, ("dp", "mp"))


def sharded_search(mesh: Mesh, k_top: int):
    """Compiled sharded scoring+top-k.

    Returns fn(P_matrix, kmers (B, L)) -> (vals, ids) both
    (B, k_top).  P_matrix is either the bitpacked (R+1, Sb) byte
    matrix (Sb % mp == 0) sharded over bytes or the dense (R+1, S)
    int8 matrix; queries shard over "dp".  Per-shard top-k
    (grouped-hierarchy exact top-k at SILVA-scale shard widths)
    merges via all-gather over "mp" — the replacement for the
    PT-server candidate merge (query_pt.cpp:692-790)."""
    from ..ops.kmer_kernel import (
        grouped_top_k, kmer_scores_packed_xla, kmer_scores_xla,
    )

    mp = mesh.shape["mp"]

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(None, "mp"), P("dp", None)),
        out_specs=(P("dp", None), P("dp", None)),
        check_vma=False,  # outputs are mp-replicated via all_gather
    )
    def fn(P_local, kmers_local):
        if P_local.dtype == jnp.uint8:  # bitpacked byte axis
            s_local = P_local.shape[1] * 8
            scores = kmer_scores_packed_xla(P_local, kmers_local)
        else:
            s_local = P_local.shape[1]
            scores = kmer_scores_xla(P_local, kmers_local)
        k_local = min(k_top, s_local)
        if s_local >= 32768:
            v, i = grouped_top_k(scores, k_local)
        else:
            v, i = jax.lax.top_k(scores, k_local)
        shard = jax.lax.axis_index("mp")
        i = i + shard * s_local
        # merge candidates across index shards
        vg = jax.lax.all_gather(v, "mp", axis=1)   # (B/dp, mp, k)
        ig = jax.lax.all_gather(i, "mp", axis=1)
        B = vg.shape[0]
        vflat = vg.reshape(B, mp * k_local)
        iflat = ig.reshape(B, mp * k_local)
        k_out = min(k_top, vflat.shape[1])
        vbest, sel = jax.lax.top_k(vflat, k_out)
        ibest = jnp.take_along_axis(iflat, sel, axis=1)
        if k_out < k_top:
            pad = k_top - k_out
            vbest = jnp.pad(vbest, ((0, 0), (0, pad)),
                            constant_values=-1)
            ibest = jnp.pad(ibest, ((0, 0), (0, pad)),
                            constant_values=0)
        return vbest, ibest

    return jax.jit(fn)


def shard_index_matrix(mesh: Mesh, P_matrix):
    """Place the (R, S) incidence matrix sharded over "mp" along its
    sequence/byte axis."""
    from jax.sharding import NamedSharding

    return jax.device_put(P_matrix, NamedSharding(mesh, P(None, "mp")))
