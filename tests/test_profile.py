"""Profile engine tests: pseq construction + chain DP + dispatch."""

import numpy as np
import jax.numpy as jnp
import pytest

from sina_tpu.align import AlignerConfig, align_sequence
from sina_tpu.ops.align_kernel import DpParams
from sina_tpu.ops.profile import (
    build_profile,
    profile_dp_batch,
    query_profile_weights,
    _profile_batched_fn,
)
from sina_tpu.sequence import Sequence
from sina_tpu import testing


def fam(*seqs):
    return [(1.0, s) for s in seqs]


def test_build_profile_semantics():
    a = Sequence.from_string("a", "AG-CU")
    b = Sequence.from_string("b", "AGGC-")
    p = build_profile([a, b])
    # occupied columns 0,1,2,3,4
    assert p.cols.tolist() == [0, 1, 2, 3, 4]
    # col0: both A -> freq A = 1
    assert p.freqs[0, 0] == pytest.approx(1.0)
    # col2: b has G, a gap (a had base at col1 -> gap open)
    total2 = 12 + 12  # one G + one gapOpen
    assert p.freqs[2, 1] == pytest.approx(12 / total2)
    assert p.gap_open[2] == pytest.approx(12 / total2)
    # col4: a has U, b gap (open: b had base at col3)
    assert p.gap_open[4] > 0


def test_query_profile_weights_ambig():
    q = Sequence.from_string("q", "AR")
    w = query_profile_weights(q.masks)
    assert w[0].tolist() == [1, 0, 0, 0]
    assert w[1, 0] == pytest.approx(0.5)  # R = A|G
    assert w[1, 1] == pytest.approx(0.5)


def test_profile_alignment_realistic():
    db = testing.make_reference(n_seqs=60, n_core=300, width=500, seed=9)
    queries = testing.make_queries(db, n=4, seed=2, branch_len=0.4)
    cfg = AlignerConfig(realign=True, engine="profile")
    from sina_tpu.comparator import Comparator, IUPAC_EXACT, COVER_QUERY

    cmp_exact = Comparator(IUPAC_EXACT, "none", COVER_QUERY, False)
    for true_q in queries:
        q = testing.unaligned_copy(true_q)
        pid = db.index_of(true_q.get_attr("parent"))
        fam_seqs = [db.sequences[(pid + k) % len(db)] for k in range(12)]
        out = align_sequence(q, fam(*fam_seqs), cfg)
        assert out is not None
        assert out.get_bases().upper() == true_q.get_bases().upper()
        assert cmp_exact(true_q, out) > 0.85


def test_wire_dispatch_matches_direct_arrays():
    """The coalesced one-transfer wire buffer (profile_dp_dispatch ->
    _build_wire/_profile_wire_fn) must reproduce the direct
    multi-array XLA path exactly: the device-side static slices +
    uint8->int32 bitcasts (_wire_layout) are a pure re-encoding.
    Covers plain, dedup (fam_idx gather) and aspace (budget) modes."""
    from sina_tpu.ops.profile import (
        _pack_fgq, _unpack_result, profile_dp_dispatch,
        profile_dp_fetch, _profile_batched_fn,
    )

    rng = np.random.default_rng(11)
    params = DpParams()
    C, M, B = 40, 56, 16  # B == bucket so no padding ambiguity
    freqs = rng.random((B, C, 4)).astype(np.float32)
    freqs /= freqs.sum(axis=2, keepdims=True) * 1.25
    gapcost = (rng.random((B, C)) * 2).astype(np.float32)
    qmask = (
        1 << rng.integers(0, 4, (B, M), dtype=np.uint8)
    ).astype(np.uint8)
    qlen = rng.integers(M // 2, M + 1, B).astype(np.int32)
    cr = rng.integers(C // 2, C + 1, B).astype(np.int32)
    for b in range(B):
        qmask[b, qlen[b]:] = 0

    fg = _pack_fgq(freqs, gapcost, params)
    lens = np.stack([qlen, cr], axis=1).astype(np.int32)

    # direct multi-array oracle
    direct = _unpack_result(
        np.asarray(
            _profile_batched_fn(C, M, params)(
                jnp.asarray(fg), jnp.asarray(qmask),
                jnp.asarray(lens),
            )
        )
    )
    wired = profile_dp_fetch(
        profile_dp_dispatch(freqs, gapcost, qmask, qlen, cr, params)
    )
    for a, b_ in zip(direct, wired):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b_))

    # dedup: all queries share profile row 0 == dispatching row 0
    # replicated
    fam_idx = np.zeros(B, np.int32)
    ded = profile_dp_fetch(
        profile_dp_dispatch(
            freqs[:1], gapcost[:1], qmask, qlen, cr, params,
            fam_idx=fam_idx,
        )
    )
    rep = profile_dp_fetch(
        profile_dp_dispatch(
            np.repeat(freqs[:1], B, 0), np.repeat(gapcost[:1], B, 0),
            qmask, qlen, cr, params,
        )
    )
    for a, b_ in zip(ded, rep):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b_))

    # aspace: wire encoding vs the direct multi-array aspace oracle
    budget = rng.integers(0, 4, (B, C)).astype(np.int32)
    asp = profile_dp_fetch(
        profile_dp_dispatch(
            freqs, gapcost, qmask, qlen, cr, params, budget=budget,
        )
    )
    asp_direct = _unpack_result(
        np.asarray(
            _profile_batched_fn(C, M, params, aspace=True)(
                jnp.asarray(fg), jnp.asarray(qmask),
                jnp.asarray(lens), jnp.asarray(budget),
            )
        )
    )
    for a, b_ in zip(asp_direct, asp):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b_))


def test_dispatch_row_bucketing():
    """The dispatch pads the batch axis to a power-of-two bucket so
    per-bucket batch sizes (data-dependent) never mint new compile
    shapes — a compile inside the run costs more than the DP call."""
    from sina_tpu.ops.profile import (
        _bucket_rows, profile_dp_dispatch, profile_dp_fetch,
        build_profile,
    )

    assert _bucket_rows(1) == 16
    assert _bucket_rows(16) == 16
    assert _bucket_rows(43) == 64
    assert _bucket_rows(128) == 128
    assert _bucket_rows(129) == 256
    assert _bucket_rows(300) == 512

    rng = np.random.default_rng(7)
    params = DpParams()
    C, M = 32, 48
    shapes = set()
    results = []
    freqs5 = rng.random((5, C, 4)).astype(np.float32)
    freqs5 /= freqs5.sum(axis=2, keepdims=True) * 1.25
    gapcost5 = (rng.random((5, C)) * 2).astype(np.float32)
    qmask5 = (
        1 << rng.integers(0, 4, (5, M), dtype=np.uint8)
    ).astype(np.uint8)
    for B in (3, 5):
        qlen = np.full(B, M, np.int32)
        cr = np.full(B, C, np.int32)
        handle = profile_dp_dispatch(
            freqs5[:B], gapcost5[:B], qmask5[:B], qlen, cr, params
        )
        shapes.add(tuple(handle[1].shape))
        emit, bc, bi, raw = profile_dp_fetch(handle)
        assert emit.shape[0] == B  # padding sliced back off
        results.append((emit, bc, bi, raw))
    # both batch sizes ran through ONE padded device shape
    assert len(shapes) == 1
    # rows shared between the two calls agree (padding is inert)
    e3, _, _, r3 = results[0]
    e5, _, _, r5 = results[1]
    np.testing.assert_array_equal(e3[:3], e5[:3])
    np.testing.assert_allclose(r3[:3], r5[:3], rtol=1e-6)
