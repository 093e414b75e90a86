"""Profile-DP column-window trimming (ops/colspan.py + align.py).

Trimming is a throughput lever for short-read (amplicon)
workloads; it must be behaviour-neutral — every test here asserts the
trimmed alignment is IDENTICAL to the full-lattice one.
"""

import numpy as np

from sina_tpu import testing
from sina_tpu.align import AlignerConfig, align_batch, INSERTION_FORBID
from sina_tpu.sequence import Sequence
from sina_tpu.testing import unaligned_copy


def _amplicon(q: Sequence, lo: int, hi: int) -> Sequence:
    """Unaligned middle slice of a query's bases (a V4-style read)."""
    masks = q.masks[lo:hi].copy()
    n = len(masks)
    return Sequence(
        q.name, np.arange(n, dtype=np.uint32), masks, n, {}
    )


def _run_pair(queries, fams, cfg_kw=None):
    kw = dict(cfg_kw or {})
    full = align_batch(
        [q.copy() for q in queries],
        [list(f) for f in fams],
        AlignerConfig(col_trim=False, **kw),
    )
    trim = align_batch(
        [q.copy() for q in queries],
        [list(f) for f in fams],
        AlignerConfig(col_trim=True, col_trim_min_cols=0, **kw),
    )
    return full, trim


def test_amplicon_trim_identical():
    db = testing.make_reference(
        n_seqs=32, n_core=900, width=1600, seed=21
    )
    shared = [(1.0, s) for s in db.sequences[:10]]
    qs = [
        _amplicon(q, 250, 480)
        for q in testing.make_queries(
            db, n=8, seed=13, branch_len=0.6
        )
    ]
    full, trim = _run_pair(qs, [shared] * len(qs))
    n_checked = 0
    for f, t in zip(full, trim):
        assert (f is None) == (t is None)
        if f is None:
            continue
        assert f.positions.tolist() == t.positions.tolist()
        assert f.masks.tolist() == t.masks.tolist()
        assert f.get_attr("align_quality_slv") == t.get_attr(
            "align_quality_slv"
        )
        n_checked += 1
    assert n_checked >= 6


def test_amplicon_trim_identical_forbid_mode():
    db = testing.make_reference(
        n_seqs=24, n_core=900, width=1600, seed=22
    )
    shared = [(1.0, s) for s in db.sequences[:8]]
    qs = [
        _amplicon(q, 300, 520)
        for q in testing.make_queries(
            db, n=5, seed=17, branch_len=0.6
        )
    ]
    full, trim = _run_pair(
        qs, [shared] * len(qs), {"insertion": INSERTION_FORBID}
    )
    for f, t in zip(full, trim):
        assert (f is None) == (t is None)
        if f is None:
            continue
        assert f.positions.tolist() == t.positions.tolist()


def test_full_length_queries_skip_trimming():
    # full-length queries must take the untrimmed path (window cannot
    # save >= 25%) — results identical, no new shape classes
    from sina_tpu.align import _trim_windows

    db = testing.make_reference(
        n_seqs=16, n_core=400, width=800, seed=23
    )
    shared = [(1.0, s) for s in db.sequences[:8]]
    qs = [
        unaligned_copy(q)
        for q in testing.make_queries(db, n=4, seed=3, branch_len=0.6)
    ]
    full, trim = _run_pair(qs, [shared] * len(qs))
    for f, t in zip(full, trim):
        assert (f is None) == (t is None)
        if f is not None:
            assert f.positions.tolist() == t.positions.tolist()
    # and directly: no window assigned on full-length items
    refs = [s for s in db.sequences[:8]]
    item = [0, qs[0], None, None, refs, [], 0, 0.0, 0, 0]
    C = len(
        np.unique(np.concatenate([r.positions for r in refs]))
    )
    item[6] = C
    item[9] = C
    _trim_windows([item])
    assert item[8] == 0 and item[6] == C


def test_mixed_batch_trimmed_and_full():
    # amplicon + full-length in one batch: both classes correct
    db = testing.make_reference(
        n_seqs=24, n_core=900, width=1600, seed=24
    )
    shared = [(1.0, s) for s in db.sequences[:8]]
    qfull = [
        unaligned_copy(q)
        for q in testing.make_queries(db, n=3, seed=5, branch_len=0.6)
    ]
    qamp = [
        _amplicon(q, 200, 430)
        for q in testing.make_queries(db, n=3, seed=6, branch_len=0.6)
    ]
    qs = qfull + qamp
    full, trim = _run_pair(qs, [shared] * len(qs))
    for f, t in zip(full, trim):
        assert (f is None) == (t is None)
        if f is not None:
            assert f.positions.tolist() == t.positions.tolist()


def test_amplicon_at_gene_start_trims():
    # regression: a window starting at column 0 is still a trimmed
    # window (bucket cpad < family C) — the dispatcher must build the
    # full profile and slice, not assume ws==0 means untrimmed
    db = testing.make_reference(
        n_seqs=24, n_core=900, width=1600, seed=26
    )
    shared = [(1.0, s) for s in db.sequences[:8]]
    qs = [
        _amplicon(q, 0, 230)
        for q in testing.make_queries(
            db, n=5, seed=29, branch_len=0.6
        )
    ]
    full, trim = _run_pair(qs, [shared] * len(qs))
    for f, t in zip(full, trim):
        assert (f is None) == (t is None)
        if f is not None:
            assert f.positions.tolist() == t.positions.tolist()


def test_query_window_covers_true_span():
    # the anchored window must contain every column the full aligner
    # actually used (sufficiency of the margins, checked directly)
    from sina_tpu.ops.colspan import RefAnchorTable, query_window

    db = testing.make_reference(
        n_seqs=16, n_core=900, width=1600, seed=25
    )
    refs = db.sequences[:8]
    cols = np.unique(
        np.concatenate([r.positions for r in refs])
    ).astype(np.int64)
    shared = [(1.0, s) for s in refs]
    table = RefAnchorTable(refs[0].masks)
    for q in testing.make_queries(db, n=6, seed=19, branch_len=0.6):
        amp = _amplicon(q, 250, 470)
        win = query_window(
            amp.masks, table, refs[0].positions, cols
        )
        if win is None:
            continue
        lo_col, hi_col, est = win
        aligned = align_batch(
            [amp.copy()],
            [list(shared)],
            AlignerConfig(col_trim=False),
        )[0]
        if aligned is None:
            continue
        used = aligned.positions
        assert lo_col <= used.min() and used.max() < hi_col
        # est bounds the family occupied count inside the window
        n_in = int(
            np.searchsorted(cols, hi_col)
            - np.searchsorted(cols, lo_col)
        )
        assert est >= n_in


def test_no_anchors_falls_back():
    from sina_tpu.ops.colspan import RefAnchorTable, query_window

    rng = np.random.default_rng(0)
    ref_masks = np.array(
        [1 << int(b) for b in rng.integers(0, 4, 600)], np.uint8
    )
    positions = np.arange(600, dtype=np.int64)
    cols = positions.copy()
    table = RefAnchorTable(ref_masks)
    # unrelated random query: diagonal-consistency should reject it
    # or (rarely) produce a window; all-ambiguity query must reject
    amb = np.full(80, 15, np.uint8)  # all-N: no valid k-mers
    assert query_window(amb, table, positions, cols) is None


def test_snap_grid_covered_by_estimate():
    # the dispatcher snaps window starts down by up to SNAP_GRID-1
    # ranks; _trim_windows must extend the bucket estimate by the
    # same grid or the lattice can lose trailing ranks.  Pin the
    # coupling: a trimmed item's estimate minus the window's rank
    # count must be >= SNAP_GRID.
    from sina_tpu.ops.colspan import (
        RefAnchorTable, query_window, SNAP_GRID,
    )
    from sina_tpu.align import _trim_windows

    db = testing.make_reference(
        n_seqs=24, n_core=900, width=1600, seed=31
    )
    db.ensure_flat()
    qfull = testing.make_queries(db, n=1, seed=33, branch_len=0.6)[0]
    parent = next(
        s for s in db.sequences if s.name == qfull.attrs["parent"]
    )
    refs = [parent] + [
        s for s in db.sequences[:9] if s is not parent
    ][:7]
    cols = np.unique(
        np.concatenate([r.positions for r in refs])
    ).astype(np.int64)
    q = _amplicon(qfull, 250, 470)
    C = len(cols)
    item = [0, q, None, None, refs, [], C, 0.0, 0, C]
    _trim_windows([item])
    assert item[8] != 0, "fixture query failed to anchor"
    lo_col, hi_col = item[8]
    # the dispatcher's needed slice length is the family's occupied
    # ranks in [lo, hi) plus up to SNAP_GRID-1 from snapping the
    # start down; the bucket estimate must cover that
    in_win = int(
        np.searchsorted(cols, hi_col) - np.searchsorted(cols, lo_col)
    )
    assert item[6] - in_win >= SNAP_GRID


def test_repeat_tolerant_anchoring():
    # a reference with an exact duplicated segment: first-occurrence
    # anchoring would place a query from the SECOND copy at the
    # first; all-occurrence + diagonal consensus must cover the
    # true locus
    from sina_tpu.ops.colspan import RefAnchorTable, query_window

    rng = np.random.default_rng(7)
    seg = np.array(
        [1 << int(b) for b in rng.integers(0, 4, 120)], np.uint8
    )
    uniq1 = np.array(
        [1 << int(b) for b in rng.integers(0, 4, 400)], np.uint8
    )
    uniq2 = np.array(
        [1 << int(b) for b in rng.integers(0, 4, 400)], np.uint8
    )
    masks = np.concatenate([uniq1, seg, uniq2, seg, uniq1[:50]])
    positions = np.arange(len(masks), dtype=np.int64)
    cols = positions.copy()
    table = RefAnchorTable(masks)
    # query = the second copy's surrounding context (uniq2 tail +
    # the duplicated segment + trailing context)
    q_lo = 400 + 120 + 300  # inside uniq2
    q_hi = 400 + 120 + 400 + 120 + 30
    q = masks[q_lo:q_hi].copy()
    win = query_window(q, table, positions, cols)
    assert win is not None
    lo_col, hi_col, _ = win
    assert lo_col <= q_lo and hi_col >= q_hi - 1, (
        lo_col, hi_col, q_lo, q_hi,
    )


def test_native_query_windows_parity():
    """The native batched anchoring must reproduce the python
    query_window for every query of a realistic batch (flat-store
    path, the amplicon production configuration)."""
    from sina_tpu.align import (
        _anchor_cache, _db_occupied_cols, _trim_windows_native,
    )
    from sina_tpu.ops.colspan import RefAnchorTable, query_window
    from sina_tpu import native

    if native.get_lib() is None:
        import pytest

        pytest.skip("native lib unavailable")
    db = testing.make_reference(
        n_seqs=400, n_core=900, width=1600, seed=77
    )
    db.ensure_flat()
    full = testing.make_queries(db, n=48, seed=13, branch_len=0.6)
    items = []
    for i, qf in enumerate(full):
        q = _amplicon(qf, 250, 500 + (i % 5) * 23)
        refs = list(db.sequences[(i % 7) * 20 : (i % 7) * 20 + 12])
        items.append([i, q, None, None, refs, [], 10**6, 0.0, 0, 0])
    pend = []
    rest = _trim_windows_native(items, pend)
    assert rest == []  # flat store present: all go native
    got = {id(p[0]): (p[1], p[2], p[3]) for p in pend}
    n_win = 0
    for it in items:
        top = it[4][0]
        table = _anchor_cache.get(
            top, lambda t: RefAnchorTable(t.masks)
        )
        cols = _db_occupied_cols(top)
        win = query_window(
            it[1].masks, table, top.positions, cols
        )
        if win is None:
            assert id(it) not in got
        else:
            n_win += 1
            assert got[id(it)] == (win[0], win[1], win[2]), it[0]
    # families are arbitrary slices, so unrelated tops legitimately
    # fail to anchor; parity above is the real assertion
    assert n_win >= 10


def test_windowed_profile_build_identical_flat_store():
    """With the shared flat store stamped (production config) the
    dispatcher builds WINDOW-RESTRICTED profiles; results must stay
    bit-identical to trim-off full-lattice alignment."""
    from sina_tpu.ops.profile import can_window_batch

    db = testing.make_reference(
        n_seqs=64, n_core=900, width=1600, seed=41
    )
    db.ensure_flat()
    refs = db.sequences[:12]
    assert can_window_batch([refs])
    shared = [(1.0, s) for s in refs]
    qs = [
        _amplicon(q, 240, 500)
        for q in testing.make_queries(
            db, n=8, seed=43, branch_len=0.6
        )
    ]
    full, trim = _run_pair(qs, [shared] * len(qs))
    n_checked = 0
    for f, t in zip(full, trim):
        assert (f is None) == (t is None)
        if f is None:
            continue
        assert f.positions.tolist() == t.positions.tolist()
        assert f.masks.tolist() == t.masks.tolist()
        n_checked += 1
    assert n_checked >= 6
    # mixed batch: one full-length query forces its family full while
    # windowed families still restrict
    qmix = qs[:3] + [
        unaligned_copy(
            testing.make_queries(db, n=1, seed=47, branch_len=0.5)[0]
        )
    ]
    fams = [shared] * len(qmix)
    fullm, trimm = _run_pair(qmix, fams)
    for f, t in zip(fullm, trimm):
        assert (f is None) == (t is None)
        if f is not None:
            assert f.positions.tolist() == t.positions.tolist()
