"""Batching behaviour of the famfinder stage: reorientation rescore
and constraint-escalation refetch must stay O(1) device calls per
batch."""

import numpy as np
import pytest

from sina_tpu.famfinder import FamFinder, FamFinderConfig
from sina_tpu.testing import make_reference, unaligned_copy


@pytest.fixture(scope="module")
def db():
    return make_reference(n_seqs=60, n_core=500, width=800, seed=7)


def _counting(ff):
    """Wrap score_topk / score_batch with call counters."""
    calls = {"topk": [], "batch": 0}
    orig_topk, orig_batch = ff.score_topk, ff.score_batch

    def topk(mask_list, k):
        calls["topk"].append((len(mask_list), k))
        return orig_topk(mask_list, k)

    def batch(mask_list):
        calls["batch"] += 1
        return orig_batch(mask_list)

    ff.score_topk = topk
    ff.score_batch = batch
    return calls


def test_revcomp_heavy_batch_two_scoring_calls(db):
    """Half-revcomp input: one initial call + ONE batched rescore for
    all reoriented queries (was: one device call per query)."""
    ff = FamFinder(db, FamFinderConfig(turn="revcomp", fs_req_gaps=0))
    queries = [unaligned_copy(db.sequences[i]) for i in range(8)]
    for q in queries[::2]:
        q.reverse().complement()
    calls = _counting(ff)
    out = ff.process_batch(queries)
    assert len(calls["topk"]) == 2
    assert calls["topk"][1][0] == 4  # the 4 reoriented queries, batched
    assert calls["batch"] == 0
    for b, (q, res) in enumerate(zip(queries, out)):
        expect = (
            "reversed and complemented" if b % 2 == 0 else "none"
        )
        assert q.get_attr("turn_slv") == expect
        assert not res.failed
        # reorientation restored the original: family must contain it
        names = [s.name for _, s in res.family]
        assert q.name in names


def test_escalation_uses_topk_ladder_not_full_rows():
    """Constraint escalation must refetch via growing device top-k,
    never by shipping full (B, n_seqs) score rows."""
    db = make_reference(n_seqs=300, n_core=400, width=700, seed=11)
    # impossible min-length -> every candidate filtered -> escalate to n
    cfg = FamFinderConfig(fs_min_len=10_000, fs_req_gaps=0)
    ff = FamFinder(db, cfg)
    queries = [unaligned_copy(db.sequences[i]) for i in range(3)]
    calls = _counting(ff)
    out = ff.process_batch(queries)
    assert calls["batch"] == 0  # no full-row fetch
    # initial k0=256 call + one ladder rung at k = n_seqs
    assert len(calls["topk"]) == 2
    assert calls["topk"][1] == (3, 300)
    assert all(r is not None and r.failed for r in out)


def test_escalation_ladder_matches_full_scoring():
    """Ladder refetch is behaviour-identical to full-row scoring."""
    db = make_reference(n_seqs=300, n_core=400, width=700, seed=11)
    # fs_min > achievable family at default k0 slice forces one rung
    cfg = FamFinderConfig(fs_req_gaps=0)
    ff = FamFinder(db, cfg)
    q = unaligned_copy(db.sequences[5])
    via_batch = ff.process_batch([q.copy()])[0]
    scores = ff.score_batch([q.masks])[0]
    via_full = ff._finish(q.copy(), scores=scores)
    # top-k ties resolve to lowest id, _rank to highest (documented
    # deviation) -> compare as score-sorted multisets
    got = sorted((round(sc, 4), s.name) for sc, s in via_batch.family)
    want = sorted((round(sc, 4), s.name) for sc, s in via_full.family)
    assert [s for s, _ in got] == [s for s, _ in want]
    assert len(got) == len(want)


def test_duplicate_queries_scored_once(db):
    """Base-identical queries collapse to one scoring row (the
    reference's FIFO result cache, kmer_search.cpp:105,378); results
    fan back out per query."""
    ff = FamFinder(db, FamFinderConfig(fs_req_gaps=0))
    qs = [unaligned_copy(db.sequences[i % 4]) for i in range(16)]
    calls = _counting(ff)
    out = ff.process_batch(qs)
    assert len(calls["topk"]) == 1
    assert calls["topk"][0][0] == 4  # 4 distinct reads, not 16
    assert calls["batch"] == 0
    for i in (0, 5, 10, 15):
        assert out[i] is not None and not out[i].failed
    # identical reads get identical families
    fams = [[s.name for _, s in out[i].family] for i in (0, 4, 8, 12)]
    assert fams[0] == fams[1] == fams[2] == fams[3]


def test_duplicate_queries_submit_handle(db):
    """The pipelined submit path scores the deduped rows only, padded
    to a power-of-two bucket (no per-batch compile shapes)."""
    ff = FamFinder(db, FamFinderConfig(fs_req_gaps=0))
    qs = [unaligned_copy(db.sequences[i % 8]) for i in range(64)]
    handle = ff.submit_batch(qs)
    packed, k0, inv = handle
    if isinstance(packed, tuple):
        # sharded (mesh) submit: deduped rows padded to the dp
        # multiple only (shard_map shapes are already stable)
        vals, ids, n_uniq = packed
        assert n_uniq == 8
        assert vals.shape[0] <= 16
    else:
        # 8 unique -> 16-row bucket, not 64
        assert packed.shape[0] == 16
    assert inv.max() == 7
    out = ff.process_batch(qs, handle=handle)
    assert all(r is not None and not r.failed for r in out)
    names0 = [s.name for _, s in out[0].family]
    names8 = [s.name for _, s in out[8].family]
    assert names0 == names8


def test_fast_policy_matches_object_path(db, monkeypatch):
    """The vectorized candidate filter (_filter_fast/_match_fast)
    must make identical keep decisions to the Sequence-object loop —
    including escalation, fs_req_gaps downstream, and constraint
    configs (fs_cover_gene / fs_req_full)."""
    for cfg in (
        FamFinderConfig(fs_min=8, fs_max=8, fs_req_gaps=1),
        FamFinderConfig(
            fs_min=4, fs_max=6, fs_req_full=2, fs_full_len=450,
            fs_min_len=100,
        ),
        FamFinderConfig(
            fs_min=4, fs_max=4, fs_cover_gene=1,
            gene_start=5, gene_end=700,
        ),
    ):
        ff = FamFinder(db, cfg)
        assert ff._fast_policy_ok()
        queries = [
            unaligned_copy(s) for s in db.sequences[:12]
        ]
        fast = ff.process_batch([q.copy() for q in queries])
        monkeypatch.setattr(
            FamFinder, "_fast_policy_ok", lambda self: False
        )
        slow = ff.process_batch([q.copy() for q in queries])
        monkeypatch.undo()
        for a, b in zip(fast, slow):
            assert a.failed == b.failed
            assert [
                (s, r.name) for s, r in a.family
            ] == [(s, r.name) for s, r in b.family]
