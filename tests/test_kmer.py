"""k-mer extraction + index tests (kmer_test.cpp / kmer_search_test.cpp
analogues, incl. the self-retrieval invariant)."""

import numpy as np
import pytest

from sina_tpu import alphabet as al
from sina_tpu.ops.kmer import kmers_of_masks, query_kmers_padded
from sina_tpu.ops.kmer_index import KmerIndex
from sina_tpu.ops.kmer_kernel import kmer_scores_xla, top_k_scores
from sina_tpu import testing


def _masks(s):
    _, m, _ = al.encode(s)
    return m


def test_kmer_values():
    # AGCU -> k=2 windows: AG, GC, CU -> 4*0+1, 4*1+2, 4*2+3
    vals = kmers_of_masks(_masks("AGCU"), 2)
    assert vals.tolist() == [1, 6, 11]


def test_kmer_ambiguity_resets_window():
    # N in the middle invalidates any window covering it
    vals = kmers_of_masks(_masks("AANAA"), 2)
    assert vals.tolist() == [0, 0]  # only the two flanking AA pairs


def test_kmer_too_short():
    assert len(kmers_of_masks(_masks("AG"), 3)) == 0


def test_kmer_prefix_filter():
    vals = kmers_of_masks(_masks("AGAU"), 2, prefix_base=al.BASE_A)
    # windows AG, GA, AU; only those starting with A pass
    assert vals.tolist() == [1, 3]


def test_kmer_unique():
    vals = kmers_of_masks(_masks("AAAA"), 2, unique=True)
    assert vals.tolist() == [0]


@pytest.fixture(scope="module")
def small_db(tmp_path_factory):
    db = testing.make_reference(n_seqs=60, n_core=300, width=500, seed=7)
    p = tmp_path_factory.mktemp("db") / "small.sref"
    db.save(p)
    return db


@pytest.fixture(scope="module")
def index(small_db):
    return KmerIndex.build(small_db, k=8, fast=True)


def test_index_cache_roundtrip(small_db):
    idx1 = KmerIndex.build(small_db, k=8, fast=True)
    idx2 = KmerIndex.build(small_db, k=8, fast=True)  # loads cache
    assert np.array_equal(idx1.seq_kmers, idx2.seq_kmers)
    assert np.array_equal(idx1.seq_offsets, idx2.seq_offsets)


def test_self_retrieval(small_db, index):
    """Every reference sequence queried against the index must return
    itself with the maximum score (kmer_search_test.cpp:97-121)."""
    P = index.dense()
    masks = [s.masks for s in small_db.sequences[:20]]
    kmers, counts = query_kmers_padded(masks, index.k, fast=True)
    scores = np.asarray(kmer_scores_xla(P, kmers))
    for i in range(len(masks)):
        best = scores[i].max()
        assert scores[i, i] == best, f"seq {i} not its own best match"


def test_score_semantics_match_reference(small_db, index):
    """Score = number of query k-mer occurrences present in the
    target's unique k-mer set (kmer_search.cpp:366-410)."""
    P = index.dense()
    q = small_db.sequences[3]
    kmers, counts = query_kmers_padded([q.masks], index.k, fast=True)
    scores = np.asarray(kmer_scores_xla(P, kmers))[0]
    # manual recompute vs sequence 5
    target_set = set(
        kmers_of_masks(
            small_db.sequences[5].masks, index.k, prefix_base=0,
            unique=True,
        ).tolist()
    )
    qk = kmers_of_masks(q.masks, index.k, prefix_base=0)
    expect = sum(1 for v in qk.tolist() if v in target_set)
    assert scores[5] == expect


def test_top_k(small_db, index):
    P = index.dense()
    masks = [s.masks for s in small_db.sequences[:4]]
    kmers, _ = query_kmers_padded(masks, index.k, fast=True)
    scores = kmer_scores_xla(P, kmers)
    vals, ids = top_k_scores(scores, 5)
    vals = np.asarray(vals)
    ids = np.asarray(ids)
    assert ids[0, 0] == 0 or vals[0, 0] == vals[0, ids[0].tolist().index(0)]
    assert (np.diff(vals, axis=1) <= 0).all()


def test_nofast_index(small_db):
    idx = KmerIndex.build(small_db, k=6, fast=False)
    P = idx.dense()
    masks = [small_db.sequences[0].masks]
    kmers, _ = query_kmers_padded(masks, 6, fast=False)
    scores = np.asarray(kmer_scores_xla(P, kmers))[0]
    assert scores.argmax() == 0


def test_packed_incidence_matches_dense():
    """Bitpacked scoring == dense scoring."""
    import jax.numpy as jnp

    from sina_tpu import testing
    from sina_tpu.ops.kmer import query_kmers_padded
    from sina_tpu.ops.kmer_index import KmerIndex
    from sina_tpu.ops.kmer_kernel import (
        kmer_scores_packed_xla,
        kmer_scores_xla,
    )

    db = testing.make_reference(
        n_seqs=50, n_core=200, width=400, seed=11
    )
    idx = KmerIndex.build(db, k=8, fast=True)
    P = idx.dense()
    Pp = idx.dense_packed()
    masks = [s.masks for s in db.sequences[:6]]
    kmers, _ = query_kmers_padded(masks, 8, fast=True, pad_to=256)
    dense = np.asarray(kmer_scores_xla(jnp.asarray(P), kmers))
    packed = np.asarray(
        kmer_scores_packed_xla(jnp.asarray(Pp), kmers)
    )
    n = idx.n_seqs
    np.testing.assert_array_equal(packed[:, :n], dense[:, :n])
    assert (packed[:, n:] == 0).all()
