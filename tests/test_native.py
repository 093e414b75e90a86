"""Native C++ data-path tests: parity with the python reader."""

import numpy as np
import pytest

from sina_tpu import native
from sina_tpu.io import fasta as fio


@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    if lib is None:
        pytest.skip("no native toolchain available")
    return lib


def test_native_parse_matches_python(lib, tmp_path):
    text = (
        ">s1 first\nAC-GU\nacgu\n"
        ">s2\nNNRY--KM\n"
        ">bad\nAC!GU\n"
        ">s3\n\nACGU\n"
    )
    p = tmp_path / "t.fasta"
    p.write_text(text)
    nat = list(fio.read_fasta(p, use_native=True))
    py = list(fio.read_fasta(p, use_native=False))
    assert [s.name for s in nat] == [s.name for s in py]
    for a, b in zip(nat, py):
        assert a.width == b.width
        assert np.array_equal(a.positions, b.positions)
        assert np.array_equal(a.masks, b.masks)
        assert a.get_attr("full_name") == b.get_attr("full_name")


def test_native_comment_fallback(lib, tmp_path):
    # comment attributes force the python reader
    p = tmp_path / "t.fasta"
    p.write_text(">s1\n; k = v\nACGU\n")
    recs = native.parse_fasta_buffer(p.read_bytes())
    assert recs is None
    seqs = list(fio.read_fasta(p))
    assert seqs[0].get_attr("k") == "v"


def test_native_crlf(lib, tmp_path):
    p = tmp_path / "t.fasta"
    p.write_bytes(b">s1 desc\r\nAC\r\nGU\r\n")
    (s,) = list(fio.read_fasta(p))
    assert s.name == "s1"
    assert s.get_attr("full_name") == "desc"
    assert s.get_bases() == "ACGU"


def test_native_large_roundtrip(lib, tmp_path):
    from sina_tpu import testing
    from sina_tpu.io.fasta import FastaWriter

    db = testing.make_reference(n_seqs=50, n_core=200, width=400, seed=3)
    p = tmp_path / "db.fasta"
    with FastaWriter(p) as w:
        for s in db.sequences:
            w.write(s)
    nat = list(fio.read_fasta(p, use_native=True))
    assert len(nat) == 50
    for a, b in zip(nat, db.sequences):
        assert a.get_aligned() == b.get_aligned()


def test_native_count_cols(lib):
    import numpy as np

    rng = np.random.default_rng(5)
    width = 300
    all_pos, starts, lens = [], [], []
    fam_sizes = []
    for _ in range(7):
        nm = int(rng.integers(1, 6))
        fam_sizes.append(nm)
        for _ in range(nm):
            n = int(rng.integers(5, 80))
            p = np.sort(
                rng.choice(width, size=n, replace=False)
            ).astype(np.uint32)
            starts.append(sum(lens))
            lens.append(n)
            all_pos.append(p)
    flat = np.concatenate(all_pos)
    out = native.count_cols(
        flat,
        np.array(starts, np.int64),
        np.array(lens, np.int64),
        np.array(fam_sizes, np.int64),
        width,
    )
    assert out is not None
    # reference: per-family union size
    cur = 0
    k = 0
    for b, nm in enumerate(fam_sizes):
        cols = set()
        for _ in range(nm):
            cols.update(all_pos[k].tolist())
            k += 1
        assert out[b] == len(cols)


def test_count_cols_batch_matches_unique():
    import numpy as np

    from sina_tpu import testing
    from sina_tpu.align import _count_cols_batch

    db = testing.make_reference(
        n_seqs=30, n_core=150, width=300, seed=9
    )
    db.ensure_flat()
    fams = [db.sequences[i : i + 5] for i in range(0, 30, 5)]
    got = _count_cols_batch(fams)
    want = [
        len(np.unique(np.concatenate([r.positions for r in f])))
        for f in fams
    ]
    assert list(got) == want


def test_native_build_profiles_packed_bit_exact():
    """The in-C++ quantiser must be bit-exact vs build_profiles_batch
    followed by the python _pack_fgq (both the freq bytes and the
    int16 gap-cost fixed point)."""
    import numpy as np

    from sina_tpu import testing
    from sina_tpu.ops.align_kernel import DpParams
    from sina_tpu.ops.profile import (
        _gap_scale, _pack_fgq, build_profiles_batch,
        build_profiles_packed_batch,
    )

    db = testing.make_reference(
        n_seqs=40, n_core=200, width=400, seed=11
    )
    db.ensure_flat()
    fams = [db.sequences[i : i + 8] for i in range(0, 40, 8)]
    params = DpParams(
        match=-2.0, mismatch=1.0, gap_open=5.0, gap_ext=2.0
    )
    cpad = 512
    freqs, gapo, gape, cols_a = build_profiles_batch(fams, cpad)
    gapcost = (
        params.gap_open * gapo + params.gap_ext * gape
    ).astype(np.float32)
    want = _pack_fgq(freqs, gapcost, params)
    got, cols_b = build_profiles_packed_batch(fams, cpad, params)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.array_equal(got, want)
    for a, b in zip(cols_a, cols_b):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    # quantisation sanity: int16 gap costs round-trip within half a
    # fixed-point step
    gi = (
        got[:, :, 4:6]
        .copy()
        .view(np.int16)
        .reshape(got.shape[0], cpad)
    )
    back = gi.astype(np.float64) / _gap_scale(params)
    assert np.max(np.abs(back - gapcost)) <= 0.5 / _gap_scale(params)


def test_native_kmer_lists_match_python():
    import numpy as np

    from sina_tpu import native, testing
    from sina_tpu.ops.kmer import kmers_of_masks, BASE_A

    db = testing.make_reference(
        n_seqs=40, n_core=300, width=500, seed=21
    )
    offsets, _, flat_mask4 = db.flat_arrays()
    for fast in (True, False):
        built = native.build_kmer_lists(flat_mask4, offsets, 10, fast)
        assert built is not None, "native library unavailable"
        kmers, koff = built
        prefix = BASE_A if fast else None
        for i, s in enumerate(db.sequences):
            want = np.unique(
                kmers_of_masks(s.masks, 10, prefix_base=prefix)
            )
            got = kmers[koff[i] : koff[i + 1]]
            np.testing.assert_array_equal(got, want)


def test_native_kmer_lists_ambiguity_and_short():
    import numpy as np

    from sina_tpu import native, alphabet
    from sina_tpu.ops.kmer import kmers_of_masks

    # seq 0: too short; seq 1: has an N in the middle
    m0 = np.array([alphabet.M_A] * 5, np.uint8)
    m1 = np.array(
        [alphabet.M_A] * 12 + [0xF] + [alphabet.M_C] * 12, np.uint8
    )
    flat = np.concatenate([m0, m1])
    offsets = np.array([0, 5, len(flat)], np.int64)
    built = native.build_kmer_lists(flat, offsets, 10, False)
    assert built is not None
    kmers, koff = built
    assert koff[1] - koff[0] == 0
    want = np.unique(kmers_of_masks(m1, 10))
    np.testing.assert_array_equal(kmers[koff[1] : koff[2]], want)


def test_native_fill_packed_matches_numpy():
    import numpy as np

    from sina_tpu import native, testing
    from sina_tpu.ops.kmer_index import KmerIndex

    db = testing.make_reference(
        n_seqs=50, n_core=300, width=500, seed=22
    )
    idx = KmerIndex.build(db, k=8, fast=True)
    P_native = idx.dense_packed()
    # recompute via the numpy fallback
    s_pad = -(-idx.n_seqs // 1024) * 1024
    P_np = np.zeros((idx.n_rows + 1, s_pad // 8), dtype=np.uint8)
    seq_ids = np.repeat(
        np.arange(idx.n_seqs, dtype=np.int64),
        np.diff(idx.seq_offsets),
    )
    np.bitwise_or.at(
        P_np,
        (idx.seq_kmers, seq_ids >> 3),
        (np.uint8(1) << (seq_ids & 7).astype(np.uint8)),
    )
    np.testing.assert_array_equal(P_native, P_np)


def test_native_build_graphs_matches_python(monkeypatch):
    import numpy as np

    from sina_tpu import testing
    from sina_tpu.ops.graph import build_graph, build_graphs_batch

    monkeypatch.setenv("SINA_TPU_NATIVE_GRAPHS", "1")
    db = testing.make_reference(n_seqs=40, n_core=250, width=400,
                                seed=41)
    db.ensure_flat()
    fams = [db.sequences[i : i + 8] for i in range(0, 32, 8)]
    nat = build_graphs_batch(fams)
    for f, g in zip(fams, nat):
        ref = build_graph(f)
        np.testing.assert_array_equal(ref.pos, g.pos)
        np.testing.assert_array_equal(ref.mask, g.mask)
        np.testing.assert_allclose(ref.weight, g.weight, rtol=1e-6)
        np.testing.assert_array_equal(ref.preds, g.preds)
        np.testing.assert_array_equal(ref.is_start, g.is_start)
        np.testing.assert_array_equal(ref.is_end, g.is_end)
        np.testing.assert_array_equal(ref.max_insert, g.max_insert)


def test_native_contains_matches_string_path(lib):
    """sina_contains parity with try_copy_alignment's normalized
    base-string containment (upper + U->T): offsets agree and the
    copy-path results are identical with and without the native
    batch (align._containment_batch)."""
    from sina_tpu import testing
    from sina_tpu.align import (
        AlignerConfig, _containment_batch, try_copy_alignment,
    )
    from sina_tpu.testing import unaligned_copy

    db = testing.make_reference(
        n_seqs=40, n_core=120, width=240, seed=5
    )
    db.ensure_flat()
    # queries: exact duplicates, substrings, and non-members
    queries, families = [], []
    for i in range(12):
        fam = [
            (float(40 - j), db.sequences[(i * 3 + j) % 40])
            for j in range(6)
        ]
        q = unaligned_copy(db.sequences[i % 40])
        if i % 3 == 1:
            # substring query (strictly contained)
            q.masks = q.masks[3 : len(q.masks) - 4]
            q.positions = np.arange(len(q.masks), dtype=np.uint32)
        elif i % 3 == 2:
            # mutate one base -> usually not contained
            q.masks = q.masks.copy()
            q.masks[5] = 1 if q.masks[5] != 1 else 2
        queries.append(q)
        families.append(fam)
    cont = _containment_batch(queries, families)
    assert cont is not None, "native containment unavailable"
    cfg = AlignerConfig()
    for i, (q, fam) in enumerate(zip(queries, families)):
        log_a, log_b = [], []
        got_a, fam_a = try_copy_alignment(
            q, list(fam), cfg, log_a, offsets=cont[i]
        )
        got_b, fam_b = try_copy_alignment(
            q, list(fam), cfg, log_b
        )
        assert (got_a is None) == (got_b is None)
        if got_a is not None:
            np.testing.assert_array_equal(
                got_a.positions, got_b.positions
            )
            assert log_a == log_b
        assert [it[1] for it in fam_a] == [it[1] for it in fam_b]
    # realign mode drops the same members
    cfg_r = AlignerConfig(realign=True)
    for i, (q, fam) in enumerate(zip(queries, families)):
        log_a, log_b = [], []
        got_a, fam_a = try_copy_alignment(
            q, list(fam), cfg_r, log_a, offsets=cont[i]
        )
        got_b, fam_b = try_copy_alignment(
            q, list(fam), cfg_r, log_b
        )
        assert got_a is None and got_b is None
        assert [it[1] for it in fam_a] == [it[1] for it in fam_b]
        assert log_a == log_b
