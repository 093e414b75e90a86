"""Smoke test of sina-tpu on one NVIDIA GPU (or four, with --four).

Runs in one process, through the entry point a user calls
(`sina_tpu.cli.main`), at SILVA scale: 100k reference sequences at
alignment width 50,000 (testing.make_reference_large) with full-length
~1450 nt reads (testing.make_queries), generated from --seed into a
scratch directory under the checkout's .work/.

Phases (any failure raises, and the script exits non-zero):
  1. device   platform, device kind and count, the card's name and
              power limit; fails unless JAX's default platform is the
              GPU and the native host library loaded;
  2. kernel   the CUDA profile chain DP against the plain XLA chain DP
              at B=128, C=2048, M=1536 and at the 2k-reference bucket
              (C=M=1536): ends identical, raw within a relative 1e-5,
              backpointer rows and full-launch emissions identical;
              prints the compiled launch's memory_analysis();
  3. end to end  three CLI runs on the GPU: the profile engine (512
              queries, FASTA + CSV, --calc-idty), --fs-graph (128) and
              -S --lca-fields tax_slv (256); checks exit codes, record
              counts, widths, bases and attributes; times one
              famfinder scoring+top-k batch against its byte bound;
  4. oracle   16 of the queries again on the CPU device in this
              process: famfinder top-k scores identical, and aligned
              rows identical wherever the best DP score is unique.
With --four only the four-GPU path runs: the index sharded over a
(dp, mp) mesh of four cards against unsharded scoring on card 0, each
card's memory_stats(), and a CLI sample against the CPU oracle.

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.

Usage: python chip_smoke.py [--four] [--seed N]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet

# famfinder options for the synthetic SILVA-scale family structure
# (the values bench.py used: fs_full_len = n_core - 100)
FS_OPTS = ["--fs-min", "40", "--fs-max", "40", "--fs-full-len", "1350",
           "--fs-req-gaps", "1"]


class SmokeError(RuntimeError):
    pass


def _keep_cpu_backend() -> None:
    """The oracle runs on JAX's CPU device in this process, so the CPU
    platform must stay enabled beside the GPU."""
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# -- 1. device ----------------------------------------------------------

def device_phase(n_devices: int):
    import jax

    from sina_tpu import native

    devs = jax.devices()
    d = devs[0]
    print(f"device: platform={d.platform} kind={d.device_kind} "
          f"count={len(devs)} JAX_PLATFORMS="
          f"{os.environ.get('JAX_PLATFORMS')}")
    if d.platform != "gpu":
        raise SmokeError(f"no GPU: JAX's default device is {d}")
    if len(devs) < n_devices:
        raise SmokeError(f"needs {n_devices} GPUs, found {len(devs)}")
    print(card_line())
    if native.get_lib() is None:
        raise SmokeError("the native host library did not load")
    return d


# -- 2. kernel ----------------------------------------------------------

def dp_case(B: int, C: int, M: int, seed: int) -> dict:
    """One profile-DP launch's inputs, on the default device: the
    quantised profiles as profile_dp_dispatch ships them (fg) and
    decoded (fq, gc), queries drawn from each profile's majority bases
    with 5% substitutions (qmask, and qm padded to the kernel layout),
    and the (query length, column count) pairs (lens)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from sina_tpu.ops import chain_dp_cuda as cc
    from sina_tpu.ops import profile as prof
    from sina_tpu.ops.align_kernel import DpParams

    params = DpParams()
    rng = np.random.default_rng(seed)
    freqs = rng.dirichlet(np.full(4, 0.3), size=(B, C)).astype(np.float32)
    freqs *= rng.uniform(0.6, 1.0, size=(B, C, 1)).astype(np.float32)
    gapcost = rng.uniform(0.0, 3.0, size=(B, C)).astype(np.float32)
    c_real = rng.integers(C - C // 8, C + 1, B).astype(np.int32)
    qlen = np.zeros(B, np.int32)
    qmask = np.zeros((B, M), np.uint8)
    for b in range(B):
        n = int(min(rng.integers(M - M // 8, M + 1), c_real[b]))
        cols = np.sort(rng.choice(c_real[b], size=n, replace=False))
        bases = 1 << np.argmax(freqs[b, cols], axis=1)
        mut = rng.random(n) < 0.05
        bases[mut] = 1 << rng.integers(0, 4, int(mut.sum()))
        qlen[b] = n
        qmask[b, :n] = bases
    fg = prof._pack_fgq(freqs, gapcost, params)
    fq, gc = jax.jit(lambda x: prof._device_unpack_fgq(x, params))(
        jnp.asarray(fg)
    )
    per_thread, m_pad = cc.layout(M)
    lens = np.stack([qlen, c_real], 1).astype(np.int32)
    return dict(
        B=B, C=C, M=M, params=params, per_thread=per_thread,
        fg=jnp.asarray(fg), qmask=jnp.asarray(qmask), fq=fq, gc=gc,
        qm=jnp.asarray(np.pad(qmask, ((0, 0), (0, m_pad - M)))),
        lens=jnp.asarray(lens), c_real=c_real,
    )


def check_kernel(case: dict) -> list[str]:
    """Compare the kernel with the XLA path on one case; prints what
    it finds and returns the failures."""
    import jax
    import numpy as np

    from sina_tpu.ops import chain_dp_cuda as cc
    from sina_tpu.ops import profile as prof

    B, C, M = case["B"], case["C"], case["M"]
    params, e = case["params"], case["per_thread"]
    args = (case["fq"], case["gc"], case["qm"], case["lens"])
    print(f"--- kernel B={B} C={C} M={M} "
          f"({case['qm'].shape[1] // e} threads x {e} lanes)")
    fwd_k = jax.jit(lambda *a: cc.chain_dp_cuda(*a, params, e))
    fwd_x = jax.jit(lambda *a: cc.chain_dp_reference(*a, params, e))
    print("kernel launch memory_analysis: "
          f"{fwd_k.lower(*args).compile().memory_analysis()}")
    bk, ck, ik, rk = (np.asarray(x) for x in fwd_k(*args))
    bx, cx, ix, rx = (np.asarray(x) for x in fwd_x(*args))
    bad = []
    for name, a, b in (("best_c", ck, cx), ("best_i", ik, ix)):
        n = int((a != b).sum())
        print(f"{name}: {n} of {B} differ")
        if n:
            bad.append(f"{name} differs in {n} rows")
    rel = float(
        (np.abs(rk - rx) / np.maximum(np.abs(rx), 1.0)).max()
    )
    print(f"raw: max relative difference {rel:.3e} "
          f"({int((rk != rx).sum())} of {B} not bit-identical)")
    if rel > 1e-5:
        bad.append(f"raw differs by {rel:.3e} relative")
    rows = np.arange(C)[None, :] < case["c_real"][:, None]
    n = int(((bk != bx).any(axis=2) & rows).sum())
    print(f"backpointer rows: {n} of {int(rows.sum())} differ")
    if n:
        bad.append(f"{n} backpointer rows differ")
    launch = (case["fg"], case["qmask"], case["lens"])
    ek = prof._unpack_log_result(
        np.asarray(prof._profile_kernel_fn(C, M, params)(*launch)), M
    )[0]
    ex = prof._unpack_result(
        np.asarray(prof._profile_batched_fn(C, M, params)(*launch))
    )[0]
    n = int((ek != ex).any(axis=1).sum())
    print(f"full launch: {n} of {B} emission rows differ")
    if n:
        bad.append(f"{n} emission rows differ")
    return bad


def kernel_phase(seed: int) -> None:
    bad = []
    for C, M in ((2048, 1536), (1536, 1536)):
        bad += check_kernel(dp_case(128, C, M, seed))
    if bad:
        raise SmokeError("kernel vs XLA: " + "; ".join(bad))


# -- 3. end to end ------------------------------------------------------

def make_fixture(work: Path, n_refs: int, width: int, n_core: int,
                 n_queries: int, seed: int):
    """Reference bundle + unaligned query FASTA, from the seed."""
    from sina_tpu import testing
    from sina_tpu.io.fasta import FastaWriter

    t0 = time.perf_counter()
    db = testing.make_reference_large(
        n_refs, n_core=n_core, width=width, seed=seed
    )
    db.save(work / "ref.sref")
    queries = [
        testing.unaligned_copy(q)
        for q in testing.make_queries(
            db, n=n_queries, seed=seed + 1, branch_len=0.7
        )
    ]
    with FastaWriter(str(work / "queries.fasta")) as w:
        for q in queries:
            w.write(q)
    print(f"fixture: {n_refs} refs, width {width}, {n_queries} queries "
          f"in {time.perf_counter() - t0:.1f} s")
    return db, queries


def write_subset(path: Path, queries) -> Path:
    from sina_tpu.io.fasta import FastaWriter

    with FastaWriter(str(path)) as w:
        for q in queries:
            w.write(q)
    return path


def run_cli(argv: list[str]) -> float:
    """sina_tpu.cli.main in this process; raises on a non-zero exit.
    Returns the wall seconds (set-up included)."""
    from sina_tpu import cli

    t0 = time.perf_counter()
    rc = cli.main(argv)
    dt = time.perf_counter() - t0
    if rc != 0:
        raise SmokeError(f"sina exited {rc}: {' '.join(argv)}")
    return dt


def read_out(path: Path) -> dict:
    from sina_tpu.io.fasta import read_fasta

    return {s.name: s for s in read_fasta(str(path))}


def check_output(path: Path, queries, width: int,
                 attrs: tuple[str, ...]) -> dict:
    out = read_out(path)
    if len(out) != len(queries):
        raise SmokeError(
            f"{path.name}: {len(out)} records for {len(queries)} queries"
        )
    for q in queries:
        s = out.get(q.name)
        if s is None:
            raise SmokeError(f"{path.name}: {q.name} missing")
        if s.width != width:
            raise SmokeError(f"{path.name}: {q.name} width {s.width}")
        if s.get_bases().upper() != q.get_bases().upper():
            raise SmokeError(f"{path.name}: {q.name} bases changed")
        missing = [a for a in attrs if a not in s.attrs]
        if missing:
            raise SmokeError(f"{path.name}: {q.name} lacks {missing}")
    return out


def mode_args(mode: str) -> list[str]:
    return {
        "profile": ["--calc-idty"],
        "graph": ["--fs-graph"],
        "search": ["-S", "--lca-fields", "tax_slv",
                   "--search-min-sim", "0.5"],
    }[mode]


MODE_ATTRS = {
    "profile": ("align_quality_slv", "align_ident_slv"),
    "graph": ("align_quality_slv",),
    "search": ("align_quality_slv", "nearest_slv", "lca_tax_slv"),
}


def end_to_end_phase(work: Path, db, queries, counts: dict) -> dict:
    """The three CLI runs; returns {mode: output path}."""
    import csv

    ref = str(work / "ref.sref")
    outs = {}
    for mode, n in counts.items():
        sub = queries[:n]
        qf = write_subset(work / f"q_{mode}.fasta", sub)
        out = work / f"gpu_{mode}.fasta"
        argv = ["-i", str(qf), "-o", str(out), "-r", ref,
                "--meta-fmt", "comment", "--batch-size", "128",
                *FS_OPTS, *mode_args(mode)]
        if mode == "profile":
            argv += ["-o", str(work / "gpu_profile.csv")]
        dt = run_cli(argv)
        check_output(out, sub, db.width, MODE_ATTRS[mode])
        if mode == "profile":
            with open(work / "gpu_profile.csv") as fh:
                n_rows = sum(1 for _ in csv.DictReader(fh))
            if n_rows != n:
                raise SmokeError(f"CSV has {n_rows} rows for {n}")
        print(f"e2e {mode}: {n} queries, wall {dt:.1f} s with set-up")
        outs[mode] = out
    return outs


def famfinder_timing(db, queries) -> None:
    """One 128-query scoring+top-k call at this index size against
    the byte bound of its gather."""
    import jax
    import numpy as np

    from sina_tpu.famfinder import (
        FamFinder, FamFinderConfig, _score_topk_compiled,
    )
    from sina_tpu.ops.kmer import query_kmers_padded

    ff = FamFinder(db, FamFinderConfig())
    P = jax.block_until_ready(ff._matrix())
    kmers, _ = query_kmers_padded(
        [q.masks for q in queries[:128]], ff.index.k,
        fast=ff.index.fast,
    )
    kmers = ff._pad_rows(kmers, P.shape[0] - 1)
    k0 = 256
    fn = _score_topk_compiled(k0)
    jax.block_until_ready(fn(P, kmers))
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(P, kmers))
        ts.append(time.perf_counter() - t0)
    t = sorted(ts)[2]
    gathered = kmers.shape[0] * kmers.shape[1] * P.shape[1]
    print(f"famfinder score+top-k: {kmers.shape[0]}x{kmers.shape[1]} "
          f"k-mers over {P.shape[0]}x{P.shape[1]} B index: median "
          f"{t * 1e3:.2f} ms, gathers {gathered / 1e9:.3f} GB = "
          f"{gathered / t / 1e9:.1f} GB/s, "
          f"{gathered / HBM_BYTES_PER_S / t:.3f} of the 3.35 TB/s "
          f"byte bound (samples ms {[round(x * 1e3, 2) for x in ts]})")


# -- 4. oracle ----------------------------------------------------------

def _raw_score(seq) -> float | None:
    log = seq.attrs.get("align_log_slv", "")
    at = log.find("raw=")
    if at < 0:
        return None
    return float(log[at + 4:].split(",", 1)[0])


def compare_rows(gpu: dict, cpu: dict, names, label: str) -> list[str]:
    """Rows of `names` in two outputs ({name: Sequence}).  A row may
    differ only where the best DP score is not unique: both runs then
    report the same raw score (relative 1e-5) for co-optimal
    alignments.  Prints every difference with both scores; returns
    the failures."""
    import numpy as np

    bad = []
    for name in names:
        g, c = gpu[name], cpu[name]
        if (np.array_equal(g.positions, c.positions)
                and np.array_equal(g.masks, c.masks)):
            continue
        rg, rc = _raw_score(g), _raw_score(c)
        tie = (rg is not None and rc is not None
               and abs(rg - rc) <= 1e-5 * max(abs(rc), 1.0))
        print(f"{label} {name}: rows differ; raw score gpu={rg} "
              f"cpu={rc} ({'co-optimal' if tie else 'MISMATCH'})")
        if not tie:
            bad.append(f"{label} {name}")
    return bad


def oracle_phase(work: Path, db, queries, gpu_outs: dict,
                 n: int = 16) -> None:
    import jax
    import numpy as np

    from sina_tpu.famfinder import FamFinder, FamFinderConfig

    sample = queries[:n]
    masks = [q.masks for q in sample]
    cpu = jax.devices("cpu")[0]
    v_gpu, _ = FamFinder(db, FamFinderConfig()).score_topk(masks, 256)
    with jax.default_device(cpu):
        v_cpu, _ = FamFinder(db, FamFinderConfig()).score_topk(
            masks, 256
        )
    n_diff = int((np.asarray(v_gpu) != np.asarray(v_cpu)).any(1).sum())
    print(f"oracle famfinder: top-256 scores differ for {n_diff} of {n}")
    bad = [f"famfinder top-k scores differ for {n_diff} queries"] \
        if n_diff else []
    qf = write_subset(work / "q_oracle.fasta", sample)
    names = [q.name for q in sample]
    for mode, gpu_out in gpu_outs.items():
        out = work / f"cpu_{mode}.fasta"
        with jax.default_device(cpu):
            run_cli(["-i", str(qf), "-o", str(out),
                     "-r", str(work / "ref.sref"),
                     "--meta-fmt", "comment", *FS_OPTS,
                     *mode_args(mode)])
        rows = compare_rows(read_out(gpu_out), read_out(out), names,
                            f"oracle {mode}")
        print(f"oracle {mode}: {n - len(rows)} of {n} rows agree")
        bad += rows
    if bad:
        raise SmokeError("oracle: " + "; ".join(bad))


# -- 5. four cards ------------------------------------------------------

def four_phase(work: Path, db, queries) -> None:
    import jax
    import numpy as np

    from sina_tpu.famfinder import (
        FamFinder, FamFinderConfig, _score_topk_compiled,
    )
    from sina_tpu.ops.kmer import query_kmers_padded

    devs = jax.devices()[:4]
    ff = FamFinder(db, FamFinderConfig())
    P = jax.block_until_ready(ff._matrix())
    print(f"four: mesh {dict(ff._mesh.shape)}, index {P.shape} "
          f"{P.nbytes / 1e9:.2f} GB, sharding {P.sharding}")
    for d in devs:
        st = d.memory_stats()
        print(f"four: {d} bytes_in_use={st['bytes_in_use']} "
              f"peak={st.get('peak_bytes_in_use')}")
    in_use = [d.memory_stats()["bytes_in_use"] for d in devs]
    if max(in_use) >= 0.9 * P.nbytes:
        raise SmokeError("the index is not split across the cards")
    masks = [q.masks for q in queries[:128]]
    v_s, _ = ff.score_topk(masks, 256)
    kmers, _ = query_kmers_padded(masks, ff.index.k, fast=ff.index.fast)
    P0 = jax.device_put(ff.index.dense_packed(), devs[0])
    kmers = ff._pad_rows(kmers, P0.shape[0] - 1)
    packed = np.asarray(_score_topk_compiled(256)(P0, kmers))[:128]
    v_1 = np.where(packed[:, 256:] >= ff.index.n_seqs, -1,
                   packed[:, :256])
    n_diff = int((np.asarray(v_s) != v_1).any(1).sum())
    print(f"four: sharded vs card-0 top-256 scores differ for "
          f"{n_diff} of 128 queries")
    del P0, ff
    if n_diff:
        raise SmokeError("sharded top-k differs from unsharded")
    sample = queries[:16]
    qf = write_subset(work / "q_four.fasta", sample)
    outs = {}
    for where in ("gpu", "cpu"):
        out = work / f"four_{where}.fasta"
        argv = ["-i", str(qf), "-o", str(out),
                "-r", str(work / "ref.sref"), "--meta-fmt", "comment",
                *FS_OPTS]
        if where == "cpu":
            with jax.default_device(jax.devices("cpu")[0]):
                run_cli(argv)
        else:
            run_cli(argv)
        outs[where] = read_out(out)
    bad = compare_rows(outs["gpu"], outs["cpu"],
                       [q.name for q in sample], "four")
    print(f"four: {16 - len(bad)} of 16 CLI rows agree with the CPU")
    if bad:
        raise SmokeError("four-card CLI output vs CPU: " + "; ".join(bad))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded path")
    ap.add_argument("--seed", type=int, default=1234)
    args = ap.parse_args(argv)
    sys.stdout.reconfigure(line_buffering=True)
    _keep_cpu_backend()
    sys.path.insert(0, str(REPO))
    import jax

    from sina_tpu import jax_setup

    jax_setup.setup_jax()
    dev = device_phase(4 if args.four else 1)
    work = REPO / ".work" / f"chip_smoke_{os.getpid()}"
    work.mkdir(parents=True)
    n_refs, width, n_core = 100_000, 50_000, 1450
    if args.four:
        db, queries = make_fixture(work, n_refs, width, n_core, 128,
                                   args.seed)
        four_phase(work, db, queries)
    else:
        kernel_phase(args.seed)
        db, queries = make_fixture(work, n_refs, width, n_core, 512,
                                   args.seed)
        outs = end_to_end_phase(
            work, db, queries,
            {"profile": 512, "graph": 128, "search": 256},
        )
        famfinder_timing(db, queries)
        oracle_phase(work, db, queries, outs)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
