"""Benchmark: full-length rRNA alignment throughput on one GPU.

Headline metric mirrors the reference's own number — full-length
sequences aligned per second against a reference database
(/root/reference/README.rst:33: 100k seqs vs SILVA NR in 40 min on a
2018 desktop ≈ 42 seq/s).  Workload: synthetic full-length (~1400nt)
queries against a synthetic SILVA-like reference; steady-state rate
measured after a warmup batch (compile time excluded, as the
reference's number excludes ARB/index startup).

Prints ONE json line:
  {"metric": ..., "value": N, "unit": "seq/s", "vs_baseline": N,
   "device": {"platform": ..., "kind": ..., "count": N}, ...}
Refuses to run unless JAX's default device is a GPU; with --cpu it
runs on the CPU and says so in the metric name.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

BASELINE_SEQ_S = 42.0  # reference: 100k full-length / 40 min

from sina_tpu.jax_setup import setup_jax

setup_jax()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-refs", type=int, default=2000)
    ap.add_argument("--width", type=int, default=2400)
    ap.add_argument("--n-core", type=int, default=1450)
    ap.add_argument("--n-queries", type=int, default=None,
                    help="default 640 (5*batch for --amplicon)")
    ap.add_argument(
        "--batch-size", type=int, default=None,
        help="default 128 (1024 for --amplicon: short queries "
        "amortise per-dispatch overhead over larger batches)",
    )
    ap.add_argument("--fs-max", type=int, default=40)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (metric names say so)")
    ap.add_argument(
        "--amplicon", action="store_true",
        help="V4-amplicon workload (~250nt queries; the reference's "
        "second headline: 1M amplicons/h ~ 280 seq/s)",
    )
    ap.add_argument(
        "--col-trim-min", type=int, default=None,
        help="override AlignerConfig.col_trim_min_cols (0 forces "
        "column-trimming on; default keeps the config gate)",
    )
    ap.add_argument(
        "--graph", action="store_true",
        help="use the graph (mseq DAG) aligner engine instead of the "
        "default profile chain",
    )
    ap.add_argument(
        "--search", action="store_true",
        help="measure the search+LCA stage (candidate retrieval, "
        "comparator rescoring, taxonomy vote) instead of alignment",
    )
    ap.add_argument(
        "--curve", action="store_true",
        help="throughput-vs-index-size curve: run the full-length "
        "workload at n_refs = 2k / 20k / 100k (width 50k for the "
        "SILVA-scale points) and print one JSON line per point",
    )
    args = ap.parse_args()
    if args.batch_size is None:
        args.batch_size = 1024 if args.amplicon else 128
    if args.n_queries is None:
        # keep a timed phase of >=4 batches after the warmup batch
        args.n_queries = (
            5 * args.batch_size if args.amplicon else 640
        )

    if args.curve:
        import subprocess

        for n, w, nc in (
            (2000, 2400, 1450),
            (20000, 50000, 1450),
            (100000, 50000, 1450),
        ):
            subprocess.run(
                [
                    sys.executable, __file__,
                    "--n-refs", str(n), "--width", str(w),
                    "--n-core", str(nc),
                    "--n-queries", str(args.n_queries),
                    "--batch-size", str(args.batch_size),
                ]
                + (["--cpu"] if args.cpu else []),
                check=False,
            )
        return 0

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    dev = jax.devices()[0]
    device = {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }
    if dev.platform != "gpu" and not args.cpu:
        print(f"bench.py: no GPU (JAX's default device is {dev}); "
              "pass --cpu to run on the CPU", file=sys.stderr)
        return 1
    where = "CPU" if args.cpu else f"{device['count']} GPU"

    import numpy as np

    from sina_tpu import testing
    from sina_tpu.align import (
        AlignerConfig, align_batch, align_dispatch, align_finalize,
    )
    from sina_tpu.famfinder import FamFinder, FamFinderConfig

    t0 = time.time()
    if args.n_refs > 5000:
        # tree generator is O(width) per node; the block generator
        # handles SILVA-scale (100k+ seqs, 50k cols) in seconds
        db = testing.make_reference_large(
            args.n_refs,
            n_core=args.n_core,
            width=args.width,
            seed=1234,
        )
    else:
        db = testing.make_reference(
            n_seqs=args.n_refs,
            n_core=args.n_core,
            width=args.width,
            seed=1234,
        )
    queries = [
        testing.unaligned_copy(q)
        for q in testing.make_queries(
            db, n=args.n_queries, seed=7, branch_len=0.7
        )
    ]
    if args.amplicon:
        # trim to a ~250nt window (V4-amplicon style)
        for q in queries:
            lo = min(400, max(0, len(q.masks) - 250) // 2)
            q.masks = q.masks[lo : lo + 250]
            import numpy as _np

            q.positions = _np.arange(len(q.masks), dtype=_np.uint32)
            q.width = len(q.masks)
    t_gen = time.time() - t0

    t0 = time.time()
    finder = FamFinder(
        db,
        FamFinderConfig(
            fs_min=args.fs_max,
            fs_max=args.fs_max,
            fs_full_len=min(1400, args.n_core - 100),
            fs_req_gaps=1,
        ),
    )
    # place the index in device memory and BLOCK until it is truly
    # resident: device_put is async, so without this the multi-GB
    # tail of the upload completes inside the first famfinder call
    # and masquerades as warmup (the r4/r5 "unexplained 250-460s
    # warmup with hits=N misses=0")
    jax.block_until_ready(finder._matrix())
    t_index = time.time() - t0

    if args.search:
        # search+LCA stage over prealigned queries (the reference's
        # search_filter workload, search_filter.cpp:243-416)
        from sina_tpu.search import SearchConfig, SearchFilter

        searcher = SearchFilter(
            db,
            SearchConfig(
                min_sim=0.5, lca_fields=["tax_slv"],
                kmer_candidates=min(1000, len(db)),
            ),
            finder,
        )
        aligned = [
            q for q in testing.make_queries(
                db, n=args.n_queries, seed=7, branch_len=0.7
            )
        ]
        t0 = time.time()
        searcher.process_batch(aligned[: args.batch_size])
        t_warm = time.time() - t0
        t0 = time.time()
        n_done = 0
        for i in range(args.batch_size, len(aligned), args.batch_size):
            out = searcher.process_batch(
                aligned[i : i + args.batch_size]
            )
            n_done += sum(
                1
                for a in out
                if a is not None and a.get_attr("nearest_slv")
            )
        elapsed = time.time() - t0
        n_timed = len(aligned) - args.batch_size
        rate = n_timed / elapsed if elapsed > 0 else 0.0
        print(
            f"# search warmup={t_warm:.1f}s timed {n_timed} in "
            f"{elapsed:.1f}s (classified {n_done})",
            file=sys.stderr,
        )
        print(
            json.dumps(
                {
                    "metric": "search+LCA classification throughput "
                    f"({where})",
                    "value": round(rate, 2),
                    "unit": "seq/s",
                    "vs_baseline": round(rate / BASELINE_SEQ_S, 2),
                    "device": device,
                }
            )
        )
        return 0

    acfg = AlignerConfig(engine="graph" if args.graph else "auto")
    if args.col_trim_min is not None:
        acfg.col_trim_min_cols = args.col_trim_min

    # warmup (compile), then prewarm the remaining DP row buckets so
    # a data-dependent bucket split in the timed phase never hits a
    # fresh compile; compiles after this log a loud warning.  Phases
    # are timed separately so a slow warmup is attributable
    # (famfinder score+fetch vs aligner dispatch vs DP finalize vs
    # row-bucket prewarm).
    t0 = time.time()
    wbatch = queries[: args.batch_size]
    wres = finder.process_batch(wbatch)
    t_w_ff = time.time() - t0
    t1 = time.time()
    wstate = align_dispatch(
        wbatch,
        [r.family if not r.failed else [] for r in wres],
        acfg,
    )
    t_w_disp = time.time() - t1
    t1 = time.time()
    n_warm = sum(1 for a in align_finalize(wstate) if a is not None)
    t_w_fin = time.time() - t1
    from sina_tpu.jax_setup import mark_warmup_done
    from sina_tpu.ops.profile import prewarm_row_buckets

    t1 = time.time()
    prewarm_row_buckets(args.batch_size)
    t_w_pre = time.time() - t1
    mark_warmup_done()
    t_warm = time.time() - t0
    print(
        f"# warmup breakdown: famfinder={t_w_ff:.1f}s "
        f"align-dispatch={t_w_disp:.1f}s dp-finalize={t_w_fin:.1f}s "
        f"prewarm={t_w_pre:.1f}s (total {t_warm:.1f}s)",
        file=sys.stderr,
    )
    # timers below report the STEADY STATE only (warmup compiles
    # used to dominate every section and made attribution useless)
    from sina_tpu.timing import reset_all

    reset_all()

    # timed steady state: 3-deep software pipeline (famfinder N+1
    # queued, DP N in flight, host finishing N-1) as in pipeline.run.
    # The Pipeline timer wraps every top-level call in this loop, so
    # its section sum equals the timed wall (any gap = untimed bench
    # glue); inner timers (Kmer Search / Aligner / ProfileDP)
    # attribute within each section.
    from collections import deque

    from sina_tpu.timing import get_timer

    tp = get_timer("Pipeline")
    t0 = time.time()
    n_done = 0
    batches = [
        queries[i : i + args.batch_size]
        for i in range(args.batch_size, len(queries), args.batch_size)
    ]
    with tp.section("ff submit"):
        handles = [finder.submit_batch(batches[0])] if batches else []
    al_q = deque()
    for bi, batch in enumerate(batches):
        if bi + 1 < len(batches):
            with tp.section("ff submit"):
                handles.append(finder.submit_batch(batches[bi + 1]))
        with tp.section("ff policy"):
            results = finder.process_batch(batch, handle=handles[bi])
        handles[bi] = None  # drop the device top-k buffers (HBM)
        with tp.section("align dispatch"):
            al_q.append(
                align_dispatch(
                    batch,
                    [r.family if not r.failed else [] for r in results],
                    acfg,
                )
            )
        if len(al_q) >= 2:
            with tp.section("finalize"):
                n_done += sum(
                    1
                    for a in align_finalize(al_q.popleft())
                    if a is not None
                )
    while al_q:
        with tp.section("finalize"):
            n_done += sum(
                1
                for a in align_finalize(al_q.popleft())
                if a is not None
            )
    elapsed = time.time() - t0
    n_timed = len(queries) - args.batch_size

    from sina_tpu.timing import _registry

    for name, t in _registry.items():
        print(f"# timings {name}: {t}", file=sys.stderr)
    covered = sum(tp.sections.values())
    print(
        f"# wall coverage: timed={elapsed:.2f}s "
        f"pipeline-sections={covered:.2f}s "
        f"untimed-glue={elapsed - covered:.2f}s",
        file=sys.stderr,
    )

    from sina_tpu.jax_setup import cache_stats

    hits, misses = cache_stats()
    rate = n_timed / elapsed if elapsed > 0 else 0.0
    print(
        f"# gen={t_gen:.1f}s index={t_index:.1f}s warmup={t_warm:.1f}s "
        f"timed {n_timed} seqs in {elapsed:.1f}s "
        f"(aligned {n_done + n_warm}/{len(queries)}) "
        f"compile-cache hits={hits} misses={misses}",
        file=sys.stderr,
    )
    if args.amplicon:
        metric = f"V4 amplicon alignment throughput ({where})"
        baseline = 280.0  # 1M amplicons / ~60 min (README.rst:33)
    else:
        metric = f"full-length rRNA alignment throughput ({where})"
        baseline = BASELINE_SEQ_S
    if args.graph:
        metric += " [graph engine]"
    out = {
        "metric": metric,
        "value": round(rate, 2),
        "unit": "seq/s",
        "vs_baseline": round(rate / baseline, 2),
        "n_refs": args.n_refs,
        "width": args.width,
        "device": device,
    }
    # a single mid-run shape compile in the short timed phase can
    # dominate it — make a poisoned capture identify itself
    from sina_tpu.jax_setup import midrun_compile_stats

    mc, mcs = midrun_compile_stats()
    if mc:
        out["midrun_compiles"] = mc
        out["midrun_compile_s"] = round(mcs, 1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
