"""Profile chain DP on the GPU: the CUDA kernel against the XLA path.

For each (C, M) shape, at batch B:
  * checks the kernel's forward pass against the plain XLA chain DP
    (chain_dp_cuda.chain_dp_reference): best_c and best_i identical,
    raw within a relative 1e-5, backpointer rows identical;
  * checks that the two full DP launches (forward + traceback, as
    profile_dp_dispatch runs them) emit identical alignments;
  * times, on the device, each forward pass, the kernel path's lax
    traceback, and both full launches;
  * prints the compiled kernel launch's memory_analysis().
With --e2e it also aligns a seeded 2k-reference workload through
Pipeline.run with each implementation, in turns (kernel, XLA, XLA,
kernel), and prints sequences per second.

Fails (exit 1) unless JAX's default backend is the GPU, and on any
mismatch.  Inputs and checks are chip_smoke.py's (dp_case,
check_kernel).

Usage: python tools/prof_profiledp.py [--shapes 2048x1536 1536x1536]
       [--batch 128] [--reps 5] [--e2e]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # repo
sys.stdout.reconfigure(line_buffering=True)


def timeit(fn, *args, reps: int) -> tuple[float, list[float]]:
    """(median seconds, all samples) of fn(*args) run to completion."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2], ts


def check_and_time(B: int, C: int, M: int, reps: int, seed: int) -> bool:
    import jax

    from chip_smoke import check_kernel, dp_case
    from sina_tpu.ops import chain_dp_cuda as cc
    from sina_tpu.ops import profile as prof

    case = dp_case(B, C, M, seed)
    ok = not check_kernel(case)
    params, e = case["params"], case["per_thread"]
    fwd = (case["fq"], case["gc"], case["qm"], case["lens"])
    launch = (case["fg"], case["qmask"], case["lens"])
    fwd_k = jax.jit(lambda *a: cc.chain_dp_cuda(*a, params, e))
    fwd_x = jax.jit(lambda *a: cc.chain_dp_reference(*a, params, e))
    tb = jax.jit(
        lambda b, c, i: jax.vmap(
            lambda bb, cc_, ii: prof.chain_traceback_log(
                bb, cc_, ii, C, M
            )
        )(b, c, i)
    )
    bp, bc, bi, _ = fwd_k(*fwd)
    times = {
        "kernel forward": timeit(fwd_k, *fwd, reps=reps),
        "XLA forward (chain_dp)": timeit(fwd_x, *fwd, reps=reps),
        "lax traceback (kernel path)": timeit(
            tb, bp, bc, bi, reps=reps
        ),
        "kernel path, full launch": timeit(
            prof._profile_kernel_fn(C, M, params), *launch, reps=reps
        ),
        "XLA path, full launch": timeit(
            prof._profile_batched_fn(C, M, params), *launch, reps=reps
        ),
    }
    for label, (med, ts) in times.items():
        print(f"{label}: median {med * 1e3:.3f} ms "
              f"(samples {[round(t * 1e3, 3) for t in ts]})")
    print(json.dumps({
        "shape": [B, C, M],
        "ms": {k: v[0] * 1e3 for k, v in times.items()},
        "ok": ok,
    }))
    return ok


def e2e(n_queries: int, seed: int) -> None:
    """Pipeline.run over a seeded 2k-reference workload with each DP
    implementation, in turns; the XLA turns replace the backend
    choice for the profile DP only."""
    import tempfile

    from sina_tpu import backend, testing
    from sina_tpu.io.fasta import FastaWriter
    from sina_tpu.pipeline import Pipeline, PipelineConfig
    from sina_tpu.famfinder import FamFinderConfig

    scratch = Path(__file__).resolve().parent.parent / ".work"
    scratch.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="prof_profiledp_", dir=scratch))
    db = testing.make_reference(
        n_seqs=2000, n_core=1450, width=2400, seed=seed
    )
    db.save(work / "ref.sref")
    qs = testing.make_queries(db, n=n_queries, seed=seed + 1,
                              branch_len=0.7)
    with FastaWriter(str(work / "q.fasta")) as w:
        for q in qs:
            w.write(testing.unaligned_copy(q))

    import jax

    pipe = Pipeline(PipelineConfig(
        in_path=str(work / "q.fasta"),
        outputs=[("fasta", str(work / "out.fasta"))],
        db=str(work / "ref.sref"),
        famfinder=FamFinderConfig(fs_full_len=1350, fs_req_gaps=1),
    ))
    jax.block_until_ready(pipe.finder._matrix())

    def run(impl: str) -> float:
        orig = backend.dp_backend
        if impl == "xla":
            backend.dp_backend = lambda: "xla"
        try:
            return pipe.run()["seq_per_s"]
        finally:
            backend.dp_backend = orig

    run("cuda")
    run("xla")  # compile both paths before the timed turns
    for impl in ("cuda", "xla", "xla", "cuda"):
        print(f"e2e {impl}: {run(impl):.2f} seq/s "
              f"({n_queries} queries through Pipeline.run)")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", nargs="+",
                    default=["2048x1536", "1536x1536"],
                    help="CxM profile columns x query bucket")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--e2e", type=int, default=0, metavar="N",
                    help="also run the Pipeline comparison on N queries")
    args = ap.parse_args()

    import jax

    if jax.default_backend() != "gpu":
        print(f"no GPU: JAX's default backend is "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return 1
    from chip_smoke import card_line

    print(f"card: {card_line()}; device {jax.devices()[0].device_kind}")
    ok = True
    for shape in args.shapes:
        C, M = (int(x) for x in shape.split("x"))
        ok &= check_and_time(args.batch, C, M, args.reps, args.seed)
    if args.e2e:
        e2e(args.e2e, args.seed)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
