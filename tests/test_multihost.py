"""Real 2-process jax.distributed test (CPU only): spawns two
CPU processes with 4 virtual devices each, initialises the
coordination service, runs the sharded k-mer search over the global
(dp=2, mp=4) mesh, and checks the merged top-k against a
single-device oracle plus the per-host --fasta-block parameters.

This exercises the path the reference covers with multi-process
--fasta-block runs + the psina wrapper (rw_fasta.cpp:209-242,
SURVEY §2.8); collectives ride the Gloo CPU backend here, ICI/DCN on
real pods (parallel/multihost.py).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_distributed(tmp_path):
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(HERE.parent) + os.pathsep + env.get(
        "PYTHONPATH", ""
    )
    fasta = tmp_path / "in.fasta"
    fasta.write_text(
        "".join(f">S{i}\nACGTACGTAC\n" for i in range(32))
    )
    outs = [tmp_path / f"out{i}.json" for i in range(2)]
    procs = [
        subprocess.Popen(
            [
                sys.executable, str(HERE / "mh_worker.py"),
                str(i), "2", str(port), str(outs[i]), str(fasta),
            ],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            cwd=str(HERE.parent),
            env=env,
        )
        for i in range(2)
    ]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
            errs.append("TIMEOUT")
        if p.returncode != 0:
            errs.append(err.decode(errors="replace")[-2000:])
    assert not errs, errs

    results = [json.loads(o.read_text()) for o in outs]
    for r in results:
        assert r["nproc"] == 2
        assert r["global_devices"] == 8
        assert r["local_devices"] == 4
    # both processes see the same merged global top-k
    np.testing.assert_array_equal(
        np.asarray(results[0]["vals"]), np.asarray(results[1]["vals"])
    )
    np.testing.assert_array_equal(
        np.asarray(results[0]["ids"]), np.asarray(results[1]["ids"])
    )
    # merged scores match the single-device oracle
    np.testing.assert_array_equal(
        np.asarray(results[0]["vals"]),
        np.asarray(results[0]["oracle_vals"]),
    )
    # per-host input shards partition the file
    shards = [r["shard"] for r in results]
    assert shards[0]["fasta_idx"] == 0
    assert shards[1]["fasta_idx"] == 1
    assert shards[0]["fasta_block"] == shards[1]["fasta_block"]
    size = fasta.stat().st_size
    assert shards[0]["fasta_block"] * 2 >= size


def test_multihost_cli_end_to_end(tmp_path):
    """Two processes run the full CLI with --multihost: per-host
    --fasta-block input shards are derived automatically, outputs go
    to <out>.part<idx>, and together they cover every query."""
    import sys

    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(HERE.parent) + os.pathsep + env.get(
        "PYTHONPATH", ""
    )
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

    # build fixture files
    fix = subprocess.run(
        [
            sys.executable, "-c",
            """
import sys
sys.argv = ['x']
import jax; jax.config.update('jax_platforms', 'cpu')
from sina_tpu import testing
from sina_tpu.io.fasta import FastaWriter
db = testing.make_reference(n_seqs=80, n_core=400, width=700, seed=5)
with FastaWriter(%r) as w:
    for s in db.sequences: w.write(s)
with FastaWriter(%r) as w:
    for q in testing.make_queries(db, n=12, seed=3, branch_len=0.5):
        w.write(testing.unaligned_copy(q))
""" % (str(tmp_path / "ref.fasta"), str(tmp_path / "q.fasta")),
        ],
        env=env, cwd=str(HERE.parent), capture_output=True,
    )
    assert fix.returncode == 0, fix.stderr.decode()[-1500:]

    out = tmp_path / "out.fasta"
    procs = [
        subprocess.Popen(
            [
                sys.executable, "-m", "sina_tpu",
                "-i", str(tmp_path / "q.fasta"),
                "-o", str(out),
                "-r", str(tmp_path / "ref.fasta"),
                "--fs-min", "8", "--fs-max", "8",
                "--fs-full-len", "300", "--fs-req-gaps", "1",
                "--multihost",
                "--coordinator", f"localhost:{port}",
                "--num-processes", "2",
                "--process-id", str(i),
            ],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            cwd=str(HERE.parent), env=env,
        )
        for i in range(2)
    ]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
            errs.append("TIMEOUT")
        if p.returncode != 0:
            errs.append(err.decode(errors="replace")[-2000:])
    assert not errs, errs

    names = []
    for i in range(2):
        part = tmp_path / f"out.fasta.part{i}"
        assert part.exists()
        names += [
            line[1:].split()[0]
            for line in part.read_text().splitlines()
            if line.startswith(">")
        ]
    assert sorted(names) == sorted(f"QRY{i:04d}" for i in range(12))
