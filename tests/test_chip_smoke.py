"""chip_smoke.py's checks that run without a GPU, and the one-process-
per-card rule for bench.py."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from sina_tpu.sequence import Sequence  # noqa: E402


def test_device_phase_fails_on_cpu():
    with pytest.raises(chip_smoke.SmokeError, match="no GPU"):
        chip_smoke.device_phase(1)


def test_script_alone_fails(tmp_path):
    """Without the rest of the checkout the script fails and prints
    no result line."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize(
    "before, after",
    [(None, None), ("cpu", "cpu"), ("cuda", "cuda,cpu"),
     ("cuda,cpu", "cuda,cpu")],
)
def test_cpu_backend_kept_for_the_oracle(monkeypatch, before, after):
    if before is None:
        monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    else:
        monkeypatch.setenv("JAX_PLATFORMS", before)
    chip_smoke._keep_cpu_backend()
    assert os.environ.get("JAX_PLATFORMS") == after


def _row(name, positions, raw):
    s = Sequence(
        name, np.asarray(positions, np.uint32),
        np.full(len(positions), 1, np.uint8), 10,
        {"align_log_slv": f"scoring: raw={raw}, weight=1, "
                          f"query-len={len(positions)}, score=0.5;"},
    )
    return s


@pytest.mark.parametrize(
    "cpu_pos, cpu_raw, n_bad",
    [
        ([1, 2, 3], -12.5, 0),     # identical rows
        ([1, 2, 4], -12.5, 0),     # co-optimal: rows differ, same score
        ([1, 2, 4], -11.0, 1),     # unique best score, rows differ
    ],
)
def test_compare_rows(cpu_pos, cpu_raw, n_bad, capsys):
    gpu = {"q": _row("q", [1, 2, 3], -12.5)}
    cpu = {"q": _row("q", cpu_pos, cpu_raw)}
    bad = chip_smoke.compare_rows(gpu, cpu, ["q"], "t")
    assert len(bad) == n_bad
    if cpu_pos != [1, 2, 3]:
        assert "raw score gpu=-12.5" in capsys.readouterr().out


def test_raw_score_parse():
    assert chip_smoke._raw_score(_row("q", [0], -7.25)) == -7.25
    s = _row("q", [0], 0)
    s.attrs.pop("align_log_slv")
    assert chip_smoke._raw_score(s) is None


def test_bench_import_initialises_no_backend():
    """bench.py --curve spawns one child per point; its parent must
    not take a device before they start."""
    code = (
        "import bench\n"
        "from jax._src import xla_bridge as xb\n"
        "import json; print(json.dumps(bool(xb._backends)))\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) is False
