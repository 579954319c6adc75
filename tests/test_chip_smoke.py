"""chip_smoke.py rehearsed on the CPU at a tiny table_scale, and its
refusal to run without a GPU."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
TINY = ["--rehearse", "--table_scale", "4000", "--batch", "8",
        "--requests", "4", "--calls", "2"]


def _run(args, tmp_path, cwd=ROOT, devices=1, script=ROOT / "chip_smoke.py"):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    return subprocess.run(
        [sys.executable, str(script), "--out", str(tmp_path / "out")] + args,
        cwd=cwd, env=env, capture_output=True, text=True, timeout=600)


def _last_json(proc):
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("four", [False, True])
def test_rehearsal_passes_every_phase(tmp_path, four):
    proc = _run(TINY + (["--four"] if four else []), tmp_path,
                devices=4 if four else 1)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    last = _last_json(proc)
    assert last == {"ok": True, "device": {
        "platform": "cpu", "kind": "cpu", "count": 4 if four else 1}}
    report = json.loads((tmp_path / "out" / (
        "report_four.json" if four else "report.json")).read_text())
    if four:
        assert report["mesh_rm2"]["worst_over_allowed"] <= 1.0
        assert "dryrun_multichip(4): ok" in proc.stdout
    else:
        assert set(report["forward"]) == {"rm1", "rm2", "rm3", "wnd",
                                          "mtwnd", "ncf", "din", "dien"}
        assert set(report["packing"]) == {"rm1", "rm3", "din"}
        assert set(report["layouts"]) == {"rm1", "rm2", "din"}
        assert report["layouts"]["rm1"]["params"] == 11
        for impl in ("xla", "hotcold"):
            served = report["serve"][impl]
            assert served["errors"] == 0 and served["matched"] == 4


def test_refuses_cpu_without_rehearse(tmp_path):
    """No GPU and no --rehearse: non-zero exit and no result line."""
    proc = _run([], tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stdout + proc.stderr


def test_fails_alone_in_a_directory(tmp_path):
    """Copied away from the repository it has nothing to run."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run(TINY, tmp_path, cwd=tmp_path,
                script=tmp_path / "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
