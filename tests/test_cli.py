"""CLI interface tests (main.py — the DeepRecSys.py analog)."""

import json

import numpy as np
import pytest

from deeprecsys_tpu.main import build_parser, model_config_from_args, serving_config_from_args, main


def parse(argv):
    return build_parser().parse_args(argv)


def test_model_selection_zoo_and_json(tmp_path):
    args = parse(["--model", "rm2", "--table_scale", "100"])
    cfg = model_config_from_args(args)
    assert cfg.model_name == "rm2" and cfg.table_scale == 100

    j = {
        "arch_mlp_bot": "8-4",
        "arch_mlp_top": "16-1",
        "arch_embedding_size": "50-60",
        "arch_sparse_feature_size": 4,
        "num_indices_per_lookup": 2,
        "arch_interaction_op": "cat",
        "model_type": "dlrm",
        "model_name": "custom",
    }
    p = tmp_path / "custom.json"
    p.write_text(json.dumps(j))
    cfg2 = model_config_from_args(parse(["--model", str(p)]))
    assert cfg2.model_name == "custom" and cfg2.embedding_rows == (50, 60)


def test_serving_config_mapping():
    args = parse([
        "--queue", "--inference_engines", "3", "--engine_backend", "sim",
        "--batch_configs", "16-32-64", "--tune_batch_qps",
        "--avg_arrival_rate", "2.5", "--target_latency", "30",
    ])
    cfg = serving_config_from_args(args)
    assert cfg.inference_engines == 3
    assert cfg.batch_configs == (16, 32, 64)
    assert cfg.tune_batch_qps
    assert cfg.avg_arrival_rate_ms == 2.5
    assert cfg.target_latency_ms == 30


def test_standalone_run_prints_reference_totals(capsys):
    res = main(["--model", "ncf", "--table_scale", "1000",
                "--num_batches", "2", "--mini_batch_size", "4"])
    out = capsys.readouterr().out
    assert "Total data loading time: ***" in out
    assert "Total computation time: ***" in out
    assert "Total execution time: ***" in out
    assert res["total_ms"] > 0


def test_queue_run_end_to_end(capsys):
    res = main([
        "--model", "ncf", "--table_scale", "1000", "--queue",
        "--engine_backend", "cpu", "--num_batches", "6",
        "--batch_size_distribution", "fixed", "--avg_mini_batch_size", "8",
        "--max_mini_batch_size", "16", "--sub_task_batch_size", "8",
        "--avg_arrival_rate", "1", "--req_granularity", "2",
    ])
    out = capsys.readouterr().out
    assert "Measured QPS:" in out
    assert res.cpu_requests == 6
    assert np.isfinite(res.p95_ms)


@pytest.mark.parametrize("source", ["env", "flag", "default"])
def test_compilation_cache_flag(tmp_path, monkeypatch, source):
    """JAX_COMPILATION_CACHE_DIR wins and nothing is set in code; else
    --compilation_cache_dir; else the fixed .jax_cache in the checkout."""
    import jax

    from deeprecsys_tpu.main import main
    from deeprecsys_tpu.utils.devices import DEFAULT_COMPILE_CACHE

    before = jax.config.jax_compilation_cache_dir
    argv = ["--model", "ncf", "--table_scale", "2000", "--num_batches", "2",
            "--mini_batch_size", "8"]
    if source == "env":
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
        argv += ["--compilation_cache_dir", str(tmp_path / "flag")]
        want = before
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        if source == "flag":
            argv += ["--compilation_cache_dir", str(tmp_path / "flag")]
            want = str(tmp_path / "flag")
        else:
            want = str(DEFAULT_COMPILE_CACHE)
    try:
        main(argv)
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def _synthetic_ladder(directory, model="rm1"):
    """An accelerator latency ladder in experiments/sweep.py's format."""
    directory.mkdir(parents=True, exist_ok=True)
    (directory / f"accel_{model}.json").write_text(json.dumps(
        {"batch_sizes": [1, 4, 16, 64, 256, 1024],
         "latencies_ms": [0.05, 0.06, 0.08, 0.12, 0.3, 1.0], "base": 4.0}))
    return directory


def test_queue_sim_backend_auto_calibrates(capsys, tmp_path, monkeypatch):
    """--engine_backend sim loads the model's recorded accelerator ladder
    for the sim engines (and the offload engine) — the calibrated-sim CLI
    path."""
    import deeprecsys_tpu.main as cli

    monkeypatch.setattr(cli, "CHARACTERIZATION_DIR",
                        _synthetic_ladder(tmp_path / "char"))
    res = cli.main(["--model", "rm1", "--table_scale", "5000", "--queue",
                "--engine_backend", "sim", "--inference_engines", "2",
                "--num_batches", "8", "--avg_arrival_rate", "1",
                "--avg_mini_batch_size", "16", "--max_mini_batch_size", "32",
                "--sub_task_batch_size", "16"])
    assert res.num_responses == 8
    assert "sim engines calibrated from" in capsys.readouterr().out


def test_serve_mode_sigterm_shutdown(tmp_path):
    """--serve exits cleanly on SIGTERM (production shutdown path)."""
    import os
    import signal
    import subprocess
    import sys
    import time
    import urllib.request

    proc = subprocess.Popen(
        [sys.executable, "-m", "deeprecsys_tpu.main", "--model", "ncf",
         "--table_scale", "2000", "--serve", "--port", "0",
         "--engine_backend", "cpu", "--inference_engines", "1",
         "--max_mini_batch_size", "8", "--sub_task_batch_size", "8"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        port = None
        deadline = time.time() + 120
        lines = []
        while time.time() < deadline:
            line = proc.stdout.readline()
            lines.append(line)
            if "serving on http" in line:
                port = int(line.split(":")[2].split(" ")[0].split("/")[0])
                break
        assert port, lines[-5:]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/healthz",
                                    timeout=30) as r:
            assert r.status == 200
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert "shutting down serving" in out
        assert proc.returncode == 0
    finally:
        if proc.poll() is None:
            proc.kill()


def test_serve_mode_sim_calibrated(tmp_path):
    """--serve with engine_backend=sim auto-loads the model's accelerator
    characterization (it used to crash at startup: the calibrated-sim
    loader was only wired into --queue)."""
    import json
    import os
    import subprocess
    import sys
    import time
    import urllib.request

    char = _synthetic_ladder(tmp_path / "char")
    argv = ["--model", "rm1", "--table_scale", "2000", "--serve", "--port",
            "0", "--engine_backend", "sim", "--inference_engines", "1",
            "--max_mini_batch_size", "8", "--sub_task_batch_size", "8"]
    launcher = ("import sys, pathlib, deeprecsys_tpu.main as m; "
                "m.CHARACTERIZATION_DIR = pathlib.Path(sys.argv[1]); "
                "m.main(sys.argv[2:])")
    proc = subprocess.Popen(
        [sys.executable, "-c", launcher, str(char)] + argv,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        port = None
        calibrated = False
        deadline = time.time() + 120
        lines = []
        while time.time() < deadline:
            line = proc.stdout.readline()
            lines.append(line)
            calibrated = calibrated or "sim engines calibrated from" in line
            if "serving on http" in line:
                port = int(line.split(":")[2].split(" ")[0].split("/")[0])
                break
        assert port, lines[-5:]
        assert calibrated, lines
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/infer",
            data=json.dumps({"batch_size": 4}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            assert json.loads(r.read())["batch_size"] == 4
    finally:
        proc.kill()
        proc.wait(timeout=30)


def test_bench_end_to_end_emits_valid_json(tmp_path, capsys, monkeypatch):
    """bench.py is the judged artifact: the full main() flow (baseline
    staleness incl. model coverage, suite run, one-line output) must
    produce PARSEABLE strict JSON with a numeric vs_baseline."""
    import bench

    monkeypatch.setattr(bench, "BASELINE_PATH", tmp_path / "cpu_baseline.json")
    monkeypatch.setattr(bench, "DETAIL_PATH", tmp_path / "last_bench.json")
    monkeypatch.setattr(bench, "MODELS", ("ncf", "wnd"))
    argv = ["bench", "--batch", "32", "--table-scale", "2000", "--iters", "8",
            "--models", "ncf", "wnd"]
    monkeypatch.setattr("sys.argv", argv)
    bench.main()  # JAX_PLATFORMS=cpu (conftest): the explicit CPU device
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert len(lines) == 1
    out = json.loads(lines[-1])  # strict JSON (NaN would fail)
    assert out["unit"] == "samples/s" and out["value"] > 0
    assert isinstance(out["vs_baseline"], (int, float))
    detail = json.loads((tmp_path / "last_bench.json").read_text())
    assert set(detail["accel"]) == {"ncf", "wnd"}

    # A cached baseline MISSING a requested model is stale (coverage):
    # rerunning with a third model must remeasure rather than shrink the
    # speedup geomean to a subset.
    monkeypatch.setattr(bench, "MODELS", ("ncf", "wnd", "dien"))
    monkeypatch.setattr("sys.argv", argv[:-2] + ["ncf", "wnd", "dien"])
    bench.main()
    out2 = json.loads([l for l in capsys.readouterr().out.splitlines()
                       if l.startswith("{")][-1])
    assert isinstance(out2["vs_baseline"], (int, float))
    base = json.loads((tmp_path / "cpu_baseline.json").read_text())
    assert set(base["results"]) >= {"ncf", "wnd", "dien"}


def test_standalone_checkpoint_and_score_output(tmp_path):
    """Offline batch scoring: --checkpoint starts from trained weights
    (not random init) and --score_output writes the computed scores —
    the train -> checkpoint -> score loop without a serving process.
    (The reference discards its outputs after measuring the blob size,
    inferenceEngine.py:52-58, and re-randomizes weights every start.)"""
    import jax
    import numpy as np

    from deeprecsys_tpu import zoo
    from deeprecsys_tpu.data import RecDataGenerator
    from deeprecsys_tpu.models import get_model
    from deeprecsys_tpu.models.base import Batch
    from deeprecsys_tpu.utils.checkpoint import save_params

    cfg = zoo.get_config("ncf", table_scale=2000)
    model = get_model(cfg)
    # A DIFFERENT key than the CLI's seed-0 default init: matching scores
    # can only come from the checkpoint actually being loaded.
    trained = model.init(jax.random.PRNGKey(99))
    save_params(tmp_path / "ckpt", trained)

    out = tmp_path / "scores.npz"
    main(["--model", "ncf", "--table_scale", "2000", "--num_batches", "3",
          "--mini_batch_size", "4", "--nepochs", "1",
          "--checkpoint", str(tmp_path / "ckpt"),
          "--score_output", str(out)])
    with np.load(out) as d:
        scores = d["scores"]
    assert scores.shape[0] == 12  # 3 batches x 4 rows

    gen = RecDataGenerator(cfg, seed=123)  # the CLI's numpy_rand_seed default
    batches = [gen.generate_batch(4) for _ in range(3)]
    want = np.concatenate([np.asarray(model.apply(
        trained, Batch(dense=None, indices=jax.numpy.asarray(b.indices))),
        dtype=np.float32) for b in batches], axis=0)
    np.testing.assert_allclose(scores, want, rtol=1e-5, atol=1e-6)

    # --nepochs 0 ("skip the characterization epochs, just score") still
    # writes scores instead of crashing on an unbound epoch output.
    out0 = tmp_path / "scores0.npz"
    main(["--model", "ncf", "--table_scale", "2000", "--num_batches", "3",
          "--mini_batch_size", "4", "--nepochs", "0",
          "--checkpoint", str(tmp_path / "ckpt"),
          "--score_output", str(out0)])
    with np.load(out0) as d:
        np.testing.assert_allclose(d["scores"], want, rtol=1e-5, atol=1e-6)
