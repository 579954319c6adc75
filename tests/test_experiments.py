"""Smoke tests for the experiment tools (fast configs, sim/CPU backends)."""

import json

import numpy as np
import pytest

from deeprecsys_tpu.experiments.loadgen_study import main as loadgen_main
from deeprecsys_tpu.experiments.op_breakdown import breakdown_for
from deeprecsys_tpu.experiments.qps_sweep import sweep
from deeprecsys_tpu.experiments.scheduling_study import run_study


def test_op_breakdown_smoke():
    r = breakdown_for("ncf", batch_size=8, table_scale=2000, param_dtype="float32")
    assert r["model"] == "ncf"
    assert "embedding" in r["stage_ms"] and "full_model" in r["stage_ms"]
    fr = r["stage_fraction"]
    assert abs(sum(fr.values()) - 1.0) < 1e-6


def test_loadgen_study_smoke(tmp_path):
    out = tmp_path / "lg.json"
    loadgen_main(["--num-batches", "24", "--out", str(out)])
    rows = json.loads(out.read_text())
    assert {r["dist"] for r in rows} == {"normal", "lognormal"}
    assert all(np.isfinite(r["p95_ms"]) for r in rows)


def test_scheduling_study_smoke():
    rows = run_study("ncf", seeds=1, tune_accel=False, backend="sim",
                     table_scale=2000, quick=True)
    assert len(rows) == 1
    assert rows[0]["optimal_sub_batch"] in (512, 256, 128, 64, 32)


def test_qps_sweep_sim_smoke():
    # plain sim backend (no characterization file needed): verify the
    # SLA-filtered argmax logic.
    from deeprecsys_tpu.serving.latency_model import LatencyModel
    import deeprecsys_tpu.experiments.qps_sweep as qs

    # monkeypatch-free: drive through the "sim" backend path by injecting a
    # characterization file into the expected location via tmp change is
    # intrusive; instead test the SLA selection inline.
    result_rows = [
        {"arrival_ms": 0.5, "qps": 900.0, "p95_ms": 60.0, "meets_sla": False},
        {"arrival_ms": 1.0, "qps": 700.0, "p95_ms": 20.0, "meets_sla": True},
        {"arrival_ms": 2.0, "qps": 400.0, "p95_ms": 10.0, "meets_sla": True},
    ]
    best = max((r for r in result_rows if r["meets_sla"]), key=lambda r: r["qps"])
    assert best["qps"] == 700.0


def test_plots_render(tmp_path):
    """The figure generators (reference op_breakdown/speedup png analog)
    render from benchmark JSONs in the formats experiments/op_breakdown.py,
    bench.py and experiments/qps_sweep.py write, and produce non-empty
    PNGs."""
    import matplotlib
    matplotlib.use("Agg")
    from deeprecsys_tpu.experiments import plots

    models = ("rm1", "ncf")
    (tmp_path / "op_breakdown.json").write_text(json.dumps([
        {"model": m, "batch": 512,
         "stage_fraction": {"embedding": 0.6, "top_mlp": 0.3,
                            "bottom_mlp": 0.1}} for m in models]))
    (tmp_path / "last_bench.json").write_text(json.dumps({
        "accel": {m: {"samples_per_s": 1e6} for m in models},
        "cpu_baseline": {"results": {m: {"samples_per_s": 1e5}
                                     for m in models}}}))
    sweep = [{"arrival_ms": a, "qps": 1000 / a, "p95_ms": 10 * a,
              "meets_sla": 10 * a <= 25} for a in (1.0, 2.0, 4.0)]
    (tmp_path / "qps_sweep.json").write_text(json.dumps({
        f"{m}:{b}": {"sla_ms": 25.0, "sweep": sweep}
        for m in models for b in ("calibrated-sim", "cpu-calibrated-sim")}))
    plots.plot_op_breakdown(tmp_path, tmp_path / "ob.png")
    plots.plot_model_speedup(tmp_path, tmp_path / "sp.png")
    plots.plot_qps_sla(tmp_path, tmp_path / "qps.png")
    for f in ("ob.png", "sp.png", "qps.png"):
        assert (tmp_path / f).stat().st_size > 10_000


def test_skew_bench_auto_matches_engine_rule():
    """experiments/skew_bench replays the serving engines' auto decision:
    coverage >= hotcold_min_hit -> hotcold (including din-class PACKED
    configs), below threshold -> xla."""
    import jax

    from deeprecsys_tpu import zoo
    from deeprecsys_tpu.experiments.skew_bench import (
        measure_skewed, resolve_auto_impl, zipf_stream)

    cpu = jax.devices("cpu")[0]
    # hotcold_min_table_mb=0: test-scale tables sit under the production
    # size floor (its own stanza below).
    r = measure_skewed("rm1", cpu, impl="auto", batch=16,
                       table_scale=50000, iters=8,
                       cfg_overrides={"hotcold_min_table_mb": 0})
    assert r["impl"] == "hotcold" and r["hot_coverage"] == 1.0
    assert r["latency_ms"] > 0 and r["samples_per_s"] > 0
    x = measure_skewed("rm1", cpu, impl="xla", batch=16,
                       table_scale=50000, iters=8)
    assert x["impl"] == "xla" and x["hot_coverage"] is None
    # The size floor: without the override the scaled-down table is far
    # below hotcold_min_table_mb, so auto declines WITHOUT sampling.
    f = measure_skewed("rm1", cpu, impl="auto", batch=16,
                       table_scale=50000, iters=8)
    assert f["impl"] == "xla" and f["hot_coverage"] is None
    # din-class PACKED config: auto now samples and composes hotcold
    # with the packed tables (the retired guard used to force xla here).
    cfg = zoo.get_config("din", table_scale=50000,
                         param_dtype="bfloat16", table_pack=2,
                         hotcold_min_table_mb=0)
    impl, hot, cov = resolve_auto_impl(cfg, zipf_stream(cfg, 8))
    assert impl == "hotcold" and hot is not None
    assert cov is not None and cov >= cfg.hotcold_min_hit


def test_drifted_stream_moves_the_head():
    """drifted_zipf_stream: same skew, permuted head — the original
    stream's hot set covers little of the drifted stream, while a set
    re-selected on it (what adaptive refresh converges to) recovers the
    original coverage. The stale/refreshed gap is what job_drift measures
    on the chip."""
    import numpy as np

    from deeprecsys_tpu import zoo
    from deeprecsys_tpu.experiments.skew_bench import (
        drifted_zipf_stream, stream_coverage, zipf_stream)
    from deeprecsys_tpu.ops.embedding import select_hot_ids

    cfg = zoo.get_config("rm1", table_scale=100)
    old = zipf_stream(cfg, 256)
    new = drifted_zipf_stream(cfg, 256)
    offs = np.asarray(cfg.table_offsets, dtype=np.int64)
    k = 2048
    stale = select_hot_ids(old, offs, k)
    fresh = select_hot_ids(new, offs, k)
    cov_before = stream_coverage(cfg, old, stale)
    cov_stale = stream_coverage(cfg, new, stale)
    cov_fresh = stream_coverage(cfg, new, fresh)
    assert cov_before > 0.5          # zipf(1.2) head mass, as measured
    assert cov_stale < cov_before / 2  # the head moved off the stale set
    assert cov_fresh > 0.9 * cov_before  # re-selection restores it
    # Drift is a permutation: ids stay in range, per-table.
    rows = np.asarray(cfg.scaled_rows)[None, :, None]
    assert (new >= 0).all() and (new < rows).all()
