import queue

import numpy as np
import pytest

from deeprecsys_tpu import zoo
from deeprecsys_tpu.config import ServingConfig
from deeprecsys_tpu.serving.engine import pick_bucket
from deeprecsys_tpu.serving.latency_model import LatencyModel
from deeprecsys_tpu.serving.load_generator import model_batch_sizes, partition_query
from deeprecsys_tpu.serving.metrics import ResponseAggregator
from deeprecsys_tpu.serving.packets import ServiceResponse
from deeprecsys_tpu.serving.orchestrator import run_serving

SCALE = 5000


def test_partition_query():
    assert partition_query(100, 32) == [32, 32, 32, 4]
    assert partition_query(16, 32) == [16]
    assert partition_query(64, 64) == [64]


def test_pick_bucket():
    buckets = (1, 2, 4, 8, 16)
    assert pick_bucket(buckets, 1) == 1
    assert pick_bucket(buckets, 3) == 4
    assert pick_bucket(buckets, 16) == 16
    assert pick_bucket(buckets, 100) == 16  # capped


def test_batch_size_distributions():
    rng = np.random.default_rng(0)
    cfg = ServingConfig(num_batches=500, batch_size_distribution="normal",
                        avg_mini_batch_size=165, var_mini_batch_size=16,
                        max_mini_batch_size=1024)
    sizes = model_batch_sizes(cfg, rng)
    assert sizes.shape == (500,)
    assert sizes.min() >= 1 and sizes.max() <= 1024
    assert 150 < sizes.mean() < 180
    cfg2 = ServingConfig(num_batches=100, batch_size_distribution="fixed",
                         avg_mini_batch_size=7)
    assert (model_batch_sizes(cfg2, rng) == 7).all()
    cfg3 = ServingConfig(num_batches=2000, batch_size_distribution="lognormal",
                         avg_mini_batch_size=5.1, var_mini_batch_size=0.2,
                         max_mini_batch_size=1024)
    s3 = model_batch_sizes(cfg3, rng)
    assert 120 < np.median(s3) < 220  # exp(5.1) ~ 164


def test_batch_size_distribution_file(tmp_path):
    # Reference parity: "file" mode samples uniformly from a percentile
    # file (loadGenerator.py:30-39).
    p = tmp_path / "dist.txt"
    p.write_text("\n".join(str(v) for v in [10, 20, 30, 40, 2000]))
    rng = np.random.default_rng(1)
    cfg = ServingConfig(num_batches=300, batch_size_distribution="file",
                        batch_dist_file=str(p), max_mini_batch_size=100)
    sizes = model_batch_sizes(cfg, rng)
    assert set(np.unique(sizes)) <= {10, 20, 30, 40, 100}  # 2000 clamped
    assert (sizes == 100).any()


def test_latency_model_interpolation():
    m = LatencyModel([1, 4, 16, 64], [1.0, 2.0, 4.0, 8.0])
    assert m.predict_ms(4) == pytest.approx(2.0)
    assert m.predict_ms(1) == pytest.approx(1.0)
    # log4 midpoint of [4, 16] is 8 -> halfway between 2 and 4 ms.
    assert m.predict_ms(8) == pytest.approx(3.0)
    # extrapolation continues last log-slope: 64->256 doubles again
    assert m.predict_ms(256) == pytest.approx(12.0)
    d = m.to_json()
    m2 = LatencyModel.from_json(d)
    assert m2.predict_ms(8) == pytest.approx(3.0)


def test_latency_model_payload_overhead():
    m = LatencyModel([1, 4, 16, 64], [1.0, 2.0, 4.0, 8.0])
    o = m.with_overhead(a_ms=5.0, ms_per_sample=0.25)
    # Affine term applies AFTER interpolation, so it stays exact between
    # ladder points (log-space chords would bend it).
    assert o.predict_ms(4) == pytest.approx(2.0 + 5.0 + 1.0)
    assert o.predict_ms(8) == pytest.approx(3.0 + 5.0 + 2.0)
    assert m.predict_ms(8) == pytest.approx(3.0)  # base model untouched


def test_latency_model_overhead_roundtrips_json():
    """Persisting a calibrated with_overhead() model must keep the
    transport term — a silent drop returns uncalibrated predictions."""
    m = LatencyModel([1, 4, 16, 64], [1.0, 2.0, 4.0, 8.0])
    o = m.with_overhead(a_ms=5.0, ms_per_sample=0.25)
    o2 = LatencyModel.from_json(o.to_json())
    assert o2.predict_ms(8) == pytest.approx(o.predict_ms(8))
    # Plain models still round-trip without an overhead key.
    assert "overhead" not in m.to_json()


def test_latency_model_overlap():
    """with_overlap: per-dispatch cost is
    max(compute, transfer) + floor — the pipeline overlaps transfer of
    request k+1 with compute of request k, so the additive model
    double-counts the smaller side."""
    m = LatencyModel([1, 4, 16, 64], [1.0, 2.0, 4.0, 8.0])
    o = m.with_overlap(a_ms=5.0, ms_per_sample=0.25)
    # Small batch: compute (2.0) dominates transfer (1.0).
    assert o.predict_ms(4) == pytest.approx(2.0 + 5.0)
    # Large batch: transfer (16.0) dominates compute (8.0).
    assert o.predict_ms(64) == pytest.approx(16.0 + 5.0)
    assert m.predict_ms(64) == pytest.approx(8.0)  # base untouched
    # JSON round-trip keeps the overlap semantics (not the additive ones).
    o2 = LatencyModel.from_json(o.to_json())
    assert o2.predict_ms(64) == pytest.approx(21.0)
    assert o2.predict_ms(4) == pytest.approx(7.0)


def test_latency_model_from_reference_raw(tmp_path):
    """Reference raw_data ingestion: the `***` 6-tuple
    results_<model>.txt format (predict_execution.py:10-29) loads into a
    LatencyModel; ladder = base**i, point = exec ms/iter (column 5)."""
    lines = []
    for i, exec_iter in enumerate([1.5, 3.0, 6.0]):  # batches 1, 4, 16
        n = 10 * (i + 1)
        lines += [
            f"Total data loading time: *** {0.2 * n} ms",
            f"Total data loading time: *** {0.2} ms/iter",
            f"Total computation time: *** {(exec_iter - 0.2) * n} ms",
            f"Total computation time: *** {exec_iter - 0.2} ms/iter",
            f"Total execution time: *** {exec_iter * n} ms",
            f"Total execution time: *** {exec_iter} ms/iter",
            "some unrelated log line",
        ]
    p = tmp_path / "results_rm1.txt"
    p.write_text("\n".join(lines))
    m = LatencyModel.from_reference_raw(p)
    assert m.batches.tolist() == [1.0, 4.0, 16.0]
    assert m.predict_ms(4) == pytest.approx(3.0)
    assert m.predict_ms(8) == pytest.approx(4.5)  # log4 midpoint
    # The CLI converter writes a loadable characterization JSON.
    from deeprecsys_tpu.serving.latency_model import main as lm_main

    out = tmp_path / "gpu_rm1.json"
    lm_main(["--from-raw", str(p), "--out", str(out)])
    assert LatencyModel.load(out).predict_ms(4) == pytest.approx(3.0)
    # A truncated file (not a multiple of 6 *** lines) must fail loudly.
    bad = tmp_path / "bad.txt"
    bad.write_text("Total execution time: *** 1.0 ms\n")
    with pytest.raises(ValueError):
        LatencyModel.from_reference_raw(bad)


def test_payload_floor_fit_cpu():
    import jax

    from deeprecsys_tpu.utils.timing import payload_floor_fit

    fit = payload_floor_fit(jax.devices("cpu")[0],
                            sizes_mb=(0.0, 0.5), trials=2)
    assert fit["a_ms"] >= 0.0 or abs(fit["a_ms"]) < 5.0  # lstsq noise on fast hosts
    assert fit["b_ms_per_mb"] >= 0.0
    assert len(fit["points_ms"]) == 2
    assert all(p >= 0.0 for p in fit["points_ms"])


def test_response_aggregator_joins_sub_batches():
    agg = ResponseAggregator(req_granularity=2)
    def resp(batch_id, sub_id, total, arr, inf, exp=False):
        return ServiceResponse(epoch=0, batch_id=batch_id, sub_id=sub_id,
                               total_sub_batches=total, arrival_time=arr,
                               inference_end_time=inf, exp_packet=exp)
    assert agg.add(resp(0, 0, 2, arr=10.0, inf=10.5)) is None
    p = agg.add(resp(0, 1, 2, arr=10.01, inf=10.7))
    assert p is None  # first completed query, window boundary at 2
    assert agg.latencies == [pytest.approx(0.7)]  # max(inf) - min(arr)
    p = agg.add(resp(1, 0, 1, arr=11.0, inf=11.2))
    assert p is not None  # second completion crosses granularity 2
    assert agg.final_latencies == [pytest.approx(0.7), pytest.approx(0.2)]


def test_aggregator_excludes_exp_packets_from_final():
    agg = ResponseAggregator(req_granularity=64)
    agg.add(ServiceResponse(epoch=0, batch_id=0, sub_id=0, total_sub_batches=1,
                            arrival_time=0.0, inference_end_time=1.0, exp_packet=True))
    assert agg.latencies and not agg.final_latencies


def test_end_to_end_sim_serving():
    """Full stack with the sleep-based fake engine (the reference's own
    accel-simulator pattern) — no hardware needed."""
    model_cfg = zoo.get_config("ncf", table_scale=SCALE)
    cfg = ServingConfig(
        num_batches=40, nepochs=2, inference_engines=2, engine_backend="sim",
        avg_arrival_rate_ms=1.0, batch_size_distribution="fixed",
        avg_mini_batch_size=64, max_mini_batch_size=256,
        sub_task_batch_size=32, req_granularity=8, seed=1,
    )
    lm = LatencyModel([1, 64, 256], [0.2, 0.5, 1.0])
    res = run_serving(model_cfg, cfg, latency_model=lm, settle_s=0.01)
    # 40 batches x 2 epochs, each split into 2 sub-batches of 32.
    assert res.cpu_requests == 80
    assert res.cpu_sub_requests == 160
    assert res.num_responses == 160
    assert res.measured_qps > 0
    assert res.p95_ms >= 0.5  # at least one sub-batch sleep


def test_end_to_end_sim_with_accel_offload():
    model_cfg = zoo.get_config("ncf", table_scale=SCALE)
    cfg = ServingConfig(
        num_batches=30, nepochs=1, inference_engines=1, engine_backend="sim",
        avg_arrival_rate_ms=1.0, batch_size_distribution="normal",
        avg_mini_batch_size=100, var_mini_batch_size=60, max_mini_batch_size=512,
        sub_task_batch_size=64, req_granularity=8, seed=3,
        model_accel=True, accel_request_size_thres=128,
    )
    lm = LatencyModel([1, 512], [0.2, 0.5])
    accel_lm = LatencyModel([1, 512], [0.05, 0.1])
    res = run_serving(model_cfg, cfg, latency_model=lm, accel_latency_model=accel_lm,
                      settle_s=0.01)
    assert res.accel_requests > 0
    assert res.cpu_requests > 0
    assert res.cpu_requests + res.accel_requests == 30


def test_end_to_end_compute_cpu_engine():
    """Real jitted model through the serving stack on the CPU backend."""
    model_cfg = zoo.get_config("ncf", table_scale=SCALE)
    cfg = ServingConfig(
        num_batches=16, nepochs=1, inference_engines=1, engine_backend="cpu",
        avg_arrival_rate_ms=0.5, batch_size_distribution="fixed",
        avg_mini_batch_size=24, max_mini_batch_size=64,
        batch_buckets=(8, 16, 32, 64), sub_task_batch_size=16,
        req_granularity=4, seed=5,
    )
    res = run_serving(model_cfg, cfg, settle_s=0.01)
    assert res.cpu_requests == 16
    assert res.cpu_sub_requests == 32  # 24 -> [16, 8]
    assert res.num_responses == 32
    assert res.measured_qps > 0
    assert np.isfinite(res.p95_ms)


def test_watchdog_aborts_on_dead_engine(monkeypatch):
    """Reference behavior: a crashed engine hangs the run forever
    (SURVEY §5). Ours raises after the watchdog period."""
    from deeprecsys_tpu.serving.engine import SimEngine

    def broken_run(self):
        self.ready_q.put(self.engine_id)
        while True:
            request = self.request_q.get()
            if request is None:
                return  # exits WITHOUT posting the done sentinel
            # drop the request on the floor (simulated crash mid-stream)
            return

    monkeypatch.setattr(SimEngine, "run", broken_run)
    model_cfg = zoo.get_config("ncf", table_scale=SCALE)
    cfg = ServingConfig(
        num_batches=4, nepochs=1, inference_engines=1, engine_backend="sim",
        avg_arrival_rate_ms=0.5, batch_size_distribution="fixed",
        avg_mini_batch_size=8, max_mini_batch_size=16, sub_task_batch_size=8,
        req_granularity=2, seed=2,
    )
    lm = LatencyModel([1, 16], [0.1, 0.2])
    with pytest.raises(RuntimeError, match="serving stalled"):
        run_serving(model_cfg, cfg, latency_model=lm, settle_s=0.01, watchdog_s=0.3)


def test_coalescing_engine_answers_every_request():
    """Dynamic batching: backlog drained into one bucket run;
    every sub-request still gets its own response."""
    model_cfg = zoo.get_config("ncf", table_scale=SCALE)
    cfg = ServingConfig(
        num_batches=20, nepochs=1, inference_engines=1, engine_backend="cpu",
        avg_arrival_rate_ms=0.1,  # flood the queue so coalescing triggers
        batch_size_distribution="fixed", avg_mini_batch_size=24,
        max_mini_batch_size=64, batch_buckets=(8, 16, 32, 64),
        sub_task_batch_size=8, req_granularity=4, seed=9,
        coalesce_requests=True, max_coalesce=4,
    )
    res = run_serving(model_cfg, cfg, settle_s=0.01)
    assert res.cpu_requests == 20
    assert res.cpu_sub_requests == 60  # 24 -> [8, 8, 8]
    assert res.num_responses == 60
    assert np.isfinite(res.p95_ms)


def test_scheduler_tunes_in_sim_loop():
    """tune_batch_qps end-to-end: the hill climber must converge and pick a
    sub-batch config, after which non-exp traffic flows."""
    model_cfg = zoo.get_config("ncf", table_scale=SCALE)
    cfg = ServingConfig(
        num_batches=64, nepochs=1, inference_engines=2, engine_backend="sim",
        avg_arrival_rate_ms=1.0, batch_size_distribution="fixed",
        avg_mini_batch_size=128, max_mini_batch_size=256,
        sub_task_batch_size=64, req_granularity=8, seed=7,
        tune_batch_qps=True, batch_configs=(32, 64, 128),
        arr_steps=5, sched_timeout=4, target_latency_ms=5.0,
        min_arr_range=0.5, max_arr_range=8.0,
    )
    lm = LatencyModel([1, 32, 256], [0.1, 0.3, 1.2])
    res = run_serving(model_cfg, cfg, latency_model=lm, settle_s=0.01)
    assert res.optimal_sub_batch in (32, 64, 128)
    # Post-tuning (non-exp) traffic may be just a handful of queries
    # depending on when the climb converges; require completion, not rate.
    assert res.num_responses > 0


# ---------------------------------------------------------------------------
# Autotuned bucket ladders (serving/buckets.py)
# ---------------------------------------------------------------------------


def test_optimal_ladder_beats_pow2_on_normal_dist():
    from deeprecsys_tpu.serving.buckets import expected_padded_work, optimal_bucket_ladder

    rng = np.random.default_rng(0)
    sizes = np.clip(rng.normal(165, 16, 4096), 1, 1024).astype(np.int64)
    ladder = optimal_bucket_ladder(sizes, max_buckets=6)
    pow2 = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
    assert len(ladder) <= 6
    assert max(ladder) == sizes.max()  # cap covers everything
    w_auto = expected_padded_work(sizes, ladder)
    w_pow2 = expected_padded_work(sizes, pow2)
    # normal(165,16) lands just above 128 -> pow2 pads most queries to 256.
    assert w_auto < 0.8 * w_pow2


def test_optimal_ladder_exact_small_case():
    from deeprecsys_tpu.serving.buckets import optimal_bucket_ladder

    # 90x size-10 + 10x size-100 with 2 buckets: {10, 100} is optimal
    # (cost 90*10+10*100=1900 vs single bucket 100*100=10000).
    sizes = np.array([10] * 90 + [100] * 10)
    assert optimal_bucket_ladder(sizes, max_buckets=2) == (10, 100)
    # K >= distinct sizes: every distinct size is a bucket (zero padding).
    assert optimal_bucket_ladder(sizes, max_buckets=5) == (10, 100)


def test_autotune_buckets_sees_engine_stream():
    from deeprecsys_tpu.serving.buckets import autotune_buckets

    # sub_task partitioning dominates: queries of 165 split into 64+64+37,
    # so the ladder must include 64 and cover 37ish remainders - never 165.
    cfg = ServingConfig(
        batch_size_distribution="normal", avg_mini_batch_size=165,
        var_mini_batch_size=16, max_mini_batch_size=1024,
        sub_task_batch_size=64, bucket_policy="auto",
    )
    ladder = autotune_buckets(cfg)
    assert max(ladder) == 64  # chunks never exceed sub_task_batch_size
    assert ladder == autotune_buckets(cfg)  # deterministic in cfg.seed

    # With accel offload, big queries bypass partitioning.
    cfg2 = ServingConfig(
        batch_size_distribution="normal", avg_mini_batch_size=165,
        var_mini_batch_size=16, max_mini_batch_size=1024,
        sub_task_batch_size=64, bucket_policy="auto",
        model_accel=True, accel_request_size_thres=128,
    )
    ladder2 = autotune_buckets(cfg2)
    assert max(ladder2) > 64  # whole queries appear in the stream


def test_engine_uses_auto_ladder_end_to_end():
    import time

    import jax

    from deeprecsys_tpu.serving.packets import ServiceRequest
    from deeprecsys_tpu.serving.buckets import autotune_buckets
    from deeprecsys_tpu.serving.engine import ComputeEngine

    model_cfg = zoo.get_config("ncf", table_scale=2000)
    cfg = ServingConfig(
        batch_size_distribution="normal", avg_mini_batch_size=40,
        var_mini_batch_size=4, max_mini_batch_size=64,
        sub_task_batch_size=64, bucket_policy="auto", max_auto_buckets=3,
        engine_backend="cpu",
    )
    req_q, resp_q, ready_q = queue.Queue(), queue.Queue(), queue.Queue()
    eng = ComputeEngine(0, model_cfg, cfg, req_q, resp_q, ready_q,
                        device=jax.devices("cpu")[0])
    assert eng.buckets == tuple(autotune_buckets(cfg))
    assert len(eng.buckets) <= 3
    eng.start()
    assert not isinstance(ready_q.get(timeout=120), Exception)
    req_q.put(ServiceRequest(batch_id=0, epoch=0, arrival_time=time.time(),
                             batch_size=37, total_sub_batches=1))
    resp = resp_q.get(timeout=60)
    assert resp.batch_size == 37
    # served at the smallest auto bucket >= 37
    assert resp.out_batch_size == min(b for b in eng.buckets if b >= 37)
    req_q.put(None)


# ---------------------------------------------------------------------------
# Hot/cold-split serving (models/hotcold.py + engine embedding_impl="hotcold")
# ---------------------------------------------------------------------------


def test_hotcold_model_matches_base():
    import jax

    from deeprecsys_tpu.data import RecDataGenerator
    from deeprecsys_tpu.models import get_model
    from deeprecsys_tpu.models.hotcold import hot_ids_from_generator, make_hotcold_model

    cfg = zoo.get_config("rm1", table_scale=2000)
    model = get_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    hot_ids = hot_ids_from_generator(cfg, seed=5, hot_rows=64, n_batches=2,
                                     batch_size=32)
    hc = make_hotcold_model(model, hot_ids)
    hc_params = hc.convert_params(params)

    batch = RecDataGenerator(cfg, seed=9).generate_batch(16)
    split = hc.prepare(batch)
    got = np.asarray(hc.apply(hc_params, batch,
                              {k: v for k, v in split.items() if k != "n_cold"}))
    want = np.asarray(model.apply(params, batch))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_hotcold_model_packed_matches_base():
    """table_pack composes with embedding_impl='hotcold' (single device):
    the hot table materializes unpacked from the packed layout and the
    cold stream gathers physical rows; scores match the plain packed
    model for both the float and per-table-int8 packed layouts."""
    import jax

    from deeprecsys_tpu.data import RecDataGenerator
    from deeprecsys_tpu.models import get_model
    from deeprecsys_tpu.models.hotcold import hot_ids_from_generator, make_hotcold_model

    for quant, layout in (("none", "packed"), ("int8", "q_packed")):
        cfg = zoo.get_config("rm1", table_scale=2000,
                             table_quant=quant, table_pack=2)
        model = get_model(cfg)
        params = model.init(jax.random.PRNGKey(0))
        assert layout in params["tables"]
        hot_ids = hot_ids_from_generator(cfg, seed=5, hot_rows=64, n_batches=2,
                                         batch_size=32)
        hc = make_hotcold_model(model, hot_ids)
        hc_params = hc.convert_params(params)
        assert layout in hc_params["tables"]  # cold table stays packed
        assert hc_params["hot_table"].shape[1] == cfg.sparse_feature_size

        batch = RecDataGenerator(cfg, seed=9).generate_batch(16)
        split = hc.prepare(batch)
        got = np.asarray(hc.apply(hc_params, batch,
                                  {k: v for k, v in split.items() if k != "n_cold"}))
        want = np.asarray(model.apply(params, batch))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_engine_reload_rederives_hotcold_state(tmp_path):
    """request_reload on a hotcold engine: the new checkpoint's MODEL
    params are re-converted (hot table re-gathered from the new tables)
    before the next served request."""
    import time

    import jax
    import numpy as np

    from deeprecsys_tpu.models import get_model
    from deeprecsys_tpu.serving.engine import ComputeEngine
    from deeprecsys_tpu.serving.packets import ServiceRequest
    from deeprecsys_tpu.utils.checkpoint import save_params

    model_cfg = zoo.get_config("ncf", table_scale=2000).replace(
        embedding_impl="hotcold", hot_set_rows=32)
    cfg = ServingConfig(engine_backend="cpu", batch_buckets=(8,),
                        max_mini_batch_size=8)
    req_q, resp_q, ready_q = queue.Queue(), queue.Queue(), queue.Queue()
    eng = ComputeEngine(0, model_cfg, cfg, req_q, resp_q, ready_q,
                        device=jax.devices("cpu")[0])
    eng.start()
    got = ready_q.get(timeout=300)
    assert not isinstance(got, Exception), got

    new = get_model(model_cfg).init(jax.random.PRNGKey(321))
    save_params(tmp_path / "ckpt", new)
    handle = eng.request_reload(str(tmp_path / "ckpt"))
    req_q.put(ServiceRequest(batch_id=0, epoch=0, arrival_time=time.time(),
                             batch_size=5, total_sub_batches=1))
    r = resp_q.get(timeout=120)
    assert r.batch_size == 5
    assert handle.event.wait(timeout=30) and handle.error is None
    hid = np.asarray(eng._hotcold.hot_ids, dtype=np.int64)
    want_hot = np.asarray(new["tables"])[hid]
    np.testing.assert_allclose(np.asarray(eng.params["hot_table"]), want_hot,
                               rtol=1e-6)
    req_q.put(None)


def test_cold_ladder_shapes():
    from deeprecsys_tpu.models.hotcold import cold_ladder

    lad = cold_ladder(1024)
    assert lad == (128, 256, 512, 1024)
    assert cold_ladder(5)[-1] >= 5  # cap always covers everything
    assert all(b >= 8 for b in cold_ladder(3))


def test_cold_buckets_scale_with_mesh():
    """On a mesh the splitters pad PER PARTITION CELL, so the ladder must
    scale by the partition count — a full-batch ladder would pad every
    chip to >= n/8 and lose the divide-by-M descriptor win."""
    from deeprecsys_tpu.models.hotcold import cold_buckets_for
    from deeprecsys_tpu.parallel import make_mesh

    n = 8192
    assert cold_buckets_for(n) == (1024, 2048, 4096, 8192)
    mesh = make_mesh(data=2, model=4)  # 8 cells, cap = n/2 per data shard
    lad = cold_buckets_for(n, mesh)
    assert lad[:4] == (128, 256, 512, 1024)  # scaled to n/8 per cell
    assert lad[-1] == 4096                   # skew guard: one cell can hold n/D
    tp = make_mesh(data=1, model=8)
    lad_tp = cold_buckets_for(n, tp)
    assert lad_tp[:4] == (128, 256, 512, 1024)
    assert lad_tp[-1] == n                   # TP: a single shard can own all cold


def test_select_hot_ids_zero_k_empty():
    from deeprecsys_tpu.ops.embedding import select_hot_ids

    idx = np.zeros((4, 2, 3), np.int32)
    hot = select_hot_ids(idx, np.array([0, 10]), 0)
    assert hot.size == 0  # not "everything hot" via the [-0:] slice


def test_hotcold_guard_applies_to_quantized_tables():
    """embedding_impl='hotcold' must be rejected by the plain apply for
    quantized configs too — silently running the ordinary int8 gather
    would benchmark the wrong implementation."""
    import pytest

    from deeprecsys_tpu.data import RecDataGenerator
    from deeprecsys_tpu.models import get_model

    for quant in ("int8", "int8_rowwise"):
        cfg = zoo.get_config("ncf", table_scale=2000,
                             embedding_impl="hotcold", table_quant=quant)
        model = get_model(cfg)
        import jax

        params = model.init(jax.random.PRNGKey(0))
        batch = RecDataGenerator(cfg, seed=1).generate_batch(4)
        with pytest.raises(ValueError, match="hotcold"):
            model.apply(params, batch)


def test_engine_hotcold_end_to_end():
    import time

    import jax

    from deeprecsys_tpu.serving.engine import ComputeEngine
    from deeprecsys_tpu.serving.packets import ServiceRequest

    model_cfg = zoo.get_config("ncf", table_scale=2000).replace(
        embedding_impl="hotcold", hot_set_rows=32)
    cfg = ServingConfig(engine_backend="cpu", batch_buckets=(8, 16),
                        max_mini_batch_size=16)
    req_q, resp_q, ready_q = queue.Queue(), queue.Queue(), queue.Queue()
    eng = ComputeEngine(0, model_cfg, cfg, req_q, resp_q, ready_q,
                        device=jax.devices("cpu")[0])
    eng.start()
    got = ready_q.get(timeout=300)
    assert not isinstance(got, Exception), got
    for i, size in enumerate([3, 11, 16]):
        req_q.put(ServiceRequest(batch_id=i, epoch=0, arrival_time=time.time(),
                                 batch_size=size, total_sub_batches=1))
    seen = [resp_q.get(timeout=120) for _ in range(3)]
    assert sorted(r.batch_size for r in seen) == [3, 11, 16]
    assert all(r.inference_end_time >= r.queue_start_time for r in seen)
    req_q.put(None)


def test_engine_auto_embedding_impl_picks_by_coverage():
    """embedding_impl='auto': the engine samples its own stream at warm-up
    and picks hotcold iff the hot set covers >= hotcold_min_hit of
    lookups. Small tables + budget-sized hot set -> coverage ~1 ->
    hotcold; a forced tiny hot set over the same uniform stream ->
    coverage ~tiny -> direct path."""
    import time

    import jax

    from deeprecsys_tpu.serving.engine import ComputeEngine
    from deeprecsys_tpu.serving.packets import ServiceRequest

    def run_engine(model_cfg):
        cfg = ServingConfig(engine_backend="cpu", batch_buckets=(8,),
                            max_mini_batch_size=8)
        req_q, resp_q, ready_q = queue.Queue(), queue.Queue(), queue.Queue()
        eng = ComputeEngine(0, model_cfg, cfg, req_q, resp_q, ready_q,
                            device=jax.devices("cpu")[0])
        eng.start()
        got = ready_q.get(timeout=300)
        assert not isinstance(got, Exception), got
        req_q.put(ServiceRequest(batch_id=0, epoch=0, arrival_time=time.time(),
                                 batch_size=5, total_sub_batches=1))
        r = resp_q.get(timeout=120)
        assert r.batch_size == 5
        req_q.put(None)
        return eng

    # 16k-row total, budgeted hot set covers everything -> hotcold.
    # (hotcold_min_table_mb=0: test-scale tables sit under the production
    # size floor that keeps auto off small-table models like ncf.)
    hot_cfg = zoo.get_config("rm1", table_scale=2000).replace(
        embedding_impl="auto", hotcold_min_table_mb=0)
    eng = run_engine(hot_cfg)
    assert eng._hotcold is not None and eng.hot_coverage > 0.9

    # Same config WITHOUT the floor override: the 1 MB test-scale table
    # is below the 128 MB production floor -> auto declines unsampled.
    floor_cfg = zoo.get_config("rm1", table_scale=2000).replace(
        embedding_impl="auto")
    eng = run_engine(floor_cfg)
    assert eng._hotcold is None and eng.hot_coverage is None

    # Same stream, hot set capped at 64 of 16k uniform rows -> direct.
    cold_cfg = zoo.get_config("rm1", table_scale=2000).replace(
        embedding_impl="auto", hot_set_rows=64, hotcold_min_table_mb=0)
    eng = run_engine(cold_cfg)
    assert eng._hotcold is None and eng.hot_coverage < 0.5

    # require=True keeps forcing the split regardless of coverage.
    forced = zoo.get_config("rm1", table_scale=2000).replace(
        embedding_impl="hotcold", hot_set_rows=64)
    eng = run_engine(forced)
    assert eng._hotcold is not None


def test_hotcold_upgrade_without_degradation():
    """The symmetric refresh rule: a hot set that was never good (warm-up
    sampled the uniform generator; live traffic is concentrated) never
    trips the drop rule — live coverage never FELL — but the engine must
    still adopt the live stream's head when a re-derived set would cover
    meaningfully more."""
    import numpy as np

    from deeprecsys_tpu.serving.ingress import ServingServer

    model_cfg = zoo.get_config("ncf", table_scale=500).replace(
        embedding_impl="hotcold", hot_set_rows=64)
    cfg = ServingConfig(engine_backend="cpu", inference_engines=1,
                        batch_buckets=(8,), max_mini_batch_size=8,
                        sub_task_batch_size=8,
                        hotcold_refresh_interval=4,
                        hotcold_refresh_window=8)
    server = ServingServer(model_cfg, cfg)
    server.start()
    try:
        eng = server.engines[0]
        assert eng._hotcold is not None
        assert eng.hot_coverage < 0.75  # warm-up (uniform) set: mediocre
        rows = model_cfg.scaled_rows
        T, L = model_cfg.num_tables, model_cfg.num_indices_per_lookup
        pools = [[3, 7, 11, 19], [5, 9, 13, 21], [2, 4, 6, 8],
                 [1, 10, 12, 14]]

        def head_batch(seed):
            rng = np.random.default_rng(seed)
            return np.stack([rng.choice(pools[t], size=(8, L))
                             for t in range(T)], axis=1).astype(np.int32)

        for i in range(8):
            server.predict(head_batch(i))
        assert eng.hot_refreshes >= 1, "upgrade never installed"
        assert eng.hot_coverage > 0.9
        assert eng._hotcold_active
        # A good set stops the scanning: ref >= min_hit short-circuits
        # before any candidate derivation, so no back-off accrues either.
        for i in range(8, 16):
            server.predict(head_batch(i))
        assert eng.hot_refreshes == 1
        assert eng._upgrade_backoff == 0
    finally:
        server.stop()


def test_hotcold_upgrade_scan_backs_off_on_steady_mediocre_stream():
    """Failed upgrade scans must not pay the candidate derivation every
    interval forever: a steady stream with nothing to upgrade to grows
    an exponential skip count (reset only by an install or disable)."""
    import numpy as np

    from deeprecsys_tpu.serving.ingress import ServingServer

    model_cfg = zoo.get_config("ncf", table_scale=500).replace(
        embedding_impl="hotcold", hot_set_rows=64)
    cfg = ServingConfig(engine_backend="cpu", inference_engines=1,
                        batch_buckets=(8,), max_mini_batch_size=8,
                        sub_task_batch_size=8,
                        hotcold_refresh_interval=2,
                        hotcold_refresh_window=8)
    server = ServingServer(model_cfg, cfg)
    server.start()
    try:
        eng = server.engines[0]
        assert eng.hot_coverage < 0.75  # mediocre warm-up reference
        rows = model_cfg.scaled_rows
        T, L = model_cfg.num_tables, model_cfg.num_indices_per_lookup

        def uniform_batch(seed):
            rng = np.random.default_rng(seed)
            return np.stack([rng.integers(0, rows[t], size=(8, L))
                             for t in range(T)], axis=1).astype(np.int32)

        # Uniform traffic matches the warm-up distribution: live ~= ref
        # (no drop), candidates are no better (no upgrade) — after a few
        # intervals the scan must be backing off, with no state change.
        for i in range(12):
            server.predict(uniform_batch(i))
        assert eng.hot_refreshes == 0
        assert eng._hotcold_active
        assert eng._upgrade_backoff >= 2, "scan never backed off"
    finally:
        server.stop()


@pytest.mark.parametrize("scan_async", [True, False])
def test_hotcold_adaptive_refresh_recovers_from_drift(scan_async):
    """Adaptive hot-set refresh (hotcold_refresh_interval): a hot set
    frozen at warm-up decays when the popular head of the id stream
    MOVES. The engine tracks the live hit rate from the splitter's cold
    counts; when the windowed coverage falls below the reference, it
    re-derives the hot set from the buffered recent stream and swaps it
    in WITHOUT recompiling (the hot table is a same-shape param). Scores
    stay exactly equal to the direct model through the swap. The
    reference has no analog (its data distribution is fixed per run).

    Parametrized over BOTH scan modes (round 5): the async worker
    default and the ``hotcold_scan_sync`` inline fallback must both
    drive the full refresh -> disable -> re-enable cycle."""
    import jax
    import numpy as np

    from deeprecsys_tpu.models import get_model
    from deeprecsys_tpu.models.base import Batch
    from deeprecsys_tpu.serving.ingress import ServingServer, _health

    # ts=500: (280, 280, 56, 56) rows — every table keeps cold rows after
    # the 64-row hot budget (at ts=2000 the 14-row tables are fully hot
    # and a drifted head could not be made cold).
    model_cfg = zoo.get_config("ncf", table_scale=500).replace(
        embedding_impl="hotcold", hot_set_rows=64)
    cfg = ServingConfig(engine_backend="cpu", inference_engines=1,
                        batch_buckets=(8,), max_mini_batch_size=8,
                        sub_task_batch_size=8,
                        hotcold_refresh_interval=4,
                        hotcold_refresh_window=8,
                        hotcold_refresh_margin=0.05,
                        # Tiny scan budget: forces the row-stride subsample
                        # (ncf per-row lookups = 4, so 64 buffered rows
                        # exceed 200/4) — the drift recovery must survive
                        # the capped scan (benchmarks/refresh_scan_cost).
                        hotcold_scan_budget=200,
                        hotcold_scan_async=scan_async)
    server = ServingServer(model_cfg, cfg)
    server.start()
    try:
        eng = server.engines[0]
        assert eng._hotcold is not None
        ref_cov = eng.hot_coverage
        assert ref_cov > 0.05  # uniform warm-up sample, hot = 64 of 672
        # Drifted stream: a small popular head chosen entirely OUTSIDE
        # the warm-up hot set (fused ids that are currently cold).
        offsets = model_cfg.table_offsets
        rows = model_cfg.scaled_rows
        hot = set(int(i) for i in eng._hotcold.hot_ids)
        pools = []
        for off, r in zip(offsets, rows):
            cold_local = [i for i in range(r) if (int(off) + i) not in hot][:6]
            assert len(cold_local) == 6, "test premise: enough cold rows"
            pools.append(cold_local)
        T, L = model_cfg.num_tables, model_cfg.num_indices_per_lookup

        def drift_batch(seed):
            rng = np.random.default_rng(seed)
            return np.stack([rng.choice(pools[t], size=(8, L))
                             for t in range(T)], axis=1).astype(np.int32)

        # interval=4: the 4th request submits the scan to the worker;
        # the swap applies on the next tracked request's poll
        # (hotcold_scan_async default — the scan does not stall the
        # dispatch thread).
        for i in range(8):
            server.predict(drift_batch(i))
            if eng.hot_refreshes:
                break
        assert eng.hot_refreshes == 1
        assert eng.hot_coverage > 0.9  # re-baselined on the buffered stream
        for i in range(8, 12):  # next window: the drifted head is now hot
            server.predict(drift_batch(i))
        assert eng.live_hot_coverage > 0.9
        assert eng.hot_refreshes == 1  # recovered coverage: no re-trigger
        # Correctness through the swap: predict scores == direct apply on
        # the same (post-refresh) params.
        idx = drift_batch(99)
        out = server.predict(idx)
        direct = get_model(model_cfg.replace(embedding_impl="xla"))
        base = {k: v for k, v in eng.params.items() if k != "hot_table"}
        want = np.asarray(direct.apply(
            base, Batch(dense=None, indices=jax.numpy.asarray(idx))),
            dtype=np.float32)
        np.testing.assert_allclose(np.asarray(out["scores"], np.float32),
                                   want, rtol=1e-5, atol=1e-6)
        (impl,) = _health(server)["embedding_impl"]
        assert impl["hot_refreshes"] == 1
        assert impl["live_hot_coverage"] > 0.9
        # The Prometheus exposition carries the same telemetry.
        from deeprecsys_tpu.serving.ingress import _prometheus

        text = _prometheus({"ncf": server})
        assert 'drs_hot_set_refreshes_total{model="ncf",engine="0"} 1' in text
        assert "drs_live_hot_coverage" in text

        # Phase 3 — the stream loses its head entirely (uniform over all
        # rows): no hot set can clear hotcold_min_hit, so the engine must
        # DISABLE the split and serve the plain fused gather (a headless
        # split pays the host pass and the hot gather for nothing).
        def uniform_batch(seed):
            rng = np.random.default_rng(1000 + seed)
            return np.stack(
                [rng.integers(0, rows[t], size=(8, L)) for t in range(T)],
                axis=1).astype(np.int32)

        for i in range(32):
            server.predict(uniform_batch(i))
            if not eng._hotcold_active:
                break
        assert not eng._hotcold_active, "uniform stream must disable the split"
        # Disabled serving stays correct (lazy direct program).
        idx = uniform_batch(99)
        out = server.predict(idx)
        want = np.asarray(direct.apply(
            {k: v for k, v in eng.params.items() if k != "hot_table"},
            Batch(dense=None, indices=jax.numpy.asarray(idx))),
            dtype=np.float32)
        np.testing.assert_allclose(np.asarray(out["scores"], np.float32),
                                   want, rtol=1e-5, atol=1e-6)
        (impl,) = _health(server)["embedding_impl"]
        assert impl["impl"] == "direct (hotcold disabled)"

        # Phase 4 — the head returns: the disabled engine keeps watching
        # the stream (pure host math) and RE-ENABLES the split.
        for i in range(64):
            server.predict(drift_batch(200 + i))
            if eng._hotcold_active:
                break
        assert eng._hotcold_active, "returning head must re-enable the split"
        idx = drift_batch(999)
        out = server.predict(idx)
        want = np.asarray(direct.apply(
            {k: v for k, v in eng.params.items() if k != "hot_table"},
            Batch(dense=None, indices=jax.numpy.asarray(idx))),
            dtype=np.float32)
        np.testing.assert_allclose(np.asarray(out["scores"], np.float32),
                                   want, rtol=1e-5, atol=1e-6)
        (impl,) = _health(server)["embedding_impl"]
        assert impl["impl"] == "hotcold"

        # Phase 5 — checkpoint reload AFTER a refresh: the reload's
        # hot-table rebuild must use the REFRESHED hot ids (the live
        # _hotcold), and scores on the reloaded weights stay exact.
        import tempfile

        from deeprecsys_tpu.utils.checkpoint import save_params

        refreshed_ids = eng._hotcold.hot_ids.copy()
        new_weights = get_model(
            model_cfg.replace(embedding_impl="xla")).init(
                jax.random.PRNGKey(1234))
        with tempfile.TemporaryDirectory() as td:
            ck = td + "/after_refresh"
            save_params(ck, new_weights)
            (h,) = server.reload(ck)
            assert h.event.wait(timeout=60) and h.error is None
        assert np.array_equal(eng._hotcold.hot_ids, refreshed_ids)
        out = server.predict(idx)
        want = np.asarray(direct.apply(
            new_weights,
            Batch(dense=None, indices=jax.numpy.asarray(idx))),
            dtype=np.float32)
        np.testing.assert_allclose(np.asarray(out["scores"], np.float32),
                                   want, rtol=1e-4, atol=1e-5)
    finally:
        server.stop()


@pytest.mark.parametrize("quant", ["int8", "int8_rowwise"])
def test_hotcold_quantized_matches_plain_quantized(quant):
    """Hot/cold composes with quantized tables: output identical to the
    plain quantized lookup (same int8 grid, same dequant factors)."""
    import jax

    from deeprecsys_tpu.data import RecDataGenerator
    from deeprecsys_tpu.models import get_model
    from deeprecsys_tpu.models.hotcold import hot_ids_from_generator, make_hotcold_model

    cfg = zoo.get_config("rm1", table_scale=2000).replace(table_quant=quant)
    model = get_model(cfg)
    params = model.init(jax.random.PRNGKey(1))
    hot_ids = hot_ids_from_generator(cfg, seed=5, hot_rows=48, n_batches=2,
                                     batch_size=32)
    hc = make_hotcold_model(model, hot_ids)
    hc_params = hc.convert_params(params)

    batch = RecDataGenerator(cfg, seed=9).generate_batch(16)
    split = hc.prepare(batch)
    got = np.asarray(hc.apply(hc_params, batch,
                              {k: v for k, v in split.items() if k != "n_cold"}))
    want = np.asarray(model.apply(params, batch))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_engine_hotcold_int8_end_to_end():
    import time

    import jax

    from deeprecsys_tpu.serving.engine import ComputeEngine
    from deeprecsys_tpu.serving.packets import ServiceRequest

    # hot_set_rows=0 exercises the auto (budget-sized) sizing path.
    model_cfg = zoo.get_config("ncf", table_scale=2000).replace(
        embedding_impl="hotcold", hot_set_rows=0, table_quant="int8")
    cfg = ServingConfig(engine_backend="cpu", batch_buckets=(8,),
                        max_mini_batch_size=8)
    req_q, resp_q, ready_q = queue.Queue(), queue.Queue(), queue.Queue()
    eng = ComputeEngine(0, model_cfg, cfg, req_q, resp_q, ready_q,
                        device=jax.devices("cpu")[0])
    eng.start()
    got = ready_q.get(timeout=300)
    assert not isinstance(got, Exception), got
    req_q.put(ServiceRequest(batch_id=0, epoch=0, arrival_time=time.time(),
                             batch_size=5, total_sub_batches=1))
    resp = resp_q.get(timeout=120)
    assert resp.batch_size == 5
    req_q.put(None)


def test_synthetic_data_plumbed_and_hotcold_hits(tmp_path):
    """The reference's --data_generation synthetic path through the serving
    stack: engines replay a stack-distance trace, and the hot/cold split's
    hot set (selected from the same distribution) achieves a high hit rate
    — the locality model is what makes hot/cold representative."""
    import jax

    from deeprecsys_tpu.data import RecDataGenerator
    from deeprecsys_tpu.data.trace import synthesize_zipf_distribution, write_dist_file
    from deeprecsys_tpu.models.hotcold import hot_ids_from_generator
    from deeprecsys_tpu.ops.embedding import split_hot_cold
    from deeprecsys_tpu.serving import run_serving

    cfg = zoo.get_config("rm1", table_scale=2000)
    dist = tmp_path / "dist.txt"
    la, sd, cdf = synthesize_zipf_distribution(min(cfg.scaled_rows), alpha=1.3,
                                               num_samples=50_000)
    write_dist_file(dist, la, sd, cdf)

    # NOTE: the reference's LRU stack-distance model produces RECENCY
    # locality, not popularity skew (within a pooling group ids are unique
    # by construction), so hot-hit rate on these streams is bounded by hot-
    # set COVERAGE of the line space. Assert exactly that: a hot set
    # covering ~60% of the lines serves ~60% of the lookups, and the hot
    # ids selected from one sample window remain the stream's top ids
    # later (the rotation keeps the head stable across batches).
    n_lines = min(cfg.scaled_rows)
    K = int(0.6 * n_lines) * cfg.num_tables
    hot_ids = hot_ids_from_generator(cfg, seed=4, hot_rows=K, n_batches=4,
                                     batch_size=64, data_generation="synthetic",
                                     trace_file=str(dist))
    gen = RecDataGenerator(cfg, seed=99, data_generation="synthetic",
                           trace_file=str(dist))
    batch = gen.generate_batch(64)
    split = split_hot_cold(np.asarray(batch.indices),
                           np.asarray(cfg.table_offsets), hot_ids)
    hit = 1.0 - split["n_cold"] / batch.indices.size
    assert 0.4 < hit < 0.95, hit

    # End-to-end: serving with synthetic engine data + hotcold impl.
    model_cfg = cfg.replace(embedding_impl="hotcold", hot_set_rows=64)
    scfg = ServingConfig(num_batches=6, inference_engines=1, engine_backend="cpu",
                         avg_arrival_rate_ms=0.5, batch_size_distribution="fixed",
                         avg_mini_batch_size=8, max_mini_batch_size=16,
                         batch_buckets=(8, 16), sub_task_batch_size=16,
                         req_granularity=2, data_generation="synthetic",
                         synthetic_trace_file=str(dist))
    res = run_serving(model_cfg, scfg, settle_s=0.01)
    assert res.num_responses == 6


def test_coalesce_never_exceeds_largest_bucket():
    """A drained request that would overflow the largest bucket is carried
    to the next execution, not silently clamped (undercomputed)."""
    import time

    import jax

    from deeprecsys_tpu.serving.engine import ComputeEngine
    from deeprecsys_tpu.serving.packets import ServiceRequest

    model_cfg = zoo.get_config("ncf", table_scale=2000)
    cfg = ServingConfig(engine_backend="cpu", batch_buckets=(8,),
                        max_mini_batch_size=8, coalesce_requests=True,
                        max_coalesce=8)
    req_q, resp_q, ready_q = queue.Queue(), queue.Queue(), queue.Queue()
    # Enqueue BEFORE starting so the backlog is there to coalesce.
    for i in range(3):
        req_q.put(ServiceRequest(batch_id=i, epoch=0, arrival_time=time.time(),
                                 batch_size=8, total_sub_batches=1))
    eng = ComputeEngine(0, model_cfg, cfg, req_q, resp_q, ready_q,
                        device=jax.devices("cpu")[0])
    eng.start()
    assert not isinstance(ready_q.get(timeout=120), Exception)
    seen = [resp_q.get(timeout=60) for _ in range(3)]
    assert sorted(r.batch_id for r in seen) == [0, 1, 2]
    # Three full-bucket requests cannot share executions: 3 runs at bucket
    # 8 (the clamped path would have run 2 and dropped 8 rows of work).
    assert eng.bucket_counts == {8: 3}
    req_q.put(None)
    eng.join(timeout=30)
    assert not eng.is_alive()


def test_coalesce_sentinel_not_stolen_from_peer():
    """A sentinel drained during coalescing is re-queued so every engine
    receives its own shutdown signal (no peer blocks forever)."""
    import time

    import jax

    from deeprecsys_tpu.serving.engine import ComputeEngine
    from deeprecsys_tpu.serving.packets import ServiceRequest

    model_cfg = zoo.get_config("ncf", table_scale=2000)
    cfg = ServingConfig(engine_backend="cpu", batch_buckets=(16,),
                        max_mini_batch_size=16, coalesce_requests=True,
                        max_coalesce=8)
    req_q, resp_q, ready_q = queue.Queue(), queue.Queue(), queue.Queue()
    # One request followed immediately by both sentinels: the first engine
    # to coalesce will drain a sentinel mid-group.
    req_q.put(ServiceRequest(batch_id=0, epoch=0, arrival_time=time.time(),
                             batch_size=4, total_sub_batches=1))
    req_q.put(None)
    req_q.put(None)
    engines = [ComputeEngine(i, model_cfg, cfg, req_q, resp_q, ready_q,
                             device=jax.devices("cpu")[0]) for i in range(2)]
    for e in engines:
        e.start()
    for _ in range(2):
        assert not isinstance(ready_q.get(timeout=120), Exception)
    for e in engines:
        e.join(timeout=60)
    assert not any(e.is_alive() for e in engines)


def test_auto_buckets_cover_all_tuning_configs():
    """With DeepRecSched tuning on, the autotuned ladder must cover the
    chunks every batch_configs candidate can produce (the tuner changes
    sub_task_batch_size at runtime)."""
    from deeprecsys_tpu.serving.buckets import autotune_buckets

    cfg = ServingConfig(
        batch_size_distribution="normal", avg_mini_batch_size=165,
        var_mini_batch_size=16, max_mini_batch_size=1024,
        sub_task_batch_size=64, bucket_policy="auto",
        tune_batch_qps=True, batch_configs=(32, 64, 128, 256, 512),
    )
    ladder = autotune_buckets(cfg)
    # A 512-sub-task config sends whole ~165-sized queries as one chunk;
    # the cap must cover them.
    assert max(ladder) > 128
    # Without tuning, the cap stays at the single configured sub-task size.
    cfg2 = ServingConfig(
        batch_size_distribution="normal", avg_mini_batch_size=165,
        var_mini_batch_size=16, max_mini_batch_size=1024,
        sub_task_batch_size=64, bucket_policy="auto",
    )
    assert max(autotune_buckets(cfg2)) == 64


def test_loadgen_death_shuts_engines_down():
    """If the load generator dies mid-run (e.g. a bad size-distribution
    file), live engines used to block on request_q.get() forever — the
    watchdog only handled the all-engines-dead quadrant. Now it injects
    the missing shutdown sentinels and surfaces the loadgen error."""
    import pytest

    from deeprecsys_tpu.serving import run_serving
    from deeprecsys_tpu.serving.latency_model import LatencyModel

    model_cfg = zoo.get_config("ncf", table_scale=5000)
    cfg = ServingConfig(
        num_batches=8, nepochs=1, inference_engines=2, engine_backend="sim",
        batch_size_distribution="file", batch_dist_file="/nonexistent/dist",
        avg_arrival_rate_ms=1.0, max_mini_batch_size=32,
        sub_task_batch_size=16, req_granularity=4, seed=5,
    )
    lm = LatencyModel([1, 32], [0.05, 0.2])
    with pytest.raises(RuntimeError, match="load generator failed"):
        run_serving(model_cfg, cfg, latency_model=lm, settle_s=0.01,
                    watchdog_s=1.0)


def test_engine_midrun_crash_completes_degraded():
    """A ComputeEngine whose serving loop raises must sink its queue (so
    the producer can finish) and still send its done-sentinel."""
    import queue as _q

    from deeprecsys_tpu.serving.engine import ComputeEngine
    from deeprecsys_tpu.serving.packets import ServiceRequest

    model_cfg = zoo.get_config("ncf", table_scale=5000)
    cfg = ServingConfig(engine_backend="cpu", batch_buckets=(8,),
                        max_mini_batch_size=8)
    req_q, resp_q, ready_q = _q.Queue(), _q.Queue(), _q.Queue()
    eng = ComputeEngine(0, model_cfg, cfg, req_q, resp_q, ready_q)

    def boom():
        raise RuntimeError("injected mid-run failure")

    eng._serve_loop = boom
    eng.start()
    assert not isinstance(ready_q.get(timeout=120), Exception)
    # Producer keeps feeding; a crashed engine must consume (sink) these.
    for i in range(5):
        req_q.put(ServiceRequest(batch_id=i, epoch=0, arrival_time=0.0,
                                 batch_size=8, sub_id=0, total_sub_batches=1))
    req_q.put(None)  # shutdown sentinel
    assert resp_q.get(timeout=60) is None  # done-sentinel despite the crash
    eng.join(timeout=30)
    assert not eng.is_alive()
    assert isinstance(eng.error, RuntimeError)
    assert req_q.qsize() == 0  # queue fully drained


def test_mesh_buckets_round_up_not_drop():
    """Non-divisible buckets round UP to the data axis instead of being
    dropped — dropping the cap bucket silently served large requests at a
    smaller bucket (undercompute)."""
    import queue as _q

    from deeprecsys_tpu.parallel import make_mesh
    from deeprecsys_tpu.serving.engine import ComputeEngine

    model_cfg = zoo.get_config("ncf", table_scale=5000)
    cfg = ServingConfig(engine_backend="cpu", batch_buckets=(8, 64, 118, 997),
                        max_mini_batch_size=1024)
    mesh = make_mesh(data=8, model=1)
    eng = ComputeEngine(0, model_cfg, cfg, _q.Queue(), _q.Queue(), _q.Queue(),
                        mesh=mesh)
    assert eng.buckets == (8, 64, 120, 1000)  # rounded, none dropped


def test_auto_coverage_estimated_out_of_sample():
    """The auto-impl coverage estimate must be out-of-sample: when the hot
    budget exceeds the number of DISTINCT sampled ids (small models, short
    warm-up samples), every sampled id lands in the hot set and an
    in-sample hit rate reads exactly 1.0 on a uniform stream whose true
    hit rate is tiny — auto would enable hotcold on exactly the workloads
    it regresses. Held-out estimation reports the generalizing rate."""
    from deeprecsys_tpu.models.hotcold import hot_ids_and_coverage_from_generator

    cfg = zoo.get_config("ncf", table_scale=10)
    # Budget 16384 rows >> the ~6.7k distinct ids an 8x256-query uniform
    # sample of ncf's 4 single-lookup tables produces.
    hot_ids, cov = hot_ids_and_coverage_from_generator(cfg, seed=31,
                                                       hot_rows=16384)
    assert len(hot_ids) < 16384  # select_hot_ids hit the "all sampled" branch
    assert cov < 0.5  # in-sample this reads exactly 1.0

    # Control: when the hot set genuinely covers the whole (scaled) table,
    # the held-out estimate still reads ~1.
    small = zoo.get_config("rm1", table_scale=2000)
    _, cov_all = hot_ids_and_coverage_from_generator(small, seed=31,
                                                     hot_rows=65536)
    assert cov_all > 0.9


def test_reload_superseded_handle_released():
    """A second request_reload before the first applies must set the
    first handle's event with a 'superseded' error — a waiter on the
    orphaned handle would otherwise block forever."""
    import jax

    from deeprecsys_tpu.serving.engine import ComputeEngine

    model_cfg = zoo.get_config("ncf", table_scale=2000)
    cfg = ServingConfig(engine_backend="cpu", batch_buckets=(8,),
                        max_mini_batch_size=8)
    eng = ComputeEngine(0, model_cfg, cfg, queue.Queue(), queue.Queue(),
                        queue.Queue(), device=jax.devices("cpu")[0])
    h1 = eng.request_reload("/tmp/ckpt_a")
    h2 = eng.request_reload("/tmp/ckpt_b")
    assert h1.event.is_set() and "superseded" in str(h1.error)
    assert not h2.event.is_set() and eng._reload is h2


def test_reload_applies_to_coalesced_drain(tmp_path):
    """A request drained into a coalescing group AFTER request_reload()
    must be served with the new params (the ReloadHandle contract). The
    trigger queue schedules the reload from inside the drain's
    get_nowait — the exact interleaving where the pre-drain check used
    to serve the drained request stale."""
    import time

    import jax

    from deeprecsys_tpu.models import get_model
    from deeprecsys_tpu.serving.engine import ComputeEngine
    from deeprecsys_tpu.serving.packets import ServiceRequest
    from deeprecsys_tpu.utils.checkpoint import save_params

    model_cfg = zoo.get_config("ncf", table_scale=2000)
    new = get_model(model_cfg).init(jax.random.PRNGKey(77))
    save_params(tmp_path / "ckpt", new)

    class TriggerQueue(queue.Queue):
        """Schedules the reload the first time the drain polls."""

        engine = None
        handle = None

        def get_nowait(self):
            if self.handle is None and self.engine is not None:
                self.handle = self.engine.request_reload(str(tmp_path / "ckpt"))
            return super().get_nowait()

    req_q = TriggerQueue()
    resp_q, ready_q = queue.Queue(), queue.Queue()
    cfg = ServingConfig(engine_backend="cpu", batch_buckets=(8,),
                        max_mini_batch_size=8, coalesce_requests=True,
                        max_coalesce=4)
    eng = ComputeEngine(0, model_cfg, cfg, req_q, resp_q, ready_q,
                        device=jax.devices("cpu")[0])
    # Both requests queued before the engine starts: it blocks-gets R1,
    # then the drain's get_nowait schedules the reload and returns R2.
    now = time.time()
    req_q.put(ServiceRequest(batch_id=0, epoch=0, arrival_time=now,
                             batch_size=3, total_sub_batches=1))
    req_q.put(ServiceRequest(batch_id=1, epoch=0, arrival_time=now,
                             batch_size=4, total_sub_batches=1))
    req_q.engine = eng
    eng.start()
    got = ready_q.get(timeout=300)
    assert not isinstance(got, Exception), got
    seen = [resp_q.get(timeout=120) for _ in range(2)]
    assert sorted(r.batch_size for r in seen) == [3, 4]
    # The swap must have been applied BEFORE the group executed.
    assert req_q.handle is not None and req_q.handle.event.is_set()
    assert req_q.handle.error is None
    np.testing.assert_allclose(
        np.asarray(jax.tree_util.tree_leaves(eng.params)[0]),
        np.asarray(jax.tree_util.tree_leaves(new)[0]), rtol=1e-6)
    req_q.put(None)


def test_engine_serves_real_dataset(tmp_path):
    """End-to-end serving on data_generation='dataset': a ComputeEngine
    warms up from a Criteo TSV (reference parity: the engines' data layer
    supports dataset mode, dlrm_data_caffe2.py:36-37)."""
    import time

    import jax

    from deeprecsys_tpu.data.criteo import criteo_model_config, write_synthetic_criteo
    from deeprecsys_tpu.serving.engine import ComputeEngine
    from deeprecsys_tpu.serving.packets import ServiceRequest

    path = tmp_path / "criteo.tsv"
    write_synthetic_criteo(path, 64, seed=7)
    model_cfg = criteo_model_config(rows_per_table=1000)
    cfg = ServingConfig(engine_backend="cpu", batch_buckets=(16,),
                        max_mini_batch_size=16, data_generation="dataset",
                        raw_data_file=str(path))
    req_q, resp_q, ready_q = queue.Queue(), queue.Queue(), queue.Queue()
    eng = ComputeEngine(0, model_cfg, cfg, req_q, resp_q, ready_q,
                        device=jax.devices("cpu")[0])
    eng.start()
    got = ready_q.get(timeout=300)
    assert not isinstance(got, Exception), got
    req_q.put(ServiceRequest(batch_id=0, epoch=0, arrival_time=time.time(),
                             batch_size=9, total_sub_batches=1))
    r = resp_q.get(timeout=120)
    assert r.batch_size == 9 and r.inference_end_time >= r.queue_start_time
    req_q.put(None)


def test_batch_tuning_excludes_accel_then_restores_threshold(tmp_path):
    """During CPU sub-batch tuning the accelerator must see ZERO traffic
    (the reference's stated intent, scheduler.py 'lets not run with the
    Accel sweeps' — sizes clip INCLUSIVELY to max and route with >=, so a
    threshold of exactly max would leak every clipped-to-max query).
    When tuning ends, the CONFIGURED threshold must be restored: the
    measurement epochs serve the deployment the config asked for, accel
    included."""
    model_cfg = zoo.get_config("ncf", table_scale=SCALE)
    log = tmp_path / "responses.log"
    cfg = ServingConfig(
        num_batches=48, nepochs=1, inference_engines=1, engine_backend="sim",
        avg_arrival_rate_ms=1.0, batch_size_distribution="fixed",
        avg_mini_batch_size=512, max_mini_batch_size=256,  # clips to 256
        sub_task_batch_size=64, req_granularity=8, seed=7,
        tune_batch_qps=True, batch_configs=(64, 128),
        arr_steps=4, sched_timeout=3, target_latency_ms=5.0,
        min_arr_range=0.5, max_arr_range=8.0,
        model_accel=True, accel_request_size_thres=256,
        log_file=str(log),
    )
    lm = LatencyModel([1, 32, 256], [0.1, 0.3, 1.2])
    accel_lm = LatencyModel([1, 256], [0.05, 0.1])
    res = run_serving(model_cfg, cfg, latency_model=lm,
                      accel_latency_model=accel_lm, settle_s=0.01,
                      log_responses=True)
    import ast

    rows = [ast.literal_eval(line) for line in log.read_text().splitlines()]
    accel_ids = {i for i in range(cfg.inference_engines, cfg.inference_engines + 1)}
    tuning_on_accel = [r for r in rows if r["exp_packet"]
                       and r["consumer_id"] in accel_ids]
    measured_on_accel = [r for r in rows if not r["exp_packet"]
                         and r["consumer_id"] in accel_ids]
    assert not tuning_on_accel  # exclusion held through the whole climb
    assert measured_on_accel    # restore: accel serves the measurement
    assert res.accel_requests == len(measured_on_accel)


def test_all_engines_dead_with_live_loadgen_raises_not_hangs():
    """The last hang quadrant: every engine dies mid-run while the load
    generator is still alive (eventually blocked on the bounded queue).
    The watchdog must raise — its 'engines still alive' continue branch
    used to spin forever because loadgen.is_alive() stayed True."""

    class DyingLatencyModel(LatencyModel):
        def __init__(self):
            super().__init__([1, 256], [0.05, 0.1])
            self.calls = 0

        def predict_ms(self, batch_size):
            self.calls += 1
            if self.calls > 3:
                raise RuntimeError("injected engine death")
            return super().predict_ms(batch_size)

    model_cfg = zoo.get_config("ncf", table_scale=SCALE)
    cfg = ServingConfig(
        num_batches=5000, nepochs=1, inference_engines=1, engine_backend="sim",
        avg_arrival_rate_ms=0.2, batch_size_distribution="fixed",
        avg_mini_batch_size=64, max_mini_batch_size=64,
        sub_task_batch_size=64, req_granularity=8, seed=2,
    )
    with pytest.raises(RuntimeError, match="ALL engines exited"):
        run_serving(model_cfg, cfg, latency_model=DyingLatencyModel(),
                    settle_s=0.01, watchdog_s=2.0)


def test_latency_model_edge_cases():
    m = LatencyModel([4, 16, 64], [1.0, 2.0, 4.0])
    # batch 0 (empty probe) and sub-range batches CLAMP — math.log would
    # raise inside a daemon engine thread and silently kill it.
    assert m.predict_ms(0) == pytest.approx(1.0)
    assert m.predict_ms(1) == pytest.approx(1.0)
    with pytest.raises(ValueError, match="mismatched|latencies"):
        LatencyModel([1, 4], [1.0, 2.0, 3.0])


def _start_cpu_engine(model_cfg, cfg, params=None, **engine_kwargs):
    import jax

    from deeprecsys_tpu.serving.engine import ComputeEngine

    req_q, resp_q, ready_q = queue.Queue(), queue.Queue(), queue.Queue()
    eng = ComputeEngine(0, model_cfg, cfg, req_q, resp_q, ready_q,
                        device=jax.devices("cpu")[0], params=params,
                        **engine_kwargs)
    eng.start()
    got = ready_q.get(timeout=300)
    assert not isinstance(got, Exception), got
    return eng, req_q, resp_q


def test_completion_thread_survives_readback_failure():
    """A device/readback error in the completion thread must not wedge the
    engine silently: the error is recorded, the poisoned group is ANSWERED
    with ERR_READBACK (waiters unblock with a 5xx instead of timing out),
    and subsequent requests still complete."""
    import time

    from deeprecsys_tpu.serving.packets import ERR_READBACK, ServiceRequest

    model_cfg = zoo.get_config("ncf", table_scale=SCALE)
    cfg = ServingConfig(engine_backend="cpu", batch_buckets=(8,),
                        max_mini_batch_size=8)
    eng, req_q, resp_q = _start_cpu_engine(model_cfg, cfg)

    class Poison:
        def __array__(self, *a, **k):
            raise RuntimeError("injected readback failure")

    fake = ServiceRequest(batch_id=99, epoch=0, arrival_time=time.time(),
                          batch_size=3, total_sub_batches=1)
    eng._pending.put(([fake], Poison(), time.time(), time.time()))
    req_q.put(ServiceRequest(batch_id=0, epoch=0, arrival_time=time.time(),
                             batch_size=5, total_sub_batches=1))
    err = resp_q.get(timeout=120)
    assert err.batch_id == 99 and err.error_code == ERR_READBACK
    assert err.out_batch_size == 0 and err.error_message()
    r = resp_q.get(timeout=120)
    assert r.batch_id == 0 and r.batch_size == 5  # engine still serving
    assert r.error_code == 0
    assert isinstance(eng.error, RuntimeError)
    req_q.put(None)


def test_supplied_params_pinned_to_engine_device():
    """Externally supplied HOST params (a loaded checkpoint) must be
    device_put at setup — host-numpy leaves re-transfer the full table on
    every jitted call otherwise."""
    import jax
    import numpy as np_

    from deeprecsys_tpu.models import get_model

    model_cfg = zoo.get_config("ncf", table_scale=SCALE)
    host_params = jax.tree_util.tree_map(
        np_.asarray, get_model(model_cfg).init(jax.random.PRNGKey(7)))
    cfg = ServingConfig(engine_backend="cpu", batch_buckets=(8,),
                        max_mini_batch_size=8)
    eng, req_q, _ = _start_cpu_engine(model_cfg, cfg, params=host_params)
    leaves = jax.tree_util.tree_leaves(eng.params)
    assert all(isinstance(l, jax.Array) for l in leaves)
    req_q.put(None)


def test_clamped_requests_counted():
    """In non-strict mode (the serving pools' setting) a request above the
    largest compiled bucket executes clamped — that undercompute must be
    VISIBLE (clamped_requests counter), and out_batch_size reports the rows
    actually executed."""
    import time

    from deeprecsys_tpu.serving.packets import ServiceRequest

    model_cfg = zoo.get_config("ncf", table_scale=SCALE)
    cfg = ServingConfig(engine_backend="cpu", batch_buckets=(8,),
                        max_mini_batch_size=32)  # ladder tops out below max
    eng, req_q, resp_q = _start_cpu_engine(model_cfg, cfg,
                                           strict_buckets=False)
    req_q.put(ServiceRequest(batch_id=0, epoch=0, arrival_time=time.time(),
                             batch_size=20, total_sub_batches=1))
    r = resp_q.get(timeout=120)
    assert r.out_batch_size == 8  # executed rows, not the requested 20
    assert eng.clamped_requests == 1
    req_q.put(None)


def test_strict_buckets_rejects_over_ladder():
    """Direct ComputeEngine construction defaults to strict_buckets: an
    over-ladder request is ANSWERED with ERR_OVER_LADDER (never silently
    undercomputed at the cap bucket) and the engine keeps serving."""
    import time

    from deeprecsys_tpu.serving.packets import ERR_OVER_LADDER, ServiceRequest

    model_cfg = zoo.get_config("ncf", table_scale=SCALE)
    cfg = ServingConfig(engine_backend="cpu", batch_buckets=(8,),
                        max_mini_batch_size=32)
    eng, req_q, resp_q = _start_cpu_engine(model_cfg, cfg)
    assert eng.strict_buckets  # the direct-construction default
    req_q.put(ServiceRequest(batch_id=0, epoch=0, arrival_time=time.time(),
                             batch_size=20, total_sub_batches=1))
    r = resp_q.get(timeout=120)
    assert r.error_code == ERR_OVER_LADDER and r.out_batch_size == 0
    assert eng.rejected_requests == 1 and eng.clamped_requests == 0
    # No execution happened for the rejected request...
    assert sum(eng.bucket_counts.values()) == 0
    # ...and an in-ladder request still serves normally.
    req_q.put(ServiceRequest(batch_id=1, epoch=0, arrival_time=time.time(),
                             batch_size=5, total_sub_batches=1))
    ok = resp_q.get(timeout=120)
    assert ok.batch_id == 1 and ok.error_code == 0 and ok.out_batch_size == 8
    req_q.put(None)


def test_deadline_expired_dropped_before_dispatch():
    """An expired deadline is answered with ERR_DEADLINE BEFORE dispatch:
    no bucket execution is recorded for it, the expired counter moves, and
    live requests are unaffected."""
    import time

    from deeprecsys_tpu.serving.packets import ERR_DEADLINE, ServiceRequest

    model_cfg = zoo.get_config("ncf", table_scale=SCALE)
    cfg = ServingConfig(engine_backend="cpu", batch_buckets=(8,),
                        max_mini_batch_size=8)
    eng, req_q, resp_q = _start_cpu_engine(model_cfg, cfg)
    now = time.time()
    req_q.put(ServiceRequest(batch_id=0, epoch=0, arrival_time=now - 1.0,
                             batch_size=5, total_sub_batches=1,
                             deadline=now - 0.5))  # already expired
    r = resp_q.get(timeout=120)
    assert r.error_code == ERR_DEADLINE and r.out_batch_size == 0
    assert eng.expired_requests == 1
    assert sum(eng.bucket_counts.values()) == 0  # never reached the device
    req_q.put(ServiceRequest(batch_id=1, epoch=0, arrival_time=time.time(),
                             batch_size=5, total_sub_batches=1,
                             deadline=time.time() + 60.0))  # live deadline
    ok = resp_q.get(timeout=120)
    assert ok.batch_id == 1 and ok.error_code == 0
    assert sum(eng.bucket_counts.values()) == 1
    req_q.put(None)


def test_idle_engine_applies_reload(tmp_path):
    """A reload scheduled against an IDLE engine applies within the idle
    wake period — not only when the next request happens to arrive."""
    import jax

    from deeprecsys_tpu.models import get_model
    from deeprecsys_tpu.utils.checkpoint import save_params

    model_cfg = zoo.get_config("ncf", table_scale=SCALE)
    cfg = ServingConfig(engine_backend="cpu", batch_buckets=(8,),
                        max_mini_batch_size=8)
    eng, req_q, _ = _start_cpu_engine(model_cfg, cfg)
    new = get_model(model_cfg).init(jax.random.PRNGKey(5))
    save_params(tmp_path / "ckpt", new)
    handle = eng.request_reload(str(tmp_path / "ckpt"))
    assert handle.event.wait(timeout=30) and handle.error is None
    req_q.put(None)
    eng.join(timeout=30)
    # And a reload scheduled after shutdown-begin resolves with an error
    # instead of hanging its waiters.
    h2 = eng.request_reload(str(tmp_path / "ckpt"))
    assert h2.event.wait(timeout=5) is True or h2.error is not None


def test_engine_auto_composes_hotcold_with_packed_tables():
    """embedding_impl='auto' on a din-class (many-table, PACKED) config
    picks hotcold when coverage clears the threshold. Scores through the
    packed hotcold engine must match the plain packed forward."""
    import time

    import jax
    import numpy as np

    from deeprecsys_tpu.config import ModelConfig
    from deeprecsys_tpu.models import get_model
    from deeprecsys_tpu.models.base import Batch
    from deeprecsys_tpu.serving.engine import ComputeEngine
    from deeprecsys_tpu.serving.packets import ServiceRequest

    base = ModelConfig(model_type="dlrm", embedding_rows=(6,) * 70,
                       sparse_feature_size=32, mlp_bot=(4, 32),
                       mlp_top=(8, 1), num_indices_per_lookup=2,
                       param_dtype="bfloat16", compute_dtype="bfloat16",
                       embedding_impl="auto", hot_set_rows=512,
                       hotcold_min_table_mb=0)  # test-scale tables
    cfg = ServingConfig(engine_backend="cpu", batch_buckets=(4,),
                        max_mini_batch_size=4)

    def start(model_cfg):
        req_q, resp_q, ready_q = queue.Queue(), queue.Queue(), queue.Queue()
        eng = ComputeEngine(0, model_cfg, cfg, req_q, resp_q, ready_q,
                            device=jax.devices("cpu")[0])
        eng.start()
        got = ready_q.get(timeout=300)
        assert not isinstance(got, Exception), got
        return eng, req_q, resp_q

    for pack in (2, 1):
        eng, req_q, resp_q = start(base.replace(table_pack=pack))
        assert eng._hotcold is not None, f"pack={pack}: auto must pick hotcold"
        assert eng.hot_coverage == 1.0   # 420-row table: full coverage
        rng = np.random.default_rng(7)
        idx = rng.integers(0, 6, size=(4, 70, 2)).astype(np.int32)
        dense = rng.standard_normal((4, 4)).astype(np.float32)
        req_q.put(ServiceRequest(batch_id=0, arrival_time=time.time(),
                                 batch_size=4,
                                 payload=Batch(dense=dense, indices=idx)))
        r = resp_q.get(timeout=120)
        assert r.error_code == 0 and r.scores is not None
        direct = get_model(base.replace(table_pack=pack,
                                        embedding_impl="xla"))
        want = np.asarray(direct.apply(
            direct.init(jax.random.PRNGKey(0)),  # engine default seed
            Batch(dense=jax.numpy.asarray(dense),
                  indices=jax.numpy.asarray(idx))), np.float32)
        np.testing.assert_allclose(r.scores, want, rtol=2e-4, atol=1e-5)
        req_q.put(None)
        eng.join(timeout=60)


def test_payload_request_coalesced_with_synthetic_traffic():
    """A client-feature (payload) request coalesced into one bucket
    execution with load-modeling requests gets exactly ITS rows' scores:
    the assembly offsets (engine._assemble_host) and the completion-loop
    score slices must agree."""
    import time

    import jax
    import numpy as np

    from deeprecsys_tpu.models import get_model
    from deeprecsys_tpu.models.base import Batch
    from deeprecsys_tpu.serving.engine import ComputeEngine
    from deeprecsys_tpu.serving.packets import ServiceRequest

    model_cfg = zoo.get_config("ncf", table_scale=SCALE)
    cfg = ServingConfig(
        inference_engines=1, engine_backend="cpu",
        batch_buckets=(8, 32), max_mini_batch_size=32,
        coalesce_requests=True, max_coalesce=4,
    )
    rows = np.asarray(model_cfg.scaled_rows, dtype=np.int64)
    rng = np.random.default_rng(7)
    T, L = model_cfg.num_tables, model_cfg.num_indices_per_lookup
    idx = rng.integers(0, rows[None, :, None], size=(8, T, L)).astype(np.int32)

    req_q, resp_q, ready_q = queue.Queue(), queue.Queue(), queue.Queue()
    # Enqueue BEFORE start so the coalescing drain sees all three at once:
    # synthetic(8) + payload(8) + synthetic(8) -> one 32-bucket execution
    # with the payload rows at offset [8, 16).
    now = time.time()
    req_q.put(ServiceRequest(batch_id=0, arrival_time=now, batch_size=8))
    req_q.put(ServiceRequest(batch_id=1, arrival_time=now, batch_size=8,
                             payload=Batch(dense=None, indices=idx)))
    req_q.put(ServiceRequest(batch_id=2, arrival_time=now, batch_size=8))
    eng = ComputeEngine(0, model_cfg, cfg, req_q, resp_q, ready_q,
                        device=jax.devices("cpu")[0])
    eng.start()
    assert not isinstance(ready_q.get(timeout=300), Exception)
    got = {}
    for _ in range(3):
        r = resp_q.get(timeout=120)
        assert r.error_code == 0
        got[r.batch_id] = r
    assert eng.coalesced_requests == 3
    assert got[0].scores is None and got[2].scores is None
    model = get_model(model_cfg)
    want = np.asarray(model.apply(
        eng.params, Batch(dense=None, indices=jax.numpy.asarray(idx))),
        dtype=np.float32)
    np.testing.assert_allclose(got[1].scores, want, rtol=1e-5, atol=1e-6)
    req_q.put(None)
    eng.join(timeout=30)


def test_bad_arena_slot_answered_and_engine_still_shuts_down():
    """A request whose BlobArena slot is unreadable is answered with
    ERR_READBACK and — the regression — the shutdown sentinel (None) must
    still terminate the serve loop afterwards: _hydrate's skip marker
    once collided with the sentinel, making every orchestrated run hang
    at shutdown (engine spinning in _next_request forever)."""
    import time

    import jax

    from deeprecsys_tpu.runtime.blob_arena import BlobArena, slot_bytes_for
    from deeprecsys_tpu.serving.engine import ComputeEngine
    from deeprecsys_tpu.serving.packets import ERR_READBACK, ServiceRequest

    model_cfg = zoo.get_config("ncf", table_scale=SCALE)
    cfg = ServingConfig(engine_backend="cpu", batch_buckets=(8,),
                        max_mini_batch_size=8)
    sb = slot_bytes_for(8, model_cfg.num_tables,
                        model_cfg.num_indices_per_lookup,
                        model_cfg.dense_dim, model_cfg.out_dim)
    arena = BlobArena("drs_test_badslot", n_slots=2, slot_bytes=sb,
                      create=True)
    req_q, resp_q, ready_q = queue.Queue(), queue.Queue(), queue.Queue()
    eng = ComputeEngine(0, model_cfg, cfg, req_q, resp_q, ready_q,
                        device=jax.devices("cpu")[0], arena=arena)
    eng.start()
    try:
        assert not isinstance(ready_q.get(timeout=300), Exception)
        # Slot 0 was never written: read_batch raises (kind-0 header).
        req_q.put(ServiceRequest(batch_id=0, arrival_time=time.time(),
                                 batch_size=8, payload_slot=0))
        r = resp_q.get(timeout=60)
        assert r.error_code == ERR_READBACK and r.scores is None
        req_q.put(None)
        eng.join(timeout=60)
        assert not eng.is_alive(), "sentinel swallowed after a dropped slot"
    finally:
        arena.close()
        arena.unlink()


def test_malformed_payload_gets_typed_error():
    """A shape-mismatched payload (wrong (T, L), or dense missing when the
    model takes dense features) is answered with ERR_PAYLOAD instead of
    crashing the engine; the engine keeps serving afterwards. Ingress
    validates too — this covers direct queue producers."""
    import time

    import jax

    from deeprecsys_tpu.models.base import Batch
    from deeprecsys_tpu.serving.engine import ComputeEngine
    from deeprecsys_tpu.serving.packets import ERR_OK, ERR_PAYLOAD, ServiceRequest

    model_cfg = zoo.get_config("ncf", table_scale=SCALE)
    cfg = ServingConfig(engine_backend="cpu", batch_buckets=(8,),
                        max_mini_batch_size=8)
    req_q, resp_q, ready_q = queue.Queue(), queue.Queue(), queue.Queue()
    eng = ComputeEngine(0, model_cfg, cfg, req_q, resp_q, ready_q,
                        device=jax.devices("cpu")[0])
    eng.start()
    assert not isinstance(ready_q.get(timeout=300), Exception)

    T, L = model_cfg.num_tables, model_cfg.num_indices_per_lookup
    rng = np.random.default_rng(3)
    bad = rng.integers(0, 4, size=(8, T + 1, L)).astype(np.int32)  # wrong T
    req_q.put(ServiceRequest(batch_id=0, arrival_time=time.time(),
                             batch_size=8,
                             payload=Batch(dense=None, indices=bad)))
    r = resp_q.get(timeout=60)
    assert r.error_code == ERR_PAYLOAD and r.scores is None
    assert eng.rejected_requests == 1

    # A MASKED payload on a non-ragged engine is also a typed rejection:
    # honoring it would trigger a serve-loop compile (the masked program
    # twin is only pre-warmed under accept_ragged) — and hotcold/mesh
    # engines would silently IGNORE the mask (wrong scores).
    good = rng.integers(0, 4, size=(8, T, L)).astype(np.int32)
    req_q.put(ServiceRequest(batch_id=1, arrival_time=time.time(),
                             batch_size=8,
                             payload=Batch(dense=None, indices=good,
                                           mask=np.ones((8, T, L), bool))))
    r = resp_q.get(timeout=60)
    assert r.error_code == ERR_PAYLOAD and r.scores is None

    req_q.put(ServiceRequest(batch_id=2, arrival_time=time.time(),
                             batch_size=8,
                             payload=Batch(dense=None, indices=good)))
    r = resp_q.get(timeout=60)
    assert r.error_code == ERR_OK and r.scores is not None  # still serving
    req_q.put(None)
    eng.join(timeout=30)


def test_payload_scores_through_hotcold_engine():
    """predict-style payload requests work through the hot/cold lookup
    engine too: assembled client rows go through prepare()'s split and
    come back with the same scores as the plain model."""
    import time

    import jax
    import numpy as np

    from deeprecsys_tpu.models import get_model
    from deeprecsys_tpu.models.base import Batch
    from deeprecsys_tpu.serving.engine import ComputeEngine
    from deeprecsys_tpu.serving.packets import ServiceRequest

    model_cfg = zoo.get_config("ncf", table_scale=SCALE).replace(
        embedding_impl="hotcold", hot_set_rows=32)
    cfg = ServingConfig(engine_backend="cpu", batch_buckets=(8,),
                        max_mini_batch_size=8)
    rows = np.asarray(model_cfg.scaled_rows, dtype=np.int64)
    rng = np.random.default_rng(11)
    T, L = model_cfg.num_tables, model_cfg.num_indices_per_lookup
    idx = rng.integers(0, rows[None, :, None], size=(8, T, L)).astype(np.int32)

    req_q, resp_q, ready_q = queue.Queue(), queue.Queue(), queue.Queue()
    eng = ComputeEngine(0, model_cfg, cfg, req_q, resp_q, ready_q,
                        device=jax.devices("cpu")[0])
    eng.start()
    assert not isinstance(ready_q.get(timeout=300), Exception)
    req_q.put(ServiceRequest(batch_id=0, arrival_time=time.time(),
                             batch_size=8,
                             payload=Batch(dense=None, indices=idx)))
    r = resp_q.get(timeout=120)
    assert r.error_code == 0 and r.scores is not None

    # Engine params are the CONVERTED hotcold tree; rebuild the plain
    # model at the engine's seed (0) for the reference forward.
    plain_cfg = model_cfg.replace(embedding_impl="xla")
    model = get_model(plain_cfg)
    want = np.asarray(model.apply(
        model.init(jax.random.PRNGKey(0)),
        Batch(dense=None, indices=jax.numpy.asarray(idx))), dtype=np.float32)
    np.testing.assert_allclose(r.scores, want, rtol=1e-5, atol=1e-6)
    req_q.put(None)
    eng.join(timeout=30)


def test_hotcold_refresh_tracks_ragged_streams_by_valid_slots():
    """Ragged x adaptive refresh: on a masked stream the
    tracker must count coverage over VALID slots only (a lengths-1 batch
    on an L=80 model is 79/80 padding — counting pads as misses would
    read a phantom coverage collapse), and candidate selection must
    exclude the padded slots' index-0 filler (which would otherwise be
    the 'hottest' row of every table). Drift in the VALID lookups must
    still be caught and the refreshed hot set must be the drifted head,
    not the filler."""
    import jax
    import numpy as np

    from deeprecsys_tpu.models import get_model
    from deeprecsys_tpu.models.base import Batch
    from deeprecsys_tpu.serving.ingress import ServingServer

    model_cfg = zoo.get_config("rm1", table_scale=500).replace(
        embedding_impl="hotcold", hot_set_rows=8)
    cfg = ServingConfig(engine_backend="cpu", inference_engines=1,
                        batch_buckets=(8,), max_mini_batch_size=8,
                        sub_task_batch_size=8, accept_ragged=True,
                        hotcold_refresh_interval=4,
                        hotcold_refresh_window=8,
                        hotcold_refresh_margin=0.05)
    server = ServingServer(model_cfg, cfg)
    server.start()
    try:
        eng = server.engines[0]
        assert eng._hotcold is not None
        offsets = np.asarray(model_cfg.table_offsets, dtype=np.int64)
        rows = np.asarray(model_cfg.scaled_rows)
        T, L = model_cfg.num_tables, model_cfg.num_indices_per_lookup
        B = 8
        hot = np.asarray(eng._hotcold.hot_ids)
        rng = np.random.default_rng(3)
        dense = rng.random((B, model_cfg.dense_dim)).astype(np.float32)

        def ragged_predict(per_table_ids):
            """One valid slot per (b, t) carrying per_table_ids[t] (or a
            masked-empty group where it is None); slots 1.. are the
            index-0 filler a buggy tracker would count."""
            idx = np.zeros((B, T, L), dtype=np.int64)
            lengths = np.zeros((B, T), dtype=np.int64)
            for t, i in enumerate(per_table_ids):
                if i is not None:
                    idx[:, t, 0] = i
                    lengths[:, t] = 1
            return server.predict(indices=idx, lengths=lengths, dense=dense)

        # Phase 1 — valid slots live entirely INSIDE the warm-up hot set:
        # live coverage must read ~1.0 (valid-only denominator; the
        # padded slots would drag it to ~1/80) and nothing may refresh.
        hot_local = [None] * T
        for h in hot:
            t = int(np.searchsorted(offsets, h, side="right") - 1)
            hot_local[t] = int(h - offsets[t])
        assert any(i is not None for i in hot_local)
        for _ in range(4):  # one full interval
            ragged_predict(hot_local)
        assert eng.live_hot_coverage > 0.9, (
            "padded slots leaked into the coverage denominator")
        assert eng.hot_refreshes == 0 and eng._hotcold_active

        # Phase 2 — the VALID head drifts to one cold nonzero row per
        # table. The refresh must install exactly that head: a tracker
        # that counted padded slots would select the 8 index-0 fillers
        # instead (79x more frequent) and serve a useless hot set.
        hotset = set(int(h) for h in hot)
        pool = []
        for t in range(T):
            cand = next(i for i in range(1, int(rows[t]))
                        if int(offsets[t]) + i not in hotset)
            pool.append(cand)
        fused_pool = {int(offsets[t]) + pool[t] for t in range(T)}
        for _ in range(24):
            ragged_predict(pool)
            if eng.hot_refreshes >= 1:
                break
        assert eng.hot_refreshes >= 1, "masked drift never caught"
        assert eng._hotcold_active, "masked refresh must not disable"
        new_hot = set(int(h) for h in eng._hotcold.hot_ids)
        assert len(new_hot & fused_pool) >= 6, (
            f"refreshed set {sorted(new_hot)} ignored the valid head "
            f"{sorted(fused_pool)} (filler selection?)")
        # Steady state on the drifted head: coverage holds, no flapping.
        n_ref = eng.hot_refreshes
        for _ in range(4):
            ragged_predict(pool)
        assert eng.live_hot_coverage > 0.9
        assert eng.hot_refreshes == n_ref

        # Scores through the refreshed masked split == direct masked
        # forward on the live params.
        out = ragged_predict(pool)
        idx = np.zeros((B, T, L), dtype=np.int32)
        mask = np.zeros((B, T, L), dtype=bool)
        for t, i in enumerate(pool):
            idx[:, t, 0] = i
            mask[:, t, 0] = True
        direct = get_model(model_cfg.replace(embedding_impl="xla"))
        base = {k: v for k, v in eng.params.items() if k != "hot_table"}
        want = np.asarray(direct.apply(
            base, Batch(dense=jax.numpy.asarray(dense),
                        indices=jax.numpy.asarray(idx),
                        mask=jax.numpy.asarray(mask))), dtype=np.float32)
        np.testing.assert_allclose(np.asarray(out["scores"], np.float32),
                                   want, rtol=1e-5, atol=1e-6)
    finally:
        server.stop()
