"""HTTP serving ingress (serving/ingress.py).

The reference has no external request API (single-node, in-process queues
only); these tests cover this framework's ingress addition end-to-end
over a real socket: concurrent clients, partitioning + rejoin, accel
routing, metrics, and malformed-request handling.
"""

import json
import threading
import urllib.error
import urllib.request

import pytest

from deeprecsys_tpu import zoo
from deeprecsys_tpu.config import ServingConfig
from deeprecsys_tpu.serving.ingress import HttpIngress, ServingServer
from deeprecsys_tpu.serving.latency_model import LatencyModel


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, json.loads(r.read())


@pytest.fixture()
def ingress():
    model_cfg = zoo.get_config("ncf", table_scale=2000)
    cfg = ServingConfig(engine_backend="sim", inference_engines=2,
                        sub_task_batch_size=16, max_mini_batch_size=64,
                        model_accel=True, accel_request_size_thres=48)
    lm = LatencyModel([1, 64], [1.0, 2.0])
    accel_lm = LatencyModel([1, 64], [0.5, 0.6])
    server = ServingServer(model_cfg, cfg, latency_model=lm,
                           accel_latency_model=accel_lm)
    server.start()
    ing = HttpIngress(server)
    ing.start()
    host, port = ing.address
    yield f"http://{host}:{port}"
    ing.stop()


def test_infer_partitions_and_rejoins(ingress):
    status, out = _post(f"{ingress}/v1/infer", {"batch_size": 40})
    assert status == 200
    assert out["sub_batches"] == 3  # 16+16+8
    assert not out["accel"]
    assert out["latency_ms"] > 0
    assert out["queue_wait_ms"] >= 0 and out["inference_ms"] > 0


def test_infer_routes_big_queries_to_accel(ingress):
    status, out = _post(f"{ingress}/v1/infer", {"batch_size": 50})
    assert status == 200
    assert out["accel"] and out["sub_batches"] == 1
    # accel engine id is the last one
    assert out["engines"] == [2]


def test_concurrent_clients_and_stats(ingress):
    results = []

    def client(n):
        results.append(_post(f"{ingress}/v1/infer", {"batch_size": n}))

    threads = [threading.Thread(target=client, args=(8 + i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(s == 200 for s, _ in results)
    assert len({r["batch_id"] for _, r in results}) == 8  # unique ids

    status, stats = _get(f"{ingress}/v1/stats")
    assert status == 200
    assert stats["completed"] >= 8 and stats["qps"] > 0
    assert stats["p95_ms"] >= stats["p50_ms"]


def test_healthz(ingress):
    status, h = _get(f"{ingress}/v1/healthz")
    assert status == 200
    assert h["status"] == "ok" and h["model"] == "ncf" and h["engines"] == 3


def test_bad_requests(ingress):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{ingress}/v1/infer", {"wrong_key": 1})
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{ingress}/v1/infer", {"batch_size": 0})
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{ingress}/v1/nope", {"batch_size": 1})
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(f"{ingress}/v1/unknown")
    assert e.value.code == 404


def test_exp_packets_excluded_from_stats(ingress):
    _, before = _get(f"{ingress}/v1/stats")
    _post(f"{ingress}/v1/infer", {"batch_size": 4, "exp": True})
    _, after = _get(f"{ingress}/v1/stats")
    assert after["completed"] == before["completed"]


def test_ingress_over_process_engines():
    """cpu-mp backend: OS-process engines over native shm rings behind the
    same HTTP ingress (reference topology + external API)."""
    pytest.importorskip("deeprecsys_tpu.runtime.shm_queue")
    from deeprecsys_tpu.runtime.native import native_available

    if not native_available():
        pytest.skip("native runtime not built")

    model_cfg = zoo.get_config("ncf", table_scale=2000)
    cfg = ServingConfig(engine_backend="cpu-mp", inference_engines=2,
                        sub_task_batch_size=8, max_mini_batch_size=16,
                        batch_buckets=(8, 16))
    server = ServingServer(model_cfg, cfg)
    server.start(timeout=300)
    ing = HttpIngress(server)
    ing.start()
    host, port = ing.address
    base = f"http://{host}:{port}"
    try:
        status, out = _post(f"{base}/v1/infer", {"batch_size": 12})
        assert status == 200
        assert out["sub_batches"] == 2  # 8 + 4
        assert out["latency_ms"] > 0
        status, h = _get(f"{base}/v1/healthz")
        assert h["engines"] == 2
    finally:
        ing.stop()


def test_predict_over_process_engines():
    """Real-input inference on the cpu-mp backend (round-3 asymmetry
    closed): /v1/predict features cross to the engine OS processes
    through the shared blob arena (the 64-byte POD ring carries only the
    slot id), the scores come back through the same slot, and they match
    the THREAD-engine scores for the identical payload and seed — the
    thread path is the correctness bar. Slots are all
    returned afterwards (no leak)."""
    import numpy as np

    pytest.importorskip("deeprecsys_tpu.runtime.shm_queue")
    from deeprecsys_tpu.runtime.native import native_available

    if not native_available():
        pytest.skip("native runtime not built")

    model_cfg = zoo.get_config("ncf", table_scale=2000)
    rows = np.asarray(model_cfg.scaled_rows, dtype=np.int64)
    T, L = model_cfg.num_tables, model_cfg.num_indices_per_lookup
    rng = np.random.default_rng(3)
    # 12 rows -> two sub-requests (8 + 4): exercises multi-slot staging,
    # per-sub-request score slicing, and sub_id-ordered reassembly.
    idx = rng.integers(0, rows[None, :, None], size=(12, T, L)).astype(np.int32)

    def serve_predict(backend):
        cfg = ServingConfig(engine_backend=backend, inference_engines=1,
                            sub_task_batch_size=8, max_mini_batch_size=16,
                            batch_buckets=(8, 16), payload_arena_slots=7)
        server = ServingServer(model_cfg, cfg)
        server.start(timeout=300)
        if backend == "cpu-mp":
            # The configured transport capacity reaches the arena.
            assert server._arena.n_slots == 7
        ing = HttpIngress(server)
        ing.start()
        base = "http://%s:%s" % ing.address
        try:
            status, out = _post(f"{base}/v1/predict",
                                {"indices": idx.tolist()})
            assert status == 200
            assert out["sub_batches"] == 2
            scores = np.asarray(out["scores"], np.float32)
            assert scores.shape == (12, model_cfg.out_dim)
            if backend == "cpu-mp":
                assert server._arena.in_flight() == 0, "leaked arena slots"
                # A second query re-uses freed slots.
                status, out2 = _post(f"{base}/v1/predict",
                                     {"indices": idx.tolist()})
                assert status == 200
                np.testing.assert_allclose(
                    np.asarray(out2["scores"], np.float32), scores,
                    rtol=1e-6, atol=1e-7)
                assert server._arena.in_flight() == 0
                # Arena health is an operator surface (exhaustion/leak
                # detection), not just an internal counter.
                status, h = _get(f"{base}/v1/healthz")
                assert status == 200
                assert h["payload_slots_in_flight"] == 0
                assert h["payload_slots_total"] == server._arena.n_slots
            return scores
        finally:
            ing.stop()
            # Double stop must be a no-op: ing.stop() already stopped the
            # server; a second stop on cpu-mp used to push the sentinel
            # into the unmapped native ring — a SEGFAULT, not an error
            # (found by tools/cpu_mp_soak.py's shutdown).
            server.stop()

    want = serve_predict("cpu")
    got = serve_predict("cpu-mp")
    # Same seed (cfg.seed + engine_id = 0) and same CPU backend in the
    # child process: the weights are bit-identical, so the scores are too
    # (up to float accumulation order, which is also identical here).
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_predict_ragged_over_process_engines():
    """Ragged (lengths+values CSR) real inference on the cpu-mp backend:
    the blob arena carries the slot mask alongside indices/dense (1 byte
    per lookup slot, sized in at arena creation when accept_ragged), so
    the process topology serves variable-length requests too. Scores
    must equal the direct masked forward at the child engine's seed."""
    import jax
    import numpy as np

    pytest.importorskip("deeprecsys_tpu.runtime.shm_queue")
    from deeprecsys_tpu.runtime.native import native_available

    if not native_available():
        pytest.skip("native runtime not built")

    from deeprecsys_tpu.data.ragged import pad_csr
    from deeprecsys_tpu.models import get_model
    from deeprecsys_tpu.models.base import Batch

    model_cfg = zoo.get_config("rm1", table_scale=50_000)
    T, L = model_cfg.num_tables, model_cfg.num_indices_per_lookup
    rows = np.asarray(model_cfg.scaled_rows, dtype=np.int64)
    cfg = ServingConfig(engine_backend="cpu-mp", inference_engines=1,
                        sub_task_batch_size=4, max_mini_batch_size=8,
                        batch_buckets=(4, 8), accept_ragged=True)
    server = ServingServer(model_cfg, cfg)
    server.start(timeout=300)
    ing = HttpIngress(server)
    ing.start()
    base = "http://%s:%s" % ing.address
    rng = np.random.default_rng(9)
    B = 6  # two sub-requests: mask slicing across arena slots
    lengths = rng.integers(0, L + 1, size=(B, T))
    values = np.concatenate(
        [rng.integers(0, rows[t], size=int(lengths[b, t]))
         for b in range(B) for t in range(T)]).astype(np.int64)
    dense = rng.random((B, model_cfg.dense_dim)).astype(np.float32)
    try:
        status, out = _post(f"{base}/v1/predict", {
            "lengths": lengths.tolist(), "values": values.tolist(),
            "dense": dense.tolist()})
        assert status == 200 and out["sub_batches"] == 2
        got = np.asarray(out["scores"], np.float32)
        assert server._arena.in_flight() == 0, "leaked arena slots"
        idx, mask = pad_csr(lengths, values, L)
        model = get_model(model_cfg)
        want = np.asarray(model.apply(
            model.init(jax.random.PRNGKey(cfg.seed)),  # child seed 123+0
            Batch(dense=jax.numpy.asarray(dense),
                  indices=jax.numpy.asarray(idx.astype(np.int32)),
                  mask=jax.numpy.asarray(mask))), np.float32)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    finally:
        ing.stop()


def test_predict_arena_exhaustion_503_then_recovery():
    """Transport backpressure end-to-end: when every
    blob-arena slot is staged for in-flight payload sub-requests, a new
    /v1/predict must fail fast with a retryable 503 (OverloadedError ->
    HTTP 503, ingress.py predict handler), leak nothing, and recover to
    200 once capacity returns. Then a concurrent burst over a tiny arena:
    every response is 200 or 503 (never a hang, a 500, or a router
    death), in-flight drains to zero, and the server still serves."""
    import numpy as np

    pytest.importorskip("deeprecsys_tpu.runtime.shm_queue")
    from deeprecsys_tpu.runtime.native import native_available

    if not native_available():
        pytest.skip("native runtime not built")

    model_cfg = zoo.get_config("ncf", table_scale=2000)
    rows = np.asarray(model_cfg.scaled_rows, dtype=np.int64)
    T, L = model_cfg.num_tables, model_cfg.num_indices_per_lookup
    rng = np.random.default_rng(11)
    idx = rng.integers(0, rows[None, :, None], size=(4, T, L)).astype(np.int32)
    body = {"indices": idx.tolist()}
    cfg = ServingConfig(engine_backend="cpu-mp", inference_engines=1,
                        sub_task_batch_size=8, max_mini_batch_size=16,
                        batch_buckets=(8, 16), payload_arena_slots=2)
    server = ServingServer(model_cfg, cfg)
    server.start(timeout=300)
    ing = HttpIngress(server)
    ing.start()
    base = "http://%s:%s" % ing.address
    try:
        # Phase 1 — deterministic exhaustion: stage both slots (as two
        # in-flight queries would), then a predict must 503 with the
        # retryable exhaustion message, not queue or 500.
        held = [server._arena.alloc() for _ in range(2)]
        assert server._arena.in_flight() == 2
        try:
            _post(f"{base}/v1/predict", body)
            raise AssertionError("expected 503")
        except urllib.error.HTTPError as e:
            assert e.code == 503
            err = json.loads(e.read())["error"]
            assert "slot" in err  # points the operator at the knob
        # The failed query must not leak pending state or slots.
        assert server._arena.in_flight() == 2
        assert not server._pending
        for s in held:
            server._arena.free(s)
        status, out = _post(f"{base}/v1/predict", body)  # recovery
        assert status == 200
        assert np.asarray(out["scores"]).shape == (4, model_cfg.out_dim)
        assert server._arena.in_flight() == 0

        # Phase 2 — concurrent burst over the 2-slot arena: 8 parallel
        # predicts race for slots. Each must resolve as 200 or 503.
        results = [None] * 8

        def hit(i):
            try:
                results[i] = _post(f"{base}/v1/predict", body)[0]
            except urllib.error.HTTPError as e:
                results[i] = e.code

        ts = [threading.Thread(target=hit, args=(i,)) for i in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert all(r in (200, 503) for r in results), results
        assert 200 in results  # the burst wasn't a blanket failure
        # Exhaustion/recovery cycle complete: nothing left in flight,
        # the router survived (healthz reports zero arena faults), and
        # the server still answers.
        assert server._arena.in_flight() == 0
        status, h = _get(f"{base}/v1/healthz")
        assert status == 200 and "arena_faults" not in h
        status, _ = _post(f"{base}/v1/predict", body)
        assert status == 200
    finally:
        ing.stop()
        server.stop()


def test_multi_model_registry():
    """Two model families behind one ingress; per-model routing + listing."""
    servers = {}
    for name in ("ncf", "rm1"):
        cfg = ServingConfig(engine_backend="sim", inference_engines=1,
                            sub_task_batch_size=16, max_mini_batch_size=32)
        servers[name] = ServingServer(zoo.get_config(name, table_scale=2000), cfg,
                                      latency_model=LatencyModel([1, 64], [1.0, 2.0]))
        servers[name].start()
    ing = HttpIngress(servers, default="ncf")
    ing.start()
    host, port = ing.address
    base = f"http://{host}:{port}"
    try:
        _, models = _get(f"{base}/v1/models")
        assert set(models) == {"ncf", "rm1"}
        assert models["rm1"]["model"] == "dlrm"

        s, out = _post(f"{base}/v1/models/rm1/infer", {"batch_size": 20})
        assert s == 200 and out["sub_batches"] == 2
        s, out = _post(f"{base}/v1/infer", {"batch_size": 4})  # default=ncf
        assert s == 200 and out["sub_batches"] == 1

        # Per-model reload status is reachable over HTTP (not just the
        # default model's /v1/reload).
        s, st = _get(f"{base}/v1/models/rm1/reload")
        assert s == 200 and st == {"scheduled": 0, "applied": 0,
                                   "failed": 0, "errors": []}

        import urllib.error
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{base}/v1/models/nope/infer", {"batch_size": 1})
        assert e.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(f"{base}/v1/models/nope/reload")
        assert e.value.code == 404
    finally:
        ing.stop()


def test_healthz_reports_bucket_executions_and_liveness(ingress):
    _post(f"{ingress}/v1/infer", {"batch_size": 10})
    status, h = _get(f"{ingress}/v1/healthz")
    assert h["live_engines"] == h["engines"] == 3
    assert h["status"] == "ok"
    # sim engines have no buckets; bucket_executions only for compute engines


def test_reload_endpoint_zero_downtime(tmp_path):
    """POST /v1/reload hot-swaps a checkpoint: applied by each engine
    before its next request, old params keep serving on a bad path, and
    GET /v1/reload reports per-engine status."""
    import jax
    import numpy as np

    from deeprecsys_tpu.models import get_model
    from deeprecsys_tpu.utils.checkpoint import save_params

    model_cfg = zoo.get_config("ncf", table_scale=2000)
    cfg = ServingConfig(engine_backend="cpu", inference_engines=1,
                        batch_buckets=(16,), max_mini_batch_size=16)
    server = ServingServer(model_cfg, cfg)
    server.start()
    ing = HttpIngress(server)
    ing.start()
    url = "http://%s:%s" % ing.address
    try:
        new = get_model(model_cfg).init(jax.random.PRNGKey(123))
        save_params(tmp_path / "ckpt", new)
        status, out = _post(f"{url}/v1/reload", {"path": str(tmp_path / "ckpt")})
        assert status == 200 and out["scheduled"] == 1
        _post(f"{url}/v1/infer", {"batch_size": 4})  # triggers the apply
        status, st = _get(f"{url}/v1/reload")
        assert st == {"scheduled": 1, "applied": 1, "failed": 0, "errors": []}
        eng = server.engines[0]
        for got, want in zip(jax.tree_util.tree_leaves(eng.params),
                             jax.tree_util.tree_leaves(new)):
            np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                       rtol=1e-6)

        # Bad path: the swap fails, the error is reported, serving
        # continues on the previous params.
        _post(f"{url}/v1/reload", {"path": str(tmp_path / "missing")})
        status, r = _post(f"{url}/v1/infer", {"batch_size": 4})
        assert status == 200 and r["latency_ms"] > 0
        st = _get(f"{url}/v1/reload")[1]
        assert st["failed"] == 1 and "missing" in st["errors"][0]
        np.testing.assert_allclose(
            np.asarray(jax.tree_util.tree_leaves(eng.params)[0]),
            np.asarray(jax.tree_util.tree_leaves(new)[0]), rtol=1e-6)

        # Malformed body.
        try:
            _post(f"{url}/v1/reload", {})
            raise AssertionError("expected 400")
        except urllib.error.HTTPError as e:
            assert e.code == 400
    finally:
        ing.stop()
        server.stop()


def test_reload_unsupported_on_sim_engines(ingress):
    try:
        _post(f"{ingress}/v1/reload", {"path": "/tmp/x"})
        raise AssertionError("expected 501")
    except urllib.error.HTTPError as e:
        assert e.code == 501


def test_oversized_batch_rejected_not_clamped(ingress):
    """POST /v1/infer above max_mini_batch_size must 400 — a silent clamp
    serves a fraction of the submitted work while returning 200."""
    try:
        _post(f"{ingress}/v1/infer", {"batch_size": 10_000_000})
        raise AssertionError("expected 400")
    except urllib.error.HTTPError as e:
        assert e.code == 400
        assert b"max_mini_batch_size" in e.read()


def test_healthz_reports_embedding_impl_decision(tmp_path):
    """embedding_impl='auto' decides per engine at warm-up; the operator
    must be able to SEE the decision (and the sampled coverage) over
    HTTP, not just the config that requested 'auto'."""
    # FULL-scale ncf (336k rows): the hot-set budget (~65k rows) covers
    # ~20% of a uniform stream -> auto must pick direct. (At small table
    # scales the whole table fits the budget and hotcold is correct —
    # the budget-scaled warm-up sample now resolves that case properly.)
    # hotcold_min_table_mb=0: ncf's 21.5 MB table sits under the
    # production size floor, which would decline before sampling — this
    # test is about the COVERAGE-based decision being visible over HTTP.
    model_cfg = zoo.get_config("ncf").replace(embedding_impl="auto",
                                              hotcold_min_table_mb=0)
    cfg = ServingConfig(engine_backend="cpu", inference_engines=1,
                        batch_buckets=(8,), max_mini_batch_size=8)
    server = ServingServer(model_cfg, cfg)
    server.start(timeout=300)
    ing = HttpIngress(server)
    ing.start()
    try:
        _, h = _get("http://%s:%s/v1/healthz" % ing.address)
        (impl,) = h["embedding_impl"]
        assert impl["impl"] == "direct"
        assert 0.0 <= impl["hot_coverage"] < 0.75
    finally:
        ing.stop()
        server.stop()


def test_deadline_expired_504_never_dispatched():
    """Per-request deadline propagation: a request whose
    deadline expires while queued is dropped BEFORE dispatch (no engine
    time burnt), the client gets 504, and /v1/healthz counts the drop."""
    import time

    model_cfg = zoo.get_config("ncf", table_scale=2000)
    cfg = ServingConfig(engine_backend="sim", inference_engines=1,
                        sub_task_batch_size=64, max_mini_batch_size=64)
    # One slow engine: the first query occupies it long enough for the
    # second's deadline to expire in the queue.
    lm = LatencyModel([1, 64], [400.0, 400.0])
    server = ServingServer(model_cfg, cfg, latency_model=lm)
    server.start()
    ing = HttpIngress(server)
    ing.start()
    base = "http://%s:%s" % ing.address
    try:
        t = threading.Thread(
            target=lambda: _post(f"{base}/v1/infer", {"batch_size": 8}))
        t.start()
        time.sleep(0.1)  # let the blocker reach the engine
        t0 = time.time()
        try:
            _post(f"{base}/v1/infer", {"batch_size": 8, "deadline_ms": 50})
            raise AssertionError("expected 504")
        except urllib.error.HTTPError as e:
            assert e.code == 504
            assert b"deadline" in e.read()
        # Answered at dequeue time, not after a second 400 ms execution.
        assert time.time() - t0 < 2.0
        t.join()
        _, h = _get(f"{base}/v1/healthz")
        assert h["expired_requests"] == 1
        # A generous deadline still serves normally.
        status, out = _post(f"{base}/v1/infer",
                            {"batch_size": 8, "deadline_ms": 60_000})
        assert status == 200 and out["latency_ms"] > 0
    finally:
        ing.stop()


def test_deadline_bad_values_rejected():
    model_cfg = zoo.get_config("ncf", table_scale=2000)
    cfg = ServingConfig(engine_backend="sim", inference_engines=1,
                        sub_task_batch_size=64, max_mini_batch_size=64)
    server = ServingServer(model_cfg, cfg,
                           latency_model=LatencyModel([1, 64], [1.0, 1.0]))
    server.start()
    ing = HttpIngress(server)
    ing.start()
    base = "http://%s:%s" % ing.address
    try:
        for bad in (0, -5, "soon"):
            try:
                _post(f"{base}/v1/infer", {"batch_size": 4, "deadline_ms": bad})
                raise AssertionError("expected 400")
            except urllib.error.HTTPError as e:
                assert e.code == 400
    finally:
        ing.stop()


def _sim_server():
    model_cfg = zoo.get_config("ncf", table_scale=2000)
    cfg = ServingConfig(engine_backend="sim", inference_engines=1,
                        sub_task_batch_size=64, max_mini_batch_size=64)
    server = ServingServer(model_cfg, cfg,
                           latency_model=LatencyModel([1, 64], [1.0, 1.0]))
    server.start()
    return server


def test_reload_refused_on_non_loopback_bind():
    """POST /v1/reload deserializes a caller-supplied path; on a
    non-loopback bind that is remote arbitrary-path deserialization, so it
    must 403 unless a reload_root is configured."""
    server = _sim_server()
    ing = HttpIngress(server, host="0.0.0.0")
    ing.start()
    host, port = ing.address
    base = f"http://127.0.0.1:{port}"
    try:
        try:
            _post(f"{base}/v1/reload", {"path": "/etc/passwd"})
            raise AssertionError("expected 403")
        except urllib.error.HTTPError as e:
            assert e.code == 403
            assert b"reload_root" in e.read()
        # Inference itself stays open on the non-loopback bind.
        status, _ = _post(f"{base}/v1/infer", {"batch_size": 4})
        assert status == 200
    finally:
        ing.stop()


def test_reload_root_restricts_paths(tmp_path):
    """With reload_root configured, checkpoint paths must resolve inside
    it — including after symlink/.. tricks (realpath)."""
    server = _sim_server()
    ing = HttpIngress(server, reload_root=str(tmp_path))
    ing.start()
    base = "http://%s:%s" % ing.address
    try:
        for evil in ("/etc/passwd", str(tmp_path) + "/../outside",
                     str(tmp_path) + "suffix/x"):
            try:
                _post(f"{base}/v1/reload", {"path": evil})
                raise AssertionError(f"expected 403 for {evil}")
            except urllib.error.HTTPError as e:
                assert e.code == 403
        # An in-root path passes the guard; the sim backend then 501s
        # (no reloadable engines), proving the guard allowed it through.
        try:
            _post(f"{base}/v1/reload", {"path": str(tmp_path / "ckpt")})
            raise AssertionError("expected 501")
        except urllib.error.HTTPError as e:
            assert e.code == 501
    finally:
        ing.stop()


def test_reload_over_process_engines(tmp_path):
    """Zero-downtime checkpoint reload on the cpu-mp backend (closes the
    round-2 'acceptable asymmetry'): the path ships to each engine
    process over its control ring as 64-byte POD fragments, each child
    applies + ACKs on the response ring, and serving continues. A bad
    path fails the handles while the old params keep serving."""
    import jax

    pytest.importorskip("deeprecsys_tpu.runtime.shm_queue")
    from deeprecsys_tpu.runtime.native import native_available

    if not native_available():
        pytest.skip("native runtime not built")

    from deeprecsys_tpu.models import get_model
    from deeprecsys_tpu.utils.checkpoint import save_params

    model_cfg = zoo.get_config("ncf", table_scale=2000)
    # A long tmp_path exercises multi-fragment reassembly (59 B chunks).
    ckpt = tmp_path / ("deep_subdir_" + "x" * 80) / "ckpt.v2"
    params = get_model(model_cfg).init(jax.random.PRNGKey(42))
    ckpt.parent.mkdir(parents=True)
    save_params(ckpt, params)

    cfg = ServingConfig(engine_backend="cpu-mp", inference_engines=2,
                        sub_task_batch_size=8, max_mini_batch_size=16,
                        batch_buckets=(8, 16))
    # A loaded params PYTREE cannot cross the POD rings — refuse loudly
    # (silently random-initializing children while the caller believes
    # trained weights are serving would be a data bug, not a crash).
    with pytest.raises(ValueError, match="checkpoint_path"):
        ServingServer(model_cfg, cfg, params=params)
    # --checkpoint on cpu-mp: children load the PATH themselves at setup.
    server = ServingServer(model_cfg, cfg, checkpoint_path=str(ckpt))
    server.start(timeout=300)
    ing = HttpIngress(server, reload_root=str(tmp_path))
    ing.start()
    base = "http://%s:%s" % ing.address
    try:
        status, out = _post(f"{base}/v1/reload", {"path": str(ckpt)})
        assert status == 200 and out["scheduled"] == 2
        # ACKs resolve the handles (idle engines poll within 0.5 s).
        for h in server._reload_handles:
            assert h.event.wait(timeout=60)
            assert h.error is None
        _, st = _get(f"{base}/v1/reload")
        assert st == {"scheduled": 2, "applied": 2, "failed": 0,
                      "errors": []}
        # Serving continues on the new params.
        status, out = _post(f"{base}/v1/infer", {"batch_size": 12})
        assert status == 200 and out["latency_ms"] > 0
        # Rapid back-to-back reloads: fragments for BOTH requests are on
        # the rings before the engines poll. Each ACK carries its
        # request's gen tag, so the bad path's failure resolves ITS
        # handles and the good path's success resolves its own — without
        # gen matching the first (failing) ACK would resolve the newer
        # handle with the older reload's outcome.
        bad = server.reload(str(tmp_path / "missing.ckpt"))
        good = server.reload(str(ckpt))
        for h in bad:
            assert h.event.wait(timeout=60)
            assert h.error is not None
        for h in good:
            assert h.event.wait(timeout=60)
            assert h.error is None, f"good reload failed: {h.error!r}"
        # reload_status reports the LATEST request (the good one).
        _, st = _get(f"{base}/v1/reload")
        assert st["applied"] == 2 and st["failed"] == 0
        status, out = _post(f"{base}/v1/infer", {"batch_size": 5})
        assert status == 200
        # A path too long for the fragment protocol (255 x 58-byte chunks)
        # must raise BEFORE any handle is registered: an orphan handle
        # would report 'scheduled' forever and hang its waiters.
        # reload_status keeps showing the last real reload.
        with pytest.raises(ValueError, match="too long"):
            server.reload("/x/" + "y" * (255 * 58))
        _, st = _get(f"{base}/v1/reload")
        assert st["applied"] == 2 and st["failed"] == 0
    finally:
        ing.stop()


def test_mp_checkpoint_load_failure_reported_at_startup(tmp_path):
    """A bad --checkpoint on cpu-mp must fail the ready barrier loudly
    (the child reports through the ready ring), never serve random
    weights."""
    pytest.importorskip("deeprecsys_tpu.runtime.shm_queue")
    from deeprecsys_tpu.runtime.native import native_available

    if not native_available():
        pytest.skip("native runtime not built")
    model_cfg = zoo.get_config("ncf", table_scale=2000)
    cfg = ServingConfig(engine_backend="cpu-mp", inference_engines=1,
                        sub_task_batch_size=8, max_mini_batch_size=16,
                        batch_buckets=(8, 16))
    server = ServingServer(model_cfg, cfg,
                           checkpoint_path=str(tmp_path / "nope.ckpt"))
    try:
        with pytest.raises(RuntimeError, match="failed during"):
            server.start(timeout=120)
        # A reload against the dead engine must resolve its handle with
        # an error immediately (nothing will ever ACK it), never leave it
        # 'scheduled' forever.
        for p in server.procs:
            p.join(timeout=30)
        (h,) = server.reload(str(tmp_path / "whatever.ckpt"))
        assert h.event.is_set() and h.error is not None
        assert "not alive" in str(h.error)
    finally:
        server.stop()


# -- real-input inference (POST /v1/predict) ---------------------------


def _valid_indices(model_cfg, batch, seed=0):
    import numpy as np

    rows = np.asarray(model_cfg.scaled_rows, dtype=np.int64)
    rng = np.random.default_rng(seed)
    T, L = model_cfg.num_tables, model_cfg.num_indices_per_lookup
    return rng.integers(0, rows[None, :, None], size=(batch, T, L),
                        endpoint=False).astype(np.int32)


def test_predict_returns_model_scores():
    """POST /v1/predict runs CLIENT features through the serving fabric
    (partitioned into sub-batches, bucket-padded) and the returned scores
    match a direct model.apply on the same rows — the real-inference path
    the reference lacks entirely (its engines only ever run pre-generated
    synthetic rows, inferenceEngine.py:200-206)."""
    import jax
    import numpy as np

    from deeprecsys_tpu.models import get_model
    from deeprecsys_tpu.models.base import Batch

    model_cfg = zoo.get_config("ncf", table_scale=2000)
    cfg = ServingConfig(engine_backend="cpu", inference_engines=1,
                        batch_buckets=(8, 16), max_mini_batch_size=16,
                        sub_task_batch_size=8)
    server = ServingServer(model_cfg, cfg)
    server.start()
    ing = HttpIngress(server)
    ing.start()
    url = "http://%s:%s" % ing.address
    try:
        idx = _valid_indices(model_cfg, 16)
        status, out = _post(f"{url}/v1/predict", {"indices": idx.tolist()})
        assert status == 200
        assert out["sub_batches"] == 2 and out["batch_size"] == 16
        got = np.asarray(out["scores"], dtype=np.float32)

        model = get_model(model_cfg)
        want = np.asarray(model.apply(
            server.engines[0].params,
            Batch(dense=None, indices=jax.numpy.asarray(idx))),
            dtype=np.float32)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

        # The named-model route answers identically.
        status, out2 = _post(f"{url}/v1/models/ncf/predict",
                             {"indices": idx.tolist()})
        assert status == 200
        np.testing.assert_allclose(np.asarray(out2["scores"], np.float32),
                                   want, rtol=1e-5, atol=1e-6)
    finally:
        ing.stop()
        server.stop()


def test_predict_validation_and_backend_errors(ingress):
    """Malformed feature payloads 400 with actionable messages; the sim
    backend (which computes nothing) 501s instead of fabricating scores."""
    import numpy as np
    # ingress fixture = sim backend.
    try:
        _post(f"{ingress}/v1/predict", {"indices": [[[0]] * 4]})
        raise AssertionError("expected 501")
    except urllib.error.HTTPError as e:
        assert e.code == 501

    model_cfg = zoo.get_config("ncf", table_scale=2000)
    cfg = ServingConfig(engine_backend="cpu", inference_engines=1,
                        batch_buckets=(8,), max_mini_batch_size=8)
    server = ServingServer(model_cfg, cfg)
    server.start()
    ing = HttpIngress(server)
    ing.start()
    url = "http://%s:%s" % ing.address

    def expect_400(payload, needle):
        try:
            _post(f"{url}/v1/predict", payload)
            raise AssertionError("expected 400")
        except urllib.error.HTTPError as e:
            assert e.code == 400
            assert needle in e.read().decode()

    try:
        expect_400({}, "indices")                       # missing
        expect_400({"indices": [[0]]}, "shape")         # wrong rank
        expect_400({"indices": [[[0], [0]]]}, "shape")  # wrong table count
        bad = _valid_indices(model_cfg, 2)
        bad[0, 0, 0] = 10**9                            # out of range
        expect_400({"indices": bad.tolist()}, "out of range")
        ok = _valid_indices(model_cfg, 2)
        expect_400({"indices": ok.tolist(), "dense": [[1.0], [1.0]]},
                   "no dense input")                    # ncf takes none
        expect_400({"indices": _valid_indices(model_cfg, 64).tolist()},
                   "max_mini_batch_size")               # oversize batch
        # Non-integral float ids must be REJECTED, not truncated — 1.9
        # silently becoming row 1 would return scores for wrong rows.
        frac = ok.astype(np.float64) + 0.5
        expect_400({"indices": frac.tolist()}, "integer")
        # Exact-integer floats (common JSON serializer output) are fine
        # and score identically to their int form.
        status, out_f = _post(f"{url}/v1/predict",
                              {"indices": ok.astype(np.float64).tolist()})
        assert status == 200
        # And a valid one still works on this server.
        status, out = _post(f"{url}/v1/predict", {"indices": ok.tolist()})
        assert status == 200 and len(out["scores"]) == 2
        assert out_f["scores"] == out["scores"]
    finally:
        ing.stop()
        server.stop()


def test_predict_dense_model_requires_and_uses_dense():
    """A dense-featured model (wnd) demands its dense input and the
    scores actually depend on it."""
    import numpy as np

    model_cfg = zoo.get_config("wnd", table_scale=2000)
    cfg = ServingConfig(engine_backend="cpu", inference_engines=1,
                        batch_buckets=(4,), max_mini_batch_size=4)
    server = ServingServer(model_cfg, cfg)
    server.start()
    ing = HttpIngress(server)
    ing.start()
    url = "http://%s:%s" % ing.address
    try:
        idx = _valid_indices(model_cfg, 2)
        try:
            _post(f"{url}/v1/predict", {"indices": idx.tolist()})
            raise AssertionError("expected 400")
        except urllib.error.HTTPError as e:
            assert e.code == 400 and b"dense" in e.read()
        d = model_cfg.dense_dim
        dense0 = np.zeros((2, d), np.float32).tolist()
        dense1 = np.full((2, d), 3.0, np.float32).tolist()
        _, out0 = _post(f"{url}/v1/predict",
                        {"indices": idx.tolist(), "dense": dense0})
        _, out1 = _post(f"{url}/v1/predict",
                        {"indices": idx.tolist(), "dense": dense1})
        assert not np.allclose(np.asarray(out0["scores"]),
                               np.asarray(out1["scores"]))
    finally:
        ing.stop()
        server.stop()


def test_prometheus_metrics_exposition(ingress):
    """GET /metrics serves a Prometheus 0.0.4 text exposition covering
    liveness, query counters, latency quantiles, and admission counters —
    scrapeable by stock tooling (the reference's only observability is
    stdout prints + a response log file, DeepRecSys.py:143-175)."""
    _post(f"{ingress}/v1/infer", {"batch_size": 8})
    req = urllib.request.Request(f"{ingress}/metrics")
    with urllib.request.urlopen(req, timeout=30) as r:
        assert r.status == 200
        assert r.headers["Content-Type"].startswith("text/plain")
        body = r.read().decode()
    assert 'drs_up{model="ncf"} 1' in body
    assert 'drs_engines_live{model="ncf"}' in body
    # At least the one completed query is counted, and the latency
    # quantiles are present once a window exists.
    for line in body.splitlines():
        if line.startswith('drs_queries_completed_total{model="ncf"}'):
            assert int(float(line.split()[-1])) >= 1
            break
    else:
        raise AssertionError("completed-queries sample missing")
    assert "drs_query_latency_p95_ms" in body
    assert "drs_expired_requests_total" in body
    # Every sample line parses as <name>{labels} <float>.
    for line in body.splitlines():
        if line.startswith("#") or not line:
            continue
        name_labels, value = line.rsplit(" ", 1)
        float(value)
        assert "{" in name_labels and name_labels.endswith("}")


def test_predict_ragged_lengths_round_trip():
    """Variable-lengths real inference: the reference's
    lengths+values CSR form through /v1/predict on an accept_ragged
    server. Scores must equal the direct masked forward, a full-length
    ragged request must equal the fixed-form request, and the guards
    must refuse ragged input when the capability is off."""
    import jax
    import numpy as np

    from deeprecsys_tpu.data.ragged import pad_csr
    from deeprecsys_tpu.models import get_model
    from deeprecsys_tpu.models.base import Batch

    model_cfg = zoo.get_config("rm1", table_scale=50_000)  # 80 rows/table
    T, L = model_cfg.num_tables, model_cfg.num_indices_per_lookup
    rows = np.asarray(model_cfg.scaled_rows, dtype=np.int64)
    cfg = ServingConfig(engine_backend="cpu", inference_engines=1,
                        sub_task_batch_size=4, max_mini_batch_size=8,
                        batch_buckets=(4, 8), accept_ragged=True)
    server = ServingServer(model_cfg, cfg)
    server.start(timeout=300)
    ing = HttpIngress(server)
    ing.start()
    base = "http://%s:%s" % ing.address
    rng = np.random.default_rng(5)
    B = 6  # -> two sub-requests (4 + 2): mask slicing across chunks
    lengths = rng.integers(0, L + 1, size=(B, T))
    values = np.concatenate(
        [rng.integers(0, rows[t], size=int(lengths[b, t]))
         for b in range(B) for t in range(T)]).astype(np.int64)
    dense = rng.random((B, model_cfg.dense_dim)).astype(np.float32)
    try:
        # CSR form over the wire.
        status, out = _post(f"{base}/v1/predict", {
            "lengths": lengths.tolist(), "values": values.tolist(),
            "dense": dense.tolist()})
        assert status == 200 and out["sub_batches"] == 2
        got = np.asarray(out["scores"], np.float32)
        # Truth: the direct masked forward on the engine's params
        # (engine seed = cfg.seed + engine_id = 123 + 0).
        idx, mask = pad_csr(lengths, values, L)
        model = get_model(model_cfg)
        want = np.asarray(model.apply(
            model.init(jax.random.PRNGKey(cfg.seed)),
            Batch(dense=jax.numpy.asarray(dense),
                  indices=jax.numpy.asarray(idx.astype(np.int32)),
                  mask=jax.numpy.asarray(mask))), np.float32)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

        # Padded-indices + lengths form, with junk beyond each length:
        # must match the CSR result (slots past the length are ignored).
        junk = idx.copy()
        junk[~mask] = 10 ** 9  # out of range — must never be validated/read
        status, out2 = _post(f"{base}/v1/predict", {
            "indices": junk.tolist(), "lengths": lengths.tolist(),
            "dense": dense.tolist()})
        assert status == 200
        np.testing.assert_allclose(np.asarray(out2["scores"], np.float32),
                                   got, rtol=1e-6, atol=1e-7)

        # Full lengths == the fixed-form request exactly.
        fidx = rng.integers(0, rows[None, :, None], size=(B, T, L))
        full = np.full((B, T), L)
        status, r1 = _post(f"{base}/v1/predict", {
            "indices": fidx.tolist(), "lengths": full.tolist(),
            "dense": dense.tolist()})
        status, r2 = _post(f"{base}/v1/predict", {
            "indices": fidx.tolist(), "dense": dense.tolist()})
        np.testing.assert_allclose(np.asarray(r1["scores"], np.float32),
                                   np.asarray(r2["scores"], np.float32),
                                   rtol=1e-5, atol=1e-6)

        # values without lengths is malformed.
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{base}/v1/predict", {"values": values.tolist()})
        assert e.value.code == 400
    finally:
        ing.stop()


def test_predict_ragged_refused_without_capability():
    """lengths on a server without accept_ragged -> 501 (the masked
    programs were never pre-warmed; compiling them in the serve loop is
    exactly what the flag exists to prevent)."""
    model_cfg = zoo.get_config("ncf", table_scale=2000)
    cfg = ServingConfig(engine_backend="cpu", inference_engines=1,
                        sub_task_batch_size=8, max_mini_batch_size=8,
                        batch_buckets=(8,))
    server = ServingServer(model_cfg, cfg)
    server.start(timeout=300)
    ing = HttpIngress(server)
    ing.start()
    base = "http://%s:%s" % ing.address
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{base}/v1/predict", {
                "lengths": [[1] * model_cfg.num_tables],
                "values": [0] * model_cfg.num_tables})
        assert e.value.code == 501
    finally:
        ing.stop()


@pytest.mark.parametrize("mode", ["mesh", "hotcold"])
def test_predict_ragged_on_mesh_and_hotcold_servers(mode):
    """Ragged /v1/predict on the two configurations rounds 1-4 refused:
    a virtual-mesh server (mask sharded over "data")
    and a hotcold server (mask consumed by the host splitter). CSR
    lengths+values in, scores equal to the direct masked forward out."""
    import jax
    import numpy as np

    from deeprecsys_tpu.data.ragged import pad_csr
    from deeprecsys_tpu.models import get_model
    from deeprecsys_tpu.models.base import Batch

    model_cfg = zoo.get_config("rm1", table_scale=5000)
    mesh = None
    if mode == "mesh":
        from deeprecsys_tpu.parallel import make_mesh

        mesh = make_mesh(data=2, model=4)
    else:
        model_cfg = model_cfg.replace(embedding_impl="hotcold",
                                      hot_set_rows=64)
    T, L = model_cfg.num_tables, model_cfg.num_indices_per_lookup
    rows = np.asarray(model_cfg.scaled_rows, dtype=np.int64)
    cfg = ServingConfig(engine_backend="cpu", inference_engines=1,
                        sub_task_batch_size=8, max_mini_batch_size=8,
                        batch_buckets=(8,), accept_ragged=True)
    server = ServingServer(model_cfg, cfg, mesh=mesh)
    server.start(timeout=600)
    ing = HttpIngress(server)
    ing.start()
    base = "http://%s:%s" % ing.address
    rng = np.random.default_rng(9)
    B = 8
    lengths = rng.integers(0, L + 1, size=(B, T))
    values = np.concatenate(
        [rng.integers(0, rows[t], size=int(lengths[b, t]))
         for b in range(B) for t in range(T)]).astype(np.int64)
    dense = rng.random((B, model_cfg.dense_dim)).astype(np.float32)
    try:
        status, out = _post(f"{base}/v1/predict", {
            "lengths": lengths.tolist(), "values": values.tolist(),
            "dense": dense.tolist()})
        assert status == 200
        got = np.asarray(out["scores"], np.float32)
        idx, mask = pad_csr(lengths, values, L)
        direct = get_model(model_cfg.replace(embedding_impl="xla"))
        want = np.asarray(direct.apply(
            direct.init(jax.random.PRNGKey(cfg.seed)),
            Batch(dense=jax.numpy.asarray(dense),
                  indices=jax.numpy.asarray(idx.astype(np.int32)),
                  mask=jax.numpy.asarray(mask))), np.float32)
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)
    finally:
        ing.stop()


@pytest.mark.parametrize("accel_kind", ["sim", "real"])
def test_cpu_mp_with_model_accel_canonical_topology(accel_kind):
    """The reference's CANONICAL topology on the process backend
    (DeepRecSys.py:62-66): N CPU engine OS-processes PLUS
    the accel engine. The accel engine lives in the PARENT (sim: latency
    model only; real: a ComputeEngine on the parent's device) fed by the
    in-process accel queue with its own rejoin router. Big queries route
    to it, small ones to the children, payload predicts stay on the
    children (arena transport), and the real-accel variant returns
    correct scores for load queries."""
    import numpy as np

    pytest.importorskip("deeprecsys_tpu.runtime.shm_queue")
    from deeprecsys_tpu.runtime.native import native_available

    if not native_available():
        pytest.skip("native runtime not built")

    model_cfg = zoo.get_config("ncf", table_scale=2000)
    cfg = ServingConfig(engine_backend="cpu-mp", inference_engines=2,
                        sub_task_batch_size=16, max_mini_batch_size=64,
                        batch_buckets=(16, 64),
                        model_accel=True, accel_request_size_thres=48)
    accel_lm = (LatencyModel([1, 64], [0.5, 0.6]) if accel_kind == "sim"
                else None)
    server = ServingServer(model_cfg, cfg, accel_latency_model=accel_lm)
    server.start(timeout=600)
    ing = HttpIngress(server)
    ing.start()
    base = "http://%s:%s" % ing.address
    try:
        # Small query -> partitioned over the child processes.
        status, small = _post(f"{base}/v1/infer", {"batch_size": 40})
        assert status == 200
        assert not small["accel"] and small["sub_batches"] == 3
        assert all(e < 2 for e in small["engines"])

        # Big query -> the parent-side accel engine, unpartitioned.
        status, big = _post(f"{base}/v1/infer", {"batch_size": 50})
        assert status == 200
        assert big["accel"] and big["sub_batches"] == 1
        assert big["engines"] == [2]

        # Payload predicts stay on the child pool (the accel slot may be
        # a sim that cannot produce scores) and still score correctly
        # through the blob arena.
        rng = np.random.default_rng(4)
        T, L = model_cfg.num_tables, model_cfg.num_indices_per_lookup
        rows = np.asarray(model_cfg.scaled_rows, dtype=np.int64)
        idx = rng.integers(0, rows[None, :, None], size=(50, T, L))
        status, out = _post(f"{base}/v1/predict", {"indices": idx.tolist()})
        assert status == 200
        assert server._arena.in_flight() == 0, "leaked arena slots"
        scores = np.asarray(out["scores"], np.float32)
        # Exact score parity against the child seed is covered by the
        # single-engine cpu-mp tests (two children here hold independent
        # random params, so sub-request placement changes the numbers);
        # this topology test asserts the payload rode the child pool.
        assert scores.shape == (50, model_cfg.out_dim)
        assert np.isfinite(scores).all()
        assert not out["accel"] and all(e < 2 for e in out["engines"])

        # Health sees the full topology: 2 children + 1 accel.
        status, h = _get(f"{base}/v1/healthz")
        assert h["engines"] == 3 and h["live_engines"] == 3
    finally:
        ing.stop()


def test_reload_reaches_parent_accel_on_cpu_mp(tmp_path):
    """cpu-mp + real model_accel reload (round 5): the children receive
    the path over their control rings, and the PARENT-side accel engine
    reloads through its thread-engine slot — all three must apply, and
    the accel engine must actually serve the new checkpoint's weights
    (ingress.py _reload_mp accel_handles; without that branch the accel
    path would silently keep stale weights after every reload)."""
    import jax
    import numpy as np

    pytest.importorskip("deeprecsys_tpu.runtime.shm_queue")
    from deeprecsys_tpu.runtime.native import native_available

    if not native_available():
        pytest.skip("native runtime not built")

    from deeprecsys_tpu.models import get_model
    from deeprecsys_tpu.utils.checkpoint import save_params

    model_cfg = zoo.get_config("ncf", table_scale=2000)
    model = get_model(model_cfg)
    ck_a = tmp_path / "ckpt.a"
    ck_b = tmp_path / "ckpt.b"
    params_a = model.init(jax.random.PRNGKey(42))
    params_b = model.init(jax.random.PRNGKey(7))
    save_params(ck_a, params_a)
    save_params(ck_b, params_b)

    cfg = ServingConfig(engine_backend="cpu-mp", inference_engines=2,
                        sub_task_batch_size=16, max_mini_batch_size=64,
                        batch_buckets=(16, 64),
                        model_accel=True, accel_request_size_thres=48)
    server = ServingServer(model_cfg, cfg, checkpoint_path=str(ck_a))
    server.start(timeout=600)
    accel = server.engines[0]  # parent-side ComputeEngine
    ing = HttpIngress(server, reload_root=str(tmp_path))
    ing.start()
    base = "http://%s:%s" % ing.address
    try:
        status, out = _post(f"{base}/v1/reload", {"path": str(ck_b)})
        assert status == 200 and out["scheduled"] == 3  # 2 children + accel
        for h in server._reload_handles:
            assert h.event.wait(timeout=60)
            assert h.error is None, f"reload failed: {h.error!r}"
        _, st = _get(f"{base}/v1/reload")
        assert st["applied"] == 3 and st["failed"] == 0
        # The accel engine's live params are checkpoint B, not A.
        for got, want in zip(jax.tree_util.tree_leaves(accel.params),
                             jax.tree_util.tree_leaves(params_b)):
            np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                       rtol=1e-6)
        # And a big query still routes to it post-swap.
        status, big = _post(f"{base}/v1/infer", {"batch_size": 50})
        assert status == 200 and big["accel"] and big["engines"] == [2]
    finally:
        ing.stop()
