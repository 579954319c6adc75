"""cpu-mp payload soak: sustained /v1/predict traffic over the blob arena.

The short socket tests prove correctness; this proves the transport
under PRODUCTION-shaped load: OS-process engines, fixed + ragged client
payloads crossing the shared-memory arena for `--minutes`, sampling
every 30 s: completed queries, tails, parent RSS, and — the soak's
point — the arena's in-flight slot count, which must return to zero
whenever traffic pauses (a creep = leaked slots; a plateau at the slot
count = exhaustion; both now also visible on /v1/healthz). CPU-only by
construction (first-line platform pin), so it never opens the GPU.

Usage: python tools/cpu_mp_soak.py [--minutes 30] [--rate 8]
Writes benchmarks/cpu_mp_soak.json (cpu_mp_soak_accel.json with --accel).
"""

import jax

jax.config.update("jax_platforms", "cpu")  # never open the GPU

import argparse
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent.parent))


def rss_mb():
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * 4096 / 1e6


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=30.0)
    ap.add_argument("--rate", type=float, default=8.0, help="per-client QPS")
    ap.add_argument("--model", default="ncf")
    ap.add_argument("--accel", action="store_true",
                    help="reference's canonical topology: a "
                         "REAL parent-side accel engine beside the "
                         "children, plus an /v1/infer client whose big "
                         "queries ride the accel router — soaks the "
                         "dual-router rejoin under sustained load")
    args = ap.parse_args()

    from deeprecsys_tpu import zoo
    from deeprecsys_tpu.config import ServingConfig
    from deeprecsys_tpu.serving.ingress import HttpIngress, ServingServer

    model_cfg = zoo.get_config(args.model, table_scale=2000)
    accel_kw = ({"model_accel": True, "accel_request_size_thres": 12}
                if args.accel else {})
    cfg = ServingConfig(engine_backend="cpu-mp", inference_engines=2,
                        batch_buckets=(8, 16), max_mini_batch_size=16,
                        sub_task_batch_size=8, accept_ragged=True,
                        **accel_kw)
    out_name = "cpu_mp_soak_accel.json" if args.accel else "cpu_mp_soak.json"
    server = ServingServer(model_cfg, cfg)
    server.start(timeout=600)
    ing = HttpIngress(server)
    ing.start()
    base = "http://%s:%s" % ing.address
    rows = np.asarray(model_cfg.scaled_rows, dtype=np.int64)
    T, L = model_cfg.num_tables, model_cfg.num_indices_per_lookup
    stop = threading.Event()
    errors, ok, backpressured = [], [0], [0]

    def client(seed):
        import urllib.error
        import urllib.request

        rng = np.random.default_rng(seed)
        while not stop.is_set():
            b = int(rng.integers(1, 13))
            idx = rng.integers(0, rows[None, :, None],
                               size=(b, T, L)).astype(np.int32)
            payload = {"indices": idx.tolist()}
            if rng.random() < 0.3:  # ~30% ragged traffic over the arena
                payload["lengths"] = rng.integers(
                    0, L + 1, size=(b, T)).tolist()
            try:
                req = urllib.request.Request(
                    base + "/v1/predict",
                    data=json.dumps(payload).encode(),
                    headers={"Content-Type": "application/json"})
                out = json.loads(urllib.request.urlopen(
                    req, timeout=120).read())
                assert len(out["scores"]) == b
                ok[0] += 1
            except urllib.error.HTTPError as e:
                if e.code == 503:
                    # Expected during the exhaustion cycles: retryable
                    # backpressure, not a fault. Counted separately.
                    backpressured[0] += 1
                else:
                    errors.append(repr(e))
                    if len(errors) > 50:
                        return
            except Exception as e:
                errors.append(repr(e))
                if len(errors) > 50:
                    return
            stop.wait(rng.exponential(1.0 / args.rate))

    samples = []
    t0 = time.time()
    t_end = t0 + args.minutes * 60

    def run_exhaustion_cycle():
        """Backpressure phase: stage EVERY arena slot
        (as in-flight queries would), drive predicts into the wall —
        each must fail fast with a retryable 503, never hang or 500 —
        then release and confirm recovery to 200. Recorded in the
        artifact as proof the exhaustion/recovery path survives a soak,
        not just a unit test."""
        import urllib.error
        import urllib.request

        held = []
        try:
            while True:
                held.append(server._arena.alloc())
        except RuntimeError:
            pass  # arena full — exactly the state under test
        outcome = {"slots_staged": len(held), "n_503": 0, "n_other": 0,
                   "recovered_200": False}
        idx = np.zeros((1, T, L), dtype=np.int32)
        body = json.dumps({"indices": idx.tolist()}).encode()
        for _ in range(3):
            try:
                req = urllib.request.Request(
                    base + "/v1/predict", data=body,
                    headers={"Content-Type": "application/json"})
                urllib.request.urlopen(req, timeout=60)
                outcome["n_other"] += 1  # a 200 here means no backpressure
            except urllib.error.HTTPError as e:
                if e.code == 503:
                    outcome["n_503"] += 1
                else:
                    outcome["n_other"] += 1
            except Exception:
                outcome["n_other"] += 1
        for s in held:
            server._arena.free(s)
        try:
            req = urllib.request.Request(
                base + "/v1/predict", data=body,
                headers={"Content-Type": "application/json"})
            out = json.loads(urllib.request.urlopen(req, timeout=120).read())
            outcome["recovered_200"] = len(out["scores"]) == 1
        except Exception as e:
            outcome["recovery_error"] = repr(e)
        print(f"[cpu_mp_soak] exhaustion cycle: {outcome}", flush=True)
        return outcome

    infer_ok = [0, 0]  # [accel-routed, child-routed]

    def infer_client(seed):
        """/v1/infer load traffic straddling the accel threshold: big
        queries ride the parent-side accel engine + its router, small
        ones partition over the children — both rejoin paths stay under
        sustained concurrent load."""
        import urllib.request

        rng = np.random.default_rng(seed)
        while not stop.is_set():
            big = bool(rng.integers(0, 2))
            body = json.dumps(
                {"batch_size": int(rng.integers(13, 17)) if big
                 else int(rng.integers(2, 12))}).encode()
            try:
                req = urllib.request.Request(
                    base + "/v1/infer", data=body,
                    headers={"Content-Type": "application/json"})
                out = json.loads(urllib.request.urlopen(
                    req, timeout=120).read())
                assert out["accel"] == big, (out, big)
                infer_ok[0 if big else 1] += 1
            except Exception as e:
                errors.append(repr(e))
                if len(errors) > 50:
                    return
            stop.wait(rng.exponential(1.0 / args.rate))

    threads = [threading.Thread(target=client, daemon=True, args=(s,))
               for s in range(3)]
    if args.accel:
        threads.append(threading.Thread(target=infer_client, daemon=True,
                                        args=(97,)))
    for t in threads:
        t.start()
    exhaustions = []
    next_exhaustion = t0 + 120  # first cycle 2 min in, then every 5 min
    try:
        while time.time() < t_end:
            time.sleep(30)
            if time.time() >= next_exhaustion:
                exhaustions.append(run_exhaustion_cycle())
                next_exhaustion = time.time() + 300
            import urllib.request

            st = json.loads(urllib.request.urlopen(
                base + "/v1/stats", timeout=60).read())
            h = json.loads(urllib.request.urlopen(
                base + "/v1/healthz", timeout=60).read())
            samples.append({
                "t_s": round(time.time() - t0),
                "predict_ok": ok[0],
                "p50_ms": st.get("p50_ms"),
                "p95_ms": st.get("p95_ms"),
                "slots_in_flight": h.get("payload_slots_in_flight"),
                "rss_mb": round(rss_mb(), 1)})
            print(f"[cpu_mp_soak] {samples[-1]}", flush=True)
            # Incremental artifact: a kill between samples still leaves
            # the evidence on disk (status flips to "done" at the end).
            out = Path(__file__).parent.parent / "benchmarks" / out_name
            out.write_text(json.dumps({
                "status": "running", "model": args.model,
                "minutes": args.minutes, "predict_ok": ok[0],
                "n_errors": len(errors), "samples": samples}, indent=2))
    finally:
        stop.set()
        for t in threads:
            # Outwait the clients' 120 s urlopen: a join that returns with
            # a request legitimately in flight would read its slot as a
            # "leak" in the headline metric below.
            t.join(timeout=150)
        # Quiesced: every staged slot must have come back.
        leaked = server._arena.in_flight()
        ing.stop()
        server.stop()
    rss = [s["rss_mb"] for s in samples] or [float(rss_mb())]
    half = max(len(rss) // 2, 1)
    if half == len(rss):  # single sample: avoid a nan second-half mean
        rss = rss * 2
    rec = {
        "status": "done", "model": args.model, "minutes": args.minutes,
        "engines": cfg.inference_engines, "clients": len(threads),
        "predict_ok": ok[0], "n_errors": len(errors),
        "errors": errors[:10],
        "model_accel": args.accel,
        "infer_accel_ok": infer_ok[0], "infer_child_ok": infer_ok[1],
        "client_503s": backpressured[0],
        "exhaustion_cycles": exhaustions,
        "slots_leaked_at_quiesce": leaked,
        "max_slots_in_flight": max((s["slots_in_flight"] or 0)
                                   for s in samples) if samples else 0,
        "rss_first_half_mb": round(float(np.mean(rss[:half])), 1),
        "rss_second_half_mb": round(float(np.mean(rss[half:])), 1),
        "samples": samples,
    }
    out = Path(__file__).parent.parent / "benchmarks" / out_name
    out.write_text(json.dumps(rec, indent=2))
    print(f"[cpu_mp_soak] DONE: {ok[0]} predicts, {len(errors)} errors, "
          f"{leaked} slots leaked, RSS {rec['rss_first_half_mb']} -> "
          f"{rec['rss_second_half_mb']} MB -> {out}", flush=True)


if __name__ == "__main__":
    main()
