"""Soak the composition stack: RAGGED /v1/predict on a HOTCOLD
engine with ADAPTIVE REFRESH firing under drift — sustained concurrent
HTTP load.

This is a deep code-path intersection in the framework: every request's CSR lengths+values
become a slot mask consumed by the native splitter's hash-index probe
(runtime/cpp drs_split_hot_cold_indexed), the refresh tracker counts
valid slots only, and each drift-triggered refresh swap builds a fresh
HotIndex on the scan worker and installs it mid-traffic. A leak, race,
or stale-index trip anywhere in that stack shows up here as an error
response, a refusal to refresh, or RSS growth.

Stream: zipf(1.2) ids whose head ROTATES every ``--phase-requests``
requests (adds a large per-phase offset mod rows), collapsing live hot
coverage and forcing the engine through refresh after refresh — each one
an off-thread candidate scan + HotIndex build + swap. Lengths are drawn
uniform [0, L] per (row, table), including empty groups.

Usage:
    python tools/ragged_hotcold_soak.py --minutes 15
Records benchmarks/ragged_hotcold_soak.json.

Reference contrast: the reference serves fixed-shape pre-generated
batches only (inferenceEngine.py:200-206) and has no refresh/soak
tooling at all.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))  # repo-root imports


def main(argv=None):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import urllib.request

    import numpy as np

    from deeprecsys_tpu import zoo
    from deeprecsys_tpu.config import ServingConfig
    from deeprecsys_tpu.serving.ingress import HttpIngress, ServingServer

    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=15.0)
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--phase-requests", type=int, default=300,
                    help="rotate the zipf head every N requests")
    ap.add_argument("--table-scale", type=int, default=100)
    ap.add_argument("--out", default="ragged_hotcold_soak.json")
    args = ap.parse_args(argv)

    # Operating point chosen so the rotating head triggers REFRESH SWAPS
    # rather than a disable: candidate coverage of a 16k hot set on this
    # fold is ~0.7-0.8, safely above min_hit 0.5 — every phase rotation
    # collapses live coverage and installs a fresh hot set + HotIndex.
    model_cfg = zoo.get_config(
        "rm3", table_scale=args.table_scale).replace(
            embedding_impl="hotcold", hot_set_rows=16384,
            hotcold_min_hit=0.5)
    T, L = model_cfg.num_tables, model_cfg.num_indices_per_lookup
    rows = np.asarray(model_cfg.scaled_rows, dtype=np.int64)
    scfg = ServingConfig(engine_backend="cpu", inference_engines=1,
                         sub_task_batch_size=args.batch,
                         max_mini_batch_size=args.batch,
                         batch_buckets=(args.batch,), accept_ragged=True,
                         hotcold_refresh_interval=24,
                         hotcold_refresh_window=8)
    server = ServingServer(model_cfg, scfg)
    server.start(timeout=900)
    ing = HttpIngress(server)
    ing.start()
    base = "http://%s:%s" % ing.address

    def post(path, body, timeout=120):
        req = urllib.request.Request(
            base + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())

    def rss_mb():
        import resource

        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024

    stop_at = time.time() + args.minutes * 60
    lock = threading.Lock()
    stats = {"ok": 0, "errors": 0, "lat_ms": []}
    counter = [0]

    def client(cid: int):
        rng = np.random.default_rng(1000 + cid)
        while time.time() < stop_at:
            with lock:
                counter[0] += 1
                phase = counter[0] // args.phase_requests
            # Rotating zipf head: same skew, different head rows each
            # phase -> live coverage collapses -> refresh fires.
            shift = (phase * 7919) % 100_000
            idx = ((rng.zipf(1.2, size=(args.batch, T, L)) + shift)
                   % rows[None, :, None])
            lengths = rng.integers(0, L + 1, size=(args.batch, T))
            values = np.concatenate(
                [idx[b, t, : lengths[b, t]]
                 for b in range(args.batch) for t in range(T)]
                or [np.empty(0, np.int64)]).astype(np.int64)
            body = {"lengths": lengths.tolist(), "values": values.tolist()}
            if model_cfg.dense_dim:
                body["dense"] = rng.random(
                    (args.batch, model_cfg.dense_dim)).astype(float).tolist()
            t0 = time.perf_counter()
            try:
                status, out = post("/v1/predict", body)
                ms = (time.perf_counter() - t0) * 1e3
                good = (status == 200
                        and np.isfinite(np.asarray(out["scores"])).all())
                with lock:
                    stats["lat_ms"].append(ms)
                    stats["ok" if good else "errors"] += 1
            except Exception as e:  # noqa: BLE001 - soak counts failures
                with lock:
                    stats["errors"] += 1
                print(f"[soak] client {cid} error: {e!r}", flush=True)

    rss0 = rss_mb()
    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(args.clients)]
    t_start = time.time()
    for t in threads:
        t.start()
    while time.time() < stop_at:
        time.sleep(30)
        with lock:
            n, e = stats["ok"], stats["errors"]
        print(f"[soak] t+{time.time() - t_start:.0f}s: {n} ok, {e} err, "
              f"rss {rss_mb():.0f} MB", flush=True)
    for t in threads:
        t.join(timeout=180)

    health = json.loads(
        urllib.request.urlopen(base + "/v1/healthz", timeout=30).read())
    refreshes = sum(e.get("hot_refreshes", 0) or 0
                    for e in health.get("embedding_impl", []))
    lat = np.asarray(stats["lat_ms"])
    record = {
        "minutes": args.minutes, "clients": args.clients,
        "batch": args.batch, "phase_requests": args.phase_requests,
        "requests_ok": stats["ok"], "errors": stats["errors"],
        "hot_refreshes": refreshes,
        "p50_ms": round(float(np.percentile(lat, 50)), 1) if lat.size else None,
        "p95_ms": round(float(np.percentile(lat, 95)), 1) if lat.size else None,
        "rss_start_mb": round(rss0), "rss_end_mb": round(rss_mb()),
        "healthz": health,
    }
    server_stop_err = None
    try:
        ing.stop()
        server.stop()
    except Exception as e:  # noqa: BLE001
        server_stop_err = repr(e)
    record["clean_shutdown"] = server_stop_err is None
    if server_stop_err:
        record["shutdown_error"] = server_stop_err
    out_path = Path(__file__).parent.parent / "benchmarks" / args.out
    out_path.write_text(json.dumps(record, indent=2))
    print(json.dumps({k: v for k, v in record.items() if k != "healthz"}))
    return record


if __name__ == "__main__":
    main()
