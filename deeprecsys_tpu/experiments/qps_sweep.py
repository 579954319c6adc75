"""Latency-bounded QPS: the DeepRecSys headline metric.

Sweeps Poisson arrival rates (logspace, like the scheduler's candidate
grid) through the full serving stack and reports the maximum sustained
QPS whose measured p95 meets the SLA — the reference's primary evaluation
("latency-bounded QPS", README.md:59, DeepRecSys.py:173-175).

Engines: any backend. The "calibrated-sim" mode drives SimEngines with
LatencyModels measured on the accelerator by ``experiments/sweep.py``
(benchmarks/characterization/accel_<model>.json), i.e. the reference's
own accelerator-simulation pattern fed with our hardware's
characterization.

Usage:
    python -m deeprecsys_tpu.experiments.qps_sweep --model rm1 \
        --backend calibrated-sim --sla-ms 25
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from deeprecsys_tpu import zoo
from deeprecsys_tpu.config import ServingConfig
from deeprecsys_tpu.serving import run_serving
from deeprecsys_tpu.serving.latency_model import LatencyModel

CHAR_DIR = Path(__file__).parent.parent.parent / "benchmarks" / "characterization"


def sweep(model: str, backend: str, sla_ms: float, arrivals_ms, engines: int,
          num_batches: int, table_scale: int, sub_batch: int) -> dict:
    lm = None
    eff_backend = backend
    if backend in ("calibrated-sim", "cpu-calibrated-sim"):
        # cpu-calibrated-sim drives the SAME serving stack with the CPU f32
        # engine characterization (cpu_<model>.json) — the self-measured
        # reference-style baseline BASELINE.md's ">=2x QPS" target compares
        # against. Run it at the SAME engine count as the accelerator
        # sweep: the ladders were characterized solo, so many sim engines
        # would model zero host contention.
        prefix = "accel" if backend == "calibrated-sim" else "cpu"
        path = CHAR_DIR / f"{prefix}_{model}.json"
        if not path.exists():
            raise FileNotFoundError(
                f"no {prefix} characterization for {model}; run "
                "python -m deeprecsys_tpu.experiments.sweep first")
        lm = LatencyModel.load(path)
        eff_backend = "sim"

    rows = []
    best = None
    for arr in arrivals_ms:
        cfg = ServingConfig(
            num_batches=num_batches, nepochs=1, inference_engines=engines,
            engine_backend=eff_backend, avg_arrival_rate_ms=float(arr),
            batch_size_distribution="normal", avg_mini_batch_size=165.0,
            var_mini_batch_size=16.0, max_mini_batch_size=1024,
            sub_task_batch_size=sub_batch, req_granularity=32,
            target_latency_ms=sla_ms, seed=13,
        )
        res = run_serving(zoo.get_config(model, table_scale=table_scale,
                                         param_dtype="bfloat16", compute_dtype="bfloat16"),
                          cfg, latency_model=lm, settle_s=0.05)
        meets = res.p95_ms <= sla_ms
        rows.append({"arrival_ms": float(arr), "qps": res.measured_qps,
                     "p95_ms": res.p95_ms, "p99_ms": res.p99_ms, "meets_sla": meets})
        print(f"arrival={arr:.2f}ms QPS={res.measured_qps:8.1f} "
              f"p95={res.p95_ms:7.2f}ms {'OK' if meets else 'VIOLATES'}", flush=True)
        if meets and (best is None or res.measured_qps > best["qps"]):
            best = rows[-1]
    return {"model": model, "backend": backend, "sla_ms": sla_ms,
            "engines": engines, "sweep": rows,
            "latency_bounded_qps": best["qps"] if best else 0.0}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="rm1")
    ap.add_argument("--backend", default="calibrated-sim")
    ap.add_argument("--sla-ms", type=float, default=25.0)
    ap.add_argument("--engines", type=int, default=2)
    ap.add_argument("--num-batches", type=int, default=96)
    ap.add_argument("--table-scale", type=int, default=8)
    ap.add_argument("--sub-batch", type=int, default=256)
    ap.add_argument("--min-arr", type=float, default=0.3)
    ap.add_argument("--max-arr", type=float, default=20.0)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--out", default="benchmarks/qps_sweep.json")
    args = ap.parse_args(argv)
    arrivals = np.logspace(np.log10(args.min_arr), np.log10(args.max_arr), args.steps)
    result = sweep(args.model, args.backend, args.sla_ms, arrivals, args.engines,
                   args.num_batches, args.table_scale, args.sub_batch)
    print(f"latency-bounded QPS ({args.model}, p95<={args.sla_ms}ms): "
          f"{result['latency_bounded_qps']:.1f}")
    out = Path(args.out)
    existing = json.loads(out.read_text()) if out.exists() else {}
    existing[f"{args.model}:{args.backend}"] = result
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(existing, indent=2))


if __name__ == "__main__":
    main()
