"""Batch-size sweeps: characterization + accelerator-vs-CPU speedup.

Reference parity:
- ``accelerator/generate_data.py``: sweep each model at batch 4^0..4^5 on
  the accelerator to produce the latency lookup tables that the simulated
  accel engine interpolates. Here the sweep produces ``LatencyModel`` JSON
  files under ``benchmarks/characterization/`` (``accel_<model>.json``,
  ``cpu_<model>.json``) for our accelerator and CPU paths —
  consumed by the SimEngine and by the offload scheduler studies.
- ``experiments/speedup/sweep_rt.py``: per-model accelerator-over-CPU
  speedup vs. batch size.

Usage:
    python -m deeprecsys_tpu.experiments.sweep --models rm1 ncf --table-scale 8
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

DEFAULT_BATCHES = (1, 4, 16, 64, 256, 1024)  # 4^0..4^5 ladder of the reference


def sweep_model(name: str, device, batch_sizes, table_scale: int, param_dtype: str,
                iters: int = 8, table_pack: int = 0) -> dict:
    import jax
    import jax.numpy as jnp
    from deeprecsys_tpu import zoo
    from deeprecsys_tpu.data import RecDataGenerator
    from deeprecsys_tpu.models import get_model
    from deeprecsys_tpu.models.base import Batch

    from deeprecsys_tpu.utils.timing import time_step_chain

    cfg = zoo.get_config(name, table_scale=table_scale,
                         param_dtype=param_dtype, compute_dtype=param_dtype,
                         table_pack=table_pack)
    model = get_model(cfg)
    with jax.default_device(device):
        # jit the init: one program instead of one dispatch per op.
        params = jax.jit(model.init)(jax.random.PRNGKey(0))  # ctx pins device
        gen = RecDataGenerator(cfg, seed=0)
        lat_ms = []
        for b in batch_sizes:
            host = gen.generate_batch(b)
            dense = None if host.dense is None else jax.device_put(jnp.asarray(host.dense), device)
            indices = jax.device_put(jnp.asarray(host.indices), device)

            def step(i, carry, params, dense, indices):
                batch = Batch(
                    dense=None if dense is None else jnp.roll(dense, i, axis=0),
                    indices=jnp.roll(indices, i, axis=0),
                )
                out = model.apply(params, batch)
                return carry + jnp.sum(out.astype(jnp.float32))

            ms = time_step_chain(step, jnp.zeros((), jnp.float32), params, dense, indices,
                                 iters=iters, device=device)
            lat_ms.append(ms)
    del params
    return {"model": name, "batch_sizes": list(batch_sizes), "latencies_ms": lat_ms,
            "dtype": param_dtype, "device": str(device), "table_scale": table_scale}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", nargs="+",
                    default=["rm1", "rm2", "rm3", "wnd", "mtwnd", "ncf", "din", "dien"])
    ap.add_argument("--batches", nargs="+", type=int, default=list(DEFAULT_BATCHES))
    ap.add_argument("--table-scale", type=int, default=8)
    ap.add_argument("--cpu", action="store_true", help="also sweep the CPU backend")
    ap.add_argument("--cpu-only", action="store_true",
                    help="skip the accelerator sweep; reuse existing "
                         "accel_*.json for speedups")
    ap.add_argument("--out-dir", default="benchmarks/characterization")
    args = ap.parse_args(argv)

    import jax

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if not args.cpu_only:
        # --cpu-only never initializes the accelerator backend.
        from deeprecsys_tpu.utils.devices import pick_accel_device

        accel = pick_accel_device()

    speedup_table = {}
    for name in args.models:
        if args.cpu_only:
            accel_path = out_dir / f"accel_{name}.json"
            if not accel_path.exists():
                raise FileNotFoundError(f"--cpu-only needs existing {accel_path}")
            r = json.loads(accel_path.read_text())
            if list(r["batch_sizes"]) != [int(b) for b in args.batches]:
                raise SystemExit(
                    f"--cpu-only batch mismatch for {name}: recorded ladder "
                    f"is {r['batch_sizes']}, requested {list(args.batches)} — "
                    "speedups would silently misalign")
            # Same guard for table_scale (recorded by newer sweeps; legacy
            # files lack it — warn rather than die, but never divide
            # silently across operating points).
            rec_scale = r.get("table_scale")
            if rec_scale is not None and rec_scale != args.table_scale:
                raise SystemExit(
                    f"--cpu-only table_scale mismatch for {name}: recorded "
                    f"sweep used {rec_scale}, requested {args.table_scale}")
            if rec_scale is None:
                print(f"# WARNING: {accel_path} predates table_scale recording; "
                      f"verify it was measured at table_scale={args.table_scale}",
                      flush=True)
        else:
            r = sweep_model(name, accel, args.batches, args.table_scale, "bfloat16")
            (out_dir / f"accel_{name}.json").write_text(json.dumps(
                {"batch_sizes": r["batch_sizes"], "latencies_ms": r["latencies_ms"],
                 "base": 4.0, "table_scale": args.table_scale, "dtype": "bfloat16"}))
            print(f"accel {name}: " + " ".join(f"{b}:{l:.2f}ms" for b, l in
                                             zip(r["batch_sizes"], r["latencies_ms"])), flush=True)
        if args.cpu or args.cpu_only:
            c = sweep_model(name, jax.devices("cpu")[0], args.batches, args.table_scale,
                            "float32", iters=3)
            (out_dir / f"cpu_{name}.json").write_text(json.dumps(
                {"batch_sizes": c["batch_sizes"], "latencies_ms": c["latencies_ms"], "base": 4.0}))
            speedup_table[name] = [cl / tl for cl, tl in
                                   zip(c["latencies_ms"], r["latencies_ms"])]
            print(f"speedup {name}: " + " ".join(
                f"{b}:{s:.1f}x" for b, s in zip(args.batches, speedup_table[name])), flush=True)
    if speedup_table:
        (out_dir / "speedup.json").write_text(json.dumps(
            {"batches": args.batches, "speedup": speedup_table}, indent=2))


if __name__ == "__main__":
    main()
