"""Turnkey multi-device scaling measurement: one flag, bench-style run.

    python tools/mesh_bench.py --mesh 1x4                  # four GPUs
    python tools/mesh_bench.py --mesh 2x4 --virtual 8      # CPU rehearsal

It executes, per model, the judged bench's chained-readback measurement
(bench.py methodology: runtime trip count, two-point slope) with the FULL
hybrid sharding the serving engines use — embedding tables row-sharded
over the mesh "model" axis, batch over "data", XLA inserting the psum —
and records, per (data, model) mesh factorization, the per-device cold-
gather counters from the native splitter (each real slot is one row
fetch the owning device issues). The counters are the
hardware-independent scaling evidence: test_parallel.py asserts the
divide-by-M law; this artifact RECORDS it (benchmarks/mesh_scaling.json).

Virtual runs (``--virtual N`` or fewer real devices than the mesh needs)
execute on the forced-host CPU platform: their wall times validate that
the sharded programs compile + run and are labeled ``"virtual": true`` —
they are NOT device performance numbers. On real devices, times are
chained-readback measurements.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

OUT = Path(__file__).parent.parent / "benchmarks" / "mesh_scaling.json"


def _parse_mesh(s: str) -> tuple[int, int]:
    try:
        d, m = s.lower().split("x")
        d, m = int(d), int(m)
        if d < 1 or m < 1:
            raise ValueError
        return d, m
    except ValueError:
        raise SystemExit(f"--mesh must be DxM (e.g. 2x4), got {s!r}")


def measure_mesh_model(name: str, mesh, batch: int, table_scale: int,
                       iters: int, trials: int = 2) -> dict:
    """Judged-style chained measurement of one model over the mesh."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax import lax

    from deeprecsys_tpu import zoo
    from deeprecsys_tpu.data import RecDataGenerator
    from deeprecsys_tpu.models import get_model
    from deeprecsys_tpu.models.base import Batch
    from deeprecsys_tpu.parallel.sharding import batch_shardings, param_shardings
    from deeprecsys_tpu.utils.timing import two_point_slope_ms

    n_data = mesh.shape["data"]
    if batch % n_data:
        raise SystemExit(f"batch {batch} must divide the data axis {n_data}")
    cfg = zoo.get_config(name, table_scale=table_scale,
                         param_dtype="bfloat16", compute_dtype="bfloat16",
                         table_pack=0)
    model = get_model(cfg)
    host = RecDataGenerator(cfg, seed=0).generate_batch(batch)
    rows_np = np.asarray(cfg.scaled_rows, dtype=np.int32)[None, :, None]

    # Shard params at init time (out_shardings on the jitted init — no
    # host round trip of multi-GB tables), batch via the engines' specs.
    template = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    p_sh = param_shardings(template, mesh)
    params = jax.jit(model.init, out_shardings=p_sh)(jax.random.PRNGKey(0))
    b_sh = batch_shardings(mesh, has_dense=host.dense is not None)
    dense = (None if host.dense is None
             else jax.device_put(host.dense, b_sh.dense))
    indices = jax.device_put(host.indices, b_sh.indices)

    def program(n, params, dense, indices):
        rows = jnp.asarray(rows_np)

        def body(i, c):
            idx = (indices + i) % rows
            d = None if dense is None else dense
            out = model.apply(params, Batch(dense=d, indices=idx))
            return c + jnp.sum(out.astype(jnp.float32))

        return lax.fori_loop(0, n, body, jnp.zeros((), jnp.float32))

    fn = jax.jit(program)
    t0 = time.perf_counter()
    float(fn(iters, params, dense, indices))
    compile_s = time.perf_counter() - t0
    ms = two_point_slope_ms(lambda n: float(fn(n, params, dense, indices)),
                            max(iters // 8, 1), iters, trials)
    if ms <= 0:
        raise RuntimeError(f"{name}: non-positive slope ({ms:.3g} ms/iter)")
    return {"model": name, "batch": batch, "latency_ms": ms,
            "samples_per_s": batch / (ms / 1000.0), "compile_s": compile_s}


def descriptor_counters(name: str, table_scale: int, batch: int,
                        factorizations) -> dict:
    """Per-chip real-slot counts of the hybrid splitter on a zipf stream —
    the recorded form of test_parallel.py's divide-by-M assertions."""
    import numpy as np

    from deeprecsys_tpu import zoo
    from deeprecsys_tpu.experiments.skew_bench import zipf_stream
    from deeprecsys_tpu.models.hotcold import hot_ids_from_generator
    from deeprecsys_tpu.ops.embedding import split_hot_cold_hybrid

    cfg = zoo.get_config(name, table_scale=table_scale)
    total, T = int(cfg.total_rows), cfg.num_tables
    offsets = np.asarray(cfg.table_offsets)
    idx = zipf_stream(cfg, batch)
    hot_ids = hot_ids_from_generator(cfg, seed=5, hot_rows=256, n_batches=2,
                                     batch_size=64)
    out = {}
    for D, M in factorizations:
        if total % M or batch % D:
            continue
        s = split_hot_cold_hybrid(idx, offsets, hot_ids, n_data=D, n_model=M,
                                  rows_per_shard=total // M)
        pad_seg = (batch // D) * T
        real = (s["cold_seg"] != pad_seg).sum(axis=-1)  # (D, M) real slots
        out[f"{D}x{M}"] = {
            "n_cold_total": int(s["n_cold"]),
            "per_chip_descriptors": real.astype(int).tolist(),
            "max_chip_descriptors": int(real.max()),
            "ideal_per_chip": float(s["n_cold"] / (D * M)),
        }
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mesh", required=True, help="DxM (data x model axes)")
    ap.add_argument("--models", nargs="+", default=["rm1", "rm2"])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--table-scale", type=int, default=0,
                    help="0 = auto: 1 (full) on real accelerators, 512 on "
                         "virtual CPU meshes")
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--virtual", type=int, default=0,
                    help="force an N-device virtual CPU mesh (rehearsal)")
    args = ap.parse_args(argv)

    D, M = _parse_mesh(args.mesh)
    need = D * M
    if args.virtual:
        if args.virtual < need:
            raise SystemExit(f"--virtual {args.virtual} < mesh size {need}")
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={args.virtual}"
            ).strip()

    import jax

    if args.virtual:
        jax.config.update("jax_platforms", "cpu")
    devices = jax.devices()
    virtual = devices[0].platform == "cpu"
    if len(devices) < need:
        raise SystemExit(
            f"mesh {D}x{M} needs {need} devices; {len(devices)} available "
            f"({devices[0].platform}). Re-run with --virtual {need} for a "
            f"CPU rehearsal.")
    table_scale = args.table_scale or (512 if virtual else 1)

    from deeprecsys_tpu.parallel import make_mesh

    mesh = make_mesh(data=D, model=M, devices=devices[:need])
    print(f"# mesh {D}x{M} on {devices[0].platform} "
          f"({'VIRTUAL rehearsal — times are not device numbers' if virtual else 'real devices'}), "
          f"table_scale={table_scale}", flush=True)

    results, counters = {}, {}
    factorizations = [(1, need), (need, 1)] + (
        [(D, M), (M, D)] if D != M and D != 1 and M != 1 else [(D, M)])
    factorizations = sorted(set(factorizations))
    for m in args.models:
        r = measure_mesh_model(m, mesh, args.batch, table_scale, args.iters)
        results[m] = r
        print(f"# {m}: {r['latency_ms']:.3f} ms/iter "
              f"({r['samples_per_s']:.0f} samples/s) over {D}x{M}, "
              f"compile {r['compile_s']:.1f}s", flush=True)
        counters[m] = descriptor_counters(m, table_scale, args.batch,
                                          factorizations)
        for k, c in counters[m].items():
            print(f"#   splitter {k}: max chip {c['max_chip_descriptors']} "
                  f"descriptors vs ideal {c['ideal_per_chip']:.0f} "
                  f"(total {c['n_cold_total']})", flush=True)

    record = {
        "mesh": f"{D}x{M}", "devices": need,
        "platform": devices[0].platform, "virtual": virtual,
        "table_scale": table_scale, "batch": args.batch,
        "results": results, "descriptor_counters": counters,
    }
    prior = json.loads(OUT.read_text()) if OUT.exists() else {}
    prior[f"{D}x{M}:{devices[0].platform}"] = record
    OUT.write_text(json.dumps(prior, indent=2))
    print(json.dumps({"mesh": f"{D}x{M}", "virtual": virtual,
                      "models": list(results)}))


if __name__ == "__main__":
    main()
