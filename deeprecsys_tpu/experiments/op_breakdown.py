"""Per-operator-stage runtime breakdown.

Reference: ``experiments/operator_breakdown/sweep_p.py`` — runs every model
with Caffe2 ``prof_dag`` profiling at batch 4^0..4^5 and aggregates per-op
runtimes over the set {FC, SparseLengthsSum, Concat, Relu, Sum,
RecurrentNetwork, Softmax}.

Design: whole-graph op timing is XLA's job (use ``jax.profiler`` for
true per-HLO traces); what the breakdown experiment actually needs is the
architectural split — where does the time go between the embedding gather,
the feature interaction, the MLP towers, and (DIEN) the recurrent scan. We
time each stage as its own jitted function at the same shapes the fused
model runs.

Usage:
    python -m deeprecsys_tpu.experiments.op_breakdown --models rm1 ncf \
        --batches 1 16 256 --table-scale 100
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np




def _time_fn(fn, *args, device=None, iters=16) -> float:
    """Honest stage timing: chained iterations with the last argument
    rolled by the loop index (loop-dependent, in-range for int indices),
    scalar readback, two-point slope (see utils/timing.py). Adaptive
    chain length: sub-0.1 ms stages (the MLP-bound models' everything)
    need hundreds of chained iterations to rise above timing jitter —
    same compiled program, bigger runtime trip count."""
    import jax.numpy as jnp
    from deeprecsys_tpu.utils.timing import time_step_chain

    import jax as _jax

    def step(i, carry, *a):
        # Roll every array leaf of the last argument (handles Batch pytrees).
        x = _jax.tree_util.tree_map(lambda l: jnp.roll(l, i, axis=0), a[-1])
        out = fn(*a[:-1], x)
        return carry + jnp.sum(out.astype(jnp.float32))

    while True:
        try:
            ms = time_step_chain(step, jnp.zeros((), jnp.float32), *args,
                                 iters=iters, device=device)
        except RuntimeError:
            ms = -1.0  # noise-clamped slope: lengthen and retry
        if ms * iters >= 25.0 or iters >= 8192:
            if ms <= 0:
                raise RuntimeError(
                    f"stage slope non-positive even at {iters} chained "
                    f"iterations — backend jitter exceeds the signal")
            return ms
        iters = min(iters * 8, 8192)


def breakdown_for(name: str, batch_size: int, table_scale: int, param_dtype: str = "float32") -> dict:
    """Stage times of ``name`` on the accelerator (``pick_accel_device``;
    the CPU only when JAX is explicitly set to it)."""
    import jax

    from deeprecsys_tpu.utils.devices import pick_accel_device

    device = pick_accel_device()
    with jax.default_device(device):
        return _breakdown(name, batch_size, table_scale, param_dtype, device)


def _breakdown(name, batch_size, table_scale, param_dtype, device) -> dict:
    import functools

    import jax
    import jax.numpy as jnp
    from deeprecsys_tpu import zoo
    from deeprecsys_tpu.data import RecDataGenerator
    from deeprecsys_tpu.models import get_model
    from deeprecsys_tpu.ops import embedding_bag, mlp_apply, dot_interaction, cat_interaction, basic_rnn_scan
    from deeprecsys_tpu.models.base import stacked_mlp_apply

    # table_pack=1: the stage isolation times the PLAIN embedding_bag;
    # a packed (dict) table layout belongs to the packed bag variants.
    cfg = zoo.get_config(name, table_scale=table_scale,
                         param_dtype=param_dtype, compute_dtype=param_dtype,
                         table_pack=1)
    model = get_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    batch = RecDataGenerator(cfg, seed=0).generate_batch(batch_size)
    indices = jnp.asarray(batch.indices)
    offsets = jnp.asarray(cfg.table_offsets)
    times: dict[str, float] = {}
    timed = functools.partial(_time_fn, device=device)

    emb_fn = jax.jit(lambda t, i: embedding_bag(t, offsets, i))
    times["embedding"] = timed(emb_fn, params["tables"], indices)
    pooled = emb_fn(params["tables"], indices)

    m = cfg.sparse_feature_size
    if cfg.model_type == "dlrm":
        dense = jnp.asarray(batch.dense)
        bot_fn = jax.jit(lambda p, x: mlp_apply(p, x))
        times["bottom_mlp"] = timed(bot_fn, params["bot"], dense)
        dense_out = bot_fn(params["bot"], dense)
        if cfg.interaction_op == "dot":
            int_fn = jax.jit(lambda d, e: dot_interaction(d, e, self_interaction=cfg.interaction_itself))
        else:
            int_fn = jax.jit(cat_interaction)
        times["interaction"] = timed(int_fn, dense_out, pooled)
        z = int_fn(dense_out, pooled)
        top_fn = jax.jit(lambda p, x: mlp_apply(p, x, sigmoid_layer=len(cfg.ln_top) - 1))
        times["top_mlp"] = timed(top_fn, params["top"], z)
    elif cfg.model_type in ("wnd", "mtwnd"):
        dense = jnp.asarray(batch.dense)
        int_fn = jax.jit(cat_interaction)
        times["interaction"] = timed(int_fn, dense, pooled)
        z = int_fn(dense, pooled)
        top_fn = jax.jit(lambda p, x: mlp_apply(p, x))
        times["top_mlp"] = timed(top_fn, params["top"], z)
        if cfg.model_type == "mtwnd":
            shared = top_fn(params["top"], z)
            x = jnp.broadcast_to(shared[:, None, :],
                                 (shared.shape[0], cfg.num_multi_tasks, shared.shape[1]))
            task_fn = jax.jit(lambda p, x: stacked_mlp_apply(p, x, sigmoid_layer=len(cfg.ln_top) - 1))
            times["task_heads"] = timed(task_fn, params["tasks"], x)
    elif cfg.model_type == "ncf":
        zmlp = jnp.concatenate([pooled[:, 2, :], pooled[:, 3, :]], axis=1)
        mlp_fn = jax.jit(lambda p, x: mlp_apply(p, x))
        times["top_mlp"] = timed(mlp_fn, params["mlp"], zmlp)
    elif cfg.model_type == "din":
        T = cfg.num_tables
        behavior = pooled[:, 1:T - 2, :]
        ad = pooled[:, T - 2, :]
        att_in = jnp.concatenate(
            [behavior, jnp.broadcast_to(ad[:, None, :], behavior.shape), behavior + ad[:, None, :]],
            axis=-1)
        att_fn = jax.jit(lambda p, x: stacked_mlp_apply(p, x))
        times["attention"] = timed(att_fn, params["attention"], att_in)
        z = jnp.zeros((batch_size, cfg.top_in_dim), pooled.dtype)
        top_fn = jax.jit(lambda p, x: mlp_apply(p, x))
        times["top_mlp"] = timed(top_fn, params["top"], z)
    elif cfg.model_type == "dien":
        T = cfg.num_tables
        seq = jnp.transpose(pooled[:, 1:T - 2, :], (1, 0, 2))
        rnn_fn = jax.jit(lambda p, x: basic_rnn_scan(p, x)[1])
        times["rnn"] = timed(rnn_fn, params["rnn0"], seq)
        z = jnp.zeros((batch_size, cfg.top_in_dim), pooled.dtype)
        top_fn = jax.jit(lambda p, x: mlp_apply(p, x))
        times["top_mlp"] = timed(top_fn, params["top"], z)

    full_fn = jax.jit(model.apply)
    from deeprecsys_tpu.models.base import Batch
    dev_batch = Batch(dense=None if batch.dense is None else jnp.asarray(batch.dense),
                      indices=indices)
    times["full_model"] = timed(full_fn, params, dev_batch)
    total_stage = sum(v for k, v in times.items() if k != "full_model")
    return {
        "model": name,
        "batch": batch_size,
        "device": f"{device.platform} {device.device_kind}",
        "stage_ms": times,
        "stage_fraction": {k: v / total_stage for k, v in times.items() if k != "full_model"},
        "fusion_gain": total_stage / times["full_model"] if times["full_model"] > 0 else None,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", nargs="+", default=["rm1", "rm2", "rm3", "wnd", "mtwnd", "ncf", "din", "dien"])
    ap.add_argument("--batches", nargs="+", type=int, default=[1, 4, 16, 64, 256, 1024])
    ap.add_argument("--table-scale", type=int, default=8)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--out", default="benchmarks/op_breakdown.json")
    args = ap.parse_args(argv)
    rows = []
    for m in args.models:
        for b in args.batches:
            r = breakdown_for(m, b, args.table_scale, args.dtype)
            rows.append(r)
            frac = {k: f"{v:.0%}" for k, v in r["stage_fraction"].items()}
            print(f"{m} b={b}: full={r['stage_ms']['full_model']:.3f}ms {frac} "
                  f"[{r['device']}]", flush=True)
    Path(args.out).parent.mkdir(exist_ok=True)
    Path(args.out).write_text(json.dumps(rows, indent=2))


if __name__ == "__main__":
    main()
