"""Multi-Task Wide & Deep.

Reference: ``models/multi_task_wnd.py`` — WnD base with an all-ReLU shared
top MLP (``create_mlp(ln_top, -1, ...)`` :304) followed by
``num_multi_tasks`` independent task heads built from ``arch_mlp_tasks``
(:306-316). Task heads are called with ``sigmoid_layer = ln_top.size - 1``
(:311, :396) — for the shipped config that lands on the heads' final layer;
we replicate the index-based semantics exactly.

Design: the task heads are identical-shape MLPs, so they are stacked and
evaluated in one einsum (see ``stacked_mlp_apply``) instead of N separate
op chains.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from deeprecsys_tpu.config import ModelConfig
from deeprecsys_tpu.models.base import (
    Batch,
    compute_dtype_of,
    init_tables,
    param_dtype_of,
    pooled_lookup,
    stacked_mlp_init,
    stacked_mlp_apply,
)
from deeprecsys_tpu.ops import mlp_init, mlp_apply, cat_interaction


def init(key: jax.Array, cfg: ModelConfig) -> dict:
    pdt = param_dtype_of(cfg)
    assert len(cfg.mlp_bot) == 1
    assert cfg.ln_top[-1] == cfg.mlp_tasks[0], (
        "shared top-MLP output dim must equal task-head input dim "
        "(reference check multi_task_wnd.py:362)"
    )
    k_emb, k_top, k_tasks = jax.random.split(key, 3)
    return {
        "tables": init_tables(k_emb, cfg),
        "top": mlp_init(k_top, cfg.ln_top, pdt),
        "tasks": stacked_mlp_init(k_tasks, cfg.num_multi_tasks, cfg.mlp_tasks, pdt),
    }


def apply_from_pooled(params: dict, pooled: jax.Array, batch: Batch, cfg: ModelConfig) -> jax.Array:
    cdt = compute_dtype_of(cfg)
    z = cat_interaction(batch.dense.astype(cdt), pooled)
    shared = mlp_apply(params["top"], z, sigmoid_layer=-1)  # all-ReLU shared trunk
    x = jnp.broadcast_to(shared[:, None, :], (shared.shape[0], cfg.num_multi_tasks, shared.shape[1]))
    heads = stacked_mlp_apply(params["tasks"], x, sigmoid_layer=len(cfg.ln_top) - 1)
    return heads.reshape(shared.shape[0], -1)  # (B, num_tasks * task_out)


def apply(params: dict, batch: Batch, cfg: ModelConfig) -> jax.Array:
    return apply_from_pooled(params, pooled_lookup(params["tables"], batch, cfg), batch, cfg)
