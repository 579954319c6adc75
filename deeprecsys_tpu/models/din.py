"""Deep Interest Network.

Reference: ``models/din.py``. Table roles (:295-300): table 0 = user
profile, tables 1..T-3 = user-behavior history (one table per history slot,
expanded to ``user_behavior_tables + 1`` copies by the CLI,
``utils/utils.py:132-149``), T-2 = candidate ad, T-1 = context.

Attention unit per behavior table (:246-285): ``Sum(user, ad)`` ->
``Concat(user, ad, sum)`` (3*m wide) -> small all-ReLU MLP with its OWN
weights (``create_mlp`` called with a fresh tag per table) sandwiched as
``[3m] + mlp_bot + [m]`` (:253-257) -> final Sum over all per-table outputs
(:282-284). Top-MLP input = Concat[profile, attention, ad, context] = 4*m.

Redesign: the ~251 per-table attention MLPs are stacked into
(T_b, n, m) weight arrays and evaluated with ONE batched einsum per layer —
the reference's per-blob Caffe2 graph builds ~750 separate FC ops for this
(SURVEY.md §7 "DIN/DIEN scale").
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
from deeprecsys_tpu.ops import mlp_init, mlp_apply


def _attention_dims(cfg: ModelConfig) -> tuple[int, ...]:
    m = cfg.sparse_feature_size
    return (3 * m,) + cfg.mlp_bot + (m,)


def init(key: jax.Array, cfg: ModelConfig) -> dict:
    pdt = param_dtype_of(cfg)
    num_behavior = len(cfg.behavior_table_ids)
    k_emb, k_att, k_top = jax.random.split(key, 3)
    return {
        "tables": init_tables(k_emb, cfg),
        # sum_fanin: the attention outputs are SUMMED (reference
        # din.py:282-284); see stacked_mlp_init / DESIGN.md §8b.
        "attention": stacked_mlp_init(k_att, num_behavior, _attention_dims(cfg), pdt,
                                      sum_fanin=num_behavior),
        "top": mlp_init(k_top, cfg.ln_top, pdt),  # (4m,) + mlp_top
    }


def apply_from_pooled(params: dict, emb: jax.Array, batch: Batch, cfg: ModelConfig) -> jax.Array:
    T = cfg.num_tables
    profile = emb[:, 0, :]
    behavior = emb[:, 1 : T - 2, :]        # (B, T_b, m)
    ad = emb[:, T - 2, :]
    ctx = emb[:, T - 1, :]

    s = behavior + ad[:, None, :]
    att_in = jnp.concatenate(
        [behavior, jnp.broadcast_to(ad[:, None, :], behavior.shape), s], axis=-1
    )  # (B, T_b, 3m)
    att_out = stacked_mlp_apply(params["attention"], att_in)  # (B, T_b, m), all-ReLU
    attention = att_out.sum(axis=1)

    z = jnp.concatenate([profile, attention, ad, ctx], axis=1)  # (B, 4m)
    # Reference head = all-ReLU (DIN create_mlp has no sigmoid); the
    # "logits" head exposes the final FC's pre-activation for
    # training/ranking (config.py output_head).
    return mlp_apply(params["top"], z,
                     final_relu=cfg.output_head != "logits")


def apply(params: dict, batch: Batch, cfg: ModelConfig) -> jax.Array:
    return apply_from_pooled(params, pooled_lookup(params["tables"], batch, cfg), batch, cfg)
