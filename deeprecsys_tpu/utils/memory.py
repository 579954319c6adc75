"""Device-memory capacity planning for model configurations.

Answers "does this model fit, and at what dtype/sharding" before paying a
device allocation — the serving analog of the reference's implicit
host-memory sizing (it simply OOM-killed if a model didn't fit).
"""

from __future__ import annotations

import numpy as np

from deeprecsys_tpu.config import ModelConfig

_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1}


def model_memory_bytes(cfg: ModelConfig) -> dict:
    """Parameter memory by component, in bytes, honoring table_quant."""
    d = cfg.sparse_feature_size
    if cfg.table_quant == "int8":
        table_bytes = cfg.total_rows * d * 1 + cfg.num_tables * 4  # + scales
    elif cfg.table_quant == "int8_rowwise":
        table_bytes = cfg.total_rows * (d + 4)  # interleaved per-row scale
    else:
        table_bytes = cfg.total_rows * d * _DTYPE_BYTES[cfg.param_dtype]

    def mlp_bytes(dims):
        total = 0
        for i in range(1, len(dims)):
            total += (dims[i - 1] * dims[i] + dims[i]) * _DTYPE_BYTES[cfg.param_dtype]
        return total

    dense_bytes = 0
    if cfg.model_type == "dlrm":
        dense_bytes = mlp_bytes(cfg.mlp_bot) + mlp_bytes(cfg.ln_top)
    elif cfg.model_type in ("wnd",):
        dense_bytes = mlp_bytes(cfg.ln_top)
    elif cfg.model_type == "mtwnd":
        dense_bytes = mlp_bytes(cfg.ln_top) + cfg.num_multi_tasks * mlp_bytes(cfg.mlp_tasks)
    elif cfg.model_type == "ncf":
        dense_bytes = mlp_bytes(cfg.ln_top[:-1]) + mlp_bytes(
            (cfg.sparse_feature_size + cfg.ln_top[-2], cfg.ln_top[-1]))
    elif cfg.model_type == "din":
        att = (3 * d,) + cfg.mlp_bot + (d,)
        dense_bytes = len(list(cfg.behavior_table_ids)) * mlp_bytes(att) + mlp_bytes(cfg.ln_top)
    elif cfg.model_type == "dien":
        H = cfg.hidden_size
        # rnn0: input d -> H; rnn1: input H -> H (each has i2h w+b, h2h w+b)
        rnn = ((d * H + H + H * H + H) + (H * H + H + H * H + H)) * _DTYPE_BYTES[cfg.param_dtype]
        dense_bytes = rnn + mlp_bytes((H, H)) + mlp_bytes(cfg.ln_top)
    return {
        "tables_bytes": int(table_bytes),
        "dense_bytes": int(dense_bytes),
        "total_bytes": int(table_bytes + dense_bytes),
    }


def fits_hbm(cfg: ModelConfig, hbm_bytes: int, n_model_shards: int = 1,
             activation_reserve: float = 0.15) -> bool:
    """Whether the model's parameters fit ``hbm_bytes`` of device memory
    per device with a reserve for activations/workspace; tables divide
    over the model axis. Pass the memory this process may use, e.g.
    ``device.memory_stats()["bytes_limit"]``."""
    m = model_memory_bytes(cfg)
    per_chip = m["tables_bytes"] / n_model_shards + m["dense_bytes"]
    return per_chip <= hbm_bytes * (1 - activation_reserve)


def suggest_hot_rows(cfg: ModelConfig, budget_bytes: int = 8 * 2**20) -> int:
    """Hot-set size for embedding_impl="hotcold" that fits ``budget_bytes``.

    Row cost depends on the table layout: bf16/f32 rows cost d*dtype bytes;
    per-table int8 rows cost d bytes (so the same budget holds 2-4x more
    hot rows — higher hit rate for free); packed rowwise costs d+4.
    The 8 MB default is a declared value, not yet measured on the GPU
    (ROADMAP Speed 4 derives it).
    """
    d = cfg.sparse_feature_size
    if cfg.table_quant == "int8":
        row_bytes = d
    elif cfg.table_quant == "int8_rowwise":
        row_bytes = d + 4
    else:
        row_bytes = d * _DTYPE_BYTES[cfg.param_dtype]
    return max(1, min(int(budget_bytes // row_bytes), cfg.total_rows))
