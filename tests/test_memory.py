import jax
import numpy as np
import pytest

from deeprecsys_tpu import zoo
from deeprecsys_tpu.models import get_model
from deeprecsys_tpu.utils.memory import model_memory_bytes, fits_hbm


@pytest.mark.parametrize("name", zoo.MODEL_NAMES)
def test_memory_estimate_matches_actual_params(name):
    cfg = zoo.get_config(name, table_scale=2000)
    est = model_memory_bytes(cfg)
    params = get_model(cfg).init(jax.random.PRNGKey(0))
    actual = sum(l.size * l.dtype.itemsize for l in jax.tree_util.tree_leaves(params))
    assert est["total_bytes"] == actual, (name, est["total_bytes"], actual)


H100_SHARE = 60 * 2**30  # what a JAX process reserves of an 80 GB H100


def test_full_scale_capacity_statements():
    # rm1 full-scale fits one H100's share in bf16.
    rm1 = zoo.get_config("rm1", param_dtype="bfloat16")
    assert fits_hbm(rm1, H100_SHARE)
    assert model_memory_bytes(rm1)["tables_bytes"] == 8 * 4_000_000 * 32 * 2
    # int8 quarters table memory (+ negligible scales).
    rm1_q = rm1.replace(table_quant="int8")
    assert model_memory_bytes(rm1_q)["tables_bytes"] < model_memory_bytes(rm1)["tables_bytes"] // 2 + 64
    # Sharding divides tables: an (artificially) huge config fits at 8 shards.
    big = rm1.replace(embedding_rows=(400_000_000,) * 8)
    assert not fits_hbm(big, H100_SHARE, n_model_shards=1)
    assert fits_hbm(big, H100_SHARE, n_model_shards=8)


def test_suggest_hot_rows_scales_with_quant():
    from deeprecsys_tpu.utils.memory import suggest_hot_rows

    cfg = zoo.get_config("rm2", table_scale=8)
    f32_rows = suggest_hot_rows(cfg.replace(param_dtype="float32"))
    bf16_rows = suggest_hot_rows(cfg.replace(param_dtype="bfloat16"))
    int8_rows = suggest_hot_rows(cfg.replace(table_quant="int8"))
    assert bf16_rows == 2 * f32_rows
    assert int8_rows == 4 * f32_rows  # same bytes, 4x the hot rows
    tiny = zoo.get_config("ncf", table_scale=2000)
    assert suggest_hot_rows(tiny) == tiny.total_rows  # capped at the table
