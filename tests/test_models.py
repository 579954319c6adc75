import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeprecsys_tpu import zoo
from deeprecsys_tpu.data import RecDataGenerator
from deeprecsys_tpu.models import get_model

SCALE = 2000  # shrink tables for CPU tests; architecture dims unchanged


@pytest.fixture(scope="module", params=zoo.MODEL_NAMES)
def model_and_batch(request):
    cfg = zoo.get_config(request.param, table_scale=SCALE)
    model = get_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    gen = RecDataGenerator(cfg, seed=7)
    batch = gen.generate_batch(4)
    return cfg, model, params, batch


def test_forward_shape_and_finite(model_and_batch):
    cfg, model, params, batch = model_and_batch
    out = model.apply(params, batch)
    assert out.shape == (4, cfg.out_dim)
    assert np.isfinite(np.asarray(out)).all()


@pytest.mark.parametrize("name", ["rm1", "din"])
@pytest.mark.parametrize("pack", [2, 4])
def test_forward_packed_tables_match(name, pack):
    """table_pack>1 stores the fused table as (R/p, p*d); the forward is
    bit-identical at f32 because the same logical values are initialized
    before packing and the row-select is exact."""
    cfg = zoo.get_config(name, table_scale=SCALE)
    model = get_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    batch = RecDataGenerator(cfg, seed=7).generate_batch(4)
    want = np.asarray(model.apply(params, batch))

    cfg_p = zoo.get_config(name, table_scale=SCALE).replace(table_pack=pack)
    model_p = get_model(cfg_p)
    params_p = model_p.init(jax.random.PRNGKey(0))
    assert isinstance(params_p["tables"], dict) and "packed" in params_p["tables"]
    got = np.asarray(model_p.apply(params_p, batch))
    np.testing.assert_array_equal(got, want)


def test_table_pack_auto_resolution():
    """Auto (0) is unpacked for every layout; explicit values pass."""
    cfg = zoo.get_config("rm1", table_scale=SCALE)  # d=32
    assert cfg.replace(table_pack=0, param_dtype="bfloat16").resolved_table_pack == 1
    assert cfg.replace(table_pack=0).resolved_table_pack == 1
    assert cfg.replace(table_pack=0,
                       table_quant="int8").resolved_table_pack == 1
    assert cfg.replace(table_pack=0, param_dtype="bfloat16",
                       table_quant="int8_rowwise").resolved_table_pack == 1
    assert cfg.replace(table_pack=3).resolved_table_pack == 3


def test_forward_deterministic_and_jittable(model_and_batch):
    cfg, model, params, batch = model_and_batch
    jit_apply = jax.jit(model.apply)
    a = np.asarray(jit_apply(params, batch))
    b = np.asarray(jit_apply(params, batch))
    c = np.asarray(model.apply(params, batch))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(a, c, rtol=1e-5, atol=1e-6)


def test_batch_independence(model_and_batch):
    # Row i of the output depends only on row i of the inputs — catches
    # accidental cross-batch mixing in the fused layouts.
    cfg, model, params, batch = model_and_batch
    out_full = np.asarray(model.apply(params, batch))
    sub = type(batch)(
        dense=None if batch.dense is None else batch.dense[:2],
        indices=batch.indices[:2],
    )
    out_sub = np.asarray(model.apply(params, sub))
    np.testing.assert_allclose(out_full[:2], out_sub, rtol=1e-4, atol=1e-5)


def test_sigmoid_output_ranges():
    # DLRM / WnD / MT-WnD end in sigmoid; outputs must be in (0, 1).
    for name in ("rm1", "wnd", "mtwnd"):
        cfg = zoo.get_config(name, table_scale=SCALE)
        model = get_model(cfg)
        params = model.init(jax.random.PRNGKey(1))
        batch = RecDataGenerator(cfg, seed=3).generate_batch(3)
        out = np.asarray(model.apply(params, batch))
        assert ((out > 0) & (out < 1)).all(), name


def test_mtwnd_output_is_tasks_times_head():
    cfg = zoo.get_config("mtwnd", table_scale=SCALE)
    assert cfg.out_dim == cfg.num_multi_tasks * cfg.mlp_tasks[-1]


def test_dlrm_dot_variant_runs():
    cfg = zoo.get_config("rm1", table_scale=SCALE).replace(interaction_op="dot")
    model = get_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    batch = RecDataGenerator(cfg, seed=7).generate_batch(4)
    out = model.apply(params, batch)
    assert out.shape == (4, 1)


def test_din_attention_depends_on_behavior_tables():
    cfg = zoo.get_config("din", table_scale=SCALE)
    model = get_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    gen = RecDataGenerator(cfg, seed=7)
    batch = gen.generate_batch(2)
    out1 = np.asarray(model.apply(params, batch))
    # Perturb all behavior-table indices -> output must change. (A single
    # table can legitimately be insensitive: the din config's attention MLP
    # is a 1-wide ReLU bottleneck, [3m]->[1]->[m], which is dead for ~half
    # of random inits.)
    idx = np.array(batch.indices)
    for t in cfg.behavior_table_ids:
        idx[:, t, :] = (idx[:, t, :] + 1) % cfg.scaled_rows[t]
    out2 = np.asarray(model.apply(params, type(batch)(batch.dense, jnp.asarray(idx))))
    assert not np.allclose(out1, out2)


def test_bf16_compute_path():
    cfg = zoo.get_config("rm1", table_scale=SCALE).replace(
        param_dtype="bfloat16", compute_dtype="bfloat16"
    )
    model = get_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    batch = RecDataGenerator(cfg, seed=7).generate_batch(4)
    out = np.asarray(model.apply(params, batch).astype(jnp.float32))
    assert np.isfinite(out).all()


def test_dien_variable_length_histories():
    """Ragged DIEN histories (reference seq_lengths queue, dien.py:112-132):
    a padded batch with per-request seq_lengths must score each request
    exactly as an UNPADDED run of that request's own history length."""
    from deeprecsys_tpu.models import dien

    cfg = zoo.get_config("dien", table_scale=SCALE)
    model = get_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    gen = RecDataGenerator(cfg, seed=11)
    batch = gen.generate_batch(3)
    T = cfg.num_tables
    T_b = T - 3
    lengths = np.array([2, T_b // 2, T_b], dtype=np.int32)

    from deeprecsys_tpu.models.base import pooled_lookup

    emb = pooled_lookup(params["tables"], batch, cfg)
    padded = np.asarray(dien.apply_from_pooled(
        params, emb, batch, cfg, seq_lengths=jnp.asarray(lengths)))

    for b, l in enumerate(lengths):
        # Unpadded run: keep only request b's first l behavior steps
        # (tables 1..l), plus profile/ad/ctx. Weights are shared across
        # steps, so the same params apply at any T_b.
        emb_b = jnp.concatenate(
            [emb[b : b + 1, :1], emb[b : b + 1, 1 : 1 + l],
             emb[b : b + 1, T - 2 :]], axis=1)
        cfg_b = cfg.replace(embedding_rows=cfg.embedding_rows[: int(l) + 3])
        solo = np.asarray(dien.apply_from_pooled(params, emb_b, None, cfg_b))
        np.testing.assert_allclose(padded[b : b + 1], solo, rtol=1e-5, atol=1e-6,
                                   err_msg=f"request {b} (len {l})")


def test_dien_seq_lengths_match_oracle():
    """The masked JAX scan must agree with the oracle's stepwise masked RNN
    (tests/oracle/np_reference.py::basic_rnn) on ragged histories, with
    recurrent weights in the stable regime (see test_parity oracle notes)."""
    from tests.oracle.np_reference import (
        csr_from_batch, dien_forward, oracle_weights_from_params)
    from deeprecsys_tpu.models import dien

    cfg = zoo.get_config("dien", table_scale=SCALE)
    model = get_model(cfg)
    params = model.init(jax.random.PRNGKey(2))
    for rnn in ("rnn0", "rnn1"):
        params[rnn] = {k: v * 0.05 for k, v in params[rnn].items()}
    batch = RecDataGenerator(cfg, seed=13).generate_batch(4)
    T_b = cfg.num_tables - 3
    lengths = np.array([1, 3, T_b // 2, T_b], dtype=np.int32)

    ours = np.asarray(dien.apply(params, batch, cfg,
                                 seq_lengths=jnp.asarray(lengths)),
                      dtype=np.float64)
    w = oracle_weights_from_params(jax.device_get(params), cfg)
    S_indices, S_lengths = csr_from_batch(batch.indices)
    ref = dien_forward(w, S_indices, S_lengths, seq_lengths=lengths)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


def test_dien_bf16_compute_stays_bf16():
    """The gate bias-add must not type-promote the DIEN tail back to f32
    under compute_dtype=bfloat16 (f32 bias + bf16 activation promotes,
    silently doubling activation width for gate/rnn1/top)."""
    import jax
    import jax.numpy as jnp

    cfg = zoo.get_config("dien", table_scale=5000).replace(
        param_dtype="float32", compute_dtype="bfloat16")
    model = get_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    batch = RecDataGenerator(cfg, seed=1).generate_batch(4)
    out = model.apply(params, batch)
    assert out.dtype == jnp.bfloat16
