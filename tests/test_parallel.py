"""Sharding tests on the 8-device virtual CPU mesh (SURVEY.md §4 strategy)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeprecsys_tpu import zoo
from deeprecsys_tpu.data import RecDataGenerator
from deeprecsys_tpu.models import get_model
from deeprecsys_tpu.models.base import Batch
from deeprecsys_tpu.ops import embedding_bag
from deeprecsys_tpu.parallel import (
    make_mesh,
    shard_params,
    sharded_apply,
    sharded_embedding_bag,
    make_train_step,
)

SCALE = 5000


def test_make_mesh_shapes():
    m = make_mesh()
    assert m.shape["data"] == 8 and m.shape["model"] == 1
    m2 = make_mesh(data=4, model=2)
    assert m2.shape == {"data": 4, "model": 2}
    m3 = make_mesh(model=4)
    assert m3.shape == {"data": 2, "model": 4}
    with pytest.raises(ValueError):
        make_mesh(data=3, model=3)


def test_sharded_embedding_bag_matches_single_device():
    mesh = make_mesh(data=2, model=4)
    rng = np.random.default_rng(0)
    d, B, T, L = 16, 8, 3, 5
    table_rows = [40, 32, 24]  # total 96, divisible by 4
    total = sum(table_rows)
    table = rng.normal(size=(total, d)).astype(np.float32)
    offsets = np.array([0, 40, 72], dtype=np.int32)
    indices = np.stack(
        [np.stack([rng.integers(0, n, size=L) for n in table_rows]) for _ in range(B)]
    ).astype(np.int32)

    expected = embedding_bag(jnp.asarray(table), jnp.asarray(offsets), jnp.asarray(indices))
    got = sharded_embedding_bag(
        jnp.asarray(table), jnp.asarray(offsets), jnp.asarray(indices), mesh, total
    )
    np.testing.assert_allclose(np.asarray(got), np.asarray(expected), rtol=1e-5, atol=1e-5)


def test_sharded_embedding_bag_requires_divisibility():
    mesh = make_mesh(data=2, model=4)
    table = jnp.zeros((10, 8))
    with pytest.raises(AssertionError):
        sharded_embedding_bag(table, jnp.zeros(1, jnp.int32), jnp.zeros((2, 1, 1), jnp.int32), mesh, 10)


@pytest.mark.parametrize("name", ["rm1", "ncf", "din", "dien"])
def test_sharded_apply_matches_single_device(name):
    cfg = zoo.get_config(name, table_scale=SCALE)
    model = get_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    batch = RecDataGenerator(cfg, seed=1).generate_batch(8)

    single = np.asarray(model.apply(params, batch))

    mesh = make_mesh(data=4, model=2)
    sp = shard_params(params, mesh)
    fn = sharded_apply(model.apply, params, mesh, has_dense=batch.dense is not None)
    dev_batch = Batch(
        dense=None if batch.dense is None else jnp.asarray(batch.dense),
        indices=jnp.asarray(batch.indices),
    )
    out = np.asarray(fn(sp, dev_batch))
    np.testing.assert_allclose(out, single, rtol=2e-4, atol=2e-5)


def test_sharded_serving_end_to_end():
    """Multi-chip serving: engine runs the hybrid-sharded model over a
    (data=4, model=2) virtual mesh through the full serving stack."""
    from deeprecsys_tpu.config import ServingConfig
    from deeprecsys_tpu.serving import run_serving

    model_cfg = zoo.get_config("rm1", table_scale=SCALE)
    mesh = make_mesh(data=4, model=2)
    cfg = ServingConfig(
        num_batches=10, nepochs=1, inference_engines=1, engine_backend="cpu",
        avg_arrival_rate_ms=0.5, batch_size_distribution="fixed",
        avg_mini_batch_size=24, max_mini_batch_size=64,
        batch_buckets=(8, 16, 32, 64), sub_task_batch_size=16,
        req_granularity=4, seed=21,
    )
    res = run_serving(model_cfg, cfg, settle_s=0.01, mesh=mesh)
    assert res.cpu_requests == 10
    assert res.num_responses == 20  # 24 -> [16, 8]
    assert np.isfinite(res.p95_ms)


def test_train_step_runs_and_reduces_loss():
    cfg = zoo.get_config("rm1", table_scale=SCALE)
    model = get_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    mesh = make_mesh(data=2, model=4)
    sp = shard_params(params, mesh)
    gen = RecDataGenerator(cfg, seed=2)
    batch = gen.generate_batch(16)
    targets = jnp.asarray(gen.generate_targets(16, round_targets=True))
    step = make_train_step(model.apply, mesh, has_dense=True, learning_rate=0.1, loss="bce")(sp)
    dev_batch = Batch(dense=jnp.asarray(batch.dense), indices=jnp.asarray(batch.indices))
    p, l0 = step(sp, dev_batch, targets)
    losses = [float(l0)]
    for _ in range(5):
        p, l = step(p, dev_batch, targets)
        losses.append(float(l))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]  # same batch: loss must drop


@pytest.mark.parametrize("quant", ["int8", "int8_rowwise"])
def test_sharded_apply_quantized_tables(quant):
    """Quantized tables over a mesh: 2-D q leaves row-shard, the 1-D scale
    leaf replicates, and the GSPMD apply matches single-device output."""
    cfg = zoo.get_config("ncf", table_scale=SCALE).replace(table_quant=quant)
    model = get_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    batch = RecDataGenerator(cfg, seed=3).generate_batch(8)

    single = np.asarray(model.apply(params, batch))

    mesh = make_mesh(data=4, model=2)
    sp = shard_params(params, mesh)
    tbl = sp["tables"]
    key2d = "qrows" if quant == "int8_rowwise" else "q"
    assert "model" in str(tbl[key2d].sharding.spec)
    if quant == "int8":
        assert tbl["scale"].sharding.spec == jax.sharding.PartitionSpec()

    fn = sharded_apply(model.apply, params, mesh, has_dense=batch.dense is not None)
    dev_batch = Batch(dense=None, indices=jnp.asarray(batch.indices))
    out = np.asarray(fn(sp, dev_batch))
    np.testing.assert_allclose(out, single, rtol=2e-4, atol=2e-5)


def test_sharded_hotcold_matches_single_device():
    """Row-sharded hot/cold lookup: per-shard cold compaction + psum
    combine matches the single-device hotcold and direct lookups."""
    from deeprecsys_tpu.ops.embedding import (
        split_hot_cold_sharded,
        embedding_bag,
    )
    from deeprecsys_tpu.parallel.sharding import sharded_embedding_bag_hotcold
    from jax.sharding import NamedSharding, PartitionSpec as P

    rng = np.random.default_rng(13)
    R, d, M = 512, 16, 4
    table_host = rng.normal(size=(R, d)).astype(np.float32)
    offsets = np.array([0, 200], dtype=np.int64)
    rows = np.array([200, 312])
    idx = rng.integers(0, rows[None, :, None], size=(8, 2, 6)).astype(np.int32)
    hot_ids = np.sort(rng.choice(R, size=48, replace=False)).astype(np.int64)

    direct = embedding_bag(jnp.asarray(table_host), jnp.asarray(offsets, jnp.int32),
                           jnp.asarray(idx))

    mesh = make_mesh(data=2, model=M)
    split = split_hot_cold_sharded(idx, offsets, hot_ids, n_shards=M,
                                   rows_per_shard=R // M)
    assert split["cold_local"].shape[0] == M
    table = jax.device_put(jnp.asarray(table_host),
                           NamedSharding(mesh, P("model", None)))
    hot_table = jax.device_put(
        jnp.take(jnp.asarray(table_host), jnp.asarray(hot_ids, jnp.int32), axis=0),
        NamedSharding(mesh, P()))
    dev_split = {
        "hot_sel": jnp.asarray(split["hot_sel"]),
        "hot_mask": jnp.asarray(split["hot_mask"]),
        "cold_local": jax.device_put(jnp.asarray(split["cold_local"]),
                                     NamedSharding(mesh, P("model", None))),
        "cold_seg": jax.device_put(jnp.asarray(split["cold_seg"]),
                                   NamedSharding(mesh, P("model", None))),
    }
    got = sharded_embedding_bag_hotcold(hot_table, table, dev_split, mesh)
    np.testing.assert_allclose(np.asarray(got), np.asarray(direct),
                               rtol=1e-5, atol=1e-5)

    # Edge: empty hot set (all cold, still sharded correctly).
    split0 = split_hot_cold_sharded(idx, offsets, np.empty(0, np.int64),
                                    n_shards=M, rows_per_shard=R // M)
    assert split0["n_cold"] == idx.size
    dev0 = {
        "hot_sel": jnp.asarray(split0["hot_sel"]),
        "hot_mask": jnp.asarray(split0["hot_mask"]),
        "cold_local": jax.device_put(jnp.asarray(split0["cold_local"]),
                                     NamedSharding(mesh, P("model", None))),
        "cold_seg": jax.device_put(jnp.asarray(split0["cold_seg"]),
                                   NamedSharding(mesh, P("model", None))),
    }
    got0 = sharded_embedding_bag_hotcold(hot_table * 0, table, dev0, mesh)
    np.testing.assert_allclose(np.asarray(got0), np.asarray(direct),
                               rtol=1e-5, atol=1e-5)


def test_hotcold_model_tp_mode_matches_base():
    """make_hotcold_model(mesh): TP serving mode — full-model output
    matches the unsharded model."""
    from deeprecsys_tpu.models.hotcold import hot_ids_from_generator, make_hotcold_model

    cfg = zoo.get_config("rm1", table_scale=SCALE)
    model = get_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    batch = RecDataGenerator(cfg, seed=2).generate_batch(8)
    want = np.asarray(model.apply(params, batch))

    mesh = make_mesh(data=1, model=4, devices=jax.devices()[:4])
    hot_ids = hot_ids_from_generator(cfg, seed=5, hot_rows=64, n_batches=2,
                                     batch_size=32)
    hc = make_hotcold_model(model, hot_ids, mesh=mesh)
    hc_params = shard_params(hc.convert_params(params), mesh)
    split = hc.prepare(batch)
    assert "cold_local" in split and split["cold_local"].shape[0] == 4

    from jax.sharding import NamedSharding, PartitionSpec as P

    dev_split = {
        "hot_sel": jnp.asarray(split["hot_sel"]),
        "hot_mask": jnp.asarray(split["hot_mask"]),
        "cold_local": jax.device_put(jnp.asarray(split["cold_local"]),
                                     NamedSharding(mesh, P("model", None))),
        "cold_seg": jax.device_put(jnp.asarray(split["cold_seg"]),
                                   NamedSharding(mesh, P("model", None))),
    }
    got = np.asarray(jax.jit(hc.apply)(hc_params, batch, dev_split))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_engine_hotcold_tp_serving_end_to_end():
    """ComputeEngine with mesh + embedding_impl=hotcold: the TP serving
    mode through the full engine loop on the virtual mesh."""
    import queue
    import time

    from deeprecsys_tpu.config import ServingConfig
    from deeprecsys_tpu.serving.engine import ComputeEngine
    from deeprecsys_tpu.serving.packets import ServiceRequest

    model_cfg = zoo.get_config("rm1", table_scale=SCALE).replace(
        embedding_impl="hotcold", hot_set_rows=64)
    cfg = ServingConfig(engine_backend="cpu", batch_buckets=(8, 16),
                        max_mini_batch_size=16)
    mesh = make_mesh(data=1, model=8)
    req_q, resp_q, ready_q = queue.Queue(), queue.Queue(), queue.Queue()
    eng = ComputeEngine(0, model_cfg, cfg, req_q, resp_q, ready_q, mesh=mesh)
    eng.start()
    got = ready_q.get(timeout=600)
    assert not isinstance(got, Exception), got
    for i, size in enumerate([5, 12]):
        req_q.put(ServiceRequest(batch_id=i, epoch=0, arrival_time=time.time(),
                                 batch_size=size, total_sub_batches=1))
    seen = [resp_q.get(timeout=120) for _ in range(2)]
    assert sorted(r.batch_size for r in seen) == [5, 12]
    req_q.put(None)


def test_hybrid_hotcold_matches_single_device():
    """Full data x model hybrid hot/cold: per-(data,table)-shard cold
    cells + psum combine match the direct lookup."""
    from deeprecsys_tpu.ops.embedding import embedding_bag, split_hot_cold_hybrid
    from deeprecsys_tpu.parallel.sharding import hybrid_embedding_bag_hotcold
    from jax.sharding import NamedSharding, PartitionSpec as P

    rng = np.random.default_rng(17)
    R, d, D, M = 512, 16, 2, 4
    table_host = rng.normal(size=(R, d)).astype(np.float32)
    offsets = np.array([0, 200], dtype=np.int64)
    rows = np.array([200, 312])
    idx = rng.integers(0, rows[None, :, None], size=(8, 2, 6)).astype(np.int32)
    hot_ids = np.sort(rng.choice(R, size=48, replace=False)).astype(np.int64)

    direct = embedding_bag(jnp.asarray(table_host), jnp.asarray(offsets, jnp.int32),
                           jnp.asarray(idx))

    mesh = make_mesh(data=D, model=M)
    split = split_hot_cold_hybrid(idx, offsets, hot_ids, n_data=D, n_model=M,
                                  rows_per_shard=R // M)
    assert split["cold_local"].shape[:2] == (D, M)
    table = jax.device_put(jnp.asarray(table_host),
                           NamedSharding(mesh, P("model", None)))
    hot_table = jax.device_put(
        jnp.take(jnp.asarray(table_host), jnp.asarray(hot_ids, jnp.int32), axis=0),
        NamedSharding(mesh, P()))
    dev = {"hot_sel": jax.device_put(jnp.asarray(split["hot_sel"]),
                                     NamedSharding(mesh, P("data", None, None))),
           "hot_mask": jax.device_put(jnp.asarray(split["hot_mask"]),
                                      NamedSharding(mesh, P("data", None, None))),
           "cold_local": jax.device_put(jnp.asarray(split["cold_local"]),
                                        NamedSharding(mesh, P("data", "model", None))),
           "cold_seg": jax.device_put(jnp.asarray(split["cold_seg"]),
                                      NamedSharding(mesh, P("data", "model", None)))}
    got = jax.jit(lambda h, t, s: hybrid_embedding_bag_hotcold(h, t, s, mesh))(
        hot_table, table, dev)
    np.testing.assert_allclose(np.asarray(got), np.asarray(direct),
                               rtol=1e-5, atol=1e-5)


def test_engine_hotcold_hybrid_serving_end_to_end():
    """ComputeEngine + hotcold on the full (data=2, model=4) mesh."""
    import queue
    import time

    from deeprecsys_tpu.config import ServingConfig
    from deeprecsys_tpu.serving.engine import ComputeEngine
    from deeprecsys_tpu.serving.packets import ServiceRequest

    model_cfg = zoo.get_config("rm1", table_scale=SCALE).replace(
        embedding_impl="hotcold", hot_set_rows=64)
    cfg = ServingConfig(engine_backend="cpu", batch_buckets=(8, 16),
                        max_mini_batch_size=16)
    mesh = make_mesh(data=2, model=4)
    req_q, resp_q, ready_q = queue.Queue(), queue.Queue(), queue.Queue()
    eng = ComputeEngine(0, model_cfg, cfg, req_q, resp_q, ready_q, mesh=mesh)
    eng.start()
    got = ready_q.get(timeout=600)
    assert not isinstance(got, Exception), got
    for i, size in enumerate([6, 14]):
        req_q.put(ServiceRequest(batch_id=i, epoch=0, arrival_time=time.time(),
                                 batch_size=size, total_sub_batches=1))
    seen = [resp_q.get(timeout=120) for _ in range(2)]
    assert sorted(r.batch_size for r in seen) == [6, 14]
    req_q.put(None)


@pytest.mark.parametrize("quant", ["int8", "int8_rowwise"])
@pytest.mark.parametrize("axes", [(1, 4), (2, 2)])
def test_mesh_hotcold_quantized_matches_plain(quant, axes):
    """Quantized tables compose with mesh hotcold (TP and hybrid): output
    equals the plain quantized single-device model."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from deeprecsys_tpu.models.hotcold import hot_ids_from_generator, make_hotcold_model

    data_ax, model_ax = axes
    cfg = zoo.get_config("rm1", table_scale=SCALE).replace(table_quant=quant)
    model = get_model(cfg)
    params = model.init(jax.random.PRNGKey(1))
    batch = RecDataGenerator(cfg, seed=6).generate_batch(8)
    want = np.asarray(model.apply(params, batch))

    mesh = make_mesh(data=data_ax, model=model_ax,
                     devices=jax.devices()[: data_ax * model_ax])
    hot_ids = hot_ids_from_generator(cfg, seed=5, hot_rows=48, n_batches=2,
                                     batch_size=32)
    hc = make_hotcold_model(model, hot_ids, mesh=mesh)
    hc_params = shard_params(hc.convert_params(params), mesh)
    split = hc.prepare(batch)

    hybrid = data_ax > 1
    hot = P("data", None, None) if hybrid else P()
    cold = P("data", "model", None) if hybrid else P("model", None)
    dev = {}
    for k, v in split.items():
        if k == "n_cold":
            continue
        spec = hot if k in ("hot_sel", "hot_mask") else cold
        dev[k] = jax.device_put(jnp.asarray(v), NamedSharding(mesh, spec))
    got = np.asarray(jax.jit(hc.apply)(hc_params, batch, dev))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("layout", ["packed", "q_packed"])
@pytest.mark.parametrize("axes", [(1, 4), (2, 2)])
def test_mesh_hotcold_packed_matches_plain(layout, axes):
    """Row-packed tables compose with mesh hotcold (TP and hybrid): the
    cold table shards over its PHYSICAL rows and shard-local logical ids
    resolve with the //pack select; output equals the plain single-device
    model with the same layout."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from deeprecsys_tpu.models.hotcold import hot_ids_from_generator, make_hotcold_model

    data_ax, model_ax = axes
    quant = "int8" if layout == "q_packed" else "none"
    cfg = zoo.get_config("rm1", table_scale=SCALE).replace(
        table_quant=quant, table_pack=2)
    model = get_model(cfg)
    params = model.init(jax.random.PRNGKey(1))
    assert layout in params["tables"]
    batch = RecDataGenerator(cfg, seed=6).generate_batch(8)
    want = np.asarray(model.apply(params, batch))

    mesh = make_mesh(data=data_ax, model=model_ax,
                     devices=jax.devices()[: data_ax * model_ax])
    hot_ids = hot_ids_from_generator(cfg, seed=5, hot_rows=48, n_batches=2,
                                     batch_size=32)
    hc = make_hotcold_model(model, hot_ids, mesh=mesh)
    hc_params = shard_params(hc.convert_params(params), mesh)
    assert layout in hc_params["tables"]  # stayed packed (shards align)
    split = hc.prepare(batch)

    hybrid = data_ax > 1
    hot = P("data", None, None) if hybrid else P()
    cold = P("data", "model", None) if hybrid else P("model", None)
    dev = {}
    for k, v in split.items():
        if k == "n_cold":
            continue
        spec = hot if k in ("hot_sel", "hot_mask") else cold
        dev[k] = jax.device_put(jnp.asarray(v), NamedSharding(mesh, spec))
    got = np.asarray(jax.jit(hc.apply)(hc_params, batch, dev))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_mesh_hotcold_packed_misaligned_falls_back_unpacked():
    """rows_per_shard not divisible by the pack factor: conversion warns
    and serves the cold table unpacked (correctness preserved)."""
    from deeprecsys_tpu.models.hotcold import hot_ids_from_generator, make_hotcold_model

    cfg = zoo.get_config("rm1", table_scale=SCALE).replace(table_pack=3)
    model = get_model(cfg)
    params = model.init(jax.random.PRNGKey(1))
    batch = RecDataGenerator(cfg, seed=6).generate_batch(8)
    want = np.asarray(model.apply(params, batch))

    mesh = make_mesh(data=1, model=8)
    assert (cfg.total_rows // 8) % 3 != 0
    hot_ids = hot_ids_from_generator(cfg, seed=5, hot_rows=48, n_batches=2,
                                     batch_size=32)
    hc = make_hotcold_model(model, hot_ids, mesh=mesh)
    with pytest.warns(UserWarning, match="unpacked"):
        conv = hc.convert_params(params)
    assert not isinstance(conv["tables"], dict)  # unpacked float array
    from jax.sharding import NamedSharding, PartitionSpec as P

    hc_params = shard_params(conv, mesh)
    split = hc.prepare(batch)
    dev = {}
    for k, v in split.items():
        if k == "n_cold":
            continue
        spec = P() if k in ("hot_sel", "hot_mask") else P("model", None)
        dev[k] = jax.device_put(jnp.asarray(v), NamedSharding(mesh, spec))
    got = np.asarray(jax.jit(hc.apply)(hc_params, batch, dev))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_descriptor_wall_scaling_counters():
    """The round-1 scaling claim, checked by code: on a
    production-shaped workload the per-chip cold-gather DESCRIPTOR count
    (real slots in the splitter output — each is one HBM row fetch the
    owning chip issues) divides by the model axis, and per-chip batch
    work (local pooling segments) divides by the data axis.
    """
    from deeprecsys_tpu.models.hotcold import hot_ids_from_generator
    from deeprecsys_tpu.ops.embedding import (
        split_hot_cold_hybrid,
        split_hot_cold_sharded,
    )

    cfg = zoo.get_config("rm1", table_scale=SCALE)
    B, T = 64, cfg.num_tables
    total = int(cfg.total_rows)
    offsets = np.asarray(cfg.table_offsets)
    idx = np.asarray(RecDataGenerator(cfg, seed=3).generate_batch(B).indices)
    hot_ids = hot_ids_from_generator(cfg, seed=5, hot_rows=256, n_batches=2,
                                     batch_size=64)

    # Row-sharded (pure TP): per-shard descriptors ~ n_cold / M.
    per_m = {}
    for M in (1, 2, 4, 8):
        assert total % M == 0
        s = split_hot_cold_sharded(idx, offsets, hot_ids, n_shards=M,
                                   rows_per_shard=total // M)
        counts = (s["cold_seg"] != B * T).sum(axis=-1)  # real slots/chip
        assert counts.shape == (M,) and counts.sum() == s["n_cold"]
        # balanced partition: the busiest chip carries ~1/M of the wall
        assert counts.max() <= np.ceil(s["n_cold"] / M) * 1.3
        per_m[M] = int(counts.max())
    assert per_m[2] <= per_m[1] * 0.65    # halving the wall actually halves
    assert per_m[8] <= per_m[1] * 0.17    # ... and 8 chips carry ~1/8 each

    # Hybrid (data x model): descriptors divide by D*M, and each chip's
    # pooling-segment space is the LOCAL batch slice (B/D groups x T).
    for D, M in ((1, 8), (2, 4), (4, 2), (8, 1)):
        s = split_hot_cold_hybrid(idx, offsets, hot_ids, n_data=D, n_model=M,
                                  rows_per_shard=total // M)
        pad_seg = (B // D) * T
        counts = (s["cold_seg"] != pad_seg).sum(axis=-1)
        assert counts.shape == (D, M) and counts.sum() == s["n_cold"]
        assert counts.max() <= np.ceil(s["n_cold"] / (D * M)) * 1.4
        real = s["cold_seg"][s["cold_seg"] != pad_seg]
        assert real.size == 0 or real.max() < pad_seg  # local segment space


@pytest.mark.parametrize("M", [2, 8])
def test_sharded_hotcold_executes_at_mesh_sizes(M):
    """The divide-by-M claim holds where it executes: the row-sharded
    hot/cold path produces the exact pooled result on 2- and 8-way model
    meshes (4-way is covered above)."""
    from deeprecsys_tpu.ops.embedding import embedding_bag, split_hot_cold_sharded
    from deeprecsys_tpu.parallel.sharding import sharded_embedding_bag_hotcold
    from jax.sharding import NamedSharding, PartitionSpec as P

    rng = np.random.default_rng(M)
    R, d = 512, 16
    table_host = rng.normal(size=(R, d)).astype(np.float32)
    offsets = np.array([0, 200], dtype=np.int64)
    idx = rng.integers(0, np.array([200, 312])[None, :, None],
                       size=(8, 2, 6)).astype(np.int32)
    hot_ids = np.sort(rng.choice(R, size=48, replace=False)).astype(np.int64)

    direct = embedding_bag(jnp.asarray(table_host),
                           jnp.asarray(offsets, jnp.int32), jnp.asarray(idx))
    mesh = make_mesh(data=8 // M, model=M)
    split = split_hot_cold_sharded(idx, offsets, hot_ids, n_shards=M,
                                   rows_per_shard=R // M)
    table = jax.device_put(jnp.asarray(table_host),
                           NamedSharding(mesh, P("model", None)))
    hot_table = jax.device_put(
        jnp.take(jnp.asarray(table_host), jnp.asarray(hot_ids, jnp.int32), axis=0),
        NamedSharding(mesh, P()))
    dev_split = {
        "hot_sel": jnp.asarray(split["hot_sel"]),
        "hot_mask": jnp.asarray(split["hot_mask"]),
        "cold_local": jax.device_put(jnp.asarray(split["cold_local"]),
                                     NamedSharding(mesh, P("model", None))),
        "cold_seg": jax.device_put(jnp.asarray(split["cold_seg"]),
                                   NamedSharding(mesh, P("model", None))),
    }
    got = sharded_embedding_bag_hotcold(hot_table, table, dev_split, mesh)
    np.testing.assert_allclose(np.asarray(got), np.asarray(direct),
                               rtol=1e-5, atol=1e-5)


def test_mesh_bench_tool_records_artifact(tmp_path, monkeypatch):
    """tools/mesh_bench.py: the turnkey --mesh DxM run
    executes the full hybrid-sharded judged-style measurement on the
    virtual mesh and records per-chip splitter descriptor counters that
    obey the divide-by-(D*M) law."""
    import json
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parent.parent / "tools"))
    import mesh_bench

    out = tmp_path / "mesh_scaling.json"
    monkeypatch.setattr(mesh_bench, "OUT", out)
    mesh_bench.main(["--mesh", "2x4", "--models", "rm1", "--batch", "16",
                     "--iters", "4", "--table-scale", "20000"])
    rec = json.loads(out.read_text())["2x4:cpu"]
    assert rec["virtual"] is True and rec["devices"] == 8
    r = rec["results"]["rm1"]
    assert r["latency_ms"] > 0 and r["samples_per_s"] > 0
    c = rec["descriptor_counters"]["rm1"]
    # Every recorded factorization keeps the busiest chip near the ideal
    # n_cold/(D*M) share — the recorded form of the scaling law.
    for key, v in c.items():
        d, m = (int(x) for x in key.split("x"))
        assert v["max_chip_descriptors"] <= max(v["ideal_per_chip"] * 1.5, 8)
        flat = [x for row in v["per_chip_descriptors"] for x in
                (row if isinstance(row, list) else [row])]
        assert sum(flat) == v["n_cold_total"]
        assert len(flat) == d * m


def test_payload_scores_through_mesh_engine():
    """Client-feature (payload) requests through a hybrid-sharded mesh
    engine: the assembled batch shards over "data", tables over "model",
    and the returned scores match the single-device forward."""
    import queue
    import time

    import jax
    import numpy as np

    from deeprecsys_tpu import zoo
    from deeprecsys_tpu.config import ServingConfig
    from deeprecsys_tpu.models import get_model
    from deeprecsys_tpu.models.base import Batch
    from deeprecsys_tpu.serving.engine import ComputeEngine
    from deeprecsys_tpu.serving.packets import ServiceRequest

    model_cfg = zoo.get_config("rm1", table_scale=SCALE)
    cfg = ServingConfig(engine_backend="cpu", batch_buckets=(8,),
                        max_mini_batch_size=8)
    mesh = make_mesh(data=2, model=4)
    rows = np.asarray(model_cfg.scaled_rows, dtype=np.int64)
    rng = np.random.default_rng(13)
    T, L = model_cfg.num_tables, model_cfg.num_indices_per_lookup
    idx = rng.integers(0, rows[None, :, None], size=(8, T, L)).astype(np.int32)
    dense = rng.normal(size=(8, model_cfg.dense_dim)).astype(np.float32)

    req_q, resp_q, ready_q = queue.Queue(), queue.Queue(), queue.Queue()
    eng = ComputeEngine(0, model_cfg, cfg, req_q, resp_q, ready_q, mesh=mesh)
    eng.start()
    assert not isinstance(ready_q.get(timeout=600), Exception)
    req_q.put(ServiceRequest(batch_id=0, arrival_time=time.time(),
                             batch_size=8,
                             payload=Batch(dense=dense, indices=idx)))
    r = resp_q.get(timeout=120)
    assert r.error_code == 0 and r.scores is not None

    model = get_model(model_cfg)
    want = np.asarray(model.apply(
        model.init(jax.random.PRNGKey(0)),
        Batch(dense=jax.numpy.asarray(dense),
              indices=jax.numpy.asarray(idx))), dtype=np.float32)
    np.testing.assert_allclose(r.scores, want, rtol=2e-4, atol=1e-5)
    req_q.put(None)
    eng.join(timeout=30)


@pytest.mark.parametrize("axes", [(1, 8), (2, 4)])
def test_mesh_hotcold_adaptive_refresh_recovers_from_drift(axes):
    """Adaptive hot-set refresh on MESH engines (round-3 gap: the sharded
    paths warned and ignored hotcold_refresh_interval, so on the topology
    where the split matters most the drift story didn't apply). The swap
    routes through the sharded hot-table rebuild program compiled ONCE at
    setup (id list traced, shape refresh-invariant), so a runtime refresh
    runs zero serve-loop compiles — asserted via the jit cache sizes.
    Covers pure-TP (1, 8) and hybrid (2, 4) meshes."""
    import queue
    import time

    from deeprecsys_tpu.config import ServingConfig
    from deeprecsys_tpu.serving.engine import ComputeEngine
    from deeprecsys_tpu.serving.packets import ServiceRequest

    # ncf at ts=500: (280, 280, 56, 56) rows — total 672 divides both
    # mesh shapes, and every table keeps cold rows after the 64-row hot
    # budget (a drifted head must be makeable from currently-cold rows).
    model_cfg = zoo.get_config("ncf", table_scale=500).replace(
        embedding_impl="hotcold", hot_set_rows=64)
    cfg = ServingConfig(engine_backend="cpu", batch_buckets=(8,),
                        max_mini_batch_size=8, sub_task_batch_size=8,
                        hotcold_refresh_interval=4,
                        hotcold_refresh_window=8,
                        hotcold_refresh_margin=0.05)
    mesh = make_mesh(data=axes[0], model=axes[1])
    req_q, resp_q, ready_q = queue.Queue(), queue.Queue(), queue.Queue()
    eng = ComputeEngine(0, model_cfg, cfg, req_q, resp_q, ready_q, mesh=mesh)
    eng.start()
    got = ready_q.get(timeout=600)
    assert not isinstance(got, Exception), got
    try:
        assert eng._hotcold is not None
        assert eng._mesh_hot_rebuild is not None  # compiled at setup
        rebuild_cache = eng._mesh_hot_rebuild._cache_size()
        direct_cache = eng._direct_fn._cache_size()
        assert rebuild_cache >= 1 and direct_cache >= 1

        offsets = model_cfg.table_offsets
        rows = model_cfg.scaled_rows
        hot = set(int(i) for i in eng._hotcold.hot_ids)
        pools = []
        for off, r in zip(offsets, rows):
            cold_local = [i for i in range(r) if (int(off) + i) not in hot][:6]
            assert len(cold_local) == 6
            pools.append(cold_local)
        T, L = model_cfg.num_tables, model_cfg.num_indices_per_lookup

        def drift_batch(seed):
            rng = np.random.default_rng(seed)
            return np.stack([rng.choice(pools[t], size=(8, L))
                             for t in range(T)], axis=1).astype(np.int32)

        def predict(idx, bid):
            req_q.put(ServiceRequest(
                batch_id=bid, arrival_time=time.time(), batch_size=8,
                payload=Batch(dense=None, indices=idx)))
            r = resp_q.get(timeout=300)
            assert r.error_code == 0 and r.scores is not None
            return np.asarray(r.scores, np.float32)

        bid = 0
        # interval=4: the 4th request submits the worker scan; the swap
        # applies on the next tracked request's poll (async default).
        for i in range(8):
            predict(drift_batch(i), bid)
            bid += 1
            if eng.hot_refreshes:
                break
        assert eng.hot_refreshes == 1, "mesh refresh never fired"
        assert eng.hot_coverage > 0.9  # re-baselined on the drifted head
        # Zero serve-loop compiles: the rebuild and apply programs were
        # all compiled at setup; the swap added none.
        assert eng._mesh_hot_rebuild._cache_size() == rebuild_cache

        # Correctness through the swap: scores == the direct model on the
        # same seed-0 weights (the engine's init seed).
        idx = drift_batch(99)
        got_scores = predict(idx, bid)
        bid += 1
        direct = get_model(model_cfg.replace(embedding_impl="xla"))
        want = np.asarray(direct.apply(
            direct.init(jax.random.PRNGKey(0)),
            Batch(dense=None, indices=jnp.asarray(idx))), np.float32)
        np.testing.assert_allclose(got_scores, want, rtol=2e-4, atol=1e-5)

        # Stream loses its head -> split DISABLES; serving continues on
        # the pre-warmed sharded direct program (no new compile).
        def uniform_batch(seed):
            rng = np.random.default_rng(1000 + seed)
            return np.stack(
                [rng.integers(0, rows[t], size=(8, L)) for t in range(T)],
                axis=1).astype(np.int32)

        for i in range(32):
            predict(uniform_batch(i), bid)
            bid += 1
            if not eng._hotcold_active:
                break
        assert not eng._hotcold_active, "uniform stream must disable"
        idx = uniform_batch(99)
        got_scores = predict(idx, bid)
        bid += 1
        want = np.asarray(direct.apply(
            direct.init(jax.random.PRNGKey(0)),
            Batch(dense=None, indices=jnp.asarray(idx))), np.float32)
        np.testing.assert_allclose(got_scores, want, rtol=2e-4, atol=1e-5)
        assert eng._direct_fn._cache_size() == direct_cache

        # Head returns -> re-enable (mesh upgrade path).
        for i in range(64):
            predict(drift_batch(200 + i), bid)
            bid += 1
            if eng._hotcold_active:
                break
        assert eng._hotcold_active, "returning head must re-enable"
        assert eng._mesh_hot_rebuild._cache_size() == rebuild_cache
    finally:
        req_q.put(None)
        eng.join(timeout=60)


@pytest.mark.parametrize("impl,axes", [("xla", (2, 4)), ("hotcold", (1, 4)),
                                       ("hotcold", (2, 4))])
def test_ragged_payload_through_mesh_engine(impl, axes):
    """Ragged real inference on MESH engines (the two
    configurations accept_ragged used to refuse). Direct mesh engines
    shard the slot mask over "data" like the indices it masks; hotcold
    mesh engines consume the mask in the host splitter (per-shard cold
    partitions carry only VALID lookups) and run a mask-free device
    program. Scores must equal the single-device masked forward."""
    import queue
    import time

    from deeprecsys_tpu.config import ServingConfig
    from deeprecsys_tpu.serving.engine import ComputeEngine
    from deeprecsys_tpu.serving.packets import ServiceRequest

    model_cfg = zoo.get_config("rm1", table_scale=SCALE)
    if impl == "hotcold":
        model_cfg = model_cfg.replace(embedding_impl="hotcold",
                                      hot_set_rows=64)
    cfg = ServingConfig(engine_backend="cpu", batch_buckets=(8,),
                        max_mini_batch_size=8, accept_ragged=True)
    mesh = make_mesh(data=axes[0], model=axes[1],
                     devices=jax.devices()[: axes[0] * axes[1]])
    rows = np.asarray(model_cfg.scaled_rows, dtype=np.int64)
    rng = np.random.default_rng(17)
    T, L = model_cfg.num_tables, model_cfg.num_indices_per_lookup
    idx = rng.integers(0, rows[None, :, None], size=(8, T, L)).astype(np.int32)
    dense = rng.normal(size=(8, model_cfg.dense_dim)).astype(np.float32)
    lengths = rng.integers(0, L + 1, size=(8, T))  # includes empty groups
    mask = np.arange(L)[None, None, :] < lengths[:, :, None]

    req_q, resp_q, ready_q = queue.Queue(), queue.Queue(), queue.Queue()
    eng = ComputeEngine(0, model_cfg, cfg, req_q, resp_q, ready_q, mesh=mesh)
    eng.start()
    got = ready_q.get(timeout=600)
    assert not isinstance(got, Exception), got
    try:
        if impl == "hotcold":
            assert eng._hotcold is not None  # the split actually ran
        req_q.put(ServiceRequest(batch_id=0, arrival_time=time.time(),
                                 batch_size=8,
                                 payload=Batch(dense=dense, indices=idx,
                                               mask=mask)))
        r = resp_q.get(timeout=300)
        assert r.error_code == 0 and r.scores is not None

        direct = get_model(model_cfg.replace(embedding_impl="xla"))
        want = np.asarray(direct.apply(
            direct.init(jax.random.PRNGKey(0)),
            Batch(dense=jnp.asarray(dense), indices=jnp.asarray(idx),
                  mask=jnp.asarray(mask))), dtype=np.float32)
        np.testing.assert_allclose(r.scores, want, rtol=2e-4, atol=1e-5)
    finally:
        req_q.put(None)
        eng.join(timeout=60)
