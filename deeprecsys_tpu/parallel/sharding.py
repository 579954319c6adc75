"""Parameter sharding and multi-chip execution.

Design (SURVEY.md §2.3):

- Embedding tables are the memory giants (rm1: ~4 GB f32), so the fused
  (total_rows, d) array is ROW-SHARDED over the mesh "model" axis: device
  k owns rows [k*R/M, (k+1)*R/M). A lookup computes masked partial pooled
  sums from locally-owned rows and combines them with ONE ``psum`` over
  the interconnect. Communication volume is (B_local, T, d) — independent
  of the pooling factor L, which makes row-sharding the right choice for
  the heavy-pooling models (rm1 L=80, rm2 L=120: up to 120x fewer bytes
  than exchanging raw rows).
- MLP towers are tiny by comparison and stay replicated; the batch is
  sharded over the "data" axis. This is classic DLRM hybrid parallelism
  (model-parallel embeddings + data-parallel MLPs) expressed as shardings
  on one jitted function, with XLA inserting the collectives.

Reference contrast: the reference's only intra-op parallelism is CPU
thread pools on SparseLengthsSum/FC (``max_num_tasks``,
``utils/utils.py:31-33``) and its only scale-out is N replicated processes
on one host.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from deeprecsys_tpu.config import ModelConfig
from deeprecsys_tpu.models.base import Batch

# Dequant plumbing shared with the single-device bags (one definition for
# all five hotcold bag variants).
from deeprecsys_tpu.ops.embedding import hotcold_quant_modes as _hotcold_quant_modes
from deeprecsys_tpu.ops.embedding import hotcold_cold_rows as _hotcold_cold_rows


# ----------------------------------------------------------------------
# Parameter / batch shardings
# ----------------------------------------------------------------------


def param_shardings(params, mesh: Mesh):
    """NamedShardings for a model's params: fused tables row-sharded over
    "model", everything else replicated.

    A table whose PHYSICAL row count does not divide the model axis
    (possible for row-packed layouts: ceil(R/pack) rows) falls back to
    replication with a warning — GSPMD refuses uneven shards, and a
    replicated odd table is correct, just unsharded. Production zoo
    configs divide cleanly at every pack (rm1 16M, rm2 16M, din 23.05M
    physical rows over <=8 shards)."""
    n_model = mesh.shape.get("model", 1)

    def spec_for(path, leaf):
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        if "tables" in keys:
            # Float tables are a (R, d) array; quantized tables are dicts
            # whose 2-D leaves ("q" int8 / "qrows" packed int8) row-shard
            # like the float path, while the 1-D per-table "scale" vector
            # is tiny and stays replicated.
            if getattr(leaf, "ndim", 2) == 2:
                if leaf.shape[0] % n_model:
                    print(f"[deeprecsys_tpu] WARNING: table with "
                          f"{leaf.shape[0]} physical rows does not divide "
                          f"the model axis ({n_model}); replicating it "
                          f"(pad rows or adjust table_pack to shard)",
                          flush=True)
                    return NamedSharding(mesh, P())
                return NamedSharding(mesh, P("model", None))
        return NamedSharding(mesh, P())

    return jax.tree_util.tree_map_with_path(spec_for, params)


def batch_shardings(mesh: Mesh, has_dense: bool):
    """Batch input shardings: everything row-shards over "data". The
    ragged slot mask shards exactly like the indices it masks; for a
    batch whose mask is None the entry is inert (None is an empty
    subtree — the sharding broadcasts over nothing)."""
    dense = NamedSharding(mesh, P("data", None)) if has_dense else None
    idx = NamedSharding(mesh, P("data", None, None))
    return Batch(dense=dense, indices=idx,
                 mask=NamedSharding(mesh, P("data", None, None)))


def shard_params(params, mesh: Mesh):
    """Place params per ``param_shardings`` (host->device with layout)."""
    return jax.device_put(params, param_shardings(params, mesh))


# ----------------------------------------------------------------------
# Row-sharded embedding lookup (shard_map building block)
# ----------------------------------------------------------------------


def shard_local_indices(indices: jax.Array, offsets: jax.Array,
                        rows_per_shard: int, axis: str = "model"):
    """Map global per-table (B, T, L) ids to THIS row shard's local rows.
    Must run inside a shard_map over ``axis``. Returns (safe, valid):
    clamped shard-local row ids and the ownership mask. Shared by the
    inference lookup (``sharded_embedding_bag``) and the trainer's
    sharded sparse-table step — one body, so a masking/index fix cannot
    diverge training from inference numerics."""
    shard_id = jax.lax.axis_index(axis)
    row_start = shard_id * rows_per_shard
    gidx = indices + offsets[None, :, None]  # fused global row ids
    lidx = gidx - row_start
    valid = (lidx >= 0) & (lidx < rows_per_shard)
    return jnp.where(valid, lidx, 0), valid


def masked_pooled_psum(table_shard: jax.Array, safe: jax.Array,
                       valid: jax.Array, *, compute_dtype=None,
                       axis: str = "model") -> jax.Array:
    """Shard-local masked gather + L-pool, completed by one psum over
    ``axis`` (non-owned rows contribute zeros). (B, T, L)-shaped safe/valid
    from ``shard_local_indices``; returns (B, T, d)."""
    B, T, L = safe.shape
    rows = jnp.take(table_shard, safe.reshape(-1), axis=0)
    if compute_dtype is not None:
        rows = rows.astype(compute_dtype)
    rows = rows.reshape(B, T, L, -1)
    rows = jnp.where(valid[..., None], rows, jnp.zeros((), rows.dtype))
    return jax.lax.psum(rows.sum(axis=2), axis)


def sharded_embedding_bag(
    table: jax.Array,
    offsets: jax.Array,
    indices: jax.Array,
    mesh: Mesh,
    total_rows: int,
    *,
    compute_dtype=None,
) -> jax.Array:
    """Pooled lookup with the table row-sharded over mesh axis "model" and
    the batch sharded over "data".

    Each chip gathers the indexed rows it owns (others contribute zeros)
    and a single ``psum`` over "model" completes the pooled sums. Returns
    (B, T, d) sharded over "data", replicated over "model".
    """
    from jax import shard_map

    n_model = mesh.shape["model"]
    assert total_rows % n_model == 0, (
        f"total rows {total_rows} must divide over model axis {n_model}; "
        "pad the last table (see pad_rows_for_mesh)"
    )
    rows_per_shard = total_rows // n_model

    def local_fn(table_shard, offsets_rep, idx_local):
        # table_shard: (rows_per_shard, d); idx_local: (B_loc, T, L) global-per-table
        safe, valid = shard_local_indices(idx_local, offsets_rep, rows_per_shard)
        return masked_pooled_psum(table_shard, safe, valid,
                                  compute_dtype=compute_dtype)

    return shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P("model", None), P(), P("data", None, None)),
        out_specs=P("data", None, None),
    )(table, offsets, indices)


def sharded_embedding_bag_hotcold(
    hot_table: jax.Array,
    table: jax.Array,
    split: dict,
    mesh: Mesh,
    *,
    compute_dtype=None,
    table_scale=None,
    rowwise: bool = False,
    pack: int = 1,
) -> jax.Array:
    """Hot/cold pooled lookup over a ROW-SHARDED table (mesh axis "model").

    The host pre-partitions the compacted cold stream by owning shard
    (``ops.embedding.split_hot_cold_sharded``), so device k gathers ONLY
    its own cold rows — the cold gather divides by the model-axis size —
    and one psum combines the per-shard cold partial sums. Hot hits
    gather from the replicated small hot table on every device
    (redundant but cheap).

    Batch is replicated (pure tensor-parallel serving mode): the cold
    stream's pooling groups span the whole batch, which is what lets the
    host partition it by row owner instead of by batch shard.

    With ``pack > 1`` the cold table is in ``pack_table`` layout sharded
    over its PHYSICAL rows; shard-local logical ids map to local physical
    rows iff rows_per_shard % pack == 0 (asserted by the caller,
    models/hotcold.py).
    """
    from jax import shard_map

    hot_sel, hot_mask = split["hot_sel"], split["hot_mask"]
    B, T, L = hot_sel.shape
    row_fn, pool_dtype, finish = _hotcold_quant_modes(
        table, table_scale, rowwise, compute_dtype)

    hot_rows = row_fn(jnp.take(hot_table, hot_sel.reshape(-1), axis=0))
    hot_rows = hot_rows * hot_mask.reshape(-1, 1).astype(pool_dtype)
    pooled_hot = hot_rows.reshape(B, T, L, -1).sum(axis=2)

    def local_fn(table_shard, cold_local, cold_seg):
        rows = _hotcold_cold_rows(table_shard, cold_local[0], row_fn,
                                  pool_dtype, pack)
        partial = jax.ops.segment_sum(rows, cold_seg[0], num_segments=B * T + 1)
        return jax.lax.psum(partial[None, : B * T], "model")

    pooled_cold = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P("model", None), P("model", None), P("model", None)),
        out_specs=P(None, None, None),
        check_vma=False,  # psum replicates; the static checker can't see it
    )(table, split["cold_local"], split["cold_seg"])[0]
    return finish(pooled_hot + pooled_cold.reshape(B, T, -1))


def hybrid_embedding_bag_hotcold(
    hot_table: jax.Array,
    table: jax.Array,
    split: dict,
    mesh: Mesh,
    *,
    compute_dtype=None,
    table_scale=None,
    rowwise: bool = False,
    pack: int = 1,
) -> jax.Array:
    """Hot/cold pooled lookup on the full HYBRID (data x model) mesh.

    The host pre-partitions the cold stream per (data shard, table shard)
    cell (``ops.embedding.split_hot_cold_hybrid``): each device gathers
    only its own cell's cold rows — cold gathers divide by the model axis
    AND the work parallelizes over the data axis — then one psum over
    "model" completes each data shard's cold partial sums. Hot hits
    gather from the replicated hot table, batch-sharded over "data"
    via GSPMD.

    Returns (B, T, d) sharded P("data", None, None).
    """
    from jax import shard_map

    hot_sel, hot_mask = split["hot_sel"], split["hot_mask"]
    B, T, L = hot_sel.shape
    n_data = mesh.shape["data"]
    b_loc = B // n_data
    row_fn, pool_dtype, finish = _hotcold_quant_modes(
        table, table_scale, rowwise, compute_dtype)

    hot_rows = row_fn(jnp.take(hot_table, hot_sel.reshape(-1), axis=0))
    hot_rows = hot_rows * hot_mask.reshape(-1, 1).astype(pool_dtype)
    pooled_hot = hot_rows.reshape(B, T, L, -1).sum(axis=2)

    def local_fn(table_shard, cold_local, cold_seg):
        # table_shard (R/M, dim); cold_local/cold_seg (1, 1, C_pad)
        rows = _hotcold_cold_rows(table_shard, cold_local[0, 0], row_fn,
                                  pool_dtype, pack)
        partial = jax.ops.segment_sum(rows, cold_seg[0, 0],
                                      num_segments=b_loc * T + 1)
        # (1, b_loc*T, dim): psum over "model" completes this data shard.
        return jax.lax.psum(partial[None, : b_loc * T], "model")

    pooled_cold = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P("model", None), P("data", "model", None),
                  P("data", "model", None)),
        out_specs=P("data", None, None),
        check_vma=False,  # psum replicates over "model"; checker can't see it
    )(table, split["cold_local"], split["cold_seg"])
    return finish(pooled_hot + pooled_cold.reshape(B, T, -1))


# ----------------------------------------------------------------------
# Table-wise sharding (placement-driven)
# ----------------------------------------------------------------------


def build_tablewise_tables(fused_table, cfg: ModelConfig, placement) -> jax.Array:
    """Rearrange the fused (total_rows, d) array into the table-wise layout
    (num_shards, rows_per_shard, d): shard s holds its placed tables
    concatenated and padded to the common row count."""
    d = fused_table.shape[1]
    offsets = cfg.table_offsets
    rows = cfg.scaled_rows
    n_real = placement.num_real_tables
    shards = []
    for group in placement.tables_per_shard:
        # Virtual pad tables (id >= n_real) contribute no rows.
        parts = [fused_table[offsets[t]: offsets[t] + rows[t]]
                 for t in group if t < n_real]
        block = (jnp.concatenate(parts, axis=0) if parts
                 else jnp.zeros((0, d), fused_table.dtype))
        pad = placement.rows_per_shard - block.shape[0]
        if pad:
            block = jnp.concatenate([block, jnp.zeros((pad, d), fused_table.dtype)])
        shards.append(block)
    return jnp.stack(shards)  # (M, rows_per_shard, d)


def tablewise_embedding_bag(
    shard_tables: jax.Array,
    indices: jax.Array,
    placement,
    mesh: Mesh,
    *,
    compute_dtype=None,
    row_transform=None,
    mask: "jax.Array | None" = None,
) -> jax.Array:
    """Pooled lookup with TABLE-WISE sharding.

    vs. row-sharding (``sharded_embedding_bag``): each device gathers ONLY
    its own tables' lookups — N/M gathered rows per device instead of N
    masked ones — and the combine is an ``all_gather`` of the per-shard
    pooled slice (B, T/M, d): M-fold less traffic than the row-sharded
    psum of the full (B, T, d). The trade is load balance, handled by the
    placement planner (``parallel/placement.py``).

    Args:
      shard_tables: (M, rows_per_shard, d), sharded P("model", None, None).
      indices: (B, T, L) per-table-local ids in ORIGINAL table order.
      placement: TablePlacement from plan_tablewise_placement.
      mask: optional (B, T, L) ragged slot mask in ORIGINAL table order
        (slot contributes iff true — Batch.mask semantics). Permuted with
        the indices; virtual pad tables mask all-false.

    Returns (B, T, d) pooled embeddings in original table order,
    sharded over "data".
    """
    from jax import shard_map

    M = placement.num_shards
    cap = len(placement.perm) // M
    perm = np.asarray(placement.perm)
    local_off = np.asarray(placement.local_offsets, dtype=np.int32).reshape(M, cap)
    n_real = placement.num_real_tables
    if len(perm) > n_real:
        # Pad virtual table slots with zero indices (they read the shard's
        # row 0 and are dropped by the inverse permutation below).
        B, _, L = indices.shape
        pad = jnp.zeros((B, len(perm) - n_real, L), indices.dtype)
        indices = jnp.concatenate([indices, pad], axis=1)
        if mask is not None:
            mask = jnp.concatenate(
                [mask, jnp.zeros((B, len(perm) - n_real, L), mask.dtype)],
                axis=1)
    idx_perm = indices[:, perm, :]
    mask_perm = None if mask is None else mask[:, perm, :]
    local_off_arr = jnp.asarray(local_off)

    def local_fn(tbl, offs, idx, *m):
        # tbl: (1, rows_per_shard, d); offs: (1, cap); idx: (B_loc, cap, L)
        B, C, L = idx.shape
        flat = (idx + offs[0][None, :, None]).reshape(-1)
        rows = jnp.take(tbl[0], flat, axis=0)
        if row_transform is not None:
            # e.g. packed-int8 per-row dequantization (pad rows are all-
            # zero, so their bitcast scale is 0.0 and they stay zero).
            rows = row_transform(rows)
        if compute_dtype is not None:
            rows = rows.astype(compute_dtype)
        if m:
            # Ragged: an invalid slot contributes NOTHING to its bag —
            # zero the row before the L-pool (same point in the pipeline
            # as every other bag variant: after dequant, before the sum).
            rows = jnp.where(m[0].reshape(-1)[:, None], rows,
                             jnp.zeros((), rows.dtype))
        pooled = rows.reshape(B, C, L, -1).sum(axis=2)  # (B_loc, cap, d)
        return jax.lax.all_gather(pooled, "model", axis=1, tiled=True)

    specs = [P("model", None, None), P("model", None), P("data", "model", None)]
    args = [shard_tables, local_off_arr, idx_perm]
    if mask_perm is not None:
        specs.append(P("data", "model", None))
        args.append(mask_perm)
    out_perm = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=tuple(specs),
        out_specs=P("data", None, None),
        # all_gather(tiled) replicates the table axis across "model"; the
        # static replication checker can't infer that, so it is disabled.
        check_vma=False,
    )(*args)
    inv = jnp.asarray(np.asarray(placement.inv_perm[: placement.num_real_tables]))
    return out_perm[:, inv, :]


def pad_rows_for_mesh(cfg: ModelConfig, n_model: int) -> int:
    """Rows of padding needed so the fused table divides over the model axis."""
    r = cfg.total_rows % n_model
    return 0 if r == 0 else n_model - r


# ----------------------------------------------------------------------
# Jitted sharded apply / train step
# ----------------------------------------------------------------------


def sharded_apply(model_apply: Callable, params, mesh: Mesh, has_dense: bool):
    """jit ``model_apply`` with hybrid shardings; XLA inserts collectives.

    The replicated-table gather inside the model becomes a partitioned
    gather under GSPMD; for explicit control of the collective pattern use
    ``sharded_embedding_bag`` directly (or ``parallel.api.
    make_tablewise_model`` for the placement-sharded variant).
    """
    in_shardings = (
        param_shardings(params, mesh),
        batch_shardings(mesh, has_dense),
    )
    out_sharding = NamedSharding(mesh, P("data", None))
    return jax.jit(model_apply, in_shardings=in_shardings, out_shardings=out_sharding)


def bce_loss(scores: jax.Array, targets: jax.Array) -> jax.Array:
    """Binary cross-entropy on sigmoid scores (reference --loss_function
    bce; training exists in the reference flags but is unused — we provide
    a full training path as a first-class capability)."""
    eps = 1e-7
    s = jnp.clip(scores.astype(jnp.float32), eps, 1.0 - eps)
    t = targets.astype(jnp.float32)
    return -jnp.mean(t * jnp.log(s) + (1.0 - t) * jnp.log(1.0 - s))


def bce_logits_loss(scores: jax.Array, targets: jax.Array) -> jax.Array:
    """Numerically stable BCE in LOGIT space, for the models whose
    reference graphs emit raw FC/ReLU scores with no sigmoid head (ncf,
    din, dien — e.g. din.py create_mlp has no sigmoid path). Probability-
    space ``bce_loss`` on those outputs is ill-defined: scores above
    1-eps hit the clip, whose VJP zeroes their gradient, and training
    silently stalls."""
    s = scores.astype(jnp.float32)
    t = targets.astype(jnp.float32)
    return jnp.mean(jnp.maximum(s, 0.0) - s * t + jnp.log1p(jnp.exp(-jnp.abs(s))))


def mse_loss(scores: jax.Array, targets: jax.Array) -> jax.Array:
    return jnp.mean((scores.astype(jnp.float32) - targets.astype(jnp.float32)) ** 2)


def loss_fn_for(loss: str, sigmoid_output: bool):
    """Resolve a user-facing loss name to the implementation matching the
    model's output space: "bce" means binary cross-entropy, computed in
    probability space for sigmoid-headed models (dlrm/wnd/mtwnd) and in
    logit space otherwise (ncf/din/dien)."""
    if loss == "mse":
        return mse_loss
    if loss == "bce":
        return bce_loss if sigmoid_output else bce_logits_loss
    raise ValueError(f"unknown loss {loss!r} (use 'bce' or 'mse')")


def make_train_step(model_apply: Callable, mesh: Mesh, has_dense: bool,
                    learning_rate: float = 0.01, loss: str = "mse",
                    sigmoid_output: bool = True):
    """Build a jitted SGD train step with hybrid shardings.

    Gradients of the fused-table gather are scatter-adds that stay local to
    each row shard; MLP grads are psum'd across "data" by XLA automatically.
    ``sigmoid_output`` tells "bce" which space the model's scores live in
    (see ``loss_fn_for``).
    """
    loss_fn = loss_fn_for(loss, sigmoid_output)

    def step(params, batch: Batch, targets):
        def objective(p):
            return loss_fn(model_apply(p, batch), targets)

        l, grads = jax.value_and_grad(objective)(params)
        new_params = jax.tree_util.tree_map(
            lambda p, g: (p - learning_rate * g.astype(p.dtype)).astype(p.dtype), params, grads
        )
        return new_params, l

    def shardings_for(params):
        ps = param_shardings(params, mesh)
        return (
            ps,
            batch_shardings(mesh, has_dense),
            NamedSharding(mesh, P("data", None)),
        ), (ps, NamedSharding(mesh, P()))

    def jitted(params):
        in_sh, out_sh = shardings_for(params)
        return jax.jit(step, in_shardings=in_sh, out_shardings=out_sh)

    return jitted
