"""Common model substrate.

Every model family is a pair of pure functions over the same batch layout:

    init(key, cfg)            -> params (pytree of jnp arrays)
    apply(params, batch, cfg) -> scores (B, out_dim)

with ``Batch = (dense (B, dense_dim) float or None, indices (B, T, L) int32)``.

This replaces the reference's per-model Caffe2 graph-builder classes
(``*_Wrapper`` / ``*_Net`` in ``models/*.py``): a static Caffe2 graph with
BlobsQueue feeding maps naturally onto a jitted pure function whose inputs
are pushed by the serving layer (see ``deeprecsys_tpu/serving/engine.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from deeprecsys_tpu.config import ModelConfig


class Batch(NamedTuple):
    """One inference batch in the fused-table layout (see ops/embedding.py).

    ``mask`` carries RAGGED pooling lengths (the reference's
    lengths+indices CSR form, ``dlrm_s_caffe2.py`` lengths queues): slot
    (b, t, l) contributes to the pooled sum iff mask[b, t, l]. None =
    every group is full (all 8 shipped configs set
    ``num_indices_per_lookup_fixed: true``, and the reference's own
    random generator always emits fixed-size groups,
    dlrm_data_caffe2.py:100-113 — so None is the fast default and masked
    programs compile only where ragged input is actually enabled)."""

    dense: Optional[jax.Array]  # (B, dense_dim) float, or None
    indices: jax.Array          # (B, T, L) int32, per-table-local ids
    mask: Optional[jax.Array] = None  # (B, T, L) bool, or None (= all true)


class ModelFns(NamedTuple):
    name: str
    init: Callable[[jax.Array], dict]
    apply: Callable[[dict, Batch], jax.Array]
    cfg: ModelConfig
    # Forward from pooled embeddings — the split point that lets training
    # treat the fused table sparsely (see train.py).
    apply_from_pooled: Callable = None


def stacked_mlp_init(key: jax.Array, num: int, dims, dtype=jnp.float32,
                     sum_fanin: int = 1) -> list[dict]:
    """Init ``num`` independent same-shape MLPs as stacked (num, ...) arrays.

    Used for DIN's per-behavior-table attention MLPs (the reference builds a
    separate Caffe2 FC chain per table, ``din.py:246-285``) and MT-WnD's task
    heads — stacking lets one einsum/vmap evaluate all of them as one
    batched matmul instead of hundreds of small ops.

    ``sum_fanin`` > 1: the caller SUMS the ``num`` stacked outputs
    downstream (DIN's final Sum over ~250 attention units, din.py:282-284)
    — the last layer's init is divided by sqrt(sum_fanin) so the summed
    feature enters the next MLP at O(1) variance. Without it the summed
    pathway is ~sqrt(250)x hotter than its concat siblings at init
    (measured: din's initial bce loss 4.5 vs log 2, and the planted-signal
    holdout AUC reaches 0.75 by step 1200 scaled vs 0.60 unscaled — the
    same inference-only-reference init trap as ops/rnn.py).
    The reference's own init can't see this: it never trains. MT-WnD's
    heads are independent outputs (no sum), so it keeps sum_fanin=1.
    """
    params = []
    keys = jax.random.split(key, max(len(dims) - 1, 1))
    for i in range(1, len(dims)):
        n, m = dims[i - 1], dims[i]
        kw, kb = jax.random.split(keys[i - 1])
        w = jax.random.normal(kw, (num, n, m), dtype=jnp.float32) * jnp.sqrt(2.0 / (m + n))
        b = jax.random.normal(kb, (num, m), dtype=jnp.float32) * jnp.sqrt(1.0 / m)
        if sum_fanin > 1 and i == len(dims) - 1:
            scale = 1.0 / jnp.sqrt(float(sum_fanin))
            w = w * scale
            b = b * scale
        params.append({"w": w.astype(dtype), "b": b.astype(dtype)})
    return params


def stacked_mlp_apply(params, x: jax.Array, sigmoid_layer: int = -1) -> jax.Array:
    """Apply stacked MLPs: x (B, num, n) -> (B, num, out).

    ``sigmoid_layer`` follows the reference's 1-based convention
    (see ops/mlp.py).
    """
    out_dtype = x.dtype
    for i, layer in enumerate(params, start=1):
        y = jnp.einsum("btn,tnm->btm", x, layer["w"], preferred_element_type=jnp.float32)
        y = y + layer["b"][None, :, :].astype(jnp.float32)
        y = jax.nn.sigmoid(y) if i == sigmoid_layer else jax.nn.relu(y)
        x = y.astype(out_dtype)
    return x


def init_tables(key: jax.Array, cfg: ModelConfig):
    """Initialize the fused embedding array per the config's quantization."""
    from deeprecsys_tpu.ops import init_fused_tables
    from deeprecsys_tpu.ops.embedding import (
        init_fused_tables_int8,
        init_fused_tables_int8_rowwise,
    )

    if cfg.table_quant == "int8":
        return init_fused_tables_int8(key, cfg.scaled_rows,
                                      cfg.sparse_feature_size,
                                      pack=cfg.resolved_table_pack)
    if cfg.table_quant == "int8_rowwise":
        return {"qrows": init_fused_tables_int8_rowwise(
            key, cfg.scaled_rows, cfg.sparse_feature_size)}
    pack = cfg.resolved_table_pack
    if pack > 1:
        return {"packed": init_fused_tables(
            key, cfg.scaled_rows, cfg.sparse_feature_size,
            param_dtype_of(cfg), pack=pack)}
    return init_fused_tables(key, cfg.scaled_rows, cfg.sparse_feature_size,
                             param_dtype_of(cfg))


def pooled_lookup(tables, batch: Batch, cfg: ModelConfig) -> jax.Array:
    """The model-facing fused pooled lookup: (B, T, d) in compute dtype,
    dispatching on implementation (cfg.embedding_impl) and quantization
    (dict-typed tables = int8 + per-table scales)."""
    from deeprecsys_tpu.ops import embedding_bag

    offsets = jnp.asarray(cfg.table_offsets)
    cdt = compute_dtype_of(cfg)
    if cfg.embedding_impl == "hotcold":
        # The hot/cold split needs the host-side splitter in the loop
        # (models/hotcold.py) — the serving engines wire it up. Falling
        # through to the plain gather here (for ANY table quantization —
        # hotcold composes with int8/int8_rowwise) would silently
        # benchmark the wrong thing in standalone/training paths.
        raise ValueError(
            "embedding_impl='hotcold' is a serving-engine path (use --queue/"
            "--serve, or models.hotcold.make_hotcold_model directly); the "
            "plain apply would silently run the xla gather instead")
    if cfg.embedding_impl not in ("xla", "auto"):
        # "auto" is a SERVING-time decision (the engine samples its stream
        # at warm-up); off-engine the direct gather is the right choice,
        # not an error; anything else is a typo. Raising beats silently
        # benchmarking xla.
        raise ValueError(f"unknown embedding_impl {cfg.embedding_impl!r} "
                         "(valid: 'xla', 'hotcold', 'auto')")
    mask = batch.mask  # ragged pooling lengths; None = full groups
    if isinstance(tables, dict) and "packed" in tables:
        from deeprecsys_tpu.ops.embedding import embedding_bag_packed

        # Pack factor from the ARRAY shape, not the config — loaded
        # checkpoints keep working whatever the current cfg default is.
        pack = tables["packed"].shape[1] // cfg.sparse_feature_size
        return embedding_bag_packed(tables["packed"], offsets, batch.indices,
                                    pack=pack, compute_dtype=cdt, mask=mask)
    if isinstance(tables, dict) and "q_packed" in tables:
        from deeprecsys_tpu.ops.embedding import embedding_bag_packed_int8

        pooled = embedding_bag_packed_int8(tables["q_packed"], offsets,
                                           batch.indices,
                                           d=cfg.sparse_feature_size,
                                           mask=mask)
        return (pooled.astype(jnp.float32)
                * tables["scale"][None, :, None]).astype(cdt)
    if isinstance(tables, dict) and "qrows" in tables:
        # int8 with per-row interleaved scales (trained-table fidelity).
        from deeprecsys_tpu.ops.embedding import embedding_bag_int8_rowwise

        return embedding_bag_int8_rowwise(tables["qrows"], offsets, batch.indices,
                                          compute_dtype=cdt, mask=mask)
    if isinstance(tables, dict):  # int8 symmetric, per-table scale
        # Pool in int32 (exact), dequantize once per pooled vector.
        pooled = embedding_bag(tables["q"], offsets, batch.indices,
                               compute_dtype=jnp.int32, mask=mask)
        return (pooled.astype(jnp.float32) * tables["scale"][None, :, None]).astype(cdt)
    return embedding_bag(tables, offsets, batch.indices, compute_dtype=cdt,
                         mask=mask)


def compute_dtype_of(cfg: ModelConfig):
    return jnp.dtype(cfg.compute_dtype)


def param_dtype_of(cfg: ModelConfig):
    return jnp.dtype(cfg.param_dtype)
