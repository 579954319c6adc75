"""Fused multi-table pooled embedding lookup.

Reference equivalent: per-table Caffe2 ``SparseLengthsSum``
(``dlrm_s_caffe2.py:319-325`` and clones in every model file) — one C++
gather-sum op per table, parallelized with ``async_dag`` inter-op scheduling
and ``max_num_tasks`` intra-op threads.

Redesign: all of a model's tables live in ONE ``(total_rows, d)``
array with per-table row offsets, and the whole model's sparse lookup is a
SINGLE fused gather + sum over the pooling axis:

    indices (B, T, L) int32  --(+offsets)-->  rows (B*T*L, d)  --sum L-->  (B, T, d)

Why this shape:
- All eight shipped reference configs use a *fixed* pooling factor
  (``num_indices_per_lookup_fixed: true``), so the ragged CSR form of
  SparseLengthsSum collapses to a dense (B, T, L) index tensor — the
  static-shape form XLA compiles well.
- One gather instead of T (up to 254 for DIN) keeps the HLO small and gives
  XLA one large memory-bound op instead of hundreds of tiny ones.
- The fused array is also the unit of model-parallel sharding: rows are
  sharded over the mesh "model" axis (see ``deeprecsys_tpu/parallel``).

This XLA path is the default and the numerics reference; there is no
hand-written gather kernel.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def init_fused_tables(key: jax.Array, table_rows, dim: int, dtype=jnp.float32,
                      pack: int = 1) -> jax.Array:
    """Initialize the fused embedding array for a list of table sizes.

    Matches the reference per-table init distribution
    U(-sqrt(1/n), sqrt(1/n)) (``dlrm_s_caffe2.py:295-300``): one uniform
    draw over the fused array, scaled per-row by its table's bound.

    With ``pack > 1`` the array is generated DIRECTLY in the
    ``pack_table`` layout ``(ceil(R/pack), pack*dim)`` with identical
    logical values (JAX's counter-based PRNG fills row-major, so the
    packed draw is a reshape of the unpacked stream; asserted by the
    packed-vs-unpacked model parity tests). Generating packed avoids
    materializing both layouts at once, which for DIN's 46M-row table
    means extra table-sized copies in device memory.
    Tail pad rows (never addressed by any lookup) are zeroed via a zero
    scale, matching ``pack_table``'s zero padding.
    """
    table_rows = np.asarray(table_rows, dtype=np.int64)
    total = int(table_rows.sum())
    scales = np.repeat(np.sqrt(1.0 / table_rows), table_rows).astype(np.float32)
    if pack <= 1:
        u = jax.random.uniform(key, (total, dim), dtype=jnp.float32,
                               minval=-1.0, maxval=1.0)
        return (u * scales[:, None]).astype(dtype)
    Rp = -(-total // pack)
    pad = Rp * pack - total
    if pad:
        scales = np.concatenate([scales, np.zeros(pad, np.float32)])
    u = jax.random.uniform(key, (Rp, pack, dim), dtype=jnp.float32,
                           minval=-1.0, maxval=1.0)
    t = (u * jnp.asarray(scales.reshape(Rp, pack))[:, :, None]).astype(dtype)
    return t.reshape(Rp, pack * dim)


def init_fused_tables_int8(key: jax.Array, table_rows, dim: int,
                           pack: int = 1) -> dict:
    """Int8 symmetric quantized fused tables with per-table scales.

    The reference init is U(-sqrt(1/n), sqrt(1/n)) per table, so a
    per-table scale of sqrt(1/n)/127 is the exact symmetric quantizer for
    the init distribution. Returns {"q": (R, d) int8, "scale": (T,) f32},
    or with ``pack > 1`` {"q_packed": (ceil(R/pack), pack*d) int8,
    "scale"} — generated directly in the ``pack_table`` layout with
    identical logical values.
    """
    table_rows = np.asarray(table_rows, dtype=np.int64)
    total = int(table_rows.sum())
    bounds = np.sqrt(1.0 / table_rows).astype(np.float32)  # per-table max-abs
    scale = jnp.asarray(bounds / 127.0)
    # Values drawn directly on the int8 grid — identical in distribution to
    # quantizing a uniform draw with these scales.
    if pack <= 1:
        u = jax.random.randint(key, (total, dim), minval=-127, maxval=128,
                               dtype=jnp.int32)
        return {"q": u.astype(jnp.int8), "scale": scale}
    Rp = -(-total // pack)
    u = jax.random.randint(key, (Rp, pack * dim), minval=-127, maxval=128,
                           dtype=jnp.int32)
    return {"q_packed": u.astype(jnp.int8), "scale": scale}


def pack_table(table: jax.Array, pack: int) -> jax.Array:
    """Pack ``pack`` consecutive logical rows into one physical row.

    Each lookup gathers one wide physical row (``idx // p``) and a tiny
    one-hot contraction selects logical row ``idx % p``. Off by default:
    on an H100 the unpacked tables served faster (PERF.md "Row
    packing"); ROADMAP Design 2 deletes the packed variants.

    Returns ``(ceil(R/pack), pack*d)``; rows are zero-padded at the end.
    """
    if pack <= 1:
        return table
    R, d = table.shape
    Rp = -(-R // pack)
    pad = Rp * pack - R
    if pad:
        table = jnp.concatenate(
            [table, jnp.zeros((pad, d), table.dtype)], axis=0)
    return table.reshape(Rp, pack * d)


def unpack_table(table_packed: jax.Array, pack: int, total_rows: int) -> jax.Array:
    """Inverse of ``pack_table``: logical ``(total_rows, d)`` view."""
    if pack <= 1:
        return table_packed
    d = table_packed.shape[1] // pack
    return table_packed.reshape(-1, d)[:total_rows]


def select_packed_rows(table_packed: jax.Array, flat_ids: jax.Array,
                       pack: int) -> jax.Array:
    """Gather logical rows from a ``pack_table`` layout: one physical row
    per lookup (``flat // pack``), then an exact one-hot einsum selects
    logical row ``flat % pack``.

    Returns (N, d) rows widened to the exact accumulator: float tables ->
    float32, int8 tables -> int32 (int8 x one-hot-int8 accumulates in
    int32, so quantized selects stay bit-exact).
    """
    d = table_packed.shape[1] // pack
    phys = jnp.take(table_packed, flat_ids // pack, axis=0).reshape(-1, pack, d)
    if table_packed.dtype == jnp.int8:
        sel = jax.nn.one_hot(flat_ids % pack, pack, dtype=jnp.int8)
        return jnp.einsum("npd,np->nd", phys, sel,
                          preferred_element_type=jnp.int32)
    sel = jax.nn.one_hot(flat_ids % pack, pack, dtype=phys.dtype)
    return jnp.einsum("npd,np->nd", phys, sel,
                      preferred_element_type=jnp.float32)


def embedding_bag_packed(
    table_packed: jax.Array,
    offsets: jax.Array,
    indices: jax.Array,
    *,
    pack: int,
    compute_dtype=None,
    mask: "jax.Array | None" = None,
) -> jax.Array:
    """``embedding_bag`` over a ``pack_table``-packed array.

    Same contract as ``embedding_bag`` (fused (B, T, L) -> (B, T, d)
    pooled lookup, reference SparseLengthsSum semantics
    ``caffe2 sparse_lengths_sum`` as in dlrm_s_caffe2.py:321-333): the
    physical gather fetches ``flat // pack`` and a one-hot einsum in f32
    selects logical row ``flat % pack`` before the L-pool.
    """
    B, T, L = indices.shape
    d = table_packed.shape[1] // pack
    flat = (indices + offsets[None, :, None]).reshape(-1)
    rows = select_packed_rows(table_packed, flat, pack)
    cdt = compute_dtype if compute_dtype is not None else table_packed.dtype
    if jnp.issubdtype(jnp.dtype(cdt), jnp.integer) and jnp.dtype(cdt).itemsize < 4:
        # Pooling L rows of int8/int16 wraps (L up to 120 here); the int8
        # sibling (embedding_bag_packed_int8) pools in exact int32 — match
        # that instead of silently corrupting every bag.
        cdt = jnp.int32
    rows = rows.astype(cdt).reshape(B, T, L, d)
    if mask is not None:
        rows = jnp.where(mask[..., None], rows, jnp.zeros((), rows.dtype))
    return rows.sum(axis=2)


def embedding_bag_packed_int8(
    q_packed: jax.Array,
    offsets: jax.Array,
    indices: jax.Array,
    *,
    d: int,
    mask: "jax.Array | None" = None,
) -> jax.Array:
    """Pooled lookup over a packed int8 fused table: (B, T, d) in EXACT
    int32 (dequantize per table after pooling, as the unpacked int8 path
    does). ``mask``: ragged pooling — see ``embedding_bag``."""
    B, T, L = indices.shape
    pack = q_packed.shape[1] // d
    flat = (indices + offsets[None, :, None]).reshape(-1)
    rows = select_packed_rows(q_packed, flat, pack).reshape(B, T, L, d)
    if mask is not None:
        rows = rows * mask[..., None].astype(rows.dtype)
    return rows.sum(axis=2)


def quantize_rowwise_int8(table: jax.Array) -> jax.Array:
    """Pack a float table into per-ROW symmetric int8 with the scale
    interleaved into the row: (R, d) float -> (R, d+4) int8, where the last
    4 bytes are the row's float32 scale bit-pattern.

    Per-table scales (``init_fused_tables_int8``) are exact for the init
    distribution but lossy for TRAINED tables, whose row norms vary by
    orders of magnitude (hot rows get large updates). Per-row scales keep
    7-bit relative fidelity per row regardless of the norm spread.

    Interleaving (instead of a separate (R,) scale array) lets one gather
    fetch values + scale together; a second scale gather would cost a
    second random access for 4 bytes of payload. Use for trained-table
    fidelity at 4x capacity; its speed on the GPU is not yet measured.
    """
    scale = jnp.maximum(jnp.max(jnp.abs(table), axis=1), 1e-30) / 127.0  # (R,)
    q = jnp.clip(jnp.round(table / scale[:, None]), -127, 127).astype(jnp.int8)
    scale_bytes = jax.lax.bitcast_convert_type(scale.astype(jnp.float32), jnp.int8)
    return jnp.concatenate([q, scale_bytes], axis=1)


def init_fused_tables_int8_rowwise(key: jax.Array, table_rows, dim: int) -> jax.Array:
    """Row-wise packed int8 init matching the reference distribution
    (see ``init_fused_tables_int8``): values on the int8 grid, every row of
    table t carrying scale sqrt(1/n_t)/127."""
    table_rows = np.asarray(table_rows, dtype=np.int64)
    total = int(table_rows.sum())
    q = jax.random.randint(key, (total, dim), minval=-127, maxval=128,
                           dtype=jnp.int32).astype(jnp.int8)
    row_scale = np.repeat(np.sqrt(1.0 / table_rows).astype(np.float32) / 127.0, table_rows)
    scale_bytes = jax.lax.bitcast_convert_type(jnp.asarray(row_scale), jnp.int8)
    return jnp.concatenate([q, scale_bytes], axis=1)


def dequant_packed_rows(rows: jax.Array) -> jax.Array:
    """(N, d+4) packed int8 rows -> (N, d) float32: the last 4 int8 lanes
    are the row's float32 scale bit-pattern (``quantize_rowwise_int8``).
    THE single definition of the packed-row layout — every rowwise lookup
    path (single-device, hotcold, sharded, table-wise) dequantizes
    through here."""
    d = rows.shape[1] - 4
    scale = jax.lax.bitcast_convert_type(rows[:, d:], jnp.float32)
    return rows[:, :d].astype(jnp.float32) * scale[:, None]


def embedding_bag_int8_rowwise(
    packed: jax.Array,
    offsets: jax.Array,
    indices: jax.Array,
    *,
    compute_dtype=jnp.float32,
    mask: "jax.Array | None" = None,
) -> jax.Array:
    """Pooled lookup over row-wise packed int8 tables (``quantize_rowwise_int8``).

    One gather of the packed (R, d+4) rows; each row is dequantized with its
    own bitcast-recovered float32 scale BEFORE the pooling sum (rows in a bag
    have different scales, so the sum cannot stay in int32 as the per-table
    path does).
    """
    B, T, L = indices.shape
    d = packed.shape[1] - 4
    flat = (indices + offsets[None, :, None]).reshape(-1)
    rows = jnp.take(packed, flat, axis=0)  # (B*T*L, d+4) int8: one gather
    vals = dequant_packed_rows(rows).reshape(B, T, L, d)
    if mask is not None:
        vals = jnp.where(mask[..., None], vals, 0.0)
    return vals.sum(axis=2).astype(compute_dtype)


def _pad_bucket(n: int, buckets, floor: int = 1) -> int:
    """Smallest configured bucket that fits ``n`` (exact ``n`` as overflow
    fallback — an uncompiled shape, but never a wrong result); without
    buckets, the next power of two >= max(n, floor)."""
    if buckets is None:
        return max(floor, 1 << max(0, (n - 1)).bit_length())
    fitting = [b for b in sorted(buckets) if b >= n]
    return fitting[0] if fitting else n


def dedup_indices(indices: np.ndarray, offsets: np.ndarray, bucket_sizes=None):
    """Host-side batch deduplication of fused lookup ids.

    Production id streams are Zipfian: hot rows repeat across a batch
    (exactly the locality the stack-distance trace machinery models).
    Fetching each UNIQUE row once and expanding from the small unique set
    saves random reads of the full table.

    Args:
      indices: (B, T, L) int32 per-table-local ids (host numpy).
      offsets: (T,) per-table row offsets into the fused array.
      bucket_sizes: ascending unique-count buckets; the unique list is
        padded to the smallest bucket that fits so jit sees a small set of
        static shapes. Default: powers of two.

    Returns (uniq_padded (U_pad,), inv (B, T, L), n_unique) — padded slots
    repeat uniq[0] (their expanded values are never referenced).
    """
    B, T, L = indices.shape
    flat = (indices.astype(np.int64) + np.asarray(offsets, dtype=np.int64)[None, :, None]).reshape(-1)
    uniq, inv = np.unique(flat, return_inverse=True)
    n = int(uniq.size)
    u_pad = _pad_bucket(n, bucket_sizes)
    if u_pad > n:
        uniq = np.concatenate([uniq, np.full(u_pad - n, uniq[0] if n else 0)])
    return uniq.astype(np.int32), inv.reshape(B, T, L).astype(np.int32), n


def embedding_bag_dedup(
    table: jax.Array,
    uniq: jax.Array,
    inv: jax.Array,
    *,
    compute_dtype=None,
) -> jax.Array:
    """Pooled lookup over pre-deduplicated ids (see ``dedup_indices``).

    One gather of the U unique rows from the full table, then the pooling
    expansion gathers from the small (U, d) set.
    """
    B, T, L = inv.shape
    rows = jnp.take(table, uniq, axis=0)  # (U_pad, d): the only full-table gather
    if compute_dtype is not None:
        rows = rows.astype(compute_dtype)
    expanded = jnp.take(rows, inv.reshape(-1), axis=0)
    return expanded.reshape(B, T, L, -1).sum(axis=2)


def _split_hot_cold_native(indices: np.ndarray, offsets: np.ndarray,
                           hot_ids: np.ndarray,
                           slot_mask: "np.ndarray | None" = None,
                           hot_index=None):
    """Single-pass parallel C++ splitter (runtime/cpp/drs_runtime.cpp
    drs_split_hot_cold_indexed). Returns the same arrays as the numpy
    path, unpadded. ``slot_mask`` (ragged pooling): invalid slots are
    neither hot hits nor cold lookups. ``hot_index`` (a
    runtime.native.HotIndex built over the SAME hot_ids) replaces the
    per-lookup binary search with an O(1) hash probe."""
    import ctypes

    from deeprecsys_tpu.runtime.native import get_lib

    lib = get_lib()
    B, T, L = indices.shape
    n = B * T * L
    idx = np.ascontiguousarray(indices, dtype=np.int32)
    offs = np.ascontiguousarray(offsets, dtype=np.int64)
    hot = np.ascontiguousarray(hot_ids, dtype=np.int64)
    hot_sel = np.empty(n, dtype=np.int32)
    hot_mask = np.empty(n, dtype=np.uint8)
    cold_ids = np.empty(n, dtype=np.int32)
    cold_seg = np.empty(n, dtype=np.int32)
    if slot_mask is None:
        mask_ptr = None
    else:
        smask = np.ascontiguousarray(slot_mask, dtype=np.uint8)
        mask_ptr = smask.ctypes.data_as(ctypes.c_void_p)
    idx_ptr = None
    if hot_index is not None and hot_index._ptr:
        if hot_index.K != len(hot):
            raise ValueError(
                f"hot_index built over {hot_index.K} ids but split called "
                f"with {len(hot)} — stale index (rebuild on hot-set swap)")
        idx_ptr = ctypes.c_void_p(hot_index._ptr)
    n_cold = lib.drs_split_hot_cold_indexed(
        idx.ctypes.data_as(ctypes.c_void_p), n,
        offs.ctypes.data_as(ctypes.c_void_p), T, L,
        hot.ctypes.data_as(ctypes.c_void_p), len(hot),
        mask_ptr, idx_ptr,
        hot_sel.ctypes.data_as(ctypes.c_void_p),
        hot_mask.ctypes.data_as(ctypes.c_void_p),
        cold_ids.ctypes.data_as(ctypes.c_void_p),
        cold_seg.ctypes.data_as(ctypes.c_void_p),
        0,
    )
    return hot_sel, hot_mask.astype(bool), cold_ids, cold_seg, int(n_cold)


def split_hot_cold(indices: np.ndarray, offsets: np.ndarray, hot_ids: np.ndarray,
                   cold_buckets=None, impl: str = "auto", pad: bool = True,
                   slot_mask: "np.ndarray | None" = None, hot_index=None):
    """Host-side split of a batch's lookups into hot-set hits and a
    COMPACTED cold stream: a STATIC hot set serves hits from a small hot
    table, and only misses gather from the full table.

    Args:
      indices: (B, T, L) per-table-local ids (host numpy).
      offsets: (T,) fused row offsets.
      hot_ids: SORTED fused row ids of the hot set (size K).
      cold_buckets: ascending pad buckets for the cold count.
      impl: "auto" (native C++ if built, else numpy), "native", or "numpy".

    Returns dict with:
      hot_sel (B*T*L,) int32   — position in hot set (0 where cold)
      hot_mask (B*T*L,) bool   — lookup served by the hot set
      cold_ids (C_pad,) int32  — compacted cold fused ids (pad repeats [0])
      cold_seg (C_pad,) int32  — pooling-group id (b*T + t) per cold slot;
                                 pad slots point at group B*T (dropped)
      n_cold   int

    ``pad=False`` returns the compacted stream at its EXACT length
    (C = n_cold) — for the sharded/hybrid splitters, which re-pad per
    partition cell and would otherwise pay a wasted pad+slice per request.

    ``slot_mask`` ((B, T, L) bool, or None = all valid) is the RAGGED
    pooling mask (reference: variable SparseLengthsSum lengths,
    dlrm_s_caffe2.py:179-211): an invalid slot contributes NOTHING —
    it is excluded from the hot mask (the hot-side mask-pool zeros it)
    and never enters the cold stream (no wasted full-table read).

    ``hot_index`` (runtime.native.HotIndex over the SAME hot_ids, or
    None): persistent hash index replacing the native path's per-lookup
    binary search (~log2 K dependent cache misses) with ~1 miss. Built
    once per hot-set install; ignored on the numpy path. Outputs are
    bit-identical with or without it.
    """
    B, T, L = indices.shape

    use_native = impl == "native"
    if impl == "auto":
        from deeprecsys_tpu.runtime.native import native_available

        use_native = native_available()

    if use_native:
        hot_sel, hot_mask, raw_cold_ids, raw_cold_seg, n_cold = _split_hot_cold_native(
            indices, offsets, hot_ids, slot_mask=slot_mask,
            hot_index=hot_index,
        )
    else:
        flat = (indices.astype(np.int64)
                + np.asarray(offsets, dtype=np.int64)[None, :, None]).reshape(-1)
        pos = np.searchsorted(hot_ids, flat)
        pos_c = np.clip(pos, 0, len(hot_ids) - 1)
        hot_mask = hot_ids[pos_c] == flat if len(hot_ids) else np.zeros(flat.shape, bool)
        if slot_mask is not None:
            valid = np.asarray(slot_mask, dtype=bool).reshape(-1)
            hot_mask &= valid
            not_cold = hot_mask | ~valid  # invalid slots are not cold either
        else:
            not_cold = hot_mask
        hot_sel = np.where(hot_mask, pos_c, 0).astype(np.int32)
        cold_positions = np.flatnonzero(~not_cold)
        n_cold = int(cold_positions.size)
        groups = (np.arange(B * T * L) // L).astype(np.int32)
        raw_cold_ids = flat[cold_positions]
        raw_cold_seg = groups[cold_positions]

    if not pad:
        return {"hot_sel": hot_sel.reshape(B, T, L),
                "hot_mask": hot_mask.reshape(B, T, L),
                "cold_ids": np.asarray(raw_cold_ids[:n_cold], dtype=np.int32),
                "cold_seg": np.asarray(raw_cold_seg[:n_cold], dtype=np.int32),
                "n_cold": n_cold}
    c_pad = _pad_bucket(n_cold, cold_buckets)
    cold_ids = np.zeros(c_pad, dtype=np.int32)
    cold_seg = np.full(c_pad, B * T, dtype=np.int32)  # pad -> dropped segment
    cold_ids[:n_cold] = raw_cold_ids[:n_cold]
    cold_seg[:n_cold] = raw_cold_seg[:n_cold]
    return {"hot_sel": hot_sel.reshape(B, T, L), "hot_mask": hot_mask.reshape(B, T, L),
            "cold_ids": cold_ids, "cold_seg": cold_seg, "n_cold": n_cold}


def hotcold_quant_modes(table, table_scale, rowwise, compute_dtype):
    """Shared dequant plumbing for ALL hotcold bags (single-device here,
    sharded/hybrid in parallel/sharding.py).

    Returns (row_fn, pool_dtype, finish): ``row_fn`` maps gathered rows to
    poolable values, pooling runs in ``pool_dtype``, and ``finish`` maps
    the combined (B, T, d') pooled array to compute_dtype.
      - float tables: identity, cdt pooling.
      - per-table int8 (+ scale (T,)): EXACT int32 pooling on both hot and
        cold sides, one dequant after the combine.
      - packed rowwise int8: per-row interleaved-scale dequant BEFORE
        pooling (f32).
    """
    cdt = compute_dtype or (jnp.float32 if table.dtype == jnp.int8 else table.dtype)
    if rowwise:
        return dequant_packed_rows, jnp.float32, lambda pooled: pooled.astype(cdt)
    if table_scale is not None:
        return (lambda rows: rows.astype(jnp.int32), jnp.int32,
                lambda pooled: (pooled.astype(jnp.float32)
                                * table_scale[None, :, None]).astype(cdt))
    return lambda rows: rows.astype(cdt), cdt, lambda pooled: pooled


def hotcold_cold_rows(table, ids, row_fn, pool_dtype, pack: int = 1):
    """Cold-stream gather for ALL hotcold bags. With ``pack > 1`` the cold
    table is in ``pack_table`` layout: each cold lookup gathers one
    physical row and the exact one-hot select replaces ``row_fn`` (the
    widened select IS the poolable value). The
    rowwise layout interleaves scales in the row and never packs."""
    if pack <= 1:
        return row_fn(jnp.take(table, ids, axis=0))
    return select_packed_rows(table, ids, pack).astype(pool_dtype)


def _embedding_bag_hotcold_impl(hot_table, table, split, *, compute_dtype,
                                table_scale=None, rowwise=False,
                                pack: int = 1) -> jax.Array:
    """One body for the single-device hotcold bags: hot hits gather from
    the small hot table (always unpacked (K, d)-layout rows) and
    mask-pool; the compacted cold stream gathers from the full table and
    segment-sums into the (B*T, d) output (pad slots target the dropped
    segment B*T)."""
    row_fn, pool_dtype, finish = hotcold_quant_modes(
        table, table_scale, rowwise, compute_dtype)
    hot_sel, hot_mask = split["hot_sel"], split["hot_mask"]
    B, T, L = hot_sel.shape
    hot_rows = row_fn(jnp.take(hot_table, hot_sel.reshape(-1), axis=0))
    hot_rows = hot_rows * hot_mask.reshape(-1, 1).astype(pool_dtype)
    pooled_hot = hot_rows.reshape(B, T, L, -1).sum(axis=2)

    cold_rows = hotcold_cold_rows(table, split["cold_ids"], row_fn,
                                  pool_dtype, pack)
    pooled_cold = jax.ops.segment_sum(
        cold_rows, split["cold_seg"], num_segments=B * T + 1
    )[: B * T].reshape(B, T, -1)
    return finish(pooled_hot + pooled_cold)


def embedding_bag_hotcold(hot_table: jax.Array, table: jax.Array, split: dict,
                          *, compute_dtype=None, pack: int = 1) -> jax.Array:
    """Pooled lookup over a hot/cold split (see ``split_hot_cold``).

    Full-table gathers = C_pad (the cold count) instead of B*T*L; hot
    hits gather from the small (K, d) hot table; cold rows are
    segment-summed straight into the (B*T, d) pooled output. With
    ``pack > 1`` the cold ``table`` is in ``pack_table`` layout;
    ``hot_table`` stays unpacked.
    """
    return _embedding_bag_hotcold_impl(hot_table, table, split,
                                       compute_dtype=compute_dtype, pack=pack)


def quantize_pertable_int8(table: jax.Array, table_rows) -> dict:
    """Quantize a TRAINED float fused table to the per-table int8 layout
    ({"q", "scale"}, see ``init_fused_tables_int8``): scale_t = per-table
    max|value| / 127. For tables whose row norms diverge after training,
    prefer ``quantize_rowwise_int8``.

    One jitted program (segment_max over a per-row table-id vector), not a
    per-table eager loop: DIN's 254 tables would cost ~4 device dispatches
    each in the train->quantize->serve export path."""
    table_rows = np.asarray(table_rows, dtype=np.int64)
    T = len(table_rows)
    row_tid = jnp.asarray(np.repeat(np.arange(T, dtype=np.int32), table_rows))

    @functools.partial(jax.jit, static_argnums=(2,))
    def _quant(tbl, tid, num_tables):
        absmax = jax.ops.segment_max(
            jnp.max(jnp.abs(tbl.astype(jnp.float32)), axis=1), tid,
            num_segments=num_tables)
        scale = jnp.maximum(absmax, 1e-30) / 127.0
        q = jnp.clip(jnp.round(tbl.astype(jnp.float32) / scale[tid][:, None]),
                     -127, 127).astype(jnp.int8)
        return q, scale

    q, scale = _quant(table, row_tid, T)
    return {"q": q, "scale": scale}


def hot_coverage_of(indices: np.ndarray, offsets: np.ndarray,
                    hot_ids: np.ndarray,
                    mask: "np.ndarray | None" = None) -> float:
    """Fraction of a (B, T, L) lookup stream served by a SORTED fused
    hot-id set — the one definition shared by the serving engines'
    adaptive-refresh estimator and the skew/drift experiments (it used
    to exist in three near-identical copies). ``mask`` (ragged streams):
    only VALID slots count — padded slots are not lookups and would
    otherwise bias coverage toward whatever covers row 0."""
    if len(hot_ids) == 0:
        return 0.0
    hot_ids = np.asarray(hot_ids)
    flat = (np.asarray(indices).astype(np.int64)
            + np.asarray(offsets, dtype=np.int64)[None, :, None]).reshape(-1)
    if mask is not None:
        flat = flat[np.asarray(mask, dtype=bool).reshape(-1)]
        if flat.size == 0:
            return 0.0
    pos = np.clip(np.searchsorted(hot_ids, flat), 0, len(hot_ids) - 1)
    return float((hot_ids[pos] == flat).mean())


def scan_budget_subsample(arr: np.ndarray, budget: int) -> np.ndarray:
    """Uniform ROW-stride subsample of a (B, T, L) index window so the
    select_hot_ids sort-unique scan reads at most ``budget`` lookups
    (0 = unlimited). The gate the serving engines' refresh/upgrade scan
    applies (ServingConfig.hotcold_scan_budget): uncapped, a sort-unique
    over rm2's 23.6M-id window takes seconds (tools/refresh_scan_cost.py
    imports THIS function, so it always measures the shipped gate).
    Whole-row striding preserves head frequencies, so selection quality
    degrades gracefully."""
    if budget <= 0:  # 0 (and any negative, the common 'unlimited'
        return arr   # convention) = no cap — never 'scan almost nothing'
    per_row = arr.shape[1] * arr.shape[2]
    max_rows = max(budget // per_row, 2)
    if arr.shape[0] <= max_rows:
        return arr
    stride = -(-arr.shape[0] // max_rows)
    return arr[::stride]


def select_hot_ids(indices_sample: np.ndarray, offsets: np.ndarray, k: int,
                   mask: "np.ndarray | None" = None) -> np.ndarray:
    """Pick the hot set for ``split_hot_cold``: the k most frequent fused
    row ids in a representative index sample (production streams are
    Zipfian — the stack-distance locality the reference's trace machinery
    models, ``data_generator/trace_profile.py``). Returns SORTED fused ids.
    ``mask`` (ragged streams): padded slots are excluded — their index-0
    filler would otherwise count as the most popular row of every table.
    """
    if k <= 0:  # "no hot set" — [-0:] would slice EVERYTHING hot
        return np.empty(0, dtype=np.int64)
    flat = (indices_sample.astype(np.int64)
            + np.asarray(offsets, dtype=np.int64)[None, :, None]).reshape(-1)
    if mask is not None:
        flat = flat[np.asarray(mask, dtype=bool).reshape(-1)]
    uniq, counts = np.unique(flat, return_counts=True)
    if len(uniq) <= k:
        return np.sort(uniq)
    top = np.argpartition(counts, -k)[-k:]
    return np.sort(uniq[top])


def split_hot_cold_sharded(indices: np.ndarray, offsets: np.ndarray,
                           hot_ids: np.ndarray, n_shards: int,
                           rows_per_shard: int, cold_buckets=None,
                           impl: str = "auto",
                           slot_mask: "np.ndarray | None" = None,
                           hot_index=None):
    """Hot/cold split with the cold stream PARTITIONED BY OWNING SHARD for
    row-sharded tables (chip k owns fused rows [k*rows_per_shard, ...)).

    Each device then gathers only its own cold rows — the cold gather
    divides across the mesh "model" axis — while the hot table is
    replicated. Built on the native single-pass splitter; the per-
    shard partition is one stable pass over the compacted cold stream.

    Returns dict with hot_sel/hot_mask as in ``split_hot_cold`` plus:
      cold_local (M, C_pad) int32 — SHARD-LOCAL cold row ids
      cold_seg   (M, C_pad) int32 — pooling group per slot (pad -> B*T)
      n_cold     int               — total real cold lookups
    C_pad is the bucketed max over shards (uniform shapes for jit).

    Implemented as the hybrid partition at n_data=1 (one stable argsort,
    O(n log n) independent of M) — per-shard boolean masks would rescan
    the compacted stream M times per request on the serving host path.
    """
    h = split_hot_cold_hybrid(indices, offsets, hot_ids, 1, n_shards,
                              rows_per_shard, cold_buckets=cold_buckets,
                              impl=impl, slot_mask=slot_mask,
                              hot_index=hot_index)
    return {"hot_sel": h["hot_sel"], "hot_mask": h["hot_mask"],
            "cold_local": h["cold_local"][0], "cold_seg": h["cold_seg"][0],
            "n_cold": h["n_cold"]}


def split_hot_cold_hybrid(indices: np.ndarray, offsets: np.ndarray,
                          hot_ids: np.ndarray, n_data: int, n_model: int,
                          rows_per_shard: int, cold_buckets=None,
                          impl: str = "auto",
                          slot_mask: "np.ndarray | None" = None,
                          hot_index=None):
    """Hot/cold split for the HYBRID (data x model) mesh: the cold stream
    is partitioned by (data shard of the query row, owning table shard),
    so each of the D*M chips gathers only the cold rows ITS table shard
    owns for ITS batch slice — cold gathers divide by M, batch work by D.

    Data shard d owns batch rows [d*B/D, (d+1)*B/D); segment ids are LOCAL
    to the shard (b_local*T + t).

    Returns hot_sel/hot_mask (B, T, L) plus:
      cold_local (D, M, C_pad) int32 — shard-local cold row ids
      cold_seg   (D, M, C_pad) int32 — local pooling group (pad -> B/D*T)
      n_cold     int
    """
    base = split_hot_cold(indices, offsets, hot_ids, impl=impl, pad=False,
                          slot_mask=slot_mask, hot_index=hot_index)
    B, T, L = indices.shape
    assert B % n_data == 0, (B, n_data)
    b_loc = B // n_data
    n_cold = base["n_cold"]
    ids = base["cold_ids"].astype(np.int64)   # exact length (pad=False)
    segs = base["cold_seg"].astype(np.int64)  # global b*T + t
    d_of = segs // (b_loc * T)
    seg_local = segs % (b_loc * T)
    m_of = np.clip(ids // rows_per_shard, 0, n_model - 1)
    local_ids = ids - m_of * rows_per_shard

    # One stable argsort over the flat cell id partitions the stream in
    # O(n log n) independent of mesh size (this runs per request on the
    # serving host path — per-cell boolean masks would cost O(D*M*n)).
    cell = d_of * n_model + m_of
    order = np.argsort(cell, kind="stable")
    ids_sorted = local_ids[order]
    segs_sorted = seg_local[order]
    bounds = np.searchsorted(cell[order], np.arange(n_data * n_model + 1))
    counts = np.diff(bounds)
    c_max = int(counts.max()) if n_cold else 0
    c_pad = _pad_bucket(c_max, cold_buckets, floor=8)
    cold_local = np.zeros((n_data, n_model, c_pad), dtype=np.int32)
    cold_seg = np.full((n_data, n_model, c_pad), b_loc * T, dtype=np.int32)
    for c in range(n_data * n_model):
        lo, hi = bounds[c], bounds[c + 1]
        if hi > lo:
            d, m = divmod(c, n_model)
            cold_local[d, m, : hi - lo] = ids_sorted[lo:hi]
            cold_seg[d, m, : hi - lo] = segs_sorted[lo:hi]
    return {"hot_sel": base["hot_sel"], "hot_mask": base["hot_mask"],
            "cold_local": cold_local, "cold_seg": cold_seg, "n_cold": n_cold}


def embedding_bag_hotcold_int8(hot_q: jax.Array, q: jax.Array, scale: jax.Array,
                               split: dict, *, compute_dtype=jnp.float32,
                               pack: int = 1) -> jax.Array:
    """Hot/cold pooled lookup over per-TABLE int8 tables — the hot set
    (int8 rows fit 4x more of them per byte) + compacted cold stream
    composed, with EXACT int32
    pooling on both sides (per-table scales are constant within a pooling
    bag, so hot and cold partial sums dequantize with the same factor).

    Args:
      hot_q: (K, d) int8 hot rows (q[hot_ids]).
      q: (R, d) int8 fused table, or with ``pack > 1`` the
        ``init_fused_tables_int8(pack=...)`` q_packed (ceil(R/pack),
        pack*d) layout (the int8 x one-hot select is exact int32).
      scale: (T,) float32 per-table scales.
      split: from ``split_hot_cold``.
    """
    return _embedding_bag_hotcold_impl(hot_q, q, split,
                                       compute_dtype=compute_dtype,
                                       table_scale=scale, pack=pack)


def embedding_bag_hotcold_int8_rowwise(hot_packed: jax.Array, packed: jax.Array,
                                       split: dict, *,
                                       compute_dtype=jnp.float32) -> jax.Array:
    """Hot/cold pooled lookup over row-wise packed int8 tables
    (``quantize_rowwise_int8`` layout): each gathered row — hot or cold —
    dequantizes with its own interleaved scale before the pooling sum."""
    return _embedding_bag_hotcold_impl(hot_packed, packed, split,
                                       compute_dtype=compute_dtype,
                                       rowwise=True)


def embedding_bag(
    table: jax.Array,
    offsets: jax.Array,
    indices: jax.Array,
    *,
    compute_dtype=None,
    mask: "jax.Array | None" = None,
) -> jax.Array:
    """Pooled multi-table lookup.

    Args:
      table: fused ``(total_rows, d)`` embedding array.
      offsets: ``(T,)`` int32 row offset of each table.
      indices: ``(B, T, L)`` int32 per-table-local ids.
      mask: optional ``(B, T, L)`` bool — ragged pooling (the reference's
        variable SparseLengthsSum lengths): masked-out slots contribute
        zero to the pooled sum. None = all groups full.

    Returns:
      ``(B, T, d)`` pooled (summed over L) embeddings, in ``compute_dtype``
      (defaults to the table dtype).
    """
    B, T, L = indices.shape
    flat = (indices + offsets[None, :, None]).reshape(-1)
    rows = jnp.take(table, flat, axis=0, indices_are_sorted=False, unique_indices=False)
    if compute_dtype is not None:
        rows = rows.astype(compute_dtype)
    rows = rows.reshape(B, T, L, -1)
    if mask is not None:
        rows = jnp.where(mask[..., None], rows, jnp.zeros((), rows.dtype))
    return rows.sum(axis=2)
