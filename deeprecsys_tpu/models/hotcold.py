"""Hot/cold-split serving wrapper for any model family.

Takes a standard ``ModelFns`` and produces a serving variant whose sparse
lookup runs through ``ops.embedding.embedding_bag_hotcold``: a static hot
set of rows is gathered from a small (K, d) hot table, and only the
compacted cold stream gathers from the full table. Whether that pays on
a GPU, whose L2 cache already keeps hot rows of a plain gather, is not
yet measured (ROADMAP Speed 4).

The reference has no analog — Caffe2's ``SparseLengthsSum`` always gathers
from the full table.

Applicability: the win requires POPULARITY skew (Zipf head) in the id
stream, as production embedding streams have. The reference's
stack-distance trace model captures RECENCY locality instead — within a
pooling group ids are unique by construction, and its LRU rotation
round-robins line popularity — so on trace-replay streams the hit rate is
bounded by hot-set coverage of the line space (see
test_synthetic_data_plumbed_and_hotcold_hits). Measure your stream's
head mass before enabling.

Split responsibilities:
  host (per request): ``split_hot_cold`` — native C++ single-pass splitter
    (runtime/cpp/drs_runtime.cpp), overlapped with device compute by the
    engine's dispatch pipeline.
  device (jitted): hot gather from the (K, d) hot table + cold gather from
    the full table + segment-sum combine, then the model's own
    ``apply_from_pooled``.

The cold count is padded to a small geometric ladder so each batch bucket
compiles at most ``len(cold_ladder)`` programs.
"""

from __future__ import annotations

from typing import NamedTuple, Callable

import jax
import jax.numpy as jnp
import numpy as np

from deeprecsys_tpu.models.base import Batch, ModelFns
from deeprecsys_tpu.ops.embedding import (
    embedding_bag_hotcold,
    select_hot_ids,
    split_hot_cold,
)


def cold_ladder(n_lookups: int) -> tuple[int, ...]:
    """Pad buckets for the cold count: n/8, n/4, n/2, n (ascending,
    deduplicated, min 8). Four compiles per batch bucket, and the common
    50-90% hit rates land in the n/4..n/2 buckets."""
    steps = sorted({max(8, -(-n_lookups // 8)), max(8, -(-n_lookups // 4)),
                    max(8, -(-n_lookups // 2)), max(8, n_lookups)})
    return tuple(steps)


def cold_buckets_for(n_lookups: int, mesh=None) -> tuple[int, ...]:
    """Pad-bucket ladder for the cold stream, scaled to the mesh: the
    sharded splits pad PER PARTITION CELL (M cells for TP, D*M for
    hybrid), so buckets must scale by the partition count or every chip
    pads to >= n/8 and the divide-by-M cold-gather win is lost. One cap
    bucket (the per-data-shard maximum a cell can hold) guards skewed
    partitions without an uncompiled shape at runtime."""
    if mesh is None:
        return cold_ladder(n_lookups)
    n_data = mesh.shape.get("data", 1)
    parts = n_data * mesh.shape["model"]
    cap = -(-n_lookups // n_data)  # a (d, m) cell holds at most shard d's lookups
    n_cell = -(-n_lookups // parts)
    return tuple(sorted(set(cold_ladder(n_cell)) | {max(8, cap)}))


class HotColdModel(NamedTuple):
    base: ModelFns
    hot_ids: np.ndarray            # sorted fused row ids (host)
    convert_params: Callable       # params -> params + "hot_table"
    apply: Callable                # (params, batch, split) -> scores (jittable)
    prepare: Callable              # host: Batch -> split dict (padded)


def make_hotcold_model(model: ModelFns, hot_ids: np.ndarray,
                       mesh=None, hot_index=None) -> HotColdModel:
    """With ``mesh``, the variant runs row-sharded: tables over the
    "model" axis (M shards), the host partitions the cold stream by
    owning shard so each device's cold gather divides by M, the hot
    table is replicated, and one psum combines. With a "data" axis of
    1 this is the pure TP serving mode (replicated batch,
    ``split_hot_cold_sharded``); with data > 1 the HYBRID mode
    additionally partitions the cold stream per data shard
    (``split_hot_cold_hybrid`` / ``hybrid_embedding_bag_hotcold``) and
    the batch shards over "data"."""
    cfg = model.cfg
    offsets_np = np.asarray(cfg.table_offsets, dtype=np.int64)
    # Persistent native hash index over the hot set: probed by every split
    # (~1 cache miss per lookup vs the binary search's ~log2(K)). Accepted
    # prebuilt (the engine's scan WORKER builds it off the dispatch thread
    # so a refresh swap costs the serve loop nothing); built here otherwise
    # — engine setup and the sync-scan mode, neither on the hot path.
    # Closure-held, so an in-flight prepare keeps it alive across a swap.
    if hot_index is not None and hot_index.K != len(hot_ids):
        raise ValueError(
            f"prebuilt hot_index covers {hot_index.K} ids, hot set has "
            f"{len(hot_ids)}")
    if hot_index is None:
        try:
            from deeprecsys_tpu.runtime.native import HotIndex

            hot_index = HotIndex(hot_ids)
        except RuntimeError:
            pass  # native runtime unavailable: splitter degrades (numpy)
    if mesh is not None:
        n_data = mesh.shape.get("data", 1)
        n_shards = mesh.shape["model"]
        if cfg.total_rows % n_shards:
            raise ValueError(
                f"total rows {cfg.total_rows} must divide over model axis {n_shards}")
        rows_per_shard = cfg.total_rows // n_shards

    def convert_params(params):
        tables = params["tables"]
        hid = jnp.asarray(hot_ids, dtype=jnp.int32)
        out = dict(params)
        if isinstance(tables, dict) and ("packed" in tables or "q_packed" in tables):
            # Row-packed layouts (pack_table) compose with the split: the
            # cold stream gathers packed physical rows while the hot table
            # is materialized UNPACKED
            # (K, d) once at conversion (exact one-hot select; int8 via
            # int32). See ops.embedding.hotcold_cold_rows.
            from deeprecsys_tpu.ops.embedding import (
                select_packed_rows,
                unpack_table,
            )

            key = "packed" if "packed" in tables else "q_packed"
            arr = tables[key]
            pack = arr.shape[1] // cfg.sparse_feature_size
            if mesh is not None and rows_per_shard % pack:
                # Shard boundaries don't align to the pack factor, so
                # shard-local logical->physical id math would cross shards.
                # Serve unpacked instead (one-time reshape, same bytes).
                import warnings

                warnings.warn(
                    f"hotcold: rows_per_shard {rows_per_shard} not divisible "
                    f"by table_pack {pack}; serving the cold table unpacked")
                unpacked = unpack_table(arr, pack, cfg.total_rows)
                out["tables"] = (unpacked if key == "packed"
                                 else {"q": unpacked, "scale": tables["scale"]})
                hot_table = jnp.take(unpacked, hid, axis=0)
            else:
                hot_table = select_packed_rows(arr, hid, pack).astype(arr.dtype)
        elif isinstance(tables, dict):
            # Quantized tables compose with the split (int8 rows fit 4x
            # more hot set per byte); the hot table is the same
            # layout's rows gathered once at conversion time.
            key2d = "qrows" if "qrows" in tables else "q"
            hot_table = jnp.take(tables[key2d], hid, axis=0)
        else:
            hot_table = jnp.take(tables, hid, axis=0)
        out["hot_table"] = hot_table
        return out

    def prepare(batch: Batch) -> dict:
        """Host split. A RAGGED batch (``batch.mask``) composes here: the
        splitter consumes the slot mask — invalid slots are neither hot
        hits nor cold lookups — so the DEVICE program is unchanged
        (same split-dict shapes; the hot-side mask-pool and the compacted
        cold stream already carry the ragged semantics). Zero extra
        compiles for variable-length traffic on every hotcold layout."""
        idx = np.asarray(batch.indices)
        smask = None if batch.mask is None else np.asarray(batch.mask)
        B, T, L = idx.shape
        buckets = cold_buckets_for(B * T * L, mesh)
        if mesh is not None and n_data > 1:
            from deeprecsys_tpu.ops.embedding import split_hot_cold_hybrid

            return split_hot_cold_hybrid(idx, offsets_np, hot_ids, n_data,
                                         n_shards, rows_per_shard,
                                         cold_buckets=buckets,
                                         slot_mask=smask,
                                         hot_index=hot_index)
        if mesh is not None:
            from deeprecsys_tpu.ops.embedding import split_hot_cold_sharded

            return split_hot_cold_sharded(idx, offsets_np, hot_ids, n_shards,
                                          rows_per_shard,
                                          cold_buckets=buckets,
                                          slot_mask=smask,
                                          hot_index=hot_index)
        return split_hot_cold(idx, offsets_np, hot_ids, cold_buckets=buckets,
                              slot_mask=smask, hot_index=hot_index)

    def apply(params, batch: Batch, split: dict) -> jax.Array:
        from deeprecsys_tpu.models.base import compute_dtype_of
        from deeprecsys_tpu.ops.embedding import (
            embedding_bag_hotcold_int8,
            embedding_bag_hotcold_int8_rowwise,
        )

        cdt = compute_dtype_of(cfg)
        tables = params["tables"]

        def pack_of(arr):
            return arr.shape[1] // cfg.sparse_feature_size

        if mesh is not None:
            from deeprecsys_tpu.parallel.sharding import (
                hybrid_embedding_bag_hotcold,
                sharded_embedding_bag_hotcold,
            )

            bag = (hybrid_embedding_bag_hotcold if n_data > 1
                   else sharded_embedding_bag_hotcold)
            if isinstance(tables, dict) and "qrows" in tables:
                pooled = bag(params["hot_table"], tables["qrows"], split, mesh,
                             compute_dtype=cdt, rowwise=True)
            elif isinstance(tables, dict) and "packed" in tables:
                pooled = bag(params["hot_table"], tables["packed"], split, mesh,
                             compute_dtype=cdt, pack=pack_of(tables["packed"]))
            elif isinstance(tables, dict) and "q_packed" in tables:
                pooled = bag(params["hot_table"], tables["q_packed"], split,
                             mesh, compute_dtype=cdt,
                             table_scale=tables["scale"],
                             pack=pack_of(tables["q_packed"]))
            elif isinstance(tables, dict):
                pooled = bag(params["hot_table"], tables["q"], split, mesh,
                             compute_dtype=cdt, table_scale=tables["scale"])
            else:
                pooled = bag(params["hot_table"], tables, split, mesh,
                             compute_dtype=cdt)
            return model.apply_from_pooled(
                {k: v for k, v in params.items() if k != "hot_table"}, pooled, batch)
        if isinstance(tables, dict) and "qrows" in tables:
            pooled = embedding_bag_hotcold_int8_rowwise(
                params["hot_table"], tables["qrows"], split, compute_dtype=cdt)
        elif isinstance(tables, dict) and "packed" in tables:
            pooled = embedding_bag_hotcold(
                params["hot_table"], tables["packed"], split, compute_dtype=cdt,
                pack=pack_of(tables["packed"]))
        elif isinstance(tables, dict) and "q_packed" in tables:
            pooled = embedding_bag_hotcold_int8(
                params["hot_table"], tables["q_packed"], tables["scale"], split,
                compute_dtype=cdt, pack=pack_of(tables["q_packed"]))
        elif isinstance(tables, dict):
            pooled = embedding_bag_hotcold_int8(
                params["hot_table"], tables["q"], tables["scale"], split,
                compute_dtype=cdt)
        else:
            pooled = embedding_bag_hotcold(
                params["hot_table"], tables, split, compute_dtype=cdt)
        return model.apply_from_pooled(
            {k: v for k, v in params.items() if k != "hot_table"}, pooled, batch)

    return HotColdModel(base=model, hot_ids=hot_ids,
                        convert_params=convert_params, apply=apply, prepare=prepare)


def with_hot_ids(hc: HotColdModel, hot_ids: np.ndarray,
                 mesh=None, hot_index=None) -> HotColdModel:
    """The same model serving a NEW hot set, keeping the ORIGINAL
    ``apply`` callable. ``apply`` reads the hot table from params and
    never depends on the id list itself (only ``prepare``/
    ``convert_params`` do), so engines swap hot sets at runtime —
    adaptive refresh under distribution drift — without invalidating any
    compiled executable keyed on the old apply's identity. ``hot_index``:
    a HotIndex over ``hot_ids`` prebuilt off-thread (the engine's scan
    worker), so the swap itself never pays the O(K) build."""
    fresh = make_hotcold_model(hc.base, np.asarray(hot_ids), mesh=mesh,
                               hot_index=hot_index)
    return fresh._replace(apply=hc.apply)


def hot_ids_and_coverage_from_generator(
        cfg, seed: int, hot_rows: int, n_batches: int = 8,
        batch_size: int = 256, data_generation: str = "random",
        trace_file: str | None = None,
        raw_data_file: str | None = None) -> tuple[np.ndarray, float]:
    """Select the hot set by sampling the model's own data distribution
    (the serving analog of profiling a production id trace) and measure
    its COVERAGE: the fraction of the sampled lookup stream that falls in
    the hot set — the "head mass" this module's docstring tells users to
    measure before enabling hotcold (``embedding_impl="auto"`` automates
    the decision on it). Pass the engine's data_generation/trace_file so
    the sample sees the same locality the serving stream will have.

    Coverage is estimated OUT-OF-SAMPLE: the hot set is chosen on the
    first half of the sampled batches and scored on the held-out second
    half. Scoring a hot set on the stream it was selected from is
    degenerate — whenever the hot budget exceeds the number of distinct
    sampled ids (small models, short samples) the in-sample hit rate is
    exactly 1.0 even on a uniform stream whose true hit rate is near
    zero, and ``embedding_impl="auto"`` would enable hotcold on exactly
    the workloads it regresses. The RETURNED hot ids are still selected
    from the full sample (best selection for deployment); only the
    estimate uses the split."""
    from deeprecsys_tpu.data import RecDataGenerator

    gen = RecDataGenerator(cfg, seed=seed, data_generation=data_generation,
                           trace_file=trace_file, raw_data_file=raw_data_file)
    samples = [np.asarray(gen.generate_batch(batch_size).indices)
               for _ in range(n_batches)]
    sample = np.concatenate(samples, axis=0)
    offsets = np.asarray(cfg.table_offsets)
    hot_ids = select_hot_ids(sample, offsets, hot_rows)
    half = max(1, len(samples) // 2)
    select_half = np.concatenate(samples[:half], axis=0)
    holdout = np.concatenate(samples[half:], axis=0) if len(samples) > half \
        else np.empty((0,) + sample.shape[1:], dtype=sample.dtype)
    holdout_flat = (holdout.astype(np.int64)
                    + offsets.astype(np.int64)[None, :, None]).reshape(-1)
    if holdout_flat.size:
        half_hot = select_hot_ids(select_half, offsets, hot_rows)
        coverage = float(np.isin(holdout_flat, half_hot).mean())
    else:
        coverage = 0.0
    return hot_ids, coverage


def hot_ids_from_generator(cfg, seed: int, hot_rows: int, n_batches: int = 8,
                           batch_size: int = 256, data_generation: str = "random",
                           trace_file: str | None = None,
                           raw_data_file: str | None = None) -> np.ndarray:
    """``hot_ids_and_coverage_from_generator`` without the coverage."""
    return hot_ids_and_coverage_from_generator(
        cfg, seed, hot_rows, n_batches=n_batches, batch_size=batch_size,
        data_generation=data_generation, trace_file=trace_file,
        raw_data_file=raw_data_file)[0]
