"""Configuration for models and serving.

Reference equivalents: ``utils/utils.py:15-165`` (the ~60-flag argparse CLI
with JSON config-file override) and ``models/configs/*.json``.

Design differences from the reference (deliberate):

- Typed dataclasses instead of a mutable argparse namespace threaded through
  every process.
- The DIN behavior-table expansion (reference ``utils/utils.py:132-149``)
  runs *after* the JSON merge. In the reference it runs before, so the JSON's
  ``user_behavior_tables`` only takes effect by accident of the default
  ``model_type``; SURVEY.md §5 flags this ordering. We make it explicit.
- Derived dimensions (``ln_top`` adjustment, interaction sizes) are computed
  in one place with the exact per-model semantics of the reference
  (``dlrm_s_caffe2.py:404-440``, ``wide_and_deep.py:345-350``,
  ``multi_task_wnd.py:354-362``, ``ncf.py:384-388``, ``din.py:?``,
  ``dien.py:426-434``).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Sequence

import numpy as np

MODEL_TYPES = ("dlrm", "wnd", "mtwnd", "ncf", "din", "dien")


def _parse_dims(s: str | Sequence[int]) -> tuple[int, ...]:
    if isinstance(s, str):
        return tuple(int(x) for x in s.split("-") if x != "")
    return tuple(int(x) for x in s)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture configuration for one recommendation model.

    Field semantics mirror the reference CLI flags of the same name
    (``utils/utils.py:22-35``).
    """

    model_type: str = "dlrm"
    model_name: str = "dlrm"
    # Embedding dimension shared by all tables (--arch_sparse_feature_size).
    sparse_feature_size: int = 32
    # Rows per embedding table (--arch_embedding_size, "-"-separated).
    embedding_rows: tuple[int, ...] = (4, 3, 2)
    # MLP tower layer sizes (--arch_mlp_bot / _top / _tasks).
    mlp_bot: tuple[int, ...] = (4, 3, 2)
    mlp_top: tuple[int, ...] = (4, 2, 1)
    mlp_tasks: tuple[int, ...] = (4, 2, 1)
    num_multi_tasks: int = 1
    # DIEN GRU hidden size (--hidden_size).
    hidden_size: int = 64
    # "dot" | "cat" (--arch_interaction_op); DLRM only.
    interaction_op: str = "dot"
    interaction_itself: bool = False
    # Pooling factor: ids per table per sample (--num_indices_per_lookup).
    # All shipped reference configs use fixed pooling, which maps to a dense
    # (B, T, L) index tensor — the static-shape form XLA wants.
    num_indices_per_lookup: int = 1
    # DIN: number of extra user-behavior table copies (--user_behavior_tables).
    user_behavior_tables: int = 1000
    # Parameter/compute dtypes (an addition; the reference is f32-only).
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    # Embedding lookup implementation: "xla" (the fused gather; default).
    # "hotcold" (serving only): a static hot row set gathered from a small
    # table + a compacted cold stream from the full table (models/hotcold.py).
    # "auto" (serving): sample the engine's data stream at warm-up and pick
    # hotcold iff the hot set would cover >= hotcold_min_hit of lookups
    # (standalone/training paths treat "auto" as the plain gather).
    embedding_impl: str = "xla"
    # Hot-set size for embedding_impl="hotcold" (rows in the hot table).
    # 0 = auto: sized to a byte budget by utils.memory.suggest_hot_rows
    # (int8 layouts fit 2-4x more rows in the same budget).
    hot_set_rows: int = 0
    # Minimum sampled hot-set coverage for embedding_impl="auto" to choose
    # hotcold: below it the padded cold stream plus the hot pass cost more
    # than they save. Declared default, not yet measured on the GPU
    # (ROADMAP Speed 4 derives it from the zipf cells).
    hotcold_min_hit: float = 0.75
    # Minimum FUSED-TABLE size (MB) for embedding_impl="auto" to consider
    # the hot/cold split at all: a small table's direct gather is cheap, so
    # the split's host pass cannot pay. Declared default, not yet measured
    # on the GPU (ROADMAP Speed 4). Explicit embedding_impl="hotcold"
    # bypasses this floor.
    hotcold_min_table_mb: float = 128.0
    # Embedding table quantization: "none" | "int8" (symmetric per-table
    # scale; 4x capacity vs f32) | "int8_rowwise" (per-ROW scale
    # interleaved into the packed row — trained-table fidelity; see
    # ops/embedding.py quantize_rowwise_int8). An addition.
    table_quant: str = "none"
    # Pack this many consecutive logical rows into one physical table row
    # (ops/embedding.py pack_table). 0 is an alias of 1, unpacked
    # (resolved_table_pack); only N > 1 packs. Applies to float/bf16 and
    # per-table int8; the rowwise layout never packs. An addition.
    table_pack: int = 0
    # Divide all table sizes by this factor (testing / memory-constrained runs).
    table_scale: int = 1
    # Output head for the relu-scored families (ncf/din/dien — their
    # reference graphs end in FC+ReLU with no sigmoid, din.py create_mlp):
    #   "reference" — relu scores, bit-parity with the reference graph.
    #   "logits"    — the final FC's PRE-activation. The head has no
    #                 parameters, so checkpoints serve either head.
    # Training REQUIRES the logits head (Trainer switches automatically):
    # gradient descent on bce-logits pushes negative samples' pre-
    # activations negative, relu zeroes them AND their gradients, and the
    # model collapses to constant-0 scores with loss frozen at log 2 —
    # seen on din at full scale (benchmarks/train_quality.json) and
    # reproduced at tiny scale in test_train.py. Serving a TRAINED model
    # should also use "logits": relu ties every below-zero score at 0,
    # destroying the learned ranking among negatives. Sigmoid-headed
    # families (dlrm/wnd/mtwnd) reject "logits" — their sigmoid is
    # monotone (rankings unaffected) and their training runs in
    # probability space.
    output_head: str = "reference"

    def __post_init__(self):
        if self.model_type not in MODEL_TYPES:
            raise ValueError(f"unknown model_type {self.model_type!r}; expected one of {MODEL_TYPES}")
        if self.output_head not in ("reference", "logits"):
            raise ValueError(f"unknown output_head {self.output_head!r} "
                             "(valid: 'reference', 'logits')")
        if self.output_head == "logits" and self.model_type in (
                "dlrm", "wnd", "mtwnd"):
            raise ValueError(
                f"output_head='logits' applies to the relu-scored families "
                f"(ncf/din/dien); {self.model_type} ends in a sigmoid whose "
                f"monotone scores need no logit head")
        if self.interaction_op not in ("dot", "cat"):
            raise ValueError(f"unknown interaction_op {self.interaction_op!r}")
        if self.model_type == "ncf":
            # Reference assertions: ncf.py:348-356.
            if len(self.embedding_rows) != 4:
                raise ValueError("NCF requires exactly 4 embedding tables")
            if self.num_indices_per_lookup != 1:
                raise ValueError("NCF requires 1 index per lookup")
        if self.model_type in ("din", "dien") and len(self.embedding_rows) < 4:
            # Reference assertions: din.py / dien.py:456.
            raise ValueError(f"{self.model_type} requires >= 4 embedding tables")

    # ------------------------------------------------------------------
    # Derived dimensions
    # ------------------------------------------------------------------

    @property
    def num_tables(self) -> int:
        return len(self.embedding_rows)

    @property
    def scaled_rows(self) -> tuple[int, ...]:
        if self.table_scale == 1:
            return self.embedding_rows
        return tuple(max(4, n // self.table_scale) for n in self.embedding_rows)

    @property
    def table_offsets(self) -> np.ndarray:
        """Row offset of each table inside the fused (total_rows, d) array."""
        return np.concatenate([[0], np.cumsum(self.scaled_rows)[:-1]]).astype(np.int32)

    @property
    def total_rows(self) -> int:
        return int(np.sum(self.scaled_rows))

    @property
    def fused_table_mb(self) -> float:
        """Fused embedding-table size in MB at the serving layout (the
        quantity the hotcold_min_table_mb auto floor compares against)."""
        itemsize = (1 if self.table_quant in ("int8", "int8_rowwise")
                    else 2 if self.param_dtype == "bfloat16" else 4)
        return self.total_rows * self.sparse_feature_size * itemsize / 1e6

    @property
    def resolved_table_pack(self) -> int:
        """table_pack with its alias 0 resolved to 1 (unpacked): on an
        H100 the unpacked bf16 tables served rm1, rm3 and din faster than
        two rows packed per 128 bytes (PERF.md "Row packing"). Packed
        int8 tables are unmeasured on the H100."""
        return max(1, self.table_pack)

    @property
    def dense_dim(self) -> int:
        """Width of the dense-feature input.

        DLRM: first bottom-MLP dim (``dlrm_s_caffe2.py:432``). WnD/MT-WnD:
        raw dense concat of width mlp_bot[0] (``wide_and_deep.py:345``,
        asserts a single-element mlp_bot). NCF/DIN/DIEN take no dense input
        (``ncf.py run_queues`` ignores fc; DIN/DIEN top input is sparse-only).
        """
        if self.model_type in ("dlrm", "wnd", "mtwnd"):
            return self.mlp_bot[0]
        return 0

    @property
    def num_fea(self) -> int:
        return self.num_tables + 1

    @property
    def top_in_dim(self) -> int:
        """First dim of the top MLP, per reference num_int computations."""
        m = self.sparse_feature_size
        if self.model_type == "dlrm":
            # dlrm_s_caffe2.py:404-426
            if self.interaction_op == "dot":
                f = self.num_fea
                pairs = (f * (f + 1)) // 2 if self.interaction_itself else (f * (f - 1)) // 2
                return pairs + self.mlp_bot[-1]
            return self.num_fea * self.mlp_bot[-1]
        if self.model_type in ("wnd", "mtwnd"):
            # wide_and_deep.py:345, multi_task_wnd.py:354
            return self.num_tables * m + self.mlp_bot[0]
        if self.model_type == "ncf":
            # ncf.py:384
            return 2 * m
        if self.model_type == "din":
            # din.py: top input = concat[profile, attention, ad, context]
            return 4 * m
        if self.model_type == "dien":
            # dien.py:426: hidden + 3 * m_spa
            return self.hidden_size + 3 * m
        raise AssertionError(self.model_type)

    @property
    def ln_top(self) -> tuple[int, ...]:
        return (self.top_in_dim,) + self.mlp_top

    @property
    def out_dim(self) -> int:
        if self.model_type == "mtwnd":
            return self.mlp_tasks[-1] * self.num_multi_tasks
        return self.mlp_top[-1]

    # DIN table-role helpers (din.py:295-300, dien.py:393-398).
    @property
    def behavior_table_ids(self) -> range:
        return range(1, self.num_tables - 2)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def _expand_din_tables(rows: tuple[int, ...], user_behavior_tables: int) -> tuple[int, ...]:
    """DIN behavior-table expansion (reference ``utils/utils.py:132-149``).

    [profile, behavior, ad, ctx] -> [profile] + [behavior]*(n+1) + [ad, ctx].
    The reference loop prepends ``n`` copies in front of the original
    behavior table, yielding n+1 behavior tables total.
    """
    profile, behavior, rest = rows[0], rows[1], rows[2:]
    return (profile,) + (behavior,) * (user_behavior_tables + 1) + rest


def load_model_config(path: str | Path, table_scale: int = 1, **overrides) -> ModelConfig:
    """Load a model config from a reference-format JSON file.

    Accepts the exact key set of ``models/configs/*.json`` ("arch_mlp_bot",
    "arch_embedding_size", ...). Unlike the reference, DIN expansion happens
    *after* the JSON values are applied.
    """
    with open(path) as f:
        raw = json.load(f)
    return model_config_from_dict(raw, table_scale=table_scale, **overrides)


def model_config_from_dict(raw: dict, table_scale: int = 1, **overrides) -> ModelConfig:
    key_map = {
        "arch_mlp_bot": ("mlp_bot", _parse_dims),
        "arch_mlp_top": ("mlp_top", _parse_dims),
        "arch_mlp_tasks": ("mlp_tasks", _parse_dims),
        "arch_embedding_size": ("embedding_rows", _parse_dims),
        "arch_sparse_feature_size": ("sparse_feature_size", int),
        "arch_interaction_op": ("interaction_op", str),
        "arch_interaction_itself": ("interaction_itself", bool),
        "num_indices_per_lookup": ("num_indices_per_lookup", int),
        "num_indices_per_lookup_fixed": (None, None),  # implied; dense (B,T,L)
        "model_type": ("model_type", str),
        "model_name": ("model_name", str),
        "user_behavior_tables": ("user_behavior_tables", int),
        "hidden_size": ("hidden_size", int),
        "num_multi_tasks": ("num_multi_tasks", int),
    }
    kw: dict = {}
    for key, val in raw.items():
        if key not in key_map:
            raise KeyError(f"unknown config key {key!r}")
        field, conv = key_map[key]
        if field is not None:
            kw[field] = conv(val)
    kw.update(overrides)
    kw.setdefault("table_scale", table_scale)
    cfg = ModelConfig(**kw)
    if cfg.model_type == "din" and len(cfg.embedding_rows) == 4:
        cfg = cfg.replace(
            embedding_rows=_expand_din_tables(cfg.embedding_rows, cfg.user_behavior_tables)
        )
    return cfg


# ----------------------------------------------------------------------
# Serving configuration (reference: DeepRecSys/serving flags,
# utils/utils.py:44-94)
# ----------------------------------------------------------------------


@dataclasses.dataclass
class ServingConfig:
    """Load-generation, engine and scheduler knobs.

    Mirrors the reference serving flags; times are in milliseconds as in the
    reference.
    """

    # Query stream (loadGenerator.py:14-43)
    num_batches: int = 64
    nepochs: int = 1
    avg_arrival_rate_ms: float = 10.0   # Poisson inter-arrival mean (ms)
    batch_size_distribution: str = "fixed"  # fixed|normal|lognormal|file
    avg_mini_batch_size: float = 1.0
    var_mini_batch_size: float = 1.0
    max_mini_batch_size: int = 1024
    batch_dist_file: str | None = None
    sub_task_batch_size: int = 16

    # Engines
    inference_engines: int = 1
    # accel: engine threads sharing the GPU (utils/devices.py
    # pick_accel_device); cpu: threads on the host backend; cpu-mp: one OS
    # process per engine over native shm rings (reference parity:
    # DeepRecSys.py:62-78); sim: latency-model sleep.
    engine_backend: str = "accel"
    # Static-shape batch buckets compiled ahead of time; requests are padded
    # up to the nearest bucket (static-shape analog of the reference's
    # pre-generate-at-max-then-slice, inferenceEngine.py:200-206).
    batch_buckets: tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
    # "static": use batch_buckets as-is. "auto": derive an optimal ladder
    # from the configured size distribution (serving/buckets.py) — fewer
    # compiled programs AND less padding waste than the power-of-two ladder.
    bucket_policy: str = "static"
    max_auto_buckets: int = 6

    # Tail-latency / scheduler (scheduler.py, utils.py:69-85)
    target_latency_ms: float = 10.0
    req_granularity: int = 64
    tune_batch_qps: bool = False
    tune_accel_qps: bool = False
    batch_configs: tuple[int, ...] = (32, 64, 128, 256, 512, 1024)
    accel_configs: tuple[int, ...] = (128, 256, 512)
    stable_region: float = 0.10
    min_arr_range: float = 1.0
    max_arr_range: float = 100.0
    arr_steps: int = 20
    sched_timeout: int = 100

    # Request coalescing (an addition): drain up to max_coalesce waiting
    # sub-requests and run them as ONE padded bucket execution — the
    # inverse of the reference's query splitting, which exists because
    # CPU cores want small batches; an accelerator wants large ones. Off
    # by default for reference-faithful behavior.
    coalesce_requests: bool = False
    max_coalesce: int = 8

    # Big-query offload (utils.py:90-94). Here the "accelerator" is the
    # real big-batch GPU path; the reference's is a simulated GPU.
    model_accel: bool = False
    accel_request_size_thres: int = 1024

    # Engine input data (reference --data_generation / --synthetic_data_trace_file,
    # utils/utils.py dataset group): "random" uniform ids, "synthetic"
    # stack-distance trace replay from a distribution file — the locality
    # model that makes hot/cold splits representative — or "dataset"
    # (reference --data_set/--raw_data_file, dlrm_data_caffe2.py:36-37):
    # real Criteo click logs streamed into the fused layout.
    data_generation: str = "random"
    synthetic_trace_file: str | None = None
    raw_data_file: str | None = None

    # Adaptive hot-set refresh (hotcold/auto engines, single-device):
    # engines track the LIVE hot-hit rate from the splitter's per-request
    # cold counts; every `interval` tracked requests, if the windowed
    # coverage fell more than `margin` below the reference coverage (the
    # warm-up sample's, then each refresh's), the hot set is re-derived
    # from the last `window` request batches and hot-swapped without
    # recompiling (the hot table is a same-shape param; models/hotcold.py
    # with_hot_ids). If no candidate set clears hotcold_min_hit (the
    # stream lost its head entirely), the split is DISABLED and the plain
    # gather serves — a headless split pays its host pass for nothing —
    # with the engine still watching the stream and
    # re-enabling when a head returns. 0 = off. Guards popularity DRIFT:
    # a hot set frozen at warm-up decays as the id distribution moves.
    # Scope: adaptation requires the engine to START on the hotcold path
    # (embedding_impl="hotcold", or "auto" whose warm-up chose it) — an
    # engine that began direct compiled no split programs and stays
    # direct; restart or reload to change impl.
    hotcold_refresh_interval: int = 0
    hotcold_refresh_margin: float = 0.05
    hotcold_refresh_window: int = 16
    # Cap on the LOOKUPS the refresh/upgrade candidate scan reads from
    # the buffered window (0 = unlimited). The scan (select_hot_ids =
    # sort-unique) is O(n log n) in the window: uncapped at rm2's shape
    # (16 x 512 x 3840 = 23.6M ids) it takes seconds
    # (tools/refresh_scan_cost.py measures it).
    # Capping subsamples whole rows at a uniform stride, which preserves
    # head frequencies (a 2M-lookup sample resolves a 64k-row hot set's
    # zipf head to well under the refresh margin).
    hotcold_scan_budget: int = 2_000_000
    # Run the candidate scan on a WORKER thread: even capped, an inline
    # scan stalls the dispatch thread once per window. Async, the
    # dispatch thread only submits the buffer snapshot and polls a
    # one-slot result queue per tracked request; install/disable
    # decisions stay on the serve thread. False = inline scan
    # (deterministic refresh timing for comparisons; pays the stall).
    hotcold_scan_async: bool = True

    # Accept RAGGED real-inference requests (the reference's
    # lengths+indices CSR form, dlrm_s_caffe2.py lengths queues): engines
    # additionally pre-warm a masked program per bucket (one extra
    # compile each), and /v1/predict takes "lengths" (+ optional flat
    # "values"). Off by default: all 8 shipped configs are fixed-length
    # (num_indices_per_lookup_fixed: true) and the masked twin would be
    # dead compile weight. Compute backends (accel/cpu/cpu-mp — the blob
    # arena slots size up for the mask bytes). Composes with EVERY
    # embedding_impl: the hot/cold splitter consumes the slot
    # mask on the host, mesh engines shard it over "data".
    accept_ragged: bool = False

    # cpu-mp payload transport capacity: BlobArena slots (one per
    # in-flight /v1/predict SUB-request — a query holds
    # ceil(batch/sub_task_batch_size) slots until its scores return).
    # Arena exhaustion fails the query loudly with a pointer here.
    payload_arena_slots: int = 256

    seed: int = 123
    debug_mode: bool = False
    log_file: str | None = None

    def __post_init__(self):
        if self.engine_backend not in ("accel", "cpu", "cpu-mp", "sim"):
            raise ValueError(f"unknown engine_backend {self.engine_backend!r}")
        if self.hotcold_refresh_interval > 0 and self.hotcold_refresh_window < 2:
            # The out-of-sample candidate estimator needs a selection half
            # AND a holdout half; a 1-batch window would silently make
            # every refresh/upgrade/disable decision inert.
            raise ValueError(
                f"hotcold_refresh_window must be >= 2 when refresh tracking "
                f"is on; got {self.hotcold_refresh_window}")
        if self.payload_arena_slots < 1:
            raise ValueError(
                f"payload_arena_slots must be >= 1; got "
                f"{self.payload_arena_slots}")
