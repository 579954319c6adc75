"""Synthetic input/output data generation.

Reference: ``data_generator/dlrm_data_caffe2.py`` (and its WnD clone).
Random mode (:69-124): uniform dense features; per (table, sample) a group
of ``num_indices_per_lookup`` UNIQUE indices, drawn by rejection resampling
of the whole group (``np.unique`` + redraw loop). Synthetic mode (:152-227):
per-table stack-distance trace replay via an LRU stack model (see
``deeprecsys_tpu/data/trace.py``).

Redesign: everything is vectorized to the fused (B, T, L) index
layout in one shot — the reference's quadruple Python loop
(batch x table x sample x redraw) is replaced by batched draws with a
row-masked rejection loop. Indices within a group come out sorted+unique
exactly like the reference (``np.unique`` sorts), which also improves
gather locality.

As in the reference, serving engines pre-generate batches at the maximum
batch size and slice per request (``inferenceEngine.py:200-206``).
"""

from __future__ import annotations

import numpy as np

from deeprecsys_tpu.config import ModelConfig
from deeprecsys_tpu.models.base import Batch
from deeprecsys_tpu.data import trace as trace_mod


def _unique_index_groups(rng: np.random.Generator, size: int, rows: int, L: int) -> np.ndarray:
    """Draw ``rows`` groups of ``L`` unique sorted indices in [0, size)."""
    if L == 1:
        return np.round(rng.random((rows, 1)) * (size - 1)).astype(np.int32)
    if L > size:
        raise ValueError(f"pooling factor {L} exceeds table size {size}")
    if L * (L - 1) >= size:
        # Dense fallback: random partial permutation per row. Rejection
        # would thrash here — by the birthday bound the whole-group success
        # probability is ~exp(-L(L-1)/2n). Only reachable for scaled-down
        # tables; production sizes never hit it (e.g. rm1: 80*79 << 4M).
        keys = rng.random((rows, size))
        idx = np.argpartition(keys, L - 1, axis=1)[:, :L].astype(np.int32)
        return np.sort(idx, axis=1)
    # Group-level rejection resampling, whole rows redrawn on any duplicate
    # (same semantics as the reference's while-loop, vectorized over rows).
    idx = np.round(rng.random((rows, L)) * (size - 1)).astype(np.int32)
    idx = np.sort(idx, axis=1)
    for _ in range(64):
        bad = (idx[:, 1:] == idx[:, :-1]).any(axis=1)
        n_bad = int(bad.sum())
        if n_bad == 0:
            return idx
        redraw = np.round(rng.random((n_bad, L)) * (size - 1)).astype(np.int32)
        idx[bad] = np.sort(redraw, axis=1)
    raise RuntimeError("rejection resampling failed to produce unique groups")


class RecDataGenerator:
    """Generates batches in the fused-table layout for one model config.

    Reference interface parity: ``DLRMDataGenerator(args)`` with
    ``generate_input_data()`` / ``generate_output_data()``
    (``dlrm_data_caffe2.py:34-66``).
    """

    def __init__(
        self,
        cfg: ModelConfig,
        seed: int = 123,
        data_generation: str = "random",
        trace_file: str | None = None,
        trace_enable_padding: bool = False,
        raw_data_file: str | None = None,
    ):
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)
        self.data_generation = data_generation
        self.trace_file = trace_file
        self.trace_enable_padding = trace_enable_padding
        self.raw_data_file = raw_data_file
        if data_generation not in ("random", "synthetic", "dataset"):
            raise ValueError(f"unknown data_generation {data_generation!r}")
        if data_generation == "synthetic" and trace_file is None:
            raise ValueError("synthetic mode requires a trace (distribution) file")
        if data_generation == "dataset":
            # Real-dataset mode (reference dlrm_data_caffe2.py:36-37,
            # --data_set/--raw_data_file): Criteo TSV streamed into the
            # fused layout, cycling at EOF (the reference pre-generates
            # num_batches and replays them; cycling is the streaming
            # equivalent for serving engines that draw indefinitely).
            if raw_data_file is None:
                raise ValueError("dataset mode requires --raw_data_file")
            from deeprecsys_tpu.data.criteo import CriteoReader

            self._reader = CriteoReader(raw_data_file, cfg)
            self._ds_iter = None
            self._ds_iter_bs = None
            self.last_labels: np.ndarray | None = None

    # ------------------------------------------------------------------

    def generate_batch(self, batch_size: int) -> Batch:
        cfg = self.cfg
        if self.data_generation == "dataset":
            batch, labels = self._next_dataset(batch_size)
            self.last_labels = labels
            return batch
        dense = None
        if cfg.dense_dim:
            dense = self.rng.random((batch_size, cfg.dense_dim), dtype=np.float32)
        if self.data_generation == "random":
            indices = self._random_indices(batch_size)
        else:
            indices = self._synthetic_indices(batch_size)
        return Batch(dense=dense, indices=indices)

    def generate_targets(self, batch_size: int, round_targets: bool = False) -> np.ndarray:
        """Uniform targets (reference generate_random_output_data,
        dlrm_data_caffe2.py:128-148). In dataset mode: the REAL labels of
        the batch most recently returned by ``generate_batch`` (the
        reference's dataset path reads y from the file alongside X)."""
        if self.data_generation == "dataset":
            if self.last_labels is None or len(self.last_labels) < batch_size:
                raise ValueError(
                    "dataset targets follow generate_batch: call it first "
                    "with batch_size >= the requested target count")
            return self.last_labels[:batch_size]
        t = self.rng.random((batch_size, self.cfg.out_dim), dtype=np.float32)
        if round_targets:
            t = np.round(t).astype(np.float32)
        return t

    def _next_dataset(self, batch_size: int):
        if self._ds_iter_bs != batch_size:
            self._ds_iter = None  # batch size changed: restart the stream
        for _ in range(2):
            if self._ds_iter is None:
                self._ds_iter = self._reader.batches(batch_size)
                self._ds_iter_bs = batch_size
            try:
                return next(self._ds_iter)
            except StopIteration:
                self._ds_iter = None  # EOF: cycle from the top
        raise ValueError(
            f"dataset {self.raw_data_file!r} holds fewer than "
            f"{batch_size} rows (one full batch)")

    def generate_batches(self, num_batches: int, batch_size: int) -> list[Batch]:
        return [self.generate_batch(batch_size) for _ in range(num_batches)]

    # ------------------------------------------------------------------

    def _random_indices(self, batch_size: int) -> np.ndarray:
        cfg = self.cfg
        L = cfg.num_indices_per_lookup
        out = np.empty((batch_size, cfg.num_tables, L), dtype=np.int32)
        sizes = np.asarray(cfg.scaled_rows)
        # Group identical-size tables into one batched draw (DIN has ~251
        # same-size behavior tables; this collapses them to one call).
        for size in np.unique(sizes):
            cols = np.flatnonzero(sizes == size)
            draws = _unique_index_groups(self.rng, int(size), batch_size * len(cols), L)
            out[:, cols, :] = draws.reshape(batch_size, len(cols), L)
        return out

    def _trace_state(self, t: int):
        """Per-table parsed distribution + LRU line state, loaded ONCE and
        kept across batches: the LRU stream rotates line state in place, so
        persisting it continues the stream exactly as the reference's
        pre-generate-all-batches loop does (re-reading the file per batch
        would reset the stack and re-bias the head).

        When the native runtime is built, the stream runs through the C++
        generator (runtime/cpp drs_trace_generate_lru, faster than the
        Python loop); each impl is
        deterministic under the generator seed, but their random streams
        differ from each other.
        """
        if not hasattr(self, "_trace_cache"):
            self._trace_cache = {}
            from deeprecsys_tpu.runtime.native import native_available

            self._trace_native = native_available()
        if t not in self._trace_cache:
            # Reference substitutes the table id into the trace-file name
            # ("dist_emb_j.log".replace("j", str(i))), falling back to the
            # same file for all tables when no placeholder is present.
            path = (self.trace_file.replace("@", str(t))
                    if "@" in self.trace_file else self.trace_file)
            la, sd, cdf = trace_mod.read_dist_from_file(path)
            trace_mod.validate_cdf(cdf, path)
            if la is None:
                # 2-line file (the reference's shipped profile/sd_cumm,
                # trace_generator.py:33-45): no line accesses in-file; the
                # reference bootstraps a random permutation of the table's
                # rows (trace_generator.py:70). Same here, sized to THIS
                # table.
                la = trace_mod.random_line_accesses(
                    int(self.cfg.scaled_rows[t]), rng=self.rng)
            if self._trace_native:
                self._trace_cache[t] = trace_mod.NativeLruTrace(
                    la, sd, cdf, seed=int(self.rng.integers(1 << 62)),
                    enable_padding=self.trace_enable_padding)
            else:
                # [la, sd, cdf, introduced-lines counter]: the counter
                # persists across calls exactly like the native path (see
                # trace_generate_lru's i_start note).
                self._trace_cache[t] = [la, sd, cdf, 0]
        return self._trace_cache[t]

    def _trace_refs(self, t: int, count: int) -> np.ndarray:
        state = self._trace_state(t)
        if self._trace_native:
            return state.generate(count)
        la, sd, cdf, i = state
        refs, state[3] = trace_mod.trace_generate_lru(
            la, sd, cdf, count, self.trace_enable_padding, rng=self.rng,
            i_start=i, return_i=True,
        )
        return np.asarray(refs, dtype=np.int64)

    def _synthetic_indices(self, batch_size: int) -> np.ndarray:
        cfg = self.cfg
        L = cfg.num_indices_per_lookup
        out = np.empty((batch_size, cfg.num_tables, L), dtype=np.int32)
        for t, size in enumerate(cfg.scaled_rows):
            for b in range(batch_size):
                refs = self._trace_refs(t, L)
                if refs.min(initial=0) < 0 or refs.max(initial=0) >= size:
                    refs = np.mod(refs, size)  # reference mod-guard (:207-215)
                # Dedup AFTER the mod (distinct lines can collapse to the
                # same residue) but in FIRST-OCCURRENCE draw order: the
                # sorted+unique invariant applies to the final ids, and a
                # sorted working set would make the L-truncation below keep
                # the SMALLEST ids — systematically biasing groups toward
                # low rows (and inflating hot-set coverage estimates).
                def _uniq_ordered(a):
                    _, idx = np.unique(a, return_index=True)
                    return a[np.sort(idx)]

                group = _uniq_ordered(refs)
                # Top up to fixed L if dedup shrank the group. Draws
                # double on no-progress rounds so rare tail ids of a
                # skewed trace are still found quickly; a trace with fewer
                # distinct residues than L can never satisfy the invariant
                # — fail loudly (at engine warm-up) instead of spinning
                # forever.
                stalled = 0
                draw = max(L - group.size, 1)
                while group.size < L:
                    extra = self._trace_refs(t, draw)
                    new = _uniq_ordered(
                        np.concatenate([group, np.mod(extra, size)]))
                    if new.size == group.size:
                        stalled += 1
                        draw = min(draw * 2, 4096)
                    else:
                        stalled = 0
                        draw = max(L - new.size, 1)
                    group = new
                    if stalled >= 24:
                        raise ValueError(
                            f"synthetic trace for table {t} yields only "
                            f"{group.size} distinct ids under mod {size}, "
                            f"< num_indices_per_lookup={L}; use a richer "
                            "distribution file or a smaller L")
                out[b, t, :] = np.sort(group[:L]).astype(np.int32)
        return out
