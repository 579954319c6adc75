"""Inference engines.

Reference: ``inferenceEngine.py`` — one OS process per engine, two threads:
the main thread pops ``ServiceRequest``s and feeds pre-generated data
sliced to the request's batch size through Caffe2 BlobsQueues
(:191-215), while a daemon thread blocks inside the static graph on
``DequeueBlobs`` and stamps ``inference_end_time`` when the net finishes
(:26-59). ``accelInferenceEngine.py`` is a simulator: latency-table lookup
+ ``time.sleep`` (:58-64).

Redesign (the accelerator is a single shared device, so engines are
threads in one process, not processes):

- ``ComputeEngine`` keeps a jitted forward per static BATCH BUCKET
  (power-of-two-ish ladder). XLA needs static shapes, so a request of size
  s runs at bucket ceil(s): the static-shape analog of the reference's
  "pre-generate at max size then slice" (inferenceEngine.py:200-206).
  All buckets are compiled during warm-up, before the engine signals ready.
- Two-stage pipeline per engine, mirroring the reference's feed/run thread
  split: the request thread slices + dispatches (JAX dispatch is async and
  returns immediately), a completion thread blocks on the result and
  stamps ``inference_end_time``. Device compute of request k overlaps host
  work of request k+1.
- ``SimEngine`` consumes whole queries and sleeps per a ``LatencyModel``
  (the reference's accel-simulator pattern) — used for serving-layer tests
  without hardware.
"""

from __future__ import annotations

import queue
import threading
import time

try:
    from deeprecsys_tpu.runtime import Empty as ShmEmpty  # dependency-free
except Exception:  # pragma: no cover — defensive
    ShmEmpty = queue.Empty

import jax
import numpy as np

from deeprecsys_tpu.config import ModelConfig, ServingConfig
from deeprecsys_tpu.data import RecDataGenerator
from deeprecsys_tpu.models import get_model
from deeprecsys_tpu.models.base import Batch
from deeprecsys_tpu.serving.latency_model import LatencyModel
from deeprecsys_tpu.serving.packets import (
    ERR_DEADLINE,
    ERR_OVER_LADDER,
    ERR_PAYLOAD,
    ERR_READBACK,
    ERR_RELOAD,
    RELOAD_ACK_BATCH_ID,
    ServiceRequest,
    ServiceResponse,
)

_SENTINEL = None
# _hydrate's "request answered with an error, skip it" marker — distinct
# from _SENTINEL (None), which must still shut the serve loop down.
_DROPPED = object()


class ReloadHandle:
    """One scheduled zero-downtime checkpoint swap (``request_reload``).

    ``event`` is set once the engine applied (or rejected) the swap —
    which happens atomically BEFORE the next request that engine serves,
    so a request submitted after scheduling is guaranteed the new params.
    On failure ``error`` holds the exception and the engine keeps serving
    the previous params. Thread engines take handles directly via
    ``request_reload``; cpu-mp process engines receive the path over a
    per-engine control ring (ReloadFragment chunks) and ACK on the
    response ring — ``ServingServer.reload`` speaks both."""

    # engine_id/gen: set by the cpu-mp ingress so reload_status can
    # resolve handles whose engine process died before ACKing.
    __slots__ = ("path", "event", "error", "engine_id", "gen")

    def __init__(self, path: str):
        self.path = path
        self.event = threading.Event()
        self.error: Exception | None = None
        self.engine_id: int | None = None
        self.gen: int | None = None


def pick_bucket(buckets, batch_size: int) -> int:
    """Smallest compiled bucket >= batch_size (last bucket caps)."""
    for b in buckets:
        if b >= batch_size:
            return b
    return buckets[-1]


class ComputeEngine(threading.Thread):
    """A real (GPU or CPU-backend) inference engine thread."""

    def __init__(
        self,
        engine_id: int,
        model_cfg: ModelConfig,
        serving_cfg: ServingConfig,
        request_q: "queue.Queue",
        response_q: "queue.Queue",
        ready_q: "queue.Queue",
        device=None,
        params=None,
        seed: int = 0,
        mesh=None,
        buckets=None,
        strict_buckets: bool = True,
        control_q=None,
        arena=None,
    ):
        super().__init__(name=f"engine-{engine_id}", daemon=True)
        self.engine_id = engine_id
        self.model_cfg = model_cfg
        self.serving_cfg = serving_cfg
        self.request_q = request_q
        self.response_q = response_q
        self.ready_q = ready_q
        if device is None:
            from deeprecsys_tpu.utils.devices import pick_accel_device

            device = pick_accel_device()
        self.device = device
        self.params = params
        self.seed = seed
        # Multi-chip serving: with a mesh, the model runs hybrid-sharded
        # (tables row-sharded over "model", batch over "data") and buckets
        # must divide the data axis.
        self.mesh = mesh
        if buckets is None:
            # Pools pass the resolved ladder in (autotuning re-samples the
            # size distribution — doing it once per engine is N-fold waste).
            from deeprecsys_tpu.serving.buckets import resolve_buckets

            buckets = resolve_buckets(serving_cfg)
        self.buckets = tuple(
            b for b in sorted(buckets) if b <= serving_cfg.max_mini_batch_size
        ) or (serving_cfg.max_mini_batch_size,)
        if mesh is not None:
            n_data = mesh.shape["data"]
            # Every bucket must divide the data axis (hybrid hotcold
            # asserts B % n_data == 0). Round non-divisible buckets UP to
            # the next multiple — dropping them would silently serve large
            # requests at a smaller bucket via pick_bucket's cap clamp
            # (undercompute). The cap bucket may overshoot
            # max_mini_batch_size by < n_data rows: pad-only work (no
            # request exceeds max), preferable to undercomputing max-size
            # requests at a rounded-DOWN cap.
            self.buckets = tuple(sorted({-(-b // n_data) * n_data
                                         for b in self.buckets}))
        self._jitted: dict[int, callable] = {}
        self._host_data: dict[int, Batch] = {}
        self._pending: "queue.Queue" = queue.Queue()
        self._hotcold = None  # HotColdModel when the hotcold path is active
        self.hot_coverage = None  # sampled hot-set coverage (hotcold/auto)
        # Adaptive hot-set refresh (cfg.hotcold_refresh_interval > 0):
        # live hit-rate window + recent-batch buffer, serve-loop-local
        # (single writer; healthz reads the plain attributes).
        self.hot_refreshes = 0
        self.live_hot_coverage = None
        self._live_hot = 0
        self._live_total = 0
        self._refresh_buf = None
        self._tracked_since_check = 0
        self._mesh_hot_rebuild = None  # jitted sharded hot-table rebuild
        # Runtime hotcold enable/disable (bidirectional adaptation): when
        # a refresh finds the stream has LOST its popular head (candidate
        # coverage < hotcold_min_hit), the engine falls back to the plain
        # fused gather — a stale-or-headless split pays the host pass and
        # the hot gather for nothing — and keeps estimating; a returning
        # head re-enables the split.
        self._hotcold_active = True
        self._direct_fn = None
        self._upgrade_backoff = 0  # doubling skip count after failed scans
        self._upgrade_wait = 0
        # Async scan worker: the candidate derivation stalls the dispatch
        # thread for a sort-unique over the whole window even with the
        # scan budget. The dispatch thread only SUBMITS scan tasks and
        # polls the one-slot result queue per tracked request;
        # install/disable decisions stay on the serve thread (it remains
        # the only writer of _hotcold/params).
        self._scan_thread = None
        self._scan_req: "queue.Queue" = queue.Queue(maxsize=1)
        self._scan_res: "queue.Queue" = queue.Queue(maxsize=1)
        self._scan_inflight = False  # serve-thread-local (single writer)
        self._reload: ReloadHandle | None = None  # pending checkpoint swap
        self._reload_lock = threading.Lock()
        self._stopped = False  # set (under the lock) when the engine exits
        self._raw_template = None  # ShapeDtypeStruct tree of the MODEL layout
        self.error: Exception | None = None
        # Observability: executions per bucket and coalesced-request count
        # (read by /v1/healthz and post-run reports; single-writer, so a
        # plain dict is safe).
        self.bucket_counts: dict[int, int] = {}
        self.coalesced_requests = 0
        self.clamped_requests = 0
        # Over-ladder handling: strict (default for direct library
        # construction) answers with an ERR_OVER_LADDER response instead of
        # silently undercomputing at the cap bucket. Serving pools pass
        # False (their auto ladder covers the max and the ingress 400s
        # oversize batches; the clamp is counted in /v1/healthz).
        self.strict_buckets = strict_buckets
        self.rejected_requests = 0   # strict over-ladder rejections
        self.expired_requests = 0    # deadline-expired, dropped pre-dispatch
        self._clamp_warned = False
        # cpu-mp reload side channel: a per-engine ring the parent feeds
        # ReloadFragment path chunks into (the 64-byte POD request ring
        # cannot carry paths, and the shared MPMC ring cannot target one
        # engine). Applied reloads are ACKed on the response ring with
        # batch_id = RELOAD_ACK_BATCH_ID.
        self.control_q = control_q
        # cpu-mp payload transport: the shared BlobArena this engine
        # hydrates payload_slot requests from and writes scores back into
        # (runtime/blob_arena.py ownership protocol).
        self.arena = arena
        self._reload_frags: dict = {}  # gen -> accumulated fragments

    # -- setup ---------------------------------------------------------

    @staticmethod
    def _layout_template(params):
        """ShapeDtypeStruct skeleton of the MODEL param layout — the
        ``like=`` tree checkpoint reloads are validated against."""
        return jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), params)

    def _setup(self):
        model = get_model(self.model_cfg)
        impl = self.model_cfg.embedding_impl
        # accept_ragged composes with EVERY engine configuration: the host
        # splitter consumes the slot mask (ops/embedding.py split_hot_cold
        # slot_mask= — invalid slots are neither hot hits nor cold
        # lookups, so the hotcold DEVICE program is mask-free and
        # identical for ragged and fixed-length traffic), and the mesh
        # direct path shards the mask over "data" exactly like the indices
        # it masks (parallel/sharding.py batch_shardings).
        if impl in ("hotcold", "auto") and self._setup_hotcold(
                model, require=(impl == "hotcold")):
            return
        if self.mesh is not None:
            from deeprecsys_tpu.parallel import shard_params, sharded_apply

            if self.params is None:
                self.params = model.init(jax.random.PRNGKey(self.seed))
            self.params = shard_params(self.params, self.mesh)
            apply_fn = sharded_apply(
                model.apply, self.params, self.mesh,
                has_dense=self.model_cfg.dense_dim > 0,
            )
        elif self.params is None:
            with jax.default_device(self.device):
                self.params = jax.device_put(
                    model.init(jax.random.PRNGKey(self.seed)), self.device
                )
            # No jit(device=): params + batch are committed to self.device
            # (device_put above / _device_batch), which pins placement.
            apply_fn = jax.jit(model.apply)
        else:
            # Externally supplied params (checkpoint / export): pin them to
            # THIS engine's device like every other path — host-numpy
            # leaves would otherwise re-transfer the full table on every
            # jitted call, and params committed to another device fail the
            # warm-up with an incompatible-devices error.
            self.params = jax.device_put(self.params, self.device)
            apply_fn = jax.jit(model.apply)
        # Model-layout skeleton for checkpoint reloads (shapes/dtypes only).
        self._raw_template = self._layout_template(self.params)

        def warm(sliced: Batch):
            apply_fn(self.params, self._device_batch(sliced)).block_until_ready()
            if self.serving_cfg.accept_ragged:
                # Pre-warm the MASKED twin of every bucket program: a
                # ragged request changes the arg pytree (mask None ->
                # array), which is a fresh trace — compiling it in the
                # serve loop would stall queued requests for the compile.
                ragged = Batch(dense=sliced.dense, indices=sliced.indices,
                               mask=np.ones(sliced.indices.shape, dtype=bool))
                apply_fn(self.params,
                         self._device_batch(ragged)).block_until_ready()

        self._warm_buckets(warm, apply_fn)

    def _setup_hotcold(self, model, require: bool = True) -> bool:
        """Hot/cold-split serving (models/hotcold.py): hot set selected
        from the engine's own data distribution at warm-up; per request the
        native splitter compacts the cold stream on the host and the jitted
        apply gathers hot rows from the small hot table.

        With ``require=False`` (embedding_impl="auto") the decision rides
        the sampled hot-set coverage: below ``cfg.hotcold_min_hit`` the
        split isn't worth the host pass and the caller falls through to
        the direct-gather setup. Returns whether hotcold was chosen."""
        from deeprecsys_tpu.models.hotcold import (
            cold_buckets_for,
            hot_ids_and_coverage_from_generator,
            make_hotcold_model,
        )

        if (not require and self.model_cfg.fused_table_mb
                < self.model_cfg.hotcold_min_table_mb):
            # Size floor (config.hotcold_min_table_mb): a small table's
            # direct gather is cheap, so the split cannot pay there.
            # Skip without sampling.
            return False

        hot_rows = self.model_cfg.hot_set_rows
        if hot_rows <= 0:  # auto: size the hot set to the byte budget
            from deeprecsys_tpu.utils.memory import suggest_hot_rows

            hot_rows = suggest_hot_rows(self.model_cfg)
        # Scale the warm-up sample with the hot budget: the default
        # 8x256 queries can see at most B*T*L distinct ids, and a
        # budget-sized set (100k+ rows for int8 narrow-d tables) would
        # otherwise be mostly unfilled — limited by the sample, not the
        # budget, with no diagnostic.
        T, L = self.model_cfg.num_tables, self.model_cfg.num_indices_per_lookup
        n_batches = int(np.clip(-(-4 * hot_rows // (256 * T * L)), 8, 256))
        hot_ids, coverage = hot_ids_and_coverage_from_generator(
            self.model_cfg, seed=self.seed + 31, hot_rows=hot_rows,
            n_batches=n_batches,
            data_generation=self.serving_cfg.data_generation,
            trace_file=self.serving_cfg.synthetic_trace_file,
            raw_data_file=self.serving_cfg.raw_data_file)
        self.hot_coverage = coverage
        if not require and coverage < self.model_cfg.hotcold_min_hit:
            return False
        hc = make_hotcold_model(model, hot_ids, mesh=self.mesh)
        self._hotcold = hc
        if self.mesh is not None:
            from deeprecsys_tpu.parallel import shard_params

            if self.params is None:
                self.params = model.init(jax.random.PRNGKey(self.seed))
            # Reload skeleton is the RAW model layout (pre-conversion).
            self._raw_template = self._layout_template(self.params)
            # shard_params row-shards the fused table over "model"; the
            # hot_table (top-level key) and MLPs replicate.
            self.params = shard_params(hc.convert_params(self.params), self.mesh)
            apply_fn = jax.jit(hc.apply)
        else:
            if self.params is None:
                with jax.default_device(self.device):
                    self.params = model.init(jax.random.PRNGKey(self.seed))
            else:
                # Supplied params: pin to this device BEFORE conversion,
                # so the hot-table rebuild runs here too (same rationale
                # as _apply_reload).
                self.params = jax.device_put(self.params, self.device)
            self._raw_template = self._layout_template(self.params)
            self.params = jax.device_put(hc.convert_params(self.params), self.device)
            # Committed params/batch/split pin placement (no jit(device=)).
            apply_fn = jax.jit(hc.apply)

        def warm(sliced: Batch):
            b, T, L = sliced.indices.shape
            # Warm every cold-pad bucket so no request hits a compile.
            # Same ladder the splitter pads with (per-cell on a mesh).
            for c_pad in cold_buckets_for(b * T * L, self.mesh):
                dummy = {
                    "hot_sel": np.zeros((b, T, L), np.int32),
                    "hot_mask": np.zeros((b, T, L), bool),
                }
                if self.mesh is not None and self.mesh.shape["data"] > 1:
                    D, M = self.mesh.shape["data"], self.mesh.shape["model"]
                    dummy["cold_local"] = np.zeros((D, M, c_pad), np.int32)
                    dummy["cold_seg"] = np.full((D, M, c_pad), (b // D) * T,
                                                np.int32)
                elif self.mesh is not None:
                    M = self.mesh.shape["model"]
                    dummy["cold_local"] = np.zeros((M, c_pad), np.int32)
                    dummy["cold_seg"] = np.full((M, c_pad), b * T, np.int32)
                else:
                    dummy["cold_ids"] = np.zeros(c_pad, np.int32)
                    dummy["cold_seg"] = np.full(c_pad, b * T, np.int32)
                apply_fn(self.params, self._device_batch(sliced),
                         self._device_split(dummy)).block_until_ready()

        self._warm_buckets(warm, apply_fn)
        if self.serving_cfg.hotcold_refresh_interval > 0:
            # Pre-warm the DIRECT program for every bucket: a runtime
            # disable would otherwise jit-compile inside the serve loop,
            # stalling queued requests exactly when the engine is escaping
            # a headless split.
            direct = get_model(self.model_cfg.replace(embedding_impl="xla"))
            base = {k: v for k, v in self.params.items() if k != "hot_table"}
            if self.mesh is None:
                self._direct_fn = jax.jit(direct.apply)
            else:
                from deeprecsys_tpu.parallel import sharded_apply

                self._direct_fn = sharded_apply(
                    direct.apply, base, self.mesh,
                    has_dense=self.model_cfg.dense_dim > 0)
            for b in self.buckets:
                self._direct_fn(
                    base, self._device_batch(self._host_data[b])
                ).block_until_ready()
                if self.serving_cfg.accept_ragged:
                    # The hotcold program is mask-free (the host split
                    # consumes the mask), but this DIRECT fallback is the
                    # model's own masked gather — a ragged request after a
                    # runtime disable would otherwise compile in the serve
                    # loop.
                    sliced = self._host_data[b]
                    ragged = sliced._replace(
                        mask=np.ones(sliced.indices.shape, dtype=bool))
                    self._direct_fn(
                        base, self._device_batch(ragged)
                    ).block_until_ready()
            if self.mesh is not None:
                # Mesh hot-set swaps re-derive the replicated hot table
                # from the SHARDED live tables. Compile that program ONCE
                # here, with the id list as an argument (shape (K,) is
                # refresh-invariant: _candidate_hot_ids pads back to K),
                # so a runtime refresh runs zero serve-loop compiles —
                # the single-device path gets this for free because its
                # convert_params gathers are eager ops on a warm backend.
                self._mesh_hot_rebuild = self._build_mesh_hot_rebuild()
                self.params = dict(
                    self.params,
                    hot_table=self._mesh_hot_rebuild(
                        self.params["tables"],
                        self._replicated_ids(self._hotcold.hot_ids)))
        return True

    def _replicated_ids(self, hot_ids) -> jax.Array:
        from jax.sharding import NamedSharding, PartitionSpec as P

        return jax.device_put(np.asarray(hot_ids, dtype=np.int32),
                              NamedSharding(self.mesh, P()))

    def _build_mesh_hot_rebuild(self):
        """Jitted (tables, hot_ids) -> replicated (K, d) hot table over
        the mesh — the refresh-time twin of ``convert_params``'s gather,
        but with the id list TRACED so one compile serves every future
        swap. Mirrors the layout dispatch of
        models/hotcold.py::make_hotcold_model.convert_params; operates on
        the POST-conversion ``params["tables"]`` (odd-pack mesh fallbacks
        already unpacked it there)."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        from deeprecsys_tpu.parallel.sharding import param_shardings

        d = self.model_cfg.sparse_feature_size

        def rebuild(tables, hid):
            import jax.numpy as jnp

            from deeprecsys_tpu.ops.embedding import select_packed_rows

            if isinstance(tables, dict) and (
                    "packed" in tables or "q_packed" in tables):
                key = "packed" if "packed" in tables else "q_packed"
                arr = tables[key]
                pack = arr.shape[1] // d
                return select_packed_rows(arr, hid, pack).astype(arr.dtype)
            if isinstance(tables, dict):
                key2d = "qrows" if "qrows" in tables else "q"
                return jnp.take(tables[key2d], hid, axis=0)
            return jnp.take(tables, hid, axis=0)

        tb_sh = param_shardings(
            {"tables": self.params["tables"]}, self.mesh)["tables"]
        rep = NamedSharding(self.mesh, P())
        return jax.jit(rebuild, in_shardings=(tb_sh, rep), out_shardings=rep)

    def _warm_buckets(self, warm_fn, apply_fn):
        """Shared warm-up scaffolding: pre-generate one max-size batch,
        register per-bucket host slices + the jitted apply, and run
        ``warm_fn(sliced)`` per bucket to compile every serve-time shape
        (reference: pre-generate then slice, inferenceEngine.py:200-206)."""
        gen = RecDataGenerator(self.model_cfg, seed=self.seed + 17,
                               data_generation=self.serving_cfg.data_generation,
                               trace_file=self.serving_cfg.synthetic_trace_file,
                               raw_data_file=self.serving_cfg.raw_data_file)
        full = gen.generate_batch(max(self.buckets))
        for b in self.buckets:
            sliced = Batch(
                dense=None if full.dense is None else full.dense[:b],
                indices=full.indices[:b],
            )
            self._host_data[b] = sliced
            self._jitted[b] = apply_fn
            warm_fn(sliced)

    def _device_split(self, split: dict) -> dict:
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            hybrid = self.mesh.shape["data"] > 1
            hot = P("data", None, None) if hybrid else P()
            cold = P("data", "model", None) if hybrid else P("model", None)
            sh = {"hot_sel": NamedSharding(self.mesh, hot),
                  "hot_mask": NamedSharding(self.mesh, hot),
                  "cold_local": NamedSharding(self.mesh, cold),
                  "cold_seg": NamedSharding(self.mesh, cold)}
            return {k: jax.device_put(np.asarray(v), sh[k])
                    for k, v in split.items() if k != "n_cold"}
        return {k: jax.device_put(np.asarray(v), self.device)
                for k, v in split.items() if k != "n_cold"}

    def _payload_ok(self, r: ServiceRequest) -> bool:
        """True iff a request's payload (if any) matches the model's input
        shapes — indices (batch_size, T, L), dense present iff the model
        takes dense features, mask (if any) shaped like indices."""
        p = r.payload
        if p is None:
            return True
        base = self._host_data[self.buckets[0]]
        T, L = base.indices.shape[1:]
        if getattr(p.indices, "shape", None) != (r.batch_size, T, L):
            return False
        if (base.dense is None) != (p.dense is None):
            return False
        if p.dense is not None and p.dense.shape != (r.batch_size,
                                                     base.dense.shape[1]):
            return False
        if p.mask is not None:
            if not self.serving_cfg.accept_ragged:
                # Only ragged-enabled engines can honor a mask: direct
                # engines pre-warmed the masked program twin (a mask on a
                # plain engine would trigger a serve-loop compile);
                # hotcold engines consume
                # the mask in the host splitter (mask-free device
                # program) but their refusal here keeps the opt-in
                # contract uniform across impls.
                return False
            if p.mask.shape != (r.batch_size, T, L):
                return False
        return True

    def _assemble_host(self, group, bucket: int) -> Batch:
        """Bucket-size host batch for a group containing client payloads.

        Rows land at each request's cumulative offset (the completion loop
        slices scores at the same offsets); requests without a payload and
        the pad up to ``bucket`` take the pre-generated synthetic rows at
        the matching positions — identical device work to the load-test
        path, honest host-assembly cost on the dispatch thread (the
        reference re-feeds host blobs per request the same way,
        inferenceEngine.py:200-206)."""
        base = self._host_data[bucket]
        dense_parts = [] if base.dense is not None else None
        idx_parts = []
        # Ragged requests carry a slot mask; any masked member upgrades
        # the whole execution to the masked program (pre-warmed when
        # accept_ragged), with full-group (all-true) masks for the
        # fixed-length members and the bucket padding.
        any_mask = any(r.payload is not None and r.payload.mask is not None
                       for r in group)
        mask_parts = [] if any_mask else None
        T, L = base.indices.shape[1:]

        def full_mask(n):
            return np.ones((n, T, L), dtype=bool)

        off = 0
        for r in group:
            if r.payload is not None:
                idx_parts.append(r.payload.indices)
                if dense_parts is not None:
                    dense_parts.append(r.payload.dense)
                if mask_parts is not None:
                    mask_parts.append(r.payload.mask
                                      if r.payload.mask is not None
                                      else full_mask(r.batch_size))
            else:
                idx_parts.append(base.indices[off:off + r.batch_size])
                if dense_parts is not None:
                    dense_parts.append(base.dense[off:off + r.batch_size])
                if mask_parts is not None:
                    mask_parts.append(full_mask(r.batch_size))
            off += r.batch_size
        if off < bucket:  # pad to the compiled bucket shape
            idx_parts.append(base.indices[off:bucket])
            if dense_parts is not None:
                dense_parts.append(base.dense[off:bucket])
            if mask_parts is not None:
                mask_parts.append(full_mask(bucket - off))
        return Batch(
            dense=(None if dense_parts is None
                   else np.concatenate(dense_parts, axis=0)),
            indices=np.concatenate(idx_parts, axis=0),
            mask=(None if mask_parts is None
                  else np.concatenate(mask_parts, axis=0)),
        )

    def _device_batch(self, host_batch: Batch) -> Batch:
        if self.mesh is not None:
            from deeprecsys_tpu.parallel.sharding import batch_shardings

            sh = batch_shardings(self.mesh, has_dense=host_batch.dense is not None)
            dense = None if host_batch.dense is None else jax.device_put(host_batch.dense, sh.dense)
            mask = (None if host_batch.mask is None
                    else jax.device_put(host_batch.mask, sh.mask))
            return Batch(dense=dense,
                         indices=jax.device_put(host_batch.indices, sh.indices),
                         mask=mask)
        dense = None if host_batch.dense is None else jax.device_put(host_batch.dense, self.device)
        mask = None if host_batch.mask is None else jax.device_put(host_batch.mask, self.device)
        return Batch(dense=dense, indices=jax.device_put(host_batch.indices, self.device),
                     mask=mask)

    # -- run loop ------------------------------------------------------

    def run(self):
        try:
            self._setup()
        except Exception as e:  # surface engine failures instead of hanging
            self.error = e
            self.ready_q.put(e)
            self._stop_and_release_reload("engine failed during setup")
            self.response_q.put(_SENTINEL)
            return
        self.ready_q.put(self.engine_id)

        completer = threading.Thread(target=self._completion_loop, daemon=True)
        completer.start()
        try:
            self._serve_loop()
        except Exception as e:
            # A mid-run crash must not deadlock the fabric: with no
            # consumer, the load generator eventually blocks on the
            # bounded request queue and the watchdog sees only live
            # threads. Record the error, then SINK requests until the
            # shutdown sentinel so the producer can finish; the dropped
            # requests surface as in-flight loss in the degraded-run
            # accounting.
            self.error = e
            print(f"[deeprecsys_tpu] WARNING: engine {self.engine_id} "
                  f"crashed mid-run ({e!r}); sinking its queue until "
                  f"shutdown", flush=True)
            self._sink_requests()
        self._pending.put(_SENTINEL)
        completer.join()
        if self._scan_thread is not None:
            # Best-effort worker stop; a full task slot means the daemon
            # worker finishes its scan and then dies with the process.
            try:
                self._scan_req.put_nowait(None)
            except queue.Full:
                pass
        self._stop_and_release_reload(
            "engine shut down before applying the reload")
        self.response_q.put(_SENTINEL)

    def _sink_requests(self):
        while True:
            request = self.request_q.get()
            if request is _SENTINEL or request is None:
                return

    def _emit_error(self, request: ServiceRequest, code: int, t: float):
        """Answer one request with an error response (waiters unblock with
        a 5xx instead of timing out). Timestamps are honest: queue_start =
        when the engine looked at it; no device time was spent."""
        now = time.time()
        self.response_q.put(ServiceResponse(
            consumer_id=self.engine_id,
            epoch=request.epoch,
            batch_id=request.batch_id,
            batch_size=request.batch_size,
            arrival_time=request.arrival_time,
            queue_start_time=t,
            queue_end_time=now,
            inference_end_time=now,
            out_batch_size=0,
            sub_id=request.sub_id,
            total_sub_batches=request.total_sub_batches,
            exp_packet=request.exp_packet,
            error_code=code,
        ))

    # -- zero-downtime checkpoint reload --------------------------------

    def request_reload(self, path: str) -> ReloadHandle:
        """Schedule a checkpoint swap (utils/checkpoint.py layout, MODEL
        params — the engine re-runs its own conversion: hotcold hot-table
        re-derivation, sharding, device placement). Applied atomically
        before the next request this engine serves; on failure the old
        params keep serving. A newer request supersedes a pending one:
        the superseded handle's event is set with error="superseded" so
        waiters never hang. Thread-safe."""
        handle = ReloadHandle(path)
        with self._reload_lock:
            if self._stopped:
                # The engine already exited: fail fast instead of parking
                # a handle nobody will ever apply (waiters would hang).
                handle.error = RuntimeError("engine has shut down")
                handle.event.set()
                return handle
            prev, self._reload = self._reload, handle
        if prev is not None and not prev.event.is_set():
            prev.error = RuntimeError(
                f"superseded by a newer reload request ({handle.path})")
            prev.event.set()
        return handle

    def _stop_and_release_reload(self, msg: str):
        """Mark the engine stopped and fail any pending reload, under ONE
        lock section so request_reload can never park a handle in the
        gap (waiters would hang forever)."""
        with self._reload_lock:
            self._stopped = True
            pending, self._reload = self._reload, None
        if pending is not None:
            pending.error = RuntimeError(msg)
            pending.event.set()

    def _take_pending_reload(self) -> "ReloadHandle | None":
        # Atomic take: once the engine owns a handle, a concurrent
        # request_reload sees None and won't supersede it mid-apply.
        with self._reload_lock:
            pending, self._reload = self._reload, None
        return pending

    def _apply_reload(self, handle: ReloadHandle):
        try:
            from deeprecsys_tpu.utils.checkpoint import load_params

            new = load_params(handle.path, like=self._raw_template)
            # Pin the conversion to this engine's backend: load_params
            # returns uncommitted host arrays, and the hotcold hot-table
            # rebuild (gathers/casts) would otherwise dispatch on the
            # DEFAULT backend, not this engine's.
            dev0 = self.device if self.mesh is None else self.mesh.devices.flat[0]
            with jax.default_device(dev0):
                if self._hotcold is not None:
                    new = self._hotcold.convert_params(new)
                if self.mesh is not None:
                    from deeprecsys_tpu.parallel import shard_params

                    self.params = shard_params(new, self.mesh)
                else:
                    self.params = jax.device_put(new, self.device)
        except Exception as e:
            handle.error = e
        finally:
            handle.event.set()

    def _track_hotcold(self, host, split, real_rows: int) -> bool:
        """Adaptive hot-set refresh: accumulate the live hit rate from the
        splitter's per-lookup hot mask and the recent request batches;
        every ``hotcold_refresh_interval`` requests, re-derive the hot set
        from the buffered stream if the windowed coverage fell
        ``hotcold_refresh_margin`` below the reference coverage. A hot set
        frozen at warm-up decays under popularity drift — the reference
        has no analog (its data distribution is fixed per run,
        dlrm_data_caffe2.py); this is the serving consequence of making
        the hot set data-driven. Returns True when the set was swapped
        (the caller's split is stale). Runs in the serve-loop thread —
        the only writer of ``_hotcold``/``params`` during serving.

        ``real_rows``: only the first N batch rows carry the actual
        request stream — the rest is bucket padding from the warm-up
        generator, which the warm-up hot set covers at ~reference rate
        and would dilute drift detection toward never triggering (a
        batch-1 payload on a bucket-64 ladder is 63/64 pad)."""
        import collections

        cfg = self.serving_cfg
        hm = np.asarray(split["hot_mask"])[:real_rows]
        self._live_hot += int(hm.sum())
        if host.mask is None:
            self._live_total += int(hm.size)
        else:
            # Ragged batch: the splitter zeroed hot_mask on invalid slots,
            # so they are non-hits by construction — counting them in the
            # denominator would read a phantom coverage collapse on
            # short-group traffic and trigger refreshes that change
            # nothing. Only VALID slots are lookups.
            self._live_total += int(np.asarray(host.mask[:real_rows]).sum())
        if self._refresh_buf is None:
            self._refresh_buf = collections.deque(
                maxlen=max(cfg.hotcold_refresh_window, 1))
        self._refresh_buf.append(self._buffered(host, real_rows))
        # A completed worker scan applies on the NEXT tracked request
        # (cheap nonblocking poll — the swap lands ~1 request after the
        # worker finishes, not an interval later).
        changed = self._apply_scan_result()
        self._tracked_since_check += 1
        if self._tracked_since_check < cfg.hotcold_refresh_interval:
            return changed
        cov = self._live_hot / max(self._live_total, 1)
        self.live_hot_coverage = cov
        self._tracked_since_check = 0
        self._live_hot = self._live_total = 0
        ref = self.hot_coverage if self.hot_coverage is not None else 0.0
        if cov >= ref - cfg.hotcold_refresh_margin:
            # No degradation — but a set that was never GOOD (warm-up
            # sampled a different distribution than the live stream, e.g.
            # the uniform generator under skewed payload traffic) will
            # never trip the drop rule either. Scan for an UPGRADE: if a
            # set re-derived from the live stream would cover
            # meaningfully more, install it. Skipped once the current
            # set is already serving well.
            if ref >= self.model_cfg.hotcold_min_hit:
                return changed
            if self._upgrade_wait > 0:
                # Back-off after failed scans: a STEADY mediocre stream
                # has nothing to upgrade to, and the candidate derivation
                # (two select_hot_ids passes over the window) is real
                # host cost (worker-thread CPU that contends with the
                # splitter) — don't pay it every interval forever.
                self._upgrade_wait -= 1
                return changed
            res = self._scan("upgrade", cov)
            if res is not None:  # sync mode: decided inline
                changed = self._apply_upgrade(res, cov) or changed
            return changed
        res = self._scan("refresh", cov)
        if res is not None:
            changed = self._apply_refresh(res, cov) or changed
        return changed

    # -- async scan machinery ------------------------------------------
    #
    # The candidate derivation (buffer concatenate + budget-gated
    # sort-unique selection + holdout coverage) would stall the dispatch
    # thread once per window — a p99 spike the serving path must not
    # pay. The dispatch thread SUBMITS a scan task (buffer
    # snapshot + decision context) and polls the one-slot result queue on
    # every tracked request; the worker only computes — every
    # install/disable/backoff decision still runs on the serve thread,
    # which stays the only writer of _hotcold/params.
    # ``hotcold_scan_async=False`` restores the inline scan (exact
    # round-4 timing, used by determinism-sensitive comparisons).

    def _scan(self, kind: str, cov):
        """Request a candidate scan. Sync mode: compute inline and return
        (new_hot, est_cov). Async mode: snapshot the buffer, hand it to
        the worker (one in flight at a time), return None — the result
        applies via ``_apply_scan_result`` on a later tracked request."""
        if not self.serving_cfg.hotcold_scan_async:
            return self._candidate_hot_ids()
        if not self._scan_inflight:
            old_hot = (None if self._hotcold is None
                       else np.asarray(self._hotcold.hot_ids))
            k = 0 if old_hot is None else len(old_hot)
            if self._scan_thread is None:
                self._scan_thread = threading.Thread(
                    target=self._scan_worker_loop, daemon=True,
                    name=f"engine-{self.engine_id}-scan")
                self._scan_thread.start()
            self._scan_inflight = True
            self._scan_req.put((kind, cov, list(self._refresh_buf), k,
                                old_hot))
        return None

    def _scan_worker_loop(self):
        while True:
            task = self._scan_req.get()
            if task is None:
                return
            kind, cov, batches, k, old_hot = task
            try:
                res = self._candidate_hot_ids_from(batches, k, old_hot)
            except Exception as e:  # never kill the worker silently
                print(f"[deeprecsys_tpu] WARNING: engine {self.engine_id} "
                      f"scan worker failed ({e!r}); scan dropped",
                      flush=True)
                res = (None, None)
            # Prebuild the splitter's hash index HERE (O(K) — the same
            # off-dispatch-thread contract as the scan itself) so the
            # serve thread's swap is param-rebuild only.
            hot_index = None
            if res[0] is not None:
                try:
                    from deeprecsys_tpu.runtime.native import HotIndex

                    hot_index = HotIndex(res[0])
                except RuntimeError:
                    pass
            self._scan_res.put((kind, cov, res, hot_index))

    def _apply_scan_result(self) -> bool:
        """Consume a completed worker scan (serve thread only). Returns
        True when the dispatch state changed (caller's split is stale)."""
        try:
            kind, cov, res, hot_index = self._scan_res.get_nowait()
        except queue.Empty:
            return False
        self._scan_inflight = False
        if kind == "upgrade":
            changed = self._apply_upgrade(res, cov, hot_index=hot_index)
        elif kind == "refresh":
            changed = self._apply_refresh(res, cov, hot_index=hot_index)
        else:
            changed = self._apply_reenable(res, hot_index=hot_index)
        if changed:
            # The async swap lands mid-window: requests dispatched against
            # the OLD set before this poll would pollute the new set's
            # coverage window and could re-trigger a refresh that changes
            # nothing. Restart the window at the swap, exactly as the
            # sync path's at-check install did.
            self._live_hot = self._live_total = 0
            self._tracked_since_check = 0
        return changed

    def _apply_upgrade(self, res, cov: float, hot_index=None) -> bool:
        new_hot, cand = res
        cfg = self.serving_cfg
        ref = self.hot_coverage if self.hot_coverage is not None else 0.0
        if (new_hot is None or cand is None
                or cand < max(ref, cov) + cfg.hotcold_refresh_margin):
            self._upgrade_backoff = min(max(self._upgrade_backoff, 1) * 2,
                                        64)
            self._upgrade_wait = self._upgrade_backoff
            return False
        self._upgrade_backoff = self._upgrade_wait = 0
        self._install_hot_ids(new_hot, cand, hot_index=hot_index)
        print(f"[deeprecsys_tpu] engine {self.engine_id}: hot-set "
              f"UPGRADE #{self.hot_refreshes} (live coverage "
              f"{cov:.1%} -> candidate {cand:.1%})", flush=True)
        return True

    @staticmethod
    def _buffered(host, real_rows: int):
        """Refresh-buffer entry: (indices, mask-or-None) for the REAL
        request rows. The mask rides along so candidate selection and
        coverage scoring exclude padded slots (a ragged stream's index-0
        filler would otherwise be counted as the hottest row of every
        table)."""
        return (np.asarray(host.indices[:real_rows]),
                None if host.mask is None
                else np.asarray(host.mask[:real_rows]))

    def _candidate_hot_ids(self):
        """(new_hot, est_coverage) from the buffered recent stream.
        ``new_hot`` is selected on all buffered batches EXCEPT a held-out
        tail (the most recent quarter, min 1 batch) and padded back to
        the original K with still-hot old ids (|old| == K, so the top-up
        always restores exactly K and the hot-table shape — and every
        compiled bucket program — survives the swap). ``est_coverage``
        scores exactly the set that would be INSTALLED, on the held-out
        batches it never saw: scoring in-sample reads exactly 1.0
        whenever the window's distinct ids fit the K budget (defeating
        the disable safeguard on headless streams), and scoring a
        DIFFERENT set than the installed one (e.g. a half-window
        selection) systematically mis-states the installed
        set's reference coverage, skewing every later drop-rule
        comparison against the re-baselined ``hot_coverage``. One
        select_hot_ids pass (host cost — on the scan WORKER thread by
        default, see benchmarks/README.md refresh-scan numbers). Returns
        (None, None) when the buffer is too small to estimate (< 2
        batches — config validation keeps the window >= 2 whenever
        tracking is on)."""
        return self._candidate_hot_ids_from(
            list(self._refresh_buf), len(self._hotcold.hot_ids),
            np.asarray(self._hotcold.hot_ids))

    def _candidate_hot_ids_from(self, batches, k: int, old_hot):
        """Pure scan body (thread-safe: reads only its arguments and
        immutable config) — shared by the sync inline path and the async
        worker (``_scan_worker_loop``)."""
        from deeprecsys_tpu.ops.embedding import (
            hot_coverage_of,
            select_hot_ids,
        )

        if len(batches) < 2:
            return None, None
        offsets = np.asarray(self.model_cfg.table_offsets)
        n_hold = max(1, len(batches) // 4)
        from deeprecsys_tpu.ops.embedding import scan_budget_subsample

        def cat(entries):
            """(indices, mask) over a buffer slice, ragged-aware: mask is
            None iff no entry carried one (the common fixed-length case
            stays zero-overhead); mixed windows fill all-true for the
            fixed-length members."""
            idxs = [e[0] for e in entries]
            idx = np.concatenate(idxs, axis=0)
            if all(e[1] is None for e in entries):
                return idx, None
            mask = np.concatenate(
                [np.ones(e[0].shape, dtype=bool) if e[1] is None else e[1]
                 for e in entries], axis=0)
            return idx, mask

        # Scan-budget gate (ops/embedding.py docstring has the numbers):
        # the sort-unique selection runs on the DISPATCH thread. The
        # subsample strides ROWS, so the mask strides identically.
        budget = self.serving_cfg.hotcold_scan_budget
        sel_idx, sel_mask = cat(batches[:-n_hold])
        hold_idx, hold_mask = cat(batches[-n_hold:])
        select = scan_budget_subsample(sel_idx, budget)
        holdout = scan_budget_subsample(hold_idx, budget)
        if sel_mask is not None:
            sel_mask = scan_budget_subsample(sel_mask, budget)
        if hold_mask is not None:
            hold_mask = scan_budget_subsample(hold_mask, budget)
        new_hot = select_hot_ids(select, offsets, k, mask=sel_mask)
        if len(new_hot) < k:
            extra = np.setdiff1d(old_hot, new_hot)
            new_hot = np.sort(np.concatenate(
                [new_hot, extra[:k - len(new_hot)]]))
        return new_hot, hot_coverage_of(holdout, offsets, new_hot,
                                        mask=hold_mask)

    def _apply_refresh(self, res, live_cov: float, hot_index=None) -> bool:
        """Live coverage collapsed at scan-submit time: if the buffered
        stream still HAS a popular head, swap it in WITHOUT recompiling
        (same-shape hot-table param; the jittable apply never depends on
        the id list — models/hotcold.py::with_hot_ids). If it does NOT
        (candidate coverage < hotcold_min_hit), DISABLE the split and
        serve the plain fused gather: a headless split pays the host pass
        and the hot gather for nothing. Returns True when the
        dispatch state changed (caller's split is stale). Mesh engines
        swap through the pre-compiled sharded hot-table rebuild
        (``_build_mesh_hot_rebuild``) — same zero-serve-loop-compile
        contract as the single-device path."""
        new_hot, new_cov = res
        if new_cov is None:
            return False  # buffer too small to estimate — no change
        if new_cov < self.model_cfg.hotcold_min_hit:
            self._disable_hotcold(live_cov, new_cov)
            return True
        self._install_hot_ids(new_hot, new_cov, hot_index=hot_index)
        print(f"[deeprecsys_tpu] engine {self.engine_id}: hot-set refresh "
              f"#{self.hot_refreshes} (live coverage {live_cov:.1%} -> "
              f"buffered-stream coverage {new_cov:.1%}, "
              f"{len(new_hot)} rows)", flush=True)
        return True

    def _install_hot_ids(self, new_hot, ref_cov: float, hot_index=None):
        """Swap the hot set + rebuild the hot table from the live params'
        full tables (same shapes: no recompile). On a
        mesh the replicated hot table is re-derived from the SHARDED
        tables by the rebuild program compiled at setup (the sharded
        apply reads the hot table from params and never depends on the
        id list, exactly like the single-device apply — only the host
        splitter's ``prepare`` does). ``hot_index``: the splitter hash
        index prebuilt by the scan worker; without it the swap builds one
        inline (sync-scan mode, which stalls by design)."""
        from deeprecsys_tpu.models.hotcold import with_hot_ids

        hc = with_hot_ids(self._hotcold, new_hot, mesh=self.mesh,
                          hot_index=hot_index)
        if self.mesh is not None:
            new_table = self._mesh_hot_rebuild(
                self.params["tables"], self._replicated_ids(new_hot))
            self.params = dict(self.params, hot_table=new_table)
        else:
            base = {key: v for key, v in self.params.items()
                    if key != "hot_table"}
            self.params = jax.device_put(hc.convert_params(base), self.device)
        self._hotcold = hc
        # Re-baseline the reference coverage on the refreshed set: stops a
        # stream whose achievable head mass genuinely dropped from
        # re-triggering a refresh every window.
        self.hot_coverage = ref_cov
        self.hot_refreshes += 1

    def _disable_hotcold(self, live_cov: float, cand_cov: float):
        self._hotcold_active = False
        self.hot_coverage = cand_cov
        print(f"[deeprecsys_tpu] engine {self.engine_id}: hot/cold split "
              f"DISABLED (live coverage {live_cov:.1%}, best candidate "
              f"{cand_cov:.1%} < min_hit "
              f"{self.model_cfg.hotcold_min_hit:.0%}); serving the direct "
              f"gather, still watching the stream", flush=True)

    def _direct_dispatch(self, dev_batch):
        """Plain fused-gather dispatch for a runtime-disabled hotcold
        engine. ``_direct_fn`` is pre-warmed per bucket at setup whenever
        refresh tracking is on (the only way to get here); the lazy
        branch is a safety net if those conditions ever drift apart —
        it pays an in-serve-loop compile, so warn loudly."""
        if self._direct_fn is None:
            print(f"[deeprecsys_tpu] WARNING: engine {self.engine_id}: "
                  f"direct fallback compiling in the serve loop (pre-warm "
                  f"did not run — setup/dispatch conditions out of sync)",
                  flush=True)
            model = get_model(self.model_cfg.replace(embedding_impl="xla"))
            if self.mesh is not None:
                from deeprecsys_tpu.parallel import sharded_apply

                self._direct_fn = sharded_apply(
                    model.apply,
                    {k: v for k, v in self.params.items() if k != "hot_table"},
                    self.mesh, has_dense=self.model_cfg.dense_dim > 0)
            else:
                self._direct_fn = jax.jit(model.apply)
        # Derived from the LIVE params every dispatch (not cached at
        # disable time): a checkpoint reload while disabled must serve
        # the reloaded tables. Same array objects -> no retrace.
        base = {k: v for k, v in self.params.items() if k != "hot_table"}
        return self._direct_fn(base, dev_batch)

    def _track_direct(self, host, real_rows: int):
        """Disabled-state stream watch: keep buffering batches; every
        interval, estimate what a re-derived hot set WOULD cover (pure
        host math — no device work) and re-enable the split when a
        popular head returns."""
        self._refresh_buf.append(self._buffered(host, real_rows))
        self._apply_scan_result()
        self._tracked_since_check += 1
        if self._tracked_since_check < self.serving_cfg.hotcold_refresh_interval:
            return
        self._tracked_since_check = 0
        res = self._scan("reenable", None)
        if res is not None:  # sync mode
            self._apply_reenable(res)

    def _apply_reenable(self, res, hot_index=None) -> bool:
        new_hot, cov = res
        if cov is not None:
            self.live_hot_coverage = cov
        # Hysteresis: re-enable needs min_hit + margin, while the disable
        # fired below min_hit — a stream hovering AT the threshold (where
        # the split is ~breakeven) would
        # otherwise flip split<->direct every interval, paying a
        # hot-table rebuild per flip.
        if cov is None or cov < (self.model_cfg.hotcold_min_hit
                                 + self.serving_cfg.hotcold_refresh_margin):
            return False
        self._install_hot_ids(new_hot, cov, hot_index=hot_index)
        self._hotcold_active = True
        self._live_hot = self._live_total = 0
        print(f"[deeprecsys_tpu] engine {self.engine_id}: hot/cold split "
              f"RE-ENABLED (candidate coverage {cov:.1%}, refresh "
              f"#{self.hot_refreshes})", flush=True)
        return True

    def _poll_control(self):
        """Drain the cpu-mp reload side channel: reassemble ReloadFragment
        path chunks PER GENERATION (concurrent reload requests may
        interleave their fragments on the ring; each request carries its
        own gen tag) and apply + ACK each completed path. The ACK echoes
        the gen in ``sub_id`` so the ingress resolves the handle that made
        THIS request — not whichever reload happens to be newest."""
        if self.control_q is None:
            return
        while True:
            try:
                frag = self.control_q.get_nowait()
            except (queue.Empty, ShmEmpty):
                return
            if frag is None:
                continue
            buf = self._reload_frags.setdefault(frag.gen, [])
            if frag.seq != len(buf):
                # Torn within one gen (producer died mid-path): drop the
                # partial sequence; a fresh seq-0 fragment starts over.
                print(f"[deeprecsys_tpu] WARNING: engine {self.engine_id} "
                      f"dropped a torn reload-path sequence (gen {frag.gen},"
                      f" got seq {frag.seq} after {len(buf)} fragments)",
                      flush=True)
                self._reload_frags.pop(frag.gen, None)
                if frag.seq != 0:
                    continue
                buf = self._reload_frags.setdefault(frag.gen, [])
            buf.append(frag)
            if len(buf) < frag.total:
                continue
            del self._reload_frags[frag.gen]
            path = b"".join(f.payload for f in buf).decode()
            handle = ReloadHandle(path)
            self._apply_reload(handle)
            now = time.time()
            self.response_q.put(ServiceResponse(
                consumer_id=self.engine_id, epoch=0,
                batch_id=RELOAD_ACK_BATCH_ID, batch_size=0,
                arrival_time=now, queue_start_time=now, queue_end_time=now,
                inference_end_time=now,
                out_batch_size=0 if handle.error is not None else 1,
                sub_id=frag.gen, total_sub_batches=1, exp_packet=True,
                error_code=ERR_RELOAD if handle.error is not None else 0))
            if handle.error is not None:
                print(f"[deeprecsys_tpu] WARNING: engine {self.engine_id} "
                      f"reload of {path!r} failed ({handle.error!r}); "
                      f"previous params keep serving", flush=True)

    def _next_request(self):
        """Blocking get — with a periodic wake to apply pending checkpoint
        reloads while IDLE (an idle engine would otherwise hold a
        scheduled swap, and anyone waiting on its handle, until traffic
        arrives). Thread engines take reloads from the in-process handle
        slot; cpu-mp engines poll their reload side-channel ring."""
        stdlib = isinstance(self.request_q, queue.Queue)
        if not stdlib and self.control_q is None:
            # Ring queue, no side channel: plain blocking get (a timeout
            # wake would have nothing to poll).
            return self.request_q.get()
        while True:
            try:
                return self.request_q.get(timeout=0.5)
            except (queue.Empty, ShmEmpty):
                self._poll_control()
                pending = self._take_pending_reload()
                if pending is not None:
                    self._apply_reload(pending)

    def _hydrate(self, request):
        """cpu-mp real inference: a request whose features crossed the
        POD ring as a BlobArena slot id gets them read back here (copied
        out — the completion loop overwrites the slot with scores). A
        read failure answers the request and returns ``_DROPPED`` — NOT
        None, which is the shutdown sentinel (a None return here would
        make the serve loop swallow the sentinel and spin forever)."""
        if (request is _SENTINEL or request is None or self.arena is None
                or request.payload is not None
                or getattr(request, "payload_slot", -1) < 0):
            return request
        from deeprecsys_tpu.models.base import Batch

        try:
            idx, dense, mask = self.arena.read_batch(request.payload_slot)
        except Exception as e:
            print(f"[deeprecsys_tpu] WARNING: engine {self.engine_id} "
                  f"failed to read payload slot {request.payload_slot} "
                  f"({e!r}); answering ERR_READBACK", flush=True)
            self._emit_error(request, ERR_READBACK, time.time())
            return _DROPPED
        request.payload = Batch(dense=dense, indices=idx, mask=mask)
        return request

    def _serve_loop(self):
        cfg = self.serving_cfg
        done = False
        carry = None  # request drained during coalescing that didn't fit
        while not done:
            request = carry if carry is not None else self._hydrate(
                self._next_request())
            carry = None
            if request is _SENTINEL:
                break
            if request is _DROPPED:
                continue  # unreadable payload slot — answered above
            group = [request]
            if cfg.coalesce_requests:
                # Dynamic batching: drain waiting requests into one bucket
                # execution (matmuls want big batches; the queue backlog is
                # free batch size). The group total never exceeds the
                # largest bucket — a drained request that would overflow
                # is carried into the next execution instead of being
                # silently clamped (undercomputed) by pick_bucket.
                total = request.batch_size
                while len(group) < cfg.max_coalesce and total < self.buckets[-1]:
                    try:
                        nxt = self.request_q.get_nowait()
                    except (queue.Empty, ShmEmpty):
                        break
                    if nxt is _SENTINEL or nxt is None:
                        # Put the sentinel back: it belongs to whichever
                        # engine blocks on the queue next (consuming it
                        # here would leave a peer engine waiting forever).
                        self.request_q.put(_SENTINEL)
                        done = True
                        break
                    nxt = self._hydrate(nxt)
                    if nxt is _DROPPED:
                        continue  # unreadable payload slot — answered
                    if total + nxt.batch_size > self.buckets[-1]:
                        carry = nxt
                        break
                    group.append(nxt)
                    total += nxt.batch_size
            # Apply a pending checkpoint swap AFTER the coalescing drain:
            # a request scheduled after request_reload() can land in this
            # group via get_nowait(), and the ReloadHandle contract says
            # it must see the new params.
            pending_reload = self._take_pending_reload()
            if pending_reload is not None:
                self._apply_reload(pending_reload)
            self._poll_control()  # cpu-mp reloads honor the same contract
            queue_start = time.time()
            # Deadline admission: drop expired requests BEFORE dispatch —
            # no device time burnt — and answer each with an ERR_DEADLINE
            # response so waiters (HTTP handlers, aggregators) unblock
            # immediately instead of receiving a stale result.
            live = []
            for r in group:
                if r.deadline and queue_start > r.deadline:
                    self.expired_requests += 1
                    self._emit_error(r, ERR_DEADLINE, queue_start)
                elif not self._payload_ok(r):
                    # Shape-mismatched payloads (dense missing/extra, wrong
                    # (T, L)) get a typed per-request error instead of
                    # killing the engine in _assemble_host. Ingress
                    # validates too; this covers direct queue producers.
                    self.rejected_requests += 1
                    self._emit_error(r, ERR_PAYLOAD, queue_start)
                else:
                    live.append(r)
            group = live
            if not group:
                continue
            total_rows = sum(r.batch_size for r in group)
            bucket = pick_bucket(self.buckets, total_rows)
            if bucket < total_rows:
                if self.strict_buckets:
                    # Direct-construction default: refuse to undercompute —
                    # answer with an explicit error instead of returning
                    # fewer rows than requested with only a stdout warning.
                    self.rejected_requests += len(group)
                    for r in group:
                        self._emit_error(r, ERR_OVER_LADDER, queue_start)
                    continue
                # Payload requests can never be clamped: returned scores
                # must correspond 1:1 to the submitted rows, and an
                # undercomputed execution has no rows for them. Answer
                # those with ERR_OVER_LADDER; only the synthetic
                # (load-modeling) members keep the legacy clamp.
                keep = []
                for r in group:
                    if r.payload is not None:
                        self.rejected_requests += 1
                        self._emit_error(r, ERR_OVER_LADDER, queue_start)
                    else:
                        keep.append(r)
                group = keep
                if not group:
                    continue
                # A static ladder topping out below the request size can
                # only execute the cap — make the undercompute VISIBLE
                # (counted in /v1/healthz) instead of silently reporting
                # full-size latencies. bucket_policy=auto force-covers the
                # max_mini_batch_size cap and never hits this.
                self.clamped_requests += len(group)
                if not self._clamp_warned:  # warn once
                    self._clamp_warned = True
                    print(f"[deeprecsys_tpu] WARNING: engine "
                          f"{self.engine_id} clamped a {total_rows}-row "
                          f"request to its largest compiled bucket "
                          f"{bucket}; extend batch_buckets or use "
                          f"bucket_policy=auto", flush=True)
            self.bucket_counts[bucket] = self.bucket_counts.get(bucket, 0) + 1
            if len(group) > 1:
                self.coalesced_requests += len(group)
            if any(r.payload is not None for r in group):
                host = self._assemble_host(group, bucket)
            else:
                host = self._host_data[bucket]
            use_hc = self._hotcold is not None and self._hotcold_active
            # Drift tracking sees only the REAL request rows (the rest of
            # the bucket is warm-up-generator padding that would dilute
            # the live-coverage signal toward never triggering).
            real_rows = min(sum(r.batch_size for r in group), bucket)
            ingested = False
            if use_hc:
                # Honest host cost: the split runs per request (native C++
                # single-pass splitter), overlapped with device compute of
                # the previous request by the dispatch pipeline.
                split = self._hotcold.prepare(host)
                if self.serving_cfg.hotcold_refresh_interval > 0:
                    # May swap self._hotcold/self.params (same thread as
                    # every other reader of both — no race) BEFORE this
                    # dispatch, but the already-computed split stays valid:
                    # it was made against the pre-swap hot set, so re-run
                    # prepare if a refresh happened — or fall through to
                    # the direct path if the stream lost its head and the
                    # split was disabled.
                    ingested = True
                    if self._track_hotcold(host, split, real_rows):
                        if self._hotcold_active:
                            split = self._hotcold.prepare(host)
                        else:
                            use_hc = False
            # Fresh host->device transfer each execution: honest serving
            # cost (the reference re-feeds host blobs through BlobsQueues).
            # The hotcold dispatch strips the ragged mask: the host split
            # already consumed it, so the device program (and its compiled
            # executable) is the same for ragged and fixed-length traffic.
            if use_hc:
                dev_batch = self._device_batch(
                    host if host.mask is None else host._replace(mask=None))
                out = self._jitted[bucket](self.params, dev_batch,
                                           self._device_split(split))
            elif self._hotcold is not None:
                # Hotcold disabled at runtime (stream lost its popular
                # head): serve the plain fused gather, keep watching the
                # stream, re-enable when a head returns. The disabling
                # request was already ingested above — don't count it
                # twice.
                if (self.serving_cfg.hotcold_refresh_interval > 0
                        and not ingested):
                    self._track_direct(host, real_rows)
                out = self._direct_dispatch(self._device_batch(host))
            else:
                out = self._jitted[bucket](self.params,
                                           self._device_batch(host))
            queue_end = time.time()
            self._pending.put((group, out, queue_start, queue_end))

    def _completion_loop(self):
        while True:
            item = self._pending.get()
            if item is _SENTINEL:
                return
            group, out, queue_start, queue_end = item
            # Transfer the scores to host: a response is only complete when
            # the client could read it (the reference FetchBlobs the output
            # too, inferenceEngine.py:52-58). This is also exactly where a
            # device/runtime error surfaces. An
            # unhandled raise would kill this thread silently: the engine
            # would keep dispatching with no responses ever emitted while
            # still reporting alive.
            try:
                scores = np.asarray(out)
            except Exception as e:
                if self.error is None:
                    self.error = e
                print(f"[deeprecsys_tpu] WARNING: engine {self.engine_id} "
                      f"readback failed ({e!r}); answering {len(group)} "
                      f"request(s) with ERR_READBACK", flush=True)
                # Answer, don't drop: HTTP clients parked on the pending-
                # response event would otherwise hang until their own
                # client timeout (up to max_coalesce stranded per incident).
                for request in group:
                    self._emit_error(request, ERR_READBACK, queue_start)
                continue
            end = time.time()
            off = 0  # cumulative row offset — matches _assemble_host
            for request in group:
                # out_batch_size = executed rows attributable to THIS
                # request (reference measures the output blob,
                # inferenceEngine.py:52-58): a singleton owns the whole
                # padded execution; coalesced members report their own
                # share (summing bucket-size per member would overstate
                # the execution N-fold).
                out_rows = (int(scores.shape[0]) if len(group) == 1
                            else request.batch_size)
                # Real-inference requests get THEIR rows' scores back
                # (f32 for the wire — bf16 is an accumulator detail).
                own_scores = (
                    scores[off:off + request.batch_size].astype(np.float32)
                    if request.payload is not None else None)
                off += request.batch_size
                if (own_scores is not None and self.arena is not None
                        and getattr(request, "payload_slot", -1) >= 0):
                    # cpu-mp: the response POD cannot carry arrays — the
                    # scores go back through the request's arena slot
                    # (written BEFORE the response is pushed; the ring's
                    # release/acquire pair orders the bytes for the
                    # parent's read — blob_arena.py protocol).
                    try:
                        self.arena.write_scores(request.payload_slot,
                                                own_scores)
                    except Exception as e:
                        print(f"[deeprecsys_tpu] WARNING: engine "
                              f"{self.engine_id} failed to write scores to "
                              f"slot {request.payload_slot} ({e!r})",
                              flush=True)
                        self._emit_error(request, ERR_READBACK, queue_start)
                        continue
                self.response_q.put(
                    ServiceResponse(
                        consumer_id=self.engine_id,
                        epoch=request.epoch,
                        batch_id=request.batch_id,
                        batch_size=request.batch_size,
                        arrival_time=request.arrival_time,
                        queue_start_time=queue_start,
                        queue_end_time=queue_end,
                        inference_end_time=end,
                        out_batch_size=out_rows,
                        sub_id=request.sub_id,
                        total_sub_batches=request.total_sub_batches,
                        exp_packet=request.exp_packet,
                        scores=own_scores,
                    )
                )


class SimEngine(threading.Thread):
    """Latency-model engine: sleeps instead of computing.

    Reference: ``accelInferenceEngine.py`` — validates the model name,
    loads characterization data, and per request sleeps
    ``predict_time(model, batch)`` (:44-84). Used here both as the
    serving-test fake and as the "simulated accelerator" parity path.
    """

    def __init__(
        self,
        engine_id: int,
        model_cfg: ModelConfig,
        serving_cfg: ServingConfig,
        request_q: "queue.Queue",
        response_q: "queue.Queue",
        ready_q: "queue.Queue",
        latency_model: LatencyModel,
    ):
        super().__init__(name=f"sim-engine-{engine_id}", daemon=True)
        self.engine_id = engine_id
        self.request_q = request_q
        self.response_q = response_q
        self.ready_q = ready_q
        self.latency_model = latency_model
        self.expired_requests = 0

    def run(self):
        self.ready_q.put(self.engine_id)
        while True:
            request = self.request_q.get()
            if request is _SENTINEL:
                break
            queue_start = time.time()
            if request.deadline and queue_start > request.deadline:
                # Mirror ComputeEngine's pre-dispatch deadline drop so
                # hardware-free serving tests exercise the same contract.
                self.expired_requests += 1
                self.response_q.put(ServiceResponse(
                    consumer_id=self.engine_id, epoch=request.epoch,
                    batch_id=request.batch_id, batch_size=request.batch_size,
                    arrival_time=request.arrival_time,
                    queue_start_time=queue_start, queue_end_time=queue_start,
                    inference_end_time=queue_start, out_batch_size=0,
                    sub_id=request.sub_id,
                    total_sub_batches=request.total_sub_batches,
                    exp_packet=request.exp_packet, error_code=ERR_DEADLINE))
                continue
            # Serial sleep of the FULL per-request latency: the reference's
            # simulated accelerator does the same
            # (accelInferenceEngine.py:58-64).
            eval_ms = self.latency_model.predict_ms(request.batch_size)
            time.sleep(eval_ms / 1000.0)
            now = time.time()
            self.response_q.put(
                ServiceResponse(
                    consumer_id=self.engine_id,
                    epoch=request.epoch,
                    batch_id=request.batch_id,
                    batch_size=request.batch_size,
                    arrival_time=request.arrival_time,
                    queue_start_time=queue_start,
                    queue_end_time=now,
                    inference_end_time=now,
                    out_batch_size=request.batch_size,
                    sub_id=request.sub_id,
                    total_sub_batches=request.total_sub_batches,
                    exp_packet=request.exp_packet,
                )
            )
        self.response_q.put(_SENTINEL)


def build_engine_pool(
    model_cfg,
    cfg,
    request_q,
    accel_request_q,
    response_q,
    ready_q,
    latency_model=None,
    accel_latency_model=None,
    params=None,
    mesh=None,
    id_base: int = 0,
):
    """Build the thread-engine pool for a ServingConfig — the one place
    that knows backend dispatch (accel/cpu/sim), device selection, and the
    accel-offload engine wiring. Shared by ``orchestrator.run_serving``
    and the HTTP ingress (``serving/ingress.py``); cpu-mp OS-process
    engines are spawned separately (``process_engine``).

    Returns (engines, total_engine_count).
    """
    from deeprecsys_tpu.serving.buckets import resolve_buckets
    from deeprecsys_tpu.utils.devices import pick_accel_device

    def device_for_backend():
        if cfg.engine_backend == "cpu":
            return jax.devices("cpu")[0]
        return pick_accel_device()

    # Resolve the bucket ladder ONCE for the pool: it is deterministic in
    # the config, and autotuning re-samples the whole size distribution.
    buckets = resolve_buckets(cfg)
    engines = []
    for i in range(cfg.inference_engines):
        eid = id_base + i
        if cfg.engine_backend == "sim":
            if latency_model is None:
                raise ValueError("sim backend requires a latency_model")
            engines.append(SimEngine(eid, model_cfg, cfg, request_q, response_q,
                                     ready_q, latency_model))
        else:
            engines.append(
                ComputeEngine(eid, model_cfg, cfg, request_q, response_q, ready_q,
                              device=device_for_backend(), params=params,
                              seed=cfg.seed + eid, mesh=mesh, buckets=buckets,
                              strict_buckets=False))
    total = cfg.inference_engines
    if cfg.model_accel:
        aid = id_base + total
        if accel_latency_model is not None:
            engines.append(SimEngine(aid, model_cfg, cfg, accel_request_q,
                                     response_q, ready_q, accel_latency_model))
        elif cfg.engine_backend == "sim":
            # A hardware-free run must stay hardware-free: falling through
            # to the real offload engine would pay minutes of real warm-up
            # compiles and serve accel traffic on the device with no
            # warning — match the main-engine sim guard above.
            raise ValueError(
                "sim backend with model_accel requires an "
                "accel_latency_model (the offload engine would otherwise "
                "run on real hardware)")
        else:
            engines.append(
                ComputeEngine(aid, model_cfg, cfg, accel_request_q, response_q,
                              ready_q, device=pick_accel_device(), params=params,
                              seed=cfg.seed + aid, buckets=buckets,
                              strict_buckets=False))
        total += 1
    return engines, total
