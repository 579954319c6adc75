"""HTTP serving ingress.

The reference is single-node: queries enter only through its own load
generator (``loadGenerator.py``) over in-process ``multiprocessing.Queue``s,
and there is no external request API at all. For a production serving
deployment the framework needs an ingress so OTHER hosts can submit
queries; this module adds one without changing the serving stack's
dataflow: the HTTP front end plays the load generator's role (partition,
route, pace) and everything downstream — engines, buckets, coalescing,
accel offload — is the same machinery ``orchestrator.run_serving`` drives.

Stack (stdlib-only, no external RPC deps):

    HTTP client(s)  -- POST /v1/infer {"batch_size": N}
        |
    ThreadingHTTPServer (one handler thread per in-flight request)
        |
    ServingServer.submit(): partition into sub-requests, enqueue,
        block on a per-query Event until the router joins all sub-responses
        |
    engine request queue -> ComputeEngine/SimEngine threads -> response queue
        |
    router thread: matches (epoch, batch_id) -> wakes the handler

Endpoints:
  POST /v1/infer   {"batch_size": N, "exp": bool?} -> 200 JSON with the
                   reference's latency decomposition (queue wait, inference)
  GET  /v1/healthz -> {"status": "ok", model, engines, buckets}
  GET  /v1/stats   -> running QPS + p50/p95/p99 over completed queries
"""

from __future__ import annotations

import itertools
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from deeprecsys_tpu.config import ModelConfig, ServingConfig
from deeprecsys_tpu.serving.latency_model import LatencyModel
from deeprecsys_tpu.serving.load_generator import partition_query
from deeprecsys_tpu.serving.packets import ERR_DEADLINE, ServiceRequest


class InferenceError(RuntimeError):
    """An engine answered with an error response (readback failure,
    over-ladder rejection, expired deadline). ``code`` is the packets.py
    ERR_* constant — the HTTP layer maps ERR_DEADLINE to 504 and the rest
    to 500."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


class OverloadedError(RuntimeError):
    """The query was rejected for lack of transport capacity (blob-arena
    exhaustion: payload_arena_slots sub-requests already in flight).
    Retryable by the client — the HTTP layer maps it to 503, not 500
    (and never to a dropped connection, which a bare RuntimeError
    escaping the handler would produce)."""


class _Pending:
    """One submitted query awaiting its sub-batch responses."""

    __slots__ = ("remaining", "responses", "event")

    def __init__(self, n_sub: int):
        self.remaining = n_sub
        self.responses = []
        self.event = threading.Event()


class ServingServer:
    """Engine pool + response router with a synchronous ``submit`` API.

    Backend selection mirrors ``orchestrator.run_serving``: "accel"/"cpu"
    ComputeEngines or "sim" SimEngines, plus an optional accel engine for
    big-query offload (``model_accel``).
    """

    def __init__(
        self,
        model_cfg: ModelConfig,
        serving_cfg: ServingConfig,
        latency_model: LatencyModel | None = None,
        accel_latency_model: LatencyModel | None = None,
        params=None,
        checkpoint_path: str | None = None,
        mesh=None,
    ):
        import collections

        self.model_cfg = model_cfg
        self.cfg = serving_cfg

        self._batch_ids = itertools.count()
        self._pending: dict[tuple, _Pending] = {}
        self._lock = threading.Lock()
        # Bounded window: a long-running server must not grow its stats
        # without limit; percentiles are over the most recent completions.
        self._completed_ms = collections.deque(maxlen=100_000)
        self._n_completed = 0
        self._t_start: float | None = None
        self._stop = threading.Event()
        self.procs: list = []
        self._cleanup = None
        # Router-thread arena-guard trips (double free / out-of-range):
        # counted and surfaced in /v1/healthz instead of killing the
        # router.
        self.arena_faults = 0
        self.accel_request_q: queue.Queue = queue.Queue(maxsize=32)

        cfg = serving_cfg
        self.engines = []
        if mesh is not None and cfg.engine_backend == "cpu-mp":
            # Mesh engines are thread engines jitted over the device mesh;
            # a per-OS-process mesh would shard each child over the SAME
            # chips, multiplying nothing.
            raise NotImplementedError("mesh with cpu-mp ingress")
        if cfg.engine_backend == "cpu-mp":
            # Reference-topology OS-process engines over native shm rings
            # (process_engine.py). With model_accel this is the
            # reference's CANONICAL topology — N CPU engine processes
            # PLUS the accel engine (DeepRecSys.py:62-66): the accel
            # engine lives in the PARENT process (a SimEngine computes
            # nothing — no shm payload needed; a real offload engine owns
            # the parent's device) fed by the in-process accel queue,
            # with its own response queue drained by a second router.
            if params is not None:
                # A loaded pytree cannot cross the POD rings; silently
                # random-initializing the children while the caller
                # believes trained weights are serving would be worse
                # than failing here.
                raise ValueError(
                    "cpu-mp engines cannot take a params pytree; pass "
                    "checkpoint_path= instead (each child loads it)")
            from deeprecsys_tpu.serving.process_engine import spawn_process_engines

            (self.request_q, self.response_q, self.ready_q,
             self.procs, self._cleanup,
             self._control_rings, self._arena) = spawn_process_engines(
                 model_cfg, cfg, checkpoint_path=checkpoint_path)
            self.n_engines = cfg.inference_engines
            self._mp_reload: dict[tuple, object] = {}  # (engine, gen) -> handle
            self._mp_send_lock = threading.Lock()
            # Real-inference payloads over the blob arena: slot ownership
            # per in-flight sub-request, (epoch, batch_id, sub_id) -> slot.
            # The router frees a slot when ITS response arrives (success,
            # error, or straggler-after-timeout alike).
            self._slot_owners: dict[tuple, int] = {}
            self._router = threading.Thread(target=self._route_loop, daemon=True,
                                            name="ingress-router")
            if cfg.model_accel:
                from deeprecsys_tpu.serving.engine import (
                    ComputeEngine,
                    SimEngine,
                )

                self._accel_resp_q: queue.Queue = queue.Queue()
                self._accel_ready_q: queue.Queue = queue.Queue()
                aid = cfg.inference_engines
                if accel_latency_model is not None:
                    accel = SimEngine(aid, model_cfg, cfg,
                                      self.accel_request_q,
                                      self._accel_resp_q,
                                      self._accel_ready_q,
                                      accel_latency_model)
                else:
                    from deeprecsys_tpu.serving.buckets import resolve_buckets
                    from deeprecsys_tpu.utils.devices import pick_accel_device

                    accel_params = None
                    if checkpoint_path:
                        # Children load the checkpoint in-child; the
                        # parent-side accel engine must serve the same
                        # weights.
                        from deeprecsys_tpu.utils.checkpoint import (
                            load_model_params,
                        )

                        accel_params = load_model_params(model_cfg,
                                                         checkpoint_path)
                    accel = ComputeEngine(
                        aid, model_cfg, cfg, self.accel_request_q,
                        self._accel_resp_q, self._accel_ready_q,
                        device=pick_accel_device(), params=accel_params,
                        seed=cfg.seed + aid,
                        buckets=resolve_buckets(cfg),
                        strict_buckets=False)
                self.engines = [accel]
                self.n_engines = cfg.inference_engines + 1
                self._accel_router = threading.Thread(
                    target=self._accel_route_loop, daemon=True,
                    name="ingress-accel-router")
            return

        self.request_q = queue.Queue(maxsize=1024)
        self.response_q = queue.Queue()
        self.ready_q = queue.Queue()
        if params is None and checkpoint_path:
            from deeprecsys_tpu.utils.checkpoint import load_model_params

            params = load_model_params(model_cfg, checkpoint_path)
        from deeprecsys_tpu.serving.engine import build_engine_pool

        self.engines, self.n_engines = build_engine_pool(
            model_cfg, cfg, self.request_q, self.accel_request_q,
            self.response_q, self.ready_q, latency_model, accel_latency_model,
            params, mesh=mesh)

        self._router = threading.Thread(target=self._route_loop, daemon=True,
                                        name="ingress-router")

    # -- lifecycle ------------------------------------------------------

    def start(self, timeout: float = 300.0):
        for e in self.engines:
            e.start()
        # cpu-mp: the shm ready ring carries the CHILD readiness signals;
        # the parent-side accel engine (if any) reports separately below.
        n_wait = len(self.procs) if self.procs else self.n_engines
        for _ in range(n_wait):
            got = self.ready_q.get(timeout=timeout)
            if isinstance(got, Exception):
                raise RuntimeError("engine failed during warm-up") from got
        if getattr(self, "_accel_ready_q", None) is not None:
            # cpu-mp + model_accel: the parent-side accel engine reports
            # on its own queue (the shm ready ring belongs to the
            # children).
            got = self._accel_ready_q.get(timeout=timeout)
            if isinstance(got, Exception):
                raise RuntimeError(
                    "accel engine failed during warm-up") from got
            self._accel_router.start()
        self._router.start()
        self._t_start = time.time()

    def stop(self):
        # Idempotent: HttpIngress.stop() stops its registry's servers, and
        # callers commonly stop their server again right after — on the
        # cpu-mp backend a second stop would push the shutdown sentinel
        # into an already-unmapped native shm ring (historically a
        # segfault; the ring now raises, found by tools/cpu_mp_soak.py).
        # CAS under the lock: two CONCURRENT stops must not both proceed
        # (double sentinels + cleanup racing the other's engine joins).
        with self._lock:
            if getattr(self, "_stopped", False):
                return
            self._stopped = True
        for e in self.engines:
            q = self.accel_request_q if getattr(e, "request_q", None) is self.accel_request_q \
                else self.request_q
            q.put(None)
        for _ in self.procs:
            self.request_q.put(None)
        for e in self.engines:
            e.join(timeout=30)
        # Stop the router BEFORE tearing down shm (it polls the ring).
        self._stop.set()
        if self._router.is_alive():
            self._router.join(timeout=5)
        accel_router = getattr(self, "_accel_router", None)
        if accel_router is not None and accel_router.is_alive():
            accel_router.join(timeout=5)
        if self._cleanup is not None:
            self._cleanup()

    # -- request path ---------------------------------------------------

    def submit(self, batch_size: int, exp: bool = False, timeout: float = 60.0,
               deadline_ms: float | None = None) -> dict:
        """Submit one query; block until all its sub-batches complete.

        Returns the reference's per-query latency decomposition
        (DeepRecSys.py:101-123 joins sub-batches the same way: min arrival,
        max inference end).

        ``deadline_ms`` (relative to arrival) propagates onto every
        sub-request: engines drop expired requests BEFORE dispatch (no
        device time burnt) and this call raises InferenceError(ERR_DEADLINE)
        — surfaced as HTTP 504.
        """
        batch_size = max(1, min(int(batch_size), self.cfg.max_mini_batch_size))
        return self._run_query(batch_size, exp, timeout, deadline_ms, None)

    def predict(self, indices=None, dense=None, timeout: float = 60.0,
                deadline_ms: float | None = None, lengths=None,
                values=None) -> dict:
        """Real inference: run the model on CLIENT-SUPPLIED features and
        return their scores (the reference has no such path — its engines
        only ever run pre-generated synthetic rows sliced per request,
        inferenceEngine.py:200-206).

        ``indices``: (B, T, L) per-table-local ids; ``dense``: (B,
        dense_dim) floats (required iff the model takes dense features).
        The query rides the SAME serving fabric as load-modeling traffic —
        partitioned into sub-batches, coalesced, bucket-padded — and the
        result dict adds ``scores`` (B x out_dim lists, f32). Compute
        backends only: thread engines carry the features in-process;
        cpu-mp engines carry them through the shared blob arena
        (runtime/blob_arena.py — the POD ring itself moves only the slot
        id). Sim engines compute nothing and stay refused."""
        import numpy as np

        from deeprecsys_tpu.models.base import Batch

        if self.cfg.engine_backend not in ("accel", "cpu", "cpu-mp"):
            raise NotImplementedError(
                f"predict needs compute engines; backend "
                f"{self.cfg.engine_backend!r} cannot return scores")
        m = self.model_cfg
        # Ragged form (the reference's lengths+indices CSR,
        # dlrm_s_caffe2.py lengths queues): "lengths" (B, T) with either
        # flat "values" (true CSR) or padded "indices" whose slots beyond
        # each length are ignored. Converted to padded indices + slot
        # mask (data/ragged.py); the masked bag is exact
        # SparseLengthsSum-with-variable-lengths semantics.
        mask = None
        if lengths is not None:
            if not self.cfg.accept_ragged:
                raise NotImplementedError(
                    "ragged requests need accept_ragged=True on the "
                    "serving config (engines then pre-warm the masked "
                    "programs)")
            from deeprecsys_tpu.data.ragged import lengths_to_mask, pad_csr

            if values is not None:
                if indices is not None:
                    raise ValueError("pass either 'values' (flat CSR) or "
                                     "'indices' (padded), not both")
                indices, mask = pad_csr(lengths, values,
                                        m.num_indices_per_lookup)
            else:
                if indices is None:
                    raise ValueError("'lengths' needs 'values' (flat CSR) "
                                     "or padded 'indices'")
                mask = lengths_to_mask(np.asarray(lengths),
                                       m.num_indices_per_lookup)
                # Ignore slot content beyond each group's length (clients
                # may leave junk there): zero is always a valid row id.
                indices = np.where(mask, np.asarray(indices), 0)
        elif values is not None:
            raise ValueError("'values' requires 'lengths'")
        if indices is None:
            raise ValueError("'indices' ((B, T, L) ids) is required")
        idx = np.asarray(indices)  # raises on ragged nesting
        if idx.dtype.kind == "f":
            # JSON serializers commonly emit ids as floats (1.0): accept
            # exact integers, but never TRUNCATE — 1.9 -> 1 would silently
            # return scores for the wrong embedding rows.
            if not np.isfinite(idx).all() or (idx != np.floor(idx)).any():
                raise ValueError(
                    "indices must be integer ids (got non-integral floats)")
        elif idx.dtype.kind not in "iu":
            raise ValueError(
                f"indices must be integer ids; got dtype {idx.dtype}")
        T, L = m.num_tables, m.num_indices_per_lookup
        if idx.ndim != 3 or idx.shape[1:] != (T, L) or idx.shape[0] < 1:
            raise ValueError(
                f"indices must have shape (B, {T}, {L}) with B >= 1 for "
                f"model {m.model_name!r}; got {idx.shape}")
        if mask is not None and mask.shape != idx.shape:
            raise ValueError(
                f"lengths must have shape (B, {T}) matching the batch; "
                f"got mask shape {mask.shape} vs indices {idx.shape}")
        if idx.shape[0] > self.cfg.max_mini_batch_size:
            raise ValueError(
                f"batch {idx.shape[0]} exceeds max_mini_batch_size "
                f"{self.cfg.max_mini_batch_size}")
        rows = np.asarray(m.scaled_rows, dtype=np.int64)[None, :, None]
        # Range-check BEFORE the int32 cast: an id >= 2**31 would wrap and
        # could pass the bound check after truncation.
        if (idx < 0).any() or (idx >= rows).any():
            raise ValueError(
                "indices out of range: each id must satisfy "
                "0 <= id < rows(table) (per-table-local ids)")
        idx = idx.astype(np.int32)
        if m.dense_dim > 0:
            if dense is None:
                raise ValueError(
                    f"model {m.model_name!r} takes a (B, {m.dense_dim}) "
                    f"dense input; 'dense' is required")
            dense = np.asarray(dense, dtype=np.float32)
            if dense.shape != (idx.shape[0], m.dense_dim):
                raise ValueError(
                    f"dense must have shape ({idx.shape[0]}, {m.dense_dim});"
                    f" got {dense.shape}")
        elif dense is not None:
            raise ValueError(f"model {m.model_name!r} takes no dense input")
        else:
            dense = None
        result, rs = self._run_query(
            idx.shape[0], False, timeout, deadline_ms,
            Batch(dense=dense, indices=idx, mask=mask), want_responses=True)
        rs = sorted(rs, key=lambda r: r.sub_id)
        result["scores"] = np.concatenate([r.scores for r in rs],
                                          axis=0).tolist()
        return result

    def _run_query(self, batch_size: int, exp: bool, timeout: float,
                   deadline_ms: float | None, payload,
                   want_responses: bool = False):
        cfg = self.cfg
        batch_id = next(self._batch_ids)
        arrival = time.time()
        deadline = arrival + deadline_ms / 1000.0 if deadline_ms else 0.0

        # Payload queries stay on the main pool: the accel slot may be a
        # SimEngine (latency model only), which cannot produce scores.
        to_accel = (payload is None and cfg.model_accel
                    and batch_size >= cfg.accel_request_size_thres)
        chunks = [batch_size] if to_accel else partition_query(batch_size, cfg.sub_task_batch_size)
        key = (0, batch_id, exp)
        pend = _Pending(len(chunks))
        with self._lock:
            self._pending[key] = pend
        target_q = self.accel_request_q if to_accel else self.request_q
        use_arena = payload is not None and getattr(self, "_arena", None) is not None
        off = 0
        for sub_id, chunk in enumerate(chunks):
            sub_payload = None
            slot = -1
            if payload is not None:
                from deeprecsys_tpu.models.base import Batch

                sub = Batch(
                    dense=(None if payload.dense is None
                           else payload.dense[off:off + chunk]),
                    indices=payload.indices[off:off + chunk],
                    mask=(None if payload.mask is None
                          else payload.mask[off:off + chunk]))
                off += chunk
                if use_arena:
                    # cpu-mp: features travel through the blob arena; the
                    # POD request carries only the slot id. Arena
                    # exhaustion (too many payload queries in flight)
                    # fails THIS query loudly; sub-requests already sent
                    # resolve as stragglers and the router frees their
                    # slots.
                    try:
                        slot = self._arena.alloc()
                    except RuntimeError as e:
                        with self._lock:
                            self._pending.pop(key, None)
                        raise OverloadedError(str(e)) from e
                    try:
                        self._arena.write_batch(slot, sub.indices, sub.dense,
                                                mask=sub.mask)
                    except Exception:
                        # Staging failed (e.g. a payload outgrowing the
                        # slot): return the slot — an unfreed slot here
                        # leaks capacity for the server's lifetime.
                        self._arena.free(slot)
                        with self._lock:
                            self._pending.pop(key, None)
                        raise
                    with self._lock:
                        self._slot_owners[(0, batch_id, sub_id)] = slot
                else:
                    sub_payload = sub
            target_q.put(ServiceRequest(
                batch_id=batch_id, epoch=0, arrival_time=arrival, batch_size=chunk,
                sub_id=sub_id, total_sub_batches=len(chunks), exp_packet=exp,
                deadline=deadline, payload=sub_payload, payload_slot=slot))
        if not pend.event.wait(timeout):
            with self._lock:
                # Re-check under the lock: the router may have delivered
                # the last sub-response between the wait expiring and here
                # — a query that completed in time must not 504.
                if not pend.event.is_set():
                    self._pending.pop(key, None)
                    raise TimeoutError(
                        f"query {batch_id} timed out after {timeout}s")

        rs = pend.responses
        errs = [r for r in rs if r.error_code]
        if errs:
            # Any failed sub-batch fails the query: partial scores are not
            # a result. ERR_DEADLINE dominates the report (the client's
            # budget expired; other codes are server faults).
            first = next((r for r in errs if r.error_code == ERR_DEADLINE),
                         errs[0])
            raise InferenceError(
                first.error_code,
                f"query {batch_id}: {len(errs)}/{len(rs)} sub-batch(es) "
                f"failed: {first.error_message()}")
        end = max(r.inference_end_time for r in rs)
        queue_start = min(r.queue_start_time for r in rs)
        latency_ms = (end - arrival) * 1000.0
        if not exp:
            with self._lock:
                self._completed_ms.append(latency_ms)
                self._n_completed += 1
        result = {
            "batch_id": batch_id,
            "batch_size": batch_size,
            "sub_batches": len(chunks),
            "accel": bool(to_accel),
            "latency_ms": latency_ms,
            "queue_wait_ms": max(queue_start - arrival, 0.0) * 1000.0,
            "inference_ms": max(end - queue_start, 0.0) * 1000.0,
            "engines": sorted({r.consumer_id for r in rs}),
        }
        return (result, rs) if want_responses else result

    def _route_loop(self):
        from deeprecsys_tpu.runtime import Empty as ShmEmpty
        from deeprecsys_tpu.serving.packets import RELOAD_ACK_BATCH_ID
        while not self._stop.is_set():
            try:
                r = self.response_q.get(timeout=0.2)
            except (queue.Empty, ShmEmpty):
                continue
            if r is None:  # an engine exited
                continue
            if r.batch_id == RELOAD_ACK_BATCH_ID:
                # cpu-mp reload ACK: sub_id echoes the request's gen tag,
                # so this resolves the handle whose request was applied —
                # a superseding reload's ACK cannot resolve the wrong one.
                with self._lock:
                    h = getattr(self, "_mp_reload", {}).pop(
                        (r.consumer_id, r.sub_id), None)
                if h is not None:
                    if r.error_code:
                        h.error = RuntimeError(
                            f"engine process {r.consumer_id} reload failed "
                            f"(its stderr has the exception)")
                    h.event.set()
                continue
            self._ingest_response(r)

    def _accel_route_loop(self):
        """cpu-mp accel rejoin: the parent-side accel engine answers on a
        plain in-process queue (its requests never ride the shm rings);
        same rejoin as the main router. Thread mode needs no twin — there
        the accel engine shares the pool's response queue."""
        while not self._stop.is_set():
            try:
                r = self._accel_resp_q.get(timeout=0.2)
            except queue.Empty:
                continue
            if r is None:
                continue
            self._ingest_response(r)

    def _ingest_response(self, r):
        if getattr(self, "_slot_owners", None):
            # cpu-mp payload response: the scores came back through
            # the request's arena slot (written before the ring push —
            # release/acquire orders the bytes). Hydrate r.scores and
            # return the slot, whether this response is a success, an
            # engine error, or a straggler of a timed-out query.
            with self._lock:
                slot = self._slot_owners.pop(
                    (r.epoch, r.batch_id, r.sub_id), None)
            if slot is not None:
                if not r.error_code:
                    try:
                        r.scores = self._arena.read_scores(slot)
                    except Exception as e:
                        from deeprecsys_tpu.serving.packets import (
                            ERR_READBACK,
                        )

                        print(f"[deeprecsys_tpu] WARNING: arena slot "
                              f"{slot} readback failed ({e!r})",
                              flush=True)
                        r.error_code = ERR_READBACK
                try:
                    self._arena.free(slot)
                except Exception:
                    # The arena's double-free / out-of-range guards
                    # raise on purpose — but this is the daemon router
                    # thread: an unhandled raise here would kill it
                    # silently and turn every later query into an
                    # undiagnosed 504. Keep the failure LOUD and the
                    # router ALIVE: full traceback + a counter that
                    # /v1/healthz reports.
                    import traceback

                    self.arena_faults += 1
                    print(f"[deeprecsys_tpu] ERROR: arena free({slot}) "
                          f"raised in the router thread (arena_faults="
                          f"{self.arena_faults}):\n"
                          f"{traceback.format_exc()}", flush=True)
        key = (r.epoch, r.batch_id, r.exp_packet)
        with self._lock:
            pend = self._pending.get(key)
            if pend is None:
                return  # timed-out query's stragglers
            pend.responses.append(r)
            pend.remaining -= 1
            if pend.remaining == 0:
                del self._pending[key]
                pend.event.set()

    # -- model management -----------------------------------------------

    def reload(self, path: str) -> list:
        """Zero-downtime checkpoint swap: schedule a reload on every
        compute engine (each applies it atomically before the next
        request it serves — see ``ComputeEngine.request_reload``).
        Returns the per-engine ReloadHandles; callers may wait on their
        events or poll ``reload_status``. Sim engines have no params and
        are skipped. cpu-mp process engines reload over their per-engine
        control rings (path shipped as 64-byte POD fragments, applied
        in-child, ACKed on the response ring)."""
        if self.cfg.engine_backend == "cpu-mp":
            return self._reload_mp(path)
        targets = [e for e in self.engines if hasattr(e, "request_reload")]
        if not targets:
            raise NotImplementedError(
                "reload needs in-process compute engines (backend "
                f"{self.cfg.engine_backend!r} has none)")
        handles = [e.request_reload(path) for e in targets]
        # Publish under the lock: ThreadingHTTPServer runs handlers in
        # parallel, and an unlocked assignment raced concurrent reloads
        # into a stale/mixed reload_status snapshot.
        with self._lock:
            self._reload_handles = handles
        return handles

    def _reload_mp(self, path: str) -> list:
        """cpu-mp reload: ship the path to every engine process over its
        control ring. Unlike the thread-engine slot (where a newer request
        supersedes a pending one), fragments already on a ring cannot be
        un-sent — every shipped request WILL be applied in order, so each
        gets its own generation tag and each engine ACK resolves exactly
        the handle whose request it answers (the last-applied reload's
        params win, matching the thread-path contract).

        The WHOLE send side runs under one ``_mp_send_lock`` section (gen
        allocation -> fragment building -> handle registration ->
        shipping), for two reasons beyond fragment-tearing: (a)
        ``reload_fragments`` raises on paths over 255*58 bytes, and it
        must do so BEFORE any handle is registered — an orphan handle
        would report 'scheduled' forever and hang its waiters; (b) with
        gen allocation and shipping in separate critical sections, two
        concurrent reload() calls could invert ring order vs handle
        order, making the older request's params win while
        ``reload_status`` reports the newer — serializing the section
        makes the later gen also the later on every ring."""
        from deeprecsys_tpu.runtime.shm_queue import reload_fragments
        from deeprecsys_tpu.serving.engine import ReloadHandle

        with self._mp_send_lock:
            with self._lock:
                gen = self._mp_reload_gen = (
                    getattr(self, "_mp_reload_gen", 0) % 255) + 1
            frags = reload_fragments(path, gen=gen)  # may raise: no handles yet
            with self._lock:
                handles = []
                for eid, ring in enumerate(self._control_rings):
                    h = ReloadHandle(path)
                    h.engine_id, h.gen = eid, gen  # reload_status liveness
                    self._mp_reload[(eid, gen)] = h
                    handles.append((eid, ring, h))
                self._reload_handles = [h for _, _, h in handles]
            for eid, ring, h in handles:
                if eid < len(self.procs) and not self.procs[eid].is_alive():
                    # Dead engine: its ring would swallow ~64 fragments
                    # without ever ACKing — resolve the handle NOW so
                    # waiters and reload_status see the failure instead
                    # of a forever-'scheduled' reload.
                    with self._lock:
                        self._mp_reload.pop((eid, gen), None)
                    h.error = RuntimeError(
                        f"engine process {eid} is not alive; reload not "
                        f"delivered")
                    h.event.set()
                    continue
                try:
                    for f in frags:
                        ring.put(f, timeout=5.0)
                except TimeoutError as e:
                    # Ring full (engine wedged): resolve THIS handle now —
                    # nothing will ever ACK it — and keep shipping to the
                    # other engines.
                    with self._lock:
                        self._mp_reload.pop((eid, gen), None)
                    h.error = RuntimeError(
                        f"engine process {eid} control ring full "
                        f"({e}); reload not delivered")
                    h.event.set()
        out = [h for _, _, h in handles]
        # Parent-side accel engine (cpu-mp + model_accel with a REAL
        # offload engine): reload it through the thread-engine slot so
        # the accel path serves the same weights as the children. Sim
        # accel engines have no params and no request_reload.
        accel_handles = [e.request_reload(path) for e in self.engines
                         if hasattr(e, "request_reload")]
        if accel_handles:
            out = out + accel_handles
            with self._lock:
                self._reload_handles = list(self._reload_handles) + accel_handles
        return out

    def reload_status(self) -> dict:
        """{scheduled, applied, failed, errors} for the last reload()."""
        with self._lock:
            handles = list(getattr(self, "_reload_handles", []))
        # cpu-mp: a handle whose engine died AFTER delivery will never be
        # ACKed — resolve it here so the status cannot report a reload
        # stuck in 'scheduled' forever.
        suspects = [h for h in handles
                    if getattr(h, "engine_id", None) is not None
                    and not h.event.is_set()
                    and h.engine_id < len(self.procs)
                    and not self.procs[h.engine_id].is_alive()]
        if suspects:
            # Grace for the router: the engine may have ACKed and THEN
            # exited, with the ACK still undrained on the response ring —
            # resolving now would misreport an applied reload as failed.
            # The router polls every 0.2 s; one wait covers several laps.
            suspects[0].event.wait(0.75)
        for h in suspects:
            # Ownership CAS: popping the (engine, gen) entry from
            # _mp_reload under the lock is the ONE resolution token —
            # the router pops the same key before it touches a handle, so
            # whichever side gets the entry resolves it and the other
            # backs off. Without this, the router could drain a
            # successful ACK between our is_set() check and the error
            # assignment and we would overwrite an applied reload with
            # 'died before ACKing'.
            with self._lock:
                claimed = self._mp_reload.pop(
                    (h.engine_id, h.gen), None) is not None
            if not claimed:
                continue  # the router owns (or already resolved) it
            h.error = RuntimeError(
                f"engine process {h.engine_id} died before ACKing the "
                f"reload")
            h.event.set()
        applied = [h for h in handles if h.event.is_set() and h.error is None]
        failed = [h for h in handles if h.event.is_set() and h.error is not None]
        return {"scheduled": len(handles), "applied": len(applied),
                "failed": len(failed),
                "errors": [f"{h.path}: {h.error!r}" for h in failed]}

    # -- metrics --------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            lat = list(self._completed_ms)
            total = self._n_completed
        wall = time.time() - self._t_start if self._t_start else float("nan")
        out = {"completed": total, "wall_s": wall,
               "qps": total / wall if wall and wall > 0 else 0.0}
        if lat:
            out.update(p50_ms=float(np.percentile(lat, 50)),
                       p95_ms=float(np.percentile(lat, 95)),
                       p99_ms=float(np.percentile(lat, 99)))
        return out


def _health(server: ServingServer) -> dict:
    buckets = (getattr(server.engines[0], "buckets", None)
               if server.engines else None)
    live = sum(1 for e in server.engines if e.is_alive()) + \
        sum(1 for p in server.procs if p.is_alive())
    degraded = live < server.n_engines
    out = {"status": "degraded" if degraded else "ok",
           "model": server.model_cfg.model_type,
           "engines": server.n_engines, "live_engines": live,
           "buckets": list(buckets) if buckets else None}
    counts = {}
    for e in server.engines:
        # Snapshot: the engine thread may insert a new bucket key while we
        # iterate (dict() of a mutating dict is safe; iteration is not).
        for b, c in dict(getattr(e, "bucket_counts", {})).items():
            counts[b] = counts.get(b, 0) + c
    if counts:
        out["bucket_executions"] = {str(k): v for k, v in sorted(counts.items())}
    clamped = sum(getattr(e, "clamped_requests", 0) for e in server.engines)
    if clamped:
        out["clamped_requests"] = clamped  # undercomputed at the ladder cap
    expired = sum(getattr(e, "expired_requests", 0) for e in server.engines)
    if expired:
        out["expired_requests"] = expired  # deadline drops (pre-dispatch)
    rejected = sum(getattr(e, "rejected_requests", 0) for e in server.engines)
    if rejected:
        out["rejected_requests"] = rejected  # strict over-ladder rejections
    arena = getattr(server, "_arena", None)
    if arena is not None:
        # cpu-mp payload transport health: slots currently staged for
        # in-flight /v1/predict sub-requests. A value stuck at n_slots
        # means exhaustion (clients see 500s); one that creeps without
        # traffic means leaked slots (an engine died mid-payload).
        out["payload_slots_in_flight"] = arena.in_flight()
        out["payload_slots_total"] = arena.n_slots
        if server.arena_faults:
            # Router-thread arena-guard trips (double free/out-of-range):
            # the router stays alive, but each trip is a real protocol
            # bug — any nonzero value deserves a look at the server log.
            out["status"] = "degraded"
            out["arena_faults"] = server.arena_faults
    # Which lookup implementation each compute engine actually chose
    # (embedding_impl="auto" decides per engine from its sampled stream) —
    # an operator diagnosing latency needs to see the decision, not just
    # the config.
    impls = []
    for e in server.engines:
        if hasattr(e, "_hotcold"):
            active = (e._hotcold is not None
                      and getattr(e, "_hotcold_active", True))
            entry = {
                "engine": e.engine_id,
                # "direct (hotcold disabled)": the split was turned off at
                # runtime because the stream lost its popular head; the
                # engine keeps watching and may re-enable.
                "impl": ("hotcold" if active else
                         "direct (hotcold disabled)" if e._hotcold is not None
                         else "direct"),
                "hot_coverage": (round(e.hot_coverage, 4)
                                 if e.hot_coverage is not None else None)}
            if e._hotcold is not None and getattr(
                    e.serving_cfg, "hotcold_refresh_interval", 0) > 0:
                # Adaptive refresh telemetry: the windowed LIVE hit rate
                # vs the (re-baselined) reference, and how many times the
                # hot set was re-derived under drift.
                entry["live_hot_coverage"] = (
                    round(e.live_hot_coverage, 4)
                    if e.live_hot_coverage is not None else None)
                entry["hot_refreshes"] = e.hot_refreshes
            impls.append(entry)
    if impls:
        out["embedding_impl"] = impls
    return out


def _prometheus(registry: dict[str, ServingServer]) -> str:
    """Text exposition (Prometheus 0.0.4) of every model's serving state —
    the pull-based twin of /v1/healthz + /v1/stats, so operators scrape
    the framework with stock tooling instead of polling JSON. An
    addition (the reference's only observability is stdout prints and a
    per-response log file, DeepRecSys.py:143-175)."""
    lines = []

    def metric(name, mtype, help_text, samples):
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {mtype}")
        for labels, value in samples:
            lab = ",".join(f'{k}="{v}"' for k, v in labels.items())
            lines.append(f"{name}{{{lab}}} {value}")

    per_model = {name: (_health(s), s.stats()) for name, s in registry.items()}

    def across(fn):
        return [({"model": n}, fn(h, st)) for n, (h, st) in per_model.items()]

    metric("drs_up", "gauge", "1 when every engine is live, else 0",
           across(lambda h, st: 1 if h["status"] == "ok" else 0))
    metric("drs_engines_live", "gauge", "live engine threads/processes",
           across(lambda h, st: h["live_engines"]))
    metric("drs_engines_total", "gauge", "configured engines",
           across(lambda h, st: h["engines"]))
    metric("drs_queries_completed_total", "counter",
           "completed (non-warm-up) queries",
           across(lambda h, st: st["completed"]))
    metric("drs_qps", "gauge", "completed queries per second since start",
           across(lambda h, st: st["qps"]))
    for q in ("p50", "p95", "p99"):
        metric(f"drs_query_latency_{q}_ms", "gauge",
               f"{q} query latency over the recent completion window (ms)",
               across(lambda h, st, q=q: st.get(f"{q}_ms", float("nan"))))
    for counter, help_text in (
            ("clamped_requests", "requests undercomputed at a static ladder cap"),
            ("expired_requests", "deadline-expired requests dropped pre-dispatch"),
            ("rejected_requests", "over-ladder requests answered with an error"),
    ):
        metric(f"drs_{counter}_total", "counter", help_text,
               across(lambda h, st, c=counter: h.get(c, 0)))
    metric("drs_coalesced_requests_total", "counter",
           "requests served inside a multi-request coalesced execution",
           [({"model": n},
             sum(getattr(e, "coalesced_requests", 0) for e in s.engines))
            for n, s in registry.items()])
    # Adaptive hot-set refresh telemetry (only for engines running the
    # hotcold path with tracking enabled — absent series otherwise, the
    # Prometheus idiom for "not applicable").
    refresh_samples, live_cov_samples = [], []
    for n, s in registry.items():
        for e in s.engines:
            if (getattr(e, "_hotcold", None) is not None
                    and getattr(e.serving_cfg, "hotcold_refresh_interval", 0) > 0):
                labels = {"model": n, "engine": e.engine_id}
                refresh_samples.append((labels, e.hot_refreshes))
                if e.live_hot_coverage is not None:
                    live_cov_samples.append((labels, round(e.live_hot_coverage, 4)))
    if refresh_samples:
        metric("drs_hot_set_refreshes_total", "counter",
               "adaptive hot-set re-derivations under popularity drift",
               refresh_samples)
    if live_cov_samples:
        metric("drs_live_hot_coverage", "gauge",
               "windowed live hot-set hit rate (hotcold engines)",
               live_cov_samples)
    bucket_samples = []
    for n, (h, _) in per_model.items():
        for b, c in (h.get("bucket_executions") or {}).items():
            bucket_samples.append(({"model": n, "bucket": b}, c))
    if bucket_samples:
        metric("drs_bucket_executions_total", "counter",
               "device executions per compiled batch bucket", bucket_samples)
    arena_samples = [({"model": n}, h["payload_slots_in_flight"])
                     for n, (h, _) in per_model.items()
                     if "payload_slots_in_flight" in h]
    if arena_samples:
        metric("drs_payload_slots_in_flight", "gauge",
               "cpu-mp blob-arena slots staged for in-flight predict "
               "sub-requests (stuck at total = exhaustion; creeping "
               "without traffic = leak)", arena_samples)
    return "\n".join(lines) + "\n"


def _make_handler(registry: dict[str, ServingServer], default: str,
                  reload_guard=None):
    """Routes: the single-model endpoints act on the ``default`` model;
    ``/v1/models`` lists the registry and ``/v1/models/<name>/infer``
    targets one — several model families can share the chip (engines are
    threads; XLA time-slices their programs).

    ``reload_guard(path) -> str | None`` vets checkpoint paths for the
    reload routes; a non-None message is returned to the client as 403."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_json_body(self):
            """Parse the request body as a JSON object; sends the 400 and
            returns None on any malformed input (shared by every POST
            route so the error handling cannot drift between them)."""
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(payload, dict):
                    raise ValueError("body must be a JSON object")
                return payload
            except (ValueError, TypeError, json.JSONDecodeError,
                    AttributeError) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return None

        @staticmethod
        def _parse_deadline(payload):
            """deadline_ms from a request body: None or a positive float.
            One definition for every POST route — /v1/infer and /v1/predict
            must never drift in deadline semantics."""
            deadline_ms = payload.get("deadline_ms")
            if deadline_ms is not None:
                deadline_ms = float(deadline_ms)
                if deadline_ms <= 0:
                    raise ValueError("deadline_ms must be > 0")
            return deadline_ms

        def _model_route(self, suffix: str):
            """Resolve ``/v1/models/<name>/<suffix>`` to its server.
            Sends the 404 and returns None for unknown model names."""
            name = self.path[len("/v1/models/"):-len("/" + suffix)]
            server = registry.get(name)
            if server is None:
                self._json(404, {"error": f"unknown model {name!r}; "
                                          f"have {sorted(registry)}"})
            return server

        def do_GET(self):
            if self.path == "/metrics":
                body = _prometheus(registry).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/v1/healthz":
                self._json(200, _health(registry[default]))
            elif self.path == "/v1/stats":
                self._json(200, registry[default].stats())
            elif self.path == "/v1/models":
                self._json(200, {name: _health(s) for name, s in registry.items()})
            elif self.path == "/v1/reload":
                self._json(200, registry[default].reload_status())
            elif (self.path.startswith("/v1/models/")
                  and self.path.endswith("/reload")):
                server = self._model_route("reload")
                if server is not None:
                    self._json(200, server.reload_status())
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path == "/v1/reload" or (
                    self.path.startswith("/v1/models/")
                    and self.path.endswith("/reload")):
                if self.path == "/v1/reload":
                    server = registry[default]
                else:
                    server = self._model_route("reload")
                    if server is None:
                        return
                payload = self._read_json_body()
                if payload is None:
                    return
                try:
                    path = payload["path"]
                    if not isinstance(path, str) or not path:
                        raise ValueError("path must be a non-empty string")
                except (KeyError, ValueError, TypeError) as e:
                    self._json(400, {"error": f"bad request: {e}"})
                    return
                if reload_guard is not None:
                    denied = reload_guard(path)
                    if denied:
                        self._json(403, {"error": denied})
                        return
                try:
                    handles = server.reload(path)
                    self._json(200, {"scheduled": len(handles)})
                except NotImplementedError as e:
                    self._json(501, {"error": str(e)})
                return
            if self.path == "/v1/predict" or (
                    self.path.startswith("/v1/models/")
                    and self.path.endswith("/predict")):
                if self.path == "/v1/predict":
                    server = registry[default]
                else:
                    server = self._model_route("predict")
                    if server is None:
                        return
                payload = self._read_json_body()
                if payload is None:
                    return
                try:
                    if "indices" not in payload and "values" not in payload:
                        raise ValueError(
                            "'indices' ((B, T, L) ids) or the ragged form "
                            "('lengths' (B, T) + flat 'values') is required")
                    deadline_ms = self._parse_deadline(payload)
                    result = server.predict(payload.get("indices"),
                                            dense=payload.get("dense"),
                                            deadline_ms=deadline_ms,
                                            lengths=payload.get("lengths"),
                                            values=payload.get("values"))
                    self._json(200, result)
                except (ValueError, TypeError) as e:
                    self._json(400, {"error": f"bad request: {e}"})
                except NotImplementedError as e:
                    self._json(501, {"error": str(e)})
                except TimeoutError as e:
                    self._json(504, {"error": str(e)})
                except OverloadedError as e:
                    # Transport backpressure (arena slots exhausted):
                    # retryable, the client should back off — 503.
                    self._json(503, {"error": str(e)})
                except InferenceError as e:
                    self._json(504 if e.code == ERR_DEADLINE else 500,
                               {"error": str(e)})
                return
            if self.path == "/v1/infer":
                server = registry[default]
            elif (self.path.startswith("/v1/models/")
                  and self.path.endswith("/infer")):
                server = self._model_route("infer")
                if server is None:
                    return
            else:
                self._json(404, {"error": f"unknown path {self.path}"})
                return
            payload = self._read_json_body()
            if payload is None:
                return
            try:
                batch_size = int(payload["batch_size"])
                if batch_size < 1:
                    raise ValueError("batch_size must be >= 1")
                limit = server.cfg.max_mini_batch_size
                if batch_size > limit:
                    # Reject rather than silently clamp: a client would
                    # otherwise record latencies for a fraction of the
                    # work it believes it submitted.
                    raise ValueError(
                        f"batch_size {batch_size} exceeds this server's "
                        f"max_mini_batch_size {limit}")
                deadline_ms = self._parse_deadline(payload)
            except (KeyError, ValueError, TypeError) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return
            try:
                result = server.submit(batch_size, exp=bool(payload.get("exp", False)),
                                       deadline_ms=deadline_ms)
                self._json(200, result)
            except TimeoutError as e:
                self._json(504, {"error": str(e)})
            except InferenceError as e:
                # Expired deadline = the client's budget ran out (504);
                # anything else is a server-side engine fault (500).
                self._json(504 if e.code == ERR_DEADLINE else 500,
                           {"error": str(e)})

        def log_message(self, *a):  # quiet; metrics live in /v1/stats
            pass

    return Handler


class HttpIngress:
    """ThreadingHTTPServer wrapper: one handler thread per in-flight query,
    so slow (large-bucket) queries don't head-of-line-block small ones at
    the HTTP layer — queueing discipline stays with the engine queues.

    Accepts one ServingServer or a {name: ServingServer} registry for
    multi-model serving (POST /v1/models/<name>/infer)."""

    def __init__(self, server, host: str = "127.0.0.1", port: int = 0,
                 default: str | None = None, reload_root: str | None = None):
        if isinstance(server, ServingServer):
            registry = {server.model_cfg.model_name: server}
        else:
            registry = dict(server)
        if not registry:
            raise ValueError("empty model registry")
        self.registry = registry
        self.default = default if default is not None else next(iter(registry))
        if self.default not in registry:
            raise ValueError(f"default {self.default!r} not in registry")
        # POST /v1/reload deserializes a caller-supplied filesystem path.
        # Safe on the default loopback bind; on any other bind it would
        # expose arbitrary-path deserialization/DoS, so reloads there
        # require an explicit reload_root and paths must resolve inside it.
        import os

        loopback = host in ("127.0.0.1", "::1", "localhost")
        root = os.path.realpath(reload_root) if reload_root else None

        def reload_guard(path: str) -> str | None:
            if root is not None:
                real = os.path.realpath(path)
                if not (real == root or real.startswith(root + os.sep)):
                    return (f"checkpoint path must live under the "
                            f"configured reload_root")
                return None
            if not loopback:
                return ("reload is disabled on non-loopback binds; "
                        "configure reload_root to enable it")
            return None

        self._reload_guard = reload_guard
        # stdlib default listen backlog is 5; concurrent clients beyond that
        # get ECONNREFUSED while handler threads contend for CPU. Raise it so
        # admission control happens in the engine queues, not the kernel.
        class _Server(ThreadingHTTPServer):
            request_queue_size = 128

        self.httpd = _Server(
            (host, port), _make_handler(registry, self.default, reload_guard))
        self.httpd.daemon_threads = True
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="ingress-http")

    @property
    def address(self) -> tuple[str, int]:
        return self.httpd.server_address[:2]

    def start(self):
        self._thread.start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        for s in self.registry.values():
            s.stop()
