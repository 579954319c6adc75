"""End-to-end serving orchestration.

Reference: ``DeepRecSys.py:21-185`` — queue creation, process spawning,
the response aggregation loop with windowed-p95 feedback, and the final
QPS / p95 / p99 report.

Design: engines are threads sharing the accelerator (see engine.py); queues
are ``queue.Queue``; everything else keeps the reference's dataflow —
request queue (bounded 1024), accel queue (bounded 32), pid (latency
feedback) queue, one response queue, readiness barrier queue.
"""

from __future__ import annotations

import dataclasses
import queue
import time

from deeprecsys_tpu.config import ModelConfig, ServingConfig
from deeprecsys_tpu.serving.latency_model import LatencyModel
from deeprecsys_tpu.serving.load_generator import LoadGenerator
from deeprecsys_tpu.serving.metrics import ResponseAggregator


@dataclasses.dataclass
class ServingResult:
    measured_qps: float
    p50_ms: float
    p95_ms: float
    p99_ms: float
    num_responses: int
    cpu_requests: int
    cpu_sub_requests: int
    accel_requests: int
    optimal_sub_batch: int | None
    optimal_accel_thres: int | None
    wall_s: float
    # Latency decomposition over non-experimental responses (ms): time
    # spent waiting in the request queue vs. executing (dispatch..scores
    # readable). The reference exposes the same split via its four
    # ServiceResponse timestamps (packets.py:51-54).
    queue_wait_p95_ms: float = float("nan")
    inference_p95_ms: float = float("nan")
    # Responses that carried an engine error code instead of scores
    # (packets.py ERR_*): 0 on a healthy run.
    error_responses: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def run_serving(
    model_cfg: ModelConfig,
    serving_cfg: ServingConfig,
    latency_model: LatencyModel | None = None,
    accel_latency_model: LatencyModel | None = None,
    settle_s: float = 3.0,
    params=None,
    log_responses: bool = False,
    watchdog_s: float = 60.0,
    mesh=None,
    checkpoint_path: str | None = None,
) -> ServingResult:
    """Run the full serving stack and return measured QPS / tail latency.

    Engine backends (serving_cfg.engine_backend):
      - "accel": ComputeEngine on the GPU (utils/devices.py)
      - "cpu": ComputeEngine on the host CPU backend
      - "sim": SimEngine driven by ``latency_model`` (required)

    With ``model_accel`` set, one extra engine consumes whole big queries:
    a SimEngine with ``accel_latency_model`` if given (reference parity:
    simulated accelerator), else a ComputeEngine on the GPU (the real
    big-batch path).
    """
    cfg = serving_cfg
    accel_request_q: queue.Queue = queue.Queue(maxsize=32)
    pid_q: queue.Queue = queue.Queue()
    cleanup = None
    procs: list = []
    if cfg.engine_backend == "cpu-mp":
        if params is not None:
            raise ValueError(
                "cpu-mp engines cannot take a params pytree; pass "
                "checkpoint_path= instead (each child loads it)")
        from deeprecsys_tpu.serving.process_engine import spawn_process_engines

        (request_q, response_q, ready_q, procs, cleanup,
         _controls, _arena) = spawn_process_engines(
             model_cfg, cfg, checkpoint_path=checkpoint_path)
    else:
        request_q = queue.Queue(maxsize=1024)
        response_q = queue.Queue()
        ready_q = queue.Queue()
        if params is None and checkpoint_path:
            from deeprecsys_tpu.utils.checkpoint import load_model_params

            params = load_model_params(model_cfg, checkpoint_path)

    from deeprecsys_tpu.serving.engine import build_engine_pool

    if cfg.engine_backend == "cpu-mp":
        # Process engines already spawned; an in-parent accel engine (if
        # any) is built by the pool helper with zero regular engines, its
        # id offset past the process-engine ids.
        engines, extra = build_engine_pool(
            model_cfg, dataclasses.replace(cfg, inference_engines=0),
            request_q, accel_request_q, response_q, ready_q,
            latency_model, accel_latency_model, params,
            id_base=cfg.inference_engines)
        total_engines = cfg.inference_engines + extra
    else:
        engines, total_engines = build_engine_pool(
            model_cfg, cfg, request_q, accel_request_q, response_q, ready_q,
            latency_model, accel_latency_model, params, mesh=mesh)

    loadgen = LoadGenerator(cfg, request_q, accel_request_q, pid_q, ready_q, settle_s=settle_s)

    t0 = time.time()
    for e in engines:
        e.start()
    loadgen.start()

    agg = ResponseAggregator(cfg.req_granularity)
    finished = 0
    # Shutdown sentinels still owed to engines after a loadgen death:
    # None = loadgen healthy so far; (cpu_count, accel_count) otherwise.
    # Tracked as REMAINING counts so a timed-out put (queue full while
    # engines are slow-but-alive) retries on the next watchdog timeout —
    # a one-shot flag would permanently skip the rest and re-hang.
    shutdown_owed: "tuple[int, int] | None" = None
    # Watchdog: the reference hangs forever if an engine dies mid-run
    # (SURVEY §5 "a crashed engine would hang the run"); we abort after a
    # quiet period once the load generator has exited with no live engine.
    while finished < total_engines:
        try:
            response = response_q.get(timeout=watchdog_s)
        except Exception:
            dead = [e.name for e in engines if not e.is_alive()] + [
                f"proc-{p.pid}" for p in procs if not p.is_alive()
            ]
            live_engines = any(e.is_alive() for e in engines) or any(
                p.is_alive() for p in procs
            )
            if (not loadgen.is_alive() and loadgen.error is not None
                    and shutdown_owed != (0, 0)):
                # The load generator DIED (it only sends done-sentinels on
                # clean completion), so live engines would block on
                # request_q.get() forever. Inject the sentinels it never
                # sent; engines drain, the loop completes, and the
                # loadgen error is raised after the joins below.
                if shutdown_owed is None:
                    print("[deeprecsys_tpu] WARNING: load generator died "
                          f"({loadgen.error!r}); shutting engines down",
                          flush=True)
                    shutdown_owed = (cfg.inference_engines,
                                     1 if cfg.model_accel else 0)
                # Timeout-bounded injection: if the queue is full (engines
                # dead, or slow-but-alive and still draining the backlog) a
                # blocking put would deadlock the watchdog's own recovery.
                # Deliver what fits NOW; the remainder retries on the next
                # timeout — live engines eventually drain the backlog and
                # make room.
                cpu_owed, accel_owed = shutdown_owed
                try:
                    while cpu_owed > 0:
                        request_q.put(None, timeout=0.5)
                        cpu_owed -= 1
                    while accel_owed > 0:
                        accel_request_q.put(None, timeout=0.5)
                        accel_owed -= 1
                except Exception:
                    print(f"[deeprecsys_tpu] WARNING: request queue full "
                          f"while injecting shutdown sentinels "
                          f"({cpu_owed}+{accel_owed} still owed); will "
                          f"retry", flush=True)
                shutdown_owed = (cpu_owed, accel_owed)
                continue
            if loadgen.is_alive() and not live_engines:
                # Every engine is dead while the load generator still
                # runs: with no consumer it eventually blocks forever in
                # put() on the bounded queue, and waiting on it would spin
                # this loop forever (the exact hang the watchdog exists to
                # prevent). Abort; threads are daemons.
                raise RuntimeError(
                    f"serving stalled: no responses for {watchdog_s}s and "
                    f"ALL engines exited (dead: {dead}) while the load "
                    f"generator is still running (blocked on a full "
                    f"queue); {finished}/{total_engines} engines had "
                    f"signalled done"
                )
            if not loadgen.is_alive() and not live_engines:
                if finished > 0:
                    # Partial failure: every engine has exited and at least
                    # one finished cleanly (sent its done-sentinel); the
                    # sentinels still missing belong to crashed engines
                    # that will never send them. Survivors already
                    # absorbed the shared queue, so complete degraded
                    # instead of hanging (the reference hangs forever
                    # here, SURVEY §5). NOTE: a merely SLOW engine is
                    # still alive and keeps this branch from firing.
                    missing = total_engines - finished
                    print(f"[deeprecsys_tpu] WARNING: {missing} engine(s) "
                          f"died mid-run (exited: {dead}); completing "
                          f"degraded", flush=True)
                    break
                raise RuntimeError(
                    f"serving stalled: no responses for {watchdog_s}s, load "
                    f"generator and engines all exited (dead: {dead}); "
                    f"{finished}/{total_engines} engines had signalled done"
                )
            continue  # engines still alive: slow, not dead
        if response is None:
            finished += 1
            continue
        windowed_p95 = agg.add(response)
        if windowed_p95 is not None:
            if cfg.debug_mode:
                # Reference parity: "Running latency:" progress lines
                # (DeepRecSys.py:131-133).
                print(f"Running latency: {windowed_p95:.3f} ms", flush=True)
            pid_q.put(windowed_p95)

    loadgen.join()
    for e in engines:
        e.join()
    if cleanup is not None:
        cleanup()
    if loadgen.error is not None:
        raise RuntimeError("load generator failed") from loadgen.error
    wall = time.time() - t0

    if log_responses and cfg.log_file:
        import os
        d = os.path.dirname(cfg.log_file)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(cfg.log_file, "w") as f:
            for r in agg.responses:
                f.write(str(dataclasses.asdict(r)) + "\n")

    sub_opt = loadgen.cpu_scheduler.optimal_config if cfg.tune_batch_qps else None
    accel_opt = loadgen.accel_scheduler.optimal_config if cfg.tune_accel_qps else None
    import numpy as _np

    finals = [r for r in agg.responses if not r.exp_packet]
    qwait = [max(r.queue_start_time - r.arrival_time, 0.0) * 1000 for r in finals]
    infer = [max(r.inference_end_time - r.queue_start_time, 0.0) * 1000 for r in finals]
    return ServingResult(
        measured_qps=agg.measured_qps(),
        p50_ms=agg.tail_latency_ms(50),
        p95_ms=agg.tail_latency_ms(95),
        p99_ms=agg.tail_latency_ms(99),
        num_responses=len(agg.responses),
        cpu_requests=loadgen.cpu_requests,
        cpu_sub_requests=loadgen.cpu_sub_requests,
        accel_requests=loadgen.accel_requests,
        optimal_sub_batch=sub_opt,
        optimal_accel_thres=accel_opt,
        wall_s=wall,
        queue_wait_p95_ms=float(_np.percentile(qwait, 95)) if qwait else float("nan"),
        inference_p95_ms=float(_np.percentile(infer, 95)) if infer else float("nan"),
        error_responses=sum(agg.error_counts.values()),
    )
