"""Multi-process CPU engines over shared-memory rings.

Reference parity: the reference's canonical configuration runs 32 CPU
inference-engine OS processes around multiprocessing queues
(``DeepRecSys.py:62-78``, ``run_DeepRecSys.sh``). Here each engine process
reuses the exact ``ComputeEngine`` serving loop (engine.py) — a Thread
object run synchronously in the child — wired to ``ShmRingQueue``s: the
native lock-free rings carry the same 64-byte packets with no pickling.

Engines force the JAX CPU backend in-child (one process per core is the
CPU-engine model; the accelerator path stays in the parent process, the
one process that opens the GPU).
"""

from __future__ import annotations

import multiprocessing as mp
import time

from deeprecsys_tpu.config import ModelConfig, ServingConfig


def _engine_child(engine_id: int, model_cfg: ModelConfig, serving_cfg: ServingConfig,
                  req_name: str, resp_name: str, ready_name: str, capacity: int,
                  ctl_name: str | None = None,
                  checkpoint_path: str | None = None,
                  arena_spec: "tuple[str, int, int] | None" = None):
    import jax

    from deeprecsys_tpu.runtime.shm_queue import ShmRingQueue
    from deeprecsys_tpu.serving.engine import ComputeEngine

    # Everything before engine.run() sits OUTSIDE the engine's own setup
    # guard: an unguarded failure here (ring attach, config validation,
    # backend init) would kill the child silently and hang the parent's
    # ready barrier forever. Report through the ready ring if it attached;
    # a response sentinel keeps the aggregator's engine count honest.
    ready_q = response_q = None
    try:
        # Ready ring FIRST: it is the failure-reporting channel, so the
        # other two rings' attach failures can be reported through it.
        ready_q = _ReadySender(
            ShmRingQueue(64, shm_name=ready_name, create=False),
            engine_id=engine_id)
        # CPU engines only. A failure here is fatal (reported like any
        # setup error): a child that went on would open the GPU and
        # reserve most of its memory next to the parent's engines.
        jax.config.update("jax_platforms", "cpu")
        request_q = ShmRingQueue(capacity, shm_name=req_name, create=False)
        response_q = ShmRingQueue(capacity, shm_name=resp_name, create=False)
        # Per-engine reload side channel (the shared request ring is MPMC
        # and cannot target one engine; the POD slot cannot carry paths).
        control_q = (ShmRingQueue(64, shm_name=ctl_name, create=False)
                     if ctl_name else None)
        # Trained weights cannot cross the 64-byte POD rings as a pytree;
        # each child loads the checkpoint PATH itself (a load failure here
        # reports through the ready ring like any other setup error).
        params = None
        if checkpoint_path:
            from deeprecsys_tpu.utils.checkpoint import load_model_params

            params = load_model_params(model_cfg, checkpoint_path)
        # Real-inference payload transport (runtime/blob_arena.py): the
        # child attaches the parent's arena; requests whose consumer slot
        # carries a payload_slot hydrate from it.
        arena = None
        if arena_spec is not None:
            from deeprecsys_tpu.runtime.blob_arena import BlobArena

            name, n_slots, slot_b = arena_spec
            arena = BlobArena(name, n_slots, slot_b, create=False)
        engine = ComputeEngine(
            engine_id, model_cfg, serving_cfg, request_q, response_q, ready_q,
            device=jax.devices("cpu")[0], params=params,
            seed=serving_cfg.seed + engine_id,
            strict_buckets=False,  # serving path: clamp + count, never reject
            control_q=control_q,
            arena=arena,
        )
    except Exception as e:
        print(f"[deeprecsys_tpu] engine child {engine_id} failed before "
              f"serving: {e!r}", flush=True)
        try:
            if ready_q is not None:
                ready_q.put(e)
            if response_q is not None:
                response_q.put(None)
        except Exception:
            pass
        return
    engine.run()  # run the serving loop synchronously in this process


class _ReadySender:
    """Adapts the ready-barrier protocol onto the packet ring: readiness is
    a ServiceRequest with batch_id = engine_id; setup failure is
    batch_id = -(engine_id+1) (the 64-byte POD packet cannot carry the
    exception text — the child prints it to its stderr)."""

    def __init__(self, ring, engine_id: int | None = None):
        self.ring = ring
        self.engine_id = engine_id

    def put(self, item):
        from deeprecsys_tpu.serving.packets import ServiceRequest

        if isinstance(item, Exception):
            eid = self.engine_id if self.engine_id is not None else 0
            self.ring.put(ServiceRequest(batch_id=-(eid + 1)))
        else:
            self.ring.put(ServiceRequest(batch_id=int(item)))


class _ReadyReceiver:
    """queue.Queue-like view for the load generator's barrier."""

    def __init__(self, ring):
        self.ring = ring

    def put(self, item):  # local (in-parent) engines can also signal here
        _ReadySender(self.ring).put(item)

    def get(self, timeout=None):
        pkt = self.ring.get(timeout=timeout)
        if pkt is not None and pkt.batch_id < 0:
            eid = -pkt.batch_id - 1
            return RuntimeError(
                f"engine process {eid} failed during setup (its stderr "
                f"has the exception)")
        return pkt.batch_id if pkt is not None else None


def spawn_process_engines(model_cfg: ModelConfig, cfg: ServingConfig, capacity: int = 1024,
                          checkpoint_path: str | None = None,
                          arena_slots: int | None = None):
    """Create shm rings + blob arena + N engine processes. Returns
    (request_q, response_q, ready_receiver, processes, cleanup_fn,
    control_rings, arena) — control_rings[i] is engine i's reload side
    channel (feed it ``reload_fragments(path)``; the engine ACKs on the
    response ring with batch_id = RELOAD_ACK_BATCH_ID). ``arena`` is the
    parent-side BlobArena for real-inference payloads
    (``ServiceRequest.payload_slot``); slots are sized for the largest
    sub-request the config can produce. ``checkpoint_path``: each child
    starts from these trained weights (loaded in-child)."""
    from deeprecsys_tpu.runtime.blob_arena import BlobArena, slot_bytes_for
    from deeprecsys_tpu.runtime.shm_queue import ShmRingQueue

    tag = f"drs{time.time_ns() % 1_000_000_000}"
    req_name, resp_name, ready_name = f"{tag}_req", f"{tag}_resp", f"{tag}_rdy"
    request_q = ShmRingQueue(capacity, shm_name=req_name, create=True)
    response_q = ShmRingQueue(capacity, shm_name=resp_name, create=True)
    ready_ring = ShmRingQueue(64, shm_name=ready_name, create=True)
    ready = _ReadyReceiver(ready_ring)
    ctl_names = [f"{tag}_ctl{i}" for i in range(cfg.inference_engines)]
    control_rings = [ShmRingQueue(64, shm_name=n, create=True) for n in ctl_names]
    slot_rows = max(1, min(cfg.sub_task_batch_size, cfg.max_mini_batch_size))
    slot_b = slot_bytes_for(slot_rows, model_cfg.num_tables,
                            model_cfg.num_indices_per_lookup,
                            model_cfg.dense_dim, model_cfg.out_dim,
                            with_mask=cfg.accept_ragged)
    if arena_slots is None:
        arena_slots = cfg.payload_arena_slots
    arena = BlobArena(f"{tag}_blob", arena_slots, slot_b, create=True)
    arena_spec = (arena.name, arena.n_slots, arena.slot_bytes)

    ctx = mp.get_context("spawn")
    procs = []
    for i in range(cfg.inference_engines):
        p = ctx.Process(
            target=_engine_child,
            args=(i, model_cfg, cfg, req_name, resp_name, ready_name,
                  capacity, ctl_names[i], checkpoint_path, arena_spec),
            daemon=True,
        )
        p.start()
        procs.append(p)

    def cleanup():
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
        for q in (request_q, response_q, ready_ring, *control_rings):
            q.close()
            q.unlink()
        arena.close()
        arena.unlink()

    return request_q, response_q, ready, procs, cleanup, control_rings, arena
