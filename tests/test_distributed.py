"""Multi-PROCESS validation of the sharded model paths.

BASELINE.md's scaling target asks for a >=2-host run; real multi-chip
hardware is unavailable here, so this is the honest next-best: two OS
processes, each with 2 virtual CPU devices, forming one 4-device global
mesh with Gloo carrying the cross-process collectives (the role the
network plays between real hosts). The hybrid-sharded apply (row-sharded
tables + data-sharded batch) must produce the single-device result.
"""

import multiprocessing as mp
import socket


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_sharded_apply_matches_single_device():
    from tests.distributed_worker import run_worker

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=run_worker, args=(i, 2, port, q))
             for i in range(2)]
    for p in procs:
        p.start()
    results = []
    try:
        for _ in range(2):
            results.append(q.get(timeout=420))
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
    assert len(results) == 2, results
    for pid, status, detail in sorted(results):
        assert status == "ok", (pid, detail)
        assert detail < 2e-4, (pid, detail)  # max|err| vs single-device
