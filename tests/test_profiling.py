"""Trace reduction (utils/profiling.py) on synthetic planes and on a
trace recorded here on the CPU."""

import jax
import jax.numpy as jnp
import pytest

from deeprecsys_tpu.utils.profiling import (
    select_device_events,
    traced_call_ms,
    union_ns,
)


@pytest.mark.parametrize("intervals, want", [
    ([], 0),
    ([(0, 10)], 10),
    ([(0, 10), (20, 5)], 15),            # a gap is idle
    ([(0, 10), (5, 10)], 15),            # overlap counts once
    ([(5, 2), (0, 10)], 10),             # contained, unsorted
    ([(0, 10), (10, 10)], 20),           # touching
])
def test_union_ns(intervals, want):
    assert union_ns(intervals) == want


def _gpu_trace():
    # Kernel names as the GPU reports them: no HLO-looking names needed.
    return [
        ("/host:CPU", [("python", [(0, 1000)]),
                       ("tf_XLAPjRtCpuClient/1", [(0, 900)])]),
        ("/device:GPU:0", [
            ("Stream #13(Compute)", [(100, 40), (150, 30)]),
            ("Stream #14(MemcpyH2D)", [(120, 50)]),
            ("XLA Modules", [(100, 200)]),
        ]),
        ("/device:GPU:1", [("Stream #7", [(0, 5)])]),
    ]


def test_gpu_lanes_selected_by_plane_not_name():
    events = select_device_events(_gpu_trace())
    assert sorted(events) == [("/device:GPU:0", 100, 40),
                              ("/device:GPU:0", 120, 50),
                              ("/device:GPU:0", 150, 30),
                              ("/device:GPU:1", 0, 5)]
    gpu0 = [(s, d) for p, s, d in events if p == "/device:GPU:0"]
    assert union_ns(gpu0) == 80          # 100..180, streams overlap


def test_cpu_rehearsal_uses_xla_threads():
    trace = [p for p in _gpu_trace() if not p[0].startswith("/device")]
    assert select_device_events(trace, cpu_run=True) == [("/host:CPU", 0, 900)]


def test_trace_without_device_plane_raises_off_cpu():
    """A GPU run whose profiler recorded no kernels must not read the
    host's threads as device time."""
    trace = [p for p in _gpu_trace() if not p[0].startswith("/device")]
    with pytest.raises(RuntimeError, match="no device plane"):
        select_device_events(trace)


def test_traced_call_ms_on_cpu():
    f = jax.jit(lambda x: jnp.tanh(x @ x).sum())
    x = jnp.ones((128, 128))
    ms = traced_call_ms(lambda: f(x).block_until_ready(), calls=3)
    assert ms > 0


def test_reduction_of_a_trace_recorded_on_the_card():
    """rm1 on an H100 (tests/data/h100_rm1_trace.json): the kernels sit on
    the GPU plane's stream line under cuBLAS/XLA fusion names; the host
    plane's python and runtime lines stay out of the busy time."""
    import json
    from pathlib import Path

    doc = json.loads((Path(__file__).parent / "data" /
                      "h100_rm1_trace.json").read_text())
    planes = [(p, [(ln, [tuple(e) for e in evs]) for ln, evs in lines])
              for p, lines in doc["planes"]]
    events = select_device_events(planes)
    assert {p for p, _, _ in events} == {"/device:GPU:0"}
    (stream,) = [evs for p, lines in planes if p == "/device:GPU:0"
                 for _, evs in lines]
    assert len(events) == len(stream) == 11 * doc["calls"]
    busy = union_ns([(s, d) for _, s, d in events])
    total = sum(d for _, d in stream)
    # Consecutive kernels on one stream can overlap a little (Hopper's
    # programmatic dependent launch): the union counts that time once.
    assert 0.99 * total < busy < total
    host = [(s, d) for p, lines in planes if p == "/host:CPU"
            for _, evs in lines for s, d in evs]
    assert busy < union_ns(host)               # the device idles between calls
