"""Device busy time from ``jax.profiler`` traces.

A trace holds one plane per device (``/device:GPU:0``, ...) and one for
the host (``/host:CPU``). Kernels run on the device planes' stream lines,
whatever their names (cuBLAS ``sm90_xmma_*``, CUTLASS ``void cutlass::*``,
XLA fusions such as ``loop_gather_fusion``), so events are selected by
plane and line, never by name. Busy time is the UNION of the selected
intervals: kernels that overlap on two streams count once, and the gaps
between kernels (launch latency, host work) count as idle.

A run explicitly on the CPU (``JAX_PLATFORMS=cpu``, see
``utils/devices.py``) has no device plane; only there do the lines of the
host plane that XLA's CPU runtime executes on (``tf_XLA*`` thread pools)
stand in, so rehearsals on the CPU exercise the same code. Those numbers
describe the CPU backend, not a device. Any other trace without a device
plane (a GPU run whose profiler could not record kernels) is an error.
"""

from __future__ import annotations

import glob
import re
import tempfile
from pathlib import Path

_GPU_PLANE = re.compile(r"^/device:GPU:\d+$")
# Lines some profiler versions derive from the stream lines: they span
# whole modules or steps and would hide the idle gaps between kernels.
_DERIVED_LINES = frozenset({"XLA Modules", "XLA Ops", "Steps",
                            "Framework Ops", "Framework Name Scope",
                            "Source code", "XLA TraceMe", "Launch Stats"})


def select_device_events(planes, cpu_run: bool = False):
    """(plane, start_ns, dur_ns) of every event on a device lane.

    ``planes`` is an iterable of (plane_name, [(line_name, [(start_ns,
    dur_ns), ...]), ...]). GPU planes are used when present. Without
    any, the host plane's XLA execution threads are used if ``cpu_run``
    (a run explicitly on the CPU); otherwise RuntimeError."""
    planes = list(planes)
    gpu = [(p, lines) for p, lines in planes if _GPU_PLANE.match(p)]
    if gpu:
        chosen = [(p, [(ln, evs) for ln, evs in lines
                       if ln not in _DERIVED_LINES]) for p, lines in gpu]
    elif cpu_run:
        chosen = [(p, [(ln, evs) for ln, evs in lines
                       if ln.startswith("tf_XLA")])
                  for p, lines in planes if p == "/host:CPU"]
    else:
        raise RuntimeError(
            f"no device plane in trace (planes: {[p for p, _ in planes]}); "
            f"the profiler recorded no GPU kernels")
    return [(p, s, d) for p, lines in chosen for _, evs in lines
            for s, d in evs]


def union_ns(intervals) -> int:
    """Total length of the union of (start_ns, dur_ns) intervals."""
    total, end = 0, None
    for s, d in sorted(intervals):
        e = s + d
        if end is None or s > end:
            total += d
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def read_planes(trace_dir):
    """The planes of the one ``*.xplane.pb`` under ``trace_dir``, in the
    shape ``select_device_events`` takes."""
    from jax.profiler import ProfileData

    (pb,) = glob.glob(str(Path(trace_dir) / "**" / "*.xplane.pb"),
                      recursive=True)
    data = ProfileData.from_file(pb)
    return [(plane.name,
             [(line.name, [(int(e.start_ns), int(e.duration_ns))
                           for e in line.events])
              for line in plane.lines])
            for plane in data.planes]


def device_busy_ms(trace_dir) -> dict:
    """Busy milliseconds per device plane of a recorded trace. The host's
    XLA threads count only when JAX is explicitly set to the CPU."""
    from deeprecsys_tpu.utils.devices import cpu_explicit

    per_plane: dict = {}
    for plane, s, d in select_device_events(read_planes(trace_dir),
                                            cpu_run=cpu_explicit()):
        per_plane.setdefault(plane, []).append((s, d))
    return {p: union_ns(iv) / 1e6 for p, iv in per_plane.items()}


def traced_call_ms(run_once, calls: int = 8) -> float:
    """Mean per-call device-busy milliseconds of ``run_once()`` over
    ``calls`` traced dispatches, summed over devices. ``run_once`` must
    block until the call completes (e.g. ``lambda:
    fn(*args).block_until_ready()``) so the calls do not overlap."""
    import shutil

    import jax

    run_once()  # compiled and warm before the traced window
    tmp = tempfile.mkdtemp(prefix="drs_trace_")
    try:
        with jax.profiler.trace(tmp):
            for _ in range(calls):
                run_once()
        return sum(device_busy_ms(tmp).values()) / calls
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
