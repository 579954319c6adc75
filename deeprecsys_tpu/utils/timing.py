"""Chained device timing.

The timed quantity flows into a scalar inside one jitted program, and the
host reads that scalar back with ``float()``.

Methodology (``time_step_chain``):
  1. K iterations of the step chained inside ONE compiled ``fori_loop``
     with a data dependence on the loop counter (no hoisting, no dedupe);
  2. the trip count K is a RUNTIME argument — a literal bound can be
     unrolled by the compiler, multiplying compile time by the unroll
     factor, and a runtime bound lets one compiled program serve several
     chain lengths;
  3. per-iteration time is the two-point slope (t(K_hi)-t(K_lo))/(K_hi-K_lo),
     which cancels the per-call dispatch and readback and any per-call
     setup inside the program exactly.

The chain times a loop body, which XLA may compile differently from the
single call a serving engine dispatches; ``utils/profiling.py`` measures
that single call. ROADMAP Speed 1 replaces both with one per-call method.
"""

from __future__ import annotations

import time
from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax

_floor_cache: dict = {}


def roundtrip_floor_ms(device=None, trials: int = 5) -> float:
    """Dispatch + scalar-readback overhead of a trivial jitted program on
    ``device`` (default: ``pick_accel_device()``)."""
    from deeprecsys_tpu.utils.devices import jit_pinned, pick_accel_device

    if device is None:
        device = pick_accel_device()
    key = str(device)
    if key in _floor_cache:
        return _floor_cache[key]
    tiny = jit_pinned(lambda x: jnp.sum(x), device)
    # Host numpy input: uncommitted, so jit_pinned's default-device wrap
    # routes it (and avoids an eager default-backend dispatch here).
    import numpy as np

    v = np.ones((8,), np.float32)
    float(tiny(v))
    t0 = time.perf_counter()
    for _ in range(trials):
        float(tiny(v))
    floor = (time.perf_counter() - t0) / trials * 1000.0
    _floor_cache[key] = floor
    return floor


def payload_floor_fit(device=None, sizes_mb=(0.0, 1.0, 4.0), trials: int = 4) -> dict:
    """Fit per-dispatch round-trip cost vs HOST->DEVICE payload size:
    ``ms ~= a_ms + b_ms_per_mb * MB``.

    The scalar floor (``roundtrip_floor_ms``) times an argument already
    resident on device, so it misses the transport term a serving engine
    pays on every dispatch (``device_put`` of fresh host index arrays,
    megabytes for the wide-table models). Each trial uses a DISTINCT host
    array, and the fit is least squares over the per-size medians.
    ``device`` defaults to ``pick_accel_device()``; the result names it.
    """
    import numpy as np

    from deeprecsys_tpu.utils.devices import jit_pinned, pick_accel_device

    if device is None:
        device = pick_accel_device()
    pts_mb, pts_ms = [], []
    for mb in sizes_mb:
        n = max(8, int(mb * 1e6 / 4))
        prog = jit_pinned(lambda x: jnp.sum(x), device)
        hosts = []
        for t in range(trials + 1):
            a = np.zeros((n,), np.int32)
            a[: min(64, n)] = t + 1  # distinct content, cheap to build
            hosts.append(a)
        float(prog(jax.device_put(hosts[-1], device)))  # compile this shape
        samples = []
        for t in range(trials):
            t0 = time.perf_counter()
            float(prog(jax.device_put(hosts[t], device)))
            samples.append((time.perf_counter() - t0) * 1000.0)
        pts_mb.append(n * 4 / 1e6)
        pts_ms.append(float(np.median(samples)))
    A = np.stack([np.ones(len(pts_mb)), np.asarray(pts_mb)], axis=1)
    (a_ms, b_ms_per_mb), *_ = np.linalg.lstsq(A, np.asarray(pts_ms), rcond=None)
    return {"a_ms": float(a_ms), "b_ms_per_mb": float(max(b_ms_per_mb, 0.0)),
            "points_mb": pts_mb, "points_ms": pts_ms,
            "device": f"{device.platform} {device.device_kind}"}


def two_point_slope_ms(call: Callable[[int], object], n_lo: int, n_hi: int,
                       trials: int = 3) -> float:
    """Best-of-trials two-point slope in ms/iter.

    ``call(n)`` must execute a chained program with RUNTIME trip count n
    and block on a scalar readback before returning. The dispatch/readback
    floor (and any per-call setup inside the program, e.g. in-program
    param init) cancels exactly in the difference. The result can be
    NEGATIVE when jitter exceeds the signal — callers decide whether to
    grow the chain or fail; clamping here would silently turn noise into
    a huge throughput number."""
    if n_hi <= n_lo:
        raise ValueError(
            f"two-point slope needs distinct chain lengths (n_lo={n_lo}, "
            f"n_hi={n_hi}); raise iters to at least 2")
    best_lo = best_hi = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        call(n_lo)
        best_lo = min(best_lo, time.perf_counter() - t0)
        t0 = time.perf_counter()
        call(n_hi)
        best_hi = min(best_hi, time.perf_counter() - t0)
    return (best_hi - best_lo) / (n_hi - n_lo) * 1000.0


def time_step_chain(
    step_fn: Callable,
    init_carry,
    *args,
    iters: int = 32,
    trials: int = 3,
    device=None,
) -> float:
    """Milliseconds per iteration of ``carry = step_fn(i, carry, *args)``.

    ``step_fn`` must make its work depend on both ``i`` and the previous
    carry (perturb inputs with the iteration index so the compiler cannot
    hoist loop-invariant work).
    """

    def chain(n, carry, *a):
        out = lax.fori_loop(0, n, lambda i, c: step_fn(i, c, *a), carry)
        leaves = jax.tree_util.tree_leaves(out)
        return sum(jnp.sum(l.astype(jnp.float32)) for l in leaves)

    if iters < 2:
        raise ValueError("iters must be >= 2: the two-point slope needs "
                         "distinct chain lengths")
    from deeprecsys_tpu.utils.devices import jit_pinned

    fn = jit_pinned(chain, device)
    n_lo, n_hi = max(iters // 8, 1), iters
    float(fn(n_hi, init_carry, *args))  # compile + warm
    call = lambda n: float(fn(n, init_carry, *args))
    ms = two_point_slope_ms(call, n_lo, n_hi, trials)
    if ms <= 0:  # jitter exceeded the signal: one re-measure, then fail
        ms = two_point_slope_ms(call, n_lo, n_hi, trials)
    if ms <= 0:
        # Never clamp: a noise-dominated slope clamped positive flows
        # into recorded characterization artifacts as ~1e9 samples/s.
        raise RuntimeError(
            f"two-point slope non-positive ({ms:.3g} ms/iter at "
            f"iters={iters}) — measurement jitter exceeds the signal; "
            f"raise iters or re-run when the backend is quiet")
    return ms


# Backwards-compatible name (older call sites / docs).
time_jitted_chain = time_step_chain
