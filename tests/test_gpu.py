"""Checks that need an NVIDIA GPU. They skip elsewhere; chip_smoke.py
runs them on the card. Whether a GPU is present is decided inside each
test, never at import time."""

import time

import pytest

pytestmark = pytest.mark.gpu


def _require_gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU")


def test_picker_returns_the_gpu():
    _require_gpu()
    from deeprecsys_tpu.utils.devices import pick_accel_device

    assert pick_accel_device().platform == "gpu"


def test_trace_busy_time_within_host_clock(tmp_path):
    """Busy time reduced from a trace recorded on the card is positive
    and no longer than the host clock around the same calls."""
    _require_gpu()
    import jax
    import jax.numpy as jnp

    from deeprecsys_tpu.utils.profiling import device_busy_ms

    f = jax.jit(lambda a: jnp.tanh(a @ a).sum())
    a = jnp.ones((2048, 2048), jnp.bfloat16)
    f(a).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        t0 = time.perf_counter()
        for _ in range(5):
            f(a).block_until_ready()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = device_busy_ms(tmp_path)
    assert list(busy) == ["/device:GPU:0"]
    assert 0 < busy["/device:GPU:0"] <= wall_ms
