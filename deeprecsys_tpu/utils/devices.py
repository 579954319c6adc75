"""Device selection and compile-cache setup shared by every entry point.

One definition of "the accelerator" so no call site can quietly run on
the host CPU: a GPU is used when JAX sees one, the CPU only when JAX was
explicitly told to use it (``JAX_PLATFORMS=cpu`` or
``jax.config.update("jax_platforms", "cpu")`` — tests and CPU
rehearsals), and anything else is an error."""

from __future__ import annotations

import os
from pathlib import Path

# Persistent compilation cache used when JAX_COMPILATION_CACHE_DIR is not
# set: one fixed path inside the checkout (listed in .gitignore). The path
# is part of the cache key, so it must not move between runs.
DEFAULT_COMPILE_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def cpu_requested(platforms_setting) -> bool:
    """Whether ``platforms_setting`` (the ``jax_platforms`` config value)
    names the CPU and nothing else."""
    requested = [p.strip() for p in (platforms_setting or "").split(",")
                 if p.strip()]
    return bool(requested) and all(p == "cpu" for p in requested)


def cpu_explicit() -> bool:
    """Whether JAX was explicitly told to run on the CPU only."""
    import jax

    return cpu_requested(jax.config.jax_platforms)


def choose_accel(devices, platforms_setting) -> object:
    """The first GPU in ``devices``; the first CPU device only when
    ``cpu_requested(platforms_setting)``; otherwise RuntimeError."""
    devices = list(devices)
    for d in devices:
        if d.platform == "gpu":
            return d
    if cpu_requested(platforms_setting):
        for d in devices:
            if d.platform == "cpu":
                return d
    raise RuntimeError(
        f"no GPU found (JAX devices: {[str(d) for d in devices]}); set "
        f"JAX_PLATFORMS=cpu to run on the host CPU on purpose")


def pick_accel_device():
    """The device accelerator engines and benchmarks run on (see
    ``choose_accel``)."""
    import jax

    return choose_accel(jax.devices(), jax.config.jax_platforms)


def init_compilation_cache(path: str | None = None) -> str:
    """Enable JAX's persistent compilation cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is set here. Otherwise the cache goes to ``path`` (the
    ``--compilation_cache_dir`` flag) or to ``DEFAULT_COMPILE_CACHE``."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    target = str(path) if path else str(DEFAULT_COMPILE_CACHE)
    jax.config.update("jax_compilation_cache_dir", target)
    return target


def jit_pinned(fn, device=None, **jit_kwargs):
    """``jax.jit`` pinned to ``device`` without the deprecated
    ``jit(device=...)`` argument (removed in jax 0.9).

    Placement semantics preserved for every call site in this repo:
    inputs committed via ``device_put`` already pin execution, and for
    uncommitted inputs (host numpy arrays, python scalars, zero-arg
    programs) the call runs under ``jax.default_device(device)``.
    ``device=None`` is plain ``jax.jit``."""
    import jax

    jitted = jax.jit(fn, **jit_kwargs)
    if device is None:
        return jitted

    def call(*args, **kwargs):
        with jax.default_device(device):
            return jitted(*args, **kwargs)

    return call
