"""ctypes bindings + on-demand build of the native runtime.

The .so is compiled once with g++ into ``build/native`` at the root of
the checkout (or ``DRS_NATIVE_CACHE``) keyed by a source hash, so the repo
needs no build step. Falls back cleanly: callers use
``native_available()`` and degrade to pure-Python equivalents
(queue.Queue / time.sleep spin).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

_SRC = Path(__file__).parent / "cpp" / "drs_runtime.cpp"
_lib = None
_build_error: str | None = None


def _cache_dir() -> Path:
    d = os.environ.get("DRS_NATIVE_CACHE")
    if d:
        return Path(d)
    return Path(__file__).resolve().parents[2] / "build" / "native"


def _build() -> Path:
    src = _SRC.read_text()
    tag = hashlib.sha256(src.encode()).hexdigest()[:16]
    out = _cache_dir() / f"drs_runtime_{tag}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    # Per-process tmp name: concurrent cold-cache builds (separate CLI
    # jobs, cpu-mp children) must not interleave writes into one file
    # before the atomic os.replace.
    tmp = out.with_suffix(f".so.tmp.{os.getpid()}")
    subprocess.run(
        ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-o", str(tmp)],
        check=True, capture_output=True,
    )
    os.replace(tmp, out)
    return out


def get_lib():
    global _lib, _build_error
    if _lib is not None:
        return _lib
    if _build_error is not None:
        raise RuntimeError(f"native runtime unavailable: {_build_error}")
    try:
        path = _build()
        lib = ctypes.CDLL(str(path))
    except Exception as e:  # g++ missing, sandbox, etc.
        msg = str(e)
        if isinstance(e, subprocess.CalledProcessError) and e.stderr:
            # str(CalledProcessError) omits stderr — without the compiler
            # diagnostics, every caller silently degrades to the slow path
            # with no way to see WHY the build failed.
            msg += "\n" + e.stderr.decode(errors="replace")[-2000:]
        _build_error = msg
        raise RuntimeError(f"native runtime unavailable: {msg}") from e
    lib.drs_ring_bytes.restype = ctypes.c_uint64
    lib.drs_ring_bytes.argtypes = [ctypes.c_uint64]
    lib.drs_ring_init.restype = ctypes.c_int
    lib.drs_ring_init.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.drs_ring_push.restype = ctypes.c_int
    lib.drs_ring_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.drs_ring_pop.restype = ctypes.c_int
    lib.drs_ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.drs_ring_pop_wait.restype = ctypes.c_int
    lib.drs_ring_pop_wait.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    lib.drs_ring_approx_size.restype = ctypes.c_uint64
    lib.drs_ring_approx_size.argtypes = [ctypes.c_void_p]
    lib.drs_precise_sleep_ns.restype = None
    lib.drs_precise_sleep_ns.argtypes = [ctypes.c_int64, ctypes.c_int64]
    lib.drs_trace_generate_lru.restype = ctypes.c_int64
    lib.drs_trace_generate_lru.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,  # lines, n, head
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # sd_vals, sd_cdf, n_sd
        ctypes.c_int64, ctypes.c_void_p,  # out_len, out
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,  # rng_state, padding, i
    ]
    lib.drs_split_hot_cold.restype = ctypes.c_int64
    lib.drs_split_hot_cold.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,  # indices, n
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,  # offsets, T, L
        ctypes.c_void_p, ctypes.c_int64,  # hot_ids, K
        ctypes.c_void_p, ctypes.c_void_p,  # hot_sel, hot_mask
        ctypes.c_void_p, ctypes.c_void_p,  # cold_ids, cold_seg
        ctypes.c_int32,  # n_threads
    ]
    lib.drs_split_hot_cold_masked.restype = ctypes.c_int64
    lib.drs_split_hot_cold_masked.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,  # indices, n
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,  # offsets, T, L
        ctypes.c_void_p, ctypes.c_int64,  # hot_ids, K
        ctypes.c_void_p,  # slot_mask (ragged; NULL = all valid)
        ctypes.c_void_p, ctypes.c_void_p,  # hot_sel, hot_mask
        ctypes.c_void_p, ctypes.c_void_p,  # cold_ids, cold_seg
        ctypes.c_int32,  # n_threads
    ]
    lib.drs_split_hot_cold_indexed.restype = ctypes.c_int64
    lib.drs_split_hot_cold_indexed.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,  # indices, n
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,  # offsets, T, L
        ctypes.c_void_p, ctypes.c_int64,  # hot_ids, K
        ctypes.c_void_p,  # slot_mask (ragged; NULL = all valid)
        ctypes.c_void_p,  # hot_index (NULL = binary-search probe)
        ctypes.c_void_p, ctypes.c_void_p,  # hot_sel, hot_mask
        ctypes.c_void_p, ctypes.c_void_p,  # cold_ids, cold_seg
        ctypes.c_int32,  # n_threads
    ]
    lib.drs_hot_index_build.restype = ctypes.c_void_p
    lib.drs_hot_index_build.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.drs_hot_index_free.restype = None
    lib.drs_hot_index_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def native_available() -> bool:
    try:
        get_lib()
        return True
    except RuntimeError:
        return False


def precise_sleep_ns(total_ns: int, spin_ns: int = 200_000):
    """GIL-releasing precise sleep (nanosleep bulk + spin tail)."""
    get_lib().drs_precise_sleep_ns(total_ns, spin_ns)


class HotIndex:
    """Persistent native hash index over a SORTED hot-id set.

    The hot/cold splitter's per-lookup membership probe dominates its
    host cost: a binary search over a K~1e6 sorted array is ~log2(K)
    dependent cache misses per lookup. This open-addressing table
    (built once per hot-set install — engine setup or a refresh swap,
    both off the serving dispatch path) brings the probe to ~1 miss.
    Pass it to ``ops.embedding.split_hot_cold(hot_index=...)``; outputs
    are bit-identical to the binary-search and numpy paths.

    Owns the native table; freed when the Python object is collected.
    The engine keeps the owning HotColdModel referenced for the
    duration of every ``prepare`` call, so a refresh swap cannot free a
    table that an in-flight split is probing.
    """

    def __init__(self, hot_ids):
        import numpy as np

        lib = get_lib()  # raises if the native runtime is unavailable
        hot = np.ascontiguousarray(hot_ids, dtype=np.int64)
        self.K = int(len(hot))
        self._lib = lib
        self._ptr = (
            lib.drs_hot_index_build(
                ctypes.c_void_p(hot.ctypes.data), self.K)
            if self.K else None)

    def __del__(self):
        ptr = getattr(self, "_ptr", None)
        if ptr:
            self._lib.drs_hot_index_free(ptr)
            self._ptr = None
