"""Skew-aware model benchmark: production-representative Zipf id streams.

The default bench (bench.py) draws UNIFORM ids, which is exactly the
stream the hot/cold split cannot help (no skew -> no hot set worth
keeping). Production recommendation traffic is heavily skewed — the
reference's entire trace machinery exists to model that locality
(``dlrm_data_caffe2.py:152-227`` replays stack-distance traces; the
shipped ``profile/sd_cumm`` CDF is a power-law-ish distribution) — so
this module measures the full-model forward on a zipf(alpha) id stream
under two lookup implementations:

- ``xla``: the direct fused gather (the uniform-bench path).
- ``auto``: the serving engines' warm-up decision replayed measurement-
  side: size the hot set to the byte budget (utils.memory.suggest_hot_rows),
  sample the stream's hot coverage, and choose hotcold iff coverage >=
  cfg.hotcold_min_hit. Below threshold, auto == xla by design.

Methodology — what a SERVING ENGINE pays per request:

1. Params are built once and fed as ARGUMENTS — the engines' exact
   treatment.

2. Timing is PER-CALL DEVICE-BUSY TIME from profiler traces
   (utils/profiling.py). A chained fori_loop compiles a DIFFERENT program
   than the engines run, so its body can optimize differently from the
   single call; ``method="chain"`` keeps the chained slope for
   cross-validation.

Streams and hot sets use zipf 1.2, rng seed 2, batch 512.
"""

from __future__ import annotations

import numpy as np

# All eight: the auto-vs-direct decision is worth measuring for every
# family, not just the heavy-pooling four (rm1/rm2/rm3/din).
ZIPF_MODELS = ("rm1", "rm2", "rm3", "wnd", "mtwnd", "ncf", "din", "dien")


def zipf_stream(cfg, batch: int, alpha: float = 1.2, seed: int = 2) -> np.ndarray:
    """(B, T, L) int32 ids, zipf(alpha) folded into each table's rows."""
    rows = np.asarray(cfg.scaled_rows, dtype=np.int64)
    rng = np.random.default_rng(seed)
    T, L = cfg.num_tables, cfg.num_indices_per_lookup
    return (rng.zipf(alpha, size=(batch, T, L)) % rows[None, :, None]).astype(np.int32)


def drifted_zipf_stream(cfg, batch: int, alpha: float = 1.2, seed: int = 2,
                        drift_seed: int = 7) -> np.ndarray:
    """The zipf stream after POPULARITY DRIFT: same skew shape, but each
    table's id space is remapped through a random affine permutation
    (a*id + b mod rows, gcd(a, rows) = 1), so the popular head lands on
    entirely different rows. This is the stream a hot set frozen at
    warm-up decays on — the scenario ``hotcold_refresh_interval``
    exists for."""
    import math

    idx = zipf_stream(cfg, batch, alpha=alpha, seed=seed)
    rows = np.asarray(cfg.scaled_rows, dtype=np.int64)
    rng = np.random.default_rng(drift_seed)
    out = np.empty_like(idx)
    for t, r in enumerate(rows):
        r = int(r)
        if r <= 1:  # degenerate table: identity (rng.integers(1, 1) raises)
            out[:, t, :] = idx[:, t, :]
            continue
        a = int(rng.integers(1, r))
        while math.gcd(a, r) != 1:
            a = a % r + 1
        b = int(rng.integers(0, r))
        out[:, t, :] = ((idx[:, t, :].astype(np.int64) * a + b) % r).astype(np.int32)
    return out


def stream_coverage(cfg, idx: np.ndarray, hot_ids: np.ndarray) -> float:
    """Fraction of this stream's lookups served by ``hot_ids`` (sorted)."""
    from deeprecsys_tpu.ops.embedding import hot_coverage_of

    return hot_coverage_of(idx, np.asarray(cfg.table_offsets), hot_ids)


def _hot_set(cfg, idx: np.ndarray):
    """Budget-sized hot set for this stream + its measured coverage."""
    from deeprecsys_tpu.ops.embedding import select_hot_ids
    from deeprecsys_tpu.utils.memory import suggest_hot_rows

    offs = np.asarray(cfg.table_offsets, dtype=np.int64)
    hot_ids = select_hot_ids(idx, offs, suggest_hot_rows(cfg))
    return hot_ids, stream_coverage(cfg, idx, hot_ids)


def resolve_auto_impl(cfg, idx: np.ndarray):
    """Replay the engine's embedding_impl="auto" decision on this stream.

    Returns (impl, hot_ids, coverage): impl is "hotcold" or "xla";
    hot_ids/coverage are the sampled hot set and its stream coverage
    (None/None when the size floor declined without sampling — the
    engine does the same)."""
    if cfg.fused_table_mb < cfg.hotcold_min_table_mb:
        # Size floor (config.hotcold_min_table_mb): a small table's direct
        # gather is cheap, so the split cannot pay there.
        return "xla", None, None
    hot_ids, coverage = _hot_set(cfg, idx)
    if coverage < cfg.hotcold_min_hit:
        return "xla", hot_ids, coverage
    return "hotcold", hot_ids, coverage



def measure_skewed(model_name: str, device, impl: str = "auto",
                   batch: int = 512, table_scale: int = 1,
                   alpha: float = 1.2, iters: int = 32,
                   trials: int = 2, stream: "np.ndarray | None" = None,
                   hot_ids_override: "np.ndarray | None" = None,
                   method: str = "trace",
                   cfg_overrides: "dict | None" = None) -> dict:
    """One self-contained measurement of the full model forward on the
    zipf stream. ``impl``: "xla" | "hotcold" | "auto" (engine rule).
    ``stream`` substitutes the measured id stream (drift experiments);
    ``hot_ids_override`` forces a SPECIFIC hot set with impl="hotcold" —
    e.g. a STALE set selected on a different stream, the decayed state
    adaptive refresh recovers from. ``method``: "trace" (default — the
    engines' single-call device time, see the module docstring) or
    "chain" (the round-3 fori_loop two-point slope, kept for
    cross-validation)."""
    import time as _time

    import jax
    import jax.numpy as jnp
    from jax import lax

    from deeprecsys_tpu import zoo
    from deeprecsys_tpu.data import RecDataGenerator
    from deeprecsys_tpu.models import get_model
    from deeprecsys_tpu.models.base import Batch
    from deeprecsys_tpu.utils.devices import jit_pinned
    from deeprecsys_tpu.utils.timing import two_point_slope_ms

    cfg = zoo.get_config(model_name, table_scale=table_scale,
                         param_dtype="bfloat16", compute_dtype="bfloat16",
                         table_pack=0, **(cfg_overrides or {}))
    model = get_model(cfg)
    idx = stream if stream is not None else zipf_stream(cfg, batch, alpha=alpha)
    host = RecDataGenerator(cfg, seed=0).generate_batch(batch)
    dense_host = host.dense
    dense_dev = (None if dense_host is None
                 else jax.device_put(dense_host, device))
    idx_dev = jax.device_put(idx, device)

    chosen, hot_ids, coverage = impl, None, None
    if impl == "auto":
        chosen, hot_ids, coverage = resolve_auto_impl(cfg, idx)
    elif impl == "hotcold" and hot_ids_override is not None:
        hot_ids = np.asarray(hot_ids_override)
        coverage = stream_coverage(cfg, idx, hot_ids)
    elif impl == "hotcold":  # forced (bypasses the coverage threshold)
        hot_ids, coverage = _hot_set(cfg, idx)

    if chosen == "hotcold":
        from deeprecsys_tpu.models.hotcold import make_hotcold_model

        hc = make_hotcold_model(model, hot_ids)
        split = hc.prepare(Batch(dense=dense_host, indices=idx))
        sp = {k: jax.device_put(np.asarray(v), device)
              for k, v in split.items() if k != "n_cold"}
        # Engine-representative params: converted once and fed as
        # ARGUMENTS (see the module docstring's methodology note).
        with jax.default_device(device):
            params = jax.jit(
                lambda: hc.convert_params(model.init(jax.random.PRNGKey(0))))()

        def call(prm, dense, indices, hs, hm, ci, cseg):
            out = hc.apply(prm, Batch(dense=dense, indices=indices),
                           {"hot_sel": hs, "hot_mask": hm,
                            "cold_ids": ci, "cold_seg": cseg})
            return jnp.sum(out.astype(jnp.float32))

        def chain(n, prm, dense, indices, hs, hm, ci, cseg):
            def body(i, c):
                s = {"hot_sel": jnp.roll(hs, i, axis=0),
                     "hot_mask": jnp.roll(hm, i, axis=0),
                     "cold_ids": jnp.roll(ci, i, axis=0), "cold_seg": cseg}
                d = None if dense is None else dense
                out = hc.apply(prm, Batch(dense=d, indices=indices), s)
                return c + jnp.sum(out.astype(jnp.float32))

            return lax.fori_loop(0, n, body, jnp.zeros((), jnp.float32))

        args = (params, dense_dev, idx_dev, sp["hot_sel"], sp["hot_mask"],
                sp["cold_ids"], sp["cold_seg"])
    else:
        # Direct gather, the engines' way too: params built once and fed
        # as args.
        with jax.default_device(device):
            params = jax.jit(lambda: model.init(jax.random.PRNGKey(0)))()
        rows_np = np.asarray(cfg.scaled_rows, dtype=np.int32)

        def call(prm, dense, indices):
            out = model.apply(prm, Batch(dense=dense, indices=indices))
            return jnp.sum(out.astype(jnp.float32))

        def chain(n, prm, dense, indices):
            rows = jnp.asarray(rows_np)[None, :, None]

            def body(i, c):
                ii = (indices + i) % rows
                d = None if dense is None else dense
                out = model.apply(prm, Batch(dense=d, indices=ii))
                return c + jnp.sum(out.astype(jnp.float32))

            return lax.fori_loop(0, n, body, jnp.zeros((), jnp.float32))

        args = (params, dense_dev, idx_dev)

    if method == "trace":
        from deeprecsys_tpu.utils.profiling import traced_call_ms

        fn = jit_pinned(call, device)
        t0 = _time.perf_counter()
        float(fn(*args))
        compile_s = _time.perf_counter() - t0
        # ``iters`` maps to traced DISPATCHES here (clamped: 8+ calls
        # already average profiler noise).
        ms = traced_call_ms(lambda: float(fn(*args)),
                            calls=int(np.clip(iters, 4, 32)))
        if ms <= 0:
            raise RuntimeError(
                f"{model_name}/{impl}: empty device trace — profiler "
                f"unsupported on this backend? use method='chain'")
    else:
        fn = jit_pinned(chain, device)
        t0 = _time.perf_counter()
        float(fn(iters, *args))
        compile_s = _time.perf_counter() - t0

        def slope(n_hi):
            return two_point_slope_ms(lambda n: float(fn(n, *args)),
                                      max(n_hi // 8, 1), n_hi, trials)

        ms = slope(iters)
        # Adaptive chain lengthening (bench.py's rule): sub-0.1 ms models
        # need >= ~50 ms of chained signal to rise above timing jitter.
        while ms * iters < 50.0 and iters < 16384:
            iters = min(iters * 8, 16384)
            ms = slope(iters)
        if ms <= 0:
            raise RuntimeError(
                f"{model_name}/{impl}: two-point slope non-positive "
                f"({ms:.3g} ms/iter) at {iters} chained iterations — "
                f"backend jitter exceeded the signal")
    return {
        "model": model_name, "impl_requested": impl, "impl": chosen,
        "alpha": alpha, "batch": batch, "table_scale": table_scale,
        "method": method,
        "hot_coverage": None if coverage is None else round(float(coverage), 4),
        "hot_rows": None if hot_ids is None else int(len(hot_ids)),
        "latency_ms": ms, "samples_per_s": batch / (ms / 1000.0),
        "compile_s": compile_s,
    }
