"""Autotuned batch-bucket ladders.

XLA compiles one program per batch shape, so engines serve every request at
the nearest bucket >= its size (``engine.py``). The reference has no such
constraint (Caffe2 runs any batch), so bucket choice is a design decision
of this framework: the default power-of-two ladder wastes up to 2x compute
on padding and compiles 11 programs.

``optimal_bucket_ladder`` picks at most K bucket sizes minimizing the
EXPECTED PADDED WORK E[bucket(s)] over an empirical size sample — the right
objective because per-request device time is ~linear in the padded batch
size for these models (embedding rows and MLP FLOPs both scale with B; see
benchmarks/characterization). Exact O(n^2 K) dynamic program over the
distinct observed sizes:

    f(i, k) = min cost of covering the i smallest distinct sizes with k
              buckets whose largest is v_i
    f(i, k) = min_{j<i} f(j, k-1) + v_i * (C_i - C_j)

``autotune_buckets`` samples the ServingConfig's own query-size
distribution (the analog of the reference tuning against its load
generator), applies sub-batch partitioning and accel-threshold routing so
the sample matches what CPU-path engines actually see, and returns the
optimal ladder — deterministic in cfg.seed so every engine derives the
same ladder without coordination.
"""

from __future__ import annotations

import numpy as np

from deeprecsys_tpu.config import ServingConfig


def expected_padded_work(sizes, buckets) -> float:
    """Mean padded batch size when serving ``sizes`` on ``buckets``."""
    sizes = np.asarray(sizes)
    buckets = np.sort(np.asarray(buckets))
    idx = np.searchsorted(buckets, sizes)
    idx = np.clip(idx, 0, len(buckets) - 1)  # oversize requests run at cap
    return float(buckets[idx].mean())


def optimal_bucket_ladder(sizes, max_buckets: int = 6) -> tuple[int, ...]:
    """Minimize E[bucket(s)] with at most ``max_buckets`` buckets.

    The largest observed size is always a bucket (nothing may exceed the
    ladder cap). Fewer buckets than ``max_buckets`` are returned when extra
    buckets stop helping (ties broken toward fewer compiled programs).
    """
    sizes = np.asarray(sizes, dtype=np.int64)
    if sizes.size == 0:
        raise ValueError("need at least one size sample")
    v, c = np.unique(sizes, return_counts=True)  # ascending distinct sizes
    n = len(v)
    K = min(max_buckets, n)
    if K == n:
        return tuple(int(x) for x in v)
    csum = np.concatenate([[0], np.cumsum(c)])  # C_j = count of j smallest

    INF = float("inf")
    # f[k][i]: min cost, k buckets covering distinct sizes 1..i, v_{i-1} a bucket.
    f = np.full((K + 1, n + 1), INF)
    f[0][0] = 0.0
    choice = np.zeros((K + 1, n + 1), dtype=np.int64)
    for k in range(1, K + 1):
        for i in range(k, n + 1):
            # vectorized over j: f[k-1][j] + v[i-1] * (C_i - C_j)
            j = np.arange(k - 1, i)
            costs = f[k - 1][j] + v[i - 1] * (csum[i] - csum[j])
            best = int(np.argmin(costs))
            f[k][i] = costs[best]
            choice[k][i] = j[best]
    best_k = int(np.argmin([f[k][n] for k in range(1, K + 1)])) + 1
    ladder = []
    i, k = n, best_k
    while k > 0:
        ladder.append(int(v[i - 1]))
        i, k = int(choice[k][i]), k - 1
    return tuple(sorted(ladder))


def autotune_buckets(
    cfg: ServingConfig,
    max_buckets: int | None = None,
    n_samples: int = 4096,
) -> tuple[int, ...]:
    """Derive the bucket ladder from the config's own size distribution.

    Samples query sizes exactly as the load generator draws them, then
    transforms them into the engine-visible sub-request stream: queries at
    or above the accel threshold go whole to the accel engine (which also
    buckets), the rest are partitioned into ``sub_task_batch_size`` chunks.
    """
    import dataclasses

    from deeprecsys_tpu.serving.load_generator import model_batch_sizes, partition_query

    rng = np.random.default_rng(cfg.seed + 9173)
    sample_cfg = dataclasses.replace(cfg, num_batches=n_samples)
    query_sizes = model_batch_sizes(sample_cfg, rng)

    # DeepRecSched tuning walks sub_task_batch_size over batch_configs at
    # runtime; the compiled ladder must cover the chunk sizes EVERY config
    # can produce, or tuned configs would silently clamp at the cap.
    sub_sizes = {cfg.sub_task_batch_size}
    if cfg.tune_batch_qps:
        sub_sizes.update(int(b) for b in cfg.batch_configs)

    engine_sizes: list[int] = []
    for s in query_sizes:
        if cfg.model_accel and s >= cfg.accel_request_size_thres:
            engine_sizes.append(int(s))  # whole query to the big-batch path
        else:
            for sub in sub_sizes:
                engine_sizes.extend(partition_query(int(s), sub))
    if cfg.model_accel and cfg.tune_accel_qps:
        # The accel-threshold walk can route ANY whole query to the accel
        # engine once the threshold drops below it; cover them all.
        engine_sizes.extend(int(s) for s in query_sizes)
    if cfg.model_accel:
        # The ladder sample is a DIFFERENT finite draw than the live
        # stream (load generator: cfg.seed); an unlucky sample whose max
        # falls short of a live whole query would make pick_bucket clamp
        # it at the cap (silent undercompute). Sizes clip at
        # max_mini_batch_size, so force that cap into the ladder — one
        # sample's weight in the DP, a hard guarantee for the cap.
        engine_sizes.append(int(cfg.max_mini_batch_size))
    if max_buckets is None:
        max_buckets = cfg.max_auto_buckets
    return optimal_bucket_ladder(engine_sizes, max_buckets)


def resolve_buckets(cfg: ServingConfig) -> tuple[int, ...]:
    """The engine-facing entry: static ladder or autotuned per policy."""
    if cfg.bucket_policy == "auto":
        return autotune_buckets(cfg)
    return tuple(cfg.batch_buckets)
