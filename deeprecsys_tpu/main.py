"""Command-line entry point.

Reference: ``DeepRecSys.py`` + ``utils/utils.py cli()`` — parse flags, then
either (a) ``--queue``: run the full serving stack (load generator +
engines + aggregator + optional DeepRecSched tuning) and report measured
QPS / p95 / p99, or (b) standalone: run the model in a characterization
loop printing per-batch data-load / compute times (the ``***`` lines that
the reference's experiment scripts parse; we emit the same three totals).

Examples:
  python -m deeprecsys_tpu.main --model rm1 --num_batches 32 --mini_batch_size 64
  python -m deeprecsys_tpu.main --model ncf --queue --inference_engines 2 \\
      --batch_size_distribution normal --avg_mini_batch_size 165 \\
      --var_mini_batch_size 16 --max_mini_batch_size 1024 \\
      --avg_arrival_rate 5 --target_latency 25 --tune_batch_qps
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from deeprecsys_tpu import zoo
from deeprecsys_tpu.config import ModelConfig, ServingConfig, load_model_config

# Latency ladders for engine_backend=sim, written by experiments/sweep.py.
CHARACTERIZATION_DIR = (Path(__file__).resolve().parent.parent / "benchmarks"
                        / "characterization")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DeepRecSys")
    # Model selection (reference: --model_name/--config_file)
    p.add_argument("--model", type=str, default="rm1",
                   help=f"zoo model name {zoo.MODEL_NAMES} or path to a reference-format JSON")
    p.add_argument("--table_scale", type=int, default=1,
                   help="divide embedding-table rows (memory-constrained runs)")
    p.add_argument("--param_dtype", type=str, default="float32")
    p.add_argument("--embedding_impl", type=str, default="xla",
                   choices=["xla", "hotcold", "auto"],
                   help="sparse-lookup implementation (config.py); auto = "
                        "serving engines sample their stream at warm-up and "
                        "pick hotcold iff coverage >= --hotcold_min_hit")
    p.add_argument("--hotcold_min_hit", type=float, default=None,
                   help="minimum sampled hot-set coverage for "
                        "--embedding_impl auto to choose hotcold "
                        "(default: config.py hotcold_min_hit)")
    p.add_argument("--hotcold_refresh_interval", type=int, default=0,
                   help="adaptive hot-set refresh: every N tracked "
                        "requests, re-derive the hot set from the live "
                        "stream if its hit rate dropped (0 = off; "
                        "hotcold/auto single-device engines)")
    p.add_argument("--hotcold_refresh_margin", type=float, default=0.05,
                   help="refresh when live coverage falls this far below "
                        "the reference coverage")
    p.add_argument("--hotcold_refresh_window", type=int, default=16,
                   help="recent request batches buffered for hot-set "
                        "re-derivation (and its out-of-sample coverage "
                        "estimate)")
    p.add_argument("--hotcold_scan_budget", type=int, default=2_000_000,
                   help="cap on lookups the refresh/upgrade candidate "
                        "scan reads from the buffered window (<= 0 = "
                        "unlimited; an uncapped scan over rm2's window "
                        "stalls for seconds)")
    p.add_argument("--hotcold_scan_sync", action="store_true",
                   help="run the candidate scan INLINE on the dispatch "
                        "thread (deterministic refresh timing, but the "
                        "scan stalls serving once per window); default is "
                        "the async worker")
    p.add_argument("--hotcold_min_table_mb", type=float, default=128.0,
                   help="embedding_impl=auto considers the hot/cold "
                        "split only for fused tables at least this big "
                        "(a small table's direct gather is cheap, so the "
                        "split's host pass cannot pay); explicit "
                        "--embedding_impl hotcold bypasses the floor")
    p.add_argument("--accept_ragged", action="store_true",
                   help="serve RAGGED real-inference requests: engines "
                        "pre-warm a masked program per bucket and "
                        "/v1/predict takes 'lengths' (+ flat 'values' "
                        "CSR or padded indices); composes with every "
                        "backend and embedding_impl (hotcold consumes "
                        "the mask in the host splitter; mesh engines "
                        "shard it over 'data')")
    p.add_argument("--payload_arena_slots", type=int,
                   default=ServingConfig.payload_arena_slots,
                   help="cpu-mp payload transport capacity: blob-arena "
                        "slots, one per in-flight /v1/predict "
                        "sub-request; exhaustion fails the query loudly")
    p.add_argument("--table_pack", type=int, default=0,
                   help="pack N logical rows per physical table row "
                        "(0 and 1 = unpacked, see config.py "
                        "resolved_table_pack)")
    p.add_argument("--hot_set_rows", type=int, default=0,
                   help="hotcold hot-set rows; 0 = auto "
                        "(utils/memory.py suggest_hot_rows)")
    p.add_argument("--table_quant", type=str, default="none",
                   choices=["none", "int8", "int8_rowwise"],
                   help="embedding-table quantization (see config.py)")
    p.add_argument("--output_head", type=str, default="reference",
                   choices=["reference", "logits"],
                   help="relu-family (ncf/din/dien) score head: "
                        "'reference' = FC+relu (graph parity); 'logits' "
                        "= the final FC's pre-activation — REQUIRED to "
                        "rank a TRAINED model sanely (relu ties every "
                        "below-zero score; config.py output_head). The "
                        "head has no parameters: checkpoints serve "
                        "either")
    p.add_argument("--compute_dtype", type=str, default=None)

    # Standalone characterization (reference: inferenceEngine standalone mode)
    p.add_argument("--data_generation", type=str, default="random",
                   choices=["random", "synthetic", "dataset"])
    p.add_argument("--synthetic_data_trace_file", type=str, default=None)
    # Real-dataset mode (reference --data_set/--raw_data_file,
    # utils/utils.py:58-60; consumed dlrm_data_caffe2.py:36-37). Works with
    # --model criteo (26-table DLRM matching the Criteo columns) or any
    # reference-format JSON with 26 single-lookup tables.
    p.add_argument("--data_set", type=str, default="kaggle",
                   choices=["kaggle", "criteo"],
                   help="dataset flavor for --data_generation dataset "
                        "(both values mean Criteo display-advertising TSV)")
    p.add_argument("--raw_data_file", type=str, default=None,
                   help="Criteo TSV path for --data_generation dataset")
    p.add_argument("--num_batches", type=int, default=16)
    p.add_argument("--mini_batch_size", type=int, default=64)
    p.add_argument("--nepochs", type=int, default=1)

    # Serving mode (reference: --queue)
    p.add_argument("--queue", action="store_true")
    p.add_argument("--serve", action="store_true",
                   help="start the HTTP serving ingress instead of a load-generator run")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--serve_models", type=str, default=None,
                   help="comma-separated zoo models for multi-model serving "
                        "(POST /v1/models/<name>/infer); default: just --model")
    p.add_argument("--port", type=int, default=8321)
    p.add_argument("--reload_root", type=str, default=None,
                   help="directory checkpoint paths for POST /v1/reload "
                        "must live under; required to enable reloads on a "
                        "non-loopback --host")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="start from this trained checkpoint "
                        "(utils.checkpoint layout: <path>.npz + treedef "
                        "sidecar) instead of random init — standalone, "
                        "--queue, and --serve (applied to --model; other "
                        "--serve_models keep random init)")
    p.add_argument("--score_output", type=str, default=None,
                   help="standalone mode: write the last epoch's scores "
                        "to this .npz (offline batch scoring; combine "
                        "with --checkpoint and --data_generation dataset)")
    p.add_argument("--inference_engines", type=int, default=1)
    p.add_argument("--engine_backend", type=str, default="accel",
                   choices=("accel", "cpu", "cpu-mp", "sim"))
    p.add_argument("--avg_arrival_rate", type=float, default=10.0, help="ms")
    p.add_argument("--target_latency", type=float, default=25.0, help="ms (p95 SLA)")
    p.add_argument("--batch_size_distribution", type=str, default="fixed")
    p.add_argument("--avg_mini_batch_size", type=float, default=64)
    p.add_argument("--var_mini_batch_size", type=float, default=1)
    p.add_argument("--max_mini_batch_size", type=int, default=1024)
    p.add_argument("--batch_dist_file", type=str, default=None)
    p.add_argument("--sub_task_batch_size", type=int, default=64)
    p.add_argument("--bucket_policy", type=str, default="static",
                   choices=["static", "auto"],
                   help="auto: derive the batch-bucket ladder from the size distribution")
    p.add_argument("--max_auto_buckets", type=int, default=6)
    p.add_argument("--req_granularity", type=int, default=64)
    p.add_argument("--tune_batch_qps", action="store_true")
    p.add_argument("--tune_accel_qps", action="store_true")
    p.add_argument("--batch_configs", type=str, default="32-64-128-256-512-1024")
    p.add_argument("--accel_configs", type=str, default="128-256-512")
    p.add_argument("--stable_region", type=float, default=0.10)
    p.add_argument("--min_arr_range", type=float, default=1.0)
    p.add_argument("--max_arr_range", type=float, default=100.0)
    p.add_argument("--arr_steps", type=int, default=20)
    p.add_argument("--sched_timeout", type=int, default=100)
    p.add_argument("--model_accel", action="store_true",
                   help="add a big-batch offload engine (accelerator path)")
    p.add_argument("--accel_request_size_thres", type=int, default=1024)
    # Dynamic batching (an addition; off by default for
    # reference-faithful behavior, see config.py coalesce_requests).
    p.add_argument("--coalesce_requests", action="store_true",
                   help="engines drain waiting requests into one bucket "
                        "execution (the inverse of query splitting)")
    p.add_argument("--max_coalesce", type=int, default=8)
    p.add_argument("--numpy_rand_seed", type=int, default=123)
    p.add_argument("--log_file", type=str, default=None)
    p.add_argument("--debug_mode", action="store_true")
    # Per-op profiling (reference: --enable_profiling + prof_dag engine ->
    # workspace.benchmark_net; here: a jax.profiler trace viewable in
    # XProf/TensorBoard).
    p.add_argument("--enable_profiling", action="store_true")
    p.add_argument("--compilation_cache_dir", type=str, default=None,
                   help="persistent XLA compilation cache directory (engine "
                        "warm-up compiles are reused across restarts); "
                        "JAX_COMPILATION_CACHE_DIR wins when set, the "
                        "default is .jax_cache in the checkout")
    p.add_argument("--profile_dir", type=str, default="log/profile")
    return p


def _model_overrides(args) -> dict:
    overrides = {"param_dtype": args.param_dtype}
    if args.embedding_impl != "xla":
        overrides["embedding_impl"] = args.embedding_impl
        overrides["hot_set_rows"] = args.hot_set_rows
    if args.hotcold_min_hit is not None:
        overrides["hotcold_min_hit"] = args.hotcold_min_hit
    if args.hotcold_min_table_mb != 128.0:
        overrides["hotcold_min_table_mb"] = args.hotcold_min_table_mb
    if args.table_quant != "none":
        overrides["table_quant"] = args.table_quant
    if args.output_head != "reference":
        overrides["output_head"] = args.output_head
    overrides["table_pack"] = args.table_pack
    if args.compute_dtype:
        overrides["compute_dtype"] = args.compute_dtype
    elif args.param_dtype:
        overrides["compute_dtype"] = args.param_dtype
    return overrides


def model_config_from_args(args, name: str | None = None) -> ModelConfig:
    name = name if name is not None else args.model
    overrides = _model_overrides(args)
    if name == "criteo":
        from deeprecsys_tpu.data.criteo import criteo_model_config

        return criteo_model_config().replace(table_scale=args.table_scale,
                                             **overrides)
    if name in zoo.MODEL_NAMES:
        return zoo.get_config(name, table_scale=args.table_scale, **overrides)
    return load_model_config(name, table_scale=args.table_scale, **overrides)


def serving_config_from_args(args) -> ServingConfig:
    from deeprecsys_tpu.config import _parse_dims as dims

    return ServingConfig(
        num_batches=args.num_batches,
        nepochs=args.nepochs,
        avg_arrival_rate_ms=args.avg_arrival_rate,
        batch_size_distribution=args.batch_size_distribution,
        avg_mini_batch_size=args.avg_mini_batch_size,
        var_mini_batch_size=args.var_mini_batch_size,
        max_mini_batch_size=args.max_mini_batch_size,
        batch_dist_file=args.batch_dist_file,
        sub_task_batch_size=args.sub_task_batch_size,
        data_generation=args.data_generation,
        synthetic_trace_file=args.synthetic_data_trace_file,
        raw_data_file=args.raw_data_file,
        bucket_policy=args.bucket_policy,
        max_auto_buckets=args.max_auto_buckets,
        inference_engines=args.inference_engines,
        engine_backend=args.engine_backend,
        target_latency_ms=args.target_latency,
        req_granularity=args.req_granularity,
        tune_batch_qps=args.tune_batch_qps,
        tune_accel_qps=args.tune_accel_qps,
        batch_configs=dims(args.batch_configs),
        accel_configs=dims(args.accel_configs),
        stable_region=args.stable_region,
        min_arr_range=args.min_arr_range,
        max_arr_range=args.max_arr_range,
        arr_steps=args.arr_steps,
        sched_timeout=args.sched_timeout,
        model_accel=args.model_accel,
        accel_request_size_thres=args.accel_request_size_thres,
        coalesce_requests=args.coalesce_requests,
        max_coalesce=args.max_coalesce,
        hotcold_refresh_interval=args.hotcold_refresh_interval,
        hotcold_refresh_margin=args.hotcold_refresh_margin,
        hotcold_refresh_window=args.hotcold_refresh_window,
        hotcold_scan_budget=args.hotcold_scan_budget,
        hotcold_scan_async=not args.hotcold_scan_sync,
        accept_ragged=args.accept_ragged,
        payload_arena_slots=args.payload_arena_slots,
        seed=args.numpy_rand_seed,
        log_file=args.log_file,
        debug_mode=args.debug_mode,
    )


def _calibrated_latency_model(model_cfg: ModelConfig):
    """Calibrated-sim support: drive SimEngines with the model's measured
    accelerator ladder (CHARACTERIZATION_DIR, the reference's
    accel-simulation pattern fed with OUR hardware data). Used by both
    --queue and --serve when engine_backend=sim."""
    from deeprecsys_tpu.serving.latency_model import LatencyModel

    char = CHARACTERIZATION_DIR / f"accel_{model_cfg.model_name}.json"
    if not char.exists():
        raise SystemExit(
            f"engine_backend=sim needs a characterization file at {char}; "
            "run python -m deeprecsys_tpu.experiments.sweep first")
    lm = LatencyModel.load(char)
    print(f"[deeprecsys_tpu] sim engines calibrated from {char}", flush=True)
    return lm


def _checkpoint_params(model_cfg: ModelConfig, path: str):
    """Load a trained checkpoint against the model's param skeleton."""
    from deeprecsys_tpu.utils.checkpoint import load_model_params

    return load_model_params(model_cfg, path)


def run_standalone(model_cfg: ModelConfig, args) -> dict:
    """Characterization loop (reference inferenceEngine.py:137-173 and each
    model's __main__): separates data-generation time from device compute
    and prints the same three totals the reference's sweeps parse."""
    import jax
    import jax.numpy as jnp
    from deeprecsys_tpu.data import RecDataGenerator
    from deeprecsys_tpu.models import get_model
    from deeprecsys_tpu.models.base import Batch
    from deeprecsys_tpu.utils.devices import pick_accel_device

    # Params, batches and every compiled call sit on the picked device, so
    # the compute totals below are never the host CPU's by accident.
    device = pick_accel_device()
    print(f"[deeprecsys_tpu] standalone on {device} ({device.device_kind})",
          flush=True)
    model = get_model(model_cfg)
    if getattr(args, "checkpoint", None):
        params = _checkpoint_params(model_cfg, args.checkpoint)
    else:
        with jax.default_device(device):
            params = model.init(jax.random.PRNGKey(args.numpy_rand_seed))
    params = jax.device_put(params, device)
    gen = RecDataGenerator(model_cfg, seed=args.numpy_rand_seed,
                           data_generation=args.data_generation,
                           trace_file=args.synthetic_data_trace_file,
                           raw_data_file=args.raw_data_file)
    fn = jax.jit(model.apply)

    t_load = 0.0
    t0 = time.perf_counter()
    batches = [gen.generate_batch(args.mini_batch_size) for _ in range(args.num_batches)]
    t_load = time.perf_counter() - t0

    # Warm-up compile excluded from the computation total.
    dev = [Batch(dense=None if b.dense is None else jax.device_put(b.dense, device),
                 indices=jax.device_put(b.indices, device)) for b in batches]
    fn(params, dev[0]).block_until_ready()

    import contextlib

    profiler_ctx = (
        jax.profiler.trace(args.profile_dir) if args.enable_profiling
        else contextlib.nullcontext()
    )
    outs = None
    with profiler_ctx:
        for _ in range(args.nepochs):
            outs = [fn(params, b) for b in dev]
            jax.block_until_ready(outs)
    if getattr(args, "score_output", None):
        if outs is None:  # --nepochs 0: still score (scores ARE the ask)
            outs = [fn(params, b) for b in dev]
            jax.block_until_ready(outs)
        # Offline batch scoring: the per-batch outputs the characterization
        # loop already computed, concatenated and written f32 (the
        # reference discards its outputs after measuring the blob size,
        # inferenceEngine.py:52-58).
        import numpy as np

        scores = np.concatenate(
            [np.asarray(o).astype(np.float32) for o in outs], axis=0)
        np.savez(args.score_output, scores=scores)
        print(f"[deeprecsys_tpu] wrote {scores.shape[0]} x "
              f"{scores.shape[1]} scores to {args.score_output}", flush=True)
    # The compute total comes from a chained measurement, not the loop
    # above: K data-dependent iterations in one compiled loop, whose
    # two-point slope leaves out per-call dispatch and readback
    # (utils/timing.py). The loop still runs every batch (profiler
    # coverage + output parity).
    from deeprecsys_tpu.utils.timing import time_step_chain

    import numpy as np

    rows = np.asarray(model_cfg.scaled_rows, np.int32)[None, :, None]

    def step(i, c, dense, indices):
        idx = (indices + i) % rows
        out = model.apply(params, Batch(dense=dense, indices=idx))
        return c + jnp.sum(out.astype(jnp.float32))

    zero = jax.device_put(np.zeros((), np.float32), device)
    iters = max(8, min(64, args.num_batches))
    per_iter_ms = time_step_chain(step, zero, dev[0].dense, dev[0].indices,
                                  iters=iters, device=device)
    # Adaptive: fast models need longer chains to rise above the timing
    # noise floor (same compiled program — the trip count is a runtime
    # argument; bench.py uses the same escalation).
    while per_iter_ms * iters < 50.0 and iters < 16384:
        iters *= 8
        per_iter_ms = time_step_chain(step, zero, dev[0].dense,
                                      dev[0].indices, iters=iters,
                                      device=device)
    t_comp = per_iter_ms * args.num_batches * args.nepochs / 1000.0

    total_ms = (t_load + t_comp) * 1000.0
    # State the semantics IN the output, not just the source: the compute
    # total is per-iteration chained time x batches, NOT the sum of
    # per-batch wall-clock the reference prints — a consumer parsing the
    # *** lines must know which they got.
    print("(compute total = chained-timing per-iteration x num_batches; "
          "not per-batch wall-clock — see utils/timing.py; device "
          f"{device.platform} {device.device_kind})")
    print(f"Total data loading time: *** {t_load * 1000.0:.3f} ms")
    print(f"Total computation time: *** {t_comp * 1000.0:.3f} ms")
    print(f"Total execution time: *** {total_ms:.3f} ms")
    n = args.nepochs * args.num_batches * args.mini_batch_size
    print(f"Throughput: {n / (t_load + t_comp):.1f} samples/s")
    sys.stdout.flush()
    return {"load_ms": t_load * 1000, "compute_ms": t_comp * 1000, "total_ms": total_ms}


def main(argv=None):
    args = build_parser().parse_args(argv)
    from deeprecsys_tpu.utils.devices import init_compilation_cache

    init_compilation_cache(args.compilation_cache_dir)
    model_cfg = model_config_from_args(args)
    print(f"[deeprecsys_tpu] model={model_cfg.model_name} type={model_cfg.model_type} "
          f"tables={model_cfg.num_tables} rows={model_cfg.total_rows} "
          f"L={model_cfg.num_indices_per_lookup}")
    if args.serve:
        from deeprecsys_tpu.serving.ingress import HttpIngress, ServingServer

        serving_cfg = serving_config_from_args(args)
        need_lm = serving_cfg.engine_backend == "sim"
        if args.serve_models:
            registry = {}
            for name in args.serve_models.split(","):
                # Every model gets the FULL override set (--table_quant,
                # --embedding_impl, dtypes), not just the default one.
                m_cfg = (model_cfg if name == model_cfg.model_name else
                         model_config_from_args(args, name=name))
                lm = _calibrated_latency_model(m_cfg) if need_lm else None
                # In sim mode the offload engine is simulated too (the
                # reference's accelerator is always simulated).
                registry[name] = ServingServer(
                    m_cfg, serving_cfg, latency_model=lm,
                    accel_latency_model=lm,
                    checkpoint_path=(args.checkpoint if args.checkpoint
                                     and name == model_cfg.model_name
                                     else None))
            for s_ in registry.values():
                s_.start()
            ingress = HttpIngress(registry, host=args.host, port=args.port,
                                  default=next(iter(registry)),
                                  reload_root=args.reload_root)
        else:
            lm = _calibrated_latency_model(model_cfg) if need_lm else None
            server = ServingServer(model_cfg, serving_cfg, latency_model=lm,
                                   accel_latency_model=lm,
                                   checkpoint_path=args.checkpoint)
            server.start()
            ingress = HttpIngress(server, host=args.host, port=args.port,
                                  reload_root=args.reload_root)
        ingress.start()
        host, port = ingress.address
        print(f"[deeprecsys_tpu] serving on http://{host}:{port} "
              f"(POST /v1/infer, GET /v1/models, GET /v1/stats)", flush=True)
        import signal
        import threading

        stop_evt = threading.Event()
        signal.signal(signal.SIGTERM, lambda *_: stop_evt.set())
        try:
            while not stop_evt.is_set():
                stop_evt.wait(3600)
        except KeyboardInterrupt:
            pass
        print("[deeprecsys_tpu] shutting down serving", flush=True)
        ingress.stop()
        return None
    if args.queue:
        from deeprecsys_tpu.serving import run_serving

        serving_cfg = serving_config_from_args(args)
        import contextlib

        import jax

        lm = (_calibrated_latency_model(model_cfg)
              if serving_cfg.engine_backend == "sim" else None)
        profiler_ctx = (
            jax.profiler.trace(args.profile_dir) if args.enable_profiling
            else contextlib.nullcontext()
        )
        with profiler_ctx:
            # In sim mode the offload engine is simulated too (the
            # reference's accelerator is always simulated); lm is None for
            # every other backend.
            res = run_serving(model_cfg, serving_cfg, latency_model=lm,
                              accel_latency_model=lm,
                              log_responses=args.log_file is not None,
                              checkpoint_path=args.checkpoint)
        print("Measured QPS: ", res.measured_qps)
        print("Measured p95 tail-latency: ", res.p95_ms, " ms")
        print("Measured p99 tail-latency: ", res.p99_ms, " ms")
        print(json.dumps(res.to_dict()))
        return res
    return run_standalone(model_cfg, args)


if __name__ == "__main__":
    main()
