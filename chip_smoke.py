"""Bring-up check of the served path on an NVIDIA GPU.

    python chip_smoke.py            # one GPU: every phase below
    python chip_smoke.py --four     # four GPUs: mesh serving + dryrun_multichip(4)

Rehearsal on the host CPU at a tiny size (never a measurement):

    JAX_PLATFORMS=cpu python chip_smoke.py --rehearse --table_scale 20000 \\
        --batch 16 --requests 8 --calls 3
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python chip_smoke.py --rehearse --four --table_scale 20000

One-GPU phases, all in this process:

1. environment: card name and power limit, JAX version, device kind and
   count, compile-cache directory, native runtime;
2. forward correctness of all eight zoo models at full width against the
   NumPy oracle (tests/oracle/np_reference.py) in three variants: f32 at
   "highest" matmul precision, f32 at the default precision (TF32 allowed)
   and bf16 params at the bench's settings (tables unpacked, the default);
3. per-call forward time of each model at the bench's settings, and row
   packing on and off for rm1, rm3 and din (informational, not a
   benchmark);
4. a profiler trace of rm1 reduced to device-busy time
   (utils/profiling.py), checked against the host clock;
5. the parameter layouts XLA picks under ``Layout.AUTO`` for rm1, rm2 and
   din, and their device-busy time against the default layouts
   (informational);
6. the served path: rm1 through ``ServingServer`` + ``HttpIngress`` as
   ``main.py --serve`` builds them, 64 ``POST /v1/predict`` requests whose
   scores must match the direct forward, with the direct gather and again
   with the hot/cold split.

Any failed check raises, so the script exits non-zero and never prints
the last line. The last line of standard output is one JSON object with
the device as JAX reports it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import subprocess
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
MODELS = ("rm1", "rm2", "rm3", "wnd", "mtwnd", "ncf", "din", "dien")
PACK_MODELS = ("rm1", "rm3", "din")
LAYOUT_MODELS = ("rm1", "rm2", "din")

# (atol, rtol, reason): an output passes where |ours - oracle| <=
# atol + rtol * |oracle|. The CPU tests hold f32 to 1e-5 (test_parity.py).
TOLERANCES = {
    "f32-highest": (1e-4, 1e-4,
                    "f32 at full matmul precision; the GPU sums in another "
                    "order than the float64 oracle (10x the CPU tests' 1e-5)"),
    "f32-default": (1e-2, 1e-2,
                    "default precision lets f32 matmuls run in TF32 (10-bit "
                    "mantissa, unit roundoff 4.9e-4) (1000x the CPU tests)"),
    "bf16": (5e-2, 5e-2,
             "bf16 params and activations (8-bit mantissa, unit roundoff "
             "3.9e-3), rounded at every layer boundary (5000x the CPU tests)"),
}
# Served scores against the direct forward of the same rows. The direct
# engines differ from it only in batch shape (bucket padding, sub-batches),
# so the bound is a few bf16 ulps of a score in (0, 1]; the hot/cold split
# also sums each bag in another order, so it is held to the bf16 bound.
SERVE_TOL = {"xla": (2.0 ** -6, 0.0, "4 bf16 ulps at 1.0; only the batch "
                     "shape differs from the direct forward"),
             "hotcold": TOLERANCES["bf16"][:2] + (
                 "bf16 bound: the split sums hot and cold rows in another "
                 "order",)}


def log(msg: str) -> None:
    print(msg, flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU phases (mesh serving and "
                         "dryrun_multichip(4))")
    ap.add_argument("--rehearse", action="store_true",
                    help="allow JAX's CPU backend (JAX_PLATFORMS=cpu) for a "
                         "rehearsal at a tiny --table_scale")
    ap.add_argument("--table_scale", type=int, default=1,
                    help="divide table rows (1 = full width)")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--requests", type=int, default=64,
                    help="POST /v1/predict requests per served run")
    ap.add_argument("--calls", type=int, default=20,
                    help="timed calls per forward-time measurement")
    ap.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "chip_smoke",
                    help="directory for the profiler trace and its listing")
    return ap.parse_args(argv)


# ----------------------------------------------------------------------
# Phase 1: environment
# ----------------------------------------------------------------------


def phase_environment(args):
    """Checks the platform; sets ``args.card`` to the card's name and power
    limit, printed beside every time (a card set below its maximum power
    runs slower)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.rehearse:
        raise SystemExit(f"chip_smoke: no GPU (JAX devices: {jax.devices()}); "
                         f"use --rehearse with JAX_PLATFORMS=cpu for a CPU "
                         f"rehearsal")
    from deeprecsys_tpu.runtime import native
    from deeprecsys_tpu.utils.devices import init_compilation_cache, pick_accel_device

    device = pick_accel_device()
    if shutil.which("nvidia-smi"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True).stdout.strip()
        log("card (nvidia-smi name, power.limit):")
        for line in smi.splitlines():
            log(line)
        args.card = smi.splitlines()[0]
    elif not args.rehearse:
        raise SystemExit("chip_smoke: nvidia-smi not found")
    else:
        log("card: none (CPU rehearsal)")
        args.card = "CPU rehearsal"
    log(f"jax {jax.__version__}; device_kind {dev.device_kind!r}; "
        f"platform {dev.platform}; device count {len(jax.devices())}")
    log(f"compile cache: {init_compilation_cache()}")
    built = native.native_available()
    log(f"native runtime built: {built}"
        + ("" if built else f" ({native._build_error})"))
    if not built:
        raise RuntimeError("native runtime did not build; the hot/cold "
                           "served path needs its splitter")
    return device


# ----------------------------------------------------------------------
# Shared helpers
# ----------------------------------------------------------------------


def model_config(name, args, dtype, **overrides):
    from deeprecsys_tpu import zoo

    return zoo.get_config(name, table_scale=args.table_scale,
                          param_dtype=dtype, compute_dtype=dtype, **overrides)


def init_params(model, device, seed=0):
    import jax

    with jax.default_device(device):
        params = jax.jit(model.init)(jax.random.PRNGKey(seed))
    if "rnn0" in params:
        # dien: the reference's plain-randn RNN init saturates tanh and
        # makes the 40-step recurrence chaotic, so any two correct
        # implementations diverge; scale the recurrent weights into the
        # stable regime for both paths (as tests/test_parity.py does).
        for rnn in ("rnn0", "rnn1"):
            params[rnn] = {k: v * 0.05 for k, v in params[rnn].items()}
    return jax.block_until_ready(params)


def device_batch(host, device):
    import jax

    from deeprecsys_tpu.models.base import Batch

    return Batch(dense=None if host.dense is None
                 else jax.device_put(host.dense, device),
                 indices=jax.device_put(host.indices, device))


def oracle_scores(cfg, params, host):
    import importlib.util

    import jax

    # Loaded by path: tests/ is no package, and an installed top-level
    # "tests" package would shadow it.
    spec = importlib.util.spec_from_file_location(
        "np_reference", ROOT / "tests" / "oracle" / "np_reference.py")
    oracle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(oracle)
    w = oracle.oracle_weights_from_params(jax.device_get(params), cfg)
    s_idx, s_len = oracle.csr_from_batch(host.indices)
    x = None if host.dense is None else np.asarray(host.dense, np.float64)
    return oracle.oracle_forward(cfg, w, x, s_idx, s_len)


def compare(ours, ref, atol, rtol):
    """(max abs error, max rel error, worst error / allowed)."""
    ours = np.asarray(ours, np.float64)
    if ours.shape != ref.shape or not np.isfinite(ours).all():
        raise AssertionError(f"shape {ours.shape} vs {ref.shape}, "
                             f"finite={np.isfinite(ours).all()}")
    err = np.abs(ours - ref)
    rel = err / np.maximum(np.abs(ref), 1e-6)
    return float(err.max()), float(rel.max()), float(
        (err / (atol + rtol * np.abs(ref))).max())


def time_calls(fn, *args, calls):
    """Host-clock ms of each call, ended by block_until_ready."""
    out = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn(*args).block_until_ready()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


# ----------------------------------------------------------------------
# Phases 2-3: forward correctness and per-call time
# ----------------------------------------------------------------------


def phase_forward(args, device, report):
    import jax

    from deeprecsys_tpu.data import RecDataGenerator
    from deeprecsys_tpu.models import get_model

    log("== forward correctness vs the NumPy oracle, b=%d, table_scale %d =="
        % (args.batch, args.table_scale))
    for variant, (atol, rtol, why) in TOLERANCES.items():
        log(f"tolerance {variant}: atol {atol:g} rtol {rtol:g} — {why}")
    failures = []
    for name in MODELS:
        cfg32 = model_config(name, args, "float32")
        host = RecDataGenerator(cfg32, seed=1).generate_batch(args.batch)
        model = get_model(cfg32)
        params = init_params(model, device)
        ref = oracle_scores(cfg32, params, host)
        batch = device_batch(host, device)
        for variant, ctx in (("f32-highest",
                              jax.default_matmul_precision("highest")),
                             ("f32-default", contextlib.nullcontext())):
            with ctx:
                fn = jax.jit(model.apply)
                t0 = time.perf_counter()
                out = fn(params, batch).block_until_ready()
                compile_s = time.perf_counter() - t0
            failures += check(name, variant, out, ref, compile_s, report)
        del params, fn

        cfg16 = model_config(name, args, "bfloat16")
        model16 = get_model(cfg16)
        params16 = init_params(model16, device)
        ref16 = oracle_scores(cfg16, params16, host)
        fn16 = jax.jit(model16.apply)
        t0 = time.perf_counter()
        try:
            out = fn16(params16, batch).block_until_ready()
        except jax.errors.JaxRuntimeError as e:
            # XLA's CPU backend has no batched bf16 x bf16 -> f32 dot
            # (mtwnd, din, dien); only a CPU rehearsal may pass over it.
            if device.platform != "cpu" or "UNIMPLEMENTED" not in str(e):
                raise
            log(f"  {name:5s} bf16        not run: CPU backend: {e}")
            continue
        compile_s = time.perf_counter() - t0
        failures += check(name, "bf16", out, ref16, compile_s, report,
                          extra=f"table_pack {cfg16.resolved_table_pack}")
        ms = time_calls(fn16, params16, batch, calls=args.calls)
        report["forward_ms"][name] = float(np.median(ms))
        log(f"  {name} bf16 b={args.batch}: {np.median(ms):.4f} ms/call "
            f"(median of {len(ms)}, host clock around block_until_ready; "
            f"not a benchmark; {args.card})")
        if name in PACK_MODELS:
            pack_turns(name, args, device, batch, fn16, params16, report)
        del params16, fn16
    if failures:
        raise AssertionError("forward checks failed: " + "; ".join(failures))


def check(name, variant, out, ref, compile_s, report, extra=""):
    atol, rtol, _ = TOLERANCES[variant]
    e_abs, e_rel, ratio = compare(out, ref, atol, rtol)
    ok = ratio <= 1.0
    report["forward"].setdefault(name, {})[variant] = {
        "max_abs": e_abs, "max_rel": e_rel, "worst_over_allowed": ratio,
        "compile_s": compile_s}
    log(f"  {name:5s} {variant:11s} max abs {e_abs:.3e} max rel {e_rel:.3e} "
        f"worst/allowed {ratio:.3f} {'ok' if ok else 'FAIL'} "
        f"(compile+first call {compile_s:.2f} s{', ' + extra if extra else ''})")
    return [] if ok else [f"{name} {variant} worst/allowed {ratio:.3f}"]


def in_turns(fn_a, params_a, fn_b, params_b, batch, calls):
    """Median host-clock ms of a and of b over 3 alternating turns, and
    the largest score difference between them."""
    diff = float(np.abs(np.asarray(fn_a(params_a, batch), np.float32)
                        - np.asarray(fn_b(params_b, batch), np.float32)).max())
    a, b = [], []
    for _ in range(3):
        a += time_calls(fn_a, params_a, batch, calls=calls)
        b += time_calls(fn_b, params_b, batch, calls=calls)
    return float(np.median(a)), float(np.median(b)), diff


def pack_turns(name, args, device, batch, fn16, params16, report):
    """Two rows packed per 128 bytes (table_pack=2) against the default
    unpacked tables, in turns on the same batch."""
    import jax

    from deeprecsys_tpu.models import get_model

    model2 = get_model(model_config(name, args, "bfloat16", table_pack=2))
    params2 = init_params(model2, device)
    p, u, diff = in_turns(jax.jit(model2.apply), params2, fn16, params16,
                          batch, args.calls)
    report["packing"][name] = {"pack_2_ms": p, "pack_1_ms": u}
    log(f"  {name} packing (3 turns of {args.calls} calls): pack 2 "
        f"{p:.4f} ms, unpacked {u:.4f} ms, unpacked/pack2 {u / p:.3f}; "
        f"max score diff {diff:.2e} ({args.card})")
    if diff > TOLERANCES["bf16"][0]:
        raise AssertionError(f"{name}: packed and unpacked scores differ by "
                             f"{diff}")


# ----------------------------------------------------------------------
# Phase 4: trace reduction
# ----------------------------------------------------------------------


def phase_trace(args, device, report):
    import jax

    from deeprecsys_tpu.data import RecDataGenerator
    from deeprecsys_tpu.models import get_model
    from deeprecsys_tpu.utils.profiling import device_busy_ms, read_planes

    cfg = model_config("rm1", args, "bfloat16")
    model = get_model(cfg)
    params = init_params(model, device)
    batch = device_batch(
        RecDataGenerator(cfg, seed=1).generate_batch(args.batch), device)
    fn = jax.jit(model.apply)
    fn(params, batch).block_until_ready()
    trace_dir = args.out / "trace_rm1"
    shutil.rmtree(trace_dir, ignore_errors=True)
    calls = 5
    with jax.profiler.trace(str(trace_dir)):
        wall = time_calls(fn, params, batch, calls=calls)
    busy = device_busy_ms(trace_dir)
    busy_ms = sum(busy.values()) / calls
    wall_ms = float(np.mean(wall))
    listing = args.out / "trace_rm1_planes.txt"
    with open(listing, "w") as f:
        for plane, lines in read_planes(trace_dir):
            for line, evs in lines:
                f.write(f"{plane} | {line} | {len(evs)} events\n")
    log(f"== trace: rm1 bf16 b={args.batch}, {calls} calls: device busy "
        f"{busy_ms:.4f} ms/call over planes {sorted(busy)}; host clock "
        f"{wall_ms:.4f} ms/call ({args.card}; listing: {listing})")
    report["trace_rm1"] = {"busy_ms_per_call": busy_ms,
                           "host_ms_per_call": wall_ms}
    if not 0.0 < busy_ms <= wall_ms:
        raise AssertionError(f"device busy {busy_ms} ms outside (0, host "
                             f"clock {wall_ms} ms]")


def phase_layouts(args, device, report):
    """The parameter layouts XLA picks when asked (``Layout.AUTO``) for
    each model in LAYOUT_MODELS, against the layouts the params already
    have, and the device-busy time of the default params against copies
    placed in the AUTO formats, in turns (default, AUTO, AUTO, default).
    Informational: serving engines place params in the default layouts."""
    import jax
    from jax.experimental.layout import Format, Layout

    from deeprecsys_tpu.data import RecDataGenerator
    from deeprecsys_tpu.models import get_model
    from deeprecsys_tpu.utils.profiling import traced_call_ms

    log(f"== parameter layouts: Layout.AUTO against the default, bf16 "
        f"b={args.batch} ==")
    for name in LAYOUT_MODELS:
        cfg = model_config(name, args, "bfloat16")
        model = get_model(cfg)
        params = init_params(model, device)
        batch = device_batch(
            RecDataGenerator(cfg, seed=1).generate_batch(args.batch), device)
        sds = jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), (params, batch))
        with jax.default_device(device):
            compiled = jax.jit(model.apply, in_shardings=Format(
                Layout.AUTO)).lower(*sds).compile()
        auto_fmts = compiled.input_formats[0][0]
        leaves = jax.tree_util.tree_leaves_with_path(params)
        auto_leaves = jax.tree_util.tree_leaves(auto_fmts)
        differ = []
        for (path, leaf), fmt in zip(leaves, auto_leaves):
            if fmt.layout != leaf.format.layout:
                differ.append(f"{jax.tree_util.keystr(path)} "
                              f"{leaf.format.layout} -> {fmt.layout}")
        moved = jax.device_put(params, auto_fmts)
        fn = jax.jit(model.apply)
        run_default = lambda: fn(params, batch).block_until_ready()
        run_auto = lambda: fn(moved, batch).block_until_ready()
        d1, a1, a2, d2 = (traced_call_ms(r, calls=args.calls) for r in
                          (run_default, run_auto, run_auto, run_default))
        report["layouts"][name] = {
            "params": len(leaves), "non_default": differ,
            "busy_ms_default": [d1, d2], "busy_ms_auto_copies": [a1, a2]}
        log(f"  {name}: AUTO picks a non-default layout for {len(differ)} of "
            f"{len(leaves)} params{': ' + '; '.join(differ) if differ else ''}"
            f"; device busy ms/call default {d1:.4f}/{d2:.4f}, params "
            f"placed in the AUTO formats {a1:.4f}/{a2:.4f} ({args.card})")
        del params, moved, fn


def phase_gpu_tests(args, device):
    """The tests marked ``gpu`` (tests/test_gpu.py), called directly."""
    import importlib.util
    import inspect

    if device.platform != "gpu":
        log("== gpu tests: not run (CPU rehearsal)")
        return
    spec = importlib.util.spec_from_file_location(
        "test_gpu", ROOT / "tests" / "test_gpu.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name, fn in sorted(vars(mod).items()):
        if not (name.startswith("test_") and callable(fn)):
            continue
        kwargs = {}
        if "tmp_path" in inspect.signature(fn).parameters:
            kwargs["tmp_path"] = args.out / name
            kwargs["tmp_path"].mkdir(parents=True, exist_ok=True)
        fn(**kwargs)
        log(f"== gpu test {name}: ok")


# ----------------------------------------------------------------------
# Phase 5: the served path
# ----------------------------------------------------------------------


def serve_configs(args, impl):
    """Model and serving configs as ``main.py --serve`` builds them for
    scripts/run_serve.sh's operating point."""
    from deeprecsys_tpu.main import (
        build_parser,
        model_config_from_args,
        serving_config_from_args,
    )

    argv = ["--model", "rm1", "--table_scale", str(args.table_scale),
            "--param_dtype", "bfloat16", "--serve", "--port", "0",
            "--inference_engines", "2", "--sub_task_batch_size", "64",
            "--max_mini_batch_size", "1024",
            "--batch_size_distribution", "normal",
            "--avg_mini_batch_size", "165", "--var_mini_batch_size", "16",
            "--bucket_policy", "auto", "--embedding_impl", impl]
    a = build_parser().parse_args(argv)
    return model_config_from_args(a), serving_config_from_args(a)


def post_predict(port, host):
    body = {"indices": host.indices.tolist()}
    if host.dense is not None:
        body["dense"] = host.dense.tolist()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/predict", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())["scores"]


def serve_once(args, impl, params, requests, direct, report):
    """Serve ``requests`` through the HTTP ingress; every response must
    match ``direct`` (scores of the same rows from a direct forward)."""
    from deeprecsys_tpu.serving.ingress import HttpIngress, ServingServer

    mcfg, scfg = serve_configs(args, impl)
    server = ServingServer(mcfg, scfg, params=params)
    t0 = time.perf_counter()
    server.start(timeout=900)
    warm_s = time.perf_counter() - t0
    ingress = HttpIngress(server, port=0)
    ingress.start()
    port = ingress.address[1]
    results = [None] * len(requests)
    lat = [None] * len(requests)
    errors = []

    def client(k):
        for i in range(k, len(requests), 4):
            t = time.perf_counter()
            try:
                results[i] = np.asarray(post_predict(port, requests[i]),
                                        np.float64)
            except Exception as e:  # counted; the check below fails the run
                errors.append(f"request {i}: {type(e).__name__}: {e}")
            lat[i] = (time.perf_counter() - t) * 1e3

    try:
        threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        ingress.stop()
    atol, rtol, why = SERVE_TOL[impl]
    worst, n_match = 0.0, 0
    for got, want in zip(results, direct):
        if got is None:
            continue
        _, _, ratio = compare(got, want, atol, rtol)
        worst = max(worst, ratio)
        n_match += ratio <= 1.0
    p50, p95 = (float(np.percentile(lat, q)) for q in (50, 95))
    report["serve"][impl] = {
        "requests": len(requests), "errors": len(errors), "matched": n_match,
        "worst_over_allowed": worst, "warmup_s": warm_s,
        "client_p50_ms": p50, "client_p95_ms": p95}
    log(f"  {impl}: {len(requests) - len(errors)}/{len(requests)} answered, "
        f"{n_match}/{len(requests)} match the direct forward (atol {atol:g} "
        f"rtol {rtol:g}: {why}; worst/allowed {worst:.3f}); engine warm-up "
        f"incl. compiles {warm_s:.1f} s; client p50 {p50:.1f} ms, p95 "
        f"{p95:.1f} ms (informational; {args.card})")
    if errors or n_match != len(requests):
        raise AssertionError(f"served path {impl}: {len(errors)} errors "
                             f"({errors[:3]}), {n_match}/{len(requests)} match")


def make_requests(cfg, args, seed=7):
    """normal(165, 16) query sizes capped to [1, 1024] (run_serve.sh), with
    generator rows."""
    from deeprecsys_tpu.data import RecDataGenerator
    from deeprecsys_tpu.models.base import Batch

    rng = np.random.default_rng(seed)
    sizes = np.clip(np.rint(rng.normal(165, 16, args.requests)), 1,
                    1024).astype(int)
    rows = RecDataGenerator(cfg, seed=seed).generate_batch(int(sizes.sum()))
    cuts = np.cumsum(sizes)[:-1]
    dense = (None if rows.dense is None else np.split(rows.dense, cuts))
    return rows, [Batch(dense=None if dense is None else dense[i],
                        indices=idx)
                  for i, idx in enumerate(np.split(rows.indices, cuts))]


def direct_scores(model, params, rows, requests, device):
    """Scores of every request's rows from ONE direct forward over all of
    them (the models score each row independently)."""
    import jax

    out = np.asarray(jax.jit(model.apply)(params, device_batch(rows, device)),
                     np.float64)
    return np.split(out, np.cumsum([len(r.indices) for r in requests])[:-1])


def phase_serve(args, device, report):
    from deeprecsys_tpu.models import get_model

    mcfg, scfg = serve_configs(args, "xla")
    log(f"== served path: rm1 bf16 (table_pack {mcfg.resolved_table_pack}), "
        f"{scfg.inference_engines} engines, bucket_policy "
        f"{scfg.bucket_policy}, {args.requests} POST /v1/predict ==")
    model = get_model(mcfg)
    params = init_params(model, device)
    rows, requests = make_requests(mcfg, args)
    direct = direct_scores(model, params, rows, requests, device)
    for impl in ("xla", "hotcold"):
        serve_once(args, impl, params, requests, direct, report)


# ----------------------------------------------------------------------
# Four GPUs
# ----------------------------------------------------------------------


def phase_four(args, report):
    import jax

    import __graft_entry__
    from deeprecsys_tpu.data import RecDataGenerator
    from deeprecsys_tpu.models import get_model
    from deeprecsys_tpu.models.base import Batch
    from deeprecsys_tpu.parallel import make_mesh
    from deeprecsys_tpu.serving.ingress import ServingServer

    if len(jax.devices()) < 4:
        raise SystemExit(f"--four needs 4 devices; JAX sees {jax.devices()}")
    devices = jax.devices()[:4]
    mesh = make_mesh(data=1, model=4, devices=devices)
    cfg = model_config("rm2", args, "float32")
    log(f"== rm2 f32 row-sharded over a 1x4 ('data', 'model') mesh, "
        f"table_scale {args.table_scale}, vs one device ==")
    model = get_model(cfg)
    params = init_params(model, devices[0])
    rows, requests = make_requests(cfg, args)
    direct = direct_scores(model, params, rows, requests, devices[0])
    from deeprecsys_tpu.main import build_parser, serving_config_from_args

    scfg = serving_config_from_args(build_parser().parse_args(
        ["--sub_task_batch_size", "64", "--max_mini_batch_size", "1024",
         "--batch_size_distribution", "normal", "--avg_mini_batch_size",
         "165", "--var_mini_batch_size", "16", "--bucket_policy", "auto"]))
    server = ServingServer(cfg, scfg, params=params, mesh=mesh)
    t0 = time.perf_counter()
    server.start(timeout=900)
    warm_s = time.perf_counter() - t0
    atol, rtol, _ = TOLERANCES["f32-default"]
    worst = 0.0
    try:
        for req, want in zip(requests, direct):
            got = server.predict(indices=req.indices, dense=req.dense,
                                 timeout=300)["scores"]
            worst = max(worst, compare(got, want, atol, rtol)[2])
    finally:
        server.stop()
    report["mesh_rm2"] = {"requests": len(requests), "warmup_s": warm_s,
                          "worst_over_allowed": worst}
    log(f"  {len(requests)} requests, sharded vs one-device scores worst/"
        f"allowed {worst:.3f} (atol {atol:g} rtol {rtol:g}: the psum and "
        f"TF32 matmuls sum in another order); warm-up {warm_s:.1f} s "
        f"({args.card})")
    if worst > 1.0:
        raise AssertionError(f"mesh scores differ: worst/allowed {worst}")
    t0 = time.perf_counter()
    __graft_entry__.dryrun_multichip(4)
    log(f"== dryrun_multichip(4): ok ({time.perf_counter() - t0:.1f} s)")


def main(argv=None):
    args = parse_args(argv)
    args.out.mkdir(parents=True, exist_ok=True)
    t_start = time.perf_counter()
    device = phase_environment(args)
    import jax

    report = {"forward": {}, "forward_ms": {}, "packing": {}, "serve": {},
              "layouts": {}}
    if args.four:
        phase_four(args, report)
    else:
        phase_forward(args, device, report)
        phase_trace(args, device, report)
        phase_layouts(args, device, report)
        phase_gpu_tests(args, device)
        phase_serve(args, device, report)
    report["seconds"] = time.perf_counter() - t_start
    (args.out / ("report_four.json" if args.four else "report.json")).write_text(
        json.dumps(report, indent=1))
    log(f"all phases passed in {report['seconds']:.1f} s")
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
