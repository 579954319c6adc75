"""Render the experiment-suite plots from the recorded benchmark JSONs.

The reference ships its characterization as rendered figures
(`experiments/operator_breakdown/png/op_breakdown_{cpu,gpu}.png`,
`experiments/speedup/png/model_speedup.png`, generated by
`sweep_p.py:164-282` / `sweep_rt.py:186-222`); this is the analog for OUR
recorded artifacts — it reads benchmarks/*.json (no device needed) and
writes PNGs next to them:

  op_breakdown.png       per-stage device-time fractions, stacked bars
                         (from op_breakdown.json)
  model_speedup.png      accelerator-vs-CPU speedup at b=512 (from
                         last_bench.json, written by bench.py)
  qps_sla.png            latency-bounded QPS at the p95 SLA per model
                         (from qps_sweep.json)

Usage: python -m deeprecsys_tpu.experiments.plots [--bench-dir benchmarks]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

# Validated categorical palette (fixed slot order, never cycled) + ink and
# surface tokens; stages map to slots in one canonical order so a stage
# keeps its hue across charts and models.
SERIES = ("#2a78d6", "#eb6834", "#1baf7a", "#eda100", "#e87ba4", "#008300",
          "#4a3aa7")
STAGE_ORDER = ("embedding", "bottom_mlp", "interaction", "top_mlp",
               "attention", "rnn", "task_heads")
STAGE_LABEL = {"embedding": "embedding gather", "bottom_mlp": "bottom MLP",
               "interaction": "interaction", "top_mlp": "top MLP",
               "attention": "attention", "rnn": "RNN",
               "task_heads": "task heads"}
SURFACE = "#fcfcfb"
INK = "#0b0b0b"
INK_2 = "#52514e"
GRID = "#e4e3df"


def _style(ax):
    ax.set_facecolor(SURFACE)
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    for side in ("left", "bottom"):
        ax.spines[side].set_color(GRID)
    ax.tick_params(colors=INK_2, labelcolor=INK)
    ax.grid(True, axis="x" if ax.get_xscale() == "log" else "y",
            color=GRID, linewidth=0.7, zorder=0)
    ax.set_axisbelow(True)


def plot_op_breakdown(bench_dir: Path, out: Path):
    import matplotlib.pyplot as plt

    all_rows = json.loads((bench_dir / "op_breakdown.json").read_text())
    unknown = {s for r in all_rows for s in r["stage_fraction"]} - set(STAGE_ORDER)
    if unknown:  # a silent omission would make a stack quietly top out < 100%
        raise ValueError(f"stages missing from STAGE_ORDER: {sorted(unknown)}")
    # The artifact may hold a batch LADDER per model; a stacked bar chart
    # is one batch's story — plot the largest measured batch (duplicate
    # categorical x positions would overlay stacks from different batches
    # with independent bottoms).
    by_batch: dict[int, list] = {}
    for r in all_rows:
        by_batch.setdefault(r["batch"], []).append(r)
    batch = max(by_batch)
    rows = by_batch[batch]
    models = [r["model"] for r in rows]
    if len(set(models)) != len(models):
        raise ValueError(f"duplicate models at batch {batch}: {models}")
    fig, ax = plt.subplots(figsize=(7, 4), facecolor=SURFACE)
    _style(ax)
    bottoms = [0.0] * len(models)
    for si, stage in enumerate(STAGE_ORDER):
        vals = [r["stage_fraction"].get(stage, 0.0) * 100 for r in rows]
        if not any(vals):
            continue
        ax.bar(models, vals, bottom=bottoms, width=0.55, color=SERIES[si],
               edgecolor=SURFACE, linewidth=2, label=STAGE_LABEL[stage],
               zorder=3)
        bottoms = [b + v for b, v in zip(bottoms, vals)]
    for i, r in enumerate(rows):  # direct label on the dominant stage
        emb = r["stage_fraction"].get("embedding", 0.0) * 100
        ax.text(i, emb / 2, f"{emb:.0f}%", ha="center", va="center",
                color=SURFACE, fontsize=10, fontweight="bold")
    ax.set_ylabel("share of device time (%)", color=INK)
    ax.set_ylim(0, 100)
    ax.set_title(f"Per-stage device time, batch {batch}"
                 " (op_breakdown.json)", color=INK, fontsize=11)
    ax.legend(frameon=False, labelcolor=INK, fontsize=9, loc="center left",
              bbox_to_anchor=(1.0, 0.5))
    fig.tight_layout()
    fig.savefig(out, dpi=150, facecolor=SURFACE)
    plt.close(fig)


def plot_model_speedup(bench_dir: Path, out: Path):
    import matplotlib.pyplot as plt

    d = json.loads((bench_dir / "last_bench.json").read_text())
    models = list(d["accel"])
    sp = [d["accel"][m]["samples_per_s"]
          / d["cpu_baseline"]["results"][m]["samples_per_s"] for m in models]
    fig, ax = plt.subplots(figsize=(7, 4), facecolor=SURFACE)
    ax.set_xscale("log")
    _style(ax)
    y = range(len(models))[::-1]
    ax.barh(list(y), sp, height=0.55, color=SERIES[0], edgecolor=SURFACE,
            linewidth=2, zorder=3)
    for yi, v in zip(y, sp):
        ax.text(v * 1.1, yi, f"{v:.1f}x", va="center", color=INK, fontsize=9)
    ax.set_yticks(list(y), models)
    ax.set_xlabel("accelerator bf16 over CPU f32 throughput, batch 512 (log scale)",
                  color=INK)
    ax.axvline(2.0, color=INK_2, linewidth=1, linestyle="--", zorder=2)
    ax.text(2.0, len(models) - 0.4, " 2x target", color=INK_2, fontsize=8)
    ax.set_xlim(1, max(sp) * 2.5)
    ax.set_title("Model speedup (last_bench.json)", color=INK, fontsize=11)
    fig.tight_layout()
    fig.savefig(out, dpi=150, facecolor=SURFACE)
    plt.close(fig)


def plot_zipf_bench(bench_dir: Path, out: Path):
    """Skew-aware bench: direct gather vs the engines' auto decision on
    the zipf(1.2) stream (zipf_bench.json, bench.py --stream zipf)."""
    import matplotlib.pyplot as plt

    path = bench_dir / "zipf_bench.json"
    if not path.exists():
        print(f"skip zipf figure: {path} missing")
        return
    d = json.loads(path.read_text())
    models = [m for m in ("rm1", "rm2", "rm3", "din") if m in d["results"]]
    if not models:
        print("skip zipf figure: no models recorded")
        return
    xla = [d["results"][m]["xla"]["samples_per_s"] / 1e3 for m in models]
    auto = [d["results"][m]["auto"]["samples_per_s"] / 1e3 for m in models]
    fig, ax = plt.subplots(figsize=(7, 4), facecolor=SURFACE)
    _style(ax)
    y = [i for i in range(len(models))][::-1]
    h = 0.32
    ax.barh([yi + h / 2 + 0.02 for yi in y], xla, height=h, color=SERIES[0],
            edgecolor=SURFACE, linewidth=2, zorder=3, label="direct gather (xla)")
    ax.barh([yi - h / 2 - 0.02 for yi in y], auto, height=h, color=SERIES[1],
            edgecolor=SURFACE, linewidth=2, zorder=3,
            label="embedding_impl=auto")
    for yi, m in zip(y, models):
        r = d["results"][m]
        cov = r["auto"].get("hot_coverage")
        note = f"{r['auto_vs_xla']:.2f}x" + (
            f" (hot {cov:.0%})" if cov is not None else " (guard: direct)")
        ax.text(max(r["xla"]["samples_per_s"],
                    r["auto"]["samples_per_s"]) / 1e3 * 1.04, yi - h / 2 - 0.02,
                note, va="center", color=INK, fontsize=9)
    ax.set_yticks(y, models)
    ax.set_xlabel("throughput, 1000 samples/s — zipf(1.2) ids, batch 512, "
                  "full tables", color=INK)
    ax.set_xlim(0, max(auto + xla) * 1.35)
    ax.legend(loc="lower right", frameon=False, labelcolor=INK, fontsize=9)
    ax.set_title("Skew-aware serving: hot/cold auto vs direct gather "
                 "(zipf_bench.json)", color=INK, fontsize=11)
    fig.tight_layout()
    fig.savefig(out, dpi=150, facecolor=SURFACE)
    plt.close(fig)


def plot_qps_sla(bench_dir: Path, out: Path):
    import matplotlib.pyplot as plt

    d = json.loads((bench_dir / "qps_sweep.json").read_text())
    # Keys are "model:backend": the accelerator calibrated-sim series is
    # the headline; cpu-calibrated-sim records (the matched-regime CPU
    # baseline) render as a second series — keying by model alone let the
    # CPU records OVERWRITE the accelerator QPS in the rendered figure.
    accel: dict[str, float] = {}
    cpu: dict[str, float] = {}
    slas = set()
    for key, rec in d.items():
        slas.add(rec["sla_ms"])
        model, _, backend = key.partition(":")
        ok = [p["qps"] for p in rec["sweep"] if p["meets_sla"]]
        (cpu if backend.startswith("cpu") else accel)[model] = max(ok) if ok else 0.0
    if len(slas) > 1:
        raise ValueError(f"qps_sweep.json mixes SLAs {sorted(slas)}; "
                         "plot one SLA at a time")
    sla = slas.pop()
    # Union of both series: a model measured only on one backend must
    # still render (silent omission reads as full coverage).
    models = sorted(set(accel) | set(cpu), key=lambda m: -accel.get(m, 0.0))
    qps = [accel.get(m, 0.0) for m in models]
    fig, ax = plt.subplots(figsize=(7, 4), facecolor=SURFACE)
    _style(ax)
    import numpy as _np

    x = _np.arange(len(models))
    width = 0.38 if cpu else 0.55
    ax.bar(x - (width / 2 if cpu else 0), qps, width=width, color=SERIES[0],
           edgecolor=SURFACE, linewidth=2, zorder=3, label="accelerator (calibrated sim)")
    for xi, v in zip(x - (width / 2 if cpu else 0), qps):
        ax.text(xi, v, f"{v:.0f}", ha="center", va="bottom", color=INK,
                fontsize=8)
    if cpu:
        cq = [cpu.get(m, 0.0) for m in models]
        ax.bar(x + width / 2, cq, width=width, color=SERIES[1],
               edgecolor=SURFACE, linewidth=2, zorder=3,
               label="CPU f32 baseline (same stack)")
        ax.legend(frameon=False, labelcolor=INK, fontsize=8)
    ax.set_xticks(list(x), models)
    ax.set_ylabel("QPS", color=INK)
    ax.set_title(f"Latency-bounded QPS, p95 <= {sla:.0f} ms SLA"
                 " (qps_sweep.json)", color=INK, fontsize=11)
    fig.tight_layout()
    fig.savefig(out, dpi=150, facecolor=SURFACE)
    plt.close(fig)


def plot_train_quality(bench_dir: Path, out: Path):
    """Training-to-quality learning curves (train_quality.json): holdout
    ROC-AUC vs steps at FULL production scale, the Bayes ceiling of the
    planted signal, and the lifecycle endpoints (int8_rowwise direct +
    served-through-the-fabric AUC) as markers at the final step."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rec = json.loads((bench_dir / "train_quality.json").read_text())
    models = sorted(rec)
    fig, axes = plt.subplots(1, len(models), figsize=(5.4 * len(models), 3.8),
                             facecolor=SURFACE, squeeze=False)
    for ax, model in zip(axes[0], models):
        r = rec[model]
        steps = [p["step"] for p in r["auc_curve"]]
        aucs = [p["auc"] for p in r["auc_curve"]]
        _style(ax)
        ax.plot(steps, aucs, color=SERIES[0], linewidth=2,
                label="holdout AUC (f32 training)", zorder=3)
        ax.axhline(r["bayes_auc"], color=INK_2, linestyle="--", linewidth=1,
                   label=f"Bayes ceiling {r['bayes_auc']:.3f}", zorder=2)
        ax.axhline(0.5, color=GRID, linewidth=1, zorder=1)
        if r.get("int8_direct_auc") is not None:
            ax.plot([steps[-1]], [r["int8_direct_auc"]], "o",
                    color=SERIES[1], markersize=7, zorder=4,
                    label=f"int8_rowwise direct {r['int8_direct_auc']:.3f}")
        if r.get("served_auc") is not None:
            ax.plot([steps[-1]], [r["served_auc"]], "x", color=SERIES[2],
                    markersize=9, markeredgewidth=2.2, zorder=5,
                    label=f"served via engines {r['served_auc']:.3f}")
        ax.set_xlabel("training step", color=INK)
        ax.set_ylabel("holdout ROC-AUC", color=INK)
        ax.set_ylim(0.45, 1.0)
        ax.set_title(f"{model} @ full scale — sparse touched-rows trainer,"
                     f" zipf(1.2) stream", color=INK, fontsize=10)
        ax.legend(loc="lower right", frameon=False, fontsize=8,
                  labelcolor=INK)
    fig.suptitle("Training-to-quality: planted table-only signal "
                 "(labels learnable ONLY through the embedding rows)",
                 color=INK, fontsize=11)
    fig.tight_layout()
    fig.savefig(out, dpi=150, facecolor=SURFACE)
    plt.close(fig)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--bench-dir", default="benchmarks")
    args = ap.parse_args(argv)
    bench_dir = Path(args.bench_dir)
    png = bench_dir / "png"
    png.mkdir(parents=True, exist_ok=True)
    plot_op_breakdown(bench_dir, png / "op_breakdown.png")
    plot_model_speedup(bench_dir, png / "model_speedup.png")
    plot_qps_sla(bench_dir, png / "qps_sla.png")
    plot_zipf_bench(bench_dir, png / "zipf_bench.png")
    plot_train_quality(bench_dir, png / "train_quality.png")
    print(f"wrote {png}/op_breakdown.png, model_speedup.png, "
          f"qps_sla.png, zipf_bench.png, train_quality.png")


if __name__ == "__main__":
    main()
