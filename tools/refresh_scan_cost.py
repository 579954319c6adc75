"""Measure the adaptive-refresh candidate-scan cost.

The refresh/upgrade scan (engine._candidate_hot_ids_from) — one
select_hot_ids (sort-unique, O(N log N) in scanned lookups) over the
buffered window + one holdout coverage pass — runs on a worker thread
(hotcold_scan_async) or inline; the numbers here are the per-scan HOST
cost either way, and bound the worker's CPU contention with the
splitter. This records, per
gather-bound model at the engine-shaped window (hotcold_refresh_window=16
batches x 512 rows):

- the UNCAPPED scan cost,
- the cost under the hotcold_scan_budget row-stride cap (the gate), and
- the selection-quality delta (holdout coverage of the capped-scan set vs
  the uncapped set — the cap must not degrade the head it selects).

Host-only (pure numpy; no device). Writes
benchmarks/refresh_scan_cost.json.

Run: python tools/refresh_scan_cost.py
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from deeprecsys_tpu import zoo  # noqa: E402
from deeprecsys_tpu.ops.embedding import (  # noqa: E402
    hot_coverage_of,
    scan_budget_subsample,
    select_hot_ids,
)
from deeprecsys_tpu.utils.memory import suggest_hot_rows  # noqa: E402

WINDOW, BATCH = 16, 512
BUDGET = 2_000_000  # the ServingConfig.hotcold_scan_budget default


def measure(model):
    cfg = zoo.get_config(model, table_scale=1, param_dtype="bfloat16")
    T, L = cfg.num_tables, cfg.num_indices_per_lookup
    rows = np.asarray(cfg.scaled_rows, np.int64)
    rng = np.random.default_rng(0)
    batches = [(rng.zipf(1.2, size=(BATCH, T, L)) % rows[None, :, None])
               .astype(np.int32) for _ in range(WINDOW)]
    offs = np.asarray(cfg.table_offsets)
    k = suggest_hot_rows(cfg)
    n_hold = max(1, WINDOW // 4)
    sel_full = np.concatenate(batches[:-n_hold], axis=0)
    hold_full = np.concatenate(batches[-n_hold:], axis=0)

    def scan(sel, hold):
        t0 = time.perf_counter()
        hot = select_hot_ids(sel, offs, k)
        t1 = time.perf_counter()
        cov = hot_coverage_of(hold, offs, hot)
        t2 = time.perf_counter()
        return hot, cov, (t1 - t0) * 1000, (t2 - t1) * 1000

    hot_u, cov_u, sel_u_ms, cov_u_ms = scan(sel_full, hold_full)
    hot_c, cov_c_capped, sel_c_ms, cov_c_ms = scan(
        scan_budget_subsample(sel_full, BUDGET),
        scan_budget_subsample(hold_full, BUDGET))
    # Quality: both sets scored on the SAME full holdout.
    cov_c_full = hot_coverage_of(hold_full, offs, hot_c)
    out = {
        "window": WINDOW, "batch": BATCH, "lookups_scanned_M":
            round(sel_full.size / 1e6, 2),
        "hot_rows_k": int(k),
        "uncapped_ms": round(sel_u_ms + cov_u_ms, 1),
        "capped_ms": round(sel_c_ms + cov_c_ms, 1),
        "budget": BUDGET,
        "coverage_uncapped_set": round(float(cov_u), 4),
        "coverage_capped_set_full_holdout": round(float(cov_c_full), 4),
    }
    print(f"{model}: {out['lookups_scanned_M']}M ids; uncapped "
          f"{out['uncapped_ms']:.0f} ms -> capped {out['capped_ms']:.0f} ms; "
          f"holdout coverage {cov_u:.3f} (uncapped set) vs "
          f"{cov_c_full:.3f} (capped set)", flush=True)
    return out


def main():
    results = {m: measure(m) for m in ("rm1", "rm2", "rm3", "din")}
    path = Path(__file__).parent.parent / "benchmarks" / "refresh_scan_cost.json"
    path.write_text(json.dumps(
        {"note": "dispatch-thread candidate-scan cost; gate = "
                 "ServingConfig.hotcold_scan_budget row-stride subsample",
         "results": results}, indent=2))
    print(f"-> {path}")


if __name__ == "__main__":
    main()
