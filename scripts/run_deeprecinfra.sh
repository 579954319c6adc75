#!/usr/bin/env bash
# DeepRecInfra parity run: every model through the full serving stack at a
# fixed arrival rate (no tuning), printing measured QPS / p95 / p99.
# Mirrors the reference's run_DeepRecInfra.sh (arrival 25 ms per model).
set -euo pipefail
cd "$(dirname "$0")/.."

BACKEND="${1:-accel}"
for MODEL in rm1 rm2 rm3 wnd mtwnd ncf din dien; do
  echo "=== $MODEL ==="
  python -m deeprecsys_tpu.main \
    --model "$MODEL" \
    --table_scale "${TABLE_SCALE:-8}" \
    --param_dtype bfloat16 \
    --queue \
    --engine_backend "$BACKEND" \
    --inference_engines "${ENGINES:-2}" \
    --num_batches "${NUM_BATCHES:-128}" \
    --batch_size_distribution normal \
    --avg_mini_batch_size 165 --var_mini_batch_size 16 \
    --max_mini_batch_size 1024 \
    --sub_task_batch_size 64 \
    --avg_arrival_rate "${ARRIVAL_MS:-25}" \
    --target_latency 25 \
    --req_granularity 64
done
