#!/usr/bin/env bash
# Canonical DeepRecSys run: full serving with DeepRecSched tuning.
# Mirrors the reference's run_DeepRecSys.sh operating point
# (32 engines there -> thread/process engines here; normal(165,16) query
# sizes capped at 1024; p95 target 25 ms; batch_configs 512-256-128;
# accel_configs 96..512; req_granularity 64; sched_timeout 128).
set -euo pipefail
cd "$(dirname "$0")/.."

# Positionals (model, backend, engines) may be followed by pass-through
# flags. Consume only arguments that are NOT flags: a blind `shift 3`
# would eat "--num_batches" as ENGINES when fewer positionals are given.
MODEL=rm1; BACKEND=accel; ENGINES=4
for var in MODEL BACKEND ENGINES; do
  if [ $# -gt 0 ] && [ "${1#-}" = "$1" ]; then
    eval "$var=\$1"
    shift
  fi
done

python -m deeprecsys_tpu.main \
  --model "$MODEL" \
  --table_scale "${TABLE_SCALE:-8}" \
  --param_dtype bfloat16 \
  --queue \
  --engine_backend "$BACKEND" \
  --inference_engines "$ENGINES" \
  --num_batches "${NUM_BATCHES:-256}" \
  --batch_size_distribution normal \
  --avg_mini_batch_size 165 --var_mini_batch_size 16 \
  --max_mini_batch_size 1024 \
  --sub_task_batch_size 32 \
  --avg_arrival_rate "${ARRIVAL_MS:-5}" \
  --target_latency 25 \
  --tune_batch_qps \
  --batch_configs 512-256-128 \
  --model_accel --tune_accel_qps \
  --accel_configs 96-128-192-256-384-512 \
  --req_granularity 64 \
  --sched_timeout 128 \
  "$@"
