#!/usr/bin/env bash
# Reproduce the full experiment suite (the reference's experiments/ dir):
# characterization sweeps, operator breakdown, scheduling + load-generator
# studies, and latency-bounded QPS per model. Results land in benchmarks/.
#
# The GPU parts (sweeps/breakdown) run only with RUN_GPU=1, one process at
# a time; everything else uses the accelerator-calibrated sim engines
# (ladders from experiments/sweep.py) and finishes in minutes on CPU.
set -euo pipefail
cd "$(dirname "$0")/.."

if [[ "${RUN_GPU:-0}" == "1" ]]; then
  python -m deeprecsys_tpu.experiments.sweep --cpu          # ladders + speedup
  python -m deeprecsys_tpu.experiments.op_breakdown --batches 512
fi

python -m deeprecsys_tpu.experiments.loadgen_study
python -m deeprecsys_tpu.experiments.scheduling_study
for m in rm1 rm2 rm3 wnd mtwnd ncf din dien; do
  python -m deeprecsys_tpu.experiments.qps_sweep --model "$m" \
      --num-batches "${QPS_BATCHES:-96}" --sla-ms "${SLA_MS:-25}"
done
echo "experiment artifacts written to benchmarks/"

# Render the figures from the recorded artifacts (reference png analog).
python -m deeprecsys_tpu.experiments.plots
echo "figures written to benchmarks/png/"
