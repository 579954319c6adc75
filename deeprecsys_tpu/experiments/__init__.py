"""Characterization experiments.

Reference: ``experiments/`` — operator breakdown (``sweep_p.py``), accel
speedup (``sweep_rt.py``), scheduler and load-generator studies (bash
drivers). Re-expressed natively:

- ``op_breakdown`` — per-stage (embedding / interaction / MLP / RNN)
  device-time breakdown per model per batch size.
- ``sweep`` — batch-size sweeps producing LatencyModel characterization
  files (the ``accelerator/generate_data.py`` analog) and accelerator-vs-CPU
  speedup tables (the ``sweep_rt.py`` analog).
"""
