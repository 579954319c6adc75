"""Accelerator latency model (characterization-driven).

Reference: ``accelerator/predict_execution.py`` — parses per-model GPU
sweep results (exec time at batch 4^0..4^5) and predicts latency for an
arbitrary batch size by LINEAR INTERPOLATION IN LOG4 SPACE between the two
bracketing measured points (:67-97). ``accelerator/generate_data.py`` is
the sweep that produces the measurements.

Here the same machinery characterizes OUR engine paths (e.g. the GPU
big-batch path vs. a host path) and powers the sleep-based ``sim`` engine —
the reference's own fake-backend pattern (``accelInferenceEngine.py:58-64``)
that SURVEY.md §4 identifies as the model for hardware-free testing.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np


class LatencyModel:
    """Piecewise log-linear latency vs. batch-size model."""

    def __init__(self, batch_sizes, latencies_ms, base: float = 4.0):
        if len(batch_sizes) != len(latencies_ms):
            raise ValueError(
                f"{len(batch_sizes)} batch sizes vs {len(latencies_ms)} "
                f"latencies — a mismatched ladder would silently drop or "
                f"misalign measurements")
        order = np.argsort(batch_sizes)
        self.batches = np.asarray(batch_sizes, dtype=np.float64)[order]
        self.lat_ms = np.asarray(latencies_ms, dtype=np.float64)[order]
        self.base = float(base)
        if len(self.batches) < 1:
            raise ValueError("need at least one measurement")

    def predict_ms(self, batch_size: int) -> float:
        """Latency for ``batch_size``, interpolated in log-space.

        Mirrors the reference's scheme: exact hit returns the measurement;
        otherwise linear interpolation between the bracketing points on a
        log_base(batch) axis. Below the smallest measured point the model
        CLAMPS to lat_ms[0] (latency cannot drop below the smallest-batch
        floor); above the largest it extrapolates with the last segment's
        slope (the reference only ever queries within its sweep range).
        """
        b = float(batch_size)
        if b <= self.batches[0]:
            # Clamp before any log: b can legitimately be 0 (an empty
            # request probe) and must not raise inside a daemon engine.
            return float(self.lat_ms[0])
        logb = math.log(b, self.base)
        logs = np.log(self.batches) / math.log(self.base)
        if b >= self.batches[-1]:
            if len(self.batches) == 1:
                return float(self.lat_ms[-1])
            # extrapolate with the last segment's slope
            slope = (self.lat_ms[-1] - self.lat_ms[-2]) / (logs[-1] - logs[-2])
            return float(self.lat_ms[-1] + slope * (logb - logs[-1]))
        j = int(np.searchsorted(self.batches, b, side="right")) - 1
        frac = (logb - logs[j]) / (logs[j + 1] - logs[j])
        return float(self.lat_ms[j] + frac * (self.lat_ms[j + 1] - self.lat_ms[j]))

    def with_overhead(self, a_ms: float, ms_per_sample: float) -> "LatencyModel":
        """Return a model predicting ``interp(b) + a_ms + ms_per_sample*b``.

        Models a per-dispatch transport cost that is AFFINE IN PAYLOAD
        (payload bytes scale linearly with batch size): ``a_ms`` is the
        scalar dispatch floor, ``ms_per_sample`` the per-sample transfer
        cost. Applied after interpolation — adding it to the ladder points
        instead would bend the affine term through the log-space chords.
        """
        return _OverheadModel(self, float(a_ms), float(ms_per_sample))

    def with_overlap(self, a_ms: float, ms_per_sample: float) -> "LatencyModel":
        """Return a model predicting ``max(interp(b), ms_per_sample*b) + a_ms``.

        OVERLAP-aware transport: the engine pipeline overlaps the
        host->device transfer of request k+1 with device compute of
        request k (two-thread dispatch/complete split, engine.py), so per
        dispatch the wall cost is the LARGER of compute and transfer, not
        their sum — plus the un-overlappable scalar dispatch floor. The
        additive ``with_overhead`` model double-counts whichever side is
        smaller, which this model exists to fix.
        """
        return _OverlapModel(self, float(a_ms), float(ms_per_sample))

    @classmethod
    def from_reference_raw(cls, path: str | Path, base: float = 4.0) -> "LatencyModel":
        """Ingest a reference ``raw_data/results_<model>.txt`` file.

        Format (reference ``accelerator/predict_execution.py:10-29``): each
        standalone characterization run prints six ``***`` timing lines
        (load total, load ms/iter, compute total, compute ms/iter, exec
        total, exec ms/iter — ``inferenceEngine.py:168-173``); the file
        concatenates one run per batch size in ladder order (batch =
        ``base**i``, GTX-1080Ti sweeps use base 4, GTX-960 base 2,
        ``predict_execution.py:49-62,98-124``). Column 5 of each 6-tuple —
        per-iteration total execution time — becomes the ladder point,
        exactly what the reference's ``GPU_Data`` extracts (``[:,5]``).
        """
        values = []
        for line in Path(path).read_text().splitlines():
            if "***" not in line:
                continue
            # The reference parses line[rindex('*')+1 : rindex('ms')].
            tail = line[line.rindex("*") + 1:]
            if "ms" not in tail:
                raise ValueError(f"malformed *** line (no 'ms'): {line!r}")
            values.append(float(tail[: tail.rindex("ms")]))
        if not values or len(values) % 6:
            raise ValueError(
                f"{path}: expected groups of six '***' timing lines per "
                f"batch point (got {len(values)} values) — is this a "
                f"reference results_<model>.txt?")
        exec_ms_per_iter = values[5::6]
        batches = [base ** i for i in range(len(exec_ms_per_iter))]
        return cls(batches, exec_ms_per_iter, base=base)

    # ------------------------------------------------------------------

    def to_json(self) -> dict:
        return {"batch_sizes": self.batches.tolist(), "latencies_ms": self.lat_ms.tolist(),
                "base": self.base}

    @classmethod
    def from_json(cls, d: dict) -> "LatencyModel":
        m = cls(d["batch_sizes"], d["latencies_ms"], d.get("base", 4.0))
        if d.get("overhead"):  # calibrated transport term round-trips
            o = d["overhead"]
            if o.get("overlap"):
                return m.with_overlap(o["a_ms"], o["ms_per_sample"])
            return m.with_overhead(o["a_ms"], o["ms_per_sample"])
        return m

    def save(self, path: str | Path):
        Path(path).write_text(json.dumps(self.to_json()))

    @classmethod
    def load(cls, path: str | Path) -> "LatencyModel":
        return cls.from_json(json.loads(Path(path).read_text()))


class _OverheadModel(LatencyModel):
    """LatencyModel plus an affine per-dispatch transport term."""

    def __init__(self, base_model: LatencyModel, a_ms: float, ms_per_sample: float):
        super().__init__(base_model.batches, base_model.lat_ms, base=base_model.base)
        self.a_ms = a_ms
        self.ms_per_sample = ms_per_sample

    def predict_ms(self, batch_size: int) -> float:
        return (super().predict_ms(batch_size)
                + self.a_ms + self.ms_per_sample * float(batch_size))

    def to_json(self) -> dict:
        d = super().to_json()
        d["overhead"] = {"a_ms": self.a_ms, "ms_per_sample": self.ms_per_sample}
        return d


class _OverlapModel(LatencyModel):
    """LatencyModel where transfer overlaps compute: max(compute, transfer)
    + dispatch floor (see LatencyModel.with_overlap)."""

    def __init__(self, base_model: LatencyModel, a_ms: float, ms_per_sample: float):
        super().__init__(base_model.batches, base_model.lat_ms, base=base_model.base)
        self.a_ms = a_ms
        self.ms_per_sample = ms_per_sample

    def predict_ms(self, batch_size: int) -> float:
        compute = super().predict_ms(batch_size)
        transfer = self.ms_per_sample * float(batch_size)
        return max(compute, transfer) + self.a_ms

    def to_json(self) -> dict:
        d = super().to_json()
        d["overhead"] = {"a_ms": self.a_ms, "ms_per_sample": self.ms_per_sample,
                         "overlap": True}
        return d


# NOTE: there is deliberately no wall-clock "characterize_engine" helper
# here. Characterization sweeps live in experiments/sweep.py on the
# utils/timing.py chained discipline.


def main(argv=None):
    """Convert a reference ``raw_data/results_<model>.txt`` (the `***`
    6-tuple format) into a characterization JSON this framework's sim
    engines and offload scheduler consume — the migration path for users
    with measured GTX characterization files."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--from-raw", required=True,
                    help="reference results_<model>.txt path")
    ap.add_argument("--out", required=True, help="output JSON path")
    ap.add_argument("--base", type=float, default=4.0,
                    help="batch ladder base (4 = GTX-1080Ti sweeps, "
                         "2 = GTX-960)")
    args = ap.parse_args(argv)
    m = LatencyModel.from_reference_raw(args.from_raw, base=args.base)
    m.save(args.out)
    print(f"wrote {args.out}: batches {m.batches.astype(int).tolist()}, "
          f"exec ms/iter {[round(v, 4) for v in m.lat_ms.tolist()]}")


if __name__ == "__main__":
    main()
