"""Device-mesh construction and multi-host initialization.

No reference equivalent: the reference is single-node and its only
"distribution" is N OS processes around one shared multiprocessing queue
(SURVEY.md §2.3). The scaling story here is a 2-D
``jax.sharding.Mesh``:

- axis "data"  — data parallelism over the batch dimension (the analog of
  the reference's replicated engine processes, DeepRecSys.py:62-78);
- axis "model" — model parallelism for the embedding tables: the fused
  (total_rows, d) array is row-sharded so each device holds a slice of
  every model's tables, and lookups combine partial pooled sums with a
  psum over the interconnect (NVLink between the GPUs of a host; the
  analog — and upgrade — of the reference's
  ``max_num_tasks`` intra-op threading of SparseLengthsSum).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(data: int | None = None, model: int | None = None, devices=None) -> Mesh:
    """Build a ("data", "model") mesh over ``devices``.

    With only one of data/model given, the other absorbs the remaining
    devices. Default: all devices on the data axis.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if data is None and model is None:
        data, model = n, 1
    elif data is None:
        assert n % model == 0, (n, model)
        data = n // model
    elif model is None:
        assert n % data == 0, (n, data)
        model = n // data
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    arr = np.asarray(devices).reshape(data, model)
    return Mesh(arr, axis_names=("data", "model"))


def distributed_init(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None):
    """Initialize multi-host JAX (``jax.distributed``). No-op when single
    process / already initialized. The reference has no multi-host path at
    all; this is the entry point for meshes that span hosts."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
