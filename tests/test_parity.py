"""Numerical parity harness (SURVEY.md §7 step 3).

The reference cannot run here (Caffe2 is long gone from modern torch), so
parity rests on an INDEPENDENT ORACLE plus regression guards:

1. ORACLE parity (the primary claim): every model's f32 JAX forward matches
   a pure-NumPy re-implementation of the reference op graph
   (tests/oracle/np_reference.py — per-table SparseLengthsSum loops, Caffe2
   FC (out,in) weights, per-table attention chains, stepwise RNNs) on
   seeded batches, sharing only config + weight values;
2. architecture dims match the reference formulas (test_config.py);
3. initialization distributions match (test_ops.py);
4. GOLDEN anchors: seeded forward outputs per model are pinned — any
   future refactor that silently changes model math fails these tests;
5. dtype consistency: bf16 scores track f32 scores in ranking (AUC-vs-f32
   within tolerance), validating the bf16 serving path;
6. trained-AUC sanity: a few SGD steps on synthetic labeled data must push
   AUC above chance on the training batch (model can actually learn).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeprecsys_tpu import zoo
from deeprecsys_tpu.data import RecDataGenerator
from deeprecsys_tpu.models import get_model
from deeprecsys_tpu.models.base import Batch
from deeprecsys_tpu.utils.metrics_ml import auc

SCALE = 2000
GOLDEN_PATH = Path(__file__).parent / "golden" / "forward_outputs.json"


def _forward(name, dtype="float32", batch=8, seed=0):
    cfg = zoo.get_config(name, table_scale=SCALE, param_dtype=dtype, compute_dtype=dtype)
    model = get_model(cfg)
    params = model.init(jax.random.PRNGKey(seed))
    host = RecDataGenerator(cfg, seed=seed + 1).generate_batch(batch)
    out = model.apply(params, host)
    return np.asarray(out.astype(jnp.float32))


def test_auc_metric():
    assert auc(np.array([0.9, 0.8, 0.3, 0.2]), np.array([1, 1, 0, 0])) == 1.0
    assert auc(np.array([0.2, 0.3, 0.8, 0.9]), np.array([1, 1, 0, 0])) == 0.0
    assert auc(np.array([0.5, 0.5, 0.5, 0.5]), np.array([1, 1, 0, 0])) == 0.5
    rng = np.random.default_rng(0)
    s = rng.random(2000)
    l = rng.random(2000) < 0.5
    assert abs(auc(s, l) - 0.5) < 0.05


@pytest.mark.parametrize("name", zoo.MODEL_NAMES)
def test_oracle_parity(name):
    """The JAX forward must match the independent NumPy reference-graph
    oracle (tests/oracle/np_reference.py) at f32 within roundoff: the two
    share only config + weight values; op order, fusion, and layout are
    derived separately."""
    from tests.oracle.np_reference import (
        csr_from_batch,
        oracle_forward,
        oracle_weights_from_params,
    )

    cfg = zoo.get_config(name, table_scale=SCALE)
    model = get_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    if name == "dien":
        # The reference's plain-randn RNN init (dien.py:321-328) saturates
        # tanh and makes the 40-step recurrence CHAOTIC: a 1e-7 f32
        # rounding difference amplifies severalfold per step, so any two
        # correct implementations diverge to O(1) by the last step. Scale
        # the recurrent weights into the stable regime — identically for
        # both paths — so the comparison tests graph semantics, not chaos.
        for rnn in ("rnn0", "rnn1"):
            params[rnn] = {k: v * 0.05 for k, v in params[rnn].items()}
    host = RecDataGenerator(cfg, seed=1).generate_batch(8)
    ours = np.asarray(model.apply(params, host), dtype=np.float64)

    w = oracle_weights_from_params(jax.device_get(params), cfg)
    S_indices, S_lengths = csr_from_batch(host.indices)
    X = None if host.dense is None else np.asarray(host.dense, dtype=np.float64)
    ref = oracle_forward(cfg, w, X, S_indices, S_lengths)

    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5,
                               err_msg=f"oracle parity failed for {name}")


def test_golden_outputs_pinned():
    """Seeded forward outputs are pinned; regenerate ONLY for intentional
    math changes: python -m tests.test_parity (as __main__)."""
    golden = json.loads(GOLDEN_PATH.read_text())
    for name in zoo.MODEL_NAMES:
        out = _forward(name)
        pinned = np.asarray(golden[name], dtype=np.float32)
        np.testing.assert_allclose(out, pinned, rtol=1e-4, atol=1e-5,
                                   err_msg=f"golden mismatch for {name}")


@pytest.mark.parametrize("name", ["rm1", "wnd", "ncf"])
def test_bf16_ranking_tracks_f32(name):
    f32 = _forward(name, "float32", batch=256)
    bf16 = _forward(name, "bfloat16", batch=256)
    # Use the f32 scores' median split as pseudo-labels: bf16 must rank
    # them nearly identically.
    labels = (f32[:, 0] > np.median(f32[:, 0])).astype(int)
    a = auc(bf16[:, 0], labels)
    assert a > 0.97, f"{name}: bf16 ranking diverges from f32 (AUC {a})"


def test_model_can_learn_auc():
    from deeprecsys_tpu.parallel import make_mesh, shard_params, make_train_step

    cfg = zoo.get_config("rm1", table_scale=SCALE)
    model = get_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    mesh = make_mesh(data=2, model=4)
    sp = shard_params(params, mesh)
    gen = RecDataGenerator(cfg, seed=3)
    B = 128
    batch = gen.generate_batch(B)
    # Labels correlated with the dense features -> learnable signal.
    labels = (batch.dense.mean(axis=1) > np.median(batch.dense.mean(axis=1))).astype(np.float32)
    targets = jnp.asarray(labels[:, None])
    dev = Batch(dense=jnp.asarray(batch.dense), indices=jnp.asarray(batch.indices))
    step = make_train_step(model.apply, mesh, has_dense=True, learning_rate=0.5, loss="bce")(sp)
    p = sp
    for _ in range(30):
        p, loss = step(p, dev, targets)
    scores = np.asarray(model.apply(jax.device_get(p), batch))
    a = auc(scores[:, 0], labels.astype(int))
    assert a > 0.8, f"training failed to learn (AUC {a})"


if __name__ == "__main__":
    # Regenerate golden outputs (intentional math changes only).
    # Golden values are CPU f32 — same platform the test suite runs on.
    jax.config.update("jax_platforms", "cpu")
    GOLDEN_PATH.parent.mkdir(exist_ok=True)
    golden = {name: _forward(name).tolist() for name in zoo.MODEL_NAMES}
    GOLDEN_PATH.write_text(json.dumps(golden))
    print(f"wrote {GOLDEN_PATH}")
