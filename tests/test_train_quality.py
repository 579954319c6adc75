"""Training-to-quality lifecycle, asserted.

The production-scale evidence lives in benchmarks/train_quality.json
(train_quality:rm1 on the chip: 32M-row tables, AUC 0.878 of a 0.938
Bayes ceiling, served int8 AUC delta 0.0000). This test pins the SAME
claim at CPU scale so it can never silently regress: the sparse
touched-rows trainer learns a planted table-only signal, and the
trained quality survives checkpoint -> int8_rowwise export -> the real
serving fabric (partition -> coalesce -> bucket-pad -> rejoin).

Reference contrast: inference-only with random weights
(dlrm_s_caffe2.py:243-252, utils/utils.py:40) — no reference analog.
"""

import jax
import numpy as np

from deeprecsys_tpu import zoo
from deeprecsys_tpu.config import ServingConfig
from deeprecsys_tpu.experiments.train_quality import (
    make_holdout,
    planted_weights,
    train_planted,
)
from deeprecsys_tpu.serving.ingress import ServingServer
from deeprecsys_tpu.train import export_serving_params
from deeprecsys_tpu.utils.checkpoint import save_params
from deeprecsys_tpu.utils.metrics_ml import auc


def test_training_to_quality_lifecycle(tmp_path):
    cfg = zoo.get_config("rm1", table_scale=2000)  # 16k rows: CPU-sized

    # 1. The sparse trainer LEARNS: the planted signal lives only in the
    #    embedding rows (dense features are uninformative), so AUC above
    #    0.5 is attributable to the touched-rows table updates.
    #    Calibration: 300 steps reach 0.749 of a 0.885 Bayes ceiling.
    tr, rep = train_planted(cfg, steps=300, batch=128, eval_every=300,
                            holdout_batches=4, log=lambda *a: None)
    assert rep["loss_last8"] < rep["loss_first8"] - 0.05, rep
    assert rep["final_auc"] >= 0.70, rep
    assert rep["final_auc"] >= 0.78 * rep["bayes_auc"], rep

    # 2. Lifecycle: checkpoint the int8_rowwise export and serve it
    #    through a REAL engine + the full query fabric; the served AUC
    #    on the SAME holdout must match the trained AUC (quantization
    #    error and the serving path both sit in between).
    params = jax.tree_util.tree_map(np.asarray, tr.params)
    sp, qcfg = export_serving_params(params, tr.cfg)
    save_params(tmp_path / "ck", sp)
    # make_holdout is seed-pure: regenerating with train_planted's args
    # yields the exact evaluation set the trained AUC was computed on.
    holdout = make_holdout(cfg, planted_weights(cfg), n_batches=4, batch=128)
    scfg = ServingConfig(engine_backend="cpu", inference_engines=1,
                         batch_buckets=(128,), max_mini_batch_size=128,
                         sub_task_batch_size=128)
    server = ServingServer(qcfg, scfg, checkpoint_path=str(tmp_path / "ck"))
    server.start(timeout=600)
    try:
        ss, ys = [], []
        for idx, dense, _logits, y in holdout:
            out = server.predict(idx, dense=dense, timeout=120)
            ss.append(np.asarray(out["scores"], np.float32)[:, 0])
            ys.append(y)
    finally:
        server.stop()
    served = auc(np.concatenate(ss), np.concatenate(ys).astype(int))
    assert abs(served - rep["final_auc"]) <= 0.02, (served, rep["final_auc"])


def test_dien_scan_path_learns_recency_signal():
    """Regression for the round-5 found bug: the BasicRNN's raw-randn
    init (faithful to the inference-only reference, dien.py:320-328) put
    tanh into saturation from step 0 — the scan path could not learn AT
    ALL. Full-scale dien plateaued at holdout AUC 0.58 ~= the
    direct-path (profile+ad+ctx) oracle ceiling of 0.63, while the
    behavior-only oracle was 0.89: the GRU contributed nothing.

    The decisive control: plant the signal ONLY on the last 5 behavior
    tables, reachable exclusively through the two scans. Saturated init
    plateaus at 0.52; the scaled ops/rnn.py init reaches ~0.90 of the
    Bayes ceiling within 300 steps. This test pins the fixed behavior so
    the scan gradient path can never silently die again."""
    cfg = zoo.get_config("dien", table_scale=2000)  # 250 rows/table
    T = cfg.num_tables
    last5 = list(range(T - 7, T - 2))  # behavior tables nearest the readout
    tr, rep = train_planted(cfg, steps=300, batch=256, eval_every=300,
                            lr=0.03, table_lr=0.01, holdout_batches=4,
                            signal_tables=last5, log=lambda *a: None)
    assert rep["final_auc"] >= 0.80, rep
    assert rep["final_auc"] >= 0.85 * rep["bayes_auc"], rep


def test_din_attention_sum_init_scale():
    """Regression for the round-5 din init fix (stacked_mlp_init
    sum_fanin): the ~250 attention-unit outputs are SUMMED (reference
    din.py:282-284), so unscaled last-layer init makes that pathway
    ~sqrt(250)x hotter than its concat siblings — initial bce loss 4.5
    (vs log 2) and a planted-signal learning curve that crawls
    (holdout AUC 0.57 at step 600). With the last layer scaled by
    1/sqrt(num_behavior) the init loss is healthy and the same budget
    reaches 0.63. Both properties pinned here at tiny scale."""
    import jax.numpy as jnp

    from deeprecsys_tpu.experiments.train_quality import zipf_batch
    from deeprecsys_tpu.models.base import Batch
    from deeprecsys_tpu.train import Trainer

    cfg = zoo.get_config("din", table_scale=2000)
    tr = Trainer(cfg, sparse_tables=True, optimizer="adagrad",
                 learning_rate=0.03, table_learning_rate=0.01,
                 loss="bce", seed=0)
    # (a) Sane score scale at init: one step's loss must sit near log 2,
    # not the 4.5 the unscaled sum produced.
    rng = np.random.default_rng(3)
    idx = zipf_batch(cfg, 256, rng)
    b = Batch(dense=None, indices=jnp.asarray(idx))
    y = jnp.asarray(np.broadcast_to(
        rng.integers(0, 2, 256).astype(np.float32)[:, None],
        (256, cfg.out_dim)).copy())
    _, _, loss0 = tr._step(tr.params, tr.opt_state, b, y)
    assert float(loss0) < 1.2, float(loss0)

    # (b) The planted signal learns at the calibrated rate (unscaled
    # init reached only ~0.57 on this exact budget and seed).
    tr2, rep = train_planted(cfg, steps=600, batch=256, eval_every=600,
                             lr=0.03, table_lr=0.01, holdout_batches=4,
                             log=lambda *a: None)
    assert rep["final_auc"] >= 0.60, rep


import pytest


@pytest.mark.parametrize("model,steps,lr,table_lr,floor", [
    ("wnd", 400, 0.03, 1e-2, 0.70),    # calibrated 0.79 at this budget
    ("ncf", 400, 0.01, 1e-3, 0.65),    # calibrated 0.73
    ("mtwnd", 800, 0.03, 1e-2, 0.56),  # calibrated 0.61 — the config's
    # 4x128 sigmoid outputs dilute the broadcast-label gradient ~512x,
    # so this family climbs slowest (0.71 by step 1200; architectural,
    # not a bug — each head output has its own last-layer weights)
])
def test_remaining_families_learn_planted_signal(model, steps, lr, table_lr,
                                                 floor):
    """Every zoo family's gradient path learns the planted table-only
    signal at tiny scale. rm1 is pinned by the lifecycle test, rm2/rm3
    share rm1's dlrm graph, din/dien have dedicated regressions for
    their round-5 init fixes — this closes the remaining three. The
    floors sit ~0.05 below calibrated values (seeds are fixed, so drift
    means a real regression: an init change, a loss-path change, or a
    pooled-lookup gradient break)."""
    cfg = zoo.get_config(model, table_scale=2000)
    tr, rep = train_planted(cfg, steps=steps, batch=256,
                            eval_every=steps, lr=lr, table_lr=table_lr,
                            holdout_batches=4, log=lambda *a: None)
    assert rep["final_auc"] >= floor, rep
