"""Training API.

The reference is inference-only: ``--inference_only`` defaults True and
its training flags (learning_rate, loss_function, nepochs) are dormant
(`utils/utils.py:100-111`, SURVEY §5 "checkpoint/resume: none"). A
complete framework needs a real training path, so this module provides a
mesh-sharded trainer over the same pure model functions:

- optax optimizers (sgd / adagrad / adam — adagrad being the classic
  choice for embedding tables);
- hybrid sharding identical to inference (tables row-sharded over
  "model", batch over "data"; optimizer state follows the params);
- BCE/MSE losses (the reference's --loss_function values) and AUC eval;
- checkpointing via utils/checkpoint.

Two table-update modes: the default dense autodiff path (fine at test
scales) and ``sparse_tables=True`` — touched-rows-only scatter updates
with row-wise AdaGrad (``make_sparse_table_step``), whose step cost is
independent of table size.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import NamedSharding, PartitionSpec as P

from deeprecsys_tpu.config import ModelConfig
from deeprecsys_tpu.data import RecDataGenerator
from deeprecsys_tpu.models import get_model, sigmoid_output
from deeprecsys_tpu.models.base import Batch
from deeprecsys_tpu.parallel.sharding import (
    batch_shardings,
    bce_loss,
    loss_fn_for,
    masked_pooled_psum,
    mse_loss,
    param_shardings,
    shard_params,
    shard_local_indices,
)
from deeprecsys_tpu.utils.metrics_ml import auc


def make_optimizer(name: str, learning_rate: float) -> optax.GradientTransformation:
    if name == "sgd":
        return optax.sgd(learning_rate)
    if name == "adagrad":
        return optax.adagrad(learning_rate)
    if name == "adam":
        return optax.adam(learning_rate)
    raise ValueError(f"unknown optimizer {name!r}")


@dataclasses.dataclass
class TrainHistory:
    losses: list
    eval_aucs: list


def dedup_touched_rows(flat: jax.Array, g_rows: jax.Array):
    """Merge duplicate touched-row gradients BEFORE the scatter: one
    argsort + sorted segment-sum emits each unique row's TRUE gradient
    (the sum over occurrences — what dense autodiff produces), so the
    scatter issues one write per unique row.

    Its speed against the colliding scatter is not yet measured on the
    GPU (ROADMAP Speed 8). Kept as an option (``dedup=True``) for its
    cleaner AdaGrad semantics (the accumulator sees each row's true
    gradient once).

    Returns (uids (N,), summed (N, d)): one entry per unique row followed
    by an inert tail (uids=0, summed=0 — zero-adds on row 0)."""
    N = flat.shape[0]
    order = jnp.argsort(flat)
    sid = jnp.take(flat, order)
    sg = jnp.take(g_rows, order, axis=0)
    newrun = jnp.concatenate([jnp.ones((1,), jnp.int32),
                              (sid[1:] != sid[:-1]).astype(jnp.int32)])
    seg = jnp.cumsum(newrun) - 1  # sorted segment ids in [0, n_unique)
    summed = jax.ops.segment_sum(sg, seg, num_segments=N,
                                 indices_are_sorted=True)
    uids = jax.ops.segment_max(sid, seg, num_segments=N,
                               indices_are_sorted=True)
    slot = jnp.arange(N) < seg[-1] + 1
    return jnp.where(slot, uids, 0), summed


def make_sharded_sparse_table_step(model, cfg: ModelConfig, tx_rest,
                                   learning_rate: float, loss_fn, mesh,
                                   eps: float = 1e-8,
                                   table_learning_rate: float | None = None,
                                   dedup: bool = False):
    """Sparse-table training over a (data, model) mesh.

    The fused table and its row-wise AdaGrad accumulator are ROW-SHARDED
    over "model"; the batch is sharded over "data". Inside one shard_map:
    the local masked lookup + psum produces pooled embeddings (same
    pattern as ``sharded_embedding_bag``), the dense-half gradients are
    psum'd over "data", and each shard scatter-updates ONLY the rows it
    owns (update indices masked to the shard's row range, gradients
    psum'd over "data" rows since every data shard may touch any row).
    """
    from jax import shard_map

    if table_learning_rate is None:
        table_learning_rate = learning_rate
    offsets_np = np.asarray(cfg.table_offsets)
    n_model = mesh.shape["model"]
    total_rows = cfg.total_rows
    assert total_rows % n_model == 0, "pad tables to divide over the model axis"
    rows_per_shard = total_rows // n_model
    cdt = jnp.dtype(cfg.compute_dtype)

    def local_step(table_shard, acc_shard, rest, tx_state, dense, indices, targets):
        # table_shard: (rows/M, d); indices: (B_loc, T, L); data-parallel rest.
        # Same shard-local lookup body as inference (sharding.py helpers).
        safe, valid = shard_local_indices(indices, jnp.asarray(offsets_np),
                                          rows_per_shard)
        B, T, L = indices.shape
        pooled = masked_pooled_psum(table_shard, safe, valid, compute_dtype=cdt)
        batch = Batch(dense=dense if cfg.dense_dim else None, indices=indices)

        def objective(rest_params, pooled_in):
            out = model.apply_from_pooled(rest_params, pooled_in, batch)
            return loss_fn(out, targets)  # LOCAL mean; averaged below

        (loss, (g_rest, g_pooled)) = jax.value_and_grad(objective, argnums=(0, 1))(
            rest, pooled
        )
        # Global-mean gradient/loss: average the per-data-shard values.
        # g_pooled is local-mean-based; the global mean is the average of
        # local means, so the pooled gradient scales by 1/n_data.
        loss = jax.lax.pmean(loss, "data")
        g_rest = jax.lax.pmean(g_rest, "data")
        g_pooled = g_pooled / mesh.shape["data"]
        updates, tx_state = tx_rest.update(g_rest, tx_state, rest)
        rest = optax.apply_updates(rest, updates)

        # Sparse update of the rows THIS model shard owns. Every data shard
        # may touch any row, so the touched-row gradients are all-gathered
        # over "data" (O(B_global*T*L*d) — independent of R) and each model
        # shard applies ONE in-place scatter over the combined stream.
        # Masked (non-owned) entries carry zero gradient into row 0.
        g_rows = jnp.broadcast_to(
            g_pooled[:, :, None, :].astype(jnp.float32), (B, T, L, g_pooled.shape[-1])
        ).reshape(B * T * L, -1)
        flatl = safe.reshape(-1)
        maskf = valid.reshape(-1)
        g_rows = jnp.where(maskf[:, None], g_rows, 0.0)
        row_g2 = jnp.where(maskf, jnp.mean(g_rows * g_rows, axis=-1), 0.0)

        g_all = jax.lax.all_gather(g_rows, "data", axis=0, tiled=True)
        flat_all = jax.lax.all_gather(flatl, "data", axis=0, tiled=True)

        if dedup:
            # One write per unique row (dedup_touched_rows); accumulator
            # takes the true row gradient's g2 — the dense-autodiff
            # row-wise-AdaGrad semantics, and no colliding scatter lanes.
            uids, summed = dedup_touched_rows(flat_all, g_all)
            row_g2_u = jnp.mean(summed * summed, axis=-1)
            acc_shard = acc_shard.at[uids].add(row_g2_u)
            scale = jax.lax.rsqrt(acc_shard[uids] + eps)
            table_shard = table_shard.astype(jnp.float32).at[uids].add(
                -table_learning_rate * summed * scale[:, None]
            ).astype(table_shard.dtype)
            return table_shard, acc_shard, rest, tx_state, loss

        g2_all = jax.lax.all_gather(row_g2, "data", axis=0, tiled=True)
        acc_shard = acc_shard.at[flat_all].add(g2_all)
        scale = jax.lax.rsqrt(acc_shard[flat_all] + eps)
        table_shard = table_shard.astype(jnp.float32).at[flat_all].add(
            -table_learning_rate * g_all * scale[:, None]
        ).astype(table_shard.dtype)
        return table_shard, acc_shard, rest, tx_state, loss

    specs_in = (
        P("model", None),   # table shard
        P("model"),         # accumulator shard
        P(),                # rest params (replicated)
        P(),                # optimizer state (replicated)
        P("data", None) if cfg.dense_dim else P(),
        P("data", None, None),
        P("data", None),
    )
    specs_out = (P("model", None), P("model"), P(), P(), P())
    sharded = shard_map(local_step, mesh=mesh, in_specs=specs_in,
                        out_specs=specs_out, check_vma=False)

    def step(params, opt_state, batch: Batch, targets):
        tx_state, acc = opt_state
        rest = {k: v for k, v in params.items() if k != "tables"}
        dense = batch.dense if batch.dense is not None else jnp.zeros((), jnp.float32)
        tbl, acc, rest, tx_state, loss = sharded(
            params["tables"], acc, rest, tx_state, dense, batch.indices, targets
        )
        return dict(rest, tables=tbl), (tx_state, acc), loss

    return jax.jit(step, donate_argnums=(0, 1))


def make_sparse_table_step(model, cfg: ModelConfig, tx_rest, learning_rate: float,
                           loss_fn, rowwise_adagrad: bool = True, eps: float = 1e-8,
                           table_learning_rate: float | None = None,
                           dedup: bool = False):
    """Train step with SPARSE embedding-table updates.

    Autodiff through a gather materializes a dense (R, d) gradient and a
    dense optimizer sweep per step — prohibitive at production scale
    (rm1: 0.5 GB/step of pure zeros). Instead the forward is split at the
    pooled embeddings: the dense half trains under optax as usual, and the
    table is updated by a scatter-add touching ONLY the looked-up rows
    (every row of a pooling group receives the group's pooled-output
    gradient — exactly the gather-sum VJP). Table optimizer state is
    row-wise AdaGrad — one accumulator scalar per row, the industry
    standard for embedding tables — updated sparsely as well.

    Step cost: O(B*T*L) rows regardless of R.
    """
    from deeprecsys_tpu.ops import embedding_bag

    if table_learning_rate is None:
        table_learning_rate = learning_rate
    offsets_np = cfg.table_offsets

    def step(params, opt_state, batch: Batch, targets):
        table = params["tables"]
        rest = {k: v for k, v in params.items() if k != "tables"}
        tx_state, table_acc = opt_state
        pooled = jax.lax.stop_gradient(
            embedding_bag(table, jnp.asarray(offsets_np), batch.indices,
                          compute_dtype=jnp.dtype(cfg.compute_dtype))
        )

        def objective(rest_params, pooled_in):
            # apply_from_pooled never reads params["tables"] (the lookup is
            # exactly what `pooled_in` replaces), so the dense half sees
            # only the non-table params — same as the sharded twin above.
            out = model.apply_from_pooled(rest_params, pooled_in, batch)
            return loss_fn(out, targets)

        (loss, (g_rest, g_pooled)) = jax.value_and_grad(objective, argnums=(0, 1))(
            rest, pooled
        )

        # Dense half: optax as usual.
        updates, tx_state = tx_rest.update(g_rest, tx_state, rest)
        rest = optax.apply_updates(rest, updates)

        # Sparse half: scatter-add on touched rows only.
        B, T, L = batch.indices.shape
        flat = (batch.indices + jnp.asarray(offsets_np)[None, :, None]).reshape(-1)
        g_rows = jnp.broadcast_to(
            g_pooled[:, :, None, :].astype(jnp.float32), (B, T, L, g_pooled.shape[-1])
        ).reshape(B * T * L, -1)
        if dedup:
            flat, g_rows = dedup_touched_rows(flat, g_rows)
        if rowwise_adagrad:
            # With dedup, g_rows holds the TRUE per-row gradient (summed
            # over occurrences) — the accumulator sees its g2 once, the
            # dense-autodiff row-wise-AdaGrad semantics; without, each
            # occurrence contributes its own g2 (the default path).
            row_g2 = jnp.mean(g_rows * g_rows, axis=-1)  # (N,)
            table_acc = table_acc.at[flat].add(row_g2)
            scale = jax.lax.rsqrt(table_acc[flat] + eps)  # post-update accumulator
            g_rows = g_rows * scale[:, None]
        new_table = table.at[flat].add(
            (-table_learning_rate * g_rows).astype(table.dtype)
        )
        params = dict(rest, tables=new_table)
        return params, (tx_state, table_acc), loss

    return step


class Trainer:
    def __init__(
        self,
        cfg: ModelConfig,
        mesh=None,
        optimizer: str = "adagrad",
        learning_rate: float = 0.01,
        loss: str = "bce",
        seed: int = 0,
        sparse_tables: bool = False,
        table_learning_rate: float | None = None,
        dedup: bool = False,
    ):
        if cfg.table_quant != "none":
            raise ValueError("training requires float tables (table_quant='none')")
        if sparse_tables and cfg.resolved_table_pack > 1:
            # Touched-rows updates need the logical (R, d) layout; a
            # packed SERVING config would otherwise be untrainable. Train
            # unpacked — export_serving_params / the serving config
            # re-pack for deployment.
            cfg = cfg.replace(table_pack=1)
        if not sigmoid_output(cfg) and cfg.output_head != "logits":
            # Training the relu-scored families THROUGH the reference's
            # final relu is gradient-dead: bce-logits pushes negative
            # samples' pre-activations negative, relu zeroes them and
            # their gradients, and the model collapses to constant-0
            # scores with loss frozen at log 2 (seen on din at full
            # scale). The head has no parameters, so the trained
            # checkpoint serves either head (config.py output_head).
            cfg = cfg.replace(output_head="logits")
        self.cfg = cfg
        self.mesh = mesh
        self.sparse_tables = sparse_tables
        self.model = get_model(cfg)
        # "bce" resolves to probability- or logit-space depending on
        # whether the model's graph ends in a sigmoid (loss_fn_for).
        self.loss_fn = loss_fn_for(loss, sigmoid_output(cfg))
        self.tx = make_optimizer(optimizer, learning_rate)
        self.params = self.model.init(jax.random.PRNGKey(seed))
        if mesh is not None:
            self.params = shard_params(self.params, mesh)
        if sparse_tables:
            if isinstance(self.params.get("tables"), dict):
                raise ValueError(
                    "sparse_tables training needs the logical (R, d) table "
                    "layout — use table_pack=1 (dense training composes "
                    "with packing; the touched-rows updates do not yet)")
            rest = {k: v for k, v in self.params.items() if k != "tables"}
            table_acc = jnp.zeros((self.params["tables"].shape[0],), jnp.float32)
            if mesh is not None:
                table_acc = jax.device_put(table_acc, NamedSharding(mesh, P("model")))
                self.opt_state = (self.tx.init(rest), table_acc)
                self._step = make_sharded_sparse_table_step(
                    self.model, cfg, self.tx, learning_rate, self.loss_fn, mesh,
                    table_learning_rate=table_learning_rate, dedup=dedup,
                )
            else:
                self.opt_state = (self.tx.init(rest), table_acc)
                # Donate params+opt state: tables are updated in place on
                # device instead of being copied every step.
                self._step = jax.jit(make_sparse_table_step(
                    self.model, cfg, self.tx, learning_rate, self.loss_fn,
                    table_learning_rate=table_learning_rate, dedup=dedup,
                ), donate_argnums=(0, 1))
        else:
            self.opt_state = self.tx.init(self.params)
            self._step = self._build_step()

    def _build_step(self):
        model_apply, loss_fn, tx = self.model.apply, self.loss_fn, self.tx

        def step(params, opt_state, batch: Batch, targets):
            def objective(p):
                return loss_fn(model_apply(p, batch), targets)

            loss, grads = jax.value_and_grad(objective)(params)
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return params, opt_state, loss

        if self.mesh is None:
            return jax.jit(step, donate_argnums=(0, 1))
        ps = param_shardings(self.params, self.mesh)
        tables = self.params["tables"]
        # Packed float tables are {"packed": (Rp, pack*d)}; the optimizer
        # accumulators mirror that leaf's shape and row-shard the same way.
        table_arr = tables["packed"] if isinstance(tables, dict) else tables
        table_shape = tuple(table_arr.shape)

        def state_leaf_sharding(path, leaf):
            # Optimizer state trees mirror the param tree (adagrad's
            # sum_of_squares / adam's mu+nu carry the "tables" key), so
            # shard by TREE PATH like param_shardings does — a shape-
            # equality test would also row-shard any MLP moment whose
            # weight coincidentally matches the fused-table shape, forcing
            # a silent reshard collective every step.
            keys = [getattr(p, "key", getattr(p, "name", None)) for p in path]
            if ("tables" in keys and hasattr(leaf, "shape")
                    and tuple(leaf.shape) == table_shape):
                return NamedSharding(self.mesh, P("model", None))
            return NamedSharding(self.mesh, P())

        os_sh = jax.tree_util.tree_map_with_path(state_leaf_sharding,
                                                 self.opt_state)
        bs = batch_shardings(self.mesh, has_dense=self.cfg.dense_dim > 0)
        tgt_sh = NamedSharding(self.mesh, P("data", None))
        return jax.jit(
            step,
            in_shardings=(ps, os_sh, bs, tgt_sh),
            out_shardings=(ps, os_sh, NamedSharding(self.mesh, P())),
            donate_argnums=(0, 1),
        )

    # ------------------------------------------------------------------

    def fit(
        self,
        num_steps: int,
        batch_size: int = 128,
        seed: int = 1,
        eval_every: int = 0,
        label_fn: Callable | None = None,
    ) -> TrainHistory:
        """Train on synthetic data. ``label_fn(batch) -> (B,)`` labels;
        defaults to a dense-feature threshold rule (learnable signal) for
        dense models, an index-parity rule otherwise."""
        gen = RecDataGenerator(self.cfg, seed=seed)
        losses, aucs = [], []
        for i in range(num_steps):
            host = gen.generate_batch(batch_size)
            labels = self._labels(host, label_fn)
            batch = Batch(
                dense=None if host.dense is None else jnp.asarray(host.dense),
                indices=jnp.asarray(host.indices),
            )
            targets = jnp.asarray(
                np.broadcast_to(labels[:, None], (batch_size, self.cfg.out_dim)).copy()
            )
            self.params, self.opt_state, loss = self._step(
                self.params, self.opt_state, batch, targets
            )
            losses.append(float(loss))
            if eval_every and (i + 1) % eval_every == 0:
                aucs.append(self.evaluate(gen, batch_size, label_fn))
        return TrainHistory(losses=losses, eval_aucs=aucs)

    def _labels(self, host: Batch, label_fn) -> np.ndarray:
        if label_fn is not None:
            return np.asarray(label_fn(host), dtype=np.float32)
        if host.dense is not None:
            m = host.dense.mean(axis=1)
            return (m > np.median(m)).astype(np.float32)
        return (host.indices[:, 0, 0] % 2).astype(np.float32)

    def evaluate(self, gen: RecDataGenerator, batch_size: int = 256,
                 label_fn: Callable | None = None) -> float:
        host = gen.generate_batch(batch_size)
        labels = self._labels(host, label_fn)
        scores = np.asarray(self.model.apply(self.params, host).astype(jnp.float32))
        return auc(scores[:, 0], labels.astype(int))

    def evaluate_batches(self, batches) -> dict:
        """Held-out evaluation over an iterable of (host Batch, labels)
        pairs (e.g. ``CriteoReader.batches`` on a validation file):
        ROC-AUC + binary log-loss — the Criteo benchmark's metrics.
        Raw-logit models (no sigmoid in the graph) are converted to
        probabilities for the log-loss."""
        from deeprecsys_tpu.models import sigmoid_output

        probs, ys = [], []
        sig = sigmoid_output(self.cfg)
        for host, labels in batches:
            s = np.asarray(
                self.model.apply(self.params, host).astype(jnp.float32))[:, 0]
            if not sig:
                s = 1.0 / (1.0 + np.exp(-s))
            probs.append(s)
            ys.append(np.asarray(labels, np.float32).reshape(-1))
        if not probs:
            raise ValueError("evaluate_batches: empty batch iterable")
        p = np.concatenate(probs)
        y = np.concatenate(ys)
        pc = np.clip(p, 1e-7, 1.0 - 1e-7)
        logloss = float(-np.mean(y * np.log(pc) + (1 - y) * np.log(1 - pc)))
        return {"auc": auc(p, y.astype(int)), "logloss": logloss,
                "n": int(y.size)}


def export_serving_params(params: dict, cfg: ModelConfig,
                          table_quant: str = "int8_rowwise"):
    """Convert TRAINED float params into a quantized serving bundle.

    The train -> quantize -> serve path: training requires float tables
    (gradients), serving wants int8 for 4x HBM capacity. Per-row scales
    (``int8_rowwise``) are the fidelity-preserving choice for trained
    tables, whose row norms diverge (hot rows accumulate large updates);
    per-table ("int8") matches the init-time layout.

    Returns ``(serving_params, serving_cfg)`` — drop into ``get_model`` /
    the serving engines as-is (e.g. ``run_serving(..., params=...)``).
    """
    from deeprecsys_tpu.ops.embedding import (
        quantize_pertable_int8,
        quantize_rowwise_int8,
    )

    tables = params["tables"]
    if isinstance(tables, dict):  # {"q"/"qrows", ...} layouts
        raise ValueError("params already quantized")
    # Accept numpy leaves too: load_params (utils/checkpoint.py) restores
    # checkpoints as np.ndarray, and the train->checkpoint->quantize->serve
    # path must work.
    tables = jnp.asarray(tables)
    scfg = cfg.replace(table_quant=table_quant)
    if table_quant == "int8_rowwise":
        new_tables = {"qrows": quantize_rowwise_int8(tables)}
    elif table_quant == "int8":
        new_tables = quantize_pertable_int8(tables, cfg.scaled_rows)
        pack = scfg.resolved_table_pack
        if pack > 1:
            # The serving layout the returned config resolves to
            # (config.resolved_table_pack): the exported bundle must
            # match it — a {"q"} bundle would fail
            # the {"q_packed"} model's checkpoint-shape validation.
            from deeprecsys_tpu.ops.embedding import pack_table

            new_tables = {"q_packed": pack_table(new_tables["q"], pack),
                          "scale": new_tables["scale"]}
    else:
        raise ValueError(f"unknown table_quant {table_quant!r}")
    return dict(params, tables=new_tables), scfg


def _fit_batches(trainer: Trainer, batches) -> list[float]:
    """Run the train step over an iterable of (host Batch, labels) pairs
    (e.g. ``CriteoReader.batches``); returns per-step losses."""
    losses = []
    for host, labels in batches:
        batch = Batch(
            dense=None if host.dense is None else jnp.asarray(host.dense),
            indices=jnp.asarray(host.indices),
        )
        t = jnp.asarray(np.asarray(labels, dtype=np.float32))
        if t.ndim == 1:
            t = jnp.broadcast_to(t[:, None], (t.shape[0], trainer.cfg.out_dim))
        trainer.params, trainer.opt_state, loss = trainer._step(
            trainer.params, trainer.opt_state, batch, t)
        losses.append(float(loss))
    return losses


def main(argv=None):
    """Training CLI — the capability the reference only stubs
    (``--inference_only`` defaults True and nothing trains,
    utils/utils.py:40):

      python -m deeprecsys_tpu.train --model rm1 --steps 200 \
          [--sparse_tables] [--criteo train.txt] [--save ckpt] \
          [--export_quant int8_rowwise --export_out ckpt_q]
    """
    import argparse

    from deeprecsys_tpu import zoo

    ap = argparse.ArgumentParser(description="DeepRecSys trainer")
    ap.add_argument("--model", default="rm1",
                    help=f"zoo name {zoo.MODEL_NAMES} (ignored with --criteo)")
    ap.add_argument("--table_scale", type=int, default=1)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch_size", type=int, default=128)
    ap.add_argument("--optimizer", default="adagrad",
                    choices=["sgd", "adagrad", "adam"])
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--loss", default="bce", choices=["bce", "mse"])
    ap.add_argument("--sparse_tables", action="store_true",
                    help="touched-rows-only table updates + row-wise AdaGrad")
    ap.add_argument("--eval_every", type=int, default=0)
    ap.add_argument("--criteo_eval", default=None,
                    help="held-out Criteo TSV: report ROC-AUC + log-loss "
                         "after each epoch (with --criteo)")
    ap.add_argument("--eval_batches", type=int, default=64,
                    help="held-out batches per evaluation (--criteo_eval)")
    ap.add_argument("--criteo", default=None,
                    help="Criteo/Kaggle TSV file: train on real data instead of synthetic")
    ap.add_argument("--criteo_rows_per_table", type=int, default=1_000_000)
    ap.add_argument("--epochs", type=int, default=1, help="epochs over --criteo")
    ap.add_argument("--save", default=None, help="checkpoint path for trained params")
    ap.add_argument("--export_quant", default=None,
                    choices=["int8", "int8_rowwise"],
                    help="also export a quantized serving bundle")
    ap.add_argument("--export_out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compilation_cache_dir", default=None,
                    help="persistent XLA compilation cache directory; "
                         "JAX_COMPILATION_CACHE_DIR wins when set, the "
                         "default is .jax_cache in the checkout")
    args = ap.parse_args(argv)
    from deeprecsys_tpu.utils.devices import init_compilation_cache

    init_compilation_cache(args.compilation_cache_dir)

    if args.criteo:
        from deeprecsys_tpu.data.criteo import CriteoReader, criteo_model_config

        cfg = criteo_model_config(rows_per_table=args.criteo_rows_per_table)
        tr = Trainer(cfg, optimizer=args.optimizer, learning_rate=args.lr,
                     loss=args.loss, seed=args.seed,
                     sparse_tables=args.sparse_tables)
        reader = CriteoReader(args.criteo, cfg)
        losses = []
        for epoch in range(args.epochs):
            ls = _fit_batches(tr, reader.batches(args.batch_size,
                                                 max_batches=args.steps))
            losses.extend(ls)
            msg = (f"epoch {epoch}: {len(ls)} steps, "
                   f"loss {np.mean(ls[:4]):.4f} -> {np.mean(ls[-4:]):.4f}")
            if args.criteo_eval:
                ev = tr.evaluate_batches(
                    CriteoReader(args.criteo_eval, cfg).batches(
                        args.batch_size, max_batches=args.eval_batches))
                msg += (f", holdout AUC {ev['auc']:.4f} "
                        f"logloss {ev['logloss']:.4f} ({ev['n']} rows)")
            print(msg, flush=True)
    else:
        cfg = zoo.get_config(args.model, table_scale=args.table_scale)
        tr = Trainer(cfg, optimizer=args.optimizer, learning_rate=args.lr,
                     loss=args.loss, seed=args.seed,
                     sparse_tables=args.sparse_tables)
        hist = tr.fit(args.steps, batch_size=args.batch_size,
                      eval_every=args.eval_every)
        losses = hist.losses
        msg = f"{len(losses)} steps, loss {np.mean(losses[:4]):.4f} -> {np.mean(losses[-4:]):.4f}"
        if hist.eval_aucs:
            msg += f", AUC {hist.eval_aucs[-1]:.3f}"
        print(msg, flush=True)

    if args.save:
        from deeprecsys_tpu.utils.checkpoint import save_params

        save_params(args.save, tr.params)
        print(f"saved params -> {args.save}", flush=True)
    if args.export_quant:
        out = args.export_out or (args.save or "serving_params") + f"_{args.export_quant}"
        sp, _scfg = export_serving_params(tr.params, tr.cfg,
                                          table_quant=args.export_quant)
        from deeprecsys_tpu.utils.checkpoint import save_params

        save_params(out, sp)
        print(f"exported {args.export_quant} serving bundle -> {out}", flush=True)
    return losses


if __name__ == "__main__":
    main()
