"""Deep Interest Evolution Network.

Reference: ``models/dien.py``. Same 4 feature roles as DIN (:393-398). GRU
unit (``create_gru_unit`` :308-380): behavior embeddings stacked time-major
(T_b, B, m) (:315-319) -> Caffe2 ``BasicRNN`` #0 (tanh, forward-only,
:336-344) -> per-step FC (H->H, axis=2) + Softmax(axis=2) + elementwise Sum
with the RNN output (:346-356, an attention-style gate) -> ``BasicRNN`` #1
(:370-378), keeping only the final hidden state. Top-MLP input =
Concat[gru_hidden, profile, ad, context] = H + 3*m (:414-426), all-ReLU.

Redesign: both RNNs are ``jax.lax.scan`` loops with the input
projection hoisted into one large matmul (ops/rnn.py); the per-step
FC+softmax gate is a single batched matmul over the (T_b, B, H) tensor.

Ragged histories: the reference plumbs per-request ``seq_lengths`` and
``initial_h`` through dedicated BlobsQueues (:112-132, :156-194) even
though every shipped config feeds the constant T_b and zeros. The same
contract is exposed here as optional ``seq_lengths``/``initial_h``
arguments on ``apply``/``apply_from_pooled``: a masked scan freezes each
request's hidden state at its own length (Caffe2 recurrent-net semantics),
so a padded batched run scores each request exactly as an unpadded run of
its own length (``test_models.py::test_dien_variable_length_histories``).
Defaults (None) preserve the shipped constant-length behavior and the
dense fast path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from deeprecsys_tpu.config import ModelConfig
from deeprecsys_tpu.models.base import Batch, compute_dtype_of, param_dtype_of, pooled_lookup, init_tables
from deeprecsys_tpu.ops import mlp_init, mlp_apply, basic_rnn_init, basic_rnn_scan


def init(key: jax.Array, cfg: ModelConfig) -> dict:
    pdt = param_dtype_of(cfg)
    m, H = cfg.sparse_feature_size, cfg.hidden_size
    k_emb, k_r0, k_fc, k_r1, k_top = jax.random.split(key, 5)
    # Gate FC init matches the reference's brew.fc defaults (Xavier-like);
    # we reuse the MLP initializer.
    return {
        "tables": init_tables(k_emb, cfg),
        "rnn0": basic_rnn_init(k_r0, m, H, pdt),
        "gate_fc": mlp_init(k_fc, (H, H), pdt)[0],
        "rnn1": basic_rnn_init(k_r1, H, H, pdt),
        "top": mlp_init(k_top, cfg.ln_top, pdt),  # (H + 3m,) + mlp_top
    }


def apply_from_pooled(params: dict, emb: jax.Array, batch: Batch, cfg: ModelConfig,
                      seq_lengths: jax.Array | None = None,
                      initial_h: jax.Array | None = None) -> jax.Array:
    T = cfg.num_tables
    profile = emb[:, 0, :]
    behavior = emb[:, 1 : T - 2, :]  # (B, T_b, m)
    ad = emb[:, T - 2, :]
    ctx = emb[:, T - 1, :]

    seq = jnp.transpose(behavior, (1, 0, 2))  # time-major (T_b, B, m)
    out0, _ = basic_rnn_scan(params["rnn0"], seq, h0=initial_h,
                             seq_lengths=seq_lengths)  # (T_b, B, H)
    # Bias-add and softmax in f32, then downcast at the boundary (the
    # mlp_apply convention) — adding the f32 bias AFTER a bf16 downcast
    # would type-promote gate/rnn1/top back to f32 and silently double the
    # activation width of the whole tail under compute_dtype=bfloat16.
    gate = jnp.dot(out0, params["gate_fc"]["w"],
                   preferred_element_type=jnp.float32)
    gate = jax.nn.softmax(gate + params["gate_fc"]["b"].astype(jnp.float32),
                          axis=2).astype(out0.dtype)
    gated = out0 + gate  # reference brew.sum of rnn_0 output and softmax gate
    _, last = basic_rnn_scan(params["rnn1"], gated, h0=initial_h,
                             seq_lengths=seq_lengths)  # (B, H)

    z = jnp.concatenate([last, profile, ad, ctx], axis=1)  # (B, H + 3m)
    # Reference head = all-ReLU; "logits" exposes the final FC's
    # pre-activation for training/ranking (config.py output_head).
    return mlp_apply(params["top"], z,
                     final_relu=cfg.output_head != "logits")


def apply(params: dict, batch: Batch, cfg: ModelConfig,
          seq_lengths: jax.Array | None = None,
          initial_h: jax.Array | None = None) -> jax.Array:
    return apply_from_pooled(params, pooled_lookup(params["tables"], batch, cfg),
                             batch, cfg, seq_lengths=seq_lengths, initial_h=initial_h)
