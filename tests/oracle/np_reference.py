"""Pure-NumPy re-implementations of the eight reference model op graphs.

This is the independent parity oracle:
each forward pass below is written op-by-op from the REFERENCE graph
builders in the reference's ``models/`` — per-table ``SparseLengthsSum``
loops over CSR (indices, lengths) inputs, Caffe2 ``FC`` semantics
(``y = x @ W^T + b`` with ``W`` stored (out, in)), per-behavior-table
attention MLP loops, explicit flatten + tril ``BatchGather`` — NOT from the
JAX implementation (which fuses tables into one gather, stacks the DIN/MT
MLPs into batched einsums, and hoists RNN input projections). The two paths
share only the config and the weight VALUES (adapted by
``oracle_weights_from_params``); every compute step is derived separately.

Reference citations per model:
- DLRM        ``dlrm_s_caffe2.py``: create_mlp :223-279, create_emb :281-327,
              create_interactions :331-363, sigmoid_top :473,
              tril indices :531-535.
- WnD         ``wide_and_deep.py``: create_interactions :271-280 (Concat of
              dense + pooled embeddings), sigmoid_top :383.
- MT-WnD      ``multi_task_wnd.py``: shared all-ReLU top :304, per-task heads
              :306-316 called with sigmoid index ``ln_top.size - 1`` :396.
- NCF         ``ncf.py``: create_mf_interaction (Sum) :301-305,
              create_mlp_interaction (Concat) :308-314, MLP over
              ``ln_top[:-1]`` :330-332, branch Concat + final FC
              ``[m + ln_top[-2]] -> ln_top[-1]`` :334-343, all-ReLU
              create_mlp :149-188.
- DIN         ``din.py``: create_attention_unit :246-285 (Sum -> 3-leg
              Concat -> per-table MLP ``[3m]+mlp_bot+[m]`` -> Sum), top
              Concat [profile, attention, ad, context] :317-328, all-ReLU
              create_mlp :151-188.
- DIEN        ``dien.py``: create_gru_unit :308-380 (BasicRNN #0 tanh ->
              per-step FC axis=2 + Softmax axis=2 + Sum -> BasicRNN #1,
              final hidden), top Concat [gru, profile, ad, context]
              :414-426, seq_lengths/initial_h feeding :112-132,505-516.

Documented deviation (shared by the JAX path and this oracle): the
reference's ``Reshape`` of the concatenated behavior tensor to
``(T_b, -1, m)`` (``dien.py:315-319``) is a raw row-major buffer
reinterpretation of a ``(B, T_b*m)`` array; whenever ``B != T_b`` it
scrambles batch entries across time steps (request b's score would depend
on other requests co-batched with it — per-request results would change
with batch composition, breaking sub-batch rejoin equivalence). Both this
oracle and ``models/dien.py`` implement the documented intent — time step
t = behavior table t, i.e. ``seq[t, b, :] = emb_t[b, :]`` — which is what
the surrounding graph (per-request seq_lengths sized T_b) assumes.

Everything here runs in float64 for an independent error reference; the
parity test compares the f32 JAX forward against it with an f32-roundoff
tolerance.
"""

from __future__ import annotations

import numpy as np


# ----------------------------------------------------------------------
# Reference operator semantics
# ----------------------------------------------------------------------


def sparse_lengths_sum(table: np.ndarray, indices: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Caffe2 ``SparseLengthsSum`` (CSR): gather ``table[indices]`` and sum
    consecutive runs of ``lengths[b]`` rows into output row b
    (``dlrm_s_caffe2.py:319-325``)."""
    out = np.zeros((len(lengths), table.shape[1]), dtype=table.dtype)
    pos = 0
    for b, n in enumerate(lengths):
        for _ in range(int(n)):
            out[b] += table[int(indices[pos])]
            pos += 1
    assert pos == len(indices), (pos, len(indices))
    return out


def fc(x: np.ndarray, w: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Caffe2 ``FC``: ``y = x @ W^T + b`` with W stored (out, in)
    (``dlrm_s_caffe2.py:255-264``; weight shape ``size=(m, n)`` :247)."""
    return x @ w.T + b


def sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def softmax(x: np.ndarray, axis: int) -> np.ndarray:
    e = np.exp(x - np.max(x, axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


def mlp(x: np.ndarray, layers, sigmoid_layer: int = -1) -> np.ndarray:
    """Reference ``create_mlp`` chain (``dlrm_s_caffe2.py:223-279``):
    FC -> Sigmoid at the 1-based layer index ``sigmoid_layer``, Relu
    elsewhere. ``layers`` is a list of (W (out,in), b (out,)) pairs."""
    for i, (w, b) in enumerate(layers, start=1):
        y = fc(x, w, b)
        x = sigmoid(y) if i == sigmoid_layer else np.maximum(y, 0.0)
    return x


# ----------------------------------------------------------------------
# Model forwards (one function per reference model file)
# ----------------------------------------------------------------------


def dlrm_forward(w: dict, X: np.ndarray, S_indices, S_lengths, *,
                 interaction_op: str, interaction_itself: bool) -> np.ndarray:
    """``dlrm_s_caffe2.py`` create_sequential_forward_ops :367-388."""
    ly = [sparse_lengths_sum(t, i, l)
          for t, i, l in zip(w["tables"], S_indices, S_lengths)]
    x = mlp(X, w["bot"], sigmoid_layer=-1)  # sigmoid_bot = -1 (:472)
    if interaction_op == "dot":
        # Concat(add_axis=1) -> (B, F, d); BatchMatMul(trans_b=1);
        # Flatten; BatchGather(tril); Concat with dense (:334-354).
        T = np.stack([x] + ly, axis=1)
        Z = np.einsum("bfd,bgd->bfg", T, T)
        num_fea = len(ly) + 1
        offset = 1 if interaction_itself else 0
        tril = np.array([j + i * num_fea
                         for i in range(num_fea) for j in range(i + offset)])
        Zflat = Z.reshape(Z.shape[0], -1)[:, tril]
        R = np.concatenate([x, Zflat], axis=1)
    else:  # "cat" (:355-360)
        R = np.concatenate([x] + ly, axis=1)
    # sigmoid_top = ln_top.size - 1 (:473) == number of top layers.
    return mlp(R, w["top"], sigmoid_layer=len(w["top"]))


def wnd_forward(w: dict, X: np.ndarray, S_indices, S_lengths) -> np.ndarray:
    """``wide_and_deep.py`` :271-280 (Concat) + top MLP with final Sigmoid."""
    ly = [sparse_lengths_sum(t, i, l)
          for t, i, l in zip(w["tables"], S_indices, S_lengths)]
    R = np.concatenate([X] + ly, axis=1)
    return mlp(R, w["top"], sigmoid_layer=len(w["top"]))


def mtwnd_forward(w: dict, X: np.ndarray, S_indices, S_lengths,
                  *, ln_top_size: int) -> np.ndarray:
    """``multi_task_wnd.py`` :296-316: shared all-ReLU trunk, then per-task
    head MLPs each called with sigmoid index ``ln_top.size - 1`` (:396) —
    the reference's index-based quirk, applied to the HEAD's layer chain.

    Returns all task head outputs concatenated (B, num_tasks * task_out);
    the reference materializes every head in the graph (its `last_output`
    bookkeeping aside)."""
    ly = [sparse_lengths_sum(t, i, l)
          for t, i, l in zip(w["tables"], S_indices, S_lengths)]
    R = np.concatenate([X] + ly, axis=1)
    shared = mlp(R, w["top"], sigmoid_layer=-1)
    heads = [mlp(shared, task_layers, sigmoid_layer=ln_top_size - 1)
             for task_layers in w["tasks"]]
    return np.concatenate(heads, axis=1)


def ncf_forward(w: dict, S_indices, S_lengths) -> np.ndarray:
    """``ncf.py`` :318-346: tables 0-1 -> MF Sum branch, tables 2-3 ->
    Concat + MLP over ln_top[:-1]; branch Concat; final FC. NCF's
    create_mlp is all-ReLU (:149-188)."""
    ly = [sparse_lengths_sum(t, i, l)
          for t, i, l in zip(w["tables"], S_indices, S_lengths)]
    zmf = ly[0] + ly[1]                       # create_mf_interaction: Sum
    zmlp = np.concatenate([ly[2], ly[3]], axis=1)
    top = mlp(zmlp, w["mlp"], sigmoid_layer=-1)
    R = np.concatenate([zmf, top], axis=1)    # Concat([Zmf] + [top_l[-1]])
    return mlp(R, w["final"], sigmoid_layer=-1)


def din_forward(w: dict, S_indices, S_lengths) -> np.ndarray:
    """``din.py`` :246-331: per-behavior-table attention loop, summed, then
    top MLP over Concat[profile, attention, ad, context]. All-ReLU."""
    ly = [sparse_lengths_sum(t, i, l)
          for t, i, l in zip(w["tables"], S_indices, S_lengths)]
    n = len(ly)
    profile, ad, ctx = ly[0], ly[n - 2], ly[n - 1]
    behavior = ly[1: n - 2]
    fc_outs = []
    for t, user in enumerate(behavior):
        Y = user + ad                                       # Sum (:262)
        C = np.concatenate([user, ad, Y], axis=1)           # 3-leg Concat (:266-271)
        fc_outs.append(mlp(C, w["attention"][t], sigmoid_layer=-1))
    attention = np.sum(fc_outs, axis=0)                     # Sum over tables (:284)
    R = np.concatenate([profile, attention, ad, ctx], axis=1)  # :319-325
    return mlp(R, w["top"], sigmoid_layer=-1)


def basic_rnn(xs: np.ndarray, i2h_w, i2h_b, gates_w, gates_b,
              seq_lengths: np.ndarray, initial_h: np.ndarray):
    """Caffe2 ``rnn_cell.BasicRNN`` (tanh, forward-only, ``dien.py:336-344``):

        h_t = tanh(FC_i2h(x_t) + FC_gates(h_{t-1}))

    with per-element sequence masking: once ``t >= seq_lengths[b]`` element
    b's hidden state stops updating (Caffe2 recurrent nets copy the previous
    state for finished sequences), so the final hidden state equals the
    state at each element's own length. Returns (all_h (T, B, H), last (B, H)).
    """
    T, B, _ = xs.shape
    h = initial_h.astype(xs.dtype)
    all_h = np.zeros((T, B, gates_w.shape[0]), dtype=xs.dtype)
    for t in range(T):
        new_h = np.tanh(fc(xs[t], i2h_w, i2h_b) + fc(h, gates_w, gates_b))
        alive = (t < seq_lengths)[:, None]
        h = np.where(alive, new_h, h)
        all_h[t] = h
    return all_h, h


def dien_forward(w: dict, S_indices, S_lengths, *,
                 seq_lengths: np.ndarray | None = None,
                 initial_h: np.ndarray | None = None) -> np.ndarray:
    """``dien.py`` create_gru_unit :308-380 + top :414-426.

    Behavior embeddings are stacked time-major (t = behavior table t) — the
    documented intent of the reference's Reshape (see module docstring for
    why the literal buffer reinterpretation is not replicated). seq_lengths
    defaults to T_b for every element (the reference feeds exactly that,
    :112-116) and initial_h to zeros (:117-118).
    """
    ly = [sparse_lengths_sum(t, i, l)
          for t, i, l in zip(w["tables"], S_indices, S_lengths)]
    n = len(ly)
    profile, ad, ctx = ly[0], ly[n - 2], ly[n - 1]
    behavior = ly[1: n - 2]
    T_b, B = len(behavior), ly[0].shape[0]
    H = w["rnn0"]["gates_w"].shape[0]
    if seq_lengths is None:
        seq_lengths = np.full(B, T_b, dtype=np.int32)
    if initial_h is None:
        initial_h = np.zeros((B, H))

    seq = np.stack(behavior, axis=0)  # (T_b, B, m) time-major
    r0 = w["rnn0"]
    out0, _ = basic_rnn(seq, r0["i2h_w"], r0["i2h_b"], r0["gates_w"],
                        r0["gates_b"], seq_lengths, initial_h)
    # brew.fc(axis=2) + brew.softmax(axis=2) + brew.sum (:346-356).
    gate = fc(out0, w["gate_fc"][0], w["gate_fc"][1])
    gated = out0 + softmax(gate, axis=2)
    r1 = w["rnn1"]
    _, last = basic_rnn(gated, r1["i2h_w"], r1["i2h_b"], r1["gates_w"],
                        r1["gates_b"], seq_lengths, initial_h)

    R = np.concatenate([last, profile, ad, ctx], axis=1)  # :414-421
    return mlp(R, w["top"], sigmoid_layer=-1)             # all-ReLU (:250)


# ----------------------------------------------------------------------
# Adapters: JAX params/batch -> the reference's weight & input layouts
# ----------------------------------------------------------------------


def _ref_mlp(layers) -> list:
    """JAX MLP layers [{"w": (in,out), "b": (out,)}] -> reference (out,in)."""
    return [(np.asarray(l["w"], dtype=np.float64).T,
             np.asarray(l["b"], dtype=np.float64)) for l in layers]


def _ref_stacked_mlp(layers, num: int) -> list:
    """Stacked (num, in, out) JAX layers -> per-unit reference MLP lists."""
    return [[(np.asarray(l["w"][t], dtype=np.float64).T,
              np.asarray(l["b"][t], dtype=np.float64)) for l in layers]
            for t in range(num)]


def _ref_rnn(p: dict) -> dict:
    """ops/rnn.py layout ((in,H) i2h_w, (H,H) h2h_w) -> Caffe2 (out,in)."""
    return {
        "i2h_w": np.asarray(p["i2h_w"], dtype=np.float64).T,
        "i2h_b": np.asarray(p["i2h_b"], dtype=np.float64),
        "gates_w": np.asarray(p["h2h_w"], dtype=np.float64).T,
        "gates_b": np.asarray(p["h2h_b"], dtype=np.float64),
    }


def oracle_weights_from_params(params: dict, cfg) -> dict:
    """Convert a JAX param pytree (float tables) into the oracle's
    per-table / (out,in) reference layouts. Purely mechanical (slice +
    transpose + dtype) — no compute semantics live here."""
    tables = params["tables"]
    if isinstance(tables, dict) and "packed" in tables:
        # Row-packed layout (ops/embedding.py pack_table): p consecutive
        # logical rows per physical row. Mechanical numpy un-pack —
        # (R/p, p*d) -> (R, d), trailing pad rows sliced off.
        arr = np.asarray(tables["packed"], dtype=np.float64)
        d = int(cfg.sparse_feature_size)
        fused = arr.reshape(-1, d)[: int(cfg.total_rows)]
    else:
        fused = np.asarray(tables, dtype=np.float64)
    offs = np.asarray(cfg.table_offsets, dtype=np.int64)
    rows = np.asarray(cfg.scaled_rows, dtype=np.int64)
    w = {"tables": [fused[o: o + r] for o, r in zip(offs, rows)]}
    if cfg.model_type == "dlrm":
        w["bot"] = _ref_mlp(params["bot"])
        w["top"] = _ref_mlp(params["top"])
    elif cfg.model_type == "wnd":
        w["top"] = _ref_mlp(params["top"])
    elif cfg.model_type == "mtwnd":
        w["top"] = _ref_mlp(params["top"])
        w["tasks"] = _ref_stacked_mlp(params["tasks"], cfg.num_multi_tasks)
    elif cfg.model_type == "ncf":
        w["mlp"] = _ref_mlp(params["mlp"])
        w["final"] = _ref_mlp(params["final"])
    elif cfg.model_type == "din":
        w["attention"] = _ref_stacked_mlp(params["attention"],
                                          len(cfg.behavior_table_ids))
        w["top"] = _ref_mlp(params["top"])
    elif cfg.model_type == "dien":
        w["rnn0"] = _ref_rnn(params["rnn0"])
        w["rnn1"] = _ref_rnn(params["rnn1"])
        w["gate_fc"] = (np.asarray(params["gate_fc"]["w"], dtype=np.float64).T,
                        np.asarray(params["gate_fc"]["b"], dtype=np.float64))
        w["top"] = _ref_mlp(params["top"])
    else:
        raise AssertionError(cfg.model_type)
    return w


def csr_from_batch(indices: np.ndarray):
    """Fused (B, T, L) index tensor -> the reference's per-table CSR feed
    (``inferenceEngine.py:200-206``): S_indices[t] is the flat (B*L,) id
    stream, S_lengths[t] = L per sample."""
    B, T, L = indices.shape
    S_indices = [np.asarray(indices[:, t, :]).reshape(-1).astype(np.int64)
                 for t in range(T)]
    S_lengths = [np.full(B, L, dtype=np.int64) for _ in range(T)]
    return S_indices, S_lengths


def oracle_forward(cfg, w: dict, X: np.ndarray | None, S_indices, S_lengths,
                   **kw) -> np.ndarray:
    """Dispatch to the per-model reference graph."""
    if cfg.model_type == "dlrm":
        return dlrm_forward(w, X, S_indices, S_lengths,
                            interaction_op=cfg.interaction_op,
                            interaction_itself=cfg.interaction_itself)
    if cfg.model_type == "wnd":
        return wnd_forward(w, X, S_indices, S_lengths)
    if cfg.model_type == "mtwnd":
        return mtwnd_forward(w, X, S_indices, S_lengths,
                             ln_top_size=len(cfg.ln_top))
    if cfg.model_type == "ncf":
        return ncf_forward(w, S_indices, S_lengths)
    if cfg.model_type == "din":
        return din_forward(w, S_indices, S_lengths)
    if cfg.model_type == "dien":
        return dien_forward(w, S_indices, S_lengths, **kw)
    raise AssertionError(cfg.model_type)
