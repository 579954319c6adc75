"""MLP towers.

Reference equivalent: ``create_mlp`` in every model file (e.g.
``dlrm_s_caffe2.py:223-280``): a chain of Caffe2 ``FC`` + ``Relu`` ops with a
``Sigmoid`` at layer index ``sigmoid_layer``.

Notes: weights are stored (in, out) so the forward pass is
``x @ W + b`` — a plain ``dot_general``; XLA fuses the bias add and
activation into the matmul epilogue. Initialization matches the reference:
W ~ N(0, sqrt(2/(in+out))), b ~ N(0, sqrt(1/out))
(``dlrm_s_caffe2.py:243-252``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def mlp_init(key: jax.Array, dims, dtype=jnp.float32) -> list[dict]:
    """Initialize an MLP for layer sizes ``dims = [in, h1, ..., out]``."""
    params = []
    keys = jax.random.split(key, max(len(dims) - 1, 1))
    for i in range(1, len(dims)):
        n, m = dims[i - 1], dims[i]
        kw, kb = jax.random.split(keys[i - 1])
        w = jax.random.normal(kw, (n, m), dtype=jnp.float32) * jnp.sqrt(2.0 / (m + n))
        b = jax.random.normal(kb, (m,), dtype=jnp.float32) * jnp.sqrt(1.0 / m)
        params.append({"w": w.astype(dtype), "b": b.astype(dtype)})
    return params


def mlp_apply(params, x: jax.Array, sigmoid_layer: int = -1,
              final_relu: bool = True) -> jax.Array:
    """Run the MLP.

    ``sigmoid_layer`` uses the reference's 1-based layer indexing
    (``create_mlp``'s ``i == sigmoid_layer``; ``sigmoid_top = ln.size - 1``
    selects the final layer). -1 means all-ReLU.

    ``final_relu=False`` leaves the LAST layer's pre-activation exposed
    (the ``output_head="logits"`` head of the relu-scored families —
    config.py output_head has the training/ranking rationale). Hidden
    layers keep their relu; a ``sigmoid_layer`` hit on the last layer
    takes precedence.
    """
    out_dtype = x.dtype
    n = len(params)
    for i, layer in enumerate(params, start=1):
        # Accumulation in f32 regardless of storage dtype; downcast at
        # the layer boundary (standard bf16 practice — keeps ranking
        # fidelity, costs nothing: XLA fuses the epilogue).
        y = jnp.dot(x, layer["w"], preferred_element_type=jnp.float32)
        y = y + layer["b"].astype(jnp.float32)
        if i == sigmoid_layer:
            y = jax.nn.sigmoid(y)
        elif i < n or final_relu:
            y = jax.nn.relu(y)
        x = y.astype(out_dtype)
    return x
