"""Feature interactions.

Reference equivalent: ``create_interactions`` (``dlrm_s_caffe2.py:331-363``):
"dot" = Concat(add_axis) + BatchMatMul + Flatten + BatchGather(tril indices)
+ Concat-with-dense; "cat" = plain Concat.

Notes: the pairwise dot is one batched matmul
(``einsum bfd,bgd->bfg``); the lower-triangle extraction uses a static
index pair computed at trace time (the reference feeds precomputed
``tril_indices`` the same way, ``dlrm_s_caffe2.py:531-535``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _tril_pairs(num_fea: int, include_diag: bool) -> tuple[np.ndarray, np.ndarray]:
    # Reference: [j + i*num_fea for i in range(num_fea) for j in range(i+offset)]
    # with offset = 1 when interacting with itself (includes diagonal).
    offset = 1 if include_diag else 0
    ii, jj = [], []
    for i in range(num_fea):
        for j in range(i + offset):
            ii.append(i)
            jj.append(j)
    return np.asarray(ii, dtype=np.int32), np.asarray(jj, dtype=np.int32)


def dot_interaction(dense_out: jax.Array, emb_out: jax.Array, *, self_interaction: bool = False) -> jax.Array:
    """DLRM "dot" interaction.

    Args:
      dense_out: (B, d) bottom-MLP output.
      emb_out: (B, T, d) pooled embeddings.

    Returns:
      (B, d + P) with P = num_fea*(num_fea±1)/2 pairwise dot products,
      dense features first (reference Concat order, dlrm_s_caffe2.py:352).
    """
    feats = jnp.concatenate([dense_out[:, None, :], emb_out], axis=1)  # (B, F, d)
    # f32 accumulation under bf16 compute, as everywhere else (ops/mlp.py).
    z = jnp.einsum("bfd,bgd->bfg", feats, feats,
                   preferred_element_type=jnp.float32).astype(feats.dtype)
    ii, jj = _tril_pairs(feats.shape[1], self_interaction)
    zflat = z[:, ii, jj]
    return jnp.concatenate([dense_out, zflat], axis=1)


def cat_interaction(dense_out: jax.Array | None, emb_out: jax.Array) -> jax.Array:
    """"cat" interaction: flatten pooled embeddings, prepend dense features."""
    B = emb_out.shape[0]
    flat = emb_out.reshape(B, -1)
    if dense_out is None:
        return flat
    return jnp.concatenate([dense_out, flat], axis=1)
