"""Ragged (lengths + values) sparse-input ingestion.

The reference feeds SparseLengthsSum through per-table (lengths, indices)
queues (``dlrm_s_caffe2.py:179-211``), a CSR form that admits variable
pooling lengths — though its shipped configs all set
``num_indices_per_lookup_fixed: true`` and its random generator always
emits fixed-size groups (``dlrm_data_caffe2.py:100-113``), so variable
lengths are a format-compat corner, not a behavioral one.

This module converts that form into the framework's dense layout:
``(B, T, L)`` indices padded with 0 plus a ``(B, T, L)`` bool mask, which
``models.base.pooled_lookup`` threads into every bag variant (masked
slots contribute zero to the pooled sum — exact SparseLengthsSum
semantics for any group length, including empty groups).
"""

from __future__ import annotations

import numpy as np


def _exact_int64(arr: np.ndarray, what: str) -> np.ndarray:
    """Cast to int64, REJECTING non-integral floats: JSON serializers
    commonly emit ids/lengths as floats (1.0 is fine), but a silent
    1.9 -> 1 truncation would serve scores for the WRONG embedding rows
    (the same never-truncate rule ingress.predict applies to padded
    indices — this keeps the CSR path equally strict)."""
    arr = np.asarray(arr)
    if arr.dtype.kind == "f":
        as_int = arr.astype(np.int64)
        if not np.array_equal(as_int, arr):
            raise ValueError(
                f"{what} must be integral; got non-integer float values "
                f"(refusing to truncate)")
        return as_int
    return arr.astype(np.int64)


def lengths_to_mask(lengths: np.ndarray, max_len: int) -> np.ndarray:
    """(B, T) group lengths -> (B, T, L) bool slot mask."""
    lengths = _exact_int64(lengths, "lengths")
    if lengths.ndim != 2:
        raise ValueError(f"lengths must be (B, T); got shape {lengths.shape}")
    if (lengths < 0).any() or (lengths > max_len).any():
        raise ValueError(
            f"each group length must satisfy 0 <= len <= {max_len} "
            f"(the model's num_indices_per_lookup)")
    return np.arange(max_len)[None, None, :] < lengths[:, :, None]


def pad_csr(lengths: np.ndarray, values: np.ndarray, max_len: int):
    """Reference CSR -> (indices (B, T, L) int32 padded with 0,
    mask (B, T, L) bool).

    ``lengths``: (B, T) per-group counts; ``values``: flat concatenation
    of all groups' ids in row-major (b, t) order — exactly the reference's
    lengths/indices queue contents for one batch, fused across tables.
    """
    lengths = _exact_int64(lengths, "lengths")
    values = _exact_int64(values, "values").reshape(-1)
    mask = lengths_to_mask(lengths, max_len)
    if int(lengths.sum()) != values.size:
        raise ValueError(
            f"values has {values.size} ids but lengths sum to "
            f"{int(lengths.sum())}")
    B, T = lengths.shape
    idx = np.zeros((B, T, max_len), dtype=np.int64)
    idx[mask] = values
    return idx, mask
