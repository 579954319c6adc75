import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeprecsys_tpu.ops import (
    embedding_bag,
    init_fused_tables,
    mlp_init,
    mlp_apply,
    dot_interaction,
    cat_interaction,
    basic_rnn_init,
    basic_rnn_scan,
)


def test_embedding_bag_matches_naive():
    rng = np.random.default_rng(0)
    table_rows = [50, 30, 20]
    d, B, L = 8, 4, 3
    table = rng.normal(size=(100, d)).astype(np.float32)
    offsets = np.array([0, 50, 80], dtype=np.int32)
    indices = np.stack(
        [np.stack([rng.integers(0, n, size=L) for n in table_rows]) for _ in range(B)]
    ).astype(np.int32)
    out = embedding_bag(jnp.asarray(table), jnp.asarray(offsets), jnp.asarray(indices))
    # Naive per-table SparseLengthsSum semantics.
    expected = np.zeros((B, 3, d), dtype=np.float32)
    for b in range(B):
        for t in range(3):
            for l in range(L):
                expected[b, t] += table[offsets[t] + indices[b, t, l]]
    np.testing.assert_allclose(np.asarray(out), expected, rtol=1e-6)


@pytest.mark.parametrize("pack,rows_total", [(2, 100), (4, 100), (4, 101)])
def test_embedding_bag_packed_matches_unpacked(pack, rows_total):
    """pack_table/embedding_bag_packed: bit-identical to embedding_bag at
    f32 (the one-hot select is exact), including tail-padded row counts."""
    from deeprecsys_tpu.ops import embedding_bag_packed, pack_table, unpack_table

    rng = np.random.default_rng(1)
    d, B, L = 8, 4, 3
    table = jnp.asarray(rng.normal(size=(rows_total, d)).astype(np.float32))
    offsets = jnp.asarray(np.array([0, 50, 80], dtype=np.int32))
    table_rows = [50, 30, rows_total - 80]
    indices = jnp.asarray(np.stack(
        [np.stack([rng.integers(0, n, size=L) for n in table_rows]) for _ in range(B)]
    ).astype(np.int32))
    packed = pack_table(table, pack)
    assert packed.shape == (-(-rows_total // pack), pack * d)
    np.testing.assert_array_equal(
        np.asarray(unpack_table(packed, pack, rows_total)), np.asarray(table))
    got = embedding_bag_packed(packed, offsets, indices, pack=pack)
    want = embedding_bag(table, offsets, indices)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_init_fused_tables_scale_per_table():
    key = jax.random.PRNGKey(0)
    rows = [10, 1000]
    t = np.asarray(init_fused_tables(key, rows, 16))
    assert t.shape == (1010, 16)
    # Each table's values bounded by sqrt(1/n) (reference init dist).
    assert np.abs(t[:10]).max() <= np.sqrt(1 / 10) + 1e-6
    assert np.abs(t[10:]).max() <= np.sqrt(1 / 1000) + 1e-6
    # And the bigger table is genuinely tighter.
    assert np.abs(t[10:]).max() < np.abs(t[:10]).max()


def test_mlp_shapes_and_sigmoid():
    key = jax.random.PRNGKey(1)
    params = mlp_init(key, (12, 8, 4))
    x = jax.random.normal(jax.random.PRNGKey(2), (5, 12))
    y_relu = mlp_apply(params, x)
    assert y_relu.shape == (5, 4)
    assert np.all(np.asarray(y_relu) >= 0)
    y_sig = mlp_apply(params, x, sigmoid_layer=2)
    assert np.all((np.asarray(y_sig) > 0) & (np.asarray(y_sig) < 1))
    # Sigmoid only at the chosen layer: layer-1 output still ReLU.
    np.testing.assert_allclose(np.asarray(y_relu)[0, 0], np.asarray(mlp_apply(params, x))[0, 0])


def test_dot_interaction_matches_naive():
    rng = np.random.default_rng(3)
    B, T, d = 3, 4, 8
    dense = rng.normal(size=(B, d)).astype(np.float32)
    emb = rng.normal(size=(B, T, d)).astype(np.float32)
    out = np.asarray(dot_interaction(jnp.asarray(dense), jnp.asarray(emb)))
    F = T + 1
    feats = np.concatenate([dense[:, None], emb], axis=1)
    z = np.einsum("bfd,bgd->bfg", feats, feats)
    pairs = [(i, j) for i in range(F) for j in range(i)]
    expected = np.concatenate([dense, np.stack([z[:, i, j] for i, j in pairs], axis=1)], axis=1)
    assert out.shape == (B, d + F * (F - 1) // 2)
    np.testing.assert_allclose(out, expected, rtol=1e-5)


def test_dot_interaction_itself_includes_diag():
    B, T, d = 2, 2, 4
    dense = np.ones((B, d), dtype=np.float32)
    emb = np.ones((B, T, d), dtype=np.float32)
    out = dot_interaction(jnp.asarray(dense), jnp.asarray(emb), self_interaction=True)
    F = T + 1
    assert out.shape == (B, d + F * (F + 1) // 2)


def test_cat_interaction():
    dense = jnp.ones((2, 3))
    emb = jnp.arange(2 * 4 * 5, dtype=jnp.float32).reshape(2, 4, 5)
    out = cat_interaction(dense, emb)
    assert out.shape == (2, 3 + 20)
    np.testing.assert_allclose(np.asarray(out[:, :3]), 1.0)
    out2 = cat_interaction(None, emb)
    assert out2.shape == (2, 20)


def test_dedup_lookup_matches_direct():
    from deeprecsys_tpu.ops.embedding import dedup_indices, embedding_bag_dedup

    rng = np.random.default_rng(7)
    table_rows = [50, 30]
    table = jnp.asarray(rng.normal(size=(80, 8)).astype(np.float32))
    offsets = np.array([0, 50], dtype=np.int32)
    # Zipf-ish duplicates: draw from a small hot set
    idx = rng.integers(0, 10, size=(6, 2, 4)).astype(np.int32)
    direct = embedding_bag(table, jnp.asarray(offsets), jnp.asarray(idx))
    uniq, inv, n = dedup_indices(idx, offsets)
    assert n <= 20  # heavy duplication
    assert uniq.shape[0] == 1 << (n - 1).bit_length()  # padded to a bucket
    got = embedding_bag_dedup(table, jnp.asarray(uniq), jnp.asarray(inv))
    np.testing.assert_allclose(np.asarray(got), np.asarray(direct), rtol=1e-6)


def test_dedup_bucket_ladder():
    from deeprecsys_tpu.ops.embedding import dedup_indices

    idx = np.arange(12, dtype=np.int32).reshape(3, 1, 4) % 7
    uniq, inv, n = dedup_indices(idx, np.zeros(1, np.int32), bucket_sizes=[4, 16, 64])
    assert n == 7 and uniq.shape[0] == 16


def test_hotcold_split_matches_direct():
    from deeprecsys_tpu.ops.embedding import split_hot_cold, embedding_bag_hotcold

    rng = np.random.default_rng(11)
    table = jnp.asarray(rng.normal(size=(200, 8)).astype(np.float32))
    offsets = np.array([0, 120], dtype=np.int32)
    # Zipf-ish: most lookups in the hot head [0, 16)
    hot_head = rng.integers(0, 16, size=(8, 2, 5))
    tail = rng.integers(0, [[120], [80]], size=(8, 2, 5))
    use_hot = rng.random((8, 2, 5)) < 0.8
    idx = np.where(use_hot, hot_head, tail).astype(np.int32)
    direct = embedding_bag(table, jnp.asarray(offsets), jnp.asarray(idx))

    # Hot set: fused ids of the head of each table.
    hot_ids = np.sort(np.concatenate([np.arange(16), 120 + np.arange(16)])).astype(np.int64)
    split = split_hot_cold(idx, offsets, hot_ids)
    assert split["n_cold"] < idx.size  # most lookups hit the hot set
    hot_table = jnp.take(table, jnp.asarray(hot_ids, dtype=jnp.int32), axis=0)
    got = embedding_bag_hotcold(hot_table, table, {
        **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in split.items()},
    })
    np.testing.assert_allclose(np.asarray(got), np.asarray(direct), rtol=1e-5, atol=1e-6)


def test_hotcold_all_cold_and_all_hot_edges():
    from deeprecsys_tpu.ops.embedding import split_hot_cold, embedding_bag_hotcold

    rng = np.random.default_rng(12)
    table = jnp.asarray(rng.normal(size=(40, 4)).astype(np.float32))
    offsets = np.zeros(1, np.int32)
    idx = rng.integers(20, 40, size=(3, 1, 2)).astype(np.int32)  # all cold
    hot_ids = np.arange(10, dtype=np.int64)
    split = split_hot_cold(idx, offsets, hot_ids)
    assert split["n_cold"] == idx.size
    hot_table = table[:10]
    got = embedding_bag_hotcold(hot_table, table,
                                {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                                 for k, v in split.items()})
    direct = embedding_bag(table, jnp.asarray(offsets), jnp.asarray(idx))
    np.testing.assert_allclose(np.asarray(got), np.asarray(direct), rtol=1e-5)

    idx2 = rng.integers(0, 10, size=(3, 1, 2)).astype(np.int32)  # all hot
    split2 = split_hot_cold(idx2, offsets, hot_ids)
    assert split2["n_cold"] == 0
    got2 = embedding_bag_hotcold(hot_table, table,
                                 {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                                  for k, v in split2.items()})
    direct2 = embedding_bag(table, jnp.asarray(offsets), jnp.asarray(idx2))
    np.testing.assert_allclose(np.asarray(got2), np.asarray(direct2), rtol=1e-5)


@pytest.mark.parametrize("pack", [2, 4])
def test_hotcold_packed_matches_unpacked(pack):
    """Packed cold table composes with the hot/cold split: same result as
    the unpacked hotcold bag and the direct lookup (f32 reassociation
    tolerance only)."""
    from deeprecsys_tpu.ops.embedding import (
        embedding_bag_hotcold,
        pack_table,
        split_hot_cold,
    )

    rng = np.random.default_rng(21)
    table = jnp.asarray(rng.normal(size=(200, 8)).astype(np.float32))
    offsets = np.array([0, 120], dtype=np.int32)
    idx = rng.integers(0, [[120], [80]], size=(6, 2, 5)).astype(np.int32)
    hot_ids = np.sort(rng.choice(200, size=24, replace=False)).astype(np.int64)
    split = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
             for k, v in split_hot_cold(idx, offsets, hot_ids).items()}
    hot_table = jnp.take(table, jnp.asarray(hot_ids, dtype=jnp.int32), axis=0)
    direct = embedding_bag(table, jnp.asarray(offsets), jnp.asarray(idx))
    unpacked = embedding_bag_hotcold(hot_table, table, split)
    got = embedding_bag_hotcold(hot_table, pack_table(table, pack), split,
                                pack=pack)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(unpacked))
    np.testing.assert_allclose(np.asarray(got), np.asarray(direct),
                               rtol=1e-5, atol=1e-6)


def test_hotcold_packed_int8_matches_unpacked():
    """Per-table int8 packed cold table: the int8 x one-hot select and
    int32 pooling are exact, so packed == unpacked bit-for-bit."""
    from deeprecsys_tpu.ops.embedding import (
        embedding_bag_hotcold_int8,
        pack_table,
        select_packed_rows,
        split_hot_cold,
    )

    rng = np.random.default_rng(22)
    q = jnp.asarray(rng.integers(-127, 128, size=(200, 8)).astype(np.int8))
    scale = jnp.asarray(rng.uniform(0.01, 0.1, size=2).astype(np.float32))
    offsets = np.array([0, 120], dtype=np.int32)
    idx = rng.integers(0, [[120], [80]], size=(6, 2, 5)).astype(np.int32)
    hot_ids = np.sort(rng.choice(200, size=24, replace=False)).astype(np.int64)
    split = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
             for k, v in split_hot_cold(idx, offsets, hot_ids).items()}
    hid = jnp.asarray(hot_ids, dtype=jnp.int32)
    hot_q = jnp.take(q, hid, axis=0)
    q_packed = pack_table(q, 2)
    # Hot-table materialization from the packed layout is exact int8.
    np.testing.assert_array_equal(
        np.asarray(select_packed_rows(q_packed, hid, 2).astype(jnp.int8)),
        np.asarray(hot_q))
    want = embedding_bag_hotcold_int8(hot_q, q, scale, split)
    got = embedding_bag_hotcold_int8(hot_q, q_packed, scale, split, pack=2)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_basic_rnn_matches_loop():
    key = jax.random.PRNGKey(4)
    T, B, In, H = 5, 3, 6, 7
    params = basic_rnn_init(key, In, H)
    xs = jax.random.normal(jax.random.PRNGKey(5), (T, B, In))
    all_h, last = basic_rnn_scan(params, xs)
    assert all_h.shape == (T, B, H)
    # Naive loop.
    p = {k: np.asarray(v) for k, v in params.items()}
    h = np.zeros((B, H), dtype=np.float32)
    for t in range(T):
        h = np.tanh(np.asarray(xs[t]) @ p["i2h_w"] + p["i2h_b"] + h @ p["h2h_w"] + p["h2h_b"])
    np.testing.assert_allclose(np.asarray(last), h, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(all_h[-1]), h, rtol=1e-5, atol=1e-6)


def test_embedding_bag_packed_int8_default_dtype_no_wraparound():
    """embedding_bag_packed on an int8 table with compute_dtype=None must
    pool in (at least) int32 — pooling L narrow ints wraps mod 256 and
    silently corrupts every bag."""
    from deeprecsys_tpu.ops import embedding_bag_packed, pack_table

    rng = np.random.default_rng(2)
    rows, d, B, L, pack = 64, 8, 4, 40, 2
    q = jnp.asarray(rng.integers(-127, 128, size=(rows, d)).astype(np.int8))
    offsets = jnp.asarray(np.array([0], dtype=np.int32))
    indices = jnp.asarray(rng.integers(0, rows, size=(B, 1, L)).astype(np.int32))
    got = embedding_bag_packed(pack_table(q, pack), offsets, indices, pack=pack)
    want = np.asarray(q, dtype=np.int64)[np.asarray(indices).reshape(-1)] \
        .reshape(B, 1, L, d).sum(axis=2)
    assert np.asarray(got).dtype == np.int32
    np.testing.assert_array_equal(np.asarray(got, dtype=np.int64), want)


@pytest.mark.parametrize("layout", ["float", "packed", "int8", "q_packed",
                                    "int8_rowwise"])
def test_masked_pooling_matches_truncated_sum(layout):
    """Ragged pooling: every bag variant with a (B, T, L)
    slot mask equals the per-group truncated sum — exact
    SparseLengthsSum-with-variable-lengths semantics, including empty
    groups (zero vector)."""
    import numpy as np

    from deeprecsys_tpu.models.base import Batch, pooled_lookup
    from deeprecsys_tpu.config import ModelConfig
    from deeprecsys_tpu.models import get_model

    quant = {"int8": "int8", "q_packed": "int8",
             "int8_rowwise": "int8_rowwise"}.get(layout, "none")
    pack = 2 if layout in ("packed", "q_packed") else 1
    cfg = ModelConfig(model_type="dlrm", model_name="m",
                      mlp_bot=(4, 8), mlp_top=(8, 1),
                      embedding_rows=(64, 32), sparse_feature_size=8,
                      num_indices_per_lookup=5, interaction_op="cat",
                      table_quant=quant, table_pack=pack,
                      compute_dtype="float32", param_dtype="float32")
    model = get_model(cfg)
    params = model.init(jax.random.PRNGKey(3))
    rng = np.random.default_rng(0)
    B, T, L = 6, 2, 5
    idx = rng.integers(0, np.asarray(cfg.scaled_rows)[None, :, None],
                       size=(B, T, L)).astype(np.int32)
    lengths = rng.integers(0, L + 1, size=(B, T))  # includes empty groups
    mask = np.arange(L)[None, None, :] < lengths[:, :, None]

    masked = np.asarray(pooled_lookup(
        params["tables"], Batch(dense=None, indices=jnp.asarray(idx),
                                mask=jnp.asarray(mask)), cfg),
        dtype=np.float32)
    # Truth: pool each group over only its first `len` slots, through the
    # SAME unmasked bag (so quantization effects cancel exactly).
    want = np.zeros_like(masked)
    for b in range(B):
        for t in range(T):
            n = int(lengths[b, t])
            for l in range(n):
                one = idx[b:b + 1].copy()
                one[0, :, :] = idx[b, :, l:l + 1]  # broadcast slot l
                full = np.asarray(pooled_lookup(
                    params["tables"],
                    Batch(dense=None, indices=jnp.asarray(one)), cfg),
                    dtype=np.float32)
                want[b, t] += full[0, t] / L  # full pools L copies of slot l
    np.testing.assert_allclose(masked, want, rtol=1e-4, atol=1e-5)


def test_pad_csr_roundtrip():
    """data/ragged.py: the reference's lengths+values CSR form converts
    to padded indices + mask and back."""
    import numpy as np

    from deeprecsys_tpu.data.ragged import lengths_to_mask, pad_csr

    lengths = np.array([[2, 0], [1, 3]])
    values = np.array([7, 8, 5, 1, 2, 3])
    idx, mask = pad_csr(lengths, values, max_len=3)
    assert idx.shape == (2, 2, 3) and mask.shape == (2, 2, 3)
    np.testing.assert_array_equal(idx[0, 0, :2], [7, 8])
    assert not mask[0, 1].any()
    np.testing.assert_array_equal(idx[1, 1], [1, 2, 3])
    np.testing.assert_array_equal(idx[mask], values)
    np.testing.assert_array_equal(mask, lengths_to_mask(lengths, 3))
    with pytest.raises(ValueError, match="lengths sum"):
        pad_csr(lengths, values[:-1], max_len=3)
    with pytest.raises(ValueError, match="0 <= len"):
        pad_csr(np.array([[4]]), np.arange(4), max_len=3)
    # Never-truncate: JSON clients send float ids; 1.9 -> 1 would
    # silently serve scores for the WRONG rows (same rule as the padded
    # path's ingress check). Exact floats (1.0) stay accepted.
    with pytest.raises(ValueError, match="refusing to truncate"):
        pad_csr(lengths, values.astype(float) + 0.9, max_len=3)
    with pytest.raises(ValueError, match="refusing to truncate"):
        lengths_to_mask(np.array([[1.5, 0.0]]), 3)
    idx_f, mask_f = pad_csr(lengths.astype(float), values.astype(float),
                            max_len=3)
    np.testing.assert_array_equal(idx_f, idx)
    np.testing.assert_array_equal(mask_f, mask)


def test_split_hot_cold_masked_semantics_and_native_parity():
    """Ragged x hotcold: the host splitter with a slot
    mask — an invalid slot is neither a hot hit (the hot-side mask-pool
    zeros it) nor a cold descriptor (no wasted HBM gather). The native
    C++ splitter (drs_split_hot_cold_masked) must agree with the numpy
    path bit-for-bit, and the sharded/hybrid partitioned splits must
    conserve the masked cold count."""
    from deeprecsys_tpu.ops.embedding import (
        split_hot_cold,
        split_hot_cold_hybrid,
        split_hot_cold_sharded,
    )
    from deeprecsys_tpu.runtime.native import native_available

    rng = np.random.default_rng(0)
    B, T, L = 16, 4, 6
    offsets = np.arange(T, dtype=np.int64) * 100
    idx = rng.integers(0, 100, size=(B, T, L)).astype(np.int32)
    hot = np.sort(rng.choice(400, 50, replace=False)).astype(np.int64)
    mask = rng.random((B, T, L)) < 0.7

    s = split_hot_cold(idx, offsets, hot, impl="numpy", slot_mask=mask)
    flat = (idx.astype(np.int64) + offsets[None, :, None]).reshape(-1)
    valid = mask.reshape(-1)
    in_hot = np.isin(flat, hot)
    np.testing.assert_array_equal(
        np.asarray(s["hot_mask"]).reshape(-1).astype(bool), in_hot & valid)
    assert s["n_cold"] == int((~in_hot & valid).sum())
    # Compacted stream carries exactly the VALID cold lookups, in order.
    cold_pos = np.flatnonzero(~in_hot & valid)
    np.testing.assert_array_equal(
        np.asarray(s["cold_ids"])[: s["n_cold"]], flat[cold_pos])

    if native_available():
        nat = split_hot_cold(idx, offsets, hot, impl="native", slot_mask=mask)
        for k in s:
            np.testing.assert_array_equal(np.asarray(s[k]), np.asarray(nat[k]))

    sh = split_hot_cold_sharded(idx, offsets, hot, 4, 100, slot_mask=mask)
    hy = split_hot_cold_hybrid(idx, offsets, hot, 2, 4, 100, slot_mask=mask)
    assert sh["n_cold"] == s["n_cold"] == hy["n_cold"]


def test_split_hot_cold_hash_index_parity():
    """The persistent HotIndex (native open-addressing probe replacing
    the per-lookup binary search) must be bit-identical to both the
    binary-search native path and the numpy oracle — masked and
    unmasked, plus the K=0 / K=1 / duplicate-heavy edges. Serving
    builds it once per hot-set install (models/hotcold.py)."""
    import pytest

    from deeprecsys_tpu.ops.embedding import split_hot_cold
    from deeprecsys_tpu.runtime.native import native_available

    if not native_available():
        pytest.skip("native runtime unavailable")
    from deeprecsys_tpu.runtime.native import HotIndex

    rng = np.random.default_rng(7)
    B, T, L = 24, 5, 7
    offsets = np.arange(T, dtype=np.int64) * 1000
    # Skewed stream: heavy duplicates (the zipf serving shape).
    idx = (rng.zipf(1.5, size=(B, T, L)) % 1000).astype(np.int32)
    hot = np.sort(rng.choice(T * 1000, 300, replace=False)).astype(np.int64)
    hi = HotIndex(hot)
    mask = rng.random((B, T, L)) < 0.8
    for sm in (None, mask):
        ref = split_hot_cold(idx, offsets, hot, impl="numpy", slot_mask=sm)
        bin_ = split_hot_cold(idx, offsets, hot, impl="native", slot_mask=sm)
        hsh = split_hot_cold(idx, offsets, hot, impl="native", slot_mask=sm,
                             hot_index=hi)
        for k in ref:
            np.testing.assert_array_equal(np.asarray(ref[k]), np.asarray(bin_[k]))
            np.testing.assert_array_equal(np.asarray(ref[k]), np.asarray(hsh[k]))

    # K=0: everything valid goes cold; the empty index degrades cleanly.
    empty = np.empty(0, np.int64)
    e = split_hot_cold(idx, offsets, empty, impl="native",
                       hot_index=HotIndex(empty))
    assert e["n_cold"] == B * T * L
    # K=1: exactly the rows matching the single hot id are hot.
    one = np.array([int(idx[0, 0, 0])], dtype=np.int64)  # table 0 fused id
    o_h = split_hot_cold(idx, offsets, one, impl="native", hot_index=HotIndex(one))
    o_n = split_hot_cold(idx, offsets, one, impl="numpy")
    np.testing.assert_array_equal(np.asarray(o_n["hot_mask"]),
                                  np.asarray(o_h["hot_mask"]))
    # A stale index (size mismatch vs hot_ids) fails loudly, not wrongly.
    with pytest.raises(ValueError, match="stale index"):
        split_hot_cold(idx, offsets, hot[:100], impl="native", hot_index=hi)


def test_select_hot_ids_and_coverage_masked():
    """Ragged refresh scans: padded slots are excluded from hot-set
    selection (their index-0 filler would otherwise count as the hottest
    row of every table) and from coverage (non-lookups are not misses)."""
    from deeprecsys_tpu.ops.embedding import hot_coverage_of, select_hot_ids

    T, L = 1, 4
    offsets = np.zeros(T, dtype=np.int64)
    # Valid slots all hit row 7; padding is the row-0 filler.
    idx = np.zeros((8, T, L), dtype=np.int32)
    idx[:, :, 0] = 7
    mask = np.zeros((8, T, L), dtype=bool)
    mask[:, :, 0] = True
    assert list(select_hot_ids(idx, offsets, 1, mask=mask)) == [7]
    assert list(select_hot_ids(idx, offsets, 1)) == [0]  # unmasked: filler wins
    assert hot_coverage_of(idx, offsets, np.array([7]), mask=mask) == 1.0
    assert hot_coverage_of(idx, offsets, np.array([7])) == pytest.approx(0.25)
    # All-padded stream: no lookups -> coverage 0, not a div-by-zero.
    assert hot_coverage_of(idx, offsets, np.array([7]),
                           mask=np.zeros_like(mask)) == 0.0


@pytest.mark.parametrize("layout", ["float", "packed", "int8", "q_packed",
                                    "int8_rowwise"])
def test_masked_hotcold_matches_masked_direct(layout):
    """Ragged x hotcold end-to-end across every table layout: the hotcold
    apply on a masked-split batch (mask consumed on the HOST, device
    program mask-free) equals the model's own masked direct forward."""
    from deeprecsys_tpu.config import ModelConfig
    from deeprecsys_tpu.models import get_model
    from deeprecsys_tpu.models.base import Batch
    from deeprecsys_tpu.models.hotcold import make_hotcold_model
    from deeprecsys_tpu.ops.embedding import select_hot_ids

    quant = {"int8": "int8", "q_packed": "int8",
             "int8_rowwise": "int8_rowwise"}.get(layout, "none")
    pack = 2 if layout in ("packed", "q_packed") else 1
    rng = np.random.default_rng(7)
    B, T, L = 8, 2, 5
    cfg = ModelConfig(model_type="dlrm", model_name="m",
                      mlp_bot=(4, 8), mlp_top=(8, 1),
                      embedding_rows=(64, 32), sparse_feature_size=8,
                      num_indices_per_lookup=L, interaction_op="cat",
                      table_quant=quant, table_pack=pack,
                      compute_dtype="float32", param_dtype="float32")
    model = get_model(cfg)
    params = model.init(jax.random.PRNGKey(3))
    idx = rng.integers(0, np.asarray(cfg.scaled_rows)[None, :, None],
                       size=(B, T, L)).astype(np.int32)
    dense = rng.normal(size=(B, cfg.dense_dim)).astype(np.float32)
    lengths = rng.integers(0, L + 1, size=(B, T))  # includes empty groups
    mask = np.arange(L)[None, None, :] < lengths[:, :, None]
    batch = Batch(dense=jnp.asarray(dense), indices=jnp.asarray(idx),
                  mask=jnp.asarray(mask))
    direct = np.asarray(model.apply(params, batch), dtype=np.float32)

    offs = np.asarray(cfg.table_offsets)
    sample = rng.integers(0, np.asarray(cfg.scaled_rows)[None, :, None],
                          size=(64, T, L)).astype(np.int32)
    hot = select_hot_ids(np.concatenate([sample, idx]), offs, 30)
    hc = make_hotcold_model(model, hot)
    split = hc.prepare(batch)  # consumes batch.mask
    got = np.asarray(hc.apply(hc.convert_params(params),
                              batch._replace(mask=None), split),
                     dtype=np.float32)
    np.testing.assert_allclose(got, direct, rtol=1e-4, atol=1e-5)
