import numpy as np
import pytest

from deeprecsys_tpu.config import (ModelConfig, ServingConfig,
                                   model_config_from_dict,
                                   _expand_din_tables)
from deeprecsys_tpu import zoo


def test_zoo_has_eight_models():
    assert set(zoo.MODEL_NAMES) == {"rm1", "rm2", "rm3", "wnd", "mtwnd", "ncf", "din", "dien"}
    for name in zoo.MODEL_NAMES:
        cfg = zoo.get_config(name, table_scale=1000)
        assert cfg.num_tables >= 1
        assert cfg.out_dim >= 1


def test_din_expansion():
    # Reference semantics (utils/utils.py:132-149): n extra copies are
    # prepended in front of the original behavior table -> n+1 behavior tables.
    rows = _expand_din_tables((10, 20, 30, 40), 5)
    assert rows == (10,) + (20,) * 6 + (30, 40)
    cfg = zoo.get_config("din")
    assert cfg.num_tables == 1 + 251 + 2
    assert len(list(cfg.behavior_table_ids)) == 251


def test_top_in_dims_match_reference_formulas():
    # DLRM cat: num_fea * m_den_out (dlrm_s_caffe2.py:426)
    rm1 = zoo.get_config("rm1")
    assert rm1.top_in_dim == (8 + 1) * 32
    # DLRM dot: pairs + bottom-out (dlrm_s_caffe2.py:418-422)
    dot = rm1.replace(interaction_op="dot")
    assert dot.top_in_dim == (9 * 8) // 2 + 32
    dot_self = dot.replace(interaction_itself=True)
    assert dot_self.top_in_dim == (9 * 10) // 2 + 32
    # WnD: num_tables*m + dense (wide_and_deep.py:345)
    wnd = zoo.get_config("wnd")
    assert wnd.top_in_dim == 27 * 32 + 512
    # NCF: 2m (ncf.py:384)
    assert zoo.get_config("ncf").top_in_dim == 128
    # DIN: 4m; DIEN: H + 3m (dien.py:426)
    assert zoo.get_config("din").top_in_dim == 4 * 32
    assert zoo.get_config("dien").top_in_dim == 64 + 3 * 32


def test_from_dict_reference_json_keys():
    raw = {
        "arch_mlp_bot": "128-64-32",
        "arch_mlp_top": "256-64-1",
        "arch_embedding_size": "100-200-300",
        "arch_sparse_feature_size": 32,
        "num_indices_per_lookup_fixed": True,
        "num_indices_per_lookup": 8,
        "arch_interaction_op": "cat",
        "model_type": "dlrm",
        "model_name": "tiny",
    }
    cfg = model_config_from_dict(raw)
    assert cfg.mlp_bot == (128, 64, 32)
    assert cfg.embedding_rows == (100, 200, 300)
    assert cfg.num_indices_per_lookup == 8
    np.testing.assert_array_equal(cfg.table_offsets, [0, 100, 300])
    assert cfg.total_rows == 600


def test_din_expansion_applies_after_json_merge():
    raw = {
        "arch_embedding_size": "1000-100-5000-5000",
        "arch_sparse_feature_size": 16,
        "arch_mlp_bot": "1",
        "arch_mlp_top": "8-2",
        "num_indices_per_lookup": 1,
        "arch_interaction_op": "cat",
        "model_type": "din",
        "model_name": "din",
        "user_behavior_tables": 3,
    }
    cfg = model_config_from_dict(raw)
    assert cfg.embedding_rows == (1000,) + (100,) * 4 + (5000, 5000)


def test_validation():
    with pytest.raises(ValueError):
        ModelConfig(model_type="nope")
    with pytest.raises(ValueError):
        ModelConfig(model_type="ncf", embedding_rows=(1, 2, 3))
    with pytest.raises(ValueError):
        ModelConfig(interaction_op="cross")
    with pytest.raises(ValueError, match="payload_arena_slots"):
        ServingConfig(payload_arena_slots=0)


def test_table_scale():
    cfg = zoo.get_config("rm1", table_scale=1000)
    assert cfg.scaled_rows == (4000,) * 8
    assert cfg.embedding_rows == (4_000_000,) * 8


def test_all_reference_config_files_load_and_run():
    """Migration promise: the reference's own shipped JSON configs work
    verbatim as --model inputs (/root/reference is read-only input data)."""
    import os

    import jax

    from deeprecsys_tpu.config import load_model_config
    from deeprecsys_tpu.data import RecDataGenerator
    from deeprecsys_tpu.models import get_model

    ref_dir = "/root/reference/models/configs"
    if not os.path.isdir(ref_dir):
        import pytest

        pytest.skip("reference checkout not present")
    for name in sorted(os.listdir(ref_dir)):
        # rm2's pooling factor (120) needs enough rows after scaling.
        scale = 1000 if "rm2" in name else 5000
        cfg = load_model_config(os.path.join(ref_dir, name), table_scale=scale)
        model = get_model(cfg)
        params = model.init(jax.random.PRNGKey(0))
        batch = RecDataGenerator(cfg, seed=1).generate_batch(4)
        out = model.apply(params, batch)
        assert out.shape == (4, cfg.out_dim), name


def test_resolved_table_pack_auto_rules():
    """table_pack=0 auto resolves to unpacked for every dtype and
    quantization (packing lost on an H100, PERF.md); explicit values
    pass through."""
    from deeprecsys_tpu import zoo

    rm1 = zoo.get_config("rm1", table_pack=0, param_dtype="bfloat16")
    assert rm1.sparse_feature_size == 32 and rm1.resolved_table_pack == 1
    assert zoo.get_config("rm1", table_pack=0).resolved_table_pack == 1  # f32
    rm2 = zoo.get_config("rm2", table_pack=0, param_dtype="bfloat16")
    assert rm2.sparse_feature_size == 64 and rm2.resolved_table_pack == 1
    assert zoo.get_config("rm1", table_pack=0,
                          table_quant="int8").resolved_table_pack == 1
    assert zoo.get_config("rm2", table_pack=0,
                          table_quant="int8").resolved_table_pack == 1
    assert zoo.get_config("rm1", table_pack=0,
                          table_quant="int8_rowwise").resolved_table_pack == 1
    assert zoo.get_config("rm2", table_pack=3).resolved_table_pack == 3


def test_zoo_din_override_sizes_expansion():
    """zoo.get_config must apply overrides BEFORE the DIN behavior-table
    expansion — the reference's ordering makes user_behavior_tables
    silently inert (SURVEY §5), and the JSON path here already fixed it;
    the zoo path must agree."""
    from deeprecsys_tpu import zoo

    small = zoo.get_config("din", user_behavior_tables=10)
    assert small.num_tables == 10 + 4  # profile + behaviors + ad + ctx
    assert small.user_behavior_tables == 10
    assert zoo.get_config("din").num_tables == 250 + 4  # default unchanged
