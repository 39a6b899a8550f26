"""The weight converter on the 3D-molecule models' trees: every key of an
`init_denoise_params` and an `init_pos_pred_params` tree (each problem
type) crosses to the port's state dict, which the port's model loads
strictly, and back to the same tree bit for bit; a key that the mapping
does not name raises instead of leaving a head at its random init."""

import jax
import numpy as np
import pytest

from graphgpt_tpu.config import ModelConfig as JConfig
from graphgpt_tpu.models import denoise as jden
from graphgpt_tpu.models import pos_pretrain as jpos
from graphgpt_torch.config import ModelConfig as TConfig
from graphgpt_torch.models.denoise import GraphGPTDenoise
from graphgpt_torch.models.pos_pretrain import GraphGPTPosPred
from graphgpt_torch.utils.convert import params_from_jax, params_to_jax

COMMON = dict(vocab_size=40, hidden_size=32, num_hidden_layers=2, head_dim=8,
              num_attention_heads=4, intermediate_size=64, stacked_feat=3, next_n_token=3,
              mask_token_id=1, dtype="float32", pos_num_bins=4, pos_num_bins_line=4,
              pos_num_bins_cube=3)
DENOISE = {
    "plain": dict(problem_type="regression", num_labels=1, stacked_feat_agg_method="gated"),
    "smtp3d-no-pos-type": dict(problem_type="regression", num_labels=1, smtp_3d=True,
                               smtp_vocab=8, add_pos_type=False, mlp=(16,)),
}
POS = {
    "line": {}, "line-gated": dict(pos_agg_method="gated"),
    "cube": dict(pos_problem_type="pos-smtp-cube"), "mix": dict(pos_problem_type="pos-smtp-mix"),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_same_tree(a, b, where=""):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_same_tree(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{where}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32),
                                      err_msg=where)


@pytest.mark.parametrize("case", sorted(DENOISE))
def test_denoise_tree_round_trips(case):
    kw = {**COMMON, **DENOISE[case]}
    tree = _np(jden.init_denoise_params(JConfig(**kw).finalize(), jax.random.PRNGKey(0)))
    sd = params_from_jax(tree, device="cpu")
    model = GraphGPTDenoise(TConfig(**kw).finalize(), device="cpu")
    model.load_state_dict(sd)  # strict: the same names and shapes
    _assert_same_tree(tree, params_to_jax(model.state_dict()))


@pytest.mark.parametrize("case", sorted(POS))
def test_pos_pred_tree_round_trips(case):
    kw = {**COMMON, **POS[case]}
    tree = _np(jpos.init_pos_pred_params(JConfig(**kw).finalize(), jax.random.PRNGKey(0)))
    sd = params_from_jax(tree, device="cpu")
    model = GraphGPTPosPred(TConfig(**kw).finalize(), device="cpu")
    model.load_state_dict(sd)
    _assert_same_tree(tree, params_to_jax(model.state_dict()))


@pytest.mark.parametrize("where", ["top", "layers", "denoise"])
def test_an_unmapped_key_raises(where):
    kw = {**COMMON, **DENOISE["plain"]}
    tree = _np(jden.init_denoise_params(JConfig(**kw).finalize(), jax.random.PRNGKey(0)))
    extra = np.zeros((2,), np.float32)
    if where == "top":
        tree["pos_head_nobody_maps"] = extra
    else:
        tree[where]["nobody_maps"] = extra
    with pytest.raises(KeyError, match="nobody_maps"):
        params_from_jax(tree, device="cpu")


def test_the_port_init_has_the_jax_init_distributions():
    """Biases of the force head start at 0 and the gated position-token
    aggregation uniform in +-1/sqrt(D), as the JAX init draws them."""
    den = GraphGPTDenoise(TConfig(**{**COMMON, **DENOISE["plain"]}).finalize(), device="cpu")
    assert float(den.denoise.force_b.abs().sum()) == 0.0
    assert 0 < float(den.denoise.force_w.std()) < 0.05
    pos = GraphGPTPosPred(TConfig(**{**COMMON, **POS["line-gated"]}).finalize(), device="cpu")
    bound = 1.0 / COMMON["hidden_size"] ** 0.5
    assert float(pos.pos_token_agg_w.abs().max()) <= bound
    assert float(pos.pos_token_agg_w.abs().max()) > 0.5 * bound
