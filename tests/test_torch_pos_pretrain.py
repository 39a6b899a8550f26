"""The port's 3D-position pretraining model (`GraphGPTPosPred`) against the
JAX package's `pos_pred_forward`, on the CPU.

A tiny model (hidden 64, 2 layers, 2 heads of 32, 13 stacked features and
next-13 2D SMTP) in fp32 on rows of `mol3d_batch` (four molecules, one
without coordinates), the JAX init's weights carried across by
`params_from_jax`, and the JAX package's own random draws handed to the
port (`draws=`; the JAX function draws the 2D mask ratio and the per-cell
2D draws from one key, `r_2d`, and the test hands over both). Loss, the 3D
CE (`gen_loss`), the 2D CE (`pretrain_loss`) and EVERY gradient leaf, by
name, on the XLA path (and the interpreted Pallas path for line and mix):
line tokens with sum and gated aggregation, cube tokens with the tied
head, mix; batch-carried percentile boundaries; the tokenizer-masked
labels of `pretrain-mlm-coord`; `loss_agg` token-lvl and sample-lvl; the
arccos and cosine schedules with one mask a node; train and eval.

Tolerances as tests/test_torch_denoise.py: losses to 1e-5, each gradient
to 2e-4 in the relative Frobenius norm and elementwise to 1e-6 + 1e-3 * |g|.
"""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from graphgpt_tpu.config import ModelConfig as JConfig
from graphgpt_tpu.models import pos_pretrain as jpos
from graphgpt_torch.config import ModelConfig as TConfig
from graphgpt_torch.data import mol3d as tmol3d
from graphgpt_torch.models.pos_pretrain import GraphGPTPosPred
from graphgpt_torch.synthetic import mol3d_batch, mol3d_tokenizer, to_torch
from graphgpt_torch.utils.convert import params_from_jax, tree_from_jax

COMMON = dict(
    vocab_size=755, hidden_size=64, num_hidden_layers=2, head_dim=32, num_attention_heads=2,
    intermediate_size=128, stacked_feat=13, next_n_token=13, mask_token_id=1,
    dtype="float32", task_type="pretrain-coord", pos_num_bins=16, pos_num_bins_line=16,
    pos_num_bins_cube=8,
)
JAX_PATHS = {"xla": dict(attn_impl="xla", mlp_kernel="off"),
             "pallas": dict(attn_impl="pallas", mlp_kernel="on")}
CASES = {
    "line": ({}, False),
    "line-gated": (dict(pos_agg_method="gated"), False),
    "line-bounds": ({}, True),
    "line-sample-lvl": (dict(loss_agg="sample-lvl"), False),
    "line-arccos-node": (dict(smtp_3d_power=-2.0, coord_lvl_mask=False), False),
    "cube": (dict(pos_problem_type="pos-smtp-cube"), False),
    "cube-cosine-sample-lvl": (dict(pos_problem_type="pos-smtp-cube", smtp_3d_power=-1.0,
                                    loss_agg="sample-lvl"), False),
    "mix": (dict(pos_problem_type="pos-smtp-mix"), False),
    "mix-bounds": (dict(pos_problem_type="pos-smtp-mix", smtp_2d_rate=0.5), True),
    "mlm-coord": (dict(task_type="pretrain-mlm-coord"), False),
}
B, P = 4, 40
LOSS_TOL, REL, ATOL, RTOL = 1e-5, 2e-4, 1e-6, 1e-3


@functools.lru_cache(maxsize=None)
def _batch(case: str):
    kw, bounds = CASES[case]
    nb = mol3d_batch(B, P, seed=2, tokenizer=mol3d_tokenizer())
    nb["pos"][2] = 0.0  # a molecule without coordinates: a 2D-only sample
    if bounds:
        for n in (8, 16):
            nb[f"pos_boundaries_{n}"] = tmol3d.pos_percentile_boundaries(nb["pos"], n)
    if kw.get("task_type") == "pretrain-mlm-coord":
        # the tokenizer's masking: labels at masked cells, [mask] in the inputs
        rng = np.random.default_rng(4)
        ids = nb["input_ids"]
        hit = (rng.random(ids.shape) < 0.3) & (ids > 0)
        nb["labels"] = np.where(hit, ids, -100).astype(np.int32)
        nb["input_ids"] = np.where(hit, 1, ids).astype(np.int32)
    return nb


def jax_draws(key, b: int, p: int, f: int) -> dict:
    """The JAX package's draws of `pos_pred_forward` for `key` (:128-170),
    as the port's `pos_draws` names them; `t2` and `u2` share `r_2d`."""
    r_sep, r_2d, r_noise, r_mask, r_coord, _ = jax.random.split(key, 6)
    return {
        "sep": jax.random.uniform(r_sep, (b, 1, 1)),
        "t2": jax.random.uniform(r_2d, (b, 1, 1)),
        "u2": jax.random.uniform(r_2d, (b, p, f)),
        "noise": jax.random.normal(r_noise, (b, p, 3)),
        "mask_u": jax.random.uniform(r_mask, (b, 1, 1)),
        "coord_u": jax.random.uniform(r_coord, (b, p, 3)),
    }


def _cfgs(path: str, case: str):
    kw = {**COMMON, **CASES[case][0]}
    return JConfig(**{**kw, **JAX_PATHS[path]}).finalize(), TConfig(**kw).finalize()


@functools.lru_cache(maxsize=None)
def _jax_run(path: str, case: str, train: bool):
    jcfg, _ = _cfgs(path, case)
    os.environ["GGT_PALLAS_INTERPRET"] = "1"
    try:
        params = jpos.init_pos_pred_params(jcfg, jax.random.PRNGKey(0))
        rng = jax.random.PRNGKey(7) if train else None

        def loss_fn(p):
            out = jpos.pos_pred_forward(p, jcfg, _batch(case), rng=rng, train=train)
            out.pop("hidden_states")
            return out["loss"], out

        (_, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    finally:
        del os.environ["GGT_PALLAS_INTERPRET"]
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return to_np(params), to_np(out), to_np(grads)


@pytest.mark.parametrize("path,case,train", [
    *(("xla", c, True) for c in sorted(CASES)),
    ("pallas", "line", True), ("pallas", "mix", True),
    ("xla", "line", False), ("xla", "cube", False),
])
def test_pos_pred_forward_and_grads_match_jax(path, case, train):
    params, want, jgrads = _jax_run(path, case, train)
    _, tcfg = _cfgs(path, case)
    model = GraphGPTPosPred(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(params, device="cpu"))  # strict: every key
    key = jax.random.PRNGKey(7 if train else 0)  # eval: the JAX fallback key
    draws = {k: torch.from_numpy(np.array(v)) for k, v in jax_draws(key, B, P, 13).items()}
    got = model(to_torch(_batch(case), "cpu"), train=train, draws=draws)
    got["loss"].backward()
    assert set(got) - {"hidden_states"} == set(want)
    for k in want:
        assert got[k].item() == pytest.approx(float(want[k]), abs=LOSS_TOL), k
    jg = tree_from_jax(jgrads, device="cpu")
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(jg) == set(grads)
    for name, g in grads.items():
        w = jg[name].numpy()
        g = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL, err_msg=f"{case} {name}")
        if np.linalg.norm(w) > 0:
            assert np.linalg.norm(g - w) / np.linalg.norm(w) < REL, (case, name)


def test_r_2d_feeds_both_2d_draws():
    """`pos_pred_forward` draws the per-sample 2D mask ratio t2 [B, 1, 1] and
    the per-cell draws u2 [B, P, F] from one key (pos_pretrain.py:146-147).
    Under this JAX's threefry the B ratios are the first B cell draws, all
    in sample 0's first node: there a cell is masked where u2 > t2, so
    sample 0's first cell (u2 == t2[0]) is never masked, and its next B - 1
    cells compare the other samples' ratios with sample 0's. The port draws
    the two independently from its generator; the parity tests above hand
    it JAX's pair, so it reproduces this when given it."""
    r_2d = jax.random.split(jax.random.PRNGKey(7), 6)[1]
    t2 = np.asarray(jax.random.uniform(r_2d, (B, 1, 1))).ravel()
    u2 = np.asarray(jax.random.uniform(r_2d, (B, P, 13)))
    np.testing.assert_array_equal(t2, u2.ravel()[:B])
    assert not u2[0, 0, 0] > t2[0]

