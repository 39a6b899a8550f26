"""The two fp32 training paths that reach #11, #4 and #5, against the JAX
package on the CPU, on the JAX package's own draws.

1. A fine-tune step of `GraphGPTTask` (graph regression, L1, gated
   aggregation) with LayerScale, DropPath and attention dropout under pairs
   remat: every layer takes the split MLP (#11, `_mlp_kernel` :82) and its
   recompute. The JAX side draws its dropout and DropPath masks from the
   step's key (`backbone_apply`: fold_in(r_body, layer), split in four); the
   test draws the same masks from the same keys and hands each to the
   port's layer in place of its generator's, so that both sides drop the
   same entries and rows.
2. A denoise step of `GraphGPTDenoise` with a 16-slot bi-causal split at
   the card's head width 64, P 88 and pairs remat: the backward takes the
   split pair (#4 `_dq_kernel_single` :602, #5 `_dkv_kernel_single` :789);
   the port is handed JAX's noise, mode, schedule and node draws
   (`denoise_draws`). `tests/test_torch_denoise.py` holds the same model at
   head width 32 without remat.

Both models are fp32 (two layers, hidden 128, two heads of 64); the JAX
side runs its Pallas path in the interpreter (GGT_PALLAS_INTERPRET=1,
attn_impl="pallas", mlp_kernel="on"), the port its wrappers' plain
versions (CPU tensors), which the card's fp32 forms are held to. Loss and
EVERY gradient leaf by parameter name: the loss to 1e-5 (relative), each
gradient to 2e-4 in the relative Frobenius norm and elementwise to
1e-6 + 1e-3 * |g|: fp32 sums in another order through two layers and the
heads.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphgpt_tpu.config import ModelConfig as JConfig
from graphgpt_tpu.models import denoise as jden
from graphgpt_tpu.models import heads as jheads
from graphgpt_torch.config import ModelConfig as TConfig
from graphgpt_torch.models import denoise as tden
from graphgpt_torch.models import heads as theads
from graphgpt_torch.models import modeling as tmod
from graphgpt_torch.ops import flash_attention as tfa
from graphgpt_torch.ops import mlp as tmlp
from graphgpt_torch.synthetic import mol3d_batch, mol3d_tokenizer, to_torch
from graphgpt_torch.utils.convert import params_from_jax, tree_from_jax
from test_torch_denoise import _torch_draws, jax_draws

LOSS_REL, REL, ATOL, RTOL = 1e-5, 2e-4, 1e-6, 1e-3
JAX_PALLAS = dict(attn_impl="pallas", mlp_kernel="on")
FT = dict(vocab_size=50, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
          intermediate_size=512, stacked_feat=3, next_n_token=1, mask_token_id=1,
          dtype="float32", use_generative=False, task_type="graph", problem_type="regression",
          loss_type="l1", stacked_feat_agg_method="gated", remat=True, remat_policy="pairs",
          layer_scale_init_value=1.0, path_dropout=0.3, attention_dropout=0.2)
FT_B, FT_P, FT_LENGTHS = 4, 128, (128, 90, 61, 33)
STEP_KEY = jax.random.PRNGKey(11)


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ft_batch():
    """One graph a row at the front, as the task loader lays rows out."""
    rng = np.random.default_rng(4)
    seg = np.zeros((FT_B, FT_P), np.int32)
    for r, n in enumerate(FT_LENGTHS):
        seg[r, :n] = 1
    ids = np.where(seg[..., None] > 0, rng.integers(2, 50, size=(FT_B, FT_P, 3)), 0)
    return {"input_ids": ids.astype(np.int32),
            "position_ids": np.tile(np.arange(FT_P, dtype=np.int32), (FT_B, 1)),
            "segment_ids": seg,
            "graph_labels": rng.normal(5.0, 1.0, size=(FT_B, 1)).astype(np.float32)}


def _layer_masks(key, cfg, b: int, p: int):
    """Each layer's attention-dropout mask [B*P, D] and its two DropPath
    masks [B] (after attention, after the MLP), drawn as `backbone_apply`
    draws them from the step's key: the body's key is the second half of
    split(key), a layer's fold_in(body, layer) split in four (mlp, path 1,
    path 2, attention)."""
    _, body = jax.random.split(key)
    n = cfg["num_hidden_layers"]
    rates = jnp.linspace(0.0, cfg["path_dropout"], n)
    masks = []
    for i in range(n):
        _, r_dp1, r_dp2, r_adrop = jax.random.split(jax.random.fold_in(body, i), 4)
        d = cfg["hidden_size"]
        adrop = jax.random.bernoulli(r_adrop, 1.0 - cfg["attention_dropout"], (b * p, d))
        dp = [jax.random.bernoulli(r, 1.0 - rates[i], (b, 1, 1)) for r in (r_dp1, r_dp2)]
        masks.append({"adrop": torch.from_numpy(np.array(adrop)),
                      "dp": [torch.from_numpy(np.array(m)) for m in dp]})
    return masks


class _JaxDraws:
    """Stands in for a layer's generator: its JAX masks, handed out in the
    order the layer asks for them (attention dropout; DropPath after the
    attention, then after the MLP). A rematerialised layer gets a fresh one
    and so draws the same masks again."""

    def __init__(self, index: int, masks):
        self.index, self.masks, self.paths = index, masks, 0


def _hand_the_port_jax_masks(monkeypatch, masks):
    def derive(seed, index, device):
        return _JaxDraws(index, masks)

    def dropout(x, rate, gen, train):
        if not train or rate <= 0.0 or gen is None:
            return x
        keep = gen.masks[gen.index]["adrop"]
        return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)

    def drop_path(x, rate, gen, train):
        if not train or gen is None:
            return x
        keep = gen.masks[gen.index]["dp"][gen.paths]
        gen.paths += 1
        return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)

    for mod in (tmod, theads):
        monkeypatch.setattr(mod, "derive_generator", derive)
    monkeypatch.setattr(tmod, "_dropout", dropout)
    monkeypatch.setattr(tmod, "_drop_path", drop_path)


def _assert_grads_match(grads, jgrads):
    want = tree_from_jax(jgrads, device="cpu")
    assert set(grads) == set(want)
    for name in sorted(grads):
        w = want[name].numpy()
        g = np.zeros_like(w) if grads[name] is None else grads[name].numpy()
        assert np.linalg.norm(g - w) <= REL * np.linalg.norm(w) + 1e-9, name
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL, err_msg=name)


@functools.lru_cache(maxsize=None)
def _jax_finetune_step():
    os.environ["GGT_PALLAS_INTERPRET"] = "1"
    try:
        jcfg = JConfig(**FT, **JAX_PALLAS).finalize()
        params = jheads.init_task_params(jcfg, jax.random.PRNGKey(0))
        # LayerScale off its init value, so that its gradient is not the only check
        params["layers"]["ls2"] = params["layers"]["ls2"] * jnp.linspace(0.5, 1.5, 128)
        nb = {k: jnp.asarray(v) for k, v in _ft_batch().items()}

        def loss_fn(p):
            return jheads.task_forward(p, jcfg, nb, rng=STEP_KEY, train=True)["loss"]

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    finally:
        del os.environ["GGT_PALLAS_INTERPRET"]
    return _to_np(params), float(loss), _to_np(grads)


def test_fp32_finetune_step_with_layer_scale_and_dropout_matches_jax(monkeypatch):
    params, want_loss, jgrads = _jax_finetune_step()
    _hand_the_port_jax_masks(monkeypatch, _layer_masks(STEP_KEY, FT, FT_B, FT_P))
    model = theads.GraphGPTTask(TConfig(**FT).finalize(), device="cpu")
    model.load_state_dict(params_from_jax(params, device="cpu"))
    calls = []
    real = tmlp.mlp
    monkeypatch.setattr(tmlp, "mlp", lambda *a: calls.append(1) or real(*a))
    out = model(to_torch(_ft_batch(), "cpu"), generator=torch.Generator().manual_seed(0),
                train=True)
    out["loss"].backward()
    assert len(calls) == 4  # the split MLP a layer, and again in the pair's recompute
    assert abs(out["loss"].item() - want_loss) <= LOSS_REL * abs(want_loss)
    _assert_grads_match({k: p.grad for k, p in model.named_parameters()}, jgrads)


DN = dict(vocab_size=755, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
          intermediate_size=256, stacked_feat=13, next_n_token=1, mask_token_id=1,
          dtype="float32", stacked_feat_agg_method="gated", task_type="graph",
          problem_type="regression", loss_type="l1", num_labels=1, pos_num_bins=16,
          bi_causal_split=16, remat=True, remat_policy="pairs")
DN_B, DN_P = 4, 88
DN_KEY = jax.random.PRNGKey(3)


@functools.lru_cache(maxsize=None)
def _dn_batch():
    return mol3d_batch(DN_B, DN_P, seed=2, bi_split=16, tokenizer=mol3d_tokenizer())


@functools.lru_cache(maxsize=None)
def _jax_denoise_step():
    os.environ["GGT_PALLAS_INTERPRET"] = "1"
    try:
        jcfg = JConfig(**DN, **JAX_PALLAS).finalize()
        params = jden.init_denoise_params(jcfg, jax.random.PRNGKey(0))
        nb = _dn_batch()

        def loss_fn(p):
            out = jden.denoise_forward(p, jcfg, nb, rng=DN_KEY, train=True)
            return out["loss"], out["task_logits"]

        (loss, logits), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    finally:
        del os.environ["GGT_PALLAS_INTERPRET"]
    return _to_np(params), float(loss), np.asarray(logits), _to_np(grads)


def test_fp32_bi_causal_denoise_step_matches_jax(monkeypatch):
    params, want_loss, want_logits, jgrads = _jax_denoise_step()
    model = tden.GraphGPTDenoise(TConfig(**DN).finalize(), device="cpu")
    model.load_state_dict(params_from_jax(params, device="cpu"))
    calls = []
    real_dq, real_dkv = tfa.flash_dq, tfa.flash_dkv
    monkeypatch.setattr(tfa, "flash_dq", lambda *a: calls.append("dq") or real_dq(*a))
    monkeypatch.setattr(tfa, "flash_dkv", lambda *a: calls.append("dkv") or real_dkv(*a))
    draws = _torch_draws(jax_draws(DN_KEY, DN_B, DN_P))
    out = model(to_torch(_dn_batch(), "cpu"), train=True, draws=draws)
    out["loss"].backward()
    assert calls == ["dq", "dkv"] * 2  # the split pair, once a layer
    assert abs(out["loss"].item() - want_loss) <= LOSS_REL * abs(want_loss)
    np.testing.assert_allclose(out["task_logits"].detach().numpy(), want_logits, atol=1e-5,
                               rtol=1e-5)
    _assert_grads_match({k: p.grad for k, p in model.named_parameters()}, jgrads)
