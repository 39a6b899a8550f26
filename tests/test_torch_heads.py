"""The port's inference slice as a whole against the JAX package, on the CPU.

The same JAX-initialised weights go to both sides through `params_from_jax`;
the JAX side runs its Pallas kernels in the interpreter
(GGT_PALLAS_INTERPRET=1, `attn_impl="pallas"`, `mlp_kernel="on"`), the port
its kernels' plain versions (CPU tensors). fp32 logits agree to 1e-5 (sums in
another order through two layers and two heads); the loss to 1e-5. In bf16
the logits agree to 4e-3 (a few bf16 ulps of values below 0.25, where
roundings flip in another summation order) and the loss to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphgpt_tpu.config import ModelConfig as JConfig
from graphgpt_tpu.models import heads as jheads
from graphgpt_tpu.ops import losses as jlosses
from graphgpt_torch.config import ModelConfig as TConfig
from graphgpt_torch.config import flagship_config
from graphgpt_torch.models import heads as theads
from graphgpt_torch.models.heads import GraphGPTPretrain
from graphgpt_torch.ops import losses as tlosses
from graphgpt_torch.synthetic import fake_batch, to_torch
from graphgpt_torch.utils.convert import params_from_jax

COMMON = dict(
    vocab_size=50, hidden_size=128, num_hidden_layers=2, stacked_feat=3,
    next_n_token=3, mask_token_id=1,
)
TOL = {"float32": dict(logits=1e-5, loss=1e-5), "bfloat16": dict(logits=4e-3, loss=1e-4)}


def _batch(b=2, p=128, seed=1):
    nb = fake_batch(b, p, 3, 50, np.random.default_rng(seed))
    # a padded tail on the last row
    nb["segment_ids"][-1, p - 32 :] = 0
    nb["input_ids"][-1, p - 32 :] = 0
    nb["labels"][-1, p - 32 :] = -100
    return nb


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pretrain_logits_and_eval_loss_match_jax(dtype, monkeypatch):
    monkeypatch.setenv("GGT_PALLAS_INTERPRET", "1")
    jcfg = JConfig(attn_impl="pallas", mlp_kernel="on", dtype=dtype, **COMMON).finalize()
    tcfg = TConfig(dtype=dtype, **COMMON).finalize()
    params = jax.tree_util.tree_map(
        np.asarray, jheads.init_pretrain_params(jcfg, jax.random.PRNGKey(0))
    )
    nb = _batch()
    want_loss = jax.jit(lambda p, b: jheads.pretrain_forward(p, jcfg, b)["loss"])(params, nb)
    want_logits = jax.jit(lambda p, b: jheads.pretrain_logits(p, jcfg, b))(params, nb)

    model = GraphGPTPretrain(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(params, device="cpu"))
    batch = to_torch(nb, "cpu")
    logits = model.logits(batch)
    loss = model.loss(batch)

    assert logits.shape == (2, 128, 3, 50) and logits.dtype == torch.float32
    tol = TOL[dtype]
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=tol["logits"], rtol=0)
    assert abs(loss.item() - float(want_loss)) < tol["loss"]


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(wgt=True), dict(focal_gamma=2.0), dict(next_n=1)],
    ids=["plain", "dlm-weighted", "focal", "single-head"],
)
def test_chunked_stacked_ce_matches_jax(kw):
    rng = np.random.default_rng(3)
    b, p, d, v = 2, 64, 32, 40
    n = kw.get("next_n", 3)
    hidden = rng.normal(size=(b, p, d)).astype(np.float32)
    labels = rng.integers(0, v, size=(b, p, n)).astype(np.int32)
    labels[rng.random((b, p, n)) < 0.4] = -100
    proj = (rng.normal(size=(d, n * d)) * 0.2).astype(np.float32) if n > 1 else None
    head = (rng.normal(size=(d, v)) * 0.2).astype(np.float32)
    wgt = dlm = None
    if kw.get("wgt"):
        wgt = np.broadcast_to(rng.random((b, 1, 1)).astype(np.float32), (b, p, n))
        dlm = float(b * p * n)
    gamma = kw.get("focal_gamma", 0.0)
    want = jlosses.chunked_stacked_ce(
        jnp.asarray(hidden), jnp.asarray(labels), None if proj is None else jnp.asarray(proj),
        jnp.asarray(head), token_wgt=None if wgt is None else jnp.asarray(wgt),
        dlm_normalizer=dlm, focal_gamma=gamma, chunk=16,
    )
    t = torch.from_numpy
    got = tlosses.chunked_stacked_ce(
        t(hidden), t(labels), None if proj is None else t(proj.T.copy()), t(head.T.copy()),
        token_wgt=None if wgt is None else t(wgt.copy()), dlm_normalizer=dlm,
        focal_gamma=gamma, chunk=16,
    )
    assert abs(got.item() - float(want)) < 1e-5


def test_last_token_pool_matches_jax():
    rng = np.random.default_rng(4)
    hidden = rng.normal(size=(3, 16, 8)).astype(np.float32)
    seg = np.ones((3, 16), np.int32)
    seg[1, 10:] = 0
    seg[2, 1:] = 0
    want = jheads.last_token_pool(jnp.asarray(hidden), jnp.asarray(seg))
    got = theads.last_token_pool(torch.from_numpy(hidden), torch.from_numpy(seg))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_flagship_config_is_graphgpt_base():
    cfg = flagship_config()
    assert (cfg.hidden_size, cfg.num_hidden_layers, cfg.num_attention_heads) == (768, 12, 12)
    assert (cfg.head_dim, cfg.intermediate_size, cfg.vocab_size) == (64, 3072, 754)
    assert (cfg.stacked_feat, cfg.next_n_token, cfg.max_position_embeddings) == (13, 13, 1024)
    assert not cfg.causal_attention and cfg.dtype == "bfloat16"


def test_seeded_init_is_reproducible_and_shaped_like_jax():
    cfg = TConfig(stacked_feat_agg_method="gated", **COMMON).finalize()
    a = GraphGPTPretrain(cfg, device="cpu", seed=7).state_dict()
    b = GraphGPTPretrain(cfg, device="cpu", seed=7).state_dict()
    c = GraphGPTPretrain(cfg, device="cpu", seed=8).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["lm_head.weight"], c["lm_head.weight"])
    jcfg = JConfig(stacked_feat_agg_method="gated", **COMMON).finalize()
    params = jax.tree_util.tree_map(
        np.asarray, jheads.init_pretrain_params(jcfg, jax.random.PRNGKey(0))
    )
    want = params_from_jax(params, device="cpu")
    assert {k: tuple(v.shape) for k, v in a.items()} == {k: tuple(v.shape) for k, v in want.items()}
    std = a["model.layers.0.mlp.gate_proj.weight"].std().item()
    assert abs(std - cfg.initializer_range) < 2e-3
    assert torch.equal(a["model.norm.weight"], torch.ones(cfg.hidden_size))


def test_model_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TConfig(**COMMON).finalize()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GraphGPTPretrain(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_jax({}, device=None)
