"""The training forward and backward of the port under both knobs,
`GGT_FLASH_MODE=band` and `GGT_ATTN_NORM_FUSE=1`, against the JAX package
under the same knobs, on the CPU.

A tiny model (hidden 128, 2 layers, 2 heads of 64, P 256, stacked_feat 3,
packed rows with a padded tail) in fp32 with save_attn remat: the loss and
every gradient against `jax.grad(pretrain_forward)` with attn_impl
"pallas", mlp_kernel "on", the Pallas kernels interpreted
(GGT_PALLAS_INTERPRET=1), the band kernels at the port's 64-row tiles and
the norm-fused q/k/v kernel, each spied on so that the test shows it ran;
the gradients cross by parameter name, as in test_torch_train_grads.py and
with its tolerances (loss 1e-5; each gradient 2e-4 in the relative
Frobenius norm, 1e-6 + 1e-3 * |g| elementwise). Then the port under the
knobs against the port under `legacy` with the knob off: the same function
by another route, so within fp32 2e-5.
"""

import functools

import jax
import numpy as np
import pytest

from graphgpt_tpu.config import ModelConfig as JConfig
from graphgpt_tpu.models import heads as jheads
from graphgpt_tpu.ops import flash_attention as jfa
from graphgpt_tpu.ops import mlp as jmlp
from graphgpt_torch.config import ModelConfig as TConfig
from graphgpt_torch.models.heads import GraphGPTPretrain
from graphgpt_torch.ops import flash_attention as tfa
from graphgpt_torch.ops import mlp as tmlp
from graphgpt_torch.synthetic import fake_batch, to_torch
from graphgpt_torch.utils.convert import params_from_jax, tree_from_jax

COMMON = dict(vocab_size=50, hidden_size=128, num_hidden_layers=2, stacked_feat=3,
              next_n_token=3, mask_token_id=1, dtype="float32", remat=True,
              remat_policy="save_attn")
REL, ATOL, RTOL = 2e-4, 1e-6, 1e-3
P = 256


def _batch(b=2, seed=1):
    nb = fake_batch(b, P, 3, 50, np.random.default_rng(seed))
    nb["segment_ids"][-1, P - 48 :] = 0  # a padded tail on the last row
    nb["input_ids"][-1, P - 48 :] = 0
    nb["labels"][-1, P - 48 :] = -100
    return nb


@pytest.fixture
def knobs(monkeypatch):
    """Both knobs on both sides, the JAX kernels interpreted at 64-row band
    tiles; returns spies on the JAX kernels that the knobs route to."""
    monkeypatch.setenv("GGT_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("GGT_ATTN_NORM_FUSE", "1")
    monkeypatch.setattr(jfa, "_MODE", "band")
    monkeypatch.setattr(tfa, "_MODE", "band")
    for name in ("_BQ_TARGET", "_BAND_BK", "_BQ_BWD"):
        monkeypatch.setattr(jfa, name, 64)
    spies = {}
    for module, name in ((jfa, "_fwd_kernel_band"), (jfa, "_bwd_kernel_band"),
                         (jmlp, "_norm_qkv_kernel")):
        calls = spies[name] = []
        fn = getattr(module, name)

        def wrapped(*a, _fn=fn, _calls=calls, **kw):
            _calls.append(1)
            return _fn(*a, **kw)

        monkeypatch.setattr(module, name, wrapped)
    return spies


def _port_loss_and_grads(model, nb):
    model.zero_grad(set_to_none=True)
    loss = model(to_torch(nb, "cpu"), train=True)["loss"]
    loss.backward()
    return loss.item(), {k: p.grad.clone() for k, p in model.named_parameters()}


def test_backbone_under_both_knobs_matches_jax_and_the_legacy_route(knobs, monkeypatch):
    jcfg = JConfig(**COMMON, attn_impl="pallas", mlp_kernel="on").finalize()
    params = jheads.init_pretrain_params(jcfg, jax.random.PRNGKey(0))
    nb = _batch()

    def loss_fn(p):
        return jheads.pretrain_forward(p, jcfg, nb, train=True)["loss"]

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    assert all(knobs.values()), {k: bool(v) for k, v in knobs.items()}
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    model = GraphGPTPretrain(TConfig(**COMMON).finalize(), device="cpu")
    model.load_state_dict(params_from_jax(to_np(params), device="cpu"))

    names = ("flash_fwd_band", "flash_bwd_band", "flash_fwd", "flash_bwd")
    counts = {n: 0 for n in names + ("norm_qkv",)}
    for module, name in [(tfa, n) for n in names] + [(tmlp, "norm_qkv")]:
        def wrapped(*a, _fn=getattr(module, name), _n=name, **kw):
            counts[_n] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(module, name, wrapped)
    loss, grads = _port_loss_and_grads(model, nb)
    # per layer: one band forward (the recompute reads the stash), one band
    # backward, norm_qkv in the forward and in the recompute
    assert counts == {"flash_fwd_band": 2, "flash_bwd_band": 2, "flash_fwd": 2, "flash_bwd": 2,
                      "norm_qkv": 4}, counts
    assert abs(loss - float(want_loss)) < 1e-5
    want = tree_from_jax(to_np(want_grads), device="cpu")
    assert set(grads) == set(want)
    for name in sorted(grads):
        g, w = grads[name].numpy(), want[name].numpy()
        assert np.linalg.norm(g - w) <= REL * np.linalg.norm(w) + 1e-9, name
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL, err_msg=name)

    monkeypatch.setattr(tfa, "_MODE", "legacy")
    monkeypatch.setenv("GGT_ATTN_NORM_FUSE", "0")
    for n in counts:
        counts[n] = 0
    loss0, grads0 = _port_loss_and_grads(model, nb)
    assert counts["flash_fwd_band"] == counts["norm_qkv"] == 0 and counts["flash_fwd"] == 2
    assert abs(loss - loss0) <= 2e-5 * abs(loss0)
    for name in sorted(grads):
        g, w = grads[name].numpy(), grads0[name].numpy()
        np.testing.assert_allclose(g, w, atol=2e-5 * np.abs(w).max(), rtol=2e-5, err_msg=name)


def test_the_norm_fuse_knob_is_read_on_each_call(monkeypatch):
    """GGT_ATTN_NORM_FUSE decides per call, as the JAX package reads it per
    trace; any value but "1" leaves the pre-norm and the three products."""
    model = GraphGPTPretrain(TConfig(**{**COMMON, "remat": False}).finalize(), device="cpu",
                             seed=2)
    nb = to_torch(_batch(b=1, seed=3), "cpu")
    calls = []
    fn = tmlp.norm_qkv
    monkeypatch.setattr(tmlp, "norm_qkv", lambda *a, **kw: calls.append(1) or fn(*a, **kw))
    losses = {}
    for value in ("0", "1", "yes"):
        monkeypatch.setenv("GGT_ATTN_NORM_FUSE", value)
        calls.clear()
        losses[value] = model(nb, train=False)["loss"].item()
        assert len(calls) == (2 if value == "1" else 0), value
    assert abs(losses["1"] - losses["0"]) <= 1e-5 * abs(losses["0"])
