"""The fp32 streamed route that reaches #6, #7 and #8 (`_fwd_kernel_stream`
:177, `_dq_kernel_stream` :645, `_dkv_kernel_stream` :835), against the
JAX package on the CPU: a pretrain-mlm training step of a two-layer fp32
model (hidden 128, two heads of 64, FFN 512, save_attn remat, as the
long-context config trains), the loss and EVERY gradient leaf by name.

Both dispatches take the streamed kernels only when the kv axis is more
than one block, so the cases reach them at small sizes:

- `p2048`: both single-block limits lowered to 1024 (JAX's
  `_MAX_SINGLE_BLOCK`, the port's `MAX_P`), one packed row of P 2048 with a
  padded tail: kv blocks of 1024 (nk 2), RoPE in the kernels, as above P
  4096's threshold of 2048 on the card;
- `skip`: both `_MODE`s `skip`, JAX's `_BAND_BK` and `_BQ_BWD` at 64, two
  rows of P 128: the streamed kernels at every P, q and k rotated outside.

The JAX side runs its Pallas path in the interpreter (GGT_PALLAS_INTERPRET=1,
attn_impl="pallas", mlp_kernel="on") and each of its three stream kernels
is spied on, so that the test shows it ran; the port runs its wrappers'
plain versions (CPU tensors), which the card's fp32 stream forms are held
to, and the test counts the wrappers' calls. Loss to 1e-5 relative, each
gradient to 2e-4 in the relative Frobenius norm and elementwise to 1e-6 +
1e-3 * |g|, as the other fp32 slices: fp32 sums in another order.
"""

import jax
import numpy as np
import pytest
import torch

from graphgpt_tpu.config import ModelConfig as JConfig
from graphgpt_tpu.models import heads as jheads
from graphgpt_tpu.ops import flash_attention as jfa
from graphgpt_torch.config import ModelConfig as TConfig
from graphgpt_torch.models.heads import GraphGPTPretrain
from graphgpt_torch.ops import flash_attention as tfa
from graphgpt_torch.synthetic import fake_batch, to_torch
from graphgpt_torch.utils.convert import params_from_jax
from test_torch_flash_stream import _spy
from test_torch_train_grads import _assert_grads_match

LOSS_REL = 1e-5
COMMON = dict(vocab_size=50, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
              intermediate_size=512, stacked_feat=3, next_n_token=3, mask_token_id=1,
              dtype="float32", remat=True, remat_policy="save_attn")
# case -> (B, P, the JAX module's attributes, the port module's)
CASES = {
    "p2048": (1, 2048, {"_MAX_SINGLE_BLOCK": 1024}, {"MAX_P": 1024}),
    "skip": (2, 128, {"_MODE": "skip", "_BAND_BK": 64, "_BQ_BWD": 64}, {"_MODE": "skip"}),
}
STREAM = ("flash_fwd_stream", "flash_dq_stream", "flash_dkv_stream")


def _batch(b, p):
    nb = fake_batch(b, p, 3, 50, np.random.default_rng(3))
    for key, fill in (("segment_ids", 0), ("input_ids", 0), ("labels", -100)):
        nb[key][-1, p - 40 :] = fill  # a padded tail on the last row
    return nb


@pytest.mark.parametrize("case", list(CASES))
def test_fp32_step_on_the_streamed_route_matches_jax(case, monkeypatch):
    b, p, jattrs, tattrs = CASES[case]
    monkeypatch.setenv("GGT_PALLAS_INTERPRET", "1")
    for name, value in jattrs.items():
        monkeypatch.setattr(jfa, name, value)
    for name, value in tattrs.items():
        monkeypatch.setattr(tfa, name, value)
    jran = {n: _spy(monkeypatch, n) for n in ("_fwd_kernel_stream", "_dq_kernel_stream",
                                              "_dkv_kernel_stream")}
    kw = dict(COMMON, max_position_embeddings=max(p, 1024))
    jcfg = JConfig(**kw, attn_impl="pallas", mlp_kernel="on").finalize()
    params = jheads.init_pretrain_params(jcfg, jax.random.PRNGKey(0))
    nb = _batch(b, p)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda q: jheads.pretrain_forward(q, jcfg, nb, rng=None, train=True)["loss"]))(params)
    assert all(jran.values()), "the JAX dispatch did not reach the stream kernels"
    params, grads = (jax.tree_util.tree_map(np.asarray, t) for t in (params, grads))

    calls = {n: 0 for n in STREAM}
    for n in STREAM:
        def wrapped(*a, _fn=getattr(tfa, n), _n=n, **k):
            calls[_n] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(tfa, n, wrapped)
    model = GraphGPTPretrain(TConfig(**kw).finalize(), device="cpu")
    model.load_state_dict(params_from_jax(params, device="cpu"))
    out = model(to_torch(nb, "cpu"), train=True)
    out["loss"].backward()
    assert calls == {n: 2 for n in STREAM}  # once a layer; save_attn keeps the forward's out
    want = float(loss)
    assert abs(out["loss"].item() - want) <= LOSS_REL * abs(want)
    _assert_grads_match({k: q.grad for k, q in model.named_parameters()}, grads)
