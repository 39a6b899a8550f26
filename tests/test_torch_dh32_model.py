"""A model with heads of 32 (as `model.size` tiny6 and small12 build them)
against the JAX package, on the CPU.

Two layers of width 64 with two heads of dh 32, fp32, a packed batch with a
padded tail. The JAX side runs its Pallas kernels in the interpreter
(GGT_PALLAS_INTERPRET=1, attn_impl "pallas"), which pad every head to 64
before the kernel (`_prep`) and rotate q and k outside it. The port runs
its plain route at dh 32, and the padding `flash_attention` does on the
kernels' route on CPU tensors (`use_kernel` saying yes to its heads of 32,
so that the wrappers, handed heads of 64, take their plain versions). The
loss and every gradient leaf at the tolerances of test_torch_train_grads.py,
and one AdamW step at those of test_torch_train_step.py.
"""

import contextlib
import functools
import os

import jax
import numpy as np
import pytest
import torch

from graphgpt_tpu.config import ModelConfig as JConfig
from graphgpt_tpu.config import OptimizerConfig as JOptConfig
from graphgpt_tpu.models import heads as jheads
from graphgpt_tpu.training import optimizer as jopt
from graphgpt_tpu.training import steps as jsteps
from graphgpt_torch.config import ModelConfig as TConfig
from graphgpt_torch.config import OptimizerConfig as TOptConfig
from graphgpt_torch.models.heads import GraphGPTPretrain
from graphgpt_torch.ops import flash_attention as tfa
from graphgpt_torch.synthetic import fake_batch, to_torch
from graphgpt_torch.training import optimizer as topt
from graphgpt_torch.training import steps as tsteps
from graphgpt_torch.utils.convert import params_from_jax, tree_from_jax

COMMON = dict(
    vocab_size=50, hidden_size=64, num_hidden_layers=2, num_attention_heads=2, head_dim=32,
    intermediate_size=128, stacked_feat=3, next_n_token=3, mask_token_id=1, dtype="float32",
)
REL, ATOL, RTOL = 2e-4, 1e-6, 1e-3  # test_torch_train_grads.py's
OPT = dict(lr=3e-3, use_ema=True, ema_decay=0.9, scheduler="onecycle")  # lr > 0 at step 0
TOTAL, WARMUP = 20, 2


def _batch():
    nb = fake_batch(2, 128, 3, 50, np.random.default_rng(1))
    nb["segment_ids"][-1, 96:] = 0
    nb["input_ids"][-1, 96:] = 0
    nb["labels"][-1, 96:] = -100
    return nb


@contextlib.contextmanager
def _interpret():
    os.environ["GGT_PALLAS_INTERPRET"] = "1"
    try:
        yield
    finally:
        del os.environ["GGT_PALLAS_INTERPRET"]


@functools.lru_cache(maxsize=None)
def _jax_side():
    """(config, params, loss, grads, loss and params after one step) of the
    JAX package on its Pallas path, interpreted."""
    jcfg = JConfig(attn_impl="pallas", mlp_kernel="on", **COMMON).finalize()
    assert jcfg.head_dim == 32 and jcfg.num_attention_heads == 2
    params = jheads.init_pretrain_params(jcfg, jax.random.PRNGKey(0))
    nb = _batch()
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    with _interpret():
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jheads.pretrain_forward(p, jcfg, nb, train=True)["loss"]))(params)
        jo = JOptConfig(**OPT)
        sched = jopt.make_schedule(jo, TOTAL, WARMUP)
        tx = jopt.make_optimizer(jo, TOTAL, WARMUP, schedule=sched)
        state = jsteps.init_train_state(params, tx, use_ema=True)
        step = jsteps.make_train_step(jheads.pretrain_forward, jcfg, tx, jo, sched, donate=False)
        state, m = step(state, nb, jax.random.PRNGKey(0))
    return (to_np(params), float(loss), to_np(grads), float(m["loss"]),
            to_np(state.params), to_np(state.ema_params))


@contextlib.contextmanager
def _route(route):
    """The port's plain route at dh 32, or the kernels' route's padding in
    `flash_attention` (its flash_fwd calls recorded: heads of 64)."""
    if route == "plain":
        yield
        return
    widths, fwd = [], tfa.flash_fwd
    with pytest.MonkeyPatch.context() as m:
        m.setattr(tfa, "use_kernel", lambda *ts: ts[0].dim() == 4 and ts[0].shape[-1] == 32)
        m.setattr(tfa, "flash_fwd", lambda *a: widths.append(a[7]) or fwd(*a))
        yield
    assert widths and set(widths) == {tfa.KERNEL_DH}, "the padded route was not taken"


def _port(params):
    model = GraphGPTPretrain(TConfig(**COMMON).finalize(), device="cpu")
    assert model.cfg.head_dim == 32
    model.load_state_dict(params_from_jax(params, device="cpu"))
    return model


@pytest.mark.parametrize("route", ["plain", "padded"])
def test_loss_and_every_gradient_match_jax_at_dh_32(route):
    params, want_loss, want_grads, *_ = _jax_side()
    model = _port(params)
    with _route(route):
        out = model(to_torch(_batch(), "cpu"), train=True)
        out["loss"].backward()
    assert abs(out["loss"].item() - want_loss) < 1e-5
    want = tree_from_jax(want_grads, device="cpu")
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for name in sorted(got):
        g, w = got[name].numpy(), want[name].numpy()
        assert np.linalg.norm(g - w) <= REL * np.linalg.norm(w) + 1e-9, name
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL, err_msg=name)


def test_one_train_step_matches_jax_at_dh_32():
    params, _, _, want_loss, want_params, want_ema = _jax_side()
    model = _port(params)
    to = TOptConfig(**OPT)
    sched = topt.make_schedule(to, TOTAL, WARMUP)
    tx = topt.make_optimizer(to, TOTAL, WARMUP, schedule=sched)
    state = tsteps.init_train_state(model, tx, use_ema=True)
    with _route("padded"):
        state, m = tsteps.make_train_step(tx, to, sched)(state, to_torch(_batch(), "cpu"),
                                                        seed=0)
    assert float(m["loss"]) == pytest.approx(want_loss, abs=2e-5)
    want, ema = tree_from_jax(want_params, device="cpu"), tree_from_jax(want_ema, device="cpu")
    before, moved = params_from_jax(params, device="cpu"), 0
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=2e-5, rtol=0,
                                   err_msg=name)
        np.testing.assert_allclose(state.ema_params[name].numpy(), ema[name].numpy(), atol=2e-5,
                                   rtol=0, err_msg="ema " + name)
        moved += not np.array_equal(want[name].numpy(), before[name].numpy())
    assert moved  # the step moved the weights
