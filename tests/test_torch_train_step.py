"""Ten training steps of the port against the JAX package's `make_train_step`.

The same JAX-initialised weights and the same packed batch, fp32 on the
CPU, AdamW with warm-up, clip and EMA. The JAX side runs its plain XLA path;
the port the kernels' plain versions. Per step the loss agrees to 2e-5, the
gradient norm to 1e-4 relative and the lr to 1e-6 relative. After ten steps
the parameters and the EMA copy agree to 2e-5 absolute: Adam divides by
sqrt(v), so where a gradient entry is near zero a difference of 1e-7 in it
moves the first updates by a visible fraction of lr (3e-3 here), and the
bound is a hundredth of lr.
"""

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
from graphgpt_torch.synthetic import fake_batch, to_torch
from graphgpt_torch.training import optimizer as topt
from graphgpt_torch.training import steps as tsteps
from graphgpt_torch.utils.convert import params_from_jax, tree_from_jax

COMMON = dict(
    vocab_size=50, hidden_size=128, num_hidden_layers=2, stacked_feat=3,
    next_n_token=3, mask_token_id=1, dtype="float32",
)
OPT = dict(lr=3e-3, use_ema=True, ema_decay=0.9)
TOTAL, WARMUP, STEPS = 20, 2, 10


def _batch():
    nb = fake_batch(2, 128, 3, 50, np.random.default_rng(1))
    nb["segment_ids"][-1, 96:] = 0
    nb["input_ids"][-1, 96:] = 0
    nb["labels"][-1, 96:] = -100
    return nb


@pytest.fixture(scope="module")
def runs():
    """Both sides stepped STEPS times; (jax metrics, port metrics, jax
    state, port state)."""
    nb = _batch()
    jcfg = JConfig(attn_impl="xla", mlp_kernel="off", **COMMON).finalize()
    params = jheads.init_pretrain_params(jcfg, jax.random.PRNGKey(0))
    params_np = jax.tree_util.tree_map(np.asarray, params)
    jo = JOptConfig(**OPT)
    sched = jopt.make_schedule(jo, TOTAL, WARMUP)
    tx = jopt.make_optimizer(jo, TOTAL, WARMUP, schedule=sched)
    jstate = jsteps.init_train_state(params, tx, use_ema=True)
    jstep = jsteps.make_train_step(jheads.pretrain_forward, jcfg, tx, jo, sched, donate=False)
    jmetrics = []
    for _ in range(STEPS):
        jstate, m = jstep(jstate, nb, jax.random.PRNGKey(0))
        jmetrics.append({k: float(v) for k, v in m.items()})

    model = GraphGPTPretrain(TConfig(**COMMON).finalize(), device="cpu")
    model.load_state_dict(params_from_jax(params_np, device="cpu"))
    to = TOptConfig(**OPT)
    tsched = topt.make_schedule(to, TOTAL, WARMUP)
    ttx = topt.make_optimizer(to, TOTAL, WARMUP, schedule=tsched)
    tstate = tsteps.init_train_state(model, ttx, use_ema=True)
    tstep = tsteps.make_train_step(ttx, to, tsched)
    batch = to_torch(nb, "cpu")
    tmetrics = []
    for _ in range(STEPS):
        tstate, m = tstep(tstate, batch, seed=0)
        tmetrics.append({k: float(v) for k, v in m.items()})
    return jmetrics, tmetrics, jstate, tstate


def test_metrics_track_the_jax_step(runs):
    jmetrics, tmetrics, _, _ = runs
    assert len(tmetrics) == STEPS
    for i, (j, t) in enumerate(zip(jmetrics, tmetrics)):
        assert set(t) == {"loss", "grad_norm", "lr", "gen_loss"}
        assert t["loss"] == pytest.approx(j["loss"], abs=2e-5), i
        assert t["gen_loss"] == pytest.approx(j["gen_loss"], abs=2e-5), i
        assert t["grad_norm"] == pytest.approx(j["grad_norm"], rel=1e-4), i
        assert t["lr"] == pytest.approx(j["lr"], rel=1e-6, abs=1e-12), i
    assert tmetrics[0]["lr"] == 0.0  # warm-up: the first step moves nothing
    assert tmetrics[1]["loss"] == pytest.approx(tmetrics[0]["loss"], abs=1e-7)
    assert tmetrics[-1]["loss"] < tmetrics[0]["loss"] - 0.05


def test_final_parameters_and_ema_track_the_jax_step(runs):
    _, _, jstate, tstate = runs
    assert tstate.step == STEPS == int(jstate.step)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    want = tree_from_jax(to_np(jstate.params), device="cpu")
    want_ema = tree_from_jax(to_np(jstate.ema_params), device="cpu")
    got = dict(tstate.model.named_parameters())
    assert set(got) == set(want) == set(tstate.ema_params)
    for name in sorted(got):
        np.testing.assert_allclose(got[name].detach().numpy(), want[name].numpy(), atol=2e-5,
                                   rtol=0, err_msg=name)
        np.testing.assert_allclose(tstate.ema_params[name].numpy(), want_ema[name].numpy(),
                                   atol=2e-5, rtol=0, err_msg="ema " + name)
        # the EMA copy trails the parameters
        assert not torch.equal(tstate.ema_params[name], got[name].detach()) or "norm" in name


def test_optimizer_state_tracks_optax(runs):
    """Adam's moments by name, through the same mapping as the weights."""
    _, _, jstate, tstate = runs
    adam = [s for s in jax.tree_util.tree_leaves(
        jstate.opt_state, is_leaf=lambda s: hasattr(s, "mu") and hasattr(s, "nu")
    ) if hasattr(s, "mu")][0]
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    want_mu = tree_from_jax(to_np(adam.mu), device="cpu")
    want_nu = tree_from_jax(to_np(adam.nu), device="cpu")
    assert tstate.opt_state.count == int(adam.count) == STEPS
    for name in want_mu:
        np.testing.assert_allclose(tstate.opt_state.mu[name].numpy(), want_mu[name].numpy(),
                                   atol=1e-6, rtol=1e-3, err_msg=name)
        np.testing.assert_allclose(tstate.opt_state.nu[name].numpy(), want_nu[name].numpy(),
                                   atol=1e-9, rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("use_ema", [False, True], ids=["params", "ema"])
def test_eval_step_matches_jax(runs, use_ema):
    _, _, jstate, tstate = runs
    nb = _batch()
    jcfg = JConfig(attn_impl="xla", mlp_kernel="off", **COMMON).finalize()
    want = jsteps.make_eval_step(jheads.pretrain_forward, jcfg, use_ema=use_ema)(jstate, nb)
    before = {k: p.detach().clone() for k, p in tstate.model.named_parameters()}
    got = tsteps.make_eval_step(use_ema=use_ema)(tstate, to_torch(nb, "cpu"))
    assert set(got) == {"loss", "gen_loss", "hidden_states"}
    assert got["loss"].item() == pytest.approx(float(want["loss"]), abs=5e-5)
    np.testing.assert_allclose(got["hidden_states"].numpy(), np.asarray(want["hidden_states"]),
                               atol=2e-3, rtol=0)
    assert not got["loss"].requires_grad
    # evaluating with the EMA copy leaves the parameters as they were
    assert all(torch.equal(p.detach(), before[k]) for k, p in tstate.model.named_parameters())


def test_ema_and_params_eval_differ(runs):
    _, _, _, tstate = runs
    batch = to_torch(_batch(), "cpu")
    a = tsteps.make_eval_step(use_ema=False)(tstate, batch)["loss"].item()
    b = tsteps.make_eval_step(use_ema=True)(tstate, batch)["loss"].item()
    assert a < b  # the trained weights are ahead of their trailing average


def test_step_generator_depends_on_seed_and_step():
    draw = lambda s, i: torch.rand(4, generator=tsteps.derive_generator(s, i, "cpu"))  # noqa: E731
    assert torch.equal(draw(0, 3), draw(0, 3))
    assert not torch.equal(draw(0, 3), draw(0, 4))
    assert not torch.equal(draw(0, 3), draw(1, 3))


def test_accumulation_updates_every_kth_step():
    model = GraphGPTPretrain(TConfig(**COMMON).finalize(), device="cpu", seed=0)
    cfg = TOptConfig(lr=1e-3, scheduler="constant", gradient_accumulation_steps=2)
    sched = topt.make_schedule(cfg, 10, 1)
    tx = topt.make_optimizer(cfg, 10, 1, schedule=sched)
    state = tsteps.init_train_state(model, tx)
    step = tsteps.make_train_step(tx, cfg, sched)
    batch = to_torch(_batch(), "cpu")
    w = model.lm_head.weight
    snap = [w.detach().clone()]
    for _ in range(4):
        state, _ = step(state, batch)
        snap.append(w.detach().clone())
    # lr(0) = 0 at the first emitted update (call 2); the second (call 4) moves
    assert torch.equal(snap[0], snap[1]) and torch.equal(snap[1], snap[2])
    assert torch.equal(snap[2], snap[3]) and not torch.equal(snap[3], snap[4])
    assert state.opt_state.count == 2 and state.step == 4
