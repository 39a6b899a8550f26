"""The port's schedules and optimizer against optax, step by step.

The JAX package builds its optimizer from optax (`make_optimizer`); the port
writes the same rules out. Random trees made with numpy go through both for
several steps. fp32 on both sides, the port's scalars (lr, bias corrections)
in Python floats while optax keeps them in fp32: updates agree to 1e-5
relative with atol 1e-8 (a few fp32 ulps, more where the Adam term and the
weight-decay term of one entry nearly cancel), schedules to 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from graphgpt_tpu.config import OptimizerConfig as JOptConfig
from graphgpt_tpu.training import optimizer as jopt
from graphgpt_torch.config import OptimizerConfig as TOptConfig
from graphgpt_torch.training import optimizer as topt
from graphgpt_torch.utils.convert import params_from_jax, tree_from_jax

SCHEDULERS = ["warmup_decay", "onecycle", "cosine", "constant", "cyclic", "cosine_wr",
              "lr_range_test"]
L, D, F, V = 3, 8, 16, 12


def _tree(rng, scale=1.0):
    """A params-shaped tree in the JAX layout (stacked [L, ...] layers)."""
    n = lambda *s: (rng.normal(size=s) * scale).astype(np.float32)  # noqa: E731
    return {
        "embed_tokens": n(V, D), "final_norm": n(D), "lm_head": n(D, V),
        "layers": {
            "q": n(L, D, D), "k": n(L, D, D), "v": n(L, D, D), "o": n(L, D, D),
            "gate": n(L, D, F), "up": n(L, D, F), "down": n(L, F, D),
            "attn_norm": n(L, D), "mlp_norm": n(L, D),
        },
    }


def _assert_trees_close(got, want_tree, rtol=1e-5, atol=1e-8):
    want = tree_from_jax(jax.tree_util.tree_map(np.asarray, want_tree), device="cpu")
    assert set(got) == set(want)
    for name in sorted(got):
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=rtol, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("name", SCHEDULERS)
@pytest.mark.parametrize("extra", [dict(), dict(min_lr=3e-5, cycle_steps=7, cycle_mult=2.0)],
                         ids=["defaults", "min_lr-cycles"])
def test_schedule_matches_optax(name, extra):
    kw = dict(lr=3e-4, scheduler=name, **extra)
    want_fn = jopt.make_schedule(JOptConfig(**kw), 50, 5)
    got_fn = topt.make_schedule(TOptConfig(**kw), 50, 5)
    for step in range(0, 70):
        want = float(want_fn(jnp.asarray(step)))
        assert got_fn(step) == pytest.approx(want, rel=1e-5, abs=1e-10), (name, step)
    assert isinstance(got_fn(3), float)


def test_unknown_scheduler_raises():
    with pytest.raises(ValueError, match="scheduler"):
        topt.make_schedule(TOptConfig(scheduler="nope"), 10, 1)


@pytest.mark.parametrize("scale", [0.01, 1.0], ids=["below", "above"])
def test_clip_by_global_norm_matches_optax(scale):
    grads = _tree(np.random.default_rng(0), scale)
    want, _ = optax.clip_by_global_norm(1.0).update(grads, optax.EmptyState())
    tgrads = params_from_jax(grads, device="cpu")
    assert topt.global_norm(tgrads).item() == pytest.approx(float(optax.global_norm(grads)), rel=1e-6)
    _assert_trees_close(topt.clip_by_global_norm(tgrads, 1.0), want)
    if scale == 0.01:  # under the threshold the gradients are the same bits
        got = topt.clip_by_global_norm(tgrads, 1.0)
        assert all(torch.equal(got[k], tgrads[k]) for k in got)


def _run_both(kw, steps=6, num_layers=None, grad_scale=1.0):
    """Step both optimizers on the same random gradients; yields
    (port updates, optax updates, port params, optax params) per step."""
    rng = np.random.default_rng(1)
    params = _tree(rng)
    tx = jopt.make_optimizer(JOptConfig(**kw), 20, 3, num_layers=num_layers)
    jstate = tx.init(params)
    opt = topt.make_optimizer(TOptConfig(**kw), 20, 3, num_layers=num_layers)
    tparams = params_from_jax(params, device="cpu")
    tstate = opt.init(tparams)
    for _ in range(steps):
        grads = _tree(rng, grad_scale)
        jupd, jstate = tx.update(grads, jstate, params)
        params = optax.apply_updates(params, jupd)
        tupd, tstate = opt.update(params_from_jax(grads, device="cpu"), tstate, tparams)
        topt.apply_updates(tparams, tupd)
        yield tupd, jupd, tparams, params


@pytest.mark.parametrize("grad_scale", [0.01, 1.0], ids=["unclipped", "clipped"])
def test_adamw_matches_optax_step_by_step(grad_scale):
    kw = dict(lr=1e-2, weight_decay=0.1)
    for i, (tupd, jupd, tparams, params) in enumerate(_run_both(kw, grad_scale=grad_scale)):
        _assert_trees_close(tupd, jupd)
        _assert_trees_close(tparams, params)
        if i == 0:  # warm-up: the first update reads lr at count 0
            assert all(float(u.abs().max()) == 0.0 for u in tupd.values())


def test_layerwise_lr_decay_matches_optax():
    kw = dict(lr=1e-2, layerwise_lr_decay=0.8)
    for tupd, jupd, tparams, params in _run_both(kw, num_layers=L):
        _assert_trees_close(tupd, jupd)
        _assert_trees_close(tparams, params)
    scales = topt.layerwise_lr_scales(
        ["model.layers.0.mlp.up_proj.weight", "model.layers.2.input_layernorm.weight",
         "model.embed_tokens.weight", "lm_head.weight"], L, 0.8)
    assert list(scales.values()) == pytest.approx([0.8**2, 1.0, 0.8**3, 1.0])
    with pytest.raises(ValueError, match="num_layers"):
        topt.make_optimizer(TOptConfig(layerwise_lr_decay=0.8), 20, 3)


def test_gradient_accumulation_matches_optax_multisteps():
    kw = dict(lr=1e-2, gradient_accumulation_steps=3)
    emitted = 0
    for i, (tupd, jupd, tparams, params) in enumerate(_run_both(kw, steps=10)):
        if (i + 1) % 3:
            assert tupd is None  # optax hands out zeros on these calls
            assert all(float(jnp.abs(u).max()) == 0.0 for u in jax.tree_util.tree_leaves(jupd))
        else:
            emitted += 1
            _assert_trees_close(tupd, jupd)
        _assert_trees_close(tparams, params)
    assert emitted == 3


def _fixed_muon(kw, total, warmup):
    """The JAX package's chain with Muon on the decoder's matrices only: its
    own label_fn also hands the stacked [L, D] norm weights to Muon, because
    stacking makes them 2-D."""
    cfg = JOptConfig(**kw)
    sched = jopt.make_schedule(cfg, total, warmup)
    adamw = optax.adamw(sched, b1=cfg.betas[0], b2=cfg.betas[1], eps=cfg.eps,
                        weight_decay=cfg.weight_decay)

    def label_fn(params):
        def label(path, leaf):
            keys = [getattr(p, "key", str(p)) for p in path]
            return "muon" if ("layers" in keys and leaf.ndim >= 3) else "adamw"

        return jax.tree_util.tree_map_with_path(label, params)

    inner = optax.multi_transform({"muon": jopt.muon(sched), "adamw": adamw}, label_fn)
    return optax.chain(optax.clip_by_global_norm(cfg.max_grad_norm), inner)


def test_muon_matches_the_jax_muon_on_matrices():
    kw = dict(name="muon", lr=1e-2)
    rng = np.random.default_rng(2)
    params = _tree(rng)
    tx, tx_pkg = _fixed_muon(kw, 20, 3), jopt.make_optimizer(JOptConfig(**kw), 20, 3)
    jstate, pstate = tx.init(params), tx_pkg.init(params)
    opt = topt.make_optimizer(TOptConfig(**kw), 20, 3)
    tparams = params_from_jax(params, device="cpu")
    tstate = opt.init(tparams)
    assert set(tstate.muon_mu) == {k for k in tparams if ".layers." in k and "proj" in k}
    for _ in range(4):
        grads = _tree(rng)
        jupd, jstate = tx.update(grads, jstate, params)
        pupd, pstate = tx_pkg.update(grads, pstate, params)
        tupd, tstate = opt.update(params_from_jax(grads, device="cpu"), tstate, tparams)
        # Newton-Schulz: five fp32 matrix polynomials, 1e-4 is a few ulps of them
        _assert_trees_close(tupd, jupd, rtol=1e-4, atol=1e-7)
        # against the package's own chain: the same on every matrix and outside
        # the layers; its stacked norm weights went through Muon instead
        want = tree_from_jax(jax.tree_util.tree_map(np.asarray, pupd), device="cpu")
        for name, u in tupd.items():
            same = np.allclose(u.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-7)
            assert same != name.endswith("layernorm.weight"), name
        params = optax.apply_updates(params, jupd)
        topt.apply_updates(tparams, tupd)


def test_newton_schulz_matches_jax():
    rng = np.random.default_rng(3)
    for shape in ((8, 16), (16, 8), (3, 8, 8)):
        g = rng.normal(size=shape).astype(np.float32)
        want = np.asarray(jopt._newton_schulz(jnp.asarray(g)))
        got = topt.newton_schulz(torch.from_numpy(g)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_compute_total_steps_matches_jax():
    args = (1e9, 1e8, 900.0, 512)
    assert topt.compute_total_steps(*args) == jopt.compute_total_steps(*args)
