"""The backward of the port's norm-fused MLP against the JAX package's.

`fused_norm_mlp` is a `torch.autograd.Function`: the kernel forward (its
plain version on the CPU) and `norm_mlp_bwd_ref`, the formula of
`_fused_norm_mlp_bwd`, backward. The JAX side is `jax.vjp(fused_norm_mlp)`
with the Pallas kernel in the interpreter. fp32: another order of sums and,
for gelu, the Pallas kernel's approximate erf in the forward only
(|error| <= 1.5e-7): 2e-5. bf16: both sides round hpre, xg, xu, a, g, dg and
dxg to bf16 at the same points and sum the three weight gradients in fp32;
what differs is the rounding of a value that lies near a bf16 tie, which
moves an entry by 1 ulp: dx to 2 ulps elementwise (atol 3e-2 at values up
to ~4), every gradient to 1e-2 in the relative Frobenius norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphgpt_tpu.ops import mlp as jmlp
from graphgpt_torch.ops import mlp as tmlp

ACTS = ["gelu", "gelu_pytorch_tanh", "silu"]
EPS = 1e-6


def _inputs(n=64, d=128, f=512, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    wn = (1.0 + 0.1 * rng.normal(size=d)).astype(np.float32)
    wg = (rng.normal(size=(d, f)) * 0.05).astype(np.float32)
    wu = (rng.normal(size=(d, f)) * 0.05).astype(np.float32)
    wd = (rng.normal(size=(f, d)) * 0.05).astype(np.float32)
    dout = rng.normal(size=(n, d)).astype(np.float32)
    return x, wn, wg, wu, wd, dout


def _jax_vjp(x, wn, wg, wu, wd, dout, act, jdt):
    args = (jnp.asarray(x, jdt), *(jnp.asarray(a) for a in (wn, wg, wu, wd)))
    _, vjp = jax.vjp(lambda *a: jmlp.fused_norm_mlp(*a, EPS, act), *args)
    return [np.asarray(g, np.float32) for g in vjp(jnp.asarray(dout, jdt))]


def _port_grads(x, wn, wg, wu, wd, dout, act, tdt):
    t = torch.from_numpy
    leaves = [t(x).to(tdt).requires_grad_(), t(wn).requires_grad_()]
    leaves += [t(w.T.copy()).requires_grad_() for w in (wg, wu, wd)]
    out = tmlp.fused_norm_mlp(*leaves, EPS, act)
    out.backward(t(dout).to(tdt))
    dx, dwn, dwg, dwu, dwd = (leaf.grad for leaf in leaves)
    assert dx.dtype == tdt and all(g.dtype == torch.float32 for g in (dwn, dwg, dwu, dwd))
    # back to the JAX layout
    return [dx.float().numpy(), dwn.numpy(), dwg.numpy().T, dwu.numpy().T, dwd.numpy().T]


@pytest.mark.parametrize("act", ACTS)
def test_norm_mlp_backward_matches_jax_vjp_fp32(act, monkeypatch):
    monkeypatch.setenv("GGT_PALLAS_INTERPRET", "1")
    inp = _inputs()
    want = _jax_vjp(*inp, act, jnp.float32)
    got = _port_grads(*inp, act, torch.float32)
    for name, g, w in zip(("dx", "dwn", "dwg", "dwu", "dwd"), got, want):
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=2e-5, err_msg=name)


@pytest.mark.parametrize("act", ACTS)
def test_norm_mlp_backward_matches_jax_vjp_bf16(act, monkeypatch):
    monkeypatch.setenv("GGT_PALLAS_INTERPRET", "1")
    inp = _inputs(seed=1)
    want = _jax_vjp(*inp, act, jnp.bfloat16)
    got = _port_grads(*inp, act, torch.bfloat16)
    for name, g, w in zip(("dx", "dwn", "dwg", "dwu", "dwd"), got, want):
        assert np.linalg.norm(g - w) / np.linalg.norm(w) < 1e-2, name
    np.testing.assert_allclose(got[0], want[0], atol=3e-2, rtol=2e-2)


@pytest.mark.parametrize("act", ACTS)
def test_norm_mlp_backward_matches_autograd_of_the_plain_forward(act):
    """fp32: the hand-written formula against autograd through
    `norm_mlp_ref` (two derivations of one function)."""
    x, wn, wg, wu, wd, dout = _inputs(seed=2)
    t = torch.from_numpy
    leaves = [t(x).requires_grad_(), t(wn).requires_grad_()]
    leaves += [t(w.T.copy()).requires_grad_() for w in (wg, wu, wd)]
    want = torch.autograd.grad(tmlp.norm_mlp_ref(*leaves, EPS, act), leaves, t(dout))
    got = tmlp.norm_mlp_bwd_ref(*(leaf.detach() for leaf in leaves), t(dout), EPS, act)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("act", ACTS)
def test_activation_derivative_is_the_derivative(act):
    x = torch.linspace(-6, 6, 241, dtype=torch.float64).requires_grad_()
    (want,) = torch.autograd.grad(tmlp.act_fn(act)(x).sum(), x)
    got = tmlp.act_grad_fn(act)(x.detach())
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-9, rtol=1e-9)


def test_function_saves_inputs_only():
    """(x, wn, wg, wu, wd) and nothing of the [N, F] intermediates."""
    x, wn, wg, wu, wd, _ = _inputs(seed=3)
    t = torch.from_numpy
    leaves = [t(x).requires_grad_(), t(wn).requires_grad_()]
    leaves += [t(w.T.copy()).requires_grad_() for w in (wg, wu, wd)]
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda s: saved.append(s.shape) or s, lambda s: s):
        tmlp.fused_norm_mlp(*leaves, EPS, "gelu")
    assert sorted(saved) == sorted(leaf.shape for leaf in leaves)
