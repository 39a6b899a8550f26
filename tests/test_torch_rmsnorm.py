"""The port's RMSNorm (forward and backward) against the JAX package's.

The port's `rms_norm` is a `torch.autograd.Function` whose backward runs
`rmsnorm_bwd` (the CUDA kernel on the card, `rmsnorm_bwd_ref` here on the
CPU). It is held against `_rms_norm_vjp` (the custom-VJP formula) and the
Pallas kernel `rmsnorm_bwd_pallas` run in the interpreter. fp32: sums in
another order, 1e-5 on dx and 1e-4 relative on dw (a sum over N rows). bf16:
dx is rounded once on both sides, 1 ulp (rtol 1e-2, atol 1e-2); dw is fp32
on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphgpt_tpu.models.modeling import _rms_norm_vjp
from graphgpt_tpu.ops.mlp import rmsnorm_bwd_pallas
from graphgpt_torch.models.modeling import rms_norm
from graphgpt_torch.ops import mlp as tmlp

EPS = 1e-6


def _inputs(n=96, d=128, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32) * 1.5
    g = rng.normal(size=(n, d)).astype(np.float32)
    w = (1.0 + 0.1 * rng.normal(size=d)).astype(np.float32)
    return x, g, w


@pytest.mark.parametrize("shape", [(96, 128), (2, 48, 64)], ids=["2d", "3d"])
def test_rms_norm_forward_and_grad_match_jax_vjp(shape):
    rng = np.random.default_rng(1)
    x = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    w = (1.0 + 0.1 * rng.normal(size=shape[-1])).astype(np.float32)
    want_y, vjp = jax.vjp(lambda x, w: _rms_norm_vjp(x, w, EPS, False), jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(g))
    tx, tw = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    y = rms_norm(tx, tw, EPS)
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want_dw), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_bwd_ref_matches_interpreted_kernel(dtype, monkeypatch):
    monkeypatch.setenv("GGT_PALLAS_INTERPRET", "1")
    x, g, w = _inputs(seed=2)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want_dx, want_dw = rmsnorm_bwd_pallas(jnp.asarray(x, jdt), jnp.asarray(g, jdt), jnp.asarray(w), EPS, bt=32)
    dx, dw = tmlp.rmsnorm_bwd(
        torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt), torch.from_numpy(w), EPS
    )
    assert dx.dtype == tdt and dw.dtype == torch.float32
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else dict(atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(dx.float().numpy(), np.asarray(want_dx, np.float32), **tol)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("n, d", [(64, 384), (40, 1600), (97, 768)],
                         ids=["d384", "d1600", "n97"])
def test_rmsnorm_bwd_ref_matches_interpreted_kernel_at_the_kernel_widths(n, d, monkeypatch):
    """bf16 at the hidden sizes of the CUDA kernel's 2- and 7-chunk
    instances, and at N 97, which no tile divides (the Pallas kernel halves
    its 32-row tile down to one row)."""
    monkeypatch.setenv("GGT_PALLAS_INTERPRET", "1")
    x, g, w = _inputs(n=n, d=d, seed=6)
    want_dx, want_dw = rmsnorm_bwd_pallas(jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16),
                                          jnp.asarray(w), EPS, bt=32)
    dx, dw = tmlp.rmsnorm_bwd(torch.from_numpy(x).to(torch.bfloat16),
                              torch.from_numpy(g).to(torch.bfloat16), torch.from_numpy(w), EPS)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    np.testing.assert_allclose(dx.float().numpy(), np.asarray(want_dx, np.float32), atol=1e-2,
                               rtol=1e-2)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw), atol=1e-4, rtol=1e-4)


def test_rms_blocks_fill_the_card_once():
    """The CUDA row pass's grid: a CTA for each 8 rows, at most two an SM
    (one above 768 columns), never none."""
    assert tmlp.rms_blocks(65536, 768, 132) == 264
    assert tmlp.rms_blocks(65536, 1600, 132) == 132
    assert tmlp.rms_blocks(100, 768, 132) == 13
    assert tmlp.rms_blocks(0, 768, 132) == 1


def test_rmsnorm_bwd_matches_autograd_of_the_plain_forward():
    x, g, w = _inputs(seed=3)
    tx, tw = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    x32 = tx.float()
    y = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + EPS) * tw
    want_dx, want_dw = torch.autograd.grad(y, (tx, tw), torch.from_numpy(g))
    before = tmlp.rmsnorm_bwd.launches
    dx, dw = tmlp.rmsnorm_bwd(tx.detach(), torch.from_numpy(g), tw.detach(), EPS)
    assert tmlp.rmsnorm_bwd.launches == before  # a CPU tensor runs the plain version
    np.testing.assert_allclose(dx.numpy(), want_dx.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(dw.numpy(), want_dw.numpy(), atol=1e-5, rtol=1e-4)
