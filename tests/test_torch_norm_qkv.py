"""The norm-fused q/k/v projections of the port against the JAX package's,
on the CPU: `fused_norm_qkv` (the plain version of the CUDA kernel #12
norm_qkv, which the port's wrapper runs on CPU tensors, and its backward
through rmsnorm_bwd's plain version) against `fused_norm_qkv` with the
Pallas kernel `_norm_qkv_kernel` run in the interpreter
(GGT_PALLAS_INTERPRET=1), which the test asserts ran. Weights cross in the
JAX package's [in, out] layout, transposed for the port's nn.Linear
[out, in]. The forward and every gradient (dx, dwn, dwq, dwk, dwv) for a
cotangent of each output; fp32 and bf16, multi-head and GQA widths, and an
N that is no multiple of the kernel's 512-row tiles; at the shapes the CUDA
kernel's tiling must take too: D 1600 (the widest hidden size of
`config._MODEL_SIZES`), widths 128/64/64 (its 64-wide tiles), N 1 and
N 129 (one row past a 128-row tile).

Tolerances: fp32, the sides differ in the order of fp32 sums, 2e-5
relative to each tensor's largest value. bf16: both round hpre, the
outputs, the three dhpre products and their sum at the same points, so
what is left is the order of the fp32 sums, which flips a bf16 rounding
here and there: 1e-2 in the relative Frobenius norm and 2 bf16 ulps of the
largest value elementwise. The weight gradients are fp32 sums of bf16
products on both sides: 1e-3 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphgpt_tpu.ops import mlp as jmlp
from graphgpt_torch.ops import mlp as tmlp

EPS = 1e-6


def _inputs(n, d, widths, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    wn = (1.0 + 0.1 * rng.normal(size=(d,))).astype(np.float32)
    ws = [(rng.normal(size=(d, w)) * 0.05).astype(np.float32) for w in widths]
    gs = [rng.normal(size=(n, w)).astype(np.float32) for w in widths]
    return x, wn, ws, gs


@pytest.mark.parametrize("dtype, n, d, widths", [
    ("float32", 320, 128, (128, 128, 128)),
    ("bfloat16", 320, 128, (128, 64, 64)),
    ("bfloat16", 1024, 128, (128, 128, 128)),
    ("float32", 200, 128, (128, 64, 64)),
    ("bfloat16", 300, 1600, (1600, 1600, 1600)),
    ("bfloat16", 1, 128, (128, 64, 64)),
    ("bfloat16", 129, 128, (128, 64, 64)),
], ids=["fp32-mha", "bf16-gqa", "bf16-mha-n1024", "fp32-gqa-n200", "bf16-d1600", "bf16-n1",
        "bf16-n129"])
def test_fused_norm_qkv_and_gradients_match_jax(dtype, n, d, widths, monkeypatch):
    monkeypatch.setenv("GGT_PALLAS_INTERPRET", "1")
    ran = []
    kernel = jmlp._norm_qkv_kernel

    def spy(*a, **kw):
        ran.append(1)
        return kernel(*a, **kw)

    monkeypatch.setattr(jmlp, "_norm_qkv_kernel", spy)
    x, wn, ws, gs = _inputs(n, d, widths, seed=n)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    # fp32 master weights on both sides, x and the cotangents in the compute dtype
    jx = jnp.asarray(x, jdt)
    want, vjp = jax.vjp(lambda x_, wn_, *w_: jmlp.fused_norm_qkv(x_, wn_, *w_, EPS),
                        jx, jnp.asarray(wn), *(jnp.asarray(w) for w in ws))
    want_grads = vjp(tuple(jnp.asarray(g, jdt) for g in gs))
    assert ran, "the JAX package did not run _norm_qkv_kernel"
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    twn = torch.from_numpy(wn).requires_grad_()
    tws = [torch.from_numpy(np.ascontiguousarray(w.T)).requires_grad_() for w in ws]
    got = tmlp.fused_norm_qkv(tx, twn, *tws, EPS)
    torch.autograd.backward(got, [torch.from_numpy(g).to(tdt) for g in gs])
    pairs = [(f"out{i}", o, w) for i, (o, w) in enumerate(zip(got, want))]
    pairs += [("dx", tx.grad, want_grads[0]), ("dwn", twn.grad, want_grads[1])]
    pairs += [(f"dw{i}", t.grad.t(), w) for i, (t, w) in enumerate(zip(tws, want_grads[2:]))]
    for name, g, w in pairs:
        g = g.detach().float().numpy()
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, name
        scale = np.abs(w).max()
        if dtype == "float32":
            np.testing.assert_allclose(g, w, atol=2e-5 * scale, rtol=2e-5, err_msg=name)
        elif name.startswith("dw"):  # fp32 sums of the same bf16 products
            np.testing.assert_allclose(g, w, atol=1e-3 * scale, rtol=1e-3, err_msg=name)
        else:
            assert np.linalg.norm(g - w) <= 1e-2 * np.linalg.norm(w), name
            np.testing.assert_allclose(g, w, atol=2 * 2**-8 * scale, rtol=0, err_msg=name)
    for o, w in zip(got, widths):
        assert o.dtype == tdt and o.shape == (n, w)


def test_norm_qkv_ref_rounds_hpre_and_each_output_once():
    """The plain version is the kernel's arithmetic: hpre rounded to bf16,
    each product summed in fp32 and rounded once."""
    x, wn, ws, _ = _inputs(64, 128, (64, 64, 64), seed=5)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    got = tmlp.norm_qkv(tx, torch.from_numpy(wn), *(torch.from_numpy(w.T.copy()).to(torch.bfloat16)
                                                     for w in ws), EPS)
    x32 = tx.float()
    hpre = (x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + EPS)
            * torch.from_numpy(wn)).to(torch.bfloat16).double()
    for o, w in zip(got, ws):
        want = (hpre @ torch.from_numpy(w).to(torch.bfloat16).double()).to(torch.bfloat16)
        assert (o.float() - want.float()).abs().max() <= 2**-8 * want.float().abs().max()


@pytest.mark.parametrize("widths, bn", [
    ((768, 768, 768), 256),
    ((768, 256, 256), 256),
    ((128, 64, 64), 64),
    ((192, 64, 64), 64),
    ((1600, 1600, 1600), 64),
    ((384, 128, 128), 128),
    ((100, 64, 64), 0),
])
def test_qkv_block_n_is_the_widest_tile_dividing_every_width(widths, bn):
    """The CUDA kernel's output tile width: the largest of 256, 128, 64 that
    divides all three widths (no tile straddles q, k and v); 0 for none."""
    assert tmlp.qkv_block_n(widths) == bn
