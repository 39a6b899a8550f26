"""The port's norm-fused MLP against the JAX package's, on the CPU.

The JAX kernel (`_norm_mlp_kernel`) runs in the Pallas interpreter; the
port runs the kernel's plain version (CPU tensors). fp32 unless stated.
The Pallas kernel's gelu uses an approximate erf (|error| <= 1.5e-7), the
port the exact one, so the two agree to about 1e-6; against the plain XLA
path (`_rms_norm_ref` + `xla_mlp` + the residual), which uses the exact erf
too, they differ only in the order of fp32 sums (1e-5 is loose).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphgpt_tpu.models.modeling import _rms_norm_ref
from graphgpt_tpu.ops import mlp as jmlp
from graphgpt_torch.ops import mlp as tmlp

ACTS = ["gelu", "gelu_pytorch_tanh", "silu"]
EPS = 1e-6


def _inputs(n=64, d=128, f=512, seed=0):
    """x [N, D]; wn [D]; wg, wu [D, F] and wd [F, D] in the JAX layout."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    wn = (1.0 + 0.1 * rng.normal(size=d)).astype(np.float32)
    wg = (rng.normal(size=(d, f)) * 0.05).astype(np.float32)
    wu = (rng.normal(size=(d, f)) * 0.05).astype(np.float32)
    wd = (rng.normal(size=(f, d)) * 0.05).astype(np.float32)
    return x, wn, wg, wu, wd


def _port(x, wn, wg, wu, wd, act, dtype=torch.float32):
    """The port's wrapper on CPU tensors, weights in nn.Linear layout."""
    t = torch.from_numpy
    return tmlp.fused_norm_mlp(
        t(x).to(dtype), t(wn), t(wg.T.copy()), t(wu.T.copy()), t(wd.T.copy()), EPS, act
    )


@pytest.mark.parametrize("act", ACTS)
def test_norm_mlp_plain_matches_interpreted_kernel(act, monkeypatch):
    monkeypatch.setenv("GGT_PALLAS_INTERPRET", "1")
    x, wn, wg, wu, wd = _inputs()
    want = np.asarray(
        jmlp.fused_norm_mlp(*(jnp.asarray(a) for a in (x, wn, wg, wu, wd)), EPS, act)
    )
    got = _port(x, wn, wg, wu, wd, act).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("act", ACTS)
def test_norm_mlp_plain_matches_xla_path(act):
    x, wn, wg, wu, wd = _inputs(seed=1)
    jx = jnp.asarray(x)
    hpre = _rms_norm_ref(jx, jnp.asarray(wn), EPS)
    want = np.asarray(jx + jmlp.xla_mlp(hpre, jnp.asarray(wg), jnp.asarray(wu), jnp.asarray(wd), act))
    got = _port(x, wn, wg, wu, wd, act).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("act", ACTS)
def test_mlp_ref_matches_xla_mlp(act):
    x, _, wg, wu, wd = _inputs(seed=2)
    want = np.asarray(jmlp.xla_mlp(*(jnp.asarray(a) for a in (x, wg, wu, wd)), act))
    t = torch.from_numpy
    got = tmlp.xla_mlp(t(x), t(wg.T.copy()), t(wu.T.copy()), t(wd.T.copy()), act).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("act", ACTS)
def test_norm_mlp_bf16_matches_interpreted_kernel(act, monkeypatch):
    """bf16 activations over fp32 weights, as the model runs: both round at
    the same five points, so they differ where a rounding flips (a bf16 ulp
    of the output, 2**-7 relative)."""
    monkeypatch.setenv("GGT_PALLAS_INTERPRET", "1")
    x, wn, wg, wu, wd = _inputs(seed=3)
    jx = jnp.asarray(x, jnp.bfloat16)
    want = jmlp.fused_norm_mlp(jx, *(jnp.asarray(a) for a in (wn, wg, wu, wd)), EPS, act)
    got = _port(x, wn, wg, wu, wd, act, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=2e-2, rtol=2e-2
    )


def test_norm_mlp_ref_rounds_where_the_kernel_does():
    """In bf16 the plain version equals a hand-rounded fp64 evaluation of
    the kernel's formula: hpre, xg, xu, a and g rounded, the residual added
    before the one final rounding."""
    x, wn, wg, wu, wd = _inputs(n=16, seed=4)
    t = torch.from_numpy
    xb = t(x).to(torch.bfloat16)
    got = tmlp.norm_mlp_ref(
        xb, t(wn), t(wg.T.copy()).to(torch.bfloat16), t(wu.T.copy()).to(torch.bfloat16),
        t(wd.T.copy()).to(torch.bfloat16), EPS, "silu",
    )

    def r(a):
        return a.to(torch.bfloat16).double()

    x64 = xb.double()
    hpre = r(x64 * torch.rsqrt((x64**2).mean(-1, keepdim=True) + EPS) * t(wn).double())
    xg = r(hpre @ r(t(wg).double()))
    xu = r(hpre @ r(t(wu).double()))
    g = r(r(xg * torch.sigmoid(xg)) * xu)
    want = (x64 + g @ r(t(wd).double())).to(torch.bfloat16)
    # sums in fp32 against fp64: a rounding may flip at a tie-near value
    assert (got.float() != want.float()).float().mean() < 0.02
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=1e-2)


def test_cpu_wrapper_counts_no_launch():
    x, wn, wg, wu, wd = _inputs(n=8)
    before = tmlp.norm_mlp.launches
    out = _port(x, wn, wg, wu, wd, "gelu")
    assert out.shape == x.shape and tmlp.norm_mlp.launches == before


def test_unknown_activation_raises():
    with pytest.raises(ValueError):
        tmlp.act_fn("relu6")


@pytest.mark.parametrize("n, d, f, tiles", [
    (8192, 768, 3072, (128, 192)),     # GraphGPT-base, serving (8 x 1024 rows)
    (18432, 768, 3072, (128, 128)),    # fine-tune and position batches (256 x 72)
    (22528, 768, 3072, (128, 256)),    # denoise batch (256 x 88)
    (65536, 768, 3072, (128, 256)),    # training (64 x 1024)
    (65537, 768, 3072, (128, 256)),    # a ragged row tile
    (8192, 384, 384, (128, 192)),      # small12
    (65536, 384, 384, (128, 192)),
    (8192, 128, 512, (128, 64)),       # the tiny configs
    (65536, 128, 512, (128, 128)),
    (8192, 256, 1024, (128, 128)),     # mini
    (65536, 256, 1024, (128, 256)),
    (8192, 768, 2112, (64, 192)),      # F a multiple of 64, not of 128
    (200, 768, 3072, (64, 64)),        # one row tile: the narrowest tiles fill the most SMs
    (8192, 100, 3072, (128, 0)),       # no width divides D
])
def test_mlp_tiles_spread_the_work_over_the_sms(n, d, f, tiles):
    """The MLP kernels' tile widths on an H100's 132 SMs: of the widths that
    divide F (gate/up: 128, 64) and D (down: 256, 192, 128, 64), the one
    whose busiest SM does the least work, the wider on a tie; 0 for none."""
    assert tmlp.mlp_tiles(n, d, f, 132) == tiles
    bh, bn = tiles
    assert (bh == 0 or f % bh == 0) and (bn == 0 or d % bn == 0)
