"""The numeric design of the fp32 split backward #4f / #5f
(`csrc/flash_bwd_split_f32.cu`) against the JAX package, on the CPU.

The CUDA pair takes every product (S = q k^T, dP = do v^T, dq = ds k,
dk = ds^T q, dv = p^T do) as three TF32 products: each operand split into
hi = x rounded to TF32 and lo = (x - hi) rounded to TF32 (nearest, ties
away, as `cvt.rna.tf32.f32`), then a_hi b_hi + a_hi b_lo + a_lo b_hi
summed in fp32 (`csrc/tf32x3.cuh`); p = 2^(S log2 e - lse log2 e). Here
that arithmetic is emulated in torch, rounding to TF32 by bits, and held
against `_dq_kernel_single` and `_dkv_kernel_single` interpreted in fp32
(GGT_PALLAS_INTERPRET=1; the bidirectional and causal masks reach them
with `_MAX_SINGLE_BLOCK` set below P, the bi-causal one through
`_flash_bwd`'s own route), at the denoise width: B 2 x P 88, 2 heads of
64, RoPE on, packed rows with a padded stretch, a cotangent of lse. dq,
delta, dk and dv must lie within 2e-5 in the relative Frobenius norm (the
card's F32_REL), and the same emulation with one TF32 product (a_hi b_hi)
past it: the split is what keeps the pair fp32-accurate. Cost: ~3 s a
case on one worker, most of it the interpreted JAX kernels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphgpt_tpu.models.rope import rope_cos_sin as j_rope_cos_sin
from graphgpt_tpu.ops import flash_attention as jfa
from graphgpt_torch.ops import flash_attention as tfa
from graphgpt_torch.synthetic import packed_segments

F32_REL = 2e-5  # chip_smoke.py's tolerance of the fp32 forms against their plain versions
B, P, H, DH, BI = 2, 88, 2, 64, 16
LOG2E = 1.4426950408889634
MASKS = {"bidirectional": (False, 0), "causal": (True, 0), "bi-causal": (False, BI)}


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to TF32's 10-bit mantissa (to nearest, ties away)."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return ah @ bh + ah @ bl + al @ bh


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32(a) @ tf32(b)


def emulated_pair(qs, k, v, do, out, seg, cos, sin, lse, dlse, causal, bi, mm):
    """(dq, delta, dk, dv) of the CUDA pair's arithmetic with `mm` for every
    product: RoPE with the plain roundings, do zero on padded rows, delta =
    rowsum(do * out) - dlse, p = 2^(S log2 e - lse log2 e) and ds = p (dP -
    delta) where the mask lets a pair through, dq and dk through the inverse
    rotation."""
    heads = tfa._heads
    q4 = heads(tfa.rotate_tokens(qs, cos, sin, DH), DH)
    k4 = heads(tfa.rotate_tokens(k, cos, sin, DH), DH)
    do = tfa.zero_padded_rows(do, seg)
    do4, v4 = heads(do, DH), heads(v, DH)
    delta = tfa.flash_delta(do, out, dlse, DH)
    s = mm(q4, k4.transpose(-1, -2))
    dp = mm(do4, v4.transpose(-1, -2))
    valid = tfa._valid_mask(seg, causal, bi) & (seg > 0)[:, None, :, None]
    l2e = torch.tensor(LOG2E, dtype=torch.float32)
    p = torch.where(valid, torch.exp2(s * l2e - lse[..., None] * l2e), 0.0)
    ds = torch.where(valid, p * (dp - delta[..., None]), 0.0)

    def back(x):
        return tfa.unrotate_tokens(tfa._tokens(x), cos, sin, DH)

    return (back(mm(ds, k4)), delta, back(mm(ds.transpose(-1, -2), q4)),
            tfa._tokens(mm(p.transpose(-1, -2), do4)))


def _rel(a, b) -> float:
    a, b = torch.as_tensor(np.array(a, np.float32)), torch.as_tensor(np.array(b, np.float32))
    return ((a - b).norm() / b.norm()).item()


@pytest.mark.parametrize("mask", list(MASKS))
def test_3xtf32_pair_matches_the_interpreted_kernels(mask, monkeypatch):
    monkeypatch.setenv("GGT_PALLAS_INTERPRET", "1")
    causal, bi = MASKS[mask]
    # the single-block pair for every mask: with P above the fused kernel's
    # limit, _flash_bwd launches _dq_kernel_single and _dkv_kernel_single
    monkeypatch.setattr(jfa, "_MAX_SINGLE_BLOCK", P - 1)
    ran = []
    for name in ("_dq_kernel_single", "_dkv_kernel_single"):
        kernel = getattr(jfa, name)

        def spy(*refs, _kernel=kernel, _name=name, **kw):
            ran.append(_name)
            return _kernel(*refs, **kw)

        monkeypatch.setattr(jfa, name, spy)
    rng = np.random.default_rng(23)
    q, k, v, do = ((rng.normal(size=(B, P, H * DH)) * 0.5).astype(np.float32) for _ in range(4))
    qs = q * DH**-0.5
    seg = packed_segments(B, P, rng)
    seg[-1, P - 24 : P - BI] = 0  # a padded stretch before the last row's end
    pos = np.tile(np.arange(P, dtype=np.int32), (B, 1))
    cos, sin = (np.asarray(a, np.float32) for a in j_rope_cos_sin(jnp.asarray(pos), DH))
    dlse = (rng.normal(size=(B, H, P)) * 0.3).astype(np.float32) * (seg > 0)[:, None, :]
    jseg, jrope = jnp.asarray(seg), (jnp.asarray(cos), jnp.asarray(sin))
    bq, bk = jfa._fwd_blocks(P)
    out, lse = jfa._flash_fwd(jnp.asarray(qs), jnp.asarray(k), jnp.asarray(v), jseg, jseg, causal,
                              bq, bk, H, DH, bi_split=bi, rope=jrope)
    want = jfa._flash_bwd(jnp.asarray(qs), jnp.asarray(k), jnp.asarray(v), jseg, jseg, out, lse,
                          jnp.asarray(do), causal, H, DH, dlse=jnp.asarray(dlse), bi_split=bi,
                          rope=jrope)
    assert set(ran) == {"_dq_kernel_single", "_dkv_kernel_single"}
    want_delta = np.einsum("bphd,bphd->bhp", do.reshape(B, P, H, DH),
                           np.asarray(out).reshape(B, P, H, DH)) - dlse
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    args = (t(qs), t(k), t(v), t(do), t(out), torch.from_numpy(seg), t(cos), t(sin), t(lse),
            t(dlse), causal, bi)
    got = emulated_pair(*args, mm_3xtf32)
    one = emulated_pair(*args, mm_tf32)
    wants = (want[0], want_delta, want[1], want[2])
    for name, g, w in zip(("dq", "delta", "dk", "dv"), got, wants):
        assert _rel(g, w) < F32_REL, (name, _rel(g, w))
        if name != "delta":  # delta takes no product
            assert bool((g[torch.from_numpy(seg == 0)] == 0).all()), name
    for name, g, w in zip(("dq", "dk", "dv"), one[:1] + one[2:], want):
        assert _rel(g, w) > F32_REL, (name, _rel(g, w))
