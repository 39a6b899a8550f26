"""The port's flash attention against the JAX package's, on the CPU.

The JAX kernel runs in the Pallas interpreter (GGT_PALLAS_INTERPRET=1);
the port runs the kernel's plain version (CPU tensors). fp32 throughout,
tolerance 2e-5: the two differ only in the order of fp32 sums. The CUDA
kernel is held against its plain version in tests/test_torch_gpu.py.

Head width 32 (`model.size` tiny6 and small12): the JAX package pads every
head to `_PAD_DH` = 64 before its kernels and rotates q and k outside them
(`JaxHeads`, which the other flash test files take too); the port's plain
route stays at dh 32, and on the kernels' route `flash_attention` pads as
JAX's does (`test_the_cuda_routes_padding_*`, on CPU tensors).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphgpt_tpu.models.rope import apply_rope as j_apply_rope
from graphgpt_tpu.models.rope import rope_cos_sin as j_rope_cos_sin
from graphgpt_tpu.ops import flash_attention as jfa
from graphgpt_tpu.ops.attention import attention as j_attention
from graphgpt_tpu.ops.attention import xla_attention
from graphgpt_torch.models.rope import apply_rope, rope_cos_sin
from graphgpt_torch.ops import flash_attention as tfa
from graphgpt_torch.ops.attention import attention, attention_ref
from graphgpt_torch.synthetic import packed_segments

TOL = 2e-5
DHS = [32, 64]  # head widths: 32 padded to 64 by the JAX package (and the port's CUDA route)


class JaxHeads:
    """Token-major q (pre-scaled), k, v as the JAX package's
    `flash_attention` hands them to its kernels at head width dh: below
    `_PAD_DH` q and k rotated outside (`apply_rope`, :1249) and every head
    zero padded (`_prep` :1217), the kernels then at `dh_k` = 64 without
    RoPE. `cut` takes an output back to dh, `back` carries the kernels'
    (dq, dk, dv) back to dh and through the rotation's transpose (the VJP
    of `apply_rope`), `pad` pads a cotangent such as do."""

    def __init__(self, qs, k, v, rope, h: int, dh: int):
        self.b, self.p = qs.shape[:2]
        self.h, self.dh, self.vjp = h, dh, None
        if dh >= jfa._PAD_DH:
            self.qs, self.k, self.v, self.rope, self.dh_k = qs, k, v, rope, dh
            return
        q4, k4 = self._heads(qs, dh), self._heads(k, dh)
        if rope is not None:
            (q4, k4), self.vjp = jax.vjp(lambda a, c: j_apply_rope(a, c, *rope), q4, k4)
        self.dh_k, self.rope = jfa._PAD_DH, None
        self.qs, self.k, self.v = self._pad4(q4), self._pad4(k4), self.pad(v)

    def _heads(self, a, dh):
        return a.reshape(self.b, self.p, self.h, dh)

    def _pad4(self, a):
        return jnp.pad(a, [(0, 0)] * 3 + [(0, self.dh_k - self.dh)]).reshape(self.b, self.p, -1)

    def pad(self, a):
        return a if self.dh_k == self.dh else self._pad4(self._heads(a, self.dh))

    def cut(self, a):
        if self.dh_k == self.dh:
            return a
        return self._heads(a, self.dh_k)[..., : self.dh].reshape(self.b, self.p, -1)

    def back(self, dq, dk, dv):
        dq, dk, dv = self.cut(dq), self.cut(dk), self.cut(dv)
        if self.vjp is not None:
            dq, dk = (a.reshape(self.b, self.p, -1) for a in self.vjp(
                (self._heads(dq, self.dh), self._heads(dk, self.dh))))
        return dq, dk, dv


def _inputs(b=2, p=128, h=2, hkv=2, dh=64, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(b, p, h, dh)) * 0.5).astype(np.float32)
    k = (rng.normal(size=(b, p, hkv, dh)) * 0.5).astype(np.float32)
    v = (rng.normal(size=(b, p, hkv, dh)) * 0.5).astype(np.float32)
    seg = packed_segments(b, p, rng)
    seg[-1, p - 24 :] = 0  # padded tail
    pos = np.tile(np.arange(p, dtype=np.int32), (b, 1))
    return q, k, v, seg, pos


def _rope_np(pos, dh):
    cos, sin = j_rope_cos_sin(jnp.asarray(pos), dh)
    return np.asarray(cos), np.asarray(sin)


@pytest.mark.parametrize("dh", DHS)
@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_matches_interpreted_kernel(causal, dh, monkeypatch):
    monkeypatch.setenv("GGT_PALLAS_INTERPRET", "1")
    q, k, v, seg, pos = _inputs(dh=dh)
    cos, sin = _rope_np(pos, dh)
    b, p, h, _ = q.shape
    jq, jk = jnp.asarray(q), jnp.asarray(k)
    rope = (jnp.asarray(cos), jnp.asarray(sin))
    if dh < jfa._PAD_DH:  # flash_attention :1249: rotated outside below _PAD_DH
        jq, jk = j_apply_rope(jq, jk, *rope)
        rope = None
    qs, kf, vf, dh_k = jfa._prep(jq, jk, jnp.asarray(v), None)
    assert dh_k == 64
    bq, bk = jfa._fwd_blocks(p)
    want_out, want_lse = jfa._flash_fwd(
        qs, kf, vf, jnp.asarray(seg), jnp.asarray(seg), causal, bq, bk, h, dh_k, rope=rope)
    t = torch.from_numpy
    out, lse = tfa.flash_attention(
        t(q), t(k), t(v), t(seg), causal=causal, rope=(t(cos), t(sin)), return_lse=True
    )
    want_out = np.asarray(want_out).reshape(b, p, h, dh_k)[..., :dh]
    np.testing.assert_allclose(out.numpy(), want_out, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=TOL, rtol=TOL)
    assert np.all(lse.numpy()[-1, :, -24:] == -1e30)
    assert np.all(out.numpy()[-1, -24:] == 0)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_matches_xla_attention(causal):
    q, k, v, seg, pos = _inputs(seed=1)
    cos, sin = _rope_np(pos, 64)
    jq, jk = j_apply_rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(cos), jnp.asarray(sin))
    want = np.asarray(xla_attention(jq, jk, jnp.asarray(v), jnp.asarray(seg), causal))
    t = torch.from_numpy
    got = tfa.flash_attention(t(q), t(k), t(v), t(seg), causal=causal, rope=(t(cos), t(sin)))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    tq, tk = apply_rope(t(q), t(k), t(cos), t(sin))
    ref = attention_ref(tq, tk, t(v), t(seg), causal)
    np.testing.assert_allclose(ref.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("bi_split", [0, 16])
def test_attention_dispatch_gqa_and_windows(bi_split):
    """GQA repeat, attn_block windows and the bi-causal mask of the port's
    dispatcher against the JAX dispatcher's XLA path."""
    q, k, v, seg, pos = _inputs(h=4, hkv=2, seed=2)
    seg = packed_segments(2, 128, np.random.default_rng(3), block=64)
    cos, sin = _rope_np(pos, 64)
    block = 0 if bi_split else 64
    want = np.asarray(
        j_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg), impl="xla",
            bi_causal_split=bi_split, attn_block=block,
            rope=(jnp.asarray(cos), jnp.asarray(sin)),
        )
    )
    t = torch.from_numpy
    got = attention(
        t(q), t(k), t(v), t(seg), bi_causal_split=bi_split, attn_block=block,
        rope=(t(cos), t(sin)),
    )
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_rope_cos_sin_feeds_the_same_tables():
    _, _, _, _, pos = _inputs()
    cos, sin = rope_cos_sin(torch.from_numpy(pos), 64)
    jcos, jsin = _rope_np(pos, 64)
    np.testing.assert_allclose(cos.numpy(), jcos, atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), jsin, atol=1e-6)


def test_bf16_rotation_is_apply_rope():
    """The kernel's rotation (each product and the sum rounded to bf16) is
    exactly apply_rope in bf16, and within one bf16 rounding of JAX's."""
    q, k, _, _, pos = _inputs(seed=4)
    cos, sin = _rope_np(pos, 64)
    t = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    b, p, h, dh = q.shape
    rq = tfa.rotate_tokens(t(q).reshape(b, p, h * dh), t(cos), t(sin), dh)
    aq, _ = apply_rope(t(q), t(k), t(cos), t(sin))
    assert torch.equal(rq.view(b, p, h, dh), aq)
    jq, _ = j_apply_rope(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(cos), jnp.asarray(sin),
    )
    np.testing.assert_allclose(
        aq.float().numpy(), np.asarray(jq, np.float32), atol=2e-2, rtol=1e-2
    )


def test_cpu_wrapper_runs_the_plain_version():
    q, k, v, seg, pos = _inputs()
    t = torch.from_numpy
    before = tfa.flash_fwd.launches
    out, lse = tfa.flash_fwd(
        t(q).reshape(2, 128, 128), t(k).reshape(2, 128, 128), t(v).reshape(2, 128, 128),
        t(seg), None, None, False, 64,
    )
    assert tfa.flash_fwd.launches == before
    assert out.shape == (2, 128, 128) and lse.shape == (2, 2, 128)


def _molecule_rows(b, p, bi, rng):
    """Rows as the fine-tune, position and denoise batches lay them out: one
    molecule (one segment) at the front, then padding; with `bi` bit slots,
    the last `bi` positions belong to the molecule's segment too."""
    seg = np.zeros((b, p), np.int32)
    for r in range(b):
        seg[r, : int(rng.integers(10, p - bi - 4))] = 1
        if bi:
            seg[r, p - bi :] = 1
    return seg


@pytest.mark.parametrize("p", [72, 88])
@pytest.mark.parametrize("mask", ["bidirectional", "causal", "bi-causal"])
def test_flash_plain_matches_interpreted_kernel_on_whole_molecules(p, mask, monkeypatch):
    """flash_fwd's plain version against the interpreted
    `_fwd_kernel_single` at the widths where #1 runs whole rows (the
    fine-tune and position batches' P 72, the denoise batch's P 88): one
    molecule a row and a padded stretch, bi-causal with 16 bit slots
    (split 56 or 72, inside a 64-row tile); fp32, the file's tolerance."""
    monkeypatch.setenv("GGT_PALLAS_INTERPRET", "1")
    b, h, dh = 2, 2, 64
    causal, bi = {"bidirectional": (False, 0), "causal": (True, 0), "bi-causal": (False, 16)}[mask]
    rng = np.random.default_rng(31)
    q, k, v = ((rng.normal(size=(b, p, h * dh)) * 0.5).astype(np.float32) for _ in range(3))
    qs = q * dh**-0.5
    seg = _molecule_rows(b, p, bi, rng)
    cos, sin = (np.array(a) for a in _rope_np(np.tile(np.arange(p, dtype=np.int32), (b, 1)), dh))
    bq, bk = jfa._fwd_blocks(p)
    assert bk == p  # one key block: the single-block kernel
    jseg = jnp.asarray(seg)
    want_out, want_lse = jfa._flash_fwd(
        jnp.asarray(qs), jnp.asarray(k), jnp.asarray(v), jseg, jseg, causal, bq, bk, h, dh,
        bi_split=bi, rope=(jnp.asarray(cos), jnp.asarray(sin)))
    t = torch.from_numpy
    out, lse = tfa.flash_fwd(t(qs), t(k), t(v), t(seg), t(cos), t(sin), causal, dh, bi)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=TOL, rtol=TOL)
    valid = np.broadcast_to((seg > 0)[:, None, :], lse.shape)
    np.testing.assert_allclose(lse.numpy()[valid], np.asarray(want_lse)[valid], atol=TOL,
                               rtol=TOL)
    assert np.all(lse.numpy()[~valid] == -1e30)
    assert np.all(out.numpy()[seg == 0] == 0)


H3 = 3  # heads of 32


def _padded_inputs(dtype, seed=41, b=2, p=128, h=H3):
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy((rng.normal(size=(b, p, h, 32)) * 0.5)
                                    .astype(np.float32)).to(dt) for _ in range(4))
    seg = packed_segments(b, p, rng)
    seg[-1, p - 40:p - 16] = 0
    cos, sin = (torch.from_numpy(np.array(a)).to(dt) for a in _rope_np(
        np.tile(np.arange(p, dtype=np.int32), (b, 1)), 32))
    return q, k, v, do, torch.from_numpy(seg), cos, sin


def _routes(monkeypatch, fn):
    """fn() on the plain route at dh 32, then on the kernels' route as
    `flash_attention` takes it at dh 32, run as plain tensors on the CPU:
    `use_kernel` says yes to its [B, P, H, 32] heads only, so it rotates,
    pads and cuts, and the wrappers, handed heads of 64, take their plain
    versions (each call's head width recorded)."""
    plain = fn()
    widths = []
    with monkeypatch.context() as m:
        m.setattr(tfa, "use_kernel", lambda *ts: ts[0].dim() == 4 and ts[0].shape[-1] == 32)
        for name in ("flash_fwd", "flash_bwd"):
            real = getattr(tfa, name)
            m.setattr(tfa, name, lambda *a, real=real: widths.append(a[11 if len(a) > 9 else 7])
                      or real(*a))
        padded = fn()
    assert widths and set(widths) == {tfa.KERNEL_DH}, widths
    return plain, padded


def _same(a, b, dtype, name):
    a, b = a.float().numpy(), b.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(b, a, atol=1e-5, rtol=1e-5, err_msg=name)
    else:
        np.testing.assert_allclose(b, a, atol=1e-2, rtol=1e-2, err_msg=name)
        assert np.linalg.norm(a - b) <= 1e-3 * np.linalg.norm(a), name


# mode, causal, bi-causal split: the wrappers each takes (#1 and #3; #1 with
# the split pair #4, #5; the stream forms #6-#8; the band forms #9, #10)
PAD_FORMS = {"single": ("legacy", True, 0), "split": ("legacy", False, 16),
             "stream": ("skip", True, 0), "band": ("band", False, 16)}


@pytest.mark.parametrize("form", list(PAD_FORMS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_cuda_routes_padding_matches_the_plain_route_at_dh_32(dtype, form, monkeypatch):
    """flash_attention at dh 32 with RoPE on the kernels' route, run as
    plain tensors on the CPU through each form's wrappers: q and k rotated
    outside (on both routes), q, k and v zero padded to 64, the wrappers at
    64 without RoPE, out cut back to 32, autograd carrying the pad and the
    cut. out, lse and every gradient (lse with a cotangent too) against the
    plain route at dh 32, which the zero lanes leave alone up to the order
    of the sums; rows padded as queries exactly 0."""
    mode, causal, bi = PAD_FORMS[form]
    monkeypatch.setattr(tfa, "_MODE", mode)
    monkeypatch.setattr(tfa, "REF_ROWS", 64)
    q, k, v, do, seg, cos, sin = _padded_inputs(dtype)
    valid = (seg > 0)[:, None, :]

    def run():
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out, lse = tfa.flash_attention(*leaves, seg, causal=causal, bi_causal_split=bi,
                                       rope=(cos, sin), return_lse=True)
        loss = (out.float() * do.float()).sum() + 0.1 * torch.where(valid, lse, 0).sum()
        loss.backward()
        return [out.detach(), lse.detach()] + [t.grad for t in leaves]

    plain, padded = _routes(monkeypatch, run)
    for name, a, g in zip(("out", "lse", "dq", "dk", "dv"), plain, padded):
        assert a.shape == g.shape and a.dtype == g.dtype, name
        _same(a, g, dtype, name)
    assert torch.all(padded[0][seg == 0] == 0) and torch.all(padded[2][seg == 0] == 0)


def test_flash_attention_on_the_padded_route_matches_the_plain_route():
    """flash_attention at dh 32 with grouped keys (4 query heads on 2 key
    and value heads) and a softmax scale of its own, forward and every
    gradient through autograd, the kernels' route's padding against the
    plain route; fp32."""
    q, k, v, do, seg, cos, sin = _padded_inputs("float32", seed=43, h=4)

    def run():
        leaves = [q.clone().requires_grad_()] + [t[:, :, :2].clone().requires_grad_()
                                                 for t in (k, v)]
        out = tfa.flash_attention(*leaves, seg, softmax_scale=0.2, rope=(cos, sin))
        (out * do).sum().backward()
        return [out.detach()] + [x.grad for x in leaves]

    with pytest.MonkeyPatch.context() as m:
        plain, padded = _routes(m, run)
    for name, a, g in zip(("out", "dq", "dk", "dv"), plain, padded):
        np.testing.assert_allclose(g.numpy(), a.numpy(), atol=1e-5, rtol=1e-5, err_msg=name)


def test_a_head_wider_than_the_kernels_raises_on_the_cuda_route(monkeypatch):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(1, 64, 2 * 128)).astype(np.float32)).bfloat16()
    seg = torch.ones(1, 64, dtype=torch.int32)
    monkeypatch.setattr(tfa, "use_kernel", lambda *ts: True)
    with pytest.raises(NotImplementedError, match="head_dim 64"):
        tfa.flash_fwd(x, x, x, seg, None, None, False, 128)
    with pytest.raises(NotImplementedError, match="head_dim 64"):
        tfa.flash_bwd(x, x, x, seg, None, None, x, torch.zeros(1, 2, 64), x, None, False, 128)
