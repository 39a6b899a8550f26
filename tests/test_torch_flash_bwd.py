"""The port's flash attention backward against the JAX package's, on the CPU.

`flash_bwd_ref` (the plain version of the CUDA kernel, which the port's
wrapper runs on CPU tensors) is held against the fused Pallas backward run
in the interpreter (GGT_PALLAS_INTERPRET=1), against `jax.grad` of the
plain XLA attention, and against autograd of the port's own forward
reference. fp32: the sides differ only in the order of fp32 sums, 2e-5 is
loose. bf16: both round p, ds and the inverse rotation at the same points,
so they differ by a flipped bf16 rounding here and there: 2 ulps of the
largest value elementwise (atol 3e-2 on values up to ~4, rtol 2e-2), and
1e-2 in the relative Frobenius norm. The CUDA kernel is held against
`flash_bwd_ref` in tests/test_torch_gpu.py. Two cases run at head width
32, which the JAX package pads to 64 (`JaxHeads`).
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
from graphgpt_torch.ops import flash_attention as tfa
from graphgpt_torch.ops.attention import attention
from graphgpt_torch.synthetic import packed_segments
from test_torch_flash_attention import JaxHeads

TOL = 2e-5
B, P, H, DH = 2, 128, 2, 64


def _inputs(seed=0, h=H, hkv=H, block=0, dh=DH):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, P, h, dh)) * 0.5).astype(np.float32)
    k = (rng.normal(size=(B, P, hkv, dh)) * 0.5).astype(np.float32)
    v = (rng.normal(size=(B, P, hkv, dh)) * 0.5).astype(np.float32)
    do = (rng.normal(size=(B, P, h, dh)) * 0.5).astype(np.float32)
    seg = packed_segments(B, P, rng, block=block)
    seg[-1, P - 24 :] = 0  # padded tail
    pos = np.tile(np.arange(P, dtype=np.int32), (B, 1))
    cos, sin = j_rope_cos_sin(jnp.asarray(pos), dh)
    return q, k, v, do, seg, np.asarray(cos), np.asarray(sin)


def _flat(a):
    return a.reshape(B, P, -1)


def _bwd_case(dtype, causal, rope, with_dlse, dh):
    name = "-".join((("nodlse", "dlse")[with_dlse], ("norope", "rope")[rope],
                     ("bidirectional", "causal")[causal], dtype))
    return pytest.param(dtype, causal, rope, with_dlse, dh,
                        id=name if dh == DH else f"dh{dh}-{name}")


# every case at dh 64; two at dh 32, padded to 64 on the JAX side
BWD_CASES = [_bwd_case(dt, c, r, d, DH) for d in (False, True) for r in (True, False)
             for c in (False, True) for dt in ("float32", "bfloat16")] + [
    _bwd_case("bfloat16", True, True, True, 32), _bwd_case("float32", False, False, False, 32)]


@pytest.mark.parametrize("dtype, causal, rope, with_dlse, dh", BWD_CASES)
def test_flash_bwd_ref_matches_interpreted_kernel(dtype, causal, rope, with_dlse, dh,
                                                   monkeypatch):
    monkeypatch.setenv("GGT_PALLAS_INTERPRET", "1")
    q, k, v, do, seg, cos, sin = _inputs(seed=3, dh=dh)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    qs = _flat(q) * dh**-0.5
    dlse = None
    if with_dlse:
        dlse = (np.random.default_rng(9).normal(size=(B, H, P)) * 0.3).astype(np.float32)
        # the port leaves padded rows out of the backward; the JAX kernel
        # would spread a padded row's dlse over every key (see the module
        # docstring of graphgpt_torch/ops/flash_attention.py)
        dlse = dlse * (seg > 0)[:, None, :]
    j = lambda a: jnp.asarray(a, jdt)  # noqa: E731
    jrope = (j(cos), j(sin)) if rope else None
    jseg = jnp.asarray(seg)
    bq, bk = jfa._fwd_blocks(P)
    jh = JaxHeads(j(qs), j(_flat(k)), j(_flat(v)), jrope, H, dh)
    out, lse = jfa._flash_fwd(jh.qs, jh.k, jh.v, jseg, jseg, causal, bq, bk, H, jh.dh_k,
                              rope=jh.rope)
    want = jh.back(*jfa._flash_bwd(
        jh.qs, jh.k, jh.v, jseg, jseg, out, lse, jh.pad(j(_flat(do))), causal, H, jh.dh_k,
        dlse=None if dlse is None else jnp.asarray(dlse), rope=jh.rope,
    ))
    out = jh.cut(out)
    t = lambda a: torch.from_numpy(np.array(a, np.float32)).to(tdt)  # noqa: E731
    got = tfa.flash_bwd(
        t(qs), t(_flat(k)), t(_flat(v)), torch.from_numpy(seg),
        t(cos) if rope else None, t(sin) if rope else None,
        t(np.asarray(out, np.float32)), torch.from_numpy(np.array(lse)), t(_flat(do)),
        None if dlse is None else torch.from_numpy(dlse), causal, dh,
    )
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        assert g.shape == w.shape
        if dtype == "float32":
            np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, atol=3e-2, rtol=2e-2, err_msg=name)
            assert np.linalg.norm(g - w) / np.linalg.norm(w) < 1e-2, name
        # padded rows: exactly zero
        assert np.all(g[-1, P - 24 :] == 0), name


@pytest.mark.parametrize("causal", [False, True], ids=["bidirectional", "causal"])
def test_flash_attention_grad_matches_jax_grad_of_xla_attention(causal):
    q, k, v, do, seg, cos, sin = _inputs(seed=4)

    def f(q, k, v):
        rq, rk = j_apply_rope(q, k, jnp.asarray(cos), jnp.asarray(sin))
        out = xla_attention(rq, rk, v, jnp.asarray(seg), causal)
        return jnp.sum(out * jnp.asarray(do))

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    t = torch.from_numpy
    leaves = [t(a).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention(*leaves, t(seg), causal=causal, rope=(t(cos), t(sin)))
    (out * t(do)).sum().backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("causal", [False, True], ids=["bidirectional", "causal"])
@pytest.mark.parametrize("bi_split", [0, 16])
def test_flash_bwd_ref_matches_autograd_of_the_forward_reference(causal, bi_split):
    """The hand-written formula against autograd through the port's own
    plain forward (two derivations of one function)."""
    q, k, v, do, seg, cos, sin = _inputs(seed=5)
    t = torch.from_numpy
    qs = (t(_flat(q)) * DH**-0.5)
    leaves = [a.clone().requires_grad_() for a in (qs, t(_flat(k)), t(_flat(v)))]
    out, lse = tfa.flash_attention_ref(*leaves, t(seg), t(cos), t(sin), causal, DH, bi_split)
    want = torch.autograd.grad(out, leaves, t(_flat(do)))
    got = tfa.flash_bwd_ref(
        qs, t(_flat(k)), t(_flat(v)), t(seg), t(cos), t(sin), out.detach(), lse.detach(),
        t(_flat(do)), None, causal, DH, bi_split,
    )
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=TOL, rtol=TOL)


def test_flash_attention_grad_gqa_matches_jax():
    """GQA: the repeat's gradient (a sum over the group) is autograd's."""
    q, k, v, do, seg, cos, sin = _inputs(seed=6, h=4, hkv=2)

    def f(q, k, v):
        out = j_attention(q, k, v, jnp.asarray(seg), impl="xla",
                          rope=(jnp.asarray(cos), jnp.asarray(sin)))
        return jnp.sum(out * jnp.asarray(do))

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    t = torch.from_numpy
    leaves = [t(a).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention(*leaves, t(seg), rope=(t(cos), t(sin)))
    (out * t(do)).sum().backward()
    for leaf, w in zip(leaves, want):
        assert leaf.grad.shape == w.shape
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), atol=TOL, rtol=TOL)


def test_attention_grad_with_attn_block_windows_matches_jax():
    q, k, v, do, seg, cos, sin = _inputs(seed=7, block=64)

    def f(q, k, v):
        out = j_attention(q, k, v, jnp.asarray(seg), impl="xla", attn_block=64,
                          rope=(jnp.asarray(cos), jnp.asarray(sin)))
        return jnp.sum(out * jnp.asarray(do))

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    t = torch.from_numpy
    leaves = [t(a).requires_grad_() for a in (q, k, v)]
    out = attention(*leaves, t(seg), attn_block=64, rope=(t(cos), t(sin)))
    (out * t(do)).sum().backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("causal", [False, True], ids=["bidirectional", "causal"])
def test_grad_through_lse_matches_the_interpreted_chunk_kernel(causal, monkeypatch):
    """A loss that reads lse (as the ring combine does) sends its cotangent
    into the backward: against `flash_attention_chunk`, whose
    `_attach_grad_lse` hands dlse to the interpreted kernel. The weights on
    lse are zero on padded rows (see this module's dlse case above)."""
    monkeypatch.setenv("GGT_PALLAS_INTERPRET", "1")
    q, k, v, do, seg, _, _ = _inputs(seed=11)
    w = (np.random.default_rng(12).normal(size=(B, H, P)) * 0.3).astype(np.float32)
    w = w * (seg > 0)[:, None, :]

    def f(q, k, v):
        out, lse = jfa.flash_attention_chunk(q, k, v, jnp.asarray(seg), jnp.asarray(seg),
                                             causal=causal)
        return jnp.sum(out * jnp.asarray(do)) + jnp.sum(lse * jnp.asarray(w))

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    t = torch.from_numpy
    leaves = [t(a).requires_grad_() for a in (q, k, v)]
    out, lse = tfa.flash_attention(*leaves, t(seg), causal=causal, return_lse=True)
    ((out * t(do)).sum() + (lse * t(w)).sum()).backward()
    for leaf, g in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("use_out", [True, False], ids=["out+lse", "lse-only"])
def test_grad_through_lse_matches_autograd_of_the_forward_reference(use_out):
    """With RoPE, through `flash_attention`: the Function's backward (the
    hand-written formula with dlse) against autograd through the port's plain
    forward, for a loss on lse with and without one on out."""
    q, k, v, do, seg, cos, sin = _inputs(seed=13)
    w = (np.random.default_rng(14).normal(size=(B, H, P)) * 0.3).astype(np.float32)
    w = w * (seg > 0)[:, None, :]
    t = torch.from_numpy

    def loss(out, lse):
        return (lse * t(w)).sum() + ((out * t(do)).sum() if use_out else 0.0)

    leaves = [t(a).requires_grad_() for a in (q, k, v)]
    out, lse = tfa.flash_attention(*leaves, t(seg), rope=(t(cos), t(sin)), return_lse=True)
    assert lse.requires_grad
    loss(out, lse).backward()
    ref = [t(a).requires_grad_() for a in (q, k, v)]
    rout, rlse = tfa.flash_attention_ref(
        ref[0].reshape(B, P, -1) * DH**-0.5, ref[1].reshape(B, P, -1), ref[2].reshape(B, P, -1),
        t(seg), t(cos), t(sin), False, DH,
    )
    loss(rout.view(B, P, H, DH), rlse).backward()
    assert leaves[0].grad.abs().max() > 0 and leaves[1].grad.abs().max() > 0
    for leaf, r in zip(leaves, ref):
        # lse does not depend on v: autograd leaves that gradient out
        want = r.grad if r.grad is not None else torch.zeros_like(r)
        np.testing.assert_allclose(leaf.grad.numpy(), want.numpy(), atol=TOL, rtol=TOL)


def test_stash_keeps_out_and_lse_and_skips_the_forward(monkeypatch):
    """The rematerialisation contract of save_attn: a second call with a
    filled stash takes (out, lse) from it and does not run the forward."""
    q, k, v, do, seg, cos, sin = _inputs(seed=8)
    t = torch.from_numpy
    stash = {}
    out1 = tfa.flash_attention(t(q), t(k), t(v), t(seg), rope=(t(cos), t(sin)), stash=stash)
    assert set(stash) == {"out", "lse"}
    calls = []
    monkeypatch.setattr(tfa, "flash_fwd", lambda *a, **kw: calls.append(a))
    out2 = tfa.flash_attention(t(q), t(k), t(v), t(seg), rope=(t(cos), t(sin)), stash=stash)
    assert not calls and not stash
    assert torch.equal(out1, out2)


def test_cpu_backward_wrapper_runs_the_plain_version():
    q, k, v, do, seg, cos, sin = _inputs()
    t = torch.from_numpy
    before = tfa.flash_bwd.launches
    leaves = [t(a).requires_grad_() for a in (q, k, v)]
    tfa.flash_attention(*leaves, t(seg)).sum().backward()
    assert tfa.flash_bwd.launches == before
    assert all(leaf.grad is not None and torch.isfinite(leaf.grad).all() for leaf in leaves)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rope", [True, False], ids=["rope", "norope"])
def test_flash_bwd_ignores_non_finite_do_in_padded_rows(dtype, rope, monkeypatch):
    """The fused route on CPU tensors, as `_bwd_kernel_fused` (:748-753) and
    the CUDA kernel: do is taken as zero on padded rows before delta is
    summed, so inf and NaN written there reach neither dq nor dk (through
    delta) nor dv; against the interpreted fused backward on the same
    inputs, the file's tolerances, padded rows exactly 0."""
    monkeypatch.setenv("GGT_PALLAS_INTERPRET", "1")
    q, k, v, do, seg, cos, sin = _inputs(seed=15)
    pad = seg == 0
    assert pad.any()
    noisy = _flat(do).copy()
    noisy[pad] = np.nan
    rows = np.argwhere(pad)[::2]
    noisy[rows[:, 0], rows[:, 1]] = np.inf
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    qs = _flat(q) * DH**-0.5
    j = lambda a: jnp.asarray(a, jdt)  # noqa: E731
    jrope = (j(cos), j(sin)) if rope else None
    jseg = jnp.asarray(seg)
    bq, bk = jfa._fwd_blocks(P)
    out, lse = jfa._flash_fwd(j(qs), j(_flat(k)), j(_flat(v)), jseg, jseg, False, bq, bk, H, DH,
                              rope=jrope)
    want = jfa._flash_bwd(j(qs), j(_flat(k)), j(_flat(v)), jseg, jseg, out, lse, j(noisy),
                          False, H, DH, rope=jrope)
    t = lambda a: torch.from_numpy(np.array(a, np.float32)).to(tdt)  # noqa: E731
    got = tfa.flash_bwd(
        t(qs), t(_flat(k)), t(_flat(v)), torch.from_numpy(seg),
        t(cos) if rope else None, t(sin) if rope else None,
        t(np.asarray(out, np.float32)), torch.from_numpy(np.array(lse)), t(noisy), None,
        False, DH,
    )
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        assert np.isfinite(w).all(), name
        assert np.isfinite(g).all(), name
        if dtype == "float32":
            np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, atol=3e-2, rtol=2e-2, err_msg=name)
            assert np.linalg.norm(g - w) / np.linalg.norm(w) < 1e-2, name
        assert np.all(g[pad] == 0), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [72, 88])
@pytest.mark.parametrize("causal", [False, True], ids=["bidirectional", "causal"])
def test_flash_bwd_ref_matches_interpreted_kernel_on_whole_molecules(dtype, p, causal,
                                                                    monkeypatch):
    """flash_bwd's plain version against the interpreted `_bwd_kernel_fused`
    at the widths where #3 runs whole rows (the fine-tune and position
    batches' P 72; P 88): one molecule a row, then a padded stretch; RoPE and
    a cotangent of lse on the valid rows; the file's tolerances."""
    monkeypatch.setenv("GGT_PALLAS_INTERPRET", "1")
    b = 2
    rng = np.random.default_rng(33)
    q, k, v, do = ((rng.normal(size=(b, p, H * DH)) * 0.5).astype(np.float32)
                   for _ in range(4))
    seg = np.zeros((b, p), np.int32)
    for r in range(b):
        seg[r, : int(rng.integers(10, p - 4))] = 1
    cos, sin = (np.asarray(a) for a in
                j_rope_cos_sin(jnp.asarray(np.tile(np.arange(p, dtype=np.int32), (b, 1))), DH))
    dlse = (rng.normal(size=(b, H, p)) * 0.3).astype(np.float32) * (seg > 0)[:, None, :]
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    qs = q * DH**-0.5
    j = lambda a: jnp.asarray(a, jdt)  # noqa: E731
    jrope, jseg = (j(cos), j(sin)), jnp.asarray(seg)
    bq, bk = jfa._fwd_blocks(p)
    assert bk == p  # whole rows: the fused kernel's single block
    out, lse = jfa._flash_fwd(j(qs), j(k), j(v), jseg, jseg, causal, bq, bk, H, DH, rope=jrope)
    want = jfa._flash_bwd(j(qs), j(k), j(v), jseg, jseg, out, lse, j(do), causal, H, DH,
                          dlse=jnp.asarray(dlse), rope=jrope)
    t = lambda a: torch.from_numpy(np.array(a, np.float32)).to(tdt)  # noqa: E731
    got = tfa.flash_bwd(t(qs), t(k), t(v), torch.from_numpy(seg), t(cos), t(sin),
                        t(np.asarray(out, np.float32)), torch.from_numpy(np.array(lse)), t(do),
                        torch.from_numpy(dlse), causal, DH)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        assert g.shape == w.shape, name
        if dtype == "float32":
            np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, atol=3e-2, rtol=2e-2, err_msg=name)
            assert np.linalg.norm(g - w) / np.linalg.norm(w) < 1e-2, name
        assert np.all(g[seg == 0] == 0), name


def test_zero_padded_rows_leaves_the_valid_rows_bit_for_bit():
    """The one place both plain routes of the fused and split backward take
    do as zero on padded rows: non-finite values there go, the valid rows
    keep their bits, the dtype stays."""
    rng = np.random.default_rng(35)
    seg = torch.from_numpy(packed_segments(2, 40, rng))
    seg[1, 30:] = 0
    do = torch.from_numpy(rng.normal(size=(2, 40, 8)).astype(np.float32)).to(torch.bfloat16)
    noisy = do.clone()
    noisy[seg == 0] = float("nan")
    noisy[1, 31] = float("inf")
    got = tfa.zero_padded_rows(noisy, seg)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got[seg > 0], do[seg > 0])
    assert bool((got[seg == 0] == 0).all())
