"""The bi-causal flash attention of the port against the JAX package's, on
the CPU: the forward's bi-causal mask (kernel #1) and the split backward
(kernels #4 `_dq_kernel_single` and #5 `_dkv_kernel_single`).

`flash_dq_ref` and `flash_dkv_ref` (the plain versions of the CUDA kernels
flash_dq and flash_dkv, which the port's wrappers run on CPU tensors) are
held against the Pallas kernels run in the interpreter
(GGT_PALLAS_INTERPRET=1) through `_flash_bwd` with a bi-causal split;
`flash_attention_ref` against `_flash_fwd`'s single-block kernel; and the
gradients of `flash_attention(bi_causal_split=...)` against `jax.grad` of
the JAX `flash_attention` (interpreted) and of `xla_attention`.

Cases: RoPE on and off; the split inside a 64-row tile (P 128, 16 bit
slots: split 112) and on a tile edge (64 slots: split 64); rows of packed
segments, and rows laid out as the denoise batch lays them out (a molecule
at the front, a padded stretch, the bit slots at the end of the row); with
and without a cotangent of lse. Tolerances: fp32, the sides differ only in
the order of fp32 sums, 2e-5. bf16: both round p, ds and the inverse
rotation at the same points, so they differ by a flipped bf16 rounding here
and there: 2 ulps of the largest value elementwise (atol 3e-2 on values up
to ~4, rtol 2e-2) and 1e-2 in the relative Frobenius norm. The CUDA kernels
are held against these plain versions in tests/test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphgpt_tpu.models.rope import apply_rope as j_apply_rope
from graphgpt_tpu.models.rope import rope_cos_sin as j_rope_cos_sin
from graphgpt_tpu.ops import flash_attention as jfa
from graphgpt_tpu.ops.attention import _mask_logits, xla_attention
from graphgpt_torch.ops import flash_attention as tfa
from graphgpt_torch.synthetic import packed_segments

TOL = 2e-5
B, P, H, DH = 2, 128, 2, 64
SPLITS = {"split-in-tile": 16, "split-on-edge": 64}


def _segments(layout, bi_split, rng):
    if layout == "packed":
        seg = packed_segments(B, P, rng)
        seg[-1, P - 24 : P - bi_split] = 0  # a padded stretch before the suffix
        return seg
    # the denoise batch's layout: molecule, padding, bit slots (one segment)
    seg = np.zeros((B, P), np.int32)
    for r, mol in enumerate((40, P - bi_split)):
        seg[r, :mol] = 1
        seg[r, P - bi_split :] = 1
    return seg


def _inputs(layout, bi_split, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, do = ((rng.normal(size=(B, P, H, DH)) * 0.5).astype(np.float32) for _ in range(4))
    seg = _segments(layout, bi_split, rng)
    pos = np.tile(np.arange(P, dtype=np.int32), (B, 1))
    cos, sin = j_rope_cos_sin(jnp.asarray(pos), DH)
    return q, k, v, do, seg, np.asarray(cos), np.asarray(sin)


def _flat(a):
    return a.reshape(B, P, -1)


def _close(g, w, dtype, name):
    g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
    assert g.shape == w.shape, name
    if dtype == "float32":
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=name)
    else:
        np.testing.assert_allclose(g, w, atol=3e-2, rtol=2e-2, err_msg=name)
        assert np.linalg.norm(g - w) / np.linalg.norm(w) < 1e-2, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["packed", "denoise-row"])
@pytest.mark.parametrize("split", sorted(SPLITS))
@pytest.mark.parametrize("rope", [True, False], ids=["rope", "norope"])
@pytest.mark.parametrize("with_dlse", [False, True], ids=["nodlse", "dlse"])
def test_split_twins_match_interpreted_kernels(dtype, layout, split, rope, with_dlse,
                                               monkeypatch):
    monkeypatch.setenv("GGT_PALLAS_INTERPRET", "1")
    bi = SPLITS[split]
    q, k, v, do, seg, cos, sin = _inputs(layout, bi, seed=3)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    qs = _flat(q) * DH**-0.5
    dlse = None
    if with_dlse:
        dlse = (np.random.default_rng(9).normal(size=(B, H, P)) * 0.3).astype(np.float32)
        # the port leaves padded rows out of the backward (see the module
        # docstring of graphgpt_torch/ops/flash_attention.py)
        dlse = dlse * (seg > 0)[:, None, :]
    j = lambda a: jnp.asarray(a, jdt)  # noqa: E731
    jrope = (j(cos), j(sin)) if rope else None
    jseg = jnp.asarray(seg)
    bq, bk = jfa._fwd_blocks(P)
    out, lse = jfa._flash_fwd(j(qs), j(_flat(k)), j(_flat(v)), jseg, jseg, False, bq, bk, H, DH,
                              bi_split=bi, rope=jrope)
    want = jfa._flash_bwd(
        j(qs), j(_flat(k)), j(_flat(v)), jseg, jseg, out, lse, j(_flat(do)), False, H, DH,
        dlse=None if dlse is None else jnp.asarray(dlse), bi_split=bi, rope=jrope,
    )
    t = lambda a: torch.from_numpy(np.array(a, np.float32)).to(tdt)  # noqa: E731
    tq, tk, tv, tdo = t(qs), t(_flat(k)), t(_flat(v)), t(_flat(do))
    tout, tlse, tseg = t(np.asarray(out, np.float32)), torch.from_numpy(np.array(lse)), \
        torch.from_numpy(seg)
    tc, ts = (t(cos), t(sin)) if rope else (None, None)
    delta = tfa.flash_delta(tdo, tout, None if dlse is None else torch.from_numpy(dlse), DH)
    dq = tfa.flash_dq_ref(tq, tk, tv, tseg, tc, ts, tlse, delta, tdo, False, DH, bi)
    dk, dv = tfa.flash_dkv_ref(tq, tk, tv, tseg, tc, ts, tlse, delta, tdo, False, DH, bi)
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert g.dtype == tdt, name
        _close(g.float().numpy(), w, dtype, name)
        assert np.all(g.float().numpy()[seg == 0] == 0), name  # padded rows: exactly 0
    # the wrapper on CPU tensors takes the same twins
    got = tfa.flash_bwd(tq, tk, tv, tseg, tc, ts, tout, tlse, tdo,
                        None if dlse is None else torch.from_numpy(dlse), False, DH, bi)
    for g, w in zip(got, (dq, dk, dv)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["packed", "denoise-row"])
@pytest.mark.parametrize("split", sorted(SPLITS))
@pytest.mark.parametrize("rope", [True, False], ids=["rope", "norope"])
def test_bicausal_forward_ref_matches_interpreted_kernel(dtype, layout, split, rope,
                                                         monkeypatch):
    monkeypatch.setenv("GGT_PALLAS_INTERPRET", "1")
    bi = SPLITS[split]
    q, k, v, _, seg, cos, sin = _inputs(layout, bi, seed=4)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    qs = _flat(q) * DH**-0.5
    j = lambda a: jnp.asarray(a, jdt)  # noqa: E731
    bq, bk = jfa._fwd_blocks(P)
    jseg = jnp.asarray(seg)
    out, lse = jfa._flash_fwd(j(qs), j(_flat(k)), j(_flat(v)), jseg, jseg, False, bq, bk, H, DH,
                              bi_split=bi, rope=(j(cos), j(sin)) if rope else None)
    t = lambda a: torch.from_numpy(np.array(a, np.float32)).to(tdt)  # noqa: E731
    tout, tlse = tfa.flash_fwd(t(qs), t(_flat(k)), t(_flat(v)), torch.from_numpy(seg),
                               t(cos) if rope else None, t(sin) if rope else None, False, DH, bi)
    _close(tout.float().numpy(), out, dtype, "out")
    valid = (seg > 0)[:, None, :]
    np.testing.assert_allclose(np.where(valid, tlse.numpy(), 0), np.where(valid, lse, 0),
                               atol=1e-4 if dtype == "bfloat16" else TOL, rtol=TOL)
    assert np.all(tlse.numpy()[~np.broadcast_to(valid, tlse.shape)] == -1e30)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("layout", ["packed", "denoise-row"])
@pytest.mark.parametrize("split", sorted(SPLITS))
def test_bicausal_flash_attention_grads_match_jax_grad(impl, layout, split, monkeypatch):
    """Forward and backward through the port's autograd Function, fp32,
    against jax.grad of the interpreted JAX flash_attention (in-kernel RoPE)
    and of xla_attention (RoPE outside)."""
    monkeypatch.setenv("GGT_PALLAS_INTERPRET", "1")
    bi = SPLITS[split]
    q, k, v, do, seg, cos, sin = _inputs(layout, bi, seed=5)
    jcos, jsin, jseg = jnp.asarray(cos), jnp.asarray(sin), jnp.asarray(seg)

    def f(q, k, v):
        if impl == "pallas":
            out = jfa.flash_attention(q, k, v, jseg, bi_causal_split=bi, rope=(jcos, jsin))
        else:
            rq, rk = j_apply_rope(q, k, jcos, jsin)
            out = xla_attention(rq, rk, v, jseg, bi_causal_split=bi)
        return jnp.sum(out * jnp.asarray(do)), out

    (_, jout), want = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tt = torch.from_numpy
    leaves = [tt(a).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention(*leaves, tt(seg), bi_causal_split=bi, rope=(tt(cos), tt(sin)))
    (out * tt(do)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=TOL, rtol=TOL)
    for name, leaf, w in zip("qkv", leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), atol=TOL, rtol=TOL,
                                   err_msg=name)


def test_the_bit_slots_are_the_last_positions_of_the_row():
    """The split is P - bi_split in the padded row, not the end of a
    segment (the JAX package's _mask_logits, attention.py:35-41): a
    segment that ends before the row does is cut by the split where the row
    ends, and suffix rows that are padding see nothing."""
    seg = np.zeros((1, 24), np.int32)
    seg[0, :12] = 1  # the segment ends at 12; the last 8 positions are padding
    seg[0, 12:16] = 2
    want = np.asarray(_mask_logits(jnp.zeros((1, 1, 24, 24)), jnp.asarray(seg), False, 8))[0, 0]
    got = tfa._valid_mask(torch.from_numpy(seg), False, 8)[0, 0].numpy()
    np.testing.assert_array_equal(got, want == 0)
    # segment 2 (rows 12-15) lies wholly before the split (16): bidirectional
    assert got[12, 15] and got[15, 12]
    # every suffix row is padding, so the bi-causal rule reaches no real token
    assert not got[16:].any()
