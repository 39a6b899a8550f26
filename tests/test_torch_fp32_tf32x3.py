"""The numeric design of the fp32 forms on 3xTF32 tensor-core products,
against the JAX package on the CPU: the split backward #4f / #5f, its
stream form #7f / #8f and the forward #1f / #6f
(`csrc/flash_bwd_split_f32.cu`, the body's forward role), the norm-fused
projections #12f and the gated MLPs #11f and #2f (`csrc/mlp_qkv_f32.cu`).

The CUDA kernels take every product as three TF32 products: each operand
split into hi = x rounded to TF32 and lo = (x - hi) rounded to TF32
(nearest, ties away, as `cvt.rna.tf32.f32`), then a_hi b_hi + a_hi b_lo +
a_lo b_hi summed in fp32 (`csrc/tf32x3.cuh`). Here that arithmetic is
emulated in torch, rounding to TF32 by bits, and held against the Pallas
kernels interpreted in fp32 (GGT_PALLAS_INTERPRET=1), each spied on so that
the test shows it ran; every output must lie within 2e-5 in the relative
Frobenius norm (the card's F32_REL), and the same emulation with one TF32
product (a_hi b_hi) past it: the split is what keeps the forms
fp32-accurate.

The pair: S = q k^T, dP = do v^T, dq = ds k, dk = ds^T q, dv = p^T do, p =
2^(S log2 e - lse log2 e), against `_dq_kernel_single` and
`_dkv_kernel_single` (the bidirectional and causal masks reach them with
`_MAX_SINGLE_BLOCK` set below P, the bi-causal one through `_flash_bwd`'s
own route), at the denoise width: B 2 x P 88, 2 heads of 64, RoPE on,
packed rows with a padded stretch, a cotangent of lse; dq, delta, dk and
dv. ~3 s a case on one worker, most of it the interpreted JAX kernels.

The stream form: the same arithmetic with the query rows' ids and the
keys' apart (#7f's own and visiting ids, #8f's visiting and own), and
#7f's delta made consistent with its own p and dP (delta' = delta +
(rowsum ds - dlse) / rowsum p, dq less (delta' - delta) p k, #8f on
delta'), against
`_dq_kernel_stream` and `_dkv_kernel_stream`, which `_flash_bwd` launches
at every P under skip mode with 64-row tiles: B 2 x P 256, 2 heads, q and
k as skip mode hands them over (rotated outside: no RoPE), bidirectional
and causal, the key ids another packed row's (the two rows' ids swapped),
so that some query rows see no key and some keys no query. Such a row takes
no part in the port's backward, where the JAX kernels give it p = 1 on
every key (its lse is the mask's floor, the forward having seen nothing):
both sides get lse +1e30 on those rows, the mask's answer written into the
exponent. ~2 s a case.

The forward (emulated_fwd): S = q k^T and O += p v by 64-key tiles with
the online softmax in the kernel's order (the new max, the sums so far
scaled by 2^(m log2 e - n log2 e), p = 2^(S log2 e - n log2 e)), out = O /
l and lse = m + log l, against `_fwd_kernel_single` at the pair's shape
with RoPE (bidirectional, causal, bi-causal) and `_fwd_kernel_stream`
under skip mode's 64-row tiles at B 2 x P 256 with the other row's key
ids; out and lse within 2e-5, the 1xTF32 control's out past it; then its
out and lse through the pair's (or the stream pair's) arithmetic against
the interpreted backward kernels on the JAX forward's. ~2.5 s a case.

#12f, #11f and #2f: the weights split into TF32 hi and lo planes (the
split pass), the A operand normalised with the plain version's two
roundings ((x * rrms) * wn, #12f and #2f) and then split, as the consumers
do in registers; the MLPs' gate and up products, act(gate) * up in fp32,
then the down product on that g, and #2f's residual x added to it in fp32.
Against `_norm_qkv_kernel` (through `fused_norm_qkv`), `_mlp_kernel`
(through `fused_mlp`) and `_norm_mlp_kernel` (through `fused_norm_mlp`) at
a ragged N 200, D 128, widths 128/128/128 and GQA's 128/64/64, F 256 and
all three activations. ~1 s a case.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphgpt_tpu.models.rope import rope_cos_sin as j_rope_cos_sin
from graphgpt_tpu.ops import flash_attention as jfa
from graphgpt_tpu.ops import mlp as jmlp
from graphgpt_torch.ops import flash_attention as tfa
from graphgpt_torch.ops import mlp as tmlp
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


def emulated_pair(qs, k, v, do, out, seg, cos, sin, lse, dlse, causal, bi, mm, seg_k=None,
                  consistent=False):
    """(dq, delta, dk, dv) of the CUDA pair's arithmetic with `mm` for every
    product: RoPE with the plain roundings (none where cos is None: q and k
    come rotated), do zero on padded query rows, delta = rowsum(do * out) -
    dlse, p = 2^(S log2 e - lse log2 e) and ds = p (dP - delta) where the
    mask lets a pair through, dq and dk through the inverse rotation. The
    query rows' ids are seg, the keys' seg_k (seg where None). `consistent`:
    the stream form's, delta' = delta + (rowsum ds - dlse) / rowsum p, dq
    less (delta' - delta) p k, and dk from delta'."""
    heads = tfa._heads

    def rot(x):
        return x if cos is None else tfa.rotate_tokens(x, cos, sin, DH)

    q4, k4 = heads(rot(qs), DH), heads(rot(k), DH)
    do = tfa.zero_padded_rows(do, seg)
    do4, v4 = heads(do, DH), heads(v, DH)
    delta = tfa.flash_delta(do, out, dlse, DH)
    s = mm(q4, k4.transpose(-1, -2))
    dp = mm(do4, v4.transpose(-1, -2))
    valid = tfa._valid_mask(seg, causal, bi, seg_k) & (seg > 0)[:, None, :, None]
    l2e = torch.tensor(LOG2E, dtype=torch.float32)
    p = torch.where(valid, torch.exp2(s * l2e - lse[..., None] * l2e), 0.0)
    ds = torch.where(valid, p * (dp - delta[..., None]), 0.0)
    dq = mm(ds, k4)
    if consistent:
        rs, ps = ds.sum(-1), p.sum(-1)
        corr = torch.where(ps > 0, (rs - dlse) / torch.where(ps > 0, ps, 1.0), 0.0)
        dq = dq - corr[..., None] * mm(p, k4)
        delta = delta + corr
        ds = torch.where(valid, p * (dp - delta[..., None]), 0.0)

    def back(x):
        x = tfa._tokens(x)
        return x if cos is None else tfa.unrotate_tokens(x, cos, sin, DH)

    return (back(dq), delta, back(mm(ds.transpose(-1, -2), q4)),
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


# the stream pair's cases: B 2 x P 256 under skip mode's 64-row tiles
STREAM_P = 256
STREAM_MASKS = {"bidirectional": False, "causal": True}


@pytest.mark.parametrize("mask", list(STREAM_MASKS))
def test_3xtf32_stream_pair_with_another_rows_key_ids_matches_the_interpreted_kernels(
        mask, monkeypatch):
    monkeypatch.setenv("GGT_PALLAS_INTERPRET", "1")
    causal, p = STREAM_MASKS[mask], STREAM_P
    # the stream pair at every P: skip mode, 64-row tiles (kv and q blocks
    # of 64, so more than one)
    for name, value in (("_MODE", "skip"), ("_BAND_BK", 64), ("_BQ_BWD", 64)):
        monkeypatch.setattr(jfa, name, value)
    ran = []
    for name in ("_dq_kernel_stream", "_dkv_kernel_stream"):
        kernel = getattr(jfa, name)

        def spy(*refs, _kernel=kernel, _name=name, **kw):
            ran.append(_name)
            return _kernel(*refs, **kw)

        monkeypatch.setattr(jfa, name, spy)
    rng = np.random.default_rng(29)
    qs, k, v, do = ((rng.normal(size=(B, p, H * DH)) * 0.5).astype(np.float32) for _ in range(4))
    qs = qs * DH**-0.5
    seg = packed_segments(B, p, rng)
    seg[-1, p - 40 : p - 8] = 0  # a padded stretch before the last row's end
    seg_k = np.ascontiguousarray(seg[::-1])  # the keys carry the other row's ids
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    tseg, tseg_k = torch.from_numpy(seg), torch.from_numpy(seg_k)
    valid = tfa._valid_mask(tseg, causal, 0, tseg_k)[:, 0]
    seen_q, seen_k = valid.any(dim=2), valid.any(dim=1)
    # some query rows see no key, some keys no query
    assert bool(((tseg > 0) & ~seen_q).any()) and bool(((tseg_k > 0) & ~seen_k).any())
    dlse = (rng.normal(size=(B, H, p)) * 0.3).astype(np.float32) * (seg > 0)[:, None, :]
    jq = jnp.asarray
    bq, bk = jfa._fwd_blocks(p)
    out, lse = jfa._flash_fwd(jq(qs), jq(k), jq(v), jq(seg), jq(seg_k), causal, bq, bk, H, DH)
    # a query row that sees no key: out no matter (p = 0), lse +1e30
    lse = np.where(seen_q.numpy()[:, None, :], np.asarray(lse), np.float32(1e30))
    want = jfa._flash_bwd(jq(qs), jq(k), jq(v), jq(seg), jq(seg_k), out, jq(lse), jq(do), causal,
                          H, DH, dlse=jq(dlse))
    assert set(ran) == {"_dq_kernel_stream", "_dkv_kernel_stream"}
    do0 = do * (seg > 0)[..., None]  # the kernels' delta: do taken as 0 on padded rows
    want_delta = np.einsum("bphd,bphd->bhp", do0.reshape(B, p, H, DH),
                           np.asarray(out).reshape(B, p, H, DH)) - dlse
    args = (t(qs), t(k), t(v), t(do), t(out), tseg, None, None, t(lse), t(dlse), causal, 0)
    got = emulated_pair(*args, mm_3xtf32, seg_k=tseg_k, consistent=True)
    one = emulated_pair(*args, mm_tf32, seg_k=tseg_k, consistent=True)
    for name, g, w in zip(("dq", "delta", "dk", "dv"), got, (want[0], want_delta, *want[1:])):
        assert _rel(g, w) < F32_REL, (name, _rel(g, w))
    assert bool((got[0][~seen_q] == 0).all())
    assert bool((got[2][~seen_k] == 0).all()) and bool((got[3][~seen_k] == 0).all())
    for name, g, w in zip(("dq", "dk", "dv"), one[:1] + one[2:], want):
        assert _rel(g, w) > F32_REL, (name, _rel(g, w))


def emulated_norm_qkv(x, wn, ws, eps, mm):
    """(q, k, v) of #12f's arithmetic with `mm` for every product: rrms in
    fp32, h = (x * rrms) * wn with its two roundings, then h W^T for each
    weight [width, D] (the split pass's planes are tf32(W), tf32(W -
    tf32(W)), what mm_3xtf32 takes of W^T)."""
    rrms = torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps)
    h = (x * rrms) * wn
    return [mm(h, w.t()) for w in ws]


def emulated_mlp(x, wg, wu, wd, act, mm):
    """#11f's arithmetic with `mm` for every product: g = act(x wg^T) *
    (x wu^T) in fp32, out = g wd^T (weights [F, D], [F, D], [D, F])."""
    g = tmlp.act_fn(act)(mm(x, wg.t())) * mm(x, wu.t())
    return mm(g, wd.t())


def emulated_norm_mlp(x, wn, wg, wu, wd, eps, act, mm):
    """#2f's arithmetic with `mm` for every product: h = (x * rrms) * wn with
    #12f's two roundings, then #11f's on h, then x + that in fp32."""
    rrms = torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps)
    return x + emulated_mlp((x * rrms) * wn, wg, wu, wd, act, mm)


def _spy(monkeypatch, name, ran):
    kernel = getattr(jmlp, name)

    def spy(*refs, **kw):
        ran.append(name)
        return kernel(*refs, **kw)

    monkeypatch.setattr(jmlp, name, spy)


def _f32(rng, shape, scale, loc=0.0):
    return (loc + rng.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("widths", [(128, 128, 128), (128, 64, 64)], ids=["mha", "gqa"])
def test_3xtf32_norm_qkv_matches_the_interpreted_kernel(widths, monkeypatch):
    monkeypatch.setenv("GGT_PALLAS_INTERPRET", "1")
    ran = []
    _spy(monkeypatch, "_norm_qkv_kernel", ran)
    n, d, eps = 200, 128, 1e-6
    rng = np.random.default_rng(31)
    x, wn = _f32(rng, (n, d), 1.0), _f32(rng, (d,), 0.1, 1.0)
    ws = [_f32(rng, (w, d), 0.55 / d**0.5) for w in widths]  # nn.Linear layout
    want = jmlp.fused_norm_qkv(jnp.asarray(x), jnp.asarray(wn),
                               *(jnp.asarray(w.T) for w in ws), eps)
    assert ran
    args = (torch.from_numpy(x), torch.from_numpy(wn), [torch.from_numpy(w) for w in ws], eps)
    got = emulated_norm_qkv(*args, mm_3xtf32)
    one = emulated_norm_qkv(*args, mm_tf32)
    for name, g, o, w in zip("qkv", got, one, want):
        assert g.shape == w.shape, name
        assert _rel(g, w) < F32_REL, (name, _rel(g, w))
        assert _rel(o, w) > F32_REL, (name, _rel(o, w))


@pytest.mark.parametrize("act", ["gelu", "gelu_pytorch_tanh", "silu"])
def test_3xtf32_mlp_matches_the_interpreted_kernel(act, monkeypatch):
    monkeypatch.setenv("GGT_PALLAS_INTERPRET", "1")
    ran = []
    _spy(monkeypatch, "_mlp_kernel", ran)
    n, d, f = 200, 128, 256
    rng = np.random.default_rng(37)
    x = _f32(rng, (n, d), 1.0)
    wg, wu = (_f32(rng, (f, d), 0.55 / d**0.5) for _ in range(2))
    wd = _f32(rng, (d, f), 0.55 / f**0.5)
    want = jmlp.fused_mlp(jnp.asarray(x), *(jnp.asarray(w.T) for w in (wg, wu, wd)), act)
    assert ran
    args = (torch.from_numpy(x), *(torch.from_numpy(w) for w in (wg, wu, wd)), act)
    got = emulated_mlp(*args, mm_3xtf32)
    one = emulated_mlp(*args, mm_tf32)
    assert got.shape == want.shape
    assert _rel(got, want) < F32_REL, _rel(got, want)
    assert _rel(one, want) > F32_REL, _rel(one, want)


@pytest.mark.parametrize("act", ["gelu", "gelu_pytorch_tanh", "silu"])
def test_3xtf32_norm_mlp_matches_the_interpreted_kernel(act, monkeypatch):
    monkeypatch.setenv("GGT_PALLAS_INTERPRET", "1")
    ran = []
    _spy(monkeypatch, "_norm_mlp_kernel", ran)
    n, d, f, eps = 200, 128, 256, 1e-6
    rng = np.random.default_rng(41)
    x, wn = _f32(rng, (n, d), 1.0), _f32(rng, (d,), 0.1, 1.0)
    wg, wu = (_f32(rng, (f, d), 0.55 / d**0.5) for _ in range(2))
    wd = _f32(rng, (d, f), 0.55 / f**0.5)
    want = jmlp.fused_norm_mlp(jnp.asarray(x), jnp.asarray(wn),
                               *(jnp.asarray(w.T) for w in (wg, wu, wd)), eps, act)
    assert ran
    args = (torch.from_numpy(x), torch.from_numpy(wn),
            *(torch.from_numpy(w) for w in (wg, wu, wd)), eps, act)
    got = emulated_norm_mlp(*args, mm_3xtf32)
    one = emulated_norm_mlp(*args, mm_tf32)
    assert got.shape == want.shape
    assert _rel(got, want) < F32_REL, _rel(got, want)
    assert _rel(one, want) > F32_REL, _rel(one, want)
    # and against the output less its residual, which no product touches
    # (read ~7e-7 and ~5e-4, where the whole output reads ~7e-8 and ~5e-5)
    want_mlp, x32 = np.asarray(want, np.float32) - x, torch.from_numpy(x)
    assert _rel(got - x32, want_mlp) < F32_REL, _rel(got - x32, want_mlp)
    assert _rel(one - x32, want_mlp) > F32_REL, _rel(one - x32, want_mlp)


def emulated_fwd(qs, k, v, seg, cos, sin, causal, bi, mm, seg_k=None, tile=64):
    """(out, lse) of the forward role's arithmetic (#1f, #6f) with `mm` for
    both products: RoPE with the plain roundings (none where cos is None),
    then by 64-key tiles as the kernel takes them: S = q k^T with masked
    logits at -inf, the rows' new max n, the sums so far scaled by a =
    2^(m log2 e - n log2 e) (exactly 1 where the max stays; the offset 0
    while a row has seen no key), p = 2^(S log2 e - n log2 e), l = l a +
    rowsum p, O = O a + p v; at the end out = O / l and lse = m + log l, 0
    and -1e30 on a padded row or one that sees no key. A tile the kernel
    skips (no pair of it visible) leaves m, l and O as they were, as it does
    here."""
    heads = tfa._heads

    def rot(x):
        return x if cos is None else tfa.rotate_tokens(x, cos, sin, DH)

    q4, k4, v4 = heads(rot(qs), DH), heads(rot(k), DH), heads(v, DH)
    valid = tfa._valid_mask(seg, causal, bi, seg_k) & (seg > 0)[:, None, :, None]
    l2e = torch.tensor(LOG2E, dtype=torch.float32)
    m = torch.full(q4.shape[:3], float("-inf"))
    l = torch.zeros(q4.shape[:3])
    o = torch.zeros(q4.shape)
    for t0 in range(0, q4.shape[2], tile):
        cols = slice(t0, t0 + tile)
        s = torch.where(valid[..., cols], mm(q4, k4[:, :, cols].transpose(-1, -2)),
                        float("-inf"))
        n = torch.maximum(m, s.amax(-1))
        base = torch.where(n == float("-inf"), 0.0, n * l2e)
        a = torch.exp2(m * l2e - base)
        pt = torch.exp2(s * l2e - base[..., None])
        l = l * a + pt.sum(-1)
        o = o * a[..., None] + mm(pt, v4[:, :, cols])
        m = n
    live = (l > 0) & (seg > 0)[:, None, :]
    out = torch.where(live[..., None], o * (1.0 / torch.where(live, l, 1.0))[..., None], 0.0)
    lse = torch.where(live, m + torch.log(torch.where(live, l, 1.0)), tfa.NEG_INF)
    return tfa._tokens(out), lse


def _spy_flash(monkeypatch, names, ran):
    for name in names:
        kernel = getattr(jfa, name)

        def spy(*refs, _kernel=kernel, _name=name, **kw):
            ran.append(_name)
            return _kernel(*refs, **kw)

        monkeypatch.setattr(jfa, name, spy)


def _check_fwd(got, one, want_out, want_lse, live):
    """out and lse (on the rows that see a key) within F32_REL of the
    interpreted kernel's, the 1xTF32 emulation's out past it; the other
    rows out 0, lse -1e30."""
    out, lse = got
    w_out, w_lse = np.asarray(want_out, np.float32), np.asarray(want_lse, np.float32)
    rows = live.numpy()  # [B, H, P]
    tok = torch.from_numpy(rows.any(axis=1))  # H heads alike: a row's mask is its ids'
    assert _rel(out[tok], w_out[tok.numpy()]) < F32_REL, _rel(out[tok], w_out[tok.numpy()])
    assert _rel(lse[live], w_lse[rows]) < F32_REL, _rel(lse[live], w_lse[rows])
    assert _rel(one[0][tok], w_out[tok.numpy()]) > F32_REL
    assert bool((out[~tok] == 0).all()) and bool((lse[~live] == tfa.NEG_INF).all())


@pytest.mark.parametrize("mask", list(MASKS))
def test_3xtf32_forward_matches_the_interpreted_single_kernel(mask, monkeypatch):
    """#1f's arithmetic against `_fwd_kernel_single` at the denoise width (B 2
    x P 88, RoPE, a padded stretch), then fed to the pair's (emulated_pair)
    against the interpreted `_dq_kernel_single` / `_dkv_kernel_single` on
    the JAX forward's out and lse. ~3 s a case."""
    monkeypatch.setenv("GGT_PALLAS_INTERPRET", "1")
    causal, bi = MASKS[mask]
    monkeypatch.setattr(jfa, "_MAX_SINGLE_BLOCK", P - 1)  # the pair for every mask
    ran = []
    _spy_flash(monkeypatch, ("_fwd_kernel_single", "_dq_kernel_single", "_dkv_kernel_single"),
               ran)
    rng = np.random.default_rng(43)
    q, k, v, do = ((rng.normal(size=(B, P, H * DH)) * 0.5).astype(np.float32) for _ in range(4))
    qs = q * DH**-0.5
    seg = packed_segments(B, P, rng)
    seg[-1, P - 24 : P - BI] = 0  # a padded stretch before the last row's end
    pos = np.tile(np.arange(P, dtype=np.int32), (B, 1))
    cos, sin = (np.asarray(a, np.float32) for a in j_rope_cos_sin(jnp.asarray(pos), DH))
    jq, jseg = jnp.asarray, jnp.asarray(seg)
    jrope = (jq(cos), jq(sin))
    out, lse = jfa._flash_fwd(jq(qs), jq(k), jq(v), jseg, jseg, causal, P, P, H, DH,
                              bi_split=bi, rope=jrope)
    assert ran == ["_fwd_kernel_single"]
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    tseg = torch.from_numpy(seg)
    args = (t(qs), t(k), t(v), tseg, t(cos), t(sin), causal, bi)
    got = emulated_fwd(*args, mm_3xtf32)
    live = tfa._valid_mask(tseg, causal, bi)[:, 0].any(-1)[:, None, :].expand(B, H, P)
    _check_fwd(got, emulated_fwd(*args, mm_tf32), out, lse, live)
    # the forward's out and lse through the pair's arithmetic, against the
    # interpreted pair on the JAX forward's
    want = jfa._flash_bwd(jq(qs), jq(k), jq(v), jseg, jseg, out, lse, jq(do), causal, H, DH,
                          bi_split=bi, rope=jrope)
    assert {"_dq_kernel_single", "_dkv_kernel_single"} <= set(ran)
    pair = emulated_pair(t(qs), t(k), t(v), t(do), got[0], tseg, t(cos), t(sin), got[1],
                         torch.zeros(B, H, P), causal, bi, mm_3xtf32)
    for name, g, w in zip(("dq", "dk", "dv"), pair[:1] + pair[2:], want):
        assert _rel(g, w) < F32_REL, (name, _rel(g, w))


@pytest.mark.parametrize("mask", list(STREAM_MASKS))
def test_3xtf32_stream_forward_with_another_rows_key_ids_matches_the_interpreted_kernel(
        mask, monkeypatch):
    """#6f's arithmetic against `_fwd_kernel_stream` under skip mode's 64-row
    tiles at B 2 x P 256, q and k as skip mode hands them over (rotated
    outside: no RoPE), the key ids the other row's
    (some query rows see no key: the port gives them out 0 and lse -1e30,
    where the JAX kernel gives the mean of the values it visited); then fed
    to the stream pair's arithmetic (consistent delta) against the
    interpreted `_dq_kernel_stream` / `_dkv_kernel_stream` on the JAX
    forward's out and lse. ~3 s a case."""
    monkeypatch.setenv("GGT_PALLAS_INTERPRET", "1")
    causal, p = STREAM_MASKS[mask], STREAM_P
    for name, value in (("_MODE", "skip"), ("_BAND_BK", 64), ("_BQ_BWD", 64)):
        monkeypatch.setattr(jfa, name, value)
    ran = []
    _spy_flash(monkeypatch, ("_fwd_kernel_stream", "_dq_kernel_stream", "_dkv_kernel_stream"),
               ran)
    rng = np.random.default_rng(47)
    qs, k, v, do = ((rng.normal(size=(B, p, H * DH)) * 0.5).astype(np.float32) for _ in range(4))
    qs = qs * DH**-0.5
    seg = packed_segments(B, p, rng)
    seg[-1, p - 40 : p - 8] = 0  # a padded stretch before the last row's end
    seg_k = np.ascontiguousarray(seg[::-1])  # the keys carry the other row's ids
    jq = jnp.asarray
    bq, bk = jfa._fwd_blocks(p)
    out, lse = jfa._flash_fwd(jq(qs), jq(k), jq(v), jq(seg), jq(seg_k), causal, bq, bk, H, DH)
    assert set(ran) == {"_fwd_kernel_stream"}
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    tseg, tseg_k = torch.from_numpy(seg), torch.from_numpy(seg_k)
    seen_q = tfa._valid_mask(tseg, causal, 0, tseg_k)[:, 0].any(-1)
    assert bool(((tseg > 0) & ~seen_q).any())  # some query rows see no key
    args = (t(qs), t(k), t(v), tseg, None, None, causal, 0)
    got = emulated_fwd(*args, mm_3xtf32, seg_k=tseg_k)
    live = seen_q[:, None, :].expand(B, H, p)
    _check_fwd(got, emulated_fwd(*args, mm_tf32, seg_k=tseg_k), out, lse, live)
    # the pair on the JAX forward's out and lse, its rows that see no key at
    # lse +1e30 (p = 0 there: see the stream pair's test)
    jlse = np.where(seen_q.numpy()[:, None, :], np.asarray(lse), np.float32(1e30))
    want = jfa._flash_bwd(jq(qs), jq(k), jq(v), jq(seg), jq(seg_k), out, jq(jlse), jq(do),
                          causal, H, DH)
    assert {"_dq_kernel_stream", "_dkv_kernel_stream"} <= set(ran)
    pair = emulated_pair(t(qs), t(k), t(v), t(do), got[0], tseg, None, None, got[1],
                         torch.zeros(B, H, p), causal, 0, mm_3xtf32, seg_k=tseg_k,
                         consistent=True)
    for name, g, w in zip(("dq", "dk", "dv"), pair[:1] + pair[2:], want):
        assert _rel(g, w) < F32_REL, (name, _rel(g, w))
