"""The band-sparse flash attention of the port against the JAX package's,
on the CPU: the plain versions of the CUDA kernels #9 flash_fwd_band and
#10 flash_bwd_band (which the port's wrappers run on CPU tensors) against
the Pallas kernels `_fwd_kernel_band` and `_bwd_kernel_band` run in the
interpreter (GGT_PALLAS_INTERPRET=1), both sides under `_MODE = "band"`.
Each JAX kernel is wrapped so that the test asserts it ran. The JAX band
tiles are set to the port's 64 rows (`_BQ_TARGET`, `_BAND_BK`, `_BQ_BWD`),
so that at P 256 the band is a real stretch of 64-key tiles.

- `flash_attention` with RoPE (rotated outside the kernels under band) on
  packed rows with a padded stretch: out and the gradients of q, k, v,
  cos and sin; bidirectional, causal, and bi-causal with 16 bit slots
  (the split inside a 64-row tile).
- The kernels' own entries with key ids from another array (the query ids
  shifted one position left, so that every query row still sees a key)
  and a cotangent of lse (0 on padded rows, which the port leaves out):
  out, lse, dq, dk, dv.
- `_MAX_BAND` cut to 128 on both sides: P 256 then leaves the band
  kernels, q and k still rotated outside, and takes the JAX dispatch's
  path above the band limit (up to P 2048 the single-block forward and the
  split backward pair).
- `band_limits` bit for bit against `_band_limits` (:265) at key-tile
  width 1, on packed, clustered-but-unsorted and all-padding tiles.
- The backwards compute one function: JAX's `_bwd_kernel_fused`, the
  streamed pair `_dq_kernel_stream` + `_dkv_kernel_stream` and
  `_bwd_kernel_band` (`_flash_bwd` under `_MODE` legacy, skip and band) and
  the port's plain routes of flash_bwd (#3), flash_dq_stream +
  flash_dkv_stream (#7, #8) and flash_bwd_band (#10), which the CUDA
  kernels of #3 and #10 share one body for, on the same pre-rotated inputs,
  out and lse agree with each other: on one id array (bidirectional and
  causal), and with another array's key ids (the fused backward takes one
  array, so there the band backward against the streamed pairs).
- #10's plain route against the interpreted `_bwd_kernel_band` on the
  denoise rows' bi-causal layout at P 88 (a molecule, padding, 16 bit slots
  in the molecule's segment), with a cotangent of lse.
- The three forwards compute one function: JAX's `_fwd_kernel_single`,
  `_fwd_kernel_stream` and `_fwd_kernel_band` (`_flash_fwd` under
  `_MODE` legacy, skip and band) and the port's `flash_attention_ref`,
  `flash_fwd_stream_ref` and `flash_fwd_band_ref` (the plain versions of
  #1, #6 and #9, which the CUDA kernels share one body for) on the same
  pre-rotated inputs agree with each other, on the rows that see a key.

Tolerances: fp32, the sides differ in the order of fp32 sums, 2e-5. bf16:
both round p, ds and the rotation at the same points (the forward's p
relative to a running max in the kernel, to the row max in the plain
version), so they differ by a flipped bf16 rounding here and there: atol
3e-2, rtol 2e-2 elementwise and 1e-2 in the relative Frobenius norm, as in
test_torch_flash_stream.py. The CUDA kernels are held against these plain
versions in tests/test_torch_gpu.py and chip_smoke.py. The RoPE case and the
entries' case run once more each at head width 32, which the JAX package
pads to 64 (`JaxHeads`; `flash_attention` pads it itself).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphgpt_tpu.models.rope import rope_cos_sin as j_rope_cos_sin
from graphgpt_tpu.ops import flash_attention as jfa
from graphgpt_torch.ops import flash_attention as tfa
from graphgpt_torch.synthetic import packed_segments
from test_torch_flash_attention import JaxHeads

TOL = 2e-5
DH = 64
BI = 16
MASKS = {"bidirectional": (False, 0), "causal": (True, 0), "bi-causal": (False, BI)}


@pytest.fixture
def band(monkeypatch):
    """Both sides in band mode, the JAX kernels interpreted with 64-row
    tiles; returns a dict of spies on the JAX band kernels."""
    monkeypatch.setenv("GGT_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(jfa, "_MODE", "band")
    monkeypatch.setattr(tfa, "_MODE", "band")
    for name in ("_BQ_TARGET", "_BAND_BK", "_BQ_BWD"):
        monkeypatch.setattr(jfa, name, 64)
    monkeypatch.setattr(tfa, "REF_ROWS", 64)
    return {n: _spy(monkeypatch, jfa, n) for n in ("_fwd_kernel_band", "_bwd_kernel_band")}


def _spy(monkeypatch, module, name):
    """Wrap module.<name> so that a test can assert it ran."""
    calls = []
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        calls.append(1)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapped)
    return calls


def _inputs(b, p, h, seed, dh=DH):
    rng = np.random.default_rng(seed)
    q, k, v, do = ((rng.normal(size=(b, p, h, dh)) * 0.5).astype(np.float32) for _ in range(4))
    seg = packed_segments(b, p, rng)
    seg[-1, p - 40 : p - BI] = 0  # a padded stretch before the last row's bit slots
    pos = np.tile(np.arange(p, dtype=np.int32), (b, 1))
    cos, sin = (np.asarray(t) for t in j_rope_cos_sin(jnp.asarray(pos), dh))
    return q, k, v, do, seg, cos, sin


def _dtypes(dtype):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return (lambda a: jnp.asarray(a, jdt),
            lambda a: torch.from_numpy(np.array(a, np.float32)).to(tdt), tdt)


def _close(g, w, dtype, name):
    g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
    assert g.shape == w.shape, name
    if dtype == "float32":
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=name)
    else:
        np.testing.assert_allclose(g, w, atol=3e-2, rtol=2e-2, err_msg=name)
        assert np.linalg.norm(g - w) / np.linalg.norm(w) < 1e-2, name


def _attention_both(q, k, v, do, seg, cos, sin, causal, bi, dtype):
    """out and the gradients of (q, k, v, cos, sin) of flash_attention with
    RoPE on both sides, for the cotangent `do` of out."""
    j, t, _ = _dtypes(dtype)
    jseg = jnp.asarray(seg)

    def jfn(q_, k_, v_, c_, s_):
        return jfa.flash_attention(q_, k_, v_, jseg, causal=causal, bi_causal_split=bi,
                                   rope=(c_, s_))

    want, vjp = jax.vjp(jfn, j(q), j(k), j(v), j(cos), j(sin))
    want_grads = vjp(j(do))
    leaves = [t(a).requires_grad_() for a in (q, k, v, cos, sin)]
    got = tfa.flash_attention(*leaves[:3], torch.from_numpy(seg), causal=causal,
                              bi_causal_split=bi, rope=tuple(leaves[3:]))
    got.backward(t(do))
    return (got, want), [(x.grad, w) for x, w in zip(leaves, want_grads)]


def _at_dh(cases, dh32):
    """The cases at dh 64 under their own ids, and those of `dh32` again at
    head width 32 (the JAX package pads it to 64 before its kernels)."""
    return ([pytest.param(*c, DH, id="-".join(c)) for c in cases]
            + [pytest.param(*c, 32, id="dh32-" + "-".join(c)) for c in dh32])


@pytest.mark.parametrize("mask, dtype, dh", _at_dh(
    [("bidirectional", "float32"), ("causal", "bfloat16"), ("bi-causal", "float32")],
    [("bi-causal", "bfloat16")]))
def test_band_attention_with_rope_matches_jax(mask, dtype, dh, band):
    b, p, h = 1, 256, 2
    causal, bi = MASKS[mask]
    q, k, v, do, seg, cos, sin = _inputs(b, p, h, seed=1, dh=dh)
    (got, want), grads = _attention_both(q, k, v, do, seg, cos, sin, causal, bi, dtype)
    assert band["_fwd_kernel_band"] and band["_bwd_kernel_band"], "JAX took another path"
    _close(got.detach().float().numpy(), want, dtype, "out")
    assert np.all(got.detach().float().numpy()[seg == 0] == 0)
    for name, (g, w) in zip(("dq", "dk", "dv", "dcos", "dsin"), grads):
        _close(g.float().numpy(), w, dtype, name)


def _key_ids(seg):
    """The query ids shifted one position left: another array in which every
    query row still finds a key of its id."""
    out = np.zeros_like(seg)
    out[:, :-1] = seg[:, 1:]
    return out


@pytest.mark.parametrize("mask", ["bidirectional", "causal"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_three_forwards_compute_one_function(mask, dtype, band, monkeypatch):
    """B 2 x P 320 (five 64-row tiles), H 2, q and k taken as rotated, one
    id array with a padded stretch: out and lse of the six forwards, every
    pair, on the rows whose id is not 0 (each sees at least itself); lse at
    the tolerance of the band entries' test in bf16."""
    b, p, h = 2, 320, 2
    causal, _ = MASKS[mask]
    q, k, v, _, seg, _, _ = _inputs(b, p, h, seed=4)
    qs, k, v = (a.reshape(b, p, h * DH) for a in (q * DH**-0.5, k, v))
    j, t, _ = _dtypes(dtype)
    ran = {n: _spy(monkeypatch, jfa, n) for n in ("_fwd_kernel_single", "_fwd_kernel_stream")}
    ran["_fwd_kernel_band"] = band["_fwd_kernel_band"]
    jseg, tseg = jnp.asarray(seg), torch.from_numpy(seg)
    outs = {}
    # (mode, the kernel it runs, key block): legacy takes the whole row as one block
    for mode, kernel, bk in (("legacy", "_fwd_kernel_single", p),
                             ("skip", "_fwd_kernel_stream", 64), ("band", "_fwd_kernel_band", 64)):
        monkeypatch.setattr(jfa, "_MODE", mode)
        outs[kernel] = jfa._flash_fwd(j(qs), j(k), j(v), jseg, jseg, causal, 64, bk, h, DH)
        assert ran[kernel], f"JAX took another path than {kernel}"
    tq, tk, tv = t(qs), t(k), t(v)
    outs["flash_attention_ref"] = tfa.flash_attention_ref(tq, tk, tv, tseg, None, None, causal, DH)
    outs["flash_fwd_stream_ref"] = tfa.flash_fwd_stream_ref(tq, tk, tv, tseg, tseg, None, None,
                                                            causal, DH)
    outs["flash_fwd_band_ref"] = tfa.flash_fwd_band_ref(tq, tk, tv, tseg, tseg, causal, DH)
    valid = seg > 0

    def numpy(x):
        return x.float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)

    rows = {n: (numpy(o)[valid], numpy(lse).transpose(0, 2, 1)[valid])
            for n, (o, lse) in outs.items()}
    names = list(rows)
    for x in range(len(names)):
        for y in range(x + 1, len(names)):
            (go, gl), (wo, wl) = rows[names[x]], rows[names[y]]
            pair = f"{names[x]} against {names[y]}"
            _close(go, wo, dtype, f"out, {pair}")
            if dtype == "float32":
                _close(gl, wl, dtype, f"lse, {pair}")
            else:
                np.testing.assert_allclose(gl, wl, atol=1e-4, rtol=1e-5, err_msg=f"lse, {pair}")


@pytest.mark.parametrize("mask, keys, dtype, dh", _at_dh(
    [("causal", "other", "float32"), ("bi-causal", "same", "bfloat16")],
    [("causal", "other", "bfloat16")]))
def test_band_kernels_with_lse_cotangent_match_jax(mask, keys, dtype, dh, band):
    """The band entries with a cotangent of lse, padded rows, and (for one
    case) key ids from another array, on pre-rotated inputs."""
    b, p, h = 1, 256, 2
    causal, bi = MASKS[mask]
    q, k, v, do, seg, _, _ = _inputs(b, p, h, seed=2, dh=dh)
    qs, k, v, do = (a.reshape(b, p, h * dh) for a in (q * dh**-0.5, k, v, do))
    seg_k = _key_ids(seg) if keys == "other" else seg
    dlse = (np.random.default_rng(9).normal(size=(b, h, p)) * 0.3).astype(np.float32)
    dlse = dlse * (seg > 0)[:, None, :]
    j, t, tdt = _dtypes(dtype)
    jseg, jseg_k = jnp.asarray(seg), jnp.asarray(seg_k)
    jh = JaxHeads(j(qs), j(k), j(v), None, h, dh)
    out, lse = jfa._flash_fwd(jh.qs, jh.k, jh.v, jseg, jseg_k, causal, 64, 64, h, jh.dh_k,
                              bi_split=bi)
    want = jh.back(*jfa._flash_bwd(jh.qs, jh.k, jh.v, jseg, jseg_k, out, lse, jh.pad(j(do)),
                                   causal, h, jh.dh_k, dlse=jnp.asarray(dlse), bi_split=bi))
    out = jh.cut(out)
    assert band["_fwd_kernel_band"] and band["_bwd_kernel_band"], "JAX took another path"
    tseg, tseg_k = torch.from_numpy(seg), torch.from_numpy(seg_k)
    aux = {}
    gout, glse = tfa.flash_fwd_band(t(qs), t(k), t(v), tseg, tseg_k, causal, dh, bi, aux=aux)
    assert torch.equal(aux["table"], tfa.band_limits(tseg, tseg_k))
    assert gout.dtype == tdt
    _close(gout.float().numpy(), out, dtype, "out")
    valid = seg > 0
    np.testing.assert_allclose(glse.numpy().transpose(0, 2, 1)[valid],
                               np.asarray(lse).transpose(0, 2, 1)[valid], atol=1e-4, rtol=1e-5)
    assert np.all(glse.numpy().transpose(0, 2, 1)[~valid] == -1e30)
    tlse = torch.from_numpy(np.array(lse, np.float32))
    aux = {}
    got = tfa.flash_bwd_band(t(qs), t(k), t(v), tseg, tseg_k, t(out), tlse, t(do),
                             torch.from_numpy(dlse), causal, dh, bi, aux=aux)
    torch.testing.assert_close(aux["delta"], tfa.flash_delta(t(do), t(out),
                                                             torch.from_numpy(dlse), dh))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == tdt, name
        _close(g.float().numpy(), w, dtype, name)
    assert np.all(got[0].float().numpy()[~valid] == 0)  # padded query rows
    for g in got[1:]:  # keys that no query row sees
        assert np.all(g.float().numpy()[seg_k == 0] == 0)


def test_above_the_band_limit_both_sides_leave_the_band_kernels(band, monkeypatch):
    """_MAX_BAND 128 on both sides: P 256 runs, q and k rotated outside, on
    the dispatch above the band limit (the JAX package's: the single-block
    forward and, since band mode skips the fused backward, the split pair;
    the streamed kernels above P 2048)."""
    monkeypatch.setattr(jfa, "_MAX_BAND", 128)
    monkeypatch.setattr(tfa, "_MAX_BAND", 128)
    jran = {n: _spy(monkeypatch, jfa, n) for n in ("_fwd_kernel_single", "_dq_kernel_single",
                                                   "_dkv_kernel_single")}
    tran = {n: _spy(monkeypatch, tfa, n) for n in ("flash_fwd_band", "flash_bwd_band",
                                                   "flash_attention_ref", "flash_dq",
                                                   "flash_dkv")}
    b, p, h = 1, 256, 2
    q, k, v, do, seg, cos, sin = _inputs(b, p, h, seed=3)
    (got, want), grads = _attention_both(q, k, v, do, seg, cos, sin, False, 0, "float32")
    assert all(jran.values()) and not band["_fwd_kernel_band"] and not band["_bwd_kernel_band"]
    assert not tran["flash_fwd_band"] and not tran["flash_bwd_band"]
    assert tran["flash_attention_ref"] and tran["flash_dq"] and tran["flash_dkv"]
    _close(got.detach().numpy(), want, "float32", "out")
    for name, (g, w) in zip(("dq", "dk", "dv", "dcos", "dsin"), grads):
        _close(g.numpy(), w, "float32", name)


def _band_segs():
    """Rows of ids: packed; clustered but unsorted (packed runs whose ids
    are permuted); a row whose last two 64-position tiles are padding."""
    rng = np.random.default_rng(11)
    p = 256
    packed = packed_segments(1, p, rng)[0]
    perm = np.concatenate([[0], rng.permutation(packed.max()) + 1]).astype(np.int32)
    unsorted = perm[packed]
    tail = packed_segments(1, p, rng)[0]
    tail[128:] = 0
    return np.stack([packed, unsorted, tail])


@pytest.mark.parametrize("keys", ["same", "other"])
def test_band_limits_is_jax_band_limits(keys):
    seg = _band_segs()
    seg_k = seg if keys == "same" else np.roll(seg, 1, axis=0)
    got = tfa.band_limits(torch.from_numpy(seg), torch.from_numpy(seg_k)).numpy()
    b, p = seg.shape
    assert got.shape == (b, p // 64, 2) and got.dtype == np.int32
    for r in range(b):
        for t in range(p // 64):
            lo, hi = jfa._band_limits(jnp.asarray(seg[r, 64 * t : 64 * t + 64]),
                                      jnp.asarray(seg_k[r]), p, 1)
            assert (int(lo), int(hi)) == tuple(got[r, t]), (r, t)
    assert tuple(got[2, 3]) == (p, -1)  # a tile of padding has an empty band
    assert np.any(got[1, :, 1] - got[1, :, 0] > got[0, :, 1] - got[0, :, 0])


@pytest.mark.parametrize("keys, mask, dtype", [
    ("same", "bidirectional", "float32"), ("same", "causal", "bfloat16"),
    ("other", "causal", "float32"), ("other", "bidirectional", "bfloat16")])
def test_the_backwards_compute_one_function(keys, mask, dtype, band, monkeypatch):
    """B 2 x P 320 (five 64-row tiles), H 2, q and k taken as rotated, a
    padded stretch, out and lse of the port's plain band forward fed to
    every backward: dq, dk, dv of the six (four with other key ids), every
    pair. Every query row that is not padding sees a key, so that the JAX
    kernels, which let exp(S - lse) = 1 spread through a row that sees
    none, compute the port's function."""
    b, p, h = 2, 320, 2
    causal, _ = MASKS[mask]
    q, k, v, do, seg, _, _ = _inputs(b, p, h, seed=5)
    qs, k, v, do = (a.reshape(b, p, h * DH) for a in (q * DH**-0.5, k, v, do))
    seg_k = _key_ids(seg) if keys == "other" else seg
    j, t, _ = _dtypes(dtype)
    tseg, tseg_k = torch.from_numpy(seg), torch.from_numpy(seg_k)
    sees = tfa._valid_mask(tseg, causal, 0, tseg_k).any(dim=-1)[:, 0]
    assert bool((sees == (tseg > 0)).all()), "a query row sees no key"
    tq, tk, tv, tdo = t(qs), t(k), t(v), t(do)
    out, lse = tfa.flash_fwd_band(tq, tk, tv, tseg, tseg_k, causal, DH)
    ran = {n: _spy(monkeypatch, jfa, n) for n in ("_bwd_kernel_fused", "_dq_kernel_stream",
                                                   "_dkv_kernel_stream")}
    ran["_bwd_kernel_band"] = band["_bwd_kernel_band"]
    jout, jlse = j(out.float().numpy()), jnp.asarray(lse.numpy())
    jseg, jseg_k = jnp.asarray(seg), jnp.asarray(seg_k)
    grads = {}
    runs = [("skip", "_dq_kernel_stream"), ("band", "_bwd_kernel_band")]
    if keys == "same":
        runs.insert(0, ("legacy", "_bwd_kernel_fused"))
    for mode, kernel in runs:
        monkeypatch.setattr(jfa, "_MODE", mode)
        grads[kernel] = jfa._flash_bwd(j(qs), j(k), j(v), jseg, jseg_k, jout, jlse, j(do),
                                       causal, h, DH)
        assert ran[kernel], f"JAX took another path than {kernel}"
    assert ran["_dkv_kernel_stream"]
    if keys == "same":
        grads["flash_bwd_ref"] = tfa.flash_bwd_ref(tq, tk, tv, tseg, None, None, out, lse, tdo,
                                                   None, causal, DH)
    dq, delta = tfa.flash_dq_stream(tq, tk, tv, tseg, tseg_k, None, None, out, lse, tdo, None,
                                    causal, DH)
    grads["flash_dq_stream + flash_dkv_stream"] = (dq, *tfa.flash_dkv_stream(
        tq, tk, tv, tseg, tseg_k, None, None, lse, delta, tdo, causal, DH))
    grads["flash_bwd_band"] = tfa.flash_bwd_band(tq, tk, tv, tseg, tseg_k, out, lse, tdo, None,
                                                 causal, DH)

    def numpy(x):
        return x.float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)

    names = list(grads)
    for x in range(len(names)):
        for y in range(x + 1, len(names)):
            for part, g, w in zip(("dq", "dk", "dv"), grads[names[x]], grads[names[y]]):
                _close(numpy(g), numpy(w), dtype, f"{part}, {names[x]} against {names[y]}")


def _denoise_segments(b, p, rng):
    """The denoise rows' layout: a molecule at the front, padding, then BI
    bit slots in the molecule's segment."""
    seg = np.zeros((b, p), np.int32)
    for r in range(b):
        seg[r, : int(rng.integers(10, p - BI))] = 1
        seg[r, p - BI :] = 1
    return seg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_band_backward_matches_jax_on_the_denoise_layout(dtype, band):
    """B 3 x P 88 (a 64-row tile and a 24-row one; the JAX side's blocks are
    8 rows, the largest that divides 88), H 2, bi-causal with 16 bit slots,
    a cotangent of lse (0 on padded rows); the port's plain band forward
    and backward against JAX's interpreted band kernels."""
    b, p, h = 3, 88, 2
    rng = np.random.default_rng(21)
    qs, k, v, do = ((rng.normal(size=(b, p, h * DH)) * 0.5).astype(np.float32)
                    for _ in range(4))
    qs = qs * DH**-0.5
    seg = _denoise_segments(b, p, rng)
    dlse = (rng.normal(size=(b, h, p)) * 0.3).astype(np.float32) * (seg > 0)[:, None, :]
    j, t, tdt = _dtypes(dtype)
    jseg = jnp.asarray(seg)
    out, lse = jfa._flash_fwd(j(qs), j(k), j(v), jseg, jseg, False, 64, 64, h, DH, bi_split=BI)
    want = jfa._flash_bwd(j(qs), j(k), j(v), jseg, jseg, out, lse, j(do), False, h, DH,
                          dlse=jnp.asarray(dlse), bi_split=BI)
    assert band["_fwd_kernel_band"] and band["_bwd_kernel_band"], "JAX took another path"
    tseg = torch.from_numpy(seg)
    gout, glse = tfa.flash_fwd_band(t(qs), t(k), t(v), tseg, tseg, False, DH, BI)
    _close(gout.float().numpy(), out, dtype, "out")
    tlse = torch.from_numpy(np.array(lse, np.float32))
    got = tfa.flash_bwd_band(t(qs), t(k), t(v), tseg, tseg, t(out), tlse, t(do),
                             torch.from_numpy(dlse), False, DH, BI)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == tdt, name
        _close(g.float().numpy(), w, dtype, name)
    for g in got:  # padded rows take no part
        assert np.all(g.float().numpy()[seg == 0] == 0)
