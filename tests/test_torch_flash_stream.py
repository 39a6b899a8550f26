"""The streamed flash attention of the port against the JAX package's, on
the CPU: the plain versions of the CUDA kernels #6 flash_fwd_stream, #7
flash_dq_stream and #8 flash_dkv_stream (which the port's wrappers run on
CPU tensors) against the Pallas kernels `_fwd_kernel_stream`,
`_dq_kernel_stream` and `_dkv_kernel_stream` run in the interpreter
(GGT_PALLAS_INTERPRET=1). Each JAX kernel is wrapped so that the test
asserts it ran: the JAX dispatch reaches them only with more than one kv
block, so the tests reach them at small sizes by

- the forward: `_flash_fwd` with explicit bq = bk = 64 at P 256 (nk 4),
  RoPE in-kernel;
- the backward with in-kernel RoPE: `_MAX_SINGLE_BLOCK` 1024 at P 2048
  (bk 1024, nk 2), B 1, H 1;
- the backward at P 256: `_MODE = "skip"` with 64-row tiles, which takes
  pre-rotated q and k;
- `flash_attention` itself with both sides in skip mode, which the port
  routes to #6-#8 at every P with q and k rotated outside.

Cases: bidirectional, causal and bi-causal (16 bit slots: the split inside
a 64-row tile); key ids equal to the query ids, or another array (the
query ids shifted one position left, so that every query row still sees a
key: the JAX stream kernel gives a row that sees none the mean of the
visited values, the port 0, as a test below pins); with and without a
cotangent of lse (0 on padded rows, which the port leaves out); padded
rows. The plain versions run REF_ROWS query rows at a time; the P 256 cases
cut that to 64 so that the chunking is exercised. Tolerances: fp32, the
sides differ only in the order of fp32 sums, 2e-5. bf16: both round p, ds
and the inverse rotation at the same points (the forward's p relative to
a running max in the kernel, to the row max in the plain version), so they
differ by a flipped bf16 rounding here and there: atol 3e-2, rtol 2e-2
elementwise and 1e-2 in the relative Frobenius norm, as in
test_torch_flash_split_bwd.py. The CUDA kernels are held against these
plain versions in tests/test_torch_gpu.py and chip_smoke.py. Two forward
cases and one P 256 backward case run again at head width 32, which the
JAX package pads to 64 (`JaxHeads`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphgpt_tpu.models.rope import apply_rope as j_apply_rope
from graphgpt_tpu.models.rope import rope_cos_sin as j_rope_cos_sin
from graphgpt_tpu.ops import flash_attention as jfa
from graphgpt_tpu.ops.attention import xla_attention
from graphgpt_torch.ops import flash_attention as tfa
from graphgpt_torch.synthetic import packed_segments
from test_torch_flash_attention import JaxHeads

TOL = 2e-5
DH = 64
BI = 16
MASKS = {"bidirectional": (False, 0), "causal": (True, 0), "bi-causal": (False, BI)}


def _inputs(b, p, h, seed, dh=DH):
    rng = np.random.default_rng(seed)
    q, k, v, do = ((rng.normal(size=(b, p, h * dh)) * 0.5).astype(np.float32) for _ in range(4))
    seg = packed_segments(b, p, rng)
    seg[-1, p - 40 : p - BI] = 0  # a padded stretch before the last row's bit slots
    pos = np.tile(np.arange(p, dtype=np.int32), (b, 1))
    cos, sin = (np.asarray(t) for t in j_rope_cos_sin(jnp.asarray(pos), dh))
    return q * dh**-0.5, k, v, do, seg, cos, sin


def _key_ids(seg, keys):
    """The keys' ids: the query ids, or those shifted one position left."""
    if keys == "same":
        return seg
    out = np.zeros_like(seg)
    out[:, :-1] = seg[:, 1:]
    return out


def _spy(monkeypatch, name):
    """Wrap jfa.<name> so that a test can assert the kernel ran."""
    calls = []
    fn = getattr(jfa, name)

    def wrapped(*args, **kwargs):
        calls.append(1)
        return fn(*args, **kwargs)

    monkeypatch.setattr(jfa, name, wrapped)
    return calls


def _close(g, w, dtype, name):
    g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
    assert g.shape == w.shape, name
    if dtype == "float32":
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=name)
    else:
        np.testing.assert_allclose(g, w, atol=3e-2, rtol=2e-2, err_msg=name)
        assert np.linalg.norm(g - w) / np.linalg.norm(w) < 1e-2, name


def _dtypes(dtype):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return (lambda a: jnp.asarray(a, jdt),
            lambda a: torch.from_numpy(np.array(a, np.float32)).to(tdt), tdt)


# (mask, key ids, dtype): each mask with both kinds of key ids and both
# dtypes, not their whole product, to keep the interpreter's compiles few
FWD_CASES = [("bidirectional", "same", "float32"), ("bidirectional", "other", "bfloat16"),
             ("causal", "same", "bfloat16"), ("causal", "other", "float32"),
             ("bi-causal", "same", "float32"), ("bi-causal", "other", "bfloat16")]
# (mask, key ids, with a cotangent of lse, dtype)
BWD_CASES = [("bidirectional", "same", False, "float32"),
             ("bidirectional", "other", True, "bfloat16"),
             ("causal", "same", True, "float32"), ("causal", "other", False, "bfloat16"),
             ("bi-causal", "same", False, "bfloat16"), ("bi-causal", "other", True, "float32")]


def _at_dh(cases, dh32):
    """The cases at dh 64 under their own ids, and those of `dh32` again at
    head width 32 (padded to 64 on the JAX side, `JaxHeads`)."""
    return ([pytest.param(*c, DH, id="-".join(map(str, c))) for c in cases]
            + [pytest.param(*c, 32, id="dh32-" + "-".join(map(str, c))) for c in dh32])


@pytest.mark.parametrize("mask, keys, dtype, dh", _at_dh(
    FWD_CASES, [("bidirectional", "other", "bfloat16"), ("bi-causal", "same", "float32")]))
def test_forward_ref_matches_interpreted_stream_kernel(mask, keys, dtype, dh, monkeypatch):
    monkeypatch.setenv("GGT_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(tfa, "REF_ROWS", 64)
    ran = _spy(monkeypatch, "_fwd_kernel_stream")
    b, p, h = 2, 256, 2
    causal, bi = MASKS[mask]
    qs, k, v, _, seg, cos, sin = _inputs(b, p, h, seed=1, dh=dh)
    seg_k = _key_ids(seg, keys)
    j, t, tdt = _dtypes(dtype)
    jh = JaxHeads(j(qs), j(k), j(v), (j(cos), j(sin)), h, dh)
    out, lse = jfa._flash_fwd(jh.qs, jh.k, jh.v, jnp.asarray(seg), jnp.asarray(seg_k), causal,
                              64, 64, h, jh.dh_k, bi_split=bi, rope=jh.rope)
    out = jh.cut(out)
    assert ran, "the JAX dispatch did not reach _fwd_kernel_stream"
    tseg, tseg_k = torch.from_numpy(seg), torch.from_numpy(seg_k)
    got, glse = tfa.flash_fwd_stream(t(qs), t(k), t(v), tseg, tseg_k, t(cos), t(sin), causal,
                                     dh, bi)
    assert got.dtype == tdt
    _close(got.float().numpy(), out, dtype, "out")
    valid = seg > 0
    np.testing.assert_allclose(glse.numpy().transpose(0, 2, 1)[valid],
                               np.asarray(lse).transpose(0, 2, 1)[valid], atol=1e-4, rtol=1e-5)
    assert np.all(got.float().numpy()[~valid] == 0)
    assert np.all(glse.numpy().transpose(0, 2, 1)[~valid] == -1e30)


def _bwd_case(jq, jk, jv, jseg, jseg_k, jdo, causal, h, bi, dlse, rope, dh=DH):
    jh = JaxHeads(jq, jk, jv, rope, h, dh)
    out, lse = jfa._flash_fwd(jh.qs, jh.k, jh.v, jseg, jseg_k, causal,
                              *jfa._fwd_blocks(jq.shape[1]), h, jh.dh_k, bi_split=bi,
                              rope=jh.rope)
    want = jh.back(*jfa._flash_bwd(jh.qs, jh.k, jh.v, jseg, jseg_k, out, lse, jh.pad(jdo),
                                   causal, h, jh.dh_k,
                                   dlse=None if dlse is None else jnp.asarray(dlse),
                                   bi_split=bi, rope=jh.rope))
    return jh.cut(out), lse, want


def _port_bwd(t, qs, k, v, seg, seg_k, cos, sin, out, lse, do, dlse, causal, bi, dh=DH):
    tseg, tseg_k = torch.from_numpy(seg), torch.from_numpy(seg_k)
    tlse = torch.from_numpy(np.array(lse, np.float32))
    tdlse = None if dlse is None else torch.from_numpy(dlse)
    tc, ts = (None, None) if cos is None else (t(cos), t(sin))
    dq, delta = tfa.flash_dq_stream(t(qs), t(k), t(v), tseg, tseg_k, tc, ts, t(out), tlse,
                                    t(do), tdlse, causal, dh, bi)
    torch.testing.assert_close(delta, tfa.flash_delta(t(do), t(out), tdlse, dh))
    dk, dv = tfa.flash_dkv_stream(t(qs), t(k), t(v), tseg, tseg_k, tc, ts, tlse, delta, t(do),
                                  causal, dh, bi)
    return dq, dk, dv


@pytest.mark.parametrize("mask, keys, with_dlse, dtype, dh", _at_dh(
    BWD_CASES, [("bi-causal", "other", True, "bfloat16")]))
def test_backward_refs_match_interpreted_stream_kernels(mask, keys, with_dlse, dtype, dh,
                                                         monkeypatch):
    """P 256 in the JAX package's skip mode (64-row tiles, pre-rotated q, k)."""
    monkeypatch.setenv("GGT_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(jfa, "_MODE", "skip")
    monkeypatch.setattr(jfa, "_BAND_BK", 64)
    monkeypatch.setattr(jfa, "_BQ_BWD", 64)
    monkeypatch.setattr(tfa, "REF_ROWS", 64)
    ran = {n: _spy(monkeypatch, n) for n in ("_dq_kernel_stream", "_dkv_kernel_stream")}
    b, p, h = 2, 256, 2
    causal, bi = MASKS[mask]
    qs, k, v, do, seg, cos, sin = _inputs(b, p, h, seed=2, dh=dh)
    # skip mode takes q and k rotated outside the kernel
    rq, rk = j_apply_rope(jnp.asarray(qs.reshape(b, p, h, dh)),
                          jnp.asarray(k.reshape(b, p, h, dh)), jnp.asarray(cos), jnp.asarray(sin))
    qs, k = np.asarray(rq).reshape(b, p, -1), np.asarray(rk).reshape(b, p, -1)
    seg_k = _key_ids(seg, keys)
    dlse = None
    if with_dlse:
        dlse = (np.random.default_rng(9).normal(size=(b, h, p)) * 0.3).astype(np.float32)
        dlse = dlse * (seg > 0)[:, None, :]
    j, t, tdt = _dtypes(dtype)
    out, lse, want = _bwd_case(j(qs), j(k), j(v), jnp.asarray(seg), jnp.asarray(seg_k), j(do),
                               causal, h, bi, dlse, None, dh)
    assert all(ran.values()), "the JAX dispatch did not reach the stream kernels"
    got = _port_bwd(t, qs, k, v, seg, seg_k, None, None, out, lse, do, dlse, causal, bi, dh)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == tdt, name
        _close(g.float().numpy(), w, dtype, name)
    assert np.all(got[0].float().numpy()[seg == 0] == 0)  # padded query rows
    for g in got[1:]:  # keys that no query row sees: padded, or not among seg's ids
        assert np.all(g.float().numpy()[seg_k == 0] == 0)


@pytest.mark.parametrize("mask, dtype", [("bidirectional", "bfloat16"), ("causal", "float32"),
                                         ("bi-causal", "bfloat16")])
def test_backward_refs_with_rope_match_interpreted_stream_kernels(mask, dtype, monkeypatch):
    """P 2048 with the single-block limit cut to 1024: kv blocks of 1024, RoPE
    in-kernel, as the JAX dispatch takes the stream kernels above P 2048."""
    monkeypatch.setenv("GGT_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(jfa, "_MAX_SINGLE_BLOCK", 1024)
    ran = {n: _spy(monkeypatch, n) for n in ("_fwd_kernel_stream", "_dq_kernel_stream",
                                            "_dkv_kernel_stream")}
    b, p, h = 1, 2048, 1
    causal, bi = MASKS[mask]
    qs, k, v, do, seg, cos, sin = _inputs(b, p, h, seed=4)
    j, t, tdt = _dtypes(dtype)
    out, lse, want = _bwd_case(j(qs), j(k), j(v), jnp.asarray(seg), jnp.asarray(seg), j(do),
                               causal, h, bi, None, (j(cos), j(sin)))
    assert all(ran.values()), "the JAX dispatch did not reach the stream kernels"
    tseg = torch.from_numpy(seg)
    gout, glse = tfa.flash_fwd_stream(t(qs), t(k), t(v), tseg, tseg, t(cos), t(sin), causal,
                                      DH, bi)
    _close(gout.float().numpy(), out, dtype, "out")
    got = _port_bwd(t, qs, k, v, seg, seg, cos, sin, out, lse, do, None, causal, bi)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == tdt, name
        _close(g.float().numpy(), w, dtype, name)
        assert np.all(g.float().numpy()[seg == 0] == 0), name


@pytest.mark.parametrize("causal", [False, True], ids=["bidirectional", "causal"])
def test_stream_pair_refs_past_one_mask_match_jax_grad_of_xla_attention(causal):
    """The plain routes of #7 and #8, the yardstick of their card checks, at
    P 4160: past the 4096 rows (64 tiles) that one 64-bit mask of visiting
    tiles covers in the CUDA kernels, with a segment across tiles 63 and 64,
    padding at the end and RoPE, against jax.grad of the JAX package's plain
    attention on the same numpy inputs (fp32: the sides differ only in the
    order of fp32 sums, TOL). xla_attention takes one id array, so the key
    ids are the query ids. B 1, H 1: a few seconds, most of it JAX's
    [P, P] scores."""
    b, p = 1, 4160
    rng = np.random.default_rng(12)
    q, k, v, do = ((rng.normal(size=(b, p, 1, DH)) * 0.5).astype(np.float32) for _ in range(4))
    seg = packed_segments(b, p, rng)
    seg[:, 4096:4112] = seg[:, 4095:4096]  # one segment across tiles 63 and 64
    seg[:, p - 40 :] = 0
    pos = np.tile(np.arange(p, dtype=np.int32), (b, 1))
    cos, sin = (np.array(t) for t in j_rope_cos_sin(jnp.asarray(pos), DH))
    jseg = jnp.asarray(seg)

    def f(q, k, v):
        rq, rk = j_apply_rope(q, k, jnp.asarray(cos), jnp.asarray(sin))
        return jnp.sum(xla_attention(rq, rk, v, jseg, causal) * jnp.asarray(do))

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).reshape(b, p, -1))  # noqa: E731
    tseg, tc, ts = torch.from_numpy(seg), torch.from_numpy(cos), torch.from_numpy(sin)
    qs = t(q) * DH**-0.5
    out, lse = tfa.flash_fwd_stream(qs, t(k), t(v), tseg, tseg, tc, ts, causal, DH)
    dq, delta = tfa.flash_dq_stream(qs, t(k), t(v), tseg, tseg, tc, ts, out, lse, t(do), None,
                                    causal, DH)
    dk, dv = tfa.flash_dkv_stream(qs, t(k), t(v), tseg, tseg, tc, ts, lse, delta, t(do), causal,
                                  DH)
    # dq is the gradient of the pre-scaled q
    for name, g, w in (("dq", dq * DH**-0.5, want[0]), ("dk", dk, want[1]), ("dv", dv, want[2])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w).reshape(b, p, -1), atol=TOL,
                                   rtol=TOL, err_msg=name)
        assert np.all(g.numpy()[seg == 0] == 0), name


def test_a_query_row_that_sees_no_key_gives_zero():
    """Key ids from another array can leave a query row with no key: the
    port gives it out = 0, lse = -1e30 and no gradient (the JAX stream
    kernel gives the mean of the values it visited and lse = -1e30)."""
    b, p, h = 1, 128, 2
    qs, k, v, do, seg, cos, sin = _inputs(b, p, h, seed=5)
    seg = np.ones((b, p), np.int32)
    seg[:, 64:] = 2
    seg_k = np.where(seg == 2, 3, seg).astype(np.int32)  # no key carries id 2
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    tseg, tseg_k = torch.from_numpy(seg), torch.from_numpy(seg_k)
    out, lse = tfa.flash_fwd_stream(t(qs), t(k), t(v), tseg, tseg_k, t(cos), t(sin), False, DH)
    assert torch.all(out[:, 64:] == 0) and torch.all(lse[:, :, 64:] == -1e30)
    assert torch.all(out[:, :64].abs().sum(-1) > 0)
    dq, delta = tfa.flash_dq_stream(t(qs), t(k), t(v), tseg, tseg_k, t(cos), t(sin), out, lse,
                                    t(do), None, False, DH)
    dk, dv = tfa.flash_dkv_stream(t(qs), t(k), t(v), tseg, tseg_k, t(cos), t(sin), lse, delta,
                                  t(do), False, DH)
    assert torch.all(dq[:, 64:] == 0) and torch.all(dk[:, 64:] == 0) and torch.all(dv[:, 64:] == 0)
    # the rows that see their keys are those of one 64-row segment alone
    want = tfa.flash_attention_ref(t(qs)[:, :64], t(k)[:, :64], t(v)[:, :64], tseg[:, :64],
                                   t(cos)[:, :64], t(sin)[:, :64], False, DH)
    torch.testing.assert_close(out[:, :64], want[0], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("bi", [0, BI], ids=["no-split", "bi-causal"])
def test_the_port_routes_rows_longer_than_2048_to_the_stream_entries(bi, monkeypatch):
    """flash_attention and its backward take #6, #7 and #8 above P 2048 (the
    JAX dispatch: the streamed kernels whenever the kv axis is more than
    one block), whatever the split, and #1 and #3 (or #4/#5) up to it."""
    names = ("flash_fwd_stream", "flash_dq_stream", "flash_dkv_stream", "flash_bwd_ref",
             "flash_dq", "flash_dkv")
    calls = {n: 0 for n in names}
    for n in names:
        def wrapped(*a, _fn=getattr(tfa, n), _n=n, **kw):
            calls[_n] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(tfa, n, wrapped)
    rng = np.random.default_rng(6)
    for p, want in ((2048, 0), (2112, 1)):
        for n in names:
            calls[n] = 0
        x = torch.from_numpy((rng.normal(size=(1, p, 1, DH)) * 0.5).astype(np.float32))
        x.requires_grad_(True)
        seg = torch.from_numpy(packed_segments(1, p, rng))
        tfa.flash_attention(x, x, x, seg, bi_causal_split=bi).sum().backward()
        assert calls["flash_fwd_stream"] == calls["flash_dq_stream"] == want
        assert calls["flash_dkv_stream"] == want
        split = (not want) and bi > 0
        assert calls["flash_bwd_ref"] == int(not want and not split)
        assert calls["flash_dq"] == calls["flash_dkv"] == int(split)
        assert torch.isfinite(x.grad).all()


def test_skip_mode_matches_jax_skip_mode_through_the_stream_kernels(monkeypatch):
    """GGT_FLASH_MODE=skip on both sides: flash_attention with RoPE at P 256
    rotates q and k outside the kernels and takes the streamed kernels (the
    JAX package's with 64-key tiles, the port's #6-#8 at every P): out and
    the gradients of q, k, v, cos and sin."""
    monkeypatch.setenv("GGT_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(jfa, "_MODE", "skip")
    monkeypatch.setattr(tfa, "_MODE", "skip")
    monkeypatch.setattr(jfa, "_BAND_BK", 64)
    monkeypatch.setattr(jfa, "_BQ_BWD", 64)
    jran = {n: _spy(monkeypatch, n) for n in ("_fwd_kernel_stream", "_dq_kernel_stream",
                                              "_dkv_kernel_stream")}
    names = ("flash_fwd_stream", "flash_dq_stream", "flash_dkv_stream")
    tran = {n: [] for n in names}
    for n in names:
        def wrapped(*a, _fn=getattr(tfa, n), _n=n, **kw):
            tran[_n].append(1)
            return _fn(*a, **kw)

        monkeypatch.setattr(tfa, n, wrapped)
    b, p, h = 1, 256, 2
    qs, k, v, do, seg, cos, sin = _inputs(b, p, h, seed=8)
    q = (qs * DH**0.5).reshape(b, p, h, DH)
    k, v, do = (a.reshape(b, p, h, DH) for a in (k, v, do))
    jseg = jnp.asarray(seg)
    want, vjp = jax.vjp(lambda *a: jfa.flash_attention(*a[:3], jseg, causal=True, rope=a[3:]),
                        *(jnp.asarray(a) for a in (q, k, v, cos, sin)))
    want_grads = vjp(jnp.asarray(do))
    assert all(jran.values()), "the JAX dispatch did not reach the stream kernels"
    leaves = [torch.from_numpy(np.array(a)).requires_grad_() for a in (q, k, v, cos, sin)]
    got = tfa.flash_attention(*leaves[:3], torch.from_numpy(seg), causal=True,
                              rope=tuple(leaves[3:]))
    got.backward(torch.from_numpy(do))
    assert all(len(c) == 1 for c in tran.values()), tran
    _close(got.detach().numpy(), want, "float32", "out")
    for name, g, w in zip(("dq", "dk", "dv", "dcos", "dsin"), leaves, want_grads):
        _close(g.grad.numpy(), w, "float32", name)


@pytest.mark.parametrize("route", ["stream", "band"])
def test_plain_routes_ignore_non_finite_do_in_padded_rows(route):
    """The plain routes of #7 (flash_dq_stream, its delta and then #8's
    dk, dv) and #10 (flash_bwd_band) take do as zero on padded rows before
    they sum delta, as their kernels do: inf and NaN written there change no
    output bit. The JAX package's outside-kernel delta sums the raw do."""
    b, p, h = 2, 256, 2
    *arrays, seg, _, _ = _inputs(b, p, h, 9)
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16) for x in arrays)
    seg = torch.from_numpy(seg)
    pad = (seg == 0)[..., None].expand_as(do)
    clean = do.masked_fill(pad, 0.0)
    noisy = do.masked_fill(pad, float("nan"))
    noisy[-1].masked_fill_(pad[-1], float("inf"))
    if route == "stream":
        out, lse = tfa.flash_fwd_stream(q, k, v, seg, seg, None, None, True, DH)
    else:
        out, lse = tfa.flash_fwd_band(q, k, v, seg, seg, True, DH)
    runs = []
    for d in (clean, noisy):
        if route == "stream":
            dq, delta = tfa.flash_dq_stream(q, k, v, seg, seg, None, None, out, lse, d, None,
                                            True, DH)
            dk, dv = tfa.flash_dkv_stream(q, k, v, seg, seg, None, None, lse, delta, d, True, DH)
            runs.append((dq, delta, dk, dv))
        else:
            aux = {}
            runs.append((*tfa.flash_bwd_band(q, k, v, seg, seg, out, lse, d, None, True, DH,
                                             aux=aux), aux["delta"]))
    for a, n in zip(*runs):
        assert torch.equal(a, n) and bool(torch.isfinite(n.float()).all())
