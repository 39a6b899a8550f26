"""The port's CUDA kernels against their plain versions, on a CUDA card.

Every test here is marked `gpu` and skips without a card. The file imports
neither JAX nor the JAX package, so that it runs on a machine with a card
and no JAX; there the repository's conftest (which imports JAX) is left
out:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances are in bf16, the kernels' working type: the kernels and the plain
versions round at the same points but sum in another order. The fp32 forms
of #1-#13 (the tests at the end) are held to 2e-5 relative: fp32 sums of
up to a few thousand terms in another order.
"""

import contextlib
import ctypes

import numpy as np
import pytest
import torch

from graphgpt_torch import ops
from graphgpt_torch.config import ModelConfig, OptimizerConfig, flagship_config
from graphgpt_torch.models.heads import GraphGPTPretrain, GraphGPTTask
from graphgpt_torch.models.rope import rope_cos_sin
from graphgpt_torch.ops import flash_attention as tfa
from graphgpt_torch.ops import mlp as tmlp
from graphgpt_torch.synthetic import fake_batch, packed_segments, to_torch
from graphgpt_torch.training.optimizer import make_optimizer
from graphgpt_torch.training.steps import init_train_state, make_train_step


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _bf16(rng, shape, scale, dev):
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(
        dev, torch.bfloat16
    )


def _molecule_segments(b, p, rng):
    """Rows laid out as the fine-tune and position batches lay them out: one
    molecule (one segment) at the front, then padding."""
    seg = np.zeros((b, p), np.int32)
    for r in range(b):
        seg[r, : int(rng.integers(10, p + 1))] = 1
    return seg


# (B, P, H, bit slots, RoPE, row layout) of #1's and #3's cases; "padded-row"
# has a batch row of padding only, whose rows see no key
_FLASH_CASES = {
    "P128": (2, 128, 3, 0, True, "packed"),
    "P200": (2, 200, 3, 0, True, "packed"),
    "P50": (2, 50, 3, 0, True, "molecule"),
    "P72": (4, 72, 12, 0, True, "molecule"),
    "P88": (4, 88, 12, 0, True, "molecule"),
    "P88-bicausal": (4, 88, 12, 16, True, "denoise"),
    "P1000": (2, 1000, 12, 0, True, "packed"),
    "P1024-bicausal": (2, 1024, 12, 16, True, "packed"),
    "P2048": (1, 2048, 12, 0, True, "packed"),
    "no-rope": (4, 88, 12, 0, False, "molecule"),
    "padded-row": (3, 200, 3, 0, True, "padded-row"),
}


def _flash_inputs(case, dev, seed=5):
    """(qs, k, v, do, seg, cos, sin, rng) of a _FLASH_CASES (or _BWD_CASES) case: q
    pre-scaled, the last 30 positions of the last row padded on packed
    rows."""
    b, p, h, bi, rope, layout = _FLASH_CASES.get(case) or _BWD_CASES[case]
    dh = 64
    rng = np.random.default_rng(seed)
    qs = _bf16(rng, (b, p, h * dh), 0.5 * dh**-0.5, dev)
    k, v, do = (_bf16(rng, (b, p, h * dh), 0.5, dev) for _ in range(3))
    if layout == "molecule":
        seg_np = _molecule_segments(b, p, rng)
    elif layout == "denoise":
        seg_np = _denoise_row_segments(b, p, bi, rng)
    else:
        seg_np = packed_segments(b, p, rng)
        seg_np[-1, p - 30 :] = 0
        if layout == "padded-row":
            seg_np[1] = 0
    seg = torch.from_numpy(seg_np).to(dev)
    cos = sin = None
    if rope:
        pos = torch.arange(p, device=dev).expand(b, p)
        cos, sin = (t.to(torch.bfloat16) for t in rope_cos_sin(pos, dh))
    return qs, k, v, do, seg, cos, sin, rng


def _check_fwd(out, lse, rout, rlse, seg):
    """#1 against its plain version: bf16 out elementwise (the kernel rounds
    the probabilities relative to a running max, the plain version relative
    to the row max) and as a whole (a fault on the P.V side cannot hide under
    the elementwise tolerance of small outputs); lse; padded rows exactly 0
    and -1e30."""
    valid = seg > 0
    torch.testing.assert_close(out.float(), rout.float(), atol=2e-2, rtol=2e-2)
    assert _rel(out[valid], rout[valid]) < 1e-2
    torch.testing.assert_close(lse.transpose(1, 2)[valid], rlse.transpose(1, 2)[valid],
                               atol=1e-3, rtol=1e-4)
    assert bool((out[~valid] == 0).all())
    assert bool((lse.transpose(1, 2)[~valid] == -1e30).all())


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True], ids=["bidirectional", "causal"])
@pytest.mark.parametrize("case", list(_FLASH_CASES))
def test_flash_kernel_matches_plain(cuda_device, causal, case):
    """#1 through its wrapper against the plain version, one launch a call,
    the same bits on a relaunch. Cases: packed rows at P 128, 200 (ragged),
    1000 and 2048 (MAX_P); whole molecules at the fine-tune and position
    width 72 and the denoise width 88; bi-causal with 16 bit slots at 88
    (split 72) and 1024 (split 1008, inside a tile; the causal flag then
    changes nothing); P 50, whose 128-row item has one 64-row box; no RoPE;
    a batch row of padding only."""
    dev = cuda_device
    _, p, h, bi, _, _ = _FLASH_CASES[case]
    dh = 64
    qs, k, v, _, seg, cos, sin, _ = _flash_inputs(case, dev)
    args = (qs, k, v, seg, cos, sin, causal, dh, bi)
    before = tfa.flash_fwd.launches
    out, lse = tfa.flash_fwd(*args)
    torch.cuda.synchronize()
    assert tfa.flash_fwd.launches == before + 1
    with ops.reference_mode():
        rout, rlse = tfa.flash_fwd(*args)
    assert tfa.flash_fwd.launches == before + 1
    _check_fwd(out, lse, rout, rlse, seg)
    again = tfa.flash_fwd(*args)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True], ids=["bidirectional", "causal"])
def test_flash_kernel_entry_takes_p4096(cuda_device, causal):
    """#1's C entry at P 4096 (two 64-bit masks of key tiles would be needed
    past it; the dispatch sends such rows to #6) against the plain version
    on 128 query rows a chunk."""
    dev = cuda_device
    b, p, h, dh = 1, 4096, 4, 64
    rng = np.random.default_rng(17)
    qs = _bf16(rng, (b, p, h * dh), 0.5 * dh**-0.5, dev)
    k, v = (_bf16(rng, (b, p, h * dh), 0.5, dev) for _ in range(2))
    seg_np = packed_segments(b, p, rng)
    seg_np[-1, p - 100 :] = 0
    seg = torch.from_numpy(seg_np).to(dev)
    pos = torch.arange(p, device=dev).expand(b, p)
    cos, sin = (t.to(torch.bfloat16) for t in rope_cos_sin(pos, dh))
    out, lse = torch.empty_like(qs), torch.empty(b, h, p, device=dev)
    fn = tfa._build.entry("flash_fwd", "ggt_flash_fwd", tfa._ARGTYPES)
    ptr = tfa._build.ptr
    tfa._build.check(fn(ptr(qs), ptr(k), ptr(v), ptr(seg), ptr(cos), ptr(sin), ptr(out), ptr(lse),
                        b, p, h, int(causal), 0, tfa._build.stream_ptr(dev)), "ggt_flash_fwd")
    torch.cuda.synchronize()
    with ops.reference_mode():
        rout, rlse = tfa.flash_attention_ref(qs, k, v, seg, cos, sin, causal, dh, row_chunk=128)
    _check_fwd(out, lse, rout, rlse, seg)


@pytest.mark.gpu
def test_flash_kernel_raises_outside_this_slice(cuda_device):
    """A bi-causal split runs on the card (the split backward pair), and so
    does P > 2048 (the streamed kernels #6-#8, whatever the split); fp16
    raises (fp32 has forms of its own, below)."""
    dev = cuda_device
    x = torch.zeros(1, 64, 2, 64, device=dev, dtype=torch.bfloat16, requires_grad=True)
    seg = torch.ones(1, 64, dtype=torch.int32, device=dev)
    out = tfa.flash_attention(x, x, x, seg, bi_causal_split=8)
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert torch.isfinite(x.grad.float()).all()
    with pytest.raises(NotImplementedError):
        tfa.flash_attention(x.half(), x.half(), x.half(), seg)
    big = torch.zeros(1, 2112, 1, 64, device=dev, dtype=torch.bfloat16, requires_grad=True)
    seg_big = torch.ones(1, 2112, dtype=torch.int32, device=dev)
    counters = (tfa.flash_fwd_stream, tfa.flash_dq_stream, tfa.flash_dkv_stream, tfa.flash_fwd,
                tfa.flash_bwd, tfa.flash_dq, tfa.flash_dkv)
    for bi in (0, 16):
        before = [c.launches for c in counters]
        tfa.flash_attention(big, big, big, seg_big, bi_causal_split=bi).float().sum().backward()
        torch.cuda.synchronize()
        assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 1, 0, 0, 0, 0]
        assert torch.isfinite(big.grad.float()).all()


def _shifted(seg):
    """Key ids from another array: the query ids one position to the left, so
    that every query row still sees a key."""
    out = torch.zeros_like(seg)
    out[:, :-1] = seg[:, 1:]
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("shape,keys,mask", [
    ((2, 4096, 12), "same", "bidirectional"), ((2, 320, 3), "other", "bidirectional"),
    ((2, 320, 3), "other", "causal"), ((2, 320, 3), "other", "bi-causal"),
    ((1, 4100, 2), "same", "causal"), ((2, 4160, 2), "other", "bidirectional"),
    ((2, 4160, 2), "other", "bi-causal")],
    ids=["P4096", "P320-other", "P320-other-causal", "P320-other-bicausal", "P4100-causal",
         "P4160-other", "P4160-other-bicausal"])
def test_stream_kernels_match_plain(cuda_device, shape, keys, mask):
    """flash_fwd_stream, flash_dq_stream (with its delta and a cotangent of
    lse) and flash_dkv_stream against their plain versions, at the
    tolerances of the single-block kernels; padded rows exactly 0; key ids
    the query ids or another array (bi-causal: 16 bit slots); the same bits
    from run to run, the forward's too. Past P 4096 (65 tiles: two 64-bit
    masks of key or visiting tiles) a segment straddles tiles 63 and 64 on
    the first row."""
    dev = cuda_device
    b, p, h = shape
    dh = 64
    causal, bi = {"bidirectional": (False, 0), "causal": (True, 0), "bi-causal": (False, 16)}[mask]
    rng = np.random.default_rng(13)
    qs = _bf16(rng, (b, p, h * dh), 0.5 * dh**-0.5, dev)
    k, v, do = (_bf16(rng, (b, p, h * dh), 0.5, dev) for _ in range(3))
    seg_np = packed_segments(b, p, rng)
    if p > 4096:  # one segment across the edge of the first 64-bit mask
        seg_np[:, 4096:4112] = seg_np[:, 4095:4096]
    seg_np[-1, p - 100 : p - 20] = 0
    seg = torch.from_numpy(seg_np).to(dev)
    seg_k = seg if keys == "same" else _shifted(seg)
    pos = torch.arange(p, device=dev).expand(b, p)
    cos, sin = (t.to(torch.bfloat16) for t in rope_cos_sin(pos, dh))
    counts = [tfa.flash_fwd_stream.launches, tfa.flash_dq_stream.launches,
              tfa.flash_dkv_stream.launches]
    fwd_args = (qs, k, v, seg, seg_k, cos, sin, causal, dh, bi)
    out, lse = tfa.flash_fwd_stream(*fwd_args)
    torch.cuda.synchronize()
    with ops.reference_mode():
        rout, rlse = tfa.flash_fwd_stream(*fwd_args)
    valid = seg > 0
    torch.testing.assert_close(out.float(), rout.float(), atol=3e-2, rtol=2e-2)
    assert _rel(out[valid], rout[valid]) < 4e-3
    torch.testing.assert_close(lse.transpose(1, 2)[valid], rlse.transpose(1, 2)[valid],
                               atol=1e-3, rtol=1e-4)
    assert bool((out[~valid] == 0).all()) and bool((lse.transpose(1, 2)[~valid] == -1e30).all())
    again = tfa.flash_fwd_stream(*fwd_args)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)
    dlse = torch.from_numpy(rng.normal(size=(b, h, p)).astype(np.float32) * 0.3).to(dev)
    dlse = dlse * valid[:, None, :]
    dq_args = (qs, k, v, seg, seg_k, cos, sin, out, lse, do, dlse, causal, dh, bi)
    dq, delta = tfa.flash_dq_stream(*dq_args)
    dkv_args = (qs, k, v, seg, seg_k, cos, sin, lse, delta, do, causal, dh, bi)
    dk, dv = tfa.flash_dkv_stream(*dkv_args)
    torch.cuda.synchronize()
    with ops.reference_mode():
        rdq, rdelta = tfa.flash_dq_stream(*dq_args)
        rdk, rdv = tfa.flash_dkv_stream(*dkv_args)
    torch.testing.assert_close(delta, rdelta, atol=1e-5, rtol=1e-5)
    for g, r in zip((dq, dk, dv), (rdq, rdk, rdv)):
        torch.testing.assert_close(g.float(), r.float(), atol=3.2e-2, rtol=2e-2)
        assert _rel(g, r) < 2e-3
    assert bool((dq[~valid] == 0).all())
    assert bool((dk[seg_k == 0] == 0).all()) and bool((dv[seg_k == 0] == 0).all())
    assert [tfa.flash_fwd_stream.launches, tfa.flash_dq_stream.launches,
            tfa.flash_dkv_stream.launches] == [counts[0] + 2, counts[1] + 1, counts[2] + 1]
    again = tfa.flash_dkv_stream(*dkv_args)
    assert torch.equal(again[0], dk) and torch.equal(again[1], dv)
    again = tfa.flash_dq_stream(*dq_args)
    assert torch.equal(again[0], dq) and torch.equal(again[1], delta)


@pytest.mark.gpu
@pytest.mark.parametrize("p", [320, 1024])
@pytest.mark.parametrize("mask", ["bidirectional", "causal", "bi-causal"])
def test_stream_forward_gives_the_single_forms_bits(cuda_device, p, mask):
    """flash_fwd_stream on one id array (seg twice) visits the key tiles
    that #1 visits, in the same order: out and lse equal flash_fwd's (#1
    up to P 2048) bit for bit; bi-causal with 16 bit slots."""
    dev = cuda_device
    b, h, dh = 2, 12, 64
    causal, bi = {"bidirectional": (False, 0), "causal": (True, 0), "bi-causal": (False, 16)}[mask]
    rng = np.random.default_rng(23)
    qs = _bf16(rng, (b, p, h * dh), 0.5 * dh**-0.5, dev)
    k, v = (_bf16(rng, (b, p, h * dh), 0.5, dev) for _ in range(2))
    seg_np = packed_segments(b, p, rng)
    seg_np[-1, p - 100 : p - 20] = 0
    seg = torch.from_numpy(seg_np).to(dev)
    pos = torch.arange(p, device=dev).expand(b, p)
    cos, sin = (t.to(torch.bfloat16) for t in rope_cos_sin(pos, dh))
    before = [tfa.flash_fwd.launches, tfa.flash_fwd_stream.launches]
    out, lse = tfa.flash_fwd_stream(qs, k, v, seg, seg, cos, sin, causal, dh, bi)
    out1, lse1 = tfa.flash_fwd(qs, k, v, seg, cos, sin, causal, dh, bi)
    torch.cuda.synchronize()
    assert [tfa.flash_fwd.launches, tfa.flash_fwd_stream.launches] == [c + 1 for c in before]
    assert torch.equal(out, out1) and torch.equal(lse, lse1)


# (N, D, F) of the MLP kernels' cases: the tiny configs' widths, small12's
# D 384 / F 384, GraphGPT-base's at a ragged N (the last 128-row tile one
# row deep)
_MLP_CASES = {
    "ragged": (200, 128, 512),
    "small": (512, 128, 512),
    "d384": (1000, 384, 384),
    "n65537": (65537, 768, 3072),
}


def _mlp_inputs(n, d, f, dev, seed=7):
    """x at unit normal, wn near 1, the weights at 0.55 / sqrt(D) (0.02 at
    D 768, the model's init) so that the outputs have the model's
    magnitude."""
    rng = np.random.default_rng(seed)
    scale = 0.55 / d**0.5
    x = _bf16(rng, (n, d), 1.0, dev)
    wn = torch.from_numpy((1 + 0.1 * rng.normal(size=d)).astype(np.float32)).to(dev)
    wg, wu = _bf16(rng, (f, d), scale, dev), _bf16(rng, (f, d), scale, dev)
    return x, wn, wg, wu, _bf16(rng, (d, f), scale, dev)


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["gelu", "gelu_pytorch_tanh", "silu"])
@pytest.mark.parametrize("case", list(_MLP_CASES))
def test_norm_mlp_kernel_matches_plain(cuda_device, act, case):
    """Kernel #2 against its plain version in bf16 (the same rounding
    points, fp32 sums in another order: 1 ulp of the output), one count a
    call, and bit-equal on a second launch."""
    x, wn, wg, wu, wd = _mlp_inputs(*_MLP_CASES[case], cuda_device)
    before = tmlp.norm_mlp.launches
    out = tmlp.norm_mlp(x, wn, wg, wu, wd, 1e-6, act)
    torch.cuda.synchronize()
    assert tmlp.norm_mlp.launches == before + 1
    with ops.reference_mode():
        ref = tmlp.norm_mlp(x, wn, wg, wu, wd, 1e-6, act)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2, rtol=1e-2)
    assert _rel(out, ref) < 2e-3
    assert torch.equal(tmlp.norm_mlp(x, wn, wg, wu, wd, 1e-6, act), out)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["norm_mlp", "mlp"])
@pytest.mark.parametrize("bh", [128, 64])
@pytest.mark.parametrize("bn", [256, 192, 128, 64])
def test_mlp_kernels_take_every_tile_width(cuda_device, monkeypatch, kernel, bh, bn):
    """Each gate/up width BH and down width BN that the kernels are built
    for, forced in place of mlp_tiles' choice, at D 768, F 3072 and a
    ragged N, against the plain version."""
    x, wn, wg, wu, wd = _mlp_inputs(1000, 768, 3072, cuda_device, seed=bh + bn)
    monkeypatch.setattr(tmlp, "mlp_tiles", lambda *a: (bh, bn))
    args = (x, wn, wg, wu, wd, 1e-6, "gelu") if kernel == "norm_mlp" else (x, wg, wu, wd, "gelu")
    out = getattr(tmlp, kernel)(*args)
    torch.cuda.synchronize()
    with ops.reference_mode():
        ref = getattr(tmlp, kernel)(*args)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2, rtol=1e-2)
    assert _rel(out, ref) < 2e-3


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["norm_mlp", "mlp"])
def test_mlp_kernels_take_no_rows(cuda_device, kernel):
    """N 0 gives an empty output and launches nothing."""
    x, wn, wg, wu, wd = _mlp_inputs(0, 128, 512, cuda_device)
    fn = getattr(tmlp, kernel)
    before = fn.launches
    out = fn(x, wn, wg, wu, wd, 1e-6, "gelu") if kernel == "norm_mlp" else fn(x, wg, wu, wd, "gelu")
    assert tuple(out.shape) == (0, 128) and fn.launches == before


def _tiny_cfg(**kw):
    return ModelConfig(**{
        **dict(vocab_size=50, hidden_size=128, num_hidden_layers=2, stacked_feat=3,
               next_n_token=3, mask_token_id=1), **kw,
    }).finalize()


@pytest.mark.gpu
def test_model_forward_launches_each_kernel_once_per_layer(cuda_device):
    cfg = _tiny_cfg()
    model = GraphGPTPretrain(cfg, device=cuda_device, seed=0)
    batch = to_torch(fake_batch(2, 128, 3, 50, np.random.default_rng(1)), cuda_device)
    fa0, mlp0 = tfa.flash_fwd.launches, tmlp.norm_mlp.launches
    out = model(batch)
    torch.cuda.synchronize()
    assert tfa.flash_fwd.launches - fa0 == cfg.num_hidden_layers
    assert tmlp.norm_mlp.launches - mlp0 == cfg.num_hidden_layers
    with ops.reference_mode():
        ref = model(batch)
    assert abs(out["loss"].item() - ref["loss"].item()) < 5e-3
    torch.testing.assert_close(
        out["hidden_states"].float(), ref["hidden_states"].float(), atol=5e-2, rtol=5e-2
    )


@pytest.mark.gpu
def test_layer_scale_model_goes_through_the_split_kernel_on_cuda(cuda_device):
    """With LayerScale the eval forward takes kernel #11 once a layer and
    the norm-fused kernel never, and agrees with the plain run."""
    cfg = _tiny_cfg(layer_scale_init_value=0.1)
    model = GraphGPTPretrain(cfg, device=cuda_device)
    batch = to_torch(fake_batch(2, 128, 3, 50, np.random.default_rng(1)), cuda_device)
    mlp0, norm0 = tmlp.mlp.launches, tmlp.norm_mlp.launches
    out = model(batch)
    torch.cuda.synchronize()
    assert tmlp.mlp.launches - mlp0 == cfg.num_hidden_layers
    assert tmlp.norm_mlp.launches == norm0
    with ops.reference_mode():
        ref = model(batch)
    assert abs(out["loss"].item() - ref["loss"].item()) < 5e-3
    assert _rel(out["hidden_states"], ref["hidden_states"]) < 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["gelu", "gelu_pytorch_tanh", "silu"])
@pytest.mark.parametrize("case", [*_MLP_CASES, "finetune"])
def test_mlp_kernel_matches_plain(cuda_device, act, case):
    """Kernel #11 against its plain version in bf16: the same rounding
    points, fp32 sums in another order (1 ulp of the output); one count a
    call, and bit-equal on a second launch. The weights are drawn at about
    0.55 / sqrt(D) (0.02 at D 768, the model's init), so that the outputs
    have the model's magnitude."""
    shape = (18432, 768, 3072) if case == "finetune" else _MLP_CASES[case]
    x, _, wg, wu, wd = _mlp_inputs(*shape, cuda_device, seed=12)
    before = tmlp.mlp.launches
    out = tmlp.mlp(x, wg, wu, wd, act)
    torch.cuda.synchronize()
    assert tmlp.mlp.launches == before + 1
    with ops.reference_mode():
        ref = tmlp.mlp(x, wg, wu, wd, act)
    assert tmlp.mlp.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2, rtol=1e-2)
    assert _rel(out, ref) < 2e-3
    assert torch.equal(tmlp.mlp(x, wg, wu, wd, act), out)


@pytest.mark.gpu
def test_mlp_kernel_raises_outside_its_shapes(cuda_device):
    dev = cuda_device
    x = torch.zeros(8, 128, device=dev, dtype=torch.bfloat16)
    w = torch.zeros(256, 128, device=dev, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):  # fp32 x with bf16 weights (fp32 takes mlp_f32)
        tmlp.mlp(x.float(), w, w, w.t().contiguous(), "gelu")
    with pytest.raises(NotImplementedError):  # fp16
        tmlp.mlp(x.half(), w.half(), w.half(), w.t().half(), "gelu")
    with pytest.raises(NotImplementedError):
        odd = torch.zeros(8, 100, device=dev, dtype=torch.bfloat16)
        wo = torch.zeros(256, 100, device=dev, dtype=torch.bfloat16)
        tmlp.mlp(odd, wo, wo, wo.t().contiguous(), "gelu")
    with pytest.raises(ValueError):
        tmlp.mlp(x, w, w, w.t().contiguous(), "relu")
    with pytest.raises(NotImplementedError):  # norm_mlp keeps wn's row in shared memory
        wide = torch.zeros(8, 8256, device=dev, dtype=torch.bfloat16)
        ww = torch.zeros(64, 8256, device=dev, dtype=torch.bfloat16)
        tmlp.norm_mlp(wide, torch.ones(8256, device=dev), ww, ww, ww.t().contiguous(), 1e-6,
                      "gelu")


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


# #3's cases beyond _FLASH_CASES (which it takes without their bit slots):
# the serving and a larger batch of packed rows
_BWD_CASES = {**{c: v for c, v in _FLASH_CASES.items() if v[3] == 0},
              "flagship": (8, 1024, 12, 0, True, "packed"),
              "flagship-24-rows": (24, 1024, 12, 0, True, "packed")}


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True], ids=["bidirectional", "causal"])
@pytest.mark.parametrize("case", list(_BWD_CASES))
def test_flash_bwd_kernel_matches_plain(cuda_device, causal, case):
    """dq, dk, dv in bf16: the kernel rounds p and ds where the plain version
    does and sums in another order (2 ulps of the largest values, and 2e-3 in
    the relative Frobenius norm); padded rows exactly 0. A non-zero dlse on
    the valid rows goes through the delta term. One launch a call, the same
    bits on a relaunch."""
    dev = cuda_device
    b, p, h, _, _, _ = _BWD_CASES[case]
    dh = 64
    qs, k, v, do, seg, cos, sin, rng = _flash_inputs(case, dev, seed=6)
    out, lse = tfa.flash_fwd(qs, k, v, seg, cos, sin, causal, dh)
    dlse = torch.from_numpy(rng.normal(size=(b, h, p)).astype(np.float32) * 0.3).to(dev)
    dlse = dlse * (seg > 0)[:, None, :]
    valid = seg > 0
    for dl in (None, dlse):
        args = (qs, k, v, seg, cos, sin, out, lse, do, dl, causal, dh)
        before = tfa.flash_bwd.launches
        got = tfa.flash_bwd(*args)
        torch.cuda.synchronize()
        assert tfa.flash_bwd.launches == before + 1
        with ops.reference_mode():
            ref = tfa.flash_bwd(*args)
        assert tfa.flash_bwd.launches == before + 1
        for g, r in zip(got, ref):
            torch.testing.assert_close(g.float(), r.float(), atol=3.2e-2, rtol=2e-2)
            assert _rel(g, r) < 2e-3
            assert bool((g[~valid] == 0).all())
        again = tfa.flash_bwd(*args)
        assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["P88", "P1000"])
def test_flash_bwd_ignores_non_finite_do_in_padded_rows(cuda_device, case):
    """inf and NaN in do's padded rows (which TMA brings in raw) change no
    bit of dq, dk or dv."""
    dev = cuda_device
    dh = 64
    qs, k, v, do, seg, cos, sin, _ = _flash_inputs(case, dev, seed=13)
    out, lse = tfa.flash_fwd(qs, k, v, seg, cos, sin, False, dh)
    pad = (seg == 0)[..., None]
    assert bool(pad.any())
    clean = torch.where(pad, torch.zeros_like(do), do)
    noisy = clean.clone()
    noisy[pad.expand_as(noisy)] = float("nan")
    noisy[-1][pad[-1, :, 0]] = float("inf")
    runs = [tfa.flash_bwd(qs, k, v, seg, cos, sin, out, lse, d, None, False, dh)
            for d in (clean, noisy)]
    torch.cuda.synchronize()
    for a, n in zip(*runs):
        assert bool(torch.isfinite(a.float()).all())
        assert torch.equal(a, n)


@pytest.mark.gpu
def test_flash_kernels_raise_outside_their_contract(cuda_device):
    """#1 and #3 refuse fp16 (and a mix of dtypes), head dim 32 and a
    misaligned view on the host; #3's entry refuses P past MAX_P (the
    wrapper sends such rows to the streamed pair) with its own code."""
    dev = cuda_device
    qs, k, v, do, seg, cos, sin, _ = _flash_inputs("P72", dev)
    dh = 64
    out, lse = tfa.flash_fwd(qs, k, v, seg, cos, sin, False, dh)
    with pytest.raises(NotImplementedError):  # fp16
        tfa.flash_fwd(qs.half(), k.half(), v.half(), seg, cos, sin, False, dh)
    with pytest.raises(NotImplementedError):
        tfa.flash_bwd(qs.half(), k.half(), v.half(), seg, cos, sin, out.half(), lse,
                      do.half(), None, False, dh)
    with pytest.raises(NotImplementedError):  # fp32 q with bf16 k and v
        tfa.flash_fwd(qs.float(), k, v, seg, cos, sin, False, dh)
    with pytest.raises(NotImplementedError):  # head dim 32
        tfa.flash_fwd(qs, k, v, seg, None, None, False, 32)
    with pytest.raises(NotImplementedError):
        tfa.flash_bwd(qs, k, v, seg, None, None, out, lse.repeat(1, 2, 1), do, None, False, 32)
    flat = torch.zeros(qs.numel() + 1, device=dev, dtype=torch.bfloat16)
    view = flat[1:].view(qs.shape)  # a contiguous view 2 bytes past an aligned base
    view.copy_(qs)
    with pytest.raises(ValueError):
        tfa.flash_fwd(view, k, v, seg, cos, sin, False, dh)
    with pytest.raises(ValueError):
        tfa.flash_bwd(qs, k, v, seg, cos, sin, out, lse, view, None, False, dh)
    b, p, h = 1, tfa.MAX_P + 64, 2
    big = torch.zeros(b, p, h * dh, device=dev, dtype=torch.bfloat16)
    big_seg = torch.ones(b, p, device=dev, dtype=torch.int32)
    big_rows = torch.zeros(b, h, p, device=dev)
    fn = tfa._build.entry("flash_bwd", "ggt_flash_bwd", tfa._BWD_ARGTYPES)
    ptr = tfa._build.ptr
    err = fn(ptr(big), ptr(big), ptr(big), ptr(big_seg), None, None, ptr(big), ptr(big_rows),
             ptr(big), None, ptr(big_rows), ptr(big), ptr(big), ptr(big), b, p, h, 0,
             tfa._build.stream_ptr(dev))
    assert err == 1002


def _denoise_row_segments(b, p, bi, rng):
    """Rows laid out as the denoise batch lays them out: a molecule at the
    front, padding, then `bi` bit slots in the molecule's segment."""
    seg = np.zeros((b, p), np.int32)
    for r in range(b):
        seg[r, : int(rng.integers(10, p - bi))] = 1
        seg[r, p - bi :] = 1
    return seg


# (B, P, H, bit slots, causal, RoPE, row layout) of the split pair's cases
_SPLIT_CASES = {
    "denoise": (4, 88, 12, 16, False, True, "denoise"),
    "P1024": (2, 1024, 12, 16, False, True, "packed"),
    "split-on-edge": (2, 128, 3, 64, False, True, "denoise"),
    "P72": (4, 72, 12, 16, False, True, "denoise"),
    "P50": (2, 50, 3, 16, False, True, "denoise"),
    "P1000": (2, 1000, 12, 16, False, True, "packed"),
    "P2048": (1, 2048, 12, 16, False, True, "packed"),
    "causal-split": (2, 200, 3, 16, True, True, "packed"),
    "causal-no-split": (2, 300, 3, 0, True, True, "packed"),
    "no-rope": (4, 88, 12, 16, False, False, "denoise"),
}


def _split_inputs(case, dev, seed=11, dtype=torch.bfloat16):
    """(qs, k, v, do, seg, cos, sin) of a _SPLIT_CASES case in `dtype`."""
    b, p, h, bi, _, rope, layout = _SPLIT_CASES[case]
    dh = 64
    rng = np.random.default_rng(seed)

    def draw(shape, scale):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(dev, dtype)

    qs = draw((b, p, h * dh), 0.5 * dh**-0.5)
    k, v, do = (draw((b, p, h * dh), 0.5) for _ in range(3))
    seg_np = _denoise_row_segments(b, p, bi, rng) if layout == "denoise" \
        else packed_segments(b, p, rng)
    seg = torch.from_numpy(seg_np).to(dev)
    cos = sin = None
    if rope:
        pos = torch.arange(p, device=dev).expand(b, p)
        cos, sin = (t.to(dtype) for t in rope_cos_sin(pos, dh))
    return qs, k, v, do, seg, cos, sin, rng


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(_SPLIT_CASES))
def test_split_backward_kernels_match_plain(cuda_device, case):
    """flash_dq (with its delta, a cotangent of lse folded in), flash_dkv
    and the forward against their plain versions, at the tolerances of the
    fused kernels; padded rows exactly 0. Cases: 16 bit slots (64 on
    split-on-edge, a split on a tile edge), P under one 128-row block (72;
    50, whose block has one 64-row box), ragged long rows (1000), MAX_P,
    causal with and without a split, no RoPE. With a split the backward
    wrapper launches each split kernel once and the fused one not at all;
    two launches give the same bits."""
    dev = cuda_device
    b, p, h, bi, causal, _, _ = _SPLIT_CASES[case]
    dh = 64
    qs, k, v, do, seg, cos, sin, rng = _split_inputs(case, dev)
    out, lse = tfa.flash_fwd(qs, k, v, seg, cos, sin, causal, dh, bi)
    torch.cuda.synchronize()
    with ops.reference_mode():
        rout, rlse = tfa.flash_fwd(qs, k, v, seg, cos, sin, causal, dh, bi)
    valid = seg > 0
    torch.testing.assert_close(out.float(), rout.float(), atol=3e-2, rtol=2e-2)
    assert _rel(out[valid], rout[valid]) < 4e-3
    torch.testing.assert_close(lse.transpose(1, 2)[valid], rlse.transpose(1, 2)[valid],
                               atol=1e-3, rtol=1e-4)
    assert bool((out[~valid] == 0).all())
    dlse = torch.from_numpy(rng.normal(size=(b, h, p)).astype(np.float32) * 0.3).to(dev)
    dlse = dlse * valid[:, None, :]  # padded rows take no part in the backward
    dq_args = (qs, k, v, seg, cos, sin, out, lse, do, dlse, causal, dh, bi)
    before = (tfa.flash_dq.launches, tfa.flash_dkv.launches)
    dq, delta = tfa.flash_dq(*dq_args)
    args = (qs, k, v, seg, cos, sin, lse, delta, do, causal, dh, bi)
    dk, dv = tfa.flash_dkv(*args)
    torch.cuda.synchronize()
    assert (tfa.flash_dq.launches, tfa.flash_dkv.launches) == (before[0] + 1, before[1] + 1)
    with ops.reference_mode():
        rdq, rdelta = tfa.flash_dq(*dq_args)
        rdk, rdv = tfa.flash_dkv(*args)
    # delta sums 64 bf16 products in fp32 in another order
    torch.testing.assert_close(delta, rdelta, atol=1e-5, rtol=1e-5)
    for g, r in zip((dq, dk, dv), (rdq, rdk, rdv)):
        torch.testing.assert_close(g.float(), r.float(), atol=3.2e-2, rtol=2e-2)
        assert _rel(g, r) < 2e-3
        assert bool((g[~valid] == 0).all())
    if bi > 0:
        before = (tfa.flash_dq.launches, tfa.flash_dkv.launches, tfa.flash_bwd.launches)
        got = tfa.flash_bwd(qs, k, v, seg, cos, sin, out, lse, do, dlse, causal, dh, bi)
        torch.cuda.synchronize()
        assert (tfa.flash_dq.launches, tfa.flash_dkv.launches, tfa.flash_bwd.launches) == (
            before[0] + 1, before[1] + 1, before[2])
    else:
        got = tfa.flash_dq(*dq_args)[:1] + tfa.flash_dkv(*args)
    for g, r in zip(got, (dq, dk, dv)):
        assert torch.equal(g, r)  # no atomics: the same bits every run


@pytest.mark.gpu
def test_split_backward_ignores_non_finite_do_in_padded_rows(cuda_device):
    """inf and NaN in do's padded rows (which TMA brings in raw) change no
    bit of dq, delta, dk or dv."""
    dev = cuda_device
    b, p, h, bi, causal, _, _ = _SPLIT_CASES["denoise"]
    dh = 64
    qs, k, v, do, seg, cos, sin, _ = _split_inputs("denoise", dev, seed=13)
    out, lse = tfa.flash_fwd(qs, k, v, seg, cos, sin, causal, dh, bi)
    pad = (seg == 0)[..., None]
    assert bool(pad.any())
    clean = torch.where(pad, torch.zeros_like(do), do)
    noisy = clean.clone()
    noisy[pad.expand_as(noisy)] = float("nan")
    noisy[0][pad[0, :, 0]] = float("inf")
    runs = []
    for d in (clean, noisy):
        dq, delta = tfa.flash_dq(qs, k, v, seg, cos, sin, out, lse, d, None, causal, dh, bi)
        dk, dv = tfa.flash_dkv(qs, k, v, seg, cos, sin, lse, delta, d, causal, dh, bi)
        runs.append((dq, delta, dk, dv))
    torch.cuda.synchronize()
    for a, n in zip(*runs):
        assert bool(torch.isfinite(a.float()).all())
        assert torch.equal(a, n)


@pytest.mark.gpu
def test_split_backward_kernels_raise_outside_their_contract(cuda_device):
    dev = cuda_device
    qs, k, v, do, seg, cos, sin, _ = _split_inputs("P72", dev)
    bi, dh = 16, 64
    out, lse = tfa.flash_fwd(qs, k, v, seg, cos, sin, False, dh, bi)
    delta = torch.zeros_like(lse)

    def both(qs, k, v, do, out, dh=dh):
        tfa.flash_dq(qs, k, v, seg, cos, sin, out, lse, do, None, False, dh, bi)
        tfa.flash_dkv(qs, k, v, seg, cos, sin, lse, delta, do, False, dh, bi)

    with pytest.raises(NotImplementedError):  # fp32 q beside bf16 k, v (fp32 takes the fp32 pair)
        both(qs.float(), k, v, do, out)
    with pytest.raises(NotImplementedError):  # fp16
        both(qs.half(), k.half(), v.half(), do.half(), out.half())
    with pytest.raises(NotImplementedError):  # head dim 32
        tfa.flash_dq(qs, k, v, seg, None, None, out, lse.repeat(1, 2, 1), do, None, False, 32,
                     bi)
    with pytest.raises(NotImplementedError):  # head dim 32
        tfa.flash_dkv(qs, k, v, seg, None, None, lse.repeat(1, 2, 1), delta.repeat(1, 2, 1), do,
                      False, 32, bi)
    with pytest.raises(ValueError):  # a contiguous view 2 bytes past an aligned base
        flat = torch.zeros(qs.numel() + 1, device=dev, dtype=torch.bfloat16)
        view = flat[1:].view(qs.shape)
        view.copy_(qs)
        both(view, k, v, do, out)
    with pytest.raises(ValueError):  # the same for flash_dkv alone
        tfa.flash_dkv(qs, k, v, seg, cos, sin, lse, delta, view, False, dh, bi)
    b, h = qs.shape[0], lse.shape[1]
    long_rows = torch.zeros(b, 2112, h * dh, device=dev, dtype=torch.bfloat16)
    long_seg = torch.ones(b, 2112, device=dev, dtype=torch.int32)
    long_lse = torch.zeros(b, h, 2112, device=dev)
    with pytest.raises(NotImplementedError):  # P past MAX_P
        tfa.flash_dq(long_rows, long_rows, long_rows, long_seg, None, None, long_rows, long_lse,
                     long_rows, None, False, dh, bi)
    with pytest.raises(NotImplementedError):
        tfa.flash_dkv(long_rows, long_rows, long_rows, long_seg, None, None, long_lse, long_lse,
                      long_rows, False, dh, bi)


@pytest.mark.gpu
def test_denoise_step_goes_through_the_split_kernels(cuda_device):
    """One training step of a 2-layer denoise model at GraphGPT-base width
    with 16 bit slots on a mol3d batch: per layer one flash_dq and one
    flash_dkv, no fused backward; the step's gradients against the plain
    run, the same draws, 5e-2 in the relative Frobenius norm."""
    from graphgpt_torch.models.denoise import GraphGPTDenoise, denoise_draws
    from graphgpt_torch.synthetic import mol3d_batch

    cfg = ModelConfig(vocab_size=755, hidden_size=768, num_hidden_layers=2, stacked_feat=13,
                      next_n_token=1, mask_token_id=1, task_type="graph",
                      stacked_feat_agg_method="gated", problem_type="regression",
                      loss_type="l1", bi_causal_split=16).finalize()
    model = GraphGPTDenoise(cfg, device=cuda_device, seed=0)
    batch = to_torch(mol3d_batch(8, 88, seed=0, bi_split=16), cuda_device)
    draws = denoise_draws(8, 88, torch.Generator(device=cuda_device).manual_seed(1), cuda_device)

    def run():
        model.zero_grad(set_to_none=True)
        out = model(batch, train=True, draws=draws)
        out["loss"].backward()
        return out, {k: q.grad.clone() for k, q in model.named_parameters() if q.grad is not None}

    counters = (tfa.flash_dq, tfa.flash_dkv, tfa.flash_bwd, tfa.flash_fwd)
    before = [c.launches for c in counters]
    out_k, grads_k = run()
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [2, 2, 0, 2]
    with ops.reference_mode():
        out_p, grads_p = run()
    assert abs(out_k["loss"].item() - out_p["loss"].item()) < 5e-3
    assert out_k["task_logits"].shape == (8, 1)
    assert set(grads_k) == set(grads_p)
    for name in grads_k:
        assert torch.isfinite(grads_k[name]).all(), name
        assert _rel(grads_k[name], grads_p[name]) < 5e-2, name


@pytest.mark.gpu
def test_flash_bwd_is_the_same_from_run_to_run(cuda_device):
    dev = cuda_device
    rng = np.random.default_rng(8)
    b, p, h, dh = 4, 512, 4, 64
    qs, k, v, do = (_bf16(rng, (b, p, h * dh), 0.3, dev) for _ in range(4))
    seg = torch.from_numpy(packed_segments(b, p, rng)).to(dev)
    out, lse = tfa.flash_fwd(qs, k, v, seg, None, None, False, dh)
    first = tfa.flash_bwd(qs, k, v, seg, None, None, out, lse, do, None, False, dh)
    for _ in range(3):
        again = tfa.flash_bwd(qs, k, v, seg, None, None, out, lse, do, None, False, dh)
        assert all(torch.equal(a, f) for a, f in zip(again, first))


@pytest.mark.gpu
def test_flash_attention_backward_goes_through_the_kernel(cuda_device):
    dev = cuda_device
    rng = np.random.default_rng(9)
    b, p, h, hkv, dh = 2, 128, 4, 2, 64
    q = _bf16(rng, (b, p, h, dh), 0.5, dev).requires_grad_()
    k, v = (_bf16(rng, (b, p, hkv, dh), 0.5, dev).requires_grad_() for _ in range(2))
    seg = torch.from_numpy(packed_segments(b, p, rng)).to(dev)
    rope = rope_cos_sin(torch.arange(p, device=dev).expand(b, p), dh)
    do = _bf16(rng, (b, p, h, dh), 0.5, dev)

    def grads():
        out = tfa.flash_attention(q, k, v, seg, rope=rope)
        return torch.autograd.grad(out, (q, k, v), do)

    before = tfa.flash_bwd.launches
    got = grads()
    torch.cuda.synchronize()
    assert tfa.flash_bwd.launches == before + 1
    with ops.reference_mode():
        ref = grads()
    for g, r in zip(got, ref):
        assert g.shape == r.shape and _rel(g, r) < 5e-3


@pytest.mark.gpu
def test_flash_attention_backward_carries_the_cotangent_of_lse(cuda_device):
    """A loss on lse reaches q and k through the kernel's dlse input."""
    dev = cuda_device
    rng = np.random.default_rng(11)
    b, p, h, dh = 2, 128, 4, 64
    q, k, v = (_bf16(rng, (b, p, h, dh), 0.5, dev).requires_grad_() for _ in range(3))
    seg = torch.from_numpy(packed_segments(b, p, rng)).to(dev)
    rope = rope_cos_sin(torch.arange(p, device=dev).expand(b, p), dh)
    do = _bf16(rng, (b, p, h, dh), 0.5, dev)
    w = torch.from_numpy(rng.normal(size=(b, h, p)).astype(np.float32) * 0.3).to(dev)

    def grads(with_out):
        out, lse = tfa.flash_attention(q, k, v, seg, rope=rope, return_lse=True)
        loss = (lse * w).sum() + ((out.float() * do.float()).sum() if with_out else 0.0)
        return torch.autograd.grad(loss, (q, k, v), allow_unused=True)

    for with_out in (True, False):
        before = tfa.flash_bwd.launches
        got = grads(with_out)
        torch.cuda.synchronize()
        assert tfa.flash_bwd.launches == before + 1
        with ops.reference_mode():
            ref = grads(with_out)
        assert got[0].abs().max() > 0
        for g, r in zip(got[:2], ref[:2]):
            assert _rel(g, r) < 5e-3
        if with_out:
            assert _rel(got[2], ref[2]) < 5e-3
        else:
            assert not bool(got[2].any())  # lse does not depend on v


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(200, 128), (1000, 1600), (65536, 768), (65537, 768),
                                   (4096, 384)],
                         ids=["small", "wide", "flagship", "ragged", "d384"])
def test_rmsnorm_bwd_kernel_matches_plain(cuda_device, shape):
    """dx bf16 within 1 ulp of the largest values; dw fp32, a sum over N rows
    in another order than torch.sum's (1e-3 of |dw| + 1)."""
    dev = cuda_device
    n, d = shape
    rng = np.random.default_rng(10)
    x, g = _bf16(rng, (n, d), 1.5, dev), _bf16(rng, (n, d), 1.0, dev)
    w = torch.from_numpy((1 + 0.1 * rng.normal(size=d)).astype(np.float32)).to(dev)
    before = tmlp.rmsnorm_bwd.launches
    dx, dw = tmlp.rmsnorm_bwd(x, g, w, 1e-6)
    torch.cuda.synchronize()
    assert tmlp.rmsnorm_bwd.launches == before + 1
    with ops.reference_mode():
        rdx, rdw = tmlp.rmsnorm_bwd(x, g, w, 1e-6)
    assert tmlp.rmsnorm_bwd.launches == before + 1
    torch.testing.assert_close(dx.float(), rdx.float(), atol=3.2e-2, rtol=1e-2)
    assert _rel(dx, rdx) < 2e-3
    assert bool(((dw - rdw).abs() <= 1e-3 * (rdw.abs() + 1)).all())
    again = tmlp.rmsnorm_bwd(x, g, w, 1e-6)
    assert torch.equal(again[0], dx) and torch.equal(again[1], dw)  # no atomics


@pytest.mark.gpu
def test_rmsnorm_bwd_kernel_raises_outside_its_shapes(cuda_device):
    dev = cuda_device
    x = torch.zeros(8, 128, device=dev, dtype=torch.bfloat16)
    w = torch.ones(128, device=dev)
    with pytest.raises(NotImplementedError):  # fp16
        tmlp.rmsnorm_bwd(x.half(), x.half(), w, 1e-6)
    with pytest.raises(NotImplementedError):  # fp32 x with a bf16 cotangent
        tmlp.rmsnorm_bwd(x.float(), x, w, 1e-6)
    wide = torch.zeros(8, 4096, device=dev, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        tmlp.rmsnorm_bwd(wide, wide, torch.ones(4096, device=dev), 1e-6)
    with pytest.raises(ValueError):
        tmlp.rmsnorm_bwd(x, x.cpu(), w, 1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("policy,fwd_per_layer", [("save_attn", 1), ("full", 2), ("off", 1)])
def test_training_step_launch_counts(cuda_device, policy, fwd_per_layer):
    """One training step: per layer one flash_bwd and one norm_mlp, one
    rmsnorm_bwd a layer plus the final norm's; the flash forward runs once a
    layer unless the rematerialisation recomputes it (full)."""
    kw = dict(remat=policy != "off", remat_policy=policy if policy != "off" else "full")
    cfg = _tiny_cfg(**kw)
    model = GraphGPTPretrain(cfg, device=cuda_device, seed=0)
    batch = to_torch(fake_batch(2, 128, 3, 50, np.random.default_rng(1)), cuda_device)
    opt_cfg = OptimizerConfig(lr=1e-3, scheduler="constant", use_ema=True)
    tx = make_optimizer(opt_cfg, 10, 1)
    state = init_train_state(model, tx, use_ema=True)
    step = make_train_step(tx, opt_cfg)
    counters = {"flash_fwd": tfa.flash_fwd, "flash_bwd": tfa.flash_bwd,
                "norm_mlp": tmlp.norm_mlp, "rmsnorm_bwd": tmlp.rmsnorm_bwd}
    losses = []
    for _ in range(3):
        before = {k: f.launches for k, f in counters.items()}
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        got = {k: f.launches - before[k] for k, f in counters.items()}
        n = cfg.num_hidden_layers
        assert got == {"flash_fwd": fwd_per_layer * n, "flash_bwd": n, "norm_mlp": n,
                       "rmsnorm_bwd": n + 1}
        losses.append(metrics["loss"].item())
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


@pytest.mark.gpu
def test_training_gradients_match_the_plain_run(cuda_device):
    """A 2-layer model at GraphGPT-base width in bf16: every gradient of the
    kernel path against the plain path, 5e-2 in the relative Frobenius norm
    (the same rounding points, another order of sums, through the depth)."""
    cfg = flagship_config(layers=2)
    model = GraphGPTPretrain(cfg, device=cuda_device, seed=0)
    batch = to_torch(fake_batch(2, 1024, 13, 754, np.random.default_rng(2)), cuda_device)

    def run():
        model.zero_grad(set_to_none=True)
        loss = model(batch, train=True)["loss"]
        loss.backward()
        return loss.item(), {k: p.grad.clone() for k, p in model.named_parameters()}

    loss_k, grads_k = run()
    with ops.reference_mode():
        loss_p, grads_p = run()
    assert abs(loss_k - loss_p) < 5e-3
    for name in grads_k:
        assert _rel(grads_k[name], grads_p[name]) < 5e-2, name


@pytest.mark.gpu
@pytest.mark.parametrize("kw,kernel", [(dict(path_dropout=0.1), "mlp"),
                                       (dict(mlp_dropout=0.1), None)],
                         ids=["path_dropout", "mlp_dropout"])
def test_split_mlp_models_train_on_cuda(cuda_device, kw, kernel):
    """DropPath takes kernel #11 in training; MLP dropout the plain
    `xla_mlp`, as the JAX package does; eval (no masks) the norm-fused
    kernel."""
    cfg = _tiny_cfg(**kw)
    model = GraphGPTPretrain(cfg, device=cuda_device)
    batch = to_torch(fake_batch(2, 64, 3, 50, np.random.default_rng(1)), cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    mlp0, norm0 = tmlp.mlp.launches, tmlp.norm_mlp.launches
    out = model(batch, generator=gen, train=True)
    out["loss"].backward()
    torch.cuda.synchronize()
    assert tmlp.mlp.launches - mlp0 == (cfg.num_hidden_layers if kernel else 0)
    assert tmlp.norm_mlp.launches == norm0
    assert all(torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None)
    assert torch.isfinite(model.loss(batch))
    assert tmlp.norm_mlp.launches - norm0 == cfg.num_hidden_layers


@pytest.mark.gpu
def test_finetune_step_launch_counts(cuda_device):
    """A fine-tune step of a LayerScale model with DropPath under `pairs`:
    per layer two mlp launches (forward and recompute; the backward is torch
    ops), two flash forwards, one flash backward, two RMSNorm backwards, and
    the final norm's; no norm_mlp. The EMA eval forward: one mlp a layer."""
    cfg = _tiny_cfg(layer_scale_init_value=1.0, path_dropout=0.1, attention_dropout=0.1,
                    remat=True, remat_policy="pairs", use_generative=False, task_type="graph",
                    problem_type="regression", loss_type="l1", next_n_token=1)
    model = GraphGPTTask(cfg, device=cuda_device, seed=0)
    nb = fake_batch(4, 64, 3, 50, np.random.default_rng(1))
    nb["graph_labels"] = np.random.default_rng(2).normal(5, 1, size=(4, 1)).astype(np.float32)
    batch = to_torch(nb, cuda_device)
    opt_cfg = OptimizerConfig(lr=1e-3, scheduler="constant", use_ema=True)
    tx = make_optimizer(opt_cfg, 10, 1)
    state = init_train_state(model, tx, use_ema=True)
    step = make_train_step(tx, opt_cfg)
    counters = {"mlp": tmlp.mlp, "flash_fwd": tfa.flash_fwd, "flash_bwd": tfa.flash_bwd,
                "norm_mlp": tmlp.norm_mlp, "rmsnorm_bwd": tmlp.rmsnorm_bwd}
    n = cfg.num_hidden_layers
    for _ in range(2):
        before = {k: f.launches for k, f in counters.items()}
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        got = {k: f.launches - before[k] for k, f in counters.items()}
        assert got == {"mlp": 2 * n, "flash_fwd": 2 * n, "flash_bwd": n, "norm_mlp": 0,
                       "rmsnorm_bwd": 2 * n + 1}
        assert torch.isfinite(metrics["task_loss"])
    from graphgpt_torch.training.steps import make_eval_step

    before = {k: f.launches for k, f in counters.items()}
    out = make_eval_step(use_ema=True)(state, batch)
    torch.cuda.synchronize()
    got = {k: f.launches - before[k] for k, f in counters.items()}
    assert got == {"mlp": n, "flash_fwd": n, "flash_bwd": 0, "norm_mlp": 0, "rmsnorm_bwd": 0}
    assert out["task_logits"].shape == (4, 1) and torch.isfinite(out["task_loss"])


@pytest.mark.gpu
def test_pretrain_pipeline_step_launch_counts(cuda_device, tmp_path):
    """One PretrainPipeline step of a 2-layer GraphGPT-base-width model at
    max_length 4096 without block-aligned packing: per layer one launch of
    each streamed kernel (#6, #7, #8) and none of #1, #3, #4, #5; the
    save point's eval forwards take #6 alone."""
    from graphgpt_torch.config import Config
    from graphgpt_torch.training.pipeline import PretrainPipeline

    cfg = Config()
    sem = cfg.tokenization.semantics
    sem.node.discrete, sem.node.dim = "node_attr", 9
    sem.edge.discrete, sem.edge.dim = "edge_attr", 3
    cfg.model.hidden_size, cfg.model.num_hidden_layers = 768, 2
    cfg.model.remat, cfg.model.remat_policy = True, "save_attn"
    t = cfg.training
    t.batch_size, t.max_length, t.pack_tokens, t.num_workers = 2, 4096, 1, 2
    t.schedule.total_num_steps, t.schedule.warmup_num_steps, t.schedule.logging_steps = 2, 1, 1
    t.valid_percent, t.do_valid, t.gen_eval_bands = 0.0004, True, 0
    t.optimizer.use_ema, t.inspect_tokenization = True, False
    t.output_dir = str(tmp_path)
    pipe = PretrainPipeline(cfg, device=cuda_device).setup()
    counters = {"fwd_stream": tfa.flash_fwd_stream, "dq_stream": tfa.flash_dq_stream,
                "dkv_stream": tfa.flash_dkv_stream, "fwd": tfa.flash_fwd, "bwd": tfa.flash_bwd,
                "dq": tfa.flash_dq, "dkv": tfa.flash_dkv, "norm_mlp": tmlp.norm_mlp}
    logs = {"train": [], "eval": []}

    def counted(fn, log):
        def wrapped(*a, **kw):
            before = {k: c.launches for k, c in counters.items()}
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            logs[log].append({k: c.launches - before[k] for k, c in counters.items()})
            return out
        return wrapped

    pipe.train_step = counted(pipe.train_step, "train")
    pipe.eval_step = counted(pipe.eval_step, "eval")
    pipe.eval_step_ema = counted(pipe.eval_step_ema, "eval")
    pipe.run()
    n = cfg.model.num_hidden_layers
    assert logs["train"] == [{"fwd_stream": n, "dq_stream": n, "dkv_stream": n, "fwd": 0, "bwd": 0,
                              "dq": 0, "dkv": 0, "norm_mlp": n}] * 2
    assert logs["eval"] and all(g == {**{k: 0 for k in counters}, "fwd_stream": n, "norm_mlp": n}
                                for g in logs["eval"])
    import csv

    rows = list(csv.DictReader(open(tmp_path / "log.csv")))
    assert len(rows) == 2 and all(float(r["mfu"]) > 0 for r in rows)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,keys,mask", [
    ((2, 1024, 12), "same", "bidirectional"), ((2, 320, 3), "other", "causal"),
    ((4, 88, 12), "same", "bi-causal"), ((1, 4096, 2), "same", "causal"),
    ((2, 1000, 12), "other", "bidirectional")],
    ids=["P1024", "P320-other-causal", "P88-bicausal", "P4096-causal", "P1000-other"])
def test_band_kernels_match_plain(cuda_device, shape, keys, mask):
    """flash_fwd_band (#9) and flash_bwd_band (#10, with its delta and a
    cotangent of lse) against their plain versions, at the tolerances of the
    streamed kernels; the band tables equal band_limits; padded rows exactly
    0; the same bits from run to run, the forward's too. P 1000: the last
    128-row item of #9 holds one 64-row tile and a 40-row one."""
    dev = cuda_device
    b, p, h = shape
    dh = 64
    causal, bi = {"bidirectional": (False, 0), "causal": (True, 0), "bi-causal": (False, 16)}[mask]
    rng = np.random.default_rng(17)
    qs = _bf16(rng, (b, p, h * dh), 0.5 * dh**-0.5, dev)
    k, v, do = (_bf16(rng, (b, p, h * dh), 0.5, dev) for _ in range(3))
    seg_np = packed_segments(b, p, rng)
    seg_np[-1, p - 40 : p - 20] = 0
    seg = torch.from_numpy(seg_np).to(dev)
    seg_k = seg if keys == "same" else _shifted(seg)
    counts = [tfa.flash_fwd_band.launches, tfa.flash_bwd_band.launches]
    aux = {}
    out, lse = tfa.flash_fwd_band(qs, k, v, seg, seg_k, causal, dh, bi, aux=aux)
    torch.cuda.synchronize()
    assert torch.equal(aux["table"].cpu(), tfa.band_limits(seg, seg_k).cpu())
    with ops.reference_mode():
        rout, rlse = tfa.flash_fwd_band(qs, k, v, seg, seg_k, causal, dh, bi)
    valid = seg > 0
    torch.testing.assert_close(out.float(), rout.float(), atol=3e-2, rtol=2e-2)
    assert _rel(out[valid], rout[valid]) < 4e-3
    torch.testing.assert_close(lse.transpose(1, 2)[valid], rlse.transpose(1, 2)[valid],
                               atol=1e-3, rtol=1e-4)
    assert bool((out[~valid] == 0).all()) and bool((lse.transpose(1, 2)[~valid] == -1e30).all())
    again = tfa.flash_fwd_band(qs, k, v, seg, seg_k, causal, dh, bi)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)
    dlse = torch.from_numpy(rng.normal(size=(b, h, p)).astype(np.float32) * 0.3).to(dev)
    dlse = dlse * valid[:, None, :]
    args = (qs, k, v, seg, seg_k, out, lse, do, dlse, causal, dh, bi)
    aux = {}
    dq, dk, dv = tfa.flash_bwd_band(*args, aux=aux)
    torch.cuda.synchronize()
    assert torch.equal(aux["table_k"].cpu(), tfa.band_limits(seg_k, seg).cpu())
    torch.testing.assert_close(aux["delta"], tfa.flash_delta(do, out, dlse, dh), atol=1e-5,
                               rtol=1e-5)
    with ops.reference_mode():
        rdq, rdk, rdv = tfa.flash_bwd_band(*args)
    for g, r in zip((dq, dk, dv), (rdq, rdk, rdv)):
        torch.testing.assert_close(g.float(), r.float(), atol=3.2e-2, rtol=2e-2)
        assert _rel(g, r) < 2e-3
    assert bool((dq[~valid] == 0).all())
    assert bool((dk[seg_k == 0] == 0).all()) and bool((dv[seg_k == 0] == 0).all())
    assert [tfa.flash_fwd_band.launches, tfa.flash_bwd_band.launches] == [counts[0] + 2,
                                                                          counts[1] + 1]
    again = tfa.flash_bwd_band(*args)
    assert all(torch.equal(a, g) for a, g in zip(again, (dq, dk, dv)))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,keys,mask", [
    ((2, 1024, 12), "same", "bidirectional"), ((4, 88, 12), "same", "bi-causal"),
    ((2, 320, 3), "other", "causal")], ids=["P1024", "P88-bicausal", "P320-other-causal"])
def test_band_backward_ignores_non_finite_do_in_padded_rows(cuda_device, shape, keys, mask):
    """inf and NaN in do's padded rows (which TMA brings in raw) change no
    bit of #10's dq, dk or dv."""
    dev = cuda_device
    b, p, h = shape
    dh = 64
    causal, bi = {"bidirectional": (False, 0), "causal": (True, 0), "bi-causal": (False, 16)}[mask]
    rng = np.random.default_rng(23)
    qs = _bf16(rng, (b, p, h * dh), 0.5 * dh**-0.5, dev)
    k, v, do = (_bf16(rng, (b, p, h * dh), 0.5, dev) for _ in range(3))
    seg_np = packed_segments(b, p, rng)
    seg_np[-1, p - 40 : p - 20] = 0
    seg = torch.from_numpy(seg_np).to(dev)
    seg_k = seg if keys == "same" else _shifted(seg)
    out, lse = tfa.flash_fwd_band(qs, k, v, seg, seg_k, causal, dh, bi)
    pad = (seg == 0)[..., None]
    clean = torch.where(pad, torch.zeros_like(do), do)
    noisy = clean.clone()
    noisy[pad.expand_as(noisy)] = float("nan")
    noisy[-1][pad[-1, :, 0]] = float("inf")
    runs = [tfa.flash_bwd_band(qs, k, v, seg, seg_k, out, lse, d, None, causal, dh, bi)
            for d in (clean, noisy)]
    torch.cuda.synchronize()
    for a, n in zip(*runs):
        assert bool(torch.isfinite(a.float()).all())
        assert torch.equal(a, n)


@pytest.mark.gpu
def test_band_backward_entry_refuses_p_past_4096(cuda_device):
    """#10's entry takes one 64-bit mask of 64 tiles: P 4160 gets its own
    code (the wrapper sends such rows to the streamed pair)."""
    dev = cuda_device
    b, p, h, dh = 1, tfa._MAX_BAND + 64, 1, 64
    big = torch.zeros(b, p, h * dh, device=dev, dtype=torch.bfloat16)
    seg = torch.ones(b, p, device=dev, dtype=torch.int32)
    rows = torch.zeros(b, h, p, device=dev)
    fn = tfa._build.entry("flash_bwd", "ggt_flash_bwd_band", tfa._BWD_BAND_ARGTYPES)
    ptr = tfa._build.ptr
    err = fn(ptr(big), ptr(big), ptr(big), ptr(seg), ptr(seg), ptr(big), ptr(rows), ptr(big),
             None, ptr(rows), ptr(big), ptr(big), ptr(big), ptr(tfa._tile_scratch(seg)), b, p, h,
             0, 0, tfa._build.stream_ptr(dev))
    assert err == 1002


def _qkv_inputs(n, d, widths, dev, seed=19):
    rng = np.random.default_rng(seed)
    x = _bf16(rng, (n, d), 1.0, dev)
    wn = torch.from_numpy((1.0 + 0.1 * rng.normal(size=(d,))).astype(np.float32)).to(dev)
    return x, wn, [_bf16(rng, (w, d), 0.02, dev) for w in widths]


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,widths", [(200, 128, (128, 64, 64)), (8192, 768, (768,) * 3),
                                        (1000, 768, (768, 256, 256)), (300, 1600, (1600,) * 3),
                                        (1, 768, (768,) * 3), (129, 128, (128, 64, 64)),
                                        (65537, 768, (768,) * 3), (3000, 1024, (640, 128, 128))],
                         ids=["small-gqa", "serving", "gqa-ragged", "d1600", "n1", "n129",
                              "n65537", "bn128"])
def test_norm_qkv_kernel_matches_plain(cuda_device, n, d, widths):
    """norm_qkv (#12) against its plain version, at each of its tile widths
    (BN 64, 128, 256) and ragged row tiles (N 1, 129, 65,537: the last 128-row
    tile mostly past N); fused_norm_qkv's backward goes through rmsnorm_bwd
    (#13) and matches the plain run's."""
    dev = cuda_device
    x, wn, ws = _qkv_inputs(n, d, widths, dev)
    before = tmlp.norm_qkv.launches
    got = tmlp.norm_qkv(x, wn, *ws, 1e-6)
    torch.cuda.synchronize()
    assert tmlp.norm_qkv.launches == before + 1
    with ops.reference_mode():
        want = tmlp.norm_qkv(x, wn, *ws, 1e-6)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), w.float(), atol=1e-2, rtol=1e-2)
        assert _rel(g, w) < 2e-3

    def grads():
        leaves = [t.detach().clone().requires_grad_() for t in [x, wn] + [w.float() for w in ws]]
        outs = tmlp.fused_norm_qkv(*leaves, 1e-6)
        torch.autograd.backward(outs, [torch.ones_like(o) * 0.1 for o in outs])
        return [t.grad for t in leaves]

    rms = tmlp.rmsnorm_bwd.launches
    kern = grads()
    assert tmlp.rmsnorm_bwd.launches == rms + 1
    with ops.reference_mode():
        plain = grads()
    for g, w in zip(kern, plain):
        assert _rel(g, w) < 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("widths", [(768,) * 3, (192, 64, 64)], ids=["bn256", "bn64"])
def test_norm_qkv_kernel_is_the_same_from_run_to_run(cuda_device, widths):
    """No split-K and no atomics: two launches on the same inputs give the
    same bits."""
    x, wn, ws = _qkv_inputs(4100, 768, widths, cuda_device, seed=23)
    first = tmlp.norm_qkv(x, wn, *ws, 1e-6)
    again = tmlp.norm_qkv(x, wn, *ws, 1e-6)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.gpu
def test_norm_qkv_kernel_raises_outside_its_contract(cuda_device):
    dev = cuda_device
    x, wn, ws = _qkv_inputs(64, 128, (128, 64, 64), dev)
    with pytest.raises(NotImplementedError):  # fp32 activations
        tmlp.norm_qkv(x.float(), wn, *ws, 1e-6)
    with pytest.raises(NotImplementedError):  # D % 64 != 0
        xo, wno, wso = _qkv_inputs(64, 96, (128, 64, 64), dev)
        tmlp.norm_qkv(xo, wno, *wso, 1e-6)
    with pytest.raises(NotImplementedError):  # a width % 64 != 0
        tmlp.norm_qkv(x, wn, ws[0], ws[1], ws[2][:32], 1e-6)
    with pytest.raises(ValueError):  # a contiguous view 2 bytes past an aligned base
        flat = torch.zeros(64 * 128 + 1, device=dev, dtype=torch.bfloat16)
        tmlp.norm_qkv(flat[1:].view(64, 128), wn, *ws, 1e-6)


@pytest.mark.gpu
def test_norm_qkv_kernel_takes_no_rows(cuda_device):
    """N 0 gives empty q, k, v and launches nothing."""
    x, wn, ws = _qkv_inputs(0, 768, (768, 256, 256), cuda_device)
    before = tmlp.norm_qkv.launches
    out = tmlp.norm_qkv(x, wn, *ws, 1e-6)
    assert [tuple(o.shape) for o in out] == [(0, 768), (0, 256), (0, 256)]
    assert tmlp.norm_qkv.launches == before


@pytest.mark.gpu
def test_training_step_under_both_knobs_launches_the_band_and_qkv_kernels(cuda_device,
                                                                           monkeypatch):
    """GGT_FLASH_MODE=band and GGT_ATTN_NORM_FUSE=1, save_attn: per layer one
    flash_fwd_band, one flash_bwd_band, two norm_qkv (the forward and the
    recompute), one norm_mlp; rmsnorm_bwd a layer plus the final norm's;
    none of the legacy flash kernels. The gradients match the legacy route."""
    monkeypatch.setattr(tfa, "_MODE", "band")
    monkeypatch.setenv("GGT_ATTN_NORM_FUSE", "1")
    cfg = _tiny_cfg(remat=True, remat_policy="save_attn")
    model = GraphGPTPretrain(cfg, device=cuda_device, seed=0)
    batch = to_torch(fake_batch(2, 256, 3, 50, np.random.default_rng(1)), cuda_device)
    counters = {"flash_fwd_band": tfa.flash_fwd_band, "flash_bwd_band": tfa.flash_bwd_band,
                "norm_qkv": tmlp.norm_qkv, "norm_mlp": tmlp.norm_mlp,
                "rmsnorm_bwd": tmlp.rmsnorm_bwd, "flash_fwd": tfa.flash_fwd,
                "flash_bwd": tfa.flash_bwd, "flash_fwd_stream": tfa.flash_fwd_stream}
    before = {k: f.launches for k, f in counters.items()}
    model(batch, train=True)["loss"].backward()
    torch.cuda.synchronize()
    got = {k: f.launches - before[k] for k, f in counters.items()}
    n = cfg.num_hidden_layers
    assert got == {"flash_fwd_band": n, "flash_bwd_band": n, "norm_qkv": 2 * n, "norm_mlp": n,
                   "rmsnorm_bwd": n + 1, "flash_fwd": 0, "flash_bwd": 0, "flash_fwd_stream": 0}
    band = {k: p.grad.clone() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    monkeypatch.setattr(tfa, "_MODE", "legacy")
    monkeypatch.setenv("GGT_ATTN_NORM_FUSE", "0")
    model(batch, train=True)["loss"].backward()
    for k, p in model.named_parameters():
        assert _rel(band[k], p.grad) < 5e-2, k


@pytest.mark.gpu
def test_skip_mode_goes_through_the_stream_kernels(cuda_device, monkeypatch):
    """GGT_FLASH_MODE=skip: flash_attention at P 1024 rotates q and k outside
    and launches #6, #7 and #8 once each; out matches the legacy route."""
    dev = cuda_device
    rng = np.random.default_rng(23)
    b, p, h, dh = 2, 1024, 4, 64
    q, k, v = (_bf16(rng, (b, p, h, dh), 0.5, dev).requires_grad_() for _ in range(3))
    seg = torch.from_numpy(packed_segments(b, p, rng)).to(dev)
    rope = rope_cos_sin(torch.arange(p, device=dev).expand(b, p), dh)
    monkeypatch.setattr(tfa, "_MODE", "skip")
    counters = [tfa.flash_fwd_stream, tfa.flash_dq_stream, tfa.flash_dkv_stream, tfa.flash_fwd,
                tfa.flash_bwd]
    before = [f.launches for f in counters]
    out = tfa.flash_attention(q, k, v, seg, rope=rope)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert [f.launches - c for f, c in zip(counters, before)] == [1, 1, 1, 0, 0]
    monkeypatch.setattr(tfa, "_MODE", "legacy")
    ref = tfa.flash_attention(q, k, v, seg, rope=rope)
    torch.testing.assert_close(out.float(), ref.float(), atol=3e-2, rtol=2e-2)


# head width 32 (model.size tiny6, small12): flash_attention rotates q and k
# outside the kernels on both routes, and on the card pads every head to the
# kernels' 64
_DH32_FORMS = {"single": ("legacy", True, 0, {"flash_fwd": 1, "flash_bwd": 1}),
               "split": ("legacy", False, 16, {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}),
               "stream": ("skip", True, 0, {"flash_fwd_stream": 1, "flash_dq_stream": 1,
                                            "flash_dkv_stream": 1}),
               "band": ("band", False, 16, {"flash_fwd_band": 1, "flash_bwd_band": 1})}


@pytest.mark.gpu
@pytest.mark.parametrize("form", list(_DH32_FORMS))
def test_head_width_32_forms_match_plain(cuda_device, form, monkeypatch):
    """flash_attention at dh 32 with RoPE (B 2 x P 200, 3 heads, packed
    rows with a padded tail) through each form's kernels on heads padded
    to 64 against the plain route at dh 32: #1 and #3; the bi-causal #1
    and the split pair #4, #5 (16 bit slots); the skip mode's #6-#8; the
    band mode's #9, #10. out, lse and every gradient (lse with a cotangent
    too); one launch of each kernel of the form."""
    dev = cuda_device
    mode, causal, bi, want = _DH32_FORMS[form]
    monkeypatch.setattr(tfa, "_MODE", mode)
    b, p, h, dh = 2, 200, 3, 32
    rng = np.random.default_rng(32)
    q, k, v, do = (_bf16(rng, (b, p, h, dh), 0.5, dev) for _ in range(4))
    seg_np = packed_segments(b, p, rng)
    seg_np[-1, p - 30:] = 0
    seg = torch.from_numpy(seg_np).to(dev)
    valid = (seg > 0)[:, None, :]
    pos = torch.arange(p, device=dev).expand(b, p)
    rope = tuple(t.to(torch.bfloat16) for t in rope_cos_sin(pos, dh))

    def run():
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out, lse = tfa.flash_attention(*leaves, seg, causal=causal, bi_causal_split=bi,
                                       rope=rope, return_lse=True)
        ((out.float() * do.float()).sum() + 0.1 * torch.where(valid, lse, 0).sum()).backward()
        return [out.detach(), lse.detach()] + [t.grad for t in leaves]

    before = {n: getattr(tfa, n).launches for n in want}
    got = run()
    torch.cuda.synchronize()
    assert {n: getattr(tfa, n).launches - c for n, c in before.items()} == want
    with ops.reference_mode():
        ref = run()
    for part, g, w in zip(("out", "lse", "dq", "dk", "dv"), got, ref):
        assert g.shape == w.shape and g.dtype == w.dtype, part
        if part == "lse":
            torch.testing.assert_close(g[valid.expand_as(g)], w[valid.expand_as(w)], atol=2e-2,
                                       rtol=0)
            continue
        torch.testing.assert_close(g.float(), w.float(), atol=3.2e-2, rtol=2e-2)
        assert _rel(g, w) < 2e-3, (part, _rel(g, w))
    assert torch.all(got[0][seg == 0] == 0) and torch.all(got[2][seg == 0] == 0)


@pytest.mark.gpu
def test_a_head_width_32_model_steps_on_the_kernels(cuda_device):
    """model.size tiny6 (128 x 6, 4 heads of 32): a training step launches
    #1 and #3 once a layer through the padded route, and its loss and
    gradients stay near the plain run's."""
    dev = cuda_device
    cfg = ModelConfig(size="tiny6", vocab_size=60, stacked_feat=3, next_n_token=3,
                      mask_token_id=1, dtype="bfloat16").finalize()
    assert cfg.head_dim == 32
    model = GraphGPTPretrain(cfg, device=dev, seed=0)
    batch = to_torch(fake_batch(4, 256, 3, 60, np.random.default_rng(4)), dev)
    counters = (tfa.flash_fwd, tfa.flash_bwd)
    before = [c.launches for c in counters]
    loss = model(batch, train=True)["loss"]
    loss.backward()
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [6, 6]
    grads = {n: q.grad.clone() for n, q in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    with ops.reference_mode():
        ref = model(batch, train=True)["loss"]
        ref.backward()
    assert abs(loss.item() - ref.item()) < 5e-3
    for n, q in model.named_parameters():
        assert _rel(grads[n], q.grad) < 8e-2, n


def _task_model_step(model, batch, call=dict):
    """[(loss, gradients, launches of #1 and #3)] of one training forward
    and backward on the kernels, then on the plain versions; `call()` gives
    the same draws to both."""
    runs = []
    for plain in (False, True):
        model.zero_grad(set_to_none=True)
        before = (tfa.flash_fwd.launches, tfa.flash_bwd.launches)
        with ops.reference_mode() if plain else contextlib.nullcontext():
            loss = model(batch, train=True, **call())["loss"]
            loss.backward()
        torch.cuda.synchronize()
        runs.append((loss.item(), {n: q.grad.clone() for n, q in model.named_parameters()
                                   if q.grad is not None},
                     (tfa.flash_fwd.launches - before[0], tfa.flash_bwd.launches - before[1])))
    return runs


@pytest.mark.gpu
def test_a_gst_batch_trains_on_the_causal_kernels(cuda_device, monkeypatch):
    """Flat GSTTokenizer rows packed into 4 x 512 (each segment's cyclic
    position ids kept) through a causal GraphGPTPretrain (hidden 128, 2
    layers, heads of 64, next-token labels): the forward and backward
    launch the causal #1 and #3 once a layer, and the loss and every
    gradient stay near the plain run's."""
    from graphgpt_torch.config import TokenizationConfig
    from graphgpt_torch.data import vocab
    from graphgpt_torch.data.collator import collate, pack_samples
    from graphgpt_torch.data.datasets import MOL_EDGE_CARD, MOL_NODE_CARD, SyntheticMolDataset
    from graphgpt_torch.data.gst_tokenizer import GSTTokenizer

    tc = TokenizationConfig()
    tc.semantics.node.discrete, tc.semantics.node.dim = "node_attr", 9
    tc.semantics.edge.discrete, tc.semantics.edge.dim = "edge_attr", 3
    vm = vocab.vocab_map_from_list(vocab.build_vocab(
        tc, [np.arange(c) for c in MOL_NODE_CARD], [np.arange(c) for c in MOL_EDGE_CARD]))
    tok = GSTTokenizer(tc, vm, task_type="pretrain")
    ds = SyntheticMolDataset(64, seed=3)
    rows = list(pack_samples([tok(ds[i], np.random.default_rng(i)) for i in range(24)], 512))
    batch = to_torch(dict(collate(rows[:4], mpe=512, fixed_length=512).data), cuda_device)
    assert batch["input_ids"].dim() == 2
    causal = []
    real_fwd = tfa.flash_fwd

    def spy(*a, **kw):
        causal.append(a[6])
        return real_fwd(*a, **kw)

    spy.launches = 0
    cfg = ModelConfig(vocab_size=max(vm.values()) + 1, hidden_size=128, num_hidden_layers=2,
                      stacked_feat=1, next_n_token=1, mask_token_id=tok.mask_id,
                      task_type="pretrain", causal_attention=True,
                      dtype="bfloat16").finalize()
    model = GraphGPTPretrain(cfg, device=cuda_device, seed=0)
    (loss, grads, launches), (ref, rgrads, _) = _task_model_step(model, batch)
    assert launches == (2, 2)
    assert abs(loss - ref) < 5e-3
    for n in rgrads:
        assert _rel(grads[n], rgrads[n]) < 8e-2, n
    monkeypatch.setattr(tfa, "flash_fwd", spy)
    with torch.no_grad():
        model(batch)
    assert causal == [True, True]


@pytest.mark.gpu
@pytest.mark.parametrize("task", ["pretrain-coord", "pretrain-cl", "pretrain-smtp"])
def test_the_pretrain_task_batches_train_on_the_kernels(cuda_device, task):
    """A batch of the stacked tokenizer's rows of each task (the molecules'
    coordinates, rotated; two adjacent views a graph for pretrain-cl)
    through GraphGPTPosPred or GraphGPTPretrain (hidden 128, 2 layers):
    #1 and #3 once a layer, and the loss and every gradient near the plain
    run's on the same draws."""
    from graphgpt_torch.data.collator import collate
    from graphgpt_torch.data.datasets import SyntheticMolDataset
    from graphgpt_torch.models.pos_pretrain import GraphGPTPosPred
    from graphgpt_torch.synthetic import mol3d_tokenizer

    base = mol3d_tokenizer()
    tok = type(base)(base.cfg, base.vocab_map, task_type=task)
    ds = SyntheticMolDataset(64, seed=5, with_pos=True)
    idx = np.repeat(np.arange(8), 2) if task == "pretrain-cl" else np.arange(16)
    samples = [tok(ds[int(i)], np.random.default_rng(k)) for k, i in enumerate(idx)]
    batch = to_torch(dict(collate(samples, mpe=128).data), cuda_device)
    cfg = ModelConfig(vocab_size=tok.vocab_size, hidden_size=128, num_hidden_layers=2,
                      stacked_feat=tok.stacked_feat, next_n_token=tok.stacked_feat,
                      mask_token_id=tok.mask_id, task_type=task, dtype="bfloat16",
                      pos_num_bins=64, use_discriminative=task == "pretrain-cl",
                      smtp_inside=task == "pretrain-smtp").finalize()
    cls = GraphGPTPosPred if "coord" in task else GraphGPTPretrain
    model = cls(cfg, device=cuda_device, seed=0)

    def call():
        return {"generator": torch.Generator(device=cuda_device).manual_seed(3)}

    (loss, grads, launches), (ref, rgrads, _) = _task_model_step(model, batch, call)
    assert launches == (2, 2) and np.isfinite(loss)
    assert abs(loss - ref) < 5e-3
    for n in rgrads:
        assert _rel(grads[n], rgrads[n]) < 8e-2, n


# ---- the fp32 forms of #1, #3 (flash_bwd_split_f32.cu, flash_bwd_f32.cu), #2
# (mlp_qkv_f32.cu) and #13 (rmsnorm_bwd.cu's fp32 instances)

F32_REL = 2e-5  # relative Frobenius error: fp32 sums of up to ~3,000 terms in another order


def _f32_flash_inputs(case, dev, seed=5):
    """_flash_inputs in fp32, cos and sin kept fp32."""
    b, p, h, bi, rope, layout = _FLASH_CASES.get(case) or _BWD_CASES[case]
    dh = 64
    rng = np.random.default_rng(seed)

    def f32(shape, scale):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(dev)

    qs = f32((b, p, h * dh), 0.5 * dh**-0.5)
    k, v, do = (f32((b, p, h * dh), 0.5) for _ in range(3))
    if layout == "molecule":
        seg_np = _molecule_segments(b, p, rng)
    elif layout == "denoise":
        seg_np = _denoise_row_segments(b, p, bi, rng)
    else:
        seg_np = packed_segments(b, p, rng)
        seg_np[-1, p - 30:] = 0
        if layout == "padded-row":
            seg_np[1] = 0
    seg = torch.from_numpy(seg_np).to(dev)
    cos = sin = None
    if rope:
        cos, sin = rope_cos_sin(torch.arange(p, device=dev).expand(b, p), dh)
    return qs, k, v, do, seg, cos, sin


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True], ids=["bidirectional", "causal"])
@pytest.mark.parametrize("case", ["P50", "P72", "P88-bicausal", "P128", "P200", "P1000", "P2048",
                                  "no-rope", "padded-row"])
def test_fp32_flash_kernels_match_plain(cuda_device, causal, case):
    """#1's and #3's fp32 forms through flash_fwd and flash_bwd against their
    plain versions in fp32 (TF32 off): out, lse, dq, dk, dv each within
    F32_REL, padded rows exactly 0 and -1e30, one fp32 launch a call and no
    bf16 one, the same bits on a relaunch (no atomics). The bi-causal case
    runs the forward only: its backward is the split pair's
    (test_fp32_split_backward_kernels_match_plain)."""
    dev = cuda_device
    bi = _FLASH_CASES[case][3]
    qs, k, v, do, seg, cos, sin = _f32_flash_inputs(case, dev)
    args = (qs, k, v, seg, cos, sin, causal, 64, bi)
    counts = (tfa.flash_fwd, tfa.flash_fwd_f32, tfa.flash_bwd, tfa.flash_bwd_f32)
    before = [c.launches for c in counts]
    out, lse = tfa.flash_fwd(*args)
    torch.cuda.synchronize()
    with ops.reference_mode():
        rout, rlse = tfa.flash_fwd(*args)
    valid = seg > 0
    assert out.dtype == torch.float32 and _rel(out, rout) < F32_REL
    assert _rel(lse.transpose(1, 2)[valid], rlse.transpose(1, 2)[valid]) < F32_REL
    assert bool((out[~valid] == 0).all()) and bool((lse.transpose(1, 2)[~valid] == -1e30).all())
    again = tfa.flash_fwd(*args)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)
    assert [c.launches - n for c, n in zip(counts, before)] == [0, 2, 0, 0]
    if bi:
        return
    dlse = torch.from_numpy(np.random.default_rng(3).normal(
        size=tuple(lse.shape)).astype(np.float32)).to(dev) * 0.1
    bargs = (qs, k, v, seg, cos, sin, out, lse, do, dlse, causal, 64)
    got = tfa.flash_bwd(*bargs)
    torch.cuda.synchronize()
    with ops.reference_mode():
        want = tfa.flash_bwd(*bargs)
    for name, a, r in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32 and _rel(a, r) < F32_REL, name
        assert bool((a[~valid] == 0).all()), name
    assert all(torch.equal(a, b) for a, b in zip(tfa.flash_bwd(*bargs), got))
    assert [c.launches - n for c, n in zip(counts, before)] == [0, 2, 0, 2]


@pytest.mark.gpu
def test_fp32_flash_bwd_ignores_non_finite_do_in_padded_rows(cuda_device):
    """inf and NaN in do's padded rows change no output bit of #3's fp32 form."""
    dev = cuda_device
    qs, k, v, do, seg, cos, sin = _f32_flash_inputs("P1000", dev)
    out, lse = tfa.flash_fwd(qs, k, v, seg, cos, sin, False, 64)
    clean = tfa.flash_bwd(qs, k, v, seg, cos, sin, out, lse, do, None, False, 64)
    noisy = do.clone()
    pad = (seg == 0).nonzero()
    noisy[pad[:, 0], pad[:, 1]] = float("nan")
    noisy[pad[0, 0], pad[0, 1], :8] = float("inf")
    got = tfa.flash_bwd(qs, k, v, seg, cos, sin, out, lse, noisy, None, False, 64)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, clean))


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["gelu", "gelu_pytorch_tanh", "silu"])
@pytest.mark.parametrize("case", list(_MLP_CASES))
def test_fp32_norm_mlp_kernel_matches_plain(cuda_device, act, case):
    """#2's fp32 form through norm_mlp against its plain version in fp32
    (TF32 off) within F32_REL, one fp32 launch a call, bit-equal on a
    relaunch."""
    x, wn, wg, wu, wd = (t.float() for t in _mlp_inputs(*_MLP_CASES[case], cuda_device))
    before = (tmlp.norm_mlp.launches, tmlp.norm_mlp_f32.launches)
    out = tmlp.norm_mlp(x, wn, wg, wu, wd, 1e-6, act)
    torch.cuda.synchronize()
    assert (tmlp.norm_mlp.launches, tmlp.norm_mlp_f32.launches) == (before[0], before[1] + 1)
    with ops.reference_mode():
        ref = tmlp.norm_mlp(x, wn, wg, wu, wd, 1e-6, act)
    assert out.dtype == torch.float32 and _rel(out, ref) < F32_REL
    assert torch.equal(tmlp.norm_mlp(x, wn, wg, wu, wd, 1e-6, act), out)


# (N, D, F) of #2f on its paths: GraphGPT-base's serving rows, the quick
# start's, the denoise batch's, a ragged last row tile; small12's widths;
# xxlarge's D 1600, whose down tiles are 64 wide
_F32_NORM_MLP_SHAPES = {"n8192": (8192, 768, 3072), "toy": (1024, 128, 512),
                        "denoise": (22528, 768, 3072), "ragged": (65537, 768, 3072),
                        "d384": (4096, 384, 384), "d1600": (4096, 1600, 6400)}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", list(_F32_NORM_MLP_SHAPES))
def test_fp32_norm_mlp_kernel_matches_plain_at_its_path_shapes(cuda_device, shape):
    """#2f through norm_mlp on inputs drawn in fp32 at the shapes its paths
    give it, against norm_mlp_ref in fp32 (TF32 off) within F32_REL, the
    same plain version with TF32 past it, bit-equal on a relaunch."""
    from graphgpt_torch.ops.split_probe import f32_mlp_inputs

    x, wn, wg, wu, wd = f32_mlp_inputs(*_F32_NORM_MLP_SHAPES[shape], cuda_device)
    out = tmlp.norm_mlp(x, wn, wg, wu, wd, 1e-6, "gelu")
    torch.cuda.synchronize()
    ref = tmlp.norm_mlp_ref(x, wn, wg, wu, wd, 1e-6, "gelu")
    with _tf32():
        tf32 = tmlp.norm_mlp_ref(x, wn, wg, wu, wd, 1e-6, "gelu")
    assert bool(torch.isfinite(out).all()) and _rel(out, ref) < F32_REL
    assert _rel(tf32, ref) > F32_REL
    assert torch.equal(tmlp.norm_mlp(x, wn, wg, wu, wd, 1e-6, "gelu"), out)


@pytest.mark.gpu
@pytest.mark.parametrize("bn", [128, 64])
def test_fp32_norm_mlp_kernel_takes_every_tile_width(cuda_device, monkeypatch, bn):
    """#2f with each down width BN it is built for, forced in place of
    f32_block_n's choice, at D 768, F 3072 and a ragged N, within F32_REL
    of the plain fp32 version and bit-equal on a relaunch."""
    from graphgpt_torch.ops.split_probe import f32_mlp_inputs

    x, wn, wg, wu, wd = f32_mlp_inputs(1000, 768, 3072, cuda_device, seed=bn)
    monkeypatch.setattr(tmlp, "f32_block_n", lambda widths: bn)
    out = tmlp.norm_mlp(x, wn, wg, wu, wd, 1e-6, "silu")
    torch.cuda.synchronize()
    with ops.reference_mode():
        ref = tmlp.norm_mlp(x, wn, wg, wu, wd, 1e-6, "silu")
    assert _rel(out, ref) < F32_REL
    assert torch.equal(tmlp.norm_mlp(x, wn, wg, wu, wd, 1e-6, "silu"), out)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [200, 4097])
def test_fp32_norm_mlp_kernel_leaves_rows_past_n_alone(cuda_device, n):
    """#2f's C entry on out and g scratch with 128 rows more than N, filled
    with NaN: rows past N keep their NaN (neither stage writes them), rows
    below N equal the wrapper's output bit for bit."""
    from graphgpt_torch.ops import _build
    from graphgpt_torch.ops.split_probe import f32_mlp_inputs

    dev = cuda_device
    d, f = 768, 3072
    x, wn, wg, wu, wd = f32_mlp_inputs(n, d, f, dev)
    want = tmlp.norm_mlp(x, wn, wg, wu, wd, 1e-6, "gelu")
    out = torch.full((n + 128, d), float("nan"), device=dev)
    g = torch.full((n + 128, f), float("nan"), device=dev)
    planes = torch.empty(2, 3 * f * d, device=dev)
    rrms = torch.empty(n, device=dev)
    fn = _build.entry("mlp_qkv_f32", "ggt_norm_mlp_f32", tmlp._F32_ARGTYPES)
    ptr = _build.ptr
    _build.check(fn(ptr(x), ptr(wn), ptr(wg), ptr(wu), ptr(wd), ptr(planes), ptr(g), ptr(out),
                    ptr(rrms), n, d, f, tmlp.f32_block_n([d]), 1e-6, 0, _build.stream_ptr(dev)),
                 "norm_mlp_f32")
    torch.cuda.synchronize()
    assert torch.equal(out[:n], want) and bool(torch.isfinite(g[:n]).all())
    assert bool(out[n:].isnan().all()) and bool(g[n:].isnan().all())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(200, 128), (1000, 1600), (65537, 768), (4096, 384),
                                   (3000, 512), (2048, 1024)],
                         ids=["small", "wide", "ragged", "d384", "d512", "d1024"])
def test_fp32_rmsnorm_bwd_kernel_matches_plain(cuda_device, shape):
    """#13's fp32 instances through rmsnorm_bwd against the plain version:
    dx and dw within F32_REL, one fp32 launch a call, bit-equal on a
    relaunch (no atomics). D 512 is the widest fp32 row with two rows in
    flight a warp, D 1024 the first with one."""
    dev = cuda_device
    n, d = shape
    rng = np.random.default_rng(10)
    x = torch.from_numpy((rng.normal(size=(n, d)) * 1.5).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(dev)
    w = torch.from_numpy((1 + 0.1 * rng.normal(size=d)).astype(np.float32)).to(dev)
    before = (tmlp.rmsnorm_bwd.launches, tmlp.rmsnorm_bwd_f32.launches)
    dx, dw = tmlp.rmsnorm_bwd(x, g, w, 1e-6)
    torch.cuda.synchronize()
    assert (tmlp.rmsnorm_bwd.launches, tmlp.rmsnorm_bwd_f32.launches) == (before[0],
                                                                          before[1] + 1)
    with ops.reference_mode():
        rdx, rdw = tmlp.rmsnorm_bwd(x, g, w, 1e-6)
    assert dx.dtype == torch.float32 and _rel(dx, rdx) < F32_REL and _rel(dw, rdw) < F32_REL
    again = tmlp.rmsnorm_bwd(x, g, w, 1e-6)
    assert torch.equal(again[0], dx) and torch.equal(again[1], dw)


@pytest.mark.gpu
def test_an_fp32_model_trains_on_the_fp32_kernels(cuda_device):
    """A toy_pretrain-width model (hidden 128, 2 layers of 2 heads of 64,
    fp32): a save_attn training step launches each fp32 form as a bf16
    model launches its bf16 one (#1, #2, #3 once a layer, #13 once a layer
    and once for the final norm) and no bf16 kernel; its loss and every
    gradient within 1e-5 and 1e-4 relative of the plain fp32 run."""
    dev = cuda_device
    cfg = _tiny_cfg(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                    num_key_value_heads=2, intermediate_size=512, dtype="float32", remat=True,
                    remat_policy="save_attn")
    model = GraphGPTPretrain(cfg, device=dev, seed=0)
    batch = to_torch(fake_batch(8, 128, 3, 50, np.random.default_rng(2)), dev)
    counts = {c.__name__: c for c in (tfa.flash_fwd, tfa.flash_bwd, tmlp.norm_mlp,
                                      tmlp.rmsnorm_bwd, tfa.flash_fwd_f32, tfa.flash_bwd_f32,
                                      tmlp.norm_mlp_f32, tmlp.rmsnorm_bwd_f32)}

    def grads():
        model.zero_grad(set_to_none=True)
        loss = model(batch, train=True)["loss"]
        loss.backward()
        return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()
                             if p.grad is not None}

    before = {n: c.launches for n, c in counts.items()}
    loss, g = grads()
    torch.cuda.synchronize()
    got = {n: c.launches - before[n] for n, c in counts.items()}
    assert got == {"flash_fwd": 0, "flash_bwd": 0, "norm_mlp": 0, "rmsnorm_bwd": 0,
                   "flash_fwd_f32": 2, "flash_bwd_f32": 2, "norm_mlp_f32": 2,
                   "rmsnorm_bwd_f32": 3}
    with ops.reference_mode():
        rloss, rg = grads()
    assert abs(loss - rloss) <= 1e-5 * abs(rloss)
    assert set(g) == set(rg)
    for n in g:
        assert _rel(g[n], rg[n]) <= 1e-4, n


# ---- the fp32 forms of #11 (mlp_qkv_f32.cu's GATE_UP and DOWN modes) and of
# the split pair #4, #5 (flash_bwd_split_f32.cu)


@contextlib.contextmanager
def _tf32():
    """TF32 matrix products on: the controls that must miss F32_REL."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["gelu", "gelu_pytorch_tanh", "silu"])
@pytest.mark.parametrize("case", list(_MLP_CASES))
def test_fp32_mlp_kernel_matches_plain(cuda_device, act, case):
    """#11's fp32 form through mlp against its plain version in fp32 (TF32
    off) within F32_REL; the same plain version with TF32 on misses it (the
    inputs drawn in fp32, so that TF32 rounds them); one fp32 launch a call
    and no bf16 one; bit-equal on a relaunch."""
    from graphgpt_torch.ops.split_probe import f32_mlp_inputs

    x, _, wg, wu, wd = f32_mlp_inputs(*_MLP_CASES[case], cuda_device)
    before = (tmlp.mlp.launches, tmlp.mlp_f32.launches)
    out = tmlp.mlp(x, wg, wu, wd, act)
    torch.cuda.synchronize()
    assert (tmlp.mlp.launches, tmlp.mlp_f32.launches) == (before[0], before[1] + 1)
    with ops.reference_mode():
        ref = tmlp.mlp(x, wg, wu, wd, act)
        with _tf32():
            tref = tmlp.mlp(x, wg, wu, wd, act)
    assert out.dtype == torch.float32 and _rel(out, ref) < F32_REL
    assert _rel(tref, ref) > F32_REL
    assert torch.equal(tmlp.mlp(x, wg, wu, wd, act), out)


@pytest.mark.gpu
def test_fp32_split_mlp_backward_takes_no_tf32(cuda_device):
    """fused_mlp's backward (the plain formula, cuBLAS products) on fp32
    inputs on the card against the same on the CPU: within F32_REL with
    TF32 off, as the fixture and chip_smoke.py set it, and past it with TF32
    on, so that the check tells them apart."""
    from graphgpt_torch.ops.split_probe import f32_mlp_inputs

    x, _, wg, wu, wd = f32_mlp_inputs(2048, 768, 3072, "cpu", seed=3)
    dout = torch.from_numpy(np.random.default_rng(4).normal(size=(2048, 768))
                            .astype(np.float32))

    def grads(dev):
        leaves = [t.detach().to(dev).requires_grad_() for t in (x, wg, wu, wd)]
        tmlp.fused_mlp(*leaves, "gelu").backward(dout.to(dev))
        return [t.grad.cpu() for t in leaves]

    want = grads("cpu")
    got = grads(cuda_device)
    with _tf32():
        tgot = grads(cuda_device)
    for name, g, t, w in zip(("dx", "dwg", "dwu", "dwd"), got, tgot, want):
        assert _rel(g, w) < F32_REL, name
        assert _rel(t, w) > F32_REL, name


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(_SPLIT_CASES))
def test_fp32_split_backward_kernels_match_plain(cuda_device, case):
    """#4's and #5's fp32 forms through flash_dq (with its delta, a
    cotangent of lse folded in) and flash_dkv against their plain versions
    in fp32 (TF32 off): dq, delta, dk, dv within F32_REL, the TF32 control
    of dq, dk, dv past it, padded rows exactly 0, one launch of each fp32
    form a call and none of the bf16 pair. The cases are the bf16 pair's:
    splits inside a 64-row tile (denoise's P 88 puts the prefix's last
    columns and the slots in one tile) and on its edge, MAX_P, causal with
    and without a split, no RoPE. With a split flash_bwd takes the fp32
    pair, not #3f; two launches give the same bits. The TF32 control is
    held where cuBLAS takes TF32 for the plain version's products: on P50's
    2 x 50-row products it keeps fp32 (the control read 0 on an H100)."""
    dev = cuda_device
    b, p, h, bi, causal, _, _ = _SPLIT_CASES[case]
    dh = 64
    qs, k, v, do, seg, cos, sin, rng = _split_inputs(case, dev, dtype=torch.float32)
    out, lse = tfa.flash_fwd(qs, k, v, seg, cos, sin, causal, dh, bi)
    valid = seg > 0
    dlse = torch.from_numpy(rng.normal(size=(b, h, p)).astype(np.float32) * 0.3).to(dev)
    dlse = dlse * valid[:, None, :]  # padded rows take no part in the backward
    dq_args = (qs, k, v, seg, cos, sin, out, lse, do, dlse, causal, dh, bi)
    counts = (tfa.flash_dq, tfa.flash_dkv, tfa.flash_dq_f32, tfa.flash_dkv_f32, tfa.flash_bwd,
              tfa.flash_bwd_f32)
    before = [c.launches for c in counts]
    dq, delta = tfa.flash_dq(*dq_args)
    args = (qs, k, v, seg, cos, sin, lse, delta, do, causal, dh, bi)
    dk, dv = tfa.flash_dkv(*args)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counts, before)] == [0, 0, 1, 1, 0, 0]
    with ops.reference_mode():
        rdq, rdelta = tfa.flash_dq(*dq_args)
        rdk, rdv = tfa.flash_dkv(*args)
        with _tf32():
            tdq = tfa.flash_dq(*dq_args)[0]
            tdk, tdv = tfa.flash_dkv(*args)
    assert delta.dtype == torch.float32 and _rel(delta, rdelta) < F32_REL
    for name, g, r, t in zip(("dq", "dk", "dv"), (dq, dk, dv), (rdq, rdk, rdv), (tdq, tdk, tdv)):
        assert g.dtype == torch.float32 and _rel(g, r) < F32_REL, name
        assert case == "P50" or _rel(t, r) > F32_REL, name
        assert bool((g[~valid] == 0).all()), name
    if bi > 0:
        before = [c.launches for c in counts]
        got = tfa.flash_bwd(qs, k, v, seg, cos, sin, out, lse, do, dlse, causal, dh, bi)
        torch.cuda.synchronize()
        assert [c.launches - n for c, n in zip(counts, before)] == [0, 0, 1, 1, 0, 0]
    else:
        got = tfa.flash_dq(*dq_args)[:1] + tfa.flash_dkv(*args)
    for g, r in zip(got, (dq, dk, dv)):
        assert torch.equal(g, r)  # no atomics: the same bits every run


@pytest.mark.gpu
def test_fp32_split_backward_ignores_non_finite_do_in_padded_rows(cuda_device):
    """inf and NaN in do's padded rows change no bit of the fp32 pair's dq,
    delta, dk or dv."""
    dev = cuda_device
    b, p, h, bi, causal, _, _ = _SPLIT_CASES["denoise"]
    qs, k, v, do, seg, cos, sin, _ = _split_inputs("denoise", dev, seed=13, dtype=torch.float32)
    out, lse = tfa.flash_fwd(qs, k, v, seg, cos, sin, causal, 64, bi)
    pad = (seg == 0)[..., None]
    assert bool(pad.any())
    clean = torch.where(pad, torch.zeros_like(do), do)
    noisy = clean.clone()
    noisy[pad.expand_as(noisy)] = float("nan")
    noisy[0][pad[0, :, 0]] = float("inf")
    runs = []
    for d in (clean, noisy):
        dq, delta = tfa.flash_dq(qs, k, v, seg, cos, sin, out, lse, d, None, causal, 64, bi)
        dk, dv = tfa.flash_dkv(qs, k, v, seg, cos, sin, lse, delta, d, causal, 64, bi)
        runs.append((dq, delta, dk, dv))
    torch.cuda.synchronize()
    for a, n in zip(*runs):
        assert bool(torch.isfinite(a).all())
        assert torch.equal(a, n)


def _f32_step_vs_plain(model, batch, call):
    """(launches of each counted wrapper, loss, gradients) of one training
    step on the kernels, and the plain run's (loss, gradients)."""
    names = ("flash_fwd", "flash_bwd", "flash_dq", "flash_dkv", "flash_fwd_f32",
             "flash_bwd_f32", "flash_dq_f32", "flash_dkv_f32", "flash_fwd_stream",
             "flash_dq_stream", "flash_dkv_stream", "flash_fwd_stream_f32",
             "flash_dq_stream_f32", "flash_dkv_stream_f32", "flash_fwd_band", "flash_bwd_band",
             "flash_fwd_band_f32", "flash_bwd_band_f32")
    counts = {n: getattr(tfa, n) for n in names}
    counts.update({n: getattr(tmlp, n) for n in ("mlp", "norm_mlp", "rmsnorm_bwd", "mlp_f32",
                                                 "norm_mlp_f32", "rmsnorm_bwd_f32", "norm_qkv",
                                                 "norm_qkv_f32")})

    def step():
        model.zero_grad(set_to_none=True)
        loss = model(batch, train=True, **call())["loss"]
        loss.backward()
        return loss.item(), {n: q.grad.clone() for n, q in model.named_parameters()
                             if q.grad is not None}

    before = {n: c.launches for n, c in counts.items()}
    loss, grads = step()
    torch.cuda.synchronize()
    got = {n: c.launches - before[n] for n, c in counts.items() if c.launches != before[n]}
    with ops.reference_mode():
        ref = step()
    return got, (loss, grads), ref


def _assert_f32_step(run, ref):
    (loss, grads), (rloss, rgrads) = run, ref
    assert abs(loss - rloss) <= 1e-5 * abs(rloss)
    assert set(grads) == set(rgrads)
    for n in grads:
        assert bool(torch.isfinite(grads[n]).all()) and _rel(grads[n], rgrads[n]) <= 1e-4, n


@pytest.mark.gpu
def test_an_fp32_layer_scale_model_trains_on_the_fp32_mlp(cuda_device):
    """A two-layer fp32 model with LayerScale, DropPath and attention
    dropout under pairs remat (the fine-tune regularisers): a training step
    launches #11f in each layer and again in the pair's recompute, #1f
    twice a layer, #3f once, #13f twice a layer and once for the final
    norm, and no bf16 kernel; its loss and every gradient within 1e-5 and
    1e-4 of the plain fp32 run on the same dropout masks."""
    dev = cuda_device
    cfg = _tiny_cfg(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                    num_key_value_heads=2, intermediate_size=512, dtype="float32", remat=True,
                    remat_policy="pairs", layer_scale_init_value=1.0, path_dropout=0.1,
                    attention_dropout=0.1)
    model = GraphGPTPretrain(cfg, device=dev, seed=0)
    batch = to_torch(fake_batch(8, 128, 3, 50, np.random.default_rng(2)), dev)
    got, run, ref = _f32_step_vs_plain(
        model, batch, lambda: {"generator": torch.Generator(device=dev).manual_seed(5)})
    assert got == {"flash_fwd_f32": 4, "flash_bwd_f32": 2, "mlp_f32": 4, "rmsnorm_bwd_f32": 5}
    _assert_f32_step(run, ref)


@pytest.mark.gpu
def test_an_fp32_denoiser_trains_on_the_fp32_split_pair(cuda_device):
    """A two-layer fp32 denoiser with a 16-slot bi-causal split (heads of
    64): a training step launches #1f, #2f, #4f, #5f once a layer and #13f
    once a layer and for the final norm, never #3f or a bf16 kernel; its
    loss and every gradient within 1e-5 and 1e-4 of the plain fp32 run on
    the same draws."""
    from graphgpt_torch.models.denoise import GraphGPTDenoise, denoise_draws
    from graphgpt_torch.synthetic import mol3d_batch

    dev = cuda_device
    cfg = ModelConfig(vocab_size=755, hidden_size=128, num_hidden_layers=2,
                      num_attention_heads=2, stacked_feat=13, next_n_token=1, mask_token_id=1,
                      task_type="graph", stacked_feat_agg_method="gated",
                      problem_type="regression", loss_type="l1", bi_causal_split=16,
                      dtype="float32").finalize()
    model = GraphGPTDenoise(cfg, device=dev, seed=0)
    batch = to_torch(mol3d_batch(8, 88, seed=0, bi_split=16), dev)
    draws = denoise_draws(8, 88, torch.Generator(device=dev).manual_seed(1), dev)
    got, run, ref = _f32_step_vs_plain(model, batch, lambda: {"draws": draws})
    assert got == {"flash_fwd_f32": 2, "flash_dq_f32": 2, "flash_dkv_f32": 2,
                   "norm_mlp_f32": 2, "rmsnorm_bwd_f32": 3}
    _assert_f32_step(run, ref)


# (B, P, H, RoPE, key ids, mask) of #6f-#8f's cases: past 4,096 rows with a
# segment across tiles 63 and 64 (#7f and #8f walk a second 64-tile mask
# chunk there), the keys' own ids (another array: some query rows see no
# key, some keys no query), causal, bi-causal with 16 bit slots, P 4096
# (the long-context rows) with both kinds of key ids, without RoPE (skip
# mode's rows), one row of P 8192 (two whole chunks) causal and bi-causal
_F32_STREAM_CASES = {
    "P4160": (1, 4160, 2, True, "same", "bidirectional"),
    "P4160-other-keys": (1, 4160, 2, True, "other", "bidirectional"),
    "P4160-causal": (1, 4160, 2, True, "same", "causal"),
    "P2112-bicausal": (1, 2112, 2, True, "same", "bi-causal"),
    "P4096": (2, 4096, 2, True, "same", "bidirectional"),
    "P4096-no-rope": (2, 4096, 2, False, "other", "bidirectional"),
    "P8192-causal": (1, 8192, 2, True, "same", "causal"),
    "P8192-bicausal-other-keys": (1, 8192, 2, True, "other", "bi-causal"),
}
_STREAM_MASKS = {"bidirectional": (False, 0), "causal": (True, 0), "bi-causal": (False, 16)}


def _f32_stream_inputs(case, dev, seed=7):
    """(qs, k, v, do, seg_q, seg_k, cos, sin) of a _F32_STREAM_CASES case, in
    fp32: packed rows, one segment across positions 4032-4111 where P > 4096,
    the last 40 positions padded; "other" key ids: the query ids shifted one
    position left, the keys of one segment made padding (its query rows see
    no key) and those of another given an id no query has (no query sees
    them)."""
    b, p, h, rope, keys, _ = _F32_STREAM_CASES[case]
    dh = 64
    rng = np.random.default_rng(seed)

    def f32(scale):
        return torch.from_numpy((rng.normal(size=(b, p, h * dh)) * scale)
                                .astype(np.float32)).to(dev)

    qs, k, v, do = f32(0.5 * dh**-0.5), f32(0.5), f32(0.5), f32(0.5)
    seg = packed_segments(b, p, rng)
    if p > 4096:
        seg[:, 4032:4112] = seg[:, 4031:4032]
    seg[:, p - 40:] = 0
    seg_k = seg
    if keys == "other":
        seg_k = np.zeros_like(seg)
        seg_k[:, :-1] = seg[:, 1:]
        seg_k[seg_k == 3] = 0
        seg_k[seg_k == 5] = 10**6
    cos = sin = None
    if rope:
        cos, sin = rope_cos_sin(torch.arange(p, device=dev).expand(b, p), dh)
    return (qs, k, v, do, torch.from_numpy(seg).to(dev), torch.from_numpy(seg_k).to(dev), cos,
            sin)


_STREAM_COUNTS = ("flash_fwd_stream", "flash_dq_stream", "flash_dkv_stream",
                  "flash_fwd_stream_f32", "flash_dq_stream_f32", "flash_dkv_stream_f32",
                  "flash_fwd_f32", "flash_bwd_f32", "flash_dq_f32", "flash_dkv_f32")


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(_F32_STREAM_CASES))
def test_fp32_stream_kernels_match_plain(cuda_device, case):
    """#6's, #7's and #8's fp32 forms through flash_fwd_stream,
    flash_dq_stream (with its delta, a cotangent of lse folded in) and
    flash_dkv_stream against their plain versions in fp32 (TF32 off): out,
    lse, dq, delta, dk, dv within F32_REL, the TF32 controls of out, dq,
    dk, dv past it; padded query rows and rows that see no key give out 0,
    lse -1e30, dq 0; keys that no query sees (padded, or of an id no query
    has) dk = dv = 0; one launch of each fp32 stream form and none of the
    bf16 ones or of #1f, #3f-#5f; a relaunch gives the same bits."""
    dev = cuda_device
    causal, bi = _STREAM_MASKS[_F32_STREAM_CASES[case][5]]
    qs, k, v, do, seg, seg_k, cos, sin = _f32_stream_inputs(case, dev)
    b, p, hd = qs.shape
    valid = seg > 0
    dlse = torch.from_numpy(np.random.default_rng(3).normal(size=(b, hd // 64, p))
                            .astype(np.float32)).to(dev) * 0.1 * valid[:, None, :]
    fwd_args = (qs, k, v, seg, seg_k, cos, sin, causal, 64, bi)
    counts = [getattr(tfa, n) for n in _STREAM_COUNTS]
    before = [c.launches for c in counts]
    out, lse = tfa.flash_fwd_stream(*fwd_args)
    dq_args = (qs, k, v, seg, seg_k, cos, sin, out, lse, do, dlse, causal, 64, bi)
    dq, delta = tfa.flash_dq_stream(*dq_args)
    dkv_args = (qs, k, v, seg, seg_k, cos, sin, lse, delta, do, causal, 64, bi)
    dk, dv = tfa.flash_dkv_stream(*dkv_args)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counts, before)] == [0, 0, 0, 1, 1, 1, 0, 0, 0, 0]
    with ops.reference_mode():
        rout, rlse = tfa.flash_fwd_stream(*fwd_args)
        rdq, rdelta = tfa.flash_dq_stream(*dq_args)
        rdk, rdv = tfa.flash_dkv_stream(*dkv_args)
        with _tf32():
            tout = tfa.flash_fwd_stream(*fwd_args)[0]
            tdq = tfa.flash_dq_stream(*dq_args)[0]
            tdk, tdv = tfa.flash_dkv_stream(*dkv_args)
    seen_q = torch.stack([torch.isin(a, c[c > 0]) for a, c in zip(seg, seg_k)]) & valid
    seen_k = torch.stack([torch.isin(c, a[a > 0]) for a, c in zip(seg, seg_k)]) & (seg_k > 0)
    assert bool(seen_q.any()) and bool(seen_k.any())
    if _F32_STREAM_CASES[case][4] == "other":
        assert bool((valid & ~seen_q).any()) and bool(((seg_k > 0) & ~seen_k).any())
    lse_rows = lse.transpose(1, 2)
    assert _rel(lse_rows[seen_q], rlse.transpose(1, 2)[seen_q]) < F32_REL
    assert bool((lse_rows[~seen_q] == -1e30).all()) and bool((out[~seen_q] == 0).all())
    assert _rel(delta, rdelta) < F32_REL
    for name, g, r, t in zip(("out", "dq", "dk", "dv"), (out, dq, dk, dv), (rout, rdq, rdk, rdv),
                             (tout, tdq, tdk, tdv)):
        assert g.dtype == torch.float32 and _rel(g, r) < F32_REL, name
        assert _rel(t, r) > F32_REL, name
    assert bool((dq[~seen_q] == 0).all())
    assert bool((dk[~seen_k] == 0).all()) and bool((dv[~seen_k] == 0).all())
    again = (*tfa.flash_fwd_stream(*fwd_args), *tfa.flash_dq_stream(*dq_args),
             *tfa.flash_dkv_stream(*dkv_args))
    assert all(torch.equal(a, g) for a, g in zip(again, (out, lse, dq, delta, dk, dv)))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["P4160", "P8192-bicausal-other-keys"])
def test_fp32_stream_pair_ignores_non_finite_do_in_padded_rows(cuda_device, case):
    """inf and NaN in do's padded rows change no bit of #7f's dq and delta or
    #8f's dk and dv."""
    dev = cuda_device
    causal, bi = _STREAM_MASKS[_F32_STREAM_CASES[case][5]]
    qs, k, v, do, seg, seg_k, cos, sin = _f32_stream_inputs(case, dev, seed=13)
    out, lse = tfa.flash_fwd_stream(qs, k, v, seg, seg_k, cos, sin, causal, 64, bi)
    pad = (seg == 0)[..., None]
    clean = torch.where(pad, torch.zeros_like(do), do)
    noisy = clean.clone()
    noisy[pad.expand_as(noisy)] = float("nan")
    noisy[0, -8:] = float("inf")
    runs = []
    for d in (clean, noisy):
        dq, delta = tfa.flash_dq_stream(qs, k, v, seg, seg_k, cos, sin, out, lse, d, None, causal,
                                        64, bi)
        runs.append((dq, delta, *tfa.flash_dkv_stream(qs, k, v, seg, seg_k, cos, sin, lse, delta,
                                                      d, causal, 64, bi)))
    torch.cuda.synchronize()
    for a, n in zip(*runs):
        assert bool(torch.isfinite(a).all()) and torch.equal(a, n)


@pytest.mark.gpu
def test_the_fp32_stream_form_on_one_id_array_gives_the_single_forms_bits(cuda_device):
    """#6f with the query ids as key ids and #1f's entry on the same rows
    (the first 2,048 positions of a long row: #1f takes P <= 2048): one
    body, the same tiles in the same order, the same bits."""
    from graphgpt_torch.ops import _build

    dev = cuda_device
    qs, k, v, _, seg, _, cos, sin = (t[:, :tfa.MAX_P].contiguous()
                                     for t in _f32_stream_inputs("P4160", dev))
    out, lse = tfa.flash_fwd_stream(qs, k, v, seg, seg, cos, sin, False, 64)
    b, p, hd = qs.shape
    out1, lse1 = torch.empty_like(out), torch.empty_like(lse)
    seg32 = seg.to(torch.int32).contiguous()
    fn = _build.entry("flash_bwd_split_f32", "ggt_flash_fwd_f32", tfa._ARGTYPES)
    _build.check(fn(_build.ptr(qs), _build.ptr(k), _build.ptr(v), _build.ptr(seg32),
                    _build.ptr(cos), _build.ptr(sin), _build.ptr(out1), _build.ptr(lse1), b, p,
                    hd // 64, 0, 0, _build.stream_ptr(dev)), "ggt_flash_fwd_f32")
    torch.cuda.synchronize()
    assert torch.equal(out1, out) and torch.equal(lse1, lse)


@pytest.mark.gpu
@pytest.mark.parametrize("mode,p", [("legacy", 2112), ("skip", 128)])
def test_an_fp32_model_trains_on_the_fp32_stream_kernels(cuda_device, mode, p, monkeypatch):
    """A two-layer fp32 model (heads of 64, save_attn) past 2,048 positions,
    or under skip at P 128: a training step launches #6f, #7f, #8f and #2f
    once a layer and #13f once a layer and for the final norm, nothing
    else; its loss and every gradient within 1e-5 and 1e-4 of the plain
    fp32 run."""
    dev = cuda_device
    monkeypatch.setattr(tfa, "_MODE", mode)
    cfg = _tiny_cfg(num_attention_heads=2, num_key_value_heads=2, intermediate_size=512,
                    dtype="float32", remat=True, remat_policy="save_attn",
                    max_position_embeddings=max(p, 1024))
    model = GraphGPTPretrain(cfg, device=dev, seed=0)
    batch = to_torch(fake_batch(2, p, 3, 50, np.random.default_rng(4)), dev)
    got, run, ref = _f32_step_vs_plain(model, batch, dict)
    assert got == {"flash_fwd_stream_f32": 2, "flash_dq_stream_f32": 2,
                   "flash_dkv_stream_f32": 2, "norm_mlp_f32": 2, "rmsnorm_bwd_f32": 3}
    _assert_f32_step(run, ref)


# The fp32 attention forms' digests (split_probe's f32_digest) through their
# wrappers at split_probe's fp32 inputs (`inputs`: packed rows, no lse
# cotangent; the stream forms and #9f on the query ids as key ids, #9f on q
# and k unrotated), from `split_probe --kernel fwd_f32 --pins --source` on
# an NVIDIA H100 80GB HBM3, --source the flash_fwd_f32.cu that held the
# FFMA #1f and #6f. The backward forms read out and lse from the plain
# forward in float64 rounded to fp32 (`plain_fwd64`), which no kernel's
# redesign moves. On the FFMA forward's out and lse the same call gave the
# digests each backward form was pinned to before (the comments below):
# its body is the one those pins held. #3f's (the FFMA passes) and #9f's
# (flash_fwd_f32.cu's band form, equal to --source's in that call) here;
# #4f's and #5f's in _F32_SPLIT_DIGESTS, #7f's and #8f's in
# _F32_STREAM_SPLIT_DIGESTS, #1f's and #6f's in _F32_FWD_DIGESTS, #2f's,
# #11f's and #12f's in _F32_TF32X3_DIGESTS. On the FFMA forward's out and
# lse #3f gave -916961056836012 and -17989573487664.
_F32_PARENT_DIGESTS = {
    ("flash_bwd_f32", "B8 P1024"): -916961054546720,
    ("flash_bwd_f32", "toy B8 P128"): -17989573239738,
    ("flash_fwd_band_f32", "B8 P1024"): -163432506408151,
    ("flash_fwd_band_f32", "B16 P4096"): -1512338697010656,
}
# #4f's and #5f's (csrc/flash_bwd_split_f32.cu: 3xTF32 products, another
# order of sums than the FFMA passes'); on the FFMA forward's out and lse
# they gave their first build's -2136141201081277, -2976345812947738,
# -249146572008087, -672921792860440
_F32_SPLIT_DIGESTS = {
    ("flash_dq_f32", "denoise B256 P88"): -2136141195266819,
    ("flash_dkv_f32", "denoise B256 P88"): -2976348014024672,
    ("flash_dq_f32", "B8 P1024 bi16"): -249146571354909,
    ("flash_dkv_f32", "B8 P1024 bi16"): -672923969654895,
}
# #1f's and #6f's as the first build of the split body's forward role gave
# them (3xTF32 products; the FFMA body's were -165906643651216 at 8 x 1024,
# -328070100018431 at the denoise batch, -1508182275918902 at 16 x 4096);
# #1f's equal #6f's on one id array
_F32_FWD_DIGESTS = {
    ("flash_fwd_f32", "B8 P1024"): -165906662815964,
    ("flash_fwd_f32", "denoise B256 P88"): -328070114397490,
    ("flash_fwd_stream_f32", "B8 P1024"): -165906662815964,
    ("flash_fwd_stream_f32", "B16 P4096"): -1508183273533821,
}
# #7f's and #8f's (the split body's stream form); on the FFMA forward's out
# and lse they gave their first build's -249068053440236, -670984090665018
# at B 8 x P 1024 and -2002096683127753, -5674440358447462 at B 16 x P 4096
_F32_STREAM_SPLIT_DIGESTS = {
    ("flash_dq_stream_f32", "B8 P1024"): -249068050128931,
    ("flash_dkv_stream_f32", "B8 P1024"): -670986253471526,
    ("flash_dq_stream_f32", "B16 P4096"): -2002094545623725,
    ("flash_dkv_stream_f32", "B16 P4096"): -5674437461299102,
}


def _f32_attention_digest(form, shape, dev):
    """The digest of `form` through its wrapper at split_probe's fp32 inputs
    of `shape` (split_probe.f32_form_digest)."""
    from graphgpt_torch.ops import split_probe as sp

    return sp.f32_form_digest(form, shape, dev)


@pytest.mark.gpu
@pytest.mark.parametrize("form,shape", list(_F32_FWD_DIGESTS))
def test_fp32_forward_keeps_its_bits(cuda_device, form, shape):
    """#1f through flash_fwd and #6f through flash_fwd_stream (out and lse)
    give the bits of the split body's forward role's first build."""
    assert _f32_attention_digest(form, shape, cuda_device) == _F32_FWD_DIGESTS[form, shape]


@pytest.mark.gpu
@pytest.mark.parametrize("form,shape", list(_F32_PARENT_DIGESTS))
def test_fp32_forms_keep_the_bits_of_their_bodies_before_the_new_forms(cuda_device, form,
                                                                        shape):
    """#3f and #9f through their wrappers on fp32 tensors give the bits
    their FFMA bodies gave before #1f and #6f left them for the split
    body."""
    assert _f32_attention_digest(form, shape, cuda_device) == _F32_PARENT_DIGESTS[form, shape]


@pytest.mark.gpu
@pytest.mark.parametrize("form,shape", list(_F32_SPLIT_DIGESTS))
def test_fp32_split_pair_keeps_its_bits(cuda_device, form, shape):
    """#4f through flash_dq (dq and delta) and #5f through flash_dkv (dk,
    dv) at the denoise batch and at B 8 x P 1024 with 16 bit slots give the
    bits of their Hopper body's first build."""
    assert _f32_attention_digest(form, shape, cuda_device) == _F32_SPLIT_DIGESTS[form, shape]


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["flash_fwd_stream_f32"])
def test_fp32_stream_forms_keep_their_bits(cuda_device, form):
    """#6f through flash_fwd_stream at B 16 x P 4096 gives the bits of the
    split body's forward role's first build."""
    assert (_f32_attention_digest(form, "B16 P4096", cuda_device)
            == _F32_FWD_DIGESTS[form, "B16 P4096"])


@pytest.mark.gpu
@pytest.mark.parametrize("form,shape", list(_F32_STREAM_SPLIT_DIGESTS))
def test_fp32_stream_pair_keeps_its_bits(cuda_device, form, shape):
    """#7f through flash_dq_stream (dq and delta) and #8f through
    flash_dkv_stream (dk, dv) at B 8 x P 1024 and B 16 x P 4096 give the
    bits of their Hopper body's first build."""
    got = _f32_attention_digest(form, shape, cuda_device)
    assert got == _F32_STREAM_SPLIT_DIGESTS[form, shape]


# ---- the fp32 forms of the knobs' kernels: #9 and #10 (flash_fwd_f32.cu's
# and flash_bwd_f32.cu's band forms, GGT_FLASH_MODE=band) and #12
# (mlp_qkv_f32.cu's QKV mode, GGT_ATTN_NORM_FUSE=1)

# (B, P, H, key ids, mask) of the band forms' cases: phase P(a)'s shapes cut
# small (the serving rows, causal, another row's ids, the denoise batch,
# the long-context rows), and a ragged last tile
_F32_BAND_CASES = {
    "P1024": (2, 1024, 12, "same", "bidirectional"),
    "P1024-causal": (2, 1024, 12, "same", "causal"),
    "P1024-other": (2, 1024, 12, "other", "bidirectional"),
    "P88-bicausal": (4, 88, 12, "same", "bi-causal"),
    "P4096": (1, 4096, 2, "same", "bidirectional"),
    "P1000-other-causal": (2, 1000, 3, "other", "causal"),
}
_F32_BAND_COUNTS = ("flash_fwd_band", "flash_bwd_band", "flash_fwd_band_f32",
                    "flash_bwd_band_f32", "flash_fwd_stream_f32", "flash_dq_stream_f32",
                    "flash_dkv_stream_f32", "flash_fwd_f32", "flash_bwd_f32")


def _f32_band_inputs(case, dev, seed=29):
    """(qs, k, v, do, seg_q, seg_k) of an _F32_BAND_CASES case in fp32, q and
    k as the band route hands them over (rotated: no cos, sin): packed rows
    with 40 positions of the last row padded (the denoise batch: molecules
    and their bit slots); "other" key ids: _f32_stream_inputs' (a segment's
    keys made padding, another's given an id no query has)."""
    b, p, h, keys, mask = _F32_BAND_CASES[case]
    dh = 64
    rng = np.random.default_rng(seed)

    def f32(scale):
        return torch.from_numpy((rng.normal(size=(b, p, h * dh)) * scale)
                                .astype(np.float32)).to(dev)

    qs, k, v, do = f32(0.5 * dh**-0.5), f32(0.5), f32(0.5), f32(0.5)
    if mask == "bi-causal":
        seg = _denoise_row_segments(b, p, 16, rng)
    else:
        seg = packed_segments(b, p, rng)
        seg[-1, p - 40:] = 0
    seg_k = seg
    if keys == "other":
        seg_k = np.zeros_like(seg)
        seg_k[:, :-1] = seg[:, 1:]
        seg_k[seg_k == 3] = 0
        seg_k[seg_k == 5] = 10**6
    seg = torch.from_numpy(seg).to(dev)
    return qs, k, v, do, seg, seg if keys == "same" else torch.from_numpy(seg_k).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(_F32_BAND_CASES))
def test_fp32_band_kernels_match_plain(cuda_device, case):
    """#9's and #10's fp32 forms through flash_fwd_band and flash_bwd_band
    (with its delta and a cotangent of lse) against their plain versions in
    fp32 (TF32 off): out, lse, delta, dq, dk, dv within F32_REL, the TF32
    controls of out, dq, dk, dv past it; both band tables equal
    band_limits; padded query rows and rows that see no key give out 0, lse
    -1e30, dq 0; keys that no query sees dk = dv = 0; one launch of each
    fp32 band form and of nothing else; a relaunch gives the same bits."""
    dev = cuda_device
    causal, bi = _STREAM_MASKS[_F32_BAND_CASES[case][4]]
    qs, k, v, do, seg, seg_k = _f32_band_inputs(case, dev)
    b, p, hd = qs.shape
    valid = seg > 0
    dlse = torch.from_numpy(np.random.default_rng(3).normal(size=(b, hd // 64, p))
                            .astype(np.float32)).to(dev) * 0.1 * valid[:, None, :]
    fwd_args = (qs, k, v, seg, seg_k, causal, 64, bi)
    counts = [getattr(tfa, n) for n in _F32_BAND_COUNTS]
    before = [c.launches for c in counts]
    faux, baux = {}, {}
    out, lse = tfa.flash_fwd_band(*fwd_args, aux=faux)
    bwd_args = (qs, k, v, seg, seg_k, out, lse, do, dlse, causal, 64, bi)
    dq, dk, dv = tfa.flash_bwd_band(*bwd_args, aux=baux)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counts, before)] == [0, 0, 1, 1, 0, 0, 0, 0, 0]
    assert torch.equal(faux["table"], tfa.band_limits(seg, seg_k))
    assert torch.equal(baux["table_k"], tfa.band_limits(seg_k, seg))
    with ops.reference_mode():
        rout, rlse = tfa.flash_fwd_band(*fwd_args)
        rdq, rdk, rdv = tfa.flash_bwd_band(*bwd_args, aux=(raux := {}))
        with _tf32():
            tout = tfa.flash_fwd_band(*fwd_args)[0]
            tdq, tdk, tdv = tfa.flash_bwd_band(*bwd_args)
    seen_q, seen_k = [], []
    for r in range(b):
        m = tfa._valid_mask(seg[r : r + 1], causal, bi, seg_k[r : r + 1])[0, 0]
        seen_q.append(m.any(dim=1))
        seen_k.append(m.any(dim=0))
    seen_q, seen_k = torch.stack(seen_q), torch.stack(seen_k)
    assert bool(seen_q.any()) and bool(seen_k.any())
    lse_rows = lse.transpose(1, 2)
    assert _rel(lse_rows[seen_q], rlse.transpose(1, 2)[seen_q]) < F32_REL
    assert bool((lse_rows[~seen_q] == -1e30).all()) and bool((out[~seen_q] == 0).all())
    assert _rel(baux["delta"], raux["delta"]) < F32_REL
    for name, g, r, t in zip(("out", "dq", "dk", "dv"), (out, dq, dk, dv), (rout, rdq, rdk, rdv),
                             (tout, tdq, tdk, tdv)):
        assert g.dtype == torch.float32 and _rel(g, r) < F32_REL, name
        assert _rel(t, r) > F32_REL, name
    assert bool((dq[~seen_q] == 0).all())
    assert bool((dk[~seen_k] == 0).all()) and bool((dv[~seen_k] == 0).all())
    again_aux = {}
    again = (*tfa.flash_fwd_band(*fwd_args), *tfa.flash_bwd_band(*bwd_args, aux=again_aux))
    assert all(torch.equal(a, g) for a, g in zip(again, (out, lse, dq, dk, dv)))
    assert torch.equal(again_aux["delta"], baux["delta"])


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["P1024", "P88-bicausal", "P1000-other-causal"])
def test_fp32_band_backward_ignores_non_finite_do_in_padded_rows(cuda_device, case):
    """inf and NaN in do's padded rows change no bit of #10f's dq, dk, dv
    or its delta."""
    dev = cuda_device
    causal, bi = _STREAM_MASKS[_F32_BAND_CASES[case][4]]
    qs, k, v, do, seg, seg_k = _f32_band_inputs(case, dev, seed=31)
    out, lse = tfa.flash_fwd_band(qs, k, v, seg, seg_k, causal, 64, bi)
    pad = (seg == 0)[..., None]
    assert bool(pad.any())
    clean = torch.where(pad, torch.zeros_like(do), do)
    noisy = clean.clone()
    noisy[pad.expand_as(noisy)] = float("nan")
    noisy[-1][pad[-1, :, 0]] = float("inf")
    runs = []
    for d in (clean, noisy):
        aux = {}
        runs.append((*tfa.flash_bwd_band(qs, k, v, seg, seg_k, out, lse, d, None, causal, 64,
                                         bi, aux=aux), aux["delta"]))
    torch.cuda.synchronize()
    for a, n in zip(*runs):
        assert bool(torch.isfinite(a).all()) and torch.equal(a, n)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["P1024", "P1024-causal", "P1024-other", "P88-bicausal",
                                  "P4096"])
def test_fp32_band_forms_give_the_bits_of_the_other_forms(cuda_device, case):
    """#9f lies within F32_REL of #6f (out, and lse on the rows that see a
    key; the rows that see none exactly alike), and #10f of #7f's and #8f's
    (dq, delta, dk, dv) and, with a split, of #4f's and #5f's: another body
    (csrc/flash_bwd_split_f32.cu), which sums in another order. A key tile
    outside the band holds no visible pair, so on one id array #10f gives
    #3f's bits without a split; and there #1f gives #6f's (one body, the
    same tiles in the same order), where it takes the row (P <= 2048)."""
    dev = cuda_device
    causal, bi = _STREAM_MASKS[_F32_BAND_CASES[case][4]]
    qs, k, v, do, seg, seg_k = _f32_band_inputs(case, dev, seed=37)
    out, lse = tfa.flash_fwd_band(qs, k, v, seg, seg_k, causal, 64, bi)
    aux = {}
    dq, dk, dv = tfa.flash_bwd_band(qs, k, v, seg, seg_k, out, lse, do, None, causal, 64, bi,
                                    aux=aux)
    sout, slse = tfa.flash_fwd_stream(qs, k, v, seg, seg_k, None, None, causal, 64, bi)
    sdq, sdelta = tfa.flash_dq_stream(qs, k, v, seg, seg_k, None, None, out, lse, do, None,
                                      causal, 64, bi)
    sdk, sdv = tfa.flash_dkv_stream(qs, k, v, seg, seg_k, None, None, lse, sdelta, do, causal,
                                    64, bi)
    torch.cuda.synchronize()
    live = lse > -1e30
    assert torch.equal(live, slse > -1e30) and torch.equal(lse[~live], slse[~live])
    assert _rel(out, sout) < F32_REL and _rel(lse[live], slse[live]) < F32_REL
    assert all(_rel(a, b) < F32_REL for a, b in zip((dq, aux["delta"], dk, dv),
                                                    (sdq, sdelta, sdk, sdv)))
    if seg_k is not seg:
        return
    if qs.shape[1] <= tfa.MAX_P:
        one = tfa.flash_fwd_f32(qs, k, v, seg, None, None, causal, 64, bi)
        torch.cuda.synchronize()
        assert torch.equal(one[0], sout) and torch.equal(one[1], slse)
    if bi:
        qd, qdelta = tfa.flash_dq_f32(qs, k, v, seg, None, None, out, lse, do, None, causal, 64,
                                      bi)
        grads = (qd, qdelta, *tfa.flash_dkv_f32(qs, k, v, seg, None, None, lse, qdelta, do,
                                                causal, 64, bi))
        torch.cuda.synchronize()
        assert all(_rel(a, b) < F32_REL for a, b in zip((dq, aux["delta"], dk, dv), grads))
    else:
        grads = tfa.flash_bwd_f32(qs, k, v, seg, None, None, out, lse, do, None, causal, 64)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip((dq, dk, dv), grads))


# (N, D, q, k, v widths) of #12f's cases: the serving rows, a ragged row
# tile, GQA, toy_pretrain's D 128, the widest hidden size, the CPU
# emulation's ragged GQA shape
_F32_QKV_CASES = {
    "ragged_gqa": (200, 128, (128, 64, 64)),
    "N8192": (8192, 768, (768, 768, 768)),
    "N65537": (65537, 768, (768, 768, 768)),
    "gqa": (4096, 768, (768, 256, 256)),
    "toy": (1024, 128, (128, 128, 128)),
    "d1600": (1000, 1600, (1600, 1600, 1600)),
    "n1": (1, 128, (128, 64, 64)),
}
RRMS_REL = 1e-5  # fp32 sums of D squares in another order, 1 / sqrtf against torch.rsqrt


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(_F32_QKV_CASES))
def test_fp32_norm_qkv_kernel_matches_plain(cuda_device, case):
    """#12's fp32 form through norm_qkv against its plain version in fp32
    (TF32 off): q, k, v within F32_REL, the TF32 control past it (inputs
    drawn in fp32, so that TF32 rounds them), its rrms pre-pass within
    RRMS_REL of the plain statistics, one fp32 launch a call and no bf16
    one, bit-equal on a relaunch."""
    from graphgpt_torch.ops import _build

    dev = cuda_device
    n, d, widths = _F32_QKV_CASES[case]
    rng = np.random.default_rng(41)

    def f32(shape, scale, loc=0.0):
        return torch.from_numpy((loc + rng.normal(size=shape) * scale).astype(np.float32)).to(dev)

    x, wn = f32((n, d), 1.0), f32((d,), 0.1, 1.0)
    ws = [f32((w, d), 0.55 / d**0.5) for w in widths]
    before = (tmlp.norm_qkv.launches, tmlp.norm_qkv_f32.launches)
    got = tmlp.norm_qkv(x, wn, *ws, 1e-6)
    torch.cuda.synchronize()
    assert (tmlp.norm_qkv.launches, tmlp.norm_qkv_f32.launches) == (before[0], before[1] + 1)
    with ops.reference_mode():
        want = tmlp.norm_qkv(x, wn, *ws, 1e-6)
        with _tf32():
            tf = tmlp.norm_qkv(x, wn, *ws, 1e-6)
    for name, g, r, t in zip("qkv", got, want, tf):
        assert g.dtype == torch.float32 and g.shape == (n, r.shape[1]), name
        assert _rel(g, r) < F32_REL, name
        if n > 1:
            assert _rel(t, r) > F32_REL, name
    assert all(torch.equal(a, b) for a, b in zip(tmlp.norm_qkv(x, wn, *ws, 1e-6), got))
    rr = torch.empty(n, device=dev)
    fn = _build.entry("mlp_qkv_f32", "ggt_norm_qkv_f32_rrms",
                      [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_float,
                                                                     ctypes.c_void_p])
    _build.check(fn(_build.ptr(x), _build.ptr(rr), n, d, 1e-6, _build.stream_ptr(dev)), "rrms")
    torch.cuda.synchronize()
    plain = torch.rsqrt(x.pow(2).mean(-1) + 1e-6)
    assert ((rr - plain).abs().max() / plain.abs().max()).item() <= RRMS_REL


@pytest.mark.gpu
def test_fp32_norm_qkv_kernel_takes_no_rows(cuda_device):
    """N 0 gives empty fp32 q, k, v and launches nothing."""
    dev = cuda_device
    x = torch.zeros(0, 768, device=dev)
    ws = [torch.zeros(w, 768, device=dev) for w in (768, 256, 256)]
    before = tmlp.norm_qkv_f32.launches
    out = tmlp.norm_qkv(x, torch.ones(768, device=dev), *ws, 1e-6)
    assert [tuple(o.shape) for o in out] == [(0, 768), (0, 256), (0, 256)]
    assert tmlp.norm_qkv_f32.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("p", [128, 1024])
def test_an_fp32_model_trains_under_both_knobs(cuda_device, p, monkeypatch):
    """A two-layer fp32 model (heads of 64, save_attn) under
    GGT_FLASH_MODE=band and GGT_ATTN_NORM_FUSE=1: a training step launches
    #9f, #10f and #2f once a layer, #12f twice a layer (the forward and the
    save_attn recompute), #13f once a layer and for the final norm, nothing
    else; its loss and every gradient within 1e-5 and 1e-4 of the plain
    fp32 run."""
    dev = cuda_device
    monkeypatch.setattr(tfa, "_MODE", "band")
    monkeypatch.setenv("GGT_ATTN_NORM_FUSE", "1")
    cfg = _tiny_cfg(num_attention_heads=2, num_key_value_heads=2, intermediate_size=512,
                    dtype="float32", remat=True, remat_policy="save_attn")
    model = GraphGPTPretrain(cfg, device=dev, seed=0)
    batch = to_torch(fake_batch(2, p, 3, 50, np.random.default_rng(4)), dev)
    got, run, ref = _f32_step_vs_plain(model, batch, dict)
    assert got == {"flash_fwd_band_f32": 2, "flash_bwd_band_f32": 2, "norm_qkv_f32": 4,
                   "norm_mlp_f32": 2, "rmsnorm_bwd_f32": 3}
    _assert_f32_step(run, ref)


# ---- #11f and #12f on their 3xTF32 body (mlp_qkv_f32.cu): every tile width
# each is built for, and the bits of its first build

# #11f's, #12f's and #2f's digests as the first build of their 3xTF32 body
# gave them (#2f's joined it later, its norm and residual template flags
# leaving #11f's and #12f's instances as they were): `split_probe --kernel
# mlp_f32` (f32_mlp_inputs, gelu; #12f's q, k, v weights the first D rows
# of wg, of wu, and rows D.. of wg), on an NVIDIA H100 80GB HBM3
_F32_TF32X3_DIGESTS = {
    ("mlp_f32", "N8192"): -225409867562753,
    ("mlp_f32", "N1024"): -3611698320819,
    ("norm_qkv_f32", "N8192"): -445785109629213,
    ("norm_qkv_f32", "N1024"): -8578998215950,
    ("norm_mlp_f32", "N8192"): -98385026759675,
    ("norm_mlp_f32", "N1024"): -2074798871119,
}


@pytest.mark.gpu
@pytest.mark.parametrize("bn", [128, 64])
def test_fp32_mlp_kernel_takes_every_tile_width(cuda_device, monkeypatch, bn):
    """#11f with each down width BN it is built for, forced in place of
    f32_block_n's choice, at D 768, F 3072 and a ragged N, within F32_REL
    of the plain fp32 version and bit-equal on a relaunch."""
    from graphgpt_torch.ops.split_probe import f32_mlp_inputs

    x, _, wg, wu, wd = f32_mlp_inputs(1000, 768, 3072, cuda_device, seed=bn)
    monkeypatch.setattr(tmlp, "f32_block_n", lambda widths: bn)
    out = tmlp.mlp(x, wg, wu, wd, "gelu")
    torch.cuda.synchronize()
    with ops.reference_mode():
        ref = tmlp.mlp(x, wg, wu, wd, "gelu")
    assert _rel(out, ref) < F32_REL
    assert torch.equal(tmlp.mlp(x, wg, wu, wd, "gelu"), out)


@pytest.mark.gpu
@pytest.mark.parametrize("bn", [128, 64])
@pytest.mark.parametrize("widths", [(768, 768, 768), (768, 256, 256)], ids=["mha", "gqa"])
def test_fp32_norm_qkv_kernel_takes_every_tile_width(cuda_device, monkeypatch, bn, widths):
    """#12f with each tile width BN it is built for, forced in place of
    f32_block_n's choice, at D 768, a ragged N and GQA's widths, within
    F32_REL of the plain fp32 version and bit-equal on a relaunch."""
    from graphgpt_torch.ops.split_probe import f32_mlp_inputs

    x, wn, wg, wu, _ = f32_mlp_inputs(1000, 768, 768, cuda_device, seed=bn)
    ws = (wg, wu[: widths[1]], wu[-widths[2]:])
    monkeypatch.setattr(tmlp, "f32_block_n", lambda w: bn)
    got = tmlp.norm_qkv(x, wn, *ws, 1e-6)
    torch.cuda.synchronize()
    with ops.reference_mode():
        want = tmlp.norm_qkv(x, wn, *ws, 1e-6)
    for name, g, w in zip("qkv", got, want):
        assert _rel(g, w) < F32_REL, name
    assert all(torch.equal(a, b) for a, b in zip(tmlp.norm_qkv(x, wn, *ws, 1e-6), got))


@pytest.mark.gpu
@pytest.mark.parametrize("form,shape", list(_F32_TF32X3_DIGESTS))
def test_fp32_tf32x3_forms_keep_their_bits(cuda_device, form, shape):
    """#11f through mlp, #12f through norm_qkv and #2f through norm_mlp at
    split_probe's fp32 inputs give the bits of their 3xTF32 body's first
    build."""
    from graphgpt_torch.ops import split_probe as sp

    n, d, f = sp.MLP_F32_SHAPES[shape]
    x, wn, wg, wu, wd = sp.f32_mlp_inputs(n, d, f, cuda_device)
    outs = {"mlp_f32": lambda: (tmlp.mlp(x, wg, wu, wd, "gelu"),),
            "norm_qkv_f32": lambda: tmlp.norm_qkv(x, wn, wg[:d], wu[:d], wg[d:2 * d], 1e-6),
            "norm_mlp_f32": lambda: (tmlp.norm_mlp(x, wn, wg, wu, wd, 1e-6, "gelu"),)}[form]()
    torch.cuda.synchronize()
    assert sp.f32_digest(*outs) == _F32_TF32X3_DIGESTS[form, shape]
