"""The port's CUDA kernels against their plain versions, on a CUDA card.

Every test here is marked `gpu` and skips without a card. The file imports
neither JAX nor the JAX package, so that it runs on a machine with a card
and no JAX; there the repository's conftest (which imports JAX) is left
out:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances are in bf16, the kernels' working type: the kernels and the plain
versions round at the same points but sum in another order.
"""

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
    does P > 2048 (the streamed kernels #6-#8, whatever the split); fp32
    still raises."""
    dev = cuda_device
    x = torch.zeros(1, 64, 2, 64, device=dev, dtype=torch.bfloat16, requires_grad=True)
    seg = torch.ones(1, 64, dtype=torch.int32, device=dev)
    out = tfa.flash_attention(x, x, x, seg, bi_causal_split=8)
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert torch.isfinite(x.grad.float()).all()
    with pytest.raises(NotImplementedError):
        tfa.flash_attention(x.float(), x.float(), x.float(), seg)
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
    from run to run. Past P 4096 (65 tiles: two 64-bit masks of visiting
    tiles in #7 and #8) a segment straddles tiles 63 and 64 on the first
    row."""
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
            tfa.flash_dkv_stream.launches] == [c + 1 for c in counts]
    again = tfa.flash_dkv_stream(*dkv_args)
    assert torch.equal(again[0], dk) and torch.equal(again[1], dv)
    again = tfa.flash_dq_stream(*dq_args)
    assert torch.equal(again[0], dq) and torch.equal(again[1], delta)


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
    with pytest.raises(NotImplementedError):
        tmlp.mlp(x.float(), w.float(), w.float(), w.t().float(), "gelu")
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
    """#1 and #3 refuse fp32, head dim 32 and a misaligned view on the host;
    #3's entry refuses P past MAX_P (the wrapper sends such rows to the
    streamed pair) with its own code."""
    dev = cuda_device
    qs, k, v, do, seg, cos, sin, _ = _flash_inputs("P72", dev)
    dh = 64
    out, lse = tfa.flash_fwd(qs, k, v, seg, cos, sin, False, dh)
    with pytest.raises(NotImplementedError):  # fp32
        tfa.flash_fwd(qs.float(), k.float(), v.float(), seg, cos, sin, False, dh)
    with pytest.raises(NotImplementedError):
        tfa.flash_bwd(qs.float(), k.float(), v.float(), seg, cos, sin, out.float(), lse,
                      do.float(), None, False, dh)
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


def _split_inputs(case, dev, seed=11):
    """(qs, k, v, do, seg, cos, sin) of a _SPLIT_CASES case."""
    b, p, h, bi, _, rope, layout = _SPLIT_CASES[case]
    dh = 64
    rng = np.random.default_rng(seed)
    qs = _bf16(rng, (b, p, h * dh), 0.5 * dh**-0.5, dev)
    k, v, do = (_bf16(rng, (b, p, h * dh), 0.5, dev) for _ in range(3))
    seg_np = _denoise_row_segments(b, p, bi, rng) if layout == "denoise" \
        else packed_segments(b, p, rng)
    seg = torch.from_numpy(seg_np).to(dev)
    cos = sin = None
    if rope:
        pos = torch.arange(p, device=dev).expand(b, p)
        cos, sin = (t.to(torch.bfloat16) for t in rope_cos_sin(pos, dh))
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

    with pytest.raises(NotImplementedError):  # fp32
        both(qs.float(), k.float(), v.float(), do.float(), out.float())
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
@pytest.mark.parametrize("shape", [(200, 128), (1000, 1600), (65536, 768)],
                         ids=["small", "wide", "flagship"])
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
    with pytest.raises(NotImplementedError):
        tmlp.rmsnorm_bwd(x.float(), x.float(), w, 1e-6)
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
    ((4, 88, 12), "same", "bi-causal"), ((1, 4096, 2), "same", "causal")],
    ids=["P1024", "P320-other-causal", "P88-bicausal", "P4096-causal"])
def test_band_kernels_match_plain(cuda_device, shape, keys, mask):
    """flash_fwd_band (#9) and flash_bwd_band (#10, with its delta and a
    cotangent of lse) against their plain versions, at the tolerances of the
    streamed kernels; the band tables equal band_limits; padded rows exactly
    0; the same bits from run to run."""
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
    assert [tfa.flash_fwd_band.launches, tfa.flash_bwd_band.launches] == [c + 1 for c in counts]
    again = tfa.flash_bwd_band(*args)
    assert all(torch.equal(a, g) for a, g in zip(again, (dq, dk, dv)))


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
