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


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("p", [128, 200])
def test_flash_kernel_matches_plain(cuda_device, causal, p):
    dev = cuda_device
    rng = np.random.default_rng(5)
    b, h, dh = 2, 3, 64
    q, k, v = (_bf16(rng, (b, p, h, dh), 0.5, dev) for _ in range(3))
    seg = packed_segments(b, p, rng)
    seg[-1, p - 30 :] = 0
    seg = torch.from_numpy(seg).to(dev)
    pos = torch.arange(p, device=dev).expand(b, p)
    rope = rope_cos_sin(pos, dh)
    before = tfa.flash_fwd.launches
    out, lse = tfa.flash_attention(q, k, v, seg, causal=causal, rope=rope, return_lse=True)
    torch.cuda.synchronize()
    assert tfa.flash_fwd.launches == before + 1
    with ops.reference_mode():
        rout, rlse = tfa.flash_attention(q, k, v, seg, causal=causal, rope=rope, return_lse=True)
    assert tfa.flash_fwd.launches == before + 1
    # bf16 out: the kernel rounds the probabilities relative to a running
    # max, the plain version relative to the row max
    torch.testing.assert_close(out.float(), rout.float(), atol=2e-2, rtol=2e-2)
    # and as a whole, so that a fault on the P.V side cannot hide under the
    # elementwise tolerance of small outputs
    valid = seg > 0
    diff = (out.float() - rout.float())[valid].norm() / rout.float()[valid].norm()
    assert diff.item() < 1e-2
    torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=1e-4)
    assert bool((out[-1, p - 30 :] == 0).all())
    assert bool((lse[-1, :, p - 30 :] == -1e30).all())


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
    ((1, 4100, 2), "same", "causal")], ids=["P4096", "P320-other", "P320-other-causal",
                                            "P320-other-bicausal", "P4100-causal"])
def test_stream_kernels_match_plain(cuda_device, shape, keys, mask):
    """flash_fwd_stream, flash_dq_stream (with its delta and a cotangent of
    lse) and flash_dkv_stream against their plain versions, at the
    tolerances of the single-block kernels; padded rows exactly 0; key ids
    the query ids or another array (bi-causal: 16 bit slots); the same bits
    from run to run."""
    dev = cuda_device
    b, p, h = shape
    dh = 64
    causal, bi = {"bidirectional": (False, 0), "causal": (True, 0), "bi-causal": (False, 16)}[mask]
    rng = np.random.default_rng(13)
    qs = _bf16(rng, (b, p, h * dh), 0.5 * dh**-0.5, dev)
    k, v, do = (_bf16(rng, (b, p, h * dh), 0.5, dev) for _ in range(3))
    seg_np = packed_segments(b, p, rng)
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


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["gelu", "gelu_pytorch_tanh", "silu"])
@pytest.mark.parametrize("n", [200, 512])
def test_norm_mlp_kernel_matches_plain(cuda_device, act, n):
    dev = cuda_device
    rng = np.random.default_rng(7)
    d, f = 128, 512
    x = _bf16(rng, (n, d), 1.0, dev)
    wn = torch.from_numpy((1 + 0.1 * rng.normal(size=d)).astype(np.float32)).to(dev)
    wg, wu = _bf16(rng, (f, d), 0.05, dev), _bf16(rng, (f, d), 0.05, dev)
    wd = _bf16(rng, (d, f), 0.05, dev)
    before = tmlp.norm_mlp.launches
    out = tmlp.norm_mlp(x, wn, wg, wu, wd, 1e-6, act)
    torch.cuda.synchronize()
    assert tmlp.norm_mlp.launches == before + 1
    with ops.reference_mode():
        ref = tmlp.norm_mlp(x, wn, wg, wu, wd, 1e-6, act)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2, rtol=1e-2)


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
@pytest.mark.parametrize("shape", [(200, 128, 512), (512, 128, 512), (18432, 768, 3072)],
                         ids=["ragged", "small", "finetune"])
def test_mlp_kernel_matches_plain(cuda_device, act, shape):
    """Kernel #11 against its plain version in bf16: the same rounding
    points, fp32 sums in another order (1 ulp of the output). The weights
    are drawn at about 0.55 / sqrt(D) (0.02 at D 768, the model's init), so
    that the outputs have the model's magnitude."""
    dev = cuda_device
    n, d, f = shape
    rng = np.random.default_rng(12)
    scale = 0.55 / d**0.5
    x = _bf16(rng, (n, d), 1.0, dev)
    wg, wu = _bf16(rng, (f, d), scale, dev), _bf16(rng, (f, d), scale, dev)
    wd = _bf16(rng, (d, f), scale, dev)
    before = tmlp.mlp.launches
    out = tmlp.mlp(x, wg, wu, wd, act)
    torch.cuda.synchronize()
    assert tmlp.mlp.launches == before + 1
    with ops.reference_mode():
        ref = tmlp.mlp(x, wg, wu, wd, act)
    assert tmlp.mlp.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2, rtol=1e-2)
    assert _rel(out, ref) < 2e-3


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


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 128, 3), (2, 200, 3), (8, 1024, 12), (24, 1024, 12)],
                         ids=["small", "ragged", "flagship", "flagship-24-rows"])
def test_flash_bwd_kernel_matches_plain(cuda_device, causal, shape):
    """dq, dk, dv in bf16: the kernel rounds p and ds where the plain version
    does and sums in another order (2 ulps of the largest values, and 2e-3 in
    the relative Frobenius norm); padded rows exactly 0. A non-zero dlse on
    the valid rows goes through the delta term."""
    dev = cuda_device
    b, p, h = shape
    dh = 64
    rng = np.random.default_rng(6)
    qs = _bf16(rng, (b, p, h * dh), 0.5 * dh**-0.5, dev)
    k, v, do = (_bf16(rng, (b, p, h * dh), 0.5, dev) for _ in range(3))
    seg = packed_segments(b, p, rng)
    seg[-1, p - 30 :] = 0
    seg = torch.from_numpy(seg).to(dev)
    cos, sin = (t.to(torch.bfloat16) for t in rope_cos_sin(torch.arange(p, device=dev).expand(b, p), dh))
    out, lse = tfa.flash_fwd(qs, k, v, seg, cos, sin, causal, dh)
    dlse = torch.from_numpy(rng.normal(size=(b, h, p)).astype(np.float32) * 0.3).to(dev)
    dlse = dlse * (seg > 0)[:, None, :]
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
            assert bool((g[-1, p - 30 :] == 0).all())


def _denoise_row_segments(b, p, bi, rng):
    """Rows laid out as the denoise batch lays them out: a molecule at the
    front, padding, then `bi` bit slots in the molecule's segment."""
    seg = np.zeros((b, p), np.int32)
    for r in range(b):
        seg[r, : int(rng.integers(10, p - bi))] = 1
        seg[r, p - bi :] = 1
    return seg


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 88, 12), (2, 1024, 12), (2, 128, 3)],
                         ids=["denoise", "P1024", "split-on-edge"])
def test_split_backward_kernels_match_plain(cuda_device, shape):
    """flash_dq (with its delta, a cotangent of lse folded in), flash_dkv
    and the bi-causal flash_fwd against their plain versions (16 bit slots;
    64 on the last shape, a split on a tile edge), at the tolerances of the
    fused kernels; padded rows exactly 0. The
    backward wrapper launches each split kernel once and the fused one not
    at all."""
    dev = cuda_device
    b, p, h = shape
    dh, bi = 64, (64 if p == 128 else 16)
    rng = np.random.default_rng(11)
    qs = _bf16(rng, (b, p, h * dh), 0.5 * dh**-0.5, dev)
    k, v, do = (_bf16(rng, (b, p, h * dh), 0.5, dev) for _ in range(3))
    seg_np = _denoise_row_segments(b, p, bi, rng) if p != 1024 else packed_segments(b, p, rng)
    seg = torch.from_numpy(seg_np).to(dev)
    pos = torch.arange(p, device=dev).expand(b, p)
    cos, sin = (t.to(torch.bfloat16) for t in rope_cos_sin(pos, dh))
    out, lse = tfa.flash_fwd(qs, k, v, seg, cos, sin, False, dh, bi)
    torch.cuda.synchronize()
    with ops.reference_mode():
        rout, rlse = tfa.flash_fwd(qs, k, v, seg, cos, sin, False, dh, bi)
    valid = seg > 0
    torch.testing.assert_close(out.float(), rout.float(), atol=3e-2, rtol=2e-2)
    assert _rel(out[valid], rout[valid]) < 4e-3
    torch.testing.assert_close(lse.transpose(1, 2)[valid], rlse.transpose(1, 2)[valid],
                               atol=1e-3, rtol=1e-4)
    assert bool((out[~valid] == 0).all())
    dlse = torch.from_numpy(rng.normal(size=(b, h, p)).astype(np.float32) * 0.3).to(dev)
    dlse = dlse * valid[:, None, :]  # padded rows take no part in the backward
    dq_args = (qs, k, v, seg, cos, sin, out, lse, do, dlse, False, dh, bi)
    dq, delta = tfa.flash_dq(*dq_args)
    args = (qs, k, v, seg, cos, sin, lse, delta, do, False, dh, bi)
    dk, dv = tfa.flash_dkv(*args)
    torch.cuda.synchronize()
    with ops.reference_mode():
        rdq, rdelta = tfa.flash_dq(*dq_args)
        rdk, rdv = tfa.flash_dkv(*args)
    # the delta kernel sums 64 bf16 products in fp32 in another order
    torch.testing.assert_close(delta, rdelta, atol=1e-5, rtol=1e-5)
    for g, r in zip((dq, dk, dv), (rdq, rdk, rdv)):
        torch.testing.assert_close(g.float(), r.float(), atol=3.2e-2, rtol=2e-2)
        assert _rel(g, r) < 2e-3
        assert bool((g[~valid] == 0).all())
    before = (tfa.flash_dq.launches, tfa.flash_dkv.launches, tfa.flash_bwd.launches)
    got = tfa.flash_bwd(qs, k, v, seg, cos, sin, out, lse, do, dlse, False, dh, bi)
    torch.cuda.synchronize()
    assert (tfa.flash_dq.launches, tfa.flash_dkv.launches, tfa.flash_bwd.launches) == (
        before[0] + 1, before[1] + 1, before[2])
    for g, r in zip(got, (dq, dk, dv)):
        assert torch.equal(g, r)  # no atomics: the same bits every run


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
