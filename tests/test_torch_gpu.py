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
from graphgpt_torch.config import ModelConfig
from graphgpt_torch.models.heads import GraphGPTPretrain
from graphgpt_torch.models.rope import rope_cos_sin
from graphgpt_torch.ops import flash_attention as tfa
from graphgpt_torch.ops import mlp as tmlp
from graphgpt_torch.synthetic import fake_batch, packed_segments, to_torch


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
    dev = cuda_device
    x = torch.zeros(1, 64, 2, 64, device=dev, dtype=torch.bfloat16)
    seg = torch.ones(1, 64, dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError):
        tfa.flash_attention(x, x, x, seg, bi_causal_split=8)
    with pytest.raises(NotImplementedError):
        tfa.flash_attention(x.float(), x.float(), x.float(), seg)
    big = torch.zeros(1, 2112, 1, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        tfa.flash_attention(big, big, big, torch.ones(1, 2112, dtype=torch.int32, device=dev))
    with pytest.raises(NotImplementedError):
        tfa.flash_attention(x.clone().requires_grad_(), x, x, seg)


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
    return ModelConfig(
        vocab_size=50, hidden_size=128, num_hidden_layers=2, stacked_feat=3,
        next_n_token=3, mask_token_id=1, **kw,
    ).finalize()


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
def test_layer_scale_model_raises_on_cuda(cuda_device):
    model = GraphGPTPretrain(_tiny_cfg(layer_scale_init_value=0.1), device=cuda_device)
    batch = to_torch(fake_batch(1, 64, 3, 50, np.random.default_rng(1)), cuda_device)
    with pytest.raises(NotImplementedError, match="LayerScale"):
        model.loss(batch)
