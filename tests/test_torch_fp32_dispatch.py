"""How the kernel wrappers hand fp32 tensors to the fp32 forms of #1, #2, #3
and #13, on the CPU.

The card is stood in for: `use_kernel` says yes, and `_build.entry`,
`_build.ptr` and `_build.stream_ptr` record which C entry was asked for and
which tensors it was given, launching nothing. Each wrapper must send fp32
to its `_f32` entry (counting a launch of the fp32 form, none of the bf16
one) with fp32 RoPE tables equal to the caller's (a bf16 rounding costs
~1e-3, far past the fp32 forms' 2e-5), bf16 to the entry it always took,
and refuse any other dtype, and a mix, before it launches. The numbers
themselves are held on the card (`tests/test_torch_gpu.py`, the fp32 tests
at its end, and `chip_smoke.py`'s phase L).
"""

import ctypes

import numpy as np
import pytest
import torch

from graphgpt_torch.models.rope import rope_cos_sin
from graphgpt_torch.ops import _build
from graphgpt_torch.ops import flash_attention as tfa
from graphgpt_torch.ops import mlp as tmlp


class FakeCard:
    """The entries asked for, with the tensors each call handed over."""

    def __init__(self, monkeypatch):
        self.calls = []
        self._args = []
        for mod in (tfa, tmlp):
            monkeypatch.setattr(mod, "use_kernel", lambda *t: True)
        monkeypatch.setattr(tmlp, "_sm_count", lambda device: 132)

        def entry(source, symbol, argtypes):
            def fn(*args):
                self.calls.append((source, symbol, list(self._args)))
                self._args.clear()
                return 0

            return fn

        def ptr(t):
            self._args.append(t)
            return ctypes.c_void_p(0)

        monkeypatch.setattr(_build, "entry", entry)
        monkeypatch.setattr(_build, "ptr", ptr)
        monkeypatch.setattr(_build, "stream_ptr", lambda device: ctypes.c_void_p(0))


def _flash(dtype, b=2, p=128, h=2, dh=64, seed=0):
    rng = np.random.default_rng(seed)
    qs, k, v, do = (torch.from_numpy((rng.normal(size=(b, p, h * dh)) * 0.5).astype(np.float32))
                    .to(dtype) for _ in range(4))
    seg = torch.ones(b, p, dtype=torch.int32)
    cos, sin = rope_cos_sin(torch.arange(p).expand(b, p), dh)
    return qs, k, v, do, seg, cos, sin


@pytest.mark.parametrize("dtype,symbol", [(torch.float32, "ggt_flash_fwd_f32"),
                                          (torch.bfloat16, "ggt_flash_fwd")], ids=["fp32", "bf16"])
def test_flash_fwd_sends_each_dtype_to_its_entry(monkeypatch, dtype, symbol):
    card = FakeCard(monkeypatch)
    qs, k, v, _, seg, cos, sin = _flash(dtype)
    before = (tfa.flash_fwd.launches, tfa.flash_fwd_f32.launches)
    out, lse = tfa.flash_fwd(qs, k, v, seg, cos, sin, False, 64)
    (source, got, tensors), = card.calls
    assert got == symbol and source == symbol[4:]
    assert out.dtype == dtype and lse.dtype == torch.float32
    fp32 = dtype == torch.float32
    assert (tfa.flash_fwd.launches - before[0], tfa.flash_fwd_f32.launches - before[1]) == (
        (0, 1) if fp32 else (1, 0))
    gcos, gsin = tensors[4], tensors[5]  # q, k, v, seg, cos, sin, out, lse
    assert gcos.dtype == gsin.dtype == dtype
    if fp32:
        assert torch.equal(gcos, cos) and torch.equal(gsin, sin)


@pytest.mark.parametrize("dtype,symbol", [(torch.float32, "ggt_flash_bwd_f32"),
                                          (torch.bfloat16, "ggt_flash_bwd")], ids=["fp32", "bf16"])
def test_flash_bwd_sends_each_dtype_to_its_entry(monkeypatch, dtype, symbol):
    card = FakeCard(monkeypatch)
    qs, k, v, do, seg, cos, sin = _flash(dtype)
    lse = torch.zeros(2, 2, 128)
    before = (tfa.flash_bwd.launches, tfa.flash_bwd_f32.launches)
    dq, dk, dv = tfa.flash_bwd(qs, k, v, seg, cos, sin, qs, lse, do, None, False, 64)
    (_, got, tensors), = card.calls
    assert got == symbol and dq.dtype == dk.dtype == dv.dtype == dtype
    fp32 = dtype == torch.float32
    assert (tfa.flash_bwd.launches - before[0], tfa.flash_bwd_f32.launches - before[1]) == (
        (0, 1) if fp32 else (1, 0))
    if fp32:
        assert torch.equal(tensors[4], cos) and torch.equal(tensors[5], sin)


def test_the_model_path_keeps_fp32_rope_tables(monkeypatch):
    """flash_attention on fp32 q, k, v (a float32 model's attention) reaches
    #1's fp32 entry with the RoPE tables as computed, unrounded."""
    card = FakeCard(monkeypatch)
    qs, k, v, _, seg, cos, sin = _flash(torch.float32)
    q4, k4, v4 = (t.view(2, 128, 2, 64) for t in (qs, k, v))
    tfa.flash_attention(q4, k4, v4, seg, rope=(cos, sin))
    (_, got, tensors), = card.calls
    assert got == "ggt_flash_fwd_f32"
    assert torch.equal(tensors[4], cos) and torch.equal(tensors[5], sin)


def test_the_flash_wrappers_refuse_other_dtypes(monkeypatch):
    card = FakeCard(monkeypatch)
    qs, k, v, do, seg, cos, sin = _flash(torch.float16)
    with pytest.raises(NotImplementedError):
        tfa.flash_fwd(qs, k, v, seg, cos, sin, False, 64)
    with pytest.raises(NotImplementedError):
        tfa.flash_bwd(qs, k, v, seg, cos, sin, qs, torch.zeros(2, 2, 128), do, None, False, 64)
    with pytest.raises(NotImplementedError):  # fp32 q beside bf16 k and v
        tfa.flash_fwd(qs.float(), k.bfloat16(), v.bfloat16(), seg, cos, sin, False, 64)
    with pytest.raises(NotImplementedError):  # the split pair has no fp32 form yet
        tfa.flash_bwd(qs.float(), k.float(), v.float(), seg, cos, sin, qs.float(),
                      torch.zeros(2, 2, 128), do.float(), None, False, 64, 16)
    assert card.calls == []


def _mlp(dtype, n=200, d=128, f=512):
    rng = np.random.default_rng(1)

    def t(*shape):
        return torch.from_numpy((rng.normal(size=shape) * 0.05).astype(np.float32)).to(dtype)

    return t(n, d), torch.ones(d), t(f, d), t(f, d), t(d, f)


@pytest.mark.parametrize("dtype,symbol", [(torch.float32, "ggt_norm_mlp_f32"),
                                          (torch.bfloat16, "ggt_norm_mlp")], ids=["fp32", "bf16"])
def test_norm_mlp_sends_each_dtype_to_its_entry(monkeypatch, dtype, symbol):
    card = FakeCard(monkeypatch)
    x, wn, wg, wu, wd = _mlp(dtype)
    before = (tmlp.norm_mlp.launches, tmlp.norm_mlp_f32.launches)
    out = tmlp.norm_mlp(x, wn, wg, wu, wd, 1e-6, "gelu")
    (source, got, tensors), = card.calls
    assert got == symbol and source == symbol[4:] and out.dtype == dtype
    assert tensors[5].dtype == dtype and tensors[5].shape == (200, 512)  # the g scratch
    fp32 = dtype == torch.float32
    assert (tmlp.norm_mlp.launches - before[0], tmlp.norm_mlp_f32.launches - before[1]) == (
        (0, 1) if fp32 else (1, 0))


def test_the_mlp_wrappers_refuse_other_dtypes(monkeypatch):
    card = FakeCard(monkeypatch)
    x, wn, wg, wu, wd = _mlp(torch.float16)
    with pytest.raises(NotImplementedError):
        tmlp.norm_mlp(x, wn, wg, wu, wd, 1e-6, "gelu")
    with pytest.raises(NotImplementedError):  # fp32 x beside bf16 weights
        tmlp.norm_mlp(x.float(), wn, wg.bfloat16(), wu.bfloat16(), wd.bfloat16(), 1e-6, "gelu")
    with pytest.raises(NotImplementedError):  # #11 has no fp32 form yet
        tmlp.mlp(x.float(), wg.float(), wu.float(), wd.float(), "gelu")
    with pytest.raises(NotImplementedError):
        tmlp.rmsnorm_bwd(x, x, wn, 1e-6)
    with pytest.raises(NotImplementedError):  # fp32 x beside a bf16 cotangent
        tmlp.rmsnorm_bwd(x.float(), x.bfloat16(), wn, 1e-6)
    assert card.calls == []


@pytest.mark.parametrize("dtype,symbol", [(torch.float32, "ggt_rmsnorm_bwd_f32"),
                                          (torch.bfloat16, "ggt_rmsnorm_bwd")], ids=["fp32", "bf16"])
@pytest.mark.parametrize("d", [128, 768, 1600])
def test_rmsnorm_bwd_sends_each_dtype_to_its_entry(monkeypatch, dtype, symbol, d):
    """Both dtypes take the one templated source, at every hidden size the
    configs name (D 128 is toy_pretrain's)."""
    card = FakeCard(monkeypatch)
    x, _, _, _, _ = _mlp(dtype, n=64, d=d, f=64)
    before = (tmlp.rmsnorm_bwd.launches, tmlp.rmsnorm_bwd_f32.launches)
    dx, dw = tmlp.rmsnorm_bwd(x, x, torch.ones(d), 1e-6)
    (source, got, _), = card.calls
    assert (source, got) == ("rmsnorm_bwd", symbol)
    assert dx.dtype == dtype and dw.dtype == torch.float32
    fp32 = dtype == torch.float32
    assert (tmlp.rmsnorm_bwd.launches - before[0], tmlp.rmsnorm_bwd_f32.launches - before[1]) == (
        (0, 1) if fp32 else (1, 0))
