"""Norm-fused gated MLP: CUDA kernel and plain versions.

Counterpart of `graphgpt_tpu/ops/mlp.py` (`_norm_mlp_kernel` :203,
`fused_norm_mlp` :253, `xla_mlp` :468). The kernel lives in
`csrc/norm_mlp.cu`. Weights are in nn.Linear layout (`[out, in]`): the
JAX package's `[in, out]` matrices transposed.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build, use_kernel

_ACT_IDS = {"gelu": 0, "gelu_new": 1, "gelu_pytorch_tanh": 1, "silu": 2}
# x, wn, wg, wu, wd, g, out; N, D, F; eps; act; stream
_ARGTYPES = (
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
)


def act_fn(name: str):
    """The activation in fp32: exact (erf) gelu, tanh gelu or silu."""
    if name == "gelu":
        return F.gelu
    if name in ("gelu_new", "gelu_pytorch_tanh"):
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "silu":
        return F.silu
    raise ValueError(f"unsupported hidden_act {name!r}")


def mlp_ref(x, wg, wu, wd, act: str):
    """act(x @ wg^T) * (x @ wu^T) @ wd^T in x's dtype (the twin of
    `xla_mlp`; the activation runs in fp32 and is rounded back)."""
    dt = x.dtype
    a = act_fn(act)(F.linear(x, wg.to(dt)).float()).to(dt)
    return F.linear(a * F.linear(x, wu.to(dt)), wd.to(dt))


def norm_mlp_ref(x, wn, wg, wu, wd, eps: float, act: str):
    """Plain version of the kernel, with its rounding points: hpre, xg, xu,
    a and g rounded to x's dtype; products accumulated in fp32; the residual
    added in fp32 and the result rounded once."""
    dt = x.dtype
    x32 = x.float()
    rrms = torch.rsqrt(x32.pow(2).mean(dim=-1, keepdim=True) + eps)
    hpre = (x32 * rrms * wn.float()).to(dt)
    xg = F.linear(hpre.float(), wg.float()).to(dt)
    xu = F.linear(hpre.float(), wu.float()).to(dt)
    a = act_fn(act)(xg.float()).to(dt)
    g = a * xu
    return (x32 + F.linear(g.float(), wd.float())).to(dt)


def norm_mlp(x, wn, wg, wu, wd, eps: float, act: str):
    """x + mlp(rms(x) * wn) for x [N, D] in bf16 and bf16 weights: the CUDA
    kernel (two launches, counted as one call) for a CUDA tensor, the plain
    version for a CPU tensor (or inside ops.reference_mode())."""
    if not use_kernel(x, wn, wg, wu, wd):
        return norm_mlp_ref(x, wn, wg, wu, wd, eps, act)
    n, d = x.shape
    f = wg.shape[0]
    if x.dtype != torch.bfloat16 or any(w.dtype != torch.bfloat16 for w in (wg, wu, wd)):
        raise NotImplementedError("the norm_mlp kernel takes bf16 activations and weights")
    if wg.shape != (f, d) or wu.shape != (f, d) or wd.shape != (d, f) or wn.shape != (d,):
        raise ValueError(f"weight shapes {wg.shape} {wu.shape} {wd.shape} {wn.shape}")
    if d % 64 or f % 64:
        raise NotImplementedError(f"the norm_mlp kernel needs D and F % 64 == 0, got {d}, {f}")
    if act not in _ACT_IDS:
        raise ValueError(f"unsupported hidden_act {act!r}")
    x, wg, wu, wd = (t.contiguous() for t in (x, wg, wu, wd))
    wn = wn.float().contiguous()
    # the kernel moves 16 bytes a thread
    if any(t.data_ptr() % 16 for t in (x, wg, wu, wd)):
        raise ValueError("norm_mlp needs 16-byte aligned x and weights")
    g = torch.empty((n, f), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    fn = _build.entry("norm_mlp", "ggt_norm_mlp", _ARGTYPES)
    err = fn(
        _build.ptr(x), _build.ptr(wn), _build.ptr(wg), _build.ptr(wu), _build.ptr(wd),
        _build.ptr(g), _build.ptr(out), n, d, f, float(eps), _ACT_IDS[act],
        _build.stream_ptr(x.device),
    )
    norm_mlp.launches += 1
    _build.check(err, "norm_mlp")
    return out


norm_mlp.launches = 0


def fused_norm_mlp(x, wn, wg, wu, wd, eps: float, act: str):
    """x + mlp(rms(x) * wn): fp32 master weights cast to x's dtype once per
    call, then `norm_mlp`."""
    dt = x.dtype
    return norm_mlp(x, wn.float(), wg.to(dt), wu.to(dt), wd.to(dt), eps, act)
