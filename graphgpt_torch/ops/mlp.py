"""Gated MLPs (CUDA kernels, plain versions, plain backwards) and the
RMSNorm backward (CUDA kernel and plain version).

Counterpart of `graphgpt_tpu/ops/mlp.py` (`_mlp_kernel` :82, `fused_mlp`
:158 with `_fused_mlp_bwd` :170, `_norm_mlp_kernel` :203, `fused_norm_mlp`
:253 with `_fused_norm_mlp_bwd` :267, `_rmsnorm_bwd_kernel` :414, `xla_mlp`
:468). The kernels live in `csrc/mlp.cu`, `csrc/norm_mlp.cu` and
`csrc/rmsnorm_bwd.cu`. Weights are in nn.Linear layout (`[out, in]`): the
JAX package's `[in, out]` matrices transposed.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build, mm_f32, use_kernel

_ACT_IDS = {"gelu": 0, "gelu_new": 1, "gelu_pytorch_tanh": 1, "silu": 2}
# x, wg, wu, wd, g, out; N, D, F; act; stream
_MLP_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
# x, wn, wg, wu, wd, g, out; N, D, F; eps; act; stream
_ARGTYPES = (
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
)
# x, g, w, dx, dw, partial; N, D; eps; blocks; stream
_RMS_ARGTYPES = (
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
)
_RMS_MAX_BLOCKS = 1056  # 8 blocks of 8 warps for each of the H100's 132 SMs
# 16-byte chunks a lane holds, ceil(D / 256): the kernel is built for the
# hidden sizes of config._MODEL_SIZES (128 to 1600)
_RMS_CHUNKS = (1, 2, 3, 4, 5, 7)


def act_fn(name: str):
    """The activation in fp32: exact (erf) gelu, tanh gelu or silu."""
    if name == "gelu":
        return F.gelu
    if name in ("gelu_new", "gelu_pytorch_tanh"):
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "silu":
        return F.silu
    raise ValueError(f"unsupported hidden_act {name!r}")


def act_grad_fn(name: str):
    """The activation's derivative in fp32 (`_act_and_grad_f32`)."""
    if name == "gelu":
        return lambda x: 0.5 * (1.0 + torch.erf(x * 0.7071067811865476)) + (
            x * 0.3989422804014327 * torch.exp(-0.5 * x * x)
        )
    if name in ("gelu_new", "gelu_pytorch_tanh"):

        def grad(x):
            k = 0.7978845608028654  # sqrt(2/pi)
            t = torch.tanh(k * (x + 0.044715 * x * x * x))
            return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * k * (1.0 + 0.134145 * x * x)

        return grad
    if name == "silu":

        def grad(x):
            sg = torch.sigmoid(x)
            return sg * (1.0 + x * (1.0 - sg))

        return grad
    raise ValueError(f"unsupported hidden_act {name!r}")


def xla_mlp(x, wg, wu, wd, act: str):
    """act(x @ wg^T) * (x @ wu^T) @ wd^T in x's dtype: the JAX package's
    plain path (`xla_mlp`), which the backbone takes under MLP dropout; the
    activation runs in fp32 and is rounded back. Differentiable by autograd."""
    dt = x.dtype
    a = act_fn(act)(F.linear(x, wg.to(dt)).float()).to(dt)
    return F.linear(a * F.linear(x, wu.to(dt)), wd.to(dt))


def mlp_kernel_ref(x, wg, wu, wd, act: str):
    """Plain version of the mlp kernel, with its rounding points: xg and xu
    rounded to x's dtype, the activation in fp32 and rounded, g = a * xu in
    x's dtype, the down product summed in fp32 and rounded once."""
    dt = x.dtype
    x32 = x.float()
    xg = F.linear(x32, wg.float()).to(dt)
    xu = F.linear(x32, wu.float()).to(dt)
    a = act_fn(act)(xg.float()).to(dt)
    g = a * xu
    return F.linear(g.float(), wd.float()).to(dt)


def _check_mlp_args(name, x, wg, wu, wd, act):
    n, d = x.shape
    f = wg.shape[0]
    if x.dtype != torch.bfloat16 or any(w.dtype != torch.bfloat16 for w in (wg, wu, wd)):
        raise NotImplementedError(f"the {name} kernel takes bf16 activations and weights")
    if wg.shape != (f, d) or wu.shape != (f, d) or wd.shape != (d, f):
        raise ValueError(f"weight shapes {wg.shape} {wu.shape} {wd.shape}")
    if d % 64 or f % 64:
        raise NotImplementedError(f"the {name} kernel needs D and F % 64 == 0, got {d}, {f}")
    if act not in _ACT_IDS:
        raise ValueError(f"unsupported hidden_act {act!r}")


def mlp(x, wg, wu, wd, act: str):
    """act(x @ wg^T) * (x @ wu^T) @ wd^T for x [N, D] in bf16 and bf16
    weights: the CUDA kernel (two launches, counted as one call) for a CUDA
    tensor, the plain version for a CPU tensor (or inside
    ops.reference_mode())."""
    if not use_kernel(x, wg, wu, wd):
        return mlp_kernel_ref(x, wg, wu, wd, act)
    _check_mlp_args("mlp", x, wg, wu, wd, act)
    n, d = x.shape
    f = wg.shape[0]
    x, wg, wu, wd = (t.contiguous() for t in (x, wg, wu, wd))
    # the kernel moves 16 bytes a thread
    if any(t.data_ptr() % 16 for t in (x, wg, wu, wd)):
        raise ValueError("mlp needs 16-byte aligned x and weights")
    g = torch.empty((n, f), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    fn = _build.entry("mlp", "ggt_mlp", _MLP_ARGTYPES)
    err = fn(
        _build.ptr(x), _build.ptr(wg), _build.ptr(wu), _build.ptr(wd), _build.ptr(g),
        _build.ptr(out), n, d, f, _ACT_IDS[act], _build.stream_ptr(x.device),
    )
    mlp.launches += 1
    _build.check(err, "mlp")
    return out


mlp.launches = 0


def mlp_bwd_ref(x, wg, wu, wd, dout, act: str):
    """(dx, dwg, dwu, dwd) of `fused_mlp`, the formula of `_fused_mlp_bwd` in
    plain ops: xg, xu, a, g computed again from x (rounded to x's dtype),
    dg and dxg rounded, the three weight gradients summed in fp32. The
    matrix products are `torch.matmul`, as the JAX package leaves them to
    XLA."""
    dt = x.dtype
    wg_c, wu_c, wd_c = wg.to(dt), wu.to(dt), wd.to(dt)
    xg = F.linear(x, wg_c)
    xu = F.linear(x, wu_c)
    a = act_fn(act)(xg.float()).to(dt)
    g = a * xu
    do = dout.to(dt)
    dg = do @ wd_c
    dwd = mm_f32(do.t(), g)
    dxu = dg * a
    dxg = ((dg * xu).float() * act_grad_fn(act)(xg.float())).to(dt)
    dwg = mm_f32(dxg.t(), x)
    dwu = mm_f32(dxu.t(), x)
    dx = dxg @ wg_c + dxu @ wu_c
    return dx, dwg.to(wg.dtype), dwu.to(wu.dtype), dwd.to(wd.dtype)


class _FusedMLP(torch.autograd.Function):
    """The mlp kernel forward; backward `mlp_bwd_ref`. Saves (x, wg, wu, wd)
    only: the backward recomputes the intermediates."""

    @staticmethod
    def forward(ctx, x, wg, wu, wd, act):
        dt = x.dtype
        ctx.save_for_backward(x, wg, wu, wd)
        ctx.act = act
        return mlp(x, wg.to(dt), wu.to(dt), wd.to(dt), act)

    @staticmethod
    def backward(ctx, dout):
        return (*mlp_bwd_ref(*ctx.saved_tensors, dout, ctx.act), None)


def fused_mlp(x, wg, wu, wd, act: str):
    """act(x @ wg^T) * (x @ wu^T) @ wd^T: fp32 master weights cast to x's
    dtype once per call, then `mlp`; differentiable in x and every weight."""
    return _FusedMLP.apply(x, wg, wu, wd, act)


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
    _check_mlp_args("norm_mlp", x, wg, wu, wd, act)
    if wn.shape != x.shape[-1:]:
        raise ValueError(f"norm weight shape {wn.shape}")
    n, d = x.shape
    f = wg.shape[0]
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


def norm_mlp_bwd_ref(x, wn, wg, wu, wd, dout, eps: float, act: str):
    """(dx, dwn, dwg, dwu, dwd) of `fused_norm_mlp`, the formula of
    `_fused_norm_mlp_bwd` in plain ops: the forward's intermediates are
    computed again from x (hpre, xg, xu, a, g and dg, dxg rounded to x's
    dtype), the three weight gradients are summed in fp32, and
    dx = dout + dx_norm in fp32, rounded once. The matrix products are
    `torch.matmul`, as the JAX package leaves them to XLA."""
    dt = x.dtype
    wn32 = wn.float()
    wg_c, wu_c, wd_c = wg.to(dt), wu.to(dt), wd.to(dt)
    x32 = x.float()
    rrms = torch.rsqrt(x32.pow(2).mean(dim=-1, keepdim=True) + eps)
    n = x32 * rrms
    hpre = (n * wn32).to(dt)
    xg = F.linear(hpre, wg_c)
    xu = F.linear(hpre, wu_c)
    a = act_fn(act)(xg.float()).to(dt)
    g = a * xu
    do = dout.to(dt)
    dg = do @ wd_c
    dwd = mm_f32(do.t(), g)
    dxu = dg * a
    dxg = ((dg * xu).float() * act_grad_fn(act)(xg.float())).to(dt)
    dwg = mm_f32(dxg.t(), hpre)
    dwu = mm_f32(dxu.t(), hpre)
    dhpre = (dxg @ wg_c + dxu @ wu_c).float()
    dn = dhpre * wn32
    dx_norm = rrms * (dn - n * (dn * n).mean(dim=-1, keepdim=True))
    dwn = (dhpre * n).sum(dim=0)
    dx = (dout.float() + dx_norm).to(dt)
    return dx, dwn.to(wn.dtype), dwg.to(wg.dtype), dwu.to(wu.dtype), dwd.to(wd.dtype)


class _FusedNormMLP(torch.autograd.Function):
    """The norm_mlp kernel forward; backward `norm_mlp_bwd_ref`. Saves
    (x, wn, wg, wu, wd) only: the backward recomputes the intermediates."""

    @staticmethod
    def forward(ctx, x, wn, wg, wu, wd, eps, act):
        dt = x.dtype
        ctx.save_for_backward(x, wn, wg, wu, wd)
        ctx.args = (eps, act)
        return norm_mlp(x, wn.float(), wg.to(dt), wu.to(dt), wd.to(dt), eps, act)

    @staticmethod
    def backward(ctx, dout):
        return (*norm_mlp_bwd_ref(*ctx.saved_tensors, dout, *ctx.args), None, None)


def fused_norm_mlp(x, wn, wg, wu, wd, eps: float, act: str):
    """x + mlp(rms(x) * wn): fp32 master weights cast to x's dtype once per
    call, then `norm_mlp`; differentiable in x and every weight."""
    return _FusedNormMLP.apply(x, wn, wg, wu, wd, eps, act)


def rmsnorm_bwd_ref(x, g, w, eps: float):
    """Plain version of the rmsnorm_bwd kernel: (dx in x's dtype, dw fp32)
    of y = rms(x) * w for the cotangent g, statistics and dx in fp32."""
    x32, g32 = x.float(), g.float()
    rrms = torch.rsqrt(x32.pow(2).mean(dim=-1, keepdim=True) + eps)
    n = x32 * rrms
    dn = g32 * w.float()
    dx = rrms * (dn - n * (dn * n).mean(dim=-1, keepdim=True))
    dw = (g32 * n).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dw


def rmsnorm_bwd(x, g, w, eps: float):
    """(dx, dw) for x, g [N, D] and w [D]: the CUDA kernel (the row pass and
    the small reduction of its per-block dw sums, counted as one call) for a
    CUDA tensor, the plain version for a CPU tensor (or inside
    ops.reference_mode())."""
    if not use_kernel(x, g, w):
        return rmsnorm_bwd_ref(x, g, w, eps)
    if x.dim() != 2 or g.shape != x.shape or w.shape != x.shape[-1:]:
        raise ValueError(f"shapes x {x.shape} g {g.shape} w {w.shape}")
    n, d = x.shape
    if x.dtype != torch.bfloat16 or g.dtype != torch.bfloat16:
        raise NotImplementedError("the rmsnorm_bwd kernel takes bf16 x and g")
    if d % 8 or -(-d // 256) not in _RMS_CHUNKS:
        raise NotImplementedError(
            f"the rmsnorm_bwd kernel needs D % 8 == 0 and ceil(D / 256) in {_RMS_CHUNKS}, got {d}"
        )
    x, g = x.contiguous(), g.contiguous()
    w = w.float().contiguous()
    if x.data_ptr() % 16 or g.data_ptr() % 16:
        raise ValueError("rmsnorm_bwd needs 16-byte aligned x and g")
    blocks = max(1, min((n + 7) // 8, _RMS_MAX_BLOCKS))
    dx = torch.empty_like(x)
    dw = torch.empty((d,), dtype=torch.float32, device=x.device)
    partial = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    fn = _build.entry("rmsnorm_bwd", "ggt_rmsnorm_bwd", _RMS_ARGTYPES)
    err = fn(
        _build.ptr(x), _build.ptr(g), _build.ptr(w), _build.ptr(dx), _build.ptr(dw),
        _build.ptr(partial), n, d, float(eps), blocks, _build.stream_ptr(x.device),
    )
    rmsnorm_bwd.launches += 1
    _build.check(err, "rmsnorm_bwd")
    return dx, dw


rmsnorm_bwd.launches = 0
