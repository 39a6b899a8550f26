"""Gated MLPs (CUDA kernels, plain versions, plain backwards), the
norm-fused q/k/v projections (CUDA kernel, plain version and backward) and
the RMSNorm backward (CUDA kernel and plain version).

Counterpart of `graphgpt_tpu/ops/mlp.py` (`_mlp_kernel` :82, `fused_mlp`
:158 with `_fused_mlp_bwd` :170, `_norm_mlp_kernel` :203, `fused_norm_mlp`
:253 with `_fused_norm_mlp_bwd` :267, `_norm_qkv_kernel` :315,
`fused_norm_qkv` :363 with `_fused_norm_qkv_bwd` :376, `_rmsnorm_bwd_kernel`
:414, `xla_mlp` :468). The kernels live in `csrc/mlp.cu`,
`csrc/norm_mlp.cu`, `csrc/norm_qkv.cu` and `csrc/rmsnorm_bwd.cu`, the fp32
forms of #2, #11 and #12 in `csrc/mlp_qkv_f32.cu`. Weights are in
nn.Linear layout (`[out, in]`): the JAX package's `[in, out]` matrices
transposed.

Dtypes: every kernel takes bf16, and fp32 (a `model.dtype: float32`
model): #2, #11 and #12 on one 3xTF32 tensor-core body,
`csrc/mlp_qkv_f32.cu` (wrappers and counts norm_mlp_f32, mlp_f32,
norm_qkv_f32), #13 in the fp32 instances of its templated source
(rmsnorm_bwd_f32); norm_mlp, mlp, norm_qkv and rmsnorm_bwd hand them fp32
CUDA tensors. Every kernel raises on any other dtype or on a mix.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build, mm_f32, use_kernel

_ACT_IDS = {"gelu": 0, "gelu_new": 1, "gelu_pytorch_tanh": 1, "silu": 2}
# x, wg, wu, wd, g, out; N, D, F, bh, bn; act; stream
_MLP_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
# x, wn, wg, wu, wd, g, out, rrms; N, D, F, bh, bn; eps; act; stream
_ARGTYPES = (
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
)
# #2's fp32 form: x, wn, wg, wu, wd, planes, g, out, rrms; N, D, F, bn; eps; act; stream
_F32_ARGTYPES = (
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
)
# #11's fp32 form: x, wg, wu, wd, planes, g, out; N, D, F, bn, act; stream
_MLP_F32_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# the stage entries (ggt_mlp_stages, ggt_norm_mlp_stages): a stage mask before the stream
_MLP_STAGE_ARGTYPES = _MLP_ARGTYPES[:-1] + [ctypes.c_int, ctypes.c_void_p]
_STAGE_ARGTYPES = _ARGTYPES[:-1] + [ctypes.c_int, ctypes.c_void_p]
_F32_STAGE_ARGTYPES = _F32_ARGTYPES[:-1] + [ctypes.c_int, ctypes.c_void_p]
# the stage mask's bits (MLP_SPLIT: the fp32 form's weight-split pass)
MLP_RRMS, MLP_GATE_UP, MLP_DOWN, MLP_SPLIT = 1, 2, 4, 8
_MLP_MAX_D = 8192  # norm_mlp: wn's row sits in the gate/up kernel's shared memory
_MLP_BLOCK_HS = (128, 64)  # gate/up tile widths: BH gate and BH up columns of 128 rows
_MLP_BLOCK_NS = (256, 192, 128, 64)  # down tile widths
# What a tile costs beside its width, in columns: the A tile that every
# tile of a row tile loads again (and, with the norm, normalises again), and
# the epilogue. The down stage's 16 ranks BN 256, 192, 128 and 64 as the
# stage alone read at N 8,192, 18,432, 22,528 and 65,536 (D 768) on an H100
_MLP_TILE_EXTRA = {"gate_up": 64, "down": 16}
# x, wn, wq, wk, wv, q, k, v, rrms; N, D, Fq, Fk, Fv, bn; eps; stream
_QKV_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
# #12's fp32 form: x, wn, wq, wk, wv, planes, q, k, v, rrms; N, D, Fq, Fk, Fv, bn; eps; stream
_QKV_F32_ARGTYPES = (
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
)
_QKV_MAX_D = 4096  # wn's row sits in the kernel's shared memory beside its stages (also #2f)
_QKV_BLOCK_NS = (256, 128, 64)  # the kernel's output tile widths
_F32_BLOCK_NS = (128, 64)  # the 3xTF32 body's (#11f's down stage, #12f) output tile widths
# x, g, w, dx, dw, partial; N, D; eps; blocks; stream
_RMS_ARGTYPES = (
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
)
# the stage entry (ggt_rmsnorm_bwd_stages): a stage mask before the stream
_RMS_STAGE_ARGTYPES = _RMS_ARGTYPES[:-1] + [ctypes.c_int, ctypes.c_void_p]
RMS_MAIN, RMS_REDUCE = 1, 2  # the stage mask's bits: the row pass, the sum of its scratch
_RMS_WARPS = 8  # warps of a CTA of the row pass, a row each at a time
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


def _check_mlp_args(name, x, wg, wu, wd, act, dtype=torch.bfloat16):
    n, d = x.shape
    f = wg.shape[0]
    if x.dtype != dtype or any(w.dtype != dtype for w in (wg, wu, wd)):
        raise NotImplementedError(f"the {name} kernel takes {dtype} activations and weights, "
                                  f"got {x.dtype}")
    if wg.shape != (f, d) or wu.shape != (f, d) or wd.shape != (d, f):
        raise ValueError(f"weight shapes {wg.shape} {wu.shape} {wd.shape}")
    if d % 64 or f % 64:
        raise NotImplementedError(f"the {name} kernel needs D and F % 64 == 0, got {d}, {f}")
    if act not in _ACT_IDS:
        raise ValueError(f"unsupported hidden_act {act!r}")


def mlp_tiles(n: int, d: int, f: int, sms: int):
    """(bh, bn): the tile widths of the MLP kernels' gate/up and down stages
    for N rows, D, F and the card's SM count. Each stage's tiles are 128
    rows by a width that divides its output's (F for gate/up, D for down);
    a persistent CTA an SM walks them, so the busiest SM runs
    ceil(tiles / sms) tiles. Of the widths that divide, the one whose
    busiest SM does the least work (its tiles times the width plus
    _MLP_TILE_EXTRA) wins, the wider on a tie. 0 where none divides."""
    rows = -(-n // 128)

    def pick(widths, total, extra):
        fits = [w for w in widths if total % w == 0]
        if not fits:
            return 0
        return min(fits, key=lambda w: (-(-rows * (total // w) // sms) * (w + extra), -w))

    return (pick(_MLP_BLOCK_HS, f, _MLP_TILE_EXTRA["gate_up"]),
            pick(_MLP_BLOCK_NS, d, _MLP_TILE_EXTRA["down"]))


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def rms_blocks(n: int, d: int, sms: int) -> int:
    """The grid of rmsnorm_bwd's row pass, and the rows of its dw scratch:
    one CTA for each 8 rows, at most two an SM (one above 3 chunks a lane,
    D > 768, where a CTA's registers fill the SM)."""
    per_sm = 2 if -(-d // 256) <= 3 else 1
    return max(1, min(-(-n // _RMS_WARPS), per_sm * sms))


def _mlp_args(name, x, wg, wu, wd, act, dtype):
    """The checks and layouts both forms of the mlp kernel need: (x, wg, wu,
    wd) contiguous. Raises on what they do not take."""
    _check_mlp_args(name, x, wg, wu, wd, act, dtype)
    x, wg, wu, wd = (t.contiguous() for t in (x, wg, wu, wd))
    # the kernels read x and the weights 16 bytes at a time (TMA in bf16)
    if any(t.data_ptr() % 16 for t in (x, wg, wu, wd)):
        raise ValueError(f"{name} needs 16-byte aligned x and weights")
    return x, wg, wu, wd


def mlp(x, wg, wu, wd, act: str):
    """act(x @ wg^T) * (x @ wu^T) @ wd^T for x [N, D] in bf16 and bf16
    weights: the CUDA kernel (two launches, counted as one call) for a CUDA
    tensor, its fp32 form (mlp_f32) for fp32 ones, the plain version for a
    CPU tensor (or inside ops.reference_mode())."""
    if not use_kernel(x, wg, wu, wd):
        return mlp_kernel_ref(x, wg, wu, wd, act)
    if x.dtype == torch.float32:
        return mlp_f32(x, wg, wu, wd, act)
    x, wg, wu, wd = _mlp_args("mlp", x, wg, wu, wd, act, torch.bfloat16)
    n, d = x.shape
    f = wg.shape[0]
    out = torch.empty_like(x)
    if n == 0:
        return out
    g = torch.empty((n, f), dtype=x.dtype, device=x.device)
    bh, bn = mlp_tiles(n, d, f, _sm_count(x.device))
    fn = _build.entry("mlp", "ggt_mlp", _MLP_ARGTYPES)
    err = fn(
        _build.ptr(x), _build.ptr(wg), _build.ptr(wu), _build.ptr(wd), _build.ptr(g),
        _build.ptr(out), n, d, f, bh, bn, _ACT_IDS[act], _build.stream_ptr(x.device),
    )
    mlp.launches += 1
    _build.check(err, "mlp")
    return out


mlp.launches = 0


def mlp_f32(x, wg, wu, wd, act: str):
    """act(x @ wg^T) * (x @ wu^T) @ wd^T for x [N, D] and the weights in
    fp32: #11's fp32 form (`csrc/mlp_qkv_f32.cu`: the weights' TF32 split,
    gate/up, down, 3xTF32 on the tensor cores; counted as one call) for CUDA
    tensors, the plain version for a CPU tensor (or inside
    ops.reference_mode())."""
    if not use_kernel(x, wg, wu, wd):
        return mlp_kernel_ref(x, wg, wu, wd, act)
    x, wg, wu, wd = _mlp_args("mlp_f32", x, wg, wu, wd, act, torch.float32)
    n, d = x.shape
    f = wg.shape[0]
    out = torch.empty_like(x)
    if n == 0:
        return out
    g = torch.empty((n, f), dtype=torch.float32, device=x.device)
    planes = torch.empty((2, 3 * f * d), dtype=torch.float32, device=x.device)  # hi, lo
    fn = _build.entry("mlp_qkv_f32", "ggt_mlp_f32", _MLP_F32_ARGTYPES)
    err = fn(
        _build.ptr(x), _build.ptr(wg), _build.ptr(wu), _build.ptr(wd), _build.ptr(planes),
        _build.ptr(g), _build.ptr(out), n, d, f, f32_block_n([d]), _ACT_IDS[act],
        _build.stream_ptr(x.device),
    )
    mlp_f32.launches += 1
    _build.check(err, "mlp_f32")
    return out


mlp_f32.launches = 0


def mlp_bwd_ref(x, wg, wu, wd, dout, act: str):
    """(dx, dwg, dwu, dwd) of `fused_mlp`, the formula of `_fused_mlp_bwd` in
    plain ops: xg, xu, a, g computed again from x (rounded to x's dtype),
    dg and dxg rounded, the three weight gradients summed in fp32. The
    matrix products are `torch.matmul`, as the JAX package leaves them to
    XLA: on fp32 inputs they are fp32 products (cuBLAS, TF32 off unless the
    caller turns `torch.backends.cuda.matmul.allow_tf32` on)."""
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


def _norm_mlp_args(name, x, wn, wg, wu, wd, act, dtype):
    """The checks and layouts both forms of the norm_mlp kernel need:
    (x, wn fp32, wg, wu, wd) contiguous. Raises on what they do not take."""
    x, wg, wu, wd = _mlp_args(name, x, wg, wu, wd, act, dtype)
    if wn.shape != x.shape[-1:]:
        raise ValueError(f"norm weight shape {wn.shape}")
    if x.shape[1] > _MLP_MAX_D:
        raise NotImplementedError(f"the {name} kernel needs D <= {_MLP_MAX_D}, got {x.shape[1]}")
    return x, wn.float().contiguous(), wg, wu, wd


def norm_mlp(x, wn, wg, wu, wd, eps: float, act: str):
    """x + mlp(rms(x) * wn) for x [N, D] in bf16 and bf16 weights: the CUDA
    kernel (the rrms pre-pass and two stages, counted as one call) for a
    CUDA tensor, its fp32 form (norm_mlp_f32) for fp32 ones, the plain
    version for a CPU tensor (or inside ops.reference_mode())."""
    if not use_kernel(x, wn, wg, wu, wd):
        return norm_mlp_ref(x, wn, wg, wu, wd, eps, act)
    if x.dtype == torch.float32:
        return norm_mlp_f32(x, wn, wg, wu, wd, eps, act)
    x, wn, wg, wu, wd = _norm_mlp_args("norm_mlp", x, wn, wg, wu, wd, act, torch.bfloat16)
    n, d = x.shape
    f = wg.shape[0]
    out = torch.empty_like(x)
    if n == 0:
        return out
    g = torch.empty((n, f), dtype=x.dtype, device=x.device)
    rrms = torch.empty((n,), dtype=torch.float32, device=x.device)
    bh, bn = mlp_tiles(n, d, f, _sm_count(x.device))
    fn = _build.entry("norm_mlp", "ggt_norm_mlp", _ARGTYPES)
    err = fn(
        _build.ptr(x), _build.ptr(wn), _build.ptr(wg), _build.ptr(wu), _build.ptr(wd),
        _build.ptr(g), _build.ptr(out), _build.ptr(rrms), n, d, f, bh, bn, float(eps),
        _ACT_IDS[act], _build.stream_ptr(x.device),
    )
    norm_mlp.launches += 1
    _build.check(err, "norm_mlp")
    return out


norm_mlp.launches = 0


def norm_mlp_f32(x, wn, wg, wu, wd, eps: float, act: str):
    """x + mlp(rms(x) * wn) for x [N, D] and the weights in fp32: #2's fp32
    form (`csrc/mlp_qkv_f32.cu`: the weights' TF32 split, the rrms pre-pass,
    gate/up on x normalised, down with x added, 3xTF32 on the tensor cores;
    counted as one call) for CUDA tensors, the plain version for a CPU
    tensor (or inside ops.reference_mode()). D at most 4096: wn's row sits
    in the gate/up kernel's shared memory."""
    if not use_kernel(x, wn, wg, wu, wd):
        return norm_mlp_ref(x, wn, wg, wu, wd, eps, act)
    x, wn, wg, wu, wd = _norm_mlp_args("norm_mlp_f32", x, wn, wg, wu, wd, act, torch.float32)
    n, d = x.shape
    f = wg.shape[0]
    if d > _QKV_MAX_D:
        raise NotImplementedError(f"the norm_mlp_f32 kernel needs D <= {_QKV_MAX_D}, got {d}")
    out = torch.empty_like(x)
    if n == 0:
        return out
    g = torch.empty((n, f), dtype=torch.float32, device=x.device)
    rrms = torch.empty((n,), dtype=torch.float32, device=x.device)
    planes = torch.empty((2, 3 * f * d), dtype=torch.float32, device=x.device)  # hi, lo
    fn = _build.entry("mlp_qkv_f32", "ggt_norm_mlp_f32", _F32_ARGTYPES)
    err = fn(
        _build.ptr(x), _build.ptr(wn), _build.ptr(wg), _build.ptr(wu), _build.ptr(wd),
        _build.ptr(planes), _build.ptr(g), _build.ptr(out), _build.ptr(rrms), n, d, f,
        f32_block_n([d]), float(eps), _ACT_IDS[act], _build.stream_ptr(x.device),
    )
    norm_mlp_f32.launches += 1
    _build.check(err, "norm_mlp_f32")
    return out


norm_mlp_f32.launches = 0


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


def norm_qkv_ref(x, wn, wq, wk, wv, eps: float):
    """Plain version of the norm_qkv kernel, with its rounding points: RMS
    statistics in fp32, hpre = x * rrms * wn rounded to x's dtype, each of
    the three products summed in fp32 and rounded once."""
    dt = x.dtype
    x32 = x.float()
    rrms = torch.rsqrt(x32.pow(2).mean(dim=-1, keepdim=True) + eps)
    hpre = (x32 * rrms * wn.float()).to(dt).float()
    return tuple(F.linear(hpre, w.float()).to(dt) for w in (wq, wk, wv))


def qkv_block_n(widths) -> int:
    """The norm_qkv kernel's output tile width for these q, k, v widths: the
    largest of 256, 128 and 64 that divides all three, so that no tile
    straddles two outputs. 0 when none does."""
    return next((bn for bn in _QKV_BLOCK_NS if all(w % bn == 0 for w in widths)), 0)


def f32_block_n(widths) -> int:
    """The 3xTF32 body's output tile width (#12f; #11f's and #2f's down
    stage) for outputs of these widths: 128 where it divides them all, else
    64 where that does; 0 when neither does. It stops at 128: a consumer
    thread holds two sets of [64, BN] fp32 sums, the tile's and a stage's
    partial ones (csrc/mlp_qkv_f32.cu)."""
    return next((bn for bn in _F32_BLOCK_NS if all(w % bn == 0 for w in widths)), 0)


def _qkv_args(name, x, wn, wq, wk, wv, dtype):
    """The checks and layouts both forms of the norm_qkv kernel need: (x,
    wn fp32, wq, wk, wv) contiguous and the output tile width of the form's
    kernel. Raises on what they do not take."""
    n, d = x.shape
    if x.dtype != dtype or any(w.dtype != dtype for w in (wq, wk, wv)):
        raise NotImplementedError(f"the {name} kernel takes {dtype} activations and weights, "
                                  f"got {x.dtype}, {[w.dtype for w in (wq, wk, wv)]}")
    if wn.shape != (d,) or any(w.dim() != 2 or w.shape[1] != d for w in (wq, wk, wv)):
        raise ValueError(f"shapes x {x.shape} wn {wn.shape} weights "
                         f"{[tuple(w.shape) for w in (wq, wk, wv)]}")
    widths = [w.shape[0] for w in (wq, wk, wv)]
    bn = (qkv_block_n if dtype == torch.bfloat16 else f32_block_n)(widths)
    if d % 64 or d > _QKV_MAX_D or not bn:
        raise NotImplementedError(
            f"the {name} kernel needs D % 64 == 0, D <= {_QKV_MAX_D} and widths % 64 == 0, "
            f"got D {d}, widths {widths}")
    x, wq, wk, wv = (t.contiguous() for t in (x, wq, wk, wv))
    # TMA reads x and the weights from 16-byte aligned bases
    if any(t.data_ptr() % 16 for t in (x, wq, wk, wv)):
        raise ValueError(f"{name} needs 16-byte aligned x and weights")
    return x, wn.float().contiguous(), wq, wk, wv, bn


def _qkv_launch(name, symbol, dtype, x, wn, wq, wk, wv, eps: float):
    """Launch the norm_qkv entry `symbol` for `dtype`: csrc/norm_qkv.cu's
    for bf16, csrc/mlp_qkv_f32.cu's for fp32 (with the scratch of the
    weights' TF32 planes). Returns (q, k, v, the entry's error code)."""
    x, wn, wq, wk, wv, bn = _qkv_args(name, x, wn, wq, wk, wv, dtype)
    n, d = x.shape
    widths = [w.shape[0] for w in (wq, wk, wv)]
    q, k, v = (torch.empty((n, w), dtype=x.dtype, device=x.device) for w in widths)
    if n == 0:
        return q, k, v, 0
    rrms = torch.empty((n,), dtype=torch.float32, device=x.device)
    ptrs = [_build.ptr(t) for t in (x, wn, wq, wk, wv)]
    if dtype == torch.bfloat16:
        fn = _build.entry("norm_qkv", symbol, _QKV_ARGTYPES)
    else:
        planes = torch.empty((2, sum(widths) * d), dtype=torch.float32, device=x.device)
        fn = _build.entry("mlp_qkv_f32", symbol, _QKV_F32_ARGTYPES)
        ptrs.append(_build.ptr(planes))
    err = fn(
        *ptrs, _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(rrms), n, d, *widths, bn,
        float(eps), _build.stream_ptr(x.device),
    )
    return q, k, v, err


def norm_qkv(x, wn, wq, wk, wv, eps: float):
    """(q, k, v) = rms(x) * wn @ (wq|wk|wv)^T for x [N, D] in bf16, wn fp32
    and bf16 weights [width, D] (widths multiples of 64, so GQA's narrower k
    and v too): the CUDA kernel (the rrms pre-pass and the main kernel,
    counted as one call) for a CUDA tensor, its fp32 form (norm_qkv_f32) for
    fp32 x and weights, the plain version for a CPU tensor (or inside
    ops.reference_mode())."""
    if not use_kernel(x, wn, wq, wk, wv):
        return norm_qkv_ref(x, wn, wq, wk, wv, eps)
    if x.dtype == torch.float32:
        return norm_qkv_f32(x, wn, wq, wk, wv, eps)
    q, k, v, err = _qkv_launch("norm_qkv", "ggt_norm_qkv", torch.bfloat16, x, wn, wq, wk, wv, eps)
    if x.shape[0]:
        norm_qkv.launches += 1
    _build.check(err, "norm_qkv")
    return q, k, v


norm_qkv.launches = 0


def norm_qkv_f32(x, wn, wq, wk, wv, eps: float):
    """(q, k, v) = rms(x) * wn @ (wq|wk|wv)^T for x [N, D], wn and the
    weights in fp32: #12's fp32 form (`csrc/mlp_qkv_f32.cu`: the weights'
    TF32 split, the rrms pre-pass, then the three products in 3xTF32 on the
    tensor cores; counted as one call) for CUDA tensors, the plain version
    for a CPU tensor (or inside ops.reference_mode()). The bf16 kernel's
    contract: D and the widths multiples of 64."""
    if not use_kernel(x, wn, wq, wk, wv):
        return norm_qkv_ref(x, wn, wq, wk, wv, eps)
    q, k, v, err = _qkv_launch("norm_qkv_f32", "ggt_norm_qkv_f32", torch.float32, x, wn, wq, wk,
                               wv, eps)
    if x.shape[0]:
        norm_qkv_f32.launches += 1
    _build.check(err, "norm_qkv_f32")
    return q, k, v


norm_qkv_f32.launches = 0


def norm_qkv_bwd(x, wn, wq, wk, wv, dq, dk, dv, eps: float):
    """(dx, dwn, dwq, dwk, dwv) of `fused_norm_qkv`, the formula of
    `_fused_norm_qkv_bwd`: hpre computed again from x (rounded to x's
    dtype); the weight gradients summed in fp32; dhpre the three products
    in x's dtype, each rounded, added in that dtype in the order q, k, v;
    then the RMSNorm adjoint of that cotangent, which is exact in x's dtype,
    through rmsnorm_bwd (kernel #13 on the card). The products are
    `torch.matmul`, as the JAX package leaves them to XLA."""
    dt = x.dtype
    x32 = x.float()
    rrms = torch.rsqrt(x32.pow(2).mean(dim=-1, keepdim=True) + eps)
    hpre = (x32 * rrms * wn.float()).to(dt)
    dq, dk, dv = (g.to(dt) for g in (dq, dk, dv))
    dws = [mm_f32(g.t(), hpre) for g in (dq, dk, dv)]
    dhpre = dq @ wq.to(dt) + dk @ wk.to(dt) + dv @ wv.to(dt)
    dx, dwn = rmsnorm_bwd(x, dhpre, wn, eps)
    return (dx, dwn.to(wn.dtype), *(dw.to(w.dtype) for dw, w in zip(dws, (wq, wk, wv))))


class _FusedNormQKV(torch.autograd.Function):
    """The norm_qkv kernel forward; backward `norm_qkv_bwd`. Saves
    (x, wn, wq, wk, wv) only: the backward computes hpre again."""

    @staticmethod
    def forward(ctx, x, wn, wq, wk, wv, eps):
        dt = x.dtype
        ctx.save_for_backward(x, wn, wq, wk, wv)
        ctx.eps = eps
        return norm_qkv(x, wn.float(), wq.to(dt), wk.to(dt), wv.to(dt), eps)

    @staticmethod
    def backward(ctx, dq, dk, dv):
        return (*norm_qkv_bwd(*ctx.saved_tensors, dq, dk, dv, ctx.eps), None)


def fused_norm_qkv(x, wn, wq, wk, wv, eps: float):
    """(q, k, v) = rms(x) * wn @ (wq|wk|wv)^T: fp32 master weights cast to
    x's dtype once per call, then `norm_qkv`; differentiable in x and every
    weight."""
    return _FusedNormQKV.apply(x, wn, wq, wk, wv, eps)


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
    """(dx, dw) for x, g [N, D] and w [D]: the CUDA kernel (the persistent
    row pass and the small sum of its per-CTA dw rows, counted as one call)
    for bf16 CUDA tensors, its fp32 instances (rmsnorm_bwd_f32) for fp32
    ones, the plain version for a CPU tensor (or inside
    ops.reference_mode())."""
    if not use_kernel(x, g, w):
        return rmsnorm_bwd_ref(x, g, w, eps)
    if x.dtype == torch.float32:
        return rmsnorm_bwd_f32(x, g, w, eps)
    dx, dw, err = _rms_launch("rmsnorm_bwd", "ggt_rmsnorm_bwd", torch.bfloat16, x, g, w, eps)
    rmsnorm_bwd.launches += 1
    _build.check(err, "rmsnorm_bwd")
    return dx, dw


rmsnorm_bwd.launches = 0


def rmsnorm_bwd_f32(x, g, w, eps: float):
    """(dx, dw) for fp32 x, g [N, D]: #13's fp32 instances
    (`csrc/rmsnorm_bwd.cu`, templated on the element type; the row pass and
    the sum, counted as one call) for CUDA tensors, the plain version for a
    CPU tensor (or inside ops.reference_mode())."""
    if not use_kernel(x, g, w):
        return rmsnorm_bwd_ref(x, g, w, eps)
    dx, dw, err = _rms_launch("rmsnorm_bwd_f32", "ggt_rmsnorm_bwd_f32", torch.float32, x, g, w,
                              eps)
    rmsnorm_bwd_f32.launches += 1
    _build.check(err, "rmsnorm_bwd_f32")
    return dx, dw


rmsnorm_bwd_f32.launches = 0


def _rms_launch(name, symbol, dtype, x, g, w, eps: float):
    """Launch the rmsnorm_bwd entry `symbol`, whose x and g are `dtype`:
    (dx, dw, the entry's error code)."""
    if x.dim() != 2 or g.shape != x.shape or w.shape != x.shape[-1:]:
        raise ValueError(f"shapes x {x.shape} g {g.shape} w {w.shape}")
    n, d = x.shape
    if x.dtype != dtype or g.dtype != dtype:
        raise NotImplementedError(f"{name} takes {dtype} x and g, got {x.dtype}, {g.dtype}")
    if d % 8 or -(-d // 256) not in _RMS_CHUNKS:
        raise NotImplementedError(
            f"the rmsnorm_bwd kernel needs D % 8 == 0 and ceil(D / 256) in {_RMS_CHUNKS}, got {d}"
        )
    x, g = x.contiguous(), g.contiguous()
    w = w.float().contiguous()
    if x.data_ptr() % 16 or g.data_ptr() % 16:
        raise ValueError("rmsnorm_bwd needs 16-byte aligned x and g")
    blocks = rms_blocks(n, d, _sm_count(x.device))
    dx = torch.empty_like(x)
    dw = torch.empty((d,), dtype=torch.float32, device=x.device)
    partial = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    fn = _build.entry("rmsnorm_bwd", symbol, _RMS_ARGTYPES)
    err = fn(
        _build.ptr(x), _build.ptr(g), _build.ptr(w), _build.ptr(dx), _build.ptr(dw),
        _build.ptr(partial), n, d, float(eps), blocks, _build.stream_ptr(x.device),
    )
    return dx, dw, err
