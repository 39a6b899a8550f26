"""Segment-masked flash attention, forward and backward: CUDA kernels and
their plain versions.

Counterpart of `graphgpt_tpu/ops/flash_attention.py` (`_prep` :1205,
`flash_attention` :1231, `_fwd_kernel_single` :124, `_bwd_kernel_fused`
:706, `_dq_kernel_single` :602, `_dkv_kernel_single` :789, `_flash_bwd`
:902, `_attach_grad_rope` :1144). The kernels live in `csrc/flash_fwd.cu`,
`csrc/flash_bwd.cu` (fused backward) and `csrc/flash_bwd_split.cu` (the
split pair flash_dq and flash_dkv, which the backward takes, as the JAX
package does, when a bi-causal split is set). Conventions kept from the
JAX package: q, k, v are token-major `[B, P, H*Dh]` at the kernel boundary;
GQA is expanded and the softmax scale folded into q (in q's dtype) before
the kernel; RoPE cos/sin `[B, P, Dh]` are cast to q's dtype and applied
in-kernel; lse is `[B, H, P]` fp32; padded rows (segment 0) give out = 0
and lse = -1e30. The autograd Function saves the un-rotated (qs, k, v) with
(out, lse); the backward rotates again in-kernel and brings dq, dk back
through the inverse rotation. One difference from the JAX package: a padded
row takes no part in the backward even when a non-zero `dlse` reaches it
(there its exp(S - lse) = 1 would spread dlse over every key of the row).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build, use_kernel

NEG_INF = -1e30
MAX_P = 2048  # the JAX package's single-block limit; longer rows stream (#6)
# q, k, v, seg, cos, sin, out, lse; B, P, H, causal, bi_split; stream
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# q, k, v, seg, cos, sin, out, lse, do, dlse, delta, dq, dk, dv; B, P, H, causal; stream
_BWD_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
# q, k, v, seg, cos, sin, out, lse, do, dlse, delta, dq; B, P, H, causal, bi_split; stream
_DQ_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# q, k, v, seg, cos, sin, lse, delta, do, dk, dv; B, P, H, causal, bi_split; stream
_DKV_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_STREAMED = "the streamed kernels (#6 _fwd_kernel_stream, #7 _dq_kernel_stream, " \
    "#8 _dkv_kernel_stream), a later slice"


def _valid_mask(seg: torch.Tensor, causal: bool, bi_causal_split: int = 0):
    """[B, 1, P, P] bool: same nonzero segment, plus the causal or bi-causal
    rule (graphgpt_tpu/ops/attention.py:22 _mask_logits)."""
    p = seg.shape[-1]
    valid = (seg[:, None, :, None] == seg[:, None, None, :]) & (seg[:, None, None, :] > 0)
    idx = torch.arange(p, device=seg.device)
    if bi_causal_split > 0:
        split = p - bi_causal_split
        qi, kj = idx[:, None], idx[None, :]
        valid = valid & (((qi < split) & (kj < split)) | ((qi >= split) & (kj <= qi)))
    elif causal:
        valid = valid & (idx[:, None] >= idx[None, :])
    return valid


def rotate_tokens(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, dh: int):
    """RoPE on a token-major [B, P, H*Dh] tensor in its own dtype, each
    product and the sum rounded (the kernel's `load_tile`)."""
    b, p, hd = x.shape
    x4 = x.view(b, p, hd // dh, dh)
    c = cos.to(x.dtype)[:, :, None, :]
    s = sin.to(x.dtype)[:, :, None, :]
    half = dh // 2
    r = torch.cat([-x4[..., half:], x4[..., :half]], dim=-1)
    return (x4 * c + r * s).reshape(b, p, hd)


def flash_attention_ref(
    qs: torch.Tensor,  # [B, P, H*Dh], pre-scaled
    k: torch.Tensor,
    v: torch.Tensor,
    seg: torch.Tensor,  # [B, P] int
    cos: Optional[torch.Tensor],  # [B, P, Dh] or None
    sin: Optional[torch.Tensor],
    causal: bool,
    dh: int,
    bi_causal_split: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: (out [B, P, H*Dh], lse [B, H, P] fp32).
    fp32 logits, softmax over the whole row, probabilities rounded to v's
    dtype for the PV product, as `_fwd_kernel_single` does."""
    b, p, hd = qs.shape
    h = hd // dh
    if cos is not None:
        qs, k = rotate_tokens(qs, cos, sin, dh), rotate_tokens(k, cos, sin, dh)
    q4 = qs.view(b, p, h, dh).transpose(1, 2).float()
    k4 = k.view(b, p, h, dh).transpose(1, 2).float()
    v4 = v.view(b, p, h, dh).transpose(1, 2)
    s = q4 @ k4.transpose(-1, -2)
    s = s + torch.where(_valid_mask(seg, causal, bi_causal_split), 0.0, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    pij = torch.exp(s - m)
    l = pij.sum(dim=-1, keepdim=True)
    pv = pij.to(v.dtype).float() @ v4.float()
    rowvalid = (seg > 0)[:, None, :, None]
    out = torch.where(rowvalid, pv / l, 0.0).to(qs.dtype)
    lse = (m + torch.log(l))[..., 0]
    lse = torch.where(m[..., 0] <= NEG_INF, NEG_INF, lse)
    return out.transpose(1, 2).reshape(b, p, hd), lse


def _check_rope(cos, sin, b, p, dh):
    """cos, sin as contiguous bf16 [B, P, Dh] (None passes through)."""
    if cos is None:
        return None, None
    cos = cos.to(torch.bfloat16).contiguous()
    sin = sin.to(torch.bfloat16).contiguous()
    if cos.shape != (b, p, dh) or sin.shape != (b, p, dh):
        raise ValueError(f"cos/sin must be [B, P, {dh}], got {cos.shape}")
    return cos, sin


def _check_aligned(name, *tensors):
    """The kernels move 16 bytes a thread."""
    if any(t is not None and t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name} needs 16-byte aligned token-major inputs, cos and sin")


def _opt_ptr(t):
    return _build.ptr(t) if t is not None else ctypes.c_void_p(0)


def flash_fwd(qs, k, v, seg, cos, sin, causal: bool, dh: int, bi_causal_split: int = 0):
    """(out, lse): the CUDA kernel for a CUDA tensor, the plain version for
    a CPU tensor (or inside ops.reference_mode())."""
    if not use_kernel(qs, k, v, seg):
        return flash_attention_ref(qs, k, v, seg, cos, sin, causal, dh, bi_causal_split)
    b, p, hd = qs.shape
    if p > MAX_P:
        raise NotImplementedError(f"P={p} > {MAX_P} needs {_STREAMED}")
    if dh != 64 or qs.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"the flash kernel takes bf16 with head_dim 64, got {qs.dtype}, {dh}"
        )
    qs, k, v = (t.contiguous() for t in (qs, k, v))
    seg = seg.to(torch.int32).contiguous()
    if k.shape != qs.shape or v.shape != qs.shape or seg.shape != (b, p):
        raise ValueError(f"shapes q {qs.shape} k {k.shape} v {v.shape} seg {seg.shape}")
    cos, sin = _check_rope(cos, sin, b, p, dh)
    _check_aligned("flash_fwd", qs, k, v, cos, sin)
    out = torch.empty_like(qs)
    lse = torch.empty((b, hd // dh, p), dtype=torch.float32, device=qs.device)
    fn = _build.entry("flash_fwd", "ggt_flash_fwd", _ARGTYPES)
    err = fn(
        _build.ptr(qs), _build.ptr(k), _build.ptr(v), _build.ptr(seg), _opt_ptr(cos),
        _opt_ptr(sin), _build.ptr(out), _build.ptr(lse), b, p, hd // dh, int(causal),
        int(bi_causal_split), _build.stream_ptr(qs.device),
    )
    flash_fwd.launches += 1
    _build.check(err, "flash_fwd")
    return out, lse


flash_fwd.launches = 0


def unrotate_tokens(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, dh: int):
    """The inverse (transposed) rotation of a token-major fp32 [B, P, H*Dh]
    cotangent: x*cos - rotate_half(x)*sin in fp32 (`_rot_head(inv=True)`)."""
    b, p, hd = x.shape
    x4 = x.view(b, p, hd // dh, dh)
    c = cos.float()[:, :, None, :]
    s = sin.float()[:, :, None, :]
    half = dh // 2
    r = torch.cat([-x4[..., half:], x4[..., :half]], dim=-1)
    return (x4 * c - r * s).reshape(b, p, hd)


def flash_delta(do, out, dlse, dh: int) -> torch.Tensor:
    """delta [B, H, P] fp32 = rowsum(do * out) - dlse in torch ops, as the
    JAX package's split backward computes it outside the kernels
    (`_flash_bwd` :933-940): the plain version of the delta kernel that
    flash_bwd and flash_dq launch first. out is 0 on padded rows, which the
    kernels leave out anyway."""
    b, p, hd = do.shape
    delta = (do.float() * out.float()).view(b, p, hd // dh, dh).sum(dim=-1).transpose(1, 2)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.contiguous()


def _bwd_terms(qs, k, v, seg, cos, sin, lse, delta, do, causal: bool, dh: int,
               bi_causal_split: int):
    """What every backward twin shares, at the kernels' rounding points:
    rot(q), rot(k) and do (zero on padded rows) per head in fp32, p =
    exp(S - lse) (zero on padded rows) and ds = p*(do v^T - delta) rounded
    to the working dtype, with cos and sin in that dtype."""
    b, p, hd = qs.shape
    h = hd // dh
    dt = qs.dtype
    if cos is not None:
        cos, sin = cos.to(dt), sin.to(dt)
        qs, k = rotate_tokens(qs, cos, sin, dh), rotate_tokens(k, cos, sin, dh)

    def heads(t):
        return t.reshape(b, p, h, dh).transpose(1, 2).float()

    rowvalid = seg > 0
    do = torch.where(rowvalid[..., None], do, torch.zeros((), dtype=do.dtype, device=do.device))
    q4, k4, v4, do4 = heads(qs), heads(k), heads(v), heads(do.to(dt))
    s = q4 @ k4.transpose(-1, -2)
    s = s + torch.where(_valid_mask(seg, causal, bi_causal_split), 0.0, NEG_INF)
    pij = torch.exp(s - lse[..., None])
    pij = torch.where(rowvalid[:, None, :, None], pij, 0.0)
    ds = (pij * (do4 @ v4.transpose(-1, -2) - delta.float()[..., None])).to(dt).float()
    return q4, k4, do4, pij, ds, cos, sin


def _tokens(t):
    """[B, H, P, Dh] -> token-major [B, P, H*Dh]."""
    b, h, p, dh = t.shape
    return t.transpose(1, 2).reshape(b, p, h * dh)


def _back(x, cos, sin, dh, dt):
    """A token-major fp32 dq or dk through the inverse rotation, rounded once."""
    x = _tokens(x)
    if cos is not None:
        x = unrotate_tokens(x, cos, sin, dh)
    return x.to(dt)


def flash_bwd_ref(
    qs, k, v, seg, cos, sin, out, lse, do, dlse, causal: bool, dh: int,
    bi_causal_split: int = 0,
):
    """Plain version of the backward kernel, from `_bwd_kernel_fused`'s
    formula with its rounding points: (dq, dk, dv) token-major in qs's dtype.
    p = exp(S - lse); delta = rowsum(do*out) - dlse in fp32; p rounded to the
    working dtype for dv = p^T do; ds = p*(do v^T - delta) rounded for
    dq = ds rot(k) and dk = ds^T rot(q); the inverse rotation on the fp32
    sums, rounded once. Padded rows take no part."""
    dt = qs.dtype
    delta = flash_delta(do.to(dt), out, dlse, dh)
    q4, k4, do4, pij, ds, cos, sin = _bwd_terms(
        qs, k, v, seg, cos, sin, lse, delta, do, causal, dh, bi_causal_split)
    dv = _tokens(pij.to(dt).float().transpose(-1, -2) @ do4).to(dt)
    return (_back(ds @ k4, cos, sin, dh, dt), _back(ds.transpose(-1, -2) @ q4, cos, sin, dh, dt),
            dv)


def _check_bwd(name, dh, qs, k, v, seg, cos, sin, lse, do, extra=(), extra_rows=()):
    """The checks and layouts every backward kernel needs: (qs, k, v, do,
    extra..., seg, cos, sin, lse, extra_rows...) contiguous, seg int32, lse
    and the extra [B, H, P] rows fp32. Raises on what the kernels do not
    take."""
    b, p, hd = qs.shape
    if p > MAX_P:
        raise NotImplementedError(f"P={p} > {MAX_P} needs {_STREAMED}")
    tok = (qs, k, v, do) + tuple(extra)
    if dh != 64 or any(t.dtype != torch.bfloat16 for t in tok):
        raise NotImplementedError(f"{name} takes bf16 with head_dim 64, got {qs.dtype}, {dh}")
    tok = tuple(t.contiguous() for t in tok)
    seg = seg.to(torch.int32).contiguous()
    if any(t.shape != qs.shape for t in tok) or seg.shape != (b, p):
        raise ValueError(f"{name}: token-major shapes {[tuple(t.shape) for t in tok]}, "
                         f"seg {tuple(seg.shape)}")
    rows = tuple(r.float().contiguous() for r in (lse,) + tuple(extra_rows))
    if any(r.shape != (b, hd // dh, p) for r in rows):
        raise ValueError(f"{name}: lse and row statistics must be [B, H, P] = "
                         f"{(b, hd // dh, p)}, got {[tuple(r.shape) for r in rows]}")
    cos, sin = _check_rope(cos, sin, b, p, dh)
    _check_aligned(name, *tok, cos, sin)
    return tok, seg, cos, sin, rows


def flash_bwd(
    qs, k, v, seg, cos, sin, out, lse, do, dlse, causal: bool, dh: int,
    bi_causal_split: int = 0,
):
    """(dq, dk, dv). With a bi-causal split the JAX package leaves the fused
    kernel for the split pair (`_flash_bwd` :911): flash_dq, which gives
    delta too, then flash_dkv. Else the fused CUDA kernel (a small delta
    kernel and the main one, counted as one call) for a CUDA tensor, the
    plain version for a CPU tensor (or inside ops.reference_mode()). dlse
    [B, H, P] is the optional cotangent of lse; None means zeros."""
    if bi_causal_split > 0:
        dq, delta = flash_dq(qs, k, v, seg, cos, sin, out, lse, do, dlse, causal, dh,
                             bi_causal_split)
        dk, dv = flash_dkv(qs, k, v, seg, cos, sin, lse, delta, do, causal, dh, bi_causal_split)
        return dq, dk, dv
    if not use_kernel(qs, k, v, seg, out, lse, do):
        return flash_bwd_ref(qs, k, v, seg, cos, sin, out, lse, do, dlse, causal, dh)
    b, p, hd = qs.shape
    extra_rows = () if dlse is None else (dlse,)
    (qs, k, v, do, out), seg, cos, sin, rows = _check_bwd(
        "flash_bwd", dh, qs, k, v, seg, cos, sin, lse, do, extra=(out,), extra_rows=extra_rows)
    lse, dlse = rows[0], (rows[1] if dlse is not None else None)
    dq, dk, dv = torch.empty_like(qs), torch.empty_like(qs), torch.empty_like(qs)
    delta = torch.empty_like(lse)
    fn = _build.entry("flash_bwd", "ggt_flash_bwd", _BWD_ARGTYPES)
    err = fn(
        _build.ptr(qs), _build.ptr(k), _build.ptr(v), _build.ptr(seg), _opt_ptr(cos),
        _opt_ptr(sin), _build.ptr(out), _build.ptr(lse), _build.ptr(do), _opt_ptr(dlse),
        _build.ptr(delta), _build.ptr(dq), _build.ptr(dk), _build.ptr(dv),
        b, p, lse.shape[1], int(causal), _build.stream_ptr(qs.device),
    )
    flash_bwd.launches += 1
    _build.check(err, "flash_bwd")
    return dq, dk, dv


flash_bwd.launches = 0


def flash_dq_ref(qs, k, v, seg, cos, sin, lse, delta, do, causal: bool, dh: int,
                 bi_causal_split: int = 0):
    """Plain version of flash_dq (`_dq_kernel_single`): dq = ds rot(k) with
    ds = p*(do v^T - delta) rounded to the working dtype, the inverse
    rotation on the fp32 sum, rounded once; 0 on padded rows."""
    _, k4, _, _, ds, cos, sin = _bwd_terms(
        qs, k, v, seg, cos, sin, lse, delta, do, causal, dh, bi_causal_split)
    return _back(ds @ k4, cos, sin, dh, qs.dtype)


def flash_dkv_ref(qs, k, v, seg, cos, sin, lse, delta, do, causal: bool, dh: int,
                  bi_causal_split: int = 0):
    """Plain version of flash_dkv (`_dkv_kernel_single`): (dk, dv) with
    dv = p^T do (p rounded to the working dtype) and dk = ds^T rot(q), dk
    through the inverse rotation; padded rows take no part."""
    dt = qs.dtype
    q4, _, do4, pij, ds, cos, sin = _bwd_terms(
        qs, k, v, seg, cos, sin, lse, delta, do, causal, dh, bi_causal_split)
    dv = _tokens(pij.to(dt).float().transpose(-1, -2) @ do4).to(dt)
    return _back(ds.transpose(-1, -2) @ q4, cos, sin, dh, dt), dv


def flash_dq(qs, k, v, seg, cos, sin, out, lse, do, dlse, causal: bool, dh: int,
             bi_causal_split: int = 0):
    """(dq, delta), delta = rowsum(do * out) - dlse [B, H, P] fp32 for
    flash_dkv: the CUDA kernels (the delta kernel, then dq; counted as one
    call) for a CUDA tensor, flash_delta and flash_dq_ref for a CPU tensor
    (or inside ops.reference_mode()). dlse None means zeros."""
    if not use_kernel(qs, k, v, seg, out, lse, do):
        delta = flash_delta(do, out, dlse, dh)
        return flash_dq_ref(qs, k, v, seg, cos, sin, lse, delta, do, causal, dh,
                            bi_causal_split), delta
    b, p, _ = qs.shape
    extra_rows = () if dlse is None else (dlse,)
    (qs, k, v, do, out), seg, cos, sin, rows = _check_bwd(
        "flash_dq", dh, qs, k, v, seg, cos, sin, lse, do, extra=(out,), extra_rows=extra_rows)
    lse, dlse = rows[0], (rows[1] if dlse is not None else None)
    dq, delta = torch.empty_like(qs), torch.empty_like(lse)
    fn = _build.entry("flash_bwd_split", "ggt_flash_dq", _DQ_ARGTYPES)
    err = fn(
        _build.ptr(qs), _build.ptr(k), _build.ptr(v), _build.ptr(seg), _opt_ptr(cos),
        _opt_ptr(sin), _build.ptr(out), _build.ptr(lse), _build.ptr(do), _opt_ptr(dlse),
        _build.ptr(delta), _build.ptr(dq), b, p, lse.shape[1], int(causal),
        int(bi_causal_split), _build.stream_ptr(qs.device),
    )
    flash_dq.launches += 1
    _build.check(err, "flash_dq")
    return dq, delta


flash_dq.launches = 0


def flash_dkv(qs, k, v, seg, cos, sin, lse, delta, do, causal: bool, dh: int,
              bi_causal_split: int = 0):
    """(dk, dv): the CUDA kernel for a CUDA tensor, the plain version for a
    CPU tensor (or inside ops.reference_mode())."""
    if not use_kernel(qs, k, v, seg, lse, delta, do):
        return flash_dkv_ref(qs, k, v, seg, cos, sin, lse, delta, do, causal, dh,
                             bi_causal_split)
    b, p, _ = qs.shape
    (qs, k, v, do), seg, cos, sin, (lse, delta) = _check_bwd(
        "flash_dkv", dh, qs, k, v, seg, cos, sin, lse, do, extra_rows=(delta,))
    dk, dv = torch.empty_like(qs), torch.empty_like(qs)
    fn = _build.entry("flash_bwd_split", "ggt_flash_dkv", _DKV_ARGTYPES)
    err = fn(
        _build.ptr(qs), _build.ptr(k), _build.ptr(v), _build.ptr(seg), _opt_ptr(cos),
        _opt_ptr(sin), _build.ptr(lse), _build.ptr(delta), _build.ptr(do), _build.ptr(dk),
        _build.ptr(dv), b, p, lse.shape[1], int(causal), int(bi_causal_split),
        _build.stream_ptr(qs.device),
    )
    flash_dkv.launches += 1
    _build.check(err, "flash_dkv")
    return dk, dv


flash_dkv.launches = 0


class _FlashAttention(torch.autograd.Function):
    """(out, lse) of the forward kernel with the backward kernel attached
    (`_attach_grad_rope`, and `_attach_grad_lse` for the cotangent of lse):
    saves the un-rotated (qs, k, v), seg, cos, sin, out and lse. Both
    outputs are differentiable; a cotangent that autograd does not have
    (lse unused, the common case) stays None, which the backward kernel
    reads as zeros. `stash`, when given, is a dict that keeps (out, lse)
    across a rematerialised region: the first call fills it, the recompute
    takes them from it and does not run the forward kernel again."""

    @staticmethod
    def forward(ctx, qs, k, v, seg, cos, sin, causal, dh, bi_causal_split, stash):
        ctx.set_materialize_grads(False)
        if stash is not None and "out" in stash:
            out, lse = stash.pop("out"), stash.pop("lse")
        else:
            out, lse = flash_fwd(qs, k, v, seg, cos, sin, causal, dh, bi_causal_split)
            if stash is not None:
                stash["out"], stash["lse"] = out.detach(), lse.detach()
        ctx.save_for_backward(qs, k, v, seg, cos, sin, out, lse)
        ctx.args = (causal, dh, bi_causal_split)
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        qs, k, v, seg, cos, sin, out, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(out)
        dq, dk, dv = flash_bwd(qs, k, v, seg, cos, sin, out, lse, do, dlse, *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,  # [B, P, H, Dh]
    k: torch.Tensor,  # [B, P, Hkv, Dh]
    v: torch.Tensor,
    segment_ids: torch.Tensor,  # [B, P]
    causal: bool = False,
    softmax_scale: Optional[float] = None,
    bi_causal_split: int = 0,
    rope: Optional[tuple] = None,  # (cos, sin) [B, P, Dh]
    return_lse: bool = False,
    stash: Optional[dict] = None,
):
    """[B, P, H, Dh] (and lse [B, H, P] when asked): GQA expansion and the
    scale fold as `_prep` (autograd carries their gradients), then the
    kernels with in-kernel RoPE. `stash`: see `_FlashAttention`."""
    b, p, h, dh = q.shape
    hkv = k.shape[2]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    scale = softmax_scale if softmax_scale is not None else dh**-0.5
    qs = q * torch.tensor(scale, dtype=q.dtype, device=q.device)
    cos = sin = None
    if rope is not None:
        cos, sin = rope[0].to(qs.dtype), rope[1].to(qs.dtype)
    out, lse = _FlashAttention.apply(
        qs.reshape(b, p, h * dh), k.reshape(b, p, h * dh), v.reshape(b, p, h * dh),
        segment_ids, cos, sin, causal, dh, bi_causal_split, stash,
    )
    out = out.view(b, p, h, dh)
    return (out, lse) if return_lse else out
