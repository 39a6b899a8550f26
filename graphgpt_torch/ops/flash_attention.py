"""Segment-masked flash attention forward: CUDA kernel and plain version.

Counterpart of `graphgpt_tpu/ops/flash_attention.py` (`_prep` :1205,
`flash_attention` :1231, `_fwd_kernel_single` :124). The kernel lives in
`csrc/flash_fwd.cu`. Conventions kept from the JAX package: q, k, v are
token-major `[B, P, H*Dh]` at the kernel boundary; GQA is expanded and the
softmax scale folded into q (in q's dtype) before the kernel; RoPE cos/sin
`[B, P, Dh]` are cast to q's dtype and applied in-kernel; lse is
`[B, H, P]` fp32; padded rows (segment 0) give out = 0 and lse = -1e30.
The wrapper returns lse too: the backward of the training slice consumes
the saved (out, lse).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build, use_kernel

NEG_INF = -1e30
MAX_P = 2048  # the JAX package's single-block limit; longer rows stream (#6)
# q, k, v, seg, cos, sin, out, lse; B, P, H, causal; stream
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


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


def flash_fwd(qs, k, v, seg, cos, sin, causal: bool, dh: int, bi_causal_split: int = 0):
    """(out, lse): the CUDA kernel for a CUDA tensor, the plain version for
    a CPU tensor (or inside ops.reference_mode())."""
    if not use_kernel(qs, k, v, seg):
        return flash_attention_ref(qs, k, v, seg, cos, sin, causal, dh, bi_causal_split)
    b, p, hd = qs.shape
    if bi_causal_split > 0:
        raise NotImplementedError(
            "bi-causal split (the denoise decode path) needs the split backward "
            "kernels, a later slice"
        )
    if p > MAX_P:
        raise NotImplementedError(
            f"P={p} > {MAX_P} needs the streamed forward (_fwd_kernel_stream), a later slice"
        )
    if dh != 64 or qs.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"the flash kernel takes bf16 with head_dim 64, got {qs.dtype}, {dh}"
        )
    qs, k, v = (t.contiguous() for t in (qs, k, v))
    seg = seg.to(torch.int32).contiguous()
    if k.shape != qs.shape or v.shape != qs.shape or seg.shape != (b, p):
        raise ValueError(f"shapes q {qs.shape} k {k.shape} v {v.shape} seg {seg.shape}")
    if cos is not None:
        cos = cos.to(torch.bfloat16).contiguous()
        sin = sin.to(torch.bfloat16).contiguous()
        if cos.shape != (b, p, dh) or sin.shape != (b, p, dh):
            raise ValueError(f"cos/sin must be [B, P, {dh}], got {cos.shape}")
    # the kernel moves 16 bytes a thread
    if any(t.data_ptr() % 16 for t in (qs, k, v) + ((cos, sin) if cos is not None else ())):
        raise ValueError("flash_fwd needs 16-byte aligned q, k, v, cos and sin")
    out = torch.empty_like(qs)
    lse = torch.empty((b, hd // dh, p), dtype=torch.float32, device=qs.device)
    fn = _build.entry("flash_fwd", "ggt_flash_fwd", _ARGTYPES)
    null = ctypes.c_void_p(0)
    err = fn(
        _build.ptr(qs), _build.ptr(k), _build.ptr(v), _build.ptr(seg),
        _build.ptr(cos) if cos is not None else null,
        _build.ptr(sin) if sin is not None else null,
        _build.ptr(out), _build.ptr(lse), b, p, hd // dh, int(causal),
        _build.stream_ptr(qs.device),
    )
    flash_fwd.launches += 1
    _build.check(err, "flash_fwd")
    return out, lse


flash_fwd.launches = 0


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
):
    """[B, P, H, Dh] (and lse [B, H, P] when asked): GQA expansion and the
    scale fold as `_prep`, then the kernel with in-kernel RoPE."""
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
    out, lse = flash_fwd(
        qs.reshape(b, p, h * dh), k.reshape(b, p, h * dh), v.reshape(b, p, h * dh),
        segment_ids, cos, sin, causal, dh, bi_causal_split,
    )
    out = out.view(b, p, h, dh)
    return (out, lse) if return_lse else out
