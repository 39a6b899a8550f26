"""Segment-masked flash attention, forward and backward: CUDA kernels and
their plain versions.

Counterpart of `graphgpt_tpu/ops/flash_attention.py` (`_prep` :1205,
`flash_attention` :1231, `_flash_fwd` :409, `_flash_bwd` :902,
`_attach_grad_rope` :1144) and its kernels: `_fwd_kernel_single` :124,
`_bwd_kernel_fused` :706, `_dq_kernel_single` :602, `_dkv_kernel_single`
:789, and the streamed `_fwd_kernel_stream` :177, `_dq_kernel_stream` :645,
`_dkv_kernel_stream` :835. The kernels live in `csrc/flash_fwd.cu`,
`csrc/flash_bwd.cu` (fused backward), `csrc/flash_bwd_split.cu` (the split
pair flash_dq and flash_dkv, and in its stream form the streamed pair, with
separate query and key segment ids) and `csrc/flash_stream.cu` (the
streamed forward). The dispatch is
the JAX package's: up to P = 2048 the single-block forward and the fused
backward, or the split pair when a bi-causal split is set; above it the
streamed forward and the streamed pair, whatever the split. Conventions
kept from the JAX package: q, k, v are token-major `[B, P, H*Dh]` at the
kernel boundary; GQA is expanded and the softmax scale folded into q (in
q's dtype) before the kernel; RoPE cos/sin `[B, P, Dh]` are cast to q's
dtype and applied in-kernel; lse is `[B, H, P]` fp32; padded rows (segment
0) give out = 0 and lse = -1e30. The autograd Function saves the
un-rotated (qs, k, v) with (out, lse); the backward rotates again
in-kernel and brings dq, dk back through the inverse rotation. Two
differences from the JAX package, both where the mask, not the exponent,
should decide: a padded row takes no part in the backward even when a
non-zero `dlse` reaches it (there its exp(S - lse) = 1 would spread dlse
over every key of the row); and a query row that sees no key (possible
only when the key ids are another array, a ring chunk's) gives out = 0,
where the JAX stream kernel gives the mean of the visited values, and
takes no part in the backward.

The kernel mode, `GGT_FLASH_MODE` read once at import into `_MODE` (tests
set the attribute, as the JAX package's do), routes as `_flash_fwd` :418
and `_flash_bwd` :911 do. `legacy` (the default): the dispatch above.
`band`: up to `_MAX_BAND` = 4096 the band kernels #9 flash_fwd_band and
#10 flash_bwd_band (`_fwd_kernel_band` :282, `_bwd_kernel_band` :484 in
`csrc/flash_band.cu`), whatever the split, the streamed ones above it.
`skip`: the streamed kernels at every P. Under `band` and `skip`
flash_attention rotates q and k outside the kernels (:1249-1255), with
`models/rope.apply_rope`, and autograd carries the rotation's gradient.
Here the port differs: an unknown mode raises, where the JAX package takes
any value it does not know for `legacy`.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch

from . import _build, use_kernel

NEG_INF = -1e30
MAX_P = 2048  # the JAX package's single-block limit; longer rows stream (#6-#8)
REF_ROWS = 512  # query rows at a time in the streamed kernels' plain versions
MODES = ("legacy", "skip", "band")
_MODE = os.environ.get("GGT_FLASH_MODE", "legacy")
_MAX_BAND = 4096  # the longest row the band kernels take (the JAX package's)
BAND_TILE = 64  # the band kernels' q and key tile height


def _mode() -> str:
    """The kernel mode; raises on a value the JAX package does not know."""
    if _MODE not in MODES:
        raise ValueError(f"GGT_FLASH_MODE={_MODE!r}: the modes are {', '.join(MODES)}")
    return _MODE


_mode()
# q, k, v, seg, cos, sin, out, lse; B, P, H, causal, bi_split; stream
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# q, k, v, seg, cos, sin, out, lse, do, dlse, delta, dq, dk, dv; B, P, H, causal; stream
_BWD_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
# q, k, v, seg, cos, sin, out, lse, do, dlse, delta, dq; B, P, H, causal, bi_split; stream
_DQ_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# q, k, v, seg, cos, sin, lse, delta, do, dk, dv; B, P, H, causal, bi_split; stream
_DKV_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# the streamed entries take seg_q, seg_k and the tile-table scratch `tab`:
# q, k, v, seg_q, seg_k, cos, sin, out, lse, tab; B, P, H, causal, bi_split; stream
_FWD_STREAM_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# q, k, v, seg_q, seg_k, cos, sin, out, lse, do, dlse, delta, dq, tab; B, P, H, causal,
# bi_split; stream
_DQ_STREAM_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# q, k, v, seg_q, seg_k, cos, sin, lse, delta, do, dk, dv, tab; B, P, H, causal,
# bi_split; stream
_DKV_STREAM_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# q, k, v, seg_q, seg_k, out, lse, tab; B, P, H, causal, bi_split; stream
_FWD_BAND_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# q, k, v, seg_q, seg_k, out, lse, do, dlse, delta, dq, dk, dv, tab; B, P, H, causal,
# bi_split; stream
_BWD_BAND_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def band_limits(seg_q: torch.Tensor, seg_k: torch.Tensor, tile: int = BAND_TILE):
    """int32 [B, ceil(P/tile), 2]: per tile of `tile` query rows, the first
    and last key positions (lo, hi) whose id lies in the tile's [min
    positive id, max id], or (P, -1) when none does (`_band_limits` :265 at
    key-tile width 1). Every key that a row of the tile can see lies in
    [lo, hi]; the band kernels write the same table and visit only the key
    tiles of that range."""
    b, p = seg_q.shape
    nt = -(-p // tile)
    sq = torch.nn.functional.pad(seg_q.long(), (0, nt * tile - p)).view(b, nt, tile)
    qmax = sq.amax(dim=-1, keepdim=True)
    qmin = torch.where(sq > 0, sq, 2**30).amin(dim=-1, keepdim=True)
    sk = seg_k.long()[:, None, :]
    match = (sk >= qmin) & (sk <= qmax) & (sk > 0)  # [B, nt, P]
    pos = torch.arange(p, device=seg_q.device)
    lo = torch.where(match, pos, p).amin(dim=-1)
    hi = torch.where(match, pos, -1).amax(dim=-1)
    return torch.stack([lo, hi], dim=-1).to(torch.int32)


def _valid_mask(seg: torch.Tensor, causal: bool, bi_causal_split: int = 0,
                seg_k: Optional[torch.Tensor] = None, rows: slice = slice(None),
                band: Optional[torch.Tensor] = None):
    """[B, 1, Pq, P] bool for the query rows `rows` (all by default): the
    query's segment equals the key's nonzero segment (seg_k, the keys' own
    ids where given, else seg), plus the causal or bi-causal rule
    (graphgpt_tpu/ops/attention.py:22 _mask_logits, flash_attention.py:76
    _tile_neg); with a `band` table (band_limits) only the key tiles of
    each query tile's band, as the band kernels visit them."""
    p = seg.shape[-1]
    seg_k = seg if seg_k is None else seg_k
    sq = seg[:, rows]
    valid = (sq[:, None, :, None] == seg_k[:, None, None, :]) & (seg_k[:, None, None, :] > 0)
    idx = torch.arange(p, device=seg.device)
    qi, kj = idx[rows][:, None], idx[None, :]
    if bi_causal_split > 0:
        split = p - bi_causal_split
        valid = valid & (((qi < split) & (kj < split)) | ((qi >= split) & (kj <= qi)))
    elif causal:
        valid = valid & (qi >= kj)
    if band is not None:
        tiles = torch.div(band.long(), BAND_TILE, rounding_mode="floor")  # [B, nt, 2]
        row_band = tiles[:, idx[rows] // BAND_TILE]  # [B, Pq, 2]
        kt = (idx // BAND_TILE)[None, None, :]
        valid = valid & ((kt >= row_band[..., :1]) & (kt <= row_band[..., 1:]))[:, None]
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


def _heads(t: torch.Tensor, dh: int) -> torch.Tensor:
    """Token-major [B, P, H*Dh] -> [B, H, P, Dh] fp32."""
    b, p, hd = t.shape
    return t.reshape(b, p, hd // dh, dh).transpose(1, 2).float()


def _tokens(t):
    """[B, H, P, Dh] -> token-major [B, P, H*Dh]."""
    b, h, p, dh = t.shape
    return t.transpose(1, 2).reshape(b, p, h * dh)


def _fwd_rows(q4, k4, v4, seg, seg_k, causal, bi_causal_split, rows, vdt, band=None):
    """(out [B, H, Pq, Dh] fp32, lse [B, H, Pq]) of the query rows `rows`:
    fp32 logits, softmax over the whole row, probabilities rounded to v's
    dtype `vdt` for the PV product; 0 and -1e30 on a padded row or one that
    sees no key."""
    s = q4[:, :, rows] @ k4.transpose(-1, -2)
    valid = _valid_mask(seg, causal, bi_causal_split, seg_k, rows, band)
    s = s + torch.where(valid, 0.0, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    pij = torch.exp(s - m)
    l = pij.sum(dim=-1, keepdim=True)
    pv = pij.to(vdt).float() @ v4
    rowvalid = (seg[:, rows] > 0)[:, None, :, None] & (m > NEG_INF)
    lse = (m + torch.log(l))[..., 0]
    return torch.where(rowvalid, pv / l, 0.0), torch.where(m[..., 0] <= NEG_INF, NEG_INF, lse)


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
    seg_k: Optional[torch.Tensor] = None,  # the keys' own ids; None: seg
    row_chunk: int = 0,  # > 0: that many query rows at a time
    band: Optional[torch.Tensor] = None,  # band_limits' table: keys of the band only
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernels: (out [B, P, H*Dh], lse [B, H, P]
    fp32), as `_fwd_kernel_single`, `_fwd_kernel_stream` and
    `_fwd_kernel_band` compute them (the online softmax of the streamed and
    band kernels is exact up to fp32 rounding). `row_chunk` bounds the
    [B, H, rows, P] logits of long rows."""
    p = qs.shape[1]
    if cos is not None:
        qs, k = rotate_tokens(qs, cos, sin, dh), rotate_tokens(k, cos, sin, dh)
    q4, k4, v4 = _heads(qs, dh), _heads(k, dh), _heads(v, dh)
    step = row_chunk if row_chunk > 0 else p
    parts = [_fwd_rows(q4, k4, v4, seg, seg_k, causal, bi_causal_split, slice(i, i + step),
                       v.dtype, band) for i in range(0, p, step)]
    out = torch.cat([o for o, _ in parts], dim=2).to(qs.dtype)
    return _tokens(out), torch.cat([l for _, l in parts], dim=2)


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
    """(out, lse), dispatched as `_flash_fwd` does: under `band` up to
    _MAX_BAND the band forward (flash_fwd_band, #9, which takes q and k
    rotated: cos None); under `skip`, or above P = 2048, the streamed
    forward (flash_fwd_stream, #6); else the single-block kernel (#1) for a
    CUDA tensor, its plain version for a CPU tensor (or inside
    ops.reference_mode())."""
    b, p, hd = qs.shape
    mode = _mode()
    if mode == "band" and p <= _MAX_BAND:
        if cos is not None:
            raise ValueError("the band kernels take q and k rotated: cos and sin must be None")
        return flash_fwd_band(qs, k, v, seg, seg, causal, dh, bi_causal_split)
    if mode == "skip" or p > MAX_P:
        return flash_fwd_stream(qs, k, v, seg, seg, cos, sin, causal, dh, bi_causal_split)
    if not use_kernel(qs, k, v, seg):
        return flash_attention_ref(qs, k, v, seg, cos, sin, causal, dh, bi_causal_split)
    (qs, k, v), seg, _, cos, sin = _check_fwd("flash_fwd", dh, qs, k, v, seg, seg, cos, sin)
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


def _tile_scratch(seg_q):
    """int32 scratch for the streamed and band kernels' two tile tables [B,
    ceil(P/64)] of int2 (one when seg_q and seg_k are one array)."""
    b, p = seg_q.shape
    return torch.empty(4 * b * ((p + 63) // 64), dtype=torch.int32, device=seg_q.device)


def _table(tab, b: int, p: int, second: bool = False):
    """The first (or the second) int2 table in _tile_scratch's `tab` as
    int32 [B, ceil(P/64), 2], band_limits' layout."""
    n = 2 * b * ((p + 63) // 64)
    return (tab[n : 2 * n] if second else tab[:n]).view(b, -1, 2)


def flash_fwd_stream_ref(qs, k, v, seg_q, seg_k, cos, sin, causal: bool, dh: int,
                         bi_causal_split: int = 0):
    """Plain version of flash_fwd_stream (`_fwd_kernel_stream`): the forward
    with the keys' own segment ids, REF_ROWS query rows at a time."""
    return flash_attention_ref(qs, k, v, seg_q, cos, sin, causal, dh, bi_causal_split,
                               seg_k=seg_k, row_chunk=REF_ROWS)


def flash_fwd_stream(qs, k, v, seg_q, seg_k, cos, sin, causal: bool, dh: int,
                     bi_causal_split: int = 0):
    """(out, lse) of the streamed forward (#6) with query ids seg_q and key
    ids seg_k [B, P] (one tensor twice for a model's rows): the CUDA kernel
    for a CUDA tensor, the plain version for a CPU tensor (or inside
    ops.reference_mode()). Any P."""
    if not use_kernel(qs, k, v, seg_q, seg_k):
        return flash_fwd_stream_ref(qs, k, v, seg_q, seg_k, cos, sin, causal, dh,
                                    bi_causal_split)
    b, p, hd = qs.shape
    (qs, k, v), seg_q, seg_k, cos, sin = _check_fwd("flash_fwd_stream", dh, qs, k, v, seg_q,
                                                    seg_k, cos, sin)
    out = torch.empty_like(qs)
    lse = torch.empty((b, hd // dh, p), dtype=torch.float32, device=qs.device)
    fn = _build.entry("flash_stream", "ggt_flash_fwd_stream", _FWD_STREAM_ARGTYPES)
    err = fn(
        _build.ptr(qs), _build.ptr(k), _build.ptr(v), _build.ptr(seg_q), _build.ptr(seg_k),
        _opt_ptr(cos), _opt_ptr(sin), _build.ptr(out), _build.ptr(lse),
        _build.ptr(_tile_scratch(seg_q)), b, p, hd // dh, int(causal), int(bi_causal_split),
        _build.stream_ptr(qs.device),
    )
    flash_fwd_stream.launches += 1
    _build.check(err, "flash_fwd_stream")
    return out, lse


flash_fwd_stream.launches = 0


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


def zero_padded_rows(do: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """do with its padded rows (segment 0) taken as zero, as
    `_bwd_kernel_fused` (:748-753) and the CUDA kernels take it before delta
    and any product: a non-finite value there reaches no output. The plain
    routes of flash_bwd and flash_dq take it from here; the streamed (#7)
    and band (#10) plain routes sum delta from the raw do, as the JAX
    package's outside-kernel delta (:933-940) does."""
    return torch.where((seg > 0)[..., None], do, torch.zeros((), dtype=do.dtype, device=do.device))


def flash_delta(do, out, dlse, dh: int) -> torch.Tensor:
    """delta [B, H, P] fp32 = rowsum(do * out) - dlse in torch ops, as the
    JAX package's split backward computes it outside the kernels
    (`_flash_bwd` :933-940): the plain version of the delta kernel that
    flash_bwd and flash_bwd_band launch first, and of the sum that the
    kernels of flash_dq and flash_dq_stream take for their own rows. out is
    0 on padded rows, which the kernels leave out anyway."""
    b, p, hd = do.shape
    delta = (do.float() * out.float()).view(b, p, hd // dh, dh).sum(dim=-1).transpose(1, 2)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.contiguous()


def _bwd_grads(qs, k, v, seg, cos, sin, lse, delta, do, causal: bool, dh: int,
               bi_causal_split: int, seg_k=None, want_dq: bool = True, want_dkv: bool = True,
               row_chunk: int = 0, band=None):
    """(dq, dk, dv) of every backward twin, None where not wanted, at the
    kernels' rounding points: rot(q), rot(k), v and do (zero on padded
    rows) per head in fp32 with cos and sin in the working dtype; for each
    `row_chunk` query rows (all at once by default) p = exp(S - lse) where
    the mask lets the pair through (zero elsewhere and on padded rows) and
    ds = p*(do v^T - delta) rounded to the working dtype; dq = ds rot(k),
    dv = bf16(p)^T do and dk = ds^T rot(q) summed in fp32, dq and dk through
    the inverse rotation, each rounded once."""
    dt = qs.dtype
    if cos is not None:
        cos, sin = cos.to(dt), sin.to(dt)
        qs, k = rotate_tokens(qs, cos, sin, dh), rotate_tokens(k, cos, sin, dh)
    do = zero_padded_rows(do, seg)
    q4, k4, v4, do4 = _heads(qs, dh), _heads(k, dh), _heads(v, dh), _heads(do.to(dt), dh)
    delta = delta.float()

    def back(x):
        x = _tokens(x)
        return (x if cos is None else unrotate_tokens(x, cos, sin, dh)).to(dt)

    p = qs.shape[1]
    step = row_chunk or p
    dq, dk, dv = [], 0.0, 0.0
    for i in range(0, p, step):
        sl = slice(i, i + step)
        valid = _valid_mask(seg, causal, bi_causal_split, seg_k, sl, band)
        valid = valid & (seg[:, sl] > 0)[:, None, :, None]
        pij = torch.where(valid, torch.exp(q4[:, :, sl] @ k4.transpose(-1, -2)
                                           - lse[:, :, sl, None]), 0.0)
        ds = (pij * (do4[:, :, sl] @ v4.transpose(-1, -2) - delta[:, :, sl, None])).to(dt).float()
        if want_dq:
            dq.append(ds @ k4)
        if want_dkv:
            dv = dv + pij.to(dt).float().transpose(-1, -2) @ do4[:, :, sl]
            dk = dk + ds.transpose(-1, -2) @ q4[:, :, sl]
    return (back(torch.cat(dq, dim=2)) if want_dq else None,
            back(dk) if want_dkv else None, _tokens(dv).to(dt) if want_dkv else None)


def flash_bwd_ref(
    qs, k, v, seg, cos, sin, out, lse, do, dlse, causal: bool, dh: int,
    bi_causal_split: int = 0,
):
    """Plain version of the backward kernel, from `_bwd_kernel_fused`'s
    formula with its rounding points: (dq, dk, dv) token-major in qs's dtype.
    p = exp(S - lse); delta = rowsum(do*out) - dlse in fp32; p rounded to the
    working dtype for dv = p^T do; ds = p*(do v^T - delta) rounded for
    dq = ds rot(k) and dk = ds^T rot(q); the inverse rotation on the fp32
    sums, rounded once. Padded rows take no part: do is zero there before
    delta is summed."""
    do = zero_padded_rows(do, seg)
    delta = flash_delta(do.to(qs.dtype), out, dlse, dh)
    return _bwd_grads(qs, k, v, seg, cos, sin, lse, delta, do, causal, dh, bi_causal_split)


def _check_segs(name, seg_q, seg_k, b, p):
    """seg_q and seg_k as contiguous int32 [B, P]; one tensor for both when
    they were one array (the streamed kernels then build one tile table)."""
    same = seg_k is seg_q or (seg_k.data_ptr() == seg_q.data_ptr()
                              and seg_k.dtype == seg_q.dtype and seg_k.shape == seg_q.shape
                              and seg_k.stride() == seg_q.stride())
    seg_q = seg_q.to(torch.int32).contiguous()
    seg_k = seg_q if same else seg_k.to(torch.int32).contiguous()
    if seg_q.shape != (b, p) or seg_k.shape != (b, p):
        raise ValueError(f"{name}: seg_q {tuple(seg_q.shape)} and seg_k "
                         f"{tuple(seg_k.shape)} must be [B, P] = {(b, p)}")
    return seg_q, seg_k


def _check_fwd(name, dh, qs, k, v, seg_q, seg_k, cos, sin):
    """The checks and layouts every forward kernel needs: ((qs, k, v)
    contiguous, seg_q, seg_k, cos, sin). Raises on what the kernels do not
    take."""
    b, p, _ = qs.shape
    if dh != 64 or qs.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"the flash kernel takes bf16 with head_dim 64, got {qs.dtype}, {dh}"
        )
    tok = tuple(t.contiguous() for t in (qs, k, v))
    if any(t.shape != qs.shape for t in tok):
        raise ValueError(f"{name}: shapes {[tuple(t.shape) for t in tok]}")
    seg_q, seg_k = _check_segs(name, seg_q, seg_k, b, p)
    cos, sin = _check_rope(cos, sin, b, p, dh)
    _check_aligned(name, *tok, cos, sin)
    return tok, seg_q, seg_k, cos, sin


def _check_bwd(name, dh, qs, k, v, seg, cos, sin, lse, do, extra=(), extra_rows=(),
               seg_k=None):
    """The checks and layouts every backward kernel needs: ((qs, k, v, do,
    extra...) contiguous, seg and seg_k (seg unless given), cos, sin, (lse,
    extra_rows...) fp32 [B, H, P]). Raises on what the kernels do not
    take."""
    b, p, hd = qs.shape
    tok = (qs, k, v, do) + tuple(extra)
    if dh != 64 or any(t.dtype != torch.bfloat16 for t in tok):
        raise NotImplementedError(f"{name} takes bf16 with head_dim 64, got {qs.dtype}, {dh}")
    tok = tuple(t.contiguous() for t in tok)
    if any(t.shape != qs.shape for t in tok):
        raise ValueError(f"{name}: token-major shapes {[tuple(t.shape) for t in tok]}")
    seg, seg_k = _check_segs(name, seg, seg if seg_k is None else seg_k, b, p)
    rows = tuple(r.float().contiguous() for r in (lse,) + tuple(extra_rows))
    if any(r.shape != (b, hd // dh, p) for r in rows):
        raise ValueError(f"{name}: lse and row statistics must be [B, H, P] = "
                         f"{(b, hd // dh, p)}, got {[tuple(r.shape) for r in rows]}")
    cos, sin = _check_rope(cos, sin, b, p, dh)
    _check_aligned(name, *tok, cos, sin)
    return tok, seg, seg_k, cos, sin, rows


def flash_bwd(
    qs, k, v, seg, cos, sin, out, lse, do, dlse, causal: bool, dh: int,
    bi_causal_split: int = 0,
):
    """(dq, dk, dv), dispatched as `_flash_bwd` does (:911, :941): under
    `band` up to _MAX_BAND the band backward (flash_bwd_band, #10, with its
    delta) whatever the split; under `skip`, or above P = 2048, the
    streamed pair (flash_dq_stream, which gives delta too, then
    flash_dkv_stream) whatever the split; else with a bi-causal split, or
    under `band` above its limit (which never takes the fused kernel), the
    split pair flash_dq, flash_dkv; else the fused CUDA kernel (a small
    delta kernel and the main one, counted as one call) for a CUDA tensor,
    the plain version for a CPU tensor (or inside ops.reference_mode()).
    dlse [B, H, P] is the optional cotangent of lse; None means zeros."""
    mode = _mode()
    if mode == "band" and qs.shape[1] <= _MAX_BAND:
        if cos is not None:
            raise ValueError("the band kernels take q and k rotated: cos and sin must be None")
        return flash_bwd_band(qs, k, v, seg, seg, out, lse, do, dlse, causal, dh,
                              bi_causal_split)
    if mode == "skip" or qs.shape[1] > MAX_P:
        dq, delta = flash_dq_stream(qs, k, v, seg, seg, cos, sin, out, lse, do, dlse, causal,
                                    dh, bi_causal_split)
        dk, dv = flash_dkv_stream(qs, k, v, seg, seg, cos, sin, lse, delta, do, causal, dh,
                                  bi_causal_split)
        return dq, dk, dv
    if bi_causal_split > 0 or mode != "legacy":
        dq, delta = flash_dq(qs, k, v, seg, cos, sin, out, lse, do, dlse, causal, dh,
                             bi_causal_split)
        dk, dv = flash_dkv(qs, k, v, seg, cos, sin, lse, delta, do, causal, dh, bi_causal_split)
        return dq, dk, dv
    if not use_kernel(qs, k, v, seg, out, lse, do):
        return flash_bwd_ref(qs, k, v, seg, cos, sin, out, lse, do, dlse, causal, dh)
    b, p, hd = qs.shape
    extra_rows = () if dlse is None else (dlse,)
    (qs, k, v, do, out), seg, _, cos, sin, rows = _check_bwd(
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


def _check_split_p(name, p: int) -> None:
    """The split pair's kernels (the single form) hold an item's visiting
    tiles in one 32-bit mask: P <= MAX_P (flash_bwd sends longer rows to the
    streamed pair, the same body's stream form)."""
    if p > MAX_P:
        raise NotImplementedError(f"{name} takes P <= {MAX_P}, got {p}")


def flash_dq_ref(qs, k, v, seg, cos, sin, lse, delta, do, causal: bool, dh: int,
                 bi_causal_split: int = 0):
    """Plain version of flash_dq (`_dq_kernel_single`): dq = ds rot(k) with
    ds = p*(do v^T - delta) rounded to the working dtype, the inverse
    rotation on the fp32 sum, rounded once; 0 on padded rows."""
    return _bwd_grads(qs, k, v, seg, cos, sin, lse, delta, do, causal, dh, bi_causal_split,
                      want_dkv=False)[0]


def flash_dkv_ref(qs, k, v, seg, cos, sin, lse, delta, do, causal: bool, dh: int,
                  bi_causal_split: int = 0):
    """Plain version of flash_dkv (`_dkv_kernel_single`): (dk, dv) with
    dv = p^T do (p rounded to the working dtype) and dk = ds^T rot(q), dk
    through the inverse rotation; padded rows take no part."""
    return _bwd_grads(qs, k, v, seg, cos, sin, lse, delta, do, causal, dh, bi_causal_split,
                      want_dq=False)[1:]


def flash_dq(qs, k, v, seg, cos, sin, out, lse, do, dlse, causal: bool, dh: int,
             bi_causal_split: int = 0):
    """(dq, delta), delta = rowsum(do * out) - dlse [B, H, P] fp32 for
    flash_dkv: the CUDA kernel (#4, which sums delta for its own rows and
    writes it beside dq: one launch) for a CUDA tensor, flash_delta and
    flash_dq_ref for a CPU tensor (or inside ops.reference_mode()). dlse
    None means zeros. The kernel takes P <= MAX_P. Both take do as zero on
    padded rows, so that a non-finite value there reaches neither dq nor
    delta, nor flash_dkv's sums."""
    if not use_kernel(qs, k, v, seg, out, lse, do):
        do = zero_padded_rows(do, seg)
        delta = flash_delta(do, out, dlse, dh)
        return flash_dq_ref(qs, k, v, seg, cos, sin, lse, delta, do, causal, dh,
                            bi_causal_split), delta
    b, p, _ = qs.shape
    _check_split_p("flash_dq", p)
    extra_rows = () if dlse is None else (dlse,)
    (qs, k, v, do, out), seg, _, cos, sin, rows = _check_bwd(
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
    """(dk, dv): the CUDA kernel (#5, reading flash_dq's delta) for a CUDA
    tensor, the plain version for a CPU tensor (or inside
    ops.reference_mode()). The kernel takes P <= MAX_P."""
    if not use_kernel(qs, k, v, seg, lse, delta, do):
        return flash_dkv_ref(qs, k, v, seg, cos, sin, lse, delta, do, causal, dh,
                             bi_causal_split)
    b, p, _ = qs.shape
    _check_split_p("flash_dkv", p)
    (qs, k, v, do), seg, _, cos, sin, (lse, delta) = _check_bwd(
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


def flash_dq_stream_ref(qs, k, v, seg_q, seg_k, cos, sin, lse, delta, do, causal: bool,
                        dh: int, bi_causal_split: int = 0):
    """Plain version of flash_dq_stream (`_dq_kernel_stream`): flash_dq_ref's
    formula with the keys' own segment ids, REF_ROWS query rows at a time."""
    return _bwd_grads(qs, k, v, seg_q, cos, sin, lse, delta, do, causal, dh, bi_causal_split,
                      seg_k, want_dkv=False, row_chunk=REF_ROWS)[0]


def flash_dkv_stream_ref(qs, k, v, seg_q, seg_k, cos, sin, lse, delta, do, causal: bool,
                         dh: int, bi_causal_split: int = 0):
    """Plain version of flash_dkv_stream (`_dkv_kernel_stream`):
    flash_dkv_ref's formula with the keys' own segment ids, summed over
    REF_ROWS query rows at a time."""
    return _bwd_grads(qs, k, v, seg_q, cos, sin, lse, delta, do, causal, dh, bi_causal_split,
                      seg_k, want_dq=False, row_chunk=REF_ROWS)[1:]


def flash_dq_stream(qs, k, v, seg_q, seg_k, cos, sin, out, lse, do, dlse, causal: bool,
                    dh: int, bi_causal_split: int = 0):
    """(dq, delta) of the streamed pair's first kernel (#7): the CUDA
    kernels (the tile tables, then dq with delta summed for its own rows;
    counted as one call) for a CUDA tensor, flash_delta and
    flash_dq_stream_ref for a CPU tensor (or inside ops.reference_mode()).
    dlse None means zeros. Any P."""
    if not use_kernel(qs, k, v, seg_q, seg_k, out, lse, do):
        delta = flash_delta(do, out, dlse, dh)
        return flash_dq_stream_ref(qs, k, v, seg_q, seg_k, cos, sin, lse, delta, do, causal,
                                   dh, bi_causal_split), delta
    b, p, _ = qs.shape
    extra_rows = () if dlse is None else (dlse,)
    (qs, k, v, do, out), seg_q, seg_k, cos, sin, rows = _check_bwd(
        "flash_dq_stream", dh, qs, k, v, seg_q, cos, sin, lse, do, extra=(out,),
        extra_rows=extra_rows, seg_k=seg_k)
    lse, dlse = rows[0], (rows[1] if dlse is not None else None)
    dq, delta = torch.empty_like(qs), torch.empty_like(lse)
    fn = _build.entry("flash_bwd_split", "ggt_flash_dq_stream", _DQ_STREAM_ARGTYPES)
    err = fn(
        _build.ptr(qs), _build.ptr(k), _build.ptr(v), _build.ptr(seg_q), _build.ptr(seg_k),
        _opt_ptr(cos), _opt_ptr(sin), _build.ptr(out), _build.ptr(lse), _build.ptr(do),
        _opt_ptr(dlse), _build.ptr(delta), _build.ptr(dq), _build.ptr(_tile_scratch(seg_q)),
        b, p, lse.shape[1], int(causal), int(bi_causal_split), _build.stream_ptr(qs.device),
    )
    flash_dq_stream.launches += 1
    _build.check(err, "flash_dq_stream")
    return dq, delta


flash_dq_stream.launches = 0


def flash_dkv_stream(qs, k, v, seg_q, seg_k, cos, sin, lse, delta, do, causal: bool,
                     dh: int, bi_causal_split: int = 0):
    """(dk, dv) of the streamed pair's second kernel (#8), reading
    flash_dq_stream's delta: the CUDA kernels (the tile tables, then dk and
    dv; counted as one call) for a CUDA tensor, the plain version for a CPU
    tensor (or inside ops.reference_mode()). Any P."""
    if not use_kernel(qs, k, v, seg_q, seg_k, lse, delta, do):
        return flash_dkv_stream_ref(qs, k, v, seg_q, seg_k, cos, sin, lse, delta, do, causal,
                                    dh, bi_causal_split)
    b, p, _ = qs.shape
    (qs, k, v, do), seg_q, seg_k, cos, sin, (lse, delta) = _check_bwd(
        "flash_dkv_stream", dh, qs, k, v, seg_q, cos, sin, lse, do, extra_rows=(delta,),
        seg_k=seg_k)
    dk, dv = torch.empty_like(qs), torch.empty_like(qs)
    fn = _build.entry("flash_bwd_split", "ggt_flash_dkv_stream", _DKV_STREAM_ARGTYPES)
    err = fn(
        _build.ptr(qs), _build.ptr(k), _build.ptr(v), _build.ptr(seg_q), _build.ptr(seg_k),
        _opt_ptr(cos), _opt_ptr(sin), _build.ptr(lse), _build.ptr(delta), _build.ptr(do),
        _build.ptr(dk), _build.ptr(dv), _build.ptr(_tile_scratch(seg_q)), b, p, lse.shape[1],
        int(causal), int(bi_causal_split), _build.stream_ptr(qs.device),
    )
    flash_dkv_stream.launches += 1
    _build.check(err, "flash_dkv_stream")
    return dk, dv


flash_dkv_stream.launches = 0


def flash_fwd_band_ref(qs, k, v, seg_q, seg_k, causal: bool, dh: int,
                       bi_causal_split: int = 0):
    """Plain version of flash_fwd_band (`_fwd_kernel_band`): the forward with
    the keys' own segment ids over each query tile's band of keys
    (band_limits), REF_ROWS query rows at a time; q and k come rotated."""
    return flash_attention_ref(qs, k, v, seg_q, None, None, causal, dh, bi_causal_split,
                               seg_k=seg_k, row_chunk=REF_ROWS, band=band_limits(seg_q, seg_k))


def flash_fwd_band(qs, k, v, seg_q, seg_k, causal: bool, dh: int, bi_causal_split: int = 0,
                   aux: Optional[dict] = None):
    """(out, lse) of the band forward (#9) with query ids seg_q and key ids
    seg_k [B, P] (one tensor twice for a model's rows), q pre-scaled and q,
    k already rotated: the CUDA kernels (the band table, then the forward;
    counted as one call) for a CUDA tensor, the plain version for a CPU
    tensor (or inside ops.reference_mode()). `aux`, when given, receives
    the band table the kernel used (int32 [B, ceil(P/64), 2], band_limits'
    layout) under "table"."""
    if not use_kernel(qs, k, v, seg_q, seg_k):
        if aux is not None:
            aux["table"] = band_limits(seg_q, seg_k)
        return flash_fwd_band_ref(qs, k, v, seg_q, seg_k, causal, dh, bi_causal_split)
    b, p, hd = qs.shape
    (qs, k, v), seg_q, seg_k, _, _ = _check_fwd("flash_fwd_band", dh, qs, k, v, seg_q, seg_k,
                                                None, None)
    out = torch.empty_like(qs)
    lse = torch.empty((b, hd // dh, p), dtype=torch.float32, device=qs.device)
    tab = _tile_scratch(seg_q)
    fn = _build.entry("flash_band", "ggt_flash_fwd_band", _FWD_BAND_ARGTYPES)
    err = fn(
        _build.ptr(qs), _build.ptr(k), _build.ptr(v), _build.ptr(seg_q), _build.ptr(seg_k),
        _build.ptr(out), _build.ptr(lse), _build.ptr(tab), b, p, hd // dh, int(causal),
        int(bi_causal_split), _build.stream_ptr(qs.device),
    )
    flash_fwd_band.launches += 1
    _build.check(err, "flash_fwd_band")
    if aux is not None:
        aux["table"] = _table(tab, b, p)
    return out, lse


flash_fwd_band.launches = 0


def flash_bwd_band_ref(qs, k, v, seg_q, seg_k, lse, delta, do, causal: bool, dh: int,
                       bi_causal_split: int = 0):
    """Plain version of flash_bwd_band (`_bwd_kernel_band`): (dq, dk, dv)
    with flash_bwd_ref's rounding points, the keys' own segment ids and each
    query tile's band of keys, REF_ROWS query rows at a time; q and k come
    rotated. Padded rows take no part."""
    return _bwd_grads(qs, k, v, seg_q, None, None, lse, delta, do, causal, dh, bi_causal_split,
                      seg_k, row_chunk=REF_ROWS, band=band_limits(seg_q, seg_k))


def flash_bwd_band(qs, k, v, seg_q, seg_k, out, lse, do, dlse, causal: bool, dh: int,
                   bi_causal_split: int = 0, aux: Optional[dict] = None):
    """(dq, dk, dv) of the band backward (#10), q and k rotated, delta =
    rowsum(do * out) - dlse computed outside its main kernel as the JAX
    package does (:933-940): the CUDA kernels (both band tables, the delta
    kernel, then dq, dk, dv; counted as one call) for a CUDA tensor,
    flash_delta and the plain version for a CPU tensor (or inside
    ops.reference_mode()). dlse None means zeros. `aux`, when given,
    receives "delta" [B, H, P] and the key tiles' band table "table_k"."""
    if not use_kernel(qs, k, v, seg_q, seg_k, out, lse, do):
        delta = flash_delta(do, out, dlse, dh)
        if aux is not None:
            aux["delta"], aux["table_k"] = delta, band_limits(seg_k, seg_q)
        return flash_bwd_band_ref(qs, k, v, seg_q, seg_k, lse, delta, do, causal, dh,
                                  bi_causal_split)
    b, p, _ = qs.shape
    extra_rows = () if dlse is None else (dlse,)
    (qs, k, v, do, out), seg_q, seg_k, _, _, rows = _check_bwd(
        "flash_bwd_band", dh, qs, k, v, seg_q, None, None, lse, do, extra=(out,),
        extra_rows=extra_rows, seg_k=seg_k)
    lse, dlse = rows[0], (rows[1] if dlse is not None else None)
    dq, dk, dv = torch.empty_like(qs), torch.empty_like(qs), torch.empty_like(qs)
    delta = torch.empty_like(lse)
    tab = _tile_scratch(seg_q)
    fn = _build.entry("flash_band", "ggt_flash_bwd_band", _BWD_BAND_ARGTYPES)
    err = fn(
        _build.ptr(qs), _build.ptr(k), _build.ptr(v), _build.ptr(seg_q), _build.ptr(seg_k),
        _build.ptr(out), _build.ptr(lse), _build.ptr(do), _opt_ptr(dlse), _build.ptr(delta),
        _build.ptr(dq), _build.ptr(dk), _build.ptr(dv), _build.ptr(tab), b, p, lse.shape[1],
        int(causal), int(bi_causal_split), _build.stream_ptr(qs.device),
    )
    flash_bwd_band.launches += 1
    _build.check(err, "flash_bwd_band")
    if aux is not None:
        aux["delta"], aux["table_k"] = delta, _table(tab, b, p, second=seg_k is not seg_q)
    return dq, dk, dv


flash_bwd_band.launches = 0


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
    kernels with in-kernel RoPE; under the `band` and `skip` modes q and k
    are rotated first, outside the kernels (:1249-1255). `stash`: see
    `_FlashAttention`."""
    if rope is not None and _mode() in ("band", "skip"):
        from ..models.rope import apply_rope

        q, k = apply_rope(q, k, rope[0], rope[1])
        rope = None
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
