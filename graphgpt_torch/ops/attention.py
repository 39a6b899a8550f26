"""Attention dispatch: the flash kernel, and the plain masked attention.

Counterpart of `graphgpt_tpu/ops/attention.py`. The mask comes from
`segment_ids` (0 = padding, equal nonzero ids = one packed segment) plus a
causal or bi-causal rule; no [P, P] mask leaves the attention functions.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import NEG_INF, _valid_mask, flash_attention


def attention_ref(
    q: torch.Tensor,  # [B, P, H, Dh], already rotated
    k: torch.Tensor,  # [B, P, Hkv, Dh]
    v: torch.Tensor,
    segment_ids: torch.Tensor,  # [B, P]
    causal: bool = False,
    softmax_scale: Optional[float] = None,
    bi_causal_split: int = 0,
) -> torch.Tensor:
    """Plain masked attention with fp32 logits and softmax (the twin of
    `xla_attention`); fully padded rows give 0."""
    b, p, h, dh = q.shape
    hkv = k.shape[2]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    scale = softmax_scale if softmax_scale is not None else dh**-0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    valid = _valid_mask(segment_ids, causal, bi_causal_split)
    probs = torch.softmax(torch.where(valid, logits, NEG_INF), dim=-1)
    probs = torch.where((segment_ids > 0)[:, None, :, None], probs, 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def attention(
    q, k, v, segment_ids, causal: bool = False,
    softmax_scale: Optional[float] = None, bi_causal_split: int = 0,
    attn_block: int = 0, rope=None,
):
    """The flash path for every device: the kernel for a CUDA tensor (no
    length crossover), its plain version for a CPU tensor.

    attn_block > 0 declares that no packed segment crosses an attn_block
    boundary, so rows are cut into [B*P/G, G] windows first."""
    b, p, h, dh = q.shape
    if attn_block and p > attn_block and p % attn_block == 0 and bi_causal_split == 0:
        g = attn_block

        def rs(x):
            return x.reshape((b * (p // g), g) + tuple(x.shape[2:]))

        out = attention(
            rs(q), rs(k), rs(v), rs(segment_ids), causal=causal,
            softmax_scale=softmax_scale,
            rope=None if rope is None else (rs(rope[0]), rs(rope[1])),
        )
        return out.reshape(b, p, h, dh)
    return flash_attention(
        q, k, v, segment_ids, causal=causal, softmax_scale=softmax_scale,
        bi_causal_split=bi_causal_split, rope=rope,
    )
