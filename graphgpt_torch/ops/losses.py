"""Masked cross-entropy over stacked next-n labels (forward only).

Counterpart of `graphgpt_tpu/ops/losses.py:20-115`. Logits are formed chunk
by chunk along P, so the largest logits tensor is one chunk of
[B, c, N, V].
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

_EPS = 1e-7


def _ce_from_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-element CE in fp32; labels < 0 read class 0 (weighted out later)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0]
    return lse - picked


def chunked_stacked_ce(
    hidden: torch.Tensor,  # [B, P, D]
    labels: torch.Tensor,  # [B, P, N], -100 = ignore
    n_token_proj: Optional[torch.Tensor],  # nn.Linear weight [N*D, D] or None
    lm_head: torch.Tensor,  # nn.Linear weight [V, D]
    *,
    token_wgt: Optional[torch.Tensor] = None,  # [B, P, N]
    dlm_normalizer: Optional[float] = None,
    focal_gamma: float = 0.0,
    chunk: int = 128,
) -> torch.Tensor:
    """Masked (optionally dLM-normalised) mean CE; weights cast to the
    hidden dtype, logits rounded to it as in the JAX package."""
    b, p, d = hidden.shape
    n = labels.shape[-1]
    if p % chunk:
        chunk = p
    dt = hidden.dtype
    proj = n_token_proj.to(dt) if n_token_proj is not None else None
    head = lm_head.to(dt)
    if token_wgt is None:
        token_wgt = torch.ones((b, p, n), dtype=torch.float32, device=hidden.device)
    token_wgt = token_wgt.float().expand(b, p, n)
    loss_sum = hidden.new_zeros((), dtype=torch.float32)
    wgt_sum = hidden.new_zeros((), dtype=torch.float32)
    for c0 in range(0, p, chunk):
        h = hidden[:, c0 : c0 + chunk]
        lab = labels[:, c0 : c0 + chunk]
        if proj is not None:
            h = F.linear(h, proj).reshape(b, chunk, n, d)
        else:
            h = h[:, :, None, :]
        ce = _ce_from_logits(F.linear(h, head), lab)
        if focal_gamma > 0:
            ce = ((1 - torch.exp(-ce)) ** focal_gamma) * ce
        w = (lab != -100).float() * token_wgt[:, c0 : c0 + chunk]
        loss_sum = loss_sum + (ce * w).sum()
        wgt_sum = wgt_sum + w.sum()
    if dlm_normalizer is not None:
        return loss_sum / dlm_normalizer
    return loss_sum / (wgt_sum + _EPS)
