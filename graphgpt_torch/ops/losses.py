"""Masked cross-entropy over stacked next-n labels, InfoNCE and the
fine-tune losses.

Counterpart of `graphgpt_tpu/ops/losses.py` (`chunked_stacked_ce` :39,
`masked_mean_ce` :118, `regression_loss` :131, `single_label_ce` :142,
`multi_label_bce` :150, `pairwise_auc_loss` :164, `info_nce` :176 on one
process). Logits are formed
chunk by chunk along P, each chunk rematerialised in the backward, so the
largest logits tensor is one chunk of [B, c, N, V] in either direction.
The JAX package's chunk is 128 positions; the port's is smaller where
B * 128 * N * V would pass LOGITS_BUDGET elements (a 33k vocab over 128
rows of 12 stacked features asked for 24 GiB at 128), the last chunk
ragged.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

_EPS = 1e-7
LOGITS_BUDGET = 1 << 29  # elements of one chunk's logits [B, c, N, V]


def _ce_from_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-element CE in fp32; labels < 0 read class 0 (weighted out later).
    A label past the last class picks no logit, so its CE is the logsumexp
    alone, as the JAX package's compare-select gives it (the denoise
    model's 3D-SMTP labels reach two past its head)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    v = logits.shape[-1]
    lab = labels.clamp(min=0).long()
    picked = logits.gather(-1, lab.clamp(max=v - 1)[..., None])[..., 0]
    return lse - torch.where(lab < v, picked, 0.0)


def chunked_stacked_ce(
    hidden: torch.Tensor,  # [B, P, D]
    labels: torch.Tensor,  # [B, P, N], -100 = ignore
    n_token_proj: Optional[torch.Tensor],  # nn.Linear weight [N*D, D] or None
    lm_head: torch.Tensor,  # nn.Linear weight [V, D]
    *,
    token_wgt: Optional[torch.Tensor] = None,  # [B, P, N]
    dlm_normalizer: Optional[float] = None,
    focal_gamma: float = 0.0,
    label_smoothing: float = 0.0,
    chunk: int = 128,
) -> torch.Tensor:
    """Masked (optionally dLM-normalised) mean CE; weights cast to the
    hidden dtype, logits rounded to it as in the JAX package."""
    b, p, d = hidden.shape
    n = labels.shape[-1]
    if p % chunk:
        chunk = p
    chunk = min(chunk, max(1, LOGITS_BUDGET // (b * n * lm_head.shape[0])))
    dt = hidden.dtype
    if token_wgt is None:
        token_wgt = torch.ones((b, p, n), dtype=torch.float32, device=hidden.device)
    token_wgt = token_wgt.float().expand(b, p, n)

    def chunk_fn(h, lab, w):
        # h [B, c, D] -> logits [B, c, N, V]. The casts sit inside the chunk
        # so that each chunk's weight gradient reaches the fp32 master on
        # its own and the chunks are summed in fp32.
        if n_token_proj is not None:
            h = F.linear(h, n_token_proj.to(dt)).reshape(b, h.shape[1], n, d)
        else:
            h = h[:, :, None, :]
        logits = F.linear(h, lm_head.to(dt))
        ce = _ce_from_logits(logits, lab)
        if label_smoothing > 0:
            smooth = -F.log_softmax(logits.float(), dim=-1).mean(dim=-1)
            ce = (1 - label_smoothing) * ce + label_smoothing * smooth
        if focal_gamma > 0:
            ce = ((1 - torch.exp(-ce)) ** focal_gamma) * ce
        w = (lab != -100).float() * w
        return (ce * w).sum(), w.sum()

    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (hidden, lm_head, n_token_proj)
    )
    loss_sum = hidden.new_zeros((), dtype=torch.float32)
    wgt_sum = hidden.new_zeros((), dtype=torch.float32)
    for c0 in range(0, p, chunk):
        args = (hidden[:, c0 : c0 + chunk], labels[:, c0 : c0 + chunk],
                token_wgt[:, c0 : c0 + chunk])
        if needs_grad:
            ls, ws = torch.utils.checkpoint.checkpoint(
                chunk_fn, *args, use_reentrant=False, preserve_rng_state=False
            )
        else:
            ls, ws = chunk_fn(*args)
        loss_sum = loss_sum + ls
        wgt_sum = wgt_sum + ws
    if dlm_normalizer is not None:
        return loss_sum / dlm_normalizer
    return loss_sum / (wgt_sum + _EPS)


def masked_mean_ce(
    logits: torch.Tensor, labels: torch.Tensor, wgt: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Plain masked-mean CE for small logit tensors."""
    ce = _ce_from_logits(logits, labels)
    valid = (labels != -100).float()
    w = valid if wgt is None else valid * wgt
    return (ce * w).sum() / (w.sum() + _EPS)


def regression_loss(preds, targets, kind: str = "l1", sample_wgt=None) -> torch.Tensor:
    """Mean absolute (l1) or squared error in fp32, optionally weighted per
    sample."""
    preds = preds.float().reshape(targets.shape)
    err = preds - targets.float()
    per = err.abs() if kind == "l1" else err * err
    if sample_wgt is not None:
        w = sample_wgt.reshape(-1, *([1] * (per.dim() - 1))).float()
        return (per * w).sum() / (w.expand(per.shape).sum() + _EPS)
    return per.mean()


def single_label_ce(logits, labels, sample_wgt=None) -> torch.Tensor:
    ce = _ce_from_logits(logits, labels)
    if sample_wgt is not None:
        w = sample_wgt.float()
        return (ce * w).sum() / (w.sum() + _EPS)
    return ce.mean()


def multi_label_bce(logits, labels, sample_wgt=None) -> torch.Tensor:
    """BCE with logits over several binary tasks; NaN labels are masked out."""
    logits, labels = logits.float(), labels.float()
    valid = torch.isfinite(labels)
    y = torch.where(valid, labels, 0.0)
    per = logits.clamp(min=0) - logits * y + torch.log1p(torch.exp(-logits.abs()))
    w = valid.float()
    if sample_wgt is not None:
        w = w * sample_wgt.reshape(-1, 1).float()
    return (per * w).sum() / (w.sum() + _EPS)


def pairwise_auc_loss(logits, labels, num_neg: int = 1) -> torch.Tensor:
    """Squared pairwise AUC surrogate over groups of one positive followed by
    its `num_neg` negatives: mean((1 - (s+ - s-))^2)."""
    scores = logits.float().reshape(-1)
    group = num_neg + 1
    n_group = scores.shape[0] // group
    s = scores[: n_group * group].reshape(n_group, group)
    return (1.0 - (s[:, :1] - s[:, 1:])).square().mean()


def info_nce(left: torch.Tensor, right: torch.Tensor, temperature: float = 0.07) -> torch.Tensor:
    """Symmetric InfoNCE between normalised [B/2, D] embeddings over this
    process's batch (the JAX package's `axis_name=None`)."""
    logits = (left @ right.t()).float() / temperature
    labels = torch.arange(logits.shape[0], device=logits.device)
    return 0.5 * (masked_mean_ce(logits, labels) + masked_mean_ce(logits.t(), labels))
