"""dLLM-style iterative unmasking generation.

Counterpart of `graphgpt_tpu/generation/dllm.py:26-227`: one model forward
per diffusion step; the masked cells with the highest confidence are
filled first; the loop ends early once nothing is masked. At temperature 0
and without Gumbel noise the picks are deterministic and equal the JAX
sampler's: the timesteps are the same float32 numbers and the ranking is a
stable sort, as `jnp.argsort` is.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..config import GenerationConfig


def timesteps(steps: int, eps: float) -> np.ndarray:
    """float32 [steps+1] from 1 down to eps: the numbers that
    `jnp.linspace(1.0, eps, steps + 1)` gives once XLA has compiled it.
    XLA turns i/n into i*(1/n) and eps*(i/n) into i*(eps*(1/n)), and fuses
    the final add with that product into one rounding. Bit-equal for up to
    351 steps; above that XLA's vectorised loop rounds a few entries
    otherwise."""
    one, stop = np.float32(1.0), np.float32(eps)
    i = np.arange(steps, dtype=np.float32)
    r = one / np.float32(steps)
    head = one - i * r
    # exact in float64, then one rounding, as a fused multiply-add
    out = head.astype(np.float64) + i.astype(np.float64) * np.float64(stop * r)
    return np.concatenate([out.astype(np.float32), [stop]]).astype(np.float32)


def top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest prefix (by probability) whose
    mass reaches top_p, and the first token above it."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True).clamp(max=logits.shape[-1] - 1)
    cutoff = sorted_logits.gather(-1, cutoff_idx)
    return torch.where(logits < cutoff, float("-inf"), logits)


def top_k_filter(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    k = min(top_k, logits.shape[-1])
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, float("-inf"), logits)


def sample_tokens(
    logits: torch.Tensor,  # [..., V]
    generator: Optional[torch.Generator],
    temperature: float = 0.0,
    top_p: Optional[float] = None,
    top_k: Optional[int] = None,
    margin_confidence: bool = False,
    neg_entropy: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(confidence, token) per position."""
    logits = logits.float()
    if temperature > 0:
        logits = logits / temperature
    if top_p is not None and top_p < 1:
        logits = top_p_filter(logits, top_p)
    if top_k is not None and top_k > 0:
        logits = top_k_filter(logits, top_k)
    probs = torch.softmax(logits, dim=-1)
    if temperature > 0 and generator is not None:
        u = torch.rand(logits.shape, generator=generator, device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
        x0 = torch.argmax(logits + gumbel, dim=-1)
        confidence = probs.gather(-1, x0[..., None])[..., 0]
    else:
        confidence, x0 = probs.max(dim=-1)
    if margin_confidence:
        top2 = torch.topk(probs, 2, dim=-1).values
        confidence = top2[..., 0] - top2[..., 1]
    if neg_entropy:
        confidence = (probs * torch.log(probs + 1e-10)).sum(dim=-1)
    return confidence, x0.to(torch.int32)


def _unmask_step(logits_fn, cfg, mask_token_id, ts, i, x, generator, extra):
    """One diffusion step: fill the most confident masked cells."""
    mask = x == mask_token_id
    logits = logits_fn(x, *extra)
    confidence, x0 = sample_tokens(
        logits, generator, temperature=cfg.temperature,
        top_p=cfg.top_p if cfg.top_p > 0 else None,
        top_k=cfg.top_k if cfg.top_k > 0 else None,
        margin_confidence=(cfg.alg == "topk_margin"),
        neg_entropy=(cfg.alg == "entropy"),
    )
    if i < cfg.steps - 1:
        p_transfer = 1.0 - ts[i + 1] / ts[i]  # float32 tensors
    else:
        p_transfer = torch.ones((), dtype=torch.float32, device=x.device)
    if cfg.alg == "origin":
        u = torch.rand(x.shape, generator=generator, device=x.device)
        return torch.where(mask & (u < p_transfer), x0, x)
    conf = torch.where(mask, confidence, float("-inf"))
    if cfg.alg_temp and cfg.alg_temp > 0:
        u = torch.rand(conf.shape, generator=generator, device=x.device)
        conf = conf / cfg.alg_temp - torch.log(-torch.log(u + 1e-9) + 1e-9)
    num_masked = mask.sum(dim=-1).to(torch.float32)
    num_transfer = torch.floor(num_masked * p_transfer).to(torch.int64)
    order = torch.argsort(-conf, dim=-1, stable=True)
    ranks = torch.empty_like(order)
    ranks.scatter_(-1, order, torch.arange(x.shape[-1], device=x.device).expand_as(order))
    unmask = mask & (ranks < num_transfer[:, None])
    return torch.where(unmask, x0.to(x.dtype), x)


def make_unmask_sampler(
    logits_fn: Callable[..., torch.Tensor],
    cfg: GenerationConfig,
    mask_token_id: int,
    device=None,
):
    """Build `sample(x_flat [B, T], generator, *extra) -> [B, T]`.

    logits_fn(x_flat, *extra) -> [B, T, V]. The sampler runs on `device`
    (cuda unless named); `sample.forwards` counts the logits_fn calls of
    the last run."""
    dev = resolve_device(device)
    ts = torch.as_tensor(timesteps(cfg.steps, cfg.eps), device=dev)

    def sample(x_flat: torch.Tensor, generator: Optional[torch.Generator] = None, *extra):
        x = x_flat.to(dev)
        sample.forwards = 0
        for i in range(cfg.steps):
            if not bool((x == mask_token_id).any()):
                break
            x = _unmask_step(logits_fn, cfg, mask_token_id, ts, i, x, generator, extra)
            sample.forwards += 1
        return x

    sample.forwards = 0
    return sample


def sample_per_example(
    logits_fn: Callable,
    cfg: GenerationConfig,
    mask_token_id: int,
    x_flat: torch.Tensor,  # [T] or [1, T]
    generator: Optional[torch.Generator],
    *extra,
    output_history: bool = False,
    device=None,
):
    """One example, with steps = min(#masked, cfg.steps); returns
    (x, histories), histories a list of [1, T] snapshots when asked."""
    x = x_flat.reshape(1, -1)
    n_masked = int((x == mask_token_id).sum())
    cfg_i = dataclasses.replace(cfg, steps=max(min(n_masked, cfg.steps), 1))
    if not output_history:
        sampler = make_unmask_sampler(logits_fn, cfg_i, mask_token_id, device)
        return sampler(x, generator, *extra), None
    dev = resolve_device(device)
    ts = torch.as_tensor(timesteps(cfg_i.steps, cfg_i.eps), device=dev)
    x = x.to(dev)
    histories = []
    for i in range(cfg_i.steps):
        x = _unmask_step(logits_fn, cfg_i, mask_token_id, ts, i, x, generator, extra)
        histories.append(x)
    return x, histories


def generation_accuracy(
    generated: torch.Tensor, truth: torch.Tensor, initial_mask: torch.Tensor
) -> Dict[str, torch.Tensor]:
    """Accuracy over the originally masked cells."""
    correct = (generated == truth) & initial_mask
    n = initial_mask.sum()
    return {"acc": correct.sum() / n.clamp(min=1), "n_masked": n}


def mask_at_ratio(input_ids, mask_token_id: int, ratio_band, rng, pad_token_id: int = 0):
    """numpy: mask a uniform ratio drawn from [lo, hi) of the non-pad cells;
    returns (masked ids, mask)."""
    lo, hi = ratio_band
    ratio = lo + (hi - lo) * rng.random()
    mask = (rng.random(input_ids.shape) < ratio) & (input_ids != pad_token_id)
    return np.where(mask, mask_token_id, input_ids), mask
