"""Optimizer and LR schedules, with optax's update rules written out.

Counterpart of `graphgpt_tpu/training/optimizer.py` (`make_schedule` :24,
`muon` :124, `make_optimizer` :155, `layerwise_lr_scales` :200). Trees are
flat dicts from the port's parameter names to tensors. The optimizer is a
chain like the JAX package's: clip by global norm, AdamW (or Muon on the
decoder's matrices and AdamW elsewhere), layer-wise LR scales on the
updates, then an optional transform of the updates (the fine-tune freeze,
`optax.chain(tx, freeze)` there), all under gradient accumulation. `update` is a function of
(grads, state, params) and returns new tensors; `apply_updates` adds the
updates to the parameters in place.

Rules kept from optax, where `torch.optim` differs:
- the clip scales by `max_norm / norm` only when `norm >= max_norm`, with no
  epsilon in the divisor;
- AdamW's update is `-lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)` on every
  parameter, with lr read at the count before the increment (so the first
  update of a warm-up schedule has lr 0);
- accumulation keeps the running mean of k micro-gradients and moves the
  inner count on every k-th call.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable, Dict, Optional

import torch

from ..config import OptimizerConfig

Tree = Dict[str, torch.Tensor]
Schedule = Callable[[int], float]


# ---------------------------------------------------------------------------
# Schedules: plain functions of the step
# ---------------------------------------------------------------------------
def _linear(init: float, end: float, steps: int) -> Schedule:
    if steps <= 0:
        return lambda count: init

    def schedule(count):
        frac = 1 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return schedule


def _cosine_decay(init: float, steps: int, alpha: float = 0.0) -> Schedule:
    def schedule(count):
        c = min(count, steps)
        return init * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / steps)) + alpha)

    return schedule


def _join(schedules, boundaries) -> Schedule:
    def schedule(step):
        out = schedules[0](step)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = sched(step - boundary)
        return out

    return schedule


def _cosine_onecycle(total: int, peak: float, pct_start: float, div: float, final_div: float):
    """optax.cosine_onecycle_schedule: cosine pieces between the values
    peak/div -> peak -> peak/(div*final_div)."""
    bounds = [0, int(pct_start * total), int(total)]
    values = [peak / div, peak, peak / (div * final_div)]

    def schedule(count):
        for lo, hi, v0, v1 in zip(bounds[:-1], bounds[1:], values[:-1], values[1:]):
            if lo <= count < hi:
                pct = (count - lo) / (hi - lo)
                return v0 + (v1 - v0) * (1 - math.cos(math.pi * pct)) / 2
        return values[-1] if count >= bounds[-1] else values[0]

    return schedule


def make_schedule(cfg: OptimizerConfig, total_steps: int, warmup_steps: int) -> Schedule:
    """The seven schedulers of the reference's registry: warmup_decay,
    onecycle, cosine, constant, cyclic, cosine_wr, lr_range_test."""
    peak = cfg.lr
    warmup_steps = max(int(warmup_steps), 1)
    total_steps = max(int(total_steps), warmup_steps + 1)
    name = cfg.scheduler
    if name == "warmup_decay":
        # DeepSpeed WarmupDecayLR: linear warmup then linear decay
        return _join(
            [_linear(0.0, peak, warmup_steps),
             _linear(peak, cfg.min_lr, total_steps - warmup_steps)],
            [warmup_steps],
        )
    if name == "onecycle":
        return _cosine_onecycle(total_steps, peak, warmup_steps / total_steps, 25.0, 1e4)
    if name == "cosine":
        alpha = 0.0 if peak == 0.0 else cfg.min_lr / peak
        return _join(
            [_linear(0.0, peak, warmup_steps),
             _cosine_decay(peak, total_steps - warmup_steps, alpha)],
            [warmup_steps],
        )
    if name == "constant":
        return _join([_linear(0.0, peak, warmup_steps), lambda count: peak], [warmup_steps])
    if name == "cyclic":
        # torch CyclicLR, triangular: min_lr <-> peak, legs of cycle_steps each
        half = max(cfg.cycle_steps or total_steps // 4, 1)
        base = cfg.min_lr

        def cyclic(step):
            pos = step % (2 * half)
            frac = pos / half if pos < half else 2.0 - pos / half
            return base + (peak - base) * frac

        return cyclic
    if name == "cosine_wr":
        # torch CosineAnnealingWarmRestarts (T_0 = cycle_steps, T_mult)
        t0 = max(cfg.cycle_steps or total_steps // 4, 1)
        mult = max(cfg.cycle_mult, 1.0)
        cycles, boundaries, t, covered = [], [], t0, 0
        while covered < total_steps:
            cycles.append(_cosine_decay(peak, int(t), cfg.min_lr / peak if peak else 0.0))
            covered += int(t)
            boundaries.append(covered)
            t = t * mult
        first = _join([_linear(0.0, peak, warmup_steps), cycles[0]], [warmup_steps])
        return _join([first, *cycles[1:]], boundaries[:-1])
    if name == "lr_range_test":
        # DeepSpeed LRRangeTest: linear ramp from min_lr up across the run
        return _linear(max(cfg.min_lr, 1e-8), peak, total_steps)
    raise ValueError(f"unknown scheduler {name!r}")


# ---------------------------------------------------------------------------
# Pieces of the chain
# ---------------------------------------------------------------------------
def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt(sum of squares) over every leaf, as a 0-d fp32 tensor."""
    sq = [t.float().pow(2).sum() for t in tree.values()]
    return torch.sqrt(torch.stack(sq).sum())


def clip_by_global_norm(tree: Tree, max_norm: float) -> Tree:
    """optax's rule: untouched while norm < max_norm, else (t / norm) * max_norm."""
    norm = global_norm(tree)
    keep = norm < max_norm
    return {
        k: torch.where(keep, t, (t / norm.to(t.dtype)) * max_norm) for k, t in tree.items()
    }


_LAYER_RE = re.compile(r"(?:^|\.)layers\.(\d+)\.")


def layer_index(name: str) -> Optional[int]:
    """The decoder layer a parameter name belongs to, or None."""
    m = _LAYER_RE.search(name)
    return int(m.group(1)) if m else None


def layerwise_lr_scales(names, num_layers: int, decay: float = 0.9) -> Dict[str, float]:
    """Layer-wise LR decay: layer i's update scaled by decay^(L-1-i), the
    embedding table's by decay^L, everything else by 1."""
    scales = {}
    for name in names:
        idx = layer_index(name)
        if idx is not None:
            scales[name] = decay ** (num_layers - 1 - idx)
        elif "embed_tokens" in name:
            scales[name] = decay**num_layers
        else:
            scales[name] = 1.0
    return scales


def newton_schulz(g: torch.Tensor, steps: int = 5, eps: float = 1e-7) -> torch.Tensor:
    """Quintic Newton-Schulz orthogonalisation (Muon; public coefficients)."""
    a, b, c = 3.4445, -4.7750, 2.0315
    x = g.float()
    transpose = x.shape[-2] > x.shape[-1]
    if transpose:
        x = x.transpose(-1, -2)
    x = x / (torch.linalg.matrix_norm(x, keepdim=True) + eps)
    for _ in range(steps):
        aa = x @ x.transpose(-1, -2)
        x = a * x + (b * aa + c * (aa @ aa)) @ x
    if transpose:
        x = x.transpose(-1, -2)
    return x


@dataclasses.dataclass
class OptState:
    count: int  # AdamW's count (and the LR schedule's): emitted updates so far
    mini_step: int  # accumulation: micro-gradients taken since the last update
    mu: Tree
    nu: Tree
    acc_grads: Optional[Tree] = None  # running mean of the micro-gradients
    muon_mu: Optional[Tree] = None
    muon_count: int = 0


class Optimizer:
    """clip -> AdamW | Muon -> layer-wise scales -> post_update, under
    accumulation."""

    def __init__(self, cfg: OptimizerConfig, schedule: Schedule, num_layers: Optional[int] = None,
                 post_update: Optional[Callable[[Tree], Tree]] = None):
        if cfg.name not in ("adamw", "muon"):
            raise ValueError(f"unknown optimizer {cfg.name!r}")
        if cfg.layerwise_lr_decay > 0 and num_layers is None:
            raise ValueError("layerwise_lr_decay>0 requires num_layers")
        self.cfg, self.schedule, self.num_layers = cfg, schedule, num_layers
        self.post_update = post_update

    def _is_muon(self, name: str, t: torch.Tensor) -> bool:
        """Muon takes the decoder layers' matrices; AdamW everything else."""
        return self.cfg.name == "muon" and layer_index(name) is not None and t.dim() >= 2

    def init(self, params: Tree) -> OptState:
        zeros = {k: torch.zeros_like(p) for k, p in params.items() if not self._is_muon(k, p)}
        return OptState(
            count=0, mini_step=0, mu=zeros, nu={k: z.clone() for k, z in zeros.items()},
            acc_grads=(
                {k: torch.zeros_like(p) for k, p in params.items()}
                if self.cfg.gradient_accumulation_steps > 1 else None
            ),
            muon_mu={k: torch.zeros_like(p) for k, p in params.items() if self._is_muon(k, p)}
            if self.cfg.name == "muon" else None,
        )

    @torch.no_grad()
    def update(self, grads: Tree, state: OptState, params: Tree):
        """(updates, new_state). Under accumulation the updates are None
        until the k-th micro-gradient has come in."""
        k = self.cfg.gradient_accumulation_steps
        if k > 1:
            n = state.mini_step
            acc = {key: a + (grads[key] - a) / (n + 1) for key, a in state.acc_grads.items()}
            if n != k - 1:
                return None, dataclasses.replace(state, mini_step=n + 1, acc_grads=acc)
            grads = acc
        updates, new_state = self._inner(grads, state, params)
        if self.post_update is not None:
            updates = self.post_update(updates)
        if k > 1:
            new_state.mini_step = 0
            new_state.acc_grads = {key: torch.zeros_like(a) for key, a in grads.items()}
        return updates, new_state

    def _inner(self, grads: Tree, state: OptState, params: Tree):
        cfg = self.cfg
        grads = clip_by_global_norm(grads, cfg.max_grad_norm)
        b1, b2 = cfg.betas
        count_inc = state.count + 1
        lr = self.schedule(state.count)  # the count before the increment
        c1, c2 = 1 - b1**count_inc, 1 - b2**count_inc
        updates, mu, nu = {}, {}, {}
        for key in state.mu:
            g = grads[key]
            mu[key] = b1 * state.mu[key] + (1 - b1) * g
            nu[key] = b2 * state.nu[key] + (1 - b2) * g * g
            u = (mu[key] / c1) / (torch.sqrt(nu[key] / c2) + cfg.eps)
            updates[key] = -lr * (u + cfg.weight_decay * params[key])
        muon_mu, muon_count = state.muon_mu, state.muon_count
        if muon_mu is not None:
            muon_count += 1
            mlr = self.schedule(muon_count)  # Muon reads the count after its increment
            muon_mu = {key: 0.95 * m + grads[key] for key, m in muon_mu.items()}
            for key, m in muon_mu.items():
                # matrices are nn.Linear's [out, in]: the scale is the JAX
                # package's sqrt(max(1, in / out)) of its [in, out] layout
                scale = math.sqrt(max(1.0, m.shape[-1] / m.shape[-2]))
                updates[key] = -mlr * (newton_schulz(m) * scale).to(m.dtype)
        if cfg.layerwise_lr_decay > 0:
            scales = layerwise_lr_scales(updates, self.num_layers, cfg.layerwise_lr_decay)
            updates = {key: u * scales[key] for key, u in updates.items()}
        new_state = OptState(
            count=count_inc, mini_step=state.mini_step, mu=mu, nu=nu,
            acc_grads=state.acc_grads, muon_mu=muon_mu, muon_count=muon_count,
        )
        return updates, new_state


@torch.no_grad()
def apply_updates(params: Tree, updates: Optional[Tree]) -> None:
    """params += updates, in place (nothing when updates is None)."""
    if updates is None:
        return
    for key, u in updates.items():
        params[key].add_(u.to(params[key].dtype))


def make_optimizer(
    cfg: OptimizerConfig, total_steps: int, warmup_steps: int,
    schedule: Optional[Schedule] = None, num_layers: Optional[int] = None,
    post_update: Optional[Callable[[Tree], Tree]] = None,
) -> Optimizer:
    return Optimizer(cfg, schedule or make_schedule(cfg, total_steps, warmup_steps), num_layers,
                     post_update)


def compute_total_steps(
    total_tokens: float, warmup_tokens: float, tokens_per_sample: float, global_batch_size: int
) -> tuple:
    """Token-budget driven step counts."""
    tokens_per_step = max(tokens_per_sample * global_batch_size, 1.0)
    total = int(total_tokens / tokens_per_step)
    warmup = int(warmup_tokens / tokens_per_step)
    return max(total, 1), max(warmup, 1)
