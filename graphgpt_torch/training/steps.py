"""Train and eval steps.

Counterpart of `graphgpt_tpu/training/steps.py` (`TrainState` :25,
`init_train_state` :32, `make_train_step` :43, `make_eval_step` :96): the
whole step is forward, backward, clip, optimizer update and EMA. PyTorch
runs it eagerly and updates the model's parameters in place, so the state
that comes back is the state that went in, advanced.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn as nn

from ..config import OptimizerConfig
from ..models.modeling import derive_generator
from .optimizer import Optimizer, OptState, apply_updates, global_norm


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module  # fp32 master weights, updated in place
    opt_state: OptState
    ema_params: Optional[Dict[str, torch.Tensor]] = None  # fp32 copy, by name


def init_train_state(model: nn.Module, tx: Optimizer, use_ema: bool = False) -> TrainState:
    params = dict(model.named_parameters())
    return TrainState(
        step=0, model=model, opt_state=tx.init(params),
        ema_params={k: p.detach().float().clone() for k, p in params.items()} if use_ema else None,
    )


def make_train_step(
    tx: Optimizer, opt_cfg: Optional[OptimizerConfig] = None,
    schedule: Optional[Callable[[int], float]] = None,
):
    """step_fn(state, batch, seed) -> (state, metrics) with metrics "loss",
    "grad_norm" (before the clip), "gen_loss" / "dis_loss" / "task_loss" /
    "pretrain_loss" where the model has them (0-d tensors on the model's
    device) and "lr" (a float, when a schedule is given). EMA is a lerp of
    the fp32 copy toward the new parameters. Like the JAX package's step, it
    hands the model no loss generator (the AUC loss then draws a fixed set
    of negatives)."""
    ema_decay = opt_cfg.ema_decay if (opt_cfg and opt_cfg.use_ema) else None

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor], seed: int = 0):
        model = state.model
        params = dict(model.named_parameters())
        device = next(iter(params.values())).device
        model.zero_grad(set_to_none=True)
        # the step's randomness is a function of (seed, step) alone, as the
        # JAX package folds the step into its key
        out = model(batch, generator=derive_generator(seed, state.step, device), train=True)
        out["loss"].backward()
        grads = {
            k: p.grad if p.grad is not None else torch.zeros_like(p) for k, p in params.items()
        }
        metrics: Dict[str, Any] = {"loss": out["loss"].detach(), "grad_norm": global_norm(grads)}
        for key in ("gen_loss", "dis_loss", "task_loss", "pretrain_loss"):
            if key in out:
                metrics[key] = out[key].detach()
        if schedule is not None:
            metrics["lr"] = schedule(state.step)
        updates, state.opt_state = tx.update(grads, state.opt_state, params)
        apply_updates(params, updates)
        model.zero_grad(set_to_none=True)
        if ema_decay is not None and state.ema_params is not None:
            with torch.no_grad():
                for k, e in state.ema_params.items():
                    e.mul_(ema_decay).add_(params[k].to(e.dtype), alpha=1.0 - ema_decay)
        state.step += 1
        return state, metrics

    return step_fn


_EVAL_KEYS = ("loss", "gen_loss", "task_loss", "task_logits", "task_hidden_states",
              "hidden_states")


def make_eval_step(use_ema: bool = False):
    """eval_fn(state, batch) -> those of "loss", "gen_loss", "task_loss",
    "task_logits", "task_hidden_states", "hidden_states" the model returns,
    run with the EMA copy in place of the parameters when asked. The JAX
    eval hands `pretrain_forward` no key, so that its in-model SMTP raises
    (an unbound name); here it draws from the generator seeded 0 too."""

    @torch.no_grad()
    def eval_fn(state: TrainState, batch: Dict[str, torch.Tensor]):
        # a forward that draws (in-model SMTP, the position and denoise
        # models) draws from a generator seeded 0, as the JAX package's
        # position and denoise forwards fall back to PRNGKey(0)
        gen = torch.Generator(device=state.model.device).manual_seed(0)
        if use_ema and state.ema_params is not None:
            out = torch.func.functional_call(state.model, state.ema_params, (batch,),
                                             {"generator": gen})
        else:
            out = state.model(batch, generator=gen)
        return {k: out[k] for k in _EVAL_KEYS if k in out}

    return eval_fn
