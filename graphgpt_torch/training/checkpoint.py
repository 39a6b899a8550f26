"""Checkpoints with torch.save: keep-last-K, the saved steps, restore, and
the warm start with head skipping.

Counterpart of `graphgpt_tpu/training/checkpoint.py` (Orbax there). A step
is a directory `<dir>/<step>/` with `state.pt` (the parameters, the
optimizer state and the EMA copy, all on the CPU) and `meta.json`.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Sequence

import torch

from .optimizer import OptState
from .steps import TrainState


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree


def _to(tree, like):
    """The tensors of `tree` on the devices (and dtypes) of `like`."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device=like.device, dtype=like.dtype)
    if isinstance(tree, dict):
        return {k: _to(v, like[k]) for k, v in tree.items()}
    return tree


class Checkpointer:
    def __init__(self, directory: str, keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self):
        """Every retained step, ascending."""
        return sorted(int(n) for n in os.listdir(self.directory) if n.isdigit()
                      and os.path.exists(os.path.join(self.directory, n, "state.pt")))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState, metadata: Optional[Dict[str, Any]] = None):
        path = os.path.join(self.directory, str(step))
        os.makedirs(path, exist_ok=True)
        opt = vars(state.opt_state)
        torch.save(
            {"step": state.step, "params": _cpu(state.model.state_dict()),
             "opt_state": {k: _cpu(v) for k, v in opt.items()},
             "ema_params": _cpu(state.ema_params)},
            os.path.join(path, "state.pt.tmp"),
        )
        os.replace(os.path.join(path, "state.pt.tmp"), os.path.join(path, "state.pt"))
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(metadata or {}, f, default=str)
        for old in self.all_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def restore(self, state: TrainState, step: Optional[int] = None):
        """(state, meta): `state`'s model, optimizer state and EMA copy loaded
        from `step` (default the latest) in place; (None, None) if there is
        none."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        path = os.path.join(self.directory, str(step))
        raw = torch.load(os.path.join(path, "state.pt"), map_location="cpu", weights_only=True)
        state.model.load_state_dict(raw["params"])
        opt = raw["opt_state"]
        state.opt_state = OptState(
            **{k: _to(v, getattr(state.opt_state, k)) for k, v in opt.items()}
        )
        if state.ema_params is not None and raw["ema_params"] is not None:
            state.ema_params = _to(raw["ema_params"], state.ema_params)
        state.step = raw["step"]
        with open(os.path.join(path, "meta.json")) as f:
            return state, json.load(f)


def restore_params_warmstart(
    ckpt_dir: str, template: Dict[str, torch.Tensor], skip_prefixes: Sequence[str] = ("score",),
    step: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """A state dict for a fine-tune model from a pretrain checkpoint: each
    entry of `template` is taken from the checkpoint where it is there with
    the same shape and its name starts with none of `skip_prefixes`, else
    kept (freshly initialised heads)."""
    ckpt = Checkpointer(ckpt_dir)
    step = ckpt.latest_step() if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    src = torch.load(os.path.join(ckpt.directory, str(step), "state.pt"), map_location="cpu",
                     weights_only=True)["params"]
    out = {}
    for key, val in template.items():
        take = (not any(key.startswith(p) for p in skip_prefixes) and key in src
                and src[key].shape == val.shape)
        out[key] = src[key].to(device=val.device, dtype=val.dtype) if take else val
    return out


def save_run_config(output_dir: str, cfg_dict: Dict[str, Any]):
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "config_final.json"), "w") as f:
        json.dump(cfg_dict, f, indent=2, default=str)
