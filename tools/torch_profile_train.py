"""Where one training step of the PyTorch port goes, on one CUDA card.

    python3 tools/torch_profile_train.py [--layers 12] [--batch 64] [--steps 3]

Builds GraphGPT-base (seeded random weights, `flagship_config`), runs a few
SMTP training steps on one packed batch as `chip_smoke.py`'s train phase
does, and prints
- the step split by CUDA events into forward, backward (with the gradient
  norm) and optimizer + EMA, recorded inside `make_train_step`'s own step
  through forward hooks and a wrapped `tx.update` (median of five steps
  after the first two);
- `torch.profiler`'s device time by kernel name over `--steps` steps (the top
  30), with the share of the profiled device time, and the device's idle
  share of the profiled wall time.
The card's name and power limit are printed first. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_train: needs a CUDA card")
    from graphgpt_torch import synthetic
    from graphgpt_torch.config import OptimizerConfig, flagship_config
    from graphgpt_torch.models.heads import GraphGPTPretrain
    from graphgpt_torch.ops import _build
    from graphgpt_torch.training.optimizer import make_optimizer
    from graphgpt_torch.training.steps import init_train_state, make_train_step

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    _build.build_all()
    dev = torch.device("cuda")
    cfg = flagship_config(layers=args.layers)
    model = GraphGPTPretrain(cfg, device=dev, seed=0)
    nb = synthetic.fake_batch(args.batch, cfg.max_position_embeddings, cfg.stacked_feat,
                              cfg.vocab_size, np.random.default_rng(5))
    batch = synthetic.to_torch(nb, dev)
    opt_cfg = OptimizerConfig(lr=3e-4, use_ema=True)
    tx = make_optimizer(opt_cfg, 100, 2)
    state = init_train_state(model, tx, use_ema=True)
    step = make_train_step(tx, opt_cfg)
    for _ in range(2):
        state, _ = step(state, batch)
    torch.cuda.synchronize()

    # the step's three parts by CUDA events, recorded inside the real step:
    # hooks around the model's forward, and the optimizer's update wrapped
    # so that its entry marks the end of the backward and the gradient norm
    marks = {}

    def mark(name):
        marks[name] = torch.cuda.Event(enable_timing=True)
        marks[name].record()

    hooks = [model.register_forward_pre_hook(lambda *_: mark("fwd0")),
             model.register_forward_hook(lambda *_: mark("fwd1"))]
    update = tx.update

    def timed_update(*a, **kw):
        mark("opt0")
        return update(*a, **kw)

    tx.update = timed_update
    parts = []
    for _ in range(5):
        state, _ = step(state, batch)
        mark("end")
        torch.cuda.synchronize()
        parts.append([marks[a].elapsed_time(marks[b])
                      for a, b in (("fwd0", "fwd1"), ("fwd1", "opt0"), ("opt0", "end"))])
    for h in hooks:
        h.remove()
    tx.update = update
    fwd, bwd, opt = np.median(np.array(parts), axis=0)
    print(f"step parts, B={args.batch} P={cfg.max_position_embeddings} layers={args.layers} "
          f"(median of 5 steps of make_train_step): forward {fwd:.2f} ms, backward + gradient "
          f"norm {bwd:.2f} ms, optimizer+EMA {opt:.2f} ms, sum {fwd + bwd + opt:.2f} ms",
          flush=True)

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(args.steps):
            state, _ = step(state, batch)
        end.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end)
    rows = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_time_total > 0 and e.device_type.name == "CUDA"]
    total = sum(r[1] for r in rows)
    print(f"profiled {args.steps} steps: {wall:.1f} ms by events, {total:.1f} ms of kernels "
          f"({'no device time seen' if total == 0 else f'device idle {100 * (1 - total / wall):.1f}%'})",
          flush=True)
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:30]:
        print(f"  {ms / args.steps:9.3f} ms/step {100 * ms / max(total, 1e-9):5.1f}%  x{count // args.steps:<5d} "
              f"{key[:110]}", flush=True)


if __name__ == "__main__":
    main()
