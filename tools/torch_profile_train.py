"""Where one training step of the PyTorch port goes, on one CUDA card.

    python3 tools/torch_profile_train.py [--layers 12] [--batch 64] [--steps 3]
        [--seq 4096]

Builds GraphGPT-base (seeded random weights, `flagship_config`) and runs a
few SMTP training steps on one packed batch as `chip_smoke.py`'s train
phase does (B 64 x P 1024); or, with `--seq P`, the long-context step as
`chip_smoke.py`'s long-context phase takes it: configs/pcqm4m_v2_pretrain_long.yaml
through `PretrainPipeline` on synthetic_mol at max_length P without
block-aligned packing, batch `--batch` (`--seq 4096 --batch 16`: 65,536
tokens a step, through the streamed kernels #6-#8), its first batch and
its own train step. Prints
- the step split by CUDA events into forward, backward (with the gradient
  norm) and optimizer + EMA, recorded inside `make_train_step`'s own step
  through forward hooks and a wrapped `tx.update`, and the whole call
  (median of five steps after the first two);
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
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seq", type=int, default=0,
                    help="the long-context pipeline's step at this max_length")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_train: needs a CUDA card")
    from graphgpt_torch.ops import _build

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    _build.build_all()
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as out_dir:
        profile_steps(args, dev, *(long_context(args, dev, out_dir) if args.seq
                                   else training(args, dev)))


def training(args, dev):
    """(model, tx, state, step, batch, P) of the 64 x 1024 training step."""
    from graphgpt_torch import synthetic
    from graphgpt_torch.config import OptimizerConfig, flagship_config
    from graphgpt_torch.models.heads import GraphGPTPretrain
    from graphgpt_torch.training.optimizer import make_optimizer
    from graphgpt_torch.training.steps import init_train_state, make_train_step

    cfg = flagship_config(layers=args.layers)
    model = GraphGPTPretrain(cfg, device=dev, seed=0)
    nb = synthetic.fake_batch(args.batch, cfg.max_position_embeddings, cfg.stacked_feat,
                              cfg.vocab_size, np.random.default_rng(5))
    opt_cfg = OptimizerConfig(lr=3e-4, use_ema=True)
    tx = make_optimizer(opt_cfg, 100, 2)
    state = init_train_state(model, tx, use_ema=True)
    return (model, tx, state, make_train_step(tx, opt_cfg), synthetic.to_torch(nb, dev),
            cfg.max_position_embeddings)


def long_context(args, dev, out_dir):
    """(model, tx, state, step, batch, P) of the long-context pipeline's step
    on its first batch (the loader's worker pool is closed again)."""
    from graphgpt_torch.config import load_config
    from graphgpt_torch.synthetic import to_torch
    from graphgpt_torch.training.pipeline import PretrainPipeline

    cfg = load_config(os.path.join(ROOT, "configs", "pcqm4m_v2_pretrain_long.yaml"), [
        "tokenization.dataset=synthetic_mol", f"model.max_position_embeddings={args.seq}",
        f"training.max_length={args.seq}", "training.pack_block=0",
        f"training.batch_size={args.batch}", f"model.num_hidden_layers={args.layers}",
        f"training.output_dir={out_dir}"])
    pipe = PretrainPipeline(cfg, device=dev).setup()
    seed = cfg.training.seed
    idx0 = np.random.default_rng((seed, 0)).permutation(pipe.train_idx)
    nb = next(pipe.loader.epoch_batches(idx0, 0)).data
    pipe.loader.close()
    return (pipe.state.model, pipe.tx, pipe.state,
            lambda state, batch: pipe.train_step(state, batch, seed=seed), to_torch(nb, dev),
            args.seq)


def profile_steps(args, dev, model, tx, state, step, batch, p) -> None:
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
        mark("start")
        state, _ = step(state, batch)
        mark("end")
        torch.cuda.synchronize()
        parts.append([marks[a].elapsed_time(marks[b])
                      for a, b in (("fwd0", "fwd1"), ("fwd1", "opt0"), ("opt0", "end"),
                                   ("start", "end"))])
    for h in hooks:
        h.remove()
    tx.update = update
    fwd, bwd, opt, whole = np.median(np.array(parts), axis=0)
    print(f"step parts, B={args.batch} P={p} layers={args.layers} (median of 5 steps of "
          f"make_train_step): forward {fwd:.2f} ms, backward + gradient norm {bwd:.2f} ms, "
          f"optimizer+EMA {opt:.2f} ms, sum {fwd + bwd + opt:.2f} ms; the whole call "
          f"{whole:.2f} ms", flush=True)

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
