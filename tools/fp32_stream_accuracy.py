"""How far the fp32 streamed pair #7f flash_dq_stream / #8f flash_dkv_stream
lies from the truth on a model's own attention inputs, beside the plain
fp32 version and other bodies of the kernels.

The model and batch are chip_smoke.py phase O(a)'s: GraphGPT-base's
long-context config (configs/pcqm4m_v2_pretrain_long.yaml at 16 x 4096,
model.dtype=float32, random weights from the config's seed) on a seeded
PCQM4M-v2-schema store (chip_smoke.py write_graph_store, 20,000
molecules), the first 4 rows of its first batch.

1. The first training step with the kernels and with the plain versions
   (ops.reference_mode()): each gradient's relative error (Frobenius), the
   worst five and every layer's q_proj.
2. The inputs of #7f and #8f at the last layer (the first the backward
   reaches), as that step hands them over; at those inputs dq, delta, dk
   and dv of the kernels, of the plain version in fp32 and of the 3xTF32
   products emulated with exact sums (each operand split into TF32 hi and
   lo as the kernels split it, a b = a_lo b_hi + a_hi b_lo + a_hi b_hi,
   every sum in float64), each against the truth: the same function in
   float64 on the same inputs.
3. Each library of `--variants` (split_probe's split_f32 variants of
   csrc/flash_bwd_split_f32.cu) and `--source` (another body with the same
   stream entries, an earlier csrc/flash_bwd_f32.cu, say) in the kernels'
   place: (1) and (2) again.

    python3 tools/fp32_stream_accuracy.py [--variants part2,part12] [--source FILE]

Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

DH = 64
GRAPHS = 20000  # the store's molecules


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def grads(model, batch):
    model.zero_grad(set_to_none=True)
    model(batch, train=True)["loss"].backward()
    g = {k: q.grad.detach().clone() for k, q in model.named_parameters() if q.grad is not None}
    model.zero_grad(set_to_none=True)
    return g


def unrot(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The inverse rotation of a head-major [..., P, Dh] gradient in x's dtype."""
    half = DH // 2
    return x * cos - torch.cat([-x[..., half:], x[..., :half]], dim=-1) * sin


def split(x: torch.Tensor):
    """fp32 x as TF32 hi and lo (the kernels' split), both as float64."""
    def tf32(t):
        return ((t.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)

    hi = tf32(x)
    return hi.double(), tf32(x - hi).double()


def mm_exact(a, b):
    return a.double() @ b.double()


def mm_3xtf32(a, b):
    (ah, al), (bh, bl) = split(a), split(b)
    return al @ bh + ah @ bl + ah @ bh


def pair(args, mm):
    """(dq, delta, dk, dv) of the pair's function at `args` (flash_dq_stream's
    arguments), one (row, head) at a time, every product by `mm`, the rest
    in float64; q and k rotated in fp32 with the plain roundings first, as
    the kernels rotate them."""
    from graphgpt_torch.ops import flash_attention as tfa

    qs, k, v, seg_q, seg_k, cos, sin, out, lse, do, dlse, causal, dh, bi = args
    b, p, hd = qs.shape
    h = hd // dh
    if cos is not None:
        qs, k = tfa.rotate_tokens(qs, cos, sin, dh), tfa.rotate_tokens(k, cos, sin, dh)
    do = torch.where((seg_q > 0)[..., None], do, torch.zeros((), device=do.device))
    delta = (do.double() * out.double()).view(b, p, h, dh).sum(-1).transpose(1, 2)
    if dlse is not None:
        delta = delta - dlse.double()
    dq, dk, dv = (torch.zeros(b, h, p, dh, dtype=torch.float64, device=qs.device)
                  for _ in range(3))
    for r in range(b):
        valid = tfa._valid_mask(seg_q[r : r + 1], causal, bi, seg_k[r : r + 1])[0, 0]
        for i in range(h):
            sl = slice(i * dh, (i + 1) * dh)
            q4, k4, v4, do4 = (t[r, :, sl] for t in (qs, k, v, do))
            s = mm(q4, k4.t())
            pij = torch.where(valid, torch.exp(s - lse[r, i].double()[:, None]), 0.0)
            ds = torch.where(valid, pij * (mm(do4, v4.t()) - delta[r, i][:, None]), 0.0)
            dq[r, i] = mm(ds.float(), k4) if mm is mm_3xtf32 else mm(ds, k4)
            dk[r, i] = mm(ds.t().float(), q4) if mm is mm_3xtf32 else mm(ds.t(), q4)
            dv[r, i] = mm(pij.t().float(), do4) if mm is mm_3xtf32 else mm(pij.t(), do4)
    if cos is not None:
        c, s_ = cos.double()[:, None], sin.double()[:, None]
        dq, dk = unrot(dq, c, s_), unrot(dk, c, s_)
    tok = lambda x: x.transpose(1, 2).reshape(b, p, hd)  # noqa: E731
    return tok(dq), delta, tok(dk), tok(dv)


def kernels(args, plain: bool = False):
    """(dq, delta, dk, dv) through the wrappers: the kernels, or the plain
    fp32 version."""
    from graphgpt_torch import ops
    from graphgpt_torch.ops import flash_attention as tfa

    qs, k, v, seg_q, seg_k, cos, sin, out, lse, do, dlse, causal, dh, bi = args
    with ops.reference_mode() if plain else torch.no_grad():
        dq, delta = tfa.flash_dq_stream(*args)
        dk, dv = tfa.flash_dkv_stream(qs, k, v, seg_q, seg_k, cos, sin, lse, delta, do, causal,
                                      dh, bi)
    torch.cuda.synchronize()
    return dq, delta, dk, dv


def report(tag, got, truth):
    print(f"{tag:28s} against float64: " + "  ".join(
        f"{n} {rel(g, t):.3e}" for n, g, t in zip(("dq", "delta", "dk", "dv"), got, truth)),
        flush=True)


def step_report(tag, gk, gp):
    rels = {k: rel(gk[k], gp[k]) for k in gp}
    worst = sorted(rels, key=rels.get, reverse=True)[:5]
    q = [rels[k] for k in sorted(gp) if k.endswith("self_attn.q_proj.weight")]
    print(f"{tag}: the step's gradients against the plain fp32 run: worst "
          + ", ".join(f"{k} {rels[k]:.3e}" for k in worst)
          + f"; median {float(np.median(list(rels.values()))):.3e}; q_proj by layer "
          + " ".join(f"{x:.1e}" for x in q), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="")
    ap.add_argument("--source", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("fp32_stream_accuracy needs a CUDA card")
    import chip_smoke as cs
    from graphgpt_torch import ops
    from graphgpt_torch.ops import _build
    from graphgpt_torch.ops import flash_attention as tfa
    from graphgpt_torch.ops import split_probe as sp
    from graphgpt_torch.synthetic import to_torch
    from graphgpt_torch.training.pipeline import PretrainPipeline

    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, "OGB")
        cs.write_graph_store(data_dir, n_graphs=GRAPHS, procs=4)
        pipe = PretrainPipeline(cs.long_config(os.path.join(tmp, "out"), data_dir,
                                               "model.dtype=float32", "training.gen_eval_bands=0"),
                                device=dev).setup()
        tc = pipe.cfg.training
        idx0 = np.random.default_rng((tc.seed, 0)).permutation(pipe.train_idx)
        nb = next(pipe.loader.epoch_batches(idx0, 0)).data
        batch = {k: v[:4] for k, v in to_torch(nb, dev).items()}
        model = pipe.state.model

        captured = {}
        dq_fn = tfa.flash_dq_stream

        def capture(*args):
            captured.setdefault("args", tuple(x.detach().clone() if torch.is_tensor(x) else x
                                              for x in args))
            return dq_fn(*args)

        tfa.flash_dq_stream = capture
        gk = grads(model, batch)
        tfa.flash_dq_stream = dq_fn
        with ops.reference_mode():
            gp = grads(model, batch)
        step_report("kernels", gk, gp)
        args = captured["args"]
        truth = pair(args, mm_exact)
        report("kernels (#7f, #8f)", kernels(args), truth)
        report("plain fp32", kernels(args, plain=True), truth)
        report("3xTF32, exact sums", pair(args, mm_3xtf32), truth)

        others = {}
        if a.variants:
            text = (_build.CSRC / "flash_bwd_split_f32.cu").read_text()
            others.update(sp.build("split_f32", text, a.variants.split(","), _build.CSRC))
        if a.source:
            others["source"] = sp.build("split_f32", open(a.source).read(), ["base"],
                                        Path(a.source).resolve().parent,
                                        label="split_f32_source")["base"]
        own = _build.lib("flash_bwd_split_f32")
        for name, lib in others.items():
            _build._libs["flash_bwd_split_f32"] = lib
            step_report(name, grads(model, batch), gp)
            report(name, kernels(args), truth)
        _build._libs["flash_bwd_split_f32"] = own


if __name__ == "__main__":
    main()
