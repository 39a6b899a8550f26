"""How far the fp32 attention kernels of the split body
(csrc/flash_bwd_split_f32.cu: the forward #1f / #6f, the pair #4f / #5f and
its stream form #7f / #8f) lie from the truth on a model's own attention
inputs, beside the plain fp32 version and other bodies of the kernels.

Two models and batches (`--model`):
- long: chip_smoke.py phase O(a)'s GraphGPT-base long-context config
  (configs/pcqm4m_v2_pretrain_long.yaml at 16 x 4096,
  model.dtype=float32, random weights from the config's seed) on a seeded
  PCQM4M-v2-schema store (chip_smoke.py write_graph_store, 20,000
  molecules), the first 4 rows of its first batch: #6f, #7f, #8f.
- denoise: phase N(b)'s fp32 denoiser (GraphGPT-base with the
  binary-energy decoding, bi_causal_split 16, seed 0) on its 256 x 88
  mol3d batch and draws: #1f, #4f, #5f.

1. The first training step with the kernels and with the plain versions
   (ops.reference_mode()): each gradient's relative error (Frobenius), the
   worst five and every layer's q_proj.
2. The inputs of the forward at the first layer, and of the pair at the
   last layer (the first the backward reaches), as that step hands them
   over. At the forward's, out and lse of the kernel (long: #6f; denoise:
   #1f, and #6f on the same ids, which must give its bits), of the plain
   version in fp32 and of the 3xTF32 products emulated with exact sums
   (each operand split into TF32 hi and lo as the kernels split it, a b =
   a_lo b_hi + a_hi b_lo + a_hi b_hi, every sum in float64); at the pair's,
   dq, delta, dk and dv likewise (denoise: #4f / #5f, and #7f / #8f on the
   same ids, whose delta is made consistent); each against the truth: the
   same function in float64 on the same inputs.
3. long only: each library of `--variants` (split_probe's split_f32
   variants of csrc/flash_bwd_split_f32.cu) and `--source` (another body
   with the same stream entries, an earlier csrc/flash_bwd_split_f32.cu,
   say) in the kernels' place: (1) and (2) again.

    python3 tools/fp32_stream_accuracy.py [--model long|denoise|both]
        [--variants part2,part12] [--source FILE]

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


def kernels(args, plain: bool = False, single: bool = False):
    """(dq, delta, dk, dv) through the wrappers: the stream pair (#7f, #8f),
    or with `single` the pair (#4f, #5f; seg_q is seg_k), or the plain fp32
    version."""
    from graphgpt_torch import ops
    from graphgpt_torch.ops import flash_attention as tfa

    qs, k, v, seg_q, seg_k, cos, sin, out, lse, do, dlse, causal, dh, bi = args
    ids = (seg_q,) if single else (seg_q, seg_k)
    dq_fn, dkv_fn = ((tfa.flash_dq, tfa.flash_dkv) if single
                     else (tfa.flash_dq_stream, tfa.flash_dkv_stream))
    with ops.reference_mode() if plain else torch.no_grad():
        dq, delta = dq_fn(qs, k, v, *ids, cos, sin, out, lse, do, dlse, causal, dh, bi)
        dk, dv = dkv_fn(qs, k, v, *ids, cos, sin, lse, delta, do, causal, dh, bi)
    torch.cuda.synchronize()
    return dq, delta, dk, dv


def forward(args, mm):
    """(out, lse) of the forward's function at `args` (flash_fwd_stream's
    arguments), a row at a time, both products by `mm`, the softmax in
    float64; q and k rotated in fp32 with the plain roundings first, as the
    kernels rotate them; 0 and -1e30 on a padded row or one that sees no
    key."""
    from graphgpt_torch.ops import flash_attention as tfa

    qs, k, v, seg_q, seg_k, cos, sin, causal, dh, bi = args
    b, p, hd = qs.shape
    h = hd // dh
    if cos is not None:
        qs, k = tfa.rotate_tokens(qs, cos, sin, dh), tfa.rotate_tokens(k, cos, sin, dh)
    out = torch.zeros(b, h, p, dh, dtype=torch.float64, device=qs.device)
    lse = torch.full((b, h, p), tfa.NEG_INF, dtype=torch.float64, device=qs.device)
    heads = lambda t: t.view(p, h, dh).transpose(0, 1)  # noqa: E731
    for r in range(b):
        valid = tfa._valid_mask(seg_q[r : r + 1], causal, bi, seg_k[r : r + 1])[0]
        q4, k4, v4 = heads(qs[r]), heads(k[r]), heads(v[r])
        s = torch.where(valid, mm(q4, k4.transpose(1, 2)), float("-inf"))
        m = s.amax(-1, keepdim=True)
        live = (m > float("-inf")) & (seg_q[r] > 0)[None, :, None]
        e = torch.exp(s - torch.where(live, m, 0.0))
        l = torch.where(live, e.sum(-1, keepdim=True), 1.0)
        pv = mm(e.float(), v4) if mm is mm_3xtf32 else mm(e, v4)
        out[r] = torch.where(live, pv / l, 0.0)
        lse[r] = torch.where(live, m + torch.log(l), tfa.NEG_INF)[..., 0]
    return out.transpose(1, 2).reshape(b, p, hd), lse


def report(tag, got, truth, names=("dq", "delta", "dk", "dv")):
    """Each output's relative error against the truth (lse on the rows that
    see a key)."""
    def err(n, g, t):
        if n == "lse":
            live = t > -1e29
            return rel(g[live], t[live])
        return rel(g, t)

    print(f"{tag:28s} against float64: " + "  ".join(
        f"{n} {err(n, g, t):.3e}" for n, g, t in zip(names, got, truth)), flush=True)


def capture_calls(tfa, names):
    """Replace each wrapper of `names` by one that keeps a copy of its first
    call's arguments (the forward's first layer, the backward's last);
    returns (the copies, a function that restores the wrappers)."""
    captured, saved = {}, {n: getattr(tfa, n) for n in names}
    for n in names:
        def spy(*args, _n=n):
            captured.setdefault(_n, tuple(x.detach().clone() if torch.is_tensor(x) else x
                                          for x in args))
            return saved[_n](*args)

        setattr(tfa, n, spy)
    return captured, lambda: [setattr(tfa, n, f) for n, f in saved.items()]


def forward_reports(tag, args, single: bool):
    """(2) at the forward's inputs: the kernel (single: #1f, and #6f on the
    same ids, its bits), the plain fp32 version and the emulated 3xTF32
    products against float64."""
    from graphgpt_torch import ops
    from graphgpt_torch.ops import flash_attention as tfa

    qs, k, v, seg_q, seg_k, cos, sin, causal, dh, bi = args
    truth = forward(args, mm_exact)
    names = ("out", "lse")
    stream = tfa.flash_fwd_stream(*args)
    if single:
        one = tfa.flash_fwd(qs, k, v, seg_q, cos, sin, causal, dh, bi)
        report(f"{tag} #1f", one, truth, names)
        same = all(torch.equal(a, b) for a, b in zip(one, stream))
        print(f"{tag} #6f on the same ids: bit for bit #1f's {same}", flush=True)
    else:
        report(f"{tag} #6f", stream, truth, names)
    with ops.reference_mode():
        report(f"{tag} plain fp32", tfa.flash_fwd_stream(*args), truth, names)
    report(f"{tag} 3xTF32, exact sums", forward(args, mm_3xtf32), truth, names)


def step_report(tag, gk, gp):
    rels = {k: rel(gk[k], gp[k]) for k in gp}
    worst = sorted(rels, key=rels.get, reverse=True)[:5]
    q = [rels[k] for k in sorted(gp) if k.endswith("self_attn.q_proj.weight")]
    print(f"{tag}: the step's gradients against the plain fp32 run: worst "
          + ", ".join(f"{k} {rels[k]:.3e}" for k in worst)
          + f"; median {float(np.median(list(rels.values()))):.3e}; q_proj by layer "
          + " ".join(f"{x:.1e}" for x in q), flush=True)


def denoise(dev) -> None:
    """--model denoise: (1) and (2) on phase N(b)'s fp32 denoiser."""
    import chip_smoke as cs
    from graphgpt_torch import ops, synthetic
    from graphgpt_torch.models.denoise import GraphGPTDenoise, denoise_draws
    from graphgpt_torch.ops import flash_attention as tfa

    tok = synthetic.mol3d_tokenizer()
    cfg = cs.mol3d_config(tok, stacked_feat_agg_method="gated", remat_policy="pairs",
                          task_type="graph", problem_type="regression", loss_type="l1",
                          num_labels=1, bi_causal_split=16, dtype="float32")
    model = GraphGPTDenoise(cfg, device=dev, seed=0)
    nb = synthetic.mol3d_batch(256, 88, seed=0, bi_split=16, tokenizer=tok)
    batch = synthetic.to_torch(nb, dev)
    b, p = nb["segment_ids"].shape
    draws = denoise_draws(b, p, torch.Generator(device=dev).manual_seed(1), dev)
    call = lambda: dict(draws=draws)  # noqa: E731
    captured, restore = capture_calls(tfa, ("flash_fwd", "flash_dq"))
    gk = cs.grads_of(model, batch, call)[1]
    restore()
    with ops.reference_mode():
        gp = cs.grads_of(model, batch, call)[1]
    step_report("denoise kernels", gk, gp)
    qs, k, v, seg, cos, sin, causal, dh, bi = captured["flash_fwd"]
    forward_reports("denoise", (qs, k, v, seg, seg, cos, sin, causal, dh, bi), single=True)
    qs, k, v, seg, cos, sin, out, lse, do, dlse, causal, dh, bi = captured["flash_dq"]
    args = (qs, k, v, seg, seg, cos, sin, out, lse, do, dlse, causal, dh, bi)
    truth = pair(args, mm_exact)
    report("denoise #4f, #5f", kernels(args, single=True), truth)
    report("denoise #7f, #8f, same ids", kernels(args), truth)
    report("denoise plain fp32", kernels(args, plain=True, single=True), truth)
    report("denoise 3xTF32, exact sums", pair(args, mm_3xtf32), truth)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="both", choices=("long", "denoise", "both"))
    ap.add_argument("--variants", default="")
    ap.add_argument("--source", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("fp32_stream_accuracy needs a CUDA card")
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0), flush=True)
    if a.model != "long":
        denoise(dev)
    if a.model != "denoise":
        long_context(dev, a)


def long_context(dev, a) -> None:
    """--model long: (1)-(3) on phase O(a)'s long-context model."""
    import chip_smoke as cs
    from graphgpt_torch import ops
    from graphgpt_torch.ops import _build
    from graphgpt_torch.ops import flash_attention as tfa
    from graphgpt_torch.ops import split_probe as sp
    from graphgpt_torch.synthetic import to_torch
    from graphgpt_torch.training.pipeline import PretrainPipeline

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

        captured, restore = capture_calls(tfa, ("flash_fwd_stream", "flash_dq_stream"))
        gk = grads(model, batch)
        restore()
        with ops.reference_mode():
            gp = grads(model, batch)
        step_report("kernels", gk, gp)
        forward_reports("long", captured["flash_fwd_stream"], single=False)
        args = captured["flash_dq_stream"]
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
