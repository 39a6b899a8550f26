"""Drive the PyTorch port (graphgpt_torch) on one CUDA card.

    python3 chip_smoke.py

1. Fails unless a CUDA card is present; prints its name and power limit.
2. Builds every kernel from graphgpt_torch/csrc with nvcc (one process per
   source, all at once) and prints the build time.
3. Kernel phase: each of the kernels (flash_fwd, norm_mlp, flash_bwd,
   rmsnorm_bwd) against its plain PyTorch version in bf16 (errors beside
   their tolerances) at the shapes both main paths give it, 8 x 1024 rows
   for serving and 64 x 1024 for training, timed three times with
   CUDA events beside the plain version, one PyTorch library call where one
   computes the same function, and the card's bound for the same work;
   the bi-causal flash_fwd and the split backward pair (flash_dq,
   flash_dkv) the same way at 8 x 1024 with 16 bit slots.
4. Eval phase: GraphGPT-base at full width (seeded random weights), the
   SMTP eval loss of a packed 8 x 1024 batch, against the same model run
   with the plain versions; each forward kernel launches once per layer.
5. Generation phase: dLLM unmasking of a 30-40% masked band with the
   default GenerationConfig (64 steps, entropy confidence).
6. Train phase: a fresh GraphGPT-base, twelve SMTP training steps (forward,
   backward, clip, AdamW, EMA) on one packed 64 x 1024 batch; the first
   step's loss and every gradient against the same step run with the plain
   versions, on the whole batch; launch counts per step; ms per step,
   trained tokens/s and peak memory.
7. Fine-tune phase: the train phase's model saved with the port's
   Checkpointer; the port's FinetunePipeline on synthetic_mol with
   GraphGPT-base as configs/pcqm4m_v2_supervised.yaml sets it up plus
   LayerScale, DropPath and attention dropout, warm-started from that
   checkpoint with the heads skipped, one epoch of 8 x 256 graphs with EMA.
   Before it, every kernel of the fine-tune step against its plain version
   at the first batch's shape: mlp (also at N 8192), flash_fwd and
   flash_bwd on that batch's segments and RoPE table, rmsnorm_bwd at its
   N; then the first step's loss and every gradient against the plain run
   on the same batch and dropout masks.
   Then launch counts per training step and per EMA eval forward, the
   losses, the valid and EMA-valid MAE, ms per step, the loader's graphs/s
   and peak memory.
8. Denoise phase: a fresh GraphGPT-base denoising double-heads model
   (configs/pcqm4m_v2_supervised.yaml's setup plus bi_causal_split 16, the
   binary-energy decoding) on a 256 x 88 mol3d batch: every kernel of its
   step at that batch's shape against its plain version (the bi-causal
   flash_fwd, flash_dq with its delta, flash_dkv, norm_mlp and rmsnorm_bwd
   at N 22,528), the first step against the plain run on the same draws,
   eight AdamW + EMA steps with their launch counts, an EMA eval forward
   that decodes the energies, ms per step and peak memory.
9. Position-pretraining phase: a fresh GraphGPT-base pos-smtp-line model on
   a 256 x 72 mol3d batch: flash_fwd, flash_bwd and norm_mlp at that
   batch's shape against their plain versions, the first step against the
   plain run, four steps with their launch counts.
10. Long-context pretraining phase: GraphGPT-base SMTP pretraining through
   the port's PretrainPipeline on configs/pcqm4m_v2_pretrain_long.yaml at
   max_length 4096 without block-aligned packing, batch 16 (65,536 tokens
   a step), synthetic_mol. First the streamed kernels #6 flash_fwd_stream,
   #7 flash_dq_stream (with its delta) and #8 flash_dkv_stream against
   their plain versions on 2 of the first batch's 16 rows, with its
   segments and RoPE table, and again with another packed row's ids as the
   key ids; each timed at the whole 16 x 4096 beside its bound, its plain
   version's time and SDPA's, and #1's entry on the same rows. Then the
   first step on 4 rows against the plain run; run A, eight steps with the
   launch counts of each step and each eval forward, falling losses,
   log.csv (tokens/s, mfu), result.csv (valid, EMA-valid, 2 generation
   bands) and the checkpoint at step 8; a step on a batch on the card, the
   loader's graphs/s with its worker pool, peak memory; auto-resume at
   step 8 for two steps more; run B, the config as shipped (pack_block
   256) for two steps: training in 256-token windows (#1, #3), the eval
   and the generation sweep on whole rows (#6).
11. Prints one JSON line listing every kernel, then the device line last.

Any failed check raises, so the script exits non-zero. The launch counts
are set to 0 just before each main path (eval + generation; training;
fine-tuning; denoising; position pretraining; long-context pretraining)
and read just after it; launches made to compare a kernel with its plain
version fall outside those windows.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # outside the tensor cores
PEAK_BYTES = 3.35e12

# bf16 out, fp32 lse. out is held twice: elementwise, and by the relative
# Frobenius error over the valid rows. A typical |out| is ~0.07 here, so
# the elementwise 3e-2 alone could let a fault on the P.V side through (a
# wrong V row, a dropped key tile, a misrounded P).
FLASH_TOL = dict(out_atol=3e-2, out_rel=4e-3, lse_atol=1e-3)
# About 2.5 bf16 ulps of the output elementwise; the relative Frobenius error
# over the whole output is held too, since at the 0.02 weights used here a
# typical |out| is ~0.2 and the elementwise atol alone would pass 5% of it.
MLP_TOL = dict(atol=1e-2, rtol=1e-2, rel=2e-3)
# dq, dk, dv in bf16 against the plain version, which rounds p and ds at the
# same points: what is left is the order of the fp32 sums, which flips a
# bf16 rounding here and there (1 ulp of the largest values, ~4, is 0.03).
# The relative Frobenius error over the whole tensor is held much tighter,
# so that a dropped tile or a wrong row cannot hide under the elementwise
# bound. Padded rows must be exactly 0.
FLASH_BWD_TOL = dict(atol=3.2e-2, rel=2e-3)
# delta = rowsum(do * out) in fp32 from bf16 inputs, whose products are exact
# in fp32: only the order of 64 fp32 additions differs (|delta| ~1 here)
DELTA_ATOL = 1e-5
# dx bf16 (1 ulp of the largest values), dw fp32 summed over 65536 rows in
# another order than torch.sum's
RMS_BWD_TOL = dict(dx_atol=3.2e-2, dx_rel=2e-3, dw_rtol=1e-3)
LOSS_ATOL = 5e-3
# Gradients of the whole model, kernels against plain versions, in bf16: the
# two paths round at the same points but sum in another order, and through
# twelve layers forward and back a flipped bf16 rounding moves what follows.
# Relative Frobenius error per parameter on the 64 x 1024 batch; on an H100
# the worst of the 112 reads 3.8e-2 (a q_proj or k_proj weight of the last
# layer, whose gradient is small) and the median 1.7e-2. The limit is twice
# the worst reading.
GRAD_REL = 8e-2
HIDDEN_REL = 3e-2  # Frobenius norm of the difference over that of the plain run
# The fine-tune step (LayerScale, DropPath, attention dropout, pairs remat,
# the score head on the pooled last token) against the plain run, the same
# masks on both sides: the same rounding points, sums in another order
# through twelve layers. On an H100 the loss reads |diff| 3.6e-5 and the
# worst of the 137 gradients 3.543e-2 (layers.11.self_attn.q_proj), the
# same in three calls; the limits are about twice the gradient reading and
# the 1e-3 predicted for the loss.
FT_GRAD_REL = 7e-2
FT_LOSS_ATOL = 1e-3
# The denoise step (bi-causal split 16, pairs remat, the force head's plain
# attention and the 3D embeddings) and the position-pretraining step
# (save_attn, the 2D and 3D CE heads) against their plain runs on the same
# draws: the same rounding points, sums in another order through twelve
# layers. On an H100 (two calls, the same digits) the denoise step reads
# loss |diff| 4.4e-4 and worst gradient 3.162e-2, the position step 7.4e-5
# and 4.926e-2 (both at layers.11.self_attn.k_proj); each limit is about
# twice its reading, the loss limits the 1e-3 predicted.
DN_GRAD_REL = 7e-2
DN_LOSS_ATOL = 1e-3
POS_GRAD_REL = 1e-1
POS_LOSS_ATOL = 1e-3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, iters: int = 20, warmup: int = 3, repeats: int = 3) -> float:
    """Device time of fn() by CUDA events: the median of `repeats` readings,
    each the mean over `iters` back-to-back calls. The readings are kept in
    `cuda_ms.last` so that the caller can print the spread."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    readings = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        readings.append(start.elapsed_time(end) / iters)
    cuda_ms.last = readings
    return float(np.median(readings))


cuda_ms.last = []


def spread() -> str:
    """The last cuda_ms readings as 'min-max'."""
    return f"{min(cuda_ms.last):.4f}-{max(cuda_ms.last):.4f}"


def bound(nbytes: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """|a - b| / |b| in the Frobenius norm, in fp32."""
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def plain_in_row_chunks(ops, fn, tensors, rows: int = 8):
    """fn(*tensors) with the plain versions, `rows` rows of the leading axis
    at a time (None entries pass through), each output concatenated: keeps
    the plain attention's [rows, H, P, P] fp32 score tensors small."""
    n = next(t for t in tensors if t is not None).shape[0]
    parts = []
    with ops.reference_mode():
        for i in range(0, n, rows):
            parts.append(fn(*(None if t is None else t[i : i + rows] for t in tensors)))
    return tuple(torch.cat(outs) for outs in zip(*parts))


def check_flash_fwd(tag, out, lse, rout, rlse, seg):
    """(out, lse) of flash_fwd against the plain version's; returns the
    larger of the two elementwise errors."""
    valid = seg > 0
    err_out = (out.float() - rout.float()).abs().max().item()
    rel_out = ((out.float() - rout.float())[valid].norm() / rout.float()[valid].norm()).item()
    err_lse = (lse - rlse).abs().amax(dim=1)[valid].max().item()
    pad_ok = bool((out[~valid] == 0).all()) and bool((lse.transpose(1, 2)[~valid] == -1e30).all())
    print(
        f"flash_fwd[{tag}] max|out-plain| {err_out:.3e} (tol {FLASH_TOL['out_atol']}) "
        f"|out-plain|/|plain| {rel_out:.3e} (tol {FLASH_TOL['out_rel']}) "
        f"max|lse-plain| {err_lse:.3e} (tol {FLASH_TOL['lse_atol']}) padded rows ok {pad_ok}",
        flush=True,
    )
    if not (err_out <= FLASH_TOL["out_atol"] and rel_out <= FLASH_TOL["out_rel"]
            and err_lse <= FLASH_TOL["lse_atol"] and pad_ok):
        fail(f"flash_fwd[{tag}] disagrees with its plain version")
    return max(err_out, err_lse)


def check_flash_bwd(tag, got, ref, seg, name="flash_bwd", parts=("dq", "dk", "dv")):
    """(dq, dk, dv) of flash_bwd (or the outputs `parts` of another backward
    kernel) against the plain version's; returns the largest elementwise and
    the largest relative error."""
    valid = seg > 0
    errs, rels, pad_ok = [], [], True
    for g, r in zip(got, ref):
        errs.append((g.float() - r.float()).abs().max().item())
        rels.append(rel_err(g, r))
        pad_ok = pad_ok and bool((g[~valid] == 0).all())
    finite = all(bool(torch.isfinite(g.float()).all()) for g in got)
    print(
        f"{name}[{tag}] max|d-plain| "
        + " ".join(f"{n} {e:.3e}" for n, e in zip(parts, errs))
        + f" (tol {FLASH_BWD_TOL['atol']}) |d-plain|/|plain| "
        + " ".join(f"{n} {r:.3e}" for n, r in zip(parts, rels))
        + f" (tol {FLASH_BWD_TOL['rel']}) padded rows exactly 0: {pad_ok}",
        flush=True,
    )
    if not (max(errs) <= FLASH_BWD_TOL["atol"] and max(rels) <= FLASH_BWD_TOL["rel"]
            and pad_ok and finite):
        fail(f"{name}[{tag}] disagrees with its plain version")
    return max(errs), max(rels)


def check_mlp(name, tag, out, ref):
    """The output of an MLP kernel (norm_mlp or mlp) against its plain
    version's; returns the largest elementwise error."""
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    excess = (diff - MLP_TOL["atol"] - MLP_TOL["rtol"] * ref.float().abs()).max().item()
    rel = rel_err(out, ref)
    print(
        f"{name}[{tag}] max|out-plain| {err:.3e} (tol atol {MLP_TOL['atol']} + rtol "
        f"{MLP_TOL['rtol']} * |plain|, worst excess {excess:.3e}) |out-plain|/|plain| "
        f"{rel:.3e} (tol {MLP_TOL['rel']})",
        flush=True,
    )
    if not (excess <= 0 and rel <= MLP_TOL["rel"] and torch.isfinite(out.float()).all()):
        fail(f"{name}[{tag}] disagrees with its plain version")
    return err


def flash_tensors(seg, h: int, dh: int, seed: int = 0):
    """(qs, k, v, do), each [B, P, H*Dh] bf16 at 0.5 normal, drawn on seg's
    device from `seed`; q pre-scaled by Dh**-0.5 as the dispatcher hands it
    over."""
    b, p = seg.shape
    gen = torch.Generator(device=seg.device).manual_seed(seed)

    def randn():
        return (torch.randn(b, p, h * dh, generator=gen, device=seg.device) * 0.5).to(
            torch.bfloat16)

    qs = (randn() * torch.tensor(dh**-0.5, dtype=torch.bfloat16)).contiguous()
    k, v, do = randn(), randn(), randn()
    return qs, k, v, do


# per kernel: the products a (query, visible key) pair costs (each 2*Dh
# operations a head), the bf16 token-major tensors read or written, and the
# fp32 [B, H, P] rows read or written
_FLASH_WORK = {"fwd": (2, 4, 1), "bwd": (5, 8, 1), "dq": (3, 6, 2), "dkv": (4, 6, 2)}


def flash_work(fa, seg, causal: bool, h: int, dh: int, kind: str, bi: int = 0):
    """(bytes, operations) of flash_fwd ("fwd"), flash_bwd ("bwd"),
    flash_dq ("dq") or flash_dkv ("dkv") on these inputs. The products are
    q.k and p.v forward; S, dP, dv, dq, dk fused; S, dP, dq for dq; S, dP,
    dv, dk for dkv, each over the visible pairs of this mask only. The bytes
    are each bf16 tensor read or written once (q, k, v, out forward; q, k, v,
    do, out and dq, dk, dv fused; q, k, v, do, out and dq for dq, which
    computes delta too; q, k, v, do and dk, dv for dkv), the segment ids,
    cos, sin and the fp32 rows (lse; lse and delta)."""
    b, p = seg.shape
    products, tensors, rows = _FLASH_WORK[kind]
    pairs = int(fa._valid_mask(seg, causal, bi).sum().item())
    nbytes = tensors * b * p * h * dh * 2 + b * p * 4 + 2 * b * p * dh * 2 + rows * b * h * p * 4
    return nbytes, 2.0 * products * dh * h * pairs


def flash_at_shape(fa, ops, tag, seg, cos, sin, h: int, dh: int, causal: bool = False):
    """flash_fwd and flash_bwd at a path's own shape (seg [B, P]) against
    their plain versions, which run 8 rows at a time to keep their score
    tensors small; then both kernels' times beside their bounds."""
    qs, k, v, do = flash_tensors(seg, h, dh)
    out, lse = fa.flash_fwd(qs, k, v, seg, cos, sin, causal, dh)
    args = (qs, k, v, seg, cos, sin, out, lse, do, None, causal, dh)
    got = fa.flash_bwd(*args)
    sync(seg.device)
    rout, rlse = plain_in_row_chunks(
        ops, lambda *t: fa.flash_fwd(*t, causal, dh), (qs, k, v, seg, cos, sin))
    b, p = seg.shape
    fwd_err = check_flash_fwd(f"{tag}, B={b} P={p}", out, lse, rout, rlse, seg)
    ref = plain_in_row_chunks(
        ops, lambda *t: fa.flash_bwd(*t, causal, dh),
        (qs, k, v, seg, cos, sin, out, lse, do, None))
    err, rel = check_flash_bwd(f"{tag}, B={b} P={p}", got, ref, seg)
    del got, ref, rout, rlse
    ms = cuda_ms(lambda: fa.flash_bwd(*args), iters=10)
    ms_spread = spread()
    fwd_ms = cuda_ms(lambda: fa.flash_fwd(qs, k, v, seg, cos, sin, causal, dh), iters=10)
    fwd_spread = spread()
    nbytes, flops = flash_work(fa, seg, causal, h, dh, "bwd")
    bms, by = bound(nbytes, flops)
    fbytes, fflops = flash_work(fa, seg, causal, h, dh, "fwd")
    fbms, fby = bound(fbytes, fflops)
    print(
        f"flash_bwd[{tag}] B={b} P={p} H={h}: kernel {ms:.4f} ms (3 readings {ms_spread}), "
        f"bound {bms:.4f} ms ({by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); "
        f"flash_fwd[{tag}] kernel {fwd_ms:.4f} ms (3 readings {fwd_spread}), bound "
        f"{fbms:.4f} ms ({fby}: {fbytes / 1e6:.1f} MB, {fflops / 1e9:.2f} GFLOP)",
        flush=True,
    )
    return dict(err=err, rel=rel, fwd_err=fwd_err, ms=ms, bound_ms=bms, bound_by=by,
                fwd_ms=fwd_ms, fwd_bound_ms=fbms)


def split_at_shape(fa, ops, tag, seg, cos, sin, bi: int, h: int, dh: int):
    """The bi-causal flash_fwd and the split backward pair flash_dq and
    flash_dkv at one shape (seg [B, P], `bi` bit slots) against their plain
    versions (8 rows at a time), then each one's time (three CUDA-event
    readings) beside its bound, its plain version's time, and the time of
    SDPA with the bi-causal boolean mask (forward; forward's backward for
    the pair, which computes dq, dk and dv in one call). flash_dq's delta
    is held against its plain version too."""
    b, p = seg.shape
    qs, k, v, do = flash_tensors(seg, h, dh, seed=3)
    out, lse = fa.flash_fwd(qs, k, v, seg, cos, sin, False, dh, bi)
    dq_args = (qs, k, v, seg, cos, sin, out, lse, do, None, False, dh, bi)
    dq, delta = fa.flash_dq(*dq_args)
    args = (qs, k, v, seg, cos, sin, lse, delta, do, False, dh, bi)
    dk, dv = fa.flash_dkv(*args)
    sync(seg.device)
    shape = f"{tag}, B={b} P={p} split {p - bi}"
    rout, rlse = plain_in_row_chunks(
        ops, lambda *t: fa.flash_fwd(*t, False, dh, bi), (qs, k, v, seg, cos, sin))
    fwd_err = check_flash_fwd(f"bi-causal, {shape}", out, lse, rout, rlse, seg)
    del rout, rlse
    rdq, rdelta = plain_in_row_chunks(ops, lambda *t: fa.flash_dq(*t, False, dh, bi),
                                      (qs, k, v, seg, cos, sin, out, lse, do, None))
    delta_err = (delta - rdelta).abs().max().item()
    print(f"flash_dq[{shape}] max|delta-plain| {delta_err:.3e} (tol {DELTA_ATOL})", flush=True)
    if not delta_err <= DELTA_ATOL:
        fail(f"flash_dq[{shape}]'s delta disagrees with its plain version")
    dq_err, dq_rel = check_flash_bwd(shape, (dq,), (rdq,), seg, "flash_dq", ("dq",))
    rdk, rdv = plain_in_row_chunks(ops, lambda *t: fa.flash_dkv(*t, False, dh, bi),
                                   (qs, k, v, seg, cos, sin, lse, delta, do))
    dkv_err, dkv_rel = check_flash_bwd(shape, (dk, dv), (rdk, rdv), seg, "flash_dkv",
                                       ("dk", "dv"))
    del rdq, rdk, rdv

    rq = fa.rotate_tokens(qs, cos, sin, dh).view(b, p, h, dh).transpose(1, 2)
    rk = fa.rotate_tokens(k, cos, sin, dh).view(b, p, h, dh).transpose(1, 2)
    mask = fa._valid_mask(seg, False, bi)
    leaves = [t.detach().requires_grad_() for t in (rq, rk, v.view(b, p, h, dh).transpose(1, 2))]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_fwd = cuda_ms(lambda: sdpa(*leaves, attn_mask=mask, scale=1.0), iters=5)
    sd = sdpa(*leaves, attn_mask=mask, scale=1.0)
    do4 = do.view(b, p, h, dh).transpose(1, 2)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(sd, leaves, do4, retain_graph=True), iters=5)
    del sd, leaves, mask
    res = {}
    for kind, fn in (("fwd", lambda: fa.flash_fwd(qs, k, v, seg, cos, sin, False, dh, bi)),
                     ("dq", lambda: fa.flash_dq(*dq_args)), ("dkv", lambda: fa.flash_dkv(*args))):
        ms = cuda_ms(fn, iters=10)
        ms_spread = spread()
        with ops.reference_mode():
            plain_ms = cuda_ms(fn, iters=3)
        lib_ms = lib_fwd if kind == "fwd" else lib_bwd
        nbytes, flops = flash_work(fa, seg, False, h, dh, kind, bi)
        bms, by = bound(nbytes, flops)
        name = {"fwd": "flash_fwd[bi-causal]", "dq": "flash_dq", "dkv": "flash_dkv"}[kind]
        lib = "SDPA" if kind == "fwd" else "SDPA backward (dq, dk, dv)"
        print(
            f"{name} {tag} B={b} P={p} H={h} split {p - bi}: kernel {ms:.4f} ms (3 readings "
            f"{ms_spread}), plain {plain_ms:.4f} ms, {lib} {lib_ms:.4f} ms, bound {bms:.4f} ms "
            f"({by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP)",
            flush=True,
        )
        res[kind] = dict(ms=ms, plain_ms=plain_ms, lib_ms=lib_ms, bound_ms=bms, bound_by=by)
    res["fwd"]["err"] = fwd_err
    res["dq"].update(err=dq_err, rel=dq_rel, delta_err=delta_err)
    res["dkv"].update(err=dkv_err, rel=dkv_rel)
    return res


def split_phase(dev, fa, ops, synthetic, rope_cos_sin):
    """The split pair and the bi-causal forward at B 8 x P 1024 with 16 bit
    slots (split 1008, inside the sixteenth 64-row tile) on packed rows."""
    b, p, h, dh, bi = 8, 1024, 12, 64, 16
    seg_np = synthetic.packed_segments(b, p, np.random.default_rng(7))
    seg_np[-1, p - 40 : p - bi] = 0  # a padded stretch before the last row's bit slots
    seg = torch.from_numpy(seg_np).to(dev)
    pos = torch.arange(p, device=dev).expand(b, p)
    cos, sin = (t.to(torch.bfloat16) for t in rope_cos_sin(pos, dh))
    return split_at_shape(fa, ops, "P1024", seg, cos, sin, bi, h, dh)


def flash_phase(dev, fa, ops, synthetic, rope_cos_sin):
    b, p, h, dh = 8, 1024, 12, 64
    rng = np.random.default_rng(0)
    seg_np = synthetic.packed_segments(b, p, rng)
    seg_np[-1, p - 40 :] = 0  # a padded tail
    seg = torch.from_numpy(seg_np).to(dev)
    qs, k, v, _ = flash_tensors(seg, h, dh)
    pos = torch.arange(p, device=dev).expand(b, p)
    cos, sin = (t.to(torch.bfloat16) for t in rope_cos_sin(pos, dh))

    res = {}
    for causal in (False, True):
        args = (qs, k, v, seg, cos, sin, causal, dh)
        out, lse = fa.flash_fwd(*args)
        torch.cuda.synchronize()
        with ops.reference_mode():
            rout, rlse = fa.flash_fwd(*args)
        tag = "causal" if causal else "bidirectional"
        err = check_flash_fwd(f"{tag}, B={b}", out, lse, rout, rlse, seg)

        ms = cuda_ms(lambda: fa.flash_fwd(*args))
        ms_spread = spread()
        with ops.reference_mode():
            plain_ms = cuda_ms(lambda: fa.flash_fwd(*args), iters=5)
        # library yardstick: SDPA with a boolean block-diagonal mask on the
        # rotated q, k (the rotation itself is not timed)
        rq = fa.rotate_tokens(qs, cos, sin, dh).view(b, p, h, dh).transpose(1, 2)
        rk = fa.rotate_tokens(k, cos, sin, dh).view(b, p, h, dh).transpose(1, 2)
        v4 = v.view(b, p, h, dh).transpose(1, 2)
        mask = fa._valid_mask(seg, causal)
        lib_ms = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                rq, rk, v4, attn_mask=mask, scale=1.0
            ),
            iters=5,
        )
        nbytes, flops = flash_work(fa, seg, causal, h, dh, "fwd")
        bms, by = bound(nbytes, flops)
        print(
            f"flash_fwd[{tag}] B={b} P={p} H={h} Dh={dh}: kernel {ms:.4f} ms (3 readings "
            f"{ms_spread}), plain {plain_ms:.4f} ms, "
            f"SDPA {lib_ms:.4f} ms, bound {bms * 1e3:.2f} us ({by}: {nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.3f} GFLOP)",
            flush=True,
        )
        res[tag] = dict(err=err, ms=ms, plain_ms=plain_ms, lib_ms=lib_ms,
                        bound_ms=bms, bound_by=by)
    return res


def norm_mlp_at_shape(dev, mlp, ops, n: int, tag: str, time_plain: bool = True):
    """norm_mlp (gelu, D 768, F 3072, weights at 0.02) against its plain
    version on N rows, then its time (three CUDA-event readings) beside the
    plain version's, when asked, and the bound."""
    d, f = 768, 3072
    gen = torch.Generator(device=dev).manual_seed(1)
    wn = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
    wg, wu = (
        (torch.randn(f, d, generator=gen, device=dev) * 0.02).to(torch.bfloat16) for _ in range(2)
    )
    wd = (torch.randn(d, f, generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    x = torch.randn(n, d, generator=gen, device=dev).to(torch.bfloat16)
    args = (x, wn, wg, wu, wd, 1e-6, "gelu")
    out = mlp.norm_mlp(*args)
    torch.cuda.synchronize()
    with ops.reference_mode():
        ref = mlp.norm_mlp(*args)
    err = check_mlp("norm_mlp", f"{tag}, N={n}", out, ref)
    del out, ref
    ms = cuda_ms(lambda: mlp.norm_mlp(*args), iters=10)
    ms_spread = spread()
    plain_ms = None
    if time_plain:
        with ops.reference_mode():
            plain_ms = cuda_ms(lambda: mlp.norm_mlp(*args), iters=3)
    flops = 2.0 * n * d * f * 3
    nbytes = 2 * n * d * 2 + d * 4 + 3 * d * f * 2
    bms, by = bound(nbytes, flops)
    plain = "not timed" if plain_ms is None else f"{plain_ms:.4f} ms"
    print(
        f"norm_mlp[{tag}] N={n} D={d} F={f} gelu: kernel {ms:.4f} ms (3 readings {ms_spread}), "
        f"plain {plain}, library none, bound {bms:.4f} ms ({by}: {nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.1f} GFLOP)",
        flush=True,
    )
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)


def mlp_phase(dev, mlp, ops):
    """norm_mlp at the serving batch's N 8192 and the training batch's
    N 65536 (64 x 1024 rows; the plain version is not timed there)."""
    r = norm_mlp_at_shape(dev, mlp, ops, 8192, "serving shape")
    t = norm_mlp_at_shape(dev, mlp, ops, 65536, "train shape", time_plain=False)
    return dict(r, err=max(r["err"], t["err"]), lib_ms=None, train_ms=t["ms"],
                train_bound_ms=t["bound_ms"])


def flash_bwd_phase(dev, fa, ops, synthetic, rope_cos_sin):
    """flash_bwd against flash_bwd_ref at B 8 (bidirectional and causal, a
    padded tail) with its times; then, at the training batch B 64,
    flash_fwd and flash_bwd against their plain versions and their times."""
    p, h, dh = 1024, 12, 64

    def inputs(b):
        rng = np.random.default_rng(0)
        seg_np = synthetic.packed_segments(b, p, rng)
        seg_np[-1, p - 40 :] = 0  # a padded tail
        seg = torch.from_numpy(seg_np).to(dev)
        pos = torch.arange(p, device=dev).expand(b, p)
        cos, sin = (t.to(torch.bfloat16) for t in rope_cos_sin(pos, dh))
        return seg, cos, sin

    res = {}
    b = 8
    seg, cos, sin = inputs(b)
    qs, k, v, do = flash_tensors(seg, h, dh)
    for causal in (False, True):
        tag = "causal" if causal else "bidirectional"
        out, lse = fa.flash_fwd(qs, k, v, seg, cos, sin, causal, dh)
        args = (qs, k, v, seg, cos, sin, out, lse, do, None, causal, dh)
        got = fa.flash_bwd(*args)
        torch.cuda.synchronize()
        with ops.reference_mode():
            ref = fa.flash_bwd(*args)
        err, rel = check_flash_bwd(f"{tag}, B={b}", got, ref, seg)

        ms = cuda_ms(lambda: fa.flash_bwd(*args))
        ms_spread = spread()
        with ops.reference_mode():
            plain_ms = cuda_ms(lambda: fa.flash_bwd(*args), iters=3)
        # library yardstick: the backward of SDPA with a boolean block-diagonal
        # mask on the rotated q, k (rotation and forward are not timed)
        rq = fa.rotate_tokens(qs, cos, sin, dh).view(b, p, h, dh).transpose(1, 2)
        rk = fa.rotate_tokens(k, cos, sin, dh).view(b, p, h, dh).transpose(1, 2)
        leaves = [t.detach().requires_grad_() for t in (rq, rk, v.view(b, p, h, dh).transpose(1, 2))]
        mask = fa._valid_mask(seg, causal)
        sd = torch.nn.functional.scaled_dot_product_attention(*leaves, attn_mask=mask, scale=1.0)
        do4 = do.view(b, p, h, dh).transpose(1, 2)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(sd, leaves, do4, retain_graph=True), iters=5)
        del sd, leaves
        nbytes, flops = flash_work(fa, seg, causal, h, dh, "bwd")
        bms, by = bound(nbytes, flops)
        print(
            f"flash_bwd[{tag}] B={b} P={p} H={h} Dh={dh}: kernel {ms:.4f} ms (3 readings "
            f"{ms_spread}), plain {plain_ms:.4f} ms, SDPA backward {lib_ms:.4f} ms, bound "
            f"{bms * 1e3:.2f} us ({by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP)",
            flush=True,
        )
        res[tag] = dict(err=err, rel=rel, ms=ms, plain_ms=plain_ms, lib_ms=lib_ms,
                        bound_ms=bms, bound_by=by)
    del qs, k, v, seg, cos, sin, do, got, ref

    # the training batch: B 64, bidirectional
    res["train"] = flash_at_shape(fa, ops, "train shape", *inputs(64), h, dh)
    return res


def rms_bwd_phase(dev, mlp, ops, n: int = 65536):
    """rmsnorm_bwd against its plain version at N rows of D 768, with its
    time beside the plain version's, F.rms_norm's backward and the bound."""
    d = 768
    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(n, d, generator=gen, device=dev).to(torch.bfloat16)
    g = torch.randn(n, d, generator=gen, device=dev).to(torch.bfloat16)
    w = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
    eps = 1e-6
    dx, dw = mlp.rmsnorm_bwd(x, g, w, eps)
    sync(dev)
    with ops.reference_mode():
        rdx, rdw = mlp.rmsnorm_bwd(x, g, w, eps)
    err_dx = (dx.float() - rdx.float()).abs().max().item()
    rel_dx = rel_err(dx, rdx)
    rel_dw = ((dw - rdw).abs() / (rdw.abs() + 1.0)).max().item()
    print(
        f"rmsnorm_bwd[N={n}] max|dx-plain| {err_dx:.3e} (tol {RMS_BWD_TOL['dx_atol']}) "
        f"|dx-plain|/|plain| {rel_dx:.3e} (tol {RMS_BWD_TOL['dx_rel']}) "
        f"max|dw-plain|/(|plain|+1) {rel_dw:.3e} (tol {RMS_BWD_TOL['dw_rtol']})",
        flush=True,
    )
    if not (err_dx <= RMS_BWD_TOL["dx_atol"] and rel_dx <= RMS_BWD_TOL["dx_rel"]
            and rel_dw <= RMS_BWD_TOL["dw_rtol"] and bool(torch.isfinite(dw).all())):
        fail(f"rmsnorm_bwd[N={n}] disagrees with its plain version")
    ms = cuda_ms(lambda: mlp.rmsnorm_bwd(x, g, w, eps))
    ms_spread = spread()
    with ops.reference_mode():
        plain_ms = cuda_ms(lambda: mlp.rmsnorm_bwd(x, g, w, eps), iters=5)
    # library yardstick: autograd's backward of torch.nn.functional.rms_norm,
    # with the weight in bf16 (with an fp32 weight it leaves its fused kernel)
    xl, wl = x.detach().requires_grad_(), w.to(torch.bfloat16).requires_grad_()
    y = torch.nn.functional.rms_norm(xl, (d,), wl, eps)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(y, (xl, wl), g.to(y.dtype), retain_graph=True),
                     iters=5)
    nbytes = 3 * n * d * 2 + 2 * d * 4
    flops = 12.0 * n * d  # a dozen fp32 operations an element, outside the tensor cores
    bms, by = bound(nbytes, flops, PEAK_F32_FLOPS)
    print(
        f"rmsnorm_bwd N={n} D={d}: kernel {ms:.4f} ms (3 readings {ms_spread}), plain "
        f"{plain_ms:.4f} ms, F.rms_norm backward {lib_ms:.4f} ms (bf16 weight), bound "
        f"{bms:.4f} ms ({by}: {nbytes / 1e6:.1f} MB)",
        flush=True,
    )
    return dict(err=max(err_dx, rel_dw), ms=ms, plain_ms=plain_ms, lib_ms=lib_ms, bound_ms=bms,
                bound_by=by)


def step_vs_plain(model, batch, ops, tag, loss_atol, grad_rel, call=dict):
    """One training forward and backward with the kernels against the same
    with the plain versions: the loss and every parameter's gradient.
    `call()` gives the model call's other keyword arguments, made afresh for
    each run so that both draw the same (dropout generators, draws).
    `grad_rel` is one limit for every gradient, or a limit per parameter
    name. Prints the plain run's peak memory; returns the worst relative
    error (all of them in `step_vs_plain.last`)."""

    def run():
        model.zero_grad(set_to_none=True)
        loss = model(batch, train=True, **call())["loss"]
        loss.backward()
        g = {k: q.grad.detach().clone() for k, q in model.named_parameters()
             if q.grad is not None}
        model.zero_grad(set_to_none=True)
        return loss.item(), g

    cuda = model.device.type == "cuda"
    loss_k, grads_k = run()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with ops.reference_mode():
        loss_p, grads_p = run()
    peak = (f"; plain run's max_memory_allocated {torch.cuda.max_memory_allocated() / 2**20:.0f}"
            " MiB" if cuda else "")
    rels = {k: rel_err(grads_k[k], grads_p[k]) for k in grads_p}
    step_vs_plain.last = rels
    limit = grad_rel if isinstance(grad_rel, dict) else {k: grad_rel for k in rels}
    worst = max(rels, key=lambda k: rels[k] / limit[k])
    print(
        f"{tag} step vs plain ({batch['input_ids'].shape[0]} rows, the same draws): loss "
        f"{loss_k:.6f} vs {loss_p:.6f} (|diff| {abs(loss_k - loss_p):.3e}, tol {loss_atol}); "
        f"{len(rels)} gradients, worst |g-plain|/|plain| {rels[worst]:.3e} at {worst} "
        f"(tol {limit[worst]:.3g}), median {float(np.median(list(rels.values()))):.3e}{peak}",
        flush=True,
    )
    if not (set(grads_k) == set(grads_p) == {k for k, _ in model.named_parameters()}
            and abs(loss_k - loss_p) <= loss_atol and rels[worst] <= limit[worst]
            and all(bool(torch.isfinite(g).all()) for g in grads_k.values())):
        fail(f"the {tag} step with kernels disagrees with the plain run")
    return rels[worst]


step_vs_plain.last = {}


def counted_steps(tag, state, step_fn, batch, counters, want, steps, timed_from=1):
    """`steps` training steps with the launch counts set to 0 first and
    checked against `want` after each; returns (state, metrics, launches,
    ms per step by CUDA events over the steps from `timed_from` on, peak
    MiB), the last two None off the card."""
    cuda = batch["input_ids"].is_cuda
    for fn in counters.values():
        fn.launches = 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    metrics, before = [], {k: 0 for k in counters}
    for i in range(steps):
        if i == timed_from and cuda:
            start.record()
        state, m = step_fn(state, batch, seed=0)
        metrics.append(m)
        now = {k: fn.launches for k, fn in counters.items()}
        per_step = {k: now[k] - before[k] for k in now}
        before = now
        if per_step != want:
            fail(f"{tag} step {i} launched {per_step}, expected {want}")
    launches = {k: fn.launches for k, fn in counters.items()}
    if not cuda:
        return state, metrics, launches, None, None
    end.record()
    torch.cuda.synchronize()
    return state, metrics, launches, start.elapsed_time(end) / (steps - timed_from), \
        torch.cuda.max_memory_allocated() / 2**20


def train_phase(model, nb, counters, steps: int = 12):
    """`steps` SMTP training steps on one batch repeated: AdamW at lr 3e-4
    with warmup_decay over 20 steps (2 of warm-up), EMA on. `counters` maps
    a kernel's name to its wrapper; the launch counts are set to 0 before
    the steps, read after every step and returned."""
    from graphgpt_torch import synthetic
    from graphgpt_torch.config import OptimizerConfig
    from graphgpt_torch.training.optimizer import make_optimizer, make_schedule
    from graphgpt_torch.training.steps import init_train_state, make_train_step

    cfg, dev = model.cfg, model.device
    batch = synthetic.to_torch(nb, dev)
    opt_cfg = OptimizerConfig(lr=3e-4, use_ema=True)
    schedule = make_schedule(opt_cfg, 20, 2)
    tx = make_optimizer(opt_cfg, 20, 2, schedule=schedule)
    state = init_train_state(model, tx, use_ema=True)
    step_fn = make_train_step(tx, opt_cfg, schedule)
    L = cfg.num_hidden_layers
    want = {**{k: 0 for k in counters}, "flash_fwd": L, "flash_bwd": L, "norm_mlp": L,
            "rmsnorm_bwd": L + 1}
    timed_from = 2
    state, metrics, launches, ms, peak = counted_steps(
        "training", state, step_fn, batch, counters, want, steps, timed_from)
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    lrs = [m["lr"] for m in metrics]
    print("train losses: " + " ".join(f"{x:.4f}" for x in losses), flush=True)
    print("train grad norms: " + " ".join(f"{x:.4f}" for x in norms), flush=True)
    print("train lr: " + " ".join(f"{x:.2e}" for x in lrs), flush=True)
    print(f"train launches per step: {want}; over {steps} steps: {launches}", flush=True)
    if not (all(np.isfinite(losses)) and all(np.isfinite(norms))):
        fail("a training loss or gradient norm is not finite")
    if not losses[-1] < losses[0]:
        fail(f"the loss did not fall: {losses[0]} -> {losses[-1]}")
    ema_moved = any(
        not torch.equal(e, p.detach().float())
        for e, p in zip(state.ema_params.values(), model.parameters())
    )
    if not ema_moved:
        fail("the EMA copy is the parameters themselves")
    if ms is not None:
        b, p = nb["segment_ids"].shape
        valid = int((nb["segment_ids"] > 0).sum())
        print(
            f"train: B={b} P={p}, {L} layers, remat {cfg.remat_policy if cfg.remat else 'off'}: "
            f"{ms:.2f} ms/step (CUDA events over steps {timed_from + 1}-{steps}), "
            f"{valid / ms * 1e3:.0f} trained tokens/s ({valid} valid of {b * p} positions), "
            f"max_memory_allocated {peak:.0f} MiB",
            flush=True,
        )
    return launches


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def eval_phase(model, nb) -> float:
    """The SMTP eval loss of one packed batch; must be finite."""
    from graphgpt_torch import synthetic

    cfg, dev = model.cfg, model.device
    b, p, f = nb["input_ids"].shape
    batch = synthetic.to_torch(nb, dev)
    sync(dev)
    t0 = time.perf_counter()
    loss = model.loss(batch).item()
    ms = (time.perf_counter() - t0) * 1e3
    print(
        f"eval: hidden {cfg.hidden_size}, {cfg.num_hidden_layers} layers, "
        f"{cfg.num_attention_heads} heads, FFN {cfg.intermediate_size}, vocab {cfg.vocab_size}, "
        f"F {f}, next_n {cfg.next_n_token}, B={b} P={p}: loss {loss:.6f} in {ms:.1f} ms "
        f"(first call)",
        flush=True,
    )
    if not np.isfinite(loss):
        fail(f"eval loss is not finite: {loss}")
    return loss


def generation_phase(model, nb) -> int:
    """dLLM unmasking of a 30-40% band of the real cells with the default
    GenerationConfig; every masked cell must be filled. Returns the number
    of model forwards (steps) taken."""
    from graphgpt_torch import synthetic
    from graphgpt_torch.config import GenerationConfig
    from graphgpt_torch.generation import dllm

    cfg, dev = model.cfg, model.device
    mask_id = cfg.mask_token_id
    gcfg = GenerationConfig()
    ids = nb["input_ids"]
    b, p, f = ids.shape
    masked, mask = dllm.mask_at_ratio(ids, mask_id, (0.3, 0.4), np.random.default_rng(3))
    real = int((ids != cfg.pad_token_id).sum())
    n_masked = int(mask.sum())
    batch = synthetic.to_torch(nb, dev)
    # the sampler may not emit the special tokens (pad 0, mask 1): a random
    # model would otherwise predict the mask id for some cells
    special = torch.tensor([cfg.pad_token_id, mask_id], device=dev)

    def logits_fn(x_flat, position_ids, segment_ids):
        lg = model.logits(
            {"input_ids": x_flat.view(b, p, f), "position_ids": position_ids,
             "segment_ids": segment_ids}
        ).view(b, p * f, -1)
        lg[..., special] = float("-inf")
        return lg

    sampler = dllm.make_unmask_sampler(logits_fn, gcfg, mask_id, device=dev)
    x0 = torch.from_numpy(masked.reshape(b, p * f)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    sync(dev)
    t0 = time.perf_counter()
    if dev.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    xg = sampler(x0, gen, batch["position_ids"], batch["segment_ids"])
    if dev.type == "cuda":
        end.record()
        torch.cuda.synchronize()
        gen_s = start.elapsed_time(end) / 1e3
    else:
        gen_s = time.perf_counter() - t0
    steps = sampler.forwards
    peak = torch.cuda.max_memory_allocated() / 2**20 if dev.type == "cuda" else float("nan")
    left = int((xg == mask_id).sum())
    mask_t = torch.from_numpy(mask.reshape(b, p * f)).to(dev)
    truth = torch.from_numpy(ids.reshape(b, p * f)).to(dev)
    acc = dllm.generation_accuracy(xg, truth, mask_t)
    print(
        f"generation: {n_masked} of {real} real cells masked ({n_masked / real:.3f}), "
        f"{gcfg.alg}, {gcfg.steps} steps: {steps} steps taken, "
        f"{gen_s * 1e3 / max(steps, 1):.2f} ms/step, {n_masked / gen_s:.0f} generated cells/s, "
        f"{left} masked cells left, accuracy {float(acc['acc']):.4f} over "
        f"{int(acc['n_masked'])} cells (random weights), max_memory_allocated {peak:.0f} MiB",
        flush=True,
    )
    if left != 0 or bool((xg[~mask_t] != x0[~mask_t]).any()):
        fail("generation left masked cells or changed unmasked ones")
    return steps


def timing_phase(model, nb) -> None:
    """The eval forward and one generation step's model forward, each timed
    seven times with CUDA events: median and spread. Runs outside the
    counted windows."""
    from graphgpt_torch import synthetic

    batch = synthetic.to_torch(nb, model.device)
    ms = cuda_ms(lambda: model.loss(batch), iters=1, warmup=2, repeats=7)
    print(f"eval forward + loss: median {ms:.2f} ms over 7 runs (spread {spread()})", flush=True)
    ms = cuda_ms(lambda: model.logits(batch), iters=1, warmup=2, repeats=7)
    print(f"generation step's forward (logits): median {ms:.2f} ms over 7 runs "
          f"(spread {spread()})", flush=True)


def compare_plain(model, nb, ops) -> None:
    """The eval forward with the kernels against the same forward with the
    plain versions: loss and final hidden states."""
    from graphgpt_torch import synthetic

    dev = model.device
    batch = synthetic.to_torch(nb, dev)
    sync(dev)
    t0 = time.perf_counter()
    out_k = model(batch)
    sync(dev)
    kernel_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    with ops.reference_mode():
        out_p = model(batch)
    sync(dev)
    plain_ms = (time.perf_counter() - t0) * 1e3
    loss_k, loss_p = out_k["loss"].item(), out_p["loss"].item()
    hk, hp = out_k["hidden_states"].float(), out_p["hidden_states"].float()
    rel = ((hk - hp).norm() / hp.norm()).item()
    print(
        f"eval vs plain: loss {loss_k:.6f} vs {loss_p:.6f} (|diff| {abs(loss_k - loss_p):.3e}, "
        f"tol {LOSS_ATOL}); hidden-state relative error {rel:.3e} (tol {HIDDEN_REL}); "
        f"forward {kernel_ms:.1f} ms with kernels, {plain_ms:.1f} ms plain",
        flush=True,
    )
    if not (abs(loss_k - loss_p) <= LOSS_ATOL and rel <= HIDDEN_REL):
        fail("the eval forward with kernels disagrees with the plain run")


def split_mlp_phase(dev, mlp, ops, n_ft: int):
    """Kernel #11 against its plain version: gelu at N 8192 (the serving
    batch of a LayerScale model) and at the fine-tune batch's N, silu at a
    small ragged N; three CUDA-event readings beside the plain time and the
    bound at both large shapes."""
    d, f = 768, 3072
    gen = torch.Generator(device=dev).manual_seed(6)
    wg, wu = (
        (torch.randn(f, d, generator=gen, device=dev) * 0.02).to(torch.bfloat16) for _ in range(2)
    )
    wd = (torch.randn(d, f, generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    res, err = {}, 0.0
    for n, act in ((200, "silu"), (8192, "gelu"), (n_ft, "gelu")):
        x = torch.randn(n, d, generator=gen, device=dev).to(torch.bfloat16)
        out = mlp.mlp(x, wg, wu, wd, act)
        torch.cuda.synchronize()
        with ops.reference_mode():
            ref = mlp.mlp(x, wg, wu, wd, act)
        err = max(err, check_mlp("mlp", f"N={n}, {act}", out, ref))
        del out, ref
        if n == 200:
            continue
        ms = cuda_ms(lambda: mlp.mlp(x, wg, wu, wd, act), iters=10)
        ms_spread = spread()
        with ops.reference_mode():
            plain_ms = cuda_ms(lambda: mlp.mlp(x, wg, wu, wd, act), iters=3)
        flops = 2.0 * n * d * f * 3
        nbytes = 2 * n * d * 2 + 3 * d * f * 2
        bms, by = bound(nbytes, flops)
        print(
            f"mlp N={n} D={d} F={f} {act}: kernel {ms:.4f} ms (3 readings {ms_spread}), plain "
            f"{plain_ms:.4f} ms, library none, bound {bms * 1e3:.2f} us ({by}: "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP)",
            flush=True,
        )
        res[n] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
    r = dict(res[8192], err=err, lib_ms=None, finetune_shape_n=n_ft,
             finetune_shape_ms=res[n_ft]["ms"], finetune_shape_plain_ms=res[n_ft]["plain_ms"],
             finetune_shape_bound_ms=res[n_ft]["bound_ms"])
    return r


def finetune_config(out_dir: str, pretrain_dir: str):
    """GraphGPT-base fine-tuned as configs/pcqm4m_v2_supervised.yaml sets it
    up (768 x 12, gated aggregation over 13 stacked features, graph
    regression with the L1 loss, pairs remat, bf16 over fp32 weights, batch
    256, lr 2e-4 onecycle, EMA 0.9999), plus the regularisers that
    configs/ogbn_proteins_supervised.yaml and ogbl_wikikg2_supervised.yaml give
    the same width (LayerScale 1.0, path and attention dropout 0.1), on the
    synthetic molecules (PCQM4M-v2's schema), one epoch."""
    from graphgpt_torch.config import Config

    cfg = Config()
    tok = cfg.tokenization
    tok.dataset = "synthetic_mol"
    tok.semantics.node.discrete, tok.semantics.node.dim = "node_attr", 9
    tok.semantics.edge.discrete, tok.semantics.edge.dim = "edge_attr", 3
    m = cfg.model
    m.hidden_size, m.num_hidden_layers = 768, 12
    m.stacked_feat_agg_method = "gated"
    m.problem_type, m.loss_type, m.num_labels = "regression", "l1", 1
    m.dtype, m.remat, m.remat_policy = "bfloat16", True, "pairs"
    m.layer_scale_init_value, m.path_dropout, m.attention_dropout = 1.0, 0.1, 0.1
    t = cfg.training
    t.task_type, t.output_dir, t.pretrain_cpt = "graph", out_dir, pretrain_dir
    t.batch_size, t.max_length = 256, 1024
    t.schedule.epochs, t.schedule.logging_steps = 1, 1
    t.optimizer.lr, t.optimizer.scheduler = 2e-4, "onecycle"
    t.optimizer.use_ema, t.optimizer.ema_decay = True, 0.9999
    return cfg


def count_per_call(fn, counters, log):
    """fn wrapped so that each call appends its launches per kernel to log."""

    def wrapped(*args, **kwargs):
        before = {k: c.launches for k, c in counters.items()}
        out = fn(*args, **kwargs)
        log.append({k: c.launches - before[k] for k, c in counters.items()})
        return out

    return wrapped


def finetune_phase(pretrain_model, counters, fa, mlp, ops):
    """The fine-tune path end to end (see the module docstring, 7). Returns
    (each kernel's results at the fine-tune batch's shape, the launches of
    the whole fine-tune run)."""
    from graphgpt_torch import synthetic
    from graphgpt_torch.config import OptimizerConfig
    from graphgpt_torch.models.modeling import derive_generator
    from graphgpt_torch.models.rope import reset_position_ids, rope_cos_sin
    from graphgpt_torch.training.checkpoint import Checkpointer
    from graphgpt_torch.training.finetune import FinetunePipeline
    from graphgpt_torch.training.optimizer import make_optimizer
    from graphgpt_torch.training.steps import init_train_state

    dev = pretrain_model.device
    with tempfile.TemporaryDirectory() as tmp:
        pt_dir, ft_dir = os.path.join(tmp, "pretrain"), os.path.join(tmp, "finetune")
        pt_sd = {k: v.detach().clone() for k, v in pretrain_model.state_dict().items()}
        tx = make_optimizer(OptimizerConfig(), 10, 1)
        Checkpointer(os.path.join(pt_dir, "ckpt")).save(
            0, init_train_state(pretrain_model, tx), {"phase": "train"})
        cfg = finetune_config(ft_dir, pt_dir)
        t0 = time.perf_counter()
        pipe = FinetunePipeline(cfg, device=dev).setup()
        # cut as the JAX package's pipeline test does: 8 batches, 512 valid
        pipe.train_idx = pipe.train_idx[: 8 * cfg.training.batch_size]
        pipe.valid_idx = pipe.test_idx = pipe.valid_idx[:512]
        model = pipe.state.model
        taken = sorted(k for k, v in model.state_dict().items()
                       if k in pt_sd and pt_sd[k].shape == v.shape and torch.equal(v, pt_sd[k]))
        fresh = sorted(k for k in model.state_dict() if k not in taken)
        print(f"finetune setup {time.perf_counter() - t0:.1f} s; warm start took {len(taken)} "
              f"tensors from the train phase's checkpoint, kept fresh: {fresh[:3]} ... "
              f"({len(fresh)}: the heads, LayerScale, the gated aggregation, and the embedding "
              f"table, vocab {cfg.model.vocab_size} here against "
              f"{pretrain_model.cfg.vocab_size})", flush=True)
        if len(taken) < 12 * 9 + 1:
            fail("the warm start took less than every decoder weight and the final norm")
        if any(k.startswith(("score", "lm_head", "n_token_proj")) for k in taken):
            fail("the warm start took a head")

        # the first batch of epoch 0, as run() draws it
        seed = cfg.training.seed
        idx0 = np.random.default_rng((seed, 0)).permutation(pipe.train_idx)
        nb = next(pipe.loader.epoch_batches(idx0, 0)).data
        batch = synthetic.to_torch(nb, dev)
        b, p = nb["segment_ids"].shape
        n_ft = b * p
        print(f"fine-tune batch: {b} graphs x {p} positions (N {n_ft}), "
              f"{int((nb['segment_ids'] > 0).sum())} tokens", flush=True)
        # every kernel of the step at this batch's shape against its plain
        # version: the attention at its own segments and RoPE table (P 72
        # leaves a ragged second 64-row tile), the norm backward at N rows
        mc = model.cfg
        pos = reset_position_ids(batch["position_ids"], mc.rope_range)
        cos, sin = (t.to(torch.bfloat16) for t in rope_cos_sin(
            pos, mc.head_dim, mc.rope_theta, resonance=mc.rope_resonance,
            rope_scaling=mc.rope_scaling, max_position_embeddings=mc.max_position_embeddings))
        shape = dict(
            mlp=split_mlp_phase(dev, mlp, ops, n_ft),
            flash=flash_at_shape(fa, ops, "finetune shape", batch["segment_ids"], cos, sin,
                                 mc.num_attention_heads, mc.head_dim, mc.causal_attention),
            rms=rms_bwd_phase(dev, mlp, ops, n_ft),
        )
        del cos, sin

        # the first step against the plain run: the same generator, so the
        # same dropout masks
        step_vs_plain(model, batch, ops, "finetune", FT_LOSS_ATOL, FT_GRAD_REL,
                      lambda: dict(generator=derive_generator(seed, 0, dev)))

        # the counted run
        L = cfg.model.num_hidden_layers
        train_log, ema_log, metrics = [], [], []
        step_fn = count_per_call(pipe.train_step, counters, train_log)

        def train_step(*a, **kw):
            state, m = step_fn(*a, **kw)
            metrics.append(m)
            return state, m

        pipe.train_step = train_step
        pipe.eval_step_ema = count_per_call(pipe.eval_step_ema, counters, ema_log)
        ema0 = {k: v.clone() for k, v in pipe.state.ema_params.items()}
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        best = pipe.run()
        run_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated() / 2**20

        want = {**{k: 0 for k in counters}, "mlp": 2 * L, "flash_fwd": 2 * L, "flash_bwd": L,
                "rmsnorm_bwd": 2 * L + 1}
        for i, got in enumerate(train_log):
            if got != want:
                fail(f"fine-tune step {i} launched {got}, expected {want}")
        want_eval = {**{k: 0 for k in counters}, "mlp": L, "flash_fwd": L}
        for i, got in enumerate(ema_log):
            if got != want_eval:
                fail(f"EMA eval forward {i} launched {got}, expected {want_eval}")
        losses = [float(m["loss"]) for m in metrics]
        norms = [float(m["grad_norm"]) for m in metrics]
        print("finetune losses: " + " ".join(f"{x:.4f}" for x in losses), flush=True)
        print("finetune grad norms: " + " ".join(f"{x:.4f}" for x in norms), flush=True)
        print(f"finetune launches per step: {want} (all {len(train_log)} steps); per EMA eval "
              f"forward: {want_eval} (all {len(ema_log)}); whole run: {launches}", flush=True)
        if len(losses) != 8 or not (all(np.isfinite(losses)) and all(np.isfinite(norms))):
            fail(f"expected 8 finite fine-tune losses and gradient norms: {losses} {norms}")
        if not any(not torch.equal(e, ema0[k]) for k, e in pipe.state.ema_params.items()):
            fail("the EMA copy did not move")
        print(f"finetune eval: valid_mae {best.get('valid_mae')}, valid_ema_mae "
              f"{best.get('valid_ema_mae')}, test_mae {best.get('test_mae')}, train_mae "
              f"{best.get('train_mae')}", flush=True)
        if not all(np.isfinite(best.get(k, np.nan)) for k in ("valid_mae", "valid_ema_mae")):
            fail(f"the valid and EMA-valid MAE are not finite: {best}")
        if not (os.path.exists(os.path.join(ft_dir, "result.csv"))
                and Checkpointer(os.path.join(ft_dir, "ckpt_ema_best")).all_steps() == [0]):
            fail("result.csv or the EMA-best checkpoint was not written")

        # timings outside the counted window: a step on a batch already on
        # the card, and the host loader alone
        ms = cuda_ms(lambda: pipe.train_step(pipe.state, batch, seed=seed), iters=1, warmup=1,
                     repeats=5)
        ms_spread = spread()
        t0 = time.perf_counter()
        n_graphs = sum(bb["segment_ids"].shape[0]
                       for bb in pipe.loader.epoch_batches(pipe.train_idx[:512], epoch=1))
        loader_s = time.perf_counter() - t0
        tokens = int((nb["segment_ids"] > 0).sum())
        print(
            f"finetune: {ms:.2f} ms/step on a batch on the card (5 readings {ms_spread}), "
            f"{tokens / ms * 1e3:.0f} tokens/s, {b / ms * 1e3:.0f} graphs/s; loader "
            f"{n_graphs / loader_s:.0f} graphs/s on one host thread; the whole run "
            f"(8 steps, eval of 256 + 512 + 512 + 512 graphs, two checkpoints) {run_s:.1f} s; "
            f"max_memory_allocated {peak:.0f} MiB",
            flush=True,
        )
        shape["mlp"].update(step_ms=ms, loader_graphs_s=n_graphs / loader_s, peak_mib=peak)
    return shape, launches


def mol3d_config(tok, **kw):
    """GraphGPT-base over the synthetic molecules' tokenizer (vocab 755, 13
    stacked features), bf16 over fp32 weights, with the fields in kw."""
    from graphgpt_torch.config import ModelConfig

    return ModelConfig(**{**dict(
        vocab_size=tok.vocab_size, hidden_size=768, num_hidden_layers=12,
        stacked_feat=tok.stacked_feat, mask_token_id=tok.mask_id,
        max_position_embeddings=1024, dtype="bfloat16", remat=True), **kw}).finalize()


def denoise_phase(dev, counters, fa, mlp, ops, synthetic, rope_cos_sin, steps: int = 8):
    """The denoise fine-tune path: GraphGPT-base as
    configs/pcqm4m_v2_supervised.yaml sets it up (gated aggregation, pairs
    remat, graph regression, L1) plus bi_causal_split 16 and the denoise
    defaults, weights from seed 0, on a 256 x 88 mol3d batch (72 molecule
    positions, 16 bit slots). Every kernel of the step at this batch's
    shape against its plain version (the attention kernels on its segments
    and RoPE table, norm_mlp and rmsnorm_bwd at N 256 x 88); the first step
    against the plain run; then
    `steps` AdamW + EMA steps with their launch counts, and an EMA eval
    forward that decodes the energies. Returns (kernel results at this
    shape, launches of the counted run)."""
    from graphgpt_torch.config import OptimizerConfig
    from graphgpt_torch.models.denoise import GraphGPTDenoise, denoise_draws
    from graphgpt_torch.models.rope import reset_position_ids
    from graphgpt_torch.training.optimizer import make_optimizer, make_schedule
    from graphgpt_torch.training.steps import init_train_state, make_eval_step, make_train_step

    tok = synthetic.mol3d_tokenizer()
    cfg = mol3d_config(tok, stacked_feat_agg_method="gated", remat_policy="pairs",
                       task_type="graph", problem_type="regression", loss_type="l1",
                       num_labels=1, bi_causal_split=16)
    model = GraphGPTDenoise(cfg, device=dev, seed=0)
    nb = synthetic.mol3d_batch(256, 88, seed=0, bi_split=16, tokenizer=tok)
    batch = synthetic.to_torch(nb, dev)
    b, p = nb["segment_ids"].shape
    print(f"denoise: hidden {cfg.hidden_size}, {cfg.num_hidden_layers} layers, "
          f"{cfg.num_attention_heads} heads, vocab {cfg.vocab_size}, bi_causal_split "
          f"{cfg.bi_causal_split}, noise_scale {cfg.noise_scale}, r_2d/r_3d/r_both "
          f"{cfg.r_2d}/{cfg.r_3d}/{cfg.r_both}, remat {cfg.remat_policy}; batch {b} x {p}, "
          f"{int((nb['segment_ids'] > 0).sum())} tokens", flush=True)
    pos = reset_position_ids(batch["position_ids"], cfg.rope_range)
    cos, sin = (t.to(torch.bfloat16) for t in rope_cos_sin(
        pos, cfg.head_dim, cfg.rope_theta, resonance=cfg.rope_resonance,
        rope_scaling=cfg.rope_scaling, max_position_embeddings=cfg.max_position_embeddings))
    shape = split_at_shape(fa, ops, "denoise shape", batch["segment_ids"], cos, sin,
                           cfg.bi_causal_split, cfg.num_attention_heads, cfg.head_dim)
    del cos, sin
    shape["norm_mlp"] = norm_mlp_at_shape(dev, mlp, ops, b * p, "denoise shape")
    shape["rms"] = rms_bwd_phase(dev, mlp, ops, b * p)
    draws = denoise_draws(b, p, torch.Generator(device=dev).manual_seed(1), dev)
    shape["grad_rel"] = step_vs_plain(model, batch, ops, "denoise", DN_LOSS_ATOL, DN_GRAD_REL,
                                      lambda: dict(draws=draws))

    opt_cfg = OptimizerConfig(lr=2e-4, scheduler="onecycle", use_ema=True, ema_decay=0.9999)
    schedule = make_schedule(opt_cfg, steps, 1)
    tx = make_optimizer(opt_cfg, steps, 1, schedule=schedule)
    state = init_train_state(model, tx, use_ema=True)
    L = cfg.num_hidden_layers
    # pairs: each group of two layers recomputes both attentions and the
    # first layer's norm-fused MLP; the split pair replaces the fused backward
    want = {**{k: 0 for k in counters}, "flash_fwd": 2 * L, "flash_dq": L, "flash_dkv": L,
            "norm_mlp": L + L // 2, "rmsnorm_bwd": L + 1}
    state, metrics, launches, ms, peak = counted_steps(
        "denoise", state, make_train_step(tx, opt_cfg, schedule), batch, counters, want, steps)
    for key in ("task_loss", "pretrain_loss", "loss"):
        vals = [float(m[key]) for m in metrics]
        print(f"denoise {key}: " + " ".join(f"{x:.4f}" for x in vals), flush=True)
        if not all(np.isfinite(vals)):
            fail(f"a denoise {key} is not finite: {vals}")
    before = {k: fn.launches for k, fn in counters.items()}
    out = make_eval_step(use_ema=True)(state, batch)
    torch.cuda.synchronize()
    ev = {k: fn.launches - before[k] for k, fn in counters.items()}
    energy = out["task_logits"]
    print(f"denoise launches per step: {want} (all {steps} steps); EMA eval forward: {ev}; "
          f"decoded energies [{energy.shape[0]}, {energy.shape[1]}], first four "
          f"{[round(float(x), 3) for x in energy[:4, 0]]}, labels "
          f"{[round(float(x), 3) for x in nb['graph_labels'][:4, 0]]}", flush=True)
    want_eval = {k: 0 for k in counters}
    want_eval.update(flash_fwd=L, norm_mlp=L)
    if ev != want_eval or tuple(energy.shape) != (b, 1) or not bool(torch.isfinite(energy).all()):
        fail(f"the EMA eval forward launched {ev} (want {want_eval}) or gave {energy.shape}")
    launches = {k: launches[k] + ev[k] for k in launches}
    print(f"denoise: {ms:.2f} ms/step (CUDA events over steps 2-{steps}), "
          f"{b / ms * 1e3:.0f} graphs/s, max_memory_allocated {peak:.0f} MiB", flush=True)
    shape.update(step_ms=ms, peak_mib=peak)
    del model, state
    return shape, launches


def pos_phase(dev, counters, fa, mlp, ops, synthetic, rope_cos_sin, steps: int = 4):
    """The 3D-position pretraining path: GraphGPT-base with pos-smtp-line
    (next-13 2D SMTP, save_attn remat) on a 256 x 72 mol3d batch, weights
    from seed 0. flash_fwd and flash_bwd on this batch's segments and RoPE
    table and norm_mlp at N 256 x 72 against their plain versions
    (rmsnorm_bwd runs at the fine-tune phase's N 18,432 already); the first
    step against the plain run, then `steps` AdamW + EMA steps with their
    launch counts. Returns (the launches of the counted run, results)."""
    from graphgpt_torch.config import OptimizerConfig
    from graphgpt_torch.models.pos_pretrain import GraphGPTPosPred, pos_draws
    from graphgpt_torch.models.rope import reset_position_ids
    from graphgpt_torch.training.optimizer import make_optimizer, make_schedule
    from graphgpt_torch.training.steps import init_train_state, make_train_step

    tok = synthetic.mol3d_tokenizer()
    cfg = mol3d_config(tok, next_n_token=tok.stacked_feat, remat_policy="save_attn",
                       task_type="pretrain-coord", pos_problem_type="pos-smtp-line")
    model = GraphGPTPosPred(cfg, device=dev, seed=0)
    nb = synthetic.mol3d_batch(256, 72, seed=1, tokenizer=tok)
    batch = synthetic.to_torch(nb, dev)
    b, p, f = nb["input_ids"].shape
    pos = reset_position_ids(batch["position_ids"], cfg.rope_range)
    cos, sin = (t.to(torch.bfloat16) for t in rope_cos_sin(
        pos, cfg.head_dim, cfg.rope_theta, resonance=cfg.rope_resonance,
        rope_scaling=cfg.rope_scaling, max_position_embeddings=cfg.max_position_embeddings))
    shape = dict(flash=flash_at_shape(fa, ops, "position shape", batch["segment_ids"], cos, sin,
                                      cfg.num_attention_heads, cfg.head_dim,
                                      cfg.causal_attention),
                 norm_mlp=norm_mlp_at_shape(dev, mlp, ops, b * p, "position shape"))
    del cos, sin
    draws = pos_draws(b, p, f, torch.Generator(device=dev).manual_seed(2), dev)
    grad_rel = step_vs_plain(model, batch, ops, "position-pretraining", POS_LOSS_ATOL,
                             POS_GRAD_REL, lambda: dict(draws=draws))
    opt_cfg = OptimizerConfig(lr=3e-4, use_ema=True)
    schedule = make_schedule(opt_cfg, 20, 2)
    tx = make_optimizer(opt_cfg, 20, 2, schedule=schedule)
    state = init_train_state(model, tx, use_ema=True)
    L = cfg.num_hidden_layers
    want = {**{k: 0 for k in counters}, "flash_fwd": L, "flash_bwd": L, "norm_mlp": L,
            "rmsnorm_bwd": L + 1}
    state, metrics, launches, ms, peak = counted_steps(
        "position-pretraining", state, make_train_step(tx, opt_cfg, schedule), batch, counters,
        want, steps)
    for key in ("gen_loss", "pretrain_loss", "loss"):
        vals = [float(m[key]) for m in metrics]
        print(f"position-pretraining {key}: " + " ".join(f"{x:.4f}" for x in vals), flush=True)
        if not all(np.isfinite(vals)):
            fail(f"a position-pretraining {key} is not finite: {vals}")
    print(f"position-pretraining launches per step: {want} (all {steps} steps); {b} x {p}, "
          f"{ms:.2f} ms/step (CUDA events over steps 2-{steps}), max_memory_allocated "
          f"{peak:.0f} MiB", flush=True)
    del model, state
    shape.update(grad_rel=grad_rel, step_ms=ms, peak_mib=peak)
    return launches, shape


def check_stream_rows(fa, ops, tag, qs, k, v, seg_q, seg_k, cos, sin, do, dh):
    """#6, #7 (with its delta) and #8 on these rows against their plain
    versions; padded query rows (and keys of no query) exactly 0. Returns
    the largest elementwise error of each kernel and #7's delta error."""
    out, lse = fa.flash_fwd_stream(qs, k, v, seg_q, seg_k, cos, sin, False, dh)
    dq, delta = fa.flash_dq_stream(qs, k, v, seg_q, seg_k, cos, sin, out, lse, do, None, False,
                                   dh)
    dk, dv = fa.flash_dkv_stream(qs, k, v, seg_q, seg_k, cos, sin, lse, delta, do, False, dh)
    torch.cuda.synchronize()
    with ops.reference_mode():
        rout, rlse = fa.flash_fwd_stream(qs, k, v, seg_q, seg_k, cos, sin, False, dh)
        rdq, rdelta = fa.flash_dq_stream(qs, k, v, seg_q, seg_k, cos, sin, out, lse, do, None,
                                         False, dh)
        rdk, rdv = fa.flash_dkv_stream(qs, k, v, seg_q, seg_k, cos, sin, lse, delta, do, False,
                                       dh)
    b, p = seg_q.shape
    shape = f"{tag}, {b} of the rows, P={p}"
    fwd_err = check_flash_fwd(f"stream, {shape}", out, lse, rout, rlse, seg_q)
    delta_err = (delta - rdelta).abs().max().item()
    print(f"flash_dq_stream[{shape}] max|delta-plain| {delta_err:.3e} (tol {DELTA_ATOL})",
          flush=True)
    if not delta_err <= DELTA_ATOL:
        fail(f"flash_dq_stream[{shape}]'s delta disagrees with its plain version")
    dq_err, _ = check_flash_bwd(shape, (dq,), (rdq,), seg_q, "flash_dq_stream", ("dq",))
    dkv_err, _ = check_flash_bwd(shape, (dk, dv), (rdk, rdv), seg_k, "flash_dkv_stream",
                                 ("dk", "dv"))
    return dict(fwd=fwd_err, dq=dq_err, dkv=dkv_err, delta=delta_err)


def stream_at_shape(fa, ops, _build, seg, cos, sin, h: int, dh: int, check_rows: int = 2):
    """The streamed kernels #6, #7 and #8 at the long-context path's shape
    (seg [B, P], P 4096 on the first batch's packed segments): against their
    plain versions on the first `check_rows` rows (the plain attention of all
    16 rows would need [16, 12, 4096, 4096] fp32, 12.9 GB), once with the
    query ids as key ids and once with another packed row's ids as key ids
    (seg_k != seg_q: query rows whose segment that row lacks see no key);
    then each kernel timed at the whole shape beside its bound, its plain
    version's time and SDPA's (boolean mask; forward, and forward's backward
    for #7 and #8), and #1's entry (ggt_flash_fwd) on the same rows, which
    the dispatch never gives it above P 2048."""
    b, p = seg.shape
    qs, k, v, do = flash_tensors(seg, h, dh, seed=21)
    r = slice(0, check_rows)
    rows = lambda *ts: [None if t is None else t[r] for t in ts]  # noqa: E731
    errs = check_stream_rows(fa, ops, "long-context", *rows(qs, k, v, seg, seg, cos, sin, do), dh)
    swap = torch.arange(check_rows, device=seg.device).roll(1)
    other = check_stream_rows(fa, ops, "keys of another packed row",
                              *rows(qs, k, v, seg), seg[r][swap], *rows(cos, sin, do), dh)
    errs = {key: max(errs[key], other[key]) for key in errs}

    fwd_args = (qs, k, v, seg, seg, cos, sin, False, dh)
    out, lse = fa.flash_fwd_stream(*fwd_args)
    dq_args = (qs, k, v, seg, seg, cos, sin, out, lse, do, None, False, dh)
    _, delta = fa.flash_dq_stream(*dq_args)
    dkv_args = (qs, k, v, seg, seg, cos, sin, lse, delta, do, False, dh)
    # kernel #1 on the same rows, through its C entry
    seg32 = seg.to(torch.int32).contiguous()
    out1, lse1 = torch.empty_like(out), torch.empty_like(lse)
    one = _build.entry("flash_fwd", "ggt_flash_fwd", fa._ARGTYPES)

    def single():
        _build.check(one(_build.ptr(qs), _build.ptr(k), _build.ptr(v), _build.ptr(seg32),
                         _build.ptr(cos), _build.ptr(sin), _build.ptr(out1), _build.ptr(lse1), b,
                         p, h, 0, 0, _build.stream_ptr(qs.device)), "ggt_flash_fwd")

    single()
    torch.cuda.synchronize()
    same = (out1.float() - out.float()).abs().max().item()
    print(f"flash_fwd (#1's entry) on the long-context rows: max|out - flash_fwd_stream| "
          f"{same:.3e} (tol {FLASH_TOL['out_atol']})", flush=True)
    if not same <= FLASH_TOL["out_atol"]:
        fail("kernel #1 and kernel #6 disagree on the long-context rows")
    single_ms = cuda_ms(single, iters=5)
    single_spread = spread()

    rq = fa.rotate_tokens(qs, cos, sin, dh).view(b, p, h, dh).transpose(1, 2)
    rk = fa.rotate_tokens(k, cos, sin, dh).view(b, p, h, dh).transpose(1, 2)
    mask = fa._valid_mask(seg, False)
    leaves = [t.detach().requires_grad_() for t in (rq, rk, v.view(b, p, h, dh).transpose(1, 2))]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_fwd = cuda_ms(lambda: sdpa(*leaves, attn_mask=mask, scale=1.0), iters=3)
    sd = sdpa(*leaves, attn_mask=mask, scale=1.0)
    do4 = do.view(b, p, h, dh).transpose(1, 2)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(sd, leaves, do4, retain_graph=True), iters=3)
    del sd, leaves, mask, rq, rk
    res = {}
    for kind, fn in (("fwd", lambda: fa.flash_fwd_stream(*fwd_args)),
                     ("dq", lambda: fa.flash_dq_stream(*dq_args)),
                     ("dkv", lambda: fa.flash_dkv_stream(*dkv_args))):
        ms = cuda_ms(fn, iters=5)
        ms_spread = spread()
        with ops.reference_mode():
            plain_ms = cuda_ms(fn, iters=1, warmup=1)
        lib_ms = lib_fwd if kind == "fwd" else lib_bwd
        nbytes, flops = flash_work(fa, seg, False, h, dh, kind)
        bms, by = bound(nbytes, flops)
        name = {"fwd": "flash_fwd_stream", "dq": "flash_dq_stream", "dkv": "flash_dkv_stream"}[kind]
        lib = "SDPA" if kind == "fwd" else "SDPA backward (dq, dk, dv)"
        extra = (f"; kernel #1 (ggt_flash_fwd) on the same rows {single_ms:.4f} ms (3 readings "
                 f"{single_spread})") if kind == "fwd" else ""
        print(f"{name} B={b} P={p} H={h}: kernel {ms:.4f} ms (3 readings {ms_spread}), plain "
              f"{plain_ms:.4f} ms, {lib} {lib_ms:.4f} ms, bound {bms:.4f} ms ({by}: "
              f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP){extra}", flush=True)
        res[kind] = dict(ms=ms, plain_ms=plain_ms, lib_ms=lib_ms, bound_ms=bms, bound_by=by,
                         err=errs[kind])
    res["fwd"]["single_ms"] = single_ms
    res["dq"]["delta_err"] = errs["delta"]
    return res


def long_config(out_dir: str, *overrides: str):
    """configs/pcqm4m_v2_pretrain_long.yaml read by the port's load_config
    (GraphGPT-base: 768 x 12, 12 heads of 64, gated aggregation, bf16,
    save_attn, AdamW 0.9/0.95 with warmup_decay, pretrain-mlm with packing),
    at max_length 4096 without block-aligned packing, batch 16 (65,536
    tokens a step), on the synthetic molecules (PCQM4M-v2's schema); eight
    steps, 2 of warm-up, EMA on for the EMA-valid loss, 550 valid graphs, a
    generation sweep of 2 bands over 16 graphs in 16 steps. `overrides` go
    after these."""
    from graphgpt_torch.config import load_config

    return load_config(os.path.join(HERE, "configs", "pcqm4m_v2_pretrain_long.yaml"), [
        "tokenization.dataset=synthetic_mol", "model.max_position_embeddings=4096",
        "training.max_length=4096", "training.pack_block=0", "training.batch_size=16",
        "training.schedule.total_num_steps=8", "training.schedule.warmup_num_steps=2",
        "training.schedule.logging_steps=1", "training.valid_percent=0.011",
        "training.gen_eval_bands=2", "training.gen_eval_samples=16", "generation.steps=16",
        "training.optimizer.use_ema=true", f"training.output_dir={out_dir}", *overrides])


def csv_rows(path: str):
    import csv

    with open(path) as f:
        return list(csv.DictReader(f))


def counted_pipeline(pipe, counters):
    """Wrap pipe's train and eval steps so that each call logs its launches;
    returns (train log, eval log, the train steps' metrics)."""
    train_log, eval_log, metrics = [], [], []
    step_fn = count_per_call(pipe.train_step, counters, train_log)

    def train_step(*a, **kw):
        state, m = step_fn(*a, **kw)
        metrics.append(m)
        return state, m

    pipe.train_step = train_step
    pipe.eval_step = count_per_call(pipe.eval_step, counters, eval_log)
    if pipe.eval_step_ema is not None:
        pipe.eval_step_ema = count_per_call(pipe.eval_step_ema, counters, eval_log)
    return train_log, eval_log, metrics


def check_logs(tag, train_log, eval_log, want, want_eval, steps):
    if len(train_log) != steps:
        fail(f"{tag}: {len(train_log)} training steps, expected {steps}")
    for i, got in enumerate(train_log):
        if got != want:
            fail(f"{tag} step {i} launched {got}, expected {want}")
    for i, got in enumerate(eval_log):
        if got != want_eval:
            fail(f"{tag} eval forward {i} launched {got}, expected {want_eval}")
    print(f"{tag} launches per training step: {want} (all {len(train_log)} steps); per eval "
          f"forward: {want_eval} (all {len(eval_log)})", flush=True)


def long_context_phase(dev, counters, fa, mlp, ops, _build, rope_cos_sin):
    """The long-context pretraining path (see the module docstring, 10).
    Returns (the kernels' results at its shape, the launches of its runs)."""
    from graphgpt_torch.models.rope import reset_position_ids
    from graphgpt_torch.synthetic import to_torch
    from graphgpt_torch.training.checkpoint import Checkpointer
    from graphgpt_torch.training.pipeline import PretrainPipeline

    launches = {k: 0 for k in counters}

    def add(before):
        for k, fn in counters.items():
            launches[k] += fn.launches - before[k]

    with tempfile.TemporaryDirectory() as tmp:
        out_a = os.path.join(tmp, "run_a")
        t0 = time.perf_counter()
        pipe = PretrainPipeline(long_config(out_a), device=dev).setup()
        mc, tc = pipe.cfg.model, pipe.cfg.training
        print(f"long-context setup {time.perf_counter() - t0:.1f} s: hidden {mc.hidden_size}, "
              f"{mc.num_hidden_layers} layers, {mc.num_attention_heads} heads, vocab "
              f"{mc.vocab_size}, mpe {mc.max_position_embeddings}, attn_block {mc.attn_block}, "
              f"remat {mc.remat_policy}, {mc.dtype}; {pipe.total_steps} steps, batch "
              f"{tc.batch_size} x {tc.max_length}, {tc.num_workers} loader workers, "
              f"{len(pipe.train_idx)} train and {len(pipe.valid_idx)} valid graphs", flush=True)
        if len(pipe.valid_idx) < 512 or mc.attn_block != 0 or tc.max_length != 4096:
            fail("the long-context config is not the one asked for")
        # the first batch, as run() draws it
        idx0 = np.random.default_rng((tc.seed, 0)).permutation(pipe.train_idx)
        t0 = time.perf_counter()
        nb = next(pipe.loader.epoch_batches(idx0, 0)).data
        first_s = time.perf_counter() - t0
        batch = to_torch(nb, dev)
        b, p = nb["segment_ids"].shape
        n_seg = int(sum(len(np.unique(r[r > 0])) for r in nb["segment_ids"]))
        # the loader alone, its worker pool started by the first batch
        t0 = time.perf_counter()
        n_graphs = 0
        for bb in pipe.loader.epoch_batches(idx0[: 3 * n_seg], epoch=3):
            n_graphs += sum(len(np.unique(r[r > 0])) for r in bb["segment_ids"])
        loader_gs = n_graphs / (time.perf_counter() - t0)
        print(f"long-context batch: {b} x {p}, {int((nb['segment_ids'] > 0).sum())} tokens, "
              f"{n_seg} molecules (the first batch tokenized and packed in {first_s:.2f} s, the "
              f"worker pool's start included); the loader alone {loader_gs:.0f} graphs/s with "
              f"{tc.num_workers} workers", flush=True)
        pos = reset_position_ids(batch["position_ids"], mc.rope_range)
        cos, sin = (t.to(torch.bfloat16) for t in rope_cos_sin(
            pos, mc.head_dim, mc.rope_theta, resonance=mc.rope_resonance,
            rope_scaling=mc.rope_scaling, max_position_embeddings=mc.max_position_embeddings))
        shape = stream_at_shape(fa, ops, _build, batch["segment_ids"], cos, sin,
                                mc.num_attention_heads, mc.head_dim)
        del cos, sin
        torch.cuda.empty_cache()
        model = pipe.state.model
        # the first step on 4 rows against the plain run. At random weights
        # the q_proj and k_proj gradients of the deeper layers are ~1e-5 of
        # the largest (their sum over a segment's keys cancels), and bf16
        # roundings move them by up to ~70% on any kernel path (the same
        # tokens through #1 and #3 read as much). So each gradient is held to
        # GRAD_REL, or to twice what the same tokens in 8 rows of 2048 (#1,
        # #3, already held to their plain versions) read on it, the larger.
        rows4 = {k: v[:4] for k, v in batch.items()}
        rows8 = {k: v.repeat_interleave(2, 0) if v.dim() == 1
                 else v.reshape((2 * v.shape[0], p // 2) + tuple(v.shape[2:]))
                 for k, v in rows4.items()}
        step_vs_plain(model, rows8, ops, "long-context control (the same tokens in rows of "
                      f"{p // 2}: #1, #3)", LOSS_ATOL, 1.0)
        limits = {k: max(GRAD_REL, 2 * r) for k, r in step_vs_plain.last.items()}
        shape["grad_rel"] = step_vs_plain(model, rows4, ops, "long-context", LOSS_ATOL, limits)
        torch.cuda.empty_cache()

        # run A: eight counted steps, the save point, the checkpoint
        L = mc.num_hidden_layers
        want = {k: 0 for k in counters}
        want.update(flash_fwd_stream=L, flash_dq_stream=L, flash_dkv_stream=L, norm_mlp=L,
                    rmsnorm_bwd=L + 1)
        want_eval = {k: 0 for k in counters}
        want_eval.update(flash_fwd_stream=L, norm_mlp=L)
        train_log, eval_log, metrics = counted_pipeline(pipe, counters)
        torch.cuda.reset_peak_memory_stats()
        before = {k: fn.launches for k, fn in counters.items()}
        t0 = time.perf_counter()
        pipe.run()
        run_s = time.perf_counter() - t0
        add(before)
        peak = torch.cuda.max_memory_allocated() / 2**20
        check_logs("long-context run A", train_log, eval_log, want, want_eval, 8)
        losses = [float(m["loss"]) for m in metrics]
        print("long-context losses: " + " ".join(f"{x:.4f}" for x in losses), flush=True)
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            fail(f"the long-context losses are not finite or did not fall: {losses}")
        log = csv_rows(os.path.join(out_a, "log.csv"))
        res = csv_rows(os.path.join(out_a, "result.csv"))
        tok_s = [float(r["tokens_per_s"]) for r in log]
        mfu = [float(r["mfu"]) for r in log if r.get("mfu")]
        gen_keys = sorted(k for k in res[-1] if k.startswith("gen_acc"))
        print(f"long-context log.csv: {len(log)} rows, tokens_per_s "
              + " ".join(f"{x:.0f}" for x in tok_s) + ", mfu " + " ".join(f"{x:.4f}" for x in mfu)
              + f"; result.csv: {res[-1]}", flush=True)
        if (len(log) != 8 or len(mfu) != 8 or len(gen_keys) != 2
                or not all(np.isfinite(float(res[-1][k]))
                           for k in ["valid_loss", "ema_valid_loss", *gen_keys])):
            fail("log.csv or result.csv lacks a column or a finite value")
        if Checkpointer(os.path.join(out_a, "ckpt")).latest_step() != 8:
            fail("no checkpoint at step 8")
        # timed outside the counted window: a step on the first batch on the
        # card (it trains on: run A's checkpoint is on disk already)
        ms = cuda_ms(lambda: pipe.train_step(pipe.state, batch, seed=tc.seed), iters=1, warmup=1,
                     repeats=3)
        ms_spread = spread()
        tokens = int((nb["segment_ids"] > 0).sum())
        print(f"long-context run A: {run_s:.1f} s for 8 steps, the save-point eval of 512 valid "
              f"graphs (EMA too), the generation sweep and a checkpoint; a step on a batch on "
              f"the card {ms:.2f} ms (3 readings {ms_spread}), {tokens / ms * 1e3:.0f} trained "
              f"tokens/s; max_memory_allocated {peak:.0f} MiB", flush=True)
        shape.update(step_ms=ms, tokens_per_s=tokens / ms * 1e3, peak_mib=peak,
                     loader_graphs_s=loader_gs, run_s=run_s,
                     losses=[round(x, 4) for x in losses])
        del pipe, model, batch
        torch.cuda.empty_cache()

        # auto-resume: the same output_dir, two steps more
        pipe = PretrainPipeline(long_config(out_a, "training.schedule.total_num_steps=10",
                                            "training.gen_eval_bands=0"), device=dev).setup()
        if pipe.start_step != 8 or pipe.state.step != 8:
            fail(f"auto-resume started at step {pipe.start_step}, not 8")
        train_log, eval_log, _ = counted_pipeline(pipe, counters)
        before = {k: fn.launches for k, fn in counters.items()}
        pipe.run()
        add(before)
        check_logs("long-context resumed", train_log, eval_log, want, want_eval, 2)
        steps = [int(r["step"]) for r in csv_rows(os.path.join(out_a, "log.csv"))]
        if steps != list(range(1, 11)) or pipe.state.step != 10:
            fail(f"the resumed run logged steps {steps}")
        print("long-context auto-resume: started at step 8, took steps 9 and 10", flush=True)
        del pipe
        torch.cuda.empty_cache()

        # run B: the config as shipped (pack_block 256) at 4096: training in
        # 256-token windows (#1, #3), the save point's eval and the
        # generation sweep on whole rows (#6)
        out_b = os.path.join(tmp, "run_b")
        pipe = PretrainPipeline(long_config(out_b, "training.pack_block=256",
                                            "training.schedule.total_num_steps=2"),
                                device=dev).setup()
        train_log, eval_log, metrics = counted_pipeline(pipe, counters)
        gen_log = []
        model = pipe.state.model
        model.logits = count_per_call(model.logits, counters, gen_log)
        before = {k: fn.launches for k, fn in counters.items()}
        pipe.run()
        add(before)
        want_b = {k: 0 for k in counters}
        want_b.update(flash_fwd=L, flash_bwd=L, norm_mlp=L, rmsnorm_bwd=L + 1)
        check_logs("long-context run B (pack_block 256)", train_log, eval_log, want_b,
                   want_eval, 2)
        for i, got in enumerate(gen_log):
            if got != want_eval:
                fail(f"run B's generation forward {i} launched {got}, expected {want_eval}")
        res_b = csv_rows(os.path.join(out_b, "result.csv"))[-1]
        print(f"long-context run B: attn_block {pipe.cfg.model.attn_block}, losses "
              + " ".join(f"{float(m['loss']):.4f}" for m in metrics)
              + f"; {len(gen_log)} generation forwards on whole rows; result.csv {res_b}",
              flush=True)
        if not all(np.isfinite(float(m["loss"])) for m in metrics) or not np.isfinite(
                float(res_b["valid_loss"])):
            fail("run B's losses are not finite")
        del pipe, model
        torch.cuda.empty_cache()
    return shape, launches


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs on a CUDA card")
    sys.path.insert(0, HERE)
    import graphgpt_torch

    if not os.path.abspath(graphgpt_torch.__file__).startswith(os.path.join(HERE, "graphgpt_torch")):
        fail(f"graphgpt_torch was imported from {graphgpt_torch.__file__}, not from this checkout")
    from graphgpt_torch import ops, synthetic
    from graphgpt_torch.config import flagship_config
    from graphgpt_torch.models.heads import GraphGPTPretrain
    from graphgpt_torch.models.rope import rope_cos_sin
    from graphgpt_torch.ops import _build
    from graphgpt_torch.ops import flash_attention as fa
    from graphgpt_torch.ops import mlp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    print(card_line(), flush=True)  # name, power limit
    print(
        f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}",
        flush=True,
    )

    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {sorted(logs)} with nvcc for sm_90a in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    # ---- kernel phase
    fres = flash_phase(dev, fa, ops, synthetic, rope_cos_sin)
    mres = mlp_phase(dev, mlp, ops)
    bres = flash_bwd_phase(dev, fa, ops, synthetic, rope_cos_sin)
    rres = rms_bwd_phase(dev, mlp, ops)
    sp = split_phase(dev, fa, ops, synthetic, rope_cos_sin)
    counters = {"flash_fwd": fa.flash_fwd, "flash_bwd": fa.flash_bwd,
                "norm_mlp": mlp.norm_mlp, "rmsnorm_bwd": mlp.rmsnorm_bwd, "mlp": mlp.mlp,
                "flash_dq": fa.flash_dq, "flash_dkv": fa.flash_dkv,
                "flash_fwd_stream": fa.flash_fwd_stream, "flash_dq_stream": fa.flash_dq_stream,
                "flash_dkv_stream": fa.flash_dkv_stream}

    # ---- eval and generation phases: the serving path, counted from 0
    cfg = flagship_config()
    model = GraphGPTPretrain(cfg, device=dev, seed=0)
    nb = synthetic.fake_batch(8, cfg.max_position_embeddings, cfg.stacked_feat, cfg.vocab_size,
                              np.random.default_rng(2))
    L = cfg.num_hidden_layers
    for fn in counters.values():
        fn.launches = 0
    eval_phase(model, nb)
    counts = (fa.flash_fwd.launches, mlp.norm_mlp.launches)
    print(f"eval launches: flash_fwd {counts[0]} norm_mlp {counts[1]} (want {L} each)", flush=True)
    if counts != (L, L):
        fail(f"expected {L} launches of each kernel per forward, got {counts}")
    steps = generation_phase(model, nb)
    serve = {k: fn.launches for k, fn in counters.items()}
    want = L * (1 + steps)
    print(f"serving path launches: {serve} (want {want} of each forward kernel, 0 of the "
          f"backward ones)", flush=True)
    if serve != {**{k: 0 for k in counters}, "flash_fwd": want, "norm_mlp": want}:
        fail(f"expected {want} launches of each forward kernel, got {serve}")
    compare_plain(model, nb, ops)
    timing_phase(model, nb)
    del model

    # ---- train phase: a fresh model; first the step against the plain run
    # (outside the counted window), then twelve counted steps
    model = GraphGPTPretrain(cfg, device=dev, seed=0)
    nb64 = synthetic.fake_batch(64, cfg.max_position_embeddings, cfg.stacked_feat,
                                cfg.vocab_size, np.random.default_rng(5))
    grad_rel = step_vs_plain(model, synthetic.to_torch(nb64, dev), ops, "train", LOSS_ATOL,
                             GRAD_REL)
    torch.cuda.empty_cache()
    train = train_phase(model, nb64, counters)

    # ---- fine-tune phase: the train phase's model as the pretrain checkpoint
    torch.cuda.empty_cache()
    ft, tune = finetune_phase(model, counters, fa, mlp, ops)
    sres = ft["mlp"]
    del model

    # ---- denoise and position-pretraining phases: fresh models
    torch.cuda.empty_cache()
    dn, den = denoise_phase(dev, counters, fa, mlp, ops, synthetic, rope_cos_sin)
    torch.cuda.empty_cache()
    posl, posr = pos_phase(dev, counters, fa, mlp, ops, synthetic, rope_cos_sin)
    torch.cuda.empty_cache()
    lc, lcl = long_context_phase(dev, counters, fa, mlp, ops, _build, rope_cos_sin)
    launches = {k: serve[k] + train[k] + tune[k] + den[k] + posl[k] + lcl[k] for k in counters}

    base = "graphgpt_tpu/ops/"

    def entry(name, source, replaces, r, tol, **extra):
        return dict(
            name=name, route="cuda", source=f"graphgpt_torch/csrc/{source}",
            replaces=base + replaces, launches=launches[name], launches_serving=serve[name],
            launches_training=train[name], launches_finetune=tune[name],
            launches_denoise=den[name], launches_pos=posl[name], launches_long=lcl[name],
            max_abs_err=r["err"],
            ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["lib_ms"], tol=tol, status="ok", **extra,
        )

    fb, bb = fres["bidirectional"], bres["bidirectional"]
    tr, ftf, ftr = bres["train"], ft["flash"], ft["rms"]
    psf, dnm, psm, dnr = posr["flash"], dn["norm_mlp"], posr["norm_mlp"], dn["rms"]

    def at(prefix, r, keys=("ms", "plain_ms", "bound_ms")):
        return {f"{prefix}_{k}": r[k] for k in keys}

    kernels = [
        entry("flash_fwd", "flash_fwd.cu", "flash_attention.py:124",
              dict(fb, err=max([r["err"] for r in fres.values()]
                               + [tr["fwd_err"], ftf["fwd_err"], psf["fwd_err"],
                                  dn["fwd"]["err"], sp["fwd"]["err"]])),
              FLASH_TOL, causal_ms=fres["causal"]["ms"], train_shape_ms=tr["fwd_ms"],
              train_shape_bound_ms=tr["fwd_bound_ms"], finetune_shape_ms=ftf["fwd_ms"],
              finetune_shape_bound_ms=ftf["fwd_bound_ms"], pos_shape_ms=psf["fwd_ms"],
              pos_shape_bound_ms=psf["fwd_bound_ms"],
              **{f"bicausal_{tag}_{k}": r["fwd"][k] for tag, r in (("denoise", dn), ("p1024", sp))
                 for k in ("ms", "plain_ms", "lib_ms", "bound_ms")}),
        entry("norm_mlp", "norm_mlp.cu", "mlp.py:203",
              dict(mres, err=max(mres["err"], dnm["err"], psm["err"])), MLP_TOL,
              train_shape_ms=mres["train_ms"], train_shape_bound_ms=mres["train_bound_ms"],
              **at("denoise_shape", dnm), **at("pos_shape", psm)),
        entry("flash_bwd", "flash_bwd.cu", "flash_attention.py:706",
              dict(bb, err=max([r["err"] for r in bres.values()] + [ftf["err"], psf["err"]])),
              FLASH_BWD_TOL, causal_ms=bres["causal"]["ms"],
              train_shape_ms=tr["ms"], train_shape_bound_ms=tr["bound_ms"],
              finetune_shape_ms=ftf["ms"], finetune_shape_bound_ms=ftf["bound_ms"],
              pos_shape_ms=psf["ms"], pos_shape_bound_ms=psf["bound_ms"]),
        entry("rmsnorm_bwd", "rmsnorm_bwd.cu", "mlp.py:414",
              dict(rres, err=max(rres["err"], ftr["err"], dnr["err"])), RMS_BWD_TOL,
              **at("finetune_shape", ftr, ("ms", "bound_ms", "plain_ms", "lib_ms")),
              **at("denoise_shape", dnr, ("ms", "bound_ms", "plain_ms", "lib_ms"))),
        entry("mlp", "mlp.cu", "mlp.py:82", sres, MLP_TOL,
              **{k: sres[k] for k in ("finetune_shape_n", "finetune_shape_ms",
                                      "finetune_shape_plain_ms", "finetune_shape_bound_ms",
                                      "step_ms", "loader_graphs_s", "peak_mib")}),
    ]
    # the split pair: its main entry at the denoise batch's shape, B 256 x P 88
    for name, kind, line in (("flash_dq", "dq", 602), ("flash_dkv", "dkv", 789)):
        extra = {"delta_err": max(dn["dq"]["delta_err"], sp["dq"]["delta_err"])} \
            if kind == "dq" else {}
        kernels.append(entry(
            name, "flash_bwd_split.cu", f"flash_attention.py:{line}",
            dict(dn[kind], err=max(dn[kind]["err"], sp[kind]["err"])), FLASH_BWD_TOL,
            rel_err=max(dn[kind]["rel"], sp[kind]["rel"]), denoise_step_ms=dn["step_ms"],
            denoise_peak_mib=dn["peak_mib"], denoise_grad_rel=dn["grad_rel"],
            **{f"p1024_{k}": sp[kind][k] for k in ("ms", "plain_ms", "lib_ms", "bound_ms")},
            **extra))
    # the streamed kernels: their main entry at the long-context shape, B 16 x P 4096
    for name, kind, line in (("flash_fwd_stream", "fwd", 177), ("flash_dq_stream", "dq", 645),
                             ("flash_dkv_stream", "dkv", 835)):
        extra = {"delta_err": lc["dq"]["delta_err"]} if kind == "dq" else {}
        if kind == "fwd":
            extra["single_block_kernel_ms"] = lc["fwd"]["single_ms"]
        kernels.append(entry(
            name, "flash_stream.cu", f"flash_attention.py:{line}", lc[kind],
            FLASH_TOL if kind == "fwd" else FLASH_BWD_TOL, long_step_ms=lc["step_ms"],
            long_tokens_per_s=lc["tokens_per_s"], long_peak_mib=lc["peak_mib"],
            long_grad_rel=lc["grad_rel"], long_loader_graphs_s=lc["loader_graphs_s"], **extra))
    print(f"whole-model gradients, kernels vs plain: worst relative error {grad_rel:.3e} "
          f"(training), {dn['grad_rel']:.3e} (denoise), {posr['grad_rel']:.3e} (position "
          f"pretraining), {lc['grad_rel']:.3e} (long context); position-pretraining step {posr['step_ms']:.2f} ms, peak "
          f"{posr['peak_mib']:.0f} MiB; the whole script took "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(
        json.dumps(
            {"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                    "count": torch.cuda.device_count()}}
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
