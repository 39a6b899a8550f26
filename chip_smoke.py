"""Drive the PyTorch port (graphgpt_torch) on one CUDA card.

    python3 chip_smoke.py

1. Fails unless a CUDA card is present; prints its name and power limit.
2. Builds every kernel from graphgpt_torch/csrc with nvcc (one process per
   source, all at once) and prints the build time. Writes the graph-level
   store, <tmp>/OGB/pcqm4m-v2/graphs.npz in the readers' npz contract:
   200,000 seeded random molecules in PCQM4M-v2's schema (9 node and 3
   edge columns, y [G, 1]), a single-node, an edge-free and a disconnected
   one at the start of each split, train/valid/test in PCQM4M-v2's
   proportions; prints its size and the seconds it took. Checks the C++
   walk on 20,000 of its graphs (every node and edge visited, each step an
   edge or a jump between components) and prints graphs/s of the C++ and
   the numpy walk on one host core, with the host's CPU. Times the
   long-context loader alone (its config's pcqm4m-v2 reader over the store,
   tokenizer and 8 workers; 16 x 4096 packed rows, no device) in a child
   process that never initialises CUDA: workers spawned, then forked, with
   the C++ walk, then spawned with the numpy walk; the first batch's
   seconds, the warm graphs/s and tokens/s, the workers' RSS.
3. Kernel phase: each of the kernels (flash_fwd, norm_mlp, flash_bwd,
   rmsnorm_bwd) against its plain PyTorch version in bf16 (errors beside
   their tolerances) at the shapes both main paths give it, 8 x 1024 rows
   for serving and 64 x 1024 for training, timed three times with
   CUDA events beside the plain version, one PyTorch library call where one
   computes the same function, and the card's bound for the same work;
   the bi-causal flash_fwd and the split backward pair (flash_dq,
   flash_dkv) the same way at 8 x 1024 with 16 bit slots, each with its
   share of its bound; then the pair, untimed, at MAX_P (2 x 2048) and
   with inf and NaN in do's padded rows, which must change no output bit.
   norm_mlp also bit for bit against a second launch, its share of the
   bound and its stages (the rrms pre-pass, gate/up, down) timed alone;
   rmsnorm_bwd bit for bit against a second launch, its two launches (the
   row pass, the sum of its per-CTA dw rows) timed alone, and, untimed, at
   a ragged N 65,537 and at D 384 and 1,600 (N 4,096);
   then norm_mlp and mlp, untimed, at a ragged N 65,537, at D 384 / F 384
   and D 128 / F 512 (N 4,096), mlp also at N 65,536 and 22,528, each
   against its plain version and a second launch.
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
   at the first batch's shape: mlp (also at N 8192; as norm_mlp above,
   its gate/up and down stages timed alone), flash_fwd and
   flash_bwd on that batch's segments and RoPE table (SDPA's forward and
   backward with that batch's mask timed beside them), rmsnorm_bwd at its
   N; then the first step's loss and every gradient against the plain run
   on the same batch and dropout masks.
   Then launch counts per training step and per EMA eval forward, the
   losses, the valid and EMA-valid MAE, ms per step, the loader's graphs/s
   and peak memory.
7b. Graph-level fine-tune phase: configs/pcqm4m_v2_supervised.yaml as
   shipped, read from the file (GraphGPT-base 768 x 12, gated, L1
   regression, pairs remat, bf16, batch 256, onecycle 2e-4, EMA 0.9999, 8
   loader workers), its data_dir the store, warm-started from the train
   phase's checkpoint: FinetunePipeline takes the reader's three splits
   (checked against the store's), the first step against an fp32 run of
   the plain versions (as the long-context step), 24 steps of epoch 0 with the launches of each step and each eval
   forward against the prediction, the eval of epoch 0 on the reader's
   valid (and EMA valid) and test splits with PCQM4M-v2's MAE, ms a step on
   a batch on the card, graphs/s through the pipeline and of the loader
   alone, the pool's first batch and its workers' RSS (the peak where the
   kernel reports it), peak memory;
   then, host only, the split under dataset_policy remove_special (edge0,
   node1, disconnected) and true_valid.
7c. Big-graph phases (A, B, C): two seeded stores in the schemas
   tools/convert_ogb.py writes (write_big_graph_store): ogbl-ppa's 576,289
   nodes ([global id, species], 58 species) with a quarter of its 30.3M
   edges as the train graph, valid/test edges and negatives in OGB's
   proportions; ogbn-proteins' 132,534 nodes in 8 species ([species, local
   id], node_species, x_mask), an eighth of its 39.6M edges with 8
   attributes in 0-999, y [N, 112], the species split in OGB's sizes; their
   draw, write and CSR-build seconds. A: configs/ogbl_ppa_supervised.yaml
   as shipped (768 x 12, pairs remat, batch 256, AUC loss, the vocab of
   every global node id), B: configs/ogbn_proteins_supervised.yaml as
   shipped (long stacking, gated, LayerScale, DropPath and attention
   dropout, 112 labels, batch 128), each warm-started from the train
   phase's model through FinetunePipeline on the reader's train split:
   the dataset + tokenizer on one host core (samples/s, tokens a sample,
   the share longer than max_length), the pool's first batch and its
   workers' RSS, the loader alone; every kernel of the step at the first
   batch's segments and N against its plain version (#1, #3, #13, and #2
   for A, #11 for B); both embedding-gradient routes timed at that batch's
   ids over vocab sizes (the switch point's measurement); the first step
   on 16 rows against the plain bf16 run and an fp32 run; 16 counted steps
   with their launches and each eval forward's, finite losses, hits@100
   (A, the ogbl-ppa evaluator) or ROC-AUC (B) on 1,024 / 512 valid
   samples, a step on a batch on the card against samples/s through the
   pipeline, peak memory. C: configs/ogbn_proteins_pretrain.yaml as
   shipped (256 x 4) through PretrainPipeline, four steps of packed long
   pretrain-mlm rows, launches, finite losses and the save point's valid
   loss.
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
   a step), its rows from the store through the pcqm4m-v2 reader its config
   names, the C++ walk in the worker pool. First the streamed kernels #6 flash_fwd_stream,
   #7 flash_dq_stream (with its delta) and #8 flash_dkv_stream against
   their plain versions on 2 of the first batch's 16 rows, with its
   segments and RoPE table, and again with another packed row's ids as the
   key ids; #6, #7 and #8 also on the whole 16 x 4096 launch against their
   plain versions run a row at a time, both ways, and against a relaunch
   bit for bit; each timed at the whole 16 x 4096 beside its bound, its
   plain version's time and SDPA's, and #1's entry on the same rows, which
   must give #6's bits (one body, one id array). Then the
   first step on 4 rows against an fp32 run of the plain versions (each
   gradient's error on the kernel path at most STEP32_K times the plain
   bf16 path's plus STEP32_F); run A, eight steps with the
   launch counts of each step and each eval forward, falling losses,
   log.csv (tokens/s, mfu), result.csv (valid, EMA-valid, 2 generation
   bands) and the checkpoint at step 8; a step on a batch on the card,
   tokens/s through the pipeline (log.csv), the loader's graphs/s and
   tokens/s with its worker pool, the pool's time to its first batch and
   its workers' RSS (the peak where the kernel reports it), peak memory;
   auto-resume at
   step 8 for two steps more; run B, the config as shipped (pack_block
   256) for two steps: training in 256-token windows (#1, #3), the eval
   and the generation sweep on whole rows (#6).
11. Band and norm-fused phase, GGT_FLASH_MODE=band and GGT_ATTN_NORM_FUSE=1
   (the port's `_MODE` attribute and the environment variable): #9
   flash_fwd_band and #10 flash_bwd_band (with its delta) against their
   plain versions at B 8 x P 1024 (bidirectional, causal, and with another
   packed row's ids as key ids), B 64 x P 1024, the long-context batch's
   16 x 4096 and the denoise batch's 256 x 88 (bi-causal, 16 bit slots),
   on every row (#10's plain version a row at a time), their band tables
   equal to band_limits, padded rows, query rows that see no key and keys
   that no query sees exactly 0 on every row, both bit for bit against a
   relaunch, #10 with inf and NaN in do's padded rows (8 x 1024, both
   masks) changing no output bit; timed at 8 x 1024,
   64 x 1024 and 16 x 4096 beside the bound, the plain version, SDPA and
   the legacy kernels at the same shape; #12 norm_qkv at N 8,192 and
   65,536 beside F.rms_norm + one matmul (its achieved TFLOP/s, share of
   bound and the WMMA kernel's time beside it, its rrms pre-pass timed
   alone), and
   held to its plain version, untimed, at GQA widths 768/256/256, at a
   ragged N 65,537, at D 1600 (N 4,096), and to itself on a second launch
   (bit for bit). The skip mode's forward and
   backward at 8 x 1024 (#6-#8 once each). GraphGPT-base's training step
   at 64 x 1024 under both knobs against the plain run and the legacy
   kernel path, four counted steps; long-context pretraining through
   PretrainPipeline under both knobs (run A's config and schedule, four
   steps and their save point): the first step on 4 rows against an fp32
   run, launch counts, losses against run A's, log.csv, result.csv.
12. Prints one JSON line listing every kernel, then the device line last.

Any failed check raises, so the script exits non-zero. The launch counts
are set to 0 just before each main path (eval + generation; training;
fine-tuning; graph-level fine-tuning; phases A, B and C; denoising;
position pretraining; long-context pretraining;
training and long-context pretraining under both knobs) and read just
after it; launches made to compare a kernel with its plain
version fall outside those windows.
"""

from __future__ import annotations

import atexit
import contextlib
import ctypes
import json
import os
import re
import shutil
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
# The long-context first steps (P 4096, 4 rows) are held against an fp32 run:
# the plain versions with the compute dtype fp32 and the same fp32 weights.
# Against it, each gradient's relative Frobenius error on the kernel path in
# bf16 (e_kernel) and on the plain path in bf16 (e_plain) must satisfy
# e_kernel <= STEP32_K * e_plain + STEP32_F: the kernels may round no worse
# than twice as far from the exact step as the plain versions do, at the same
# bf16 rounding points. F covers a gradient that bf16 leaves almost exact.
# At random weights the deeper q/k gradients are ~1e-5 of the largest, and
# bf16 moves them by tens of percent on either path, which the ratio absorbs
# and a fixed limit could not. The loss is held to LOSS_ATOL against the
# plain bf16 run, and its distance from the fp32 run's to the same rule.
STEP32_K = 2.0
STEP32_F = 2e-3
# The long-context run under GGT_FLASH_MODE=band and GGT_ATTN_NORM_FUSE=1
# against the streamed run A of this script on the same batches and
# schedule: each of its four losses within this much of run A's. Both round
# in bf16 at other points (band against streamed kernels, the norm-fused
# q/k/v against the norm and three products), through four AdamW steps.
BAND_LOSS_ATOL = 5e-2
# Pairs of training steps, one under both knobs and one on the legacy route,
# alternated to compare the two routes' step times within one call.
STEP_PAIRS = 6
# The rrms pre-pass against the plain statistics: fp32 sums of 768 squares
# in another order, and 1 / sqrtf against torch.rsqrt.
RRMS_REL = 1e-5


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


def sdpa_ms(fa, seg, qs, k, v, do, cos, sin, causal: bool, h: int, dh: int, bi: int = 0):
    """(forward ms, backward ms) of SDPA with this shape's boolean mask
    (segments, then causal or bi-causal) on q and k rotated outside (the
    rotation is not timed): the one PyTorch call that computes what the
    flash kernels compute, a yardstick the port never calls. The backward
    gives dq, dk and dv in one call."""
    b, p = seg.shape

    def heads(t):
        return t.view(b, p, h, dh).transpose(1, 2)

    if cos is not None:
        qs, k = fa.rotate_tokens(qs, cos, sin, dh), fa.rotate_tokens(k, cos, sin, dh)
    mask = fa._valid_mask(seg, causal, bi)
    leaves = [heads(t).detach().requires_grad_() for t in (qs, k, v)]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd = cuda_ms(lambda: sdpa(*leaves, attn_mask=mask, scale=1.0), iters=5)
    out = sdpa(*leaves, attn_mask=mask, scale=1.0)
    bwd = cuda_ms(lambda: torch.autograd.grad(out, leaves, heads(do), retain_graph=True), iters=5)
    return fwd, bwd


def flash_at_shape(fa, ops, tag, seg, cos, sin, h: int, dh: int, causal: bool = False):
    """flash_fwd and flash_bwd at a path's own shape (seg [B, P]) against
    their plain versions, which run 8 rows at a time to keep their score
    tensors small; then both kernels' times beside their bounds and SDPA's
    forward and backward with this shape's mask."""
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
    lib_fwd, lib_bwd = sdpa_ms(fa, seg, qs, k, v, do, cos, sin, causal, h, dh)
    print(
        f"flash_bwd[{tag}] B={b} P={p} H={h}: kernel {ms:.4f} ms (3 readings {ms_spread}), "
        f"{bms / ms:.1%} of the bound, SDPA backward {lib_bwd:.4f} ms, bound {bms:.4f} ms "
        f"({by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); flash_fwd[{tag}] kernel "
        f"{fwd_ms:.4f} ms (3 readings {fwd_spread}), {fbms / fwd_ms:.1%} of the bound, SDPA "
        f"{lib_fwd:.4f} ms, bound {fbms:.4f} ms ({fby}: {fbytes / 1e6:.1f} MB, "
        f"{fflops / 1e9:.2f} GFLOP)",
        flush=True,
    )
    return dict(err=err, rel=rel, fwd_err=fwd_err, ms=ms, bound_ms=bms, bound_by=by,
                lib_ms=lib_bwd, bound_share=bms / ms, fwd_ms=fwd_ms, fwd_bound_ms=fbms,
                fwd_lib_ms=lib_fwd, fwd_bound_share=fbms / fwd_ms)


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

    lib_fwd, lib_bwd = sdpa_ms(fa, seg, qs, k, v, do, cos, sin, False, h, dh, bi)
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
            f"({by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP), {bms / ms:.1%} of the "
            f"bound",
            flush=True,
        )
        res[kind] = dict(ms=ms, plain_ms=plain_ms, lib_ms=lib_ms, bound_ms=bms, bound_by=by,
                         bound_share=bms / ms)
    print(f"flash_dq + flash_dkv {tag}: {res['dq']['ms'] + res['dkv']['ms']:.4f} ms against "
          f"the SDPA backward's {lib_bwd:.4f} ms", flush=True)
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
    res = split_at_shape(fa, ops, "P1024", seg, cos, sin, bi, h, dh)
    res["edge"] = split_edge_checks(dev, fa, ops, synthetic, rope_cos_sin)
    return res


def split_edge_checks(dev, fa, ops, synthetic, rope_cos_sin):
    """The split pair, untimed: at MAX_P (B 2 x P 2048 packed rows, 16 bit
    slots, a padded stretch) against its plain versions; then with inf and
    NaN written into do's padded rows, which must change no bit of dq,
    delta, dk or dv."""
    b, p, h, dh, bi = 2, fa.MAX_P, 12, 64, 16
    seg_np = synthetic.packed_segments(b, p, np.random.default_rng(9))
    seg_np[-1, p - 48 : p - bi] = 0
    seg = torch.from_numpy(seg_np).to(dev)
    pos = torch.arange(p, device=dev).expand(b, p)
    cos, sin = (t.to(torch.bfloat16) for t in rope_cos_sin(pos, dh))
    qs, k, v, do = flash_tensors(seg, h, dh, seed=4)
    out, lse = fa.flash_fwd(qs, k, v, seg, cos, sin, False, dh, bi)

    def pair(d):
        dq, delta = fa.flash_dq(qs, k, v, seg, cos, sin, out, lse, d, None, False, dh, bi)
        return (dq, delta) + fa.flash_dkv(qs, k, v, seg, cos, sin, lse, delta, d, False, dh, bi)

    dq, delta, dk, dv = pair(do)
    sync(dev)
    shape = f"MAX_P, B={b} P={p} split {p - bi}"
    rdq, rdelta = plain_in_row_chunks(ops, lambda *t: fa.flash_dq(*t, False, dh, bi),
                                      (qs, k, v, seg, cos, sin, out, lse, do, None), rows=1)
    delta_err = (delta - rdelta).abs().max().item()
    print(f"flash_dq[{shape}] max|delta-plain| {delta_err:.3e} (tol {DELTA_ATOL})", flush=True)
    if not delta_err <= DELTA_ATOL:
        fail(f"flash_dq[{shape}]'s delta disagrees with its plain version")
    dq_err, dq_rel = check_flash_bwd(shape, (dq,), (rdq,), seg, "flash_dq", ("dq",))
    del rdq
    rdk, rdv = plain_in_row_chunks(ops, lambda *t: fa.flash_dkv(*t, False, dh, bi),
                                   (qs, k, v, seg, cos, sin, lse, delta, do), rows=1)
    dkv_err, dkv_rel = check_flash_bwd(shape, (dk, dv), (rdk, rdv), seg, "flash_dkv",
                                       ("dk", "dv"))
    del rdk, rdv
    pad = (seg == 0)[..., None].expand_as(do)
    noisy = do.masked_fill(pad, float("nan"))
    noisy[0].masked_fill_(pad[0], float("inf"))
    same = all(torch.equal(a, n) for a, n in zip((dq, delta, dk, dv), pair(noisy)))
    print(f"flash_dq, flash_dkv[{shape}] with inf and NaN in do's {int(pad[..., 0].sum())} padded "
          f"rows: every output bit the same {same}", flush=True)
    if not same:
        fail(f"non-finite do in padded rows reached an output of the split pair ({shape})")
    return dict(dq_err=dq_err, dq_rel=dq_rel, dkv_err=dkv_err, dkv_rel=dkv_rel,
                delta_err=delta_err)


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
            f"{ms_spread}), {bms / ms:.1%} of the bound, plain {plain_ms:.4f} ms, "
            f"SDPA {lib_ms:.4f} ms, bound {bms * 1e3:.2f} us ({by}: {nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.3f} GFLOP)",
            flush=True,
        )
        res[tag] = dict(err=err, ms=ms, plain_ms=plain_ms, lib_ms=lib_ms,
                        bound_ms=bms, bound_by=by, bound_share=bms / ms)
    return res


def gated_mlp_library(x, wgu, wd_t, f: int, norm=None):
    """The PyTorch yardstick of the gated-MLP kernels: (F.rms_norm with a
    bf16 weight, when norm = (wn16, eps)), one matmul against [Wg|Wu]^T,
    the exact gelu of the first half times the second, one matmul against
    Wd^T, (and the residual, with the norm). Timed beside #2 and #11, never
    called by the port."""
    h = x if norm is None else torch.nn.functional.rms_norm(x, x.shape[-1:], *norm)
    gu = torch.matmul(h, wgu)
    out = torch.matmul(torch.nn.functional.gelu(gu[:, :f]) * gu[:, f:], wd_t)
    return out if norm is None else x + out


def mlp_inputs(dev, n: int, d: int, f: int, seed: int):
    """x [n, d] bf16 at unit normal, wn fp32 near 1, Wg, Wu [f, d] and Wd
    [d, f] bf16 at 0.55 / sqrt(d) (0.02 at D 768, the model's init)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    scale = 0.55 / d**0.5
    wn = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
    wg, wu = (
        (torch.randn(f, d, generator=gen, device=dev) * scale).to(torch.bfloat16) for _ in range(2)
    )
    wd = (torch.randn(d, f, generator=gen, device=dev) * scale).to(torch.bfloat16)
    x = torch.randn(n, d, generator=gen, device=dev).to(torch.bfloat16)
    return x, wn, wg, wu, wd


def mlp_args(name, x, wn, wg, wu, wd, act="gelu"):
    """The wrapper's arguments of MLP kernel `name` (norm_mlp or mlp)."""
    return (x, wn, wg, wu, wd, 1e-6, act) if name == "norm_mlp" else (x, wg, wu, wd, act)


def mlp_relaunch(mlp, name, tag, args, out):
    """Fail unless a second launch of MLP kernel `name` on the same inputs
    gives out's bits."""
    same = torch.equal(getattr(mlp, name)(*args), out)
    print(f"{name}[{tag}]: a second launch on the same inputs is bit-equal: {same}", flush=True)
    if not same:
        fail(f"{name}[{tag}] differs from launch to launch")


def mlp_stages(mlp, name, x, wn, wg, wu, wd):
    """Each stage of MLP kernel `name` alone (norm_mlp: the rrms pre-pass,
    gate/up, down; mlp: gate/up, down), through its stage entry on the tiles
    the wrapper picks, gelu: ({stage: ms}, (bh, bn)). One run of every stage
    first leaves rrms and g in place for the stages that read them."""
    b = mlp._build
    n, d = x.shape
    f = wg.shape[0]
    tiles = mlp.mlp_tiles(n, d, f, mlp._sm_count(x.device))
    g = torch.empty((n, f), dtype=x.dtype, device=x.device)
    out, rr = torch.empty_like(x), torch.empty(n, dtype=torch.float32, device=x.device)
    stream, act = b.stream_ptr(x.device), mlp._ACT_IDS["gelu"]
    if name == "norm_mlp":
        fn = b.entry("norm_mlp", "ggt_norm_mlp_stages", mlp._STAGE_ARGTYPES)
        ptrs = [b.ptr(t) for t in (x, wn, wg, wu, wd, g, out, rr)]
        run = lambda m: fn(*ptrs, n, d, f, *tiles, 1e-6, act, m, stream)  # noqa: E731
        stages = {"rrms": mlp.MLP_RRMS, "gate_up": mlp.MLP_GATE_UP, "down": mlp.MLP_DOWN}
    else:
        fn = b.entry("mlp", "ggt_mlp_stages", mlp._MLP_STAGE_ARGTYPES)
        ptrs = [b.ptr(t) for t in (x, wg, wu, wd, g, out)]
        run = lambda m: fn(*ptrs, n, d, f, *tiles, act, m, stream)  # noqa: E731
        stages = {"gate_up": mlp.MLP_GATE_UP, "down": mlp.MLP_DOWN}
    b.check(run(sum(stages.values())), f"{name} stages")
    ms = {}
    for stage, mask in stages.items():
        ms[stage] = cuda_ms(lambda m=mask: b.check(run(m), f"{name} {stage}"), iters=10)
    return ms, tiles


def mlp_timed(mlp, ops, name, tag, x, wn, wg, wu, wd, time_plain: bool = True):
    """MLP kernel `name` (gelu) timed on these inputs: three CUDA-event
    readings beside the plain version's (when asked), the library
    composition's (gated_mlp_library, with the norm and the residual for
    norm_mlp), each stage alone and the bound; returns the numbers."""
    n, d = x.shape
    f = wg.shape[0]
    fn, args = getattr(mlp, name), mlp_args(name, x, wn, wg, wu, wd)
    ms = cuda_ms(lambda: fn(*args), iters=10)
    ms_spread = spread()
    plain_ms = None
    if time_plain:
        with ops.reference_mode():
            plain_ms = cuda_ms(lambda: fn(*args), iters=3)
    wgu, wd_t = torch.cat([wg, wu]).t(), wd.t()
    norm = (wn.to(torch.bfloat16), 1e-6) if name == "norm_mlp" else None
    lib_ms = cuda_ms(lambda: gated_mlp_library(x, wgu, wd_t, f, norm), iters=10)
    del wgu
    stages, (bh, bn) = mlp_stages(mlp, name, x, wn, wg, wu, wd)
    flops = 2.0 * n * d * f * 3
    nbytes = 2 * n * d * 2 + 3 * d * f * 2 + (d * 4 if name == "norm_mlp" else 0)
    bms, by = bound(nbytes, flops)
    plain = "not timed" if plain_ms is None else f"{plain_ms:.4f} ms"
    lib = ("F.rms_norm + matmul [Wg|Wu] + gelu * up + matmul Wd + residual" if norm
           else "matmul [Wg|Wu] + gelu * up + matmul Wd")
    print(
        f"{name}[{tag}] N={n} D={d} F={f} gelu: kernel {ms:.4f} ms (3 readings {ms_spread}; "
        f"{flops / ms / 1e9:.1f} TFLOP/s, {bms / ms:.1%} of the bound), plain {plain}, {lib} "
        f"{lib_ms:.4f} ms, bound {bms:.4f} ms ({by}: {nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.1f} GFLOP); tiles BH {bh}, BN {bn}; alone: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in stages.items()),
        flush=True,
    )
    return dict(ms=ms, plain_ms=plain_ms, lib_ms=lib_ms, bound_ms=bms, bound_by=by,
                bound_share=bms / ms, **{f"{k}_ms": v for k, v in stages.items()})


def norm_mlp_at_shape(dev, mlp, ops, n: int, tag: str, time_plain: bool = True,
                      name: str = "norm_mlp"):
    """MLP kernel `name` (norm_mlp, or mlp; gelu, D 768, F 3072, weights at
    0.02) against its plain version on N rows and bit for bit against a
    second launch, then timed (mlp_timed)."""
    x, wn, wg, wu, wd = mlp_inputs(dev, n, 768, 3072, seed=1)
    args = mlp_args(name, x, wn, wg, wu, wd)
    fn = getattr(mlp, name)
    out = fn(*args)
    torch.cuda.synchronize()
    with ops.reference_mode():
        ref = fn(*args)
    err = check_mlp(name, f"{tag}, N={n}", out, ref)
    del ref
    mlp_relaunch(mlp, name, f"{tag}, N={n}", args, out)
    del out
    return dict(err=err, **mlp_timed(mlp, ops, name, tag, x, wn, wg, wu, wd, time_plain))


# (N, D, F, kernels) held to their plain versions and to a relaunch, untimed:
# a ragged N (the last 128-row tile one row deep), small12's D 384 / F 384,
# the tiny configs' D 128 / F 512, and #11 at the training and denoise rows
MLP_CONTRACT = ((65537, 768, 3072, ("norm_mlp", "mlp")), (4096, 384, 384, ("norm_mlp", "mlp")),
                (4096, 128, 512, ("norm_mlp", "mlp")), (65536, 768, 3072, ("mlp",)),
                (22528, 768, 3072, ("mlp",)))


def mlp_contract(dev, mlp, ops):
    """#2 and #11 at the MLP_CONTRACT shapes (gelu) against their plain
    versions and bit for bit against a second launch; returns the largest
    error."""
    err = 0.0
    for n, d, f, names in MLP_CONTRACT:
        x, wn, wg, wu, wd = mlp_inputs(dev, n, d, f, seed=n + d)
        tag = f"N={n} D={d} F={f} (tiles {mlp.mlp_tiles(n, d, f, mlp._sm_count(dev))})"
        for name in names:
            args = mlp_args(name, x, wn, wg, wu, wd)
            out = getattr(mlp, name)(*args)
            torch.cuda.synchronize()
            with ops.reference_mode():
                ref = getattr(mlp, name)(*args)
            err = max(err, check_mlp(name, tag, out, ref))
            del ref
            mlp_relaunch(mlp, name, tag, args, out)
            del out
    return err


def mlp_phase(dev, mlp, ops):
    """norm_mlp at the serving batch's N 8192 and the training batch's
    N 65536 (64 x 1024 rows; the plain version is not timed there), then
    both MLP kernels at the MLP_CONTRACT shapes."""
    r = norm_mlp_at_shape(dev, mlp, ops, 8192, "serving shape")
    t = norm_mlp_at_shape(dev, mlp, ops, 65536, "train shape", time_plain=False)
    err = max(r["err"], t["err"], mlp_contract(dev, mlp, ops))
    return dict(r, err=err, train=t)


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
            f"{ms_spread}), {bms / ms:.1%} of the bound, plain {plain_ms:.4f} ms, SDPA backward "
            f"{lib_ms:.4f} ms, bound {bms * 1e3:.2f} us ({by}: {nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.3f} GFLOP)",
            flush=True,
        )
        res[tag] = dict(err=err, rel=rel, ms=ms, plain_ms=plain_ms, lib_ms=lib_ms,
                        bound_ms=bms, bound_by=by, bound_share=bms / ms)
    flash_bwd_non_finite_check(fa, qs, k, v, seg, cos, sin, do, dh)
    del qs, k, v, seg, cos, sin, do, got, ref

    # the training batch: B 64, bidirectional
    res["train"] = flash_at_shape(fa, ops, "train shape", *inputs(64), h, dh)
    return res


def flash_bwd_non_finite_check(fa, qs, k, v, seg, cos, sin, do, dh: int):
    """flash_bwd, untimed, with inf and NaN written into do's padded rows
    (both masks): every bit of dq, dk and dv must stay as with zeros there."""
    pad = (seg == 0)[..., None].expand_as(do)
    if not bool(pad.any()):
        fail("the non-finite check needs padded rows")
    clean = do.masked_fill(pad, 0.0)
    noisy = do.masked_fill(pad, float("nan"))
    noisy[-1].masked_fill_(pad[-1], float("inf"))
    for causal in (False, True):
        out, lse = fa.flash_fwd(qs, k, v, seg, cos, sin, causal, dh)
        runs = [fa.flash_bwd(qs, k, v, seg, cos, sin, out, lse, d, None, causal, dh)
                for d in (clean, noisy)]
        same = all(torch.equal(a, n) for a, n in zip(*runs))
        finite = all(bool(torch.isfinite(a.float()).all()) for a in runs[1])
        tag = "causal" if causal else "bidirectional"
        print(f"flash_bwd[{tag}, B={seg.shape[0]}] with inf and NaN in do's "
              f"{int(pad[..., 0].sum())} padded rows: every output bit the same {same}, "
              f"finite {finite}", flush=True)
        if not (same and finite):
            fail(f"non-finite do in padded rows reached an output of flash_bwd ({tag})")


def rms_inputs(dev, n: int, d: int, seed: int = 4):
    """x, g [n, d] bf16 at unit normal, w fp32 near 1, eps."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, d, generator=gen, device=dev).to(torch.bfloat16)
    g = torch.randn(n, d, generator=gen, device=dev).to(torch.bfloat16)
    w = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
    return x, g, w, 1e-6


def check_rms(mlp, ops, tag, x, g, w, eps):
    """rmsnorm_bwd against its plain version and against a second launch
    (dx and dw bit for bit: no atomics); returns the larger of dx's
    elementwise error and dw's relative one."""
    n = x.shape[0]
    dx, dw = mlp.rmsnorm_bwd(x, g, w, eps)
    again = mlp.rmsnorm_bwd(x, g, w, eps)
    sync(x.device)
    same = torch.equal(again[0], dx) and torch.equal(again[1], dw)
    with ops.reference_mode():
        rdx, rdw = mlp.rmsnorm_bwd(x, g, w, eps)
    err_dx = (dx.float() - rdx.float()).abs().max().item()
    rel_dx = rel_err(dx, rdx)
    rel_dw = ((dw - rdw).abs() / (rdw.abs() + 1.0)).max().item()
    print(
        f"rmsnorm_bwd[{tag}, N={n} D={x.shape[1]}] max|dx-plain| {err_dx:.3e} (tol "
        f"{RMS_BWD_TOL['dx_atol']}) |dx-plain|/|plain| {rel_dx:.3e} (tol "
        f"{RMS_BWD_TOL['dx_rel']}) max|dw-plain|/(|plain|+1) {rel_dw:.3e} (tol "
        f"{RMS_BWD_TOL['dw_rtol']}); a second launch bit for bit: {same}",
        flush=True,
    )
    if not (err_dx <= RMS_BWD_TOL["dx_atol"] and rel_dx <= RMS_BWD_TOL["dx_rel"]
            and rel_dw <= RMS_BWD_TOL["dw_rtol"] and bool(torch.isfinite(dw).all()) and same):
        fail(f"rmsnorm_bwd[{tag}, N={n}] disagrees with its plain version or a relaunch")
    return max(err_dx, rel_dw)


def rms_stages(mlp, x, g, w, eps):
    """(row pass ms, scratch-sum ms) of rmsnorm_bwd's two launches, each
    alone through the stage entry, with the wrapper's grid and scratch."""
    from graphgpt_torch.ops import _build

    n, d = x.shape
    blocks = mlp.rms_blocks(n, d, mlp._sm_count(x.device))
    dx, dw = torch.empty_like(x), torch.empty(d, dtype=torch.float32, device=x.device)
    partial = torch.empty(blocks, d, dtype=torch.float32, device=x.device)
    fn = _build.entry("rmsnorm_bwd", "ggt_rmsnorm_bwd_stages", mlp._RMS_STAGE_ARGTYPES)
    stream = _build.stream_ptr(x.device)

    def run(mask):
        _build.check(fn(_build.ptr(x), _build.ptr(g), _build.ptr(w), _build.ptr(dx),
                        _build.ptr(dw), _build.ptr(partial), n, d, float(eps), blocks, mask,
                        stream), "rmsnorm_bwd stages")

    return cuda_ms(lambda: run(mlp.RMS_MAIN)), cuda_ms(lambda: run(mlp.RMS_REDUCE)), blocks


def rms_bwd_phase(dev, mlp, ops, n: int = 65536, contract: bool = False):
    """rmsnorm_bwd against its plain version and a relaunch at N rows of
    D 768, with its time beside the plain version's, F.rms_norm's backward
    and the bound, and its two launches timed apart; `contract`: also,
    untimed, at a ragged N 65,537 and at D 384 and 1,600 (the 2- and
    7-chunk instances)."""
    d = 768
    x, g, w, eps = rms_inputs(dev, n, d)
    err = check_rms(mlp, ops, "D 768", x, g, w, eps)
    if contract:
        for cn, cd in ((65537, 768), (4096, 384), (4096, 1600)):
            err = max(err, check_rms(mlp, ops, "contract", *rms_inputs(dev, cn, cd, seed=5)))
    ms = cuda_ms(lambda: mlp.rmsnorm_bwd(x, g, w, eps))
    ms_spread = spread()
    main_ms, reduce_ms, blocks = rms_stages(mlp, x, g, w, eps)
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
        f"rmsnorm_bwd N={n} D={d}: kernel {ms:.4f} ms (3 readings {ms_spread}; alone: row pass "
        f"{main_ms:.4f} ms on {blocks} CTAs, sum of the scratch {reduce_ms:.4f} ms), plain "
        f"{plain_ms:.4f} ms, F.rms_norm backward {lib_ms:.4f} ms (bf16 weight), bound "
        f"{bms:.4f} ms ({by}: {nbytes / 1e6:.1f} MB)",
        flush=True,
    )
    return dict(err=err, ms=ms, plain_ms=plain_ms, lib_ms=lib_ms, bound_ms=bms, bound_by=by,
                main_ms=main_ms, reduce_ms=reduce_ms)


def grads_of(model, batch, call=dict):
    """(loss, {parameter name: gradient}) of one training forward and
    backward; `call()` gives the model call's other keyword arguments."""
    model.zero_grad(set_to_none=True)
    loss = model(batch, train=True, **call())["loss"]
    loss.backward()
    g = {k: q.grad.detach().clone() for k, q in model.named_parameters() if q.grad is not None}
    model.zero_grad(set_to_none=True)
    return loss.item(), g


def step_vs_plain(model, batch, ops, tag, loss_atol, grad_rel, call=dict):
    """One training forward and backward with the kernels against the same
    with the plain versions: the loss and every parameter's gradient.
    `call()` gives the model call's other keyword arguments, made afresh for
    each run so that both draw the same (dropout generators, draws).
    `grad_rel` is one limit for every gradient, or a limit per parameter
    name. Prints the plain run's peak memory; returns the worst relative
    error (all of them in `step_vs_plain.last`)."""
    cuda = model.device.type == "cuda"
    loss_k, grads_k = grads_of(model, batch, call)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with ops.reference_mode():
        loss_p, grads_p = grads_of(model, batch, call)
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
    small ragged N, each bit for bit against a second launch; timed at both
    large shapes (mlp_timed)."""
    _, _, wg, wu, wd = mlp_inputs(dev, 1, 768, 3072, seed=6)
    res, err = {}, 0.0
    for n, act in ((200, "silu"), (8192, "gelu"), (n_ft, "gelu")):
        x = torch.randn(n, 768, generator=torch.Generator(device=dev).manual_seed(n),
                        device=dev).to(torch.bfloat16)
        out = mlp.mlp(x, wg, wu, wd, act)
        torch.cuda.synchronize()
        with ops.reference_mode():
            ref = mlp.mlp(x, wg, wu, wd, act)
        err = max(err, check_mlp("mlp", f"N={n}, {act}", out, ref))
        mlp_relaunch(mlp, "mlp", f"N={n}, {act}", (x, wg, wu, wd, act), out)
        del out, ref
        if n != 200:
            res[n] = mlp_timed(mlp, ops, "mlp", f"N={n}", x, None, wg, wu, wd)
    ft = {f"finetune_shape_{k}": v for k, v in res[n_ft].items() if k != "bound_by"}
    return dict(res[8192], err=err, finetune_shape_n=n_ft, **ft)


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


# PCQM4M-v2 as OGB splits it (split_dict: train, valid, test-dev; the rest of
# its 3,746,620 molecules is test-challenge, unlabelled), and the store this
# script writes in its schema
PCQM_SPLITS, PCQM_GRAPHS = (3_378_606, 73_545, 147_037), 3_746_620
STORE_GRAPHS = 200_000
WALK_CHECK_GRAPHS = 20_000
FT_STEPS = 24  # fine-tune steps of the graph-level phase


def _degenerate(kind: int, rng):
    """(nodes, local edge_index) of a degenerate molecule, as
    tests/test_partition_readers.py writes them: one node; four nodes and no
    edge; two 2-cliques."""
    if kind == 0:
        return 1, np.zeros((2, 0), np.int64)
    if kind == 1:
        return 4, np.zeros((2, 0), np.int64)
    return 4, np.asarray([[0, 1, 2, 3], [1, 0, 3, 2]], np.int64)


def _mol_chunk(args):
    """Molecules start..stop of the store (molecule i drawn from the seed
    (seed, i), as SyntheticMolDataset draws it), degenerate at the indices
    of `special`: (node_attr, edge_attr, local edge_index, node and edge
    counts, y)."""
    from graphgpt_torch.data.datasets import MOL_EDGE_CARD, MOL_NODE_CARD, random_molecule_graph

    start, stop, seed, special = args
    na, ea, ei, nn, ne, ys = [], [], [], [], [], []
    for i in range(start, stop):
        rng = np.random.default_rng((seed, i))
        if i in special:
            n, e = _degenerate(special[i], rng)
            na.append(np.stack([rng.integers(0, c, size=n) for c in MOL_NODE_CARD], 1))
            ea.append(np.stack([rng.integers(0, c, size=e.shape[1]) for c in MOL_EDGE_CARD], 1))
            ei.append(e)
            ys.append(rng.normal(5.0, 1.0, size=1))
        else:
            g = random_molecule_graph(rng)
            n = g.num_nodes
            na.append(g.node_attr), ea.append(g.edge_attr), ei.append(g.edge_index)
            ys.append(g.y)
        nn.append(n)
        ne.append(ei[-1].shape[1])
    return (np.concatenate(na).astype(np.int32), np.concatenate(ea).astype(np.int32),
            np.concatenate(ei, axis=1).astype(np.int32), np.asarray(nn), np.asarray(ne),
            np.concatenate(ys).astype(np.float32))


def write_graph_store(data_dir: str, n_graphs: int = STORE_GRAPHS, seed: int = 0,
                      procs: int = 8):
    """<data_dir>/pcqm4m-v2/graphs.npz in the readers' npz contract:
    `n_graphs` random molecules in PCQM4M-v2's schema (9 node and 3 edge
    columns, y [G, 1] float32), three degenerate ones (one node, four nodes
    without an edge, two 2-cliques) at the start of each split, and train,
    valid and test splits in PCQM4M-v2's proportions (contiguous, as OGB
    numbers them; the rest belongs to no split, as test-challenge). The
    molecules are drawn by `procs` spawned processes. Returns (path, split
    sizes)."""
    import multiprocessing as mp

    sizes = [round(n_graphs * s / PCQM_GRAPHS) for s in PCQM_SPLITS]
    starts = np.cumsum([0] + sizes)
    special = {int(s) + k + 1: k for s in starts[:3] for k in range(3)}
    t0 = time.perf_counter()
    bounds = np.linspace(0, n_graphs, 8 * procs + 1).astype(int)
    chunks = [(int(a), int(b), seed, {i: k for i, k in special.items() if a <= i < b})
              for a, b in zip(bounds[:-1], bounds[1:])]
    with mp.get_context("spawn").Pool(procs) as pool:
        parts = pool.map(_mol_chunk, chunks)
    gen_s = time.perf_counter() - t0
    nn = np.concatenate([p[3] for p in parts])
    ne = np.concatenate([p[4] for p in parts])
    node_ptr = np.concatenate([[0], np.cumsum(nn)]).astype(np.int64)
    edge_ptr = np.concatenate([[0], np.cumsum(ne)]).astype(np.int64)
    edge_index = np.concatenate([p[2] for p in parts], axis=1).astype(np.int64)
    edge_index += np.repeat(node_ptr[:-1], ne)[None, :]  # global node ids
    path = os.path.join(data_dir, "pcqm4m-v2", "graphs.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    t1 = time.perf_counter()
    np.savez(path, node_attr=np.concatenate([p[0] for p in parts]),
             edge_attr=np.concatenate([p[1] for p in parts]),
             edge_index=edge_index.astype(np.int32), node_ptr=node_ptr, edge_ptr=edge_ptr,
             y=np.concatenate([p[5] for p in parts])[:, None],
             train_idx=np.arange(starts[0], starts[1]), valid_idx=np.arange(starts[1], starts[2]),
             test_idx=np.arange(starts[2], starts[3]))
    write_s = time.perf_counter() - t1
    print(f"graph store: {n_graphs} molecules in PCQM4M-v2's schema ({int(node_ptr[-1])} nodes, "
          f"{int(edge_ptr[-1])} directed edges; degenerate at {sorted(special)}), splits "
          f"{sizes[0]} / {sizes[1]} / {sizes[2]} (PCQM4M-v2: {PCQM_SPLITS[0]} / {PCQM_SPLITS[1]} "
          f"/ {PCQM_SPLITS[2]} of {PCQM_GRAPHS}); {os.path.getsize(path)} bytes; drawn in "
          f"{gen_s:.1f} s ({procs} processes), written in {write_s:.1f} s", flush=True)
    return path, sizes


def host_cpu() -> str:
    """The host's CPU as /proc/cpuinfo names it (vendor, family and model
    where its model name reads "unknown", as in a sandboxed kernel), and
    its core count."""
    info = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, val = line.partition(":")
            info.setdefault(key.strip(), val.strip())
    name = info.get("model name", "unknown")
    if name == "unknown":
        name = (f"{info.get('vendor_id', '?')} family {info.get('cpu family', '?')} model "
                f"{info.get('model', '?')}")
    return f"{name}, {os.cpu_count()} cores"


@contextlib.contextmanager
def numpy_walk():
    """The port's numpy walk instead of its C++ one, as the tests pin it
    (`data/euler.py`: `_NATIVE_CHECKED, _NATIVE = True, None`), for a
    measurement."""
    from graphgpt_torch.data import euler

    saved = (euler._NATIVE_CHECKED, euler._NATIVE)
    euler._NATIVE_CHECKED, euler._NATIVE = True, None
    try:
        yield
    finally:
        euler._NATIVE_CHECKED, euler._NATIVE = saved


def walk_phase(path: str, n_check: int = WALK_CHECK_GRAPHS, n_numpy: int = 2000):
    """The C++ walk on the store's first `n_check` graphs: every node and
    every undirected edge visited, each step an edge or a jump between two
    components; then graphs/s of the C++ walk (all of them) and of the
    numpy walk (the first `n_numpy`) on one host core, the graphs read
    beforehand."""
    from graphgpt_torch.data import euler
    from graphgpt_torch.data.graph import CSR, connected_components
    from graphgpt_torch.readers import NpzGraphStore

    store = NpzGraphStore(path)
    graphs = [store.get(i) for i in range(n_check)]
    rng = np.random.default_rng(0)
    jumps = steps = 0
    for i, g in enumerate(graphs):
        n = g.num_nodes
        walk = euler.graph_to_walk(g, rng)
        a, b = walk[:-1], walk[1:]
        step_keys = np.minimum(a, b) * n + np.maximum(a, b)
        src, dst = g.edge_index.astype(np.int64)
        real = src != dst
        edge_keys = np.unique(np.minimum(src, dst)[real] * n + np.maximum(src, dst)[real])
        comp = connected_components(CSR(n, g.edge_index))
        is_edge = np.isin(step_keys, edge_keys)
        if not (np.array_equal(np.unique(walk), np.arange(n))
                and np.isin(edge_keys, step_keys).all()
                and (comp[a[~is_edge]] != comp[b[~is_edge]]).all()):
            fail(f"the C++ walk of graph {i} misses a node or an edge, or jumps inside a "
                 f"component: {walk.tolist()}")
        jumps += int((~is_edge).sum())
        steps += len(a)
    cpu = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, cpu[:1])  # one host core
    try:
        t0 = time.perf_counter()
        for g in graphs:
            euler.graph_to_walk(g, rng)
        cpp_gs = len(graphs) / (time.perf_counter() - t0)
        with numpy_walk():
            t0 = time.perf_counter()
            for g in graphs[:n_numpy]:
                euler.graph_to_walk(g, rng)
            numpy_gs = n_numpy / (time.perf_counter() - t0)
    finally:
        os.sched_setaffinity(0, cpu)
    print(f"walk: the C++ walk visits every node and edge of {n_check} graphs, {steps} steps of "
          f"which {jumps} jumps, each between two components; on one host core ({host_cpu()}) "
          f"the C++ walk {cpp_gs:.0f} graphs/s, the numpy walk {numpy_gs:.0f} graphs/s "
          f"({cpp_gs / numpy_gs:.1f}x)", flush=True)
    return dict(cpp_graphs_s=cpp_gs, numpy_graphs_s=numpy_gs, checked=n_check, jumps=jumps)


def worker_rss(loader):
    """(resident memory of each worker of the loader's pool in MiB, what it
    is): the peak (VmHWM) where the kernel reports it, else the current
    (VmRSS)."""
    out, kind = [], "VmHWM"
    for proc in getattr(loader._pool, "_pool", []):
        with open(f"/proc/{proc.pid}/status") as f:
            status = dict(line.split(":", 1) for line in f if ":" in line)
        kind = "VmHWM" if "VmHWM" in status else "VmRSS"
        out.append(int(status[kind].split()[0]) / 1024)
    return out, kind


def save_pretrain(model, pt_dir: str):
    """`model` as a pretrain checkpoint (step 0) under pt_dir/ckpt."""
    from graphgpt_torch.config import OptimizerConfig
    from graphgpt_torch.training.checkpoint import Checkpointer
    from graphgpt_torch.training.optimizer import make_optimizer
    from graphgpt_torch.training.steps import init_train_state

    tx = make_optimizer(OptimizerConfig(), 10, 1)
    Checkpointer(os.path.join(pt_dir, "ckpt")).save(
        0, init_train_state(model, tx), {"phase": "train"})


def graph_finetune_phase(pretrain_model, counters, ops, data_dir: str, sizes, overrides=()):
    """configs/pcqm4m_v2_supervised.yaml as shipped, read from the file, on
    the store through the pcqm4m-v2 reader (see the module docstring, 7b).
    Returns (its numbers, the launches of the fine-tune run)."""
    from graphgpt_torch import readers, synthetic
    from graphgpt_torch.config import load_config
    from graphgpt_torch.training.checkpoint import Checkpointer
    from graphgpt_torch.training.finetune import FinetunePipeline

    dev = pretrain_model.device
    with tempfile.TemporaryDirectory() as tmp:
        pt_dir, ft_dir = os.path.join(tmp, "pretrain"), os.path.join(tmp, "finetune")
        save_pretrain(pretrain_model, pt_dir)
        over = [f"tokenization.data_dir={data_dir}", f"training.output_dir={ft_dir}",
                f"training.pretrain_cpt={pt_dir}", *overrides]
        cfg = load_config(os.path.join(HERE, "configs", "pcqm4m_v2_supervised.yaml"), over)
        t0 = time.perf_counter()
        pipe = FinetunePipeline(cfg, device=dev).setup()
        setup_s = time.perf_counter() - t0
        got = [len(pipe.train_idx), len(pipe.valid_idx), len(pipe.test_idx)]
        m, t = pipe.cfg.model, pipe.cfg.training
        print(f"graph-level fine-tune setup {setup_s:.1f} s (the vocab scanned from 10,000 "
              f"graphs: {m.vocab_size} tokens): {m.hidden_size} x {m.num_hidden_layers}, "
              f"{m.stacked_feat_agg_method}, {m.problem_type} {m.loss_type}, remat "
              f"{m.remat_policy}, {m.dtype}, LayerScale {m.layer_scale_init_value}, batch "
              f"{t.batch_size}, {t.optimizer.scheduler} {t.optimizer.lr}, EMA "
              f"{t.optimizer.ema_decay}, {t.num_workers} loader workers; the reader's splits "
              f"train {got[0]}, valid {got[1]}, test {got[2]}", flush=True)
        if got != list(sizes) or type(pipe.dataset).__name__ != "SplitDataset":
            fail(f"FinetunePipeline did not take the reader's splits {sizes}: {got}")
        # the first FT_STEPS batches of epoch 0: the train split cut to them
        pipe.train_idx, pipe.epochs = pipe.train_idx[: FT_STEPS * t.batch_size], 1
        model = pipe.state.model
        idx0 = np.random.default_rng((t.seed, 0)).permutation(pipe.train_idx)
        t0 = time.perf_counter()
        nb = next(pipe.loader.epoch_batches(idx0, 0)).data
        first_s = time.perf_counter() - t0
        # the loader alone, its pool warm: one pass over the cut train split
        t0 = time.perf_counter()
        n_graphs = sum(bb["segment_ids"].shape[0]
                       for bb in pipe.loader.epoch_batches(pipe.train_idx, epoch=1))
        loader_gs = n_graphs / (time.perf_counter() - t0)
        rss, rss_kind = worker_rss(pipe.loader)
        batch = synthetic.to_torch(nb, dev)
        b, p = nb["segment_ids"].shape
        print(f"graph-level fine-tune batch: {b} graphs x {p} positions, "
              f"{int((nb['segment_ids'] > 0).sum())} tokens; the pool's first batch in "
              f"{first_s:.2f} s", flush=True)
        # against an fp32 run, as the long-context step: without LayerScale
        # the deeper q/k gradients are tiny and bf16 moves them by tens of
        # percent on either path (against the plain bf16 run the worst,
        # layers.11.self_attn.k_proj, read 0.326 on an H100)
        grad = step_vs_fp32(model, batch, ops, "graph-level finetune")
        torch.cuda.empty_cache()

        L = m.num_hidden_layers
        train_log, eval_log, metrics = counted_pipeline(pipe, counters)
        times = []
        step_fn = pipe.train_step

        def timed_step(*a, **kw):
            times.append(time.perf_counter())
            out = step_fn(*a, **kw)
            if len(times) == FT_STEPS:
                torch.cuda.synchronize()
                times.append(time.perf_counter())
            return out

        pipe.train_step = timed_step
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        best = pipe.run()
        run_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated() / 2**20
        # pairs remat runs the attention of each layer again in the backward
        # and the MLP of the first layer of each pair (the denoise step's
        # count); the MLP's norm backward is in torch ops, the attention input
        # norms' and the final norm's in #13. Predicted first 2 L norm_mlp; an
        # H100 read L + L // 2
        want = {**{k: 0 for k in counters}, "flash_fwd": 2 * L, "norm_mlp": L + L // 2,
                "flash_bwd": L, "rmsnorm_bwd": L + 1}
        want_eval = {**{k: 0 for k in counters}, "flash_fwd": L, "norm_mlp": L}
        check_logs("graph-level fine-tune", train_log, eval_log, want, want_eval, FT_STEPS)
        losses = [float(x["loss"]) for x in metrics]
        print("graph-level fine-tune losses: " + " ".join(f"{x:.4f}" for x in losses),
              flush=True)
        if not all(np.isfinite(losses)):
            fail(f"the graph-level fine-tune losses are not finite: {losses}")
        trained = (FT_STEPS - 1) * t.batch_size
        pipe_gs = trained / (times[-1] - times[1])
        print(f"graph-level fine-tune eval (PCQM4M-v2's MAE): valid_mae {best.get('valid_mae')} "
              f"on the reader's {got[1]} valid graphs, valid_ema_mae "
              f"{best.get('valid_ema_mae')}, test_mae {best.get('test_mae')} on {got[2]}, "
              f"train_mae {best.get('train_mae')}", flush=True)
        if not all(np.isfinite(best.get(k, np.nan)) for k in ("valid_mae", "valid_ema_mae",
                                                               "test_mae")):
            fail(f"the graph-level valid, EMA-valid and test MAE are not finite: {best}")
        if not os.path.exists(os.path.join(ft_dir, "result.csv")) or Checkpointer(
                os.path.join(ft_dir, "ckpt")).all_steps() != [0]:
            fail("the graph-level fine-tune wrote no result.csv or no epoch checkpoint")
        ms = cuda_ms(lambda: pipe.train_step(pipe.state, batch, seed=t.seed), iters=1, warmup=1,
                     repeats=5)
        ms_spread = spread()
        print(f"graph-level fine-tune: {ms:.2f} ms/step on a batch on the card (5 readings "
              f"{ms_spread}), {b / ms * 1e3:.0f} graphs/s; through the pipeline {pipe_gs:.0f} "
              f"graphs/s (steps 2-{FT_STEPS}); the loader alone {loader_gs:.0f} graphs/s with "
              f"{t.num_workers} workers, their RSS ({rss_kind}) {max(rss, default=0):.0f} MiB "
              f"each at most ({sum(rss):.0f} in all); the whole run ({FT_STEPS} steps, eval of "
              f"{t.k_samplers} train + {got[1]} valid (twice, EMA) + {got[2]} test graphs, "
              f"checkpoints) {run_s:.1f} s; max_memory_allocated {peak:.0f} MiB", flush=True)

        # the split under PCQM4M-v2's special-molecule and true-valid policies
        pol = {"remove_special": {"edge0": True, "node1": True, "disconnected": True},
               "true_valid": True}
        pcfg = load_config(os.path.join(HERE, "configs", "pcqm4m_v2_supervised.yaml"),
                           over + [f"tokenization.dataset_policy={json.dumps(pol)}"])
        t0 = time.perf_counter()
        tr, va, te = readers.read_dataset("pcqm4m-v2", pcfg).splits()
        pol_s = time.perf_counter() - t0
        print(f"graph-level split with dataset_policy {pol}: train {len(tr)}, valid {len(va)}, "
              f"test {len(te)} (host only, {pol_s:.1f} s)", flush=True)
        # the nine degenerate molecules go (three a split: one node, no
        # edge, two components); true_valid keeps 5000 of valid, here all
        special = {int(s) + k for s in np.cumsum([0] + list(sizes))[:3] for k in (1, 2, 3)}
        if (len(tr) != sizes[0] - 3 or len(va) != min(sizes[1] - 3, 5000)
                or special & set(np.concatenate([tr, va, te]).tolist())):
            fail(f"the policy split is not the one asked for: {len(tr)}, {len(va)}, {len(te)}")
        res = dict(step_ms=ms, pipeline_graphs_s=pipe_gs, loader_graphs_s=loader_gs,
                   first_s=first_s, worker_rss_mib=max(rss, default=0), peak_mib=peak,
                   tokens_per_graph=int((nb["segment_ids"] > 0).sum()) / b,
                   grad_ratio=grad["ratio"],
                   valid_mae=best.get("valid_mae"), run_s=run_s,
                   policy_sizes=[len(tr), len(va), len(te)])
    return res, launches


# ---------------------------------------------------------------------------
# Big-graph phases (A ogbl-ppa fine-tune, B ogbn-proteins fine-tune, C
# ogbn-proteins pretraining) on seeded stores in OGB's schemas
# ---------------------------------------------------------------------------
# OGB's sizes: ogbl-ppa's nodes and undirected edges (all splits), its split
# ratios (train 70, valid 20, test 10) and eval negatives (3,000,000 a split
# against 21,231,931 train edges); ogbn-proteins' nodes, undirected edges,
# species (taxonomy ids), labels and species split
PPA_NODES, PPA_EDGES, PPA_SPECIES = 576_289, 30_326_273, 58
PPA_NEG_SHARE = 3_000_000 / 21_231_931
PROTEINS_NODES, PROTEINS_EDGES, PROTEINS_LABELS = 132_534, 39_561_252, 112
PROTEINS_SPECIES = (3702, 4932, 6239, 7227, 7955, 9606, 10090, 511145)
PROTEINS_SPLIT = (86_619, 21_236, 24_679)
# the cuts: ogbl-ppa's edge_index a quarter of its edges (average degree 26
# over the real node count, above the reader's fanout 14), ogbn-proteins' an
# eighth (average degree 75, far above fanout 10)
PPA_CUT, PROTEINS_CUT = 4, 8
# the synthetic structure: communities of consecutive nodes (within a
# species for proteins), a share of each node's edges inside its own
BIG_COMMUNITY = {"ogbl-ppa": (64, 0.7), "ogbn-proteins": (256, 0.5)}
BIG_STEPS = 16  # counted fine-tune steps of phases A and B
BIG_EVAL = {"ogbl-ppa": 1024, "ogbn-proteins": 512}  # valid samples evaluated
# rows of the first step held to the plain and fp32 runs: ogbl-ppa's whole
# batch (its AUC loss pairs positives with negatives of the same batch; on
# 16 rows bf16 moved it 4e-3 from fp32 on the plain path and 1.6e-2 on the
# kernels', on one seed, which is not explained yet), 16 of
# ogbn-proteins' (the plain attention of all 128 rows at 1024 would keep
# 77 GB of fp32 scores)
BIG_STEP_ROWS = {"ogbl-ppa": 256, "ogbn-proteins": 16}
PT_STEPS = 4  # pretraining steps of phase C


def _community_edges(rng, n: int, m: int, community: int, inside: float, group_lo, group_hi):
    """m distinct undirected edges (rows lo < hi) over nodes 0..n-1: each
    from a uniform node, to a node of its own community of `community`
    consecutive nodes with probability `inside`, else to a uniform node of
    its group [group_lo[node], group_hi[node]); no self loop."""
    out = np.zeros((0, 2), np.int64)
    while len(out) < m:
        k = 2 * (m - len(out)) + 1024
        src = rng.integers(0, n, k)
        lo, hi = group_lo[src], group_hi[src]
        base = np.maximum(src // community * community, lo)
        comm = base + rng.integers(0, community, k)
        far = lo + (rng.random(k) * (hi - lo)).astype(np.int64)
        dst = np.where((rng.random(k) < inside) & (comm < hi), comm, far)
        keep = src != dst
        pairs = np.stack([np.minimum(src, dst)[keep], np.maximum(src, dst)[keep]], 1)
        keys = np.unique(np.concatenate([out[:, 0] * n + out[:, 1], pairs[:, 0] * n + pairs[:, 1]]))
        keys = rng.permutation(keys)[:m]
        out = np.stack([keys // n, keys % n], 1)
    return out


def write_big_graph_store(data_dir: str, name: str, n_nodes: int = 0, n_edges: int = 0,
                          seed: int = 0):
    """<data_dir>/<name>/big_graph.npz in the schema `tools/convert_ogb.py`
    writes (the readers' npz contract), seeded: ogbl-ppa's (node_attr
    [global id, species] over 58 species; edge_index the train edges, both
    directions; {train,valid,test}_edge in OGB's 70/20/10 proportions,
    {valid,test}_edge_neg at OGB's share of train) or ogbn-proteins' (8
    species of consecutive node blocks, node_attr [species, local id],
    node_species, edge_attr [E, 8] in 0-999 (the same both ways), y [N, 112]
    binary, x_mask, the species split in OGB's sizes), its edges within a
    species. Node ids are shuffled at the end. n_nodes / n_edges 0: OGB's
    node count and edge count over the cut. Returns (path, seconds to draw,
    seconds to write)."""
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    ppa = name == "ogbl-ppa"
    n = n_nodes or (PPA_NODES if ppa else PROTEINS_NODES)
    community, inside = BIG_COMMUNITY[name]
    if ppa:
        m = n_edges or PPA_EDGES // PPA_CUT
        lo, hi = np.zeros(n, np.int64), np.full(n, n, np.int64)
        m_all = m + int(m * 3 / 7)  # train, then valid and test positives
    else:
        m = m_all = n_edges or PROTEINS_EDGES // PROTEINS_CUT
        # species blocks in OGB's split sizes (train, valid, test species)
        sizes = np.asarray(PROTEINS_SPLIT) * n // PROTEINS_NODES
        sizes[0] += n - sizes.sum()
        block_sizes = [len(b) for b in np.array_split(np.arange(sizes[0]), 6)] + list(sizes[1:])
        starts = np.cumsum([0] + block_sizes)
        species_of_block = np.asarray(PROTEINS_SPECIES)
        block = np.searchsorted(starts, np.arange(n), side="right") - 1
        lo, hi = starts[block], starts[block + 1]
    edges = _community_edges(rng, n, m_all, community, inside, lo, hi)
    perm = rng.permutation(n)  # shuffled node ids
    edges = perm[edges]
    train = edges[:m]
    data = dict(edge_index=np.concatenate([train, train[:, ::-1]]).T.astype(np.int32),
                num_nodes=np.int64(n))
    if ppa:
        n_va = (m_all - m) * 2 // 3
        data.update(train_edge=train, valid_edge=edges[m:m + n_va], test_edge=edges[m + n_va:])
        n_neg = int(round(m * PPA_NEG_SHARE))
        for split in ("valid", "test"):
            data[f"{split}_edge_neg"] = rng.integers(0, n, (n_neg, 2))
        species = rng.integers(0, PPA_SPECIES, n)
        data["node_attr"] = np.stack([np.arange(n), species], 1).astype(np.int32)
    else:
        species = np.empty(n, np.int64)
        species[perm] = species_of_block[block]
        local = np.empty(n, np.int64)
        local[perm] = np.arange(n) - lo + 1  # 1-based running count in the species
        data["node_attr"] = np.stack([species, local], 1).astype(np.int32)
        data["node_species"] = species
        e_attr = rng.integers(0, 1000, (m, 8)).astype(np.int32)
        data["edge_attr"] = np.concatenate([e_attr, e_attr])
        data["y"] = (rng.random((n, PROTEINS_LABELS)) < 0.15).astype(np.int64)
        data["x_mask"] = np.ones(2, np.int64)
        split_of_block = np.repeat([0, 1, 2], (6, 1, 1))
        node_split = np.empty(n, np.int64)
        node_split[perm] = split_of_block[block]
        for k, split in enumerate(("train", "valid", "test")):
            data[f"{split}_idx"] = np.flatnonzero(node_split == k)
    gen_s = time.perf_counter() - t0
    path = os.path.join(data_dir, name, "big_graph.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    t1 = time.perf_counter()
    np.savez(path, **data)
    write_s = time.perf_counter() - t1
    e = data["edge_index"].shape[1]
    print(f"big-graph store {name}: {n} nodes, {e // 2} undirected edges in edge_index "
          f"(average degree {e / n:.1f}), "
          + ", ".join(f"{k} {tuple(v.shape)}" for k, v in data.items()
                      if k not in ("edge_index", "num_nodes"))
          + f"; {os.path.getsize(path)} bytes, drawn in {gen_s:.1f} s, written in {write_s:.1f} s",
          flush=True)
    return path, gen_s, write_s


def csr_build_seconds(path: str) -> float:
    """The reader's CSR of the store built and cached (`readers._big_csr`),
    timed; later reads map the cache."""
    from graphgpt_torch import readers

    t0 = time.perf_counter()
    big, _ = readers._load_big_graph(path)
    readers._big_csr(path, big)
    return time.perf_counter() - t0


def one_core_samples(ds, tok, idx, max_length: int):
    """The dataset plus tokenizer on one host core over `idx`: (samples/s,
    mean tokens a sample, the share longer than max_length)."""
    cpu = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, cpu[:1])
    try:
        t0 = time.perf_counter()
        lens = [tok(ds[int(i)], np.random.default_rng(int(i))).seq_len for i in idx]
        rate = len(idx) / (time.perf_counter() - t0)
    finally:
        os.sched_setaffinity(0, cpu)
    lens = np.asarray(lens)
    return rate, float(lens.mean()), float((lens > max_length).mean())


def embed_grad_probe(ids, d: int, vocabs, chunk: int):
    """Both routes of the embedding gradient (modeling.embedding_grad) timed
    on `ids` [N, F] (taken modulo each vocab size) with a bf16 cotangent
    [N, D]: {vocab: (count-matrix ms, segment-sum ms)}; the two held to each
    other."""
    from graphgpt_torch.models import modeling

    gen = torch.Generator(device=ids.device).manual_seed(3)
    gf = torch.randn(ids.shape[0], d, generator=gen, device=ids.device).to(torch.bfloat16)
    out = {}
    for v in vocabs:
        vi = ids % v
        seg = modeling._segment_sum_grad(vi, gf, v)
        cnt = modeling._count_matrix_grad(vi, gf, v, chunk)
        err = rel_err(seg, cnt)
        if err > 1e-5:
            fail(f"the two embedding-gradient routes differ at vocab {v}: {err:.3e}")
        del seg, cnt
        out[v] = (cuda_ms(lambda: modeling._count_matrix_grad(vi, gf, v, chunk), iters=2,
                          warmup=1),
                  cuda_ms(lambda: modeling._segment_sum_grad(vi, gf, v), iters=2, warmup=1))
    torch.cuda.empty_cache()
    return out


def big_finetune_phase(pretrain_model, counters, fa, mlp, ops, data_dir: str, name: str,
                       overrides=()):
    """Phase A (ogbl-ppa) or B (ogbn-proteins): the dataset's supervised
    config as shipped, read from the file, on its store through the
    FinetunePipeline, warm-started from the train phase's model (see the
    module docstring). Returns (its numbers, the launches of the run)."""
    from graphgpt_torch import synthetic
    from graphgpt_torch.config import load_config
    from graphgpt_torch.models.modeling import derive_generator
    from graphgpt_torch.models.rope import reset_position_ids, rope_cos_sin
    from graphgpt_torch.training.finetune import FinetunePipeline

    ppa = name == "ogbl-ppa"
    tag = "phase A (ogbl-ppa)" if ppa else "phase B (ogbn-proteins)"
    cfg_file = "ogbl_ppa_supervised.yaml" if ppa else "ogbn_proteins_supervised.yaml"
    dev = pretrain_model.device
    path = os.path.join(data_dir, name, "big_graph.npz")
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        pt_dir, ft_dir = os.path.join(tmp, "pretrain"), os.path.join(tmp, "finetune")
        save_pretrain(pretrain_model, pt_dir)
        over = [f"tokenization.data_dir={data_dir}", f"training.output_dir={ft_dir}",
                f"training.pretrain_cpt={pt_dir}", "training.schedule.logging_steps=1",
                *overrides]
        cfg = load_config(os.path.join(HERE, "configs", cfg_file), over)
        t0 = time.perf_counter()
        pipe = FinetunePipeline(cfg, device=dev).setup()
        setup_s = time.perf_counter() - t0
        m, t = pipe.cfg.model, pipe.cfg.training
        ds, tok = pipe.dataset, pipe.tokenizer
        print(f"{tag} setup {setup_s:.1f} s (the reader, the vocab from the full tables: "
              f"{m.vocab_size} tokens): {m.hidden_size} x {m.num_hidden_layers}, stacked_feat "
              f"{m.stacked_feat} ({pipe.cfg.tokenization.stack_method}, "
              f"{type(tok).__name__}), {m.stacked_feat_agg_method}, {m.problem_type} "
              f"{m.loss_type} ({m.num_labels} labels), remat {m.remat_policy}, {m.dtype}, "
              f"LayerScale {m.layer_scale_init_value}, DropPath {m.path_dropout}, attention "
              f"dropout {m.attention_dropout}, batch {t.batch_size}, max_length "
              f"{t.max_length}, {t.optimizer.scheduler} {t.optimizer.lr}, EMA "
              f"{t.optimizer.ema_decay if t.optimizer.use_ema else 'off'}, {t.num_workers} "
              f"loader workers; dataset {type(ds).__name__} of {len(ds)} samples (the "
              f"reader's train split), train {len(pipe.train_idx)} / valid "
              f"{len(pipe.valid_idx)} by train_valid_split", flush=True)
        want_cls = "EgoEdgeDataset" if ppa else "EgoNodeDataset"
        if type(ds).__name__ != want_cls or (not ppa and type(tok).__name__ !=
                                             "StackedGSTTokenizerLong"):
            fail(f"{tag}: the pipeline built {type(ds).__name__} / {type(tok).__name__}")
        if ppa and m.vocab_size <= ds.big.num_nodes:
            fail(f"{tag}: the vocab ({m.vocab_size}) does not hold every global node id")
        one_rate, tokens_mean, cut_share = one_core_samples(
            ds, tok, np.random.default_rng(1).choice(pipe.train_idx, 256), t.max_length)
        # the first BIG_STEPS batches of epoch 0 and BIG_EVAL valid samples
        pipe.train_idx, pipe.epochs = pipe.train_idx[: BIG_STEPS * t.batch_size], 1
        pipe.valid_idx = pipe.test_idx = pipe.valid_idx[: BIG_EVAL[name]]
        model = pipe.state.model
        idx0 = np.random.default_rng((t.seed, 0)).permutation(pipe.train_idx)
        t0 = time.perf_counter()
        nb = next(pipe.loader.epoch_batches(idx0, 0)).data
        first_s = time.perf_counter() - t0
        rss, rss_kind = worker_rss(pipe.loader)
        t0 = time.perf_counter()
        n_loaded = sum(bb["segment_ids"].shape[0]
                       for bb in pipe.loader.epoch_batches(pipe.train_idx[: 4 * t.batch_size],
                                                           epoch=1))
        loader_rate = n_loaded / (time.perf_counter() - t0)
        batch = synthetic.to_torch(nb, dev)
        b, p = nb["segment_ids"].shape
        n_rows = b * p
        print(f"{tag} batch: {b} samples x {p} positions (N {n_rows}), "
              f"{int((nb['segment_ids'] > 0).sum())} tokens; the pool's first batch in "
              f"{first_s:.2f} s, its workers' RSS ({rss_kind}) {max(rss, default=0):.0f} MiB at "
              f"most ({sum(rss):.0f} in all); dataset + tokenizer on one host core "
              f"{one_rate:.0f} samples/s ({host_cpu()}), {tokens_mean:.1f} tokens a sample, "
              f"{cut_share:.1%} longer than max_length {t.max_length}; the loader alone "
              f"{loader_rate:.0f} samples/s with {t.num_workers} spawned workers", flush=True)

        # every kernel of the step at this batch's shape against its plain version
        pos = reset_position_ids(batch["position_ids"], m.rope_range)
        cos, sin = (x.to(torch.bfloat16) for x in rope_cos_sin(
            pos, m.head_dim, m.rope_theta, resonance=m.rope_resonance,
            rope_scaling=m.rope_scaling, max_position_embeddings=m.max_position_embeddings))
        shape = dict(flash=flash_at_shape(fa, ops, tag, batch["segment_ids"], cos, sin,
                                          m.num_attention_heads, m.head_dim,
                                          m.causal_attention),
                     rms=rms_bwd_phase(dev, mlp, ops, n_rows))
        shape["mlp"] = norm_mlp_at_shape(dev, mlp, ops, n_rows, tag,
                                         name="norm_mlp" if ppa else "mlp")
        del cos, sin
        # the embedding gradient's two routes at this batch's ids and width
        ids = batch["input_ids"].reshape(-1, 1 if m.stacked_feat_agg_method == "gated"
                                         else m.stacked_feat).long()
        gated = m.stacked_feat_agg_method == "gated"
        probe = embed_grad_probe(ids, m.hidden_size, (1024, 4096, 16384, 65536, m.vocab_size),
                                 65536 if gated else 8192)
        from graphgpt_torch.models.modeling import segment_route

        print(f"{tag} embedding gradient at N {ids.shape[0]} x F {ids.shape[1]}, D "
              f"{m.hidden_size} (ms, count matrix / segment sum): "
              + ", ".join(f"V {v}: {a:.3f} / {s:.3f}" for v, (a, s) in probe.items())
              + f"; the route at this model's vocab: "
              f"{'segment sum' if segment_route(*ids.shape, m.vocab_size) else 'count matrix'}",
              flush=True)
        # the first step against the plain bf16 run and an fp32 run, on rows
        sub = {k: v[: BIG_STEP_ROWS[name]] for k, v in batch.items()}
        gen_call = (lambda: dict(generator=derive_generator(t.seed, 0, dev)))
        grad = step_vs_fp32(model, sub, ops, tag, gen_call)
        torch.cuda.empty_cache()

        L = m.num_hidden_layers
        train_log, eval_log, metrics = counted_pipeline(pipe, counters)
        times = []
        step_fn = pipe.train_step

        ends = []

        def timed_step(*a, **kw):
            times.append(time.perf_counter())
            out = step_fn(*a, **kw)
            torch.cuda.synchronize()  # the pipeline's log line syncs each step too
            ends.append(time.perf_counter())
            return out

        pipe.train_step = timed_step
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        best = pipe.run()
        run_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated() / 2**20
        # through the pipeline, steps 2-16: samples/s, the step's own seconds
        # and the wait between one step's end and the next one's start
        pipe_rate = (BIG_STEPS - 1) * t.batch_size / (ends[BIG_STEPS - 1] - times[1])
        in_step = float(np.mean([e - s for s, e in zip(times[1:BIG_STEPS], ends[1:])]))
        gap = float(np.mean([s - e for s, e in zip(times[2:BIG_STEPS], ends[1:])]))
        zero = {k: 0 for k in counters}
        if ppa:  # pairs remat, no LayerScale: as the graph-level phase
            want = {**zero, "flash_fwd": 2 * L, "norm_mlp": L + L // 2, "flash_bwd": L,
                    "rmsnorm_bwd": L + 1}
            want_eval = {**zero, "flash_fwd": L, "norm_mlp": L}
        else:  # pairs remat with LayerScale and DropPath: as the fine-tune phase
            want = {**zero, "mlp": 2 * L, "flash_fwd": 2 * L, "flash_bwd": L,
                    "rmsnorm_bwd": 2 * L + 1}
            want_eval = {**zero, "mlp": L, "flash_fwd": L}
        check_logs(tag, train_log, eval_log, want, want_eval, BIG_STEPS)
        losses = [float(x["loss"]) for x in metrics]
        print(f"{tag} losses: " + " ".join(f"{x:.4f}" for x in losses), flush=True)
        if not all(np.isfinite(losses)):
            fail(f"{tag}: the losses are not finite: {losses}")
        key = "hits@100" if ppa else "auroc"
        got = {k: best.get(k) for k in (f"valid_{key}", f"valid_ema_{key}", f"test_{key}",
                                        f"train_{key}")}
        print(f"{tag} eval ({key}; {'the ogbl-ppa evaluator' if ppa else 'ROC-AUC over the '}"
              f"{'' if ppa else '112 labels'}) on {len(pipe.valid_idx)} valid samples: {got}",
              flush=True)
        if not all(np.isfinite(got[k] if got[k] is not None else np.nan)
                   for k in (f"valid_{key}", f"valid_ema_{key}")):
            fail(f"{tag}: the valid and EMA-valid {key} are not finite: {best}")
        ms = cuda_ms(lambda: pipe.train_step(pipe.state, batch, seed=t.seed), iters=1, warmup=1,
                     repeats=5)
        ms_spread = spread()
        print(f"{tag} through the pipeline: a step {in_step * 1e3:.1f} ms, the wait before the "
              f"next {gap * 1e3:.1f} ms (means over steps 2-{BIG_STEPS}, host clock)", flush=True)
        phase_s = time.perf_counter() - t_phase
        print(f"{tag}: {ms:.2f} ms/step on a batch on the card (5 readings {ms_spread}), "
              f"{b / ms * 1e3:.0f} samples/s; through the pipeline {pipe_rate:.0f} samples/s "
              f"(steps 2-{BIG_STEPS}); the run ({BIG_STEPS} steps, eval, checkpoints) "
              f"{run_s:.1f} s; max_memory_allocated {peak:.0f} MiB; the phase {phase_s:.1f} s",
              flush=True)
        if peak > 80 * 1024:
            fail(f"{tag}: peak memory {peak:.0f} MiB")
        res = dict(step_ms=ms, pipeline_samples_s=pipe_rate, loader_samples_s=loader_rate,
                   pipeline_step_ms=in_step * 1e3, pipeline_wait_ms=gap * 1e3,
                   one_core_samples_s=one_rate, first_s=first_s,
                   worker_rss_mib=max(rss, default=0), peak_mib=peak, tokens_mean=tokens_mean,
                   cut_share=cut_share, n_rows=n_rows, grad_ratio=grad["ratio"],
                   vocab=m.vocab_size, setup_s=setup_s, phase_s=phase_s,
                   metric=got[f"valid_{key}"],
                   embed_grad={str(v): list(x) for v, x in probe.items()}, **shape)
    return res, launches


def big_pretrain_phase(dev, counters, data_dir: str, overrides=()):
    """Phase C: configs/ogbn_proteins_pretrain.yaml as shipped (256 x 4,
    gated, long stacking, pretrain-mlm packed, dropouts), read from the file,
    on the ogbn-proteins store through PretrainPipeline: PT_STEPS steps with
    their launch counts, finite losses, the save point's valid loss. Returns
    (its numbers, the launches)."""
    from graphgpt_torch.config import load_config
    from graphgpt_torch.training.pipeline import PretrainPipeline

    tag = "phase C (ogbn-proteins pretraining)"
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cfg = load_config(os.path.join(HERE, "configs", "ogbn_proteins_pretrain.yaml"), [
            f"tokenization.data_dir={data_dir}", f"training.output_dir={tmp}",
            f"training.schedule.total_num_steps={PT_STEPS}",
            "training.schedule.warmup_num_steps=1", "training.schedule.logging_steps=1",
            # the save point's generation sweep cut as the long-context
            # phase's: 2 bands over 4 graphs in 16 steps
            "training.gen_eval_bands=2", "training.gen_eval_samples=4", "generation.steps=16",
            *overrides])
        t0 = time.perf_counter()
        pipe = PretrainPipeline(cfg, device=dev).setup()
        setup_s = time.perf_counter() - t0
        m, t = pipe.cfg.model, pipe.cfg.training
        print(f"{tag} setup {setup_s:.1f} s: {m.hidden_size} x {m.num_hidden_layers}, vocab "
              f"{m.vocab_size} from the tables, stacked_feat {m.stacked_feat} "
              f"({type(pipe.tokenizer).__name__}), batch {t.batch_size} packed rows of "
              f"{t.max_length}, valid {len(pipe.valid_idx)}", flush=True)
        if type(pipe.tokenizer).__name__ != "StackedGSTTokenizerLong":
            fail(f"{tag}: the pipeline built {type(pipe.tokenizer).__name__}")
        L = m.num_hidden_layers
        train_log, eval_log, _ = counted_pipeline(pipe, counters)
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        pipe.run()
        run_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated() / 2**20
        zero = {k: 0 for k in counters}
        # DropPath in training: the split MLP (#11) outside remat; the
        # eval's forwards take the norm-fused #2
        want = {**zero, "mlp": L, "flash_fwd": L, "flash_bwd": L, "rmsnorm_bwd": 2 * L + 1}
        want_eval = {**zero, "norm_mlp": L, "flash_fwd": L}
        check_logs(tag, train_log, eval_log, want, want_eval, PT_STEPS)
        rows = csv_rows(os.path.join(tmp, "log.csv"))
        losses = [float(r["loss"]) for r in rows]
        res_rows = csv_rows(os.path.join(tmp, "result.csv"))
        valid = float(res_rows[-1].get("valid_loss", "nan")) if res_rows else float("nan")
        print(f"{tag} losses: " + " ".join(f"{x:.4f}" for x in losses) + f"; tokens/s "
              + " ".join(f"{float(r['tokens_per_s']):.0f}" for r in rows)
              + f"; valid loss {valid:.4f}; the run {run_s:.1f} s; max_memory_allocated "
              f"{peak:.0f} MiB; the phase {time.perf_counter() - t_phase:.1f} s", flush=True)
        if len(losses) != PT_STEPS or not all(np.isfinite(losses)) or not np.isfinite(valid):
            fail(f"{tag}: expected {PT_STEPS} finite losses and a valid loss: {losses} {valid}")
        res = dict(losses=losses, valid_loss=valid, peak_mib=peak,
                   tokens_per_s=float(rows[-1]["tokens_per_s"]),
                   phase_s=time.perf_counter() - t_phase)
    return res, launches


def big_graph_phases(pretrain_model, counters, fa, mlp, ops, data_dir: str, sizes=None,
                     overrides=None):
    """The two seeded stores (see write_big_graph_store; `sizes` maps a
    store's name to (nodes, edges) for a rehearsal), their CSR builds, and
    phases A, B and C (`overrides` maps a phase's name to config overrides).
    Returns ({phase: its numbers}, {phase: its launches})."""
    sizes, overrides = sizes or {}, overrides or {}
    res, launches, store = {}, {}, {}
    for name in ("ogbl-ppa", "ogbn-proteins"):
        path, gen_s, write_s = write_big_graph_store(data_dir, name, *sizes.get(name, (0, 0)))
        csr_s = csr_build_seconds(path)
        print(f"big-graph store {name}: the reader's CSR built and cached in {csr_s:.1f} s",
              flush=True)
        store[name] = dict(store_draw_s=gen_s, store_write_s=write_s, csr_s=csr_s)
    for phase, name in (("A", "ogbl-ppa"), ("B", "ogbn-proteins")):
        torch.cuda.empty_cache()
        res[phase], launches[phase] = big_finetune_phase(
            pretrain_model, counters, fa, mlp, ops, data_dir, name, overrides.get(phase, ()))
        res[phase].update(store[name])
    torch.cuda.empty_cache()
    res["C"], launches["C"] = big_pretrain_phase(pretrain_model.device, counters, data_dir,
                                                 overrides.get("C", ()))
    return res, launches


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


def check_stream_batch(fa, ops, tag, qs, k, v, seg_q, seg_k, cos, sin, do, dh):
    """#6, #7 (with its delta) and #8 at the whole launch that the
    long-context step makes, B 16 x P 4096 (a persistent kernel's schedule
    depends on B), #7 and #8 on #6's out and lse, against their plain
    versions run one row at a time: #6's errors as check_flash_fwd's, #7's
    and #8's as check_flash_bwd's; delta within DELTA_ATOL; padded query
    rows, query rows that see no key (out 0, lse -1e30) and keys that no
    query sees exactly 0 (the path is bidirectional: a pair is visible when
    the ids match); a second launch of each gives the same bits. Returns the
    largest elementwise errors of out and lse ("fwd"), dq, and dk and dv,
    the largest relative error of the backward ("rel") and delta's."""
    out, lse = fa.flash_fwd_stream(qs, k, v, seg_q, seg_k, cos, sin, False, dh)
    dq, delta = fa.flash_dq_stream(qs, k, v, seg_q, seg_k, cos, sin, out, lse, do, None, False,
                                   dh)
    dk, dv = fa.flash_dkv_stream(qs, k, v, seg_q, seg_k, cos, sin, lse, delta, do, False, dh)
    again = (*fa.flash_fwd_stream(qs, k, v, seg_q, seg_k, cos, sin, False, dh),
             *fa.flash_dq_stream(qs, k, v, seg_q, seg_k, cos, sin, out, lse, do, None, False, dh),
             *fa.flash_dkv_stream(qs, k, v, seg_q, seg_k, cos, sin, lse, delta, do, False, dh))
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(again, (out, lse, dq, delta, dk, dv)))
    parts = []
    with ops.reference_mode():
        for r in range(seg_q.shape[0]):
            row = lambda *ts: [None if t is None else t[r : r + 1] for t in ts]  # noqa: E731
            args = row(qs, k, v, seg_q, seg_k, cos, sin)
            rout, rlse = fa.flash_fwd_stream(*args, False, dh)
            rdq, rdelta = fa.flash_dq_stream(*args, *row(out, lse, do), None, False, dh)
            rdk, rdv = fa.flash_dkv_stream(*args, *row(lse, delta, do), False, dh)
            parts.append((rout, rlse, rdq, rdelta, rdk, rdv))
    rout, rlse, rdq, rdelta, rdk, rdv = (torch.cat(t) for t in zip(*parts))
    # the ids that take part: a query row that sees a key, a key that a query sees
    seen_q = torch.stack([torch.isin(a, b[b > 0]) for a, b in zip(seg_q, seg_k)]) & (seg_q > 0)
    seen_k = torch.stack([torch.isin(b, a[a > 0]) for a, b in zip(seg_q, seg_k)]) & (seg_k > 0)
    b, p = seg_q.shape
    shape = f"{tag}, all {b} rows, P={p}, the plain versions one row at a time"
    delta_err = (delta - rdelta).abs().max().item()
    print(f"flash_dq_stream[{shape}] max|delta-plain| {delta_err:.3e} (tol {DELTA_ATOL}); "
          f"{int((~seen_q).sum())} query rows see no key, {int((~seen_k).sum())} keys are seen "
          f"by no query; a second launch of #6, #7 and #8 bit for bit: {same}", flush=True)
    if not (delta_err <= DELTA_ATOL and same):
        fail(f"flash_fwd_stream/flash_dq_stream/flash_dkv_stream[{shape}]: delta or a relaunch "
             f"disagrees")
    fwd_err = check_flash_fwd(f"stream, {shape}", out, lse, rout, rlse, seen_q.int())
    dq_err, dq_rel = check_flash_bwd(shape, (dq,), (rdq,), seen_q.int(), "flash_dq_stream",
                                     ("dq",))
    dkv_err, dkv_rel = check_flash_bwd(shape, (dk, dv), (rdk, rdv), seen_k.int(),
                                       "flash_dkv_stream", ("dk", "dv"))
    return dict(fwd=fwd_err, dq=dq_err, dkv=dkv_err, rel=max(dq_rel, dkv_rel), delta=delta_err)


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
    the dispatch never gives it above P 2048: one body and one id array, it
    must give #6's bits. #6, #7 and #8 are held on all the rows too
    (check_stream_batch), with both kinds of key ids."""
    b, p = seg.shape
    qs, k, v, do = flash_tensors(seg, h, dh, seed=21)
    r = slice(0, check_rows)
    rows = lambda *ts: [None if t is None else t[r] for t in ts]  # noqa: E731
    errs = check_stream_rows(fa, ops, "long-context", *rows(qs, k, v, seg, seg, cos, sin, do), dh)
    swap = torch.arange(check_rows, device=seg.device).roll(1)
    other = check_stream_rows(fa, ops, "keys of another packed row",
                              *rows(qs, k, v, seg), seg[r][swap], *rows(cos, sin, do), dh)
    errs = {key: max(errs[key], other[key]) for key in errs}
    batch = [check_stream_batch(fa, ops, tag, qs, k, v, seg, seg_k, cos, sin, do, dh)
             for tag, seg_k in (("long-context", seg),
                                ("keys of another packed row", seg.roll(1, dims=0)))]
    for key in ("fwd", "dq", "dkv", "delta"):
        errs[key] = max([errs[key]] + [e[key] for e in batch])
    torch.cuda.empty_cache()

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
    diff = (out1.float() - out.float()).abs().max().item()
    same = torch.equal(out1, out) and torch.equal(lse1, lse)
    print(f"flash_fwd (#1's entry) on the long-context rows: max|out - flash_fwd_stream| "
          f"{diff:.3e}, max|lse - flash_fwd_stream| {(lse1 - lse).abs().max().item():.3e}; "
          f"bit for bit: {same}", flush=True)
    if not same:
        fail("kernel #1 and kernel #6 disagree on the long-context rows (one body, one id "
             "array: the same bits)")
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
                 f"{single_spread}), {bms / single_ms:.1%} of the bound") if kind == "fwd" else ""
        print(f"{name} B={b} P={p} H={h}: kernel {ms:.4f} ms (3 readings {ms_spread}), plain "
              f"{plain_ms:.4f} ms, {lib} {lib_ms:.4f} ms, bound {bms:.4f} ms ({by}: "
              f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP){extra}", flush=True)
        res[kind] = dict(ms=ms, plain_ms=plain_ms, lib_ms=lib_ms, bound_ms=bms, bound_by=by,
                         err=errs[kind])
    for kind in ("fwd", "dq", "dkv"):
        res[kind]["batch_err"] = max(e[kind] for e in batch)
    for kind in ("dq", "dkv"):
        res[kind]["batch_rel"] = max(e["rel"] for e in batch)
    res["fwd"]["single_ms"] = single_ms
    res["dq"]["delta_err"] = errs["delta"]
    return res


def long_config(out_dir: str, data_dir: str, *overrides: str):
    """configs/pcqm4m_v2_pretrain_long.yaml read by the port's load_config
    (GraphGPT-base: 768 x 12, 12 heads of 64, gated aggregation, bf16,
    save_attn, AdamW 0.9/0.95 with warmup_decay, pretrain-mlm with packing),
    at max_length 4096 without block-aligned packing, batch 16 (65,536
    tokens a step), on the store under data_dir through the pcqm4m-v2
    reader the config names; eight steps, 2 of warm-up, EMA on for the
    EMA-valid loss, 2,200 valid graphs (the first 512 evaluated), a
    generation sweep of 2 bands over 16 graphs in 16 steps. `overrides` go
    after these."""
    from graphgpt_torch.config import load_config

    return load_config(os.path.join(HERE, "configs", "pcqm4m_v2_pretrain_long.yaml"), [
        f"tokenization.data_dir={data_dir}", "model.max_position_embeddings=4096",
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


def long_context_phase(dev, counters, fa, mlp, ops, _build, rope_cos_sin, data_dir):
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
        pipe = PretrainPipeline(long_config(out_a, data_dir), device=dev).setup()
        mc, tc = pipe.cfg.model, pipe.cfg.training
        print(f"long-context setup {time.perf_counter() - t0:.1f} s: hidden {mc.hidden_size}, "
              f"{mc.num_hidden_layers} layers, {mc.num_attention_heads} heads, vocab "
              f"{mc.vocab_size}, mpe {mc.max_position_embeddings}, attn_block {mc.attn_block}, "
              f"remat {mc.remat_policy}, {mc.dtype}; {pipe.total_steps} steps, batch "
              f"{tc.batch_size} x {tc.max_length}, {tc.num_workers} loader workers, "
              f"{len(pipe.train_idx)} train and {len(pipe.valid_idx)} valid graphs", flush=True)
        if len(pipe.valid_idx) < 512 or mc.attn_block != 0 or tc.max_length != 4096:
            fail("the long-context config is not the one asked for")
        # the first batch, as run() draws it, from a pool started anew (setup
        # started one): the pool's time to its first batch
        idx0 = np.random.default_rng((tc.seed, 0)).permutation(pipe.train_idx)
        pipe.loader.close()
        t0 = time.perf_counter()
        nb = next(pipe.loader.epoch_batches(idx0, 0)).data
        first_s = time.perf_counter() - t0
        batch = to_torch(nb, dev)
        b, p = nb["segment_ids"].shape
        n_seg = int(sum(len(np.unique(r[r > 0])) for r in nb["segment_ids"]))
        # the loader alone, its worker pool warm
        t0 = time.perf_counter()
        n_graphs = n_tokens = 0
        for bb in pipe.loader.epoch_batches(idx0[: 3 * n_seg], epoch=3):
            n_graphs += sum(len(np.unique(r[r > 0])) for r in bb["segment_ids"])
            n_tokens += int((bb["segment_ids"] > 0).sum())
        loader_s = time.perf_counter() - t0
        loader_gs, loader_ts = n_graphs / loader_s, n_tokens / loader_s
        rss, rss_kind = worker_rss(pipe.loader)
        print(f"long-context batch: {b} x {p}, {int((nb['segment_ids'] > 0).sum())} tokens, "
              f"{n_seg} molecules of the pcqm4m-v2 reader's store (the pool's first batch in "
              f"{first_s:.2f} s, its start included); the loader alone {loader_gs:.0f} graphs/s, "
              f"{loader_ts:.0f} tokens/s with {tc.num_workers} workers walking in C++ (host "
              f"{host_cpu()}), their RSS ({rss_kind}) {max(rss, default=0):.0f} MiB each at "
              f"most ({sum(rss):.0f} in all)", flush=True)
        pos = reset_position_ids(batch["position_ids"], mc.rope_range)
        cos, sin = (t.to(torch.bfloat16) for t in rope_cos_sin(
            pos, mc.head_dim, mc.rope_theta, resonance=mc.rope_resonance,
            rope_scaling=mc.rope_scaling, max_position_embeddings=mc.max_position_embeddings))
        shape = stream_at_shape(fa, ops, _build, batch["segment_ids"], cos, sin,
                                mc.num_attention_heads, mc.head_dim)
        del cos, sin
        torch.cuda.empty_cache()
        model = pipe.state.model
        # the first step on 4 rows against an fp32 run of the plain versions
        rows4 = {k: v[:4] for k, v in batch.items()}
        # the band phase takes the same rows and ids
        shape["rows4"], shape["seg"] = rows4, batch["segment_ids"]
        shape["grad"] = step_vs_fp32(model, rows4, ops, "long-context")
        shape["grad_rel"] = shape["grad"]["e_kernel_max"]
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
        pipe_ts = float(np.mean(tok_s[1:]))  # steps 2-8, through the pipeline
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
              f"tokens/s; through the pipeline {pipe_ts:.0f} tokens/s (log.csv, steps 2-8); the "
              f"loader alone {loader_gs:.0f} graphs/s ({loader_ts:.0f} tokens/s), its pool's "
              f"first batch {first_s:.2f} s, worker RSS ({rss_kind}) {max(rss, default=0):.0f} "
              f"MiB; "
              f"max_memory_allocated {peak:.0f} MiB", flush=True)
        shape.update(step_ms=ms, tokens_per_s=tokens / ms * 1e3, peak_mib=peak,
                     pipeline_tokens_s=pipe_ts, loader_tokens_s=loader_ts,
                     worker_rss_mib=max(rss, default=0),
                     loader_graphs_s=loader_gs, loader_first_s=first_s, run_s=run_s,
                     losses=[round(x, 4) for x in losses], run_a_losses=losses)
        del pipe, model, batch
        torch.cuda.empty_cache()

        # auto-resume: the same output_dir, two steps more
        pipe = PretrainPipeline(long_config(out_a, data_dir, "training.schedule.total_num_steps=10",
                                            "training.gen_eval_bands=0"),
                                device=dev).setup()
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
        pipe = PretrainPipeline(long_config(out_b, data_dir, "training.pack_block=256",
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


# The loader alone in a fresh interpreter that never initialises CUDA: the
# long-context config's dataset (the pcqm4m-v2 reader over the store under
# data_dir), tokenizer and GraphTokenLoader (8 workers started with the given
# method, walking in C++ or, as the tests pin it, in numpy): 16 x 4096 packed
# rows, tokenized and collated, no device. The first batch's seconds with the
# pool's start, then graphs/s and tokens/s over the next four batches, and
# the largest worker's RSS (the peak where the kernel reports it). argv:
# checkout, method, data_dir, walk.
_LOADER_CHILD = r"""
import faulthandler, json, os, sys, tempfile, time
faulthandler.dump_traceback_later(150, exit=True)  # a stuck child shows where
import numpy as np
sys.path.insert(0, sys.argv[1])
from graphgpt_torch.config import load_config
from graphgpt_torch.data import euler
from graphgpt_torch.data.datasets import train_valid_split
from graphgpt_torch.data.loader import GraphTokenLoader
from graphgpt_torch.training.pipeline import build_dataset, build_tokenizer
from chip_smoke import worker_rss

cfg = load_config(os.path.join(sys.argv[1], "configs", "pcqm4m_v2_pretrain_long.yaml"), [
    f"tokenization.data_dir={sys.argv[3]}", "training.max_length=4096", "training.pack_block=0",
    "training.batch_size=16", f"training.output_dir={tempfile.mkdtemp()}"])
if sys.argv[4] == "numpy":
    euler._NATIVE_CHECKED, euler._NATIVE = True, None
t = cfg.training
ds = build_dataset(cfg)
print("dataset read", file=sys.stderr, flush=True)
tok = build_tokenizer(cfg, ds)
print("vocab scanned", file=sys.stderr, flush=True)
loader = GraphTokenLoader(ds, tok, batch_size=t.batch_size, mpe=t.max_length, pack=True,
                          num_workers=t.num_workers, seed=t.seed, pack_block=t.pack_block,
                          bucket=t.pad_to_multiple_of, start_method=sys.argv[2])
train_idx, _ = train_valid_split(len(ds), t.valid_percent, t.seed)
idx = np.random.default_rng((t.seed, 0)).permutation(train_idx)
print("pool starting", file=sys.stderr, flush=True)
t0 = time.perf_counter()
batches = loader.epoch_batches(idx, 0)
next(batches)
first_s = time.perf_counter() - t0
print("first batch", file=sys.stderr, flush=True)
t0, n, tokens = time.perf_counter(), 0, 0
for _ in range(4):
    seg = next(batches).data["segment_ids"]
    n += sum(len(np.unique(r[r > 0])) for r in seg)
    tokens += int((seg > 0).sum())
s = time.perf_counter() - t0
rss, kind = worker_rss(loader)
loader.close()
print("closed", file=sys.stderr, flush=True)
print(json.dumps({"first_s": first_s, "graphs_s": n / s, "tokens_s": tokens / s,
                  "workers": t.num_workers, "rss_mib": max(rss), "rss_kind": kind,
                  "walk": sys.argv[4]}), flush=True)
"""


def loader_start_methods(data_dir: str):
    """The long-context loader alone in a child process that never
    initialises CUDA, over the store: its workers spawned and forked,
    walking in C++, then spawned walking in numpy, back to back on this
    host: the first batch's seconds (the pool's start included), the warm
    graphs/s and tokens/s, the largest worker's RSS."""
    res = {}
    for method, walk in (("spawn", "cpp"), ("fork", "cpp"), ("spawn", "numpy")):
        # its own session, so that a timeout ends its pool's workers too;
        # its stderr in a file, which the workers may hold open after it
        with tempfile.TemporaryFile("w+") as err:
            proc = subprocess.Popen([sys.executable, "-c", _LOADER_CHILD, HERE, method, data_dir,
                                     walk], stdout=subprocess.PIPE, stderr=err, text=True,
                                    start_new_session=True)
            try:
                out, _ = proc.communicate(timeout=200)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, 9)
                out, _ = proc.communicate()
            err.seek(0)
            if proc.returncode != 0:
                fail(f"the loader child ({method}, {walk} walk) failed:\n{err.read()[-6000:]}")
        res[f"{method}_{walk}"] = json.loads(out.strip().splitlines()[-1])
    print(f"long-context loader alone (16 x 4096 packed rows, tokenized and collated, no "
          f"device), one host ({host_cpu()}), a child process without CUDA: "
          + "; ".join(f"{m.split('_')[0]}ed workers, {r['walk']} walk: first batch "
                      f"{r['first_s']:.2f} s, then {r['graphs_s']:.0f} graphs/s, "
                      f"{r['tokens_s']:.0f} tokens/s with {r['workers']} workers (RSS, "
                      f"{r['rss_kind']}, {r['rss_mib']:.0f} MiB a worker at most)"
                      for m, r in res.items()),
          flush=True)
    return res


def step_vs_fp32(model, batch, ops, tag, call=dict):
    """The first training step on `batch` three times: with the kernels in
    bf16, with the plain versions in bf16, and with the plain versions in
    fp32 (the compute dtype fp32, the same fp32 weights). The loss with
    kernels is held to LOSS_ATOL against the plain bf16 run, and to
    |loss_k - loss_32| <= STEP32_K |loss_p - loss_32| + STEP32_F; each
    gradient to e_kernel <= STEP32_K * e_plain + STEP32_F, both relative
    Frobenius errors against the fp32 run. `call()` gives the model call's other
    keyword arguments, made afresh for each run (the same dropout masks).
    Returns the readings."""
    cfgs = list({id(m.cfg): m.cfg for m in model.modules() if hasattr(m, "cfg")}.values())
    loss_k, gk = grads_of(model, batch, call)
    torch.cuda.reset_peak_memory_stats()
    with ops.reference_mode():
        loss_p, gp = grads_of(model, batch, call)
        saved = [c.dtype for c in cfgs]
        for c in cfgs:
            c.dtype = "float32"
        try:
            loss_32, g32 = grads_of(model, batch, call)
        finally:
            for c, dt in zip(cfgs, saved):
                c.dtype = dt
    peak = torch.cuda.max_memory_allocated() / 2**20
    ek = {n: rel_err(gk[n], g32[n]) for n in g32}
    ep = {n: rel_err(gp[n], g32[n]) for n in g32}
    limit = {n: STEP32_K * ep[n] + STEP32_F for n in ek}
    worst = max(ek, key=lambda n: ek[n] / limit[n])
    top_k, top_p = max(ek, key=ek.get), max(ep, key=ep.get)
    lk, lp = abs(loss_k - loss_32), abs(loss_p - loss_32)
    loss_ratio = lk / (STEP32_K * lp + STEP32_F)
    rows = batch["input_ids"].shape[0]
    print(
        f"{tag} step vs an fp32 plain run ({rows} rows): loss kernels {loss_k:.6f}, plain bf16 "
        f"{loss_p:.6f} (|diff| {abs(loss_k - loss_p):.3e}, tol {LOSS_ATOL}), plain fp32 "
        f"{loss_32:.6f} (|kernels - fp32| {lk:.3e}, |plain - fp32| {lp:.3e}, "
        f"{loss_ratio:.3f} of the rule's limit); {len(ek)} gradients, worst e_kernel / ({STEP32_K} e_plain + "
        f"{STEP32_F}) {ek[worst] / limit[worst]:.3f} at {worst} (e_kernel {ek[worst]:.3e}, "
        f"e_plain {ep[worst]:.3e}); e_kernel median {float(np.median(list(ek.values()))):.3e}, "
        f"max {ek[top_k]:.3e} at {top_k}; e_plain median "
        f"{float(np.median(list(ep.values()))):.3e}, max {ep[top_p]:.3e} at {top_p}; the plain "
        f"runs' max_memory_allocated {peak:.0f} MiB",
        flush=True,
    )
    if not (set(gk) == set(gp) == set(g32) == {k for k, _ in model.named_parameters()}
            and abs(loss_k - loss_p) <= LOSS_ATOL and loss_ratio <= 1
            and ek[worst] <= limit[worst]
            and all(bool(torch.isfinite(g).all()) for g in gk.values())):
        fail(f"the {tag} step with kernels is further from the fp32 run than the rule allows")
    return dict(e_kernel_max=ek[top_k], e_plain_max=ep[top_p], ratio=ek[worst] / limit[worst],
                worst=worst, loss_diff=abs(loss_k - loss_p), loss_err_kernel=lk,
                loss_err_plain=lp, loss_ratio=loss_ratio)


# per kernel: the products a (query, visible key) pair costs, the bf16
# token-major tensors read or written, the fp32 [B, H, P] rows read or
# written; no cos, sin (the band kernels take q and k rotated)
_BAND_WORK = {"fwd": (2, 4, 1), "bwd": (5, 8, 2)}


def band_work(fa, seg, seg_k, causal: bool, h: int, dh: int, kind: str, bi: int = 0):
    """(bytes, operations) of flash_fwd_band ("fwd": q, k, v read, out
    written, lse) or flash_bwd_band ("bwd": q, k, v, do, out read, dq, dk,
    dv written, lse read, delta written; the products S, dP, dv, dq, dk),
    with both id arrays, over the pairs this mask lets through."""
    b, p = seg.shape
    products, tensors, rows = _BAND_WORK[kind]
    pairs = int(fa._valid_mask(seg, causal, bi, seg_k).sum().item())
    nbytes = tensors * b * p * h * dh * 2 + 2 * b * p * 4 + rows * b * h * p * 4
    return nbytes, 2.0 * products * dh * h * pairs


def band_non_finite_check(fa, qs, k, v, seg, seg_k, out, lse, do, causal, dh, bi, shape):
    """flash_bwd_band, untimed, with inf and NaN written into do's padded
    rows: every bit of dq, dk and dv must stay as with zeros there."""
    pad = (seg == 0)[..., None].expand_as(do)
    if not bool(pad.any()):
        fail("the non-finite check needs padded rows")
    clean = do.masked_fill(pad, 0.0)
    noisy = do.masked_fill(pad, float("nan"))
    noisy[-1].masked_fill_(pad[-1], float("inf"))
    runs = [fa.flash_bwd_band(qs, k, v, seg, seg_k, out, lse, d, None, causal, dh, bi)
            for d in (clean, noisy)]
    same = all(torch.equal(a, n) for a, n in zip(*runs))
    finite = all(bool(torch.isfinite(a.float()).all()) for a in runs[1])
    print(f"flash_bwd_band[{shape}] with inf and NaN in do's {int(pad[..., 0].sum())} padded "
          f"rows: every output bit the same {same}, finite {finite}", flush=True)
    if not (same and finite):
        fail(f"non-finite do in padded rows reached an output of flash_bwd_band ({shape})")


def band_at_shape(fa, ops, tag, seg, seg_k, h: int, dh: int, causal: bool = False,
                  bi: int = 0, timed: bool = False, non_finite: bool = False):
    """#9 flash_fwd_band and #10 flash_bwd_band on every row of seg [B, P]
    (key ids seg_k): #9's out and lse against its plain version on every
    row (8 rows at a time: a persistent kernel's schedule depends on B);
    #10's delta, dq, dk, dv against its plain version on every row, run one
    row at a time; both bit for bit against a relaunch; both band tables
    equal band_limits on every row; padded query rows, query rows that see
    no key, and keys that no query sees (padded or not) exactly 0 on every
    row. `non_finite`: #10 also with inf and NaN written into do's padded
    rows, which must change no output bit. `timed`: then each kernel, its
    plain version (the whole shape, once), SDPA with the boolean mask
    (forward; its backward for #10) and the legacy kernels at the same shape
    (#1 and #3 up to P 2048, #6 and #7 + #8 above), three CUDA-event
    readings each, beside the bound."""
    b, p = seg.shape
    qs, k, v, do = flash_tensors(seg, h, dh, seed=31)
    fwd_args = (qs, k, v, seg, seg_k, causal, dh, bi)
    aux = {}
    out, lse = fa.flash_fwd_band(*fwd_args, aux=aux)
    bwd_args = (qs, k, v, seg, seg_k, out, lse, do, None, causal, dh, bi)
    bux = {}
    dq, dk, dv = fa.flash_bwd_band(*bwd_args, aux=bux)
    again = fa.flash_fwd_band(*fwd_args)
    agux = {}
    again_bwd = fa.flash_bwd_band(*bwd_args, aux=agux)
    torch.cuda.synchronize()
    same = (torch.equal(again[0], out) and torch.equal(again[1], lse)
            and all(torch.equal(a, g) for a, g in zip(again_bwd, (dq, dk, dv)))
            and torch.equal(agux["delta"], bux["delta"]))
    del again, again_bwd, agux
    table_ok = (torch.equal(aux["table"], fa.band_limits(seg, seg_k))
                and torch.equal(bux["table_k"], fa.band_limits(seg_k, seg)))
    # the query rows that see a key and the keys that a query sees, a row at a time
    seen_q, seen_k = [], []
    for r in range(b):
        m = fa._valid_mask(seg[r : r + 1], causal, bi, seg_k[r : r + 1])[0, 0]
        seen_q.append(m.any(dim=1))
        seen_k.append(m.any(dim=0))
    seen_q, seen_k = torch.stack(seen_q), torch.stack(seen_k)
    valid = seg > 0
    pad_ok = (bool((out[~seen_q] == 0).all())
              and bool((lse.transpose(1, 2)[~seen_q] == -1e30).all())
              and bool((dq[~seen_q] == 0).all()) and bool((dk[~seen_k] == 0).all())
              and bool((dv[~seen_k] == 0).all()))
    shape = f"{tag}, B={b} P={p}" + (f" split {p - bi}" if bi else "")
    print(f"flash_fwd_band/flash_bwd_band[{shape}] band tables == band_limits on all {b} rows: "
          f"{table_ok}; padded query rows ({int((~valid).sum())}), query rows that see no key "
          f"({int((~seen_q & valid).sum())}) and keys that no query sees "
          f"({int((~seen_k).sum())}) exactly 0 on all rows: {pad_ok}; a second launch of #9 "
          f"and #10 bit for bit: {same}; both against their plain versions on all {b} rows",
          flush=True)
    if not (table_ok and pad_ok and same):
        fail(f"flash_fwd_band/flash_bwd_band[{shape}]: a band table, a row that takes no part "
             f"or a relaunch is wrong")
    rout, rlse = plain_in_row_chunks(ops, lambda *t: fa.flash_fwd_band(*t, causal, dh, bi),
                                     (qs, k, v, seg, seg_k))
    fwd_err = check_flash_fwd(f"band, {shape}", out, lse, rout, rlse, seen_q.int())
    del rout, rlse
    with ops.reference_mode():
        rdelta = fa.flash_delta(do, out, None, dh)
    rgrads = plain_in_row_chunks(ops, lambda *t: fa.flash_bwd_band(*t, None, causal, dh, bi),
                                 (qs, k, v, seg, seg_k, out, lse, do), rows=1)
    delta_err = (bux["delta"] - rdelta).abs().max().item()
    print(f"flash_bwd_band[{shape}] max|delta-plain| {delta_err:.3e} (tol {DELTA_ATOL}), the "
          f"plain versions one row at a time", flush=True)
    if not delta_err <= DELTA_ATOL:
        fail(f"flash_bwd_band[{shape}]'s delta disagrees with its plain version")
    dq_err, dq_rel = check_flash_bwd(shape, (dq,), rgrads[:1], seen_q.int(), "flash_bwd_band",
                                     ("dq",))
    dkv_err, dkv_rel = check_flash_bwd(shape, (dk, dv), rgrads[1:], seen_k.int(),
                                       "flash_bwd_band", ("dk", "dv"))
    err, rel = max(dq_err, dkv_err), max(dq_rel, dkv_rel)
    del rgrads, rdelta
    if non_finite:
        band_non_finite_check(fa, qs, k, v, seg, seg_k, out, lse, do, causal, dh, bi, shape)
    res = dict(fwd_err=fwd_err, err=err, rel=rel, delta_err=delta_err)
    if not timed:
        return res
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = fa._valid_mask(seg, causal, bi, seg_k)
    leaves = [t.view(b, p, h, dh).transpose(1, 2).detach().requires_grad_() for t in (qs, k, v)]
    lib_fwd = cuda_ms(lambda: sdpa(*leaves, attn_mask=mask, scale=1.0), iters=3)
    sd = sdpa(*leaves, attn_mask=mask, scale=1.0)
    do4 = do.view(b, p, h, dh).transpose(1, 2)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(sd, leaves, do4, retain_graph=True), iters=3)
    del sd, leaves, mask
    saved, fa._MODE = fa._MODE, "legacy"  # the legacy kernels at the same shape, no RoPE
    try:
        legacy_fwd = cuda_ms(lambda: fa.flash_fwd(qs, k, v, seg, None, None, causal, dh, bi),
                             iters=5)
        legacy_bwd = cuda_ms(lambda: fa.flash_bwd(qs, k, v, seg, None, None, out, lse, do, None,
                                                  causal, dh, bi), iters=5)
    finally:
        fa._MODE = saved
    legacy = ("#1", "#3") if p <= fa.MAX_P and not bi else (("#1", "#4 + #5") if p <= fa.MAX_P
                                                             else ("#6", "#7 + #8"))
    for kind, fn in (("fwd", lambda: fa.flash_fwd_band(*fwd_args)),
                     ("bwd", lambda: fa.flash_bwd_band(*bwd_args))):
        ms = cuda_ms(fn, iters=10)
        ms_spread = spread()
        with ops.reference_mode():
            plain_ms = cuda_ms(fn, iters=1, warmup=1)
        nbytes, flops = band_work(fa, seg, seg_k, causal, h, dh, kind, bi)
        bms, by = bound(nbytes, flops)
        lib_ms = lib_fwd if kind == "fwd" else lib_bwd
        leg_ms = legacy_fwd if kind == "fwd" else legacy_bwd
        name = "flash_fwd_band" if kind == "fwd" else "flash_bwd_band"
        lib = "SDPA" if kind == "fwd" else "SDPA backward (dq, dk, dv)"
        print(f"{name} {shape} H={h}: kernel {ms:.4f} ms (3 readings {ms_spread}), plain "
              f"{plain_ms:.4f} ms, {lib} {lib_ms:.4f} ms, legacy kernel "
              f"{legacy[0 if kind == 'fwd' else 1]} {leg_ms:.4f} ms, bound {bms:.4f} ms ({by}: "
              f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP)", flush=True)
        res[kind] = dict(ms=ms, plain_ms=plain_ms, lib_ms=lib_ms, legacy_ms=leg_ms,
                         bound_ms=bms, bound_by=by)
    return res


def qkv_inputs(dev, n: int, d: int, widths, seed: int = 8):
    """x [n, d] bf16 at unit normal, wn fp32 near 1, weights bf16 at 0.02."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    wn = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
    ws = [(torch.randn(w, d, generator=gen, device=dev) * 0.02).to(torch.bfloat16)
          for w in widths]
    x = torch.randn(n, d, generator=gen, device=dev).to(torch.bfloat16)
    return x, wn, ws


def check_norm_qkv(mlp, ops, tag, args):
    """#12 against its plain version on args; returns (outputs, largest
    elementwise error)."""
    got = mlp.norm_qkv(*args)
    torch.cuda.synchronize()
    with ops.reference_mode():
        want = mlp.norm_qkv(*args)
    err = max(check_mlp("norm_qkv", f"{tag}, {name}", g, r) for name, g, r in zip("qkv", got, want))
    return got, err


def norm_qkv_contract(dev, mlp, ops):
    """#12 outside the flagship's shape, untimed: GQA widths 768/256/256
    at N 65,536, a ragged N 65,537 (the last 128-row tile one row deep), D
    1600 (the widest hidden size; 64-wide tiles) at N 4,096; returns the
    largest error."""
    err = 0.0
    for n, d, widths in ((65536, 768, (768, 256, 256)), (65537, 768, (768,) * 3),
                         (4096, 1600, (1600,) * 3)):
        x, wn, ws = qkv_inputs(dev, n, d, widths, seed=n)
        tag = f"N={n} D={d} widths {'/'.join(map(str, widths))} (tile {mlp.qkv_block_n(widths)})"
        got, e = check_norm_qkv(mlp, ops, tag, (x, wn, *ws, 1e-6))
        err = max(err, e)
        del got, x, ws
    return err


def norm_qkv_at_shape(dev, mlp, ops, n: int, tag: str, contract: bool = False):
    """#12 norm_qkv (D 768, q, k, v 768 wide, weights at 0.02) against its
    plain version on N rows, and bit for bit against a second launch; then
    its time (three CUDA-event readings) beside the plain version's, the
    library call's (F.rms_norm with a bf16 weight, then one torch.matmul
    against [wq|wk|wv]) and the bound, and its rrms pre-pass timed alone.
    With `contract`, norm_qkv_contract too."""
    d, w = 768, 768
    x, wn, ws = qkv_inputs(dev, n, d, (w, w, w))
    args = (x, wn, *ws, 1e-6)
    got, err = check_norm_qkv(mlp, ops, f"{tag}, N={n}", args)
    again = mlp.norm_qkv(*args)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    print(f"norm_qkv[{tag}] N={n}: a second launch on the same inputs is bit-equal: {same}",
          flush=True)
    if not same:
        fail(f"norm_qkv[{tag}] differs from launch to launch")
    del got, again
    if contract:
        err = max(err, norm_qkv_contract(dev, mlp, ops))
    ms = cuda_ms(lambda: mlp.norm_qkv(*args), iters=10)
    ms_spread = spread()
    # the host's time to issue one call (the wrapper, the tensor maps, two
    # launches): when it exceeds the card's, the events above time the host
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        mlp.norm_qkv(*args)
    host_ms = (time.perf_counter() - t0) / 50 * 1e3
    torch.cuda.synchronize()
    with ops.reference_mode():
        plain_ms = cuda_ms(lambda: mlp.norm_qkv(*args), iters=3)
    wcat, wn16 = torch.cat(ws).t(), wn.to(torch.bfloat16)
    lib_ms = cuda_ms(lambda: torch.matmul(torch.nn.functional.rms_norm(x, (d,), wn16, 1e-6),
                                          wcat), iters=10)
    flops = 2.0 * n * d * 3 * w
    nbytes = n * d * 2 + d * 4 + 3 * w * d * 2 + 3 * n * w * 2
    bms, by = bound(nbytes, flops)
    print(f"norm_qkv[{tag}] N={n} D={d} widths 3 x {w}: kernel {ms:.4f} ms (3 readings "
          f"{ms_spread}; {flops / ms / 1e9:.1f} TFLOP/s, {bms / ms:.1%} of the bound; the host "
          f"issues a call in {host_ms:.4f} ms), plain "
          f"{plain_ms:.4f} ms, F.rms_norm + one matmul {lib_ms:.4f} ms, "
          f"bound {bms:.4f} ms ({by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP)", flush=True)
    # the rrms pre-pass alone, through its own C entry
    rr_fn = mlp._build.entry("norm_qkv", "ggt_norm_qkv_rrms", [ctypes.c_void_p] * 2
                             + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p])
    rr = torch.empty(n, dtype=torch.float32, device=dev)
    stream = mlp._build.stream_ptr(dev)

    def prepass():
        mlp._build.check(rr_fn(mlp._build.ptr(x), mlp._build.ptr(rr), n, d, 1e-6, stream),
                         "norm_qkv rrms pre-pass")

    prepass()
    x32 = x.float()
    rr_rel = ((rr - torch.rsqrt(x32.pow(2).mean(-1) + 1e-6)).abs().max()
              / torch.rsqrt(x32.pow(2).mean(-1) + 1e-6).abs().max()).item()
    rr_ms = cuda_ms(prepass, iters=20)
    rr_bound = (n * d * 2 + n * 4) / PEAK_BYTES * 1e3
    print(f"norm_qkv rrms pre-pass[{tag}] N={n} D={d}: {rr_ms:.4f} ms (3 readings {spread()}; "
          f"{rr_ms / ms:.1%} of the kernel's time), bound {rr_bound:.4f} ms (bytes); "
          f"max|rrms-plain|/max|plain| {rr_rel:.2e} (tol {RRMS_REL})", flush=True)
    if not rr_rel <= RRMS_REL:
        fail(f"norm_qkv's rrms pre-pass[{tag}] disagrees with the plain statistics")
    return dict(err=err, ms=ms, plain_ms=plain_ms, lib_ms=lib_ms, bound_ms=bms, bound_by=by,
                tflops=flops / ms / 1e9, bound_share=bms / ms, rrms_ms=rr_ms, host_ms=host_ms)


def skip_check(dev, fa, ops, synthetic, rope_cos_sin):
    """GGT_FLASH_MODE=skip: flash_attention forward and backward at B 8 x
    P 1024 with RoPE (rotated outside the kernels) launch #6, #7 and #8
    once each, and agree with the same call on the plain versions."""
    b, p, h, dh = 8, 1024, 12, 64
    seg = torch.from_numpy(synthetic.packed_segments(b, p, np.random.default_rng(9))).to(dev)
    gen = torch.Generator(device=dev).manual_seed(9)
    q, k, v, do = ((torch.randn(b, p, h, dh, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
                   for _ in range(4))
    rope = rope_cos_sin(torch.arange(p, device=dev).expand(b, p), dh)
    counters = (fa.flash_fwd_stream, fa.flash_dq_stream, fa.flash_dkv_stream, fa.flash_fwd,
                fa.flash_bwd, fa.flash_fwd_band)

    def run():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out, lse = fa.flash_attention(*leaves, seg, rope=rope, return_lse=True)
        out.backward(do)
        return out.view(b, p, h * dh), lse, [t.grad.view(b, p, h * dh) for t in leaves]

    saved, fa._MODE = fa._MODE, "skip"
    try:
        before = [c.launches for c in counters]
        out, lse, grads = run()
        torch.cuda.synchronize()
        got = [c.launches - n for c, n in zip(counters, before)]
        with ops.reference_mode():
            rout, rlse, rgrads = run()
    finally:
        fa._MODE = saved
    print(f"skip mode, B={b} P={p}: launches #6 {got[0]}, #7 {got[1]}, #8 {got[2]}, #1 {got[3]}, "
          f"#3 {got[4]}, #9 {got[5]} (want 1, 1, 1, 0, 0, 0)", flush=True)
    if got != [1, 1, 1, 0, 0, 0]:
        fail(f"skip mode launched {got}")
    check_flash_fwd(f"skip mode, B={b} P={p}", out, lse, rout, rlse, seg)
    check_flash_bwd(f"skip mode, B={b} P={p}", grads, rgrads, seg, "flash_attention (skip)")


def band_kernel_phase(dev, fa, mlp, ops, synthetic, long_seg):
    """#9 and #10 at the shapes of their paths, #12 at N 8,192 and 65,536
    (see the module docstring, 11). long_seg: the long-context batch's ids."""
    h, dh = 12, 64
    rng = np.random.default_rng(12)

    def packed(b, p, tail=0):
        seg_np = synthetic.packed_segments(b, p, rng)
        if tail:
            seg_np[-1, p - tail :] = 0
        return torch.from_numpy(seg_np).to(dev)

    res = {}
    seg8 = packed(8, 1024, 40)
    res["serving"] = band_at_shape(fa, ops, "serving", seg8, seg8, h, dh, timed=True,
                                   non_finite=True)
    res["causal"] = band_at_shape(fa, ops, "serving, causal", seg8, seg8, h, dh, causal=True,
                                  non_finite=True)
    other = seg8.roll(1, 0)  # another packed row's ids as the key ids
    res["other"] = band_at_shape(fa, ops, "keys of another packed row", seg8, other, h, dh)
    seg64 = packed(64, 1024, 40)
    res["train"] = band_at_shape(fa, ops, "train shape", seg64, seg64, h, dh, timed=True)
    del seg64
    res["long"] = band_at_shape(fa, ops, "long-context batch", long_seg, long_seg, h, dh,
                                timed=True)
    dn = torch.from_numpy(synthetic.mol3d_batch(256, 88, seed=0, bi_split=16)["segment_ids"])
    dn = dn.to(dev)
    res["denoise"] = band_at_shape(fa, ops, "denoise batch, bi-causal", dn, dn, h, dh, bi=16)
    torch.cuda.empty_cache()
    res["qkv_serving"] = norm_qkv_at_shape(dev, mlp, ops, 8192, "serving shape")
    res["qkv_train"] = norm_qkv_at_shape(dev, mlp, ops, 65536, "train shape", contract=True)
    return res


@contextlib.contextmanager
def knobs(fa, mode: str, fuse: str):
    """GGT_FLASH_MODE's attribute and GGT_ATTN_NORM_FUSE set inside the
    block, both put back after it."""
    saved = fa._MODE, os.environ.get("GGT_ATTN_NORM_FUSE")
    fa._MODE, os.environ["GGT_ATTN_NORM_FUSE"] = mode, fuse
    try:
        yield
    finally:
        fa._MODE = saved[0]
        if saved[1] is None:
            os.environ.pop("GGT_ATTN_NORM_FUSE", None)
        else:
            os.environ["GGT_ATTN_NORM_FUSE"] = saved[1]


def band_want(counters, L: int, train: bool):
    """The predicted launches under both knobs: a training step 12
    flash_fwd_band (the save_attn recompute reads the stash), 12
    flash_bwd_band, 24 norm_qkv (the forward and the recompute), 12
    norm_mlp, 13 rmsnorm_bwd (norm_qkv's adjoint and the final norm); an
    eval forward 12 each of flash_fwd_band, norm_qkv, norm_mlp."""
    want = {k: 0 for k in counters}
    if train:
        want.update(flash_fwd_band=L, flash_bwd_band=L, norm_qkv=2 * L, norm_mlp=L,
                    rmsnorm_bwd=L + 1)
    else:
        want.update(flash_fwd_band=L, norm_qkv=L, norm_mlp=L)
    return want


def band_train_phase(dev, counters, fa, ops, synthetic, nb, steps: int = 4):
    """GraphGPT-base's SMTP training step at the train phase's B 64 x P 1024
    batch under both knobs: the first step against the plain run and
    against the legacy kernel path (the same function), then `steps`
    counted AdamW + EMA steps."""
    from graphgpt_torch.config import OptimizerConfig, flagship_config
    from graphgpt_torch.models.heads import GraphGPTPretrain
    from graphgpt_torch.training.optimizer import make_optimizer, make_schedule
    from graphgpt_torch.training.steps import init_train_state, make_train_step

    cfg = flagship_config()
    model = GraphGPTPretrain(cfg, device=dev, seed=0)
    batch = synthetic.to_torch(nb, dev)
    grad_rel = step_vs_plain(model, batch, ops, "band + norm-fused train", LOSS_ATOL, GRAD_REL)
    loss_b, gb = grads_of(model, batch)
    with knobs(fa, "legacy", "0"):
        loss_l, gl = grads_of(model, batch)
    rels = {n: rel_err(gb[n], gl[n]) for n in gl}
    worst = max(rels, key=rels.get)
    print(f"band + norm-fused train step vs the legacy kernel path (#1, #3, the pre-norm and three "
          f"products; {batch['input_ids'].shape[0]} rows): loss {loss_b:.6f} vs {loss_l:.6f} "
          f"(|diff| {abs(loss_b - loss_l):.3e}, tol {LOSS_ATOL}); {len(rels)} gradients, worst "
          f"{rels[worst]:.3e} at {worst} (tol {GRAD_REL}), median "
          f"{float(np.median(list(rels.values()))):.3e}", flush=True)
    if set(gb) != set(gl) or abs(loss_b - loss_l) > LOSS_ATOL or rels[worst] > GRAD_REL:
        fail("the band + norm-fused train step disagrees with the legacy kernel path")
    del gb, gl
    torch.cuda.empty_cache()
    opt_cfg = OptimizerConfig(lr=3e-4, use_ema=True)
    schedule = make_schedule(opt_cfg, 20, 2)
    tx = make_optimizer(opt_cfg, 20, 2, schedule=schedule)
    state = init_train_state(model, tx, use_ema=True)
    want = band_want(counters, cfg.num_hidden_layers, train=True)
    step_fn = make_train_step(tx, opt_cfg, schedule)
    state, metrics, launches, ms, peak = counted_steps(
        "band + norm-fused training", state, step_fn, batch, counters, want, steps, timed_from=1)
    losses = [float(m["loss"]) for m in metrics]
    valid = int((nb["segment_ids"] > 0).sum())
    print(f"band + norm-fused train: losses " + " ".join(f"{x:.4f}" for x in losses)
          + f"; launches per step {want}; {ms:.2f} ms/step (CUDA events over steps 2-{steps}), "
          f"{valid / ms * 1e3:.0f} trained tokens/s, max_memory_allocated {peak:.0f} MiB",
          flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"the band + norm-fused training losses are not finite or did not fall: {losses}")
    alt = alternate_routes(fa, state, step_fn, batch)
    del model, state
    return launches, dict(grad_rel=grad_rel, legacy_rel=rels[worst], step_ms=ms,
                          tokens_per_s=valid / ms * 1e3, peak_mib=peak, **alt)


def alternate_routes(fa, state, step_fn, batch, pairs: int = STEP_PAIRS):
    """The training step under both knobs against the legacy route's on the
    same model and batch, in pairs that alternate their order (knob first,
    then legacy first), queued back to back with a CUDA event between two
    steps; after one untimed step of each. Prints and returns each route's
    median and the median and range of the paired gaps (knob - legacy)."""
    routes = {"knob": ("band", "1"), "legacy": ("legacy", "0")}
    order = [r for i in range(pairs) for r in (("knob", "legacy") if i % 2 == 0
                                              else ("legacy", "knob"))]
    for route in routes:
        with knobs(fa, *routes[route]):
            state, _ = step_fn(state, batch, seed=0)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(len(order) + 1)]
    events[0].record()
    for route, end in zip(order, events[1:]):
        with knobs(fa, *routes[route]):
            state, _ = step_fn(state, batch, seed=0)
        end.record()
    torch.cuda.synchronize()
    times = {r: [] for r in routes}
    for route, a, b in zip(order, events, events[1:]):
        times[route].append(a.elapsed_time(b))
    gaps = sorted(k - g for k, g in zip(times["knob"], times["legacy"]))
    res = dict(alt_knob_ms=float(np.median(times["knob"])),
               alt_legacy_ms=float(np.median(times["legacy"])),
               alt_gap_ms=float(np.median(gaps)), alt_gap_min_ms=gaps[0], alt_gap_max_ms=gaps[-1])
    print(f"band + norm-fused vs legacy train step, {pairs} alternating pairs on the same model and "
          f"batch: knob {res['alt_knob_ms']:.2f} ms (readings "
          + " ".join(f"{x:.2f}" for x in times["knob"]) + f"), legacy {res['alt_legacy_ms']:.2f} ms "
          f"(readings " + " ".join(f"{x:.2f}" for x in times["legacy"]) + f"); paired gap knob - "
          f"legacy median {res['alt_gap_ms']:.2f} ms, range {gaps[0]:.2f} to {gaps[-1]:.2f}",
          flush=True)
    res.update(route_profiles(fa, state, step_fn, batch, routes))
    return res


def route_profiles(fa, state, step_fn, batch, routes, top: int = 14):
    """One more step of each route under torch.profiler: each route's device
    time in kernels, and the kernels (by name) whose time differs most
    between the routes, so that the step gap can be placed."""
    from torch.profiler import ProfilerActivity, profile

    per = {}
    for route, kv in routes.items():
        with knobs(fa, *kv):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                state, _ = step_fn(state, batch, seed=0)
                torch.cuda.synchronize()
        per[route] = {}
        for e in prof.key_averages():
            if e.device_time_total > 0:
                per[route][e.key] = per[route].get(e.key, 0.0) + e.device_time_total / 1e3
    a, b = routes
    totals = {r: sum(v.values()) for r, v in per.items()}
    print(f"{a} and {b} steps by kernel (torch.profiler, one step each): device time in kernels "
          + ", ".join(f"{r} {t:.2f} ms" for r, t in totals.items())
          + f"; the {top} largest differences ({a} - {b}, ms):", flush=True)
    diff = {k: per[a].get(k, 0.0) - per[b].get(k, 0.0) for k in set(per[a]) | set(per[b])}
    for k in sorted(diff, key=lambda k: -abs(diff[k]))[:top]:
        print(f"  {diff[k]:+8.3f}  ({a} {per[a].get(k, 0.0):7.3f}, {b} {per[b].get(k, 0.0):7.3f})"
              f"  {k[:100]}", flush=True)
    return {f"prof_{r}_kernel_ms": t for r, t in totals.items()}


def band_long_phase(dev, counters, rows4, run_a_losses, ops, data_dir):
    """Long-context pretraining through PretrainPipeline under both knobs:
    run A's config (P 4096, pack_block 0, batch 16, the pcqm4m-v2 reader,
    EMA, 512 valid graphs, 2 generation bands of 16) and schedule, cut to 4 steps and
    their save point. The first step on the long-context batch's 4 rows
    against an fp32 run; launches per step, per eval and generation
    forward; losses finite, falling and each within BAND_LOSS_ATOL of run
    A's; log.csv, result.csv and the checkpoint at step 4."""
    from graphgpt_torch.training.checkpoint import Checkpointer
    from graphgpt_torch.training.pipeline import PretrainPipeline

    launches = {k: 0 for k in counters}
    with tempfile.TemporaryDirectory() as tmp:
        out_c = os.path.join(tmp, "run_band")
        t0 = time.perf_counter()
        pipe = PretrainPipeline(long_config(out_c, data_dir), device=dev).setup()
        setup_s = time.perf_counter() - t0
        model = pipe.state.model
        L = pipe.cfg.model.num_hidden_layers
        grad = step_vs_fp32(model, rows4, ops, "long-context band + norm-fused")
        torch.cuda.empty_cache()
        want, want_eval = band_want(counters, L, True), band_want(counters, L, False)
        train_log, eval_log, metrics = counted_pipeline(pipe, counters)
        gen_log = []
        model.logits = count_per_call(model.logits, counters, gen_log)
        torch.cuda.reset_peak_memory_stats()
        before = {k: fn.launches for k, fn in counters.items()}
        t0 = time.perf_counter()
        pipe.run(max_steps=4)
        run_s = time.perf_counter() - t0
        for k, fn in counters.items():
            launches[k] += fn.launches - before[k]
        peak = torch.cuda.max_memory_allocated() / 2**20
        check_logs("long-context band + norm-fused", train_log, eval_log, want, want_eval, 4)
        for i, got in enumerate(gen_log):
            if got != want_eval:
                fail(f"the band run's generation forward {i} launched {got}, expected {want_eval}")
        losses = [float(m["loss"]) for m in metrics]
        diffs = [abs(x - y) for x, y in zip(losses, run_a_losses)]
        log = csv_rows(os.path.join(out_c, "log.csv"))
        res = csv_rows(os.path.join(out_c, "result.csv"))
        gen_keys = sorted(k for k in res[-1] if k.startswith("gen_acc"))
        print("long-context band + norm-fused: losses " + " ".join(f"{x:.4f}" for x in losses)
              + " against run A's " + " ".join(f"{x:.4f}" for x in run_a_losses[:4])
              + f" (max |diff| {max(diffs):.3e}, tol {BAND_LOSS_ATOL}); setup {setup_s:.1f} s, "
              f"run {run_s:.1f} s (4 steps, the save-point eval, EMA too, the generation sweep "
              f"of {len(gen_log)} forwards, a checkpoint); log.csv {len(log)} rows, tokens_per_s "
              + " ".join(f"{float(r['tokens_per_s']):.0f}" for r in log)
              + f"; result.csv {res[-1]}; max_memory_allocated {peak:.0f} MiB", flush=True)
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
                and max(diffs) <= BAND_LOSS_ATOL):
            fail(f"the band run's losses are not finite, did not fall or left run A's: {losses}")
        keys = ["valid_loss", "ema_valid_loss", *gen_keys]
        if len(log) != 4 or len(gen_keys) != 2 or not all(
                np.isfinite(float(res[-1][k])) for k in keys):
            fail("the band run's log.csv or result.csv lacks a row, a column or a finite value")
        if Checkpointer(os.path.join(out_c, "ckpt")).latest_step() != 4:
            fail("the band run left no checkpoint at step 4")
        del pipe, model
        torch.cuda.empty_cache()
    return launches, dict(grad=grad, losses=losses, loss_diff=max(diffs), run_s=run_s,
                          peak_mib=peak)


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
            if "registers" in line or "spill" in line or "Performance Loss" in line:
                print(f"  {name}: {line.strip()}", flush=True)
    # the wgmma kernels (#12; #2, #11; #4, #5, #7, #8; #1, #6, #9; #3, #10) keep
    # no spill and let ptxas pipeline their wgmma (no C7512/C7513), #13 keeps
    # no spill; flash_fwd.cu's log must show its three forms, flash_bwd.cu's
    # its two
    for name in ("norm_qkv", "norm_mlp", "mlp", "flash_bwd_split", "flash_fwd", "flash_bwd",
                 "rmsnorm_bwd"):
        if re.search(r"[1-9]\d* bytes spill|C751[0-9]", logs.get(name, "")):
            fail(f"ptxas spilled in {name}.cu or serialised its wgmma (see the build lines above)")
    for name, kernel, want in (("flash_fwd", "fwd_kernel", ["0", "1", "2"]),
                               ("flash_bwd", "fused_kernel", ["0", "2"])):
        forms = sorted(set(re.findall(kernel + r"ILi(\d)E", logs.get(name, ""))))
        print(f"{name}.cu: the forms ptxas compiled (0 single, 1 stream, 2 band): {forms}",
              flush=True)
        if forms != want:
            fail(f"{name}.cu's build log does not show its forms {want}")

    # ---- the graph-level store (PCQM4M-v2's schema), the C++ walk on it, and
    # the long-context loader alone on it, before this process starts a pool
    store_root = tempfile.mkdtemp(prefix="ggt_store_")
    atexit.register(shutil.rmtree, store_root, True)
    data_dir = os.path.join(store_root, "OGB")
    store_path, split_sizes = write_graph_store(data_dir)
    walks = walk_phase(store_path)
    loaders = loader_start_methods(data_dir)

    # ---- kernel phase
    fres = flash_phase(dev, fa, ops, synthetic, rope_cos_sin)
    mres = mlp_phase(dev, mlp, ops)
    bres = flash_bwd_phase(dev, fa, ops, synthetic, rope_cos_sin)
    rres = rms_bwd_phase(dev, mlp, ops, contract=True)
    sp = split_phase(dev, fa, ops, synthetic, rope_cos_sin)
    counters = {"flash_fwd": fa.flash_fwd, "flash_bwd": fa.flash_bwd,
                "norm_mlp": mlp.norm_mlp, "rmsnorm_bwd": mlp.rmsnorm_bwd, "mlp": mlp.mlp,
                "flash_dq": fa.flash_dq, "flash_dkv": fa.flash_dkv,
                "flash_fwd_stream": fa.flash_fwd_stream, "flash_dq_stream": fa.flash_dq_stream,
                "flash_dkv_stream": fa.flash_dkv_stream, "flash_fwd_band": fa.flash_fwd_band,
                "flash_bwd_band": fa.flash_bwd_band, "norm_qkv": mlp.norm_qkv}

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
    # ---- graph-level phase: pcqm4m_v2_supervised.yaml as shipped on the store
    torch.cuda.empty_cache()
    gft, gtune = graph_finetune_phase(model, counters, ops, data_dir, split_sizes)
    # ---- big-graph phases A-C: seeded stores in the ogbl-ppa and
    # ogbn-proteins schemas, their supervised configs warm-started from the
    # train phase's model, then the proteins pretrain config
    t0 = time.perf_counter()
    big, bigl = big_graph_phases(model, counters, fa, mlp, ops, data_dir)
    print(f"big-graph phases A-C: {time.perf_counter() - t0:.1f} s", flush=True)
    del model

    # ---- denoise and position-pretraining phases: fresh models
    torch.cuda.empty_cache()
    dn, den = denoise_phase(dev, counters, fa, mlp, ops, synthetic, rope_cos_sin)
    torch.cuda.empty_cache()
    posl, posr = pos_phase(dev, counters, fa, mlp, ops, synthetic, rope_cos_sin)
    torch.cuda.empty_cache()
    lc, lcl = long_context_phase(dev, counters, fa, mlp, ops, _build, rope_cos_sin, data_dir)

    # ---- band and norm-fused phase: both knobs on (GGT_FLASH_MODE=band,
    # GGT_ATTN_NORM_FUSE=1); the skip mode's check; then the training step
    # and the long-context pipeline, each counted from 0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with knobs(fa, "band", "1"):
        bk = band_kernel_phase(dev, fa, mlp, ops, synthetic, lc["seg"])
    skip_check(dev, fa, ops, synthetic, rope_cos_sin)
    with knobs(fa, "band", "1"):
        btl, btr = band_train_phase(dev, counters, fa, ops, synthetic, nb64)
        torch.cuda.empty_cache()
        bll, blr = band_long_phase(dev, counters, lc["rows4"], lc["run_a_losses"], ops,
                                   data_dir)
    print(f"band and norm-fused phase: {time.perf_counter() - t0:.1f} s", flush=True)
    launches = {k: serve[k] + train[k] + tune[k] + gtune[k] + den[k] + posl[k] + lcl[k] + btl[k]
                + bll[k] + sum(bigl[ph][k] for ph in bigl) for k in counters}

    base = "graphgpt_tpu/ops/"

    def entry(name, source, replaces, r, tol, **extra):
        return dict(
            name=name, route="cuda", source=f"graphgpt_torch/csrc/{source}",
            replaces=base + replaces, launches=launches[name], launches_serving=serve[name],
            launches_training=train[name], launches_finetune=tune[name],
            launches_graph_finetune=gtune[name],
            launches_denoise=den[name], launches_pos=posl[name], launches_long=lcl[name],
            launches_band_train=btl[name], launches_band_long=bll[name],
            launches_big_ppa=bigl["A"][name], launches_big_proteins=bigl["B"][name],
            launches_big_pretrain=bigl["C"][name], max_abs_err=r["err"],
            ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["lib_ms"], tol=tol, status="ok", **extra,
        )

    fb, bb = fres["bidirectional"], bres["bidirectional"]
    tr, ftf, ftr = bres["train"], ft["flash"], ft["rms"]
    psf, dnm, psm, dnr = posr["flash"], dn["norm_mlp"], posr["norm_mlp"], dn["rms"]

    def at(prefix, r, keys=("ms", "plain_ms", "bound_ms")):
        return {f"{prefix}_{k}": r[k] for k in keys}

    # the MLP kernels' numbers at each timed shape (mlp_timed; rrms_ms #2 only)
    MLP_KEYS = ("ms", "plain_ms", "lib_ms", "bound_ms", "bound_share", "gate_up_ms", "down_ms",
                "rrms_ms")

    kernels = [
        entry("flash_fwd", "flash_fwd.cu", "flash_attention.py:124",
              dict(fb, err=max([r["err"] for r in fres.values()]
                               + [tr["fwd_err"], ftf["fwd_err"], psf["fwd_err"],
                                  dn["fwd"]["err"], sp["fwd"]["err"]])),
              FLASH_TOL, bound_share=fb["bound_share"], causal_ms=fres["causal"]["ms"],
              causal_library_ms=fres["causal"]["lib_ms"],
              causal_bound_share=fres["causal"]["bound_share"],
              **{f"{tag}_shape_{k}": r[f"fwd_{k}"] for tag, r in (
                  ("train", tr), ("finetune", ftf), ("pos", psf))
                 for k in ("ms", "bound_ms", "lib_ms", "bound_share")},
              **{f"bicausal_{tag}_{k}": r["fwd"][k] for tag, r in (("denoise", dn), ("p1024", sp))
                 for k in ("ms", "plain_ms", "lib_ms", "bound_ms", "bound_share")},
              p4096_entry_ms=lc["fwd"]["single_ms"]),
        entry("norm_mlp", "norm_mlp.cu", "mlp.py:203",
              dict(mres, err=max(mres["err"], dnm["err"], psm["err"])), MLP_TOL,
              **{k: mres[k] for k in MLP_KEYS if k not in ("ms", "plain_ms", "lib_ms",
                                                          "bound_ms")},
              train_shape_library_ms=mres["train"]["lib_ms"],
              **at("train_shape", mres["train"], ("ms", "bound_ms") + MLP_KEYS[4:]),
              **at("denoise_shape", dnm, MLP_KEYS), **at("pos_shape", psm, MLP_KEYS),
              **{f"graph_finetune_{k}": v for k, v in gft.items()},
              **{f"walk_{k}": v for k, v in walks.items()}),
        entry("flash_bwd", "flash_bwd.cu", "flash_attention.py:706",
              dict(bb, err=max([r["err"] for r in bres.values()] + [ftf["err"], psf["err"]])),
              FLASH_BWD_TOL, bound_share=bb["bound_share"], causal_ms=bres["causal"]["ms"],
              causal_library_ms=bres["causal"]["lib_ms"],
              causal_bound_share=bres["causal"]["bound_share"],
              **{f"{tag}_shape_{k}": r[k] for tag, r in (
                  ("train", tr), ("finetune", ftf), ("pos", psf))
                 for k in ("ms", "bound_ms", "lib_ms", "bound_share")}),
        entry("rmsnorm_bwd", "rmsnorm_bwd.cu", "mlp.py:414",
              dict(rres, err=max(rres["err"], ftr["err"], dnr["err"])), RMS_BWD_TOL,
              main_ms=rres["main_ms"], reduce_ms=rres["reduce_ms"],
              **at("finetune_shape", ftr, ("ms", "bound_ms", "plain_ms", "lib_ms", "main_ms",
                                           "reduce_ms")),
              **at("denoise_shape", dnr, ("ms", "bound_ms", "plain_ms", "lib_ms", "main_ms",
                                          "reduce_ms"))),
        entry("mlp", "mlp.cu", "mlp.py:82", sres, MLP_TOL,
              **{k: sres[k] for k in ("bound_share", "gate_up_ms", "down_ms", "step_ms",
                                      "loader_graphs_s", "peak_mib")},
              **{k: v for k, v in sres.items() if k.startswith("finetune_shape_")}),
    ]
    # the big-graph phases: each kernel at phase A's (ogbl-ppa) and B's
    # (ogbn-proteins) batch shape, held to its plain version there; the
    # phases' own numbers beside the MLP kernel each runs (#2 A, #11 B and C)
    by_name = {e["name"]: e for e in kernels}
    for ph, tag, mlp_name in (("A", "ppa", "norm_mlp"), ("B", "proteins", "mlp")):
        r = big[ph]
        f = r["flash"]
        for name, vals, err in (
                ("flash_fwd", {k: f[f"fwd_{k}"] for k in ("ms", "bound_ms", "lib_ms")},
                 f["fwd_err"]),
                ("flash_bwd", {k: f[k] for k in ("ms", "bound_ms", "lib_ms")}, f["err"]),
                ("rmsnorm_bwd", {k: r["rms"][k] for k in ("ms", "plain_ms", "bound_ms",
                                                         "lib_ms")}, r["rms"]["err"]),
                (mlp_name, {k: r["mlp"][k] for k in ("ms", "plain_ms", "bound_ms", "lib_ms")},
                 r["mlp"]["err"])):
            e = by_name[name]
            e["max_abs_err"] = max(e["max_abs_err"], err)
            e.update({f"{tag}_shape_{k}": v for k, v in vals.items()}, **{f"{tag}_shape_n":
                                                                         r["n_rows"]})
        by_name[mlp_name].update({f"big_{tag}_{k}": v for k, v in r.items()
                                  if k not in ("flash", "rms", "mlp")})
    by_name["mlp"].update({f"big_pretrain_{k}": v for k, v in big["C"].items()})
    # the split pair: its main entry at the denoise batch's shape, B 256 x P 88
    edge = sp["edge"]
    for name, kind, line in (("flash_dq", "dq", 602), ("flash_dkv", "dkv", 789)):
        extra = {"delta_err": max(dn["dq"]["delta_err"], sp["dq"]["delta_err"],
                                  edge["delta_err"])} if kind == "dq" else {}
        kernels.append(entry(
            name, "flash_bwd_split.cu", f"flash_attention.py:{line}",
            dict(dn[kind], err=max(dn[kind]["err"], sp[kind]["err"], edge[f"{kind}_err"])),
            FLASH_BWD_TOL,
            rel_err=max(dn[kind]["rel"], sp[kind]["rel"], edge[f"{kind}_rel"]),
            bound_share=dn[kind]["bound_share"], denoise_step_ms=dn["step_ms"],
            denoise_peak_mib=dn["peak_mib"], denoise_grad_rel=dn["grad_rel"],
            **{f"p1024_{k}": sp[kind][k]
               for k in ("ms", "plain_ms", "lib_ms", "bound_ms", "bound_share")},
            **extra))
    # the streamed kernels: their main entry at the long-context shape, B 16 x P 4096
    for name, kind, line in (("flash_fwd_stream", "fwd", 177), ("flash_dq_stream", "dq", 645),
                             ("flash_dkv_stream", "dkv", 835)):
        extra = {"delta_err": lc["dq"]["delta_err"]} if kind == "dq" else {}
        # held on all 16 rows of the launch, both kinds of key ids
        extra["batch_max_abs_err"] = lc[kind]["batch_err"]
        if kind == "fwd":
            extra["single_block_kernel_ms"] = lc["fwd"]["single_ms"]
        else:
            extra["batch_rel_err"] = lc[kind]["batch_rel"]
        kernels.append(entry(
            name, "flash_fwd.cu" if kind == "fwd" else "flash_bwd_split.cu",
            f"flash_attention.py:{line}", lc[kind],
            FLASH_TOL if kind == "fwd" else FLASH_BWD_TOL, long_step_ms=lc["step_ms"],
            long_tokens_per_s=lc["tokens_per_s"], long_peak_mib=lc["peak_mib"],
            long_grad_rel=lc["grad_rel"], long_grad_ratio=lc["grad"]["ratio"],
            long_loader_graphs_s=lc["loader_graphs_s"], long_loader_first_s=lc["loader_first_s"],
            long_loader_tokens_s=lc["loader_tokens_s"],
            long_pipeline_tokens_s=lc["pipeline_tokens_s"], long_worker_rss_mib=lc["worker_rss_mib"],
            **{f"loader_{m}_{k}": r[k] for m, r in loaders.items()
               for k in ("first_s", "graphs_s", "tokens_s", "rss_mib")}, **extra))
    # the band kernels: their main entry at the train phase's B 64 x P 1024
    # (65,536 tokens); the serving and long-context shapes beside it
    shapes = ("serving", "causal", "other", "train", "long", "denoise")
    for name, kind, line in (("flash_fwd_band", "fwd", 282), ("flash_bwd_band", "bwd", 484)):
        err = max(bk[t]["fwd_err" if kind == "fwd" else "err"] for t in shapes)
        extra = {"delta_err": max(bk[t]["delta_err"] for t in shapes),
                 "rel_err": max(bk[t]["rel"] for t in shapes)} if kind == "bwd" else {}
        kernels.append(entry(
            name, "flash_fwd.cu" if kind == "fwd" else "flash_bwd.cu",
            f"flash_attention.py:{line}", dict(bk["train"][kind], err=err),
            FLASH_TOL if kind == "fwd" else FLASH_BWD_TOL,
            legacy_kernel_ms=bk["train"][kind]["legacy_ms"],
            **{f"{t}_{k}": bk[t][kind][k] for t in ("serving", "long")
               for k in ("ms", "plain_ms", "lib_ms", "legacy_ms", "bound_ms")},
            band_train_step_ms=btr["step_ms"], band_train_alt_step_ms=btr["alt_knob_ms"],
            legacy_train_alt_step_ms=btr["alt_legacy_ms"], band_train_alt_gap_ms=btr["alt_gap_ms"],
            band_train_grad_rel=btr["grad_rel"],
            band_train_legacy_rel=btr["legacy_rel"], band_long_loss_diff=blr["loss_diff"],
            band_long_grad_ratio=blr["grad"]["ratio"], **extra))
    qs_, qt_ = bk["qkv_serving"], bk["qkv_train"]
    kernels.append(entry(
        "norm_qkv", "norm_qkv.cu", "mlp.py:315", dict(qt_, err=max(qs_["err"], qt_["err"])),
        MLP_TOL, tflops=qt_["tflops"], bound_share=qt_["bound_share"], rrms_ms=qt_["rrms_ms"],
        host_ms=qt_["host_ms"],
        **at("serving_shape", qs_, ("ms", "plain_ms", "lib_ms", "bound_ms", "tflops",
                                    "bound_share", "rrms_ms", "host_ms"))))
    print(f"whole-model gradients, kernels vs plain: worst relative error {grad_rel:.3e} "
          f"(training), {dn['grad_rel']:.3e} (denoise), {posr['grad_rel']:.3e} (position "
          f"pretraining), {btr['grad_rel']:.3e} (band + norm-fused training); against an fp32 "
          f"run at P 4096, worst e_kernel / (K e_plain + F) {lc['grad']['ratio']:.3f} (streamed), "
          f"{blr['grad']['ratio']:.3f} (band + norm-fused); position-pretraining step "
          f"{posr['step_ms']:.2f} ms, peak "
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
