"""Where the time of the Hopper kernels goes: the split backward #4
flash_dq and #5 flash_dkv (`csrc/flash_bwd_split.cu`, the default), the
same body's stream form #7 flash_dq_stream and #8 flash_dkv_stream
(`--kernel stream`), the forward #1 and its stream and band forms #6
flash_fwd_stream and #9 flash_fwd_band (`--kernel fwd`,
`csrc/flash_fwd.cu`), the fused backward #3 and its band form #10
flash_bwd_band (`--kernel bwd`, `csrc/flash_bwd.cu`), the gated
MLPs #11 and #2 (`--kernel mlp`, `--kernel norm_mlp`: `csrc/mlp.cu`,
`csrc/norm_mlp.cu` with `csrc/mlp_common.cuh`) and the RMSNorm backward #13
(`--kernel rmsnorm_bwd`, `csrc/rmsnorm_bwd.cu`), and the fp32 forms #2f,
#11f and #12f (`--kernel mlp_f32`, `csrc/mlp_qkv_f32.cu`), #1f and #6f
(`--kernel fwd_f32`: `csrc/flash_bwd_split_f32.cu`'s forward role, beside
#9f, `csrc/flash_fwd_f32.cu`), #3f and #10f (`--kernel bwd_f32`,
`csrc/flash_bwd_f32.cu`) and the pair #4f, #5f and its stream form #7f,
#8f (`--kernel split_f32`, `csrc/flash_bwd_split_f32.cu`), timed
on the card whole
and with one phase of their body left out at a time, at their paths'
shapes: the denoise batch (B 256 x P 88, 16 bit slots, a molecule and a
padded stretch a row), the fine-tune batch (B 256 x P 72, a molecule a
row), B 8 and B 64 x P 1024 and the long-context batch B 16 x P 4096
(packed rows, the key ids the query ids; the band forms take the same q
and k, unrotated, and no cos, sin; bwd's band form at B 8 and 64 x P 1024
and B 16 x P 4096); the MLPs at N 8,192 and 65,536 rows (D 768, F 3,072,
gelu), whole and each stage alone; #13 at N 18,432, 22,528 and 65,536
(D 768), its row pass and its sum of the per-CTA dw rows alone; the fp32
MLP forms at N 8,192 and 18,432 (D 768, F 3,072) and N 1,024 (D 128, F
512, toy_pretrain's), #2f also at the denoise batch's N 22,528 and N
65,536 and each of its launches alone (the split pass, the rrms pre-pass,
gate/up, down), #12f there with q, k and v each D wide (the first rows of
the gate and up weights), the fp32 attention forms at B 8 x P 1024 (12 heads), B 8
x P 128 (2 heads, toy_pretrain's), the fine-tune batch B 256 x P 72 (a
molecule a row) and the long-context B 16 x P 4096,
where every form runs (#3f's and #9f's C entries take any P; #1f's, as
the pair's, P <= 2048), the fp32 pair and the fp32 forward also at the
denoise batch and at B 8 x
P 1024 with 16 bit slots, the fp32 pair's stream form also with another
row's ids as key ids at B 16 x P 4096 (their inputs drawn in fp32 by numpy
from a fixed
seed, so that a digest is the same from machine to machine for the same
bits; the band forms #9f and #10f take the same q and k, unrotated, and no
cos, sin).

A variant leaves a phase out by a text substitution in the source and is
built beside the package's own builds. Its outputs are wrong by design;
the time it saves is that phase's share:

  rope0    the RoPE of the in-place pass over each visiting stage (the pass
           warps still mark each stage ready)
  noglob   the own rows' segment ids and lse, loaded an item ahead (split)
  noepi    the epilogue's TMA stores
  noexp    the exponential (and, split and bwd, the mask) of the
           elementwise section
  nomask   the mask of the forward's online softmax (fwd)
  nocons   the consumers' products and softmax (fwd, bwd: what is left is
           the loads, the in-place pass, the barriers and the epilogue)
  nodelta  the delta launch before the main kernel (bwd)
  dqonly   the query role alone (bwd: no dk, dv)
  dkvonly  the key role alone (bwd: no dq)
  shfl     the walkers' tile ranges by tile_range's shuffles instead of
           redux.sync (fwd's single form, bwd; outputs right); stream: the
           masks and the visiting tiles' ranges from the ids by tile_range's
           shuffles (the single form's way) instead of the tile tables
           (outputs right, the key ids being the query ids)
  redux    fwd's stream form: the masks and the key tiles' ranges from the
           ids by redux.sync (the single form's way) instead of the tile
           tables (outputs right, the key ids being the query ids)
  stages2  a ring of 2 stages instead of 3 (fwd: of 4; bwd: both forms, the
           band form's of 8; fwd_f32: the forward role's 3) (outputs right)
  stages3  a ring of 3 stages instead of 4 (fwd; outputs right)
  stages4  bwd's band form: a ring of 4 stages instead of 8 (outputs right)
  stages6  bwd's band form: a ring of 6 stages instead of 8 (outputs right)
  all      rope0, noepi, noexp and noglob, nomask or nodelta together

and for the MLPs (the header's text is put in place of its include, then
substituted):

  nocons   the consumers' products (both stages; what is left is the loads,
           the norm, the barriers and the epilogues)
  nonorm   the norm of the register A operand (norm_mlp)
  noact    the activation of the gate/up epilogue (g = xg * xu)
  nores    the residual (norm_mlp: the down stage without its x tile)
  nopre    the rrms pre-pass (norm_mlp)
  bf16x2   the gate/up epilogue on bf16x2 pairs, a * xu by mul.rn.bf16x2 (the
           same bits)
  wnglobal wn read from global memory, not shared: four gate/up stages, not
           three (norm_mlp; the same bits)

and for the RMSNorm backward (a launch left out; the outputs of "main" lack
dw, those of "reduce" are stale):

  main     the row pass alone (the sum of the scratch left out)
  reduce   the sum of the scratch alone (the row pass left out)

and for the fp32 split pair (split_f32; tf32x3.cuh put in place of its
include):

  nosplit  no TF32 split: the raw fp32 bits as hi, lo 0 (three products still)
  mma1     one TF32 product (hi hi) instead of three
  nopass   the pass warps leave the landed stages as they are (no RoPE, no
           split)
  nosecond no second products (dq; dk, dv)
  cvtsplit the split by cvt.rna.tf32.f32 instead of integer rounding (the
           same bits)
  part2    the second products (dq; dk, dv) into a zeroed partial a k-step,
           added to the sums by fp32 adds (the tensor core truncates each
           product to its accumulator's exponent)
  part12   part2, and S and dP likewise

and for the fp32 dense products #2f, #11f and #12f (mlp_f32;
gemm_tf32x3.cuh put in place of its include):

  mma1     one TF32 product (A_hi B_hi) instead of three
  smema    A read by descriptor from the landed stage (its raw fp32 bits, no
           norm, no split) in all three products: the shared-memory-A
           route's main loop without its pre-pass and second A box, a lower
           bound of that route
  oneacc   one accumulator a tile, no partial sums a stage (the first
           build's summation; the same products)

    python3 -m graphgpt_torch.ops.split_probe
        [--kernel split|stream|fwd|bwd|mlp|norm_mlp|rmsnorm_bwd|mlp_f32|fwd_f32|bwd_f32|split_f32]
        [--source FILE] [--variants base,noexp]

--source probes another body of the file (one unpacked from an earlier
commit, say, with the headers beside it, which it is built against before
the package's own); a substitution that does not match it raises; fwd
and bwd time the forms that its source has; fwd_f32 times the package's
forward role (its variants) and band form, and with --source an earlier
flash_fwd_f32.cu (whose entries of the same names were the FFMA #1f, #6f)
beside them in the same turns. fwd_f32 with --pins times nothing: it
prints the digests that tests/test_torch_gpu.py pins, each fp32 backward
form's through its wrapper on the out and lse of `inputs` (the plain
forward in float64) and, with --source, on those of that body's forward;
#1f's, #6f's and #9f's through their wrappers, and #9f's of the --source
body. split_f32 times the pair at
the denoise batch and at B 8 x P 1024 with and without 16 bit slots, and
its stream form there (on one id array within F32_REL of the pair: its
delta is made consistent with its own p and dP) and at B 16 x P 4096
(the stream form alone, the query ids as key ids, then another row's), and
with --source (an earlier flash_bwd_split_f32.cu, or an earlier
flash_bwd_f32.cu, whose stream entries of the same names were the FFMA
pair #7f, #8f) times that body beside the package's in the same turns;
mlp_f32 likewise with --source an FFMA body's norm_mlp_f32.cu (whose
entries of the same names take no weight planes and no tile width). Needs
a CUDA card and nvcc.
Prints the card, then one line a shape and variant (fwd, bwd: a line a
form): the medians of five CUDA-event readings of 30 launches each, every
variant of a shape in one turn, then again in the reverse order; the split,
stream and bwd lines end with a digest of dq, delta, dk and dv, the fwd
lines with one of out and lse, the rmsnorm_bwd lines with one of dx and dw,
the fp32 lines with one of their outputs (f32_digest: out; q, k, v of
#12f; out and lse of #1f, #6f and #9f; dq, dk, dv of #3f and #10f; dq and
delta of #4f and #7f; dk, dv of #5f and #8f), so that two bodies that should give the same bits (one
--source against another, or a stream form against its single form on the
same ids) show it, and the form's bound at that shape (chip_smoke.py's
count: fp32 bytes at 3.35 TB/s, operations on the visible pairs at 165
TFLOP/s). The fp32 kernels but split_f32 and mlp_f32 have the
base variant only, and the forms their source has.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
from pathlib import Path

import numpy as np
import torch

from graphgpt_torch.models.rope import rope_cos_sin
from graphgpt_torch.ops import _build
from graphgpt_torch.ops import flash_attention as fa
from graphgpt_torch.ops import mlp as tmlp
from graphgpt_torch.synthetic import packed_segments

_ROPE0 = [("            if (args.rope) {\n              uint4 x = lds128",
           "            if (false) {\n              uint4 x = lds128")]
# the forward and the fused backward: the pass warps read and write nothing
_ROPE0_SM90 = [("uint4 x = lds128(b1 + plo), y = lds128(b1 + phi);",
                "uint4 x{}, y{};\n if (false) { x = lds128(b1 + plo), y = lds128(b1 + phi);"),
               ("sts128(b1 + phi, y);", "sts128(b1 + phi, y); }")]
_NOGLOB = [("const int s0 = rows.s0, s1 = rows.s1;",
            "const int s0 = r0 < P ? 1 : 0, s1 = r1 < P ? 1 : 0;"),
           ("const float l2e0 = rows.lse0 * LOG2E, l2e1 = rows.lse1 * LOG2E;",
            "const float l2e0 = 5.f, l2e1 = 5.f;")]
_NOEPI = [("      tma_store_3d(&st1, box0, it.h * DH, wrow0, it.b);", "      (void)0;"),
          ("      if (DKV) tma_store_3d(&st2, box0 + HALF, it.h * DH, wrow0, it.b);",
           "      (void)0;")]
_NOEXP = [("const float pe = ex2(ok ? fmaf(sc[4 * j + e], LOG2E, -l2e) : -INFINITY);",
           "const float pe = sc[4 * j + e];")]
_STAGES2 = [("constexpr int STAGES = 3;", "constexpr int STAGES = 2;")]
_BWD_STAGES = {n: [("constexpr int STAGES_BAND = 8;", f"constexpr int STAGES_BAND = {n};")]
               for n in (2, 4, 6)}
_BWD_STAGES[2].append(("constexpr int STAGES_SINGLE = 3;", "constexpr int STAGES_SINGLE = 2;"))
_BWD_NOCONS = [("    if (!skip) {\n      float sc[32], dp[32];",
                "    if (false) {\n      float sc[32], dp[32];")]
_FWD_STAGES = {n: [("constexpr int STAGES = 4;", f"constexpr int STAGES = {n};")] for n in (2, 3)}
_FWD_NOEPI = [("      tma_store_3d(&tout, box0, it.h * DH, wrow0, it.b);", "      (void)0;")]
_FWD_NOEXP = [("pv[e] = ex2(fmaf(sc[4 * j + e], LOG2E, -(e < 2 ? ml0 : ml1)));",
               "pv[e] = sc[4 * j + e];")]
_FWD_NOCONS = [("      if (!skip) {\n        float sc[32];",
                "      if (false) {\n        float sc[32];")]
_FWD_SHFL = [("visiting_mask<uint64_t, true>(", "visiting_mask<uint64_t, false>("),
             ("tile_range_redux(segb, v0,", "tile_range(segb, v0,")]
_BWD_SHFL = [("visiting_mask<uint32_t, true>(", "visiting_mask<uint32_t, false>("),
             ("tile_range_redux(segb, v0,", "tile_range(segb, v0,")]
# the stream form's walkers: the masks and ranges from the ids (the
# visiting ids for both sides: the probe's key ids are its query ids)
_STREAM_SHFL = [("table_mask(tabo, tabv, it.own0, nt, tri, DKV, lane, ",
                 "visiting_mask<uint64_t>(args.segv + (long long)it.b * P, it.own0, P, tri, DKV, "
                 "lane, "),
                ("lo = tabv[vt].x;\n            hi = tabv[vt].y;",
                 "tile_range(segv, v0, P, lane, &lo, &hi);")]
# the stream form's walkers: the masks and the key tiles' ranges from the
# ids by redux.sync, as the single form takes them (the probe's key ids are
# its query ids)
_FWD_REDUX = [("return table_mask(args.tabq + (long long)it.b * nt, args.tabk + (long long)it.b"
               " * nt,\n                        it.own0, nt, tri, false, lane, c);",
               "return visiting_mask<uint64_t, true>(args.segk + (long long)it.b * P, it.own0, P,"
               " tri, false, lane, c);"),
              ("const int2 r = args.tabk[(long long)it.b * nt + vt];\n              lo = r.x;\n"
               "              hi = r.y;", "tile_range_redux(segb, v0, P, lane, &lo, &hi);")]
_FWD_NOMASK = [("sc[4 * j + e] = ok ? sc[4 * j + e] : -INFINITY;", "(void)ok;")]
_BWD_NOEPI = [("    tma_store_3d(DKV ? &mp.dk : &mp.dq, box0, it.h * DH, wrow0, it.b);",
               "    (void)0;"),
              ("    if (DKV) tma_store_3d(&mp.dv, box0 + HALF, it.h * DH, wrow0, it.b);",
               "    (void)0;")]
_BWD_NODELTA = [("  delta_kernel<<<", "  if (false) delta_kernel<<<")]


def _drop(role):
    """The three calls of one role of the fused backward (both forms), left
    out."""
    return [(f"        produce<FORM, {role}>(", f"        if (false) produce<FORM, {role}>("),
            (f"        pass_role<FORM, {role}>(", f"        if (false) pass_role<FORM, {role}>("),
            (f"    consume<FORM, {role}>(", f"    if (false) consume<FORM, {role}>(")]


# the RMSNorm backward's two launches, one left out
_RMS_MAIN = [("rmsnorm_bwd_reduce_kernel<<<", "if (false) rmsnorm_bwd_reduce_kernel<<<")]
_RMS_REDUCE = [("rmsnorm_bwd_kernel<T, NC><<<", "if (false) rmsnorm_bwd_kernel<T, NC><<<")]


_MLP_NOCONS = [("wgmma_ss<N>(acc, da + 2 * kk, db + 2 * kk, kc + kk > 0);", "(void)0;"),
               ("wgmma_rs<2 * BH>(acc, a[kk], desc + 2 * kk, kc + kk > 0);", "(void)0;")]
_MLP_NONORM = [("norm_a(a[kk], kk, wk, rr0, rr1);", "(void)0;")]
_MLP_NOACT = [("return bround(act_f32<ACT>(bround(sg))) * bround(su);",
               "return bround(sg) * bround(su);")]
_MLP_NORES = [(f"launch_down<{bn}, NORM>", f"launch_down<{bn}, false>")
              for bn in (256, 192, 128, 64)]
_MLP_NOPRE = [("if (NORM && (stages & RRMS))", "if (false)")]
# the gate/up epilogue on bf16x2 pairs: one conversion a pair, a * xu by
# mul.rn.bf16x2 (the product of two bf16 is exact in fp32: the same bits)
_MLP_BF16X2 = [
    ("template <int ACT>\n__device__ __forceinline__ float gated(",
     "template <int ACT>\n__device__ __forceinline__ uint32_t gated2(float g0, float g1, float u0,"
     " float u1) {\n  const uint32_t xg = bf2(g0, g1);\n  const uint32_t a = bf2(act_f32<ACT>("
     "__uint_as_float(xg << 16)), act_f32<ACT>(__uint_as_float(xg & 0xFFFF0000u)));\n"
     "  uint32_t d;\n  asm(\"mul.rn.bf16x2 %0, %1, %2;\\n\" : \"=r\"(d) : \"r\"(a), "
     "\"r\"(bf2(u0, u1)));\n  return d;\n}\n\ntemplate <int ACT>\n"
     "__device__ __forceinline__ float gated("),
    ("sts32(at, bf2(gated<ACT>(acc[4 * j], acc[u]), gated<ACT>(acc[4 * j + 1], acc[u + 1])));",
     "sts32(at, gated2<ACT>(acc[4 * j], acc[4 * j + 1], acc[u], acc[u + 1]));"),
    ("bf2(gated<ACT>(acc[4 * j + 2], acc[u + 2]), gated<ACT>(acc[4 * j + 3], acc[u + 3])));",
     "gated2<ACT>(acc[4 * j + 2], acc[4 * j + 3], acc[u + 2], acc[u + 3]));")]
# wn read from global memory (L1) instead of shared: a 4th ring stage for gate/up with the norm
_MLP_WNGLOBAL = [
    ("using GateUp = Ring<2 * BH, BH, NORM ? MAX_D * 4 : 0>;",
     "using GateUp = Ring<2 * BH, BH, 0>;"),
    ("reinterpret_cast<uint64_t*>(wn_s + (NORM ? D : 0));", "reinterpret_cast<uint64_t*>(wn_s);"),
    ("    for (int i = tid; i < D; i += THREADS) wn_s[i] = wn[i];", "    (void)0;"),
    ("const float* wk = wn_s + kc * KC + 2 * tq4;", "const float* wk = wn + kc * KC + 2 * tq4;"),
    ("smem_bytes<T>(NORM ? MAX_D : 0), configured", "smem_bytes<T>(0), configured"),
    ("smem_bytes<T>(NORM ? a.D : 0), s>>>(", "smem_bytes<T>(0), s>>>(")]

# the fp32 split pair (flash_bwd_split_f32.cu with tf32x3.cuh put in place
# of its include): the TF32 split by cvt.rna (the same bits), no split (the
# raw fp32 bits as hi, lo 0), one TF32 product instead of three, no pass
# over the landed stages (no RoPE, no split: the planes hold the raw tile
# and what the last pass left), no second products
_F32_SPLIT_BODY = ("  hi = tf32_rna(x);\n  lo = tf32_rna(x - __uint_as_float(hi));")
_F32_CVTSPLIT = [(_F32_SPLIT_BODY,
                  '  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(x));\n'
                  '  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));')]
_F32_NOSPLIT = [(_F32_SPLIT_BODY, "  hi = __float_as_uint(x);\n  lo = 0u;")]
_F32_MMA1 = [("      mma_tf32(s0, l1, b1h[0], b1h[1]);\n      mma_tf32(s1, l1, b1h[2], b1h[3]);\n"
              "      mma_tf32(d0, l2, b2h[0], b2h[1]);\n      mma_tf32(d1, l2, b2h[2], b2h[3]);\n"
              "      mma_tf32(s0, h1, b1l[0], b1l[1]);\n      mma_tf32(s1, h1, b1l[2], b1l[3]);\n"
              "      mma_tf32(d0, h2, b2l[0], b2l[1]);\n      mma_tf32(d1, h2, b2l[2], b2l[3]);\n", ""),
             ("  for (int q = 0; q < 4; ++q) mma_tf32(acc[nb0 + q], al, bh[q][0], bh[q][1]);\n"
              "#pragma unroll\n  for (int q = 0; q < 4; ++q) mma_tf32(acc[nb0 + q], ah, bl[q][0], bl[q][1]);\n",
              "  for (int q = 0; q < 0; ++q) {}\n")]
# the 3xTF32 dense products (mlp_qkv_f32.cu with gemm_tf32x3.cuh put in
# place of its include): one TF32 product (A_hi B_hi) instead of three; and
# the shared-memory-A route's main loop, A read by descriptor from the
# landed stage (its raw fp32 bits, no norm and no split) in all three
# products, without the route's pre-pass and its second A box a stage (a
# lower bound of that route's time)
_GEMM_MMA1 = [("  wgmma_rs<N>(d, lo, bhi, scale_d);\n  wgmma_rs<N>(d, hi, blo, 1);\n"
               "  wgmma_rs<N>(d, hi, bhi, 1);", "  wgmma_rs<N>(d, hi, bhi, scale_d);")]
_GEMM_SMEMA = [("      uint32_t a[4][4];\n      load_a(a, st, aoff);\n#pragma unroll\n"
                "      for (int kk = 0; kk < 4; ++kk) {",
                "      const uint64_t da = desc_sw128(st + (warp >> 2) * 64 * 128);\n"
                "      wgmma_fence();\n#pragma unroll\n      for (int kk = 0; kk < 4; ++kk) {\n"
                "        wgmma_ss<BN>(part, da + 2 * kk, bhi + 2 * kk, kk > 0);\n"
                "        wgmma_ss<BN>(part, da + 2 * kk, blo + 2 * kk, 1);\n"
                "        wgmma_ss<BN>(part, da + 2 * kk, bhi + 2 * kk, 1);\n      }\n"
                "      uint32_t a[4][4];\n      for (int kk = 0; kk < 0; ++kk) {")]
# one accumulator a tile, as the first build had it: no partial sums a
# stage (the same products, summed less accurately)
_GEMM_ONEACC = [("mma3<BN>(part, a[kk], lo, bhi + 2 * kk, blo + 2 * kk, kk > 0);",
                 "mma3<BN>(acc, a[kk], lo, bhi + 2 * kk, blo + 2 * kk, kc + kk > 0);"),
                ("        pin(part[i]);\n        acc[i] += part[i];", "        pin(acc[i]);")]
# each k-step's three products into a zeroed partial, added to the sums by
# fp32 adds, which round to nearest: the second products (part2), and S and
# dP too (part12)
_F32_PART2 = [("#pragma unroll\n  for (int q = 0; q < 4; ++q) mma_tf32(acc[nb0 + q], al, bh[q][0], bh[q][1]);\n"
               "#pragma unroll\n  for (int q = 0; q < 4; ++q) mma_tf32(acc[nb0 + q], ah, bl[q][0], bl[q][1]);\n"
               "#pragma unroll\n  for (int q = 0; q < 4; ++q) mma_tf32(acc[nb0 + q], ah, bh[q][0], bh[q][1]);\n",
               "  float t[4][4] = {};\n"
               "#pragma unroll\n  for (int q = 0; q < 4; ++q) mma_tf32(t[q], al, bh[q][0], bh[q][1]);\n"
               "#pragma unroll\n  for (int q = 0; q < 4; ++q) mma_tf32(t[q], ah, bl[q][0], bl[q][1]);\n"
               "#pragma unroll\n  for (int q = 0; q < 4; ++q) mma_tf32(t[q], ah, bh[q][0], bh[q][1]);\n"
               "#pragma unroll\n  for (int q = 0; q < 4; ++q)\n#pragma unroll\n"
               "    for (int e = 0; e < 4; ++e) acc[nb0 + q][e] += t[q][e];\n")]
_F32_PART12 = _F32_PART2 + [
    ("      float(&s0)[4] = sc[2 * pb];\n      float(&s1)[4] = sc[2 * pb + 1];\n"
     "      float(&d0)[4] = dp[2 * pb];\n      float(&d1)[4] = dp[2 * pb + 1];\n",
     "      float s0[4] = {}, s1[4] = {}, d0[4] = {}, d1[4] = {};\n"),
    ("      mma_tf32(d1, h2, b2h[2], b2h[3]);\n    }\n",
     "      mma_tf32(d1, h2, b2h[2], b2h[3]);\n#pragma unroll\n      for (int e = 0; e < 4; ++e) {\n"
     "        sc[2 * pb][e] += s0[e];\n        sc[2 * pb + 1][e] += s1[e];\n"
     "        dp[2 * pb][e] += d0[e];\n        dp[2 * pb + 1][e] += d1[e];\n      }\n    }\n")]
_F32_NOPASS = [("          for (int u = u0; u < 1024; u += 96) {",
                "          for (int u = u0 + 1024; u < 1024; u += 96) {")]
_F32_NOSECOND = [("            const int nbk = 4 * half + j;\n",
                  "            const int nbk = 4 * half + j;\n            continue;\n")]

# the fp32 forward role's ring of 2 stages instead of 3
_F32_FWD_STAGES2 = [("static constexpr int STAGES = FWD ? 3 : 2;",
                     "static constexpr int STAGES = 2;")]
# the digests tests/test_torch_gpu.py pins of the fp32 backward forms, which
# read out and lse (`inputs`), and of the fp32 forwards
F32_BWD_PINNED = (("flash_bwd_f32", "B8 P1024"), ("flash_bwd_f32", "toy B8 P128"),
                  ("flash_dq_f32", "denoise B256 P88"), ("flash_dkv_f32", "denoise B256 P88"),
                  ("flash_dq_f32", "B8 P1024 bi16"), ("flash_dkv_f32", "B8 P1024 bi16"),
                  ("flash_dq_stream_f32", "B8 P1024"), ("flash_dkv_stream_f32", "B8 P1024"),
                  ("flash_dq_stream_f32", "B16 P4096"), ("flash_dkv_stream_f32", "B16 P4096"))
F32_FWD_PINNED = (("flash_fwd_f32", "B8 P1024"), ("flash_fwd_f32", "denoise B256 P88"),
                  ("flash_fwd_stream_f32", "B8 P1024"), ("flash_fwd_stream_f32", "B16 P4096"),
                  ("flash_fwd_band_f32", "B8 P1024"), ("flash_fwd_band_f32", "B16 P4096"))

# per kernel: its source, its C entries, and its variants
KERNELS = {
    "split": ("flash_bwd_split.cu", {
        "base": [], "rope0": _ROPE0, "noglob": _NOGLOB, "noepi": _NOEPI, "noexp": _NOEXP,
        "stages2": _STAGES2, "all": _ROPE0 + _NOGLOB + _NOEPI + _NOEXP}),
    "stream": ("flash_bwd_split.cu", {
        "base": [], "rope0": _ROPE0, "noepi": _NOEPI, "noexp": _NOEXP, "stages2": _STAGES2,
        "shfl": _STREAM_SHFL}),
    "fwd": ("flash_fwd.cu", {
        "base": [], "rope0": _ROPE0_SM90, "noepi": _FWD_NOEPI, "noexp": _FWD_NOEXP,
        "nomask": _FWD_NOMASK, "nocons": _FWD_NOCONS, "shfl": _FWD_SHFL, "redux": _FWD_REDUX,
        "stages2": _FWD_STAGES[2], "stages3": _FWD_STAGES[3],
        "all": _ROPE0_SM90 + _FWD_NOEPI + _FWD_NOEXP + _FWD_NOMASK}),
    "bwd": ("flash_bwd.cu", {
        "base": [], "rope0": _ROPE0_SM90, "noepi": _BWD_NOEPI, "noexp": _NOEXP,
        "nocons": _BWD_NOCONS, "nodelta": _BWD_NODELTA, "dqonly": _drop("true"),
        "dkvonly": _drop("false"), "shfl": _BWD_SHFL, "stages2": _BWD_STAGES[2],
        "stages4": _BWD_STAGES[4], "stages6": _BWD_STAGES[6],
        "all": _ROPE0_SM90 + _BWD_NOEPI + _NOEXP + _BWD_NODELTA}),
    "mlp": ("mlp.cu", {"base": [], "nocons": _MLP_NOCONS, "noact": _MLP_NOACT,
                       "bf16x2": _MLP_BF16X2}),
    "norm_mlp": ("norm_mlp.cu", {
        "base": [], "nocons": _MLP_NOCONS, "nonorm": _MLP_NONORM, "noact": _MLP_NOACT,
        "nores": _MLP_NORES, "nopre": _MLP_NOPRE, "bf16x2": _MLP_BF16X2,
        "wnglobal": _MLP_WNGLOBAL}),
    "rmsnorm_bwd": ("rmsnorm_bwd.cu", {"base": [], "main": _RMS_MAIN, "reduce": _RMS_REDUCE}),
    "mlp_f32": ("mlp_qkv_f32.cu", {"base": [], "mma1": _GEMM_MMA1, "smema": _GEMM_SMEMA,
                                   "oneacc": _GEMM_ONEACC}),
    "fwd_f32": ("flash_bwd_split_f32.cu", {"base": [], "stages2": _F32_FWD_STAGES2}),
    "bwd_f32": ("flash_bwd_f32.cu", {"base": []}),
    "split_f32": ("flash_bwd_split_f32.cu", {
        "base": [], "cvtsplit": _F32_CVTSPLIT, "nosplit": _F32_NOSPLIT, "mma1": _F32_MMA1,
        "nopass": _F32_NOPASS, "nosecond": _F32_NOSECOND, "part2": _F32_PART2,
        "part12": _F32_PART12}),
}
# the fp32 forms: each C entry, its argument types and the form's name
F32_ENTRIES = {
    "mlp_f32": {"norm_mlp_f32": ("ggt_norm_mlp_f32", tmlp._F32_ARGTYPES),
                "mlp_f32": ("ggt_mlp_f32", tmlp._MLP_F32_ARGTYPES),
                "norm_qkv_f32": ("ggt_norm_qkv_f32", tmlp._QKV_F32_ARGTYPES)},
    "fwd_f32": {"flash_fwd_f32": ("ggt_flash_fwd_f32", fa._ARGTYPES),
                "flash_fwd_stream_f32": ("ggt_flash_fwd_stream_f32", fa._FWD_STREAM_ARGTYPES),
                "flash_fwd_band_f32": ("ggt_flash_fwd_band_f32", fa._FWD_BAND_ARGTYPES)},
    "bwd_f32": {"flash_bwd_f32": ("ggt_flash_bwd_f32", fa._BWD_ARGTYPES),
                "flash_bwd_band_f32": ("ggt_flash_bwd_band_f32", fa._BWD_BAND_ARGTYPES)},
    "split_f32": {"flash_dq_f32": ("ggt_flash_dq_f32", fa._DQ_ARGTYPES),
                  "flash_dkv_f32": ("ggt_flash_dkv_f32", fa._DKV_ARGTYPES),
                  "flash_dq_stream_f32": ("ggt_flash_dq_stream_f32", fa._DQ_STREAM_ARGTYPES),
                  "flash_dkv_stream_f32": ("ggt_flash_dkv_stream_f32",
                                           fa._DKV_STREAM_ARGTYPES)},
}
# (N, D, F): GraphGPT-base's serving rows, the fine-tune batch's,
# toy_pretrain's; #2f also the denoise batch's and the training batch's
MLP_F32_SHAPES = {"N8192": (8192, 768, 3072), "N18432": (18432, 768, 3072),
                  "N1024": (1024, 128, 512), "N22528": (22528, 768, 3072),
                  "N65536": (65536, 768, 3072)}
NORM_MLP_F32_ONLY = ("N22528", "N65536")
# #2f's launches, each timed alone (ggt_norm_mlp_f32_stages) after a whole call
NORM_MLP_F32_STAGES = {"split": tmlp.MLP_SPLIT, "rrms": tmlp.MLP_RRMS,
                       "gate_up": tmlp.MLP_GATE_UP, "down": tmlp.MLP_DOWN}
# (B, P, H, bit slots, row layout) of the fp32 attention forms; #3f takes
# the shapes without bit slots
BWD_F32_SHAPES = {"B8 P1024": (8, 1024, 12, 0, "packed"), "toy B8 P128": (8, 128, 2, 0, "packed"),
                  "finetune B256 P72": (256, 72, 12, 0, "molecule"),
                  "denoise B256 P88": (256, 88, 12, 16, "denoise"),
                  "B8 P1024 bi16": (8, 1024, 12, 16, "packed"),
                  "B16 P4096": (16, 4096, 12, 0, "packed")}
# the split pair's shapes: the denoise batch, P 1024 with and without 16 bit
# slots, the quick start's; its stream form's also the long-context batch
SPLIT_F32_SHAPES = ("denoise B256 P88", "B8 P1024 bi16", "B8 P1024", "toy B8 P128",
                    "B16 P4096")
# the header a kernel's source includes, put in place before the substitutions
INLINE = {"mlp": "mlp_common.cuh", "norm_mlp": "mlp_common.cuh", "split_f32": "tf32x3.cuh",
          "mlp_f32": "gemm_tf32x3.cuh"}
# the entries of #2f, #11f and #12f in the FFMA body (norm_mlp_f32.cu, which
# held #2f alone once #11f and #12f moved to mlp_qkv_f32.cu), which --source
# of mlp_f32 may name: no weight planes, no tile widths
FFMA_F32_ARGTYPES = {
    "ggt_norm_mlp_f32": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_float,
                                                                       ctypes.c_int,
                                                                       ctypes.c_void_p],
    "ggt_mlp_f32": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "ggt_norm_qkv_f32": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                                       ctypes.c_void_p]}
VARIANTS = KERNELS["split"][1]
# (B, P, H, bit slots, row layout) of each kernel's shapes
SHAPES = {
    "split": {"denoise B256 P88": (256, 88, 12, 16, "denoise"),
              "B8 P1024": (8, 1024, 12, 16, "packed")},
    "stream": {"B16 P4096": (16, 4096, 12, 0, "packed")},
    "fwd": {"denoise B256 P88": (256, 88, 12, 16, "denoise"),
            "finetune B256 P72": (256, 72, 12, 0, "molecule"),
            "B8 P1024": (8, 1024, 12, 0, "packed"), "B64 P1024": (64, 1024, 12, 0, "packed"),
            "B16 P4096": (16, 4096, 12, 0, "packed")},
    "bwd": {"finetune B256 P72": (256, 72, 12, 0, "molecule"),
            "B8 P1024": (8, 1024, 12, 0, "packed"), "B64 P1024": (64, 1024, 12, 0, "packed"),
            "B16 P4096": (16, 4096, 12, 0, "packed")},
}
# bwd's forms: their C entries, argument types and the shapes they are timed at
BWD_FORMS = {"flash_bwd": ("ggt_flash_bwd", fa._BWD_ARGTYPES, fa.MAX_P),
             "flash_bwd_band": ("ggt_flash_bwd_band", fa._BWD_BAND_ARGTYPES, None)}
BWD_BAND_SHAPES = ("B8 P1024", "B64 P1024", "B16 P4096")
RMS_SHAPES = {"N18432": 18432, "N22528": 22528, "N65536": 65536}  # D 768
# fwd's forms: their C entries and argument types
FWD_FORMS = {"flash_fwd": ("ggt_flash_fwd", fa._ARGTYPES),
             "flash_fwd_stream": ("ggt_flash_fwd_stream", fa._FWD_STREAM_ARGTYPES),
             "flash_fwd_band": ("ggt_flash_fwd_band", fa._FWD_BAND_ARGTYPES)}
MLP_SHAPES = {"N8192": (8192, 768, 3072), "N65536": (65536, 768, 3072)}  # (N, D, F)
DH = 64
# the fp32 lines' bounds, as chip_smoke.py's flash_work and bound count them:
# fp32 bytes at 3.35 TB/s, operations at 165 TFLOP/s (3xTF32, the fastest
# fp32-accurate product); per attention kind its products, token-major
# tensors and fp32 rows
PEAK_BYTES, PEAK_F32_ACCURATE_FLOPS = 3.35e12, 165e12
F32_WORK = {"fwd": (2, 4, 1), "bwd": (5, 8, 1), "dq": (3, 6, 2), "dkv": (4, 6, 2)}
F32_KIND = {"flash_fwd_f32": "fwd", "flash_fwd_stream_f32": "fwd", "flash_fwd_band_f32": "fwd",
            "flash_bwd_f32": "bwd", "flash_bwd_band_f32": "bwd", "flash_dq_f32": "dq",
            "flash_dq_stream_f32": "dq", "flash_dkv_f32": "dkv", "flash_dkv_stream_f32": "dkv"}


def build(kernel: str, source: str, names, include: Path, label: str = "") -> dict:
    """{variant: its C library}, one nvcc each, all at once; `include` (the
    source's directory) is searched for headers before the package's;
    `label` names the builds (default: the kernel's key)."""
    out_dir = _build.BUILD_DIR.parent / "split_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    variants = KERNELS[kernel][1]
    if kernel in INLINE:
        header = f'#include "{INLINE[kernel]}"'
        source = source.replace(header, (_build.CSRC / INLINE[kernel]).read_text())
    procs = {}
    for name in names:
        text = source
        for old, new in variants[name]:
            if old not in text:
                raise ValueError(f"variant {name}: {old!r} is not in the source")
            text = text.replace(old, new)
        src, lib = out_dir / f"{label or kernel}_{name}.cu", out_dir / f"lib{label or kernel}_{name}.so"
        src.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(include), "-I", str(_build.CSRC),
               "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} did not build:\n{log}")
        flagged = re.findall(r"[1-9]\d* bytes spill \w+|C751\d", log)
        if flagged:
            print(f"variant {name}: ptxas reports {sorted(set(flagged))}", flush=True)
        libs[name] = ctypes.CDLL(str(lib))
        if kernel == "split":
            libs[name].ggt_flash_dq.argtypes = fa._DQ_ARGTYPES
            libs[name].ggt_flash_dkv.argtypes = fa._DKV_ARGTYPES
        elif kernel == "stream":
            libs[name].ggt_flash_dq_stream.argtypes = fa._DQ_STREAM_ARGTYPES
            libs[name].ggt_flash_dkv_stream.argtypes = fa._DKV_STREAM_ARGTYPES
        elif kernel == "fwd":
            for entry, argtypes in FWD_FORMS.values():
                if hasattr(libs[name], entry):
                    getattr(libs[name], entry).argtypes = argtypes
        elif kernel == "bwd":
            for entry, argtypes, _ in BWD_FORMS.values():
                if hasattr(libs[name], entry):
                    getattr(libs[name], entry).argtypes = argtypes
        elif kernel in F32_ENTRIES:
            for entry, argtypes in F32_ENTRIES[kernel].values():
                if hasattr(libs[name], entry):
                    getattr(libs[name], entry).argtypes = argtypes
            if hasattr(libs[name], "ggt_norm_mlp_f32_stages"):
                libs[name].ggt_norm_mlp_f32_stages.argtypes = tmlp._F32_STAGE_ARGTYPES
        elif kernel == "rmsnorm_bwd":
            libs[name].ggt_rmsnorm_bwd.argtypes = tmlp._RMS_ARGTYPES
        elif kernel == "mlp":
            libs[name].ggt_mlp_stages.argtypes = tmlp._MLP_STAGE_ARGTYPES
        else:
            libs[name].ggt_norm_mlp_stages.argtypes = tmlp._STAGE_ARGTYPES
    return libs


def probe_mlp(kernel: str, libs, dev) -> None:
    """Each MLP variant whole and stage by stage at MLP_SHAPES, every
    variant of a shape in one turn, then again in the reverse order."""
    stream, ptr = _build.stream_ptr(dev), _build.ptr
    gen = torch.Generator(device=dev).manual_seed(0)
    for tag, (n, d, f) in MLP_SHAPES.items():
        x = torch.randn(n, d, generator=gen, device=dev).to(torch.bfloat16)
        wn = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
        wg, wu = ((torch.randn(f, d, generator=gen, device=dev) * 0.02).to(torch.bfloat16)
                  for _ in range(2))
        wd = (torch.randn(d, f, generator=gen, device=dev) * 0.02).to(torch.bfloat16)
        g = torch.empty(n, f, dtype=torch.bfloat16, device=dev)
        out, rr = torch.empty_like(x), torch.empty(n, dtype=torch.float32, device=dev)
        tiles = tmlp.mlp_tiles(n, d, f, torch.cuda.get_device_properties(dev).multi_processor_count)
        stages = {"rrms": tmlp.MLP_RRMS} if kernel == "norm_mlp" else {}
        stages.update(gate_up=tmlp.MLP_GATE_UP, down=tmlp.MLP_DOWN)
        order = list(libs.items())
        for turn in (order, order[::-1]):
            for name, lib in turn:
                def run(mask, lib=lib):
                    if kernel == "mlp":
                        err = lib.ggt_mlp_stages(ptr(x), ptr(wg), ptr(wu), ptr(wd), ptr(g),
                                                 ptr(out), n, d, f, *tiles, 0, mask, stream)
                    else:
                        err = lib.ggt_norm_mlp_stages(ptr(x), ptr(wn), ptr(wg), ptr(wu), ptr(wd),
                                                      ptr(g), ptr(out), ptr(rr), n, d, f, *tiles,
                                                      1e-6, 0, mask, stream)
                    _build.check(err, f"{kernel} {name}")

                whole = cuda_ms(lambda: run(sum(stages.values())))
                alone = "  ".join(f"{s} {cuda_ms(lambda m=m: run(m)):.4f}"
                                  for s, m in stages.items())
                # a digest of g and out after a whole run: a variant that
                # should keep the bits (bf16x2, wnglobal) shows base's
                run(sum(stages.values()))
                digest = sum(t.view(torch.int16).long().sum().item() for t in (g, out))
                print(f"{tag} tiles {tiles}: {name:8s} {kernel} {whole:.4f} ms  alone: {alone}  "
                      f"digest {digest}", flush=True)


def probe_rms(libs, dev, legacy_grid: bool) -> None:
    """Each rmsnorm_bwd variant at RMS_SHAPES (D 768), every variant of a
    shape in one turn, then again in the reverse order. The grid is the
    wrapper's (`rms_blocks`), or with `legacy_grid` the grid of the first
    body (one 8-warp CTA for each 8 rows up to 1,056, which its wrapper
    gave it)."""
    stream, ptr = _build.stream_ptr(dev), _build.ptr
    gen = torch.Generator(device=dev).manual_seed(4)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    d = 768
    for tag, n in RMS_SHAPES.items():
        x = torch.randn(n, d, generator=gen, device=dev).to(torch.bfloat16)
        g = torch.randn(n, d, generator=gen, device=dev).to(torch.bfloat16)
        w = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
        blocks = max(1, min((n + 7) // 8, 1056)) if legacy_grid else tmlp.rms_blocks(n, d, sms)
        dx, dw = torch.empty_like(x), torch.empty(d, dtype=torch.float32, device=dev)
        partial = torch.empty(blocks, d, dtype=torch.float32, device=dev)
        order = list(libs.items())
        for turn in (order, order[::-1]):
            for name, lib in turn:
                def run(lib=lib):
                    err = lib.ggt_rmsnorm_bwd(ptr(x), ptr(g), ptr(w), ptr(dx), ptr(dw),
                                              ptr(partial), n, d, 1e-6, blocks, stream)
                    _build.check(err, f"rmsnorm_bwd {name}")

                t = cuda_ms(run)
                dx.zero_()
                dw.zero_()
                run()
                digest = (dx.view(torch.int16).long().sum().item()
                          + dw.view(torch.int32).long().sum().item())
                print(f"{tag} D{d} grid {blocks}: {name:8s} rmsnorm_bwd {t:.4f} ms  "
                      f"digest {digest}", flush=True)


def f32_digest(*tensors) -> int:
    """The sum of fp32 tensors' bits read as int32: equal for equal bits."""
    return sum(t.contiguous().view(torch.int32).long().sum().item() for t in tensors)


def f32_mlp_inputs(n, d, f, dev, seed: int = 9):
    """x, wn, wg, wu, wd in fp32, drawn by numpy from `seed`."""
    rng = np.random.default_rng(seed)

    def draw(shape, scale, loc=0.0):
        return torch.from_numpy((loc + rng.normal(size=shape) * scale).astype(np.float32)).to(dev)

    scale = 0.55 / d**0.5
    return (draw((n, d), 1.0), draw((d,), 0.1, 1.0), draw((f, d), scale), draw((f, d), scale),
            draw((d, f), scale))


def _segments(b, p, bi, layout, rng):
    """int32 [B, P] segment ids: a molecule and a padded stretch a row, then
    `bi` bit slots ("denoise"); a molecule at the front ("molecule"); packed
    rows (else)."""
    if layout == "denoise":
        seg = np.zeros((b, p), np.int32)
        for r in range(b):
            seg[r, : int(rng.integers(10, p - bi))] = 1
            seg[r, p - bi:] = 1
        return seg
    if layout == "molecule":
        seg = np.zeros((b, p), np.int32)
        for r in range(b):
            seg[r, : int(rng.integers(10, p + 1))] = 1
        return seg
    return packed_segments(b, p, rng)


def probe_f32(kernel: str, libs, dev) -> None:
    """Each fp32 form its source has, at its shapes: the median time and a
    digest of its outputs after one launch on fresh buffers, every source
    of a shape in one turn, then again in the reverse order (mlp_f32: then
    #2f's launches alone, in the package's base body)."""
    stream, ptr = _build.stream_ptr(dev), _build.ptr
    entries = F32_ENTRIES[kernel]
    if kernel == "mlp_f32":
        ffma = libs.get("source")  # the FFMA body's entries take no planes
        for tag, (n, d, f) in MLP_F32_SHAPES.items():
            x, wn, wg, wu, wd = f32_mlp_inputs(n, d, f, dev)
            g = torch.empty(n, f, device=dev)
            out, rr = torch.empty_like(x), torch.empty(n, device=dev)
            qkv = [torch.empty_like(x) for _ in range(3)]
            planes = torch.empty(2, 3 * f * d, device=dev)
            bn = tmlp.f32_block_n((d,))
            # #12f's weights: the first d rows of wg, of wu, and rows d.. of wg
            ws = (ptr(wg), ptr(wu), ptr(wg[d:]))

            def run_mlp(lib):
                if lib is ffma:
                    return lib.ggt_mlp_f32(ptr(x), ptr(wg), ptr(wu), ptr(wd), ptr(g), ptr(out), n,
                                           d, f, 0, stream)
                return lib.ggt_mlp_f32(ptr(x), ptr(wg), ptr(wu), ptr(wd), ptr(planes), ptr(g),
                                       ptr(out), n, d, f, bn, 0, stream)

            def run_qkv(lib):
                if lib is ffma:
                    return lib.ggt_norm_qkv_f32(ptr(x), ptr(wn), *ws, *(ptr(t) for t in qkv),
                                                ptr(rr), n, d, d, d, d, 1e-6, stream)
                return lib.ggt_norm_qkv_f32(ptr(x), ptr(wn), *ws, ptr(planes),
                                            *(ptr(t) for t in qkv), ptr(rr), n, d, d, d, d, bn,
                                            1e-6, stream)

            def run_norm_mlp(lib, stages=None):
                if lib is ffma:
                    return lib.ggt_norm_mlp_f32(ptr(x), ptr(wn), ptr(wg), ptr(wu), ptr(wd),
                                                ptr(g), ptr(out), ptr(rr), n, d, f, 1e-6, 0,
                                                stream)
                args = (ptr(x), ptr(wn), ptr(wg), ptr(wu), ptr(wd), ptr(planes), ptr(g),
                        ptr(out), ptr(rr), n, d, f, bn, 1e-6, 0)
                if stages is None:
                    return lib.ggt_norm_mlp_f32(*args, stream)
                return lib.ggt_norm_mlp_f32_stages(*args, stages, stream)

            runs = {"norm_mlp_f32": run_norm_mlp, "mlp_f32": run_mlp, "norm_qkv_f32": run_qkv}
            if tag in NORM_MLP_F32_ONLY:
                runs = {"norm_mlp_f32": run_norm_mlp}
            outs = {"norm_mlp_f32": (out,), "mlp_f32": (out,), "norm_qkv_f32": qkv}
            mlp_bytes = 4 * (2 * n * d + 3 * d * f)
            bounds = {"norm_mlp_f32": f32_bound_ms(mlp_bytes + 4 * d, 6.0 * n * d * f),
                      "mlp_f32": f32_bound_ms(mlp_bytes, 6.0 * n * d * f),
                      "norm_qkv_f32": f32_bound_ms(4 * (4 * n * d + 3 * d * d + d),
                                                   6.0 * n * d * d)}
            _probe_f32_turns(tag, libs, entries, runs, outs, bounds)
            name, lib = next(iter(libs.items()))  # the package's first variant
            _build.check(run_norm_mlp(lib), "norm_mlp_f32")
            for stage, bit in NORM_MLP_F32_STAGES.items():
                t = cuda_ms(lambda: _build.check(run_norm_mlp(lib, bit), f"norm_mlp_f32 {stage}"))
                print(f"{tag}: {name:8s} norm_mlp_f32 {stage} alone {t:.4f} ms", flush=True)
        return
    for tag, (b, p, h, bi, layout) in BWD_F32_SHAPES.items():
        if kernel == "split_f32" and tag not in SPLIT_F32_SHAPES:
            continue
        qs, k, v, do, seg, cos, sin, out, lse = inputs(b, p, h, bi, layout, dev, torch.float32)
        if kernel == "fwd_f32":
            common = (ptr(qs), ptr(k), ptr(v), ptr(seg), ptr(cos), ptr(sin))
            # the stream form on the query ids as key ids
            stream_common = (ptr(qs), ptr(k), ptr(v), ptr(seg), ptr(seg), ptr(cos), ptr(sin))
            # the band form on the same q and k, unrotated, no cos and sin
            band_common = (ptr(qs), ptr(k), ptr(v), ptr(seg), ptr(seg))
            tab = fa._tile_scratch(seg)
            o2, l2 = torch.empty_like(out), torch.empty_like(lse)
            runs = {
                "flash_fwd_f32": lambda lib: lib.ggt_flash_fwd_f32(
                    *common, ptr(o2), ptr(l2), b, p, h, 0, bi, stream),
                "flash_fwd_stream_f32": lambda lib: lib.ggt_flash_fwd_stream_f32(
                    *stream_common, ptr(o2), ptr(l2), ptr(tab), b, p, h, 0, bi, stream),
                "flash_fwd_band_f32": lambda lib: lib.ggt_flash_fwd_band_f32(
                    *band_common, ptr(o2), ptr(l2), ptr(tab), b, p, h, 0, bi, stream)}
            # the 3xTF32 #1f takes P <= MAX_P (the FFMA one, --source's, any P)
            skip = ({("flash_fwd_f32", name) for name in libs if name != "source"}
                    if p > fa.MAX_P else set())
            _probe_f32_turns(tag, libs, entries, runs, {form: (o2, l2) for form in runs},
                             {form: f32_attention_bound(form, seg, h, bi) for form in runs},
                             skip)
            continue
        if kernel == "split_f32":
            # the stream form also with another row's ids as key ids where
            # the single form cannot take the row (and its out and lse)
            keys = [(tag, seg, out, lse)]
            if p > fa.MAX_P:
                seg_k = seg.roll(1, dims=0)
                keys.append((f"{tag} other keys", seg_k,
                             *fa.flash_fwd_stream(qs, k, v, seg, seg_k, cos, sin, False, DH, bi)))
            for ktag, seg_k, kout, klse in keys:
                _probe_f32_bwd(ktag, libs, entries, qs, k, v, do, seg, seg_k, cos, sin, kout,
                               klse, bi, dev)
        else:
            _probe_f32_bwd(tag, libs, entries, qs, k, v, do, seg, seg, cos, sin, out, lse, bi, dev)


def _probe_f32_bwd(tag, libs, entries, qs, k, v, do, seg, seg_k, cos, sin, out, lse, bi,
                   dev) -> None:
    """The fp32 backward forms of `entries` on these inputs (the key ids
    seg_k those of the stream forms; the single forms and the band form run
    only on one id array, the single forms up to MAX_P)."""
    stream, ptr = _build.stream_ptr(dev), _build.ptr
    b, p, hd = qs.shape
    h = hd // DH
    common = (ptr(qs), ptr(k), ptr(v), ptr(seg), ptr(cos), ptr(sin))
    stream_common = (ptr(qs), ptr(k), ptr(v), ptr(seg), ptr(seg_k), ptr(cos), ptr(sin))
    # the band form on the same q and k, unrotated, no cos and sin
    band_common = (ptr(qs), ptr(k), ptr(v), ptr(seg), ptr(seg))
    tab = fa._tile_scratch(seg)
    delta = torch.empty_like(lse)
    dq, dk, dv = (torch.empty_like(qs) for _ in range(3))
    runs = {
        "flash_bwd_f32": lambda lib: lib.ggt_flash_bwd_f32(
            *common, ptr(out), ptr(lse), ptr(do), None, ptr(delta), ptr(dq), ptr(dk), ptr(dv), b,
            p, h, 0, stream),
        "flash_dq_f32": lambda lib: lib.ggt_flash_dq_f32(
            *common, ptr(out), ptr(lse), ptr(do), None, ptr(delta), ptr(dq), b, p, h, 0, bi,
            stream),
        "flash_dkv_f32": lambda lib: lib.ggt_flash_dkv_f32(
            *common, ptr(lse), ptr(delta), ptr(do), ptr(dk), ptr(dv), b, p, h, 0, bi, stream),
        "flash_dq_stream_f32": lambda lib: lib.ggt_flash_dq_stream_f32(
            *stream_common, ptr(out), ptr(lse), ptr(do), None, ptr(delta), ptr(dq), ptr(tab), b,
            p, h, 0, bi, stream),
        "flash_dkv_stream_f32": lambda lib: lib.ggt_flash_dkv_stream_f32(
            *stream_common, ptr(lse), ptr(delta), ptr(do), ptr(dk), ptr(dv), ptr(tab), b, p, h,
            0, bi, stream),
        "flash_bwd_band_f32": lambda lib: lib.ggt_flash_bwd_band_f32(
            *band_common, ptr(out), ptr(lse), ptr(do), None, ptr(delta), ptr(dq), ptr(dk),
            ptr(dv), ptr(tab), b, p, h, 0, bi, stream)}
    if bi:
        runs.pop("flash_bwd_f32")  # #3 takes no bit slots
    if seg_k is not seg or p > fa.MAX_P:
        for form in ("flash_dq_f32", "flash_dkv_f32"):  # one id array, P <= MAX_P
            runs.pop(form)
    if seg_k is not seg:
        runs.pop("flash_bwd_f32", None)
        runs.pop("flash_bwd_band_f32")
    runs = {form: run for form, run in runs.items() if form in entries}
    # each pair's key pass reads the delta of its query pass, which runs
    # before it in each library's turn; the digests read what each form
    # writes
    outs = {"flash_bwd_f32": (dq, dk, dv), "flash_dq_f32": (dq, delta),
            "flash_dkv_f32": (dk, dv), "flash_dq_stream_f32": (dq, delta),
            "flash_dkv_stream_f32": (dk, dv), "flash_bwd_band_f32": (dq, dk, dv)}
    _probe_f32_turns(tag, libs, entries, runs, outs,
                     {form: f32_attention_bound(form, seg, h, bi, seg_k) for form in runs})


def f32_bound_ms(nbytes: float, flops: float) -> float:
    return max(nbytes / PEAK_BYTES, flops / PEAK_F32_ACCURATE_FLOPS) * 1e3


def f32_attention_bound(form: str, seg, h: int, bi: int, seg_k=None) -> float:
    """The bound (ms) of an fp32 attention form on these rows, bidirectional
    or with `bi` bit slots, the key ids seg_k (seg's where None): its
    operations over the visible pairs, its bytes each token-major tensor,
    the ids, cos, sin and the fp32 rows once."""
    products, tensors, rows = F32_WORK[F32_KIND[form]]
    b, p = seg.shape
    pairs = int(fa._valid_mask(seg, False, bi, seg_k).sum().item())
    nbytes = tensors * b * p * h * DH * 4 + b * p * 4 + 2 * b * p * DH * 4 + rows * b * h * p * 4
    return f32_bound_ms(nbytes, 2.0 * products * DH * h * pairs)


def _probe_f32_turns(tag, libs, entries, runs, outs, bounds, skip=frozenset()) -> None:
    """Time each form of `runs` in each library that has it (but the pairs
    (form, library name) of `skip`), then launch it once on zeroed outputs
    (`outs[form]`, the tensors its digest reads); each line ends with the
    form's bound (`bounds[form]`, ms)."""
    order = list(libs.items())
    for turn in (order, order[::-1]):
        for name, lib in turn:
            for form, run in runs.items():
                if not hasattr(lib, entries[form][0]) or (form, name) in skip:
                    continue
                t = cuda_ms(lambda: _build.check(run(lib), f"{form} {name}"))
                for x in outs[form]:
                    x.zero_()
                _build.check(run(lib), f"{form} {name}")
                print(f"{tag}: {name:8s} {form} {t:.4f} ms  digest {f32_digest(*outs[form])}  "
                      f"bound {bounds[form]:.4f} ms", flush=True)


def inputs(b, p, h, bi, layout, dev, dtype=torch.bfloat16, fwd=None):
    """q (pre-scaled), k, v, do, seg, cos, sin, and the forward's out and lse,
    in `dtype` (the forms' working type: bf16, or fp32 for the fp32 forms),
    drawn by numpy from seed 0. out and lse: in bf16 the forward kernels'
    (flash_fwd); in fp32 the plain forward in float64 rounded to fp32
    (plain_fwd64), which no kernel's redesign moves, so that the digests of
    the backward forms read only their own bodies; or fwd(qs, k, v, seg,
    cos, sin, bi)'s where given."""
    rng = np.random.default_rng(0)

    def draw(scale):
        x = rng.normal(size=(b, p, h * DH)) * scale
        return torch.from_numpy(x.astype(np.float32)).to(dev, dtype)

    qs, k, v, do = draw(0.5 * DH**-0.5), draw(0.5), draw(0.5), draw(0.5)
    seg = torch.from_numpy(_segments(b, p, bi, layout, rng)).to(dev)
    pos = torch.arange(p, device=dev).expand(b, p)
    cos, sin = (t.to(dtype) for t in rope_cos_sin(pos, DH))
    if fwd is not None:
        out, lse = fwd(qs, k, v, seg, cos, sin, bi)
    elif dtype == torch.float32:
        out, lse = plain_fwd64(qs, k, v, seg, cos, sin, bi)
    else:
        out, lse = fa.flash_fwd(qs, k, v, seg, cos, sin, False, DH, bi)
    return qs, k, v, do, seg, cos, sin, out, lse


def plain_fwd64(qs, k, v, seg, cos, sin, bi: int):
    """(out, lse) of the bidirectional (or `bi` bit slots) forward in float64,
    RoPE included, fa.REF_ROWS query rows at a time, rounded to fp32: out 0
    and lse -1e30 on a padded row."""
    b, p, hd = qs.shape
    h = hd // DH

    def heads(t):
        return t.double().reshape(b, p, h, DH).transpose(1, 2)

    c64, s64 = cos.double(), sin.double()
    q4 = heads(fa.rotate_tokens(qs.double(), c64, s64, DH))
    k4 = heads(fa.rotate_tokens(k.double(), c64, s64, DH))
    v4 = heads(v)
    outs, lses = [], []
    for i in range(0, p, fa.REF_ROWS):
        rows = slice(i, i + fa.REF_ROWS)
        s = q4[:, :, rows] @ k4.transpose(-1, -2)
        s = s.masked_fill(~fa._valid_mask(seg, False, bi, None, rows), float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        live = (m > float("-inf")) & (seg[:, rows] > 0)[:, None, :, None]
        e = torch.exp(s - torch.where(live, m, 0.0))
        l = torch.where(live, e.sum(dim=-1, keepdim=True), 1.0)
        outs.append(torch.where(live, (e @ v4) / l, 0.0))
        lses.append(torch.where(live, m + torch.log(l), fa.NEG_INF)[..., 0])
        del s, e
    out = torch.cat(outs, dim=2).transpose(1, 2).reshape(b, p, hd)
    return out.float().contiguous(), torch.cat(lses, dim=2).float().contiguous()


def f32_form_digest(form, shape, dev, fwd=None) -> int:
    """The digest of the fp32 `form` (#1f, #3f, #4f, #5f, a stream form or
    #9f) through its wrapper at `inputs`' fp32 draws of `shape`
    (BWD_F32_SHAPES); the backward forms read `inputs`' out and lse (fwd:
    see there), the stream forms and #9f take the query ids as key ids, #9f
    q and k unrotated."""
    b, p, h, bi, layout = BWD_F32_SHAPES[shape]
    qs, k, v, do, seg, cos, sin, out, lse = inputs(b, p, h, bi, layout, dev, torch.float32, fwd)
    stream = form.endswith("_stream_f32")
    if form == "flash_fwd_band_f32":
        outs = fa.flash_fwd_band(qs, k, v, seg, seg, False, DH, bi)
    elif form in ("flash_fwd_f32", "flash_fwd_stream_f32"):
        outs = (fa.flash_fwd_stream(qs, k, v, seg, seg, cos, sin, False, DH, bi) if stream
                else fa.flash_fwd(qs, k, v, seg, cos, sin, False, DH, bi))
    elif form == "flash_bwd_f32":
        outs = fa.flash_bwd(qs, k, v, seg, cos, sin, out, lse, do, None, False, DH)
    else:
        pair = ((fa.flash_dq_stream, fa.flash_dkv_stream) if stream
                else (fa.flash_dq, fa.flash_dkv))
        ids = (seg, seg) if stream else (seg,)
        dq, delta = pair[0](qs, k, v, *ids, cos, sin, out, lse, do, None, False, DH, bi)
        outs = ((dq, delta) if form.startswith("flash_dq")
                else pair[1](qs, k, v, *ids, cos, sin, lse, delta, do, False, DH, bi))
    torch.cuda.synchronize()
    return f32_digest(*outs)


def print_pins(source_lib, dev) -> None:
    """The pinned digests (F32_BWD_PINNED, F32_FWD_PINNED) of the package's
    builds; beside each backward form's, its digest on the out and lse of
    `source_lib`'s forward (its #1f's entry up to MAX_P, its #6f's above, as
    flash_fwd dispatches), and beside #9f's, `source_lib`'s #9f's."""
    stream = _build.stream_ptr(dev)
    ptr = _build.ptr

    def source_fwd(qs, k, v, seg, cos, sin, bi):
        b, p, hd = qs.shape
        out = torch.empty_like(qs)
        lse = torch.empty(b, hd // DH, p, device=dev)
        if p <= fa.MAX_P:
            err = source_lib.ggt_flash_fwd_f32(ptr(qs), ptr(k), ptr(v), ptr(seg), ptr(cos),
                                               ptr(sin), ptr(out), ptr(lse), b, p, hd // DH,
                                               0, bi, stream)
        else:
            err = source_lib.ggt_flash_fwd_stream_f32(
                ptr(qs), ptr(k), ptr(v), ptr(seg), ptr(seg), ptr(cos), ptr(sin), ptr(out),
                ptr(lse), ptr(fa._tile_scratch(seg)), b, p, hd // DH, 0, bi, stream)
        _build.check(err, "the --source forward")
        return out, lse

    for form, shape in F32_BWD_PINNED:
        theirs = f32_form_digest(form, shape, dev, source_fwd) if source_lib else None
        print(f"pin {form} [{shape}]: {f32_form_digest(form, shape, dev)}  on the --source "
              f"forward's out and lse: {theirs}", flush=True)
    for form, shape in F32_FWD_PINNED:
        theirs = None
        if source_lib is not None and form == "flash_fwd_band_f32":
            b, p, h, bi, layout = BWD_F32_SHAPES[shape]
            qs, k, v, _, seg, _, _, out, lse = inputs(b, p, h, bi, layout, dev, torch.float32,
                                                      lambda *a: (None, None))
            out, lse = torch.empty_like(qs), torch.empty(b, h, p, device=dev)
            _build.check(source_lib.ggt_flash_fwd_band_f32(
                ptr(qs), ptr(k), ptr(v), ptr(seg), ptr(seg), ptr(out), ptr(lse),
                ptr(fa._tile_scratch(seg)), b, p, h, 0, bi, stream), "the --source #9f")
            torch.cuda.synchronize()
            theirs = f32_digest(out, lse)
        print(f"pin {form} [{shape}]: {f32_form_digest(form, shape, dev)}  --source's: {theirs}",
              flush=True)


def cuda_ms(fn, iters: int = 30, repeats: int = 5) -> float:
    for _ in range(3):
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
    return float(np.median(readings))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", default="split", choices=sorted(KERNELS))
    ap.add_argument("--source", default=None)
    ap.add_argument("--variants", default=None)
    ap.add_argument("--pins", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("split_probe needs a CUDA card")
    file, variants = KERNELS[args.kernel]
    source = args.source or str(_build.CSRC / file)
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0), flush=True)
    if args.pins:
        if args.kernel != "fwd_f32":
            raise SystemExit("--pins goes with --kernel fwd_f32")
        print_pins(build(args.kernel, open(source).read(), ["base"],
                         Path(source).resolve().parent, label="fwd_f32_source")["base"]
                   if args.source else None, dev)
        return
    if args.kernel in ("split_f32", "mlp_f32", "fwd_f32"):
        # the package's body (its variants), fwd_f32's band form, and the
        # --source body beside them in the same turns
        libs = build(args.kernel, (_build.CSRC / file).read_text(),
                     (args.variants or "base").split(","), _build.CSRC)
        if args.kernel == "fwd_f32":
            libs["band"] = build(args.kernel, (_build.CSRC / "flash_fwd_f32.cu").read_text(),
                                 ["base"], _build.CSRC, label="fwd_f32_band")["base"]
        if args.source:
            libs["source"] = build(args.kernel, open(source).read(), ["base"],
                                   Path(source).resolve().parent,
                                   label=f"{args.kernel}_source")["base"]
        if args.source and args.kernel == "mlp_f32":
            for entry, argtypes in FFMA_F32_ARGTYPES.items():
                if hasattr(libs["source"], entry):
                    getattr(libs["source"], entry).argtypes = argtypes
    else:
        libs = build(args.kernel, open(source).read(),
                     (args.variants or ",".join(variants)).split(","),
                     Path(source).resolve().parent)
    if args.kernel in INLINE and args.kernel not in F32_ENTRIES:
        probe_mlp(args.kernel, libs, dev)
        return
    if args.kernel in F32_ENTRIES:
        probe_f32(args.kernel, libs, dev)
        return
    if args.kernel == "rmsnorm_bwd":
        # the first body, which sums its 1,056-row scratch one row after
        # another, takes its own grid
        probe_rms(libs, dev, "for (int b = 0; b < blocks; ++b)" in open(source).read())
        return
    stream = _build.stream_ptr(dev)
    ptr = _build.ptr
    for tag, (b, p, h, bi, layout) in SHAPES[args.kernel].items():
        qs, k, v, do, seg, cos, sin, out, lse = inputs(b, p, h, bi, layout, dev)
        delta = torch.zeros_like(lse)
        dq, dk, dv = (torch.empty_like(qs) for _ in range(3))
        tab = fa._tile_scratch(seg)
        o2, l2 = torch.empty_like(out), torch.empty_like(lse)
        order = list(libs.items())
        for turn in (order, order[::-1]):
            for name, lib in turn:
                def run_dq(lib=lib):
                    lib.ggt_flash_dq(ptr(qs), ptr(k), ptr(v), ptr(seg), ptr(cos), ptr(sin),
                                     ptr(out), ptr(lse), ptr(do), None, ptr(delta), ptr(dq),
                                     b, p, h, 0, bi, stream)

                def run_dkv(lib=lib):
                    lib.ggt_flash_dkv(ptr(qs), ptr(k), ptr(v), ptr(seg), ptr(cos), ptr(sin),
                                      ptr(lse), ptr(delta), ptr(do), ptr(dk), ptr(dv),
                                      b, p, h, 0, bi, stream)

                def run_dq_stream(lib=lib):
                    lib.ggt_flash_dq_stream(ptr(qs), ptr(k), ptr(v), ptr(seg), ptr(seg), ptr(cos),
                                            ptr(sin), ptr(out), ptr(lse), ptr(do), None,
                                            ptr(delta), ptr(dq), ptr(tab), b, p, h, 0, bi, stream)

                def run_dkv_stream(lib=lib):
                    lib.ggt_flash_dkv_stream(ptr(qs), ptr(k), ptr(v), ptr(seg), ptr(seg),
                                             ptr(cos), ptr(sin), ptr(lse), ptr(delta), ptr(do),
                                             ptr(dk), ptr(dv), ptr(tab), b, p, h, 0, bi, stream)

                def run_fwd(lib=lib):
                    lib.ggt_flash_fwd(ptr(qs), ptr(k), ptr(v), ptr(seg), ptr(cos), ptr(sin),
                                      ptr(o2), ptr(l2), b, p, h, 0, bi, stream)

                def run_fwd_stream(lib=lib):
                    lib.ggt_flash_fwd_stream(ptr(qs), ptr(k), ptr(v), ptr(seg), ptr(seg),
                                             ptr(cos), ptr(sin), ptr(o2), ptr(l2), ptr(tab), b, p,
                                             h, 0, bi, stream)

                def run_fwd_band(lib=lib):
                    lib.ggt_flash_fwd_band(ptr(qs), ptr(k), ptr(v), ptr(seg), ptr(seg), ptr(o2),
                                           ptr(l2), ptr(tab), b, p, h, 0, bi, stream)

                def run_bwd(lib=lib):
                    lib.ggt_flash_bwd(ptr(qs), ptr(k), ptr(v), ptr(seg), ptr(cos), ptr(sin),
                                      ptr(out), ptr(lse), ptr(do), None, ptr(delta), ptr(dq),
                                      ptr(dk), ptr(dv), b, p, h, 0, stream)

                def run_bwd_band(lib=lib):
                    lib.ggt_flash_bwd_band(ptr(qs), ptr(k), ptr(v), ptr(seg), ptr(seg), ptr(out),
                                           ptr(lse), ptr(do), None, ptr(delta), ptr(dq), ptr(dk),
                                           ptr(dv), ptr(tab), b, p, h, 0, 0, stream)

                if args.kernel in ("split", "stream"):
                    one, two = ((run_dq, run_dkv) if args.kernel == "split"
                                else (run_dq_stream, run_dkv_stream))
                    tq, tkv = cuda_ms(one), cuda_ms(two)
                    # the outputs of one launch of each on fresh buffers
                    for t in (delta, dq, dk, dv):
                        t.zero_()
                    one()
                    two()
                    digest = sum(t.view(torch.int16).long().sum().item() for t in (dq, dk, dv))
                    digest += delta.view(torch.int32).long().sum().item()
                    kn = "flash_dq" if args.kernel == "split" else "flash_dq_stream"
                    print(f"{tag}: {name:8s} {kn} {tq:.4f} ms  {kn.replace('dq', 'dkv')} "
                          f"{tkv:.4f} ms  pair {tq + tkv:.4f} ms  digest {digest}", flush=True)
                elif args.kernel == "fwd":
                    runs = {"flash_fwd": run_fwd, "flash_fwd_stream": run_fwd_stream,
                            "flash_fwd_band": run_fwd_band}
                    for form, (entry, _) in FWD_FORMS.items():
                        if not hasattr(lib, entry):
                            continue
                        t = cuda_ms(runs[form])
                        # out and lse of one launch on fresh buffers
                        o2.zero_()
                        l2.zero_()
                        runs[form]()
                        digest = (o2.view(torch.int16).long().sum().item()
                                  + l2.view(torch.int32).long().sum().item())
                        print(f"{tag}: {name:8s} {form} {t:.4f} ms  digest {digest}", flush=True)
                else:
                    runs = {"flash_bwd": run_bwd, "flash_bwd_band": run_bwd_band}
                    for form, (entry, _, max_p) in BWD_FORMS.items():
                        if not hasattr(lib, entry) or (max_p and p > max_p) or (
                                form == "flash_bwd_band" and tag not in BWD_BAND_SHAPES):
                            continue
                        t = cuda_ms(runs[form])
                        # delta, dq, dk, dv of one launch on fresh buffers
                        for x in (delta, dq, dk, dv):
                            x.zero_()
                        runs[form]()
                        digest = sum(x.view(torch.int16).long().sum().item() for x in (dq, dk, dv))
                        digest += delta.view(torch.int32).long().sum().item()
                        print(f"{tag}: {name:8s} {form} {t:.4f} ms  digest {digest}", flush=True)


if __name__ == "__main__":
    main()
