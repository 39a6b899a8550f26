"""Where the time of the Hopper kernels goes: the split backward #4
flash_dq and #5 flash_dkv (`csrc/flash_bwd_split.cu`, the default), the
same body's stream form #7 flash_dq_stream and #8 flash_dkv_stream
(`--kernel stream`), the forward #1 (`--kernel fwd`, `csrc/flash_fwd.cu`),
the fused backward #3 (`--kernel bwd`, `csrc/flash_bwd.cu`) and the gated
MLPs #11 and #2 (`--kernel mlp`, `--kernel norm_mlp`: `csrc/mlp.cu`,
`csrc/norm_mlp.cu` with `csrc/mlp_common.cuh`), timed on the card whole
and with one phase of their body left out at a time, at their paths'
shapes: the denoise batch (B 256 x P 88, 16 bit slots, a molecule and a
padded stretch a row), the fine-tune batch (B 256 x P 72, a molecule a
row), B 8 and B 64 x P 1024 and the long-context batch B 16 x P 4096
(packed rows, the key ids the query ids); the MLPs at N 8,192 and 65,536
rows (D 768, F 3,072, gelu), whole and each stage alone.

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
  nocons   the consumers' products and softmax (fwd: what is left is the
           loads, the in-place pass, the barriers and the epilogue)
  nodelta  the delta launch before the main kernel (bwd)
  dqonly   the query role alone (bwd: no dk, dv)
  dkvonly  the key role alone (bwd: no dq)
  shfl     the walkers' tile ranges by tile_range's shuffles instead of
           redux.sync (fwd, bwd; outputs right); stream: the masks and the
           visiting tiles' ranges from the ids by tile_range's shuffles (the
           single form's way) instead of the tile tables (outputs right, the
           key ids being the query ids)
  stages2  a ring of 2 stages instead of 3 (fwd: of 4) (outputs right)
  stages3  a ring of 3 stages instead of 4 (fwd; outputs right)
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

    python3 -m graphgpt_torch.ops.split_probe
        [--kernel split|stream|fwd|bwd|mlp|norm_mlp] [--source FILE]
        [--variants base,noexp]

--source probes another body of the file (one unpacked from an earlier
commit, say); a substitution that does not match it raises. Needs a CUDA
card and nvcc. Prints the card, then one line a shape and variant: the
medians of five CUDA-event readings of 30 launches each, every variant of
a shape in one turn, then again in the reverse order; the split and stream
lines end with a digest of dq, delta, dk and dv, so that two bodies that
should give the same bits (one --source against another) show it.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess

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
_FWD_NOMASK = [("sc[4 * j + e] = ok ? sc[4 * j + e] : -INFINITY;", "(void)ok;")]
_BWD_NOEPI = [("    tma_store_3d(DKV ? &mp.dk : &mp.dq, box0, it.h * DH, wrow0, it.b);",
               "    (void)0;"),
              ("    if (DKV) tma_store_3d(&mp.dv, box0 + HALF, it.h * DH, wrow0, it.b);",
               "    (void)0;")]
_BWD_NODELTA = [("  delta_kernel<<<", "  if (false) delta_kernel<<<")]


def _drop(role):
    """The three calls of one role of the fused backward, left out."""
    return [(f"        produce<{role}>(", f"        if (false) produce<{role}>("),
            (f"        pass_role<{role}>(", f"        if (false) pass_role<{role}>("),
            (f"    consume<{role}>(", f"    if (false) consume<{role}>(")]


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
        "nomask": _FWD_NOMASK, "nocons": _FWD_NOCONS, "shfl": _FWD_SHFL,
        "stages2": _FWD_STAGES[2], "stages3": _FWD_STAGES[3],
        "all": _ROPE0_SM90 + _FWD_NOEPI + _FWD_NOEXP + _FWD_NOMASK}),
    "bwd": ("flash_bwd.cu", {
        "base": [], "rope0": _ROPE0_SM90, "noepi": _BWD_NOEPI, "noexp": _NOEXP,
        "nodelta": _BWD_NODELTA, "dqonly": _drop("true"), "dkvonly": _drop("false"),
        "shfl": _BWD_SHFL,
        "stages2": _STAGES2, "all": _ROPE0_SM90 + _BWD_NOEPI + _NOEXP + _BWD_NODELTA}),
    "mlp": ("mlp.cu", {"base": [], "nocons": _MLP_NOCONS, "noact": _MLP_NOACT,
                       "bf16x2": _MLP_BF16X2}),
    "norm_mlp": ("norm_mlp.cu", {
        "base": [], "nocons": _MLP_NOCONS, "nonorm": _MLP_NONORM, "noact": _MLP_NOACT,
        "nores": _MLP_NORES, "nopre": _MLP_NOPRE, "bf16x2": _MLP_BF16X2,
        "wnglobal": _MLP_WNGLOBAL}),
}
# the header a kernel's source includes, put in place before the substitutions
INLINE = {"mlp": "mlp_common.cuh", "norm_mlp": "mlp_common.cuh"}
VARIANTS = KERNELS["split"][1]
# (B, P, H, bit slots, row layout) of each kernel's shapes
SHAPES = {
    "split": {"denoise B256 P88": (256, 88, 12, 16, "denoise"),
              "B8 P1024": (8, 1024, 12, 16, "packed")},
    "stream": {"B16 P4096": (16, 4096, 12, 0, "packed")},
    "fwd": {"denoise B256 P88": (256, 88, 12, 16, "denoise"),
            "finetune B256 P72": (256, 72, 12, 0, "molecule"),
            "B8 P1024": (8, 1024, 12, 0, "packed"), "B64 P1024": (64, 1024, 12, 0, "packed")},
    "bwd": {"finetune B256 P72": (256, 72, 12, 0, "molecule"),
            "B8 P1024": (8, 1024, 12, 0, "packed"), "B64 P1024": (64, 1024, 12, 0, "packed")},
}
MLP_SHAPES = {"N8192": (8192, 768, 3072), "N65536": (65536, 768, 3072)}  # (N, D, F)
DH = 64


def build(kernel: str, source: str, names) -> dict:
    """{variant: its C library}, one nvcc each, all at once."""
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
        src, lib = out_dir / f"{kernel}_{name}.cu", out_dir / f"lib{kernel}_{name}.so"
        src.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib), str(src)]
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
            libs[name].ggt_flash_fwd.argtypes = fa._ARGTYPES
        elif kernel == "bwd":
            libs[name].ggt_flash_bwd.argtypes = fa._BWD_ARGTYPES
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


def inputs(b, p, h, bi, layout, dev):
    """q (pre-scaled), k, v, do, seg, cos, sin, and the forward's out and lse."""
    rng = np.random.default_rng(0)

    def draw(scale):
        x = rng.normal(size=(b, p, h * DH)) * scale
        return torch.from_numpy(x.astype(np.float32)).to(dev, torch.bfloat16)

    qs, k, v, do = draw(0.5 * DH**-0.5), draw(0.5), draw(0.5), draw(0.5)
    if layout == "denoise":
        seg = np.zeros((b, p), np.int32)
        for r in range(b):
            seg[r, : int(rng.integers(10, p - bi))] = 1
            seg[r, p - bi:] = 1
    elif layout == "molecule":
        seg = np.zeros((b, p), np.int32)
        for r in range(b):
            seg[r, : int(rng.integers(10, p + 1))] = 1
    else:
        seg = packed_segments(b, p, rng)
    seg = torch.from_numpy(seg).to(dev)
    pos = torch.arange(p, device=dev).expand(b, p)
    cos, sin = (t.to(torch.bfloat16) for t in rope_cos_sin(pos, DH))
    out, lse = fa.flash_fwd(qs, k, v, seg, cos, sin, False, DH, bi)
    return qs, k, v, do, seg, cos, sin, out, lse


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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("split_probe needs a CUDA card")
    file, variants = KERNELS[args.kernel]
    source = args.source or str(_build.CSRC / file)
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0), flush=True)
    libs = build(args.kernel, open(source).read(),
                 (args.variants or ",".join(variants)).split(","))
    if args.kernel in INLINE:
        probe_mlp(args.kernel, libs, dev)
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

                def run_bwd(lib=lib):
                    lib.ggt_flash_bwd(ptr(qs), ptr(k), ptr(v), ptr(seg), ptr(cos), ptr(sin),
                                      ptr(out), ptr(lse), ptr(do), None, ptr(delta), ptr(dq),
                                      ptr(dk), ptr(dv), b, p, h, 0, stream)

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
                else:
                    t = cuda_ms(run_fwd if args.kernel == "fwd" else run_bwd)
                    kname = "flash_fwd" if args.kernel == "fwd" else "flash_bwd"
                    print(f"{tag}: {name:8s} {kname} {t:.4f} ms", flush=True)


if __name__ == "__main__":
    main()
