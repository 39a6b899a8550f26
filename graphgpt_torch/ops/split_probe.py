"""Where the time of the split attention backward goes: kernels #4
flash_dq and #5 flash_dkv (`csrc/flash_bwd_split.cu`) timed on the card
whole and with one phase of their body left out at a time, at the denoise
batch's shape (B 256 x P 88, 16 bit slots, a molecule and a padded
stretch a row) and at B 8 x P 1024 (packed rows, 16 bit slots).

A variant leaves a phase out by a text substitution in the source and is
built beside the package's own builds. Its outputs are wrong by design;
the time it saves is that phase's share:

  rope0    the RoPE of the in-place pass over each visiting stage (the pass
           warps still mark each stage ready)
  noglob   the own rows' segment ids and lse, loaded an item ahead
  noepi    the epilogue's TMA stores
  noexp    the exponential and the mask of the elementwise section
  stages2  a ring of 2 stages instead of 3 (outputs right)
  all      rope0, noglob, noepi and noexp together

    python3 -m graphgpt_torch.ops.split_probe [--source FILE] [--variants base,noexp]

--source probes another body of the file (one unpacked from an earlier
commit, say); a substitution that does not match it raises. Needs a CUDA
card and nvcc. Prints the card, then one line a shape and variant: the
medians of five CUDA-event readings of 30 launches each, every variant of
a shape in one turn, then again in the reverse order.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import numpy as np
import torch

from graphgpt_torch.models.rope import rope_cos_sin
from graphgpt_torch.ops import _build
from graphgpt_torch.ops import flash_attention as fa
from graphgpt_torch.synthetic import packed_segments

_ROPE0 = [("            if (args.rope) {\n              uint4 x = lds128",
           "            if (false) {\n              uint4 x = lds128")]
_NOGLOB = [("const int s0 = rows.s0, s1 = rows.s1;",
            "const int s0 = r0 < P ? 1 : 0, s1 = r1 < P ? 1 : 0;"),
           ("const float l2e0 = rows.lse0 * LOG2E, l2e1 = rows.lse1 * LOG2E;",
            "const float l2e0 = 5.f, l2e1 = 5.f;")]
_NOEPI = [("      tma_store_3d(&st1, box0, it.h * DH, wrow0, it.b);", "      (void)0;"),
          ("      if (DKV) tma_store_3d(&st2, box0 + HALF, it.h * DH, wrow0, it.b);",
           "      (void)0;")]
_NOEXP = [("const float pe = ex2(ok ? fmaf(sc[4 * j + e], LOG2E, -l2e) : -INFINITY);",
           "const float pe = sc[4 * j + e];")]
VARIANTS = {
    "base": [],
    "rope0": _ROPE0,
    "noglob": _NOGLOB,
    "noepi": _NOEPI,
    "noexp": _NOEXP,
    "stages2": [("constexpr int STAGES = 3;", "constexpr int STAGES = 2;")],
    "all": _ROPE0 + _NOGLOB + _NOEPI + _NOEXP,
}
SHAPES = {"denoise B256 P88": (256, 88, 12, 16, "denoise"), "B8 P1024": (8, 1024, 12, 16, "packed")}
DH = 64


def build(source: str, names) -> dict:
    """{variant: its C library}, one nvcc each, all at once."""
    out_dir = _build.BUILD_DIR.parent / "split_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = source
        for old, new in VARIANTS[name]:
            if old not in text:
                raise ValueError(f"variant {name}: {old!r} is not in the source")
            text = text.replace(old, new)
        src, lib = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
        src.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} did not build:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
        libs[name].ggt_flash_dq.argtypes = fa._DQ_ARGTYPES
        libs[name].ggt_flash_dkv.argtypes = fa._DKV_ARGTYPES
    return libs


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
    ap.add_argument("--source", default=str(_build.CSRC / "flash_bwd_split.cu"))
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("split_probe needs a CUDA card")
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0), flush=True)
    libs = build(open(args.source).read(), args.variants.split(","))
    stream = _build.stream_ptr(dev)
    for tag, (b, p, h, bi, layout) in SHAPES.items():
        qs, k, v, do, seg, cos, sin, out, lse = inputs(b, p, h, bi, layout, dev)
        delta = torch.zeros_like(lse)
        dq, dk, dv = (torch.empty_like(qs) for _ in range(3))
        ptr = _build.ptr
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

                tq, tkv = cuda_ms(run_dq), cuda_ms(run_dkv)
                print(f"{tag}: {name:8s} flash_dq {tq:.4f} ms  flash_dkv {tkv:.4f} ms  "
                      f"pair {tq + tkv:.4f} ms", flush=True)


if __name__ == "__main__":
    main()
