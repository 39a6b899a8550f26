// RMSNorm-fused gated MLP with its residual add, for Hopper: kernel #2
// norm_mlp.
//
// Replaces graphgpt_tpu/ops/mlp.py:203 _norm_mlp_kernel (launched by
// _norm_mlp_call :226 from fused_norm_mlp :253):
//   out = x + (act(hpre @ Wg^T) * (hpre @ Wu^T)) @ Wd^T,  hpre = rms(x) * wn
// with the TPU kernel's rounding points: RMS statistics in fp32, hpre, xg,
// xu, a = act(xg) and g = a * xu each rounded to bf16; both products
// accumulate in fp32; the residual is added in fp32 and the result rounded
// once. Activations: exact gelu through erff (not the TPU kernel's
// Abramowitz-Stegun erf), tanh gelu, silu. Weights are bf16 in nn.Linear
// layout ([out, in], row-major), x and out bf16 [N, D], wn fp32 [D].
//
// What bounds it on the H100: operations. At N 8192, D 768, F 3072 the
// three products are 116 GFLOP (117 us at 989 TFLOP/s) against ~39 MB of
// x, weights and out (12 us at 3.35 TB/s).
//
// Design: three launches. The rrms pre-pass of #12 (a warp a row) writes the
// fp32 statistics to scratch: hpre is rounded to bf16 before the product, so
// every row's rrms is needed before its first product, and computing it
// once a row spares each of the F / BH column tiles of a row tile from
// computing it again. Then the two persistent TMA + wgmma stages of
// mlp_common.cuh with the norm and the residual on: gate/up applies the norm
// to the register A operand as #12 does (hpre never reaches memory) and act
// x up in the epilogue; down adds the residual, loaded by TMA into the
// output staging tile, in fp32 before the one rounding. g [N, F] makes one
// round trip through device memory.

#include "mlp_common.cuh"

namespace {

gated_mlp::Args args(const void* x, const void* wn, const void* wg, const void* wu,
                     const void* wd, void* g, void* out, void* rrms, int N, int D, int F, int bh,
                     int bn, float eps, int act) {
  return {x, wn, wg, wu, wd, g, out, rrms, N, D, F, bh, bn, act, eps};
}

}  // namespace

// C entries for ctypes; each returns the first CUDA error (0 when the
// launches were accepted), or one of mlp_common.cuh's codes above 999.
//
// ggt_norm_mlp: the rrms pre-pass into `rrms` (fp32 [N] scratch) and both
// stages, on `stream`; nothing for N 0. g is caller-allocated scratch [N, F]
// bf16; D a multiple of 64, at most 8192; bh (128 or 64) divides F and bn
// (256, 192, 128 or 64) divides D; x and the weights 16-byte aligned.
extern "C" int ggt_norm_mlp(const void* x, const void* wn, const void* wg, const void* wu,
                            const void* wd, void* g, void* out, void* rrms, int N, int D, int F,
                            int bh, int bn, float eps, int act, void* stream) {
  using namespace gated_mlp;
  return run<true>(args(x, wn, wg, wu, wd, g, out, rrms, N, D, F, bh, bn, eps, act),
                   RRMS | GATE_UP | DOWN, stream);
}

// ggt_norm_mlp_stages: the stages in `stages` alone (1 the rrms pre-pass,
// 2 gate/up, 4 down), for timing them apart.
extern "C" int ggt_norm_mlp_stages(const void* x, const void* wn, const void* wg, const void* wu,
                                   const void* wd, void* g, void* out, void* rrms, int N, int D,
                                   int F, int bh, int bn, float eps, int act, int stages,
                                   void* stream) {
  return gated_mlp::run<true>(args(x, wn, wg, wu, wd, g, out, rrms, N, D, F, bh, bn, eps, act),
                              stages, stream);
}
