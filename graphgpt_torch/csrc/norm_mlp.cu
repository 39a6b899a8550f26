// RMSNorm-fused gated MLP with its residual add, for Hopper.
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
// What bounds it on the H100: operations. At N=8192, D=768, F=3072 the
// three products are 116 GFLOP (117 us at 989 TFLOP/s) against ~39 MB of
// x, weights and out (12 us at 3.35 TB/s).
//
// Design: two launches, the stages of mlp_common.cuh with the norm and the
// residual on. (a) gate_up: a 64x64 tile of g [N, F] per CTA; the CTA
// computes the RMS statistics of its 64 rows first, then normalises x while
// staging each 64x32 A tile, so hpre never reaches device memory; the gate
// and up products share that A tile; the epilogue applies act * up and
// writes g in bf16. (b) down: a 64x64 tile of out per CTA, g @ Wd^T with the
// residual added in fp32 in the epilogue. g makes one round trip through
// device memory (2 x 50 MB at the shape above); keeping it on chip in one
// fused launch, and wgmma with TMA pipelines, are later work.

#include "mlp_common.cuh"

// C entry for ctypes: both launches on `stream`; returns cudaGetLastError().
// g is caller-allocated scratch [N, F] bf16.
extern "C" int ggt_norm_mlp(const void* x, const void* wn, const void* wg, const void* wu,
                            const void* wd, void* g, void* out, int N, int D, int F,
                            float eps, int act, void* stream) {
  return gated_mlp::launch<true, true>(x, wn, wg, wu, wd, g, out, N, D, F, eps, act, stream);
}
