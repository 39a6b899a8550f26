// Gated MLP without norm or residual, for Hopper.
//
// Replaces graphgpt_tpu/ops/mlp.py:82 _mlp_kernel (launched by
// _mlp_fwd_kernel_call :104 from fused_mlp :158), the MLP that the backbone
// takes when LayerScale or DropPath sits between the MLP and the residual
// (graphgpt_tpu/models/modeling.py:500-513):
//   out = (act(x @ Wg^T) * (x @ Wu^T)) @ Wd^T
// with the TPU kernel's rounding points: xg and xu rounded to bf16, the
// activation in fp32 and rounded, g = a * xu in bf16, the down product
// summed in fp32 and rounded once. Exact gelu through erff where the TPU
// kernel uses Abramowitz-Stegun (|err| <= 1.5e-7); tanh gelu; silu. x and
// out bf16 [N, D]; Wg, Wu [F, D] and Wd [D, F] bf16 in nn.Linear layout.
//
// What bounds it on the H100: operations. The three products are 2*3*N*D*F
// (116 GFLOP at N=8192, D=768, F=3072: 117 us at 989 TFLOP/s) against
// 2*N*D*2 + 3*D*F*2 bytes (39 MB: 12 us at 3.35 TB/s).
//
// Design: the two stages of mlp_common.cuh, with norm_mlp.cu's tiles and
// without its norm and residual. (a) gate_up: a 64x64 tile of g [N, F] per
// CTA, the gate and up products sharing the staged x tile, act * up in the
// epilogue; (b) down: a 64x64 tile of out per CTA, summed in fp32 over F.
// WMMA bf16 tiles, single-buffered; g makes one round trip through device
// memory. wgmma, TMA and keeping g on chip are later work.

#include "mlp_common.cuh"

// C entry for ctypes: both launches on `stream`; returns cudaGetLastError().
// g is caller-allocated scratch [N, F] bf16.
extern "C" int ggt_mlp(const void* x, const void* wg, const void* wu, const void* wd, void* g,
                       void* out, int N, int D, int F, int act, void* stream) {
  return gated_mlp::launch<false, false>(x, nullptr, wg, wu, wd, g, out, N, D, F, 0.f, act,
                                       stream);
}
