// Gated MLP without norm or residual, for Hopper: kernel #11 mlp.
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
// (116 GFLOP at N 8192, D 768, F 3072: 117 us at 989 TFLOP/s) against
// 2*N*D*2 + 3*D*F*2 bytes (39 MB: 12 us at 3.35 TB/s).
//
// Design: the two persistent TMA + wgmma stages of mlp_common.cuh without
// the norm and the residual: gate/up with A straight from the ring by
// descriptor and act x up in the epilogue, then down; g [N, F] makes one
// round trip through device memory.

#include "mlp_common.cuh"

namespace {

gated_mlp::Args args(const void* x, const void* wg, const void* wu, const void* wd, void* g,
                     void* out, int N, int D, int F, int bh, int bn, int act) {
  return {x, nullptr, wg, wu, wd, g, out, nullptr, N, D, F, bh, bn, act, 0.f};
}

}  // namespace

// C entries for ctypes; each returns the first CUDA error (0 when the
// launches were accepted), or one of mlp_common.cuh's codes above 999.
//
// ggt_mlp: both stages on `stream`; nothing for N 0. g is caller-allocated
// scratch [N, F] bf16; bh (128 or 64) divides F and bn (256, 192, 128 or 64)
// divides D; x and the weights 16-byte aligned.
extern "C" int ggt_mlp(const void* x, const void* wg, const void* wu, const void* wd, void* g,
                       void* out, int N, int D, int F, int bh, int bn, int act, void* stream) {
  using namespace gated_mlp;
  return run<false>(args(x, wg, wu, wd, g, out, N, D, F, bh, bn, act), GATE_UP | DOWN, stream);
}

// ggt_mlp_stages: the stages in `stages` alone (2 gate/up, 4 down), for
// timing them apart.
extern "C" int ggt_mlp_stages(const void* x, const void* wg, const void* wu, const void* wd,
                              void* g, void* out, int N, int D, int F, int bh, int bn, int act,
                              int stages, void* stream) {
  return gated_mlp::run<false>(args(x, wg, wu, wd, g, out, N, D, F, bh, bn, act), stages, stream);
}
