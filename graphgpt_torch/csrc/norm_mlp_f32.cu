// The gated MLP with RMSNorm and residual in fp32 for Hopper: #2's fp32
// form, x + down(act(gate(h)) * up(h)) with h = rms(x) * wn.
//
// Replaces graphgpt_tpu/ops/mlp.py:203 _norm_mlp_kernel when it is given
// fp32 (a `model.dtype: float32` model): its casts of hpre and the
// activation to x's dtype (:208, :217) then change nothing, its products
// sum in fp32, and the residual is added in fp32. The bf16 form is
// csrc/norm_mlp.cu; the fp32 forms of #11 and #12 are csrc/mlp_qkv_f32.cu
// (3xTF32 on the tensor cores). Same contract: x [N, D] fp32, wn [D]
// fp32, wg, wu [F, D] and wd [D, F] fp32 in nn.Linear layout; out [N, D]
// fp32; g [N, F] and rrms [N] fp32 scratch from the caller. Activations:
// exact gelu (erff), tanh gelu, silu. D and F multiples of 64.
//
// What bounds it on the H100: operations, 6 N D F of them (116 GFLOP at N
// 8192, D 768, F 3072) against ~0.2 GB of traffic. fp32-accurate products
// run at 165 TFLOP/s at best (3xTF32); this kernel's FFMA tops out at the
// 67 TFLOP/s of the fp32 cores.
//
// Design: simple and right first. Three launches: the rrms pre-pass (a
// warp a row); gate/up, a block of 256 threads a 64 x 64 tile of g that
// normalises each 64 x 16 slab of x as it lands in shared memory (x *
// rrms * wn, rounded as the plain version rounds it) and sums gate and up
// in two sets of FFMA accumulators, then writes act(gate) * up; down, the
// same tile product over g and wd with x added in the epilogue. Each
// output sums its k in order: the same bits on every launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16;  // output tile, and the k slab a step
constexpr int SLD = BK + 1;               // a slab's padded row stride, in floats
constexpr int THREADS = 256;              // 16 x 16, each 4 x 4 outputs

enum Act { GELU = 0, GELU_TANH = 1, SILU = 2 };

__device__ __forceinline__ float act_f32(int act, float x) {
  if (act == GELU) return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
  if (act == GELU_TANH)
    return 0.5f * x * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
  return x / (1.f + expf(-x));
}

// rrms[n] = 1 / sqrt(mean(x[n]^2) + eps), a warp a row
__global__ void __launch_bounds__(256)
rrms_kernel(const float* __restrict__ x, float* __restrict__ rrms, int N, int D, float eps) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= N) return;
  float ss = 0.f;
  for (int d = lane * 4; d < D; d += 128) {
    const float4 v = *reinterpret_cast<const float4*>(x + row * D + d);
    ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (lane == 0) rrms[row] = 1.f / sqrtf(ss / (float)D + eps);
}

// A 64 x 16 slab at (r0, k0) of a row-major [rows, K] matrix into shared
// memory [64][SLD]; rows past `rows` are 0. NORM: row r scaled as the
// plain version scales it, (x * rrms[r]) * wn[k], each product rounded.
template <bool NORM>
__device__ __forceinline__ void load_slab(float* dst, const float* src, int rows, int K, int r0,
                                          int k0, const float* rrms, const float* wn) {
  const int r = threadIdx.x >> 2, c = (threadIdx.x & 3) * 4;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if (r0 + r < rows) {
    const float4 t = *reinterpret_cast<const float4*>(src + (long long)(r0 + r) * K + k0 + c);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
    if (NORM) {
      const float s = rrms[r0 + r];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = __fmul_rn(__fmul_rn(v[u], s), wn[k0 + c + u]);
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) dst[r * SLD + c + u] = v[u];
}

// acc[i][j] += sum over the slab's 16 k of a(ty + 16 i, k) * b(tx + 16 j, k)
__device__ __forceinline__ void slab_mma(float (&acc)[4][4], const float* a, const float* b,
                                         int ty, int tx) {
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * SLD + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * SLD + k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// g[n, f] = act(h wg^T)[n, f] * (h wu^T)[n, f], h = rms(x) * wn; a block
// a 64 x 64 tile (blockIdx.x over F, blockIdx.y over N)
__global__ void __launch_bounds__(THREADS)
gate_up_kernel(const float* __restrict__ x, const float* __restrict__ wn,
               const float* __restrict__ wg, const float* __restrict__ wu,
               const float* __restrict__ rrms, float* __restrict__ g, int N, int D, int F,
               int act) {
  __shared__ float as[BM * SLD], gs[BN * SLD], us[BN * SLD];
  const int n0 = blockIdx.y * BM, f0 = blockIdx.x * BN;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float ag[4][4] = {}, au[4][4] = {};
  for (int k0 = 0; k0 < D; k0 += BK) {
    __syncthreads();
    load_slab<true>(as, x, N, D, n0, k0, rrms, wn);
    load_slab<false>(gs, wg, F, D, f0, k0, nullptr, nullptr);
    load_slab<false>(us, wu, F, D, f0, k0, nullptr, nullptr);
    __syncthreads();
    slab_mma(ag, as, gs, ty, tx);
    slab_mma(au, as, us, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty + 16 * i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) g[(long long)n * F + f0 + tx + 16 * j] = act_f32(act, ag[i][j]) * au[i][j];
  }
}

// out[n, d] = x[n, d] + (g wd^T)[n, d]; a block a 64 x 64 tile
__global__ void __launch_bounds__(THREADS)
down_kernel(const float* __restrict__ g, const float* __restrict__ wd,
            const float* __restrict__ x, float* __restrict__ out, int N, int D, int F) {
  __shared__ float as[BM * SLD], bs[BN * SLD];
  const int n0 = blockIdx.y * BM, d0 = blockIdx.x * BN;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < F; k0 += BK) {
    __syncthreads();
    load_slab<false>(as, g, N, F, n0, k0, nullptr, nullptr);
    load_slab<false>(bs, wd, D, F, d0, k0, nullptr, nullptr);
    __syncthreads();
    slab_mma(acc, as, bs, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty + 16 * i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long o = (long long)n * D + d0 + tx + 16 * j;
      out[o] = x[o] + acc[i][j];
    }
  }
}

}  // namespace

// C entry for ctypes: #2's fp32 form (the rrms pre-pass, gate/up, down) on
// `stream`; returns the first CUDA error (0 when the launches were
// accepted). g [N, F] and rrms [N] are fp32 scratch from the caller; D and
// F multiples of 64.
extern "C" int ggt_norm_mlp_f32(const void* x, const void* wn, const void* wg, const void* wu,
                                const void* wd, void* g, void* out, void* rrms, int N, int D,
                                int F, float eps, int act, void* stream) {
  if (D % BN != 0 || F % BN != 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  rrms_kernel<<<(N + 7) / 8, 256, 0, st>>>((const float*)x, (float*)rrms, N, D, eps);
  gate_up_kernel<<<dim3(F / BN, (N + BM - 1) / BM), THREADS, 0, st>>>(
      (const float*)x, (const float*)wn, (const float*)wg, (const float*)wu,
      (const float*)rrms, (float*)g, N, D, F, act);
  down_kernel<<<dim3(D / BN, (N + BM - 1) / BM), THREADS, 0, st>>>(
      (const float*)g, (const float*)wd, (const float*)x, (float*)out, N, D, F);
  return (int)cudaGetLastError();
}
