// The gated MLP in fp32 for Hopper, in two forms of one body: #2's fp32
// form, x + down(act(gate(h)) * up(h)) with h = rms(x) * wn, and #11's,
// down(act(gate(x)) * up(x)) with no norm and no residual; and on the same
// pieces #12's fp32 form, the norm-fused projections (q, k, v) = h (Wq |
// Wk | Wv)^T.
//
// Replaces graphgpt_tpu/ops/mlp.py:203 _norm_mlp_kernel, :82 _mlp_kernel
// and :315 _norm_qkv_kernel when they are given fp32 (a `model.dtype:
// float32` model): their casts of hpre and the activation to x's dtype
// (:208, :217; :88; :320) then change nothing, their products sum in fp32,
// and #2's residual is added in fp32. The bf16 forms are csrc/norm_mlp.cu,
// csrc/mlp.cu and csrc/norm_qkv.cu. Same contracts: x [N, D] fp32, wn [D]
// fp32 (#2, #12), wg, wu [F, D] and wd [D, F] fp32 in nn.Linear layout;
// out [N, D] fp32; g [N, F] and rrms [N] (#2, #12) fp32 scratch from the
// caller. Activations: exact gelu (erff), tanh gelu, silu. D and F
// multiples of 64. #12: wq, wk, wv [Fq | Fk | Fv, D] fp32 (GQA's k and v
// narrower than q), each width a multiple of 64; q, k, v [N, width] fp32.
//
// What bounds it on the H100: operations, 6 N D F of them (116 GFLOP at N
// 8192, D 768, F 3072) against ~0.2 GB of traffic; #12's 2 N D (Fq + Fk +
// Fv) (29.0 GFLOP at N 8,192, D 768, widths 3 x 768) against ~0.1 GB.
// fp32-accurate products run at 165 TFLOP/s at best (3xTF32); this
// kernel's FFMA tops out at the 67 TFLOP/s of the fp32 cores.
//
// Design: simple and right first. #2: three launches, the rrms pre-pass (a
// warp a row); gate/up, a block of 256 threads a 64 x 64 tile of g that
// normalises each 64 x 16 slab of x as it lands in shared memory (x *
// rrms * wn, rounded as the plain version rounds it) and sums gate and up
// in two sets of FFMA accumulators, then writes act(gate) * up; down, the
// same tile product over g and wd with x added in the epilogue. #11: the
// same gate/up and down without the pre-pass, the norm and the residual;
// each difference is an `if constexpr` on the form, so #2's instances are
// the code they were before #11 joined them. #12: two launches, #2's rrms
// pre-pass, then a kernel of its own on #2's gate/up pieces (the same slab
// loads, the norm applied as each slab of x lands, the same FFMA slab
// product) with one accumulator set and no activation: a block a 64 x 64
// tile of the three outputs side by side, which never straddles two of
// them, so #2's and #11's kernels are not touched. Each output sums its k
// in order: the same bits on every launch.

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

// g[n, f] = act(h wg^T)[n, f] * (h wu^T)[n, f], h = rms(x) * wn with NORM,
// else x; a block a 64 x 64 tile (blockIdx.x over F, blockIdx.y over N)
template <bool NORM>
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
    load_slab<NORM>(as, x, N, D, n0, k0, rrms, wn);
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

// (q | k | v)[n, f] = (h (wq | wk | wv)^T)[n, f], h = rms(x) * wn; a block
// a 64 x 64 tile (blockIdx.x over Fq + Fk + Fv, blockIdx.y over N), the
// output and weight of its columns picked by where they start
__global__ void __launch_bounds__(THREADS)
qkv_kernel(const float* __restrict__ x, const float* __restrict__ wn,
           const float* __restrict__ wq, const float* __restrict__ wk,
           const float* __restrict__ wv, const float* __restrict__ rrms, float* __restrict__ q,
           float* __restrict__ k, float* __restrict__ v, int N, int D, int Fq, int Fk, int Fv) {
  __shared__ float as[BM * SLD], ws[BN * SLD];
  const int n0 = blockIdx.y * BM;
  int f0 = blockIdx.x * BN, F = Fq;
  const float* w = wq;
  float* out = q;
  if (f0 >= Fq + Fk) {
    f0 -= Fq + Fk, F = Fv, w = wv, out = v;
  } else if (f0 >= Fq) {
    f0 -= Fq, F = Fk, w = wk, out = k;
  }
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < D; k0 += BK) {
    __syncthreads();
    load_slab<true>(as, x, N, D, n0, k0, rrms, wn);
    load_slab<false>(ws, w, F, D, f0, k0, nullptr, nullptr);
    __syncthreads();
    slab_mma(acc, as, ws, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty + 16 * i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) out[(long long)n * F + f0 + tx + 16 * j] = acc[i][j];
  }
}

// out[n, d] = x[n, d] + (g wd^T)[n, d] with RESID, else (g wd^T)[n, d]; a
// block a 64 x 64 tile
template <bool RESID>
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
      if constexpr (RESID)
        out[o] = x[o] + acc[i][j];
      else
        out[o] = acc[i][j];
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
  gate_up_kernel<true><<<dim3(F / BN, (N + BM - 1) / BM), THREADS, 0, st>>>(
      (const float*)x, (const float*)wn, (const float*)wg, (const float*)wu,
      (const float*)rrms, (float*)g, N, D, F, act);
  down_kernel<true><<<dim3(D / BN, (N + BM - 1) / BM), THREADS, 0, st>>>(
      (const float*)g, (const float*)wd, (const float*)x, (float*)out, N, D, F);
  return (int)cudaGetLastError();
}

// C entry for ctypes: #11's fp32 form (gate/up, then down; no norm, no
// residual) on `stream`; returns the first CUDA error (0 when the launches
// were accepted). g [N, F] is fp32 scratch from the caller; D and F
// multiples of 64.
extern "C" int ggt_mlp_f32(const void* x, const void* wg, const void* wu, const void* wd,
                           void* g, void* out, int N, int D, int F, int act, void* stream) {
  if (D % BN != 0 || F % BN != 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  gate_up_kernel<false><<<dim3(F / BN, (N + BM - 1) / BM), THREADS, 0, st>>>(
      (const float*)x, nullptr, (const float*)wg, (const float*)wu, nullptr, (float*)g, N, D, F,
      act);
  down_kernel<false><<<dim3(D / BN, (N + BM - 1) / BM), THREADS, 0, st>>>(
      (const float*)g, (const float*)wd, nullptr, (float*)out, N, D, F);
  return (int)cudaGetLastError();
}

// C entry for ctypes: #12's fp32 form (the rrms pre-pass, then the three
// products) on `stream`; returns the first CUDA error (0 when the launches
// were accepted). rrms [N] is fp32 scratch from the caller; D, Fq, Fk and
// Fv multiples of 64.
extern "C" int ggt_norm_qkv_f32(const void* x, const void* wn, const void* wq, const void* wk,
                                const void* wv, void* q, void* k, void* v, void* rrms, int N,
                                int D, int Fq, int Fk, int Fv, float eps, void* stream) {
  if (D % BN != 0 || Fq % BN != 0 || Fk % BN != 0 || Fv % BN != 0)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  rrms_kernel<<<(N + 7) / 8, 256, 0, st>>>((const float*)x, (float*)rrms, N, D, eps);
  qkv_kernel<<<dim3((Fq + Fk + Fv) / BN, (N + BM - 1) / BM), THREADS, 0, st>>>(
      (const float*)x, (const float*)wn, (const float*)wq, (const float*)wk, (const float*)wv,
      (const float*)rrms, (float*)q, (float*)k, (float*)v, N, D, Fq, Fk, Fv);
  return (int)cudaGetLastError();
}

// ggt_norm_qkv_f32_rrms: its pre-pass alone, for checking and timing it on
// its own.
extern "C" int ggt_norm_qkv_f32_rrms(const void* x, void* rrms, int N, int D, float eps,
                                     void* stream) {
  if (N == 0) return 0;
  rrms_kernel<<<(N + 7) / 8, 256, 0, (cudaStream_t)stream>>>((const float*)x, (float*)rrms, N,
                                                              D, eps);
  return (int)cudaGetLastError();
}
