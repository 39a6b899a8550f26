// The two stages of the gated MLP, shared by norm_mlp.cu and mlp.cu, and
// their tile pieces (the RMS statistics of a row tile, the staged tiles, the
// fragment types).
//
//   stage 1 (gate_up_kernel): g = bf16(bf16(act(bf16(xg))) * bf16(xu)),
//     xg = a @ Wg^T, xu = a @ Wu^T, where a = x, or a = bf16(rms(x) * wn)
//     when NORM (the RMS statistics in fp32, computed per CTA for its rows,
//     applied while the A tile is staged, so hpre never reaches memory);
//   stage 2 (down_kernel): out = bf16(g @ Wd^T), plus x in fp32 before the
//     one rounding when RESIDUAL.
//
// Products are WMMA bf16 tensor-core tiles (4 warps, 32x32 each, a 64x64
// tile per CTA) with fp32 accumulation, single-buffered. Activations: exact
// gelu through erff (not the TPU kernels' Abramowitz-Stegun erf), tanh
// gelu, silu. Weights are bf16 in nn.Linear layout ([out, in], row-major);
// x, g and out bf16 row-major; wn fp32. D and F must be multiples of 64.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace gated_mlp {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BKK = 32;
constexpr int THREADS = 128;
constexpr int LDA = BKK + 8;  // bf16 row stride of the staged tiles

enum Act { GELU = 0, GELU_TANH = 1, SILU = 2 };

__device__ __forceinline__ float act_f32(float x, int act) {
  if (act == GELU) return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
  if (act == GELU_TANH)
    return 0.5f * x * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
  return x / (1.f + expf(-x));
}

__device__ __forceinline__ float bround(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Copy a [64, 32] tile (rows r0.., cols k0..) of a row-major bf16 matrix
// with `ld` columns into shared memory, zero past `rows`.
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, int ld, int r0, int rows,
                                      int k0, int tid) {
#pragma unroll
  for (int it = 0; it < (64 * BKK / 8) / THREADS; ++it) {
    int i = tid + it * THREADS;
    int row = i >> 2, c = (i & 3) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + row < rows)
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + row) * ld + k0 + c);
    *reinterpret_cast<uint4*>(dst + row * LDA + c) = val;
  }
}

// rrms[r] = 1 / sqrt(mean(x[m0 + r]^2) + eps) for the 64 rows of a tile,
// fp32 statistics, 16 rows a warp (4 warps); 0 past N. The caller syncs.
__device__ __forceinline__ void tile_rrms(const bf16* x, float* rrms, int m0, int N, int D,
                                          float eps, int warp, int lane) {
  for (int rr = 0; rr < 16; ++rr) {
    const int row = warp * 16 + rr, gr = m0 + row;
    float ss = 0.f;
    if (gr < N) {
      for (int c = lane * 8; c < D; c += 256) {
        uint4 val = *reinterpret_cast<const uint4*>(x + (long long)gr * D + c);
        const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          float f = __bfloat162float(e[t]);
          ss += f * f;
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (lane == 0) rrms[row] = gr < N ? 1.f / sqrtf(ss / (float)D + eps) : 0.f;
  }
}

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragB;

template <bool NORM>
__global__ void __launch_bounds__(THREADS)
gate_up_kernel(const bf16* __restrict__ x, const float* __restrict__ wn,
               const bf16* __restrict__ wg, const bf16* __restrict__ wu,
               bf16* __restrict__ g, int N, int D, int F, float eps, int act) {
  __shared__ __align__(128) bf16 sa[BM * LDA];
  __shared__ __align__(128) bf16 sg[BN * LDA];
  __shared__ __align__(128) bf16 su[BN * LDA];
  __shared__ __align__(128) float scratch[4][2][256];
  __shared__ float rrms[BM];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn_ = warp & 1;

  if (NORM) {
    tile_rrms(x, rrms, m0, N, D, eps, warp, lane);
    __syncthreads();
  }

  Acc accg[2][2], accu[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(accg[i][j], 0.f);
      wmma::fill_fragment(accu[i][j], 0.f);
    }

  for (int k0 = 0; k0 < D; k0 += BKK) {
    if (NORM) {
      // A tile: hpre = bf16(x * rrms * wn)
#pragma unroll
      for (int it = 0; it < (BM * BKK / 8) / THREADS; ++it) {
        int i = tid + it * THREADS;
        int row = i >> 2, c = (i & 3) * 8;
        int gr = m0 + row;
        uint4 outv = make_uint4(0, 0, 0, 0);
        if (gr < N) {
          uint4 val = *reinterpret_cast<const uint4*>(x + (long long)gr * D + k0 + c);
          const bf16* e = reinterpret_cast<const bf16*>(&val);
          bf16* y = reinterpret_cast<bf16*>(&outv);
          const float rr = rrms[row];
#pragma unroll
          for (int t = 0; t < 8; ++t)
            y[t] = __float2bfloat16(__bfloat162float(e[t]) * rr * wn[k0 + c + t]);
        }
        *reinterpret_cast<uint4*>(sa + row * LDA + c) = outv;
      }
    } else {
      stage(sa, x, D, m0, N, k0, tid);
    }
    stage(sg, wg, D, n0, F, k0, tid);
    stage(su, wu, D, n0, F, k0, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BKK / 16; ++kk) {
      FragA a[2];
      FragB bg[2], bu[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], sa + (wm * 32 + i * 16) * LDA + kk * 16, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::load_matrix_sync(bg[j], sg + (wn_ * 32 + j * 16) * LDA + kk * 16, LDA);
        wmma::load_matrix_sync(bu[j], su + (wn_ * 32 + j * 16) * LDA + kk * 16, LDA);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::mma_sync(accg[i][j], a[i], bg[j], accg[i][j]);
          wmma::mma_sync(accu[i][j], a[i], bu[j], accu[i][j]);
        }
    }
    __syncthreads();
  }

  // epilogue: g = bf16(bf16(act(bf16(xg))) * bf16(xu)), 8 columns a lane
  const int er = lane >> 1, ec = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(scratch[warp][0], accg[i][j], 16, wmma::mem_row_major);
      wmma::store_matrix_sync(scratch[warp][1], accu[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gr = m0 + wm * 32 + i * 16 + er;
      const int gc = n0 + wn_ * 32 + j * 16 + ec;
      if (gr < N) {
        uint4 outv;
        bf16* y = reinterpret_cast<bf16*>(&outv);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const float xg = bround(scratch[warp][0][er * 16 + ec + t]);
          const float xu = bround(scratch[warp][1][er * 16 + ec + t]);
          const float a = bround(act_f32(xg, act));
          y[t] = __float2bfloat16(a * xu);
        }
        *reinterpret_cast<uint4*>(g + (long long)gr * F + gc) = outv;
      }
      __syncwarp();
    }
}

template <bool RESIDUAL>
__global__ void __launch_bounds__(THREADS)
down_kernel(const bf16* __restrict__ g, const bf16* __restrict__ wd,
            const bf16* __restrict__ x, bf16* __restrict__ out, int N, int D, int F) {
  __shared__ __align__(128) bf16 sa[BM * LDA];
  __shared__ __align__(128) bf16 sb[BN * LDA];
  __shared__ __align__(128) float scratch[4][256];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn_ = warp & 1;

  Acc acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < F; k0 += BKK) {
    stage(sa, g, F, m0, N, k0, tid);
    stage(sb, wd, F, n0, D, k0, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BKK / 16; ++kk) {
      FragA a[2];
      FragB b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], sa + (wm * 32 + i * 16) * LDA + kk * 16, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], sb + (wn_ * 32 + j * 16) * LDA + kk * 16, LDA);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: out = bf16(acc), or bf16(x + acc) in fp32 with the residual
  const int er = lane >> 1, ec = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(scratch[warp], acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gr = m0 + wm * 32 + i * 16 + er;
      const int gc = n0 + wn_ * 32 + j * 16 + ec;
      if (gr < N) {
        const long long off = (long long)gr * D + gc;
        uint4 outv;
        bf16* y = reinterpret_cast<bf16*>(&outv);
        if (RESIDUAL) {
          uint4 xv = *reinterpret_cast<const uint4*>(x + off);
          const bf16* xe = reinterpret_cast<const bf16*>(&xv);
#pragma unroll
          for (int t = 0; t < 8; ++t)
            y[t] = __float2bfloat16(__bfloat162float(xe[t]) + scratch[warp][er * 16 + ec + t]);
        } else {
#pragma unroll
          for (int t = 0; t < 8; ++t) y[t] = __float2bfloat16(scratch[warp][er * 16 + ec + t]);
        }
        *reinterpret_cast<uint4*>(out + off) = outv;
      }
      __syncwarp();
    }
}

// Both launches on `stream`; returns cudaGetLastError(). g is
// caller-allocated scratch [N, F] bf16; wn and x (in stage 2) are read only
// when NORM and RESIDUAL.
template <bool NORM, bool RESIDUAL>
int launch(const void* x, const void* wn, const void* wg, const void* wu, const void* wd,
           void* g, void* out, int N, int D, int F, float eps, int act, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid_a(F / BN, (N + BM - 1) / BM);
  gate_up_kernel<NORM><<<grid_a, THREADS, 0, s>>>((const bf16*)x, (const float*)wn,
                                                  (const bf16*)wg, (const bf16*)wu, (bf16*)g,
                                                  N, D, F, eps, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid_b(D / BN, (N + BM - 1) / BM);
  down_kernel<RESIDUAL><<<grid_b, THREADS, 0, s>>>((const bf16*)g, (const bf16*)wd,
                                                   (const bf16*)x, (bf16*)out, N, D, F);
  return (int)cudaGetLastError();
}

}  // namespace gated_mlp
