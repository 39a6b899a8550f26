// RMSNorm backward, (dx, dw) of y = x * rsqrt(mean(x^2) + eps) * w in one
// pass over the rows, for Hopper.
//
// Replaces graphgpt_tpu/ops/mlp.py:414 _rmsnorm_bwd_kernel (launched by
// rmsnorm_bwd_pallas :436). Same contract: x and the cotangent g are bf16
// [N, D], w fp32 [D]; dx bf16 [N, D], dw fp32 [D]. Statistics and dx are
// computed in fp32 and dx is rounded once:
//   n = x * rrms,  dn = g * w,  dx = rrms * (dn - n * mean(dn * n)),
//   dw = sum over rows of g * n.
//
// What bounds it on the H100: bytes. x and g are read and dx written once,
// 3 x 100.7 MB at N = 65536, D = 768 (~0.09 ms of HBM time) against a few
// operations an element.
//
// Design. The TPU kernel carries its dw sum in scratch across a sequential
// grid; blocks here run in any order, so each block sums the dw of the rows
// it meets and writes one row of a [blocks, D] fp32 scratch, and a second
// small kernel adds the scratch up column by column. That keeps dw the same
// from run to run (no atomics). A warp owns a row at a time: a lane keeps
// its D/32 elements of x and g in registers (16-byte loads, neighbouring
// lanes on neighbouring addresses), the two row sums go through warp
// shuffles, and x, g are read exactly once. The block's warps add their dw
// sums in shared memory in warp order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int WARPS = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int NC>
__global__ void __launch_bounds__(WARPS * 32)
rmsnorm_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                   const float* __restrict__ w, bf16* __restrict__ dx,
                   float* __restrict__ partial, int N, int D, float eps) {
  extern __shared__ float dw_block[];  // [D]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nchunks = D / 8;
  float wv[NC][8], dw[NC][8];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = lane + 32 * i;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      wv[i][e] = c < nchunks ? w[c * 8 + e] : 0.f;
      dw[i][e] = 0.f;
    }
  }
  const float inv_d = 1.f / (float)D;
  for (long long row = (long long)blockIdx.x * WARPS + warp; row < N;
       row += (long long)gridDim.x * WARPS) {
    float xv[NC][8], gv[NC][8];
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      uint4 xr = make_uint4(0, 0, 0, 0), gr = make_uint4(0, 0, 0, 0);
      if (c < nchunks) {
        xr = *reinterpret_cast<const uint4*>(x + row * D + c * 8);
        gr = *reinterpret_cast<const uint4*>(g + row * D + c * 8);
      }
      const bf16* xb = reinterpret_cast<const bf16*>(&xr);
      const bf16* gb = reinterpret_cast<const bf16*>(&gr);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        xv[i][e] = __bfloat162float(xb[e]);
        gv[i][e] = __bfloat162float(gb[e]);
        ss += xv[i][e] * xv[i][e];
      }
    }
    const float rrms = rsqrtf(warp_sum(ss) * inv_d + eps);
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        xv[i][e] *= rrms;  // n
        dw[i][e] += gv[i][e] * xv[i][e];
        gv[i][e] *= wv[i][e];  // dn
        dot += gv[i][e] * xv[i][e];
      }
    const float m = warp_sum(dot) * inv_d;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      if (c < nchunks) {
        uint4 pack;
        bf16* y = reinterpret_cast<bf16*>(&pack);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          y[e] = __float2bfloat16(rrms * (gv[i][e] - xv[i][e] * m));
        *reinterpret_cast<uint4*>(dx + row * D + c * 8) = pack;
      }
    }
  }
  // the block's dw: the warps add theirs in warp order
  for (int turn = 0; turn < WARPS; ++turn) {
    if (warp == turn) {
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = lane + 32 * i;
        if (c < nchunks) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            if (turn == 0) dw_block[c * 8 + e] = dw[i][e];
            else dw_block[c * 8 + e] += dw[i][e];
          }
        }
      }
    }
    __syncthreads();
  }
  for (int d = threadIdx.x; d < D; d += WARPS * 32)
    partial[(long long)blockIdx.x * D + d] = dw_block[d];
}

// dw[d] = sum over the blocks' rows of the scratch, in row order.
__global__ void rmsnorm_bwd_reduce_kernel(const float* __restrict__ partial,
                                          float* __restrict__ dw, int blocks, int D) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= D) return;
  float acc = 0.f;
  for (int b = 0; b < blocks; ++b) acc += partial[(long long)b * D + d];
  dw[d] = acc;
}

template <int NC>
cudaError_t launch(const bf16* x, const bf16* g, const float* w, bf16* dx,
                   float* partial, int N, int D, float eps, int blocks,
                   cudaStream_t st) {
  rmsnorm_bwd_kernel<NC><<<blocks, WARPS * 32, D * sizeof(float), st>>>(
      x, g, w, dx, partial, N, D, eps);
  return cudaGetLastError();
}

}  // namespace

// C entry for ctypes: both kernels on `stream`; returns the first CUDA error
// (0 when both launches were accepted). `partial` is fp32 scratch
// [blocks, D] from the caller; D % 8 == 0 and ceil(D / 256) one of the
// chunk counts below.
extern "C" int ggt_rmsnorm_bwd(const void* x, const void* g, const void* w, void* dx,
                               void* dw, void* partial, int N, int D, float eps,
                               int blocks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nc = (D / 8 + 31) / 32;
  if (D % 8 != 0 || nc < 1) return (int)cudaErrorInvalidValue;
  const bf16* xp = (const bf16*)x;
  const bf16* gp = (const bf16*)g;
  const float* wp = (const float*)w;
  bf16* dxp = (bf16*)dx;
  float* pp = (float*)partial;
  cudaError_t err;
  // one instantiation for each hidden size the port's configs name
  // (128 to 1600: 1, 2, 3, 4, 5 and 7 chunks a lane)
  switch (nc) {
    case 1: err = launch<1>(xp, gp, wp, dxp, pp, N, D, eps, blocks, st); break;
    case 2: err = launch<2>(xp, gp, wp, dxp, pp, N, D, eps, blocks, st); break;
    case 3: err = launch<3>(xp, gp, wp, dxp, pp, N, D, eps, blocks, st); break;
    case 4: err = launch<4>(xp, gp, wp, dxp, pp, N, D, eps, blocks, st); break;
    case 5: err = launch<5>(xp, gp, wp, dxp, pp, N, D, eps, blocks, st); break;
    case 7: err = launch<7>(xp, gp, wp, dxp, pp, N, D, eps, blocks, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  rmsnorm_bwd_reduce_kernel<<<(D + 255) / 256, 256, 0, st>>>(pp, (float*)dw, blocks, D);
  return (int)cudaGetLastError();
}
