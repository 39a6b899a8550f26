// RMSNorm backward, (dx, dw) of y = x * rsqrt(mean(x^2) + eps) * w in one
// pass over the rows, for Hopper.
//
// Replaces graphgpt_tpu/ops/mlp.py:414 _rmsnorm_bwd_kernel (launched by
// rmsnorm_bwd_pallas :436), in both dtypes it is given: the TPU kernel
// writes dx in its ref's dtype, so an fp32 model (`model.dtype: float32`)
// runs it in fp32. Same contract: x and the cotangent g are bf16 or fp32
// [N, D], w fp32 [D]; dx [N, D] in x's dtype, dw fp32 [D]. Statistics and
// dx are computed in fp32 and dx is rounded once (not at all in fp32):
//   n = x * rrms,  dn = g * w,  dx = rrms * (dn - n * mean(dn * n)),
//   dw = sum over rows of g * n.
//
// What bounds it on the H100: bytes. x and g are read and dx written once,
// 3 x 100.7 MB at N = 65536, D = 768 (~0.09 ms of HBM time) against a few
// operations an element. At the fine-tune and denoise N (18,432, 22,528)
// that is 0.025-0.031 ms, so a fixed cost of a few microseconds shows.
// In fp32 the bytes double (x, g and dx 4 bytes an element).
//
// Design. The TPU kernel carries its dw sum in scratch across a sequential
// grid; blocks here run in any order, so each CTA sums the dw of the rows
// it meets and writes one row of a [CTAs, D] fp32 scratch, and a second
// small kernel adds the scratch up column by column. That keeps dw the same
// from launch to launch (no atomics).
//  - The row pass is persistent: at most two CTAs of 8 warps an SM (the
//    grid comes from the caller, from the SM count), rows grid-strided over
//    the warps. A warp owns a row at a time: a lane holds its chunks of 8
//    elements of x and g (one 16-byte vector each in bf16, two in fp32;
//    neighbouring lanes on neighbouring addresses) as loaded, and issues
//    the loads of its next row before the shuffle sums of this one, so that
//    two rows a warp are in flight (bf16 up to D 1280, fp32 up to D 512,
//    for want of registers). w sits in shared memory; dw in registers, per
//    lane, until
//    the end, where the CTA's warps add theirs by a fixed tree in shared
//    memory and warp 0 writes the CTA's row. The element type is a
//    template parameter: the bf16 and fp32 forms do the same arithmetic in
//    the same order, and differ only in how a chunk is loaded and stored.
//  - The sum of the <= 2 x 132 rows runs spread over the card: 8 warps a
//    block of 32 columns, each warp a slice of the rows in index order, then
//    the 8 slices in warp order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int WARPS = 8;
constexpr int RMS_MAIN = 1, RMS_REDUCE = 2;  // the stage mask's bits

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float lo_f(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_f(uint32_t v) { return __uint_as_float(v & 0xFFFF0000u); }

// How a chunk of 8 elements of T is held (VEC 16-byte vectors), read and written.
template <typename T>
struct Chunk;

template <>
struct Chunk<bf16> {
  static constexpr int VEC = 1;
  // element e (0..7) of a chunk of bf16
  static __device__ __forceinline__ float elem(const uint4* c, int e) {
    const uint32_t w = e < 2 ? c[0].x : e < 4 ? c[0].y : e < 6 ? c[0].z : c[0].w;
    return (e & 1) ? hi_f(w) : lo_f(w);
  }
  static __device__ __forceinline__ void store(bf16* dst, const float* y) {
    uint4 pack;
    bf16* p = reinterpret_cast<bf16*>(&pack);
#pragma unroll
    for (int e = 0; e < 8; ++e) p[e] = __float2bfloat16(y[e]);
    *reinterpret_cast<uint4*>(dst) = pack;
  }
};

template <>
struct Chunk<float> {
  static constexpr int VEC = 2;
  static __device__ __forceinline__ float elem(const uint4* c, int e) {
    const uint4& v = c[e >> 2];
    const uint32_t w = (e & 3) == 0 ? v.x : (e & 3) == 1 ? v.y : (e & 3) == 2 ? v.z : v.w;
    return __uint_as_float(w);
  }
  static __device__ __forceinline__ void store(float* dst, const float* y) {
    *reinterpret_cast<float4*>(dst) = make_float4(y[0], y[1], y[2], y[3]);
    *reinterpret_cast<float4*>(dst + 4) = make_float4(y[4], y[5], y[6], y[7]);
  }
};

// The chunks of x and g of one row that a lane holds (zeros past D).
template <typename T, int NC>
struct RowChunks {
  uint4 x[NC][Chunk<T>::VEC], g[NC][Chunk<T>::VEC];
};

template <typename T, int NC>
__device__ __forceinline__ void load_row(RowChunks<T, NC>& r, const T* x, const T* g,
                                         long long row, int D, int lane) {
  const int nchunks = D / 8;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = lane + 32 * i;
#pragma unroll
    for (int u = 0; u < Chunk<T>::VEC; ++u) {
      r.x[i][u] = r.g[i][u] = make_uint4(0, 0, 0, 0);
      if (c < nchunks) {
        r.x[i][u] = reinterpret_cast<const uint4*>(x + row * D + c * 8)[u];
        r.g[i][u] = reinterpret_cast<const uint4*>(g + row * D + c * 8)[u];
      }
    }
  }
}

// Two CTAs an SM up to 3 chunks a lane (D <= 768), one above. A lane
// holds two rows' chunks, their fp32 values and dw: ~40 NC registers in
// bf16, so above 5 chunks (D > 1280) a warp keeps one row in flight, not
// two; an fp32 chunk takes twice the registers, so there above 2 (D > 512).
template <typename T, int NC>
__global__ void __launch_bounds__(WARPS * 32, NC <= 3 ? 2 : 1)
rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                   const float* __restrict__ w, T* __restrict__ dx,
                   float* __restrict__ partial, int N, int D, float eps) {
  using C = Chunk<T>;
  extern __shared__ float smem[];  // w [D], then the tree's WARPS / 2 rows of D
  float* w_s = smem;
  float* tree = smem + D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nchunks = D / 8;
  for (int d = threadIdx.x; d < D; d += WARPS * 32) w_s[d] = w[d];
  __syncthreads();
  float dw[NC][8];
#pragma unroll
  for (int i = 0; i < NC; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) dw[i][e] = 0.f;
  const float inv_d = 1.f / (float)D;
  const long long stride = (long long)gridDim.x * WARPS;
  long long row = (long long)blockIdx.x * WARPS + warp;
  constexpr bool AHEAD = NC <= (C::VEC == 1 ? 5 : 2);
  RowChunks<T, NC> cur, nxt;
  if (AHEAD && row < N) load_row(cur, x, g, row, D, lane);
  for (; row < N; row += stride) {
    // AHEAD: the next row's loads go out before this row's sums
    if (!AHEAD) load_row(cur, x, g, row, D, lane);
    else if (row + stride < N) load_row(nxt, x, g, row + stride, D, lane);
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float xv = C::elem(cur.x[i], e);
        ss += xv * xv;
      }
    const float rrms = rsqrtf(warp_sum(ss) * inv_d + eps);
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = min(lane + 32 * i, nchunks - 1);  // w of a chunk past D: any, g is 0
      const float4 wa = *reinterpret_cast<const float4*>(w_s + c * 8);
      const float4 wb = *reinterpret_cast<const float4*>(w_s + c * 8 + 4);
      const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float n = C::elem(cur.x[i], e) * rrms, gv = C::elem(cur.g[i], e);
        dw[i][e] += gv * n;
        dot += gv * wv[e] * n;
      }
    }
    const float m = warp_sum(dot) * inv_d;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      if (c < nchunks) {
        const float4 wa = *reinterpret_cast<const float4*>(w_s + c * 8);
        const float4 wb = *reinterpret_cast<const float4*>(w_s + c * 8 + 4);
        const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
        float y[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float n = C::elem(cur.x[i], e) * rrms, dn = C::elem(cur.g[i], e) * wv[e];
          y[e] = rrms * (dn - n * m);
        }
        C::store(dx + row * D + c * 8, y);
      }
    }
    if (AHEAD) cur = nxt;
  }
  // the CTA's dw: warps [h, 2h) hand theirs to warps [0, h), h = 4, 2, 1
#pragma unroll
  for (int h = WARPS / 2; h > 0; h >>= 1) {
    if (warp >= h && warp < 2 * h) {
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = lane + 32 * i;
        if (c < nchunks) {
          float* t = tree + (warp - h) * D + c * 8;
          *reinterpret_cast<float4*>(t) = make_float4(dw[i][0], dw[i][1], dw[i][2], dw[i][3]);
          *reinterpret_cast<float4*>(t + 4) =
              make_float4(dw[i][4], dw[i][5], dw[i][6], dw[i][7]);
        }
      }
    }
    __syncthreads();
    if (warp < h) {
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = lane + 32 * i;
        if (c < nchunks) {
          const float* t = tree + warp * D + c * 8;
#pragma unroll
          for (int e = 0; e < 8; ++e) dw[i][e] += t[e];
        }
      }
    }
    __syncthreads();
  }
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      if (c < nchunks) {
        float* out = partial + (long long)blockIdx.x * D + c * 8;
        *reinterpret_cast<float4*>(out) = make_float4(dw[i][0], dw[i][1], dw[i][2], dw[i][3]);
        *reinterpret_cast<float4*>(out + 4) = make_float4(dw[i][4], dw[i][5], dw[i][6], dw[i][7]);
      }
    }
  }
}

// dw[d] = sum over the scratch's `blocks` rows: a block of 8 warps takes 32
// columns, warp k the rows [k blocks / 8, (k + 1) blocks / 8) in index
// order, then warp 0 adds the 8 slices in warp order.
__global__ void __launch_bounds__(WARPS * 32)
rmsnorm_bwd_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dw, int blocks,
                          int D) {
  __shared__ float part[WARPS][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = blockIdx.x * 32 + lane;
  const int b0 = warp * blocks / WARPS, b1 = (warp + 1) * blocks / WARPS;
  float acc = 0.f;
  if (d < D) {
#pragma unroll 8
    for (int b = b0; b < b1; ++b) acc += partial[(long long)b * D + d];
  }
  part[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && d < D) {
    float sum = part[0][lane];
#pragma unroll
    for (int k = 1; k < WARPS; ++k) sum += part[k][lane];
    dw[d] = sum;
  }
}

template <typename T, int NC>
cudaError_t launch(const T* x, const T* g, const float* w, T* dx,
                   float* partial, int N, int D, float eps, int blocks,
                   cudaStream_t st) {
  const size_t smem = (size_t)D * (1 + WARPS / 2) * sizeof(float);
  rmsnorm_bwd_kernel<T, NC><<<blocks, WARPS * 32, smem, st>>>(x, g, w, dx, partial, N, D, eps);
  return cudaGetLastError();
}

// The stages of `stages` in element type T (see the C entries below).
template <typename T>
int stages_of(const void* x, const void* g, const void* w, void* dx, void* dw, void* partial,
              int N, int D, float eps, int blocks, int stages, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nc = (D / 8 + 31) / 32;
  if (D % 8 != 0 || nc < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  const T* xp = (const T*)x;
  const T* gp = (const T*)g;
  const float* wp = (const float*)w;
  T* dxp = (T*)dx;
  float* pp = (float*)partial;
  if (stages & RMS_MAIN) {
    cudaError_t err;
    // one instantiation for each hidden size the port's configs name
    // (128 to 1600: 1, 2, 3, 4, 5 and 7 chunks a lane)
    switch (nc) {
      case 1: err = launch<T, 1>(xp, gp, wp, dxp, pp, N, D, eps, blocks, st); break;
      case 2: err = launch<T, 2>(xp, gp, wp, dxp, pp, N, D, eps, blocks, st); break;
      case 3: err = launch<T, 3>(xp, gp, wp, dxp, pp, N, D, eps, blocks, st); break;
      case 4: err = launch<T, 4>(xp, gp, wp, dxp, pp, N, D, eps, blocks, st); break;
      case 5: err = launch<T, 5>(xp, gp, wp, dxp, pp, N, D, eps, blocks, st); break;
      case 7: err = launch<T, 7>(xp, gp, wp, dxp, pp, N, D, eps, blocks, st); break;
      default: return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
  }
  if (stages & RMS_REDUCE) {
    rmsnorm_bwd_reduce_kernel<<<(D + 31) / 32, WARPS * 32, 0, st>>>(pp, (float*)dw, blocks, D);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C entries for ctypes: the stages of `stages` (1 the row pass, 2 the sum
// of its scratch; 3 both, the call) on `stream`, bf16 x, g and dx (the
// `_f32` entries: fp32); return the first CUDA error (0 when the launches
// were accepted). `partial` is fp32 scratch [blocks, D] from the caller,
// `blocks` the row pass's grid; D % 8 == 0 and ceil(D / 256) one of the
// chunk counts above.
extern "C" int ggt_rmsnorm_bwd_stages(const void* x, const void* g, const void* w, void* dx,
                                      void* dw, void* partial, int N, int D, float eps,
                                      int blocks, int stages, void* stream) {
  return stages_of<bf16>(x, g, w, dx, dw, partial, N, D, eps, blocks, stages, stream);
}

extern "C" int ggt_rmsnorm_bwd_f32_stages(const void* x, const void* g, const void* w, void* dx,
                                          void* dw, void* partial, int N, int D, float eps,
                                          int blocks, int stages, void* stream) {
  return stages_of<float>(x, g, w, dx, dw, partial, N, D, eps, blocks, stages, stream);
}

// The call: both stages.
extern "C" int ggt_rmsnorm_bwd(const void* x, const void* g, const void* w, void* dx,
                               void* dw, void* partial, int N, int D, float eps,
                               int blocks, void* stream) {
  return ggt_rmsnorm_bwd_stages(x, g, w, dx, dw, partial, N, D, eps, blocks,
                                RMS_MAIN | RMS_REDUCE, stream);
}

extern "C" int ggt_rmsnorm_bwd_f32(const void* x, const void* g, const void* w, void* dx,
                                   void* dw, void* partial, int N, int D, float eps,
                                   int blocks, void* stream) {
  return ggt_rmsnorm_bwd_f32_stages(x, g, w, dx, dw, partial, N, D, eps, blocks,
                                    RMS_MAIN | RMS_REDUCE, stream);
}
