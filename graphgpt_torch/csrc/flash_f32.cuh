// What the FFMA fp32 flash kernels, the band forward (flash_fwd_f32.cu)
// and the fused backward's passes (flash_bwd_f32.cu), share: 64 x 64 fp32
// tiles in shared memory, the tile loads with RoPE, the FFMA tile product,
// and the test that skips a tile pair with no segment id in common.
//
// Layout. A block of 256 threads works on 64 x 64 tiles; thread (ty, tx) =
// (tid / 16, tid % 16) owns the 16 elements (ty + 16 i, tx + 16 j), i, j in
// 0..3. A tile sits in shared memory row-major with a padded row of LD = 65
// floats, so that a column read (tx + 16 j varying along the warp) and a
// row read both hit 16 different banks and the two ty of a warp
// broadcast: every product below reads its operands either way round
// without a bank conflict. Products are fp32 fused multiply-adds summed
// over k in order, one accumulator an element: no TF32, no atomics, the
// same bits on every launch.
#pragma once

#include "flash_common.cuh"

namespace f32 {

constexpr int T = 64;          // tile rows (queries or keys), and the head width
constexpr int LD = 65;         // a shared tile's row stride, in floats
constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 elements each
constexpr int TILE = T * LD;   // floats of a shared tile

// The token-major row of head h at position p of row b of a [B, P, H * 64] tensor.
__device__ __forceinline__ const float* head_row(const float* x, int b, int p, int P, int H,
                                                 int h) {
  return x + ((long long)b * P + p) * H * DH + h * DH;
}

// Rows [r0, r0 + 64) of head h of row b into the shared tile `dst`: rows
// past P are 0, and so are rows of segment 0 where `zero_padded` (do, so
// that a non-finite value there reaches nothing). With cos and sin [B, P,
// 64], RoPE as the plain version applies it in fp32: x * cos + r * sin, r
// = (-x[32:], x[:32]), each product and the sum rounded (no contraction).
__device__ __forceinline__ void load_tile(float* dst, const float* src, const int* seg,
                                          const float* cos, const float* sin, int b, int r0,
                                          int P, int H, int h, bool zero_padded) {
  for (int e = threadIdx.x; e < T * (T / 4); e += THREADS) {
    const int r = e >> 4, c = (e & 15) * 4;
    const int p = r0 + r;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (p < P && (!zero_padded || seg[(long long)b * P + p] > 0)) {
      const float* row = head_row(src, b, p, P, H, h);
      const float4 x = *reinterpret_cast<const float4*>(row + c);
      v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
      if (cos != nullptr) {
        const float4 o = *reinterpret_cast<const float4*>(row + (c ^ 32));
        const long long t = ((long long)b * P + p) * DH + c;
        const float4 cs = *reinterpret_cast<const float4*>(cos + t);
        const float4 sn = *reinterpret_cast<const float4*>(sin + t);
        const float sign = c < 32 ? -1.f : 1.f;
        const float ov[4] = {o.x, o.y, o.z, o.w}, cv[4] = {cs.x, cs.y, cs.z, cs.w};
        const float sv[4] = {sn.x, sn.y, sn.z, sn.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
          v[u] = __fadd_rn(__fmul_rn(v[u], cv[u]), __fmul_rn(sign * ov[u], sv[u]));
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) dst[r * LD + c + u] = v[u];
  }
}

// acc[i][j] += sum over k in [0, 64) of A(ty + 16 i, k) * B(tx + 16 j, k),
// where A(r, k) is a[r * LD + k], or a[k * LD + r] when TA (the tile read
// transposed); the same for B and TB.
template <bool TA, bool TB>
__device__ __forceinline__ void mma64(float (&acc)[4][4], const float* a, const float* b,
                                      int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < T; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = TA ? a[k * LD + ty + 16 * i] : a[(ty + 16 * i) * LD + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = TB ? b[k * LD + tx + 16 * j] : b[(tx + 16 * j) * LD + k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// Sum or max over the 16 threads of a row (tx), which sit in one half-warp.
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The segment ids of rows [r0, r0 + 64) into shared `dst` (0 past P).
__device__ __forceinline__ void load_seg(int* dst, const int* seg, int b, int r0, int P) {
  for (int r = threadIdx.x; r < T; r += THREADS)
    dst[r] = r0 + r < P ? seg[(long long)b * P + r0 + r] : 0;
}

// Whether the query tile [q0, q0 + 64), its ids in q_row, and the key tile
// [k0, k0 + 64), its ids in k_row (q_row again unless the keys carry ids
// of their own), share no segment id (every pair masked). Disjoint id
// ranges mean disjoint sets in any order of the ids. Every warp computes
// it, the same for all.
__device__ __forceinline__ bool tiles_miss(const int* q_row, int q0, const int* k_row, int k0,
                                           int P) {
  const int lane = threadIdx.x & 31;
  int qlo, qhi, klo, khi;
  tile_range(q_row, q0, P, lane, &qlo, &qhi);
  tile_range(k_row, k0, P, lane, &klo, &khi);
  return ranges_miss(qlo, qhi, klo, khi);
}

// The inverse rotation of a gradient's row, in place on the four columns
// tx + 16 j a thread holds (columns d and d + 32 are j and j + 2):
// x * cos - r * sin with r as above, each product and the difference
// rounded, as the plain version's unrotate_tokens.
__device__ __forceinline__ void unrotate(float (&x)[4], const float* cos, const float* sin,
                                         long long t, int tx) {
  const float old[4] = {x[0], x[1], x[2], x[3]};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int d = tx + 16 * j;
    const float r = j < 2 ? -old[j + 2] : old[j - 2];
    x[j] = __fsub_rn(__fmul_rn(old[j], cos[t + d]), __fmul_rn(r, sin[t + d]));
  }
}

}  // namespace f32
