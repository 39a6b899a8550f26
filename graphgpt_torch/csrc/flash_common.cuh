// What the flash forward and backward kernels share: the tile sizes, the
// segment-range test that lets a kernel skip a fully masked tile pair (from
// the ids, or from a precomputed table of each tile's range), the causal or
// bi-causal rule as per-row bounds, and the tile load that applies RoPE in
// bf16 on the way into shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int DH = 64;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int LDH = DH + 8;  // bf16 row stride in shared memory
constexpr int LDS = 64 + 4;  // fp32 row stride of the per-warp scratch
constexpr float NEG = -1e30f;


// Min over positive ids and max of seg[t0 : t0+64) (each warp, redundantly).
__device__ __forceinline__ void tile_range(const int* seg, int t0, int P, int lane,
                                           int* lo, int* hi) {
  int mn = 0x7fffffff, mx = 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int p = t0 + lane + 32 * i;
    int s = p < P ? seg[p] : 0;
    if (s > 0) mn = min(mn, s);
    mx = max(mx, s);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
  *lo = mn;
  *hi = mx;
}

// The segment-id range of the 64-row tile that starts at t0. TABLE: read
// it from `tab` (one int2 (lo, hi) a tile, written once by the streamed
// kernels' pre-pass, tile_table_kernel in tile_table.cuh); else each warp
// computes it from the ids with tile_range.
template <bool TABLE>
__device__ __forceinline__ void tile_bounds(const int2* tab, const int* seg, int t0, int P,
                                            int lane, int* lo, int* hi) {
  if constexpr (TABLE) {
    const int2 r = tab[t0 / 64];
    *lo = r.x;
    *hi = r.y;
  } else {
    tile_range(seg, t0, P, lane, lo, hi);
  }
}

// No segment id in common between two tiles with these ranges: every
// logit of the pair is masked. Ids are packed in increasing order, so
// disjoint ranges mean disjoint sets; padding (0) never matches.
__device__ __forceinline__ bool ranges_miss(int alo, int ahi, int blo, int bhi) {
  return ahi <= 0 || bhi <= 0 || alo > bhi || blo > ahi;
}

// The position rule of graphgpt_tpu/ops/flash_attention.py:76 _tile_neg,
// in absolute row and column indices within one segment. Each rule lets a
// query row see a prefix of the columns, and a key column be seen by a
// suffix of the rows, so a kernel computes the bound once per row and the
// inner loop compares one index. bi_split > 0 is the bi-causal rule of the
// binary-energy decoding: rows before split = P - bi_split see the prefix
// [0, split), later rows every column up to their own (the split may fall
// inside a 64-row tile). Else causal or bidirectional.

// Query `row` sees the columns [0, visible_cols).
__device__ __forceinline__ int visible_cols(int row, int causal, int bi_split, int P) {
  if (bi_split > 0) return row < P - bi_split ? P - bi_split : row + 1;
  return causal ? row + 1 : P;
}

// Key `col` is seen by the rows [first_row, P).
__device__ __forceinline__ int first_row(int col, int causal, int bi_split, int P) {
  if (bi_split > 0) return col < P - bi_split ? 0 : col;
  return causal ? col : 0;
}

// Copy a [64, 64] head tile of rows t0.. into shared memory, zero past P,
// rotating it by RoPE when cos is given: y = x*c + rotate_half(x)*s in bf16.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long rs,
                                          int t0, int P, const bf16* cos,
                                          const bf16* sin, int tid) {
#pragma unroll
  for (int it = 0; it < (BQ * DH / 8) / THREADS; ++it) {
    int i = tid + it * THREADS;
    int row = i >> 3, d0 = (i & 7) * 8;
    int gr = t0 + row;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (gr < P) {
      val = *reinterpret_cast<const uint4*>(src + gr * rs + d0);
      if (cos != nullptr) {
        uint4 pv = *reinterpret_cast<const uint4*>(src + gr * rs + ((d0 + 32) & 63));
        uint4 cv = *reinterpret_cast<const uint4*>(cos + (long long)gr * DH + d0);
        uint4 sv = *reinterpret_cast<const uint4*>(sin + (long long)gr * DH + d0);
        const bf16* x = reinterpret_cast<const bf16*>(&val);
        const bf16* pr = reinterpret_cast<const bf16*>(&pv);
        const bf16* c = reinterpret_cast<const bf16*>(&cv);
        const bf16* s = reinterpret_cast<const bf16*>(&sv);
        uint4 outv;
        bf16* y = reinterpret_cast<bf16*>(&outv);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float r = __bfloat162float(pr[e]);
          if (d0 < 32) r = -r;
          bf16 t1 = __float2bfloat16(__bfloat162float(x[e]) * __bfloat162float(c[e]));
          bf16 t2 = __float2bfloat16(r * __bfloat162float(s[e]));
          y[e] = __float2bfloat16(__bfloat162float(t1) + __bfloat162float(t2));
        }
        val = outv;
      }
    }
    *reinterpret_cast<uint4*>(dst + row * LDH + d0) = val;
  }
}

}  // namespace
