// What the flash forward and backward kernels share: the head width, the
// floor of a row that sees no key, the segment-range test that lets a
// kernel skip a fully masked tile pair, and the causal or bi-causal rule as
// per-row bounds.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int DH = 64;
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

}  // namespace
