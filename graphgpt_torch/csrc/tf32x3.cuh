// fp32-accurate products on the TF32 tensor cores (3xTF32), for the fp32
// kernels written for Hopper: the split of an fp32 value into two TF32
// values, mma.sync m16n8k8 in TF32 with fp32 sums, and an accumulator tile
// read as the A operand of the next product. First used by the split
// backward #4f / #5f (flash_bwd_split_f32.cu); the later fp32 redesigns
// (#12f, #11f, #2f) can take the same pieces.
//
// The split: hi = x rounded to TF32 (10 mantissa bits, to nearest, ties
// away: cvt.rna's rounding), lo = x - hi (exact in fp32) rounded the same
// way, so that hi + lo holds x to ~21 bits. A product a b is then a_lo b_hi
// + a_hi b_lo + a_hi b_hi (the small terms first), each term a TF32 product
// summed in fp32 by the tensor core (a_lo b_lo, ~2^-22 of a b, is dropped):
// three TF32 products for one fp32-accurate one: 495 / 3 = 165 TFLOP/s on
// an H100 SXM at wgmma's rate (these pieces take mma.sync).
//
// Fragments (PTX ISA, mma.m16n8k8 with .tf32; g = lane / 4, t = lane % 4):
//   A (16 x 8, row-major):  a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, k x n):       b0 (t, g), b1 (t + 4, g)
//   C, D (16 x 8):          c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// A sum of k in any order is the same sum, so an accumulator tile can serve
// as the A operand of the next product without moving a value: read c0,
// c2, c1, c3 as a0..a3, which puts columns 2t and 2t + 1 at k = t and
// t + 4, and give B rows 2t and 2t + 1 in b0, b1 (acc_as_a).
#pragma once

#include <stdint.h>

namespace tf32x3 {
namespace {

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero, on the magnitude bits: the same bits for every finite x), by
// two integer operations, which issue faster than the conversion
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo in TF32 (the bits of each as the .b32 operands of mma)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// a fragment of fp32 values held as their bits, split element by element
template <int N>
__device__ __forceinline__ void split_frag(const uint32_t (&x)[N], uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split(__uint_as_float(x[i]), hi[i], lo[i]);
}

// split_frag of a fragment that stays live across a loop, done here and
// not hoisted: an opaque copy keeps the compiler from splitting it once
// before the loop and holding both halves (twice the registers) throughout
__device__ __forceinline__ void split_frag_here(const uint32_t (&x)[4], uint32_t (&hi)[4],
                                                uint32_t (&lo)[4]) {
  uint32_t y[4] = {x[0], x[1], x[2], x[3]};
  asm volatile("" : "+r"(y[0]), "+r"(y[1]), "+r"(y[2]), "+r"(y[3]));
  split_frag(y, hi, lo);
}

// d += a b, one m16n8k8 tile in TF32 with fp32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The accumulator tile c (16 x 8, columns n) as the A operand (16 x 8,
// k = n relabelled: column 2t is k = t, column 2t + 1 is k = t + 4), split;
// its B partner gives rows 2t, 2t + 1 of the same 8 in b0, b1.
__device__ __forceinline__ void acc_as_a(const float (&c)[4], uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  split(c[0], hi[0], lo[0]);
  split(c[2], hi[1], lo[1]);
  split(c[1], hi[2], lo[2]);
  split(c[3], hi[3], lo[3]);
}

}  // namespace
}  // namespace tf32x3
