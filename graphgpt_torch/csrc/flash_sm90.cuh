// The attention pieces for Hopper that the split backward #4, #5 and its
// stream form #7, #8 (flash_bwd_split.cu), the forward #1 and its forms #6,
// #9 (flash_fwd.cu) and the fused backward #3 and its band form #10
// (flash_bwd.cu) share, on top of sm90_common.cuh's primitives: the
// register-A wgmma m64n64k16, the MN-major descriptor, the pins that keep a
// wgmma operand in its registers, 16-byte shared loads and stores, the
// cp.async helpers, bf16x2 arithmetic and RoPE with the plain rotation's
// roundings, the branch-free exponential, the visiting-tile mask, the 3D
// tensor-map encoder and the error codes of the C entries; and, for the
// forward and the fused backward only (the pair keeps its own), the item
// schedule, the own rows' cos/sin loader and the rotation of an own A
// operand in registers.
#pragma once

#include "flash_common.cuh"  // DH, tile_range, ranges_miss
#include "sm90_common.cuh"   // saddr, pin, EncodeTiled

namespace sm90 {
namespace {

#define D8(i)                                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64, 64] (+)= a[64, 16] @ b[16, 64] for the warpgroup: a from registers
// (mma.m16n8k16's A layout a warp), b through its descriptor, K-major
// (TB 0) or MN-major (TB 1: wgmma's transpose bit); scale_d 0 overwrites d.
template <int TB>
__device__ __forceinline__ void wgmma64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                        int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(TB));
}

#undef D8

// The descriptor of a [64 rows, 64] 128-byte swizzled tile read MN-major:
// a row holds 64 of N, 8-row groups of K lie 1024 bytes apart. Both offset
// fields carry 1024 (the N extent is one 64-wide swizzle atom, so only the
// K-group stride is read). A k-step of 16 rows advances 2048 bytes (+128).
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// pin for every register of a wgmma sum or register A operand: the value
// stays in its register across the asynchronous product (FlashAttention-3
// fences its register operands so)
__device__ __forceinline__ void pin_all(float (&d)[32]) {
#pragma unroll
  for (int j = 0; j < 32; ++j) pin(d[j]);
}
__device__ __forceinline__ void pin_all(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[k][r])::"memory");
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}
__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// 4 bytes global -> shared, zero-filled when !ok (nothing read).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(saddr(dst)),
               "l"((uint64_t)__cvta_generic_to_global(src)), "r"(ok ? 4 : 0)
               : "memory");
}

// The mbarrier counts one arrival when this thread's earlier cp.async land.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ float lo_f(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_f(uint32_t v) { return __uint_as_float(v & 0xFFFF0000u); }

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// bf16x2 products and sums, each rounded once to bf16: the product of two
// bf16 is exact in fp32 and a sum of two bf16 rounds to the same bf16
// either way, so these give the fp32 roundings of the plain
// rotate_tokens (ops/flash_attention.py) bit for bit
__device__ __forceinline__ uint32_t bmul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t badd(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// RoPE on bf16x2 pairs: x at column d < 32 and y at d + 32, with their cos
// and sin: x' = bf16(bf16(x c_x) + bf16(-y s_x)), y' = bf16(bf16(y c_y) +
// bf16(x s_y)), the plain rotate_tokens' roundings.
__device__ __forceinline__ void rope2(uint32_t& x, uint32_t& y, uint32_t cx, uint32_t cy,
                                      uint32_t sx, uint32_t sy) {
  const uint32_t x0 = x;
  x = badd(bmul(x0, cx), bmul(y ^ 0x80008000u, sx));
  y = badd(bmul(y, cy), bmul(x0, sy));
}

// 2^x, flushing subnormals: one MUFU.EX2 (2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void rope16(uint4& x, uint4& y, const uint4& cx, const uint4& cy,
                                       const uint4& sx, const uint4& sy) {
  rope2(x.x, y.x, cx.x, cy.x, sx.x, sy.x);
  rope2(x.y, y.y, cx.y, cy.y, sx.y, sy.y);
  rope2(x.z, y.z, cx.z, cy.z, sx.z, sy.z);
  rope2(x.w, y.w, cx.w, cy.w, sx.w, sy.w);
}

// tile_range (flash_common.cuh) with each reduction one redux.sync instead
// of five rounds of shuffles: the same (min positive id or 0x7fffffff, max
// id) of seg[t0 : t0+64), for the walkers of the ring, whose per-item work
// is a chain of these.
__device__ __forceinline__ void tile_range_redux(const int* seg, int t0, int P, int lane, int* lo,
                                                 int* hi) {
  const int p0 = t0 + lane, p1 = p0 + 32;
  const int s0 = p0 < P ? seg[p0] : 0, s1 = p1 < P ? seg[p1] : 0;
  const unsigned mn = min(s0 > 0 ? (unsigned)s0 : 0x7fffffffu, s1 > 0 ? (unsigned)s1 : 0x7fffffffu);
  *lo = (int)__reduce_min_sync(0xffffffffu, mn);
  *hi = (int)__reduce_max_sync(0xffffffffu, (unsigned)max(max(s0, s1), 0));
}

// The visiting tiles that an item's own block [own0, own0 + 128) can meet,
// bit vt - vt0 for the tile of rows [64 vt, 64 vt + 64), vt0 <= vt <
// vt0 + the mask's width: their segment-id ranges meet the own block's and,
// causal, they lie on its side of the diagonal (an own query block meets
// the key tiles up to its last row, an own key block the query tiles from
// its first on). Each warp that walks the ring computes it (tile_range: a
// warp's lanes read 64 ids). A 32-bit mask covers P <= 2048, a 64-bit one
// P <= 4096; longer rows take one 64-bit mask per 64 tiles (vt0 = 64 c).
// REDUX: the ranges by tile_range_redux (the same values).
template <typename Mask = uint32_t, bool REDUX = false>
__device__ __forceinline__ Mask visiting_mask(const int* segb, int own0, int P, bool tri,
                                              bool dkv, int lane, int vt0 = 0) {
  auto range = [&](int t0, int* lo, int* hi) {
    if constexpr (REDUX) tile_range_redux(segb, t0, P, lane, lo, hi);
    else tile_range(segb, t0, P, lane, lo, hi);
  };
  const int nt = (P + 63) / 64;
  int olo, ohi, lo, hi;
  range(own0, &olo, &ohi);
  range(own0 + 64, &lo, &hi);
  olo = min(olo, lo);
  ohi = max(ohi, hi);
  int vb = 0, ve = nt;
  if (tri) {
    if (dkv) vb = own0 / 64;
    else ve = min(nt, (own0 + 128 - 1) / 64 + 1);
  }
  vb = max(vb, vt0);
  ve = min(ve, vt0 + 8 * (int)sizeof(Mask));
  Mask mask = 0;
  for (int vt = vb; vt < ve; ++vt) {
    range(vt * 64, &lo, &hi);
    if (!ranges_miss(olo, ohi, lo, hi)) mask |= (Mask)1 << (vt - vt0);
  }
  return mask;
}

// The work items of the persistent forward and fused backward: 128 own rows
// (b, 128-row block, h), h fastest; CTA c takes the contiguous run
// [c n / G, (c + 1) n / G), so that the heads of a row block, which share
// its segment ids, cos and sin, follow one another.
constexpr int ITEM_ROWS = 128;

struct Item {
  int b, h, own0;
};

__device__ __forceinline__ Item decode(int i, int H, int nblk) {
  Item it;
  it.h = i % H;
  const int bb = i / H;
  it.own0 = (bb % nblk) * ITEM_ROWS;
  it.b = bb / nblk;
  return it;
}

// Item i is the first (last) of its row block in this CTA's run.
__device__ __forceinline__ bool block_starts(int i, int first, int H) {
  return i == first || i % H == 0;
}
__device__ __forceinline__ bool block_ends(int i, int last, int H) {
  return i + 1 == last || (i + 1) % H == 0;
}

// One thread's loads of the own rows' cos and sin (two [128, 64] swizzled
// tiles at cos_dst and sin_dst) once a row block of [first, last): its
// items take them from one phase of `full` and hand them back together on
// `empty`, so that the next item's tiles are rotated while one runs.
__device__ __forceinline__ void load_own_rope(const CUtensorMap* tcos, const CUtensorMap* tsin,
                                              uint32_t cos_dst, uint32_t sin_dst, uint32_t full,
                                              uint32_t empty, int first, int last, int H,
                                              int nblk, int P) {
  constexpr int BOX = 64 * DH * 2;
  uint32_t phase = 0;
  for (int i = first; i < last; ++i) {
    if (!block_starts(i, first, H)) continue;
    const Item it = decode(i, H, nblk);
    mbar_wait_or_trap(empty, phase ^ 1);
    const bool two = it.own0 + 64 < P;
    mbar_expect_tx(full, 2 * (two ? 2 : 1) * BOX);
    tma_load_3d(cos_dst, tcos, full, 0, it.own0, it.b);
    tma_load_3d(sin_dst, tsin, full, 0, it.own0, it.b);
    if (two) {
      tma_load_3d(cos_dst + BOX, tcos, full, 0, it.own0 + 64, it.b);
      tma_load_3d(sin_dst + BOX, tsin, full, 0, it.own0 + 64, it.b);
    }
    phase ^= 1;
  }
  mbar_wait_or_trap(empty, phase ^ 1);
}

// RoPE on an own A operand in registers (ldmatrix's fragments at aoff of a
// [128, 64] swizzled tile), with the own rows' cos and sin tiles at cs and
// sn: k-steps kk and kk + 2 hold columns d and d + 32 in the same registers.
__device__ __forceinline__ void rope_a(uint32_t (&a)[4][4], uint32_t cs, uint32_t sn,
                                       uint32_t aoff) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    uint32_t c0[4], c2[4], n0[4], n2[4];
    ldmatrix_x4(c0, cs + (aoff ^ (32 * kk)));
    ldmatrix_x4(c2, cs + (aoff ^ (32 * (kk + 2))));
    ldmatrix_x4(n0, sn + (aoff ^ (32 * kk)));
    ldmatrix_x4(n2, sn + (aoff ^ (32 * (kk + 2))));
#pragma unroll
    for (int r = 0; r < 4; ++r) rope2(a[kk][r], a[kk + 2][r], c0[r], c2[r], n0[r], n2[r]);
  }
}

// Error codes of the C entries beside CUDA's own (all below 1000).
constexpr int ERR_NO_ENCODE = 1000;  // cuTensorMapEncodeTiled not found in the driver
constexpr int ERR_ENCODE = 1001;     // a tensor map was refused
constexpr int ERR_P = 1002;          // P past the kernel's MAX_P
constexpr int ERR_DEVICE = 1003;     // a device index past MAX_DEVICES
constexpr int MAX_DEVICES = 64;

// A bf16 [B, P, width] tensor as a 3D map {width, P, B} in [64, 64] boxes,
// 128-byte swizzled; rows past P read as zeros and are not written.
bool encode3(EncodeTiled fn, CUtensorMap* map, const void* base, int B, int P, int width) {
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)P, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)width * 2, (cuuint64_t)width * 2 * P};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
}  // namespace sm90
