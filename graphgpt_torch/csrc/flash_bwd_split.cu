// The split flash attention backward with in-kernel RoPE, for Hopper: two
// kernels, #4 flash_dq and #5 flash_dkv, launched one after the other.
//
// Replaces graphgpt_tpu/ops/flash_attention.py:602 _dq_kernel_single
// (flash_dq) and :789 _dkv_kernel_single (flash_dkv), which _flash_bwd :902
// launches instead of the fused kernel when bi_split > 0 (the denoise
// model's bi-causal energy decoding) and P <= 2048. q (pre-scaled, not
// rotated), k, v, do, out are token-major bf16 [B, P, H*64]; lse and the
// optional dlse fp32 [B, H, P]; seg int32 [B, P]; optional cos/sin bf16
// [B, P, 64]; P <= 2048. The JAX package computes
// delta = rowsum(do * out) - dlse outside its kernels (:933-940); here
// flash_dq computes it for its own rows, uses it, and writes delta
// [B, H, P] for flash_dkv. With S = rot(q) rot(k)^T + mask and
// p = exp(S - lse):
//   flash_dq:  ds = p * (do v^T - delta) rounded to bf16, dq = ds rot(k)
//   flash_dkv: dv = bf16(p)^T do,  dk = ds^T rot(q)
// in fp32 sums, the inverse rotation applied to the fp32 dq and dk, each
// rounded to bf16 once; the rotation keeps load_tile's roundings
// (flash_common.cuh). The mask is the segment rule with the bi-causal (or
// causal) rule of flash_common.cuh, whose split may fall inside a 64-row
// tile. A padded row (segment 0) gives dq = 0 and takes no part in dk and
// dv; its do is zeroed before any product, so that a non-finite value
// there reaches no output.
//
// What bounds it on the H100: bytes. At the denoise shape (B 256, P 88,
// H 12) flash_dq reads q, k, v, do, out (5 x 34.6 MB), cos, sin and lse and
// writes delta and dq; flash_dkv reads q, k, v, do, cos, sin, lse and delta
// and writes dk and dv: ~216 MB each, 64 us of HBM time, against ~9 and
// ~12 GFLOP of dense products (~10 us).
//
// Design. One kernel body for both, DKV choosing the roles: a work item is
// 128 own rows of one (batch row, head) (queries in flash_dq, keys in
// flash_dkv), and the kernel is persistent: one CTA an SM walks a
// contiguous run of items with the head fastest, so that one CTA reuses a
// row's cos/sin and segment ids across its heads. A CTA is three
// warpgroups:
//  - producer warp 8 computes which 64-row visiting tiles meet the item's
//    segment-id range (and the causal range), then TMA-loads the item's own
//    tiles (q, do, out; or k, v) once, and streams the visiting tiles
//    (k, v; or q, do), with the visiting rows' cos/sin where those rows lie
//    outside the own block, through a 3-stage ring with full and empty
//    mbarriers; its lanes copy each visiting tile's segment ids (and lse,
//    delta in flash_dkv) with cp.async into the stage. 3D tensor maps
//    {64 H, P, B}, boxes of [64, 64], 128-byte swizzled: rows past P arrive
//    as zeros and cost no bytes. Producer warp 9 loads the own rows'
//    cos/sin when the row block changes. Warps 10 and 11 make each landed
//    stage ready: they rotate its k (or q) in place once, with bf16x2
//    arithmetic, and zero do of padded query rows (flash_dkv), then arrive
//    on the stage's ready mbarrier, so that this pass runs beside the
//    consumers' products on the stage before;
//  - two consumer warpgroups own 64 rows each. Their rows' ids, lse and
//    dlse are loaded an item ahead. They take the own tiles into registers
//    with ldmatrix (rotating q or k there; flash_dq zeroes do of padded rows
//    and sums delta from do and out), hand the own buffer back so that the
//    next item loads under this one, and per ready stage:
//    S = A1 B1^T and dP = A2 B2^T as wgmma m64n64k16 with A from registers
//    and B K-major from the stage; p = 2^(S log2 e - lse log2 e) and ds,
//    branch-free, in the accumulator layout, taken as bf16 straight into the
//    A-operand layout of the next products (FlashAttention-3's trick: no
//    shared-memory round trip); and dq += ds rot(k) (dk += ds^T rot(q),
//    dv += bf16(p)^T do in flash_dkv, which computes S^T directly) with B
//    MN-major through wgmma's transpose bit. A warpgroup whose 64 rows
//    cannot meet the tile skips its products;
//  - the epilogue applies the inverse rotation in fp32 (columns j and
//    j + 32 sit in fragments j/8 and j/8 + 4 of one thread), rounds once
//    into a swizzled staging tile and stores it by TMA: rows past P are not
//    written.
// setmaxnreg gives the consumers 224 registers and the producers 56. Only
// the producers' waits time out (4 s, then trap); they wait last for every
// stage to be handed back. No split-K and no atomics: two launches on the
// same inputs give the same bits.

#include "flash_common.cuh"  // DH, the segment-range test, the causal and bi-causal bounds
#include "sm90_common.cuh"   // TMA, mbarriers, wgmma descriptors, the tensor-map encoder

namespace split_bwd {
namespace {

using namespace sm90;

constexpr int ROWS = 128;          // own rows of a work item: two consumer warpgroups of 64
constexpr int NTHREADS = 384;      // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int CONSUMERS = 256;
constexpr int STAGES = 3;
constexpr int BOX = 64 * DH * 2;   // one [64, 64] bf16 box, 8 KB
constexpr int HALF = ROWS * DH * 2;  // a [128, 64] own tile: two boxes
constexpr int MAX_P = 2048;        // the visiting tiles of an item fit one 32-bit mask

// A visiting tile's row data. seg, lse, delta arrive by cp.async (zeros
// past P); v0, lo, hi, rope_own are written by producer lane 0.
struct Meta {
  int seg[64];
  float lse[64];
  float delta[64];
  int v0;        // the tile's first row
  int lo, hi;    // its segment-id range (tile_range)
  int rope_own;  // 1: its rows lie in the own block, whose cos/sin are in the rope buffer
};

// Shared memory from a 1024-aligned base: the own tiles (flash_dq: q, do,
// out; flash_dkv: k, v), the own rows' cos and sin, the ring (per stage the
// visiting B1, B2 and their rows' cos, sin), the output staging (dq; dk and
// dv), the stage metadata, the item header, the barriers.
template <bool DKV>
struct Layout {
  static constexpr int NOWN = DKV ? 2 : 3;
  static constexpr int NOUT = DKV ? 2 : 1;
  static constexpr int OWN = 0;
  static constexpr int COS = OWN + NOWN * HALF;
  static constexpr int SIN = COS + HALF;
  static constexpr int RING = SIN + HALF;
  static constexpr int STAGE = 4 * BOX;  // B1, B2, cos, sin
  static constexpr int OUT = RING + STAGES * STAGE;
  static constexpr int META = OUT + NOUT * HALF;
  static constexpr int HDR = META + STAGES * (int)sizeof(Meta);
  static constexpr int BARS = (HDR + 16 + 7) & ~7;
  // own_full, own_empty, rope_full, rope_empty, ring_full[STAGES], ring_empty[STAGES],
  // ring_ready[STAGES]
  static constexpr int END = BARS + (4 + 3 * STAGES) * 8;
  static constexpr size_t BYTES = 1024 + (size_t)END;
};

struct Args {
  const int* seg;      // [B, P]
  const float* lse;    // [B, H, P]
  const float* dlse;   // flash_dq: [B, H, P] or null
  float* delta;        // flash_dq writes it, flash_dkv reads it
  int B, P, H, causal, bi_split, rope;
};

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
// either way, so these give load_tile's fp32 roundings bit for bit
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
// bf16(x s_y)), load_tile's roundings.
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

// The visiting tiles that an item's own block [own0, own0 + 128) can meet,
// bit vt for the tile of rows [64 vt, 64 vt + 64): their segment-id ranges
// meet the own block's and, causal, they lie on its side of the diagonal
// (an own query block meets the key tiles up to its last row, an own key
// block the query tiles from its first on). Each warp that walks the ring
// computes it (tile_range: a warp's lanes read 64 ids).
__device__ __forceinline__ uint32_t visiting_mask(const int* segb, int own0, int P, bool tri,
                                                  bool dkv, int lane) {
  const int nt = (P + 63) / 64;
  int olo, ohi, lo, hi;
  tile_range(segb, own0, P, lane, &olo, &ohi);
  tile_range(segb, own0 + 64, P, lane, &lo, &hi);
  olo = min(olo, lo);
  ohi = max(ohi, hi);
  int vb = 0, ve = nt;
  if (tri) {
    if (dkv) vb = own0 / 64;
    else ve = min(nt, (own0 + ROWS - 1) / 64 + 1);
  }
  uint32_t mask = 0;
  for (int vt = vb; vt < ve; ++vt) {
    tile_range(segb, vt * 64, P, lane, &lo, &hi);
    if (!ranges_miss(olo, ohi, lo, hi)) mask |= 1u << vt;
  }
  return mask;
}

// The schedule: items (b, 128-row block, h), h fastest; CTA c takes the
// contiguous run [c n / G, (c + 1) n / G).
struct Item {
  int b, h, own0;
};

__device__ __forceinline__ Item decode(int i, int H, int nblk) {
  Item it;
  it.h = i % H;
  const int bb = i / H;
  it.own0 = (bb % nblk) * ROWS;
  it.b = bb / nblk;
  return it;
}

template <bool DKV>
__global__ void __launch_bounds__(NTHREADS, 1)
split_kernel(const __grid_constant__ CUtensorMap own1, const __grid_constant__ CUtensorMap own2,
             const __grid_constant__ CUtensorMap own3, const __grid_constant__ CUtensorMap vis1,
             const __grid_constant__ CUtensorMap vis2, const __grid_constant__ CUtensorMap tcos,
             const __grid_constant__ CUtensorMap tsin, const __grid_constant__ CUtensorMap st1,
             const __grid_constant__ CUtensorMap st2, const Args args) {
  using L = Layout<DKV>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  Meta* meta = reinterpret_cast<Meta*>(base + L::META);
  volatile int* hdr = reinterpret_cast<volatile int*>(base + L::HDR);
  const uint32_t sbase = saddr(base), sbars = sbase + L::BARS;
  const uint32_t own_full = sbars, own_empty = sbars + 8, rope_full = sbars + 16,
                 rope_empty = sbars + 24;
  auto ring_full = [=](int s) { return sbars + 32 + 8 * s; };
  auto ring_empty = [=](int s) { return sbars + 32 + 8 * (STAGES + s); };
  auto ring_ready = [=](int s) { return sbars + 32 + 8 * (2 * STAGES + s); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int P = args.P, H = args.H;
  const int nblk = (P + ROWS - 1) / ROWS;
  const int items = args.B * nblk * H;
  const int first = (int)((long long)blockIdx.x * items / gridDim.x);
  const int last = (int)((long long)(blockIdx.x + 1) * items / gridDim.x);
  const bool tri = args.causal && args.bi_split == 0;
  // a landed stage needs the in-place pass: RoPE on k (or q), and zeros
  // for do of padded query rows in flash_dkv
  const bool pass = DKV || args.rope;

  if (tid == 0) {
    mbar_init(own_full, 1);
    mbar_init(own_empty, 8);
    mbar_init(rope_full, 1);
    mbar_init(rope_empty, 10);  // every consumer warp and both pass warps
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(ring_full(s), 33);  // 32 lanes' cp.async and lane 0's expect_tx
      mbar_init(ring_empty(s), 8);  // every consumer warp
      mbar_init(ring_ready(s), 2);  // both pass warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    if (warp == 8) {
      // the own tiles and the ring
      int stage = 0;
      uint32_t phase = 0, ophase = 0;
      for (int i = first; i < last; ++i) {
        const Item it = decode(i, H, nblk);
        const int* segb = args.seg + (long long)it.b * P;
        const long long rowbase = ((long long)it.b * H + it.h) * P;
        uint32_t mask = visiting_mask(segb, it.own0, P, tri, DKV, lane);
        const bool two = it.own0 + 64 < P;  // the own block's second box holds rows
        mbar_wait_or_trap(own_empty, ophase ^ 1);
        if (lane == 0) {
          hdr[0] = __popc(mask);
          mbar_expect_tx(own_full, L::NOWN * (two ? 2 : 1) * BOX);
          const CUtensorMap* maps[3] = {&own1, &own2, &own3};
#pragma unroll
          for (int o = 0; o < L::NOWN; ++o) {
            const uint32_t dst = sbase + L::OWN + o * HALF;
            tma_load_3d(dst, maps[o], own_full, it.h * DH, it.own0, it.b);
            if (two) tma_load_3d(dst + BOX, maps[o], own_full, it.h * DH, it.own0 + 64, it.b);
          }
        }
        ophase ^= 1;
        while (mask) {
          const int vt = __ffs(mask) - 1;
          mask &= mask - 1;
          const int v0 = vt * 64;
          mbar_wait_or_trap(ring_empty(stage), phase ^ 1);
          Meta& m = meta[stage];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = lane + 32 * e, p = v0 + r;
            const bool ok = p < P;
            cp_async4(&m.seg[r], segb + (ok ? p : 0), ok);
            if (DKV) {
              cp_async4(&m.lse[r], args.lse + rowbase + (ok ? p : 0), ok);
              cp_async4(&m.delta[r], args.delta + rowbase + (ok ? p : 0), ok);
            }
          }
          cp_async_arrive(ring_full(stage));
          int lo, hi;
          tile_range(segb, v0, P, lane, &lo, &hi);
          const bool in_own = v0 >= it.own0 && v0 < it.own0 + ROWS;
          if (lane == 0) {
            m.v0 = v0;
            m.lo = lo;
            m.hi = hi;
            m.rope_own = in_own;
            const bool rope = args.rope && !in_own;
            const uint32_t bar = ring_full(stage);
            const uint32_t dst = sbase + L::RING + stage * L::STAGE;
            mbar_expect_tx(bar, (rope ? 4 : 2) * BOX);
            tma_load_3d(dst, &vis1, bar, it.h * DH, v0, it.b);
            tma_load_3d(dst + BOX, &vis2, bar, it.h * DH, v0, it.b);
            if (rope) {
              tma_load_3d(dst + 2 * BOX, &tcos, bar, 0, v0, it.b);
              tma_load_3d(dst + 3 * BOX, &tsin, bar, 0, v0, it.b);
            }
          }
          __syncwarp();
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      // every stage and the own buffer handed back: the consumers are past
      // their last product
      for (int s = 0; s < STAGES; ++s) {
        mbar_wait_or_trap(ring_empty(stage), phase ^ 1);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      mbar_wait_or_trap(own_empty, ophase ^ 1);
    } else if (warp == 9 && lane == 0 && args.rope) {
      // the own rows' cos and sin, loaded again only when the row block changes
      uint32_t rphase = 0;
      int loaded = -1;
      for (int i = first; i < last; ++i) {
        const Item it = decode(i, H, nblk);
        const int key = it.b * nblk + it.own0 / ROWS;
        mbar_wait_or_trap(rope_empty, rphase ^ 1);
        if (key != loaded) {
          const bool two = it.own0 + 64 < P;
          mbar_expect_tx(rope_full, 2 * (two ? 2 : 1) * BOX);
          tma_load_3d(sbase + L::COS, &tcos, rope_full, 0, it.own0, it.b);
          tma_load_3d(sbase + L::SIN, &tsin, rope_full, 0, it.own0, it.b);
          if (two) {
            tma_load_3d(sbase + L::COS + BOX, &tcos, rope_full, 0, it.own0 + 64, it.b);
            tma_load_3d(sbase + L::SIN + BOX, &tsin, rope_full, 0, it.own0 + 64, it.b);
          }
          loaded = key;
        } else {
          mbar_arrive(rope_full);
        }
        rphase ^= 1;
      }
      mbar_wait_or_trap(rope_empty, rphase ^ 1);
    } else if (warp >= 10 && pass) {
      // the in-place pass over each landed stage, off the consumers' path:
      // 64 threads, each the 16-byte chunks c and c + 4 (columns d and
      // d + 32) of four rows, at their swizzled places
      const int u = tid - 320;
      int stage = 0;
      uint32_t phase = 0, rphase = 0;
      for (int i = first; i < last; ++i) {
        const Item it = decode(i, H, nblk);
        uint32_t mask = visiting_mask(args.seg + (long long)it.b * P, it.own0, P, tri, DKV, lane);
        if (args.rope) {  // the own rows' cos and sin
          mbar_wait(rope_full, rphase);
          rphase ^= 1;
        }
        for (; mask; mask &= mask - 1) {
          mbar_wait(ring_full(stage), phase);
          const Meta& m = meta[stage];
          const uint32_t b1 = sbase + L::RING + stage * L::STAGE;
          const uint32_t cs = m.rope_own ? sbase + L::COS + (m.v0 - it.own0) * 128 : b1 + 2 * BOX;
          const uint32_t sn = cs + (m.rope_own ? L::SIN - L::COS : BOX);
          // one row at a time: the producer warpgroup has 56 registers
#pragma unroll 1
          for (int q = 0; q < 4; ++q) {
            const int pr = (u >> 2) + 16 * q, pc = u & 3;
            const uint32_t plo = pr * 128 + ((pc ^ (pr & 7)) << 4);
            const uint32_t phi = pr * 128 + (((pc + 4) ^ (pr & 7)) << 4);
            if (args.rope) {
              uint4 x = lds128(b1 + plo), y = lds128(b1 + phi);
              rope16(x, y, lds128(cs + plo), lds128(cs + phi), lds128(sn + plo), lds128(sn + phi));
              sts128(b1 + plo, x);
              sts128(b1 + phi, y);
            }
            if (DKV && m.seg[pr] == 0) {  // do of a padded query row
              sts128(b1 + BOX + plo, make_uint4(0, 0, 0, 0));
              sts128(b1 + BOX + phi, make_uint4(0, 0, 0, 0));
            }
          }
          fence_proxy_async();
          __syncwarp();
          if (lane == 0) mbar_arrive(ring_ready(stage));
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
        if (args.rope) {
          __syncwarp();
          if (lane == 0) mbar_arrive(rope_empty);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: rows [64 wg, 64 wg + 64) of each item
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
  const int wg = warp >> 2, w4 = warp & 3, g = lane >> 2, t = lane & 3;
  // ldmatrix: lane l gives row (l & 7) + 8 ((l >> 3) & 1) of the warp's 16
  // and 16-byte half l >> 4 of a k-step, the swizzle's XOR (row & 7 = l & 7)
  // in the chunk bits; k-step kk is aoff ^ 32 kk (norm_qkv.cu's load_x)
  const uint32_t aoff = (wg * 64 + w4 * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * 128 +
                        (((lane >> 4) ^ (lane & 7)) << 4);
  int stage = 0;
  uint32_t phase = 0, ophase = 0, rphase = 0;

  // the ids of this thread's own rows and of the warp's 64-row tile (two a
  // lane), and (flash_dq) the rows' lse and dlse: loaded an item ahead, so
  // that their latency hides under the item before
  struct Rows {
    int s0, s1, t0, t1;
    float lse0, lse1, dlse0, dlse1;
  };
  auto load_rows = [&](int i) {
    Rows r{};
    const Item it = decode(i, H, nblk);
    const int* segb = args.seg + (long long)it.b * P;
    const long long rowbase = ((long long)it.b * H + it.h) * P;
    const int wrow0 = it.own0 + wg * 64, r0 = wrow0 + w4 * 16 + g, r1 = r0 + 8;
    r.s0 = r0 < P ? segb[r0] : 0;
    r.s1 = r1 < P ? segb[r1] : 0;
    r.t0 = wrow0 + lane < P ? segb[wrow0 + lane] : 0;
    r.t1 = wrow0 + lane + 32 < P ? segb[wrow0 + lane + 32] : 0;
    if (!DKV) {
      r.lse0 = r0 < P ? args.lse[rowbase + r0] : 0.f;
      r.lse1 = r1 < P ? args.lse[rowbase + r1] : 0.f;
      if (args.dlse != nullptr) {
        r.dlse0 = r0 < P ? args.dlse[rowbase + r0] : 0.f;
        r.dlse1 = r1 < P ? args.dlse[rowbase + r1] : 0.f;
      }
    }
    return r;
  };
  Rows next = first < last ? load_rows(first) : Rows{};

  for (int i = first; i < last; ++i) {
    const Rows rows = next;
    if (i + 1 < last) next = load_rows(i + 1);
    const Item it = decode(i, H, nblk);
    const long long rowbase = ((long long)it.b * H + it.h) * P;
    const int wrow0 = it.own0 + wg * 64;
    const int r0 = wrow0 + w4 * 16 + g, r1 = r0 + 8;  // this thread's own rows
    const int s0 = rows.s0, s1 = rows.s1;
    // own queries see the visiting columns [0, lim); own keys are seen by
    // the visiting rows [lim, P)
    const int lim0 = DKV ? first_row(r0, args.causal, args.bi_split, P)
                         : visible_cols(r0, args.causal, args.bi_split, P);
    const int lim1 = DKV ? first_row(r1, args.causal, args.bi_split, P)
                         : visible_cols(r1, args.causal, args.bi_split, P);
    // the segment-id range of this warpgroup's 64 rows (tile_range's)
    int omin = min(rows.t0 > 0 ? rows.t0 : 0x7fffffff, rows.t1 > 0 ? rows.t1 : 0x7fffffff);
    int omax = max(rows.t0, rows.t1);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      omin = min(omin, __shfl_xor_sync(0xffffffffu, omin, o));
      omax = max(omax, __shfl_xor_sync(0xffffffffu, omax, o));
    }
    // a row's segment id, the key a visiting column must match; -1 (no
    // match) for a padded row
    const int k0 = s0 > 0 ? s0 : -1, k1 = s1 > 0 ? s1 : -1;
    // flash_dq: lse log2(e) and delta of the own rows
    const float l2e0 = rows.lse0 * LOG2E, l2e1 = rows.lse1 * LOG2E;
    float dl0 = 0.f, dl1 = 0.f;

    mbar_wait(own_full, ophase);
    ophase ^= 1;
    const int nv = hdr[0];
    uint32_t a1[4][4], a2[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      ldmatrix_x4(a1[kk], sbase + L::OWN + (aoff ^ (32 * kk)));
      ldmatrix_x4(a2[kk], sbase + L::OWN + HALF + (aoff ^ (32 * kk)));
    }
    if (!DKV) {
      // delta = rowsum(do * out) - dlse for rows r0, r1 (a quad holds a row)
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t o[4];
        ldmatrix_x4(o, sbase + L::OWN + 2 * HALF + (aoff ^ (32 * kk)));
        sum0 += lo_f(a2[kk][0]) * lo_f(o[0]) + hi_f(a2[kk][0]) * hi_f(o[0]) +
                lo_f(a2[kk][2]) * lo_f(o[2]) + hi_f(a2[kk][2]) * hi_f(o[2]);
        sum1 += lo_f(a2[kk][1]) * lo_f(o[1]) + hi_f(a2[kk][1]) * hi_f(o[1]) +
                lo_f(a2[kk][3]) * lo_f(o[3]) + hi_f(a2[kk][3]) * hi_f(o[3]);
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
      }
      dl0 = (s0 > 0 ? sum0 : 0.f) - rows.dlse0;
      dl1 = (s1 > 0 ? sum1 : 0.f) - rows.dlse1;
      if (t == 0) {
        if (r0 < P) args.delta[rowbase + r0] = dl0;
        if (r1 < P) args.delta[rowbase + r1] = dl1;
      }
      // do of a padded row takes part in no product
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (s0 == 0) a2[kk][0] = a2[kk][2] = 0u;
        if (s1 == 0) a2[kk][1] = a2[kk][3] = 0u;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(own_empty);

    if (args.rope) {
      mbar_wait(rope_full, rphase);
      rphase ^= 1;
      // rotate q (or k) in registers: k-steps kk and kk + 2 hold columns d
      // and d + 32 in the same registers
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t c0[4], c2[4], n0[4], n2[4];
        ldmatrix_x4(c0, sbase + L::COS + (aoff ^ (32 * kk)));
        ldmatrix_x4(c2, sbase + L::COS + (aoff ^ (32 * (kk + 2))));
        ldmatrix_x4(n0, sbase + L::SIN + (aoff ^ (32 * kk)));
        ldmatrix_x4(n2, sbase + L::SIN + (aoff ^ (32 * (kk + 2))));
#pragma unroll
        for (int r = 0; r < 4; ++r) rope2(a1[kk][r], a1[kk + 2][r], c0[r], c2[r], n0[r], n2[r]);
      }
    }

    float acc1[32], acc2[32];  // flash_dq: dq; flash_dkv: dk, dv
#pragma unroll
    for (int j = 0; j < 32; ++j) acc1[j] = acc2[j] = 0.f;

    for (int s = 0; s < nv; ++s) {
      mbar_wait(ring_full(stage), phase);
      if (pass) mbar_wait(ring_ready(stage), phase);
      const Meta& m = meta[stage];
      const int v0 = m.v0;
      const uint32_t sb = sbase + L::RING + stage * L::STAGE;
      const bool skip = ranges_miss(omin, omax, m.lo, m.hi) ||
                        (tri && (DKV ? v0 + 63 < wrow0 : v0 > wrow0 + 63));
      if (!skip) {
        float sc[32], dp[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) sc[j] = dp[j] = 0.f;
        pin_all(sc);
        pin_all(dp);
        pin_all(a1);
        pin_all(a2);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma64<0>(sc, a1[kk], desc_sw128(sb) + 2 * kk, kk > 0);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma64<0>(dp, a2[kk], desc_sw128(sb + BOX) + 2 * kk, kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        pin_all(sc);
        pin_all(dp);
        pin_all(a1);
        pin_all(a2);
        // p and ds in the accumulator layout (fragment j: columns 8j + 2t,
        // +1 of rows g and g + 8), packed straight into the A layout of
        // k-step j / 2 (registers 0, 1 for even j, 2, 3 for odd)
        uint32_t pa[4][4], da[4][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 8 * j + 2 * t;
          const int2 sv = *reinterpret_cast<const int2*>(&m.seg[c]);
          float lc0 = 0.f, lc1 = 0.f, dc0 = 0.f, dc1 = 0.f;
          if (DKV) {
            const float2 l2 = *reinterpret_cast<const float2*>(&m.lse[c]);
            const float2 d2 = *reinterpret_cast<const float2*>(&m.delta[c]);
            lc0 = l2.x * LOG2E, lc1 = l2.y * LOG2E, dc0 = d2.x, dc1 = d2.y;
          }
          float pv[4], dv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = e < 2 ? k0 : k1, lim = e < 2 ? lim0 : lim1;
            const int col = v0 + c + (e & 1);
            const bool ok = ((e & 1) ? sv.y : sv.x) == key && (DKV ? col >= lim : col < lim);
            const float l2e = DKV ? ((e & 1) ? lc1 : lc0) : (e < 2 ? l2e0 : l2e1);
            const float del = DKV ? ((e & 1) ? dc1 : dc0) : (e < 2 ? dl0 : dl1);
            // branch-free: a masked logit goes to -inf, whose 2^ is 0. (With
            // expf, whose accurate path branches around every element,
            // ptxas (CUDA 12.9) gave the registers of the do fragment, a
            // wgmma A operand live across the loop, to temporaries: dP
            // read garbage from the second visiting tile on.)
            const float pe = ex2(ok ? fmaf(sc[4 * j + e], LOG2E, -l2e) : -INFINITY);
            pv[e] = pe;
            dv[e] = ok ? pe * (dp[4 * j + e] - del) : 0.f;
          }
          const int kk = j >> 1, hi = (j & 1) * 2;
          pa[kk][hi] = pack2(pv[0], pv[1]);
          pa[kk][hi + 1] = pack2(pv[2], pv[3]);
          da[kk][hi] = pack2(dv[0], dv[1]);
          da[kk][hi + 1] = pack2(dv[2], dv[3]);
        }
        // the sums stay in their registers from before the products to after
        // the wait: a copy the compiler made in between would read them
        // before the products land
        pin_all(acc1);
        if (DKV) pin_all(acc2);
        pin_all(da);
        if (DKV) pin_all(pa);
        wgmma_fence();
        if (DKV) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)  // dv += bf16(p)^T do
            wgmma64<1>(acc2, pa[kk], desc_mn(sb + BOX) + 128 * kk, 1);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // dq += ds rot(k); dk += ds^T rot(q)
          wgmma64<1>(acc1, da[kk], desc_mn(sb) + 128 * kk, 1);
        wgmma_commit();
        wgmma_wait<0>();
        pin_all(acc1);
        if (DKV) pin_all(acc2);
        pin_all(da);
        if (DKV) pin_all(pa);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(ring_empty(stage));
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    // epilogue: the inverse rotation in fp32 (x c - rotate_half(x) s), each
    // value rounded to bf16 once into this warpgroup's staging box, then one
    // TMA store a box; the boxes are written again only once the last
    // item's stores have read them
    const uint32_t box0 = sbase + L::OUT + wg * BOX;
    if ((tid & 127) == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    bar_sync(2 + wg, 128);
    // row g's staging address with its chunk bits holding g; row g + 8 is
    // 1024 on (the same swizzle); fragment j's chunk is j ^ g
    const uint32_t rowg = (box0 + (w4 * 16 + g) * 128 + t * 4) ^ (g << 4);
    if (args.rope) {
      const uint8_t* cs = base + L::COS + (wg * 64 + w4 * 16 + g) * 128 + t * 4;
      const uint8_t* sn = base + L::SIN + (wg * 64 + w4 * 16 + g) * 128 + t * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {  // rows g, g + 8
          const uint32_t ox = ((j ^ g) << 4) + r * 1024, oy = (((j + 4) ^ g) << 4) + r * 1024;
          const uint32_t cx = *reinterpret_cast<const uint32_t*>(cs + ox);
          const uint32_t cy = *reinterpret_cast<const uint32_t*>(cs + oy);
          const uint32_t sx = *reinterpret_cast<const uint32_t*>(sn + ox);
          const uint32_t sy = *reinterpret_cast<const uint32_t*>(sn + oy);
          float& x0 = acc1[4 * j + 2 * r];
          float& x1 = acc1[4 * j + 2 * r + 1];
          float& y0 = acc1[4 * (j + 4) + 2 * r];
          float& y1 = acc1[4 * (j + 4) + 2 * r + 1];
          const float nx0 = x0 * lo_f(cx) + y0 * lo_f(sx), nx1 = x1 * hi_f(cx) + y1 * hi_f(sx);
          const float ny0 = y0 * lo_f(cy) - x0 * lo_f(sy), ny1 = y1 * hi_f(cy) - x1 * hi_f(sy);
          x0 = nx0, x1 = nx1, y0 = ny0, y1 = ny1;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t at = rowg ^ (j << 4);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at), "r"(pack2(acc1[4 * j], acc1[4 * j + 1])));
      asm volatile("st.shared.b32 [%0+1024], %1;\n" ::"r"(at),
                   "r"(pack2(acc1[4 * j + 2], acc1[4 * j + 3])));
      if (DKV) {
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at + HALF),
                     "r"(pack2(acc2[4 * j], acc2[4 * j + 1])));
        asm volatile("st.shared.b32 [%0+1024], %1;\n" ::"r"(at + HALF),
                     "r"(pack2(acc2[4 * j + 2], acc2[4 * j + 3])));
      }
    }
    fence_proxy_async();
    bar_sync(2 + wg, 128);
    if ((tid & 127) == 0 && wrow0 < P) {
      tma_store_3d(&st1, box0, it.h * DH, wrow0, it.b);
      if (DKV) tma_store_3d(&st2, box0 + HALF, it.h * DH, wrow0, it.b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
    if (args.rope) {
      __syncwarp();
      if (lane == 0) mbar_arrive(rope_empty);
    }
  }
  if ((tid & 127) == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Error codes of the C entries beside CUDA's own (all below 1000).
constexpr int ERR_NO_ENCODE = 1000;  // cuTensorMapEncodeTiled not found in the driver
constexpr int ERR_ENCODE = 1001;     // a tensor map was refused
constexpr int ERR_P = 1002;          // P past MAX_P
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

// The launch: tensors in the roles of the DKV kernel (own1..3, vis1, vis2,
// st1, st2; null where unused); one CTA an SM, at most one an item.
template <bool DKV>
int launch(const void* own1, const void* own2, const void* own3, const void* vis1,
           const void* vis2, const void* cos, const void* sin, void* st1, void* st2,
           const Args& args, cudaStream_t stream) {
  if (args.P > MAX_P) return ERR_P;
  if (args.B == 0 || args.P == 0 || args.H == 0) return 0;
  static bool configured[MAX_DEVICES] = {};
  static int sms[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return ERR_DEVICE;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(split_kernel<DKV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Layout<DKV>::BYTES);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  const EncodeTiled fn = encode_fn();
  if (!fn) return ERR_NO_ENCODE;
  const int B = args.B, P = args.P, W = args.H * DH;
  CUtensorMap m[9];
  const void* tok[7] = {own1, own2, own3 ? own3 : own1, vis1, vis2, st1, st2 ? st2 : st1};
  const int slot[7] = {0, 1, 2, 3, 4, 7, 8};
  for (int i = 0; i < 7; ++i)
    if (!encode3(fn, &m[slot[i]], tok[i], B, P, W)) return ERR_ENCODE;
  // without RoPE the cos/sin maps are never read: any valid map will do
  if (!encode3(fn, &m[5], cos ? cos : own1, B, P, cos ? DH : W) ||
      !encode3(fn, &m[6], sin ? sin : own1, B, P, sin ? DH : W))
    return ERR_ENCODE;
  const int items = B * ((P + ROWS - 1) / ROWS) * args.H;
  const int grid = items < sms[dev] ? items : sms[dev];
  split_kernel<DKV><<<grid, NTHREADS, Layout<DKV>::BYTES, stream>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7], m[8], args);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace split_bwd

// C entries for ctypes, on `stream`; each returns the first CUDA error (0
// when its launch was accepted), or one of the codes above 999.
// flash_dq: dq, and delta into the caller's fp32 [B, H, P] `delta` (dlse
// may be null: zeros). flash_dkv: dk, dv, reading that delta.
extern "C" int ggt_flash_dq(const void* q, const void* k, const void* v, const void* seg,
                            const void* cos, const void* sin, const void* out,
                            const void* lse, const void* dout, const void* dlse,
                            void* delta, void* dq, int B, int P, int H, int causal,
                            int bi_split, void* stream) {
  using namespace split_bwd;
  const Args args{(const int*)seg, (const float*)lse, (const float*)dlse, (float*)delta,
                  B, P, H, causal, bi_split, cos != nullptr};
  return launch<false>(q, dout, out, k, v, cos, sin, dq, nullptr, args, (cudaStream_t)stream);
}

extern "C" int ggt_flash_dkv(const void* q, const void* k, const void* v, const void* seg,
                             const void* cos, const void* sin, const void* lse,
                             const void* delta, const void* dout, void* dk, void* dv,
                             int B, int P, int H, int causal, int bi_split, void* stream) {
  using namespace split_bwd;
  const Args args{(const int*)seg, (const float*)lse, nullptr, (float*)delta,
                  B, P, H, causal, bi_split, cos != nullptr};
  return launch<true>(k, v, nullptr, q, dout, cos, sin, dk, dv, args, (cudaStream_t)stream);
}
