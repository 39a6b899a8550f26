// The split flash attention backward with in-kernel RoPE, for Hopper: one
// kernel body in two forms, each two kernels launched one after the other,
// flash_dq (with delta) then flash_dkv.
//
// The single form, #4 flash_dq and #5 flash_dkv, replaces
// graphgpt_tpu/ops/flash_attention.py:602 _dq_kernel_single and :789
// _dkv_kernel_single, which _flash_bwd :902 launches instead of the fused
// kernel when bi_split > 0 (the denoise model's bi-causal energy decoding)
// and P <= 2048. The stream form (STREAM), #7 flash_dq_stream and #8
// flash_dkv_stream, replaces :645 _dq_kernel_stream and :835
// _dkv_kernel_stream, which _flash_bwd launches above P = 2048 (kv blocks of
// 1024, so more than one; the port's long-context pretraining at P 4096) and
// under GGT_FLASH_MODE=skip at every P. q (pre-scaled, not rotated), k, v,
// do, out are token-major bf16 [B, P, H*64]; lse and the optional dlse fp32
// [B, H, P]; optional cos/sin bf16 [B, P, 64]; the single form takes one
// seg int32 [B, P] and P <= 2048, the stream form seg_q and seg_k, two
// arrays (a ring chunk's keys carry another chunk's ids; the model passes
// one array twice), and any P. The JAX package computes
// delta = rowsum(do * out) - dlse outside its kernels (:933-940); here
// flash_dq computes it for its own rows, uses it, and writes delta
// [B, H, P] for flash_dkv (a padded row's delta is -dlse). With
// S = rot(q) rot(k)^T + mask and p = exp(S - lse):
//   flash_dq:  ds = p * (do v^T - delta) rounded to bf16, dq = ds rot(k)
//   flash_dkv: dv = bf16(p)^T do,  dk = ds^T rot(q)
// in fp32 sums, the inverse rotation applied to the fp32 dq and dk, each
// rounded to bf16 once; the rotation keeps the plain rotate_tokens'
// roundings. The mask is the segment rule (seg_q[row] ==
// seg_k[col] > 0) with the bi-causal (or causal) rule of flash_common.cuh,
// whose split may fall inside a 64-row tile. A padded row (segment 0) gives
// dq = 0 and takes no part in dk and dv; its do is zeroed before any
// product, so that a non-finite value there reaches no output. A query row
// that sees no key, or a key that no query sees, gives 0.
//
// What bounds it on the H100: bytes. At the denoise shape (B 256, P 88,
// H 12) flash_dq reads q, k, v, do, out (5 x 34.6 MB), cos, sin and lse and
// writes delta and dq; flash_dkv reads q, k, v, do, cos, sin, lse and delta
// and writes dk and dv: ~216 MB each, 64 us of HBM time, against ~9 and
// ~12 GFLOP of dense products (~10 us). At the long-context shape (B 16,
// P 4096, H 12; 100.7 MB a token-major tensor) each moves ~627 MB, 0.187 ms,
// against 12-16 GFLOP of products on ~32-token packed segments (~16 us).
//
// Design. One kernel body for both, DKV choosing the roles: a work item is
// 128 own rows of one (batch row, head) (queries in flash_dq, keys in
// flash_dkv), and the kernel is persistent: one CTA an SM walks a
// contiguous run of items with the head fastest, so that one CTA reuses a
// row's cos/sin and segment ids across its heads (B 16 x P 4096 x H 12 is
// 6,144 items on 132 SMs). A CTA is three warpgroups:
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
// What the stream form changes: the own rows' ids and the visiting rows'
// ids come from their two arrays (flash_dq: own seg_q, visiting seg_k;
// flash_dkv: own seg_k, visiting seg_q), and every walker of the ring (the
// producer, the pass warps, the consumers' per-tile and per-item ranges)
// takes the tiles' segment-id ranges from the tile tables (tile_table.cuh),
// which the entry writes first: one int2 a tile, where the single form's
// walkers read a tile's 64 ids and reduce them by shuffles. The visiting
// tiles of an item go in 64-bit masks of 64 tiles, counted over every chunk
// first, so that no P limit applies; the single form keeps one 32-bit mask
// (P <= MAX_P).
// setmaxnreg gives the consumers 224 registers and the producers 56. Only
// the producers' waits time out (4 s, then trap); they wait last for every
// stage to be handed back. No split-K and no atomics: two launches on the
// same inputs give the same bits.

#include "flash_common.cuh"  // DH, the segment-range test, the causal and bi-causal bounds
#include "sm90_common.cuh"   // TMA, mbarriers, wgmma descriptors, the tensor-map encoder
#include "flash_sm90.cuh"    // wgmma64, desc_mn, ex2, bf16x2 RoPE, the visiting mask, encode3
#include "tile_table.cuh"    // the stream form's tile tables and table_mask

namespace split_bwd {
namespace {

using namespace sm90;

constexpr int ROWS = 128;          // own rows of a work item: two consumer warpgroups of 64
constexpr int NTHREADS = 384;      // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int CONSUMERS = 256;
constexpr int STAGES = 3;
constexpr int BOX = 64 * DH * 2;   // one [64, 64] bf16 box, 8 KB
constexpr int HALF = ROWS * DH * 2;  // a [128, 64] own tile: two boxes
constexpr int MAX_P = 2048;        // the single form: an item's visiting tiles fit one 32-bit mask

// A visiting tile's row data. seg, lse, delta arrive by cp.async (zeros
// past P); v0, lo, hi, rope_own are written by producer lane 0.
struct Meta {
  int seg[64];
  float lse[64];
  float delta[64];
  int v0;        // the tile's first row
  int lo, hi;    // its segment-id range (tile_range, or the stream form's table)
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
  const int* seg;      // [B, P]: the own rows' ids (the single form: every row's)
  const float* lse;    // [B, H, P]
  const float* dlse;   // flash_dq: [B, H, P] or null
  float* delta;        // flash_dq writes it, flash_dkv reads it
  int B, P, H, causal, bi_split, rope;
  // the stream form: the visiting rows' ids [B, P], and the own and the
  // visiting rows' tile tables [B, ceil(P/64)] (tile_table_kernel)
  const int* segv;
  const int2* tabo;
  const int2* tabv;
};

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

template <bool DKV, bool STREAM>
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
  const int nblk = (P + ROWS - 1) / ROWS, nt = (P + 63) / 64;
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
        const int* segv = STREAM ? args.segv + (long long)it.b * P : segb;  // visiting ids
        const int2* tabo = STREAM ? args.tabo + (long long)it.b * nt : nullptr;
        const int2* tabv = STREAM ? args.tabv + (long long)it.b * nt : nullptr;
        const long long rowbase = ((long long)it.b * H + it.h) * P;
        // the visiting tiles: one 32-bit mask (the single form), or 64-bit
        // masks of 64 tiles from the tables, counted over every chunk first
        uint32_t mask = 0;
        uint64_t mask0 = 0;
        int n;
        if constexpr (STREAM) {
          mask0 = table_mask(tabo, tabv, it.own0, nt, tri, DKV, lane, 0);
          n = __popcll(mask0);
          for (int c = 64; c < nt; c += 64)
            n += __popcll(table_mask(tabo, tabv, it.own0, nt, tri, DKV, lane, c));
        } else {
          mask = visiting_mask(segb, it.own0, P, tri, DKV, lane);
          n = __popc(mask);
        }
        const bool two = it.own0 + 64 < P;  // the own block's second box holds rows
        mbar_wait_or_trap(own_empty, ophase ^ 1);
        if (lane == 0) {
          hdr[0] = n;
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
        // visiting tile vt into the next stage
        auto visit = [&](int vt) {
          const int v0 = vt * 64;
          mbar_wait_or_trap(ring_empty(stage), phase ^ 1);
          Meta& m = meta[stage];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = lane + 32 * e, p = v0 + r;
            const bool ok = p < P;
            cp_async4(&m.seg[r], segv + (ok ? p : 0), ok);
            if (DKV) {
              cp_async4(&m.lse[r], args.lse + rowbase + (ok ? p : 0), ok);
              cp_async4(&m.delta[r], args.delta + rowbase + (ok ? p : 0), ok);
            }
          }
          cp_async_arrive(ring_full(stage));
          int lo, hi;
          if constexpr (STREAM) {
            lo = tabv[vt].x;
            hi = tabv[vt].y;
          } else {
            tile_range(segb, v0, P, lane, &lo, &hi);
          }
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
        };
        if constexpr (STREAM) {
          for (int c = 0; c < nt; c += 64) {
            uint64_t bits = mask0;
            if (c > 0) bits = table_mask(tabo, tabv, it.own0, nt, tri, DKV, lane, c);
            for (; bits; bits &= bits - 1) visit(c + __ffsll((long long)bits) - 1);
          }
        } else {
          for (; mask; mask &= mask - 1) visit(__ffs(mask) - 1);
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
        int n = 0;  // the item's visiting tiles, as the producer counts them
        if constexpr (STREAM) {
          const int2* tabo = args.tabo + (long long)it.b * nt;
          const int2* tabv = args.tabv + (long long)it.b * nt;
          for (int c = 0; c < nt; c += 64)
            n += __popcll(table_mask(tabo, tabv, it.own0, nt, tri, DKV, lane, c));
        } else {
          n = __popc(visiting_mask(args.seg + (long long)it.b * P, it.own0, P, tri, DKV, lane));
        }
        if (args.rope) {  // the own rows' cos and sin
          mbar_wait(rope_full, rphase);
          rphase ^= 1;
        }
        for (; n > 0; --n) {
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
  // lane; the stream form: the tile's range), and (flash_dq) the rows' lse
  // and dlse: loaded an item ahead, so that their latency hides under the
  // item before
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
    if constexpr (STREAM) {  // the stream form: the tile's range from the own rows' table
      const int2 tr = wrow0 < P ? args.tabo[(long long)it.b * nt + wrow0 / 64]
                                : make_int2(0x7fffffff, 0);
      r.t0 = tr.x;
      r.t1 = tr.y;
    } else {
      r.t0 = wrow0 + lane < P ? segb[wrow0 + lane] : 0;
      r.t1 = wrow0 + lane + 32 < P ? segb[wrow0 + lane + 32] : 0;
    }
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
    int omin, omax;
    if constexpr (STREAM) {
      omin = rows.t0;
      omax = rows.t1;
    } else {
      omin = min(rows.t0 > 0 ? rows.t0 : 0x7fffffff, rows.t1 > 0 ? rows.t1 : 0x7fffffff);
      omax = max(rows.t0, rows.t1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        omin = min(omin, __shfl_xor_sync(0xffffffffu, omin, o));
        omax = max(omax, __shfl_xor_sync(0xffffffffu, omax, o));
      }
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

// The launch: tensors in the roles of the DKV kernel (own1..3, vis1, vis2,
// st1, st2; null where unused); one CTA an SM, at most one an item.
template <bool DKV, bool STREAM>
int launch(const void* own1, const void* own2, const void* own3, const void* vis1,
           const void* vis2, const void* cos, const void* sin, void* st1, void* st2,
           const Args& args, cudaStream_t stream) {
  if (!STREAM && args.P > MAX_P) return ERR_P;
  if (args.B == 0 || args.P == 0 || args.H == 0) return 0;
  static bool configured[MAX_DEVICES] = {};
  static int sms[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return ERR_DEVICE;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(split_kernel<DKV, STREAM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  split_kernel<DKV, STREAM><<<grid, NTHREADS, Layout<DKV>::BYTES, stream>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7], m[8], args);
  return (int)cudaGetLastError();
}

// The stream form's entries take seg_q and seg_k and `tab`, int32 scratch of
// 4 x B x ceil(P/64) from the caller; each first writes the tile tables of
// seg_q and seg_k there (one when they are one array), then launches its
// kernel. Any P.
// flash_dq_stream: own rows are queries (ids seg_q), visiting rows keys
// (seg_k). flash_dkv_stream: the other way round.
int launch_stream(bool dkv, const void* own1, const void* own2, const void* own3,
                  const void* vis1, const void* vis2, const void* segq, const void* segk,
                  const void* cos, const void* sin, void* st1, void* st2, void* tab, Args args,
                  cudaStream_t stream) {
  if (args.B == 0 || args.P == 0 || args.H == 0) return 0;
  const int2 *tq, *tk;
  const cudaError_t err = launch_tables(segq, segk, tab, args.B, args.P, stream, &tq, &tk);
  if (err != cudaSuccess) return (int)err;
  args.seg = (const int*)(dkv ? segk : segq);
  args.segv = (const int*)(dkv ? segq : segk);
  args.tabo = dkv ? tk : tq;
  args.tabv = dkv ? tq : tk;
  return dkv ? launch<true, true>(own1, own2, own3, vis1, vis2, cos, sin, st1, st2, args, stream)
             : launch<false, true>(own1, own2, own3, vis1, vis2, cos, sin, st1, st2, args,
                                   stream);
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
  return launch<false, false>(q, dout, out, k, v, cos, sin, dq, nullptr, args,
                              (cudaStream_t)stream);
}

extern "C" int ggt_flash_dkv(const void* q, const void* k, const void* v, const void* seg,
                             const void* cos, const void* sin, const void* lse,
                             const void* delta, const void* dout, void* dk, void* dv,
                             int B, int P, int H, int causal, int bi_split, void* stream) {
  using namespace split_bwd;
  const Args args{(const int*)seg, (const float*)lse, nullptr, (float*)delta,
                  B, P, H, causal, bi_split, cos != nullptr};
  return launch<true, false>(k, v, nullptr, q, dout, cos, sin, dk, dv, args,
                             (cudaStream_t)stream);
}

// #7: dq, and delta into the caller's fp32 [B, H, P] `delta` (dlse may be
// null: zeros), summed in the kernel: one launch after the tables.
extern "C" int ggt_flash_dq_stream(const void* q, const void* k, const void* v,
                                   const void* segq, const void* segk, const void* cos,
                                   const void* sin, const void* out, const void* lse,
                                   const void* dout, const void* dlse, void* delta, void* dq,
                                   void* tab, int B, int P, int H, int causal, int bi_split,
                                   void* stream) {
  using namespace split_bwd;
  const Args args{nullptr, (const float*)lse, (const float*)dlse, (float*)delta,
                  B, P, H, causal, bi_split, cos != nullptr};
  return launch_stream(false, q, dout, out, k, v, segq, segk, cos, sin, dq, nullptr, tab, args,
                       (cudaStream_t)stream);
}

// #8: dk, dv, reading flash_dq_stream's delta.
extern "C" int ggt_flash_dkv_stream(const void* q, const void* k, const void* v,
                                    const void* segq, const void* segk, const void* cos,
                                    const void* sin, const void* lse, const void* delta,
                                    const void* dout, void* dk, void* dv, void* tab, int B,
                                    int P, int H, int causal, int bi_split, void* stream) {
  using namespace split_bwd;
  const Args args{nullptr, (const float*)lse, nullptr, (float*)delta,
                  B, P, H, causal, bi_split, cos != nullptr};
  return launch_stream(true, k, v, nullptr, q, dout, segq, segk, cos, sin, dk, dv, tab, args,
                       (cudaStream_t)stream);
}
