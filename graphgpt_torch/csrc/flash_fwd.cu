// Segment-masked flash attention forward, for Hopper: one kernel body in
// three forms, each behind its own C entry.
//
// SINGLE, #1 flash_fwd, replaces graphgpt_tpu/ops/flash_attention.py:124
// _fwd_kernel_single (the TPU's single-block forward, launched by _flash_fwd
// :409 when P <= 2048). q (pre-scaled), k, v are token-major bf16
// [B, P, H*64]; seg int32 [B, P] (0 = padding, equal ids = one packed
// segment); optional cos/sin bf16 [B, P, 64] with the halves duplicated,
// applied to q and k in bf16 with three roundings (the plain
// rotate_tokens'); out bf16 [B, P, H*64]; lse fp32 [B, H, P]. The mask is
// the segment rule plus causal, or, with bi_split > 0, the bi-causal rule of
// the denoise model's energy decoding (visible_cols in flash_common.cuh; the
// split may fall inside a 64-row tile). p = exp(S - m) with fp32 row sums,
// rounded to bf16 for the PV product; out = PV (1 / l) rounded once; lse =
// m + ln l. A padded row, or one that sees no key, gives out = 0 exactly and
// lse = -1e30. The entry takes any P (the dispatch gives it P <= 2048).
//
// STREAM, #6 flash_fwd_stream, replaces :177 _fwd_kernel_stream, which
// _flash_fwd launches above P = 2048 (the port's long-context pretraining at
// P 4096) and under GGT_FLASH_MODE=skip at every P, and which ring
// attention's chunks take. The same contract with two id arrays, seg_q and
// seg_k (a ring chunk's keys carry another chunk's ids; the model passes
// one array twice; a query row that sees no key gives 0, the port's rule),
// and any P. The entry first writes the tile tables of seg_q and seg_k
// (tile_table.cuh), and every walker of the ring takes a tile's segment-id
// range from them: one int2 a tile, where SINGLE's walkers read a tile's 64
// ids and reduce them by redux.sync.
//
// BAND, #9 flash_fwd_band, replaces :282 _fwd_kernel_band, which _flash_fwd
// launches under GGT_FLASH_MODE=band for P <= 4096: STREAM's contract with
// q and k already rotated (no cos, sin: the band path applies RoPE
// outside). The entry first writes the band table (tile_table.cuh's
// band_table_kernel, the plain `band_limits`): for each 64-row q tile the
// first and last key positions whose id lies in the tile's id range, which
// hold every key a row of the tile can match. An item walks the key tiles
// from the first of its two q tiles' bands to the last, the top clipped to
// the columns its last row sees (the JAX kernel's clip, :293-303); a
// warpgroup whose own tile's band misses a key tile skips its products.
//
// What bounds it on the H100: bytes. On packed rows (~32-token segments) a
// query meets a few dozen keys, so the masked work is ~1 GFLOP against
// ~53 MB of q, k, v, out at B 8, P 1024, H 12 (16 us of HBM time); at the
// denoise shape (B 256 x P 88, bi-causal) ~145 MB, 43 us; at B 16 x P 4096
// (65,536 tokens) ~423 MB with cos, sin and lse, 0.126 ms (#9 without cos,
// sin ~406 MB, 0.121 ms).
//
// Design (the machinery of the split backward, flash_bwd_split.cu, on the
// pieces of flash_sm90.cuh). Persistent: one CTA an SM walks a contiguous
// run of work items (b, 128-row q block, h), the head fastest, so that the
// row's ids, cos and sin stay hot across its heads; at P <= 128 an item
// holds the whole row, and each key tile is loaded and rotated once per
// (row, head). A CTA is three warpgroups:
//  - producer warp 8 finds the 64-row key tiles that meet the item's
//    segment-id range (and the causal range), in 64-bit masks of 64 tiles
//    counted over every chunk first (SINGLE: the tiles' id ranges by
//    redux.sync; STREAM: the tables; BAND: the band's stretch), TMA-loads the
//    item's q block once and streams k and v (with their rows' cos and sin
//    where those rows lie outside the own block) through a 4-stage ring with
//    full and empty mbarriers; its lanes copy each key tile's ids with
//    cp.async into the stage. 3D tensor maps {64 H, P, B}, boxes of
//    [64, 64], 128-byte swizzled: rows past P arrive as zeros and cost no
//    bytes. Warp 9 loads the own rows' cos and sin once a row block: its
//    items (the heads) share one phase of the rope barriers, so the next
//    item's tiles are rotated while this one runs. Warps 10 and 11 rotate
//    each landed k in place, once, with bf16x2 arithmetic, and mark the
//    stage ready;
//  - two consumer warpgroups own 64 q rows each: q into registers with
//    ldmatrix, rotated there; per ready stage S = q k^T as wgmma m64n64k16
//    (A from registers, k K-major), the mask and the online softmax in the
//    accumulator layout (two rows a thread, running max floored at -1e30 so
//    that a row with no key yet never forms inf - inf), p = 2^(S log2 e -
//    m log2 e) by ex2.approx, branch-free, packed as bf16 straight into the
//    A-operand layout, O rescaled after the last product's wait, then
//    O += P V with V MN-major through wgmma's transpose bit. A warpgroup
//    whose 64 rows cannot meet the tile skips its products;
//  - the epilogue multiplies by 1 / l, rounds once into a swizzled staging
//    box and stores it by TMA (rows past P are not written); lse takes plain
//    stores.
// The three forms visit the same key tiles of a row wherever their ids
// can match, in the same order, so on one id array STREAM gives SINGLE's
// bits. setmaxnreg gives the consumers 224 registers and the producers 56.
// Only the producers' waits time out (4 s, then trap). No atomics: two
// launches on the same inputs give the same bits.

#include "flash_sm90.cuh"  // wgmma64, desc_mn, ex2, bf16x2 RoPE, the visiting mask, encode3
#include "tile_table.cuh"  // STREAM's tile tables and table_mask, BAND's band table and mask

namespace fwd_sm90 {
namespace {

using namespace sm90;

constexpr int ROWS = ITEM_ROWS;   // q rows of a work item: two consumer warpgroups of 64
constexpr int NTHREADS = 384;     // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int CONSUMERS = 256;
constexpr int STAGES = 4;  // 3 read 10% slower at B 64 x P 1024 (split_probe)
constexpr int BOX = 64 * DH * 2;  // one [64, 64] bf16 box, 8 KB
constexpr int HALF = ROWS * DH * 2;

// The forms of the body (the template argument).
constexpr int SINGLE = 0, STREAM = 1, BAND = 2;

// A key tile's ids (cp.async from the key ids, zeros past P) and what
// producer lane 0 writes.
struct Meta {
  int seg[64];
  int v0;        // the tile's first row
  int lo, hi;    // its segment-id range (tile_range; STREAM: the table's; BAND: unused)
  int rope_own;  // 1: its rows lie in the own block, whose cos/sin are in the rope buffer
};

// Shared memory from a 1024-aligned base: q, the own rows' cos and sin, the
// ring (per stage k, v and their rows' cos, sin), the out staging, the stage
// metadata, the item header, the barriers.
struct Layout {
  static constexpr int OWN = 0;
  static constexpr int COS = OWN + HALF;
  static constexpr int SIN = COS + HALF;
  static constexpr int RING = SIN + HALF;
  static constexpr int STAGE = 4 * BOX;  // k, v, cos, sin
  static constexpr int OUT = RING + STAGES * STAGE;
  static constexpr int META = OUT + HALF;
  static constexpr int HDR = META + STAGES * (int)sizeof(Meta);
  static constexpr int BARS = (HDR + 16 + 7) & ~7;
  // own_full, own_empty, rope_full, rope_empty, ring_full[STAGES], ring_empty[STAGES],
  // ring_ready[STAGES]
  static constexpr int END = BARS + (4 + 3 * STAGES) * 8;
  static constexpr size_t BYTES = 1024 + (size_t)END;
};

struct Args {
  const int* seg;  // [B, P]: the query rows' ids (SINGLE: every row's)
  float* lse;      // [B, H, P]
  int B, P, H, causal, bi_split, rope;
  // STREAM, BAND: the key rows' ids [B, P]. STREAM: the query and the key
  // rows' tile tables [B, ceil(P/64)] (tile_table_kernel); BAND: tabq the
  // query tiles' band table (band_table_kernel)
  const int* segk;
  const int2* tabq;
  const int2* tabk;
};

template <int FORM>
__global__ void __launch_bounds__(NTHREADS, 1)
fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tcos,
           const __grid_constant__ CUtensorMap tsin, const __grid_constant__ CUtensorMap tout,
           const Args args) {
  using L = Layout;
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
  // the item's key tiles in the chunk of 64 from tile c, bit vt - c; every
  // lane of the calling warp takes part
  auto key_tiles = [&](const Item& it, int c) -> uint64_t {
    if constexpr (FORM == SINGLE) {
      return visiting_mask<uint64_t, true>(args.seg + (long long)it.b * P, it.own0, P, tri, false,
                                           lane, c);
    } else if constexpr (FORM == STREAM) {
      return table_mask(args.tabq + (long long)it.b * nt, args.tabk + (long long)it.b * nt,
                        it.own0, nt, tri, false, lane, c);
    } else {
      return band_mask(args.tabq + (long long)it.b * nt, it.own0, nt, P, args.causal,
                       args.bi_split, false, c);
    }
  };

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
      // q and the ring
      int stage = 0;
      uint32_t phase = 0, ophase = 0;
      for (int i = first; i < last; ++i) {
        const Item it = decode(i, H, nblk);
        // the key ids
        const int* segb = (FORM == SINGLE ? args.seg : args.segk) + (long long)it.b * P;
        // the key tiles, 64 to a mask; rows past 4096 take more masks
        const uint64_t mask0 = key_tiles(it, 0);
        int n = __popcll(mask0);
        for (int c = 64; c < nt; c += 64) n += __popcll(key_tiles(it, c));
        const bool two = it.own0 + 64 < P;  // the q block's second box holds rows
        mbar_wait_or_trap(own_empty, ophase ^ 1);
        if (lane == 0) {
          hdr[0] = n;
          mbar_expect_tx(own_full, (two ? 2 : 1) * BOX);
          tma_load_3d(sbase + L::OWN, &tq, own_full, it.h * DH, it.own0, it.b);
          if (two) tma_load_3d(sbase + L::OWN + BOX, &tq, own_full, it.h * DH, it.own0 + 64, it.b);
        }
        ophase ^= 1;
        for (int c = 0; c < nt; c += 64) {
          uint64_t mask = c == 0 ? mask0 : key_tiles(it, c);
          while (mask) {
            const int vt = c + __ffsll((long long)mask) - 1;
            mask &= mask - 1;
            const int v0 = vt * 64;
            mbar_wait_or_trap(ring_empty(stage), phase ^ 1);
            Meta& m = meta[stage];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int r = lane + 32 * e, p = v0 + r;
              const bool ok = p < P;
              cp_async4(&m.seg[r], segb + (ok ? p : 0), ok);
            }
            cp_async_arrive(ring_full(stage));
            int lo = 0, hi = 0;
            if constexpr (FORM == SINGLE) {
              tile_range_redux(segb, v0, P, lane, &lo, &hi);
            } else if constexpr (FORM == STREAM) {
              const int2 r = args.tabk[(long long)it.b * nt + vt];
              lo = r.x;
              hi = r.y;
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
              tma_load_3d(dst, &tk, bar, it.h * DH, v0, it.b);
              tma_load_3d(dst + BOX, &tv, bar, it.h * DH, v0, it.b);
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
      }
      // every stage and the q buffer handed back: the consumers are past
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
      load_own_rope(&tcos, &tsin, sbase + L::COS, sbase + L::SIN, rope_full, rope_empty, first,
                    last, H, nblk, P);
    } else if (warp >= 10 && args.rope) {
      // RoPE on each landed k, in place, off the consumers' path: 64
      // threads, each the 16-byte chunks c and c + 4 (columns d and d + 32)
      // of four rows, at their swizzled places
      const int u = tid - 320;
      int stage = 0;
      uint32_t phase = 0, rphase = 0;
      for (int i = first; i < last; ++i) {
        const Item it = decode(i, H, nblk);
        for (int c = 0; c < nt; c += 64) {
          uint64_t mask = key_tiles(it, c);
          if (c == 0 && block_starts(i, first, H)) {  // the own rows' cos and sin
            mbar_wait(rope_full, rphase);
            rphase ^= 1;
          }
          for (; mask; mask &= mask - 1) {
            mbar_wait(ring_full(stage), phase);
            const Meta& m = meta[stage];
            const uint32_t b1 = sbase + L::RING + stage * L::STAGE;
            const uint32_t cs =
                m.rope_own ? sbase + L::COS + (m.v0 - it.own0) * 128 : b1 + 2 * BOX;
            const uint32_t sn = cs + (m.rope_own ? L::SIN - L::COS : BOX);
            // one row at a time: the producer warpgroup has 56 registers
#pragma unroll 1
            for (int q = 0; q < 4; ++q) {
              const int pr = (u >> 2) + 16 * q, pc = u & 3;
              const uint32_t plo = pr * 128 + ((pc ^ (pr & 7)) << 4);
              const uint32_t phi = pr * 128 + (((pc + 4) ^ (pr & 7)) << 4);
              uint4 x = lds128(b1 + plo), y = lds128(b1 + phi);
              rope16(x, y, lds128(cs + plo), lds128(cs + phi), lds128(sn + plo), lds128(sn + phi));
              sts128(b1 + plo, x);
              sts128(b1 + phi, y);
            }
            fence_proxy_async();
            __syncwarp();
            if (lane == 0) mbar_arrive(ring_ready(stage));
            if (++stage == STAGES) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
        __syncwarp();
        if (lane == 0 && block_ends(i, last, H)) mbar_arrive(rope_empty);
      }
    }
    return;
  }

  // ---- consumer warpgroups: q rows [64 wg, 64 wg + 64) of each item
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
  const int wg = warp >> 2, w4 = warp & 3, g = lane >> 2, t = lane & 3;
  // ldmatrix: lane l gives row (l & 7) + 8 ((l >> 3) & 1) of the warp's 16
  // and 16-byte half l >> 4 of a k-step, the swizzle's XOR (row & 7 = l & 7)
  // in the chunk bits; k-step kk is aoff ^ 32 kk (norm_qkv.cu's load_x)
  const uint32_t aoff = (wg * 64 + w4 * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * 128 +
                        (((lane >> 4) ^ (lane & 7)) << 4);
  int stage = 0;
  uint32_t phase = 0, ophase = 0, rphase = 0;

  // the ids of this thread's two rows and of the warp's 64-row tile (two a
  // lane; STREAM: the tile's range from the table; BAND: the tile's band),
  // loaded an item ahead so that their latency hides under the item before
  struct Rows {
    int s0, s1, t0, t1;
  };
  auto load_rows = [&](int i) {
    Rows r{};
    const Item it = decode(i, H, nblk);
    const int* segb = args.seg + (long long)it.b * P;
    const int wrow0 = it.own0 + wg * 64, r0 = wrow0 + w4 * 16 + g, r1 = r0 + 8;
    r.s0 = r0 < P ? segb[r0] : 0;
    r.s1 = r1 < P ? segb[r1] : 0;
    if constexpr (FORM == SINGLE) {
      r.t0 = wrow0 + lane < P ? segb[wrow0 + lane] : 0;
      r.t1 = wrow0 + lane + 32 < P ? segb[wrow0 + lane + 32] : 0;
    } else {
      const int2 none = FORM == BAND ? make_int2(P, -1) : make_int2(0x7fffffff, 0);
      const int2 tr = wrow0 < P ? args.tabq[(long long)it.b * nt + wrow0 / 64] : none;
      r.t0 = tr.x;
      r.t1 = tr.y;
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
    const int r0 = wrow0 + w4 * 16 + g, r1 = r0 + 8;  // this thread's rows
    // the rows see the key columns [0, lim)
    const int lim0 = visible_cols(r0, args.causal, args.bi_split, P);
    const int lim1 = visible_cols(r1, args.causal, args.bi_split, P);
    // the segment-id range of this warpgroup's 64 rows (tile_range's;
    // BAND: the first and last key position of their band)
    int omin, omax;
    if constexpr (FORM == SINGLE) {
      omin = min(rows.t0 > 0 ? rows.t0 : 0x7fffffff, rows.t1 > 0 ? rows.t1 : 0x7fffffff);
      omax = max(rows.t0, rows.t1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        omin = min(omin, __shfl_xor_sync(0xffffffffu, omin, o));
        omax = max(omax, __shfl_xor_sync(0xffffffffu, omax, o));
      }
    } else {
      omin = rows.t0;
      omax = rows.t1;
    }
    // BAND: the warpgroup's rows see no column from wlim on
    const int wlim =
        FORM == BAND ? visible_cols(min(wrow0 + 63, P - 1), args.causal, args.bi_split, P) : 0;
    // a row's segment id, the key a column must match; -1 (no match) for a
    // padded row
    const int k0 = rows.s0 > 0 ? rows.s0 : -1, k1 = rows.s1 > 0 ? rows.s1 : -1;

    mbar_wait(own_full, ophase);
    ophase ^= 1;
    const int nv = hdr[0];
    uint32_t a1[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) ldmatrix_x4(a1[kk], sbase + L::OWN + (aoff ^ (32 * kk)));
    __syncwarp();
    if (lane == 0) mbar_arrive(own_empty);

    if (args.rope) {
      if (block_starts(i, first, H)) {
        mbar_wait(rope_full, rphase);
        rphase ^= 1;
      }
      rope_a(a1, sbase + L::COS, sbase + L::SIN, aoff);  // q
    }

    // running max (natural units, floored at NEG), this thread's part of
    // the row sums, and O
    float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;
    float acc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = 0.f;

    for (int s = 0; s < nv; ++s) {
      mbar_wait(ring_full(stage), phase);
      if (args.rope) mbar_wait(ring_ready(stage), phase);
      const Meta& m = meta[stage];
      const int v0 = m.v0;
      const uint32_t sb = sbase + L::RING + stage * L::STAGE;
      bool skip;
      if constexpr (FORM == BAND) skip = v0 > omax || v0 + 63 < omin || v0 >= wlim;
      else skip = ranges_miss(omin, omax, m.lo, m.hi) || (tri && v0 > wrow0 + 63);
      if (!skip) {
        float sc[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) sc[j] = 0.f;
        pin_all(sc);
        pin_all(a1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma64<0>(sc, a1[kk], desc_sw128(sb) + 2 * kk, kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        pin_all(sc);
        pin_all(a1);
        // the mask in the accumulator layout (fragment j: columns 8j + 2t,
        // +1 of rows g and g + 8): a masked logit goes to -inf
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 8 * j + 2 * t;
          const int2 sv = *reinterpret_cast<const int2*>(&m.seg[c]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = e < 2 ? k0 : k1, lim = e < 2 ? lim0 : lim1;
            const bool ok = ((e & 1) ? sv.y : sv.x) == key && v0 + c + (e & 1) < lim;
            sc[4 * j + e] = ok ? sc[4 * j + e] : -INFINITY;
          }
          mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
          mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
        }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {  // a quad holds a row
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
        }
        // the floor keeps m finite: 2^(-inf - m) = 0 and alpha = 1 while a
        // row has seen no key
        const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
        const float al0 = ex2((m0 - n0) * LOG2E), al1 = ex2((m1 - n1) * LOG2E);
        const float ml0 = n0 * LOG2E, ml1 = n1 * LOG2E;
        m0 = n0;
        m1 = n1;
        // p, packed as bf16 straight into the A layout of k-step j / 2
        // (registers 0, 1 for even j, 2, 3 for odd)
        uint32_t pa[4][4];
        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float pv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            pv[e] = ex2(fmaf(sc[4 * j + e], LOG2E, -(e < 2 ? ml0 : ml1)));
          ps0 += pv[0] + pv[1];
          ps1 += pv[2] + pv[3];
          const int kk = j >> 1, hi = (j & 1) * 2;
          pa[kk][hi] = pack2(pv[0], pv[1]);
          pa[kk][hi + 1] = pack2(pv[2], pv[3]);
        }
        l0 = l0 * al0 + ps0;
        l1 = l1 * al1 + ps1;
        // O is stable here (the last product was waited for)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[4 * j] *= al0;
          acc[4 * j + 1] *= al0;
          acc[4 * j + 2] *= al1;
          acc[4 * j + 3] *= al1;
        }
        // O stays in its registers from before the products to after the
        // wait: a copy the compiler made in between would read it before
        // the products land
        pin_all(acc);
        pin_all(pa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // O += bf16(p) v
          wgmma64<1>(acc, pa[kk], desc_mn(sb + BOX) + 128 * kk, 1);
        wgmma_commit();
        wgmma_wait<0>();
        pin_all(acc);
        pin_all(pa);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(ring_empty(stage));
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    // epilogue: the row sums over the quad; out = O (1 / l) (0 on a padded
    // row or one that saw no key), rounded once into this warpgroup's staging
    // box, then one TMA store; the box is written again only once the last
    // item's store has read it
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o);
    }
    const bool ok0 = k0 > 0 && m0 > NEG, ok1 = k1 > 0 && m1 > NEG;
    const float inv0 = ok0 ? 1.f / l0 : 0.f, inv1 = ok1 ? 1.f / l1 : 0.f;
    const uint32_t box0 = sbase + L::OUT + wg * BOX;
    if ((tid & 127) == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    bar_sync(2 + wg, 128);
    // row g's staging address with its chunk bits holding g; row g + 8 is
    // 1024 on (the same swizzle); fragment j's chunk is j ^ g
    const uint32_t rowg = (box0 + (w4 * 16 + g) * 128 + t * 4) ^ (g << 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t at = rowg ^ (j << 4);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at),
                   "r"(pack2(acc[4 * j] * inv0, acc[4 * j + 1] * inv0)));
      asm volatile("st.shared.b32 [%0+1024], %1;\n" ::"r"(at),
                   "r"(pack2(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1)));
    }
    fence_proxy_async();
    bar_sync(2 + wg, 128);
    if ((tid & 127) == 0 && wrow0 < P) {
      tma_store_3d(&tout, box0, it.h * DH, wrow0, it.b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
    if (t == 0) {
      if (r0 < P) args.lse[rowbase + r0] = ok0 ? m0 + logf(l0) : NEG;
      if (r1 < P) args.lse[rowbase + r1] = ok1 ? m1 + logf(l1) : NEG;
    }
    if (args.rope && block_ends(i, last, H)) {
      __syncwarp();
      if (lane == 0) mbar_arrive(rope_empty);
    }
  }
  if ((tid & 127) == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The launch of form FORM: one CTA an SM, at most one an item. cos and sin
// may be null (no RoPE).
template <int FORM>
int launch(const void* q, const void* k, const void* v, const void* cos, const void* sin,
           void* out, const Args& args, cudaStream_t stream) {
  static bool configured[MAX_DEVICES] = {};
  static int sms[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return ERR_DEVICE;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(fwd_kernel<FORM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Layout::BYTES);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  const EncodeTiled fn = encode_fn();
  if (!fn) return ERR_NO_ENCODE;
  const int B = args.B, P = args.P, W = args.H * DH;
  CUtensorMap m[6];
  if (!encode3(fn, &m[0], q, B, P, W) || !encode3(fn, &m[1], k, B, P, W) ||
      !encode3(fn, &m[2], v, B, P, W) || !encode3(fn, &m[5], out, B, P, W))
    return ERR_ENCODE;
  // without RoPE the cos/sin maps are never read: any valid map will do
  if (!encode3(fn, &m[3], cos ? cos : q, B, P, cos ? DH : W) ||
      !encode3(fn, &m[4], sin ? sin : q, B, P, sin ? DH : W))
    return ERR_ENCODE;
  const int items = B * ((P + ROWS - 1) / ROWS) * args.H;
  const int grid = items < sms[dev] ? items : sms[dev];
  fwd_kernel<FORM><<<grid, NTHREADS, Layout::BYTES, stream>>>(m[0], m[1], m[2], m[3], m[4], m[5],
                                                                args);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fwd_sm90

// C entries for ctypes, on `stream`: each returns the first CUDA error (0
// when its launches were accepted), or one of flash_sm90.cuh's codes above
// 999. cos and sin may be null (no RoPE).

// #1: one id array.
extern "C" int ggt_flash_fwd(const void* q, const void* k, const void* v,
                             const void* seg, const void* cos, const void* sin,
                             void* out, void* lse, int B, int P, int H, int causal,
                             int bi_split, void* stream) {
  using namespace fwd_sm90;
  if (B == 0 || P == 0 || H == 0) return 0;
  const Args args{(const int*)seg, (float*)lse, B, P, H, causal, bi_split, cos != nullptr};
  return launch<SINGLE>(q, k, v, cos, sin, out, args, (cudaStream_t)stream);
}

// #6: query ids seg_q and key ids seg_k; `tab` is int32 scratch of
// 4 x B x ceil(P/64) from the caller, into which the tile tables of seg_q
// and seg_k (one when they are one array) are written first. Any P.
extern "C" int ggt_flash_fwd_stream(const void* q, const void* k, const void* v,
                                    const void* segq, const void* segk, const void* cos,
                                    const void* sin, void* out, void* lse, void* tab, int B,
                                    int P, int H, int causal, int bi_split, void* stream) {
  using namespace fwd_sm90;
  if (B == 0 || P == 0 || H == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const int2 *tq, *tk;
  const cudaError_t err = launch_tables(segq, segk, tab, B, P, st, &tq, &tk);
  if (err != cudaSuccess) return (int)err;
  const Args args{(const int*)segq, (float*)lse, B, P, H, causal, bi_split, cos != nullptr,
                  (const int*)segk, tq, tk};
  return launch<STREAM>(q, k, v, cos, sin, out, args, st);
}

// #9: query ids seg_q and key ids seg_k, q and k already rotated; `tab` as
// #6's, into whose first B x ceil(P/64) int2 the query tiles' band table is
// written first.
extern "C" int ggt_flash_fwd_band(const void* q, const void* k, const void* v, const void* segq,
                                  const void* segk, void* out, void* lse, void* tab, int B,
                                  int P, int H, int causal, int bi_split, void* stream) {
  using namespace fwd_sm90;
  if (B == 0 || P == 0 || H == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  int2* tq = (int2*)tab;
  const cudaError_t err = launch_band_table(segq, segk, tq, B, P, st);
  if (err != cudaSuccess) return (int)err;
  const Args args{(const int*)segq, (float*)lse, B, P, H, causal, bi_split, 0,
                  (const int*)segk, tq, nullptr};
  return launch<BAND>(q, k, v, nullptr, nullptr, out, args, st);
}
