// Segment-masked flash attention backward (dq, dk, dv), for Hopper: one
// kernel body in two forms, each behind its own C entry.
//
// SINGLE, #3 flash_bwd, replaces graphgpt_tpu/ops/flash_attention.py:706
// _bwd_kernel_fused (the TPU's single-block fused backward, reached from
// _flash_bwd :902 when P <= 2048 without a bi-causal split). q (pre-scaled,
// not rotated), k, v, do, out are token-major bf16 [B, P, H*64]; lse and the
// optional dlse are fp32 [B, H, P]; seg int32 [B, P]; optional cos/sin bf16
// [B, P, 64]; P <= 2048. With S = rot(q) rot(k)^T + mask (the segment rule,
// causal or bidirectional), p = exp(S - lse) and
// delta = rowsum(do * out) - dlse:
//   dv = bf16(p)^T do,  ds = bf16(p * (do v^T - delta)),
//   dq = ds rot(k),  dk = ds^T rot(q)
// in fp32 sums; dq and dk come back through the inverse rotation, applied
// to the fp32 sums and rounded to bf16 once. A row of segment 0 takes no
// part: its dq, and dk, dv of such a key, are exactly 0, and its do is
// taken as zero before delta and before any product, so that a non-finite
// value there reaches no output bit.
//
// BAND, #10 flash_bwd_band, replaces :484 _bwd_kernel_band, which
// _flash_bwd launches under GGT_FLASH_MODE=band for P <= 4096: SINGLE's
// contract with q and k already rotated (no cos, sin: the band path applies
// RoPE outside), query ids seg_q and key ids seg_k (the model passes one
// array twice), the causal, bidirectional or bi-causal rule (bi_split > 0:
// visible_cols and first_row of flash_common.cuh; the split may fall inside
// a 64-row tile) and P <= 4096, one 64-bit visiting mask of 64 tiles. The
// entry first writes the band tables (tile_table.cuh's band_table_kernel,
// the plain `band_limits`): for each 64-row query tile the first and last
// key positions whose id lies in the tile's id range, and for each key tile
// the first and last such query positions (one table when seg_q and seg_k
// are one array). An item's query role walks the key tiles from the first
// of its two q tiles' bands to the last, the top clipped to the columns its
// last row sees; its key role walks the query tiles of its two key tiles'
// bands, the bottom clipped to the first row that sees its first key
// (band_mask); a warpgroup skips a tile outside its own tile's band or its
// rows' causal or bi-causal range. delta comes from the same delta kernel
// (the JAX package sums it outside the kernel, :933-940), so a padded query
// row takes no part even where dlse reaches it (the port's rule; the JAX
// kernel lets exp(S - lse) = 1 spread it), and its do is never read.
//
// What bounds it on the H100: bytes. At B 64, P 1024, H 12 it must read q,
// k, v, do, out and write dq, dk, dv (8 x 100.7 MB, ~0.25 ms of HBM time)
// against ~22 GFLOP of unmasked products on packed ~32-token segments
// (~0.02 ms of tensor-core time); BAND the same bytes without cos, sin.
//
// Design. The TPU kernel walks the q tiles in order and carries dk, dv in
// scratch from one grid step to the next; blocks on this card run in any
// order, so nothing is carried and no sum is split: every output row has
// one owner and the result is the same from run to run (no atomics).
//  - A small first kernel writes delta [B, H, P] (8 threads a (token,
//    head) row, 16 bytes each; 0 - dlse on a padded row, whose do it never
//    reads). The key role needs delta of the query rows that visit its
//    keys, which other CTAs own, so it cannot come from inside the main
//    kernel without a grid-wide barrier; the launches count as one call.
//  - The main kernel is the split backward's machinery (flash_bwd_split.cu,
//    on the pieces of flash_sm90.cuh) with both roles in one CTA.
//    Persistent: one CTA an SM walks a contiguous run of work items (b,
//    128-row block, h), the head fastest. Each item runs the query role
//    (dq: own q and do, visiting k and v tiles) and then the key role (dk,
//    dv: own k and v, visiting q and do tiles, S^T and dP^T computed
//    directly), one after the other, so that the register peak stays one
//    role's. A CTA is three warpgroups:
//  - producer warp 8 finds the visiting 64-row tiles (SINGLE: those that
//    meet the own block's segment-id range and the causal range, in a
//    32-bit mask; BAND: the band's stretch in a 64-bit one), TMA-loads
//    each role's own tiles once and streams the visiting tiles (SINGLE:
//    with their rows' cos and sin where those rows lie outside the own
//    block) through a ring with full and empty mbarriers, 3 stages of four
//    boxes (SINGLE) or 8 of two (BAND, in the shared memory that the cos
//    and sin buffers leave); its lanes copy each visiting tile's ids (and,
//    in the key role, lse and delta) with cp.async into the stage. 3D
//    tensor maps {64 H, P, B}, boxes of [64, 64], 128-byte swizzled: rows
//    past P arrive as zeros. Warp 9 loads the own rows' cos and sin once a
//    row block (its items, the heads, share one phase of the rope
//    barriers); both roles use them. Warps 10 and 11 rotate each landed k
//    (or q) in place, once, with bf16x2 arithmetic, zero do of padded query
//    rows in the key role, and mark the stage ready;
//  - two consumer warpgroups own 64 rows each: the own tiles into registers
//    with ldmatrix (q or k rotated there; do of padded rows zeroed), per
//    ready stage S and dP as wgmma m64n64k16 with A from registers and B
//    K-major from the stage, p = 2^(S log2 e - lse log2 e) and ds
//    branch-free in the accumulator layout, taken as bf16 straight into the
//    A operand of the next products, and dq += ds rot(k) (dk += ds^T rot(q),
//    dv += bf16(p)^T do) with B MN-major through wgmma's transpose bit. A
//    warpgroup whose 64 rows cannot meet the tile skips its products;
//  - each role's epilogue applies the inverse rotation in fp32, rounds once
//    into a swizzled staging box and stores it by TMA (rows past P are not
//    written).
// setmaxnreg gives the consumers 224 registers and the producers 56. Only
// the producers' waits time out (4 s, then trap).

#include <type_traits>

#include "flash_sm90.cuh"  // wgmma64, desc_mn, ex2, bf16x2 RoPE, the visiting mask, encode3
#include "tile_table.cuh"  // BAND's band tables and band_mask

namespace fused_bwd {
namespace {

using namespace sm90;

constexpr int ROWS = ITEM_ROWS;    // own rows of a work item: two consumer warpgroups of 64
constexpr int NTHREADS = 384;      // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int CONSUMERS = 256;
constexpr int BOX = 64 * DH * 2;   // one [64, 64] bf16 box, 8 KB
constexpr int HALF = ROWS * DH * 2;  // a [128, 64] own tile: two boxes

// The forms of the body (the template argument; flash_fwd.cu's numbers).
constexpr int SINGLE = 0, BAND = 2;
constexpr int STAGES_SINGLE = 3;
constexpr int STAGES_BAND = 8;  // stages of two boxes

// What a form fixes: RoPE (the cos/sin buffers and stages of four boxes),
// the ring's depth, the longest row and its visiting mask.
template <int FORM>
struct Form {
  static constexpr bool ROPE = FORM == SINGLE;
  static constexpr int STAGES = FORM == SINGLE ? STAGES_SINGLE : STAGES_BAND;
  static constexpr int MAX_P = FORM == SINGLE ? 2048 : 4096;  // the visiting tiles fit one mask
  using Mask = std::conditional_t<FORM == SINGLE, uint32_t, uint64_t>;
};

__device__ __forceinline__ int popcount(uint32_t m) { return __popc(m); }
__device__ __forceinline__ int popcount(uint64_t m) { return __popcll(m); }
__device__ __forceinline__ int lowest(uint32_t m) { return __ffs(m) - 1; }
__device__ __forceinline__ int lowest(uint64_t m) { return __ffsll((long long)m) - 1; }

// A visiting tile's row data. seg (and in the key role lse, delta) arrive
// by cp.async (zeros past P); v0, lo, hi, rope_own are written by producer
// lane 0.
struct Meta {
  int seg[64];
  float lse[64];
  float delta[64];
  int v0;        // the tile's first row
  int lo, hi;    // its segment-id range (tile_range; BAND: unused)
  int rope_own;  // 1: its rows lie in the own block, whose cos/sin are in the rope buffer
};

// Shared memory from a 1024-aligned base: a role's own tiles (q, do; or
// k, v), the own rows' cos and sin (SINGLE), the ring (per stage the
// visiting B1, B2 and, SINGLE, their rows' cos, sin), the output staging
// (dq; dk and dv), the stage metadata, the role header, the barriers.
template <int FORM>
struct Layout {
  static constexpr int STAGES = Form<FORM>::STAGES;
  static constexpr int ROPE_BYTES = Form<FORM>::ROPE ? HALF : 0;
  static constexpr int OWN = 0;
  static constexpr int COS = OWN + 2 * HALF;
  static constexpr int SIN = COS + ROPE_BYTES;
  static constexpr int RING = SIN + ROPE_BYTES;
  static constexpr int STAGE = (Form<FORM>::ROPE ? 4 : 2) * BOX;  // B1, B2 (, cos, sin)
  static constexpr int OUT = RING + STAGES * STAGE;
  static constexpr int META = OUT + 2 * HALF;
  static constexpr int HDR = META + STAGES * (int)sizeof(Meta);
  static constexpr int BARS = (HDR + 16 + 7) & ~7;
  // own_full, own_empty, rope_full, rope_empty, ring_full[STAGES], ring_empty[STAGES],
  // ring_ready[STAGES]
  static constexpr int END = BARS + (4 + 3 * STAGES) * 8;
  static constexpr size_t BYTES = 1024 + (size_t)END;
};

struct Args {
  const int* seg;       // [B, P]: SINGLE every row's ids; BAND the query rows'
  const float* lse;     // [B, H, P]
  const float* delta;   // [B, H, P], from the delta kernel
  int B, P, H, causal, rope;
  // BAND: the key rows' ids [B, P], the bi-causal split, and the band
  // tables [B, ceil(P/64)] of the query tiles (over the keys) and of the key
  // tiles (over the queries)
  const int* segk;
  int bi_split;
  const int2* tabq;
  const int2* tabk;
};

// The tensor maps: q, k, v, do, cos, sin, dq, dk, dv.
struct Maps {
  CUtensorMap q, k, v, dout, cos, sin, dq, dk, dv;
};

// The barriers of the CTA, at the Layout's offsets.
template <int FORM>
struct Bars {
  static constexpr int STAGES = Form<FORM>::STAGES;
  uint32_t own_full, own_empty, rope_full, rope_empty, ring0;
  __device__ uint32_t full(int s) const { return ring0 + 8 * s; }
  __device__ uint32_t empty(int s) const { return ring0 + 8 * (STAGES + s); }
  __device__ uint32_t ready(int s) const { return ring0 + 8 * (2 * STAGES + s); }
};

// Where a ring walker stands: the stage and its parity.
template <int FORM>
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ void advance() {
    if (++stage == Form<FORM>::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// The visiting tiles of one role of an item (the key role: DKV); every
// lane of the calling warp takes part.
template <int FORM, bool DKV>
__device__ __forceinline__ typename Form<FORM>::Mask visits(const Args& args, const Item& it,
                                                            bool tri, int lane) {
  if constexpr (FORM == SINGLE) {
    return visiting_mask<uint32_t, true>(args.seg + (long long)it.b * args.P, it.own0, args.P,
                                         tri, DKV, lane);
  } else {
    const int nt = (args.P + 63) / 64;
    return band_mask((DKV ? args.tabk : args.tabq) + (long long)it.b * nt, it.own0, nt, args.P,
                     args.causal, args.bi_split, DKV, 0);
  }
}

// The visiting rows' ids of one role in batch row b: the key ids in the
// query role, the query ids in the key role (SINGLE: one array).
template <int FORM, bool DKV>
__device__ __forceinline__ const int* visiting_ids(const Args& args, int b) {
  return (FORM == BAND && !DKV ? args.segk : args.seg) + (long long)b * args.P;
}

// Producer warp 8, one role of one item: the own tiles, then the visiting
// tiles through the ring.
template <int FORM, bool DKV>
__device__ __forceinline__ void produce(const Maps& mp, const Args& args, const Item& it,
                                        uint32_t sbase, const Bars<FORM>& bars, Meta* meta,
                                        volatile int* hdr, bool tri, int lane, Ring<FORM>& ring,
                                        uint32_t& ophase) {
  using L = Layout<FORM>;
  const int P = args.P;
  const int* segb = visiting_ids<FORM, DKV>(args, it.b);
  const long long rowbase = ((long long)it.b * args.H + it.h) * P;
  auto mask = visits<FORM, DKV>(args, it, tri, lane);
  const bool two = it.own0 + 64 < P;  // the own block's second box holds rows
  mbar_wait_or_trap(bars.own_empty, ophase ^ 1);
  if (lane == 0) {
    hdr[0] = popcount(mask);
    mbar_expect_tx(bars.own_full, 2 * (two ? 2 : 1) * BOX);
    const CUtensorMap* own1 = DKV ? &mp.k : &mp.q;
    const CUtensorMap* own2 = DKV ? &mp.v : &mp.dout;
    tma_load_3d(sbase + L::OWN, own1, bars.own_full, it.h * DH, it.own0, it.b);
    tma_load_3d(sbase + L::OWN + HALF, own2, bars.own_full, it.h * DH, it.own0, it.b);
    if (two) {
      tma_load_3d(sbase + L::OWN + BOX, own1, bars.own_full, it.h * DH, it.own0 + 64, it.b);
      tma_load_3d(sbase + L::OWN + HALF + BOX, own2, bars.own_full, it.h * DH, it.own0 + 64,
                  it.b);
    }
  }
  ophase ^= 1;
  while (mask) {
    const int vt = lowest(mask);
    mask &= mask - 1;
    const int v0 = vt * 64;
    const int s = ring.stage;
    mbar_wait_or_trap(bars.empty(s), ring.phase ^ 1);
    Meta& m = meta[s];
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
    cp_async_arrive(bars.full(s));
    int lo = 0, hi = 0;
    if constexpr (FORM == SINGLE) tile_range_redux(segb, v0, P, lane, &lo, &hi);
    const bool in_own = v0 >= it.own0 && v0 < it.own0 + ROWS;
    if (lane == 0) {
      m.v0 = v0;
      m.lo = lo;
      m.hi = hi;
      m.rope_own = in_own;
      const bool rope = Form<FORM>::ROPE && args.rope && !in_own;
      const uint32_t bar = bars.full(s);
      const uint32_t dst = sbase + L::RING + s * L::STAGE;
      mbar_expect_tx(bar, (rope ? 4 : 2) * BOX);
      tma_load_3d(dst, DKV ? &mp.q : &mp.k, bar, it.h * DH, v0, it.b);
      tma_load_3d(dst + BOX, DKV ? &mp.dout : &mp.v, bar, it.h * DH, v0, it.b);
      if (rope) {
        tma_load_3d(dst + 2 * BOX, &mp.cos, bar, 0, v0, it.b);
        tma_load_3d(dst + 3 * BOX, &mp.sin, bar, 0, v0, it.b);
      }
    }
    __syncwarp();
    ring.advance();
  }
}

// Pass warps 10 and 11, one role of one item: each landed stage made ready
// in place, off the consumers' path: RoPE on k (or q), and zeros for do of
// padded query rows in the key role. 64 threads, each the 16-byte chunks c
// and c + 4 (columns d and d + 32) of four rows, at their swizzled places.
// They mark every stage ready, also one with nothing to do (the query role
// without RoPE): a walker that skipped stages could run a lap ahead of the
// ring and take an old phase for the one it waits for.
template <int FORM, bool DKV>
__device__ __forceinline__ void pass_role(const Args& args, const Item& it, uint32_t sbase,
                                          const Bars<FORM>& bars, const Meta* meta, bool tri,
                                          int u, int lane, Ring<FORM>& ring) {
  using L = Layout<FORM>;
  auto mask = visits<FORM, DKV>(args, it, tri, lane);
  for (; mask; mask &= mask - 1) {
    const int s = ring.stage;
    mbar_wait(bars.full(s), ring.phase);
    const Meta& m = meta[s];
    const uint32_t b1 = sbase + L::RING + s * L::STAGE;
    const uint32_t cs = m.rope_own ? sbase + L::COS + (m.v0 - it.own0) * 128 : b1 + 2 * BOX;
    const uint32_t sn = cs + (m.rope_own ? L::SIN - L::COS : BOX);
    // one row at a time: the producer warpgroup has 56 registers
#pragma unroll 1
    for (int q = 0; q < 4; ++q) {
      const int pr = (u >> 2) + 16 * q, pc = u & 3;
      const uint32_t plo = pr * 128 + ((pc ^ (pr & 7)) << 4);
      const uint32_t phi = pr * 128 + (((pc + 4) ^ (pr & 7)) << 4);
      if (Form<FORM>::ROPE && args.rope) {
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
    if (lane == 0) mbar_arrive(bars.ready(s));
    ring.advance();
  }
}

// The ids of a consumer thread's own rows and of its warp's 64-row tile
// (two a lane), and the rows' lse and delta: loaded an item ahead, so that
// their latency hides under the item before. BAND: s0, s1 are the own
// rows' query ids, u0, u1 their key ids; (t0, t1) the warpgroup's query
// tile's band of key positions, (t2, t3) its key tile's band of query
// positions.
struct Rows {
  int s0, s1, t0, t1;
  float lse0, lse1, dl0, dl1;
  int u0, u1, t2, t3;
};

// What a consumer thread knows of its place in the CTA.
struct Lane {
  int tid, wg, w4, g, t, lane;
  uint32_t aoff;  // its ldmatrix offset in a [128, 64] swizzled own tile
};

// A consumer warpgroup, one role of one item: the own tiles into
// registers, the products over every ready stage, then the epilogue.
template <int FORM, bool DKV>
__device__ __forceinline__ void consume(const Maps& mp, const Args& args, const Item& it,
                                        const Rows& rows, uint8_t* base, uint32_t sbase,
                                        const Bars<FORM>& bars, const Meta* meta,
                                        volatile int* hdr, bool tri, const Lane& ln,
                                        Ring<FORM>& ring, uint32_t& ophase) {
  using L = Layout<FORM>;
  constexpr bool ROPE = Form<FORM>::ROPE;
  const int P = args.P;
  const int wg = ln.wg, w4 = ln.w4, g = ln.g, t = ln.t, lane = ln.lane;
  const int bsplit = FORM == BAND ? args.bi_split : 0;
  const uint32_t aoff = ln.aoff;
  const int wrow0 = it.own0 + wg * 64;
  const int r0 = wrow0 + w4 * 16 + g, r1 = r0 + 8;  // this thread's own rows
  // the own rows' ids (BAND: the key ids in the key role)
  const int s0 = FORM == BAND && DKV ? rows.u0 : rows.s0;
  const int s1 = FORM == BAND && DKV ? rows.u1 : rows.s1;
  // own queries see the visiting columns [0, lim); own keys are seen by
  // the visiting rows [lim, P)
  const int lim0 =
      DKV ? first_row(r0, args.causal, bsplit, P) : visible_cols(r0, args.causal, bsplit, P);
  const int lim1 =
      DKV ? first_row(r1, args.causal, bsplit, P) : visible_cols(r1, args.causal, bsplit, P);
  // the segment-id range of this warpgroup's 64 rows (tile_range's; BAND:
  // the first and last visiting position of their tile's band)
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
    omin = DKV ? rows.t2 : rows.t0;
    omax = DKV ? rows.t3 : rows.t1;
  }
  // BAND: the warpgroup's rows see no column from wlim on (query role); no
  // row before wlim sees its keys (key role)
  const int wlim = FORM != BAND ? 0
                   : DKV       ? first_row(wrow0, args.causal, bsplit, P)
                               : visible_cols(min(wrow0 + 63, P - 1), args.causal, bsplit, P);
  // a row's segment id, the key a visiting column must match; -1 (no
  // match) for a padded row
  const int k0 = s0 > 0 ? s0 : -1, k1 = s1 > 0 ? s1 : -1;
  // the query role: lse log2(e) and delta of the own rows
  const float l2e0 = rows.lse0 * LOG2E, l2e1 = rows.lse1 * LOG2E;
  const float dl0 = rows.dl0, dl1 = rows.dl1;

  mbar_wait(bars.own_full, ophase);
  ophase ^= 1;
  const int nv = hdr[0];
  uint32_t a1[4][4], a2[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    ldmatrix_x4(a1[kk], sbase + L::OWN + (aoff ^ (32 * kk)));
    ldmatrix_x4(a2[kk], sbase + L::OWN + HALF + (aoff ^ (32 * kk)));
  }
  if (!DKV) {
    // do of a padded row takes part in no product
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (s0 == 0) a2[kk][0] = a2[kk][2] = 0u;
      if (s1 == 0) a2[kk][1] = a2[kk][3] = 0u;
    }
  }
  __syncwarp();
  if (lane == 0) mbar_arrive(bars.own_empty);

  if (ROPE && args.rope) {
    rope_a(a1, sbase + L::COS, sbase + L::SIN, aoff);  // q (or k)
  }

  float acc1[32], acc2[32];  // query role: dq; key role: dk, dv
#pragma unroll
  for (int j = 0; j < 32; ++j) acc1[j] = acc2[j] = 0.f;

  for (int s = 0; s < nv; ++s) {
    const int st = ring.stage;
    mbar_wait(bars.full(st), ring.phase);
    mbar_wait(bars.ready(st), ring.phase);
    const Meta& m = meta[st];
    const int v0 = m.v0;
    const uint32_t sb = sbase + L::RING + st * L::STAGE;
    bool skip;
    if constexpr (FORM == BAND)
      skip = v0 > omax || v0 + 63 < omin || (DKV ? v0 + 63 < wlim : v0 >= wlim);
    else
      skip = ranges_miss(omin, omax, m.lo, m.hi) ||
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
      for (int kk = 0; kk < 4; ++kk) wgmma64<0>(dp, a2[kk], desc_sw128(sb + BOX) + 2 * kk, kk > 0);
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
          // branch-free: a masked logit goes to -inf, whose 2^ is 0 (expf's
          // branches let ptxas give a live wgmma A operand's registers to
          // temporaries: flash_bwd_split.cu)
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
    if (lane == 0) mbar_arrive(bars.empty(st));
    ring.advance();
  }
  // epilogue: the inverse rotation in fp32 (x c - rotate_half(x) s), each
  // value rounded to bf16 once into this warpgroup's staging box, then one
  // TMA store a box; the boxes are written again only once the last role's
  // stores have read them
  const uint32_t box0 = sbase + L::OUT + wg * BOX;
  if ((ln.tid & 127) == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  bar_sync(2 + wg, 128);
  // row g's staging address with its chunk bits holding g; row g + 8 is
  // 1024 on (the same swizzle); fragment j's chunk is j ^ g
  const uint32_t rowg = (box0 + (w4 * 16 + g) * 128 + t * 4) ^ (g << 4);
  if (ROPE && args.rope) {
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
  if ((ln.tid & 127) == 0 && wrow0 < P) {
    tma_store_3d(DKV ? &mp.dk : &mp.dq, box0, it.h * DH, wrow0, it.b);
    if (DKV) tma_store_3d(&mp.dv, box0 + HALF, it.h * DH, wrow0, it.b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
}

template <int FORM>
__global__ void __launch_bounds__(NTHREADS, 1)
fused_kernel(const __grid_constant__ Maps mp, const Args args) {
  using L = Layout<FORM>;
  constexpr int STAGES = Form<FORM>::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  Meta* meta = reinterpret_cast<Meta*>(base + L::META);
  volatile int* hdr = reinterpret_cast<volatile int*>(base + L::HDR);
  const uint32_t sbase = saddr(base), sbars = sbase + L::BARS;
  const Bars<FORM> bars{sbars, sbars + 8, sbars + 16, sbars + 24, sbars + 32};

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int P = args.P, H = args.H;
  const int nblk = (P + ROWS - 1) / ROWS;
  const int items = args.B * nblk * H;
  const int first = (int)((long long)blockIdx.x * items / gridDim.x);
  const int last = (int)((long long)(blockIdx.x + 1) * items / gridDim.x);
  const bool tri = args.causal != 0;

  if (tid == 0) {
    mbar_init(bars.own_full, 1);
    mbar_init(bars.own_empty, 8);
    mbar_init(bars.rope_full, 1);
    mbar_init(bars.rope_empty, 10);  // every consumer warp and both pass warps
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars.full(s), 33);  // 32 lanes' cp.async and lane 0's expect_tx
      mbar_init(bars.empty(s), 8);  // every consumer warp
      mbar_init(bars.ready(s), 2);  // both pass warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    if (warp == 8) {
      Ring<FORM> ring;
      uint32_t ophase = 0;
      for (int i = first; i < last; ++i) {
        const Item it = decode(i, H, nblk);
        produce<FORM, false>(mp, args, it, sbase, bars, meta, hdr, tri, lane, ring, ophase);
        produce<FORM, true>(mp, args, it, sbase, bars, meta, hdr, tri, lane, ring, ophase);
      }
      // every stage and the own buffer handed back: the consumers are past
      // their last product
      for (int s = 0; s < STAGES; ++s) {
        mbar_wait_or_trap(bars.empty(ring.stage), ring.phase ^ 1);
        ring.advance();
      }
      mbar_wait_or_trap(bars.own_empty, ophase ^ 1);
    } else if (warp == 9 && lane == 0 && Form<FORM>::ROPE && args.rope) {
      // both roles of an item use them
      load_own_rope(&mp.cos, &mp.sin, sbase + L::COS, sbase + L::SIN, bars.rope_full,
                    bars.rope_empty, first, last, H, nblk, P);
    } else if (warp >= 10) {
      const int u = tid - 320;
      const bool rope = Form<FORM>::ROPE && args.rope;
      Ring<FORM> ring;
      uint32_t rphase = 0;
      for (int i = first; i < last; ++i) {
        const Item it = decode(i, H, nblk);
        if (rope && block_starts(i, first, H)) {  // the own rows' cos and sin
          mbar_wait(bars.rope_full, rphase);
          rphase ^= 1;
        }
        pass_role<FORM, false>(args, it, sbase, bars, meta, tri, u, lane, ring);
        pass_role<FORM, true>(args, it, sbase, bars, meta, tri, u, lane, ring);
        if (rope && block_ends(i, last, H)) {
          __syncwarp();
          if (lane == 0) mbar_arrive(bars.rope_empty);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: rows [64 wg, 64 wg + 64) of each item
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
  const bool rope = Form<FORM>::ROPE && args.rope;
  Lane ln;
  ln.tid = tid, ln.wg = warp >> 2, ln.w4 = warp & 3, ln.g = lane >> 2, ln.t = lane & 3;
  ln.lane = lane;
  // ldmatrix: lane l gives row (l & 7) + 8 ((l >> 3) & 1) of the warp's 16
  // and 16-byte half l >> 4 of a k-step, the swizzle's XOR (row & 7 = l & 7)
  // in the chunk bits; k-step kk is aoff ^ 32 kk (norm_qkv.cu's load_x)
  ln.aoff = (ln.wg * 64 + ln.w4 * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * 128 +
            (((lane >> 4) ^ (lane & 7)) << 4);
  Ring<FORM> ring;
  uint32_t ophase = 0, rphase = 0;

  auto load_rows = [&](int i) {
    Rows r{};
    const Item it = decode(i, H, nblk);
    const int* segb = args.seg + (long long)it.b * P;
    const long long rowbase = ((long long)it.b * H + it.h) * P;
    const int wrow0 = it.own0 + ln.wg * 64, r0 = wrow0 + ln.w4 * 16 + ln.g, r1 = r0 + 8;
    r.s0 = r0 < P ? segb[r0] : 0;
    r.s1 = r1 < P ? segb[r1] : 0;
    if constexpr (FORM == SINGLE) {
      r.t0 = wrow0 + lane < P ? segb[wrow0 + lane] : 0;
      r.t1 = wrow0 + lane + 32 < P ? segb[wrow0 + lane + 32] : 0;
    } else {
      const int* segkb = args.segk + (long long)it.b * P;
      r.u0 = r0 < P ? segkb[r0] : 0;
      r.u1 = r1 < P ? segkb[r1] : 0;
      const long long tb = (long long)it.b * ((P + 63) / 64) + wrow0 / 64;
      const int2 none = make_int2(P, -1);  // no band: every tile is skipped
      const int2 bq = wrow0 < P ? args.tabq[tb] : none;
      const int2 bk = wrow0 < P ? args.tabk[tb] : none;
      r.t0 = bq.x;
      r.t1 = bq.y;
      r.t2 = bk.x;
      r.t3 = bk.y;
    }
    r.lse0 = r0 < P ? args.lse[rowbase + r0] : 0.f;
    r.lse1 = r1 < P ? args.lse[rowbase + r1] : 0.f;
    r.dl0 = r0 < P ? args.delta[rowbase + r0] : 0.f;
    r.dl1 = r1 < P ? args.delta[rowbase + r1] : 0.f;
    return r;
  };
  Rows next = first < last ? load_rows(first) : Rows{};

  for (int i = first; i < last; ++i) {
    const Rows rows = next;
    if (i + 1 < last) next = load_rows(i + 1);
    const Item it = decode(i, H, nblk);
    if (rope && block_starts(i, first, H)) {
      mbar_wait(bars.rope_full, rphase);
      rphase ^= 1;
    }
    consume<FORM, false>(mp, args, it, rows, base, sbase, bars, meta, hdr, tri, ln, ring, ophase);
    consume<FORM, true>(mp, args, it, rows, base, sbase, bars, meta, hdr, tri, ln, ring, ophase);
    if (rope && block_ends(i, last, H)) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bars.rope_empty);
    }
  }
  if ((tid & 127) == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// delta[b, h, p] = sum_d do * out - dlse, 8 threads a (token, head) row of
// 64, 16 bytes each; a padded row gives -dlse and its do is not read.
__global__ void delta_kernel(const bf16* __restrict__ dout, const bf16* __restrict__ out,
                             const int* __restrict__ seg, const float* __restrict__ dlse,
                             float* __restrict__ delta, int P, int H, long long rows) {
  const long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 3;
  const int part = threadIdx.x & 7;
  const bool in = row < rows;
  const long long tok = row / H;
  float acc = 0.f;
  if (in && seg[tok] > 0) {
    const uint4 d = *reinterpret_cast<const uint4*>(dout + row * DH + part * 8);
    const uint4 o = *reinterpret_cast<const uint4*>(out + row * DH + part * 8);
    const uint32_t dw[4] = {d.x, d.y, d.z, d.w}, ow[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) acc += lo_f(dw[w]) * lo_f(ow[w]) + hi_f(dw[w]) * hi_f(ow[w]);
  }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (in && part == 0) {
    const long long b = tok / P;
    const int p = (int)(tok % P), h = (int)(row % H);
    const long long idx = (b * H + h) * P + p;
    delta[idx] = acc - (dlse != nullptr ? dlse[idx] : 0.f);
  }
}

// The delta kernel, then the main kernel of form FORM, on `stream`: one CTA
// an SM, at most one an item. cos and sin may be null (no RoPE).
template <int FORM>
int launch(const void* q, const void* k, const void* v, const void* cos, const void* sin,
           const void* out, const void* dout, const void* dlse, void* dq, void* dk, void* dv,
           const Args& args, cudaStream_t st) {
  static bool configured[MAX_DEVICES] = {};
  static int sms[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return ERR_DEVICE;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(fused_kernel<FORM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Layout<FORM>::BYTES);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  const EncodeTiled fn = encode_fn();
  if (!fn) return ERR_NO_ENCODE;
  const int B = args.B, P = args.P, H = args.H, W = H * DH;
  Maps mp;
  if (!encode3(fn, &mp.q, q, B, P, W) || !encode3(fn, &mp.k, k, B, P, W) ||
      !encode3(fn, &mp.v, v, B, P, W) || !encode3(fn, &mp.dout, dout, B, P, W) ||
      !encode3(fn, &mp.dq, dq, B, P, W) || !encode3(fn, &mp.dk, dk, B, P, W) ||
      !encode3(fn, &mp.dv, dv, B, P, W))
    return ERR_ENCODE;
  // without RoPE the cos/sin maps are never read: any valid map will do
  if (!encode3(fn, &mp.cos, cos ? cos : q, B, P, cos ? DH : W) ||
      !encode3(fn, &mp.sin, sin ? sin : q, B, P, sin ? DH : W))
    return ERR_ENCODE;
  const long long rows = (long long)B * P * H;
  delta_kernel<<<(unsigned)((rows * 8 + 255) / 256), 256, 0, st>>>(
      (const bf16*)dout, (const bf16*)out, args.seg, (const float*)dlse, (float*)args.delta, P,
      H, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int items = B * ((P + ROWS - 1) / ROWS) * H;
  const int grid = items < sms[dev] ? items : sms[dev];
  fused_kernel<FORM><<<grid, NTHREADS, Layout<FORM>::BYTES, st>>>(mp, args);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fused_bwd

// C entries for ctypes, on `stream`: each returns the first CUDA error (0
// when its launches were accepted), or one of flash_sm90.cuh's codes above
// 999. dlse may be null (zeros). delta is fp32 scratch [B, H, P] from the
// caller, into which the delta kernel writes first.

// #3: one id array; cos and sin may be null (no RoPE).
extern "C" int ggt_flash_bwd(const void* q, const void* k, const void* v,
                             const void* seg, const void* cos, const void* sin,
                             const void* out, const void* lse, const void* dout,
                             const void* dlse, void* delta, void* dq, void* dk,
                             void* dv, int B, int P, int H, int causal, void* stream) {
  using namespace fused_bwd;
  if (P > Form<SINGLE>::MAX_P) return ERR_P;
  if (B == 0 || P == 0 || H == 0) return 0;
  const Args args{(const int*)seg, (const float*)lse, (const float*)delta, B, P, H, causal,
                  cos != nullptr};
  return launch<SINGLE>(q, k, v, cos, sin, out, dout, dlse, dq, dk, dv, args,
                        (cudaStream_t)stream);
}

// #10: query ids seg_q and key ids seg_k, q and k already rotated; `tab` is
// int32 scratch of 4 x B x ceil(P/64) from the caller: the query tiles'
// band table first, then the key tiles' (the same table when seg_q and
// seg_k are one array), both written first. P <= 4096.
extern "C" int ggt_flash_bwd_band(const void* q, const void* k, const void* v, const void* segq,
                                  const void* segk, const void* out, const void* lse,
                                  const void* dout, const void* dlse, void* delta, void* dq,
                                  void* dk, void* dv, void* tab, int B, int P, int H, int causal,
                                  int bi_split, void* stream) {
  using namespace fused_bwd;
  if (P > Form<BAND>::MAX_P) return ERR_P;
  if (B == 0 || P == 0 || H == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  int2* tq = (int2*)tab;
  int2* tk = segk == segq ? tq : tq + (long long)B * ((P + 63) / 64);
  cudaError_t err = launch_band_table(segq, segk, tq, B, P, st);
  if (err != cudaSuccess) return (int)err;
  if (tk != tq) {
    err = launch_band_table(segk, segq, tk, B, P, st);
    if (err != cudaSuccess) return (int)err;
  }
  const Args args{(const int*)segq, (const float*)lse, (const float*)delta, B, P, H, causal, 0,
                  (const int*)segk, bi_split, tq, tk};
  return launch<BAND>(q, k, v, nullptr, nullptr, out, dout, dlse, dq, dk, dv, args, st);
}
