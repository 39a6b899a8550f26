// The pre-passes of the kernels that walk the 64-row tiles of long rows or
// of other rows' ids, written once a call so that a walker reads one int2 a
// tile instead of the tile's 64 ids (at P 4096 that is 64 tiles x 256
// bytes a walker and an item, growing with P^2):
//  - the tile tables of the streamed kernels, #6 (flash_fwd.cu's stream
//    form) and #7, #8 (flash_bwd_split.cu's): tab[b, t] = (min positive
//    id, max id) of seg[b, 64t : 64t + 64), and table_mask, the visiting
//    tiles of an item read from them;
//  - the band tables of the band kernels, #9 (flash_fwd.cu's band form) and
//    #10 (flash_bwd.cu's): for each query tile the first and last key
//    positions whose id lies in the tile's id range (and for #10 the same
//    of each key tile over the queries), and band_mask, the tiles an item
//    of either walks.
#pragma once

#include "flash_common.cuh"  // tile_range, ranges_miss, visible_cols, first_row

namespace {

// One warp a tile; (0x7fffffff, 0) for a tile of padding.
__global__ void tile_table_kernel(const int* __restrict__ seg, int2* __restrict__ tab,
                                  int P, int nt, long long tiles) {
  const long long w = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (w >= tiles) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  int lo, hi;
  tile_range(seg + (w / nt) * P, (int)(w % nt) * 64, P, lane, &lo, &hi);
  if (lane == 0) tab[w] = make_int2(lo, hi);
}

// The tables of seg_q and seg_k [B, P] into `tab` (the caller's scratch of
// 2 x B x ceil(P/64) int2): tabq first, tabk after it, or tabk = tabq when
// both are one array. B and P must not be 0.
inline cudaError_t launch_tables(const void* segq, const void* segk, void* tab, int B,
                                 int P, cudaStream_t st, const int2** tabq,
                                 const int2** tabk) {
  const int nt = (P + 63) / 64;
  const long long tiles = (long long)B * nt;
  const int wpb = 8;  // warps per block
  const unsigned blocks = (unsigned)((tiles + wpb - 1) / wpb);
  int2* tq = (int2*)tab;
  int2* tk = segk == segq ? tq : tq + tiles;
  tile_table_kernel<<<blocks, wpb * 32, 0, st>>>((const int*)segq, tq, P, nt, tiles);
  if (tk != tq)
    tile_table_kernel<<<blocks, wpb * 32, 0, st>>>((const int*)segk, tk, P, nt, tiles);
  *tabq = tq;
  *tabk = tk;
  return cudaGetLastError();
}

// The visiting mask from the tables: bit vt - vt0 for each visiting tile vt
// in [vt0, vt0 + 64) whose segment-id range meets the own block's [own0,
// own0 + 128) and, causal, lies on its side of the diagonal (an own query
// block meets the key tiles up to its last row, an own key block (dkv) the
// query tiles from its first on), from one batch row's tables: the own
// tiles' ranges in tabo, the visiting tiles' in tabv, each lane testing two
// tiles. The warp's lanes must all call it.
__device__ __forceinline__ uint64_t table_mask(const int2* tabo, const int2* tabv, int own0,
                                               int nt, bool tri, bool dkv, int lane, int vt0) {
  const int ot = own0 / 64;
  const int2 a = tabo[ot];
  const int2 b = ot + 1 < nt ? tabo[ot + 1] : make_int2(0x7fffffff, 0);
  const int olo = min(a.x, b.x), ohi = max(a.y, b.y);
  int vb = 0, ve = nt;
  if (tri) {
    if (dkv) vb = ot;
    else ve = min(nt, ot + 2);
  }
  uint32_t half[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int vt = vt0 + lane + 32 * e;
    bool hit = false;
    if (vt >= vb && vt < ve) {
      const int2 r = tabv[vt];
      hit = !ranges_miss(olo, ohi, r.x, r.y);
    }
    half[e] = __ballot_sync(0xffffffffu, hit);
  }
  return (uint64_t)half[0] | ((uint64_t)half[1] << 32);
}

// The band table (graphgpt_tpu _band_limits :265, the plain `band_limits`):
// tab[b, t] = (lo, hi), the first and last positions of segv[b] whose id
// lies in [min positive id, max id] of sego[b, 64t : 64t + 64); (P, -1)
// when there is none (a tile of padding, or no key of its ids). Packing
// gives increasing ids, so every key a row of the tile can match lies in
// [lo, hi], one contiguous stretch a little wider than the tile. One warp a
// tile.
__global__ void band_table_kernel(const int* __restrict__ sego, const int* __restrict__ segv,
                                  int2* __restrict__ tab, int P, int nt, long long tiles) {
  const long long w = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (w >= tiles) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const long long b = w / nt;
  int idlo, idhi;
  tile_range(sego + b * P, (int)(w % nt) * 64, P, lane, &idlo, &idhi);
  const int* sv = segv + b * P;
  int lo = P, hi = -1;
  if (idhi > 0) {
    for (int p = lane; p < P; p += 32) {
      const int s = sv[p];
      if (s > 0 && s >= idlo && s <= idhi) {
        lo = min(lo, p);
        hi = max(hi, p);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (lane == 0) tab[w] = make_int2(lo, hi);
}

// The band table of sego's tiles over segv's keys [B, P] into tab [B,
// ceil(P/64)] of int2. B and P must not be 0.
inline cudaError_t launch_band_table(const void* sego, const void* segv, int2* tab, int B,
                                     int P, cudaStream_t st) {
  const int nt = (P + 63) / 64;
  const long long tiles = (long long)B * nt;
  const int wpb = 8;  // warps per block
  band_table_kernel<<<(unsigned)((tiles + wpb - 1) / wpb), wpb * 32, 0, st>>>(
      (const int*)sego, (const int*)segv, tab, P, nt, tiles);
  return cudaGetLastError();
}

// The band form's visiting tiles of the item whose own 128 rows (two
// tiles) start at own0, bit vt - vt0 for vt in [vt0, vt0 + 64), from one
// batch row's band table of the own tiles `tab`: from the first tile of
// the two own tiles' bands to the last, clipped to the rows' causal or
// bi-causal range. Own queries (the forward, #10's query role): the top
// clipped to the columns the last row sees. Own keys (dkv, #10's key
// role): the bottom clipped to the first row that sees the first key.
__device__ __forceinline__ uint64_t band_mask(const int2* tab, int own0, int nt, int P,
                                              int causal, int bi_split, bool dkv, int vt0) {
  const int ot = own0 / 64;
  const int2 a = tab[ot];
  const int2 b = ot + 1 < nt ? tab[ot + 1] : make_int2(P, -1);
  int lo = min(a.x, b.x);  // a tile with no band holds (P, -1)
  int hi = max(a.y, b.y);
  if (dkv) lo = max(lo, first_row(own0, causal, bi_split, P));
  else hi = min(hi, visible_cols(min(own0 + 128, P) - 1, causal, bi_split, P) - 1);
  if (hi < lo) return 0;
  const int kb = max(lo / 64, vt0) - vt0, ke = min(hi / 64 + 1, vt0 + 64) - vt0;
  if (ke <= kb) return 0;
  const uint64_t below = ke == 64 ? ~0ull : (1ull << ke) - 1;
  return below & ~((1ull << kb) - 1);
}

}  // namespace
