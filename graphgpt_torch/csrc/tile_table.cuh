// The tile tables of the streamed kernels, #6 (flash_stream.cu) and #7, #8
// (flash_bwd_split.cu): tab[b, t] = (min positive id, max id) of the 64
// segment ids seg[b, 64t : 64t + 64), written once a call by a pre-pass, so
// that a kernel that walks the tiles of a long row reads one int2 a tile
// instead of the tile's 64 ids. Without it every walker re-reads the ids of
// every tile it tests: at P 4096 that is 64 tiles x 256 bytes a walker and
// an item, and it grows with P^2.
#pragma once

#include "flash_common.cuh"  // tile_range

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

}  // namespace
