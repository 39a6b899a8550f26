// The streamed flash attention, forward and split backward, with in-kernel
// RoPE, for Hopper: kernels #6 flash_fwd_stream, #7 flash_dq_stream and
// #8 flash_dkv_stream, each behind its own C entry.
//
// Replaces graphgpt_tpu/ops/flash_attention.py:177 _fwd_kernel_stream, :645
// _dq_kernel_stream and :835 _dkv_kernel_stream, which _flash_fwd (:409)
// and _flash_bwd (:902) launch above P = 2048 (kv blocks of 1024, so more
// than one) and which ring attention's chunks take. Same contract: q
// (pre-scaled, not rotated), k, v, do, out token-major bf16 [B, P, H*64];
// seg_q and seg_k int32 [B, P], two arrays (a ring chunk's keys carry
// another chunk's ids; the model passes one array twice); optional cos/sin
// bf16 [B, P, 64]; lse, delta and the optional dlse fp32 [B, H, P]. With
// S = rot(q) rot(k)^T + mask (seg_q[row] == seg_k[col] > 0, causal or
// bi-causal) and p = exp(S - lse):
//   #6: out = softmax(S) v with p rounded to bf16 for the product, and lse;
//       a row whose seg_q is 0, or which sees no key, gives out = 0 and
//       lse = -1e30.
//   #7: delta = rowsum(do * out) - dlse (the JAX einsum :933-940, here the
//       backward's delta kernel, launched first by this entry and handed
//       back), ds = p * (do v^T - delta) rounded to bf16, dq = ds rot(k).
//   #8: dv = bf16(p)^T do, dk = ds^T rot(q), reading that delta.
// Every sum is fp32; the inverse rotation is applied to the fp32 dq and dk,
// each rounded to bf16 once. A padded row takes no part.
//
// What bounds them on the H100: bytes. At B 16, P 4096, H 12 (65,536
// tokens) q, k, v, out are 100.7 MB each: #6 moves ~423 MB (q, k, v, out,
// cos, sin, lse), ~0.126 ms at 3.35 TB/s; #7 and #8 ~0.63 GB each, ~0.19
// ms. On ~32-token packed segments their products are a few GFLOP, ~10 us
// at 989 TFLOP/s.
//
// Design. The bodies are those of #1 (flash_fwd_common.cuh) and #4/#5
// (flash_bwd_common.cuh) instantiated with STREAM: one CTA of 4 warps per
// (64-row tile, head, batch row), #6 and #7 owning a q tile and looping over
// the key tiles, #8 owning a key tile and looping over the q tiles; each CTA
// writes only its own tile, so no atomics, and the result is the same from
// run to run. What STREAM adds is what long rows and ring chunks need: the
// key ids are read from seg_k, and each tile's (min positive id, max id) is
// read from a table [B, ceil(P/64)] of int2 that a pre-pass writes once
// (tile_table_kernel; once for both when seg_q and seg_k are one array).
// Without the table every CTA re-reads the 64 ids of every visiting tile to
// decide whether to skip it: at P 4096 that is 64 tiles x 256 bytes per CTA,
// ~0.8 GB over the grid of B 16 x 12 heads x 64 tiles, as much as q, k, v
// and out together and growing with P^2. With it, one int2 per tile. Loads
// are 16 bytes a thread, single-buffered, products WMMA bf16 tiles with fp32
// accumulation: TMA, wgmma and pipelining are later work.

#include "flash_fwd_common.cuh"
#include "flash_bwd_common.cuh"

namespace {

// tab[b, t] = (min positive id, max id) of seg[b, 64t : 64t + 64), one warp
// a tile; (0x7fffffff, 0) for a tile of padding.
__global__ void tile_table_kernel(const int* __restrict__ seg, int2* __restrict__ tab,
                                  int P, int nt, long long tiles) {
  const long long w = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (w >= tiles) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  int lo, hi;
  tile_range(seg + (w / nt) * P, (int)(w % nt) * 64, P, lane, &lo, &hi);
  if (lane == 0) tab[w] = make_int2(lo, hi);
}

// The tables of seg_q and seg_k into `tab` (scratch of 2 x B x nt int2):
// tabq first, tabk after it, or tabk = tabq when both are one array.
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

// C entries for ctypes, on `stream`; each returns the first CUDA error (0
// when its launches were accepted). `tab` is int32 scratch of 4 x B x
// ceil(P/64) from the caller; each entry writes the tile tables first.

// #6: out, lse.
extern "C" int ggt_flash_fwd_stream(const void* q, const void* k, const void* v,
                                    const void* segq, const void* segk, const void* cos,
                                    const void* sin, void* out, void* lse, void* tab, int B,
                                    int P, int H, int causal, int bi_split, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int2 *tq, *tk;
  cudaError_t err = launch_tables(segq, segk, tab, B, P, st, &tq, &tk);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((P + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<true><<<grid, THREADS, 0, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)segq, (const int*)segk, tq,
      tk, (const bf16*)cos, (const bf16*)sin, (bf16*)out, (float*)lse, P, H, causal, bi_split);
  return (int)cudaGetLastError();
}

// #7: the delta kernel into the caller's fp32 [B, H, P] `delta` (dlse may
// be null: zeros), then dq.
extern "C" int ggt_flash_dq_stream(const void* q, const void* k, const void* v,
                                   const void* segq, const void* segk, const void* cos,
                                   const void* sin, const void* out, const void* lse,
                                   const void* dout, const void* dlse, void* delta, void* dq,
                                   void* tab, int B, int P, int H, int causal, int bi_split,
                                   void* stream) {
  static bool configured = false;
  cudaError_t err = allow_smem(flash_dq_kernel<true>, &configured);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const int2 *tq, *tk;
  err = launch_tables(segq, segk, tab, B, P, st, &tq, &tk);
  if (err != cudaSuccess) return (int)err;
  err = launch_delta(dout, out, segq, dlse, delta, B, P, H, st);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((P + 63) / 64, H, B);
  flash_dq_kernel<true><<<grid, THREADS, sizeof(Smem), st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)segq, (const int*)segk, tq,
      tk, (const bf16*)cos, (const bf16*)sin, (const float*)lse, (const float*)delta,
      (const bf16*)dout, (bf16*)dq, P, H, causal, bi_split);
  return (int)cudaGetLastError();
}

// #8: dk, dv, reading flash_dq_stream's delta.
extern "C" int ggt_flash_dkv_stream(const void* q, const void* k, const void* v,
                                    const void* segq, const void* segk, const void* cos,
                                    const void* sin, const void* lse, const void* delta,
                                    const void* dout, void* dk, void* dv, void* tab, int B,
                                    int P, int H, int causal, int bi_split, void* stream) {
  static bool configured = false;
  cudaError_t err = allow_smem(flash_dkv_kernel<true>, &configured);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const int2 *tq, *tk;
  err = launch_tables(segq, segk, tab, B, P, st, &tq, &tk);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((P + 63) / 64, H, B);
  flash_dkv_kernel<true><<<grid, THREADS, sizeof(Smem), st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)segq, (const int*)segk, tq,
      tk, (const bf16*)cos, (const bf16*)sin, (const float*)lse, (const float*)delta,
      (const bf16*)dout, (bf16*)dk, (bf16*)dv, P, H, causal, bi_split);
  return (int)cudaGetLastError();
}
