// The streamed flash attention forward with in-kernel RoPE: kernel #6
// flash_fwd_stream, behind its C entry. (The streamed backward pair, #7 and
// #8, runs on the Hopper body of flash_bwd_split.cu.)
//
// Replaces graphgpt_tpu/ops/flash_attention.py:177 _fwd_kernel_stream, which
// _flash_fwd (:409) launches above P = 2048 (kv blocks of 1024, so more than
// one) and which ring attention's chunks take. Same contract: q (pre-scaled,
// not rotated), k, v token-major bf16 [B, P, H*64]; seg_q and seg_k int32
// [B, P], two arrays (a ring chunk's keys carry another chunk's ids; the
// model passes one array twice); optional cos/sin bf16 [B, P, 64]. With
// S = rot(q) rot(k)^T + mask (seg_q[row] == seg_k[col] > 0, causal or
// bi-causal): out = softmax(S) v with p rounded to bf16 for the product, and
// lse fp32 [B, H, P]; a row whose seg_q is 0, or which sees no key, gives
// out = 0 and lse = -1e30.
//
// What bounds it on the H100: bytes. At B 16, P 4096, H 12 (65,536 tokens)
// q, k, v, out are 100.7 MB each: ~423 MB with cos, sin and lse, ~0.126 ms
// at 3.35 TB/s. On ~32-token packed segments its products are a few GFLOP,
// ~10 us at 989 TFLOP/s.
//
// Design. First a pre-pass writes each 64-row tile's segment-id range into
// the tile tables (tile_table.cuh; one table when seg_q and seg_k are one
// array), so that each CTA reads one int2 a key tile to decide whether to
// skip it. Then the WMMA body of flash_fwd_common.cuh with STREAM: one CTA
// of 4 warps per (64-row q tile, head, batch row), looping over the key
// tiles with an online softmax; each CTA writes only its own tile, so no
// atomics, and the result is the same from run to run. Loads are 16 bytes a
// thread, single-buffered: TMA, wgmma and pipelining are later work.

#include "flash_fwd_common.cuh"
#include "tile_table.cuh"

// The C entry for ctypes, on `stream`; it returns the first CUDA error (0
// when its launches were accepted). `tab` is int32 scratch of 4 x B x
// ceil(P/64) from the caller.
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
