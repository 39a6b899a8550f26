// The split flash attention backward with in-kernel RoPE, for Hopper: two
// kernels, flash_dq and flash_dkv, launched one after the other.
//
// Replaces graphgpt_tpu/ops/flash_attention.py:602 _dq_kernel_single
// (flash_dq) and :789 _dkv_kernel_single (flash_dkv), which _flash_bwd :902
// launches instead of the fused kernel when bi_split > 0 (the denoise
// model's bi-causal energy decoding) and P <= 2048. Same contract as the
// fused kernel (flash_bwd.cu): q (pre-scaled, not rotated), k, v, do, out
// are token-major bf16 [B, P, H*64]; lse and the optional dlse fp32
// [B, H, P]; seg int32 [B, P]; optional cos/sin bf16 [B, P, 64]. The JAX
// package computes delta = rowsum(do * out) - dlse outside its kernels
// (:933-940); here flash_dq's entry launches the fused kernel's small delta
// kernel first and hands delta [B, H, P] back, and flash_dkv reads it.
// With S = rot(q) rot(k)^T + mask and p = exp(S - lse):
//   flash_dq:  ds = p * (do v^T - delta) rounded to bf16, dq = ds rot(k)
//   flash_dkv: dv = bf16(p)^T do,  dk = ds^T rot(q)
// in fp32 sums, the inverse rotation applied to the fp32 dq and dk, each
// rounded to bf16 once. The mask is the segment rule with the bi-causal (or
// causal) rule of flash_common.cuh, whose split may fall inside a 64-row
// tile.
// A padded row (segment 0) gives dq = 0 and takes no part in dk and dv.
//
// What bounds it on the H100: bytes. At the denoise shape (B 256, P 88,
// H 12) flash_dq reads q, k, v, do, out (5 x 34.6 MB), cos, sin and lse and
// writes delta and dq; flash_dkv reads q, k, v, do, cos, sin, lse and delta
// and writes dk and dv: ~216 MB each, 64 us of HBM time, against ~9 and
// ~12 GFLOP of dense products (~10 us).
//
// Design. One CTA of 4 warps owns one 64-row tile of one (batch row, head):
// flash_dq its queries, looping over every key tile of the row; flash_dkv
// its keys, looping over every query tile. Each CTA writes only its own
// tile, so no atomics, and the result is the same from run to run. The
// kernels live in flash_bwd_common.cuh (shared with the streamed pair #7,
// #8) and their loop body is the fused kernel's pass: a tile pair
// whose segment-id ranges do not meet is skipped before it is loaded, S and
// dP are recomputed per pair in WMMA bf16 tiles with fp32 accumulation, and
// loads are 16 bytes a thread, single-buffered. Splitting costs S and dP
// once more than the fused kernel; the two stay separate kernels so that
// each is counted and timed on its own.

#include "flash_bwd_common.cuh"

// C entries for ctypes, on `stream`; each returns the first CUDA error (0
// when its launches were accepted). flash_dq: the delta kernel into the
// caller's fp32 [B, H, P] `delta` (dlse may be null: zeros), then the dq
// kernel. flash_dkv: one launch, reading that delta.
extern "C" int ggt_flash_dq(const void* q, const void* k, const void* v, const void* seg,
                            const void* cos, const void* sin, const void* out,
                            const void* lse, const void* dout, const void* dlse,
                            void* delta, void* dq, int B, int P, int H, int causal,
                            int bi_split, void* stream) {
  static bool configured = false;
  cudaError_t err = allow_smem(flash_dq_kernel<false>, &configured);
  if (err != cudaSuccess) return (int)err;
  err = launch_delta(dout, out, seg, dlse, delta, B, P, H, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((P + 63) / 64, H, B);
  flash_dq_kernel<false><<<grid, THREADS, sizeof(Smem), (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)seg, (const int*)seg,
      nullptr, nullptr, (const bf16*)cos, (const bf16*)sin, (const float*)lse,
      (const float*)delta, (const bf16*)dout, (bf16*)dq, P, H, causal, bi_split);
  return (int)cudaGetLastError();
}

extern "C" int ggt_flash_dkv(const void* q, const void* k, const void* v, const void* seg,
                             const void* cos, const void* sin, const void* lse,
                             const void* delta, const void* dout, void* dk, void* dv,
                             int B, int P, int H, int causal, int bi_split, void* stream) {
  static bool configured = false;
  cudaError_t err = allow_smem(flash_dkv_kernel<false>, &configured);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((P + 63) / 64, H, B);
  flash_dkv_kernel<false><<<grid, THREADS, sizeof(Smem), (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)seg, (const int*)seg,
      nullptr, nullptr, (const bf16*)cos, (const bf16*)sin, (const float*)lse,
      (const float*)delta, (const bf16*)dout, (bf16*)dk, (bf16*)dv, P, H, causal, bi_split);
  return (int)cudaGetLastError();
}
