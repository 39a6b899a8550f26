// Segment-masked flash attention forward with in-kernel RoPE, for Hopper.
//
// Replaces graphgpt_tpu/ops/flash_attention.py:124 _fwd_kernel_single (the
// TPU's single-block forward, launched by _flash_fwd :409 when P <= 2048).
// Same contract: q (pre-scaled), k, v are token-major bf16 [B, P, H*64];
// seg int32 [B, P] (0 = padding, equal ids = one packed segment); optional
// cos/sin bf16 [B, P, 64] with the halves duplicated, applied to q and k
// in bf16 (each product and the sum rounded, as the plain version does);
// out bf16 [B, P, H*64]; lse fp32 [B, H, P]. A row whose segment is 0 gives
// out = 0 and lse = -1e30. Masked logits take the additive -1e30 of the JAX
// kernel, never -inf, so a fully masked row cannot make NaN. The mask is the
// segment rule plus causal, or, with bi_split > 0, the bi-causal rule of the
// denoise model's energy decoding (visible_cols in flash_common.cuh).
//
// What bounds it on the H100: bytes. On packed rows (~32-token segments) a
// query meets a few dozen keys, so the masked work is ~1 GFLOP against
// ~53 MB of q, k, v, out at B=8, P=1024, H=12: about 16 us of HBM time and
// 1 us of tensor-core time. The TPU kernel's whole-row block does the dense
// 26 GFLOP instead.
//
// Design (the kernel body is flash_fwd_common.cuh's, shared with the
// streamed forward #6): one CTA of 4 warps per (64-row q tile, head, batch
// row); a loop over 64-key tiles with an online softmax (fp32 running max
// and sum, one row per lane pair). A key tile whose segment-id range misses
// the q tile's is skipped before it is loaded, which on packed rows leaves
// one or two of the sixteen tiles at P=1024: the kernel reads little more
// than q, k, v once. Products go through WMMA bf16 tensor-core tiles with fp32
// accumulation; the probabilities are rounded to bf16 for the PV product as
// in the TPU kernel. Loads are 16 bytes a thread, single-buffered: the
// rewrite onto TMA and wgmma with pipelined tiles is later work.

#include "flash_fwd_common.cuh"

// C entry for ctypes: returns cudaGetLastError() after the launch.
extern "C" int ggt_flash_fwd(const void* q, const void* k, const void* v,
                             const void* seg, const void* cos, const void* sin,
                             void* out, void* lse, int B, int P, int H, int causal,
                             int bi_split, void* stream) {
  dim3 grid((P + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)seg, (const int*)seg,
      nullptr, nullptr, (const bf16*)cos, (const bf16*)sin, (bf16*)out, (float*)lse, P, H,
      causal, bi_split);
  return (int)cudaGetLastError();
}
