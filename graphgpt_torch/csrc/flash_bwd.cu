// Segment-masked flash attention backward (dq, dk, dv) with in-kernel RoPE,
// for Hopper.
//
// Replaces graphgpt_tpu/ops/flash_attention.py:706 _bwd_kernel_fused (the
// TPU's single-block fused backward, reached from _flash_bwd :902 when
// P <= 2048 without a bi-causal split). Same contract: q (pre-scaled, not
// rotated), k, v, do, out are token-major bf16 [B, P, H*64]; lse and the
// optional dlse are fp32 [B, H, P]; seg int32 [B, P]; optional cos/sin bf16
// [B, P, 64]. With S = rot(q) rot(k)^T + mask, p = exp(S - lse) and
// delta = rowsum(do * out) - dlse:
//   dv = p^T do,  ds = p * (do v^T - delta),  dq = ds rot(k),  dk = ds^T rot(q)
// p is rounded to bf16 for the dv product and ds to bf16 for the dq and dk
// products; every sum is fp32. dq and dk come back through the inverse
// rotation, applied to the fp32 sums and rounded to bf16 once. A row of
// segment 0 takes no part: its dq, and dk, dv of such a key, are exactly 0
// (on such a row exp(S - lse) would be 1, so the mask decides, not the
// exponent, and do is zeroed there as well).
//
// What bounds it on the H100: bytes. At B=64, P=1024, H=12 it must read q,
// k, v, do, out and write dq, dk, dv (8 x 100.7 MB, ~0.25 ms of HBM time)
// against ~22 GFLOP of unmasked products on packed ~32-token segments
// (~0.02 ms of tensor-core time).
//
// Design. The TPU kernel walks the q tiles in order and carries dk, dv in
// scratch from one grid step to the next; blocks on this card run in any
// order, so nothing is carried. A first small kernel writes delta [B, H, P]
// (one warp per row of 64). Then one CTA of 4 warps owns one 64-row tile of
// one (batch row, head) and works twice. As the owner of those KEYS it loops
// over the q tiles whose segment-id range meets its own (one or two of
// sixteen on packed rows), recomputes S^T and dP^T for the pair, and sums
// dv and dk in fp32 fragments. As the owner of those QUERIES it loops over
// the key tiles the same way and sums dq. The neighbour tiles come from L2.
// S is recomputed once more than a single-pass kernel would, which costs
// little where bytes are the bound, and no atomics are needed: the result is
// the same from run to run. Products are WMMA bf16 tiles with fp32
// accumulation; loads are 16 bytes a thread, single-buffered. The two
// passes live in flash_bwd_common.cuh, which the split pair
// (flash_bwd_split.cu) shares; this kernel never sees a bi-causal split.

#include "flash_bwd_common.cuh"

namespace {

__global__ void __launch_bounds__(THREADS)
flash_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ seg,
                 const bf16* __restrict__ cosb, const bf16* __restrict__ sinb,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const bf16* __restrict__ dout, bf16* __restrict__ dq,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, int P, int H,
                 int causal) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int t0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long rs = (long long)H * DH;
  const long long base = (long long)b * P * rs + h * DH;
  const int* segb = seg + (long long)b * P;
  const float* lseb = lse + ((long long)b * H + h) * P;
  const float* deltab = delta + ((long long)b * H + h) * P;
  const bf16* cb = cosb ? cosb + (long long)b * P * DH : nullptr;
  const bf16* sb = sinb ? sinb + (long long)b * P * DH : nullptr;
  const int row = t0 + warp * 16 + (lane >> 1);

  AccFrag acc1[4], acc2[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wmma::fill_fragment(acc1[j], 0.f);
    wmma::fill_fragment(acc2[j], 0.f);
  }
  pass<true, false>(sm, q + base, k + base, v + base, dout + base, segb, segb, nullptr,
                    nullptr, lseb, deltab, cb, sb, rs, t0, P, causal, 0, acc1, acc2);
  write_rows(dk + base, rs, acc1, sm.s[warp], row, P, cb, sb, lane);
  write_rows(dv + base, rs, acc2, sm.s[warp], row, P, nullptr, nullptr, lane);

#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc1[j], 0.f);
  pass<false, false>(sm, q + base, k + base, v + base, dout + base, segb, segb, nullptr,
                     nullptr, lseb, deltab, cb, sb, rs, t0, P, causal, 0, acc1, acc2);
  write_rows(dq + base, rs, acc1, sm.s[warp], row, P, cb, sb, lane);
}

}  // namespace

// C entry for ctypes: the delta kernel, then the main kernel, on `stream`;
// returns the first CUDA error (0 when both launches were accepted). dlse
// may be null (zeros). delta is fp32 scratch [B, H, P] from the caller.
extern "C" int ggt_flash_bwd(const void* q, const void* k, const void* v,
                             const void* seg, const void* cos, const void* sin,
                             const void* out, const void* lse, const void* dout,
                             const void* dlse, void* delta, void* dq, void* dk,
                             void* dv, int B, int P, int H, int causal, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = launch_delta(dout, out, seg, dlse, delta, B, P, H, st);
  if (err != cudaSuccess) return (int)err;
  static bool configured = false;
  if (!configured) {
    err = cudaFuncSetAttribute(flash_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sizeof(Smem));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((P + 63) / 64, H, B);
  flash_bwd_kernel<<<grid, THREADS, sizeof(Smem), st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)seg, (const bf16*)cos,
      (const bf16*)sin, (const float*)lse, (const float*)delta, (const bf16*)dout,
      (bf16*)dq, (bf16*)dk, (bf16*)dv, P, H, causal);
  return (int)cudaGetLastError();
}
