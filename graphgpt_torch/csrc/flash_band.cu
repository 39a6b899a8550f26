// Band-sparse flash attention, forward and backward, for Hopper: kernels #9
// flash_fwd_band and #10 flash_bwd_band, each behind its own C entry.
//
// Replaces graphgpt_tpu/ops/flash_attention.py:282 _fwd_kernel_band and :484
// _bwd_kernel_band, which _flash_fwd (:409) and _flash_bwd (:902) launch
// under GGT_FLASH_MODE=band for P <= 4096. Same contract: q (pre-scaled and
// already rotated: the band path applies RoPE outside), k, v, do, out
// token-major bf16 [B, P, H*64]; seg_q and seg_k int32 [B, P]; lse, delta
// and the optional dlse fp32 [B, H, P]. With S = q k^T + mask (seg_q[row] ==
// seg_k[col] > 0, causal or bi-causal) and p = exp(S - lse):
//   #9:  out = softmax(S) v with p rounded to bf16 for the product, and lse;
//        a row whose seg_q is 0, or which sees no key, gives out = 0 and
//        lse = -1e30.
//   #10: dv = bf16(p)^T do, ds = p * (do v^T - delta) rounded to bf16,
//        dq = ds k, dk = ds^T q, every sum fp32 and rounded once; delta =
//        rowsum(do * out) - dlse comes from outside the main kernel, as in
//        the JAX package (:933-940): the entry launches the backward's
//        delta kernel first. A padded row takes no part, even where dlse
//        reaches it (the port's rule; the JAX kernel lets exp(S - lse) = 1
//        spread it).
//
// The band. For a 64-row q tile, the keys that can match lie between the
// first and the last key position whose id falls inside the tile's
// [min positive id, max id] (graphgpt_tpu _band_limits :265): packing gives
// increasing ids, so that is one contiguous stretch a little wider than the
// tile. A pre-pass (band_table_kernel, one warp a tile) writes that (lo, hi)
// for every tile into a table [B, ceil(P/64)] of int2 shared by the heads,
// the same table as the plain `band_limits`; (P, -1) for a tile of padding.
// The kernels then loop over the key tiles of the band alone, where #6
// probes all 64 tiles' ranges at P 4096.
//
// What bounds them on the H100: bytes. At 65,536 tokens (B 16 x P 4096 or
// B 64 x P 1024, H 12) #9 reads q, k, v and writes out (4 x 100.66 MB) and
// lse (3.15 MB): ~406 MB, 0.121 ms at 3.35 TB/s; #10 reads q, k, v, do and
// writes dq, dk, dv (7 x 100.66 MB) plus lse and delta: ~711 MB, 0.212 ms.
// On ~32-token packed segments their products are a few GFLOP, ~10 us.
//
// Design. #9 is the body of #1 and #6 (flash_fwd_common.cuh) with BAND: one
// CTA of 4 warps per (64-row q tile, head, batch row), an online softmax
// over the band's key tiles, the causal or bi-causal top clipped as the JAX
// kernel clips it. #10 does not carry dk and dv across q tiles in scratch as
// the TPU kernel does (blocks on this card run in any order): it is the
// two-role CTA of flash_bwd_common.cuh, no atomics. As the owner of a key
// tile it loops over the q tiles of that key tile's band (a second table:
// the query positions whose ids fall in the key tile's range) and sums dk
// and dv; as the owner of a q tile it loops over the q tile's band and sums
// dq. S and dP are computed once more than the TPU kernel's single pass,
// which costs little where bytes are the bound.
// WMMA bf16 tiles with fp32 accumulation, 16-byte loads, single-buffered:
// TMA, wgmma and pipelining are later work.

#include "flash_fwd_common.cuh"
#include "flash_bwd_common.cuh"

namespace {

// tab[b, t] = (lo, hi): the first and last positions of segv[b] whose id
// lies in [min positive id, max id] of sego[b, 64t : 64t + 64); (P, -1)
// when there is none (a tile of padding, or no key of its ids).
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

inline cudaError_t launch_band_table(const void* sego, const void* segv, int2* tab, int B,
                                     int P, cudaStream_t st) {
  const int nt = (P + 63) / 64;
  const long long tiles = (long long)B * nt;
  const int wpb = 8;  // warps per block
  band_table_kernel<<<(unsigned)((tiles + wpb - 1) / wpb), wpb * 32, 0, st>>>(
      (const int*)sego, (const int*)segv, tab, P, nt, tiles);
  return cudaGetLastError();
}

// #10's main kernel: one CTA per (64-row tile, head, batch row), first as
// the owner of those keys (dk, dv), then of those queries (dq).
__global__ void __launch_bounds__(THREADS)
flash_bwd_band_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const int* __restrict__ segq,
                      const int* __restrict__ segk, const int2* __restrict__ tabq,
                      const int2* __restrict__ tabk, const float* __restrict__ lse,
                      const float* __restrict__ delta, const bf16* __restrict__ dout,
                      bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                      int P, int H, int causal, int bi_split) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int t0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nt = (P + 63) / 64;
  const long long rs = (long long)H * DH;
  const long long base = (long long)b * P * rs + h * DH;
  const long long rows = ((long long)b * H + h) * P;
  const int* segqb = segq + (long long)b * P;
  const int* segkb = segk + (long long)b * P;
  const int2* tabqb = tabq + (long long)b * nt;
  const int2* tabkb = tabk + (long long)b * nt;
  const int row = t0 + warp * 16 + (lane >> 1);

  AccFrag acc1[4], acc2[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wmma::fill_fragment(acc1[j], 0.f);
    wmma::fill_fragment(acc2[j], 0.f);
  }
  pass<true>(sm, q + base, k + base, v + base, dout + base, segqb, segkb, tabqb, tabkb,
             lse + rows, delta + rows, rs, t0, P, causal, bi_split, acc1, acc2);
  write_rows(dk + base, rs, acc1, sm.s[warp], row, P, lane);
  write_rows(dv + base, rs, acc2, sm.s[warp], row, P, lane);

#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc1[j], 0.f);
  pass<false>(sm, q + base, k + base, v + base, dout + base, segqb, segkb, tabqb, tabkb,
              lse + rows, delta + rows, rs, t0, P, causal, bi_split, acc1, acc2);
  write_rows(dq + base, rs, acc1, sm.s[warp], row, P, lane);
}

}  // namespace

// C entries for ctypes, on `stream`; each returns the first CUDA error (0
// when its launches were accepted). `tab` is int32 scratch of
// 4 x B x ceil(P/64) from the caller: the q tiles' band table first, then,
// for the backward, the key tiles' (the same table when seg_q and seg_k are
// one array).

// #9: the q tiles' band table, then out and lse.
extern "C" int ggt_flash_fwd_band(const void* q, const void* k, const void* v, const void* segq,
                                  const void* segk, void* out, void* lse, void* tab, int B,
                                  int P, int H, int causal, int bi_split, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int2* tq = (int2*)tab;
  cudaError_t err = launch_band_table(segq, segk, tq, B, P, st);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((P + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<true, true><<<grid, THREADS, 0, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)segq, (const int*)segk, tq,
      nullptr, nullptr, nullptr, (bf16*)out, (float*)lse, P, H, causal, bi_split);
  return (int)cudaGetLastError();
}

// #10: both band tables, the delta kernel into the caller's fp32 [B, H, P]
// `delta` (dlse may be null: zeros), then dq, dk, dv.
extern "C" int ggt_flash_bwd_band(const void* q, const void* k, const void* v, const void* segq,
                                  const void* segk, const void* out, const void* lse,
                                  const void* dout, const void* dlse, void* delta, void* dq,
                                  void* dk, void* dv, void* tab, int B, int P, int H, int causal,
                                  int bi_split, void* stream) {
  static bool configured = false;
  cudaError_t err = allow_smem(flash_bwd_band_kernel, &configured);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  int2* tq = (int2*)tab;
  int2* tk = segk == segq ? tq : tq + (long long)B * ((P + 63) / 64);
  err = launch_band_table(segq, segk, tq, B, P, st);
  if (err != cudaSuccess) return (int)err;
  if (tk != tq) {
    err = launch_band_table(segk, segq, tk, B, P, st);
    if (err != cudaSuccess) return (int)err;
  }
  err = launch_delta(dout, out, segq, dlse, delta, B, P, H, st);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((P + 63) / 64, H, B);
  flash_bwd_band_kernel<<<grid, THREADS, sizeof(Smem), st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)segq, (const int*)segk, tq, tk,
      (const float*)lse, (const float*)delta, (const bf16*)dout, (bf16*)dq, (bf16*)dk, (bf16*)dv,
      P, H, causal, bi_split);
  return (int)cudaGetLastError();
}
