// Segment-masked flash attention backward in fp32, for Hopper: the fused
// backward #3 and the band backward #10 on one set of passes. (The split
// pair #4 / #5 and the streamed pair #7 / #8 are flash_bwd_split_f32.cu's.)
//
// Replaces graphgpt_tpu/ops/flash_attention.py:706 _bwd_kernel_fused and
// :484 _bwd_kernel_band when they are given fp32 (a `model.dtype: float32`
// model): there their products, p = exp(S - lse) and ds = p * (do v^T -
// delta) stay fp32 (the casts to the working dtype, :764-770, change
// nothing). The bf16 forms are csrc/flash_bwd.cu. Same contracts: q
// (pre-scaled, unrotated), k, v, out, do token-major [B, P, H * 64] fp32,
// segment ids int32 [B, P] (the band backward: query ids seg and key ids
// seg_k, one array twice for a model's rows), RoPE cos/sin [B, P, 64] fp32
// (or null; the band backward takes q and k rotated and none), lse [B, H,
// P] fp32 and its optional cotangent dlse; delta = rowsum(do * out) - dlse
// [B, H, P] and dq, dk, dv [B, P, H * 64] fp32, dq and dk brought back
// through the inverse rotation. do is taken as zero on padded rows (segment
// 0) before any sum, so that a non-finite value there reaches no output; a
// padded row takes no part, and so does a query row that sees no key
// (possible only with ids of the keys' own); a key that no query sees gets
// dk = dv = 0. #3 takes the bidirectional and causal masks; #10 also the
// bi-causal one (`bi_split` bit slots, whose split may fall inside a
// 64-row tile).
//
// What bounds it on the H100: operations, as for the forward
// (flash_fwd_f32.cu): fp32-accurate products at 165 TFLOP/s (3xTF32) or
// 67 (FFMA), against ~0.3 GB of traffic at B 8 x P 1024.
//
// Design: simple and right first, and the same bits on every launch, so
// no atomics. Three launches: delta (a warp a row and head); the key pass,
// a block of 256 threads a (row, head, 64-key tile) that walks the query
// tiles which can see it and sums dk = ds^T q and dv = p^T do in
// registers; the query pass, a block a (row, head, 64-query tile) that
// walks the key tiles it sees and sums dq = ds k. Each pass computes S and
// do v^T again for its tile pairs. #3 is all three; #10 is all three in
// the band form, which reads the key tiles' ids from seg_k and walks only
// the tiles of a band: the query pass the key tiles of its query tile's
// band, the key pass the query tiles of its key tile's band (band_limits(
// seg_k, seg), the second table), both written first by tile_table.cuh's
// band_table_kernel. A template value picks the form, so that the single
// form compiles as before and keeps its bits. A tile outside a band holds
// no pair of matching ids, so it adds p = 0 and ds = 0 to the sums: on one
// id array the band form gives #3's bits. The passes walk 64-row tiles at
// any P. Tiles are fp32 in shared memory, the products FFMA
// (flash_f32.cuh).

#include "flash_f32.cuh"
#include "tile_table.cuh"  // the band form's band tables

namespace {

using namespace f32;

enum Form { SINGLE = 0, BAND = 2 };  // the stream form (1) is flash_bwd_split_f32.cu's

constexpr int KEY_SMEM = 6 * TILE * sizeof(float) + 2 * T * sizeof(float) + T * sizeof(int);
constexpr int QUERY_SMEM = 5 * TILE * sizeof(float) + T * sizeof(int);

// delta[b, h, p] = sum_d do * out - dlse, a warp a (b, p, h); do is 0 on padded rows
__global__ void __launch_bounds__(256)
delta_kernel(const float* __restrict__ dout, const float* __restrict__ out,
             const int* __restrict__ seg, const float* __restrict__ dlse,
             float* __restrict__ delta, int B, int P, int H) {
  const long long idx = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (idx >= (long long)B * P * H) return;
  const int h = (int)(idx % H);
  const long long bp = idx / H;
  const int b = (int)(bp / P), p = (int)(bp % P);
  const float* d0 = dout + bp * H * DH + h * DH;
  const float* o0 = out + bp * H * DH + h * DH;
  float s = 0.f;
  if (seg[bp] > 0) s = d0[lane] * o0[lane] + d0[lane + 32] * o0[lane + 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) {
    const long long r = ((long long)b * H + h) * P + p;
    delta[r] = dlse != nullptr ? s - dlse[r] : s;
  }
}

// The pair (query row i, key column c) takes part: one nonzero segment,
// and the column within the row's causal bound.
__device__ __forceinline__ bool visible(int qseg, int kseg, int col, int vis) {
  return kseg > 0 && kseg == qseg && col < vis;
}

// The key pass: dk, dv of the 64 keys [k0, k0 + 64) of head h, row b.
// BAND: the keys' ids are seg_k's (else seg's, and seg_k is unread), and
// the query tiles of band[b, key tile] only (band unread else).
template <int FORM>
__global__ void __launch_bounds__(THREADS)
dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const int* __restrict__ seg,
               const int* __restrict__ seg_k, const int2* __restrict__ band,
               const float* __restrict__ cos, const float* __restrict__ sin,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const float* __restrict__ dout, float* __restrict__ dk, float* __restrict__ dv,
               int P, int H, int causal, int bi_split) {
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + TILE;
  float* qs = vs + TILE;
  float* ds = qs + TILE;   // do
  float* ps = ds + TILE;   // p
  float* ss = ps + TILE;   // ds = p * (dp - delta)
  float* lse_s = ss + TILE;
  float* delta_s = lse_s + T;
  int* qseg = reinterpret_cast<int*>(delta_s + T);
  const int k0 = blockIdx.x * T, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int* seg_row = seg + (long long)b * P;
  const int* kseg_row = (FORM != SINGLE ? seg_k : seg) + (long long)b * P;
  const float* lse_row = lse + ((long long)b * H + h) * P;
  const float* delta_row = delta + ((long long)b * H + h) * P;

  load_tile(ks, k, seg, cos, sin, b, k0, P, H, h, false);
  load_tile(vs, v, seg, nullptr, nullptr, b, k0, P, H, h, false);
  int cseg[4];  // the key ids of the columns tx + 16 j
#pragma unroll
  for (int j = 0; j < 4; ++j) cseg[j] = k0 + tx + 16 * j < P ? kseg_row[k0 + tx + 16 * j] : 0;
  float dka[4][4], dva[4][4];
  zero(dka);
  zero(dva);
  // the first query row that may see this tile: the rule is monotone in the
  // column, so the tile's first column's (under a bi-causal split inside
  // the tile, its prefix columns are seen from row 0)
  int q_first = first_row(k0, causal, bi_split, P) / T * T, q_end = P;
  if constexpr (FORM == BAND) {
    // the query tiles from the band's first query to its last ((P, -1): none)
    const int2 lh = band[(long long)b * gridDim.x + blockIdx.x];
    q_first = max(q_first, lh.x / T * T);
    q_end = lh.y + 1;
  }
  for (int q0 = q_first; q0 < q_end; q0 += T) {
    if (tiles_miss(seg_row, q0, kseg_row, k0, P)) continue;
    __syncthreads();
    load_tile(qs, q, seg, cos, sin, b, q0, P, H, h, false);
    load_tile(ds, dout, seg, nullptr, nullptr, b, q0, P, H, h, true);
    load_seg(qseg, seg, b, q0, P);
    for (int r = threadIdx.x; r < T; r += THREADS) {
      lse_s[r] = q0 + r < P ? lse_row[q0 + r] : 0.f;
      delta_s[r] = q0 + r < P ? delta_row[q0 + r] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    mma64<false, false>(s, qs, ks, ty, tx);   // S(i, c) = q(i) . k(c)
    mma64<false, false>(dp, ds, vs, ty, tx);  // dP(i, c) = do(i) . v(c)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ri = ty + 16 * i, r = q0 + ri;
      const int vis = r < P ? visible_cols(r, causal, bi_split, P) : 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = visible(qseg[ri], cseg[j], k0 + tx + 16 * j, vis);
        const float p = ok ? expf(s[i][j] - lse_s[ri]) : 0.f;
        ps[ri * LD + tx + 16 * j] = p;
        ss[ri * LD + tx + 16 * j] = ok ? p * (dp[i][j] - delta_s[ri]) : 0.f;
      }
    }
    __syncthreads();
    // dv(c, d) += sum_i p(i, c) do(i, d); dk(c, d) += sum_i ds(i, c) q(i, d)
    mma64<true, true>(dva, ps, ds, ty, tx);
    mma64<true, true>(dka, ss, qs, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c >= P) continue;
    if (cos != nullptr) unrotate(dka[i], cos, sin, ((long long)b * P + c) * DH, tx);
    const long long o = ((long long)b * P + c) * H * DH + h * DH;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dk[o + tx + 16 * j] = dka[i][j];
      dv[o + tx + 16 * j] = dva[i][j];
    }
  }
}

// The query pass: dq of the 64 queries [q0, q0 + 64) of head h, row b.
// BAND: the key tiles' ids are seg_k's (else seg's, and seg_k is unread),
// and the key tiles of band[b, query tile] only (band unread else).
template <int FORM>
__global__ void __launch_bounds__(THREADS)
dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int* __restrict__ seg,
              const int* __restrict__ seg_k, const int2* __restrict__ band,
              const float* __restrict__ cos, const float* __restrict__ sin,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const float* __restrict__ dout, float* __restrict__ dq, int P, int H, int causal,
              int bi_split) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ds = qs + TILE;  // do
  float* ks = ds + TILE;
  float* vs = ks + TILE;
  float* ss = vs + TILE;  // ds = p * (dp - delta)
  int* kseg = reinterpret_cast<int*>(ss + TILE);
  const int q0 = blockIdx.x * T, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int* seg_row = seg + (long long)b * P;
  const int* kseg_ids = FORM != SINGLE ? seg_k : seg;
  const int* kseg_row = kseg_ids + (long long)b * P;
  const float* lse_row = lse + ((long long)b * H + h) * P;
  const float* delta_row = delta + ((long long)b * H + h) * P;

  load_tile(qs, q, seg, cos, sin, b, q0, P, H, h, false);
  load_tile(ds, dout, seg, nullptr, nullptr, b, q0, P, H, h, true);
  int rseg[4], rvis[4];
  float rlse[4], rdelta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    rseg[i] = r < P ? seg_row[r] : 0;
    rvis[i] = r < P ? visible_cols(r, causal, bi_split, P) : 0;
    rlse[i] = r < P ? lse_row[r] : 0.f;
    rdelta[i] = r < P ? delta_row[r] : 0.f;
  }
  float dqa[4][4];
  zero(dqa);
  // the key tiles a row of this tile may see (the rule is monotone in the row)
  int kmin = 0, kmax = visible_cols(min(q0 + T - 1, P - 1), causal, bi_split, P);
  if constexpr (FORM == BAND) {
    // the key tiles from the band's first key to its last ((P, -1): none)
    const int2 lh = band[(long long)b * gridDim.x + blockIdx.x];
    kmin = lh.x / T * T;
    kmax = min(kmax, lh.y + 1);
  }
  for (int k0 = kmin; k0 < kmax; k0 += T) {
    if (tiles_miss(seg_row, q0, kseg_row, k0, P)) continue;
    __syncthreads();
    load_tile(ks, k, seg, cos, sin, b, k0, P, H, h, false);
    load_tile(vs, v, seg, nullptr, nullptr, b, k0, P, H, h, false);
    load_seg(kseg, kseg_ids, b, k0, P);
    __syncthreads();
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    mma64<false, false>(s, qs, ks, ty, tx);
    mma64<false, false>(dp, ds, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool ok = visible(rseg[i], kseg[c], k0 + c, rvis[i]);
        const float p = ok ? expf(s[i][j] - rlse[i]) : 0.f;
        ss[(ty + 16 * i) * LD + c] = ok ? p * (dp[i][j] - rdelta[i]) : 0.f;
      }
    __syncthreads();
    // dq(i, d) += sum_c ds(i, c) k(c, d)
    mma64<false, true>(dqa, ss, ks, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= P) continue;
    if (cos != nullptr) unrotate(dqa[i], cos, sin, ((long long)b * P + r) * DH, tx);
    float* o = dq + ((long long)b * P + r) * H * DH + h * DH;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[tx + 16 * j] = dqa[i][j];
  }
}

// The three launches, each on `st`; the two passes raise their dynamic
// shared memory first.
void launch_delta(const float* dout, const float* out, const int* seg, const float* dlse,
                  float* delta, int B, int P, int H, cudaStream_t st) {
  const long long rows = (long long)B * P * H;
  delta_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(dout, out, seg, dlse, delta, B, P, H);
}

// The passes of form FORM; seg_k and the band table are read by the band
// form only.
template <int FORM>
cudaError_t launch_dkv(const float* q, const float* k, const float* v, const int* seg,
                       const int* seg_k, const int2* band, const float* cos, const float* sin,
                       const float* lse, const float* delta, const float* dout, float* dk,
                       float* dv, int B, int P, int H, int causal, int bi_split,
                       cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      dkv_f32_kernel<FORM>, cudaFuncAttributeMaxDynamicSharedMemorySize, KEY_SMEM);
  if (err != cudaSuccess) return err;
  dkv_f32_kernel<FORM><<<dim3((P + T - 1) / T, H, B), THREADS, KEY_SMEM, st>>>(
      q, k, v, seg, seg_k, band, cos, sin, lse, delta, dout, dk, dv, P, H, causal, bi_split);
  return cudaSuccess;
}

template <int FORM>
cudaError_t launch_dq(const float* q, const float* k, const float* v, const int* seg,
                      const int* seg_k, const int2* band, const float* cos, const float* sin,
                      const float* lse, const float* delta, const float* dout, float* dq, int B,
                      int P, int H, int causal, int bi_split, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      dq_f32_kernel<FORM>, cudaFuncAttributeMaxDynamicSharedMemorySize, QUERY_SMEM);
  if (err != cudaSuccess) return err;
  dq_f32_kernel<FORM><<<dim3((P + T - 1) / T, H, B), THREADS, QUERY_SMEM, st>>>(
      q, k, v, seg, seg_k, band, cos, sin, lse, delta, dout, dq, P, H, causal, bi_split);
  return cudaSuccess;
}

}  // namespace

// C entry for ctypes: #3's fp32 form (delta, then the key pass and the
// query pass) on `stream`; returns the first CUDA error (0 when the
// launches were accepted). cos and sin may both be null, and so may dlse
// (zeros). Any P.
extern "C" int ggt_flash_bwd_f32(const void* q, const void* k, const void* v, const void* seg,
                                 const void* cos, const void* sin, const void* out,
                                 const void* lse, const void* dout, const void* dlse,
                                 void* delta, void* dq, void* dk, void* dv, int B, int P, int H,
                                 int causal, void* stream) {
  if (B == 0 || P == 0 || H == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const float *fq = (const float*)q, *fk = (const float*)k, *fv = (const float*)v;
  const float *fcos = (const float*)cos, *fsin = (const float*)sin, *flse = (const float*)lse;
  const float* fdo = (const float*)dout;
  const int* iseg = (const int*)seg;
  launch_delta(fdo, (const float*)out, iseg, (const float*)dlse, (float*)delta, B, P, H, st);
  cudaError_t err = launch_dkv<SINGLE>(fq, fk, fv, iseg, nullptr, nullptr, fcos, fsin, flse,
                                       (const float*)delta, fdo, (float*)dk, (float*)dv, B, P,
                                       H, causal, 0, st);
  if (err == cudaSuccess)
    err = launch_dq<SINGLE>(fq, fk, fv, iseg, nullptr, nullptr, fcos, fsin, flse,
                            (const float*)delta, fdo, (float*)dq, B, P, H, causal, 0, st);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// C entry for ctypes: #10's fp32 form (both band tables, delta, then the
// key pass and the query pass in the band form) on `stream`; returns the
// first CUDA error. Query ids segq and key ids segk (one array twice for a
// model's rows), q and k already rotated; dlse may be null (zeros). It
// takes the bf16 entry's arguments: `tab` is int32 scratch of 4 x B x
// ceil(P/64) from the caller, the query tiles' band table first, then the
// key tiles' (the same table when segq and segk are one array), both
// written first. Masks: bidirectional, causal, or bi-causal with
// `bi_split` bit slots. Any P.
extern "C" int ggt_flash_bwd_band_f32(const void* q, const void* k, const void* v,
                                      const void* segq, const void* segk, const void* out,
                                      const void* lse, const void* dout, const void* dlse,
                                      void* delta, void* dq, void* dk, void* dv, void* tab, int B,
                                      int P, int H, int causal, int bi_split, void* stream) {
  if (B == 0 || P == 0 || H == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  int2* tq = (int2*)tab;
  int2* tk = segk == segq ? tq : tq + (long long)B * ((P + 63) / 64);
  cudaError_t err = launch_band_table(segq, segk, tq, B, P, st);
  if (err == cudaSuccess && tk != tq) err = launch_band_table(segk, segq, tk, B, P, st);
  if (err != cudaSuccess) return (int)err;
  const float *fq = (const float*)q, *fk = (const float*)k, *fv = (const float*)v;
  const float *flse = (const float*)lse, *fdo = (const float*)dout;
  const int *iq = (const int*)segq, *ik = (const int*)segk;
  launch_delta(fdo, (const float*)out, iq, (const float*)dlse, (float*)delta, B, P, H, st);
  err = launch_dkv<BAND>(fq, fk, fv, iq, ik, tk, nullptr, nullptr, flse, (const float*)delta, fdo,
                         (float*)dk, (float*)dv, B, P, H, causal, bi_split, st);
  if (err == cudaSuccess)
    err = launch_dq<BAND>(fq, fk, fv, iq, ik, tq, nullptr, nullptr, flse, (const float*)delta,
                          fdo, (float*)dq, B, P, H, causal, bi_split, st);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
