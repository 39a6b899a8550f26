// Segment-masked flash attention forward in fp32, for Hopper: #1's form
// and, with the keys' own segment ids, #6's and #9's.
//
// Replaces graphgpt_tpu/ops/flash_attention.py:124 _fwd_kernel_single
// (single form), :177 _fwd_kernel_stream (stream form) and :282
// _fwd_kernel_band (band form) when they are given fp32 (a `model.dtype:
// float32` model): they take their working type from their inputs, so
// there q.k^T, the probabilities (cast to v's dtype, :155, :254, :330) and
// p.v are all fp32, and out is written in q's dtype. The bf16 forms are
// csrc/flash_fwd.cu's. Same contract: q (pre-scaled), k, v token-major
// [B, P, H * 64] fp32, segment ids int32 [B, P] (the stream and band
// forms: query ids seg and key ids seg_k, one array twice for a model's
// rows, another for a ring chunk's keys), RoPE cos/sin [B, P, 64] fp32
// applied in the kernel (or null; the band form takes q and k rotated and
// none); out [B, P, H * 64] fp32, lse [B, H, P] fp32. Masks:
// bidirectional, causal, or bi-causal with `bi_split` bit slots. A padded
// row (segment 0), and a row that sees no key (possible only with ids of
// the keys' own), give out 0 and lse -1e30.
//
// What bounds it on the H100: operations. The products must keep fp32
// accuracy, so the tensor cores' TF32 (about three decimal digits) is out;
// the fastest fp32-accurate product is 3xTF32 at 495 / 3 = 165 TFLOP/s,
// and this kernel's FFMA tops out at the 67 TFLOP/s of the fp32 cores. At
// B 8 x P 1024, 12 heads, the packed segments leave ~6 GFLOP of visible
// work and 0.15 GB of traffic, so even FFMA is far from the byte bound.
//
// Design: simple and right first. One block of 256 threads a (row, head,
// 64-query tile), an online softmax over the 64-key tiles the mask lets
// through (a tile pair that shares no segment id, or lies past the causal
// bound, is skipped); q, k, v and the probabilities as 64 x 64 fp32 tiles
// in shared memory (flash_f32.cuh), S = q k^T and O += P v by FFMA. The
// body already streams the keys at any P, so the stream form differs from
// the single one only where it reads the key tiles' ids (from seg_k), and
// the band form from the stream one only in the key tiles it walks: those
// of its query tile's band, from the band table that the entry writes
// first (tile_table.cuh's band_table_kernel, the plain `band_limits`), cut
// at the causal bound as before. A template value picks the form, so that
// the single and stream forms compile as before and keep their bits. A
// key tile outside the band holds no key of the query tile's ids, so it
// leaves m, l and acc exactly as they were (scale expf(0) = 1, p = 0); the
// band form visits the rest in the same order and gives the stream form's
// bits, and with seg_k == seg the single form's.

#include "flash_f32.cuh"
#include "tile_table.cuh"  // the band form's band table

namespace {

using namespace f32;

constexpr int SMEM = 4 * TILE * sizeof(float) + T * sizeof(int);  // q, k, v, p; key ids

enum Form { SINGLE = 0, STREAM = 1, BAND = 2 };

// STREAM and BAND: the key tiles' ids are seg_k's (else seg's, and seg_k is
// unread). BAND: the key tiles of band[b, q tile] only (band unread else).
template <int FORM>
__global__ void __launch_bounds__(THREADS, 2)
fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const int* __restrict__ seg,
               const int* __restrict__ seg_k, const int2* __restrict__ band,
               const float* __restrict__ cos, const float* __restrict__ sin,
               float* __restrict__ out, float* __restrict__ lse, int P, int H, int causal,
               int bi_split) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + TILE;
  float* vs = ks + TILE;
  float* ps = vs + TILE;
  int* kseg = reinterpret_cast<int*>(ps + TILE);
  const int q0 = blockIdx.x * T, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int* seg_row = seg + (long long)b * P;
  const int* kseg_ids = FORM != SINGLE ? seg_k : seg;
  const int* kseg_row = kseg_ids + (long long)b * P;

  load_tile(qs, q, seg, cos, sin, b, q0, P, H, h, false);
  int rseg[4], rvis[4];
  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    rseg[i] = r < P ? seg_row[r] : 0;
    rvis[i] = r < P ? visible_cols(r, causal, bi_split, P) : 0;
    m[i] = NEG;
    l[i] = 0.f;
  }
  zero(acc);
  // the key tiles a row of this tile may see
  int kmin = 0, kmax = visible_cols(min(q0 + T - 1, P - 1), causal, bi_split, P);
  if constexpr (FORM == BAND) {
    // the key tiles from the band's first key to its last ((P, -1): none)
    const int2 lh = band[(long long)b * gridDim.x + blockIdx.x];
    kmin = lh.x / T * T;
    kmax = min(kmax, lh.y + 1);
  }
  for (int k0 = kmin; k0 < kmax; k0 += T) {
    if (tiles_miss(seg_row, q0, kseg_row, k0, P)) continue;
    __syncthreads();  // the last tile's reads of ks, vs, ps are done
    load_tile(ks, k, seg, cos, sin, b, k0, P, H, h, false);
    load_tile(vs, v, seg, nullptr, nullptr, b, k0, P, H, h, false);
    load_seg(kseg, kseg_ids, b, k0, P);
    __syncthreads();
    float s[4][4];
    zero(s);
    mma64<false, false>(s, qs, ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      unsigned ok = 0;  // bit j: the pair (row, column tx + 16 j) is visible
      float mt = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        if (kseg[c] > 0 && kseg[c] == rseg[i] && k0 + c < rvis[i]) {
          ok |= 1u << j;
          mt = fmaxf(mt, s[i][j]);
        }
      }
      const float mn = fmaxf(m[i], row_max(mt));
      // a row with no visible key yet keeps m = NEG, l = 0 and acc = 0
      const float scale = mn > NEG ? expf(m[i] - mn) : 1.f;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (ok >> j) & 1u ? expf(s[i][j] - mn) : 0.f;
        sum += p;
        ps[(ty + 16 * i) * LD + tx + 16 * j] = p;
      }
      l[i] = l[i] * scale + row_sum(sum);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= scale;
      m[i] = mn;
    }
    __syncthreads();
    // O(i, d) += sum_j P(i, j) v(j, d)
    mma64<false, true>(acc, ps, vs, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= P) continue;
    const bool live = rseg[i] > 0 && m[i] > NEG;
    float* o = out + ((long long)b * P + r) * H * DH + h * DH;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[tx + 16 * j] = live ? acc[i][j] / l[i] : 0.f;
    if (tx == 0) lse[((long long)b * H + h) * P + r] = live ? m[i] + logf(l[i]) : NEG;
  }
}

// One launch of form FORM on `stream`; returns the first CUDA error.
template <int FORM>
int launch(const void* q, const void* k, const void* v, const void* seg, const void* seg_k,
           const int2* band, const void* cos, const void* sin, void* out, void* lse, int B,
           int P, int H, int causal, int bi_split, void* stream) {
  if (B == 0 || P == 0 || H == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(fwd_f32_kernel<FORM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((P + T - 1) / T, H, B);
  fwd_f32_kernel<FORM><<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const int*)seg, (const int*)seg_k,
      band, (const float*)cos, (const float*)sin, (float*)out, (float*)lse, P, H, causal,
      bi_split);
  return (int)cudaGetLastError();
}

}  // namespace

// C entries for ctypes, on `stream`: each returns the first CUDA error (0
// when the launch was accepted). cos and sin may both be null (no RoPE).
// Any P.

// #1's fp32 form: one id array.
extern "C" int ggt_flash_fwd_f32(const void* q, const void* k, const void* v, const void* seg,
                                 const void* cos, const void* sin, void* out, void* lse, int B,
                                 int P, int H, int causal, int bi_split, void* stream) {
  return launch<SINGLE>(q, k, v, seg, nullptr, nullptr, cos, sin, out, lse, B, P, H, causal,
                        bi_split, stream);
}

// #6's fp32 form: query ids segq and key ids segk (one array twice for a
// model's rows). It takes the bf16 entry's arguments; `tab`, the bf16
// form's tile-table scratch, is not read: each block tests its tile pairs
// itself (tiles_miss).
extern "C" int ggt_flash_fwd_stream_f32(const void* q, const void* k, const void* v,
                                        const void* segq, const void* segk, const void* cos,
                                        const void* sin, void* out, void* lse, void* tab, int B,
                                        int P, int H, int causal, int bi_split, void* stream) {
  (void)tab;
  return launch<STREAM>(q, k, v, segq, segk, nullptr, cos, sin, out, lse, B, P, H, causal,
                        bi_split, stream);
}

// #9's fp32 form: query ids segq and key ids segk (one array twice for a
// model's rows), q and k already rotated. It takes the bf16 entry's
// arguments: `tab`, int32 scratch of 2 x B x ceil(P/64) from the caller,
// into whose first B x ceil(P/64) int2 the query tiles' band table is
// written first, then read by the forward. Any P.
extern "C" int ggt_flash_fwd_band_f32(const void* q, const void* k, const void* v,
                                      const void* segq, const void* segk, void* out, void* lse,
                                      void* tab, int B, int P, int H, int causal, int bi_split,
                                      void* stream) {
  if (B == 0 || P == 0 || H == 0) return 0;
  int2* band = (int2*)tab;
  const cudaError_t err = launch_band_table(segq, segk, band, B, P, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return launch<BAND>(q, k, v, segq, segk, band, nullptr, nullptr, out, lse, B, P, H, causal,
                      bi_split, stream);
}
