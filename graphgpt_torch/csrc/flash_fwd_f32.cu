// Segment-masked flash attention forward in fp32, for Hopper: #9's form,
// the band forward.
//
// Replaces graphgpt_tpu/ops/flash_attention.py:282 _fwd_kernel_band when
// it is given fp32 (a `model.dtype: float32` model): it takes its working
// type from its inputs, so there q.k^T, the probabilities (cast to v's
// dtype, :330) and p.v are all fp32, and out is written in q's dtype. The
// bf16 form is csrc/flash_fwd.cu's; #1's and #6's fp32 forms are the
// forward role of csrc/flash_bwd_split_f32.cu's 3xTF32 body. Same
// contract: q (pre-scaled, rotated), k (rotated), v token-major [B, P, H *
// 64] fp32, query ids seg and key ids seg_k int32 [B, P] (one array twice
// for a model's rows, another for a ring chunk's keys); out [B, P, H * 64]
// fp32, lse [B, H, P] fp32. Masks: bidirectional, causal, or bi-causal
// with `bi_split` bit slots. A padded row (segment 0), and a row that sees
// no key (possible only with ids of the keys' own), give out 0 and lse
// -1e30.
//
// What bounds it on the H100: operations. The products must keep fp32
// accuracy, so the tensor cores' TF32 (about three decimal digits) is out;
// the fastest fp32-accurate product is 3xTF32 at 495 / 3 = 165 TFLOP/s,
// and this kernel's FFMA tops out at the 67 TFLOP/s of the fp32 cores.
//
// Design: simple and right first. One block of 256 threads a (row, head,
// 64-query tile), an online softmax over the 64-key tiles of its query
// tile's band, from the band table that the entry writes first
// (tile_table.cuh's band_table_kernel, the plain `band_limits`), cut at the
// causal bound (a tile pair that shares no segment id is skipped); q, k, v
// and the probabilities as 64 x 64 fp32 tiles in shared memory
// (flash_f32.cuh), S = q k^T and O += P v by FFMA. A key tile outside the
// band holds no key of the query tile's ids, so it would leave m, l and acc
// exactly as they were (scale expf(0) = 1, p = 0).

#include "flash_f32.cuh"
#include "tile_table.cuh"  // the band form's band table

namespace {

using namespace f32;

constexpr int SMEM = 4 * TILE * sizeof(float) + T * sizeof(int);  // q, k, v, p; key ids

// The key tiles of band[b, q tile] only, their ids seg_k's.
__global__ void __launch_bounds__(THREADS, 2)
fwd_band_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const int* __restrict__ seg,
                    const int* __restrict__ seg_k, const int2* __restrict__ band,
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
  const int* kseg_row = seg_k + (long long)b * P;

  load_tile(qs, q, seg, nullptr, nullptr, b, q0, P, H, h, false);
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
  // the key tiles from the band's first key to its last ((P, -1): none),
  // up to the last column a row of this tile may see
  const int2 lh = band[(long long)b * gridDim.x + blockIdx.x];
  const int kmin = lh.x / T * T;
  const int kmax = min(visible_cols(min(q0 + T - 1, P - 1), causal, bi_split, P), lh.y + 1);
  for (int k0 = kmin; k0 < kmax; k0 += T) {
    if (tiles_miss(seg_row, q0, kseg_row, k0, P)) continue;
    __syncthreads();  // the last tile's reads of ks, vs, ps are done
    load_tile(ks, k, seg, nullptr, nullptr, b, k0, P, H, h, false);
    load_tile(vs, v, seg, nullptr, nullptr, b, k0, P, H, h, false);
    load_seg(kseg, seg_k, b, k0, P);
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

}  // namespace

// #9's fp32 form: query ids segq and key ids segk (one array twice for a
// model's rows), q and k already rotated. It takes the bf16 entry's
// arguments: `tab`, int32 scratch of 2 x B x ceil(P/64) from the caller,
// into whose first B x ceil(P/64) int2 the query tiles' band table is
// written first, then read by the forward. Any P. Returns the first CUDA
// error (0 when the launches were accepted).
extern "C" int ggt_flash_fwd_band_f32(const void* q, const void* k, const void* v,
                                      const void* segq, const void* segk, void* out, void* lse,
                                      void* tab, int B, int P, int H, int causal, int bi_split,
                                      void* stream) {
  if (B == 0 || P == 0 || H == 0) return 0;
  int2* band = (int2*)tab;
  cudaError_t err = launch_band_table(segq, segk, band, B, P, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fwd_band_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((P + T - 1) / T, H, B);
  fwd_band_f32_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const int*)segq, (const int*)segk,
      band, (float*)out, (float*)lse, P, H, causal, bi_split);
  return (int)cudaGetLastError();
}
