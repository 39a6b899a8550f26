// The flash forward over one 64-row query tile, shared by the streamed
// forward (flash_stream.cu, kernel #6) and the band forward (flash_band.cu,
// kernel #9); the single-block forward #1 (flash_fwd.cu) instantiated it
// without either switch until it took a Hopper body of its own. STREAM selects
// what the streamed kernel adds: the keys' segment ids come from their own
// array (seg_k, a ring chunk's visiting keys) and each tile's segment-id
// range from a table written once by a pre-pass, instead of from the ids,
// which every CTA would otherwise re-read for every key tile of a long row.
// BAND (with STREAM) replaces the per-tile test by the q tile's band: tabq
// holds, per q tile, the first and last key positions whose id lies in the
// tile's [min positive id, max id] (band_table_kernel), and the loop visits
// exactly the key tiles between them. Without either, seg_k is seg_q and the
// tables are unused.
#pragma once

#include "flash_common.cuh"

namespace {

struct __align__(128) FwdSmem {
  bf16 q[BQ * LDH];
  bf16 k[BK * LDH];
  bf16 v[BK * LDH];
  float s[WARPS][16 * LDS];  // per warp: S tile, then P (bf16), then PV
  int segk[BK];
};

// One CTA of 4 warps per (64-row q tile, head, batch row); a loop over the
// 64-key tiles with an online softmax (fp32 running max and sum, one row per
// lane pair). A key tile whose segment-id range misses the q tile's is
// skipped before it is loaded. A query row whose segment is 0, or which sees
// no key, gives out = 0 and lse = -1e30.
//
// At least four CTAs an SM: without the bound nvcc gave the single-block
// instance 168 registers a thread, which left three CTAs an SM and made it
// slower on the H100 at every shape; with it, 128 and no spills
// (chip_smoke.py prints the counts).
template <bool STREAM, bool BAND = false>
__global__ void __launch_bounds__(THREADS, 4)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ segq,
                 const int* __restrict__ segk, const int2* __restrict__ tabq,
                 const int2* __restrict__ tabk, const bf16* __restrict__ cosb,
                 const bf16* __restrict__ sinb, bf16* __restrict__ out,
                 float* __restrict__ lse, int P, int H, int causal, int bi_split) {
  __shared__ FwdSmem sm;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nkt = (P + BK - 1) / BK;
  const long long rs = (long long)H * DH;
  const long long base = (long long)b * P * rs + h * DH;
  const bf16* qb = q + base;
  const bf16* kb = k + base;
  const bf16* vb = v + base;
  const int* segqb = segq + (long long)b * P;
  const int* segkb = STREAM ? segk + (long long)b * P : segqb;
  const int2* tabqb = STREAM ? tabq + (long long)b * nkt : nullptr;
  const int2* tabkb = (STREAM && !BAND) ? tabk + (long long)b * nkt : nullptr;
  const bf16* cb = cosb ? cosb + (long long)b * P * DH : nullptr;
  const bf16* sb = sinb ? sinb + (long long)b * P * DH : nullptr;

  int qmin = 0, qmax = 0;
  if constexpr (!BAND) tile_bounds<STREAM>(tabqb, segqb, q0, P, lane, &qmin, &qmax);
  load_tile(sm.q, qb, rs, q0, P, cb, sb, tid);
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[DH / 16];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], sm.q + warp * 16 * LDH + kk * 16, LDH);

  // each lane pair owns one query row; each lane half of its 64 columns
  const int r = lane >> 1, c0 = (lane & 1) * 32;
  const int qrow = q0 + warp * 16 + r;
  const int sq = qrow < P ? segqb[qrow] : 0;
  const int lim = visible_cols(qrow, causal, bi_split, P);  // this row sees [0, lim)
  float m = NEG, l = 0.f, o[32];
#pragma unroll
  for (int c = 0; c < 32; ++c) o[c] = 0.f;
  float* sbuf = sm.s[warp];
  bf16* pbuf = reinterpret_cast<bf16*>(sbuf);

  int kt_begin = 0;
  int kt_end = (causal && bi_split == 0) ? min(nkt, (min(q0 + BQ, P) - 1) / BK + 1) : nkt;
  if constexpr (BAND) {
    // the band's key tiles, its top clipped as the JAX kernel clips it
    // (:293-303): a q tile without a causal row sees only the prefix
    const int2 band = tabqb[blockIdx.x];
    const int last = min(q0 + BQ, P) - 1;
    if (band.y < band.x) {
      kt_end = 0;  // a tile of padding, or no key of its ids
    } else {
      kt_begin = band.x / BK;
      int top = band.y / BK;
      if (bi_split > 0) top = min(top, (last >= P - bi_split ? last : P - bi_split - 1) / BK);
      kt_end = min(kt_end, top + 1);
    }
  }
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    if constexpr (!BAND) {
      int kmin, kmax;
      tile_bounds<STREAM>(tabkb, segkb, k0, P, lane, &kmin, &kmax);
      if (ranges_miss(qmin, qmax, kmin, kmax)) continue;
    }
    __syncthreads();  // the previous tile's readers are done
    load_tile(sm.k, kb, rs, k0, P, cb, sb, tid);
    load_tile(sm.v, vb, rs, k0, P, nullptr, nullptr, tid);
    if (tid < BK) sm.segk[tid] = (k0 + tid < P) ? segkb[k0 + tid] : 0;
    __syncthreads();

    // S = rot(q) rot(k)^T for this warp's 16 rows
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, sm.k + j * 16 * LDH + kk * 16, LDH);
        wmma::mma_sync(acc, qf[kk], kf, acc);
      }
      wmma::store_matrix_sync(sbuf + j * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    float s[32];
    float mx = NEG;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int kc = c0 + c;
      const int sk = sm.segk[kc];
      const bool ok = (sk == sq) && (sk > 0) && (k0 + kc < lim);
      s[c] = sbuf[r * LDS + kc] + (ok ? 0.f : NEG);
      mx = fmaxf(mx, s[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float mnew = fmaxf(m, mx);
    const float alpha = expf(m - mnew);
    __syncwarp();  // S fully read before P overwrites it
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float p = expf(s[c] - mnew);
      psum += p;
      pbuf[r * LDH + c0 + c] = __float2bfloat16(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = mnew;
#pragma unroll
    for (int c = 0; c < 32; ++c) o[c] *= alpha;
    __syncwarp();

    // O += P V
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf[BK / 16];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wmma::load_matrix_sync(pf[kk], pbuf + kk * 16, LDH);
    __syncwarp();  // P is in registers before PV overwrites the scratch
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(vf, sm.v + kk * 16 * LDH + j * 16, LDH);
        wmma::mma_sync(acc, pf[kk], vf, acc);
      }
      wmma::store_matrix_sync(sbuf + j * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 32; ++c) o[c] += sbuf[r * LDS + c0 + c];
  }

  if (qrow < P) {
    // a masked logit sits at -1e30, so m stays there on a row that saw no key
    const bool valid = sq > 0 && m > NEG;
    uint4 pack[4];
    bf16* y = reinterpret_cast<bf16*>(pack);
#pragma unroll
    for (int c = 0; c < 32; ++c) y[c] = __float2bfloat16(valid ? o[c] / l : 0.f);
    uint4* dst = reinterpret_cast<uint4*>(out + base + qrow * rs + c0);
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[i] = pack[i];
    if ((lane & 1) == 0)
      lse[((long long)b * H + h) * P + qrow] = (m <= NEG) ? NEG : m + logf(l);
  }
}

}  // namespace
