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
// Design: one CTA of 4 warps per (64-row q tile, head, batch row); a loop
// over 64-key tiles with an online softmax (fp32 running max and sum, one
// row per lane pair). A key tile whose segment-id range misses the q tile's
// is skipped before it is loaded, which on packed rows leaves one or two of
// the sixteen tiles at P=1024: the kernel reads little more than q, k, v
// once. Products go through WMMA bf16 tensor-core tiles with fp32
// accumulation; the probabilities are rounded to bf16 for the PV product as
// in the TPU kernel. Loads are 16 bytes a thread, single-buffered: the
// rewrite onto TMA and wgmma with pipelined tiles is later work.

#include "flash_common.cuh"

namespace {

constexpr int LDS = BK + 4;  // fp32 row stride of the per-warp scratch

struct __align__(128) Smem {
  bf16 q[BQ * LDH];
  bf16 k[BK * LDH];
  bf16 v[BK * LDH];
  float s[WARPS][16 * LDS];  // per warp: S tile, then P (bf16), then PV
  int segk[BK];
};

// At least four CTAs an SM: without the bound nvcc gives this kernel 168
// registers a thread, which leaves three CTAs an SM and made it slower on
// the H100 at every shape; with it, 128 and no spills (chip_smoke.py prints
// the counts).
__global__ void __launch_bounds__(THREADS, 4)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ seg,
                 const bf16* __restrict__ cosb, const bf16* __restrict__ sinb,
                 bf16* __restrict__ out, float* __restrict__ lse, int P, int H,
                 int causal, int bi_split) {
  __shared__ Smem sm;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long rs = (long long)H * DH;
  const long long base = (long long)b * P * rs + h * DH;
  const bf16* qb = q + base;
  const bf16* kb = k + base;
  const bf16* vb = v + base;
  const int* segb = seg + (long long)b * P;
  const bf16* cb = cosb ? cosb + (long long)b * P * DH : nullptr;
  const bf16* sb = sinb ? sinb + (long long)b * P * DH : nullptr;

  int qmin, qmax;
  tile_range(segb, q0, P, lane, &qmin, &qmax);
  load_tile(sm.q, qb, rs, q0, P, cb, sb, tid);
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[DH / 16];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], sm.q + warp * 16 * LDH + kk * 16, LDH);

  // each lane pair owns one query row; each lane half of its 64 columns
  const int r = lane >> 1, c0 = (lane & 1) * 32;
  const int qrow = q0 + warp * 16 + r;
  const int sq = qrow < P ? segb[qrow] : 0;
  const int lim = visible_cols(qrow, causal, bi_split, P);  // this row sees [0, lim)
  float m = NEG, l = 0.f, o[32];
#pragma unroll
  for (int c = 0; c < 32; ++c) o[c] = 0.f;
  float* sbuf = sm.s[warp];
  bf16* pbuf = reinterpret_cast<bf16*>(sbuf);

  const int nkt = (P + BK - 1) / BK;
  const int kt_end =
      (causal && bi_split == 0) ? min(nkt, (min(q0 + BQ, P) - 1) / BK + 1) : nkt;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    int kmin, kmax;
    tile_range(segb, k0, P, lane, &kmin, &kmax);
    // no segment id in common: every logit of the tile pair is masked
    if (qmax <= 0 || kmax <= 0 || qmin > kmax || kmin > qmax) continue;
    __syncthreads();  // the previous tile's readers are done
    load_tile(sm.k, kb, rs, k0, P, cb, sb, tid);
    load_tile(sm.v, vb, rs, k0, P, nullptr, nullptr, tid);
    if (tid < BK) sm.segk[tid] = (k0 + tid < P) ? segb[k0 + tid] : 0;
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
    const bool valid = sq > 0;
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

// C entry for ctypes: returns cudaGetLastError() after the launch.
extern "C" int ggt_flash_fwd(const void* q, const void* k, const void* v,
                             const void* seg, const void* cos, const void* sin,
                             void* out, void* lse, int B, int P, int H, int causal,
                             int bi_split, void* stream) {
  dim3 grid((P + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)seg,
      (const bf16*)cos, (const bf16*)sin, (bf16*)out, (float*)lse, P, H, causal,
      bi_split);
  return (int)cudaGetLastError();
}
