// RMSNorm-fused q/k/v projections, for Hopper: kernel #12 norm_qkv.
//
// Replaces graphgpt_tpu/ops/mlp.py:315 _norm_qkv_kernel (launched by
// _norm_qkv_call :328 from fused_norm_qkv :363 under GGT_ATTN_NORM_FUSE=1):
//   hpre = bf16(x * rrms(x) * wn),  q = bf16(hpre @ Wq^T),  k = bf16(hpre @ Wk^T),
//   v = bf16(hpre @ Wv^T)
// with the TPU kernel's rounding points: RMS statistics in fp32, hpre
// rounded to bf16, each product summed in fp32 and rounded once. x bf16
// [N, D], wn fp32 [D], the weights bf16 in nn.Linear layout ([out, in],
// row-major) with any widths that are multiples of 64 (GQA's k and v are
// narrower than q); q, k, v bf16 [N, width].
//
// What bounds it on the H100: operations. At N 65,536, D 768 and widths
// 3 x 768 the products are 2 x 65,536 x 768 x 2,304 = 231.9 GFLOP, 0.2345 ms
// at 989 TFLOP/s, against 406.5 MB of x, weights and outputs (0.121 ms at
// 3.35 TB/s).
//
// Design: one CTA of 4 warps per (64-row tile, group of 12 column tiles of
// 64). It computes its rows' RMS statistics (mlp_common.cuh's tile_rrms, as
// norm_mlp's first stage does), normalises the whole [64, D] row tile into
// shared memory in bf16 once, then for each of its column tiles streams the
// weight rows through shared memory in chunks of 64 and sums the product in
// WMMA bf16 fragments (fp32 accumulation, each warp 32 x 32), rounding to
// bf16 in the epilogue. hpre never reaches device memory. The column groups
// of one row tile are neighbours in the launch order, so x is read from
// device memory about once and from L2 after. Single-buffered, 16-byte
// loads: wgmma, TMA and a pipelined weight ring are later work.

#include "mlp_common.cuh"

namespace gated_mlp {
namespace {

constexpr int KC = 64;        // depth of a staged weight chunk
constexpr int LDW = KC + 8;   // its bf16 row stride in shared memory
constexpr int TILES = 12;     // column tiles a CTA
constexpr int MAX_D = 1600;   // the widest hidden size of config._MODEL_SIZES

inline size_t smem_bytes(int D) {
  return (size_t)BM * (D + 8) * sizeof(bf16) + (size_t)BN * LDW * sizeof(bf16) +
         4 * 256 * sizeof(float) + BM * sizeof(float);
}

__global__ void __launch_bounds__(THREADS)
norm_qkv_kernel(const bf16* __restrict__ x, const float* __restrict__ wn,
                const bf16* __restrict__ wq, const bf16* __restrict__ wk,
                const bf16* __restrict__ wv, bf16* __restrict__ q, bf16* __restrict__ k,
                bf16* __restrict__ v, int N, int D, int Fq, int Fk, int Fv, float eps) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ldh = D + 8;
  bf16* hn = reinterpret_cast<bf16*>(smem_raw);  // [64, D] normalised rows
  bf16* sw = hn + BM * ldh;                       // [64, KC] weight chunk
  float* scratch = reinterpret_cast<float*>(sw + BN * LDW);  // [4][256] epilogue
  float* rrms = scratch + 4 * 256;
  const int m0 = blockIdx.y * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn_ = warp & 1;

  tile_rrms(x, rrms, m0, N, D, eps, warp, lane);
  __syncthreads();
  const int chunks = D / 8;  // 16-byte chunks a row
  for (int i = tid; i < BM * chunks; i += THREADS) {
    const int row = i / chunks, c = (i - row * chunks) * 8;
    const int gr = m0 + row;
    uint4 outv = make_uint4(0, 0, 0, 0);
    if (gr < N) {
      uint4 val = *reinterpret_cast<const uint4*>(x + (long long)gr * D + c);
      const bf16* e = reinterpret_cast<const bf16*>(&val);
      bf16* y = reinterpret_cast<bf16*>(&outv);
      const float rr = rrms[row];
#pragma unroll
      for (int t = 0; t < 8; ++t) y[t] = __float2bfloat16(__bfloat162float(e[t]) * rr * wn[c + t]);
    }
    *reinterpret_cast<uint4*>(hn + row * ldh + c) = outv;
  }
  __syncthreads();

  const int nq = Fq / BN, nk = Fk / BN, nv = Fv / BN;
  const int ct_end = min(nq + nk + nv, (int)(blockIdx.x + 1) * TILES);
  const int er = lane >> 1, ec = (lane & 1) * 8;
  for (int ct = blockIdx.x * TILES; ct < ct_end; ++ct) {
    const bf16* w;
    bf16* o;
    int F, n0;
    if (ct < nq) {
      w = wq, o = q, F = Fq, n0 = ct * BN;
    } else if (ct < nq + nk) {
      w = wk, o = k, F = Fk, n0 = (ct - nq) * BN;
    } else {
      w = wv, o = v, F = Fv, n0 = (ct - nq - nk) * BN;
    }
    Acc acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    for (int k0 = 0; k0 < D; k0 += KC) {
#pragma unroll
      for (int it = 0; it < (BN * KC / 8) / THREADS; ++it) {
        const int i = tid + it * THREADS;
        const int row = i >> 3, c = (i & 7) * 8;
        *reinterpret_cast<uint4*>(sw + row * LDW + c) =
            *reinterpret_cast<const uint4*>(w + (long long)(n0 + row) * D + k0 + c);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        FragA a[2];
        FragB bw[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], hn + (wm * 32 + i * 16) * ldh + k0 + kk * 16, ldh);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(bw[j], sw + (wn_ * 32 + j * 16) * LDW + kk * 16, LDW);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], bw[j], acc[i][j]);
      }
      __syncthreads();
    }
    // epilogue: each 16 x 16 fragment through the warp's scratch, 8 columns a lane
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float* sc = scratch + warp * 256;
        wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        const int gr = m0 + wm * 32 + i * 16 + er;
        const int gc = n0 + wn_ * 32 + j * 16 + ec;
        if (gr < N) {
          uint4 outv;
          bf16* y = reinterpret_cast<bf16*>(&outv);
#pragma unroll
          for (int t = 0; t < 8; ++t) y[t] = __float2bfloat16(sc[er * 16 + ec + t]);
          *reinterpret_cast<uint4*>(o + (long long)gr * F + gc) = outv;
        }
        __syncwarp();
      }
  }
}

}  // namespace
}  // namespace gated_mlp

// C entry for ctypes: one launch on `stream`; returns the first CUDA error
// (0 when the launch was accepted). D and the widths are multiples of 64,
// D at most 1600.
extern "C" int ggt_norm_qkv(const void* x, const void* wn, const void* wq, const void* wk,
                            const void* wv, void* q, void* k, void* v, int N, int D, int Fq,
                            int Fk, int Fv, float eps, void* stream) {
  using namespace gated_mlp;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        norm_qkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes(MAX_D));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int tiles = (Fq + Fk + Fv) / BN;
  dim3 grid((tiles + TILES - 1) / TILES, (N + BM - 1) / BM);
  norm_qkv_kernel<<<grid, THREADS, smem_bytes(D), (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)wn, (const bf16*)wq, (const bf16*)wk, (const bf16*)wv,
      (bf16*)q, (bf16*)k, (bf16*)v, N, D, Fq, Fk, Fv, eps);
  return (int)cudaGetLastError();
}
