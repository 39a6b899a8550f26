// The two passes of the WMMA flash backward over one 64-row tile, which the
// band backward #10 (flash_band.cu) runs both of in one CTA; the split and
// streamed pairs #4, #5, #7, #8 (flash_bwd_split.cu) and the fused backward
// #3 (flash_bwd.cu) have Hopper bodies of their own. As the owner of KEYS a
// CTA sums dk and dv over the visiting query tiles; as the owner of QUERIES
// it sums dq over the visiting key tiles. Each pass recomputes S and dP for
// a tile pair from q, k, v, do, lse and delta, visits the tiles of its own
// tile's band, and masks by segment (seg_q[row] == seg_k[col] > 0) and by
// the per-row bounds of flash_common.cuh (causal or bi-causal). Also the
// small kernel that the band backward launches first for delta =
// rowsum(do * out) - dlse (the Hopper bodies sum delta themselves).
#pragma once

#include "flash_common.cuh"

namespace {

struct __align__(128) Smem {
  bf16 a1[64 * LDH];  // own tile: k as key owner, q as query owner
  bf16 a2[64 * LDH];  // own tile: v, or do
  bf16 b1[64 * LDH];  // visiting tile: q, or k
  bf16 b2[64 * LDH];  // visiting tile: do, or v
  float s[WARPS][16 * LDS];      // per warp: S, then dP, then the epilogue
  bf16 p[WARPS][2][16 * LDH];    // per warp: P and dS in bf16
  int seg_o[64];                 // the visiting tile's segment ids
  float lse_o[64], delta_o[64];  // and, as key owner, its row statistics
};

// Zero the rows of a loaded [64, 64] tile whose token is padding (do of a
// padded row takes no part). Each thread revisits the 16 bytes that it wrote
// itself in load_tile, so no barrier is needed between the two.
__device__ __forceinline__ void zero_padded_rows(bf16* dst, const int* segb, int t0,
                                                 int P, int tid) {
#pragma unroll
  for (int it = 0; it < (64 * DH / 8) / THREADS; ++it) {
    const int i = tid + it * THREADS;
    const int row = i >> 3, d0 = (i & 7) * 8;
    const int gr = t0 + row;
    if (gr < P && segb[gr] == 0)
      *reinterpret_cast<uint4*>(dst + row * LDH + d0) = make_uint4(0, 0, 0, 0);
  }
}

// acc[16 x 64] = A[16 x 64] * B^T, A = rows of `a` (row-major), B = the 64
// rows of `bt` (row-major, so col-major as the right operand); to scratch.
__device__ __forceinline__ void rows_times_transposed(float* dst, const bf16* a,
                                                      const bf16* bt) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bf;
      wmma::load_matrix_sync(af, a + kk * 16, LDH);
      wmma::load_matrix_sync(bf, bt + j * 16 * LDH + kk * 16, LDH);
      wmma::mma_sync(acc, af, bf, acc);
    }
    wmma::store_matrix_sync(dst + j * 16, acc, LDS, wmma::mem_row_major);
  }
}

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> AccFrag;

// acc[16 x 64] += A[16 x 64] * B[64 x 64], A = bf16 rows in `a`, B = `b`.
__device__ __forceinline__ void accumulate(AccFrag* acc, const bf16* a, const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
    wmma::load_matrix_sync(af, a + kk * 16, LDH);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bf;
      wmma::load_matrix_sync(bf, b + kk * 16 * LDH + j * 16, LDH);
      wmma::mma_sync(acc[j], af, bf, acc[j]);
    }
  }
}

// Write one warp's fp32 [16 x 64] sum as bf16 rows of a token-major tensor.
// Each lane pair owns a row, each lane 32 of its columns.
__device__ __forceinline__ void write_rows(bf16* dst, long long rs, AccFrag* acc,
                                           float* sbuf, int row, int P, int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(sbuf + j * 16, acc[j], LDS, wmma::mem_row_major);
  __syncwarp();
  const int r = lane >> 1, c0 = (lane & 1) * 32;
  if (row < P) {
    uint4 pack[4];
    bf16* y = reinterpret_cast<bf16*>(pack);
#pragma unroll
    for (int c = 0; c < 32; ++c) y[c] = __float2bfloat16(sbuf[r * LDS + c0 + c]);
    uint4* out = reinterpret_cast<uint4*>(dst + row * rs + c0);
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = pack[i];
  }
  __syncwarp();
}

// One pass of the CTA over the visiting tiles of its own tile's band. KEYS:
// the own tile holds keys (sums dk, dv); else it holds queries (sums dq).
// segq, segk: one batch row's query and key segment ids; tabq holds each q
// tile's band of key positions and tabk each key tile's band of query
// positions (flash_band.cu). q and k come rotated.
template <bool KEYS>
__device__ __forceinline__ void pass(Smem& sm, const bf16* qb, const bf16* kb,
                                     const bf16* vb, const bf16* dob, const int* segq,
                                     const int* segk, const int2* tabq, const int2* tabk,
                                     const float* lseb, const float* deltab, long long rs,
                                     int t0, int P, int causal, int bi_split,
                                     AccFrag* acc1, AccFrag* acc2) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int* sego = KEYS ? segk : segq;  // the own tile's ids
  const int* segv = KEYS ? segq : segk;  // the visiting tiles' ids
  __syncthreads();  // the previous pass has read the own tiles
  if (KEYS) {
    load_tile(sm.a1, kb, rs, t0, P, nullptr, nullptr, tid);
    load_tile(sm.a2, vb, rs, t0, P, nullptr, nullptr, tid);
  } else {
    load_tile(sm.a1, qb, rs, t0, P, nullptr, nullptr, tid);
    load_tile(sm.a2, dob, rs, t0, P, nullptr, nullptr, tid);
    zero_padded_rows(sm.a2, segq, t0, P, tid);
  }
  // each lane pair owns one row of the own tile; each lane 32 columns
  const int r = lane >> 1, c0 = (lane & 1) * 32;
  const int orow = t0 + warp * 16 + r;
  const int so = orow < P ? sego[orow] : 0;
  // own keys: seen by the visiting rows [lim, P); own queries: see the
  // visiting columns [0, lim)
  const int lim = KEYS ? first_row(orow, causal, bi_split, P)
                       : visible_cols(orow, causal, bi_split, P);
  float lse_r = 0.f, delta_r = 0.f;
  if (!KEYS && orow < P) {
    lse_r = lseb[orow];
    delta_r = deltab[orow];
  }
  float* sbuf = sm.s[warp];
  bf16* pbuf = sm.p[warp][0];
  bf16* dsbuf = sm.p[warp][1];
  const bf16* own1 = sm.a1 + warp * 16 * LDH;
  const bf16* own2 = sm.a2 + warp * 16 * LDH;

  const int nt = (P + 63) / 64, ti = t0 / 64;
  // causal: a key tile meets the q tiles from its own on; a q tile meets
  // the key tiles up to its own (bi-causal: every tile, the mask decides)
  const bool tri = causal && bi_split == 0;
  int v_begin = (KEYS && tri) ? ti : 0;
  int v_end = (!KEYS && tri) ? ti + 1 : nt;
  // every pair with a matching id lies in the own tile's band (a query's
  // key, or a key's query, carries an id inside the own tile's range)
  const int2 band = (KEYS ? tabk : tabq)[ti];
  if (band.y < band.x) {
    v_end = v_begin;
  } else {
    v_begin = max(v_begin, band.x / 64);
    v_end = min(v_end, band.y / 64 + 1);
    if (!KEYS && bi_split > 0) {  // the forward's clip of a q tile's band
      const int last = min(t0 + 64, P) - 1;
      v_end = min(v_end, (last >= P - bi_split ? last : P - bi_split - 1) / 64 + 1);
    }
  }
  for (int vt = v_begin; vt < v_end; ++vt) {
    const int v0 = vt * 64;
    __syncthreads();  // the previous tile's readers are done
    if (KEYS) {
      load_tile(sm.b1, qb, rs, v0, P, nullptr, nullptr, tid);
      load_tile(sm.b2, dob, rs, v0, P, nullptr, nullptr, tid);
      zero_padded_rows(sm.b2, segq, v0, P, tid);
    } else {
      load_tile(sm.b1, kb, rs, v0, P, nullptr, nullptr, tid);
      load_tile(sm.b2, vb, rs, v0, P, nullptr, nullptr, tid);
    }
    if (tid < 64) {
      const bool in = v0 + tid < P;
      sm.seg_o[tid] = in ? segv[v0 + tid] : 0;
      if (KEYS) {
        sm.lse_o[tid] = in ? lseb[v0 + tid] : 0.f;
        sm.delta_o[tid] = in ? deltab[v0 + tid] : 0.f;
      }
    }
    __syncthreads();

    // S (or S^T) = own1 * visiting1^T, this warp's 16 rows
    rows_times_transposed(sbuf, own1, sm.b1);
    __syncwarp();
    float pr[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int vc = c0 + c;
      const int sv = sm.seg_o[vc];
      const int vrow = v0 + vc;
      const bool ok = (sv == so) && (sv > 0) && (KEYS ? vrow >= lim : vrow < lim);
      const float lse = KEYS ? sm.lse_o[vc] : lse_r;
      pr[c] = ok ? expf(sbuf[r * LDS + vc] - lse) : 0.f;
    }
    __syncwarp();  // S fully read before dP overwrites it
    // dP (or dP^T) = own2 * visiting2^T
    rows_times_transposed(sbuf, own2, sm.b2);
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int vc = c0 + c;
      const float delta = KEYS ? sm.delta_o[vc] : delta_r;
      const float ds = pr[c] * (sbuf[r * LDS + vc] - delta);
      if (KEYS) pbuf[r * LDH + vc] = __float2bfloat16(pr[c]);
      dsbuf[r * LDH + vc] = __float2bfloat16(ds);
    }
    __syncwarp();
    if (KEYS) {
      accumulate(acc1, dsbuf, sm.b1);  // dk += dS^T q
      accumulate(acc2, pbuf, sm.b2);   // dv += P^T do
    } else {
      accumulate(acc1, dsbuf, sm.b1);  // dq += dS k
    }
    __syncwarp();
  }
}

// The backward kernels need more than the 48 KB of static shared memory.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, bool* configured) {
  if (*configured) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Smem));
  if (err == cudaSuccess) *configured = true;
  return err;
}

// delta[b, h, p] = sum_d do * out - dlse, one warp per (token, head); a
// padded row gives -dlse. The band backward launches it before its main
// kernel.
__global__ void flash_bwd_delta_kernel(const bf16* __restrict__ dout,
                                       const bf16* __restrict__ out,
                                       const int* __restrict__ seg,
                                       const float* __restrict__ dlse,
                                       float* __restrict__ delta, int P, int H,
                                       long long rows) {
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const long long tok = row / H;
  const int h = (int)(row % H);
  const long long b = tok / P;
  const int p = (int)(tok % P);
  float acc = 0.f;
  if (seg[tok] > 0) {
    const __nv_bfloat162 d2 =
        *reinterpret_cast<const __nv_bfloat162*>(dout + row * DH + 2 * lane);
    const __nv_bfloat162 o2 =
        *reinterpret_cast<const __nv_bfloat162*>(out + row * DH + 2 * lane);
    acc = __bfloat162float(d2.x) * __bfloat162float(o2.x) +
          __bfloat162float(d2.y) * __bfloat162float(o2.y);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) {
    const long long idx = (b * H + h) * P + p;
    delta[idx] = acc - (dlse != nullptr ? dlse[idx] : 0.f);
  }
}

// The delta kernel on `stream`; dlse may be null (zeros).
inline cudaError_t launch_delta(const void* dout, const void* out, const void* seg,
                                const void* dlse, void* delta, int B, int P, int H,
                                cudaStream_t st) {
  const long long rows = (long long)B * P * H;
  const int wpb = 8;  // warps per block
  flash_bwd_delta_kernel<<<(unsigned)((rows + wpb - 1) / wpb), wpb * 32, 0, st>>>(
      (const bf16*)dout, (const bf16*)out, (const int*)seg, (const float*)dlse,
      (float*)delta, P, H, rows);
  return cudaGetLastError();
}

}  // namespace
