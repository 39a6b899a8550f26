// The two stages of the gated MLP for Hopper, shared by norm_mlp.cu (#2)
// and mlp.cu (#11):
//
//   gate/up (gate_up_kernel): g = bf16(bf16(act(bf16(xg))) * bf16(xu)),
//     xg = a @ Wg^T, xu = a @ Wu^T, where a = x, or a = bf16((x * rrms) * wn)
//     when NORM (rrms from the pre-pass of gemm_sm90.cuh, in fp32);
//   down (down_kernel): out = bf16(g @ Wd^T), or bf16(x + g @ Wd^T) with x
//     added in fp32 before the one rounding when RESIDUAL.
//
// What bounds them on the H100: operations. At N 65,536, D 768 and F 3,072
// the three products are 927.7 GFLOP, 0.938 ms at 989 TFLOP/s, against
// 215 MB of x, weights and out (0.064 ms at 3.35 TB/s); g's round trip
// through device memory (805 MB) is not in that bound, and the ring hides
// it behind the products.
//
// Design. Both stages are persistent kernels, one CTA an SM, walking output
// tiles of 128 rows with the column index fastest, so that the CTAs in
// flight share a row tile of their A and all of the weights in L2. A CTA is
// three warpgroups, the machinery of #12 (norm_qkv.cu):
//  - one producer thread keeps a ring of 128-byte swizzled stages full with
//    TMA (full and empty mbarriers; rows past N arrive as zeros). A gate/up
//    stage is the x tile [128, 64] and the boxes [BH, 64] of Wg and of Wu at
//    the same row, stacked into one B tile [2 BH, 64]; a down stage is the
//    g tile [128, 64] and the Wd tile [BN, 64] (Wd is [D, F], K-major);
//  - two consumer warpgroups of 64 rows each issue one wgmma m64n(2 BH)k16
//    (gate/up) or m64nBNk16 (down) a k-step. With NORM, A is read from the
//    stage into registers (ldmatrix) and normalised there, as #12 does, one
//    commit group a stage, waited for before the next stage's A is loaded;
//    otherwise A comes from the stage by descriptor and one group stays in
//    flight while the next stage's products are issued;
//  - gate column c lies in n8-group c / 8 of the accumulator and up column c
//    in group c / 8 + BH / 8, in the same thread at the same offset: act x up
//    needs no exchange between threads. The epilogue rounds xg and xu, runs
//    the activation (no wgmma in flight), rounds a, multiplies, rounds g and
//    stages the [64, BH] bf16 tile of each warpgroup as 64-wide swizzled
//    boxes for a TMA store (rows past N are not written);
//  - RESIDUAL: at the start of each tile a consumer thread loads the x tile
//    by TMA into the warpgroup's output staging boxes; the epilogue adds
//    each fp32 sum to the x value at its place, rounds once in place, and
//    the tile is stored by TMA.
// setmaxnreg gives the consumers 232 registers (128 fp32 sums a thread at
// n256) and the producer 40. The consumers spin on their barriers with no
// clock; the producer waits with a timeout and last for the whole ring, so
// a hang traps the launch. The tile widths BH (128 or 64) and BN (256, 192,
// 128 or 64) are chosen on the host (ops/mlp.py mlp_tiles). No split-K and
// no atomics: two launches on the same inputs give the same bits. Measured
// and not kept (PERF.md §6): wn read from global memory for a fourth
// gate/up stage with the norm (slower); the gate/up epilogue on bf16x2
// pairs, a * xu by mul.rn.bf16x2 (faster, but ptxas spilled the gelu
// instances).
// Activations: exact gelu through erff (not the TPU kernels'
// Abramowitz-Stegun erf), tanh gelu, silu. Weights bf16 in nn.Linear
// layout ([out, in]); x, g and out bf16 row-major; wn fp32. D and F
// multiples of 64.

#pragma once

#include <cuda_bf16.h>

#include "gemm_sm90.cuh"  // wgmma, the register-A norm, the rrms pre-pass, tensor maps

namespace gated_mlp {
namespace {

using namespace sm90;
using namespace gemm90;

constexpr int BM = 128;           // rows of an output tile: two consumer warpgroups of 64
constexpr int THREADS = 384;      // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int SMEM_MAX = 232448;  // shared memory a block can have on the H100
constexpr int MAX_D = 8192;       // wn's row in shared memory beside the stages (NORM)

enum Act { GELU = 0, GELU_TANH = 1, SILU = 2 };

template <int ACT>
__device__ __forceinline__ float act_f32(float x) {
  if (ACT == GELU) return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
  if (ACT == GELU_TANH)
    return 0.5f * x * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
  return x / (1.f + expf(-x));
}

// Shared memory of a stage kernel: 1024 bytes of slack to align what follows
// for the 128-byte swizzle; the ring; the output tile staged for its TMA
// store ([128, width] bf16 as width / 64 swizzled boxes of [64, 64] a
// warpgroup); wn (gate/up with NORM); the barriers.
template <int B_ROWS, int OUT_W, int WN_BYTES>
struct Ring {
  static constexpr int A_BYTES = BM * KC * 2;  // 16 KB
  static constexpr int B_BYTES = B_ROWS * KC * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int OUT_BYTES = BM * OUT_W * 2;
  static constexpr int FIT = (SMEM_MAX - 1024 - OUT_BYTES - WN_BYTES - 256) / STAGE;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int NACC = B_ROWS / 2;  // fp32 sums a thread: [64, B rows] over 128 threads
};
// gate/up: B is [2 BH, 64] (Wg over Wu), the output g [128, BH]
template <int BH, bool NORM>
using GateUp = Ring<2 * BH, BH, NORM ? MAX_D * 4 : 0>;
// down: B is Wd [BN, 64], the output [128, BN]
template <int BN>
using Down = Ring<BN, BN, 0>;

template <typename T>
inline size_t smem_bytes(int wn_floats) {
  return 1024 + (size_t)T::STAGES * T::STAGE + T::OUT_BYTES + (size_t)wn_floats * sizeof(float) +
         (2 * T::STAGES + 2) * sizeof(uint64_t);
}

// The producer thread: for each tile of this CTA (row tile rt, column tile
// ct of cts), kt stages, each the A box [128, 64] at (k, 128 rt) and NB
// B boxes of b_rows rows at (k, b_rows ct) stacked; then it waits
// for the consumers to hand back every stage.
template <typename T, int NB>
__device__ __forceinline__ void produce(const CUtensorMap* ta, const CUtensorMap* const (&tb)[NB],
                                        int b_rows, int tiles, int cts, int kt, uint32_t sm_ring,
                                        uint32_t sm_bars) {
  int stage = 0;
  uint32_t phase = 0;
  auto next = [&] {
    if (++stage == T::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  };
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int rt = t / cts, ct = t - rt * cts;
    for (int kc = 0; kc < kt; ++kc) {
      mbar_wait_or_trap(sm_bars + 8 * (T::STAGES + stage), phase ^ 1);
      const uint32_t bar = sm_bars + 8 * stage;
      mbar_expect_tx(bar, T::STAGE);
      const uint32_t dst = sm_ring + stage * T::STAGE;
      tma_load(dst, ta, bar, kc * KC, rt * BM);
#pragma unroll
      for (int b = 0; b < NB; ++b)
        tma_load(dst + T::A_BYTES + b * b_rows * KC * 2, tb[b], bar, kc * KC, ct * b_rows);
      next();
    }
  }
  for (int s = 0; s < T::STAGES; ++s, next())
    mbar_wait_or_trap(sm_bars + 8 * (T::STAGES + stage), phase ^ 1);
}

// A consumer warpgroup's products over one tile with A from the stage by
// descriptor (this warpgroup's 64 rows of it): one commit group a stage,
// the previous stage handed back once its group has retired, so that one
// group stays in flight while the next is issued.
template <typename T, int N>
__device__ __forceinline__ void products_ss(float* acc, int kt, int wg, int lane, int& stage,
                                            uint32_t& phase, uint32_t sm_ring, uint32_t sm_bars) {
  int prev = -1;
  for (int kc = 0; kc < kt; ++kc) {
    mbar_wait(sm_bars + 8 * stage, phase);
    const uint32_t st = sm_ring + stage * T::STAGE;
    const uint64_t da = desc_sw128(st + wg * 64 * 128), db = desc_sw128(st + T::A_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss<N>(acc, da + 2 * kk, db + 2 * kk, kc + kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    if (prev >= 0 && lane == 0) mbar_arrive(sm_bars + 8 * (T::STAGES + prev));
    prev = stage;
    if (++stage == T::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  if (lane == 0) mbar_arrive(sm_bars + 8 * (T::STAGES + prev));
}

// The address in a warpgroup's staging boxes (from box0) of row g of this
// warp's 16 with its chunk bits holding g: fragment j (columns 8j + 2 tq4,
// +1) lies at (rowg ^ ((j % 8) << 4)) + (j / 8) * 8192, row g + 8 1024 on,
// as the 128-byte swizzle puts them.
__device__ __forceinline__ uint32_t stage_row(uint32_t box0, int warp, int g, int tq4) {
  return (box0 + ((warp & 3) * 16 + g) * 128 + tq4 * 4) ^ (g << 4);
}
__device__ __forceinline__ uint32_t stage_at(uint32_t rowg, int j) {
  return (rowg ^ ((j & 7) << 4)) + (j / 8) * 8192;
}

__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ uint32_t bf2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float bround(float x) { return __bfloat162float(__float2bfloat16(x)); }

// g = bf16(bf16(act(bf16(xg))) * bf16(xu)) of two sums
template <int ACT>
__device__ __forceinline__ float gated(float sg, float su) {
  return bround(act_f32<ACT>(bround(sg))) * bround(su);
}

template <int BH, int ACT, bool NORM>
__global__ void __launch_bounds__(THREADS, 1)
gate_up_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tg,
               const __grid_constant__ CUtensorMap tu, const __grid_constant__ CUtensorMap og,
               const float* __restrict__ wn, const float* __restrict__ rrms, int N, int D,
               int F) {
  using T = GateUp<BH, NORM>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  uint8_t* out_s = ring + T::STAGES * T::STAGE;
  float* wn_s = reinterpret_cast<float*>(out_s + T::OUT_BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(wn_s + (NORM ? D : 0));  // full, empty
  const uint32_t sm_ring = saddr(ring), sm_bars = saddr(bars);
  const int tid = threadIdx.x;
  if constexpr (NORM)
    for (int i = tid; i < D; i += THREADS) wn_s[i] = wn[i];
  if (tid == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(sm_bars + 8 * s, 1);                // the producer's arrive and the bytes
      mbar_init(sm_bars + 8 * (T::STAGES + s), 8);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int cts = F / BH;
  const int tiles = ((N + BM - 1) / BM) * cts;
  const int kt = D / KC;
  if (tid >= 256) {
    // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      const CUtensorMap* const tb[2] = {&tg, &tu};
      produce<T, 2>(&tx, tb, BH, tiles, cts, kt, sm_ring, sm_bars);
    }
    return;
  }
  // consumer warpgroups: rows [64 wg, 64 wg + 64) of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  const int g = lane >> 2, tq4 = lane & 3;
  const uint32_t aoff = (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * 128 +
                        (((lane >> 4) ^ (lane & 7)) << 4);
  const uint32_t box0 = saddr(out_s) + wg * (BH / 64) * 8192;
  const uint32_t rowg = stage_row(box0, warp, g, tq4);
  float acc[T::NACC];
#pragma unroll
  for (int i = 0; i < T::NACC; ++i) acc[i] = 0.f;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int rt = t / cts, ct = t - rt * cts;
    if constexpr (NORM) {
      // #12's k-loop: the stage's x into registers, then each k-step's norm
      // and its wgmma (k-step kk's registers are written while the wgmma of
      // the steps before it run, which read only their own); one commit
      // group a stage, waited for before the next stage's x is loaded
      const int row0 = rt * BM + warp * 16 + g;  // this thread's rows: row0, row0 + 8
      const float rr0 = row0 < N ? rrms[row0] : 0.f;
      const float rr1 = row0 + 8 < N ? rrms[row0 + 8] : 0.f;
      uint32_t a[4][4];
      for (int kc = 0; kc < kt; ++kc) {
        mbar_wait(sm_bars + 8 * stage, phase);
        const int cur = stage;
        const uint32_t xs = sm_ring + cur * T::STAGE;
        const float* wk = wn_s + kc * KC + 2 * tq4;
        const uint64_t desc = desc_sw128(xs + T::A_BYTES);
        load_x(a, xs, aoff);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          norm_a(a[kk], kk, wk, rr0, rr1);
          wgmma_fence();
          wgmma_rs<2 * BH>(acc, a[kk], desc + 2 * kk, kc + kk > 0);
        }
        wgmma_commit();
        if (++stage == T::STAGES) {
          stage = 0;
          phase ^= 1;
        }
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(sm_bars + 8 * (T::STAGES + cur));
      }
    } else {
      products_ss<T, 2 * BH>(acc, kt, wg, lane, stage, phase, sm_ring, sm_bars);
    }
#pragma unroll
    for (int i = 0; i < T::NACC; ++i) pin(acc[i]);
    if (rt * BM + wg * 64 >= N) continue;  // this warpgroup's rows are all past N
    // epilogue: act x up of fragment j (gate group j, up group j + BH / 8),
    // rounded at the plain version's points, into the staging boxes; the
    // boxes are written again only once the last tile's stores have read them
    if ((tid & 127) == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    bar_sync(1 + wg, 128);
#pragma unroll
    for (int j = 0; j < BH / 8; ++j) {
      const int u = 4 * (j + BH / 8);
      const uint32_t at = stage_at(rowg, j);
      sts32(at, bf2(gated<ACT>(acc[4 * j], acc[u]), gated<ACT>(acc[4 * j + 1], acc[u + 1])));
      sts32(at + 1024,
            bf2(gated<ACT>(acc[4 * j + 2], acc[u + 2]), gated<ACT>(acc[4 * j + 3], acc[u + 3])));
    }
    fence_proxy_async();
    bar_sync(1 + wg, 128);
    if ((tid & 127) == 0) {
#pragma unroll
      for (int b = 0; b < BH / 64; ++b)
        tma_store(&og, box0 + b * 8192, ct * BH + 64 * b, rt * BM + wg * 64);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if ((tid & 127) == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int BN, bool RESIDUAL>
__global__ void __launch_bounds__(THREADS, 1)
down_kernel(const __grid_constant__ CUtensorMap tga, const __grid_constant__ CUtensorMap twd,
            const __grid_constant__ CUtensorMap tres, const __grid_constant__ CUtensorMap tout,
            int N, int D, int F) {
  using T = Down<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  uint8_t* out_s = ring + T::STAGES * T::STAGE;
  // full[STAGES], empty[STAGES], each consumer warpgroup's residual tile
  uint64_t* bars = reinterpret_cast<uint64_t*>(out_s + T::OUT_BYTES);
  const uint32_t sm_ring = saddr(ring), sm_bars = saddr(bars);
  const uint32_t res_bar0 = sm_bars + 8 * 2 * T::STAGES;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(sm_bars + 8 * s, 1);
      mbar_init(sm_bars + 8 * (T::STAGES + s), 8);
    }
    mbar_init(res_bar0, 1);
    mbar_init(res_bar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int cts = D / BN;
  const int tiles = ((N + BM - 1) / BM) * cts;
  const int kt = F / KC;
  if (tid >= 256) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      const CUtensorMap* const tb[1] = {&twd};
      produce<T, 1>(&tga, tb, BN, tiles, cts, kt, sm_ring, sm_bars);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  const int g = lane >> 2, tq4 = lane & 3;
  const uint32_t box0 = saddr(out_s) + wg * (BN / 64) * 8192;
  const uint32_t rowg = stage_row(box0, warp, g, tq4);
  const uint32_t res_bar = res_bar0 + 8 * wg;
  uint32_t res_phase = 0;
  float acc[T::NACC];
#pragma unroll
  for (int i = 0; i < T::NACC; ++i) acc[i] = 0.f;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int rt = t / cts, ct = t - rt * cts;
    const bool live = rt * BM + wg * 64 < N;  // this warpgroup has rows to store
    if (RESIDUAL && live && (tid & 127) == 0) {
      // the x tile into the staging boxes once the last tile's stores have
      // read them; it lands while the products run
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      mbar_expect_tx(res_bar, (BN / 64) * 8192);
#pragma unroll
      for (int b = 0; b < BN / 64; ++b)
        tma_load(box0 + b * 8192, &tres, res_bar, ct * BN + 64 * b, rt * BM + wg * 64);
    }
    products_ss<T, BN>(acc, kt, wg, lane, stage, phase, sm_ring, sm_bars);
#pragma unroll
    for (int i = 0; i < T::NACC; ++i) pin(acc[i]);
    if (!live) continue;
    if constexpr (RESIDUAL) {
      mbar_wait(res_bar, res_phase);
      res_phase ^= 1;
    } else {
      if ((tid & 127) == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      bar_sync(1 + wg, 128);
    }
    // epilogue: each sum (plus x in fp32) rounded once to bf16 in place
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const uint32_t at = stage_at(rowg, j);
      float o[4] = {acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]};
      if constexpr (RESIDUAL) {
        const uint32_t x0 = lds32(at), x1 = lds32(at + 1024);
        o[0] += __uint_as_float(x0 << 16);
        o[1] += __uint_as_float(x0 & 0xFFFF0000u);
        o[2] += __uint_as_float(x1 << 16);
        o[3] += __uint_as_float(x1 & 0xFFFF0000u);
      }
      sts32(at, bf2(o[0], o[1]));
      sts32(at + 1024, bf2(o[2], o[3]));
    }
    fence_proxy_async();
    bar_sync(1 + wg, 128);
    if ((tid & 127) == 0) {
#pragma unroll
      for (int b = 0; b < BN / 64; ++b)
        tma_store(&tout, box0 + b * 8192, ct * BN + 64 * b, rt * BM + wg * 64);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if ((tid & 127) == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Error codes of the C entries beside CUDA's own (all below 1000).
constexpr int ERR_NO_ENCODE = 1000;  // cuTensorMapEncodeTiled not found in the driver
constexpr int ERR_ENCODE = 1001;     // a tensor map was refused
constexpr int ERR_TILE = 1002;       // a tile width or activation the kernels are not built for
constexpr int ERR_DEVICE = 1003;     // a device index past MAX_DEVICES

// The arguments of both stages. g is caller-allocated scratch [N, F] bf16,
// rrms fp32 [N] (NORM); wn and rrms are read only with NORM, x by the down
// stage only with RESIDUAL.
struct Args {
  const void *x, *wn, *wg, *wu, *wd;
  void *g, *out, *rrms;
  int N, D, F, bh, bn, act;
  float eps;
};

// The stages a call runs: the main entries run all three; the stage entries
// one at a time, for timing them apart.
constexpr int RRMS = 1, GATE_UP = 2, DOWN = 4;

// Set the kernel's shared-memory limit on this device once (`configured`
// is the kernel's own: every instance of a stage has the same type); the
// device's SM count through `sms`.
template <typename K>
int prepare(K kernel, size_t smem, bool (&configured)[MAX_DEVICES], int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return ERR_DEVICE;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  *sms = sm_count(dev);
  return 0;
}

template <int BH, int ACT, bool NORM>
int launch_gate_up(const Args& a, EncodeTiled fn, cudaStream_t s) {
  using T = GateUp<BH, NORM>;
  static bool configured[MAX_DEVICES] = {};
  int sms = 0;
  int err =
      prepare(gate_up_kernel<BH, ACT, NORM>, smem_bytes<T>(NORM ? MAX_D : 0), configured, &sms);
  if (err) return err;
  CUtensorMap mx, mg, mu, og;
  if (!encode(fn, &mx, a.x, a.N, a.D, BM) || !encode(fn, &mg, a.wg, a.F, a.D, BH) ||
      !encode(fn, &mu, a.wu, a.F, a.D, BH) || !encode(fn, &og, a.g, a.N, a.F, 64))
    return ERR_ENCODE;
  const int tiles = ((a.N + BM - 1) / BM) * (a.F / BH);
  gate_up_kernel<BH, ACT, NORM><<<tiles < sms ? tiles : sms, THREADS,
                                  smem_bytes<T>(NORM ? a.D : 0), s>>>(
      mx, mg, mu, og, (const float*)a.wn, (const float*)a.rrms, a.N, a.D, a.F);
  return (int)cudaGetLastError();
}

template <int BN, bool RESIDUAL>
int launch_down(const Args& a, EncodeTiled fn, cudaStream_t s) {
  using T = Down<BN>;
  static bool configured[MAX_DEVICES] = {};
  int sms = 0;
  int err = prepare(down_kernel<BN, RESIDUAL>, smem_bytes<T>(0), configured, &sms);
  if (err) return err;
  CUtensorMap mga, mwd, mres, mout;
  if (!encode(fn, &mga, a.g, a.N, a.F, BM) || !encode(fn, &mwd, a.wd, a.D, a.F, BN) ||
      !encode(fn, &mres, RESIDUAL ? a.x : a.out, a.N, a.D, 64) ||
      !encode(fn, &mout, a.out, a.N, a.D, 64))
    return ERR_ENCODE;
  const int tiles = ((a.N + BM - 1) / BM) * (a.D / BN);
  down_kernel<BN, RESIDUAL><<<tiles < sms ? tiles : sms, THREADS, smem_bytes<T>(0), s>>>(
      mga, mwd, mres, mout, a.N, a.D, a.F);
  return (int)cudaGetLastError();
}

template <int ACT, bool NORM>
int gate_up_act(const Args& a, EncodeTiled fn, cudaStream_t s) {
  switch (a.bh) {
    case 128: return launch_gate_up<128, ACT, NORM>(a, fn, s);
    case 64: return launch_gate_up<64, ACT, NORM>(a, fn, s);
    default: return ERR_TILE;
  }
}

// The stages in `stages` on `stream`, in order; returns the first CUDA error
// (0 when the launches were accepted) or one of the codes above 999.
// Nothing for N 0.
template <bool NORM>
int run(const Args& a, int stages, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (a.N == 0) return 0;
  const EncodeTiled fn = encode_fn();
  if (!fn) return ERR_NO_ENCODE;
  int err = 0;
  if (NORM && (stages & RRMS)) err = launch_rrms(a.x, a.rrms, a.N, a.D, a.eps, s);
  if (!err && (stages & GATE_UP)) {
    switch (a.act) {
      case GELU: err = gate_up_act<GELU, NORM>(a, fn, s); break;
      case GELU_TANH: err = gate_up_act<GELU_TANH, NORM>(a, fn, s); break;
      case SILU: err = gate_up_act<SILU, NORM>(a, fn, s); break;
      default: err = ERR_TILE;
    }
  }
  if (!err && (stages & DOWN)) {
    switch (a.bn) {
      case 256: err = launch_down<256, NORM>(a, fn, s); break;
      case 192: err = launch_down<192, NORM>(a, fn, s); break;
      case 128: err = launch_down<128, NORM>(a, fn, s); break;
      case 64: err = launch_down<64, NORM>(a, fn, s); break;
      default: err = ERR_TILE;
    }
  }
  return err;
}

}  // namespace
}  // namespace gated_mlp
