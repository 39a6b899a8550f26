// RMSNorm-fused q/k/v projections, for Hopper: kernel #12 norm_qkv.
//
// Replaces graphgpt_tpu/ops/mlp.py:315 _norm_qkv_kernel (launched by
// _norm_qkv_call :328 from fused_norm_qkv :363 under GGT_ATTN_NORM_FUSE=1):
//   hpre = bf16((x * rrms(x)) * wn),  q = bf16(hpre @ Wq^T),  k = bf16(hpre @ Wk^T),
//   v = bf16(hpre @ Wv^T)
// with the TPU kernel's rounding points: RMS statistics in fp32, hpre
// rounded to bf16, each product summed in fp32 and rounded once. x bf16
// [N, D], wn fp32 [D], the weights bf16 in nn.Linear layout ([width, D],
// K-major) with D and every width a multiple of 64 (GQA's k and v are
// narrower than q); q, k, v bf16 [N, width]. N is any count (0 launches
// nothing).
//
// What bounds it on the H100: operations. At N 65,536, D 768 and widths
// 3 x 768 the products are 2 x 65,536 x 768 x 2,304 = 231.9 GFLOP, 0.2345 ms
// at 989 TFLOP/s, against 406.5 MB of x, weights and outputs (0.121 ms at
// 3.35 TB/s).
//
// Design. A pre-pass (a warp a row, 16-byte loads) writes rrms [N] in fp32
// to scratch: hpre is rounded to bf16 before the product, so the norm
// cannot become a row scale in the epilogue and every row's rrms is needed
// before its first product. The main kernel is persistent, one CTA an SM
// walking output tiles of 128 rows x BN columns (BN 256, 128 or 64: the
// largest that divides the three widths, so no tile straddles q, k and v),
// the column index fastest, so that the CTAs in flight share a row tile of
// x and all of W in L2. A CTA is three warpgroups:
//  - one producer thread keeps a ring of stages full with TMA: a stage is
//    the x tile [128, 64] and the W tile [BN, 64] (K-major, as nn.Linear
//    holds it), both 128-byte swizzled; full and empty mbarriers; rows past
//    N arrive as zeros;
//  - two consumer warpgroups of 64 rows each take the landed x stage into
//    registers (ldmatrix, the swizzle's XOR in the address), apply the norm
//    there ((x * rrms[row]) * wn[k] in fp32, rounded to bf16) and issue
//    wgmma m64nBNk16 with that A from registers and B from the W stage
//    through a shared-memory descriptor: each k-step's norm runs while the
//    stage's earlier wgmma do (in registers they do not read); one commit
//    group a stage, waited for before the next stage's x is loaded (a
//    register of a wgmma in flight written by another instruction makes
//    ptxas serialise every wgmma); each warp then hands the stage back;
//  - the epilogue rounds each sum to bf16 once into a swizzled staging tile
//    that one thread stores by TMA (rows past N are not written) while the
//    warpgroup goes on to its next tile.
// setmaxnreg gives the consumers 232 registers (128 fp32 sums a thread at
// BN 256) and the producer 40. The consumers spin on their barriers with no
// clock: a timeout there left ptxas short of registers in the k-loop (a
// spill, and C7512: every wgmma serialised). The producer keeps the timeout
// and waits last for the whole ring, so a hang on the ring traps the
// launch. No split-K and no atomics: two launches on the same inputs give
// the same bits. Measured and not kept (PERF.md §6):
// clusters of two CTAs multicasting W (L2 reads a stage 48 -> 32 KB: no
// gain), the norm applied in shared memory with A read from there (by the
// consumers or by the producer warpgroup's spare warps: slower), A
// double-buffered across stages (serialised by ptxas).

#include "gemm_sm90.cuh"  // wgmma, the register-A norm, the rrms pre-pass, tensor maps

namespace norm_qkv {
namespace {

using namespace sm90;
using namespace gemm90;

constexpr int BM = 128;             // rows of an output tile: two consumer warpgroups of 64
constexpr int THREADS = 384;        // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int SMEM_MAX = 232448;    // shared memory a block can have on the H100
constexpr int MAX_D = 4096;         // wn's row in shared memory beside the stages

// Shared memory: 1024 bytes of slack to align what follows for the 128-byte
// swizzle; the ring of stages; the output tile staged for its TMA store
// ([128, BN] bf16 as BN / 64 swizzled boxes of [64, 64] a warpgroup); wn;
// the barriers.
template <int BN>
struct Tile {
  static constexpr int X_BYTES = BM * KC * 2;  // 16 KB
  static constexpr int W_BYTES = BN * KC * 2;
  static constexpr int STAGE = X_BYTES + W_BYTES;
  static constexpr int OUT_BYTES = BM * BN * 2;
  static constexpr int FIT = (SMEM_MAX - 1024 - OUT_BYTES - MAX_D * 4 - 256) / STAGE;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;  // 3, 5, 8 for BN 256, 128, 64
  static constexpr int NACC = BN / 2;  // fp32 accumulators a thread: [64, BN] over 128 threads
};

template <int BN>
inline size_t smem_bytes(int D) {
  return 1024 + (size_t)Tile<BN>::STAGES * Tile<BN>::STAGE + Tile<BN>::OUT_BYTES +
         (size_t)D * sizeof(float) + 2 * Tile<BN>::STAGES * sizeof(uint64_t);
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
qkv_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tq,
           const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
           const __grid_constant__ CUtensorMap oq, const __grid_constant__ CUtensorMap ok,
           const __grid_constant__ CUtensorMap ov, const float* __restrict__ wn,
           const float* __restrict__ rrms, int N, int D, int Fq, int Fk, int Fv) {
  using T = Tile<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  uint8_t* out_s = ring + T::STAGES * T::STAGE;
  float* wn_s = reinterpret_cast<float*>(out_s + T::OUT_BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(wn_s + D);  // full[STAGES], empty[STAGES]
  const uint32_t sm_ring = saddr(ring), sm_bars = saddr(bars);
  auto ring_full = [=](int s) { return sm_bars + 8 * s; };                // the stage landed
  auto ring_empty = [=](int s) { return sm_bars + 8 * (T::STAGES + s); };  // the stage is free
  const int tid = threadIdx.x;
  for (int i = tid; i < D; i += THREADS) wn_s[i] = wn[i];
  if (tid == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(ring_full(s), 1);   // the producer's arrive and the bytes
      mbar_init(ring_empty(s), 8);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int nq = Fq / BN, nk = Fk / BN;
  const int cts = (Fq + Fk + Fv) / BN;
  const int tiles = ((N + BM - 1) / BM) * cts;
  const int kt = D / KC;
  if (tid >= 256) {
    // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
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
        const CUtensorMap* tw = ct < nq ? &tq : ct < nq + nk ? &tk : &tv;
        const int n0 = (ct < nq ? ct : ct < nq + nk ? ct - nq : ct - nq - nk) * BN;
        for (int kc = 0; kc < kt; ++kc) {
          mbar_wait_or_trap(ring_empty(stage), phase ^ 1);
          const uint32_t bar = ring_full(stage);
          mbar_expect_tx(bar, T::STAGE);
          const uint32_t dst = sm_ring + stage * T::STAGE;
          tma_load(dst, &tx, bar, kc * KC, rt * BM);
          tma_load(dst + T::X_BYTES, tw, bar, kc * KC, n0);
          next();
        }
      }
      // every stage handed back: the consumers are past their last product
      for (int s = 0; s < T::STAGES; ++s, next()) mbar_wait_or_trap(ring_empty(stage), phase ^ 1);
    }
  } else {
    // consumer warpgroups: rows [64 wg, 64 wg + 64) of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = tid & 31, warp = tid >> 5;  // warp 0-7: 16 rows each
    const int g = lane >> 2, tq4 = lane & 3;
    const uint32_t aoff = (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * 128 +
                          (((lane >> 4) ^ (lane & 7)) << 4);
    float acc[T::NACC];
#pragma unroll
    for (int i = 0; i < T::NACC; ++i) acc[i] = 0.f;
    uint32_t a[4][4];
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int rt = t / cts, ct = t - rt * cts;
      const int row0 = rt * BM + warp * 16 + g;  // this thread's rows: row0, row0 + 8
      const float rr0 = row0 < N ? rrms[row0] : 0.f;
      const float rr1 = row0 + 8 < N ? rrms[row0 + 8] : 0.f;
      for (int kc = 0; kc < kt; ++kc) {
        mbar_wait(ring_full(stage), phase);
        const int cur = stage;
        const uint32_t xs = sm_ring + cur * T::STAGE;
        const float* wk = wn_s + kc * KC + 2 * tq4;
        const uint64_t desc = desc_sw128(xs + T::X_BYTES);
        // the stage's x into registers, then each k-step's norm and its wgmma:
        // k-step kk's registers are written while the wgmma of the steps
        // before it run, which read only their own
        load_x(a, xs, aoff);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          norm_a(a[kk], kk, wk, rr0, rr1);
          wgmma_fence();
          wgmma_rs<BN>(acc, a[kk], desc + 2 * kk, kc + kk > 0);
        }
        wgmma_commit();
        if (++stage == T::STAGES) {
          stage = 0;
          phase ^= 1;
        }
        wgmma_wait<0>();
        // every warp hands the stage back once its products have retired
        if (lane == 0) mbar_arrive(ring_empty(cur));
      }
#pragma unroll
      for (int i = 0; i < T::NACC; ++i) pin(acc[i]);
      // epilogue: round to bf16 into this warpgroup's staging boxes (fragment j
      // holds columns 8j + 2 tq4, +1 of rows g and g + 8 of the warp's 16: box
      // j / 8 of [64, 64], its 16-byte chunk j % 8 at chunk (j % 8) ^ g of the
      // row, as the 128-byte swizzle puts it), then one thread stores the
      // boxes by TMA and the warpgroup goes on. The boxes are written again
      // only once the last tile's stores have read them.
      const int wg = warp >> 2;
      const uint32_t box0 = saddr(out_s) + wg * (BN / 64) * 8192;
      if ((tid & 127) == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      bar_sync(1 + wg, 128);
      // row g's address with its chunk bits holding g; row g + 8 is 1024 on
      // (the same swizzle). XOR-ing j % 8 into bits 4-6 keeps the invariant
      // part one register, not one per fragment.
      const uint32_t rowg = (box0 + ((warp & 3) * 16 + g) * 128 + tq4 * 4) ^ (g << 4);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const uint32_t at = (rowg ^ ((j & 7) << 4)) + (j / 8) * 8192;
        const __nv_bfloat162 lo = __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at),
                     "r"(*reinterpret_cast<const uint32_t*>(&lo)));
        asm volatile("st.shared.b32 [%0+1024], %1;\n" ::"r"(at),
                     "r"(*reinterpret_cast<const uint32_t*>(&hi)));
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_sync(1 + wg, 128);
      if ((tid & 127) == 0 && rt * BM + wg * 64 < N) {
        const CUtensorMap* om = ct < nq ? &oq : ct < nq + nk ? &ok : &ov;
        const int n0 = (ct < nq ? ct : ct < nq + nk ? ct - nq : ct - nq - nk) * BN;
#pragma unroll
        for (int b = 0; b < BN / 64; ++b)
          tma_store(om, box0 + b * 8192, n0 + 64 * b, rt * BM + wg * 64);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    if ((tid & 127) == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// Error codes of the C entries beside CUDA's own (all below 1000).
constexpr int ERR_NO_ENCODE = 1000;   // cuTensorMapEncodeTiled not found in the driver
constexpr int ERR_ENCODE = 1001;      // a tensor map was refused
constexpr int ERR_BN = 1002;          // a tile width other than 64, 128, 256
constexpr int ERR_DEVICE = 1003;      // a device index past MAX_DEVICES

template <int BN>
int launch(const void* x, const void* wn, const void* wq, const void* wk, const void* wv,
           void* q, void* k, void* v, const void* rrms, int N, int D, int Fq, int Fk, int Fv,
           cudaStream_t stream) {
  // the shared-memory limit is a property of the kernel on each device
  static bool configured[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return ERR_DEVICE;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(qkv_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes<BN>(MAX_D));
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  const EncodeTiled fn = encode_fn();
  if (!fn) return ERR_NO_ENCODE;
  CUtensorMap mx, mq, mk, mv, oq, ok, ov;
  if (!encode(fn, &mx, x, N, D, BM) || !encode(fn, &mq, wq, Fq, D, BN) ||
      !encode(fn, &mk, wk, Fk, D, BN) || !encode(fn, &mv, wv, Fv, D, BN) ||
      !encode(fn, &oq, q, N, Fq, 64) || !encode(fn, &ok, k, N, Fk, 64) ||
      !encode(fn, &ov, v, N, Fv, 64))
    return ERR_ENCODE;
  const int tiles = ((N + BM - 1) / BM) * ((Fq + Fk + Fv) / BN);
  const int grid = tiles < sm_count(dev) ? tiles : sm_count(dev);
  qkv_kernel<BN><<<grid, THREADS, smem_bytes<BN>(D), stream>>>(
      mx, mq, mk, mv, oq, ok, ov, (const float*)wn, (const float*)rrms, N, D, Fq, Fk, Fv);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace norm_qkv

// C entries for ctypes; each returns the first CUDA error (0 when the
// launches were accepted), or one of the codes above 999.
//
// ggt_norm_qkv: the rrms pre-pass into `rrms` (fp32 [N] scratch) and the
// main kernel, on `stream`; nothing for N 0. D a multiple of 64, at most
// 4096; the widths multiples of bn (256, 128 or 64); x and the weights
// 16-byte aligned.
extern "C" int ggt_norm_qkv(const void* x, const void* wn, const void* wq, const void* wk,
                            const void* wv, void* q, void* k, void* v, void* rrms, int N, int D,
                            int Fq, int Fk, int Fv, int bn, float eps, void* stream) {
  using namespace norm_qkv;
  if (N == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int err = launch_rrms(x, rrms, N, D, eps, s);
  if (err) return err;
  switch (bn) {
    case 256: return launch<256>(x, wn, wq, wk, wv, q, k, v, rrms, N, D, Fq, Fk, Fv, s);
    case 128: return launch<128>(x, wn, wq, wk, wv, q, k, v, rrms, N, D, Fq, Fk, Fv, s);
    case 64: return launch<64>(x, wn, wq, wk, wv, q, k, v, rrms, N, D, Fq, Fk, Fv, s);
    default: return ERR_BN;
  }
}

// ggt_norm_qkv_rrms: the pre-pass alone, for timing it on its own.
extern "C" int ggt_norm_qkv_rrms(const void* x, void* rrms, int N, int D, float eps,
                                 void* stream) {
  return norm_qkv::launch_rrms(x, rrms, N, D, eps, (cudaStream_t)stream);
}
