// The fp32 forms of the dense products for Hopper, on the TF32 tensor
// cores with fp32 accuracy (3xTF32): #12f, the norm-fused projections
// (q, k, v) = h (Wq | Wk | Wv)^T with h = rms(x) * wn; #11f, the gated MLP
// down(act(gate(x)) * up(x)) with no norm and no residual; and #2f, the
// gated MLP with RMSNorm and residual, x + down(act(gate(h)) * up(h)).
//
// Replaces graphgpt_tpu/ops/mlp.py:315 _norm_qkv_kernel, :82 _mlp_kernel and
// :203 _norm_mlp_kernel when they are given fp32 (a `model.dtype: float32`
// model): their casts of hpre and the activation to x's dtype (:320; :88,
// :91; :208, :217) then change nothing, their products sum in fp32 and #2's
// residual is added in fp32. The bf16 forms are csrc/norm_qkv.cu,
// csrc/mlp.cu and csrc/norm_mlp.cu. Contracts: x [N, D] fp32, wn [D] fp32
// (#12f, #2f), the weights fp32 in nn.Linear layout (wq, wk, wv [width, D],
// GQA's k and v narrower than q; wg, wu [F, D]; wd [D, F]); q, k, v [N,
// width] and out [N, D] fp32; from the caller fp32 scratch: the weights'
// planes (twice the weights' values), rrms [N] (#12f, #2f), g [N, F] (#11f,
// #2f). D and every width a multiple of the tile width, D at most 4096
// where wn is read; exact gelu (erff), tanh gelu, silu.
//
// What bounds it on the H100: operations, at 165 TFLOP/s (495 TF32 / 3).
// #12f: 2 N D (Fq + Fk + Fv), 29.0 GFLOP at N 8,192, D 768, widths 3 x 768
// (0.176 ms) against ~0.1 GB; #11f and #2f: 6 N D F, 116.0 GFLOP at N 8,192,
// D 768, F 3,072 (0.703 ms) against ~0.2 GB. The FFMA bodies these replace
// (the first fp32 forms, FFMA on fp32 tiles in shared memory) reached 23-28
// TFLOP/s, 42% of the fp32 cores' 67; cuBLAS's fp32 product, also FFMA,
// ~40-43.
//
// Design: the bf16 kernels' persistent TMA + warp-specialised wgmma body
// (norm_qkv.cu, mlp_common.cuh) with every product in 3xTF32:
//  - a pass of its own splits each weight once a call into TF32 hi and lo
//    planes in the caller's scratch (gemm_tf32x3.cuh split_kernel): a
//    weight tile is read by every row tile (N / 128 times), and splitting
//    a shared operand in every warp cost the split pair #4f / #5f ~60% of
//    their time (flash_bwd_split_f32.cu);
//  - one kernel body (prod_kernel) for the three products, its mode a
//    template parameter: QKV (#12f, after the rrms pre-pass), GATE_UP and
//    DOWN (the MLPs' two stages, g [N, F] between them in device memory),
//    and two flags: NORM (QKV; #2f's GATE_UP, after the rrms pre-pass)
//    normalises A, RESID (#2f's DOWN) adds x in the epilogue; each an `if
//    constexpr`, so that #11f's and #12f's instances are what they were
//    without them. One CTA an SM walks output tiles of 128 rows x BN
//    columns (BN 128, or 64 where 128 does not divide the output:
//    ops/mlp.py f32_block_n), the column index fastest, so that the CTAs in
//    flight share a row tile of A in L2;
//  - a producer thread keeps a ring full by TMA: a stage is the A box [128,
//    32] (x, or g) and the B boxes [BN, 32] of the hi and lo planes (QKV:
//    the rows of q, k or v, BN dividing each width, so no tile straddles
//    two outputs; GATE_UP: 64 gate rows over 64 up rows, as the bf16 #11
//    stacks them, BN 128); rows past N arrive as zeros;
//  - two consumer warpgroups of 64 rows each take the landed A box into
//    registers with ldmatrix (a 16-bit 8 x 8 matrix is an 8 x 4 fp32 one;
//    a k8-step is 32 bytes, as a bf16 k16-step), normalise it there under
//    NORM ((x * rrms[row]) * wn[k], the plain version's two roundings; wn's
//    row sits in shared memory beside the ring), split each k8-step into
//    hi and lo registers next to its use, and issue three wgmma m64nBNk8
//    .tf32 with that A from registers and B from the planes (mma3: A_lo
//    B_hi, A_hi B_lo, A_hi B_hi); each k8-step's registers are written
//    while the wgmma of the steps before it run, which read only their own;
//    one commit group a stage, waited for before the next stage's A is
//    loaded (a register of an in-flight wgmma written by another
//    instruction makes ptxas serialise every wgmma);
//  - a stage's twelve products sum into partial accumulators, which the
//    consumers then add to the tile's sums in fp32 (round to nearest): the
//    tensor core aligns and cuts each product to its accumulator's
//    exponent, so that one accumulator over a K of 3,072 (the MLPs' down
//    stage) drifted 3.1e-5 from the plain fp32 sums, past F32_REL (the
//    first build: one accumulator, BN up to 256); the partials are why BN
//    stops at 128 (two sets of [64, BN] sums a thread);
//  - the epilogue (GATE_UP: act(gate) * up of the two column groups one
//    thread holds at the same offset; RESID: x + the sums, x read at the
//    output's offsets) stores each thread's fp32 pairs straight to global
//    memory (full 32-byte sectors; rows past N are neither read nor
//    written): an fp32 staging tile for a TMA store would take the ring's
//    room.
// Shared memory: a stage is 16 KB of A and 2 x BN x 128 bytes of planes
// (48 KB at BN 128: four stages, also beside NORM's 16 KB wn row; seven at
// 64). setmaxnreg gives the consumers 232 registers (2 x 64 fp32 sums a
// thread at BN 128, 32 for a stage's split A) and the producer 40; only the
// producer's waits time out (4 s, then trap), and it waits last for the
// whole ring. No split-K and no atomics: two launches on the same inputs
// give the same bits.
// Measured and not kept: see PERF.md §6 and ops/split_probe.py's
// mlp_f32 variants (mma1: one TF32 product; smema: A read from the stage
// by descriptor, the shared-memory-A route's main loop without its
// pre-pass); #2f's first body, FFMA on 64 x 64 fp32 tiles in
// shared memory with the norm applied as x landed there: 4.15-4.21 ms at
// N 8,192, D 768, F 3,072, 28 TFLOP/s, slower than cuBLAS's fp32 products
// (2.7 ms), since no FFMA design passes the fp32 cores' 67 TFLOP/s.

#include "gemm_tf32x3.cuh"  // TF32 wgmma, load_a, split_a, mma3, the split pass, encode_f32

namespace mlp_qkv_f32 {
namespace {

using namespace sm90;
using namespace gemm_tf32;

constexpr int BM = 128;           // rows of an output tile: two consumer warpgroups of 64
constexpr int THREADS = 384;      // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int SMEM_MAX = 232448;  // shared memory a block can have on the H100
constexpr int MAX_D = 4096;       // wn's row in shared memory beside the stages (NORM)
constexpr int RRMS_ROWS = 8;      // rows (warps) a block of the rrms pre-pass

enum Mode { QKV = 0, GATE_UP = 1, DOWN = 2 };
enum Act { GELU = 0, GELU_TANH = 1, SILU = 2 };

template <int ACT>
__device__ __forceinline__ float act_f32(float x) {
  if (ACT == GELU) return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
  if (ACT == GELU_TANH)
    return 0.5f * x * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
  return x / (1.f + expf(-x));
}

// Shared memory at accumulator width BN: 1024 bytes of slack to align the
// ring for the 128-byte swizzle; the ring (a stage: A, then B's hi plane
// [BN, 32], then its lo plane); wn (NORM); the barriers.
template <int BN, bool NORM>
struct Ring {
  static constexpr int A_BYTES = BM * KC * 4;  // 16 KB
  static constexpr int B_BYTES = BN * KC * 4;  // one plane
  static constexpr int STAGE = A_BYTES + 2 * B_BYTES;
  static constexpr int WN_BYTES = NORM ? MAX_D * 4 : 0;
  static constexpr int FIT = (SMEM_MAX - 1024 - WN_BYTES - 256) / STAGE;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int NACC = BN / 2;  // fp32 sums a thread: [64, BN] over 128 threads
  static_assert(BN <= 128, "the tile's sums and a stage's partial sums fill the registers");
  static constexpr size_t bytes(int wn_floats) {
    return 1024 + (size_t)STAGES * STAGE + (size_t)wn_floats * 4 + 2 * STAGES * 8;
  }
};

// What a launch writes and reads beside its tensor maps. QKV: out[0..2] q,
// k, v of ld[i] columns, ncol[i] column tiles each; GATE_UP: out[0] g
// [N, F], ncol[0] = F / BH, up's rows F (b_up) on in the planes; DOWN:
// out[0] [N, D], ncol[0] = D / BN. NORM reads wn and rrms, RESID x [N, D].
struct Params {
  float* out[3];
  int ld[3];
  int ncol[3];
  const float* wn;
  const float* rrms;
  int N, K, b_up;
  const float* x;
};

// rrms[n] = 1 / sqrt(mean(x[n]^2) + eps), a warp a row, 16-byte loads
__global__ void __launch_bounds__(32 * RRMS_ROWS)
rrms_kernel(const float* __restrict__ x, float* __restrict__ rrms, int N, int D, float eps) {
  const long long row = (long long)blockIdx.x * RRMS_ROWS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= N) return;
  float ss = 0.f;
  for (int d = lane * 4; d < D; d += 128) {
    const float4 v = *reinterpret_cast<const float4*>(x + row * D + d);
    ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (lane == 0) rrms[row] = 1.f / sqrtf(ss / (float)D + eps);
}

// NORM: A = x normalised in registers (QKV; #2f's GATE_UP); RESID: x added
// to the sums in the epilogue (#2f's DOWN)
template <int MODE, int BN, int ACT, bool NORM, bool RESID>
__global__ void __launch_bounds__(THREADS, 1)
prod_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap thi,
            const __grid_constant__ CUtensorMap tlo, const Params p) {
  static_assert((MODE != QKV || NORM) && (MODE != DOWN || !NORM) && (MODE == DOWN || !RESID),
                "QKV normalises; the norm is on x (not g), the residual on the down stage");
  using R = Ring<BN, NORM>;
  constexpr int BH = MODE == GATE_UP ? BN / 2 : BN;  // rows of one B box
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  float* wn_s = reinterpret_cast<float*>(ring + R::STAGES * R::STAGE);
  const int D = p.K;  // NORM: the depth is x's width
  uint64_t* bars = reinterpret_cast<uint64_t*>(wn_s + (NORM ? D : 0));  // full, empty
  const uint32_t sm_ring = saddr(ring), sm_bars = saddr(bars);
  auto ring_full = [=](int s) { return sm_bars + 8 * s; };                // the stage landed
  auto ring_empty = [=](int s) { return sm_bars + 8 * (R::STAGES + s); };  // the stage is free
  const int tid = threadIdx.x;
  if constexpr (NORM)
    for (int i = tid; i < D; i += THREADS) wn_s[i] = p.wn[i];
  if (tid == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(ring_full(s), 1);   // the producer's arrive and the bytes
      mbar_init(ring_empty(s), 8);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int cts = p.ncol[0] + p.ncol[1] + p.ncol[2];
  const int tiles = ((p.N + BM - 1) / BM) * cts;
  const int kt = p.K / KC;
  if (tid >= 256) {
    // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      int stage = 0;
      uint32_t phase = 0;
      auto next = [&] {
        if (++stage == R::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      };
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int rt = t / cts, ct = t - rt * cts;
        for (int kc = 0; kc < kt; ++kc) {
          mbar_wait_or_trap(ring_empty(stage), phase ^ 1);
          const uint32_t bar = ring_full(stage);
          mbar_expect_tx(bar, R::STAGE);
          const uint32_t dst = sm_ring + stage * R::STAGE;
          tma_load(dst, &ta, bar, kc * KC, rt * BM);
#pragma unroll
          for (int pl = 0; pl < 2; ++pl) {
            const CUtensorMap* tb = pl ? &tlo : &thi;
            const uint32_t b = dst + R::A_BYTES + pl * R::B_BYTES;
            tma_load(b, tb, bar, kc * KC, ct * BH);
            if (MODE == GATE_UP) tma_load(b + BH * KC * 4, tb, bar, kc * KC, p.b_up + ct * BH);
          }
          next();
        }
      }
      // every stage handed back: the consumers are past their last product
      for (int s = 0; s < R::STAGES; ++s, next())
        mbar_wait_or_trap(ring_empty(stage), phase ^ 1);
    }
    return;
  }
  // consumer warpgroups: rows [64 wg, 64 wg + 64) of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int lane = tid & 31, warp = tid >> 5;  // warp 0-7: 16 rows each
  const int g = lane >> 2, tq4 = lane & 3;
  const uint32_t aoff = a_offset(warp, lane);
  float acc[R::NACC], part[R::NACC];  // the tile's sums; a stage's partial sums
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int rt = t / cts, ct = t - rt * cts;
#pragma unroll
    for (int i = 0; i < R::NACC; ++i) acc[i] = 0.f;
    const int row0 = rt * BM + warp * 16 + g;  // this thread's rows: row0, row0 + 8
    float rr0 = 0.f, rr1 = 0.f;
    if constexpr (NORM) {
      rr0 = row0 < p.N ? p.rrms[row0] : 0.f;
      rr1 = row0 + 8 < p.N ? p.rrms[row0 + 8] : 0.f;
    }
    for (int kc = 0; kc < kt; ++kc) {
      mbar_wait(ring_full(stage), phase);
      const int cur = stage;
      const uint32_t st = sm_ring + cur * R::STAGE;
      const uint64_t bhi = desc_sw128(st + R::A_BYTES);
      const uint64_t blo = desc_sw128(st + R::A_BYTES + R::B_BYTES);
      // the stage's A into registers, then each k8-step's norm, split and
      // three products
      uint32_t a[4][4];
      load_a(a, st, aoff);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (NORM) {
          const float w0 = wn_s[kc * KC + 8 * kk + tq4], w4 = wn_s[kc * KC + 8 * kk + tq4 + 4];
          const float rr[4] = {rr0, rr1, rr0, rr1}, w[4] = {w0, w0, w4, w4};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float h = __fmul_rn(__fmul_rn(__uint_as_float(a[kk][i]), rr[i]), w[i]);
            a[kk][i] = __float_as_uint(h);
          }
        }
        uint32_t lo[4];
        split_a(a[kk], lo);
        wgmma_fence();
        mma3<BN>(part, a[kk], lo, bhi + 2 * kk, blo + 2 * kk, kk > 0);
      }
      wgmma_commit();
      if (++stage == R::STAGES) {
        stage = 0;
        phase ^= 1;
      }
      wgmma_wait<0>();
      // every warp hands the stage back once its products have retired
      if (lane == 0) mbar_arrive(ring_empty(cur));
#pragma unroll
      for (int i = 0; i < R::NACC; ++i) {
        pin(part[i]);
        acc[i] += part[i];
      }
    }
    // epilogue: fragment j holds columns 8 j + 2 tq4, +1 of rows row0 (acc
    // 4 j, 4 j + 1) and row0 + 8 (4 j + 2, 4 j + 3)
    // (QKV: the output of this column tile, picked without indexing the
    // parameters by a register)
    int c0 = ct, ld = p.ld[0];
    float* base = p.out[0];
    if constexpr (MODE == QKV) {
      const int nqk = p.ncol[0] + p.ncol[1];
      base = ct < p.ncol[0] ? p.out[0] : ct < nqk ? p.out[1] : p.out[2];
      ld = ct < p.ncol[0] ? p.ld[0] : ct < nqk ? p.ld[1] : p.ld[2];
      c0 = ct < p.ncol[0] ? ct : ct < nqk ? ct - p.ncol[0] : ct - nqk;
    }
    const long long off = (long long)row0 * ld + c0 * BH + 2 * tq4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row0 + 8 * r >= p.N) continue;
      float* orow = base + off + 8LL * r * ld;
      if constexpr (MODE == GATE_UP) {
#pragma unroll
        for (int j = 0; j < BH / 8; ++j) {
          const int gi = 4 * j + 2 * r, ui = 4 * (j + BH / 8) + 2 * r;
          *reinterpret_cast<float2*>(orow + 8 * j) = make_float2(
              act_f32<ACT>(acc[gi]) * acc[ui], act_f32<ACT>(acc[gi + 1]) * acc[ui + 1]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          float2 o = make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
          if constexpr (RESID) {
            const float2 xr = *reinterpret_cast<const float2*>(p.x + off + 8LL * r * ld + 8 * j);
            o = make_float2(xr.x + o.x, xr.y + o.y);
          }
          *reinterpret_cast<float2*>(orow + 8 * j) = o;
        }
      }
    }
  }
}

// Error codes of the C entries beside CUDA's own (all below 1000).
constexpr int ERR_NO_ENCODE = 1000;  // cuTensorMapEncodeTiled not found in the driver
constexpr int ERR_ENCODE = 1001;     // a tensor map was refused
constexpr int ERR_TILE = 1002;       // a tile width or activation the kernels are not built for
constexpr int ERR_DEVICE = 1003;     // a device index past MAX_DEVICES

// One launch of prod_kernel<MODE, BN, ACT, NORM, RESID>: A [N, K] at a, the
// planes' hi [b_rows, K] at hi and lo right after it (lo_off values on);
// the kernel's shared-memory limit set once a device.
template <int MODE, int BN, int ACT, bool NORM = false, bool RESID = false>
int launch_prod(const void* a, const float* hi, long long lo_off, int b_rows, const Params& p,
                EncodeTiled fn, cudaStream_t stream) {
  using R = Ring<BN, NORM>;
  static bool configured[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return ERR_DEVICE;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(prod_kernel<MODE, BN, ACT, NORM, RESID>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)R::bytes(NORM ? MAX_D : 0));
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  constexpr int BH = MODE == GATE_UP ? BN / 2 : BN;
  CUtensorMap ma, mhi, mlo;
  if (!encode_f32(fn, &ma, a, p.N, p.K, BM) || !encode_f32(fn, &mhi, hi, b_rows, p.K, BH) ||
      !encode_f32(fn, &mlo, hi + lo_off, b_rows, p.K, BH))
    return ERR_ENCODE;
  const int tiles = ((p.N + BM - 1) / BM) * (p.ncol[0] + p.ncol[1] + p.ncol[2]);
  const int sms = sm_count(dev);
  prod_kernel<MODE, BN, ACT, NORM, RESID><<<tiles < sms ? tiles : sms, THREADS,
                                            R::bytes(NORM ? p.K : 0), stream>>>(ma, mhi, mlo, p);
  return (int)cudaGetLastError();
}

int device_sms(int* sms) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return ERR_DEVICE;
  *sms = sm_count(dev);
  return 0;
}

int launch_rrms(const void* x, void* rrms, int N, int D, float eps, cudaStream_t stream) {
  rrms_kernel<<<(N + RRMS_ROWS - 1) / RRMS_ROWS, 32 * RRMS_ROWS, 0, stream>>>(
      (const float*)x, (float*)rrms, N, D, eps);
  return (int)cudaGetLastError();
}

// the MLPs' launches, a bit each (ops/mlp.py's stage mask)
enum Stage { RRMS = 1, GATE_UP_STAGE = 2, DOWN_STAGE = 4, SPLIT = 8 };

// The gated MLP's launches among `stages`, in order: the split pass of wg,
// wu, wd into `planes` (fp32 scratch of 2 x 3 F D values); NORM (#2f): the
// rrms pre-pass into `rrms` (fp32 [N]); gate/up into g (fp32 scratch [N,
// F]; 64 gate and 64 up columns a tile), x normalised under NORM; down
// into out (bn, 128 or 64, divides D: ops/mlp.py f32_block_n), x added
// under NORM. D and F multiples of 64 (NORM: D at most MAX_D); x and the
// weights 16-byte aligned. Nothing for N 0.
template <bool NORM>
int launch_mlp(const void* x, const void* wn, const void* wg, const void* wu, const void* wd,
               void* planes, void* g, void* out, void* rrms, int N, int D, int F, int bn,
               float eps, int act, int stages, cudaStream_t s) {
  if (N == 0) return 0;
  if (D % 64 || F % 64 || (bn != 128 && bn != 64) || D % bn || (NORM && D > MAX_D) ||
      act < GELU || act > SILU)
    return ERR_TILE;
  const EncodeTiled fn = encode_fn();
  if (!fn) return ERR_NO_ENCODE;
  int sms = 0;
  int err = device_sms(&sms);
  if (err) return err;
  const long long fd = (long long)F * D, total = 3 * fd;
  if (stages & SPLIT) err = launch_split(wg, fd, wu, fd, wd, fd, planes, sms, s);
  if (!err && NORM && (stages & RRMS)) err = launch_rrms(x, rrms, N, D, eps, s);
  if (err) return err;
  const float* hi = (const float*)planes;
  if (stages & GATE_UP_STAGE) {
    const Params pg{{(float*)g, nullptr, nullptr}, {F, 0, 0}, {F / 64, 0, 0},
                    (const float*)wn, (const float*)rrms, N, D, F, nullptr};
    switch (act) {
      case GELU:
        err = launch_prod<GATE_UP, 128, GELU, NORM>(x, hi, total, 2 * F, pg, fn, s);
        break;
      case GELU_TANH:
        err = launch_prod<GATE_UP, 128, GELU_TANH, NORM>(x, hi, total, 2 * F, pg, fn, s);
        break;
      default: err = launch_prod<GATE_UP, 128, SILU, NORM>(x, hi, total, 2 * F, pg, fn, s);
    }
    if (err) return err;
  }
  if (!(stages & DOWN_STAGE)) return 0;
  // down: A = g [N, F], B = wd's planes [D, F] (2 F D values on)
  const Params pd{{(float*)out, nullptr, nullptr}, {D, 0, 0}, {D / bn, 0, 0}, nullptr, nullptr,
                  N, F, 0, (const float*)x};
  switch (bn) {
    case 128: return launch_prod<DOWN, 128, 0, false, NORM>(g, hi + 2 * fd, total, D, pd, fn, s);
    case 64: return launch_prod<DOWN, 64, 0, false, NORM>(g, hi + 2 * fd, total, D, pd, fn, s);
    default: return ERR_TILE;
  }
}

}  // namespace
}  // namespace mlp_qkv_f32

// C entries for ctypes, on `stream`; each returns the first CUDA error (0
// when the launches were accepted), or one of the codes above 999.
//
// ggt_mlp_f32: #11f, three launches (launch_mlp without the norm): the
// split pass of wg, wu, wd into `planes`, gate/up into g, down into out.
extern "C" int ggt_mlp_f32(const void* x, const void* wg, const void* wu, const void* wd,
                           void* planes, void* g, void* out, int N, int D, int F, int bn, int act,
                           void* stream) {
  using namespace mlp_qkv_f32;
  return launch_mlp<false>(x, nullptr, wg, wu, wd, planes, g, out, nullptr, N, D, F, bn, 0.f,
                           act, SPLIT | GATE_UP_STAGE | DOWN_STAGE, (cudaStream_t)stream);
}

// ggt_norm_mlp_f32: #2f, four launches (launch_mlp with the norm): the split
// pass, the rrms pre-pass into `rrms`, gate/up on x normalised, down with x
// added.
extern "C" int ggt_norm_mlp_f32(const void* x, const void* wn, const void* wg, const void* wu,
                                const void* wd, void* planes, void* g, void* out, void* rrms,
                                int N, int D, int F, int bn, float eps, int act, void* stream) {
  using namespace mlp_qkv_f32;
  return launch_mlp<true>(x, wn, wg, wu, wd, planes, g, out, rrms, N, D, F, bn, eps, act,
                          SPLIT | RRMS | GATE_UP_STAGE | DOWN_STAGE, (cudaStream_t)stream);
}

// ggt_norm_mlp_f32_stages: #2f's launches among the bits of `stages` (1 the
// rrms pre-pass, 2 gate/up, 4 down, 8 the split pass), for timing each
// alone on the scratch of a whole call.
extern "C" int ggt_norm_mlp_f32_stages(const void* x, const void* wn, const void* wg,
                                       const void* wu, const void* wd, void* planes, void* g,
                                       void* out, void* rrms, int N, int D, int F, int bn,
                                       float eps, int act, int stages, void* stream) {
  return mlp_qkv_f32::launch_mlp<true>(x, wn, wg, wu, wd, planes, g, out, rrms, N, D, F, bn,
                                       eps, act, stages, (cudaStream_t)stream);
}

// ggt_norm_qkv_f32: #12f, three launches: the split pass of wq, wk, wv into
// `planes` (fp32 scratch of 2 (Fq + Fk + Fv) D values), the rrms pre-pass
// into `rrms` (fp32 [N] scratch), the products. D a multiple of 64, at
// most 4096; bn (128 or 64: ops/mlp.py f32_block_n) divides every width;
// x and the weights 16-byte aligned. Nothing for N 0.
extern "C" int ggt_norm_qkv_f32(const void* x, const void* wn, const void* wq, const void* wk,
                                const void* wv, void* planes, void* q, void* k, void* v,
                                void* rrms, int N, int D, int Fq, int Fk, int Fv, int bn,
                                float eps, void* stream) {
  using namespace mlp_qkv_f32;
  if (N == 0) return 0;
  if (D % 64 || D > MAX_D || (bn != 128 && bn != 64) || Fq % bn || Fk % bn || Fv % bn)
    return ERR_TILE;
  const cudaStream_t s = (cudaStream_t)stream;
  const EncodeTiled fn = encode_fn();
  if (!fn) return ERR_NO_ENCODE;
  int sms = 0;
  int err = device_sms(&sms);
  if (err) return err;
  const int fs = Fq + Fk + Fv;
  err = launch_split(wq, (long long)Fq * D, wk, (long long)Fk * D, wv, (long long)Fv * D, planes,
                     sms, s);
  if (!err) err = launch_rrms(x, rrms, N, D, eps, s);
  if (err) return err;
  const Params p{{(float*)q, (float*)k, (float*)v}, {Fq, Fk, Fv}, {Fq / bn, Fk / bn, Fv / bn},
                 (const float*)wn, (const float*)rrms, N, D, 0, nullptr};
  const float* hi = (const float*)planes;
  const long long lo_off = (long long)fs * D;
  return bn == 128 ? launch_prod<QKV, 128, 0, true>(x, hi, lo_off, fs, p, fn, s)
                   : launch_prod<QKV, 64, 0, true>(x, hi, lo_off, fs, p, fn, s);
}

// ggt_norm_qkv_f32_rrms: #12f's pre-pass alone, for checking and timing it
// on its own.
extern "C" int ggt_norm_qkv_f32_rrms(const void* x, void* rrms, int N, int D, float eps,
                                     void* stream) {
  if (N == 0) return 0;
  return mlp_qkv_f32::launch_rrms(x, rrms, N, D, eps, (cudaStream_t)stream);
}
