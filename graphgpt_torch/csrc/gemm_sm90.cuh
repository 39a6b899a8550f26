// The dense-product pieces for Hopper that kernel #12 norm_qkv
// (norm_qkv.cu) and the gated MLPs #2 norm_mlp and #11 mlp (mlp_common.cuh)
// share, on top of sm90_common.cuh's primitives: wgmma m64nNk16 with A from
// registers or from shared memory (both through 128-byte swizzled tiles),
// the RMSNorm of a register A operand, the rrms pre-pass, the tensor map of
// a bf16 matrix and the SM count.
#pragma once

#include <cuda_bf16.h>

#include "sm90_common.cuh"  // TMA, mbarriers, wgmma descriptors, the tensor-map encoder

namespace gemm90 {
namespace {

using namespace sm90;

typedef __nv_bfloat16 bf16;

constexpr int KC = 64;           // depth of a stage: one 128-byte swizzled row of bf16
constexpr int RRMS_ROWS = 8;     // rows (warps) a block of the pre-pass
constexpr int MAX_DEVICES = 64;  // devices whose SM count and kernel attributes are kept

// d[64, N] (+)= a[64, 16] @ b[16, N] for the warpgroup: a from registers
// (4 x bf16x2 a thread, mma.m16n8k16's A layout a warp), b through its
// descriptor; scale_d 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t desc, int scale_d);

#define D8(i)                                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

template <>
__device__ __forceinline__ void wgmma_rs<256>(float* d, const uint32_t* a, uint64_t desc,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56),
        D8(64), D8(72), D8(80), D8(88), D8(96), D8(104), D8(112), D8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a, uint64_t desc,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a, uint64_t desc,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// d[64, N] (+)= a[64, 16] @ b[16, N] for the warpgroup, a and b through
// their descriptors (K-major); scale_d 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<256>(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56),
        D8(64), D8(72), D8(80), D8(88), D8(96), D8(104), D8(112), D8(120)
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<192>(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56),
        D8(64), D8(72), D8(80), D8(88)
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef D8

// bf16x2 (low: the lower column) -> ((x * rr) * w) in fp32, rounded to bf16x2.
__device__ __forceinline__ uint32_t norm2(uint32_t v, float rr, float2 w) {
  const float lo = __uint_as_float(v << 16) * rr * w.x;
  const float hi = __uint_as_float(v & 0xFFFF0000u) * rr * w.y;
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// This warp's 16 rows x 64 of the x stage at xs, as four k-steps of
// mma.m16n8k16's A layout. ldmatrix: lane l gives the address of row
// (l & 7) + 8 ((l >> 3) & 1) of the warp's 16, 16-byte half l >> 4 of the
// k-step; aoff holds that row's offset with the swizzle's XOR (l & 7) and
// the half in bits 4-6, so k-step kk is aoff ^ 32 kk. Registers 0 and 2
// hold row g, 1 and 3 row g + 8; 0 and 1 columns 2 tq, +1 of the k-step,
// 2 and 3 those + 8.
__device__ __forceinline__ void load_x(uint32_t (&a)[4][4], uint32_t xs, uint32_t aoff) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) ldmatrix_x4(a[kk], xs + (aoff ^ (32 * kk)));
}

// The norm on k-step kk's registers: (x * rrms[row]) * wn[k] in fp32,
// rounded to bf16; rr0 is row g's rrms, rr1 row g + 8's; wk is wn at the
// stage's first column + 2 tq.
__device__ __forceinline__ void norm_a(uint32_t (&a)[4], int kk, const float* wk, float rr0,
                                       float rr1) {
  const float2 w0 = *reinterpret_cast<const float2*>(wk + 16 * kk);
  const float2 w8 = *reinterpret_cast<const float2*>(wk + 16 * kk + 8);
  a[0] = norm2(a[0], rr0, w0);
  a[1] = norm2(a[1], rr1, w0);
  a[2] = norm2(a[2], rr0, w8);
  a[3] = norm2(a[3], rr1, w8);
}

// rrms[r] = 1 / sqrt(mean(x[r]^2) + eps) in fp32, a warp a row, 16-byte loads.
__global__ void __launch_bounds__(32 * RRMS_ROWS)
rrms_kernel(const bf16* __restrict__ x, float* __restrict__ rrms, int N, int D, float eps) {
  const int row = blockIdx.x * RRMS_ROWS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= N) return;
  const bf16* xr = x + (long long)row * D;
  float ss = 0.f;
  for (int c = lane * 8; c < D; c += 256) {
    const uint4 val = *reinterpret_cast<const uint4*>(xr + c);
    const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float f = __bfloat162float(e[t]);
      ss += f * f;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (lane == 0) rrms[row] = 1.f / sqrtf(ss / (float)D + eps);
}

// A row-major bf16 [rows, cols] matrix in boxes of [box_rows, 64], 128-byte
// swizzled; rows past the end read as zeros and are not written.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* base, int rows, int cols,
            int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)KC, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The SMs of the current device, read once a device.
int sm_count(int dev) {
  static int n[MAX_DEVICES] = {};
  if (!n[dev]) cudaDeviceGetAttribute(&n[dev], cudaDevAttrMultiProcessorCount, dev);
  return n[dev];
}

int launch_rrms(const void* x, void* rrms, int N, int D, float eps, cudaStream_t stream) {
  rrms_kernel<<<(N + RRMS_ROWS - 1) / RRMS_ROWS, 32 * RRMS_ROWS, 0, stream>>>(
      (const bf16*)x, (float*)rrms, N, D, eps);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace gemm90
