// The fp32-accurate dense-product pieces for Hopper that the fp32 forms
// #12f norm_qkv, #11f mlp and #2f norm_mlp (mlp_qkv_f32.cu) share, on top of
// sm90_common.cuh's primitives and tf32x3.cuh's split: wgmma m64nNk8 in
// TF32 with fp32 sums (N 128 and 64), A from registers or from shared
// memory, B from a 128-byte swizzled tile; the A fragment of a stage by ldmatrix; the three
// products of 3xTF32; the tensor map of an fp32 matrix in [rows, 32] boxes;
// and the weight-split pass, which writes each weight's TF32 hi and lo
// planes once a call.
//
// An fp32 row of 32 values is 128 bytes, the span of the swizzle, so a
// stage of depth 32 is one box and a k8-step of wgmma is 32 bytes of it,
// as a k16-step of bf16 is (gemm_sm90.cuh): the descriptors, the swizzled
// addresses and ldmatrix's lanes are those of the bf16 kernels. wgmma's
// .tf32 kind takes A and B K-major only; every product here is (x or g
// [rows, K]) against a weight in nn.Linear layout ([out, K]), K-major in
// both.
#pragma once

#include "sm90_common.cuh"  // TMA, mbarriers, ldmatrix, wgmma descriptors and fences
#include "tf32x3.cuh"       // split: x = hi + lo in TF32

namespace gemm_tf32 {
namespace {

using namespace sm90;

constexpr int KC = 32;           // depth of a stage: one 128-byte swizzled row of fp32
constexpr int MAX_DEVICES = 64;  // devices whose SM count and kernel attributes are kept

// d[64, N] (+)= a[64, 8] @ b[8, N] in TF32 for the warpgroup: a from
// registers (mma.m16n8k8's tf32 A layout a warp: a0 (g, t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4)), b through its descriptor; scale_d 0
// overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t (&a)[4], uint64_t desc,
                                         int scale_d);

#define D8(i)                                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// d[64, N] (+)= a[64, 8] @ b[8, N] in TF32 for the warpgroup, a and b
// through their descriptors (K-major); scale_d 0 overwrites d. The
// shared-memory-A route that ops/split_probe.py's smema variant times.
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<128>(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}


#undef D8

// This warp's 16 rows x 32 of the A box at `stage` ([128, 32] fp32,
// 128-byte swizzled), as four k8-steps of the tf32 A layout: ldmatrix's
// 8 x 8 b16 matrices are 8 x 4 fp32 ones, lane l giving the address of row
// (l & 7) + 8 ((l >> 3) & 1) of the warp's 16 and 16-byte chunk l >> 4 of
// the k-step; aoff holds that row's offset with the swizzle's XOR (l & 7)
// and the chunk in bits 4-6, so k-step kk is aoff ^ 32 kk.
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], uint32_t stage, uint32_t aoff) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) ldmatrix_x4(a[kk], stage + (aoff ^ (32 * kk)));
}

// lane's aoff for load_a: warp w's rows 16 w.. of the box
__device__ __forceinline__ uint32_t a_offset(int warp, int lane) {
  return (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * 128 +
         (((lane >> 4) ^ (lane & 7)) << 4);
}

// a k8-step's fp32 A fragment (bits) split in place: a becomes its hi part,
// lo its lo part
__device__ __forceinline__ void split_a(uint32_t (&a)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) tf32x3::split(__uint_as_float(a[i]), a[i], lo[i]);
}

// d += A B in 3xTF32 for one k8-step: A = hi + lo from registers, B's hi
// and lo planes through their descriptors; the small terms first (A_lo B_hi,
// A_hi B_lo, then A_hi B_hi; A_lo B_lo, ~2^-22 of A B, is dropped); scale_d
// 0 overwrites d with the first.
template <int N>
__device__ __forceinline__ void mma3(float* d, const uint32_t (&hi)[4], const uint32_t (&lo)[4],
                                     uint64_t bhi, uint64_t blo, int scale_d) {
  wgmma_rs<N>(d, lo, bhi, scale_d);
  wgmma_rs<N>(d, hi, blo, 1);
  wgmma_rs<N>(d, hi, bhi, 1);
}

// The weight-split pass: three fp32 arrays of n0, n1, n2 values (multiples
// of 4, 16-byte aligned) end to end into hi [n0 + n1 + n2] and lo (the
// same, right after hi), each value x as hi = rna(x), lo = rna(x - hi)
// (tf32x3::split): the planes hold TF32 values, as wgmma reads them.
__global__ void __launch_bounds__(256)
split_kernel(const float4* __restrict__ w0, const float4* __restrict__ w1,
             const float4* __restrict__ w2, long long n0, long long n1, long long n2,
             uint4* __restrict__ hi) {
  const long long total = n0 + n1 + n2;
  uint4* lo = hi + total;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < total; i += gridDim.x * 256LL) {
    const float4 v = i < n0 ? w0[i] : i < n0 + n1 ? w1[i - n0] : w2[i - n0 - n1];
    uint4 h, l;
    tf32x3::split(v.x, h.x, l.x);
    tf32x3::split(v.y, h.y, l.y);
    tf32x3::split(v.z, h.z, l.z);
    tf32x3::split(v.w, h.w, l.w);
    hi[i] = h;
    lo[i] = l;
  }
}

// The SMs of the current device, read once a device.
int sm_count(int dev) {
  static int n[MAX_DEVICES] = {};
  if (!n[dev]) cudaDeviceGetAttribute(&n[dev], cudaDevAttrMultiProcessorCount, dev);
  return n[dev];
}

// The split pass over w0, w1, w2 ([n0], [n1], [n2] fp32; w2 may be null
// with n2 0) into planes (2 (n0 + n1 + n2) fp32: hi, then lo).
int launch_split(const void* w0, long long n0, const void* w1, long long n1, const void* w2,
                 long long n2, void* planes, int sms, cudaStream_t stream) {
  const long long v4 = (n0 + n1 + n2) / 4;
  const long long want = (v4 + 255) / 256;
  const int blocks = (int)(want < 8LL * sms ? want : 8LL * sms);
  split_kernel<<<blocks, 256, 0, stream>>>((const float4*)w0, (const float4*)w1,
                                           (const float4*)w2, n0 / 4, n1 / 4, n2 / 4,
                                           (uint4*)planes);
  return (int)cudaGetLastError();
}

// A row-major fp32 [rows, cols] matrix in boxes of [box_rows, 32], 128-byte
// swizzled; rows past the end read as zeros.
bool encode_f32(EncodeTiled fn, CUtensorMap* map, const void* base, int rows, int cols,
                int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)KC, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
}  // namespace gemm_tf32
