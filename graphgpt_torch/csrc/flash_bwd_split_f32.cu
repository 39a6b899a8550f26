// The split flash attention backward in fp32, for Hopper, and the fp32
// forward on the same body: one kernel body in three roles and two forms.
// The backward is two kernels launched one after the other, flash_dq (with
// delta) then flash_dkv; the forward one.
//
// The single form, #4f flash_dq and #5f flash_dkv, replaces
// graphgpt_tpu/ops/flash_attention.py:602 _dq_kernel_single and :789
// _dkv_kernel_single when they are given fp32 (a `model.dtype: float32`
// model), which _flash_bwd :902 launches instead of the fused kernel when
// bi_split > 0 and P <= 2048. The stream form (STREAM), #7f
// flash_dq_stream and #8f flash_dkv_stream, replaces :645
// _dq_kernel_stream and :835 _dkv_kernel_stream given fp32, which
// _flash_bwd launches above P = 2048 and under GGT_FLASH_MODE=skip at every
// P. The forward role (FWD_ROLE): #1f flash_fwd (single form) replaces :124
// _fwd_kernel_single and #6f flash_fwd_stream (stream form) :177
// _fwd_kernel_stream given fp32, which _flash_fwd :409 launches up to and
// above P = 2048. There p = exp(S - lse) and ds = p * (do v^T - delta)
// stay fp32. The
// bf16 pair and its stream form are csrc/flash_bwd_split.cu. The same
// contract: q (pre-scaled, not rotated), k, v, out, do token-major fp32
// [B, P, H * 64]; cos and sin fp32 [B, P, 64] or null; lse and the
// optional dlse fp32 [B, H, P]; the single form one seg int32 [B, P] and P
// <= MAX_P, the stream form seg_q and seg_k, two arrays (a ring chunk's
// keys carry another chunk's ids; the model passes one array twice), and
// any P. With S = rot(q) rot(k)^T + mask and p = exp(S - lse):
//   flash_fwd: out = softmax(S) v, lse = logsumexp(S), written [B, H, P]
//   flash_dq:  delta = rowsum(do * out) - dlse, written [B, H, P] for
//              flash_dkv; dq = ds rot(k)
//   flash_dkv: dv = p^T do, dk = ds^T rot(q), reading that delta
// in fp32, dq and dk through the inverse rotation; the rotations keep the
// plain version's roundings (each product and sum rounded, no
// contraction). The mask is the segment rule (seg_q[row] == seg_k[col] >
// 0) with the bidirectional, causal or bi-causal rule of flash_common.cuh
// (a split may fall inside a 64-row tile). do is taken as 0 on padded
// query rows (segment 0) before any sum, so that a non-finite value there
// reaches no output; a padded row,
// a query row that sees no key and a key that no query sees give exactly
// 0 (the forward: out 0 and lse -1e30). No atomics: two launches on the
// same inputs give the same bits.
//
// What bounds it on the H100: bytes. At the denoise batch (B 256, P 88,
// H 12) each kernel moves ~429 MB (0.128 ms at 3.35 TB/s) against 2.3 and
// 3.1 GFLOP over the visible pairs (14 and 19 us at 165 TFLOP/s, the
// fp32-accurate rate of 3xTF32); at B 8 x P 1024, 156 MB (0.047 ms)
// against 1.7 and 2.2 GFLOP; at the long-context shape (B 16, P 4096, H
// 12) ~1.25 GB (0.373 ms) against 12-16 GFLOP on ~32-token packed
// segments. The FFMA passes this replaces (flash_bwd_f32.cu's, which keep
// #3f and #10f) reached 8-14% of that bound: synchronous tile loads, a
// block a 64-row tile, each tile's partners loaded again for each of its
// tiles and tested by reading their ids, a delta launch of its own, and an
// FFMA product that reads two shared floats for every four FMAs. The FFMA
// forward that the forward role replaces (flash_fwd_f32.cu, which keeps the
// band form #9f) had the same faults, and reached 8-11% of its bound.
//
// Design: one body, the role choosing the own and visiting tiles; an item
// is 128 own rows of one (batch row, head) (queries in flash_fwd and
// flash_dq, keys in flash_dkv), so that at
// P 88 an item is a whole (row, head) and its partners are read once. The
// kernel is persistent: one CTA an SM walks a contiguous run of items,
// head fastest. A CTA is three warpgroups:
//  - producer warp 8 computes which 64-row visiting tiles meet the item's
//    ids (visiting_mask), TMA-loads the item's own tiles (q, do, out; or
//    k, v; the forward q alone) as [128, 32] boxes, and streams the
//    visiting tiles (k, v; or q, do) as [64, 32] boxes through a ring of
//    STAGES (2; the forward, whose own tiles are one, 3) with full and
//    empty mbarriers; its lanes copy each visiting tile's ids (and lse,
//    delta in flash_dkv) with cp.async into the stage. An fp32 row of 64 is
//    256 bytes and the 128-byte swizzle spans 32 floats, so a tile is two
//    boxes. 3D tensor maps {64 H, P, B}: rows past P arrive as zeros and
//    cost no bytes. Warps 9-11 make the own tiles and each landed stage
//    ready, off the consumers' path: RoPE on the own q (or k) in place,
//    and on each visiting k (or q), in fp32 (cos/sin from global memory);
//    do of padded query rows zeroed (flash_dkv); then each visiting value
//    split once, for every product that reads it, into its TF32 hi (in
//    place) and lo (a plane beside it, the same swizzled layout). They take
//    an item's tile count from the producer's header;
//  - two consumer warpgroups own 64 rows each, a warp 16. A warp takes
//    its own tiles into registers with ldmatrix (flash_dq zeroes do of
//    padded rows and sums delta from do and out) and hands the own buffer
//    back, so that the next item's tiles load under this one's products.
//    Per ready stage, in halves of 32 visiting rows: S = A1 B1^T and dP =
//    A2 B2^T (flash_dkv: S^T and dP^T
//    directly), p = 2^(S log2 e - lse log2 e) and ds branch-free in the
//    accumulators, then dq += ds B1 (dv += p^T B2, dk += ds^T B1). A warp
//    skips a tile its 16 rows cannot meet, and its second half past P.
//    (Finer skips, by 8-row block or by the blocks' ids and the causal
//    bound, measured slower: see products_nt.)
//  - the epilogue applies the inverse rotation and stores each thread's
//    rows straight to global memory (32-byte sectors).
// The forward's consumers (fwd_items) take q into registers split once an
// item, and per ready stage S = q k^T by flash_dq's products (the same
// operands, fragments and order of sums: #4f and #7f recompute the
// forward's S bit for bit), the online softmax in the accumulators over
// the tile's 64 keys (2^(S log2 e - m log2 e), the sums l a thread's
// columns, summed over the quad at the end), then O += p v with p as the A
// operand (acc_as_a) and v's planes as flash_dq's second product reads k's;
// out = O / l and lse = m + log l go straight to global memory. A role of
// this body and not a source of its own: the forward's producer and pass
// warps are flash_dq's, which streams the same k and v tiles, and its own
// tile and first product are flash_dq's; each difference is an if
// constexpr on the role, so that the backward's four kernels compile as
// before and keep their bits.
// The products are 3xTF32 (tf32x3.cuh) on mma.sync m16n8k8, not wgmma.
// wgmma's .tf32 kind takes A and B K-major only, so dq += ds k, dv += p^T
// do, dk += ds^T q and the forward's O += p v would need a transposed copy
// of each visiting tile;
// and the A operands split in registers (64 a product) beside the
// accumulators exceed the consumers' registers, or, split in shared memory,
// its 227 KB. mma.sync reads the A and B fragments of S and dP by ldmatrix
// (a 32-bit element is a pair of 16-bit ones) and those of the second
// products by single loads, conflict-free under the swizzle; the
// accumulators of S and dP serve as the A operand of the second products
// with no shared-memory round trip (acc_as_a). The split costs more than
// the products when every warp splits each B fragment it reads (measured),
// so the pass warps split each visiting value once and the consumers split
// only their A operands. A warp (16 rows) and an
// 8-row block are its units, where a warpgroup's wgmma would compute all
// 64 rows of a partly padded item. setmaxnreg gives the consumers 224
// registers and the producers 56 (from the launch's 168: what the
// producers hand back is what the consumers take, 4 x 112 = 8 x 56 a
// lane). Only the producers' waits time out (4 s, then trap); they wait
// last for every stage to be handed back.
// What the stream form changes, each difference an if constexpr on the
// form, so that the single form compiles as before and keeps its bits:
// the own rows' ids and the visiting rows' ids come from their two arrays
// (flash_fwd and flash_dq: own seg_q, visiting seg_k; flash_dkv: own
// seg_k, visiting
// seg_q), and the producer takes the visiting tiles' segment-id ranges
// from the tile tables (tile_table.cuh), which the entry writes first: one
// int2 a tile, where the single form reads a tile's 64 ids and reduces
// them by shuffles. The visiting tiles of an item go in 64-bit masks of 64
// tiles (walk), counted over every chunk first, so that no P limit
// applies. On one id array both forms walk the same tiles in the same
// order, so flash_fwd gives flash_fwd_stream's bits. The masks stay in
// registers and the tables in global memory
// (L2): flash_dq's shared memory is full. And flash_dq keeps each row's
// ds consistent: the tensor core truncates each product to its
// accumulator's exponent, so S and dP carry a biased error some 10x fp32's,
// and a row's sum of ds, which must equal its dlse, errs by it; a model's
// keys share a large part within a segment, along which dq = ds k (and,
// through the rows, dk's weight gradient) amplifies that error (on an H100
// a long-context fp32 step's q and k weight gradients read ~2e-3 from the
// plain run's, the FFMA passes' ~4e-5). flash_dq also sums p k, and the
// sums of ds and p of each row, and ends with delta' = delta + (sum ds -
// dlse) / sum p, dq -= (delta' - delta) p k, writing delta' for flash_dkv:
// the same function, 0 in exact arithmetic, one more product.

#include "flash_common.cuh"  // DH, the segment-range test, the causal and bi-causal bounds
#include "sm90_common.cuh"   // TMA, mbarriers, the tensor-map encoder
#include "flash_sm90.cuh"    // ex2, LOG2E, the visiting mask, cp.async, lds128/sts128, error codes
#include "tf32x3.cuh"        // the 3xTF32 split and mma
#include "tile_table.cuh"    // the stream form's tile tables and table_mask

#include <type_traits>

namespace split_bwd_f32 {
namespace {

using namespace sm90;
using namespace tf32x3;

enum Form { SINGLE = 0, STREAM = 1 };  // the band form (2) is flash_bwd_f32.cu's
// the own rows and what the kernel computes: flash_dq (own queries),
// flash_dkv (own keys), the forward (own queries)
enum Role { DQ_ROLE = 0, DKV_ROLE = 1, FWD_ROLE = 2 };

constexpr int ROWS = 128;                // own rows of an item: two consumer warpgroups of 64
constexpr int NTHREADS = 384;            // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int CONSUMERS = 256;
constexpr int PASS0 = 288;               // the first thread of the pass warps 9-11
constexpr int OWN_BOX = ROWS * 128;      // a [128, 32] fp32 box, 16 KB
constexpr int OWN_TILE = 2 * OWN_BOX;    // an own [128, 64] tile: columns 0-31, then 32-63
constexpr int VIS_BOX = 64 * 128;        // a [64, 32] fp32 box, 8 KB
constexpr int VIS_TILE = 2 * VIS_BOX;    // a visiting [64, 64] tile (or one of its planes)
constexpr int MAX_P = 2048;              // the single form's: its tiles fit one 32-bit mask

// A visiting tile's row data. seg, lse, delta arrive by cp.async (zeros
// past P); v0, lo, hi are written by producer lane 0.
struct Meta {
  int seg[64];
  float lse[64];
  float delta[64];
  int v0;      // the tile's first row
  int lo, hi;  // its segment-id range (tile_range, or the stream form's table)
  int pad;     // the next stage's Meta 8-byte aligned (int2 reads of seg)
};

// The forward's: ids and the tile's place only (its ring of 3 stages fills
// the shared memory)
struct FwdMeta {
  int seg[64];
  int v0;
  int lo, hi;
  int pad;
};

// Shared memory from a 1024-aligned base: the own tiles (flash_dq: q, do,
// out; flash_dkv: k, v; the forward: q), the ring (per stage B1 hi, B1 lo,
// B2 hi, B2 lo: TMA lands each tile in its hi plane, the pass splits it
// there), the stage metadata, the item header, the barriers. flash_dq:
// 232,056 bytes of the 232,448 a block may have; the forward, three stages:
// 231,328.
template <int ROLE>
struct Layout {
  static constexpr bool FWD = ROLE == FWD_ROLE;
  static constexpr int NOWN = FWD ? 1 : ROLE == DKV_ROLE ? 2 : 3;
  static constexpr int STAGES = FWD ? 3 : 2;
  using M = std::conditional_t<FWD, FwdMeta, Meta>;
  static constexpr int OWN = 0;
  static constexpr int RING = OWN + NOWN * OWN_TILE;
  static constexpr int STAGE = 4 * VIS_TILE;
  static constexpr int META = RING + STAGES * STAGE;
  static constexpr int HDR = META + STAGES * (int)sizeof(M);
  static constexpr int BARS = (HDR + 16 + 7) & ~7;
  // own_full, own_ready, own_empty, ring_full[STAGES], ring_empty[STAGES],
  // ring_ready[STAGES]
  static constexpr int END = BARS + (3 + 3 * STAGES) * 8;
  static constexpr size_t BYTES = 1024 + (size_t)END;
};

struct Args {
  const int* seg;     // [B, P]: the own rows' ids (the single form: every row's)
  const float* lse;   // [B, H, P]
  const float* dlse;  // flash_dq: [B, H, P] or null
  float* delta;       // flash_dq writes it, flash_dkv reads it
  const float* cos;   // [B, P, 64], or null: no RoPE
  const float* sin;
  float* out1;        // dq; or dk; or out (the forward)
  float* out2;        // dv (flash_dkv); or lse [B, H, P] (the forward)
  int B, P, H, causal, bi_split;
  // the stream form: the visiting rows' ids [B, P], and the own and the
  // visiting rows' tile tables [B, ceil(P/64)] (tile_table_kernel)
  const int* segv;
  const int2* tabo;
  const int2* tabv;
};

// The schedule: items (b, 128-row block, h), h fastest; CTA c takes the
// contiguous run [c n / G, (c + 1) n / G).
struct Item {
  int b, h, own0;
};

__device__ __forceinline__ Item decode(int i, int H, int nblk) {
  Item it;
  it.h = i % H;
  const int bb = i / H;
  it.own0 = (bb % nblk) * ROWS;
  it.b = bb / nblk;
  return it;
}

// The visiting tiles of an item, bit vt - vt0 for the tile of rows
// [64 vt, 64 vt + 64): those whose ids meet the own block's (and, causal
// without a split, on its side of the diagonal). The single form: one
// 32-bit mask from the ids (vt0 0, P <= MAX_P); the stream form: a 64-bit
// mask of the tiles [vt0, vt0 + 64) from the tile tables. The producer
// walks the ring by them and writes the count in the item header for the
// other warps. The warp's lanes must all call it.
template <bool DKV, int FORM>
__device__ __forceinline__ auto walk(const Args& a, const Item& it, int nt, bool tri, int lane,
                                     int vt0) {
  if constexpr (FORM == STREAM) {
    const long long t = (long long)it.b * nt;
    return table_mask(a.tabo + t, a.tabv + t, it.own0, nt, tri, DKV, lane, vt0);
  } else {
    return visiting_mask(a.seg + (long long)it.b * a.P, it.own0, a.P, tri, DKV, lane);
  }
}

__device__ __forceinline__ float4 lds_f4(uint32_t addr) {
  const uint4 v = lds128(addr);
  return make_float4(__uint_as_float(v.x), __uint_as_float(v.y), __uint_as_float(v.z),
                     __uint_as_float(v.w));
}
__device__ __forceinline__ uint32_t lds_u(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// RoPE with the plain version's roundings: x at column d < 32 and y at
// d + 32: x' = x c_x + (-y) s_x, y' = y c_y + x s_y, each product and sum
// rounded (no contraction)
__device__ __forceinline__ void rope1(float& x, float& y, float cx, float cy, float sx,
                                      float sy) {
  const float x0 = x;
  x = __fadd_rn(__fmul_rn(x0, cx), __fmul_rn(-y, sx));
  y = __fadd_rn(__fmul_rn(y, cy), __fmul_rn(x0, sy));
}

// The inverse rotation of a gradient with the plain unrotate_tokens'
// roundings: x' = x c_x - (-y) s_x, y' = y c_y - x s_y
__device__ __forceinline__ void unrope1(float& x, float& y, float cx, float cy, float sx,
                                        float sy) {
  const float x0 = x;
  x = __fsub_rn(__fmul_rn(x0, cx), __fmul_rn(-y, sx));
  y = __fsub_rn(__fmul_rn(y, cy), __fmul_rn(x0, sy));
}

// A 16-byte chunk of fp32 values split in place: hi to `at`, lo to `at + lo`
__device__ __forceinline__ void split_chunk(uint32_t at, int lo, float4 v) {
  uint4 h, l;
  split(v.x, h.x, l.x);
  split(v.y, h.y, l.y);
  split(v.z, h.z, l.z);
  split(v.w, h.w, l.w);
  sts128(at, h);
  sts128(at + lo, l);
}

// sc[j] += A1 B1^T and dp[j] += A2 B2^T over the 64 columns for the 8-row
// blocks 4 half + j of a visiting tile (B1's hi plane at t1, B2's at t2,
// each lo plane VIS_TILE on), two blocks at a time: A1, A2 the own
// operands' fragments (fp32 bits), split here; B's hi and lo fragments by
// ldmatrix (boff: the lane's address). The three terms go to the four
// accumulators of a pair in turn, so that no product waits on the one
// before it. No branch inside: a block-by-block skip made ptxas
// reconverge the warp before each ldmatrix and cost more than the
// products it saved (measured).
__device__ __forceinline__ void products_nt(float (&sc)[4][4], float (&dp)[4][4],
                                            const uint32_t (&a1)[8][4],
                                            const uint32_t (&a2)[8][4], uint32_t t1,
                                            uint32_t t2, uint32_t boff, int half) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    uint32_t h1[4], l1[4], h2[4], l2[4];
    split_frag_here(a1[kk], h1, l1);
    split_frag_here(a2[kk], h2, l2);
    const uint32_t at = (kk >> 2) * VIS_BOX + (boff ^ (32 * (kk & 3)));
#pragma unroll
    for (int pb = 0; pb < 2; ++pb) {
      const int nb = 4 * half + 2 * pb;
      uint32_t b1h[4], b1l[4], b2h[4], b2l[4];
      ldmatrix_x4(b1h, t1 + at + nb * 1024);
      ldmatrix_x4(b1l, t1 + VIS_TILE + at + nb * 1024);
      ldmatrix_x4(b2h, t2 + at + nb * 1024);
      ldmatrix_x4(b2l, t2 + VIS_TILE + at + nb * 1024);
      float(&s0)[4] = sc[2 * pb];
      float(&s1)[4] = sc[2 * pb + 1];
      float(&d0)[4] = dp[2 * pb];
      float(&d1)[4] = dp[2 * pb + 1];
      mma_tf32(s0, l1, b1h[0], b1h[1]);
      mma_tf32(s1, l1, b1h[2], b1h[3]);
      mma_tf32(d0, l2, b2h[0], b2h[1]);
      mma_tf32(d1, l2, b2h[2], b2h[3]);
      mma_tf32(s0, h1, b1l[0], b1l[1]);
      mma_tf32(s1, h1, b1l[2], b1l[3]);
      mma_tf32(d0, h2, b2l[0], b2l[1]);
      mma_tf32(d1, h2, b2l[2], b2l[3]);
      mma_tf32(s0, h1, b1h[0], b1h[1]);
      mma_tf32(s1, h1, b1h[2], b1h[3]);
      mma_tf32(d0, h2, b2h[0], b2h[1]);
      mma_tf32(d1, h2, b2h[2], b2h[3]);
    }
  }
}

// acc[nb] += A B over the 8 rows 8 j.. of a visiting plane pair at `at` (hi
// plane; lo VIS_TILE on), for the column blocks nb of one half of the 64: A
// the split accumulator block (acc_as_a), B by single loads (soff: the
// lane's rows 2t, 2t + 1), four blocks' loads before their products
__device__ __forceinline__ void product_nn(float (&acc)[8][4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t at, uint32_t s0,
                                           uint32_t s1, int nb0) {
  uint32_t bh[4][2], bl[4][2];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int nb = nb0 + q;
    const uint32_t p = at + (nb >> 2) * VIS_BOX;
    const uint32_t o0 = s0 ^ (32 * (nb & 3)), o1 = s1 ^ (32 * (nb & 3));
    bh[q][0] = lds_u(p + o0);
    bh[q][1] = lds_u(p + o1);
    bl[q][0] = lds_u(p + VIS_TILE + o0);
    bl[q][1] = lds_u(p + VIS_TILE + o1);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) mma_tf32(acc[nb0 + q], al, bh[q][0], bh[q][1]);
#pragma unroll
  for (int q = 0; q < 4; ++q) mma_tf32(acc[nb0 + q], ah, bl[q][0], bl[q][1]);
#pragma unroll
  for (int q = 0; q < 4; ++q) mma_tf32(acc[nb0 + q], ah, bh[q][0], bh[q][1]);
}

// The forward's sc[j] += q k^T over the 64 columns for the 8-row blocks 4
// half + j of a visiting tile (k's hi plane at t1, its lo plane VIS_TILE
// on): products_nt's S without dP, q split once an item (qh, ql). The same
// fragments, terms and order of sums as products_nt gives flash_dq's S, so
// that the two compute the same bits.
__device__ __forceinline__ void products_s(float (&sc)[4][4], const uint32_t (&qh)[8][4],
                                           const uint32_t (&ql)[8][4], uint32_t t1,
                                           uint32_t boff, int half) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint32_t at = (kk >> 2) * VIS_BOX + (boff ^ (32 * (kk & 3)));
#pragma unroll
    for (int pb = 0; pb < 2; ++pb) {
      const int nb = 4 * half + 2 * pb;
      uint32_t bh[4], bl[4];
      ldmatrix_x4(bh, t1 + at + nb * 1024);
      ldmatrix_x4(bl, t1 + VIS_TILE + at + nb * 1024);
      float(&s0)[4] = sc[2 * pb];
      float(&s1)[4] = sc[2 * pb + 1];
      mma_tf32(s0, ql[kk], bh[0], bh[1]);
      mma_tf32(s1, ql[kk], bh[2], bh[3]);
      mma_tf32(s0, qh[kk], bl[0], bl[1]);
      mma_tf32(s1, qh[kk], bl[2], bl[3]);
      mma_tf32(s0, qh[kk], bh[0], bh[1]);
      mma_tf32(s1, qh[kk], bh[2], bh[3]);
    }
  }
}

// The max or the sum of a row's values over its quad (the four lanes that
// hold a row of an accumulator block)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int ROLE, int FORM>
__global__ void __launch_bounds__(NTHREADS, 1)
split_f32_kernel(const __grid_constant__ CUtensorMap own1, const __grid_constant__ CUtensorMap own2,
                 const __grid_constant__ CUtensorMap own3,
                 const __grid_constant__ CUtensorMap vis1,
                 const __grid_constant__ CUtensorMap vis2, const Args args) {
  constexpr bool DKV = ROLE == DKV_ROLE, FWD = ROLE == FWD_ROLE;
  using L = Layout<ROLE>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  auto* meta = reinterpret_cast<typename L::M*>(base + L::META);
  volatile int* hdr = reinterpret_cast<volatile int*>(base + L::HDR);
  const uint32_t sbase = saddr(base), sbars = sbase + L::BARS;
  const uint32_t own_full = sbars, own_ready = sbars + 8, own_empty = sbars + 16;
  auto ring_full = [=](int s) { return sbars + 24 + 8 * s; };
  auto ring_empty = [=](int s) { return sbars + 24 + 8 * (STAGES + s); };
  auto ring_ready = [=](int s) { return sbars + 24 + 8 * (2 * STAGES + s); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int P = args.P, H = args.H;
  const int nblk = (P + ROWS - 1) / ROWS, nt = (P + 63) / 64;
  // this CTA's run of items [first, last), computed where each role starts:
  // a value live from here into both roles takes a register the producers
  // hand back, and ptxas spilled it
  auto item_run = [&](int& first, int& last) {
    unsigned cta;
    asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(cta));
    const long long items = (long long)args.B * nblk * H;
    first = (int)(cta * items / gridDim.x);
    last = (int)((cta + 1) * items / gridDim.x);
  };
  const bool tri = args.causal && args.bi_split == 0;
  const bool rope = args.cos != nullptr;
  // the stream form's flash_dq writes a delta consistent with its own p and
  // dP (see the epilogue)
  constexpr bool CONSISTENT = ROLE == DQ_ROLE && FORM == STREAM;

  if (tid == 0) {
    mbar_init(own_full, 1);
    mbar_init(own_ready, 3);  // the three pass warps
    mbar_init(own_empty, 8);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(ring_full(s), 33);  // 32 lanes' cp.async and lane 0's expect_tx
      mbar_init(ring_empty(s), 8);  // every consumer warp
      mbar_init(ring_ready(s), 3);  // the three pass warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    int first, last;
    item_run(first, last);
    if (warp == 8) {
      // the own tiles and the ring
      int stage = 0;
      uint32_t phase = 0, ophase = 0;
      for (int i = first; i < last; ++i) {
        const Item it = decode(i, H, nblk);
        const int* segb = args.seg + (long long)it.b * P;
        // the visiting rows' ids: the stream form's second array
        const int* segv = FORM == STREAM ? args.segv + (long long)it.b * P : segb;
        const long long rowbase = ((long long)it.b * H + it.h) * P;
        // the single form's mask, or the stream form's first chunk, the
        // tiles of every chunk counted first
        auto mask = walk<DKV, FORM>(args, it, nt, tri, lane, 0);
        int n;
        if constexpr (FORM == STREAM) {
          n = __popcll(mask);
          for (int c = 64; c < nt; c += 64)
            n += __popcll(walk<DKV, FORM>(args, it, nt, tri, lane, c));
        } else {
          n = __popc(mask);
        }
        mbar_wait_or_trap(own_empty, ophase ^ 1);
        if (lane == 0) {
          hdr[0] = n;
          mbar_expect_tx(own_full, L::NOWN * OWN_TILE);
          const CUtensorMap* maps[3] = {&own1, &own2, &own3};
#pragma unroll
          for (int o = 0; o < L::NOWN; ++o)
#pragma unroll
            for (int cb = 0; cb < 2; ++cb)
              tma_load_3d(sbase + L::OWN + o * OWN_TILE + cb * OWN_BOX, maps[o], own_full,
                          it.h * DH + 32 * cb, it.own0, it.b);
        }
        ophase ^= 1;
        // visiting tile vt into the next stage
        auto visit = [&](int vt) {
          const int v0 = vt * 64;
          mbar_wait_or_trap(ring_empty(stage), phase ^ 1);
          auto& m = meta[stage];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = lane + 32 * e, p = v0 + r;
            const bool ok = p < P;
            cp_async4(&m.seg[r], segv + (ok ? p : 0), ok);
            if constexpr (DKV) {
              cp_async4(&m.lse[r], args.lse + rowbase + (ok ? p : 0), ok);
              cp_async4(&m.delta[r], args.delta + rowbase + (ok ? p : 0), ok);
            }
          }
          cp_async_arrive(ring_full(stage));
          int lo, hi;
          if constexpr (FORM == STREAM) {
            const int2 r = args.tabv[(long long)it.b * nt + vt];
            lo = r.x;
            hi = r.y;
          } else {
            tile_range(segb, v0, P, lane, &lo, &hi);
          }
          if (lane == 0) {
            m.v0 = v0;
            m.lo = lo;
            m.hi = hi;
            const uint32_t bar = ring_full(stage);
            const uint32_t dst = sbase + L::RING + stage * L::STAGE;
            mbar_expect_tx(bar, 2 * VIS_TILE);
#pragma unroll
            for (int cb = 0; cb < 2; ++cb) {
              tma_load_3d(dst + cb * VIS_BOX, &vis1, bar, it.h * DH + 32 * cb, v0, it.b);
              tma_load_3d(dst + 2 * VIS_TILE + cb * VIS_BOX, &vis2, bar, it.h * DH + 32 * cb, v0,
                          it.b);
            }
          }
          __syncwarp();
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        };
        if constexpr (FORM == STREAM) {
          for (int c = 0; c < nt; c += 64) {
            if (c > 0) mask = walk<DKV, FORM>(args, it, nt, tri, lane, c);
            for (; mask; mask &= mask - 1) visit(c + __ffsll((long long)mask) - 1);
          }
        } else {
          for (; mask; mask &= mask - 1) visit(__ffs(mask) - 1);
        }
      }
      // every stage and the own buffer handed back: the consumers are past
      // their last product
      for (int s = 0; s < STAGES; ++s) {
        mbar_wait_or_trap(ring_empty(stage), phase ^ 1);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      mbar_wait_or_trap(own_empty, ophase ^ 1);
    } else {
      // warps 9-11: the pass over the own tiles and each landed stage, off
      // the consumers' path. A unit is the 16-byte chunk c of one row in
      // both boxes (columns 4c.. and 32 + 4c.., at the same offset); 96
      // threads take the units in turn.
      const int u0 = tid - PASS0;
      int stage = 0;
      uint32_t phase = 0, ophase = 0;
      // RoPE in fp32 on the chunk pair x (columns 4c..), y (32 + 4c..) of
      // row `row` of batch row b
      auto rotate = [&](float4& x, float4& y, int b, int row, int c) {
        const float* cs = args.cos + ((long long)b * P + row) * DH + 4 * c;
        const float* sn = args.sin + ((long long)b * P + row) * DH + 4 * c;
        const float4 cx = *reinterpret_cast<const float4*>(cs);
        const float4 cy = *reinterpret_cast<const float4*>(cs + 32);
        const float4 sx = *reinterpret_cast<const float4*>(sn);
        const float4 sy = *reinterpret_cast<const float4*>(sn + 32);
        rope1(x.x, y.x, cx.x, cy.x, sx.x, sy.x);
        rope1(x.y, y.y, cx.y, cy.y, sx.y, sy.y);
        rope1(x.z, y.z, cx.z, cy.z, sx.z, sy.z);
        rope1(x.w, y.w, cx.w, cy.w, sx.w, sy.w);
      };
      for (int i = first; i < last; ++i) {
        const Item it = decode(i, H, nblk);
        // the own q (or k) rotated in place: 128 rows x 8 units
        mbar_wait(own_full, ophase);
        ophase ^= 1;
        const int nv = hdr[0];  // the item's visiting tiles (stable until own_empty)
        if (rope) {
#pragma unroll 1
          for (int u = u0; u < ROWS * 8; u += 96) {
            const int r = u >> 3, c = u & 7;
            if (it.own0 + r >= P) continue;
            const uint32_t x_at = sbase + L::OWN + r * 128 + ((c ^ (r & 7)) << 4);
            float4 x = lds_f4(x_at), y = lds_f4(x_at + OWN_BOX);
            rotate(x, y, it.b, it.own0 + r, c);
            sts128(x_at, make_uint4(__float_as_uint(x.x), __float_as_uint(x.y),
                                    __float_as_uint(x.z), __float_as_uint(x.w)));
            sts128(x_at + OWN_BOX, make_uint4(__float_as_uint(y.x), __float_as_uint(y.y),
                                              __float_as_uint(y.z), __float_as_uint(y.w)));
          }
          fence_proxy_async();  // before the own buffer's next TMA load writes it again
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(own_ready);
        for (int n = nv; n > 0; --n) {
          mbar_wait(ring_full(stage), phase);
          const auto& m = meta[stage];
          const uint32_t st = sbase + L::RING + stage * L::STAGE;
#pragma unroll 1
          for (int u = u0; u < 1024; u += 96) {
            const int two = u >> 9, r = (u >> 3) & 63, c = u & 7;
            const uint32_t x_at = st + 2 * two * VIS_TILE + r * 128 + ((c ^ (r & 7)) << 4);
            const uint32_t y_at = x_at + VIS_BOX;
            float4 x = lds_f4(x_at), y = lds_f4(y_at);
            if (two == 0 && rope && m.v0 + r < P) rotate(x, y, it.b, m.v0 + r, c);  // k (or q)
            if (DKV && two == 1 && m.seg[r] == 0)  // do of a padded query row
              x = y = make_float4(0.f, 0.f, 0.f, 0.f);
            split_chunk(x_at, VIS_TILE, x);
            split_chunk(y_at, VIS_TILE, y);
          }
          fence_proxy_async();  // before the stage's next TMA load writes it again
          __syncwarp();
          if (lane == 0) mbar_arrive(ring_ready(stage));
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 16 rows of each item a warp, rows
  // [16 w', 16 w' + 16) with w' = (w + 2 (i & 1)) mod 8 for item i: a
  // partly padded item (P 88: six live blocks of 16) loads SMs' four
  // sub-partitions (warp w runs on w mod 4) 2, 2, 1, 1 and the next item
  // 1, 1, 2, 2
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
  const int g = lane >> 2, t = lane & 3;
  auto warp_row = [&](int i) { return ((warp + 2 * (i & 1)) & 7) * 16; };
  // ldmatrix of an own A fragment (rows wrow.., k-step kk: a0..a3 at rows
  // g, g + 8 and columns 8 kk + t, 8 kk + 4 + t): lane l gives row
  // (l & 7) + 8 ((l >> 3) & 1) and chunk 2 (kk & 3) + (l >> 4) of box
  // kk / 4; the swizzle XORs the chunk with row & 7 = l & 7
  const uint32_t alane = ((lane & 7) + ((lane >> 3) & 1) * 8) * 128 +
                         (((lane >> 4) ^ (lane & 7)) << 4);
  // ldmatrix of the B fragments of two 8-row blocks nb, nb + 1 of a
  // visiting plane at k-step kk: lane l gives row 8 nb + (l & 7) + 8 (l >> 4)
  // and chunk 2 (kk & 3) + ((l >> 3) & 1)
  const uint32_t boff = ((lane & 7) + (lane >> 4) * 8) * 128 +
                        ((((lane >> 3) & 1) ^ (lane & 7)) << 4);
  // the single loads of a visiting plane as the B of the second products:
  // rows 8 j + 2t + e (e = 0, 1), column 8 nb + g
  uint32_t soff[2];
#pragma unroll
  for (int e = 0; e < 2; ++e)
    soff[e] = (2 * t + e) * 128 + ((((g >> 2) ^ (2 * t + e)) << 4) | ((g & 3) * 4));
  int stage = 0;
  uint32_t phase = 0, ophase = 0;
  int first, last;
  item_run(first, last);

  if constexpr (FWD) {
    // the forward: out and lse of the warp's 16 query rows of each item
    for (int i = first; i < last; ++i) {
      const Item it = decode(i, H, nblk);
      const int* segb = args.seg + (long long)it.b * P;
      const int wrow = warp_row(i);  // the warp's first row within the item
      const int wrow_abs = it.own0 + wrow;
      const uint32_t aoff = wrow * 128 + alane;
      const int r0 = wrow_abs + g, r1 = r0 + 8;  // this thread's own rows
      const int s0 = r0 < P ? segb[r0] : 0, s1 = r1 < P ? segb[r1] : 0;
      // the id range of the warp's 16 rows
      const int rl = wrow_abs + (lane & 15);
      const int sl = rl < P ? segb[rl] : 0;
      const int lo = (int)__reduce_min_sync(0xffffffffu, sl > 0 ? (unsigned)sl : 0x7fffffffu);
      const int hi = (int)__reduce_max_sync(0xffffffffu, (unsigned)max(sl, 0));
      const int lim0 = visible_cols(r0, args.causal, args.bi_split, P);
      const int lim1 = visible_cols(r1, args.causal, args.bi_split, P);
      const int key0 = s0 > 0 ? s0 : -1, key1 = s1 > 0 ? s1 : -1;
      // q, rotated by the pass warps, split once for every tile of the item
      mbar_wait(own_full, ophase);
      mbar_wait(own_ready, ophase);
      ophase ^= 1;
      const int nv = hdr[0];
      uint32_t qh[8][4], ql[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, sbase + L::OWN + (kk >> 2) * OWN_BOX + (aoff ^ (32 * (kk & 3))));
        split_frag(a, qh[kk], ql[kk]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(own_empty);

      // O in the accumulator layout (block j: columns 8 j + 2t, + 1 of rows
      // g and g + 8); m, the rows' running max, and l, the sums of
      // 2^(S log2 e - m log2 e) over this thread's columns
      float o[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
      float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
      for (int s = 0; s < nv; ++s) {
        mbar_wait(ring_full(stage), phase);
        mbar_wait(ring_ready(stage), phase);
        const auto& m = meta[stage];
        const int v0 = m.v0;
        const uint32_t sb = sbase + L::RING + stage * L::STAGE;  // k hi, lo; v hi, lo
        const bool skip = ranges_miss(lo, hi, m.lo, m.hi) || (tri && v0 > wrow_abs + 15);
        if (!skip) {
          // S of the tile's 64 keys by halves (block j of the tile: sc[j /
          // 4][j % 4]), a half past P left 0 (its keys masked)
          float sc[2][4][4];
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[j >> 2][j & 3][e] = 0.f;
          const bool two = v0 + 32 < P;
          products_s(sc[0], qh, ql, sb, boff, 0);
          if (two) products_s(sc[1], qh, ql, sb, boff, 1);
          // the mask (a masked logit to -inf), the rows' new max
          float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = 8 * j + 2 * t;
            const int2 sv = *reinterpret_cast<const int2*>(&m.seg[c]);
            float(&cj)[4] = sc[j >> 2][j & 3];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = e < 2 ? key0 : key1, lim = e < 2 ? lim0 : lim1;
              const bool ok = ((e & 1) ? sv.y : sv.x) == key && v0 + c + (e & 1) < lim;
              cj[e] = ok ? cj[e] : -INFINITY;
              if (e < 2) x0 = fmaxf(x0, cj[e]);
              else x1 = fmaxf(x1, cj[e]);
            }
          }
          const float n0 = fmaxf(m0, quad_max(x0)), n1 = fmaxf(m1, quad_max(x1));
          // the exponent's offset (0 while a row has seen no key), and the
          // scale of the sums so far: exactly 1 where the max stays
          const float b0 = n0 == -INFINITY ? 0.f : __fmul_rn(n0, LOG2E);
          const float b1 = n1 == -INFINITY ? 0.f : __fmul_rn(n1, LOG2E);
          const float a0 = ex2(__fsub_rn(__fmul_rn(m0, LOG2E), b0));
          const float a1 = ex2(__fsub_rn(__fmul_rn(m1, LOG2E), b1));
          m0 = n0;
          m1 = n1;
          float p0 = 0.f, p1 = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float(&cj)[4] = sc[j >> 2][j & 3];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              // branch-free: 2^-inf is 0
              cj[e] = ex2(fmaf(cj[e], LOG2E, -(e < 2 ? b0 : b1)));
              if (e < 2) p0 += cj[e];
              else p1 += cj[e];
            }
            o[j][0] *= a0;
            o[j][1] *= a0;
            o[j][2] *= a1;
            o[j][3] *= a1;
          }
          l0 = fmaf(l0, a0, p0);
          l1 = fmaf(l1, a1, p1);
          // O += p v over the tile's keys, 8 at a time (a half past P
          // holds p 0)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (j >= 4 && !two) break;
            uint32_t ph[4], pl[4];
            acc_as_a(sc[j >> 2][j & 3], ph, pl);
            const uint32_t at = sb + 2 * VIS_TILE + j * 1024;
            product_nn(o, ph, pl, at, soff[0], soff[1], 0);
            product_nn(o, ph, pl, at, soff[0], soff[1], 4);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(ring_empty(stage));
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      // epilogue: out = O / l and lse = m + log l of each live row; a
      // padded row and one that saw no key give 0 and -1e30
      l0 = quad_sum(l0);
      l1 = quad_sum(l1);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        if (row >= P) continue;
        const float l = r ? l1 : l0, mx = r ? m1 : m0;
        const bool live = (r ? s1 : s0) > 0 && l > 0.f;
        const float inv = live ? 1.f / l : 0.f;
        const long long o_at = ((long long)it.b * P + row) * H * DH + it.h * DH + 2 * t;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(args.out1 + o_at + 8 * j) =
              make_float2(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
        if (t == 0)
          args.out2[((long long)it.b * H + it.h) * P + row] = live ? mx + logf(l) : NEG;
      }
    }
  } else {
    // the ids of this thread's own rows, the id range of the warp's 16 rows,
    // and (flash_dq) the rows' lse and dlse: loaded an item ahead, so that
    // their latency hides under the item before (flash_dkv and the stream
    // form's flash_dq: at the item's start, where their registers are free)
    struct Rows {
      int s0, s1, lo, hi;
      float lse0, lse1, dlse0, dlse1;
    };
    auto load_rows = [&](int i) {
      Rows r{};
      const Item it = decode(i, H, nblk);
      const int* segb = args.seg + (long long)it.b * P;
      const long long rowbase = ((long long)it.b * H + it.h) * P;
      const int wrow = warp_row(i);
      const int r0 = it.own0 + wrow + g, r1 = r0 + 8, rl = it.own0 + wrow + (lane & 15);
      r.s0 = r0 < P ? segb[r0] : 0;
      r.s1 = r1 < P ? segb[r1] : 0;
      const int sl = rl < P ? segb[rl] : 0;
      r.lo = (int)__reduce_min_sync(0xffffffffu, sl > 0 ? (unsigned)sl : 0x7fffffffu);
      r.hi = (int)__reduce_max_sync(0xffffffffu, (unsigned)max(sl, 0));
      if (!DKV) {
        r.lse0 = r0 < P ? args.lse[rowbase + r0] : 0.f;
        r.lse1 = r1 < P ? args.lse[rowbase + r1] : 0.f;
        if (args.dlse != nullptr) {
          r.dlse0 = r0 < P ? args.dlse[rowbase + r0] : 0.f;
          r.dlse1 = r1 < P ? args.dlse[rowbase + r1] : 0.f;
        }
      }
      return r;
    };
    constexpr bool AHEAD = !DKV && !CONSISTENT;
    Rows next = AHEAD && first < last ? load_rows(first) : Rows{};

    for (int i = first; i < last; ++i) {
      const Rows rows = AHEAD ? next : load_rows(i);
      if (AHEAD && i + 1 < last) next = load_rows(i + 1);
      const Item it = decode(i, H, nblk);
      const long long rowbase = ((long long)it.b * H + it.h) * P;
      const int wrow = warp_row(i);  // the warp's first row within the item
      const int wrow_abs = it.own0 + wrow;
      const uint32_t aoff = wrow * 128 + alane;
      const int r0 = wrow_abs + g, r1 = r0 + 8;  // this thread's own rows
      const int s0 = rows.s0, s1 = rows.s1;
      // own queries see the visiting columns [0, lim); own keys are seen by
      // the visiting rows [lim, P)
      const int lim0 = DKV ? first_row(r0, args.causal, args.bi_split, P)
                           : visible_cols(r0, args.causal, args.bi_split, P);
      const int lim1 = DKV ? first_row(r1, args.causal, args.bi_split, P)
                           : visible_cols(r1, args.causal, args.bi_split, P);
      // a row's segment id, the key a visiting column must match; -1 (no
      // match) for a padded row
      const int key0 = s0 > 0 ? s0 : -1, key1 = s1 > 0 ? s1 : -1;
      // flash_dq: lse log2(e) and delta of the own rows
      const float l2e0 = rows.lse0 * LOG2E, l2e1 = rows.lse1 * LOG2E;
      float dl0 = 0.f, dl1 = 0.f;
      // the stream form's flash_dq: the sums over this thread's columns of ds
      // and of p for rows r0, r1 (see the epilogue)
      float rs0 = 0.f, rs1 = 0.f, ps0 = 0.f, ps1 = 0.f;
      // the own tiles, q (or k) rotated by the pass warps
      mbar_wait(own_full, ophase);
      mbar_wait(own_ready, ophase);
      ophase ^= 1;
      const int nv = hdr[0];
      // the own A operands as fp32 bits: q and do (flash_dq), k and v (flash_dkv)
      uint32_t a1[8][4], a2[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint32_t at = (kk >> 2) * OWN_BOX + (aoff ^ (32 * (kk & 3)));
        ldmatrix_x4(a1[kk], sbase + L::OWN + at);
        ldmatrix_x4(a2[kk], sbase + L::OWN + OWN_TILE + at);
      }
      if (!DKV) {
        // delta = rowsum(do * out) - dlse for rows r0, r1 (a quad holds a row)
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          uint32_t o[4];
          ldmatrix_x4(o, sbase + L::OWN + 2 * OWN_TILE + (kk >> 2) * OWN_BOX +
                             (aoff ^ (32 * (kk & 3))));
          sum0 += __uint_as_float(a2[kk][0]) * __uint_as_float(o[0]) +
                  __uint_as_float(a2[kk][2]) * __uint_as_float(o[2]);
          sum1 += __uint_as_float(a2[kk][1]) * __uint_as_float(o[1]) +
                  __uint_as_float(a2[kk][3]) * __uint_as_float(o[3]);
        }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
          sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
        }
        dl0 = (s0 > 0 ? sum0 : 0.f) - rows.dlse0;
        dl1 = (s1 > 0 ? sum1 : 0.f) - rows.dlse1;
        if (!CONSISTENT && t == 0) {
          if (r0 < P) args.delta[rowbase + r0] = dl0;
          if (r1 < P) args.delta[rowbase + r1] = dl1;
        }
        // do of a padded row takes part in no product
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          if (s0 == 0) a2[kk][0] = a2[kk][2] = 0u;
          if (s1 == 0) a2[kk][1] = a2[kk][3] = 0u;
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(own_empty);

      // flash_dq: dq; flash_dkv: dk (acc1) and dv (acc2); 8 column blocks of
      // 8 in the accumulator layout
      float acc1[8][4], acc2[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc1[j][e] = acc2[j][e] = 0.f;

      for (int s = 0; s < nv; ++s) {
        mbar_wait(ring_full(stage), phase);
        mbar_wait(ring_ready(stage), phase);
        const auto& m = meta[stage];
        const int v0 = m.v0;
        const uint32_t sb = sbase + L::RING + stage * L::STAGE;  // B1 hi, lo; B2 hi, lo
        const bool skip = ranges_miss(rows.lo, rows.hi, m.lo, m.hi) ||
                          (tri && (DKV ? v0 + 63 < wrow_abs : v0 > wrow_abs + 15));
        if (!skip) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            if (v0 + 32 * half >= P) continue;  // the half holds no row before P
            // S (S^T) and dP (dP^T) of visiting rows [32 half, 32 half + 32)
            float sc[4][4], dp[4][4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
            products_nt(sc, dp, a1, a2, sb, sb + 2 * VIS_TILE, boff, half);
            // p and ds in the accumulator layout (block j: columns 8 j + 2t,
            // + 1 of rows g and g + 8), in place of S and dP
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int c = 32 * half + 8 * j + 2 * t;
              const int2 sv = *reinterpret_cast<const int2*>(&m.seg[c]);
              float lc0 = 0.f, lc1 = 0.f, dc0 = 0.f, dc1 = 0.f;
              if (DKV) {
                const float2 l2 = *reinterpret_cast<const float2*>(&m.lse[c]);
                const float2 d2 = *reinterpret_cast<const float2*>(&m.delta[c]);
                lc0 = l2.x * LOG2E, lc1 = l2.y * LOG2E, dc0 = d2.x, dc1 = d2.y;
              }
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int key = e < 2 ? key0 : key1, lim = e < 2 ? lim0 : lim1;
                const int col = v0 + c + (e & 1);
                const bool ok = ((e & 1) ? sv.y : sv.x) == key && (DKV ? col >= lim : col < lim);
                const float l2e = DKV ? ((e & 1) ? lc1 : lc0) : (e < 2 ? l2e0 : l2e1);
                const float del = DKV ? ((e & 1) ? dc1 : dc0) : (e < 2 ? dl0 : dl1);
                // branch-free: a masked logit goes to -inf, whose 2^ is 0
                const float pe = ex2(ok ? fmaf(sc[j][e], LOG2E, -l2e) : -INFINITY);
                dp[j][e] = ok ? pe * (dp[j][e] - del) : 0.f;
                sc[j][e] = pe;
                if (CONSISTENT) {
                  if (e < 2) {
                    rs0 += dp[j][e];
                    ps0 += pe;
                  } else {
                    rs1 += dp[j][e];
                    ps1 += pe;
                  }
                }
              }
            }
            // the second products over the visiting rows of this half:
            // flash_dq dq += ds B1 (the stream form also p B1); flash_dkv
            // dk += ds^T B1, dv += p^T B2
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int nbk = 4 * half + j;
              uint32_t dh[4], dl[4];
              acc_as_a(dp[j], dh, dl);
              const uint32_t at = sb + nbk * 1024;
              product_nn(acc1, dh, dl, at, soff[0], soff[1], 0);
              product_nn(acc1, dh, dl, at, soff[0], soff[1], 4);
              if (DKV || CONSISTENT) {
                const uint32_t b = DKV ? at + 2 * VIS_TILE : at;
                uint32_t ph[4], pl[4];
                acc_as_a(sc[j], ph, pl);
                product_nn(acc2, ph, pl, b, soff[0], soff[1], 0);
                product_nn(acc2, ph, pl, b, soff[0], soff[1], 4);
              }
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(ring_empty(stage));
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      // epilogue: the inverse rotation of dq (dk) (blocks j and j + 4 hold
      // columns d and d + 32), then each thread's rows straight to global
      // memory. The item is decoded again from an opaque copy of its index:
      // an address kept from the item's start across the tile loop took a
      // register the products need (ptxas spilled it)
      int ie = i;
      asm volatile("" : "+r"(ie));
      const Item ite = decode(ie, H, nblk);
      if (CONSISTENT) {
        // delta made consistent with this kernel's own p and dP (see the
        // header): delta' = delta + (rowsum ds - dlse) / rowsum p, dq -=
        // (delta' - delta) rowsum(p k); flash_dkv reads delta'
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          rs0 += __shfl_xor_sync(0xffffffffu, rs0, o);
          rs1 += __shfl_xor_sync(0xffffffffu, rs1, o);
          ps0 += __shfl_xor_sync(0xffffffffu, ps0, o);
          ps1 += __shfl_xor_sync(0xffffffffu, ps1, o);
        }
        // dlse read again here, not kept across the tile loop, where the
        // registers run short (the first build of these sums spilled)
        const long long rb = ((long long)ite.b * H + ite.h) * P;
        const int row0 = ite.own0 + warp_row(ie) + g;
        const bool in0 = row0 < P, in1 = row0 + 8 < P, ld = args.dlse != nullptr;
        const float dlse0 = ld && in0 ? args.dlse[rb + row0] : 0.f;
        const float dlse1 = ld && in1 ? args.dlse[rb + row0 + 8] : 0.f;
        const float c0 = ps0 > 0.f ? (rs0 - dlse0) / ps0 : 0.f;
        const float c1 = ps1 > 0.f ? (rs1 - dlse1) / ps1 : 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc1[j][0] = fmaf(-c0, acc2[j][0], acc1[j][0]);
          acc1[j][1] = fmaf(-c0, acc2[j][1], acc1[j][1]);
          acc1[j][2] = fmaf(-c1, acc2[j][2], acc1[j][2]);
          acc1[j][3] = fmaf(-c1, acc2[j][3], acc1[j][3]);
        }
        if (t == 0) {
          if (in0) args.delta[rb + row0] = dl0 + c0;
          if (in1) args.delta[rb + row0 + 8] = dl1 + c1;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = ite.own0 + warp_row(ie) + g + 8 * r;
        if (row >= P) continue;
        if (rope) {
          const long long ct = ((long long)ite.b * P + row) * DH + 2 * t;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 cx = *reinterpret_cast<const float2*>(args.cos + ct + 8 * j);
            const float2 cy = *reinterpret_cast<const float2*>(args.cos + ct + 8 * j + 32);
            const float2 sx = *reinterpret_cast<const float2*>(args.sin + ct + 8 * j);
            const float2 sy = *reinterpret_cast<const float2*>(args.sin + ct + 8 * j + 32);
            unrope1(acc1[j][2 * r], acc1[j + 4][2 * r], cx.x, cy.x, sx.x, sy.x);
            unrope1(acc1[j][2 * r + 1], acc1[j + 4][2 * r + 1], cx.y, cy.y, sx.y, sy.y);
          }
        }
        const long long o = ((long long)ite.b * P + row) * H * DH + ite.h * DH + 2 * t;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          *reinterpret_cast<float2*>(args.out1 + o + 8 * j) =
              make_float2(acc1[j][2 * r], acc1[j][2 * r + 1]);
          if (DKV)
            *reinterpret_cast<float2*>(args.out2 + o + 8 * j) =
                make_float2(acc2[j][2 * r], acc2[j][2 * r + 1]);
        }
      }
    }
  }
}

// An fp32 [B, P, width] tensor as a 3D map {width, P, B} in [rows, 32]
// boxes, 128-byte swizzled; rows past P read as zeros.
bool encode_f32(EncodeTiled fn, CUtensorMap* map, const void* base, int B, int P, int width,
                int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)P, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)width * 4, (cuuint64_t)width * 4 * P};
  const cuuint32_t box[3] = {32, (cuuint32_t)rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The launch: tensors in the roles of the ROLE kernel (own1..3, vis1, vis2;
// own3 null in flash_dkv, own2 and own3 in the forward); one CTA an SM, at
// most one an item.
template <int ROLE, int FORM>
int launch(const void* own1, const void* own2, const void* own3, const void* vis1,
           const void* vis2, const Args& args, cudaStream_t stream) {
  if (FORM == SINGLE && args.P > MAX_P) return ERR_P;
  if (args.B == 0 || args.P == 0 || args.H == 0) return 0;
  static bool configured[MAX_DEVICES] = {};
  static int sms[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return ERR_DEVICE;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(split_f32_kernel<ROLE, FORM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Layout<ROLE>::BYTES);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  const EncodeTiled fn = encode_fn();
  if (!fn) return ERR_NO_ENCODE;
  const int B = args.B, P = args.P, W = args.H * DH;
  CUtensorMap m[5] = {};  // a null tensor's map is not read
  const void* tok[5] = {own1, own2, own3, vis1, vis2};
  const int rows[5] = {ROWS, ROWS, ROWS, 64, 64};
  for (int i = 0; i < 5; ++i)
    if (tok[i] != nullptr && !encode_f32(fn, &m[i], tok[i], B, P, W, rows[i])) return ERR_ENCODE;
  const int items = B * ((P + ROWS - 1) / ROWS) * args.H;
  const int grid = items < sms[dev] ? items : sms[dev];
  split_f32_kernel<ROLE, FORM><<<grid, NTHREADS, Layout<ROLE>::BYTES, stream>>>(
      m[0], m[1], m[2], m[3], m[4], args);
  return (int)cudaGetLastError();
}

// The stream form's launch: the tile tables of seg_q and seg_k into `tab`
// (int32 scratch of 4 x B x ceil(P/64) from the caller; one table when they
// are one array), then the kernel with the own and visiting roles: flash_fwd
// and flash_dq own queries (seg_q) and visiting keys (seg_k), flash_dkv the
// other way round. Any P.
int launch_stream(int role, const void* own1, const void* own2, const void* own3,
                  const void* vis1, const void* vis2, const void* segq, const void* segk,
                  void* tab, Args args, cudaStream_t stream) {
  if (args.B == 0 || args.P == 0 || args.H == 0) return 0;
  const int2 *tq, *tk;
  const cudaError_t err = launch_tables(segq, segk, tab, args.B, args.P, stream, &tq, &tk);
  if (err != cudaSuccess) return (int)err;
  const bool dkv = role == DKV_ROLE;
  args.seg = (const int*)(dkv ? segk : segq);
  args.segv = (const int*)(dkv ? segq : segk);
  args.tabo = dkv ? tk : tq;
  args.tabv = dkv ? tq : tk;
  if (role == FWD_ROLE)
    return launch<FWD_ROLE, STREAM>(own1, own2, own3, vis1, vis2, args, stream);
  return dkv ? launch<DKV_ROLE, STREAM>(own1, own2, own3, vis1, vis2, args, stream)
             : launch<DQ_ROLE, STREAM>(own1, own2, own3, vis1, vis2, args, stream);
}

}  // namespace
}  // namespace split_bwd_f32

// C entries for ctypes, on `stream`; each returns the first CUDA error (0
// when its launches were accepted), or one of flash_sm90.cuh's codes above
// 999. cos and sin may both be null. Masks: bidirectional, causal, or
// bi-causal with `bi_split` bit slots. The single forms (P <= 2048):
// flash_dq: dq, and delta into the caller's fp32 [B, H, P] `delta` (dlse
// may be null: zeros), summed in the kernel: one launch. flash_dkv: dk,
// dv, reading that delta.
extern "C" int ggt_flash_dq_f32(const void* q, const void* k, const void* v, const void* seg,
                                const void* cos, const void* sin, const void* out,
                                const void* lse, const void* dout, const void* dlse, void* delta,
                                void* dq, int B, int P, int H, int causal, int bi_split,
                                void* stream) {
  using namespace split_bwd_f32;
  const Args args{(const int*)seg, (const float*)lse, (const float*)dlse, (float*)delta,
                  (const float*)cos, (const float*)sin, (float*)dq, nullptr,
                  B, P, H, causal, bi_split};
  return launch<DQ_ROLE, SINGLE>(q, dout, out, k, v, args, (cudaStream_t)stream);
}

extern "C" int ggt_flash_dkv_f32(const void* q, const void* k, const void* v, const void* seg,
                                 const void* cos, const void* sin, const void* lse,
                                 const void* delta, const void* dout, void* dk, void* dv, int B,
                                 int P, int H, int causal, int bi_split, void* stream) {
  using namespace split_bwd_f32;
  const Args args{(const int*)seg, (const float*)lse, nullptr, (float*)delta,
                  (const float*)cos, (const float*)sin, (float*)dk, (float*)dv,
                  B, P, H, causal, bi_split};
  return launch<DKV_ROLE, SINGLE>(k, v, nullptr, q, dout, args, (cudaStream_t)stream);
}

// #7f: dq, and delta into the caller's fp32 [B, H, P] `delta` (dlse may be
// null: zeros), summed in the kernel over do zeroed where seg_q is 0: one
// launch after the tables. Query ids segq, key ids segk (one array twice
// for a model's rows); `tab` the tables' scratch. Any P.
extern "C" int ggt_flash_dq_stream_f32(const void* q, const void* k, const void* v,
                                       const void* segq, const void* segk, const void* cos,
                                       const void* sin, const void* out, const void* lse,
                                       const void* dout, const void* dlse, void* delta,
                                       void* dq, void* tab, int B, int P, int H, int causal,
                                       int bi_split, void* stream) {
  using namespace split_bwd_f32;
  const Args args{nullptr, (const float*)lse, (const float*)dlse, (float*)delta,
                  (const float*)cos, (const float*)sin, (float*)dq, nullptr,
                  B, P, H, causal, bi_split};
  return launch_stream(DQ_ROLE, q, dout, out, k, v, segq, segk, tab, args,
                       (cudaStream_t)stream);
}

// #8f: dk, dv, reading flash_dq_stream_f32's delta.
extern "C" int ggt_flash_dkv_stream_f32(const void* q, const void* k, const void* v,
                                        const void* segq, const void* segk, const void* cos,
                                        const void* sin, const void* lse, const void* delta,
                                        const void* dout, void* dk, void* dv, void* tab, int B,
                                        int P, int H, int causal, int bi_split, void* stream) {
  using namespace split_bwd_f32;
  const Args args{nullptr, (const float*)lse, nullptr, (float*)delta,
                  (const float*)cos, (const float*)sin, (float*)dk, (float*)dv,
                  B, P, H, causal, bi_split};
  return launch_stream(DKV_ROLE, k, v, nullptr, q, dout, segq, segk, tab, args,
                       (cudaStream_t)stream);
}

// #1f: out and lse [B, H, P] of one id array seg, P <= MAX_P: one launch.
extern "C" int ggt_flash_fwd_f32(const void* q, const void* k, const void* v, const void* seg,
                                 const void* cos, const void* sin, void* out, void* lse, int B,
                                 int P, int H, int causal, int bi_split, void* stream) {
  using namespace split_bwd_f32;
  const Args args{(const int*)seg, nullptr, nullptr, nullptr,
                  (const float*)cos, (const float*)sin, (float*)out, (float*)lse,
                  B, P, H, causal, bi_split};
  return launch<FWD_ROLE, SINGLE>(q, nullptr, nullptr, k, v, args, (cudaStream_t)stream);
}

// #6f: out and lse with query ids segq and key ids segk (one array twice
// for a model's rows): one launch after the tables in `tab`, the tables'
// scratch. Any P.
extern "C" int ggt_flash_fwd_stream_f32(const void* q, const void* k, const void* v,
                                        const void* segq, const void* segk, const void* cos,
                                        const void* sin, void* out, void* lse, void* tab, int B,
                                        int P, int H, int causal, int bi_split, void* stream) {
  using namespace split_bwd_f32;
  const Args args{nullptr, nullptr, nullptr, nullptr,
                  (const float*)cos, (const float*)sin, (float*)out, (float*)lse,
                  B, P, H, causal, bi_split};
  return launch_stream(FWD_ROLE, q, nullptr, nullptr, k, v, segq, segk, tab, args,
                       (cudaStream_t)stream);
}
