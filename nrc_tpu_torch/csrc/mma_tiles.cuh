// Warp-level bf16 tensor-core tiles for the NRC cache MLP (kernels K3-K6).
//
// Every product of the chain 128 -> 64 -> (64 -> 64) x n_hidden -> 16, of its
// backward pass and of the weight gradients is computed here with
//   mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
// (bf16 operands, f32 sums: the contract of the TPU kernels' _mm / _mm_tn in
// nrc_tpu/ops/mlp_pallas.py). A warp owns 16 rows of the batch. Operands that
// live in shared memory are loaded with ldmatrix; an activation that goes
// from one layer to the next never leaves the registers, because the f32
// accumulator fragments of two neighbouring 8-wide column tiles are, once
// rounded to bf16, exactly the A fragment of the next product's 16-deep step.
//
// Fragment layouts of m16n8k16 (lane = thread within the warp, g = lane / 4,
// t = lane % 4; a register holds two bf16, the lower column in its low half):
//   A [16, 16] row-major, 4 registers: register j holds row g + 8 (j & 1),
//       columns 2 t + 8 (j >> 1) and the next one;
//   B [16, 8], 2 registers: register j holds rows (the depth) 2 t + 8 j and
//       the next one, column g;
//   C [16, 8] f32, 4 registers: element i is row g + 8 (i >> 1), column
//       2 t + (i & 1).
// ldmatrix.x4 loads four 8 x 8 blocks of bf16; lanes 8 m .. 8 m + 7 give the
// addresses of the eight 16-byte rows of block m, and register m of a lane
// holds block m's (row g, columns 2 t, 2 t + 1), or with .trans its (rows
// 2 t, 2 t + 1, column g). Rows are padded (72, 24 and 136 bf16) so that every
// block row is 16-byte aligned and the eight rows of a block fall into
// different banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nrc_mma {

typedef __nv_bfloat16 bf16;

constexpr int kIn = 128;          // padded encoded input
constexpr int kWidth = 64;        // hidden width
constexpr int kOut = 16;          // padded output, RGB in columns 0-2
constexpr int kWarpRows = 16;     // batch rows a warp owns
constexpr int kCtaThreads = 256;  // 8 warps: 128 batch rows per CTA and turn
constexpr int kStride = 72;       // bf16 per staged row of 64: weights, activations, gradients
constexpr int kOutStride = 24;    // bf16 per staged row of w_out [64, 16]
constexpr int kXStride = 136;     // bf16 per staged input row of 128
constexpr int kSmemLimit = 232448;  // an H100 CTA's shared memory

__host__ __device__ inline int num_params(int n_hidden) {
  return kIn * kWidth + n_hidden * kWidth * kWidth + kWidth * kOut;
}

// bf16 elements of the staged weights: w_in [128, 72] | w_hidden [H, 64, 72] | w_out [64, 24]
__host__ __device__ inline int staged_weight_halves(int n_hidden) {
  return kIn * kStride + n_hidden * kWidth * kStride + kWidth * kOutStride;
}

// ---- the fragment index maps ------------------------------------------------

// row (of the warp's 16) and column (of the 8-wide tile) of accumulator element i
__device__ __forceinline__ int frag_row(int lane, int i) { return (lane >> 2) + ((i >> 1) << 3); }
__device__ __forceinline__ int frag_col(int lane, int i) { return ((lane & 3) << 1) + (i & 1); }
// row and first column (of 16) that A register j holds
__device__ __forceinline__ int a_row(int lane, int j) { return (lane >> 2) + ((j & 1) << 3); }
__device__ __forceinline__ int a_col(int lane, int j) { return ((lane & 3) << 1) + ((j >> 1) << 3); }

// Offset (in bf16) of the 16-byte row this lane names in an ldmatrix.x4 over a
// 16 x 16 block of a row-major array: blocks 0, 1 are rows 0-7, 8-15 of
// columns 0-7, blocks 2, 3 the same of columns 8-15 ...
__device__ __forceinline__ int quad_rows_first(int lane, int stride) {
  return ((lane & 7) + (((lane >> 3) & 1) << 3)) * stride + ((lane >> 4) << 3);
}
// ... or blocks 0, 1 are columns 0-7, 8-15 of rows 0-7, blocks 2, 3 of rows 8-15.
__device__ __forceinline__ int quad_cols_first(int lane, int stride) {
  return ((lane & 7) + ((lane >> 4) << 3)) * stride + (((lane >> 3) & 1) << 3);
}

// ---- ldmatrix and mma, by inline PTX ------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a [16, 16] x b [16, 8]
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
}

// ---- staging ------------------------------------------------------------------

// f32 [rows, kCols] row-major in device memory -> bf16 [rows, kDstStride] in
// shared memory, by all kCtaThreads threads of the CTA, 16 bytes read per
// thread and turn; unrolled so that a thread has several reads in flight
// (the staging is the fixed cost of a CTA: K3 at 102,400 rows took 0.0338 ms
// before the unrolling and 0.0316 after, NVIDIA H100 80GB HBM3, 700 W).
// kCoherent reads through the L2 only (ld.global.cg): for weights that other
// CTAs of the same kernel have written (K6's persistent kernel), which the
// read-only path and the L1 may hold stale.
template <int kCols, int kDstStride, bool kCoherent = false>
__device__ __forceinline__ void stage_bf16(const float* __restrict__ src, int rows, bf16* dst) {
  const float4* src4 = reinterpret_cast<const float4*>(src);
  const int count = rows * (kCols / 4);
#pragma unroll 5
  for (int i = threadIdx.x; i < count; i += kCtaThreads) {
    const float4 v = kCoherent ? __ldcg(src4 + i) : src4[i];
    const int r = i / (kCols / 4), c = (i % (kCols / 4)) * 4;
    *reinterpret_cast<uint2*>(dst + r * kDstStride + c) =
        make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
}

// all weights, as w_in [128, 72] | w_hidden [H, 64, 72] | w_out [64, 24]
template <bool kCoherent = false>
__device__ __forceinline__ void stage_weights(const float* __restrict__ w_in,
                                              const float* __restrict__ w_hidden,
                                              const float* __restrict__ w_out, int n_hidden,
                                              bf16* s_in, bf16* s_hidden, bf16* s_out) {
  stage_bf16<kWidth, kStride, kCoherent>(w_in, kIn, s_in);
  stage_bf16<kWidth, kStride, kCoherent>(w_hidden, n_hidden * kWidth, s_hidden);
  stage_bf16<kOut, kOutStride, kCoherent>(w_out, kWidth, s_out);
}

// ---- products of a warp's 16 rows ------------------------------------------------

// acc += a [16, 16] x w[0:16, 0:8 NT]; w_lane = the staged [k, n] block's
// first element + quad_rows_first(lane, kWStride)
template <int NT, int kWStride>
__device__ __forceinline__ void mma_step_w(const uint32_t (&a)[4], const bf16* w_lane,
                                           float (&acc)[NT][4]) {
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    uint32_t b[4];
    ldsm_x4_t(b, w_lane + np * 16);
    mma_bf16(acc[2 * np], a, b[0], b[1]);
    mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
  }
}

// acc += A [16, 16 KT] x W [16 KT, 8 NT]: A in registers, W staged as [k, n]
template <int KT, int NT, int kWStride>
__device__ __forceinline__ void mm_a_w(const uint32_t (&a)[KT][4], const bf16* w,
                                       float (&acc)[NT][4], int lane) {
  const bf16* w_lane = w + quad_rows_first(lane, kWStride);
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) mma_step_w<NT, kWStride>(a[kt], w_lane + kt * 16 * kWStride, acc);
}

// acc += G [16, 16 KT] x W^T, W staged as [n, k] = [8 NT, 16 KT]: the way back
template <int KT, int NT, int kWStride>
__device__ __forceinline__ void mm_a_wt(const uint32_t (&a)[KT][4], const bf16* w,
                                        float (&acc)[NT][4], int lane) {
  const bf16* w_lane = w + quad_cols_first(lane, kWStride);
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b, w_lane + np * 16 * kWStride + kt * 16);
      mma_bf16(acc[2 * np], a[kt], b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a[kt], b[2], b[3]);
    }
  }
}

// ReLU and the rounding to bf16 that every product's operand gets: the f32
// accumulators of a 64-wide layer become the A fragments of the next product.
__device__ __forceinline__ void relu_to_a(const float (&acc)[8][4], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[j][0] = pack_bf16(fmaxf(acc[2 * j][0], 0.f), fmaxf(acc[2 * j][1], 0.f));
    a[j][1] = pack_bf16(fmaxf(acc[2 * j][2], 0.f), fmaxf(acc[2 * j][3], 0.f));
    a[j][2] = pack_bf16(fmaxf(acc[2 * j + 1][0], 0.f), fmaxf(acc[2 * j + 1][1], 0.f));
    a[j][3] = pack_bf16(fmaxf(acc[2 * j + 1][2], 0.f), fmaxf(acc[2 * j + 1][3], 0.f));
  }
}

}  // namespace nrc_mma
