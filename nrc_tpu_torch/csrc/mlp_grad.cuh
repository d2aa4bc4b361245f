// Shared device code of the NRC cache MLP's gradient kernels K4 and K5/K6,
// on the tensor cores (mma_tiles.cuh has the tiles and the fragment maps).
//
// One CTA of 8 warps owns 128 batch rows, a warp 16 of them. The CTA stages
// every weight and its input rows as bf16 in shared memory. A warp recomputes
// the forward chain 128 -> 64 -> (64 -> 64) x n_hidden -> 16 for its rows
// with mma.sync m16n8k16, the activations passing from layer to layer in
// registers; each layer's bf16 activations are also written to shared memory,
// because the weight gradients need them by column. Every product of the TPU
// kernels rounds both operands to bf16 and sums in f32
// (nrc_tpu/ops/mlp_pallas.py::_mm, _mm_tn), so an activation, an input row
// and a gradient row are rounded once and every later use is exact.
//
// The way back: g' = mask * (g x W^T) is again a product of the warp's 16
// rows, with W read as stored ([k, j] row-major is W^T as a column-major B),
// and g' rounded to bf16 is the next step's A fragment. The ReLU mask of a
// layer is 32 bits in a register, one per accumulator element the lane held
// in the forward pass: of the bf16 activations for K5, of the f32 sums for K4.
// The weight gradients dW = A^T G sum over the CTA's 128 rows: both operands
// lie row by batch row in shared memory and load with ldmatrix.trans; the
// 16 x 8 tiles of a dW are shared out among the 8 warps.
//
// dW sums over the whole batch. The TPU kernels carry that sum in VMEM across
// a sequential grid; CTAs here run in no order, so each CTA writes the sum
// over its own rows to a scratch row partial[blockIdx.x, :] and the rows are
// added in CTA order: by reduce_partials() for K4/K5, inside the persistent
// kernel of K6 (mlp_train.cu). Nothing uses atomics: the result is the same
// from run to run. The scratch (25,601 floats per CTA, 13 MB written and read
// at B = 16,384) is the price of that. grad_tile() is the body shared by the
// one-tile-a-CTA kernel of K4/K5 and K6's persistent kernel.
//
// What bounds it on an H100: per 16,384 rows 3 x 25,600 multiply-adds a row
// (0.0025 ms at 989 TFLOP/s) against the 8.6 MB of rows its function must
// move (0.0026 ms at 3.35 TB/s), so bytes by a hair. The 26 MB of scratch
// traffic come on top and are this design's own (0.008 ms from device
// memory, less from the L2, which holds them); in practice the chain of
// barriers and dependent mma of one 128-row tile per SM decides: 203,808
// bytes of shared memory for the shipped network leave room for one CTA an
// SM.

#pragma once

#include <mutex>

#include "mma_tiles.cuh"

namespace nrc_mlp {

using namespace nrc_mma;

constexpr int kThreads = kCtaThreads;                    // 8 warps
constexpr int kRows = (kThreads / 32) * kWarpRows;       // 128 rows per CTA
constexpr int kMaxHidden = 5;                            // what smem_bytes() allows

// bytes of dynamic shared memory: 32 for the loss sums, the staged weights,
// the input rows [128, 136], the activations [H + 1, 128, 72] and the
// gradient rows [128, 72]
__host__ __device__ inline int smem_bytes(int n_hidden) {
  const int halves = staged_weight_halves(n_hidden) + kRows * kXStride +
                     (n_hidden + 2) * kRows * kStride;
  return 32 + 2 * halves;
}

// the warp's A fragments -> its 16 bf16 rows of shared memory (rows = the
// first of them, row stride kStride)
template <int KT>
__device__ __forceinline__ void store_a_frags(const uint32_t (&a)[KT][4], bf16* rows, int lane) {
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint32_t*>(rows + a_row(lane, j) * kStride + kt * 16 + a_col(lane, j)) =
          a[kt][j];
}

// ReLU mask of a layer, bit 4 nt + i for accumulator element acc[nt][i]: of
// the f32 sums (K4), or of the bf16 activations in the A fragments (K5)
template <bool kFromF32>
__device__ __forceinline__ uint32_t relu_mask(const float (&acc)[8][4], const uint32_t (&a)[4][4]) {
  uint32_t bits = 0;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // element (nt, i) sits in A register (nt & 1) * 2 + (i >> 1) of k-tile nt >> 1, half i & 1
      const uint32_t half = (a[nt >> 1][(nt & 1) * 2 + (i >> 1)] >> (16 * (i & 1))) & 0x7fffu;
      const bool on = kFromF32 ? acc[nt][i] > 0.f : half != 0u;
      bits |= (on ? 1u : 0u) << (4 * nt + i);
    }
  return bits;
}

// g' = mask * acc, rounded to bf16: the A fragments of the next step back
__device__ __forceinline__ void mask_to_a(const float (&acc)[8][4], uint32_t mask,
                                          uint32_t (&a)[4][4]) {
  float v[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) v[nt][i] = ((mask >> (4 * nt + i)) & 1u) ? acc[nt][i] : 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[j][0] = pack_bf16(v[2 * j][0], v[2 * j][1]);
    a[j][1] = pack_bf16(v[2 * j][2], v[2 * j][3]);
    a[j][2] = pack_bf16(v[2 * j + 1][0], v[2 * j + 1][1]);
    a[j][3] = pack_bf16(v[2 * j + 1][2], v[2 * j + 1][3]);
  }
}

// out[(m0 + i) * n_cols + n0 + j] = sum over the CTA's rows r of
// a[r, m0 + i] * g[r, n0 + j] for i < 16, j < 8 NT: one warp's share of a
// dW = A^T G. a has row stride kAStride, g row stride kStride. With
// accumulate the sum is added to what out holds (a CTA's later tile; each
// entry has one writer in the CTA, so the order is fixed).
template <int NT, int kAStride>
__device__ __forceinline__ void at_g(const bf16* a, int m0, const bf16* g, int n0, float* out,
                                     int n_cols, int lane, bool accumulate) {
  float acc[NT][4];
  zero_acc(acc);
  const bf16* a_lane = a + quad_cols_first(lane, kAStride) + m0;
  const bf16* g_lane = g + quad_rows_first(lane, kStride) + n0;
#pragma unroll 2
  for (int ks = 0; ks < kRows / 16; ++ks) {
    uint32_t af[4];
    ldsm_x4_t(af, a_lane + ks * 16 * kAStride);
    mma_step_w<NT, kStride>(af, g_lane + ks * 16 * kStride, acc);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* o = out + (m0 + frag_row(lane, i)) * n_cols + n0 + nt * 8 + frag_col(lane, i);
      *o = accumulate ? *o + acc[nt][i] : acc[nt][i];
    }
}

// RelativeL2Luminance of one row (nrc_tpu/models/network.py:210-216): its
// loss, and its output gradient in gr[0:3]. A row past the batch has diff 0.
__device__ __forceinline__ float row_loss_grad(const float (&pred)[3], const float* target,
                                               float grad_scale, float (&gr)[3]) {
  const float lum = __fadd_rn(__fadd_rn(__fmul_rn(0.299f, pred[0]), __fmul_rn(0.587f, pred[1])),
                              __fmul_rn(0.114f, pred[2]));
  const float denom = __fadd_rn(__fmul_rn(lum, lum), 0.01f);
  float loss = 0.f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float diff = target != nullptr ? __fsub_rn(pred[c], target[c]) : 0.f;
    loss = __fadd_rn(loss, __fdiv_rn(__fmul_rn(diff, diff), denom));
    gr[c] = __fdiv_rn(__fmul_rn(grad_scale, diff), denom);
  }
  return loss;
}

// A CTA's shared memory, carved from the dynamic allocation
struct GradSmem {
  float* red;   // [kThreads / 32] the warps' loss sums
  bf16* win;    // [kIn, kStride]
  bf16* wh;     // [H, kWidth, kStride]
  bf16* wout;   // [kWidth, kOutStride]
  bf16* x;      // [kRows, kXStride]
  bf16* act;    // [H + 1, kRows, kStride]
  bf16* g;      // [kRows, kStride]
};

__device__ __forceinline__ GradSmem carve_smem(unsigned char* smem_raw, int n_hidden) {
  GradSmem s;
  s.red = reinterpret_cast<float*>(smem_raw);
  s.win = reinterpret_cast<bf16*>(smem_raw + 32);
  s.wh = s.win + kIn * kStride;
  s.wout = s.wh + n_hidden * kWidth * kStride;
  s.x = s.wout + kWidth * kOutStride;
  s.act = s.x + kRows * kXStride;
  s.g = s.act + (n_hidden + 1) * kRows * kStride;
  return s;
}

// The input rows row0 .. row0 + 127 of x [batch, 128] as bf16, coalesced; rows
// past the batch are zero and contribute nothing
__device__ __forceinline__ void stage_rows(const float* __restrict__ x, int batch, int row0,
                                           bf16* s_x) {
  for (int i = threadIdx.x; i < kRows * (kIn / 4); i += kThreads) {
    const int r = i / (kIn / 4), c = (i % (kIn / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < batch)
      v = __ldcs(reinterpret_cast<const float4*>(x + static_cast<size_t>(row0 + r) * kIn + c));
    *reinterpret_cast<uint2*>(s_x + r * kXStride + c) =
        make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
}

// The gradient of one 128-row tile, rows row0 .. row0 + 127, with the weights
// and the tile's input rows staged and a __syncthreads() behind them. It
// ends with every warp's last read of s.x and s.g: a caller that stages
// again synchronises first. kTrain = false is K4 (fused_backward): gout is
// the output gradient [batch, 16], ReLU masks come from the f32
// pre-activations, and dx [batch, 128] is written. kTrain = true is K5
// (fused_train_grad): gout is the target [batch, 3], the RelativeL2Luminance
// loss and its gradient (grad_scale = 2 / (3 batch)) are formed per row, masks
// come from the bf16 activations, and the tile's loss sum goes to part[P].
//
// part: the CTA's partial row [P + 1] with P = num_params(n_hidden), laid out
// as dW_in | dW_hidden | dW_out | loss; with accumulate the tile's sums are
// added to it, else they are written.
template <bool kTrain>
__device__ __forceinline__ void grad_tile(const GradSmem& s, const float* __restrict__ gout,
                                          int batch, int n_hidden, float grad_scale, int row0,
                                          float* __restrict__ dx, float* __restrict__ part,
                                          bool accumulate) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_row0 = warp * kWarpRows;  // within the CTA
  const int rows[2] = {row0 + warp_row0 + a_row(lane, 0), row0 + warp_row0 + a_row(lane, 1)};
  const int n_params = num_params(n_hidden);
  const int off_hidden = kIn * kWidth;
  const int off_out = off_hidden + n_hidden * kWidth * kWidth;

  // ---- forward recompute: the warp's 16 rows, activations in registers ------
  float acc[8][4];
  uint32_t a[4][4];             // the current layer's activations as A fragments
  uint32_t mask[kMaxHidden + 1];
  zero_acc(acc);
  {
    const bf16* x_lane = s.x + warp_row0 * kXStride + quad_rows_first(lane, kXStride);
    const bf16* w_lane = s.win + quad_rows_first(lane, kStride);
#pragma unroll
    for (int kt = 0; kt < kIn / 16; ++kt) {
      uint32_t ax[4];
      ldsm_x4(ax, x_lane + kt * 16);
      mma_step_w<8, kStride>(ax, w_lane + kt * 16 * kStride, acc);
    }
  }
  relu_to_a(acc, a);
  mask[0] = relu_mask<!kTrain>(acc, a);
  uint32_t mask_top = mask[0];
  store_a_frags<4>(a, s.act + warp_row0 * kStride, lane);
#pragma unroll
  for (int l = 0; l < kMaxHidden; ++l) {
    if (l < n_hidden) {
      zero_acc(acc);
      mm_a_w<4, 8, kStride>(a, s.wh + l * kWidth * kStride, acc, lane);
      relu_to_a(acc, a);
      mask[l + 1] = relu_mask<!kTrain>(acc, a);
      mask_top = mask[l + 1];
      store_a_frags<4>(a, s.act + ((l + 1) * kRows + warp_row0) * kStride, lane);
    }
  }

  // ---- output gradient: A fragments ga of g [16, 16], and into s.g[:, 0:16] ---
  uint32_t ga[1][4];
  if (kTrain) {
    // linear output; the loss reads columns 0-2, which lanes 0 and 1 of a quad hold
    float o[2][4];
    zero_acc(o);
    mm_a_w<4, 2, kOutStride>(a, s.wout, o, lane);
    const int q0 = lane & ~3;
    float row_loss = 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float pred[3] = {__shfl_sync(0xffffffffu, o[0][2 * half], q0),
                             __shfl_sync(0xffffffffu, o[0][2 * half + 1], q0),
                             __shfl_sync(0xffffffffu, o[0][2 * half], q0 + 1)};
      const int row = rows[half];
      float gr[3];
      const float loss = row_loss_grad(
          pred, row < batch ? gout + static_cast<size_t>(row) * 3 : nullptr, grad_scale, gr);
      if ((lane & 3) == 0) row_loss = __fadd_rn(row_loss, loss);
      ga[0][half] = (lane & 3) == 0 ? pack_bf16(gr[0], gr[1])
                                    : ((lane & 3) == 1 ? pack_bf16(gr[2], 0.f) : 0u);
      ga[0][2 + half] = 0u;
    }
    // CTA loss sum in a fixed order: warp tree, then the warps in turn
#pragma unroll
    for (int o2 = 16; o2 > 0; o2 >>= 1) row_loss += __shfl_xor_sync(0xffffffffu, row_loss, o2);
    if (lane == 0) s.red[warp] = row_loss;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = rows[j & 1];
      float2 v = make_float2(0.f, 0.f);
      if (row < batch)
        v = *reinterpret_cast<const float2*>(gout + static_cast<size_t>(row) * kOut + a_col(lane, j));
      ga[0][j] = pack_bf16(v.x, v.y);
    }
  }
  store_a_frags<1>(ga, s.g + warp_row0 * kStride, lane);
  __syncthreads();  // every warp's activations and g rows are in shared memory
  if (kTrain && tid == 0) {
    float sum = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) sum += s.red[w];
    part[n_params] = accumulate ? part[n_params] + sum : sum;
  }

  // ---- backward: dW_out, then through w_out^T ---------------------------------
  if (warp < kWidth / 16)
    at_g<2, kStride>(s.act + n_hidden * kRows * kStride, warp * 16, s.g, 0, part + off_out, kOut,
                     lane, accumulate);
  zero_acc(acc);
  mm_a_wt<1, 8, kOutStride>(ga, s.wout, acc, lane);
  mask_to_a(acc, mask_top, a);  // from here on a holds the gradient rows
  __syncthreads();              // s.g has been read
  store_a_frags<4>(a, s.g + warp_row0 * kStride, lane);
  __syncthreads();
#pragma unroll
  for (int l = kMaxHidden - 1; l >= 0; --l) {
    if (l < n_hidden) {
      // dW_hidden[l] [64, 64]: 4 x 8 tiles, four to a warp
      at_g<4, kStride>(s.act + l * kRows * kStride, (warp >> 1) * 16, s.g, (warp & 1) * 32,
                       part + off_hidden + l * kWidth * kWidth, kWidth, lane, accumulate);
      zero_acc(acc);
      mm_a_wt<4, 8, kStride>(a, s.wh + l * kWidth * kStride, acc, lane);
      mask_to_a(acc, mask[l], a);
      __syncthreads();
      store_a_frags<4>(a, s.g + warp_row0 * kStride, lane);
      __syncthreads();
    }
  }
  // dW_in [128, 64]: 8 x 8 tiles, a row of eight to a warp
  at_g<8, kXStride>(s.x, warp * 16, s.g, 0, part, kWidth, lane, accumulate);

  // ---- K4: dX = g @ w_in^T, in two halves of 64 columns -----------------------
  if (!kTrain) {
#pragma unroll
    for (int part_n = 0; part_n < kIn / kWidth; ++part_n) {
      zero_acc(acc);
      mm_a_wt<4, 8, kStride>(a, s.win + part_n * kWidth * kStride, acc, lane);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          if (rows[half] < batch)
            *reinterpret_cast<float2*>(dx + static_cast<size_t>(rows[half]) * kIn +
                                       part_n * kWidth + nt * 8 + frag_col(lane, 0)) =
                make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
    }
  }
}

// The gradient kernel of K4 (kTrain = false) and K5 (kTrain = true): one
// 128-row tile a CTA, its sums to partial[blockIdx.x, :], a row of [gridDim.x,
// P + 1] (see grad_tile).
template <bool kTrain>
__global__ void __launch_bounds__(kThreads, 1) mlp_grad_kernel(
    const float* __restrict__ x, const float* __restrict__ gout,
    const float* __restrict__ w_in, const float* __restrict__ w_hidden,
    const float* __restrict__ w_out, int batch, int n_hidden, float grad_scale,
    float* __restrict__ dx, float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const GradSmem s = carve_smem(smem_raw, n_hidden);
  const int row0 = blockIdx.x * kRows;
  stage_weights(w_in, w_hidden, w_out, n_hidden, s.win, s.wh, s.wout);
  stage_rows(x, batch, row0, s.x);
  __syncthreads();
  grad_tile<kTrain>(s, gout, batch, n_hidden, grad_scale, row0, dx,
                    partial + static_cast<size_t>(blockIdx.x) * (num_params(n_hidden) + 1), false);
}

// out[i] = sum over b of partial[b, i], b in order; i < count. The last
// entry (i == count - 1) goes to *last_out, scaled by last_scale, when
// last_out is given.
__global__ void reduce_partials(const float* __restrict__ partial, int n_blocks, int stride,
                                int count, float* __restrict__ out, float* __restrict__ last_out,
                                float last_scale) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += partial[static_cast<size_t>(b) * stride + i];
  if (last_out != nullptr && i == count - 1) {
    *last_out = s * last_scale;
  } else {
    out[i] = s;
  }
}

// Raise the gradient kernel's limit of dynamic shared memory to `smem`, once
// per (device, size): a launch then makes no attribute call, which costs the
// host time at every frame (mlp_forward.cu keeps its grid the same way).
template <bool kTrain>
inline cudaError_t allow_smem(int smem) {
  static std::mutex lock;
  static int known_device = -1, known_smem = -1;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> guard(lock);
  if (device != known_device || smem != known_smem) {
    err = cudaFuncSetAttribute(mlp_grad_kernel<kTrain>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    known_device = device;
    known_smem = smem;
  }
  return cudaSuccess;
}

// Launch the gradient kernel and the reduction on `stream` (K4, K5). grad
// receives the P summed weight gradients; with loss != nullptr (K5) *loss
// receives loss_scale times the summed loss.
template <bool kTrain>
inline cudaError_t launch_grad(const float* x, const float* gout, const float* w_in,
                               const float* w_hidden, const float* w_out, int batch,
                               int n_hidden, float grad_scale, float* dx, float* partial,
                               float* grad, float* loss, float loss_scale, cudaStream_t stream) {
  const int smem = smem_bytes(n_hidden);
  if (n_hidden > kMaxHidden || smem > kSmemLimit || batch <= 0) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem<kTrain>(smem);
  if (err != cudaSuccess) return err;
  const int blocks = (batch + kRows - 1) / kRows;
  mlp_grad_kernel<kTrain><<<blocks, kThreads, smem, stream>>>(
      x, gout, w_in, w_hidden, w_out, batch, n_hidden, grad_scale, dx, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_params = num_params(n_hidden);
  const int count = loss != nullptr ? n_params + 1 : n_params;
  reduce_partials<<<(count + 255) / 256, 256, 0, stream>>>(
      partial, blocks, n_params + 1, count, grad, loss, loss_scale);
  return cudaGetLastError();
}

}  // namespace nrc_mlp
