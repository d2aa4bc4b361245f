// Shared device code of the NRC cache MLP's gradient kernels K4 and K5/K6.
//
// One CTA owns kRows batch rows, one thread per row. It stages every weight
// as bf16 in shared memory, recomputes the forward chain
// 128 -> 64 -> (64 -> 64) x n_hidden -> 16 row by row, and keeps each row's
// bf16 activations in shared memory for the backward pass. Every product of
// the TPU kernels rounds both operands to bf16 and sums in f32
// (nrc_tpu/ops/mlp_pallas.py::_mm, _mm_tn), so an activation, an input row
// and a gradient row are stored as bf16 once and every later use is exact.
//
// The weight gradients dW = A^T G sum over the batch. The TPU kernels carry
// that sum in VMEM across a sequential grid; CTAs here run in no order, so
// each CTA writes the sum over its own rows to a scratch row
// partial[blockIdx.x, :] and reduce_partials() adds the rows in CTA order.
// Nothing uses atomics: the result is the same from run to run.
//
// Shared-memory rows are padded (130 and 66 bf16) so that the 32 threads of
// a warp, one row each, hit 32 different banks; in the dW phases all threads
// of a warp read the same activation (a broadcast) and consecutive gradient
// columns.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nrc_mlp {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

constexpr int kIn = 128;                 // padded encoded input
constexpr int kWidth = 64;               // hidden width
constexpr int kOut = 16;                 // padded output, RGB in columns 0-2
constexpr int kRows = 128;               // rows (= threads) per CTA
constexpr int kXStride = kIn + 2;        // bf16 per staged input row
constexpr int kActStride = kWidth + 2;   // bf16 per staged activation / gradient row
constexpr int kSmemLimit = 232448;       // an H100 CTA's shared memory

__host__ __device__ inline int num_params(int n_hidden) {
  return kIn * kWidth + n_hidden * kWidth * kWidth + kWidth * kOut;
}

// bytes of dynamic shared memory; K4 adds one 64-bit ReLU mask per row and layer
__host__ __device__ inline int smem_bytes(int n_hidden, bool f32_masks) {
  const int halves = num_params(n_hidden) + kRows * kXStride +
                     (n_hidden + 2) * kRows * kActStride;
  return 16 + 2 * halves + (f32_masks ? 8 * (n_hidden + 1) * kRows : 0);
}

__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const bf162*>(p));
}

// acc[0:kWidth] += a[0:n_in] @ w[n_in, kWidth]; a is this thread's bf16 row
__device__ __forceinline__ void row_times_w(const bf16* a, const bf16* w, int n_in,
                                            float* acc) {
#pragma unroll
  for (int j = 0; j < kWidth; ++j) acc[j] = 0.f;
#pragma unroll 2
  for (int k = 0; k < n_in; k += 2) {
    const float2 av = load2(a + k);
    const bf16* w0 = w + k * kWidth;
    const bf16* w1 = w0 + kWidth;
#pragma unroll
    for (int j = 0; j < kWidth; j += 2) {
      const float2 p = load2(w0 + j);
      const float2 q = load2(w1 + j);
      acc[j] = fmaf(av.x, p.x, acc[j]);
      acc[j + 1] = fmaf(av.x, p.y, acc[j + 1]);
      acc[j] = fmaf(av.y, q.x, acc[j]);
      acc[j + 1] = fmaf(av.y, q.y, acc[j + 1]);
    }
  }
}

// relu -> bf16 row of shared memory; returns the mask bits of z > 0
__device__ __forceinline__ uint64_t store_relu(const float* acc, bf16* dst) {
  uint64_t bits = 0;
#pragma unroll
  for (int j = 0; j < kWidth; j += 2) {
    *reinterpret_cast<bf162*>(dst + j) =
        __floats2bfloat162_rn(fmaxf(acc[j], 0.f), fmaxf(acc[j + 1], 0.f));
    bits |= (acc[j] > 0.f ? 1ull : 0ull) << j;
    bits |= (acc[j + 1] > 0.f ? 1ull : 0ull) << (j + 1);
  }
  return bits;
}

// ReLU mask of one stored bf16 activation row (K5/K6; K4 keeps the f32
// pre-activations' bits from store_relu instead)
__device__ __forceinline__ uint64_t act_mask(const bf16* act) {
  uint64_t bits = 0;
#pragma unroll
  for (int j = 0; j < kWidth; ++j)
    bits |= (__bfloat162float(act[j]) > 0.f ? 1ull : 0ull) << j;
  return bits;
}

// One backward step for this thread's row: g_row[0:n_out] (bf16 in shared
// memory) -> (g @ w^T) masked, rounded to bf16, written over g_row[0:kWidth].
// w is [kWidth, n_out].
template <int n_out>
__device__ __forceinline__ void backprop_row(bf16* g_row, const bf16* w, uint64_t mask) {
  float g[n_out];
#pragma unroll
  for (int j = 0; j < n_out; j += 2) {
    const float2 v = load2(g_row + j);
    g[j] = v.x;
    g[j + 1] = v.y;
  }
#pragma unroll 2
  for (int k = 0; k < kWidth; ++k) {
    const bf16* wk = w + k * n_out;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < n_out; j += 2) {
      const float2 p = load2(wk + j);
      s0 = fmaf(g[j], p.x, s0);
      s1 = fmaf(g[j + 1], p.y, s1);
    }
    const float v = ((mask >> k) & 1ull) ? s0 + s1 : 0.f;
    g_row[k] = __float2bfloat16_rn(v);
  }
}

// partial[k * n_cols + j] = sum over the CTA's rows r of a[r, k] * g[r, j],
// a [kRows, n_k] with row stride a_stride, g [kRows, n_cols] with row stride
// kActStride. Thread t owns column j = t % n_cols and a run of
// n_k * n_cols / kRows consecutive k.
template <int n_k, int n_cols>
__device__ __forceinline__ void block_at_g(const bf16* a, int a_stride, const bf16* g,
                                           float* partial) {
  constexpr int kGroups = kRows / n_cols;       // threads sharing one column
  constexpr int kPer = n_k / kGroups;           // k values per thread
  const int j = threadIdx.x % n_cols;
  const int k0 = (threadIdx.x / n_cols) * kPer;
  float acc[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) acc[q] = 0.f;
#pragma unroll 1
  for (int r = 0; r < kRows; ++r) {
    const float gj = __bfloat162float(g[r * kActStride + j]);
    const bf16* ar = a + r * a_stride + k0;
#pragma unroll
    for (int q = 0; q < kPer; q += 2) {
      const float2 av = load2(ar + q);
      acc[q] = fmaf(av.x, gj, acc[q]);
      acc[q + 1] = fmaf(av.y, gj, acc[q + 1]);
    }
  }
#pragma unroll
  for (int q = 0; q < kPer; ++q) partial[(k0 + q) * n_cols + j] = acc[q];
}

// dW_out [kWidth, kOut]: thread t owns row k = t % kWidth and kOut / 2
// columns, so that the 16 output columns spread over all kRows threads
__device__ __forceinline__ void block_at_gout(const bf16* a, const bf16* g, float* partial) {
  constexpr int kPer = kOut * kWidth / kRows;   // 8
  const int k = threadIdx.x % kWidth;
  const int j0 = (threadIdx.x / kWidth) * kPer;
  float acc[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) acc[q] = 0.f;
#pragma unroll 1
  for (int r = 0; r < kRows; ++r) {
    const float ak = __bfloat162float(a[r * kActStride + k]);
    const bf16* gr = g + r * kActStride + j0;
#pragma unroll
    for (int q = 0; q < kPer; q += 2) {
      const float2 gv = load2(gr + q);
      acc[q] = fmaf(ak, gv.x, acc[q]);
      acc[q + 1] = fmaf(ak, gv.y, acc[q + 1]);
    }
  }
#pragma unroll
  for (int q = 0; q < kPer; ++q) partial[k * kOut + j0 + q] = acc[q];
}

// The gradient kernel. kTrain = false is K4 (fused_backward): gout is the
// output gradient [batch, 16], ReLU masks come from the f32 pre-activations,
// and dx [batch, 128] is written. kTrain = true is K5 (fused_train_grad):
// gout is the target [batch, 3], the RelativeL2Luminance loss and its
// gradient (grad_scale = 2 / (3 batch)) are formed per row, masks come from
// the bf16 activations, and the CTA's loss sum goes to partial[P].
//
// partial: [gridDim.x, P + 1] with P = num_params(n_hidden), laid out as
// dW_in | dW_hidden | dW_out | loss.
template <bool kTrain>
__global__ void __launch_bounds__(kRows) mlp_grad_kernel(
    const float* __restrict__ x, const float* __restrict__ gout,
    const float* __restrict__ w_in, const float* __restrict__ w_hidden,
    const float* __restrict__ w_out, int batch, int n_hidden, float grad_scale,
    float* __restrict__ dx, float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_red = reinterpret_cast<float*>(smem_raw);                 // [kRows / 32]
  bf16* s_win = reinterpret_cast<bf16*>(smem_raw + 16);              // [kIn, kWidth]
  bf16* s_wh = s_win + kIn * kWidth;                                  // [H, kWidth, kWidth]
  bf16* s_wout = s_wh + n_hidden * kWidth * kWidth;                   // [kWidth, kOut]
  bf16* s_x = s_wout + kWidth * kOut;                                 // [kRows, kXStride]
  bf16* s_act = s_x + kRows * kXStride;                               // [H + 1, kRows, kActStride]
  bf16* s_g = s_act + (n_hidden + 1) * kRows * kActStride;            // [kRows, kActStride]
  uint64_t* s_mask = reinterpret_cast<uint64_t*>(s_g + kRows * kActStride);  // K4: [H + 1, kRows]

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int row = row0 + tid;
  const bool live = row < batch;
  const int n_params = num_params(n_hidden);
  const int off_hidden = kIn * kWidth;
  const int off_out = off_hidden + n_hidden * kWidth * kWidth;
  float* part = partial + static_cast<size_t>(blockIdx.x) * (n_params + 1);

  for (int i = tid; i < kIn * kWidth; i += kRows) s_win[i] = __float2bfloat16_rn(w_in[i]);
  for (int i = tid; i < n_hidden * kWidth * kWidth; i += kRows)
    s_wh[i] = __float2bfloat16_rn(w_hidden[i]);
  for (int i = tid; i < kWidth * kOut; i += kRows) s_wout[i] = __float2bfloat16_rn(w_out[i]);
  // input rows, coalesced; rows past the batch are zero and contribute nothing
  for (int i = tid; i < kRows * kIn; i += kRows) {
    const int r = i / kIn, c = i % kIn;
    const float v = row0 + r < batch ? x[static_cast<size_t>(row0 + r) * kIn + c] : 0.f;
    s_x[r * kXStride + c] = __float2bfloat16_rn(v);
  }
  __syncthreads();

  // ---- forward recompute, one row per thread ------------------------------
  float acc[kWidth];
  row_times_w(s_x + tid * kXStride, s_win, kIn, acc);
  uint64_t bits = store_relu(acc, s_act + tid * kActStride);
  if (!kTrain) s_mask[tid] = bits;
  for (int l = 0; l < n_hidden; ++l) {
    row_times_w(s_act + (l * kRows + tid) * kActStride, s_wh + l * kWidth * kWidth, kWidth, acc);
    bits = store_relu(acc, s_act + ((l + 1) * kRows + tid) * kActStride);
    if (!kTrain) s_mask[(l + 1) * kRows + tid] = bits;
  }
  const bf16* a_last = s_act + (n_hidden * kRows + tid) * kActStride;
  bf16* g_row = s_g + tid * kActStride;

  // ---- output gradient into s_g[:, 0:kOut] ---------------------------------
  if (kTrain) {
    // linear output, columns 0-2 only: RelativeL2Luminance (network.py:210-216)
    float pred[3] = {0.f, 0.f, 0.f};
#pragma unroll 4
    for (int k = 0; k < kWidth; ++k) {
      const float a = __bfloat162float(a_last[k]);
#pragma unroll
      for (int c = 0; c < 3; ++c) pred[c] = fmaf(a, __bfloat162float(s_wout[k * kOut + c]), pred[c]);
    }
    const float lum = __fadd_rn(__fadd_rn(__fmul_rn(0.299f, pred[0]), __fmul_rn(0.587f, pred[1])),
                                __fmul_rn(0.114f, pred[2]));
    const float denom = __fadd_rn(__fmul_rn(lum, lum), 0.01f);
    float row_loss = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float diff = live ? __fsub_rn(pred[c], gout[static_cast<size_t>(row) * 3 + c]) : 0.f;
      row_loss = __fadd_rn(row_loss, __fdiv_rn(__fmul_rn(diff, diff), denom));
      g_row[c] = __float2bfloat16_rn(__fdiv_rn(__fmul_rn(grad_scale, diff), denom));
    }
#pragma unroll
    for (int c = 3; c < kOut; ++c) g_row[c] = __float2bfloat16_rn(0.f);
    // CTA loss sum in a fixed order: warp tree, then the warps in turn
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) row_loss += __shfl_xor_sync(0xffffffffu, row_loss, o);
    if ((tid & 31) == 0) s_red[tid >> 5] = row_loss;
  } else {
#pragma unroll
    for (int c = 0; c < kOut; ++c)
      g_row[c] = __float2bfloat16_rn(live ? gout[static_cast<size_t>(row) * kOut + c] : 0.f);
  }
  __syncthreads();
  if (kTrain && tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kRows / 32; ++w) s += s_red[w];
    part[n_params] = s;
  }

  // ---- backward: dW_out, then through w_out^T -------------------------------
  block_at_gout(s_act + n_hidden * kRows * kActStride, s_g, part + off_out);
  __syncthreads();
  const bf16* a_top = s_act + (n_hidden * kRows + tid) * kActStride;
  backprop_row<kOut>(g_row, s_wout, kTrain ? act_mask(a_top) : s_mask[n_hidden * kRows + tid]);
  for (int l = n_hidden - 1; l >= 0; --l) {
    __syncthreads();
    block_at_g<kWidth, kWidth>(s_act + l * kRows * kActStride, kActStride, s_g,
                               part + off_hidden + l * kWidth * kWidth);
    __syncthreads();
    const bf16* a_l = s_act + (l * kRows + tid) * kActStride;
    backprop_row<kWidth>(g_row, s_wh + l * kWidth * kWidth,
                         kTrain ? act_mask(a_l) : s_mask[l * kRows + tid]);
  }
  __syncthreads();
  block_at_g<kIn, kWidth>(s_x, kXStride, s_g, part);

  // ---- K4: dX = g @ w_in^T ----------------------------------------------------
  if (!kTrain && live) {
    float g[kWidth];
#pragma unroll
    for (int j = 0; j < kWidth; j += 2) {
      const float2 v = load2(g_row + j);
      g[j] = v.x;
      g[j + 1] = v.y;
    }
    float* dxr = dx + static_cast<size_t>(row) * kIn;
#pragma unroll 2
    for (int k = 0; k < kIn; ++k) {
      const bf16* wk = s_win + k * kWidth;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int j = 0; j < kWidth; j += 2) {
        const float2 p = load2(wk + j);
        s0 = fmaf(g[j], p.x, s0);
        s1 = fmaf(g[j + 1], p.y, s1);
      }
      dxr[k] = s0 + s1;
    }
  }
}

// out[i] = scale_i * sum over b of partial[b, i], b in order; i < count.
// The last entry (i == count - 1) is scaled by last_scale, and set to 0 when
// num_records is given and holds 0. It goes to *last_out when that is given.
__global__ void reduce_partials(const float* __restrict__ partial, int n_blocks, int stride,
                                int count, float* __restrict__ out, float* __restrict__ last_out,
                                float last_scale, const long long* __restrict__ num_records) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += partial[static_cast<size_t>(b) * stride + i];
  if (last_out != nullptr && i == count - 1) {
    *last_out = (num_records != nullptr && *num_records == 0) ? 0.f : s * last_scale;
  } else {
    out[i] = s;
  }
}

// Launch the gradient kernel and the reduction on `stream`. grad receives
// the P summed weight gradients; with loss != nullptr (K5/K6) *loss receives
// loss_scale times the summed loss (0 when *num_records == 0).
template <bool kTrain>
inline cudaError_t launch_grad(const float* x, const float* gout, const float* w_in,
                               const float* w_hidden, const float* w_out, int batch,
                               int n_hidden, float grad_scale, float* dx, float* partial,
                               float* grad, float* loss, float loss_scale,
                               const long long* num_records, cudaStream_t stream) {
  const int smem = smem_bytes(n_hidden, !kTrain);
  if (smem > kSmemLimit || batch <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(mlp_grad_kernel<kTrain>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (batch + kRows - 1) / kRows;
  mlp_grad_kernel<kTrain><<<blocks, kRows, smem, stream>>>(
      x, gout, w_in, w_hidden, w_out, batch, n_hidden, grad_scale, dx, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_params = num_params(n_hidden);
  const int count = loss != nullptr ? n_params + 1 : n_params;
  reduce_partials<<<(count + 255) / 256, 256, 0, stream>>>(
      partial, blocks, n_params + 1, count, grad, loss, loss_scale, num_records);
  return cudaGetLastError();
}

}  // namespace nrc_mlp
