// Fully-fused forward pass of the NRC cache MLP: one thread per batch row.
//
// Replaces the TPU kernel nrc_tpu/ops/mlp_pallas.py::fused_forward
// (_fwd_kernel): the bias-free chain 128 -> 64 -> (64 -> 64) x n_hidden -> 16
// with ReLU between layers and an optional ReLU on the output. Operands are
// bf16 and sums are f32, as there: the input and every hidden activation are
// rounded to bf16 before each product (nrc_tpu/models/network.py:169-183),
// the weights are rounded to bf16 when staged.
//
// What bounds it on an H100: 2 x (128*64 + 4*64*64 + 64*16) = 51,200 flops
// per row against 576 bytes of input and output, so compute, not memory. A
// CTA of kRows threads stages all weights in shared memory as bf16
// (51,200 bytes for the shipped network, above the 48 KB default, hence the
// cudaFuncAttributeMaxDynamicSharedMemorySize opt-in below) and keeps each
// row's 64-wide activation and accumulator in registers. Every thread of a
// warp reads the same weight at the same time (a shared-memory broadcast).
// This runs on the CUDA cores in f32 FMA; moving the chain onto the tensor
// cores (mma.sync / wgmma on 64-row tiles) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kIn = 128;     // padded encoded input (nrc_tpu LANE)
constexpr int kWidth = 64;   // hidden width
constexpr int kOut = 16;     // padded output (RGB in columns 0-2)
constexpr int kRows = 128;   // rows (threads) per CTA

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__global__ void __launch_bounds__(kRows) mlp_forward_kernel(
    const float* __restrict__ x, const float* __restrict__ w_in,
    const float* __restrict__ w_hidden, const float* __restrict__ w_out, int batch,
    int n_hidden, int output_relu, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* s_in = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kIn, kWidth]
  __nv_bfloat16* s_hidden = s_in + kIn * kWidth;           // [n_hidden, kWidth, kWidth]
  __nv_bfloat16* s_out = s_hidden + n_hidden * kWidth * kWidth;  // [kWidth, kOut]
  for (int i = threadIdx.x; i < kIn * kWidth; i += kRows) s_in[i] = __float2bfloat16_rn(w_in[i]);
  for (int i = threadIdx.x; i < n_hidden * kWidth * kWidth; i += kRows)
    s_hidden[i] = __float2bfloat16_rn(w_hidden[i]);
  for (int i = threadIdx.x; i < kWidth * kOut; i += kRows) s_out[i] = __float2bfloat16_rn(w_out[i]);
  __syncthreads();

  const int row = blockIdx.x * kRows + threadIdx.x;
  if (row >= batch) return;  // the ragged edge; no barrier follows

  float acc[kWidth];
  float h[kWidth];
#pragma unroll
  for (int j = 0; j < kWidth; ++j) acc[j] = 0.f;
  const float4* xr = reinterpret_cast<const float4*>(x + static_cast<size_t>(row) * kIn);
#pragma unroll 2
  for (int k4 = 0; k4 < kIn / 4; ++k4) {
    const float4 v = xr[k4];
    const float xs[4] = {bf16_round(v.x), bf16_round(v.y), bf16_round(v.z), bf16_round(v.w)};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const __nv_bfloat16* wrow = s_in + (k4 * 4 + q) * kWidth;
#pragma unroll
      for (int j = 0; j < kWidth; ++j) acc[j] = fmaf(xs[q], __bfloat162float(wrow[j]), acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kWidth; ++j) h[j] = bf16_round(fmaxf(acc[j], 0.f));

  for (int layer = 0; layer < n_hidden; ++layer) {
    const __nv_bfloat16* w = s_hidden + layer * kWidth * kWidth;
#pragma unroll
    for (int j = 0; j < kWidth; ++j) acc[j] = 0.f;
#pragma unroll
    for (int k = 0; k < kWidth; ++k) {
      const __nv_bfloat16* wrow = w + k * kWidth;
#pragma unroll
      for (int j = 0; j < kWidth; ++j) acc[j] = fmaf(h[k], __bfloat162float(wrow[j]), acc[j]);
    }
#pragma unroll
    for (int j = 0; j < kWidth; ++j) h[j] = bf16_round(fmaxf(acc[j], 0.f));
  }

  float o[kOut];
#pragma unroll
  for (int j = 0; j < kOut; ++j) o[j] = 0.f;
#pragma unroll
  for (int k = 0; k < kWidth; ++k) {
#pragma unroll
    for (int j = 0; j < kOut; ++j) o[j] = fmaf(h[k], __bfloat162float(s_out[k * kOut + j]), o[j]);
  }
  float4* orow = reinterpret_cast<float4*>(out + static_cast<size_t>(row) * kOut);
#pragma unroll
  for (int j4 = 0; j4 < kOut / 4; ++j4) {
    float4 r = make_float4(o[4 * j4 + 0], o[4 * j4 + 1], o[4 * j4 + 2], o[4 * j4 + 3]);
    if (output_relu) {
      r.x = fmaxf(r.x, 0.f);
      r.y = fmaxf(r.y, 0.f);
      r.z = fmaxf(r.z, 0.f);
      r.w = fmaxf(r.w, 0.f);
    }
    orow[j4] = r;
  }
}

}  // namespace

extern "C" int nrc_mlp_forward(const float* x, const float* w_in, const float* w_hidden,
                               const float* w_out, int batch, int n_hidden, int output_relu,
                               float* out, void* stream) {
  const int smem_bytes =
      (kIn * kWidth + n_hidden * kWidth * kWidth + kWidth * kOut) * static_cast<int>(sizeof(__nv_bfloat16));
  cudaError_t err = cudaFuncSetAttribute(
      mlp_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (batch + kRows - 1) / kRows;
  mlp_forward_kernel<<<blocks, kRows, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      x, w_in, w_hidden, w_out, batch, n_hidden, output_relu, out);
  return static_cast<int>(cudaGetLastError());
}
