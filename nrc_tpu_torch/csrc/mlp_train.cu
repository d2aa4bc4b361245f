// Training side of the NRC cache MLP: kernels K5 and K6.
//
// K5 replaces nrc_tpu/ops/mlp_pallas.py::fused_train_grad (_train_kernel):
// forward with bf16-stored activations, the RelativeL2Luminance loss
// (p - t)^2 / (lum(p)^2 + 0.01) on the linear output's columns 0-2 with its
// gradient 2 (p - t) / denom / (3B), then the backward with ReLU masks taken
// from the bf16 activations. Returns the loss and dW_in, dW_hidden, dW_out
// summed over the batch, f32; no dX (the frequency encoding has no
// parameters).
//
// K6 replaces mlp_pallas.py::fused_train4 (_train4_kernel): four sequential
// steps over x4 [4, B, 128] and t4 [4, B, 3]. Each step is the K5 gradient,
// then L2 (1e-6 w), bias-corrected Adam with the step count step0 + k + 1
// read on the device, then the EMA of the weights; weights, moments and EMA
// are updated in place. A frame with no training records (*num_records == 0)
// leaves all of them and the step count unchanged and reports zero losses.
// The TPU kernel's block-diagonal two-half packing is an MXU layout and is
// not carried over. x4 is rounded to bf16 where it is staged, as the TPU
// kernel rounds it before the call.
//
// What bounds them on an H100: the gradient kernel (mlp_grad.cuh) runs every
// product as bf16 mma.sync tiles with the activations in registers, so its
// ~3 x 25,600 multiply-adds per row are 0.0025 ms of tensor-core time at
// B = 16,384, and the 8.6 MB of rows its function must move 0.0026 ms. On top
// it writes [128 CTAs, 25,601] f32 of partial sums (13 MB) that the
// reduction reads back: the price of a sum in a fixed order, and traffic of
// this design, not of the function. The Adam + EMA update is one
// elementwise pass over 25,600 weights (five f32 arrays, ~0.5 MB). K6 is one
// host call that launches, per step, the gradient kernel, the reduction and
// the update on one stream with no host synchronisation (13 launches, each
// waiting for the one before: their latencies, not their work, are K6's
// time), and counts the gradient kernels it launches in *grad_launches,
// which the wrapper adds to K5's launch count. It does not keep the weights
// on chip across the four steps: every step stages them anew.

#include "mlp_grad.cuh"

namespace {

struct AdamArgs {
  float* w[3];
  float* mu[3];
  float* nu[3];
  float* ema[3];
  int n[3];
  float b1, one_minus_b1, b2, one_minus_b2, eps, l2, decay, one_minus_decay;
};

// One L2 + Adam + EMA step over the flat gradient (w_in | w_hidden | w_out),
// in the operation order of ops/mlp_cuda.py::adam_ema (and of
// nrc_tpu/models/network.py::train_step).
__global__ void adam_ema_kernel(const float* __restrict__ grad, AdamArgs a,
                                const long long* __restrict__ step, int k,
                                const float* __restrict__ lr,
                                const long long* __restrict__ num_records) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (*num_records == 0) return;
  float *w, *mu, *nu, *ema;
  int j;
  if (i < a.n[0]) {
    w = a.w[0]; mu = a.mu[0]; nu = a.nu[0]; ema = a.ema[0]; j = i;
  } else if (i < a.n[0] + a.n[1]) {
    w = a.w[1]; mu = a.mu[1]; nu = a.nu[1]; ema = a.ema[1]; j = i - a.n[0];
  } else if (i < a.n[0] + a.n[1] + a.n[2]) {
    w = a.w[2]; mu = a.mu[2]; nu = a.nu[2]; ema = a.ema[2]; j = i - a.n[0] - a.n[1];
  } else {
    return;
  }
  const float t = __fadd_rn(static_cast<float>(*step), static_cast<float>(k + 1));
  const float bc1 = __fsub_rn(1.f, powf(a.b1, t));
  const float bc2 = __fsub_rn(1.f, powf(a.b2, t));
  const float p = w[j];
  const float g = __fadd_rn(grad[i], __fmul_rn(a.l2, p));
  const float m = __fadd_rn(__fmul_rn(a.b1, mu[j]), __fmul_rn(a.one_minus_b1, g));
  const float v = __fadd_rn(__fmul_rn(a.b2, nu[j]), __fmul_rn(__fmul_rn(a.one_minus_b2, g), g));
  const float upd = __fdiv_rn(__fdiv_rn(m, bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), a.eps));
  const float p_new = __fsub_rn(p, __fmul_rn(*lr, upd));
  w[j] = p_new;
  mu[j] = m;
  nu[j] = v;
  ema[j] = __fadd_rn(__fmul_rn(a.decay, ema[j]), __fmul_rn(a.one_minus_decay, p_new));
}

__global__ void advance_step(long long* step, int n, const long long* num_records) {
  if (*num_records > 0) *step += n;
}

}  // namespace

// bytes of dynamic shared memory of a CTA of the gradient kernel (K4-K6)
extern "C" int nrc_mlp_grad_smem_bytes(int n_hidden) { return nrc_mlp::smem_bytes(n_hidden); }

extern "C" int nrc_mlp_train_grad(const float* x, const float* target, const float* w_in,
                                  const float* w_hidden, const float* w_out, int batch,
                                  int n_hidden, float grad_scale, float loss_scale,
                                  float* partial, float* grad, float* loss, void* stream) {
  return static_cast<int>(nrc_mlp::launch_grad<true>(
      x, target, w_in, w_hidden, w_out, batch, n_hidden, grad_scale, nullptr, partial, grad,
      loss, loss_scale, nullptr, static_cast<cudaStream_t>(stream)));
}

extern "C" int nrc_mlp_train4(const float* x4, const float* t4, int n_steps, int batch,
                              int n_hidden, float* w_in, float* w_hidden, float* w_out,
                              float* mu_in, float* mu_hidden, float* mu_out, float* nu_in,
                              float* nu_hidden, float* nu_out, float* ema_in, float* ema_hidden,
                              float* ema_out, long long* step, const float* lr,
                              const long long* num_records, float b1, float one_minus_b1,
                              float b2, float one_minus_b2, float eps, float l2, float decay,
                              float one_minus_decay, float grad_scale, float loss_scale,
                              float* partial, float* grad, float* losses, int* grad_launches,
                              void* stream) {
  using nrc_mlp::kIn;
  using nrc_mlp::kOut;
  using nrc_mlp::kWidth;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  AdamArgs a;
  a.w[0] = w_in; a.w[1] = w_hidden; a.w[2] = w_out;
  a.mu[0] = mu_in; a.mu[1] = mu_hidden; a.mu[2] = mu_out;
  a.nu[0] = nu_in; a.nu[1] = nu_hidden; a.nu[2] = nu_out;
  a.ema[0] = ema_in; a.ema[1] = ema_hidden; a.ema[2] = ema_out;
  a.n[0] = kIn * kWidth;
  a.n[1] = n_hidden * kWidth * kWidth;
  a.n[2] = kWidth * kOut;
  a.b1 = b1; a.one_minus_b1 = one_minus_b1;
  a.b2 = b2; a.one_minus_b2 = one_minus_b2;
  a.eps = eps; a.l2 = l2;
  a.decay = decay; a.one_minus_decay = one_minus_decay;
  const int n_params = nrc_mlp::num_params(n_hidden);
  for (int k = 0; k < n_steps; ++k) {
    cudaError_t err = nrc_mlp::launch_grad<true>(
        x4 + static_cast<size_t>(k) * batch * kIn, t4 + static_cast<size_t>(k) * batch * 3,
        w_in, w_hidden, w_out, batch, n_hidden, grad_scale, nullptr, partial, grad, losses + k,
        loss_scale, num_records, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*grad_launches;  // K5's gradient kernel, launched above
    adam_ema_kernel<<<(n_params + 255) / 256, 256, 0, s>>>(grad, a, step, k, lr, num_records);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  advance_step<<<1, 1, 0, s>>>(step, n_steps, num_records);
  return static_cast<int>(cudaGetLastError());
}
