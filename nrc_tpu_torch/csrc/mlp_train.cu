// Training side of the NRC cache MLP: kernels K5 and K6.
//
// K5 replaces nrc_tpu/ops/mlp_pallas.py::fused_train_grad (_train_kernel):
// forward with bf16-stored activations, the RelativeL2Luminance loss
// (p - t)^2 / (lum(p)^2 + 0.01) on the linear output's columns 0-2 with its
// gradient 2 (p - t) / denom / (3B), then the backward with ReLU masks taken
// from the bf16 activations. Returns the loss and dW_in, dW_hidden, dW_out
// summed over the batch, f32; no dX (the frequency encoding has no
// parameters). Two launches: the gradient kernel of mlp_grad.cuh (one
// 128-row tile a CTA) and reduce_partials.
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
// What bounds K6 on an H100: its function moves 35 MB (the rows of four
// steps, the weights, both moments and the EMA read and written once):
// 0.0105 ms at 3.35 TB/s; its bf16 products take 0.009 ms at 989 TFLOP/s.
// What it cannot avoid on top is the dependence of each step on the one
// before: step k + 1 needs every weight that step k's update wrote, and that
// update needs the gradient summed over every row of step k. The TPU kernel
// runs its grid in order on one core; here the grid is 128 CTAs.
//
// The design: one persistent, cooperative launch for all four steps
// (mlp_train4_kernel). The wrapper chooses the grid (ops/mlp_cuda.py::
// train4_grid: one CTA per SM, no more than 128-row tiles) and sizes the
// partial rows by it; the launch only checks that the grid can be co-resident
// (the occupancy query, once per device, times the SMs), and the cooperative
// launch refuses a grid that does not fit. Per step each CTA stages the current
// weights as bf16 and runs grad_tile() (mlp_grad.cuh, the K5 body,
// unchanged in arithmetic) over its 128-row tiles, summing them into its
// partial row in tile order; a grid barrier; then each CTA adds a fixed
// slice of the 25,601 entries over all CTAs' partial rows in CTA order (the
// same order as reduce_partials, so the same bits as K5's reduction) and, in
// the same pass, applies L2 + Adam + EMA to that slice and writes the new
// weights, moments and EMA; a second grid barrier; the next step. The step
// count advances inside the kernel. A CTA arrives at the first barrier as
// soon as its partial row is written and stages the next step's input rows
// before it waits, so the staging overlaps the wait for the slowest CTA's
// gradient (the gradient bodies differ by up to 3 us a step across CTAs,
// NVIDIA H100 80GB HBM3, 700 W). The partial rows stay in the L2
// (13 MB written and read per step at B = 16,384): a thread block cluster
// summing its CTAs' partial rows through distributed shared memory would
// need a CTA's 102 KB f32 partial in shared memory beside the 204 KB the
// gradient body holds until its last product, which does not fit 227 KB.
//
// The grid barrier is written here on device-global counters (g_barrier):
// an arrival count for launches of even and one for launches of odd
// parity, and the number of launches. A CTA arrives with one release-add
// and waits until the count of its launch's parity reaches gridDim.x times
// the barriers passed so far: nothing is reset between barriers. Every CTA
// reads the launch number before its first arrival; after the last
// barrier, which all CTAs have reached, CTA 0 sets the other parity's count
// to 0 and advances the launch number. So the next launch, and the next
// replay of a captured one, starts on a clean count. (A barrier whose last
// arrival reset the count and opened a new generation took 0.1504 ms for
// K6 against 0.1485 for this one, and staging the next rows before arriving
// 0.1485 against 0.1456 for arriving first, in one call, NVIDIA H100 80GB
// HBM3, 700 W.) The counters are one per device; launches of K6 on one
// device must not overlap (they are issued on one stream). A launch the
// runtime refuses raises in the wrapper; nothing falls back to another way
// of running the four steps.

#include <cuda_runtime.h>

#include <mutex>

#include "mlp_grad.cuh"

namespace {

using nrc_mlp::kIn;
using nrc_mlp::kOut;
using nrc_mlp::kRows;
using nrc_mlp::kThreads;
using nrc_mlp::kWidth;

// arrivals of launches of even parity, of odd parity; launches
__device__ unsigned int g_barrier[3];

__device__ __forceinline__ unsigned int load_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// A grid barrier in two halves. What any thread of the grid wrote before its
// CTA's arrival is visible to every thread after the wait; between the two
// a CTA may do work that no other CTA reads.
__device__ __forceinline__ void barrier_arrive(unsigned int* count) {
  __syncthreads();
  if (threadIdx.x == 0) asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(count) : "memory");
}

__device__ __forceinline__ void barrier_wait(const unsigned int* count, unsigned int target) {
  if (threadIdx.x == 0)
    while (load_acquire(count) < target) __nanosleep(20);
  __syncthreads();
}

struct Train4Params {
  const float* x4;   // [n_steps, batch, 128]
  const float* t4;   // [n_steps, batch, 3]
  float* w[3];       // w_in | w_hidden | w_out, and likewise below
  float* mu[3];
  float* nu[3];
  float* ema[3];
  int n[3];          // their sizes
  long long* step;
  const float* lr;
  const long long* num_records;
  float* partial;    // [gridDim.x, P + 1]
  float* losses;     // [n_steps]
  int n_steps, batch, n_hidden, tiles;
  float b1, one_minus_b1, b2, one_minus_b2, eps, l2, decay, one_minus_decay;
  float grad_scale, loss_scale;
};

// One L2 + Adam + EMA update of flat parameter i (w_in | w_hidden | w_out)
// with the summed gradient g, at step count t, in the operation order of
// ops/mlp_cuda.py::adam_ema (and of nrc_tpu/models/network.py::train_step).
__device__ __forceinline__ void adam_ema(const Train4Params& p, int i, float grad, float t,
                                         float lr) {
  int j = i, a = 0;
  if (j >= p.n[0]) {
    j -= p.n[0];
    a = 1;
    if (j >= p.n[1]) {
      j -= p.n[1];
      a = 2;
    }
  }
  float* w = p.w[a];
  float* mu = p.mu[a];
  float* nu = p.nu[a];
  float* ema = p.ema[a];
  const float bc1 = __fsub_rn(1.f, powf(p.b1, t));
  const float bc2 = __fsub_rn(1.f, powf(p.b2, t));
  const float w_old = __ldcg(w + j);  // other CTAs read w through the L2 only
  const float g = __fadd_rn(grad, __fmul_rn(p.l2, w_old));
  const float m = __fadd_rn(__fmul_rn(p.b1, mu[j]), __fmul_rn(p.one_minus_b1, g));
  const float v = __fadd_rn(__fmul_rn(p.b2, nu[j]), __fmul_rn(__fmul_rn(p.one_minus_b2, g), g));
  const float upd = __fdiv_rn(__fdiv_rn(m, bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), p.eps));
  const float w_new = __fsub_rn(w_old, __fmul_rn(lr, upd));
  __stcg(w + j, w_new);
  mu[j] = m;
  nu[j] = v;
  ema[j] = __fadd_rn(__fmul_rn(p.decay, ema[j]), __fmul_rn(p.one_minus_decay, w_new));
}

constexpr int kReduceUnroll = 16;  // partial rows whose loads a thread has in flight

__global__ void __launch_bounds__(kThreads, 1) mlp_train4_kernel(const Train4Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // a frame with no records changes nothing (every CTA reads the same count)
  if (*p.num_records == 0) {
    if (blockIdx.x == 0 && static_cast<int>(threadIdx.x) < p.n_steps) p.losses[threadIdx.x] = 0.f;
    return;
  }
  const nrc_mlp::GradSmem s = nrc_mlp::carve_smem(smem_raw, p.n_hidden);
  const long long step0 = *p.step;
  const float lr = *p.lr;
  const int n_params = nrc_mlp::num_params(p.n_hidden);
  const int stride = n_params + 1;  // a partial row: the P gradients and the loss
  float* part = p.partial + static_cast<size_t>(blockIdx.x) * stride;
  const int slice = (stride + gridDim.x - 1) / gridDim.x;
  const int e_begin = blockIdx.x * slice;
  const int e_end = min(e_begin + slice, stride);
  const int n_blocks = gridDim.x;
  const unsigned int parity = load_acquire(&g_barrier[2]) & 1u;
  unsigned int* count = &g_barrier[parity];
  unsigned int passed = 0;  // barriers this launch has passed

  nrc_mlp::stage_rows(p.x4, p.batch, blockIdx.x * kRows, s.x);
  for (int k = 0; k < p.n_steps; ++k) {
    const float* x = p.x4 + static_cast<size_t>(k) * p.batch * kIn;
    const float* t = p.t4 + static_cast<size_t>(k) * p.batch * 3;
    // ---- the gradient of step k over this CTA's tiles, in tile order -------------
    nrc_mlp::stage_weights<true>(p.w[0], p.w[1], p.w[2], p.n_hidden, s.win, s.wh, s.wout);
    __syncthreads();
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const bool later = tile != static_cast<int>(blockIdx.x);
      if (later) {
        __syncthreads();  // the previous tile's last reads of s.x and s.g
        nrc_mlp::stage_rows(x, p.batch, tile * kRows, s.x);
        __syncthreads();
      }
      nrc_mlp::grad_tile<true>(s, t, p.batch, p.n_hidden, p.grad_scale, tile * kRows, nullptr,
                               part, later);
    }
    barrier_arrive(count);
    if (k + 1 < p.n_steps)  // the next step's first tile, while the slowest CTA finishes
      nrc_mlp::stage_rows(x + static_cast<size_t>(p.batch) * kIn, p.batch, blockIdx.x * kRows,
                          s.x);
    barrier_wait(count, ++passed * gridDim.x);

    // ---- this CTA's slice: the sum over the partial rows in CTA order, then
    // ---- L2 + Adam + EMA, or the step's loss -------------------------------------
    const float tk = __fadd_rn(static_cast<float>(step0), static_cast<float>(k + 1));
    for (int e = e_begin + static_cast<int>(threadIdx.x); e < e_end; e += kThreads) {
      const float* col = p.partial + e;
      float sum = 0.f;
      int b = 0;
      for (; b + kReduceUnroll <= n_blocks; b += kReduceUnroll) {
        float v[kReduceUnroll];
#pragma unroll
        for (int j = 0; j < kReduceUnroll; ++j) v[j] = __ldcg(col + static_cast<size_t>(b + j) * stride);
#pragma unroll
        for (int j = 0; j < kReduceUnroll; ++j) sum += v[j];
      }
      for (; b < n_blocks; ++b) sum += __ldcg(col + static_cast<size_t>(b) * stride);
      if (e == n_params) {
        p.losses[k] = sum * p.loss_scale;
      } else {
        adam_ema(p, e, sum, tk, lr);
      }
    }
    if (k + 1 < p.n_steps) {  // step k + 1 stages the new weights
      barrier_arrive(count);
      barrier_wait(count, ++passed * gridDim.x);
    }
  }
  // every CTA read the step count and the launch number before its first
  // arrival, and has arrived at the last barrier, which CTA 0 has passed
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *p.step = step0 + p.n_steps;
    g_barrier[parity ^ 1u] = 0;
    __threadfence();
    atomicAdd(&g_barrier[2], 1u);
  }
}

// Per device: the SM count and how many CTAs of mlp_train4_kernel an SM
// holds at `smem` bytes, with the kernel's limit of dynamic shared memory
// raised to `smem`; queried once per (device, smem), so a launch makes no
// attribute call.
cudaError_t train4_setup(int smem, int* sms, int* per_sm) {
  static std::mutex lock;
  static int known_device = -1, known_smem = -1, known_sms = 0, known_per_sm = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> guard(lock);
  if (device != known_device || smem != known_smem) {
    int count = 0, blocks = 0;
    if ((err = cudaFuncSetAttribute(mlp_train4_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    smem)) != cudaSuccess)
      return err;
    if ((err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device)) !=
        cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, mlp_train4_kernel, kThreads,
                                                             smem)) != cudaSuccess)
      return err;
    known_device = device;
    known_smem = smem;
    known_sms = count;
    known_per_sm = blocks;
  }
  *sms = known_sms;
  *per_sm = known_per_sm;
  return cudaSuccess;
}

}  // namespace

// bytes of dynamic shared memory of a CTA of the gradient kernel (K4-K6)
extern "C" int nrc_mlp_grad_smem_bytes(int n_hidden) { return nrc_mlp::smem_bytes(n_hidden); }

extern "C" int nrc_mlp_train_grad(const float* x, const float* target, const float* w_in,
                                  const float* w_hidden, const float* w_out, int batch,
                                  int n_hidden, float grad_scale, float loss_scale,
                                  float* partial, float* grad, float* loss, void* stream) {
  return static_cast<int>(nrc_mlp::launch_grad<true>(
      x, target, w_in, w_hidden, w_out, batch, n_hidden, grad_scale, nullptr, partial, grad, loss,
      loss_scale, static_cast<cudaStream_t>(stream)));
}

// K6: one cooperative launch of `grid` CTAs, the rows of partial ([grid,
// P + 1] f32), which the caller chose (ops/mlp_cuda.py::train4_grid). Returns
// cudaErrorCooperativeLaunchTooLarge when they cannot be co-resident.
extern "C" int nrc_mlp_train4(const float* x4, const float* t4, int n_steps, int batch,
                              int n_hidden, float* w_in, float* w_hidden, float* w_out,
                              float* mu_in, float* mu_hidden, float* mu_out, float* nu_in,
                              float* nu_hidden, float* nu_out, float* ema_in, float* ema_hidden,
                              float* ema_out, long long* step, const float* lr,
                              const long long* num_records, float b1, float one_minus_b1,
                              float b2, float one_minus_b2, float eps, float l2, float decay,
                              float one_minus_decay, float grad_scale, float loss_scale,
                              int grid, float* partial, float* losses, void* stream) {
  const int smem = nrc_mlp::smem_bytes(n_hidden);
  const int tiles = (batch + kRows - 1) / kRows;
  // a CTA with no tile would leave its partial row unwritten
  if (n_hidden > nrc_mlp::kMaxHidden || smem > nrc_mlp::kSmemLimit || batch <= 0 ||
      n_steps <= 0 || grid <= 0 || grid > tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0, per_sm = 0;
  cudaError_t err = train4_setup(smem, &sms, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (grid > sms * per_sm) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  Train4Params p;
  p.x4 = x4;
  p.t4 = t4;
  p.w[0] = w_in; p.w[1] = w_hidden; p.w[2] = w_out;
  p.mu[0] = mu_in; p.mu[1] = mu_hidden; p.mu[2] = mu_out;
  p.nu[0] = nu_in; p.nu[1] = nu_hidden; p.nu[2] = nu_out;
  p.ema[0] = ema_in; p.ema[1] = ema_hidden; p.ema[2] = ema_out;
  p.n[0] = kIn * kWidth;
  p.n[1] = n_hidden * kWidth * kWidth;
  p.n[2] = kWidth * kOut;
  p.step = step;
  p.lr = lr;
  p.num_records = num_records;
  p.partial = partial;
  p.losses = losses;
  p.n_steps = n_steps;
  p.batch = batch;
  p.n_hidden = n_hidden;
  p.tiles = tiles;
  p.b1 = b1; p.one_minus_b1 = one_minus_b1;
  p.b2 = b2; p.one_minus_b2 = one_minus_b2;
  p.eps = eps; p.l2 = l2;
  p.decay = decay; p.one_minus_decay = one_minus_decay;
  p.grad_scale = grad_scale;
  p.loss_scale = loss_scale;

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, mlp_train4_kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
