// Fully-fused forward pass of the NRC cache MLP (kernel K3) on the tensor cores.
//
// Replaces the TPU kernel nrc_tpu/ops/mlp_pallas.py::fused_forward
// (_fwd_kernel): the bias-free chain 128 -> 64 -> (64 -> 64) x n_hidden -> 16
// with ReLU between layers and an optional ReLU on the output. Operands are
// bf16 and sums are f32, as there: the input and every hidden activation are
// rounded to bf16 before each product (nrc_tpu/models/network.py:169-183),
// the weights are rounded to bf16 when staged.
//
// What bounds it on an H100: a row is 512 bytes in and 64 out against
// 2 x 25,600 operations, which the tensor cores do at 989 TFLOP/s: 0.0053 ms
// for 102,400 rows against 0.0176 ms for their bytes at 3.35 TB/s. So device
// memory, provided the products run as mma and the activations never leave
// the SM. The design (mma_tiles.cuh has the tiles and fragment maps):
//  - a warp owns 16 rows; each product is mma.sync m16n8k16 (bf16, f32 sums);
//  - x goes straight from device memory into A fragments: a lane reads
//    float2 pairs of its two rows, a quad one full 32-byte sector per row,
//    and no barrier or shared-memory round trip is needed;
//  - from layer to layer the activations stay in registers: the accumulator
//    fragments, after ReLU and rounding, are the next product's A fragments;
//  - the weights are staged once per CTA as bf16 in shared memory (58,368
//    bytes for the shipped network, rows padded to 72 and 24 for
//    conflict-free ldmatrix), and the CTAs are persistent: about two per SM,
//    each walking over 128-row tiles, so the staging is paid once per CTA,
//    not once per 128 rows.

#include <mutex>

#include "mma_tiles.cuh"

namespace {

using namespace nrc_mma;

constexpr int kThreads = kCtaThreads;                      // 8 warps
constexpr int kTileRows = (kThreads / 32) * kWarpRows;     // 128 rows per CTA and turn

__global__ void __launch_bounds__(kThreads, 2) mlp_forward_kernel(
    const float* __restrict__ x, const float* __restrict__ w_in,
    const float* __restrict__ w_hidden, const float* __restrict__ w_out, int batch,
    int n_hidden, int output_relu, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_in = reinterpret_cast<bf16*>(smem_raw);           // [kIn, kStride]
  bf16* s_hidden = s_in + kIn * kStride;                    // [n_hidden, kWidth, kStride]
  bf16* s_out = s_hidden + n_hidden * kWidth * kStride;     // [kWidth, kOutStride]
  stage_weights(w_in, w_hidden, w_out, n_hidden, s_in, s_hidden, s_out);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int num_tiles = (batch + kTileRows - 1) / kTileRows;
  for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int warp_row0 = tile * kTileRows + warp * kWarpRows;
    if (warp_row0 >= batch) continue;  // the ragged edge; no barrier follows
    const int rows[2] = {warp_row0 + a_row(lane, 0), warp_row0 + a_row(lane, 1)};

    // x -> A fragments; rows past the batch read as zero
    uint32_t a[kIn / 16][4];
#pragma unroll
    for (int kt = 0; kt < kIn / 16; ++kt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = rows[j & 1];
        float2 v = make_float2(0.f, 0.f);
        if (row < batch)
          v = __ldcs(reinterpret_cast<const float2*>(
              x + static_cast<size_t>(row) * kIn + kt * 16 + a_col(lane, j)));
        a[kt][j] = pack_bf16(v.x, v.y);
      }
    }

    float acc[kWidth / 8][4];
    uint32_t h[kWidth / 16][4];
    zero_acc(acc);
    mm_a_w<kIn / 16, kWidth / 8, kStride>(a, s_in, acc, lane);
    relu_to_a(acc, h);
    for (int layer = 0; layer < n_hidden; ++layer) {
      zero_acc(acc);
      mm_a_w<kWidth / 16, kWidth / 8, kStride>(h, s_hidden + layer * kWidth * kStride, acc, lane);
      relu_to_a(acc, h);
    }
    float o[kOut / 8][4];
    zero_acc(o);
    mm_a_w<kWidth / 16, kOut / 8, kOutStride>(h, s_out, o, lane);

#pragma unroll
    for (int nt = 0; nt < kOut / 8; ++nt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float2 r = make_float2(o[nt][2 * half], o[nt][2 * half + 1]);
        if (output_relu) r = make_float2(fmaxf(r.x, 0.f), fmaxf(r.y, 0.f));
        const int row = rows[half];
        if (row < batch)
          __stcs(reinterpret_cast<float2*>(out + static_cast<size_t>(row) * kOut + nt * 8 +
                                           frag_col(lane, 0)),
                 r);
      }
    }
  }
}

// The grid of persistent CTAs (as many as the card holds at once) for one
// (device, bytes of shared memory): asked of the runtime at the first launch
// and kept, so that a launch costs the host no occupancy query.
cudaError_t resident_ctas(int smem_bytes, int* ctas) {
  static std::mutex lock;
  static int known_device = -1, known_smem = -1, known_ctas = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> guard(lock);
  if (device != known_device || smem_bytes != known_smem) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(mlp_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    smem_bytes)) != cudaSuccess)
      return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mlp_forward_kernel, kThreads,
                                                             smem_bytes)) != cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    known_device = device;
    known_smem = smem_bytes;
    known_ctas = sms * per_sm;
  }
  *ctas = known_ctas;
  return cudaSuccess;
}

}  // namespace

// bytes of dynamic shared memory of a CTA: the weights staged as bf16
extern "C" int nrc_mlp_forward_smem_bytes(int n_hidden) {
  return staged_weight_halves(n_hidden) * static_cast<int>(sizeof(bf16));
}

extern "C" int nrc_mlp_forward(const float* x, const float* w_in, const float* w_hidden,
                               const float* w_out, int batch, int n_hidden, int output_relu,
                               float* out, void* stream) {
  const int smem_bytes = nrc_mlp_forward_smem_bytes(n_hidden);
  if (smem_bytes > kSmemLimit || batch <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int ctas = 0;
  const cudaError_t err = resident_ctas(smem_bytes, &ctas);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (batch + kTileRows - 1) / kTileRows;
  const int blocks = tiles < ctas ? tiles : ctas;
  mlp_forward_kernel<<<blocks, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      x, w_in, w_hidden, w_out, batch, n_hidden, output_relu, out);
  return static_cast<int>(cudaGetLastError());
}
