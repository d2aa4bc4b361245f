// Backward pass of the NRC cache MLP (kernel K4).
//
// Replaces the TPU kernel nrc_tpu/ops/mlp_pallas.py::fused_backward
// (_bwd_kernel): recompute the bias-free forward chain per row block, keep
// the f32 pre-activations' signs for the ReLU masks, then walk the chain
// backward from the output gradient g [B, 16]. Returns dX [B, 128] and the
// weight gradients dW_in [128, 64], dW_hidden [H, 64, 64], dW_out [64, 16]
// summed over the batch, all f32. Operands of every product are bf16, sums
// f32, as there.
//
// What bounds it on an H100: per row about 3 x 25,600 multiply-adds
// (forward, backward, dW) on the tensor cores against 576 bytes of x and g in
// and 512 bytes of dX out, plus the partial sums of dW: device memory, not
// operations. The design (mlp_grad.cuh, the kTrain = false instantiation of
// the kernel K5 uses): a warp owns 16 rows and runs every product as bf16
// mma.sync tiles, activations and gradients passing from layer to layer in
// registers; weights and a 128-row block's bf16 activations lie in shared
// memory (~204 KB, one CTA per SM); dW is summed per CTA into a scratch row
// and the rows are reduced in a fixed order by a second kernel, so the
// result does not depend on CTA scheduling.

#include "mlp_grad.cuh"

extern "C" int nrc_mlp_backward(const float* x, const float* g_out, const float* w_in,
                                const float* w_hidden, const float* w_out, int batch,
                                int n_hidden, float* dx, float* partial, float* grad,
                                void* stream) {
  return static_cast<int>(nrc_mlp::launch_grad<false>(
      x, g_out, w_in, w_hidden, w_out, batch, n_hidden, 0.f, dx, partial, grad, nullptr, 0.f,
      static_cast<cudaStream_t>(stream)));
}
