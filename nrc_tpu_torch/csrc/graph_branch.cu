// Two-way branches inside a captured CUDA graph: conditional IF nodes.
//
// A frame on the card is one CUDA graph replay and reads nothing back, so
// work that depends on a flag the frame computes on the device is captured
// as the bodies of IF nodes (CUDA 12.4 and later), one taken where the flag
// is set and one where it is clear (ops/graph_branch.py).
//
//   nrc_if_begin   on a stream that is being captured: a one-thread kernel
//                  that sets the node's condition from the flag (inverted
//                  with `invert`), the IF node after it, the stream's next
//                  work made to wait for the node, and `body_stream` set to
//                  capture into the node's body graph
//   nrc_if_end     ends the capture of the body on `body_stream`
//
// No TPU kernel stood here: the JAX package branches inside XLA.

#include <cuda_runtime.h>

namespace {

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle, const bool* flag, int invert) {
  const bool taken = (*flag) != (invert != 0);
  cudaGraphSetConditional(handle, taken ? 1u : 0u);
}

}  // namespace

extern "C" int nrc_if_begin(void* stream, const void* flag, int invert, void* body_stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t num_deps = 0;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, nullptr, &num_deps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &num_deps);
#endif
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive) return static_cast<int>(cudaErrorStreamCaptureUnmatched);

  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  set_condition_kernel<<<1, 1, 0, s>>>(handle, static_cast<const bool*>(flag), invert);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // the node depends on what the stream's work depends on now: the kernel
#if CUDART_VERSION >= 13000
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, nullptr, &num_deps);
#else
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &num_deps);
#endif
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, num_deps, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, num_deps, &params);
#endif
  if (err != cudaSuccess) return static_cast<int>(err);
#if CUDART_VERSION >= 13000
  err = cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(body_stream), params.conditional.phGraph_out[0],
                                      nullptr, nullptr, 0, cudaStreamCaptureModeRelaxed);
  return static_cast<int>(err);
}

extern "C" int nrc_if_end(void* body_stream) {
  cudaGraph_t body;
  return static_cast<int>(cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &body));
}
