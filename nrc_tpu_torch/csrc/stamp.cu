// Device stamps: the time at which the stream reached a point of a frame.
//
// A stamp is one thread that reads the card's %globaltimer (nanoseconds) and
// writes it into a ring of frames, ring[frame % rows][slot]. The frame is
// read on the device from the renderer's frame counter, so a CUDA graph that
// holds stamps writes a row of its own at every replay. On one stream a
// kernel starts once the kernel before it has ended, so a stamp reads the
// time between the work before it and the work after it; the spans of a
// frame are the differences of its stamps (utils/spans.py).
//
//   nrc_stamp          one stamp
//   nrc_timer_ticks    the timer's least step: a thread reads it `reads`
//                      times and keeps the least nonzero difference
//
// No TPU kernel stood here: the JAX package has no counterpart.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned long long global_timer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void stamp_kernel(long long* ring, const long long* frame, int rows, int slots, int slot) {
  const long long f = *frame;
  const long long row = ((f % rows) + rows) % rows;
  ring[row * slots + slot] = static_cast<long long>(global_timer());
}

__global__ void ticks_kernel(long long* out, int reads) {
  unsigned long long prev = global_timer();
  const unsigned long long first = prev;
  unsigned long long least = ~0ull;
  for (int i = 0; i < reads; ++i) {
    const unsigned long long t = global_timer();
    if (t != prev) {
      if (t - prev < least) least = t - prev;
      prev = t;
    }
  }
  out[0] = static_cast<long long>(least == ~0ull ? 0ull : least);
  out[1] = static_cast<long long>(prev - first);
}

}  // namespace

extern "C" int nrc_stamp(void* ring, const void* frame, int rows, int slots, int slot, void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(ring), static_cast<const long long*>(frame), rows, slots, slot);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nrc_timer_ticks(void* out, int reads, void* stream) {
  ticks_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<long long*>(out), reads);
  return static_cast<int>(cudaGetLastError());
}
