// Row gather out[i, :] = table[idx[i], :] for a float32 table [R, P] and
// int64 indices [N], in three variants.
//
// Replaces the three TPU kernels of tools/bench_gather_pallas.py, which all
// compute this function at the shape of the wide BVH walk's unified node +
// leaf table ([R, 160] float32, 640 bytes a row):
//   nrc_gather_rows          <- bench_dma's dma_kernel: the table stays in
//                               device memory, K row copies in flight
//   nrc_gather_rows_resident <- bench_vmem's vmem_kernel: the table (8192
//                               rows) resident in the core's fast memory
//   nrc_gather_rows_block    <- bench_blockspec's bs_kernel: one grid step
//                               per gathered row
//
// What bounds it on an H100: bytes. Each gathered row is read once and
// written once (2 x N x P x 4 bytes) plus 8 bytes of index; there is no
// arithmetic at all. At N = 102,400 and P = 160 that is 132 MB, 39 us at the
// card's 3.35 TB/s. The design answers with wide, coalesced accesses and
// enough of them in flight:
// - warp variant: one warp copies a row with 16-byte loads and stores, lanes
//   on neighbouring addresses, and owns kRowsPerWarp rows at a time, whose
//   loads are all issued before the first store, so four rows' reads are in
//   flight per warp. cp.async or TMA row copies are later work.
// - resident variant: a megabyte-sized fast memory has no counterpart in a
//   block's 227 KB of shared memory, so this ports the idea the TPU variant
//   tested ("pin the top levels"): each block (one per SM, looping over its
//   share of the rows) first stages the table's leading S rows, as many as
//   fit, in shared memory, then serves idx < S from there and the rest from
//   device memory. The walk's table puts the node rows first, root at row 0,
//   so the leading rows are the top levels of the tree. The staging itself
//   reads S rows per block from the L2, which a small N cannot pay back. An
//   L2 persisting window over the leading rows was the other candidate; the
//   whole table of the port's scene (about 10 MB) already fits the 50 MB L2,
//   so a window would pin what is resident anyway.
// - block variant: one thread block of 64 threads per gathered row, loading
//   its own index: the TPU variant's grid, whose cost is one block launch
//   per 640 bytes.
//
// Rows are copied as 32-bit words (uint4 where P % 4 == 0 and both bases are
// 16-byte aligned, else word by word). No floating-point instruction touches
// them: the walk's rows hold child metas and primitive ids as bit-cast
// integers, many of which are NaN patterns. An index outside [0, R) is
// clamped, so a bad index cannot read outside the table.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kWarpThreads = 256;       // 8 warps per block
constexpr int kRowsPerWarp = 4;         // rows in flight per warp
constexpr int kBlockThreads = 64;       // block variant: one row per block
constexpr int kResidentThreads = 512;
constexpr int kResidentBytes = 227 * 1024;  // a block's opt-in shared memory

__device__ __forceinline__ long long clamp_row(long long r, int num_rows) {
  return r < 0 ? 0 : (r >= num_rows ? num_rows - 1 : r);
}

template <typename Word>
__global__ void __launch_bounds__(kWarpThreads) gather_warp_kernel(
    const Word* __restrict__ table, const long long* __restrict__ idx, Word* __restrict__ out,
    int n, int row_words, int num_rows) {
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * kWarpThreads + threadIdx.x) >> 5;
  const long long num_warps = (static_cast<long long>(gridDim.x) * kWarpThreads) >> 5;
  for (long long base = warp * kRowsPerWarp; base < n; base += num_warps * kRowsPerWarp) {
    const Word* src[kRowsPerWarp];
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) {
      // rows past the end repeat the last row: loaded, never stored
      const long long i = base + k < n ? base + k : n - 1;
      src[k] = table + clamp_row(idx[i], num_rows) * row_words;
    }
    for (int w = lane; w < row_words; w += 32) {
      Word v[kRowsPerWarp];
#pragma unroll
      for (int k = 0; k < kRowsPerWarp; ++k) v[k] = src[k][w];
#pragma unroll
      for (int k = 0; k < kRowsPerWarp; ++k)
        if (base + k < n) out[(base + k) * row_words + w] = v[k];
    }
  }
}

template <typename Word>
__global__ void __launch_bounds__(kBlockThreads) gather_block_kernel(
    const Word* __restrict__ table, const long long* __restrict__ idx, Word* __restrict__ out,
    int row_words, int num_rows) {
  const long long i = blockIdx.x;
  const Word* src = table + clamp_row(idx[i], num_rows) * row_words;
  Word* dst = out + i * row_words;
  for (int w = threadIdx.x; w < row_words; w += kBlockThreads) dst[w] = src[w];
}

template <typename Word>
__global__ void __launch_bounds__(kResidentThreads) gather_resident_kernel(
    const Word* __restrict__ table, const long long* __restrict__ idx, Word* __restrict__ out,
    int n, int row_words, int num_rows, int staged_rows) {
  extern __shared__ uint4 staged_raw[];
  Word* staged = reinterpret_cast<Word*>(staged_raw);
  const long long staged_words = static_cast<long long>(staged_rows) * row_words;
  for (long long w = threadIdx.x; w < staged_words; w += kResidentThreads) staged[w] = table[w];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warps_per_block = kResidentThreads >> 5;
  const long long warp = static_cast<long long>(blockIdx.x) * warps_per_block + (threadIdx.x >> 5);
  const long long num_warps = static_cast<long long>(gridDim.x) * warps_per_block;
  for (long long i = warp; i < n; i += num_warps) {
    const long long r = clamp_row(idx[i], num_rows);
    const Word* src = r < staged_rows ? staged + r * row_words : table + r * row_words;
    Word* dst = out + i * row_words;
    for (int w = lane; w < row_words; w += 32) dst[w] = src[w];
  }
}

bool vector_ok(const void* table, const void* out, int row_words) {
  return row_words % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

// The SM count, and the resident kernel's limit of dynamic shared memory
// raised to kResidentBytes, once per device: a launch then makes no query
// and no attribute call (both cost the host time at every launch).
template <typename Word>
cudaError_t resident_setup(int* sms) {
  static std::mutex lock;
  static int known_device = -1, known_sms = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> guard(lock);
  if (device != known_device) {
    int count = 0;
    if ((err = cudaFuncSetAttribute(gather_resident_kernel<Word>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    kResidentBytes)) != cudaSuccess)
      return err;
    if ((err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device)) !=
        cudaSuccess)
      return err;
    known_device = device;
    known_sms = count > 0 ? count : 1;
  }
  *sms = known_sms;
  return cudaSuccess;
}

template <typename Word>
int launch_resident(const Word* table, const long long* idx, Word* out, int n, int row_words,
                    int num_rows, cudaStream_t stream) {
  const int row_bytes = row_words * static_cast<int>(sizeof(Word));
  int staged_rows = kResidentBytes / row_bytes;
  if (staged_rows > num_rows) staged_rows = num_rows;
  const int smem = staged_rows * row_bytes;
  int sms = 1;
  cudaError_t err = resident_setup<Word>(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps_per_block = kResidentThreads >> 5;
  int blocks = (n + warps_per_block - 1) / warps_per_block;
  if (blocks > sms) blocks = sms;
  gather_resident_kernel<Word><<<blocks, kResidentThreads, smem, stream>>>(
      table, idx, out, n, row_words, num_rows, staged_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int nrc_gather_rows(const void* table, const void* idx, void* out, int n,
                               int row_words, int num_rows, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* ix = static_cast<const long long*>(idx);
  const int rows_per_block = (kWarpThreads >> 5) * kRowsPerWarp;
  const int blocks = (n + rows_per_block - 1) / rows_per_block;
  if (vector_ok(table, out, row_words)) {
    gather_warp_kernel<uint4><<<blocks, kWarpThreads, 0, s>>>(
        static_cast<const uint4*>(table), ix, static_cast<uint4*>(out), n, row_words / 4, num_rows);
  } else {
    gather_warp_kernel<uint32_t><<<blocks, kWarpThreads, 0, s>>>(
        static_cast<const uint32_t*>(table), ix, static_cast<uint32_t*>(out), n, row_words,
        num_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nrc_gather_rows_resident(const void* table, const void* idx, void* out, int n,
                                        int row_words, int num_rows, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* ix = static_cast<const long long*>(idx);
  if (vector_ok(table, out, row_words)) {
    return launch_resident<uint4>(static_cast<const uint4*>(table), ix, static_cast<uint4*>(out),
                                  n, row_words / 4, num_rows, s);
  }
  return launch_resident<uint32_t>(static_cast<const uint32_t*>(table), ix,
                                   static_cast<uint32_t*>(out), n, row_words, num_rows, s);
}

extern "C" int nrc_gather_rows_block(const void* table, const void* idx, void* out, int n,
                                     int row_words, int num_rows, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* ix = static_cast<const long long*>(idx);
  if (vector_ok(table, out, row_words)) {
    gather_block_kernel<uint4><<<n, kBlockThreads, 0, s>>>(
        static_cast<const uint4*>(table), ix, static_cast<uint4*>(out), row_words / 4, num_rows);
  } else {
    gather_block_kernel<uint32_t><<<n, kBlockThreads, 0, s>>>(
        static_cast<const uint32_t*>(table), ix, static_cast<uint32_t*>(out), row_words, num_rows);
  }
  return static_cast<int>(cudaGetLastError());
}
