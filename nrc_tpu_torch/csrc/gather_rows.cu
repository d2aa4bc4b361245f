// Row gather out[i, :] = table[idx[i], :] for a float32 table [R, P] and
// int64 indices [N], in three variants.
//
// Replaces the three TPU kernels of tools/bench_gather_pallas.py, which all
// compute this function at the shape of the wide BVH walk's unified node +
// leaf table ([R, 160] float32, 640 bytes a row):
//   nrc_gather_rows          <- bench_dma's dma_kernel: the table stays in
//                               device memory, K row copies in flight
//   nrc_gather_rows_resident <- bench_vmem's vmem_kernel: the table (8192
//                               rows, 5.2 MB) resident in the core's fast
//                               memory
//   nrc_gather_rows_block    <- bench_blockspec's bs_kernel: one grid step
//                               per gathered row
//
// What bounds it on an H100: bytes. Each distinct row the indices name is
// read once, each gathered row written once, plus 8 bytes of index; there is
// no arithmetic at all. At N = 102,400 random indices into [131072, 160]
// (about 71,000 distinct rows) that is 112 MB, 33 us at the card's 3.35 TB/s.
// The design answers with wide, coalesced accesses and enough of them in
// flight:
// - warp variant (K7): one warp copies a row with 16-byte loads and stores,
//   lanes on neighbouring addresses, and owns kRowsPerWarp rows at a time,
//   whose loads are all issued before the first store, so four rows' reads
//   are in flight per warp.
// - resident variant (K8): the TPU kernel's fast memory of that size is, on
//   this card, the 50 MB L2, not a block's 227 KB of shared memory (a block
//   that staged the table's leading rows there would read 30 MB at the
//   bench's shape before serving a row, and serve 0.3 % of random indices
//   from them). So the table is kept in the L2 for the launch: its rows are
//   read with an evict-last
//   cache policy when the table fits half the L2, and the gathered rows are
//   written with an evict-first policy, so that the output streaming through
//   the L2 does not displace the table. The rows move with Hopper's bulk
//   asynchronous copies: each of a block's 128 threads owns a ring of row
//   slots in shared memory, issues cp.async.bulk global -> shared for its
//   next rows (completion on one mbarrier per slot), and sends each row that
//   has arrived back with a bulk store shared -> global, so a block keeps
//   128 x (slots - 1) rows in flight with no register or instruction spent
//   on their bytes. A slot is refilled once its store has read it
//   (cp.async.bulk.wait_group.read). Bulk copies need rows of a multiple of
//   16 bytes on 16-byte aligned bases (the path's tri_shade and tris.packed
//   rows are 104 and 36 bytes); such a table, or one whose rows do not fit
//   two slots a thread, is served by K8's word loop: the warp variant's loop
//   with the same L2 policies on its loads and stores.
// - block variant (K9): one thread block of 64 threads per gathered row,
//   loading its own index: the TPU variant's grid, whose cost is one block
//   launch per 640 bytes.
//
// Rows are copied as 32-bit words or as raw bytes (uint4 where P % 4 == 0 and
// both bases are 16-byte aligned, else word by word; the bulk copies move
// bytes). No floating-point instruction touches them: the walk's rows hold
// child metas and primitive ids as bit-cast integers, many of which are NaN
// patterns. An index outside [0, R) is clamped, so a bad index cannot read
// outside the table.

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>

namespace {

constexpr int kWarpThreads = 256;       // 8 warps per block
constexpr int kRowsPerWarp = 4;         // rows in flight per warp
constexpr int kBlockThreads = 64;       // block variant: one row per block
constexpr int kBulkThreads = 128;       // resident variant: row lanes a block, a ring each
constexpr int kBulkMaxSlots = 8;        // row slots a lane at most
constexpr int kBulkSmemBytes = 227 * 1024;  // a block's opt-in shared memory

// bytes of the resident variant's mbarriers (8 a slot), padded to 128
__host__ __device__ inline int bulk_ring_offset(int slots) {
  return (kBulkThreads * slots * 8 + 127) / 128 * 128;
}

// row slots a lane of the resident variant gets for rows of row_bytes
inline int bulk_slots(int row_bytes) {
  int slots = kBulkMaxSlots;
  while (slots > 0 && bulk_ring_offset(slots) + kBulkThreads * slots * row_bytes > kBulkSmemBytes)
    --slots;
  return slots;
}

__device__ __forceinline__ long long clamp_row(long long r, int num_rows) {
  return r < 0 ? 0 : (r >= num_rows ? num_rows - 1 : r);
}

// A word of a row through the L2 under a cache policy (K8), or plainly (K7).
template <bool kHinted>
__device__ __forceinline__ uint32_t load_word(const uint32_t* p, uint64_t policy) {
  uint32_t v;
  if (kHinted)
    asm("ld.global.L2::cache_hint.b32 %0, [%1], %2;" : "=r"(v) : "l"(p), "l"(policy));
  else
    v = *p;
  return v;
}

template <bool kHinted>
__device__ __forceinline__ uint4 load_word(const uint4* p, uint64_t policy) {
  uint4 v;
  if (kHinted)
    asm("ld.global.L2::cache_hint.v4.b32 {%0, %1, %2, %3}, [%4], %5;"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
        : "l"(p), "l"(policy));
  else
    v = *p;
  return v;
}

template <bool kHinted>
__device__ __forceinline__ void store_word(uint32_t* p, uint32_t v, uint64_t policy) {
  if (kHinted)
    asm volatile("st.global.L2::cache_hint.b32 [%0], %1, %2;" ::"l"(p), "r"(v), "l"(policy));
  else
    *p = v;
}

template <bool kHinted>
__device__ __forceinline__ void store_word(uint4* p, uint4 v, uint64_t policy) {
  if (kHinted)
    asm volatile("st.global.L2::cache_hint.v4.b32 [%0], {%1, %2, %3, %4}, %5;" ::"l"(p), "r"(v.x),
                 "r"(v.y), "r"(v.z), "r"(v.w), "l"(policy));
  else
    *p = v;
}

// L2 policies of K8: the table's rows evict-last when it fits half the L2
// (else evict-normal), the gathered rows evict-first
__device__ __forceinline__ void resident_policies(int keep_table, uint64_t* keep, uint64_t* stream) {
  if (keep_table) {
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, %1;" : "=l"(*keep) : "f"(1.f));
  } else {
    asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, %1;" : "=l"(*keep) : "f"(1.f));
  }
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, %1;" : "=l"(*stream) : "f"(1.f));
}

// K7 (kResident false), and K8's word loop for rows the bulk copies cannot
// move (kResident true: the loads and stores carry K8's L2 policies)
template <typename Word, bool kResident>
__global__ void __launch_bounds__(kWarpThreads) gather_warp_kernel(
    const Word* __restrict__ table, const long long* __restrict__ idx, Word* __restrict__ out,
    int n, int row_words, int num_rows, int keep_table) {
  uint64_t keep = 0, stream = 0;
  if (kResident) resident_policies(keep_table, &keep, &stream);
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
      for (int k = 0; k < kRowsPerWarp; ++k) v[k] = load_word<kResident>(src[k] + w, keep);
#pragma unroll
      for (int k = 0; k < kRowsPerWarp; ++k)
        if (base + k < n) store_word<kResident>(out + (base + k) * row_words + w, v[k], stream);
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

// ---- K8: bulk copies through a ring of row slots per thread --------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// row global -> shared; the mbarrier's phase completes when its bytes have landed
__device__ __forceinline__ void load_row(uint32_t dst, const void* src, uint32_t bytes,
                                         uint32_t bar, uint64_t policy) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

// row shared -> global, as one bulk group of its own
__device__ __forceinline__ void store_row(void* dst, uint32_t src, uint32_t bytes,
                                          uint64_t policy) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;" ::"l"(
                   dst),
               "r"(src), "r"(bytes), "l"(policy)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

__global__ void __launch_bounds__(kBulkThreads) gather_bulk_kernel(
    const unsigned char* __restrict__ table, const long long* __restrict__ idx,
    unsigned char* __restrict__ out, int n, int row_bytes, int num_rows, int slots,
    int keep_table) {
  extern __shared__ __align__(128) unsigned char bulk_smem[];
  const int t = threadIdx.x;
  // this thread's ring: `slots` mbarriers, and `slots` rows after all barriers
  const uint32_t bars = smem_u32(bulk_smem) + t * slots * 8;
  const uint32_t ring = smem_u32(bulk_smem) + bulk_ring_offset(slots) + t * slots * row_bytes;
  for (int j = 0; j < slots; ++j) mbar_init(bars + 8 * j);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  uint64_t keep, stream;
  resident_policies(keep_table, &keep, &stream);

  const long long step = static_cast<long long>(gridDim.x) * kBulkThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kBulkThreads + t;
  const int mine = first < n ? static_cast<int>((n - 1 - first) / step + 1) : 0;
  // the r-th of this thread's rows goes to slot r % slots
  auto issue = [&](int r) {
    const long long row = clamp_row(idx[first + r * step], num_rows);
    load_row(ring + (r % slots) * row_bytes, table + row * row_bytes, row_bytes,
             bars + 8 * (r % slots), keep);
  };
  for (int r = 0; r < slots && r < mine; ++r) issue(r);
  for (int r = 0; r < mine; ++r) {
    const int slot = r % slots;
    mbar_wait(bars + 8 * slot, (r / slots) & 1);
    store_row(out + (first + r * step) * row_bytes, ring + slot * row_bytes, row_bytes, stream);
    // refill the slot of row r - 1 once its store (committed an iteration ago) has read it
    if (r >= 1 && r - 1 + slots < mine) {
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      issue(r - 1 + slots);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

bool vector_ok(const void* table, const void* out, int row_words) {
  return row_words % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

// Per device: the SM count, the L2's size, and the bulk kernel's limit of
// dynamic shared memory raised to kBulkSmemBytes, once; and per (device,
// shared memory a block) the blocks of the bulk kernel an SM holds, once
// (smem 0: not asked). A launch then makes no query and no attribute call
// (both cost the host time).
cudaError_t resident_setup(int smem, int* sms, int* l2_bytes, int* per_sm) {
  static std::mutex lock;
  static int known_device = -1, known_sms = 0, known_l2 = 0;
  static std::map<int, int> known_per_sm;  // smem -> blocks an SM, on known_device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> guard(lock);
  if (device != known_device) {
    int count = 0, l2 = 0;
    if ((err = cudaFuncSetAttribute(gather_bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    kBulkSmemBytes)) != cudaSuccess)
      return err;
    if ((err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device)) !=
        cudaSuccess)
      return err;
    if ((err = cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, device)) != cudaSuccess)
      return err;
    known_device = device;
    known_sms = count > 0 ? count : 1;
    known_l2 = l2;
    known_per_sm.clear();
  }
  *sms = known_sms;
  *l2_bytes = known_l2;
  if (smem == 0) return cudaSuccess;
  auto it = known_per_sm.find(smem);
  if (it == known_per_sm.end()) {
    int blocks = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, gather_bulk_kernel,
                                                             kBulkThreads, smem)) != cudaSuccess)
      return err;
    it = known_per_sm.emplace(smem, blocks > 0 ? blocks : 1).first;
  }
  *per_sm = it->second;
  return cudaSuccess;
}

int warp_blocks(int n) {
  const int rows_per_block = (kWarpThreads >> 5) * kRowsPerWarp;
  return (n + rows_per_block - 1) / rows_per_block;
}

}  // namespace

extern "C" int nrc_gather_rows(const void* table, const void* idx, void* out, int n,
                               int row_words, int num_rows, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* ix = static_cast<const long long*>(idx);
  if (vector_ok(table, out, row_words)) {
    gather_warp_kernel<uint4, false><<<warp_blocks(n), kWarpThreads, 0, s>>>(
        static_cast<const uint4*>(table), ix, static_cast<uint4*>(out), n, row_words / 4, num_rows,
        0);
  } else {
    gather_warp_kernel<uint32_t, false><<<warp_blocks(n), kWarpThreads, 0, s>>>(
        static_cast<const uint32_t*>(table), ix, static_cast<uint32_t*>(out), n, row_words,
        num_rows, 0);
  }
  return static_cast<int>(cudaGetLastError());
}

// K8: the table kept in the L2; bulk row copies where the rows allow them,
// else K8's word loop (see the note at the top).
extern "C" int nrc_gather_rows_resident(const void* table, const void* idx, void* out, int n,
                                        int row_words, int num_rows, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* ix = static_cast<const long long*>(idx);
  const int row_bytes = row_words * 4;
  const int slots = bulk_slots(row_bytes);
  const bool vec = vector_ok(table, out, row_words);
  const bool bulk = vec && slots >= 2;
  const int smem = bulk ? bulk_ring_offset(slots) + kBulkThreads * slots * row_bytes : 0;
  int sms = 1, l2 = 0, per_sm = 1;
  cudaError_t err = resident_setup(smem, &sms, &l2, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int keep = static_cast<long long>(num_rows) * row_bytes <= l2 / 2;
  if (bulk) {
    long long blocks = (static_cast<long long>(n) + kBulkThreads - 1) / kBulkThreads;
    if (blocks > static_cast<long long>(sms) * per_sm) blocks = static_cast<long long>(sms) * per_sm;
    gather_bulk_kernel<<<static_cast<int>(blocks), kBulkThreads, smem, s>>>(
        static_cast<const unsigned char*>(table), ix, static_cast<unsigned char*>(out), n,
        row_bytes, num_rows, slots, keep);
  } else if (vec) {
    gather_warp_kernel<uint4, true><<<warp_blocks(n), kWarpThreads, 0, s>>>(
        static_cast<const uint4*>(table), ix, static_cast<uint4*>(out), n, row_words / 4, num_rows,
        keep);
  } else {
    gather_warp_kernel<uint32_t, true><<<warp_blocks(n), kWarpThreads, 0, s>>>(
        static_cast<const uint32_t*>(table), ix, static_cast<uint32_t*>(out), n, row_words,
        num_rows, keep);
  }
  return static_cast<int>(cudaGetLastError());
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
