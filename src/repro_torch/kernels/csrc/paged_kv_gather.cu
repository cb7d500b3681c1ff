// Paged KV block gather for Hopper (sm_90a): out[i] = pool[table[i]].
//
// Replaces the Pallas TPU kernel `paged_kv_gather` / `_gather_kernel` in
// src/repro/kernels/paged_kv_gather/paged_kv_gather.py, where the block table
// is a scalar-prefetch operand and each grid step copies one
// [block_tokens, d_kv] block through VMEM.
//
// Bound on the H100: HBM bytes.  The kernel reads and writes
// n * block_tokens * d_kv * itemsize bytes each and does no arithmetic, so
// its floor is 2 * that over 3.35 TB/s.  At the serving shape (64 blocks of
// 16 x 3072 bf16, 6 MiB each way) that is about 3.8 us, so the launch costs
// as much as the copy.
//
// Design: a 2-D grid over (block, chunk of the block).  One CTA per block
// would give 64 CTAs for 132 SMs; cutting each 96 KiB block into 16 KiB
// chunks gives 384 CTAs, enough to keep every SM's load queue busy.  Each CTA
// reads its own table entry (the TPU's scalar prefetch) and copies its chunk
// with 16-byte vector loads and stores when the block's bytes and both base
// pointers are 16-byte aligned, else with the widest scalar word that
// divides them.  The copy is of raw bytes, so every dtype is bit-exact.  A
// table entry outside [0, n_pool) reads nothing and zero-fills its block, so
// a bad index cannot fault the card.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWordsPerThread = 4;  // words in flight per thread per chunk

template <typename W>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const W* __restrict__ pool, const int* __restrict__ table,
              W* __restrict__ out, long long words_per_block, int n_pool) {
  const long long chunk = (long long)kThreads * kWordsPerThread;
  const long long start = (long long)blockIdx.y * chunk;
  const long long stop = min(start + chunk, words_per_block);
  const int src = table[blockIdx.x];
  W* dst = out + (long long)blockIdx.x * words_per_block;
  if (src < 0 || src >= n_pool) {
    const W zero{};
    for (long long e = start + threadIdx.x; e < stop; e += kThreads) dst[e] = zero;
    return;
  }
  const W* from = pool + (long long)src * words_per_block;
#pragma unroll
  for (int u = 0; u < kWordsPerThread; ++u) {
    const long long e = start + threadIdx.x + (long long)u * kThreads;
    if (e < stop) dst[e] = from[e];
  }
}

template <typename W>
int launch(const void* pool, const int* table, void* out, int n_blocks, int n_pool,
           long long block_bytes, cudaStream_t stream) {
  const long long words = block_bytes / (long long)sizeof(W);
  const long long chunk = (long long)kThreads * kWordsPerThread;
  const long long chunks = (words + chunk - 1) / chunk;
  if (chunks > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)n_blocks, (unsigned)chunks);
  gather_kernel<W><<<grid, kThreads, 0, stream>>>(
      static_cast<const W*>(pool), table, static_cast<W*>(out), words, n_pool);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int paged_kv_gather(const void* pool, const int* table, void* out,
                               int n_blocks, int n_pool, long long block_bytes,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_blocks <= 0 || block_bytes <= 0) return 0;
  const uintptr_t align = (uintptr_t)pool | (uintptr_t)out | (uintptr_t)block_bytes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (align % 16 == 0) return launch<uint4>(pool, table, out, n_blocks, n_pool, block_bytes, s);
  if (align % 4 == 0) return launch<uint32_t>(pool, table, out, n_blocks, n_pool, block_bytes, s);
  if (align % 2 == 0) return launch<uint16_t>(pool, table, out, n_blocks, n_pool, block_bytes, s);
  return launch<uint8_t>(pool, table, out, n_blocks, n_pool, block_bytes, s);
}
