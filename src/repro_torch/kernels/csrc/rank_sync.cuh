// Flags, waits and byte copies shared by the emulated-rank collectives
// (ring_all_gather.cu, ring_all_to_all.cu).
//
// A collective of the port runs n ranks inside ONE cooperative launch: rank r
// is CTAs [r * parts, (r + 1) * parts), and each of a rank's `parts` CTAs owns
// one contiguous share of every chunk's bytes.  The TPU kernels' DMA
// semaphores become int flags in device memory, one per (rank, step):
//
// * a sender CTA stores its share, then raises the flags with a system-scope
//   release add (`red.release.sys`), after a barrier of its threads and a
//   system fence, so the same code holds when the ranks are separate cards;
// * a waiting CTA polls with an acquire load in one thread, then releases its
//   other threads with a barrier.  A flag is complete when it counts `parts`
//   (every CTA of the sending rank finished its share).
//
// Every wait is bounded: after kSpinLimit polls it writes an error word and
// the CTA returns, so a lost flag ends the kernel instead of hanging the card.
// The error word lives in pinned host memory mapped into the device, so the
// host reads it without synchronising (`*_error()` in each library).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rank_sync {

constexpr int kMaxRanks = 64;
constexpr int kThreads = 512;
constexpr int kUnroll = 4;                    // words in flight per thread
constexpr long long kSpinLimit = 1ll << 22;   // polls of one wait (seconds with the sleeps)
constexpr long long kBytesPerPart = 32 * 1024;

// Per-rank base pointers, passed by value in the kernel's parameter space
// (the device's constant bank): the rank buffers need not be one
// allocation, and no table is uploaded per call.
struct RankPtrs {
  const void* in[kMaxRanks];
  void* out[kMaxRanks];
};

// What a failed wait was waiting for; packed into the error word with the
// rank, the step and the stream (0 rightward / all-to-all, 1 leftward).
enum WaitKind { kBarrier = 1, kSend = 2, kRecv = 3 };

__host__ __device__ constexpr int error_code(int kind, int stream, int rank, int step) {
  return (1 << 30) | (kind << 24) | (stream << 20) | (rank << 10) | step;
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.sys.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void add_release(int* p) {
  asm volatile("red.release.sys.global.add.s32 [%0], %1;" ::"l"(p), "r"(1) : "memory");
}

// Called by every thread of the CTA after its stores; thread 0 raises each
// non-null flag by one.
__device__ __forceinline__ void raise_flags(int* a, int* b, int* c = nullptr,
                                            int* d = nullptr) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    if (a) add_release(a);
    if (b) add_release(b);
    if (c) add_release(c);
    if (d) add_release(d);
  }
}

// Called by every thread of the CTA: thread 0 polls until *flag >= target.
// Returns false for the whole CTA when the poll limit ran out; the first
// failure's code is left in the error word.
__device__ __forceinline__ bool wait_for(const int* flag, int target, int code,
                                         volatile int* err) {
  int failed = 0;
  if (threadIdx.x == 0) {
    long long polls = 0;
    while (load_acquire(flag) < target) {
      if (++polls == kSpinLimit) {
        if (*err == 0) *err = code;
        __threadfence_system();
        failed = 1;
        break;
      }
      __nanosleep(128);
    }
    __threadfence();
  }
  return !__syncthreads_or(failed);
}

// Copies words [lo, hi) of src to dst0 (and dst1 when non-null: one read,
// two destinations).  Loads and stores go through L2 only (.cg): the data
// was written by other CTAs during this kernel, and L1 is not coherent.
template <typename W>
__device__ __forceinline__ void copy_words(const W* src, W* dst0, W* dst1, long long lo,
                                           long long hi) {
  for (long long base = lo + threadIdx.x; base < hi; base += (long long)kThreads * kUnroll) {
    W v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long e = base + (long long)u * kThreads;
      if (e < hi) v[u] = __ldcg(src + e);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long e = base + (long long)u * kThreads;
      if (e < hi) {
        __stcg(dst0 + e, v[u]);
        if (dst1) __stcg(dst1 + e, v[u]);
      }
    }
  }
}

// The error word of this library: one int of pinned host memory mapped into
// the device's address space.  0 means no wait has failed.
struct ErrorWord {
  int* host = nullptr;
  int* device = nullptr;
};

inline ErrorWord& error_word() {
  static ErrorWord word;
  return word;
}

inline cudaError_t ensure_error_word() {
  ErrorWord& w = error_word();
  if (w.host) return cudaSuccess;
  int* host = nullptr;
  cudaError_t err = cudaHostAlloc((void**)&host, sizeof(int), cudaHostAllocMapped);
  if (err != cudaSuccess) return err;
  *(volatile int*)host = 0;
  err = cudaHostGetDevicePointer((void**)&w.device, host, 0);
  if (err != cudaSuccess) {
    cudaFreeHost(host);
    return err;
  }
  w.host = host;
  return cudaSuccess;
}

// Shares per rank: enough CTAs that each moves about kBytesPerPart per step,
// at most sm_count / n so every CTA of the grid has an SM of its own (the CTAs
// wait on each other, so all must be resident: the launch is cooperative).
// `requested` > 0 overrides the choice.  Returns 0 when it cannot be met.
inline int choose_parts(int n, long long chunk_bytes, int requested, int device) {
  int sms = 0, coop = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device) != cudaSuccess ||
      !coop)
    return 0;
  const int max_parts = sms / n;
  if (max_parts < 1) return 0;
  if (requested > 0) return requested <= max_parts ? requested : 0;
  long long parts = (chunk_bytes + kBytesPerPart - 1) / kBytesPerPart;
  if (parts < 1) parts = 1;
  return (int)(parts < max_parts ? parts : max_parts);
}

// Widest word that divides every rank pointer and the chunk size, so the
// copy moves raw bytes and is bit-exact in every dtype.
inline int word_bytes(const RankPtrs& ptrs, int n, long long chunk_bytes) {
  uintptr_t align = (uintptr_t)chunk_bytes;
  for (int r = 0; r < n; ++r) align |= (uintptr_t)ptrs.in[r] | (uintptr_t)ptrs.out[r];
  if (align % 16 == 0) return 16;
  if (align % 4 == 0) return 4;
  if (align % 2 == 0) return 2;
  return 1;
}

}  // namespace rank_sync
