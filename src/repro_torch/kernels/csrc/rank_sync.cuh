// Flags, waits and byte copies shared by the emulated-rank collectives
// (ring_all_gather.cu, ring_all_to_all.cu).
//
// A collective of the port runs n ranks inside ONE cooperative launch: rank r
// is CTAs [r * parts, (r + 1) * parts), and each of a rank's `parts` CTAs owns
// one contiguous share of every chunk's bytes.  The TPU kernels' DMA
// semaphores become int flags in device memory:
//
// * a sender CTA stores its share, then every thread passes a barrier
//   (bar.sync) and one thread per flag raises it with a release add
//   (`red.release.<scope>`).  A release is cumulative, so it also publishes
//   the stores that the CTA's other threads made before the barrier; no
//   separate fence is needed.
// * a waiting CTA polls with acquire loads, one thread per flag (several
//   flags are polled at once), with no sleep between polls, then releases
//   its other threads with a barrier: the acquire and the barrier order
//   their later loads after the producer's stores.
//
// Scope is a compile-time parameter of the helpers.  The kernels use
// Scope::kGpu: every rank is a CTA of one grid on one card, which is the only
// case that exists.  Ranks on separate cards (peers over NVLink) need
// Scope::kSys.
//
// Flags are never zeroed per call.  The wrapper keeps one flag buffer per
// (device, stream, n, parts, set of flags raised) and passes a call epoch
// e = 1, 2, ...; a flag raised c times per call is complete in call e when it
// reaches e * c.  The kernels on one stream run one after another, so a flag
// never holds a later call's raises while an earlier call waits on it.  The
// wrapper zeroes a new buffer when (e * c) would pass INT32_MAX, and drops a
// buffer after a failed wait or launch (_rank_sync.py).
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
constexpr int kUnroll = 8;                    // 16-byte words in flight per thread
constexpr long long kSpinLimit = 1ll << 22;   // polls of one wait (a second or two)
constexpr long long kBytesPerPart = 32 * 1024;

enum class Scope { kGpu, kSys };

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

template <Scope S>
__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  if constexpr (S == Scope::kGpu)
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  else
    asm volatile("ld.acquire.sys.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

template <Scope S>
__device__ __forceinline__ void add_release(int* p) {
  if constexpr (S == Scope::kGpu)
    asm volatile("red.release.gpu.global.add.s32 [%0], %1;" ::"l"(p), "r"(1) : "memory");
  else
    asm volatile("red.release.sys.global.add.s32 [%0], %1;" ::"l"(p), "r"(1) : "memory");
}

// Called by every thread of the CTA after its stores: after a barrier,
// thread i < 4 raises the i-th non-null flag by one.
template <Scope S>
__device__ __forceinline__ void raise_flags(int* a, int* b, int* c = nullptr,
                                            int* d = nullptr) {
  __syncthreads();
  int* const flag = threadIdx.x == 0 ? a : threadIdx.x == 1 ? b
                  : threadIdx.x == 2 ? c : threadIdx.x == 3 ? d : nullptr;
  if (flag) add_release<S>(flag);
}

// One wait: poll *flag until it reaches target; code goes to the error word
// if the poll limit runs out.
struct Wait {
  const int* flag;
  int target;
  int code;
};

// Called by every thread of the CTA: thread i < count polls at(i) (a Wait),
// all at once.  Returns false for the whole CTA when a poll limit ran out;
// the first failure's code is left in the error word.
template <Scope S, typename At>
__device__ __forceinline__ bool wait_all(int count, At at, volatile int* err) {
  int failed = 0;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const Wait w = at(i);
    long long polls = 0;
    while (load_acquire<S>(w.flag) < w.target) {
      if (++polls == kSpinLimit) {
        if (*err == 0) *err = w.code;
        __threadfence_system();
        failed = 1;
        break;
      }
    }
  }
  return !__syncthreads_or(failed);
}

template <Scope S>
__device__ __forceinline__ bool wait_for(const int* flag, int target, int code,
                                         volatile int* err) {
  return wait_all<S>(1, [&](int) { return Wait{flag, target, code}; }, err);
}

// Copies words [lo, hi) of src to dst0 (and dst1 when non-null: one read,
// two destinations).  Loads and stores go through L2 only (.cg): the data
// was written by other CTAs during this kernel, and L1 is not coherent.
// A thread copies the same words in every call with the same [lo, hi).
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
