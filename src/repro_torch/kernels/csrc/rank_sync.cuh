// Flags, waits and byte copies shared by the rank collectives
// (ring_all_gather.cu, ring_all_to_all.cu; ring_reduce_scatter.cu uses them
// on its per-rank path only, at Scope::kSys: RankFlags, error_code, wait_for,
// raise_flags, copy_words, word_bytes, prepare_call, the error word, kThreads,
// kUnroll and kSysWaitNs, so a change to any of them changes that kernel too).
//
// Each collective has two paths, with one kernel body:
//
// * Emulated ranks (Scope::kGpu): ONE cooperative launch runs all n ranks on
//   one card: rank r is CTAs [r * parts, (r + 1) * parts), and the operands
//   are rank-stacked contiguous tensors, passed as base pointers.  Every
//   flag is raised and polled at gpu scope, since every rank is a CTA of one
//   grid.
// * One rank per process (Scope::kSys): each process launches only its own
//   rank's `parts` CTAs, and stores into its peers' outputs through CUDA IPC
//   mappings.  Every flag a rank waits on lives in that rank's own memory:
//   it polls locally, and its peers raise with a system-scope release, as a
//   TPU's DMA semaphore lives on the receiving device.  On one card without
//   MPS the processes' kernels take turns by time slice, so a wait may last
//   several slices: its limit is a time (kSysWaitNs), not a poll count,
//   since a kernel that is switched out does not poll.
//
// The TPU kernels' DMA semaphores become int flags in device memory:
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
// Scope is a compile-time parameter of the helpers and of the kernels.
//
// Flags are never zeroed per call.  The wrapper keeps one flag buffer per
// (device, stream, n, parts, set of flags raised; per rank: chunk bytes and
// slot, each rank's own, _rank_sync.SymmetricBuffers) and passes a call epoch
// e = 1, 2, ...; a flag raised c times per call is complete in call e when it
// reaches e * c.  The kernels on one stream run one after another, so a flag
// never holds a later call's raises while an earlier call waits on it.  The
// wrapper zeroes a new buffer when (e * c) would pass INT32_MAX, and drops a
// buffer after a failed wait or launch (_rank_sync.py).
//
// The CTAs per rank are chosen on the host, once per call shape
// (`_rank_sync.py`), and passed in: no call queries the device's attributes.
//
// Every wait is bounded (kSpinLimit polls at gpu scope, kSysWaitNs at system
// scope): then it writes an error word and the CTA returns, so a lost flag
// ends the kernel instead of hanging the card.
// The error word lives in pinned host memory mapped into the device, so the
// host reads it without synchronising or calling into the library
// (`<name>_error_word()` gives its host address once).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rank_sync {

constexpr int kMaxRanks = 64;
constexpr int kThreads = 512;
constexpr int kUnroll = 8;                    // 16-byte words in flight per thread
constexpr long long kSpinLimit = 1ll << 22;   // polls of one wait (a second or two)
// One wait of the per-rank path, in ns of the global timer.  Set from the
// cross-process flag round trip that tools/flag_probe.py measures on one
// H100 (PERF.md §6): a token's lap of a ring of 2 processes takes 4.5 ms
// (time slices; 3.9 us between two streams of one process), of 8 processes
// 72-75 ms.  4 s is 53 laps of 8 processes, about 900 of 2.
constexpr unsigned long long kSysWaitNs = 4000000000ull;

enum class Scope { kGpu, kSys };

// Per-rank base pointers, passed by value in the kernel's parameter space
// (the device's constant bank), so no table is uploaded per call
// (ring_all_gather.cu fills it from the rank-stacked base pointers).
struct RankPtrs {
  const void* in[kMaxRanks];
  void* out[kMaxRanks];
};

// Per-rank flag regions, beside RankPtrs: rank r's flags start at of[r].
// Emulated ranks: one buffer cut in regions of equal size; one rank per
// process: each rank's own buffer, its peers' mapped through CUDA IPC.
struct RankFlags {
  int* of[kMaxRanks];
};

// Where a launch's ranks are: rank `rank_base + blockIdx.x / parts` runs
// the CTA.  The emulated path passes rank_base 0 and a grid of n * parts;
// the per-rank path passes its own rank and a grid of parts.
struct Ranks {
  RankPtrs ptrs;
  RankFlags flags;
  int rank_base;
};

// What a failed wait was waiting for; packed into the error word with the
// rank, the step and the stream (0 rightward / all-to-all, 1 leftward).
// kArrive: the all-to-all's count of the CTAs that stored into a rank.
enum WaitKind { kBarrier = 1, kSend = 2, kRecv = 3, kArrive = 4 };

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

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The bound of one wait: kSpinLimit polls at gpu scope; kSysWaitNs of the
// global timer at system scope (read every 256 polls).
template <Scope S>
struct PollLimit {
  long long polls = 0;
  unsigned long long deadline = 0;
  __device__ __forceinline__ PollLimit() {
    if constexpr (S == Scope::kSys) deadline = global_ns() + kSysWaitNs;
  }
  __device__ __forceinline__ bool spent() {
    if constexpr (S == Scope::kGpu) return ++polls == kSpinLimit;
    else return (++polls & 255) == 0 && global_ns() > deadline;
  }
};

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
    PollLimit<S> limit;
    while (load_acquire<S>(w.flag) < w.target) {
      if (limit.spent()) {
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

// Widest word that divides both base pointers and the chunk size (every rank
// and chunk offset is a multiple of it), so the copy moves raw bytes and is
// bit-exact in every dtype.
inline int word_bytes(const void* in, const void* out, long long chunk_bytes) {
  const uintptr_t align = (uintptr_t)chunk_bytes | (uintptr_t)in | (uintptr_t)out;
  if (align % 16 == 0) return 16;
  if (align % 4 == 0) return 4;
  if (align % 2 == 0) return 2;
  return 1;
}

// Checks of a call's scalar arguments and its device, shared by the C
// entries: cudaSetDevice only when `device` is not already current, and the
// error word allocated on the first call.
inline cudaError_t prepare_call(int n, long long chunk_bytes, int parts, int epoch, int device,
                                int my = 0) {
  if (n < 1 || n > kMaxRanks || chunk_bytes <= 0 || parts < 1 || epoch < 1 || my < 0 ||
      my >= n)
    return cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return ensure_error_word();
}

}  // namespace rank_sync
