// Ring reduce-scatter with one rank per process, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference renders the ring as n - 1
// `ppermute` steps, each followed by an add (`ring_reduce_scatter` in
// src/repro/core/collectives.py), and XLA lowers each `ppermute` to a
// device-to-device transfer.  With one rank per process, the only such
// transfer on the card that is no library collective is a store into the
// neighbour's memory through a CUDA IPC mapping, as the per-rank entries of
// ring_all_gather.cu and ring_all_to_all.cu do; this kernel is that ring,
// with the add fused into each hop.
//
// Rank `my` holds n addends x[0..n-1] (x[i] for rank i) and ends with
// sum_e x_e[my].  The reference's schedule, one launch per call:
//   acc = x[(my - 1) % n];
//   for r in 0 .. n-2: acc = recv_from_left(acc) + x[(my - r - 2) % n].
// Hop r stores this rank's acc into receive slot r of the right
// neighbour, then raises that neighbour's flag of (step r, share) with a
// system-scope release.  Fused: at step r >= 1 a CTA reads slot r - 1 of
// its own memory (the left neighbour's acc), adds its own addend and stores
// the sum straight into the right neighbour's slot r; after the last step it
// adds x[my] to slot n - 2 into the result.  Every step has its own slot and
// flag, never one counting flag: a later step's arrival must not satisfy an
// earlier wait.
//
// The add is float32 `recv + own` rounded to nearest even into the operand's
// type, as torch adds bf16 and f32 tensors, so the result is bit-equal to
// the emulated rendering (`core/collectives.py`: torch.roll + add) on the
// same inputs.
//
// Chained per share, as ring_all_gather.cu: CTA p of every rank owns words
// [lo, hi) of every chunk, so the share it reads from slot r - 1 was stored
// there by CTA p of the left neighbour alone, and a CTA waits only for that
// producer's flag.  The ring is `parts` independent chains.
//
// Reuse across calls: the symmetric output (result, then n - 1 receive
// slots) and the flags persist between calls, so the kernel starts with
// ring_all_gather.cu's neighbour barrier, one-sided since a rank stores only
// into its right neighbour: each CTA raises the barrier flag of its share in
// its left neighbour and waits for its own, which the right neighbour raises.
// A rank then stores call e + 1 into the right neighbour only after that
// neighbour's launch of call e + 1 has begun, so its reads of call e and its
// copy out of call e (queued before it on its stream) have ended.  A flag is
// raised once per call; a raise of call e + 1 comes after the barrier of
// call e + 1, so it never meets a wait of call e.
//
// Every wait is bounded by kSysWaitNs and leaves a code in the error word
// (rank_sync.cuh); _rank_sync.RankKernel.check_ranks then raises on every
// rank.
//
// Bound on the H100: bytes.  A rank reads its n addends and n - 1 received
// partials and writes n - 1 partials and its result; summed over the ranks
// the function moves at least the n * n addends in and the n results out.
// On one card the ranks' kernels take turns by time slice (~2.2 ms a turn,
// PERF.md §6), so each of the n - 1 dependent hops costs about a turn and no
// byte bound is approached there.
#include <cuda_bf16.h>

#include "rank_sync.cuh"

using namespace rank_sync;

namespace {

__host__ __device__ inline int ring_steps(int n) { return n > 1 ? n - 1 : 1; }

// This rank's addends, every rank's symmetric output (result [words], then
// receive slot r at (r + 1) * words) and flag region (IPC-mapped for peers);
// a region per rank of barrier [parts], recv [steps][parts].
struct PerRank {
  const void* input;
  RankPtrs ptrs;      // out[] only
  RankFlags flags;
  int my, n, parts;

  static __host__ __device__ long long flag_ints(int n, int parts) {
    return (long long)parts + (long long)ring_steps(n) * parts;
  }
  __device__ int* barrier(int r, int part) const { return flags.of[r] + part; }
  __device__ int* recv(int r, int i, int part) const {
    return flags.of[r] + parts + (long long)i * parts + part;
  }
};

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }

__device__ __forceinline__ __nv_bfloat16 add_rn(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(a), __bfloat162float(b)));
}

// Element-wise sum of two raw words holding sizeof(W) / sizeof(T) values.
template <typename T, typename W>
__device__ __forceinline__ W add_word(W a, W b) {
  static_assert(sizeof(W) % sizeof(T) == 0, "a word holds whole elements");
  constexpr int k = sizeof(W) / sizeof(T);
  T ta[k], tb[k];
  memcpy(ta, &a, sizeof(W));
  memcpy(tb, &b, sizeof(W));
#pragma unroll
  for (int i = 0; i < k; ++i) ta[i] = add_rn(ta[i], tb[i]);
  memcpy(&a, ta, sizeof(W));
  return a;
}

// dst[e] = recv[e] + own[e] for words [lo, hi), kUnroll words per thread in
// flight.  Through L2 only (.cg): recv was stored by a peer's CTA during
// this kernel, and L1 is not coherent.
template <typename T, typename W>
__device__ __forceinline__ void add_words(const W* recv, const W* own, W* dst, long long lo,
                                          long long hi) {
  for (long long base = lo + threadIdx.x; base < hi; base += (long long)kThreads * kUnroll) {
    W a[kUnroll], b[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long e = base + (long long)u * kThreads;
      if (e < hi) {
        a[u] = __ldcg(recv + e);
        b[u] = __ldcg(own + e);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long e = base + (long long)u * kThreads;
      if (e < hi) __stcg(dst + e, add_word<T>(a[u], b[u]));
    }
  }
}

// One block per SM is all a cooperative launch needs (PERF.md §6: without
// the 1, ptxas may hold a kernel to 64 registers and spill).
template <typename T, typename W>
__global__ void __launch_bounds__(kThreads, 1)
ring_reduce_scatter_kernel(const __grid_constant__ PerRank ranks, long long words, int epoch,
                           volatile int* err) {
  constexpr Scope S = Scope::kSys;
  const int n = ranks.n, parts = ranks.parts, my = ranks.my;
  const int part = blockIdx.x;
  const int left = (my + n - 1) % n;
  const int right = (my + 1) % n;
  const long long lo = words * part / parts;
  const long long hi = words * (part + 1) / parts;
  const W* const x = static_cast<const W*>(ranks.input);
  W* const mine = static_cast<W*>(ranks.ptrs.out[my]);
  W* const theirs = static_cast<W*>(ranks.ptrs.out[right]);
  auto addend = [&](int j) { return x + (long long)(((j % n) + n) % n) * words; };
  auto slot = [&](W* out, int r) { return out + (long long)(r + 1) * words; };

  raise_flags<S>(ranks.barrier(left, part), nullptr);
  if (!wait_for<S>(ranks.barrier(my, part), epoch, error_code(kBarrier, 0, my, 0), err))
    return;
  if (n == 1) {
    copy_words(addend(0), mine, (W*)nullptr, lo, hi);
    return;
  }
  for (int r = 0; r < n - 1; ++r) {
    if (r == 0) {
      copy_words(addend(my - 1), slot(theirs, 0), (W*)nullptr, lo, hi);
    } else {
      if (!wait_for<S>(ranks.recv(my, r - 1, part), epoch, error_code(kRecv, 0, my, r), err))
        return;
      add_words<T>(slot(mine, r - 1), addend(my - r - 1), slot(theirs, r), lo, hi);
    }
    raise_flags<S>(ranks.recv(right, r, part), nullptr);
  }
  if (!wait_for<S>(ranks.recv(my, n - 2, part), epoch, error_code(kRecv, 0, my, n - 1), err))
    return;
  add_words<T>(slot(mine, n - 2), addend(my), mine, lo, hi);
}

template <typename T, typename W>
cudaError_t launch_as(PerRank ranks, long long chunk_bytes, int epoch, cudaStream_t stream) {
  long long words = chunk_bytes / (long long)sizeof(W);
  volatile int* err = error_word().device;
  void* args[] = {&ranks, &words, &epoch, &err};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)ring_reduce_scatter_kernel<T, W>,
                                              dim3((unsigned)ranks.parts), dim3(kThreads), args,
                                              0, stream);
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? e : last;
}

// The launch with the widest word that divides the pointers and the chunk
// and holds whole elements of T.
template <typename T>
cudaError_t launch(const PerRank& ranks, uintptr_t align, long long chunk_bytes, int epoch,
                   cudaStream_t s) {
  const int wb = word_bytes((const void*)align, nullptr, chunk_bytes);
  if (wb < (int)sizeof(T)) return cudaErrorMisalignedAddress;
  if (wb == 16) return launch_as<T, uint4>(ranks, chunk_bytes, epoch, s);
  if constexpr (sizeof(T) == 2) {
    if (wb == 2) return launch_as<T, uint16_t>(ranks, chunk_bytes, epoch, s);
  }
  return launch_as<T, uint32_t>(ranks, chunk_bytes, epoch, s);
}

}  // namespace

// One rank per process: rank `my` of n.  in: this rank's addends
// [n][chunk_bytes] (in[i] for rank i); outs: every rank's symmetric output
// of n * chunk_bytes (peers' mapped through CUDA IPC, outs[my] this rank's
// own), whose first chunk_bytes receive this rank's result; flags: every
// rank's flag region of ring_reduce_scatter_rank_flag_ints(n, parts) ints,
// likewise, each zeroed before its first call; parts: this rank's CTAs, the
// same on every rank; bf16: the element type (1 bf16, 0 float32); epoch: 1
// for the first call on a buffer set, one more for each call after, the same
// on every rank.  Launches this rank's `parts` CTAs; returns
// cudaGetLastError() after the launch, nothing synchronised.
extern "C" int ring_reduce_scatter_rank(int my, int n, const void* in, void* const* outs,
                                        int* const* flags, long long chunk_bytes, int parts,
                                        int bf16, int epoch, int device, void* stream) {
  cudaError_t err = prepare_call(n, chunk_bytes, parts, epoch, device, my);
  if (err != cudaSuccess) return (int)err;
  PerRank ranks{};
  ranks.input = in;
  uintptr_t align = (uintptr_t)in;
  for (int r = 0; r < n; ++r) {
    ranks.ptrs.out[r] = outs[r];
    ranks.flags.of[r] = flags[r];
    align |= (uintptr_t)outs[r];
  }
  ranks.my = my;
  ranks.n = n;
  ranks.parts = parts;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch<__nv_bfloat16>(ranks, align, chunk_bytes, epoch, s)
                    : launch<float>(ranks, align, chunk_bytes, epoch, s));
}

// Ints of one rank's flag region.
extern "C" long long ring_reduce_scatter_rank_flag_ints(int n, int parts) {
  return PerRank::flag_ints(n, parts);
}

// Host address of the error word (see ring_all_gather_error_word).
extern "C" int* ring_reduce_scatter_error_word(void) {
  return ensure_error_word() == cudaSuccess ? error_word().host : nullptr;
}
