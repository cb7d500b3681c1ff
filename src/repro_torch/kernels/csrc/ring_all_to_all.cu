// All-to-all over n ranks for Hopper (sm_90a): out_i[j] = x_j[i].
//
// Replaces the Pallas TPU kernel `all_to_all_kernel` / `make_all_to_all` in
// src/repro/kernels/ring_all_to_all/ring_all_to_all.py, where each device
// exchanges one chunk per round with a partner by remote DMA: round r pairs
// `my` with my ^ r when n is a power of two (the in-place pairwise swap),
// else sends to my + r (rotation); round 0 is the local chunk.  A remote DMA
// becomes stores into the partner's output slice followed by a release add
// on a flag (rank_sync.cuh).  Two paths, one kernel body templated on scope
// and on where the ranks are:
// * ring_all_to_all: emulated ranks, n slices of one rank-stacked buffer on
//   one card, one cooperative launch of n * parts CTAs (rank r owns CTAs
//   [r * parts, (r + 1) * parts)), gpu-scope flags;
// * ring_all_to_all_rank: one rank per process, a launch of its `parts`
//   CTAs that stores into its partners' outputs through CUDA IPC, with
//   system-scope flags that live in the waiting rank's memory.
//
// What bounds it on the H100.  From about 16 MiB per rank, HBM bytes: every
// rank reads and writes its n chunks, 2 * n * n * chunk bytes at 3.35 TB/s.
// Below about 1 MiB per rank, latency: the launch, one dependent trip
// through L2 for a CTA's loads and one for the release of its stores, and
// the poll that sees the last flag; the bytes take well under a microsecond.
// A round-serial schedule pays that trip n - 1 times over: a rank's CTAs
// walk the partners one round after another, with a release per round, and
// then poll 2 * (n - 1) flags.  So the design spreads the rounds over CTAs:
//
// * Partner first, share second (b2b).  The host (`_rank_sync.A2APlan`,
//   this kernel's twin, tested on the CPU) gives each rank `parts` CTAs, up
//   to sm_count / n.  They are divided over the n rounds first and over
//   shares of a chunk second: with parts >= n, CTA c takes one share of one round
//   (parts % n rounds get one share more); with parts < n, CTA c takes whole
//   rounds c, c + parts, ...  All of a rank's exchanges then run at once on
//   separate SMs, the card's counterpart of DMA commands on parallel
//   engine queues.
// * b2b (b2b=1): one fence per CTA per call.  A CTA puts all the loads of its
//   rounds in flight before its stores, passes one CTA barrier, and raises
//   the arrival counter of each of its receivers from one thread each
//   (warp 0, at once).  Each rank's first CTA then drains one counter, whose
//   target per call is the count of CTAs that store into that rank
//   (`arrivals`: parts when parts >= n, else n), instead of polling
//   2 * (n - 1) flags.  Legal because sends read x and receives land in out.
// * per_round (b2b=0): round r + 1 starts after round r's send and recv, as
//   in the TPU kernel, so the rounds form a chain and a round's latency is
//   paid n - 1 times whatever the plan.  Here CTA c takes share c of every
//   round, so every round runs on all the rank's CTAs (with one CTA per
//   round, a round's bytes would wait on one SM's store rate); the host
//   gives per_round a CTA per 32 KiB of a rank's chunks, since more CTAs
//   only add skew to each round's flags at small sizes.  A CTA loads the
//   shares of all its rounds at once when they fit in registers (up to 1
//   MiB per rank over 8 ranks; loading each round's share just before its
//   wait instead took 25 and 34 us at 64 KiB and 1 MiB, not 15 and 17,
//   PERF.md §6), else each round's first batch before its wait.  Round by
//   round it waits for the previous round's send flag (this rank's CTAs)
//   and recv flag (the sender's CTAs), stores and raises its round's flags,
//   and it waits for the last round's flags before it ends.  Round 0 (the
//   local chunk) is no round of the chain.
//
// The TPU kernel's neighbour barrier is gone: on the TPU it keeps a device
// from writing into a peer that has not entered the kernel yet.  Inside one
// grid whose output was allocated before the launch, and with flags that
// count call epochs, it orders nothing (it cost ~1 us, PERF.md §6).
//
// The per-rank path needs that ordering, and gets it from two slots instead
// of a barrier: the wrapper (_rank_sync.SymmetricBuffers) gives each rank
// two persistent (output, flags) slots, and call c uses slot c % 2 with that
// slot's own epoch.  What makes it safe: every rank exchanges with every
// other, and a rank's call c ends only after each partner's stores of call
// c have landed in it (b2b: its drain counts them; per_round: it waits for
// every round's recv flag).  So when rank q stores call c + 2 into p's slot,
// q has ended call c + 1, in which p stored into q, so p's launch of call
// c + 1 has begun and p's copy out of call c (queued before it on p's
// stream) has ended: the slot is free.  For the flags: any raise of call
// c + 2 comes from a rank that has ended call c + 1, which needed every
// rank's call-c + 1 stores, so every rank had ended call c and made all
// its raises of call c; a slot's count never mixes in a later call's raises
// before a wait of call c is met.  Costs nothing in the kernel, where a
// barrier would cost a flag round trip between processes.
//
// Flags (epoch-counted, never zeroed per call; Stacked and PerRank below):
// arrival counters [n] of b2b, one 128-byte line each since every CTA of
// the grid raises one; send and recv [n][n] of per_round (index 0 unused).  Every wait is
// bounded and leaves a code in the error word.  Raw-word copies (16-, 4-,
// 2- or 1-byte words as the pointers and the chunk allow), bit-exact in
// every dtype.
#include "rank_sync.cuh"

using namespace rank_sync;

namespace {

constexpr int kPad = 32;    // ints from one rank's arrival counter to the next

// Emulated ranks: x and out rank-stacked [n][n][words]; one flag buffer,
// arrive [n][kPad], send [n][n], recv [n][n].
template <typename W>
struct Stacked {
  const W* x;
  W* out;
  int* flags;
  int n;
  long long words;

  static __host__ __device__ long long flag_ints(int n) {
    return (long long)n * kPad + 2LL * n * n;
  }
  __device__ int rank(int block, int parts) const { return block / parts; }
  // x[my][p]: rank my's chunk for p; out[p][my]: where it lands
  __device__ const W* src(int my, int p) const { return x + ((long long)my * n + p) * words; }
  __device__ W* dst(int p, int my) const { return out + ((long long)p * n + my) * words; }
  __device__ int* arrive(int r) const { return flags + r * kPad; }
  __device__ int* send(int r, int round) const { return flags + n * kPad + r * n + round; }
  __device__ int* recv(int r, int round) const {
    return flags + n * kPad + n * n + r * n + round;
  }
};

// One rank per process: this rank's x [n][words], every rank's output slot
// [n][words] and flag region (IPC-mapped for peers), a region per rank of
// arrive [kPad], send [n], recv [n].
template <typename W>
struct PerRank {
  const W* x;
  RankPtrs ptrs;      // out[] only
  RankFlags flags;
  int my, n;
  long long words;

  static __host__ __device__ long long flag_ints(int n) { return kPad + 2LL * n; }
  __device__ int rank(int, int) const { return my; }
  __device__ const W* src(int, int p) const { return x + (long long)p * words; }
  __device__ W* dst(int p, int my_) const {
    return static_cast<W*>(ptrs.out[p]) + (long long)my_ * words;
  }
  __device__ int* arrive(int r) const { return flags.of[r]; }
  __device__ int* send(int r, int round) const { return flags.of[r] + kPad + round; }
  __device__ int* recv(int r, int round) const { return flags.of[r] + kPad + n + round; }
};

// b2b: a CTA's rounds first, first + stride, ... (`rounds` of them), and
// its share of each: share `share` of `shares`.  Twin of A2APlan.work_of.
struct Work {
  int first, stride, rounds, share, shares;
};

__device__ __forceinline__ Work work_of(int c, int parts, int n) {
  if (parts >= n) {
    const int base = parts / n, extra = parts % n, wide = extra * (base + 1);
    const int r = c < wide ? c / (base + 1) : extra + (c - wide) / base;
    const int q = c < wide ? c % (base + 1) : (c - wide) % base;
    return {r, n, 1, q, r < extra ? base + 1 : base};
  }
  return {c, parts, (n - 1 - c) / parts + 1, 0, 1};
}

// Words [lo, hi) of src to dst, kUnroll words per thread in flight.  The
// first batch is loaded, then every thread runs `before_store` (it may wait
// on flags; false ends the copy), then the batch is stored.  The loop bound
// is the same for every thread, so the hook's barriers are reached by all.
template <typename W, typename F>
__device__ __forceinline__ bool copy_share(const W* src, W* dst, long long lo, long long hi,
                                           F before_store) {
  for (long long b = lo; b < hi || b == lo; b += (long long)kThreads * kUnroll) {
    W v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long e = b + threadIdx.x + (long long)u * kThreads;
      if (e < hi) v[u] = __ldcg(src + e);
    }
    if (b == lo && !before_store()) return false;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long e = b + threadIdx.x + (long long)u * kThreads;
      if (e < hi) __stcg(dst + e, v[u]);
    }
  }
  return true;
}

// The kernel body, shared by both paths; each kernel below is a thin entry.
template <Scope S, typename W, template <typename> class L>
__device__ __forceinline__ void all_to_all_body(const L<W>& ranks, int parts, int b2b,
                                                int epoch, volatile int* err) {
  const int n = ranks.n;
  const long long words = ranks.words;
  const int my = ranks.rank(blockIdx.x, parts);
  const int c = blockIdx.x % parts;
  const bool xor_pairing = (n & (n - 1)) == 0;
  auto partner = [&](int r) { return xor_pairing ? (my ^ r) : (my + r) % n; };
  auto src = [&](int p) { return ranks.src(my, p); };
  auto dst = [&](int p) { return ranks.dst(p, my); };
  const Work w = work_of(c, parts, n);
  auto no_wait = [] { return true; };

  if (b2b) {
    if (w.rounds == 1) {
      const int p = partner(w.first);
      copy_share(src(p), dst(p), words * w.share / w.shares, words * (w.share + 1) / w.shares,
                 no_wait);
    } else {
      // whole chunks of several rounds as one range of rounds * words, so
      // every round's loads are in flight before the stores
      const long long total = (long long)w.rounds * words;
      for (long long b = threadIdx.x; b < total; b += (long long)kThreads * kUnroll) {
        W v[kUnroll];
        W* to[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const long long e = b + (long long)u * kThreads;
          if (e < total) {
            const int i = (int)(e / words);
            const long long off = e - i * words;
            const int p = partner(w.first + i * w.stride);
            v[u] = __ldcg(src(p) + off);
            to[u] = dst(p) + off;
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (b + (long long)u * kThreads < total) __stcg(to[u], v[u]);
      }
    }
    __syncthreads();
    if ((int)threadIdx.x < w.rounds)
      add_release<S>(ranks.arrive(partner(w.first + threadIdx.x * w.stride)));
    if (c == 0)
      wait_for<S>(ranks.arrive(my), (parts >= n ? parts : n) * epoch,
                  error_code(kArrive, 0, my, 0), err);
    return;
  }

  // per_round: CTA c stores share c (of parts) of every round, rounds in
  // order, so every round has all of the rank's CTAs; round r >= 2 waits for
  // round r - 1's send and recv flags, each raised by a rank's parts CTAs.
  auto wait_round = [&](int r) {
    return wait_all<S>(2, [&](int k) {
      return k == 0 ? Wait{ranks.send(my, r), parts * epoch, error_code(kSend, 0, my, r)}
                    : Wait{ranks.recv(my, r), parts * epoch, error_code(kRecv, 0, my, r)};
    }, err);
  };
  const long long lo = words * c / parts, len = words * (c + 1) / parts - lo;
  const long long total = (long long)n * len;
  if (total <= (long long)kThreads * kUnroll) {
    // the shares of all rounds fit in registers: load them all at once,
    // then store round by round
    W v[kUnroll];
    int round[kUnroll];
    long long off[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long e = threadIdx.x + (long long)u * kThreads;
      round[u] = e < total ? (int)(e / len) : n;
      off[u] = e < total ? lo + e - round[u] * len : 0;
      if (round[u] < n) v[u] = __ldcg(src(partner(round[u])) + off[u]);
    }
    for (int r = 0; r < n; ++r) {
      if (r >= 2 && !wait_round(r - 1)) return;
      const int p = partner(r);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (round[u] == r) __stcg(dst(p) + off[u], v[u]);
      if (r >= 1) raise_flags<S>(ranks.send(my, r), ranks.recv(p, r));
    }
  } else {
    for (int r = 0; r < n; ++r) {
      const int p = partner(r);
      auto wait_prev = [&] { return r < 2 || wait_round(r - 1); };
      if (!copy_share(src(p), dst(p), lo, lo + len, wait_prev)) return;
      if (r >= 1) raise_flags<S>(ranks.send(my, r), ranks.recv(p, r));
    }
  }
  if (n > 1) wait_round(n - 1);
}

// Emulated ranks: the operands as separate parameters, as before the
// per-rank path existed.  One block per SM is all a cooperative launch
// needs: without the 1, ptxas held this entry to 64 registers and spilled,
// and per_round ran 4% slower (PERF.md §6).
template <typename W>
__global__ void __launch_bounds__(kThreads, 1)
all_to_all_kernel(const W* __restrict__ x, W* __restrict__ out, int n, long long words,
                  int parts, int b2b, int* flags, int epoch, volatile int* err) {
  const Stacked<W> ranks{x, out, flags, n, words};
  all_to_all_body<Scope::kGpu>(ranks, parts, b2b, epoch, err);
}

// One rank per process: the pointer tables read in place from the
// parameter space.
template <typename W>
__global__ void __launch_bounds__(kThreads, 1)
all_to_all_rank_kernel(const __grid_constant__ PerRank<W> ranks, int parts, int b2b, int epoch,
                       volatile int* err) {
  all_to_all_body<Scope::kSys>(ranks, parts, b2b, epoch, err);
}

cudaError_t launch(const void* kernel, void** args, int grid, cudaStream_t stream) {
  cudaError_t e = cudaLaunchCooperativeKernel(kernel, dim3((unsigned)grid), dim3(kThreads),
                                              args, 0, stream);
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? e : last;
}

template <typename W>
cudaError_t launch_stacked(const void* x, void* out, int n, long long chunk_bytes, int parts,
                           int b2b, int* flags, int epoch, cudaStream_t stream) {
  const W* xp = static_cast<const W*>(x);
  W* op = static_cast<W*>(out);
  long long words = chunk_bytes / (long long)sizeof(W);
  volatile int* err = error_word().device;
  void* args[] = {&xp, &op, &n, &words, &parts, &b2b, &flags, &epoch, &err};
  return launch((const void*)all_to_all_kernel<W>, args, n * parts, stream);
}

template <typename W>
cudaError_t launch_rank(int my, int n, const void* x, void* const* outs, int* const* flags,
                        long long chunk_bytes, int parts, int b2b, int epoch,
                        cudaStream_t stream) {
  PerRank<W> ranks{};
  ranks.x = static_cast<const W*>(x);
  for (int r = 0; r < n; ++r) {
    ranks.ptrs.out[r] = outs[r];
    ranks.flags.of[r] = flags[r];
  }
  ranks.my = my;
  ranks.n = n;
  ranks.words = chunk_bytes / (long long)sizeof(W);
  volatile int* err = error_word().device;
  void* args[] = {&ranks, &parts, &b2b, &epoch, &err};
  return launch((const void*)all_to_all_rank_kernel<W>, args, parts, stream);
}

}  // namespace

// Emulated ranks.  x: the rank-stacked input [n][n][chunk_bytes] (x[j][i]
// is rank j's chunk for rank i); out: the output of the same layout; parts:
// CTAs per rank, chosen by the caller (_rank_sync.A2APlan) so that all
// n * parts CTAs are resident; flags: ring_all_to_all_flag_ints(n, parts)
// ints, zeroed before the first call and kept between calls on one stream
// with the same parts and variant; epoch: 1 for the first call on a buffer,
// one more for each call after.  Returns cudaGetLastError() after the
// launch (0 on success); nothing is synchronised.
extern "C" int ring_all_to_all(const void* x, void* out, int n, long long chunk_bytes,
                               int parts, int b2b, int* flags, int epoch, int device,
                               void* stream) {
  cudaError_t err = prepare_call(n, chunk_bytes, parts, epoch, device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto word) {
    using W = decltype(word);
    return (int)launch_stacked<W>(x, out, n, chunk_bytes, parts, b2b, flags, epoch, s);
  };
  switch (word_bytes(x, out, chunk_bytes)) {
    case 16: return go(uint4{});
    case 4: return go(uint32_t{});
    case 2: return go(uint16_t{});
    default: return go(uint8_t{});
  }
}

// One rank per process: rank `my` of n.  x: this rank's chunks
// [n][chunk_bytes] (x[i] for rank i); outs: every rank's output slot
// [n][chunk_bytes] (peers' mapped through CUDA IPC, outs[my] this rank's
// own), where rank j's chunk lands at [j]; flags: every rank's flag region
// of ring_all_to_all_rank_flag_ints(n, parts) ints, likewise, each zeroed
// before its first call; parts and epoch as above, the same on every rank.
// Launches this rank's `parts` CTAs; returns cudaGetLastError() after the
// launch, nothing synchronised.
extern "C" int ring_all_to_all_rank(int my, int n, const void* x, void* const* outs,
                                    int* const* flags, long long chunk_bytes, int parts, int b2b,
                                    int epoch, int device, void* stream) {
  cudaError_t err = prepare_call(n, chunk_bytes, parts, epoch, device, my);
  if (err != cudaSuccess) return (int)err;
  uintptr_t align = (uintptr_t)x;
  for (int r = 0; r < n; ++r) align |= (uintptr_t)outs[r];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto word) {
    using W = decltype(word);
    return (int)launch_rank<W>(my, n, x, outs, flags, chunk_bytes, parts, b2b, epoch, s);
  };
  switch (word_bytes((const void*)align, nullptr, chunk_bytes)) {
    case 16: return go(uint4{});
    case 4: return go(uint32_t{});
    case 2: return go(uint16_t{});
    default: return go(uint8_t{});
  }
}

// Ints of the flag buffer of an emulated call with n ranks (any parts).
extern "C" long long ring_all_to_all_flag_ints(int n, int parts) {
  (void)parts;
  return Stacked<uint4>::flag_ints(n);
}

// Ints of one rank's flag region on the per-rank path (any parts).
extern "C" long long ring_all_to_all_rank_flag_ints(int n, int parts) {
  (void)parts;
  return PerRank<uint4>::flag_ints(n);
}

// Host address of the error word (see ring_all_gather_error_word).
extern "C" int* ring_all_to_all_error_word(void) {
  return ensure_error_word() == cudaSuccess ? error_word().host : nullptr;
}
