// Ring all-gather over n ranks for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ring_all_gather_kernel` /
// `make_ring_all_gather` in src/repro/kernels/ring_all_gather/ring_all_gather.py,
// where each device forwards one chunk per ring step to its neighbour with a
// remote DMA and per-step DMA semaphores.  A remote DMA becomes stores into
// the neighbour rank's output followed by a release of a flag.  Two paths,
// one kernel body templated on scope and on where the ranks are
// (rank_sync.cuh):
// * ring_all_gather: emulated ranks, n buffers on one card, one cooperative
//   launch of n * parts CTAs (rank r owns CTAs [r * parts, (r + 1) * parts)),
//   gpu-scope flags;
// * ring_all_gather_rank: one rank per process, a launch of its `parts`
//   CTAs that stores into the neighbours' outputs through CUDA IPC, with
//   system-scope flags that live in the waiting rank's memory.  The output
//   is a persistent symmetric buffer that the wrapper copies out after the
//   launch; the neighbour barrier (step 1 below) makes its reuse safe: a
//   rank stores call e + 1 into a neighbour only after that neighbour has
//   raised its barrier flag in call e + 1, so the neighbour's launch of call
//   e + 1 has begun and its copy out of call e, queued before it on its
//   stream, has ended.
//
// Schedule, as in the TPU kernel:
// 1. neighbour barrier: each CTA raises the barrier flag of its share in its
//    left and right neighbours and waits until its own reaches 2;
// 2. local copy of in[my] into slot `my` of out[my];
// 3. ring steps k = 1 .. n-1: copy slot (my - k + 1) of out[my] into the same
//    slot of out[right], then raise the neighbour's recv flag and this
//    rank's send flag of step k.  Bidirectional variants run ceil((n-1)/2)
//    steps rightward and the rest leftward, forwarding slot (my + k - 1) to
//    out[left]; at k = 1 both streams send slot `my`, so it is read once and
//    stored twice (bcst).
// Per-step flags, never one counting flag: a later step's arrival must not
// satisfy an earlier step's wait (the race the TPU kernel's docstring records).
//
// Per-share chaining.  CTA p of every rank moves words [lo, hi) of each slot,
// and lo/hi depend only on p.  So the words that CTA p of rank `my` forwards
// at step k + 1 are exactly those that CTA p of its neighbour stored there at
// step k: recv flags are per (rank, stream, step, share), each raised once by
// that one producer, and a CTA waits only for it, not for all `parts` CTAs of
// the neighbour.  The ring is n * parts independent chains, and a forwarded
// share is read shortly after it was written, from L2.  Send flags stay
// rank-wide per (rank, stream, step), counting the rank's `parts` CTAs.
//
// Variants (flags of `ring_all_gather`), which differ only in these syncs:
// * pcpy (defer=0): after each step wait for the rank-wide send flag (every
//   CTA of this rank finished the step) and this share's recv flag;
// * b2b (defer=1): steps chain on the share's recv flag only; the send flags
//   of all steps are drained once at the end;
// * bcst / bcst_b2b (bidir=1): the same two syncs with both streams.
//
// Syncs: release adds after a CTA barrier, acquire polls, no system fence
// and no sleep between polls (PERF.md "Why a ring step costs ~9 us" measured
// each), at gpu scope on the emulated path and system scope per rank.  Flags
// count call epochs and are never zeroed per call (rank_sync.cuh); layout in
// Stacked and PerRank below.
//
// Bound on the H100: HBM bytes.  The function reads the n shards once and
// writes n copies of them, (n + n * n) chunks at 3.35 TB/s.  Each step of a
// share waits for its producer's previous step, so small chunks are bound by
// the n - 1 flag round trips through L2 instead.  Copies are raw bytes in
// 16-byte words where the pointers and the chunk allow (4-, 2- and 1-byte
// words otherwise), so every dtype is bit-exact.
#include "rank_sync.cuh"

using namespace rank_sync;

namespace {

__host__ __device__ inline int ring_steps(int n) { return n > 1 ? n - 1 : 1; }

// Emulated ranks: rank-stacked buffers (pointer table by value) and one flag
// buffer, barrier [n][parts], recv [2 streams][n][steps][parts],
// send [2 streams][n][steps].
struct Stacked {
  RankPtrs ptrs;
  int* flags;
  int n, parts;

  static __host__ __device__ long long flag_ints(int n, int parts) {
    const long long steps = ring_steps(n);
    return (long long)n * parts + 2 * n * steps * parts + 2 * n * steps;
  }
  __device__ int rank(int block) const { return block / parts; }
  __device__ const void* in(int r) const { return ptrs.in[r]; }
  __device__ void* out(int r) const { return ptrs.out[r]; }
  __device__ int* barrier(int r, int part) const { return flags + r * parts + part; }
  __device__ int* recv(int stream, int r, int i, int part) const {
    const int steps = ring_steps(n);
    return flags + n * parts + (((long long)stream * n + r) * steps + i) * parts + part;
  }
  __device__ int* send(int stream, int r, int i) const {
    const int steps = ring_steps(n);
    return flags + n * parts + 2LL * n * steps * parts + ((long long)stream * n + r) * steps + i;
  }
};

// One rank per process: this rank's input, every rank's output and flag
// region (IPC-mapped for peers), a region per rank of barrier [parts],
// recv [2 streams][steps][parts], send [2 streams][steps].
struct PerRank {
  const void* input;
  RankPtrs ptrs;      // out[] only
  RankFlags flags;
  int my, n, parts;

  static __host__ __device__ long long flag_ints(int n, int parts) {
    const long long steps = ring_steps(n);
    return parts + 2 * steps * parts + 2 * steps;
  }
  __device__ int rank(int block) const { return my; }
  __device__ const void* in(int) const { return input; }
  __device__ void* out(int r) const { return ptrs.out[r]; }
  __device__ int* barrier(int r, int part) const { return flags.of[r] + part; }
  __device__ int* recv(int stream, int r, int i, int part) const {
    return flags.of[r] + parts + ((long long)stream * ring_steps(n) + i) * parts + part;
  }
  __device__ int* send(int stream, int r, int i) const {
    const int steps = ring_steps(n);
    return flags.of[r] + parts + 2LL * steps * parts + (long long)stream * steps + i;
  }
};

// One block per SM is all a cooperative launch needs; with the 1, ptxas
// does not hold the kernel to 64 registers (PERF.md §6).
template <Scope S, typename L, typename W>
__global__ void __launch_bounds__(kThreads, 1)
ring_all_gather_kernel(const __grid_constant__ L ranks, long long words, int defer, int bidir,
                       int epoch, volatile int* err) {
  const int n = ranks.n, parts = ranks.parts;
  const int my = ranks.rank(blockIdx.x);
  const int part = blockIdx.x % parts;
  const int left = (my + n - 1) % n;
  const int right = (my + 1) % n;
  auto recv_at = [&](int stream, int rank, int i) { return ranks.recv(stream, rank, i, part); };
  auto send_at = [&](int stream, int rank, int i) { return ranks.send(stream, rank, i); };
  const long long lo = words * part / parts;
  const long long hi = words * (part + 1) / parts;
  W* const mine = static_cast<W*>(ranks.out(my));
  W* const to_right = static_cast<W*>(ranks.out(right));
  W* const to_left = static_cast<W*>(ranks.out(left));

  raise_flags<S>(ranks.barrier(left, part), ranks.barrier(right, part));
  if (!wait_for<S>(ranks.barrier(my, part), 2 * epoch, error_code(kBarrier, 0, my, 0), err))
    return;

  // The same thread copies the same words in every call of copy_words, so
  // step 1 reads back what this thread stored here.
  copy_words(static_cast<const W*>(ranks.in(my)), mine + my * words, (W*)nullptr, lo, hi);

  const int n_right = bidir ? n / 2 : n - 1;   // ceil((n-1)/2) when bidirectional
  const int n_left = (n - 1) - n_right;
  for (int k = 1; k <= n_right; ++k) {
    const bool go_left = k <= n_left;
    const int slot_r = (my - k + 1 + n) % n;
    const int slot_l = (my + k - 1) % n;
    if (go_left && slot_l == slot_r) {
      copy_words(mine + slot_r * words, to_right + slot_r * words, to_left + slot_l * words,
                 lo, hi);
    } else {
      copy_words(mine + slot_r * words, to_right + slot_r * words, (W*)nullptr, lo, hi);
      if (go_left)
        copy_words(mine + slot_l * words, to_left + slot_l * words, (W*)nullptr, lo, hi);
    }
    const int i = k - 1;
    raise_flags<S>(recv_at(0, right, i), send_at(0, my, i),
                   go_left ? recv_at(1, left, i) : nullptr,
                   go_left ? send_at(1, my, i) : nullptr);
    // Waits of this step, polled at once: [recv_r, recv_l] then, for pcpy,
    // [send_r, send_l].  The recv flag says this share of the next slot
    // has arrived from its one producer.
    const int n_streams = go_left ? 2 : 1;
    const bool ok = wait_all<S>(
        defer ? n_streams : 2 * n_streams,
        [&](int w) {
          const int stream = w % n_streams;
          return w < n_streams
                     ? Wait{recv_at(stream, my, i), epoch, error_code(kRecv, stream, my, k)}
                     : Wait{send_at(stream, my, i), parts * epoch,
                            error_code(kSend, stream, my, k)};
        },
        err);
    if (!ok) return;
  }
  if (defer) {
    // b2b: drain the send flags of every step, all polled at once.
    wait_all<S>(
        n_right + n_left,
        [&](int w) {
          const int stream = w < n_right ? 0 : 1;
          const int i = stream ? w - n_right : w;
          return Wait{send_at(stream, my, i), parts * epoch,
                      error_code(kSend, stream, my, i + 1)};
        },
        err);
  }
}

template <Scope S, typename L, typename W>
cudaError_t launch_as(L ranks, int grid, long long chunk_bytes, int defer, int bidir, int epoch,
                      cudaStream_t stream) {
  long long words = chunk_bytes / (long long)sizeof(W);
  volatile int* err = error_word().device;
  void* args[] = {&ranks, &words, &defer, &bidir, &epoch, &err};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)ring_all_gather_kernel<S, L, W>,
                                              dim3((unsigned)grid), dim3(kThreads), args, 0,
                                              stream);
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? e : last;
}

// The launch with the widest word that divides the pointers and the chunk.
template <Scope S, typename L>
cudaError_t launch(const L& ranks, int grid, uintptr_t align, long long chunk_bytes, int defer,
                   int bidir, int epoch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (word_bytes((const void*)align, nullptr, chunk_bytes)) {
    case 16: return launch_as<S, L, uint4>(ranks, grid, chunk_bytes, defer, bidir, epoch, s);
    case 4: return launch_as<S, L, uint32_t>(ranks, grid, chunk_bytes, defer, bidir, epoch, s);
    case 2: return launch_as<S, L, uint16_t>(ranks, grid, chunk_bytes, defer, bidir, epoch, s);
    default: return launch_as<S, L, uint8_t>(ranks, grid, chunk_bytes, defer, bidir, epoch, s);
  }
}

}  // namespace

// Emulated ranks.  in: the rank-stacked shards, n * chunk_bytes (rank r's
// at r * chunk_bytes); out: the rank-stacked outputs, n * n * chunk_bytes;
// parts: CTAs per rank, chosen by the caller (_rank_sync.py) so that all
// n * parts CTAs are resident; flags: ring_all_gather_flag_ints(n, parts)
// ints, zeroed before the first call and kept between calls on one stream;
// epoch: 1 for the first call on a buffer, one more for each call after.
// Returns cudaGetLastError() after the launch (0 on success); nothing is
// synchronised.
extern "C" int ring_all_gather(const void* in, void* out, int n, long long chunk_bytes,
                               int parts, int defer, int bidir, int* flags, int epoch,
                               int device, void* stream) {
  cudaError_t err = prepare_call(n, chunk_bytes, parts, epoch, device);
  if (err != cudaSuccess) return (int)err;
  Stacked ranks{};
  for (int r = 0; r < n; ++r) {
    ranks.ptrs.in[r] = static_cast<const char*>(in) + r * chunk_bytes;
    ranks.ptrs.out[r] = static_cast<char*>(out) + (long long)r * n * chunk_bytes;
  }
  ranks.flags = flags;
  ranks.n = n;
  ranks.parts = parts;
  const uintptr_t align = (uintptr_t)in | (uintptr_t)out;
  return (int)launch<Scope::kGpu>(ranks, n * parts, align, chunk_bytes, defer, bidir, epoch,
                                  stream);
}

// One rank per process: rank `my` of n.  in: this rank's shard, chunk_bytes;
// outs: every rank's output (n * chunk_bytes; peers' mapped through CUDA
// IPC, outs[my] this rank's own); flags: every rank's flag region of
// ring_all_gather_rank_flag_ints(n, parts) ints, likewise, each zeroed
// before its first call; parts: this rank's CTAs, the same on every rank;
// epoch: as above, the same on every rank.  Launches this rank's `parts`
// CTAs; returns cudaGetLastError() after the launch, nothing synchronised.
extern "C" int ring_all_gather_rank(int my, int n, const void* in, void* const* outs,
                                    int* const* flags, long long chunk_bytes, int parts,
                                    int defer, int bidir, int epoch, int device, void* stream) {
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
  return (int)launch<Scope::kSys>(ranks, parts, align, chunk_bytes, defer, bidir, epoch,
                                  stream);
}

// Ints of the flag buffer of an emulated call with n ranks and `parts` CTAs
// per rank.
extern "C" long long ring_all_gather_flag_ints(int n, int parts) {
  return Stacked::flag_ints(n, parts);
}

// Ints of one rank's flag region on the per-rank path.
extern "C" long long ring_all_gather_rank_flag_ints(int n, int parts) {
  return PerRank::flag_ints(n, parts);
}

// Host address of the error word (allocated here if no call made it yet;
// null if it cannot be): the first failed wait's code since the host last
// wrote 0 there.  The host reads it without synchronising, so a failure
// shows once its kernel has ended.
extern "C" int* ring_all_gather_error_word(void) {
  return ensure_error_word() == cudaSuccess ? error_word().host : nullptr;
}
