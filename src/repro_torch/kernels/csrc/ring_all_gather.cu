// Ring all-gather over n emulated ranks for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ring_all_gather_kernel` /
// `make_ring_all_gather` in src/repro/kernels/ring_all_gather/ring_all_gather.py,
// where each device forwards one chunk per ring step to its neighbour with a
// remote DMA and per-step DMA semaphores.  Here the n ranks are n buffers on
// one card and one cooperative launch runs them all (rank_sync.cuh): rank r
// owns CTAs [r * parts, (r + 1) * parts), and a remote DMA becomes stores
// into the neighbour rank's output followed by a release of a flag.
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
// Syncs: gpu-scope release adds after a CTA barrier, gpu-scope acquire
// polls, no system fence and no sleep between polls (PERF.md "Why a ring step
// costs ~9 us" measured each).  Flags count call epochs and are never zeroed
// per call (rank_sync.cuh); layout in ring_all_gather_flag_ints.
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

constexpr Scope kScope = Scope::kGpu;

__host__ __device__ inline int ring_steps(int n) { return n > 1 ? n - 1 : 1; }

// Flag layout: barrier [n][parts], recv [2 streams][n][steps][parts],
// send [2 streams][n][steps].
__host__ __device__ inline long long flag_ints(int n, int parts) {
  const long long steps = ring_steps(n);
  return (long long)n * parts + 2 * n * steps * parts + 2 * n * steps;
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
ring_all_gather_kernel(RankPtrs ptrs, int n, long long words, int parts, int defer,
                       int bidir, int* flags, int epoch, volatile int* err) {
  const int my = blockIdx.x / parts;
  const int part = blockIdx.x % parts;
  const int left = (my + n - 1) % n;
  const int right = (my + 1) % n;
  const int steps = ring_steps(n);
  int* const barrier = flags;                              // [n][parts]
  int* const recv = barrier + n * parts;                   // [2][n][steps][parts]
  int* const send = recv + 2 * n * steps * parts;          // [2][n][steps]
  auto recv_at = [&](int stream, int rank, int i) {
    return recv + (((long long)stream * n + rank) * steps + i) * parts + part;
  };
  auto send_at = [&](int stream, int rank, int i) {
    return send + ((long long)stream * n + rank) * steps + i;
  };
  const long long lo = words * part / parts;
  const long long hi = words * (part + 1) / parts;
  W* const mine = static_cast<W*>(ptrs.out[my]);
  W* const to_right = static_cast<W*>(ptrs.out[right]);
  W* const to_left = static_cast<W*>(ptrs.out[left]);

  raise_flags<kScope>(barrier + left * parts + part, barrier + right * parts + part);
  if (!wait_for<kScope>(barrier + my * parts + part, 2 * epoch,
                        error_code(kBarrier, 0, my, 0), err))
    return;

  // The same thread copies the same words in every call of copy_words, so
  // step 1 reads back what this thread stored here.
  copy_words(static_cast<const W*>(ptrs.in[my]), mine + my * words, (W*)nullptr, lo, hi);

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
    raise_flags<kScope>(recv_at(0, right, i), send_at(0, my, i),
                        go_left ? recv_at(1, left, i) : nullptr,
                        go_left ? send_at(1, my, i) : nullptr);
    // Waits of this step, polled at once: [recv_r, recv_l] then, for pcpy,
    // [send_r, send_l].  The recv flag says this share of the next slot
    // has arrived from its one producer.
    const int n_streams = go_left ? 2 : 1;
    const bool ok = wait_all<kScope>(
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
    wait_all<kScope>(
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

template <typename W>
cudaError_t launch(const RankPtrs& ptrs, int n, long long chunk_bytes, int parts, int defer,
                   int bidir, int* flags, int epoch, cudaStream_t stream) {
  RankPtrs p = ptrs;
  long long words = chunk_bytes / (long long)sizeof(W);
  volatile int* err = error_word().device;
  void* args[] = {&p, &n, &words, &parts, &defer, &bidir, &flags, &epoch, &err};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)ring_all_gather_kernel<W>,
                                              dim3((unsigned)(n * parts)), dim3(kThreads),
                                              args, 0, stream);
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? e : last;
}

}  // namespace

// in_ptrs[r]: rank r's chunk (chunk_bytes); out_ptrs[r]: rank r's output
// (n * chunk_bytes); flags: ring_all_gather_flag_ints(n, parts) ints, zeroed
// before the first call and kept between calls on one stream; epoch: 1 for
// the first call on a buffer, one more for each call after.  parts <= 0
// picks the CTAs per rank.  Returns cudaGetLastError() after the launch (0
// on success); nothing is synchronised.
extern "C" int ring_all_gather(const unsigned long long* in_ptrs,
                               const unsigned long long* out_ptrs, int n,
                               long long chunk_bytes, int parts, int defer, int bidir,
                               int* flags, int epoch, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n < 1 || n > kMaxRanks || chunk_bytes <= 0 || epoch < 1)
    return (int)cudaErrorInvalidValue;
  err = ensure_error_word();
  if (err != cudaSuccess) return (int)err;
  parts = choose_parts(n, chunk_bytes, parts, device);
  if (parts == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  RankPtrs ptrs{};
  for (int r = 0; r < n; ++r) {
    ptrs.in[r] = reinterpret_cast<const void*>(in_ptrs[r]);
    ptrs.out[r] = reinterpret_cast<void*>(out_ptrs[r]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (word_bytes(ptrs, n, chunk_bytes)) {
    case 16:
      return (int)launch<uint4>(ptrs, n, chunk_bytes, parts, defer, bidir, flags, epoch, s);
    case 4:
      return (int)launch<uint32_t>(ptrs, n, chunk_bytes, parts, defer, bidir, flags, epoch, s);
    case 2:
      return (int)launch<uint16_t>(ptrs, n, chunk_bytes, parts, defer, bidir, flags, epoch, s);
    default:
      return (int)launch<uint8_t>(ptrs, n, chunk_bytes, parts, defer, bidir, flags, epoch, s);
  }
}

// Ints of the flag buffer of a call with n ranks and `parts` CTAs per rank.
extern "C" long long ring_all_gather_flag_ints(int n, int parts) {
  return flag_ints(n, parts);
}

// The first failed wait's code since the last clear (0: none).  Reads pinned
// host memory: no synchronisation, so a failure shows once its kernel ended.
extern "C" int ring_all_gather_error(void) {
  const ErrorWord& w = error_word();
  return w.host ? *(volatile int*)w.host : 0;
}

extern "C" void ring_all_gather_clear_error(void) {
  ErrorWord& w = error_word();
  if (w.host) *(volatile int*)w.host = 0;
}

// CTAs per rank that a call with these arguments launches (0: cannot launch).
extern "C" int ring_all_gather_parts(int n, long long chunk_bytes, int parts, int device) {
  return choose_parts(n, chunk_bytes, parts, device);
}
