// Ring all-gather over n emulated ranks for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ring_all_gather_kernel` /
// `make_ring_all_gather` in src/repro/kernels/ring_all_gather/ring_all_gather.py,
// where each device forwards one chunk per ring step to its neighbour with a
// remote DMA and per-step DMA semaphores.  Here the n ranks are n buffers on
// one card and one cooperative launch runs them all (rank_sync.cuh): rank r
// owns CTAs [r * parts, (r + 1) * parts), and a remote DMA becomes stores
// into the neighbour rank's output followed by a release of its step flag.
//
// Schedule, as in the TPU kernel:
// 1. neighbour barrier: each CTA signals its left and right neighbours' flag
//    and waits until its own counts 2 * parts;
// 2. local copy of in[my] into slot `my` of out[my];
// 3. ring steps k = 1 .. n-1: copy slot (my - k + 1) of out[my] into the same
//    slot of out[right], then raise send_r[my][k-1] and recv_r[right][k-1].
//    Bidirectional variants run ceil((n-1)/2) steps rightward and the rest
//    leftward, forwarding slot (my + k - 1) to out[left]; at k = 1 both
//    streams send slot `my`, so it is read once and stored twice (bcst).
// Per-step flags, never one counting flag: a later step's arrival must not
// satisfy an earlier step's wait (the race the TPU kernel's docstring records).
//
// Variants (flags of `ring_all_gather`):
// * pcpy (defer=0): after each step wait for the own send flag (every CTA of
//   this rank finished the step) and the recv flag (the neighbour's step
//   arrived) before the next step;
// * b2b (defer=1): steps chain on the recv flag only; the send flags are
//   drained once after the last step;
// * bcst / bcst_b2b (bidir=1): the same two syncs with both streams.
//
// Bound on the H100: HBM bytes.  Every rank reads and writes n chunks, so
// the call moves 2 * n * n * chunk bytes at 3.35 TB/s.  Each step of a rank
// waits for its neighbour's previous step, so small chunks are bound by the
// n - 1 flag round trips through L2 instead.  Copies are raw bytes in
// 16-byte words where the pointers and the chunk allow, so every dtype is
// bit-exact.
#include "rank_sync.cuh"

using namespace rank_sync;

namespace {

template <typename W>
__global__ void __launch_bounds__(kThreads)
ring_all_gather_kernel(RankPtrs ptrs, int n, long long words, int parts, int defer,
                       int bidir, int* flags, volatile int* err) {
  const int my = blockIdx.x / parts;
  const int part = blockIdx.x % parts;
  const int left = (my + n - 1) % n;
  const int right = (my + 1) % n;
  const int steps = n > 1 ? n - 1 : 1;
  int* barrier = flags;                  // [n]
  int* send_r = barrier + n;             // [n][steps] each
  int* recv_r = send_r + n * steps;
  int* send_l = recv_r + n * steps;
  int* recv_l = send_l + n * steps;
  const long long lo = words * part / parts;
  const long long hi = words * (part + 1) / parts;
  W* const mine = static_cast<W*>(ptrs.out[my]);
  W* const to_right = static_cast<W*>(ptrs.out[right]);
  W* const to_left = static_cast<W*>(ptrs.out[left]);

  raise_flags(barrier + left, barrier + right);
  if (!wait_for(barrier + my, 2 * parts, error_code(kBarrier, 0, my, 0), err)) return;

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
    raise_flags(send_r + my * steps + i, recv_r + right * steps + i,
                go_left ? send_l + my * steps + i : nullptr,
                go_left ? recv_l + left * steps + i : nullptr);
    if (!defer &&
        !wait_for(send_r + my * steps + i, parts, error_code(kSend, 0, my, k), err))
      return;
    if (!wait_for(recv_r + my * steps + i, parts, error_code(kRecv, 0, my, k), err)) return;
    if (go_left) {
      if (!defer &&
          !wait_for(send_l + my * steps + i, parts, error_code(kSend, 1, my, k), err))
        return;
      if (!wait_for(recv_l + my * steps + i, parts, error_code(kRecv, 1, my, k), err))
        return;
    }
  }
  if (defer) {
    for (int k = 1; k <= n_right; ++k) {
      const int i = k - 1;
      if (!wait_for(send_r + my * steps + i, parts, error_code(kSend, 0, my, k), err)) return;
      if (k <= n_left &&
          !wait_for(send_l + my * steps + i, parts, error_code(kSend, 1, my, k), err))
        return;
    }
  }
}

template <typename W>
cudaError_t launch(const RankPtrs& ptrs, int n, long long chunk_bytes, int parts, int defer,
                   int bidir, int* flags, cudaStream_t stream) {
  RankPtrs p = ptrs;
  long long words = chunk_bytes / (long long)sizeof(W);
  volatile int* err = error_word().device;
  void* args[] = {&p, &n, &words, &parts, &defer, &bidir, &flags, &err};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)ring_all_gather_kernel<W>,
                                              dim3((unsigned)(n * parts)), dim3(kThreads),
                                              args, 0, stream);
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? e : last;
}

}  // namespace

// in_ptrs[r]: rank r's chunk (chunk_bytes); out_ptrs[r]: rank r's output
// (n * chunk_bytes); flags: 1 + 4 * max(n-1, 1) ints per rank, zeroed by the
// caller.  parts <= 0 picks the CTAs per rank.  Returns cudaGetLastError()
// after the launch (0 on success); nothing is synchronised.
extern "C" int ring_all_gather(const unsigned long long* in_ptrs,
                               const unsigned long long* out_ptrs, int n,
                               long long chunk_bytes, int parts, int defer, int bidir,
                               int* flags, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n < 1 || n > kMaxRanks || chunk_bytes <= 0) return (int)cudaErrorInvalidValue;
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
    case 16: return (int)launch<uint4>(ptrs, n, chunk_bytes, parts, defer, bidir, flags, s);
    case 4: return (int)launch<uint32_t>(ptrs, n, chunk_bytes, parts, defer, bidir, flags, s);
    case 2: return (int)launch<uint16_t>(ptrs, n, chunk_bytes, parts, defer, bidir, flags, s);
    default: return (int)launch<uint8_t>(ptrs, n, chunk_bytes, parts, defer, bidir, flags, s);
  }
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
