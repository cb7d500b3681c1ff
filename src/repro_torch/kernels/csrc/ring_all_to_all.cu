// All-to-all over n emulated ranks for Hopper (sm_90a): out_i[j] = x_j[i].
//
// Replaces the Pallas TPU kernel `all_to_all_kernel` / `make_all_to_all` in
// src/repro/kernels/ring_all_to_all/ring_all_to_all.py, where each device
// exchanges one chunk per round with a partner by remote DMA.  As in
// ring_all_gather.cu, the n ranks are n buffers on one card, one cooperative
// launch runs them all (rank r owns CTAs [r * parts, (r + 1) * parts)), and a
// remote DMA becomes stores into the partner's output followed by a release
// of its per-round flag (rank_sync.cuh).
//
// Schedule, as in the TPU kernel:
// 1. neighbour barrier (left and right, wait for 2 * parts);
// 2. local copy x_my[my] -> out_my[my];
// 3. rounds r = 1 .. n-1: partner = my ^ r when n is a power of two (the
//    in-place pairwise swap), else my + r (rotation).  Store x_my[partner]
//    into out_partner[my], raise send[my][r-1] and recv[partner][r-1].  In
//    each round exactly one rank sends to each rank (my ^ r, or my - r), so
//    recv[my][r-1] counts exactly that sender's CTAs.
//
// Variants (flag `b2b` of `ring_all_to_all`):
// * per_round (b2b=0): wait for send and recv after every round;
// * b2b (b2b=1): store every round back to back, then drain all flags.  Legal
//   because the sends read x and the receives land in out (no hazard).
//
// Bound on the H100: HBM bytes.  Every rank reads and writes n chunks, so
// the call moves 2 * n * n * chunk bytes at 3.35 TB/s; small chunks are bound
// by the flag round trips instead.  Raw-byte copies, bit-exact in every dtype.
#include "rank_sync.cuh"

using namespace rank_sync;

namespace {

template <typename W>
__global__ void __launch_bounds__(kThreads)
all_to_all_kernel(RankPtrs ptrs, int n, long long words, int parts, int b2b, int* flags,
                  volatile int* err) {
  const int my = blockIdx.x / parts;
  const int part = blockIdx.x % parts;
  const int left = (my + n - 1) % n;
  const int right = (my + 1) % n;
  const int steps = n > 1 ? n - 1 : 1;
  int* barrier = flags;                  // [n]
  int* send = barrier + n;               // [n][steps] each
  int* recv = send + n * steps;
  const long long lo = words * part / parts;
  const long long hi = words * (part + 1) / parts;
  const W* const x = static_cast<const W*>(ptrs.in[my]);   // [n][words]
  const bool xor_pairing = (n & (n - 1)) == 0;

  raise_flags(barrier + left, barrier + right);
  if (!wait_for(barrier + my, 2 * parts, error_code(kBarrier, 0, my, 0), err)) return;

  copy_words(x + my * words, static_cast<W*>(ptrs.out[my]) + my * words, (W*)nullptr, lo, hi);

  for (int r = 1; r < n; ++r) {
    const int partner = xor_pairing ? (my ^ r) : (my + r) % n;
    copy_words(x + partner * words, static_cast<W*>(ptrs.out[partner]) + my * words,
               (W*)nullptr, lo, hi);
    const int i = r - 1;
    raise_flags(send + my * steps + i, recv + partner * steps + i);
    if (!b2b) {
      if (!wait_for(send + my * steps + i, parts, error_code(kSend, 0, my, r), err)) return;
      if (!wait_for(recv + my * steps + i, parts, error_code(kRecv, 0, my, r), err)) return;
    }
  }
  if (b2b) {
    for (int r = 1; r < n; ++r) {
      const int i = r - 1;
      if (!wait_for(send + my * steps + i, parts, error_code(kSend, 0, my, r), err)) return;
      if (!wait_for(recv + my * steps + i, parts, error_code(kRecv, 0, my, r), err)) return;
    }
  }
}

template <typename W>
cudaError_t launch(const RankPtrs& ptrs, int n, long long chunk_bytes, int parts, int b2b,
                   int* flags, cudaStream_t stream) {
  RankPtrs p = ptrs;
  long long words = chunk_bytes / (long long)sizeof(W);
  volatile int* err = error_word().device;
  void* args[] = {&p, &n, &words, &parts, &b2b, &flags, &err};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)all_to_all_kernel<W>,
                                              dim3((unsigned)(n * parts)), dim3(kThreads),
                                              args, 0, stream);
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? e : last;
}

}  // namespace

// in_ptrs[r]: rank r's n chunks (n * chunk_bytes); out_ptrs[r]: rank r's
// output (n * chunk_bytes); flags: 1 + 2 * max(n-1, 1) ints per rank, zeroed
// by the caller.  parts <= 0 picks the CTAs per rank.  Returns
// cudaGetLastError() after the launch (0 on success); nothing is synchronised.
extern "C" int ring_all_to_all(const unsigned long long* in_ptrs,
                               const unsigned long long* out_ptrs, int n,
                               long long chunk_bytes, int parts, int b2b, int* flags,
                               int device, void* stream) {
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
    case 16: return (int)launch<uint4>(ptrs, n, chunk_bytes, parts, b2b, flags, s);
    case 4: return (int)launch<uint32_t>(ptrs, n, chunk_bytes, parts, b2b, flags, s);
    case 2: return (int)launch<uint16_t>(ptrs, n, chunk_bytes, parts, b2b, flags, s);
    default: return (int)launch<uint8_t>(ptrs, n, chunk_bytes, parts, b2b, flags, s);
  }
}

// The first failed wait's code since the last clear (0: none); no
// synchronisation (see ring_all_gather_error).
extern "C" int ring_all_to_all_error(void) {
  const ErrorWord& w = error_word();
  return w.host ? *(volatile int*)w.host : 0;
}

extern "C" void ring_all_to_all_clear_error(void) {
  ErrorWord& w = error_word();
  if (w.host) *(volatile int*)w.host = 0;
}

// CTAs per rank that a call with these arguments launches (0: cannot launch).
extern "C" int ring_all_to_all_parts(int n, long long chunk_bytes, int parts, int device) {
  return choose_parts(n, chunk_bytes, parts, device);
}
