// Pieces of the all-to-all kernel (src/repro_torch/kernels/csrc/ring_all_to_all.cu)
// launched alone, to split its device time (tools/b4_split.py builds and runs
// this file; the port never loads it).
//
// One probe kernel over n emulated ranks, `parts` CTAs per rank, rank-stacked
// contiguous x and out of [n][n][words] 16-byte words, with two switches:
// * mode bit 1: the neighbour barrier of the TPU kernel (each CTA raises
//   its left and right neighbours' flag, waits for 2 * parts raises);
// * mode bit 2: the copies out[p][my] = x[my][p] for every round, no flags;
//   plan 0 gives CTA `part` of a rank its share of all n chunks, one round
//   after another (the round-serial schedule); plan 1 divides a rank's CTAs
//   over the n chunks first and over shares of a chunk second (a CTA takes
//   one share of one chunk, or whole chunks r = c, c + parts, ... when
//   parts < n).
// mode 0 is an empty launch of the same grid.
#include "rank_sync.cuh"

using namespace rank_sync;

namespace {

constexpr Scope kScope = Scope::kGpu;

__global__ void __launch_bounds__(kThreads)
probe_kernel(const uint4* x, uint4* out, int n, long long words, int parts, int mode, int plan,
             int* flags, int epoch, volatile int* err) {
  const int my = blockIdx.x / parts;
  const int part = blockIdx.x % parts;
  if (mode & 1) {
    const int left = (my + n - 1) % n, right = (my + 1) % n;
    raise_flags<kScope>(flags + left, flags + right);
    if (!wait_for<kScope>(flags + my, 2 * parts * epoch, error_code(kBarrier, 0, my, 0), err))
      return;
  }
  if (!(mode & 2)) return;
  const bool xor_pairing = (n & (n - 1)) == 0;
  auto copy_round = [&](int r, long long lo, long long hi) {
    const int p = xor_pairing ? (my ^ r) : (my + r) % n;
    copy_words(x + ((long long)my * n + p) * words, out + ((long long)p * n + my) * words,
               (uint4*)nullptr, lo, hi);
  };
  if (plan == 0) {
    for (int r = 0; r < n; ++r)
      copy_round(r, words * part / parts, words * (part + 1) / parts);
  } else if (parts >= n) {
    const int base = parts / n, extra = parts % n, wide = extra * (base + 1);
    const int r = part < wide ? part / (base + 1) : extra + (part - wide) / base;
    const int s = r < extra ? base + 1 : base;
    const int q = part < wide ? part % (base + 1) : (part - wide) % base;
    copy_round(r, words * q / s, words * (q + 1) / s);
  } else {
    for (int r = part; r < n; r += parts) copy_round(r, 0, words);
  }
}

__global__ void empty_kernel() {}

}  // namespace

// One probe launch on `stream`: cooperative when coop != 0, else <<<>>>.
extern "C" int b4_probe(const void* x, void* out, int n, long long words, int parts, int mode,
                        int plan, int* flags, int epoch, int coop, void* stream) {
  cudaError_t e = ensure_error_word();
  if (e != cudaSuccess) return (int)e;
  const uint4* xp = static_cast<const uint4*>(x);
  uint4* op = static_cast<uint4*>(out);
  volatile int* err = error_word().device;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (coop) {
    void* args[] = {&xp, &op, &n, &words, &parts, &mode, &plan, &flags, &epoch, &err};
    e = cudaLaunchCooperativeKernel((const void*)probe_kernel, dim3((unsigned)(n * parts)),
                                    dim3(kThreads), args, 0, s);
  } else {
    probe_kernel<<<n * parts, kThreads, 0, s>>>(xp, op, n, words, parts, mode, plan, flags,
                                                 epoch, err);
  }
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

// An empty kernel of `ctas` CTAs of `threads` threads: with one of one, the
// cost of a launch alone.
extern "C" int b4_probe_empty(int ctas, int threads, int coop, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;
  if (coop)
    e = cudaLaunchCooperativeKernel((const void*)empty_kernel, dim3(ctas), dim3(threads),
                                    nullptr, 0, s);
  else
    empty_kernel<<<ctas, threads, 0, s>>>();
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

// The two attribute queries of a per-call choice of CTAs on the device side.
extern "C" int b4_probe_attrs(int device) {
  int sms = 0, coop = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  return sms * coop;
}

extern "C" int b4_probe_set_device(int device) { return (int)cudaSetDevice(device); }

extern "C" int b4_probe_get_device(void) {
  int d = -1;
  cudaGetDevice(&d);
  return d;
}

extern "C" int b4_probe_error(void) {
  const ErrorWord& w = error_word();
  return w.host ? *(volatile int*)w.host : 0;
}
