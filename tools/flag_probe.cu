// Cross-process flag round trip, for the collectives with one rank per
// process (tools/flag_probe.py builds and runs this file; the port never
// loads it).
//
// A token goes round a ring of processes: each rank's flag lives in its own
// memory (a CUDA IPC allocation), the rank polls it with system-scope
// acquire loads (rank_sync.cuh), and its left neighbour raises it with a
// system-scope release add, as the per-rank kernels do.  Rank 0 starts
// each lap and times it with the global timer; every rank counts the polls
// of each wait.  One thread per rank.  A wait gives up after `limit_ns`
// and leaves -1 for its lap.
#include "rank_sync.cuh"

using namespace rank_sync;

namespace {

constexpr Scope kScope = Scope::kSys;

__global__ void ring_token(int* mine, int* next, int first, int laps,
                           unsigned long long limit_ns, long long* lap_ns,
                           long long* polls) {
  if (threadIdx.x != 0) return;
  for (int lap = 1; lap <= laps; ++lap) {
    const unsigned long long t0 = global_ns();
    if (first) add_release<kScope>(next);
    long long count = 0;
    while (load_acquire<kScope>(mine) < lap) {
      ++count;
      if ((count & 255) == 0 && global_ns() - t0 > limit_ns) {
        lap_ns[lap - 1] = -1;
        polls[lap - 1] = count;
        return;
      }
    }
    if (!first) add_release<kScope>(next);
    lap_ns[lap - 1] = (long long)(global_ns() - t0);
    polls[lap - 1] = count;
  }
}

// ns of `count` polls of a flag that is never raised: the poll rate.
__global__ void poll_rate(const int* flag, long long count, long long* ns) {
  if (threadIdx.x != 0) return;
  const unsigned long long t0 = global_ns();
  int seen = 0;
  for (long long i = 0; i < count; ++i) seen += load_acquire<kScope>(flag);
  ns[0] = (long long)(global_ns() - t0) + (seen == -1);
}

}  // namespace

extern "C" int flag_probe_ring(int* mine, int* next, int first, int laps,
                               unsigned long long limit_ns, long long* lap_ns,
                               long long* polls, void* stream) {
  ring_token<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(mine, next, first, laps,
                                                              limit_ns, lap_ns, polls);
  return (int)cudaGetLastError();
}

extern "C" int flag_probe_poll_rate(const int* flag, long long count, long long* ns,
                                    void* stream) {
  poll_rate<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(flag, count, ns);
  return (int)cudaGetLastError();
}
