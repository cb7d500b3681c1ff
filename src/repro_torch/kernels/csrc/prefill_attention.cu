// Causal flash-attention forward for the prefill on Hopper (sm_90a): the
// queries of a whole prompt against its own keys, grouped-query layout, with
// no score matrix in device memory.
//
// Replaces no TPU kernel.  The JAX package leaves full-context attention to
// XLA (`attention_ctx` in src/repro/models/attention.py: an einsum, a masked
// float32 softmax and a second einsum, query-chunked for long sequences),
// and the port's plain rendering of that (`_attn_scores_block` in
// src/repro_torch/models/attention.py) writes the whole float32 score tensor
// [B, KV, G, S, S] to device memory and passes over it some ten times: 8.6 GB
// a layer at B 8, 64 query heads, S 2048.  This kernel computes the same
// function with the scores kept in registers.
//
// Bound on the H100: the tensor cores.  Causal attention needs
// 2 * 2 * B * H * hd * S * (S + 1) / 2 operations (Q.K^T and P.V over the
// lower triangle): at B 8, H 64, hd 128, S 2048, 0.55 TFLOP, 0.556 ms at
// 989 TFLOP/s; Q, K, V and the output are 0.4 GB, 0.12 ms at 3.35 TB/s.
//
// Design (FlashAttention-2 on mma.sync):
// * One CTA of 4 warps per (batch, kv head, tile of 128 query rows); two CTAs
//   share an SM (96 KB of shared memory, at most 255 registers a thread).  A
//   query row is one (position, query head of the group) pair, m = s * G + g,
//   so a CTA holds all G heads that share a kv head: each K/V tile it loads
//   serves G heads, and q [B, S, KV, G, hd] is read in place (the G rows of
//   one position are adjacent).  Each warp owns 32 rows, two m16 tiles, so
//   every K/V fragment it reads from shared memory feeds two MMAs (32 rows
//   a warp ran at 270 TFLOP/s, 16 rows with Q held in registers at 238, 64-
//   and 32-key tiles 270 and 259, on the fresh-2k shape).
// * Q is loaded once by cp.async into shared memory and read by ldmatrix at
//   each k-step.  K and V tiles of 64 keys go through a two-stage ring in
//   shared memory by cp.async: tile j + 1 is in flight while tile j is
//   computed.  Rows are 16-byte chunks swizzled by (row & 7), so ldmatrix is
//   free of bank conflicts for hd 64 and 128.  Rows past the sequence are
//   zero-filled (cp.async with a source size of 0).
// * S = Q.K^T by mma.sync.m16n8k16 with float32 accumulators, kept in
//   registers; scaled by 1/sqrt(hd) (times log2 e, for exp2).  A tile is
//   masked only where it reaches past the warp's first position (the
//   diagonal, the end of the sequence).  Online softmax: running max and sum
//   in float32 per row, the sum over the float32 probabilities.  P is rounded
//   to the input type (as the dense path's `w.to(q.dtype)`) and reused in
//   registers as the A operand of O += P.V (ldmatrix.trans reads V).
// * Key tiles past the CTA's last position are never loaded (causal skip).
//   Query tiles are issued longest first (blockIdx.x counts down from the
//   last tile), with the kv head and the batch in the slower grid axes, so
//   the CTAs running at once share one (batch, kv head)'s K/V in L2 and the
//   short tiles fill the end of the grid.
// * Epilogue: O / l rounded to the output type, staged through the warp's
//   own rows of the Q buffer, stored as 16-byte rows into [B, S, KV, G, hd].
// One launch per call on the caller's stream; bf16 and fp16; hd 64 and 128.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 128;             // query rows of a CTA
constexpr int kBlockN = 64;              // keys of a K/V tile
constexpr int kWarpTiles = 2;            // m16 tiles a warp (32 query rows)
constexpr int kThreads = kBlockM / (16 * kWarpTiles) * 32;   // 4 warps
constexpr float kLog2e = 1.4426950408889634f;

template <typename T> struct Mma;

template <> struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <> struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

// Element offset of 16-byte chunk `chunk` of row `row` in a tile of rows of HD
// elements: chunks are XOR-swizzled by the row's low three bits.
template <int HD>
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * HD + ((chunk ^ (row & 7)) << 3);
}

// 2^x by the special-function unit (2^-inf = +0).
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;          // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int S, G;
  long long qsb, qss, qsk, qsg;          // element strides of q [B, S, KV, G, hd]
  long long ksb, kss, ksk;               // of k [B, S, KV, hd]
  long long vsb, vss, vsk;               // of v [B, S, KV, hd]
  long long osb, oss, osk, osg;          // of out [B, S, KV, G, hd]
  float scale_log2;                      // 1/sqrt(hd) * log2(e)
};

// Keys [n0, n0 + kBlockN) of one (batch, kv head) into a swizzled tile.
template <typename T, int HD>
__device__ __forceinline__ void load_kv_tile(T* tile, const T* base, long long stride_s, int n0,
                                             int S, int tid) {
  constexpr int C = HD / 8;
#pragma unroll
  for (int i = tid; i < kBlockN * C; i += kThreads) {
    const int r = i / C, c = i % C;
    const bool ok = n0 + r < S;
    cp_async16(tile + swz<HD>(r, c), base + (ok ? (n0 + r) * stride_s : 0) + c * 8, ok);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2) prefill_flash_attention_fwd(const Args a) {
  constexpr int MT = kWarpTiles;
  constexpr int WR = 16 * MT;            // rows a warp
  constexpr int C = HD / 8;              // 16-byte chunks a row
  constexpr int KS = HD / 16;            // k-steps of Q.K^T
  constexpr int NT = kBlockN / 8;        // n-tiles of a score tile
  constexpr int DT = HD / 8;             // n-tiles of the output
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + kBlockM * HD;             // two stages
  T* sV = sK + 2 * kBlockN * HD;         // two stages

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile = gridDim.x - 1 - blockIdx.x;       // longest first
  const int kv = blockIdx.y, b = blockIdx.z;
  const int S = a.S, G = a.G;
  const int M = S * G;                   // query rows of this (batch, kv head)
  const int m0 = tile * kBlockM;
  const int last_pos = min((min(m0 + kBlockM, M) - 1) / G, S - 1);
  const int n_tiles = (last_pos + kBlockN) / kBlockN;   // keys [0, last_pos]

  const T* q = static_cast<const T*>(a.q) + b * a.qsb + kv * a.qsk;
  const T* k = static_cast<const T*>(a.k) + b * a.ksb + kv * a.ksk;
  const T* v = static_cast<const T*>(a.v) + b * a.vsb + kv * a.vsk;

  // Q tile; then K/V tile 0 into stage 0.
#pragma unroll
  for (int i = tid; i < kBlockM * C; i += kThreads) {
    const int r = i / C, c = i % C;
    const int m = m0 + r;
    const bool ok = m < M;
    const int s = ok ? m / G : 0, g = ok ? m - s * G : 0;
    cp_async16(sQ + swz<HD>(r, c), q + s * a.qss + g * a.qsg + c * 8, ok);
  }
  load_kv_tile<T, HD>(sK, k, a.kss, 0, S, tid);
  load_kv_tile<T, HD>(sV, v, a.vss, 0, S, tid);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // Row of lane's A fragment within an m16 tile (ldmatrix x4 addressing).
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;

  // This thread's rows: lane / 4 and lane / 4 + 8 of each of the warp's m16 tiles.
  int pos[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int row = m0 + warp * WR + mt * 16 + (lane >> 2);
    pos[mt][0] = min(row / G, S - 1);
    pos[mt][1] = min((row + 8) / G, S - 1);
  }
  const int warp_first_pos = min((m0 + warp * WR) / G, S - 1);

  float o[MT][DT][4];
  float m_run[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int d = 0; d < DT; ++d) o[mt][d][0] = o[mt][d][1] = o[mt][d][2] = o[mt][d][3] = 0.f;
    m_run[mt][0] = m_run[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_tiles) {
      load_kv_tile<T, HD>(sK + (stage ^ 1) * kBlockN * HD, k, a.kss, (j + 1) * kBlockN, S, tid);
      load_kv_tile<T, HD>(sV + (stage ^ 1) * kBlockN * HD, v, a.vss, (j + 1) * kBlockN, S, tid);
      cp_async_commit();
    }
    const T* tK = sK + stage * kBlockN * HD;
    const T* tV = sV + stage * kBlockN * HD;

    float sc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n) sc[mt][n][0] = sc[mt][n][1] = sc[mt][n][2] = sc[mt][n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(qa[mt], sQ + swz<HD>(warp * WR + mt * 16 + a_row, kk * 2 + (lane >> 4)));
#pragma unroll
      for (int nn = 0; nn < NT / 2; ++nn) {
        uint32_t kb[4];
        const int key = nn * 16 + (lane & 7) + (lane >> 4) * 8;
        ldmatrix_x4(kb, tK + swz<HD>(key, kk * 2 + ((lane >> 3) & 1)));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          Mma<T>::run(sc[mt][2 * nn], qa[mt], kb[0], kb[1]);
          Mma<T>::run(sc[mt][2 * nn + 1], qa[mt], kb[2], kb[3]);
        }
      }
    }

    const int n0 = j * kBlockN;
    if (n0 + kBlockN - 1 > warp_first_pos) {         // the diagonal or the end
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int key = n0 + n * 8 + 2 * (lane & 3);
          if (key > pos[mt][0]) sc[mt][n][0] = -INFINITY;
          if (key + 1 > pos[mt][0]) sc[mt][n][1] = -INFINITY;
          if (key > pos[mt][1]) sc[mt][n][2] = -INFINITY;
          if (key + 1 > pos[mt][1]) sc[mt][n][3] = -INFINITY;
        }
    }

    // Online softmax (every row holds key 0 <= its position in tile 0, so
    // the running max is finite from the first tile on).
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < NT; ++n) mx = fmaxf(mx, fmaxf(sc[mt][n][2 * h], sc[mt][n][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mn = fmaxf(m_run[mt][h], mx * a.scale_log2);
        const float alpha = exp2_fast(m_run[mt][h] - mn);
        m_run[mt][h] = mn;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          sc[mt][n][2 * h] = exp2_fast(fmaf(sc[mt][n][2 * h], a.scale_log2, -mn));
          sc[mt][n][2 * h + 1] = exp2_fast(fmaf(sc[mt][n][2 * h + 1], a.scale_log2, -mn));
          sum += sc[mt][n][2 * h] + sc[mt][n][2 * h + 1];
        }
        l[mt][h] = l[mt][h] * alpha + sum;
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          o[mt][d][2 * h] *= alpha;
          o[mt][d][2 * h + 1] *= alpha;
        }
      }
    }

    // O += P.V, P from the score registers as the A operand.
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        pa[mt][0] = Mma<T>::pack(sc[mt][2 * kk][0], sc[mt][2 * kk][1]);
        pa[mt][1] = Mma<T>::pack(sc[mt][2 * kk][2], sc[mt][2 * kk][3]);
        pa[mt][2] = Mma<T>::pack(sc[mt][2 * kk + 1][0], sc[mt][2 * kk + 1][1]);
        pa[mt][3] = Mma<T>::pack(sc[mt][2 * kk + 1][2], sc[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int dd = 0; dd < DT / 2; ++dd) {
        uint32_t vb[4];
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(vb, tV + swz<HD>(key, dd * 2 + (lane >> 4)));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          Mma<T>::run(o[mt][2 * dd], pa[mt], vb[0], vb[1]);
          Mma<T>::run(o[mt][2 * dd + 1], pa[mt], vb[2], vb[3]);
        }
      }
    }

    cp_async_wait_all();                 // tile j + 1 has landed
    __syncthreads();                     // and nobody reads stage j any more
  }

  // Epilogue: the row sums across the quad, O / l into the warp's own rows of
  // sQ (no other warp reads them), then 16-byte stores.
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = l[mt][h];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      inv[h] = 1.f / sum;
    }
    const int r0 = warp * WR + mt * 16 + (lane >> 2);
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      const int col = 2 * (lane & 3);
      *reinterpret_cast<uint32_t*>(sQ + swz<HD>(r0, d) + col) =
          Mma<T>::pack(o[mt][d][0] * inv[0], o[mt][d][1] * inv[0]);
      *reinterpret_cast<uint32_t*>(sQ + swz<HD>(r0 + 8, d) + col) =
          Mma<T>::pack(o[mt][d][2] * inv[1], o[mt][d][3] * inv[1]);
    }
  }
  __syncwarp();
  T* out = static_cast<T*>(a.out) + b * a.osb + kv * a.osk;
#pragma unroll
  for (int i = lane; i < WR * C; i += 32) {
    const int r = i / C, c = i % C;
    const int m = m0 + warp * WR + r;
    if (m < M) {
      const int s = m / G, g = m - s * G;
      *reinterpret_cast<uint4*>(out + s * a.oss + g * a.osg + c * 8) =
          *reinterpret_cast<const uint4*>(sQ + swz<HD>(warp * WR + r, c));
    }
  }
}

template <typename T, int HD>
int launch(const Args& a, int B, int KV, cudaStream_t stream) {
  const int smem = (kBlockM + 4 * kBlockN) * HD * static_cast<int>(sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(prefill_flash_attention_fwd<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S * a.G + kBlockM - 1) / kBlockM, KV, B);
  prefill_flash_attention_fwd<T, HD><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 1 bf16, 2 fp16.  Strides in elements; the last dimension of every
// operand is contiguous and every row starts 16-byte aligned (the wrapper
// checks).  Returns the CUDA error of the launch (0 on success).
extern "C" int prefill_flash_attention(
    int dtype, const void* q, const void* k, const void* v, void* out, int B, int S, int KV,
    int G, int hd, long long qsb, long long qss, long long qsk, long long qsg, long long ksb,
    long long kss, long long ksk, long long vsb, long long vss, long long vsk, long long osb,
    long long oss, long long osk, long long osg, float scale, void* stream) {
  const Args a{q, k, v, out, S, G, qsb, qss, qsk, qsg, ksb, kss, ksk, vsb, vss, vsk,
               osb, oss, osk, osg, scale * kLog2e};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && hd == 128) return launch<__nv_bfloat16, 128>(a, B, KV, st);
  if (dtype == 1 && hd == 64) return launch<__nv_bfloat16, 64>(a, B, KV, st);
  if (dtype == 2 && hd == 128) return launch<__half, 128>(a, B, KV, st);
  if (dtype == 2 && hd == 64) return launch<__half, 64>(a, B, KV, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
