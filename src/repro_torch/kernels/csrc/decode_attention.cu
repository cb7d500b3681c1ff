// Paged flash-decode attention for Hopper (sm_90a): one query token per
// sequence against paged K/V pools through block tables, grouped-query layout,
// with the walk over each sequence's blocks split across CTAs (split-KV
// flash-decoding).
//
// Replaces the Pallas TPU kernel `paged_decode_attention` / `_decode_kernel`
// in src/repro/kernels/decode_attention/decode_attention.py.  There the grid
// is (B, KV, max_blocks) with the block axis innermost and sequential, and
// VMEM scratch carries the online-softmax state (running max, normalizer,
// accumulator) from one block to the next.
//
// Bound on the H100: the K/V bytes up to each sequence's length (every other
// operand is small), over 3.35 TB/s.  At decode sizes (B 4, KV 2, ~1024
// tokens, head_dim 64, bf16: about 2 MiB) that floor is under a microsecond,
// so what bounds the kernel is latency: the launches, the first loads, and
// how many blocks one CTA walks in series.  One CTA per (sequence, kv head)
// gave 8 CTAs on 132 SMs, each walking ~65 blocks one after another.
//
// Design:
// * Grid B * KV * S, one CTA per (sequence, kv head, split).  The wrapper
//   (decode_attention/ops.py, `num_splits`) picks S so the grid fills about
//   two waves of the SMs: S = clamp(ceil(2 * SMs / (B * KV)), 1, max_blocks),
//   so the grid is at most 2 * SMs + B * KV - 1 CTAs.  Each CTA computes its
//   block range from `lengths` on the device, as `split_ranges` in ops.py
//   does: n = min(ceil(length / bt), max_blocks), per = ceil(n / S), split s
//   takes blocks [min(s * per, n), min(s * per + per, n)).  A split whose
//   range is empty (short sequences) loads nothing; blocks at or after the
//   length are never read.
// * Loads: each K/V token row of the head (head_dim elements, 128 bytes at
//   hd 64 in bf16) is copied into shared memory with cp.async in 16-byte
//   pieces (8 or 4 where the row is not a multiple of 16 bytes; plain loads
//   for 2-byte rows), double-buffered: the next tile of tokens is in flight
//   while this one is computed.  A tile is one block of bt tokens, or half or
//   less of one when two blocks of K and V would not fit in shared memory.
//   The group's G query heads share every K/V row that is loaded.
// * Scores: two neighbouring threads per (query head, token), each a dot
//   product over half of head_dim from shared memory (16-byte reads of the K
//   row, conflict-free: rows are padded by 16 bytes), summed with one
//   shuffle; at G 7 and 16 tokens that is 224 of the 256 threads in one
//   pass.  Then scale, optional softcap*tanh(s/softcap), and the length
//   mask, in the TPU kernel's order; masked positions weigh exactly 0.  One
//   warp per query head updates the running max and normalizer with
//   shuffle reductions; softmax state is f32 for f32 and bf16 inputs.  The
//   P.V accumulation gives each thread two neighbouring output elements
//   (one paired load of V per token): at G 7, hd 64, 224 threads in one
//   pass.  A table entry outside [0, n_pool) loads nothing and its tokens
//   weigh 0, so a bad index cannot fault the card.
// * Combine: each CTA writes its partial (m, l, acc[G, hd]) in f32 to a
//   workspace that the wrapper allocates with torch.empty; a second small
//   kernel, one CTA per (sequence, kv head, query head), merges them, the S
//   partials of an element summed by several threads at once.  It is a
//   programmatic dependent launch (Hopper): scheduled while the split pass
//   runs, it waits in griddepcontrol.wait, so the gap between the two
//   launches is hidden.  It computes
//   m* = max_s m_s, out = sum_s e^(m_s - m*) acc_s / max(sum_s e^(m_s - m*) l_s, 1e-30).
//   An empty split (m = -1e30, l = 0, acc = 0) adds nothing, and a sequence
//   of length <= 0 gives 0, as the Pallas kernel does.
// Two launches per call, on the caller's stream; the wrapper counts the call
// once.  G, head_dim and bt are runtime values (qwen2-0.5b: G 7, hd 64).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCombineThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Dot product of an f32 row (16-byte aligned) and a row of T in shared
// memory (16-byte aligned), 16 bytes of the T row per step.
__device__ __forceinline__ float dot_row(const float* q, const float* k, int hd) {
  float s = 0.f;
  int d = 0;
  for (; d + 4 <= hd; d += 4) {
    const float4 kv = *reinterpret_cast<const float4*>(k + d);
    const float4 qv = *reinterpret_cast<const float4*>(q + d);
    s = fmaf(qv.x, kv.x, s);
    s = fmaf(qv.y, kv.y, s);
    s = fmaf(qv.z, kv.z, s);
    s = fmaf(qv.w, kv.w, s);
  }
  for (; d < hd; ++d) s = fmaf(q[d], k[d], s);
  return s;
}

__device__ __forceinline__ float dot_row(const float* q, const __nv_bfloat16* k, int hd) {
  float s = 0.f;
  int d = 0;
  for (; d + 8 <= hd; d += 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(k + d);
    const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float4 q0 = *reinterpret_cast<const float4*>(q + d);
    const float4 q1 = *reinterpret_cast<const float4*>(q + d + 4);
    float2 f;
    f = __bfloat1622float2(k2[0]); s = fmaf(q0.x, f.x, s); s = fmaf(q0.y, f.y, s);
    f = __bfloat1622float2(k2[1]); s = fmaf(q0.z, f.x, s); s = fmaf(q0.w, f.y, s);
    f = __bfloat1622float2(k2[2]); s = fmaf(q1.x, f.x, s); s = fmaf(q1.y, f.y, s);
    f = __bfloat1622float2(k2[3]); s = fmaf(q1.z, f.x, s); s = fmaf(q1.w, f.y, s);
  }
  for (; d < hd; ++d) s = fmaf(q[d], __bfloat162float(k[d]), s);
  return s;
}

// Two neighbouring elements of a row in shared memory (4- or 8-byte aligned).
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// One CP-byte piece from global to shared memory: cp.async for 16, 8 and 4
// bytes (16 bypasses L1), a plain load and store for 2.
template <int CP>
__device__ __forceinline__ void copy_piece(void* dst, const void* src) {
  if constexpr (CP == 2) {
    *static_cast<uint16_t*>(dst) = __ldg(static_cast<const unsigned short*>(src));
  } else {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    if constexpr (CP == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(CP));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most `pending` (0 or 1) of this thread's groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Bytes of one K/V token row in shared memory: head_dim elements rounded up
// to 16 bytes, plus 16 bytes so rows t and t+1 fall in other banks.
__host__ __device__ __forceinline__ int row_bytes(int hd, int esize) {
  return (hd * esize + 15) / 16 * 16 + 16;
}

__host__ __device__ __forceinline__ int q_stride(int hd) { return (hd + 3) / 4 * 4 + 4; }

size_t smem_bytes(int G, int hd, int tile, int esize) {
  // K and V, two stages each; q [G, q_stride]; acc [G, hd rounded up to
  // even]; p [G, tile]; m, l, alpha [G]
  return (size_t)4 * tile * row_bytes(hd, esize) +
         sizeof(float) * ((size_t)G * q_stride(hd) + (size_t)G * (hd + (hd & 1)) +
                          (size_t)G * tile + 3 * (size_t)G);
}

template <typename T, int CP>
__global__ void __launch_bounds__(kThreads)
split_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
             const T* __restrict__ v_pool, const int* __restrict__ tables,
             const int* __restrict__ lengths, float* __restrict__ part_ml,
             float* __restrict__ part_acc, int KV, int G, int hd, int bt, int tile,
             int max_blocks, int n_pool, int S, float scale, float softcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  // Let the combine grid (a programmatic dependent launch) be scheduled now;
  // it waits for this grid to finish before it reads anything.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int split = blockIdx.x % S;
  const int bh = blockIdx.x / S;             // b * KV + h
  const int b = bh / KV;
  const int h = bh - b * KV;
  const int rb = row_bytes(hd, (int)sizeof(T));
  unsigned char* kbuf = smem;                // [2][tile][rb]
  unsigned char* vbuf = kbuf + 2 * tile * rb;
  float* q_s = reinterpret_cast<float*>(vbuf + 2 * tile * rb);   // [G][q_stride]
  const int qs = q_stride(hd);
  const int hd2 = (hd + 1) / 2, acc_stride = 2 * hd2;
  float* acc = q_s + G * qs;                 // [G][acc_stride]
  float* p_s = acc + G * acc_stride;         // [G][tile]
  float* m_s = p_s + G * tile;               // [G]
  float* l_s = m_s + G;                      // [G]
  float* a_s = l_s + G;                      // [G]
  const int tid = threadIdx.x;
  const int split_d = min(hd, (hd / 2 + 7) / 8 * 8);   // where a score's two halves meet

  // This split's blocks (split_ranges in ops.py).
  const int length = lengths[b];
  int n_valid = length > 0 ? (length - 1) / bt + 1 : 0;
  if (n_valid > max_blocks) n_valid = max_blocks;
  const int per = (n_valid + S - 1) / S;
  const int lo = min(split * per, n_valid);
  const int hi = min(lo + per, n_valid);
  const int tiles_per_block = (bt + tile - 1) / tile;
  const int n_tiles = (hi - lo) * tiles_per_block;
  const int* row = tables + (long long)b * max_blocks;
  const long long token_stride = (long long)KV * hd;   // elements between tokens

  // Tile i of this split: block lo + i / tiles_per_block, tokens
  // [tok0, tok0 + ntok) of it, into stage i & 1.
  auto issue = [&](int i) {
    const int j = lo + i / tiles_per_block;
    const int tok0 = (i % tiles_per_block) * tile;
    const int ntok = min(tile, bt - tok0);
    const int blk = __ldg(row + j);
    if (blk >= 0 && blk < n_pool) {
      const int pieces = hd * (int)sizeof(T) / CP;     // per token row
      unsigned char* kd = kbuf + (i & 1) * tile * rb;
      unsigned char* vd = vbuf + (i & 1) * tile * rb;
      const long long base = (((long long)blk * bt + tok0) * KV + h) * hd;
      for (int e = tid; e < ntok * pieces; e += kThreads) {
        const int t = e / pieces, c = e - t * pieces;
        const long long off = (base + t * token_stride) * (long long)sizeof(T) + c * CP;
        copy_piece<CP>(kd + t * rb + c * CP, reinterpret_cast<const unsigned char*>(k_pool) + off);
        copy_piece<CP>(vd + t * rb + c * CP, reinterpret_cast<const unsigned char*>(v_pool) + off);
      }
    }
  };

  if (n_tiles > 0) issue(0);
  cp_async_commit();
  const T* qb = q + (long long)bh * G * hd;
  for (int e = tid; e < G * hd; e += kThreads) {
    const int g = e / hd;
    if (n_tiles > 0) q_s[g * qs + (e - g * hd)] = to_f32(qb[e]);
  }
  for (int e = tid; e < G * acc_stride; e += kThreads) acc[e] = 0.f;
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  const int warp = tid / 32, lane = tid % 32;
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) issue(i + 1);
    cp_async_commit();
    cp_async_wait(1);            // tile i has landed (this thread's pieces)
    __syncthreads();             // ... and every thread's

    const int j = lo + i / tiles_per_block;
    const int tok0 = (i % tiles_per_block) * tile;
    const int ntok = min(tile, bt - tok0);
    const int blk = __ldg(row + j);
    const int pos0 = j * bt + tok0;
    int nv = (blk >= 0 && blk < n_pool) ? length - pos0 : 0;   // valid tokens: a prefix
    nv = max(0, min(nv, ntok));
    const T* kt = reinterpret_cast<const T*>(kbuf + (i & 1) * tile * rb);
    const T* vt = reinterpret_cast<const T*>(vbuf + (i & 1) * tile * rb);
    const int rbe = rb / (int)sizeof(T);     // row stride in elements

    // Two neighbouring lanes per (query head, token), each over one half of
    // head_dim (split at a multiple of 8 elements, so both halves stay
    // 16-byte aligned), summed with one shuffle.  Every thread runs the
    // same number of rounds, so the shuffle's lanes are all present.
    for (int base = 0; base < 2 * G * nv; base += kThreads) {
      const int e = base + tid, pair = e / 2, g = pair / max(nv, 1), t = pair - g * nv;
      const int d0 = (e & 1) ? split_d : 0, d1 = (e & 1) ? hd : split_d;
      float s = e < 2 * G * nv
                    ? dot_row(q_s + g * qs + d0, kt + t * rbe + d0, d1 - d0) : 0.f;
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      if (e < 2 * G * nv && (e & 1) == 0) {
        s *= scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        p_s[g * tile + t] = s;
      }
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {
      float* pr = p_s + g * tile;
      float bmax = kNegInf;
      for (int t = lane; t < nv; t += 32) bmax = fmaxf(bmax, pr[t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) bmax = fmaxf(bmax, __shfl_xor_sync(0xffffffffu, bmax, o));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, bmax);
      float sum = 0.f;
      for (int t = lane; t < ntok; t += 32) {
        const float p = t < nv ? expf(pr[t] - m_new) : 0.f;   // masked: exactly 0
        pr[t] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    // Each thread accumulates two neighbouring elements of a query head's
    // output (one 4- or 8-byte load of V per token); head_dim is padded to
    // even in acc and in the V rows, so an odd head_dim reads one pad
    // element that it never writes back.
    for (int e = tid; e < G * hd2; e += kThreads) {
      const int g = e / hd2, d = 2 * (e - g * hd2);
      const float* pr = p_s + g * tile;
      const float alpha = a_s[g];
      float2 a = *reinterpret_cast<const float2*>(acc + g * acc_stride + d);
      a.x *= alpha;
      a.y *= alpha;
#pragma unroll 4
      for (int t = 0; t < nv; ++t) {
        const float2 v = load2(vt + t * rbe + d);
        a.x = fmaf(pr[t], v.x, a.x);
        a.y = fmaf(pr[t], v.y, a.y);
      }
      *reinterpret_cast<float2*>(acc + g * acc_stride + d) = a;
    }
    __syncthreads();             // stage i & 1 is free for tile i + 2
  }
  cp_async_wait(0);

  const long long part = (long long)bh * S + split;
  for (int g = tid; g < G; g += kThreads) {
    part_ml[part * 2 * G + g] = m_s[g];
    part_ml[part * 2 * G + G + g] = l_s[g];
  }
  float* pa = part_acc + part * G * hd;
  for (int e = tid; e < G * hd; e += kThreads) {
    const int g = e / hd;
    pa[e] = acc[g * acc_stride + (e - g * hd)];
  }
}

// One CTA per (sequence, kv head, query head): the S partials' m and l go to
// shared memory, then each output element is summed over the splits by
// `groups` threads at once (independent loads in flight, not a serial walk
// over S), and the groups' sums are added in shared memory.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
combine_kernel(const float* __restrict__ part_ml, const float* __restrict__ part_acc,
               T* __restrict__ out, int G, int hd, int S, int width) {
  extern __shared__ float cs[];
  float* w_s = cs;                   // [S] e^(m_s - m*), after m_s
  float* l_s = w_s + S;              // [S]
  float* red = l_s + S;              // [blockDim.x]
  const int bh = blockIdx.x / G;
  const int g = blockIdx.x - bh * G;
  const int tid = threadIdx.x;
  // Launched with programmatic stream serialization: wait here until the
  // split pass has finished and its partials are visible.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const float* ml = part_ml + (long long)bh * S * 2 * G;
  for (int s = tid; s < S; s += blockDim.x) {
    w_s[s] = ml[s * 2 * G + g];
    l_s[s] = ml[s * 2 * G + G + g];
  }
  __syncthreads();
  // m* and the normalizer, each reduced by every warp on its own (lanes over
  // the splits, then shuffles): no serial walk over S.
  const int lane32 = tid % 32;
  float m_star = kNegInf;
  for (int s = lane32; s < S; s += 32) m_star = fmaxf(m_star, w_s[s]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m_star = fmaxf(m_star, __shfl_xor_sync(0xffffffffu, m_star, o));
  float den = 0.f;
  for (int s = lane32; s < S; s += 32) den = fmaf(expf(w_s[s] - m_star), l_s[s], den);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) den += __shfl_xor_sync(0xffffffffu, den, o);
  const float inv = 1.f / fmaxf(den, 1e-30f);
  __syncthreads();                   // every warp has read m_s
  for (int s = tid; s < S; s += blockDim.x) w_s[s] = expf(w_s[s] - m_star);
  __syncthreads();

  const int groups = blockDim.x / width;       // threads summing one element
  const int grp = tid / width, lane = tid - grp * width;
  const float* pa = part_acc + ((long long)bh * S * G + g) * hd;   // split s at + s*G*hd
  T* ob = out + ((long long)bh * G + g) * hd;
  for (int d0 = 0; d0 < hd; d0 += width) {
    const int d = d0 + lane;
    float num = 0.f;
    if (d < hd) {
#pragma unroll 4
      for (int s = grp; s < S; s += groups)
        num = fmaf(w_s[s], pa[(long long)s * G * hd + d], num);
    }
    red[tid] = num;
    __syncthreads();
    if (grp == 0 && d < hd) {
      float total = 0.f;
      for (int q = 0; q < groups; ++q) total += red[q * width + lane];
      ob[d] = from_f32<T>(total * inv);
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool, const int* tables,
           const int* lengths, void* out, float* workspace, int B, int KV, int G, int hd,
           int bt, int max_blocks, int n_pool, int S, float scale, float softcap,
           int device, cudaStream_t stream) {
  int optin = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  const int esize = (int)sizeof(T);
  int tile = bt;
  while (tile > 1 && smem_bytes(G, hd, tile, esize) > (size_t)optin) tile = (tile + 1) / 2;
  const size_t smem = smem_bytes(G, hd, tile, esize);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  // Widest piece that divides a token row's bytes and both pools' addresses.
  const uintptr_t align = (uintptr_t)(hd * esize) | (uintptr_t)k_pool | (uintptr_t)v_pool;
  using SplitFn = decltype(&split_kernel<T, 16>);
  const SplitFn split = align % 16 == 0 ? &split_kernel<T, 16>
                        : align % 8 == 0 ? &split_kernel<T, 8>
                        : align % 4 == 0 ? &split_kernel<T, 4> : &split_kernel<T, 2>;
  float* part_ml = workspace;                                   // [B*KV*S][2][G]
  float* part_acc = workspace + (size_t)B * KV * S * 2 * G;      // [B*KV*S][G][hd]
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(split, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  split<<<B * KV * S, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      tables, lengths, part_ml, part_acc, KV, G, hd, bt, tile, max_blocks, n_pool, S, scale,
      softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // width threads cover head_dim (a multiple of 32, at most 256); the rest of
  // the 256 threads split the S partials among them
  const int width = hd >= kCombineThreads ? kCombineThreads : (hd + 31) / 32 * 32;
  const int groups = kCombineThreads / width < S ? kCombineThreads / width : S;
  const size_t csmem = sizeof(float) * (2 * (size_t)S + (size_t)width * groups);
  if (csmem > 48 * 1024) {
    err = cudaFuncSetAttribute(combine_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)csmem);
    if (err != cudaSuccess) return (int)err;
  }
  // Programmatic dependent launch: the combine grid is scheduled while the
  // split pass runs and waits for it in griddepcontrol.wait, which hides the
  // launch gap between the two kernels.
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * KV * G));
  cfg.blockDim = dim3((unsigned)(width * groups));
  cfg.dynamicSmemBytes = csmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, combine_kernel<T>, static_cast<const float*>(part_ml),
                           static_cast<const float*>(part_acc), static_cast<T*>(out), G, hd,
                           S, width);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  softcap <= 0 means no softcap.  S >= 1
// splits per (sequence, kv head); workspace: B * KV * S * G * (hd + 2) floats.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int paged_decode_attention(int dtype, const void* q, const void* k_pool,
                                      const void* v_pool, const int* tables,
                                      const int* lengths, void* out, void* workspace, int B,
                                      int KV, int G, int hd, int bt, int max_blocks,
                                      int n_pool, int S, float scale, float softcap,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || KV <= 0 || G <= 0 || hd <= 0) return 0;
  if (S < 1 || bt < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(workspace);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, tables, lengths, out, ws, B, KV, G, hd, bt,
                         max_blocks, n_pool, S, scale, softcap, device, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, tables, lengths, out, ws, B, KV, G, hd,
                                 bt, max_blocks, n_pool, S, scale, softcap, device, s);
  return (int)cudaErrorInvalidValue;
}
