// Paged flash-decode attention for Hopper (sm_90a): one query token per
// sequence against paged K/V pools through block tables, grouped-query layout.
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
// so the kernel is bound by launch and by the latency of its serial walk over
// the blocks, not by bandwidth.
//
// Design: one CTA per (sequence, kv head), loading its own table row and
// length.  A loop over j < ceil(length / block_tokens) takes the place of the
// TPU's sequential grid axis; blocks past the length are never loaded.  Each
// step stages the K and V block in shared memory as f32 (K rows padded by one
// word so the per-token dot products are free of bank conflicts), computes
// the G x block_tokens scores (scale, then optional softcap*tanh(s/softcap),
// then the length mask at -1e30), updates the running max and normalizer per
// query head, and rescales and accumulates the [G, head_dim] output in shared
// memory.  G and head_dim are runtime values: nothing assumes a power of two
// (qwen2-0.5b has G = 7, head_dim = 64).  Softmax state stays in f32 for both
// f32 and bf16 inputs; the normalizer is floored at 1e-30; the output is
// written in q's dtype.  A table entry outside [0, n_pool) is skipped (its
// block contributes nothing), so a bad index cannot fault the card.
//
// Simple first: the serial walk over blocks leaves most SMs idle at small
// batch (B * KV CTAs).  Splitting the walk over several CTAs with a second
// combine pass is the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

size_t smem_bytes(int G, int hd, int bt) {
  // q [G,hd] + acc [G,hd] + k [bt,hd+1] + v [bt,hd] + p [G,bt] + m,l,alpha [G]
  return sizeof(float) * ((size_t)2 * G * hd + (size_t)bt * (hd + 1) + (size_t)bt * hd +
                          (size_t)G * bt + 3 * (size_t)G);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
              const T* __restrict__ v_pool, const int* __restrict__ tables,
              const int* __restrict__ lengths, T* __restrict__ out, int KV, int G,
              int hd, int bt, int max_blocks, int n_pool, float scale, float softcap) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / KV;
  const int h = blockIdx.x % KV;
  const int kstride = hd + 1;
  float* q_s = smem;                 // [G, hd]
  float* acc = q_s + G * hd;         // [G, hd]
  float* k_s = acc + G * hd;         // [bt, hd + 1]
  float* v_s = k_s + bt * kstride;   // [bt, hd]
  float* p_s = v_s + bt * hd;        // [G, bt] scores, then probabilities
  float* m_s = p_s + G * bt;         // [G] running max
  float* l_s = m_s + G;              // [G] running normalizer
  float* a_s = l_s + G;              // [G] rescale factor of this step

  const int tid = threadIdx.x;
  const long long head = (long long)b * KV + h;
  const T* qb = q + head * G * hd;
  for (int e = tid; e < G * hd; e += kThreads) {
    q_s[e] = to_f32(qb[e]);
    acc[e] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  const int length = lengths[b];
  int n_iter = length > 0 ? (length + bt - 1) / bt : 0;
  if (n_iter > max_blocks) n_iter = max_blocks;
  const int* row = tables + (long long)b * max_blocks;
  const long long token_stride = (long long)KV * hd;  // between tokens of a block
  __syncthreads();

  for (int j = 0; j < n_iter; ++j) {
    const int blk = row[j];
    if (blk < 0 || blk >= n_pool) continue;  // same value in every thread
    const long long base_off = ((long long)blk * bt * KV + h) * hd;
    for (int e = tid; e < bt * hd; e += kThreads) {
      const int t = e / hd, d = e - t * hd;
      const long long off = base_off + t * token_stride + d;
      k_s[t * kstride + d] = to_f32(k_pool[off]);
      v_s[e] = to_f32(v_pool[off]);
    }
    __syncthreads();

    const int base = j * bt;
    for (int e = tid; e < G * bt; e += kThreads) {
      const int g = e / bt, t = e - g * bt;
      const float* qr = q_s + g * hd;
      const float* kr = k_s + t * kstride;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qr[d], kr[d], s);
      s *= scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      p_s[e] = (base + t < length) ? s : kNegInf;
    }
    __syncthreads();

    for (int g = tid; g < G; g += kThreads) {
      float* pr = p_s + g * bt;
      float block_max = kNegInf;
      for (int t = 0; t < bt; ++t) block_max = fmaxf(block_max, pr[t]);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, block_max);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.f;
      for (int t = 0; t < bt; ++t) {
        const float p = expf(pr[t] - m_new);
        pr[t] = p;
        sum += p;
      }
      l_s[g] = l_s[g] * alpha + sum;
      m_s[g] = m_new;
      a_s[g] = alpha;
    }
    __syncthreads();

    for (int e = tid; e < G * hd; e += kThreads) {
      const int g = e / hd, d = e - g * hd;
      const float* pr = p_s + g * bt;
      float a = acc[e] * a_s[g];
      for (int t = 0; t < bt; ++t) a = fmaf(pr[t], v_s[t * hd + d], a);
      acc[e] = a;
    }
    __syncthreads();
  }

  T* ob = out + head * G * hd;
  for (int e = tid; e < G * hd; e += kThreads)
    ob[e] = from_f32<T>(acc[e] / fmaxf(l_s[e / hd], 1e-30f));
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool, const int* tables,
           const int* lengths, void* out, int B, int KV, int G, int hd, int bt,
           int max_blocks, int n_pool, float scale, float softcap, cudaStream_t stream) {
  const size_t smem = smem_bytes(G, hd, bt);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  decode_kernel<T><<<B * KV, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      tables, lengths, static_cast<T*>(out), KV, G, hd, bt, max_blocks, n_pool, scale,
      softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  softcap <= 0 means no softcap.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int paged_decode_attention(int dtype, const void* q, const void* k_pool,
                                      const void* v_pool, const int* tables,
                                      const int* lengths, void* out, int B, int KV, int G,
                                      int hd, int bt, int max_blocks, int n_pool,
                                      float scale, float softcap, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || KV <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, tables, lengths, out, B, KV, G, hd, bt,
                         max_blocks, n_pool, scale, softcap, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, tables, lengths, out, B, KV, G, hd,
                                 bt, max_blocks, n_pool, scale, softcap, s);
  return (int)cudaErrorInvalidValue;
}
