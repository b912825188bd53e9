// Flash attention (chunked online softmax) for Hopper (sm_90a), bound to
// PyTorch through a plain C interface (ctypes, see kernels/flash_attn.py).
//
// Replaces the TPU kernel of the reference package:
//   flash_attn <- repro/kernels/flash_attn.py flash_attention_pallas
//                 (_flash_kernel); the reference model runs its XLA twin
//                 _mha_blockwise under flags.blockwise_attention, and the
//                 port's _mha_blockwise calls this kernel instead.
//
// What it computes, for every query row i of q (b*H, s, hd) and every
// query position: the keys and values of row i // group of k, v
// (b*KV, t, hd) (GQA: G = H / KV query heads share one KV head). In f32:
// score = (q . k) * scale, then softcap * tanh(score / softcap) when a soft
// cap is given, then the masks (causal: k_pos <= q_pos; window:
// q_pos - k_pos < window; both counted from position 0 for q and k) as the
// finite -1e30, then an online softmax over the keys with a running max m,
// a rescaled denominator l and accumulator; out = acc / max(l, 1e-30) in
// q's dtype. The order of operations is the Pallas kernel's.
//
// Bound on the card (kernels/bounds.py flash_prefill): at TinyLlama's
// 4 x 64 prefill each q/k/v/out element takes part in few operations, so
// the least time is the bytes over 3.35 TB/s; at 1 x 2048 the causal half
// of the q . k and p . v products (2 * 2 * hd operations per pair) over
// the bf16 tensor-core rate is the larger, so it is bound by operations.
//
// Design (first, simple version). The TPU kernel's grid walks the K/V
// blocks in order and carries m, l and acc in VMEM scratch; here one CTA
// of 128 threads owns one (row of b*H, tile of 32 query positions) and
// walks the K/V tiles of 64 keys itself, so no state crosses CTAs. Each
// tile is staged in shared memory as f32 (K padded to hd + 1 floats a row,
// so the threads of a warp read different banks), every thread forms
// scores from shared memory with CUDA-core f32 FMAs, one warp per query
// position updates m and l, and every thread rescales and accumulates its
// own output elements in registers. Tiles above the causal diagonal or
// wholly outside the window are skipped: they add nothing to any position
// that has a visible key (the softmax weight of a masked key is
// exp(-1e30 - m) = 0 once m is finite, and a tile processed while m is
// still -1e30 is wiped by the factor exp(-1e30 - m) = 0 that the first
// visible key brings). Keys past t (the ragged tail of the last tile) get
// a score of -inf and weight 0; query positions past s are computed but not
// stored. mma/wgmma bf16 tensor-core products, cp.async/TMA staging and a
// split over keys are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 32;           // query positions per CTA
constexpr int kBK = 64;           // keys per staged tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store_f32(__half* p, float x) { *p = __float2half(x); }

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kBQ * HD + (size_t)kBK * (HD + 1) + (size_t)kBK * HD +
                          (size_t)kBQ * kBK + 3 * (size_t)kBQ);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// T: dtype of q, k, v and the output (float, bf16 or fp16); HD: head dim.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const T* __restrict__ q,      // (b*H, s, HD)
                  const T* __restrict__ k,      // (b*KV, t, HD)
                  const T* __restrict__ v,      // (b*KV, t, HD)
                  T* __restrict__ out,          // (b*H, s, HD)
                  int s, int t, int group, float scale, int causal, int window,
                  float softcap) {
  constexpr int kOut = kBQ * HD / kThreads;     // output elements per thread
  constexpr int kHDP = HD + 1;
  const int q0 = blockIdx.x * kBQ;
  const int row = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;                  // (BQ, HD)
  float* k_s = q_s + kBQ * HD;        // (BK, HD + 1)
  float* v_s = k_s + kBK * kHDP;      // (BK, HD)
  float* p_s = v_s + kBK * HD;        // (BQ, BK) scores, then weights
  float* m_s = p_s + kBQ * kBK;       // (BQ,) running maxima
  float* l_s = m_s + kBQ;             // (BQ,) running denominators
  float* a_s = l_s + kBQ;             // (BQ,) rescale of the running sums

  const int nq = min(kBQ, s - q0);
  const T* qb = q + ((size_t)row * s + q0) * HD;
  const T* kb = k + (size_t)(row / group) * t * HD;
  const T* vb = v + (size_t)(row / group) * t * HD;

  for (int e = tid; e < kBQ * HD; e += kThreads) q_s[e] = e < nq * HD ? to_f32(qb[e]) : 0.f;
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kOut];
#pragma unroll
  for (int j = 0; j < kOut; ++j) acc[j] = 0.f;

  // the keys this tile of query positions can see: none past the last
  // position (causal), none at or before first position - window
  const int k_end = causal ? min(t, q0 + nq) : t;
  const int k_begin = window > 0 ? (max(0, q0 - window + 1) / kBK) * kBK : 0;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    const int nk = min(kBK, t - k0);
    __syncthreads();                  // the previous tile's weights and values are consumed
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int c = e / HD, d = e - c * HD;
      float kf = 0.f, vf = 0.f;
      if (c < nk) {
        kf = to_f32(kb[(size_t)(k0 + c) * HD + d]);
        vf = to_f32(vb[(size_t)(k0 + c) * HD + d]);
      }
      k_s[c * kHDP + d] = kf;
      v_s[e] = vf;
    }
    __syncthreads();

    // scores: scale, soft cap, masks
    for (int e = tid; e < kBQ * kBK; e += kThreads) {
      const int r = e / kBK, c = e - r * kBK;
      float sc = -INFINITY;           // no key here (past t): weight 0
      if (c < nk) {
        const float* qr = q_s + r * HD;
        const float* kr = k_s + c * kHDP;
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
        sc = dot * scale;
        if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
        const int qp = q0 + r, kp = k0 + c;
        bool ok = true;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && (qp - kp) < window;
        if (!ok) sc = kNegInf;
      }
      p_s[e] = sc;
    }
    __syncthreads();

    // online softmax: one warp per query position
    for (int r = warp; r < kBQ; r += kWarps) {
      float* pr = p_s + r * kBK;
      float mx = -INFINITY;
      for (int c = lane; c < kBK; c += 32) mx = fmaxf(mx, pr[c]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < kBK; c += 32) {
        const float w = expf(pr[c] - m_new);
        pr[c] = w;
        sum += w;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        a_s[r] = a;
        l_s[r] = l_s[r] * a + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // rescale and accumulate: thread tid owns elements tid, tid + 128, ...
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const int e = tid + j * kThreads;
      const int r = e / HD, d = e - r * HD;
      const float* pr = p_s + r * kBK;
      float a = acc[j] * a_s[r];
#pragma unroll 8
      for (int c = 0; c < kBK; ++c) a = fmaf(pr[c], v_s[c * HD + d], a);
      acc[j] = a;
    }
  }
  __syncthreads();

  T* ob = out + ((size_t)row * s + q0) * HD;
#pragma unroll
  for (int j = 0; j < kOut; ++j) {
    const int e = tid + j * kThreads;
    const int r = e / HD;
    if (r < nq) store_f32(ob + e, acc[j] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int bh, int s, int t,
           int group, float scale, int causal, int window, float softcap,
           cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_attn_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + kBQ - 1) / kBQ, bh);
  flash_attn_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), s, t, group, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out, int bh, int s, int t,
              int hd, int group, float scale, int causal, int window, float softcap,
              cudaStream_t stream) {
  if (hd == 32) return launch<T, 32>(q, k, v, out, bh, s, t, group, scale, causal, window,
                                     softcap, stream);
  if (hd == 64) return launch<T, 64>(q, k, v, out, bh, s, t, group, scale, causal, window,
                                     softcap, stream);
  if (hd == 128) return launch<T, 128>(q, k, v, out, bh, s, t, group, scale, causal, window,
                                       softcap, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype codes shared with kernels/flash_attn.py
enum Dtype { kF32 = 0, kBF16 = 1, kF16 = 2 };

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success); the Python
// wrapper raises on anything else. window <= 0 means no window, softcap
// <= 0 no soft cap.
extern "C" int flash_attn(const void* q, const void* k, const void* v, void* out, int bh,
                          int bkv, int s, int t, int hd, int group, float scale, int causal,
                          int window, float softcap, int dtype, int device, void* stream) {
  if (bh < 1 || bh > 65535 || s < 1 || t < 1 || group < 1 || bkv * group != bh)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_hd<float>(q, k, v, out, bh, s, t, hd, group, scale, causal, window, softcap,
                            st);
  if (dtype == kBF16)
    return launch_hd<__nv_bfloat16>(q, k, v, out, bh, s, t, hd, group, scale, causal, window,
                                    softcap, st);
  if (dtype == kF16)
    return launch_hd<__half>(q, k, v, out, bh, s, t, hd, group, scale, causal, window, softcap,
                             st);
  return static_cast<int>(cudaErrorInvalidValue);
}
