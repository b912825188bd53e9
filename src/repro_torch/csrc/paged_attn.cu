// Paged decode attention over a block-pool KV cache, for Hopper (sm_90a),
// bound to PyTorch through a plain C interface (ctypes, see
// kernels/paged_attn.py).
//
// Replaces the TPU kernel of the reference package:
//   paged_attn <- repro/kernels/paged_attn.py paged_attention_pallas
//                 (_paged_kernel for float pools, _paged_quant_kernel for
//                 int8/fp8 pools; both share _attend)
//
// What it computes, per decode row i and KV head k (G query heads share k):
//   for every virtual block j of row i, physical block table[i, j] of the
//   (NB, BS, KV, hd) pool holds K and V rows (BS, hd); int8/fp8 rows are
//   dequantized by their f32 scale (NB, BS, KV) before the dot. Column
//   pos[i] is the current token, not yet committed to the pool: its score
//   is q . k_new and its value row v_new. Scores are scaled, optionally
//   soft-capped (softcap * tanh(s / softcap)), masked additively with
//   mask (b, MB * BS), and accumulated with an online softmax in f32;
//   ctx (b, KV * G * hd) is written in q's dtype.
//
// Bound on the card: each K/V element read is used for 2 * G = 16
// operations, far below the H100's ~295 bf16 operations per byte, so the
// kernel is bound by bytes: the least time is the live K/V rows (and their
// scales) over 3.35 TB/s.
//
// Design (first, simple version). The TPU kernel's grid walks the virtual
// blocks in order and carries the softmax state in VMEM; here one CTA of
// 128 threads owns one (row, KV head) and walks the row's blocks itself,
// so no state crosses CTAs. Each iteration stages a tile of whole blocks
// (64 columns) in shared memory as f32: the block table is read in the
// kernel (the TPU's scalar prefetch has no counterpart), K/V rows come in
// with 4-element vector loads, are dequantized on the way in, and the row
// of the current token is replaced by k_new / v_new, so stale data in
// recycled or sink blocks never reaches the sums. Every thread then forms
// scores from shared memory, one warp per query head updates the running
// max and denominator, and every thread updates its own output elements.
// A block whose mask entries are all <= -1e29 is neither read nor summed:
// its softmax weight exp(s - 1e30 - m) is exactly 0 in f32 whenever the
// row has an unmasked column, as every decode mask has (column pos). So
// blocks past pos, and unallocated table entries, cost no bytes. Split-K
// over blocks, cp.async/TMA pipelining and tensor cores are later work.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileCols = 64;    // virtual columns staged per iteration (whole blocks)
constexpr int kMaxOut = 8;       // output elements per thread: G * hd <= 1024
constexpr float kNegInf = -1e30f;
constexpr float kDeadMask = -1e29f;
constexpr size_t kMaxSmem = 48 * 1024;

template <typename S>
struct alignas(4 * sizeof(S)) Vec4 {
  S v[4];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__host__ __device__ inline int tile_blocks(int bs) { return bs >= kTileCols ? 1 : kTileCols / bs; }

__host__ __device__ inline size_t smem_bytes(int g, int hd, int bs) {
  const int tb = tile_blocks(bs), tc = tb * bs;
  const size_t floats = (size_t)g * hd + (size_t)tc * (hd + 1) + (size_t)tc * hd +
                        (size_t)g * tc + 3 * (size_t)g;
  return floats * sizeof(float) + tb * sizeof(int);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// T: dtype of q, k_new, v_new and the output (float or bf16).
// S: storage dtype of the pool (T itself, int8 or fp8 e4m3).
template <typename T, typename S, bool kQuant>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const T* __restrict__ q,             // (b, KV, G, hd)
                  const S* __restrict__ k_pages,       // (NB, BS, KV, hd)
                  const S* __restrict__ v_pages,
                  const float* __restrict__ k_scales,  // (NB, BS, KV); quantized pools only
                  const float* __restrict__ v_scales,
                  const int* __restrict__ table,       // (b, MB)
                  const int* __restrict__ pos,         // (b,)
                  const T* __restrict__ k_new,         // (b, KV, hd)
                  const T* __restrict__ v_new,
                  const float* __restrict__ mask,      // (b, MB * BS)
                  T* __restrict__ out,                 // (b, KV * G * hd)
                  int kv, int g, int hd, int bs, int mb, int nb,
                  float scale, float softcap) {
  const int k = blockIdx.x, i = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tb = tile_blocks(bs), tc = tb * bs, hdp = hd + 1, hv = hd / 4;

  extern __shared__ float smem[];
  float* q_s = smem;                    // (G, hd)
  float* k_s = q_s + g * hd;            // (tc, hd + 1): padded, conflict-free column reads
  float* v_s = k_s + tc * hdp;          // (tc, hd)
  float* p_s = v_s + tc * hd;           // (G, tc) scores, then weights
  float* alpha_s = p_s + g * tc;        // (G,) rescale of the running sums
  float* l_s = alpha_s + g;             // (G,) running denominators
  float* m_s = l_s + g;                 // (G,) running maxima
  int* live_s = reinterpret_cast<int*>(m_s + g);   // (tb,) block of the tile is read

  const int p = pos[i];
  const size_t head = (size_t)i * kv + k;
  const float* mrow = mask + (size_t)i * mb * bs;
  const int* trow = table + (size_t)i * mb;
  const T* kn = k_new + head * hd;
  const T* vn = v_new + head * hd;

  for (int e = tid; e < g * hd; e += kThreads) q_s[e] = to_f32(q[head * g * hd + e]);
  if (tid < g) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kMaxOut];
#pragma unroll
  for (int r = 0; r < kMaxOut; ++r) acc[r] = 0.f;

  for (int j0 = 0; j0 < mb; j0 += tb) {
    const int ncol = min(tb, mb - j0) * bs;
    const int c0 = j0 * bs;                   // first virtual column of the tile
    if (tid < tb) live_s[tid] = 0;
    __syncthreads();
    int mine = 0;
    for (int c = tid; c < ncol; c += kThreads) {
      if (mrow[c0 + c] > kDeadMask) {
        live_s[c / bs] = 1;                   // every writer stores the same value
        mine = 1;
      }
    }
    if (!__syncthreads_or(mine)) continue;    // the whole tile is masked

    // stage K/V rows as f32 (dequantized); the current token's row is k_new/v_new
    for (int e = tid; e < ncol * hv; e += kThreads) {
      const int c = e / hv, d = (e - c * hv) * 4;
      const int jb = c / bs, t = c - jb * bs;
      float kf[4] = {0.f, 0.f, 0.f, 0.f}, vf[4] = {0.f, 0.f, 0.f, 0.f};
      if (live_s[jb]) {
        if (c0 + c == p) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            kf[u] = to_f32(kn[d + u]);
            vf[u] = to_f32(vn[d + u]);
          }
        } else {
          // out-of-range entries are clamped, as the reference's gather does
          const int phys = min(max(trow[j0 + jb], 0), nb - 1);
          const size_t row = ((size_t)phys * bs + t) * kv + k;
          const Vec4<S> k4 = *reinterpret_cast<const Vec4<S>*>(k_pages + row * hd + d);
          const Vec4<S> v4 = *reinterpret_cast<const Vec4<S>*>(v_pages + row * hd + d);
          const float ks = kQuant ? k_scales[row] : 1.f;
          const float vs = kQuant ? v_scales[row] : 1.f;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            kf[u] = kQuant ? to_f32(k4.v[u]) * ks : to_f32(k4.v[u]);
            vf[u] = kQuant ? to_f32(v4.v[u]) * vs : to_f32(v4.v[u]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        k_s[c * hdp + d + u] = kf[u];
        v_s[c * hd + d + u] = vf[u];
      }
    }
    __syncthreads();

    // scores: scale, soft cap, additive mask; columns of unread blocks get -1e30
    for (int e = tid; e < g * ncol; e += kThreads) {
      const int gg = e / ncol, c = e - gg * ncol;
      float s = kNegInf;
      if (live_s[c / bs]) {
        const float* qr = q_s + gg * hd;
        const float* kr = k_s + c * hdp;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        s += mrow[c0 + c];
      }
      p_s[gg * tc + c] = s;
    }
    __syncthreads();

    // online softmax: one warp per query head
    for (int gg = warp; gg < g; gg += kWarps) {
      float* pr = p_s + gg * tc;
      float mx = kNegInf;
      for (int c = lane; c < ncol; c += 32) mx = fmaxf(mx, pr[c]);
      mx = warp_max(mx);
      const float m_prev = m_s[gg];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < ncol; c += 32) {
        const float w = expf(pr[c] - m_new);
        pr[c] = w;
        sum += w;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        alpha_s[gg] = a;
        l_s[gg] = l_s[gg] * a + sum;
        m_s[gg] = m_new;
      }
    }
    __syncthreads();

    // weighted values: each thread owns output elements tid, tid + 128, ...
#pragma unroll
    for (int r = 0; r < kMaxOut; ++r) {
      const int e = tid + r * kThreads;
      if (e < g * hd) {
        const int gg = e / hd, d = e - gg * hd;
        const float* pr = p_s + gg * tc;
        float a = acc[r] * alpha_s[gg];
        for (int c = 0; c < ncol; ++c) a = fmaf(pr[c], v_s[c * hd + d], a);
        acc[r] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kMaxOut; ++r) {
    const int e = tid + r * kThreads;
    if (e < g * hd) {
      const float l = fmaxf(l_s[e / hd], 1e-30f);
      store_f32(out + head * g * hd + e, acc[r] / l);
    }
  }
}

template <typename T, typename S, bool kQuant>
int launch(const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
           const void* table, const void* pos, const void* kn, const void* vn,
           const void* mask, void* out, int b, int kv, int g, int hd, int bs, int mb, int nb,
           float scale, float softcap, cudaStream_t stream) {
  const dim3 grid(kv, b);
  paged_attn_kernel<T, S, kQuant><<<grid, kThreads, smem_bytes(g, hd, bs), stream>>>(
      static_cast<const T*>(q), static_cast<const S*>(kp), static_cast<const S*>(vp),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(table), static_cast<const int*>(pos),
      static_cast<const T*>(kn), static_cast<const T*>(vn), static_cast<const float*>(mask),
      static_cast<T*>(out), kv, g, hd, bs, mb, nb, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

// dtype codes shared with kernels/paged_attn.py
enum Dtype { kF32 = 0, kBF16 = 1, kI8 = 2, kFP8 = 3 };

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success); the Python
// wrapper raises on anything else. q_dtype is kF32 or kBF16; pool_dtype is
// q_dtype (float pool, scales null) or kI8 / kFP8 (quantized pool).
extern "C" int paged_attn(const void* q, const void* k_pages, const void* v_pages,
                          const void* k_scales, const void* v_scales, const void* table,
                          const void* pos, const void* k_new, const void* v_new,
                          const void* mask, void* out, int b, int kv, int g, int hd, int bs,
                          int mb, int nb, float scale, float softcap, int q_dtype,
                          int pool_dtype, int device, void* stream) {
  if (b < 1 || b > 65535 || kv < 1 || g < 1 || hd < 4 || hd % 4 || bs < 1 || mb < 1 ||
      nb < 1 || g * hd > kMaxOut * kThreads || smem_bytes(g, hd, bs) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool quant = pool_dtype == kI8 || pool_dtype == kFP8;
  if (quant != (k_scales != nullptr && v_scales != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PAGED_ARGS q, k_pages, v_pages, k_scales, v_scales, table, pos, k_new, v_new, mask, out, \
                   b, kv, g, hd, bs, mb, nb, scale, softcap, s
  if (q_dtype == kF32) {
    if (pool_dtype == kF32) return launch<float, float, false>(PAGED_ARGS);
    if (pool_dtype == kI8) return launch<float, int8_t, true>(PAGED_ARGS);
    if (pool_dtype == kFP8) return launch<float, __nv_fp8_e4m3, true>(PAGED_ARGS);
  } else if (q_dtype == kBF16) {
    if (pool_dtype == kBF16) return launch<__nv_bfloat16, __nv_bfloat16, false>(PAGED_ARGS);
    if (pool_dtype == kI8) return launch<__nv_bfloat16, int8_t, true>(PAGED_ARGS);
    if (pool_dtype == kFP8) return launch<__nv_bfloat16, __nv_fp8_e4m3, true>(PAGED_ARGS);
  }
#undef PAGED_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
