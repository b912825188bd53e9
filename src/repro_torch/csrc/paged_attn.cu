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
// Design (flash-decoding's shape: split-K over the row's blocks, then a
// combine). The TPU kernel's grid walks the virtual blocks in order and
// carries the softmax state in VMEM. Here:
// - Pass 1 (paged_attn_kernel): the grid is (KV, b, S). Split s of a row
//   walks its own contiguous run of tiles of whole blocks (64 columns for
//   blocks of <= 64 rows; 32 for an f32 pool at hd 256, whose 1 KB rows
//   would not fit three 64-column stages) with an online softmax, one CTA of 256 threads
//   (two warps on each scheduler; registers capped so that three CTAs
//   share an SM). With S = 1 it writes ctx; with S > 1 it writes its
//   running max m, denominator l and unnormalised accumulator for the G
//   heads to f32 scratch (b, KV, S, G, hd + 2). S comes from the shapes
//   alone (see kernels/paged_attn.split_plan), so the wrapper never waits
//   on the card.
// - Pass 2 (paged_attn_combine_kernel), only when S > 1: out =
//   sum_s e^(m_s - m) acc_s / max(sum_s e^(m_s - m) l_s, 1e-30) with
//   m = max_s m_s, in q's dtype.
// Both passes are launched as programmatic dependents (Hopper): a pass may
// be scheduled while the kernel before it in the stream drains (pass 1's
// CTAs release the combine as they finish) and waits in griddepcontrol.wait
// until that kernel's writes are visible before it reads anything, so the
// launch latency between kernels is hidden.
// Staging: a tile's mask values and table entries come into shared memory
// by cp.async four tiles ahead; from them one warp per block decides once
// whether the block is live and writes each column's pool row (-1 for a
// dead block, -2 for the current token's column); then every 16-byte piece
// of the tile's live K/V rows (and every row scale) is issued at once as
// cp.async into a 3-stage ring, raw (int8 and e4m3 bytes stay bytes), two
// tiles ahead. So the rows of tiles n + 1 and n + 2 are in flight while
// tile n is summed, and no global load is waited on inside the loop.
// Dead rows are zero-filled by the copy itself. No integer divide runs in
// the inner loops: hd is a template parameter and each column's row offset
// is computed once per tile. K rows are XOR-swizzled in shared memory, so
// the score loop's 32 threads (32 columns at one 16-byte chunk) read 8
// different bank groups; V rows are read along d and need none. A thread
// scores two heads per read of a K row (their fmaf chains interleaved), a
// warp softmaxes up to two heads at once, and a thread sums one V value per
// column into each of its 1, 2 or 4 output elements, the weights four
// columns a load.
// Within a split the order of arithmetic is the first design's: a
// quantized value is dequantized as it is read, (k * ks), then the same
// fmaf over d in order, columns in order, one warp per head for the max
// and sum; with S = 1 the result is bit-equal to it. A block whose mask
// entries are all <= -1e29 is neither read nor summed: its softmax weight
// exp(s - 1e30 - m) is exactly 0 in f32 whenever the row has an unmasked
// column, as every decode mask has (column pos). So blocks past pos, and
// unallocated table entries, cost no bytes; a split whose blocks are all
// dead (one pass over its mask entries tells, before anything is staged)
// writes m = -1e30, l = 0 and acc = 0, which the combine weighs by 0.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileCols = 64;    // virtual columns staged per tile (whole blocks)
constexpr int kWideRow = 512;    // a row wider than this (f32 at hd 256) halves the tile
constexpr int kMaxOut = 4;       // output elements per thread: G * hd <= 1024
constexpr int kColLanes = 64;    // columns the score loop covers at once
constexpr int kHeadLanes = kThreads / kColLanes;   // thread groups over the heads
constexpr int kHeadsAtOnce = 2;  // heads a thread scores per read of a K row
constexpr int kDBlock = 32;      // K values a thread holds in registers at once
constexpr int kStages = 3;       // tiles of K/V rows in the cp.async ring
constexpr int kSlots = 5;        // tiles of mask values and table entries
constexpr int kMinCtasPerSm = 3; // registers capped so that three CTAs share an SM
constexpr float kNegInf = -1e30f;
constexpr float kDeadMask = -1e29f;
constexpr size_t kMaxSmem = 232448;   // 227 KB, the most a block can opt into
constexpr int kMaxDevices = 64;
constexpr int kMaxSplits = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

// The 16 / sizeof(S) pool values of one 16-byte load, as f32 (exact).
template <typename S>
__device__ __forceinline__ void unpack16(const uint4& raw, float* out);
template <>
__device__ __forceinline__ void unpack16<float>(const uint4& raw, float* out) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}
template <>
__device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4& raw, float* out) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
template <>
__device__ __forceinline__ void unpack16<int8_t>(const uint4& raw, float* out) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int u = 0; u < 4; ++u)
      out[4 * i + u] = static_cast<float>(static_cast<int8_t>((w[i] >> (8 * u)) & 0xffu));
  }
}
template <>
__device__ __forceinline__ void unpack16<__nv_fp8_e4m3>(const uint4& raw, float* out) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const __half2_raw hr = __nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>((w[i] >> (16 * h)) & 0xffffu), __NV_E4M3);
      const float2 f = __half22float2(__half2(hr));
      out[4 * i + 2 * h] = f.x;
      out[4 * i + 2 * h + 1] = f.y;
    }
  }
}

__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Columns a tile: 64, or 32 where a staged row is wider than 512 bytes (an
// f32 pool at hd 256), so that three stages of K and V rows fit in 227 KB.
__host__ __device__ constexpr int tile_cols(int hd, int elt) {
  return hd * elt > kWideRow ? kTileCols / 2 : kTileCols;
}

__host__ __device__ inline int tile_blocks(int bs, int cols) { return bs >= cols ? 1 : cols / bs; }

__host__ __device__ inline size_t row_bytes(int hd, int elt) { return (size_t)hd * elt; }

// The 16-byte chunk of a staged K row where logical chunk `chunk` of row
// `row` lives (XOR swizzle): the score loop's 8 threads of a quarter warp
// read one logical chunk of 8 consecutive rows, which then fall in 8
// different 16-byte bank groups whatever the row's size.
template <int kChunks>
__device__ __forceinline__ int kswz(int row, int chunk) {
  if constexpr (kChunks >= 8) return chunk ^ (row & 7);
  else if constexpr (kChunks == 4) return chunk ^ ((row >> 1) & 3);
  else return chunk ^ ((row >> 2) & 1);
}

// Dynamic shared memory of one pass-1 CTA (kernels/paged_attn.smem_bytes
// mirrors it): per stage K and V rows (tc, row_bytes) and, for quantized
// pools, their scales (tc,) each; then q (G, hd), k_new and v_new (hd,),
// the scores (G, tc), alpha, l and m (G,), kSlots slots of mask values
// (tc,) and table entries (tb,), and kStages stages of row offsets (tc,).
__host__ __device__ inline size_t smem_bytes(int g, int hd, int bs, int elt, bool quant) {
  const size_t tb = tile_blocks(bs, tile_cols(hd, elt)), tc = tb * bs;
  return 2 * kStages * tc * row_bytes(hd, elt) + (quant ? 2 * kStages * tc * 4 : 0) +
         4 * ((size_t)g * hd + 2 * (size_t)hd + (size_t)g * tc + 3 * (size_t)g) +
         4 * (kSlots * (tc + tb) + kStages * tc);
}

// Dynamic shared memory of one combine CTA: m (then the weights) and l of
// every split and head, and each head's denominator.
__host__ __device__ inline size_t combine_smem_bytes(int g, int nsplit) {
  return 4 * (2 * (size_t)nsplit * g + (size_t)g);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One tile's weighted values for the first NR output elements of a thread
// (tid + 256 r: d = tid % HD, heads gg0 + r * 256 / HD): acc = acc * alpha
// + sum over the columns, in order, of p * v, each V value read and
// dequantized once for all NR, the weights four columns a load. The
// current token's column (pc) takes v_new; its zero-filled row is not used.
// An element whose head is past G sums head 0's weights and is never
// stored.
template <int NR, typename S, bool kQuant, int HD>
__device__ __forceinline__ void weigh_values(float (&acc)[kMaxOut], const unsigned char* vd,
                                             const float* vsc, const float* p_s,
                                             const float* alpha_s, float vnd, int d, int gg0,
                                             int g, int tc, int ncol, int pc) {
  constexpr int kHeadStep = kThreads / HD;
  const S* vcol = reinterpret_cast<const S*>(vd) + d;
  float a[NR];
  const float* pr[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int gg = gg0 + r * kHeadStep;
    a[r] = gg < g ? acc[r] * alpha_s[gg] : 0.f;
    pr[r] = p_s + (gg < g ? gg : 0) * tc;
  }
  auto value = [&](int c) {
    const S x = vcol[c * HD];            // staged rows are HD values apart
    return kQuant ? to_f32(x) * vsc[c] : to_f32(x);
  };
  auto step = [&](int c, float vf) {
#pragma unroll
    for (int r = 0; r < NR; ++r) a[r] = fmaf(pr[r][c], vf, a[r]);
  };
  // pool columns [from, to), four a weight load where the rows allow it
  auto run = [&](int from, int to) {
    int c = from;
    if ((tc & 3) == 0) {                      // weight rows 16-byte aligned
      for (; c < to && (c & 3); ++c) step(c, value(c));
#pragma unroll 2
      for (; c + 4 <= to; c += 4) {
        float vf[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) vf[u] = value(c + u);
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          const float4 w = *reinterpret_cast<const float4*>(pr[r] + c);
          a[r] = fmaf(w.x, vf[0], a[r]);
          a[r] = fmaf(w.y, vf[1], a[r]);
          a[r] = fmaf(w.z, vf[2], a[r]);
          a[r] = fmaf(w.w, vf[3], a[r]);
        }
      }
    }
#pragma unroll 4
    for (; c < to; ++c) step(c, value(c));
  };
  if (pc < 0) {
    run(0, ncol);
  } else {                                    // the columns in order, v_new at pc
    run(0, pc);
    step(pc, vnd);
    run(pc + 1, ncol);
  }
#pragma unroll
  for (int r = 0; r < NR; ++r) acc[r] = a[r];
}

// T: dtype of q, k_new, v_new and the output (float or bf16).
// S: storage dtype of the pool (T itself, int8 or fp8 e4m3).
// HD: head dim (32, 64, 128 or 256).
template <typename T, typename S, bool kQuant, int HD>
__global__ void __launch_bounds__(kThreads, kMinCtasPerSm)
paged_attn_kernel(const T* __restrict__ q,             // (b, KV, G, HD)
                  const S* __restrict__ k_pages,       // (NB, BS, KV, HD)
                  const S* __restrict__ v_pages,
                  const float* __restrict__ k_scales,  // (NB, BS, KV); quantized pools only
                  const float* __restrict__ v_scales,
                  const int* __restrict__ table,       // (b, MB)
                  const int* __restrict__ pos,         // (b,)
                  const T* __restrict__ k_new,         // (b, KV, HD)
                  const T* __restrict__ v_new,
                  const float* __restrict__ mask,      // (b, MB * BS)
                  T* __restrict__ out,                 // (b, KV * G * HD); S == 1
                  float* __restrict__ part,            // (b, KV, S, G, HD + 2); S > 1
                  int kv, int g, int bs, int mb, int nb, int tps, float scale,
                  float softcap) {
  constexpr int kVec = 16 / sizeof(S);        // pool elements per 16-byte copy
  constexpr int kChunks = HD / kVec;          // 16-byte copies per row
  constexpr int kRB = HD * sizeof(S);         // bytes a staged row
  const int k = blockIdx.x, i = blockIdx.y, split = blockIdx.z, nsplit = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tb = tile_blocks(bs, tile_cols(HD, sizeof(S))), tc = tb * bs;
  const int ntiles = (mb + tb - 1) / tb;
  const int t_begin = split * tps;
  int t_end = min(ntiles, t_begin + tps);     // t_begin when every block is dead

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* kv_s = smem;                         // (stages, K | V, tc, kRB)
  // (stages, K | V, tc) row scales of a quantized pool
  float* sc_s = reinterpret_cast<float*>(smem + 2 * kStages * (size_t)tc * kRB);
  float* q_s = sc_s + (kQuant ? 2 * kStages * tc : 0);   // (G, HD)
  float* kn_s = q_s + g * HD;                         // (HD,)
  float* vn_s = kn_s + HD;                            // (HD,)
  float* p_s = vn_s + HD;                             // (G, tc) scores, then weights
  float* alpha_s = p_s + g * tc;                      // (G,) rescale of the running sums
  float* l_s = alpha_s + g;                           // (G,) running denominators
  float* m_s = l_s + g;                               // (G,) running maxima
  float* mraw_s = m_s + g;                            // (slots, tc) mask values
  int* traw_s = reinterpret_cast<int*>(mraw_s + kSlots * tc);   // (slots, tb) table entries
  int* ro_s = traw_s + kSlots * tb;                   // (stages, tc) pool row, -1 dead, -2 pos

  asm volatile("griddepcontrol.wait;\n" ::: "memory");   // the kernel before is done
  const int p = pos[i];
  const size_t head = (size_t)i * kv + k;
  const float* mrow = mask + (size_t)i * mb * bs;
  const int* trow = table + (size_t)i * mb;

  // The ring: tile tt's K/V rows (and scales) and its row offsets in stage
  // (tt - t_begin) % kStages, its raw mask values and table entries in slot
  // (tt - t_begin) % kSlots. Rows are issued two tiles ahead and the mask
  // and table entries four, in one cp.async group per tile: while tile tt
  // is summed, the rows of tt + 1 and tt + 2 and the entries of tt + 3 and
  // tt + 4 are in flight, and no global load is waited on inside the loop.
  static_assert(kStages == 3 && kSlots == kStages + 2, "the loop below is written for 3 stages");
  auto stage = [&](int tt) { return (tt - t_begin) % kStages; };
  auto slot = [&](int tt) { return (tt - t_begin) % kSlots; };

  // Tile tt's mask values and table entries into its slot, asynchronously.
  auto fetch_meta = [&](int tt) {
    if (tt < t_end) {
      const int j0 = tt * tb, nblk = min(tb, mb - j0);
      float* mr = mraw_s + slot(tt) * tc;
      int* tr = traw_s + slot(tt) * tb;
      for (int c = tid; c < nblk * bs; c += kThreads) cp_async4(mr + c, mrow + j0 * bs + c, true);
      for (int jb = tid; jb < nblk; jb += kThreads) cp_async4(tr + jb, trow + j0 + jb, true);
    }
  };

  // Tile tt's staging plan from its landed slot into its stage: one warp
  // per block reads the block's mask values and table entry once and writes
  // each column's pool row; returns whether a block this thread's warp
  // planned is live (a barrier, __syncthreads_or, publishes the rows and
  // makes that the tile's answer).
  auto plan = [&](int tt) -> int {
    const int j0 = tt * tb, nblk = min(tb, mb - j0), c0 = j0 * bs, sl = slot(tt);
    const float* mr = mraw_s + sl * tc;
    int* ro = ro_s + stage(tt) * tc;
    int any = 0;
    for (int jb = warp; jb < nblk; jb += kWarps) {
      int alive = 0;
      for (int u = lane; u < bs; u += 32) alive |= mr[jb * bs + u] > kDeadMask;
      alive = __any_sync(0xffffffffu, alive);
      // out-of-range entries are clamped, as the reference's gather does
      const int phys = min(max(traw_s[sl * tb + jb], 0), nb - 1);
      for (int u = lane; u < bs; u += 32) {
        const int c = jb * bs + u;
        ro[c] = !alive ? -1 : (c0 + c == p ? -2 : (phys * bs + u) * kv + k);
      }
      any |= alive;
    }
    return any;
  };

  // Every 16-byte piece of tile tt's live rows, at once, into its stage.
  auto issue = [&](int tt, int live) {
    if (!live) return;
    const int ncol = min(tb, mb - tt * tb) * bs, st = stage(tt);
    const int* ro = ro_s + st * tc;
    unsigned char* kd = kv_s + (size_t)st * 2 * tc * kRB;
    unsigned char* vd = kd + (size_t)tc * kRB;
    for (int e = tid; e < ncol * kChunks; e += kThreads) {
      const int c = e / kChunks, ch = e % kChunks;
      const int r = ro[c];
      const size_t off = r >= 0 ? (size_t)r * HD + ch * kVec : 0;
      cp_async16(kd + c * kRB + kswz<kChunks>(c, ch) * 16, k_pages + off, r >= 0);
      cp_async16(vd + c * kRB + ch * 16, v_pages + off, r >= 0);
    }
    if (kQuant) {
      float* ksd = sc_s + st * 2 * tc;
      for (int c = tid; c < ncol; c += kThreads) {
        const int r = ro[c];
        cp_async4(ksd + c, k_scales + max(r, 0), r >= 0);
        cp_async4(ksd + tc + c, v_scales + max(r, 0), r >= 0);
      }
    }
  };

  // whether any block of the split is live: one pass over its mask entries
  int seen = 0;
  for (int c = t_begin * tc + tid; c < min(t_end * tc, mb * bs); c += kThreads)
    seen |= mrow[c] > kDeadMask;
  fetch_meta(t_begin);
  fetch_meta(t_begin + 1);
  cp_async_commit();
  for (int e = tid; e < g * HD; e += kThreads) q_s[e] = to_f32(q[head * g * HD + e]);
  for (int d = tid; d < HD; d += kThreads) {
    kn_s[d] = to_f32(k_new[head * HD + d]);
    vn_s[d] = to_f32(v_new[head * HD + d]);
  }
  if (tid < g) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kMaxOut];
#pragma unroll
  for (int r = 0; r < kMaxOut; ++r) acc[r] = 0.f;
  cp_async_wait<0>();
  // a split whose blocks are all dead adds nothing: it keeps m = -1e30,
  // l = 0 and acc = 0 and goes straight to its output
  if (!__syncthreads_or(seen)) t_end = t_begin;
  // one group a tile from here on: tile tt's rows with tile tt + 2's entries
  int live = __syncthreads_or(t_begin < t_end ? plan(t_begin) : 0);   // tiles tt, tt + 1
  if (t_begin < t_end) issue(t_begin, live);
  fetch_meta(t_begin + 2);
  cp_async_commit();
  int live1 = __syncthreads_or(t_begin + 1 < t_end ? plan(t_begin + 1) : 0);
  if (t_begin + 1 < t_end) issue(t_begin + 1, live1);
  fetch_meta(t_begin + 3);
  cp_async_commit();

  for (int tt = t_begin; tt < t_end; ++tt) {
    const int st = stage(tt), sl = slot(tt);
    cp_async_wait<1>();                       // tile tt's rows, tile tt + 2's entries
    __syncthreads();
    // tile tt + 2's row offsets now; the barrier after tile tt's scores
    // publishes them, then its rows and tile tt + 4's entries are issued
    const int plan2 = tt + 2 < t_end ? plan(tt + 2) : 0;
    const int c0 = tt * tb * bs, ncol = min(tb, mb - tt * tb) * bs;
    const int* ro = ro_s + st * tc;
    // the current token's column, when it lies in a live block of this tile
    const int pc = (live && p >= c0 && p < c0 + ncol && ro[p - c0] == -2) ? p - c0 : -1;
    if (live) {
      const float* mk = mraw_s + sl * tc;
      const unsigned char* kd = kv_s + (size_t)st * 2 * tc * kRB;
      const float* ksc = sc_s + st * 2 * tc;
      // scores: scale, soft cap, additive mask; columns of dead blocks get
      // -1e30. Thread (column c, lane group h) takes heads h, h + 4, ... two
      // at a time: a block of 32 K values is read (16-byte loads) and
      // dequantized once into registers and meets both heads' q (16-byte
      // broadcasts), the two fmaf chains interleaved; every (head, column)
      // dot is still one fmaf chain over d in order.
      for (int c = tid % kColLanes; c < ncol; c += kColLanes) {
        const int r = ro[c];
        const float ks = kQuant ? ksc[c] : 1.f;
        const unsigned char* krow = kd + c * kRB;
        for (int g0 = tid / kColLanes; g0 < g; g0 += kHeadLanes * kHeadsAtOnce) {
          float dot[kHeadsAtOnce];
          const float* qh[kHeadsAtOnce];      // a head past G reads head G - 1, unused
#pragma unroll
          for (int j = 0; j < kHeadsAtOnce; ++j) {
            dot[j] = 0.f;
            qh[j] = q_s + min(g0 + kHeadLanes * j, g - 1) * HD;
          }
          if (r == -2) {                      // the current token: k_new
            for (int d = 0; d < HD; ++d) {
#pragma unroll
              for (int j = 0; j < kHeadsAtOnce; ++j) dot[j] = fmaf(qh[j][d], kn_s[d], dot[j]);
            }
          } else if (r >= 0) {
#pragma unroll
            for (int d0 = 0; d0 < HD; d0 += kDBlock) {
              float kf[kDBlock];
#pragma unroll
              for (int ch = 0; ch < kDBlock / kVec; ++ch) {
                const int lc = d0 * sizeof(S) / 16 + ch;    // logical chunk
                const uint4 raw = *reinterpret_cast<const uint4*>(krow + kswz<kChunks>(c, lc) * 16);
                unpack16<S>(raw, kf + ch * kVec);
              }
              if (kQuant) {
#pragma unroll
                for (int u = 0; u < kDBlock; ++u) kf[u] *= ks;
              }
#pragma unroll
              for (int u = 0; u < kDBlock / 4; ++u) {
                float4 qq[kHeadsAtOnce];
#pragma unroll
                for (int j = 0; j < kHeadsAtOnce; ++j)
                  qq[j] = reinterpret_cast<const float4*>(qh[j] + d0)[u];
#pragma unroll
                for (int j = 0; j < kHeadsAtOnce; ++j) dot[j] = fmaf(qq[j].x, kf[4 * u], dot[j]);
#pragma unroll
                for (int j = 0; j < kHeadsAtOnce; ++j)
                  dot[j] = fmaf(qq[j].y, kf[4 * u + 1], dot[j]);
#pragma unroll
                for (int j = 0; j < kHeadsAtOnce; ++j)
                  dot[j] = fmaf(qq[j].z, kf[4 * u + 2], dot[j]);
#pragma unroll
                for (int j = 0; j < kHeadsAtOnce; ++j)
                  dot[j] = fmaf(qq[j].w, kf[4 * u + 3], dot[j]);
              }
            }
          }
#pragma unroll
          for (int j = 0; j < kHeadsAtOnce; ++j) {
            if (g0 + kHeadLanes * j < g) {
              float sc = kNegInf;
              if (r != -1) {
                sc = dot[j] * scale;
                if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
                sc += mk[c];
              }
              p_s[(g0 + kHeadLanes * j) * tc + c] = sc;
            }
          }
        }
      }
    }
    const int live2 = __syncthreads_or(plan2);
    if (tt + 2 < t_end) issue(tt + 2, live2);
    fetch_meta(tt + 4);
    cp_async_commit();
    if (live) {
      // online softmax: one warp per query head, two heads at once
      // (interleaved, each in the same order of operations as alone)
      for (int g0 = warp; g0 < g; g0 += 2 * kWarps) {
        const int g1 = g0 + kWarps;
        const bool two = g1 < g;
        float* p0 = p_s + g0 * tc;
        float* p1 = p_s + (two ? g1 : g0) * tc;
        float mx0 = kNegInf, mx1 = kNegInf;
        for (int c = lane; c < ncol; c += 32) {
          mx0 = fmaxf(mx0, p0[c]);
          mx1 = fmaxf(mx1, p1[c]);
        }
        mx0 = warp_max(mx0);
        mx1 = warp_max(mx1);
        const float mp0 = m_s[g0], mp1 = m_s[two ? g1 : g0];
        const float mn0 = fmaxf(mp0, mx0), mn1 = fmaxf(mp1, mx1);
        float s0 = 0.f, s1 = 0.f;
        for (int c = lane; c < ncol; c += 32) {
          const float w0 = expf(p0[c] - mn0);
          const float w1 = expf(p1[c] - mn1);
          s0 += w0;
          s1 += w1;
          p0[c] = w0;
          if (two) p1[c] = w1;
        }
        s0 = warp_sum(s0);
        s1 = warp_sum(s1);
        if (lane == 0) {
          const float a0 = expf(mp0 - mn0);
          alpha_s[g0] = a0;
          l_s[g0] = l_s[g0] * a0 + s0;
          m_s[g0] = mn0;
          if (two) {
            const float a1 = expf(mp1 - mn1);
            alpha_s[g1] = a1;
            l_s[g1] = l_s[g1] * a1 + s1;
            m_s[g1] = mn1;
          }
        }
      }
      __syncthreads();

      // weighted values: thread tid owns output elements tid + 256 r, which
      // share d = tid % HD (heads tid / HD + r * 256 / HD), so each V value
      // is read and dequantized once per column for all of them (the next
      // tile's barrier at the top of the loop ends this phase)
      {
        const unsigned char* vd = kv_s + (size_t)st * 2 * tc * kRB + (size_t)tc * kRB;
        const float* vsc = sc_s + st * 2 * tc + tc;
        const int nr = (g * HD + kThreads - 1) / kThreads;   // elements a thread owns
        const int d = tid % HD, gg0 = tid / HD;
        if (nr == 1) {
          weigh_values<1, S, kQuant, HD>(acc, vd, vsc, p_s, alpha_s, vn_s[d], d, gg0, g, tc,
                                         ncol, pc);
        } else if (nr == 2) {
          weigh_values<2, S, kQuant, HD>(acc, vd, vsc, p_s, alpha_s, vn_s[d], d, gg0, g, tc,
                                         ncol, pc);
        } else {
          weigh_values<kMaxOut, S, kQuant, HD>(acc, vd, vsc, p_s, alpha_s, vn_s[d], d, gg0, g,
                                               tc, ncol, pc);
        }
      }
    }
    live = live1;
    live1 = live2;
  }
  cp_async_wait<0>();
  __syncthreads();                            // l and m of every head are final

  if (nsplit == 1) {
#pragma unroll
    for (int r = 0; r < kMaxOut; ++r) {
      const int e = tid + r * kThreads;
      if (e < g * HD) {
        const float l = fmaxf(l_s[e / HD], 1e-30f);
        store_f32(out + head * g * HD + e, acc[r] / l);
      }
    }
  } else {
    float* pb = part + (head * nsplit + split) * g * (HD + 2);
#pragma unroll
    for (int r = 0; r < kMaxOut; ++r) {
      const int e = tid + r * kThreads;
      if (e < g * HD) pb[(e / HD) * (HD + 2) + e % HD] = acc[r];
    }
    if (tid < g) {
      pb[tid * (HD + 2) + HD] = m_s[tid];
      pb[tid * (HD + 2) + HD + 1] = l_s[tid];
    }
  }
  // this CTA is done: once every CTA is, the combine (launched after this
  // grid) may be scheduled
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
}

// Pass 2: one CTA per (row, KV head) weighs the S splits' partial sums.
// The splits' m and l come into shared memory with one load each, all in
// flight together; one thread per head forms the weights e^(m_s - m) and
// the denominator; then every output element sums its S accumulators.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_attn_combine_kernel(const float* __restrict__ part,   // (b, KV, S, G, HD + 2)
                          T* __restrict__ out,              // (b, KV * G * HD)
                          int g, int nsplit) {
  extern __shared__ float cm_s[];     // (S, G) m, then weights; (S, G) l; (G,) denominators
  float* cl_s = cm_s + nsplit * g;
  float* den_s = cl_s + nsplit * g;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");   // the split pass is complete
  const size_t head = blockIdx.x;
  const float* pb = part + head * nsplit * g * (HD + 2);
  for (int e = threadIdx.x; e < nsplit * g; e += kThreads) {
    cm_s[e] = pb[e * (HD + 2) + HD];
    cl_s[e] = pb[e * (HD + 2) + HD + 1];
  }
  __syncthreads();
  for (int gg = threadIdx.x; gg < g; gg += kThreads) {
    float m = kNegInf;
    for (int sp = 0; sp < nsplit; ++sp) m = fmaxf(m, cm_s[sp * g + gg]);
    float den = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) {
      const float w = expf(cm_s[sp * g + gg] - m);
      cm_s[sp * g + gg] = w;
      den = fmaf(w, cl_s[sp * g + gg], den);
    }
    den_s[gg] = fmaxf(den, 1e-30f);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < g * HD; e += kThreads) {
    const int gg = e / HD, d = e % HD;
    float num = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < nsplit; ++sp)
      num = fmaf(cm_s[sp * g + gg], pb[(sp * g + gg) * (HD + 2) + d], num);
    store_f32(out + head * g * HD + e, num / den_s[gg]);
  }
}

template <typename T, typename S, bool kQuant, int HD>
int launch(const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
           const void* table, const void* pos, const void* kn, const void* vn,
           const void* mask, void* out, void* part, int b, int kv, int g, int bs, int mb,
           int nb, int nsplit, int tps, float scale, float softcap, int device,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes(g, HD, bs, sizeof(S), kQuant);
  // the opt-in above 48 KB, once per device and size
  static size_t opted[kMaxDevices] = {};
  if (bytes > 48 * 1024 && bytes > opted[device]) {
    cudaError_t err = cudaFuncSetAttribute(paged_attn_kernel<T, S, kQuant, HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[device] = bytes;
  }
  // Both passes are programmatic dependent launches (Hopper): each may be
  // scheduled while the kernel before it drains, and waits in
  // griddepcontrol.wait until that kernel's writes are visible before it
  // reads anything, so the launch latency between them is hidden.
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kv, b, nsplit);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, paged_attn_kernel<T, S, kQuant, HD>, static_cast<const T*>(q),
      static_cast<const S*>(kp), static_cast<const S*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(pos), static_cast<const T*>(kn), static_cast<const T*>(vn),
      static_cast<const float*>(mask), static_cast<T*>(out), static_cast<float*>(part), kv, g,
      bs, mb, nb, tps, scale, softcap);
  if (err != cudaSuccess || nsplit == 1) return static_cast<int>(err);
  cfg.gridDim = dim3(b * kv);
  cfg.dynamicSmemBytes = combine_smem_bytes(g, nsplit);
  return static_cast<int>(cudaLaunchKernelEx(&cfg, paged_attn_combine_kernel<T, HD>,
                                             static_cast<const float*>(part),
                                             static_cast<T*>(out), g, nsplit));
}

template <typename T, typename S, bool kQuant>
int launch_hd(const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
              const void* table, const void* pos, const void* kn, const void* vn,
              const void* mask, void* out, void* part, int b, int kv, int g, int hd, int bs,
              int mb, int nb, int nsplit, int tps, float scale, float softcap, int device,
              cudaStream_t stream) {
#define PAGED_HD_ARGS q, kp, vp, ks, vs, table, pos, kn, vn, mask, out, part, b, kv, g, bs, mb, \
                      nb, nsplit, tps, scale, softcap, device, stream
  if (hd == 32) return launch<T, S, kQuant, 32>(PAGED_HD_ARGS);
  if (hd == 64) return launch<T, S, kQuant, 64>(PAGED_HD_ARGS);
  if (hd == 128) return launch<T, S, kQuant, 128>(PAGED_HD_ARGS);
  if (hd == 256) return launch<T, S, kQuant, 256>(PAGED_HD_ARGS);
#undef PAGED_HD_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype codes shared with kernels/paged_attn.py
enum Dtype { kF32 = 0, kBF16 = 1, kI8 = 2, kFP8 = 3 };

}  // namespace

// Returns cudaGetLastError() after the launches (0 on success); the Python
// wrapper raises on anything else. q_dtype is kF32 or kBF16; pool_dtype is
// q_dtype (float pool, scales null) or kI8 / kFP8 (quantized pool). nsplit
// and tps (tiles per split) are the wrapper's split plan; part is the f32
// scratch (b, KV, nsplit, G, hd + 2) when nsplit > 1, else null.
extern "C" int paged_attn(const void* q, const void* k_pages, const void* v_pages,
                          const void* k_scales, const void* v_scales, const void* table,
                          const void* pos, const void* k_new, const void* v_new,
                          const void* mask, void* out, void* part, int b, int kv, int g, int hd,
                          int bs, int mb, int nb, int nsplit, int tps, float scale,
                          float softcap, int q_dtype, int pool_dtype, int device,
                          void* stream) {
  const bool quant = pool_dtype == kI8 || pool_dtype == kFP8;
  const int elt = quant ? 1 : (pool_dtype == kF32 ? 4 : 2);
  const int tb = bs >= 1 ? tile_blocks(bs, tile_cols(hd, elt)) : 1;
  const int ntiles = mb >= 1 && bs >= 1 ? (mb + tb - 1) / tb : 0;
  if (b < 1 || b > 65535 || kv < 1 || g < 1 ||
      (hd != 32 && hd != 64 && hd != 128 && hd != 256) ||
      bs < 1 || mb < 1 || nb < 1 || g * hd > kMaxOut * kThreads || device < 0 ||
      device >= kMaxDevices || smem_bytes(g, hd, bs, elt, quant) > kMaxSmem || nsplit < 1 ||
      nsplit > kMaxSplits || tps < 1 || (nsplit - 1) * tps >= ntiles || nsplit * tps < ntiles ||
      (nsplit > 1) != (part != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (quant != (k_scales != nullptr && v_scales != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PAGED_ARGS q, k_pages, v_pages, k_scales, v_scales, table, pos, k_new, v_new, mask, out, \
                   part, b, kv, g, hd, bs, mb, nb, nsplit, tps, scale, softcap, device, s
  if (q_dtype == kF32) {
    if (pool_dtype == kF32) return launch_hd<float, float, false>(PAGED_ARGS);
    if (pool_dtype == kI8) return launch_hd<float, int8_t, true>(PAGED_ARGS);
    if (pool_dtype == kFP8) return launch_hd<float, __nv_fp8_e4m3, true>(PAGED_ARGS);
  } else if (q_dtype == kBF16) {
    if (pool_dtype == kBF16) return launch_hd<__nv_bfloat16, __nv_bfloat16, false>(PAGED_ARGS);
    if (pool_dtype == kI8) return launch_hd<__nv_bfloat16, int8_t, true>(PAGED_ARGS);
    if (pool_dtype == kFP8) return launch_hd<__nv_bfloat16, __nv_fp8_e4m3, true>(PAGED_ARGS);
  }
#undef PAGED_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
