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
// Two kernels, chosen by dtype (never by a failure):
//
// bf16 / fp16: flash_attn_mma_kernel, on the tensor cores (FA2's shape on
// mma.sync). One CTA of 4 warps owns 64 query rows of one (b*H) row, 16
// rows a warp, and walks 64-key K/V tiles. The tiles arrive through a
// 2-stage cp.async ring of 16-byte copies into an XOR-swizzled layout (so
// the ldmatrix reads of 8 rows hit 8 different bank groups), the next tile
// in flight while this one is multiplied. Q fragments are loaded once with
// ldmatrix; S = Q K^T runs as mma.sync.m16n8k16 with f32 accumulators; the
// scale, soft cap, masks and the online softmax run on S in registers (row
// max and sum across the 4 lanes of a row with shuffles, in f32); P is
// rounded to bf16 / fp16 in registers and reused as the A operand of
// P V, with V read by ldmatrix.trans. Rounding P adds up to 2^-9 (bf16)
// relative per weight; the denominator l sums the f32 weights. Only tiles
// that straddle the diagonal, the window's edge or the end of t are
// masked. Query tiles are handed out longest first (causal rows near the
// end see the most keys). Head dims 32, 64, 112, 128 and 256: at hd 112
// (14 chunks of 16 bytes a row, which chunk ^ (row & 7) would carry past
// the row) the staged rows are padded to 128 elements; the q . k k-steps
// (7) and the O n-tiles (14) stay whole. At hd 256 O alone holds 128 f32
// registers a lane, so the K/V tile is 32 keys and Q's fragments are
// reloaded from shared memory every k-step instead of held (64 registers),
// which keeps the kernel out of local memory; its 98,304 bytes of shared
// memory are opted into.
//
// f32: flash_attn_f32_kernel, register-tiled on the CUDA cores. f32 values
// do not fit bf16 tensor-core operands within 1e-5 and TF32 keeps about
// three decimal digits, so every product is an exact f32 FMA, as in the
// plain version; only the order of the f32 sums differs. Bound: the f32
// rate (67 TFLOP/s), since each staged element feeds 64 or more FMAs. The
// first design formed each score as one thread's HD-long dot product from
// shared memory (two loads an FMA: about 1/8 of the FMA rate), ran four
// phases a tile with the softmax on one warp a row, staged K/V element by
// element, and at hd 256 took 172,672 bytes: one 4-warp CTA an SM.
// This one:
// - A CTA of 8 warps owns 64 query rows of one (b*H) row; the grid is
//   (b*H, query tiles), tiles handed out longest causal rows first.
// - Thread layout: 16 row groups of 16 lanes (half a warp each); row group
//   ty holds rows ty, ty + 16, ty + 32, ty + 48, so a row's m and l live in
//   the registers of its 16 lanes.
// - S = Q K^T: K/V tiles of f32_keys() keys: 64, 32 at hd 128, 16 at hd 256.
//   The 16 lanes of a row group are key groups x d-splits (16 x 1, 8 x 2,
//   4 x 4): a lane holds a 4 x 4 micro-tile of S (its 4 rows x keys kg,
//   kg + KG, kg + 2 KG, kg + 3 KG) over the 16-byte d-chunks ds, ds + DS,
//   ... Per chunk, 8 ld.shared.v4 (4 Q rows, 4 K rows) feed 64 FMAs; each
//   partial sum runs left to right over the lane's d, the d-splits are
//   added by an xor butterfly (every split ends with the same bits).
// - Softmax in registers: scale, soft cap, masks (only on edge tiles), row
//   max and sum by xor shuffles over the key groups (the sum: each lane's
//   4 keys left to right, then a pairwise tree in lane order),
//   l = fma(l, alpha, sum), O *= alpha.
// - O += P V: P passes once through shared memory, one 16-byte vector a
//   row and key group (keys kg + KG j); a lane owns 4 rows x the 16-byte
//   dim-chunks g16, g16 + 16, ... (at hd 112 the 28 chunks leave lanes
//   12-15 a duplicate of chunk 27 in their second slot, at hd 32 lanes 8-15
//   one in their first; duplicates are not stored). Per P vector, 4 + 4 *
//   (chunks a lane) loads feed 64 * (chunks a lane) FMAs, keys in the order
//   of the P vectors: e, e + KG, e + 2 KG, e + 3 KG for e = 0 .. KG - 1.
// - Staging: 16-byte cp.async (4-byte copies where q, k or v is not 16-byte
//   aligned; an f32 row is a multiple of 16 bytes at every head dim), rows
//   padded to f32_row_floats() so that the rows a warp reads at once fall in
//   distinct 16-byte bank groups. K and V have one buffer each and fill in
//   turn: V of tile i while S of tile i runs, K of tile i + 1 while P V of
//   tile i runs; two barriers a tile.
// - Shared memory: 4 * (64 * row + 2 * keys * row + 64 * (keys + 4)) bytes,
//   at most 109,568 (hd 256): two CTAs (16 warps) fit an SM at every head
//   dim (flash_attn_f32_layout reports the occupancy); at most 128
//   registers a thread.
//
// Both kernels skip tiles above the causal diagonal or wholly outside the
// window: they add nothing to any position that has a visible key (the
// softmax weight of a masked key is exp(-1e30 - m) = 0 once m is finite,
// and a tile processed while m is still -1e30 is wiped by the factor
// exp(-1e30 - m) = 0 that the first visible key brings). Keys past t (the
// ragged tail of the last tile) get a score of -inf and weight 0; query
// positions past s are computed but not stored. wgmma with TMA is the next
// design for the tensor-core path.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;

// every head dim the wrapper takes (kernels/flash_attn.HEAD_DIMS)
#define FLASH_HEAD_DIMS(X) X(32) X(64) X(112) X(128) X(256)

constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
// 4 bytes, for sources that are not 16-byte aligned
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// f32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;  // 8 warps
constexpr int kF32BQ = 64;        // query rows a CTA
constexpr int kF32Lanes = 16;     // lanes of a row group (half a warp)
constexpr int kF32Rows = 4;       // rows a row group: ty + 16 i

// Keys a K/V tile: 64, or fewer where Q's 64 staged rows take the room
template <int HD>
__host__ __device__ constexpr int f32_keys() {
  return HD <= 112 ? 64 : HD <= 128 ? 32 : 16;
}
// d-splits of S: a row group's 16 lanes are (keys / 4) key groups x splits
template <int HD>
__host__ __device__ constexpr int f32_splits() {
  return kF32Lanes * 4 / f32_keys<HD>();
}
// Floats between staged rows: the head dim and a pad that makes the row
// stride, in 16-byte chunks, odd (one split), 3 mod 8 (two) or 4 mod 8
// (four), so that the rows and d-chunks a warp reads at once fall in
// distinct 16-byte bank groups.
template <int HD>
__host__ __device__ constexpr int f32_row_floats() {
  return HD + (f32_splits<HD>() == 1 ? 4 : f32_splits<HD>() == 2 ? 12 : 16);
}
// Q's rows, one K and one V tile, and P (64 rows of keys + 4 floats)
template <int HD>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * ((size_t)kF32BQ * f32_row_floats<HD>() +
                          2 * (size_t)f32_keys<HD>() * f32_row_floats<HD>() +
                          (size_t)kF32BQ * (f32_keys<HD>() + 4));
}

__device__ __forceinline__ float f4_at(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// `rows` rows of HD floats from src (row stride HD) into dst (row stride
// f32_row_floats), zero-filled from row `valid` on; 16-byte copies, or four
// 4-byte ones where a source is not 16-byte aligned (vec false)
template <int HD>
__device__ __forceinline__ void stage_f32(float* dst, const float* src, int rows, int valid,
                                          bool vec) {
  constexpr int kChunks = HD / 4;
  constexpr int kRow = f32_row_floats<HD>();
  for (int e = threadIdx.x; e < rows * kChunks; e += kF32Threads) {
    const int r = e / kChunks, ch = e - r * kChunks;   // a constant divisor: a multiply
    const float* s = src + (size_t)min(r, valid - 1) * HD + 4 * ch;
    float* d = dst + r * kRow + 4 * ch;
    if (vec) {
      cp_async16(d, s, r < valid);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) cp_async4(d + i, s + i, r < valid);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kF32Threads, 2)
flash_attn_f32_kernel(const float* __restrict__ q,   // (b*H, s, HD)
                      const float* __restrict__ k,   // (b*KV, t, HD)
                      const float* __restrict__ v,   // (b*KV, t, HD)
                      float* __restrict__ out,       // (b*H, s, HD)
                      float* __restrict__ lse,       // (b*H, s) or null
                      int s, int t, int group, float scale, int causal, int window,
                      float softcap, int vec) {
  constexpr int kKeys = f32_keys<HD>();
  constexpr int kDS = f32_splits<HD>();
  constexpr int kKG = kKeys / 4;                     // key groups: kKG * kDS = 16
  constexpr int kRow = f32_row_floats<HD>();
  constexpr int kPRow = kKeys + 4;
  constexpr int kChunks = HD / 4;                    // 16-byte chunks of a row
  constexpr int kOC = (kChunks + kF32Lanes - 1) / kF32Lanes;   // O chunks a lane, per row
  // unrolling of the S and P V loops: less at hd 256, where O alone takes
  // 64 registers a lane
  constexpr int kUnrollS = HD > 128 ? 2 : 4, kUnrollPV = HD > 128 ? 1 : 4;
  extern __shared__ __align__(16) float fsm[];
  float* q_s = fsm;                    // (BQ, kRow)
  float* k_s = q_s + kF32BQ * kRow;    // (kKeys, kRow)
  float* v_s = k_s + kKeys * kRow;     // (kKeys, kRow)
  float* p_s = v_s + kKeys * kRow;     // (BQ, kPRow): 16-byte vectors of keys kg + kKG j

  const int row = blockIdx.x;
  const int q0 = ((int)gridDim.y - 1 - (int)blockIdx.y) * kF32BQ;   // longest causal rows first
  const int ty = threadIdx.x >> 4;     // row group: rows ty + 16 i
  const int g16 = threadIdx.x & 15;
  const int kg = g16 % kKG, ds = g16 / kKG;   // S: key group and d-split of this lane
  const int nq = min(kF32BQ, s - q0);
  const float* qb = q + ((size_t)row * s + q0) * HD;
  const float* kb = k + (size_t)(row / group) * t * HD;
  const float* vb = v + (size_t)(row / group) * t * HD;

  // the keys this tile of query positions can see: none past the last
  // position (causal), none at or before first position - window
  const int k_end = causal ? min(t, q0 + nq) : t;
  const int k_begin = window > 0 ? (max(0, q0 - window + 1) / kKeys) * kKeys : 0;
  const int ntiles = k_end > k_begin ? (k_end - k_begin + kKeys - 1) / kKeys : 0;

  stage_f32<HD>(q_s, qb, kF32BQ, nq, vec);
  if (ntiles > 0)
    stage_f32<HD>(k_s, kb + (size_t)k_begin * HD, kKeys, min(kKeys, t - k_begin), vec);
  cp_async_commit();

  float o[kF32Rows][kOC][4];
#pragma unroll
  for (int i = 0; i < kF32Rows; ++i)
#pragma unroll
    for (int c = 0; c < kOC; ++c) o[i][c][0] = o[i][c][1] = o[i][c][2] = o[i][c][3] = 0.f;
  float m_r[kF32Rows], l_r[kF32Rows];
#pragma unroll
  for (int i = 0; i < kF32Rows; ++i) {
    m_r[i] = kNegInf;
    l_r[i] = 0.f;
  }

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = k_begin + it * kKeys;
    cp_async_wait<0>();
    __syncthreads();                   // K (and Q) in place; the last tile's P and V are read
    stage_f32<HD>(v_s, vb + (size_t)k0 * HD, kKeys, min(kKeys, t - k0), vec);
    cp_async_commit();

    // S: rows ty + 16 i x keys kg + kKG j, over the d-chunks ds, ds + kDS, ...
    float sc[kF32Rows][4];
#pragma unroll
    for (int i = 0; i < kF32Rows; ++i) sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
#pragma unroll(kUnrollS)
    for (int u = 0; u < kChunks / kDS; ++u) {
      const int d = 4 * (ds + kDS * u);
      float4 kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(k_s + (kg + kKG * j) * kRow + d);
#pragma unroll
      for (int i = 0; i < kF32Rows; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(q_s + (ty + 16 * i) * kRow + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = sc[i][j];
          a = fmaf(qv.x, kv[j].x, a);
          a = fmaf(qv.y, kv[j].y, a);
          a = fmaf(qv.z, kv[j].z, a);
          a = fmaf(qv.w, kv[j].w, a);
          sc[i][j] = a;
        }
      }
    }
#pragma unroll
    for (int off = kKG; off < kF32Lanes; off <<= 1)   // the d-splits' partial sums
#pragma unroll
      for (int i = 0; i < kF32Rows; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sc[i][j] = __fadd_rn(sc[i][j], __shfl_xor_sync(0xffffffffu, sc[i][j], off));

    // scale, soft cap, masks (only on tiles at an edge), running max
    const bool edge = k0 + kKeys > t || (causal && k0 + kKeys - 1 > q0) ||
                      (window > 0 && q0 + kF32BQ - 1 - k0 >= window);
    float mx[kF32Rows];
#pragma unroll
    for (int i = 0; i < kF32Rows; ++i) {
      mx[i] = m_r[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = sc[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        if (edge) {
          const int kp = k0 + kg + kKG * j, qp = q0 + ty + 16 * i;
          if (kp >= t) {
            x = -INFINITY;             // no key here: weight 0
          } else if ((causal && kp > qp) || (window > 0 && qp - kp >= window)) {
            x = kNegInf;
          }
        }
        sc[i][j] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    }
#pragma unroll
    for (int off = 1; off < kKG; off <<= 1)
#pragma unroll
      for (int i = 0; i < kF32Rows; ++i)
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
    float alpha[kF32Rows], rs[kF32Rows];
#pragma unroll
    for (int i = 0; i < kF32Rows; ++i) {
      alpha[i] = expf(m_r[i] - mx[i]);
      m_r[i] = mx[i];
      rs[i] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = expf(sc[i][j] - mx[i]);
        rs[i] = __fadd_rn(rs[i], sc[i][j]);
      }
    }
#pragma unroll
    for (int off = 1; off < kKG; off <<= 1)
#pragma unroll
      for (int i = 0; i < kF32Rows; ++i)
        rs[i] = __fadd_rn(rs[i], __shfl_xor_sync(0xffffffffu, rs[i], off));
#pragma unroll
    for (int i = 0; i < kF32Rows; ++i) {
      l_r[i] = fmaf(l_r[i], alpha[i], rs[i]);
      if (i % kDS == ds)               // one d-split writes each row's P
        *reinterpret_cast<float4*>(p_s + (ty + 16 * i) * kPRow + 4 * kg) =
            make_float4(sc[i][0], sc[i][1], sc[i][2], sc[i][3]);
#pragma unroll
      for (int c = 0; c < kOC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][c][e] = __fmul_rn(o[i][c][e], alpha[i]);
    }
    cp_async_wait<0>();
    __syncthreads();                   // V and P in place; K is read
    if (it + 1 < ntiles)
      stage_f32<HD>(k_s, kb + (size_t)(k0 + kKeys) * HD, kKeys, min(kKeys, t - k0 - kKeys), vec);
    cp_async_commit();

    // O += P V: rows ty + 16 i x the dim-chunks g16 + 16 c
#pragma unroll(kUnrollPV)
    for (int e = 0; e < kKG; ++e) {
      float4 pv[kF32Rows];
#pragma unroll
      for (int i = 0; i < kF32Rows; ++i)
        pv[i] = *reinterpret_cast<const float4*>(p_s + (ty + 16 * i) * kPRow + 4 * e);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* vr = v_s + (e + kKG * j) * kRow;
#pragma unroll
        for (int c = 0; c < kOC; ++c) {
          const float4 vv =
              *reinterpret_cast<const float4*>(vr + 4 * min(g16 + kF32Lanes * c, kChunks - 1));
#pragma unroll
          for (int i = 0; i < kF32Rows; ++i) {
            const float p = f4_at(pv[i], j);
            o[i][c][0] = fmaf(p, vv.x, o[i][c][0]);
            o[i][c][1] = fmaf(p, vv.y, o[i][c][1]);
            o[i][c][2] = fmaf(p, vv.z, o[i][c][2]);
            o[i][c][3] = fmaf(p, vv.w, o[i][c][3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  float* ob = out + ((size_t)row * s + q0) * HD;
#pragma unroll
  for (int i = 0; i < kF32Rows; ++i) {
    const int r = ty + 16 * i;
    const float l = fmaxf(l_r[i], 1e-30f);
    if (r >= nq) continue;
    // every lane of the row group holds the row's m and l
    if (lse != nullptr && g16 == 0) lse[(size_t)row * s + q0 + r] = m_r[i] + logf(l_r[i]);
#pragma unroll
    for (int c = 0; c < kOC; ++c) {
      const int ch = g16 + kF32Lanes * c;
      if (ch < kChunks)
        *reinterpret_cast<float4*>(ob + (size_t)r * HD + 4 * ch) =
            make_float4(o[i][c][0] / l, o[i][c][1] / l, o[i][c][2] / l, o[i][c][3] / l);
    }
  }
}

// the opt-in above 48 KB and the carveout that lets two CTAs share an SM,
// once per device
template <int HD>
cudaError_t f32_attributes(int device) {
  static bool done[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[device]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(flash_attn_f32_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(f32_smem_bytes<HD>()));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_attn_f32_kernel<HD>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) done[device] = true;
  return err;
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* out, float* lse, int bh,
               int s, int t, int group, float scale, int causal, int window, float softcap,
               int device, cudaStream_t stream) {
  const int nqt = (s + kF32BQ - 1) / kF32BQ;
  if (nqt > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = f32_attributes<HD>(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  flash_attn_f32_kernel<HD><<<dim3(bh, nqt), kF32Threads, f32_smem_bytes<HD>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), lse, s, t, group, scale, causal, window, softcap, vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32_hd(const void* q, const void* k, const void* v, void* out, float* lse, int bh,
                  int s, int t, int hd, int group, float scale, int causal, int window,
                  float softcap, int device, cudaStream_t stream) {
#define FLASH_HD(H)                                                                            \
  if (hd == H) return launch_f32<H>(q, k, v, out, lse, bh, s, t, group, scale, causal, window, \
                                    softcap, device, stream);
  FLASH_HEAD_DIMS(FLASH_HD)
#undef FLASH_HD
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// bf16 / fp16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps
constexpr int kMmaBQ = 64;        // query rows per CTA, 16 per warp
constexpr int kStages = 2;        // K/V tiles in the cp.async ring
constexpr float kLog2e = 1.4426950408889634f;

// Elements a staged row takes: the head dim, or, where its 16-byte chunks
// are no multiple of 8 (hd 112: 14), the next multiple of 64, so that the
// swizzle chunk ^ (row & 7) stays a permutation inside the row.
template <int HD>
__host__ __device__ constexpr int row_elems() {
  return HD < 64 || HD % 64 == 0 ? HD : (HD + 63) / 64 * 64;
}
// Keys a K/V tile: 64, or 32 at hd 256, where O's accumulators alone take
// 128 registers a lane (S takes 4 a lane per 8 keys).
template <int HD>
__host__ __device__ constexpr int kv_tile() {
  return HD > 128 ? 32 : 64;
}
// Q's fragments stay in registers (4 a lane per 16 dims) up to hd 128; at
// hd 256 (64 registers) they are reloaded from shared memory every k-step.
template <int HD>
__host__ __device__ constexpr bool q_in_regs() {
  return HD <= 128;
}

template <int HD>
constexpr size_t mma_smem_bytes() {
  return 2 * ((size_t)kMmaBQ * row_elems<HD>() +
              2 * (size_t)kStages * kv_tile<HD>() * row_elems<HD>());
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a (16x16, row) * b (16x8, col), f32 accumulators; pack() rounds two
// f32 values to one register of the operand type (lo = lower column)
template <typename T>
struct Mma;
template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};
template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

// Element offset of (row, 16-byte chunk) in a tile of row_elems<HD>()-element
// rows. The chunk is XORed with bits of the row so that 8 consecutive rows
// at one logical chunk (one ldmatrix 8x8 matrix) land in 8 different
// 16-byte bank groups: with 8 or more chunks a row, chunk ^ (row & 7); with
// 4 (hd 32, two rows per 128 bytes), chunk ^ ((row >> 1) & 3).
template <int HD>
__device__ __forceinline__ int swz(int row, int chunk) {
  constexpr int kRow = row_elems<HD>();
  const int pc = kRow >= 64 ? (chunk ^ (row & 7)) : (chunk ^ ((row >> 1) & 3));
  return row * kRow + pc * 8;
}

// T: bf16 or fp16 (q, k, v and the output); HD: head dim (32, 64, 112, 128,
// 256).
template <typename T, int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_attn_mma_kernel(const T* __restrict__ q,   // (b*H, s, HD)
                      const T* __restrict__ k,   // (b*KV, t, HD)
                      const T* __restrict__ v,   // (b*KV, t, HD)
                      T* __restrict__ out,       // (b*H, s, HD)
                      float* __restrict__ lse,   // (b*H, s) or null
                      int s, int t, int group, float scale, int causal, int window,
                      float softcap) {
  constexpr int kChunks = HD / 8;       // 16-byte chunks a row
  constexpr int kKSteps = HD / 16;      // k-steps of q . k
  constexpr int kKeys = kv_tile<HD>();  // keys a K/V tile
  constexpr int kSTiles = kKeys / 8;    // n-tiles of S (8 keys each)
  constexpr int kOTiles = HD / 8;       // n-tiles of O (8 dims each)
  constexpr int kRow = row_elems<HD>();
  constexpr bool kQRegs = q_in_regs<HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);     // (BQ, kRow), swizzled
  T* k_s = q_s + kMmaBQ * kRow;                // (stages, BK, kRow), swizzled
  T* v_s = k_s + kStages * kKeys * kRow;       // (stages, BK, kRow), swizzled

  const int nqt = (s + kMmaBQ - 1) / kMmaBQ;
  const int q0 = (nqt - 1 - (int)blockIdx.x) * kMmaBQ;   // longest causal rows first
  const int row = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;   // mma fragment row / column pair
  const int nq = min(kMmaBQ, s - q0);
  const T* qb = q + ((size_t)row * s + q0) * HD;
  const T* kb = k + (size_t)(row / group) * t * HD;
  const T* vb = v + (size_t)(row / group) * t * HD;

  for (int e = tid; e < kMmaBQ * kChunks; e += kMmaThreads) {
    const int r = e / kChunks, ch = e % kChunks;
    cp_async16(q_s + swz<HD>(r, ch), qb + (size_t)min(r, nq - 1) * HD + ch * 8, r < nq);
  }
  // the keys this tile of query positions can see: none past the last
  // position (causal), none at or before first position - window
  const int k_end = causal ? min(t, q0 + nq) : t;
  const int k_begin = window > 0 ? (max(0, q0 - window + 1) / kKeys) * kKeys : 0;
  const int ntiles = k_end > k_begin ? (k_end - k_begin + kKeys - 1) / kKeys : 0;

  auto load_kv = [&](int tile, int stage) {
    const int k0 = k_begin + tile * kKeys;
    T* ks = k_s + stage * kKeys * kRow;
    T* vs = v_s + stage * kKeys * kRow;
    for (int e = tid; e < kKeys * kChunks; e += kMmaThreads) {
      const int r = e / kChunks, ch = e % kChunks;
      const size_t off = (size_t)min(k0 + r, t - 1) * HD + ch * 8;
      cp_async16(ks + swz<HD>(r, ch), kb + off, k0 + r < t);
      cp_async16(vs + swz<HD>(r, ch), vb + off, k0 + r < t);
    }
  };
  if (ntiles > 0) load_kv(0, 0);
  cp_async_commit();                    // group 0: Q and the first tile

  uint32_t qf[kQRegs ? kKSteps : 1][4];   // Q's fragments, where they stay in registers
  float o[kOTiles][4];
#pragma unroll
  for (int n = 0; n < kOTiles; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};    // rows gid and gid + 8 of the warp's 16
  float l_r[2] = {0.f, 0.f};            // this lane's share of each row's sum
  const int qp_lo = q0 + warp * 16 + gid;

  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1;
    if (it + 1 < ntiles) load_kv(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                 // tile it (and Q) have landed
    __syncthreads();
    auto q_frag = [&](uint32_t (&r)[4], int kk) {
      ldmatrix_x4(r, q_s + swz<HD>(warp * 16 + (lane & 15), 2 * kk + (lane >> 4)));
    };
    if constexpr (kQRegs) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < kKSteps; ++kk) q_frag(qf[kk], kk);
      }
    }

    // S = Q K^T: 16 rows x kKeys keys a warp
    const T* ks = k_s + st * kKeys * kRow;
    float sc[kSTiles][4];
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      uint32_t qk[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) qk[i] = qf[kk][i];
      } else {
        q_frag(qk, kk);
      }
#pragma unroll
      for (int j = 0; j < kSTiles; j += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, ks + swz<HD>(j * 8 + (lane >> 4) * 8 + (lane & 7),
                                    2 * kk + ((lane >> 3) & 1)));
        Mma<T>::run(sc[j], qk, b[0], b[1]);
        Mma<T>::run(sc[j + 1], qk, b[2], b[3]);
      }
    }

    // scale, soft cap, masks (only on tiles at an edge), running max
    const int k0 = k_begin + it * kKeys;
    const bool edge = k0 + kKeys > t || (causal && k0 + kKeys - 1 > q0) ||
                      (window > 0 && q0 + kMmaBQ - 1 - k0 >= window);
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[j][e] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        if (edge) {
          const int kp = k0 + j * 8 + 2 * tig + (e & 1);
          const int qp = qp_lo + (e >> 1) * 8;
          if (kp >= t) {
            x = -INFINITY;              // no key here: weight 0
          } else if ((causal && kp > qp) || (window > 0 && qp - kp >= window)) {
            x = kNegInf;
          }
        }
        sc[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      alpha[h] = exp2f((m_r[h] - mx[h]) * kLog2e);
      m_r[h] = mx[h];
    }
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float w = exp2f((sc[j][e] - mx[e >> 1]) * kLog2e);
        sc[j][e] = w;
        rs[e >> 1] += w;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_r[h] = l_r[h] * alpha[h] + rs[h];
#pragma unroll
    for (int n = 0; n < kOTiles; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: P from the S accumulators (the C layout of two n-tiles is
    // the A layout of one k-step), V through ldmatrix.trans
    const T* vs = v_s + st * kKeys * kRow;
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      uint32_t a[4];
      a[0] = Mma<T>::pack(sc[2 * kk][0], sc[2 * kk][1]);
      a[1] = Mma<T>::pack(sc[2 * kk][2], sc[2 * kk][3]);
      a[2] = Mma<T>::pack(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      a[3] = Mma<T>::pack(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < kOTiles; n += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vs + swz<HD>(kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7),
                                          n + (lane >> 4)));
        Mma<T>::run(o[n], a, b[0], b[1]);
        Mma<T>::run(o[n + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();                    // stage st is free for tile it + 2
  }
  cp_async_wait<0>();

  // each row's denominator: the sum over the 4 lanes that share it
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 1);
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 2);
    l_r[h] = fmaxf(l_r[h], 1e-30f);
  }
  T* ob = out + ((size_t)row * s + q0) * HD;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + gid + h * 8;
    // the 4 lanes of a row hold its m and (now) its whole l
    if (r < nq && lse != nullptr && tig == 0)
      lse[(size_t)row * s + q0 + r] = m_r[h] + logf(l_r[h]);
    if (r < nq) {
#pragma unroll
      for (int n = 0; n < kOTiles; ++n) {
        const uint32_t pair = Mma<T>::pack(o[n][2 * h] / l_r[h], o[n][2 * h + 1] / l_r[h]);
        *reinterpret_cast<uint32_t*>(ob + (size_t)r * HD + n * 8 + 2 * tig) = pair;
      }
    }
  }
}

template <typename T, int HD>
int launch_mma(const void* q, const void* k, const void* v, void* out, float* lse, int bh,
               int s, int t, int group, float scale, int causal, int window, float softcap,
               cudaStream_t stream) {
  constexpr size_t bytes = mma_smem_bytes<HD>();
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(flash_attn_mma_kernel<T, HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((s + kMmaBQ - 1) / kMmaBQ, bh);
  flash_attn_mma_kernel<T, HD><<<grid, kMmaThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, s, t, group, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_mma_hd(const void* q, const void* k, const void* v, void* out, float* lse, int bh,
                  int s, int t, int hd, int group, float scale, int causal, int window,
                  float softcap, cudaStream_t stream) {
#define FLASH_HD(H)                                                                               \
  if (hd == H) return launch_mma<T, H>(q, k, v, out, lse, bh, s, t, group, scale, causal, window, \
                                       softcap, stream);
  FLASH_HEAD_DIMS(FLASH_HD)
#undef FLASH_HD
  return static_cast<int>(cudaErrorInvalidValue);
}


// ---------------------------------------------------------------------------
// backward: dQ, dK, dV
// ---------------------------------------------------------------------------
//
// FlashAttention-2's scheme: the forward writes each query row's f32
// log-sum-exp (lse = m + log l); the backward recomputes the scores as the
// forward forms them (q . k * scale, the soft cap, the masks as -1e30) and
// the weights P = exp(score - lse), with D = rowsum(dO * O) per query row:
//   dV = P^T dO,  dP = dO V^T,  dS = P (dP - D) on the visible pairs (0 on
//   masked ones), times 1 - tanh^2 under a soft cap, times the scale;
//   dQ = dS K,  dK = dS^T Q.
// Bound (kernels/bounds.py flash_backward): five products of 2 * HD
// operations a visible (query, key) pair over the bf16 tensor-core rate (or
// the f32 rate), or the bytes of q, k, v, o, dO, dq, dk, dv and the lse,
// whichever is larger. At 1 x 2048 and up it is the products.
//
// Deterministic, no atomics: every output element has one owner that adds
// its terms in a fixed order, so two calls give the same bits.
//
// The launches, for every dtype:
// - flash_bwd_delta_kernel: D, a warp a query row (an xor butterfly);
// - the dK/dV kernel: a CTA per (query head, key tile), grid (b*H, key
//   tiles), the first key tiles (which see the most causal queries) handed
//   out first. It stages the tile's K and V once and walks the query tiles
//   that can see a key of it (causal: from the key tile on; window: up to
//   the last key + window), with Q, dO (and their rows' lse and D) streamed.
//   Per query tile: S^T = K Q^T and dP^T = V dO^T, P^T and dS^T from them,
//   then dV += P^T dO and dK += dS^T Q;
// - flash_bwd_group_sum_kernel (only for GQA, group > 1): the dK/dV kernel
//   writes each query head's dK and dV as f32 partials to a workspace of
//   2 x (b*H, t, HD) floats that the wrapper allocates; this kernel adds
//   the group's G partials of each KV row in head order 0 .. G-1 and rounds
//   the sum once to the dtype (group 1 writes the dtype directly);
// - the dQ kernel: a CTA per (query head, 64-row query tile), grid (b*H,
//   query tiles), the last tiles (the longest causal rows) first, walks the
//   forward's key range with K and V streamed: S = Q K^T, dP = dO V^T, P and
//   dS again, dQ += dS K. S and dP are formed twice (once per kernel): seven
//   products against the bound's five, which buys dK/dV and dQ each one
//   owner without atomics or a reduction over query tiles.
// Both products kernels are one template each for the two roles (kDQ):
// "rows" are the tile a CTA owns and keeps (keys, or query positions),
// "columns" the tiles it streams (query positions, or keys), X = R1 C1^T
// and Y = R2 C2^T (S^T and dP^T, or S and dP), lse and D per column (dK/dV)
// or per row (dQ); the accumulations read the streamed tiles again
// (dK += dS^T C1, dV += P^T C2; dQ += dS C1). Masks are applied only on
// tiles at an edge (the diagonal, the window's edge, past s or t); tiles
// that no visible pair touches are not walked.
//
// bf16 / fp16: flash_bwd_mma_kernel on the tensor cores (FA2's backward on
// mma.sync.m16n8k16, f32 accumulators), built from the forward's parts:
// 4 warps, 16 rows a warp; the streamed tiles arrive through a 2-stage
// cp.async ring of 16-byte copies into the XOR-swizzled layout (swz), the
// next tile in flight while this one is multiplied; A operands from the
// kept rows by ldmatrix, B of X and Y by ldmatrix, B of the accumulations by
// ldmatrix.trans; P and dS are rounded to bf16 / fp16 in registers and
// reused as A operands (the C layout of two n-tiles is the A layout of one
// k-step), as the forward does with P. Rounding P and dS adds up to 2^-9
// (bf16) relative per term against the all-f32 plain version. Tiles: rows
// 64 a CTA (bwd_rows), columns 32 a streamed tile (kBwdCols). At hd 256 a
// dK/dV CTA's dK and dV of 16 keys would take 256 registers a lane, so two
// warps share 16 keys and split the head dim of the accumulators
// (bwd_dsplit; both form the same S^T and dP^T: 1.5x the products of that
// kernel) and a CTA owns 32 keys; at hd 112 the staged rows are padded to
// 128 elements, as in the forward. Shared memory: the kept
// rows' two tiles and two ring stages of two column tiles (and their lse
// and D), at most 131,072 bytes (the dQ kernel at hd 256), opted into.
//
// f32: flash_bwd_f32_kernel on the CUDA cores, register-tiled as the
// forward's f32 kernel (no TF32: f32 stays within 1e-4 of the plain
// version): 8 warps, 64 rows a CTA; 16 row groups of 16 lanes (half a warp),
// row group ty holding rows ty + 16 i; X and Y as 4 x 4 micro-tiles a lane
// (its 4 rows x columns cg + CG j) over the 16-byte d-chunks ds, ds + DS, ...
// (column tiles of f32_keys() columns: 64, 32 at hd 128, 16 at hd 256,
// and f32_splits() d-splits), each partial sum left to right over the
// lane's d, the d-splits added by an xor butterfly; P and dS pass once
// through shared memory as 16-byte vectors of columns cg + CG j; a lane owns
// 4 rows x the dim-chunks g16, g16 + 16, ... of each accumulator and adds
// the columns in the order of the vectors (e, e + CG, e + 2 CG, e + 3 CG for
// e = 0 .. CG - 1), tile after tile. Staging: 16-byte cp.async (4-byte where
// an input is not 16-byte aligned) into rows of f32_row_floats() floats;
// one buffer a tile, so a tile's copies do not overlap its products: at hd
// 32 and 64 two CTAs share an SM and cover each other's copies. Both f32
// products kernels run at 43-47 % of the f32 FMA peak on the visible pairs
// at 1 x 2048 (hd 64 with two CTAs an SM, hd 112 with one), the share of the
// forward's f32 kernel at the same shapes: issue slots and shared-memory
// reads (8 ld.shared.v4 a 64 FMAs in X and Y, as many in the accumulations),
// the P / dS pass through shared memory and two barriers a tile, not the
// bytes, bound it (NVIDIA H100 80GB HBM3 at 700 W,
// tests/profile_torch_flash_bwd.py).
//
// What the first design did and this one does not: every product
// on the CUDA cores in f32 for every dtype, each score one thread's serial
// HD-long dot product from shared memory (10 vector loads for 32 FMAs);
// tiles staged element by element with synchronous loads; one dK/dV CTA per
// (KV row, 32 keys) walking every head of the group and every visible query
// tile in series (256 CTAs at 1 x 2048, the first walking 8 x 64 tiles).
//
// Next for the tensor-core path: wgmma for the products whose B operands
// sit in shared memory (X and Y from the kept rows and the streamed tiles,
// both K-major as wgmma wants; the accumulations need the streamed tiles
// transposed, which wgmma reads from a transposed smem layout, or P and dS
// as register A operands), fed by TMA with an mbarrier ring in place of
// cp.async, with 64-row warpgroup tiles: a CTA of 2 warpgroups over 128 rows.

constexpr int kBwdThreads = 128;      // the tensor-core kernels: 4 warps
constexpr int kBwdDeltaThreads = 256;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f32<__half>(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }

// a += x * b, element by element
__device__ __forceinline__ void fma4(float4& a, float x, const float4& b) {
  a.x = fmaf(x, b.x, a.x);
  a.y = fmaf(x, b.y, a.y);
  a.z = fmaf(x, b.z, a.z);
  a.w = fmaf(x, b.w, a.w);
}

// The pair (query position qp, key position kp) is visible: a key there,
// a query there, and neither mask hides it.
__device__ __forceinline__ bool visible(int qp, int kp, int s, int t, int causal, int window) {
  return kp < t && qp < s && !(causal && kp > qp) && !(window > 0 && qp - kp >= window);
}

// P and dS of one pair from its score x (q . k, unscaled), its dP y and its
// query row's lse and D; the plain version's order of operations
__device__ __forceinline__ void p_ds(float x, float y, float l, float d, float scale,
                                     float softcap, bool vis, float& p, float& ds) {
  x *= scale;
  float th = 0.f;
  if (softcap > 0.f) {
    th = tanhf(x / softcap);
    x = softcap * th;
  }
  p = vis ? expf(x - l) : 0.f;
  ds = vis ? p * (y - d) : 0.f;
  if (softcap > 0.f) ds *= 1.f - th * th;
  ds *= scale;
}

// The edge of a (key tile, query tile) pair: some pair in it is masked or
// lies past s or t
__device__ __forceinline__ bool bwd_edge(int k0, int nk, int q0, int nq, int s, int t, int causal,
                                         int window) {
  return k0 + nk > t || q0 + nq > s || (causal && k0 + nk - 1 > q0) ||
         (window > 0 && q0 + nq - 1 - k0 >= window);
}

// The streamed tiles a CTA walks: [*begin, end) in tiles of `cols`, from
// its kept rows [r0, r0 + rows) (keys for dK/dV, query positions for dQ)
__device__ __forceinline__ int bwd_range(bool dq, int r0, int rows, int cols, int s, int t,
                                         int causal, int window, int* begin) {
  int lo, hi;
  if (dq) {   // the forward's key range of these query positions
    const int nq = min(rows, s - r0);
    hi = causal ? min(t, r0 + nq) : t;
    lo = window > 0 ? max(0, r0 - window + 1) : 0;
  } else {    // the query positions that see a key of this tile
    const int k_last = min(r0 + rows, t) - 1;
    lo = causal ? r0 : 0;
    hi = window > 0 ? min(s, k_last + window) : s;
  }
  *begin = (lo / cols) * cols;
  return hi > *begin ? (hi - *begin + cols - 1) / cols : 0;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kBwdDeltaThreads)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, long long rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * (kBwdDeltaThreads / 32) + warp;
  if (r >= rows) return;
  const T* o = out + r * HD;
  const T* g = dout + r * HD;
  float acc = 0.f;
  for (int d = lane; d < HD; d += 32) acc = fmaf(to_f32(o[d]), to_f32(g[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[r] = acc;
}

// dk = sum over g of dk_part[kv * group + g] in the order g = 0 .. group - 1,
// rounded once; the same for dv. n = b*KV * t * HD, per = t * HD (both
// multiples of 4).
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_group_sum_kernel(const float* __restrict__ dk_part, const float* __restrict__ dv_part,
                           T* __restrict__ dk, T* __restrict__ dv, long long n, long long per,
                           int group) {
  for (long long i = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x); i < n;
       i += 4 * (long long)gridDim.x * blockDim.x) {
    const long long kv = i / per, off = i - kv * per;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    for (int g = 0; g < group; ++g) {
      const size_t at = (size_t)(kv * group + g) * per + off;
      const float4 x = *reinterpret_cast<const float4*>(dk_part + at);
      const float4 y = *reinterpret_cast<const float4*>(dv_part + at);
      a = make_float4(a.x + x.x, a.y + x.y, a.z + x.z, a.w + x.w);
      b = make_float4(b.x + y.x, b.y + y.y, b.z + y.z, b.w + y.w);
    }
    const float ak[4] = {a.x, a.y, a.z, a.w}, av[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk[i + e] = from_f32<T>(ak[e]);
      dv[i + e] = from_f32<T>(av[e]);
    }
  }
}

// ---- bf16 / fp16 on the tensor cores --------------------------------------

// Warps that share one 16-row block and split the head dim of its
// accumulators: 2 for dK/dV at hd 256, else 1.
template <int HD, bool kDQ>
__host__ __device__ constexpr int bwd_dsplit() {
  return !kDQ && HD > 128 ? 2 : 1;
}
// Rows a CTA keeps: 16 a warp over the d-splits.
template <int HD, bool kDQ>
__host__ __device__ constexpr int bwd_rows() {
  return 16 * (kBwdThreads / 32) / bwd_dsplit<HD, kDQ>();
}
// Columns a streamed tile, 32 at every head dim: 64-column tiles hold
// twice the X and Y accumulators (32 registers a lane more), which costs a
// CTA an SM. The bits do not depend on it: the accumulations' k-steps of 16
// columns run in the same order either way.
constexpr int kBwdCols = 32;
// the kept rows' two tiles, two ring stages of two column tiles and, for
// dK/dV, the columns' lse and D in each stage
template <int HD, bool kDQ>
constexpr size_t bwd_mma_smem_bytes() {
  return 2 * (2 * (size_t)bwd_rows<HD, kDQ>() * row_elems<HD>() +
              2 * (size_t)kStages * kBwdCols * row_elems<HD>()) +
         (kDQ ? 0 : sizeof(float) * 2 * (size_t)kStages * kBwdCols);
}

// kDQ false: dK/dV of the key tile blockIdx.y of query head blockIdx.x
// (rows: keys of KV row blockIdx.x / group; columns: that head's query
// positions); kDQ true: dQ of the query tile (nqt - 1 - blockIdx.y) of query
// row blockIdx.x (rows: its query positions; columns: keys).
template <typename T, int HD, bool kDQ>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dq, T* __restrict__ dk,
                     T* __restrict__ dv, float* __restrict__ dk_part,
                     float* __restrict__ dv_part, int s, int t, int group, float scale,
                     int causal, int window, float softcap) {
  constexpr int kChunks = HD / 8;            // 16-byte chunks a row
  constexpr int kRow = row_elems<HD>();
  constexpr int kSplit = bwd_dsplit<HD, kDQ>();
  constexpr int kRows = bwd_rows<HD, kDQ>();
  constexpr int kCols = kBwdCols;
  constexpr int kXTiles = kCols / 8;         // n-tiles of X and Y
  constexpr int kAccD = HD / kSplit;         // accumulator dims a warp
  constexpr int kAccTiles = kAccD / 8;       // n-tiles of an accumulator
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* r1_s = reinterpret_cast<T*>(smem_raw);             // (kRows, kRow): K or Q
  T* r2_s = r1_s + kRows * kRow;                        // V or dO
  T* c1_s = r2_s + kRows * kRow;                        // (stages, kCols, kRow): Q or K
  T* c2_s = c1_s + kStages * kCols * kRow;              // dO or V
  float* lse_s = reinterpret_cast<float*>(c2_s + kStages * kCols * kRow);   // (stages, kCols)
  float* dl_s = lse_s + kStages * kCols;

  const int row = blockIdx.x;                // query head (b*H row)
  const int kvrow = row / group;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wrow = (warp / kSplit) * 16;     // the warp's 16 rows in the CTA
  const int dchunk = (warp % kSplit) * (kAccD / 8);   // its first accumulator chunk
  const int rlen = kDQ ? s : t, clen = kDQ ? t : s;
  const int r0 = kDQ ? ((int)gridDim.y - 1 - (int)blockIdx.y) * kRows : (int)blockIdx.y * kRows;
  const int nr = min(kRows, rlen - r0);
  const T* r1 = kDQ ? q + (size_t)row * s * HD : k + (size_t)kvrow * t * HD;
  const T* r2 = kDQ ? dout + (size_t)row * s * HD : v + (size_t)kvrow * t * HD;
  const T* c1 = kDQ ? k + (size_t)kvrow * t * HD : q + (size_t)row * s * HD;
  const T* c2 = kDQ ? v + (size_t)kvrow * t * HD : dout + (size_t)row * s * HD;

  for (int e = tid; e < kRows * kChunks; e += kBwdThreads) {
    const int r = e / kChunks, ch = e % kChunks;
    const size_t off = (size_t)(r0 + min(r, nr - 1)) * HD + ch * 8;
    cp_async16(r1_s + swz<HD>(r, ch), r1 + off, r < nr);
    cp_async16(r2_s + swz<HD>(r, ch), r2 + off, r < nr);
  }
  int c_begin;
  const int ntiles = bwd_range(kDQ, r0, kRows, kCols, s, t, causal, window, &c_begin);

  auto load_cols = [&](int tile, int stage) {
    const int c0 = c_begin + tile * kCols;
    T* d1 = c1_s + stage * kCols * kRow;
    T* d2 = c2_s + stage * kCols * kRow;
    for (int e = tid; e < kCols * kChunks; e += kBwdThreads) {
      const int r = e / kChunks, ch = e % kChunks;
      const size_t off = (size_t)min(c0 + r, clen - 1) * HD + ch * 8;
      cp_async16(d1 + swz<HD>(r, ch), c1 + off, c0 + r < clen);
      cp_async16(d2 + swz<HD>(r, ch), c2 + off, c0 + r < clen);
    }
    if constexpr (!kDQ) {
      for (int e = tid; e < kCols; e += kBwdThreads) {
        const size_t at = (size_t)row * s + min(c0 + e, s - 1);
        cp_async4(lse_s + stage * kCols + e, lse + at, c0 + e < s);
        cp_async4(dl_s + stage * kCols + e, delta + at, c0 + e < s);
      }
    }
  };
  if (ntiles > 0) load_cols(0, 0);
  cp_async_commit();                    // group 0: the kept rows and the first tile

  // dQ: the lse and D of the lane's rows gid and gid + 8
  float lse_r[2] = {0.f, 0.f}, dl_r[2] = {0.f, 0.f};
  if constexpr (kDQ) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t at = (size_t)row * s + min(r0 + wrow + gid + 8 * h, s - 1);
      lse_r[h] = lse[at];
      dl_r[h] = delta[at];
    }
  }
  float acc_a[kDQ ? 1 : kAccTiles][4];       // dV (dK/dV only)
  float acc_b[kAccTiles][4];                 // dK or dQ
#pragma unroll
  for (int n = 0; n < kAccTiles; ++n) {
    acc_b[n][0] = acc_b[n][1] = acc_b[n][2] = acc_b[n][3] = 0.f;
    if constexpr (!kDQ) acc_a[n][0] = acc_a[n][1] = acc_a[n][2] = acc_a[n][3] = 0.f;
  }

  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1;
    if (it + 1 < ntiles) load_cols(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                 // tile it (and the kept rows) have landed
    __syncthreads();
    const T* t1 = c1_s + st * kCols * kRow;
    const T* t2 = c2_s + st * kCols * kRow;

    // X = R1 C1^T, Y = R2 C2^T: 16 rows x kCols columns a warp
    float xs[kXTiles][4], ys[kXTiles][4];
#pragma unroll
    for (int j = 0; j < kXTiles; ++j) {
      xs[j][0] = xs[j][1] = xs[j][2] = xs[j][3] = 0.f;
      ys[j][0] = ys[j][1] = ys[j][2] = ys[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a1[4], a2[4];
      ldmatrix_x4(a1, r1_s + swz<HD>(wrow + (lane & 15), 2 * kk + (lane >> 4)));
      ldmatrix_x4(a2, r2_s + swz<HD>(wrow + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
      for (int j = 0; j < kXTiles; j += 2) {
        const int br = j * 8 + (lane >> 4) * 8 + (lane & 7), bc = 2 * kk + ((lane >> 3) & 1);
        uint32_t b[4];
        ldmatrix_x4(b, t1 + swz<HD>(br, bc));
        Mma<T>::run(xs[j], a1, b[0], b[1]);
        Mma<T>::run(xs[j + 1], a1, b[2], b[3]);
        ldmatrix_x4(b, t2 + swz<HD>(br, bc));
        Mma<T>::run(ys[j], a2, b[0], b[1]);
        Mma<T>::run(ys[j + 1], a2, b[2], b[3]);
      }
    }

    // P and dS in place of X and Y
    const int c0 = c_begin + it * kCols;
    const bool edge = kDQ ? bwd_edge(c0, kCols, r0, kRows, s, t, causal, window)
                          : bwd_edge(r0, kRows, c0, kCols, s, t, causal, window);
#pragma unroll
    for (int j = 0; j < kXTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rp = r0 + wrow + gid + (e >> 1) * 8, cc = j * 8 + 2 * tig + (e & 1);
        const int cp = c0 + cc;
        const float l = kDQ ? lse_r[e >> 1] : lse_s[st * kCols + cc];
        const float d = kDQ ? dl_r[e >> 1] : dl_s[st * kCols + cc];
        const bool vis = !edge || (kDQ ? visible(rp, cp, s, t, causal, window)
                                       : visible(cp, rp, s, t, causal, window));
        p_ds(xs[j][e], ys[j][e], l, d, scale, softcap, vis, xs[j][e], ys[j][e]);
      }
    }

    // dQ += dS C1 (K); dK += dS^T C1 (Q), dV += P^T C2 (dO): P and dS from
    // the X / Y accumulators, C1 and C2 through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kCols / 16; ++kk) {
      uint32_t a_ds[4], a_p[4];
      a_ds[0] = Mma<T>::pack(ys[2 * kk][0], ys[2 * kk][1]);
      a_ds[1] = Mma<T>::pack(ys[2 * kk][2], ys[2 * kk][3]);
      a_ds[2] = Mma<T>::pack(ys[2 * kk + 1][0], ys[2 * kk + 1][1]);
      a_ds[3] = Mma<T>::pack(ys[2 * kk + 1][2], ys[2 * kk + 1][3]);
      if constexpr (!kDQ) {
        a_p[0] = Mma<T>::pack(xs[2 * kk][0], xs[2 * kk][1]);
        a_p[1] = Mma<T>::pack(xs[2 * kk][2], xs[2 * kk][3]);
        a_p[2] = Mma<T>::pack(xs[2 * kk + 1][0], xs[2 * kk + 1][1]);
        a_p[3] = Mma<T>::pack(xs[2 * kk + 1][2], xs[2 * kk + 1][3]);
      }
#pragma unroll
      for (int n = 0; n < kAccTiles; n += 2) {
        const int br = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
        const int bc = dchunk + n + (lane >> 4);
        uint32_t b[4];
        ldmatrix_x4_trans(b, t1 + swz<HD>(br, bc));
        Mma<T>::run(acc_b[n], a_ds, b[0], b[1]);
        Mma<T>::run(acc_b[n + 1], a_ds, b[2], b[3]);
        if constexpr (!kDQ) {
          ldmatrix_x4_trans(b, t2 + swz<HD>(br, bc));
          Mma<T>::run(acc_a[n], a_p, b[0], b[1]);
          Mma<T>::run(acc_a[n + 1], a_p, b[2], b[3]);
        }
      }
    }
    __syncthreads();                    // stage st is free for tile it + 2
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wrow + gid + 8 * h;
    if (r >= nr) continue;
    const size_t base = ((size_t)row * rlen + r0 + r) * HD + dchunk * 8 + 2 * tig;
#pragma unroll
    for (int n = 0; n < kAccTiles; ++n) {
      if constexpr (kDQ) {
        *reinterpret_cast<uint32_t*>(dq + base + n * 8) =
            Mma<T>::pack(acc_b[n][2 * h], acc_b[n][2 * h + 1]);
      } else if (dk_part == nullptr) {   // group 1: row is the KV row
        *reinterpret_cast<uint32_t*>(dk + base + n * 8) =
            Mma<T>::pack(acc_b[n][2 * h], acc_b[n][2 * h + 1]);
        *reinterpret_cast<uint32_t*>(dv + base + n * 8) =
            Mma<T>::pack(acc_a[n][2 * h], acc_a[n][2 * h + 1]);
      } else {
        *reinterpret_cast<float2*>(dk_part + base + n * 8) =
            make_float2(acc_b[n][2 * h], acc_b[n][2 * h + 1]);
        *reinterpret_cast<float2*>(dv_part + base + n * 8) =
            make_float2(acc_a[n][2 * h], acc_a[n][2 * h + 1]);
      }
    }
  }
}

// ---- f32 on the CUDA cores ------------------------------------------------

// the kept rows' two tiles (64 rows), one buffer of each column tile, dS
// (and P) as 64 rows of columns + 4 floats, and for dK/dV the columns' lse
// and D
template <int HD, bool kDQ>
constexpr size_t bwd_f32_smem_bytes() {
  return sizeof(float) * (2 * (size_t)kF32BQ * f32_row_floats<HD>() +
                          2 * (size_t)f32_keys<HD>() * f32_row_floats<HD>() +
                          (kDQ ? 1 : 2) * (size_t)kF32BQ * (f32_keys<HD>() + 4) +
                          (kDQ ? 0 : 2 * (size_t)f32_keys<HD>()));
}
// The f32 kernels are compiled for two CTAs an SM where their shared memory
// lets two share one (hd 32 and 64), else for one with every register. At
// 128 registers the dK/dV kernel spills 16 (hd 32) and 60 (hd 64) bytes a
// thread; compiled for one CTA an SM it spills nothing (168 registers) but
// took 11 % longer at 1 x 2048, hd 64 (1,220 against 1,095 us on an NVIDIA
// H100 80GB HBM3 at 700 W, tests/profile_torch_flash_bwd.py), so two stay.
template <int HD, bool kDQ>
__global__ void __launch_bounds__(kF32Threads, HD <= 64 ? 2 : 1)
flash_bwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
                     float* __restrict__ dk_part, float* __restrict__ dv_part, int s, int t,
                     int group, float scale, int causal, int window, float softcap, int vec) {
  constexpr int kCols = f32_keys<HD>();
  constexpr int kDS = f32_splits<HD>();
  constexpr int kCG = kCols / 4;                     // column groups: kCG * kDS = 16
  constexpr int kRow = f32_row_floats<HD>();
  constexpr int kPRow = kCols + 4;
  constexpr int kChunks = HD / 4;
  constexpr int kOC = (kChunks + kF32Lanes - 1) / kF32Lanes;   // accumulator chunks a lane
  constexpr int kUnroll = HD > 128 ? 2 : 4, kUnrollAcc = kDQ ? 4 : 2;
  extern __shared__ __align__(16) float fsm[];
  float* r1_s = fsm;                      // (64, kRow): K or Q
  float* r2_s = r1_s + kF32BQ * kRow;     // V or dO
  float* c1_s = r2_s + kF32BQ * kRow;     // (kCols, kRow): Q or K
  float* c2_s = c1_s + kCols * kRow;      // dO or V
  float* ds_s = c2_s + kCols * kRow;      // (64, kPRow)
  float* p_s = ds_s + kF32BQ * kPRow;     // (64, kPRow), dK/dV only
  float* lse_s = p_s + kF32BQ * kPRow;    // (kCols), dK/dV only
  float* dl_s = lse_s + kCols;

  const int row = blockIdx.x;
  const int kvrow = row / group;
  const int ty = threadIdx.x >> 4, g16 = threadIdx.x & 15;
  const int cg = g16 % kCG, ds = g16 / kCG;
  const int rlen = kDQ ? s : t, clen = kDQ ? t : s;
  const int r0 = kDQ ? ((int)gridDim.y - 1 - (int)blockIdx.y) * kF32BQ
                     : (int)blockIdx.y * kF32BQ;
  const int nr = min(kF32BQ, rlen - r0);
  const float* r1 = kDQ ? q + ((size_t)row * s + r0) * HD : k + ((size_t)kvrow * t + r0) * HD;
  const float* r2 = kDQ ? dout + ((size_t)row * s + r0) * HD : v + ((size_t)kvrow * t + r0) * HD;
  const float* c1 = kDQ ? k + (size_t)kvrow * t * HD : q + (size_t)row * s * HD;
  const float* c2 = kDQ ? v + (size_t)kvrow * t * HD : dout + (size_t)row * s * HD;
  stage_f32<HD>(r1_s, r1, kF32BQ, nr, vec);
  stage_f32<HD>(r2_s, r2, kF32BQ, nr, vec);
  cp_async_commit();
  int c_begin;
  const int ntiles = bwd_range(kDQ, r0, kF32BQ, kCols, s, t, causal, window, &c_begin);

  float lse_r[kF32Rows], dl_r[kF32Rows];   // dQ: the rows' lse and D
  if constexpr (kDQ) {
#pragma unroll
    for (int i = 0; i < kF32Rows; ++i) {
      const size_t at = (size_t)row * s + min(r0 + ty + 16 * i, s - 1);
      lse_r[i] = lse[at];
      dl_r[i] = delta[at];
    }
  }
  float4 acc_a[kDQ ? 1 : kF32Rows][kOC];     // dV
  float4 acc_b[kF32Rows][kOC];               // dK or dQ
#pragma unroll
  for (int i = 0; i < kF32Rows; ++i)
#pragma unroll
    for (int c = 0; c < kOC; ++c) {
      acc_b[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (!kDQ) acc_a[i][c] = acc_b[i][c];
    }

  for (int it = 0; it < ntiles; ++it) {
    const int c0 = c_begin + it * kCols;
    __syncthreads();                      // the last tile's columns, P and dS are read
    stage_f32<HD>(c1_s, c1 + (size_t)c0 * HD, kCols, min(kCols, clen - c0), vec);
    stage_f32<HD>(c2_s, c2 + (size_t)c0 * HD, kCols, min(kCols, clen - c0), vec);
    if constexpr (!kDQ) {
      for (int e = threadIdx.x; e < kCols; e += kF32Threads) {
        const size_t at = (size_t)row * s + min(c0 + e, s - 1);
        cp_async4(lse_s + e, lse + at, c0 + e < s);
        cp_async4(dl_s + e, delta + at, c0 + e < s);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // X = R1 C1^T, Y = R2 C2^T: rows ty + 16 i x columns cg + kCG j, over
    // the d-chunks ds, ds + kDS, ...
    float xs[kF32Rows][4], ys[kF32Rows][4];
#pragma unroll
    for (int i = 0; i < kF32Rows; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) xs[i][j] = ys[i][j] = 0.f;
#pragma unroll(kUnroll)
    for (int u = 0; u < kChunks / kDS; ++u) {
      const int d = 4 * (ds + kDS * u);
      float4 cv1[4], cv2[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        cv1[j] = *reinterpret_cast<const float4*>(c1_s + (cg + kCG * j) * kRow + d);
        cv2[j] = *reinterpret_cast<const float4*>(c2_s + (cg + kCG * j) * kRow + d);
      }
#pragma unroll
      for (int i = 0; i < kF32Rows; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(r1_s + (ty + 16 * i) * kRow + d);
        const float4 b = *reinterpret_cast<const float4*>(r2_s + (ty + 16 * i) * kRow + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = xs[i][j], y = ys[i][j];
          x = fmaf(a.x, cv1[j].x, x);
          x = fmaf(a.y, cv1[j].y, x);
          x = fmaf(a.z, cv1[j].z, x);
          x = fmaf(a.w, cv1[j].w, x);
          y = fmaf(b.x, cv2[j].x, y);
          y = fmaf(b.y, cv2[j].y, y);
          y = fmaf(b.z, cv2[j].z, y);
          y = fmaf(b.w, cv2[j].w, y);
          xs[i][j] = x;
          ys[i][j] = y;
        }
      }
    }
#pragma unroll
    for (int off = kCG; off < kF32Lanes; off <<= 1)   // the d-splits' partial sums
#pragma unroll
      for (int i = 0; i < kF32Rows; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          xs[i][j] = __fadd_rn(xs[i][j], __shfl_xor_sync(0xffffffffu, xs[i][j], off));
          ys[i][j] = __fadd_rn(ys[i][j], __shfl_xor_sync(0xffffffffu, ys[i][j], off));
        }

    // P and dS; one d-split writes each row's vectors
    const bool edge = kDQ ? bwd_edge(c0, kCols, r0, kF32BQ, s, t, causal, window)
                          : bwd_edge(r0, kF32BQ, c0, kCols, s, t, causal, window);
#pragma unroll
    for (int i = 0; i < kF32Rows; ++i) {
      const int rp = r0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cc = cg + kCG * j, cp = c0 + cc;
        const float l = kDQ ? lse_r[i] : lse_s[cc];
        const float d = kDQ ? dl_r[i] : dl_s[cc];
        const bool vis = !edge || (kDQ ? visible(rp, cp, s, t, causal, window)
                                       : visible(cp, rp, s, t, causal, window));
        p_ds(xs[i][j], ys[i][j], l, d, scale, softcap, vis, xs[i][j], ys[i][j]);
      }
      if (i % kDS == ds) {
        *reinterpret_cast<float4*>(ds_s + (ty + 16 * i) * kPRow + 4 * cg) =
            make_float4(ys[i][0], ys[i][1], ys[i][2], ys[i][3]);
        if constexpr (!kDQ)
          *reinterpret_cast<float4*>(p_s + (ty + 16 * i) * kPRow + 4 * cg) =
              make_float4(xs[i][0], xs[i][1], xs[i][2], xs[i][3]);
      }
    }
    __syncthreads();

    // acc_b += dS C1, acc_a += P C2: rows ty + 16 i x the dim-chunks
    // g16 + 16 c, columns in the order of the vectors
#pragma unroll(kUnrollAcc)
    for (int e = 0; e < kCG; ++e) {
      float4 dsv[kF32Rows], pv[kDQ ? 1 : kF32Rows];
#pragma unroll
      for (int i = 0; i < kF32Rows; ++i) {
        dsv[i] = *reinterpret_cast<const float4*>(ds_s + (ty + 16 * i) * kPRow + 4 * e);
        if constexpr (!kDQ)
          pv[i] = *reinterpret_cast<const float4*>(p_s + (ty + 16 * i) * kPRow + 4 * e);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cr = (e + kCG * j) * kRow;
#pragma unroll
        for (int c = 0; c < kOC; ++c) {
          const int ch = 4 * min(g16 + kF32Lanes * c, kChunks - 1);
          const float4 b1 = *reinterpret_cast<const float4*>(c1_s + cr + ch);
#pragma unroll
          for (int i = 0; i < kF32Rows; ++i) fma4(acc_b[i][c], f4_at(dsv[i], j), b1);
          if constexpr (!kDQ) {
            const float4 b2 = *reinterpret_cast<const float4*>(c2_s + cr + ch);
#pragma unroll
            for (int i = 0; i < kF32Rows; ++i) fma4(acc_a[i][c], f4_at(pv[i], j), b2);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kF32Rows; ++i) {
    const int r = ty + 16 * i;
    if (r >= nr) continue;
    const size_t base = ((size_t)row * rlen + r0 + r) * HD;
#pragma unroll
    for (int c = 0; c < kOC; ++c) {
      const int ch = g16 + kF32Lanes * c;
      if (ch >= kChunks) continue;
      const size_t at = base + 4 * ch;
      if constexpr (kDQ) {
        *reinterpret_cast<float4*>(dq + at) = acc_b[i][c];
      } else {
        float* ok = dk_part == nullptr ? dk : dk_part;   // group 1: row is the KV row
        float* ov = dk_part == nullptr ? dv : dv_part;
        *reinterpret_cast<float4*>(ok + at) = acc_b[i][c];
        *reinterpret_cast<float4*>(ov + at) = acc_a[i][c];
      }
    }
  }
}

// ---- launch ---------------------------------------------------------------

// The products kernel of dtype T at head dim HD for one role: its function,
// shared memory, threads and rows a CTA.
template <typename T, int HD, bool kDQ>
struct BwdKernel {
  static auto fn() { return flash_bwd_mma_kernel<T, HD, kDQ>; }
  static constexpr size_t bytes = bwd_mma_smem_bytes<HD, kDQ>();
  static constexpr int threads = kBwdThreads, rows = bwd_rows<HD, kDQ>();
};
template <int HD, bool kDQ>
struct BwdKernel<float, HD, kDQ> {
  static auto fn() { return flash_bwd_f32_kernel<HD, kDQ>; }
  static constexpr size_t bytes = bwd_f32_smem_bytes<HD, kDQ>();
  static constexpr int threads = kF32Threads, rows = kF32BQ;
};

// the opt-in above 48 KB and the carveout for shared memory, once per
// kernel and device
template <typename K>
cudaError_t bwd_attributes(int device) {
  static bool done[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[device]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(K::fn(), cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(K::bytes));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(K::fn(), cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) done[device] = true;
  return err;
}

template <typename T, int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* out, const void* dout,
               const void* lse, void* delta, void* dq, void* dk, void* dv, void* dk_part,
               void* dv_part, int bh, int bkv, int s, int t, int group, float scale, int causal,
               int window, float softcap, int device, cudaStream_t stream) {
  using KV = BwdKernel<T, HD, false>;
  using DQ = BwdKernel<T, HD, true>;
  const int kv_tiles = (t + KV::rows - 1) / KV::rows, q_tiles = (s + DQ::rows - 1) / DQ::rows;
  if (kv_tiles > 65535 || q_tiles > 65535 || (group > 1 && (dk_part == nullptr ||
                                                            dv_part == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = bwd_attributes<KV>(device);
  if (err == cudaSuccess) err = bwd_attributes<DQ>(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* gp = static_cast<const T*>(dout);
  const float* lp = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* pk = group > 1 ? static_cast<float*>(dk_part) : nullptr;
  float* pv = group > 1 ? static_cast<float*>(dv_part) : nullptr;
  const long long rows = (long long)bh * s;
  const long long warps = kBwdDeltaThreads / 32;
  flash_bwd_delta_kernel<T, HD><<<(unsigned)((rows + warps - 1) / warps), kBwdDeltaThreads, 0,
                                  stream>>>(static_cast<const T*>(out), gp, dl, rows);
  if constexpr (std::is_same<T, float>::value) {
    const int vec = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) &
                     15) == 0;
    flash_bwd_f32_kernel<HD, false><<<dim3(bh, kv_tiles), KV::threads, KV::bytes, stream>>>(
        qp, kp, vp, gp, lp, dl, nullptr, static_cast<float*>(dk), static_cast<float*>(dv), pk,
        pv, s, t, group, scale, causal, window, softcap, vec);
    flash_bwd_f32_kernel<HD, true><<<dim3(bh, q_tiles), DQ::threads, DQ::bytes, stream>>>(
        qp, kp, vp, gp, lp, dl, static_cast<float*>(dq), nullptr, nullptr, nullptr, nullptr, s,
        t, group, scale, causal, window, softcap, vec);
  } else {
    flash_bwd_mma_kernel<T, HD, false><<<dim3(bh, kv_tiles), KV::threads, KV::bytes, stream>>>(
        qp, kp, vp, gp, lp, dl, nullptr, static_cast<T*>(dk), static_cast<T*>(dv), pk, pv, s, t,
        group, scale, causal, window, softcap);
    flash_bwd_mma_kernel<T, HD, true><<<dim3(bh, q_tiles), DQ::threads, DQ::bytes, stream>>>(
        qp, kp, vp, gp, lp, dl, static_cast<T*>(dq), nullptr, nullptr, nullptr, nullptr, s, t,
        group, scale, causal, window, softcap);
  }
  if (group > 1) {
    const long long n = (long long)bkv * t * HD;
    const long long want = (n / 4 + 255) / 256, blocks = want < 132 * 16 ? want : 132 * 16;
    flash_bwd_group_sum_kernel<T><<<(unsigned)blocks, 256, 0, stream>>>(
        pk, pv, static_cast<T*>(dk), static_cast<T*>(dv), n, (long long)t * HD, group);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd_hd(const void* q, const void* k, const void* v, const void* out, const void* dout,
                  const void* lse, void* delta, void* dq, void* dk, void* dv, void* dk_part,
                  void* dv_part, int bh, int bkv, int s, int t, int hd, int group, float scale,
                  int causal, int window, float softcap, int device, cudaStream_t stream) {
#define FLASH_HD(H)                                                                             \
  if (hd == H) return launch_bwd<T, H>(q, k, v, out, dout, lse, delta, dq, dk, dv, dk_part,      \
                                       dv_part, bh, bkv, s, t, group, scale, causal, window,     \
                                       softcap, device, stream);
  FLASH_HEAD_DIMS(FLASH_HD)
#undef FLASH_HD
  return static_cast<int>(cudaErrorInvalidValue);
}

// shared memory and CTAs an SM of one backward products kernel
template <typename T, int HD, bool kDQ>
int bwd_layout(int device, int* smem_bytes, int* ctas_per_sm) {
  using K = BwdKernel<T, HD, kDQ>;
  const cudaError_t err = bwd_attributes<K>(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem_bytes = static_cast<int>(K::bytes);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, K::fn(), K::threads, K::bytes));
}

// dtype codes shared with kernels/flash_attn.py
enum Dtype { kF32 = 0, kBF16 = 1, kF16 = 2 };

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success); the Python
// wrapper raises on anything else. window <= 0 means no window, softcap
// <= 0 no soft cap. f32 runs the CUDA-core kernel (16-byte copies where
// q, k and v are 16-byte aligned, else 4-byte ones), bf16 and fp16 the
// tensor-core kernel (whose 16-byte copies need 16-byte aligned q, k, v).
extern "C" int flash_attn(const void* q, const void* k, const void* v, void* out, void* lse,
                          int bh, int bkv, int s, int t, int hd, int group, float scale,
                          int causal, int window, float softcap, int dtype, int device,
                          void* stream) {
  if (bh < 1 || bh > 65535 || s < 1 || t < 1 || group < 1 || bkv * group != bh)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == kF32)
    return launch_f32_hd(q, k, v, out, l, bh, s, t, hd, group, scale, causal, window, softcap,
                         device, st);
  if (dtype == kBF16)
    return launch_mma_hd<__nv_bfloat16>(q, k, v, out, l, bh, s, t, hd, group, scale, causal,
                                        window, softcap, st);
  if (dtype == kF16)
    return launch_mma_hd<__half>(q, k, v, out, l, bh, s, t, hd, group, scale, causal, window,
                                 softcap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The f32 kernel's dynamic shared memory at head dim hd and how many of its
// CTAs an SM holds (the card tests and chip_smoke.py check both). Returns 0
// on success.
extern "C" int flash_attn_f32_layout(int hd, int device, int* smem_bytes, int* ctas_per_sm) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
#define FLASH_HD(H)                                                                        \
  if (hd == H) {                                                                           \
    err = f32_attributes<H>(device);                                                       \
    if (err != cudaSuccess) return static_cast<int>(err);                                  \
    *smem_bytes = static_cast<int>(f32_smem_bytes<H>());                                   \
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(                \
        ctas_per_sm, flash_attn_f32_kernel<H>, kF32Threads, f32_smem_bytes<H>()));         \
  }
  FLASH_HEAD_DIMS(FLASH_HD)
#undef FLASH_HD
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward of flash_attn: dq (b*H, s, hd), dk and dv (b*KV, t, hd) in
// the inputs' dtype from q, k, v, the forward's output and its lse (f32,
// b*H x s), and dout; delta is an f32 workspace of b*H x s, and for group >
// 1 dk_part and dv_part f32 workspaces of b*H x t x hd each (null for group
// 1). Three launches on the stream (D, dK/dV, dQ) and for group > 1 a
// fourth (the group sum); returns cudaGetLastError() after them (0 on
// success). window <= 0 means no window, softcap <= 0 none. f32 runs the
// CUDA-core kernels (16-byte copies where q, k, v and dout are 16-byte
// aligned, else 4-byte ones), bf16 and fp16 the tensor-core kernels (16-byte
// aligned q, k, v and dout).
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v, const void* out,
                              const void* dout, const void* lse, void* delta, void* dq, void* dk,
                              void* dv, void* dk_part, void* dv_part, int bh, int bkv, int s,
                              int t, int hd, int group, float scale, int causal, int window,
                              float softcap, int dtype, int device, void* stream) {
  if (bh < 1 || bh > 65535 || bkv < 1 || s < 1 || t < 1 || group < 1 || bkv * group != bh)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_bwd_hd<float>(q, k, v, out, dout, lse, delta, dq, dk, dv, dk_part, dv_part, bh,
                                bkv, s, t, hd, group, scale, causal, window, softcap, device, st);
  if (dtype == kBF16)
    return launch_bwd_hd<__nv_bfloat16>(q, k, v, out, dout, lse, delta, dq, dk, dv, dk_part,
                                        dv_part, bh, bkv, s, t, hd, group, scale, causal, window,
                                        softcap, device, st);
  if (dtype == kF16)
    return launch_bwd_hd<__half>(q, k, v, out, dout, lse, delta, dq, dk, dv, dk_part, dv_part,
                                 bh, bkv, s, t, hd, group, scale, causal, window, softcap,
                                 device, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// One backward products kernel's dynamic shared memory at head dim hd and
// how many of its CTAs an SM holds: dtype 0 (f32) the CUDA-core kernels,
// 1 / 2 (bf16 / fp16) the tensor-core ones; dq 0 the dK/dV kernel, 1 the dQ
// kernel (the card tests and chip_smoke.py check both against
// kernels/flash_attn.py). Returns 0 on success.
extern "C" int flash_attn_bwd_layout(int hd, int dtype, int dq, int device, int* smem_bytes,
                                     int* ctas_per_sm) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
#define FLASH_LAYOUT(T, H)                                                         \
  return dq ? bwd_layout<T, H, true>(device, smem_bytes, ctas_per_sm)              \
            : bwd_layout<T, H, false>(device, smem_bytes, ctas_per_sm);
#define FLASH_HD(H)                                                                \
  if (hd == H) {                                                                   \
    if (dtype == kF32) FLASH_LAYOUT(float, H)                                      \
    if (dtype == kBF16) FLASH_LAYOUT(__nv_bfloat16, H)                             \
    if (dtype == kF16) FLASH_LAYOUT(__half, H)                                     \
  }
  FLASH_HEAD_DIMS(FLASH_HD)
#undef FLASH_HD
#undef FLASH_LAYOUT
  return static_cast<int>(cudaErrorInvalidValue);
}
