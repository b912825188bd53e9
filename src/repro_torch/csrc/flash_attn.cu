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
// backward: dQ, dK, dV for every dtype, f32 arithmetic on the CUDA cores
// ---------------------------------------------------------------------------
//
// FlashAttention-2's scheme: the forward writes each query row's f32
// log-sum-exp (lse = m + log l); the backward recomputes the scores as the
// forward forms them (q . k * scale, the soft cap, the masks as -1e30) and
// the weights P = exp(score - lse), with D = rowsum(dO * O) per query row:
//   dV = P^T dO,  dP = dO V^T,  dS = P (dP - D) on the visible pairs (0 on
//   masked ones), times 1 - tanh^2 under a soft cap, times the scale;
//   dQ = dS K,  dK = dS^T Q.
// Three launches, each a plain deterministic loop (no atomics: every output
// element has one owner thread that adds its terms in a fixed order):
// - flash_bwd_delta_kernel: D, a warp a query row (an xor butterfly);
// - flash_bwd_dkdv_kernel: a CTA per (KV row, tile of 32 keys) stages the
//   tile's K and V once, then walks every query head of the KV row's group
//   and every tile of 32 query rows that can see the keys (causal: from the
//   key tile on; window: up to the last key + window); a thread owns one
//   key and every 8th 16-byte chunk of its dK and dV rows;
// - flash_bwd_dq_kernel: a CTA per (query row, tile of 32 positions) walks
//   the key tiles the forward walks; a thread owns one query position and
//   every 8th 16-byte chunk of its dQ row.
// A 32 x 32 tile's S and dP are formed by 256 threads, each one key (its
// lane) x 4 query rows (warp + 8 i), from f32 copies of the tiles in shared
// memory with rows HD + 4 floats apart (16-byte vector reads; a warp's 32
// keys' chunks fall in distinct bank groups, HD / 4 + 1 being odd), 10
// vector loads for 32 FMAs; P and dS pass through shared memory to the
// dK/dV or dQ products, where a thread owns the 16-byte chunks sub, sub +
// 8, ... of its row (a vector load for 4 FMAs). The inputs are read
// as bf16 / fp16 / f32 and every product and sum is f32; the gradients are
// rounded once to the inputs' dtype. A simple design: each score is a
// thread's serial HD-long dot product on the CUDA cores, and the dK/dV
// CTAs of the first key tiles see the most query tiles. Bound
// (kernels/bounds.py flash_backward): five products of 2 * HD operations a
// visible (query, key) pair over the bf16 tensor-core rate (or the f32
// rate), or the bytes of q, k, v, o, dO, dq, dk, dv and the lse, whichever
// is larger.

constexpr int kBwdThreads = 256;
constexpr int kBwdQ = 32;   // query positions a tile
constexpr int kBwdK = 32;   // keys a tile

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
template <typename T>
__device__ __forceinline__ void store4(T* dst, const float4& v) {
  dst[0] = from_f32<T>(v.x);
  dst[1] = from_f32<T>(v.y);
  dst[2] = from_f32<T>(v.z);
  dst[3] = from_f32<T>(v.w);
}

// floats between staged rows: a multiple of 4 (16-byte rows) whose count
// of 16-byte chunks, HD / 4 + 1, is odd, so a warp reading one chunk of 32
// rows hits distinct bank groups
template <int HD>
__host__ __device__ constexpr int bwd_row() {
  return HD + 4;
}
// two (32, HD) tiles of each side (K, V; Q, dO), P and dS (32 x 33), the
// query rows' lse and D
template <int HD>
constexpr size_t bwd_smem_bytes() {
  return sizeof(float) * (2 * (size_t)(kBwdK + kBwdQ) * bwd_row<HD>() +
                          2 * (size_t)kBwdQ * (kBwdK + 1) + 2 * (size_t)kBwdQ);
}

// rows [r0, r0 + rows) of a (len, HD) matrix into f32 rows of stride
// bwd_row; rows at or past len are zero
template <typename T, int HD>
__device__ __forceinline__ void stage_bwd(float* dst, const T* src, int r0, int len, int rows) {
  for (int e = threadIdx.x; e < rows * HD; e += kBwdThreads) {
    const int r = e / HD, d = e - r * HD;
    dst[r * bwd_row<HD>() + d] = r0 + r < len ? to_f32(src[(size_t)(r0 + r) * HD + d]) : 0.f;
  }
}

// the query tile's lse and D into shared memory (0 past s)
__device__ __forceinline__ void stage_rows(float* lse_s, float* dl_s, const float* lse,
                                           const float* delta, size_t base, int q0, int s) {
  for (int e = threadIdx.x; e < kBwdQ; e += kBwdThreads) {
    const bool in = q0 + e < s;
    lse_s[e] = in ? lse[base + q0 + e] : 0.f;
    dl_s[e] = in ? delta[base + q0 + e] : 0.f;
  }
}

// P and dS of one (query tile q0, key tile k0) pair into p_s / ds_s
// (32 x 33): thread (warp w, lane j) forms key j x query rows w + 8 i
template <int HD>
__device__ __forceinline__ void bwd_tile(const float* q_s, const float* do_s, const float* k_s,
                                         const float* v_s, const float* lse_s, const float* dl_s,
                                         float* p_s, float* ds_s, int q0, int k0, int s, int t,
                                         float scale, int causal, int window, float softcap) {
  constexpr int kRow = bwd_row<HD>();
  const int w = threadIdx.x >> 5, j = threadIdx.x & 31;
  float sc[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
  const float4* kr = reinterpret_cast<const float4*>(k_s + j * kRow);
  const float4* vr = reinterpret_cast<const float4*>(v_s + j * kRow);
#pragma unroll 2
  for (int d = 0; d < HD / 4; ++d) {
    const float4 kd = kr[d], vd = vr[d];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 qd = reinterpret_cast<const float4*>(q_s + (w + 8 * i) * kRow)[d];
      const float4 od = reinterpret_cast<const float4*>(do_s + (w + 8 * i) * kRow)[d];
      sc[i] = fmaf(qd.w, kd.w, fmaf(qd.z, kd.z, fmaf(qd.y, kd.y, fmaf(qd.x, kd.x, sc[i]))));
      dp[i] = fmaf(od.w, vd.w, fmaf(od.z, vd.z, fmaf(od.y, vd.y, fmaf(od.x, vd.x, dp[i]))));
    }
  }
  const int kp = k0 + j;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = w + 8 * i, qp = q0 + r;
    float x = sc[i] * scale, th = 0.f;
    if (softcap > 0.f) {
      th = tanhf(x / softcap);
      x = softcap * th;
    }
    const bool ok = !((causal && kp > qp) || (window > 0 && qp - kp >= window));
    float p = 0.f, ds = 0.f;
    if (kp < t && qp < s) {
      p = expf((ok ? x : kNegInf) - lse_s[r]);
      if (ok) {
        ds = p * (dp[i] - dl_s[r]);
        if (softcap > 0.f) ds *= 1.f - th * th;
        ds *= scale;
      }
    }
    p_s[r * (kBwdK + 1) + j] = p;
    ds_s[r * (kBwdK + 1) + j] = ds;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, long long rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * (kBwdThreads / 32) + warp;
  if (r >= rows) return;
  const T* o = out + r * HD;
  const T* g = dout + r * HD;
  float acc = 0.f;
  for (int d = lane; d < HD; d += 32) acc = fmaf(to_f32(o[d]), to_f32(g[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[r] = acc;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      int s, int t, int group, float scale, int causal, int window,
                      float softcap) {
  constexpr int kRow = bwd_row<HD>();
  constexpr int kC = (HD / 4 + 7) / 8;   // 16-byte chunks a thread owns: sub, sub + 8, ...
  extern __shared__ __align__(16) float bsm[];
  float* k_s = bsm;
  float* v_s = k_s + kBwdK * kRow;
  float* q_s = v_s + kBwdK * kRow;
  float* do_s = q_s + kBwdQ * kRow;
  float* p_s = do_s + kBwdQ * kRow;
  float* ds_s = p_s + kBwdQ * (kBwdK + 1);
  float* lse_s = ds_s + kBwdQ * (kBwdK + 1);
  float* dl_s = lse_s + kBwdQ;

  const int kvrow = blockIdx.x, k0 = blockIdx.y * kBwdK;
  const int kj = threadIdx.x >> 3, sub = threadIdx.x & 7;
  stage_bwd<T, HD>(k_s, k + (size_t)kvrow * t * HD, k0, t, kBwdK);
  stage_bwd<T, HD>(v_s, v + (size_t)kvrow * t * HD, k0, t, kBwdK);
  float4 ak[kC], av[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) ak[c] = av[c] = make_float4(0.f, 0.f, 0.f, 0.f);

  // the query positions that see a key of this tile
  const int k_last = min(k0 + kBwdK, t) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(s, k_last + window) : s;
  for (int g = 0; g < group; ++g) {
    const int row = kvrow * group + g;
    const T* qb = q + (size_t)row * s * HD;
    const T* dob = dout + (size_t)row * s * HD;
    for (int q0 = (q_lo / kBwdQ) * kBwdQ; q0 < q_hi; q0 += kBwdQ) {
      __syncthreads();                  // the last tile's Q, dO, P and dS are read
      stage_bwd<T, HD>(q_s, qb, q0, s, kBwdQ);
      stage_bwd<T, HD>(do_s, dob, q0, s, kBwdQ);
      stage_rows(lse_s, dl_s, lse, delta, (size_t)row * s, q0, s);
      __syncthreads();
      bwd_tile<HD>(q_s, do_s, k_s, v_s, lse_s, dl_s, p_s, ds_s, q0, k0, s, t, scale, causal,
                   window, softcap);
      __syncthreads();
      for (int r = 0; r < kBwdQ; ++r) {
        const float p = p_s[r * (kBwdK + 1) + kj], ds = ds_s[r * (kBwdK + 1) + kj];
        const float4* qr = reinterpret_cast<const float4*>(q_s + r * kRow);
        const float4* dor = reinterpret_cast<const float4*>(do_s + r * kRow);
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          if (sub + 8 * c < HD / 4) {
            fma4(av[c], p, dor[sub + 8 * c]);
            fma4(ak[c], ds, qr[sub + 8 * c]);
          }
        }
      }
    }
  }
  if (k0 + kj < t) {
    const size_t base = ((size_t)kvrow * t + k0 + kj) * HD;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      if (sub + 8 * c < HD / 4) {
        store4(dk + base + 4 * (sub + 8 * c), ak[c]);
        store4(dv + base + 4 * (sub + 8 * c), av[c]);
      }
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int s, int t, int group,
                    float scale, int causal, int window, float softcap) {
  constexpr int kRow = bwd_row<HD>();
  constexpr int kC = (HD / 4 + 7) / 8;
  extern __shared__ __align__(16) float bsm[];
  float* k_s = bsm;
  float* v_s = k_s + kBwdK * kRow;
  float* q_s = v_s + kBwdK * kRow;
  float* do_s = q_s + kBwdQ * kRow;
  float* p_s = do_s + kBwdQ * kRow;
  float* ds_s = p_s + kBwdQ * (kBwdK + 1);
  float* lse_s = ds_s + kBwdQ * (kBwdK + 1);
  float* dl_s = lse_s + kBwdQ;

  const int row = blockIdx.x, q0 = blockIdx.y * kBwdQ;
  const int qi = threadIdx.x >> 3, sub = threadIdx.x & 7;
  const int nq = min(kBwdQ, s - q0);
  const T* kb = k + (size_t)(row / group) * t * HD;
  const T* vb = v + (size_t)(row / group) * t * HD;
  stage_bwd<T, HD>(q_s, q + (size_t)row * s * HD, q0, s, kBwdQ);
  stage_bwd<T, HD>(do_s, dout + (size_t)row * s * HD, q0, s, kBwdQ);
  stage_rows(lse_s, dl_s, lse, delta, (size_t)row * s, q0, s);
  float4 aq[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) aq[c] = make_float4(0.f, 0.f, 0.f, 0.f);

  // the forward's key range for these query positions
  const int k_end = causal ? min(t, q0 + nq) : t;
  const int k_begin = window > 0 ? (max(0, q0 - window + 1) / kBwdK) * kBwdK : 0;
  for (int k0 = k_begin; k0 < k_end; k0 += kBwdK) {
    __syncthreads();                    // the last tile's K and dS are read
    stage_bwd<T, HD>(k_s, kb, k0, t, kBwdK);
    stage_bwd<T, HD>(v_s, vb, k0, t, kBwdK);
    __syncthreads();
    bwd_tile<HD>(q_s, do_s, k_s, v_s, lse_s, dl_s, p_s, ds_s, q0, k0, s, t, scale, causal,
                 window, softcap);
    __syncthreads();
    for (int j = 0; j < kBwdK; ++j) {
      const float ds = ds_s[qi * (kBwdK + 1) + j];
      const float4* kr = reinterpret_cast<const float4*>(k_s + j * kRow);
#pragma unroll
      for (int c = 0; c < kC; ++c)
        if (sub + 8 * c < HD / 4) fma4(aq[c], ds, kr[sub + 8 * c]);
    }
  }
  if (qi < nq) {
    const size_t base = ((size_t)row * s + q0 + qi) * HD;
#pragma unroll
    for (int c = 0; c < kC; ++c)
      if (sub + 8 * c < HD / 4) store4(dq + base + 4 * (sub + 8 * c), aq[c]);
  }
}

template <typename T, int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* out, const void* dout,
               const void* lse, void* delta, void* dq, void* dk, void* dv, int bh, int bkv, int s,
               int t, int group, float scale, int causal, int window, float softcap,
               cudaStream_t stream) {
  constexpr size_t bytes = bwd_smem_bytes<HD>();
  if ((s + kBwdQ - 1) / kBwdQ > 65535 || (t + kBwdK - 1) / kBwdK > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* gp = static_cast<const T*>(dout);
  const float* lp = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const long long rows = (long long)bh * s;
  const long long warps = kBwdThreads / 32;
  flash_bwd_delta_kernel<T, HD><<<(unsigned)((rows + warps - 1) / warps), kBwdThreads, 0,
                                  stream>>>(static_cast<const T*>(out), gp, dl, rows);
  flash_bwd_dkdv_kernel<T, HD><<<dim3(bkv, (t + kBwdK - 1) / kBwdK), kBwdThreads, bytes,
                                 stream>>>(qp, kp, vp, gp, lp, dl, static_cast<T*>(dk),
                                           static_cast<T*>(dv), s, t, group, scale, causal,
                                           window, softcap);
  flash_bwd_dq_kernel<T, HD><<<dim3(bh, (s + kBwdQ - 1) / kBwdQ), kBwdThreads, bytes, stream>>>(
      qp, kp, vp, gp, lp, dl, static_cast<T*>(dq), s, t, group, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd_hd(const void* q, const void* k, const void* v, const void* out, const void* dout,
                  const void* lse, void* delta, void* dq, void* dk, void* dv, int bh, int bkv,
                  int s, int t, int hd, int group, float scale, int causal, int window,
                  float softcap, cudaStream_t stream) {
#define FLASH_HD(H)                                                                           \
  if (hd == H) return launch_bwd<T, H>(q, k, v, out, dout, lse, delta, dq, dk, dv, bh, bkv, s, \
                                       t, group, scale, causal, window, softcap, stream);
  FLASH_HEAD_DIMS(FLASH_HD)
#undef FLASH_HD
  return static_cast<int>(cudaErrorInvalidValue);
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
// b*H x s), and dout; delta is an f32 workspace of b*H x s. Three launches
// on the stream (D, then dK/dV, then dQ); returns cudaGetLastError() after
// them (0 on success). window <= 0 means no window, softcap <= 0 none.
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v, const void* out,
                              const void* dout, const void* lse, void* delta, void* dq, void* dk,
                              void* dv, int bh, int bkv, int s, int t, int hd, int group,
                              float scale, int causal, int window, float softcap, int dtype,
                              int device, void* stream) {
  if (bh < 1 || bh > 65535 || bkv < 1 || s < 1 || t < 1 || group < 1 || bkv * group != bh)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_bwd_hd<float>(q, k, v, out, dout, lse, delta, dq, dk, dv, bh, bkv, s, t, hd,
                                group, scale, causal, window, softcap, st);
  if (dtype == kBF16)
    return launch_bwd_hd<__nv_bfloat16>(q, k, v, out, dout, lse, delta, dq, dk, dv, bh, bkv, s,
                                        t, hd, group, scale, causal, window, softcap, st);
  if (dtype == kF16)
    return launch_bwd_hd<__half>(q, k, v, out, dout, lse, delta, dq, dk, dv, bh, bkv, s, t, hd,
                                 group, scale, causal, window, softcap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
