// Fused RMSNorm + int8 group-wise activation quantization for Hopper
// (sm_90a), bound to PyTorch through a plain C interface (ctypes, see
// kernels/rmsnorm_quant.py).
//
// Replaces the TPU kernel of the reference package:
//   rmsnorm_quant <- repro/kernels/rmsnorm_quant.py rmsnorm_quant_pallas
//                    (_kernel). No model path calls it, in the reference or
//                    in the port: the reference model rounds the normed row
//                    back to the compute dtype before quantize_activation,
//                    which a fused kernel would skip at bf16. It is ported
//                    as the reference has it, a standalone op held to its
//                    oracle (kernels/ref.py rmsnorm_quant_ref).
//
// What it computes, per row of x (m, n) (any float dtype, read as f32) with
// weight w (n,): inv = 1 / sqrt(mean(x^2) + eps); normed = x * inv * w; per
// group of GS columns S = absmax(normed) * (2/255), q = round(normed / S)
// half to even, clipped to +-127 (a group of zeros keeps S = 0 and q = 0).
// Outputs int8 q (m, n) and f32 S (m, n / GS).
//
// Bound on the card (kernels/bounds.py rmsnorm_quant): about 8 f32
// operations per element against 3-6 bytes moved per element, far below the
// card's operations per byte, so the least time is the bytes over
// 3.35 TB/s. At TinyLlama's rows (1-3 MB) that is under 1.5 us, so what
// bounds a call is its critical path: one DRAM round trip for x and w, one
// reduction, the quantization, the stores.
//
// Design (rmsnorm_quant_rows_kernel). A lane takes chunks of kChunk = 8
// consecutive elements (16 bytes of bf16 / f16, 32 of f32), a warp units of
// kUnit = 256 (32 lanes' chunks: every warp load is contiguous), and a team
// of 1, 2, 4 or 8 warps (the fewest that leave a lane at most kTeamChunks
// = 1 chunk, at most kWarps) takes a row: warp k of the team its units k,
// k + team, ... A CTA of kWarps warps holds kWarps / team rows: a row of
// more than 1024 elements is a CTA, narrower rows share one. Each lane
// issues every load of its chunks of x and w at once, as 16-byte vectors,
// before it waits for anything, and keeps them in registers as f32 (at most
// kMaxChunks = 6 chunks: n <= 12288). The sum of squares: each lane adds
// the squares of its chunks' elements in order (chunks in order, from 0); a
// warp adds its lanes by an xor butterfly (offsets 16, 8, 4, 2, 1); one
// barrier, after which every thread adds its row's team partials itself as
// a pairwise tree over 8 leaves, the absent warps' as +0: ((p0 + p1) +
// (p2 + p3)) + ((p4 + p5) + (p6 + p7)). A group (GS a power of two from 8
// to 256) is GS / 8 lanes of one unit: its absmax by xor shuffles among
// them, its scale written by its first lane, each lane's 8 int8 values as
// one 8-byte store. The kernel is a programmatic dependent launch: it is
// scheduled while the kernel before it drains and waits in
// griddepcontrol.wait before it reads anything, which hides the launch
// latency between calls. Rows that are not 16-byte aligned (x or w off 16
// bytes, n no multiple of 8) and other group sizes run the first design
// (rmsnorm_quant_first_kernel): one CTA of 256 threads per row, the row in
// shared memory as f32, thread 0 adding the 8 warps' partials of the
// block-strided sums of squares. The choice is by pointer and shape
// (rows_ok; kernels/rmsnorm_quant.design mirrors it).
//
// Rounding, in both designs as in the reference's XLA oracle: products and
// sums with __fmul_rn / __fadd_rn (no contraction into FMAs), sqrt and
// division with __fsqrt_rn / __fdiv_rn (not the approximate rsqrtf), every
// value divided by its scale (not multiplied by a reciprocal) and rounded
// with rintf (half to even, as jnp.round), then clipped to +-127. Only the
// order of the sum of squares differs from the oracle's, which can move inv
// by an ulp and a value within about 1e-5 of a .5 boundary to the other
// side of it.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 12288;      // the first design's row in shared memory: 48 KB of f32
constexpr int kChunk = 8;         // elements a lane takes at a time
constexpr int kUnit = 32 * kChunk;                     // elements a warp takes at a time
constexpr int kMaxChunks = kMaxN / (kWarps * kUnit);   // chunks a lane holds at most
constexpr int kTeamChunks = 1;    // chunks a lane aims at: the team's size follows

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// 8 elements at p (16-byte aligned) as f32, exactly
__device__ __forceinline__ void load8(const float* p, float (&v)[kChunk]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[kChunk]) {
  const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // a bf16 is the high half of its f32
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
  }
}
__device__ __forceinline__ void load8(const __half* p, float (&v)[kChunk]) {
  const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&u[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// q = round(v / safe) half to even, clipped to +-127, as the low byte of an int
__device__ __forceinline__ unsigned quant_byte(float v, float safe) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(v, safe)), -127.f), 127.f);
  return static_cast<unsigned>(static_cast<int>(r)) & 0xFFu;
}

// The row design (the note at the top). T: dtype of x; W: dtype of w.
template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
rmsnorm_quant_rows_kernel(const T* __restrict__ x,        // (m, n)
                          const W* __restrict__ w,        // (n,)
                          int8_t* __restrict__ q,         // (m, n)
                          float* __restrict__ scales,     // (m, n / gs)
                          int m, int n, int gs, float eps, int team_log2) {
  __shared__ float part[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int team = 1 << team_log2;
  const int k = warp & (team - 1);              // this warp's place in its row's team
  const int r = warp >> team_log2;              // the CTA's row
  const int row = blockIdx.x * (kWarps >> team_log2) + r;
  const int units = (n + kUnit - 1) / kUnit;
  const bool live = row < m;
  const T* xr = x + (size_t)(live ? row : 0) * n;
  // launched as a programmatic dependent: scheduled while the kernel before
  // drains, it reads nothing until that kernel is done
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::);

  // every load of x and w first; chunk c is unit k + c * team
  float v[kMaxChunks][kChunk], wv[kMaxChunks][kChunk];
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int e = (k + c * team) * kUnit + kChunk * lane;
    if (live && e < n) {
      load8(xr + e, v[c]);
      load8(w + e, wv[c]);
    } else {
#pragma unroll
      for (int i = 0; i < kChunk; ++i) v[c][i] = wv[c][i] = 0.f;
    }
  }
  // the sum of squares: the lane's chunks in order, its lanes by an xor
  // butterfly, its team's warps as a pairwise tree of 8 leaves
  float ss = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    if (k + c * team < units) {
#pragma unroll
      for (int i = 0; i < kChunk; ++i) ss = __fadd_rn(ss, __fmul_rn(v[c][i], v[c][i]));
    }
  }
  ss = warp_sum(ss);
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (!live) return;
  float p[kWarps];
#pragma unroll
  for (int j = 0; j < kWarps; ++j) p[j] = j < team ? part[(r << team_log2) + j] : 0.f;
#pragma unroll
  for (int span = 1; span < kWarps; span <<= 1)
#pragma unroll
    for (int j = 0; j < kWarps; j += 2 * span) p[j] = __fadd_rn(p[j], p[j + span]);
  const float tot = p[0];
  const float mean = __fdiv_rn(tot, static_cast<float>(n));
  const float inv = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(mean, eps)));

  // each chunk's normed values, its group's absmax over the group's lanes,
  // the scale by the group's first lane, the int8 values as one 8-byte store
  const int seg = gs / kChunk, ng = n / gs;
  int8_t* qr = q + (size_t)row * n;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    if (k + c * team < units) {
      const int e = (k + c * team) * kUnit + kChunk * lane;
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        v[c][i] = __fmul_rn(__fmul_rn(v[c][i], inv), wv[c][i]);
        amax = fmaxf(amax, fabsf(v[c][i]));
      }
      for (int off = 1; off < seg; off <<= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      const float sc = __fmul_rn(amax, 2.0f / 255.0f);
      const float safe = sc > 0.f ? sc : 1.f;
      if (e < n) {
        unsigned lo = 0u, hi = 0u;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          lo |= quant_byte(v[c][i], safe) << (8 * i);
          hi |= quant_byte(v[c][4 + i], safe) << (8 * i);
        }
        *reinterpret_cast<uint2*>(qr + e) = make_uint2(lo, hi);
        if ((lane & (seg - 1)) == 0) scales[(size_t)row * ng + e / gs] = sc;
      }
    }
  }
}

// The first design (the note at the top). T: dtype of x; W: dtype of w.
template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
rmsnorm_quant_first_kernel(const T* __restrict__ x,        // (m, n)
                           const W* __restrict__ w,        // (n,)
                           int8_t* __restrict__ q,         // (m, n)
                           float* __restrict__ scales,     // (m, n / gs)
                           int n, int gs, float eps) {
  extern __shared__ float row[];                     // (n,)
  __shared__ float part[kWarps];
  __shared__ float inv_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t i = blockIdx.x;
  const T* xr = x + i * n;

  float ss = 0.f;
  for (int e = tid; e < n; e += kThreads) {
    const float v = to_f32(xr[e]);
    row[e] = v;
    ss = __fadd_rn(ss, __fmul_rn(v, v));
  }
  ss = warp_sum(ss);
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (tid == 0) {
    float tot = 0.f;
    for (int j = 0; j < kWarps; ++j) tot = __fadd_rn(tot, part[j]);
    const float mean = __fdiv_rn(tot, static_cast<float>(n));
    inv_s = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(mean, eps)));
  }
  __syncthreads();
  const float inv = inv_s;
  for (int e = tid; e < n; e += kThreads) row[e] = __fmul_rn(__fmul_rn(row[e], inv), to_f32(w[e]));
  __syncthreads();

  const int ng = n / gs;
  int8_t* qr = q + i * n;
  for (int g = warp; g < ng; g += kWarps) {
    const float* gr = row + g * gs;
    float amax = 0.f;
    for (int e = lane; e < gs; e += 32) amax = fmaxf(amax, fabsf(gr[e]));
    amax = warp_max(amax);
    const float sc = __fmul_rn(amax, 2.0f / 255.0f);
    const float safe = sc > 0.f ? sc : 1.f;
    for (int e = lane; e < gs; e += 32) {
      const float r = rintf(__fdiv_rn(gr[e], safe));
      qr[g * gs + e] = static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
    }
    if (lane == 0) scales[i * ng + g] = sc;
  }
}

// whether the row design takes these rows: 16-byte loads of x and w (both
// bases 16-byte aligned, rows of whole chunks) and groups of whole chunks
// within a unit (kernels/rmsnorm_quant.design mirrors it)
bool rows_ok(const void* x, const void* w, int n, int gs) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) & 15) == 0;
  return aligned && n % kChunk == 0 && gs >= kChunk && gs <= kUnit && (gs & (gs - 1)) == 0;
}

// log2 of the warps a row of the row design (kernels/rmsnorm_quant.plan)
int team_log2(int n) {
  const int units = (n + kUnit - 1) / kUnit;
  int lg = 0;
  while ((1 << lg) < kWarps && ((1 << lg) * kTeamChunks) < units) ++lg;
  return lg;
}

// a programmatic dependent launch (Hopper) of ctas CTAs: the grid may be
// scheduled while the kernel before it drains (the kernel waits in
// griddepcontrol.wait before it reads anything)
cudaLaunchConfig_t dependent_launch(int ctas, cudaStream_t stream, cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr->val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Dynamic shared memory of a first-design CTA (kernels/rmsnorm_quant.
// first_smem_bytes mirrors it): the row as f32, at most kMaxN of them (48 KB).
__host__ __device__ inline size_t first_smem_bytes(int n) { return (size_t)n * sizeof(float); }

template <typename T, typename W>
int launch(const void* x, const void* w, void* q, void* scales, int m, int n, int gs, float eps,
           cudaStream_t stream) {
  if (!rows_ok(x, w, n, gs)) {
    rmsnorm_quant_first_kernel<T, W><<<m, kThreads, first_smem_bytes(n), stream>>>(
        static_cast<const T*>(x), static_cast<const W*>(w), static_cast<int8_t*>(q),
        static_cast<float*>(scales), n, gs, eps);
    return static_cast<int>(cudaGetLastError());
  }
  const int lg = team_log2(n);
  const int rows = kWarps >> lg;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = dependent_launch((m + rows - 1) / rows, stream, &attr);
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, rmsnorm_quant_rows_kernel<T, W>, static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<int8_t*>(q), static_cast<float*>(scales), m, n, gs, eps, lg));
}

// the row design's launch with no work: the card's floor for it
__global__ void empty_kernel() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
}

// dtype codes shared with kernels/rmsnorm_quant.py
enum Dtype { kF32 = 0, kBF16 = 1, kF16 = 2 };

template <typename T>
int launch_w(const void* x, const void* w, void* q, void* scales, int m, int n, int gs,
             float eps, int w_dtype, cudaStream_t stream) {
  if (w_dtype == kF32) return launch<T, float>(x, w, q, scales, m, n, gs, eps, stream);
  if (w_dtype == kBF16) return launch<T, __nv_bfloat16>(x, w, q, scales, m, n, gs, eps, stream);
  if (w_dtype == kF16) return launch<T, __half>(x, w, q, scales, m, n, gs, eps, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success); the Python
// wrapper raises on anything else.
extern "C" int rmsnorm_quant(const void* x, const void* w, void* q, void* scales, int m, int n,
                             int gs, float eps, int x_dtype, int w_dtype, int device,
                             void* stream) {
  if (m < 1 || n < 1 || n > kMaxN || gs < 1 || n % gs) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32) return launch_w<float>(x, w, q, scales, m, n, gs, eps, w_dtype, s);
  if (x_dtype == kBF16) return launch_w<__nv_bfloat16>(x, w, q, scales, m, n, gs, eps, w_dtype, s);
  if (x_dtype == kF16) return launch_w<__half>(x, w, q, scales, m, n, gs, eps, w_dtype, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Launches an empty kernel of `ctas` CTAs of kThreads threads as the row
// design launches its kernel (a programmatic dependent): the card's floor
// for such a launch, for timing beside it.
extern "C" int rmsnorm_quant_empty(int ctas, int device, void* stream) {
  if (ctas < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = dependent_launch(ctas, static_cast<cudaStream_t>(stream), &attr);
  return static_cast<int>(cudaLaunchKernelEx(&cfg, empty_kernel));
}
