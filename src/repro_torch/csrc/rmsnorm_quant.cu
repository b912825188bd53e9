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
// 3.35 TB/s.
//
// Design. One CTA of 256 threads per row: the row is read once from device
// memory into shared memory as f32 (n <= 12288 floats) while each thread
// sums its squares; a block reduction gives inv; the normed row is written
// back to shared memory; then each warp takes whole groups, finds the
// group's absmax with shuffles, and writes the group's int8 values and its
// scale. Every rounding follows IEEE f32 as the reference's XLA oracle
// does: products and sums with __fmul_rn / __fadd_rn (no contraction into
// FMAs), sqrt and division with __fsqrt_rn / __fdiv_rn (not the approximate
// rsqrtf), the value divided by its scale (not multiplied by a reciprocal)
// and rounded with rintf (half to even, as jnp.round). Only the order of the
// sum of squares differs from the oracle's, which can move inv by an ulp and
// a value within about 1e-5 of a .5 boundary to the other side of it.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 12288;      // the row in shared memory: 48 KB of f32

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

// T: dtype of x; W: dtype of w.
template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
rmsnorm_quant_kernel(const T* __restrict__ x,        // (m, n)
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

template <typename T, typename W>
int launch(const void* x, const void* w, void* q, void* scales, int m, int n, int gs, float eps,
           cudaStream_t stream) {
  rmsnorm_quant_kernel<T, W><<<m, kThreads, n * sizeof(float), stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<int8_t*>(q),
      static_cast<float*>(scales), n, gs, eps);
  return static_cast<int>(cudaGetLastError());
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
