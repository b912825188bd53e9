// W8A8 group-quantized matrix-vector (GQMV) and matrix-matrix (GQMM)
// products for Hopper (sm_90a), bound to PyTorch through a plain C
// interface (ctypes, see kernels/gqmv.py).
//
// Replaces the TPU kernels of the reference package:
//   gqmv_int8  <- repro/kernels/gqmv.py gqmv_pallas (_gqmv_kernel -> _gqmv_compute)
//   gqmm_int8  <- repro/kernels/gqmv.py gqmm_pallas (_gqmm_kernel -> _gqmm_compute)
//
// What they compute (paper Alg. 1): for every output row i and batch row b,
// the int8 x int8 products of each quantization group (GS columns) are
// summed into an exact int32, the group sum is scaled in f32, and the scaled
// sums are added across groups in f32:
//   GQMV:  out[i]    = sum_g  s_g * (ws[i,g] * xs[g])       (_gqmv_compute)
//   GQMM:  out[b, i] = sum_g (s_g *  ws[i,g]) * xs[b,g]     (ref.gqmm_ref)
//
// Bound on the card: at the batch sizes of decoding (b <= 8) every weight
// byte is used for 2*b operations, far below the ~590 int8 operations per
// byte at which an H100's dp4a/tensor rate rather than its 3.35 TB/s of HBM
// would be the limit. Both kernels are HBM-bound: the least time is the
// weight-plus-scale bytes over the memory rate.
//
// Design (first, simple version). The TPU kernel's sequential n-block grid
// axis, which carries the sum in VMEM, does not carry over: here one warp
// owns one output row for a tile of BB batch rows and walks the whole
// contraction itself, so no sum crosses blocks and each block writes its
// own output rows. Each lane loads 16 contiguous weight bytes per step
// (coalesced 512-byte warp loads; rows are 16-byte aligned because n is a
// multiple of GS >= 16), forms the int8 dot with four __dp4a, and the lanes
// of one group (GS/16 of them, an aligned power-of-two segment) add their
// int32 partials with xor shuffles, so every group sum is exact before it
// is scaled. The segment's first lane scales it and keeps a per-lane f32
// sum; a warp shuffle reduction adds the lanes at the end. __fmul_rn and
// __fadd_rn keep nvcc from contracting the scaling into an FMA, so each
// scaled term is bit-equal to the plain version's; only the order of the
// f32 sum across groups differs. The weight row is read once per batch
// tile and activations come through the read-only cache. Tensor cores
// (s8 mma/wgmma) for large b and TMA/cp.async pipelining are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;    // output rows per block, one warp each
constexpr int kChunk = 16;   // bytes one lane loads per step

template <int BB, bool kGqmv>
__global__ void __launch_bounds__(kWarps * 32)
gqmm_int8_kernel(const int8_t* __restrict__ wq, const float* __restrict__ ws,
                 const int8_t* __restrict__ xq, const float* __restrict__ xs,
                 float* __restrict__ out, int b, int m, int n, int gs_log2) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int b0 = blockIdx.y * BB;
  if (row >= m) return;  // warp-uniform: the whole warp leaves together

  const int ng = n >> gs_log2;
  const int nchunks = n / kChunk;
  const int seg = (1 << gs_log2) / kChunk;  // lanes per group: 1..16
  const int4* wrow = reinterpret_cast<const int4*>(wq + (size_t)row * n);
  const float* wsrow = ws + (size_t)row * ng;

  float acc[BB];
#pragma unroll
  for (int j = 0; j < BB; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < nchunks; c0 += 32) {
    const int c = c0 + lane;
    const bool live = c < nchunks;  // n is whole groups: dead lanes form whole segments
    const int4 w = live ? __ldg(wrow + c) : make_int4(0, 0, 0, 0);
    const int g = (c * kChunk) >> gs_log2;
    const bool leader = live && (c & (seg - 1)) == 0;
    const float wscale = leader ? __ldg(wsrow + g) : 0.f;
#pragma unroll
    for (int j = 0; j < BB; ++j) {
      const int bj = b0 + j;
      int s = 0;
      if (live && bj < b) {
        const int4 x = __ldg(reinterpret_cast<const int4*>(xq + (size_t)bj * n) + c);
        s = __dp4a(w.x, x.x, s);
        s = __dp4a(w.y, x.y, s);
        s = __dp4a(w.z, x.z, s);
        s = __dp4a(w.w, x.w, s);
      }
      for (int off = 1; off < seg; off <<= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (leader && bj < b) {
        const float xscale = __ldg(xs + (size_t)bj * ng + g);
        const float sf = __int2float_rn(s);  // exact: |s| <= 127^2 * 256 < 2^24
        const float term = kGqmv ? __fmul_rn(sf, __fmul_rn(wscale, xscale))
                                 : __fmul_rn(__fmul_rn(sf, wscale), xscale);
        acc[j] = __fadd_rn(acc[j], term);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < BB; ++j) {
    float v = acc[j];
    for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0 && b0 + j < b) out[(size_t)(b0 + j) * m + row] = v;
  }
}

int log2_group(int group_size) {
  for (int k = 4; k <= 8; ++k)
    if (group_size == (1 << k)) return k;
  return -1;
}

template <int BB, bool kGqmv>
int launch(const void* wq, const void* ws, const void* xq, const void* xs, void* out,
           int b, int m, int n, int gs_log2, cudaStream_t stream) {
  const dim3 grid((m + kWarps - 1) / kWarps, (b + BB - 1) / BB);
  gqmm_int8_kernel<BB, kGqmv><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const int8_t*>(wq), static_cast<const float*>(ws),
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<float*>(out), b, m, n, gs_log2);
  return static_cast<int>(cudaGetLastError());
}

bool bad_args(int b, int m, int n, int gs_log2) {
  return gs_log2 < 0 || b < 1 || m < 1 || n < 1 || (n & ((1 << gs_log2) - 1)) != 0 ||
         (b + 7) / 8 > 65535;
}

}  // namespace

// Both entry points return cudaGetLastError() after the launch (0 on
// success); the Python wrapper raises on anything else.
extern "C" int gqmv_int8(const void* wq, const void* ws, const void* xq, const void* xs,
                         void* out, int m, int n, int group_size, int device, void* stream) {
  const int gs_log2 = log2_group(group_size);
  if (bad_args(1, m, n, gs_log2)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch<1, true>(wq, ws, xq, xs, out, 1, m, n, gs_log2,
                         static_cast<cudaStream_t>(stream));
}

extern "C" int gqmm_int8(const void* wq, const void* ws, const void* xq, const void* xs,
                         void* out, int b, int m, int n, int group_size, int device,
                         void* stream) {
  const int gs_log2 = log2_group(group_size);
  if (bad_args(b, m, n, gs_log2)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b == 1) return launch<1, false>(wq, ws, xq, xs, out, b, m, n, gs_log2, s);
  if (b <= 4) return launch<4, false>(wq, ws, xq, xs, out, b, m, n, gs_log2, s);
  return launch<8, false>(wq, ws, xq, xs, out, b, m, n, gs_log2, s);
}
