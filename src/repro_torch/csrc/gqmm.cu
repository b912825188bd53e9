// Group-quantized matrix-vector (GQMV) and matrix-matrix (GQMM) products
// for Hopper (sm_90a) with int8, packed int4, packed int3 or fp8 weights and
// int8 activations, bound to PyTorch through a plain C interface (ctypes,
// see kernels/gqmv.py).
//
// Replaces the TPU kernels of the reference package (repro/kernels/gqmv.py):
//   gqmv_int8 <- gqmv_pallas       gqmm_int8 <- gqmm_pallas          (B1, B3)
//   gqmv_int4 <- gqmv_int4_pallas  gqmm_int4 <- gqmm_int4_pallas     (B5)
//   gqmv_int3 <- gqmv_int3_pallas  gqmm_int3 <- gqmm_int3_pallas     (B6)
//   gqmv_fp8  <- gqmv_fp8_pallas   gqmm_fp8  <- gqmm_fp8_pallas      (B7)
// The six Pallas kernels after B1/B3 share B1/B3's two compute bodies
// (_gqmv_compute, _gqmm_compute) behind a stage that unpacks the weights,
// and so do these: one kernel template, one weight loader per format.
//
// What they compute (paper Alg. 1): for every output row i and batch row b,
// the products of each quantization group (GS columns) are summed, the
// group sum is scaled in f32, and the scaled sums are added across groups
// in f32. The integer formats sum int8 x int8 products into an exact int32;
// fp8 weights (e4m3) times int8 activations are summed in f32, as the
// reference's float branch does. The scaling follows each format's plain
// version (kernels/ref.py):
//   int8 GQMV:           out[i]    = sum_g  s_g * (ws[i,g] * xs[g])
//   int8 GQMM:           out[b, i] = sum_g (s_g *  ws[i,g]) * xs[b,g]
//   int4/int3/fp8 GQMV:  out[i]    = sum_g  s_g * (ws[i,g] * xs[g])
//   int4/int3/fp8 GQMM:  out[b, i] = sum_g (s_g *  xs[b,g]) * ws[i,g]
//
// Bound on the card: at the batch sizes of decoding (b <= 8) every weight
// byte is used for 2*b*(8/bits) operations, far below the ~590 operations
// per byte at which an H100's compute rather than its 3.35 TB/s of HBM
// would be the limit. All eight kernels are HBM-bound there: the least time
// is the weight-plus-scale bytes over the memory rate, so int4 and int3 can
// at best take 0.52x and 0.40x of int8's time on TinyLlama's projections.
//
// Design (first, simple version). The TPU kernel's sequential n-block grid
// axis, which carries the sum in VMEM, does not carry over: here one warp
// owns one output row for a tile of BB batch rows and walks the whole
// contraction itself, so no sum crosses blocks and each block writes its
// own output rows. Each lane takes 16 logical weights per step (16 bytes of
// int8 or fp8, 8 of int4, 6 of int3: warp loads of 512, 256 or 192
// contiguous bytes), unpacks them in registers and dots them with its 16
// activation bytes. A group is GS/16 lanes, an aligned power-of-two
// segment, whose partial sums are added with xor shuffles before the
// segment's first lane scales the group sum and keeps a per-lane f32 sum; a
// warp shuffle reduction adds the lanes at the end. __fmul_rn and __fadd_rn
// keep nvcc from contracting the scaling into an FMA, so each scaled term
// of an integer format is bit-equal to the plain version's; only the order
// of the f32 sum across groups differs (and, for fp8, the order within a
// group). Tensor cores for large b and TMA/cp.async pipelining are later
// work.
//
// Unpacking. int4: the low nibble holds the even element. The four low
// nibbles of a 32-bit word (elements 0, 2, 4, 6) and the four high ones
// (1, 3, 5, 7) are sign-extended in place with one per-byte subtraction,
// (v ^ 8) - 8, and dotted with the even and odd activation bytes picked by
// __byte_perm: the integer group sum is exact in any order. int3: eight
// 3-bit fields per little-endian 24-bit word (element i in bits 3i..3i+2);
// a lane's 6 bytes are two words, read as three 16-bit loads (an int3 row
// is 3n/8 bytes, so a lane's chunk is only 2-byte aligned), and each run of
// four fields is spread into the four bytes of a word and sign-extended as
// (v ^ 4) - 4. fp8: pairs of e4m3 values are converted to half2 and then
// float2 (both exact), and multiplied by the activation as f32 (exact: 4 x
// 7 significant bits), so the only roundings are the f32 sums.

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;    // output rows per block, one warp each
constexpr int kChunk = 16;   // logical weights (and activation bytes) per lane per step

__device__ __forceinline__ float to_float(int s) { return __int2float_rn(s); }  // exact: |s| < 2^24
__device__ __forceinline__ float to_float(float s) { return s; }

// Four int8 weights per word, in the order of the activation bytes they meet.
struct Int8Weights {
  using Sum = int;
  static constexpr int kBytes = 16;
  int4 w;
  __device__ __forceinline__ void load(const uint8_t* row, int c) {
    w = __ldg(reinterpret_cast<const int4*>(row) + c);
  }
  __device__ __forceinline__ void clear() { w = make_int4(0, 0, 0, 0); }
  __device__ __forceinline__ int dot(const int4 x) const {
    int s = 0;
    s = __dp4a(w.x, x.x, s);
    s = __dp4a(w.y, x.y, s);
    s = __dp4a(w.z, x.z, s);
    s = __dp4a(w.w, x.w, s);
    return s;
  }
};

// four nibbles, one in the low half of each byte -> four sign-extended int8
__device__ __forceinline__ int sext4(unsigned v) {
  return static_cast<int>(__vsub4(v ^ 0x08080808u, 0x08080808u));
}

struct Int4Weights {
  using Sum = int;
  static constexpr int kBytes = 8;
  int even[2], odd[2];  // word h: elements 8h+{0,2,4,6} and 8h+{1,3,5,7}
  __device__ __forceinline__ void load(const uint8_t* row, int c) {
    const uint2 p = __ldg(reinterpret_cast<const uint2*>(row) + c);
    even[0] = sext4(p.x & 0x0F0F0F0Fu);
    odd[0] = sext4((p.x >> 4) & 0x0F0F0F0Fu);
    even[1] = sext4(p.y & 0x0F0F0F0Fu);
    odd[1] = sext4((p.y >> 4) & 0x0F0F0F0Fu);
  }
  __device__ __forceinline__ void clear() { even[0] = even[1] = odd[0] = odd[1] = 0; }
  __device__ __forceinline__ int dot(const int4 x) const {
    int s = 0;
    s = __dp4a(even[0], static_cast<int>(__byte_perm(x.x, x.y, 0x6420)), s);
    s = __dp4a(odd[0], static_cast<int>(__byte_perm(x.x, x.y, 0x7531)), s);
    s = __dp4a(even[1], static_cast<int>(__byte_perm(x.z, x.w, 0x6420)), s);
    s = __dp4a(odd[1], static_cast<int>(__byte_perm(x.z, x.w, 0x7531)), s);
    return s;
  }
};

// the four 3-bit fields in bits 0..11 of w -> four sign-extended int8
__device__ __forceinline__ int sext3(unsigned w) {
  const unsigned spread = (w & 0x7u) | ((w << 5) & 0x700u) | ((w << 10) & 0x70000u) |
                          ((w << 15) & 0x7000000u);
  return static_cast<int>(__vsub4(spread ^ 0x04040404u, 0x04040404u));
}

struct Int3Weights {
  using Sum = int;
  static constexpr int kBytes = 6;
  int w[4];  // elements 4k..4k+3 in word k
  __device__ __forceinline__ void load(const uint8_t* row, int c) {
    const unsigned short* p = reinterpret_cast<const unsigned short*>(row) + 3 * c;
    const unsigned u0 = __ldg(p), u1 = __ldg(p + 1), u2 = __ldg(p + 2);
    const unsigned lo = u0 | ((u1 & 0xFFu) << 16);  // elements 0..7
    const unsigned hi = (u1 >> 8) | (u2 << 8);      // elements 8..15
    w[0] = sext3(lo);
    w[1] = sext3(lo >> 12);
    w[2] = sext3(hi);
    w[3] = sext3(hi >> 12);
  }
  __device__ __forceinline__ void clear() { w[0] = w[1] = w[2] = w[3] = 0; }
  __device__ __forceinline__ int dot(const int4 x) const {
    int s = 0;
    s = __dp4a(w[0], x.x, s);
    s = __dp4a(w[1], x.y, s);
    s = __dp4a(w[2], x.z, s);
    s = __dp4a(w[3], x.w, s);
    return s;
  }
};

// two e4m3 values (low byte first) -> two floats, exactly
__device__ __forceinline__ float2 fp8x2_to_float2(unsigned pair) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(pair & 0xFFFFu), __NV_E4M3);
  return __half22float2(__half2(h));
}

__device__ __forceinline__ float fp8_word_dot(unsigned w, int x, float s) {
  const float2 a = fp8x2_to_float2(w);
  const float2 b = fp8x2_to_float2(w >> 16);
  s = __fadd_rn(s, __fmul_rn(a.x, static_cast<float>(static_cast<int8_t>(x))));
  s = __fadd_rn(s, __fmul_rn(a.y, static_cast<float>(static_cast<int8_t>(x >> 8))));
  s = __fadd_rn(s, __fmul_rn(b.x, static_cast<float>(static_cast<int8_t>(x >> 16))));
  s = __fadd_rn(s, __fmul_rn(b.y, static_cast<float>(static_cast<int8_t>(x >> 24))));
  return s;
}

struct Fp8Weights {
  using Sum = float;
  static constexpr int kBytes = 16;
  int4 w;
  __device__ __forceinline__ void load(const uint8_t* row, int c) {
    w = __ldg(reinterpret_cast<const int4*>(row) + c);
  }
  __device__ __forceinline__ void clear() { w = make_int4(0, 0, 0, 0); }
  __device__ __forceinline__ float dot(const int4 x) const {
    float s = 0.f;
    s = fp8_word_dot(static_cast<unsigned>(w.x), x.x, s);
    s = fp8_word_dot(static_cast<unsigned>(w.y), x.y, s);
    s = fp8_word_dot(static_cast<unsigned>(w.z), x.z, s);
    s = fp8_word_dot(static_cast<unsigned>(w.w), x.w, s);
    return s;
  }
};

// kGqmv: term = s * (ws * xs); else kXsFirst: (s * xs) * ws; else (s * ws) * xs
template <class W, int BB, bool kGqmv, bool kXsFirst>
__global__ void __launch_bounds__(kWarps * 32)
gqmm_kernel(const uint8_t* __restrict__ wq, const float* __restrict__ ws,
            const int8_t* __restrict__ xq, const float* __restrict__ xs,
            float* __restrict__ out, int b, int m, int n, int gs_log2) {
  using Sum = typename W::Sum;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int b0 = blockIdx.y * BB;
  if (row >= m) return;  // warp-uniform: the whole warp leaves together

  const int ng = n >> gs_log2;
  const int nchunks = n / kChunk;
  const int seg = (1 << gs_log2) / kChunk;  // lanes per group: 1..16
  const uint8_t* wrow = wq + (size_t)row * ((size_t)nchunks * W::kBytes);
  const float* wsrow = ws + (size_t)row * ng;

  float acc[BB];
#pragma unroll
  for (int j = 0; j < BB; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < nchunks; c0 += 32) {
    const int c = c0 + lane;
    const bool live = c < nchunks;  // n is whole groups: dead lanes form whole segments
    W w;
    if (live) w.load(wrow, c);
    else w.clear();
    const int g = (c * kChunk) >> gs_log2;
    const bool leader = live && (c & (seg - 1)) == 0;
    const float wscale = leader ? __ldg(wsrow + g) : 0.f;
#pragma unroll
    for (int j = 0; j < BB; ++j) {
      const int bj = b0 + j;
      Sum s = 0;
      if (live && bj < b) {
        s = w.dot(__ldg(reinterpret_cast<const int4*>(xq + (size_t)bj * n) + c));
      }
      for (int off = 1; off < seg; off <<= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (leader && bj < b) {
        const float xscale = __ldg(xs + (size_t)bj * ng + g);
        const float sf = to_float(s);
        const float term = kGqmv     ? __fmul_rn(sf, __fmul_rn(wscale, xscale))
                           : kXsFirst ? __fmul_rn(__fmul_rn(sf, xscale), wscale)
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

template <class W, int BB, bool kGqmv, bool kXsFirst>
int launch(const void* wq, const void* ws, const void* xq, const void* xs, void* out,
           int b, int m, int n, int gs_log2, cudaStream_t stream) {
  const dim3 grid((m + kWarps - 1) / kWarps, (b + BB - 1) / BB);
  gqmm_kernel<W, BB, kGqmv, kXsFirst><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const uint8_t*>(wq), static_cast<const float*>(ws),
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<float*>(out), b, m, n, gs_log2);
  return static_cast<int>(cudaGetLastError());
}

bool bad_args(int b, int m, int n, int gs_log2) {
  return gs_log2 < 0 || b < 1 || m < 1 || n < 1 || (n & ((1 << gs_log2) - 1)) != 0 ||
         (b + 7) / 8 > 65535;
}

template <class W>
int run_gqmv(const void* wq, const void* ws, const void* xq, const void* xs, void* out,
             int m, int n, int group_size, int device, void* stream) {
  const int gs_log2 = log2_group(group_size);
  if (bad_args(1, m, n, gs_log2)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch<W, 1, true, false>(wq, ws, xq, xs, out, 1, m, n, gs_log2,
                                   static_cast<cudaStream_t>(stream));
}

template <class W, bool kXsFirst>
int run_gqmm(const void* wq, const void* ws, const void* xq, const void* xs, void* out,
             int b, int m, int n, int group_size, int device, void* stream) {
  const int gs_log2 = log2_group(group_size);
  if (bad_args(b, m, n, gs_log2)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b == 1) return launch<W, 1, false, kXsFirst>(wq, ws, xq, xs, out, b, m, n, gs_log2, s);
  if (b <= 4) return launch<W, 4, false, kXsFirst>(wq, ws, xq, xs, out, b, m, n, gs_log2, s);
  return launch<W, 8, false, kXsFirst>(wq, ws, xq, xs, out, b, m, n, gs_log2, s);
}

}  // namespace

// Every entry point returns cudaGetLastError() after the launch (0 on
// success); the Python wrapper raises on anything else. wq is the format's
// storage: int8 (m, n), int8 (m, n/2), uint8 (m, 3n/8) or e4m3 (m, n).
#define GQMM_ENTRY_POINTS(FMT, W, XS_FIRST)                                                  \
  extern "C" int gqmv_##FMT(const void* wq, const void* ws, const void* xq, const void* xs, \
                            void* out, int m, int n, int group_size, int device,            \
                            void* stream) {                                                 \
    return run_gqmv<W>(wq, ws, xq, xs, out, m, n, group_size, device, stream);              \
  }                                                                                         \
  extern "C" int gqmm_##FMT(const void* wq, const void* ws, const void* xq, const void* xs, \
                            void* out, int b, int m, int n, int group_size, int device,     \
                            void* stream) {                                                 \
    return run_gqmm<W, XS_FIRST>(wq, ws, xq, xs, out, b, m, n, group_size, device, stream); \
  }

GQMM_ENTRY_POINTS(int8, Int8Weights, false)
GQMM_ENTRY_POINTS(int4, Int4Weights, true)
GQMM_ENTRY_POINTS(int3, Int3Weights, true)
GQMM_ENTRY_POINTS(fp8, Fp8Weights, true)
