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
// and so do these: each design is a kernel template over a weight loader
// per format (the first design for rows the others cannot take; the
// streamed GQMV design for int4 and int3, with a tensor-core variant for
// fp8 and int8; GQMM's two tensor-core designs for every format).
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
// At a prefill's b = 256 the products are 2*b*m*n int8 operations against
// m*n weight bytes plus a 4*b*m-byte f32 output: bytes and int8 tensor-core
// operations bound them about equally (wo 2.1 us, classifier 29.8 us).
//
// GQMV of every format on rows the streamed designs cannot take, and
// int4 / int3 GQMM on rows the large design's ring cannot stream: the
// first, simple design (gqmm_kernel). The TPU kernel's sequential n-block
// grid axis, which carries the sum in VMEM, does not carry over: here one
// warp owns one output row for a tile of BB <= 8 batch rows and walks the
// whole contraction itself, so no sum crosses blocks and each block writes
// its own output rows. Each lane takes 16 logical weights per step (16
// bytes of int8 or fp8, 8 of int4, 6 of int3: warp loads of 512, 256 or
// 192 contiguous bytes), unpacks them in registers and dots them with its
// 16 activation bytes (__dp4a). A group is GS/16 lanes, an aligned
// power-of-two segment, whose partial sums are added with xor shuffles
// before the segment's first lane scales the group sum and keeps a per-lane
// f32 sum; a warp shuffle reduction adds the lanes at the end (at b = 1
// and GS 256: the even groups left to right on lane 0, the odd ones on lane
// 16, then the two). At b = 1 it keeps one 16-byte load (6 bytes for int3)
// in flight a lane behind a chain of global activation and scale loads and
// a shuffle tree: a few KB in flight an SM where HBM wants 17-20 KB; a
// 2048-wide row is 4 such steps a warp, w2's 5632 11 (int8: 6.0 us for wo
// against a 1.3 us bound on an H100 80GB HBM3 at 700 W; it reached 77 % of
// its bound only at the classifier, by 8,000 CTAs of occupancy).
//
// GQMV of int4 (B5, gqmv_int4_pallas) and int3 (B6, gqmv_int3_pallas)
// weights: the streamed design (gqmv_stream_kernel, a template over a
// weight loader: StreamInt4, StreamInt3). Bound: the weight bytes. A lane
// takes a chunk of 128 logical weights of one row, 64 bytes of int4 or 48
// of int3, as four or three 16-byte loads (a warp step moves 2,048 or 1,536
// bytes), issued with the chunk's weight scales before the lane waits for
// anything; a half-warp of 16 lanes takes a piece of 16 chunks of one row
// (a 2048-wide row, 1,024 or 768 bytes, is one piece: a warp covers two
// rows); a CTA of 8 warps takes 16 pieces: 16 rows of one piece, or, for
// longer rows (w2: 5632 wide, 44 chunks, 3 pieces), 16 / pieces rows whose
// pieces sit in different half-warps and are added through shared memory.
// One launch a call. The CTA stages the activation vector (n int8 bytes,
// each chunk's eight 16-byte vectors XOR-swizzled by the chunk so that a
// piece's 16 lanes read 8 bank groups) and its n / GS scales by cp.async
// while the weights are in flight. Each lane unpacks its chunk in
// registers into 32 words of four int8 in element order (int4:
// unpack_int4_word, the nibbles sign-extended and interleaved by
// __byte_perm; int3: sext3 on four 24-bit words a 12 bytes) and forms
// exact int32 sums with __dp4a. The order of the f32 sums, fixed: a lane
// adds its chunk's group terms s * (ws * xs) left to right (GS <= 128; at
// GS 256 a group is the chunks of lanes 2j, 2j + 1, whose int32 sums are
// added and scaled on the even lane); a piece's 16 lanes are added by an
// xor butterfly (a pairwise tree in lane order); a row's pieces left to
// right. What bounds it: about 4 us a call of fixed cost (launch, the
// first loads' latency, the staging barrier) plus the bytes at ~2 TB/s:
// each CTA issues its loads once and then computes, so an SM's bytes in
// flight come and go with its CTAs.
//
// GQMV of fp8 weights (B7, gqmv_fp8_pallas) and of int8 weights (B1,
// gqmv_pallas): the streamed design in blocks of 16 rows
// (gqmv_stream_block_kernel, loaders StreamFp8, StreamInt8). Bound: the
// weight bytes. fp8 on the f16 tensor cores: a lane's f32 dot on the CUDA
// cores, with the activations staged as f32, pays for each e4m3 byte a
// conversion and an FMA: in the GS-256 kernel 64 F2FP (e4m3x2 to f16x2),
// 128 HADD2.F32 and 128 FFMA for 128 weights with the hardware cvt, and 2-3
// integer instructions a byte in place of the F2FP and HADD2 with a decode
// that moves the byte's bits into an f32 as its value x 2^-120 (cuobjdump
// -sass; tests/time_torch_kernels.py --sass), and its compute outlasted its
// loads: 32.7 (cvt) and 33.0 (integer decode) us at the classifier against
// the first design's 31.1, with the next rows prefetched (H100 80GB HBM3,
// 700 W). Here e4m3 pairs convert to f16x2 (one cvt a pair) for mma.sync
// m16n8k16, whose B operand is the activations as f16 (exact: |x| <= 127)
// in all 8 columns: a 16-byte vector of a row costs 8 cvts and 4 mmas.
// int8 needs no conversion: a lane's 16 bytes of a row are four __dp4a with
// its 16 activation bytes (staged as int8 by cp.async), and a group's lanes
// t are added by a 2-step xor butterfly, exact int32 (m16n8k32 s8 mmas in
// the same partition, the accumulator holding the group sum, timed 1-3 %
// slower at TinyLlama's projections, H100 80GB HBM3, 700 W). A block is 16
// rows (an mma's); warp w of a CTA takes its 256-column slices w, w + 8,
// ...; lane (gid, t) loads 16 bytes of rows gid and gid + 8 at columns
// 16t .. 16t + 15 of each of a slice's four 64-column spans (eight 16-byte
// loads, 128 bytes; a warp load is 8 rows x 64 contiguous bytes) with the
// slice's weight scales. fp8: mma j of a span takes the lane's columns
// 4j .. 4j + 3 as k-slots 2t, 2t + 1, 2t + 8, 2t + 9 of both operands, so a
// k16 step covers columns {64p + 16t + 4j + b}. A span is whole groups at
// GS >= 64, and at GS 16 and 32 each group of a span is summed with the
// other groups' lanes masked (fp8: their activations zeroed; int8: their
// dp4a sums). Long rows are split across warps, never walked by one: w2's
// 5632 columns are 22 slices, 3 or 2 a warp of the CTA. The grid holds as
// many CTAs as the card runs at once (the occupancy API; two an SM, fp8 124
// registers, int8 about 100), cut so that every CTA but the last takes
// ceil(blocks / that) blocks (w13's 704 blocks over 264 CTAs left a third
// of them a block more); a CTA stages the activations (fp8 as f16, int8 as
// int8) and their scales once and takes blocks blockIdx.x, blockIdx.x +
// gridDim.x, ...; each slice (the next block's first, at a block's last) is
// requested before the one before is computed, so an SM keeps its next
// bytes in flight while it computes. The kernel is a programmatic dependent
// launch (cudaLaunchKernelEx): its first weight loads are issued before
// griddepcontrol.wait, while the kernel before it drains, and everything
// else after it, so GQMV's weights must not be the output of the kernel
// launched right before it (model weights, quantized once, never are).
// What bounds it: without the dependent launch, about 4 us a call of fixed
// cost (launch, the first loads' latency, the staging barrier) plus the
// bytes at ~2.5-2.8 TB/s; the dependent launch hides most of the fixed
// cost between consecutive calls. (Weights brought to shared memory by
// bulk copies of 2 KB row pieces, three stages a CTA, timed slower: 28.8
// against 26.6 us at the classifier.) The order of the f32 sums: a group's
// sum is exact (int8: s32) or accumulates its k16 steps in order in the
// mma's f32 accumulator (fp8: within a step the tensor core's own order,
// each product exact); a slice's group terms s * (ws * xs) left to right;
// a row's slices left to right, through shared memory.
// Every format's GQMV runs its streamed design where the rows are 16-byte
// aligned and n is a multiple of 128 (at most 32768: 16 pieces); other
// rows (a stacked leaf's slice off 16 bytes, GS 32 at n 1056, wider rows)
// run the first design, chosen by pointer and shape (run_gqmv_stream,
// mirrored by kernels/gqmv.gqmv_design).
//
// GQMM, every format: two designs on the tensor cores, chosen by b
// (run_gqmm_tc): int8 (B3, gqmm_pallas), int4 (B5, gqmm_int4_pallas) and
// int3 (B6, gqmm_int3_pallas) on the int8 tensor cores, the packed formats
// unpacked to int8 on the way (a loader each: TcInt8, TcInt4, TcInt3); fp8
// (B7, gqmm_fp8_pallas) on the f16 tensor cores (TcFp8): e4m3 and int8
// values are exact in f16 and their products exact in f32, so the group
// sums differ from the plain version's only in the order of the f32
// additions, and the card's rate for them is bf16's.
// - Small, b <= kSmallMaxB (decode; gqmm_small_kernel). Bound: the weight
//   bytes. The first design re-read each weight row for every 8 batch rows,
//   re-read the activations per warp-row, kept one 16-byte load a lane in
//   flight behind a chain of dp4a, shuffles and scale loads per batch row,
//   and ran 4-iteration warps on small grids. Here a CTA of 8 warps owns 16
//   weight rows for every batch row; the activations (b <= 16 rows), their
//   scales and the 16 rows' weight scales are staged in shared memory once
//   per CTA by cp.async, behind the first weight loads. The warps take the
//   contraction's units of whole groups (at GS 256 one group: 4 k-spans of
//   64 columns) in rounds, one unit each; each lane keeps up to 16 16-byte
//   weight loads in flight (its unit's k-spans of two rows, and the next
//   round's, double-buffered in registers) and feeds them straight to
//   m16n8k32 mmas as A fragments, so a group's int32 sum is formed by the
//   tensor core with no shuffle, and the scales are applied once per group.
//   int4 lanes fetch 8 bytes for their 16 weights and unpack them into the
//   same four int8 words. fp8 lanes fetch 16 bytes as int8's do and convert
//   them in registers into m16n8k16 f16 A fragments (four mmas a k-span);
//   the int8 activations stay staged as int8 (f16 would double the staging:
//   184 KB for w2's rows at b = 16) and are converted as they are read.
//   Each round's scaled terms pass through shared memory to one thread per
//   output, which adds them in group order. kSmallMaxB: see gqmv.py's
//   SMALL_MAX_B, set from phase-2 times of both designs.
// - Large, b > kSmallMaxB (prefill; gqmm_mma_kernel). Bound: bytes and
//   operations alike. A CTA owns 128 (or, where that leaves SMs idle, 64)
//   weight rows x 64 batch rows, one warpgroup a 64 x 64 block. A 5-stage
//   ring brings 128-byte slices of both: the TMA unit loads each tile with
//   one instruction (2-D tensor maps; zeros past m, b and n; the 128-byte
//   swizzle) onto an mbarrier, cp.async the slice's scales. At GS >= 32
//   wgmma m64n64k32 s8 reads both tiles from shared memory (the X and W
//   tiles are both K-major, as int8 wgmma requires, so nothing is
//   transposed); at GS 16, where a group is half a k-step, ldmatrix feeds
//   mma.sync m16n8k32 with the other half's weights zeroed. After a group's
//   GS/32 k-steps the s32 sums are converted, scaled and added into f32
//   sums. int3 and int4 tiles arrive packed (48 and 64 bytes a row a slice)
//   and are unpacked to int8 in the same swizzle (their rows that are not
//   16-byte aligned, or n no multiple of 128, run the first design
//   instead). fp8 (m64n64k16 f16, f32 sums, at every GS: a k16-step is whole
//   groups even at GS 16): each warp converts its rows' e4m3 bytes into
//   wgmma's A fragments in registers, 8 k16-steps a slice; the int8
//   activation tile is converted once a slice into an f16 tile (two atoms of
//   128-byte rows, the same swizzle) that wgmma reads as B; after a group's
//   GS/16 k-steps the f32 sums are scaled and added as the integer sums are.
//   What bounds it now: the tiles are re-read from L2 by every CTA
//   that shares them (64 x 64 blocks: (1/64 + 1/64) of the product's
//   operations in bytes), ~32 MB at wo and ~380 MB at the classifier for
//   b = 256, against 4 and 65 MB of weights. Larger tiles or TMA multicast
//   across a cluster are the next step. (16-byte cp.async from every
//   thread held each SM to ~16 KB in flight; mma.sync s8 ran at ~200 TOPS.)
// Both keep the plain versions' arithmetic: exact int32 group sums and each
// scaled term bit-equal (__fmul_rn, no contraction; int8 (s*ws)*xs, int4
// and int3 (s*xs)*ws); fp8's group sums are f32 in the tensor core's order,
// each term (s*xs)*ws. The f32 sum across groups runs in one order in both
// designs, the first design's at GS 256: the even groups left to right, the
// odd groups left to right, then the two added. (The 2-layer int8 golden
// stays token-exact on the card with it; with one left-to-right sum a .5
// activation tie flips.)
//
// __fmul_rn and __fadd_rn keep nvcc from contracting the scaling into an
// FMA, so each scaled term of an integer format is bit-equal to the plain
// version's; only the order of the f32 sum across groups differs (and, for
// fp8, the order within a group).
//
// Unpacking. int4: the low nibble holds the even element. The four low
// nibbles of a 32-bit word (elements 0, 2, 4, 6) and the four high ones
// (1, 3, 5, 7) are sign-extended in place with one per-byte subtraction,
// (v ^ 8) - 8, and dotted with the even and odd activation bytes picked by
// __byte_perm: the integer group sum is exact in any order. The tensor-core
// designs interleave the two back into element order with __byte_perm
// (unpack_int4_word), the order of the activation bytes. int3: eight
// 3-bit fields per little-endian 24-bit word (element i in bits 3i..3i+2);
// a lane's 6 bytes are two words, read as three 16-bit loads (an int3 row
// is 3n/8 bytes, so a lane's chunk is only 2-byte aligned), and each run of
// four fields is spread into the four bytes of a word and sign-extended as
// (v ^ 4) - 4. fp8 (first design): pairs of e4m3 values are converted to
// half2 and then float2 (both exact), and multiplied by the activation as
// f32 (exact: 4 x 7 significant bits), so the only roundings are the f32
// sums; on the tensor cores (GQMM, streamed GQMV) pairs convert to f16x2.

#include <cuda.h>   // CUtensorMap and its enums; the encoder is looked up at run time
#include <cudaTypedefs.h>
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

// four packed int4 bytes (elements 0..7) -> two words of sign-extended int8
// in element order: lo holds elements 0..3, hi 4..7
__device__ __forceinline__ void unpack_int4_word(unsigned v, int& lo, int& hi) {
  const unsigned even = v & 0x0F0F0F0Fu, odd = (v >> 4) & 0x0F0F0F0Fu;   // 0,2,4,6 / 1,3,5,7
  lo = sext4(__byte_perm(even, odd, 0x5140));
  hi = sext4(__byte_perm(even, odd, 0x7362));
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

// ---------------------------------------------------------------------------
// B3 (int8) and B6 (int3) GQMM on the int8 tensor cores (the two designs of
// the note at the top). Shared pieces first.

constexpr int kSms = 132;         // the H100's SMs
constexpr int kMaxSmem = 232448;  // 227 KB, the most a block can opt into
constexpr int kMaxDevices = 64;

// Small design (b <= kSmallMaxB): one CTA of kSmallWarps warps owns
// kSmallRows weight rows; its warps take the contraction's units of whole
// groups in rounds; a k-span is 64 logical weights of a row.
constexpr int kSmallMaxB = 16;    // the cut-over (phase-2 times, see the note at the top)
constexpr int kSmallRows = 16;
constexpr int kSmallWarps = 8;
constexpr int kSpan = 64;
constexpr int kUnroll = 4;        // k-spans of weight loads in flight a round (a unit's most)
constexpr int kUnitGroups = 4;    // groups a unit holds at most (GS 16: a k-span)

// Large design (b > kSmallMaxB): a CTA owns a tile of 128 or 64 weight rows
// x kLargeCols batch rows; the contraction streams through a kStagesTc-deep
// ring of kBK-byte slices.
constexpr int kLargeCols = 64;
constexpr int kBK = 128;
constexpr int kStagesTc = 5;   // stages of the ring: two 64-row CTAs fit an SM (deeper gained nothing)
constexpr int kStagesF16 = 4;  // fp8's, whose f16 activation tile takes 16 KB more: two still fit

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the opt-in above 48 KB of dynamic shared memory, once per device for the
// kernel whose flags are `done`
template <class K>
cudaError_t opt_in(K kernel, bool (&done)[kMaxDevices], int device) {
  if (done[device]) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess) done[device] = true;
  return err;
}

// d += a (16 x 32, rows) . b (32 x 8, columns), s8 x s8 -> exact s32
__device__ __forceinline__ void mma_k32(int (&c)[4], int a0, int a1, int a2, int a3, int b0,
                                        int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += a (16 x 16, rows) . b (16 x 8, columns), f16 x f16 -> f32
__device__ __forceinline__ void mma_f16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                        uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// two e4m3 values (low byte first) -> one f16x2 register (low half first), exactly
__device__ __forceinline__ uint32_t fp8x2_to_h2(unsigned pair) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(pair & 0xFFFFu), __NV_E4M3);
  return static_cast<uint32_t>(h.x) | (static_cast<uint32_t>(h.y) << 16);
}

// int8 bytes 2h, 2h + 1 of v -> one f16x2 register, exactly: the byte
// biased by 128 is the mantissa of the f16 1024 + 128 + x, minus 1152
__device__ __forceinline__ uint32_t i8x2_to_h2(unsigned v, int h) {
  const unsigned biased = __byte_perm(v ^ 0x80808080u, 0x64646464u, h ? 0x4342 : 0x4140);
  const __half2 r = __hsub2(*reinterpret_cast<const __half2*>(&biased),
                            __half2(__float2half(1152.f), __float2half(1152.f)));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// ---------------------------------------------------------------------------
// GQMV, streamed design (every format; the note at the top). int4 and
// int3: a lane takes a chunk of 128 logical weights of one row with 16-byte
// loads, a half-warp a 16-chunk piece of a row, a CTA 16 pieces
// (gqmv_stream_kernel). fp8 and int8: a warp takes 16-row blocks'
// 256-column slices (gqmv_stream_block_kernel: fp8 on the f16 tensor cores,
// int8 by __dp4a). Both stage the activations once a CTA.

constexpr int kStreamThreads = 256;
constexpr int kStreamLanes = 16;                                  // lanes a piece
constexpr int kStreamPieces = kStreamThreads / kStreamLanes;     // pieces a CTA
constexpr int kStreamChunk = 128;                                 // logical weights a lane
constexpr int kStreamMaxN = kStreamPieces * kStreamLanes * kStreamChunk;   // one round

// the widest row the streamed designs take: kStreamMaxN, or less while a
// timing run holds rows on the first design (gqmv_set_stream_max_n)
int g_stream_max_n = kStreamMaxN;

// 16-byte loads need a 16-byte aligned base and whole chunks (a row of
// int4, int3, fp8 or int8 storage is then a multiple of 64, 48 or 128 bytes)
bool stream_ok(const void* wq, int n) {
  return (reinterpret_cast<uintptr_t>(wq) & 15) == 0 && n % kStreamChunk == 0 &&
         n <= g_stream_max_n;
}

// int3: a chunk is 48 bytes (three 16-byte loads), sixteen 24-bit words
struct StreamInt3 {
  static constexpr int kVecs = 3;
  static constexpr bool kBlock = false;
  __host__ __device__ static size_t row_bytes(int n) { return (size_t)n / 8 * 3; }
  // the chunk's 128 weights as 32 words of four sign-extended int8 (word i:
  // weights 4i .. 4i + 3); 12 bytes hold four 24-bit words of 8 fields
  __device__ __forceinline__ static void unpack(const uint4 (&r)[kVecs], int (&w)[32]) {
    const unsigned u[12] = {r[0].x, r[0].y, r[0].z, r[0].w, r[1].x, r[1].y,
                            r[1].z, r[1].w, r[2].x, r[2].y, r[2].z, r[2].w};
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const unsigned a = u[3 * g], b = u[3 * g + 1], c = u[3 * g + 2];
      const unsigned w24[4] = {a, (a >> 24) | (b << 8), (b >> 16) | (c << 16), c >> 8};
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        w[8 * g + 2 * h] = sext3(w24[h]);
        w[8 * g + 2 * h + 1] = sext3(w24[h] >> 12);
      }
    }
  }
};

// int4: a chunk is 64 bytes (four 16-byte loads); each 32-bit word holds
// eight weights, the low nibble of a byte the even one, interleaved back
// into element order (unpack_int4_word) as 32 words like int3's
struct StreamInt4 {
  static constexpr int kVecs = 4;
  static constexpr bool kBlock = false;
  __host__ __device__ static size_t row_bytes(int n) { return (size_t)n / 2; }
  __device__ __forceinline__ static void unpack(const uint4 (&r)[kVecs], int (&w)[32]) {
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      unpack_int4_word(r[i].x, w[8 * i], w[8 * i + 1]);
      unpack_int4_word(r[i].y, w[8 * i + 2], w[8 * i + 3]);
      unpack_int4_word(r[i].z, w[8 * i + 4], w[8 * i + 5]);
      unpack_int4_word(r[i].w, w[8 * i + 6], w[8 * i + 7]);
    }
  }
};

// fp8 and int8 (gqmv_stream_block_kernel): a lane's 128 bytes (eight 16-byte
// loads) are 16 bytes of two rows at each of four 64-column spans. fp8's
// activations are staged as f16 (kXBytes 2) for m16n8k16 f16 mmas with f32
// sums; int8's as int8 (kXBytes 1) for __dp4a with exact int32 sums.
struct StreamFp8 {
  static constexpr int kVecs = 8;
  static constexpr bool kBlock = true;
  static constexpr int kXBytes = 2;
  using Acc = float;
};
struct StreamInt8 {
  static constexpr int kVecs = 8;
  static constexpr bool kBlock = true;
  static constexpr int kXBytes = 1;
  using Acc = int;
};

// Dynamic shared memory of a streamed int4 / int3 CTA
// (kernels/gqmv.stream_smem_bytes): the activations, their scales, one
// partial sum a piece.
__host__ __device__ inline size_t stream_smem_bytes(int n, int ng) {
  return (size_t)n + 4 * (size_t)ng + 4 * kStreamPieces;
}

template <class L, int GSL>
__global__ void __launch_bounds__(kStreamThreads)
gqmv_stream_kernel(const uint8_t* __restrict__ wq, const float* __restrict__ ws,
                   const int8_t* __restrict__ xq, const float* __restrict__ xs,
                   float* __restrict__ out, int m, int n, int pieces, int rows_per_cta) {
  constexpr int kGS = 1 << GSL;
  constexpr bool kWhole = kGS <= kStreamChunk;                // groups lie within a chunk
  constexpr int kGroups = kWhole ? kStreamChunk / kGS : 1;   // groups (or halves) a chunk
  constexpr int kVecsPerGroup = kWhole ? kGS / 16 : 8;       // 16-byte activation vectors
  extern __shared__ __align__(16) unsigned char gsm[];
  const int ng = n >> GSL;
  int8_t* x_s = reinterpret_cast<int8_t*>(gsm);             // n bytes, vectors swizzled
  float* xs_s = reinterpret_cast<float*>(gsm + n);          // ng scales
  float* part = xs_s + ng;                                  // a partial sum a piece

  const int tid = threadIdx.x, l16 = tid & 15, h = tid >> 4;
  const int rl = h / pieces, piece = h - rl * pieces;       // row of the CTA, piece of the row
  const int row = blockIdx.x * rows_per_cta + rl;
  const int chunk = piece * kStreamLanes + l16;
  const bool live = rl < rows_per_cta && row < m && chunk < n / kStreamChunk;

  // this lane's weights and weight scales, requested before anything waits
  uint4 raw[L::kVecs];
  float wsc[kGroups];
  if (live) {
    const uint4* src =
        reinterpret_cast<const uint4*>(wq + (size_t)row * L::row_bytes(n)) + chunk * L::kVecs;
#pragma unroll
    for (int i = 0; i < L::kVecs; ++i) raw[i] = __ldg(src + i);
    const float* wsr = ws + (size_t)row * ng;
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
      wsc[g] = kWhole ? __ldg(wsr + chunk * kGroups + g) : __ldg(wsr + (chunk >> 1));
  } else {
#pragma unroll
    for (int i = 0; i < L::kVecs; ++i) raw[i] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int g = 0; g < kGroups; ++g) wsc[g] = 0.f;
  }
  // the activations (16-byte vector i of chunk c at position i ^ (c & 7) of
  // the chunk's 128 bytes, so that the 16 lanes of a piece read 8 bank
  // groups) and their scales, once a CTA
  for (int e = tid; e < n / 16; e += kStreamThreads) {
    const int c = e >> 3, i = e & 7;
    cp_async16(x_s + c * 128 + 16 * (i ^ (c & 7)), xq + 16 * e, true);
  }
  for (int e = tid; e < ng; e += kStreamThreads) cp_async4(xs_s + e, xs + e, true);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // exact int32 sums of each 16-byte activation vector's 16 products
  int sv[8];
  if (live) {
    int w[32];
    L::unpack(raw, w);
    const int8_t* xc = x_s + chunk * 128;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int4 x = *reinterpret_cast<const int4*>(xc + 16 * (i ^ (chunk & 7)));
      int d = 0;
      d = __dp4a(w[4 * i], x.x, d);
      d = __dp4a(w[4 * i + 1], x.y, d);
      d = __dp4a(w[4 * i + 2], x.z, d);
      d = __dp4a(w[4 * i + 3], x.w, d);
      sv[i] = d;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) sv[i] = 0;
  }
  // each group's term s * (ws * xs), the lane's groups left to right; at GS
  // 256 a group is two chunks (lanes 2j, 2j + 1 of a piece), whose int32
  // sums are added first and scaled on the even lane
  float acc = 0.f;
  if constexpr (kWhole) {
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      int s = 0;
#pragma unroll
      for (int i = 0; i < kVecsPerGroup; ++i) s += sv[g * kVecsPerGroup + i];
      if (live)
        acc = __fadd_rn(acc, __fmul_rn(__int2float_rn(s),
                                       __fmul_rn(wsc[g], xs_s[chunk * kGroups + g])));
    }
  } else {
    int s = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) s += sv[i];
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if (live && (chunk & 1) == 0)
      acc = __fmul_rn(__int2float_rn(s), __fmul_rn(wsc[0], xs_s[chunk >> 1]));
  }
  // the piece's 16 lanes: a pairwise tree in lane order
#pragma unroll
  for (int off = 1; off < kStreamLanes; off <<= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (pieces == 1) {
    if (l16 == 0 && rl < rows_per_cta && row < m) out[row] = acc;
    return;
  }
  // a row's pieces left to right, through shared memory
  if (l16 == 0) part[h] = acc;
  __syncthreads();
  if (tid < rows_per_cta) {
    const int r = blockIdx.x * rows_per_cta + tid;
    if (r < m) {
      float v = part[tid * pieces];
      for (int p = 1; p < pieces; ++p) v = __fadd_rn(v, part[tid * pieces + p]);
      out[r] = v;
    }
  }
}

// fp8 (B7) and int8 (B1) on the streamed design in blocks of 16 rows. fp8:
// the f16 tensor cores (e4m3 weights and int8 activations are exact in f16
// and their products exact in f32; mma.sync m16n8k16, f32 sums); int8: the
// CUDA cores, each lane's 16 bytes of a row dotted with its 16 activation
// bytes by four __dp4a and a group's lanes t added by an xor butterfly
// (exact int32; m16n8k32 s8 mmas in the same partition timed a few percent
// slower). A block is kBlockRows rows; warp w of a CTA takes the block's
// 256-column slices w, w + 8, ...; lane (gid, t) loads 16 bytes of rows gid
// and gid + 8 at columns 16t .. 16t + 15 of each of a slice's four
// 64-column spans (a warp load is 8 rows x 64 contiguous bytes), with the
// slice's weight scales. The grid holds as many CTAs as the card runs at
// once, cut so that every CTA but the last takes as many blocks as the
// others; a CTA takes blocks blockIdx.x, blockIdx.x + gridDim.x, ..., and
// requests each slice (the next block's first, at the last) before the one
// before is computed, so that its bytes are in flight while it computes.
// It is a programmatic dependent launch: its first weight loads are issued
// before griddepcontrol.wait, so they stream while the kernel before it
// drains (the weights and their scales are no earlier kernel's output); the
// activations are read after it. They are staged once a CTA (fp8: as f16;
// int8: as int8, by cp.async); a warp's 16-byte reads of them are four
// consecutive vectors, free of bank conflicts. fp8: mma j of a span takes
// the lane's columns 4j .. 4j + 3 as k-slots 2t, 2t + 1, 2t + 8, 2t + 9 of
// both operands (the weights converted pairwise in registers).
constexpr int kBlockRows = 16;     // rows a block: an mma's 16
constexpr int kBlockSlice = 256;   // columns a warp takes at a time: four 64-column spans

// Dynamic shared memory of a streamed fp8 / int8 CTA
// (kernels/gqmv.stream_smem_bytes): the activations (xbytes each: f16 or
// int8), their scales, one term a row a slice.
__host__ __device__ inline size_t stream_block_smem_bytes(int n, int ng, int xbytes) {
  return (size_t)xbytes * n + 4 * (size_t)ng +
         4 * (size_t)kBlockRows * ((n + kBlockSlice - 1) / kBlockSlice);
}

template <class L, int GSL>
__global__ void __launch_bounds__(kStreamThreads)
gqmv_stream_block_kernel(const uint8_t* __restrict__ wq, const float* __restrict__ ws,
                         const int8_t* __restrict__ xq, const float* __restrict__ xs,
                         float* __restrict__ out, int m, int n) {
  constexpr int kGS = 1 << GSL;
  // a group is kGroupSpans whole spans (GS >= 64), or a span holds
  // kSpanGroups groups of GS / 16 lanes each (GS 16, 32)
  constexpr int kGroupSpans = kGS >= 64 ? kGS / 64 : 1;
  constexpr int kSpanGroups = kGS >= 64 ? 1 : 64 / kGS;
  constexpr int kSliceGroups = kBlockSlice / kGS;
  constexpr int kWarps = kStreamThreads / 32;
  constexpr int kSpans = L::kVecs / 2;   // a lane's 16 bytes of two rows a span
  static_assert(kSpans * 64 == kBlockSlice, "a slice is four 64-column spans");
  using Acc = typename L::Acc;
  extern __shared__ __align__(16) unsigned char gsm[];
  const int ng = n >> GSL, slices = (n + kBlockSlice - 1) / kBlockSlice;
  const int blocks = (m + kBlockRows - 1) / kBlockRows;
  uint32_t* x_s = reinterpret_cast<uint32_t*>(gsm);                        // n f16 or int8
  float* xs_s = reinterpret_cast<float*>(gsm + L::kXBytes * (size_t)n);    // ng scales
  float* part = xs_s + ng;                                                 // slices x kBlockRows

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, t = lane & 3;
  // slice s of block b: 16 bytes of rows gid, gid + 8 at each span and
  // their weight scales (zeros past m and n)
  auto fetch = [&](int b, int s, uint4 (&r)[2][kSpans], float (&sc)[2][kSliceGroups]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = b * kBlockRows + gid + 8 * h;
      const uint8_t* wr = wq + (size_t)row * n;
#pragma unroll
      for (int p = 0; p < kSpans; ++p) {
        const int col = s * kBlockSlice + 64 * p + 16 * t;
        r[h][p] = row < m && col < n ? __ldg(reinterpret_cast<const uint4*>(wr + col))
                                     : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int g = 0; g < kSliceGroups; ++g) {
        const int gg = s * kSliceGroups + g;
        sc[h][g] = row < m && gg < ng ? __ldg(ws + (size_t)row * ng + gg) : 0.f;
      }
    }
  };
  int blk = blockIdx.x;
  uint4 raw[2][kSpans];
  float wsc[2][kSliceGroups];
  if (warp < slices) fetch(blk, warp, raw, wsc);
  // launched as a programmatic dependent: the weights and their scales
  // above may be read while the kernel before drains (they are no earlier
  // kernel's output); everything below waits until that kernel is done
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  // the activations (fp8: as f16, exact) and their scales, once a CTA
  if constexpr (L::kXBytes == 2) {
    for (int e = tid; e < n / 16; e += kStreamThreads) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(xq) + e);
      const unsigned v[4] = {static_cast<unsigned>(q.x), static_cast<unsigned>(q.y),
                             static_cast<unsigned>(q.z), static_cast<unsigned>(q.w)};
      uint4* dst = reinterpret_cast<uint4*>(x_s) + 2 * e;
      dst[0] = make_uint4(i8x2_to_h2(v[0], 0), i8x2_to_h2(v[0], 1), i8x2_to_h2(v[1], 0),
                          i8x2_to_h2(v[1], 1));
      dst[1] = make_uint4(i8x2_to_h2(v[2], 0), i8x2_to_h2(v[2], 1), i8x2_to_h2(v[3], 0),
                          i8x2_to_h2(v[3], 1));
    }
  } else {
    for (int e = tid; e < n / 16; e += kStreamThreads)
      cp_async16(reinterpret_cast<uint4*>(x_s) + e, xq + 16 * e, true);
  }
  for (int e = tid; e < ng; e += kStreamThreads) cp_async4(xs_s + e, xs + e, true);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  for (;;) {
    const int nblk = blk + gridDim.x;
    for (int s = warp; s < slices; s += kWarps) {
      uint4 nraw[2][kSpans];
      float nwsc[2][kSliceGroups];
      if (s + kWarps < slices) fetch(blk, s + kWarps, nraw, nwsc);
      else if (nblk < blocks) fetch(nblk, warp, nraw, nwsc);
      // the group terms s * (ws * xs) of this slice, left to right
      float acc[2] = {0.f, 0.f};
#pragma unroll
      for (int p0 = 0; p0 < kSpans; p0 += kGroupSpans) {
#pragma unroll
        for (int q = 0; q < kSpanGroups; ++q) {
          const bool mine = t / (4 / kSpanGroups) == q;   // this lane's columns in group q
          Acc c[4] = {0, 0, 0, 0};
#pragma unroll
          for (int p = p0; p < p0 + kGroupSpans; ++p) {
            if constexpr (L::kXBytes == 2) {
              const uint4* xv = reinterpret_cast<const uint4*>(x_s) +
                                (s * kBlockSlice + 64 * p + 16 * t) / 8;
              const uint4 x0 = xv[0], x1 = xv[1];
              const uint32_t xb[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
              const uint32_t w0[4] = {raw[0][p].x, raw[0][p].y, raw[0][p].z, raw[0][p].w};
              const uint32_t w1[4] = {raw[1][p].x, raw[1][p].y, raw[1][p].z, raw[1][p].w};
#pragma unroll
              for (int j = 0; j < 4; ++j)
                mma_f16(c, fp8x2_to_h2(w0[j]), fp8x2_to_h2(w1[j]), fp8x2_to_h2(w0[j] >> 16),
                        fp8x2_to_h2(w1[j] >> 16), mine ? xb[2 * j] : 0u,
                        mine ? xb[2 * j + 1] : 0u);
            } else {   // c[0], c[2]: rows gid and gid + 8, where an mma would hold them
              const int4 xv =
                  reinterpret_cast<const int4*>(x_s)[(s * kBlockSlice + 64 * p) / 16 + t];
              const uint4 w0 = raw[0][p], w1 = raw[1][p];
              int d0 = __dp4a(static_cast<int>(w0.x), xv.x, 0);
              d0 = __dp4a(static_cast<int>(w0.y), xv.y, d0);
              d0 = __dp4a(static_cast<int>(w0.z), xv.z, d0);
              d0 = __dp4a(static_cast<int>(w0.w), xv.w, d0);
              int d1 = __dp4a(static_cast<int>(w1.x), xv.x, 0);
              d1 = __dp4a(static_cast<int>(w1.y), xv.y, d1);
              d1 = __dp4a(static_cast<int>(w1.z), xv.z, d1);
              d1 = __dp4a(static_cast<int>(w1.w), xv.w, d1);
              c[0] += mine ? d0 : 0;
              c[2] += mine ? d1 : 0;
            }
          }
          if constexpr (L::kXBytes == 1) {   // the group's lanes t: an xor butterfly
#pragma unroll
            for (int off = 1; off < 4; off <<= 1) {
              c[0] += __shfl_xor_sync(0xffffffffu, c[0], off);
              c[2] += __shfl_xor_sync(0xffffffffu, c[2], off);
            }
          }
          const int g = (64 * p0) / kGS + q;               // the group within the slice
          if (s * kSliceGroups + g < ng) {
            const float x = xs_s[s * kSliceGroups + g];
            acc[0] = __fadd_rn(acc[0], __fmul_rn(to_float(c[0]), __fmul_rn(wsc[0][g], x)));
            acc[1] = __fadd_rn(acc[1], __fmul_rn(to_float(c[2]), __fmul_rn(wsc[1][g], x)));
          }
        }
      }
      if (t == 0) {
        part[s * kBlockRows + gid] = acc[0];
        part[s * kBlockRows + gid + 8] = acc[1];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int p = 0; p < kSpans; ++p) raw[h][p] = nraw[h][p];
#pragma unroll
        for (int g = 0; g < kSliceGroups; ++g) wsc[h][g] = nwsc[h][g];
      }
    }
    // a row's slices left to right
    __syncthreads();
    if (tid < kBlockRows && blk * kBlockRows + tid < m) {
      float v = part[tid];
      for (int s = 1; s < slices; ++s) v = __fadd_rn(v, part[s * kBlockRows + tid]);
      out[blk * kBlockRows + tid] = v;
    }
    if (nblk >= blocks) return;
    __syncthreads();   // part is read before the next block writes it
    blk = nblk;
  }
}

template <class L, int GSL>
int launch_stream(const void* wq, const void* ws, const void* xq, const void* xs, void* out,
                  int m, int n, int device, cudaStream_t stream) {
  if constexpr (L::kBlock) {
    const auto kernel = gqmv_stream_block_kernel<L, GSL>;
    const size_t smem = stream_block_smem_bytes(n, n >> GSL, L::kXBytes);
    if (smem > 48 * 1024) {   // wide rows: the staged activations past 48 KB
      static bool opted[kMaxDevices] = {};
      const cudaError_t err = opt_in(kernel, opted, device);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    // as many CTAs as the card runs at once, at most one a block
    int per_sm = 0, sms = 0;
    cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kStreamThreads, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int cap = per_sm * sms > 0 ? per_sm * sms : 1;
    const int blocks = (m + kBlockRows - 1) / kBlockRows;
    const int per = (blocks + cap - 1) / cap;   // blocks a CTA, the same for all but the last
    // a programmatic dependent launch (Hopper): the grid may be scheduled
    // while the kernel before it drains, and stream its weights meanwhile
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((blocks + per - 1) / per);
    cfg.blockDim = dim3(kStreamThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return static_cast<int>(cudaLaunchKernelEx(
        &cfg, kernel, static_cast<const uint8_t*>(wq), static_cast<const float*>(ws),
        static_cast<const int8_t*>(xq), static_cast<const float*>(xs), static_cast<float*>(out),
        m, n));
  } else {
    const int pieces = (n / kStreamChunk + kStreamLanes - 1) / kStreamLanes;
    const int rows = kStreamPieces / pieces;
    gqmv_stream_kernel<L, GSL><<<(m + rows - 1) / rows, kStreamThreads,
                                 stream_smem_bytes(n, n >> GSL), stream>>>(
        static_cast<const uint8_t*>(wq), static_cast<const float*>(ws),
        static_cast<const int8_t*>(xq), static_cast<const float*>(xs), static_cast<float*>(out),
        m, n, pieces, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

// GQMV with the streamed design where the rows allow it (stream_ok: by
// pointer and shape, kernels/gqmv.gqmv_design mirrors it), else the first
// design (First)
template <class L, class First>
int run_gqmv_stream(const void* wq, const void* ws, const void* xq, const void* xs, void* out,
                    int m, int n, int group_size, int device, void* stream) {
  const int gs_log2 = log2_group(group_size);
  if (bad_args(1, m, n, gs_log2) || device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!stream_ok(wq, n))
    return run_gqmv<First>(wq, ws, xq, xs, out, m, n, group_size, device, stream);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (gs_log2) {
    case 4: return launch_stream<L, 4>(wq, ws, xq, xs, out, m, n, device, s);
    case 5: return launch_stream<L, 5>(wq, ws, xq, xs, out, m, n, device, s);
    case 6: return launch_stream<L, 6>(wq, ws, xq, xs, out, m, n, device, s);
    case 7: return launch_stream<L, 7>(wq, ws, xq, xs, out, m, n, device, s);
    default: return launch_stream<L, 8>(wq, ws, xq, xs, out, m, n, device, s);
  }
}

__device__ __forceinline__ void ldmatrix_x4(int (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// one group's scaled term, each product rounded on its own (no FMA):
// int8 (s * ws) * xs, int4 / int3 / fp8 (s * xs) * ws, as the plain versions
template <bool kXsFirst>
__device__ __forceinline__ float group_term(float sf, float wsc, float xsc) {
  return kXsFirst ? __fmul_rn(__fmul_rn(sf, xsc), wsc) : __fmul_rn(__fmul_rn(sf, wsc), xsc);
}
template <bool kXsFirst>
__device__ __forceinline__ float group_term(int s, float wsc, float xsc) {
  // exact: |s| <= 127^2 * 256 < 2^24
  return group_term<kXsFirst>(__int2float_rn(s), wsc, xsc);
}

// Weight loaders: 16 logical weights of a row from logical column k (a
// multiple of 16), raw (fetch, a load in flight) then as four words of
// sign-extended int8 (unpack; fp8: the four words of e4m3 bytes). A load
// past m or n gives zeros. Acc: the type of a group sum (exact int32, or
// f32 for fp8). kMayMisalign: rows the large design's ring may not stream,
// which then run the first design (First) by shape (ring_ok).
struct TcInt8 {
  using Raw = int4;
  using Acc = int;
  static constexpr bool kFloat = false;
  static constexpr bool kMayMisalign = false;   // the wrapper checks 16-byte rows
  __host__ __device__ __forceinline__ static size_t row_bytes(int n) { return (size_t)n; }
  __device__ __forceinline__ static Raw fetch(const uint8_t* wq, size_t rb, int row, int k,
                                              bool ok) {
    return ok ? __ldg(reinterpret_cast<const int4*>(wq + row * rb + k)) : make_int4(0, 0, 0, 0);
  }
  __device__ __forceinline__ static void unpack(const Raw& r, int (&w)[4]) {
    w[0] = r.x;
    w[1] = r.y;
    w[2] = r.z;
    w[3] = r.w;
  }
};

// int3: 16 weights are 6 bytes at 6 * (k / 16) of the row, read as three
// 16-bit words (rows are only 2-byte aligned)
struct TcInt3 {
  struct Raw {
    unsigned u0, u1, u2;
  };
  using Acc = int;
  using First = Int3Weights;
  static constexpr bool kFloat = false;
  static constexpr bool kMayMisalign = true;    // rows are only 2-byte aligned
  // whether the large design's 16-byte copies can stream these rows (48
  // bytes a slice of a row)
  static bool ring_ok(const void* wq, int n) {
    return (reinterpret_cast<uintptr_t>(wq) & 15) == 0 && n % kBK == 0;
  }
  __host__ __device__ __forceinline__ static size_t row_bytes(int n) { return (size_t)n / 8 * 3; }
  __device__ __forceinline__ static Raw fetch(const uint8_t* wq, size_t rb, int row, int k,
                                              bool ok) {
    if (!ok) return Raw{0u, 0u, 0u};
    const unsigned short* p =
        reinterpret_cast<const unsigned short*>(wq + row * rb) + 3 * (k >> 4);
    return Raw{__ldg(p), __ldg(p + 1), __ldg(p + 2)};
  }
  __device__ __forceinline__ static void unpack(const Raw& r, int (&w)[4]) {
    const unsigned lo = r.u0 | ((r.u1 & 0xFFu) << 16);  // elements 0..7
    const unsigned hi = (r.u1 >> 8) | (r.u2 << 8);      // elements 8..15
    w[0] = sext3(lo);
    w[1] = sext3(lo >> 12);
    w[2] = sext3(hi);
    w[3] = sext3(hi >> 12);
  }
};

// int4: 16 weights are 8 bytes at k / 2 of the row, the low nibble the even
// element (rows are 8-byte aligned: n / 2 bytes, n a multiple of 16);
// unpacked into element order, the order of the activation bytes
struct TcInt4 {
  using Raw = uint2;
  using Acc = int;
  using First = Int4Weights;
  static constexpr bool kFloat = false;
  static constexpr bool kMayMisalign = true;    // rows are 8-byte aligned; the ring needs 16
  // whether the large design's TMA can stream these rows (64 bytes a slice
  // of a row)
  static bool ring_ok(const void* wq, int n) {
    return (reinterpret_cast<uintptr_t>(wq) & 15) == 0 && n % kBK == 0;
  }
  __host__ __device__ __forceinline__ static size_t row_bytes(int n) { return (size_t)n / 2; }
  __device__ __forceinline__ static Raw fetch(const uint8_t* wq, size_t rb, int row, int k,
                                              bool ok) {
    return ok ? __ldg(reinterpret_cast<const uint2*>(wq + row * rb + (k >> 1)))
              : make_uint2(0u, 0u);
  }
  __device__ __forceinline__ static void unpack(const Raw& r, int (&w)[4]) {
    unpack_int4_word(r.x, w[0], w[1]);
    unpack_int4_word(r.y, w[2], w[3]);
  }
};

// fp8: 16 e4m3 bytes, fetched and kept as int8's are; the mma converts
// them to f16 and sums in f32
struct TcFp8 : TcInt8 {
  using Acc = float;
  static constexpr bool kFloat = true;
};

// One 64-column k-span of the small design: rows gid and gid + 8 (w0, w1:
// the lane's 16 weights of each, as four words) times batch rows gid of an
// 8-row tile (xv: the lane's same 16 activation bytes), added into the
// tile's accumulators c; the weights count as zeros where !on. Integer
// formats: two m16n8k32 s8 mmas, bytes 0-7 then 8-15 of every lane's 16.
// fp8: four m16n8k16 f16 mmas; mma i takes the lane's columns 4i..4i+3 as
// k-slots 2t, 2t+1, 2t+8, 2t+9 of both operands (e4m3 and int8 are exact
// in f16, their products exact in f32).
template <class L>
__device__ __forceinline__ void span_mma(typename L::Acc (&c)[4], const int (&w0)[4],
                                         const int (&w1)[4], const int4& xv, bool on) {
  if constexpr (L::kFloat) {
    const int x[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned a0 = on ? static_cast<unsigned>(w0[i]) : 0u;
      const unsigned a1 = on ? static_cast<unsigned>(w1[i]) : 0u;
      mma_f16(c, fp8x2_to_h2(a0), fp8x2_to_h2(a1), fp8x2_to_h2(a0 >> 16), fp8x2_to_h2(a1 >> 16),
              i8x2_to_h2(static_cast<unsigned>(x[i]), 0),
              i8x2_to_h2(static_cast<unsigned>(x[i]), 1));
    }
  } else {
    mma_k32(c, on ? w0[0] : 0, on ? w1[0] : 0, on ? w0[1] : 0, on ? w1[1] : 0, xv.x, xv.y);
    mma_k32(c, on ? w0[2] : 0, on ? w1[2] : 0, on ? w0[3] : 0, on ? w1[3] : 0, xv.z, xv.w);
  }
}

__host__ __device__ inline int small_x_stride(int n) {
  // whole k-spans, then rounded so that rows start 64 bytes apart mod 128:
  // the 8 rows a B-fragment load touches fall in distinct bank groups
  const int spans = (n + kSpan - 1) / kSpan;
  return (spans * kSpan + 127) / 128 * 128 + 64;
}

// Dynamic shared memory of a small-design CTA (kernels/gqmv.small_smem_bytes
// mirrors it): X rows (8 NB, stride), xs (8 NB, ng), ws (kSmallRows, ng),
// and one round's scaled terms (kSmallWarps, kUnitGroups, kSmallRows, 8 NB).
__host__ __device__ inline size_t small_smem_bytes(int nb8, int n, int ng) {
  return (size_t)8 * nb8 * small_x_stride(n) + 4 * ((size_t)8 * nb8 * ng) +
         4 * ((size_t)kSmallRows * ng) +
         4 * ((size_t)kSmallWarps * kUnitGroups * kSmallRows * 8 * nb8);
}

// Small design. The contraction is cut into units of whole groups (one
// group of GS >= 64 columns, or one 64-column k-span of 64/GS groups) and
// walked in rounds: in round r, warp w multiplies unit r * kSmallWarps + w,
// while its loads of the next round's unit are in flight. Lane (gid =
// lane / 4, t = lane % 4) holds, for every k-span of its unit, the 16
// logical weights 16t..16t+15 of rows gid and gid + 8 (two 16-byte loads
// for int8) and the same 16 activation bytes of batch row gid of each 8-row
// tile. Inside a k-span the mma's k order is a permutation of the 64
// columns, the same for weights and activations, so the int32 sums are the
// group sums: the first m16n8k32 takes bytes 0-7 of every lane's 16, the
// second bytes 8-15. A group narrower than a k-span (GS 16, 32) is summed by
// mmas whose weights are zero outside it. Each group's scaled terms go to
// shared memory; after the round one thread per output adds the round's
// terms in group order into its even-group or odd-group sum, so the order is
// the large design's.
template <class L, int NB, bool kXsFirst>
__global__ void __launch_bounds__(kSmallWarps * 32, 2)
gqmm_small_kernel(const uint8_t* __restrict__ wq, const float* __restrict__ ws,
                  const int8_t* __restrict__ xq, const float* __restrict__ xs,
                  float* __restrict__ out, int b, int m, int n, int gs_log2) {
  extern __shared__ __align__(16) unsigned char smem_small[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * kSmallRows;
  const int ng = n >> gs_log2, gs = 1 << gs_log2;
  const int xstride = small_x_stride(n);
  int8_t* x_s = reinterpret_cast<int8_t*>(smem_small);                          // (8 NB, xstride)
  float* xs_s = reinterpret_cast<float*>(smem_small + (size_t)8 * NB * xstride);  // (8 NB, ng)
  float* ws_s = xs_s + 8 * NB * ng;                                               // (16, ng)
  float* t_s = ws_s + kSmallRows * ng;                     // (warps, unit groups, 16, 8 NB)

  const int ugroups = gs >= kSpan ? 1 : kSpan >> gs_log2;  // groups a unit
  const int uspans = gs >= kSpan ? gs / kSpan : 1;         // k-spans a unit (<= kUnroll)
  const int nspan = (n + kSpan - 1) / kSpan;
  const int nunits = (nspan + uspans - 1) / uspans;
  const int nrounds = (nunits + kSmallWarps - 1) / kSmallWarps;
  const size_t rb = L::row_bytes(n);
  const int r0 = m0 + gid, r1 = m0 + gid + 8;

  typename L::Raw cur[kUnroll][2], nxt[kUnroll][2];
  // this warp's unit of round `round` (nothing past the last unit)
  auto fetch = [&](typename L::Raw (&buf)[kUnroll][2], int round) {
    const int u = round * kSmallWarps + warp;
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int k = (u * uspans + i) * kSpan + 16 * t;
      const bool ok = u < nunits && i < uspans && k < n;
      buf[i][0] = L::fetch(wq, rb, r0, k, ok && r0 < m);
      buf[i][1] = L::fetch(wq, rb, r1, k, ok && r1 < m);
    }
  };
  // the first weight loads go out before the activations are staged
  fetch(cur, 0);
  for (int e = tid; e < 8 * NB * (xstride / 16); e += kSmallWarps * 32) {
    const int r = e / (xstride / 16), c = e % (xstride / 16);
    const bool ok = r < b && c * 16 < n;
    cp_async16(x_s + (size_t)r * xstride + c * 16, ok ? xq + (size_t)r * n + c * 16 : xq, ok);
  }
  for (int e = tid; e < 8 * NB * ng; e += kSmallWarps * 32) {
    const int r = e / ng;
    cp_async4(xs_s + e, r < b ? xs + e : xs, r < b);
  }
  for (int e = tid; e < kSmallRows * ng; e += kSmallWarps * 32) {
    const int r = e / ng;
    cp_async4(ws_s + e, m0 + r < m ? ws + (size_t)m0 * ng + e : ws, m0 + r < m);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  typename L::Acc c[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[j][i] = 0;
  // group g's scaled terms (the jg-th of this warp's unit) into t_s
  auto put_group = [&](int g, int jg) {
    const float w0 = ws_s[gid * ng + g], w1 = ws_s[(gid + 8) * ng + g];
    float* tw = t_s + (size_t)(warp * kUnitGroups + jg) * kSmallRows * 8 * NB;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int c0 = j * 8 + 2 * t;
      const float x0 = xs_s[c0 * ng + g], x1 = xs_s[(c0 + 1) * ng + g];
      tw[gid * 8 * NB + c0] = group_term<kXsFirst>(c[j][0], w0, x0);
      tw[gid * 8 * NB + c0 + 1] = group_term<kXsFirst>(c[j][1], w0, x1);
      tw[(gid + 8) * 8 * NB + c0] = group_term<kXsFirst>(c[j][2], w1, x0);
      tw[(gid + 8) * 8 * NB + c0 + 1] = group_term<kXsFirst>(c[j][3], w1, x1);
#pragma unroll
      for (int i = 0; i < 4; ++i) c[j][i] = 0;
    }
  };
  // thread tid < 16 * 8 NB owns output (row tid % 16, batch row tid / 16)
  const int orow = tid % kSmallRows, ocol = tid / kSmallRows;
  float even = 0.f, odd = 0.f;

  for (int round = 0; round < nrounds; ++round) {
    if (round + 1 < nrounds) fetch(nxt, round + 1);
    const int u = round * kSmallWarps + warp;
    if (u < nunits) {
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        const int s = u * uspans + i;
        if (i < uspans && s < nspan) {
          int w0[4], w1[4];
          L::unpack(cur[i][0], w0);
          L::unpack(cur[i][1], w1);
          int4 xv[NB];
#pragma unroll
          for (int j = 0; j < NB; ++j)
            xv[j] = *reinterpret_cast<const int4*>(x_s + (size_t)(j * 8 + gid) * xstride +
                                                   s * kSpan + 16 * t);
          if (gs >= kSpan) {
#pragma unroll
            for (int j = 0; j < NB; ++j) span_mma<L>(c[j], w0, w1, xv[j], true);
          } else {
            // GS 16 or 32: lane t's 16 weights lie in the span's group 16t / GS
            const int mine = (16 * t) >> gs_log2;
            for (int jg = 0; jg < ugroups; ++jg) {
              if (s * ugroups + jg >= ng) break;
#pragma unroll
              for (int j = 0; j < NB; ++j) span_mma<L>(c[j], w0, w1, xv[j], mine == jg);
              put_group(s * ugroups + jg, jg);
            }
          }
        }
      }
      if (gs >= kSpan) put_group(u, 0);
    }
    __syncthreads();          // the round's terms are in t_s
    if (tid < kSmallRows * 8 * NB) {
      for (int w = 0; w < kSmallWarps; ++w) {
        const int uw = round * kSmallWarps + w;
        if (uw >= nunits) break;
        for (int jg = 0; jg < ugroups; ++jg) {
          const int g = uw * ugroups + jg;
          if (g >= ng) break;
          const float v = t_s[((size_t)(w * kUnitGroups + jg) * kSmallRows + orow) * 8 * NB + ocol];
          if (g & 1) odd = __fadd_rn(odd, v);
          else even = __fadd_rn(even, v);
        }
      }
    }
    __syncthreads();          // t_s is free for the next round
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      cur[i][0] = nxt[i][0];
      cur[i][1] = nxt[i][1];
    }
  }
  if (tid < kSmallRows * 8 * NB && m0 + orow < m && ocol < b)
    out[(size_t)ocol * m + m0 + orow] = __fadd_rn(even, odd);
}

// Large design: a CTA of 2 WM warps owns weight rows m0 .. m0 + 32 WM and
// batch rows b0 .. b0 + 64. At GS >= 32 each warpgroup computes 64 of the
// rows for all 64 batch rows with wgmma; at GS 16 warp (wm, wb) computes a
// 32 x 32 block as 2 x 4 mma.sync m16n8 tiles. Each stage of the ring holds
// a kBK-byte slice of the contraction for the CTA's weight rows and batch
// rows, brought by the TMA unit (one cp.async.bulk.tensor a tile,
// completing on the stage's mbarrier; rows and columns past m, b or n
// arrive as zeros), and the weight and activation scales of the slice's
// groups, by cp.async; all but one stage ahead, so no global load is waited
// on inside the loop but the ring's. (16-byte cp.async from every thread
// held each SM to ~16 KB in flight, ~1.3 us a slice whatever the grid.)
// The TMA's 128-byte swizzle puts 16-byte chunk ch of row r at chunk
// ch ^ (r % 8): wgmma's descriptors name that layout, and each ldmatrix
// phase reads 8 distinct bank groups. int3 weights arrive packed (48 bytes
// a row a slice) and are unpacked to int8 into one tile, in the same
// swizzle, before the slice is multiplied, so the mma body is shared.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// the box of tensor map tm at (x, y) -> shared dst, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* tm, int x, int y,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// Shared-memory matrix descriptor of a K-major tile of 128-byte rows in the
// 128-byte swizzle, 8-row atoms 1 KB apart, starting at addr.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (64 x 64 s32, this warpgroup's) = a (64 x 32 s8) . b (32 x 64 s8), plus
// d when accumulate; both operands from shared memory
__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8"
      " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}
// d (64 x 64 f32, this warpgroup's) = a (64 x 16 f16, registers: the
// m16n8k16 A fragment of each warp's 16 rows) . b (16 x 64 f16, shared
// memory, K-major), plus d when accumulate
__device__ __forceinline__ void wgmma_f16(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16"
      " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n wgmma.wait_group.sync.aligned 0;\n" ::
                   : "memory");
}

template <class L>
struct TcRing;   // how a slice's weights reach the int8 rows ldmatrix reads

template <>
struct TcRing<TcInt8> {
  static constexpr int kSliceBytes = kBK;   // bytes a weight row a slice, as stored
  static constexpr bool kUnpacked = false;  // ldmatrix reads the ring itself
  __device__ __forceinline__ static int x_of(int k0) { return k0; }
  template <int kThr, int kRows>
  __device__ __forceinline__ static void unpack(const unsigned char*, unsigned char*, int) {}
};

template <>
struct TcRing<TcInt3> {
  static constexpr int kSliceBytes = kBK / 8 * 3;   // 48: 128 3-bit fields, packed
  static constexpr bool kUnpacked = true;
  __device__ __forceinline__ static int x_of(int k0) { return k0 / 8 * 3; }
  // the slice's packed rows -> the int8 tile, 16 fields (6 bytes) a chunk
  template <int kThr, int kRows>
  __device__ __forceinline__ static void unpack(const unsigned char* w_s, unsigned char* tile,
                                                int tid) {
    for (int e = tid; e < kRows * (kBK / 16); e += kThr) {
      const int r = e >> 3, ch = e & 7;
      const unsigned short* q =
          reinterpret_cast<const unsigned short*>(w_s + r * kSliceBytes) + 3 * ch;
      int w[4];
      TcInt3::unpack(TcInt3::Raw{q[0], q[1], q[2]}, w);
      *reinterpret_cast<int4*>(tile + r * kBK + ((ch ^ (r & 7)) << 4)) =
          make_int4(w[0], w[1], w[2], w[3]);
    }
  }
};

template <>
struct TcRing<TcInt4> {
  static constexpr int kSliceBytes = kBK / 2;   // 64: 128 nibbles, packed
  static constexpr bool kUnpacked = true;
  __device__ __forceinline__ static int x_of(int k0) { return k0 / 2; }
  // the slice's packed rows -> the int8 tile, 16 nibbles (8 bytes) a chunk
  template <int kThr, int kRows>
  __device__ __forceinline__ static void unpack(const unsigned char* w_s, unsigned char* tile,
                                                int tid) {
    for (int e = tid; e < kRows * (kBK / 16); e += kThr) {
      const int r = e >> 3, ch = e & 7;
      int w[4];
      TcInt4::unpack(*reinterpret_cast<const uint2*>(w_s + r * kSliceBytes + 8 * ch), w);
      *reinterpret_cast<int4*>(tile + r * kBK + ((ch ^ (r & 7)) << 4)) =
          make_int4(w[0], w[1], w[2], w[3]);
    }
  }
};

// fp8: the weights stay in the ring as e4m3 bytes (each warp converts its
// rows' A fragments in registers); the activations' int8 tile is converted
// to an f16 tile beside the ring (x_to_f16)
template <>
struct TcRing<TcFp8> : TcRing<TcInt8> {};

// groups whose scales a stage holds: the slice's (kBK / GS of them, or the
// one group a slice of a wider group lies in)
constexpr int kStageGroups = 8;   // kBK / 16, at GS 16
constexpr int kScaleStride = 9;   // floats a row of them: 8 rows fall in distinct banks
constexpr int kSwizzleAlign = 1024;   // a 128-byte-swizzled tile starts on 1 KB
static_assert(kStageGroups == kBK / 16 && kScaleStride == kStageGroups + 1, "scale layout");

__host__ __device__ constexpr size_t round_up_1k(size_t x) {
  return (x + kSwizzleAlign - 1) / kSwizzleAlign * kSwizzleAlign;
}

// A stage: the weight tile (1 KB multiple), the activation tile, the
// scales, padded to 1 KB so every stage's tiles start swizzle-aligned.
template <class L>
__host__ __device__ constexpr size_t large_stage_bytes(int rows) {
  return round_up_1k((size_t)rows * TcRing<L>::kSliceBytes + (size_t)kLargeCols * kBK +
                     4 * (size_t)(rows + kLargeCols) * kScaleStride);
}

// fp8: the f16 activation tile, two 1 KB-aligned atoms of 64 columns (128
// bytes) x kLargeCols rows in the 128-byte swizzle, K-major as wgmma's B
constexpr int kXAtomBytes = kLargeCols * 128;

template <class L>
__host__ __device__ constexpr int ring_stages() {
  return L::kFloat ? kStagesF16 : kStagesTc;
}

// Dynamic shared memory of a large-design CTA (kernels/gqmv.large_smem_bytes
// mirrors it): 1 KB of room to align the base, ring_stages<L>() stages, for
// int3 and int4 the unpacked int8 tile, for fp8 the f16 activation tile,
// then one mbarrier a stage.
template <class L>
__host__ __device__ constexpr size_t large_smem_bytes(int wm) {
  return kSwizzleAlign + ring_stages<L>() * large_stage_bytes<L>(32 * wm) +
         (TcRing<L>::kUnpacked ? (size_t)32 * wm * kBK : 0) +
         (L::kFloat ? (size_t)2 * kXAtomBytes : 0) + 8 * ring_stages<L>();
}

// fp8: the stage's int8 activation tile (kLargeCols rows of kBK bytes in the
// 128-byte swizzle) -> the f16 tile xh: 16 bytes of row r (columns 16 ch ..
// 16 ch + 15) become chunks 2 (ch % 4) and 2 (ch % 4) + 1 of row r of atom
// ch / 4, swizzled the same way
template <int kThr>
__device__ __forceinline__ void x_to_f16(const unsigned char* x_s, unsigned char* xh, int tid) {
  for (int e = tid; e < kLargeCols * (kBK / 16); e += kThr) {
    const int r = e >> 3, ch = e & 7;
    const int4 v = *reinterpret_cast<const int4*>(x_s + r * kBK + ((ch ^ (r & 7)) << 4));
    const unsigned w[4] = {static_cast<unsigned>(v.x), static_cast<unsigned>(v.y),
                           static_cast<unsigned>(v.z), static_cast<unsigned>(v.w)};
    unsigned char* row = xh + (ch >> 2) * kXAtomBytes + r * 128;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c2 = 2 * (ch & 3) + h;
      *reinterpret_cast<uint4*>(row + ((c2 ^ (r & 7)) << 4)) =
          make_uint4(i8x2_to_h2(w[2 * h], 0), i8x2_to_h2(w[2 * h], 1),
                     i8x2_to_h2(w[2 * h + 1], 0), i8x2_to_h2(w[2 * h + 1], 1));
    }
  }
}

template <class L, int WM, bool kXsFirst, bool kWg>
__global__ void __launch_bounds__(WM * 64)
gqmm_mma_kernel(const __grid_constant__ CUtensorMap tm_w, const __grid_constant__ CUtensorMap tm_x,
                const float* __restrict__ ws, const float* __restrict__ xs,
                float* __restrict__ out, int b, int m, int n, int gs_log2) {
  constexpr int kThr = WM * 64, kRows = 32 * WM;
  constexpr int kStages = ring_stages<L>();
  using Ring = TcRing<L>;
  constexpr size_t kStageBytes = large_stage_bytes<L>(kRows);
  static_assert(large_smem_bytes<L>(WM) <= kMaxSmem, "the ring fits the opt-in");
  constexpr int kTxBytes = kRows * Ring::kSliceBytes + kLargeCols * kBK;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, t = lane & 3;
  const int wm = warp % WM, wb = warp / WM;
  const int b0 = blockIdx.x * kLargeCols, m0 = blockIdx.y * kRows;
  const int ng = n >> gs_log2, gs = 1 << gs_log2;
  const int nk = (n + kBK - 1) / kBK;
  const int sgroups = max(1, kBK >> gs_log2);        // groups whose scales a stage holds

  unsigned char* base = smem_tc + ((kSwizzleAlign - (smem_addr(smem_tc) & (kSwizzleAlign - 1))) &
                                   (kSwizzleAlign - 1));
  auto stage = [&](int kt) { return base + (size_t)(kt % kStages) * kStageBytes; };
  auto x_stage = [&](int kt) { return stage(kt) + kRows * Ring::kSliceBytes; };
  auto ws_stage = [&](int kt) { return reinterpret_cast<float*>(x_stage(kt) + kLargeCols * kBK); };
  auto xs_stage = [&](int kt) { return ws_stage(kt) + kRows * kScaleStride; };
  unsigned char* tile = base + kStages * kStageBytes;   // int3, int4: the unpacked weights
  unsigned char* xh = tile + (Ring::kUnpacked ? (size_t)kRows * kBK : 0);   // fp8: f16 X
  const uint32_t bars = smem_addr(xh + (L::kFloat ? 2 * kXAtomBytes : 0));
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // slice kt: thread 0 sets the stage's byte count and issues the two tile
  // loads; every thread copies scales
  auto fetch = [&](int kt) {
    const int k0 = kt * kBK;
    if (tid == 0) {
      const uint32_t bar = bars + 8 * (kt % kStages);
      // the stage was last read by ldmatrix (generic proxy) before the
      // barrier that precedes this fetch: order those reads before the
      // tile loads' writes (async proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect_tx(bar, kTxBytes);
      tma_load(smem_addr(stage(kt)), &tm_w, Ring::x_of(k0), m0, bar);
      tma_load(smem_addr(x_stage(kt)), &tm_x, k0, b0, bar);
    }
    const int g0 = k0 >> gs_log2;
    float* wsd = ws_stage(kt);
    for (int e = tid; e < (kRows + kLargeCols) * sgroups; e += kThr) {
      const int r = e / sgroups, j = e - r * sgroups, g = g0 + j;
      if (r < kRows) {
        const bool ok = m0 + r < m && g < ng;
        cp_async4(wsd + r * kScaleStride + j, ok ? ws + (size_t)(m0 + r) * ng + g : ws, ok);
      } else {
        const int rx = r - kRows;
        const bool ok = b0 + rx < b && g < ng;
        cp_async4(wsd + r * kScaleStride + j, ok ? xs + (size_t)(b0 + rx) * ng + g : xs, ok);
      }
    }
  };

  if constexpr (kWg) {
    // warpgroup wg owns weight rows 64 wg .. 64 wg + 63 of the tile, all 64
    // batch rows; warp w4 of it rows 16 w4 .. 16 w4 + 15, lane (gid, t) the
    // m16n8 fragment of each 8-column tile j: d[4j + i] at row gid + 8 (i / 2),
    // batch row 8j + 2t + i % 2
    const int wg = warp >> 2, w4 = warp & 3;
    typename L::Acc d[32];
    float ev[32], od[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      d[i] = 0;
      ev[i] = od[i] = 0.f;
    }
    const int lrow = wg * 64 + w4 * 16 + gid;     // tile rows lrow, lrow + 8
    auto finish = [&](int g, const float* wsd, const float* xsd, int j0) {
      const bool is_odd = g & 1;
      const float w0 = wsd[lrow * kScaleStride + j0], w1 = wsd[(lrow + 8) * kScaleStride + j0];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float x0 = xsd[(8 * j + 2 * t) * kScaleStride + j0];
        const float x1 = xsd[(8 * j + 2 * t + 1) * kScaleStride + j0];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float term = group_term<kXsFirst>(d[4 * j + i], i < 2 ? w0 : w1, i & 1 ? x1 : x0);
          const float sum = __fadd_rn(is_odd ? od[4 * j + i] : ev[4 * j + i], term);
          if (is_odd) od[4 * j + i] = sum;
          else ev[4 * j + i] = sum;
        }
      }
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nk) fetch(s);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<kStages - 2>();
      mbar_wait(bars + 8 * (kt % kStages), (kt / kStages) & 1);
      __syncthreads();        // everyone's scales are in; slice kt - 1's stage is free
      const int nx = kt + kStages - 1;
      if (nx < nk) fetch(nx);
      cp_async_commit();
      if (Ring::kUnpacked || L::kFloat) {
        if constexpr (Ring::kUnpacked) Ring::template unpack<kThr, kRows>(stage(kt), tile, tid);
        if constexpr (L::kFloat) x_to_f16<kThr>(x_stage(kt), xh, tid);
        // generic stores, read next by wgmma (async proxy)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
      }
      const float* wsd = ws_stage(kt);
      const float* xsd = xs_stage(kt);
      const int g0 = (kt * kBK) >> gs_log2;
      if constexpr (L::kFloat) {
        // fp8: the warp's A fragments of the slice's 8 k16-steps, from its
        // rows lrow, lrow + 8 of the e4m3 tile (chunk ks of a row holds
        // columns 16 ks .. 16 ks + 15; lane t takes 2t, 2t + 1, 2t + 8,
        // 2t + 9), converted to f16; the f16 activations are B
        const unsigned char* w_s = stage(kt);
        uint32_t af[kBK / 16][4];
#pragma unroll
        for (int ks = 0; ks < kBK / 16; ++ks) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const unsigned short* row = reinterpret_cast<const unsigned short*>(
                w_s + (lrow + 8 * h) * kBK + ((ks ^ gid) << 4));
            af[ks][h] = fp8x2_to_h2(row[t]);
            af[ks][2 + h] = fp8x2_to_h2(row[t + 4]);
          }
        }
        const uint64_t db = sw128_desc(smem_addr(xh));
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kBK / 16; ++ks) {
          const int k = kt * kBK + ks * 16;
          if (k < n) {
            // the k-step's 32 bytes of f16 lie 32 (ks % 4) bytes into the
            // swizzled rows of atom ks / 4
            wgmma_f16(d, af[ks], db + (ks >> 2) * (kXAtomBytes >> 4) + 2 * (ks & 3),
                      (k & (gs - 1)) != 0);
            if (((k + 16) & (gs - 1)) == 0) {
              wgmma_commit_wait();
              const int g = k >> gs_log2;
              finish(g, wsd, xsd, g - g0);
              wgmma_fence();
            }
          }
        }
      } else {
        const uint64_t da =
            sw128_desc(smem_addr(Ring::kUnpacked ? tile : stage(kt)) + wg * 64 * kBK);
        const uint64_t db = sw128_desc(smem_addr(x_stage(kt)));
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kBK / 32; ++ks) {
          const int k = kt * kBK + ks * 32;
          if (k < n) {
            // the k-step's 32 bytes lie 32 ks bytes into the swizzled rows; a
            // group's first k-step starts the sum afresh
            wgmma_s8(d, da + 2 * ks, db + 2 * ks, (k & (gs - 1)) != 0);
            if (((k + 32) & (gs - 1)) == 0) {
              wgmma_commit_wait();
              const int g = k >> gs_log2;
              finish(g, wsd, xsd, g - g0);
              wgmma_fence();
            }
          }
        }
      }
      wgmma_commit_wait();    // the stage's tiles are read before the next barrier frees them
    }
    cp_async_wait<0>();
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = m0 + lrow + (i >> 1) * 8;
        const int col = b0 + 8 * j + 2 * t + (i & 1);
        if (r < m && col < b) out[(size_t)col * m + r] = __fadd_rn(ev[4 * j + i], od[4 * j + i]);
      }
    return;
  }

  // mma.sync (GS 16, integer formats; fp8 runs wgmma at every GS): s32
  // group sums; the scaled terms of even and of odd groups, each added left
  // to right
  int c[2][4][4];
  float even[2][4][4], odd[2][4][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        c[a][j][i] = 0;
        even[a][j][i] = odd[a][j][i] = 0.f;
      }
  // group g, whose scales are entry j0 of the stage's, is complete: its
  // terms into the sums of its parity (one copy of the code for both)
  auto finish_group = [&](int g, const float* wsd, const float* xsd, int j0) {
    const bool is_odd = g & 1;
    float wsc[2][2], xsc[4][2];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        wsc[a][h] = wsd[(wm * 32 + a * 16 + gid + 8 * h) * kScaleStride + j0];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) xsc[j][h] = xsd[(wb * 32 + j * 8 + 2 * t + h) * kScaleStride + j0];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float term = group_term<kXsFirst>(c[a][j][i], wsc[a][i >> 1], xsc[j][i & 1]);
          const float sum = __fadd_rn(is_odd ? odd[a][j][i] : even[a][j][i], term);
          if (is_odd) odd[a][j][i] = sum;
          else even[a][j][i] = sum;
          c[a][j][i] = 0;
        }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) fetch(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();                                  // slice kt's scales
    mbar_wait(bars + 8 * (kt % kStages), (kt / kStages) & 1);    // and its tiles
    __syncthreads();          // everyone's scales are in; slice kt - 1's stage is free
    const int nx = kt + kStages - 1;
    if (nx < nk) fetch(nx);
    cp_async_commit();
    if (Ring::kUnpacked) {
      Ring::template unpack<kThr, kRows>(stage(kt), tile, tid);
      __syncthreads();
    }
    const uint32_t wbase = smem_addr(Ring::kUnpacked ? tile : stage(kt));
    const uint32_t xbase = smem_addr(x_stage(kt));
    const float* wsd = ws_stage(kt);
    const float* xsd = xs_stage(kt);
    const int g0 = (kt * kBK) >> gs_log2;
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      const int k = kt * kBK + ks * 32;
      if (k < n) {
        int af[2][4], bf[4][2];
        const int j8 = lane >> 3;
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int r = wm * 32 + a * 16 + (lane & 7) + (j8 & 1) * 8;
          const int ch = 2 * ks + (j8 >> 1);
          ldmatrix_x4(af[a], wbase + r * kBK + ((ch ^ (r & 7)) << 4));
        }
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int r = wb * 32 + p * 16 + (lane & 7) + (j8 >> 1) * 8;
          const int ch = 2 * ks + (j8 & 1);
          int q[4];
          ldmatrix_x4(q, xbase + r * kBK + ((ch ^ (r & 7)) << 4));
          bf[2 * p][0] = q[0];
          bf[2 * p][1] = q[1];
          bf[2 * p + 1][0] = q[2];
          bf[2 * p + 1][1] = q[3];
        }
        if (gs >= 32) {
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mma_k32(c[a][j], af[a][0], af[a][1], af[a][2], af[a][3], bf[j][0], bf[j][1]);
          if (((k + 32) & (gs - 1)) == 0) {
            const int g = k >> gs_log2;
            finish_group(g, wsd, xsd, g - g0);
          }
        } else {
          // GS 16: columns 0-15 of the step are one group (fragments 0 and
          // 1 of A), 16-31 the next (fragments 2 and 3)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int g = (k >> 4) + h;
            if (g < ng) {
#pragma unroll
              for (int a = 0; a < 2; ++a)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  mma_k32(c[a][j], h ? 0 : af[a][0], h ? 0 : af[a][1], h ? af[a][2] : 0,
                          h ? af[a][3] : 0, bf[j][0], bf[j][1]);
              finish_group(g, wsd, xsd, g - g0);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = m0 + wm * 32 + a * 16 + gid + (i >> 1) * 8;
        const int col = b0 + wb * 32 + j * 8 + 2 * t + (i & 1);
        if (r < m && col < b) out[(size_t)col * m + r] = __fadd_rn(even[a][j][i], odd[a][j][i]);
      }
}

// The driver's tensor-map encoder, looked up once through the runtime (the
// library links no driver library).
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A 2-D byte tensor map: rows of row_bytes (a multiple of 16) at ptr (16-byte
// aligned), boxes of box_x bytes x box_y rows, zeros outside.
bool byte_map(CUtensorMap* tm, const void* ptr, uint64_t row_bytes, uint64_t rows, int box_x,
              int box_y, bool swizzle) {
  const auto encode = tensor_map_encoder();
  if (!encode) return false;
  const cuuint64_t dims[2] = {row_bytes, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_x), static_cast<cuuint32_t>(box_y)};
  const cuuint32_t estr[2] = {1, 1};
  return encode(tm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides, box,
                estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// b at or below which the small design runs; a timing knob (gqmm_set_small_max_b)
int g_small_max_b = kSmallMaxB;

template <class L, int NB, bool kXsFirst>
int launch_small(const void* wq, const void* ws, const void* xq, const void* xs, void* out, int b,
                 int m, int n, int gs_log2, int device, cudaStream_t stream) {
  const auto kernel = gqmm_small_kernel<L, NB, kXsFirst>;
  static bool opted[kMaxDevices] = {};
  cudaError_t err = opt_in(kernel, opted, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(m + kSmallRows - 1) / kSmallRows, kSmallWarps * 32,
           small_smem_bytes(NB, n, n >> gs_log2), stream>>>(
      static_cast<const uint8_t*>(wq), static_cast<const float*>(ws),
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs), static_cast<float*>(out), b,
      m, n, gs_log2);
  return static_cast<int>(cudaGetLastError());
}

template <class L, int WM, bool kXsFirst, bool kWg>
int launch_large(const void* wq, const void* ws, const void* xq, const void* xs, void* out, int b,
                 int m, int n, int gs_log2, int device, cudaStream_t stream) {
  const auto kernel = gqmm_mma_kernel<L, WM, kXsFirst, kWg>;
  static bool opted[kMaxDevices] = {};
  cudaError_t err = opt_in(kernel, opted, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tm_w, tm_x;
  if (!byte_map(&tm_w, wq, L::row_bytes(n), m, TcRing<L>::kSliceBytes, 32 * WM,
                !TcRing<L>::kUnpacked) ||
      !byte_map(&tm_x, xq, n, b, kBK, kLargeCols, true))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((b + kLargeCols - 1) / kLargeCols, (m + 32 * WM - 1) / (32 * WM));
  kernel<<<grid, WM * 64, large_smem_bytes<L>(WM), stream>>>(
      tm_w, tm_x, static_cast<const float*>(ws), static_cast<const float*>(xs),
      static_cast<float*>(out), b, m, n, gs_log2);
  return static_cast<int>(cudaGetLastError());
}

// The design for (b, m, n): small for b <= the cut-over (8-row tiles of
// batch rows: 1 or 2), else large, 128-row tiles where they alone give a
// CTA to every SM, else 64-row tiles (kernels/gqmv.gqmm_design mirrors it).
template <class L, bool kXsFirst>
int run_gqmm_tc(const void* wq, const void* ws, const void* xq, const void* xs, void* out, int b,
                int m, int n, int group_size, int device, void* stream) {
  const int gs_log2 = log2_group(group_size);
  if (bad_args(b, m, n, gs_log2) || device < 0 || device >= kMaxDevices ||
      (m + 63) / 64 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ng = n >> gs_log2;
  if (b <= g_small_max_b && b <= 8 && small_smem_bytes(1, n, ng) <= kMaxSmem)
    return launch_small<L, 1, kXsFirst>(wq, ws, xq, xs, out, b, m, n, gs_log2, device, s);
  if (b <= g_small_max_b && b <= 16 && small_smem_bytes(2, n, ng) <= kMaxSmem)
    return launch_small<L, 2, kXsFirst>(wq, ws, xq, xs, out, b, m, n, gs_log2, device, s);
  // int3 / int4 rows the ring cannot stream (not 16-byte aligned, or n no
  // multiple of 128: a layer slice of an odd shape) run the first design
  if constexpr (L::kMayMisalign) {
    if (!L::ring_ok(wq, n))
      return run_gqmm<typename L::First, kXsFirst>(wq, ws, xq, xs, out, b, m, n, group_size,
                                                   device, stream);
  }
  // wgmma for GS >= 32 (a k-step of 32 columns is whole groups); mma.sync,
  // which can sum half a k-step, at GS 16. fp8's k16-steps are whole groups
  // at every GS: wgmma throughout.
  const bool wide = (long)((m + 127) / 128) * ((b + kLargeCols - 1) / kLargeCols) >= kSms;
#define GQMM_LARGE(WM_, WG_) \
  launch_large<L, WM_, kXsFirst, WG_>(wq, ws, xq, xs, out, b, m, n, gs_log2, device, s)
  if constexpr (L::kFloat) {
    return wide ? GQMM_LARGE(4, true) : GQMM_LARGE(2, true);
  } else {
    if (gs_log2 >= 5) return wide ? GQMM_LARGE(4, true) : GQMM_LARGE(2, true);
    return wide ? GQMM_LARGE(4, false) : GQMM_LARGE(2, false);
  }
#undef GQMM_LARGE
}

}  // namespace

// Every entry point returns cudaGetLastError() after the launch (0 on
// success); the Python wrapper raises on anything else. wq is the format's
// storage: int8 (m, n), int8 (m, n/2), uint8 (m, 3n/8) or e4m3 (m, n).
#define GQMV_ENTRY_POINT(FMT, RUN)                                                           \
  extern "C" int gqmv_##FMT(const void* wq, const void* ws, const void* xq, const void* xs, \
                            void* out, int m, int n, int group_size, int device,            \
                            void* stream) {                                                 \
    return RUN(wq, ws, xq, xs, out, m, n, group_size, device, stream);                      \
  }
#define GQMM_ENTRY_POINT(FMT, RUN)                                                           \
  extern "C" int gqmm_##FMT(const void* wq, const void* ws, const void* xq, const void* xs, \
                            void* out, int b, int m, int n, int group_size, int device,     \
                            void* stream) {                                                 \
    return RUN(wq, ws, xq, xs, out, b, m, n, group_size, device, stream);                   \
  }

GQMV_ENTRY_POINT(int8, (run_gqmv_stream<StreamInt8, Int8Weights>))
GQMV_ENTRY_POINT(int4, (run_gqmv_stream<StreamInt4, Int4Weights>))
GQMV_ENTRY_POINT(int3, (run_gqmv_stream<StreamInt3, Int3Weights>))
GQMV_ENTRY_POINT(fp8, (run_gqmv_stream<StreamFp8, Fp8Weights>))
GQMM_ENTRY_POINT(int8, (run_gqmm_tc<TcInt8, false>))
GQMM_ENTRY_POINT(int4, (run_gqmm_tc<TcInt4, true>))
GQMM_ENTRY_POINT(int3, (run_gqmm_tc<TcInt3, true>))
GQMM_ENTRY_POINT(fp8, (run_gqmm_tc<TcFp8, true>))

// Sets the widest row that takes the streamed GQMV design (at most
// kStreamMaxN; 0 sends every row to the first design, which keeps the
// plain version's arithmetic in another order of f32 sums) and returns the
// previous value. For timing the two designs at one shape.
extern "C" int gqmv_set_stream_max_n(int n) {
  const int prev = g_stream_max_n;
  g_stream_max_n = n < kStreamMaxN ? n : kStreamMaxN;
  return prev;
}

// Sets the largest b that takes the small design of GQMM (both designs
// keep the plain versions' arithmetic; only their times differ) and
// returns the previous value. For timing the two designs at one b.
extern "C" int gqmm_set_small_max_b(int b) {
  const int prev = g_small_max_b;
  g_small_max_b = b;
  return prev;
}
