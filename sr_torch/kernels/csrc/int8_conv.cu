// k x k SAME stride-1 convolution as an implicit GEMM for Hopper (sm_90a),
// NHWC activations, weights packed once by pack_conv_weights, three entries
// on one body:
//
//   raw     int8 x int8 -> int32 (exact: |acc| <= k*k*C*127*127, below 2^26
//                         for the 7x7 64-channel tail conv)
//   raw     bf16 x bf16 -> f32
//   fused   f32 in -> quantize on load -> int8 x int8 -> int32 -> dequantize
//           and bias on store -> f32 out
//
// Replaces sr/kernels/int8_conv.py:_conv3x3_im2col (the pl.pallas_call at
// line 75; entries conv3x3_int8_im2col :93 and conv3x3_bf16_im2col :105),
// which built the (rows*W, 9C) im2col matrix of a 1-padded image in VMEM and
// contracted it in one dot. The raw entries are that kernel's function. The
// fused entry also takes in the arithmetic that sr/quant.py:int8_conv runs
// around it, in the same order and with the same roundings:
//
//   q   = int8(clamp(rint(x / s), -127, 127))     (x * s for the fused
//                                                  tail's reciprocal scale)
//   out = f32(acc) * dq[b, n] + bias[n]
//
// each operation rounded once (__fdiv_rn / __fmul_rn / __fadd_rn: nvcc's
// default -fmad=true would contract a plain a*b+c into an FMA and round
// once), rintf rounding half to even like torch.round, and __int2float_rn
// rounding like .to(torch.float32) (the 7x7 tail's accumulator passes 2^24).
// s is per tensor, per input channel or per sample (a pointer and two
// strides); dq is a (1 or B, N) table the wrapper computes.
//
// What bounds it on the H100 (3.35 TB/s, 1979 int8 TOP/s):
//   * class 1, per tap (C * ES > 8 bytes, or k = 1): bytes. EDSR's body
//     conv 64->64 at b16 128^2 reads 67.1 MB of f32 and writes 67.1 MB of
//     f32, 40 us, against 9.8 us of int8 operations; only the 7x7 64->48
//     tail is bound by operations (40 us). The f32 input must be read once,
//     the output written once, and loads kept in flight all the time.
//   * class 2, tap-packed (C * ES <= 8 bytes and k > 1: the 1- and
//     3-channel heads, a 9x9 over one channel): the f32 output, 64 channels
//     x 4 bytes a pixel against 4-12 bytes of input, so the store path.
//   The boundary is measured (tools/int8_conv_probe.py --class-boundary,
//   H100): tap-packing writes each element k times, so past 8 bytes a
//   pixel it loses: FSRCNN's 3x3 12->12 on (4,280,280) 0.1816 ms
//   tap-packed (6 K steps) against 0.0760 per tap (9), a 5x5 16->16
//   0.3974 against 0.1033.
//
// Design. The former kernel (one block an 8 x 32 output tile, its f32 tile
// staged through registers and quantized there, all weights restaged for
// every tile, a 1.25-1.75x halo re-read, mma.sync) ran its staging,
// weight copy, products and stores one after another; only the SM's second
// block overlapped them (tools/int8_conv_probe.py --former). Here:
//   * A persistent grid, one block an SM, each walking a list of items: an
//     image, a band of R output rows, a column segment of 64 * nwg pixels
//     (nwg = 1 or 2 MMA warpgroups). R and nwg are chosen on the host so
//     that the busiest block costs the least (its rows' quantize or wgmma
//     steps, halo included):
//     EDSR's body at b16 128^2 takes 128 bands of 16 rows, a whole 96x80
//     image 96 bands of one row, so small images fill the card. Each input
//     row of a band is read from memory and quantized once. Plans are kept
//     per size, so a serving call pays for its plan once.
//   * The weights stay resident in shared memory for the whole launch, one
//     bulk copy a block. pack_conv_weights packs them in chunks of 64
//     output channels (32, 16 or 8 where one chunk would not fit), each
//     (tap, 32-byte K step) an N x 32 byte block in wgmma's K-major layout
//     with the 32-byte swizzle. Where all chunks do not fit beside the rings
//     (the 64->256 PS convs), the chunks are split across blocks: block q
//     of each slice walks the same items at the same time, so the second
//     read of an input row hits L2.
//   * Warp specialisation, three roles joined by mbarriers:
//     - one producer warp keeps a staging ring of up to 3 input rows in
//       flight: the 16-byte aligned middle of a row segment is one bulk
//       copy (the TMA engine's one-dimensional form, completion counted in
//       bytes; a row segment of NHWC is one contiguous run, so no tensor
//       map is needed and any C and any alignment take the same path), its
//       unaligned ends 4-byte cp.async copies arriving on the same barrier;
//     - two quantizer warpgroups turn each staged row into a quantized row
//       of a ring of k to k + 2 rows (the same quantize() and division
//       check, the division out of line so it stays off the common path;
//       each thread keeps one group of four channels and its scales for
//       the row), then fence.proxy.async, since wgmma reads the row. They
//       bound most convs: a third warpgroup would leave 80 registers a
//       thread and spill;
//     - the MMA warpgroups, 64 output pixels each, issue every K step of
//       every tap of an output row as wgmma.mma_async m64nNk32 s8 -> s32
//       (bf16: m64nNk16 -> f32; a K step is 32 bytes for both) in one
//       commit group, A and B from shared memory through descriptors,
//       release the ring row no later output row reads, and dequantize, add
//       the bias and store f32 pairs straight from the accumulators.
//     No thread holds a staged value in registers across a copy (what
//     spilled the former persistent-loop attempt), and loads, quantize,
//     products and stores of different rows run at once.
//   * Quantized rows are [16-byte K chunk][pixel][16 bytes]: wgmma's K-major
//     layout without swizzle, core matrices of 8 pixels x 16 bytes, so the
//     A operand of tap column dx is the same rows 16 * dx bytes further: a
//     descriptor start address, for any dx. Class 1: pixel p's K run is its
//     C channels padded to ks * 32 bytes, ks K steps a tap, k * k taps.
//     Class 2: position m's K run is the k * C channels of pixels m ...
//     m + k - 1 (the quantizer writes each element k times, once per
//     window), ceil(k * C * ES / 32) K steps a tap row, k tap rows: a 9x9
//     over one channel takes 9 K steps instead of 81, EDSR's 3x3 head over 3
//     channels 3 instead of 9.
//   * The warpgroup index comes from a shuffle of lane 0, so the compiler
//     keeps the descriptors in uniform registers and a K step costs the
//     wgmma and one 64-bit add; the code is instantiated for five wgmma
//     widths only (8, 16, 32, 48, 64), since a larger kernel thrashed the
//     instruction cache with three roles running different code.
//   * plan() takes the first shared-memory layout that fits: two MMA
//     warpgroups before one, deeper staging before fewer N slices, more
//     ring rows, whole rows before pieces of a row (a 256-channel row is
//     staged in pieces). Convs whose smallest layout does not fit (k = 17 at
//     C = 64, bf16 5x5 over 256 channels) are refused; no path of the port
//     has one.
//
// Plain C interface for ctypes; the launches return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>
#include <type_traits>
#include <vector>

namespace {

constexpr int M_WG = 64;        // output pixels per MMA warpgroup
constexpr int MAX_WG = 2;       // MMA warpgroups per block
constexpr int NCH = 64;         // output channels per weight chunk, at most
#ifndef SR_TAP_PACK_BYTES  // tools/int8_conv_probe.py --class-boundary
#define SR_TAP_PACK_BYTES 8
#endif
constexpr int TAP_PACK_BYTES = SR_TAP_PACK_BYTES;  // C * ES at or below:
                                                   // tap-packed K
constexpr int MAX_STAGES = 3;
constexpr int MAX_SMEM = 232448;  // 227 KB, the most a block may use
constexpr int NQ = 256;         // quantizer threads (two warpgroups)
constexpr int MAX_THREADS = MAX_WG * 128 + NQ + 32;
constexpr int BULK_MAX = 32768;  // bytes per bulk copy instruction

constexpr int LOAD_RAW = 0;    // x holds the MMA type
constexpr int LOAD_QUANT = 1;  // x is f32, quantized to int8 as staged
constexpr int STORE_RAW = 0;      // the accumulator
constexpr int STORE_DEQUANT = 1;  // f32(acc) * dq + bias

template <typename T>
using Acc = typename std::conditional<std::is_same<T, int8_t>::value, int,
                                      float>::type;

struct Params {
  const void* x;
  const void* w;  // packed weight chunks (pack_conv_weights)
  void* out;
  const float* mul;      // quantize: x * mul[b * scale_sb + c * scale_sc]
  const float* divisor;  // or x / divisor[...] (mul its reciprocals), or
                         // null
  const float* dq;       // dequantize: dq[b * dq_sb + n]
  const float* bias;     // (N,) or null
  int scale_sb, scale_sc, dq_sb;
  int B, H, W, C, N, k;
  // the plan, set by plan() on the host
  int packed;         // tap-packed K (few channels): one K run per tap row
  int taps, ks;       // taps (k*k, or k tap rows) and 32-byte K steps each
  int nch, nchunks, last_w;  // outputs a weight chunk (64, or fewer where
                             // one chunk would not fit), chunks, the last
                             // chunk's width
  int chunk_bytes;    // bytes of a full chunk
  int nslices, cps;   // N slices across blocks, chunks per slice
  int nwg, P;         // MMA warpgroups; staged pixels a row (with halo)
  int segs, R, bands, items;  // column segments, band rows, bands, items
  int stages, piece_px;  // staging ring; pixels per staged piece
  int ring_rows, ring_row_bytes;  // quantized rows in the ring, their size
  int stage_bytes;
  int off_ring, off_stage, off_tab, off_bar, smem;
};

__host__ __device__ constexpr int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// wgmma's N for a chunk of n output channels: 8, 16, 32, 48 or 64 (the
// widths the port's convs need; s8 and bf16 take any multiple of 8 here)
__host__ __device__ constexpr int mma_width(int n) {
  return n <= 8 ? 8 : n <= 16 ? 16 : n <= 32 ? 32 : n <= 48 ? 48 : 64;
}

// --------------------------------------------------------------- PTX --

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// the bulk copy engine (TMA, one-dimensional): 16-byte aligned source,
// destination and size; completion counted on the barrier in bytes
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src,
                                          int bytes, unsigned bar) {
  for (int off = 0; off < bytes; off += BULK_MAX) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(dst + off),
        "l"(static_cast<const unsigned char*>(src) + off),
        "r"(min(BULK_MAX, bytes - off)), "r"(bar)
        : "memory");
  }
}

__device__ __forceinline__ void cp_async4(unsigned dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// the barrier's phase also waits for this thread's cp.async copies
__device__ __forceinline__ void cp_async_arrive(unsigned bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// the MMA warpgroups' barrier (the other roles do not take part)
__device__ __forceinline__ void mma_groups_sync(int nthreads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(nthreads) : "memory");
}

// wgmma descriptor of a K-major operand without swizzle: core matrices of
// 8 rows x 16 bytes, 128 contiguous bytes each, 8-row groups 128 bytes
// apart (stride offset) and the two 16-byte K halves of a 32-byte step
// `lead` bytes apart (leading offset). Both operands use it: the weights
// as [half][N rows][16 bytes] blocks, the quantized rows as
// [16-byte K chunk][pixel][16 bytes], so the A operand of tap column dx
// starts dx * 16 bytes further and any shift is a start address.
__device__ __forceinline__ uint64_t desc_k32(unsigned addr, int lead) {
  uint64_t d = 0;
  d |= (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lead >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)(128 >> 4) << 32;
  return d;
}

// wgmma descriptor of a K-major operand with the 32-byte swizzle (the
// weights): rows of 32 bytes (one K step), 8-row atoms of 256 bytes on
// 256-byte boundaries, the 16-byte halves of rows 4-7 of an atom swapped
__device__ __forceinline__ uint64_t desc_sw32(unsigned addr) {
  uint64_t d = 0;
  d |= (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;
  d |= (uint64_t)(256 >> 4) << 32;
  d |= (uint64_t)3 << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// generic-proxy writes to shared memory -> visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keep the compiler from moving accumulator accesses across wgmma's
// asynchronous reads and writes
template <int NR>
__device__ __forceinline__ void fence_regs(int (&d)[NR]) {
#pragma unroll
  for (int i = 0; i < NR; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int NR>
__device__ __forceinline__ void fence_regs(float (&d)[NR]) {
#pragma unroll
  for (int i = 0; i < NR; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x NW, this warpgroup) += A (64 x 32 bytes) * B (32 bytes x NW),
// both from shared memory through descriptors
template <int NW>
__device__ __forceinline__ void wgmma_s8(int (&d)[NW / 2], uint64_t desc_a,
                                         uint64_t desc_b);
template <int NW>
__device__ __forceinline__ void wgmma_bf16(float (&d)[NW / 2],
                                           uint64_t desc_a, uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_s8<8>(
    int (&d)[4], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<16>(
    int (&d)[8], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<32>(
    int (&d)[16], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "%16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]),
        "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<48>(
    int (&d)[24], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]),
        "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(
    int (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]),
        "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<8>(
    float (&d)[4], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<16>(
    float (&d)[8], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<32>(
    float (&d)[16], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<48>(
    float (&d)[24], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(
    float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <int NR>
__device__ __forceinline__ void wgmma(int (&d)[NR], uint64_t desc_a,
                                      uint64_t desc_b) {
  wgmma_s8<2 * NR>(d, desc_a, desc_b);
}
template <int NR>
__device__ __forceinline__ void wgmma(float (&d)[NR], uint64_t desc_a,
                                      uint64_t desc_b) {
  wgmma_bf16<2 * NR>(d, desc_a, desc_b);
}

// ------------------------------------------------------ arithmetic --

// the correctly rounded quotient, out of line: a rare path that the
// compiler must not turn into predicated code on the common one
__device__ __noinline__ float divide_rn(float x, float d) {
  return __fdiv_rn(x, d);
}

// torch.clamp(torch.round(x / d), -127, 127).to(torch.int8) with m the
// correctly rounded 1/d, or with x * m when there is no divisor. x * m is
// within 1.5 * 2^-23 * |x / d| of the correctly rounded quotient, so the
// two round to different integers only when x * m lies that close to a
// half-way point; within 4 * 2^-23 of one (|q - rint(q)| >= 0.5 -
// |q| * 2^-21) the exact division decides. rintf rounds half to even like
// torch.round, and clamping after rounding gives -127 for a NaN, like the
// plain version's clamp.
__device__ __forceinline__ uint32_t quantize(float x, float m, float d,
                                             bool divide) {
  const float q = __fmul_rn(x, m);
  float r = rintf(q);
  if (divide &&
      __builtin_expect(fabsf(q - r) >= fmaf(-fabsf(q), 0x1p-21f, 0.5f), 0)) {
    r = rintf(divide_rn(x, d));
  }
  r = fminf(fmaxf(r, -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<int>(r)) & 0xffu;
}

// ------------------------------------------------------- the kernel --

// shared memory of one block (byte offsets in Params): the resident weight
// slice at 0, the ring of quantized rows, the staging ring, the tables
// (per-channel mul and divisor, the slice's dq and bias), the barriers
struct Smem {
  unsigned char* base;
  const Params& p;
  __device__ unsigned char* ring(int row) const {
    return base + p.off_ring + (row % p.ring_rows) * p.ring_row_bytes;
  }
  __device__ unsigned char* stage(int s) const {
    return base + p.off_stage + s * p.stage_bytes;
  }
  __device__ float* tab() const {
    return reinterpret_cast<float*>(base + p.off_tab);
  }
  __device__ unsigned bar(int i) const {
    return smem_addr(base + p.off_bar) + 8 * i;
  }
  // staging stage s: filled by the producer / emptied by the quantizer
  __device__ unsigned staged(int s) const { return bar(s); }
  __device__ unsigned stage_free(int s) const { return bar(p.stages + s); }
  // quantized row r (a running count): written / read by every MMA warp
  __device__ unsigned quantized(int r) const {
    return bar(2 * p.stages + r % p.ring_rows);
  }
  __device__ unsigned row_free(int r) const {
    return bar(2 * p.stages + p.ring_rows + r % p.ring_rows);
  }
  __device__ unsigned weights() const {
    return bar(2 * p.stages + 2 * p.ring_rows);
  }
};

// Where a piece of one input row lies: image pixels [pa, pb) of row y of
// image b, bytes [g0, g0 + len) of x; empty when the row or the piece lies
// outside the image
struct Piece {
  int pa, pb;
  uintptr_t g0;
  int len;
};

template <int ES>
__device__ __forceinline__ Piece locate(const Params& p, int b, int y,
                                        int xs, int q0, int q1) {
  Piece r;
  r.pa = max(0, xs + q0);
  r.pb = min(p.W, xs + q1);
  if (y < 0 || y >= p.H || r.pa >= r.pb) {
    r.pb = r.pa;
    r.len = 0;
    r.g0 = 0;
    return r;
  }
  r.g0 = reinterpret_cast<uintptr_t>(p.x) +
         (((int64_t)b * p.H + y) * p.W + r.pa) * (int64_t)p.C * ES;
  r.len = (r.pb - r.pa) * p.C * ES;
  return r;
}

// One item's place: image b, output rows [y0, y0 + rows), the column
// segment starting at x0
struct Item {
  int b, y0, rows, x0;
  __device__ Item(const Params& p, int item) {
    const int seg = item % p.segs;
    const int band = (item / p.segs) % p.bands;
    b = item / (p.segs * p.bands);
    y0 = band * p.R;
    rows = min(p.R, p.H - y0);
    x0 = seg * M_WG * p.nwg;
  }
};

// The producer warp: the weight slice once, then every piece of every
// input row of this block's items, in the quantizer's order, through the
// staging ring. The 16-byte aligned middle of a piece is one bulk copy;
// its unaligned ends (a misaligned x, or C * ES not a multiple of 16) are
// 4-byte cp.async copies (f32) or byte copies (raw int8 / bf16).
template <int IN_ES>
__device__ void producer(const Params& p, const Smem& sm, int slice,
                         int first, int step) {
  const int lane = threadIdx.x % 32;
  const int half = p.k / 2;
  if (lane == 0) {
    const int c0 = slice * p.cps;
    const int c1 = min(p.nchunks, c0 + p.cps);
    const int wbytes = (c1 - c0 - 1) * p.chunk_bytes +
                       (c1 == p.nchunks ? p.taps * p.ks * p.last_w * 32
                                        : p.chunk_bytes);
    mbar_expect(sm.weights(), wbytes);
    bulk_copy(smem_addr(sm.base),
              static_cast<const unsigned char*>(p.w) +
                  (int64_t)c0 * p.chunk_bytes,
              wbytes, sm.weights());
  }
  int st = 0, ph = 0;
  for (int item = first; item < p.items; item += step) {
    const Item it(p, item);
    for (int i = 0; i < it.rows + p.k - 1; ++i) {
      for (int q0 = 0; q0 < p.P; q0 += p.piece_px) {
        const Piece pc = locate<IN_ES>(p, it.b, it.y0 - half + i,
                                       it.x0 - half, q0,
                                       min(p.P, q0 + p.piece_px));
        mbar_wait(sm.stage_free(st), ph ^ 1);
        const unsigned dst = smem_addr(sm.stage(st)) + (pc.g0 & 15);
        const uintptr_t a0 = (pc.g0 + 15) & ~uintptr_t(15);
        const uintptr_t a1 = (pc.g0 + pc.len) & ~uintptr_t(15);
        const bool mid = pc.len > 0 && a1 > a0;
        // the unaligned ends: [g0, a0) and [a1, g0 + len), or all of a
        // piece too short for an aligned middle
        const int head = mid ? (int)(a0 - pc.g0) : pc.len;
        const int tail = mid ? (int)(pc.g0 + pc.len - a1) : 0;
        const int tail_at = pc.len - tail;
        for (int e = lane * IN_ES; e < head + tail; e += 32 * IN_ES) {
          const int off = e < head ? e : tail_at + (e - head);
          const unsigned char* src =
              reinterpret_cast<const unsigned char*>(pc.g0) + off;
          if constexpr (IN_ES == 4) {
            cp_async4(dst + off, src);
          } else {
            *(sm.stage(st) + (pc.g0 & 15) + off) = *src;
            if constexpr (IN_ES == 2) {
              *(sm.stage(st) + (pc.g0 & 15) + off + 1) = src[1];
            }
          }
        }
        if constexpr (IN_ES != 4) __threadfence_block();
        cp_async_arrive(sm.staged(st));
        __syncwarp();
        if (lane == 0) {
          const int bytes = mid ? (int)(a1 - a0) : 0;
          mbar_expect(sm.staged(st), bytes);
          if (mid) {
            bulk_copy(dst + (unsigned)(a0 - pc.g0),
                      reinterpret_cast<const void*>(a0), bytes,
                      sm.staged(st));
          }
        }
        if (++st == p.stages) st = 0, ph ^= 1;
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One staged piece (pixels [q0, q1) of the segment's row) -> the quantized
// row, by the quantizer warpgroups (thread t of NQ): zero outside the image
// and past C. Rows are [16-byte K chunk][pixel][16 bytes], so the A operand
// of every tap is a descriptor into them. Class 1 (per tap): pixel p's K
// run is its C channels, zero-padded to ks * 32 bytes. Class 2
// (tap-packed): output position m's K run is the k * C channels of pixels
// m ... m + k - 1, so each element is written k times, once for each
// window it lies in.
template <typename T, int LOAD>
__device__ void fill_piece(const Params& p, const Smem& sm, int t,
                           unsigned char* row, const unsigned char* stage,
                           const Piece& pc, int xs, int q0, int q1, float m_s,
                           float d_s) {
  constexpr int ES = sizeof(T);
  constexpr int IN_ES = LOAD == LOAD_QUANT ? 4 : ES;
  const bool divide = p.divisor != nullptr;
  const float* s_mul = sm.tab();
  const float* s_div = s_mul + round_up(p.C, 4);
  const unsigned char* src0 = stage + (pc.g0 & 15);
  auto value = [&](int x, int c) -> uint32_t {  // one element, its bits
    if (x < pc.pa || x >= pc.pb) return 0u;
    const unsigned char* e =
        src0 + ((int64_t)(x - pc.pa) * p.C + c) * IN_ES;
    if constexpr (LOAD == LOAD_QUANT) {
      const float m = p.scale_sc ? s_mul[c] : m_s;
      const float d = p.scale_sc ? s_div[c] : d_s;
      return quantize(*reinterpret_cast<const float*>(e), m, d, divide);
    } else if constexpr (ES == 1) {
      return *e;
    } else {
      return *reinterpret_cast<const uint16_t*>(e);
    }
  };
  if (p.packed) {  // a whole row is one piece: k * C fits in the staging
    const int mpix = M_WG * p.nwg;
    const int chunks = 2 * p.ks;
    for (int i = t; i < mpix * chunks; i += NQ) {
      const int m = i % mpix, j = i / mpix;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int e = 0; e < 16 / ES; ++e) {
        const int q = 16 / ES * j + e;  // element of the run
        if (q < p.k * p.C) {
          const uint32_t v = value(xs + m + q / p.C, q % p.C);
          w[e * ES / 4] |= v << (8 * (e * ES % 4));
        }
      }
      *reinterpret_cast<uint4*>(row + (j * mpix + m) * 16) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
    return;
  }
  // per tap: four channels a thread, 4 * ES bytes of one 16-byte chunk
  const int groups = p.ks * 32 / ES / 4;
  auto put4 = [&](int px, int c, const uint32_t (&v)[4]) {
    unsigned char* dst =
        row + ((c * ES / 16) * p.P + px) * 16 + c * ES % 16;
    if constexpr (ES == 1) {
      *reinterpret_cast<uint32_t*>(dst) =
          v[0] | (v[1] << 8) | (v[2] << 16) | (v[3] << 24);
    } else {
      *reinterpret_cast<uint2*>(dst) =
          make_uint2(v[0] | (v[1] << 16), v[2] | (v[3] << 16));
    }
  };
  if (LOAD == LOAD_QUANT && p.C % 4 == 0 && (pc.g0 & 15) == 0 &&
      NQ % groups == 0) {
    // 16-byte loads; each thread keeps one group of four channels and its
    // scales for the whole piece
    const int c = 4 * (t % groups);
    const bool real = c < p.C;
    float mv[4], dv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mv[j] = p.scale_sc && real ? s_mul[c + j] : m_s;
      dv[j] = p.scale_sc && real ? s_div[c + j] : d_s;
    }
    // zeros outside the image quantize to 0, so no branch on the pixel
    auto load = [&](int px) {
      const int x = xs + px;
      return real && x >= pc.pa && x < pc.pb
                 ? *reinterpret_cast<const float4*>(
                       src0 + ((int64_t)(x - pc.pa) * p.C + c) * 4)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    };
    auto store = [&](int px, const float4& f) {
      const uint32_t v[4] = {quantize(f.x, mv[0], dv[0], divide),
                             quantize(f.y, mv[1], dv[1], divide),
                             quantize(f.z, mv[2], dv[2], divide),
                             quantize(f.w, mv[3], dv[3], divide)};
      put4(px, c, v);
    };
    // four pixels an iteration, their loads first: 16 values in flight
    const int step = NQ / groups;
    int px = q0 + t / groups;
    for (; px + 3 * step < q1; px += 4 * step) {
      const float4 f0 = load(px), f1 = load(px + step);
      const float4 f2 = load(px + 2 * step), f3 = load(px + 3 * step);
      store(px, f0);
      store(px + step, f1);
      store(px + 2 * step, f2);
      store(px + 3 * step, f3);
    }
    for (; px < q1; px += step) store(px, load(px));
    return;
  }
  for (int i = t; i < (q1 - q0) * groups; i += NQ) {
    const int px = q0 + i / groups, c = 4 * (i % groups);
    uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (c + j < p.C) v[j] = value(xs + px, c + j);
    }
    put4(px, c, v);
  }
}

// The quantizer warpgroups: each staged row, piece by piece, into the ring
// of quantized rows, running ahead of the MMA warpgroups by as many rows
// as the ring has beyond k.
template <typename T, int LOAD>
__device__ void quantizer(const Params& p, const Smem& sm, int first,
                          int step) {
  constexpr int IN_ES = LOAD == LOAD_QUANT ? 4 : (int)sizeof(T);
  const int t = threadIdx.x - p.nwg * 128, lane = t % 32;
  const int half = p.k / 2;
  int st = 0, ph = 0, r = 0;
  for (int item = first; item < p.items; item += step) {
    const Item it(p, item);
    float m_s = 1.f, d_s = 1.f;  // a per-tensor or per-sample scale
    if (LOAD == LOAD_QUANT && !p.scale_sc) {
      m_s = __ldg(p.mul + (int64_t)it.b * p.scale_sb);
      if (p.divisor) d_s = __ldg(p.divisor + (int64_t)it.b * p.scale_sb);
    }
    for (int i = 0; i < it.rows + p.k - 1; ++i, ++r) {
      mbar_wait(sm.row_free(r), ((r / p.ring_rows) & 1) ^ 1);
      unsigned char* row = sm.ring(r);
      for (int q0 = 0; q0 < p.P; q0 += p.piece_px) {
        const int q1 = min(p.P, q0 + p.piece_px);
        const Piece pc = locate<IN_ES>(p, it.b, it.y0 - half + i,
                                       it.x0 - half, q0, q1);
        mbar_wait(sm.staged(st), ph);
        fill_piece<T, LOAD>(p, sm, t, row, sm.stage(st), pc, it.x0 - half,
                            q0, q1, m_s, d_s);
        __syncwarp();
        if (lane == 0) mbar_arrive(sm.stage_free(st));
        if (++st == p.stages) st = 0, ph ^= 1;
      }
      fence_async_shared();  // the row is wgmma's A operand
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.quantized(r));
    }
  }
}

// Output row oy (its first input row is quantized row r0), one chunk of NW
// output channels (n0 ...): every K step of every tap as wgmma m64nNWk32
// of this warpgroup's 64 pixels in one commit group, A and B from shared
// memory; after the slice's last chunk each warp arrives on `release` (the
// ring row no later output row reads); then the epilogue straight from the
// accumulators.
template <typename T, int STORE, int NW>
__device__ void out_chunk(const Params& p, const Smem& sm, int wg, int r0,
                          int b, int oy, int x0, unsigned wchunk, int n0,
                          int nslice0, bool last, unsigned release) {
  using OutT = typename std::conditional<STORE == STORE_RAW, Acc<T>,
                                         float>::type;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  Acc<T> acc[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0;
  fence_regs(acc);
  // A of tap (dy, dx), step s: ring row r0 + dy, K chunk 2s, pixel
  // 64 * wg + dx (class 2: position 64 * wg, and dx = 0). Descriptors step
  // by adding to their address field (16-byte units).
  const int lead = p.packed ? M_WG * p.nwg * 16 : p.P * 16;
  const unsigned ring0 = smem_addr(sm.base + p.off_ring) + M_WG * wg * 16;
  const int kcols = p.packed ? 1 : p.k, ks = p.ks;
  const uint64_t step_a = (uint64_t)(2 * lead) >> 4;
  uint64_t desc_b = desc_sw32(wchunk);
  const uint64_t step_b = NW * 32 >> 4;
  int slot = r0 % p.ring_rows;
  wgmma_fence();
  for (int dy = 0; dy < p.k; ++dy) {
    uint64_t desc_a = desc_k32(ring0 + slot * p.ring_row_bytes, lead);
    for (int dx = 0; dx < kcols; ++dx, ++desc_a) {
      uint64_t da = desc_a;
      for (int s = 0; s < ks; ++s, da += step_a, desc_b += step_b) {
        wgmma(acc, da, desc_b);
      }
    }
    slot = slot + 1 == p.ring_rows ? 0 : slot + 1;
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  if (last) {
    __syncwarp();
    if (lane == 0) mbar_arrive(release);
  }

  // accumulator i: pixel row 16 * warp + lane / 4 (+ 8 for (i >> 1) & 1),
  // output channel 8 * (i / 4) + 2 * (lane % 4) + (i & 1)
  const float* s_dq = sm.tab() + 2 * round_up(p.C, 4);
  const float* s_bias = s_dq + p.cps * p.nch;
  OutT* out = static_cast<OutT*>(p.out);
#pragma unroll
  for (int i = 0; i < NW / 2; i += 2) {
    const int x = x0 + M_WG * wg + 16 * warp + (lane >> 2) +
                  8 * ((i >> 1) & 1);
    const int n = n0 + 8 * (i / 4) + 2 * (lane & 3);
    if (x >= p.W || n >= p.N) continue;
    OutT v[2];
    if constexpr (STORE == STORE_DEQUANT) {
      const int ns = n - nslice0;  // even: dq and bias pairs are aligned
      const float2 dq = *reinterpret_cast<const float2*>(s_dq + ns);
      const float2 bias = *reinterpret_cast<const float2*>(s_bias + ns);
      v[0] = __fmul_rn(__int2float_rn(acc[i]), dq.x);
      v[1] = __fmul_rn(__int2float_rn(acc[i + 1]), dq.y);
      if (p.bias != nullptr) {
        v[0] = __fadd_rn(v[0], bias.x);
        v[1] = __fadd_rn(v[1], bias.y);
      }
    } else {
      v[0] = acc[i];
      v[1] = acc[i + 1];
    }
    OutT* o = out + (((int64_t)b * p.H + oy) * p.W + x) * p.N + n;
    if (n + 1 < p.N && p.N % 2 == 0) {
      if constexpr (std::is_same<OutT, int>::value) {
        *reinterpret_cast<int2*>(o) = make_int2(v[0], v[1]);
      } else {
        *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
      }
    } else {
      o[0] = v[0];
      if (n + 1 < p.N) o[1] = v[1];
    }
  }
}

// Output row oy for every chunk of the block's slice; `release` is
// arrived on once the last chunk has read its ring rows
template <typename T, int STORE>
__device__ void out_row(const Params& p, const Smem& sm, int wg, int r0,
                        int b, int oy, int x0, int slice, unsigned release) {
  const int c0 = slice * p.cps, c1 = min(p.nchunks, c0 + p.cps);
  const unsigned wbase = smem_addr(sm.base);
  for (int c = c0; c < c1; ++c) {
    const unsigned wchunk = wbase + (c - c0) * p.chunk_bytes;
    const int nw = c + 1 == p.nchunks ? p.last_w : p.nch;
    const int n0 = c * p.nch, ns0 = c0 * p.nch;
    const bool last = c + 1 == c1;
    switch (nw) {
      case 8: out_chunk<T, STORE, 8>(p, sm, wg, r0, b, oy, x0, wchunk, n0,
                                     ns0, last, release); break;
      case 16: out_chunk<T, STORE, 16>(p, sm, wg, r0, b, oy, x0, wchunk, n0,
                                       ns0, last, release); break;
      case 32: out_chunk<T, STORE, 32>(p, sm, wg, r0, b, oy, x0, wchunk, n0,
                                       ns0, last, release); break;
      case 48: out_chunk<T, STORE, 48>(p, sm, wg, r0, b, oy, x0, wchunk, n0,
                                       ns0, last, release); break;
      default: out_chunk<T, STORE, 64>(p, sm, wg, r0, b, oy, x0, wchunk, n0,
                                       ns0, last, release); break;
    }
  }
}

// The MMA warpgroups: each output row once its k quantized rows are in the
// ring, releasing the row that no later output row reads
template <typename T, int LOAD, int STORE>
__device__ void mma_warpgroup(const Params& p, const Smem& sm, int slice,
                              int first, int step) {
  // warp-uniform (a shuffle from lane 0), so that the descriptors built
  // from it stay in uniform registers
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int lane = threadIdx.x % 32;
  const int nthreads = p.nwg * 128;
  const int c0 = slice * p.cps;
  const int nslice = min(p.N - c0 * p.nch, p.cps * p.nch);
  float* s_dq = sm.tab() + 2 * round_up(p.C, 4);
  float* s_bias = s_dq + p.cps * p.nch;
  bool weights = false;
  int r = 0;  // quantized rows consumed before this item
  for (int item = first; item < p.items; item += step) {
    const Item it(p, item);
    if constexpr (LOAD == LOAD_QUANT) {
      mma_groups_sync(nthreads);  // the previous item's epilogues are done
      for (int n = threadIdx.x; n < nslice; n += nthreads) {
        s_dq[n] = __ldg(p.dq + (int64_t)it.b * p.dq_sb + c0 * p.nch + n);
        s_bias[n] = p.bias ? __ldg(p.bias + c0 * p.nch + n) : 0.f;
      }
      mma_groups_sync(nthreads);
    }
    const bool active = it.x0 + M_WG * wg < p.W;  // a pixel of this WG
    for (int j = 0; j < it.rows; ++j) {
      // the quantizer arrives row by row, so its newest row's phase covers
      // the k - 1 rows above it
      const int newest = r + j + p.k - 1;
      mbar_wait(sm.quantized(newest), (newest / p.ring_rows) & 1);
      // row r + j is read last by this output row (released inside
      // out_row once read); the halo rows below the band's last output
      // row go after it
      if (!active) {
        __syncwarp();
        if (lane == 0) mbar_arrive(sm.row_free(r + j));
      } else {
        if (!weights) {
          mbar_wait(sm.weights(), 0);
          weights = true;
        }
        out_row<T, STORE>(p, sm, wg, r + j, it.b, it.y0 + j, it.x0, slice,
                          sm.row_free(r + j));
      }
      if (j + 1 == it.rows) {
        __syncwarp();
        if (lane == 0) {
          for (int e = 1; e < p.k; ++e) mbar_arrive(sm.row_free(r + j + e));
        }
      }
    }
    r += it.rows + p.k - 1;
  }
}

// One persistent block: nwg MMA warpgroups, one quantizer warpgroup and one
// producer warp walk the same list of items (image, band of R output rows,
// column segment of 64 * nwg pixels); block q of slice s takes items q,
// q + G, ... where G = gridDim.x / nslices, with the weights of
// output-channel slice s resident for the whole launch.
template <typename T, int LOAD, int STORE>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    conv_kernel(const __grid_constant__ Params p) {
  constexpr int IN_ES = LOAD == LOAD_QUANT ? 4 : (int)sizeof(T);
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned, and derived from the __shared__ array so that its
  // accesses compile to shared-memory instructions
  const Smem sm{smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023),
                p};
  const int slice = blockIdx.x % p.nslices;
  const int first = blockIdx.x / p.nslices;
  const int step = gridDim.x / p.nslices;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(sm.staged(s), 33);      // the producer's lanes + its bytes
      mbar_init(sm.stage_free(s), NQ / 32);  // the quantizer's warps
    }
    for (int r = 0; r < p.ring_rows; ++r) {
      mbar_init(sm.quantized(r), NQ / 32);    // the quantizer's warps
      mbar_init(sm.row_free(r), p.nwg * 4);   // every MMA warp
    }
    mbar_init(sm.weights(), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  float* tab = sm.tab();
  if (LOAD == LOAD_QUANT && p.scale_sc) {  // per-channel scales, once
    const int cp4 = round_up(p.C, 4);
    for (int c = threadIdx.x; c < cp4; c += blockDim.x) {
      tab[c] = c < p.C ? __ldg(p.mul + c) : 1.f;
      tab[cp4 + c] = c < p.C && p.divisor ? __ldg(p.divisor + c) : 1.f;
    }
  }
  __syncthreads();

  if (threadIdx.x >= p.nwg * 128 + NQ) {
    producer<IN_ES>(p, sm, slice, first, step);
  } else if (threadIdx.x >= p.nwg * 128) {
    quantizer<T, LOAD>(p, sm, first, step);
  } else {
    mma_warpgroup<T, LOAD, STORE>(p, sm, slice, first, step);
  }
}

// ------------------------------------------------------------ host --

// Shared memory of the smallest plan: one MMA warpgroup, one staging
// stage of one pixel (a whole row when tap-packed; 4 bytes an element), k
// quantized rows, one chunk of weights a block (ops.py:_conv_smem_floor)
int smem_floor(const Params& p) {
  const int w = p.taps * p.ks * 32 * (p.nchunks > 1 ? p.nch : p.last_w);
  const int P = M_WG + p.k - 1;
  const int ring_row = round_up((p.packed ? M_WG : P) * p.ks * 32, 256);
  const int stage = round_up((p.packed ? P : 1) * p.C * 4 + 32, 128);
  return round_up(w, 256) + p.k * ring_row + stage +
         round_up((2 * round_up(p.C, 4) + 2 * p.nch) * 4, 16) +
         8 * (3 + 2 * p.k) + 1024;
}

// The shape class and the packing: the fields of Params that
// pack_conv_weights's layout fixes (ops.py:conv_layout). Chunks hold 64
// outputs, or 32, 16, 8 where the smallest plan of a 64-wide chunk would
// not fit (the bf16 7x7 over 64 channels).
template <typename T>
void packing(Params& p) {
  constexpr int ES = sizeof(T);
  p.packed = p.k > 1 && p.C * ES <= TAP_PACK_BYTES;
  p.taps = p.packed ? p.k : p.k * p.k;
  p.ks = ((p.packed ? p.k : 1) * p.C * ES + 31) / 32;
  for (p.nch = NCH;; p.nch /= 2) {
    p.nchunks = (p.N + p.nch - 1) / p.nch;
    p.last_w = mma_width(p.N - (p.nchunks - 1) * p.nch);
    p.chunk_bytes = p.taps * p.ks * p.nch * 32;
    if (p.nch == 8 || smem_floor(p) <= MAX_SMEM) break;
  }
}

// Shared memory for one candidate plan; returns the total
template <typename T, int LOAD>
int layout(Params& p) {
  constexpr int ES = sizeof(T);
  constexpr int IN_ES = LOAD == LOAD_QUANT ? 4 : ES;
  const int c1 = std::min(p.nchunks, p.cps);  // slice 0 is the largest
  const int wbytes = (c1 - 1) * p.chunk_bytes +
                     (c1 == p.nchunks ? p.taps * p.ks * p.last_w * 32
                                      : p.chunk_bytes);
  p.ring_row_bytes =
      round_up((p.packed ? M_WG * p.nwg : p.P) * p.ks * 32, 256);
  p.stage_bytes = round_up(p.piece_px * p.C * IN_ES + 32, 128);
  p.off_ring = round_up(wbytes, 256);
  p.off_stage = p.off_ring + p.ring_rows * p.ring_row_bytes;
  p.off_tab = p.off_stage + p.stages * p.stage_bytes;
  p.off_bar = p.off_tab +
              round_up((2 * round_up(p.C, 4) + 2 * p.cps * p.nch) * 4, 16);
  p.smem = p.off_bar + 8 * (2 * p.stages + 2 * p.ring_rows + 1) +
           1024;  // + base alignment
  return p.smem;
}

// The first plan that fits, in order of preference: two MMA warpgroups
// (when the image is wider than 64 pixels), then the deepest staging ring,
// then the fewest N slices, then the most quantized rows (k + 2 lets the
// quantizer run two rows ahead), whole rows staged. Else (a 256-channel
// row) k quantized rows and the largest pieces of a row that fit.
template <typename T, int LOAD>
bool plan(Params& p, int max_nwg) {
  packing<T>(p);
  for (int whole = 1; whole >= 0; --whole) {
    for (int nwg = std::min(max_nwg, p.W > M_WG ? MAX_WG : 1); nwg >= 1;
         --nwg) {
      p.nwg = nwg;
      p.P = M_WG * nwg + p.k - 1;
      for (int ns = 1; ns <= p.nchunks; ++ns) {
        p.nslices = ns;
        p.cps = (p.nchunks + ns - 1) / ns;
        if ((p.nchunks + p.cps - 1) / p.cps != ns) continue;
        for (int stages = MAX_STAGES; stages >= (whole ? 2 : 1); --stages) {
          p.stages = stages;
          if (whole) {
            p.piece_px = p.P;
            for (p.ring_rows = p.k + 2; p.ring_rows >= p.k; --p.ring_rows) {
              if (layout<T, LOAD>(p) <= MAX_SMEM) return true;
            }
          } else if (!p.packed) {  // class 2 stages whole rows
            p.ring_rows = p.k;
            for (p.piece_px = p.P - 1; p.piece_px >= 16; --p.piece_px) {
              if (layout<T, LOAD>(p) <= MAX_SMEM) return true;
            }
          }
        }
      }
    }
  }
  // the smallest plan (smem_floor)
  p.nwg = 1;
  p.P = M_WG + p.k - 1;
  p.nslices = p.nchunks;
  p.cps = 1;
  p.stages = 1;
  p.ring_rows = p.k;
  p.piece_px = p.packed ? p.P : 1;
  return layout<T, LOAD>(p) <= MAX_SMEM;
}

// The cost of a row, in quantized values: its values plus a handoff
// between the roles (a 130 x 64-value row took ~6,000 cycles on the H100,
// the handoff ~2,000), or its wgmma steps (~120 cycles each) when those
// take longer
constexpr int ROW_OVERHEAD = 2800;
constexpr int STEP_COST = 170;

// Rows per band: the fewest rows the busiest block walks, halo included,
// with G blocks a slice; returns the busiest block's cost
int64_t bands(Params& p, int blocks, int es) {
  p.segs = (p.W + M_WG * p.nwg - 1) / (M_WG * p.nwg);
  int64_t best = -1;
  for (int r = 1; r <= p.H; ++r) {
    const int nb = (p.H + r - 1) / r;
    if (r > 1 && (p.H + r - 2) / (r - 1) == nb) continue;  // same bands
    const int64_t items = (int64_t)p.B * nb * p.segs;
    const int64_t cost = (items + blocks - 1) / blocks * (r + p.k - 1);
    if (best < 0 || cost <= best) {
      best = cost;
      p.R = r;
    }
  }
  p.bands = (p.H + p.R - 1) / p.R;
  p.items = p.B * p.bands * p.segs;
  const int64_t quantize = ROW_OVERHEAD + (int64_t)p.P * p.ks * 32 / es;
  const int64_t mma = (int64_t)STEP_COST * p.taps * p.ks * p.cps;
  return best * std::max(quantize, mma);
}

// A launch's plan: the layout, the occupancy and the bands, for the sizes
// of p on the current device. Two MMA warpgroups (128-pixel segments), or
// one (64) where its busiest block costs a tenth less (a 160-pixel row is
// 128 + 32 or 3 x 64).
template <typename T, int LOAD, int STORE>
cudaError_t make_plan(Params& p, int& grid, int& per_sm) {
  const void* kernel = (const void*)conv_kernel<T, LOAD, STORE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  int64_t best = -1;
  for (int nwg = MAX_WG; nwg >= 1; --nwg) {
    Params q = p;
    if (!plan<T, LOAD>(q, nwg) || q.nwg != nwg) continue;
    int occupancy = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occupancy, kernel, q.nwg * 128 + NQ + 32, q.smem);
    if (err != cudaSuccess) return err;
    if (occupancy < 1) continue;
    const int blocks = std::max(1, sms * occupancy / q.nslices);
    const int64_t cost = bands(q, blocks, (int)sizeof(T));
    if (best < 0 || 10 * cost < 9 * best) {
      best = cost;
      grid = (int)std::min<int64_t>(blocks, q.items) * q.nslices;
      per_sm = occupancy;
      p = q;
    }
  }
  return best < 0 ? cudaErrorInvalidValue : cudaSuccess;
}

// Plans depend on the sizes and the device only, and finding one (the
// layout search, the occupancy query, the band choice) costs host time on
// every call of a serving path; each is made once and kept.
struct Planned {
  int key[7];
  Params p;
  int grid, per_sm;
};

template <typename T, int LOAD, int STORE>
cudaError_t planned(Params& p, int& grid, int& per_sm) {
  static std::mutex mutex;
  static std::vector<Planned> cache;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int key[7] = {p.B, p.H, p.W, p.C, p.N, p.k, dev};
  std::lock_guard<std::mutex> lock(mutex);
  for (const Planned& c : cache) {
    if (std::equal(key, key + 7, c.key)) {
      Params q = c.p;  // the plan, with this call's tensors and scales
      q.x = p.x, q.w = p.w, q.out = p.out, q.mul = p.mul;
      q.divisor = p.divisor, q.dq = p.dq, q.bias = p.bias;
      q.scale_sb = p.scale_sb, q.scale_sc = p.scale_sc, q.dq_sb = p.dq_sb;
      p = q;
      grid = c.grid, per_sm = c.per_sm;
      return cudaSuccess;
    }
  }
  err = make_plan<T, LOAD, STORE>(p, grid, per_sm);
  if (err == cudaSuccess && cache.size() < 1024) {
    Planned c{{}, p, grid, per_sm};
    std::copy(key, key + 7, c.key);
    cache.push_back(c);
  }
  return err;
}

template <typename T, int LOAD, int STORE>
cudaError_t launch(Params p, int kp, cudaStream_t s) {
  if (p.k < 1 || p.k % 2 == 0 || p.C < 1 || p.N < 1 || p.B > 65535) {
    return cudaErrorInvalidValue;
  }
  packing<T>(p);
  if (kp != p.ks * 32 / (int)sizeof(T)) return cudaErrorInvalidValue;
  if (p.B == 0 || p.H == 0 || p.W == 0) return cudaSuccess;
  int grid = 0, per_sm = 0;
  const cudaError_t err = planned<T, LOAD, STORE>(p, grid, per_sm);
  if (err != cudaSuccess) return err;
  conv_kernel<T, LOAD, STORE><<<grid, p.nwg * 128 + NQ + 32, p.smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Raw accumulator. dtype: 0 = int8 in, int32 out; 1 = bfloat16 in, float32
// out. x is (B, H, W, C) and out (B, H, W, N), both contiguous; w is
// pack_conv_weights's layout and kp its K elements per tap, k odd. Returns
// a cudaError_t (cudaErrorInvalidValue for an even k, C < 1, N < 1, a kp
// that is not the packing's, B > 65535, or a weight chunk too large to
// stay resident in shared memory).
extern "C" int sr_conv_im2col(const void* x, const void* w, void* out, int B,
                              int H, int W, int C, int kp, int N, int k,
                              int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p{};
  p.x = x;
  p.w = w;
  p.out = out;
  p.B = B;
  p.H = H;
  p.W = W;
  p.C = C;
  p.N = N;
  p.k = k;
  if (dtype == 0) return (int)launch<int8_t, LOAD_RAW, STORE_RAW>(p, kp, s);
  if (dtype == 1) {
    return (int)launch<__nv_bfloat16, LOAD_RAW, STORE_RAW>(p, kp, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Fused int8 conv: x f32 (B, H, W, C) -> out f32 (B, H, W, N), both
// contiguous; w int8 packed as for sr_conv_im2col. The input is quantized
// as x / divisor[b * scale_sb + c * scale_sc], with mul holding the correctly
// rounded reciprocals in the same layout, or as x * mul[...] when divisor
// is null. The accumulator is dequantized with dq[b * dq_sb + n] and bias[n]
// is added when bias is not null. Returns a cudaError_t.
extern "C" int sr_conv_int8_fused(const void* x, const void* w, void* out,
                                  const void* mul, const void* divisor,
                                  int scale_sb, int scale_sc, const void* dq,
                                  int dq_sb, const void* bias, int B, int H,
                                  int W, int C, int kp, int N, int k,
                                  void* stream) {
  Params p{};
  p.x = x;
  p.w = w;
  p.out = out;
  p.mul = static_cast<const float*>(mul);
  p.divisor = static_cast<const float*>(divisor);
  p.scale_sb = scale_sb;
  p.scale_sc = scale_sc;
  p.dq = static_cast<const float*>(dq);
  p.dq_sb = dq_sb;
  p.bias = static_cast<const float*>(bias);
  p.B = B;
  p.H = H;
  p.W = W;
  p.C = C;
  p.N = N;
  p.k = k;
  return (int)launch<int8_t, LOAD_QUANT, STORE_DEQUANT>(
      p, kp, static_cast<cudaStream_t>(stream));
}

// The plan a launch of these sizes takes (dtype 0 raw int8, 1 raw bf16,
// 2 fused), into out[0..11]: tap-packed, K steps, MMA warpgroups,
// staging stages, pixels a staged piece, quantized ring rows, N slices,
// band rows, items a slice, shared memory bytes, blocks, blocks an SM.
// Returns a cudaError_t as a launch would.
extern "C" int sr_conv_plan(int B, int H, int W, int C, int N, int k,
                            int dtype, int* out) {
  Params p{};
  p.B = B;
  p.H = H;
  p.W = W;
  p.C = C;
  p.N = N;
  p.k = k;
  int grid = 0, per_sm = 0;
  cudaError_t err;
  if (dtype == 0) {
    packing<int8_t>(p);
    err = planned<int8_t, LOAD_RAW, STORE_RAW>(p, grid, per_sm);
  } else if (dtype == 1) {
    packing<__nv_bfloat16>(p);
    err = planned<__nv_bfloat16, LOAD_RAW, STORE_RAW>(p, grid, per_sm);
  } else {
    packing<int8_t>(p);
    err = planned<int8_t, LOAD_QUANT, STORE_DEQUANT>(p, grid, per_sm);
  }
  if (err != cudaSuccess) return (int)err;
  const int v[12] = {p.packed, p.ks,      p.nwg, p.stages, p.piece_px,
                     p.ring_rows, p.nslices, p.R, p.items, p.smem,
                     grid,     per_sm};
  for (int i = 0; i < 12; ++i) out[i] = v[i];
  return (int)cudaSuccess;
}

extern "C" const char* sr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
