// EDSR residual block for Hopper (sm_90a), inference only:
//
//   out = x + res_scale * (conv2(relu(conv1(x) + b1)) + b2)
//
// with both convs 3x3, stride 1, zero padding 1 (SAME), NHWC activations,
// f32 accumulation, f32 biases added before the cast, and the intermediate
// stored in the activation dtype -- the arithmetic of the TPU kernel.
//
// Replaces sr/kernels/fused_resblock.py:_resblock_kernel (the pl.pallas_call
// at line 119), which kept a whole image and both padded intermediates in
// VMEM and ran each conv as row-tiled (rows*W, 9C) @ (9C, C) im2col matmuls.
//
// Bound: operations. Two convs of 2*B*H*W*9C*C flops each; at B=16, 128x128,
// C=64 in bf16 that is 38.7 GFLOP, about 39 us at the H100's 989 TFLOP/s,
// against about 20 us to read x and write out once at 3.35 TB/s. In f32 on
// the CUDA cores (67 TFLOP/s) the same work takes at least 0.58 ms.
//
// bf16: one persistent launch per block, the intermediate on chip, wgmma.
//   * One block of four warpgroups per SM. It copies w1 and w2 into shared
//     memory once (147,456 bytes), in wgmma's canonical K-major layout with
//     the 128-byte swizzle: per tap a 64 x 64 matrix, row n = output channel
//     holding its 64 input channels (128 bytes), 16-byte chunk j stored at
//     j ^ (n % 8). The wrapper packs that layout once (zero rows and columns
//     past C, so C = 16, 32, 48 run the same n64 products) and caches it.
//   * Per output tile of 12 x 16 pixels:
//       1. cp.async copies the input tile with a 2-pixel halo (16 x 20 px,
//          40,960 bytes) into shared memory, zero-filled outside the image.
//       2. conv1 over the tile plus a 1-pixel halo, 14 x 18 = 252 pixels,
//          four M blocks of 64 rows, one per warpgroup (the last four rows
//          are padding). The halo is recomputed, 31% more conv1 work than
//          the 192 output pixels need, instead of exchanged. Epilogue: + b1
//          in f32, ReLU, one rounding to bf16, and zero where the pixel lies
//          outside the image (conv2's SAME padding, not relu(b1)); the
//          result stays in shared memory (32,256 bytes).
//       3. conv2 from that intermediate, three M blocks of 64 output pixels
//          on warpgroups 0-2.
//       4. Epilogue out = bf16(f32(x) + f32(bf16((acc + b2) * rs))), the
//          residual x read from the staged input tile; each thread writes
//          its result over its own residual, and after a barrier the block
//          copies the 12 x 16 tile out in 16-byte vectors.
//   * Products: wgmma.mma_async m64n64k16 bf16 -> f32, B from shared memory
//     through a matrix descriptor (start address, 1024-byte stride between
//     8-row groups, 128-byte swizzle; a k16 step advances the start by 32
//     bytes), A from registers, loaded with ldmatrix.x4 from the staged
//     pixels: per-lane row addresses gather the shifted 3x3 windows (the
//     implicit GEMM), and the activation rows carry the same XOR swizzle so
//     the eight rows of one ldmatrix fall in distinct banks. The A fragments
//     of the next tap load while the current tap's four wgmmas run (two
//     register sets, wgmma.wait_group 1).
//   * Shared memory: 147,456 + 40,960 + 32,256 = 220,672 bytes (+1 KB to
//     align the swizzle atoms), under the 227 KB a block may use. No room is
//     left to double-buffer the input tile, and its copy is not overlapped
//     with the products. Overlapping it with conv2 (warpgroup 3 idle there
//     copying the next tile, the epilogue storing straight from the
//     accumulators with the residual read from device memory) measured
//     slower.
//
// f32: tensor cores would round to TF32, so the products run on the CUDA
//   cores, register-tiled: each thread computes 8 pixels x C/8 output
//   channels, 64 FMAs for every 16 shared-memory words it loads. A load
//   instruction costs one shared-memory wavefront per 32-bit word a thread
//   takes (a float4 costs four, broadcast or not), so the loads here are
//   32-bit broadcasts: a warp's 8 channel groups read 8 consecutive weight
//   words (channels cg + 8q), its 4 pixel groups 4 pixel words in distinct
//   banks. 16 wavefronts per 64 FMA instructions per warp match the SM's
//   one wavefront and four FMA instructions a cycle; 4-pixel x C/8 layouts
//   spent 12 wavefronts per 32 FMAs and ran at 44% of the FMA rate. One
//   conv's f32 weights are 147,456 bytes at C=64, so both do not fit in
//   shared memory beside a tile: f32 keeps two launches of one conv kernel
//   (16 x 16 output pixels a tile, 231,696 bytes of shared memory, weights
//   loaded once per persistent block), the first writing relu(conv1 + b1)
//   to a scratch tensor that the wrapper allocates.
//
// Also here: sr_wgmma_matmul, one 64 x 64 x 64 product through the same
// ldmatrix / descriptor / wgmma helpers, to test them against a plain
// matmul.
//
// C must be 16, 32, 48 or 64; the wrapper checks. Plain C interface for
// ctypes; each entry returns cudaGetLastError() after its launches (or the
// first error met).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------- helpers --

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// generic-proxy writes to shared memory -> visible to wgmma's operand reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 128-byte rows (64 bf16), 16-byte chunk j of row p stored at j ^ (p % 8):
// the layout of the weights (wgmma's 128-byte swizzle) and of the staged
// activations (conflict-free ldmatrix)
__device__ __forceinline__ unsigned swz(int p, int j) {
  return (unsigned)(p * 128 + ((j ^ (p & 7)) << 4));
}

// wgmma matrix descriptor of a K-major, 128-byte-swizzled operand at `addr`
// (shared, 1024-byte aligned atom rows of 8 x 128 bytes)
__device__ __forceinline__ uint64_t desc_sw128(unsigned addr) {
  uint64_t d = 0;
  d |= (uint64_t)((addr & 0x3FFFF) >> 4);  // start address
  d |= (uint64_t)1 << 16;                  // leading offset (unused here)
  d |= (uint64_t)(1024 >> 4) << 32;        // stride between 8-row groups
  d |= (uint64_t)1 << 62;                  // 128-byte swizzle
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

// keep the compiler from moving accumulator accesses across wgmma's
// asynchronous reads and writes
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// keep an A fragment's registers live until wgmma.wait_group says the
// products that read them are done
template <int KSTEPS>
__device__ __forceinline__ void fence_a(uint32_t (&a)[KSTEPS][4]) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[kk][j])::"memory");
  }
}

// d (64 x 64 f32, this warpgroup) += A (64 x 16 bf16, registers) *
// B (16 x 64 bf16, shared memory, K-major)
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// The accumulator of m64nN: thread t of the warpgroup holds rows
// 16 * (t / 32) + (t % 32) / 4 (+ 8) and columns 8 * (i / 4) + 2 * (t % 4)
// (+ 1) in d[i]: row offset 8 * ((i >> 1) & 1), column offset i & 1.
__device__ __forceinline__ int acc_row(int i, int lane_wg) {
  return 16 * (lane_wg / 32) + (lane_wg % 32) / 4 + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i, int lane_wg) {
  return 8 * (i / 4) + 2 * (lane_wg % 4) + (i & 1);
}

// ---------------------------------------------------- bf16, wgmma body --

constexpr int OT_H = 12, OT_W = 16;                // output tile
constexpr int MID_H = OT_H + 2, MID_W = OT_W + 2;  // conv1 region, 252 px
constexpr int IN_H = OT_H + 4, IN_W = OT_W + 4;    // input tile, 320 px
constexpr int MID_PX = MID_H * MID_W;
constexpr int NWG = 4;
constexpr int BF_THREADS = NWG * 128;
constexpr int TAP_BYTES = 64 * 128;
constexpr int W_BYTES = 9 * TAP_BYTES;
constexpr int OFF_W1 = 0;
constexpr int OFF_W2 = W_BYTES;
constexpr int OFF_IN = 2 * W_BYTES;
constexpr int OFF_MID = OFF_IN + IN_H * IN_W * 128;
constexpr int BF_SMEM = OFF_MID + MID_PX * 128 + 1024;  // + alignment slack

// One 3x3 conv of one M block: acc += sum over taps and k16 steps of
// A (the shifted pixel rows) x W_tap. `pix` is this lane's ldmatrix row
// pixel for tap (0, 0); a tap (a, b) adds a * row + b.
template <int KSTEPS>
__device__ __forceinline__ void conv3x3_wgmma(float (&acc)[32],
                                              unsigned act, int pix,
                                              int row, unsigned w,
                                              int khalf) {
  uint32_t af[2][KSTEPS][4];
  auto load = [&](uint32_t(&dst)[KSTEPS][4], int tap) {
    const int p = pix + (tap / 3) * row + tap % 3;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      ldsm_x4(dst[kk], act + swz(p, 2 * kk + khalf));
    }
  };
  load(af[0], 0);
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    wgmma_fence();
    fence_acc(acc);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      wgmma_m64n64k16(acc, af[tap & 1][kk],
                      desc_sw128(w + tap * TAP_BYTES + kk * 32));
    }
    wgmma_commit();
    if (tap + 1 < 9) {
      wgmma_wait<1>();  // the previous tap's products are done with its A
      fence_a(af[(tap + 1) & 1]);
      load(af[(tap + 1) & 1], tap + 1);
    }
  }
  wgmma_wait<0>();
  fence_a(af[0]);
  fence_a(af[1]);
  fence_acc(acc);
}

template <int C>
__global__ void __launch_bounds__(BF_THREADS, 1)
    resblock_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ w1,
                         const float* __restrict__ b1,
                         const __nv_bfloat16* __restrict__ w2,
                         const float* __restrict__ b2,
                         __nv_bfloat16* __restrict__ out, int B, int H, int W,
                         float res_scale) {
  constexpr int KSTEPS = C / 16;
  constexpr int CHUNKS = C / 8;  // 16-byte chunks of a pixel
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* s_in = smem + OFF_IN;
  unsigned char* s_mid = smem + OFF_MID;
  const unsigned a_w1 = smem_addr(smem + OFF_W1);
  const unsigned a_w2 = smem_addr(smem + OFF_W2);
  const unsigned a_in = smem_addr(s_in);
  const unsigned a_mid = smem_addr(s_mid);

  // both packed weight sets, once per block
  for (int i = threadIdx.x; i < 2 * W_BYTES / 16; i += BF_THREADS) {
    const unsigned char* src =
        i < W_BYTES / 16
            ? reinterpret_cast<const unsigned char*>(w1) + 16 * i
            : reinterpret_cast<const unsigned char*>(w2) + 16 * i - W_BYTES;
    cp_async16(smem + OFF_W1 + 16 * i, src, true);
  }
  cp_async_wait_all();
  fence_async_shared();

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int lane = t % 32, wi = t / 32;
  // this lane's ldmatrix row in an M block, and its 16-byte K half
  const int r = 16 * wi + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int khalf = lane >> 4;

  const int ntx = (W + OT_W - 1) / OT_W, nty = (H + OT_H - 1) / OT_H;
  const int64_t ntiles = (int64_t)B * nty * ntx;
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int tx = (int)(tile % ntx);
    const int ty = (int)((tile / ntx) % nty);
    const int b = (int)(tile / ((int64_t)ntx * nty));
    const int y0 = ty * OT_H, x0 = tx * OT_W;

    __syncthreads();  // the previous tile is done with s_in and s_mid
    for (int i = threadIdx.x; i < IN_H * IN_W * CHUNKS; i += BF_THREADS) {
      const int q = i / CHUNKS, j = i % CHUNKS;
      const int gy = y0 - 2 + q / IN_W, gx = x0 - 2 + q % IN_W;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const __nv_bfloat16* src =
          in ? x + (((int64_t)b * H + gy) * W + gx) * C + 8 * j : x;
      cp_async16(s_in + swz(q, j), src, in);
    }
    cp_async_wait_all();
    __syncthreads();

    // conv1 -> relu -> bf16 intermediate (zero outside the image)
    {
      const int m = min(64 * wg + r, MID_PX - 1);  // rows past 252: padding
      const int pix = (m / MID_W) * IN_W + m % MID_W;
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      conv3x3_wgmma<KSTEPS>(acc, a_in, pix, IN_W, a_w1, khalf);
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int mm = 64 * wg + acc_row(i, t);
        const int n = acc_col(i, t);
        if (mm < MID_PX && n < C) {
          const int my = mm / MID_W, mx = mm % MID_W;
          const int gy = y0 - 1 + my, gx = x0 - 1 + mx;
          const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
          float v0 = acc[i] + __ldg(b1 + n);
          float v1 = acc[i + 1] + __ldg(b1 + n + 1);
          v0 = in && v0 > 0.f ? v0 : 0.f;
          v1 = in && v1 > 0.f ? v1 : 0.f;
          *reinterpret_cast<__nv_bfloat162*>(s_mid + swz(mm, n >> 3) +
                                             2 * (n & 7)) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
    __syncthreads();

    // conv2 + b2, * res_scale, + x: written over x in the staged tile
    if (wg < OT_H * OT_W / 64) {
      const int m = 64 * wg + r;
      const int pix = (m / OT_W) * MID_W + m % OT_W;
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      conv3x3_wgmma<KSTEPS>(acc, a_mid, pix, MID_W, a_w2, khalf);
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int mm = 64 * wg + acc_row(i, t);
        const int n = acc_col(i, t);
        if (n < C) {
          const int q = (mm / OT_W + 2) * IN_W + mm % OT_W + 2;
          __nv_bfloat162* px = reinterpret_cast<__nv_bfloat162*>(
              s_in + swz(q, n >> 3) + 2 * (n & 7));
          const float2 res = __bfloat1622float2(*px);
          const float2 h = __bfloat1622float2(__floats2bfloat162_rn(
              (acc[i] + __ldg(b2 + n)) * res_scale,
              (acc[i + 1] + __ldg(b2 + n + 1)) * res_scale));
          *px = __floats2bfloat162_rn(res.x + h.x, res.y + h.y);
        }
      }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < OT_H * OT_W * CHUNKS; i += BF_THREADS) {
      const int q = i / CHUNKS, j = i % CHUNKS;
      const int oy = y0 + q / OT_W, ox = x0 + q % OT_W;
      if (oy < H && ox < W) {
        const int p = (q / OT_W + 2) * IN_W + q % OT_W + 2;
        *reinterpret_cast<uint4*>(out + (((int64_t)b * H + oy) * W + ox) * C +
                                  8 * j) =
            *reinterpret_cast<const uint4*>(s_in + swz(p, j));
      }
    }
  }
}

template <int C>
cudaError_t launch_bf16(const void* x, const void* w1, const float* b1,
                        const void* w2, const float* b2, void* out, int B,
                        int H, int W, float res_scale, cudaStream_t s) {
  auto kernel = resblock_bf16_kernel<C>;
  static int sms = 0;  // found at first launch
  if (sms == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BF_SMEM);
    if (e != cudaSuccess) return e;
    int dev = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  const int64_t ntiles =
      (int64_t)B * ((H + OT_H - 1) / OT_H) * ((W + OT_W - 1) / OT_W);
  if (ntiles == 0) return cudaSuccess;
  const int grid = (int)(ntiles < sms ? ntiles : sms);
  kernel<<<grid, BF_THREADS, BF_SMEM, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w1), b1,
      static_cast<const __nv_bfloat16*>(w2), b2,
      static_cast<__nv_bfloat16*>(out), B, H, W, res_scale);
  return cudaGetLastError();
}

// A (64 x 64 bf16, row-major) x B (packed like one tap of the weights) ->
// out (64 x 64 f32, row-major), one warpgroup
__global__ void __launch_bounds__(128)
    wgmma_matmul_kernel(const __nv_bfloat16* __restrict__ a,
                        const __nv_bfloat16* __restrict__ b,
                        float* __restrict__ out) {
  __shared__ __align__(1024) unsigned char s_b[TAP_BYTES];
  __shared__ __align__(128) unsigned char s_a[TAP_BYTES];
  const int t = threadIdx.x, lane = t % 32;
  for (int i = t; i < TAP_BYTES / 16; i += 128) {
    cp_async16(s_b + 16 * i, reinterpret_cast<const unsigned char*>(b) +
                                 16 * i, true);
    cp_async16(s_a + swz(i / 8, i % 8), a + 8 * i, true);
  }
  cp_async_wait_all();
  fence_async_shared();
  __syncthreads();
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  const int r = 16 * (t / 32) + (lane & 7) + 8 * ((lane >> 3) & 1);
  uint32_t af[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    ldsm_x4(af[kk], smem_addr(s_a) + swz(r, 2 * kk + (lane >> 4)));
  }
  wgmma_fence();
  fence_acc(acc);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_m64n64k16(acc, af[kk], desc_sw128(smem_addr(s_b) + kk * 32));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
#pragma unroll
  for (int i = 0; i < 32; ++i) out[acc_row(i, t) * 64 + acc_col(i, t)] = acc[i];
}

// ------------------------------------------------ f32, CUDA-core body --

constexpr int FT = 16;      // output tile: FT x FT pixels
constexpr int FH = FT + 2;  // tile with halo
constexpr int F_THREADS = 256;
constexpr int FPX = 8;  // pixels per thread: 8 neighbours in a row

constexpr int MODE_CONV1 = 0;  // relu(conv + b) -> scratch
constexpr int MODE_CONV2 = 1;  // resid + res_scale * (conv + b) -> out

template <int C>
struct F32Layout {
  // pixel stride C + 1: the four pixels a warp reads at once fall in
  // distinct banks
  static constexpr int XS = C + 1;
  static constexpr int Q = C / 8;  // output channels per thread
  static constexpr int BYTES = (9 * C * C + FH * FH * XS) * 4;
};

template <int C, int MODE>
__global__ void __launch_bounds__(F_THREADS, 1)
    conv3x3_f32_kernel(const float* __restrict__ in,
                       const float* __restrict__ w,
                       const float* __restrict__ bias,
                       const float* __restrict__ resid,
                       float* __restrict__ out, int B, int H, int W,
                       float res_scale) {
  using L = F32Layout<C>;
  constexpr int Q = L::Q;
  extern __shared__ __align__(16) float fsmem[];
  float* s_w = fsmem;              // [9 * C][C]
  float* s_x = fsmem + 9 * C * C;  // [FH * FH][XS]

  for (int i = threadIdx.x; i < 9 * C * C / 4; i += F_THREADS) {
    reinterpret_cast<float4*>(s_w)[i] = reinterpret_cast<const float4*>(w)[i];
  }
  // thread -> channels cg + 8q (a warp's 8 channel groups read 8
  // consecutive words) x 8 pixels of one tile row
  const int cg = threadIdx.x % 8, pg = threadIdx.x / 8;
  const int py = pg / 2, px0 = (pg % 2) * FPX;
  const int ntx = (W + FT - 1) / FT, nty = (H + FT - 1) / FT;
  const int64_t ntiles = (int64_t)B * nty * ntx;
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int tx = (int)(t % ntx);
    const int ty = (int)((t / ntx) % nty);
    const int b = (int)(t / ((int64_t)ntx * nty));
    const int y0 = ty * FT, x0 = tx * FT;
    __syncthreads();  // weights visible; the previous tile is done with s_x
    for (int i = threadIdx.x; i < FH * FH * (C / 4); i += F_THREADS) {
      const int c4 = i % (C / 4), q = i / (C / 4);
      const int gy = y0 + q / FH - 1, gx = x0 + q % FH - 1;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        v = reinterpret_cast<const float4*>(
            in + (((int64_t)b * H + gy) * W + gx) * C)[c4];
      }
      float* d = s_x + q * L::XS + 4 * c4;
      d[0] = v.x;
      d[1] = v.y;
      d[2] = v.z;
      d[3] = v.w;
    }
    __syncthreads();

    float acc[FPX][Q];
#pragma unroll
    for (int i = 0; i < FPX; ++i) {
#pragma unroll
      for (int q = 0; q < Q; ++q) acc[i][q] = 0.f;
    }
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const float* xs = s_x + ((py + tap / 3) * FH + px0 + tap % 3) * L::XS;
      const float* ws = s_w + tap * C * C + cg;
#pragma unroll 4
      for (int k = 0; k < C; ++k) {
        float xv[FPX], wv[Q];
#pragma unroll
        for (int i = 0; i < FPX; ++i) xv[i] = xs[i * L::XS + k];
#pragma unroll
        for (int q = 0; q < Q; ++q) wv[q] = ws[k * C + 8 * q];
#pragma unroll
        for (int i = 0; i < FPX; ++i) {
#pragma unroll
          for (int q = 0; q < Q; ++q) acc[i][q] = fmaf(xv[i], wv[q], acc[i][q]);
        }
      }
    }

    const int oy = y0 + py;
#pragma unroll
    for (int i = 0; i < FPX; ++i) {
      const int ox = x0 + px0 + i;
      if (oy < H && ox < W) {
        const int64_t base = (((int64_t)b * H + oy) * W + ox) * C + cg;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const float a = acc[i][q] + __ldg(bias + cg + 8 * q);
          if constexpr (MODE == MODE_CONV1) {
            out[base + 8 * q] = a > 0.f ? a : 0.f;
          } else {
            out[base + 8 * q] = resid[base + 8 * q] + a * res_scale;
          }
        }
      }
    }
  }
}

template <int C, int MODE>
cudaError_t launch_f32(const float* in, const float* w, const float* bias,
                       const float* resid, float* out, int B, int H, int W,
                       float res_scale, cudaStream_t s) {
  using L = F32Layout<C>;
  auto kernel = conv3x3_f32_kernel<C, MODE>;
  static int sms = 0;  // found at first launch
  if (sms == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (e != cudaSuccess) return e;
    int dev = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  const int64_t ntiles =
      (int64_t)B * ((H + FT - 1) / FT) * ((W + FT - 1) / FT);
  if (ntiles == 0) return cudaSuccess;
  const int grid = (int)(ntiles < sms ? ntiles : sms);
  kernel<<<grid, F_THREADS, L::BYTES, s>>>(in, w, bias, resid, out, B, H, W,
                                          res_scale);
  return cudaGetLastError();
}

template <int C>
cudaError_t block(int dtype, const void* x, const void* w1, const float* b1,
                  const void* w2, const float* b2, void* mid, void* out,
                  int B, int H, int W, float res_scale, cudaStream_t s) {
  if (dtype == 1) {
    return launch_bf16<C>(x, w1, b1, w2, b2, out, B, H, W, res_scale, s);
  }
  const float* fx = static_cast<const float*>(x);
  cudaError_t e = launch_f32<C, MODE_CONV1>(
      fx, static_cast<const float*>(w1), b1, nullptr,
      static_cast<float*>(mid), B, H, W, 1.f, s);
  if (e != cudaSuccess) return e;
  return launch_f32<C, MODE_CONV2>(
      static_cast<const float*>(mid), static_cast<const float*>(w2), b2, fx,
      static_cast<float*>(out), B, H, W, res_scale, s);
}

}  // namespace

// dtype 0 = float32: x, mid and out are (B, H, W, C) contiguous, w1 and w2
// (9*C, C) float32 with row (a*3 + b)*C + ci for tap (a, b); two launches.
// dtype 1 = bfloat16: x and out (B, H, W, C) contiguous, w1 and w2 each
// (9, 64, 64) bf16 in the swizzled K-major layout of the header, 16-byte
// aligned; mid is unused; one launch. b1 and b2 are float32 (C,). Returns a
// cudaError_t.
extern "C" int sr_fused_resblock(const void* x, const void* w1, const void* b1,
                                 const void* w2, const void* b2, void* mid,
                                 void* out, int B, int H, int W, int C,
                                 int dtype, float res_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fb1 = static_cast<const float*>(b1);
  const float* fb2 = static_cast<const float*>(b2);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  switch (C) {
    case 16:
      return (int)block<16>(dtype, x, w1, fb1, w2, fb2, mid, out, B, H, W,
                            res_scale, s);
    case 32:
      return (int)block<32>(dtype, x, w1, fb1, w2, fb2, mid, out, B, H, W,
                            res_scale, s);
    case 48:
      return (int)block<48>(dtype, x, w1, fb1, w2, fb2, mid, out, B, H, W,
                            res_scale, s);
    case 64:
      return (int)block<64>(dtype, x, w1, fb1, w2, fb2, mid, out, B, H, W,
                            res_scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// a: (64, 64) bf16 row-major; b: (64, 64) bf16 packed like one weight tap
// (row n holds column n of the matrix, swizzled); out: (64, 64) float32.
extern "C" int sr_wgmma_matmul(const void* a, const void* b, void* out,
                               void* stream) {
  wgmma_matmul_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), static_cast<float*>(out));
  return (int)cudaGetLastError();
}

extern "C" const char* sr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
