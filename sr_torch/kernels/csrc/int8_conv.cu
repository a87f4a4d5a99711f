// k x k SAME stride-1 convolution as an implicit GEMM for Hopper (sm_90a),
// NHWC activations, (k, k, N, C) weights, raw accumulator out:
//
//   int8 x int8 -> int32 (exact: |acc| <= k*k*C*127*127, below 2^26 for the
//                         7x7 64-channel tail conv)
//   bf16 x bf16 -> f32
//
// Replaces sr/kernels/int8_conv.py:_conv3x3_im2col (the pl.pallas_call at
// line 75; entries conv3x3_int8_im2col :93 and conv3x3_bf16_im2col :105),
// which built the (rows*W, 9C) im2col matrix of a 1-padded image in VMEM and
// contracted it in one dot. The dequantize / bias / requantize epilogue
// stays outside the kernel, as the TPU kernel left it to XLA.
//
// Bound, at the serving path's shapes (b16, 128x128 LR): the int32
// accumulator makes the body conv bytes-bound. 64->64 at 128^2: 19.3 GOP
// over 1979 TOP/s is 9.8 us, but 16.8 MB in plus 67.1 MB of int32 out is
// 25.0 us at 3.35 TB/s. PS stage 1 (64->256 at 128^2) is about 85 us of
// bytes, the out conv (64->3 at 512^2) about 95 us of bytes, and the 7x7
// 64->48 fused-quant tail conv about 40 us of operations.
//
// Design (simple and right first): one block of 8 warps computes an output
// tile of 8 rows x 16 pixels x 64 output channels of one image. Its K loop
// runs over chunks of 64 bytes of input channels (64 int8 or 32 bf16) and,
// inside a chunk, over the k rows of taps. Per chunk the input tile plus a
// k/2 halo is copied to shared memory, zero-filled outside the image and
// past C; per tap row the weight slice (k taps x 64 outputs x chunk) is
// copied in 16-byte vectors from weights that the wrapper packs as
// (k, k, N, C), so that each output channel's K run is contiguous, the
// layout the MMA's B operand wants; it is zero-filled past C and N. Each
// warp owns one output row: 16 pixels (the MMA's M) x 64 channels as eight
// m16n8 accumulators, fed by mma.sync from ldmatrix.x4 loads. Both
// instantiations share one body, because int8 m16n8k32 and bf16 m16n8k16
// fragments have the same byte layout: a K step is 32 bytes, A row g holds
// bytes tig*4..+3 and 16+tig*4..+3 of pixel g and g+8, B column g the same
// bytes of output g, which is what ldmatrix hands each lane. A shared-memory
// row is 64 + 16 bytes, so the eight rows of an 8x16-byte matrix fall in
// distinct banks. Any C >= 1, N >= 1 and odd k <= 25 work through the zero
// fill; K steps that hold only the zero fill and n8 fragments wholly past N
// are skipped, so C = 3 costs one K step per tap and N = 3 one fragment.
// The store is masked at the image edge and past N.
//
// Left for later: wgmma fed by TMA, more pixels per warp (B fragments are
// loaded once per 16 pixels), a persistent block that keeps the weights in
// shared memory, and the epilogue (dequantize, bias, the next conv's
// quantize) fused into the store.
//
// Plain C interface for ctypes; the launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TH = 8;          // output rows per block, one per warp
constexpr int TW = 16;         // output pixels per row: the MMA's M
constexpr int NT = 64;         // output channels per block
constexpr int KCB = 64;        // bytes of input channels per K chunk
constexpr int RS = KCB + 16;   // bytes per shared-memory row (pixel / n)
constexpr int NTHREADS = TH * 32;
constexpr int MAX_SMEM = 232448;  // 227 KB, the most a block may use

template <typename T>
using Acc = typename std::conditional<std::is_same<T, int8_t>::value, int,
                                      float>::type;

// four 8x8 matrices of 16-bit words (8 rows x 16 bytes each); lane l gives
// the row address of matrix l / 8, row l % 8, and receives word l % 4 of
// row l / 4 of each matrix
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                        const unsigned char* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// one m16n8 tile += A (16 x 32 bytes) * B (32 bytes x 8)
__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ int8_t zero<int8_t>() { return 0; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

__host__ __device__ constexpr int smem_bytes(int k) {
  return ((TH + k - 1) * (TW + k - 1) + k * NT) * RS;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                Acc<T>* __restrict__ out, int H, int W, int C, int N, int k,
                int tiles_x, bool vec) {
  constexpr int ES = sizeof(T);
  constexpr int KCE = KCB / ES;  // channels per chunk
  constexpr int KSE = 32 / ES;   // channels per K step
  constexpr int V = KCB / 16;    // 16-byte vectors per chunk row
  const int p = k / 2;
  const int HWd = TW + k - 1;  // halo tile columns
  const int HH = TH + k - 1;   // halo tile rows
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* s_x = smem;                  // [HH * HWd][RS]
  unsigned char* s_w = smem + HH * HWd * RS;  // [k][NT][RS]

  const int b = blockIdx.z;
  const int n0 = blockIdx.y * NT;
  const int nfr = min(NT / 8, (N - n0 + 7) / 8);  // n8 fragments in use
  const int nstage = nfr * 8;                     // weight rows staged
  const int ty = blockIdx.x / tiles_x;
  const int y0 = ty * TH, x0 = (blockIdx.x - ty * tiles_x) * TW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* xb = x + (int64_t)b * H * W * C;
  // ldmatrix row addresses of this lane: A matrices (rows 0-7 | 8-15) x
  // (bytes 0-15 | 16-31); B matrices (bytes 0-15 | 16-31) x (n8 | next n8)
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int a_col = 16 * (lane >> 4);
  const int b_row = (lane & 7) + 8 * (lane >> 4);
  const int b_col = 16 * ((lane >> 3) & 1);

  Acc<T> acc[NT / 8][4];
#pragma unroll
  for (int nf = 0; nf < NT / 8; ++nf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nf][i] = 0;
  }

  for (int c0 = 0; c0 < C; c0 += KCE) {
    // K steps of this chunk that hold a real channel; the rest are zero
    const int ksteps = min(KCB / 32, (C - c0 + KSE - 1) / KSE);
    const int kce = ksteps * KSE;  // channels staged for this chunk
    __syncthreads();  // every warp is done with the previous chunk
    if (vec) {  // whole chunks, 16-byte aligned rows
      for (int i = threadIdx.x; i < HH * HWd * V; i += NTHREADS) {
        const int q = i / V, v = i - q * V;
        const int gy = y0 + q / HWd - p, gx = x0 + q % HWd - p;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
          val = *reinterpret_cast<const uint4*>(
              xb + ((int64_t)gy * W + gx) * C + c0 + v * (16 / ES));
        }
        *reinterpret_cast<uint4*>(s_x + q * RS + v * 16) = val;
      }
    } else {
      for (int i = threadIdx.x; i < HH * HWd * kce; i += NTHREADS) {
        const int q = i / kce, ce = i - q * kce;
        const int gy = y0 + q / HWd - p, gx = x0 + q % HWd - p;
        const int c = c0 + ce;
        T val = zero<T>();
        if (c < C && gy >= 0 && gy < H && gx >= 0 && gx < W) {
          val = xb[((int64_t)gy * W + gx) * C + c];
        }
        reinterpret_cast<T*>(s_x + q * RS)[ce] = val;
      }
    }
    for (int dy = 0; dy < k; ++dy) {
      __syncthreads();  // tile staged; the previous tap row is consumed
      // weights (dy, dx, n, c) of this chunk -> s_w[dx][n][c]
      const T* wrow = w + (int64_t)dy * k * N * C;
      if (vec) {
        for (int i = threadIdx.x; i < k * nstage * V; i += NTHREADS) {
          const int v = i % V, row = i / V;
          const int n = row % nstage, dx = row / nstage;
          uint4 val = make_uint4(0u, 0u, 0u, 0u);
          if (n0 + n < N) {
            val = *reinterpret_cast<const uint4*>(
                wrow + ((int64_t)dx * N + n0 + n) * C + c0 + v * (16 / ES));
          }
          *reinterpret_cast<uint4*>(s_w + (dx * NT + n) * RS + v * 16) = val;
        }
      } else {
        for (int i = threadIdx.x; i < k * nstage * kce; i += NTHREADS) {
          const int ce = i % kce, row = i / kce;
          const int n = row % nstage, dx = row / nstage;
          const int c = c0 + ce;
          T val = zero<T>();
          if (c < C && n0 + n < N) {
            val = wrow[((int64_t)dx * N + n0 + n) * C + c];
          }
          reinterpret_cast<T*>(s_w + (dx * NT + n) * RS)[ce] = val;
        }
      }
      __syncthreads();
      for (int dx = 0; dx < k; ++dx) {
        const unsigned char* xa =
            s_x + ((warp + dy) * HWd + dx + a_row) * RS + a_col;
        const unsigned char* wb = s_w + (dx * NT + b_row) * RS + b_col;
        for (int ks = 0; ks < ksteps; ++ks) {
          uint32_t a[4];
          ldsm_x4(a, xa + ks * 32);
#pragma unroll
          for (int np = 0; np < NT / 16; ++np) {
            if (2 * np < nfr) {
              uint32_t bq[4];  // b0, b1 of fragment 2np, then of 2np + 1
              ldsm_x4(bq, wb + np * 16 * RS + ks * 32);
              mma(acc[2 * np], a, bq[0], bq[1]);
              if (2 * np + 1 < nfr) mma(acc[2 * np + 1], a, bq[2], bq[3]);
            }
          }
        }
      }
    }
  }

  // accumulator (row g / g+8, column tig*2 / +1) -> out[b, oy, ox, n]
  const int g = lane >> 2, tig = lane & 3;
  const int oy = y0 + warp;
  if (oy >= H) return;
  Acc<T>* orow = out + ((int64_t)b * H + oy) * W * N;
#pragma unroll
  for (int nf = 0; nf < NT / 8; ++nf) {
    const int n = n0 + nf * 8 + tig * 2;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ox = x0 + g + 8 * half;
      if (ox >= W) continue;
      Acc<T>* o = orow + (int64_t)ox * N + n;
      if (n < N) o[0] = acc[nf][2 * half];
      if (n + 1 < N) o[1] = acc[nf][2 * half + 1];
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, int B, int H,
                   int W, int C, int N, int k, cudaStream_t s) {
  if (k < 1 || k % 2 == 0 || smem_bytes(k) > MAX_SMEM || C < 1 ||
      B > 65535) {
    return cudaErrorInvalidValue;
  }
  if (B == 0 || H == 0 || W == 0 || N == 0) return cudaSuccess;
  auto kernel = conv_kernel<T>;
  // the opt-in above 48 KB, once: a 7x7 conv stages 60 KB
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return attr;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const dim3 grid((unsigned)tiles_x * tiles_y, (N + NT - 1) / NT, B);
  const bool vec = C % (KCB / (int)sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  kernel<<<grid, NTHREADS, smem_bytes(k), s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<Acc<T>*>(out), H, W, C, N, k, tiles_x, vec);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = int8 in, int32 out; 1 = bfloat16 in, float32 out. x is
// (B, H, W, C) and out (B, H, W, N), both contiguous; w is packed as
// (k, k, N, C), contiguous, k odd. Returns a cudaError_t
// (cudaErrorInvalidValue for an even k, k > 25, C < 1 or B > 65535).
extern "C" int sr_conv_im2col(const void* x, const void* w, void* out, int B,
                              int H, int W, int C, int N, int k, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)launch<int8_t>(x, w, out, B, H, W, C, N, k, s);
  }
  if (dtype == 1) {
    return (int)launch<__nv_bfloat16>(x, w, out, B, H, W, C, N, k, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* sr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
