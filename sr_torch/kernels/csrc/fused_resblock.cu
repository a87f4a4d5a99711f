// EDSR residual block for Hopper (sm_90a), inference only:
//
//   out = x + res_scale * (conv2(relu(conv1(x) + b1)) + b2)
//
// with both convs 3x3, stride 1, zero padding 1 (SAME), NHWC activations,
// weights packed as (9*C, C) with row (a*3 + b)*C + ci for tap (a, b), f32
// accumulation, f32 biases added before the cast, and the intermediate stored
// in the activation dtype -- the arithmetic of the TPU kernel.
//
// Replaces sr/kernels/fused_resblock.py:_resblock_kernel (the pl.pallas_call
// at line 119), which kept a whole image and both padded intermediates in
// VMEM and ran each conv as row-tiled (rows*W, 9C) @ (9C, C) im2col matmuls.
//
// Bound: operations. Two convs of 2*B*H*W*9C*C flops each; at B=16, 128x128,
// C=64 in bf16 that is 38.7 GFLOP, about 39 us at the H100's 989 TFLOP/s,
// against about 20 us to read x and write out once at 3.35 TB/s.
//
// Design (simple and right first): two launches of one direct-conv kernel
// with a fused epilogue. Launch 1 writes relu(conv1(x) + b1) in x's dtype to
// a scratch tensor that the wrapper allocates; launch 2 reads it back and
// writes x + res_scale * (conv2 + b2). Each block is persistent: it loads
// the packed weights into shared memory once, then walks over 8x16-pixel
// output tiles. For each tile it loads the tile plus a one-pixel halo into
// shared memory, zero-filled outside the image, so any H and W work.
//   * bf16: each of the 8 warps owns one 16-pixel tile row and computes it
//     with warp-level bf16 tensor-core products (WMMA 16x16x16, f32
//     accumulators), K = 9 taps x C. The accumulators go through shared
//     memory to the epilogue, which writes 16-byte vectors.
//   * f32: tensor cores would round to TF32, so each thread computes one
//     pixel times C/2 output channels with FMAs on the CUDA cores, reading
//     the weights as broadcast float4s.
// The intermediate makes a round trip through device memory, and the
// products use mma.sync-class instructions. The later redesign keeps the
// conv1 tile with its halo on chip in one launch (recomputing the halo),
// feeds wgmma from TMA-loaded tiles, and overlaps loads with the products.
//
// C must be 16, 32, 48 or 64; the wrapper checks. Plain C interface for
// ctypes; returns cudaGetLastError() after the second launch (or the first
// error met).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int TH = 8;        // output tile rows
constexpr int TW = 16;       // output tile columns (one WMMA M fragment)
constexpr int HH = TH + 2;   // tile rows with halo
constexpr int HW = TW + 2;   // tile columns with halo
constexpr int NTHREADS = 256;

constexpr int MODE_CONV1 = 0;  // relu(conv + b) -> scratch
constexpr int MODE_CONV2 = 1;  // resid + res_scale * (conv + b) -> out

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

template <typename T, int C>
struct Layout {
  static constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  // bf16: rows of the halo tile are WMMA A rows at any pixel offset, so
  // their stride keeps every fragment pointer 32-byte aligned (C + 16); the
  // weights' B fragments start at multiples of 16 rows, where C + 8 is
  // enough and breaks the 128-byte bank period.
  // f32: the pixel stride C + 1 spreads a warp's 32 pixels over 32 banks;
  // weight rows are read as broadcasts and need no padding.
  static constexpr int XS = BF16 ? C + 16 : C + 1;
  static constexpr int WS = BF16 ? C + 8 : C;
  static constexpr int W_ELEMS = 9 * C * WS;
  static constexpr int X_ELEMS = HH * HW * XS;
  static constexpr int BYTES = (W_ELEMS + X_ELEMS) * (int)sizeof(T);
};

template <typename T, int MODE>
__device__ __forceinline__ T epilogue(float acc, float bias, T resid,
                                      float res_scale) {
  if constexpr (MODE == MODE_CONV1) {
    const float v = acc + bias;
    return from_f32<T>(v > 0.f ? v : 0.f);
  } else {
    const T h = from_f32<T>((acc + bias) * res_scale);
    return from_f32<T>(to_f32(resid) + to_f32(h));
  }
}

// bf16 tile: warp w computes tile row w, all C output channels.
template <int C, int MODE>
__device__ __forceinline__ void tile_bf16(
    const __nv_bfloat16* s_w, __nv_bfloat16* s_x,
    const float* __restrict__ bias, const __nv_bfloat16* __restrict__ resid,
    __nv_bfloat16* __restrict__ out, int b, int y0, int x0, int H, int W,
    float res_scale) {
  using L = Layout<__nv_bfloat16, C>;
  constexpr int NF = C / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int nf = 0; nf < NF; ++nf) wmma::fill_fragment(acc[nf], 0.f);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int bb = 0; bb < 3; ++bb) {
#pragma unroll
      for (int kc = 0; kc < NF; ++kc) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            fa;
        wmma::load_matrix_sync(fa, s_x + ((warp + a) * HW + bb) * L::XS + kc * 16,
                               L::XS);
#pragma unroll
        for (int nf = 0; nf < NF; ++nf) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              fb;
          wmma::load_matrix_sync(
              fb, s_w + ((a * 3 + bb) * C + kc * 16) * L::WS + nf * 16, L::WS);
          wmma::mma_sync(acc[nf], fa, fb, acc[nf]);
        }
      }
    }
  }
  // every warp has finished reading the halo tile: reuse it as staging
  __syncthreads();
  float* st = reinterpret_cast<float*>(s_x) + warp * 256;
  const int m = lane >> 1, c8 = (lane & 1) * 8;
  const int oy = y0 + warp, ox = x0 + m;
  const bool valid = oy < H && ox < W;
  const int64_t pix = ((int64_t)b * H + oy) * W + ox;
#pragma unroll
  for (int nf = 0; nf < NF; ++nf) {
    wmma::store_matrix_sync(st, acc[nf], 16, wmma::mem_row_major);
    __syncwarp();
    if (valid) {
      const int c = nf * 16 + c8;
      alignas(16) __nv_bfloat16 rv[8];
      if constexpr (MODE == MODE_CONV2) {
        *reinterpret_cast<uint4*>(rv) =
            *reinterpret_cast<const uint4*>(resid + pix * C + c);
      }
      alignas(16) __nv_bfloat16 ov[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        ov[k] = epilogue<__nv_bfloat16, MODE>(st[m * 16 + c8 + k],
                                              __ldg(bias + c + k), rv[k],
                                              res_scale);
      }
      *reinterpret_cast<uint4*>(out + pix * C + c) =
          *reinterpret_cast<const uint4*>(ov);
    }
    __syncwarp();
  }
}

// f32 tile: thread t computes pixel t % 128 for channels (t / 128) * C/2 ...
template <int C, int MODE>
__device__ __forceinline__ void tile_f32(const float* s_w, const float* s_x,
                                         const float* __restrict__ bias,
                                         const float* __restrict__ resid,
                                         float* __restrict__ out, int b,
                                         int y0, int x0, int H, int W,
                                         float res_scale) {
  using L = Layout<float, C>;
  constexpr int HALF = C / 2;
  const int p = threadIdx.x % (TH * TW), g = threadIdx.x / (TH * TW);
  const int py = p / TW, px = p % TW;
  float acc[HALF];
#pragma unroll
  for (int n = 0; n < HALF; ++n) acc[n] = 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int bb = 0; bb < 3; ++bb) {
      const float* xs = s_x + ((py + a) * HW + px + bb) * L::XS;
      const float* ws = s_w + (a * 3 + bb) * C * L::WS + g * HALF;
#pragma unroll 4
      for (int k = 0; k < C; ++k) {
        const float xv = xs[k];
        const float4* wr = reinterpret_cast<const float4*>(ws + k * L::WS);
#pragma unroll
        for (int n4 = 0; n4 < HALF / 4; ++n4) {
          const float4 wv = wr[n4];
          acc[4 * n4 + 0] = fmaf(xv, wv.x, acc[4 * n4 + 0]);
          acc[4 * n4 + 1] = fmaf(xv, wv.y, acc[4 * n4 + 1]);
          acc[4 * n4 + 2] = fmaf(xv, wv.z, acc[4 * n4 + 2]);
          acc[4 * n4 + 3] = fmaf(xv, wv.w, acc[4 * n4 + 3]);
        }
      }
    }
  }
  const int oy = y0 + py, ox = x0 + px;
  if (oy < H && ox < W) {
    const int64_t base = (((int64_t)b * H + oy) * W + ox) * C + g * HALF;
#pragma unroll
    for (int n = 0; n < HALF; ++n) {
      const float rv = MODE == MODE_CONV2 ? resid[base + n] : 0.f;
      out[base + n] =
          epilogue<float, MODE>(acc[n], __ldg(bias + g * HALF + n), rv,
                                res_scale);
    }
  }
}

template <typename T, int C, int MODE>
__global__ void __launch_bounds__(NTHREADS)
    conv3x3_kernel(const T* __restrict__ in, const T* __restrict__ w,
                   const float* __restrict__ bias, const T* __restrict__ resid,
                   T* __restrict__ out, int B, int H, int W,
                   float res_scale) {
  using L = Layout<T, C>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* s_w = reinterpret_cast<T*>(smem);
  T* s_x = s_w + L::W_ELEMS;

  for (int i = threadIdx.x; i < 9 * C * C; i += NTHREADS) {
    s_w[(i / C) * L::WS + i % C] = w[i];
  }
  const int ntx = (W + TW - 1) / TW, nty = (H + TH - 1) / TH;
  const int64_t ntiles = (int64_t)B * nty * ntx;
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int tx = (int)(t % ntx);
    const int ty = (int)((t / ntx) % nty);
    const int b = (int)(t / ((int64_t)ntx * nty));
    const int y0 = ty * TH, x0 = tx * TW;
    __syncthreads();  // weights visible; the previous tile is done with s_x
    for (int i = threadIdx.x; i < HH * HW * C; i += NTHREADS) {
      const int c = i % C, q = i / C;
      const int gy = y0 + q / HW - 1, gx = x0 + q % HW - 1;
      T v = from_f32<T>(0.f);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        v = in[(((int64_t)b * H + gy) * W + gx) * C + c];
      }
      s_x[q * L::XS + c] = v;
    }
    __syncthreads();
    if constexpr (L::BF16) {
      tile_bf16<C, MODE>(s_w, s_x, bias, resid, out, b, y0, x0, H, W,
                         res_scale);
    } else {
      tile_f32<C, MODE>(s_w, s_x, bias, resid, out, b, y0, x0, H, W,
                        res_scale);
    }
  }
}

template <typename T, int C, int MODE>
cudaError_t launch(const void* in, const void* w, const float* bias,
                   const void* resid, void* out, int B, int H, int W,
                   float res_scale, cudaStream_t s) {
  using L = Layout<T, C>;
  auto kernel = conv3x3_kernel<T, C, MODE>;
  static int grid_cap = 0;  // SMs x resident blocks, found at first launch
  if (grid_cap == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (e != cudaSuccess) return e;
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      NTHREADS, L::BYTES);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    grid_cap = sms * per_sm;
  }
  const int64_t ntiles =
      (int64_t)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (ntiles == 0) return cudaSuccess;
  const int grid = (int)(ntiles < grid_cap ? ntiles : grid_cap);
  kernel<<<grid, NTHREADS, L::BYTES, s>>>(
      static_cast<const T*>(in), static_cast<const T*>(w), bias,
      static_cast<const T*>(resid), static_cast<T*>(out), B, H, W, res_scale);
  return cudaGetLastError();
}

template <typename T, int C>
cudaError_t block(const void* x, const void* w1, const float* b1,
                  const void* w2, const float* b2, void* mid, void* out,
                  int B, int H, int W, float res_scale, cudaStream_t s) {
  cudaError_t e = launch<T, C, MODE_CONV1>(x, w1, b1, nullptr, mid, B, H, W,
                                           1.f, s);
  if (e != cudaSuccess) return e;
  return launch<T, C, MODE_CONV2>(mid, w2, b2, x, out, B, H, W, res_scale, s);
}

template <typename T>
cudaError_t by_channels(const void* x, const void* w1, const float* b1,
                        const void* w2, const float* b2, void* mid, void* out,
                        int B, int H, int W, int C, float res_scale,
                        cudaStream_t s) {
  switch (C) {
    case 16:
      return block<T, 16>(x, w1, b1, w2, b2, mid, out, B, H, W, res_scale, s);
    case 32:
      return block<T, 32>(x, w1, b1, w2, b2, mid, out, B, H, W, res_scale, s);
    case 48:
      return block<T, 48>(x, w1, b1, w2, b2, mid, out, B, H, W, res_scale, s);
    case 64:
      return block<T, 64>(x, w1, b1, w2, b2, mid, out, B, H, W, res_scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x, mid and out are (B, H, W, C)
// contiguous; w1 and w2 are (9*C, C) in x's dtype; b1 and b2 are float32
// (C,). Returns a cudaError_t.
extern "C" int sr_fused_resblock(const void* x, const void* w1, const void* b1,
                                 const void* w2, const void* b2, void* mid,
                                 void* out, int B, int H, int W, int C,
                                 int dtype, float res_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fb1 = static_cast<const float*>(b1);
  const float* fb2 = static_cast<const float*>(b2);
  if (dtype == 0) {
    return (int)by_channels<float>(x, w1, fb1, w2, fb2, mid, out, B, H, W, C,
                                   res_scale, s);
  }
  if (dtype == 1) {
    return (int)by_channels<__nv_bfloat16>(x, w1, fb1, w2, fb2, mid, out, B,
                                           H, W, C, res_scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* sr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
