// Pixel shuffle (depth_to_space) in NHWC for Hopper (sm_90a).
//
//   out[b, h*r + i, w*r + j, c] = act(x[b, h, w, c*r*r + i*r + j])
//
// Replaces sr/kernels/depth_to_space.py:_d2s_kernel (the pl.pallas_call at
// line 73), which streamed one LR row per grid step through VMEM. Types:
// float32, bfloat16, and uint8 for the fused-quant tail, which quantizes to
// u8 before the shuffle so that the shuffle moves a quarter of the bytes.
//
// Bound: bytes. The shuffle reads every input element once and writes every
// output element once, so the least time is 2 * numel * itemsize over the
// card's memory rate (3.35 TB/s on an H100 SXM). It does no arithmetic
// beyond the optional ReLU.
//
// Design: one thread per 16-byte output vector (16 u8, 8 bf16 or 4 f32
// channels of one output pixel; one element when C does not divide into vectors), indexed
// by the OUTPUT so that a warp writes one contiguous run of memory. Each
// thread gathers its channels from the input with stride r*r; neighbouring
// threads read neighbouring input rows, which L2 serves. The grid's x walks
// output rows (b, oh) and its y splits a row. Offsets inside a row are
// 32-bit; only a row's base offset is 64-bit, so the tensor may hold more
// than 2^31 elements as long as the output rows (B * H * r) number fewer
// than 2^31 and one input row (W * C * r * r elements) holds fewer than
// 2^30.
//
// Plain C interface for ctypes: the wrapper passes pointers, sizes and the
// CUDA stream; the launch returns cudaGetLastError() as an int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxRows = (int64_t{1} << 31) - 1;  // gridDim.x
constexpr int64_t kMaxRowElems = int64_t{1} << 30;  // v + stride fits int

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

__device__ __forceinline__ __nv_bfloat16 relu(__nv_bfloat16 v) {
  return __bfloat162float(v) < 0.f ? __float2bfloat16(0.f) : v;
}

__device__ __forceinline__ uint8_t relu(uint8_t v) { return v; }

template <typename T, int VEC, bool RELU>
__global__ void d2s_kernel(const T* __restrict__ x, T* __restrict__ out,
                           int H, int W, int C, int r) {
  const int Ho = H * r, Wo = W * r;
  const int rr = r * r;
  const int cv = C / VEC;        // vectors per output pixel
  const int row_len = Wo * cv;   // vectors per output row
  const int row = blockIdx.x;    // output row: b * Ho + oh
  const int b = row / Ho, oh = row - b * Ho;
  const int h = oh / r, ii = oh - h * r;
  const T* src_row = x + (int64_t)(b * H + h) * (W * C * rr) + ii * r;
  T* dst_row = out + (int64_t)row * (Wo * C);
  for (int v = blockIdx.y * kThreads + threadIdx.x; v < row_len;
       v += gridDim.y * kThreads) {
    const int ow = v / cv;
    const int c0 = (v - ow * cv) * VEC;
    const int w = ow / r, jj = ow - w * r;
    const T* src = src_row + w * C * rr + jj;
    alignas(16) T vals[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const T val = src[(c0 + k) * rr];
      vals[k] = RELU ? relu(val) : val;
    }
    // output element (oh, ow, c0) of this row is exactly v * VEC
    T* dst = dst_row + v * VEC;
    if constexpr (VEC * sizeof(T) == 16) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(vals);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) dst[k] = vals[k];
    }
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, void* out, int64_t B, int64_t H, int64_t W,
                   int64_t C, int64_t r, bool relu_on, cudaStream_t s) {
  const int64_t rows = B * H * r;
  const int64_t row_len = W * r * (C / VEC);
  const int64_t segs = (row_len + kThreads - 1) / kThreads;
  const dim3 grid((unsigned)rows, (unsigned)(segs < 65535 ? segs : 65535));
  if (relu_on) {
    d2s_kernel<T, VEC, true><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(out), (int)H, (int)W,
        (int)C, (int)r);
  } else {
    d2s_kernel<T, VEC, false><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(out), (int)H, (int)W,
        (int)C, (int)r);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, void* out, int64_t B, int64_t H,
                     int64_t W, int64_t C, int64_t r, bool relu_on,
                     cudaStream_t s) {
  if (B * H * W * C == 0) return cudaSuccess;
  if (B * H * r > kMaxRows || W * C * r * r >= kMaxRowElems) {
    return cudaErrorInvalidValue;
  }
  constexpr int VEC = 16 / sizeof(T);
  const bool aligned = ((uintptr_t)out % 16) == 0;
  if (C % VEC == 0 && aligned) {
    return launch<T, VEC>(x, out, B, H, W, C, r, relu_on, s);
  }
  return launch<T, 1>(x, out, B, H, W, C, r, relu_on, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = uint8. C is the OUTPUT channel count; the input
// has C * r * r channels. Returns a cudaError_t; cudaErrorInvalidValue when
// B * H * r reaches 2^31 or W * C * r * r reaches 2^30.
extern "C" int sr_depth_to_space(const void* x, void* out, int64_t B,
                                 int64_t H, int64_t W, int64_t C, int64_t r,
                                 int dtype, int relu_on, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)dispatch<float>(x, out, B, H, W, C, r, relu_on != 0, s);
  }
  if (dtype == 1) {
    return (int)dispatch<__nv_bfloat16>(x, out, B, H, W, C, r, relu_on != 0,
                                        s);
  }
  if (dtype == 2) {
    return (int)dispatch<uint8_t>(x, out, B, H, W, C, r, relu_on != 0, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* sr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
