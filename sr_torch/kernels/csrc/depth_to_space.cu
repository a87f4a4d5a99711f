// Pixel shuffle (depth_to_space) in NHWC for Hopper (sm_90a), with the
// preceding conv's bias and an optional ReLU applied on the way:
//
//   out[b, h*r + i, w*r + j, c] = act(x[b, h, w, k] + bias[k]),
//   k = c*r*r + i*r + j
//
// Replaces sr/kernels/depth_to_space.py:_d2s_kernel (the pl.pallas_call at
// line 73), which streamed one LR row per grid step through VMEM and is
// "fusable with a preceding bias+activation". Types: float32, bfloat16,
// and uint8 for the fused-quant tail, which quantizes to u8 before the
// shuffle (no bias for u8). The bias is added in float32 and rounded once
// to the tensor's type, which is what PyTorch's broadcast add of a bias in
// the same type does, so the kernel equals `act(x + bias)` then the shuffle
// bit for bit.
//
// Bound: bytes. Every input element is read once and every output element
// written once: 2 * numel * itemsize over the card's memory rate (3.35
// TB/s on an H100 SXM); the bias is a few hundred bytes.
//
// Design. A block owns one segment of an LR row, (b, h, w0 .. w0+tw), and
// stages it through shared memory, so that both sides of the shuffle move
// contiguous runs of device memory in 16-byte vectors whatever C is:
//   1. Load: the segment is tw * C*r*r contiguous input elements. Each
//      thread reads 16-byte vectors (up to four in flight), adds the bias
//      and applies the ReLU in registers, and writes them to shared memory.
//      Elements before the first and after the last whole 16-byte chunk
//      (an input that starts off a 16-byte boundary) go one by one.
//   2. Store: the segment's r output rows h*r + i are each a contiguous run
//      of tw*r*C elements. Each thread gathers one 16-byte vector of
//      consecutive output elements from shared memory (element e of the
//      run is channel e % C of output pixel e / C) and stores it with one
//      16-byte store. A run's ragged head and tail go one by one.
// Shared memory holds the tile with 4 bytes of padding after every 128
// bytes: the gather reads with a stride of about 16*r bytes between lanes,
// which would put a warp on one or two banks; the padding spreads it.
// The segment width tw holds about kTileBytes of input and is a multiple
// of the pixels that make an output run 16-byte aligned, so interior runs
// start aligned. Several 16 KB tiles fit on an SM, so some blocks load
// while others store.
//
// Limits: fewer than 2^31 input rows (B * H), at most 65535 segments in a
// row, and one LR pixel (C*r*r elements) of at most kMaxPixelBytes. Offsets
// inside a segment are 32-bit; row bases are 64-bit.
//
// Plain C interface for ctypes: the wrapper passes pointers, sizes and the
// CUDA stream; the launch returns cudaGetLastError() as an int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;               // 16-byte loads in flight a thread
constexpr int kTileBytes = 16384;        // staged input per block (target)
constexpr int kMaxPixelBytes = 65536;    // one LR pixel must fit the tile
constexpr int64_t kMaxRows = (int64_t{1} << 31) - 1;  // gridDim.x
constexpr int64_t kMaxSegments = 65535;               // gridDim.y

// Shared-memory byte offset of logical byte p: 4 bytes after every 128.
__device__ __forceinline__ int padded(int p) { return p + ((p >> 7) << 2); }

__host__ __device__ constexpr int padded_size(int bytes) {
  return bytes + ((bytes >> 7) << 2) + 4;
}

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float to_f32(float v) { return v; }
  static __device__ __forceinline__ float from_f32(float v) { return v; }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f32(float v) {
    return __float2bfloat16_rn(v);
  }
};

// act(v + b), the sum in float32 rounded once to T. u8 takes no bias and
// its ReLU is the identity.
template <typename T, bool RELU, bool BIAS>
__device__ __forceinline__ T apply(T v, float b) {
  if constexpr (std::is_same_v<T, uint8_t> || (!RELU && !BIAS)) {
    return v;
  } else {
    float y = Elem<T>::to_f32(v);
    if constexpr (BIAS) y = __fadd_rn(y, b);
    if constexpr (RELU) y = y < 0.f ? 0.f : y;
    return Elem<T>::from_f32(y);
  }
}

template <typename T>
__device__ __forceinline__ float bias_at(const T* __restrict__ bias, int k) {
  return Elem<T>::to_f32(bias[k]);
}

// WHOLE: C is a whole number of 16-byte vectors and every output run of
// the launch starts 16-byte aligned, so a vector never leaves its pixel
// and the gather steps by r*r without the pixel-wrap logic (measurably
// faster than the general body in bf16 at the r=2 serving shapes, the same
// in f32; PERF.md §6).
template <typename T, bool RELU, bool BIAS, bool WHOLE>
__global__ void __launch_bounds__(kThreads)
d2s_staged(const T* __restrict__ x, const T* __restrict__ bias,
           T* __restrict__ out, int W, int C, int r, int tw_full,
           bool bias_vec) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int rr = r * r;
  const int cin = C * rr;
  const int64_t row = blockIdx.x;  // b * H + h
  const int w0 = blockIdx.y * tw_full;
  const int tw = min(tw_full, W - w0);

  // ---- 1. load the segment, bias and ReLU on the way ----
  const int n_in = tw * cin;
  const T* src = x + (row * W + w0) * cin;
  // elements of src's 16-byte chunk before src; the tile keeps the same
  // alignment, so element k of the segment sits at logical byte
  // (lead + k) * sizeof(T)
  const int lead = (int)(((uintptr_t)src & 15) / sizeof(T));
  const int head = min((VEC - lead) % VEC, n_in);
  const int nvec = (n_in - head) / VEC;
  for (int base = 0; base < nvec; base += kUnroll * kThreads) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = base + u * kThreads + tid;
      if (v < nvec) {
        raw[u] = __ldg(reinterpret_cast<const uint4*>(src + head + v * VEC));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = base + u * kThreads + tid;
      if (v >= nvec) continue;
      const int k0 = head + v * VEC;
      alignas(16) T vals[VEC];
      *reinterpret_cast<uint4*>(vals) = raw[u];
      if constexpr (BIAS || RELU) {
        float b[VEC];
        if constexpr (BIAS) {
          int ch = k0 % cin;
          if (bias_vec && lead == 0) {  // ch is a multiple of VEC
            alignas(16) T bv[VEC];
            *reinterpret_cast<uint4*>(bv) =
                __ldg(reinterpret_cast<const uint4*>(bias + ch));
#pragma unroll
            for (int q = 0; q < VEC; ++q) b[q] = Elem<T>::to_f32(bv[q]);
          } else {
#pragma unroll
            for (int q = 0; q < VEC; ++q) {
              b[q] = bias_at(bias, ch);
              ch = ch + 1 == cin ? 0 : ch + 1;
            }
          }
        }
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
          vals[q] = apply<T, RELU, BIAS>(vals[q], BIAS ? b[q] : 0.f);
        }
      }
      // one 16-byte chunk never crosses a 128-byte line: 4 words in a row
      uint32_t* dst = reinterpret_cast<uint32_t*>(
          smem + padded((lead + k0) * (int)sizeof(T)));
      const uint32_t* words = reinterpret_cast<const uint32_t*>(vals);
#pragma unroll
      for (int q = 0; q < 4; ++q) dst[q] = words[q];
    }
  }
  // the ragged head and tail of the segment (under 16 bytes each), one
  // element a thread
  const int tail0 = head + nvec * VEC;
  if (tid < 2 * VEC) {
    const int k = tid < VEC ? tid : tail0 + tid - VEC;
    if ((tid < VEC && k < head) || (tid >= VEC && k < n_in)) {
      float b = 0.f;
      if constexpr (BIAS) b = bias_at(bias, k % cin);
      *reinterpret_cast<T*>(smem + padded((lead + k) * (int)sizeof(T))) =
          apply<T, RELU, BIAS>(src[k], b);
    }
  }
  __syncthreads();

  // ---- 2. store the r output rows of the segment ----
  const int n_out = tw * r * C;               // elements of one run
  const int64_t row_len = (int64_t)W * r * C;  // elements of an output row
  T* dst0 = out + row * r * row_len + (int64_t)w0 * r * C;
  auto gather = [&](int i, int e) -> T {
    const int ow = e / C, c = e - ow * C;
    const int w = ow / r, j = ow - w * r;
    const int s = w * cin + c * rr + i * r + j;
    return *reinterpret_cast<const T*>(smem + padded((lead + s) *
                                                     (int)sizeof(T)));
  };
  const int nv_max = n_out / VEC;
  for (int item = tid; item < r * nv_max; item += kThreads) {
    const int i = item / nv_max;
    const int v = item - i * nv_max;
    T* dst = dst0 + i * row_len;
    const int lead_o = (int)(((uintptr_t)dst & 15) / sizeof(T));
    const int head_o = WHOLE ? 0 : min((VEC - lead_o) % VEC, n_out);
    if (!WHOLE && v >= (n_out - head_o) / VEC) continue;
    const int e0 = head_o + v * VEC;
    alignas(16) T vals[VEC];
    if constexpr (WHOLE) {
      const int ow = e0 / C, c0 = e0 - ow * C;
      const int w = ow / r, j = ow - w * r;
      const int s0 = w * cin + c0 * rr + i * r + j;
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        vals[q] = *reinterpret_cast<const T*>(
            smem + padded((lead + s0 + q * rr) * (int)sizeof(T)));
      }
    } else {
      int ow = e0 / C, c = e0 - ow * C;
      int w = ow / r, j = ow - w * r;
      int s = w * cin + c * rr + i * r + j;
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        vals[q] = *reinterpret_cast<const T*>(
            smem + padded((lead + s) * (int)sizeof(T)));
        if (++c == C) {
          c = 0;
          if (++j == r) {
            j = 0;
            ++w;
          }
          s = w * cin + i * r + j;
        } else {
          s += rr;
        }
      }
    }
    *reinterpret_cast<uint4*>(dst + e0) =
        *reinterpret_cast<const uint4*>(vals);
  }
  if constexpr (!WHOLE) {
    // each run's head (before its first aligned vector) and tail
    for (int item = tid; item < r * 2 * VEC; item += kThreads) {
      const int i = item / (2 * VEC);
      const int q = item - i * 2 * VEC;
      T* dst = dst0 + i * row_len;
      const int lead_o = (int)(((uintptr_t)dst & 15) / sizeof(T));
      const int head_o = min((VEC - lead_o) % VEC, n_out);
      const int tail_o = head_o + (n_out - head_o) / VEC * VEC;
      const int e = q < VEC ? q : tail_o + q - VEC;
      if ((q < VEC && e < head_o) || (q >= VEC && e < n_out)) {
        dst[e] = gather(i, e);
      }
    }
  }
}

struct Launch {
  const void* x;
  const void* bias;
  void* out;
  int64_t rows;
  int W, C, r, tw, segs;
  bool bias_vec;
  cudaStream_t stream;
};

template <typename T, bool RELU, bool BIAS, bool WHOLE>
cudaError_t launch_staged(const Launch& p) {
  constexpr int VEC = 16 / sizeof(T);
  const int smem =
      (padded_size((VEC - 1 + p.tw * p.C * p.r * p.r) * (int)sizeof(T)) + 15)
      / 16 * 16;
  auto kernel = d2s_staged<T, RELU, BIAS, WHOLE>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3((unsigned)p.rows, (unsigned)p.segs), kThreads, smem,
           p.stream>>>(static_cast<const T*>(p.x),
                       static_cast<const T*>(p.bias), static_cast<T*>(p.out),
                       p.W, p.C, p.r, p.tw, p.bias_vec);
  return cudaGetLastError();
}

template <typename T, bool RELU, bool BIAS>
cudaError_t launch_any(const Launch& p, bool whole) {
  return whole ? launch_staged<T, RELU, BIAS, true>(p)
               : launch_staged<T, RELU, BIAS, false>(p);
}

int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

// Segment width in LR pixels: about kTileBytes of input, a multiple of the
// m pixels that keep an output run 16-byte aligned, balanced over the row.
int64_t segment_width(int64_t W, int64_t C, int64_t r, int64_t itemsize) {
  const int64_t pixel = C * r * r * itemsize;
  const int64_t m = 16 / gcd(16, (int)(r * C * itemsize % 16));
  int64_t tw = kTileBytes / pixel;
  if (tw < 1) tw = 1;
  if (tw >= m) tw = tw / m * m;
  const int64_t segs = (W + tw - 1) / tw;
  int64_t balanced = (W + segs - 1) / segs;
  if (tw >= m) balanced = (balanced + m - 1) / m * m;
  return balanced < tw ? balanced : tw;
}

template <typename T>
cudaError_t dispatch(const void* x, const void* bias, void* out, int64_t B,
                     int64_t H, int64_t W, int64_t C, int64_t r, bool relu,
                     cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  if (B * H * W * C == 0) return cudaSuccess;
  const int64_t rows = B * H;
  if (rows > kMaxRows || C * r * r * (int64_t)sizeof(T) > kMaxPixelBytes) {
    return cudaErrorInvalidValue;
  }
  const int tw = (int)segment_width(W, C, r, sizeof(T));
  if ((W + tw - 1) / tw > kMaxSegments) return cudaErrorInvalidValue;
  const Launch p{x, bias, out, rows, (int)W, (int)C, (int)r, tw,
                 (int)((W + tw - 1) / tw),
                 bias != nullptr && (C * r * r) % VEC == 0 &&
                     ((uintptr_t)bias & 15) == 0,
                 s};
  const bool whole = C % VEC == 0 && ((uintptr_t)out & 15) == 0;
  if constexpr (std::is_same_v<T, uint8_t>) {
    if (bias != nullptr) return cudaErrorInvalidValue;
    return launch_any<T, false, false>(p, whole);  // ReLU of u8: identity
  } else {
    if (bias != nullptr) {
      return relu ? launch_any<T, true, true>(p, whole)
                  : launch_any<T, false, true>(p, whole);
    }
    return relu ? launch_any<T, true, false>(p, whole)
                : launch_any<T, false, false>(p, whole);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = uint8. C is the OUTPUT channel
// count; the input has C * r * r channels, and bias (null for none) has
// C * r * r elements of the input's type. Returns a cudaError_t;
// cudaErrorInvalidValue when B * H reaches 2^31, a row needs more than
// 65535 segments, one LR pixel is larger than 64 KiB, or u8 has a bias.
extern "C" int sr_depth_to_space(const void* x, const void* bias, void* out,
                                 int64_t B, int64_t H, int64_t W, int64_t C,
                                 int64_t r, int dtype, int relu_on,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool relu = relu_on != 0;
  if (dtype == 0) {
    return (int)dispatch<float>(x, bias, out, B, H, W, C, r, relu, s);
  }
  if (dtype == 1) {
    return (int)dispatch<__nv_bfloat16>(x, bias, out, B, H, W, C, r, relu, s);
  }
  if (dtype == 2) {
    return (int)dispatch<uint8_t>(x, bias, out, B, H, W, C, r, relu, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Segments of an LR row that a launch would use (its gridDim.y), so the
// wrapper can refuse a shape before it allocates the output.
extern "C" int64_t sr_depth_to_space_segments(int64_t W, int64_t C,
                                              int64_t r, int64_t itemsize) {
  const int64_t tw = segment_width(W, C, r, itemsize);
  return (W + tw - 1) / tw;
}

extern "C" const char* sr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
