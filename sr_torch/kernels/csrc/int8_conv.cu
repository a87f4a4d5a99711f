// k x k SAME stride-1 convolution as an implicit GEMM for Hopper (sm_90a),
// NHWC activations, weights packed as (k, k, N, Cp), three entries on one
// body:
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
// Bound, at the serving path's shapes (b16, 128x128 LR): bytes. The fused
// body conv 64->64 at 128^2 reads 67.1 MB of f32 and writes 67.1 MB of f32,
// 40 us at 3.35 TB/s, against 9.8 us of int8 operations; the raw entry
// writes an int32 accumulator of the same size. Only the 7x7 64->48 tail is
// bound by operations (about 40 us).
//
// Design. One block of 8 warps computes an output tile of 8 rows x 32
// pixels of one image, for every output channel: it walks the N tiles of 64
// channels itself. Its K loop runs over chunks of 64 bytes of input
// channels; when one chunk holds all of C (every int8 conv of the serving
// path: C = 3 or 64), the input tile plus its k/2 halo is staged into
// shared memory once and serves every N tile -- the 64->256 PS convs read
// and quantize their f32 input once, not four times. Staging writes the MMA
// operand type, zero-filled outside the image and past C; the fused entry
// quantizes as it stages. When C is a whole number of chunks and x (and a
// per-channel scale) is 16-byte aligned, a row piece is one 16-byte load
// (four f32 loads for the fused entry's 16 int8), else one scalar load per
// channel; a small C stages only its 32-byte K step, one 16-byte piece at
// a time. Weights are staged for all nine taps of a 3x3 kernel at once
// (one barrier pair per N tile), or one tap row at a time for larger k,
// in 16-byte vectors: the wrapper packs them once as (k, k, N, Cp), each
// output channel's K run contiguous and zero-padded to Cp, a multiple of
// the chunk, so this copy never needs a scalar path. Each warp owns one
// output row of 32 pixels: two m16 tiles x 64 channels as 2 x 8 m16n8
// accumulators, fed by mma.sync from ldmatrix.x4 loads, each B fragment
// reused for both m16 tiles. int8 m16n8k32 and bf16 m16n8k16 fragments
// have the same byte layout (a K step is 32 bytes), so one body serves
// both types. A shared-memory row is 64 + 16 bytes, so the eight rows of an
// 8x16-byte matrix fall in distinct banks. K steps that hold only the zero
// fill and n8 fragments wholly past N are skipped, so C = 3 costs one K
// step per tap and N = 3 one fragment. The accumulators go through a
// warp's own shared-memory staging area (after the epilogue, for the fused
// entry), so every warp writes its pixels' outputs as 16-byte vectors
// where the alignment allows, and as coalesced words where it does not,
// without a block barrier. Shared memory: 108 KB for 3x3 and 113 KB for
// 7x7, so two blocks share an SM and one's staging overlaps the other's
// products.
//
// Left for later: wgmma, once the kernel is bound by operations and not by
// bytes (today it is bytes); a load that hides the f32 tile's latency (a
// persistent tile loop spilled registers, and a cp.async ring quantized
// from shared memory measured no faster than this load through
// registers); the next conv's quantize, ReLU and the residual add fused
// into the store, which would hand the next conv int8 instead of f32.
//
// Plain C interface for ctypes; the launches return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TH = 8;          // output rows per block, one per warp
constexpr int TW = 32;         // output pixels per row
constexpr int MT = TW / 16;    // m16 tiles per warp
constexpr int NT = 64;         // output channels per block
constexpr int KCB = 64;        // bytes of input channels per K chunk
constexpr int RS = KCB + 16;   // bytes per shared-memory row (pixel / n)
constexpr int SS = NT + 4;     // words per staged output pixel
constexpr int NTHREADS = TH * 32;
constexpr int MAX_SMEM = 232448;  // 227 KB, the most a block may use

constexpr int LOAD_RAW = 0;    // x holds the MMA type
constexpr int LOAD_QUANT = 1;  // x is f32, quantized to int8 as staged
constexpr int STORE_RAW = 0;      // the accumulator
constexpr int STORE_DEQUANT = 1;  // f32(acc) * dq + bias

template <typename T>
using Acc = typename std::conditional<std::is_same<T, int8_t>::value, int,
                                      float>::type;

struct Params {
  const void* x;
  const void* w;  // (k, k, N, Cp)
  void* out;
  const float* mul;  // quantize: x * mul[b * scale_sb + c * scale_sc]
  const float* divisor;  // or x / divisor[...] (mul its reciprocals),
                         // or null
  const float* dq;     // dequantize: dq[b * dq_sb + n]
  const float* bias;   // (N,) or null
  int scale_sb, scale_sc, dq_sb;
  int H, W, C, Cp, N, k, tiles_x;
  bool xvec;  // whole 64-byte chunks of x (and of a per-channel scale),
              // 16-byte aligned: the loads are 16-byte vectors
};

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

// torch.clamp(torch.round(x / d), -127, 127).to(torch.int8) with m the
// correctly rounded 1/d, or with x * m when there is no divisor. x * m is
// within 1.5 * 2^-23 * |x / d| of the correctly rounded quotient, so the
// two round to different integers only when x * m lies that close to a
// half-way point; within 4 * 2^-23 of one the exact division decides.
__device__ __forceinline__ int quantize(float x, float m, float d,
                                        bool divide) {
  float q = __fmul_rn(x, m);
  if (divide) {
    const float a = fabsf(q);
    if (fabsf((a - truncf(a)) - 0.5f) <= a * 0x1p-21f) q = __fdiv_rn(x, d);
  }
  q = fminf(fmaxf(rintf(q), -127.f), 127.f);
  return static_cast<int>(q);
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ int8_t zero<int8_t>() { return 0; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ uint32_t as_bits(int v) {
  return static_cast<uint32_t>(v);
}
__device__ __forceinline__ uint32_t as_bits(float v) {
  return __float_as_uint(v);
}

// tap rows of weights staged at once: all of a 3x3 kernel, else one
__host__ __device__ constexpr int weight_rows(int k) { return k <= 3 ? k : 1; }

__host__ __device__ constexpr int smem_bytes(int k) {
  return ((TH + k - 1) * (TW + k - 1) + weight_rows(k) * k * NT) * RS +
         TH * 16 * SS * 4;
}

// 16 f32 values of channels c ... of sample b -> 16 int8 (the fused
// entry's quantize)
__device__ __forceinline__ uint4 quantize16(const float (&f)[16],
                                            const Params& p, int b, int c) {
  const bool divide = p.divisor != nullptr;
  const float* mp = p.mul + (int64_t)b * p.scale_sb;
  const float* dp = (divide ? p.divisor : p.mul) + (int64_t)b * p.scale_sb;
  uint32_t word[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // four channels at a time
    float m[4], d[4];
    if (p.scale_sc == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        m[i] = __ldg(mp);
        d[i] = __ldg(dp);
      }
    } else if (p.xvec) {  // per channel, 16-byte aligned runs
      const float4 m4 = __ldg(reinterpret_cast<const float4*>(mp + c) + j);
      const float4 d4 = __ldg(reinterpret_cast<const float4*>(dp + c) + j);
      m[0] = m4.x, m[1] = m4.y, m[2] = m4.z, m[3] = m4.w;
      d[0] = d4.x, d[1] = d4.y, d[2] = d4.z, d[3] = d4.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ci = c + 4 * j + i;
        m[i] = ci < p.C ? __ldg(mp + ci) : 1.f;
        d[i] = ci < p.C ? __ldg(dp + ci) : 1.f;
      }
    }
    word[j] = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = quantize(f[4 * j + i], m[i], d[i], divide);
      word[j] |= (static_cast<uint32_t>(q) & 0xffu) << (8 * i);
    }
  }
  return make_uint4(word[0], word[1], word[2], word[3]);
}

// Row piece v (16 bytes of the MMA type: channels c0 + v * 16 / ES ...) of
// pixel (gy, gx), zero outside the image and past C; the fused entry loads
// f32 and quantizes it here
template <typename T, int LOAD>
__device__ __forceinline__ uint4 load_piece(const Params& p, int b, int gy,
                                            int gx, int c0, int v) {
  constexpr int E = 16 / (int)sizeof(T);  // MMA elements per piece
  if (gy < 0 || gy >= p.H || gx < 0 || gx >= p.W) {
    return make_uint4(0u, 0u, 0u, 0u);
  }
  const int64_t pix = ((int64_t)b * p.H + gy) * p.W + gx;
  const int c = c0 + v * E;
  if constexpr (LOAD == LOAD_RAW) {
    const T* src = static_cast<const T*>(p.x) + pix * p.C + c;
    if (p.xvec) return *reinterpret_cast<const uint4*>(src);
    alignas(16) T e[E];
#pragma unroll
    for (int j = 0; j < E; ++j) e[j] = c + j < p.C ? src[j] : zero<T>();
    return *reinterpret_cast<const uint4*>(e);
  } else {
    const float* src = static_cast<const float*>(p.x) + pix * p.C + c;
    float f[E];
    if (p.xvec) {
#pragma unroll
      for (int j = 0; j < E / 4; ++j) {
        const float4 f4 = reinterpret_cast<const float4*>(src)[j];
        f[4 * j] = f4.x;
        f[4 * j + 1] = f4.y;
        f[4 * j + 2] = f4.z;
        f[4 * j + 3] = f4.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < E; ++j) f[j] = c + j < p.C ? src[j] : 0.f;
    }
    return quantize16(f, p, b, c);
  }
}

// two blocks an SM (at most 128 registers a thread): one block's staging
// overlaps the other's products
template <typename T, int LOAD, int STORE>
__global__ void __launch_bounds__(NTHREADS, 2) conv_kernel(const Params p) {
  constexpr int ES = sizeof(T);
  constexpr int KCE = KCB / ES;  // channels per chunk
  constexpr int KSE = 32 / ES;   // channels per K step
  using OutT = typename std::conditional<STORE == STORE_RAW, Acc<T>,
                                         float>::type;
  const int k = p.k, half = k / 2;
  const int HWd = TW + k - 1;  // halo tile columns
  const int HH = TH + k - 1;   // halo tile rows
  const int wrows = weight_rows(k);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* s_x = smem;                  // [HH * HWd][RS]
  unsigned char* s_w = smem + HH * HWd * RS;  // [wrows * k][NT][RS]
  uint32_t* st = reinterpret_cast<uint32_t*>(s_w + wrows * k * NT * RS) +
                 warp * 16 * SS;              // this warp's [16][SS] words

  const int b = blockIdx.y;
  const int ty = blockIdx.x / p.tiles_x;
  const int y0 = ty * TH, x0 = (blockIdx.x - ty * p.tiles_x) * TW;
  const int oy = y0 + warp;
  const T* w = static_cast<const T*>(p.w);
  const float* dq = p.dq + (int64_t)b * p.dq_sb;
  // ldmatrix row addresses of this lane: A matrices (rows 0-7 | 8-15) x
  // (bytes 0-15 | 16-31); B matrices (bytes 0-15 | 16-31) x (n8 | next n8)
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int a_col = 16 * (lane >> 4);
  const int b_row = (lane & 7) + 8 * (lane >> 4);
  const int b_col = 16 * ((lane >> 3) & 1);
  const int g = lane >> 2, tig = lane & 3;
  // the input tile plus halo, channels c0 ... of one chunk -> s_x (two
  // pieces in flight a thread measured slower: the fused entry then needs
  // more than the 128 registers that keep two blocks on an SM; a cp.async
  // ring of f32 quantized from shared memory measured no faster)
  auto stage = [&](int c0, int pieces) {
    for (int i = threadIdx.x; i < HH * HWd * pieces; i += NTHREADS) {
      const int q = i / pieces, v = i - q * pieces;
      *reinterpret_cast<uint4*>(s_x + q * RS + v * 16) = load_piece<T, LOAD>(
          p, b, y0 + q / HWd - half, x0 + q % HWd - half, c0, v);
    }
  };
  auto pieces_of = [&](int c0) {  // 16-byte pieces per staged row
    return 2 * min(KCB / 32, (p.C - c0 + KSE - 1) / KSE);
  };
  // one chunk holds all of C: the tile is staged once, before any
  // accumulator is live, for every N tile
  const bool one_chunk = p.C <= KCE;
  if (one_chunk) stage(0, pieces_of(0));

  for (int n0 = 0; n0 < p.N; n0 += NT) {
    const int nfr = min(NT / 8, (p.N - n0 + 7) / 8);  // n8 fragments in use
    const int nstage = nfr * 8;                       // weight rows staged
    Acc<T> acc[MT][NT / 8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nf = 0; nf < NT / 8; ++nf) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nf][i] = 0;
      }
    }

    for (int c0 = 0; c0 < p.C; c0 += KCE) {
      // K steps of this chunk that hold a real channel; the rest are zero
      const int pieces = pieces_of(c0);
      const int ksteps = pieces / 2;
      if (!one_chunk) {
        __syncthreads();  // every warp is done with the previous chunk
        stage(c0, pieces);
      }
      for (int dy0 = 0; dy0 < k; dy0 += wrows) {
        __syncthreads();  // tile staged; the previous weights are consumed
        // weights (dy0 + r, dx, n, c) of this chunk -> s_w[r * k + dx][n][c]
        const T* wrow = w + (int64_t)dy0 * k * p.N * p.Cp;
        for (int i = threadIdx.x; i < wrows * k * nstage * pieces;
             i += NTHREADS) {
          const int v = i % pieces, row = i / pieces;
          const int n = row % nstage, tap = row / nstage;
          uint4 val = make_uint4(0u, 0u, 0u, 0u);
          if (n0 + n < p.N) {
            val = *reinterpret_cast<const uint4*>(
                wrow + ((int64_t)tap * p.N + n0 + n) * p.Cp + c0 +
                v * (16 / ES));
          }
          *reinterpret_cast<uint4*>(s_w + (tap * NT + n) * RS + v * 16) = val;
        }
        __syncthreads();
        for (int r = 0; r < wrows; ++r) {
          for (int dx = 0; dx < k; ++dx) {
            const unsigned char* xa =
                s_x + ((warp + dy0 + r) * HWd + dx + a_row) * RS + a_col;
            const unsigned char* wb =
                s_w + ((r * k + dx) * NT + b_row) * RS + b_col;
            for (int ks = 0; ks < ksteps; ++ks) {
              uint32_t a[MT][4];
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) {
                ldsm_x4(a[mt], xa + mt * 16 * RS + ks * 32);
              }
#pragma unroll
              for (int np = 0; np < NT / 16; ++np) {
                if (2 * np < nfr) {
                  uint32_t bq[4];  // b0, b1 of fragment 2np, then 2np + 1
                  ldsm_x4(bq, wb + np * 16 * RS + ks * 32);
#pragma unroll
                  for (int mt = 0; mt < MT; ++mt) {
                    mma(acc[mt][2 * np], a[mt], bq[0], bq[1]);
                    if (2 * np + 1 < nfr) {
                      mma(acc[mt][2 * np + 1], a[mt], bq[2], bq[3]);
                    }
                  }
                }
              }
            }
          }
        }
      }
    }

    // accumulator (row g / g+8, column tig*2 / +1) -> this warp's staged
    // [16][SS] words per m16 tile -> out[b, oy, ox, n0 ...] in 16-byte
    // vectors
    const int nn = min(NT, p.N - n0);  // output channels of this N tile
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int px0 = x0 + 16 * mt;
      const int npx = min(16, p.W - px0);
      if (oy >= p.H || npx <= 0) break;  // uniform across the warp
#pragma unroll
      for (int nf = 0; nf < NT / 8; ++nf) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = g + 8 * (i >> 1);
          const int n = nf * 8 + tig * 2 + (i & 1);
          if (n < nn) {
            if constexpr (STORE == STORE_DEQUANT) {
              float v = __fmul_rn(__int2float_rn(acc[mt][nf][i]),
                                  __ldg(dq + n0 + n));
              if (p.bias != nullptr) {
                v = __fadd_rn(v, __ldg(p.bias + n0 + n));
              }
              st[row * SS + n] = as_bits(v);
            } else {
              st[row * SS + n] = as_bits(acc[mt][nf][i]);
            }
          }
        }
      }
      __syncwarp();
      uint32_t* o = reinterpret_cast<uint32_t*>(static_cast<OutT*>(p.out)) +
                    (((int64_t)b * p.H + oy) * p.W + px0) * p.N + n0;
      if (nn == p.N) {  // the 16 pixels' outputs are one contiguous span
        const int len = npx * p.N;
        const int lead =
            (int)(((16 - reinterpret_cast<uintptr_t>(o) % 16) % 16) / 4);
        const int head = min(lead, len);
        const int nvec = (len - head) / 4;
        for (int i = lane; i < head; i += 32) {
          o[i] = st[(i / p.N) * SS + i % p.N];
        }
        for (int v = lane; v < nvec; v += 32) {
          uint32_t e[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int i = head + 4 * v + j;
            e[j] = st[(i / p.N) * SS + i % p.N];
          }
          reinterpret_cast<uint4*>(o + head)[v] =
              make_uint4(e[0], e[1], e[2], e[3]);
        }
        for (int i = head + 4 * nvec + lane; i < len; i += 32) {
          o[i] = st[(i / p.N) * SS + i % p.N];
        }
      } else if (p.N % 4 == 0 && nn % 4 == 0) {  // per pixel, 16-byte pieces
        const int per = nn / 4;
        for (int v = lane; v < npx * per; v += 32) {
          const int px = v / per, j = v - px * per;
          const uint4 e =
              *reinterpret_cast<const uint4*>(st + px * SS + 4 * j);
          *reinterpret_cast<uint4*>(o + (int64_t)px * p.N + 4 * j) = e;
        }
      } else {
        for (int v = lane; v < npx * nn; v += 32) {
          const int px = v / nn, n = v - px * nn;
          o[(int64_t)px * p.N + n] = st[px * SS + n];
        }
      }
      __syncwarp();  // the next m16 tile reuses st
    }
  }
}

template <typename T, int LOAD, int STORE>
cudaError_t launch(Params p, int B, cudaStream_t s) {
  const int k = p.k;
  if (k < 1 || k % 2 == 0 || smem_bytes(k) > MAX_SMEM || p.C < 1 ||
      p.Cp < p.C || p.Cp % (KCB / (int)sizeof(T)) != 0 || B > 65535) {
    return cudaErrorInvalidValue;
  }
  if (B == 0 || p.H == 0 || p.W == 0 || p.N == 0) return cudaSuccess;
  auto aligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  p.xvec = p.C % (KCB / (int)sizeof(T)) == 0 && aligned(p.x) &&
           (p.scale_sc == 0 ||
            (aligned(p.mul) &&
             (p.divisor == nullptr || aligned(p.divisor))));
  auto kernel = conv_kernel<T, LOAD, STORE>;
  // the opt-in above 48 KB, once: a 3x3 conv stages 108 KB
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return attr;
  p.tiles_x = (p.W + TW - 1) / TW;
  const int tiles_y = (p.H + TH - 1) / TH;
  const dim3 grid((unsigned)p.tiles_x * tiles_y, B);
  kernel<<<grid, NTHREADS, smem_bytes(k), s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Raw accumulator. dtype: 0 = int8 in, int32 out; 1 = bfloat16 in, float32
// out. x is (B, H, W, C) and out (B, H, W, N), both contiguous; w is packed
// as (k, k, N, Cp), contiguous, k odd, Cp >= C a multiple of 64 bytes of
// the type, zero past C. Returns a cudaError_t (cudaErrorInvalidValue for an
// even k, a k whose tiles exceed shared memory, C < 1, a bad Cp or
// B > 65535).
extern "C" int sr_conv_im2col(const void* x, const void* w, void* out, int B,
                              int H, int W, int C, int Cp, int N, int k,
                              int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p{};
  p.x = x;
  p.w = w;
  p.out = out;
  p.H = H;
  p.W = W;
  p.C = C;
  p.Cp = Cp;
  p.N = N;
  p.k = k;
  if (dtype == 0) return (int)launch<int8_t, LOAD_RAW, STORE_RAW>(p, B, s);
  if (dtype == 1) {
    return (int)launch<__nv_bfloat16, LOAD_RAW, STORE_RAW>(p, B, s);
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
                                  int W, int C, int Cp, int N, int k,
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
  p.H = H;
  p.W = W;
  p.C = C;
  p.Cp = Cp;
  p.N = N;
  p.k = k;
  return (int)launch<int8_t, LOAD_QUANT, STORE_DEQUANT>(
      p, B, static_cast<cudaStream_t>(stream));
}

extern "C" const char* sr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
