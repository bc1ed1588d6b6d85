// Int8 convolution for Hopper (sm_90a), part 1: the activation quantize
// kernel and the mma.sync conv route. The wgmma/TMA route and its split-K
// form are in int8_conv_sm90.cu, the 1x1 routes (pointwise and dot, which
// quantize as they load) in int8_pointwise.cu;
// ops/kernels/int8_conv.py::int8_conv_plan decides which route runs a conv.
//
// Replaces the int8 branch of autoware_vision_pilot_tpu/nn/layers.py::Conv2d
// (:81-113), which the JAX package leaves to XLA
// (lax.conv_general_dilated(..., preferred_element_type=int32)):
//   avp_int8_quantize  xq = clip(round_half_even(f32(x) / sx), -127, 127)
//                      with sx a scalar or one scale per input channel
//                      (:103-108), a separate kernel;
//   avp_int8_conv_mma  acc = conv(xq, w) in int32, then the epilogue of
//                      int8_common.cuh (:110-113).
// Both take channels_last (NHWC) tensors; the weights are (O, kh, kw, I)
// int8, K = kh*kw*I contiguous, arranged once when a conv is quantized.
//
// Quantize: bound by bytes (a bf16 input is 2 bytes read and 1 written per
// value). Each thread takes 16 consecutive channels of one pixel: two
// 16-byte loads of bf16 (four of f32) and one 16-byte int8 store, with the
// channel computed once per group of 16; a grid-stride loop over a grid
// sized to the SM count; a scalar scale read once, per-channel scales
// staged in shared memory. C must be a multiple of 16 (the wrapper pads).
//
// The mma.sync route: warp-level mma.sync.m16n8k32 s8 x s8 -> s32, 128x128
// or 64x64 tiles (the plan's choice), K in steps of 64 bytes through a
// 3-stage cp.async ring, im2col rows generated on the fly; cp.async with a
// source size of 0 zero-fills padded pixels, the K tail and the rows and
// columns beyond M and N (quantize(0) == 0, so padding commutes with
// quantization). The plan keeps on it what no other route takes: windows
// larger than 1x1 with C < 128, and a 1x1 window with padding. (Until the
// pointwise and dot routes, it ran every 1x1 and SE conv of the main path.)
//
// Numerics: the division is __fdiv_rn and the rounding __float2int_rn
// (half to even, as jnp.round), clamped to +-127, never -128. The
// accumulators are exact (|acc| <= 127^2 * K < 2^31 for K < 133,144).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_common.cuh"

namespace {

using avp::cp_async16;
using avp::cp_async_commit;
using avp::cp_async_wait;
using avp::lds32;
using avp::MAX_DEVICES;
using avp::mma_s8;
using avp::sm_count;

// ---------------------------------------------------------------- quantize

__device__ __forceinline__ void load16(const float* p, float (&v)[16]) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 f = __ldg(q + j);
    v[4 * j] = f.x; v[4 * j + 1] = f.y; v[4 * j + 2] = f.z; v[4 * j + 3] = f.w;
  }
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[16]) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const uint4 u = __ldg(q + j);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[8 * j + 2 * i] = avp::bf16_lo(w[i]);
      v[8 * j + 2 * i + 1] = avp::bf16_hi(w[i]);
    }
  }
}

// groups = pixels * C / 16; group g holds channels (g % (C/16)) * 16 + 0..15
// of pixel g / (C/16).
template <typename T>
__global__ void __launch_bounds__(256) quantize_kernel(
    const T* __restrict__ x, signed char* __restrict__ xq,
    const float* __restrict__ scale, int per_channel, long long groups, int C) {
  extern __shared__ float s_scale[];  // C values when per_channel
  float s0 = 0.f;
  if (per_channel) {
    for (int c = threadIdx.x; c < C; c += blockDim.x) s_scale[c] = scale[c];
    __syncthreads();
  } else {
    s0 = __ldg(scale);
  }
  const int cg = C / 16;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       g < groups; g += step) {
    float v[16];
    load16(x + g * 16, v);
    const int c0 = (int)(g % cg) * 16;
    uint32_t packed[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = 4 * i + j;
        const float s = per_channel ? s_scale[c0 + k] : s0;
        word |= (uint32_t)(uint8_t)avp::quantize_one(v[k], s) << (8 * j);
      }
      packed[i] = word;
    }
    *reinterpret_cast<uint4*>(xq + g * 16) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
}

// ------------------------------------------------------------ mma.sync conv

constexpr int BK = 64;         // K bytes per tile: 4 chunks of 16
constexpr int LDS = BK + 16;   // smem row pitch: 20 words, so the 8x4
                               // fragment loads of a warp hit 32 banks
constexpr int STAGES = 3;

struct ConvArgs {
  const signed char* x;   // (B, H, W, C) int8
  const signed char* w;   // (N, KH, KW, C) int8
  avp::Epilogue e;        // out (B, OH, OW, N)
  int B, H, W, C, N, KH, KW, pad, OH, OW, M, K;
};

// One block computes a BM x BN output tile with (BM/WM) x (BN/WN) warps,
// each a WM x WN tile of m16n8 fragments. OUT_KIND is a.e.out_kind, fixed
// at compile time so that the epilogue holds the code of one output type.
template <int BM, int BN, int WM, int WN, int OUT_KIND>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32)
    int8_conv_kernel(const ConvArgs a) {
  constexpr int NT = (BM / WM) * (BN / WN) * 32;
  constexpr int MI = WM / 16, NJ = WN / 8;
  constexpr int ROWS = NT / 4;  // rows one pass of the loader covers
  constexpr int A_CH = BM / ROWS, B_CH = BN / ROWS;
  static_assert(BM % ROWS == 0 && BN % ROWS == 0, "tile vs threads");

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* As = smem;                       // [STAGES][BM][LDS]
  unsigned char* Bs = smem + STAGES * BM * LDS;   // [STAGES][BN][LDS]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp % (BM / WM)) * WM, wn = (warp / (BM / WM)) * WN;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  // The loader: thread tid copies the 16-byte chunk kc of rows
  // tid/4 + i*ROWS in every tile, so its output pixels are fixed and only
  // its position in K moves.
  const int kc = (tid % 4) * 16;
  const int row0 = tid / 4;
  int a_ih[A_CH], a_iw[A_CH];
  long long a_img[A_CH];
#pragma unroll
  for (int i = 0; i < A_CH; ++i) {
    const int m = m0 + row0 + i * ROWS;
    if (m < a.M) {
      const int b = m / (a.OH * a.OW), rem = m % (a.OH * a.OW);
      a_ih[i] = rem / a.OW - a.pad;
      a_iw[i] = rem % a.OW - a.pad;
      a_img[i] = (long long)b * a.H * a.W;
    } else {
      a_ih[i] = -(1 << 30);  // never inside the image
      a_iw[i] = 0;
      a_img[i] = 0;
    }
  }
  // K position of this thread's chunk: k = (r*KW + s)*C + c.
  int kr = kc / a.C, kcin = kc % a.C;
  int ks = kr % a.KW;
  kr /= a.KW;
  int kb = kc;  // the same k, for the weights

  auto load_tile = [&](int stage) {
    unsigned char* as = As + stage * BM * LDS;
    unsigned char* bs = Bs + stage * BN * LDS;
    const bool k_ok = kr < a.KH;
#pragma unroll
    for (int i = 0; i < A_CH; ++i) {
      const int ih = a_ih[i] + kr, iw = a_iw[i] + ks;
      const bool ok = k_ok && ih >= 0 && ih < a.H && iw >= 0 && iw < a.W;
      const signed char* src =
          ok ? a.x + (a_img[i] + (long long)ih * a.W + iw) * a.C + kcin : a.x;
      cp_async16(as + (row0 + i * ROWS) * LDS + kc, src, ok);
    }
#pragma unroll
    for (int j = 0; j < B_CH; ++j) {
      const int n = n0 + row0 + j * ROWS;
      const bool ok = n < a.N && kb < a.K;
      const signed char* src = ok ? a.w + (long long)n * a.K + kb : a.w;
      cp_async16(bs + (row0 + j * ROWS) * LDS + kc, src, ok);
    }
    // advance to the next tile's k
    kb += BK;
    kcin += BK;
    while (kcin >= a.C) {
      kcin -= a.C;
      if (++ks == a.KW) {
        ks = 0;
        ++kr;
      }
    }
  };

  int acc[MI][NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int KT = (a.K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_tile(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed (this thread's part)
    __syncthreads();              // ... everyone's; stage kt-1 is free
    if (kt + STAGES - 1 < KT) load_tile((kt + STAGES - 1) % STAGES);
    cp_async_commit();

    const unsigned char* as = As + (kt % STAGES) * BM * LDS;
    const unsigned char* bs = Bs + (kt % STAGES) * BN * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[MI][4], bf[NJ][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const unsigned char* p = as + (wm + i * 16 + g) * LDS + kk + t * 4;
        af[i][0] = lds32(p);
        af[i][1] = lds32(p + 8 * LDS);
        af[i][2] = lds32(p + 16);
        af[i][3] = lds32(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const unsigned char* p = bs + (wn + j * 8 + g) * LDS + kk + t * 4;
        bf[j][0] = lds32(p);
        bf[j][1] = lds32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
  }
  cp_async_wait<0>();

  avp::Epilogue e = a.e;
  e.out_kind = OUT_KIND;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + i * 16 + g + h * 8;
        const int n = n0 + wn + j * 8 + t * 2;
        if (m < a.M) avp::store_pair(e, m, n, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
}

// The dynamic shared-memory limit is set once per kernel and device.
template <int BM, int BN, int WM, int WN, int OUT_KIND>
cudaError_t launch_kind(const ConvArgs& a, unsigned grid_x, unsigned grid_y,
                        cudaStream_t stream) {
  constexpr int threads = (BM / WM) * (BN / WN) * 32;
  constexpr int smem = STAGES * (BM + BN) * LDS;
  static bool ready[MAX_DEVICES] = {false};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES || !ready[dev]) {
    err = cudaFuncSetAttribute(int8_conv_kernel<BM, BN, WM, WN, OUT_KIND>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (dev >= 0 && dev < MAX_DEVICES) ready[dev] = true;
  }
  int8_conv_kernel<BM, BN, WM, WN, OUT_KIND><<<dim3(grid_x, grid_y), threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int BM, int BN, int WM, int WN>
cudaError_t launch_conv(const ConvArgs& a, unsigned grid_x, unsigned grid_y,
                        cudaStream_t stream) {
  if (a.e.out_kind == 0) return launch_kind<BM, BN, WM, WN, 0>(a, grid_x, grid_y, stream);
  if (a.e.out_kind == 1) return launch_kind<BM, BN, WM, WN, 1>(a, grid_x, grid_y, stream);
  return launch_kind<BM, BN, WM, WN, 2>(a, grid_x, grid_y, stream);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// x: (pixels, C) f32 or bf16 (in_bf16), contiguous, 16-byte aligned, C a
// multiple of 16; xq: (pixels, C) int8, 16-byte aligned; scale: f32, C
// values if per_channel, else one.
extern "C" int avp_int8_quantize(const void* x, void* xq, const void* scale,
                                 int per_channel, long long pixels, int C,
                                 int in_bf16, void* stream) {
  if (pixels <= 0 || C <= 0 || C % 16) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)x % 16 || (uintptr_t)xq % 16) return (int)cudaErrorMisalignedAddress;
  const long long groups = pixels * (C / 16);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const long long want = (groups + threads - 1) / threads;
  const long long cap = 8LL * sm_count(dev);  // 8 blocks of 256 per SM
  const unsigned blocks = (unsigned)(want < cap ? want : cap);
  const size_t smem = per_channel ? (size_t)C * sizeof(float) : 0;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* sc = (const float*)scale;
  signed char* q = (signed char*)xq;
  if (in_bf16) {
    quantize_kernel<__nv_bfloat16><<<blocks, threads, smem, s>>>(
        (const __nv_bfloat16*)x, q, sc, per_channel, groups, C);
  } else {
    quantize_kernel<float><<<blocks, threads, smem, s>>>(
        (const float*)x, q, sc, per_channel, groups, C);
  }
  return (int)cudaGetLastError();
}

// Launches the mma.sync route on `stream` and returns cudaGetLastError()
// (0 on success). xq: (B, H, W, C) int8, C a multiple of 16; w: (N, KH, KW,
// C) int8; w_scale: (N,) f32; x_scale: one f32, or null for a per-channel
// input scale already folded into w; bias: (N,) of the output type, or
// null; out: (B, OH, OW, N) with OH = H + 2*pad - KH + 1 (stride 1), f32
// (out_kind 0), bf16 (1) or the int32 accumulators (2). bm (128 or 64) and
// the grid are the plan's.
extern "C" int avp_int8_conv_mma(const void* xq, const void* w, const void* w_scale,
                                 const void* x_scale, const void* bias, void* out,
                                 int B, int H, int W, int C, int N, int KH, int KW,
                                 int pad, int out_kind, int bm, int grid_x,
                                 int grid_y, void* stream) {
  ConvArgs a;
  a.x = (const signed char*)xq;
  a.w = (const signed char*)w;
  a.e.w_scale = (const float*)w_scale;
  a.e.x_scale = (const float*)x_scale;
  a.e.bias = bias;
  a.e.out = out;
  a.e.N = N;
  a.e.out_kind = out_kind;
  a.B = B; a.H = H; a.W = W; a.C = C; a.N = N;
  a.KH = KH; a.KW = KW; a.pad = pad;
  a.OH = H + 2 * pad - KH + 1;
  a.OW = W + 2 * pad - KW + 1;
  const long long M = (long long)B * a.OH * a.OW;
  const long long K = (long long)KH * KW * C;
  if (B <= 0 || C <= 0 || C % 16 || N <= 0 || a.OH <= 0 || a.OW <= 0 ||
      M > 0x7fffffffLL || K > 0x7fffffffLL || out_kind < 0 || out_kind > 2 ||
      grid_x <= 0 || grid_y <= 0 || (bm != 128 && bm != 64) ||
      (long long)grid_x * bm < M || (long long)grid_y * bm < N)
    return (int)cudaErrorInvalidValue;
  a.M = (int)M;
  a.K = (int)K;
  cudaStream_t s = (cudaStream_t)stream;
  if (bm == 128) return (int)launch_conv<128, 128, 64, 32>(a, grid_x, grid_y, s);
  return (int)launch_conv<64, 64, 32, 32>(a, grid_x, grid_y, s);
}
