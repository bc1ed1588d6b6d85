// Int8 convolution for Hopper (sm_90a): activation quantize + implicit-GEMM
// conv with int32 accumulation and the dequant/bias epilogue.
//
// Replaces the int8 branch of autoware_vision_pilot_tpu/nn/layers.py::Conv2d
// (:81-113), which the JAX package leaves to XLA
// (lax.conv_general_dilated(..., preferred_element_type=int32)):
//   avp_int8_quantize  xq = clip(round_half_even(f32(x) / sx), -127, 127)
//                      with sx a scalar or one scale per input channel
//                      (:103-108), a separate kernel;
//   avp_int8_conv      acc = conv(xq, w) in int32, then
//                      y = cast(f32(acc) * dequant) + bias, with dequant =
//                      sx * w_scale for a scalar sx, w_scale alone for a
//                      per-channel one (whose scales the weights carry)
//                      (:110-113).
// Both take channels_last (NHWC) tensors; the weights are (O, kh, kw, I)
// int8, K = kh*kw*I contiguous, arranged once when a conv is quantized.
//
// What bounds it on the H100: at the main path's shapes, operations. A 3x3
// conv reads each int8 input value ~9 times from the cache and does
// 2*kh*kw*cout operations per input byte: 13,824 for 256->256 at 160x320,
// 27,648 for 1456->768 at 20x40, far above the ~590 operations per byte of
// device memory at which the int8 tensor cores (1,979 TOP/s dense) and
// HBM (3.35 TB/s) balance. Only the SE squeeze convs (M = 1) and the 1x1
// project convs at 10x20 are small enough to be bound by their weight bytes
// and by the launch itself. The quantize kernel is bound by bytes.
//
// Design, a simple and exact first version: 128x128 (or 64x64 where the
// big tiles would leave SMs idle) output tiles, K in steps of 64 bytes
// through a 3-stage cp.async ring in shared memory, im2col rows generated
// on the fly, warp-level mma.sync.m16n8k32 s8 x s8 -> s32 on the tensor
// cores. Zero padding is exact to do on the int8 tensor: quantize(0) == 0,
// so padding commutes with quantization and the loader zero-fills padded
// pixels, the K tail, and the rows and columns beyond M and N (cp.async
// with a source size of 0). wgmma, TMA and a persistent schedule are later
// work.
//
// Numerics: the division is __fdiv_rn and the rounding __float2int_rn
// (half to even, as jnp.round), clamped to +-127, never -128. The epilogue
// is __int2float_rn, __fmul_rn, the cast to the output type, then a
// separate __fadd_rn for the bias: two roundings, never contracted into an
// FMA, as XLA and PyTorch compute them. The accumulators are exact
// (|acc| <= 127^2 * K < 2^31 for K < 133,000).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- quantize

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ signed char quantize_one(float v, float s) {
  int q = __float2int_rn(__fdiv_rn(v, s));
  return (signed char)min(max(q, -127), 127);
}

// Each thread quantizes 4 consecutive values of the flattened (pixels, C)
// tensor; scale has C values if per_channel, else one.
template <typename T>
__global__ void quantize_kernel(const T* __restrict__ x,
                                signed char* __restrict__ xq,
                                const float* __restrict__ scale,
                                int per_channel, long long total, int C) {
  const long long e0 = (blockIdx.x * (long long)blockDim.x + threadIdx.x) * 4;
  if (e0 >= total) return;
  int c = (int)(e0 % C);
  signed char q[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    q[j] = 0;
    if (e0 + j < total) {
      q[j] = quantize_one(to_f32(x[e0 + j]), scale[per_channel ? c : 0]);
    }
    if (++c == C) c = 0;
  }
  if (e0 + 3 < total) {
    *reinterpret_cast<char4*>(xq + e0) = make_char4(q[0], q[1], q[2], q[3]);
  } else {
    for (int j = 0; e0 + j < total; ++j) xq[e0 + j] = q[j];
  }
}

// -------------------------------------------------------------------- conv

constexpr int BK = 64;         // K bytes per tile: 4 chunks of 16
constexpr int LDS = BK + 16;   // smem row pitch: 20 words, so the 8x4
                               // fragment loads of a warp hit 32 banks
constexpr int STAGES = 3;

struct ConvArgs {
  const signed char* x;   // (B, H, W, C) int8
  const signed char* w;   // (N, KH, KW, C) int8
  const float* w_scale;   // (N,)
  const float* x_scale;   // scalar, or null: dequant = w_scale alone
  const void* bias;       // (N,) in the output type, or null
  void* out;              // (B, OH, OW, N): f32, bf16, or int32 acc
  int B, H, W, C, N, KH, KW, pad, OH, OW, M, K;
  int out_kind;           // 0 f32, 1 bf16, 2 the raw int32 accumulators
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int bytes = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D = A(16x32 s8, row) * B(32x8 s8, col) + D, s32 accumulators.
// Fragments (lane = 4*g + t): a0 = A[g][4t..4t+3], a1 = A[g+8][4t..],
// a2 = A[g][16+4t..], a3 = A[g+8][16+4t..]; b0 = B[4t..4t+3][g],
// b1 = B[16+4t..][g]; d0,d1 = D[g][2t, 2t+1], d2,d3 = D[g+8][2t, 2t+1].
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void store_out(const ConvArgs& a, int m, int n,
                                          int acc) {
  const long long i = (long long)m * a.N + n;
  if (a.out_kind == 2) {
    static_cast<int*>(a.out)[i] = acc;
    return;
  }
  const float dq = a.x_scale ? __fmul_rn(a.x_scale[0], a.w_scale[n])
                             : a.w_scale[n];
  const float y = __fmul_rn(__int2float_rn(acc), dq);
  if (a.out_kind == 0) {
    static_cast<float*>(a.out)[i] =
        a.bias ? __fadd_rn(y, static_cast<const float*>(a.bias)[n]) : y;
    return;
  }
  __nv_bfloat16 yb = __float2bfloat16_rn(y);
  if (a.bias) {
    const float b = __bfloat162float(static_cast<const __nv_bfloat16*>(a.bias)[n]);
    yb = __float2bfloat16_rn(__fadd_rn(__bfloat162float(yb), b));
  }
  static_cast<__nv_bfloat16*>(a.out)[i] = yb;
}

// One block computes a BM x BN output tile with (BM/WM) x (BN/WN) warps,
// each a WM x WN tile of m16n8 fragments.
template <int BM, int BN, int WM, int WN>
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

#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + i * 16 + g + (e >> 1) * 8;
        const int n = n0 + wn + j * 8 + t * 2 + (e & 1);
        if (m < a.M && n < a.N) store_out(a, m, n, acc[i][j][e]);
      }
}

template <int BM, int BN, int WM, int WN>
cudaError_t launch_conv(const ConvArgs& a, cudaStream_t stream) {
  constexpr int threads = (BM / WM) * (BN / WN) * 32;
  constexpr int smem = STAGES * (BM + BN) * LDS;
  // on every launch: the attribute belongs to the current device's copy
  const cudaError_t err = cudaFuncSetAttribute(
      int8_conv_kernel<BM, BN, WM, WN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.M + BM - 1) / BM, (a.N + BN - 1) / BN);
  int8_conv_kernel<BM, BN, WM, WN><<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// x: (pixels, C) f32 or bf16 (in_bf16), contiguous; xq: (pixels, C) int8;
// scale: f32, C values if per_channel, else one.
extern "C" int avp_int8_quantize(const void* x, void* xq, const void* scale,
                                 int per_channel, long long pixels, int C,
                                 int in_bf16, void* stream) {
  if (pixels <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const long long total = pixels * C;
  const int threads = 256;
  const long long blocks = (total + 4LL * threads - 1) / (4LL * threads);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* sc = (const float*)scale;
  signed char* q = (signed char*)xq;
  if (in_bf16) {
    quantize_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, s>>>(
        (const __nv_bfloat16*)x, q, sc, per_channel, total, C);
  } else {
    quantize_kernel<float><<<(unsigned)blocks, threads, 0, s>>>(
        (const float*)x, q, sc, per_channel, total, C);
  }
  return (int)cudaGetLastError();
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// xq: (B, H, W, C) int8, C a multiple of 16; w: (N, KH, KW, C) int8;
// w_scale: (N,) f32; x_scale: one f32, or null for a per-channel input
// scale already folded into w; bias: (N,) of the output type, or null;
// out: (B, OH, OW, N) with OH = H + 2*pad - KH + 1 (stride 1), f32
// (out_kind 0), bf16 (1) or the int32 accumulators (2).
extern "C" int avp_int8_conv(const void* xq, const void* w, const void* w_scale,
                             const void* x_scale, const void* bias, void* out,
                             int B, int H, int W, int C, int N, int KH, int KW,
                             int pad, int out_kind, void* stream) {
  ConvArgs a;
  a.x = (const signed char*)xq;
  a.w = (const signed char*)w;
  a.w_scale = (const float*)w_scale;
  a.x_scale = (const float*)x_scale;
  a.bias = bias;
  a.out = out;
  a.B = B; a.H = H; a.W = W; a.C = C; a.N = N;
  a.KH = KH; a.KW = KW; a.pad = pad;
  a.OH = H + 2 * pad - KH + 1;
  a.OW = W + 2 * pad - KW + 1;
  const long long M = (long long)B * a.OH * a.OW;
  const long long K = (long long)KH * KW * C;
  if (B <= 0 || C <= 0 || C % 16 || N <= 0 || a.OH <= 0 || a.OW <= 0 ||
      M > 0x7fffffffLL || K > 0x7fffffffLL || out_kind < 0 || out_kind > 2)
    return (int)cudaErrorInvalidValue;
  a.M = (int)M;
  a.K = (int)K;
  a.out_kind = out_kind;
  cudaStream_t s = (cudaStream_t)stream;
  const long long big_tiles = ((M + 127) / 128) * ((N + 127) / 128);
  if (big_tiles >= 132) return (int)launch_conv<128, 128, 64, 32>(a, s);
  return (int)launch_conv<64, 64, 32, 32>(a, s);
}
