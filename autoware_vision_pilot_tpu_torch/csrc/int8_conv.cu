// Int8 convolution for Hopper (sm_90a), part 1: the activation quantize
// kernel. The convs are in int8_conv_sm90.cu (the wgmma/TMA route, its
// split-K form, and the transposed conv's "d2s"), int8_conv_halo.cu (windows
// larger than 1x1 with C < 128, and a 1x1 window with padding) and
// int8_pointwise.cu (the 1x1 routes, pointwise and dot, which quantize as
// they load); ops/kernels/int8_conv.py::int8_conv_plan decides which route
// runs a conv.
//
// Replaces the activation quantize of the int8 branch of
// autoware_vision_pilot_tpu/nn/layers.py::Conv2d (:103-108), which the JAX
// package leaves to XLA:
//   avp_int8_quantize  xq = clip(round_half_even(f32(x) / sx), -127, 127)
//                      with sx a scalar or one scale per input channel,
// on channels_last (NHWC) tensors.
//
// Bound by bytes (a bf16 input is 2 bytes read and 1 written per value).
// Each thread takes 16 consecutive channels of one pixel: two 16-byte loads
// of bf16 (four of f32) and one 16-byte int8 store, with the channel
// computed once per group of 16; a grid-stride loop over a grid sized to the
// SM count; a scalar scale read once, per-channel scales staged in shared
// memory. C must be a multiple of 16 (the wrapper pads).
//
// Numerics: the division is __fdiv_rn and the rounding __float2int_rn
// (half to even, as jnp.round), clamped to +-127, never -128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_common.cuh"

namespace {

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
