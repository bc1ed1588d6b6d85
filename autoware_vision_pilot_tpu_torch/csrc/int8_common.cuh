// What the int8 kernels of int8_conv.cu and int8_conv_sm90.cu share: the
// SM count of a device, and the int8 conv's epilogue, one for every route:
//   y = cast(f32(acc) * dequant) + bias, dequant = x_scale * w_scale[n] for
//   a scalar input scale, w_scale[n] alone for a per-channel one (folded
//   into the weights), or the int32 accumulators themselves.
// Numerics as autoware_vision_pilot_tpu/nn/layers.py:110-113 computes them
// op by op: __int2float_rn, __fmul_rn, the cast to the output type, then a
// separate __fadd_rn for the bias (two roundings, never an FMA).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace avp {

constexpr int MAX_DEVICES = 64;

// The device's SM count, read once per device (132 if it cannot be read).
inline int sm_count(int dev) {
  static int cached[MAX_DEVICES] = {0};
  if (dev < 0 || dev >= MAX_DEVICES) return 132;
  if (cached[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
      n = 132;
    cached[dev] = n;
  }
  return cached[dev];
}

struct Epilogue {
  const float* w_scale;  // (N,)
  const float* x_scale;  // scalar, or null: dequant = w_scale alone
  const void* bias;      // (N,) in the output type, or null
  void* out;             // (M, N): f32, bf16, or int32 accumulators
  int N;
  int out_kind;          // 0 f32, 1 bf16, 2 the raw int32 accumulators
};

__device__ __forceinline__ float dequant(const Epilogue& e, int n, int acc) {
  const float dq = e.x_scale ? __fmul_rn(e.x_scale[0], e.w_scale[n]) : e.w_scale[n];
  return __fmul_rn(__int2float_rn(acc), dq);
}

__device__ __forceinline__ __nv_bfloat16 to_bf16_out(const Epilogue& e, int n,
                                                     int acc) {
  __nv_bfloat16 yb = __float2bfloat16_rn(dequant(e, n, acc));
  if (e.bias) {
    const float b = __bfloat162float(static_cast<const __nv_bfloat16*>(e.bias)[n]);
    yb = __float2bfloat16_rn(__fadd_rn(__bfloat162float(yb), b));
  }
  return yb;
}

__device__ __forceinline__ float to_f32_out(const Epilogue& e, int n, int acc) {
  const float y = dequant(e, n, acc);
  return e.bias ? __fadd_rn(y, static_cast<const float*>(e.bias)[n]) : y;
}

// One output element.
__device__ __forceinline__ void store_out(const Epilogue& e, int m, int n, int acc) {
  const long long i = (long long)m * e.N + n;
  if (e.out_kind == 2) {
    static_cast<int*>(e.out)[i] = acc;
  } else if (e.out_kind == 0) {
    static_cast<float*>(e.out)[i] = to_f32_out(e, n, acc);
  } else {
    static_cast<__nv_bfloat16*>(e.out)[i] = to_bf16_out(e, n, acc);
  }
}

// Two neighbouring outputs (n, n + 1) of row m, as one vector store when
// both lie inside N and the pair is aligned (N even), else one by one.
__device__ __forceinline__ void store_pair(const Epilogue& e, int m, int n,
                                           int a0, int a1) {
  if (n + 1 < e.N && (e.N & 1) == 0) {
    const long long i = (long long)m * e.N + n;
    if (e.out_kind == 2) {
      *reinterpret_cast<int2*>(static_cast<int*>(e.out) + i) = make_int2(a0, a1);
    } else if (e.out_kind == 0) {
      *reinterpret_cast<float2*>(static_cast<float*>(e.out) + i) =
          make_float2(to_f32_out(e, n, a0), to_f32_out(e, n + 1, a1));
    } else {
      __nv_bfloat162 v;
      v.x = to_bf16_out(e, n, a0);
      v.y = to_bf16_out(e, n + 1, a1);
      *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(e.out) + i) = v;
    }
    return;
  }
  if (n < e.N) store_out(e, m, n, a0);
  if (n + 1 < e.N) store_out(e, m, n + 1, a1);
}

}  // namespace avp
