// What the int8 kernels of int8_conv.cu, int8_conv_sm90.cu and
// int8_pointwise.cu share: the SM count of a device, the activation
// quantize of one value (the quantize kernel's, and the pointwise and dot
// routes' on load, so that both give the same int8 values), and the int8
// conv's epilogue, one for every route:
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

// xq = clip(round_half_even(v / s), -127, 127), never -128 (nn/layers.py:
// 103-108): the division is __fdiv_rn and the rounding __float2int_rn (half
// to even, as jnp.round).
__device__ __forceinline__ signed char quantize_one(float v, float s) {
  int q = __float2int_rn(__fdiv_rn(v, s));
  return (signed char)min(max(q, -127), 127);
}

// The two bf16 values of a 32-bit word as f32 (a bf16 is the top half of
// an f32: exact).
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// The same value as quantize_one(v, s), without a division: r = RN64(1/s)
// (given), and RN32(RN64(v * r)) == RN32(v / s) for f32 v and s. Why: the
// double product is within 2^-52 (relative) of v / s, while v / s, unless
// a float itself, lies at least ~2^-50 (relative) from every midpoint
// between two floats, and is never on one (a midpoint has a 25-bit odd
// significand, and such a number times s has more than 24 bits); a
// quotient below 2^-99 (v subnormal; s >= ~1e-8 for any calibrated scale)
// rounds to 0 either way. __fdiv_rn costs a branch per value (a check for
// the slow path), which a kernel with few warps a scheduler cannot hide;
// this is three conversions and a multiply, with no branch.
// tests/test_torch_int8_pointwise.py holds the identity on 40M pairs.
__device__ __forceinline__ signed char quantize_rcp(float v, double r) {
  const int q = __float2int_rn(__double2float_rn(__dmul_rn((double)v, r)));
  return (signed char)min(max(q, -127), 127);
}

// Four of them packed into a word, v[0] in the low byte.
__device__ __forceinline__ uint32_t quantize4_rcp(const float* v, const double* r) {
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    word |= (uint32_t)(uint8_t)quantize_rcp(v[j], r[j]) << (8 * j);
  return word;
}

// A 16-byte copy from global to shared memory that bypasses the registers
// (cp.async.cg); with valid false it writes 16 zeros and reads nothing.
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

// mma.sync.m16n8k32 s8 x s8 -> s32, as the mma.sync and pointwise routes
// issue it. D = A(16x32 s8, row) * B(32x8 s8, col) + D, s32 accumulators.
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

// The same epilogue with column n's factors read ahead: dq = x_scale *
// w_scale[n] (or w_scale[n] alone) and the bias as f32 (0 without one), the
// values dequant and the bias add above read, in the same operations. A
// kernel whose few output tiles leave the loads above exposed reads them
// before its main loop: read after each store, every read waits for the
// store before it (the output may alias them) and, with cold scales, for
// device memory.
struct Column {
  float dq, b;
};

__device__ __forceinline__ Column column(const Epilogue& e, int n) {
  Column c;
  c.dq = e.x_scale ? __fmul_rn(e.x_scale[0], e.w_scale[n]) : e.w_scale[n];
  c.b = !e.bias ? 0.f
        : e.out_kind == 1 ? __bfloat162float(static_cast<const __nv_bfloat16*>(e.bias)[n])
                          : static_cast<const float*>(e.bias)[n];
  return c;
}

__device__ __forceinline__ void store_out(const Epilogue& e, int m, int n, const Column& c,
                                          int acc) {
  const long long i = (long long)m * e.N + n;
  const float y = __fmul_rn(__int2float_rn(acc), c.dq);
  if (e.out_kind == 2) {
    static_cast<int*>(e.out)[i] = acc;
  } else if (e.out_kind == 0) {
    static_cast<float*>(e.out)[i] = e.bias ? __fadd_rn(y, c.b) : y;
  } else {
    __nv_bfloat16 yb = __float2bfloat16_rn(y);
    if (e.bias) yb = __float2bfloat16_rn(__fadd_rn(__bfloat162float(yb), c.b));
    static_cast<__nv_bfloat16*>(e.out)[i] = yb;
  }
}

// Two neighbouring outputs (n, n + 1) of row m with their columns' factors:
// one vector store when both lie inside N and the pair is aligned (N
// even), else one by one.
__device__ __forceinline__ void store_pair(const Epilogue& e, int m, int n, const Column& c0,
                                           const Column& c1, int a0, int a1) {
  if (n + 1 < e.N && (e.N & 1) == 0 && e.out_kind != 2) {
    const long long i = (long long)m * e.N + n;
    const float y0 = __fmul_rn(__int2float_rn(a0), c0.dq);
    const float y1 = __fmul_rn(__int2float_rn(a1), c1.dq);
    if (e.out_kind == 0) {
      *reinterpret_cast<float2*>(static_cast<float*>(e.out) + i) =
          e.bias ? make_float2(__fadd_rn(y0, c0.b), __fadd_rn(y1, c1.b)) : make_float2(y0, y1);
    } else {
      __nv_bfloat162 v;
      v.x = __float2bfloat16_rn(y0);
      v.y = __float2bfloat16_rn(y1);
      if (e.bias) {
        v.x = __float2bfloat16_rn(__fadd_rn(__bfloat162float(v.x), c0.b));
        v.y = __float2bfloat16_rn(__fadd_rn(__bfloat162float(v.y), c1.b));
      }
      *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(e.out) + i) = v;
    }
    return;
  }
  if (n + 1 < e.N && (e.N & 1) == 0) {
    *reinterpret_cast<int2*>(static_cast<int*>(e.out) + (long long)m * e.N + n) =
        make_int2(a0, a1);
    return;
  }
  if (n < e.N) store_out(e, m, n, c0, a0);
  if (n + 1 < e.N) store_out(e, m, n + 1, c1, a1);
}

}  // namespace avp
