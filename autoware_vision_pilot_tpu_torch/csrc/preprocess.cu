// Fused frame preprocessing for Hopper (sm_90a).
//
// Replaces autoware_vision_pilot_tpu/ops/pallas/preprocess_kernel.py::
// fused_preprocess_pallas: a uint8 BGR frame -> cv2 INTER_LINEAR resize
// (half-pixel sampling, no antialiasing) -> RGB -> [0,1] -> ImageNet
// mean/std -> one cast to bf16 or f32, written NHWC so that the wrapper's
// NCHW view of it is channels_last and feeds the first conv with no copy.
//
// What bounds it on the H100: bytes. A 720x1280 frame is 2.76 MB of uint8
// read and a 320x640x3 bf16 image is 1.23 MB written, about 1.2 us at the
// card's 3.35 TB/s; the arithmetic is 4 taps and an affine epilogue per
// output value. The Pallas kernel spent ~2.5 GFLOP of dense matmuls on the
// same work to keep the TPU's matrix unit busy; here each output pixel is
// one thread doing a direct bilinear lerp (rows first, then columns, in
// f32), so only the bytes are paid. The source rows and columns and their
// fractional weights come from host tables (ops/preprocess.py::
// bilinear_taps, computed in float64 as the JAX package does), not from
// coordinates recomputed on the card in f32, which would shift the weights.
//
// Every multiply and add is an explicit round-to-nearest intrinsic, which
// the compiler never contracts into an FMA: the kernel then computes the
// plain PyTorch version's operations in the same order, bit for bit.
// Later work: 16-byte vector loads and stores, and fusing into the stem
// conv.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ T cast_out(float v);

template <>
__device__ __forceinline__ float cast_out<float>(float v) { return v; }

template <>
__device__ __forceinline__ __nv_bfloat16 cast_out<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, like torch
}

// Output row oy reads source rows y0[oy], y1[oy] with weight fy[oy] on
// y1; output column ox likewise from x0, x1, fx. mean and stdv are per
// output (RGB) channel.
struct Tables {
  const int *y0, *y1, *x0, *x1;
  const float *fy, *fx, *mean, *stdv;
};

template <typename T>
__global__ void fused_preprocess_kernel(const uint8_t* __restrict__ frame,
                                        T* __restrict__ out, Tables t, int B,
                                        int H, int W, int h, int w) {
  const long long n = (long long)B * h * w;
  for (long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x; p < n;
       p += (long long)gridDim.x * blockDim.x) {
    const int ox = (int)(p % w);
    const long long r = p / w;
    const int oy = (int)(r % h);
    const int b = (int)(r / h);

    const int y0 = t.y0[oy], y1 = t.y1[oy], x0 = t.x0[ox], x1 = t.x1[ox];
    const float fy = t.fy[oy], fx = t.fx[ox];
    const float gy = __fsub_rn(1.0f, fy), gx = __fsub_rn(1.0f, fx);

    const uint8_t* img = frame + (size_t)b * H * W * 3;
    const uint8_t* r0 = img + (size_t)y0 * W * 3;
    const uint8_t* r1 = img + (size_t)y1 * W * 3;
    T* o = out + (size_t)p * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int ic = 2 - c;  // BGR -> RGB: output channel c reads plane 2-c
      const float t0 = __fadd_rn(__fmul_rn((float)r0[x0 * 3 + ic], gy),
                                 __fmul_rn((float)r1[x0 * 3 + ic], fy));
      const float t1 = __fadd_rn(__fmul_rn((float)r0[x1 * 3 + ic], gy),
                                 __fmul_rn((float)r1[x1 * 3 + ic], fy));
      float v = __fadd_rn(__fmul_rn(t0, gx), __fmul_rn(t1, fx));
      v = __fdiv_rn(__fsub_rn(__fmul_rn(v, 1.0f / 255.0f), t.mean[c]),
                    t.stdv[c]);
      o[c] = cast_out<T>(v);
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// frame: (B, H, W, 3) uint8; out: (B, h, w, 3) bf16 if out_bf16 else f32.
// y0, y1, x0, x1: int32; fy, fx, mean[3], stdv[3]: f32 (see Tables).
extern "C" int avp_fused_preprocess(
    const void* frame, void* out, const void* y0, const void* y1,
    const void* fy, const void* x0, const void* x1, const void* fx,
    const void* mean, const void* stdv, int B, int H, int W, int h, int w,
    int out_bf16, void* stream) {
  const long long n = (long long)B * h * w;
  if (n <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride loop covers the rest
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* f = (const uint8_t*)frame;
  const Tables t{(const int*)y0,   (const int*)y1,   (const int*)x0,
                 (const int*)x1,   (const float*)fy, (const float*)fx,
                 (const float*)mean, (const float*)stdv};
  if (out_bf16) {
    fused_preprocess_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, s>>>(
        f, (__nv_bfloat16*)out, t, B, H, W, h, w);
  } else {
    fused_preprocess_kernel<float><<<(unsigned)blocks, threads, 0, s>>>(
        f, (float*)out, t, B, H, W, h, w);
  }
  return (int)cudaGetLastError();
}
