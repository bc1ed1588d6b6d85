// Fused frame preprocessing for Hopper (sm_90a).
//
// Replaces autoware_vision_pilot_tpu/ops/pallas/preprocess_kernel.py::
// fused_preprocess_pallas: a uint8 BGR frame -> cv2 INTER_LINEAR resize
// (half-pixel sampling, no antialiasing) -> RGB -> [0,1] -> ImageNet
// mean/std -> one cast to bf16 or f32, written NHWC so that the wrapper's
// NCHW view of it is channels_last and feeds the first conv with no copy.
//
// What bounds it on the H100: bytes. At 720x1280 -> 320x640 its two-tap
// lerp reads 640 of the frame's 720 rows (2.46 MB of uint8) and writes a
// 320x640x3 bf16 image (1.23 MB), 1.1 us at the card's 3.35 TB/s; the
// arithmetic is 4 taps and an affine epilogue per output value. The Pallas
// kernel spent ~2.5 GFLOP of dense matmuls on the same work to keep the
// TPU's matrix unit busy; here each output value is a direct bilinear lerp
// (rows first, then columns, in f32), so only the bytes are paid. The
// source rows and columns and their fractional weights come from host
// tables (ops/preprocess.py::bilinear_taps, computed in float64 as the JAX
// package does), not from coordinates recomputed on the card in f32, which
// would shift the weights.
//
// Design: one block per output row oy of image b (blockIdx.x, blockIdx.y:
// no division). The block copies its two source rows, y0[oy] and y1[oy],
// into shared memory with 16-byte loads (3840 bytes each at 1280 wide;
// a row that does not start on 16 bytes is copied from the 16-byte word
// below it, and bytes outside the frame are read one by one). Each thread
// then makes PX consecutive output pixels (3 * PX values), with its
// column taps x0, x1, fx read as one 8-byte chunk each while the rows
// load, into a shared-memory image of the output row placed at the row's
// own offset from 16 bytes,
// which the block writes out with 16-byte stores (the ragged ends of the
// row value by value). Any output width: the last group of a row may hold
// fewer than PX pixels. PX = 8, one 16-byte chunk of each table, ran at
// 7.6 us: 3 warps a block, too few to hide the latency of the division
// by std (a branch per value); PX = 2 gives 10 warps a block, and the
// division is a multiply by the reciprocal (below). Taps computed on the
// card in float64 with bilinear_taps's operations, in place of the
// tables, were no faster: 4.7 us with the row's alone, 5.2 us with all.
//
// The letterbox (XLA's fusion of autoware_vision_pilot_tpu/ops/
// preprocess.py::letterbox) was a mode of this kernel; it is now a kernel
// of its own, csrc/letterbox.cu.
//
// Every multiply and add is an explicit round-to-nearest intrinsic, which
// the compiler never contracts into an FMA: the kernel then computes the
// plain PyTorch version's operations in the same order, bit for bit. The
// division by std is RN32(RN64(u * RN64(1 / std))), which equals the f32
// division RN32(u / std) for every f32 u and std (the argument is in
// int8_common.cuh::quantize_rcp), with no branch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int MAX_DEVICES = 64;
constexpr int PX = 2;  // output pixels a thread: taps() reads 8-byte chunks

template <typename T>
__device__ __forceinline__ T cast_out(float v);

template <>
__device__ __forceinline__ float cast_out<float>(float v) { return v; }

template <>
__device__ __forceinline__ __nv_bfloat16 cast_out<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, like torch
}

// Output row oy reads source rows y0[oy], y1[oy] with weight fy[oy] on
// y1; output column ox likewise from x0, x1, fx. mean and inv_std (1 / std
// in f64, correctly rounded) are per output (RGB) channel. Every table is
// 16-byte aligned.
struct Tables {
  const int *y0, *y1, *x0, *x1;
  const float *fy, *fx, *mean;
  const double* inv_std;
};

// Bytes of shared memory a copy of `bytes` bytes that starts at any offset
// from 16 needs: whole 16-byte words, one more for the offset.
__host__ __device__ constexpr int span(int bytes) { return (bytes + 15) / 16 * 16 + 16; }

// Copies the `bytes` bytes at src (inside [lo, hi)) to dst + (src % 16),
// 16 bytes at a time: dst is 16-byte aligned and has span(bytes) bytes.
// Returns where the copy of src begins.
__device__ __forceinline__ const uint8_t* copy_row(uint8_t* dst, const uint8_t* src, int bytes,
                                                   const uint8_t* lo, const uint8_t* hi) {
  const uint8_t* a = reinterpret_cast<const uint8_t*>((uintptr_t)src & ~(uintptr_t)15);
  const int words = (int)((src + bytes - a + 15) / 16);
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    const uint8_t* p = a + 16 * i;
    if (p >= lo && p + 16 <= hi) {
      *reinterpret_cast<uint4*>(dst + 16 * i) = __ldg(reinterpret_cast<const uint4*>(p));
    } else {
      for (int j = 0; j < 16; ++j)
        if (p + j >= lo && p + j < hi) dst[16 * i + j] = __ldg(p + j);
    }
  }
  return dst + (src - a);
}

// Writes the `n` values at src (shared, placed at dst % 16 from 16 bytes)
// to dst with 16-byte stores, and the values before the first and after
// the last whole 16-byte word one by one.
template <typename T>
__device__ __forceinline__ void store_row(T* dst, const T* src, int n) {
  const int lead = (int)((uintptr_t)dst % 16);
  const int head = lead ? (16 - lead) / (int)sizeof(T) : 0;  // values before the first word
  const int words = (n - min(head, n)) * (int)sizeof(T) / 16;
  const int tail = head + words * 16 / (int)sizeof(T);
  for (int i = threadIdx.x; i < words; i += blockDim.x)
    reinterpret_cast<uint4*>(dst + head)[i] = reinterpret_cast<const uint4*>(src + head)[i];
  for (int i = threadIdx.x; i < min(head, n); i += blockDim.x) dst[i] = src[i];
  for (int i = tail + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS) fused_preprocess_kernel(
    const uint8_t* __restrict__ frame, T* __restrict__ out, Tables t, long long frame_stride,
    int H, int W, int h, int w) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int oy = blockIdx.x, b = blockIdx.y;
  const int row = 3 * W;  // bytes of a source row
  // image b starts frame_stride bytes after image b - 1 (its rows are
  // contiguous, the images need not be: a crop of a batch); 16-byte reads
  // stay inside the image, the bytes of a word that crosses its ends are
  // read one by one
  const uint8_t* img = frame + (size_t)b * (size_t)frame_stride;
  const uint8_t* lo = img;
  const uint8_t* hi = img + (size_t)H * row;
  // The column taps of a group of PX image pixels: one 8-byte chunk of
  // each table (value by value for a short last group).
  auto taps = [&](int g, int (&x0)[PX], int (&x1)[PX], float (&fx)[PX]) {
    const int ox0 = g * PX, n = min(PX, w - ox0);
    if (n == PX) {
      const int2 a = __ldg(reinterpret_cast<const int2*>(t.x0 + ox0));
      const int2 c = __ldg(reinterpret_cast<const int2*>(t.x1 + ox0));
      const float2 f = __ldg(reinterpret_cast<const float2*>(t.fx + ox0));
      x0[0] = a.x; x0[1] = a.y;
      x1[0] = c.x; x1[1] = c.y;
      fx[0] = f.x; fx[1] = f.y;
    } else {
#pragma unroll
      for (int p = 0; p < PX; ++p) {
        const int ox = ox0 + min(p, n - 1);
        x0[p] = __ldg(t.x0 + ox);
        x1[p] = __ldg(t.x1 + ox);
        fx[p] = __ldg(t.fx + ox);
      }
    }
  };
  // the affine step: [0,1] scale, then the channel's mean and 1 / std
  // (selected, not indexed: an indexed array would live in local memory)
  const float m0 = t.mean[0], m1 = t.mean[1], m2 = t.mean[2];
  const double s0 = t.inv_std[0], s1 = t.inv_std[1], s2 = t.inv_std[2];
  auto affine = [&](float v, int c) {
    v = __fsub_rn(__fmul_rn(v, 1.0f / 255.0f), c == 0 ? m0 : c == 1 ? m1 : m2);
    const double inv_std = c == 0 ? s0 : c == 1 ? s1 : s2;
    return cast_out<T>(__double2float_rn(__dmul_rn((double)v, inv_std)));  // v / std
  };
  T* dst = out + ((size_t)b * h + oy) * w * 3;
  T* o = reinterpret_cast<T*>(smem + 2 * span(row) + (uintptr_t)dst % 16);
  // the first group's taps, read while the rows load
  int x0[PX], x1[PX];
  float fx[PX];
  if ((int)threadIdx.x * PX < w) taps(threadIdx.x, x0, x1, fx);
  const uint8_t* r0 = copy_row(smem, img + (size_t)t.y0[oy] * row, row, lo, hi);
  const uint8_t* r1 = copy_row(smem + span(row), img + (size_t)t.y1[oy] * row, row, lo, hi);
  const float fy = t.fy[oy], gy = __fsub_rn(1.0f, fy);
  __syncthreads();

  for (int g = threadIdx.x; g * PX < w; g += blockDim.x) {
    const int ox0 = g * PX, n = min(PX, w - ox0);
    if (g != (int)threadIdx.x) taps(g, x0, x1, fx);
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      if (p < n) {
        const float gx = __fsub_rn(1.0f, fx[p]);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int ic = 2 - c;  // BGR -> RGB: output channel c reads plane 2-c
          const float t0 = __fadd_rn(__fmul_rn((float)r0[x0[p] * 3 + ic], gy),
                                     __fmul_rn((float)r1[x0[p] * 3 + ic], fy));
          const float t1 = __fadd_rn(__fmul_rn((float)r0[x1[p] * 3 + ic], gy),
                                     __fmul_rn((float)r1[x1[p] * 3 + ic], fy));
          o[(ox0 + p) * 3 + c] = affine(__fadd_rn(__fmul_rn(t0, gx), __fmul_rn(t1, fx[p])), c);
        }
      }
    }
  }
  __syncthreads();
  store_row(dst, o, w * 3);
}

template <typename T>
cudaError_t launch(const uint8_t* frame, T* out, const Tables& t, long long stride, int B, int H,
                   int W, int h, int w, cudaStream_t s) {
  const int groups = (w + PX - 1) / PX;
  const int threads = min(MAX_THREADS, (groups + 31) / 32 * 32);
  const size_t smem = 2 * (size_t)span(3 * W) + span(3 * w * (int)sizeof(T));
  static bool ready[MAX_DEVICES] = {false};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (smem > 48 * 1024 && (dev < 0 || dev >= MAX_DEVICES || !ready[dev])) {
    // the largest rows; the limit then holds for every smaller frame
    err = cudaFuncSetAttribute(fused_preprocess_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (err != cudaSuccess) return err;
    if (dev >= 0 && dev < MAX_DEVICES) ready[dev] = true;
  }
  fused_preprocess_kernel<T><<<dim3((unsigned)h, (unsigned)B), threads, smem, s>>>(
      frame, out, t, stride, H, W, h, w);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// frame: B images of (H, W, 3) uint8, each contiguous, frame_stride bytes
// apart (any stride >= 0, such as a row crop of a batch: frames[:, y0:]);
// out: (B, h, w, 3) bf16 if out_bf16 else f32,
// 16-byte aligned. y0, y1, x0, x1: int32 and fy, fx: f32, the taps of
// bilinear_taps(H, h) and (W, w);
// mean[3]: f32; inv_std[3]: f64, 1 / std correctly rounded (see Tables);
// each table 16-byte aligned. Two source rows and an output row must fit
// in 227 KB of shared memory (W up to ~30,000).
extern "C" int avp_fused_preprocess(const void* frame, void* out, const void* y0,
                                    const void* y1, const void* fy, const void* x0,
                                    const void* x1, const void* fx, const void* mean,
                                    const void* inv_std, long long frame_stride, int B,
                                    int H, int W, int h, int w, int out_bf16, void* stream) {
  if (B <= 0 || B > 65535 || frame_stride < 0 || H <= 0 || W <= 0 || h <= 0 || w <= 0 ||
      2LL * span(3 * W) + span(3 * w * (out_bf16 ? 2 : 4)) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  const void* aligned[] = {out, y0, y1, fy, x0, x1, fx, mean, inv_std};
  for (const void* p : aligned)
    if ((uintptr_t)p % 16) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* f = (const uint8_t*)frame;
  const Tables t{(const int*)y0,   (const int*)y1,   (const int*)x0,
                 (const int*)x1,   (const float*)fy, (const float*)fx,
                 (const float*)mean, (const double*)inv_std};
  return (int)(out_bf16 ? launch(f, (__nv_bfloat16*)out, t, frame_stride, B, H, W, h, w, s)
                        : launch(f, (float*)out, t, frame_stride, B, H, W, h, w, s));
}
