// Greedy non-maximum suppression of sorted candidates for Hopper (sm_90a).
//
// Replaces XLA's lowering of autoware_vision_pilot_tpu/ops/postprocess.py::
// nms_fixed after its top-k (:51-111): the k x k same-class IoU > t matrix,
// the `fori_loop` of k dependent greedy steps (:88-97) and the compaction
// of the kept boxes, in score order, into max_det rows with a valid flag.
// The wrapper (ops/kernels/nms_kernel.py) sorts; the kernel takes the top k
// boxes, scores (below the confidence threshold already -1) and classes.
//
// What bounds it on the H100: neither bytes nor operations. At k = 256 it
// reads 6 KB and writes 1.6 KB (2 ns at 3.35 TB/s) and makes at most k^2/2
// IoU tests (~0.2-0.4 MFLOP, a few ns at 67 TFLOP/s of f32), while eager
// PyTorch ran the loop as ~1,000 launches. What is left is one SM's
// instruction rate and latency: one launch, a pass over the matrix by one
// block, and k dependent steps.
//
// Design: one block of 1024 threads. The candidates go to shared memory,
// with a bitmask of the rows above the threshold. The suppression matrix is
// built in parallel as a bitmask in shared memory (row i, word w: bit b says
// candidate i suppresses candidate 32w + b; k = 256 takes 8 KB, rows padded
// by a word against bank conflicts): a warp per row, a lane per column, a
// word made by a ballot. Only rows above the threshold and words at or
// after the row's own, bits j > i, are built: in the reference's loop a box
// i that is alive at its step never kills an earlier alive box j, since j,
// alive at its own step, would have killed i first (IoU and the class test
// are symmetric bit for bit), so the lower triangle changes nothing, and a
// row below the threshold is never alive. A pair that does not intersect
// skips the division (0 / union = 0). One warp then makes the greedy pass
// with the alive bitmask in registers (lane l holds word l): for each word
// in turn, each lane loads its row's own word, the 32 steps run on
// shuffles of those (the same result in every lane), and each later word
// drops the bits of the word's kept rows by one OR-reduction across the
// lanes. A popc prefix sum over the lanes gives each kept box its row,
// which is capped at max_det; every other output row is zero with valid 0.
//
// Measured on the H100 with chip_smoke.py (PERF.md, section 6): the first
// design, 512 threads, a warp per (row, word) pair found by an integer
// division, every pair divided, and a greedy pass of dependent shared-memory
// loads, took 56.6 us at k = 256 with every candidate live; this one takes
// a quarter of that. Slower or no faster, on the same inputs: greedy passes
// that step over the kept rows' bits with a dependent load each, and a
// division screened by `__fdividef` with the exact one only near the
// threshold.
//
// Bit-equality with the plain version (ops/postprocess.py::
// nms_greedy_plain): the IoU is computed with __fsub_rn, __fmul_rn,
// __fadd_rn and __fdiv_rn in the plain version's order, which nvcc never
// contracts into an FMA, and max/min are PTX's max.NaN / min.NaN, NaN if
// either input is, as torch.maximum / torch.minimum; the decisions are then
// the same, and the outputs are copies of the inputs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int MAX_K = 1024;  // 32 words: one per lane of the greedy warp
constexpr int MAX_DEVICES = 64;
constexpr unsigned FULL = 0xffffffffu;

// torch.maximum / torch.minimum: NaN if either is NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__global__ void __launch_bounds__(THREADS) nms_greedy_kernel(
    const float4* __restrict__ boxes, const float* __restrict__ scores,
    const int* __restrict__ classes, float4* __restrict__ out_boxes,
    float* __restrict__ out_scores, int* __restrict__ out_classes,
    uint8_t* __restrict__ out_valid, int k, int max_det, float iou_t, float conf_t,
    int class_aware) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int nw = (k + 31) / 32, stride = nw + 1;
  float4* box = reinterpret_cast<float4*>(smem);
  float* area = reinterpret_cast<float*>(box + k);
  int* cls = reinterpret_cast<int*>(area + k);
  unsigned* mask = reinterpret_cast<unsigned*>(cls + k);  // k rows of stride words
  __shared__ unsigned live[32];  // the rows above the threshold
  __shared__ unsigned kept[32];
  __shared__ int first[32];  // output row of each word's first kept box
  __shared__ int n_kept;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  for (int i = threadIdx.x; i < k; i += THREADS) {
    const float4 b = boxes[i];
    box[i] = b;
    area[i] = __fmul_rn(max_nan(__fsub_rn(b.z, b.x), 0.0f), max_nan(__fsub_rn(b.w, b.y), 0.0f));
    cls[i] = classes[i];
  }
  for (int w = warp; w < nw; w += THREADS / 32) {
    const int i = 32 * w + lane;
    const unsigned word = __ballot_sync(FULL, i < k && scores[i] >= conf_t);
    if (lane == 0) live[w] = word;
  }
  __syncthreads();

  // the suppression bits: a warp per live row, a lane per column
  for (int i = warp; i < k; i += THREADS / 32) {
    if (!((live[i / 32] >> (i % 32)) & 1u)) continue;
    const float4 a = box[i];
    const float ai = area[i];
    const int ci = cls[i];
    for (int w = i / 32; w < nw; ++w) {
      const int j = 32 * w + lane;
      bool hit = false;
      if (j > i && j < k && (!class_aware || cls[j] == ci)) {
        const float4 b = box[j];
        const float iw = max_nan(__fsub_rn(min_nan(a.z, b.z), max_nan(a.x, b.x)), 0.0f);
        const float ih = max_nan(__fsub_rn(min_nan(a.w, b.w), max_nan(a.y, b.y)), 0.0f);
        const float inter = __fmul_rn(iw, ih);
        const float uni = __fsub_rn(__fadd_rn(ai, area[j]), inter);
        // iou = union > 0 ? inter / union : 0, and 0 / union = 0
        hit = (uni > 0.0f && inter != 0.0f ? __fdiv_rn(inter, uni) : 0.0f) > iou_t;
      }
      const unsigned word = __ballot_sync(FULL, hit);
      if (lane == 0) mask[i * stride + w] = word;
    }
  }
  __syncthreads();

  if (warp == 0) {
    unsigned alive = lane < nw ? live[lane] : 0u;  // lane l: candidates 32l .. 32l + 31
    for (int w = 0; w < nw; ++w) {
      // the word's own steps, in order: a kept row kills later rows of the word
      unsigned cur = __shfl_sync(FULL, alive, w);
      const int i = 32 * w + lane;
      const unsigned diag = (cur >> lane) & 1u ? mask[i * stride + w] : 0u;
#pragma unroll
      for (int b = 0; b < 32; ++b) {
        const unsigned d = __shfl_sync(FULL, diag, b);
        if ((cur >> b) & 1u) cur &= ~d;
      }
      if (lane == w) alive = cur;
      // the later words: drop whatever a kept row of this word suppresses
      const bool mine = (cur >> lane) & 1u;
#pragma unroll 4
      for (int l = w + 1; l < nw; ++l) {
        const unsigned kill = __reduce_or_sync(FULL, mine ? mask[i * stride + l] : 0u);
        if (lane == l) alive &= ~kill;
      }
    }
    const int count = __popc(alive);
    int incl = count;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += v;
    }
    kept[lane] = alive;
    first[lane] = incl - count;
    if (lane == 31) n_kept = incl;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < k; i += THREADS) {
    const unsigned word = kept[i / 32], bit = 1u << (i % 32);
    if (word & bit) {
      const int r = first[i / 32] + __popc(word & (bit - 1));
      if (r < max_det) {
        out_boxes[r] = box[i];
        out_scores[r] = scores[i];
        out_classes[r] = cls[i];
        out_valid[r] = 1;
      }
    }
  }
  for (int r = min(n_kept, max_det) + threadIdx.x; r < max_det; r += THREADS) {
    out_boxes[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    out_scores[r] = 0.0f;
    out_classes[r] = 0;
    out_valid[r] = 0;
  }
}

size_t smem_bytes(int k) {
  return (size_t)k * (sizeof(float4) + sizeof(float) + sizeof(int)) +
         (size_t)k * ((k + 31) / 32 + 1) * sizeof(unsigned);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// boxes: (k, 4) f32 [x1, y1, x2, y2], 16-byte aligned; scores: (k,) f32,
// sorted descending, those below conf_thresh already -1; classes: (k,)
// int32. out_boxes (max_det, 4) f32, 16-byte aligned; out_scores (max_det,)
// f32; out_classes (max_det,) int32; out_valid (max_det,) bytes 0/1.
// 1 <= k <= 1024, max_det >= 1.
extern "C" int avp_nms_greedy(const void* boxes, const void* scores, const void* classes,
                              void* out_boxes, void* out_scores, void* out_classes,
                              void* out_valid, int k, int max_det, float iou_thresh,
                              float conf_thresh, int class_aware, void* stream) {
  if (k < 1 || k > MAX_K || max_det < 1) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)boxes % 16 || (uintptr_t)out_boxes % 16)
    return (int)cudaErrorMisalignedAddress;
  const size_t smem = smem_bytes(k);
  static bool ready[MAX_DEVICES] = {false};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024 && (dev < 0 || dev >= MAX_DEVICES || !ready[dev])) {
    // the largest k; the limit then holds for every smaller one
    err = cudaFuncSetAttribute(nms_greedy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(MAX_K));
    if (err != cudaSuccess) return (int)err;
    if (dev >= 0 && dev < MAX_DEVICES) ready[dev] = true;
  }
  nms_greedy_kernel<<<1, THREADS, smem, (cudaStream_t)stream>>>(
      (const float4*)boxes, (const float*)scores, (const int*)classes, (float4*)out_boxes,
      (float*)out_scores, (int*)out_classes, (uint8_t*)out_valid, k, max_det, iou_thresh,
      conf_thresh, class_aware);
  return (int)cudaGetLastError();
}
