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
// PyTorch ran the loop as ~1,000 launches. What is left is instruction
// issue over the matrix, which the cluster spreads over up to 8 SMs, and
// latency: k dependent greedy steps.
//
// Design: a thread-block cluster of cs blocks (cs = min(8, ceil(k / 32)),
// chosen by the wrapper), 512 threads each.
//   1. Every block stages the candidates in its shared memory. Block r
//      builds the suppression bits of rows r, r + cs, ... (row i, word w:
//      bit b says candidate i suppresses candidate 32w + b), dealt to its
//      warps back and forth so that each gets long and short rows: a warp
//      per row, a lane per column, a word a ballot. Each word goes into
//      block 0's shared memory with st.async, which completes its bytes on
//      block 0's mbarrier; block 0 expects 4 bytes for each word at or
//      after a live row's own. The words are kept by word (word w of row i
//      at w * tstride + i), so that the greedy pass reads them 16 bytes at
//      a time without bank conflicts. Only rows above the threshold and
//      words at or after the row's own, bits j > i, are built: in the
//      reference's loop a box i that is alive at its step never kills an
//      earlier alive box j, since j, alive at its own step, would have
//      killed i first (IoU and the class test are symmetric bit for bit),
//      so the lower triangle changes nothing, and a row below the
//      threshold is never alive. A pair that does not intersect skips the
//      division (0 / union = 0). The arrivals at a cluster barrier on
//      entry, waited on before the first store, make sure block 0 has set
//      up its mbarrier; no block reads another's shared memory, so the
//      other blocks leave when their stores are out.
//   2. One warp of block 0 makes the greedy pass with the alive bitmask in
//      registers (lane l holds word l). For each word it first loads the
//      word's 32 diagonal words into registers (they do not depend on the
//      pass), so its 32 steps are dependent ALU operations; lane l also
//      loads word l of the same 32 rows, and then drops from its word the
//      bits of every kept row with one OR tree: the later words' kill
//      masks do not depend on one another. A popc prefix sum over the lanes
//      gives each kept box its row, which is capped at max_det; every other
//      output row is zero with valid 0.
//
// Measured on the H100 (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6,
// chip_smoke.py phase 13 with --parent), at k = 256 with every candidate
// live (the longitudinal program's own), profiler device time: a first
// design (512 threads, a warp per (row, word) pair of the whole matrix
// found by an integer division, every pair divided, a greedy pass of
// dependent shared-memory loads) took 56.6 us; the second (one block of
// 1024 threads, a warp per live row, the greedy pass on shuffles and one
// OR-reduction per later word) 12.9 us: staging 0.7 us, matrix 9.6 us,
// greedy 3.8 us, output 0.4 us. This one takes 5.8 us in the same call:
// staging 0.6, the matrix built and landed 1.8, greedy 2.9, output 0.5;
// an empty cluster of the same shape takes 0.9 us. Slower or no faster, on
// the same inputs: the greedy steps as a predicated AND in PTX; the next
// word's diagonal words loaded during this word's steps; a warp per
// (row, word) pair of the cluster's rows found by an integer division,
// with cooperative groups' cluster.sync (a MEMBAR.ALL.GPU) handing the
// matrix over; a prefetch of the outputs at entry; and, in the second
// design, greedy
// passes that step over the kept rows' bits with a dependent load each,
// and a division screened by `__fdividef` with the exact one only near the
// threshold.

// Bit-equality with the plain version (ops/postprocess.py::
// nms_greedy_plain): the IoU is computed with __fsub_rn, __fmul_rn,
// __fadd_rn and __fdiv_rn in the plain version's order, which nvcc never
// contracts into an FMA, and max/min are PTX's max.NaN / min.NaN, NaN if
// either input is, as torch.maximum / torch.minimum; the decisions are then
// the same, and the outputs are copies of the inputs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_store.cuh"

namespace {

using namespace avp;

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_K = 1024;  // 32 words: one per lane of the greedy warp
constexpr int MAX_CLUSTER = 8;  // the portable cluster size
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

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_blocks() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}

// Shared memory: the candidates (box, area, class), then the suppression
// bits by word: words[w * tstride + i] is word w of row i (tstride =
// k rounded up to 32, plus 4: lanes reading their own word of one row fall
// in distinct banks, 16 bytes a lane).
__global__ void __launch_bounds__(THREADS) nms_greedy_kernel(
    const float4* __restrict__ boxes, const float* __restrict__ scores,
    const int* __restrict__ classes, float4* __restrict__ out_boxes,
    float* __restrict__ out_scores, int* __restrict__ out_classes,
    uint8_t* __restrict__ out_valid, int k, int max_det, float iou_t, float conf_t,
    int class_aware, uint64_t* __restrict__ stamps) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ unsigned live[32];  // the rows above the threshold
  __shared__ unsigned kept[32];
  __shared__ int first[32];  // output row of each word's first kept box
  __shared__ int n_kept;
  __shared__ __align__(8) uint64_t built;  // block 0: the matrix has landed
  const int rank = (int)cluster_rank(), cs = (int)cluster_blocks();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nw = (k + 31) / 32, tstride = 32 * nw + 4;
  float4* box = reinterpret_cast<float4*>(smem);
  float* area = reinterpret_cast<float*>(box + k);
  int* cls = reinterpret_cast<int*>(area + k);
  unsigned* words = reinterpret_cast<unsigned*>(smem + (24 * k + 15) / 16 * 16);
  const bool timed = stamps && rank == 0 && threadIdx.x == 0;
  if (timed) stamps[0] = global_ns();
  if (rank == 0 && threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&built)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // every block arrives now and waits before its first store to block 0,
  // which by then has started and set up its barrier
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");

  for (int i = threadIdx.x; i < k; i += THREADS) {
    const float4 b = boxes[i];
    box[i] = b;
    area[i] = __fmul_rn(max_nan(__fsub_rn(b.z, b.x), 0.0f), max_nan(__fsub_rn(b.w, b.y), 0.0f));
    cls[i] = classes[i];
  }
  for (int w = warp; w < nw; w += WARPS) {
    const int i = 32 * w + lane;
    const unsigned word = __ballot_sync(FULL, i < k && scores[i] >= conf_t);
    if (lane == 0) live[w] = word;
  }
  __syncthreads();
  if (timed) stamps[1] = global_ns();
  const uint32_t bar0 = in_rank(smem_addr(&built), 0);
  const uint32_t words0 = in_rank(smem_addr(words), 0);
  if (rank == 0 && warp == 0) {
    // the bytes block 0 waits for: a word for each word at or after a live
    // row's own
    const int n = lane < nw ? __popc(live[lane]) * (nw - lane) : 0;
    const uint32_t bytes = 4u * (uint32_t)__reduce_add_sync(FULL, n);
    if (lane == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(smem_addr(&built)), "r"(bytes) : "memory");
  }
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");

  // the suppression bits of this block's rows rank, rank + cs, ..., into
  // block 0: a warp per row (dealt back and forth, so that every warp gets
  // long and short rows), a lane per column, a word a ballot
  const int rows = (k - rank + cs - 1) / cs;
  for (int t = warp; t < rows; t += WARPS) {
    const int round = t / WARPS, in_round = t - round * WARPS;
    const int in_this = min(WARPS, rows - round * WARPS);
    const int q = round & 1 ? round * WARPS + (in_this - 1 - in_round) : t;
    const int i = rank + cs * q;
    if (!((live[i / 32] >> (i % 32)) & 1u)) continue;
    const float4 a = box[i];
    const float ai = area[i];
    const int ci = cls[i];
    for (int w = i / 32; w < nw; ++w) {
      const int j = min(32 * w + lane, k - 1);
      const float4 b = box[j];
      const float aj = area[j];
      const bool pair = 32 * w + lane > i && 32 * w + lane < k && (!class_aware || cls[j] == ci);
      const float iw = max_nan(__fsub_rn(min_nan(a.z, b.z), max_nan(a.x, b.x)), 0.0f);
      const float ih = max_nan(__fsub_rn(min_nan(a.w, b.w), max_nan(a.y, b.y)), 0.0f);
      const float inter = __fmul_rn(iw, ih);
      const float uni = __fsub_rn(__fadd_rn(ai, aj), inter);
      // iou = union > 0 ? inter / union : 0, and 0 / union = 0
      float iou = 0.0f;
      if (pair && uni > 0.0f && inter != 0.0f) iou = __fdiv_rn(inter, uni);
      const unsigned word = __ballot_sync(FULL, pair && iou > iou_t);
      if (lane == 0) st_async(words0 + 4u * (uint32_t)(w * tstride + i), word, bar0);
    }
  }
  if (rank != 0) return;  // nothing reads another block's shared memory

  if (warp == 0) {
    mbar_wait(smem_addr(&built));
    if (timed) stamps[2] = global_ns();
    unsigned alive = lane < nw ? live[lane] : 0u;  // lane l: candidates 32l .. 32l + 31
    const unsigned* mine = words + min(lane, nw - 1) * tstride;
    for (int w = 0; w < nw; ++w) {
      // rows 32w .. 32w + 31: their diagonal words (word w), and this lane's
      // word of each, 16 bytes a load; unbuilt words hold garbage, read only
      // under a dead bit
      unsigned diag[32], row[32];
      const uint4* d4 = reinterpret_cast<const uint4*>(words + w * tstride + 32 * w);
      const uint4* r4 = reinterpret_cast<const uint4*>(mine + 32 * w);
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const uint4 d = d4[b], r = r4[b];
        diag[4 * b] = d.x, diag[4 * b + 1] = d.y, diag[4 * b + 2] = d.z, diag[4 * b + 3] = d.w;
        row[4 * b] = r.x, row[4 * b + 1] = r.y, row[4 * b + 2] = r.z, row[4 * b + 3] = r.w;
      }
      // the word's own steps, in order: a kept row kills later rows of the word
      unsigned cur = __shfl_sync(FULL, alive, w);
#pragma unroll
      for (int b = 0; b < 32; ++b)
        if ((cur >> b) & 1u) cur &= ~diag[b];
      // the later words: drop whatever a kept row of this word suppresses
      // (an OR tree over the kept rows, not a chain)
      unsigned part[8];
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        part[g] = 0u;
#pragma unroll
        for (int b = 4 * g; b < 4 * g + 4; ++b) part[g] |= row[b] & (0u - ((cur >> b) & 1u));
      }
      const unsigned kill = ((part[0] | part[1]) | (part[2] | part[3])) |
                            ((part[4] | part[5]) | (part[6] | part[7]));
      if (lane == w) alive = cur;
      else if (lane > w) alive &= ~kill;
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
  if (timed) stamps[3] = global_ns();

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
  if (timed) stamps[4] = global_ns();
}

size_t smem_bytes(int k) {
  const int nw = (k + 31) / 32;
  return (size_t)(24 * k + 15) / 16 * 16 + (size_t)nw * (32 * nw + 4) * sizeof(unsigned);
}

}  // namespace

// Launches a cluster of cs blocks on `stream` and returns the launch's
// error, or cudaGetLastError() (0 on success).
// boxes: (k, 4) f32 [x1, y1, x2, y2], 16-byte aligned; scores: (k,) f32,
// sorted descending, those below conf_thresh already -1; classes: (k,)
// int32. out_boxes (max_det, 4) f32, 16-byte aligned; out_scores (max_det,)
// f32; out_classes (max_det,) int32; out_valid (max_det,) bytes 0/1.
// 1 <= k <= 1024, max_det >= 1, 1 <= cs <= 8. stamps: null, or 5 uint64
// that receive %globaltimer (ns) in block 0: start, staged, matrix built,
// greedy pass done, written out (chip_smoke.py reads them; the path
// passes null).
extern "C" int avp_nms_greedy(const void* boxes, const void* scores, const void* classes,
                              void* out_boxes, void* out_scores, void* out_classes,
                              void* out_valid, int k, int max_det, float iou_thresh,
                              float conf_thresh, int class_aware, int cs, void* stamps,
                              void* stream) {
  if (k < 1 || k > MAX_K || max_det < 1 || cs < 1 || cs > MAX_CLUSTER)
    return (int)cudaErrorInvalidValue;
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
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cs, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = (unsigned)cs;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, nms_greedy_kernel, (const float4*)boxes, (const float*)scores,
                           (const int*)classes, (float4*)out_boxes, (float*)out_scores,
                           (int*)out_classes, (uint8_t*)out_valid, k, max_det, iou_thresh,
                           conf_thresh, class_aware, (uint64_t*)stamps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
