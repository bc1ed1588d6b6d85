// Int8 convolution for Hopper (sm_90a), part 2: the wgmma/TMA route and
// its split-K form.
//
// Replaces, with int8_conv.cu's mma.sync route, the int8 conv of
// autoware_vision_pilot_tpu/nn/layers.py::Conv2d (:110-113), which the JAX
// package leaves to XLA: acc = conv(xq, w) in int32, then the epilogue of
// int8_common.cuh.
//
// What bounds it on the H100: operations. A 3x3 conv of the main path does
// 1,275-2,745 operations per byte it must move, far above the ~590 at
// which the int8 tensor cores (1,979 TOP/s dense) and HBM (3.35 TB/s)
// balance. Only wgmma reaches the full int8 tensor-core rate, and only if
// address arithmetic and copies stay off the threads that issue it.
//
// Design (implicit GEMM, M = output pixels, N = cout, K = (tap r, tap s,
// channel chunk)):
// - A 128x128 output tile per block: the M tile is a rectangle of TH x TW
//   output pixels of one image (TH * TW <= 128, the plan's choice), the N
//   tile 128 output channels. K runs over the KH*KW taps and, within a
//   tap, over chunks of 128 channels.
// - Loads by TMA, issued by one producer thread: for tap (r, s) and chunk
//   c0, A is the 4-D box (128 channels, TW, TH, 1) of the NHWC tensor at
//   (c0, ow0 + s - pad, oh0 + r - pad, b): row h*TW + w of the tile is
//   output pixel (oh0 + h, ow0 + w), so the box is the im2col tile. B is
//   the 4-D box (128, 1, 1, 128) of the (O, kh, kw, I) weights at
//   (c0, s, r, n0). TMA fills coordinates outside the image and beyond C
//   with zeros: the conv's zero padding (quantize(0) == 0) and the channel
//   tail, where the weight box is zero too. Both land 128-byte swizzled.
// - A ring of 6 stages (32 KB each) guarded by mbarriers: "full" (the
//   producer's expect_tx, completed by TMA's bytes) and "empty" (every
//   consumer thread arrives once it is done with the stage).
// - Two consumer warpgroups, 64 rows each, run
//   wgmma.mma_async.m64n128k32.s32.s8.s8 with A and B from shared memory
//   (both K-major, as wgmma requires of 8-bit types), four per stage, into
//   64 int32 accumulators a thread. setmaxnreg moves registers from the
//   producer warpgroup (40) to the consumers (232).
// - Persistent blocks: a unit of work is one output tile and one range of
//   K steps; block i takes units i, i + gridDim.x, ... (at most one block
//   per SM), so the producer loads the next unit's first stages while the
//   consumers store the last unit's outputs.
// - Split-K for the thin convs (the 20x40 and 10x20 3x3 convs: few output
//   tiles, K up to 13,104): each unit takes a contiguous range of the K
//   steps, stores its partial sums to its own slice of an int32
//   workspace and counts its arrival at the tile. The split that arrives
//   last adds the other slices to its accumulators and runs the epilogue,
//   so each output is finished once, in the same launch. int32 addition
//   is exact and associative: any order of arrival gives the same sums
//   bit for bit. The wrapper allocates the workspace; the entry point
//   zeroes the arrival counters; the kernel allocates nothing.
// - Epilogue straight from the accumulator registers (int8_common.cuh),
//   masked at the rectangle, the image and N. The kernel is a template on
//   the output type, so that the epilogue holds one type's code: with the
//   three inlined, a launch that followed a cuDNN conv waited ~10 us more
//   (instruction fetch, it seems: neither cold scales nor cold outputs).
// Measured on the H100 and dropped, each slower at every main-path shape:
// 128x256 tiles (two m64n128 halves per warpgroup), clusters of 2 or 4
// blocks sharing A or B tiles by TMA multicast, and two blocks per SM (64
// accumulators need more than the 80 registers a thread that allows).
// Split-K with int32 atomic adds into one zeroed (M, N) sum that the last
// split reads back was slower at the 20x40 shapes and no faster at 10x20.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "int8_common.cuh"
#include "sm90.cuh"

namespace {

using avp::MAX_DEVICES;
using namespace avp::sm90;
constexpr int BM = 128, BN = 128, BK = 128;
constexpr int A_STAGE = BM * BK, B_STAGE = BN * BK;  // bytes
constexpr int THREADS = 384;        // producer + 2 consumers
constexpr int CONSUMERS = 256;

constexpr int STAGES = 6;           // 32 KB each: one block per SM
constexpr int SMEM = STAGES * (A_STAGE + B_STAGE) + 2 * STAGES * 8 + 1024;
// setmaxnreg moves registers from the producer warpgroup to the consumers
// within the block's launch allocation of 168 a thread (65536 / 384):
// 128 * (168 - 40) = 256 * (232 - 168).
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

struct WgArgs {
  avp::Epilogue e;
  int* ws;             // (splits, M, N) int32 partial sums when split, else null
  unsigned* arrivals;  // (m_tiles * n_tiles) zeroed counters when split
  int M, OH, OW, pad, KW, nc, th, tw, tiles_h, tiles_w, iters, per_split, splits;
  int m_tiles, n_tiles, units;  // units = m_tiles * n_tiles * splits
};

// One unit of work: an output tile and a split of K. Units are numbered
// with the N tile fastest, so blocks that run at once share the input tile.
struct Unit {
  int b, oh0, ow0, n0, k_begin, k_end, z, tile;
};

__device__ __forceinline__ Unit unit(const WgArgs& a, int u) {
  const int n = u % a.n_tiles, rest = u / a.n_tiles;
  const int m = rest % a.m_tiles, z = rest / a.m_tiles;
  const int per_img = a.tiles_h * a.tiles_w, rem = m % per_img;
  Unit t;
  t.z = z;
  t.tile = m * a.n_tiles + n;
  t.b = m / per_img;
  t.oh0 = (rem / a.tiles_w) * a.th;
  t.ow0 = (rem % a.tiles_w) * a.tw;
  t.n0 = n * BN;
  t.k_begin = z * a.per_split;
  t.k_end = min(a.iters, t.k_begin + a.per_split);
  return t;
}

// A barrier of the two consumer warpgroups alone (the producer never
// waits on it).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// OUT_KIND is a.e.out_kind, fixed at compile time so that the epilogue
// holds the code of one output type.
template <int OUT_KIND>
__global__ void __launch_bounds__(THREADS, 1)
    int8_conv_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                           const __grid_constant__ CUtensorMap map_w,
                           const WgArgs a) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int last_split;  // split-K: this block's split came last
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t a_base = base;                          // [STAGES][BM][BK]
  const uint32_t b_base = base + STAGES * A_STAGE;       // [STAGES][BN][BK]
  const uint32_t bars = b_base + STAGES * B_STAGE;       // full[], empty[]
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer warpgroup: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      const uint32_t tx = (uint32_t)(a.th * a.tw * BK + B_STAGE);
      int i = 0;  // this block's K steps so far: the ring position
      for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
        const Unit t = unit(a, u);
        for (int it = t.k_begin; it < t.k_end; ++it, ++i) {
          const int s = i % STAGES;
          mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);  // round 0 passes at once
          mbar_expect_tx(full(s), tx);
          const int tap = it / a.nc, c0 = (it % a.nc) * BK;
          const int r = tap / a.KW, q = tap % a.KW;
          tma_load_4d(a_base + s * A_STAGE, &map_x, full(s), c0, t.ow0 + q - a.pad,
                      t.oh0 + r - a.pad, t.b);
          tma_load_4d(b_base + s * B_STAGE, &map_w, full(s), c0, q, r, t.n0);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: rows 64*(wg-1) .. +64 of each tile. Each
    // stage's wgmmas are committed as one group; the stage before is
    // released once its group has completed (wait_group 1), so the tensor
    // cores always have the next group queued.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int ci = wg - 1;
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    const int g = lane >> 2, t4 = lane & 3;
    int i = 0;
    for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
      const Unit t = unit(a, u);
      int acc[64];
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[j] = 0;
      int prev = -1;
      for (int it = t.k_begin; it < t.k_end; ++it, ++i) {
        const int s = i % STAGES;
        mbar_wait(full(s), (i / STAGES) & 1);
        const uint64_t da = smem_desc(a_base + s * A_STAGE + ci * 64 * BK);
        const uint64_t db = smem_desc(b_base + s * B_STAGE);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk) wgmma_m64n128k32(acc, da + 2 * kk, db + 2 * kk);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(acc);
        if (prev >= 0) mbar_arrive(empty(prev));
        prev = s;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (prev >= 0) mbar_arrive(empty(prev));

      // Accumulator layout of m64nNk32 (per warp w of the warpgroup, lane
      // = 4g + t4): acc[4p + 2h + e] is row 16w + g + 8h, column
      // 8p + 2t4 + e. Row h of this thread is output pixel m[h], or -1
      // outside the rectangle or the image.
      int m[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ml = ci * 64 + warp * 16 + g + 8 * h;  // row of the tile
        const int oh = t.oh0 + ml / a.tw, ow = t.ow0 + ml % a.tw;
        m[h] = ml < a.th * a.tw && oh < a.OH && ow < a.OW ? (t.b * a.OH + oh) * a.OW + ow
                                                          : -1;
      }
      const int N = a.e.N, n0 = t.n0 + 2 * t4;
      avp::Epilogue e = a.e;
      e.out_kind = OUT_KIND;
      if (a.ws) {
        // Split-K: this split stores its partial sums to its own slice of
        // the workspace, then counts its arrival at the tile; the split
        // that arrives last adds the other slices to its accumulators. It
        // loads all 32 pairs of a slice before it adds any, so that they
        // are in flight together, not one L2 round trip each.
        const bool whole = (N & 1) == 0 && t.n0 + BN <= N;  // 8-byte pairs, all inside N
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (m[h] < 0) continue;
          int* row = a.ws + ((long long)t.z * a.M + m[h]) * N;
#pragma unroll
          for (int p = 0; p < 16; ++p) {
            const int n = n0 + 8 * p;
            if (whole) {
              *reinterpret_cast<int2*>(row + n) =
                  make_int2(acc[4 * p + 2 * h], acc[4 * p + 2 * h + 1]);
            } else {
              if (n < N) row[n] = acc[4 * p + 2 * h];
              if (n + 1 < N) row[n + 1] = acc[4 * p + 2 * h + 1];
            }
          }
        }
        __threadfence();  // the slice is visible before the arrival is
        consumer_sync();
        if (threadIdx.x == 128)
          last_split = atomicAdd(a.arrivals + t.tile, 1u) == (unsigned)(a.splits - 1);
        consumer_sync();
        if (!last_split) continue;
        __threadfence();
        for (int z = 0; z < a.splits; ++z) {
          if (z == t.z) continue;
          int2 v[2][16];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int* row = a.ws + ((long long)z * a.M + max(m[h], 0)) * N;
#pragma unroll
            for (int p = 0; p < 16; ++p) {
              const int n = n0 + 8 * p;
              if (m[h] < 0) {
                v[h][p] = make_int2(0, 0);
              } else if (whole) {
                v[h][p] = __ldcg(reinterpret_cast<const int2*>(row + n));
              } else {
                v[h][p].x = n < N ? __ldcg(row + n) : 0;
                v[h][p].y = n + 1 < N ? __ldcg(row + n + 1) : 0;
              }
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int p = 0; p < 16; ++p) {
              acc[4 * p + 2 * h] += v[h][p].x;
              acc[4 * p + 2 * h + 1] += v[h][p].y;
            }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (m[h] < 0) continue;
#pragma unroll
        for (int p = 0; p < 16; ++p)
          avp::store_pair(e, m[h], n0 + 8 * p, acc[4 * p + 2 * h], acc[4 * p + 2 * h + 1]);
      }
    }
  }
}

}  // namespace

// The weights' tensor map, encoded once per weight by the wrapper, which
// keeps the 128 bytes written to map_out beside the weight: boxes of 128
// channels x box_n output channels (128 on the wgmma routes, the plan's N
// tile on the pointwise route). w: (N, KH, KW, C) int8, 16-byte aligned, C
// a multiple of 16. Returns 0, or 100000 + the driver's CUresult.
extern "C" int avp_int8_weight_map(const void* w, int N, int KH, int KW, int C,
                                   int box_n, void* map_out) {
  if (N <= 0 || KH <= 0 || KW <= 0 || C <= 0 || C % 16 || box_n <= 0 || box_n > 256)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)w % 16) return (int)cudaErrorMisalignedAddress;
  alignas(64) CUtensorMap map;
  const int err = encode_weights(&map, w, N, KH, KW, C, box_n);
  if (err == 0) memcpy(map_out, &map, sizeof(map));
  return err;
}

// Launches the wgmma route on `stream` and returns cudaGetLastError() (0 on
// success), or 100000 + a CUresult if the input's tensor map is refused.
// xq: (B, H, W, C) int8, 16-byte aligned, C a multiple of 16; w_map: the
// 128 bytes avp_int8_weight_map wrote; w_scale, x_scale, bias, out_kind as
// avp_int8_conv_mma. The plan's numbers: the th x tw pixel rectangle, the
// tiles (m_tiles, n_tiles), the K splits and the K steps per split, and
// the blocks to launch (each takes every blocks-th unit of work). With
// splits > 1, ws is an int32 workspace of splits * M * N partial sums
// followed by m_tiles * n_tiles arrival counters, which this call zeroes
// on `stream` before the launch; its contents need no other preparation.
extern "C" int avp_int8_conv_wgmma(const void* xq, const void* w_map,
                                   const void* w_scale, const void* x_scale,
                                   const void* bias, void* out, void* ws, int B,
                                   int H, int W, int C, int N, int KH, int KW,
                                   int pad, int out_kind, int th, int tw,
                                   int m_tiles, int n_tiles, int splits,
                                   int per_split, int blocks, void* stream) {
  WgArgs a;
  a.OH = H + 2 * pad - KH + 1;
  a.OW = W + 2 * pad - KW + 1;
  a.pad = pad;
  a.KW = KW;
  a.nc = (C + BK - 1) / BK;
  a.th = th;
  a.tw = tw;
  a.tiles_h = th > 0 ? (a.OH + th - 1) / th : 0;
  a.tiles_w = tw > 0 ? (a.OW + tw - 1) / tw : 0;
  a.iters = KH * KW * a.nc;
  a.per_split = per_split;
  a.splits = splits;
  a.m_tiles = m_tiles;
  a.n_tiles = n_tiles;
  a.units = m_tiles * n_tiles * splits;
  a.ws = splits > 1 ? (int*)ws : nullptr;
  a.arrivals = nullptr;
  a.e.w_scale = (const float*)w_scale;
  a.e.x_scale = (const float*)x_scale;
  a.e.bias = bias;
  a.e.out = out;
  a.e.N = N;
  a.e.out_kind = out_kind;
  const long long M = (long long)B * a.OH * a.OW;
  if (!out || B <= 0 || C <= 0 || C % 16 || N <= 0 || a.OH <= 0 || a.OW <= 0 ||
      M > 0x7fffffffLL || out_kind < 0 || out_kind > 2 || th <= 0 || tw <= 0 ||
      th * tw > BM || th > 256 || tw > 256 ||
      (long long)m_tiles != (long long)B * a.tiles_h * a.tiles_w ||
      n_tiles != (N + BN - 1) / BN || splits <= 0 ||
      (long long)m_tiles * n_tiles * splits > 0x7fffffffLL || blocks <= 0 ||
      (long long)blocks > (long long)m_tiles * n_tiles * splits ||
      per_split <= 0 || (long long)per_split * splits < a.iters ||
      (long long)per_split * (splits - 1) >= a.iters || (splits > 1 && !ws))
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)xq % 16) return (int)cudaErrorMisalignedAddress;
  a.M = (int)M;

  alignas(64) CUtensorMap map_x, map_w;
  const uint64_t dims[4] = {(uint64_t)C, (uint64_t)W, (uint64_t)H, (uint64_t)B};
  const uint32_t box[4] = {(uint32_t)BK, (uint32_t)tw, (uint32_t)th, 1u};
  const int err = encode(&map_x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 4, xq, dims, box);
  if (err) return err;
  memcpy(&map_w, w_map, sizeof(map_w));

  // the dynamic shared-memory limit is set once per kernel and device
  static void (*const kernels[3])(const CUtensorMap, const CUtensorMap, const WgArgs) = {
      int8_conv_wgmma_kernel<0>, int8_conv_wgmma_kernel<1>, int8_conv_wgmma_kernel<2>};
  static bool ready[3][MAX_DEVICES] = {};
  const auto kernel = kernels[out_kind];
  int dev = 0;
  cudaError_t cerr = cudaGetDevice(&dev);
  if (cerr != cudaSuccess) return (int)cerr;
  if (dev < 0 || dev >= MAX_DEVICES || !ready[out_kind][dev]) {
    cerr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (cerr != cudaSuccess) return (int)cerr;
    if (dev >= 0 && dev < MAX_DEVICES) ready[out_kind][dev] = true;
  }
  if (a.ws) {
    a.arrivals = reinterpret_cast<unsigned*>(a.ws + splits * M * N);
    cerr = cudaMemsetAsync(a.arrivals, 0, sizeof(unsigned) * m_tiles * n_tiles,
                           (cudaStream_t)stream);
    if (cerr != cudaSuccess) return (int)cerr;
  }
  kernel<<<blocks, THREADS, SMEM, (cudaStream_t)stream>>>(map_x, map_w, a);
  return (int)cudaGetLastError();
}
