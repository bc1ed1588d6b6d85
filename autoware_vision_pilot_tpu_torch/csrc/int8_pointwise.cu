// Int8 1x1 convolution for Hopper (sm_90a), the activation quantize fused
// into the load: the "pointwise" and "dot" routes of
// ops/kernels/int8_conv.py::int8_conv_plan.
//
// Replaces, for the 1x1 convs (stride 1, no padding), the int8 branch of
// autoware_vision_pilot_tpu/nn/layers.py::Conv2d (:81-113), which XLA runs
// with its static-scale quantize fused into the producer (:84-87). A 1x1
// conv of NHWC tensors is the product of the (M = pixels, K = C) activation
// and the (N, K) weights:
//   acc = sum_k quantize(x[m, k], sx) * w[n, k] in int32, then the epilogue
//   of int8_common.cuh; quantize as the quantize kernel computes it.
// Each kernel takes the float activation (bf16 or f32) and quantizes it as
// it loads it, or an int8 activation that was quantized before (a template
// on the input type); the scale is one f32 or one per input channel. The
// quantize is int8_common.cuh::quantize_rcp, the multiply by RN64(1/s)
// that gives the quantize kernel's __fdiv_rn result bit for bit without
// its branch; the wrapper passes the reciprocals.
//
// What bounds them on the H100: neither bytes nor operations. The main
// path's 1x1 convs (M = 200 or 800, K = 320-1152, N = 80-1280) move
// 0.1-0.6 MB and do 0.05-0.3 GOP, a bound of 0.1-0.3 us; the SE convs (M =
// 1) move the weights alone (9.6-55 KB). What takes the time is latency:
// few output tiles to spread over 132 SMs, a serial walk over K in each,
// the launch, the quantize's conversions, and the sums across a cluster.
//
// "pointwise" (M > 8): a block takes a BM x BN output tile (BM = 64 or
// 128 rows; BN = 64-256 columns, the plan's choice) and one K range; one
// producer warpgroup and two consumer warpgroups share a ring of stages
// by mbarriers ("full": the producer's expect_tx, completed by TMA's
// bytes; "empty": every consumer thread arrives once the stage's wgmmas
// are done).
// - Loads: the producer thread issues TMA for each K step of 128 channels:
//   the activation as 1, 2 or 4 boxes of BM rows x 128 bytes (int8, bf16,
//   f32) from a tensor map encoded per call, the weights as one box of BN
//   rows x 128 bytes from the map kept on the weight; 128-byte swizzle,
//   zeros past M, N and C. The producer warpgroup's other threads read the
//   tile's epilogue factors (int8_common.cuh::Column) into shared memory.
// - Quantize in registers: each consumer thread reads from the landed
//   stage exactly the values of its wgmma A fragment (two rows, 16
//   channels of a 32-channel slice), quantizes them (int8_common.cuh::
//   quantize4_fast_path, an f32 path that gives quantize_rcp's values
//   where it decides; the rare words it leaves go to quantize_rcp) and
//   packs them into the fragment's registers. No int8 staging tile and
//   no block barrier in the K loop; an int8 input is read into the
//   fragment as it is.
// - MMA: wgmma.mma_async m64n64k32 s32.s8.s8 with A from registers and B
//   from the stage (BN / 64 of them a slice); a slice's wgmmas run while
//   the next slice is quantized. With BM = 128 each warpgroup takes 64
//   rows; with BM = 64 both take the same rows and each half of every K
//   step (a split of K inside the block: half the quantize a thread).
// - Cluster split-K: the plan cuts K into contiguous ranges of multiples
//   of 16 channels, one per block of a thread-block cluster of up to 8
//   (values of a K step at or past the range's end quantize to zeros).
// - Epilogue through shared memory: the block stages its int32 tile in
//   the ring (row-major, 8 words of padding a row; with BM = 64 the second
//   warpgroup adds its partial sums to the first's); after a cluster
//   barrier, rank r sums rows r, r + cs, ... over every rank (distributed
//   shared memory, all of a chunk's 16-byte reads in flight at once),
//   runs the epilogue (the factors from shared memory) and writes whole
//   16-byte chunks of output rows; a second barrier keeps each rank's
//   shared memory until all have read it. int32 sums are exact in any order, so the result is
//   bit-equal to one block's. No workspace, no memset, one launch.
//
// "dot" (M <= 8 and M * C <= 32 KB, the SE convs' M = 1): a lane takes
// one 16-channel chunk of an output channel's K (lanes = a power of two of
// one warp, or up to four warps a channel: the plan's choice). It loads
// the activation's chunk first (the quantize waits for it), then the
// weights' (which wait for nothing), quantizes in registers exactly the
// values it multiplies (the same path as the pointwise route's), sums
// with __dp4a, and warp shuffles add a warp's lanes; the warps of a channel
// add their sums through shared memory behind a named barrier of theirs
// alone. No block barrier and no staging: one memory round trip.
//
// Measured on the H100 and dropped (chip_smoke.py --parent times an
// earlier tree's kernels beside these): the first pointwise design
// (mma.sync on 64x64 or 32x64 tiles through a cp.async ring, the float
// activation quantized into a separate int8 tile behind a second block
// barrier every K step, the epilogue in 4-byte stores from the fragments)
// and the first dot (the block quantized the whole activation into shared
// memory behind a barrier before loading any weight). Of this design's own steps: the cluster sums
// pulled rank by rank through distributed shared memory (slower than the
// bulk adds at every cluster size); one vote of the warp that sent every
// word of a slice to the exact quantize when any lane needed it (bf16
// inputs with a calibrated amax put values on exact half-integers: most
// slices took it); a dot warp that quantized two or three chunks a lane;
// clusters larger than lets all of them run at once (a second wave); and
// four consumer warpgroups splitting K in a 64 x 64 tile (each thread a
// quarter of the quantize: slower at every 10x20 shape, the load wait and
// the staging grew more than the quantize shrank).
//
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "int8_common.cuh"
#include "sm90.cuh"

namespace cg = cooperative_groups;
namespace sm90 = avp::sm90;

namespace {

using avp::MAX_DEVICES;

// ----------------------------------------------------------------- pointwise

constexpr int STEP = 128;          // channels of a K step (128 int8 bytes a row)
constexpr int WN = 64;             // columns of one wgmma
constexpr int CONSUMERS = 256;     // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup
// setmaxnreg moves registers from the producer warpgroup to the consumers
// within the block's launch allocation of 168 a thread (65536 / 384):
// 128 * (168 - 40) = 256 * (232 - 168).
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int MAX_STAGES = 8;
constexpr int MAX_CLUSTER = 8;     // the portable cluster size
constexpr int PAD = 8;             // words after each staged output row
constexpr int SMEM_MAX = 200 * 1024;  // the dynamic shared memory a launch may ask for

struct PwArgs {
  const double* rcp;  // RN64(1 / scale): one, or C (per_channel); null for an int8 x
  avp::Epilogue e;    // out (M, N)
  int M, C, N, per_channel, k_per_rank, cs, bm, stages;
};

#ifdef AVP_PW_STAMPS
// A stage split for chip_smoke.py (built with -DAVP_PW_STAMPS, never by
// kernels/build.py): thread 0 of each block adds up the SM clocks it
// spends in each stage and writes them, with the block's first and last
// %globaltimer and its clocks in all, as 8 words a block. Pointwise: 0
// load wait, 1 quantize, 2 MMA, 3 staging and the cluster barrier, 4
// epilogue; dot: 0 issuing the weight loads, 1 the activation's loads,
// quantize and sums, 2 the shuffles and stores.
__device__ unsigned long long* g_pw_stamps;

struct Stamps {
  unsigned long long g0;
  long long c0, t, c[5];
  __device__ __forceinline__ void start() {
    g0 = sm90::global_ns();
    c0 = t = clock64();
#pragma unroll
    for (int i = 0; i < 5; ++i) c[i] = 0;
  }
  __device__ __forceinline__ void lap(int i) {
    const long long now = clock64();
    c[i] += now - t;
    t = now;
  }
  __device__ __forceinline__ void write() {
    if (!g_pw_stamps || threadIdx.x != 0) return;
    unsigned long long* o = g_pw_stamps + 8 * (blockIdx.y * gridDim.x + blockIdx.x);
    o[0] = g0;
    o[1] = sm90::global_ns();
    o[2] = (unsigned long long)(clock64() - c0);
#pragma unroll
    for (int i = 0; i < 5; ++i) o[3 + i] = (unsigned long long)c[i];
  }
};
#else
struct Stamps {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void lap(int) {}
  __device__ __forceinline__ void write() {}
};
#endif

// The reciprocals of four channels: f64 for quantize_rcp, f32 for
// quantize4_fast_path.
struct Rcp4 {
  double d[4];
  float f[4];
};

// The scalar scale's, on every channel.
__device__ __forceinline__ Rcp4 rcp4(double r) {
  const float f = __double2float_rn(r);
  return Rcp4{{r, r, r, r}, {f, f, f, f}};
}

// Per-channel reciprocals at p (16-byte aligned).
__device__ __forceinline__ Rcp4 rcp4(const double* p) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
  return Rcp4{{a.x, a.y, b.x, b.y},
              {__double2float_rn(a.x), __double2float_rn(a.y), __double2float_rn(b.x),
               __double2float_rn(b.y)}};
}

// Four consecutive activation values at p (shared memory) as f32.
__device__ __forceinline__ void load4(const unsigned char* p, const __nv_bfloat16*,
                                      float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  v[0] = avp::bf16_lo(u.x);
  v[1] = avp::bf16_hi(u.x);
  v[2] = avp::bf16_lo(u.y);
  v[3] = avp::bf16_hi(u.y);
}

__device__ __forceinline__ void load4(const unsigned char* p, const float*, float (&v)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}

// Words of four quantized values, the first in the low byte:
// quantize4_fast_path for all of them (independent chains the scheduler
// interleaves), then one branch of this lane alone, rarely taken, that
// hands the words it left (a value at or near a half-integer: one of a
// few thousand) to quantize4_rcp. A branch per word would keep the words'
// chains apart; a vote of the warp would redo every word of the warp.
template <int W>
__device__ __forceinline__ void quantize_words(const float (&v)[W][4], const Rcp4 (&r)[W],
                                               uint32_t (&q)[W]) {
  bool exact[W];
  bool all = true;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    exact[i] = true;
    q[i] = avp::quantize4_fast_path(v[i], r[i].f, exact[i]);
    all = all & exact[i];
  }
  if (__builtin_expect(!all, 0)) {
#pragma unroll
    for (int i = 0; i < W; ++i)
      if (!exact[i]) q[i] = avp::quantize4_rcp(v[i], r[i].d);
  }
}

// Slice kk (channels 32kk .. 32kk + 31 of the K step) of this thread's
// rows `row` and row + 8 of the stage's activation tile -> its wgmma A
// fragment f. The tile is sizeof(T) boxes of bm rows x 128 bytes, each
// 128-byte swizzled: byte b of row r lies at r * 128 + ((b / 16) ^ (r %
// 8)) * 16 + b % 16. Only the step's first `live16` 16-channel groups lie
// inside the block's K range (the caller skips a slice with none); the
// others are zeros. rcp: the step's per-channel reciprocals, or null for
// r0 on every channel.
template <typename T>
__device__ __forceinline__ void fragment(const unsigned char* tile, int bm, int row, int kk,
                                         int t, int live16, const double* rcp,
                                         const Rcp4& r0, uint32_t (&f)[4]) {
  constexpr int EPB = 128 / (int)sizeof(T);  // channels of a box row
  const unsigned char* at[4];                  // f[2 * half + h]'s four values
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int c = kk * 32 + half * 16 + 4 * t;  // the first of the four channels
    const int b = (c % EPB) * (int)sizeof(T);
    const unsigned char* box = tile + (c / EPB) * bm * 128;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = row + 8 * h;
      at[2 * half + h] = box + rr * 128 + ((((b >> 4) ^ (rr & 7)) << 4) | (b & 15));
    }
  }
  // the second 16-channel group may lie past the range: zeros (nothing
  // past the range is read, not even its reciprocals)
  const bool live1 = kk * 2 + 1 < live16;
  if constexpr (sizeof(T) == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[i] = i < 2 || live1 ? *reinterpret_cast<const uint32_t*>(at[i]) : 0u;
  } else {
    Rcp4 r[4] = {r0, r0, r0, r0};
    if (rcp) {
#pragma unroll
      for (int half = 0; half < 2; ++half)
        r[2 * half] = r[2 * half + 1] =
            half == 0 || live1 ? rcp4(rcp + kk * 32 + half * 16 + 4 * t) : r0;
    }
    float v[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < 2 || live1) {
        load4(at[i], static_cast<const T*>(nullptr), v[i]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[i][j] = 0.f;
      }
    }
    quantize_words<4>(v, r, f);
  }
}

// int32 sums as f32, exactly as __int2float_rn: where every one of the
// active lanes' values lies below 2^22 in magnitude, through the low bits
// of 1.5 * 2^23 (two ALU operations, no conversion); else the conversion.
template <int W>
__device__ __forceinline__ void to_f32(const int (&v)[W], float (&f)[W]) {
  bool small = true;
#pragma unroll
  for (int k = 0; k < W; ++k) small = small & (abs(v[k]) < 0x400000);
  if (__all_sync(__activemask(), small)) {
#pragma unroll
    for (int k = 0; k < W; ++k) f[k] = __fsub_rn(__int_as_float(0x4B400000 + v[k]), 12582912.f);
  } else {
#pragma unroll
    for (int k = 0; k < W; ++k) f[k] = __int2float_rn(v[k]);
  }
}

// One 16-byte chunk of an output row: the ch (4, or 8 for bf16) columns
// from n of row m, col[k] the factors of column n + k, as one vector store
// when `vec`, else value by value inside N. The values are
// int8_common.cuh::store_out's, two bf16 rounded by one conversion.
__device__ __forceinline__ void store_chunk(const PwArgs& a, int m, int n, int ch, bool vec,
                                            const int (&v)[8], const avp::Column* col) {
  const avp::Epilogue& e = a.e;
  if (vec) {
    const long long i = (long long)m * a.N + n;
    if (e.out_kind == 2) {
      *reinterpret_cast<int4*>(static_cast<int*>(e.out) + i) = make_int4(v[0], v[1], v[2], v[3]);
    } else if (e.out_kind == 0) {
      const int w[4] = {v[0], v[1], v[2], v[3]};
      float f[4];
      to_f32(w, f);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        f[k] = __fmul_rn(f[k], col[k].dq);
        if (e.bias) f[k] = __fadd_rn(f[k], col[k].b);
      }
      *reinterpret_cast<float4*>(static_cast<float*>(e.out) + i) =
          make_float4(f[0], f[1], f[2], f[3]);
    } else {
      float f[8];
      to_f32(v, f);
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        __nv_bfloat162 p = __floats2bfloat162_rn(__fmul_rn(f[2 * k], col[2 * k].dq),
                                                 __fmul_rn(f[2 * k + 1], col[2 * k + 1].dq));
        if (e.bias) {
          const float2 y = __bfloat1622float2(p);
          p = __floats2bfloat162_rn(__fadd_rn(y.x, col[2 * k].b), __fadd_rn(y.y, col[2 * k + 1].b));
        }
        w[k] = *reinterpret_cast<const uint32_t*>(&p);
      }
      *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(e.out) + i) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (k < ch && n + k < e.N) avp::store_out(e, m, n + k, col[k], v[k]);
}

// One block: the bm x BN output tile (m tile blockIdx.x / cs, n tile
// blockIdx.y) over the K range of its rank in the cluster. Threads: two
// consumer warpgroups, then the producer warpgroup. With bm = 128 each
// warpgroup takes 64 rows; with bm = 64 both take the same rows and each
// half of every K step's slices (a split of K inside the block, which
// halves each thread's quantize), and the epilogue adds their two tiles.
template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS, 1)
    int8_pointwise_kernel(const __grid_constant__ CUtensorMap map_x,
                          const __grid_constant__ CUtensorMap map_w, const PwArgs a) {
  constexpr int BN = NJ * WN;
  constexpr int PITCH = BN + PAD;  // words of a staged output row
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * MAX_STAGES + 1];  // full[], empty[], sums
  __shared__ avp::Column cols[BN];                          // the tile's epilogue factors
  Stamps stamps;
  stamps.start();
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const tiles = smem_raw + (base - raw);
  const int bm = a.bm;
  const bool ksplit = bm == 64;
  const int a_stage = (int)sizeof(T) * bm * 128, stage_bytes = a_stage + BN * 128;
  auto full = [&](int s) { return sm90::smem_u32(&bars[s]); };
  auto empty = [&](int s) { return sm90::smem_u32(&bars[MAX_STAGES + s]); };
  const uint32_t sums = sm90::smem_u32(&bars[2 * MAX_STAGES]);  // the ranks' partial rows landed

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int m0 = (blockIdx.x / a.cs) * bm, n0 = blockIdx.y * BN;
  const int k_begin = rank * a.k_per_rank;
  const int k_end = min(a.C, k_begin + a.k_per_rank);
  const int steps = k_end > k_begin ? (k_end - k_begin + STEP - 1) / STEP : 0;
  // rank r finishes rows [r * rpr, r * rpr + rows) of the tile
  const int rpr = (bm + a.cs - 1) / a.cs;
  const int rows = min(rpr, bm - rank * rpr);
  const uint32_t row_bytes = PITCH * 4;

  if (tid == CONSUMERS) {
    sm90::prefetch_map(&map_x);
    sm90::prefetch_map(&map_w);
  }
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      sm90::mbar_init(full(s), 1);
      sm90::mbar_init(empty(s), CONSUMERS);
    }
    sm90::mbar_init(sums, 1);
    if (a.cs > 1) sm90::mbar_expect_tx(sums, (a.cs - 1) * rows * row_bytes);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- the producer warpgroup: one thread issues every TMA load (a box
    // of the activation that holds no channel of the range is not
    // loaded); the others read the tile's epilogue factors meanwhile.
    // Then it passes the barriers the consumers pass on their way out.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int lane = tid - CONSUMERS;
    if (lane == 0) {
      constexpr int BOX_CH = STEP / (int)sizeof(T);  // channels of an activation box
      for (int s = 0; s < steps; ++s) {
        const int st = s % a.stages;
        sm90::mbar_wait(empty(st), ((s / a.stages) & 1) ^ 1);  // round 0 passes at once
        const int k0 = k_begin + s * STEP;
        const int boxes = min((int)sizeof(T), (k_end - k0 + BOX_CH - 1) / BOX_CH);
        sm90::mbar_expect_tx(full(st), (uint32_t)(boxes * bm * 128 + BN * 128));
        const uint32_t dst = base + st * stage_bytes;
        for (int j = 0; j < boxes; ++j)
          sm90::tma_load_2d(dst + j * bm * 128, &map_x, full(st), k0 + j * BOX_CH, m0);
        sm90::tma_load_4d(dst + a_stage, &map_w, full(st), k0, 0, 0, n0);
      }
    }
    if (a.e.out_kind != 2)
      for (int c = lane; c < BN; c += 128)
        cols[c] = n0 + c < a.N ? avp::column(a.e, n0 + c) : avp::Column{0.f, 0.f};
    if (a.cs > 1) {
      cluster.sync();
      cluster.sync();
    } else {
      __syncthreads();
    }
    return;
  }
  {
    // ---- the consumer warpgroups. Each slice's wgmmas run while the
    // next slice is quantized; a stage is released once its wgmmas are done.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int row = (ksplit ? 0 : wg * 64) + warp * 16 + g;  // and row + 8
    const Rcp4 r0 = rcp4(sizeof(T) != 1 && !a.per_channel ? __ldg(a.rcp) : 0.0);
    int acc[NJ][32];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] = 0;
    uint32_t f[2][4];  // the A fragments of two slices
    for (int s = 0; s < steps; ++s) {
      const int st = s % a.stages;
      const int k0 = k_begin + s * STEP;
      const int live16 = min(STEP / 16, (k_end - k0) / 16);
      sm90::mbar_wait(full(st), (s / a.stages) & 1);
      stamps.lap(0);
      const unsigned char* tile = tiles + st * stage_bytes;
      const double* rcp = sizeof(T) != 1 && a.per_channel ? a.rcp + k0 : nullptr;
      const uint64_t db = sm90::smem_desc(base + st * stage_bytes + a_stage);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (2 * kk >= live16 || (ksplit && kk / 2 != wg)) continue;
        fragment<T>(tile, bm, row, kk, t, live16, rcp, r0, f[kk & 1]);
        stamps.lap(1);
#pragma unroll
        for (int j = 0; j < NJ; ++j) sm90::fence_regs(acc[j]);
        sm90::wgmma_fence();
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          sm90::wgmma_m64n64k32_rs(acc[j], f[kk & 1], db + 512 * j + 2 * kk);
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();  // the slice before is done: its fragment is free
#pragma unroll
        for (int j = 0; j < NJ; ++j) sm90::fence_regs(acc[j]);
        stamps.lap(2);
      }
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < NJ; ++j) sm90::fence_regs(acc[j]);
      sm90::mbar_arrive(empty(st));
      stamps.lap(2);
    }

    // every consumer is done with the ring: stage the tile in it,
    // warpgroup wg's 64 rows (bm = 128); with bm = 64, warpgroup 0's
    // partial tile, to which warpgroup 1 then adds its own (each thread
    // the elements it wrote, so no two threads touch one)
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
    int* out_tile = reinterpret_cast<int*>(tiles);
    auto at = [&](int j, int p, int h) {
      return reinterpret_cast<int2*>(out_tile + (row + 8 * h) * PITCH + j * WN + 8 * p + 2 * t);
    };
    if (!ksplit || wg == 0) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int p = 0; p < 8; ++p)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *at(j, p, h) = make_int2(acc[j][4 * p + 2 * h], acc[j][4 * p + 2 * h + 1]);
    }
    if (ksplit) {
      asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
      if (wg == 1) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int p = 0; p < 8; ++p)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int2 o = *at(j, p, h);
              *at(j, p, h) =
                  make_int2(o.x + acc[j][4 * p + 2 * h], o.y + acc[j][4 * p + 2 * h + 1]);
            }
      }
    }
  }
  // every rank's tile is staged (release / acquire); then each rank adds
  // its rows of every other rank's share into that rank's tile with the
  // bulk-copy engine (int32 adds, exact in any order)
  if (a.cs > 1) {
    sm90::fence_proxy_async_smem();
    cluster.sync();
    if (tid == 0) {
      for (int q = 1; q < a.cs; ++q) {
        const int dst = (rank + q) % a.cs;  // each rank starts on another
        const int q_rows = min(rpr, bm - dst * rpr);
        const uint32_t at = sm90::smem_u32(tiles) + dst * rpr * row_bytes;
        sm90::bulk_reduce_add_s32(sm90::map_rank(at, dst), at, q_rows * row_bytes,
                                  sm90::map_rank(sums, dst));
      }
    }
    sm90::mbar_wait(sums, 0);
  } else {
    __syncthreads();
  }
  stamps.lap(3);

  // this rank's rows, whole: the epilogue (the factors from shared memory),
  // 16-byte stores along the row
  const int* out_tile = reinterpret_cast<const int*>(tiles);
  const int ch = a.e.out_kind == 1 ? 8 : 4;
  const int chunks = BN / ch;
  const bool vec = a.N % ch == 0 && ((uintptr_t)a.e.out & 15) == 0;
  for (int i = tid; i < rows * chunks; i += CONSUMERS) {
    const int r = rank * rpr + i / chunks, c = (i % chunks) * ch;
    const int m = m0 + r, n = n0 + c;
    if (m >= a.M || n >= a.N) continue;
    const int4* src = reinterpret_cast<const int4*>(out_tile + r * PITCH + c);
    const int4 x = src[0], y = ch == 8 ? src[1] : make_int4(0, 0, 0, 0);
    const int v[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
    store_chunk(a, m, n, ch, vec && n + ch <= a.N, v, cols + c);
  }
  // no rank exits while a bulk add still reads its tile
  if (a.cs > 1) cluster.sync();
  stamps.lap(4);
  stamps.write();
}

template <typename T, int NJ>
cudaError_t launch_pointwise(const CUtensorMap& map_x, const CUtensorMap& map_w,
                             const PwArgs& a, int m_tiles, int n_tiles, int smem,
                             cudaStream_t stream) {
  // the dynamic shared-memory limit is set once per kernel and device
  static bool ready[MAX_DEVICES] = {false};
  const void* kernel = reinterpret_cast<const void*>(int8_pointwise_kernel<T, NJ>);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES || !ready[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return err;
    if (dev >= 0 && dev < MAX_DEVICES) ready[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)m_tiles * (unsigned)a.cs, (unsigned)n_tiles, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = (unsigned)a.cs;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  void* args[] = {const_cast<CUtensorMap*>(&map_x), const_cast<CUtensorMap*>(&map_w),
                  const_cast<PwArgs*>(&a)};
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t pointwise_bn(const CUtensorMap& mx, const CUtensorMap& mw, const PwArgs& a,
                         int bn, int m_tiles, int n_tiles, int smem, cudaStream_t s) {
  switch (bn) {
    case 64: return launch_pointwise<T, 1>(mx, mw, a, m_tiles, n_tiles, smem, s);
    case 128: return launch_pointwise<T, 2>(mx, mw, a, m_tiles, n_tiles, smem, s);
    case 192: return launch_pointwise<T, 3>(mx, mw, a, m_tiles, n_tiles, smem, s);
    default: return launch_pointwise<T, 4>(mx, mw, a, m_tiles, n_tiles, smem, s);
  }
}

// ----------------------------------------------------------------------- dot

constexpr int DOT_THREADS = 128;  // a block's threads with lanes <= 32
constexpr int DOT_GROUPS = 4;     // a block's channels with lanes >= 32
constexpr int DOT_MAX_M = 8;
constexpr int DOT_MAX_BYTES = 32 * 1024;  // M * C: the route's limit, as the plan's
constexpr int DOT_MAX_WARPS = 4;          // of one channel

struct DotArgs {
  const void* x;          // (M, C) int8, bf16 or f32
  const double* rcp;      // RN64(1 / scale): one, or C (per_channel)
  const signed char* w;   // (N, C) int8
  avp::Epilogue e;        // out (M, N)
  int M, C, N, per_channel, lanes;
};

// 16 activation values (one chunk) as loaded from global memory, and
// quantized with the reciprocals r of their channels (four at a time), or
// taken as they are.
template <typename T>
struct Chunk;

template <>
struct Chunk<signed char> {
  uint4 u;
  __device__ __forceinline__ void load(const signed char* p) {
    u = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ uint4 quantized(const Rcp4 (&)[4]) const { return u; }
};

template <>
struct Chunk<__nv_bfloat16> {
  uint4 a, b;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    a = __ldg(reinterpret_cast<const uint4*>(p));
    b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
  }
  __device__ __forceinline__ void values(float (&v)[4][4]) const {
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i][0] = avp::bf16_lo(w[2 * i]);
      v[i][1] = avp::bf16_hi(w[2 * i]);
      v[i][2] = avp::bf16_lo(w[2 * i + 1]);
      v[i][3] = avp::bf16_hi(w[2 * i + 1]);
    }
  }
  __device__ __forceinline__ uint4 quantized(const Rcp4 (&r)[4]) const {
    float v[4][4];
    values(v);
    uint32_t q[4];
    quantize_words<4>(v, r, q);
    return make_uint4(q[0], q[1], q[2], q[3]);
  }
};

template <>
struct Chunk<float> {
  float4 u[4];
  __device__ __forceinline__ void load(const float* p) {
#pragma unroll
    for (int i = 0; i < 4; ++i) u[i] = __ldg(reinterpret_cast<const float4*>(p) + i);
  }
  __device__ __forceinline__ void values(float (&v)[4][4]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i][0] = u[i].x;
      v[i][1] = u[i].y;
      v[i][2] = u[i].z;
      v[i][3] = u[i].w;
    }
  }
  __device__ __forceinline__ uint4 quantized(const Rcp4 (&r)[4]) const {
    float v[4][4];
    values(v);
    uint32_t q[4];
    quantize_words<4>(v, r, q);
    return make_uint4(q[0], q[1], q[2], q[3]);
  }
};

// `lanes` threads take one output channel: a power of two up to 32 lanes
// of a warp (DOT_THREADS / lanes channels a block), or 32 * W lanes of W
// warps (DOT_GROUPS channels a block); lane i takes the 16-channel
// chunks i, i + lanes, ... (one, at C <= 512 * W). A lane issues its weight
// load first, then loads and quantizes in registers the activation values
// it multiplies, sums them with __dp4a, and warp shuffles add a warp's
// lanes; the W warps of a channel add theirs through shared memory behind
// a barrier of those warps alone. A thread past N runs channel N - 1's
// sums and stores nothing, so that every lane takes part in the shuffles
// and barriers.
// W: the warps of a channel (lanes = 32 * W), or 0 for `lanes` of one
// warp, a power of two.
template <typename T, int MM, int W>
__global__ void __launch_bounds__(DOT_GROUPS * DOT_MAX_WARPS * 32)
    int8_dot_kernel(const DotArgs a) {
  __shared__ int partial[DOT_GROUPS * DOT_MAX_WARPS][DOT_MAX_M];  // a warp's sums, by row
  Stamps stamps;
  stamps.start();
  const int tid = threadIdx.x;
  const int L = W ? 32 * W : a.lanes;
  const int lg = W ? 0 : __ffs(L) - 1;
  const int channel = W ? tid / (32 * W) : tid >> lg;  // of the block
  const int sub = W ? tid % (32 * W) : tid & (L - 1);
  const int per_block = W ? DOT_GROUPS : DOT_THREADS >> lg;
  const int n_own = blockIdx.x * per_block + channel;
  const bool on = n_own < a.N;
  const int n = on ? n_own : a.N - 1;
  const int chunks = a.C / 16;
  const T* x = static_cast<const T*>(a.x);
  // the activation first (the quantize waits for it), then the weights
  Chunk<T> first[MM];
#pragma unroll
  for (int m = 0; m < MM; ++m)
    if (sub < chunks && (MM == 1 || m < a.M)) first[m].load(x + (long long)m * a.C + sub * 16);
  const uint4* wrow = reinterpret_cast<const uint4*>(a.w + (long long)n * a.C);
  uint4 wv = sub < chunks ? __ldg(wrow + sub) : make_uint4(0, 0, 0, 0);
  const Rcp4 r0 = rcp4(sizeof(T) != 1 && !a.per_channel ? __ldg(a.rcp) : 0.0);
  stamps.lap(0);
  const avp::Epilogue& e = a.e;
  // the epilogue's factors of column n, read while the sums run
  const avp::Column col = e.out_kind != 2 ? avp::column(e, n) : avp::Column{0.f, 0.f};
  int acc[MM];
#pragma unroll
  for (int m = 0; m < MM; ++m) acc[m] = 0;
  for (int k = sub; k < chunks; k += L) {
    if (k != sub) wv = __ldg(wrow + k);
    Rcp4 r[4] = {r0, r0, r0, r0};
    if (sizeof(T) != 1 && a.per_channel)
#pragma unroll
      for (int i = 0; i < 4; ++i) r[i] = rcp4(a.rcp + k * 16 + 4 * i);
#pragma unroll
    for (int m = 0; m < MM; ++m) {
      if (MM > 1 && m >= a.M) continue;
      Chunk<T> row = first[m];
      if (k != sub) row.load(x + (long long)m * a.C + k * 16);
      const uint4 q = row.quantized(r);
      acc[m] = __dp4a((int)q.x, (int)wv.x, acc[m]);
      acc[m] = __dp4a((int)q.y, (int)wv.y, acc[m]);
      acc[m] = __dp4a((int)q.z, (int)wv.z, acc[m]);
      acc[m] = __dp4a((int)q.w, (int)wv.w, acc[m]);
    }
  }
  stamps.lap(1);
  const int span = W ? 32 : L;  // the lanes a shuffle adds
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int m = 0; m < MM; ++m) {
    if (MM > 1 && m >= a.M) continue;
    for (int off = span / 2; off > 0; off >>= 1)
      acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], off);
    if (W > 1 && lane == 0) partial[warp][m] = acc[m];
  }
  if (W > 1) {
    // the channel's warps: a named barrier of their 32 * W threads
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + channel), "n"(32 * W) : "memory");
    if (warp % (W > 1 ? W : 1) != 0) {
      stamps.lap(2);
      stamps.write();
      return;
    }
#pragma unroll
    for (int m = 0; m < MM; ++m) {
      if (MM > 1 && m >= a.M) continue;
#pragma unroll
      for (int w = 1; w < W; ++w) acc[m] += partial[warp + w][m];
    }
  }
#pragma unroll
  for (int m = 0; m < MM; ++m) {
    if (MM > 1 && m >= a.M) continue;
    if (on && m % span == lane % span) avp::store_out(e, m, n, col, acc[m]);
  }
  stamps.lap(2);
  stamps.write();
}

template <typename T, int MM>
cudaError_t launch_dot_m(const DotArgs& a, unsigned blocks, int threads, cudaStream_t s) {
  switch (a.lanes) {
    case 32: int8_dot_kernel<T, MM, 1><<<blocks, threads, 0, s>>>(a); break;
    case 64: int8_dot_kernel<T, MM, 2><<<blocks, threads, 0, s>>>(a); break;
    case 96: int8_dot_kernel<T, MM, 3><<<blocks, threads, 0, s>>>(a); break;
    case 128: int8_dot_kernel<T, MM, 4><<<blocks, threads, 0, s>>>(a); break;
    default: int8_dot_kernel<T, MM, 0><<<blocks, threads, 0, s>>>(a);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dot(const DotArgs& a, cudaStream_t s) {
  const int L = a.lanes;
  const int per_block = L >= 32 ? DOT_GROUPS : DOT_THREADS / L;
  const int threads = per_block * L;
  const unsigned blocks = (unsigned)((a.N + per_block - 1) / per_block);
  if (a.M == 1) return launch_dot_m<T, 1>(a, blocks, threads, s);
  return launch_dot_m<T, DOT_MAX_M>(a, blocks, threads, s);
}

avp::Epilogue epilogue(const void* scale, int per_channel, const void* w_scale,
                       const void* bias, void* out, int N, int out_kind) {
  avp::Epilogue e;
  e.w_scale = (const float*)w_scale;
  e.x_scale = per_channel ? nullptr : (const float*)scale;
  e.bias = bias;
  e.out = out;
  e.N = N;
  e.out_kind = out_kind;
  return e;
}

bool bad_common(const void* x, int in_kind, const void* rcp, int per_channel, const void* w,
                int M, int C, int N, int out_kind) {
  return M <= 0 || C <= 0 || C % 16 || N <= 0 || in_kind < 0 || in_kind > 2 ||
         out_kind < 0 || out_kind > 2 || !w || (uintptr_t)x % 16 || (uintptr_t)w % 16 ||
         (in_kind != 0 && (rcp == nullptr || (per_channel && (uintptr_t)rcp % 16)));
}

// The pointwise kernel's launch for avp_int8_conv_pointwise: checks the
// plan, encodes the activation's map and picks the instance; `a` holds the
// epilogue.
int launch_pw(const void* x, int in_kind, const void* rcp, int per_channel,
              const void* w, PwArgs a, int M, int C, int N, int bm, int bn, int m_tiles,
              int n_tiles, int cs, int k_per_rank, void* stream) {
  if (bad_common(x, in_kind, rcp, per_channel, w, M, C, N, a.e.out_kind) ||
      (bm != 64 && bm != 128) || (bn != 64 && bn != 128 && bn != 192 && bn != 256) ||
      cs < 1 || cs > MAX_CLUSTER || k_per_rank <= 0 || k_per_rank % 16 ||
      (long long)k_per_rank * cs < C || (long long)k_per_rank * (cs - 1) >= C ||
      m_tiles <= 0 || n_tiles <= 0 || n_tiles > 65535 ||
      (long long)m_tiles * bm < M || (long long)(m_tiles - 1) * bm >= M ||
      (long long)n_tiles * bn < N || (long long)(n_tiles - 1) * bn >= N ||
      (long long)m_tiles * cs > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int elem = in_kind == 0 ? 1 : in_kind == 1 ? 2 : 4;
  // as many stages as the range has K steps, as far as shared memory
  // allows; the output tile is staged in the same memory afterwards
  const int stage = elem * bm * 128 + bn * 128;
  int stages = min(MAX_STAGES, (k_per_rank + STEP - 1) / STEP);
  while (stages > 1 && stages * stage + 1024 > SMEM_MAX) --stages;
  const int smem = max(stages * stage, 2 * 64 * (bn + PAD) * 4) + 1024;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;

  alignas(64) CUtensorMap map_x, map_w;
  static const CUtensorMapDataType types[3] = {CU_TENSOR_MAP_DATA_TYPE_UINT8,
                                               CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                               CU_TENSOR_MAP_DATA_TYPE_FLOAT32};
  const uint64_t dims[2] = {(uint64_t)C, (uint64_t)M};
  const uint32_t box[2] = {(uint32_t)(STEP / elem), (uint32_t)bm};
  int err = sm90::encode(&map_x, types[in_kind], elem, 2, x, dims, box);
  if (err) return err;
  err = sm90::weight_map(&map_w, w, N, 1, 1, C, bn);
  if (err) return err;

  a.rcp = (const double*)rcp;
  a.M = M; a.C = C; a.N = N;
  a.per_channel = per_channel;
  a.k_per_rank = k_per_rank;
  a.cs = cs;
  a.bm = bm;
  a.stages = stages;
  cudaStream_t s = (cudaStream_t)stream;
  if (in_kind == 0)
    return (int)pointwise_bn<signed char>(map_x, map_w, a, bn, m_tiles, n_tiles, smem, s);
  if (in_kind == 1)
    return (int)pointwise_bn<__nv_bfloat16>(map_x, map_w, a, bn, m_tiles, n_tiles, smem, s);
  return (int)pointwise_bn<float>(map_x, map_w, a, bn, m_tiles, n_tiles, smem, s);
}

}  // namespace

// The stamp buffer of a build with -DAVP_PW_STAMPS (chip_smoke.py's stage
// split), 8 words a block; without stamps, cudaErrorNotSupported.
extern "C" int avp_int8_pointwise_set_stamps(void* stamps) {
#ifdef AVP_PW_STAMPS
  return (int)cudaMemcpyToSymbol(g_pw_stamps, &stamps, sizeof(stamps));
#else
  (void)stamps;
  return (int)cudaErrorNotSupported;
#endif
}

// The pointwise route on `stream`; returns cudaGetLastError() (0 on
// success), or 100000 + a CUresult if the activation's tensor map is
// refused. x: (M, C) NHWC pixels of int8 (in_kind 0), bf16 (1) or f32 (2),
// 16-byte aligned, C a multiple of 16; scale: the f32 scale x is (or was)
// quantized with, C values if per_channel, else one, which the epilogue
// then multiplies into w_scale; rcp: for a float x, 1 / scale in f64
// (correctly rounded), as many values, 16-byte aligned; for an int8 x,
// unused; w: the (N, C) int8 weights, 16-byte aligned (their map in boxes
// of bn output channels encoded at the first launch and kept,
// sm90.cuh::weight_map); w_scale: (N,) f32; bias: (N,) of the
// output type, or null; out: (M, N) f32 (out_kind 0), bf16 (1) or the
// int32 accumulators (2). The plan's numbers: the tile's bm (64 or 128)
// rows and bn (64, 128, 192 or 256) columns, the m and n tiles, the
// cluster size cs (1-8) and the channels of K each rank takes, a multiple
// of 16 (the last rank takes the rest).
extern "C" int avp_int8_conv_pointwise(const void* x, int in_kind, const void* scale,
                                       const void* rcp, int per_channel, const void* w,
                                       const void* w_scale, const void* bias, void* out,
                                       int M, int C, int N, int out_kind, int bm, int bn,
                                       int m_tiles, int n_tiles, int cs, int k_per_rank,
                                       void* stream) {
  PwArgs a = {};
  a.e = epilogue(scale, per_channel, w_scale, bias, out, N, out_kind);
  return launch_pw(x, in_kind, rcp, per_channel, w, a, M, C, N, bm, bn, m_tiles, n_tiles,
                   cs, k_per_rank, stream);
}

// The dot route on `stream`, for M <= 8 rows and M * C <= 32 KB, `lanes`
// threads an output channel (1, 2, 4, 8, 16, 32, 64, 96 or 128); the other arguments
// as avp_int8_conv_pointwise's, with w the (N, C) int8 weights themselves,
// 16-byte aligned.
extern "C" int avp_int8_conv_dot(const void* x, int in_kind, const void* scale,
                                 const void* rcp, int per_channel, const void* w,
                                 const void* w_scale, const void* bias, void* out, int M,
                                 int C, int N, int out_kind, int lanes, void* stream) {
  if (bad_common(x, in_kind, rcp, per_channel, w, M, C, N, out_kind) || M > DOT_MAX_M ||
      (long long)M * C > DOT_MAX_BYTES || lanes < 1 ||
      (lanes <= 32 ? (lanes & (lanes - 1)) != 0 : lanes % 32 || lanes > 32 * DOT_MAX_WARPS))
    return (int)cudaErrorInvalidValue;
  DotArgs a;
  a.x = x;
  a.rcp = (const double*)rcp;
  a.w = (const signed char*)w;
  a.e = epilogue(scale, per_channel, w_scale, bias, out, N, out_kind);
  a.M = M; a.C = C; a.N = N;
  a.per_channel = per_channel;
  a.lanes = lanes;
  cudaStream_t s = (cudaStream_t)stream;
  if (in_kind == 0) return (int)launch_dot<signed char>(a, s);
  if (in_kind == 1) return (int)launch_dot<__nv_bfloat16>(a, s);
  return (int)launch_dot<float>(a, s);
}
