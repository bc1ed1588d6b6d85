// Int8 convolution for Hopper (sm_90a), part 4: the "strided" route, for
// every conv that JAX's int8 rule takes and the stride-1 routes do not: any
// stride, dilation and padding a dimension (int8_conv_plan's "strided"; a
// grouped conv runs a launch a group).
//
// Replaces, with int8_conv_sm90.cu, int8_conv_halo.cu and int8_pointwise.cu,
// the int8 conv of autoware_vision_pilot_tpu/nn/layers.py::Conv2d (:73-79,
// :110-113), which the JAX package leaves to XLA: acc = conv(xq, w) in int32
// (lax.conv_general_dilated with window_strides, rhs_dilation and a padding
// per dimension), then the epilogue of int8_common.cuh. On the paths: int8
// AutoSpeed's stride-2 3x3 convs (3 a frame at min_channels 128, 5 at 32),
// AutoSteer-temporal's QAT export (3 a forward), AutoSteer's 2x1 head convs
// at stride (2, 1).
//
// What bounds it on the H100: latency. The YOLO nets' strided convs are a
// few hundred to 6,400 output pixels (p4_0: 3x3 s2 128 -> 128, 80x80 ->
// 40x40, 0.47 GOP and 1.4 MB, a bound of 0.41 us by bytes). A launch, one
// round trip of a tile's loads, a short chain of wgmmas and the hand-off
// of partial sums are what a block waits on; the earlier form (the wgmma
// kernel's 128x128 tiles with the input's map read at the stride)
// took 13.4-14.4 us at every 3x3 shape, its split-K hand-off through a
// global workspace (3.7-6.0 us a block) and its epilogue (2.5-3.8 us) most
// of it, plus a memset launch (stage stamps, chip_smoke.py --parent).
//
// Design:
// - Load each input byte once a tile: output (oh, ow) reads tap (r, q) at
//   input line oh sh + r dh - ph, which is phase f = (r dh - ph) mod sh of
//   the input (lines f, f + sh, ...) at phase line oh + floor((r dh - ph) /
//   sh): a unit-stride conv on each phase. So a tile loads one halo a phase
//   the taps touch (a 3x3 at stride 2: 4 phase halos, not 9 tap boxes), as
//   16-channel slabs of 16-byte pixel rows (the halo route's layout,
//   int8_conv_halo.cu), and each tap's A is that halo through a
//   no-swizzle K-major descriptor started at the tap's line offset (a
//   position = a halo pixel: y hw + x, hw the halo's row). The accumulator
//   rows are the halo positions; rows with x >= tw are computed and never
//   stored. Dilation moves a tap's phase and its offset, nothing else.
// - How the halos are filled, chosen by the stage splits (chip_smoke.py
//   --parent): every thread of the block gathers them with 16-byte
//   cp.async (zeros outside the image), a warp a halo row, all of a step's
//   loads in flight at once. A first version loaded them by TMA at the
//   phase's traversal stride (the input map's elementStrides): its boxes
//   move 16-byte elements (a slab's pixel row; the next pixel lies C bytes
//   on), which TMA takes one request each, and with the weight boxes (16
//   bytes x BN rows a tap) and the maps' first fetch a block waited longer
//   for its first stage than the gather does for all of its loads. A
//   phase-major quantize would not help: its slabs
//   would still be 16-byte pixel rows unless it wrote a slab-major layout,
//   which avp::int8_conv_strided's NCHW-shaped input (its schema and fake
//   implementation) cannot carry.
// - Where a stride is above 8 the tile takes one output along it and a box
//   a tap; where a phase's halo would not fit (a very large dilation) a box
//   a tap too (int8_conv.py::strided_dim: "phase" or not, a dimension
//   each).
// - No K or N wasted: K steps of 32 channels (wgmma's int8 k32: two slabs,
//   so C = 32 and 64 take 1 and 2 steps, not a 128-channel chunk); N tiles
//   of BN = 8-64 (wgmma_ss<BN>), the narrowest that holds N.
// - Fill the card in one launch: a block takes a tile of 128 positions, an
//   N tile and a K range; the K steps are split over the blocks of a
//   thread-block cluster (up to 8, every cluster resident at once), whose
//   int32 partial sums meet in distributed shared memory (below): no
//   workspace, no arrival counters, no memset. int32 sums are exact in any
//   order: bit-equal to one block's.
// - Stages: a unit is one K step's halos of some groups (all of them unless
//   shared memory says otherwise) and their taps' weight boxes (16 channels
//   x BN output channels a tap, no swizzle: B read by the same descriptor
//   form); a rank's units run in batches of `stages`, a batch's loads in
//   flight together, then its taps as one wgmma group of the two
//   warpgroups (64 positions each). Each tap's group and line offset and
//   each group's offsets come in a table the host computes (up to
//   MAX_ARG_TAPS taps; above, the block computes it once), so no loop
//   divides by the geometry (integer division by a run-time value is a
//   long dependent chain, and a block's table of them delayed its first
//   load).
// - Epilogue: each rank finishes a share of the tile's rows. A thread
//   stores its accumulators of its own rank's rows into the int32 tile (in
//   the stages' memory) and those of another rank's rows straight into that
//   rank's slot for it (st.async into distributed shared memory, completing
//   the receiver's mbarrier; a cluster barrier split into an arrival after
//   the mbarriers' init and a wait before the first store). Each rank then
//   sums its rows' cs copies and writes them: int8_common.cuh's arithmetic
//   (f32, bf16 or the int32 accumulators, a scalar or a per-channel x_scale
//   folded into the weights; the output type fixed at compile time),
//   16-byte stores where the row allows; the N tile's factors are loaded
//   before the main loop and combined after it.
// One launch a conv after its quantize.
//
// Measured on the H100 (chip_smoke.py --parent, stage stamps of a build
// with -DAVP_STRIDED_STAMPS, ns a block): at p4_0 the first stage lands
// ~4.9 us after the block starts (the gather's 16-byte requests, ~1,160 a
// block, bound it), the wgmmas ~1.0 us, the hand-off ~1.8 us, the epilogue
// ~0.7 us; 10.0 us a conv against the strided form of the wgmma kernel's
// 16.4, in turns. Tried and dropped: TMA boxes for the halos and weights
// (above), three accumulator chains in turn (the wgmma stage no shorter:
// it does not shrink with N either), the arguments copied into shared
// memory first (no faster), and the bulk-copy engine's reduce-adds of
// staged tiles after a cluster barrier (slower than the direct stores).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "int8_common.cuh"
#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

using avp::MAX_DEVICES;
using namespace avp::sm90;

constexpr int TILE = 128;          // output positions a block (two warpgroups of 64)
constexpr int STEP = 32;           // channels of a K step: one int8 wgmma, two slabs
constexpr int SLAB = 16;           // channels of a slab: one 16-byte pixel row
constexpr int THREADS = 256;       // two warpgroups of 64 positions
constexpr int WARPS = THREADS / 32;
constexpr int MAX_STAGES = 8;
constexpr int MAX_CLUSTER = 8;
constexpr int MAX_PHASES = 8;      // a phase-mode dimension's groups (its stride, <= 8)
// the plan's limits on a dimension (int8_conv.py::StridedDim.fits): a
// phase-mode stride of at most MAX_TRAVERSAL, a halo of at most MAX_BOX
// input elements
constexpr int MAX_TRAVERSAL = 8;
constexpr int MAX_BOX = 256;
constexpr int PAD = 4;             // words after each row of the int32 tile
constexpr int MAX_BN = 64;
constexpr int MAX_ARG_TAPS = 64;   // taps (and groups) whose tables ride in the arguments
constexpr int SMEM_MAX = 200 * 1024;  // the dynamic shared memory a launch may ask for

#ifdef AVP_STRIDED_STAMPS
// chip_smoke.py's stage split (thread 0): 0 the start to the first batch of
// stages landed (the tables, the loads), 1 every later batch's loads, 2 the
// wgmmas and their group wait, 3 staging the int32 tile, the cluster
// barrier and the sums, 4 the epilogue's stores and the last barrier
__device__ unsigned long long* g_strided_stamps;
using Stamps = StageClock;
#else
__device__ unsigned long long* const g_strided_stamps = nullptr;
using Stamps = NoClock;
#endif

// One dimension's loads (ops/kernels/int8_conv.py::strided_dim): tap k reads
// input line x0 s + k d - p for output x0. A phase-mode dimension loads a
// halo a phase (group g: ext lines from x0 s + base[g] at stride s; tap k in
// group gidx[(k d - p) mod s] from line floor((k d - p) / s) - amin[g]); a
// tap-mode one a box a tap (group k, from x0 s + k d - p, line 0).
struct Dim {
  int s, d, p, phase;
  int groups, ext, span, estride, box;
  int base[MAX_PHASES], gidx[MAX_PHASES], amin[MAX_PHASES];
};

__host__ __device__ __forceinline__ int floor_mod(int a, int s) { return ((a % s) + s) % s; }
__host__ __device__ __forceinline__ int floor_div(int a, int s) {
  return (a - floor_mod(a, s)) / s;
}

__host__ __device__ __forceinline__ int tap_group(const Dim& d, int k) {
  return d.phase ? d.gidx[floor_mod(k * d.d - d.p, d.s)] : k;
}

__host__ __device__ __forceinline__ int tap_line(const Dim& d, int k) {
  const int o = k * d.d - d.p;
  return d.phase ? floor_div(o, d.s) - d.amin[d.gidx[floor_mod(o, d.s)]] : 0;
}

__host__ __device__ __forceinline__ int group_base(const Dim& d, int g) {
  return d.phase ? d.base[g] : g * d.d - d.p;
}

struct StArgs;
__host__ __device__ int4 tap_entry(const StArgs& a, int t);
__host__ __device__ int2 group_entry(const StArgs& a, int g);

struct StArgs {
  avp::Epilogue e;
  const signed char* x;  // (B, H, W, C) int8
  const signed char* w;  // (N, KH, KW, C) int8
  int H, W, C;
  Dim dh, dw;
  int KH, KW, OH, OW;
  int th, tw, hw, tiles_h, tiles_w;
  int cs, per_rank, steps, gu, units;  // units: a K step's units of gu groups
  int stages, slab_pitch, stage_bytes, w_off;
  int table_off;  // the taps' and groups' tables in shared memory, after the ring
  int recv_off;   // the slots of the other ranks' rows, after the tables
  // the tables computed by the host where they fit here (else by the block)
  int host_tables;
  int4 tap_tab[MAX_ARG_TAPS];
  int2 group_tab[MAX_ARG_TAPS];
};

// One 16-byte chunk of an output row: the ch (4, or 8 for bf16) columns from
// n of output pixel m, col[k] the factors of column n + k; one vector store
// when `vec`, else value by value inside N. The values are
// int8_common.cuh's; OUT_KIND (e.out_kind) fixed at compile time, so that
// the kernel holds one output type's code.
template <int OUT_KIND>
__device__ __forceinline__ void store_chunk(const avp::Epilogue& e, long long m, int n, bool vec,
                                            const int (&v)[8], const avp::Column* col) {
  constexpr int CH = OUT_KIND == 1 ? 8 : 4;
  const long long i = m * e.N + n;
  if constexpr (OUT_KIND == 2) {
    int* out = static_cast<int*>(e.out) + i;
    if (vec) {
      *reinterpret_cast<int4*>(out) = make_int4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int k = 0; k < CH; ++k)
        if (n + k < e.N) out[k] = v[k];
    }
  } else if constexpr (OUT_KIND == 0) {
    float f[CH];
#pragma unroll
    for (int k = 0; k < CH; ++k) f[k] = avp::f32_out(e, col[k], v[k]);
    float* out = static_cast<float*>(e.out) + i;
    if (vec) {
      *reinterpret_cast<float4*>(out) = make_float4(f[0], f[1], f[2], f[3]);
    } else {
#pragma unroll
      for (int k = 0; k < CH; ++k)
        if (n + k < e.N) out[k] = f[k];
    }
  } else {
    __nv_bfloat16 h[CH];
#pragma unroll
    for (int k = 0; k < CH; ++k) h[k] = avp::bf16_out(e, col[k], v[k]);
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(e.out) + i;
    if (vec) {
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        __nv_bfloat162 p;
        p.x = h[2 * k];
        p.y = h[2 * k + 1];
        w[k] = *reinterpret_cast<const uint32_t*>(&p);
      }
      *reinterpret_cast<uint4*>(out) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int k = 0; k < CH; ++k)
        if (n + k < e.N) out[k] = h[k];
    }
  }
}

// Tap t = r KW + q: (its group, its first position in the group's halo, r,
// q); group g = gh dw.groups + gw: its (row, column) offsets at output 0.
__host__ __device__ int4 tap_entry(const StArgs& a, int t) {
  const int r = t / a.KW, q = t - r * a.KW;
  return make_int4(tap_group(a.dh, r) * a.dw.groups + tap_group(a.dw, q),
                   tap_line(a.dh, r) * a.hw + tap_line(a.dw, q), r, q);
}

__host__ __device__ int2 group_entry(const StArgs& a, int g) {
  const int gh = g / a.dw.groups;
  return make_int2(group_base(a.dh, gh), group_base(a.dw, g - gh * a.dw.groups));
}

// Two int32 into a block of the cluster (addr and bar from map_rank), 8
// bytes of that block's mbarrier transaction.
__device__ __forceinline__ void st_async_v2(uint32_t addr, int v0, int v1, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.u32 [%0], {%1, %2}, [%3];\n" ::"r"(
          addr),
      "r"(v0), "r"(v1), "r"(bar)
      : "memory");
}

// Waits for phase 0 of a barrier that other blocks of the cluster complete
// (their stores then visible here); traps after 10 s, as sm90::mbar_wait.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar) {
  const uint64_t t0 = global_ns();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
    if (done) return;
    if (global_ns() - t0 > 10000000000ull) __trap();
  }
}

// CH columns of a row: this rank's own sums (own, in its int32 tile) plus
// the `slots` other ranks' (slot k at recv + k stride, shared-memory
// addresses).
template <int CH>
__device__ __forceinline__ void sum_row(int (&v)[8], const int* own, uint32_t recv,
                                        uint32_t stride, int slots) {
  const int4 lo = reinterpret_cast<const int4*>(own)[0];
  const int4 hi = CH == 8 ? reinterpret_cast<const int4*>(own)[1] : make_int4(0, 0, 0, 0);
  int s[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  for (int k = 0; k < slots; ++k) {
#pragma unroll
    for (int j = 0; j < CH; j += 4) {
      int4 o;
      asm volatile("ld.shared.v4.s32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(o.x), "=r"(o.y), "=r"(o.z), "=r"(o.w)
                   : "r"(recv + k * stride + j * 4));
      s[j] += o.x;
      s[j + 1] += o.y;
      s[j + 2] += o.z;
      s[j + 3] += o.w;
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = s[j];
}

// cp.async of 16 bytes from global to shared memory, zeros where `valid`
// is false (the source is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One unit into the stage at `dst`, by every thread of the block: the halos
// of groups [g0, g1) of the K step at channel c0 (a warp a halo row of hw
// pixels, two lanes a pixel: its 32 channels, 16 bytes into each slab;
// zeros outside the image and past C), then the weight boxes of their taps
// (a warp a tap, two lanes an output channel; zeros past N). taps/groups:
// the block's tables.
template <int BN>
__device__ __forceinline__ void load_unit(const StArgs& a, const int4* taps, const int2* groups,
                                          uint32_t dst, int c0, int g0, int g1, int b, int oh0,
                                          int ow0, int n0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rows = (g1 - g0) * a.dh.ext;
  int gl = 0, y = warp;  // row = gl ext + y, without a division
  for (int row = warp; row < rows; row += WARPS, y += WARPS) {
    while (y >= a.dh.ext) {
      y -= a.dh.ext;
      ++gl;
    }
    const int ih = oh0 * a.dh.s + groups[g0 + gl].x + y * a.dh.estride;
    const int iw0 = ow0 * a.dw.s + groups[g0 + gl].y;
    const bool row_ok = ih >= 0 && ih < a.H;
    const signed char* src_row = a.x + ((long long)b * a.H + ih) * a.W * a.C + c0;
    const uint32_t d = dst + gl * 2 * a.slab_pitch + y * a.hw * SLAB;
    for (int e = lane; e < 2 * a.hw; e += 32) {
      const int x = e >> 1, sl = e & 1;
      const int iw = iw0 + x * a.dw.estride;
      const bool ok = row_ok && iw >= 0 && iw < a.W && c0 + sl * SLAB < a.C;
      cp_async16(d + sl * a.slab_pitch + x * SLAB,
                 ok ? src_row + (long long)iw * a.C + sl * SLAB : a.x, ok);
    }
  }
  const int ntaps = a.KH * a.KW;
  int w = 0;  // the unit's weight boxes so far
  for (int t = 0; t < ntaps; ++t) {
    const int4 tp = taps[t];
    if (tp.x < g0 || tp.x >= g1) continue;
    if (w % WARPS == warp) {
      const uint32_t d = dst + a.w_off + w * 2 * BN * SLAB;
      for (int e = lane; e < 2 * BN; e += 32) {
        const int n = e >> 1, sl = e & 1;
        const bool ok = n0 + n < a.e.N && c0 + sl * SLAB < a.C;
        cp_async16(d + sl * BN * SLAB + n * SLAB,
                   ok ? a.w + ((long long)(n0 + n) * ntaps + t) * a.C + c0 + sl * SLAB : a.w, ok);
      }
    }
    ++w;
  }
}


// One block: the tile of TILE positions (M tile blockIdx.x / cs), the N
// tile blockIdx.y of BN columns, and the K steps of its rank in the cluster.
// Every thread loads; warpgroup ci runs the wgmmas of positions 64 ci ..;
// all of them run the sums and the epilogue.
template <int BN, int OUT_KIND>
__global__ void __launch_bounds__(THREADS)
    int8_conv_strided_kernel(const __grid_constant__ StArgs a) {
  constexpr int PITCH = BN + PAD;  // words of a row of the int32 tile
  extern __shared__ unsigned char smem_raw[];
  Stamps st;
  st.start();
  __shared__ __align__(8) uint64_t sums_bar;  // the other ranks' rows landed
  __shared__ avp::Column cols[MAX_BN];       // the N tile's epilogue factors
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  int* const tile = reinterpret_cast<int*>(smem_raw + (base - raw));
  const uint32_t sums = smem_u32(&sums_bar);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int mt = blockIdx.x / a.cs, per_img = a.tiles_h * a.tiles_w;
  const int b = mt / per_img, rem = mt - b * per_img;
  const int oh0 = (rem / a.tiles_w) * a.th, ow0 = (rem % a.tiles_w) * a.tw;
  const int n0 = blockIdx.y * BN;
  const int s_begin = rank * a.per_rank;
  const int units = (min(a.steps, s_begin + a.per_rank) - s_begin) * a.units;
  const int G = a.dh.groups * a.dw.groups;
  // rank r finishes rows [r rpr, r rpr + rows) of the tile
  const int rpr = (TILE + a.cs - 1) / a.cs;
  const int rows = min(rpr, TILE - rank * rpr);
  // the N tile's epilogue factors: their bits loaded first, combined
  // (int8_common.cuh::column's arithmetic) after the main loop, so that no
  // thread waits on them before it
  const bool has_col = OUT_KIND != 2 && tid < BN && n0 + tid < a.e.N;
  const float ws_bits = has_col ? __ldg(a.e.w_scale + n0 + tid) : 0.f;
  const float xs_bits = has_col && a.e.x_scale ? __ldg(a.e.x_scale) : 0.f;
  uint32_t b_bits = 0;  // the bias as f32 bits (a bf16's are its top half)
  if (has_col && a.e.bias) {
    const int n = n0 + tid;
    b_bits = OUT_KIND == 1
                 ? (uint32_t)__ldg(static_cast<const unsigned short*>(a.e.bias) + n) << 16
                 : __float_as_uint(__ldg(static_cast<const float*>(a.e.bias) + n));
  }

  // each tap's (group, first position, r, q) and each group's (row, column)
  // offset into shared memory: the loops below then do no division by the
  // geometry
  int4* const taps = reinterpret_cast<int4*>(smem_raw + (base - raw) + a.table_off);
  int2* const groups = reinterpret_cast<int2*>(taps + a.KH * a.KW);
  // the other ranks' rows of this rank's share: cs - 1 slots of rpr rows
  const uint32_t recv = base + a.recv_off;
  const int ntaps = a.KH * a.KW;
  if (a.host_tables) {  // copied (the host computed them)
    for (int t = tid; t < ntaps; t += THREADS) taps[t] = a.tap_tab[t];
    for (int g = tid; g < G; g += THREADS) groups[g] = a.group_tab[g];
  } else {  // a window of more than MAX_ARG_TAPS taps: computed here, once
    for (int t = tid; t < ntaps; t += THREADS) taps[t] = tap_entry(a, t);
    for (int g = tid; g < G; g += THREADS) groups[g] = group_entry(a, g);
  }
  if (tid == 0) {
    mbar_init(sums, 1);
    if (a.cs > 1) mbar_expect_tx(sums, (a.cs - 1) * rows * BN * 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // every rank's `sums` is initialised before any rank stores to it: the
  // arrival here, the wait just before the first store
  if (a.cs > 1) asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");

  const int ci = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  int acc[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] = 0;
  // the rank's units in batches of `stages`: a batch's loads all in flight
  // at once, then its taps as one wgmma group
  for (int i0 = 0; i0 < units; i0 += a.stages) {
    const int n = min(a.stages, units - i0);
    for (int j = 0; j < n; ++j) {
      const int i = i0 + j, u = i % a.units;
      const int g0 = u * a.gu, g1 = min(G, g0 + a.gu);
      load_unit<BN>(a, taps, groups, base + j * a.stage_bytes, (s_begin + i / a.units) * STEP,
                    g0, g1, b, oh0, ow0, n0);
    }
    cp_async_wait_all();
    fence_proxy_async_smem();  // the copies, before wgmma reads them
    __syncthreads();
    if (i0 == 0)
      st.lap(0);
    else
      st.lap(1);
    fence_regs(acc);
    wgmma_fence();
    for (int j = 0; j < n; ++j) {
      const int u = (i0 + j) % a.units;
      const int g0 = u * a.gu, g1 = min(G, g0 + a.gu);
      const uint32_t sb = base + j * a.stage_bytes;
      int wu = 0;  // the unit's weight boxes so far
      for (int t = 0; t < ntaps; ++t) {
        const int4 tp = taps[t];
        if (tp.x < g0 || tp.x >= g1) continue;
        const uint32_t ha = sb + (tp.x - g0) * 2 * a.slab_pitch + (ci * 64 + tp.y) * SLAB;
        const uint32_t wa = sb + a.w_off + wu * 2 * BN * SLAB;
        wgmma_ss<BN>(acc, smem_desc_plain(ha, a.slab_pitch, 8 * SLAB),
                     smem_desc_plain(wa, BN * SLAB, 8 * SLAB));
        ++wu;
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // every wgmma has read the stages
    st.lap(2);
  }
  if (tid < BN)
    cols[tid] = avp::Column{a.e.x_scale ? __fmul_rn(xs_bits, ws_bits) : ws_bits,
                            __uint_as_float(b_bits)};
  // each row's partial sums to the rank that finishes it: this rank's rows
  // into its int32 tile (in the ring), another rank's straight from the
  // registers into that rank's slot for this rank (st.async, completing its
  // `sums` barrier)
  if (a.cs > 1) asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = ci * 64 + warp * 16 + g + 8 * h;
    const int dst = row / rpr;
    if (dst == rank) {
#pragma unroll
      for (int p = 0; p < BN / 8; ++p)
        *reinterpret_cast<int2*>(tile + row * PITCH + 8 * p + 2 * t4) =
            make_int2(acc[4 * p + 2 * h], acc[4 * p + 2 * h + 1]);
    } else {
      const int slot = (rank - dst - 1 + a.cs) % a.cs;  // of the cs - 1 slots of dst
      const uint32_t at = map_rank(recv + ((slot * rpr + row - dst * rpr) * BN + 2 * t4) * 4, dst);
      const uint32_t bar = map_rank(sums, dst);
#pragma unroll
      for (int p = 0; p < BN / 8; ++p)
        st_async_v2(at + 8 * p * 4, acc[4 * p + 2 * h], acc[4 * p + 2 * h + 1], bar);
    }
  }
  __syncthreads();  // this rank's own rows staged
  if (a.cs > 1) mbar_wait_cluster(sums);  // the other ranks' rows landed
  st.lap(3);

  // this rank's rows whose positions are outputs: the epilogue, in 16-byte
  // chunks of a row
  constexpr int ch = OUT_KIND == 1 ? 8 : 4, chunks = BN / ch;
  const bool vec = a.e.N % ch == 0 && ((uintptr_t)a.e.out & 15) == 0;
  for (int i = tid; i < rows * chunks; i += THREADS) {
    const int r = rank * rpr + i / chunks, c = (i % chunks) * ch;
    const int y = r / a.hw, x = r - y * a.hw;
    const int oh = oh0 + y, ow = ow0 + x, n = n0 + c;
    if (y >= a.th || x >= a.tw || oh >= a.OH || ow >= a.OW || n >= a.e.N) continue;
    int v[8];
    sum_row<ch>(v, tile + r * PITCH + c, recv + ((r - rank * rpr) * BN + c) * 4, rpr * BN * 4,
                a.cs - 1);
    store_chunk<OUT_KIND>(a.e, (long long)(b * a.OH + oh) * a.OW + ow, n,
                          vec && n + ch <= a.e.N, v, cols + c);
  }
  st.lap(4);
  if (tid == 0)
    st.write(g_strided_stamps ? g_strided_stamps + 8ull * blockIdx.y * gridDim.x : nullptr);
}

template <int BN, int OUT_KIND>
cudaError_t launch_strided(const StArgs& a, int m_tiles, int n_tiles, int smem,
                           cudaStream_t stream) {
  // the dynamic shared-memory limit is set once per kernel and device
  static bool ready[MAX_DEVICES] = {false};
  const void* kernel = reinterpret_cast<const void*>(int8_conv_strided_kernel<BN, OUT_KIND>);
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
  void* args[] = {const_cast<StArgs*>(&a)};
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int OUT_KIND>
cudaError_t launch_bn(const StArgs& a, int bn, int m_tiles, int n_tiles, int smem,
                      cudaStream_t s) {
  switch (bn) {
    case 8: return launch_strided<8, OUT_KIND>(a, m_tiles, n_tiles, smem, s);
    case 16: return launch_strided<16, OUT_KIND>(a, m_tiles, n_tiles, smem, s);
    case 24: return launch_strided<24, OUT_KIND>(a, m_tiles, n_tiles, smem, s);
    case 32: return launch_strided<32, OUT_KIND>(a, m_tiles, n_tiles, smem, s);
    case 48: return launch_strided<48, OUT_KIND>(a, m_tiles, n_tiles, smem, s);
    default: return launch_strided<64, OUT_KIND>(a, m_tiles, n_tiles, smem, s);
  }
}

// The Dim of K taps at stride s, dilation dil and padding p for tiles of t
// outputs (int8_conv.py::strided_dim). Returns false where its halo is
// longer than MAX_BOX elements or its phases more than MAX_TRAVERSAL.
bool make_dim(Dim* d, int K, int s, int dil, int p, int t, bool phase) {
  memset(d, 0, sizeof(*d));
  d->s = s;
  d->d = dil;
  d->p = p;
  d->phase = phase;
  if (!phase) {
    d->groups = K;
    d->ext = t;
    d->span = 0;
    d->estride = t > 1 ? s : 1;
    d->box = t > 1 ? t * s : 1;
  } else {
    if (s > MAX_PHASES) return false;
    bool present[MAX_PHASES] = {false};
    int amin[MAX_PHASES];
    for (int k = 0; k < K; ++k) {
      const int o = k * dil - p, f = floor_mod(o, s), a = floor_div(o, s);
      amin[f] = present[f] ? (a < amin[f] ? a : amin[f]) : a;
      present[f] = true;
    }
    for (int f = 0; f < s; ++f) {
      if (!present[f]) continue;
      d->gidx[f] = d->groups;
      d->amin[d->groups] = amin[f];
      d->base[d->groups] = amin[f] * s + f;
      ++d->groups;
    }
    for (int k = 0; k < K; ++k) {
      const int line = tap_line(*d, k);
      if (line > d->span) d->span = line;
    }
    d->ext = t + d->span;
    d->estride = s;
    d->box = d->ext * s;
  }
  return d->box <= MAX_BOX && (d->box == 1 || d->estride <= MAX_TRAVERSAL);
}

}  // namespace

// The stamp buffer of a build with -DAVP_STRIDED_STAMPS (chip_smoke.py's
// stage split), 8 words a block; without stamps, cudaErrorNotSupported.
extern "C" int avp_int8_strided_set_stamps(void* stamps) {
#ifdef AVP_STRIDED_STAMPS
  return (int)cudaMemcpyToSymbol(g_strided_stamps, &stamps, sizeof(stamps));
#else
  (void)stamps;
  return (int)cudaErrorNotSupported;
#endif
}

// Launches the strided route on `stream` and returns cudaGetLastError() (0
// on success), or 100000 + a CUresult if a tensor map is refused. xq: (B, H,
// W, C) int8, 16-byte aligned, C a multiple of 16; w: the (N, KH, KW, C) int8
// weights, 16-byte aligned;
// w_scale: (N,) f32; x_scale: one f32, or null for a per-channel input scale
// already folded into the weights; bias: (N,) of the output type, or null;
// pad_h, pad_w, stride_h, stride_w, dil_h, dil_w: the conv's padding (each
// side), strides and dilation a dimension; out: (B, OH, OW, N), OH = (H + 2
// pad_h - dil_h (KH - 1) - 1) / stride_h + 1, f32 (out_kind 0), bf16 (1) or
// the int32 accumulators (2). The plan's numbers (int8_conv.py::
// _strided_plan): the th x tw rectangle, bn (8, 16, 24, 32, 48 or 64), the
// m and n tiles, the cluster size cs (1-8) and the 32-channel K steps a rank
// takes, the stages (1-8), whether each dimension loads a halo a phase
// (else a box a tap), and the groups of a unit.
extern "C" int avp_int8_conv_strided(const void* xq, const void* w, const void* w_scale,
                                     const void* x_scale, const void* bias, void* out, int B,
                                     int H, int W, int C, int N, int KH, int KW, int pad_h,
                                     int pad_w, int stride_h, int stride_w, int dil_h, int dil_w,
                                     int out_kind, int th, int tw, int bn, int m_tiles,
                                     int n_tiles, int cs, int per_rank, int stages, int phase_h,
                                     int phase_w, int gu, void* stream) {
  if (!out || !w || B <= 0 || C <= 0 || C % 16 || N <= 0 || KH <= 0 || KW <= 0 || pad_h < 0 ||
      pad_w < 0 || stride_h <= 0 || stride_w <= 0 || dil_h <= 0 || dil_w <= 0 || out_kind < 0 ||
      out_kind > 2 || th <= 0 || tw <= 0 ||
      (bn != 8 && bn != 16 && bn != 24 && bn != 32 && bn != 48 && bn != 64))
    return (int)cudaErrorInvalidValue;
  StArgs a;
  memset(&a, 0, sizeof(a));
  a.KH = KH;
  a.KW = KW;
  const int eh = H + 2 * pad_h - dil_h * (KH - 1), ew = W + 2 * pad_w - dil_w * (KW - 1);
  if (eh <= 0 || ew <= 0) return (int)cudaErrorInvalidValue;
  a.OH = (eh - 1) / stride_h + 1;
  a.OW = (ew - 1) / stride_w + 1;
  if (!make_dim(&a.dh, KH, stride_h, dil_h, pad_h, th, phase_h != 0) ||
      !make_dim(&a.dw, KW, stride_w, dil_w, pad_w, tw, phase_w != 0))
    return (int)cudaErrorInvalidValue;
  a.th = th;
  a.tw = tw;
  a.hw = a.dw.ext;
  a.tiles_h = (a.OH + th - 1) / th;
  a.tiles_w = (a.OW + tw - 1) / tw;
  a.cs = cs;
  a.per_rank = per_rank;
  a.steps = (C + STEP - 1) / STEP;
  const int G = a.dh.groups * a.dw.groups;
  a.gu = gu;
  a.units = gu > 0 ? (G + gu - 1) / gu : 0;
  a.stages = stages;
  const long long M = (long long)B * a.OH * a.OW;
  if (M > 0x7fffffffLL || th > a.OH || tw > a.OW || th * a.hw > TILE || a.hw > TILE ||
      (long long)m_tiles != (long long)B * a.tiles_h * a.tiles_w ||
      n_tiles != (N + bn - 1) / bn || n_tiles > 65535 || cs < 1 || cs > MAX_CLUSTER ||
      per_rank <= 0 || (long long)per_rank * cs < a.steps ||
      (long long)per_rank * (cs - 1) >= a.steps || (long long)m_tiles * cs > 0x7fffffffLL ||
      gu < 1 || gu > G || stages < 1 || stages > MAX_STAGES ||
      stages > per_rank * a.units)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)xq % 16 || (uintptr_t)w % 16) return (int)cudaErrorMisalignedAddress;
  // the layout (int8_conv.py::strided_layout): a slab holds the halo and
  // what the TILE positions' taps read past it; a stage gu groups' two
  // slabs, then two slabs of the unit's taps' weight boxes
  const int halo_rows = a.dh.ext * a.hw, read_rows = TILE + a.dh.span * a.hw + a.dw.span;
  const int rows_needed = halo_rows > read_rows ? halo_rows : read_rows;
  a.slab_pitch = (rows_needed * SLAB + 127) / 128 * 128;
  int taps = 0;
  for (int u = 0; u < a.units; ++u) {
    int n = 0;
    for (int r = 0; r < KH; ++r)
      for (int q = 0; q < KW; ++q) {
        const int g = tap_group(a.dh, r) * a.dw.groups + tap_group(a.dw, q);
        n += g >= u * gu && g < (u + 1) * gu;
      }
    if (n > taps) taps = n;
  }
  a.host_tables = KH * KW <= MAX_ARG_TAPS && G <= MAX_ARG_TAPS;
  if (a.host_tables) {
    for (int t = 0; t < KH * KW; ++t) a.tap_tab[t] = tap_entry(a, t);
    for (int g = 0; g < G; ++g) a.group_tab[g] = group_entry(a, g);
  }
  a.w_off = gu * 2 * a.slab_pitch;
  a.stage_bytes = (a.w_off + taps * 2 * bn * SLAB + 1023) / 1024 * 1024;
  const int tile_bytes = TILE * (bn + PAD) * 4;
  const long long ring = (long long)stages * a.stage_bytes;
  a.table_off = (int)(ring > tile_bytes ? ring : tile_bytes);
  a.recv_off = a.table_off + (16 * KH * KW + 8 * G + 15) / 16 * 16;
  const int rpr = (TILE + cs - 1) / cs;
  const long long smem = 1024 + a.recv_off + (long long)(cs - 1) * rpr * bn * 4;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  a.x = (const signed char*)xq;
  a.w = (const signed char*)w;
  a.H = H;
  a.W = W;
  a.C = C;
  a.e.w_scale = (const float*)w_scale;
  a.e.x_scale = (const float*)x_scale;
  a.e.bias = bias;
  a.e.out = out;
  a.e.N = N;
  a.e.out_kind = out_kind;

  cudaStream_t s = (cudaStream_t)stream;
  if (out_kind == 0) return (int)launch_bn<0>(a, bn, m_tiles, n_tiles, (int)smem, s);
  if (out_kind == 1) return (int)launch_bn<1>(a, bn, m_tiles, n_tiles, (int)smem, s);
  return (int)launch_bn<2>(a, bn, m_tiles, n_tiles, (int)smem, s);
}
