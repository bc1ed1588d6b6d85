// Int8 convolution for Hopper (sm_90a), part 2: the wgmma/TMA route, its
// split-K form, and the int8 transposed conv on the same kernel ("d2s").
// (The strided convs have a kernel of their own: int8_conv_strided.cu.)
//
// Replaces, with int8_conv_halo.cu and int8_pointwise.cu, the int8 conv of
// autoware_vision_pilot_tpu/nn/layers.py::Conv2d (:110-113), which the JAX
// package leaves to XLA: acc = conv(xq, w) in int32, then the epilogue of
// int8_common.cuh; and the int8 branch of nn/layers.py::ConvTranspose2d
// (:187-208) with kernel == stride (the U-neck and head upsamples).
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
// The transposed conv with kernel == stride ("d2s", avp_int8_conv_d2s): a
// 1x1 conv over the int8 activation (the quantize kernel runs first, once)
// with N = kh kw O columns, tiled within one (i, j) output segment: N tile
// (seg, o0), seg = i kw + j, o0 a multiple of 128, so a tile never
// straddles two segments, and the weights, a (kh kw, O, C) buffer, come as
// the 3-D box (128 channels, 128 o, 1 segment), zeros past O. Where its
// results go is the only change (a compile-time variant of the epilogue):
// - bound by bytes: at 80x160 and 40x80 the bf16 output (depth to space,
//   4x the input pixels) is most of what moves; at 10x20 the int8 weights
//   (8.5 MB at 1456 channels);
// - each tile's outputs (the same arithmetic as the conv's) are staged in
//   shared memory as the boxes of a 5-D tensor map of the output, which
//   views out (B, h kh, w kw, O) as (O, kw, w, kh, B h) with element
//   strides (1, O, kw O, w kw O, kh w kw O): the box (128 bytes of o, 1 j,
//   TW x, 1 i, TH rows) at (o0, j, x0, i, b h + y0) holds out[b, y kh + i,
//   x kw + j, o] with no division by a thread. The staging is 128-byte
//   swizzled as TMA reads it (the accumulators' pairs land without bank
//   conflicts), and one cp.async.bulk.tensor store a box writes it; TMA
//   clips the o tail and the right edge (the plan's rectangles never cross
//   an image's last row, so B h rows cannot spill into the next image);
// - a unit's stores are one bulk group, and the staging is written again
//   only after cp.async.bulk.wait_group.read, so a tile's stores drain
//   while the next unit's main loop runs;
// - the epilogue's factors (w_scale[o] and x_scale, bias[o]) of every o are
//   read once a block into shared memory (up to 2048 of them, else from
//   global memory a tile);
// - 5 stages of the ring (4 for 4-byte outputs) leave room for the staging
//   tile and the factors; the split-K form runs unchanged on a (splits, M,
//   n_tiles 128) workspace;
// - where the map cannot hold the output (O * bytes not a multiple of 16,
//   or O below one box: O = 3, 12, 20 in bf16), the same kernel stores
//   value by value from the registers, each at its computed offset.
// Measured on the H100 (stage stamps, 256 -> 256 at 80x160): the stores
// cost ~3 % (no store at all: 40.4 us against 41.5), whatever their layout
// (a flat 2-D box: 41.3); with the factors read from global memory a tile,
// their loads took 45 % of a block's time, hence the table (40.2 us then,
// against 48.0). What is left is the two warpgroups' lockstep: the
// epilogue's ALU and barriers wait on the slower one, and no unit's
// epilogue overlaps the next unit's wgmmas. Measured and dropped: two
// staging tiles in turns, 256-byte rows without swizzle (one box a tile),
// each warpgroup staging and storing its own rows (power-of-two rectangles;
// 43.1 us, and 29.0 against 17.5 at 1456 10x20), the consumers copying the
// staging out in 16-byte stores (1.5x slower), and value-by-value stores
// from the registers (2.3x slower).
//
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
constexpr int SMEM_MAX = 232448 - 256;  // a block's shared memory, less the static
// the d2s staging: the 128x128 output tile in boxes of 128-byte rows, then
// the epilogue's factors of every o (up to D2S_TABLE of them)
constexpr int BOX_BYTES = BM * 128;
constexpr int D2S_TABLE = 2048;
template <bool D2S, int OUT_KIND>
__host__ __device__ constexpr int staging_bytes() {
  return D2S ? BM * BN * (OUT_KIND == 1 ? 2 : 4) + D2S_TABLE * 8 : 0;
}
// d2s: as many stages as fit beside the staging (5 for bf16, 4 for 4-byte
// outputs)
template <bool D2S, int OUT_KIND>
__host__ __device__ constexpr int stages() {
  constexpr int fit =
      (SMEM_MAX - 1024 - 2 * STAGES * 8 - staging_bytes<D2S, OUT_KIND>()) / (A_STAGE + B_STAGE);
  return D2S && fit < STAGES ? fit : STAGES;
}
template <bool D2S, int OUT_KIND>
__host__ __device__ constexpr int smem_bytes() {
  return stages<D2S, OUT_KIND>() * (A_STAGE + B_STAGE) + staging_bytes<D2S, OUT_KIND>() +
         2 * stages<D2S, OUT_KIND>() * 8 + 1024;
}
static_assert(smem_bytes<true, 0>() <= SMEM_MAX && smem_bytes<true, 1>() <= SMEM_MAX &&
                  smem_bytes<false, 0>() <= SMEM_MAX,
              "shared memory");
// setmaxnreg moves registers from the producer warpgroup to the consumers
// within the block's launch allocation of 168 a thread (65536 / 384):
// 128 * (168 - 40) = 256 * (232 - 168).
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

#ifdef AVP_D2S_STAMPS
// chip_smoke.py's stage split of the d2s variant (thread 128, the first
// consumer): 0 waiting for loads, 1 the wgmmas and their group waits, 2 the
// epilogue (staging and the bulk stores' issue), 3 split-K's sums, 4 the
// epilogue's wait for the last tile's stores to read the staging
__device__ unsigned long long* g_d2s_stamps;
using D2sStamps = StageClock;
#else
__device__ unsigned long long* const g_d2s_stamps = nullptr;
using D2sStamps = NoClock;
#endif

struct WgArgs {
  avp::Epilogue e;
  int* ws;             // (splits, M, N) int32 partial sums when split, else null
  unsigned* arrivals;  // (m_tiles * n_tiles) zeroed counters when split
  int M, OH, OW, KW, nc, th, tw, tiles_h, tiles_w, iters, per_split, splits;
  int pad_h, pad_w;  // the padding a dimension
  int m_tiles, n_tiles, units;  // units = m_tiles * n_tiles * splits
  // d2s: the transposed conv's O, kh, kw, its N tiles a segment (ceil(O /
  // 128)), and whether the output map stores the tiles (else value by value)
  int O, kh, kw, o_tiles, tma_store;
};

// One unit of work: an output tile and a split of K. Units are numbered
// with the N tile fastest, so blocks that run at once share the input tile.
struct Unit {
  int b, oh0, ow0, n0, k_begin, k_end, z, tile;
  int seg, o0;  // d2s: the N tile's output segment i kw + j and first o
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
  t.seg = a.o_tiles > 0 ? n / a.o_tiles : 0;
  t.o0 = a.o_tiles > 0 ? (n - t.seg * a.o_tiles) * BN : 0;
  t.k_begin = z * a.per_split;
  t.k_end = min(a.iters, t.k_begin + a.per_split);
  return t;
}

// A barrier of the two consumer warpgroups alone (the producer never
// waits on it).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// The transposed conv's epilogue of one tile (consumer threads; ml = the
// tile row of pixel (y0 + ml / tw, x0 + ml % tw) of image b, column c = o -
// o0, acc[4p + 2h + e] at row ci 64 + 16 warp + g + 8h, column 8p + 2t4 +
// e). With the output map: the outputs into the staging boxes (box q holds
// columns [q, q + 1) * 128 bytes, row ml at 128 ml, its 16-byte chunk k at
// k ^ (ml % 8): TMA's 128-byte swizzle), then one thread stores the boxes
// and commits them as a bulk group. Without: value by value from the
// registers at out[b, y kh + i, x kw + j, o].
template <int OUT_KIND>
__device__ __forceinline__ void d2s_epilogue(const WgArgs& a, const avp::Epilogue& e,
                                             const Unit& t, const int (&acc)[64], int ci,
                                             int warp, int g, int t4, const int (&m)[2],
                                             unsigned char* staging, uint32_t stage_base,
                                             const avp::Column* table,
                                             const CUtensorMap* map_out, D2sStamps& st) {
  constexpr int ELEM = OUT_KIND == 1 ? 2 : 4;
  constexpr int QCOLS = 128 / ELEM;  // columns of a box
  const int i = t.seg / a.kw, j = t.seg - i * a.kw;
  if (!a.tma_store) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (m[h] < 0) continue;
      // m = (b h + y) w + x: out[b, y kh + i, x kw + j, :] starts at
      // (((b h + y) kh + i) w + x) kw + j) O
      const int by = m[h] / a.OW, x = m[h] - by * a.OW;
      const long long row = ((((long long)by * a.kh + i) * a.OW + x) * a.kw + j) * a.O;
#pragma unroll
      for (int p = 0; p < 16; ++p)
#pragma unroll
        for (int x2 = 0; x2 < 2; ++x2) {
          const int o = t.o0 + 8 * p + 2 * t4 + x2;
          if (o < a.O) avp::store_at(e, row + o, avp::column(e, o), acc[4 * p + 2 * h + x2]);
        }
    }
    return;
  }
  // this thread's 32 columns' factors: from the block's table in shared
  // memory (read from global memory they took 45 % of a block's time at
  // 80x160), all before the first staging store
  avp::Column cf[16][2];
#pragma unroll
  for (int p = 0; p < 16; ++p)
#pragma unroll
    for (int x2 = 0; x2 < 2; ++x2) {
      const int o = t.o0 + 8 * p + 2 * t4 + x2;
      cf[p][x2] = OUT_KIND == 2 || o >= a.O ? avp::Column{0.f, 0.f}
                  : a.O <= D2S_TABLE       ? table[o]
                                           : avp::column(e, o);
    }
  if (threadIdx.x == 128) bulk_wait_read<0>();  // the last tile's stores have read the staging
  consumer_sync();
  st.lap(4);
  const int rows = a.th * a.tw;
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    const int c = 8 * p + 2 * t4;  // this thread's columns c, c + 1
    const int q = c / QCOLS, byte = (c % QCOLS) * ELEM;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ml = ci * 64 + warp * 16 + g + 8 * h;
      if (ml >= rows) continue;
      unsigned char* at = staging + q * BOX_BYTES + ml * 128 +
                          ((((byte >> 4) ^ (ml & 7)) << 4) | (byte & 15));
      const int v0 = acc[4 * p + 2 * h], v1 = acc[4 * p + 2 * h + 1];
      if (OUT_KIND == 2) {
        *reinterpret_cast<int2*>(at) = make_int2(v0, v1);
      } else if (OUT_KIND == 0) {
        *reinterpret_cast<float2*>(at) = make_float2(avp::f32_out(e, cf[p][0], v0),
                                                     avp::f32_out(e, cf[p][1], v1));
      } else {
        __nv_bfloat162 v;
        v.x = avp::bf16_out(e, cf[p][0], v0);
        v.y = avp::bf16_out(e, cf[p][1], v1);
        *reinterpret_cast<__nv_bfloat162*>(at) = v;
      }
    }
  }
  fence_proxy_async_smem();  // this thread's writes, before the bulk copy reads them
  consumer_sync();
  if (threadIdx.x == 128) {
    for (int q = 0; q < BN * ELEM / 128; ++q)
      if (t.o0 + q * QCOLS < a.O)
        tma_store_5d(map_out, stage_base + q * BOX_BYTES, t.o0 + q * QCOLS, j, t.ow0, i,
                     t.b * a.OH + t.oh0);
    bulk_commit();
  }
}

// OUT_KIND is a.e.out_kind, fixed at compile time so that the epilogue
// holds the code of one output type; D2S selects the transposed conv's
// weights and epilogue (map_out: its output's 5-D map).
template <int OUT_KIND, bool D2S>
__global__ void __launch_bounds__(THREADS, 1)
    int8_conv_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                           const __grid_constant__ CUtensorMap map_w,
                           const __grid_constant__ CUtensorMap map_out,
                           const WgArgs a) {
  constexpr int STAGES = stages<D2S, OUT_KIND>();
  extern __shared__ unsigned char smem_raw[];
  __shared__ int last_split;  // split-K: this block's split came last
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t a_base = base;                          // [STAGES][BM][BK]
  const uint32_t b_base = base + STAGES * A_STAGE;       // [STAGES][BN][BK]
  const uint32_t stage_base = b_base + STAGES * B_STAGE;  // d2s: the staging boxes
  unsigned char* const staging = smem_raw + (stage_base - raw);
  const uint32_t bars = stage_base + staging_bytes<D2S, OUT_KIND>();  // full[], empty[]
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
          tma_load_4d(a_base + s * A_STAGE, &map_x, full(s), c0, t.ow0 + q - a.pad_w,
                      t.oh0 + r - a.pad_h, t.b);
          if (D2S)
            tma_load_4d(b_base + s * B_STAGE, &map_w, full(s), c0, t.o0, t.seg, 0);
          else
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
    D2sStamps st;
    if (D2S) st.start();
    // d2s: the factors of every o, once, into the table after the staging tile
    avp::Column* const table =
        reinterpret_cast<avp::Column*>(staging + BM * BN * (OUT_KIND == 1 ? 2 : 4));
    if constexpr (D2S) {
      if (OUT_KIND != 2 && a.O <= D2S_TABLE)
        for (int o = threadIdx.x - 128; o < a.O; o += CONSUMERS) table[o] = avp::column(a.e, o);
      consumer_sync();
    }
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
        if (D2S) st.lap(0);
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
        if (D2S) st.lap(1);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (prev >= 0) mbar_arrive(empty(prev));
      if (D2S) st.lap(1);

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
      // d2s: the workspace's rows are the n_tiles * 128 GEMM columns
      const int N = D2S ? a.n_tiles * BN : a.e.N, n0 = t.n0 + 2 * t4;
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
      if constexpr (D2S) {
        st.lap(3);
        d2s_epilogue<OUT_KIND>(a, e, t, acc, ci, warp, g, t4, m, staging, stage_base, table,
                               &map_out, st);
        st.lap(2);
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (m[h] < 0) continue;
#pragma unroll
          for (int p = 0; p < 16; ++p)
            avp::store_pair(e, m[h], n0 + 8 * p, acc[4 * p + 2 * h], acc[4 * p + 2 * h + 1]);
        }
      }
    }
    // d2s: no block leaves while a bulk store still reads its staging
    if (D2S && threadIdx.x == 128) {
      bulk_wait<0>();
      st.write(g_d2s_stamps);
    }
  }
}

// The launch of either variant: the dynamic shared-memory limit, set once
// per kernel and device, the split-K arrival counters zeroed on `stream`,
// then the kernel. Returns cudaGetLastError().
template <int OUT_KIND, bool D2S>
int launch_wg(const CUtensorMap& map_x, const CUtensorMap& map_w, const CUtensorMap& map_out,
              WgArgs a, int blocks, void* stream) {
  static bool ready[MAX_DEVICES] = {};
  constexpr int SMEM = smem_bytes<D2S, OUT_KIND>();
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES || !ready[dev]) {
    err = cudaFuncSetAttribute(int8_conv_wgmma_kernel<OUT_KIND, D2S>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 0 && dev < MAX_DEVICES) ready[dev] = true;
  }
  if (a.ws) {
    a.arrivals = reinterpret_cast<unsigned*>(a.ws + (long long)a.splits * a.M *
                                                        (D2S ? a.n_tiles * BN : a.e.N));
    err = cudaMemsetAsync(a.arrivals, 0, sizeof(unsigned) * a.m_tiles * a.n_tiles,
                          (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  int8_conv_wgmma_kernel<OUT_KIND, D2S>
      <<<blocks, THREADS, SMEM, (cudaStream_t)stream>>>(map_x, map_w, map_out, a);
  return (int)cudaGetLastError();
}

// The arguments both entry points share, checked: the 4-D map of the int8
// NHWC input in boxes of the th x tw rectangle, and WgArgs up to the
// epilogue's pointers. Returns 0, cudaErrorInvalidValue, or 100000 + a
// CUresult.
int prepare(WgArgs& a, CUtensorMap* map_x, const void* xq, int B, int H, int W, int C, int N,
            int KH, int KW, int pad_h, int pad_w, int out_kind, int th, int tw, int m_tiles,
            int n_tiles, int splits, int per_split, int blocks, void* ws) {
  if (KH <= 0 || KW <= 0 || pad_h < 0 || pad_w < 0 || th <= 0 || tw <= 0)
    return (int)cudaErrorInvalidValue;
  a.OH = H + 2 * pad_h - KH + 1;
  a.OW = W + 2 * pad_w - KW + 1;
  if (a.OH <= 0 || a.OW <= 0) a.OH = a.OW = 0;
  a.pad_h = pad_h;
  a.pad_w = pad_w;
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
  a.O = a.kh = a.kw = a.o_tiles = a.tma_store = 0;
  const long long M = (long long)B * a.OH * a.OW;
  if (B <= 0 || C <= 0 || C % 16 || N <= 0 || a.OH <= 0 || a.OW <= 0 ||
      M > 0x7fffffffLL || out_kind < 0 || out_kind > 2 || th <= 0 || tw <= 0 ||
      th * tw > BM || th > 256 || tw > 256 ||
      (long long)m_tiles != (long long)B * a.tiles_h * a.tiles_w || n_tiles <= 0 ||
      splits <= 0 || (long long)m_tiles * n_tiles * splits > 0x7fffffffLL || blocks <= 0 ||
      (long long)blocks > (long long)m_tiles * n_tiles * splits ||
      per_split <= 0 || (long long)per_split * splits < a.iters ||
      (long long)per_split * (splits - 1) >= a.iters || (splits > 1 && !ws))
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)xq % 16) return (int)cudaErrorMisalignedAddress;
  a.M = (int)M;
  const uint64_t dims[4] = {(uint64_t)C, (uint64_t)W, (uint64_t)H, (uint64_t)B};
  const uint32_t box[4] = {(uint32_t)BK, (uint32_t)tw, (uint32_t)th, 1u};
  return encode(map_x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 4, xq, dims, box);
}

avp::Epilogue epilogue(const void* w_scale, const void* x_scale, const void* bias, void* out,
                       int N, int out_kind) {
  avp::Epilogue e;
  e.w_scale = (const float*)w_scale;
  e.x_scale = (const float*)x_scale;
  e.bias = bias;
  e.out = out;
  e.N = N;
  e.out_kind = out_kind;
  return e;
}

}  // namespace

// The weight maps encoded in this process so far (sm90.cuh::weight_maps):
// one a (weight address, shape, box) key; tests/test_torch_cuda.py reads it.
extern "C" long long avp_int8_weight_map_encodes() { return weight_maps().encodes(); }

// The stamp buffer of a build with -DAVP_D2S_STAMPS (chip_smoke.py's stage
// split of the d2s variant), 8 words a block; without stamps,
// cudaErrorNotSupported.
extern "C" int avp_int8_d2s_set_stamps(void* stamps) {
#ifdef AVP_D2S_STAMPS
  return (int)cudaMemcpyToSymbol(g_d2s_stamps, &stamps, sizeof(stamps));
#else
  (void)stamps;
  return (int)cudaErrorNotSupported;
#endif
}

// Launches the wgmma route (and its split-K form) on `stream`
// and returns cudaGetLastError() (0 on success), or 100000 + a CUresult if
// a tensor map is refused. xq: (B, H, W, C) int8, 16-byte aligned, C a
// multiple of 16; w: the (N, KH, KW, C) int8 weights, 16-byte aligned (their
// map is encoded at the first launch and kept, sm90.cuh::weight_map);
// w_scale: (N,) f32; x_scale: one f32, or null for a per-channel input
// scale already folded into the weights; bias: (N,) of the output type, or
// null; pad_h, pad_w: the conv's padding (each side) a dimension, at stride
// 1; out: (B, OH, OW, N), OH = H + 2 pad_h - KH + 1, f32 (out_kind 0), bf16
// (1) or the int32 accumulators (2). The plan's numbers: the th x tw pixel
// rectangle, the tiles (m_tiles, n_tiles), the K splits and the K steps per
// split, and the blocks to
// launch (each takes every blocks-th unit of work). With splits > 1, ws is
// an int32 workspace of splits * M * N partial sums followed by m_tiles *
// n_tiles arrival counters, which this call zeroes on `stream` before the
// launch; its contents need no other preparation.
extern "C" int avp_int8_conv_wgmma(const void* xq, const void* w, const void* w_scale,
                                   const void* x_scale, const void* bias, void* out, void* ws,
                                   int B, int H, int W, int C, int N, int KH, int KW, int pad_h,
                                   int pad_w, int out_kind, int th, int tw, int m_tiles,
                                   int n_tiles, int splits, int per_split, int blocks,
                                   void* stream) {
  WgArgs a;
  alignas(64) CUtensorMap map_x, map_w;
  int err = prepare(a, &map_x, xq, B, H, W, C, N, KH, KW, pad_h, pad_w, out_kind, th, tw,
                    m_tiles, n_tiles, splits, per_split, blocks, ws);
  if (err) return err;
  if (!out || !w || n_tiles != (N + BN - 1) / BN) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)w % 16) return (int)cudaErrorMisalignedAddress;
  a.e = epilogue(w_scale, x_scale, bias, out, N, out_kind);
  err = weight_map(&map_w, w, N, KH, KW, C, BN);
  if (err) return err;
  if (out_kind == 0) return launch_wg<0, false>(map_x, map_w, map_w, a, blocks, stream);
  if (out_kind == 1) return launch_wg<1, false>(map_x, map_w, map_w, a, blocks, stream);
  return launch_wg<2, false>(map_x, map_w, map_w, a, blocks, stream);
}

// The transposed conv with kernel == stride ("d2s") on `stream`, the return
// value as avp_int8_conv_wgmma's. xq: (B, h, w, C) int8 (the quantized
// activation), 16-byte aligned, C a multiple of 16; wt: the (kh kw, O, C)
// int8 weights, 16-byte aligned, as the 4-D tensor (C, O, kh kw, 1) in
// boxes of 128 channels x 128 o of one segment (zeros past O; the map kept
// as avp_int8_conv_wgmma's); w_scale and
// bias: (O,); x_scale: the scalar the activation was quantized with; out:
// (B, h kh, w kw, O) of out_kind, 16-byte aligned. The plan's numbers as
// avp_int8_conv_wgmma's for the 1x1 conv of N = kh kw ceil(O / 128) 128
// columns (n_tiles of them), the rectangle's th dividing h; ws: splits * B h
// w * n_tiles * 128 partial sums and the counters. tma_store: store the
// tiles through the output's 5-D map (needs O * bytes a multiple of 16 and O
// at least 128 bytes of outputs), else value by value.
extern "C" int avp_int8_conv_d2s(const void* xq, const void* wt, const void* w_scale,
                                 const void* x_scale, const void* bias, void* out, void* ws,
                                 int B, int h, int w, int C, int O, int kh, int kw,
                                 int out_kind, int th, int tw, int m_tiles, int n_tiles,
                                 int splits, int per_split, int blocks, int tma_store,
                                 void* stream) {
  if (O <= 0 || kh <= 0 || kw <= 0 || (long long)kh * kw * O > 0x7fffffffLL || !out ||
      !x_scale || !wt)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)wt % 16) return (int)cudaErrorMisalignedAddress;
  WgArgs a;
  alignas(64) CUtensorMap map_x, map_w, map_out;
  int err = prepare(a, &map_x, xq, B, h, w, C, kh * kw * O, 1, 1, 0, 0, out_kind, th, tw,
                    m_tiles, n_tiles, splits, per_split, blocks, ws);
  if (err) return err;
  a.O = O;
  a.kh = kh;
  a.kw = kw;
  a.o_tiles = (O + BN - 1) / BN;
  a.tma_store = tma_store;
  const int elem = out_kind == 1 ? 2 : 4;
  if (n_tiles != kh * kw * a.o_tiles || h % th ||
      (tma_store && ((O * elem) % 16 || O * elem < 128 || (uintptr_t)out % 16)))
    return (int)cudaErrorInvalidValue;
  a.e = epilogue(w_scale, x_scale, bias, out, O, out_kind);
  const int S = kh * kw;
  err = weight_maps().get(&map_w, {1, (long long)(uintptr_t)wt, O, S, C, 1, BN},
                          [&](CUtensorMap* m) {
                            const uint64_t dims[4] = {(uint64_t)C, (uint64_t)O, (uint64_t)S, 1u};
                            const uint32_t box[4] = {(uint32_t)BK, (uint32_t)BN, 1u, 1u};
                            return encode(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 4, wt, dims, box);
                          });
  if (err) return err;
  memset(&map_out, 0, sizeof(map_out));
  if (tma_store) {
    static const CUtensorMapDataType types[3] = {CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                                                 CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                                 CU_TENSOR_MAP_DATA_TYPE_INT32};
    const uint64_t row = (uint64_t)O * elem;  // bytes of one output pixel
    const uint64_t dims[5] = {(uint64_t)O, (uint64_t)kw, (uint64_t)w, (uint64_t)kh,
                              (uint64_t)B * h};
    const uint64_t strides[4] = {row, row * kw, row * kw * w, row * kw * w * kh};
    const uint32_t box[5] = {(uint32_t)(128 / elem), 1u, (uint32_t)tw, 1u, (uint32_t)th};
    err = encode_map(&map_out, types[out_kind], 5, out, dims, strides, box,
                     CU_TENSOR_MAP_SWIZZLE_128B);
    if (err) return err;
  }
  if (out_kind == 0) return launch_wg<0, true>(map_x, map_w, map_out, a, blocks, stream);
  if (out_kind == 1) return launch_wg<1, true>(map_x, map_w, map_out, a, blocks, stream);
  return launch_wg<2, true>(map_x, map_w, map_out, a, blocks, stream);
}
