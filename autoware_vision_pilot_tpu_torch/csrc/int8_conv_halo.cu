// Int8 convolution for Hopper (sm_90a), part 3: the "halo" route, for the
// convs that the wgmma and 1x1 routes do not take (windows larger than 1x1
// with C < 128, and a 1x1 window with padding; int8_conv_plan's "halo").
//
// Replaces, with int8_conv_sm90.cu and int8_pointwise.cu, the int8 conv of
// autoware_vision_pilot_tpu/nn/layers.py::Conv2d (:110-113), which the JAX
// package leaves to XLA: acc = conv(xq, w) in int32, then the epilogue of
// int8_common.cuh. On the paths it is the QAT export's head (SceneSeg's 64 ->
// 3 3x3 conv at 320x640) and any int8 selection below 128 channels.
//
// What bounds it on the H100: bytes. At 64 -> 3 3x3 320x640 it reads 13.1 MB
// of int8 input and writes 1.2 MB of bf16 output for 1.9 GOP (a byte bound
// of 4.28 us). An implicit GEMM that gathers each tap's pixels (im2col) reads
// every input pixel once a tap, 9 times for a 3x3, and a 128-wide N tile is
// 61/64 padding at N = 3.
//
// Design:
// - Persistent blocks (two per SM, or one per unit of work): a unit is a
//   TH x TW rectangle of output pixels of one image and an N tile of BN =
//   8-64 output channels (a template: wgmma's small N shapes).
// - The input is read once per tile: the producer thread loads the tile's
//   halo, TH + KH - 1 rows of HW pixels at the tile's origin minus `pad`
//   (HW, a power of two >= TW + KW - 1, TH * HW <= 128: the plan's choice,
//   the fewest tiles), by TMA as `slabs` boxes of 16 channels each (one
//   128-channel chunk of C at a time), into a ring of halo stages on
//   mbarriers. TMA fills coordinates outside the image and past C with
//   zeros: the conv's padding (quantize(0) == 0) and the channel tail.
// - A straight from the halo, by descriptor: a slab is a run of 16-byte
//   pixel rows, which is wgmma's K-major layout without swizzle (core
//   matrices of 8 rows x 16 bytes, 128 bytes from one to the next 8 rows,
//   a slab from one 16 channels to the next). The accumulator rows are the
//   halo's positions m = y HW + x, 64 a warpgroup; tap (r, s) reads
//   positions m + r HW + s, so its A is the same descriptor started r HW +
//   s rows later. Rows with x >= TW are computed and never stored. No
//   im2col, no register fragments: every tap and 32-channel step of a
//   chunk is one wgmma m64nBNk32, all in one group.
// - The weights (N, KH, KW, C) come by TMA in boxes of 128 channels x BN
//   rows, one a (tap, chunk), 128-byte swizzled for wgmma's B descriptor
//   (zeros past C and N): all of them once per block, resident, when the
//   conv has one N tile and they fit (the plan's `resident`), else through
//   a ring of WSTAGES, a group a tap.
// - The epilogue's factors (w_scale[n] and x_scale, bias[n]) of every
//   output channel are read once a block into shared memory.
// - Epilogue through shared memory: the block stages its tile's outputs
//   (int8_common.cuh's arithmetic) in the output's own layout, a stretch of
//   global memory a segment (an output row of the tile when one N tile
//   holds all of N, else a pixel's BN channels), each staged at its global
//   address's offset mod 16, then writes 16-byte chunks, and the ragged ends
//   element by element. (At N = 3 a pixel is 6 bytes, below TMA's 16-byte
//   inner box: no TMA store.)
// - Two blocks an SM (113 KB of shared memory and 80 registers a thread at
//   most), so that one block's epilogue and barriers overlap the other's
//   loads and wgmmas.
// The quantize stays a launch of its own (int8_conv.cu): two launches a
// conv, as before.
//
// What bounds it now (64 -> 3 3x3 at 320x640, stage stamps of
// chip_smoke.py --parent; 32.8 us): the wgmmas, ~18 a 64-row block a unit
// at N = 8, whose cost does not shrink with N, and the staged epilogue,
// about as long; then the first unit's start. Two blocks an SM took it from
// 51 to 36.5 us, the factors in shared memory to 32.8. Measured on the
// H100 and dropped: A from registers
// (ldmatrix from the shifted halo, a group a tap or three; 57 us against
// 51 with descriptors, one block an SM), tap-interleaved accumulator chains
// (slower: the chains went to local memory), stores from the registers in
// place of the staging (faster only at 20x40 and N = 96, slower at 320x640
// and 160x320), and the halo by cp.async from the producer warpgroup in
// place of TMA's 16-byte rows (no faster).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "int8_common.cuh"
#include "sm90.cuh"

namespace {

using avp::MAX_DEVICES;
using namespace avp::sm90;

constexpr int THREADS = 384;       // the producer warpgroup + two consumers of 64 rows
constexpr int CONSUMERS = 256;
constexpr int BM = 128;            // output pixels of a tile
constexpr int CHUNK = 128;         // channels of a halo chunk and of a weight box
constexpr int SLAB = 16;           // channels of a slab: one 16-byte pixel row
constexpr int MAX_HSTAGES = 4;
constexpr int WSTAGES = 4;         // the weight ring when the weights are not resident
// two blocks an SM, so that one block's epilogue and barriers overlap the
// other's loads and wgmmas: each at most 113 KB of the SM's 228 (1 KB of
// each reserved), and 80 registers a thread at launch: setmaxnreg moves
// them from the producer warpgroup (32) to the consumers (104): 128 * (80 -
// 32) >= 256 * (104 - 80), or the consumers wait for registers forever
constexpr int BLOCKS_PER_SM = 2;
constexpr int SMEM_MAX = 113 * 1024;  // the dynamic shared memory a launch may ask for
constexpr int PRODUCER_REGS = 32, CONSUMER_REGS = 104;

#ifdef AVP_HALO_STAMPS
// chip_smoke.py's stage split (thread 128, the first consumer): 0 waiting
// for the halo, 1 the taps (weight waits, the wgmmas and their group
// waits), 2 staging the outputs, 3 copying them out, 4 the epilogue's first
// barrier (both warpgroups done with the taps, the last copy out done)
__device__ unsigned long long* g_halo_stamps;
using Stamps = StageClock;
#else
__device__ unsigned long long* const g_halo_stamps = nullptr;
using Stamps = NoClock;
#endif

struct HaloArgs {
  avp::Epilogue e;
  int OH, OW, C, KW, pad, taps, nc, slabs;
  int th, tw, tiles_h, tiles_w, n_tiles, units;
  int hw, lg_hw, hh;                // the halo's width (a power of two, 2^lg_hw) and height
  int slab_pitch, halo_bytes, hstages, resident;
  int w_off, stage_off, seg_pitch;  // the weights' and the staging's offsets; a segment's pitch
  int table_off;                    // the epilogue's factors of every output channel
};

struct Tile {
  int b, oh0, ow0, n0;
};

// Units are numbered with the N tile fastest, so blocks that run at once
// share the input tile.
__device__ __forceinline__ Tile tile(const HaloArgs& a, int u, int bn) {
  const int n = u % a.n_tiles, m = u / a.n_tiles;
  const int per_img = a.tiles_h * a.tiles_w, rem = m % per_img;
  Tile t;
  t.b = m / per_img;
  t.oh0 = (rem / a.tiles_w) * a.th;
  t.ow0 = (rem % a.tiles_w) * a.tw;
  t.n0 = n * bn;
  return t;
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// One output value (int8_common.cuh's epilogue) into the staging.
__device__ __forceinline__ void stage_value(unsigned char* p, const avp::Epilogue& e,
                                            const avp::Column& c, int acc) {
  if (e.out_kind == 2) {
    *reinterpret_cast<int*>(p) = acc;
  } else if (e.out_kind == 0) {
    *reinterpret_cast<float*>(p) = avp::f32_out(e, c, acc);
  } else {
    *reinterpret_cast<__nv_bfloat16*>(p) = avp::bf16_out(e, c, acc);
  }
}

template <int BN>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    int8_conv_halo_kernel(const __grid_constant__ CUtensorMap map_x,
                          const __grid_constant__ CUtensorMap map_w, const HaloArgs a) {
  constexpr int WB = BN * CHUNK;  // bytes of a weight box
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * MAX_HSTAGES + 2 * WSTAGES + 1];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t w_base = base + a.w_off;
  unsigned char* const staging = smem_raw + (base - raw) + a.stage_off;
  auto hfull = [&](int s) { return smem_u32(&bars[s]); };
  auto hempty = [&](int s) { return smem_u32(&bars[MAX_HSTAGES + s]); };
  auto wfull = [&](int s) { return smem_u32(&bars[2 * MAX_HSTAGES + s]); };
  auto wempty = [&](int s) { return smem_u32(&bars[2 * MAX_HSTAGES + WSTAGES + s]); };
  const uint32_t wall = smem_u32(&bars[2 * MAX_HSTAGES + 2 * WSTAGES]);  // resident weights

  if (threadIdx.x == 0) {
    prefetch_map(&map_x);
    prefetch_map(&map_w);
    for (int s = 0; s < MAX_HSTAGES; ++s) {
      mbar_init(hfull(s), 1);
      mbar_init(hempty(s), CONSUMERS);
    }
    for (int s = 0; s < WSTAGES; ++s) {
      mbar_init(wfull(s), 1);
      mbar_init(wempty(s), CONSUMERS);
    }
    mbar_init(wall, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer warpgroup: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      if (a.resident) {  // one N tile: every (chunk, tap) box once, for the block's life
        const int steps = a.nc * a.taps;
        mbar_expect_tx(wall, (uint32_t)(steps * WB));
        for (int j = 0; j < steps; ++j) {
          const int tap = j % a.taps;
          tma_load_4d(w_base + j * WB, &map_w, wall, (j / a.taps) * CHUNK, tap % a.KW,
                      tap / a.KW, 0);
        }
      }
      const uint32_t halo_tx = (uint32_t)(a.slabs * a.hh * a.hw * SLAB);
      int hi = 0, wi = 0;  // halo and weight loads so far: the rings' positions
      for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
        const Tile t = tile(a, u, BN);
        for (int c = 0; c < a.nc; ++c, ++hi) {
          const int hs = hi % a.hstages;
          mbar_wait(hempty(hs), ((hi / a.hstages) & 1) ^ 1);  // round 0 passes at once
          mbar_expect_tx(hfull(hs), halo_tx);
          for (int sl = 0; sl < a.slabs; ++sl)
            tma_load_4d(base + hs * a.halo_bytes + sl * a.slab_pitch, &map_x, hfull(hs),
                        c * CHUNK + sl * SLAB, t.ow0 - a.pad, t.oh0 - a.pad, t.b);
          if (a.resident) continue;
          for (int tap = 0; tap < a.taps; ++tap, ++wi) {
            const int ws = wi % WSTAGES;
            mbar_wait(wempty(ws), ((wi / WSTAGES) & 1) ^ 1);
            mbar_expect_tx(wfull(ws), (uint32_t)WB);
            tma_load_4d(w_base + ws * WB, &map_w, wfull(ws), c * CHUNK, tap % a.KW, tap / a.KW,
                        t.n0);
          }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: halo positions 64 * ci .. + 64 of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int ci = wg - 1, tid = threadIdx.x - 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const avp::Epilogue e = a.e;
  const int N = e.N, rows = a.th * a.tw;
  const int elem = e.out_kind == 1 ? 2 : 4;
  const bool row_segments = a.n_tiles == 1;  // a segment: an output row of the tile, else a pixel
  Stamps st;
  st.start();
  // the factors of every output channel, once, into shared memory (read
  // from global memory a unit, their latency was exposed in every epilogue)
  avp::Column* const table = reinterpret_cast<avp::Column*>(smem_raw + (base - raw) + a.table_off);
  if (e.out_kind != 2)
    for (int n = tid; n < N; n += CONSUMERS) table[n] = avp::column(e, n);
  consumer_sync();
  if (a.resident) mbar_wait(wall, 0);
  int hi = 0, wi = 0;
  for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
    const Tile t = tile(a, u, BN);
    int acc[BN / 2];
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] = 0;
    for (int c = 0; c < a.nc; ++c, ++hi) {
      const int hs = hi % a.hstages;
      const int kn = min(4, (a.C - c * CHUNK + 31) / 32);  // 32-channel steps of this chunk
      mbar_wait(hfull(hs), (hi / a.hstages) & 1);
      st.lap(0);
      // this warpgroup's first position; a 32-channel step is two slabs
      const uint32_t h0 = base + hs * a.halo_bytes + ci * 64 * SLAB;
      auto tap_mma = [&](int tap, uint32_t wsm) {
        const int r = tap / a.KW, q = tap - r * a.KW;
        const uint32_t at = h0 + (uint32_t)((r * a.hw + q) * SLAB);
        const uint64_t db = smem_desc(wsm);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if (kk < kn)
            wgmma_ss<BN>(acc, smem_desc_plain(at + kk * 2 * a.slab_pitch, a.slab_pitch, 8 * SLAB),
                         db + 2 * kk);
      };
      if (a.resident) {  // every tap of the chunk, one group
        fence_regs(acc);
        wgmma_fence();
        for (int tap = 0; tap < a.taps; ++tap) tap_mma(tap, w_base + (c * a.taps + tap) * WB);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
      } else {  // a group a tap; a ring stage is released once its group is done
        int prev = -1;
        for (int tap = 0; tap < a.taps; ++tap, ++wi) {
          const int ws = wi % WSTAGES;
          mbar_wait(wfull(ws), (wi / WSTAGES) & 1);
          fence_regs(acc);
          wgmma_fence();
          tap_mma(tap, w_base + ws * WB);
          wgmma_commit();
          wgmma_wait<1>();
          fence_regs(acc);
          if (prev >= 0) mbar_arrive(wempty(prev));
          prev = ws;
        }
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(wempty(prev));
      }
      mbar_arrive(hempty(hs));  // the chunk's wgmmas have read the halo
      st.lap(1);
    }

    // ---- epilogue: stage the tile in the output's layout, then copy it out
    const int ncols = min(BN, N - t.n0);
    // this thread's columns' factors, all read before the first staging store
    avp::Column cfs[BN / 8][2];
#pragma unroll
    for (int p = 0; p < BN / 8; ++p)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int col = 8 * p + 2 * t4 + x;
        cfs[p][x] = e.out_kind == 2 || col >= ncols ? avp::Column{0.f, 0.f} : table[t.n0 + col];
      }
    consumer_sync();  // the unit before has copied its staging out
    st.lap(4);
#pragma unroll
    for (int p = 0; p < BN / 8; ++p)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int col = 8 * p + 2 * t4 + x;
        if (col >= ncols) continue;
        const avp::Column cf = cfs[p][x];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // accumulator row: halo position y HW + xx; an output for xx < TW
          const int pos = ci * 64 + warp * 16 + g + 8 * h;
          const int y = pos >> a.lg_hw, xx = pos & (a.hw - 1);
          if (y >= a.th || xx >= a.tw) continue;
          const int oh = t.oh0 + y, ow = t.ow0 + xx;
          if (oh >= a.OH || ow >= a.OW) continue;
          const int seg = row_segments ? y : y * a.tw + xx;
          const long long start = row_segments
                                      ? ((long long)(t.b * a.OH + oh) * a.OW + t.ow0) * N
                                      : ((long long)(t.b * a.OH + oh) * a.OW + ow) * N + t.n0;
          const int off = row_segments ? (xx * N + col) * elem : col * elem;
          unsigned char* p8 = staging + seg * a.seg_pitch + (int)((start * elem) & 15) + off;
          stage_value(p8, e, cf, acc[4 * p + 2 * h + x]);
        }
      }
    consumer_sync();
    st.lap(2);
    const int segs = row_segments ? min(a.th, a.OH - t.oh0) : rows;
    const int seg_len = (row_segments ? min(a.tw, a.OW - t.ow0) * N : ncols) * elem;
    const int windows = (seg_len + 15) / 16 + 1;  // 16-byte windows a segment touches at most
    for (int i = tid; i < segs * windows; i += CONSUMERS) {
      const int s = i / windows, j = i - s * windows;
      long long start;
      if (row_segments) {
        start = ((long long)(t.b * a.OH + t.oh0 + s) * a.OW + t.ow0) * N;
      } else {
        const int y = s / a.tw, xx = s - y * a.tw;
        if (t.oh0 + y >= a.OH || t.ow0 + xx >= a.OW) continue;
        start = ((long long)(t.b * a.OH + t.oh0 + y) * a.OW + t.ow0 + xx) * N + t.n0;
      }
      unsigned char* gp = static_cast<unsigned char*>(e.out) + start * elem;
      const int mis = (int)((uintptr_t)gp & 15);
      const int lo = max(0, 16 * j - mis), hi_b = min(seg_len, 16 * j + 16 - mis);
      if (lo >= hi_b) continue;
      const unsigned char* sp = staging + s * a.seg_pitch + mis;
      if (hi_b - lo == 16) {
        *reinterpret_cast<uint4*>(gp + lo) = *reinterpret_cast<const uint4*>(sp + lo);
      } else if (elem == 2) {
        for (int k = lo; k < hi_b; k += 2)
          *reinterpret_cast<uint16_t*>(gp + k) = *reinterpret_cast<const uint16_t*>(sp + k);
      } else {
        for (int k = lo; k < hi_b; k += 4)
          *reinterpret_cast<uint32_t*>(gp + k) = *reinterpret_cast<const uint32_t*>(sp + k);
      }
    }
    st.lap(3);
  }
  if (threadIdx.x == 128) st.write(g_halo_stamps);
}

// The shared memory of a launch: the halo ring, the weights (resident or a
// ring), the output staging, and 1024 bytes to align the base.
struct Layout {
  int slab_pitch, halo_bytes, wbytes, seg_pitch, stage_bytes, table_bytes, smem;
};

Layout layout(int th, int tw, int hh, int hw, int KH, int KW, int slabs, int bn, int taps,
              int nc, int N, int n_tiles, int hstages, int resident) {
  Layout l;
  // a slab holds the halo and what the taps of the 128 positions read past
  // it (positions never stored); a TMA destination starts on 128 bytes
  const int rows = max(hh * hw, BM + (KH - 1) * hw + KW - 1);
  l.slab_pitch = (rows * SLAB + 127) / 128 * 128;
  l.halo_bytes = (slabs * l.slab_pitch + 1023) / 1024 * 1024;
  l.wbytes = (resident ? taps * nc : WSTAGES) * bn * CHUNK;
  // a segment's values in 4-byte elements at most, shifted by up to 15 bytes
  const int seg_elems = n_tiles == 1 ? tw * N : bn;
  l.seg_pitch = (seg_elems * 4 + 15) / 16 * 16 + 16;
  l.stage_bytes = (n_tiles == 1 ? th : th * tw) * l.seg_pitch;
  l.table_bytes = (N * 8 + 127) / 128 * 128;
  l.smem = 1024 + hstages * l.halo_bytes + l.wbytes + l.stage_bytes + l.table_bytes;
  return l;
}

template <int BN>
cudaError_t launch_halo(const CUtensorMap& mx, const CUtensorMap& mw, const HaloArgs& a,
                        int blocks, int smem, cudaStream_t stream) {
  // the dynamic shared-memory limit is set once per kernel and device
  static bool ready[MAX_DEVICES] = {false};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES || !ready[dev]) {
    err = cudaFuncSetAttribute(int8_conv_halo_kernel<BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return err;
    if (dev >= 0 && dev < MAX_DEVICES) ready[dev] = true;
  }
  int8_conv_halo_kernel<BN><<<blocks, THREADS, smem, stream>>>(mx, mw, a);
  return cudaGetLastError();
}

}  // namespace

// The stamp buffer of a build with -DAVP_HALO_STAMPS (chip_smoke.py's stage
// split), 8 words a block; without stamps, cudaErrorNotSupported.
extern "C" int avp_int8_halo_set_stamps(void* stamps) {
#ifdef AVP_HALO_STAMPS
  return (int)cudaMemcpyToSymbol(g_halo_stamps, &stamps, sizeof(stamps));
#else
  (void)stamps;
  return (int)cudaErrorNotSupported;
#endif
}

// Launches the halo route on `stream` and returns cudaGetLastError() (0 on
// success), or 100000 + a CUresult if the input's tensor map is refused.
// xq: (B, H, W, C) int8, 16-byte aligned, C a multiple of 16; w: the (N,
// KH, KW, C) int8 weights, 16-byte aligned (their map in boxes of bn output
// channels encoded at the first launch and kept, sm90.cuh::weight_map);
// w_scale: (N,) f32; x_scale: one f32, or null for a per-channel input
// scale already folded into the weights; bias: (N,) of the output type, or
// null; out: (B, OH, OW, N), OH = H + 2 pad - KH + 1 (stride 1), f32
// (out_kind 0), bf16 (1) or the int32 accumulators (2), 16-byte aligned.
// The plan's numbers: the th x tw rectangle (th times the halo's width,
// the power of two >= tw + KW - 1 and >= 8, at most 128), bn (8, 16, 24, 32, 48 or 64
// output channels), the m and n tiles, the persistent blocks, the halo
// stages (2-4) and whether the weights are resident (one N tile only).
extern "C" int avp_int8_conv_halo(const void* xq, const void* w, const void* w_scale,
                                  const void* x_scale, const void* bias, void* out, int B, int H,
                                  int W, int C, int N, int KH, int KW, int pad, int out_kind,
                                  int th, int tw, int bn, int m_tiles, int n_tiles, int blocks,
                                  int hstages, int resident, void* stream) {
  HaloArgs a;
  a.OH = H + 2 * pad - KH + 1;
  a.OW = W + 2 * pad - KW + 1;
  a.C = C;
  a.KW = KW;
  a.pad = pad;
  a.taps = KH * KW;
  a.nc = (C + CHUNK - 1) / CHUNK;
  // a chunk's slabs: 8, or C's own rounded up to an even count (a 32-channel step)
  a.slabs = a.nc > 1 ? CHUNK / SLAB : (C / SLAB + 1) / 2 * 2;
  a.th = th;
  a.tw = tw;
  a.tiles_h = th > 0 ? (a.OH + th - 1) / th : 0;
  a.tiles_w = tw > 0 ? (a.OW + tw - 1) / tw : 0;
  a.n_tiles = n_tiles;
  a.units = m_tiles * n_tiles;
  // the halo's width: a power of two (at least 8) that holds tw + KW - 1
  a.lg_hw = 3;
  while ((1 << a.lg_hw) < tw + KW - 1) ++a.lg_hw;
  a.hw = 1 << a.lg_hw;
  a.hh = th + KH - 1;
  a.hstages = hstages;
  a.resident = resident;
  a.e.w_scale = (const float*)w_scale;
  a.e.x_scale = (const float*)x_scale;
  a.e.bias = bias;
  a.e.out = out;
  a.e.N = N;
  a.e.out_kind = out_kind;
  const long long M = (long long)B * a.OH * a.OW;
  if (!out || !w || B <= 0 || C <= 0 || C % 16 || N <= 0 || KH <= 0 || KW <= 0 ||
      pad < 0 || a.OH <= 0 || a.OW <= 0 || M > 0x7fffffffLL || out_kind < 0 || out_kind > 2 ||
      (bn != 8 && bn != 16 && bn != 24 && bn != 32 && bn != 48 && bn != 64) ||
      th <= 0 || tw <= 0 || th * a.hw > BM || a.hh > 256 ||
      (long long)m_tiles != (long long)B * a.tiles_h * a.tiles_w ||
      n_tiles != (N + bn - 1) / bn || (long long)m_tiles * n_tiles > 0x7fffffffLL ||
      blocks <= 0 || blocks > a.units || hstages < 2 || hstages > MAX_HSTAGES ||
      (resident && n_tiles != 1))
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)xq % 16 || (uintptr_t)out % 16 || (uintptr_t)w % 16)
    return (int)cudaErrorMisalignedAddress;
  const Layout l = layout(th, tw, a.hh, a.hw, KH, KW, a.slabs, bn, a.taps, a.nc, N, n_tiles,
                          hstages, resident);
  if (l.smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  a.slab_pitch = l.slab_pitch;
  a.halo_bytes = l.halo_bytes;
  a.w_off = hstages * l.halo_bytes;
  a.stage_off = a.w_off + l.wbytes;
  a.seg_pitch = l.seg_pitch;
  a.table_off = a.stage_off + l.stage_bytes;

  alignas(64) CUtensorMap map_x, map_w;
  const uint64_t dims[4] = {(uint64_t)C, (uint64_t)W, (uint64_t)H, (uint64_t)B};
  const uint32_t box[4] = {(uint32_t)SLAB, (uint32_t)a.hw, (uint32_t)a.hh, 1u};
  int err = encode(&map_x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 4, xq, dims, box,
                   CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err) return err;
  err = weight_map(&map_w, w, N, KH, KW, C, bn);
  if (err) return err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (bn) {
    case 8: return (int)launch_halo<8>(map_x, map_w, a, blocks, l.smem, s);
    case 16: return (int)launch_halo<16>(map_x, map_w, a, blocks, l.smem, s);
    case 24: return (int)launch_halo<24>(map_x, map_w, a, blocks, l.smem, s);
    case 32: return (int)launch_halo<32>(map_x, map_w, a, blocks, l.smem, s);
    case 48: return (int)launch_halo<48>(map_x, map_w, a, blocks, l.smem, s);
    default: return (int)launch_halo<64>(map_x, map_w, a, blocks, l.smem, s);
  }
}
