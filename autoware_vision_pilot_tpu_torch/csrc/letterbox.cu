// Letterbox for Hopper (sm_90a): a uint8 BGR frame (or a batch of them) ->
// cv2 INTER_LINEAR resize to nh x nw (half-pixel sampling, no
// antialiasing) -> placed at row pad_y, column pad_x of an h x w image of
// gray `pad` -> RGB -> x 1/255 -> one cast to bf16 or f32, NHWC.
//
// Replaces XLA's fusion of autoware_vision_pilot_tpu/ops/preprocess.py::
// letterbox (:86-110) (resize, jnp.pad, flip, * 1/255, astype), the
// AutoSpeed input of the longitudinal program, build_engine,
// AutoSpeedInfer and the fleet. The plain version is
// ops/preprocess.py::letterbox; the kernel performs its f32 operations in
// the same order, each an explicit round-to-nearest intrinsic that the
// compiler never contracts into an FMA, so the two are bit-equal. The
// source rows and columns and their fractional weights come from host
// tables (ops/preprocess.py::bilinear_taps, in float64 as the JAX package
// computes them): coordinates computed on the card in f32 would shift the
// weights.
//
// What bounds it on the H100: bytes. At 720x1280 -> 640x640 bf16 it reads
// the frame once (2.76 MB: every row and column is a tap at scale 0.5) and
// writes the output once (2.46 MB, 280 of its 640 rows pad), 1.56 us at
// 3.35 TB/s. The arithmetic is four taps and a scale a value.
//
// Design: no persistent blocks and no block barrier. The grid is a warp
// for each (image row of all B images, 64 output columns) unit, then a
// warp for each 1 KB piece of the pad; 8 warps a block
// (ops/kernels/preprocess_kernel.py::letterbox_plan).
// - An image warp loads its row's taps (y0, y1, fy), its lanes' column
//   taps (2 output pixels a lane) and its chunk's source byte range [3
//   x0[first], 3 x1[last] + 3), then copies that range of its two source
//   rows (one if y0 = y1) into its own shared memory with cp.async, 16
//   bytes a lane. The 16-byte words that lie inside the image are copied;
//   the at most 15 bytes before the first whole word of the image and
//   after its last (a frame that starts off 16 bytes, as a view of a batch
//   may) are read with plain loads; nothing outside [image start, image
//   end) is read. It writes the pad columns left and right of its row (the
//   row's first and last chunk), waits for its copies, lerps (rows, then
//   columns, in f32; a source byte becomes an f32 by an integer or and an
//   f32 subtract, not the conversion unit), scales by 1/255 and stores its
//   values with 4-byte (bf16, two values by one paired conversion) or
//   8-byte (f32) stores: a warp writes 384 (768) contiguous bytes.
// - The pad: the B + 1 runs of pad rows (above image 0, between images,
//   below the last) are each contiguous; a pad warp writes one piece of
//   64 16-byte words (two 512-byte stores), the ragged values at a run's
//   ends one by one. The pad value is one number in all three channels,
//   RN32(114 * RN32(1/255)) cast to the output type; the wrapper computes
//   its bits once (letterbox_pad_bits) and the kernel only stores them.
//   The pad blocks follow the image blocks in the grid and run in the same
//   wave at N = 1, so their stores overlap the image warps' loads.
// - What holds it back (chip_smoke.py --parent's stage split, H100 80GB
//   HBM3 at 700 W, 720p -> 640x640 bf16): two dependent memory round
//   trips. From a warp's start to the landing of the taps that address its
//   copies (y0, y1, x0[first], x1[last], from L2) 0.85-1.07 us; then its
//   source bytes (DRAM) 1.1-1.4 us; against a 0.26 us lerp and store. At N
//   = 8, ~9 waves of such warps; more warps resident (40 or 48 registers)
//   did not help. 4.7 us at N = 1 and 23.6-23.8 at N = 8, against 4.9-5.0
//   and 27.8-28.0 for the letterbox mode of csrc/preprocess.cu that it
//   replaces, in the same call.
//
// Dropped on the way (probe builds on the H100 at 700 W, each against the
// letterbox mode it replaces in the same call: 5.0-5.1 us at N = 1,
// 27.8-28.1 at N = 8, 4.7 at 375x1242):
// - The persistent design: two blocks a SM (264) walking bands of rows,
//   a producer warp landing each source row once by 1D bulk copies into an
//   mbarrier ring, consumer warps lerping into three staging rows sent out
//   by bulk stores (cp.async.bulk.global.shared::cta, wait_group.read): 6.67
//   and 24.93 us. Its stage split at N = 8 (a block's 25 us): 10.0 us
//   waiting for rows, 9.7 lerp and barrier, 3.4 store, 1.9 pad; the
//   producer waited 8.1 us for a free slot. The same with the consumers'
//   register stores in place of the staging: 6.41 and 25.0; with 16-byte
//   stores staged a warp at a time (and a 64-register cap that spilled):
//   7.41 and 31.1. Built with no lerp and no loads it still took 5.1 and
//   17.9 us: the per-row mbarrier waits, shuffles, 64-bit division and
//   indexing of every consumer warp, not the bytes.
// - Warp-private rings (each warp its own bulk-copy producer over a column
//   segment of a band): 6.09 and 26.95 us at best; a relaxed in place of a
//   release arrive changed nothing.
// - This design with the pad cut evenly over every image warp (each warp
//   walking the B + 1 runs): 5.67 and 50.3 us (the walk's bookkeeping on
//   28,800 warps); with its stores staged for 16-byte stores: 5.79 and
//   31.7; with 5, 6 or 8 blocks a SM forced by launch bounds: no faster
//   (8: 5.67 and 29.5, spills).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// CHUNK, WARPS, PIECE and SMEM_LIMIT are also the LB_* constants of
// ops/kernels/preprocess_kernel.py, whose letterbox_plan models the grid
// (tests/test_torch_letterbox.py reads them here and holds the two equal).
constexpr int PX = 2;           // output pixels a lane
constexpr int CHUNK = 32 * PX;  // output pixels a warp: its unit of work
constexpr int WARPS = 8;        // warps a block
constexpr int PIECE = 64;       // 16-byte words of the pad a warp writes
constexpr int MAX_DEVICES = 64;
constexpr int SMEM_LIMIT = 227 * 1024;

// Bytes a copy of `bytes` bytes that starts at any offset from 16 needs:
// its whole 16-byte words, and one more for the offset.
__host__ __device__ constexpr int span(int bytes) { return (bytes + 15) / 16 * 16 + 16; }

// The source pixels that `px` consecutive output columns read, at most:
// x1[last] - x0[first] + 1 <= (px - 1) W / nw + 3.
__host__ __device__ inline int segment_pixels(int px, int W, int nw) {
  const long long n = ((long long)px * W + nw - 1) / nw + 3;
  return (int)(n < W ? n : W);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename T>
__device__ __forceinline__ T cast_out(float v);

template <>
__device__ __forceinline__ __nv_bfloat16 cast_out<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, like torch
}

template <typename T>
__device__ __forceinline__ T from_bits(uint32_t bits);

template <>
__device__ __forceinline__ float from_bits<float>(uint32_t bits) { return __uint_as_float(bits); }

template <>
__device__ __forceinline__ __nv_bfloat16 from_bits<__nv_bfloat16>(uint32_t bits) {
  __nv_bfloat16_raw r;
  r.x = (unsigned short)bits;
  return __nv_bfloat16(r);
}

#ifdef AVP_LB_STAMPS
// A stage split for chip_smoke.py (built with -DAVP_LB_STAMPS, never by
// kernels/build.py): lane 0 of each block's first warp adds up the SM
// clocks it spends in each stage (0 the unit decoded and the taps that
// address its copies (y0, y1, x0[first], x1[last]) loaded and landed, 1
// the source rows' bytes copied, issued and landed, 2 the lerp and the
// stores, 3 a piece of the pad, in a pad block) and writes them, with the
// warp's first and last %globaltimer and its clocks in all, as words 0-6
// of 8 a block.
__device__ unsigned long long* g_lb_stamps;
__device__ int g_lb_sink;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

struct Stamps {
  unsigned long long g0;
  long long c0, t, c[4];
  __device__ __forceinline__ void start() {
    g0 = global_ns();
    c0 = t = clock64();
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] = 0;
  }
  __device__ __forceinline__ void lap(int i) {
    long long now;
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(now)::"memory");
    c[i] += now - t;
    t = now;
  }
  // lap i once v has landed: the store of v waits for its loads, and the
  // clock is read after the store
  __device__ __forceinline__ void lap_after(int i, int v) {
    *(volatile int*)&g_lb_sink = v;
    lap(i);
  }
  __device__ __forceinline__ void write() {
    if (!g_lb_stamps) return;
    unsigned long long* o = g_lb_stamps + 8 * blockIdx.x;
    o[0] = g0;
    o[1] = global_ns();
    o[2] = (unsigned long long)(clock64() - c0);
#pragma unroll
    for (int i = 0; i < 4; ++i) o[3 + i] = (unsigned long long)c[i];
    o[7] = 0;
  }
};
#else
struct Stamps {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void lap(int) {}
  __device__ __forceinline__ void lap_after(int, int) {}
  __device__ __forceinline__ void write() {}
};
#endif

struct Taps {
  const int *y0, *y1, *x0, *x1;
  const float *fy, *fx;
};

struct Geometry {
  long long frame_stride;  // bytes from image b to image b + 1
  int B, H, W, h, w, nh, nw, pad_y, pad_x;
  int chunks;         // units of CHUNK output columns a row
  int image_blocks;   // blocks of image units; the rest write the pad
  int slot;           // shared bytes of a warp's copy of one source row
  uint32_t pad_bits;  // the pad value's bits in the output type
};

// Copies the `bytes` bytes at src (inside [lo, hi)) to dst + src % 16 (dst
// 16-byte aligned): its 16-byte words inside the image by cp.async, a lane
// a word, the bytes outside them (at most 16 before, 15 after) by plain
// loads. Called by the whole warp; the caller waits (cp_async_wait_all)
// and crosses __syncwarp before it reads dst.
__device__ __forceinline__ void copy_segment(uint8_t* dst, const uint8_t* src, int bytes,
                                             const uint8_t* lo, const uint8_t* hi, int lane) {
  const uintptr_t s = (uintptr_t)src, base = s & ~(uintptr_t)15;
  const uintptr_t lo16 = ((uintptr_t)lo + 15) & ~(uintptr_t)15, hi16 = (uintptr_t)hi & ~(uintptr_t)15;
  const uintptr_t end16 = (s + bytes + 15) & ~(uintptr_t)15;
  uintptr_t cl = base > lo16 ? base : lo16;
  uintptr_t ch = end16 < hi16 ? end16 : hi16;
  // no whole word of the image under the bytes (fewer than 31): bytes only
  if (ch <= cl) cl = ch = s + min(bytes, 16);
  const int front = cl > s ? (int)(cl - s) : 0;
  const int back = s + bytes > ch ? (int)(s + bytes - ch) : 0;
  uint8_t* row = dst + (s - base);  // where src lands
  if (lane < front) row[lane] = __ldg(src + lane);
  if (lane >= 16 && lane - 16 < back) row[bytes - back + lane - 16] = __ldg(src + bytes - back + lane - 16);
  const int words = (int)(ch - cl) / 16;
  for (int i = lane; i < words; i += 32)
    cp_async16(dst + (cl - base) + 16 * i, reinterpret_cast<const void*>(cl + 16 * i));
}

// The pad: B + 1 runs of pad rows (above image 0, between images b - 1 and
// b, below the last), each contiguous, cut into pieces of PIECE 16-byte
// words (a warp's two stores of 512 contiguous bytes), a warp a piece.
// The values before a run's first whole word and after its last are stored
// one by one by the warps of its first and its last piece.
struct PadRun {
  int start, n;              // first value, values
  int head, words, pieces;   // values before the first whole word, words, pieces
};

// Run r of the pad of the (B, h, w, 3) output of `elem`-byte values at
// `out`: the host sizes the grid by it (grid_blocks), the pad warps walk it.
__host__ __device__ inline PadRun pad_run(uintptr_t out, int elem, int r, int B, int h, int w,
                                          int nh, int pad_y) {
  const int below = h - nh - pad_y, out_row = 3 * w;
  PadRun run;
  run.start = (r == 0 ? 0 : (r - 1) * h + pad_y + nh) * out_row;
  run.n = (r == 0 ? pad_y : r == B ? below : below + pad_y) * out_row;
  const int lead = (int)((out + (uintptr_t)run.start * elem) % 16);
  const int head = lead ? (16 - lead) / elem : 0;
  run.head = run.n < head ? run.n : head;
  run.words = (int)((long long)(run.n - run.head) * elem / 16);
  const int pieces = (run.words + PIECE - 1) / PIECE;
  run.pieces = run.n > 0 ? (pieces > 1 ? pieces : 1) : 0;
  return run;
}

// Writes piece `piece` of the pad (numbered over all runs, in order); a
// warp past the last piece writes nothing.
template <typename T>
__device__ __forceinline__ void fill_piece(T* out, const Geometry& g, int piece, T v, uint4 word,
                                           int lane) {
  for (int r = 0; r <= g.B; ++r) {
    const PadRun run = pad_run((uintptr_t)out, (int)sizeof(T), r, g.B, g.h, g.w, g.nh, g.pad_y);
    if (piece >= run.pieces) {
      piece -= run.pieces;
      continue;
    }
    T* seg = out + run.start;
    uint4* wp = reinterpret_cast<uint4*>(seg + run.head);
#pragma unroll
    for (int i = 0; i < PIECE / 32; ++i) {
      const int k = PIECE * piece + 32 * i + lane;
      if (k < run.words) wp[k] = word;
    }
    const int tail = run.head + run.words * 16 / (int)sizeof(T);
    if (piece == 0 && lane < run.head) seg[lane] = v;
    if (piece == run.pieces - 1 && tail + lane < run.n) seg[tail + lane] = v;
    return;
  }
}

// A source byte as f32, exactly, without the conversion unit (a quarter
// of the FP32 rate): 2^23 + v is the f32 whose low mantissa bits are v.
__device__ __forceinline__ float byte_to_float(uint32_t v) {
  return __fsub_rn(__uint_as_float(0x4B000000u | v), 8388608.0f);
}

// A lane's 3 PX values, cast, at dst: as words of two values (bf16: one
// paired conversion each) where dst is aligned for them and the lane's
// pixels are whole, else value by value.
__device__ __forceinline__ void store_values(__nv_bfloat16* dst, const float (&u)[3 * PX], int n) {
  if (n == 3 * PX && (uintptr_t)dst % 4 == 0) {
    __nv_bfloat162* w = reinterpret_cast<__nv_bfloat162*>(dst);
#pragma unroll
    for (int i = 0; i < 3 * PX / 2; ++i) w[i] = __floats2bfloat162_rn(u[2 * i], u[2 * i + 1]);
  } else {
    for (int i = 0; i < n; ++i) dst[i] = cast_out<__nv_bfloat16>(u[i]);
  }
}

__device__ __forceinline__ void store_values(float* dst, const float (&u)[3 * PX], int n) {
  if (n == 3 * PX && (uintptr_t)dst % 8 == 0) {
    float2* w = reinterpret_cast<float2*>(dst);
#pragma unroll
    for (int i = 0; i < 3 * PX / 2; ++i) w[i] = make_float2(u[2 * i], u[2 * i + 1]);
  } else {
    for (int i = 0; i < n; ++i) dst[i] = u[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32) letterbox_kernel(const uint8_t* __restrict__ frame,
                                                               T* __restrict__ out, Taps t,
                                                               Geometry g) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  Stamps st;
  const bool timed = warp == 0 && lane == 0;
  if (timed) st.start();
  const T padv = from_bits<T>(g.pad_bits);
  if ((int)blockIdx.x >= g.image_blocks) {  // a piece of the pad
    const uint32_t lane_bits = sizeof(T) == 2 ? (g.pad_bits & 0xffffu) * 0x10001u : g.pad_bits;
    fill_piece(out, g, ((int)blockIdx.x - g.image_blocks) * WARPS + warp, padv,
               make_uint4(lane_bits, lane_bits, lane_bits, lane_bits), lane);
    if (timed) {
      st.lap(3);
      st.write();
    }
    return;
  }
  const int unit = blockIdx.x * WARPS + warp;  // (image row, chunk of columns)
  if (unit >= g.B * g.nh * g.chunks) return;
  const int q = unit / g.chunks, c = unit - q * g.chunks;
  const int b = q / g.nh, iy = q - b * g.nh;
  // the taps: the row's, this lane's columns', and the chunk's source bytes
  const int px = c * CHUNK + lane * PX, np = min(PX, g.nw - px);
  const int first = c * CHUNK, last = min(first + CHUNK, g.nw) - 1;
  const int y0 = __ldg(t.y0 + iy), y1 = __ldg(t.y1 + iy);
  const float fy = __ldg(t.fy + iy);
  const int sx0 = 3 * __ldg(t.x0 + first), sx1 = 3 * (__ldg(t.x1 + last) + 1);
  int x0[PX], x1[PX];
  float fx[PX];
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int ox = min(px + p, g.nw - 1);
    x0[p] = __ldg(t.x0 + ox);
    x1[p] = __ldg(t.x1 + ox);
    fx[p] = __ldg(t.fx + ox);
  }
  if (timed) st.lap_after(0, y0 ^ y1 ^ sx0 ^ sx1);

  // the two source rows' bytes [sx0, sx1)
  const int row = 3 * g.W;
  const uint8_t* img = frame + (size_t)b * (size_t)g.frame_stride;
  const uint8_t* hi = img + (size_t)g.H * row;
  uint8_t* s0 = smem + warp * 2 * g.slot;
  uint8_t* s1 = y1 == y0 ? s0 : s0 + g.slot;
  copy_segment(s0, img + (size_t)y0 * row + sx0, sx1 - sx0, img, hi, lane);
  if (y1 != y0) copy_segment(s1, img + (size_t)y1 * row + sx0, sx1 - sx0, img, hi, lane);
  if (timed) st.lap(1);

  T* dst = out + ((size_t)b * g.h + g.pad_y + iy) * (3 * g.w);
  if (c == 0)  // the pad columns left of the image
    for (int k = lane; k < g.pad_x * 3; k += 32) dst[k] = padv;
  if (c == g.chunks - 1)  // and right of it
    for (int k = (g.pad_x + g.nw) * 3 + lane; k < 3 * g.w; k += 32) dst[k] = padv;
  cp_async_wait_all();
  __syncwarp();
  if (timed) st.lap(1);

  // the lerp: rows, then columns, in f32, from the copies (each placed at
  // its own offset from 16; byte x of the source row at r[x - sx0])
  const uint8_t* r0 = s0 + (uintptr_t)(img + (size_t)y0 * row + sx0) % 16;
  const uint8_t* r1 = s1 + (uintptr_t)(img + (size_t)y1 * row + sx0) % 16;
  const float gy = __fsub_rn(1.0f, fy);
  if (np > 0) {
    float u[3 * PX];
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      const float gx = __fsub_rn(1.0f, fx[p]);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const int ic = 2 - ch;  // BGR -> RGB: output channel ch reads plane 2 - ch
        const int a = x0[p] * 3 + ic - sx0, e = x1[p] * 3 + ic - sx0;
        const float t0 = __fadd_rn(__fmul_rn(byte_to_float(r0[a]), gy),
                                   __fmul_rn(byte_to_float(r1[a]), fy));
        const float t1 = __fadd_rn(__fmul_rn(byte_to_float(r0[e]), gy),
                                   __fmul_rn(byte_to_float(r1[e]), fy));
        u[3 * p + ch] = __fmul_rn(__fadd_rn(__fmul_rn(t0, gx), __fmul_rn(t1, fx[p])),
                                  1.0f / 255.0f);
      }
    }
    store_values(dst + (g.pad_x + px) * 3, u, 3 * np);
  }
  if (timed) {
    st.lap(2);
    st.write();
  }
}

// The grid: the image units' blocks, then the pad pieces', a warp each.
inline int grid_blocks(uintptr_t out, int elem, const Geometry& g) {
  long long pieces = 0;
  for (int r = 0; r <= g.B; ++r) pieces += pad_run(out, elem, r, g.B, g.h, g.w, g.nh, g.pad_y).pieces;
  return g.image_blocks + (int)((pieces + WARPS - 1) / WARPS);
}

template <typename T>
cudaError_t launch(const uint8_t* frame, T* out, const Taps& t, const Geometry& g, size_t smem,
                   cudaStream_t s) {
  static bool ready[MAX_DEVICES] = {false};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (smem > 48 * 1024 && (dev < 0 || dev >= MAX_DEVICES || !ready[dev])) {
    // once, at the limit; it then holds for every smaller launch
    err = cudaFuncSetAttribute(letterbox_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_LIMIT);
    if (err != cudaSuccess) return err;
    if (dev >= 0 && dev < MAX_DEVICES) ready[dev] = true;
  }
  const int blocks = grid_blocks((uintptr_t)out, (int)sizeof(T), g);
  letterbox_kernel<T><<<blocks, WARPS * 32, smem, s>>>(frame, out, t, g);
  return cudaGetLastError();
}

}  // namespace

// The stamp buffer of a build with -DAVP_LB_STAMPS (chip_smoke.py's stage
// split), 8 words a block; without stamps, cudaErrorNotSupported.
extern "C" int avp_letterbox_set_stamps(void* stamps) {
#ifdef AVP_LB_STAMPS
  return (int)cudaMemcpyToSymbol(g_lb_stamps, &stamps, sizeof(stamps));
#else
  (void)stamps;
  return (int)cudaErrorNotSupported;
#endif
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// frame: B images of (H, W, 3) uint8, each contiguous, frame_stride bytes
// apart (any stride >= 0, any alignment); out: (B, h, w, 3) bf16 if
// out_bf16 else f32, 16-byte aligned. The frame is resized to nh x nw and
// placed at row pad_y, column pad_x of out; every other value is the one
// whose bits pad_bits holds (bf16: the low 16). y0, y1, x0, x1 (int32) and
// fy, fx (f32): the taps of bilinear_taps(H, nh) and (W, nw). A warp a
// (row, 64 output columns), then a warp a piece of the pad, 8 warps a
// block (preprocess_kernel.py::letterbox_plan models the grid).
extern "C" int avp_letterbox(const void* frame, void* out, const void* y0, const void* y1,
                             const void* fy, const void* x0, const void* x1, const void* fx,
                             long long frame_stride, int B, int H, int W, int h, int w, int nh,
                             int nw, int pad_y, int pad_x, int pad_bits, int out_bf16,
                             void* stream) {
  const int chunks = nw > 0 ? (nw + CHUNK - 1) / CHUNK : 0;
  if (B <= 0 || frame_stride < 0 || H <= 0 || W <= 0 || h <= 0 || w <= 0 || nh <= 0 ||
      nw <= 0 || pad_y < 0 || pad_x < 0 || pad_y + nh > h || pad_x + nw > w ||
      3LL * B * h * w >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)out % 16) return (int)cudaErrorMisalignedAddress;
  const int slot = span(3 * segment_pixels(CHUNK, W, nw));
  const long long smem = (long long)WARPS * 2 * slot;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const int image_blocks = (int)(((long long)B * nh * chunks + WARPS - 1) / WARPS);
  const Taps t{(const int*)y0, (const int*)y1, (const int*)x0,
               (const int*)x1, (const float*)fy, (const float*)fx};
  const Geometry g{frame_stride, B,      H,     W,      h,     w,        nh,
                   nw,           pad_y,  pad_x, chunks, image_blocks, slot, (uint32_t)pad_bits};
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* f = (const uint8_t*)frame;
  return (int)(out_bf16 ? launch<__nv_bfloat16>(f, (__nv_bfloat16*)out, t, g, (size_t)smem, s)
                        : launch<float>(f, (float*)out, t, g, (size_t)smem, s));
}
