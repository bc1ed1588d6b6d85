// Int8 1x1 convolution for Hopper (sm_90a), the activation quantize fused
// into the load: the "pointwise" and "dot" routes of
// ops/kernels/int8_conv.py::int8_conv_plan.
//
// Replaces, for the 1x1 convs (stride 1, no padding), the int8 branch of
// autoware_vision_pilot_tpu/nn/layers.py::Conv2d (:81-113), which XLA runs
// with its static-scale quantize fused into the producer (:84-87), and
// PR 2's mma.sync route with its separate quantize kernel (int8_conv.cu),
// which took them before. A 1x1 conv of NHWC tensors is the product of the
// (M = pixels, K = C) activation and the (N, K) weights:
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
// the launch itself, and (on PR 2's route) a quantize launch before each.
//
// "pointwise" (M > 8): mma.sync.m16n8k32 s8 on 64x64 or 32x64 output tiles
// (the plan's choice), eight warps a block, K in steps of 64 channels
// through a 4-stage cp.async ring. A float activation lands raw in the
// ring and is quantized from there into an int8 tile that the warps' mma
// fragments read; the reciprocals of the step's 64 scales land beside it.
// An int8 activation is read from the ring as it is. To fill the SMs
// without a second launch, the blocks of a thread-block cluster (up to 8)
// take one output tile and split K into contiguous ranges; each
// accumulates its range in int32, the others leave their partial tiles in
// their shared memory, and after a cluster barrier each rank adds up a
// share of the tile's fragments over all ranks through distributed shared
// memory (cluster.map_shared_rank) and runs their epilogue; a second
// barrier keeps every rank's shared memory until all have read it. No
// workspace, no memset, no arrival counter, and one launch; int32 sums are
// exact in any order, so the result is bit-equal to one block's.
//
// "dot" (M <= 8 and M * C <= 32 KB, the SE convs' M = 1): the block
// quantizes the M x C activation once into shared memory; then one warp
// per output channel, each lane walking K in 16-byte chunks of the weight
// row and summing with __dp4a; a warp shuffle adds the lanes, and lane 0
// runs the epilogue. Bound by the weight bytes and by the launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_common.cuh"

namespace cg = cooperative_groups;

namespace {

using avp::cp_async16;
using avp::cp_async_commit;
using avp::cp_async_wait;
using avp::lds32;
using avp::MAX_DEVICES;
using avp::mma_s8;

// ----------------------------------------------------------------- pointwise

constexpr int BK = 64;         // channels per K step
constexpr int BN = 64;         // output channels per tile
constexpr int LDS = BK + 16;   // int8 tile pitch: 20 words, so the 8x4
                               // fragment loads of a warp hit 32 banks
constexpr int STAGES = 4;
constexpr int THREADS = 256;   // 2 x 4 warps
constexpr int MAX_CLUSTER = 8; // the portable cluster size

// Bytes of one activation row of a ring stage: an int8 row has the mma
// tile's pitch, a float row is BK values.
template <typename T>
__host__ __device__ constexpr int raw_pitch() { return sizeof(T) == 1 ? LDS : BK * (int)sizeof(T); }

template <typename T, int BM>
__host__ __device__ constexpr int stage_bytes() { return BM * raw_pitch<T>() + BN * LDS + BK * 8; }

template <typename T, int BM>
__host__ __device__ constexpr int pointwise_smem() {
  return STAGES * stage_bytes<T, BM>() + (sizeof(T) == 1 ? 0 : BM * LDS);
}

struct PwArgs {
  const void* x;          // (M, C) int8, bf16 or f32
  const double* rcp;      // RN64(1 / scale): one, or C (per_channel)
  const signed char* w;   // (N, C) int8
  avp::Epilogue e;        // out (M, N)
  int M, C, N, per_channel, k_per_rank, cs;
};

// 8 values of a float row in shared memory -> f32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = avp::bf16_lo(w[i]);
    v[2 * i + 1] = avp::bf16_hi(w[i]);
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// The same from global memory, through the read-only cache.
__device__ __forceinline__ void load8_global(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// One block: a BM x BN output tile and the K range [k_begin, k_end) of its
// rank in the cluster (blockIdx.x = m tile * cs + rank, blockIdx.y = n tile).
template <typename T, int BM, int OUT_KIND>
__global__ void __launch_bounds__(THREADS) int8_pointwise_kernel(const PwArgs a) {
  constexpr bool QUANT = sizeof(T) != 1;
  constexpr int WM = BM / 2, WN = BN / 4;
  constexpr int MI = WM / 16, NJ = WN / 8;
  constexpr int RP = raw_pitch<T>();
  constexpr int EPC = 16 / sizeof(T);     // values in a 16-byte chunk
  constexpr int A_CPR = BK / EPC;         // chunks of an activation row
  constexpr int B_CPR = BK / 16;          // chunks of a weight row
  constexpr int A_STAGE = BM * RP, B_STAGE = BN * LDS;
  constexpr int STAGE = stage_bytes<T, BM>();
  constexpr int UPR = BK / 8;             // 8-channel units of a row
  static_assert(MI * NJ * 4 * THREADS * 4 <= STAGES * STAGE, "partial tile vs ring");

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* tile = smem + STAGES * STAGE;  // the quantized A (QUANT)

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp % 2) * WM, wn = (warp / 2) * WN;
  const int m0 = (blockIdx.x / a.cs) * BM, n0 = blockIdx.y * BN;
  static_assert(THREADS == 2 * 4 * 32, "the warps tile the block 2 x 4");
  const int k_begin = rank * a.k_per_rank;
  const int k_end = min(a.C, k_begin + a.k_per_rank);
  const int steps = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  const T* x = static_cast<const T*>(a.x);

  // Chunks at or past k_end read as zeros on both sides, so a K step that
  // crosses the end of the range adds nothing there.
  auto load_stage = [&](int step, int stage) {
    unsigned char* as = smem + stage * STAGE;
    unsigned char* bs = as + A_STAGE;
    double* rs = reinterpret_cast<double*>(bs + B_STAGE);
    const int k0 = k_begin + step * BK;
    for (int c = tid; c < BM * A_CPR; c += THREADS) {
      const int r = c / A_CPR, j = c % A_CPR;
      const int m = m0 + r, k = k0 + j * EPC;
      const bool ok = m < a.M && k < k_end;
      cp_async16(as + r * RP + j * 16, ok ? x + (long long)m * a.C + k : x, ok);
    }
    for (int c = tid; c < BN * B_CPR; c += THREADS) {
      const int r = c / B_CPR, j = c % B_CPR;
      const int n = n0 + r, k = k0 + j * 16;
      const bool ok = n < a.N && k < k_end;
      cp_async16(bs + r * LDS + j * 16, ok ? a.w + (long long)n * a.C + k : a.w, ok);
    }
    if (QUANT && a.per_channel && tid < BK / 2) {
      const int k = k0 + tid * 2;
      const bool ok = k < k_end;
      cp_async16(rs + tid * 2, ok ? a.rcp + k : a.rcp, ok);
    }
  };

  // The stage's float activation -> the int8 tile; thread tid takes the
  // 8 channels (tid % UPR) * 8 of rows tid / UPR, + THREADS / UPR, ...
  const double r0 = QUANT && !a.per_channel ? __ldg(a.rcp) : 0.0;
  auto quantize_stage = [&](int stage) {
    if constexpr (QUANT) {
      const unsigned char* as = smem + stage * STAGE;
      const double* rs = reinterpret_cast<const double*>(as + A_STAGE + B_STAGE);
      const int u = tid % UPR;
      double r[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) r[i] = a.per_channel ? rs[u * 8 + i] : r0;
#pragma unroll
      for (int row = tid / UPR; row < BM; row += THREADS / UPR) {
        float v[8];
        load8(reinterpret_cast<const T*>(as + row * RP) + u * 8, v);
        *reinterpret_cast<uint2*>(tile + row * LDS + u * 8) =
            make_uint2(avp::quantize4_rcp(v, r), avp::quantize4_rcp(v + 4, r + 4));
      }
    }
  };

  int acc[MI][NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_stage(s, s);
    cp_async_commit();
  }
  // The epilogue's factors of this thread's 2 * NJ columns, read while the
  // first stages load.
  avp::Epilogue e = a.e;
  e.out_kind = OUT_KIND;
  avp::Column col[NJ][2];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int n = n0 + wn + j * 8 + t * 2 + c;
      col[j][c] = OUT_KIND != 2 && n < a.N ? avp::column(e, n) : avp::Column{0.f, 0.f};
    }

  for (int kt = 0; kt < steps; ++kt) {
    cp_async_wait<STAGES - 2>();  // step kt has landed (this thread's part)
    __syncthreads();              // ... everyone's; step kt-1 is done with
    if (kt + STAGES - 1 < steps) load_stage(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();

    const unsigned char* stage = smem + (kt % STAGES) * STAGE;
    const unsigned char* as = stage;
    if constexpr (QUANT) {
      quantize_stage(kt % STAGES);
      __syncthreads();
      as = tile;
    }
    const unsigned char* bs = stage + A_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[MI][4], bf[NJ][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const unsigned char* p = as + (wm + i * 16 + g) * LDS + kk + t * 4;
        af[i][0] = lds32(p);
        af[i][1] = lds32(p + 8 * LDS);
        af[i][2] = lds32(p + 16);
        af[i][3] = lds32(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const unsigned char* p = bs + (wn + j * 8 + g) * LDS + kk + t * 4;
        bf[j][0] = lds32(p);
        bf[j][1] = lds32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
  }
  cp_async_wait<0>();

  auto store = [&](int i, int j, const int (&v)[4]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + i * 16 + g + h * 8;
      const int n = n0 + wn + j * 8 + t * 2;
      if (m < a.M) avp::store_pair(e, m, n, col[j][0], col[j][1], v[2 * h], v[2 * h + 1]);
    }
  };
  if (a.cs == 1) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) store(i, j, acc[i][j]);
    return;
  }
  // Every rank leaves its partial tile in its shared memory, laid out
  // [fragment][thread] as int4, so that thread tid of any rank reads what
  // thread tid of every rank held. Rank r then finishes the fragments f
  // with f % cs == r: their sum over the ranks, and the epilogue.
  __syncthreads();  // the ring is free
  int4* part = reinterpret_cast<int4*>(smem);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      part[(i * NJ + j) * THREADS + tid] =
          make_int4(acc[i][j][0], acc[i][j][1], acc[i][j][2], acc[i][j][3]);
  cluster.sync();  // the partial tiles are written (release / acquire)
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if ((i * NJ + j) % a.cs != rank) continue;
      int v[4] = {0, 0, 0, 0};
      for (int q = 0; q < a.cs; ++q) {
        const int4 p = cluster.map_shared_rank(part, q)[(i * NJ + j) * THREADS + tid];
        v[0] += p.x;
        v[1] += p.y;
        v[2] += p.z;
        v[3] += p.w;
      }
      store(i, j, v);
    }
  cluster.sync();  // no rank exits while another still reads its tile
}

// The dynamic shared-memory limit is set once per kernel and device.
template <typename T, int BM, int OUT_KIND>
cudaError_t launch_pointwise(const PwArgs& a, int m_tiles, int n_tiles,
                             cudaStream_t stream) {
  constexpr int smem = pointwise_smem<T, BM>();
  static bool ready[MAX_DEVICES] = {false};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES || !ready[dev]) {
    err = cudaFuncSetAttribute(int8_pointwise_kernel<T, BM, OUT_KIND>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (dev >= 0 && dev < MAX_DEVICES) ready[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)m_tiles * (unsigned)a.cs, (unsigned)n_tiles, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = (unsigned)a.cs;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, int8_pointwise_kernel<T, BM, OUT_KIND>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int BM>
cudaError_t pointwise_out(const PwArgs& a, int m_tiles, int n_tiles, cudaStream_t s) {
  if (a.e.out_kind == 0) return launch_pointwise<T, BM, 0>(a, m_tiles, n_tiles, s);
  if (a.e.out_kind == 1) return launch_pointwise<T, BM, 1>(a, m_tiles, n_tiles, s);
  return launch_pointwise<T, BM, 2>(a, m_tiles, n_tiles, s);
}

template <typename T>
cudaError_t pointwise_bm(const PwArgs& a, int bm, int m_tiles, int n_tiles,
                         cudaStream_t s) {
  if (bm == 64) return pointwise_out<T, 64>(a, m_tiles, n_tiles, s);
  return pointwise_out<T, 32>(a, m_tiles, n_tiles, s);
}

// ----------------------------------------------------------------------- dot

constexpr int DOT_WARPS = 8;   // output channels a block
constexpr int DOT_MAX_M = 8;
constexpr int DOT_MAX_BYTES = 32 * 1024;  // the M x C int8 activation, in shared memory

struct DotArgs {
  const void* x;          // (M, C) int8, bf16 or f32
  const double* rcp;      // RN64(1 / scale): one, or C (per_channel)
  const signed char* w;   // (N, C) int8
  avp::Epilogue e;        // out (M, N)
  int M, C, N, per_channel;
};

// The 8 values at p as two words of int8: quantized with the reciprocals
// r, or copied.
__device__ __forceinline__ uint2 quantized8(const signed char* p, const double*) {
  return __ldg(reinterpret_cast<const uint2*>(p));
}

__device__ __forceinline__ uint2 quantized8(const __nv_bfloat16* p, const double* r) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  float v[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = avp::bf16_lo(w[i]);
    v[2 * i + 1] = avp::bf16_hi(w[i]);
  }
  return make_uint2(avp::quantize4_rcp(v, r), avp::quantize4_rcp(v + 4, r + 4));
}

__device__ __forceinline__ uint2 quantized8(const float* p, const double* r) {
  float v[8];
  load8_global(p, v);
  return make_uint2(avp::quantize4_rcp(v, r), avp::quantize4_rcp(v + 4, r + 4));
}

// The block first quantizes (or copies) the whole M x C activation into
// shared memory, 8 values a thread at a time, so that it is quantized once
// a block and not once a warp; then warp w takes output channel
// blockIdx.x * DOT_WARPS + w.
template <typename T, int OUT_KIND>
__global__ void __launch_bounds__(DOT_WARPS * 32) int8_dot_kernel(const DotArgs a) {
  extern __shared__ __align__(16) unsigned char xs[];  // (M, C) int8
  const int tid = threadIdx.x, lane = tid % 32;
  const int n = blockIdx.x * DOT_WARPS + tid / 32;
  const T* x = static_cast<const T*>(a.x);
  avp::Epilogue e = a.e;
  e.out_kind = OUT_KIND;
  // the epilogue's factors of column n, read while the activation loads
  const avp::Column col =
      OUT_KIND != 2 && n < a.N ? avp::column(e, n) : avp::Column{0.f, 0.f};

  const double r0 = sizeof(T) != 1 && !a.per_channel ? __ldg(a.rcp) : 0.0;
  const int groups = a.M * a.C / 8;
  for (int c = tid; c < groups; c += blockDim.x) {
    const int k = (c * 8) % a.C;
    double r[8];
    if (sizeof(T) != 1 && a.per_channel) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const double2 d = __ldg(reinterpret_cast<const double2*>(a.rcp + k) + i);
        r[2 * i] = d.x;
        r[2 * i + 1] = d.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) r[i] = r0;
    }
    *reinterpret_cast<uint2*>(xs + c * 8) = quantized8(x + (long long)c * 8, r);
  }
  __syncthreads();
  if (n >= a.N) return;

  const signed char* wrow = a.w + (long long)n * a.C;
  int acc[DOT_MAX_M];
#pragma unroll
  for (int m = 0; m < DOT_MAX_M; ++m) acc[m] = 0;
#pragma unroll 2
  for (int k = lane * 16; k < a.C; k += 32 * 16) {
    const uint4 wv = __ldg(reinterpret_cast<const uint4*>(wrow + k));
#pragma unroll
    for (int m = 0; m < DOT_MAX_M; ++m) {
      if (m < a.M) {
        const uint4 q = *reinterpret_cast<const uint4*>(xs + m * a.C + k);
        acc[m] = __dp4a((int)q.x, (int)wv.x, acc[m]);
        acc[m] = __dp4a((int)q.y, (int)wv.y, acc[m]);
        acc[m] = __dp4a((int)q.z, (int)wv.z, acc[m]);
        acc[m] = __dp4a((int)q.w, (int)wv.w, acc[m]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < DOT_MAX_M; ++m) {
    if (m < a.M) {
      int v = acc[m];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) avp::store_out(e, m, n, col, v);
    }
  }
}

template <typename T>
cudaError_t launch_dot(const DotArgs& a, cudaStream_t s) {
  const unsigned blocks = (unsigned)((a.N + DOT_WARPS - 1) / DOT_WARPS);
  const size_t smem = (size_t)a.M * a.C;
  if (a.e.out_kind == 0) int8_dot_kernel<T, 0><<<blocks, DOT_WARPS * 32, smem, s>>>(a);
  else if (a.e.out_kind == 1) int8_dot_kernel<T, 1><<<blocks, DOT_WARPS * 32, smem, s>>>(a);
  else int8_dot_kernel<T, 2><<<blocks, DOT_WARPS * 32, smem, s>>>(a);
  return cudaGetLastError();
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

bool bad_common(const void* x, int in_kind, const void* rcp, int per_channel,
                const void* w, int M, int C, int N, int out_kind) {
  return M <= 0 || C <= 0 || C % 16 || N <= 0 || in_kind < 0 || in_kind > 2 ||
         out_kind < 0 || out_kind > 2 || (uintptr_t)x % 16 || (uintptr_t)w % 16 ||
         (in_kind != 0 && (rcp == nullptr || (per_channel && (uintptr_t)rcp % 16)));
}

}  // namespace

// The pointwise route on `stream`; returns cudaGetLastError() (0 on
// success). x: (M, C) NHWC pixels of int8 (in_kind 0), bf16 (1) or f32
// (2), 16-byte aligned, C a multiple of 16; scale: the f32 scale x is
// (or was) quantized with, C values if per_channel, else one, which the
// epilogue then multiplies into w_scale; rcp: for a float x, 1 / scale in
// f64 (correctly rounded), as many values, 16-byte aligned; for an int8 x,
// unused; w: (N, C) int8, 16-byte aligned;
// w_scale: (N,) f32; bias: (N,) of the output type, or null; out: (M, N)
// f32 (out_kind 0), bf16 (1) or the int32 accumulators (2). The plan's
// numbers: bm (64 or 32), the m and n tiles (64 output channels each), the
// cluster size cs (1-8) and the channels of K each rank takes, a multiple
// of 16 (the last rank takes the rest).
extern "C" int avp_int8_conv_pointwise(const void* x, int in_kind, const void* scale,
                                       const void* rcp, int per_channel, const void* w,
                                       const void* w_scale, const void* bias,
                                       void* out, int M, int C, int N, int out_kind,
                                       int bm, int m_tiles, int n_tiles, int cs,
                                       int k_per_rank, void* stream) {
  if (bad_common(x, in_kind, rcp, per_channel, w, M, C, N, out_kind) ||
      (bm != 64 && bm != 32) ||
      cs < 1 || cs > MAX_CLUSTER || k_per_rank <= 0 || k_per_rank % 16 ||
      (long long)k_per_rank * cs < C || (long long)k_per_rank * (cs - 1) >= C ||
      m_tiles <= 0 || n_tiles <= 0 || n_tiles > 65535 ||
      (long long)m_tiles * bm < M || (long long)(m_tiles - 1) * bm >= M ||
      (long long)n_tiles * BN < N || (long long)m_tiles * cs > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  PwArgs a;
  a.x = x;
  a.rcp = (const double*)rcp;
  a.w = (const signed char*)w;
  a.e = epilogue(scale, per_channel, w_scale, bias, out, N, out_kind);
  a.M = M; a.C = C; a.N = N;
  a.per_channel = per_channel;
  a.k_per_rank = k_per_rank;
  a.cs = cs;
  cudaStream_t s = (cudaStream_t)stream;
  if (in_kind == 0) return (int)pointwise_bm<signed char>(a, bm, m_tiles, n_tiles, s);
  if (in_kind == 1) return (int)pointwise_bm<__nv_bfloat16>(a, bm, m_tiles, n_tiles, s);
  return (int)pointwise_bm<float>(a, bm, m_tiles, n_tiles, s);
}

// The dot route on `stream`, for M <= 8 rows and M * C <= 32 KB;
// arguments as avp_int8_conv_pointwise's.
extern "C" int avp_int8_conv_dot(const void* x, int in_kind, const void* scale,
                                 const void* rcp, int per_channel, const void* w,
                                 const void* w_scale,
                                 const void* bias, void* out, int M, int C, int N,
                                 int out_kind, void* stream) {
  if (bad_common(x, in_kind, rcp, per_channel, w, M, C, N, out_kind) || M > DOT_MAX_M ||
      (long long)M * C > DOT_MAX_BYTES)
    return (int)cudaErrorInvalidValue;
  DotArgs a;
  a.x = x;
  a.rcp = (const double*)rcp;
  a.w = (const signed char*)w;
  a.e = epilogue(scale, per_channel, w_scale, bias, out, N, out_kind);
  a.M = M; a.C = C; a.N = N;
  a.per_channel = per_channel;
  cudaStream_t s = (cudaStream_t)stream;
  if (in_kind == 0) return (int)launch_dot<signed char>(a, s);
  if (in_kind == 1) return (int)launch_dot<__nv_bfloat16>(a, s);
  return (int)launch_dot<float>(a, s);
}
