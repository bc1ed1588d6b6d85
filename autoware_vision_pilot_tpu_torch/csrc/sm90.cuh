// The Hopper (sm_90a) building blocks that int8_conv_sm90.cu,
// int8_conv_halo.cu and int8_pointwise.cu share: shared-memory addresses,
// mbarriers, TMA tile loads and stores and the host's encoding of their
// tensor maps, a stage clock for stamped builds, and int8 wgmma with its
// shared-memory descriptors (K-major: 128-byte swizzle, the layout a TMA
// load with CU_TENSOR_MAP_SWIZZLE_128B writes, or none), and the weights'
// maps, encoded once per (address, shape, box) for the process.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is found at run time
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "map_cache.hpp"

namespace avp {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Waits for the phase; a wait of more than 10 s (a TMA copy that never
// lands) traps, so a fault ends the launch with an error, not a hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (global_ns() - t0 > 10000000000ull) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// Brings a tensor map (a kernel parameter) into the TMA unit's cache
// before its first load.
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// A tile from shared memory (`src`, laid out as the map's box) to the
// tensor of a 5-D map at the given coordinates, as one bulk-group copy;
// coordinates outside the tensor are not written.
__device__ __forceinline__ void tma_store_5d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5, %6}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// Closes this thread's bulk copies issued so far into one bulk group.
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's bulk groups still read their
// shared-memory source (the source may then be written again).
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Waits until at most N of this thread's bulk groups are still in flight
// (their writes to global memory done).
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// A stage split for chip_smoke.py's builds with -DAVP_*_STAMPS (never
// kernels/build.py's): one thread of each block adds up the SM clocks it
// spends in each of up to 5 stages and writes them, with the block's first
// and last %globaltimer and its clocks in all, as 8 words a block at
// out[8 * blockIdx.x].
struct StageClock {
  unsigned long long g0;
  long long c0, t, c[5];
  __device__ __forceinline__ void start() {
    g0 = global_ns();
    c0 = t = clock64();
#pragma unroll
    for (int i = 0; i < 5; ++i) c[i] = 0;
  }
  __device__ __forceinline__ void lap(int i) {
    const long long now = clock64();
    c[i] += now - t;
    t = now;
  }
  __device__ __forceinline__ void write(unsigned long long* out) {
    if (!out) return;
    unsigned long long* o = out + 8 * blockIdx.x;
    o[0] = g0;
    o[1] = global_ns();
    o[2] = (unsigned long long)(clock64() - c0);
#pragma unroll
    for (int i = 0; i < 5; ++i) o[3 + i] = (unsigned long long)c[i];
  }
};

// The same clock where a build has no stamps: nothing.
struct NoClock {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void lap(int) {}
  __device__ __forceinline__ void write(unsigned long long*) {}
};

// The same shared-memory offset in block `rank` of the cluster.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// Orders this thread's generic-proxy writes to shared memory before the
// bulk (async-proxy) copies that read or reduce into it.
__device__ __forceinline__ void fence_proxy_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// dst[i] += src[i] for `bytes` / 4 int32 values, src in this block's
// shared memory, dst (and its mbarrier, which the bytes complete) in a
// block of the cluster (addresses from map_rank); bytes a multiple of 16,
// both 16-byte aligned. The bulk-copy engine runs it asynchronously.
__device__ __forceinline__ void bulk_reduce_add_s32(uint32_t dst, uint32_t src, uint32_t bytes,
                                                    uint32_t bar) {
  asm volatile(
      "cp.reduce.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes.add.s32 "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Shared-memory matrix descriptor: K-major, 128-byte swizzle, rows of 128
// bytes in groups of 8 (1024 bytes apart). The tile base is 1024-aligned;
// a step of 32 bytes along K adds 2 to the address field, and one of 64
// rows adds 512.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;            // leading byte offset (unused: swizzled K-major)
  d |= (uint64_t)(1024 >> 4) << 32;  // stride byte offset: 8 rows
  d |= (uint64_t)1 << 62;            // 128-byte swizzle
  return d;
}

// Shared-memory matrix descriptor without swizzle: K-major core matrices of
// 8 rows x 16 bytes (128 contiguous bytes), `lbo` bytes from one to the
// next along K and `sbo` bytes from one to the next 8 rows; the start
// address needs 16-byte alignment alone.
__device__ __forceinline__ uint64_t smem_desc_plain(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  return d;  // layout type 0: no swizzle
}

// Keeps the compiler from moving reads or writes of the registers across
// the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// D(64x128 s32) += A(64x32 s8) * B(32x128 s8), A and B from shared memory.
// Accumulator layout (warp w of the warpgroup, lane = 4g + t): d[4p + 2h +
// e] is row 16w + g + 8h, column 8p + 2t + e.
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
      "%61, %62, %63}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]),
        "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
        "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]),
        "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]),
        "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]),
        "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// D(64x64 s32) += A(64x32 s8) * B(32x64 s8), A from registers: warp w of
// the warpgroup holds rows 16w..16w+15 as mma.sync's m16n8k32 A fragment
// (lane = 4g + t): a[0] = A[g][4t..4t+3], a[1] = A[g+8][4t..], a[2] =
// A[g][16+4t..], a[3] = A[g+8][16+4t..], the lowest k in the low byte.
// Accumulators as wgmma_m64n128k32's.
__device__ __forceinline__ void wgmma_m64n64k32_rs(int (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31}, {%32, %33, %34, %35}, %36, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]),
        "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
        "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]),
        "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64xN s32) += A(64x32 s8) * B(32xN s8) for N = 8, 16, 24, 32, 48 or 64,
// A and B from shared memory (descriptors), accumulators as
// wgmma_m64n128k32's: d[4p + 2h + e] is row 16w + g + 8h, column 8p + 2t +
// e, N / 2 registers.
template <int N>
__device__ __forceinline__ void wgmma_ss(int (&d)[N / 2], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<8>(int (&d)[4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
      "{%0, %1, %2, %3}, %4, %5, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<16>(int (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<24>(int (&d)[12], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, %12, %13, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(int (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<48>(int (&d)[24], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23}, %24, %25, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// ------------------------------------------------------------------- host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

constexpr int ENCODE_FAILED = 100000;  // + the CUresult

// A map of `rank` (2 to 5) dims, innermost first, of elements of `type`,
// with the byte strides of dims 1.. in `strides`, boxes `box` and
// `swizzle`, zeros outside the tensor (a load) or nothing written there (a
// store). `elem_strides` (1 by default) are the traversal strides: a load
// takes every elem_strides[i]-th element of box[i], ceil(box[i] /
// elem_strides[i]) of them, packed. Returns 0 or ENCODE_FAILED + the
// CUresult.
inline int encode_map(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* ptr,
                      const uint64_t* dims, const uint64_t* strides, const uint32_t* box,
                      CUtensorMapSwizzle swizzle, const uint32_t* elem_strides = nullptr) {
  const EncodeTiled fn = encoder();
  if (!fn) return ENCODE_FAILED + (int)CUDA_ERROR_NOT_FOUND;
  cuuint64_t gdim[5], gstride[4];
  cuuint32_t bdim[5], estride[5];
  for (int i = 0; i < rank; ++i) {
    gdim[i] = dims[i];
    bdim[i] = box[i];
    estride[i] = elem_strides ? elem_strides[i] : 1;
    if (i + 1 < rank) gstride[i] = strides[i];
  }
  const CUresult r = fn(map, type, (cuuint32_t)rank, const_cast<void*>(ptr), gdim, gstride,
                        bdim, estride, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_FAILED + (int)r;
}

// A map of `rank` (2 to 5) dims, innermost first, of elements of `type` and
// `elem` bytes with dense strides, `swizzle` (128-byte by default), zeros
// outside the tensor. Returns 0 or ENCODE_FAILED + the CUresult.
inline int encode(CUtensorMap* map, CUtensorMapDataType type, int elem, int rank,
                  const void* ptr, const uint64_t* dims, const uint32_t* box,
                  CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  uint64_t strides[4];
  uint64_t bytes = (uint64_t)elem;
  for (int i = 0; i + 1 < rank; ++i) strides[i] = bytes *= dims[i];
  return encode_map(map, type, rank, ptr, dims, strides, box, swizzle);
}

// The map of (N, KH, KW, C) int8 weights in boxes of 128 channels x
// box_n output channels (one tap).
inline int encode_weights(CUtensorMap* map, const void* w, int N, int KH, int KW, int C,
                          int box_n) {
  const uint64_t dims[4] = {(uint64_t)C, (uint64_t)KW, (uint64_t)KH, (uint64_t)N};
  const uint32_t box[4] = {128u, 1u, 1u, (uint32_t)box_n};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 4, w, dims, box);
}

// The process's weight maps (map_cache.hpp).
inline MapCache<CUtensorMap>& weight_maps() {
  static MapCache<CUtensorMap> maps;
  return maps;
}

// encode_weights' map of (N, KH, KW, C) int8 weights with box_n output
// channels a box, encoded at the first launch and kept for the process.
inline int weight_map(CUtensorMap* map, const void* w, int N, int KH, int KW, int C, int box_n) {
  return weight_maps().get(map, {0, (long long)(uintptr_t)w, N, KH, KW, C, box_n},
                           [&](CUtensorMap* m) { return encode_weights(m, w, N, KH, KW, C, box_n); });
}

}  // namespace sm90
}  // namespace avp
