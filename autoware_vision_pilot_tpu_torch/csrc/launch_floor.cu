// An empty kernel, for the launch floor: the profiler device time of a
// launch that does nothing, which no kernel of the same launch shape can go
// below. chip_smoke.py prints it beside the lane-filter walk and NMS
// kernels (one block of 32 threads, the walk's cluster of 8 blocks of 1024,
// the NMS kernel's of 8 blocks of 512).

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

// Launches `blocks` blocks of `threads` threads in clusters of `cluster`
// (1-8) on `stream`; returns the launch's error, or cudaGetLastError().
extern "C" int avp_launch_floor(int blocks, int threads, int cluster, void* stream) {
  if (blocks < 1 || threads < 1 || cluster < 1 || cluster > 8 || blocks % cluster)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, empty_kernel);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
