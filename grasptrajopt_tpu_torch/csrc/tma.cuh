// Helpers shared by K1 (min_d2.cu) and K2 / K3 (nearest.cu): 1-D TMA bulk
// copies counted on shared-memory mbarriers, the exact-fp32 squared
// distance of one (query, point) pair, and the launch of a grid of
// thread-block clusters with its residency check.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace gto {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// one contiguous span global -> shared, counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// |q - r.xyz|^2 + r.w in 7 FP32 instructions with the min that follows:
// three subtracts and three fused multiply-adds, the penalty the first
// one's addend. The intrinsics pin each rounding, so every call site
// computes the same bits for the same pair (K2 / K3 compare a rescan's
// values with the walk's for equality).
__device__ __forceinline__ float pair_d2(float qx, float qy, float qz, float4 r) {
  const float dx = __fsub_rn(qx, r.x);
  const float dy = __fsub_rn(qy, r.y);
  const float dz = __fsub_rn(qz, r.z);
  return __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmaf_rn(dx, dx, r.w)));
}

// the error of a host call, with the runtime's last-error state cleared so
// that no later launch reports it
inline int finish(cudaError_t err) {
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

// A launch of `tiles` query tiles x B sets, each tile a cluster of `split`
// blocks of `threads` threads along x, with `smem` bytes of dynamic shared
// memory a block.
inline cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int tiles, int B, int threads, int split,
                                         size_t smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * split), (unsigned)B, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Whether a cluster of cfg's shape can be resident on the current device
// (cudaOccupancyMaxActiveClusters), asked once per kernel, device, block
// size, cluster size and shared memory: the query costs more host time
// than a small launch.
template <typename Kernel>
cudaError_t check_clusters(Kernel kernel, const cudaLaunchConfig_t& cfg) {
  struct Checked { const void* fn; int device, threads, split; size_t smem; cudaError_t err; };
  static Checked seen[64];
  static int n_seen = 0;
  static std::mutex lock;
  const std::lock_guard<std::mutex> guard(lock);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const int threads = (int)cfg.blockDim.x, split = (int)cfg.attrs[0].val.clusterDim.x;
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].fn == (const void*)kernel && seen[i].device == device && seen[i].threads == threads &&
        seen[i].split == split && seen[i].smem == cfg.dynamicSmemBytes)
      return seen[i].err;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err == cudaSuccess && clusters < 1) err = cudaErrorInvalidConfiguration;
  if (n_seen < 64) seen[n_seen++] = {(const void*)kernel, device, threads, split, cfg.dynamicSmemBytes, err};
  return err;
}

}  // namespace gto
