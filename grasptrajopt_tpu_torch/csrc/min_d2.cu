// K1: batched exact-fp32 minimum squared distance, the dense SDF field build.
//
//   out[b, m] = max(0, min_n (|q[b, m] - r[b, n]|^2 + pen[b, n]))
//
// Replaces grasptrajopt_tpu/ops/nn.py:_min_d2_bcast_kernel (launched by
// min_d2_batched_pallas). The queries are either one set shared by every
// batch entry (q_batch_stride = 0: the workspace grid against B scene
// clouds) or one set per entry (q_batch_stride = 3 * M: the grasp
// pre-filter). The reference set is (B, N, 4) float32 rows x / y / z /
// penalty, 16 bytes a point; the penalty is 0 for a valid point and 3e38
// for an invalid one.
//
// What bounds it on the card: FP32 issue. A (query, point) pair needs 7
// instructions: three subtracts, fma(dx, dx, pen), fma(dy, dy, acc),
// fma(dz, dz, acc) and the min. The tensor cores could only take the
// |q|^2 + |r|^2 - 2 q.r expansion, which cancels catastrophically near the
// surface and is ruled out.
//
// What the design does about it:
// - A block takes tile_m = blockDim.x * QPT queries (the launcher picks
//   tile_m); each thread keeps QPT queries and their running minima in
//   registers, so one 16-byte shared-memory broadcast feeds QPT pairs.
//   QPT is 2, not more: at the pipeline's B = 1 launches the card runs
//   short of warps before it runs short of issue slots, and 4 or 8
//   queries a thread measured slower there.
// - The N points are split over a thread-block cluster of S blocks (S in
//   1, 2, 4, 8), each walking a contiguous share of the cloud, cut to the
//   point so that the shares are equal. At the pipeline's B = 1 launches
//   the query tiles alone give fewer blocks than the card holds; the
//   split multiplies them.
// - A share's tiles stream in through a ring of STAGES shared buffers: one
//   thread issues a 1-D TMA bulk copy per tile (one contiguous span of
//   float4 rows) whose completion an mbarrier counts, so the next tiles
//   are in flight while the current one is consumed.
// - The S partial minima meet through distributed shared memory: each
//   block stores its minima, cluster.sync(), each rank reduces
//   tile_m / S of the queries over all S blocks' shared memory, clamps
//   and writes them; a second cluster.sync() keeps every block's shared
//   memory alive until the others have read it. One launch, no atomics,
//   no scratch tensor. The min is exact and order-free, so the output is
//   bit-identical for every S.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace cg = cooperative_groups;
using gto::bulk_load;
using gto::finish;
using gto::mbar_init;
using gto::mbar_wait;
using gto::pair_d2;

namespace {

constexpr int QPT = 2;                       // queries per thread
// The launch bound. The launch plan uses 64 or 128 threads, but under a
// 128-thread bound nvcc allocates 50 registers instead of 32 and the
// kernel runs slower at the pipeline's B = 1 shapes.
constexpr int MAX_THREADS = 256;
constexpr int MAX_TILE_M = MAX_THREADS * QPT;  // 512 queries a block at most
constexpr int TILE_N = 512;                  // points a tile: 8 KB of float4 rows
constexpr int STAGES = 3;
constexpr int UNROLL = 4;                    // points an inner iteration

__global__ void __launch_bounds__(MAX_THREADS)
min_d2_kernel(const float* __restrict__ q, long long q_batch_stride,
              const float4* __restrict__ r4, float* __restrict__ out, int M, int N) {
  __shared__ alignas(128) float4 tile[STAGES][TILE_N];
  __shared__ alignas(8) uint64_t full[STAGES];
  __shared__ float part[MAX_TILE_M];

  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int threads = blockDim.x;
  const int tile_m = threads * QPT;
  const int b = blockIdx.y;
  const int m_tile = (blockIdx.x / S) * tile_m;
  const float* qb = q + (long long)b * q_batch_stride;
  const float4* rb = r4 + (long long)b * N;

  // this block's share of the cloud: points [p0, p1), cut to the point
  // (a row is 16 bytes, so every share starts aligned), walked in tiles
  const int p0 = (int)((long long)N * rank / S);
  const int p1 = (int)((long long)N * (rank + 1) / S);
  const int nt = (p1 - p0 + TILE_N - 1) / TILE_N;

  auto issue = [&](int i) {  // tile i of the share into stage i % STAGES
    const int n0 = p0 + i * TILE_N;
    const int count = min(TILE_N, p1 - n0);
    bulk_load(tile[i % STAGES], rb + n0, (uint32_t)count * sizeof(float4), &full[i % STAGES]);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < STAGES && i < nt; ++i) issue(i);
  }

  float qx[QPT], qy[QPT], qz[QPT], best[QPT];
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int m = m_tile + threadIdx.x + k * threads;
    const bool in = m < M;
    qx[k] = in ? qb[3 * (long long)m + 0] : 0.f;
    qy[k] = in ? qb[3 * (long long)m + 1] : 0.f;
    qz[k] = in ? qb[3 * (long long)m + 2] : 0.f;
    best[k] = __int_as_float(0x7f800000);  // +inf
  }
  __syncthreads();  // the barriers are initialised

  for (int i = 0; i < nt; ++i) {
    const int stage = i % STAGES;
    mbar_wait(&full[stage], (uint32_t)(i / STAGES) & 1u);
    const float4* tp = tile[stage];
    const int count = min(TILE_N, p1 - (p0 + i * TILE_N));
    int j = 0;
    for (; j + UNROLL <= count; j += UNROLL) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const float4 r = tp[j + u];
#pragma unroll
        for (int k = 0; k < QPT; ++k) best[k] = fminf(best[k], pair_d2(qx[k], qy[k], qz[k], r));
      }
    }
    for (; j < count; ++j) {
      const float4 r = tp[j];
#pragma unroll
      for (int k = 0; k < QPT; ++k) best[k] = fminf(best[k], pair_d2(qx[k], qy[k], qz[k], r));
    }
    __syncthreads();  // every thread is done with this stage
    if (threadIdx.x == 0 && i + STAGES < nt) issue(i + STAGES);
  }

  // combine the S partial minima over distributed shared memory
#pragma unroll
  for (int k = 0; k < QPT; ++k) part[threadIdx.x + k * threads] = best[k];
  cluster.sync();
  const int per_rank = (tile_m + S - 1) / S;
  float* ob = out + (long long)b * M;
  for (int j = threadIdx.x; j < per_rank; j += threads) {
    const int idx = rank * per_rank + j;
    if (idx >= tile_m) break;
    float v = __int_as_float(0x7f800000);
    for (int s = 0; s < S; ++s) v = fminf(v, cluster.map_shared_rank(part, s)[idx]);
    const int m = m_tile + idx;
    if (m < M) ob[m] = fmaxf(v, 0.f);
  }
  cluster.sync();  // no block leaves while another may still read its `part`
}

cudaLaunchConfig_t make_config(cudaLaunchAttribute* attr, int B, int M, int tile_m, int split,
                               cudaStream_t stream) {
  return gto::cluster_config(attr, (M + tile_m - 1) / tile_m, B, tile_m / QPT, split, 0, stream);
}

}  // namespace

extern "C" {

// q: (B or 1, M, 3) float32, q_batch_stride elements between batch
// entries (0 = shared); r4: (B, N, 4) float32, 16-byte aligned; out:
// (B, M) float32. tile_m: queries a block takes (a multiple of QPT, at
// most MAX_TILE_M); split: the blocks of a cluster sharing one query tile.
// Returns the launch's cudaError_t (0 on success): a shape whose clusters
// cannot be resident is refused, never run another way.
int gto_min_d2(const void* q, long long q_batch_stride, const void* r4, void* out,
               int B, int M, int N, int tile_m, int split, void* stream) {
  if (B <= 0 || M <= 0 || N <= 0 || split <= 0 || tile_m <= 0 || tile_m % QPT != 0)
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = make_config(attr, B, M, tile_m, split, (cudaStream_t)stream);
  cudaError_t err = gto::check_clusters(min_d2_kernel, cfg);
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(&cfg, min_d2_kernel, (const float*)q, q_batch_stride, (const float4*)r4,
                             (float*)out, M, N);
  return finish(err);
}

// How the launch of gto_min_d2 at (tile_m, split) sits on the current
// device: resident blocks an SM holds and clusters the card holds at once.
int gto_min_d2_occupancy(int tile_m, int split, int* blocks_per_sm, int* active_clusters) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = make_config(attr, 1, tile_m, tile_m, split, 0);
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, min_d2_kernel,
                                                                  (int)cfg.blockDim.x, 0);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(active_clusters, min_d2_kernel, &cfg);
  return finish(err);
}

const char* gto_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
