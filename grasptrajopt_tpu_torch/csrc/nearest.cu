// K2 and K3: batched exact-fp32 nearest reference point, its index, and
// (K2) the point and its normal.
//
//   d2[c, m]  = max(0, min_n (|q[c, m] - r[c, n]|^2 + pen[c, n]))
//   idx[c, m] = the FIRST n reaching that minimum
//   pt[c, m]  = r[c, idx],  nm[c, m] = normals[c, idx]      (K2 only)
//
// Replaces two kernels of grasptrajopt_tpu/ops/nn.py:
//   - _nearest_kernel (launched by nearest_point_normal_pallas, nn.py:296):
//     points mode's signed distance (d2, nearest point, nearest normal);
//   - _min_kernel (launched by min_sqdist_pallas, nn.py:420): d2 and the
//     global argmin under a validity mask. Null pt / nm pointers select
//     this index-only mode.
// The reference set is K1's layout, (C, N, 4) float32 rows x / y / z /
// penalty (0 valid, 3e38 invalid), 16 bytes a point, so a mask costs
// nothing extra and any run of points is one aligned span; normals are
// (C, N, 3). The queries are one set per batch entry (q_batch_stride =
// 3 * M) or one set shared by all (q_batch_stride = 0).
//
// What bounds it on the card: FP32 issue, as K1. The least a (query,
// point) pair needs is K1's 7 instructions (three subtracts, three fused
// multiply-adds, the min); carrying the index with a compare and two
// selects at every pair would make it 10. The exact per-goal tier's
// obstacle pass is 16 sets x 1.6 M queries x 4,096 points = 1.05e11 pairs.
//
// What the design does about it (each choice measured on the card,
// NVIDIA H100 80GB HBM3 at 700 W: PERF.md section 6, PR 8):
// - The argmin is not carried per pair. Each thread keeps QPT = 4
//   queries and their running minima (fminf, as K1) and, at the end of
//   every SUB = 32-point sub-tile, records the sub-tile in which the
//   minimum last strictly fell: a compare and a select per query per
//   sub-tile. No earlier sub-tile can hold the final value (the minimum
//   fell below all of them later) and an equal value in a later sub-tile
//   never moves the record, so after the walk one rescan of the recorded
//   sub-tile, in increasing index order and with the same instructions
//   (pair_d2 pins its roundings), finds the first index reaching the
//   minimum. A compare and two selects at every pair ran 28% slower at
//   the exact tier's obstacle pass.
// - A block's share of the cloud streams through a ring of STAGES = 2
//   shared-memory buffers of CHUNK rows: one thread issues a 1-D TMA bulk
//   copy per chunk, counted on the buffer's mbarrier, and refills a buffer
//   once every thread is done with it, so the next chunk is in flight
//   while one is consumed. A share of at most STAGES chunks stays
//   resident, and its rescan reads shared memory; a longer one's rescan
//   reads its rows from global memory (L2). Keeping every share resident
//   was slower: 64 KB of rows a block leave room for fewer blocks an SM.
// - Where the query tiles alone do not fill the card (the mobile
//   occupancy builds: 2,867 and 211,176 queries), the cloud is split over
//   a thread-block cluster of S blocks (S in 1, 2, 4, 8, 16), each walking
//   a contiguous share in increasing index order. The S partial (d2,
//   index) pairs meet through distributed shared memory: the smaller d2
//   wins and, on equal d2, the lower rank, so the index is the global
//   first one and the output is bit-identical for every S. The epilogue
//   loads the winning row (one 16-byte load) and its normal once per
//   query.
// The TPU kernel carried a running minimum across a sequential grid axis
// and built the nearest point with a one-hot matmul against VMEM tables;
// neither carries over. It averaged tied points; here the first index
// wins. Ragged M and N are masked here, not padded by the caller; padded
// PAD_COORD = 1e6 rows need no mask (their d2 ~3e12 stays finite).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "tma.cuh"

namespace cg = cooperative_groups;
using gto::bulk_load;
using gto::finish;
using gto::mbar_init;
using gto::mbar_wait;
using gto::pair_d2;

namespace {

constexpr int QPT = 4;                         // queries per thread
constexpr int SUB = 32;                        // points a sub-tile of the argmin record
constexpr int MAX_THREADS = 256;
constexpr int MAX_TILE_M = MAX_THREADS * QPT;  // queries a block at most
constexpr int CHUNK = 512;                     // points a bulk copy: 8 KB of rows
constexpr int STAGES = 2;                      // buffers of the ring: 16 KB
constexpr int MAX_SPLIT = 16;                  // the largest (non-portable) cluster
static_assert(CHUNK % SUB == 0, "a chunk holds whole sub-tiles");

__global__ void __launch_bounds__(MAX_THREADS)
nearest_kernel(const float* __restrict__ q, long long q_batch_stride,
               const float4* __restrict__ r4, const float* __restrict__ normals,
               float* __restrict__ d2_out, int* __restrict__ idx_out,
               float* __restrict__ pt_out, float* __restrict__ nm_out,
               int M, int N) {
  extern __shared__ __align__(128) float4 rows[];  // the ring: min(STAGES x CHUNK, share) rows
  __shared__ alignas(8) uint64_t full[STAGES];
  __shared__ float part_d2[MAX_TILE_M];
  __shared__ int part_idx[MAX_TILE_M];

  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int threads = blockDim.x;
  const int tile_m = threads * QPT;
  const int c = blockIdx.y;
  const int m_tile = (blockIdx.x / S) * tile_m;
  const float* qc = q + (long long)c * q_batch_stride;
  const float4* rc = r4 + (long long)c * N;

  // this block's share of the cloud: points [p0, p1), in nt chunks
  const int p0 = (int)((long long)N * rank / S);
  const int p1 = (int)((long long)N * (rank + 1) / S);
  const int nt = (p1 - p0 + CHUNK - 1) / CHUNK;
  const bool resident = nt <= STAGES;

  auto issue = [&](int i) {  // chunk i of the share into buffer i % STAGES
    const int n0 = p0 + i * CHUNK;
    const int count = min(CHUNK, p1 - n0);
    bulk_load(rows + (i % STAGES) * CHUNK, rc + n0, (uint32_t)count * sizeof(float4), &full[i % STAGES]);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES && s < nt; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < STAGES && i < nt; ++i) issue(i);
  }

  float qx[QPT], qy[QPT], qz[QPT], best[QPT], low[QPT];
  int rec[QPT];
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int m = m_tile + threadIdx.x + k * threads;
    const bool in = m < M;
    qx[k] = in ? qc[3 * (long long)m + 0] : 0.f;
    qy[k] = in ? qc[3 * (long long)m + 1] : 0.f;
    qz[k] = in ? qc[3 * (long long)m + 2] : 0.f;
    best[k] = low[k] = __int_as_float(0x7f800000);  // +inf
    rec[k] = p0;
  }
  __syncthreads();  // the barriers are initialised

  for (int i = 0; i < nt; ++i) {
    mbar_wait(&full[i % STAGES], (uint32_t)(i / STAGES) & 1u);
    const float4* tp = rows + (i % STAGES) * CHUNK;
    const int n0 = p0 + i * CHUNK;
    const int count = min(CHUNK, p1 - n0);
    for (int j = 0; j < count; j += SUB) {
      if (j + SUB <= count) {
#pragma unroll 8
        for (int u = 0; u < SUB; ++u) {
          const float4 r = tp[j + u];
#pragma unroll
          for (int k = 0; k < QPT; ++k) best[k] = fminf(best[k], pair_d2(qx[k], qy[k], qz[k], r));
        }
      } else {
        for (int u = j; u < count; ++u) {
          const float4 r = tp[u];
#pragma unroll
          for (int k = 0; k < QPT; ++k) best[k] = fminf(best[k], pair_d2(qx[k], qy[k], qz[k], r));
        }
      }
#pragma unroll
      for (int k = 0; k < QPT; ++k) {  // the sub-tile where the minimum last strictly fell
        rec[k] = best[k] < low[k] ? n0 + j : rec[k];
        low[k] = best[k];
      }
    }
    if (i + STAGES < nt) {  // ring: refill this buffer once every thread is done with it
      __syncthreads();
      if (threadIdx.x == 0) issue(i + STAGES);
    }
  }

  // the first index of the recorded sub-tile reaching the minimum
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int start = rec[k];
    const int len = min(SUB, p1 - start);
    const float4* src = resident ? rows + (start - p0) : rc + start;
    int at = start;
    for (int u = len - 1; u >= 0; --u)
      if (pair_d2(qx[k], qy[k], qz[k], src[u]) == best[k]) at = start + u;
    part_d2[threadIdx.x + k * threads] = best[k];
    part_idx[threadIdx.x + k * threads] = at;
  }

  // combine the S partial (d2, index) pairs over distributed shared memory
  cluster.sync();
  const int per_rank = (tile_m + S - 1) / S;
  const float* nc = normals == nullptr ? nullptr : normals + (long long)c * 3 * N;
  for (int j = threadIdx.x; j < per_rank; j += threads) {
    const int slot = rank * per_rank + j;
    if (slot >= tile_m) break;
    float v = 0.f;
    int a = 0;
    for (int s = 0; s < S; ++s) {  // ascending rank: strict '<' keeps the lower rank on a tie
      const float w = cluster.map_shared_rank(part_d2, s)[slot];
      if (s == 0 || w < v) {
        v = w;
        a = cluster.map_shared_rank(part_idx, s)[slot];
      }
    }
    const int m = m_tile + slot;
    if (m >= M) continue;
    const long long o = (long long)c * M + m;
    d2_out[o] = fmaxf(v, 0.f);
    idx_out[o] = a;
    if (pt_out != nullptr) {
      const float4 r = rc[a];
      pt_out[3 * o + 0] = r.x;
      pt_out[3 * o + 1] = r.y;
      pt_out[3 * o + 2] = r.z;
    }
    if (nm_out != nullptr) {
      nm_out[3 * o + 0] = nc[3 * (long long)a + 0];
      nm_out[3 * o + 1] = nc[3 * (long long)a + 1];
      nm_out[3 * o + 2] = nc[3 * (long long)a + 2];
    }
  }
  cluster.sync();  // no block leaves while another may still read its partials
}

// Clusters of 16 allowed on the current device, set once.
cudaError_t configure() {
  static int done[64] = {};
  static std::mutex lock;
  const std::lock_guard<std::mutex> guard(lock);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || (device < 64 && done[device])) return err;
  err = cudaFuncSetAttribute(nearest_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && device < 64) done[device] = 1;
  return err;
}

// The launch of C sets x ceil(M / tile_m) query tiles, each a cluster of
// `split` blocks. Fails with cudaErrorInvalidValue where the geometry
// does not fit.
cudaError_t make_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int C, int M, int N, int tile_m,
                        int split, cudaStream_t stream) {
  if (C <= 0 || M <= 0 || N <= 0 || C > 65535 || split <= 0 || split > MAX_SPLIT || tile_m <= 0 ||
      tile_m % QPT != 0 || tile_m > MAX_TILE_M)
    return cudaErrorInvalidValue;
  const int share = (N + split - 1) / split;  // the largest share
  const size_t smem = (size_t)min(STAGES * CHUNK, share) * sizeof(float4);
  *cfg = gto::cluster_config(attr, (M + tile_m - 1) / tile_m, C, tile_m / QPT, split, smem, stream);
  return configure();
}

}  // namespace

extern "C" {

// q: (C or 1, M, 3) float32, q_batch_stride elements between sets (0 =
// shared); r4: (C, N, 4) float32, 16-byte aligned; normals: (C, N, 3)
// float32, or null when nm is null; d2: (C, M) float32; idx: (C, M) int32;
// pt, nm: (C, M, 3) float32, or both null for the index-only mode (K3).
// tile_m: queries a block takes (a multiple of QPT, at most MAX_TILE_M);
// split: the blocks of a cluster sharing one query tile.
// Returns the launch's cudaError_t (0 on success): a shape that does not
// fit, or whose clusters cannot be resident, is refused, never run
// another way.
int gto_nearest(const void* q, long long q_batch_stride, const void* r4, const void* normals,
                void* d2, void* idx, void* pt, void* nm, int C, int M, int N, int tile_m, int split,
                void* stream) {
  if ((nm != nullptr && normals == nullptr) || ((pt == nullptr) != (nm == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = make_config(&cfg, attr, C, M, N, tile_m, split, (cudaStream_t)stream);
  if (err == cudaSuccess) err = gto::check_clusters(nearest_kernel, cfg);
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(&cfg, nearest_kernel, (const float*)q, q_batch_stride, (const float4*)r4,
                             (const float*)normals, (float*)d2, (int*)idx, (float*)pt, (float*)nm, M, N);
  return finish(err);
}

// How a launch of gto_nearest at (N, tile_m, split) sits on the current
// device: resident blocks an SM holds and clusters the card holds at once.
int gto_nearest_occupancy(int N, int tile_m, int split, int* blocks_per_sm, int* active_clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = make_config(&cfg, attr, 1, tile_m, N, tile_m, split, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, nearest_kernel, (int)cfg.blockDim.x,
                                                        cfg.dynamicSmemBytes);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(active_clusters, nearest_kernel, &cfg);
  return finish(err);
}

const char* gto_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
