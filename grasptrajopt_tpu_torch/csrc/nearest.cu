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
// The reference set is K1's layout, (C, 4, N) float32 rows x / y / z /
// penalty (0 valid, 3e38 invalid), so a mask costs nothing extra; normals
// are (C, N, 3). The queries are one set per batch entry (q_batch_stride =
// 3 * M) or one set shared by all (q_batch_stride = 0).
//
// What bounds it on the card: FP32 issue, like K1. Each (query, point)
// pair costs about 10 instructions: K1's 8 (3 subtracts, a multiply, two
// fused multiply-adds, the penalty add and the compare) plus the two
// selects that carry the index. One pass of the exact per-goal tier is
// 16 sets x 1.6 M queries x 4,096 points = 1.05e11 pairs.
//
// What the design does about it: as in K1, one block per (set, tile of
// THREADS * QPT queries); each thread keeps QPT queries with their best
// (d2, index) in registers and the block streams the set through a float4
// shared-memory tile in increasing index order. The TPU kernel carried a
// running minimum across a sequential grid axis and built the nearest
// point with a one-hot matmul against VMEM tables to avoid gathers;
// neither carries over. Here the walk over N is a loop inside the block,
// nothing crosses blocks, and the epilogue loads the winning row once per
// query. The comparison is a strict '<' in increasing index order, so the
// first index wins a tie (the TPU kernel averaged tied points). Ragged M
// and N are masked here, not padded by the caller; padded PAD_COORD = 1e6
// rows need no mask (their d2 ~3e12 stays finite). Plain FP32 only:
// wider query tiles and cp.async double-buffering are later work.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int QPT = 4;                    // queries per thread
constexpr int TILE_M = THREADS * QPT;     // queries per block
constexpr int TILE_N = 2048;              // points per shared-memory tile (32 KB)

__global__ void __launch_bounds__(THREADS)
nearest_kernel(const float* __restrict__ q, long long q_batch_stride,
               const float* __restrict__ rT, const float* __restrict__ normals,
               float* __restrict__ d2_out, int* __restrict__ idx_out,
               float* __restrict__ pt_out, float* __restrict__ nm_out,
               int M, int N) {
  __shared__ float4 tile[TILE_N];

  const int c = blockIdx.y;
  const int m0 = blockIdx.x * TILE_M + threadIdx.x;
  const float* qc = q + (long long)c * q_batch_stride;
  const float* rx = rT + (long long)c * 4 * N;
  const float* ry = rx + N;
  const float* rz = ry + N;
  const float* rp = rz + N;

  float qx[QPT], qy[QPT], qz[QPT], best[QPT];
  int arg[QPT];
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const int m = m0 + i * THREADS;
    const bool in = m < M;
    qx[i] = in ? qc[3 * (long long)m + 0] : 0.f;
    qy[i] = in ? qc[3 * (long long)m + 1] : 0.f;
    qz[i] = in ? qc[3 * (long long)m + 2] : 0.f;
    best[i] = __int_as_float(0x7f800000);  // +inf
    arg[i] = 0;
  }

  for (int n0 = 0; n0 < N; n0 += TILE_N) {
    const int count = min(TILE_N, N - n0);
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < count; j += THREADS) {
      tile[j] = make_float4(rx[n0 + j], ry[n0 + j], rz[n0 + j], rp[n0 + j]);
    }
    __syncthreads();
    for (int j = 0; j < count; ++j) {
      const float4 r = tile[j];
      const int n = n0 + j;
#pragma unroll
      for (int i = 0; i < QPT; ++i) {
        const float dx = qx[i] - r.x;
        const float dy = qy[i] - r.y;
        const float dz = qz[i] - r.z;
        float acc = dx * dx;
        acc += dy * dy;
        acc += dz * dz;
        acc += r.w;
        const bool better = acc < best[i];  // strict: the first index wins a tie
        best[i] = better ? acc : best[i];
        arg[i] = better ? n : arg[i];
      }
    }
  }

  const float* nc = normals == nullptr ? nullptr : normals + (long long)c * 3 * N;
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const int m = m0 + i * THREADS;
    if (m >= M) continue;
    const long long o = (long long)c * M + m;
    const int a = arg[i];
    d2_out[o] = fmaxf(best[i], 0.f);
    idx_out[o] = a;
    if (pt_out != nullptr) {
      pt_out[3 * o + 0] = rx[a];
      pt_out[3 * o + 1] = ry[a];
      pt_out[3 * o + 2] = rz[a];
    }
    if (nm_out != nullptr) {
      nm_out[3 * o + 0] = nc[3 * (long long)a + 0];
      nm_out[3 * o + 1] = nc[3 * (long long)a + 1];
      nm_out[3 * o + 2] = nc[3 * (long long)a + 2];
    }
  }
}

}  // namespace

extern "C" {

// q: (C or 1, M, 3) float32, q_batch_stride elements between sets (0 =
// shared); rT: (C, 4, N) float32; normals: (C, N, 3) float32, or null when
// nm is null; d2: (C, M) float32; idx: (C, M) int32; pt, nm: (C, M, 3)
// float32, or both null for the index-only mode (K3).
// Returns the launch's cudaError_t (0 on success).
int gto_nearest(const void* q, long long q_batch_stride, const void* rT, const void* normals,
                void* d2, void* idx, void* pt, void* nm, int C, int M, int N, void* stream) {
  if (C <= 0 || M <= 0 || N <= 0 || C > 65535) return (int)cudaErrorInvalidValue;
  if (nm != nullptr && normals == nullptr) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + TILE_M - 1) / TILE_M, C);
  nearest_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)q, q_batch_stride, (const float*)rT, (const float*)normals,
      (float*)d2, (int*)idx, (float*)pt, (float*)nm, M, N);
  return (int)cudaGetLastError();
}

const char* gto_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
