// K4: packed-row trilinear field lookup with its closed-form gradient.
//
// Per query point p = (x, y, z), against a table of packed corner rows
// (R, 8) float32 or bfloat16 (VoxelGrid.pack: the 8 trilinear corners of
// each cell; bf16 rows are upcast to float32 after the load, as the JAX
// lookup upcasts the gathered rows):
//
//   u    = (p - origin) * inv                      (float32, not contracted)
//   b    = clamp(floor(u), 0, shape - 2)           (the base cell)
//   row  = row_base[i / rb_div] + b.z + sz * (b.y + sy * b.x)
//   f    = clamp(u - b, 0, 1)
//   val  = trilinear(corners[row], f)
//   grad = d val / d p, zero along an axis where u - b leaves [0, 1]
//
// Replaces tools/probe_vmem_gather.py:_lane_gather_kernel (launched by
// make_lane_gather), the TPU probe of the packed corner-row gather inside
// grasptrajopt_tpu/ops/interp.py:field_lookup_packed_soa_grad, and the
// elementwise passes around that gather. The probe kept an (8, S) table in
// VMEM and gathered lanes, which never compiled under Mosaic; on the card
// the table lives in device memory and its rows are read through L2.
//
// The points arrive as three pointers with one element stride between
// consecutive points: stride 1 for the SoA output of component-form FK,
// stride 3 for the x / y / z views of an AoS (..., 3) tensor. row_base
// holds one int32 per rb_div consecutive points: one per (problem, step)
// in the planner (its phase slab plus, for stacked per-problem tables, the
// problem's field_base), or one per point.
//
// What bounds it on the card: bytes. Each point reads 12 B of coordinates
// and writes 16 B of value and gradient; its corner row (32 B in float32,
// 16 B in bf16) is an L2 hit once the table is resident (the bench's
// shared table is 2 x 95,760 rows x 32 B = 6.1 MB of the 50 MB L2). At the
// bench's fine pass (32 x 50 x 1,000 = 1.6 M points) that is ~45 MB, ~14 us
// at 3.35 TB/s; the ~60 flops a point are far below the FP32 rate. The bf16
// mode halves only the row bytes, so its bound stays the points' 28 B.
//
// What the design does about it: one thread per point, consecutive threads
// on consecutive points, so the coordinate reads and the four output
// writes coalesce; the corner row is two 16-byte loads through the
// read-only path (bf16: one 16-byte load, each 32-bit word two corners,
// widened to float32 by a 16-bit shift, which is exact). The cell
// computation uses round-to-nearest intrinsics in
// the plain version's order so every point lands in the same cell as in
// the plain version; the interpolation may contract into fused
// multiply-adds (a few ulp). Shared memory, tiling and fusing the Jacobian
// contraction are later work.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float clamp01(float v) { return fminf(fmaxf(v, 0.f), 1.f); }

// floor(u) clamped to [0, hi] as in the plain version (floor, cast, clamp)
__device__ __forceinline__ int base_cell(float u, int hi) {
  return (int)fminf(fmaxf(floorf(u), 0.f), (float)hi);
}

// the 8 corners of one row: c000 c001 c010 c011 c100 c101 c110 c111
template <bool BF16>
__device__ __forceinline__ void load_corners(const uint4* __restrict__ packed, long long row,
                                             float c[8]) {
  if (BF16) {
    const uint4 w = __ldg(packed + row);  // 8 bf16, little-endian pairs
    const unsigned int words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      c[2 * k] = __uint_as_float(words[k] << 16);
      c[2 * k + 1] = __uint_as_float(words[k] & 0xffff0000u);
    }
  } else {
    const float4 lo = __ldg(reinterpret_cast<const float4*>(packed) + 2 * row);
    const float4 hi = __ldg(reinterpret_cast<const float4*>(packed) + 2 * row + 1);
    c[0] = lo.x; c[1] = lo.y; c[2] = lo.z; c[3] = lo.w;
    c[4] = hi.x; c[5] = hi.y; c[6] = hi.z; c[7] = hi.w;
  }
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
field_lookup_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    const float* __restrict__ z, long long stride, int n,
                    const int* __restrict__ row_base, int rb_div,
                    const uint4* __restrict__ packed, long long n_rows,
                    float ox, float oy, float oz, float inv, int sx, int sy, int sz,
                    float* __restrict__ val, float* __restrict__ gx,
                    float* __restrict__ gy, float* __restrict__ gz) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const long long e = (long long)i * stride;
  const float ux = __fmul_rn(__fsub_rn(__ldg(x + e), ox), inv);
  const float uy = __fmul_rn(__fsub_rn(__ldg(y + e), oy), inv);
  const float uz = __fmul_rn(__fsub_rn(__ldg(z + e), oz), inv);
  const int bx = base_cell(ux, sx - 2);
  const int by = base_cell(uy, sy - 2);
  const int bz = base_cell(uz, sz - 2);
  const long long row =
      (long long)__ldg(row_base + i / rb_div) + bz + (long long)sz * (by + (long long)sy * bx);
  if (row < 0 || row >= n_rows) {  // the plain version raises an index error here
    const float nan = __int_as_float(0x7fc00000);
    val[i] = nan; gx[i] = nan; gy[i] = nan; gz[i] = nan;
    return;
  }
  const float rx = __fsub_rn(ux, (float)bx);
  const float ry = __fsub_rn(uy, (float)by);
  const float rz = __fsub_rn(uz, (float)bz);
  const float fx = clamp01(rx), fy = clamp01(ry), fz = clamp01(rz);
  // the clip's derivative: 1 on [0, 1], 0 outside
  const float mx = (rx >= 0.f && rx <= 1.f) ? inv : 0.f;
  const float my = (ry >= 0.f && ry <= 1.f) ? inv : 0.f;
  const float mz = (rz >= 0.f && rz <= 1.f) ? inv : 0.f;

  float c[8];
  load_corners<BF16>(packed, row, c);
  const float wx = 1.f - fx, wy = 1.f - fy, wz = 1.f - fz;
  const float c00 = c[0] * wz + c[1] * fz;
  const float c01 = c[2] * wz + c[3] * fz;
  const float c10 = c[4] * wz + c[5] * fz;
  const float c11 = c[6] * wz + c[7] * fz;
  const float c0 = c00 * wy + c01 * fy;
  const float c1 = c10 * wy + c11 * fy;
  val[i] = c0 * wx + c1 * fx;
  gx[i] = (c1 - c0) * mx;
  gy[i] = ((c01 - c00) * wx + (c11 - c10) * fx) * my;
  const float dz0 = (c[1] - c[0]) * wy + (c[3] - c[2]) * fy;
  const float dz1 = (c[5] - c[4]) * wy + (c[7] - c[6]) * fy;
  gz[i] = (dz0 * wx + dz1 * fx) * mz;
}

}  // namespace

extern "C" {

// x / y / z: n float32 points, `stride` elements apart; row_base: int32,
// one per rb_div consecutive points; packed: (n_rows, 8) float32 (bf16 = 0)
// or bfloat16 (bf16 = 1), 16-byte aligned; val / gx / gy / gz: n float32
// each. Returns the launch's cudaError_t (0 on success).
int gto_field_lookup(const void* x, const void* y, const void* z, long long stride, int n,
                     const void* row_base, int rb_div, const void* packed, long long n_rows,
                     int bf16, float ox, float oy, float oz, float inv, int sx, int sy, int sz,
                     void* val, void* gx, void* gy, void* gz, void* stream) {
  if (n <= 0 || stride <= 0 || rb_div <= 0 || n_rows <= 0 || sx < 2 || sy < 2 || sz < 2 ||
      (bf16 != 0 && bf16 != 1))
    return (int)cudaErrorInvalidValue;
  const int blocks = (n + THREADS - 1) / THREADS;
  auto kernel = bf16 ? field_lookup_kernel<true> : field_lookup_kernel<false>;
  kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y, (const float*)z, stride, n, (const int*)row_base, rb_div,
      (const uint4*)packed, n_rows, ox, oy, oz, inv, sx, sy, sz,
      (float*)val, (float*)gx, (float*)gy, (float*)gz);
  return (int)cudaGetLastError();
}

const char* gto_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
