// K5: the batched block-tridiagonal SPD solve H x = rhs (block Thomas /
// Cholesky recursion) in one launch.
//
// Per problem, with diagonal blocks D_t (F of them, n x n), sub-diagonal
// blocks L_t = H[t+1, t] (F - 1) and right-hand sides r_t:
//
//   forward   S_0 = D_0,  y_0 = r_0,  C_0 = chol(S_0)
//             W = S_{t-1}^{-1} L_{t-1}^T,  u = S_{t-1}^{-1} y_{t-1}
//             S_t = D_t - L_{t-1} W,  y_t = r_t - L_{t-1} u,  C_t = chol(S_t)
//   backward  x_{F-1} = S_{F-1}^{-1} y_{F-1}
//             x_t = S_t^{-1} (y_t - L_t^T x_{t+1})
//
// with every S^{-1} b as the two triangular solves with C, in the plain
// loop's order (ops/block_tridiag.py: block_tridiag_solve_reference, on
// the unrolled Cholesky and substitutions of ops/smallchol.py).
//
// Replaces no TPU kernel: the JAX solve
// (grasptrajopt_tpu/ops/block_tridiag.py: block_tridiag_solve) is a
// lax.scan that XLA compiles into one program. The port's plain loop runs
// the recursion as a Python loop over F steps of batched elementwise ops:
// ~18,300 launches a call at F = 48, n = 7, three calls an LM solve, each
// ~27 us of the host's time for ~1.5 us of the card's. The host paced the
// whole solve on them, so K5 was added to do the recursion in one launch.
//
// What bounds it on the card:
//   - bytes: D, r and x once each, B * F * (n^2 + 2n) elements (the
//     solver's L is one -w I block read through stride 0), ~25 MB in
//     float32 at B = 2,048, F = 48, n = 7: ~7.4 us at 3.35 TB/s; the
//     factors written and read back (B * F * n^2) stay in the 50 MB L2;
//   - the serial chain: 2F dependent steps, each an n x n Cholesky and its
//     triangular solves, whose IEEE square roots and divisions follow one
//     another; no amount of parallelism over the batch shortens it.
//
// What the design does about them: each problem is a group of G lanes of
// one warp (G = 8 for n <= 7, 16 for n <= 15, 32 for n = 16: n + 1 lanes
// and a power of two), so a warp carries 32 / G problems and 128-thread
// blocks cover the batch in about one wave at B = 2,048. Lane j < n owns
// column j of S_t and of W; lane n owns the right-hand side column (y_{t-1}
// in, y_t out), so both solves of a step run at once as the n + 1 columns
// of [L^T | y]. The Cholesky goes column by column: lane k takes the
// square root and scales its column into the group's shared-memory copy of
// C_t, the other lanes read it and update their columns (the plain
// loop's left-looking sums, in the same order). Every lane keeps its
// column, the next step's D_t / L_t column is fetched during the current
// step, and only __syncwarp orders a step: no __syncthreads. The factors
// go to a global scratch, the y_t to the output x; the backward sweep
// stages each C_t and y_t in shared memory a step ahead and every lane of
// the group runs the substitutions on them.
//
// Arithmetic: IEEE square roots and divisions (built without fast-math),
// fused multiply-adds allowed, L applied as the full blocks it is.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_THREADS = 128;  // the block the wrapper launches; __launch_bounds__

__host__ __device__ constexpr int group_lanes(int n) { return n + 1 <= 8 ? 8 : (n + 1 <= 16 ? 16 : 32); }

// IEEE-rounded square roots (no fast-math, so sqrtf is sqrt.rn.f32)
__device__ __forceinline__ float ieee_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double ieee_sqrt(double v) { return sqrt(v); }

// S^{-1} w in place, S = C C^T, C lower-triangular row-major in shared memory
template <typename T, int N>
__device__ __forceinline__ void chol_solve(const T* C, T (&w)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {  // C z = w
    T r = w[i];
#pragma unroll
    for (int k = 0; k < i; ++k) r = r - C[i * N + k] * w[k];
    w[i] = r / C[i * N + i];
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {  // C^T x = z
    T r = w[i];
#pragma unroll
    for (int k = i + 1; k < N; ++k) r = r - C[k * N + i] * w[k];
    w[i] = r / C[i * N + i];
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(MAX_THREADS)
block_tridiag_kernel(const T* __restrict__ diag, const T* __restrict__ lower, long long ls_b,
                     long long ls_t, long long ls_r, long long ls_c, const T* __restrict__ rhs,
                     T* __restrict__ x, T* __restrict__ fac, int B, int F) {
  constexpr int G = group_lanes(N);
  constexpr int NN = N * N;
  constexpr int STAGE = (NN + N + G - 1) / G;  // staged elements a lane in the backward sweep
  __shared__ T smem[MAX_THREADS / G][NN + N];  // per group: C_t (row-major), then y_t

  const int per_block = blockDim.x / G;
  const int grp = threadIdx.x / G;
  const int lane = threadIdx.x % G;
  // a warp whose first problem is past the batch has nothing to do; the
  // other warps keep every lane to the end (their groups past the batch
  // redo the last problem and store nothing), so __syncwarp sees them all
  if ((long long)blockIdx.x * per_block + (int)(threadIdx.x & ~31u) / G >= B) return;
  const long long b_raw = (long long)blockIdx.x * per_block + grp;
  const bool live = b_raw < B;
  const long long b = live ? b_raw : B - 1;
  T* Cs = smem[grp];
  const bool is_col = lane < N;
  const int j = is_col ? lane : N - 1;  // lanes >= n read column n - 1's L row and ignore it

  const T* Db = diag + b * F * NN;
  const T* Rb = rhs + b * F * N;
  T* Xb = x + b * F * N;
  T* Fb = fac + b * F * NN;
  const T* Lb = lower + b * ls_b;
  // column `lane` of [D_t | r_t]: D_t[i][lane], or r_t[i] for lanes >= n
  const T* dcol = is_col ? Db + lane : Rb;
  const int dstride = is_col ? N : 1;
  const long long dstep = is_col ? NN : N;

  T s[N];  // this lane's column of S_t (lanes >= n: y_t)
  T c[N];  // this lane's column of C_t
  T d_next[N], l_next[N];
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = __ldg(dcol + i * dstride);
  if (F > 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      d_next[i] = __ldg(dcol + dstep + i * dstride);
      l_next[i] = __ldg(Lb + j * ls_r + i * ls_c);
    }
  }

  for (int t = 0; t < F; ++t) {
    if (t > 0) {
      // w: column `lane` of S_{t-1}^{-1} [L_{t-1}^T | y_{t-1}]
      T w[N], d[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        w[i] = is_col ? l_next[i] : s[i];
        d[i] = d_next[i];
      }
      if (t + 1 < F) {  // the next step's column, in flight during this one
#pragma unroll
        for (int i = 0; i < N; ++i) {
          d_next[i] = __ldg(dcol + (t + 1) * dstep + i * dstride);
          l_next[i] = __ldg(Lb + t * ls_t + j * ls_r + i * ls_c);
        }
      }
      chol_solve<T, N>(Cs, w);
      const T* Lp = Lb + (t - 1) * ls_t;
#pragma unroll
      for (int i = 0; i < N; ++i) {  // [S_t | y_t] = [D_t | r_t] - L_{t-1} w
        T acc = T(0);
#pragma unroll
        for (int k = 0; k < N; ++k) acc = acc + __ldg(Lp + i * ls_r + k * ls_c) * w[k];
        s[i] = d[i] - acc;
      }
      __syncwarp();  // the group is done reading C_{t-1}
    }
    if (live && lane == N) {
#pragma unroll
      for (int i = 0; i < N; ++i) Xb[t * N + i] = s[i];  // y_t, until the backward sweep
    }
    // C_t = chol(S_t): at pivot k lane k scales its column into Cs; the
    // lanes right of it subtract it from theirs
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (lane == k) {
        const T piv = ieee_sqrt(s[k]);
#pragma unroll
        for (int i = 0; i < N; ++i) {
          c[i] = i < k ? T(0) : s[i] / piv;
          Cs[i * N + k] = c[i];
        }
      }
      __syncwarp();
      if (lane > k && lane < N) {
        const T cjk = Cs[lane * N + k];
#pragma unroll
        for (int i = k + 1; i < N; ++i) s[i] = s[i] - Cs[i * N + k] * cjk;
      }
    }
    if (live && is_col) {
#pragma unroll
      for (int i = 0; i < N; ++i) Fb[(long long)t * NN + i * N + lane] = c[i];
    }
  }

  __syncwarp();  // the factors and y_t in global memory, before the group reads them
  T pre[STAGE];  // C_t and y_t, staged a step ahead
  auto stage_load = [&](int t) {
#pragma unroll
    for (int q = 0; q < STAGE; ++q) {
      const int e = lane + q * G;
      if (e < NN) pre[q] = Fb[(long long)t * NN + e];
      else if (e < NN + N) pre[q] = Xb[(long long)t * N + e - NN];
    }
  };
  stage_load(F - 1);
  T xn[N];  // x_{t+1}
  for (int t = F - 1; t >= 0; --t) {
    __syncwarp();  // the group is done reading the previous step's stage
#pragma unroll
    for (int q = 0; q < STAGE; ++q) {
      const int e = lane + q * G;
      if (e < NN + N) Cs[e] = pre[q];
    }
    __syncwarp();
    if (t > 0) stage_load(t - 1);
    T r[N];
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] = Cs[NN + i];
    if (t + 1 < F) {  // y_t - L_t^T x_{t+1}
      const T* Lt = Lb + t * ls_t;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        T acc = T(0);
#pragma unroll
        for (int k = 0; k < N; ++k) acc = acc + __ldg(Lt + k * ls_r + i * ls_c) * xn[k];
        r[i] = r[i] - acc;
      }
    }
    chol_solve<T, N>(Cs, r);
#pragma unroll
    for (int i = 0; i < N; ++i) xn[i] = r[i];
    if (live && lane == 0) {
#pragma unroll
      for (int i = 0; i < N; ++i) Xb[(long long)t * N + i] = r[i];
    }
  }
}

template <typename T, int N>
int launch(const void* diag, const void* lower, long long ls_b, long long ls_t, long long ls_r,
           long long ls_c, const void* rhs, void* x, void* fac, int B, int F, int threads,
           cudaStream_t stream) {
  constexpr int G = group_lanes(N);
  if (threads <= 0 || threads % 32) return (int)cudaErrorInvalidValue;
  const long long per_block = threads / G;
  const long long blocks = (B + per_block - 1) / per_block;
  block_tridiag_kernel<T, N><<<(unsigned int)blocks, threads, 0, stream>>>(
      (const T*)diag, (const T*)lower, ls_b, ls_t, ls_r, ls_c, (const T*)rhs, (T*)x, (T*)fac, B, F);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int n, const void* diag, const void* lower, long long ls_b, long long ls_t,
             long long ls_r, long long ls_c, const void* rhs, void* x, void* fac, int B, int F,
             int threads, cudaStream_t stream) {
  switch (n) {
#define K5_CASE(N_) \
  case N_:          \
    return launch<T, N_>(diag, lower, ls_b, ls_t, ls_r, ls_c, rhs, x, fac, B, F, threads, stream);
    K5_CASE(1) K5_CASE(2) K5_CASE(3) K5_CASE(4) K5_CASE(5) K5_CASE(6) K5_CASE(7) K5_CASE(8)
    K5_CASE(9) K5_CASE(10) K5_CASE(11) K5_CASE(12) K5_CASE(13) K5_CASE(14) K5_CASE(15) K5_CASE(16)
#undef K5_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// diag (B, F, n, n) and rhs (B, F, n) contiguous; lower (B, F - 1, n, n)
// read through its element strides (ls_b, ls_t, ls_r, ls_c), any of them
// 0; x (B, F, n) out; fac (B, F, n, n) scratch; all float32 (f64 = 0) or
// float64 (f64 = 1); 1 <= n <= 16; `threads` a multiple of 32. Returns the
// launch's cudaError_t (0 on success).
int gto_block_tridiag(const void* diag, const void* lower, long long ls_b, long long ls_t,
                      long long ls_r, long long ls_c, const void* rhs, void* x, void* fac, int B,
                      int F, int n, int f64, int threads, void* stream) {
  if (B <= 0 || F <= 0 || (f64 != 0 && f64 != 1)) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  return f64 ? dispatch<double>(n, diag, lower, ls_b, ls_t, ls_r, ls_c, rhs, x, fac, B, F, threads, s)
             : dispatch<float>(n, diag, lower, ls_b, ls_t, ls_r, ls_c, rhs, x, fac, B, F, threads, s);
}

const char* gto_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
