// Batched dense Cholesky factor + solve for NVIDIA Hopper (sm_90a).
//
// Replaces mjtpu/ops/cholesky.py `_chol_solve_kernel` (the Pallas TPU
// kernel behind mjtpu.ops.fused.chol_solve): for each env b of a batch,
// factor the SPD matrix mat[b] (n x n) with a pivot-clamped right-looking
// Cholesky and solve mat[b] x = rhs[b] with forward and back substitution,
// all in one residency.
//
// Two kernels, chosen by ops/cholesky.py's size dispatch; both put one env
// on a warp, 4 warps a block:
//
//   * `register` (instantiated for the n of MJTPU_CHOL_WIDTHS: 2, 5, 6, 8,
//     9, 12, 14, 23, 27, the main paths' and the zoo envs' sizes, so every loop bound
//     is a constant; a 32-wide instance masked at run time measured 35-56%
//     slower, PERF.md).  What
//     bounds it on this card: at the main paths' sizes (n = 27 and 23,
//     B = 4096: ~31 warps an SM, one wave) neither bytes (~6 KB an env)
//     nor FLOPs (~7 KFLOP) do, but the instructions each warp issues along
//     its chain of columns.  What the design does about that: lane i keeps
//     row i of the working matrix in n registers, the loops unrolled at
//     compile time; column j's
//     pivot and entries reach the other lanes by __shfl_sync, and the
//     trailing update runs in lockstep across the lanes, so a step of the
//     update is a shuffle, a multiply and a subtract with no shared-memory
//     round trip and no per-lane test; the forward substitution runs in the
//     same loop, column by column, with one division the whole warp shares,
//     and lanes whose quotient nobody reads divide d by d, so no lane takes
//     the division's slow path on a stray value.  The
//     back substitution needs columns of L, which a row a lane does not
//     give: L is written once to shared memory after the factor (rows at
//     an odd stride, so lane i's row and a row read across lanes are free
//     of bank conflicts) and the substitution reads it there in the
//     shared kernel's order.  The matrix is staged through the same shared
//     memory, read by the warp in order (coalesced).  At f64 a row takes
//     two registers an entry, which leaves room for fewer warps an SM than
//     B = 4096 needs in one wave.
//   * `shared` (the first design, every other n up to what fits a block's
//     shared memory, the wrapper's static bound): the matrix and right-hand
//     side in shared memory, the rows of each column spread over the lanes
//     (strided for n > 32), each lane's row of the trailing update a loop
//     over shared memory.
//
// Numerics follow mjtpu's math.safe_cholesky operation by operation, in
// both kernels in the same order: pivot = a_jj clamped below at floor (a
// NaN pivot stays NaN, so a diverging env is still seen), d = sqrt(pivot),
// column = a_ij / d, trailing update a_ik -= c_i * c_k for j ascending.
// Products are rounded before the subtraction (__fmul_rn / __dmul_rn), so
// the compiler cannot contract them into FMAs: the two kernels agree bit
// for bit, and stay within a few ULP of the plain PyTorch version.
//
// Interface: per kernel and dtype one plain C entry point, bound with
// ctypes.  It launches on the given stream, allocates nothing, does not
// synchronize, and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

template <typename T>
__global__ void chol_shared_kernel(const T* __restrict__ mat, const T* __restrict__ rhs,
                                  T* __restrict__ out, int batch, int n, T floor) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const long env = static_cast<long>(blockIdx.x) * blockDim.y + warp;
  if (env >= batch) return;  // whole warp leaves together: only __syncwarp below

  const int nn = n * n;
  T* a = smem + static_cast<long>(warp) * (nn + n);  // (n, n) row-major
  T* x = a + nn;                                     // (n,) rhs -> y -> x
  const T* src = mat + env * nn;
  for (int e = lane; e < nn; e += kWarp) a[e] = src[e];
  for (int e = lane; e < n; e += kWarp) x[e] = rhs[env * n + e];
  __syncwarp();

  // factor: column j, then the trailing update of the lower triangle
  for (int j = 0; j < n; ++j) {
    // not max(): device max is fmax, which would turn a NaN pivot into the
    // floor; clamp_min in the twin lets NaN through, and so does this
    const T ajj = a[j * n + j];
    const T d = sqrt(ajj < floor ? floor : ajj);
    for (int i = j + 1 + lane; i < n; i += kWarp) a[i * n + j] = a[i * n + j] / d;
    __syncwarp();
    if (lane == 0) a[j * n + j] = d;
    for (int i = j + 1 + lane; i < n; i += kWarp) {
      const T ci = a[i * n + j];
      for (int k = j + 1; k <= i; ++k) a[i * n + k] = a[i * n + k] - mul_rn(ci, a[k * n + j]);
    }
    __syncwarp();
  }

  // forward substitution L y = rhs, column-oriented
  for (int j = 0; j < n; ++j) {
    const T yj = x[j] / a[j * n + j];
    __syncwarp();
    if (lane == 0) x[j] = yj;
    for (int i = j + 1 + lane; i < n; i += kWarp) x[i] = x[i] - mul_rn(a[i * n + j], yj);
    __syncwarp();
  }

  // back substitution L^T x = y: column j of L^T is row j of L
  for (int j = n - 1; j >= 0; --j) {
    const T xj = x[j] / a[j * n + j];
    __syncwarp();
    if (lane == 0) x[j] = xj;
    for (int i = lane; i < j; i += kWarp) x[i] = x[i] - mul_rn(a[j * n + i], xj);
    __syncwarp();
  }

  for (int e = lane; e < n; e += kWarp) out[env * n + e] = x[e];
}

// the n the register kernel is instantiated for (every loop bound a
// constant); ops/cholesky.py's REGISTER_WIDTHS lists the same
#define MJTPU_CHOL_WIDTHS(X) X(2) X(5) X(6) X(8) X(9) X(12) X(14) X(23) X(27)

constexpr int kRegisterWarps = 4;
constexpr unsigned kFull = 0xffffffffu;

template <typename T, int n>
__global__ void __launch_bounds__(kWarp * kRegisterWarps)
chol_register_kernel(const T* __restrict__ mat, const T* __restrict__ rhs, T* __restrict__ out,
                     int batch, T floor) {
  static_assert(n <= kWarp, "a row a lane");
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const long env = static_cast<long>(blockIdx.x) * blockDim.y + warp;
  if (env >= batch) return;  // whole warp leaves together: only warp-wide sync below

  constexpr int ld = n | 1;  // odd row stride
  T* a = reinterpret_cast<T*>(smem_raw) + static_cast<long>(warp) * n * ld;
  constexpr int nn = n * n;
  {
    // the matrix in order: entry e to row e / n (a multiply-high with
    // m = ceil(2^32 / n), exact for every e < 2^27 at n <= 32), so every
    // iteration stands alone and the copy unrolls into batches of loads
    const T* src = mat + env * nn;
    constexpr unsigned long long magic = ((1ull << 32) + n - 1) / n;
    for (int e = lane; e < nn; e += kWarp) {
      const int row = static_cast<int>((static_cast<unsigned long long>(e) * magic) >> 32);
      a[row * ld + e - row * n] = src[e];
    }
  }
  __syncwarp();
  const bool live = lane < n;
  T r[n];  // row `lane` of the working matrix; entries right of the diagonal are never read
#pragma unroll
  for (int k = 0; k < n; ++k) r[k] = live ? a[lane * ld + k] : T(0);
  T x = live ? rhs[env * n + lane] : T(0);

  // factor, and the forward substitution L y = rhs with it: column j's
  // pivot from lane j, its entries from lanes k > j.  Lanes i < j update
  // their entries right of the diagonal too (a select would cost more than
  // the multiply), and those entries never reach one that is read.
#pragma unroll
  for (int j = 0; j < n; ++j) {
    const T ajj = __shfl_sync(kFull, r[j], j);
    // not max(): device max is fmax, which would turn a NaN pivot into the
    // floor; clamp_min in the twin lets NaN through, and so does this
    const T d = sqrt(ajj < floor ? floor : ajj);
    // only lanes j < i < n divide their entry; the others divide d by d, so
    // no lane takes the division's slow path on a value nobody reads
    const bool below = lane > j && live;
    const T q = (below ? r[j] : d) / d;
    r[j] = lane == j ? d : q;
#pragma unroll
    for (int k = j + 1; k < n; ++k) {
      const T ck = __shfl_sync(kFull, r[j], k);
      r[k] = r[k] - mul_rn(r[j], ck);
    }
    // y_j = x_j / d, as the shared kernel's separate pass computes it after
    // the factor: x_j has had every column before j subtracted
    const T yj = __shfl_sync(kFull, x, j) / d;
    if (lane > j) x = x - mul_rn(r[j], yj);
    if (lane == j) x = yj;
  }

  // L to shared memory, then back substitution L^T x = y: column j of L^T
  // is row j of L, read across the lanes
  __syncwarp();
#pragma unroll
  for (int k = 0; k < n; ++k) {
    if (live && k <= lane) a[lane * ld + k] = r[k];
  }
  __syncwarp();
#pragma unroll
  for (int j = n - 1; j >= 0; --j) {
    const T xj = __shfl_sync(kFull, x, j) / a[j * ld + j];
    if (lane < j) x = x - mul_rn(a[j * ld + lane], xj);
    if (lane == j) x = xj;
  }
  if (live) out[env * n + lane] = x;
}

template <typename T, int n>
int launch_register(const T* mat, const T* rhs, T* out, int batch, T floor, void* stream) {
  const size_t smem = sizeof(T) * static_cast<size_t>(kRegisterWarps) * n * (n | 1);
  cudaError_t err = cudaFuncSetAttribute(
      chol_register_kernel<T, n>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kWarp, kRegisterWarps);
  const dim3 grid((batch + kRegisterWarps - 1) / kRegisterWarps);
  chol_register_kernel<T, n><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      mat, rhs, out, batch, floor);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_register_n(const T* mat, const T* rhs, T* out, int batch, int n, T floor,
                      void* stream) {
  switch (n) {
#define MJTPU_CHOL_CASE(W) \
    case W:                \
      return launch_register<T, W>(mat, rhs, out, batch, floor, stream);
    MJTPU_CHOL_WIDTHS(MJTPU_CHOL_CASE)
#undef MJTPU_CHOL_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch(const T* mat, const T* rhs, T* out, int batch, int n, int warps_per_block,
           T floor, void* stream) {
  const size_t smem = sizeof(T) * static_cast<size_t>(warps_per_block) * (n * n + n);
  cudaError_t err = cudaFuncSetAttribute(
      chol_shared_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kWarp, warps_per_block);
  const dim3 grid((batch + warps_per_block - 1) / warps_per_block);
  chol_shared_kernel<T><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      mat, rhs, out, batch, n, floor);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int mjtpu_chol_shared_f32(const float* mat, const float* rhs, float* out, int batch, int n,
                          int warps_per_block, void* stream) {
  return launch<float>(mat, rhs, out, batch, n, warps_per_block, 1e-9f, stream);
}

int mjtpu_chol_shared_f64(const double* mat, const double* rhs, double* out, int batch, int n,
                          int warps_per_block, void* stream) {
  return launch<double>(mat, rhs, out, batch, n, warps_per_block, 1e-15, stream);
}

// n: one of MJTPU_CHOL_WIDTHS
int mjtpu_chol_register_f32(const float* mat, const float* rhs, float* out, int batch, int n,
                            void* stream) {
  return launch_register_n<float>(mat, rhs, out, batch, n, 1e-9f, stream);
}

int mjtpu_chol_register_f64(const double* mat, const double* rhs, double* out, int batch, int n,
                            void* stream) {
  return launch_register_n<double>(mat, rhs, out, batch, n, 1e-15, stream);
}

const char* mjtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
