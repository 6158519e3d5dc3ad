// Batched dense Cholesky factor + solve for NVIDIA Hopper (sm_90a).
//
// Replaces mjtpu/ops/cholesky.py `_chol_solve_kernel` (the Pallas TPU
// kernel behind mjtpu.ops.fused.chol_solve): for each env b of a batch,
// factor the SPD matrix mat[b] (n x n) with a pivot-clamped right-looking
// Cholesky and solve mat[b] x = rhs[b] with forward and back substitution,
// all in one shared-memory residency.
//
// What bounds it on this card: at the main path's size (n = 27, the
// humanoid's Newton Hessian) one env is ~7 KFLOP over ~6 KB, so neither
// bytes nor FLOPs bound it; the latency of the n-step dependent column
// loop does (each column needs the previous column's trailing update).
// What the design does about that: one warp per env, the rows of each
// column spread across the warp's lanes (strided for n > 32), and many
// warps per block and per SM, so the SM hides one env's dependent chain
// behind the others'.  Making it fast (several envs per warp, registers
// instead of shared memory, assembling the Hessian in the same kernel) is
// later work.
//
// Numerics follow mjtpu's math.safe_cholesky operation by operation:
// pivot = a_jj clamped below at floor (a NaN pivot stays NaN, so a
// diverging env is still seen), d = sqrt(pivot), column = a_ij / d, trailing
// update a_ik -= c_i * c_k.  Products are rounded before the subtraction
// (__fmul_rn / __dmul_rn), so the compiler cannot contract them into FMAs
// and the factor stays within a few ULP of the plain PyTorch version.
//
// Interface: a plain C entry point per dtype, bound with ctypes.  It
// launches on the given stream, allocates nothing, does not synchronize,
// and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

template <typename T>
__global__ void chol_solve_kernel(const T* __restrict__ mat, const T* __restrict__ rhs,
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

template <typename T>
int launch(const T* mat, const T* rhs, T* out, int batch, int n, int warps_per_block,
           T floor, void* stream) {
  const size_t smem = sizeof(T) * static_cast<size_t>(warps_per_block) * (n * n + n);
  cudaError_t err = cudaFuncSetAttribute(
      chol_solve_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kWarp, warps_per_block);
  const dim3 grid((batch + warps_per_block - 1) / warps_per_block);
  chol_solve_kernel<T><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      mat, rhs, out, batch, n, floor);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int mjtpu_chol_solve_f32(const float* mat, const float* rhs, float* out, int batch, int n,
                         int warps_per_block, void* stream) {
  return launch<float>(mat, rhs, out, batch, n, warps_per_block, 1e-9f, stream);
}

int mjtpu_chol_solve_f64(const double* mat, const double* rhs, double* out, int batch, int n,
                         int warps_per_block, void* stream) {
  return launch<double>(mat, rhs, out, batch, n, warps_per_block, 1e-15, stream);
}

const char* mjtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
