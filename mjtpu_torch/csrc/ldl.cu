// Batched tree-sparse LDL^T factor and solve of the mass matrix for NVIDIA
// Hopper (sm_90a).
//
// Replaces mjtpu/ops/ldl.py `_factor_value` and `_solve_value` (the Pallas
// TPU kernels behind `ldl_factor`, `ldl_solve` and `ldl_factor_solve`,
// mjtpu.ops.fused's LDL seams).  For each env b it factors the chain-
// pattern matrix Mc[b], held in the compact (nv, depth) layout of
// mjtpu_torch/_src/sparse.py (row i right-aligned: column depth-1 the
// diagonal, column depth-1-p the ancestor at distance p), as M = L^T D L
// with the levelwise zero-fill-in rounds of sparse.py, and/or solves
// M x = rhs[b] from the factor.  The Pallas kernel's one-hot selection
// matmuls, lane padding and transposes exist for the TPU's matrix unit
// and are not carried over: here the gathers and scatters are direct
// shared-memory reads and writes.
//
// What bounds it on this card: at the main path's size (the 66-dof
// branchy tree, depth 16, 3,905 updates) one env's factor is ~12 KFLOP
// over 8.4 KB at f32, so neither bytes nor FLOPs bound it; the chain of
// dependent rounds (16 factor rounds, 15 + 15 solve rounds, a warp
// barrier after each) and the short rounds near the root do.  What the
// design does about that: one warp per env, the env's compact factor and
// right-hand side in the warp's shared memory, lanes striding over a
// round's targets, several warps per block and many blocks per SM, so the
// SM hides one env's round chain behind the others'.  Making it fast
// (registers, several envs per warp on shallow trees, the schedule in
// shared memory) is later work.
//
// Schedule: a packed int32 buffer built once per tree by sparse.py
// (`_pack`), header first (enum Header).  Each factor round lists its
// targets (flat compact indices) with, per target, its contributions
// (a, b, d) in ascending update order; the lane that owns a target sums
// its list in that order:
//     acc = S[t];  acc = acc - (S[a] * S[b]) / max(S[d], MINVAL)  ...
// so no two lanes write one entry, no atomics are used, and the result is
// deterministic.  After the rounds the off-diagonals are divided by the
// floored pivot.  The solve's L^T rounds (by height) list, per ancestor
// row a, its contributions (k*D + c, k): x[a] = x[a] - L[k,c] * x[k];
// then x /= max(D, MINVAL); then the L rounds (by depth) list the rows k,
// and each sums its ancestors in ascending column order:
//     x[k] = x[k] - (L[k,c0] x[anc] + L[k,c0+1] x[anc] + ...).
// sparse.py's factor/solve perform the same operations in the same order,
// and this file is built with --fmad=false (no contraction into FMAs), so
// the two agree bit for bit.  The pivot floor is MINVAL = 1e-15 at f32 and
// f64 alike (mjtpu's sparse.py), and a NaN pivot stays NaN.
//
// Interface: one plain C entry point per dtype, bound with ctypes, with a
// mode: 1 factor (in = Mc, out = S), 2 solve (in = S, rhs, out = x),
// 3 factor then solve in one residency (in = Mc, rhs, out = x).  It
// launches on the given stream, allocates nothing, does not synchronize,
// and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;

// the packed schedule's header (mjtpu_torch/_src/sparse.py, _pack)
enum Header {
  kNv = 0, kDepth,
  kFRounds, kFRoundOff, kFTgtOff, kFPtrOff, kFSrcOff,
  kLtRounds, kLtRoundOff, kLtTgtOff, kLtPtrOff, kLtSrcOff,
  kLRounds, kLRoundOff, kLKOff, kDepthOff, kAncOff,
};

constexpr int kFactor = 1;
constexpr int kSolve = 2;

template <typename T>
__device__ __forceinline__ T floored(T v, T floor) {
  // not max(): device max is fmax, which would turn a NaN pivot into the
  // floor; clamp_min in the plain version lets NaN through, and so does this
  return v < floor ? floor : v;
}

template <typename T>
__device__ void factor(T* S, const int* sched, int nv, int depth, int lane, T floor) {
  const int rounds = sched[kFRounds];
  const int* round = sched + sched[kFRoundOff];
  const int* tgt = sched + sched[kFTgtOff];
  const int* ptr = sched + sched[kFPtrOff];
  const int* src = sched + sched[kFSrcOff];
  for (int r = 0; r < rounds; ++r) {
    for (int t = round[r] + lane; t < round[r + 1]; t += kWarp) {
      T acc = S[tgt[t]];
      for (int u = ptr[t]; u < ptr[t + 1]; ++u) {
        const int* s = src + 3 * u;
        acc = acc - (S[s[0]] * S[s[1]]) / floored(S[s[2]], floor);
      }
      S[tgt[t]] = acc;
    }
    __syncwarp();
  }
  // L's off-diagonals over the floored pivot (pad entries too, as the
  // plain version does), then the pivots themselves
  const int nd = nv * depth;
  for (int e = lane; e < nd; e += kWarp) {
    const int c = e % depth;
    if (c != depth - 1) S[e] = S[e] / floored(S[e - c + depth - 1], floor);
  }
  __syncwarp();
  for (int i = lane; i < nv; i += kWarp) {
    T* d = S + i * depth + depth - 1;
    *d = floored(*d, floor);
  }
  __syncwarp();
}

template <typename T>
__device__ void solve(const T* S, T* x, const int* sched, int nv, int depth, int lane, T floor) {
  // L^T y = rhs: descendants first
  {
    const int rounds = sched[kLtRounds];
    const int* round = sched + sched[kLtRoundOff];
    const int* tgt = sched + sched[kLtTgtOff];
    const int* ptr = sched + sched[kLtPtrOff];
    const int* src = sched + sched[kLtSrcOff];
    for (int r = 0; r < rounds; ++r) {
      for (int t = round[r] + lane; t < round[r + 1]; t += kWarp) {
        T acc = x[tgt[t]];
        for (int u = ptr[t]; u < ptr[t + 1]; ++u) acc = acc - S[src[2 * u]] * x[src[2 * u + 1]];
        x[tgt[t]] = acc;
      }
      __syncwarp();
    }
  }
  for (int i = lane; i < nv; i += kWarp) x[i] = x[i] / floored(S[i * depth + depth - 1], floor);
  __syncwarp();
  // L x = y: ancestors first
  const int rounds = sched[kLRounds];
  const int* round = sched + sched[kLRoundOff];
  const int* rows = sched + sched[kLKOff];
  const int* dof_depth = sched + sched[kDepthOff];
  const int* anc = sched + sched[kAncOff];
  for (int r = 0; r < rounds; ++r) {
    for (int j = round[r] + lane; j < round[r + 1]; j += kWarp) {
      const int k = rows[j];
      const int base = k * depth;
      const int c0 = depth - dof_depth[k];
      T acc = S[base + c0] * x[anc[base + c0]];
      for (int c = c0 + 1; c < depth - 1; ++c) acc = acc + S[base + c] * x[anc[base + c]];
      x[k] = x[k] - acc;
    }
    __syncwarp();
  }
}

template <typename T, int kMode>
__global__ void ldl_kernel(const T* __restrict__ in, const T* __restrict__ rhs,
                           T* __restrict__ out, const int* __restrict__ sched, int batch, int nv,
                           int depth, T floor) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const long env = static_cast<long>(blockIdx.x) * blockDim.y + warp;
  if (env >= batch) return;  // whole warp leaves together: only __syncwarp below

  const int nd = nv * depth;
  T* S = smem + static_cast<long>(warp) * (nd + nv);  // (nv, depth) compact
  T* x = S + nd;                                      // (nv,) rhs -> y -> x
  for (int e = lane; e < nd; e += kWarp) S[e] = in[env * nd + e];
  if (kMode & kSolve) {
    for (int e = lane; e < nv; e += kWarp) x[e] = rhs[env * nv + e];
  }
  __syncwarp();

  if (kMode & kFactor) factor(S, sched, nv, depth, lane, floor);
  if (kMode == kFactor) {
    for (int e = lane; e < nd; e += kWarp) out[env * nd + e] = S[e];
    return;
  }
  solve(S, x, sched, nv, depth, lane, floor);
  for (int e = lane; e < nv; e += kWarp) out[env * nv + e] = x[e];
}

template <typename T, int kMode>
int launch_mode(const T* in, const T* rhs, T* out, const int* sched, int batch, int nv,
                int depth, int warps_per_block, void* stream) {
  const size_t smem = sizeof(T) * static_cast<size_t>(warps_per_block) * (nv * depth + nv);
  cudaError_t err = cudaFuncSetAttribute(
      ldl_kernel<T, kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kWarp, warps_per_block);
  const dim3 grid((batch + warps_per_block - 1) / warps_per_block);
  // MINVAL (mjMINVAL) at every dtype, as mjtpu's sparse.py floors
  ldl_kernel<T, kMode><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      in, rhs, out, sched, batch, nv, depth, static_cast<T>(1e-15));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(int mode, const T* in, const T* rhs, T* out, const int* sched, int batch, int nv,
           int depth, int warps_per_block, void* stream) {
  switch (mode) {
    case kFactor:
      return launch_mode<T, kFactor>(in, rhs, out, sched, batch, nv, depth, warps_per_block,
                                     stream);
    case kSolve:
      return launch_mode<T, kSolve>(in, rhs, out, sched, batch, nv, depth, warps_per_block,
                                    stream);
    case kFactor | kSolve:
      return launch_mode<T, kFactor | kSolve>(in, rhs, out, sched, batch, nv, depth,
                                              warps_per_block, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int mjtpu_ldl_f32(int mode, const float* in, const float* rhs, float* out, const int* sched,
                  int batch, int nv, int depth, int warps_per_block, void* stream) {
  return launch<float>(mode, in, rhs, out, sched, batch, nv, depth, warps_per_block, stream);
}

int mjtpu_ldl_f64(int mode, const double* in, const double* rhs, double* out, const int* sched,
                  int batch, int nv, int depth, int warps_per_block, void* stream) {
  return launch<double>(mode, in, rhs, out, sched, batch, nv, depth, warps_per_block, stream);
}

const char* mjtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
