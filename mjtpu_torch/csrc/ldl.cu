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
// Two kernels, chosen by ops/ldl.py's size dispatch; both hold one env per
// warp, its compact factor and right-hand side in the warp's shared
// memory, several warps a block:
//
//   * `lanes` (every tree whose shared block fits the schedule's 15-bit
//     byte offsets, MJTPU_LDL_LANE_FIELD_BITS: 32 KB an env).  What bounds
//     it on this card: at the main path's size (the 66-dof branchy tree,
//     depth 16, 3,905 updates, 4,096 envs: ~31 warps an SM, one wave)
//     neither bytes nor FLOPs do (~12 KFLOP over 8.4 KB an env at f32),
//     but the instructions each warp issues for its chain of updates and
//     the shared-memory wavefronts their operands take.  What the design
//     does about that: the schedule is dealt to the 32 lanes on the host
//     (longest list first, to the least loaded lane) and stored lane-
//     major, one 64-bit word an update (four 15-bit byte offsets into the
//     env's block and three flags), so each step of a warp is one
//     coalesced 8-byte load a lane, an operand's address one add, and no
//     lane waits at a reconvergence point; each step's operands are loaded
//     one step ahead, while the previous division runs (safe: a round
//     never writes what it reads), and a target's running value only at
//     its first update; the rows sit at an odd stride in shared memory,
//     which spreads the pivots (each row's last entry) over the banks; the
//     L solve runs by ancestor level (sparse._l_push), each deeper row
//     adding one term a round, so all rows below a level share its round
//     instead of one row per limb.  branchy66 takes 133 factor steps a
//     warp, 65 L^T and 26 L solve steps (the shared kernel's striding:
//     149, 70 and 120 over its busiest lane).  The schedule stays in global memory (58.4 KB for
//     branchy66; staging it beside 8 envs' blocks would cut the blocks an
//     SM), where every warp reads the same words through L1.  Two envs a
//     warp sharing each word, and operands loaded two steps ahead, both
//     measured slower (PERF.md).
//   * `shared` (the first design, any tree whose block fits; the static
//     bound of the wrapper): lanes stride over each round's targets and
//     read three int32 indices an update from the packed schedule
//     (sparse._pack).
//
// Order: each factor target sums its contributions in ascending update
// order, one lane a target:
//     acc = S[t];  acc = acc - (S[a] * S[b]) / max(S[d], MINVAL)  ...
// so no two lanes write one entry, no atomics are used, and the result is
// deterministic.  After the rounds the off-diagonals are divided by the
// floored pivot.  The solve's L^T rounds (by height) sum, per ancestor
// row a, its contributions x[a] = x[a] - L[k,c] * x[k] in list order;
// then x /= max(D, MINVAL); then each row k sums its ancestors' terms in
// ascending column order and subtracts the sum once:
//     x[k] = x[k] - (L[k,c0] x[anc] + L[k,c0+1] x[anc] + ...).
// sparse.py's factor/solve perform the same operations in the same order,
// both kernels too, and this file is built with --fmad=false (no
// contraction into FMAs), so all three agree bit for bit.  The pivot floor
// is MINVAL = 1e-15 at f32 and f64 alike (mjtpu's sparse.py), and a NaN
// pivot stays NaN.
//
// Interface: per kernel and dtype one plain C entry point, bound with
// ctypes, with a mode: 1 factor (in = Mc, out = S), 2 solve (in = S, rhs,
// out = x), 3 factor then solve in one residency (in = Mc, rhs, out = x).
// It launches on the given stream, allocates nothing, does not
// synchronize, and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;

// the shared kernel's packed schedule header (mjtpu_torch/_src/sparse.py, _pack)
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
__global__ void ldl_shared_kernel(const T* __restrict__ in, const T* __restrict__ rhs,
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

// ---------------------------------------------------------------------------
// the lanes kernel
// ---------------------------------------------------------------------------

// the lane-major schedule's word: ops/ldl.py and _src/sparse.py (_pack_lanes,
// LANES and LANE_FIELD_BITS) use the same numbers
#define MJTPU_LDL_LANES 32
#define MJTPU_LDL_LANE_FIELD_BITS 15
static_assert(MJTPU_LDL_LANES == kWarp, "one word a lane of a warp");

// the lane schedule's header (mjtpu_torch/_src/sparse.py, _pack_lanes): nv,
// depth, the shared row stride, then per pass its round count, the offset
// of its cumulative step counts and of its words (int32 units; the words
// start 8-byte aligned)
enum LaneHeader {
  kLaneNv = 0, kLaneDepth, kLaneStride,
  kLaneFRounds, kLaneFSteps, kLaneFWords,
  kLaneLtRounds, kLaneLtSteps, kLaneLtWords,
  kLaneLRounds, kLaneLSteps, kLaneLWords,
};

constexpr unsigned kFieldMask = (1u << MJTPU_LDL_LANE_FIELD_BITS) - 1;
constexpr unsigned kFlagBit = 1u << MJTPU_LDL_LANE_FIELD_BITS;

// one update of one lane.  lo = p | FIRST | q << 16 | LAST, hi = r | VALID |
// t << 16: p, q, r the sources, t the target, as byte offsets into the
// env's shared block; FIRST and LAST mark the target's first and last
// update, VALID is clear in a padding word (all zero: offsets 0, safe to
// read)
struct Word {
  unsigned p, q, r, t;
  bool first, last, valid;
};

__device__ __forceinline__ Word unpack(uint2 w) {
  Word o;
  o.p = w.x & kFieldMask;
  o.first = (w.x & kFlagBit) != 0;
  o.q = (w.x >> 16) & kFieldMask;
  o.last = (w.x >> 31) != 0;
  o.r = w.y & kFieldMask;
  o.valid = (w.y & kFlagBit) != 0;
  o.t = w.y >> 16;
  return o;
}

template <typename T>
__device__ __forceinline__ T at(const unsigned char* base, unsigned off) {
  return *reinterpret_cast<const T*>(base + off);
}

template <typename T>
__device__ __forceinline__ void put(unsigned char* base, unsigned off, T v) {
  *reinterpret_cast<T*>(base + off) = v;
}

enum Pass { kPassFactor, kPassLt, kPassL };

// one step's operands, read a step ahead; the target's running value only
// where the step needs it (its first update; in the L solve its partial sum
// where it is not the first, x at its last)
template <typename T>
struct Operands {
  T p, q, d, init, part;
};

template <typename T, int kPass>
__device__ __forceinline__ Operands<T> operands(const Word& w, const unsigned char* base,
                                                unsigned part_off) {
  Operands<T> o{};
  o.p = at<T>(base, w.p);
  o.q = at<T>(base, w.q);
  if (kPass == kPassFactor) o.d = at<T>(base, w.r);
  if (kPass == kPassL) {
    if (!w.first) o.part = at<T>(base, w.t + part_off);
    if (w.last) o.init = at<T>(base, w.t);
  } else if (w.first) {
    o.init = at<T>(base, w.t);
  }
  return o;
}

// One pass of the lane schedule.  Within a round no word reads what another
// writes (factor: sources in the rows the round eliminates, targets in their
// ancestors; L^T: x of the round's rows into their ancestors; L: x of the
// level's rows into deeper rows), and each target is one lane's, so each
// step's operands are loaded one step ahead, while the previous step's
// division or product runs; past a round's last step the lookahead reads
// the next round's first (or the padding step) and drops it.
template <typename T, int kPass>
__device__ void lane_pass(unsigned char* base, unsigned part_off, const int* sched,
                          int rounds_at, int steps_at, int words_at, int lane, T floor) {
  const int rounds = sched[rounds_at];
  const int* steps = sched + sched[steps_at];
  const uint2* words = reinterpret_cast<const uint2*>(sched + sched[words_at]) + lane;
  for (int r = 0; r < rounds; ++r) {
    const int s1 = steps[r + 1];
    int s = steps[r];
    Word w = unpack(__ldg(words + s * kWarp));
    Operands<T> o = operands<T, kPass>(w, base, part_off);
    T acc = 0;
    for (; s < s1; ++s) {
      const Word cur = w;
      const Operands<T> c = o;
      w = unpack(__ldg(words + (s + 1) * kWarp));
      o = operands<T, kPass>(w, base, part_off);
      if (!cur.valid) continue;  // padding: this lane's list ended
      if (kPass == kPassFactor) {
        acc = (cur.first ? c.init : acc) - (c.p * c.q) / floored(c.d, floor);
        if (cur.last) put(base, cur.t, acc);
      } else if (kPass == kPassLt) {
        acc = (cur.first ? c.init : acc) - c.p * c.q;
        if (cur.last) put(base, cur.t, acc);
      } else {
        const T prod = c.p * c.q;
        const T sum = cur.first ? prod : c.part + prod;
        if (cur.last) {
          put(base, cur.t, c.init - sum);
        } else {
          put(base, cur.t + part_off, sum);
        }
      }
    }
    __syncwarp();
  }
}

template <typename T, int kMode>
__global__ void ldl_lanes_kernel(const T* __restrict__ in, const T* __restrict__ rhs,
                                 T* __restrict__ out, const int* __restrict__ sched, int batch,
                                 int nv, int depth, T floor) {
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const long env = static_cast<long>(blockIdx.x) * blockDim.y + warp;
  if (env >= batch) return;  // whole warp leaves together: only __syncwarp below

  const int ld = sched[kLaneStride];  // odd: rows start on different banks
  const int block = nv * ld + 2 * nv;
  unsigned char* base = smem_raw + sizeof(T) * static_cast<long>(warp) * block;
  T* S = reinterpret_cast<T*>(base);  // (nv, ld): the compact factor, rows padded
  T* x = S + nv * ld;                 // (nv,) rhs -> y -> x
  const unsigned part_off = sizeof(T) * nv;  // the L solve's partial sums, after x
  const int nd = nv * depth;
  // compact entry e = lane + 32 m sits at shared row * ld + column: each lane
  // carries its (row, column) from one entry to its next, branch-free, so
  // the copies unroll into batches of independent loads
  const int drow = kWarp / depth, dcol = kWarp % depth;
  const int row0 = lane / depth, col0 = lane % depth;
  {
    int row = row0, col = col0;
#pragma unroll 4
    for (int e = lane; e < nd; e += kWarp) {
      S[row * ld + col] = in[env * nd + e];
      col += dcol;
      const bool wrap = col >= depth;
      row += drow + wrap;
      col -= wrap ? depth : 0;
    }
  }
  if (kMode & kSolve) {
    for (int e = lane; e < nv; e += kWarp) x[e] = rhs[env * nv + e];
  }
  __syncwarp();

  if (kMode & kFactor) {
    lane_pass<T, kPassFactor>(base, part_off, sched, kLaneFRounds, kLaneFSteps, kLaneFWords,
                              lane, floor);
    // L's off-diagonals over the floored pivot (pad entries too, as the
    // plain version does), then the pivots floored: a row a lane, whose
    // rows at the odd stride lie on different banks
    for (int i = lane; i < nv; i += kWarp) {
      T* Si = S + i * ld;
      const T dia = floored(Si[depth - 1], floor);
      for (int c = 0; c < depth - 1; ++c) Si[c] = Si[c] / dia;
      Si[depth - 1] = dia;
    }
    __syncwarp();
  }
  if (kMode == kFactor) {
    int row = row0, col = col0;
#pragma unroll 4
    for (int e = lane; e < nd; e += kWarp) {
      out[env * nd + e] = S[row * ld + col];
      col += dcol;
      const bool wrap = col >= depth;
      row += drow + wrap;
      col -= wrap ? depth : 0;
    }
    return;
  }
  lane_pass<T, kPassLt>(base, part_off, sched, kLaneLtRounds, kLaneLtSteps, kLaneLtWords, lane,
                        floor);
  for (int i = lane; i < nv; i += kWarp) x[i] = x[i] / floored(S[i * ld + depth - 1], floor);
  __syncwarp();
  lane_pass<T, kPassL>(base, part_off, sched, kLaneLRounds, kLaneLSteps, kLaneLWords, lane,
                       floor);
  for (int e = lane; e < nv; e += kWarp) out[env * nv + e] = x[e];
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

enum Kind { kShared = 0, kLanes = 1 };

template <typename T, int kKind, int kMode>
int launch_mode(const T* in, const T* rhs, T* out, const int* sched, int batch, int nv,
                int depth, int warps_per_block, void* stream) {
  // the lanes kernel pads its rows to an odd stride and keeps a second
  // (nv,) vector, the L solve's partial sums
  const int per_env = kKind == kLanes ? nv * (depth | 1) + 2 * nv : nv * depth + nv;
  const size_t smem = sizeof(T) * static_cast<size_t>(warps_per_block) * per_env;
  auto kernel = kKind == kLanes ? ldl_lanes_kernel<T, kMode> : ldl_shared_kernel<T, kMode>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kWarp, warps_per_block);
  const dim3 grid((batch + warps_per_block - 1) / warps_per_block);
  // MINVAL (mjMINVAL) at every dtype, as mjtpu's sparse.py floors
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      in, rhs, out, sched, batch, nv, depth, static_cast<T>(1e-15));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kKind>
int launch(int mode, const T* in, const T* rhs, T* out, const int* sched, int batch, int nv,
           int depth, int warps_per_block, void* stream) {
  switch (mode) {
    case kFactor:
      return launch_mode<T, kKind, kFactor>(in, rhs, out, sched, batch, nv, depth,
                                            warps_per_block, stream);
    case kSolve:
      return launch_mode<T, kKind, kSolve>(in, rhs, out, sched, batch, nv, depth,
                                           warps_per_block, stream);
    case kFactor | kSolve:
      return launch_mode<T, kKind, kFactor | kSolve>(in, rhs, out, sched, batch, nv, depth,
                                                     warps_per_block, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// sched: the lane schedule (sparse._pack_lanes) for the lanes kernel, the
// packed schedule (sparse._pack) for the shared one
#define MJTPU_LDL_ENTRY(KIND, SUFFIX, T, KINDV)                                                 \
  int mjtpu_ldl_##KIND##_##SUFFIX(int mode, const T* in, const T* rhs, T* out, const int* sched, \
                                  int batch, int nv, int depth, int warps_per_block,            \
                                  void* stream) {                                               \
    return launch<T, KINDV>(mode, in, rhs, out, sched, batch, nv, depth, warps_per_block,       \
                            stream);                                                            \
  }
MJTPU_LDL_ENTRY(lanes, f32, float, kLanes)
MJTPU_LDL_ENTRY(lanes, f64, double, kLanes)
MJTPU_LDL_ENTRY(shared, f32, float, kShared)
MJTPU_LDL_ENTRY(shared, f64, double, kShared)
#undef MJTPU_LDL_ENTRY

const char* mjtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
