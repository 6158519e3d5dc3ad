// Batched convex-convex SAT winners for NVIDIA Hopper (sm_90a).
//
// Replaces mjtpu/ops/sat.py `_sat_kernel` (the Pallas TPU kernel behind
// mjtpu/_src/collision_convex._sat_winners): for each instance i (one
// (env, pair) of two convex hulls at poses (pos1, mat1), (pos2, mat2)),
// enumerate the SAT axes (both hulls' face normals and the ne1 x ne2
// edge-cross axes), and return only the winners:
//   seps[i] = [best face separation of hull 1, of hull 2, best edge-cross
//              separation]
//   idx[i]  = [bf1, bf2, be1, be2], the edge pair re-selected by support
//             along the winning axis.
// The O(ne1 * ne2 * (nv1 + nv2)) projections never leave the chip; the
// manifold clipping that consumes the winners stays in plain torch.
//
// What bounds it on this card: for two boxes (nv = 8, nf = 6, ne = 12) one
// instance reads 24 pose numbers and writes 7 values (~125 bytes at f32)
// and needs ~17.7k floating-point operations (144 axes, each a cross
// product, a norm, three IEEE divisions, an orientation and 16 vertex
// projections), so arithmetic, not bytes, bounds it: 0.130 ms at scene_pile's
// n = 491,520, f32.  The first design (`sat_shared_kernel`, kept for hulls
// past the static sizes) took 2.12 ms there (NVIDIA H100 80GB HBM3,
// 700.00 W, device time): it ran some 2,300 warp instructions an
// instance, most of them redundant: every axis read the 16 world vertices
// from shared memory, the reselect rebuilt all 144 axes (a square root and
// three divisions each), the hull sizes were runtime values (integer
// divisions, no unrolled loop), and the 5th pass over 144 axes left half
// the warp idle.
//
// Two variants, chosen by the wrapper (ops/sat.py) from the hull sizes:
//  * `sat_static_kernel<T, NV1, NF1, NE1, NV2, NF2, NE2>`, for the hull
//    sizes instantiated below (boxes (8, 6, 12) and humanoid_terrain's rock
//    hulls (6, 8, 12), in every order): 16 lanes per instance, two
//    instances a warp, so the 144 axes give each lane exactly 9; each lane
//    keeps the world vertices of both hulls in registers (staged once
//    through shared memory), computes each of its axes once and keeps them
//    (and |axis|) in registers for the reselect, which then costs one dot
//    product an axis; the winning axis comes from the lane that owns it by
//    a shuffle; the edge midpoints' dots with it are taken once an edge.
//    Loops are unrolled over the compile-time sizes.  0.847 ms at
//    box-box n = 491,520 f32 (15% of the bound; the shared variant 1.976 ms
//    in the same run; NVIDIA H100 80GB HBM3, 700.00 W, device time), with
//    122 registers; 8 and 32 lanes an instance and one thread an instance
//    measured 0.815, 1.109 and 1.151 ms.
//  * `sat_shared_kernel<T>`, the first design, for any other hulls: one
//    warp per instance, its lanes striding over the axes, the world hulls
//    in the warp's shared memory, the axes rebuilt for the reselect.
// Each argmax is a lane-local running argmax in ascending flat index, then
// a shuffle reduction on (value, flat index).
//
// Numerics follow mjtpu's jnp path (collision_convex._sat_winners_jnp) and
// the port's plain twin (mjtpu_torch.ops.sat.sat_winners_reference)
// operation by operation, in the same order: with axis-aligned boxes most
// axes tie exactly, and the winner decides the contact, so the build passes
// --fmad=false and nvcc contracts no multiply-add.  The reselect and its
// argmax read the very bits of the first pass (an axis kept, or one
// rebuilt by the same operations), so both variants equal the twin bit for
// bit.  The axis is divided by max(1e-12, |axis|), not multiplied by its
// inverse (the Pallas kernel multiplies); an axis with |axis| < 1e-6
// separates at -inf, chosen by a select, never by multiplying with a mask
// (-inf * 0 is NaN).  Argmax order: NaN first, as torch.argmax, then the
// larger value, then the lower flat index e1 * ne2 + e2.
//
// Interface: plain C entry points per dtype and variant, bound with
// ctypes.  Each launches on the given stream, allocates nothing, does not
// synchronize, and returns cudaGetLastError() after the launch (the static
// entry returns cudaErrorInvalidValue for hull sizes it has no
// instantiation of).

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct V3 {
  T x, y, z;
};

template <typename T>
__device__ __forceinline__ V3<T> load3(const T* p) {
  return {p[0], p[1], p[2]};
}

template <typename T>
__device__ __forceinline__ void store3(T* p, V3<T> v) {
  p[0] = v.x, p[1] = v.y, p[2] = v.z;
}

template <typename T>
__device__ __forceinline__ V3<T> sub(V3<T> a, V3<T> b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}

template <typename T>
__device__ __forceinline__ V3<T> add(V3<T> a, V3<T> b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}

// math.dot3: x + y + z in that order
template <typename T>
__device__ __forceinline__ T dot(V3<T> a, V3<T> b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

template <typename T>
__device__ __forceinline__ V3<T> cross(V3<T> a, V3<T> b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// math.mat_vec: row k of the row-major 3x3 m dotted with v
template <typename T>
__device__ __forceinline__ V3<T> mat_vec(const T* m, V3<T> v) {
  return {m[0] * v.x + m[1] * v.y + m[2] * v.z, m[3] * v.x + m[4] * v.y + m[5] * v.z,
          m[6] * v.x + m[7] * v.y + m[8] * v.z};
}

// torch.minimum / torch.maximum as PyTorch computes them on the card: a NaN
// in either propagates, else fmin / fmax, which order -0 below +0 (so a tie
// of signed zeros gives the twin's zero).  At f32 that is one instruction,
// min.NaN / max.NaN (sm_80 and later; the NaN is the canonical one)
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ double min_nan(double a, double b) {
  return a != a ? a : (b != b ? b : fmin(a, b));
}

__device__ __forceinline__ double max_nan(double a, double b) {
  return a != a ? a : (b != b ? b : fmax(a, b));
}

// (d, i) before (e, j) in torch.argmax's order: NaN first, then larger
// values, then the lower index
template <typename T>
__device__ __forceinline__ bool before(T d, int i, T e, int j) {
  const bool dn = d != d, en = e != e;
  if (dn || en) return dn && (!en || i < j);
  return d > e || (d == e && i < j);
}

// every lane ends with the first maximum of the (best, bi) of the W lanes
// of its group (W divides 32; every lane of the warp takes part)
template <int W = kWarp, typename T>
__device__ __forceinline__ void warp_argmax(T* best, int* bi) {
  for (int off = W / 2; off > 0; off /= 2) {
    const T ob = __shfl_xor_sync(kFull, *best, off, W);
    const int oi = __shfl_xor_sync(kFull, *bi, off, W);
    if (before(ob, oi, *best, *bi)) *best = ob, *bi = oi;
  }
}

// the edge-cross axis of directions a, b: divided by max(1e-12, |axis|)
// and oriented along cv by sign(axis . cv); |axis| (before the division)
// in *norm
template <typename T>
__device__ __forceinline__ V3<T> edge_axis(V3<T> a, V3<T> b, V3<T> cv, T* norm) {
  V3<T> ax = cross(a, b);
  const T sq = dot(ax, ax);
  const T n = sq == T(0) ? T(0) : sqrt(sq);
  const T den = n < T(1e-12) ? T(1e-12) : n;
  ax = {ax.x / den, ax.y / den, ax.z / den};
  const T o = dot(ax, cv);
  // torch.sign, (o > 0) - (o < 0): +0 for either zero and for NaN
  const T s = T(o > T(0)) - T(o < T(0));
  *norm = n;
  return {ax.x * s, ax.y * s, ax.z * s};
}

// the best face of one hull: per face, the min over the other hull's
// world vertices of n . v, minus the face offset; warp argmax over faces
template <typename T>
__device__ void face_winner(const T* nrm, const T* off, int nf, const T* w_other, int nv_other,
                            int lane, T* best, int* bi) {
  *best = T(-INFINITY);
  *bi = INT_MAX;
  for (int f = lane; f < nf; f += kWarp) {
    const V3<T> nn = load3(nrm + 3 * f);
    T minp = dot(load3(w_other), nn);
    for (int v = 1; v < nv_other; ++v) minp = min_nan(minp, dot(load3(w_other + 3 * v), nn));
    const T sep = minp - off[f];
    if (before(sep, f, *best, *bi)) *best = sep, *bi = f;
  }
  warp_argmax(best, bi);
}

template <typename T>
__device__ __forceinline__ V3<T> centroid(const T* w, int nv) {
  V3<T> c = load3(w);
  for (int v = 1; v < nv; ++v) c = add(c, load3(w + 3 * v));
  return {c.x / T(nv), c.y / T(nv), c.z / T(nv)};
}

// one hull's world tables in its warp's shared memory
template <typename T>
__device__ void world_hull(const T* pos, const T* mat, const T* vert, const T* fnorm,
                           const int* face0, const int* edge, int nv, int nf, int ne, int lane,
                           T* w, T* n, T* off, T* d, T* mid) {
  const V3<T> p = load3(pos);
  T r[9];
  for (int k = 0; k < 9; ++k) r[k] = mat[k];
  for (int v = lane; v < nv; v += kWarp) store3(w + 3 * v, add(p, mat_vec(r, load3(vert + 3 * v))));
  for (int f = lane; f < nf; f += kWarp) store3(n + 3 * f, mat_vec(r, load3(fnorm + 3 * f)));
  __syncwarp();
  for (int f = lane; f < nf; f += kWarp) off[f] = dot(load3(n + 3 * f), load3(w + 3 * face0[f]));
  for (int e = lane; e < ne; e += kWarp) {
    const V3<T> a = load3(w + 3 * edge[2 * e]), b = load3(w + 3 * edge[2 * e + 1]);
    store3(d + 3 * e, sub(b, a));
    const V3<T> s = add(a, b);
    store3(mid + 3 * e, V3<T>{T(0.5) * s.x, T(0.5) * s.y, T(0.5) * s.z});
  }
}

template <typename T>
__global__ void sat_shared_kernel(const T* __restrict__ pos1, const T* __restrict__ mat1,
                                   const T* __restrict__ pos2, const T* __restrict__ mat2,
                                   const T* __restrict__ vert1, const T* __restrict__ fnorm1,
                                   const int* __restrict__ face01, const int* __restrict__ edge1,
                                   const T* __restrict__ vert2, const T* __restrict__ fnorm2,
                                   const int* __restrict__ face02, const int* __restrict__ edge2,
                                   T* __restrict__ seps, int* __restrict__ idx, int n, int nv1,
                                   int nf1, int ne1, int nv2, int nf2, int ne2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const long inst = static_cast<long>(blockIdx.x) * blockDim.y + warp;
  if (inst >= n) return;  // whole warp leaves together: only __syncwarp below

  const int per_warp = 3 * (nv1 + nv2) + 4 * (nf1 + nf2) + 6 * (ne1 + ne2);
  T* w1 = reinterpret_cast<T*>(smem_raw) + static_cast<long>(warp) * per_warp;
  T* w2 = w1 + 3 * nv1;
  T* n1 = w2 + 3 * nv2;
  T* n2 = n1 + 3 * nf1;
  T* off1 = n2 + 3 * nf2;
  T* off2 = off1 + nf1;
  T* d1 = off2 + nf2;
  T* d2 = d1 + 3 * ne1;
  T* m1 = d2 + 3 * ne2;
  T* m2 = m1 + 3 * ne1;

  world_hull(pos1 + 3 * inst, mat1 + 9 * inst, vert1, fnorm1, face01, edge1, nv1, nf1, ne1, lane,
             w1, n1, off1, d1, m1);
  world_hull(pos2 + 3 * inst, mat2 + 9 * inst, vert2, fnorm2, face02, edge2, nv2, nf2, ne2, lane,
             w2, n2, off2, d2, m2);
  __syncwarp();

  T sep1, sep2;
  int bf1, bf2;
  face_winner(n1, off1, nf1, w2, nv2, lane, &sep1, &bf1);
  face_winner(n2, off2, nf2, w1, nv1, lane, &sep2, &bf2);

  // edge-cross axes, flat index e1 * ne2 + e2
  const V3<T> cv = sub(centroid(w2, nv2), centroid(w1, nv1));
  const int nax = ne1 * ne2;
  T best = T(-INFINITY);
  int be = INT_MAX;
  for (int a = lane; a < nax; a += kWarp) {
    const int e1 = a / ne2, e2 = a % ne2;
    T an;
    const V3<T> ax = edge_axis(load3(d1 + 3 * e1), load3(d2 + 3 * e2), cv, &an);
    T maxp1 = dot(load3(w1), ax);
    for (int v = 1; v < nv1; ++v) maxp1 = max_nan(maxp1, dot(load3(w1 + 3 * v), ax));
    T minp2 = dot(load3(w2), ax);
    for (int v = 1; v < nv2; ++v) minp2 = min_nan(minp2, dot(load3(w2 + 3 * v), ax));
    const T sep = an < T(1e-6) ? T(-INFINITY) : minp2 - maxp1;
    if (before(sep, a, best, be)) best = sep, be = a;
  }
  warp_argmax(&best, &be);

  // support reselect among the axes (near-)parallel to the winner, scored
  // by the edge midpoints
  T unused;
  const V3<T> axb = edge_axis(load3(d1 + 3 * (be / ne2)), load3(d2 + 3 * (be % ne2)), cv, &unused);
  T sbest = T(-INFINITY);
  int bp = INT_MAX;
  for (int a = lane; a < nax; a += kWarp) {
    const int e1 = a / ne2, e2 = a % ne2;
    T an;
    const V3<T> ax = edge_axis(load3(d1 + 3 * e1), load3(d2 + 3 * e2), cv, &an);
    const bool compat = dot(ax, axb) > T(1.0 - 1e-6) && an >= T(1e-6);
    const T score = dot(load3(m1 + 3 * e1), axb) - dot(load3(m2 + 3 * e2), axb);
    const T s = compat ? score : T(-INFINITY);
    if (before(s, a, sbest, bp)) sbest = s, bp = a;
  }
  warp_argmax(&sbest, &bp);

  if (lane == 0) {
    seps[3 * inst] = sep1;
    seps[3 * inst + 1] = sep2;
    seps[3 * inst + 2] = best;
    idx[4 * inst] = bf1;
    idx[4 * inst + 1] = bf2;
    idx[4 * inst + 2] = bp / ne2;
    idx[4 * inst + 3] = bp % ne2;
  }
}

template <typename T>
int launch_shared(const T* pos1, const T* mat1, const T* pos2, const T* mat2, const T* vert1,
           const T* fnorm1, const int* face01, const int* edge1, const T* vert2, const T* fnorm2,
           const int* face02, const int* edge2, T* seps, int* idx, int n, int nv1, int nf1,
           int ne1, int nv2, int nf2, int ne2, int warps_per_block, void* stream) {
  const size_t per_warp = 3 * (nv1 + nv2) + 4 * (nf1 + nf2) + 6 * (ne1 + ne2);
  const size_t smem = sizeof(T) * static_cast<size_t>(warps_per_block) * per_warp;
  cudaError_t err = cudaFuncSetAttribute(sat_shared_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kWarp, warps_per_block);
  const dim3 grid((n + warps_per_block - 1) / warps_per_block);
  sat_shared_kernel<T><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      pos1, mat1, pos2, mat2, vert1, fnorm1, face01, edge1, vert2, fnorm2, face02, edge2, seps,
      idx, n, nv1, nf1, ne1, nv2, nf2, ne2);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// the static variant: hull sizes fixed at compile time
// ---------------------------------------------------------------------------

constexpr int kLanes = 16;         // lanes per instance: two instances a warp
constexpr int kStaticThreads = 128;  // 8 instances a block
constexpr int kStaticInst = kStaticThreads / kLanes;

// one instance's tables in shared memory: world vertices (hull 1's, then
// hull 2's), edge directions and midpoints (hull 1's edges, then hull
// 2's), and the midpoints' dots with the winning axis
template <typename T, int NV, int NE>
struct StaticTables {
  T w[NV][3];
  T d[NE][3];
  T mid[NE][3];
  T md[NE];
};

template <typename T>
__device__ __forceinline__ V3<T> v3(const T (&a)[3]) {
  return {a[0], a[1], a[2]};
}

template <typename T, int NV1, int NF1, int NE1, int NV2, int NF2, int NE2>
__global__ void __launch_bounds__(kStaticThreads)
    sat_static_kernel(const T* __restrict__ pos1, const T* __restrict__ mat1,
                      const T* __restrict__ pos2, const T* __restrict__ mat2,
                      const T* __restrict__ vert1, const T* __restrict__ fnorm1,
                      const int* __restrict__ face01, const int* __restrict__ edge1,
                      const T* __restrict__ vert2, const T* __restrict__ fnorm2,
                      const int* __restrict__ face02, const int* __restrict__ edge2,
                      T* __restrict__ seps, int* __restrict__ idx, int n) {
  constexpr int NV = NV1 + NV2, NF = NF1 + NF2, NE = NE1 + NE2, NAX = NE1 * NE2;
  constexpr int K = (NAX + kLanes - 1) / kLanes;  // axes per lane
  __shared__ StaticTables<T, NV, NE> tables[kStaticInst];

  const int lane = threadIdx.x % kLanes;
  const int slot = threadIdx.x / kLanes;
  const long inst = static_cast<long>(blockIdx.x) * kStaticInst + slot;
  // an instance past n computes on the last one and stores nothing: every
  // lane stays for the shuffles
  const long ic = inst < n ? inst : static_cast<long>(n) - 1;
  StaticTables<T, NV, NE>& tb = tables[slot];
  const T* p1 = pos1 + 3 * ic;
  const T* r1 = mat1 + 9 * ic;
  const T* p2 = pos2 + 3 * ic;
  const T* r2 = mat2 + 9 * ic;

  // world vertices w = p + R v, one a lane
  for (int v = lane; v < NV; v += kLanes) {
    const bool first = v < NV1;
    const V3<T> local = first ? load3(vert1 + 3 * v) : load3(vert2 + 3 * (v - NV1));
    store3(tb.w[v], add(load3(first ? p1 : p2), mat_vec(first ? r1 : r2, local)));
  }
  __syncwarp();

  // every lane keeps both hulls' world vertices in registers
  V3<T> w[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) w[v] = v3(tb.w[v]);

  // edge directions b - a and midpoints 0.5 (a + b), one edge a lane
  for (int e = lane; e < NE; e += kLanes) {
    const bool first = e < NE1;
    const int* ed = first ? edge1 + 2 * e : edge2 + 2 * (e - NE1);
    const int base = first ? 0 : NV1;
    const V3<T> a = v3(tb.w[base + ed[0]]), b = v3(tb.w[base + ed[1]]);
    store3(tb.d[e], sub(b, a));
    const V3<T> s = add(a, b);
    store3(tb.mid[e], V3<T>{T(0.5) * s.x, T(0.5) * s.y, T(0.5) * s.z});
  }

  // face separations, one face a lane (hull 1's faces, then hull 2's): the
  // min over the other hull's vertices of n . v, minus n . (the face's
  // first vertex)
  T sep1 = T(-INFINITY), sep2 = T(-INFINITY);
  int bf1 = INT_MAX, bf2 = INT_MAX;
  for (int f = lane; f < NF; f += kLanes) {
    const bool first = f < NF1;
    const V3<T> nn = first ? mat_vec(r1, load3(fnorm1 + 3 * f))
                           : mat_vec(r2, load3(fnorm2 + 3 * (f - NF1)));
    const T off = first ? dot(nn, v3(tb.w[face01[f]])) : dot(nn, v3(tb.w[NV1 + face02[f - NF1]]));
    T minp;
    if (first) {
      minp = dot(w[NV1], nn);
#pragma unroll
      for (int v = NV1 + 1; v < NV; ++v) minp = min_nan(minp, dot(w[v], nn));
    } else {
      minp = dot(w[0], nn);
#pragma unroll
      for (int v = 1; v < NV1; ++v) minp = min_nan(minp, dot(w[v], nn));
    }
    const T sep = minp - off;
    if (first) {
      if (before(sep, f, sep1, bf1)) sep1 = sep, bf1 = f;
    } else if (before(sep, f - NF1, sep2, bf2)) {
      sep2 = sep, bf2 = f - NF1;
    }
  }
  warp_argmax<kLanes>(&sep1, &bf1);
  warp_argmax<kLanes>(&sep2, &bf2);
  __syncwarp();  // the edge tables are written

  // centroids, summed in vertex order
  V3<T> c1 = w[0], c2 = w[NV1];
#pragma unroll
  for (int v = 1; v < NV1; ++v) c1 = add(c1, w[v]);
#pragma unroll
  for (int v = NV1 + 1; v < NV; ++v) c2 = add(c2, w[v]);
  const V3<T> cv = sub(V3<T>{c2.x / T(NV2), c2.y / T(NV2), c2.z / T(NV2)},
                       V3<T>{c1.x / T(NV1), c1.y / T(NV1), c1.z / T(NV1)});

  // the lane's edge-cross axes a = lane + kLanes * k (flat index
  // e1 * NE2 + e2), each computed once and kept for the reselect
  V3<T> ax[K];
  T an[K];
  T best = T(-INFINITY);
  int be = INT_MAX;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int a = lane + kLanes * k;
    if (NAX % kLanes == 0 || a < NAX) {
      const int e1 = a / NE2, e2 = a % NE2;
      ax[k] = edge_axis(v3(tb.d[e1]), v3(tb.d[NE1 + e2]), cv, &an[k]);
      T maxp1 = dot(w[0], ax[k]);
#pragma unroll
      for (int v = 1; v < NV1; ++v) maxp1 = max_nan(maxp1, dot(w[v], ax[k]));
      T minp2 = dot(w[NV1], ax[k]);
#pragma unroll
      for (int v = NV1 + 1; v < NV; ++v) minp2 = min_nan(minp2, dot(w[v], ax[k]));
      const T sep = an[k] < T(1e-6) ? T(-INFINITY) : minp2 - maxp1;
      if (before(sep, a, best, be)) best = sep, be = a;
    } else {
      ax[k] = {T(0), T(0), T(0)};
      an[k] = T(0);
    }
  }
  warp_argmax<kLanes>(&best, &be);

  // the winning axis, from the lane that owns it
  const int owner = be % kLanes, owned = be / kLanes;
  V3<T> mine = ax[0];
#pragma unroll
  for (int k = 1; k < K; ++k) mine = owned == k ? ax[k] : mine;
  const V3<T> axb = {__shfl_sync(kFull, mine.x, owner, kLanes),
                     __shfl_sync(kFull, mine.y, owner, kLanes),
                     __shfl_sync(kFull, mine.z, owner, kLanes)};

  // support reselect among the axes (near-)parallel to the winner, scored
  // by the edge midpoints: mid1 . axb - mid2 . axb
  for (int e = lane; e < NE; e += kLanes) tb.md[e] = dot(v3(tb.mid[e]), axb);
  __syncwarp();
  T sbest = T(-INFINITY);
  int bp = INT_MAX;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int a = lane + kLanes * k;
    if (NAX % kLanes == 0 || a < NAX) {
      const int e1 = a / NE2, e2 = a % NE2;
      const bool compat = dot(ax[k], axb) > T(1.0 - 1e-6) && an[k] >= T(1e-6);
      const T score = tb.md[e1] - tb.md[NE1 + e2];
      const T s = compat ? score : T(-INFINITY);
      if (before(s, a, sbest, bp)) sbest = s, bp = a;
    }
  }
  warp_argmax<kLanes>(&sbest, &bp);

  if (inst < n) {
    if (lane < 3) seps[3 * inst + lane] = lane == 0 ? sep1 : (lane == 1 ? sep2 : best);
    if (lane < 4) {
      const int e = lane == 2 ? bp / NE2 : bp % NE2;
      idx[4 * inst + lane] = lane == 0 ? bf1 : (lane == 1 ? bf2 : e);
    }
  }
}

template <typename T, int NV1, int NF1, int NE1, int NV2, int NF2, int NE2>
int launch_static_sized(const T* pos1, const T* mat1, const T* pos2, const T* mat2,
                        const T* vert1, const T* fnorm1, const int* face01, const int* edge1,
                        const T* vert2, const T* fnorm2, const int* face02, const int* edge2,
                        T* seps, int* idx, int n, void* stream) {
  const dim3 grid((n + kStaticInst - 1) / kStaticInst);
  sat_static_kernel<T, NV1, NF1, NE1, NV2, NF2, NE2>
      <<<grid, kStaticThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          pos1, mat1, pos2, mat2, vert1, fnorm1, face01, edge1, vert2, fnorm2, face02, edge2,
          seps, idx, n);
  return static_cast<int>(cudaGetLastError());
}

// the hull sizes (nv, nf, ne) instantiated: a box, and humanoid_terrain's
// 6-vertex rock; ops/sat.py's STATIC_HULLS lists the same
#define MJTPU_SAT_HULLS(X) X(8, 6, 12) X(6, 8, 12)

template <typename T, int NV1, int NF1, int NE1>
int launch_static_second(const T* pos1, const T* mat1, const T* pos2, const T* mat2,
                         const T* vert1, const T* fnorm1, const int* face01, const int* edge1,
                         const T* vert2, const T* fnorm2, const int* face02, const int* edge2,
                         T* seps, int* idx, int n, int nv2, int nf2, int ne2, void* stream) {
#define MJTPU_SAT_CASE(NV, NF, NE)                                                            \
  if (nv2 == NV && nf2 == NF && ne2 == NE)                                                    \
    return launch_static_sized<T, NV1, NF1, NE1, NV, NF, NE>(pos1, mat1, pos2, mat2, vert1,   \
                                                             fnorm1, face01, edge1, vert2,    \
                                                             fnorm2, face02, edge2, seps, idx, \
                                                             n, stream);
  MJTPU_SAT_HULLS(MJTPU_SAT_CASE)
#undef MJTPU_SAT_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_static(const T* pos1, const T* mat1, const T* pos2, const T* mat2, const T* vert1,
                  const T* fnorm1, const int* face01, const int* edge1, const T* vert2,
                  const T* fnorm2, const int* face02, const int* edge2, T* seps, int* idx, int n,
                  int nv1, int nf1, int ne1, int nv2, int nf2, int ne2, void* stream) {
#define MJTPU_SAT_CASE(NV, NF, NE)                                                           \
  if (nv1 == NV && nf1 == NF && ne1 == NE)                                                   \
    return launch_static_second<T, NV, NF, NE>(pos1, mat1, pos2, mat2, vert1, fnorm1, face01, \
                                               edge1, vert2, fnorm2, face02, edge2, seps, idx, \
                                               n, nv2, nf2, ne2, stream);
  MJTPU_SAT_HULLS(MJTPU_SAT_CASE)
#undef MJTPU_SAT_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
}  // namespace

extern "C" {

int mjtpu_sat_shared_f32(const float* pos1, const float* mat1, const float* pos2,
                          const float* mat2, const float* vert1, const float* fnorm1,
                          const int* face01, const int* edge1, const float* vert2,
                          const float* fnorm2, const int* face02, const int* edge2, float* seps,
                          int* idx, int n, int nv1, int nf1, int ne1, int nv2, int nf2, int ne2,
                          int warps_per_block, void* stream) {
  return launch_shared<float>(pos1, mat1, pos2, mat2, vert1, fnorm1, face01, edge1, vert2, fnorm2,
                       face02, edge2, seps, idx, n, nv1, nf1, ne1, nv2, nf2, ne2,
                       warps_per_block, stream);
}

int mjtpu_sat_shared_f64(const double* pos1, const double* mat1, const double* pos2,
                          const double* mat2, const double* vert1, const double* fnorm1,
                          const int* face01, const int* edge1, const double* vert2,
                          const double* fnorm2, const int* face02, const int* edge2,
                          double* seps, int* idx, int n, int nv1, int nf1, int ne1, int nv2,
                          int nf2, int ne2, int warps_per_block, void* stream) {
  return launch_shared<double>(pos1, mat1, pos2, mat2, vert1, fnorm1, face01, edge1, vert2, fnorm2,
                        face02, edge2, seps, idx, n, nv1, nf1, ne1, nv2, nf2, ne2,
                        warps_per_block, stream);
}

int mjtpu_sat_static_f32(const float* pos1, const float* mat1, const float* pos2,
                         const float* mat2, const float* vert1, const float* fnorm1,
                         const int* face01, const int* edge1, const float* vert2,
                         const float* fnorm2, const int* face02, const int* edge2, float* seps,
                         int* idx, int n, int nv1, int nf1, int ne1, int nv2, int nf2, int ne2,
                         void* stream) {
  return launch_static<float>(pos1, mat1, pos2, mat2, vert1, fnorm1, face01, edge1, vert2, fnorm2,
                              face02, edge2, seps, idx, n, nv1, nf1, ne1, nv2, nf2, ne2, stream);
}

int mjtpu_sat_static_f64(const double* pos1, const double* mat1, const double* pos2,
                         const double* mat2, const double* vert1, const double* fnorm1,
                         const int* face01, const int* edge1, const double* vert2,
                         const double* fnorm2, const int* face02, const int* edge2, double* seps,
                         int* idx, int n, int nv1, int nf1, int ne1, int nv2, int nf2, int ne2,
                         void* stream) {
  return launch_static<double>(pos1, mat1, pos2, mat2, vert1, fnorm1, face01, edge1, vert2,
                               fnorm2, face02, edge2, seps, idx, n, nv1, nf1, ne1, nv2, nf2, ne2,
                               stream);
}

const char* mjtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
