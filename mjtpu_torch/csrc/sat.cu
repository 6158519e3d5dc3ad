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
// and needs ~18k floating-point operations (144 axes, each a cross
// product, a norm, a division, an orientation and 16 vertex projections),
// so arithmetic, not bytes, bounds it.  What the design does about that:
// one warp per instance, its lanes striding over the 144 axes (and over
// vertices and faces while the world hulls are built), the world vertices,
// face normals and offsets, edge directions and midpoints staged once in
// the warp's shared memory and read from there by every axis; each argmax
// is a warp shuffle on (value, flat index); the winning axis is rebuilt by
// every lane from its index (the same operations give the same bits) for
// the support reselect.  Many warps per block and per SM hide the latency
// of the dependent chain of one axis.
//
// Numerics follow mjtpu's jnp path (collision_convex._sat_winners_jnp) and
// the port's plain twin (mjtpu_torch.ops.sat.sat_winners_reference)
// operation by operation, in the same order: with axis-aligned boxes most
// axes tie exactly, and the winner decides the contact, so the build passes
// --fmad=false and nvcc contracts no multiply-add.  The axis is divided by
// max(1e-12, |axis|), not multiplied by its inverse (the Pallas kernel
// multiplies); an axis with |axis| < 1e-6 separates at -inf, chosen by a
// select, never by multiplying with a mask (-inf * 0 is NaN).  Argmax order:
// NaN first, as torch.argmax, then the larger value, then the lower flat
// index e1 * ne2 + e2.
//
// Interface: a plain C entry point per dtype, bound with ctypes.  It
// launches on the given stream, allocates nothing, does not synchronize,
// and returns cudaGetLastError() after the launch.

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

// torch.minimum / torch.maximum: a NaN in either propagates
template <typename T>
__device__ __forceinline__ T min_nan(T a, T b) {
  return (b != b || b < a) ? b : a;
}

template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  return (b != b || b > a) ? b : a;
}

// (d, i) before (e, j) in torch.argmax's order: NaN first, then larger
// values, then the lower index
template <typename T>
__device__ __forceinline__ bool before(T d, int i, T e, int j) {
  const bool dn = d != d, en = e != e;
  if (dn || en) return dn && (!en || i < j);
  return d > e || (d == e && i < j);
}

// every lane ends with the warp's first maximum of its lanes' (best, bi)
template <typename T>
__device__ __forceinline__ void warp_argmax(T* best, int* bi) {
  for (int off = kWarp / 2; off > 0; off /= 2) {
    const T ob = __shfl_xor_sync(kFull, *best, off);
    const int oi = __shfl_xor_sync(kFull, *bi, off);
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
  const T s = o > T(0) ? T(1) : (o < T(0) ? T(-1) : o);  // torch.sign (0 and NaN pass)
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
__global__ void sat_winners_kernel(const T* __restrict__ pos1, const T* __restrict__ mat1,
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
int launch(const T* pos1, const T* mat1, const T* pos2, const T* mat2, const T* vert1,
           const T* fnorm1, const int* face01, const int* edge1, const T* vert2, const T* fnorm2,
           const int* face02, const int* edge2, T* seps, int* idx, int n, int nv1, int nf1,
           int ne1, int nv2, int nf2, int ne2, int warps_per_block, void* stream) {
  const size_t per_warp = 3 * (nv1 + nv2) + 4 * (nf1 + nf2) + 6 * (ne1 + ne2);
  const size_t smem = sizeof(T) * static_cast<size_t>(warps_per_block) * per_warp;
  cudaError_t err = cudaFuncSetAttribute(sat_winners_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kWarp, warps_per_block);
  const dim3 grid((n + warps_per_block - 1) / warps_per_block);
  sat_winners_kernel<T><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      pos1, mat1, pos2, mat2, vert1, fnorm1, face01, edge1, vert2, fnorm2, face02, edge2, seps,
      idx, n, nv1, nf1, ne1, nv2, nf2, ne2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int mjtpu_sat_winners_f32(const float* pos1, const float* mat1, const float* pos2,
                          const float* mat2, const float* vert1, const float* fnorm1,
                          const int* face01, const int* edge1, const float* vert2,
                          const float* fnorm2, const int* face02, const int* edge2, float* seps,
                          int* idx, int n, int nv1, int nf1, int ne1, int nv2, int nf2, int ne2,
                          int warps_per_block, void* stream) {
  return launch<float>(pos1, mat1, pos2, mat2, vert1, fnorm1, face01, edge1, vert2, fnorm2,
                       face02, edge2, seps, idx, n, nv1, nf1, ne1, nv2, nf2, ne2,
                       warps_per_block, stream);
}

int mjtpu_sat_winners_f64(const double* pos1, const double* mat1, const double* pos2,
                          const double* mat2, const double* vert1, const double* fnorm1,
                          const int* face01, const int* edge1, const double* vert2,
                          const double* fnorm2, const int* face02, const int* edge2,
                          double* seps, int* idx, int n, int nv1, int nf1, int ne1, int nv2,
                          int nf2, int ne2, int warps_per_block, void* stream) {
  return launch<double>(pos1, mat1, pos2, mat2, vert1, fnorm1, face01, edge1, vert2, fnorm2,
                        face02, edge2, seps, idx, n, nv1, nf1, ne1, nv2, nf2, ne2,
                        warps_per_block, stream);
}

const char* mjtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
