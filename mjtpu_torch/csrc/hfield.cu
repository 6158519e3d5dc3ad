// Batched height-field surface manifolds for NVIDIA Hopper (sm_90a).
//
// Replaces mjtpu/ops/hfield.py `_make_kernel(...).kernel` (the Pallas TPU
// kernel behind mjtpu/_src/collision_hfield._surface_manifold): for each
// instance i (one (env, pair) of a sphere or capsule against a height
// field), build the surface triangles of its (R, C) height window, test the
// object against each, and select a 4-point contact manifold.  Everything
// is in the height field's local frame (terrain up = +z); the caller
// gathers the window and maps the 4 winners back to world.
//
// What bounds it on this card: at the main path's size (hy = hx = 2: a 6x6
// window, T = 50 triangles) one capsule instance reads ~0.3 KB and needs
// ~29k floating-point operations (four closest-point-on-triangle tests per
// triangle, 584 operations a triangle), so arithmetic, not bytes, bounds
// it: 0.0214 ms at humanoid_terrain's n = 49,152 capsules, f32.  The first
// design (`hfield_shared_kernel`, kept for other subgrids) took 0.292 ms
// there (NVIDIA H100 80GB HBM3, 700.00 W, device time): it did about twice
// the operations the algorithm needs, since every closest-point test
// rebuilt the triangle's normal (a square root and three divisions) and
// its three edge cross products, and a fifth test repeated one of the
// first four; and one warp striding over 50 triangles left 14 of its 64
// lane slots idle.
//
// Two variants, chosen by the wrapper (ops/hfield.py) from the subgrid:
//  * `hfield_static_kernel<T, HY, HX, AXIS>` for (hy, hx) = (2, 2), the
//    main path's subgrid, spheres and capsules: one thread per triangle,
//    256 threads a block holding 5 instances' 50 triangles each (250 busy
//    lanes of 256); each thread builds its triangle's normal, edge vectors,
//    edge normals and clamped squared edge lengths once, in registers, and
//    every closest-point test reuses them; the capsule's fifth test is the
//    choice between the two it already made.  The windows are staged in
//    shared memory with coalesced loads; each triangle's (dist, pos,
//    normal) goes to shared memory, and one warp per instance selects.
//    0.144 ms at (2, 2) capsules n = 49,152 f32 (15% of the bound; the
//    shared variant 0.292 ms in the same run; NVIDIA H100 80GB HBM3,
//    700.00 W, device time), with 71 registers.
//  * `hfield_shared_kernel<T>`, the first design, for any other subgrid up
//    to mjtpu's cap of 8 half cells: one warp per instance, its lanes
//    striding over the triangles.
// Selection, in both: 4 rounds of a warp-shuffle argmin on (dist, index),
// each followed by a broadcast of the winner for the near-duplicate
// suppression.
//
// Numerics follow mjtpu's jnp path (and the port's plain twin,
// mjtpu_torch.ops.hfield.manifold_reference) operation by operation, in
// the same order: ties in the argmin decide which contacts are kept, so
// the build passes --fmad=false and nvcc contracts no multiply-add.  A term
// built once is the very value the twin builds again (the same operations
// on the same inputs), so both variants equal the twin bit for bit.
// Triangle order: every (p00, p01, p11) triangle, row band by row band and
// column by column, then every (p00, p11, p10) triangle; the first index
// wins a tie.  A NaN distance counts as the minimum, as in torch.argmin.
//
// Interface: plain C entry points per dtype and variant, bound with
// ctypes.  Each launches on the given stream, allocates nothing, does not
// synchronize, and returns cudaGetLastError() after the launch (the static
// entry returns cudaErrorInvalidValue for a subgrid it has no
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
__device__ __forceinline__ V3<T> sub(V3<T> a, V3<T> b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}

template <typename T>
__device__ __forceinline__ T dot(V3<T> a, V3<T> b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

template <typename T>
__device__ __forceinline__ V3<T> cross(V3<T> a, V3<T> b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

template <typename T>
__device__ __forceinline__ V3<T> sel(bool c, V3<T> a, V3<T> b) {
  return c ? a : b;
}

// math.normalize_with_norm: x / where(|x| == 0, 1, |x|), and |x|
template <typename T>
__device__ __forceinline__ V3<T> normalize(V3<T> v, T* norm) {
  const T sq = dot(v, v);
  const T n = sq == T(0) ? T(0) : sqrt(sq);
  const T nn = n == T(0) ? T(1) : n;
  *norm = n;
  return {v.x / nn, v.y / nn, v.z / nn};
}

// math.closest_segment_point: a + clip(t, 0, 1) * ab (NaN stays NaN)
template <typename T>
__device__ __forceinline__ V3<T> closest_segment_point(V3<T> a, V3<T> b, V3<T> p) {
  const V3<T> ab = sub(b, a);
  const T len2 = dot(ab, ab);
  T t = dot(sub(p, a), ab) / (len2 < T(1e-12) ? T(1e-12) : len2);
  t = t < T(0) ? T(0) : (t > T(1) ? T(1) : t);
  return {a.x + t * ab.x, a.y + t * ab.y, a.z + t * ab.z};
}

// collision_hfield._closest_on_triangle
template <typename T>
__device__ V3<T> closest_on_triangle(V3<T> a, V3<T> b, V3<T> c, V3<T> p) {
  T unused;
  const V3<T> n = normalize(cross(sub(b, a), sub(c, a)), &unused);
  const T sd = dot(sub(p, a), n);
  const V3<T> proj = {p.x - sd * n.x, p.y - sd * n.y, p.z - sd * n.z};
  const T eab = dot(cross(sub(b, a), n), sub(proj, a));
  const T ebc = dot(cross(sub(c, b), n), sub(proj, b));
  const T eca = dot(cross(sub(a, c), n), sub(proj, c));
  const bool inside = (eab <= T(0) && ebc <= T(0) && eca <= T(0)) ||
                      (eab >= T(0) && ebc >= T(0) && eca >= T(0));
  const V3<T> e1 = closest_segment_point(a, b, p);
  const V3<T> e2 = closest_segment_point(b, c, p);
  const V3<T> e3 = closest_segment_point(c, a, p);
  const T d1 = dot(sub(e1, p), sub(e1, p));
  const T d2 = dot(sub(e2, p), sub(e2, p));
  const T d3 = dot(sub(e3, p), sub(e3, p));
  const bool use1 = d1 <= d2 && d1 <= d3;
  const bool use2 = !use1 && d2 <= d3;
  return sel(inside, proj, sel(use1, e1, sel(use2, e2, e3)));
}

// collision_hfield._segment_triangle + _point_triangle (up = +z)
template <typename T>
__device__ void tri_test(V3<T> a, V3<T> b, V3<T> c, V3<T> pa, V3<T> pb, T r, bool has_axis,
                         T* dist_out, V3<T>* pos_out, V3<T>* nrm_out) {
  V3<T> s = pa;
  if (has_axis) {
    const V3<T> s1 = closest_segment_point(pa, pb, closest_on_triangle(a, b, c, pa));
    const V3<T> s2 = closest_segment_point(pa, pb, closest_on_triangle(a, b, c, pb));
    const V3<T> c1b = closest_on_triangle(a, b, c, s1);
    const V3<T> c2b = closest_on_triangle(a, b, c, s2);
    const T d1 = dot(sub(s1, c1b), sub(s1, c1b));
    const T d2 = dot(sub(s2, c2b), sub(s2, c2b));
    s = sel(d1 <= d2, s1, s2);
  }
  T unused;
  V3<T> n_tri = normalize(cross(sub(b, a), sub(c, a)), &unused);
  if (n_tri.z < T(0)) n_tri = {-n_tri.x, -n_tri.y, -n_tri.z};
  const T sd = dot(n_tri, sub(s, a));
  const V3<T> proj = {s.x - sd * n_tri.x, s.y - sd * n_tri.y, s.z - sd * n_tri.z};
  const V3<T> closest = closest_on_triangle(a, b, c, s);
  const bool inside = dot(sub(closest, proj), sub(closest, proj)) < T(1e-16);
  T dc;
  const V3<T> to_c = normalize(sub(s, closest), &dc);
  const V3<T> up = {T(0), T(0), T(1)};
  const V3<T> n_out = sel(dc < T(1e-12), up, to_c);
  const T dist = (inside ? sd : dc) - r;
  const V3<T> n = sel(inside, n_tri, n_out);
  const T k = r + T(0.5) * dist;
  *dist_out = dist;
  *pos_out = {s.x - n.x * k, s.y - n.y * k, s.z - n.z * k};
  *nrm_out = n;
}

// (d, i) before (e, j) in torch.argmin's order: NaN first, then smaller
// values, then the lower index
template <typename T>
__device__ __forceinline__ bool before(T d, int i, T e, int j) {
  const bool dn = d != d, en = e != e;
  if (dn || en) return dn && (!en || i < j);
  return d < e || (d == e && i < j);
}

// the 4-point manifold of one instance from its T triangles' (dist, pos,
// normal) in shared memory, by one warp: 4 rounds of argmin with
// near-duplicate suppression; d is overwritten
template <typename T>
__device__ void select4(T* d, const T* p, const T* nv, int ntri, int lane, long inst,
                        T* __restrict__ dist_out, T* __restrict__ pos_out,
                        T* __restrict__ nrm_out) {
  for (int k = 0; k < 4; ++k) {
    // this lane's first minimum over its triangles, then the warp's
    // (a lane without triangles holds (+inf, INT_MAX), which loses to any
    // real triangle; lane 0 always has one)
    T best = lane < ntri ? d[lane] : T(INFINITY);
    int bi = lane < ntri ? lane : INT_MAX;
    for (int t = lane + kWarp; t < ntri; t += kWarp) {
      if (before(d[t], t, best, bi)) best = d[t], bi = t;
    }
    for (int off = kWarp / 2; off > 0; off /= 2) {
      const T ob = __shfl_xor_sync(kFull, best, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      if (before(ob, oi, best, bi)) best = ob, bi = oi;
    }
    // every lane now holds the same (best, bi)
    const bool ok = isfinite(best);
    const T px = ok ? p[3 * bi] : T(0), py = ok ? p[3 * bi + 1] : T(0),
            pz = ok ? p[3 * bi + 2] : T(0);
    if (lane == 0) {
      dist_out[4 * inst + k] = ok ? best : T(1);
      T* po = pos_out + 12 * inst + 3 * k;
      T* no = nrm_out + 12 * inst + 3 * k;
      po[0] = px, po[1] = py, po[2] = pz;
      no[0] = ok ? nv[3 * bi] : T(0);
      no[1] = ok ? nv[3 * bi + 1] : T(0);
      no[2] = ok ? nv[3 * bi + 2] : T(1);
    }
    __syncwarp();
    // suppress the near-duplicates of the chosen point
    for (int t = lane; t < ntri; t += kWarp) {
      const T ex = p[3 * t] - px, ey = p[3 * t + 1] - py, ez = p[3 * t + 2] - pz;
      if (ex * ex + ey * ey + ez * ez < T(1e-10)) d[t] = INFINITY;
    }
    __syncwarp();
  }
}

template <typename T>
__global__ void hfield_shared_kernel(const T* __restrict__ zwin, const T* __restrict__ origin,
                                     const T* __restrict__ seg_a, const T* __restrict__ seg_b,
                                     const T* __restrict__ radius, T* __restrict__ dist_out,
                                     T* __restrict__ pos_out, T* __restrict__ nrm_out, int n,
                                     int hy, int hx, T dx, T dy, int has_axis) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const long inst = static_cast<long>(blockIdx.x) * blockDim.y + warp;
  if (inst >= n) return;  // whole warp leaves together: only __syncwarp below

  const int rr = 2 * hy + 2, cc = 2 * hx + 2;
  const int ncell = (rr - 1) * (cc - 1);
  const int ntri = 2 * ncell;
  T* z = reinterpret_cast<T*>(smem_raw) + static_cast<long>(warp) * (rr * cc + 7 * ntri);
  T* d = z + rr * cc;   // (T,) working distances
  T* p = d + ntri;      // (T, 3) contact positions
  T* nv = p + 3 * ntri; // (T, 3) normals

  const T* zsrc = zwin + inst * rr * cc;
  for (int e = lane; e < rr * cc; e += kWarp) z[e] = zsrc[e];
  __syncwarp();

  const T x0 = origin[2 * inst], y0 = origin[2 * inst + 1];
  const V3<T> pa = {seg_a[3 * inst], seg_a[3 * inst + 1], seg_a[3 * inst + 2]};
  const V3<T> pb = {seg_b[3 * inst], seg_b[3 * inst + 1], seg_b[3 * inst + 2]};
  const T r = radius[inst];

  for (int t = lane; t < ntri; t += kWarp) {
    const bool second = t >= ncell;
    const int cell = second ? t - ncell : t;
    const int row = cell / (cc - 1), col = cell % (cc - 1);
    const T xa = x0 + static_cast<T>(col) * dx, xb = x0 + static_cast<T>(col + 1) * dx;
    const T ya = y0 + static_cast<T>(row) * dy, yb = y0 + static_cast<T>(row + 1) * dy;
    const V3<T> p00 = {xa, ya, z[row * cc + col]};
    const V3<T> p01 = {xb, ya, z[row * cc + col + 1]};
    const V3<T> p10 = {xa, yb, z[(row + 1) * cc + col]};
    const V3<T> p11 = {xb, yb, z[(row + 1) * cc + col + 1]};
    T dist;
    V3<T> pos, nrm;
    if (second) {
      tri_test(p00, p11, p10, pa, pb, r, has_axis != 0, &dist, &pos, &nrm);
    } else {
      tri_test(p00, p01, p11, pa, pb, r, has_axis != 0, &dist, &pos, &nrm);
    }
    d[t] = dist;
    p[3 * t] = pos.x, p[3 * t + 1] = pos.y, p[3 * t + 2] = pos.z;
    nv[3 * t] = nrm.x, nv[3 * t + 1] = nrm.y, nv[3 * t + 2] = nrm.z;
  }
  __syncwarp();

  select4(d, p, nv, ntri, lane, inst, dist_out, pos_out, nrm_out);
}

template <typename T>
int launch_shared(const T* zwin, const T* origin, const T* a, const T* b, const T* r, T* dist,
                  T* pos, T* nrm, int n, int hy, int hx, T dx, T dy, int has_axis,
                  int warps_per_block, void* stream) {
  const int ntri = 2 * (2 * hy + 1) * (2 * hx + 1);
  const size_t smem =
      sizeof(T) * static_cast<size_t>(warps_per_block) * ((2 * hy + 2) * (2 * hx + 2) + 7 * ntri);
  cudaError_t err = cudaFuncSetAttribute(hfield_shared_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kWarp, warps_per_block);
  const dim3 grid((n + warps_per_block - 1) / warps_per_block);
  hfield_shared_kernel<T><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      zwin, origin, a, b, r, dist, pos, nrm, n, hy, hx, dx, dy, has_axis);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// the static variant: the subgrid fixed at compile time, a thread a triangle
// ---------------------------------------------------------------------------

constexpr int kStaticThreads = 256;

// one triangle's terms, each built once: its vertices, its edges b - a,
// c - b and a - c, its unit normal normalize(cross(b - a, c - a)), the
// in-plane edge normals cross(edge, n), and the squared edge lengths
// floored at 1e-12 (the closest_segment_point denominators)
template <typename T>
struct Tri {
  V3<T> a, b, c, ab, bc, ca, n, nab, nbc, nca;
  T lab, lbc, lca;
};

template <typename T>
__device__ __forceinline__ T floor_len2(V3<T> e) {
  const T len2 = dot(e, e);
  return len2 < T(1e-12) ? T(1e-12) : len2;
}

template <typename T>
__device__ __forceinline__ Tri<T> make_tri(V3<T> a, V3<T> b, V3<T> c) {
  Tri<T> t;
  t.a = a, t.b = b, t.c = c;
  t.ab = sub(b, a), t.bc = sub(c, b), t.ca = sub(a, c);
  T unused;
  t.n = normalize(cross(t.ab, sub(c, a)), &unused);
  t.nab = cross(t.ab, t.n), t.nbc = cross(t.bc, t.n), t.nca = cross(t.ca, t.n);
  t.lab = floor_len2(t.ab), t.lbc = floor_len2(t.bc), t.lca = floor_len2(t.ca);
  return t;
}

// closest_segment_point(a, a + e, p) with rel = p - a and len2 = the
// floored |e|^2
template <typename T>
__device__ __forceinline__ V3<T> segment_point(V3<T> a, V3<T> e, T len2, V3<T> rel) {
  T t = dot(rel, e) / len2;
  t = t < T(0) ? T(0) : (t > T(1) ? T(1) : t);
  return {a.x + t * e.x, a.y + t * e.y, a.z + t * e.z};
}

// closest_on_triangle on the triangle's built terms
template <typename T>
__device__ V3<T> closest_on_tri(const Tri<T>& t, V3<T> p) {
  const V3<T> pa = sub(p, t.a);
  const T sd = dot(pa, t.n);
  const V3<T> proj = {p.x - sd * t.n.x, p.y - sd * t.n.y, p.z - sd * t.n.z};
  const T eab = dot(t.nab, sub(proj, t.a));
  const T ebc = dot(t.nbc, sub(proj, t.b));
  const T eca = dot(t.nca, sub(proj, t.c));
  const bool inside = (eab <= T(0) && ebc <= T(0) && eca <= T(0)) ||
                      (eab >= T(0) && ebc >= T(0) && eca >= T(0));
  const V3<T> e1 = segment_point(t.a, t.ab, t.lab, pa);
  const V3<T> e2 = segment_point(t.b, t.bc, t.lbc, sub(p, t.b));
  const V3<T> e3 = segment_point(t.c, t.ca, t.lca, sub(p, t.c));
  const T d1 = dot(sub(e1, p), sub(e1, p));
  const T d2 = dot(sub(e2, p), sub(e2, p));
  const T d3 = dot(sub(e3, p), sub(e3, p));
  const bool use1 = d1 <= d2 && d1 <= d3;
  const bool use2 = !use1 && d2 <= d3;
  return sel(inside, proj, sel(use1, e1, sel(use2, e2, e3)));
}

template <typename T, int HY, int HX, bool AXIS>
__global__ void __launch_bounds__(kStaticThreads)
    hfield_static_kernel(const T* __restrict__ zwin, const T* __restrict__ origin,
                         const T* __restrict__ seg_a, const T* __restrict__ seg_b,
                         const T* __restrict__ radius, T* __restrict__ dist_out,
                         T* __restrict__ pos_out, T* __restrict__ nrm_out, int n, T dx, T dy) {
  constexpr int RR = 2 * HY + 2, CC = 2 * HX + 2, NCELL = (RR - 1) * (CC - 1), NT = 2 * NCELL;
  constexpr int PER_BLOCK = kStaticThreads / NT;  // instances a block
  static_assert(PER_BLOCK >= 1 && PER_BLOCK <= kStaticThreads / kWarp,
                "a block holds every triangle of an instance and a warp for each");
  __shared__ T z[PER_BLOCK * RR * CC];
  __shared__ T d[PER_BLOCK][NT];
  __shared__ T p[PER_BLOCK][3 * NT];
  __shared__ T nv[PER_BLOCK][3 * NT];

  const long first = static_cast<long>(blockIdx.x) * PER_BLOCK;
  const int count = static_cast<int>(n - first < PER_BLOCK ? n - first : PER_BLOCK);
  // the block's windows are contiguous: one coalesced copy
  const T* zsrc = zwin + first * RR * CC;
  for (int e = threadIdx.x; e < count * RR * CC; e += kStaticThreads) z[e] = zsrc[e];
  __syncthreads();

  const int slot = threadIdx.x / NT, t = threadIdx.x % NT;
  if (slot < count) {
    const long inst = first + slot;
    const bool second = t >= NCELL;
    const int cell = second ? t - NCELL : t;
    const int row = cell / (CC - 1), col = cell % (CC - 1);
    const T x0 = origin[2 * inst], y0 = origin[2 * inst + 1];
    const T xa = x0 + static_cast<T>(col) * dx, xb = x0 + static_cast<T>(col + 1) * dx;
    const T ya = y0 + static_cast<T>(row) * dy, yb = y0 + static_cast<T>(row + 1) * dy;
    const T* zw = z + slot * RR * CC;
    const V3<T> p00 = {xa, ya, zw[row * CC + col]};
    const V3<T> p01 = {xb, ya, zw[row * CC + col + 1]};
    const V3<T> p10 = {xa, yb, zw[(row + 1) * CC + col]};
    const V3<T> p11 = {xb, yb, zw[(row + 1) * CC + col + 1]};
    // (p00, p01, p11) or (p00, p11, p10): the vertices chosen first, so that
    // a warp holding both kinds builds its triangles together
    const Tri<T> tri = make_tri(p00, sel(second, p11, p01), sel(second, p10, p11));
    const V3<T> pa = {seg_a[3 * inst], seg_a[3 * inst + 1], seg_a[3 * inst + 2]};
    const T r = radius[inst];

    // the object point s nearest the triangle and the triangle's point
    // closest to it
    V3<T> s = pa, closest;
    if (AXIS) {
      const V3<T> pb = {seg_b[3 * inst], seg_b[3 * inst + 1], seg_b[3 * inst + 2]};
      const V3<T> axis = sub(pb, pa);
      const T len2 = floor_len2(axis);
      const V3<T> s1 = segment_point(pa, axis, len2, sub(closest_on_tri(tri, pa), pa));
      const V3<T> s2 = segment_point(pa, axis, len2, sub(closest_on_tri(tri, pb), pa));
      const V3<T> c1b = closest_on_tri(tri, s1);
      const V3<T> c2b = closest_on_tri(tri, s2);
      const T d1 = dot(sub(s1, c1b), sub(s1, c1b));
      const T d2 = dot(sub(s2, c2b), sub(s2, c2b));
      s = sel(d1 <= d2, s1, s2);
      closest = sel(d1 <= d2, c1b, c2b);  // closest_on_tri(tri, s), already made
    } else {
      closest = closest_on_tri(tri, s);
    }

    // _point_triangle at s (up = +z)
    const V3<T> n_tri = tri.n.z < T(0) ? V3<T>{-tri.n.x, -tri.n.y, -tri.n.z} : tri.n;
    const T sd = dot(n_tri, sub(s, tri.a));
    const V3<T> proj = {s.x - sd * n_tri.x, s.y - sd * n_tri.y, s.z - sd * n_tri.z};
    const bool inside = dot(sub(closest, proj), sub(closest, proj)) < T(1e-16);
    T dc;
    const V3<T> to_c = normalize(sub(s, closest), &dc);
    const V3<T> up = {T(0), T(0), T(1)};
    const V3<T> n_out = sel(dc < T(1e-12), up, to_c);
    const T dist = (inside ? sd : dc) - r;
    const V3<T> nrm = sel(inside, n_tri, n_out);
    const T k = r + T(0.5) * dist;
    d[slot][t] = dist;
    p[slot][3 * t] = s.x - nrm.x * k, p[slot][3 * t + 1] = s.y - nrm.y * k;
    p[slot][3 * t + 2] = s.z - nrm.z * k;
    nv[slot][3 * t] = nrm.x, nv[slot][3 * t + 1] = nrm.y, nv[slot][3 * t + 2] = nrm.z;
  }
  __syncthreads();

  const int warp = threadIdx.x / kWarp;
  if (warp < count) {
    select4(d[warp], p[warp], nv[warp], NT, threadIdx.x % kWarp, first + warp, dist_out, pos_out,
            nrm_out);
  }
}

template <typename T, int HY, int HX, bool AXIS>
int launch_static_sized(const T* zwin, const T* origin, const T* a, const T* b, const T* r,
                        T* dist, T* pos, T* nrm, int n, T dx, T dy, void* stream) {
  constexpr int per_block = kStaticThreads / (2 * (2 * HY + 1) * (2 * HX + 1));
  const dim3 grid((n + per_block - 1) / per_block);
  hfield_static_kernel<T, HY, HX, AXIS><<<grid, kStaticThreads, 0,
                                          static_cast<cudaStream_t>(stream)>>>(
      zwin, origin, a, b, r, dist, pos, nrm, n, dx, dy);
  return static_cast<int>(cudaGetLastError());
}

// the subgrids (hy, hx) instantiated: humanoid_terrain's (2, 2);
// ops/hfield.py's STATIC_SUBGRIDS lists the same
#define MJTPU_HFIELD_SUBGRIDS(X) X(2, 2)

template <typename T>
int launch_static(const T* zwin, const T* origin, const T* a, const T* b, const T* r, T* dist,
                  T* pos, T* nrm, int n, int hy, int hx, T dx, T dy, int has_axis,
                  void* stream) {
#define MJTPU_HFIELD_CASE(HY, HX)                                                              \
  if (hy == HY && hx == HX) {                                                                  \
    return has_axis ? launch_static_sized<T, HY, HX, true>(zwin, origin, a, b, r, dist, pos,   \
                                                           nrm, n, dx, dy, stream)             \
                    : launch_static_sized<T, HY, HX, false>(zwin, origin, a, b, r, dist, pos,  \
                                                            nrm, n, dx, dy, stream);           \
  }
  MJTPU_HFIELD_SUBGRIDS(MJTPU_HFIELD_CASE)
#undef MJTPU_HFIELD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int mjtpu_hfield_shared_f32(const float* zwin, const float* origin, const float* a,
                            const float* b, const float* r, float* dist, float* pos, float* nrm,
                            int n, int hy, int hx, float dx, float dy, int has_axis,
                            int warps_per_block, void* stream) {
  return launch_shared<float>(zwin, origin, a, b, r, dist, pos, nrm, n, hy, hx, dx, dy, has_axis,
                       warps_per_block, stream);
}

int mjtpu_hfield_shared_f64(const double* zwin, const double* origin, const double* a,
                            const double* b, const double* r, double* dist, double* pos,
                            double* nrm, int n, int hy, int hx, double dx, double dy,
                            int has_axis, int warps_per_block, void* stream) {
  return launch_shared<double>(zwin, origin, a, b, r, dist, pos, nrm, n, hy, hx, dx, dy, has_axis,
                        warps_per_block, stream);
}

int mjtpu_hfield_static_f32(const float* zwin, const float* origin, const float* a,
                            const float* b, const float* r, float* dist, float* pos, float* nrm,
                            int n, int hy, int hx, float dx, float dy, int has_axis,
                            void* stream) {
  return launch_static<float>(zwin, origin, a, b, r, dist, pos, nrm, n, hy, hx, dx, dy, has_axis,
                              stream);
}

int mjtpu_hfield_static_f64(const double* zwin, const double* origin, const double* a,
                            const double* b, const double* r, double* dist, double* pos,
                            double* nrm, int n, int hy, int hx, double dx, double dy,
                            int has_axis, void* stream) {
  return launch_static<double>(zwin, origin, a, b, r, dist, pos, nrm, n, hy, hx, dx, dy,
                               has_axis, stream);
}

const char* mjtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
