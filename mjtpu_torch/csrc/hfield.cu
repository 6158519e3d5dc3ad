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
// triangle; this code does about twice that, since it recomputes each
// triangle's normal and edge terms in every test and makes a fifth test),
// so arithmetic, not bytes, bounds it.  What the design does
// about that: one warp per instance, its lanes striding over the T
// triangles so that 32 triangles are tested at once, the window staged in
// shared memory (read R*C times per instance from there, once from device
// memory), each triangle's dist/pos/normal kept in the warp's shared
// memory, and each of the 4 selection rounds a warp-shuffle argmin on
// (dist, index) followed by a broadcast of the winner for the
// near-duplicate suppression.  Many warps per block and per SM hide the
// latency of the dependent chain of one triangle test.
//
// Numerics follow mjtpu's jnp path (and the port's plain twin,
// mjtpu_torch.ops.hfield.manifold_reference) operation by operation, in
// the same order: ties in the argmin decide which contacts are kept, so
// the build passes --fmad=false and nvcc contracts no multiply-add.
// Triangle order: every (p00, p01, p11) triangle, row band by row band and
// column by column, then every (p00, p11, p10) triangle; the first index
// wins a tie.  A NaN distance counts as the minimum, as in torch.argmin.
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

template <typename T>
__global__ void hfield_manifold_kernel(const T* __restrict__ zwin, const T* __restrict__ origin,
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
int launch(const T* zwin, const T* origin, const T* a, const T* b, const T* r, T* dist, T* pos,
           T* nrm, int n, int hy, int hx, T dx, T dy, int has_axis, int warps_per_block,
           void* stream) {
  const int ntri = 2 * (2 * hy + 1) * (2 * hx + 1);
  const size_t smem =
      sizeof(T) * static_cast<size_t>(warps_per_block) * ((2 * hy + 2) * (2 * hx + 2) + 7 * ntri);
  cudaError_t err = cudaFuncSetAttribute(hfield_manifold_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kWarp, warps_per_block);
  const dim3 grid((n + warps_per_block - 1) / warps_per_block);
  hfield_manifold_kernel<T><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      zwin, origin, a, b, r, dist, pos, nrm, n, hy, hx, dx, dy, has_axis);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int mjtpu_hfield_manifold_f32(const float* zwin, const float* origin, const float* a,
                              const float* b, const float* r, float* dist, float* pos,
                              float* nrm, int n, int hy, int hx, float dx, float dy,
                              int has_axis, int warps_per_block, void* stream) {
  return launch<float>(zwin, origin, a, b, r, dist, pos, nrm, n, hy, hx, dx, dy, has_axis,
                       warps_per_block, stream);
}

int mjtpu_hfield_manifold_f64(const double* zwin, const double* origin, const double* a,
                              const double* b, const double* r, double* dist, double* pos,
                              double* nrm, int n, int hy, int hx, double dx, double dy,
                              int has_axis, int warps_per_block, void* stream) {
  return launch<double>(zwin, origin, a, b, r, dist, pos, nrm, n, hy, hx, dx, dy, has_axis,
                        warps_per_block, stream);
}

const char* mjtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
