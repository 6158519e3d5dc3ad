"""Batched height-field surface manifolds: the Hopper kernel and its plain twin.

Port of mjtpu/ops/hfield.py (the Pallas kernel behind
collision_hfield._surface_manifold) and of the per-triangle functions of
mjtpu/_src/collision_hfield.py that its jnp path runs (_local_triangles,
_closest_on_triangle, _point_triangle, _segment_triangle, _select4).
``manifold_batch`` takes n height windows, each with one object (a sphere
centre, or a capsule segment), in the height field's local frame
(terrain up = +z), and returns the 4-point contact manifold of each:

  * on a CUDA tensor it launches a hand-written kernel in
    ``mjtpu_torch/csrc/hfield.cu``, built with nvcc for sm_90a at first use
    and bound with ctypes (``ops._build``).  Which one is a size dispatch
    (``variant``): a subgrid in ``STATIC_SUBGRIDS`` (humanoid_terrain's
    (2, 2)) takes the ``static`` kernel (the subgrid fixed at compile time,
    one thread per triangle, each triangle's terms built once in
    registers); any other subgrid takes the ``shared`` kernel (one warp per
    instance, the window in shared memory, the lanes striding over the
    triangles).  A build or launch failure, or a window past the kernels'
    static bound, raises; nothing falls back.
  * on a CPU tensor it runs the plain twin ``manifold_reference``.

Both follow mjtpu's jnp path operation by operation: the triangle order
(every (p00, p01, p11) triangle, row band by row band, then every
(p00, p11, p10) one) and the first-index argmin decide ties, so the twin
is written as plain elementwise operations in the kernel's order, and the
kernel is built with ``--fmad=false`` so that nvcc contracts no
multiply-add.  Selection: 4 rounds of argmin with near-duplicate
suppression (|p - p_chosen|^2 < 1e-10 -> +inf); a round whose minimum is
not finite gives dist = 1, pos = 0, normal = (0, 0, 1).

The wrapper has no backward: on the card it raises on an input that
requires grad while grad mode is on (``_build.refuse_grad``).  The
engine's seam is ``manifold_differentiable``: the kernel forward, the
twin's gradient backward (``_build.TwinGrad``).

``launches`` counts kernel launches (never twin calls), and
``variant_launches`` counts them by variant.
"""

from __future__ import annotations

import ctypes

import torch

from mjtpu_torch._src.math import closest_segment_point, cross, dot3, normalize_with_norm
from mjtpu_torch.ops import _build

# kernel launches since import (CPU calls and twin calls do not count),
# in all and by variant
launches = 0
variant_launches = {"static": 0, "shared": 0}

SOURCE = "hfield.cu"
EXTRA_FLAGS = ("--fmad=false",)
# mjtpu's cap on the subgrid half-extent (collision_hfield._MAX_HALF_CELLS)
MAX_HALF_CELLS = 8
SMEM_LIMIT = _build.SMEM_LIMIT
_MAX_WARPS_PER_BLOCK = 8
# the subgrids (hy, hx) the static kernel is instantiated for
# (csrc/hfield.cu's MJTPU_HFIELD_SUBGRIDS), and its threads a block
STATIC_SUBGRIDS = ((2, 2),)
STATIC_THREADS = 256


def num_triangles(hy: int, hx: int) -> int:
  return 2 * (2 * hy + 1) * (2 * hx + 1)


def variant(hy: int, hx: int) -> str:
  """The kernel a subgrid takes: "static" when it is instantiated
  (STATIC_SUBGRIDS), else "shared"."""
  return "static" if (hy, hx) in STATIC_SUBGRIDS else "shared"


def variants(hy: int, hx: int) -> tuple[str, ...]:
  """The kernels that can run a subgrid: the shared one always, the static
  one where it is instantiated."""
  return ("static", "shared") if variant(hy, hx) == "static" else ("shared",)


def launch_geometry(n: int, hy: int, hx: int, dtype: torch.dtype, kind: str | None = None):
  """(variant, blocks, threads a block, instances a block) of one launch
  over n instances, of ``kind`` or else of ``variant(hy, hx)``.  The static
  kernel gives each triangle a thread and a block as many whole instances
  as fit in its threads; the shared kernel puts one warp per instance and
  as many warps in a block as its shared memory allows, up to 8."""
  kind = kind or variant(hy, hx)
  if kind == "static":
    per_block, threads = STATIC_THREADS // num_triangles(hy, hx), STATIC_THREADS
  else:
    per_block = max(1, min(_MAX_WARPS_PER_BLOCK, SMEM_LIMIT // smem_per_warp(hy, hx, dtype)))
    threads = 32 * per_block
  return kind, -(-n // per_block), threads, per_block


def smem_per_warp(hy: int, hx: int, dtype: torch.dtype) -> int:
  """Shared memory one warp's instance takes: the (R, C) window and the
  T triangles' dist, pos and normal."""
  item = torch.empty((), dtype=dtype).element_size()
  return ((2 * hy + 2) * (2 * hx + 2) + 7 * num_triangles(hy, hx)) * item


# ---------------------------------------------------------------------------
# plain twin (mjtpu's jnp path, batched over n)
# ---------------------------------------------------------------------------


def _local_triangles(zwin, origin, dx: float, dy: float):
  """Vertices (a, b, c), each (n, T, 3), of the window's surface triangles:
  every cell split on its (00, 11) diagonal, all first triangles, then all
  second ones (argmin tie-breaking depends on this order)."""
  n, rr, cc = zwin.shape
  dtype, dev = zwin.dtype, zwin.device
  xs = origin[:, 0:1] + torch.arange(cc, dtype=dtype, device=dev) * dx  # (n, C)
  ys = origin[:, 1:2] + torch.arange(rr, dtype=dtype, device=dev) * dy  # (n, R)
  shape = (n, rr - 1, cc - 1)
  x0g, x1g = xs[:, None, :-1].expand(shape), xs[:, None, 1:].expand(shape)
  y0g, y1g = ys[:, :-1, None].expand(shape), ys[:, 1:, None].expand(shape)

  def pt(x, y, z):
    return torch.stack([x, y, z], dim=-1).reshape(n, -1, 3)

  p00, p01 = pt(x0g, y0g, zwin[:, :-1, :-1]), pt(x1g, y0g, zwin[:, :-1, 1:])
  p10, p11 = pt(x0g, y1g, zwin[:, 1:, :-1]), pt(x1g, y1g, zwin[:, 1:, 1:])
  return torch.cat([p00, p00], 1), torch.cat([p01, p11], 1), torch.cat([p11, p10], 1)


def _closest_on_triangle(a, b, c, p):
  """Closest point on triangle abc to p: the projection when it lies
  inside (tested with both windings), else the nearest of the three edge
  points (the first edge wins ties)."""
  n = normalize_with_norm(cross(b - a, c - a))[0]
  proj = p - dot3(p - a, n)[..., None] * n
  eab = dot3(cross(b - a, n), proj - a)
  ebc = dot3(cross(c - b, n), proj - b)
  eca = dot3(cross(a - c, n), proj - c)
  inside = ((eab <= 0) & (ebc <= 0) & (eca <= 0)) | ((eab >= 0) & (ebc >= 0) & (eca >= 0))
  e1 = closest_segment_point(a, b, p)
  e2 = closest_segment_point(b, c, p)
  e3 = closest_segment_point(c, a, p)
  d1, d2, d3 = dot3(e1 - p, e1 - p), dot3(e2 - p, e2 - p), dot3(e3 - p, e3 - p)
  use1 = (d1 <= d2) & (d1 <= d3)
  use2 = ~use1 & (d2 <= d3)
  edge = torch.where(use1[..., None], e1, torch.where(use2[..., None], e2, e3))
  return torch.where(inside[..., None], proj, edge)


def _point_triangle(a, b, c, p, r):
  """Signed sphere-triangle gap and normal (up = +z): the perpendicular
  depth when the projection is inside the triangle, else the distance to
  the nearest edge point."""
  n_tri = normalize_with_norm(cross(b - a, c - a))[0]
  n_tri = torch.where((n_tri[..., 2] < 0)[..., None], -n_tri, n_tri)
  sd = dot3(n_tri, p - a)
  proj = p - sd[..., None] * n_tri
  closest = _closest_on_triangle(a, b, c, p)
  inside = dot3(closest - proj, closest - proj) < 1e-16
  to_c, dc = normalize_with_norm(p - closest)
  up = torch.zeros_like(to_c)
  up[..., 2] = 1.0
  n_out = torch.where((dc < 1e-12)[..., None], up, to_c)
  dist = torch.where(inside, sd, dc) - r
  return dist, torch.where(inside[..., None], n_tri, n_out)


def _segment_triangle(a, b, c, pa, pb, r, has_axis: bool):
  """The object segment (pa, pb) (a sphere centre when not has_axis)
  against each triangle: (dist, pos, normal)."""
  if has_axis:
    # the segment point nearest the triangle, from the two candidates
    # closest to its ends
    s1 = closest_segment_point(pa, pb, _closest_on_triangle(a, b, c, pa))
    s2 = closest_segment_point(pa, pb, _closest_on_triangle(a, b, c, pb))
    c1b = _closest_on_triangle(a, b, c, s1)
    c2b = _closest_on_triangle(a, b, c, s2)
    d1, d2 = dot3(s1 - c1b, s1 - c1b), dot3(s2 - c2b, s2 - c2b)
    s = torch.where((d1 <= d2)[..., None], s1, s2)
  else:
    s = pa.expand(a.shape)
  dist, nrm = _point_triangle(a, b, c, s, r)
  return dist, s - nrm * (r + 0.5 * dist)[..., None], nrm


def _select4(dist, pos, nrm):
  """Top-4 distinct contacts by penetration: (dist (n, 4), pos (n, 4, 3),
  nrm (n, 4, 3))."""
  work = dist
  out_d, out_p, out_n = [], [], []
  empty_n = torch.zeros_like(nrm[:, 0])
  empty_n[:, 2] = 1.0
  for _ in range(4):
    i = torch.argmin(work, dim=1)
    di = torch.gather(work, 1, i[:, None])[:, 0]
    ok = torch.isfinite(di)
    take = lambda v: torch.gather(v, 1, i[:, None, None].expand(-1, 1, 3))[:, 0]
    pi = torch.where(ok[:, None], take(pos), 0.0)
    out_d.append(torch.where(ok, di, 1.0))
    out_p.append(pi)
    out_n.append(torch.where(ok[:, None], take(nrm), empty_n))
    diff = pos - pi[:, None]
    work = torch.where(dot3(diff, diff) < 1e-10, torch.inf, work)
  return torch.stack(out_d, 1), torch.stack(out_p, 1), torch.stack(out_n, 1)


def manifold_reference(zwin, origin, a, b, r, hy: int, hx: int, dx: float, dy: float,
                       has_axis: bool):
  """Plain PyTorch twin of the kernel (same arguments as manifold_batch)."""
  del hy, hx  # the window's shape carries them
  ta, tb, tc = _local_triangles(zwin, origin, dx, dy)
  dist, pos, nrm = _segment_triangle(ta, tb, tc, a[:, None], b[:, None], r[:, None], has_axis)
  return _select4(dist, pos, nrm)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


SIGNATURES = {
    f"mjtpu_hfield_{kind}_{suffix}": (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [real, real] + [ctypes.c_int]
        + ([ctypes.c_int] if kind == "shared" else []) + [ctypes.c_void_p], ctypes.c_int)
    for kind in ("static", "shared")
    for suffix, real in (("f32", ctypes.c_float), ("f64", ctypes.c_double))
}


def library() -> ctypes.CDLL:
  """Builds (at first use) and loads the kernel library."""
  return _build.library(SOURCE, EXTRA_FLAGS, SIGNATURES)


def _check(zwin, origin, a, b, r, hy: int, hx: int) -> None:
  if zwin.dtype not in (torch.float32, torch.float64) or any(
      x.dtype != zwin.dtype for x in (origin, a, b, r)):
    raise TypeError("manifold_batch takes float32 or float64 tensors of one dtype")
  n = zwin.shape[0]
  shapes = (zwin.shape, origin.shape, a.shape, b.shape, r.shape)
  want = ((n, 2 * hy + 2, 2 * hx + 2), (n, 2), (n, 3), (n, 3), (n,))
  if tuple(map(tuple, shapes)) != want:
    raise ValueError(f"manifold_batch takes shapes {want}, got {tuple(map(tuple, shapes))}")
  if any(x.device != zwin.device for x in (origin, a, b, r)):
    raise ValueError("manifold_batch takes tensors on one device")


def manifold_batch(zwin, origin, a, b, r, hy: int, hx: int, dx: float, dy: float,
                   has_axis: bool, *, kernel: str | None = None):
  """Batched surface manifold: zwin (n, R, C) local height windows
  (R = 2hy+2, C = 2hx+2), origin (n, 2) window (x0, y0), a/b (n, 3) object
  segment ends in the local frame (a == b for spheres), r (n,) radii.
  Returns (dist (n, 4), pos (n, 4, 3), nrm (n, 4, 3)) in the local frame.
  ``kernel`` names the variant to launch ("static" or "shared"; a test's
  choice, to hold both to the twin); None takes ``variant(hy, hx)``."""
  global launches
  _check(zwin, origin, a, b, r, hy, hx)
  kind = variant(hy, hx) if kernel is None else kernel
  if kind not in variants(hy, hx):
    raise ValueError(f"no {kind!r} hfield kernel for the subgrid ({hy}, {hx})")
  if zwin.device.type == "cpu":
    return manifold_reference(zwin, origin, a, b, r, hy, hx, dx, dy, has_axis)
  if zwin.device.type != "cuda":
    raise ValueError(f"manifold_batch runs on cuda or cpu, not {zwin.device}")
  _build.refuse_grad("hfield manifold", zwin, origin, a, b, r)
  if max(hy, hx) > MAX_HALF_CELLS or smem_per_warp(hy, hx, zwin.dtype) > SMEM_LIMIT:
    raise ValueError(
        f"subgrid (hy, hx) = ({hy}, {hx}) exceeds the kernel's static bound"
        f" ({MAX_HALF_CELLS} half cells, {SMEM_LIMIT} bytes of shared memory a block)")
  n = zwin.shape[0]
  dtype = zwin.dtype
  dist = torch.empty((n, 4), dtype=dtype, device=zwin.device)
  pos = torch.empty((n, 4, 3), dtype=dtype, device=zwin.device)
  nrm = torch.empty((n, 4, 3), dtype=dtype, device=zwin.device)
  if n == 0:
    return dist, pos, nrm
  args = [x.contiguous() for x in (zwin, origin, a, b, r)]
  lib = library()
  per_block = launch_geometry(n, hy, hx, dtype, kind)[3]
  fn = getattr(lib, f"mjtpu_hfield_{kind}_{'f64' if dtype == torch.float64 else 'f32'}")
  with torch.cuda.device(zwin.device):
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [x.data_ptr() for x in args] + [dist.data_ptr(), pos.data_ptr(), nrm.data_ptr(), n,
                                           hy, hx, float(dx), float(dy), int(has_axis)]
    err = fn(*ptrs, stream) if kind == "static" else fn(*ptrs, per_block, stream)
  _build.check_launch(lib, err, f"hfield ({kind})")
  launches += 1
  variant_launches[kind] += 1
  return dist, pos, nrm


def manifold_differentiable(zwin, origin, a, b, r, hy: int, hx: int, dx: float, dy: float,
                            has_axis: bool):
  """``manifold_batch`` with a backward (``_build.TwinGrad``): the kernel's
  manifold forward, the twin's gradient backward.  The engine's seam, in
  every mode."""
  static = (hy, hx, dx, dy, has_axis)
  return _build.TwinGrad.apply(lambda *t: manifold_batch(*t, *static),
                               lambda *t: manifold_reference(*t, *static),
                               zwin, origin, a, b, r)
