"""Ray casting against geoms (mj_ray / mj_rayGeom).

Port of mjtpu/_src/ray.py, batch-explicit.  The intersectors work in the
geom's local frame on the trailing axes of their arguments and return the
smallest non-negative ray parameter t, or +inf on a miss; ``ray_geom``
takes a world pose.  ``ray`` casts B rays (one per env) through the
scene; ``cast`` casts S rays per env at once, each with its own static
candidate geoms (a rangefinder excludes its own body's): one (B, S, G_t)
computation per geom type over the candidates G_t of that type that any
ray has, the results put back in ascending geom id before the argmin, so
that the lowest geom id wins a tie, as ``jnp.argmin`` picks it in mjtpu.
Height fields have no intersector, in mjtpu neither: put_model refuses a
rangefinder that could see one.
"""

from __future__ import annotations

import numpy as np
import torch

from mjtpu_torch._src import math
from mjtpu_torch._src.types import Data, GeomType, Model, cached, rows as env_rows

_INF = float("inf")


def _quad(a, b, c):
  """Smallest non-negative root of a t^2 + 2 b t + c = 0, else inf."""
  det = b * b - a * c
  big = torch.abs(a) > 1e-15
  ok = (det >= 0) & big
  # a miss's root is never taken: its gradient is 0 (mjtpu's NaN, ROADMAP C22)
  sdet = math.sqrt0(torch.clamp_min(det, 0.0))
  den = torch.where(big, a, 1e-15)
  t0 = (-b - sdet) / den
  t1 = (-b + sdet) / den
  t = torch.where(t0 >= 0, t0, torch.where(t1 >= 0, t1, _INF))
  return torch.where(ok, t, _INF)


def _ray_plane(size, lp, lv):
  small = torch.abs(lv[..., 2]) < 1e-15
  t = -lp[..., 2] / torch.where(small, 1e-15, lv[..., 2])
  p = lp + t[..., None] * lv
  valid = (t >= 0) & (torch.abs(lv[..., 2]) > 1e-15)
  valid = valid & ((size[..., 0] <= 0) | (torch.abs(p[..., 0]) <= size[..., 0]))
  valid = valid & ((size[..., 1] <= 0) | (torch.abs(p[..., 1]) <= size[..., 1]))
  return torch.where(valid, t, _INF)


def _ray_sphere(size, lp, lv):
  r = size[..., 0]
  return _quad(math.dot3(lv, lv), math.dot3(lp, lv), math.dot3(lp, lp) - r * r)


def _side(size, lp, lv):
  """The lateral surface of a z-axis cylinder of radius size[0], its
  height clipped to |z| <= size[1]."""
  r, h = size[..., 0], size[..., 1]
  a = lv[..., 0] * lv[..., 0] + lv[..., 1] * lv[..., 1]
  b = lp[..., 0] * lv[..., 0] + lp[..., 1] * lv[..., 1]
  c = lp[..., 0] * lp[..., 0] + lp[..., 1] * lp[..., 1] - r * r
  t = _quad(a, b, c)
  z = lp[..., 2] + t * lv[..., 2]
  return torch.where(torch.abs(z) <= h, t, _INF)


def _ray_capsule(size, lp, lv):
  r, h = size[..., 0], size[..., 1]
  t_best = _side(size, lp, lv)
  for sgn in (-1.0, 1.0):  # the end caps
    lpc = torch.cat([lp[..., :2], (lp[..., 2] - sgn * h)[..., None]], dim=-1)
    t = _quad(math.dot3(lv, lv), math.dot3(lpc, lv), math.dot3(lpc, lpc) - r * r)
    zc = lpc[..., 2] + t * lv[..., 2]
    t_best = torch.minimum(t_best, torch.where(zc * sgn >= 0, t, _INF))
  return t_best


def _ray_ellipsoid(size, lp, lv):
  s = 1.0 / size
  p, v = lp * s, lv * s
  return _quad(math.dot3(v, v), math.dot3(p, v), math.dot3(p, p) - 1.0)


def _ray_cylinder(size, lp, lv):
  r, h = size[..., 0], size[..., 1]
  t_best = _side(size, lp, lv)
  small = torch.abs(lv[..., 2]) < 1e-15
  for sgn in (-1.0, 1.0):  # the flat disks
    t = (sgn * h - lp[..., 2]) / torch.where(small, 1e-15, lv[..., 2])
    p = lp + t[..., None] * lv
    ok = ((t >= 0) & (p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1] <= r * r)
          & (torch.abs(lv[..., 2]) > 1e-15))
    t_best = torch.minimum(t_best, torch.where(ok, t, _INF))
  return t_best


def _ray_box(size, lp, lv):
  t_best = None
  for axis in range(3):
    small = torch.abs(lv[..., axis]) < 1e-15
    denom = torch.where(small, 1e-15, lv[..., axis])
    o1, o2 = (axis + 1) % 3, (axis + 2) % 3
    for sgn in (-1.0, 1.0):
      t = (sgn * size[..., axis] - lp[..., axis]) / denom
      p = lp + t[..., None] * lv
      ok = ((t >= 0) & (torch.abs(lv[..., axis]) > 1e-15)
            & (torch.abs(p[..., o1]) <= size[..., o1]) & (torch.abs(p[..., o2]) <= size[..., o2]))
      t = torch.where(ok, t, _INF)
      t_best = t if t_best is None else torch.minimum(t_best, t)
  return t_best


def _ray_triangles(tris, lp, lv):
  """Möller-Trumbore over a triangle soup tris (..., T, 3, 3): the least t.
  A degenerate triangle (all zeros, the padding of a shorter mesh) never
  hits."""
  va, vb, vc = tris[..., 0, :], tris[..., 1, :], tris[..., 2, :]
  e1, e2 = vb - va, vc - va
  lp, lv = lp[..., None, :], lv[..., None, :]
  h = math.cross(lv, e2)
  det = math.dot3(e1, h)
  inv = 1.0 / torch.where(torch.abs(det) < 1e-15, 1e-15, det)
  s = lp - va
  u = math.dot3(s, h) * inv
  q = math.cross(s, e1)
  v = math.dot3(lv, q) * inv
  t = math.dot3(e2, q) * inv
  ok = (torch.abs(det) > 1e-15) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t >= 0)
  return torch.amin(torch.where(ok, t, _INF), dim=-1)


_RAY_FUNC = {
    GeomType.PLANE: _ray_plane,
    GeomType.SPHERE: _ray_sphere,
    GeomType.CAPSULE: _ray_capsule,
    GeomType.ELLIPSOID: _ray_ellipsoid,
    GeomType.CYLINDER: _ray_cylinder,
    GeomType.BOX: _ray_box,
}


def ray_geom(pos, mat, size, pnt, vec, geomtype, mesh_tris=None) -> torch.Tensor:
  """Ray against geoms of one type at their world poses pos (..., 3), mat
  (..., 3, 3) with sizes size (..., 3): the distance along ``vec`` from
  ``pnt`` or inf, over the broadcast leading axes.  A mesh takes its
  triangles mesh_tris (..., T, 3, 3) in the geom's frame."""
  lp = math.mat_t_vec(mat, pnt - pos)
  lv = math.mat_t_vec(mat, vec)
  if geomtype == GeomType.MESH:
    return _ray_triangles(mesh_tris, lp, lv)
  return _RAY_FUNC[GeomType(geomtype)](size, lp, lv)


def candidate_geoms(m: Model, geomgroup, flg_static: bool, bodyexclude: int) -> np.ndarray:
  """The geoms a ray may hit, in ascending id (mjtpu's host filter): not
  on ``bodyexclude``, not static unless ``flg_static``, in an enabled
  ``geomgroup`` (None: all groups)."""
  ids = []
  for g in range(m.ngeom):
    b = int(m.geom_bodyid[g])
    if b == bodyexclude:
      continue
    if not flg_static and int(m.body_weldid[b]) == 0:
      continue
    if geomgroup is not None and not geomgroup[min(max(int(m.geom_group[g]), 0), 5)]:
      continue
    ids.append(g)
  return np.array(ids, dtype=np.int64)


def _mesh_triangles(m: Model, geoms: np.ndarray) -> torch.Tensor:
  """(G, T, 3, 3) triangles of each mesh geom in its frame, padded with
  all-zero triangles to the largest face count."""
  tris = []
  for g in geoms:
    mid = int(m.geom_dataid[g])
    fa, fn = int(m.mesh_faceadr[mid]), int(m.mesh_facenum[mid])
    faces = np.asarray(m.mesh_face)[fa:fa + fn]
    tris.append(np.asarray(m.mesh_vert, dtype=np.float64)[int(m.mesh_vertadr[mid]) + faces])
  out = np.zeros((len(tris), max(len(t) for t in tris), 3, 3))
  for i, t in enumerate(tris):
    out[i, :len(t)] = t
  return torch.as_tensor(out, dtype=m.dtype, device=m.device)


def _plan(m: Model, candidates: tuple[tuple[int, ...], ...]):
  """The static work of casting S rays with these candidate lists: the
  union of candidates in ascending id (a tensor), and per geom type
  (type, its geoms (G_t,), (S, G_t) candidate mask, mesh triangles or
  None), with the permutation that puts the types' columns back in
  ascending geom id."""

  def build():
    union = np.array(sorted(set().union(*map(set, candidates))), dtype=np.int64)
    types = np.asarray(m.geom_type)[union]
    t = lambda x, dtype=torch.long: torch.as_tensor(x, dtype=dtype, device=m.device)
    groups, order = [], []
    for gt in sorted(set(int(x) for x in types)):
      cols = np.nonzero(types == gt)[0]
      geoms = union[cols]
      mask = np.array([[g in set(c) for g in geoms] for c in candidates])
      tris = _mesh_triangles(m, geoms) if gt == GeomType.MESH else None
      groups.append((GeomType(gt), t(geoms), t(mask, torch.bool), tris))
      order.append(cols)
    perm = np.argsort(np.concatenate(order)) if order else np.zeros(0, np.int64)
    return t(union), groups, t(perm)

  return cached(m, ("ray.plan", candidates), build)


def cast(m: Model, d: Data, pnt: torch.Tensor, vec: torch.Tensor,
         candidates: tuple[tuple[int, ...], ...]):
  """Casts S rays per env: pnt and vec (B, S, 3), ray s against the geoms
  ``candidates[s]``.  Returns (dist (B, S), geom_id (B, S) int32), both -1
  where a ray hits nothing."""
  union, groups, perm = _plan(m, candidates)
  B, S = pnt.shape[:2]
  if not len(union):
    return (pnt.new_full((B, S), -1.0),
            torch.full((B, S), -1, dtype=torch.int32, device=pnt.device))
  dists = []
  for gt, geoms, mask, tris in groups:
    pos, mat = d.geom_xpos[:, None, geoms], d.geom_xmat[:, None, geoms]
    t = ray_geom(pos, mat, env_rows(m, "geom_size")[:, None, geoms], pnt[:, :, None],
                 vec[:, :, None], gt, tris)
    dists.append(torch.where(mask, t, _INF))
  dists = torch.cat(dists, dim=-1)[..., perm]  # (B, S, union) in ascending geom id
  best = torch.argmin(dists, dim=-1)
  dist = torch.gather(dists, -1, best[..., None])[..., 0]
  hit = torch.isfinite(dist)
  return (torch.where(hit, dist, -1.0),
          torch.where(hit, union[best], -1).to(torch.int32))


def ray(m: Model, d: Data, pnt: torch.Tensor, vec: torch.Tensor, geomgroup=None,
        flg_static: bool = True, bodyexclude: int = -1):
  """Casts one ray per env through the scene (mj_ray): pnt and vec (B, 3).
  Returns (dist (B,), geom_id (B,) int32), both -1 where nothing is hit."""
  group = None if geomgroup is None else tuple(bool(g) for g in geomgroup)
  cands = (tuple(int(g) for g in candidate_geoms(m, group, flg_static, bodyexclude)),)
  dist, geom = cast(m, d, pnt[:, None], vec[:, None], cands)
  return dist[:, 0], geom[:, 0]
