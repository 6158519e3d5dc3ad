"""Convex narrowphase: spheres and capsules against convex hulls.

Port of mjtpu/_src/collision_convex.py (_hull_consts, _closest_on_face,
sphere_convex, capsule_convex), batched over every leading axis (here:
B envs x the group's pairs).  A group's pairs share one hull (the driver
groups mesh geoms by mesh id), whose tables the driver turns into tensors
once per model (``hull_consts``) and passes as ``hull2``.  The
differentiable-mode blends of mjtpu (_smooth_k) are not ported.  Outputs
are (dist (..., n), pos (..., n, 3), frame (..., n, 3, 3)) with the normal
from geom1 into geom2.  Convex-convex (SAT, kernel B3) waits for a later
slice.
"""

from __future__ import annotations

import torch

from mjtpu_torch._src import math
from mjtpu_torch._src.math import cross, dot3
from mjtpu_torch._src.types import ConvexMesh

# small preference for face axes over edge axes (numerical-tie stability)
_EDGE_TOL = 1e-10


def hull_consts(hull: ConvexMesh, dtype, device):
  """(vert (nv, 3), face_vert (nf, mfv, 3), face_normal (nf, 3),
  edge_v (ne, 2, 3)) as tensors."""
  t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
  return t(hull.vert), t(hull.vert[hull.face]), t(hull.face_normal), t(hull.vert[hull.edge])


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
  """x[..., i, :] per leading index: x (..., k, d), i (...) -> (..., d)."""
  return torch.gather(x, -2, i[..., None, None].expand(i.shape + (1, x.shape[-1])))[..., 0, :]


def _closest_on_face(face_verts, n, p):
  """Closest point to p on the polygon face_verts (..., mfv, 3) with
  normal n; p lies on (or near) the face plane."""
  a = face_verts
  b = torch.roll(face_verts, -1, dims=-2)
  edge_out = cross(b - a, n[..., None, :].expand(a.shape))
  # the interior is to the left of each CCW edge
  outside = dot3(p[..., None, :] - a, edge_out) > 0
  inside_all = ~torch.any(outside, dim=-1)
  seg_pts = math.closest_segment_point(a, b, p[..., None, :])
  diff = seg_pts - p[..., None, :]
  best = _take(seg_pts, torch.argmin(dot3(diff, diff), dim=-1))
  return torch.where(inside_all[..., None], p, best)


def sphere_convex(pos1, mat1, size1, pos2, mat2, size2, hull2):
  """Sphere vs convex hull (``hull2`` from hull_consts): the closest point
  of the deepest face."""
  r = size1[..., 0]
  _, face_vert, face_normal, _ = hull2
  c = math.mat_t_vec(mat2, pos1 - pos2)  # sphere centre in the hull frame

  d_f = dot3(face_normal, c[..., None, :] - face_vert[:, 0])  # (..., nf)
  f = torch.argmax(d_f, dim=-1)
  sep = torch.gather(d_f, -1, f[..., None])[..., 0]
  nf = face_normal[f]
  inside = sep < 0

  p_plane = c - sep[..., None] * nf
  closest = _closest_on_face(face_vert[f], nf, p_plane)
  dir_out, dist_c = math.normalize_with_norm(closest - c)
  # outside: along to_closest; inside: pushed out along the face normal
  n_local = torch.where(inside[..., None], nf, dir_out)
  dist = torch.where(inside, sep, dist_c) - r
  n_world = math.mat_vec(mat2, n_local)
  pos = pos1 + n_world * (r + 0.5 * dist)[..., None]
  return dist[..., None], pos[..., None, :], math.make_frame(n_world)[..., None, :, :]


def capsule_convex(pos1, mat1, size1, pos2, mat2, size2, hull2):
  """Capsule vs convex hull (``hull2`` from hull_consts): SAT over the face
  normals and the edge x segment axes; a face manifold by clipping the
  segment (2 points) or one edge contact."""
  r, h = size1[..., 0], size1[..., 1]
  vert, face_vert, face_normal, edge_v = hull2

  # the capsule segment in the hull's frame
  axis_l = math.mat_t_vec(mat2, mat1[..., :, 2])
  cen = math.mat_t_vec(mat2, pos1 - pos2)
  a = cen - h[..., None] * axis_l
  b = cen + h[..., None] * axis_l

  # face axes: separation of the segment beyond each face plane
  da = dot3(face_normal, a[..., None, :] - face_vert[:, 0])
  db = dot3(face_normal, b[..., None, :] - face_vert[:, 0])
  sep_face = torch.minimum(da, db) - r[..., None]
  bf = torch.argmax(sep_face, dim=-1)
  sep_face_best = torch.gather(sep_face, -1, bf[..., None])[..., 0]

  # edge-cross axes: cross(hull edge, segment), oriented from the hull's
  # centroid toward the capsule
  e_dirs = edge_v[:, 1] - edge_v[:, 0]
  axes = cross(e_dirs, (b - a)[..., None, :])                  # (..., ne, 3)
  axes_n = math.norm3(axes)
  axes = axes / torch.clamp_min(axes_n, 1e-12)[..., None]
  centroid = torch.mean(vert, dim=0)
  orient = dot3(axes, (cen - centroid)[..., None, :])
  axes = axes * torch.sign(orient)[..., None]
  # separation: min over the segment minus max over the hull, minus radius
  seg_min = torch.minimum(dot3(axes, a[..., None, :]), dot3(axes, b[..., None, :]))
  hull_max = torch.amax(torch.einsum("...ed,vd->...ev", axes, vert), dim=-1)
  sep_edge = seg_min - hull_max - r[..., None]
  sep_edge = torch.where(axes_n < 1e-9, -torch.inf, sep_edge)
  be = torch.argmax(sep_edge, dim=-1)
  # keep the winning separation before the support reselect below, which
  # may land on a degenerate axis whose sep_edge is the -inf sentinel
  best_edge_sep = torch.gather(sep_edge, -1, be[..., None])[..., 0]
  # parallel hull edges tie on the axis: the contact uses the support edge
  # along it, among the non-degenerate compatible axes
  n_best = _take(axes, be)
  compat = (dot3(axes, n_best[..., None, :]) > 1.0 - 1e-6) & (axes_n >= 1e-9)
  support = dot3(0.5 * (edge_v[:, 0] + edge_v[:, 1]), n_best[..., None, :])
  be = torch.argmax(torch.where(compat, support, -torch.inf), dim=-1)
  use_edge = best_edge_sep > sep_face_best + _EDGE_TOL

  # edge contact: closest points between the segment and the winning edge
  ev = edge_v[be]                                              # (..., 2, 3)
  pa, pb = math.closest_segment_to_segment_points(a, b, ev[..., 0, :], ev[..., 1, :])
  n_edge = _take(axes, be)
  d_edge = dot3(pa - pb, n_edge) - r
  p_edge = pa - n_edge * (r + 0.5 * d_edge)[..., None]

  # face contacts: clip the segment onto the face's side planes
  nf = face_normal[bf]
  fv = face_vert[bf]                                           # (..., mfv, 3)
  mfv = fv.shape[-2]
  t_lo, t_hi = torch.zeros_like(r), torch.ones_like(r)
  ab = b - a
  for k in range(mfv):
    p0, p1 = fv[..., k, :], fv[..., (k + 1) % mfv, :]
    edge_out = cross(p1 - p0, nf)  # outward side-plane normal
    num = dot3(p0 - a, edge_out)
    den = dot3(ab, edge_out)
    t_cross = num / torch.where(torch.abs(den) < 1e-12, 1e-12, den)
    entering = den < 0
    t_lo = torch.where(entering, torch.maximum(t_lo, t_cross), t_lo)
    t_hi = torch.where(~entering, torch.minimum(t_hi, t_cross), t_hi)
  degenerate = t_lo > t_hi
  t_mid = torch.clamp(0.5 * (t_lo + t_hi), 0.0, 1.0)
  t_lo = torch.where(degenerate, t_mid, torch.clamp(t_lo, 0.0, 1.0))
  t_hi = torch.where(degenerate, t_mid, torch.clamp(t_hi, 0.0, 1.0))

  ue = use_edge[..., None]
  dists, poss, frames = [], [], []
  for idx, t in enumerate((t_lo, t_hi)):
    p_seg = a + t[..., None] * ab
    d_face = dot3(nf, p_seg - fv[..., 0, :]) - r
    # the normal points from the capsule (geom1) into the hull (geom2)
    p_face = p_seg + (-nf) * (r + 0.5 * d_face)[..., None]
    p_use = torch.where(ue, p_edge, p_face)
    d_use = torch.where(use_edge, d_edge, d_face)
    n_use = torch.where(ue, -n_edge, -nf)
    if idx == 1:  # an edge contact takes one slot only
      d_use = torch.where(use_edge, 1.0, d_use)
    n_world = math.mat_vec(mat2, n_use)
    dists.append(d_use)
    poss.append(pos2 + math.mat_vec(mat2, p_use))
    frames.append(math.make_frame(n_world))
  return torch.stack(dists, -1), torch.stack(poss, -2), torch.stack(frames, -3)
