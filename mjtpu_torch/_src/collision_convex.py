"""Convex narrowphase: planes, spheres, capsules and hulls against hulls.

Port of mjtpu/_src/collision_convex.py (_hull_consts, plane_convex,
_closest_on_face, sphere_convex, capsule_convex, _manifold_points, the
seam _sat_winners and convex_convex), batched over every leading axis
(here: B envs x the group's pairs).  A group's pairs share their hulls
(collision_driver groups mesh geoms by mesh id and boxes by exact size),
whose tables collision_driver turns into tensors once per model
(``hull_consts``) and passes as ``hull1``/``hull2``.  Under
``differentiable_mode(smooth_collisions=True)`` the case switches blend
by a sigmoid of their margin (``diff_config.smooth_k``), as in mjtpu.  Outputs are
(dist (..., n), pos (..., n, 3), frame (..., n, 3, 3)) with the normal
from geom1 into geom2.  Convex-convex finds its SAT winners through
kernel B3 (``ops.sat``) on the whole (B x npair) batch, in every mode,
through its differentiable seam; the manifold clipping stays plain torch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mjtpu_torch._src import math
from mjtpu_torch._src.diff_config import smooth_k
from mjtpu_torch._src.math import cross, dot3
from mjtpu_torch._src.types import ConvexMesh

# small preference for face axes over edge axes (numerical-tie stability)
_EDGE_TOL = 1e-10


def _renorm(n):
  return n / torch.clamp_min(math.norm3(n), 1e-12)[..., None]


class HullConsts(NamedTuple):
  """One hull's tables as tensors (model constants)."""

  vert: torch.Tensor         # (nv, 3)
  face_vert: torch.Tensor    # (nf, mfv, 3)
  face_normal: torch.Tensor  # (nf, 3)
  edge_v: torch.Tensor       # (ne, 2, 3)
  face: torch.Tensor         # (nf, mfv) long
  edge: torch.Tensor         # (ne, 2) long
  sat: "object"              # ops.sat.SatHull: kernel B3's tables


def hull_consts(hull: ConvexMesh, dtype, device) -> HullConsts:
  """The tensors of one hull, built once per model."""
  from mjtpu_torch.ops import sat

  t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
  i = lambda x: torch.as_tensor(x, dtype=torch.long, device=device)
  return HullConsts(t(hull.vert), t(hull.vert[hull.face]), t(hull.face_normal),
                    t(hull.vert[hull.edge]), i(hull.face), i(hull.edge),
                    sat.sat_hull(hull, dtype, device))


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
  """x[..., i, :] per leading index: x (..., k, d), i (...) -> (..., d)."""
  return torch.gather(x, -2, i[..., None, None].expand(i.shape + (1, x.shape[-1])))[..., 0, :]


def _take_face(f: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
  """f[..., i, :, :] per leading index: f (..., nf, m, 3), i (...) -> (..., m, 3)."""
  return torch.gather(f, -3, i[..., None, None, None].expand(i.shape + (1,) + f.shape[-2:]))[
      ..., 0, :, :]


def _world(pos, mat, local):
  """pos + mat @ local for local points (k, 3): (..., k, 3)."""
  return pos[..., None, :] + math.mat_vec(mat[..., None, :, :], local)


def plane_convex(pos1, mat1, size1, pos2, mat2, size2, hull2: HullConsts):
  """Plane vs convex hull: contacts at the 4 deepest vertices (a stable
  sort, as jnp.argsort, so equal heights keep the vertex order)."""
  n = mat1[..., :, 2]
  vert = _world(pos2, mat2, hull2.vert)                          # (..., nv, 3)
  support = dot3(vert - pos1[..., None, :], n[..., None, :])     # height above the plane
  idx = torch.argsort(support, dim=-1, stable=True)[..., :4]
  dist = torch.gather(support, -1, idx)
  pos = torch.gather(vert, -2, idx[..., None].expand(idx.shape + (3,))) \
      - 0.5 * dist[..., None] * n[..., None, :]
  frame = math.make_frame(n)[..., None, :, :].expand(dist.shape + (3, 3))
  return dist, pos, frame


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
  k = smooth_k()
  if k is None:
    return torch.where(inside_all[..., None], p, best)
  # the signed outside margin in length units (> 0 outside a side plane)
  e_hat = edge_out / torch.clamp_min(math.norm3(edge_out), 1e-12)[..., None]
  margin = torch.amax(dot3(p[..., None, :] - a, e_hat), dim=-1)
  return math.sigmoid_blend(-margin, p, best, k)


def sphere_convex(pos1, mat1, size1, pos2, mat2, size2, hull2):
  """Sphere vs convex hull (``hull2`` from hull_consts): the closest point
  of the deepest face."""
  r = size1[..., 0]
  face_vert, face_normal = hull2.face_vert, hull2.face_normal
  c = math.mat_t_vec(mat2, pos1 - pos2)  # sphere centre in the hull frame

  d_f = dot3(face_normal, c[..., None, :] - face_vert[:, 0])  # (..., nf)
  f = torch.argmax(d_f, dim=-1)
  k0 = smooth_k()
  if k0 is None:
    sep = torch.gather(d_f, -1, f[..., None])[..., 0]
    nf = face_normal[f]
  else:
    # a soft face max: the hard argmax kinks at face ties (box edges and
    # corners); softmax weights keep sep and the normal smooth across them
    w = torch.softmax(k0 * d_f, dim=-1)
    sep = torch.sum(w * d_f, dim=-1)
    nf = _renorm(w @ face_normal)
  inside = sep < 0

  p_plane = c - sep[..., None] * nf
  closest = _closest_on_face(face_vert[f], nf, p_plane)
  dir_out, dist_c = math.normalize_with_norm(closest - c)
  # outside: along to_closest; inside: pushed out along the face normal
  k = smooth_k()
  if k is None:
    n_local = torch.where(inside[..., None], nf, dir_out)
    dist = torch.where(inside, sep, dist_c) - r
  else:
    n_local = _renorm(math.sigmoid_blend(-sep, nf, dir_out, k))
    dist = math.sigmoid_blend(-sep, sep, dist_c, k) - r
  n_world = math.mat_vec(mat2, n_local)
  pos = pos1 + n_world * (r + 0.5 * dist)[..., None]
  return dist[..., None], pos[..., None, :], math.make_frame(n_world)[..., None, :, :]


def capsule_convex(pos1, mat1, size1, pos2, mat2, size2, hull2):
  """Capsule vs convex hull (``hull2`` from hull_consts): SAT over the face
  normals and the edge x segment axes; a face manifold by clipping the
  segment (2 points) or one edge contact."""
  r, h = size1[..., 0], size1[..., 1]
  vert, face_vert, face_normal, edge_v = hull2[:4]

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
  k = smooth_k()
  s_edge = best_edge_sep - sep_face_best  # > 0: the edge case wins
  dists, poss, frames = [], [], []
  for idx, t in enumerate((t_lo, t_hi)):
    p_seg = a + t[..., None] * ab
    d_face = dot3(nf, p_seg - fv[..., 0, :]) - r
    # the normal points from the capsule (geom1) into the hull (geom2)
    p_face = p_seg + (-nf) * (r + 0.5 * d_face)[..., None]
    if k is None or idx == 1:
      p_use = torch.where(ue, p_edge, p_face)
      d_use = torch.where(use_edge, d_edge, d_face)
      n_use = torch.where(ue, -n_edge, -nf)
    else:
      p_use = math.sigmoid_blend(s_edge, p_edge, p_face, k)
      d_use = math.sigmoid_blend(s_edge, d_edge, d_face, k)
      n_use = _renorm(math.sigmoid_blend(s_edge, -n_edge, -nf, k))
    if idx == 1:  # an edge contact takes one slot only
      d_use = torch.where(use_edge, 1.0, d_use)
    n_world = math.mat_vec(mat2, n_use)
    dists.append(d_use)
    poss.append(pos2 + math.mat_vec(mat2, p_use))
    frames.append(math.make_frame(n_world))
  return torch.stack(dists, -1), torch.stack(poss, -2), torch.stack(frames, -3)


def _manifold_points(pts, mask, depth, n):
  """Up to 4 well-spread valid points of pts (..., K, 3): (idx (..., 4),
  dup (..., 4) bool); dup marks a slot that repeats an already selected
  (or coincident) point, which the caller deactivates."""
  big_neg = -1e10

  def exclude_near(score, chosen):
    for cp in chosen:
      diff = pts - cp[..., None, :]
      score = torch.where(dot3(diff, diff) < 1e-12, big_neg, score)
    return score

  at = lambda x, i: torch.gather(x, -1, i[..., None])[..., 0]
  i0 = torch.argmax(torch.where(mask, -depth, big_neg), dim=-1)  # deepest first
  p0 = _take(pts, i0)
  diff = pts - p0[..., None, :]
  d1 = exclude_near(torch.where(mask, dot3(diff, diff), big_neg), [p0])
  i1 = torch.argmax(d1, dim=-1)
  p1 = _take(pts, i1)
  dup1 = at(d1, i1) <= 0

  area = dot3(cross(diff, (p1 - p0)[..., None, :]), n[..., None, :])
  s2 = exclude_near(torch.where(mask, torch.abs(area), big_neg), [p0, p1])
  i2 = torch.argmax(s2, dim=-1)
  p2 = _take(pts, i2)
  dup2 = at(s2, i2) <= 1e-12

  area2 = dot3(cross(diff, (p2 - p0)[..., None, :]), n[..., None, :])
  sign = torch.sign(at(area, i2))
  s3 = exclude_near(torch.where(mask, -sign[..., None] * area2, big_neg), [p0, p1, p2])
  i3 = torch.argmax(s3, dim=-1)
  dup3 = at(s3, i3) <= 1e-12

  idx = torch.stack([i0, i1, i2, i3], dim=-1)
  dup = torch.stack([torch.zeros_like(dup1), dup1, dup2, dup3], dim=-1)
  return idx, dup


def _sat_winners(pos1, mat1, pos2, mat2, hull1: HullConsts, hull2: HullConsts):
  """SAT winners of every pair: (seps (..., 3), idx (..., 4) int32).  The
  whole (B x npair) batch goes to ops.sat.sat_winners_differentiable
  (kernel B3 on the card, its twin on the CPU), always; its seps carry
  the twin's gradient, which the differentiable-mode blends read."""
  from mjtpu_torch.ops import sat

  lead = pos1.shape[:-1]
  seps, idx = sat.sat_winners_differentiable(
      pos1.reshape(-1, 3), mat1.reshape(-1, 3, 3), pos2.reshape(-1, 3), mat2.reshape(-1, 3, 3),
      hull1.sat, hull2.sat)
  return seps.reshape(lead + (3,)), idx.reshape(lead + (4,))


def _face_manifold(ref_face, ref_n, inc_faces, inc_normals):
  """Clips the incident face (the most anti-parallel of inc_faces
  (..., nf, mfv_i, 3)) against the side planes of ref_face (..., mfv_r, 3)
  with normal ref_n: (dist (..., 4), pos (..., 4, 3))."""
  inc_i = torch.argmin(dot3(inc_normals, ref_n[..., None, :]), dim=-1)
  inc = _take_face(inc_faces, inc_i)                                       # (..., mfv_i, 3)
  ra = ref_face
  side_n = cross(torch.roll(ra, -1, dims=-2) - ra, ref_n[..., None, :].expand(ra.shape))

  def inside(p, a, side):
    """p (..., k, 3) inside every side plane (a, side (..., m, 3))."""
    gap = dot3(p[..., :, None, :] - a[..., None, :, :], side[..., None, :, :])
    return torch.all(gap <= 1e-10, dim=-1)

  # (a) incident vertices inside all side planes
  cands, masks = [inc], [inside(inc, ra, side_n)]
  # (b) incident edge x side plane intersections, edge k outer, plane s inner
  p0 = inc[..., :, None, :]
  seg = (torch.roll(inc, -1, dims=-2) - inc)[..., :, None, :]             # (..., mfv_i, 1, 3)
  sn = side_n[..., None, :, :]                                             # (..., 1, mfv_r, 3)
  den = dot3(seg, sn)
  t = dot3(ra[..., None, :, :] - p0, sn) / torch.where(torch.abs(den) < 1e-12, 1e-12, den)
  p = (p0 + t[..., None] * seg).flatten(-3, -2)
  ok = ((t > 0) & (t < 1) & (torch.abs(den) > 1e-12)).flatten(-2)
  cands.append(p)
  masks.append(ok & inside(p, ra, side_n))
  # (c) reference vertices projected onto the incident plane along ref_n
  inc_n = _take(inc_normals, inc_i)
  iside_n = cross(torch.roll(inc, -1, dims=-2) - inc, inc_n[..., None, :].expand(inc.shape))
  cos = dot3(ref_n, inc_n)
  t = dot3(inc[..., 0:1, :] - ra, inc_n[..., None, :]) / torch.clamp_min(
      torch.abs(cos), 1e-12)[..., None] * torch.sign(cos)[..., None]
  p = ra + t[..., None] * ref_n[..., None, :]
  cands.append(p)
  masks.append(inside(p, inc, iside_n))

  pts, msk = torch.cat(cands, dim=-2), torch.cat(masks, dim=-1)
  # every candidate lies on the incident surface, so the gap is its height
  # above the reference plane
  depth = dot3(pts - ref_face[..., 0:1, :], ref_n[..., None, :])
  idx, dup = _manifold_points(pts, msk & (depth < 1e9), depth, ref_n)
  sel_p = torch.gather(pts, -2, idx[..., None].expand(idx.shape + (3,)))
  sel_d = torch.gather(depth, -1, idx)
  sel_valid = torch.gather(msk, -1, idx) & ~dup
  sel_d = torch.where(sel_valid, sel_d, 1.0)  # deactivate invalid and duplicate slots
  return sel_d, sel_p - 0.5 * sel_d[..., None] * ref_n[..., None, :]


def convex_convex(pos1, mat1, size1, pos2, mat2, size2, hull1: HullConsts, hull2: HullConsts):
  """Hull vs hull: SAT over both hulls' face normals and the edge-cross
  axes (kernel B3), then one edge-edge contact or a face manifold of up to
  4 points clipped from the incident face."""
  from mjtpu_torch.ops.sat import centroid

  w1, w2 = _world(pos1, mat1, hull1.vert), _world(pos2, mat2, hull2.vert)
  n1 = math.mat_vec(mat1[..., None, :, :], hull1.face_normal)             # (..., nf1, 3)
  n2 = math.mat_vec(mat2[..., None, :, :], hull2.face_normal)
  f1, f2 = w1[..., hull1.face, :], w2[..., hull2.face, :]                 # (..., nf, mfv, 3)
  c1, c2 = centroid(w1), centroid(w2)

  seps, idx = _sat_winners(pos1, mat1, pos2, mat2, hull1, hull2)
  sep1_best, sep2_best, best_edge_sep = seps.unbind(-1)
  bf1, bf2, be1, be2 = idx.long().unbind(-1)
  best_face_sep = torch.maximum(sep1_best, sep2_best)
  use_edge = best_edge_sep > best_face_sep + _EDGE_TOL

  # edge-edge contact from the winning pair's end points
  e1, e2 = hull1.edge[be1], hull2.edge[be2]                               # (..., 2)
  pa, pb = math.closest_segment_to_segment_points(
      _take(w1, e1[..., 0]), _take(w1, e1[..., 1]), _take(w2, e2[..., 0]), _take(w2, e2[..., 1]))
  n_edge = math.normalize(pb - pa)
  n_edge = torch.where((dot3(n_edge, c2 - c1) < 0)[..., None], -n_edge, n_edge)
  edge_dist = dot3(pb - pa, n_edge)
  edge_pos = 0.5 * (pa + pb)

  # face-face manifold: the reference face on the hull with the larger sep
  nb1, nb2 = _take(n1, bf1), _take(n2, bf2)
  d_a, p_a = _face_manifold(_take_face(f1, bf1), nb1, f2, n2)
  d_b, p_b = _face_manifold(_take_face(f2, bf2), nb2, f1, n1)
  ref_is_1 = sep1_best >= sep2_best
  k = smooth_k()
  # for hull2 as reference the normal (geom1 -> geom2) is -ref_n
  if k is None:
    n_face = torch.where(ref_is_1[..., None], nb1, -nb2)
    d_face = torch.where(ref_is_1[..., None], d_a, d_b)
    p_face = torch.where(ref_is_1[..., None, None], p_a, p_b)
  else:
    s_ref = sep1_best - sep2_best  # > 0: hull1 is the reference
    n_face = _renorm(math.sigmoid_blend(s_ref, nb1, -nb2, k))
    d_face = math.sigmoid_blend(s_ref, d_a, d_b, k)
    p_face = math.sigmoid_blend(s_ref, p_a, p_b, k)

  ue = use_edge[..., None]
  one = torch.ones_like(d_face[..., 1:])
  dist = torch.where(ue, torch.cat([edge_dist[..., None], one], dim=-1), d_face)
  pos = torch.where(ue[..., None], torch.cat(
      [edge_pos[..., None, :], torch.zeros_like(p_face[..., 1:, :])], dim=-2), p_face)
  if k is None:
    n_c = torch.where(ue, n_edge, n_face)
  else:
    # the deepest slot's dist, pos and normal blend across the edge/face
    # switch; slots 1-3 keep the hard edge deactivation (the count is
    # discrete)
    s_e = best_edge_sep - best_face_sep
    dist = torch.cat([math.sigmoid_blend(s_e, edge_dist, d_face[..., 0], k)[..., None],
                      dist[..., 1:]], dim=-1)
    pos = torch.cat([math.sigmoid_blend(s_e, edge_pos, p_face[..., 0, :], k)[..., None, :],
                     pos[..., 1:, :]], dim=-2)
    n_c = _renorm(math.sigmoid_blend(s_e, n_edge, n_face, k))
  frame = math.make_frame(n_c)[..., None, :, :].expand(dist.shape + (3, 3))
  return dist, pos, frame
