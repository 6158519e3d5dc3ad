"""Primitive narrowphase collision functions.

Port of mjtpu/_src/collision_primitive.py: plane against sphere, capsule,
ellipsoid and cylinder; sphere against sphere, capsule and cylinder;
capsule against capsule.  The cylinder colliders' case switches blend by
a sigmoid under ``differentiable_mode(smooth_collisions=True)``
(``_soft_where``), as in mjtpu.  Inputs
are world poses/sizes with any leading axes (here: B envs x the group's
pairs); outputs are
(dist (..., n), pos (..., n, 3), frame (..., n, 3, 3)) with the normal
pointing from geom1 into geom2 (MuJoCo convention).
"""

from __future__ import annotations

import torch

from mjtpu_torch._src import math
from mjtpu_torch._src.diff_config import smooth_k


def _sphere_sphere_raw(p1, r1, p2, r2):
  """Contact between two spheres given centers and radii."""
  n, dist_c = math.normalize_with_norm(p2 - p1)
  # coincident centers: the z axis, as in MuJoCo
  up = torch.zeros_like(n)
  up[..., 2] = 1.0
  n = torch.where((dist_c == 0.0)[..., None], up, n)
  dist = dist_c - (r1 + r2)
  pos = p1 + n * (r1 + 0.5 * dist)[..., None]
  return dist[..., None], pos[..., None, :], math.make_frame(n)[..., None, :, :]


def plane_sphere(pos1, mat1, size1, pos2, mat2, size2):
  n = mat1[..., :, 2]
  r = size2[..., 0]
  dist = math.dot3(n, pos2 - pos1) - r
  pos = pos2 - n * (r + 0.5 * dist)[..., None]
  return dist[..., None], pos[..., None, :], math.make_frame(n)[..., None, :, :]


def sphere_sphere(pos1, mat1, size1, pos2, mat2, size2):
  return _sphere_sphere_raw(pos1, size1[..., 0], pos2, size2[..., 0])


def sphere_capsule(pos1, mat1, size1, pos2, mat2, size2):
  axis = mat2[..., :, 2]
  h = size2[..., 1, None]
  pt = math.closest_segment_point(pos2 - h * axis, pos2 + h * axis, pos1)
  return _sphere_sphere_raw(pos1, size1[..., 0], pt, size2[..., 0])


def capsule_capsule(pos1, mat1, size1, pos2, mat2, size2):
  axis1, axis2 = mat1[..., :, 2], mat2[..., :, 2]
  h1, h2 = size1[..., 1, None], size2[..., 1, None]
  p1, p2 = math.closest_segment_to_segment_points(
      pos1 - h1 * axis1, pos1 + h1 * axis1, pos2 - h2 * axis2, pos2 + h2 * axis2)
  return _sphere_sphere_raw(p1, size1[..., 0], p2, size2[..., 0])


def plane_capsule(pos1, mat1, size1, pos2, mat2, size2):
  n = mat1[..., :, 2]
  axis = mat2[..., :, 2]
  r, h = size2[..., 0], size2[..., 1]
  # mj's plane-capsule frame: first tangent is the capsule axis projected
  # onto the plane (matters for pyramidal cone orientation under sliding)
  t1 = axis - n * math.dot3(n, axis)[..., None]
  t1n = math.norm3(t1)
  frame_fallback = math.make_frame(n)
  t1 = torch.where(
      (t1n < 1e-12)[..., None],
      frame_fallback[..., 1, :],
      t1 / torch.clamp_min(t1n, 1e-12)[..., None],
  )
  t2 = math.cross(n, t1)
  frame = torch.stack(torch.broadcast_tensors(n, t1, t2), dim=-2)
  dists, poss = [], []
  for sgn in (-1.0, 1.0):
    center = pos2 + (sgn * h)[..., None] * axis
    dist = math.dot3(n, center - pos1) - r
    pos = center - n * (r + 0.5 * dist)[..., None]
    dists.append(dist)
    poss.append(pos)
  return (
      torch.stack(dists, dim=-1),
      torch.stack(poss, dim=-2),
      torch.stack([frame, frame], dim=-3),
  )


def _soft_where(cond_margin, k, a, b):
  """where(cond_margin > 0, a, b), broadcast over a trailing 3-axis of a
  and b; sigmoid-blended with sharpness k in differentiable mode (k None
  outside it)."""
  if k is not None:
    return math.sigmoid_blend(cond_margin, a, b, k)
  c = cond_margin > 0
  return torch.where(c[..., None] if a.dim() > c.dim() else c, a, b)


def _sign_of(x, k):
  """1 where x > 0, else -1 (blended in differentiable mode), at x's dtype."""
  one = torch.ones_like(x)
  return _soft_where(x, k, one, -one)


def plane_ellipsoid(pos1, mat1, size1, pos2, mat2, size2):
  """One contact between a plane and an ellipsoid: the ellipsoid's support
  point along the inward plane normal."""
  n = mat1[..., :, 2]
  n_local = math.mat_t_vec(mat2, n)
  support = -math.normalize(n_local * size2) * size2  # the deepest point, local
  pos = pos2 + math.mat_vec(mat2, support)
  dist = math.dot3(n, pos - pos1)
  pos = pos - n * dist[..., None] * 0.5
  return dist[..., None], pos[..., None, :], math.make_frame(n)[..., None, :, :]


def plane_cylinder(pos1, mat1, size1, pos2, mat2, size2):
  """Four contacts between a plane and a cylinder: the deepest cap-rim
  point, the same rim point on the opposite cap (a lying cylinder's line
  contact) and two rim points at +-120 degrees on the deep cap (an upright
  cylinder's disk contact).  All four slots are always written; the
  constraint layer gates them on penetration."""
  k = smooth_k()
  r, h = size2[..., 0], size2[..., 1]
  n = mat1[..., :, 2]
  axis = mat2[..., :, 2]

  # orient the axis toward the plane (prjaxis <= 0 after the flip)
  prjaxis0 = math.dot3(n, axis)
  sign = -_sign_of(prjaxis0, k)
  axis = axis * sign[..., None]
  prjaxis = prjaxis0 * sign

  dist0 = math.dot3(pos2 - pos1, n)

  # radial direction of the deepest rim point: -normal without its axial
  # component (degenerate when the axis is perpendicular to the plane)
  vec = axis * prjaxis[..., None] - n
  len_ = math.norm3(vec)
  vec = _soft_where(len_ - 1e-12, k,
                    vec / torch.clamp_min(len_, 1e-12)[..., None] * r[..., None],
                    mat2[..., :, 0] * r[..., None])
  prjvec = math.dot3(vec, n)

  axis_h = axis * h[..., None]
  prjaxis_h = prjaxis * h
  # the flanking rim points at +-120 degrees around the deep cap disk
  prjvec1 = -prjvec * 0.5
  vec1 = math.normalize(math.cross(vec, axis)) * r[..., None] * (3.0 ** 0.5 * 0.5)

  d1 = dist0 + prjaxis_h + prjvec   # the deep cap's rim
  d2 = dist0 + prjaxis_h + prjvec1  # the flanks on the deep cap
  d3 = dist0 - prjaxis_h + prjvec   # the opposite cap's rim (lying cylinders)
  deep = pos2 + axis_h
  half = lambda d: n * d[..., None] * 0.5
  dist = torch.stack([d1, d3, d2, d2], dim=-1)
  pos = torch.stack([
      deep + vec - half(d1),
      pos2 - axis_h + vec - half(d3),
      deep + vec1 - vec * 0.5 - half(d2),
      deep - vec1 - vec * 0.5 - half(d2),
  ], dim=-2)
  frame = math.make_frame(n)[..., None, :, :].expand(dist.shape + (3, 3))
  return dist, pos, frame


def sphere_cylinder(pos1, mat1, size1, pos2, mat2, size2):
  """One contact between a sphere (geom1) and a cylinder (geom2): the
  closest point of the solid cylinder, or for a centre inside it the
  nearer of the side wall and the cap."""
  k = smooth_k()
  r_s = size1[..., 0]
  r_c, h = size2[..., 0], size2[..., 1]

  c = math.mat_t_vec(mat2, pos1 - pos2)  # the sphere's centre, cylinder frame
  zero = torch.zeros_like(c[..., 2])
  rho_vec = torch.stack([c[..., 0], c[..., 1], zero], dim=-1)
  rho = math.norm3(rho_vec)
  x_axis = torch.stack([torch.ones_like(zero), zero, zero], dim=-1)
  rho_hat = _soft_where(rho - 1e-12, k, rho_vec / torch.clamp_min(rho, 1e-12)[..., None],
                        x_axis)
  z = c[..., 2]

  # outside: clamp to the solid cylinder
  p_out = rho_hat * torch.minimum(rho, r_c)[..., None]
  p_out = torch.stack([p_out[..., 0], p_out[..., 1], torch.minimum(torch.maximum(z, -h), h)],
                      dim=-1)
  u = c - p_out
  u_len = math.norm3(u)
  u_hat = _soft_where(u_len - 1e-12, k, u / torch.clamp_min(u_len, 1e-12)[..., None], rho_hat)
  dist_out = u_len - r_s

  # inside: pushed out through the nearer of the side wall and the cap
  gap_side = r_c - rho
  gap_cap = h - torch.abs(z)
  use_side = gap_cap - gap_side  # > 0: the side wall is nearer
  zsign = _sign_of(z, k)
  cap_n = torch.stack([zero, zero, torch.ones_like(zero)], dim=-1) * zsign[..., None]
  n_in = _soft_where(use_side, k, rho_hat, cap_n)
  dist_in = -(torch.minimum(gap_side, gap_cap) + r_s)
  p_in_side = rho_hat * r_c[..., None]
  p_in_side = torch.stack([p_in_side[..., 0], p_in_side[..., 1], z], dim=-1)
  p_in_cap = torch.stack([c[..., 0], c[..., 1], h * zsign], dim=-1)
  p_in = _soft_where(use_side, k, p_in_side, p_in_cap)

  inside = torch.minimum(gap_side, gap_cap)  # > 0 iff the centre is inside
  dist = _soft_where(inside, k, dist_in, dist_out)
  n_out_local = _soft_where(inside, k, n_in, u_hat)
  p_surf = _soft_where(inside, k, p_in, p_out)
  pos_local = p_surf + 0.5 * dist[..., None] * n_out_local

  pos = pos2 + math.mat_vec(mat2, pos_local)
  # the normal points from geom1 (the sphere) into geom2 (the cylinder)
  n_world = -math.mat_vec(mat2, n_out_local)
  return dist[..., None], pos[..., None, :], math.make_frame(n_world)[..., None, :, :]
