"""Primitive narrowphase collision functions.

Port of mjtpu/_src/collision_primitive.py's plane-sphere, plane-capsule,
sphere-sphere, sphere-capsule and capsule-capsule colliders.  The other
primitive colliders arrive with the slices whose models need them.  Inputs
are world poses/sizes with any leading axes (here: B envs x the group's
pairs); outputs are
(dist (..., n), pos (..., n, 3), frame (..., n, 3, 3)) with the normal
pointing from geom1 into geom2 (MuJoCo convention).
"""

from __future__ import annotations

import torch

from mjtpu_torch._src import math


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
