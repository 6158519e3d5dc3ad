"""Primitive narrowphase collision functions.

Port of mjtpu/_src/collision_primitive.py's plane-capsule collider, the
only pair family of this slice.  The other primitive colliders arrive with
the slices whose models need them.  Inputs are world poses/sizes with any
leading axes (here: B envs x the group's pairs); outputs are
(dist (..., n), pos (..., n, 3), frame (..., n, 3, 3)) with the normal
pointing from geom1 into geom2 (MuJoCo convention).
"""

from __future__ import annotations

import torch

from mjtpu_torch._src import math


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
