"""Height-field collisions: spheres, capsules and hulls against the terrain.

Port of mjtpu/_src/collision_hfield.py (_subgrid_shape, _grid_consts,
_height_window, _hfield_object, hfield_sphere, hfield_capsule,
hfield_convex), batched
over (B, npair).  The subgrid size is a model constant (from the height
field's cell size and the group's largest bounding radius), so each pair
gathers a fixed (R, C) window of heights around its object; the object is
pulled into the height field's local frame (terrain up = +z), the 4-point
manifold is computed there by ``ops.hfield.manifold_batch`` over all
(env, pair) instances at once, and only the 4 winners go back to world.

On a CUDA tensor the manifold runs in the hand-written kernel (or
raises), in every mode; the plain twin runs for a CPU tensor.  The seam
is differentiable (``manifold_differentiable``: the twin's gradient
backward).  The window gather
stays plain torch, outside the kernel, as it stays in XLA outside mjtpu's
Pallas call.  As in mjtpu, objects collide with the surface triangles only
(two per cell); the side walls of the boundary prisms are not modelled.
``hfield_convex`` (a box, mesh, cylinder or ellipsoid hull on terrain)
stays plain torch, as it stays in XLA in mjtpu: a bilinear lookup per
vertex, no triangle batch, nothing for a kernel to keep on chip.
"""

from __future__ import annotations

import numpy as np
import torch

from mjtpu_torch._src import math
from mjtpu_torch._src.types import Model, cached, rows as env_rows
from mjtpu_torch.ops import hfield as hfield_op

# cap on the static subgrid half-extent (cells); bigger objects clamp here
_MAX_HALF_CELLS = hfield_op.MAX_HALF_CELLS


def _subgrid_shape(m: Model, hid: int, rbound: float) -> tuple[int, int]:
  nrow, ncol = int(m.hfield_nrow[hid]), int(m.hfield_ncol[hid])
  sx, sy = float(m.hfield_size[hid][0]), float(m.hfield_size[hid][1])
  dx = 2.0 * sx / max(1, ncol - 1)
  dy = 2.0 * sy / max(1, nrow - 1)
  hx = min(_MAX_HALF_CELLS, int(np.ceil(rbound / max(1e-9, dx))) + 1)
  hy = min(_MAX_HALF_CELLS, int(np.ceil(rbound / max(1e-9, dy))) + 1)
  hx = max(0, min(hx, (ncol - 2) // 2))
  hy = max(0, min(hy, (nrow - 2) // 2))
  return hy, hx


def _grid_consts(m: Model, hid: int):
  nrow, ncol = int(m.hfield_nrow[hid]), int(m.hfield_ncol[hid])
  size = m.hfield_size[hid]  # (sx, sy, ztop, zbottom), host numpy
  sx, sy, ztop = float(size[0]), float(size[1]), float(size[2])
  dx = 2.0 * sx / max(1, ncol - 1)
  dy = 2.0 * sy / max(1, nrow - 1)
  return nrow, ncol, sx, sy, ztop, int(m.hfield_adr[hid]), dx, dy


def _heights(m: Model, flat: torch.Tensor) -> torch.Tensor:
  """hfield_data at the (B, ...) flat indices ``flat``: each env's own
  heights where the model holds one row of them per env."""
  data = env_rows(m, "hfield_data")
  if data.shape[0] == 1:
    return data[0][flat]
  return torch.gather(data, 1, flat.reshape(flat.shape[0], -1)).reshape(flat.shape)


def _height_window(m: Model, hid: int, lc: torch.Tensor, hy: int, hx: int):
  """Gathers the (..., R, C) height window under the local object centres
  ``lc`` (..., 3) and its origin (x0, y0); R = 2hy+2 rows, C = 2hx+2 cols."""
  nrow, ncol, sx, sy, ztop, adr, dx, dy = _grid_consts(m, hid)
  dev = lc.device
  ar_r, ar_c = cached(m, ("hfield.window", hid, hy, hx), lambda: (
      torch.arange(2 * hy + 2, device=dev), torch.arange(2 * hx + 2, device=dev)))
  ci = torch.clamp(torch.floor((lc[..., 0] + sx) / dx).long(), hx, ncol - 2 - hx)
  ri = torch.clamp(torch.floor((lc[..., 1] + sy) / dy).long(), hy, nrow - 2 - hy)
  rows = torch.clamp(ri[..., None] - hy + ar_r, 0, nrow - 1)
  cols = torch.clamp(ci[..., None] - hx + ar_c, 0, ncol - 1)
  flat = adr + rows[..., :, None] * ncol + cols[..., None, :]
  z = _heights(m, flat) * ztop
  x0 = -sx + cols[..., 0].to(lc.dtype) * dx
  y0 = -sy + rows[..., 0].to(lc.dtype) * dy
  return z, x0, y0


def _hfield_object(pos1, mat1, pos2, mat2, size2, m: Model, hid: int, rbound: float,
                   has_axis: bool):
  """Sphere/capsule (geom2) against height field ``hid`` (geom1), every
  leading axis batched: (dist (..., 4), pos (..., 4, 3), frame (..., 4, 3, 3))."""
  hy, hx = _subgrid_shape(m, hid, rbound)
  _, _, _, _, _, _, dx, dy = _grid_consts(m, hid)
  lead = pos2.shape[:-1]
  lc = math.mat_t_vec(mat1, pos2 - pos1)
  if has_axis:
    axis_l = math.mat_t_vec(mat1, mat2[..., :, 2])
    h = size2[..., 1, None]
    a, b = lc - h * axis_l, lc + h * axis_l
  else:
    a = b = lc
  zwin, x0, y0 = _height_window(m, hid, lc, hy, hx)
  origin = torch.stack([x0, y0], dim=-1)
  flat = lambda x: x.reshape((-1,) + x.shape[len(lead):])
  r = size2[..., 0].expand(lead)
  dist4, pos_l, n_l = hfield_op.manifold_differentiable(
      flat(zwin), flat(origin), flat(a), flat(b), flat(r), hy, hx, dx, dy, has_axis)
  dist4 = dist4.reshape(lead + (4,))
  # local -> world: pos1 + mat1 @ p, with the axes as mjtpu's `p @ mat1.T`
  pos_w = pos1[..., None, :] + math.mat_vec(mat1[..., None, :, :], pos_l.reshape(lead + (4, 3)))
  n_w = math.mat_vec(mat1[..., None, :, :], n_l.reshape(lead + (4, 3)))
  return dist4, pos_w, math.make_frame(n_w)


def hfield_sphere(pos1, mat1, size1, pos2, mat2, size2, m: Model, hid: int, rbound: float):
  return _hfield_object(pos1, mat1, pos2, mat2, size2, m, hid, rbound, has_axis=False)


def hfield_capsule(pos1, mat1, size1, pos2, mat2, size2, m: Model, hid: int, rbound: float):
  return _hfield_object(pos1, mat1, pos2, mat2, size2, m, hid, rbound, has_axis=True)


def hfield_convex(pos1, mat1, size1, pos2, mat2, size2, m: Model, hid: int, hull2):
  """A hull (geom2; ``hull2`` from collision_convex.hull_consts) against
  height field ``hid`` (geom1): each hull vertex against the surface
  triangle under it (the cell split on its 00-11 diagonal), contacts at
  the 4 deepest vertices (a stable sort, as jnp.argsort).  Every leading
  axis batched: (dist (..., 4), pos (..., 4, 3), frame (..., 4, 3, 3))."""
  nrow, ncol, sx, sy, ztop, adr, dx, dy = _grid_consts(m, hid)
  verts_w = pos2[..., None, :] + math.mat_vec(mat2[..., None, :, :], hull2.vert)  # (..., nv, 3)
  v = math.mat_t_vec(mat1[..., None, :, :], verts_w - pos1[..., None, :])       # hfield-local
  fx = (v[..., 0] + sx) / dx
  fy = (v[..., 1] + sy) / dy
  ci = torch.clamp(torch.floor(fx).to(torch.int32), 0, ncol - 2)
  ri = torch.clamp(torch.floor(fy).to(torch.int32), 0, nrow - 2)
  u = torch.clamp(fx - ci, 0.0, 1.0)
  w = torch.clamp(fy - ri, 0.0, 1.0)
  height = lambda r, c: _heights(m, (adr + r * ncol + c).long()) * ztop
  z00, z01 = height(ri, ci), height(ri, ci + 1)
  z10, z11 = height(ri + 1, ci), height(ri + 1, ci + 1)
  x0 = -sx + ci.to(v.dtype) * dx
  y0 = -sy + ri.to(v.dtype) * dy
  pt = lambda x, y, z: torch.stack([x, y, z], dim=-1)
  p00, p01 = pt(x0, y0, z00), pt(x0 + dx, y0, z01)
  p10, p11 = pt(x0, y0 + dy, z10), pt(x0 + dx, y0 + dy, z11)
  # the triangle of the (00, 11) diagonal split: u >= w -> (00, 01, 11)
  in_a = (u >= w)[..., None]
  a = p00
  b = torch.where(in_a, p01, p11)
  c = torch.where(in_a, p11, p10)
  n = math.normalize(math.cross(b - a, c - a))
  n = torch.where((n[..., 2] < 0)[..., None], -n, n)  # up
  dist = math.dot3(n, v - a)                                                     # (..., nv)

  idx = torch.argsort(dist, dim=-1, stable=True)[..., :4]
  at = lambda x: torch.gather(x, -2, idx[..., None].expand(idx.shape + (3,)))
  dist4 = torch.gather(dist, -1, idx)
  n4 = math.mat_vec(mat1[..., None, :, :], at(n))  # local -> world
  pos4 = at(verts_w) - 0.5 * dist4[..., None] * n4
  return dist4, pos4, math.make_frame(n4)
