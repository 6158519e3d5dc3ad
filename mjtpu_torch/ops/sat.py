"""Batched convex-convex SAT winners: the Hopper kernel and its plain twin.

Port of mjtpu/ops/sat.py (``_sat_kernel``, the Pallas kernel behind
collision_convex._sat_winners, and ``sat_winners_batch``), following
mjtpu's jnp path ``collision_convex._sat_winners_jnp``, which made the f64
goldens.  For n pair instances, each two poses (pos (n, 3), mat (n, 3, 3))
of two hulls, ``sat_winners_batch`` returns

  seps (n, 3)  [best face separation of hull 1, of hull 2, best edge-cross
               separation]
  idx  (n, 4)  int32 [bf1, bf2, be1, be2], the edge pair re-selected by
               support along the winning axis

  * on a CUDA tensor it launches a hand-written kernel in
    ``mjtpu_torch/csrc/sat.cu``, built with nvcc for sm_90a at first use
    and bound with ctypes (``ops._build``).  Which one is a size dispatch
    (``variant``): hull pairs whose (nv, nf, ne) are both in
    ``STATIC_HULLS`` (boxes and humanoid_terrain's rock hulls) take the
    ``static`` kernel (sizes fixed at compile time, 16 lanes per instance,
    world vertices and each lane's axes in registers); any other pair takes
    the ``shared`` kernel (one warp per instance, the world hulls in shared
    memory).  A build or launch failure, or hulls whose tables do not fit a
    block's shared memory (the shared kernel's static bound), raises;
    nothing falls back.
  * on a CPU tensor it runs the plain twin ``sat_winners_reference``.

The algorithm, per instance, on world geometry (vertices w = pos + R v;
edge directions and midpoints from the world end points; centroids the
vertex means):
  1. face separations: per face, the min over the other hull's vertices of
     n . v, minus the face offset n . (its first vertex); the argmax face;
  2. the ne1 x ne2 axes cross(d1, d2), divided by max(1e-12, |axis|),
     oriented along c2 - c1 by sign(axis . (c2 - c1)); separation
     min proj2 - max proj1, or -inf where |axis| < 1e-6;
  3. the flat argmax over e1 * ne2 + e2;
  4. the support reselect: among the axes within 1e-6 of parallel to the
     winner (and |axis| >= 1e-6), the flat argmax of
     mid1 . ax - mid2 . ax.
Every argmax is torch.argmax's: NaN first, then the value, then the lowest
index.  With axis-aligned boxes most axes tie exactly, and the winner
decides the contact, so the twin is written as plain elementwise
operations in the kernel's order (3-vector dots as x + y + z, no matmul),
and the kernel is built with ``--fmad=false`` so that nvcc contracts no
multiply-add: the two agree bit for bit.

The wrapper has no backward: on the card it raises on an input that
requires grad while grad mode is on (``_build.refuse_grad``).  The
engine's seam is ``sat_winners_differentiable``: the kernel forward, the
twin's gradient backward (``_build.TwinGrad``).

``launches`` counts kernel launches (never twin calls), and
``variant_launches`` counts them by variant.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from mjtpu_torch._src.math import cross, dot3, mat_vec, norm3
from mjtpu_torch.ops import _build

# kernel launches since import (CPU calls and twin calls do not count),
# in all and by variant
launches = 0
variant_launches = {"static": 0, "shared": 0}

SOURCE = "sat.cu"
EXTRA_FLAGS = ("--fmad=false",)
SMEM_LIMIT = _build.SMEM_LIMIT
_MAX_WARPS_PER_BLOCK = 8
# the hull sizes (nv, nf, ne) the static kernel is instantiated for, in
# either place of a pair (csrc/sat.cu's MJTPU_SAT_HULLS): a box and
# humanoid_terrain's 6-vertex rock
STATIC_HULLS = ((8, 6, 12), (6, 8, 12))
# the static kernel's launch: 16 lanes per instance, 128 threads a block
STATIC_LANES = 16
STATIC_THREADS = 128


class SatHull(NamedTuple):
  """One hull's tables on the device: local vertices (nv, 3), face normals
  (nf, 3), each face's first vertex (nf,) int32 and the edges' end vertices
  (ne, 2) int32."""

  vert: torch.Tensor
  face_normal: torch.Tensor
  face0: torch.Tensor
  edge: torch.Tensor


def sat_hull(hull, dtype: torch.dtype, device) -> SatHull:
  """SatHull of a ConvexMesh (host tables), built once per model."""
  f = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device).contiguous()
  i = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int32, device=device).contiguous()
  return SatHull(f(hull.vert), f(hull.face_normal), i(np.asarray(hull.face)[:, 0]), i(hull.edge))


def hull_sizes(h: SatHull) -> tuple[int, int, int]:
  """(nv, nf, ne) of a hull's tables."""
  return h.vert.shape[0], h.face_normal.shape[0], h.edge.shape[0]


def variant(h1: SatHull, h2: SatHull) -> str:
  """The kernel a hull pair takes: "static" when both hulls' sizes are
  instantiated (STATIC_HULLS), else "shared"."""
  return "static" if {hull_sizes(h1), hull_sizes(h2)} <= set(STATIC_HULLS) else "shared"


def variants(h1: SatHull, h2: SatHull) -> tuple[str, ...]:
  """The kernels that can run a hull pair: the shared one always, the
  static one where both sizes are instantiated."""
  return ("static", "shared") if variant(h1, h2) == "static" else ("shared",)


def launch_geometry(n: int, h1: SatHull, h2: SatHull, dtype: torch.dtype,
                    kind: str | None = None):
  """(variant, blocks, threads a block, instances a block) of one launch
  over n instances, of ``kind`` or else of ``variant(h1, h2)``.  The static
  kernel puts 16 lanes on an instance; the shared kernel puts one warp per
  instance and as many warps in a block as its shared memory allows, up to
  8."""
  kind = kind or variant(h1, h2)
  if kind == "static":
    per_block, threads = STATIC_THREADS // STATIC_LANES, STATIC_THREADS
  else:
    per_block = max(1, min(_MAX_WARPS_PER_BLOCK, SMEM_LIMIT // smem_per_warp(h1, h2, dtype)))
    threads = 32 * per_block
  return kind, -(-n // per_block), threads, per_block


def smem_per_warp(h1: SatHull, h2: SatHull, dtype: torch.dtype) -> int:
  """Shared memory one warp's instance takes: both hulls' world vertices,
  face normals, face offsets, edge directions and midpoints.  The kernel's
  static bound: one warp's share must fit a block's shared memory."""
  item = torch.empty((), dtype=dtype).element_size()
  per = lambda h: 3 * h.vert.shape[0] + 4 * h.face_normal.shape[0] + 6 * h.edge.shape[0]
  return (per(h1) + per(h2)) * item


# ---------------------------------------------------------------------------
# plain twin (mjtpu's jnp path, batched over n)
# ---------------------------------------------------------------------------


def centroid(w: torch.Tensor) -> torch.Tensor:
  """The mean of the points w (..., nv, 3), summed in vertex order (the
  kernel's order on every device) and divided by nv.  The divisor is a
  tensor on w's device: on the card torch multiplies by the reciprocal of a
  Python-number divisor, which differs from the division (the kernel's, and
  mjtpu's) where nv is not a power of two."""
  c = w[..., 0, :]
  for v in range(1, w.shape[-2]):
    c = c + w[..., v, :]
  return c / torch.full((), w.shape[-2], dtype=c.dtype, device=c.device)


def _argmax(x: torch.Tensor) -> torch.Tensor:
  """Flat argmax over every axis after the first (torch.argmax's order)."""
  return torch.argmax(x.reshape(x.shape[0], -1), dim=1)


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
  """x[b, i[b]] for x (n, k, ...) and i (n,)."""
  return x[torch.arange(x.shape[0], device=x.device), i]


def sat_winners_reference(pos1, mat1, pos2, mat2, h1: SatHull, h2: SatHull):
  """Plain PyTorch twin of the kernel (same arguments as sat_winners_batch)."""
  n = pos1.shape[0]
  world = lambda pos, mat, h: pos[:, None] + mat_vec(mat[:, None], h.vert)   # (n, nv, 3)
  w1, w2 = world(pos1, mat1, h1), world(pos2, mat2, h2)
  n1 = mat_vec(mat1[:, None], h1.face_normal)                               # (n, nf1, 3)
  n2 = mat_vec(mat2[:, None], h2.face_normal)

  def face_sep(nrm, w_self, face0, w_other):
    off = dot3(nrm, w_self[:, face0.long()])
    minp = dot3(w_other[:, 0:1], nrm)
    for v in range(1, w_other.shape[1]):
      minp = torch.minimum(minp, dot3(w_other[:, v:v + 1], nrm))
    sep = minp - off
    best = torch.argmax(sep, dim=1)
    return _take(sep, best), best

  sep1, bf1 = face_sep(n1, w1, h1.face0, w2)
  sep2, bf2 = face_sep(n2, w2, h2.face0, w1)

  def edges(w, h):
    e = h.edge.long()
    a, b = w[:, e[:, 0]], w[:, e[:, 1]]
    return b - a, 0.5 * (a + b)                                             # (n, ne, 3)

  d1, mid1 = edges(w1, h1)
  d2, mid2 = edges(w2, h2)
  cvec = centroid(w2) - centroid(w1)
  axes = cross(d1[:, :, None], d2[:, None])                                 # (n, ne1, ne2, 3)
  axes_n = norm3(axes)
  axes = axes / torch.clamp_min(axes_n, 1e-12)[..., None]
  axes = axes * torch.sign(dot3(axes, cvec[:, None, None]))[..., None]
  proj = lambda w, v: dot3(w[:, None, None, v], axes)
  maxp1 = proj(w1, 0)
  for v in range(1, w1.shape[1]):
    maxp1 = torch.maximum(maxp1, proj(w1, v))
  minp2 = proj(w2, 0)
  for v in range(1, w2.shape[1]):
    minp2 = torch.minimum(minp2, proj(w2, v))
  sep_e = torch.where(axes_n < 1e-6, -torch.inf, minp2 - maxp1)
  be = _argmax(sep_e)
  best_edge = _take(sep_e.reshape(n, -1), be)

  # the support reselect among the (near-)parallel axes
  ne2 = axes.shape[2]
  ax = _take(axes.reshape(n, -1, 3), be)                                   # (n, 3)
  compat = (dot3(axes, ax[:, None, None]) > 1.0 - 1e-6) & (axes_n >= 1e-6)
  score = dot3(mid1, ax[:, None])[:, :, None] - dot3(mid2, ax[:, None])[:, None, :]
  bp = _argmax(torch.where(compat, score, -torch.inf))

  seps = torch.stack([sep1, sep2, best_edge], dim=1)
  idx = torch.stack([bf1, bf2, bp // ne2, bp % ne2], dim=1).to(torch.int32)
  return seps, idx


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


SIGNATURES = {
    **{name: ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 8 + [ctypes.c_void_p], ctypes.c_int)
       for name in ("mjtpu_sat_shared_f32", "mjtpu_sat_shared_f64")},
    **{name: ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [ctypes.c_void_p], ctypes.c_int)
       for name in ("mjtpu_sat_static_f32", "mjtpu_sat_static_f64")},
}


def library() -> ctypes.CDLL:
  """Builds (at first use) and loads the kernel library."""
  return _build.library(SOURCE, EXTRA_FLAGS, SIGNATURES)


def _check(pos1, mat1, pos2, mat2, h1: SatHull, h2: SatHull) -> None:
  dtype = pos1.dtype
  floats = (pos1, mat1, pos2, mat2, h1.vert, h1.face_normal, h2.vert, h2.face_normal)
  if dtype not in (torch.float32, torch.float64) or any(x.dtype != dtype for x in floats):
    raise TypeError("sat_winners_batch takes float32 or float64 poses and hulls of one dtype")
  if any(x.dtype != torch.int32 for x in (h1.face0, h1.edge, h2.face0, h2.edge)):
    raise TypeError("sat_winners_batch takes int32 face and edge tables")
  n = pos1.shape[0]
  shapes = tuple(tuple(x.shape) for x in (pos1, mat1, pos2, mat2))
  if shapes != ((n, 3), (n, 3, 3), (n, 3), (n, 3, 3)):
    raise ValueError(f"sat_winners_batch takes pos (n, 3) and mat (n, 3, 3), got {shapes}")
  for h in (h1, h2):
    nv, nf, ne = h.vert.shape[0], h.face_normal.shape[0], h.edge.shape[0]
    if (h.vert.shape, h.face_normal.shape, h.face0.shape, h.edge.shape) != (
        (nv, 3), (nf, 3), (nf,), (ne, 2)) or min(nv, nf, ne) == 0:
      raise ValueError("sat_winners_batch takes non-empty hull tables (nv, 3), (nf, 3), (nf,),"
                       " (ne, 2)")
  tensors = floats + (h1.face0, h1.edge, h2.face0, h2.edge)
  if any(x.device != pos1.device for x in tensors):
    raise ValueError("sat_winners_batch takes tensors on one device")


def sat_winners_batch(pos1, mat1, pos2, mat2, h1: SatHull, h2: SatHull, *,
                      kernel: str | None = None):
  """Batched SAT winners: pos (n, 3), mat (n, 3, 3) per hull ->
  (seps (n, 3), idx (n, 4) int32); see the module docstring.  ``kernel``
  names the variant to launch ("static" or "shared"; a test's choice, to
  hold both to the twin); None takes ``variant(h1, h2)``."""
  global launches
  _check(pos1, mat1, pos2, mat2, h1, h2)
  kind = variant(h1, h2) if kernel is None else kernel
  if kind not in variants(h1, h2):
    raise ValueError(f"no {kind!r} sat kernel for hulls of (nv, nf, ne)"
                     f" {[hull_sizes(h1), hull_sizes(h2)]}")
  if pos1.device.type == "cpu":
    return sat_winners_reference(pos1, mat1, pos2, mat2, h1, h2)
  if pos1.device.type != "cuda":
    raise ValueError(f"sat_winners_batch runs on cuda or cpu, not {pos1.device}")
  _build.refuse_grad("sat", pos1, mat1, pos2, mat2)
  dtype = pos1.dtype
  sizes = (hull_sizes(h1), hull_sizes(h2))
  n = pos1.shape[0]
  per_block = launch_geometry(n, h1, h2, dtype, kind)[3]
  if kind == "shared" and smem_per_warp(h1, h2, dtype) > SMEM_LIMIT:
    raise ValueError(
        f"hulls of (nv, nf, ne) {list(sizes)} need {smem_per_warp(h1, h2, dtype)} bytes of shared"
        f" memory, past the kernel's static bound of {SMEM_LIMIT} a block")
  seps = torch.empty((n, 3), dtype=dtype, device=pos1.device)
  idx = torch.empty((n, 4), dtype=torch.int32, device=pos1.device)
  if n == 0:
    return seps, idx
  # contiguous copies where needed, kept alive through the launch
  args = [x.contiguous() for x in (pos1, mat1, pos2, mat2, *h1, *h2)]
  lib = library()
  suffix = "f64" if dtype == torch.float64 else "f32"
  with torch.cuda.device(pos1.device):
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [x.data_ptr() for x in args] + [seps.data_ptr(), idx.data_ptr(), n, *sizes[0],
                                           *sizes[1]]
    if kind == "static":
      err = getattr(lib, f"mjtpu_sat_static_{suffix}")(*ptrs, stream)
    else:
      err = getattr(lib, f"mjtpu_sat_shared_{suffix}")(*ptrs, per_block, stream)
  _build.check_launch(lib, err, f"sat ({kind})")
  launches += 1
  variant_launches[kind] += 1
  return seps, idx


def sat_winners_differentiable(pos1, mat1, pos2, mat2, h1: SatHull, h2: SatHull):
  """``sat_winners_batch`` with a backward (``_build.TwinGrad``): the
  kernel's seps and winners forward, the twin's gradient of the seps
  backward (the max's gradient flows to the winning face or edge pair).
  The engine's seam, in every mode."""
  return _build.TwinGrad.apply(lambda *p: sat_winners_batch(*p, h1, h2),
                               lambda *p: sat_winners_reference(*p, h1, h2),
                               pos1, mat1, pos2, mat2)
