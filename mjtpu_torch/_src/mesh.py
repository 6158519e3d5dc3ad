"""Host-side convex hull tables for mesh collisions.

Port of mjtpu/_src/mesh.py (``_merge_coplanar``, ``_edges_and_adjacent_normals``,
``_pad_faces``, ``convex``, ``box``, ``cylinder``, ``ellipsoid``, ``get``): scipy's
ConvexHull, then coplanar triangles merged into polygonal faces in numpy.  The outputs are padded,
fixed-shape numpy arrays that the convex colliders close over as model
constants:

  vert             (nvert, 3)
  face             (nface, max_face_vert) vertex indices (padded by repeating)
  face_normal      (nface, 3)
  edge             (nedge, 2) unique hull edges
  edge_face_normal (nedge, 2, 3) normals of the two faces adjacent to an edge

Qhull's face order can differ between builds of scipy, so a model snapshot
stores the tables built where the snapshot was written (io.save_snapshot),
mesh hulls and the hulls of boxes, cylinders and ellipsoids alike, and a
model loaded from it never rebuilds them.
"""

from __future__ import annotations

import itertools

import numpy as np

from mjtpu_torch._src.types import ConvexMesh, GeomType


def _merge_coplanar(hull) -> tuple[np.ndarray, np.ndarray, list[list[int]]]:
  """Merges coplanar hull triangles into polygons: (vert, face_normal,
  faces), faces as CCW-ordered vertex-index lists into vert."""
  pts = hull.points
  # a convex hull has at most one face per outward normal: group the
  # triangles by quantized normal
  keys = np.round(hull.equations[:, :3] / np.maximum(
      np.linalg.norm(hull.equations[:, :3], axis=1, keepdims=True), 1e-12), 5)
  groups: dict[tuple, list[int]] = {}
  for i, k in enumerate(map(tuple, keys)):
    groups.setdefault(k, []).append(i)

  used = np.unique(hull.simplices)  # compact vertex set: hull vertices only
  remap = -np.ones(len(pts), dtype=np.int64)
  remap[used] = np.arange(len(used))
  vert = pts[used]

  faces, normals = [], []
  for tri_ids in groups.values():
    vids = np.unique(hull.simplices[np.array(tri_ids)])
    n = hull.equations[tri_ids[0], :3]
    n = n / max(np.linalg.norm(n), 1e-12)
    # order the polygon's vertices CCW about the outward normal
    c = pts[vids].mean(axis=0)
    ref = np.array([1.0, 0.0, 0.0]) if abs(n[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    u = np.cross(n, ref)
    u /= max(np.linalg.norm(u), 1e-12)
    v = np.cross(n, u)
    ang = np.arctan2((pts[vids] - c) @ v, (pts[vids] - c) @ u)
    order = np.argsort(ang)
    faces.append([int(remap[i]) for i in vids[order]])
    normals.append(n)
  return vert, np.array(normals), faces


def _edges_and_adjacent_normals(
    faces: list[list[int]], normals: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
  """Unique undirected edges of the polygon soup and their two face normals."""
  edge_faces: dict[tuple[int, int], list[int]] = {}
  for fi, f in enumerate(faces):
    for a, b in zip(f, f[1:] + f[:1]):
      if a == b:
        continue
      edge_faces.setdefault((min(a, b), max(a, b)), []).append(fi)
  edges, efn = [], []
  for (a, b), fids in edge_faces.items():
    edges.append((a, b))
    n0 = normals[fids[0]]
    n1 = normals[fids[1]] if len(fids) > 1 else n0
    efn.append((n0, n1))
  return np.array(edges, dtype=np.int64), np.array(efn)


def _pad_faces(faces: list[list[int]]) -> np.ndarray:
  maxv = max(len(f) for f in faces)
  out = np.zeros((len(faces), maxv), dtype=np.int64)
  for i, f in enumerate(faces):
    out[i, : len(f)] = f
    out[i, len(f):] = f[-1]  # pad by repeating the last vertex
  return out


def convex(vert: np.ndarray) -> ConvexMesh:
  """ConvexMesh hull tables of a point cloud."""
  from scipy.spatial import ConvexHull  # host-side, at model load only

  hull = ConvexHull(np.asarray(vert, dtype=np.float64))
  v, normals, faces = _merge_coplanar(hull)
  edge, efn = _edges_and_adjacent_normals(faces, normals)
  return ConvexMesh(
      vert=v, face=_pad_faces(faces), face_normal=normals, edge=edge, edge_face_normal=efn,
  )


def box(size: np.ndarray) -> ConvexMesh:
  """Hull of the axis-aligned box with half-sizes ``size`` (3,): convex()
  of its 8 corners in itertools.product order, as mjtpu builds it (the
  table order decides SAT ties)."""
  corners = np.array(list(itertools.product([-1.0, 1.0], repeat=3))) * size
  return convex(corners)


def cylinder(size: np.ndarray, nseg: int = 16) -> ConvexMesh:
  """Hull of the cylinder of radius size[0] and half-height size[1]: two
  rings of ``nseg`` vertices, inscribed in the cylinder (its depth is short
  by at most r (1 - cos(pi / nseg)), ~1.9% of r at 16), as mjtpu builds
  it.  Its 16 side edges are parallel and tie on every SAT cross axis; the
  lowest index wins, so the table order matters."""
  ang = np.arange(nseg) * (2.0 * np.pi / nseg)
  ring = np.stack([np.cos(ang), np.sin(ang)], axis=-1) * float(size[0])
  h = float(size[1])
  return convex(np.concatenate([
      np.concatenate([ring, np.full((nseg, 1), -h)], axis=-1),
      np.concatenate([ring, np.full((nseg, 1), h)], axis=-1),
  ]))


def ellipsoid(size: np.ndarray, nvert: int = 32) -> ConvexMesh:
  """Hull of the ellipsoid with radii ``size``: a Fibonacci sphere of
  ``nvert`` points scaled by the radii (inscribed, every face a triangle),
  as mjtpu builds it."""
  i = np.arange(nvert)
  phi = np.arccos(1.0 - 2.0 * (i + 0.5) / nvert)
  theta = np.pi * (1.0 + np.sqrt(5.0)) * i
  pts = np.stack([np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)],
                 axis=-1)
  return convex(pts * np.asarray(size, dtype=np.float64))


# the hull of each geom type that collides through a hull made from its
# size, as a function of the size
SIZED_HULLS = {GeomType.BOX: box, GeomType.CYLINDER: cylinder, GeomType.ELLIPSOID: ellipsoid}


def size_key(size: np.ndarray) -> tuple:
  """mjtpu's grouping key of a box, cylinder or ellipsoid geom: its exact
  size, rounded to 12 digits (collision_driver._shape_key); its hull is
  built from it."""
  return tuple(np.round(np.asarray(size, dtype=np.float64), 12))


def get_geoms(mjm) -> tuple:
  """Per-geom ConvexMesh tuple of ``mjm``: the hull of each colliding box,
  cylinder and ellipsoid (one hull object per type and distinct size),
  None for every other geom."""
  geom_type = np.asarray(mjm.geom_type)
  hulls: dict[tuple, ConvexMesh] = {}
  out = []
  for g in range(mjm.ngeom):
    t = int(geom_type[g])
    if t in SIZED_HULLS and (mjm.geom_contype[g] or mjm.geom_conaffinity[g]):
      key = (t,) + size_key(np.asarray(mjm.geom_size)[g])
      if key not in hulls:
        hulls[key] = SIZED_HULLS[t](np.array(key[1:]))
      out.append(hulls[key])
    else:
      out.append(None)
  return tuple(out)


def get(mjm) -> tuple:
  """Per-mesh ConvexMesh tuple of ``mjm`` (any object with MjModel's
  attribute names): hulls of the meshes that colliding geoms use, None for
  the others."""
  geom_type = np.asarray(mjm.geom_type)
  needed = {
      int(mjm.geom_dataid[g]) for g in range(mjm.ngeom)
      if geom_type[g] == GeomType.MESH and (mjm.geom_contype[g] or mjm.geom_conaffinity[g])
  }
  out = []
  for i in range(mjm.nmesh):
    if i in needed:
      va, vn = int(mjm.mesh_vertadr[i]), int(mjm.mesh_vertnum[i])
      out.append(convex(np.asarray(mjm.mesh_vert)[va : va + vn]))
    else:
      out.append(None)
  return tuple(out)
