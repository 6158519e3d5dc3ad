"""Collision driver: candidate enumeration (host) + narrowphase (device).

Port of mjtpu/_src/collision_driver.py.  Candidate enumeration is plain
numpy over the Model's static fields, computed once per Model; the
narrowphase runs once per homogeneous group (same type pair / shape /
condim) over a (B, npair) batch of geom poses.  Contacts are ordered by
group, groups sorted by condim, so ``efc_address`` is static.

The narrowphase table is mjtpu's: the analytic primitives (plane against
sphere, capsule, ellipsoid and cylinder; sphere against sphere, capsule
and cylinder; capsule against capsule), the convex colliders on hull
tables (a plane, sphere or capsule against a box, mesh or the inscribed
hull of an ellipsoid or cylinder; every other pair of those hulls through
SAT, kernel B3) and the height field against spheres and capsules (kernel
B4) and against hulls (``hfield_convex``).

The ``max_geom_pairs`` broadphase (``<numeric name="max_geom_pairs">``)
narrowphases only the K pairs of each group nearest by bounding-sphere
distance, per env; the slots' geoms then differ from env to env.
mjtpu's ``MJTPU_MAX_GEOM_PAIRS`` environment variable is not read.
"""

from __future__ import annotations

import functools
import itertools
from typing import Callable, Iterator

import numpy as np
import torch

from mjtpu_torch._src import collision_convex, collision_hfield, collision_primitive, math, mesh
from mjtpu_torch._src.dataclasses import replace
from mjtpu_torch._src.types import (
    ConeType,
    Contact,
    Data,
    DisableBit,
    GeomType,
    Model,
    cached,
    env_expand,
    rows as env_rows,
)

G = GeomType
# contact points per pair function, keyed by (type1, type2), type1 <= type2
_PAIR_NCON: dict[tuple[int, int], int] = {
    (G.PLANE, G.SPHERE): 1,
    (G.PLANE, G.CAPSULE): 2,
    (G.PLANE, G.ELLIPSOID): 1,
    (G.PLANE, G.CYLINDER): 4,
    (G.PLANE, G.BOX): 4,
    (G.PLANE, G.MESH): 4,
    (G.HFIELD, G.SPHERE): 4,
    (G.HFIELD, G.CAPSULE): 4,
    (G.HFIELD, G.BOX): 4,
    (G.HFIELD, G.MESH): 4,
    (G.HFIELD, G.ELLIPSOID): 4,
    (G.HFIELD, G.CYLINDER): 4,
    (G.SPHERE, G.SPHERE): 1,
    (G.SPHERE, G.CAPSULE): 1,
    (G.SPHERE, G.ELLIPSOID): 1,
    (G.SPHERE, G.CYLINDER): 1,
    (G.SPHERE, G.BOX): 1,
    (G.SPHERE, G.MESH): 1,
    (G.CAPSULE, G.CAPSULE): 1,
    (G.CAPSULE, G.ELLIPSOID): 2,
    (G.CAPSULE, G.CYLINDER): 2,
    (G.CAPSULE, G.BOX): 2,
    (G.CAPSULE, G.MESH): 2,
    (G.ELLIPSOID, G.ELLIPSOID): 4,
    (G.ELLIPSOID, G.CYLINDER): 4,
    (G.ELLIPSOID, G.BOX): 4,
    (G.ELLIPSOID, G.MESH): 4,
    (G.CYLINDER, G.CYLINDER): 4,
    (G.CYLINDER, G.BOX): 4,
    (G.CYLINDER, G.MESH): 4,
    (G.BOX, G.BOX): 4,
    (G.BOX, G.MESH): 4,
    (G.MESH, G.MESH): 4,
}

# the analytic colliders; every other pair but the height field's goes
# through a hull (_collision_fn)
_PRIMITIVE: dict[tuple[int, int], Callable] = {
    (G.PLANE, G.SPHERE): collision_primitive.plane_sphere,
    (G.PLANE, G.CAPSULE): collision_primitive.plane_capsule,
    (G.PLANE, G.ELLIPSOID): collision_primitive.plane_ellipsoid,
    (G.PLANE, G.CYLINDER): collision_primitive.plane_cylinder,
    (G.SPHERE, G.SPHERE): collision_primitive.sphere_sphere,
    (G.SPHERE, G.CAPSULE): collision_primitive.sphere_capsule,
    (G.SPHERE, G.CYLINDER): collision_primitive.sphere_cylinder,
    (G.CAPSULE, G.CAPSULE): collision_primitive.capsule_capsule,
}


def has_collision_fn(t1: int, t2: int) -> bool:
  return (int(t1), int(t2)) in _PAIR_NCON


# ---------------------------------------------------------------------------
# host-side candidate enumeration (numpy over static Model fields)
# ---------------------------------------------------------------------------


def geom_pairs(m: Model) -> Iterator[tuple[int, int, int]]:
  """Yields (geom1, geom2, pair_index) candidate pairs: <pair> table
  entries (index >= 0), then dynamic pairs (-1) that pass MuJoCo's
  filters (contype/conaffinity, same body or weld, parent-child,
  <exclude>)."""
  pair_sigs = set()
  for i in range(m.npair):
    g1, g2 = int(m.pair_geom1[i]), int(m.pair_geom2[i])
    if m.geom_type[g1] > m.geom_type[g2]:
      g1, g2 = g2, g1
    pair_sigs.add((g1, g2))
    yield g1, g2, i

  exclude_sigs = set(int(s) for s in m.exclude_signature)
  filterparent = not (m.opt.disableflags & DisableBit.FILTERPARENT)

  for ga, gb in itertools.combinations(range(m.ngeom), 2):
    g1, g2 = (ga, gb) if m.geom_type[ga] <= m.geom_type[gb] else (gb, ga)
    if (g1, g2) in pair_sigs:
      continue
    mask = (m.geom_contype[g1] & m.geom_conaffinity[g2]) | (
        m.geom_contype[g2] & m.geom_conaffinity[g1]
    )
    if not mask:
      continue
    b1, b2 = int(m.geom_bodyid[g1]), int(m.geom_bodyid[g2])
    if b1 == b2:
      continue
    w1, w2 = int(m.body_weldid[b1]), int(m.body_weldid[b2])
    if w1 == w2:
      continue
    wp1 = int(m.body_weldid[m.body_parentid[w1]])
    wp2 = int(m.body_weldid[m.body_parentid[w2]])
    if filterparent and w1 != 0 and w2 != 0 and (w1 == wp2 or w2 == wp1):
      continue
    if ((b1 << 16) + b2) in exclude_sigs or ((b2 << 16) + b1) in exclude_sigs:
      continue
    yield g1, g2, -1


def _pair_condim(m: Model, g1: int, g2: int, ip: int) -> int:
  """condim for a candidate pair per MuJoCo's priority/max mixing rule."""
  if ip >= 0:
    return int(m.pair_dim[ip])
  p1, p2 = int(m.geom_priority[g1]), int(m.geom_priority[g2])
  if p1 != p2:
    return int(m.geom_condim[g1] if p1 > p2 else m.geom_condim[g2])
  return int(max(m.geom_condim[g1], m.geom_condim[g2]))


def _shape_key(m: Model, g: int):
  """Grouping key: the geoms of a group share hull or height-field
  constants (mesh and hfield geoms key on their data id; boxes, cylinders
  and ellipsoids, whose hulls mjtpu builds from the size, on their exact
  size), so the groups and the contact order are mjtpu's."""
  t = int(m.geom_type[g])
  if t in (GeomType.MESH, GeomType.HFIELD):
    return int(m.geom_dataid[g])
  if t in (GeomType.BOX, GeomType.CYLINDER, GeomType.ELLIPSOID):
    return mesh.size_key(m.geom_size_np[g])
  return -1


def candidate_groups(m: Model) -> dict[tuple, list[tuple[int, int, int]]]:
  """Groups candidate pairs by (type1, type2, shape1, shape2, condim), in
  condim order so efc row addressing is static."""

  def build():
    groups: dict[tuple, list[tuple[int, int, int]]] = {}
    for g1, g2, ip in geom_pairs(m):
      t1, t2 = int(m.geom_type[g1]), int(m.geom_type[g2])
      if not has_collision_fn(t1, t2):
        raise NotImplementedError(
            f"collision between geom types {GeomType(t1).name} and"
            f" {GeomType(t2).name} is not supported"
        )
      condim = _pair_condim(m, g1, g2, ip)
      if condim not in (1, 3, 4, 6):
        raise NotImplementedError(f"condim={condim} not supported")
      key = (t1, t2, _shape_key(m, g1), _shape_key(m, g2), condim)
      groups.setdefault(key, []).append((g1, g2, ip))
    return dict(sorted(groups.items(), key=lambda kv: (kv[0][4], str(kv[0]))))

  return cached(m, "collision.candidate_groups", build)


def _numeric(m: Model, target: bytes) -> int | None:
  """Value of the custom <numeric> field named ``target``, or None."""
  for i in range(len(m.numeric_adr)):
    adr = int(m.name_numericadr[i])
    name = m.names[adr:].split(b"\x00", 1)[0]
    if name == target:
      return int(m.numeric_data[int(m.numeric_adr[i])])
  return None


def max_contact_points(m: Model) -> int | None:
  """Static contact cap from <numeric name="max_contact_points">, or None."""
  return _numeric(m, b"max_contact_points")


def max_geom_pairs(m: Model) -> int | None:
  """The per-group broadphase cap <numeric name="max_geom_pairs">, or None
  (off: every candidate pair is narrowphased)."""
  return _numeric(m, b"max_geom_pairs")


def _group_npair(m: Model, key: tuple, pairs: list) -> int:
  """Pairs of a group that the narrowphase runs: the K nearest by
  bound distance when max_geom_pairs is set, except in height-field
  groups (the field's bounding radius spans the terrain, so a centre
  distance ranks nothing)."""
  cap = max_geom_pairs(m)
  if cap is None or key[0] == GeomType.HFIELD:
    return len(pairs)
  return max(1, min(len(pairs), cap))


def _group_slots(m: Model) -> list[int]:
  """Contact slots each group writes (before the max_contact_points cap)."""
  return cached(m, "collision.group_slots", lambda: [
      _PAIR_NCON[k[:2]] * _group_npair(m, k, p) for k, p in candidate_groups(m).items()])


def _raw_ncon(m: Model) -> int:
  if m.opt.disableflags & DisableBit.CONTACT:
    return 0
  return sum(_group_slots(m))


def _compacted(m: Model) -> bool:
  """Whether the broadphase narrowphases fewer pairs than a group has."""
  return cached(m, "collision.compacted", lambda: any(
      _group_npair(m, k, p) < len(p) for k, p in candidate_groups(m).items()))


def condim_counts(m: Model) -> dict[int, int]:
  """Contact count per condim value (after the max_contact_points cap)."""
  counts: dict[int, int] = {}
  if m.opt.disableflags & DisableBit.CONTACT:
    return counts
  for key, n in zip(candidate_groups(m), _group_slots(m)):
    counts[key[4]] = counts.get(key[4], 0) + n
  cap = max_contact_points(m)
  if cap is not None and len(counts) == 1:
    k = next(iter(counts))
    counts[k] = min(counts[k], cap)
  return counts


def ncon(m: Model) -> int:
  """Static maximum number of contact points, after the optional
  max_contact_points cap (top-k by penetration; applied only when every
  contact has one condim, so efc addressing stays static)."""
  n = _raw_ncon(m)
  cap = max_contact_points(m)
  if cap is not None and n > cap:
    if len(condim_counts(m)) > 1:
      import warnings

      warnings.warn(
          "max_contact_points ignored: contacts mix condims (efc addressing"
          " would become dynamic)"
      )
      return n
    return cap
  return n


def make_condim(m: Model) -> np.ndarray:
  """Static per-contact condim array (capped), in group order."""

  def build():
    dims = []
    if not (m.opt.disableflags & DisableBit.CONTACT):
      for key, n in zip(candidate_groups(m), _group_slots(m)):
        dims += [key[4]] * n
    return np.array(dims, dtype=np.int32)[: ncon(m)]

  return cached(m, "collision.make_condim", build)


def _slot_geoms(m: Model) -> tuple[np.ndarray, np.ndarray]:
  """(geom1, geom2) of each contact the narrowphase writes, in group
  order, before the max_contact_points cap, where no group is compacted."""

  def build():
    g1, g2 = [], []
    for key, pairs in candidate_groups(m).items():
      for a, b, _ in pairs:
        g1 += [a] * _PAIR_NCON[key[:2]]
        g2 += [b] * _PAIR_NCON[key[:2]]
    return np.array(g1, dtype=np.int64), np.array(g2, dtype=np.int64)

  return cached(m, "collision.slot_geoms", build)


def contact_geoms(m: Model) -> tuple[np.ndarray, np.ndarray] | None:
  """Static (geom1, geom2) of each contact slot, or None where the
  max_contact_points cap or the max_geom_pairs broadphase picks the slots
  per env (their geoms then differ from env to env)."""
  return None if _raw_ncon(m) > ncon(m) or _compacted(m) else _slot_geoms(m)


def contact_efc_address(m: Model, ne: int, nf: int, nl: int) -> np.ndarray:
  """Static efc row address per contact (rows start after ne+nf+nl)."""
  dims = make_condim(m)
  if not len(dims):
    return np.zeros(0, np.int32)
  if m.opt.cone == ConeType.PYRAMIDAL:
    rows_per = np.where(dims == 1, 1, (dims - 1) * 2)
  else:
    rows_per = dims
  addr = ne + nf + nl + np.concatenate([[0], np.cumsum(rows_per)[:-1]])
  return addr.astype(np.int32)


# ---------------------------------------------------------------------------
# solver parameter mixing (model constants per group)
# ---------------------------------------------------------------------------


# the fields the mixed contact parameters read
_CONTACT_FIELDS = ("geom_margin", "geom_gap", "geom_solmix", "geom_friction", "geom_solref",
                   "geom_solimp", "pair_margin", "pair_gap", "pair_friction", "pair_solref",
                   "pair_solreffriction", "pair_solimp")


def _contact_params(m: Model, g: "_Group"):
  """Stacked (margin, gap, friction, solref, solreffriction, solimp) for a
  group's pairs, each (E, P, ...) with the env axis E of types.rows: B
  where randomize gave any of _CONTACT_FIELDS a row per env, else 1, the
  same in every group.  <pair> rows use the table; dynamic rows mix
  per-geom parameters by solmix weight with priority override.  Every
  index comes from the group's device tables."""
  i1, i2 = g.i1, g.i2
  gmargin, ggap = env_rows(m, "geom_margin"), env_rows(m, "geom_gap")
  margin = gmargin[:, i1] + gmargin[:, i2]
  gap = ggap[:, i1] + ggap[:, i2]

  gsolmix = env_rows(m, "geom_solmix")
  solmix1, solmix2 = gsolmix[:, i1], gsolmix[:, i2]
  small1, small2 = solmix1 < math.MINVAL, solmix2 < math.MINVAL
  mix = solmix1 / (solmix1 + solmix2)
  mix = torch.where(small1 & small2, 0.5, mix)
  mix = torch.where(small1 & ~small2, 0.0, mix)
  mix = torch.where(~small1 & small2, 1.0, mix)
  eq_prio = g.eq_prio
  mix = torch.where(eq_prio, mix, g.prio_gt.to(mix.dtype))
  mix_ = mix[..., None]

  gf, gsr, gsi = (env_rows(m, f"geom_{k}") for k in ("friction", "solref", "solimp"))
  f1, f2 = gf[:, i1], gf[:, i2]
  friction3 = torch.where(
      eq_prio[:, None], torch.maximum(f1, f2), torch.where(mix_ > 0.5, f1, f2)
  )
  sr1, sr2 = gsr[:, i1], gsr[:, i2]
  is_standard = (sr1[..., 0:1] > 0) & (sr2[..., 0:1] > 0)
  solref = torch.where(is_standard, torch.minimum(sr1, sr2), mix_ * sr1 + (1 - mix_) * sr2)
  solimp = mix_ * gsi[:, i1] + (1 - mix_) * gsi[:, i2]
  # [0, 0, 1, 2, 2] by slices: an index list would copy from the host
  f = lambda k: friction3[..., k:k + 1]
  friction = torch.cat([f(0), f(0), f(1), f(2), f(2)], dim=-1)
  solreffriction = torch.zeros_like(solref)

  E = max(env_rows(m, name).shape[0] for name in _CONTACT_FIELDS)
  out = [x.expand((E,) + x.shape[1:]).clone()
         for x in (margin, gap, friction, solref, solreffriction, solimp)]
  if g.pair_slots is not None:
    sel, tp = g.pair_slots
    for x, k in zip(out, ("margin", "gap", "friction", "solref", "solreffriction", "solimp")):
      x[:, sel] = env_rows(m, f"pair_{k}")[:, tp]
  return tuple(out)


def _group_params(m: Model) -> list[tuple]:
  """Each group's mixed contact parameters (_contact_params), in schedule
  order."""
  return cached(m, "collision.group_params",
                lambda: [_contact_params(m, g) for g in _schedule(m)], live=True)


def _collision_fn(m: Model, key: tuple, pairs: list[tuple[int, int, int]]) -> Callable:
  """fn(pos1, mat1, size1, pos2, mat2, size2) -> (dist, pos, frame) for
  one group, with its hull or height-field constants bound."""
  t1, t2, s1, s2 = key[:4]
  # the hulls: a mesh's by its id, a box's, cylinder's or ellipsoid's as
  # built for the group's first pair (every geom of such a group has the
  # same size)
  hull = lambda t, g, s: collision_convex.hull_consts(
      m.mesh_convex[s] if t == GeomType.MESH else m.geom_convex[g], m.dtype, m.device)
  if t1 == GeomType.HFIELD:
    if t2 not in (GeomType.SPHERE, GeomType.CAPSULE):
      return functools.partial(collision_hfield.hfield_convex, m=m, hid=s1,
                               hull2=hull(t2, pairs[0][1], s2))
    # the subgrid is sized by the colliding objects' own bounding radii
    # (the group's largest), not the model-wide one, which includes the
    # height field itself
    rbound = float(max(m.geom_rbound_np[p[1]] for p in pairs))
    fn = {GeomType.SPHERE: collision_hfield.hfield_sphere,
          GeomType.CAPSULE: collision_hfield.hfield_capsule}[t2]
    return functools.partial(fn, m=m, hid=s1, rbound=rbound)
  if (t1, t2) in _PRIMITIVE:
    return _PRIMITIVE[t1, t2]
  hull2 = hull(t2, pairs[0][1], s2)
  fn = {GeomType.PLANE: collision_convex.plane_convex,
        GeomType.SPHERE: collision_convex.sphere_convex,
        GeomType.CAPSULE: collision_convex.capsule_convex}.get(t1)
  if fn is not None:
    return functools.partial(fn, hull2=hull2)
  # every other pair of hulls (boxes, meshes, round geoms): SAT
  return functools.partial(collision_convex.convex_convex,
                           hull1=hull(t1, pairs[0][0], s1), hull2=hull2)


class _Group:
  """One group's narrowphase: its pair function, geom ids (P,) as tensors,
  contacts per pair, the pairs the broadphase keeps (``npair``; P where it
  keeps all), whether geom1 is a plane, and the index tables its mixed
  parameters read (_contact_params): whether each pair's geoms have equal
  priority and whether geom1's is the higher, and the slots of its
  <pair> rows with their pair ids (None without)."""

  def __init__(self, m: Model, key: tuple, pairs: list[tuple[int, int, int]]):
    self.fn = _collision_fn(m, key, pairs)
    self.i1 = torch.as_tensor([p[0] for p in pairs], device=m.device)
    self.i2 = torch.as_tensor([p[1] for p in pairs], device=m.device)
    self.n_per = _PAIR_NCON[key[:2]]
    self.npair = _group_npair(m, key, pairs)
    self.compacted = self.npair < len(pairs)
    self.plane = key[0] == GeomType.PLANE
    p1 = m.geom_priority[np.array([p[0] for p in pairs])]
    p2 = m.geom_priority[np.array([p[1] for p in pairs])]
    self.eq_prio = torch.as_tensor(p1 == p2, device=m.device)
    self.prio_gt = torch.as_tensor(p1 > p2, device=m.device)
    ip = np.array([p[2] for p in pairs])
    sel = np.where(ip >= 0)[0]
    self.pair_slots = (torch.as_tensor(sel, device=m.device),
                       torch.as_tensor(ip[sel], device=m.device)) if len(sel) else None


def _schedule(m: Model) -> list[_Group]:
  """The groups' narrowphases (model constants)."""
  return cached(m, "collision.schedule", lambda: [
      _Group(m, key, pairs) for key, pairs in candidate_groups(m).items()])


def _static_rows(m: Model):
  """(condim, efc_address) of the slots, and where no group is compacted
  the slots' mixed parameters (margin, margin + gap, friction, solref,
  solreffriction, solimp) and geoms, in group order (model constants)."""
  from mjtpu_torch._src import support

  def build():
    ne, nf, nl, _ = support.count_constraints(m)
    rows = (torch.as_tensor(make_condim(m), device=m.device),
            torch.as_tensor(contact_efc_address(m, ne, nf, nl), device=m.device))
    if _compacted(m):
      return rows, None
    geoms = tuple(torch.as_tensor(g, dtype=torch.int32, device=m.device)
                  for g in _slot_geoms(m))
    return rows, geoms

  rows, geoms = cached(m, "collision.static_rows", build)
  if geoms is None:
    return rows, None

  def params():
    rep = lambda x, g: torch.repeat_interleave(x, g.n_per, dim=1)
    margin, gap, *rest = (torch.cat([rep(p[k], g) for g, p in zip(_schedule(m), _group_params(m))],
                                    dim=1) for k in range(6))
    return (margin, margin + gap, *rest)

  return rows, cached(m, "collision.static_params", params, live=True) + geoms


def _broadphase(m: Model, d: Data, g: _Group, params: tuple) -> torch.Tensor:
  """(B, npair) the pairs of group g that the narrowphase runs in each env:
  the npair smallest bound distances, the lower pair index first on ties
  (jax.lax.top_k's order: a stable sort).  The bound is the distance of
  the two bounding spheres (for a plane, the sphere's signed height above
  it) less the detection buffer margin + gap."""
  rb = env_rows(m, "geom_rbound")
  detect = params[0] + params[1]
  x1, x2 = d.geom_xpos[:, g.i1], d.geom_xpos[:, g.i2]
  if g.plane:
    bound = math.dot3(d.geom_xmat[:, g.i1][..., :, 2], x2 - x1) - rb[:, g.i2] - detect
  else:
    bound = math.norm3(x2 - x1) - rb[:, g.i1] - rb[:, g.i2] - detect
  return torch.sort(bound, dim=1, stable=True).indices[:, :g.npair]


def collision(m: Model, d: Data) -> Data:
  """Narrowphase over all candidate groups -> d.contact (batched)."""
  B = d.qpos.shape[0]
  dtype, device = d.qpos.dtype, d.qpos.device
  n = ncon(m)
  if n == 0:
    return replace(d, contact=Contact.zero(B, 0, dtype, device))

  (dim, efc_address), static = _static_rows(m)
  bcast = lambda x: x.expand((B,) + x.shape)
  size = env_rows(m, "geom_size")  # (E, ngeom, 3)
  dists, poss, frames, slots = [], [], [], []
  params = _group_params(m) if static is None else None
  for k, g in enumerate(_schedule(m)):
    i1, i2 = g.i1, g.i2
    if g.compacted:
      # the broadphase's pairs, per env: (B, K) geom ids
      sel = _broadphase(m, d, g, params[k])
      i1, i2 = i1[sel], i2[sel]
      envs = torch.arange(B, device=device)[:, None]
      args = (d.geom_xpos[envs, i1], d.geom_xmat[envs, i1], env_expand(size, B)[envs, i1],
              d.geom_xpos[envs, i2], d.geom_xmat[envs, i2], env_expand(size, B)[envs, i2])
    else:
      args = (d.geom_xpos[:, i1], d.geom_xmat[:, i1], size[:, i1],
              d.geom_xpos[:, i2], d.geom_xmat[:, i2], size[:, i2])
    dist, pos, frame = g.fn(*args)  # (B, npair, contacts per pair, ...)
    dists.append(dist.reshape(B, -1))
    poss.append(pos.reshape(B, -1, 3))
    frames.append(frame.reshape(B, -1, 3, 3))
    if static is None:
      # each slot's parameters and geoms, (B, slots, ...)
      rep = lambda x: torch.repeat_interleave(x, g.n_per, dim=1)
      if g.compacted:
        slots.append([rep(env_expand(p, B)[envs, sel]) for p in params[k]] + [rep(i1), rep(i2)])
      else:
        slots.append([env_expand(torch.repeat_interleave(x, g.n_per, dim=1), B) for x in params[k]]
                     + [bcast(torch.repeat_interleave(x, g.n_per, dim=0)) for x in (i1, i2)])

  if static is None:
    margin, gap, friction, solref, solreffriction, solimp, geom1, geom2 = (
        torch.cat([s[k] for s in slots], dim=1) for k in range(8))
    detect, geom1, geom2 = margin + gap, geom1.to(torch.int32), geom2.to(torch.int32)
  else:
    margin, detect, friction, solref, solreffriction, solimp = (env_expand(x, B) for x in static[:6])
    geom1, geom2 = map(bcast, static[6:])

  dist = torch.cat(dists, dim=1)
  contact = Contact(
      dist=dist,
      pos=torch.cat(poss, dim=1),
      frame=torch.cat(frames, dim=1),
      # gap is an additional detection buffer beyond margin (MuJoCo >= 3);
      # includemargin is the mixed margin itself
      includemargin=margin,
      margin=detect,
      friction=friction,
      solref=solref,
      solreffriction=solreffriction,
      solimp=solimp,
      dim=bcast(dim),
      geom1=geom1,
      geom2=geom2,
      geom=torch.stack([geom1, geom2], dim=-1),
      efc_address=bcast(efc_address),
  )

  if _raw_ncon(m) > n:
    # top-k cap by penetration depth: per env, keep the n deepest contacts
    order = torch.argsort(dist, dim=1, stable=True)[:, :n]
    take = lambda x: torch.gather(
        x, 1, order.reshape(order.shape + (1,) * (x.dim() - 2)).expand(order.shape + x.shape[2:])
    )
    contact = Contact(
        dist=take(dist), pos=take(contact.pos), frame=take(contact.frame),
        includemargin=take(contact.includemargin), margin=take(contact.margin),
        friction=take(contact.friction), solref=take(contact.solref),
        solreffriction=take(contact.solreffriction), solimp=take(contact.solimp),
        dim=bcast(dim[:n]), geom1=take(geom1), geom2=take(geom2),
        geom=take(contact.geom), efc_address=bcast(efc_address[:n]),
    )
  return replace(d, contact=contact)
