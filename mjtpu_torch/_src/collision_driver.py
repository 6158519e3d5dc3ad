"""Collision driver: candidate enumeration (host) + narrowphase (device).

Port of mjtpu/_src/collision_driver.py.  Candidate enumeration is plain
numpy over the Model's static fields, computed once per Model; the
narrowphase runs once per homogeneous group (same type pair / condim) over
a (B, npair) batch of geom poses.  Contacts are ordered by group, groups
sorted by condim, so ``efc_address`` is static.

The narrowphase table holds the colliders of the ported slices: plane
against sphere, capsule and box, the sphere/capsule primitives among
themselves, sphere and capsule against a convex mesh, sphere against a
box, box against box (SAT, kernel B3) and sphere and capsule against a
height field (kernel B4).  put_model refuses a model whose candidate
pairs need any other collider.
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
)

# contact points per pair function, keyed by (type1, type2), type1 <= type2
_PAIR_NCON: dict[tuple[int, int], int] = {
    (GeomType.PLANE, GeomType.SPHERE): 1,
    (GeomType.PLANE, GeomType.CAPSULE): 2,
    (GeomType.PLANE, GeomType.BOX): 4,
    (GeomType.HFIELD, GeomType.SPHERE): 4,
    (GeomType.HFIELD, GeomType.CAPSULE): 4,
    (GeomType.SPHERE, GeomType.SPHERE): 1,
    (GeomType.SPHERE, GeomType.CAPSULE): 1,
    (GeomType.SPHERE, GeomType.BOX): 1,
    (GeomType.SPHERE, GeomType.MESH): 1,
    (GeomType.CAPSULE, GeomType.CAPSULE): 1,
    (GeomType.CAPSULE, GeomType.MESH): 2,
    (GeomType.BOX, GeomType.BOX): 4,
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
  (put_model refuses a model that sets it: the top-K broadphase waits)."""
  return _numeric(m, b"max_geom_pairs")


def _raw_ncon(m: Model) -> int:
  if m.opt.disableflags & DisableBit.CONTACT:
    return 0
  return sum(_PAIR_NCON[k[:2]] * len(p) for k, p in candidate_groups(m).items())


def condim_counts(m: Model) -> dict[int, int]:
  """Contact count per condim value (after the max_contact_points cap)."""
  counts: dict[int, int] = {}
  if m.opt.disableflags & DisableBit.CONTACT:
    return counts
  for key, pairs in candidate_groups(m).items():
    counts[key[4]] = counts.get(key[4], 0) + _PAIR_NCON[key[:2]] * len(pairs)
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
      for key, pairs in candidate_groups(m).items():
        dims += [key[4]] * (_PAIR_NCON[key[:2]] * len(pairs))
    return np.array(dims, dtype=np.int32)[: ncon(m)]

  return cached(m, "collision.make_condim", build)


def _slot_geoms(m: Model) -> tuple[np.ndarray, np.ndarray]:
  """(geom1, geom2) of each contact the narrowphase writes, in group
  order, before the max_contact_points cap."""

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
  max_contact_points cap picks the slots per env (their geoms then differ
  from env to env)."""
  return None if _raw_ncon(m) > ncon(m) else _slot_geoms(m)


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


def _contact_params(m: Model, pairs: list[tuple[int, int, int]]):
  """Stacked (margin, gap, friction, solref, solreffriction, solimp) for a
  group's pairs.  <pair> rows use the table; dynamic rows mix per-geom
  parameters by solmix weight with priority override."""
  i1 = np.array([p[0] for p in pairs])
  i2 = np.array([p[1] for p in pairs])
  ip = np.array([p[2] for p in pairs])

  p1, p2 = m.geom_priority[i1], m.geom_priority[i2]
  margin = m.geom_margin[i1] + m.geom_margin[i2]
  gap = m.geom_gap[i1] + m.geom_gap[i2]

  solmix1, solmix2 = m.geom_solmix[i1], m.geom_solmix[i2]
  small1, small2 = solmix1 < math.MINVAL, solmix2 < math.MINVAL
  mix = solmix1 / (solmix1 + solmix2)
  mix = torch.where(small1 & small2, 0.5, mix)
  mix = torch.where(small1 & ~small2, 0.0, mix)
  mix = torch.where(~small1 & small2, 1.0, mix)
  dev = margin.device
  eq_prio = torch.as_tensor(p1 == p2, device=dev)
  mix = torch.where(eq_prio, mix, torch.as_tensor(p1 > p2, device=dev).to(mix.dtype))
  mix_ = mix[:, None]

  f1, f2 = m.geom_friction[i1], m.geom_friction[i2]
  friction3 = torch.where(
      eq_prio[:, None], torch.maximum(f1, f2), torch.where(mix_ > 0.5, f1, f2)
  )
  sr1, sr2 = m.geom_solref[i1], m.geom_solref[i2]
  is_standard = (sr1[:, 0:1] > 0) & (sr2[:, 0:1] > 0)
  solref = torch.where(is_standard, torch.minimum(sr1, sr2), mix_ * sr1 + (1 - mix_) * sr2)
  solimp = mix_ * m.geom_solimp[i1] + (1 - mix_) * m.geom_solimp[i2]
  friction = friction3[:, [0, 0, 1, 2, 2]]
  solreffriction = torch.zeros_like(solref)

  rows = np.where(ip >= 0)[0]
  if len(rows):
    tp = ip[rows]
    margin[rows] = m.pair_margin[tp]
    gap[rows] = m.pair_gap[tp]
    friction[rows] = m.pair_friction[tp]
    solref[rows] = m.pair_solref[tp]
    solreffriction[rows] = m.pair_solreffriction[tp]
    solimp[rows] = m.pair_solimp[tp]
  return margin, gap, friction, solref, solreffriction, solimp


def _collision_fn(m: Model, key: tuple, pairs: list[tuple[int, int, int]]) -> Callable:
  """fn(pos1, mat1, size1, pos2, mat2, size2) -> (dist, pos, frame) for
  one group, with its hull or height-field constants bound."""
  t1, t2, s1, s2 = key[:4]
  if t1 == GeomType.HFIELD:
    # the subgrid is sized by the colliding objects' own bounding radii
    # (the group's largest), not the model-wide one, which includes the
    # height field itself
    rbound = float(max(m.geom_rbound_np[p[1]] for p in pairs))
    fn = {GeomType.SPHERE: collision_hfield.hfield_sphere,
          GeomType.CAPSULE: collision_hfield.hfield_capsule}[t2]
    return functools.partial(fn, m=m, hid=s1, rbound=rbound)
  # the hulls: a mesh's by its id, a box's as built for the group's first
  # pair (every geom of a box group has the same size)
  hull = lambda t, g, s: collision_convex.hull_consts(
      m.mesh_convex[s] if t == GeomType.MESH else m.geom_convex[g], m.dtype, m.device)
  if t2 in (GeomType.MESH, GeomType.BOX):
    hull2 = hull(t2, pairs[0][1], s2)
    if t1 == GeomType.BOX:
      return functools.partial(collision_convex.convex_convex,
                               hull1=hull(t1, pairs[0][0], s1), hull2=hull2)
    fn = {GeomType.PLANE: collision_convex.plane_convex,
          GeomType.SPHERE: collision_convex.sphere_convex,
          GeomType.CAPSULE: collision_convex.capsule_convex}[t1]
    return functools.partial(fn, hull2=hull2)
  return {
      (GeomType.PLANE, GeomType.SPHERE): collision_primitive.plane_sphere,
      (GeomType.PLANE, GeomType.CAPSULE): collision_primitive.plane_capsule,
      (GeomType.SPHERE, GeomType.SPHERE): collision_primitive.sphere_sphere,
      (GeomType.SPHERE, GeomType.CAPSULE): collision_primitive.sphere_capsule,
      (GeomType.CAPSULE, GeomType.CAPSULE): collision_primitive.capsule_capsule,
  }[(t1, t2)]


def _schedule(m: Model):
  """Per group: (pair fn, geom1 ids, geom2 ids as tensors, mixed
  parameters repeated per contact) — model constants."""

  def build():
    out = []
    for key, pairs in candidate_groups(m).items():
      n_per = _PAIR_NCON[key[:2]]
      i1 = torch.as_tensor([p[0] for p in pairs], device=m.device)
      i2 = torch.as_tensor([p[1] for p in pairs], device=m.device)
      params = tuple(
          torch.repeat_interleave(p, n_per, dim=0) for p in _contact_params(m, pairs)
      )
      out.append((_collision_fn(m, key, pairs), i1, i2, params))
    return out

  return cached(m, "collision.schedule", build)


def collision(m: Model, d: Data) -> Data:
  """Narrowphase over all candidate groups -> d.contact (batched)."""
  from mjtpu_torch._src import support

  B = d.qpos.shape[0]
  dtype, device = d.qpos.dtype, d.qpos.device
  n = ncon(m)
  if n == 0:
    return replace(d, contact=Contact.zero(B, 0, dtype, device))

  ne, nf, nl, _ = support.count_constraints(m)
  dists, poss, frames, params = [], [], [], []
  for fn, i1, i2, prm in _schedule(m):
    dist, pos, frame = fn(
        d.geom_xpos[:, i1], d.geom_xmat[:, i1], m.geom_size[i1],
        d.geom_xpos[:, i2], d.geom_xmat[:, i2], m.geom_size[i2],
    )  # (B, npair, contacts per pair, ...)
    dists.append(dist.reshape(B, -1))
    poss.append(pos.reshape(B, -1, 3))
    frames.append(frame.reshape(B, -1, 3, 3))
    params.append(prm)

  margin, gap, friction, solref, solreffriction, solimp = (
      torch.cat([p[k] for p in params]) for k in range(6)
  )
  bcast = lambda x: x.expand((B,) + x.shape)
  dim, efc_address, geom1, geom2 = cached(m, "collision.static_rows", lambda: (
      torch.as_tensor(make_condim(m), device=device),
      torch.as_tensor(contact_efc_address(m, ne, nf, nl), device=device),
      *(torch.as_tensor(g, dtype=torch.int32, device=device) for g in _slot_geoms(m)),
  ))
  geom1, geom2 = bcast(geom1), bcast(geom2)

  dist = torch.cat(dists, dim=1)
  contact = Contact(
      dist=dist,
      pos=torch.cat(poss, dim=1),
      frame=torch.cat(frames, dim=1),
      # gap is an additional detection buffer beyond margin (MuJoCo >= 3);
      # includemargin is the mixed margin itself
      includemargin=bcast(margin),
      margin=bcast(margin + gap),
      friction=bcast(friction),
      solref=bcast(solref),
      solreffriction=bcast(solreffriction),
      solimp=bcast(solimp),
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
