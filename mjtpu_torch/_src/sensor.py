"""Sensors: the position, velocity and acceleration stages.

Port of mjtpu/_src/sensor.py, batch-explicit, for the sensor types of
io.SENSORS_PORTED (put_model refuses the others by name).  As in mjtpu,
the sensors of a stage are grouped on the host by (type, objtype,
reftype, datatype, dim), and each group runs as one batched computation
over its K sensors and the B envs.  A stage's groups are written into
sensordata together: their values are concatenated, clamped at each
sensor's cutoff as its datatype says (mjtpu's ``_write``) and put in
place with one indexed write.  The rangefinders of a group cast all
their rays at once (ray.cast), and the geom-distance sensors of every
group share one support.geom_distances call (one collider call per pair
type).  The index tables live on the Model's device (Model.cache), so a
step makes no host copy.
"""

from __future__ import annotations

import numpy as np
import torch

from mjtpu_torch._src import collision_driver, math, ray, smooth, support
from mjtpu_torch._src.dataclasses import replace
from mjtpu_torch._src.io import GEOMDIST_SENSORS
from mjtpu_torch._src.types import (
    Data,
    DataType,
    DisableBit,
    EnableBit,
    GeomType,
    JointType,
    Model,
    ObjType,
    SensorType,
    Stage,
    TrnType,
    cached,
    index,
    rows as env_rows,
)

_NO_REF = -2  # reftype of a sensor without a reference frame

_AXIS_COL = {SensorType.FRAMEXAXIS: 0, SensorType.FRAMEYAXIS: 1, SensorType.FRAMEZAXIS: 2}

# the acceleration sensors that read rne_postconstraint's cacc, cfrc_int
# or cfrc_ext (TOUCH too, in mjtpu)
_NEEDS_RNEPOST = frozenset((
    SensorType.ACCELEROMETER, SensorType.FORCE, SensorType.TORQUE, SensorType.FRAMELINACC,
    SensorType.FRAMEANGACC, SensorType.TOUCH))
_NEEDS_SUBTREE_VEL = frozenset((SensorType.SUBTREELINVEL, SensorType.SUBTREEANGMOM))


class _Group:
  """One sensor group's static tables: ids, objid and refid (numpy), and
  the same and the objects' bodies as device tensors (``t``)."""

  def __init__(self, m: Model, key: tuple, ids: list[int]):
    self.stype, self.objtype, self.reftype, self.datatype, self.dim = key
    self.stype = SensorType(self.stype)
    self.ids = np.asarray(ids)
    self.objid = np.asarray(m.sensor_objid)[self.ids]
    self.refid = np.asarray(m.sensor_refid)[self.ids]
    self.has_ref = self.reftype != _NO_REF
    self.t = {}
    tensor = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.long, device=m.device)
    self.t["objid"] = tensor(self.objid)
    self.t["refid"] = tensor(self.refid)
    self.extra = {}


def _groups(m: Model, stage: Stage) -> list[_Group]:
  """The stage's sensor groups in model order of their first sensor."""

  def build():
    out: dict = {}
    for i in range(m.nsensor):
      if int(m.sensor_needstage[i]) != stage:
        continue
      key = (
          int(m.sensor_type[i]),
          int(m.sensor_objtype[i]),
          int(m.sensor_reftype[i]) if int(m.sensor_refid[i]) >= 0 else _NO_REF,
          int(m.sensor_datatype[i]),
          int(m.sensor_dim[i]),
      )
      out.setdefault(key, []).append(i)
    return [_Group(m, key, ids) for key, ids in out.items()]

  return cached(m, ("sensor.groups", int(stage)), build)


def _writer(m: Model, stage: Stage):
  """(flat sensordata addresses, lower and upper clamp) of the stage's
  groups' values concatenated in group order: a REAL sensor with a
  positive cutoff clamps to [-cutoff, cutoff], a POSITIVE one to
  (-inf, cutoff], every other sensor (and every CONTACT sensor) not at
  all."""

  def build():
    adrs, dts, cut_ids = [], [], []
    for g in _groups(m, stage):
      adr = np.asarray(m.sensor_adr)[g.ids]
      adrs.append((adr[:, None] + np.arange(g.dim)[None]).reshape(-1))
      dts.append(np.full(len(g.ids) * g.dim, g.datatype))
      cut_ids.append(np.repeat(g.ids, g.dim))
    flat = np.concatenate(adrs)
    dt = np.concatenate(dts)
    ids = np.concatenate(cut_ids)
    t = lambda x: torch.as_tensor(x, device=m.device)
    # C applies no cutoff to a CONTACT sensor
    return (t(flat.astype(np.int64)), t(ids), t(np.asarray(m.sensor_type)[ids] != SensorType.CONTACT),
            t(dt == DataType.REAL), t(dt == DataType.POSITIVE))

  flat, ids, clamped, real, positive = cached(m, ("sensor.writer_index", int(stage)), build)

  def clamps():
    # the clamps have the env axis of env_rows: (E, n)
    cut = env_rows(m, "sensor_cutoff")[:, ids]
    on = (cut > 0) & clamped
    return (torch.where(on & real, -cut, -torch.inf),
            torch.where(on & (real | positive), cut, torch.inf))

  lo, hi = cached(m, ("sensor.writer", int(stage)), clamps, live=True)
  return flat, lo, hi


def _write(m: Model, d: Data, stage: Stage, vals: list[torch.Tensor]) -> torch.Tensor:
  """sensordata with the stage's group values (each (B, K, dim) or (B,
  K)) clamped at their cutoffs and written in place."""
  if not vals:
    return d.sensordata
  flat, lo, hi = _writer(m, stage)
  B = d.qpos.shape[0]
  v = torch.cat([x.reshape(B, -1).to(d.sensordata.dtype) for x in vals], dim=1)
  sd = d.sensordata.clone()
  sd[:, flat] = torch.minimum(torch.maximum(v, lo), hi)
  return sd


# ---------------------------------------------------------------------------
# object frames
# ---------------------------------------------------------------------------


def _obj_pos_mat(d: Data, objtype: int, ids: torch.Tensor):
  """(pos (B, K, 3), mat (B, K, 3, 3)) of K object frames of one type."""
  objtype = ObjType(objtype)
  pos, mat = {
      ObjType.BODY: (d.xipos, d.ximat), ObjType.XBODY: (d.xpos, d.xmat),
      ObjType.GEOM: (d.geom_xpos, d.geom_xmat), ObjType.SITE: (d.site_xpos, d.site_xmat),
      ObjType.CAMERA: (d.cam_xpos, d.cam_xmat),
  }[objtype]
  return pos[:, ids], mat[:, ids]


def _obj_bodyid(m: Model, objtype: int, ids: np.ndarray) -> np.ndarray:
  objtype = ObjType(objtype)
  if objtype in (ObjType.BODY, ObjType.XBODY):
    return np.asarray(ids)
  field = {ObjType.GEOM: "geom_bodyid", ObjType.SITE: "site_bodyid",
           ObjType.CAMERA: "cam_bodyid"}[objtype]
  return np.asarray(getattr(m, field))[ids]


def _body_tables(m: Model, g: _Group, objtype: int, which: str = "objid"):
  """Device tensors of the group's objects' bodies, their root bodies, and
  whether each body is welded to the world, cached on the group."""
  key = ("bodies", objtype, which)
  if key not in g.extra:
    ids = g.objid if which == "objid" else g.refid
    b = _obj_bodyid(m, objtype, ids)
    t = lambda x: torch.as_tensor(np.asarray(x), device=m.device)
    g.extra[key] = (t(b), t(np.asarray(m.body_rootid)[b]),
                    t(np.asarray(m.body_weldid)[b] == 0))
  return g.extra[key]


def _rot(mat: torch.Tensor, local: bool):
  """The rotation into the object frame (its transpose) or None: world."""
  return mat.transpose(-1, -2) if local else None


def _transform_motion(vel, offset, rot):
  if rot is None:  # world axes: mjtpu multiplies by the identity
    ang, lin = vel[..., :3], vel[..., 3:]
    return torch.cat([ang, lin - math.cross(offset, ang)], dim=-1)
  return math.transform_motion(vel, offset, rot)


def _object_velocity(m, d, g, objtype, which, local):
  """(B, K, 6) (ang, lin) velocities of object frames (mj_objectVelocity)."""
  ids = g.t[which]
  pos, mat = _obj_pos_mat(d, objtype, ids)
  b, root, _ = _body_tables(m, g, objtype, which)
  return _transform_motion(d.cvel[:, b], pos - d.subtree_com[:, root], _rot(mat, local))


def _object_acceleration(m, d, g, objtype, local):
  """(B, K, 6) accelerations of object frames (mj_objectAcceleration);
  objects in the world's weld subtree read 0."""
  pos, mat = _obj_pos_mat(d, objtype, g.t["objid"])
  b, root, static = _body_tables(m, g, objtype)
  offset, rot = pos - d.subtree_com[:, root], _rot(mat, local)
  acc = _transform_motion(d.cacc[:, b], offset, rot)
  vel = _transform_motion(d.cvel[:, b], offset, rot)
  # the centripetal correction w x v on the linear part
  acc = torch.cat([acc[..., :3], acc[..., 3:] + math.cross(vel[..., :3], vel[..., 3:])], dim=-1)
  return torch.where(static[:, None], 0.0, acc)


def _frame_quat(m: Model, d: Data, objtype: int, ids: torch.Tensor):
  """(B, K, 4) frame quaternions of one object type (FRAMEQUAT)."""
  objtype = ObjType(objtype)
  if objtype == ObjType.BODY:
    return math.quat_mul(d.xquat[:, ids], env_rows(m, "body_iquat")[:, ids])
  if objtype == ObjType.XBODY:
    return d.xquat[:, ids]
  if objtype == ObjType.GEOM:
    return math.quat_mul(d.xquat[:, index(m, "geom_bodyid")[ids]], env_rows(m, "geom_quat")[:, ids])
  if objtype == ObjType.SITE:
    return math.quat_mul(d.xquat[:, index(m, "site_bodyid")[ids]], env_rows(m, "site_quat")[:, ids])
  return math.mat_to_quat(d.cam_xmat[:, ids])


def _inside(stype: int, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
  """Whether points q (..., 3), in a site's frame, lie inside the site's
  volume of type ``stype`` and size s (..., 3) (mju_insideGeom)."""
  if stype == GeomType.SPHERE:
    return math.dot3(q, q) <= s[..., 0] * s[..., 0]
  if stype == GeomType.CAPSULE:
    z = torch.minimum(torch.maximum(q[..., 2], -s[..., 1]), s[..., 1])
    dz = q[..., 2] - z
    return q[..., 0] * q[..., 0] + q[..., 1] * q[..., 1] + dz * dz <= s[..., 0] * s[..., 0]
  if stype == GeomType.ELLIPSOID:
    r = q / s
    return math.dot3(r, r) <= 1.0
  if stype == GeomType.CYLINDER:
    return (torch.abs(q[..., 2]) <= s[..., 1]) & (
        q[..., 0] * q[..., 0] + q[..., 1] * q[..., 1] <= s[..., 0] * s[..., 0])
  if stype == GeomType.BOX:
    return torch.all(torch.abs(q) <= s, dim=-1)
  raise NotImplementedError(f"site zone of type {stype}")


def _site_types(m: Model, g: _Group, sites: np.ndarray):
  """Per site type among ``sites``: (type, positions within the group,
  their sites), device tensors cached on the group."""
  if "site_types" not in g.extra:
    st = np.asarray(m.site_type)[sites]
    t = lambda x: torch.as_tensor(x, dtype=torch.long, device=m.device)
    g.extra["site_types"] = [(int(k), t(np.nonzero(st == k)[0]), t(sites[st == k]))
                             for k in sorted(set(int(x) for x in st))]
  return g.extra["site_types"]


def _inside_sites(m: Model, g: _Group, sites: np.ndarray, q: torch.Tensor) -> torch.Tensor:
  """(B, K, ...) bool: points q (B, K, ..., 3), each in the frame of its
  group's site, inside the site's volume; one batch per site type."""
  out = torch.zeros(q.shape[:-1], dtype=torch.bool, device=q.device)
  for stype, pos, sid in _site_types(m, g, sites):
    s = env_rows(m, "site_size")[:, sid]
    s = s.reshape(s.shape[:2] + (1,) * (q.dim() - 3) + (3,))
    out[:, pos] = _inside(stype, q[:, pos], s)
  return out


_TENDON_LIMIT = frozenset((SensorType.TENDONLIMITPOS, SensorType.TENDONLIMITVEL,
                           SensorType.TENDONLIMITFRC))


def _limit_rows(m: Model, ids: np.ndarray, tendon: bool = False) -> np.ndarray:
  """(K, 2) efc rows of each joint's (or tendon's) lower and upper limit,
  -1 where the model emits none; an object with one limit row repeats it
  (mjtpu's _limit_efc_rows, support.efc_row_meta's layout: the limited
  joints in joint order, then the limited tendons)."""
  ne, nf, nl, _ = support.count_constraints(m)
  rows = np.full((len(ids), 2), -1)
  if nl == 0:
    return rows
  jt = np.asarray(m.jnt_type)
  two = np.asarray(m.jnt_limit_two_sided)
  start, lookup = ne + nf, {}
  for j in np.nonzero(np.asarray(m.jnt_limited))[0]:
    n = 2 if (jt[j] != JointType.BALL and two[j]) else 1
    lookup[int(j)] = (start, start + n - 1)
    start += n
  if tendon:
    per = support.tendon_limit_rows_per(m)
    lookup = {int(t): (start + per * k, start + per * k + per - 1)
              for k, t in enumerate(np.nonzero(np.asarray(m.tendon_limited))[0])}
  for k, j in enumerate(np.asarray(ids)):
    if int(j) in lookup:
      rows[k] = lookup[int(j)]
  return rows


def _limit_read(m: Model, d: Data, g: _Group, field) -> torch.Tensor:
  """A joint (tendon) limit sensor reads the first live limit row of its
  joint (tendon) (C makes a row only while that side's dist < margin):
  the lower row where active, else the upper, else 0.  ``field(rows)``
  reads the (B, K) values of static rows (K,)."""
  if "limit_rows" not in g.extra:
    rows = _limit_rows(m, g.objid, g.stype in _TENDON_LIMIT)
    ok = rows[:, 0] >= 0
    t = lambda x: torch.as_tensor(x, device=m.device)
    g.extra["limit_rows"] = (bool(ok.any()), t(ok), t(np.where(ok, rows[:, 0], 0)),
                             t(np.where(ok, rows[:, 1], 0)))
  any_ok, ok, r_lo, r_hi = g.extra["limit_rows"]
  B = d.qpos.shape[0]
  if not any_ok:
    return d.qpos.new_zeros((B, len(g.ids)))
  pos_lo, pos_hi = d.efc_pos[:, r_lo], d.efc_pos[:, r_hi]
  lo_active = ok & (pos_lo < 0)
  hi_active = ok & (pos_hi < 0)
  val = torch.where(lo_active, field(r_lo, pos_lo), field(r_hi, pos_hi))
  return torch.where(lo_active | hi_active, val, 0.0)


def _tendon_actuators(m: Model, g: _Group) -> torch.Tensor:
  """(K, nu) 0/1: actuator u has a tendon transmission to sensor k's
  tendon, cached on the group."""
  if "tendon_actuators" not in g.extra:
    trn = np.asarray(m.actuator_trntype) == TrnType.TENDON
    target = np.asarray(m.actuator_trnid)[:, 0]
    mask = trn[None, :] & (target[None, :] == np.asarray(g.objid)[:, None])
    g.extra["tendon_actuators"] = torch.as_tensor(mask, dtype=m.dtype, device=m.device)
  return g.extra["tendon_actuators"]


def _rangefinder(m: Model, d: Data, g: _Group) -> torch.Tensor:
  """(B, K) distance from each rangefinder site along its z axis to the
  nearest geom not on the site's body, -1 on a miss (mj_ray with
  flg_static and no group filter)."""
  if "candidates" not in g.extra:
    bodies = np.asarray(m.site_bodyid)[g.objid]
    g.extra["candidates"] = tuple(
        tuple(int(x) for x in ray.candidate_geoms(m, None, True, int(b))) for b in bodies)
  sid = g.t["objid"]
  dist, _ = ray.cast(m, d, d.site_xpos[:, sid], d.site_xmat[:, sid, :, 2], g.extra["candidates"])
  return dist


def _operand_geoms(m: Model, objtype: int, oid: int) -> list[int]:
  """A geom-distance operand's geoms: the geom, or every geom of the body."""
  if ObjType(objtype) == ObjType.GEOM:
    return [int(oid)]
  adr, num = int(m.body_geomadr[oid]), int(m.body_geomnum[oid])
  return list(range(adr, adr + num))


def _geomdist_tables(m: Model) -> dict:
  """The pairs of every GEOMDIST, GEOMNORMAL and GEOMFROMTO sensor of the
  model, in group order (g1, g2 and each pair's sensor on the device), and per
  group its (K, P) table of positions in that list, padded with the
  position of an extra column of +inf distance."""
  g1, g2, cut_ids, tables = [], [], [], {}
  for g in _groups(m, Stage.POS):
    if g.stype not in GEOMDIST_SENSORS:
      continue
    lists = [[(a, b) for a in _operand_geoms(m, g.objtype, o)
              for b in _operand_geoms(m, g.reftype, r)] for o, r in zip(g.objid, g.refid)]
    table = np.full((len(lists), max(len(ps) for ps in lists)), -1)
    for k, (sid, ps) in enumerate(zip(g.ids, lists)):
      table[k, :len(ps)] = np.arange(len(g1), len(g1) + len(ps))
      g1 += [p[0] for p in ps]
      g2 += [p[1] for p in ps]
      cut_ids += [sid] * len(ps)
    tables[tuple(g.ids)] = table
  t = lambda x: torch.as_tensor(np.asarray(x), device=m.device)
  return dict(g1=g1, g2=g2, cut_ids=t(np.asarray(cut_ids, dtype=np.int64)),
              tables={k: t(np.where(v < 0, len(g1), v)) for k, v in tables.items()})


def _geom_distances(m: Model, d: Data):
  """(dist (B, P + 1), fromto (B, P + 1, 6)) of every geom-distance
  sensor's pairs (_geomdist_tables), the last column the padding's: the
  stage's sensors share one support.geom_distances call, so each collider
  runs once over all of them."""
  c = cached(m, "sensor.geomdist", lambda: _geomdist_tables(m))
  cut = cached(m, "sensor.geomdist_cutoff",
               lambda: env_rows(m, "sensor_cutoff")[:, c["cut_ids"]], live=True)
  dist, fromto = support.geom_distances(m, d, c["g1"], c["g2"], cut)
  B = dist.shape[0]
  return (torch.cat([dist, dist.new_full((B, 1), torch.inf)], dim=1),
          torch.cat([fromto, fromto.new_zeros((B, 1, 6))], dim=1))


def _geom_distance(m: Model, g: _Group, dist: torch.Tensor, fromto: torch.Tensor) -> torch.Tensor:
  """(B, K, dim) GEOMDIST, GEOMNORMAL or GEOMFROMTO (mj_geomDistance) from
  the stage's pair distances (_geom_distances): the sensor's cutoff is
  distmax; a body operand takes, over its geoms' pairs, the first pair of
  least distance (mjtpu's loop keeps a pair only where it is strictly
  nearer); the normal is normalize(to - from), zero where nothing lies
  below distmax."""
  table = cached(m, "sensor.geomdist", lambda: _geomdist_tables(m))["tables"][tuple(g.ids)]
  key = tuple(int(i) for i in g.ids)
  ids = cached(m, ("sensor.group_ids", key), lambda: torch.as_tensor(g.ids, device=m.device))
  cut = cached(m, ("sensor.group_cutoff", key),
               lambda: env_rows(m, "sensor_cutoff")[:, ids], live=True)
  dmin, i = torch.min(dist[:, table], dim=-1)  # (B, K)
  ft = torch.gather(fromto[:, table], 2, i[..., None, None].expand(i.shape + (1, 6)))[:, :, 0]
  ft = torch.where((dmin < cut)[..., None], ft, 0.0)
  if g.stype == SensorType.GEOMDIST:
    return torch.minimum(dmin, cut)
  if g.stype == SensorType.GEOMFROMTO:
    return ft
  n = ft[..., 3:] - ft[..., :3]
  norm = math.norm3(n)[..., None]
  return torch.where(norm > 1e-15, n / torch.clamp_min(norm, 1e-15), 0.0)


def _camprojection(m: Model, d: Data, g: _Group) -> torch.Tensor:
  """(B, K, 2) the target site in the camera's pixel coordinates
  (mjtpu's CAMPROJECTION): the focal lengths from cam_intrinsic over
  cam_sensorsize where the sensor size is set, else from fovy; the
  principal point is ignored; the camera looks along its -z."""
  if "focal" not in g.extra:
    cam = g.refid
    res = np.asarray(m.cam_resolution)[cam].astype(np.float64)
    ss = np.asarray(m.cam_sensorsize)[cam]
    intr = np.asarray(m.cam_intrinsic)[cam]
    fovy_f = 0.5 * res[:, 1] / np.tan(np.deg2rad(np.asarray(m.cam_fovy)[cam]) / 2)
    has_ss = ss[:, 0] > 0
    fx = np.where(has_ss, intr[:, 0] / np.where(has_ss, ss[:, 0], 1.0) * res[:, 0], fovy_f)
    fy = np.where(has_ss, intr[:, 1] / np.where(has_ss, ss[:, 1], 1.0) * res[:, 1], fovy_f)
    t = lambda x: torch.as_tensor(x, dtype=m.dtype, device=m.device)
    g.extra["focal"] = (t(fx), t(fy), t(res[:, 0] / 2), t(res[:, 1] / 2))
  fx, fy, cx, cy = g.extra["focal"]
  cam = g.t["refid"]
  p = math.mat_t_vec(d.cam_xmat[:, cam], d.site_xpos[:, g.t["objid"]] - d.cam_xpos[:, cam])
  u = -p[..., 0] / p[..., 2] * fx + cx
  v = p[..., 1] / p[..., 2] * fy + cy
  return torch.stack([u, v], dim=-1)


# a CONTACT sensor's data fields (sensor_intprm[0] bits) in slot order,
# with their widths, and its reduce modes (sensor_intprm[1])
_CONTACT_FIELDS = ((1, "found", 1), (2, "force", 3), (4, "torque", 3), (8, "dist", 1),
                   (16, "pos", 3), (32, "normal", 3), (64, "tangent", 3))
_REDUCE_NONE, _REDUCE_MINDIST, _REDUCE_MAXFORCE, _REDUCE_NETFORCE = 0, 1, 2, 3


def _subtree_mask(m: Model, root: int) -> np.ndarray:
  """(nbody,) bool: the bodies of the subtree rooted at ``root``."""
  parent = np.asarray(m.body_parentid)
  mask = np.zeros(m.nbody, dtype=bool)
  mask[root] = True
  for b in range(m.nbody):
    i = b
    while i != 0 and i != root:
      i = int(parent[i])
    mask[b] |= i == root
  return mask


def _contact_criteria(m: Model, sidx: int) -> list:
  """A CONTACT sensor's criteria, host tables: per operand (object, then
  reference) that is set, ("site", its site, its type) or ("sided", the
  (nbody,) or (ngeom,) mask of what matches, "geom" or "body")."""
  out = []
  for otype, oid in ((int(m.sensor_objtype[sidx]), int(m.sensor_objid[sidx])),
                     (int(m.sensor_reftype[sidx]), int(m.sensor_refid[sidx]))):
    if oid < 0 or otype == ObjType.UNKNOWN:
      continue
    t = lambda x: torch.as_tensor(x, device=m.device)
    if otype == ObjType.SITE:
      out.append(("site", oid, int(np.asarray(m.site_type)[oid])))
    elif otype == ObjType.GEOM:
      mask = np.zeros(m.ngeom, dtype=bool)
      mask[oid] = True
      out.append(("sided", t(mask), "geom"))
    elif otype == ObjType.BODY:
      mask = np.zeros(m.nbody, dtype=bool)
      mask[oid] = True
      out.append(("sided", t(mask), "body"))
    elif otype == ObjType.XBODY:  # the subtree criterion
      out.append(("sided", t(_subtree_mask(m, oid)), "body"))
    else:
      raise NotImplementedError(f"contact sensor criterion objtype {otype}")
  return out


def _contact(m: Model, d: Data, g: _Group) -> torch.Tensor:
  """(B, K, dim) CONTACT sensors (mjtpu's _contact_sensor): the contacts
  that match the sensor's criteria (geom, body and subtree sided; a
  site's volume holding the contact point), each oriented so that the
  first matched object is object 1 (a flip negates the normal, the
  tangent and the t2 components of force and torque); ``found`` the
  number of matches, in filled slots only; reduce none (the first
  ``num`` matches in contact order), mindist, maxforce, or netforce (the
  world-frame sums about the force-weighted centroid, in the pos field).
  No cutoff (_writer)."""
  B = d.qpos.shape[0]
  if collision_driver.ncon(m) == 0:  # nothing writes the sensor
    adr = np.asarray(m.sensor_adr)[g.ids][:, None] + np.arange(g.dim)
    return d.sensordata[:, torch.as_tensor(adr, device=d.qpos.device)]
  con = d.contact
  forces6 = support.contact_forces(m, d)
  detected = con.dist < con.margin
  geom1, geom2 = con.geom1.long(), con.geom2.long()
  bodyid = index(m, "geom_bodyid")
  body1, body2 = bodyid[geom1], bodyid[geom2]
  if "criteria" not in g.extra:
    g.extra["criteria"] = [_contact_criteria(m, int(i)) for i in g.ids]
  out = []
  for sidx, criteria in zip(g.ids, g.extra["criteria"]):
    dataspec, reduce_, num = (int(x) for x in np.asarray(m.sensor_intprm)[sidx])
    match, sided = detected, []
    for kind, obj, extra in criteria:
      if kind == "site":
        q = math.mat_t_vec(d.site_xmat[:, obj, None], con.pos - d.site_xpos[:, obj, None])
        match = match & _inside(extra, q, env_rows(m, "site_size")[:, obj, None])
      else:
        ids1, ids2 = (geom1, geom2) if extra == "geom" else (body1, body2)
        sided.append((obj[ids1], obj[ids2]))
    if len(sided) == 1:
      (m1, m2), = sided
      match, flip = match & (m1 | m2), m2 & ~m1
    elif len(sided) == 2:
      (a1, a2), (b1, b2) = sided
      fwd, rev = a1 & b2, a2 & b1
      match, flip = match & (fwd | rev), rev & ~fwd
    else:
      flip = torch.zeros_like(match)
    found = match.sum(dim=-1).to(d.qpos.dtype)  # (B,)
    sgn = torch.where(flip, -1.0, 1.0).to(d.qpos.dtype)
    t2flip = torch.stack([torch.ones_like(sgn), torch.ones_like(sgn), sgn], dim=-1)
    any_found = (found > 0).to(d.qpos.dtype)[:, None]
    names = [name for bit, name, _ in _CONTACT_FIELDS if dataspec & bit]
    if reduce_ == _REDUCE_NETFORCE:
      mf = match.to(d.qpos.dtype)
      f_w = math.mat_t_vec(con.frame, forces6[..., :3]) * sgn[..., None]
      t_w = math.mat_t_vec(con.frame, forces6[..., 3:]) * sgn[..., None]
      w = mf * math.norm3(forces6[..., :3])
      pos_c = torch.sum(w[..., None] * con.pos, dim=1) / torch.clamp_min(
          torch.sum(w, dim=1), 1e-15)[:, None]
      f_net = torch.sum(mf[..., None] * f_w, dim=1)
      t_net = torch.sum(mf[..., None] * (math.cross(con.pos - pos_c[:, None], f_w) + t_w), dim=1)
      zero = lambda n: d.qpos.new_zeros((B, n))
      slot = {"force": f_net * any_found, "torque": t_net * any_found,
              "pos": pos_c * any_found, "dist": zero(1), "normal": zero(3), "tangent": zero(3),
              "found": found[:, None]}
      row = torch.cat([slot[n] for n in names], dim=-1)
      out.append(row[:, None].expand(B, num, row.shape[-1]).reshape(B, -1))
      continue
    fields = {
        "force": forces6[..., :3] * t2flip, "torque": forces6[..., 3:] * t2flip,
        "dist": con.dist[..., None], "pos": con.pos,
        "normal": con.frame[..., 0, :] * sgn[..., None],
        "tangent": con.frame[..., 1, :] * sgn[..., None],
        "found": d.qpos.new_zeros(con.dist.shape + (1,)),
    }
    rows = torch.cat([fields[n] for n in names], dim=-1)  # (B, ncon, slotdim)
    if reduce_ in (_REDUCE_MINDIST, _REDUCE_MAXFORCE):
      if reduce_ == _REDUCE_MINDIST:
        i = torch.argmin(torch.where(match, con.dist, torch.inf), dim=-1)
      else:
        i = torch.argmax(torch.where(match, forces6[..., 0], -torch.inf), dim=-1)
      row = torch.gather(rows, 1, i[:, None, None].expand(B, 1, rows.shape[-1]))[:, 0] * any_found
      if dataspec & 1:
        row = torch.cat([found[:, None], row[:, 1:]], dim=-1)
      out.append(row[:, None].expand(B, num, row.shape[-1]).reshape(B, -1))
      continue
    # reduce none: slot s holds the (s+1)-th match in contact order, found
    # in column 0 of the filled slots
    order = torch.cumsum(match.to(torch.int64), dim=-1) - 1  # (B, ncon)
    s = torch.arange(num, device=order.device)
    hit = match[:, None] & (order[:, None] == s[None, :, None])  # (B, num, ncon)
    i = torch.argmax(hit.to(torch.int32), dim=-1)  # the slot's contact (0 if none)
    slots = torch.gather(rows, 1, i[..., None].expand(B, num, rows.shape[-1]))
    filled = hit.any(dim=-1)[..., None]
    slots = torch.where(filled, slots, 0.0)
    if dataspec & 1:
      slots = torch.cat([torch.where(filled, found[:, None, None], 0.0), slots[..., 1:]], dim=-1)
    out.append(slots.reshape(B, -1))
  return torch.stack(out, dim=1)


# ---------------------------------------------------------------------------
# the three stages
# ---------------------------------------------------------------------------


def _active(m: Model) -> bool:
  return bool(m.nsensor) and not (m.opt.disableflags & DisableBit.SENSOR)


def sensor_pos(m: Model, d: Data) -> Data:
  """Position-stage sensors (mj_sensorPos)."""
  if not _active(m):
    return d
  vals = []
  energy, pair_dist = d.energy, None
  for g in _groups(m, Stage.POS):
    objid, refid = g.t["objid"], g.t["refid"]
    st = g.stype
    if st == SensorType.MAGNETOMETER:
      val = math.mat_t_vec(d.site_xmat[:, objid], env_rows(m, "opt.magnetic")[:, None])
    elif st == SensorType.RANGEFINDER:
      val = _rangefinder(m, d, g)
    elif st == SensorType.JOINTPOS:
      val = d.qpos[:, index(m, "jnt_qposadr")[objid]]
    elif st == SensorType.ACTUATORPOS:
      val = d.actuator_length[:, objid]
    elif st == SensorType.BALLQUAT:
      qadr = index(m, "jnt_qposadr")[objid]
      val = math.normalize(d.qpos[:, qadr[:, None] + torch.arange(4, device=qadr.device)])
    elif st == SensorType.FRAMEPOS:
      val, _ = _obj_pos_mat(d, g.objtype, objid)
      if g.has_ref:
        rpos, rmat = _obj_pos_mat(d, g.reftype, refid)
        val = math.mat_t_vec(rmat, val - rpos)
    elif st in _AXIS_COL:
      _, mat = _obj_pos_mat(d, g.objtype, objid)
      val = mat[..., _AXIS_COL[st]]
      if g.has_ref:
        _, rmat = _obj_pos_mat(d, g.reftype, refid)
        val = math.mat_t_vec(rmat, val)
    elif st == SensorType.FRAMEQUAT:
      val = _frame_quat(m, d, g.objtype, objid)
      if g.has_ref:
        val = math.quat_mul(math.quat_inv(_frame_quat(m, d, g.reftype, refid)), val)
    elif st == SensorType.SUBTREECOM:
      val = d.subtree_com[:, objid]
    elif st == SensorType.CLOCK:
      val = d.time[:, None].expand(-1, len(g.ids))
    elif st == SensorType.INSIDESITE:
      # whether the object's frame origin lies inside the reference site
      p, _ = _obj_pos_mat(d, g.objtype, objid)
      q = math.mat_t_vec(d.site_xmat[:, refid], p - d.site_xpos[:, refid])
      val = _inside_sites(m, g, g.refid, q)
    elif st == SensorType.TENDONPOS:
      val = d.ten_length[:, objid]
    elif st in (SensorType.JOINTLIMITPOS, SensorType.TENDONLIMITPOS):
      val = _limit_read(m, d, g, lambda r, pos: pos)
    elif st in GEOMDIST_SENSORS:
      if pair_dist is None:
        pair_dist = _geom_distances(m, d)
      val = _geom_distance(m, g, *pair_dist)
    elif st == SensorType.CAMPROJECTION:
      val = _camprojection(m, d, g)
    elif st == SensorType.E_POTENTIAL:
      # like C, the sensor runs mj_energyPos and writes d.energy even
      # without EnableBit.ENERGY
      pe = smooth.potential_energy(m, d)
      energy = torch.stack([pe, energy[:, 1]], dim=-1)
      val = pe[:, None].expand(-1, len(g.ids))
    elif st == SensorType.E_KINETIC:
      # mjtpu's lazy evaluation (C's flg_energyvel): under EnableBit.ENERGY
      # fwd_velocity computes the kinetic energy after this stage, so the
      # sensor reads the previous step's, or a fresh one where energy[1]
      # is 0 (C's flag unset); without the flag it computes and writes it
      ke = smooth.kinetic_energy(m, d)
      if m.opt.enableflags & EnableBit.ENERGY:
        ke = torch.where(d.energy[:, 1] == 0.0, ke, d.energy[:, 1])
      else:
        energy = torch.stack([energy[:, 0], ke], dim=-1)
      val = ke[:, None].expand(-1, len(g.ids))
    else:
      raise NotImplementedError(f"pos sensor {st.name}")
    vals.append(val)
  return replace(d, sensordata=_write(m, d, Stage.POS, vals), energy=energy)


def sensor_vel(m: Model, d: Data) -> Data:
  """Velocity-stage sensors (mj_sensorVel); subtree_vel first when a
  sensor reads it."""
  if not _active(m):
    return d
  groups = _groups(m, Stage.VEL)
  if any(g.stype in _NEEDS_SUBTREE_VEL for g in groups):
    d = smooth.subtree_vel(m, d)
  vals = []
  for g in groups:
    objid = g.t["objid"]
    st = g.stype
    if st in (SensorType.VELOCIMETER, SensorType.GYRO):
      vel = _object_velocity(m, d, g, ObjType.SITE, "objid", local=True)
      val = vel[..., 3:] if st == SensorType.VELOCIMETER else vel[..., :3]
    elif st == SensorType.JOINTVEL:
      val = d.qvel[:, index(m, "jnt_dofadr")[objid]]
    elif st == SensorType.ACTUATORVEL:
      val = d.actuator_velocity[:, objid]
    elif st == SensorType.BALLANGVEL:
      dadr = index(m, "jnt_dofadr")[objid]
      val = d.qvel[:, dadr[:, None] + torch.arange(3, device=dadr.device)]
    elif st == SensorType.SUBTREELINVEL:
      val = d.subtree_linvel[:, objid]
    elif st == SensorType.SUBTREEANGMOM:
      val = d.subtree_angmom[:, objid]
    elif st in (SensorType.FRAMELINVEL, SensorType.FRAMEANGVEL):
      vel = _object_velocity(m, d, g, g.objtype, "objid", local=False)
      lin = st == SensorType.FRAMELINVEL
      if g.has_ref:
        rvel = _object_velocity(m, d, g, g.reftype, "refid", local=False)
        rpos, rmat = _obj_pos_mat(d, g.reftype, g.t["refid"])
        if lin:  # the velocity seen from the rotating reference frame
          pos, _ = _obj_pos_mat(d, g.objtype, objid)
          rel = vel[..., 3:] - rvel[..., 3:] - math.cross(rvel[..., :3], pos - rpos)
        else:
          rel = vel[..., :3] - rvel[..., :3]
        val = math.mat_t_vec(rmat, rel)
      else:
        val = vel[..., 3:] if lin else vel[..., :3]
    elif st == SensorType.TENDONVEL:
      val = d.ten_velocity[:, objid]
    elif st in (SensorType.JOINTLIMITVEL, SensorType.TENDONLIMITVEL):
      val = _limit_read(m, d, g, lambda r, pos: torch.einsum(
          "bkv,bv->bk", d.efc_J[:, r], d.qvel))
    else:
      raise NotImplementedError(f"vel sensor {st.name}")
    vals.append(val)
  return replace(d, sensordata=_write(m, d, Stage.VEL, vals))


def _touch(m: Model, d: Data, g: _Group) -> torch.Tensor:
  """(B, K) the normal forces of the contacts on each touch site's body
  whose point lies inside the site's volume (C's zone test), a masked
  sum over the contact slots; an inactive slot's force is 0."""
  B = d.qpos.shape[0]
  if collision_driver.ncon(m) == 0:
    return d.qpos.new_zeros((B, len(g.ids)))
  forces = support.contact_forces(m, d)[..., 0]  # (B, ncon)
  bodyid = index(m, "geom_bodyid")
  b1 = bodyid[d.contact.geom1.long()]
  b2 = bodyid[d.contact.geom2.long()]
  sb, _, _ = _body_tables(m, g, ObjType.SITE)
  member = (b1[:, None, :] == sb[None, :, None]) | (b2[:, None, :] == sb[None, :, None])
  objid = g.t["objid"]
  rel = d.contact.pos[:, None] - d.site_xpos[:, objid, None]  # (B, K, ncon, 3)
  local = math.mat_t_vec(d.site_xmat[:, objid, None], rel)
  inside = _inside_sites(m, g, g.objid, local)
  return torch.sum(torch.where(member & inside, forces[:, None, :], 0.0), dim=-1)


def sensor_acc(m: Model, d: Data) -> Data:
  """Acceleration-stage sensors (mj_sensorAcc); rne_postconstraint first
  when a sensor reads it."""
  if not _active(m):
    return d
  groups = _groups(m, Stage.ACC)
  if any(g.stype in _NEEDS_RNEPOST for g in groups):
    d = smooth.rne_postconstraint(m, d)
  vals = []
  for g in groups:
    objid = g.t["objid"]
    st = g.stype
    if st == SensorType.ACCELEROMETER:
      val = _object_acceleration(m, d, g, ObjType.SITE, local=True)[..., 3:]
    elif st in (SensorType.FRAMELINACC, SensorType.FRAMEANGACC):
      acc = _object_acceleration(m, d, g, g.objtype, local=False)
      val = acc[..., 3:] if st == SensorType.FRAMELINACC else acc[..., :3]
    elif st in (SensorType.FORCE, SensorType.TORQUE):
      # the interaction force of the site's body with its parent, in the
      # site's frame
      b, root, _ = _body_tables(m, g, ObjType.SITE)
      wrench = math.transform_force(
          d.cfrc_int[:, b], d.site_xpos[:, objid] - d.subtree_com[:, root],
          d.site_xmat[:, objid].transpose(-1, -2))
      val = wrench[..., 3:] if st == SensorType.FORCE else wrench[..., :3]
    elif st == SensorType.ACTUATORFRC:
      val = d.actuator_force[:, objid]
    elif st == SensorType.JOINTACTFRC:
      val = d.qfrc_actuator[:, index(m, "jnt_dofadr")[objid]]
    elif st == SensorType.TENDONACTFRC:
      # the total force of the actuators whose transmission is the tendon
      val = d.actuator_force @ _tendon_actuators(m, g).T
    elif st in (SensorType.JOINTLIMITFRC, SensorType.TENDONLIMITFRC):
      val = _limit_read(m, d, g, lambda r, pos: d.efc_force[:, r])
    elif st == SensorType.TOUCH:
      val = _touch(m, d, g)
    elif st == SensorType.CONTACT:
      val = _contact(m, d, g)
    else:
      raise NotImplementedError(f"acc sensor {st.name}")
    vals.append(val)
  return replace(d, sensordata=_write(m, d, Stage.ACC, vals))
