"""Sensors: the position, velocity and acceleration stages.

Port of mjtpu/_src/sensor.py, batch-explicit, for the sensor types of
io.SENSORS_PORTED (put_model refuses the others by name).  As in mjtpu,
the sensors of a stage are grouped on the host by (type, objtype,
reftype, datatype, dim), and each group runs as one batched computation
over its K sensors and the B envs.  A stage's groups are written into
sensordata together: their values are concatenated, clamped at each
sensor's cutoff as its datatype says (mjtpu's ``_write``) and put in
place with one indexed write.  The rangefinders of a group cast all
their rays at once (ray.cast).  The index tables live on the Model's
device (Model.cache), so a step makes no host copy.
"""

from __future__ import annotations

import numpy as np
import torch

from mjtpu_torch._src import collision_driver, math, ray, smooth, support
from mjtpu_torch._src.dataclasses import replace
from mjtpu_torch._src.types import (
    Data,
    DataType,
    DisableBit,
    GeomType,
    JointType,
    Model,
    ObjType,
    SensorType,
    Stage,
    TrnType,
    cached,
    index,
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
  (-inf, cutoff], every other sensor not at all."""

  def build():
    adrs, dts, cut_ids = [], [], []
    for g in _groups(m, stage):
      adr = np.asarray(m.sensor_adr)[g.ids]
      adrs.append((adr[:, None] + np.arange(g.dim)[None]).reshape(-1))
      dts.append(np.full(len(g.ids) * g.dim, g.datatype))
      cut_ids.append(np.repeat(g.ids, g.dim))
    flat = np.concatenate(adrs)
    dt = np.concatenate(dts)
    cut = m.sensor_cutoff[torch.as_tensor(np.concatenate(cut_ids), device=m.device)]
    on = cut > 0
    real = torch.as_tensor(dt == DataType.REAL, device=m.device)
    positive = torch.as_tensor(dt == DataType.POSITIVE, device=m.device)
    lo = torch.where(on & real, -cut, -torch.inf)
    hi = torch.where(on & (real | positive), cut, torch.inf)
    return torch.as_tensor(flat, dtype=torch.long, device=m.device), lo, hi

  return cached(m, ("sensor.writer", int(stage)), build)


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
    return math.quat_mul(d.xquat[:, ids], m.body_iquat[ids])
  if objtype == ObjType.XBODY:
    return d.xquat[:, ids]
  if objtype == ObjType.GEOM:
    return math.quat_mul(d.xquat[:, index(m, "geom_bodyid")[ids]], m.geom_quat[ids])
  if objtype == ObjType.SITE:
    return math.quat_mul(d.xquat[:, index(m, "site_bodyid")[ids]], m.site_quat[ids])
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
    s = m.site_size[sid].reshape((len(sid),) + (1,) * (q.dim() - 3) + (3,))
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
  for g in _groups(m, Stage.POS):
    objid, refid = g.t["objid"], g.t["refid"]
    st = g.stype
    if st == SensorType.MAGNETOMETER:
      val = math.mat_t_vec(d.site_xmat[:, objid], m.opt.magnetic)
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
    else:
      raise NotImplementedError(f"pos sensor {st.name}")
    vals.append(val)
  return replace(d, sensordata=_write(m, d, Stage.POS, vals))


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
    else:
      raise NotImplementedError(f"acc sensor {st.name}")
    vals.append(val)
  return replace(d, sensordata=_write(m, d, Stage.ACC, vals))
