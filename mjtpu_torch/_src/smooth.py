"""Smooth (unconstrained) dynamics pipeline — the main-path part.

Port of mjtpu/_src/smooth.py: kinematics, com_pos, camlight, tendon
(fixed and spatial) and tendon_armature, crb, factor_m and solve_m
(forest-blocked through mass_blocks for several trees, the levelwise
sparse LDL of sparse.py for a large branchy tree, dense otherwise),
factor_solve (per block for a forest, Cholesky or LU), com_vel,
rne, transmission (every transmission mjtpu has), what the sensors
read: rne_postconstraint and subtree_vel, and the energy (energy_pos,
energy_vel).  Tree traversals use
scan.body_tree (levelwise groups, batch-explicit).
"""

from __future__ import annotations

import numpy as np
import torch

from mjtpu_torch._src import math, scan, sparse, support
from mjtpu_torch._src.dataclasses import replace
from mjtpu_torch._src.types import (
    CamLightType,
    Data,
    DisableBit,
    EqType,
    JointType,
    Model,
    TrnType,
    WrapType,
    cached,
    index,
    rows as env_rows,
)
from mjtpu_torch.ops import fused


def _mocap_bodies(m: Model) -> tuple[torch.Tensor, torch.Tensor]:
  """((nbody, 1) bool: the body is a mocap body, (nbody,) its mocap index,
  0 for the other bodies), on the model's device."""

  def build():
    mid = np.asarray(m.body_mocapid)
    return (torch.as_tensor(mid >= 0, device=m.device)[:, None],
            torch.as_tensor(np.maximum(mid, 0), dtype=torch.long, device=m.device))

  return cached(m, "smooth.mocap_bodies", build)


def kinematics(m: Model, d: Data) -> Data:
  """Forward kinematics (mj_kinematics).  A mocap body (a jointless child
  of the world) takes its frame from each env's mocap_pos/mocap_quat in
  place of body_pos/body_quat, before the tree scan, as in mjtpu: the
  frame reaches its children, and the scan's normalize of the quaternion
  is C's mju_normalize4 of mocap_quat."""
  body_pos, body_quat = env_rows(m, "body_pos"), env_rows(m, "body_quat")
  if m.nmocap:
    # (B, nbody, .) frames by a gather and a select: no scatter, no copy
    # from the host
    is_mocap, mocap_id = _mocap_bodies(m)
    body_pos = torch.where(is_mocap, d.mocap_pos[:, mocap_id], body_pos)
    body_quat = torch.where(is_mocap, d.mocap_quat[:, mocap_id], body_quat)

  def fn(carry, jnt_types, jnt_pos, jnt_axis, qpos, qpos0, body_pos, body_quat):
    if carry is None:
      pos, quat = body_pos, body_quat
    else:
      parent_pos, parent_quat, _ = carry
      pos = parent_pos + math.rotate(body_pos, parent_quat)
      quat = math.quat_mul(parent_quat, body_quat)

    anchors, axes, qpos_out = [], [], []
    qi = 0
    for i, jt in enumerate(jnt_types):
      jt = JointType(int(jt))
      if jt == JointType.FREE:
        pos = qpos[..., qi : qi + 3]
        quat = math.normalize(qpos[..., qi + 3 : qi + 7])
        anchor = pos
        axis = torch.zeros_like(pos)
        axis[..., 2] = 1.0
        qpos_out += [pos, quat]
        qi += 7
      else:
        anchor = math.rotate(jnt_pos[..., i, :], quat) + pos
        axis = math.rotate(jnt_axis[..., i, :], quat)
        if jt == JointType.BALL:
          qloc = math.normalize(qpos[..., qi : qi + 4])
          qpos_out.append(qloc)
          quat = math.quat_mul(quat, qloc)
          pos = anchor - math.rotate(jnt_pos[..., i, :], quat)
          qi += 4
        elif jt == JointType.HINGE:
          angle = qpos[..., qi] - qpos0[..., qi]
          qloc = math.axis_angle_to_quat(jnt_axis[..., i, :], angle)
          qpos_out.append(qpos[..., qi : qi + 1])
          quat = math.quat_mul(quat, qloc)
          pos = anchor - math.rotate(jnt_pos[..., i, :], quat)
          qi += 1
        else:  # SLIDE
          qpos_out.append(qpos[..., qi : qi + 1])
          pos = pos + axis * (qpos[..., qi] - qpos0[..., qi])[..., None]
          qi += 1
      anchors.append(anchor)
      axes.append(axis)

    quat = math.normalize(quat)
    lead = torch.broadcast_shapes(pos.shape[:-1], quat.shape[:-1])
    pos, quat = pos.expand(lead + (3,)), quat.expand(lead + (4,))
    if anchors:
      xanchor = torch.stack(torch.broadcast_tensors(*anchors), dim=-2)
      xaxis = torch.stack(torch.broadcast_tensors(*axes), dim=-2)
      qpos_new = torch.cat([q.expand(qpos.shape[:-1] + q.shape[-1:]) for q in qpos_out], -1)
    else:
      xanchor = xaxis = pos.new_zeros(lead + (0, 3))
      qpos_new = qpos
    return qpos_new, xanchor, xaxis, pos, quat, math.quat_to_mat(quat)

  qpos, xanchor, xaxis, xpos, xquat, xmat = scan.body_tree(
      m, fn, "jjjqqbb", "qjjbbb",
      np.asarray(m.jnt_type), env_rows(m, "jnt_pos"), env_rows(m, "jnt_axis"),
      d.qpos, env_rows(m, "qpos0"), body_pos, body_quat,
  )
  if xanchor is None:  # model with no joints
    xanchor, xaxis = d.xanchor, d.xaxis
  if qpos is None:
    qpos = d.qpos

  # inertial / geom / site frames
  xipos = xpos + math.rotate(env_rows(m, "body_ipos"), xquat)
  ximat = math.quat_to_mat(math.quat_mul(xquat, env_rows(m, "body_iquat")))

  bid = index(m, "geom_bodyid")
  geom_xpos = xpos[:, bid] + math.rotate(env_rows(m, "geom_pos"), xquat[:, bid])
  geom_xmat = math.quat_to_mat(math.quat_mul(xquat[:, bid], env_rows(m, "geom_quat")))

  if m.nsite:
    sid = index(m, "site_bodyid")
    site_xpos = xpos[:, sid] + math.rotate(env_rows(m, "site_pos"), xquat[:, sid])
    site_xmat = math.quat_to_mat(math.quat_mul(xquat[:, sid], env_rows(m, "site_quat")))
  else:
    site_xpos, site_xmat = d.site_xpos, d.site_xmat

  return replace(
      d, qpos=qpos, xanchor=xanchor, xaxis=xaxis, xpos=xpos, xquat=xquat,
      xmat=xmat, xipos=xipos, ximat=ximat, geom_xpos=geom_xpos,
      geom_xmat=geom_xmat, site_xpos=site_xpos, site_xmat=site_xmat,
  )


def com_pos(m: Model, d: Data) -> Data:
  """Subtree CoM, com-frame inertias (cinert) and dof axes (cdof) — mj_comPos."""

  def mass_fn(carry, mass, xipos):
    own = (mass, mass[..., None] * xipos)
    if carry is None:
      return own
    return own[0] + carry[0], own[1] + carry[1]

  smass, smom = scan.body_tree(
      m, mass_fn, "bb", "bb", env_rows(m, "body_mass"), d.xipos, reverse=True
  )
  subtree_com = smom / torch.clamp_min(smass, math.MINVAL)[..., None]

  root_com = subtree_com[:, index(m, "body_rootid")]
  cinert = math.transform_inert(env_rows(m, "body_inertia"), d.xipos - root_com, d.ximat,
                                env_rows(m, "body_mass"))
  cinert[:, 0] = 0.0  # world body has no inertia

  def cdof_fn(jnt_types, xanchor, xaxis, xmat, com):
    def dof_com(axis, offset):
      return torch.cat([axis, math.cross(axis, offset)], dim=-1)

    cdofs = []
    for i, jt in enumerate(jnt_types):
      jt = JointType(int(jt))
      offset = com - xanchor[..., i, :]
      if jt in (JointType.FREE, JointType.BALL):
        rot = dof_com(xmat.transpose(-1, -2), offset[..., None, :])  # (.., 3, 6)
        if jt == JointType.FREE:
          trans = torch.eye(6, dtype=xaxis.dtype, device=xaxis.device)[3:]
          cdofs.append(trans.expand(rot.shape))
        cdofs.append(rot)
      elif jt == JointType.SLIDE:
        ax = xaxis[..., i, :]
        cdofs.append(torch.cat([torch.zeros_like(ax), ax], -1)[..., None, :])
      else:  # HINGE
        cdofs.append(dof_com(xaxis[..., i, :], offset)[..., None, :])
    if not cdofs:
      return xaxis.new_zeros(xaxis.shape[:-2] + (0, 6))
    return torch.cat(cdofs, dim=-2)

  cdof = scan.flat(
      m, cdof_fn, "jjjbb", "v",
      np.asarray(m.jnt_type), d.xanchor, d.xaxis, d.xmat, root_com,
  )
  if cdof is None:
    cdof = d.cdof
  return replace(d, subtree_com=subtree_com, cinert=cinert, cdof=cdof)


def _track_modes(m: Model, prefix: str) -> list[tuple[CamLightType, torch.Tensor, torch.Tensor]]:
  """Per tracking mode other than FIXED: (mode, camera or light ids, the
  bodies they track or target) as device tensors, for ``prefix`` "cam" or
  "light"."""

  def build():
    modes = np.asarray(getattr(m, f"{prefix}_mode"))
    out = []
    for mode in CamLightType:
      ids = np.nonzero(modes == mode)[0]
      if mode == CamLightType.FIXED or not len(ids):
        continue
      target = mode in (CamLightType.TARGETBODY, CamLightType.TARGETBODYCOM)
      bodies = np.asarray(getattr(m, f"{prefix}_{'targetbodyid' if target else 'bodyid'}"))[ids]
      t = lambda x: torch.as_tensor(x, dtype=torch.long, device=m.device)
      out.append((mode, t(ids), t(bodies)))
    return out

  return cached(m, ("smooth.track_modes", prefix), build)


def camlight(m: Model, d: Data) -> Data:
  """Camera and light frames (mj_camlight), with mjtpu's tracking modes:
  each mode's cameras (lights) in one batch."""
  if not m.ncam and not m.nlight:
    return d
  changes = {}
  if m.ncam:
    bid = index(m, "cam_bodyid")
    quat = d.xquat[:, bid]
    cam_xpos = d.xpos[:, bid] + math.rotate(env_rows(m, "cam_pos"), quat)
    cam_xmat = math.quat_to_mat(math.quat_mul(quat, env_rows(m, "cam_quat")))
    mat0 = env_rows(m, "cam_mat0").unflatten(-1, (3, 3))
    for mode, ids, body in _track_modes(m, "cam"):
      if mode == CamLightType.TRACK:
        cam_xpos[:, ids] = d.xpos[:, body] + env_rows(m, "cam_pos0")[:, ids]
        cam_xmat[:, ids] = mat0[:, ids]
      elif mode == CamLightType.TRACKCOM:
        cam_xpos[:, ids] = d.subtree_com[:, body] + env_rows(m, "cam_poscom0")[:, ids]
        cam_xmat[:, ids] = mat0[:, ids]
      else:  # the camera looks down -z at the target
        target = (d.subtree_com if mode == CamLightType.TARGETBODYCOM else d.xpos)[:, body]
        z = math.normalize(cam_xpos[:, ids] - target)
        up = torch.zeros_like(z)
        up[..., 2] = 1.0
        x = math.normalize(math.cross(up, z))
        cam_xmat[:, ids] = torch.stack([x, math.cross(z, x), z], dim=-1)
    changes.update(cam_xpos=cam_xpos, cam_xmat=cam_xmat)
  if m.nlight:
    bid = index(m, "light_bodyid")
    quat = d.xquat[:, bid]
    light_xpos = d.xpos[:, bid] + math.rotate(env_rows(m, "light_pos"), quat)
    light_xdir = math.rotate(env_rows(m, "light_dir"), quat)
    for mode, ids, body in _track_modes(m, "light"):
      if mode == CamLightType.TRACK:
        light_xpos[:, ids] = d.xpos[:, body] + env_rows(m, "light_pos0")[:, ids]
      elif mode == CamLightType.TRACKCOM:
        light_xpos[:, ids] = d.subtree_com[:, body] + env_rows(m, "light_poscom0")[:, ids]
      else:
        target = (d.subtree_com if mode == CamLightType.TARGETBODYCOM else d.xpos)[:, body]
        light_xdir[:, ids] = light_xpos[:, ids] - target
    changes.update(light_xpos=light_xpos, light_xdir=math.normalize(light_xdir))
  return replace(d, **changes)


def _fixed_tendon_tables(m: Model) -> dict | None:
  """The fixed tendons' joint entries: their joints' qpos addresses and
  coefficients, the gather table that sums them into their tendons in
  entry order, and the model-constant Jacobian (ntendon, nv) they make;
  None without a fixed tendon."""
  wrap_type = np.asarray(m.wrap_type)
  jsel = np.nonzero(wrap_type == int(WrapType.JOINT))[0]
  if not len(jsel):
    return None
  jnt = np.asarray(m.wrap_objid)[jsel]
  coef = np.asarray(m.wrap_prm)[jsel]
  ten_id = np.repeat(np.arange(m.ntendon), np.asarray(m.tendon_num))[jsel]
  jac = np.zeros((m.ntendon, m.nv))
  np.add.at(jac, (ten_id, np.asarray(m.jnt_dofadr)[jnt]), coef)
  return dict(
      qadr=torch.as_tensor(np.asarray(m.jnt_qposadr)[jnt], device=m.device),
      coef=torch.as_tensor(coef, dtype=m.dtype, device=m.device),
      table=scan.segment_table([np.nonzero(ten_id == t)[0] for t in range(m.ntendon)],
                               len(jsel), m.device),
      J=torch.as_tensor(jac, dtype=m.dtype, device=m.device),
  )


def tendon(m: Model, d: Data) -> Data:
  """Tendon lengths and Jacobians (mj_tendon): fixed tendons are linear in
  qpos (their Jacobian a model constant); spatial tendons walk their
  site/geom/pulley chains with the exact mju_wrap geometry
  (tendon_wrap.py).  Each tendon is one or the other, so the two passes
  fill disjoint rows."""
  if not m.ntendon:
    return d
  from mjtpu_torch._src import tendon_wrap

  fixed = cached(m, "smooth.fixed_tendon", lambda: _fixed_tendon_tables(m))
  B = d.qpos.shape[0]
  changes = {}
  if fixed is not None:
    ten_length = scan.segment_sum(fixed["coef"] * d.qpos[:, fixed["qadr"]], fixed["table"])
    ten_J = fixed["J"].expand((B,) + fixed["J"].shape)
  if np.any(np.asarray(m.wrap_type) != int(WrapType.JOINT)):
    length, jac, wrap_xpos, wrap_active = tendon_wrap.spatial_tendon(m, d)
    if fixed is not None:
      length, jac = ten_length + length, ten_J + jac
    ten_length, ten_J = length, jac
    changes.update(ten_wrap_xpos=wrap_xpos, ten_wrap_active=wrap_active)
  return replace(d, ten_length=ten_length, ten_J=ten_J, **changes)


def tendon_armature(m: Model, d: Data) -> Data:
  """Adds the tendons' armature inertia J^T A J to qM (MuJoCo 3.9+),
  masked to the kinematic-chain pattern: MuJoCo's sparse qM cannot hold a
  coupling between dofs of which neither is the other's ancestor, so C
  drops those terms, and qM stays block diagonal per tree."""
  if not m.ntendon:
    return d
  ja = d.ten_J * env_rows(m, "tendon_armature")[..., None]
  add = d.ten_J.transpose(-1, -2) @ ja
  return replace(d, qM=d.qM + add * chain_pattern(m))


def dof_chain_mask(m: Model) -> torch.Tensor:
  """(nv, nv) mask: M[i, j] = 1 iff j == i or j is an ancestor dof of i."""

  def build():
    mask = np.zeros((m.nv, m.nv), dtype=np.float64)
    parent = np.asarray(m.dof_parentid)
    for i in range(m.nv):
      j = i
      while j >= 0:
        mask[i, j] = 1.0
        j = parent[j]
    return torch.as_tensor(mask, dtype=m.dtype, device=m.device)

  return cached(m, "smooth.dof_chain_mask", build)


def chain_pattern(m: Model) -> torch.Tensor:
  """(nv, nv) symmetric 0/1 sparsity pattern of MuJoCo's qM: entry (i, j)
  exists iff one of i, j is an ancestor dof of the other (or i == j)."""

  def build():
    mask = dof_chain_mask(m)
    return torch.maximum(mask, mask.T)

  return cached(m, "smooth.chain_pattern", build)


def crb(m: Model, d: Data) -> Data:
  """Composite rigid body inertias + mass matrix (mj_crb)."""

  def crb_fn(carry, cinert):
    return cinert if carry is None else cinert + carry

  crb_body = scan.body_tree(m, crb_fn, "b", "b", d.cinert, reverse=True)
  crb_body[:, 0] = 0.0  # world row stays zero (mj_crb)

  # qM[i, j] = cdof[j] . (crb[body(i)] * cdof[i])   for j in chain(i)
  buf = math.inert_mul(crb_body[:, index(m, "dof_bodyid")], d.cdof)
  full = buf @ d.cdof.transpose(-1, -2)  # (B, nv, nv)
  lower = full * dof_chain_mask(m)
  qm = lower + lower.transpose(-1, -2) - torch.diag_embed(torch.diagonal(full, dim1=-2, dim2=-1))
  qm = qm + torch.diag_embed(env_rows(m, "dof_armature"))
  return replace(d, crb=crb_body, qM=qm)


def block_partition(nv: int, body_rootid, dof_bodyid) -> tuple[tuple[int, int], ...] | None:
  """mjtpu's _mass_blocks_cached: the static diagonal-block partition
  ((start, size), ...) of qM, one block per kinematic tree (trees whose
  dofs interleave merge into one), or None when one block spans all dofs."""
  if nv == 0:
    return None
  rootid = np.asarray(body_rootid)
  lo, hi = {}, {}
  for i, b in enumerate(np.asarray(dof_bodyid)):
    t = int(rootid[b])
    lo[t] = min(lo.get(t, i), i)
    hi[t] = max(hi.get(t, i), i)
  merged = []
  for s, e in sorted((lo[t], hi[t]) for t in lo):
    if merged and s <= merged[-1][1]:
      merged[-1] = (merged[-1][0], max(merged[-1][1], e))
    else:
      merged.append((s, e))
  blocks = tuple((s, e - s + 1) for s, e in merged)
  return None if len(blocks) <= 1 else blocks


def mass_blocks(m: Model) -> tuple[tuple[int, int], ...] | None:
  """The diagonal-block partition of qM (mjtpu's smooth.mass_blocks): qM
  of a forest is exactly block diagonal, one block per tree, and mjtpu
  factors and solves it per block; None for one tree."""
  return cached(m, "smooth.mass_blocks",
                lambda: block_partition(m.nv, m.body_rootid, m.dof_bodyid))


def block_indices(m: Model) -> list[tuple[int, torch.Tensor, torch.Tensor, torch.Tensor]]:
  """mjtpu's _block_indices as device tensors: per block size bs, in
  ascending order, (bs, rows (k, bs), ii (k, bs, bs), jj (k, bs, bs)), so
  that each size group moves with one gather and one scatter."""

  def build():
    by: dict[int, list[int]] = {}
    for s, n in mass_blocks(m):
      by.setdefault(n, []).append(s)
    out = []
    for bs, starts in sorted(by.items()):
      rows = np.asarray([[s + r for r in range(bs)] for s in starts])
      ii = np.repeat(rows[:, :, None], bs, axis=2)
      jj = np.repeat(rows[:, None, :], bs, axis=1)
      t = lambda x: torch.as_tensor(x, dtype=torch.long, device=m.device)
      out.append((bs, t(rows), t(ii), t(jj)))
    return out

  return cached(m, "smooth.block_indices", build)


def factor_m(m: Model, d: Data) -> Data:
  """Mass matrix factorization (mj_factorM), on mjtpu's three static
  paths: per tree for a forest (each block size group one batched
  pivot-clamped Cholesky over (B, k, bs, bs)); the levelwise sparse LDL
  (kernel B2) for a single tree that sparse.structure takes, whose compact
  factor is spread into the dense qLD (L below the diagonal, D on it);
  else one dense pivot-clamped Cholesky.  The paths differ in rounding, so
  the port takes mjtpu's branch."""
  if mass_blocks(m) is None:
    t = sparse.tables(m)
    if t is not None:
      qLD = sparse.scatter_dense(t, fused.ldl_factor(t, d.qM))
    else:
      qLD = math.safe_cholesky(d.qM)
  else:
    qLD = torch.zeros_like(d.qM)
    for _, _, ii, jj in block_indices(m):
      qLD[:, ii, jj] = math.safe_cholesky(d.qM[:, ii, jj])
  return replace(d, qLD=qLD, qLDiagInv=1.0 / torch.diagonal(qLD, dim1=-2, dim2=-1))


def solve_m(m: Model, d: Data, x: torch.Tensor) -> torch.Tensor:
  """Solves qM y = x (B, nv) with the current factorization (mj_solveM),
  per block size group for a forest, through kernel B2 from the compact
  factor for a sparse tree."""
  if mass_blocks(m) is None:
    t = sparse.tables(m)
    if t is not None:
      return fused.ldl_solve(t, sparse.gather_compact(t, d.qLD), x)
    return math.cho_solve(d.qLD, x)
  out = torch.zeros_like(x)
  for _, rows, ii, jj in block_indices(m):
    out[:, rows] = math.cho_solve(d.qLD[:, ii, jj], x[:, rows])
  return out


def factor_solve(m: Model, mat: torch.Tensor, rhs: torch.Tensor,
                 symmetric: bool = True) -> torch.Tensor:
  """Solves mat @ x = rhs per env, mat (B, nv, nv) with qM's pattern (the
  implicit integrators' qM + h * damping or qM - h * qDeriv).  One tree,
  symmetric: for a tree that sparse.structure takes, the levelwise LDL
  factor and solve in one launch of kernel B2 (mat keeps qM's chain
  pattern), else the pivot-clamped Cholesky of ops.fused.chol_solve
  (kernel B1); symmetric=False: a batched LU (ImplicitFast's matrix is not
  symmetric).  A forest: mjtpu's blocked solve, per block size group, one
  batched factor and solve over (B, blocks) a group, as factor_m: the
  pivot-clamped Cholesky of each block (Euler's damping), or its LU
  (ImplicitFast; mjtpu's jax.scipy.linalg.lu_factor, outside any Pallas
  kernel).  The LU is lu_factor_ex's, which unlike lu_factor does not
  sync the host to check for errors on CUDA."""
  if mass_blocks(m) is not None:
    out = torch.zeros_like(rhs)
    for _, rows, ii, jj in block_indices(m):
      sub, r = mat[:, ii, jj], rhs[:, rows]
      out[:, rows] = (math.cho_solve(math.safe_cholesky(sub), r) if symmetric
                      else _lu_solve(sub, r))
    return out
  if symmetric:
    t = sparse.tables(m)
    if t is not None:
      return fused.ldl_factor_solve(t, mat, rhs)
    return fused.chol_solve(mat, rhs)
  return _lu_solve(mat, rhs)


def _lu_solve(mat: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
  """Solves mat x = rhs, mat (..., n, n), rhs (..., n), by partial-pivot
  LU, with no host sync."""
  lu, piv, _ = torch.linalg.lu_factor_ex(mat)
  return torch.linalg.lu_solve(lu, piv, rhs[..., None])[..., 0]


def com_vel(m: Model, d: Data) -> Data:
  """Com-frame velocities + cdof time derivatives (mj_comVel)."""

  def fn(carry, jnt_types, cdof, qvel):
    if carry is None:
      cvel = cdof.new_zeros(cdof.shape[:-2] + (6,))
    else:
      cvel = carry
    cdof_x_qvel = cdof * qvel[..., None]
    cdof_dots = []
    di = 0
    for jt in jnt_types:
      jt = JointType(int(jt))
      if jt == JointType.FREE:
        cvel = cvel + torch.sum(cdof_x_qvel[..., di : di + 3, :], dim=-2)
        cdof_dots.append(cdof.new_zeros(cvel.shape[:-1] + (3, 6)))
        cdof_dots.append(math.motion_cross(cvel[..., None, :], cdof[..., di + 3 : di + 6, :]))
        cvel = cvel + torch.sum(cdof_x_qvel[..., di + 3 : di + 6, :], dim=-2)
        di += 6
      else:
        w = jt.dof_width()
        cdof_dots.append(math.motion_cross(cvel[..., None, :], cdof[..., di : di + w, :]))
        cvel = cvel + torch.sum(cdof_x_qvel[..., di : di + w, :], dim=-2)
        di += w
    if cdof_dots:
      cdof_dot = torch.cat(cdof_dots, dim=-2)
    else:
      cdof_dot = cdof.new_zeros(cvel.shape[:-1] + (0, 6))
    return cvel, cdof_dot

  cvel, cdof_dot = scan.body_tree(m, fn, "jvv", "bv", np.asarray(m.jnt_type), d.cdof, d.qvel)
  if cdof_dot is None:
    cdof_dot = d.cdof_dot
  return replace(d, cvel=cvel, cdof_dot=cdof_dot)


def _base_acc(m: Model, d: Data) -> torch.Tensor:
  """The world's com-frame acceleration: -gravity (unless disabled), (E,
  1, 6) over the scan's (B, k, 6)."""
  gravity = env_rows(m, "opt.gravity")
  if m.opt.disableflags & DisableBit.GRAVITY:
    return gravity.new_zeros((gravity.shape[0], 1, 6))
  return torch.cat([torch.zeros_like(gravity), -gravity], dim=-1)[:, None]


def rne(m: Model, d: Data) -> Data:
  """Recursive Newton-Euler bias forces, qacc = 0 (mj_rne)."""
  base_acc = _base_acc(m, d)

  def cacc_fn(carry, cdof_dot, qvel):
    cacc = base_acc if carry is None else carry
    return cacc + torch.einsum("...wi,...w->...i", cdof_dot, qvel)

  cacc = scan.body_tree(m, cacc_fn, "vv", "b", d.cdof_dot, d.qvel)

  # body-local force: I a + v x* (I v)
  loc_frc = math.inert_mul(d.cinert, cacc) + math.motion_cross_force(
      d.cvel, math.inert_mul(d.cinert, d.cvel)
  )

  def acc_fn(carry, frc):
    return frc if carry is None else frc + carry

  cfrc = scan.body_tree(m, acc_fn, "b", "b", loc_frc, reverse=True)
  qfrc_bias = torch.sum(d.cdof * cfrc[:, index(m, "dof_bodyid")], dim=-1)
  return replace(d, qfrc_bias=qfrc_bias)


def rne_jvp(m: Model, d: Data, qvel_t: torch.Tensor, cvel_t: torch.Tensor,
            cdof_dot_t: torch.Tensor) -> torch.Tensor:
  """(B, nv) the derivative of rne's qfrc_bias along the qvel tangents
  ``qvel_t`` (B, nv), given com_vel's along them, cvel_t and cdof_dot_t:
  the product rule through rne's two tree passes (the forward-mode pass
  mjtpu takes with jax.jacfwd; gravity has no tangent)."""

  def cacc_fn(carry, cdof_dot_t, qvel, cdof_dot, qvel_t):
    t = (torch.einsum("...wi,...w->...i", cdof_dot_t, qvel)
         + torch.einsum("...wi,...w->...i", cdof_dot, qvel_t))
    return t if carry is None else carry + t

  cacc_t = scan.body_tree(m, cacc_fn, "vvvv", "b", cdof_dot_t, d.qvel, d.cdof_dot, qvel_t)
  loc_t = (math.inert_mul(d.cinert, cacc_t)
           + math.motion_cross_force(cvel_t, math.inert_mul(d.cinert, d.cvel))
           + math.motion_cross_force(d.cvel, math.inert_mul(d.cinert, cvel_t)))

  def acc_fn(carry, frc):
    return frc if carry is None else frc + carry

  cfrc_t = scan.body_tree(m, acc_fn, "b", "b", loc_t, reverse=True)
  return torch.sum(d.cdof * cfrc_t[:, index(m, "dof_bodyid")], dim=-1)


def _transmission_tables(m: Model) -> dict:
  """Static transmission groups: the scalar-joint actuators (ids, their
  joints' qpos and dof addresses), the tendon actuators (ids, tendons),
  both as device tensors, and every other actuator with its type and
  integer ids (handled one at a time)."""
  trntype = np.asarray(m.actuator_trntype)
  trnid = np.asarray(m.actuator_trnid)
  jnt_type = np.asarray(m.jnt_type)
  long = lambda x: torch.as_tensor(np.asarray(x, dtype=np.int64), device=m.device)
  is_joint = np.isin(trntype, (TrnType.JOINT, TrnType.JOINTINPARENT))
  # trnid is a joint only for joint transmissions: clip before the jnt_type
  # gather, other ids can exceed njnt
  scalar = is_joint & np.isin(jnt_type[np.where(is_joint, trnid[:, 0], 0)],
                              (JointType.SLIDE, JointType.HINGE))
  ids = np.nonzero(scalar)[0]
  j = trnid[ids, 0]
  ten = np.nonzero(trntype == TrnType.TENDON)[0]
  rest = []
  for u in np.nonzero(~scalar & (trntype != TrnType.TENDON))[0]:
    kind = TrnType(int(trntype[u]))
    entry = dict(u=int(u), kind=kind, id0=int(trnid[u, 0]), id1=int(trnid[u, 1]))
    if kind in (TrnType.JOINT, TrnType.JOINTINPARENT):
      jid = entry["id0"]
      entry.update(ball=int(jnt_type[jid]) == JointType.BALL,
                   qadr=int(m.jnt_qposadr[jid]), dadr=int(m.jnt_dofadr[jid]))
    elif kind == TrnType.BODY:
      geoms = np.nonzero(np.asarray(m.geom_bodyid) == entry["id0"])[0]
      entry["geoms"] = long(geoms) if len(geoms) else None
    rest.append(entry)
  return dict(
      joint=(long(ids), long(np.asarray(m.jnt_qposadr)[j]), long(np.asarray(m.jnt_dofadr)[j]))
      if len(ids) else None,
      tendon=(long(ten), long(trnid[ten, 0])) if len(ten) else None,
      rest=rest,
  )


def _site_jac(m: Model, d: Data, sid: int):
  """(jacp, jacr), each (B, nv, 3), of site ``sid``'s origin."""
  return support.jac(m, d, d.site_xpos[:, sid], int(m.site_bodyid[sid]))


def _rows_dot(jac: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
  """jac (B, nv, 3) @ vec (B, 3) or (3,): (B, nv)."""
  return math.dot3(jac, vec[..., None, :])


def _transmit(m: Model, d: Data, e: dict, length, moment) -> None:
  """Writes one actuator's length (B,) and moment row (B, nv) of a ball
  or free joint, site, slider-crank or body (adhesion) transmission into
  ``length`` and ``moment``."""
  # gear and the crank length have the env axis of env_rows: (E, 6), (E,)
  u, kind, gear = e["u"], e["kind"], env_rows(m, "actuator_gear")[:, e["u"]]
  if kind in (TrnType.JOINT, TrnType.JOINTINPARENT):
    qadr, dadr = e["qadr"], e["dadr"]
    if e["ball"]:
      q = d.qpos[:, qadr : qadr + 4]
      gearaxis = math.rotate_inv(gear[..., :3], q) if kind == TrnType.JOINTINPARENT \
          else gear[..., :3].expand(q.shape[:1] + (3,))
      length[:, u] = math.dot3(math.quat_to_vel(q), gear[..., :3])
      moment[:, u, dadr : dadr + 3] = gearaxis
    else:  # FREE: length stays 0
      q = d.qpos[:, qadr + 3 : qadr + 7]
      gearaxis = math.rotate_inv(gear[..., 3:], q) if kind == TrnType.JOINTINPARENT \
          else gear[..., 3:].expand(q.shape[:1] + (3,))
      moment[:, u, dadr : dadr + 3] = gear[..., :3]
      moment[:, u, dadr + 3 : dadr + 6] = gearaxis
  elif kind == TrnType.SITE:
    sid, refid = e["id0"], e["id1"]
    jacp, jacr = _site_jac(m, d, sid)
    if refid == -1:  # length stays 0
      frame = d.site_xmat[:, sid]
      moment[:, u] = (_rows_dot(jacp, math.mat_vec(frame, gear[..., :3]))
                      + _rows_dot(jacr, math.mat_vec(frame, gear[..., 3:])))
    else:
      jacp2, jacr2 = _site_jac(m, d, refid)
      frame = d.site_xmat[:, refid]
      vecp = math.mat_t_vec(frame, d.site_xpos[:, sid] - d.site_xpos[:, refid])
      quat_rel = math.quat_mul(math.quat_inv(math.mat_to_quat(frame)),
                               math.mat_to_quat(d.site_xmat[:, sid]))
      vecr = math.quat_to_vel(quat_rel)
      length[:, u] = math.dot3(vecp, gear[..., :3]) + math.dot3(vecr, gear[..., 3:])
      djacp = math.mat_t_vec(frame[:, None], jacp - jacp2)
      djacr = math.mat_t_vec(frame[:, None], jacr - jacr2)
      moment[:, u] = _rows_dot(djacp, gear[..., :3]) + _rows_dot(djacr, gear[..., 3:])
  elif kind == TrnType.SLIDERCRANK:
    # length = gear0 * (a.v - sqrt((a.v)^2 + rod^2 - v.v)) with a the
    # slider site's z axis and v = crank_pos - slider_pos; the moment is
    # the analytic dL/dq through both site Jacobians and the turning axis
    cid, sid = e["id0"], e["id1"]
    rod = env_rows(m, "actuator_cranklength")[:, u]
    axis = d.site_xmat[:, sid, :, 2]
    vec = d.site_xpos[:, cid] - d.site_xpos[:, sid]
    av = math.dot3(axis, vec)
    # a rod shorter than the crank offset is unreachable: clamp as C's
    # ok=0 branch does rather than give NaN
    det = torch.sqrt(torch.clamp_min(av * av + rod * rod - math.dot3(vec, vec), math.MINVAL))
    length[:, u] = gear[..., 0] * (av - det)
    scale = 1.0 - av / det
    dldv = scale[:, None] * axis + vec / det[:, None]
    jacp_c, _ = _site_jac(m, d, cid)
    jacp_s, jacr_s = _site_jac(m, d, sid)
    mom = _rows_dot(jacp_c - jacp_s, dldv) + _rows_dot(
        jacr_s, scale[:, None] * math.cross(axis, vec))
    moment[:, u] = gear[..., 0, None] * mom
  elif kind == TrnType.BODY:
    # adhesion: length 0; the moment is minus the mean of the normal rows
    # of every detected contact (dist < margin, gap-band contacts too)
    # on the body's geoms; gear is ignored
    from mjtpu_torch._src import collision_driver, constraint

    if e["geoms"] is None or not collision_driver.ncon(m):
      return
    jt, _, _ = constraint._contact_jacobians(m, d)
    g = e["geoms"]
    con = d.contact
    involved = (torch.any(con.geom1[..., None] == g, dim=-1)
                | torch.any(con.geom2[..., None] == g, dim=-1))
    mask = involved & (con.dist < con.margin)
    count = torch.sum(mask.to(jt.dtype), dim=-1)
    total = torch.sum(torch.where(mask[..., None], jt[:, :, 0, :], 0.0), dim=1)
    moment[:, u] = -total / torch.clamp_min(count, 1.0)[:, None]
  else:
    raise NotImplementedError(f"transmission {kind!r}")


def transmission(m: Model, d: Data) -> Data:
  """Actuator lengths and moment arms (mj_transmission).  Where every
  actuator is a scalar-joint transmission the moment matrix is the
  model's constant (put_model bakes it, and its gear: per-env
  actuator_gear rows reach neither the moment nor the length there, as in
  mjtpu, ROADMAP C19); otherwise scalar joints and
  tendons are batched per group, and each other actuator (ball and free
  joints, sites, slider-cranks, bodies) runs on its own, over the batch."""
  if not m.nu:
    return d
  B = d.qpos.shape[0]
  if m.actuator_static_moment is not None:
    def build():
      jid = np.asarray(m.actuator_trnid)[:, 0]
      dadr = np.asarray(m.jnt_dofadr)[jid]
      return (torch.as_tensor(np.asarray(m.jnt_qposadr)[jid], device=m.device),
              m.actuator_static_moment[np.arange(m.nu), dadr])

    qadr, g0 = cached(m, "smooth.transmission", build)
    return replace(
        d,
        actuator_length=d.qpos[:, qadr] * g0,
        actuator_moment=m.actuator_static_moment.expand((B,) + m.actuator_static_moment.shape),
    )

  t = cached(m, "smooth.transmission_groups", lambda: _transmission_tables(m))
  length = d.qpos.new_zeros((B, m.nu))
  moment = d.qpos.new_zeros((B, m.nu, m.nv))
  if t["joint"] is not None:
    ids, qadr, dadr = t["joint"]
    g0 = env_rows(m, "actuator_gear")[:, ids, 0]
    length[:, ids] = d.qpos[:, qadr] * g0
    moment[:, ids, dadr] = g0
  if t["tendon"] is not None:
    ids, ten = t["tendon"]
    g0 = env_rows(m, "actuator_gear")[:, ids, 0]
    length[:, ids] = d.ten_length[:, ten] * g0
    moment[:, ids] = d.ten_J[:, ten] * g0[..., None]
  for e in t["rest"]:
    _transmit(m, d, e, length, moment)
  return replace(d, actuator_length=length, actuator_moment=moment)


# ---------------------------------------------------------------------------
# post-constraint quantities, read by the acceleration and velocity sensors
# ---------------------------------------------------------------------------


def _eq_wrench_tables(m: Model) -> dict | None:
  """The connect and weld equalities' constants for cfrc_ext, in eq order:
  their ids and bodies, whether each is a weld (their anchors are
  _eq_anchors'), efc rows of force (K, 3) and torque (K, 3) (a
  connect's torque rows are its force rows, masked by ``weld``), and the
  segment_table that sums the 2K wrenches (+ on body1, then - on body2)
  into each body; None where there is none."""

  def build():
    from mjtpu_torch._src import support

    eq_type = np.asarray(m.eq_type)
    ids = np.nonzero(np.isin(eq_type, (EqType.CONNECT, EqType.WELD)))[0]
    if not len(ids):
      return None
    # each equality's first efc row: the static layout's, C's row walk
    # (which steps over a tendon equality's row too)
    first = np.cumsum([0] + [support.EQ_ROWS[int(t)] for t in eq_type])[ids]
    weld = eq_type[ids] == EqType.WELD
    t = lambda x: torch.as_tensor(x, device=m.device)
    b1, b2 = np.asarray(m.eq_obj1id)[ids], np.asarray(m.eq_obj2id)[ids]
    k = len(ids)
    return dict(
        ids=t(ids), b1=t(b1), b2=t(b2), is_weld=t(weld)[:, None],
        force=t(first[:, None] + np.arange(3)),
        torque=t(first[:, None] + 3 * weld[:, None] + np.arange(3)),
        weld=torch.as_tensor(weld, dtype=m.dtype, device=m.device)[:, None],
        table=scan.segment_table(
            [np.concatenate([np.nonzero(b1 == b)[0], k + np.nonzero(b2 == b)[0]])
             for b in range(m.nbody)], 2 * k, m.device))

  return cached(m, "smooth.eq_wrench_tables", build)


def _eq_anchors(m: Model, c: dict) -> tuple[torch.Tensor, torch.Tensor]:
  """Each connect's and weld's anchors on body1 and body2, (E, K, 3) with
  the env axis of env_rows (a connect's data holds body1's first, a
  weld's body2's)."""

  def build():
    data = env_rows(m, "eq_data")[:, c["ids"]]  # (E, K, NEQDATA)
    w = c["is_weld"]
    return (torch.where(w, data[..., 3:6], data[..., 0:3]),
            torch.where(w, data[..., 0:3], data[..., 3:6]))

  return cached(m, "smooth.eq_anchors", build, live=True)


def _eq_body_wrenches(m: Model, d: Data, c: dict) -> torch.Tensor:
  """(B, nbody, 6) the connect and weld forces on each body, as MuJoCo C's
  mj_rnePostConstraint applies them: the rows' force f, and a weld's rows'
  torque t, +(t + (p1 - c1) x f, f) on body1 and -(t + (p2 - c2) x f, f)
  on body2, p each body's anchor point in the world, c its root subtree
  com."""
  root = index(m, "body_rootid")
  force = d.efc_force[:, c["force"]]                                  # (B, K, 3)
  torque = d.efc_force[:, c["torque"]] * c["weld"]

  def wrench(b, anchor):
    p = math.mat_vec(d.xmat[:, b], anchor) + d.xpos[:, b]
    return torch.cat([torque + math.cross(p - d.subtree_com[:, root[b]], force), force], -1)

  anchor1, anchor2 = _eq_anchors(m, c)
  w1, w2 = wrench(c["b1"], anchor1), wrench(c["b2"], anchor2)
  return scan.segment_sum(torch.cat([w1, -w2], dim=1), c["table"])


def rne_postconstraint(m: Model, d: Data) -> Data:
  """Com-frame accelerations and interaction forces with the constrained
  qacc (mj_rnePostConstraint): fills cacc, cfrc_int and cfrc_ext.

  cfrc_ext holds the applied forces (xfrc_applied), the contact wrenches
  and the connect and weld forces.  The last follow MuJoCo C where mjtpu
  parts from it (ROADMAP C11): each body takes the force at its own
  anchor (mjtpu puts both at body1's frame of the first anchor), and each
  equality's force is read at its rows of the static layout (mjtpu's row
  count does not step over a tendon equality's row)."""
  from mjtpu_torch._src import collision_driver, support

  root_com = d.subtree_com[:, index(m, "body_rootid")]
  force = d.xfrc_applied[..., :3]
  torque = d.xfrc_applied[..., 3:] + math.cross(d.xipos - root_com, force)
  cfrc_ext = torch.cat([torque, force], dim=-1)
  cfrc_ext[:, 0] = 0.0
  if collision_driver.ncon(m):
    cfrc_ext = cfrc_ext + support.contact_body_wrenches(m, d)
  eq = _eq_wrench_tables(m) if support.count_constraints(m)[0] else None
  if eq is not None:
    cfrc_ext = cfrc_ext + _eq_body_wrenches(m, d, eq)

  base_acc = _base_acc(m, d)

  def cacc_fn(carry, cdof, cdof_dot, qvel, qacc):
    cacc = base_acc if carry is None else carry
    return (cacc + torch.einsum("...wi,...w->...i", cdof_dot, qvel)
            + torch.einsum("...wi,...w->...i", cdof, qacc))

  cacc = scan.body_tree(m, cacc_fn, "vvvv", "b", d.cdof, d.cdof_dot, d.qvel, d.qacc)
  loc_frc = (math.inert_mul(d.cinert, cacc)
             + math.motion_cross_force(d.cvel, math.inert_mul(d.cinert, d.cvel)) - cfrc_ext)

  def acc_fn(carry, frc):
    return frc if carry is None else frc + carry

  cfrc_int = scan.body_tree(m, acc_fn, "b", "b", loc_frc, reverse=True)
  return replace(d, cacc=cacc, cfrc_int=cfrc_int, cfrc_ext=cfrc_ext)


def subtree_vel(m: Model, d: Data) -> Data:
  """Subtree linear velocity and angular momentum (mj_subtreeVel)."""
  root_com = d.subtree_com[:, index(m, "body_rootid")]
  ang, lin = d.cvel[..., :3], d.cvel[..., 3:]
  # each body's com velocity and momenta, world frame
  p_body = env_rows(m, "body_mass")[..., None] * (lin - math.cross(d.xipos - root_com, ang))
  l_body = math.mat_vec(d.ximat, env_rows(m, "body_inertia") * math.mat_t_vec(d.ximat, ang))
  rxp = math.cross(d.xipos, p_body)

  def acc3(carry, a, b, c):
    own = (a, b, c)
    return own if carry is None else tuple(o + cc for o, cc in zip(own, carry))

  p_sub, l_sub, rxp_sub = scan.body_tree(m, acc3, "bbb", "bbb", p_body, l_body, rxp,
                                         reverse=True)
  linvel = p_sub / torch.clamp_min(env_rows(m, "body_subtreemass"), math.MINVAL)[..., None]
  angmom = l_sub + rxp_sub - math.cross(d.subtree_com, p_sub)
  return replace(d, subtree_linvel=linvel, subtree_angmom=angmom)


# ---------------------------------------------------------------------------
# energy (mj_energyPos / mj_energyVel): the gravity term gated on
# DisableBit.GRAVITY, the joint and tendon springs on DisableBit.SPRING;
# the kinetic energy always
# ---------------------------------------------------------------------------


def _spring_tables(m: Model) -> dict:
  """The springy joints by kind, as device tensors (None where a kind has
  no joint): their joint ids (K,) and qpos addresses, scalar (K,), ball
  (K, 4) and free (K, 3) and (K, 4)."""
  dev = m.device
  jt, qadr = np.asarray(m.jnt_type), np.asarray(m.jnt_qposadr)
  out = {}
  for kind, types, width in (("scalar", (JointType.SLIDE, JointType.HINGE), 0),
                             ("ball", (JointType.BALL,), 4), ("free", (JointType.FREE,), 3)):
    j = np.nonzero(np.isin(jt, types))[0]
    if not len(j):
      out[kind] = None
      continue
    adr = qadr[j][:, None] + np.arange(width) if width else qadr[j]
    out[kind] = (torch.as_tensor(j, device=dev), torch.as_tensor(adr, device=dev))
    if kind == "free":
      out[kind] += (torch.as_tensor(qadr[j][:, None] + 3 + np.arange(4), device=dev),)
  return out


def _spring_stiffness(m: Model, c: dict) -> dict:
  """Each kind's stiffnesses (E, K), with the env axis of env_rows."""
  k = env_rows(m, "jnt_stiffness")
  return {kind: None if t is None else k[:, t[0]] for kind, t in c.items()}


def potential_energy(m: Model, d: Data) -> torch.Tensor:
  """(B,) potential energy: gravity, joint springs and tendon springs
  (mj_energyPos)."""
  e = d.qpos.new_zeros(d.qpos.shape[0])
  if not (m.opt.disableflags & DisableBit.GRAVITY):
    e = e - torch.einsum("...n,...ni,...i->...", env_rows(m, "body_mass"), d.xipos,
                         env_rows(m, "opt.gravity"))
  spring_on = not (m.opt.disableflags & DisableBit.SPRING)
  if m.has_jnt_spring and spring_on:
    c = cached(m, "smooth.springs", lambda: _spring_tables(m))
    stiff = cached(m, "smooth.spring_stiffness", lambda: _spring_stiffness(m, c), live=True)
    spring = env_rows(m, "qpos_spring")
    quat_term = lambda adr, k: 0.5 * torch.sum(k * torch.sum(
        math.quat_sub(d.qpos[:, adr], spring[:, adr]) ** 2, dim=-1), dim=-1)
    if c["scalar"] is not None:
      _, adr = c["scalar"]
      k = stiff["scalar"]
      dif = d.qpos[:, adr] - spring[:, adr]
      e = e + 0.5 * torch.sum(k * dif * dif, dim=-1)
    if c["ball"] is not None:
      e = e + quat_term(c["ball"][1], stiff["ball"])
    if c["free"] is not None:
      _, pos, quat = c["free"]
      k = stiff["free"]
      t = d.qpos[:, pos] - spring[:, pos]
      e = e + 0.5 * torch.sum(k * torch.sum(t * t, dim=-1), dim=-1)
      e = e + quat_term(quat, k)
  if m.ntendon and m.has_tendon_spring and spring_on:
    lengthspring = env_rows(m, "tendon_lengthspring")
    lower, upper = lengthspring[..., 0], lengthspring[..., 1]
    length = d.ten_length
    disp = torch.where(length > upper, length - upper,
                       torch.where(length < lower, length - lower, 0.0))
    e = e + 0.5 * torch.sum(env_rows(m, "tendon_stiffness") * disp * disp, dim=-1)
  return e


def kinetic_energy(m: Model, d: Data) -> torch.Tensor:
  """(B,) kinetic energy 0.5 qvel' M qvel (mj_energyVel)."""
  return 0.5 * torch.sum(d.qvel * (d.qM @ d.qvel[..., None])[..., 0], dim=-1)


def energy_pos(m: Model, d: Data) -> Data:
  """Writes the potential energy into d.energy[:, 0] (mj_energyPos)."""
  return replace(d, energy=torch.stack([potential_energy(m, d), d.energy[:, 1]], dim=-1))


def energy_vel(m: Model, d: Data) -> Data:
  """Writes the kinetic energy into d.energy[:, 1] (mj_energyVel)."""
  return replace(d, energy=torch.stack([d.energy[:, 0], kinetic_energy(m, d)], dim=-1))
