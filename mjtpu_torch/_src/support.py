"""Support functions: constraint counting, Jacobians, applied forces,
contact forces, the muscle model.

Port of mjtpu/_src/support.py (the slice's part).  Sizes are host functions
of the Model's static fields, cached per Model.
"""

from __future__ import annotations

import numpy as np
import torch

from mjtpu_torch._src import math, scan
from mjtpu_torch._src.types import (
    ConeType,
    ConstraintType,
    Data,
    DisableBit,
    EqType,
    JointType,
    Model,
    cached,
    index,
    rows as env_rows,
)

# ---------------------------------------------------------------------------
# constraint sizes (host, static)
# ---------------------------------------------------------------------------


def tendon_limit_rows_per(m: Model) -> int:
  """Static rows per limited tendon: 2 where any limited tendon's range is
  narrower than 2*margin (C can then emit both sides at once), else 1."""
  lim = np.asarray(m.tendon_limited).astype(bool)
  if lim.any() and np.asarray(m.tendon_limit_two_sided)[lim].any():
    return 2
  return 1


# efc rows of each equality type: a connect's 3, a weld's 6, a joint's and
# a tendon's 1
EQ_ROWS = {int(EqType.CONNECT): 3, int(EqType.WELD): 6, int(EqType.JOINT): 1,
           int(EqType.TENDON): 1}


def count_constraints(m: Model) -> tuple[int, int, int, int]:
  """(ne, nf, nl, nefc): static row counts.  The equality rows are
  EQ_ROWS of each equality, active or not (an inactive one zeroes its
  rows); the friction rows those of dofs, then tendons; the limit rows
  those of joints (a scalar joint two where its range is narrower than
  2*margin, else one; a ball joint one), then tendons
  (tendon_limit_rows_per each)."""

  def build():
    if m.opt.disableflags & DisableBit.CONSTRAINT:
      return 0, 0, 0, 0
    ne = 0 if m.opt.disableflags & DisableBit.EQUALITY else sum(
        EQ_ROWS[int(t)] for t in np.asarray(m.eq_type))
    nf = 0 if m.opt.disableflags & DisableBit.FRICTIONLOSS else (
        len(m.friction_dofid) + len(m.friction_tenid))
    nl = 0
    if not (m.opt.disableflags & DisableBit.LIMIT):
      jt = np.asarray(m.jnt_type)
      lim = np.asarray(m.jnt_limited).astype(bool)
      scalar = lim & np.isin(jt, (int(JointType.SLIDE), int(JointType.HINGE)))
      ball = lim & (jt == int(JointType.BALL))
      two = np.asarray(m.jnt_limit_two_sided)
      nl = int((scalar & two).sum() * 2 + (scalar & ~two).sum() + ball.sum())
      nl += tendon_limit_rows_per(m) * int(np.asarray(m.tendon_limited).astype(bool).sum())

    from mjtpu_torch._src import collision_driver

    ncon_rows = 0
    for condim, count in collision_driver.condim_counts(m).items():
      if m.opt.cone == ConeType.PYRAMIDAL:
        rows = 1 if condim == 1 else (condim - 1) * 2
      else:
        rows = condim
      ncon_rows += rows * count
    return ne, nf, nl, ne + nf + nl + ncon_rows

  return cached(m, "support.count_constraints", build)


def constraint_sizes(m: Model) -> tuple[int, int, int, int, int]:
  """(ne, nf, nl, ncon, nefc) — mjtpu's constraint_sizes tuple."""
  from mjtpu_torch._src import collision_driver

  ne, nf, nl, nefc = count_constraints(m)
  return ne, nf, nl, collision_driver.ncon(m), nefc


def efc_row_meta(m: Model) -> tuple[np.ndarray, np.ndarray]:
  """Static (efc_type, efc_id) labels for every row of the fixed efc layout
  (equality, dof friction, tendon friction, joint limits, tendon limits,
  then contacts), as in mjtpu's support.efc_row_meta."""

  def build():
    from mjtpu_torch._src import collision_driver

    ne, nf, nl, nefc = count_constraints(m)
    types = np.zeros(nefc, np.int32)
    ids = np.zeros(nefc, np.int32)
    r = 0
    if ne:
      for e, t in enumerate(np.asarray(m.eq_type)):
        n = EQ_ROWS[int(t)]
        types[r : r + n] = int(ConstraintType.EQUALITY)
        ids[r : r + n] = e
        r += n
    if nf:
      for kind, objs in ((ConstraintType.FRICTION_DOF, m.friction_dofid),
                         (ConstraintType.FRICTION_TENDON, m.friction_tenid)):
        n = len(objs)
        types[r : r + n] = int(kind)
        ids[r : r + n] = np.asarray(objs)
        r += n
    if nl:
      jt = np.asarray(m.jnt_type)
      two = np.asarray(m.jnt_limit_two_sided).astype(bool)
      for j in np.nonzero(np.asarray(m.jnt_limited))[0]:
        scalar = jt[j] in (int(JointType.SLIDE), int(JointType.HINGE))
        n = 2 if (scalar and two[j]) else 1
        types[r : r + n] = int(ConstraintType.LIMIT_JOINT)
        ids[r : r + n] = j
        r += n
      per = tendon_limit_rows_per(m)
      for t in np.nonzero(np.asarray(m.tendon_limited))[0]:
        types[r : r + per] = int(ConstraintType.LIMIT_TENDON)
        ids[r : r + per] = t
        r += per
    if r != ne + nf + nl:
      raise AssertionError((r, ne, nf, nl))

    dims = collision_driver.make_condim(m)
    addr = collision_driver.contact_efc_address(m, ne, nf, nl)
    pyramidal = m.opt.cone == ConeType.PYRAMIDAL
    for c, (a, dim) in enumerate(zip(addr, dims)):
      if dim == 1:
        t, n = int(ConstraintType.CONTACT_FRICTIONLESS), 1
      elif pyramidal:
        t, n = int(ConstraintType.CONTACT_PYRAMIDAL), 2 * (dim - 1)
      else:
        t, n = int(ConstraintType.CONTACT_ELLIPTIC), dim
      types[a : a + n] = t
      ids[a : a + n] = c
    return types, ids

  return cached(m, "support.efc_row_meta", build)


# ---------------------------------------------------------------------------
# kinematic-chain masks (host, static)
# ---------------------------------------------------------------------------


def dof_ancestor_mask(m: Model) -> np.ndarray:
  """(nbody, nv) 0/1 mask: dof i moves body b's frame (b or an ancestor of
  b owns dof i)."""

  def build():
    mask = np.zeros((m.nbody, m.nv), dtype=np.float64)
    parentid = np.asarray(m.body_parentid)
    for b in range(m.nbody):
      anc = b
      while anc > 0:
        da, dn = int(m.body_dofadr[anc]), int(m.body_dofnum[anc])
        mask[b, da : da + dn] = 1.0
        anc = parentid[anc]
    return mask

  return cached(m, "support.dof_ancestor_mask", build)


def dof_ancestor_mask_t(m: Model) -> torch.Tensor:
  """dof_ancestor_mask as a tensor in the model's dtype and device."""
  return cached(
      m, "support.dof_ancestor_mask_t",
      lambda: torch.as_tensor(dof_ancestor_mask(m), dtype=m.dtype, device=m.device),
  )


# ---------------------------------------------------------------------------
# Jacobians (device)
# ---------------------------------------------------------------------------


def jac(m: Model, d: Data, point: torch.Tensor, body_id: int):
  """Jacobian of a world ``point`` (B, 3) attached to body ``body_id``
  (mjtpu's form of jac_rows).

  Returns (jacp, jacr), each (B, nv, 3).
  """
  ids = cached(m, "support.body_ids", lambda: torch.arange(m.nbody, device=m.device))
  jacp, jacr = jac_rows(m, d, point[:, None], ids[int(body_id):int(body_id) + 1])
  return jacp[:, 0].transpose(1, 2), jacr[:, 0].transpose(1, 2)


def jac_rows(m: Model, d: Data, point: torch.Tensor, body: torch.Tensor):
  """Jacobians of the world points ``point`` (B, K, 3) attached to the
  bodies ``body`` (K,), a long tensor on the model's device.

  Returns (jacp, jacr), each (B, K, 3, nv): a row per axis.
  """
  mask = dof_ancestor_mask_t(m)[body][None, :, None, :]               # (1, K, 1, nv)
  offset = point - d.subtree_com[:, index(m, "body_rootid")[body]]    # (B, K, 3)
  cdof = d.cdof[:, None]                                              # (B, 1, nv, 6)
  jacp = cdof[..., 3:] + math.cross(cdof[..., :3], offset[:, :, None, :])
  return (jacp.transpose(-1, -2) * mask,
          cdof[..., :3].transpose(-1, -2).expand(jacp.shape[:2] + (3, m.nv)) * mask)


def wrench_qfrc(m: Model, d: Data, point: torch.Tensor, force: torch.Tensor,
                torque: torch.Tensor | None = None, bodies: dict | None = None
                ) -> torch.Tensor:
  """(B, nv) generalized force of world forces ``force`` (B, K, 3) at world
  points ``point`` (B, K, 3) and torques ``torque`` (B, K, 3), one on each
  of K bodies: every body in order, or those whose dof_ancestor_mask_t
  rows and root ids ``bodies`` gives ({"mask": (K, nv), "rootid": (K,)})."""
  if bodies is None:
    mask, rootid = dof_ancestor_mask_t(m), index(m, "body_rootid")
  else:
    mask, rootid = bodies["mask"], bodies["rootid"]
  offset = point - d.subtree_com[:, rootid]                               # (B, K, 3)
  jacp = d.cdof[:, None, :, 3:] + math.cross(
      d.cdof[:, None, :, :3], offset[:, :, None, :]
  )  # (B, K, nv, 3)
  qfrc = torch.einsum("nv,bnvi,bni->bv", mask, jacp, force)
  if torque is not None:
    qfrc = qfrc + torch.einsum("nv,bvi,bni->bv", mask, d.cdof[..., :3], torque)
  return qfrc


def is_sparse(m: Model) -> bool:
  """Whether the mass matrix uses MuJoCo's sparse (nM,) layout: never, as
  in mjtpu (qM is dense (B, nv, nv); the sparse LDL of kernel B2 keeps
  its own compact factor)."""
  del m
  return False


def apply_ft(m: Model, d: Data, force: torch.Tensor, torque: torch.Tensor,
             point: torch.Tensor, body_id: int) -> torch.Tensor:
  """(B, nv) the generalized force of a world-frame force and torque (B,
  3) applied at ``point`` (B, 3) on body ``body_id`` (mjtpu's apply_ft)."""
  jacp, jacr = jac(m, d, point, body_id)
  return (jacp @ force[..., None])[..., 0] + (jacr @ torque[..., None])[..., 0]


def full_m(m: Model, d: Data) -> torch.Tensor:
  """(B, nv, nv) the dense mass matrix (mjtpu's full_m and dense_m)."""
  del m
  return d.qM


def mul_m(m: Model, d: Data, vec: torch.Tensor) -> torch.Tensor:
  """(B, nv) qM @ vec per env (mj_mulM)."""
  del m
  return (d.qM @ vec[..., None])[..., 0]


def xfrc_accumulate(m: Model, d: Data) -> torch.Tensor:
  """Maps d.xfrc_applied over all bodies to generalized forces (B, nv)."""
  return wrench_qfrc(m, d, d.xipos, d.xfrc_applied[..., :3], d.xfrc_applied[..., 3:])


# ---------------------------------------------------------------------------
# contact forces (mju_decodePyramid / mj_contactForce)
# ---------------------------------------------------------------------------


def _contact_force_rows(m: Model) -> list[tuple[int, slice, torch.Tensor]]:
  """Per condim (the contacts of one condim are contiguous): (condim, its
  contacts' slice, their efc rows (k, rows a contact) on the device)."""

  def build():
    from mjtpu_torch._src import collision_driver

    ne, nf, nl, _ = count_constraints(m)
    dims = collision_driver.make_condim(m)
    addr = collision_driver.contact_efc_address(m, ne, nf, nl)
    out = []
    for condim in sorted(set(int(c) for c in dims)):
      idx = np.nonzero(dims == condim)[0]
      if condim == 1 or m.opt.cone == ConeType.ELLIPTIC:
        n_rows = condim
      else:
        n_rows = 2 * (condim - 1)
      rows = addr[idx][:, None] + np.arange(n_rows)[None]
      out.append((condim, slice(int(idx[0]), int(idx[-1]) + 1),
                  torch.as_tensor(rows, dtype=torch.long, device=m.device)))
    return out

  return cached(m, "support.contact_force_rows", build)


def contact_forces(m: Model, d: Data) -> torch.Tensor:
  """(B, ncon, 6) contact wrenches in the contact frame [fn, ft1, ft2,
  torques], decoded from efc_force: a condim-1 row is the normal force; an
  elliptic contact's rows are the wrench's first condim components; a
  pyramidal contact's normal force is the sum of its rows and each
  friction component the difference of a row pair times its friction
  (mju_decodePyramid).  Without constraint rows every wrench is zero."""
  from mjtpu_torch._src import collision_driver

  B = d.qpos.shape[0]
  ncon = collision_driver.ncon(m)
  if count_constraints(m)[3] == 0:
    # no contact rows (constraints disabled), so no contact force: MuJoCo
    # C detects no contact at all then (mjtpu raises here)
    return d.qpos.new_zeros((B, ncon, 6))
  parts = []
  for condim, sl, rows in _contact_force_rows(m):
    f = d.efc_force[:, rows]  # (B, k, rows)
    k = rows.shape[0]
    if condim == 1 or m.opt.cone == ConeType.ELLIPTIC:
      parts.append(torch.cat([f, f.new_zeros((B, k, 6 - condim))], dim=-1))
      continue
    mu = d.contact.friction[:, sl]
    total = f[..., 0]
    for r in range(1, f.shape[-1]):
      total = total + f[..., r]
    fric = [(f[..., 2 * j] - f[..., 2 * j + 1]) * mu[..., j] for j in range(condim - 1)]
    parts.append(torch.cat([torch.stack([total, *fric], dim=-1),
                            f.new_zeros((B, k, 6 - condim))], dim=-1))
  return torch.cat(parts, dim=1)


def contact_force_com(m: Model, d: Data):
  """Per-contact wrenches in world axes for cfrc_ext, each about the root
  subtree com of the body it acts on: (wrench1, wrench2 (B, ncon, 6),
  body1 ids, body2 ids (B, ncon)); +wrench2 acts on body2, -wrench1 on
  body1 (mj_rnePostConstraint's contact part).  mjtpu takes body2's root
  com for both, which parts from MuJoCo C where body1 lies in another
  tree than body2; the port follows C there (ROADMAP C11).  C leaves the
  world body out; mjtpu gives it the wrench about body2's root com, and
  so does the port."""
  bodyid = index(m, "geom_bodyid")
  b1 = bodyid[d.contact.geom1.long()]
  b2 = bodyid[d.contact.geom2.long()]
  f = contact_forces(m, d)
  frame = d.contact.frame  # rows are the contact axes
  force = math.mat_t_vec(frame, f[..., :3])
  torque = math.mat_t_vec(frame, f[..., 3:])

  def wrench(root):
    rc = torch.gather(d.subtree_com, 1, root[..., None].expand(root.shape + (3,)))
    return torch.cat([torque + math.cross(d.contact.pos - rc, force), force], dim=-1)

  rootid = index(m, "body_rootid")
  root2 = rootid[b2]
  return wrench(torch.where(b1 == 0, root2, rootid[b1])), wrench(root2), b1, b2


def _contact_body_table(m: Model) -> torch.Tensor | None:
  """segment_table over [wrenches, -wrenches] (2 ncon rows): body b sums
  the contacts whose body2 is b, then the negated ones whose body1 is b;
  None where the contact slots' geoms differ per env (a capped model)."""

  def build():
    from mjtpu_torch._src import collision_driver

    geoms = collision_driver.contact_geoms(m)
    if geoms is None:
      return None
    bodyid = np.asarray(m.geom_bodyid)
    b1, b2 = bodyid[geoms[0]], bodyid[geoms[1]]
    n = len(b1)
    return scan.segment_table(
        [np.concatenate([np.nonzero(b2 == b)[0], n + np.nonzero(b1 == b)[0]])
         for b in range(m.nbody)], 2 * n, m.device)

  return cached(m, "support.contact_body_table", build)


def contact_body_wrenches(m: Model, d: Data) -> torch.Tensor:
  """(B, nbody, 6) sum of the contact wrenches on each body: +wrench2 on
  body2, -wrench1 on body1 (contact_force_com).  Static contact geoms sum
  through a gather table in a fixed order; a capped model, whose slots'
  bodies differ per env, through a masked product over the contacts."""
  w1, w2, b1, b2 = contact_force_com(m, d)
  table = _contact_body_table(m)
  if table is not None:
    return scan.segment_sum(torch.cat([w2, -w1], dim=1), table)
  bodies = torch.arange(m.nbody, device=w1.device)[None, :, None]
  on = lambda b: (b[:, None, :] == bodies).to(w1.dtype)
  return on(b2) @ w2 - on(b1) @ w1


def act_input(m: Model) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
  """Where each actuator reads its input from, as device tensors: (nu,)
  whether it has an activation state, (nu,) its last activation slot (0
  for a stateless one), and (nu,) whether it reads that activation one
  step ahead (actearly; None where no actuator does)."""

  def build():
    actadr, actnum = np.asarray(m.actuator_actadr), np.asarray(m.actuator_actnum)
    stateful = actadr >= 0
    early = np.asarray(m.actuator_actearly, dtype=bool) & stateful
    t = lambda x: torch.as_tensor(x, device=m.device)
    return (t(stateful), t(np.maximum(actadr + actnum - 1, 0).astype(np.int64)),
            t(early) if early.any() else None)

  return cached(m, "support.act_input", build)


# ---------------------------------------------------------------------------
# muscle model (mju_muscle*), elementwise over any leading axes
# ---------------------------------------------------------------------------


def _sq(x: torch.Tensor) -> torch.Tensor:
  return x * x  # x**2 as XLA's integer power computes it


def muscle_gain_length(length, lmin, lmax):
  """Active force-length curve (piecewise quadratic bump, mju_muscleGainLength)."""
  a = 0.5 * (lmin + 1.0)
  b = 0.5 * (1.0 + lmax)
  out = torch.where(
      length <= a,
      0.5 * _sq((length - lmin) / torch.clamp_min(a - lmin, math.MINVAL)),
      1.0 - 0.5 * _sq((1.0 - length) / torch.clamp_min(1.0 - a, math.MINVAL)),
  )
  out = torch.where(
      length > 1.0,
      torch.where(
          length <= b,
          1.0 - 0.5 * _sq((length - 1.0) / torch.clamp_min(b - 1.0, math.MINVAL)),
          0.5 * _sq((lmax - length) / torch.clamp_min(lmax - b, math.MINVAL)),
      ),
      out,
  )
  return torch.where((length <= lmin) | (length >= lmax), 0.0, out)


def _muscle_normalized(len_, lengthrange, prm):
  range0, range1 = prm[..., 0], prm[..., 1]
  l0 = (lengthrange[..., 1] - lengthrange[..., 0]) / torch.clamp_min(range1 - range0, math.MINVAL)
  ln = range0 + (len_ - lengthrange[..., 0]) / torch.clamp_min(l0, math.MINVAL)
  return ln, l0


def _muscle_peak(prm, acc0):
  """The peak force: prm's force, or scale / acc0 where it is negative."""
  force, scale = prm[..., 2], prm[..., 3]
  return torch.where(force < 0.0, scale / torch.clamp_min(acc0, math.MINVAL), force)


def muscle_gain(len_, vel, lengthrange, acc0, prm):
  """Muscle active gain (mju_muscleGain).  prm = (range0, range1, force,
  scale, lmin, lmax, vmax, fpmax, fvmax)."""
  lmin, lmax, vmax, fvmax = prm[..., 4], prm[..., 5], prm[..., 6], prm[..., 8]
  ln, l0 = _muscle_normalized(len_, lengthrange, prm)
  v = vel / torch.clamp_min(l0 * vmax, math.MINVAL)
  fl = muscle_gain_length(ln, lmin, lmax)
  y = fvmax - 1.0
  fv = torch.where(v <= 0.0, (v + 1.0) * (v + 1.0),
                   fvmax - ((y - v) * (y - v)) / torch.clamp_min(y, math.MINVAL))
  fv = torch.where(v <= -1.0, 0.0, torch.where(v > y, fvmax, fv))
  return -_muscle_peak(prm, acc0) * fl * fv


def muscle_bias(len_, lengthrange, acc0, prm):
  """Muscle passive bias force (mju_muscleBias): a quadratic ramp to
  fpmax/2 at x = 1, then linear."""
  lmax, fpmax = prm[..., 5], prm[..., 7]
  ln, _ = _muscle_normalized(len_, lengthrange, prm)
  b = 0.5 * (1.0 + lmax)
  x = (ln - 1.0) / torch.clamp_min(b - 1.0, math.MINVAL)
  fp = torch.where(x <= 1.0, 0.5 * fpmax * x * x, fpmax * (0.5 + (x - 1.0)))
  fp = torch.where(x <= 0.0, 0.0, fp)
  return -_muscle_peak(prm, acc0) * fp


def sigmoid(x):
  """Smootherstep sigmoid on [0, 1] (mju_sigmoid)."""
  s = x * x * x * (3.0 * x * (2.0 * x - 5.0) + 10.0)
  return torch.clamp(torch.where(x <= 0.0, 0.0, torch.where(x >= 1.0, 1.0, s)), 0.0, 1.0)


def muscle_dynamics(ctrl, act, prm):
  """Muscle activation dynamics (mju_muscleDynamics).  prm = (tau_act,
  tau_deact, smoothing_width)."""
  ctrlclamp = torch.clamp(ctrl, 0.0, 1.0)
  actclamp = torch.clamp(act, 0.0, 1.0)
  tau_act = prm[..., 0] * (0.5 + 1.5 * actclamp)
  tau_deact = prm[..., 1] / (0.5 + 1.5 * actclamp)
  dctrl = ctrlclamp - act
  # smoothing between the deactivation and activation time constants
  width = prm[..., 2]
  hard = torch.where(dctrl > 0.0, tau_act, tau_deact)
  soft = tau_deact + (tau_act - tau_deact) * sigmoid(
      dctrl / torch.clamp_min(width, math.MINVAL) + 0.5)
  tau = torch.where(width < math.MINVAL, hard, soft)
  return dctrl / torch.clamp_min(tau, math.MINVAL)


# ---------------------------------------------------------------------------
# geom distance (mj_geomDistance)
# ---------------------------------------------------------------------------


def _distance_tables(m: Model, g1: tuple, g2: tuple) -> list:
  """The colliders of P geom pairs: per collider key, in first-use order,
  (its function, the pairs' positions in the P, their geoms in the order
  the collider takes (type1 <= type2), -1 where a pair was swapped, else
  1), device tensors.  A height-field pair keeps a group of its own (its
  subgrid is sized by its own geom's bounding radius)."""
  from mjtpu_torch._src import collision_driver
  from mjtpu_torch._src.types import GeomType

  def build():
    keys: dict = {}
    for p, (a, b) in enumerate(zip(g1, g2)):
      t1, t2 = int(m.geom_type[a]), int(m.geom_type[b])
      swap = t1 > t2
      if swap:
        a, b, t1, t2 = b, a, t2, t1
      if not collision_driver.has_collision_fn(t1, t2):
        raise NotImplementedError(
            f"geom_distance between {GeomType(t1).name} and {GeomType(t2).name} is not supported")
      key = (t1, t2, collision_driver._shape_key(m, a), collision_driver._shape_key(m, b), 3)
      if t1 == GeomType.HFIELD:
        key += (p,)
      keys.setdefault(key, []).append((p, a, b, -1.0 if swap else 1.0))
    out = []
    for key, rows in keys.items():
      pos, a, b, sign = zip(*rows)
      fn = collision_driver._collision_fn(m, key[:5], [(x, y, -1) for x, y in zip(a, b)])
      t = lambda x: torch.as_tensor(np.asarray(x), device=m.device)
      out.append((fn, t(pos), t(a), t(b), t(sign).to(m.dtype)))
    return out

  return cached(m, ("support.geom_distance", g1, g2), build)


def geom_distances(m: Model, d: Data, g1, g2, distmax: torch.Tensor):
  """The smallest signed distances of P geom pairs (mj_geomDistance), each
  through the collider that collision runs on the pair (a box-box or mesh
  pair through kernel B3, a round geom as mjtpu's inscribed hull): (dist
  (B, P), clamped to ``distmax`` (P,) where no contact point lies below
  it; fromto (B, P, 6), the segment between the two nearest surface
  points, zeros where none does).  The normal of a contact points from
  the pair's first geom to its second."""
  B = d.qpos.shape[0]
  g1 = tuple(int(x) for x in g1)
  g2 = tuple(int(x) for x in g2)
  dist = d.qpos.new_zeros((B, len(g1)))
  mid = d.qpos.new_zeros((B, len(g1), 3))
  normal = d.qpos.new_zeros((B, len(g1), 3))
  for fn, pos, a, b, sign in _distance_tables(m, g1, g2):
    size = env_rows(m, "geom_size")
    dk, pk, frame = fn(d.geom_xpos[:, a], d.geom_xmat[:, a], size[:, a],
                       d.geom_xpos[:, b], d.geom_xmat[:, b], size[:, b])
    dmin, i = torch.min(dk, dim=-1)  # the first of the pair's deepest points
    take = lambda x: torch.gather(x, 2, i[:, :, None, None].expand(i.shape + (1, 3)))[:, :, 0]
    dist[:, pos] = dmin
    mid[:, pos] = take(pk)
    normal[:, pos] = take(frame[..., 0, :]) * sign[:, None]
  found = dist < distmax
  half = (0.5 * dist)[..., None] * normal
  fromto = torch.where(found[..., None], torch.cat([mid - half, mid + half], dim=-1), 0.0)
  return torch.where(found, dist, distmax), fromto


def geom_distance(m: Model, d: Data, g1: int, g2: int, distmax: float):
  """The smallest signed distance between geoms g1 and g2 in every env
  (mj_geomDistance): (dist (B,), clamped to ``distmax`` where nothing lies
  below it; fromto (B, 6), zeros then)."""
  dist, fromto = geom_distances(
      m, d, (g1,), (g2,), torch.full((1,), distmax, dtype=d.qpos.dtype, device=d.qpos.device))
  return dist[:, 0], fromto[:, 0]
