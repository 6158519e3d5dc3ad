"""Constraint assembly: efc rows for equality constraints, dof and tendon
friction, joint and tendon limits, and contacts.

Port of mjtpu/_src/constraint.py: _kbi, _contact_jacobians, _eq_rows
(connect, weld with its torquescale, joint and tendon couplings),
_friction_rows for dofs and tendons, _limit_rows for scalar and ball
joints and tendons, _contact_rows for pyramidal and elliptic cones at
condim 1, 3, 4 and 6, make_constraint.  The row layout is static per
model — [equality (eq order) | dof friction | tendon friction | joint
limits | tendon limits | contacts (condim-sorted groups)] — and rows
deactivate themselves with zeroed Jacobians, as in mjtpu.  mjtpu builds
the equality rows one equality at a time; here each type is one batched
computation over (B, K equalities), permuted back to eq order, so the
launches stay flat in neq.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mjtpu_torch._src import math, scan, support
from mjtpu_torch._src.dataclasses import replace
from mjtpu_torch._src.diff_config import get_diff_config
from mjtpu_torch._src.types import (
    ConeType,
    Data,
    DisableBit,
    EqType,
    JointType,
    Model,
    cached,
    env_expand,
    index,
    rows as env_rows,
)

# MuJoCo impedance clamps
_MINIMP = 0.0001
_MAXIMP = 0.9999


class _Rows(NamedTuple):
  """A block of constraint rows (every shape leads with (B, nrow))."""

  J: torch.Tensor            # (B, n, nv)
  pos: torch.Tensor          # (B, n) violation: the aref input
  # (B, n) the violation that drives the impedance: pos, but for an
  # elliptic contact's friction rows (pos 0) the normal's penetration
  pos_imp: torch.Tensor
  pos_out: torch.Tensor      # (B, n) value written to efc_pos
  margin: torch.Tensor       # (B, n)
  invweight: torch.Tensor    # (B, n)
  solref: torch.Tensor       # (B, n, 2)
  solimp: torch.Tensor       # (B, n, 5)
  frictionloss: torch.Tensor  # (B, n)
  # regularization scale applied outside the MINVAL floor (see mjtpu's
  # _Rows.r_scale): R = r_scale * max(MINVAL, invweight*(1-imp)/imp)
  r_scale: torch.Tensor      # (B, n)


def _kbi(m: Model, solref, solimp, pos):
  """Stiffness/damping/impedance from solver parameters (mj KBI transform).
  pos is the (margin-adjusted) violation."""
  timeconst, dampratio = solref[..., 0], solref[..., 1]
  dmin = torch.clamp(solimp[..., 0], _MINIMP, _MAXIMP)
  dmax = torch.clamp(solimp[..., 1], _MINIMP, _MAXIMP)
  width = torch.clamp_min(solimp[..., 2], math.MINVAL)
  mid = torch.clamp(solimp[..., 3], _MINIMP, _MAXIMP)
  power = torch.clamp_min(solimp[..., 4], 1.0)

  if not (m.opt.disableflags & DisableBit.REFSAFE):
    timeconst = torch.maximum(timeconst, 2.0 * env_rows(m, "opt.timestep")[:, None])

  k = 1.0 / torch.clamp_min(dmax * dmax * timeconst * timeconst * dampratio * dampratio, math.MINVAL)
  b = 2.0 / torch.clamp_min(dmax * timeconst, math.MINVAL)
  # direct (negative) solref: -stiffness, -damping
  k = torch.where(solref[..., 0] <= 0, -solref[..., 0] / torch.clamp_min(dmax * dmax, math.MINVAL), k)
  b = torch.where(solref[..., 1] <= 0, -solref[..., 1] / torch.clamp_min(dmax, math.MINVAL), b)

  x = torch.abs(pos) / width
  y_low = (mid ** (1.0 - power)) * (x ** power)
  # where a gradient is taken, the upper branch's base clamped at 0: past
  # x = 1 (where imp is dmax) 1 - x is negative, and its power is NaN at a
  # power that is not an integer, and its gradient to the power (b^p log
  # b) NaN at any, which reaches every gradient through the where below;
  # x <= 1 keeps its bits, and a plain step its operations.  mjtpu takes
  # the negative base (ROADMAP C22)
  xb = torch.clamp_max(x, 1.0) if x.requires_grad or power.requires_grad else x
  y_high = 1.0 - ((1.0 - mid) ** (1.0 - power)) * ((1.0 - xb) ** power)
  y = torch.where(x < mid, y_low, y_high)
  imp = dmin + y * (dmax - dmin)
  imp = torch.minimum(torch.maximum(imp, dmin), dmax)
  imp = torch.where(x >= 1.0, dmax, imp)
  return k, b, imp


def _contact_jacobians(m: Model, d: Data, rotational: bool = False):
  """Per-contact frame-projected Jacobian differences.

  Returns jt (B, ncon, 3, nv): rows f_i . (jacp2 - jacp1) for the three
  contact-frame axes f_i; jr (B, ncon, 3, nv): rows f_i . (jacr2 - jacr1),
  which condim 4 and 6 read (None unless ``rotational``); and the contact
  bodies (b1, b2), each (B, ncon).
  """
  bodyid, rootid = index(m, "geom_bodyid"), index(m, "body_rootid")
  b1 = bodyid[d.contact.geom1.long()]
  b2 = bodyid[d.contact.geom2.long()]

  mask = support.dof_ancestor_mask_t(m)
  take = lambda x, idx: torch.gather(x, 1, idx[..., None].expand(idx.shape + x.shape[2:]))
  com1 = take(d.subtree_com, rootid[b1])
  com2 = take(d.subtree_com, rootid[b2])
  pos = d.contact.pos       # (B, ncon, 3)
  frame = d.contact.frame   # (B, ncon, 3, 3), rows = contact axes
  w = d.cdof[..., :3]       # (B, nv, 3) rotational dof axes
  v = d.cdof[..., 3:]       # (B, nv, 3) translational

  # jacp_k[j] = (v_j + w_j x off_k) * mask_k; rewritten with the triple
  # product f.(w x off) = w.(off x f), as in mjtpu
  mask1 = mask[b1][:, :, None, :]  # (B, ncon, 1, nv)
  mask2 = mask[b2][:, :, None, :]
  fv = torch.einsum("bcik,bjk->bcij", frame, v)
  g1 = math.cross((pos - com1)[:, :, None, :], frame)
  g2 = math.cross((pos - com2)[:, :, None, :], frame)
  wg1 = torch.einsum("bcik,bjk->bcij", g1, w)
  wg2 = torch.einsum("bcik,bjk->bcij", g2, w)
  jt = mask2 * (fv + wg2) - mask1 * (fv + wg1)
  jr = None
  if rotational:
    jr = (mask2 - mask1) * torch.einsum("bcik,bjk->bcij", frame, w)
  return jt, jr, (b1, b2)


def _quat_vec_map(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """(..., 3, 3) A with A @ w == vec(u * (0, w) * v) for quaternions u, v
  (..., 4)."""
  u0, uv = u[..., 0, None, None], u[..., 1:]
  v0, vv = v[..., 0, None, None], v[..., 1:]
  eye = torch.eye(3, dtype=u.dtype, device=u.device)
  su, sv = math.cross_skew(uv), math.cross_skew(vv)
  return (-(vv[..., :, None] * uv[..., None, :]) + (v0 * u0) * eye + v0 * su - u0 * sv
          - sv @ su)


def _vel_products(m: Model, d: Data):
  """(cvel, cacc_bias), each (B, nbody, 6): com-frame velocities and the
  velocity-product accelerations (no gravity, qacc = 0) that the
  equality rows' J̇q̇ bias reads.  make_constraint runs before com_vel, so
  this runs its own, as mjtpu does."""
  from mjtpu_torch._src import smooth

  d_v = smooth.com_vel(m, d)

  def cacc_fn(carry, cdof_dot, qvel):
    cacc = cdof_dot.new_zeros(cdof_dot.shape[:-2] + (6,)) if carry is None else carry
    return cacc + torch.einsum("...wi,...w->...i", cdof_dot, qvel)

  return d_v.cvel, scan.body_tree(m, cacc_fn, "vv", "b", d_v.cdof_dot, d.qvel)


def _point_acc_bias(m: Model, d: Data, cvel, cacc_bias, p, b):
  """(B, K, 3) classical acceleration of the body-fixed points p (B, K, 3)
  of bodies b (K,) with qacc = 0 and no gravity."""
  off = p - d.subtree_com[:, index(m, "body_rootid")[b]]
  w, cb = cvel[:, b], cacc_bias[:, b]
  v_p = w[..., 3:] - math.cross(off, w[..., :3])
  a_lin = cb[..., 3:] - math.cross(off, cb[..., :3])
  return a_lin + math.cross(w[..., :3], v_p)


def _poly(data, dif):
  """The coupling polynomial's value and slope at dif (B, K): data (E, K,
  5) its coefficients, constant term first."""
  powers = torch.arange(5, dtype=dif.dtype, device=dif.device)
  pows = dif[..., None] ** powers
  value = torch.sum(data * pows, dim=-1)
  deriv = torch.sum(data[..., 1:] * powers[1:] * pows[..., :4], dim=-1)
  return value, deriv


def _eq_index(m: Model) -> tuple[list[tuple[int, dict]], torch.Tensor | None]:
  """Per equality type present, in EqType order: (type, its index tables
  over its K equalities as device tensors: ids, the objects and, for the
  joint and tendon ones, where each reads its references and invweights);
  and the permutation from that type-grouped row order back to eq order
  (None if the identity)."""

  def build():
    eq_type = np.asarray(m.eq_type)
    t = lambda x: torch.as_tensor(np.asarray(x), device=m.device)
    obj1, obj2 = np.asarray(m.eq_obj1id), np.asarray(m.eq_obj2id)
    groups, starts, base = [], {}, 0
    for et in EqType:
      ids = np.nonzero(eq_type == int(et))[0]
      if not len(ids):
        continue
      per = support.EQ_ROWS[int(et)]
      for k, e in enumerate(ids):
        starts[int(e)] = (base + per * k, per)
      base += per * len(ids)
      o1, o2 = obj1[ids], obj2[ids]
      c = dict(per=per, ids=t(ids), o1=t(o1))
      if et in (EqType.CONNECT, EqType.WELD):
        c.update(b1=c["o1"], b2=t(o2))
      else:
        has2 = o2 > -1
        o2 = np.where(has2, o2, 0)
        c.update(o2=t(o2), has2=torch.as_tensor(has2, dtype=m.dtype, device=m.device))
        if et == EqType.JOINT:
          qadr, dadr = np.asarray(m.jnt_qposadr), np.asarray(m.jnt_dofadr)
          c.update(q1=t(qadr[o1]), q2=t(qadr[o2]), d1=t(dadr[o1]), d2=t(dadr[o2]))
          onehot = lambda adr: torch.as_tensor(np.eye(m.nv)[adr], dtype=m.dtype,
                                               device=m.device)
          c["dof1"] = onehot(dadr[o1])
          c["dof2"] = onehot(dadr[o2]) * c["has2"][:, None]
        else:
          c.update(t1=c["o1"], t2=c["o2"])
      groups.append((int(et), c))
    perm = np.concatenate([np.arange(s, s + n) for s, n in
                           (starts[e] for e in range(len(eq_type)))])
    return groups, None if np.array_equal(perm, np.arange(len(perm))) else t(perm)

  return cached(m, "constraint.eq_index", build)


def _eq_tables(m: Model) -> tuple[list[tuple[int, dict]], torch.Tensor | None]:
  """_eq_index's groups, each with its constants read from the traced
  fields (the data, solref and solimp per row, the invweight and the
  joint and tendon references), with the env axis of env_rows; and the
  permutation back to eq order."""
  index_groups, perm = _eq_index(m)

  def build():
    groups = []
    for et, ix in index_groups:
      per = ix["per"]
      rep = lambda x: torch.repeat_interleave(x, per, dim=1)
      c = dict(ix, data=env_rows(m, "eq_data")[:, ix["ids"]],
               solref=rep(env_rows(m, "eq_solref")[:, ix["ids"]]),
               solimp=rep(env_rows(m, "eq_solimp")[:, ix["ids"]]))
      if et in (EqType.CONNECT, EqType.WELD):
        biw = env_rows(m, "body_invweight0")
        iw = biw[:, ix["b1"]] + biw[:, ix["b2"]]                      # (E, K, 2)
        c["invweight"] = (torch.repeat_interleave(iw[..., 0], per, dim=1)
                          if et == EqType.CONNECT else
                          torch.cat([iw[..., :1].expand(-1, -1, 3), iw[..., 1:].expand(-1, -1, 3)],
                                    dim=2).reshape(iw.shape[0], -1))
      else:
        if et == EqType.JOINT:
          qpos0 = env_rows(m, "qpos0")
          c.update(ref1=qpos0[:, ix["q1"]], ref2=qpos0[:, ix["q2"]])
          diw = env_rows(m, "dof_invweight0")
          iw1, iw2 = diw[:, ix["d1"]], diw[:, ix["d2"]]
        else:
          length0, tiw = env_rows(m, "tendon_length0"), env_rows(m, "tendon_invweight0")
          c.update(ref1=length0[:, ix["t1"]], ref2=length0[:, ix["t2"]])
          iw1, iw2 = tiw[:, ix["t1"]], tiw[:, ix["t2"]]
        c["invweight"] = torch.where(ix["has2"] > 0, iw1 + iw2, iw1)
      groups.append((et, c))
    return groups

  return cached(m, "constraint.eq_tables", build, live=True), perm


def _eq_rows(m: Model, d: Data) -> tuple[list[_Rows], torch.Tensor]:
  """Equality constraint rows, in eq order, and their J̇q̇ bias (B, ne),
  which aref subtracts so that a row prescribes the true residual
  acceleration (MuJoCo C; the connect and weld rows', zero for the joint
  and tendon ones).  An equality whose eq_active is off keeps its rows
  with J, pos and bias zeroed."""
  B, dtype = d.qpos.shape[0], d.qpos.dtype
  groups, perm = _eq_tables(m)
  if any(et in (EqType.CONNECT, EqType.WELD) for et, _ in groups):
    cvel, cacc_bias = _vel_products(m, d)
  rows = lambda x: env_expand(x, B)
  parts, biases = [], []
  for et, c in groups:
    active = d.eq_active[:, c["ids"]].to(dtype)                       # (B, K)
    K = active.shape[1]
    if et in (EqType.CONNECT, EqType.WELD):
      b1, b2, data = c["b1"], c["b2"], c["data"]
      # a connect's data: anchor in body1, anchor in body2; a weld's:
      # anchor in body2, anchor in body1, relpose quaternion, torquescale
      a1, a2 = (data[..., 0:3], data[..., 3:6]) if et == EqType.CONNECT else (
          data[..., 3:6], data[..., 0:3])
      pos1 = math.mat_vec(d.xmat[:, b1], a1) + d.xpos[:, b1]
      pos2 = math.mat_vec(d.xmat[:, b2], a2) + d.xpos[:, b2]
      cpos = pos1 - pos2
      jacp1, jacr1 = support.jac_rows(m, d, pos1, b1)
      jacp2, jacr2 = support.jac_rows(m, d, pos2, b2)
      J = jacp1 - jacp2                                                # (B, K, 3, nv)
      bias = (_point_acc_bias(m, d, cvel, cacc_bias, pos1, b1)
              - _point_acc_bias(m, d, cvel, cacc_bias, pos2, b2))
      if et == EqType.CONNECT:
        pos_imp = math.norm3(cpos)[..., None].expand(B, K, 3)
      else:
        relpose, ts = data[..., 6:10], data[..., 10:11]
        # rotational residual r = ts vec(q2^-1 (q1 relpose)); its rate is
        # ts/2 A (w1 - w2), A = _quat_vec_map(u, v)
        u = math.quat_inv(d.xquat[:, b2])
        v = math.quat_mul(d.xquat[:, b1], relpose)
        crot = math.quat_mul(u, v)[..., 1:] * ts
        jr = (0.5 * ts)[..., None] * (_quat_vec_map(u, v) @ (jacr1 - jacr2))
        w1, w2 = cvel[:, b1, :3], cvel[:, b2, :3]
        dw = w1 - w2
        dwb = cacc_bias[:, b1, :3] - cacc_bias[:, b2, :3]
        P = lambda w: torch.cat([torch.zeros_like(w[..., :1]), w], dim=-1)
        qm = math.quat_mul
        qdd = 0.5 * (qm(u, qm(P(dwb), v)) + 0.5 * qm(u, qm(P(dw), qm(P(w1), v)))
                     - 0.5 * qm(u, qm(P(w2), qm(P(dw), v))))
        J = torch.cat([J, jr], dim=2)
        cpos = torch.cat([cpos, crot], dim=-1)
        bias = torch.cat([bias, ts * qdd[..., 1:]], dim=-1)
        # the norm of the gated residual, as mjtpu's (a connect's is not gated)
        pos_imp = math.safe_norm(cpos * active[..., None])[..., None].expand(B, K, 6)
      n = J.shape[2]
      J = (J * active[..., None, None]).reshape(B, K * n, m.nv)
      cpos = (cpos * active[..., None]).reshape(B, K * n)
      bias = (bias * active[..., None]).reshape(B, K * n)
      pos_imp = pos_imp.reshape(B, K * n)
    else:
      has2 = c["has2"]
      if et == EqType.JOINT:
        pos1 = d.qpos[:, c["q1"]] - c["ref1"]
        dif = (d.qpos[:, c["q2"]] - c["ref2"]) * has2
      else:
        pos1 = d.ten_length[:, c["t1"]] - c["ref1"]
        dif = (d.ten_length[:, c["t2"]] - c["ref2"]) * has2
      value, deriv = _poly(c["data"][..., :5], dif)
      cpos_raw = pos1 - value
      if et == EqType.JOINT:
        J = c["dof1"] - deriv[..., None] * c["dof2"]
      else:
        J = d.ten_J[:, c["t1"]] - (deriv * has2)[..., None] * d.ten_J[:, c["t2"]]
      J = J * active[..., None]
      cpos = cpos_raw * active
      pos_imp = torch.abs(cpos_raw)
      bias = torch.zeros_like(cpos)
    zero = torch.zeros_like(cpos)
    parts.append(_Rows(
        J=J, pos=cpos, pos_imp=pos_imp, pos_out=cpos, margin=zero,
        invweight=rows(c["invweight"]), solref=rows(c["solref"]), solimp=rows(c["solimp"]),
        frictionloss=zero, r_scale=torch.ones_like(zero),
    ))
    biases.append(bias)
  block = _Rows(*(torch.cat([getattr(p, f) for p in parts], dim=1) for f in _Rows._fields))
  bias = torch.cat(biases, dim=1)
  if perm is not None:
    block = _Rows(*(getattr(block, f)[:, perm] for f in _Rows._fields))
    bias = bias[:, perm]
  return [block], bias


def _friction_rows(m: Model, d: Data) -> list[_Rows]:
  """Frictionloss rows at pos 0: a unit Jacobian row per dof with
  frictionloss, in dof order, then the Jacobian row of each tendon with
  frictionloss, in tendon order."""
  B = d.qpos.shape[0]

  def index():
    """Per kind: the objects' ids on the device, and the dofs' Jacobian."""
    dofs, tens = np.asarray(m.friction_dofid), np.asarray(m.friction_tenid)
    out = {}
    if len(dofs):
      onehot = np.zeros((len(dofs), m.nv))
      onehot[np.arange(len(dofs)), dofs] = 1.0
      out["dof"] = (torch.as_tensor(dofs, device=m.device),
                    torch.as_tensor(onehot, dtype=m.dtype, device=m.device))
    if len(tens):
      out["tendon"] = (torch.as_tensor(tens, device=m.device),) * 2
    return out

  ix = cached(m, "constraint.friction_index", index)

  def build():
    out = {}
    for kind, prefix, fri in (("dof", "dof", ""), ("tendon", "tendon", "_fri")):
      if kind in ix:
        ids, jac = ix[kind]
        out[kind] = (jac, *(env_rows(m, f"{prefix}_{f}")[:, ids] for f in (
            "invweight0", f"solref{fri}", f"solimp{fri}", "frictionloss")))
    return out

  # every table but the Jacobian has the env axis of env_rows
  tables = cached(m, "constraint.friction_rows", build, live=True)
  rows = lambda x: env_expand(x, B)
  out = []
  for kind, (jac, invweight, solref, solimp, frictionloss) in tables.items():
    jac = jac.expand((B,) + jac.shape) if kind == "dof" else d.ten_J[:, jac]
    zero = d.qpos.new_zeros((B, invweight.shape[1]))
    out.append(_Rows(
        J=jac, pos=zero, pos_imp=zero, pos_out=zero, margin=zero,
        invweight=rows(invweight), solref=rows(solref), solimp=rows(solimp),
        frictionloss=rows(frictionloss), r_scale=torch.ones_like(zero),
    ))
  return out


def _limit_rows(m: Model, d: Data) -> list[_Rows]:
  """Limit rows: those of joints, then those of tendons."""
  return _joint_limit_rows(m, d) + _tendon_limit_rows(m, d)


def _tendon_limit_rows(m: Model, d: Data) -> list[_Rows]:
  """Limit rows of tendons, in tendon order: one row each, at the nearer
  side, or, where some limited tendon's range is narrower than 2*margin
  (support.tendon_limit_rows_per), two each, lower then upper; +J pushes
  the length up (the lower limit), -J down, as the joints' rows."""
  tens = np.nonzero(np.asarray(m.tendon_limited))[0]
  if not len(tens):
    return []
  B, dtype = d.qpos.shape[0], d.qpos.dtype
  per = support.tendon_limit_rows_per(m)

  ix = cached(m, "constraint.tendon_limit_index", lambda: dict(
      ids=torch.as_tensor(tens, device=m.device),
      side=torch.tensor([1.0, -1.0], dtype=m.dtype, device=m.device).repeat(len(tens))))

  def build():
    # every table but ids and side has the env axis of env_rows
    rep = lambda x: torch.repeat_interleave(x, per, dim=1)
    ids = ix["ids"]
    rng, margin = env_rows(m, "tendon_range")[:, ids], env_rows(m, "tendon_margin")[:, ids]
    return dict(
        ix, lo=rng[..., 0], hi=rng[..., 1], margin=margin, margin_rows=rep(margin),
        invweight=rep(env_rows(m, "tendon_invweight0")[:, ids]),
        solref=rep(env_rows(m, "tendon_solref_lim")[:, ids]),
        solimp=rep(env_rows(m, "tendon_solimp_lim")[:, ids]),
    )

  c = cached(m, "constraint.tendon_limit_rows", build, live=True)
  length = d.ten_length[:, c["ids"]]
  jac = d.ten_J[:, c["ids"]]
  dist_min = length - c["lo"]
  dist_max = c["hi"] - length
  if per == 2:
    pos = torch.stack([dist_min, dist_max], dim=-1).reshape(B, 2 * len(tens)) - c["margin_rows"]
    side = c["side"]
    jac = torch.repeat_interleave(jac, 2, dim=1)
  else:
    pos = torch.minimum(dist_min, dist_max) - c["margin"]
    side = torch.where(dist_min < dist_max, 1.0, -1.0).to(dtype)
  active = (pos < 0).to(dtype)
  rows = lambda x: env_expand(x, B)
  return [_Rows(
      J=(side * active)[..., None] * jac, pos=pos, pos_imp=pos, pos_out=pos,
      margin=rows(c["margin_rows"]), invweight=rows(c["invweight"]),
      solref=rows(c["solref"]), solimp=rows(c["solimp"]),
      frictionloss=torch.zeros_like(pos), r_scale=torch.ones_like(pos),
  )]


def _joint_limit_rows(m: Model, d: Data) -> list[_Rows]:
  """Limit rows of joints, by category — scalar joints' one-sided rows
  (range wider than 2*margin) and two-sided pairs, ball joints' rows on
  their rotation angle — permuted back to mj joint order."""
  B = d.qpos.shape[0]
  limited = np.nonzero(np.asarray(m.jnt_limited))[0]
  if not len(limited):
    return []
  dtype = d.qpos.dtype

  def index():
    """Per category (one-sided, two-sided, ball): its joints, their dofs
    and qpos addresses, and its rows' placement; and the permutation back
    to joint order (None if identity)."""
    two = np.asarray(m.jnt_limit_two_sided).astype(bool)
    ball = np.asarray(m.jnt_type)[limited] == JointType.BALL
    sh1 = limited[~ball & ~two[limited]]
    sh2 = limited[~ball & two[limited]]
    balls = limited[ball]
    starts, base = {}, 0
    for cat, per in ((sh1, 1), (sh2, 2), (balls, 1)):
      for p, j in enumerate(cat):
        starts[j] = (base + per * p, per)
      base += per * len(cat)
    perm = np.concatenate([np.arange(s, s + c) for s, c in (starts[j] for j in limited)])
    qadr, dadr = np.asarray(m.jnt_qposadr), np.asarray(m.jnt_dofadr)
    t = lambda x: torch.as_tensor(x, device=m.device)
    cats = []
    for cat, per in ((sh1, 1), (sh2, 2)):
      if not len(cat):
        continue
      cats.append(dict(
          per=per, n=len(cat), jnt=t(cat), dof=t(dadr[cat]), qadr=t(qadr[cat]),
          onehot=torch.as_tensor(np.eye(m.nv)[np.repeat(dadr[cat], per)], dtype=m.dtype,
                                 device=m.device),
          side=torch.tensor([1.0, -1.0], dtype=m.dtype, device=m.device).repeat(len(cat)),
      ))
    if len(balls):
      # J[i, dadr_i + k] = -axis_i[k] * active_i: a (n, 3, nv) placement
      place = np.zeros((len(balls), 3, m.nv))
      place[np.arange(len(balls))[:, None], np.arange(3), dadr[balls][:, None] + np.arange(3)] = 1
      cats.append(dict(
          per=None, jnt=t(balls), dof=t(dadr[balls]),
          quat=t(qadr[balls][:, None] + np.arange(4)),
          place=torch.as_tensor(place, dtype=m.dtype, device=m.device),
          x_axis=torch.tensor([1.0, 0.0, 0.0], dtype=m.dtype, device=m.device)))
    identity = np.array_equal(perm, np.arange(len(perm)))
    return cats, None if identity else t(perm)

  index_cats, perm = cached(m, "constraint.limit_index", index)

  def build():
    """Per category, its index tables with the model constants of its
    rows, each with the env axis of env_rows."""
    jnt_range, dof_iw = env_rows(m, "jnt_range"), env_rows(m, "dof_invweight0")
    margin = env_rows(m, "jnt_margin")
    solref, solimp = env_rows(m, "jnt_solref"), env_rows(m, "jnt_solimp")
    cats = []
    for ix in index_cats:
      j, per = ix["jnt"], ix["per"]
      if per is None:
        rng = jnt_range[:, j]
        cats.append(dict(
            ix, limit=torch.maximum(torch.abs(rng[..., 0]), torch.abs(rng[..., 1])),
            margin=margin[:, j], invweight=dof_iw[:, ix["dof"]],
            solref=solref[:, j], solimp=solimp[:, j]))
        continue
      rep = lambda x: torch.repeat_interleave(x, per, dim=1)
      cats.append(dict(
          ix, lo=jnt_range[:, j, 0], hi=jnt_range[:, j, 1], margin=margin[:, j],
          margin_rows=rep(margin[:, j]), invweight=rep(dof_iw[:, ix["dof"]]),
          solref=rep(solref[:, j]), solimp=rep(solimp[:, j])))
    return cats

  cats = cached(m, "constraint.limit_rows", build, live=True)
  parts = []
  rows = lambda x: env_expand(x, B)
  for c in cats:
    if c["per"] is None:
      # a ball joint: its rotation angle against the larger |range|
      axis, angle = math.normalize_with_norm(math.quat_to_vel(d.qpos[:, c["quat"]]))
      # C's mju_normalize3 leaves (1, 0, 0) for a zero rotation, where the
      # row can be live through the margin
      axis = torch.where((angle < math.MINVAL)[..., None], c["x_axis"], axis)
      pos = c["limit"] - angle - c["margin"]
      active = (pos < 0).to(dtype)
      J = torch.einsum("bnk,nkv->bnv", -axis * active[..., None], c["place"])
      parts.append(_Rows(
          J=J, pos=pos, pos_imp=pos, pos_out=pos, margin=rows(c["margin"]),
          invweight=rows(c["invweight"]), solref=rows(c["solref"]),
          solimp=rows(c["solimp"]),
          frictionloss=torch.zeros_like(pos), r_scale=torch.ones_like(pos),
      ))
      continue
    q = d.qpos[:, c["qadr"]]
    dist_min = q - c["lo"]
    dist_max = c["hi"] - q
    if c["per"] == 1:
      # wide range: at most one side is within margin at a time
      pos = torch.minimum(dist_min, dist_max) - c["margin"]
      side = torch.where(dist_min < dist_max, 1.0, -1.0).to(dtype)
    else:
      # range narrower than 2*margin: lower then upper row, each gated
      pos = torch.stack([dist_min, dist_max], dim=-1).reshape(B, 2 * c["n"])
      pos = pos - c["margin_rows"]
      side = c["side"]
    active = (pos < 0).to(dtype)
    parts.append(_Rows(
        J=c["onehot"] * (side * active)[..., None],
        pos=pos, pos_imp=pos, pos_out=pos,
        margin=rows(c["margin_rows"]), invweight=rows(c["invweight"]),
        solref=rows(c["solref"]), solimp=rows(c["solimp"]),
        frictionloss=torch.zeros_like(pos), r_scale=torch.ones_like(pos),
    ))
  block = _Rows(*(torch.cat([getattr(p, f) for p in parts], dim=1) for f in _Rows._fields))
  if perm is not None:
    block = _Rows(*(getattr(block, f)[:, perm] for f in _Rows._fields))
  return [block]


def _contact_rows(m: Model, d: Data) -> list[_Rows]:
  """Contact rows, vectorized per condim group (the contacts arrive
  condim-sorted from the driver, so each group is contiguous).  Condim 1
  (frictionless): one row, the normal.  Condim 3, 4 and 6 rub along their
  tangents: the two translational ones, then (4 and 6) the rotational
  ones, torsion about the normal first.  A pyramidal cone gives each
  tangent a pair of edges, normal +- friction * tangent; an elliptic one
  gives the normal, then a row per tangent."""
  from mjtpu_torch._src import collision_driver

  ncon = collision_driver.ncon(m)
  if ncon == 0:
    return []
  B = d.qpos.shape[0]
  con = d.contact

  def build():
    dims = collision_driver.make_condim(m)
    out = []
    for condim in sorted(set(int(c) for c in dims)):
      idx = np.nonzero(dims == condim)[0]
      out.append((condim, slice(int(idx[0]), int(idx[-1]) + 1)))
    return out

  groups = cached(m, "constraint.contact_groups", build)
  jt, jr, (b1, b2) = _contact_jacobians(m, d, rotational=groups[-1][0] > 3)
  iw_body = env_expand(env_rows(m, "body_invweight0")[..., 0], B)
  iw_all = torch.gather(iw_body, 1, b1) + torch.gather(iw_body, 1, b2)  # (B, ncon)
  pos_all = con.dist - con.includemargin
  active_all = (pos_all < 0).to(pos_all.dtype)
  cfg = get_diff_config()
  if cfg is not None and cfg.cfd:
    # contacts from distance: a sigmoid activation within cfd_width and a
    # softplus penetration, each through a straight-through estimator, so
    # the values are the hard ones (active below cfd_width) and the
    # gradients the soft ones
    soft_act = torch.sigmoid(-pos_all / cfg.cfd_width)
    hard_act = (pos_all < cfg.cfd_width).to(pos_all.dtype)
    active_all = soft_act + (hard_act - soft_act).detach()
    x = -pos_all / cfg.cfd_dc
    pos_soft = -cfg.cfd_dc * torch.logaddexp(x, torch.zeros_like(x))
    pos_all = pos_soft + (pos_all - pos_soft).detach()
  elliptic = m.opt.cone == ConeType.ELLIPTIC

  rows = []
  for condim, sl in groups:
    k = sl.stop - sl.start
    jn = jt[:, sl, None, 0]                 # (B, k, 1, nv) normal rows
    pos, active, iw = pos_all[:, sl], active_all[:, sl], iw_all[:, sl]
    solref = con.solref[:, sl]
    if condim == 1:
      n_rows = 1
      J = jn * active[..., None, None]
      invweight, r_scale, posr = iw, torch.ones_like(iw), pos
    else:
      mu = con.friction[:, sl]              # (B, k, 5)
      tang = jt[:, sl, 1:3]
      if condim > 3:
        tang = torch.cat([tang, jr[:, sl, :condim - 3]], dim=2)  # (B, k, condim-1, nv)
      f = mu[..., :condim - 1, None]
      if not elliptic:
        n_rows = 2 * (condim - 1)
        plus, minus = jn + f * tang, jn - f * tang
        J = torch.stack([plus, minus], dim=3).reshape(B, k, n_rows, m.nv) * active[..., None, None]
        # all pyramid rows share the friction[0]-based invweight (mj C); the
        # 2*mu^2 factor scales outside the R floor (see _Rows.r_scale)
        invweight = iw + mu[..., 0] ** 2 * iw
        r_scale, posr = 2.0 * mu[..., 0] ** 2, pos
      else:
        n_rows = condim
        J = torch.cat([jn, tang], dim=2) * active[..., None, None]
        invweight = iw
        # friction rows: D_i = D_n * impratio * (mu_i/mu_0)^2, applied
        # outside the R floor (see _Rows.r_scale)
        mu_ratio2 = (mu[..., :condim - 1] / torch.clamp_min(mu[..., :1], math.MINVAL)) ** 2
        r_scale = torch.cat([
            torch.ones_like(pos)[..., None],
            1.0 / torch.clamp_min(env_rows(m, "opt.impratio")[:, None, None] * mu_ratio2,
                                  math.MINVAL)], dim=-1)
        # friction rows take solreffriction where it is not zero
        srf = con.solreffriction[:, sl]
        use_srf = torch.any(srf != 0.0, dim=-1, keepdim=True)
        srf_row = torch.where(use_srf, srf, solref)
        solref = torch.cat([solref[:, :, None], srf_row[:, :, None].expand(B, k, condim - 1, 2)],
                           dim=2)
        # friction rows sit at position 0 (no normal coupling)
        posr = torch.cat([pos[..., None], pos.new_zeros((B, k, condim - 1))], dim=-1)
    rows.append(_Rows(
        J=J.reshape(B, n_rows * k, m.nv),
        pos=_per_row(posr, n_rows),
        pos_imp=_per_row(pos, n_rows),
        pos_out=_per_row(con.dist[:, sl], n_rows),
        margin=_per_row(con.includemargin[:, sl], n_rows),
        invweight=_per_row(invweight, n_rows),
        solref=_per_row(solref, n_rows, extra=1),
        solimp=_per_row(con.solimp[:, sl], n_rows, extra=1),
        frictionloss=pos.new_zeros((B, n_rows * k)),
        r_scale=_per_row(r_scale, n_rows),
    ))
  return rows


def _per_row(x: torch.Tensor, n_rows: int, extra: int = 0) -> torch.Tensor:
  """A group's per-row values (B, k * n_rows, ...) from ``x``: (B, k, ...)
  values a contact, repeated over its rows, or (B, k, n_rows, ...) values
  a row.  ``extra`` is the number of trailing axes of one value (a
  solref's 1)."""
  B, k = x.shape[:2]
  if x.dim() == 2 + extra:
    x = x[:, :, None].expand((B, k, n_rows) + x.shape[2:])
  return x.reshape((B, k * n_rows) + x.shape[3:])


def make_constraint(m: Model, d: Data) -> Data:
  """Assembles all constraint rows into efc_* (mj_makeConstraint)."""
  B = d.qpos.shape[0]
  dtype, device = d.qpos.dtype, d.qpos.device
  _, _, _, nefc = support.count_constraints(m)

  if nefc == 0:
    z = torch.zeros((B, 0), dtype=dtype, device=device)
    return replace(
        d, efc_J=torch.zeros((B, 0, m.nv), dtype=dtype, device=device),
        efc_pos=z, efc_margin=z, efc_frictionloss=z, efc_D=z, efc_aref=z, efc_force=z,
    )

  rows: list[_Rows] = []
  eq_bias = None
  if m.neq and not (m.opt.disableflags & DisableBit.EQUALITY):
    rows, eq_bias = _eq_rows(m, d)
  if not (m.opt.disableflags & DisableBit.FRICTIONLOSS):
    rows += _friction_rows(m, d)
  if not (m.opt.disableflags & DisableBit.LIMIT):
    rows += _limit_rows(m, d)
  if not (m.opt.disableflags & DisableBit.CONTACT):
    rows += _contact_rows(m, d)

  cat = lambda f: torch.cat([getattr(r, f) for r in rows], dim=1)
  J, pos, pos_imp, pos_out = cat("J"), cat("pos"), cat("pos_imp"), cat("pos_out")
  margin, invweight, r_scale = cat("margin"), cat("invweight"), cat("r_scale")
  solref, solimp, frictionloss = cat("solref"), cat("solimp"), cat("frictionloss")

  k, b, imp = _kbi(m, solref, solimp, pos_imp)
  jv = torch.einsum("bnv,bv->bn", J, d.qvel)
  aref = -b * jv - k * imp * pos
  if eq_bias is not None:
    # the equality rows come first; every other row's bias is 0
    ne = eq_bias.shape[1]
    aref = torch.cat([aref[:, :ne] - eq_bias, aref[:, ne:]], dim=1)
  R = r_scale * torch.clamp_min(
      invweight * (1.0 - imp) / torch.clamp_min(imp, math.MINVAL), math.MINVAL
  )
  # no re-floor after scaling; the tiny guard only prevents 1/0
  D = 1.0 / torch.clamp_min(R, torch.finfo(dtype).tiny)

  return replace(
      d, efc_J=J, efc_pos=pos_out, efc_margin=margin, efc_frictionloss=frictionloss,
      efc_D=D, efc_aref=aref, efc_force=torch.zeros_like(pos),
  )
