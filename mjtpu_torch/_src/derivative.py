"""Smooth-dynamics derivatives for implicit integration.

Port of mjtpu/_src/derivative.py's ``deriv_smooth_vel`` (mjd_smooth_vel),
batch-explicit: the affine actuator gain (its input the activation state
where the actuator has one) and bias terms, joint and tendon damping, the
fluid forces' velocity derivative (both fluid models, with wind), and for
the full Implicit integrator (``rne=True``) the RNE bias force's, then
the kinematic-chain mask.

mjtpu takes the fluid and RNE terms with ``jax.jacfwd`` over
``com_vel`` + ``passive._fluid`` and ``com_vel`` + ``rne``.  The port
takes the same forward-mode derivative, its product rule written out
(smooth.rne_jvp, and passive._fluid given a tangent), in one pass over a
(B * nv) batch: env b's nv copies stacked along the batch, copy j
carrying the one-hot tangent e_j on qvel, so the pass launches what one
``com_vel`` + ``rne`` launches, not nv times that.  com_vel is linear in qvel (the world is at
rest), so its tangent along e_j is com_vel at qvel = e_j.  (torch's own
forward mode, ``torch.autograd.forward_ad``, gives the same numbers, but
each operation between a dual and a plain tensor costs it some 0.5 ms of
host time.)
"""

from __future__ import annotations

import numpy as np
import torch

from mjtpu_torch._src import passive, smooth, support
from mjtpu_torch._src.dataclasses import replace
from mjtpu_torch._src.types import (BiasType, Data, DisableBit, GainType, Model, cached,
                                    derived, repeat_env_rows, rows as env_rows)

# the Data fields the fluid and RNE passes read; every other field is
# left out of the stacked batch
_PASS_FIELDS = ("qvel", "cdof", "cvel", "cdof_dot", "cinert", "subtree_com", "xipos", "ximat",
                "geom_xpos", "geom_xmat")


def deriv_smooth_vel(m: Model, d: Data, rne: bool = False) -> torch.Tensor:
  """(B, nv, nv) derivative of the smooth forces with respect to qvel;
  with ``rne`` (the full Implicit integrator) less the RNE bias force's."""
  B = d.qpos.shape[0]
  qderiv = torch.zeros((B, m.nv, m.nv), dtype=d.qpos.dtype, device=d.qpos.device)

  # actuation: moment^T @ diag(dforce/dvel) @ moment
  if m.nu and not (m.opt.disableflags & DisableBit.ACTUATION):
    dgain = torch.zeros_like(d.ctrl)
    ids = np.nonzero(np.asarray(m.actuator_gaintype) == GainType.AFFINE)[0]
    if len(ids):  # dforce/dvel += gainprm[2] * input (ctrl, or the last activation)
      dgain[:, ids] += env_rows(m, "actuator_gainprm")[:, ids, 2] * _actuator_input(m, d)[:, ids]
    ids = np.nonzero(np.asarray(m.actuator_biastype) == BiasType.AFFINE)[0]
    if len(ids):
      dgain[:, ids] += env_rows(m, "actuator_biasprm")[:, ids, 2]
    moment = d.actuator_moment
    qderiv = qderiv + moment.transpose(-1, -2) @ (dgain[..., None] * moment)

  # passive damping
  if not (m.opt.disableflags & DisableBit.DAMPER):
    if m.has_dof_damping:
      qderiv = qderiv - torch.diag_embed(env_rows(m, "dof_damping"))
    if m.has_tendon_damping:
      damping = env_rows(m, "tendon_damping")[..., None]
      qderiv = qderiv - d.ten_J.transpose(-1, -2) @ (damping * d.ten_J)

  # the fluid forces' velocity derivative (mjtpu: jacfwd of com_vel +
  # passive._fluid), both fluid models
  fluid = m.opt.has_fluid_params and not (m.opt.disableflags & DisableBit.PASSIVE)
  if fluid or rne:
    dfluid, dbias = _velocity_jacobians(m, d, fluid, rne)
    if fluid:
      qderiv = qderiv + dfluid
    if rne:  # qfrc_smooth holds -qfrc_bias
      qderiv = qderiv - dbias

  # qDeriv shares qM's kinematic-chain sparsity: C drops the cross terms
  # between non-ancestor dofs
  return qderiv * smooth.chain_pattern(m)


def _tangents(m: Model, batch: int, dtype, device) -> torch.Tensor:
  """(batch * nv, nv): env b's copy j holds the one-hot e_j."""
  eye = cached(m, ("derivative.eye", dtype), lambda: torch.eye(m.nv, dtype=dtype, device=device))
  return eye.repeat(batch, 1)


def _velocity_jacobians(m: Model, d: Data, fluid: bool, rne: bool):
  """(d qfrc_fluid / d qvel, d qfrc_bias / d qvel), each (B, nv, nv) or
  None where not asked for: the tangents of passive._fluid and rne along
  every e_j, over the envs' nv copies stacked along the batch."""
  B, nv = d.qvel.shape
  stack = lambda x: x.repeat_interleave(nv, dim=0)
  fields = {f: stack(getattr(d, f)) for f in _PASS_FIELDS}
  # the fields the passes do not read stay out of the (B * nv) batch
  rest = {f: None for f in d.__dataclass_fields__ if f not in fields}
  dd = replace(d, **fields, **rest)
  # a model's env rows follow its envs into the stack
  m = derived(m, ("derivative.stacked", nv), lambda: repeat_env_rows(m, nv))
  qvel_t = _tangents(m, B, d.qvel.dtype, d.qvel.device)
  tan = smooth.com_vel(m, replace(dd, qvel=qvel_t))
  # column j of env b's Jacobian is its copy j's tangent
  jac = lambda x: x.reshape(B, nv, nv).transpose(1, 2)
  dfluid = jac(passive._fluid(m, dd, tan.cvel)) if fluid else None
  dbias = jac(smooth.rne_jvp(m, dd, qvel_t, tan.cvel, tan.cdof_dot)) if rne else None
  return dfluid, dbias


def _actuator_input(m: Model, d: Data) -> torch.Tensor:
  """(B, nu) each actuator's input without actearly: its last activation
  where it has an activation state, else its ctrl (unclamped, as mjtpu's
  derivative reads it)."""
  if not m.na:
    return d.ctrl
  stateful, last, _ = support.act_input(m)
  return torch.where(stateful, d.act[:, last], d.ctrl)
