"""Smooth-dynamics derivatives for implicit integration.

Port of mjtpu/_src/derivative.py's ``deriv_smooth_vel`` (mjd_smooth_vel)
for the ImplicitFast integrator: the affine actuator gain (its input the
activation state where the actuator has one) and bias terms, joint and
tendon damping, and the kinematic-chain mask, batch-explicit.  Fluid drag
and the RNE derivative of the full Implicit integrator (``rne=True``)
wait for later slices; put_model refuses the models that need them.
"""

from __future__ import annotations

import numpy as np
import torch

from mjtpu_torch._src import smooth, support
from mjtpu_torch._src.types import BiasType, Data, DisableBit, GainType, Model


def deriv_smooth_vel(m: Model, d: Data) -> torch.Tensor:
  """(B, nv, nv) derivative of the smooth forces with respect to qvel."""
  B = d.qpos.shape[0]
  qderiv = torch.zeros((B, m.nv, m.nv), dtype=d.qpos.dtype, device=d.qpos.device)

  # actuation: moment^T @ diag(dforce/dvel) @ moment
  if m.nu and not (m.opt.disableflags & DisableBit.ACTUATION):
    dgain = torch.zeros_like(d.ctrl)
    ids = np.nonzero(np.asarray(m.actuator_gaintype) == GainType.AFFINE)[0]
    if len(ids):  # dforce/dvel += gainprm[2] * input (ctrl, or the last activation)
      dgain[:, ids] += m.actuator_gainprm[ids, 2] * _actuator_input(m, d)[:, ids]
    ids = np.nonzero(np.asarray(m.actuator_biastype) == BiasType.AFFINE)[0]
    if len(ids):
      dgain[:, ids] += m.actuator_biasprm[ids, 2]
    moment = d.actuator_moment
    qderiv = qderiv + moment.transpose(-1, -2) @ (dgain[..., None] * moment)

  # passive damping
  if not (m.opt.disableflags & DisableBit.DAMPER):
    if m.has_dof_damping:
      qderiv = qderiv - torch.diag(m.dof_damping)
    if m.has_tendon_damping:
      qderiv = qderiv - d.ten_J.transpose(-1, -2) @ (m.tendon_damping[:, None] * d.ten_J)

  # qDeriv shares qM's kinematic-chain sparsity: C drops the cross terms
  # between non-ancestor dofs
  return qderiv * smooth.chain_pattern(m)


def _actuator_input(m: Model, d: Data) -> torch.Tensor:
  """(B, nu) each actuator's input without actearly: its last activation
  where it has an activation state, else its ctrl (unclamped, as mjtpu's
  derivative reads it)."""
  if not m.na:
    return d.ctrl
  stateful, last, _ = support.act_input(m)
  return torch.where(stateful, d.act[:, last], d.ctrl)
