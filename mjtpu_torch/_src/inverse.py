"""Inverse dynamics (mj_inverse), batch-explicit.

Port of mjtpu/_src/inverse.py: the position and velocity stages with
their sensors, the undo of the integrator's discretization of qacc under
EnableBit.INVDISCRETE (discrete_acc), the constraint force from qacc by
the solver's own row costs (_inv_constraint), the acceleration sensors,
and qfrc_inverse.  The caller's qacc is restored on return.
"""

from __future__ import annotations

import torch

from mjtpu_torch._src import derivative, forward, sensor, smooth, solver, support
from mjtpu_torch._src.dataclasses import replace
from mjtpu_torch._src.types import (Data, DisableBit, EnableBit, IntegratorType, Model,
                                    rows as env_rows)


def _matvec(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
  return (a @ x[..., None])[..., 0]


def _inv_constraint(m: Model, d: Data) -> Data:
  """The constraint force of qacc by the dual active-set formula
  (mj_invConstraint): each row's force at Jaref = J qacc - aref, priced by
  its zone as the solver prices it."""
  _, _, _, nefc = support.count_constraints(m)
  if nefc == 0:
    return replace(d, qfrc_constraint=torch.zeros_like(d.qacc),
                   efc_force=d.qacc.new_zeros((d.batch_size, 0)))
  meta = solver._efc_meta(m)
  jaref = _matvec(d.efc_J, d.qacc) - d.efc_aref
  cones = solver._cones(meta, d.efc_D, d.contact.friction)
  force, _, _ = solver._row_costs(meta, cones, jaref, d.efc_D, d.efc_frictionloss)
  return replace(d, efc_force=force, qfrc_constraint=_matvec(d.efc_J.transpose(-1, -2), force))


def discrete_acc(m: Model, d: Data) -> torch.Tensor:
  """(B, nv) qacc with the integrator's discretization undone
  (mj_invDiscrete): Euler's implicit damping, and ImplicitFast's and
  Implicit's velocity derivative (the smooth one for both, as mjtpu and C
  take it); RK4 has no inverse."""
  qacc = d.qacc
  h = env_rows(m, "opt.timestep")[:, None]
  if m.opt.integrator == IntegratorType.RK4:
    raise NotImplementedError("discrete inverse with RK4")
  if m.opt.integrator == IntegratorType.EULER:
    if m.has_dof_damping and not (m.opt.disableflags & DisableBit.EULERDAMP):
      # qacc solves (M + h diag(B)) qacc = qfrc: M qacc = qfrc - h B qacc
      qfrc = _matvec(d.qM, qacc) + h * env_rows(m, "dof_damping") * qacc
      qacc = smooth.solve_m(m, d, qfrc)
  else:  # IMPLICITFAST, IMPLICIT
    qderiv = derivative.deriv_smooth_vel(m, d)
    qfrc = _matvec(d.qM, qacc) - h * _matvec(qderiv, qacc)
    qacc = smooth.solve_m(m, d, qfrc)
  return qacc


def inverse(m: Model, d: Data) -> Data:
  """Inverse dynamics (mj_inverse): from (qpos, qvel, qacc), qfrc_inverse,
  the applied generalized force that gives qacc."""
  d = forward.fwd_position(m, d)
  d = sensor.sensor_pos(m, d)
  d = forward.fwd_velocity(m, d)
  d = sensor.sensor_vel(m, d)

  qacc_in = d.qacc
  if m.opt.enableflags & EnableBit.INVDISCRETE:
    # the constraint force, the acceleration sensors and qfrc_inverse all
    # see the continuous-time qacc
    d = replace(d, qacc=discrete_acc(m, d))

  d = _inv_constraint(m, d)
  d = sensor.sensor_acc(m, d)
  qfrc_inverse = d.qfrc_bias + _matvec(d.qM, d.qacc) - d.qfrc_passive - d.qfrc_constraint
  return replace(d, qfrc_inverse=qfrc_inverse, qacc=qacc_in)
