"""Forward dynamics orchestration + the Euler, implicit and RK4 integrators.

Port of mjtpu/_src/forward.py: _check_state, the fwd_* stages (tendons,
actuator activation dynamics and muscles included; the energy under
EnableBit.ENERGY), forward with the three sensor stages, _advance (the
exact filter update, the activation clamp), euler (with implicit joint
damping), implicit (ImplicitFast and the full Implicit integrator),
rungekutta4 and step, batch-explicit over B envs.
"""

from __future__ import annotations

import numpy as np
import torch

from mjtpu_torch._src import (
    collision_driver,
    constraint,
    derivative,
    math,
    passive as passive_mod,
    scan,
    sensor,
    smooth,
    solver,
    support,
)
from mjtpu_torch._src.dataclasses import replace
from mjtpu_torch._src.diff_config import get_diff_config
from mjtpu_torch._src.types import (
    BiasType,
    Data,
    DisableBit,
    DynType,
    EnableBit,
    GainType,
    IntegratorType,
    JointType,
    MAXVAL,
    Model,
    cached,
    derived,
    replace_fields,
    rows as env_rows,
)


def _check_state(m: Model, d: Data) -> Data:
  """Resets envs whose state is non-finite or diverged (mj_checkPos/Vel
  semantics) and counts each reset in ``nreset``."""
  bad = lambda x: torch.any(~torch.isfinite(x) | (torch.abs(x) > MAXVAL), dim=-1)
  reset = bad(d.qpos) | bad(d.qvel)
  r = reset[:, None]
  return replace(
      d,
      qpos=torch.where(r, env_rows(m, "qpos0"), d.qpos),
      qvel=torch.where(r, 0.0, d.qvel),
      qacc=torch.where(r, 0.0, d.qacc),
      qacc_warmstart=torch.where(r, 0.0, d.qacc_warmstart),
      nreset=d.nreset + reset.to(d.nreset.dtype),
  )


def fwd_position(m: Model, d: Data) -> Data:
  """Position-dependent computations (mj_fwdPosition)."""
  d = smooth.kinematics(m, d)
  d = smooth.com_pos(m, d)
  d = smooth.camlight(m, d)
  d = smooth.tendon(m, d)
  d = smooth.crb(m, d)
  if m.has_tendon_armature:
    d = smooth.tendon_armature(m, d)
  d = smooth.factor_m(m, d)
  d = collision_driver.collision(m, d)
  d = constraint.make_constraint(m, d)
  d = smooth.transmission(m, d)
  if m.opt.enableflags & EnableBit.ENERGY:
    d = smooth.energy_pos(m, d)
  return d


def fwd_velocity(m: Model, d: Data) -> Data:
  """Velocity-dependent computations (mj_fwdVelocity)."""
  actuator_velocity = torch.einsum("buv,bv->bu", d.actuator_moment, d.qvel)
  d = replace(d, actuator_velocity=actuator_velocity)
  if m.ntendon:
    d = replace(d, ten_velocity=torch.einsum("btv,bv->bt", d.ten_J, d.qvel))
  d = smooth.com_vel(m, d)
  d = passive_mod.passive(m, d)
  d = smooth.rne(m, d)
  if m.opt.enableflags & EnableBit.ENERGY:
    d = smooth.energy_vel(m, d)
  return d


def fwd_actuation(m: Model, d: Data) -> Data:
  """Actuator forces and activation derivatives (mj_fwdActuation): ctrl
  clamped; act_dot of the integrator, filter, filterexact and muscle
  dynamics; each actuator's input its last activation (one step ahead
  with actearly) where it has one, else its ctrl; fixed, affine and
  muscle gains, no, affine and muscle biases."""
  if not m.nu or (m.opt.disableflags & DisableBit.ACTUATION):
    return replace(d, act_dot=torch.zeros_like(d.act), actuator_force=torch.zeros_like(d.ctrl),
                   qfrc_actuator=_actgravcomp(m, d, torch.zeros_like(d.qvel)))

  c = cached(m, "forward.actuation", lambda: _actuation_tables(m))
  ctrl = d.ctrl
  if not (m.opt.disableflags & DisableBit.CLAMPCTRL):
    ctrlrange = env_rows(m, "actuator_ctrlrange")
    clamped = torch.minimum(torch.maximum(ctrl, ctrlrange[..., 0]), ctrlrange[..., 1])
    ctrl = torch.where(c["ctrllimited"], clamped, ctrl)

  act_dot = torch.zeros_like(d.act)
  dynprm = env_rows(m, "actuator_dynprm")
  for dyn, ids, slots in c["dyn"]:
    if dyn == DynType.INTEGRATOR:
      val = ctrl[:, ids]
    elif dyn in (DynType.FILTER, DynType.FILTEREXACT):
      val = (ctrl[:, ids] - d.act[:, slots]) / torch.clamp_min(dynprm[:, ids, 0], math.MINVAL)
    else:  # MUSCLE
      val = support.muscle_dynamics(ctrl[:, ids], d.act[:, slots], dynprm[:, ids])
    act_dot[:, slots] = val

  ainput = ctrl
  if m.na:
    stateful, last, early = support.act_input(m)
    act_in = d.act[:, last]
    if early is not None:
      h = env_rows(m, "opt.timestep")[:, None]
      act_in = torch.where(early, act_in + h * act_dot[:, last], act_in)
    ainput = torch.where(stateful, act_in, ctrl)

  gain, bias = torch.zeros_like(ctrl), torch.zeros_like(ctrl)
  gainprm, biasprm = env_rows(m, "actuator_gainprm"), env_rows(m, "actuator_biasprm")
  acc0, lengthrange = env_rows(m, "actuator_acc0"), env_rows(m, "actuator_lengthrange")
  if c["fixed"] is not None:
    gain[:, c["fixed"]] = gainprm[:, c["fixed"], 0]
  for out, ids, prm in ((gain, c["affine_gain"], gainprm), (bias, c["affine_bias"], biasprm)):
    if ids is not None:
      out[:, ids] = (prm[:, ids, 0] + prm[:, ids, 1] * d.actuator_length[:, ids]
                     + prm[:, ids, 2] * d.actuator_velocity[:, ids])
  ids = c["muscle_gain"]
  if ids is not None:
    gain[:, ids] = support.muscle_gain(
        d.actuator_length[:, ids], d.actuator_velocity[:, ids], lengthrange[:, ids],
        acc0[:, ids], gainprm[:, ids])
  ids = c["muscle_bias"]
  if ids is not None:
    bias[:, ids] = support.muscle_bias(d.actuator_length[:, ids], lengthrange[:, ids],
                                       acc0[:, ids], biasprm[:, ids])

  force = gain * ainput + bias
  if c["forcelimited"] is not None:
    forcerange = env_rows(m, "actuator_forcerange")
    clamped = torch.minimum(torch.maximum(force, forcerange[..., 0]), forcerange[..., 1])
    force = torch.where(c["forcelimited"], clamped, force)

  qfrc_actuator = _actgravcomp(m, d, torch.einsum("buv,bu->bv", d.actuator_moment, force))

  # clamp per-dof actuator force (jnt_actfrcrange)
  if c["actfrclimited"] is not None:
    rng = env_rows(m, "jnt_actfrcrange")[:, c["dof_jnt"]]
    lo, hi = rng[..., 0], rng[..., 1]
    clamped = torch.minimum(torch.maximum(qfrc_actuator, lo), hi)
    qfrc_actuator = torch.where(c["actfrclimited"], clamped, qfrc_actuator)
  return replace(d, act_dot=act_dot, actuator_force=force, qfrc_actuator=qfrc_actuator)


def _actgravcomp(m: Model, d: Data, qfrc: torch.Tensor) -> torch.Tensor:
  """qfrc plus the gravity compensation of the dofs whose joint routes it
  through the actuators (jnt_actgravcomp; passive leaves it out of
  qfrc_passive)."""
  if not m.has_gravcomp:
    return qfrc
  return qfrc + torch.where(passive_mod.actgrav_dofs(m), d.qfrc_gravcomp, 0.0)


def _actuation_tables(m: Model) -> dict:
  """Static actuator masks and index groups as device tensors (None where
  a group is empty)."""
  dev = m.device
  mask = lambda x: torch.as_tensor(np.asarray(x, dtype=bool), device=dev) if np.any(x) else None
  ids = lambda sel: torch.as_tensor(np.nonzero(sel)[0], device=dev) if np.any(sel) else None
  dof_jnt = np.asarray(m.dof_jntid)
  # each dyntype's actuators and their last activation slots
  last = np.asarray(m.actuator_actadr) + np.asarray(m.actuator_actnum) - 1
  dyntype = np.asarray(m.actuator_dyntype)
  long = lambda x: torch.as_tensor(np.asarray(x, dtype=np.int64), device=dev)
  dyn = [(kind, long(np.nonzero(dyntype == kind)[0]), long(last[dyntype == kind]))
         for kind in (DynType.INTEGRATOR, DynType.FILTER, DynType.FILTEREXACT, DynType.MUSCLE)
         if np.any(dyntype == kind)]
  return dict(
      ctrllimited=torch.as_tensor(np.asarray(m.actuator_ctrllimited, dtype=bool), device=dev),
      dyn=dyn,
      fixed=ids(np.asarray(m.actuator_gaintype) == GainType.FIXED),
      affine_gain=ids(np.asarray(m.actuator_gaintype) == GainType.AFFINE),
      affine_bias=ids(np.asarray(m.actuator_biastype) == BiasType.AFFINE),
      muscle_gain=ids(np.asarray(m.actuator_gaintype) == GainType.MUSCLE),
      muscle_bias=ids(np.asarray(m.actuator_biastype) == BiasType.MUSCLE),
      forcelimited=mask(m.actuator_forcelimited),
      actfrclimited=mask(np.asarray(m.jnt_actfrclimited, dtype=bool)[dof_jnt]),
      dof_jnt=long(dof_jnt),
  )


def fwd_acceleration(m: Model, d: Data) -> Data:
  """Smooth (unconstrained) acceleration (mj_fwdAcceleration)."""
  qfrc_applied = d.qfrc_applied + support.xfrc_accumulate(m, d)
  qfrc_smooth = d.qfrc_passive - d.qfrc_bias + d.qfrc_actuator + qfrc_applied
  qacc_smooth = smooth.solve_m(m, d, qfrc_smooth)
  return replace(d, qfrc_smooth=qfrc_smooth, qacc_smooth=qacc_smooth)


def forward(m: Model, d: Data, fixed_iterations: bool = False) -> Data:
  """Full forward dynamics (mj_forward), with the sensor stages after
  the position, velocity and acceleration stages as in mjtpu;
  ``fixed_iterations`` runs the solver's loops to their bounds (as it
  does under differentiable mode)."""
  d = fwd_position(m, d)
  d = sensor.sensor_pos(m, d)
  d = fwd_velocity(m, d)
  d = sensor.sensor_vel(m, d)
  d = fwd_actuation(m, d)
  d = fwd_acceleration(m, d)
  _, _, _, nefc = support.count_constraints(m)
  if nefc == 0:
    d = replace(d, qacc=d.qacc_smooth, qacc_warmstart=d.qacc_smooth)
  else:
    d = solver.solve(m, d, fixed_iterations=fixed_iterations)
  return sensor.sensor_acc(m, d)


def _integrate_pos(m: Model, qpos: torch.Tensor, qvel: torch.Tensor,
                   dt: torch.Tensor) -> torch.Tensor:
  """qpos integrated by qvel over dt (E,), quaternion-correct
  (mj_integratePos)."""
  # the scan's entities reach fn as (B, k, width)
  dt_q, dt = dt.reshape(-1, 1), dt.reshape(-1, 1, 1)

  def fn(jnt_types, qpos, qvel_b):
    out = []
    qi = vi = 0
    for jt in jnt_types:
      jt = JointType(int(jt))
      if jt == JointType.FREE:
        out.append(qpos[..., qi : qi + 3] + dt * qvel_b[..., vi : vi + 3])
        out.append(
            math.quat_integrate(qpos[..., qi + 3 : qi + 7], qvel_b[..., vi + 3 : vi + 6], dt_q))
        qi, vi = qi + 7, vi + 6
      elif jt == JointType.BALL:
        out.append(math.quat_integrate(qpos[..., qi : qi + 4], qvel_b[..., vi : vi + 3], dt_q))
        qi, vi = qi + 4, vi + 3
      else:
        out.append(qpos[..., qi : qi + 1] + dt * qvel_b[..., vi : vi + 1])
        qi, vi = qi + 1, vi + 1
    if not out:
      return qpos.new_zeros(qpos.shape[:-1] + (0,))
    return torch.cat(out, dim=-1)

  out = scan.flat(m, fn, "jqv", "q", np.asarray(m.jnt_type), qpos, qvel)
  return qpos if out is None else out


def _act_tables(m: Model) -> dict:
  """The activation update's static tables: the filterexact actuators
  (ids, their last activation slots) and, over the activation slots, the
  actlimited mask and ranges; None where a group is empty."""
  dev = m.device
  actadr, actnum = np.asarray(m.actuator_actadr), np.asarray(m.actuator_actnum)
  exact = np.nonzero(np.asarray(m.actuator_dyntype) == DynType.FILTEREXACT)[0]
  limited = np.nonzero(np.asarray(m.actuator_actlimited, dtype=bool) & (actadr >= 0))[0]
  out = {"exact": None, "limited": None}
  if len(exact):
    out["exact"] = (torch.as_tensor(exact, device=dev),
                    torch.as_tensor((actadr + actnum - 1)[exact], device=dev))
  if len(limited):
    owner = np.full(m.na, -1)
    for u in limited:
      owner[actadr[u] : actadr[u] + actnum[u]] = u
    out["limited"] = (torch.as_tensor(owner >= 0, device=dev),
                      torch.as_tensor(np.maximum(owner, 0), device=dev))
  return out


def _act_ranges(m: Model, owner: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
  """(lower, upper) activation ranges over the activation slots, from
  their owners ``owner`` (na,), with the env axis of env_rows: (E, na)."""
  rows = env_rows(m, "actuator_actrange")[:, owner]
  return rows[..., 0], rows[..., 1]


def _advance(m: Model, d: Data, act_dot: torch.Tensor, qacc: torch.Tensor,
             qvel: torch.Tensor | None = None) -> Data:
  """Integrates state with the semi-implicit update (mj_advance).  The
  velocity state always takes qvel + h * qacc; ``qvel`` (RK4's combined
  velocity) overrides only the velocity the position update uses.  The
  activations integrate linearly, filterexact ones exactly, and clamp to
  their range where actlimited."""
  h = env_rows(m, "opt.timestep")
  act = d.act
  if m.na:
    c = cached(m, "forward.act", lambda: _act_tables(m))
    act = act + act_dot * h[:, None]
    if c["exact"] is not None:
      ids, slots = c["exact"]
      tau = torch.clamp_min(env_rows(m, "actuator_dynprm")[:, ids, 0], math.MINVAL)
      act[:, slots] = (d.act[:, slots]
                       + act_dot[:, slots] * tau * (1.0 - torch.exp(-h[:, None] / tau)))
    if c["limited"] is not None:
      limited, owner = c["limited"]
      lo, hi = cached(m, "forward.act_ranges", lambda: _act_ranges(m, owner), live=True)
      act = torch.where(limited, torch.minimum(torch.maximum(act, lo), hi), act)
  qvel_state = d.qvel + qacc * h[:, None]
  qpos = _integrate_pos(m, d.qpos, qvel_state if qvel is None else qvel, h)
  return replace(d, act=act, qpos=qpos, qvel=qvel_state, qacc=qacc, time=d.time + h)


def euler(m: Model, d: Data) -> Data:
  """Semi-implicit Euler with implicit joint damping (mj_Euler): with dof
  damping, unless EULERDAMP or DAMPER is disabled, qacc solves
  (qM + h * diag(dof_damping)) qacc = qfrc_smooth + qfrc_constraint
  through the symmetric factor_solve."""
  qacc = d.qacc
  if (m.has_dof_damping and not (m.opt.disableflags & DisableBit.EULERDAMP)
      and not (m.opt.disableflags & DisableBit.DAMPER)):
    mh = d.qM + (env_rows(m, "opt.timestep")[:, None, None]
                 * torch.diag_embed(env_rows(m, "dof_damping")))
    qfrc = d.qfrc_smooth + d.qfrc_constraint
    qacc = smooth.factor_solve(m, mh, qfrc)
  return _advance(m, d, d.act_dot, qacc)


def implicit(m: Model, d: Data) -> Data:
  """The implicit-in-velocity integrators (mj_implicit): the velocity
  update solves (qM - h * qDeriv) qacc = qfrc_smooth + qfrc_constraint by
  the batched LU of factor_solve (blocked per tree on a forest).  The full
  Implicit integrator's qDeriv holds the RNE derivative and is not
  symmetric; ImplicitFast's leaves it out and symmetrizes qDeriv, as C's
  ImplicitFast does."""
  full = m.opt.integrator == IntegratorType.IMPLICIT
  qderiv = derivative.deriv_smooth_vel(m, d, rne=full)
  if not full:
    qderiv = 0.5 * (qderiv + qderiv.transpose(-1, -2))
  mh = d.qM - env_rows(m, "opt.timestep")[:, None, None] * qderiv
  qfrc = d.qfrc_smooth + d.qfrc_constraint
  qacc = smooth.factor_solve(m, mh, qfrc, symmetric=False)
  return _advance(m, d, d.act_dot, qacc)


# RK4's tableau (mj_RungeKutta): each stage's step fraction and the
# combination weights of the four passes
RK4_A = (0.5, 0.5, 1.0)
RK4_B = (1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0)


def rungekutta4(m: Model, d: Data) -> Data:
  """4th-order Runge-Kutta (mj_RungeKutta) from ``d`` after its forward:
  three more forward passes at the stage states X_i = X_0 + h a_i F_{i-1},
  each warm-started from the previous pass's solve (the stage Data is
  carried), then one advance from X_0 by the B-weighted passes.  The last
  pass's derived fields stay; qpos, qvel, act and time come from X_0."""
  h = env_rows(m, "opt.timestep")
  qpos0, qvel0, act0, time0 = d.qpos, d.qvel, d.act, d.time
  qvels, qaccs, act_dots = [qvel0], [d.qacc], [d.act_dot]
  dd = d
  for a in RK4_A:
    ha = h * a  # at the state's dtype, as mjtpu scans the tableau
    qvel_i = qvel0 + ha[:, None] * qaccs[-1]
    act_i = act0 + ha[:, None] * act_dots[-1]
    dd = replace(dd, qpos=_integrate_pos(m, qpos0, qvels[-1], ha), qvel=qvel_i, act=act_i,
                 time=time0 + ha)
    dd = forward(m, dd)
    qvels.append(dd.qvel)
    qaccs.append(dd.qacc)
    act_dots.append(dd.act_dot)
  # left to right from the first pass's term, as mjtpu sums them
  qvel_comb = sum(b * v for b, v in zip(RK4_B, qvels))
  qacc_comb = sum(b * v for b, v in zip(RK4_B, qaccs))
  act_dot_comb = sum(b * v for b, v in zip(RK4_B, act_dots))
  dd = replace(dd, qpos=qpos0, qvel=qvel0, act=act0, time=time0)
  return _advance(m, dd, act_dot_comb, qacc_comb, qvel=qvel_comb)


def _single_step(m: Model, d: Data, fixed_iterations: bool) -> Data:
  d = _check_state(m, d)
  d = forward(m, d, fixed_iterations=fixed_iterations)
  if m.opt.integrator in (IntegratorType.IMPLICITFAST, IntegratorType.IMPLICIT):
    return implicit(m, d)
  if m.opt.integrator == IntegratorType.RK4:
    return rungekutta4(m, d)
  return euler(m, d)


def step(m: Model, d: Data, fixed_iterations: bool = False) -> Data:
  """Advances every env one timestep (mj_step).

  Under ``differentiable_mode()`` the solver runs its fixed iteration
  counts and, with ``adaptive_integration``, the step splits into
  ``adaptive_substeps`` equal substeps of timestep / n (each env's own
  timestep where the model holds one per env)."""
  cfg = get_diff_config()
  if cfg is not None and cfg.adaptive_integration and cfg.adaptive_substeps > 1:
    n = cfg.adaptive_substeps
    m_sub = derived(m, ("forward.substep", n), lambda: replace_fields(
        m, {"opt.timestep": m.opt.timestep / n}))
    for _ in range(n):
      d = _single_step(m_sub, d, fixed_iterations)
    return d
  return _single_step(m, d, fixed_iterations)
