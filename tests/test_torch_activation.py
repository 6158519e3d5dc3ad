"""Activation dynamics and muscles (support.muscle_*, forward.fwd_actuation
and _advance, derivative.deriv_smooth_vel's activation input) against
mjtpu and MuJoCo C at float64 on the CPU.

  * the muscle curves (gain, bias, dynamics) on tests/test_support.py::
    test_muscle_curves's grid against mjtpu's support.muscle_* and MuJoCo
    C's mju_muscleGain/Bias/Dynamics, to 1e-12 of scale;
  * muscle.xml (muscles on fixed tendons, integrator, filter and
    filterexact dynamics, an actlimited integrator) from seeded states
    past the activation ranges, under Euler and RK4, against MuJoCo C:
    act_dot, actuator_force and qfrc_actuator to 1e-12 of scale, 20 steps
    of qpos, qvel and act to 1e-10;
  * the same model with actearly on every actuator, an affine gain on the
    filter actuator and tendon damping, under ImplicitFast, against mjtpu
    (jit(vmap(step))): step 1's activation and actuator fields to 1e-12 of
    scale, 5 steps to 1e-10; and where mjtpu parts from MuJoCo C
    (ROADMAP C9): actearly's activation is one linear step for a
    filterexact actuator and is not clamped to an actlimited range.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import chip_smoke
import mjtpu
import mjtpu_torch
from mjtpu._src import support as j_support
from mjtpu_torch._src import support
from mjtpu_torch._src.types import DynType, GainType
from tests.conftest import load_mj

torch.set_num_threads(1)

CURVE_BOUND = 1e-12
FORCE_BOUND = 1e-12
TRAJECTORY_BOUND = 1e-10
C_STEPS = 20
MJTPU_STEPS = 5
BATCH = 4

# tests/test_support.py::test_muscle_curves's grid
PRM = np.array([0.75, 1.05, -1.0, 200.0, 0.5, 1.6, 1.5, 1.3, 1.2])
LENGTHRANGE = np.array([0.2, 0.6])
ACC0 = 20.0
DYN_PRMS = (np.array([0.01, 0.04, 0.0]), np.array([0.01, 0.04, 0.2]))


def _close(got, want, what):
  err = chip_smoke._scaled_err(np.asarray(got), np.asarray(want))
  assert err <= CURVE_BOUND, f"{what}: {err:.3e}"


def test_muscle_gain_and_bias_match_mjtpu_and_c():
  length, vel = (g.reshape(-1) for g in np.meshgrid(np.linspace(0.15, 0.7, 12),
                                                     np.linspace(-1.0, 1.0, 7), indexing="ij"))
  t = lambda x: torch.as_tensor(x)
  gain = support.muscle_gain(t(length), t(vel), t(LENGTHRANGE), t(ACC0), t(PRM)).numpy()
  bias = support.muscle_bias(t(length), t(LENGTHRANGE), t(ACC0), t(PRM)).numpy()
  j = lambda x: jnp.asarray(x)
  _close(gain, j_support.muscle_gain(j(length), j(vel), j(LENGTHRANGE), ACC0, j(PRM)), "gain/mjtpu")
  _close(bias, j_support.muscle_bias(j(length), j(LENGTHRANGE), ACC0, j(PRM)), "bias/mjtpu")
  _close(gain, [mujoco.mju_muscleGain(a, b, LENGTHRANGE, ACC0, PRM) for a, b in zip(length, vel)],
         "gain/C")
  _close(bias, [mujoco.mju_muscleBias(a, LENGTHRANGE, ACC0, PRM) for a in length], "bias/C")
  assert np.abs(gain).max() > 1.0 and np.abs(bias).max() > 1.0


@pytest.mark.parametrize("prm", DYN_PRMS, ids=["hard", "smooth"])
def test_muscle_dynamics_match_mjtpu_and_c(prm):
  ctrl, act = (g.reshape(-1) for g in np.meshgrid(np.linspace(-0.2, 1.2, 8),
                                                   np.linspace(0.0, 1.0, 5), indexing="ij"))
  got = support.muscle_dynamics(torch.as_tensor(ctrl), torch.as_tensor(act),
                                torch.as_tensor(prm)).numpy()
  _close(got, j_support.muscle_dynamics(jnp.asarray(ctrl), jnp.asarray(act), jnp.asarray(prm)),
         "dynamics/mjtpu")
  _close(got, [mujoco.mju_muscleDynamics(c, a, prm) for c, a in zip(ctrl, act)], "dynamics/C")


def _start(mjm, seed=0):
  """BATCH states with ctrl and act beyond their ranges."""
  rng = np.random.default_rng(seed)
  return {"qpos": mjm.qpos0[None] + rng.uniform(-0.3, 0.3, (BATCH, mjm.nq)),
          "qvel": rng.uniform(-0.5, 0.5, (BATCH, mjm.nv)),
          "ctrl": rng.uniform(-0.2, 1.2, (BATCH, mjm.nu)),
          "act": rng.uniform(-0.2, 1.2, (BATCH, mjm.na))}


def _port(mjm, start):
  m = mjtpu_torch.put_model(mjm, device="cpu")
  d = mjtpu_torch.make_data(m, batch_size=BATCH)
  return m, mjtpu_torch.replace(d, **{k: torch.as_tensor(v) for k, v in start.items()})


def _c_run(mjm, start, steps):
  """MuJoCo C env by env: the forward's fields, and the state after each step."""
  mjd = mujoco.MjData(mjm)
  fwd = {k: np.zeros((BATCH,) + getattr(mjd, k).shape)
         for k in ("act_dot", "actuator_force", "qfrc_actuator")}
  run = {k: np.zeros((steps, BATCH) + getattr(mjd, k).shape) for k in ("qpos", "qvel", "act")}
  for e in range(BATCH):
    mujoco.mj_resetData(mjm, mjd)
    for k, v in start.items():
      getattr(mjd, k)[:] = v[e]
    mujoco.mj_forward(mjm, mjd)
    for k in fwd:
      fwd[k][e] = getattr(mjd, k)
    for t in range(steps):
      mujoco.mj_step(mjm, mjd)
      for k in run:
        run[k][t, e] = getattr(mjd, k)
  return fwd, run


@pytest.mark.parametrize("integrator", ["EULER", "RK4"])
def test_activation_matches_mujoco_c(integrator):
  """muscle.xml: every dyntype, muscle gains and biases on fixed tendons,
  the filterexact update and the actlimited clamp, against MuJoCo C."""
  mjm = load_mj("muscle.xml")
  mjm.opt.integrator = getattr(mujoco.mjtIntegrator, f"mjINT_{integrator}")
  start = _start(mjm)
  want, run = _c_run(mjm, start, C_STEPS)
  m, d = _port(mjm, start)
  fwd = mjtpu_torch.forward(m, d)
  for k, v in want.items():
    err = chip_smoke._scaled_err(getattr(fwd, k).numpy(), v)
    assert err <= FORCE_BOUND, f"{k}: {err:.3e}"
  err = dict.fromkeys(run, 0.0)
  for t in range(C_STEPS):
    d = mjtpu_torch.step(m, d)
    for k in run:
      err[k] = max(err[k], float(np.abs(getattr(d, k).numpy() - run[k][t]).max()))
  assert max(err.values()) <= TRAJECTORY_BOUND, err
  # the actlimited integrator's activation reached its bound
  assert np.abs(run["act"][..., 4]).max() == 1.0


def test_actearly_affine_gain_implicitfast_match_mjtpu():
  """muscle.xml with actearly on every actuator, the filter actuator's
  gain affine in velocity (so ImplicitFast's derivative reads its
  activation) and tendon damping, under ImplicitFast: against mjtpu, and
  where mjtpu parts from MuJoCo C (ROADMAP C9)."""
  mjm = load_mj("muscle.xml")
  mjm.opt.integrator = mujoco.mjtIntegrator.mjINT_IMPLICITFAST
  mjm.actuator_actearly[:] = 1
  mjm.actuator_gaintype[2] = GainType.AFFINE
  mjm.actuator_gainprm[2, :3] = (40.0, 0.0, 0.5)
  mjm.tendon_damping[:] = 0.2
  start = _start(mjm, seed=1)
  # the actlimited integrator starts past its range, so C clamps it
  start["act"][:, mjm.actuator_actadr[4]] = 1.05

  jm = mjtpu.put_model(mjm, dtype=jnp.float64)
  jd = jax.vmap(lambda _: mjtpu.make_data(jm))(jnp.arange(BATCH))
  jd = jd.replace(**{k: jnp.asarray(v) for k, v in start.items()})
  step = jax.jit(jax.vmap(mjtpu.step, in_axes=(None, 0)))
  m, d = _port(mjm, start)
  assert m.has_tendon_damping and bool(np.asarray(m.actuator_actearly).all())
  for t in range(MJTPU_STEPS):
    jd, d = step(jm, jd), mjtpu_torch.step(m, d)
    fields = ("qpos", "qvel", "act") + (
        ("act_dot", "actuator_force", "qfrc_actuator") if t == 0 else ())
    for k in fields:
      err = chip_smoke._scaled_err(getattr(d, k).numpy(), np.asarray(getattr(jd, k)))
      assert err <= (FORCE_BOUND if t == 0 else TRAJECTORY_BOUND), f"step {t + 1} {k}: {err:.3e}"

  # MuJoCo C integrates the early activation as the step will (exactly for
  # filterexact, clamped where actlimited); mjtpu and the port take one
  # linear step, so those two actuators' forces part from C's
  want, _ = _c_run(mjm, start, 0)
  fwd = mjtpu_torch.forward(*_port(mjm, start)).actuator_force.numpy()
  err = np.abs(fwd - want["actuator_force"]).max(axis=0) / np.maximum(
      1.0, np.abs(want["actuator_force"]).max(axis=0))
  dyn = np.asarray(m.actuator_dyntype)
  apart = (dyn == DynType.FILTEREXACT) | np.asarray(m.actuator_actlimited, dtype=bool) & (
      dyn == DynType.INTEGRATOR)
  assert apart.tolist() == [False, False, False, True, True]
  assert err[~apart].max() <= FORCE_BOUND and err[apart].min() > 1e-6, err
