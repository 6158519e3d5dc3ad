"""Fluid forces and gravity compensation (mjtpu_torch/_src/passive.py and
fwd_actuation's actuator channel) against mjtpu at float64 on the CPU.

  * the fluid scene bundle (fluid_scenes.npz, fluid_scenes_golden.npz,
    scripts/torch_port_assets.py): tests/test_fluid.py's mixed model
    (ellipsoid-model geoms of five types, one body on the box model, wind,
    viscosity, density), two trees with bodies at gravcomp 0.5 and 1 and
    joints with actuatorgravcomp, with and without actuators (nu = 0 is
    fwd_actuation's early return), and the box model alone with wind and
    gravcomp.  Step 1's qfrc_fluid, qfrc_gravcomp, qfrc_passive and
    qfrc_actuator to 1e-12 of each field's scale, 100 Euler steps of qpos
    and qvel to 1e-8, from mjtpu's states;
  * qfrc_gravcomp against MuJoCo C (mjtpu has no gravcomp test of its own
    against C) to 1e-10;
  * put_model takes fluid and gravcomp under Euler and RK4, and since the
    Implicit slice under ImplicitFast and Implicit (the fluid forces'
    velocity derivative, held to mjtpu by tests/test_torch_implicit.py);
  * ant_bench with the constraints disabled (ROADMAP C8) against MuJoCo C
    over 20 steps: mjtpu raises there, so C is the oracle.
"""

import jax
import mujoco
import numpy as np
import pytest
import torch

import mjtpu
import mjtpu_torch
from mjtpu_torch._src import io
from mjtpu_torch._src.types import DisableBit, IntegratorType
from tests.test_torch_assets import _assets_script

torch.set_num_threads(1)

SCENES = mjtpu_torch.ASSETS / "fluid_scenes.npz"
GOLDEN = mjtpu_torch.ASSETS / "fluid_scenes_golden.npz"
NAMES = ("box_wind", "gravcomp", "gravcomp_noact", "mixed")
FORCES = ("qfrc_fluid", "qfrc_gravcomp", "qfrc_passive", "qfrc_actuator")
FORCE_BOUND = 1e-12
TRAJECTORY_BOUND = 1e-8
C_BOUND = 1e-10  # gravcomp against MuJoCo C
C8_STEPS = 20
C8_BOUND = 1e-8


@pytest.fixture(scope="module")
def golden():
  return dict(np.load(GOLDEN))


def _scene(name, golden):
  m = mjtpu_torch.model_from_arrays(io.load_snapshot(SCENES, name), device="cpu")
  d = mjtpu_torch.make_data(m, batch_size=golden[f"{name}.qpos0"].shape[0])
  return m, mjtpu_torch.replace(d, **{k: torch.as_tensor(golden[f"{name}.{k}0"])
                                      for k in ("qpos", "qvel", "ctrl")})


def test_bundle_holds_the_scenes():
  assert tuple(io.bundle_names(SCENES)) == NAMES
  assert tuple(sorted(_assets_script().fluid_scene_xmls())) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_step1_forces_match_mjtpu(golden, name):
  """The forward pass at the golden's states: the passive and actuator
  forces, each to 1e-12 of its scale (max |mjtpu's|, at least 1); each
  scene exercises what it was built for."""
  m, d = _scene(name, golden)
  d = mjtpu_torch.forward(m, d)
  for f in FORCES:
    want = golden[f"{name}.fwd.{f}"]
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(getattr(d, f).numpy() - want).max())
    assert err <= FORCE_BOUND * scale, f"{name} {f}: {err:.3e} (scale {scale:.3g})"
  fluid = np.abs(golden[f"{name}.fwd.qfrc_fluid"]).max()
  gravcomp = np.abs(golden[f"{name}.fwd.qfrc_gravcomp"]).max()
  assert (fluid > 0.1) == (name in ("box_wind", "mixed"))
  assert (gravcomp > 1.0) == (name != "mixed")
  assert m.opt.has_fluid_params == (name in ("box_wind", "mixed"))
  assert len(m.geom_fluid_np) == m.ngeom
  if name.startswith("gravcomp"):
    # the actuator channel carries the gravcomp of the actgravcomp dofs
    actgrav = np.asarray(m.jnt_actgravcomp)[np.asarray(m.dof_jntid)]
    assert actgrav.sum() == 2 and m.nu == (2 if name == "gravcomp" else 0)
    assert np.abs(d.qfrc_actuator.numpy()[:, actgrav]).min() > 0


@pytest.mark.parametrize("name", NAMES)
def test_trajectory_matches_mjtpu(golden, name):
  m, d = _scene(name, golden)
  steps = golden[f"{name}.qpos"].shape[0]
  err = 0.0
  for t in range(steps):
    d = mjtpu_torch.step(m, d)
    for f in ("qpos", "qvel"):
      err = max(err, float(np.abs(getattr(d, f).numpy() - golden[f"{name}.{f}"][t]).max()))
  assert steps == 100 and err <= TRAJECTORY_BOUND, err


def test_gravcomp_matches_mujoco_c(golden):
  """qfrc_gravcomp of the gravcomp scene at the golden's 4 states against
  MuJoCo C's mj_forward."""
  name = "gravcomp"
  mjm = mujoco.MjModel.from_xml_string(_assets_script().GRAVCOMP_XML)
  m, d = _scene(name, golden)
  got = mjtpu_torch.forward(m, d).qfrc_gravcomp.numpy()
  mjd = mujoco.MjData(mjm)
  for e in range(got.shape[0]):
    mjd.qpos[:], mjd.qvel[:] = golden[f"{name}.qpos0"][e], golden[f"{name}.qvel0"][e]
    mjd.ctrl[:] = golden[f"{name}.ctrl0"][e]
    mujoco.mj_forward(mjm, mjd)
    assert np.abs(mjd.qfrc_gravcomp).max() > 1.0
    np.testing.assert_allclose(got[e], mjd.qfrc_gravcomp, rtol=0, atol=C_BOUND)


def _mixed(integrator):
  from tests.test_fluid import MIXED_XML

  mjm = mujoco.MjModel.from_xml_string(MIXED_XML)
  mjm.opt.integrator = integrator
  return mjm


@pytest.mark.parametrize("integrator", [IntegratorType.EULER, IntegratorType.RK4],
                         ids=["euler", "rk4"])
def test_fluid_and_gravcomp_accepted(integrator):
  mjm = _mixed(integrator)
  mjm.body_gravcomp[1] = 0.5
  m = mjtpu_torch.put_model(mjm, device="cpu")
  assert m.has_gravcomp and m.opt.has_fluid_params
  d = mjtpu_torch.step(m, mjtpu_torch.make_data(m, batch_size=2))
  assert bool(torch.isfinite(d.qpos).all()) and float(d.qfrc_fluid.abs().max()) > 0


@pytest.mark.parametrize("integrator", [IntegratorType.IMPLICITFAST, IntegratorType.IMPLICIT],
                         ids=["implicitfast", "implicit"])
def test_fluid_refused_under_implicit_integrators(integrator):
  """Fluid forces under ImplicitFast and Implicit, refused until the
  Implicit slice brought their velocity derivative, build and step from a
  moving state (at rest the ellipsoid model's angular drag has a NaN
  derivative in mjtpu and the port alike, ROADMAP C15)."""
  m = mjtpu_torch.put_model(_mixed(integrator), device="cpu")
  d = mjtpu_torch.make_data(m, batch_size=2)
  qvel = np.random.default_rng(0).uniform(-1.0, 1.0, (2, m.nv))
  d = mjtpu_torch.step(m, mjtpu_torch.replace(d, qvel=torch.as_tensor(qvel)))
  assert bool(torch.isfinite(d.qpos).all() & torch.isfinite(d.qvel).all())
  assert int(d.nreset.sum()) == 0 and float(d.qfrc_fluid.abs().max()) > 0


def test_constraint_disabled_matches_mujoco_c():
  """ant_bench with DisableBit.CONSTRAINT (ROADMAP C8): mjtpu raises an
  IndexError reading the contact forces that its sensors need (nefc = 0),
  so MuJoCo C is the oracle: no contact, touch readings 0.  20 steps from
  the ant golden's states, qpos and qvel to 1e-8, sensordata to 1e-8 of
  each sensor's scale."""
  script = _assets_script()
  ant = dict(np.load(script.ANT_GOLDEN_FILE))
  mjm = script.load_ant_mjmodel()
  mjm.opt.disableflags |= int(DisableBit.CONSTRAINT)
  m_j = mjtpu.put_model(mjm)
  with pytest.raises(IndexError):
    jax.eval_shape(mjtpu.step, m_j, mjtpu.make_data(m_j))

  m = mjtpu_torch.put_model(mjm, device="cpu")
  batch = ant["qpos0"].shape[0]
  d = mjtpu_torch.make_data(m, batch_size=batch)
  d = mjtpu_torch.replace(d, qpos=torch.as_tensor(ant["qpos0"]),
                          qvel=torch.as_tensor(ant["qvel0"]), ctrl=torch.as_tensor(ant["ctrl"]))
  want = {f: np.zeros((C8_STEPS, batch, n)) for f, n in (
      ("qpos", mjm.nq), ("qvel", mjm.nv), ("sensordata", mjm.nsensordata))}
  mjd = mujoco.MjData(mjm)
  for e in range(batch):
    mujoco.mj_resetData(mjm, mjd)
    mjd.qpos[:], mjd.qvel[:], mjd.ctrl[:] = ant["qpos0"][e], ant["qvel0"][e], ant["ctrl"][e]
    for t in range(C8_STEPS):
      mujoco.mj_step(mjm, mjd)
      assert mjd.ncon == 0 and mjd.nefc == 0
      for f in want:
        want[f][t, e] = getattr(mjd, f)
  touch = np.asarray(m.sensor_type) == int(mujoco.mjtSensor.mjSENS_TOUCH)
  cols = np.concatenate([np.arange(a, a + n) for a, n in zip(
      np.asarray(m.sensor_adr)[touch], np.asarray(m.sensor_dim)[touch])])
  top = np.abs(want["sensordata"]).max(axis=(0, 1))
  scale = np.concatenate([np.full(int(n), max(1.0, float(top[a:a + n].max())))
                          for a, n in zip(np.asarray(m.sensor_adr), np.asarray(m.sensor_dim))])
  err = dict.fromkeys(want, 0.0)
  for t in range(C8_STEPS):
    d = mjtpu_torch.step(m, d)
    assert not d.sensordata[:, cols].any(), f"step {t + 1}: a touch reading is not 0"
    for f in ("qpos", "qvel"):
      err[f] = max(err[f], float(np.abs(getattr(d, f).numpy() - want[f][t]).max()))
    err["sensordata"] = max(err["sensordata"], float(
        (np.abs(d.sensordata.numpy() - want["sensordata"][t]) / scale).max()))
  assert len(cols) == 9 and max(err.values()) <= C8_BOUND, err
