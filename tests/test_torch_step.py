"""mjtpu_torch.step against mjtpu's jit(vmap(step)) at float64 on the CPU:
humanoid_bench, B=4, from the committed initial states.

The benchmark configuration (iterations=1, ls_iterations=4) truncates the
Newton solve, so its iterate depends on rounding wherever a constraint
switches on or off; there the two engines' ULP-level state differences
grow over a long horizon (on an x86 CPU: below 1e-8 through step 52,
1.6e-8 at step 53, at most 1.7e-7 over 100 steps, in one of the four
envs).  So the benchmark configuration is held step by step from mjtpu's
own state, and over the whole 100 steps where the solver runs to
convergence.
"""

import pathlib

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import mjtpu
import mjtpu_torch
from mjtpu_torch.ops import cholesky
from tests.conftest import load_mj

torch.set_num_threads(1)

HB = str(pathlib.Path(mjtpu.__file__).parent / "zoo" / "assets" / "humanoid_bench.xml")
STEPS = 100
GOLDEN = mjtpu_torch.ASSETS / "humanoid_bench_golden.npz"


@pytest.fixture(scope="module")
def golden():
  return dict(np.load(GOLDEN))


@pytest.fixture(scope="module")
def mjtpu_states(golden):
  """mjtpu's Data (numpy leaves) before step 1 and after each step."""
  mjm = mujoco.MjModel.from_xml_path(HB)
  m = mjtpu.put_model(mjm, dtype=jnp.float64)
  d = jax.vmap(lambda _: mjtpu.make_data(m))(jnp.arange(4))
  d = d.replace(qpos=jnp.asarray(golden["qpos0"]), qvel=jnp.asarray(golden["qvel0"]),
                ctrl=jnp.asarray(golden["ctrl"]))
  step = jax.jit(jax.vmap(mjtpu.step, in_axes=(None, 0)))
  out = [jax.tree.map(np.asarray, d)]
  for _ in range(STEPS):
    d = step(m, d)
    out.append(jax.tree.map(np.asarray, d))
  return out


def _model(iterations=None):
  ns = mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / "humanoid_bench_model.npz")
  if iterations:
    ns.opt.iterations = ns.opt.ls_iterations = iterations
  return mjtpu_torch.model_from_arrays(ns, device="cpu")


def _rollout(m, golden, steps=STEPS):
  d = mjtpu_torch.make_data(m, batch_size=4)
  d = mjtpu_torch.replace(d, qpos=torch.as_tensor(golden["qpos0"]),
                          qvel=torch.as_tensor(golden["qvel0"]),
                          ctrl=torch.as_tensor(golden["ctrl"]))
  qpos, qvel, first = [], [], None
  for i in range(steps):
    d = mjtpu_torch.step(m, d)
    qpos.append(d.qpos.numpy())
    qvel.append(d.qvel.numpy())
    if i == 0:
      first = d
  return np.stack(qpos), np.stack(qvel), first


def _err(a, b):
  return np.abs(a - b).max(axis=tuple(range(1, a.ndim)))  # per step


def test_benchmark_config_step_by_step(mjtpu_states):
  """Every one of the 100 steps, started from mjtpu's full state (warmstart
  included), lands within 1e-8 of mjtpu's next state."""
  m = _model()
  for i in range(STEPS):
    got = mjtpu_torch.step(m, mjtpu_torch.data_from_mjtpu(mjtpu_states[i], device="cpu"))
    want = mjtpu_states[i + 1]
    for f in ("qpos", "qvel", "qacc"):
      err = float(np.abs(getattr(got, f).numpy() - getattr(want, f)).max())
      assert err < 1e-8, f"step {i + 1} {f}: {err:.3e}"


def test_benchmark_config_trajectory(golden):
  m = _model()
  cholesky.launches = 0
  qpos, qvel, first = _rollout(m, golden)
  assert cholesky.launches == 0  # CPU tensors: the plain twin, no kernel
  for f, key in (("qacc", "qacc"), ("efc_force", "efc_force")):
    np.testing.assert_allclose(getattr(first, f).numpy(), golden[key], rtol=0, atol=1e-9)
  np.testing.assert_allclose(first.contact.dist.numpy(), golden["contact_dist"],
                             rtol=0, atol=1e-9)
  err = np.maximum(_err(qpos, golden["qpos"]), _err(qvel, golden["qvel"]))
  assert err[:50].max() < 1e-8, err[:50]
  assert err.max() < 1e-6, err  # see the module docstring
  assert int(first.nreset.sum()) == 0 and np.isfinite(qpos).all()


def test_converged_trajectory(golden):
  """With the solver run to convergence the 100-step trajectory holds 1e-8."""
  m = _model(int(golden["converged_iterations"]))
  qpos, qvel, _ = _rollout(m, golden)
  err = np.maximum(_err(qpos, golden["conv_qpos"]), _err(qvel, golden["conv_qvel"]))
  assert err.max() < 1e-8, (int(err.argmax()) + 1, float(err.max()))


def test_check_state_resets_nan():
  m = _model()
  d = mjtpu_torch.make_data(m, batch_size=3)
  qvel = torch.zeros(3, m.nv, dtype=torch.float64)
  qvel[1, 4] = float("nan")
  qpos = d.qpos.clone()
  qpos[2, 10] = 1e12  # diverged
  d = mjtpu_torch.replace(d, qvel=qvel, qpos=qpos)
  d = mjtpu_torch.step(m, d)
  assert d.nreset.tolist() == [0, 1, 1]
  assert bool(torch.isfinite(d.qpos).all() and torch.isfinite(d.qvel).all())
  d = mjtpu_torch.step(m, d)
  assert d.nreset.tolist() == [0, 1, 1]


def _variant(path, collide_head=False, pair_dim=None, **opt):
  def make():
    mjm = mujoco.MjModel.from_xml_path(path) if "/" in path else load_mj(path)
    for k, v in opt.items():
      setattr(mjm.opt, k, v)
    if collide_head:  # the head, made an ellipsoid, meets the floor plane
      head = mujoco.mj_name2id(mjm, mujoco.mjtObj.mjOBJ_GEOM, "head")
      mjm.geom_contype[head] = mjm.geom_conaffinity[head] = 1
      mjm.geom_type[head] = mujoco.mjtGeom.mjGEOM_ELLIPSOID
      mjm.geom_size[head, 1:] = mjm.geom_size[head, 0]  # a sphere's size has one radius
    if pair_dim is not None:
      mjm.pair_dim[:] = pair_dim
    return mjm
  return make


def _xml(body: str, asset: str = "", custom: str = ""):
  return lambda: mujoco.MjModel.from_xml_string(
      f"<mujoco><asset>{asset}</asset><custom>{custom}</custom><worldbody>"
      f'<geom type="plane" size="5 5 0.1"/>{body}</worldbody></mujoco>')


def _free(geom: str, z: float) -> str:
  return f'<body pos="0 0 {z}"><freejoint/><geom {geom}/></body>'


_BOXES = _free('type="box" size="0.1 0.1 0.1"', 0.2) + _free('type="box" size="0.1 0.1 0.1"', 0.5)


# ``what`` None: a model that an earlier slice refused and a later one
# accepts (the collision slice: every geom pair mjtpu collides, the
# max_geom_pairs broadphase; the cone slice: elliptic cones, condim 4 and
# 6; the fluid slice: fluid forces under RK4; the tendon slice: tendons,
# every transmission, activation dynamics, Euler's damping on a forest;
# the equality slice: equality constraints, ImplicitFast on a forest); it
# must build and step
@pytest.mark.parametrize("make, what", [
    (_variant(HB, collide_head=True), None),
    (_xml(_free('type="capsule" size="0.05 0.1"', 0.5) + _free('type="box" size="0.1 0.1 0.1"', 0.2)),
     None),
    (_xml('<geom type="hfield" hfield="h"/>' + _free('type="box" size="0.1 0.1 0.1"', 0.3),
          asset='<hfield name="h" nrow="4" ncol="4" size="1 1 0.1 0.1"/>'),
     None),
    (_xml(_BOXES, custom='<numeric name="max_geom_pairs" data="1"/>'), None),
    # two damped pendulums: Euler's implicit damping on a forest takes the
    # blocked symmetric factor_solve (the tendon slice)
    (_xml('<body pos="0 0 1"><joint type="hinge" axis="0 1 0" damping="0.1"/>'
          '<geom type="capsule" fromto="0 0 0 0 0 -0.3" size="0.02"/></body>' * 2),
     None),
    # tendon sensors, a ball-joint transmission and tendon actuators (the
    # tendon slice)
    (_variant("sensors.xml"), None),
    (_variant("equality.xml"), None),
    (_variant("friction_tendon.xml"), None),
    # RK4 is in the slice since the zoo envs, fluid forces since the fluid
    # slice: an RK4 model in a fluid (as the zoo's swimmer) builds and steps
    (_variant("pendulum_rk4.xml", density=1.2), None),
    (_variant("boxes.xml", integrator=mujoco.mjtIntegrator.mjINT_IMPLICITFAST), None),
    (_variant(HB, cone=mujoco.mjtCone.mjCONE_ELLIPTIC), None),
    (_variant(HB, solver=mujoco.mjtSolver.mjSOL_PGS), "solver 0"),
    # condim 1 is in the slice since humanoid_terrain, 4 and 6 since the
    # cone slice
    (_variant(HB, pair_dim=4), None),
    (_variant(HB, pair_dim=6), None),
    # the full Implicit integrator and fluid forces under ImplicitFast since
    # the Implicit slice
    (_variant(HB, integrator=mujoco.mjtIntegrator.mjINT_IMPLICIT), None),
    (_variant(HB, density=1.2, integrator=mujoco.mjtIntegrator.mjINT_IMPLICITFAST), None),
    # the OVERRIDE, FWDINV and INVDISCRETE enable flags since inverse
    # dynamics came to the port
    (_variant(HB, enableflags=int(mujoco.mjtEnableBit.mjENBL_OVERRIDE
                                  | mujoco.mjtEnableBit.mjENBL_FWDINV
                                  | mujoco.mjtEnableBit.mjENBL_INVDISCRETE)), None),
], ids=["sphere_plane", "box_capsule", "box_hfield", "max_geom_pairs", "eulerdamp_forest",
        "sensors", "equality", "tendon", "rk4", "implicitfast_forest", "elliptic", "pgs",
        "condim1", "condim6", "implicit", "implicitfast_fluid", "enable_flags"])
def test_put_model_refuses_out_of_slice(make, what):
  """put_model refuses a model outside the slices, naming the feature; the
  cases that a later slice took in (what None) build and step."""
  if what is None:
    m = mjtpu_torch.put_model(make(), device="cpu")
    d = mjtpu_torch.step(m, mjtpu_torch.make_data(m, batch_size=2))
    assert bool(torch.isfinite(d.qpos).all()) and int(d.nreset.sum()) == 0
    return
  with pytest.raises(NotImplementedError, match=what):
    mjtpu_torch.put_model(make(), device="cpu")


@pytest.mark.parametrize("make", [
    # three trees: the blocked mass matrix, boxes of two sizes (Newton,
    # its loops capped: the port runs them to their fixed counts)
    _variant("boxes.xml", iterations=5, ls_iterations=5),
    _variant(HB, solver=mujoco.mjtSolver.mjSOL_CG),
    # Euler's implicit joint damping on one tree (the dense factor_solve)
    _variant("pendulum.xml"),
    # one tree with nv >= 32 that sparse.structure leaves dense (Newton,
    # its loops capped as for boxes)
    _variant("chain40.xml", iterations=2, ls_iterations=2),
    # RK4 (the zoo's ant, hopper and walker2d)
    _variant("pendulum_rk4.xml"),
], ids=["boxes", "cg", "pendulum", "chain40", "rk4"])
def test_put_model_accepts_the_slice(make):
  """Models that earlier slices refused build and step on the CPU."""
  mjm = make()
  m = mjtpu_torch.put_model(mjm, device="cpu")
  d = mjtpu_torch.make_data(m, batch_size=2)
  for _ in range(2):
    d = mjtpu_torch.step(m, d)
  assert bool(torch.isfinite(d.qpos).all()) and int(d.nreset.sum()) == 0
  assert float(d.time[0]) == pytest.approx(2 * mjm.opt.timestep)


def test_entry_points_default_to_cuda(monkeypatch):
  """Without a CUDA device, a call that names no device raises and asks
  for device="cpu"; it never falls back to the CPU."""
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  ns = mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / "humanoid_bench_model.npz")
  with pytest.raises(RuntimeError, match='device="cpu"'):
    mjtpu_torch.model_from_arrays(ns)
  with pytest.raises(RuntimeError, match='device="cpu"'):
    mjtpu_torch.put_model(mujoco.MjModel.from_xml_path(HB))
  m = mjtpu_torch.model_from_arrays(ns, device="cpu")
  d = mjtpu_torch.data_to_numpy(mjtpu_torch.make_data(m, batch_size=1))
  with pytest.raises(RuntimeError, match='device="cpu"'):
    mjtpu_torch.data_from_mjtpu(d)
  assert mjtpu_torch.data_from_mjtpu(d, device="cpu").qpos.device.type == "cpu"


def test_put_data_get_data_into_round_trip():
  mjm = mujoco.MjModel.from_xml_path(HB)
  rng = np.random.default_rng(3)
  mjds = [mujoco.MjData(mjm) for _ in range(2)]
  for x in mjds:
    x.qpos[:] = mjm.qpos0 + rng.uniform(-0.01, 0.01, mjm.nq)
    x.qvel[:] = rng.uniform(-0.1, 0.1, mjm.nv)
    x.ctrl[:] = rng.uniform(-1, 1, mjm.nu)
  m = mjtpu_torch.put_model(mjm, device="cpu")
  d = mjtpu_torch.forward(m, mjtpu_torch.put_data(m, mjds))
  out = [mujoco.MjData(mjm) for _ in range(2)]
  mjtpu_torch.get_data_into(out, m, d)
  for b, (x, y) in enumerate(zip(mjds, out)):
    np.testing.assert_array_equal(y.qpos, d.qpos[b].numpy())  # quaternion normalized
    np.testing.assert_array_equal(y.ctrl, x.ctrl)
    np.testing.assert_array_equal(y.qacc, d.qacc[b].numpy())
    np.testing.assert_array_equal(y.xmat.reshape(-1, 3, 3), d.xmat[b].numpy())
    # mj_kinematics agrees with the port's kinematics
    mujoco.mj_kinematics(mjm, x)
    np.testing.assert_allclose(y.xpos, x.xpos, atol=1e-12)


def test_zoo_humanoid_matches_mjtpu():
  """Zoo humanoid.xml (the model __graft_entry__ steps: ImplicitFast, feet
  on a plane) at B=2, f64: 5 port steps against mjtpu's to 1e-8, with the
  feet 5 mm into the floor so that the plane-sphere contacts are live."""
  from mjtpu_torch._src import collision_driver

  mjm = mujoco.MjModel.from_xml_path(str(pathlib.Path(HB).with_name("humanoid.xml")))
  rng = np.random.default_rng(5)
  qpos = mjm.qpos0 + rng.uniform(-0.01, 0.01, (2, mjm.nq))
  mjd = mujoco.MjData(mjm)
  mjd.qpos[:] = qpos[0]
  mujoco.mj_kinematics(mjm, mjd)
  foot = mujoco.mj_name2id(mjm, mujoco.mjtObj.mjOBJ_GEOM, "right_foot_g")
  qpos[:, 2] -= mjd.geom_xpos[foot, 2] - mjm.geom_size[foot, 0] + 0.005
  ctrl = rng.uniform(-1.0, 1.0, (2, mjm.nu))

  jm = mjtpu.put_model(mjm, dtype=jnp.float64)
  jd = jax.vmap(lambda _: mjtpu.make_data(jm))(jnp.arange(2))
  jd = jd.replace(qpos=jnp.asarray(qpos), ctrl=jnp.asarray(ctrl))
  m = mjtpu_torch.put_model(mjm, device="cpu")
  keys = [k[:2] for k in collision_driver.candidate_groups(m)]
  assert (0, 2) in keys  # plane-sphere
  d = mjtpu_torch.make_data(m, batch_size=2)
  d = mjtpu_torch.replace(d, qpos=torch.as_tensor(qpos), ctrl=torch.as_tensor(ctrl))
  step = jax.jit(jax.vmap(mjtpu.step, in_axes=(None, 0)))
  for i in range(5):
    jd = step(jm, jd)
    d = mjtpu_torch.step(m, d)
    if i == 0:
      live = np.asarray(jd.contact.dist) < np.asarray(jd.contact.includemargin)
      assert live[np.asarray(jd.contact.geom1) == 0].any()  # feet on the floor
    for f in ("qpos", "qvel"):
      err = float(np.abs(getattr(d, f).numpy() - np.asarray(getattr(jd, f))).max())
      assert err < 1e-8, f"step {i + 1} {f}: {err:.3e}"
