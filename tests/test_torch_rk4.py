"""mjtpu_torch's RK4 integrator (forward.rungekutta4) against mjtpu at
float64 on the CPU, and kernel B1's register instances for the zoo envs'
sizes.

  * tests/models/pendulum_rk4.xml, live from both engines: 20 steps of 4
    envs, qpos, qvel and qacc_warmstart to 1e-12 (absolute; the measured
    gap is ~1e-14), and the four passes' times.
  * mjtpu/zoo/assets/ant.xml (the Ant env's model: RK4, Newton 100 x 50
    left early, 25 contact slots on the floor) from the committed golden
    (scripts/torch_port_assets.py, ant_rk4_golden.npz): step 1's four
    forward passes' qacc, the combined qacc and qacc_warmstart to 1e-10 of
    each field's scale; the 100-step trajectory, qpos and qvel, to 1e-8.
  * B1 at n = 6, 9 and 14 (hopper; walker2d and halfcheetah; ant): the
    register kernel's dispatch and, on the CPU, its twin against mjtpu's
    per-env base rule.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import mjtpu
import mjtpu_torch
from mjtpu.ops import fused as mjtpu_fused
from mjtpu_torch._src import forward as forward_mod
from mjtpu_torch.ops import cholesky

from conftest import load_mj

torch.set_num_threads(1)

GOLDEN = mjtpu_torch.ASSETS / "ant_rk4_golden.npz"
PENDULUM_STEPS = 20
PENDULUM_BOUND = 1e-12
PASS_BOUND = 1e-10
TRAJECTORY_BOUND = 1e-8


@pytest.fixture(scope="module")
def golden():
  return dict(np.load(GOLDEN))


def _ant(dtype=torch.float64):
  return mjtpu_torch.model_from_arrays(
      mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / "ant_model.npz"), dtype=dtype,
      device="cpu")


def _start(m, golden):
  d = mjtpu_torch.make_data(m, batch_size=golden["qpos0"].shape[0])
  return mjtpu_torch.replace(d, qpos=torch.as_tensor(golden["qpos0"]),
                             qvel=torch.as_tensor(golden["qvel0"]),
                             ctrl=torch.as_tensor(golden["ctrl"]))


class _Passes:
  """Records every forward pass's Data while installed as
  forward_mod.forward (rungekutta4 and step look it up at call time)."""

  def __init__(self, monkeypatch):
    self.data = []
    original = forward_mod.forward

    def record(m, d, **kw):
      d = original(m, d, **kw)
      self.data.append(d)
      return d

    monkeypatch.setattr(forward_mod, "forward", record)


def test_pendulum_rk4_matches_mjtpu(monkeypatch):
  """20 steps of 4 envs from the same seeded states, live from both engines;
  step 1's passes run at time0, time0 + h/2 (twice) and time0 + h."""
  mjm = load_mj("pendulum_rk4.xml")
  rng = np.random.default_rng(0)
  qpos = mjm.qpos0[None] + rng.uniform(-0.5, 0.5, (4, mjm.nq))
  qvel = rng.normal(size=(4, mjm.nv))
  m = mjtpu.put_model(mjm, dtype=jnp.float64)
  d = jax.vmap(lambda _: mjtpu.make_data(m))(jnp.arange(4))
  d = d.replace(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel))
  step = jax.jit(jax.vmap(mjtpu.step, in_axes=(None, 0)))
  tm = mjtpu_torch.put_model(mjm, device="cpu")
  assert tm.opt.integrator == mjtpu_torch.IntegratorType.RK4
  td = mjtpu_torch.replace(mjtpu_torch.make_data(tm, batch_size=4), qpos=torch.as_tensor(qpos),
                           qvel=torch.as_tensor(qvel))
  passes = _Passes(monkeypatch)
  for i in range(PENDULUM_STEPS):
    d, td = step(m, d), mjtpu_torch.step(tm, td)
    if i == 0:
      h = mjm.opt.timestep
      times = [p.time.numpy() for p in passes.data]
      np.testing.assert_array_equal(np.stack(times), np.array(
          [0.0, 0.5 * h, 0.5 * h, 1.0 * h])[:, None].repeat(4, axis=1))
    for f in ("qpos", "qvel", "qacc_warmstart", "time"):
      np.testing.assert_allclose(getattr(td, f).numpy(), np.asarray(getattr(d, f)), rtol=0,
                                 atol=PENDULUM_BOUND, err_msg=f"step {i + 1} {f}")
  assert len(passes.data) == 4 * PENDULUM_STEPS


def test_ant_model_is_the_slice():
  m = _ant()
  assert (m.nq, m.nv, m.nu) == (15, 14, 8)
  assert m.opt.integrator == mjtpu_torch.IntegratorType.RK4
  # 8 hinge limits, 25 contact slots at condim 3 (1 plane-sphere, 12
  # plane-capsule pairs of 2), 4 rows each
  assert mjtpu_torch.constraint_sizes(m) == (0, 0, 8, 25, 108)
  assert (m.opt.solver, m.opt.iterations, m.opt.ls_iterations) == (
      mjtpu_torch.SolverType.NEWTON, 100, 50)
  # Newton's Hessian takes B1's register kernel at n=14
  for dtype in (torch.float32, torch.float64):
    assert cholesky.variant(m.nv, dtype) == "register"


def _scaled(got, want) -> float:
  return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


def test_ant_rk4_passes_match_mjtpu(golden, monkeypatch):
  """Step 1 from the golden's states: each forward pass's qacc (the
  initial forward and the three stages, each warm-started from the pass
  before), the combined qacc and qacc_warmstart (the last pass's solve)."""
  m = _ant()
  passes = _Passes(monkeypatch)
  d = mjtpu_torch.step(m, _start(m, golden))
  assert len(passes.data) == 4
  for k, p in enumerate(passes.data):
    err = _scaled(p.qacc.numpy(), golden["pass_qacc"][k])
    assert err <= PASS_BOUND, f"pass {k} qacc: {err:.3e} of scale"
  for f in ("qacc", "qacc_warmstart"):
    err = _scaled(getattr(d, f).numpy(), golden[f])
    assert err <= PASS_BOUND, f"{f}: {err:.3e} of scale"
  # the stage Data is carried: the derived fields are the last pass's
  assert torch.equal(d.efc_force, passes.data[-1].efc_force)
  assert torch.equal(d.qacc_warmstart, passes.data[-1].qacc)


def test_ant_rk4_trajectory_matches_golden(golden):
  """100 steps of the 4 envs: the ant falls from z ~0.75 onto the floor
  and its feet, torso and legs make contact; qpos and qvel to 1e-8."""
  m = _ant()
  d = _start(m, golden)
  worst = 0.0
  for i in range(golden["qpos"].shape[0]):
    d = mjtpu_torch.step(m, d)
    for f in ("qpos", "qvel"):
      err = float(np.abs(getattr(d, f).numpy() - golden[f][i]).max())
      worst = max(worst, err)
      assert err <= TRAJECTORY_BOUND, f"step {i + 1} {f}: {err:.3e}"
  assert int(d.nreset.sum()) == 0
  # the run reaches the floor: the torso ends below its start
  assert (golden["qpos"][-1, :, 2] < golden["qpos0"][:, 2] - 0.1).all()


ZOO_WIDTHS = (6, 9, 14)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", ZOO_WIDTHS)
def test_register_instance_for_zoo_width(n, dtype):
  """hopper's n=6, walker2d's and halfcheetah's 9 and ant's 14 take the
  register kernel (an instance each, csrc/cholesky.cu; its dispatch and
  launch geometry: tests/test_torch_cholesky.py); on the CPU both
  variants are the twin."""
  assert cholesky.variants(n, dtype) == ("register", "shared")
  rng = np.random.default_rng(n)
  a = rng.normal(size=(130, n, n))
  mat = torch.as_tensor(a @ a.transpose(0, 2, 1) + n * np.eye(n), dtype=dtype)
  rhs = torch.as_tensor(rng.normal(size=(130, n)), dtype=dtype)
  want = cholesky.chol_solve_reference(mat, rhs)
  for kind in ("register", "shared"):
    assert torch.equal(cholesky.cholesky_solve(mat, rhs, kernel=kind), want)
  assert cholesky.launches == 0


@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("n", ZOO_WIDTHS)
def test_twin_matches_mjtpu_base_at_zoo_width(n, clamp):
  """The twin (the register kernel's reference on the card) against
  mjtpu's per-env base rule at the zoo widths, SPD and with floored
  pivots: rel 1e-10, and 1e-6 of the largest entry with floored pivots
  (~1/floor solutions, ill-conditioned)."""
  rng = np.random.default_rng(100 + n + clamp)
  a = rng.normal(size=(130, n, n))
  mat = a @ a.transpose(0, 2, 1) + n * np.eye(n)
  if clamp:
    keep = (rng.random((130, n)) >= 0.3).astype(np.float64)
    mat = mat * keep[:, :, None] * keep[:, None, :]
  rhs = rng.normal(size=(130, n))
  want = np.asarray(jax.vmap(mjtpu_fused._base)(jnp.asarray(mat), jnp.asarray(rhs)))
  got = cholesky.chol_solve_reference(torch.as_tensor(mat), torch.as_tensor(rhs)).numpy()
  rel = 1e-6 if clamp else 1e-10
  np.testing.assert_allclose(got, want, rtol=rel, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("name", ["swimmer.xml", "implicit"])
def test_put_model_refuses_by_name(name):
  """RK4 models pass the integrator gate (the swimmer, RK4 in a viscous
  medium, builds: tests/test_torch_satellite.py); the swimmer under
  ImplicitFast (its fluid's velocity derivative) and pendulum_rk4.xml
  under the full Implicit integrator, refused until the Implicit slice,
  build and step too."""
  if name == "implicit":
    mjm = load_mj("pendulum_rk4.xml")
    mjm.opt.integrator = mujoco.mjtIntegrator.mjINT_IMPLICIT
  else:
    mjm = mujoco.MjModel.from_xml_path(str(mjtpu_torch.ASSETS.parent.parent / "mjtpu" / "zoo"
                                           / "assets" / name))
    mjtpu_torch.put_model(mjm, device="cpu")  # RK4 in a fluid
    mjm.opt.integrator = mujoco.mjtIntegrator.mjINT_IMPLICITFAST
  m = mjtpu_torch.put_model(mjm, device="cpu")
  d = mjtpu_torch.make_data(m, batch_size=2)
  qvel = np.random.default_rng(0).uniform(-0.5, 0.5, (2, m.nv))
  d = mjtpu_torch.step(m, mjtpu_torch.replace(d, qvel=torch.as_tensor(qvel)))
  assert bool(torch.isfinite(d.qpos).all()) and int(d.nreset.sum()) == 0


@pytest.mark.parametrize("name", ["ant", "hopper", "walker2d"])
def test_put_model_accepts_rk4_zoo_model(name):
  mjm = mujoco.MjModel.from_xml_path(str(mjtpu_torch.ASSETS.parent.parent / "mjtpu" / "zoo"
                                         / "assets" / f"{name}.xml"))
  assert mjm.opt.integrator == mujoco.mjtIntegrator.mjINT_RK4
  m = mjtpu_torch.put_model(mjm, device="cpu")
  d = mjtpu_torch.step(m, mjtpu_torch.make_data(m, batch_size=2))
  assert bool(torch.isfinite(d.qpos).all()) and int(d.nreset.sum()) == 0
