"""humanoid_terrain through mjtpu_torch against mjtpu at float64 on the CPU.

humanoid_terrain (mjtpu/zoo/assets) has ImplicitFast, 8 Newton iterations,
235 contact slots in 7 collision groups (sphere/capsule self-collision at
condim 1; sphere/capsule against the height field and against two convex
rocks at condim 3) and 630 efc rows.  Three checks:

  * stage parity: every stage of a step, started from mjtpu's Data before
    it, against mjtpu's Data after it, at 1e-10 times the field's scale,
    on B=4 states built to touch every group (random joint poses; env 0
    lying on the flat ground, env 1 standing over the bumpy ring with its
    feet crossed, envs 2 and 3 with a foot and a shin pressed into the
    rocks).  The collision
    stage is compared slot by slot, the slots that do not touch included.
    Also deriv_smooth_vel, both branches of factor_solve and implicit.
  * one-step restarts: from mjtpu's state before each of the 100 steps of
    the committed golden run (all 100 as one batch), one port step lands
    within 1e-8 of mjtpu's next state.
  * the 100-step trajectory from the golden's initial states against the
    committed golden (mjtpu, f64), to TRAJECTORY_BOUND (measured on an x86
    CPU: 3.4e-13; chip_smoke.py holds the run on the card to the same
    bound).
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import mjtpu
from mjtpu._src import derivative as j_derivative
from mjtpu._src import forward as j_forward
from mjtpu._src import smooth as j_smooth
import mjtpu_torch
from mjtpu_torch._src import derivative as t_derivative
from mjtpu_torch._src import forward as t_forward
from mjtpu_torch._src import smooth as t_smooth
from mjtpu_torch.ops import cholesky, hfield
from tests.test_torch_stages import STAGES, _field

torch.set_num_threads(1)

B = 4
STEPS = 100
TRAJECTORY_BOUND = 1e-8
GOLDEN = mjtpu_torch.ASSETS / "humanoid_terrain_golden.npz"
SNAPSHOT = mjtpu_torch.ASSETS / "humanoid_terrain_model.npz"

# the chain's stages: STAGES of tests/test_torch_stages.py with the
# ImplicitFast integrator in Euler's place
CHAIN = [s for s in STAGES if s[0] != "euler"] + [
    ("implicit", j_forward.implicit, t_forward.implicit, ("qpos", "qvel", "qacc", "time")),
]
NAMES = [s[0] for s in CHAIN]


def _terrain_mjm():
  import importlib.util
  import pathlib

  path = pathlib.Path(__file__).resolve().parent.parent / "scripts" / "torch_port_assets.py"
  spec = importlib.util.spec_from_file_location("torch_port_assets", path)
  script = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(script)
  return script.load_terrain_mjmodel()


def _stage_states(mjm, m):
  """(qpos, qvel, ctrl, qacc_warmstart) for the stage-parity envs."""
  rng = np.random.default_rng(7)
  qpos = np.tile(mjm.qpos0, (B, 1))
  for j in range(1, mjm.njnt):
    lo, hi = mjm.jnt_range[j]
    qpos[:, mjm.jnt_qposadr[j]] = rng.uniform(lo, hi, B) * 0.6
  qpos[0, 3:7] = (np.cos(np.pi / 4), 0.0, np.sin(np.pi / 4), 0.0)  # lying along x
  qpos[1, :2] = (4.0, 0.5)  # over the bumpy ring
  # env 1: straight legs, both hips adducted to their limit: the feet cross
  for side in ("right", "left"):
    for joint in ("hip_x", "hip_z", "hip_y", "knee"):
      j = mujoco.mj_name2id(mjm, mujoco.mjtObj.mjOBJ_JOINT, f"{side}_{joint}")
      qpos[1, mjm.jnt_qposadr[j]] = mjm.jnt_range[j, 1] if joint == "hip_x" else 0.0

  mjd = mujoco.MjData(mjm)
  geom = lambda name: mujoco.mj_name2id(mjm, mujoco.mjtObj.mjOBJ_GEOM, name)

  def apex(rock):
    mesh = mjm.geom_dataid[rock]
    va, vn = mjm.mesh_vertadr[mesh], mjm.mesh_vertnum[mesh]
    verts = mjd.geom_xpos[rock] + mjm.mesh_vert[va:va + vn] @ mjd.geom_xmat[rock].reshape(3, 3).T
    return verts[np.argmax(verts[:, 2])]

  # envs 2 and 3: the left foot sphere and the lower end of the right shin
  # capsule 1 cm into a rock's apex
  for b, (rock, part) in ((2, ("rock2", "left_foot_g")), (3, ("rock1", "right_shin1"))):
    mjd.qpos[:] = qpos[b]
    mujoco.mj_kinematics(mjm, mjd)
    g = geom(part)
    size = mjm.geom_size[g]
    low = mjd.geom_xpos[g].copy()
    if mjm.geom_type[g] == mujoco.mjtGeom.mjGEOM_CAPSULE:
      axis = mjd.geom_xmat[g].reshape(3, 3)[:, 2]
      low -= np.sign(axis[2]) * size[1] * axis
    low[2] -= size[0]
    qpos[b, :3] += apex(geom(rock)) - low - np.array([0.0, 0.0, 0.01])

  # envs 0 and 1: lowered until the deepest height-field contact is 1 cm in
  d = mjtpu_torch.make_data(m, batch_size=B)
  d = mjtpu_torch.replace(d, qpos=torch.as_tensor(qpos))
  d = mjtpu_torch.collision(m, mjtpu_torch.kinematics(m, d))
  floor = (d.contact.geom1 == geom("floor")).numpy()
  dist = np.where(floor, d.contact.dist.numpy(), np.inf).min(axis=1)
  qpos[:2, 2] -= dist[:2] + 0.01
  qvel = rng.uniform(-0.5, 0.5, (B, mjm.nv))
  return qpos, qvel, rng.uniform(-1.0, 1.0, (B, mjm.nu)), rng.uniform(-1.0, 1.0, (B, mjm.nv))


def _chain(m, d):
  """mjtpu's Data before the first stage and after each one."""
  out = [d]
  for _, j_stage, _, _ in CHAIN:
    d = jax.vmap(j_stage, in_axes=(None, 0))(m, d)
    out.append(d)
  return out


@pytest.fixture(scope="module")
def setup():
  """(port Model, mjtpu Model, jitted mjtpu chain, mjtpu chain at the
  stage-parity states with numpy leaves)."""
  mjm = _terrain_mjm()
  jm = mjtpu.put_model(mjm, dtype=jnp.float64)
  m = mjtpu_torch.put_model(mjm, device="cpu")
  qpos, qvel, ctrl, warm = _stage_states(mjm, m)
  d = jax.vmap(lambda _: mjtpu.make_data(jm))(jnp.arange(B))
  d = d.replace(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel), ctrl=jnp.asarray(ctrl),
                qacc_warmstart=jnp.asarray(warm))
  chain = jax.jit(_chain)
  return m, jm, chain, [jax.tree.map(np.asarray, x) for x in chain(jm, d)]


def _port(ds, i):
  return mjtpu_torch.data_from_mjtpu(ds[i], device="cpu")


def _assert_close(got, want, what, tol=1e-10):
  got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
  assert got.shape == want.shape, (what, got.shape, want.shape)
  scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
  err = float(np.abs(got - want).max()) if want.size else 0.0
  assert err <= tol * scale, f"{what}: max abs err {err:.3e} (scale {scale:.3g})"


@pytest.mark.parametrize("stage", range(len(CHAIN)), ids=NAMES)
def test_stage(setup, stage):
  m, _, _, ds = setup
  name, _, t_stage, fields = CHAIN[stage]
  if name == "collision":
    fields = fields + ("contact.geom",)
  if name == "make_constraint":
    fields = fields + ("efc_frictionloss",)
  got = mjtpu_torch.data_to_numpy(t_stage(m, _port(ds, stage)))
  for f in fields:
    _assert_close(_field(got, f), _field(ds[stage + 1], f), f"{name} {f}")


def test_stages_exercise_the_slice(setup):
  """Every collision group has live contacts in the stage states, and the
  layout is the slice's: 235 slots, 109 at condim 1, 630 efc rows."""
  from mjtpu_torch._src import collision_driver

  m, _, _, ds = setup
  assert mjtpu_torch.constraint_sizes(m) == (0, 0, 17, 235, 630)
  dims = collision_driver.make_condim(m)
  assert (dims == 1).sum() == 109 and (dims == 3).sum() == 126
  con = ds[NAMES.index("collision") + 1].contact
  live = con.dist < con.includemargin
  start = 0
  for key, pairs in collision_driver.candidate_groups(m).items():
    n = collision_driver._PAIR_NCON[key[:2]] * len(pairs)
    assert live[:, start:start + n].any(), f"group {key} has no live contact"
    start += n
  assert (np.abs(ds[NAMES.index("solve") + 1].efc_force) > 0).any(axis=1).all()


def test_deriv_smooth_vel(setup):
  m, jm, _, ds = setup
  d = ds[NAMES.index("solve") + 1]
  want = jax.vmap(j_derivative.deriv_smooth_vel, in_axes=(None, 0))(
      jm, jax.tree.map(jnp.asarray, d))
  got = t_derivative.deriv_smooth_vel(m, _port(ds, NAMES.index("solve") + 1))
  _assert_close(got.numpy(), want, "qDeriv")
  assert np.abs(np.asarray(want)).max() > 0


@pytest.mark.parametrize("symmetric", [False, True], ids=["lu", "cholesky"])
def test_factor_solve(setup, symmetric):
  """ImplicitFast's qM - h*qDeriv through the LU branch, and qM + h*D
  (symmetric positive definite) through the Cholesky one (kernel B1's
  seam: its plain twin on the CPU)."""
  m, jm, _, ds = setup
  d = ds[NAMES.index("solve") + 1]
  qderiv = np.asarray(jax.vmap(j_derivative.deriv_smooth_vel, in_axes=(None, 0))(
      jm, jax.tree.map(jnp.asarray, d)))
  h = float(m.opt.timestep)
  if symmetric:
    mat = d.qM + h * np.eye(m.nv) * np.asarray(m.dof_damping)
  else:
    mat = d.qM - h * 0.5 * (qderiv + qderiv.transpose(0, 2, 1))
  rhs = d.qfrc_smooth + d.qfrc_constraint
  want = jax.vmap(lambda a, b: j_smooth.factor_solve(jm, a, b, symmetric=symmetric))(
      jnp.asarray(mat), jnp.asarray(rhs))
  before = cholesky.launches
  got = t_smooth.factor_solve(m, torch.as_tensor(mat), torch.as_tensor(rhs), symmetric=symmetric)
  assert cholesky.launches == before
  _assert_close(got.numpy(), want, "factor_solve")


@pytest.fixture(scope="module")
def golden():
  return dict(np.load(GOLDEN))


@pytest.fixture(scope="module")
def mjtpu_states(setup, golden):
  """mjtpu's Data (numpy leaves) before step 1 and after each of the 100
  golden steps (the jitted chain's last Data is the stepped one)."""
  _, jm, chain, _ = setup
  d = jax.vmap(lambda _: mjtpu.make_data(jm))(jnp.arange(B))
  d = d.replace(qpos=jnp.asarray(golden["qpos0"]), qvel=jnp.asarray(golden["qvel0"]),
                ctrl=jnp.asarray(golden["ctrl"]))
  out = [jax.tree.map(np.asarray, d)]
  for _ in range(STEPS):
    d = chain(jm, d)[-1]
    out.append(jax.tree.map(np.asarray, d))
  return out


def test_one_step_restarts(setup, mjtpu_states):
  """From mjtpu's state before each golden step (all 100 x 4 envs as one
  batch), one port step lands within 1e-8 of mjtpu's next state."""
  m = setup[0]
  stack = lambda states: jax.tree.map(lambda *x: np.concatenate(x), *states)
  before, after = stack(mjtpu_states[:-1]), stack(mjtpu_states[1:])
  got = mjtpu_torch.step(m, mjtpu_torch.data_from_mjtpu(before, device="cpu"))
  for f in ("qpos", "qvel", "qacc"):
    err = np.abs(getattr(got, f).numpy() - getattr(after, f)).max(axis=1).reshape(STEPS, B)
    assert err.max() < 1e-8, f"{f}: {err.max():.3e} at step {int(err.max(axis=1).argmax()) + 1}"
  # the golden's states are mjtpu's too (same engine, committed run)
  np.testing.assert_allclose(after.qpos[-B:], np.load(GOLDEN)["qpos"][-1], rtol=0, atol=1e-10)


def test_trajectory_matches_golden(golden):
  m = mjtpu_torch.model_from_arrays(mjtpu_torch.load_snapshot(SNAPSHOT), device="cpu")
  d = mjtpu_torch.make_data(m, batch_size=B)
  d = mjtpu_torch.replace(d, qpos=torch.as_tensor(golden["qpos0"]),
                          qvel=torch.as_tensor(golden["qvel0"]),
                          ctrl=torch.as_tensor(golden["ctrl"]))
  hfield.launches = cholesky.launches = 0
  err = []
  for i in range(STEPS):
    d = mjtpu_torch.step(m, d)
    if i == 0:
      for f in ("qacc", "efc_force"):
        _assert_close(getattr(d, f).numpy(), golden[f], f"step 1 {f}", 1e-9)
      for f in ("dist", "pos", "frame"):
        _assert_close(getattr(d.contact, f).numpy(), golden[f"contact_{f}"], f"step 1 {f}", 1e-9)
    err.append(max(np.abs(d.qpos.numpy() - golden["qpos"][i]).max(),
                   np.abs(d.qvel.numpy() - golden["qvel"][i]).max()))
  assert hfield.launches == cholesky.launches == 0  # CPU tensors: the twins
  assert max(err) < TRAJECTORY_BOUND, (int(np.argmax(err)) + 1, max(err))
  assert int(d.nreset.sum()) == 0
