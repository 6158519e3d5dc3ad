"""Equality constraints, mocap bodies, ball-joint limits and the blocked LU
factor_solve (constraint._eq_rows and the ball rows of _limit_rows,
smooth.kinematics' mocap frames, smooth.rne_postconstraint's connect and
weld forces, smooth.factor_solve, the solver's equality zone) against
mjtpu at float64 on the CPU, and against MuJoCo C where mjtpu parts from
it (ROADMAP C11).

  * the equality scene bundle (equality_scenes.npz,
    equality_scenes_golden.npz, scripts/torch_port_assets.py): mocap.xml
    under Euler and ImplicitFast with moving targets, weld.xml,
    equality.xml with per-env eq_active, ball_free.xml under Euler and
    ImplicitFast, tests/test_blocks.py's two forests under ImplicitFast,
    tests/test_constraint.py's two ball-limit models,
    tests/test_limit_sensors.py's XML, a tendon equality, a tendon
    equality before a connect and a weld, two equality fuzz scenes
    (chip_smoke.equality_scene_errors, which phase 28 runs on the card):
    every body's frame at step 1 to 1e-14, its efc rows to 1e-10 of
    scale with mjtpu's row labels, qacc and efc_force to 1e-10 of scale,
    100 steps of qpos, qvel and act to 1e-8, sensordata to 1e-8 of each
    sensor's scale;
  * rne_postconstraint's cfrc_ext to 1e-10 of MuJoCo C's but for the
    world body's row, which C leaves at zero and the port and mjtpu give
    the floor contact's wrench (held to mjtpu's); mjtpu's equals C's where
    no connect, weld or contact between two trees acts, and parts from it
    where one does (ROADMAP C11);
  * mocap frames per env against MuJoCo C's mj_kinematics, the blocked LU
    against mjtpu's factor_solve(symmetric=False), eq_active per env, the
    ball limit's axis at zero rotation, and mocap_targets against
    tests/test_mocap.py's schedule.
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
from mjtpu._src import smooth as j_smooth
from mjtpu._src import support as j_support
from mjtpu_torch._src import io, smooth
from tests.test_torch_assets import _assets_script

torch.set_num_threads(1)

SCENES = mjtpu_torch.ASSETS / "equality_scenes.npz"
GOLDEN = mjtpu_torch.ASSETS / "equality_scenes_golden.npz"
NAMES = ("ball_free", "ball_free_implicitfast", "ball_limit_margin", "ball_limit_order",
         "eq_order", "equality", "forest_implicitfast", "fuzz_2", "fuzz_3", "limit_sensors",
         "mocap", "mocap_implicitfast", "tendon_coupled_implicitfast", "tendon_equality", "weld")
# where mjtpu's cfrc_ext parts from MuJoCo C's (ROADMAP C11): a connect or
# a weld (mjtpu applies its force at body1's frame of the first anchor on
# both bodies; eq_order: and reads it at rows a tendon equality shifts), or
# a contact between two trees (mocap.xml's ball on the payload)
C11_SCENES = ("eq_order", "equality", "fuzz_2", "fuzz_3", "mocap", "mocap_implicitfast", "weld")
# mjtpu's cfrc_ext against C's on those scenes is at least this, of scale
C11_GAP = 1e-2
LU_BOUND = 1e-12


@pytest.fixture(scope="module")
def golden():
  return dict(np.load(GOLDEN))


def _mjm(name):
  return mujoco.MjModel.from_xml_string(_assets_script().equality_scene_xmls()[name])


def test_bundle_holds_the_scenes():
  """The bundle's scenes are the script's, and the port's static row
  counts are mjtpu's, DisableBit.EQUALITY's too (no equality rows)."""
  assert tuple(io.bundle_names(SCENES)) == NAMES
  assert sorted(_assets_script().equality_scene_xmls()) == list(NAMES)
  for name in ("eq_order", "mocap", "ball_limit_order"):
    mjm = _mjm(name)
    for flags in (0, mujoco.mjtDisableBit.mjDSBL_EQUALITY):
      mjm.opt.disableflags = flags
      assert mjtpu_torch.count_constraints(mjtpu_torch.put_model(mjm, device="cpu")) == \
          j_support.count_constraints(mjtpu.put_model(mjm)), (name, flags)


@pytest.mark.parametrize("name", NAMES)
def test_scene_matches_mjtpu(golden, name):
  """Step 1's frames, efc rows, row labels, qacc and efc_force, and 100
  steps, against mjtpu's golden at the bounds of
  chip_smoke.equality_scene_errors; cfrc_ext against MuJoCo C's, and
  against mjtpu's where mjtpu agrees with C."""
  errs = chip_smoke.equality_scene_errors(name, golden, "cpu")
  bad = {k: v for k, v in errs.items()
         if chip_smoke.equality_bound(k) is not None and v > chip_smoke.equality_bound(k)}
  assert not bad, (name, bad)
  if name not in C11_SCENES:
    assert errs["cfrc.mjtpu"] <= chip_smoke.EQ_CFRC_BOUND, name


@pytest.mark.parametrize("name", C11_SCENES)
def test_cfrc_ext_follows_mujoco_c(golden, name):
  """ROADMAP C11: at each env's start state MuJoCo C's cfrc_ext (live,
  mj_forward then mj_rnePostConstraint) is the golden's, the port's is
  within 1e-10 of it, and mjtpu's parts from it by at least C11_GAP of
  scale."""
  mjm = _mjm(name)
  m, d = chip_smoke.equality_scene(name, golden, "cpu")
  d = chip_smoke._mocap_at(d, golden, name, 0)
  got = smooth.rne_postconstraint(m, mjtpu_torch.forward(m, d)).cfrc_ext.numpy()
  want = []
  for e in range(d.qpos.shape[0]):
    mjd = mujoco.MjData(mjm)
    for k in ("qpos", "qvel", "ctrl", "act", "eq_active", "mocap_pos", "mocap_quat"):
      getattr(mjd, k)[:] = getattr(d, k)[e].numpy().reshape(getattr(mjd, k).shape)
    mujoco.mj_forward(mjm, mjd)
    mujoco.mj_rnePostConstraint(mjm, mjd)
    want.append(np.array(mjd.cfrc_ext))
  want = np.stack(want)
  np.testing.assert_allclose(want, golden[f"{name}.c.cfrc_ext"], rtol=0, atol=1e-12)
  assert chip_smoke._scaled_err(got[:, 1:], want[:, 1:]) <= chip_smoke.EQ_CFRC_BOUND
  assert chip_smoke._scaled_err(golden[f"{name}.rnepost.cfrc_ext"], want) >= C11_GAP


@pytest.mark.parametrize("name", ("mocap", "mocap_implicitfast"))
def test_world_row_follows_mjtpu(golden, name):
  """ROADMAP C11: MuJoCo C leaves the world body's cfrc_ext row at zero;
  mjtpu gives it the wrench of the ball's floor contact in env 1, and the
  port gives it mjtpu's, to 1e-10 of scale, while its other rows are C's
  (test_cfrc_ext_follows_mujoco_c)."""
  m, d = chip_smoke.equality_scene(name, golden, "cpu")
  fwd = mjtpu_torch.forward(m, chip_smoke._mocap_at(d, golden, name, 0))
  got = smooth.rne_postconstraint(m, fwd).cfrc_ext[:, 0].numpy()
  want = golden[f"{name}.rnepost.cfrc_ext"][:, 0]
  assert not golden[f"{name}.c.cfrc_ext"][:, 0].any()
  assert (fwd.contact.dist[1] < 0).sum() == 1 and np.abs(want[1]).max() > 1.0
  assert chip_smoke._scaled_err(got, want) <= chip_smoke.EQ_CFRC_BOUND


def test_mocap_frames_follow_each_env():
  """Each env's mocap bodies take their frames from its own mocap_pos and
  mocap_quat (an unnormalized quaternion normalized), as MuJoCo C's
  mj_kinematics, to 1e-14."""
  mjm = _mjm("mocap")
  rng = np.random.default_rng(0)
  B = 3
  pos = rng.uniform(-1.0, 1.0, (B, mjm.nmocap, 3))
  quat = rng.uniform(-1.0, 1.0, (B, mjm.nmocap, 4))
  m = mjtpu_torch.put_model(mjm, device="cpu")
  d = mjtpu_torch.replace(mjtpu_torch.make_data(m, batch_size=B),
                          mocap_pos=torch.as_tensor(pos), mocap_quat=torch.as_tensor(quat))
  d = mjtpu_torch.kinematics(m, d)
  for e in range(B):
    mjd = mujoco.MjData(mjm)
    mjd.mocap_pos[:], mjd.mocap_quat[:] = pos[e], quat[e]
    mujoco.mj_kinematics(mjm, mjd)
    np.testing.assert_allclose(d.xpos[e].numpy(), mjd.xpos, rtol=0, atol=1e-14)
    np.testing.assert_allclose(d.xquat[e].numpy(), mjd.xquat, rtol=0, atol=1e-14)
  # make_data starts them at the model's frames, as mj_makeData
  d0 = mjtpu_torch.make_data(m, batch_size=2)
  mjd = mujoco.MjData(mjm)
  np.testing.assert_array_equal(d0.mocap_pos.numpy(), np.stack([mjd.mocap_pos] * 2))
  np.testing.assert_array_equal(d0.mocap_quat.numpy(), np.stack([mjd.mocap_quat] * 2))


@pytest.mark.parametrize("name", ["forest_implicitfast", "mocap_implicitfast"])
def test_blocked_lu_matches_mjtpu(golden, name):
  """smooth.factor_solve(symmetric=False) of a forest, per block size
  group, against mjtpu's (jax.scipy.linalg.lu_factor per block), on qM
  minus a nonsymmetric term within the blocks, to LU_BOUND of scale."""
  m = mjtpu_torch.model_from_arrays(io.load_snapshot(SCENES, name), device="cpu")
  jm = mjtpu.put_model(_mjm(name), dtype=jnp.float64)
  assert smooth.mass_blocks(m) is not None and smooth.mass_blocks(m) == j_smooth.mass_blocks(jm)
  rng = np.random.default_rng(1)
  qm = golden[f"{name}.fwd.qM"]
  pattern = np.zeros((m.nv, m.nv))
  for s, n in smooth.mass_blocks(m):
    pattern[s:s + n, s:s + n] = 1.0
  mat = qm - 0.01 * rng.uniform(-1.0, 1.0, qm.shape) * pattern
  rhs = rng.uniform(-1.0, 1.0, (qm.shape[0], m.nv))
  got = smooth.factor_solve(m, torch.as_tensor(mat), torch.as_tensor(rhs), symmetric=False)
  solve = jax.jit(jax.vmap(lambda a, b: j_smooth.factor_solve(jm, a, b, symmetric=False)))
  want = np.asarray(solve(jnp.asarray(mat), jnp.asarray(rhs)))
  assert chip_smoke._scaled_err(got.numpy(), want) <= LU_BOUND


def test_eq_active_gates_rows_per_env(golden):
  """equality.xml's connect is off in env 2 and its joint coupling in env
  3: those envs' rows of it have zero Jacobian, position and force, every
  other env's rows do not."""
  m, d = chip_smoke.equality_scene("equality", golden, "cpu")
  assert d.eq_active.tolist() == [[True, True], [True, True], [False, True], [True, False]]
  fwd = mjtpu_torch.forward(m, d)
  # rows 0-2 the connect's, row 3 the joint coupling's
  live = torch.stack([fwd.efc_J[:, :3].abs().amax(dim=(1, 2)), fwd.efc_J[:, 3].abs().amax(dim=1)],
                     dim=1) > 0
  assert live.tolist() == [[True, True], [True, True], [False, True], [True, False]]
  for e, eq in ((2, slice(0, 3)), (3, slice(3, 4))):
    assert not fwd.efc_pos[e, eq].any() and not fwd.efc_force[e, eq].any()


def test_ball_limit_axis_at_zero_rotation(golden):
  """ball_limit_margin's env 0 sits at zero rotation inside the margin
  band: its row is live with MuJoCo C's default axis, J = -(1, 0, 0)."""
  m, d = chip_smoke.equality_scene("ball_limit_margin", golden, "cpu")
  fwd = mjtpu_torch.forward(m, d)
  assert fwd.efc_J.shape[1] == 1 and float(fwd.efc_pos[0, 0]) < 0
  np.testing.assert_array_equal(fwd.efc_J[0, 0].numpy(), [-1.0, 0.0, 0.0])


def test_mocap_targets_follow_test_mocap():
  """chip_smoke.mocap_targets at phase 0 is tests/test_mocap.py's moving
  target schedule."""
  mjm = _mjm("mocap")
  base = np.array(mujoco.MjData(mjm).mocap_pos)
  for i in (0, 7, 60):
    t = i * float(mjm.opt.timestep)
    pos, quat = chip_smoke.mocap_targets(torch.as_tensor(base),
                                         torch.tensor([t], dtype=torch.float64))
    ang = 0.8 * t
    np.testing.assert_allclose(pos[0].numpy(), base + np.array([0.2 * np.sin(3 * t), 0.0, 0.1 * t]),
                               rtol=0, atol=1e-15)
    np.testing.assert_allclose(quat[0].numpy(), [[np.cos(ang / 2), 0.0, 0.0, np.sin(ang / 2)],
                                                 [1.0, 0.0, 0.0, 0.0]], rtol=0, atol=1e-15)


def test_put_data_carries_eq_active_and_mocap():
  """put_data takes each MjData's eq_active, mocap_pos and mocap_quat, and
  get_data_into writes them back with the frames they give."""
  mjm = _mjm("equality")
  mjds = [mujoco.MjData(mjm) for _ in range(2)]
  mjds[1].eq_active[0] = 0
  m = mjtpu_torch.put_model(mjm, device="cpu")
  d = mjtpu_torch.put_data(m, mjds)
  assert d.eq_active.tolist() == [[True, True], [False, True]]
  mjm = _mjm("mocap")
  mjds = [mujoco.MjData(mjm) for _ in range(2)]
  mjds[1].mocap_pos[0] += (0.1, -0.2, 0.3)
  mjds[1].mocap_quat[0] = (0.8, 0.0, 0.6, 0.0)
  m = mjtpu_torch.put_model(mjm, device="cpu")
  d = mjtpu_torch.kinematics(m, mjtpu_torch.put_data(m, mjds))
  out = [mujoco.MjData(mjm) for _ in range(2)]
  mjtpu_torch.get_data_into(out, m, d)
  for mjd, res in zip(mjds, out):
    mujoco.mj_kinematics(mjm, mjd)
    for f in ("mocap_pos", "mocap_quat", "xpos", "xquat"):
      np.testing.assert_allclose(getattr(res, f), getattr(mjd, f), rtol=0, atol=1e-15, err_msg=f)
