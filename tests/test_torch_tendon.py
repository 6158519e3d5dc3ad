"""Tendons and every actuator transmission (mjtpu_torch/_src/tendon_wrap.py,
smooth.tendon, tendon_armature and transmission, the tendon rows of
constraint.py, passive.py and sensor.py) against mjtpu at float64 on the
CPU.

  * the tendon scene bundle (tendon_scenes.npz, tendon_scenes_golden.npz,
    scripts/torch_port_assets.py): tests/test_tendon.py's mixed model,
    its sphere and cylinder wraps (no side site, outside, inside) and its
    pulley, friction_tendon.xml, muscle.xml, sensors.xml, the slider-crank
    and adhesion models of tests/test_transmission.py, and the tendon limit
    sensors (chip_smoke.tendon_scene_errors, which phase 26 runs on the
    card): ten_length, ten_J and ten_wrap_xpos at 40 seeded poses per wrap
    scene to 1e-12 of scale, ten_wrap_active exact; step 1's
    actuator_length, actuator_moment, act_dot, actuator_force and
    qfrc_passive to 1e-12 of scale, its efc rows to 1e-10 of scale; 100
    steps of qpos, qvel and act to 1e-8, sensordata to 1e-8 of each
    sensor's scale;
  * the site (with and without a reference site) and ball and free
    joint-in-parent transmissions and a two-sided tendon limit against
    mjtpu's fwd_position, live;
  * tendon_armature, factor_m and solve_m on tests/test_blocks.py's
    TENDON_COUPLED_XML against mjtpu and MuJoCo C's mj_solveM;
  * the static layout: row counts and labels equal mjtpu's.
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
from mjtpu_torch._src import io, smooth, support
from tests.test_torch_assets import _assets_script

torch.set_num_threads(1)

SCENES = mjtpu_torch.ASSETS / "tendon_scenes.npz"
GOLDEN = mjtpu_torch.ASSETS / "tendon_scenes_golden.npz"
NAMES = ("adhesion", "cylinder", "cylinder_side_in", "cylinder_side_out", "friction_tendon",
         "limit_sensors", "mixed", "muscle", "pulley", "sensors", "slidercrank", "sphere",
         "sphere_side_in", "sphere_side_out")
WRAPS = ("cylinder", "cylinder_side_in", "cylinder_side_out", "mixed", "pulley", "sphere",
         "sphere_side_in", "sphere_side_out")
STAGE_BOUND = 1e-12


@pytest.fixture(scope="module")
def golden():
  return dict(np.load(GOLDEN))


def test_bundle_holds_the_scenes():
  """The bundle's scenes are the script's; its mixed model is
  tests/test_tendon.py's; its limit-sensor scene is
  tests/test_limit_sensors.py's without the ball joint's limit."""
  script = _assets_script()
  assert tuple(io.bundle_names(SCENES)) == NAMES == tuple(sorted(script.tendon_scene_xmls()))
  assert tuple(sorted(script.WRAP_SCENES)) == WRAPS
  from tests.test_limit_sensors import XML
  from tests.test_tendon import _MIXED_XML

  assert script.TENDON_MIXED_XML == _MIXED_XML
  lim = script.limit_sensor_xml()
  assert lim != XML and 'joint="b"' not in lim and lim.count("<tendonlimit") == 3


@pytest.mark.parametrize("name", NAMES)
def test_scene_matches_mjtpu(golden, name):
  """Poses, step 1 and the 100-step trajectory against mjtpu's golden
  (chip_smoke.tendon_scene_errors), each within its bound; the wrap scenes
  wrap at some of their poses."""
  errs = chip_smoke.tendon_scene_errors(name, golden, "cpu")
  bad = {k: v for k, v in errs.items() if v > chip_smoke.tendon_bound(k)}
  assert not bad, bad
  assert ("pose.flags" in errs) == (name in WRAPS)
  assert golden[f"{name}.qpos"].shape[0] == 100
  if name in WRAPS and name != "cylinder_side_in":
    assert golden[f"{name}.poses.ten_wrap_active"].any(), name


def test_scenes_exercise_the_slice(golden):
  """Each scene reaches what it was built for: tendon friction and limit
  rows, tendon springs and dampers, activation states, the transmissions,
  the tendon sensors."""
  def model(name):
    return mjtpu_torch.model_from_arrays(io.load_snapshot(SCENES, name), device="cpu")

  mixed = model("mixed")
  assert len(mixed.friction_tenid) == 1 and mixed.has_tendon_spring and mixed.has_tendon_damping
  assert mixed.actuator_static_moment is None and mixed.nwrap == 5
  ne, nf, nl, nefc = support.count_constraints(mixed)
  assert (ne, nf, nl, nefc) == (0, 1, 1, 2)
  muscle = model("muscle")
  assert muscle.na == 5
  assert sorted(set(np.asarray(muscle.actuator_dyntype).tolist())) == [1, 2, 3, 4]
  assert np.abs(golden["muscle.fwd.act_dot"]).max() > 0.1
  for name, trn in (("slidercrank", 2), ("adhesion", 5), ("sensors", 3)):
    assert trn in np.asarray(model(name).actuator_trntype), name
  # the adhesion moment is not zero where the box touches, zero past margin + gap
  moment = np.abs(golden["adhesion.fwd.actuator_moment"]).sum(axis=(1, 2))
  assert (moment > 0).tolist() == [True, True, True, False]
  lim = model("limit_sensors")
  assert {int(t) for t in lim.sensor_type} >= {23, 24, 25}
  assert np.abs(golden["limit_sensors.sensordata"]).max() > 0


# a site transmission with and without a reference site, ball and free
# joints' joint-in-parent transmissions, and a fixed tendon whose range is
# narrower than 2 * margin (two limit rows, lower then upper)
TRANSMISSIONS_XML = """<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <body pos="0 0 1">
      <joint name="h" type="hinge" axis="0 1 0"/>
      <geom type="capsule" size="0.03" fromto="0 0 0 0.3 0 0"/>
      <site name="tip" pos="0.3 0 0" euler="10 20 30"/>
      <body pos="0.3 0 0">
        <joint name="ball" type="ball"/>
        <geom type="capsule" size="0.02" fromto="0 0 0 0.2 0 0"/>
        <site name="end" pos="0.2 0.05 0" euler="-20 5 40"/>
      </body>
    </body>
    <body pos="1 0 1">
      <freejoint name="free"/>
      <geom type="box" size="0.05 0.06 0.07"/>
    </body>
  </worldbody>
  <tendon>
    <fixed name="t" limited="true" range="-0.05 0.05" margin="0.2">
      <joint joint="h" coef="1"/>
    </fixed>
  </tendon>
  <actuator>
    <general site="tip" gear="1 0.5 0 0 0.2 0.3"/>
    <general site="end" refsite="tip" gear="0.4 -1 0.2 0.3 0 -0.5"/>
    <general joint="ball" gear="0.3 -0.2 0.6 0 0 0"/>
    <general jointinparent="ball" gear="0.3 -0.2 0.6 0 0 0"/>
    <general jointinparent="free" gear="1 2 3 0.4 -0.5 0.6"/>
    <general joint="free" gear="1 2 3 0.4 -0.5 0.6"/>
  </actuator>
</mujoco>"""


def test_transmissions_and_two_sided_tendon_limit_match_mjtpu():
  """fwd_position at 6 seeded states against mjtpu's: actuator_length and
  actuator_moment of every transmission kind, the tendon and its two limit
  rows, to 1e-12 of scale."""
  mjm = mujoco.MjModel.from_xml_string(TRANSMISSIONS_XML)
  rng = np.random.default_rng(0)
  batch = 6
  qpos = mjm.qpos0[None] + rng.uniform(-0.6, 0.6, (batch, mjm.nq))
  for q in qpos:
    mujoco.mj_normalizeQuat(mjm, q)
  jm = mjtpu.put_model(mjm, dtype=jnp.float64)
  jd = jax.vmap(lambda _: mjtpu.make_data(jm))(jnp.arange(batch)).replace(qpos=jnp.asarray(qpos))
  want = jax.tree.map(np.asarray, jax.jit(jax.vmap(mjtpu.fwd_position, in_axes=(None, 0)))(jm, jd))
  m = mjtpu_torch.put_model(mjm, device="cpu")
  assert support.tendon_limit_rows_per(m) == 2 and support.count_constraints(m)[2] == 2
  for a, b in zip(support.efc_row_meta(m), j_support.efc_row_meta(jm)):
    np.testing.assert_array_equal(a, b)
  d = mjtpu_torch.replace(mjtpu_torch.make_data(m, batch_size=batch), qpos=torch.as_tensor(qpos))
  got = mjtpu_torch.fwd_position(m, d)
  for f in ("actuator_length", "actuator_moment", "ten_length", "ten_J", "efc_J", "efc_pos"):
    err = chip_smoke._scaled_err(getattr(got, f).numpy(), getattr(want, f))
    assert err <= STAGE_BOUND, f"{f}: {err:.3e}"
  assert np.abs(want.actuator_length).min(axis=0)[[0, 4, 5]].max() == 0.0  # site, free: 0
  assert (want.efc_pos < 0).sum() > 0


def test_tendon_armature_factor_solve_match_mjtpu_and_c():
  """tendon_armature, factor_m and solve_m on TENDON_COUPLED_XML (three
  trees, a fixed tendon with armature across two of them): qM against
  mjtpu's, solve_m against mjtpu's and MuJoCo C's mj_solveM, to 1e-12 of
  scale; qM keeps the trees' blocks (C drops the cross-tree terms)."""
  from tests.test_blocks import TENDON_COUPLED_XML

  mjm = mujoco.MjModel.from_xml_string(TENDON_COUPLED_XML)
  mjd = mujoco.MjData(mjm)
  rng = np.random.default_rng(0)
  mjd.qpos[:] = mjm.qpos0 + rng.uniform(-0.2, 0.2, mjm.nq)
  mujoco.mj_forward(mjm, mjd)
  x = np.linspace(-1.0, 1.0, mjm.nv)
  c = np.zeros((1, mjm.nv))
  mujoco.mj_solveM(mjm, mjd, c, x.reshape(1, -1))
  jm = mjtpu.put_model(mjm, dtype=jnp.float64)

  @jax.jit
  def stages(qpos, x):
    jd = mjtpu.make_data(jm).replace(qpos=qpos)
    jd = mjtpu.crb(jm, mjtpu.tendon(jm, mjtpu.com_pos(jm, mjtpu.kinematics(jm, jd))))
    jd = mjtpu.factor_m(jm, mjtpu.tendon_armature(jm, jd))
    return jd.qM, mjtpu.solve_m(jm, jd, x)

  qm_want, want = (np.asarray(v) for v in stages(jnp.asarray(np.array(mjd.qpos)), jnp.asarray(x)))

  m = mjtpu_torch.put_model(mjm, device="cpu")
  assert m.has_tendon_armature and smooth.mass_blocks(m) == ((0, 1), (1, 1), (2, 1))
  d = mjtpu_torch.make_data(m, batch_size=1)
  d = mjtpu_torch.replace(d, qpos=torch.as_tensor(np.array(mjd.qpos))[None])
  d = smooth.crb(m, smooth.tendon(m, smooth.com_pos(m, smooth.kinematics(m, d))))
  d = smooth.tendon_armature(m, d)
  qm = d.qM[0].numpy()
  assert chip_smoke._scaled_err(qm, qm_want) <= STAGE_BOUND
  assert qm[0, 1] == qm[1, 0] == 0.0 and qm_want[0, 0] > mjm.body_mass[1]
  got = smooth.solve_m(m, smooth.factor_m(m, d), torch.as_tensor(x)[None])[0].numpy()
  assert chip_smoke._scaled_err(got, want) <= STAGE_BOUND
  assert chip_smoke._scaled_err(got, c[0]) <= STAGE_BOUND
