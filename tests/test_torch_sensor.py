"""The sensor stages of mjtpu_torch (sensor_pos, sensor_vel, sensor_acc,
with subtree_vel, rne_postconstraint and camlight) against mjtpu at
float64 on the CPU, on mjtpu's own sensor test models:

  * the frame-sensor matrix of tests/test_sensor.py (``_frame_matrix_xml``:
    220 frame sensors over 5 object types and 6 references, 2 cameras, a
    ball joint);
  * the accelerometer, touch-zone, insidesite and cutoff models of
    tests/test_sensor.py's test_accelerometer_static_body_zero,
    test_touch_zone_filtering, test_insidesite and
    test_cutoff_datatypes_vs_c (their XML strings are inside those test
    functions, so they are copied here; the touch model also with a
    max_contact_points cap, whose contact slots differ per env);
  * tests/test_limit_sensors.py's XML without its tendon, and with its
    ball joint unlimited (the port refuses ball-joint limits), so its
    limit sensors are the hinge's; Euler's implicit damping disabled, as
    the port refuses it on a model of two trees (forward does not reach
    it);
  * a camera and a light in each tracking mode.

One forward from the same states through both engines; sensordata, cacc,
cfrc_int, cfrc_ext, subtree_linvel, subtree_angmom and the camera and
light frames to 1e-10 of each field's scale.  put_model refuses a model
with a sensor type outside the slice by the type's name.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import mjtpu
import mjtpu_torch
from tests.test_limit_sensors import XML as LIMIT_XML
from tests.test_sensor import _frame_matrix_xml

torch.set_num_threads(1)

BOUND = 1e-10
FIELDS = ("sensordata", "cacc", "cfrc_int", "cfrc_ext", "subtree_linvel", "subtree_angmom",
          "cam_xpos", "cam_xmat", "light_xpos", "light_xdir")

# copied from tests/test_sensor.py::test_accelerometer_static_body_zero
ACCEL_XML = """<mujoco><worldbody>
    <geom type="plane" size="5 5 .1"/>
    <body name="ball" pos="0 0 0.09"><freejoint/><geom type="sphere" size="0.1"/>
      <site name="imu_free"/>
      <body name="rider" pos="0 0 0.1"><geom type="sphere" size="0.03"/>
        <site name="imu_rider"/></body>
    </body>
    <body name="fixed" pos="1 0 1"><geom type="sphere" size="0.1"/>
      <site name="imu_static"/></body>
  </worldbody>
  <sensor>
    <accelerometer site="imu_free"/>
    <accelerometer site="imu_rider"/>
    <accelerometer site="imu_static"/>
    <framelinacc objtype="site" objname="imu_static"/>
  </sensor></mujoco>"""

# copied from tests/test_sensor.py::test_touch_zone_filtering
TOUCH_XML = """<mujoco><worldbody>
    <geom type="plane" size="5 5 .1"/>
    <body pos="0 0 0.099">
      <freejoint/>
      <geom type="capsule" fromto="-0.3 0 0 0.3 0 0" size="0.1"/>
      <site name="s_end" type="box" pos="0.25 0 0" size="0.1 0.12 0.12"/>
      <site name="s_all" type="box" pos="0 0 0" size="0.5 0.2 0.2"/>
      <site name="s_sph" type="sphere" pos="-0.3 0 -0.05" size="0.08"/>
    </body></worldbody>
  <sensor><touch site="s_end"/><touch site="s_all"/><touch site="s_sph"/></sensor>
  </mujoco>"""

# copied from tests/test_sensor.py::test_insidesite
INSIDE_XML = """<mujoco>
  <worldbody>
    <site name="z1" type="box" pos="0 0 1" size="0.2 0.3 0.4" euler="10 20 0"/>
    <site name="z2" type="cylinder" pos="1 0 1" size="0.2 0.3 0" euler="0 30 0"/>
    <site name="z3" type="ellipsoid" pos="2 0 1" size="0.2 0.3 0.4"/>
    <site name="z4" type="capsule" pos="3 0 1" size="0.2 0.3 0"/>
    <site name="z5" type="sphere" pos="4 0 1" size="0.25"/>
    <body pos="0 0 1.2"><freejoint/><geom type="sphere" size="0.05"/>
      <site name="pt"/></body>
  </worldbody>
  <sensor>
    <insidesite site="z1" objtype="site" objname="pt"/>
    <insidesite site="z2" objtype="site" objname="pt"/>
    <insidesite site="z3" objtype="site" objname="pt"/>
    <insidesite site="z4" objtype="site" objname="pt"/>
    <insidesite site="z5" objtype="site" objname="pt"/>
  </sensor>
  </mujoco>"""
INSIDE_POINTS = ([0, 0, 1.2], [0.05, 0.1, 1.35], [1.1, 0, 1.1], [2.1, 0, 1.15],
                 [3, 0.05, 1.45], [3, 0, 1.55], [4.1, 0.1, 1.1], [4.2, 0.2, 1.2])

# copied from tests/test_sensor.py::test_cutoff_datatypes_vs_c
CUTOFF_XML = """
  <mujoco>
    <worldbody>
      <geom type="plane" size="3 3 0.1"/>
      <body pos="0 0 0.08">
        <freejoint/>
        <geom type="sphere" size="0.1" mass="1"/>
        <site name="s" type="sphere" size="0.25" zaxis="0 0 -1"/>
      </body>
      <body pos="2 0 1">
        <joint name="h" type="hinge" axis="0 1 0"/>
        <geom type="sphere" size="0.1" mass="1"/>
      </body>
    </worldbody>
    <sensor>
      <jointpos joint="h" cutoff="0.05"/>
      <jointpos joint="h"/>
      <rangefinder site="s" cutoff="0.001"/>
      <rangefinder site="s"/>
      <touch site="s" cutoff="1e-4"/>
      <touch site="s"/>
    </sensor>
  </mujoco>
  """

CAMLIGHT_XML = """<mujoco>
  <worldbody>
    <light name="fixed" pos="0 0 3" dir="0 0 -1"/>
    <body name="a" pos="0 0 1">
      <joint type="ball"/>
      <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.04" contype="0" conaffinity="0"/>
      <camera name="c_fixed" pos="0.1 0 0.2" euler="0.2 0.1 0"/>
      <camera name="c_track" mode="track" pos="0 -1 0.5" xyaxes="1 0 0 0 1 1"/>
      <camera name="c_trackcom" mode="trackcom" pos="0 -1 0.5" xyaxes="1 0 0 0 1 1"/>
      <camera name="c_target" mode="targetbody" target="b" pos="0.5 0.5 0.5"/>
      <camera name="c_targetcom" mode="targetbodycom" target="b" pos="-0.5 0.5 0.5"/>
      <light name="l_track" mode="track" pos="0 0 1" dir="0 0 -1"/>
      <light name="l_trackcom" mode="trackcom" pos="0 0 1" dir="0 0 -1"/>
      <light name="l_target" mode="targetbody" target="b" pos="1 0 1"/>
      <light name="l_targetcom" mode="targetbodycom" target="b" pos="-1 0 1"/>
      <body name="b" pos="0.3 0 0">
        <joint type="hinge" axis="0 1 0"/>
        <geom type="sphere" size="0.06" pos="0.1 0 0" contype="0" conaffinity="0"/>
      </body>
    </body>
  </worldbody>
  <sensor>
    <framepos objtype="camera" objname="c_target"/>
    <framequat objtype="camera" objname="c_targetcom"/>
    <framelinvel objtype="camera" objname="c_track"/>
    <subtreelinvel body="a"/>
    <subtreeangmom body="a"/>
    <clock/>
  </sensor>
</mujoco>"""


def _limit_xml():
  """test_limit_sensors.py's XML without the tendon, the ball joint's
  range and the limit sensors that read them, Euler's damping off."""
  xml = LIMIT_XML.split("<tendon>")[0] + "<sensor>" + LIMIT_XML.split("<sensor>")[1]
  xml = xml.replace(' range="0 0.4" margin="0.05"', "")
  xml = xml.replace('<option timestep="0.002"/>',
                    '<option timestep="0.002"><flag eulerdamp="disable"/></option>')
  keep = [ln for ln in xml.splitlines() if 'joint="b"' not in ln and "tendon" not in ln]
  return "\n".join(keep)


def _settled(mjm, steps=300):
  """The state after ``steps`` steps of MuJoCo C from qpos0 (a body
  resting on the floor), as (qpos, qvel)."""
  mjd = mujoco.MjData(mjm)
  for _ in range(steps):
    mujoco.mj_step(mjm, mjd)
  return np.array(mjd.qpos), np.array(mjd.qvel)


def _random(mjm, n, seed, kick):
  rng = np.random.default_rng(seed)
  return (mjm.qpos0 + rng.uniform(-kick, kick, (n, mjm.nq)),
          rng.uniform(-0.5, 0.5, (n, mjm.nv)))


def _states(name, mjm):
  """(qpos, qvel) (B, ...) for each model: settled bodies for the contact
  models (with a velocity kick in the second env), the insidesite
  points, random states otherwise."""
  if name in ("accelerometer", "touch", "touch_capped", "cutoff"):
    q, v = _settled(mjm)
    q2, v2 = q.copy(), v + np.random.default_rng(1).uniform(-0.3, 0.3, mjm.nv)
    qpos, qvel = np.stack([q, q2]), np.stack([v, v2])
    if name == "cutoff":  # the hinge past its jointpos cutoff
      qpos[:, mjm.jnt_qposadr[1]] = (0.3, -0.2)
    return qpos, qvel
  if name == "insidesite":
    qpos = np.tile(mjm.qpos0, (len(INSIDE_POINTS), 1))
    qpos[:, :3] = INSIDE_POINTS
    return qpos, np.zeros((len(INSIDE_POINTS), mjm.nv))
  return _random(mjm, 3, 0, 0.4)


def _capped(xml):
  return xml.replace("<worldbody>", '<custom><numeric name="max_contact_points" data="1"/>'
                     "</custom><worldbody>", 1)


MODELS = {
    "frame_matrix": _frame_matrix_xml,
    "accelerometer": lambda: ACCEL_XML,
    "touch": lambda: TOUCH_XML,
    "touch_capped": lambda: _capped(TOUCH_XML),
    "insidesite": lambda: INSIDE_XML,
    "cutoff": lambda: CUTOFF_XML,
    "limits": _limit_xml,
    "camlight": lambda: CAMLIGHT_XML,
}


def _mjtpu_forward(mjm, qpos, qvel):
  """mjtpu's forward of each env (one jit of the unbatched forward, which
  compiles faster than the vmapped one): (Data before, Data after), numpy
  leaves with a leading env axis."""
  m = mjtpu.put_model(mjm, dtype=jnp.float64)
  fwd = jax.jit(mjtpu.forward)
  before, after = [], []
  for b in range(len(qpos)):
    d = mjtpu.make_data(m).replace(qpos=jnp.asarray(qpos[b]), qvel=jnp.asarray(qvel[b]),
                                   time=jnp.asarray(0.25 * (b + 1)))
    before.append(d)
    after.append(fwd(m, d))
  stack = lambda ds: jax.tree.map(lambda *x: np.stack([np.asarray(a) for a in x]), *ds)
  return stack(before), stack(after)


@pytest.mark.parametrize("name", list(MODELS))
def test_sensors_match_mjtpu(name):
  mjm = mujoco.MjModel.from_xml_string(MODELS[name]())
  qpos, qvel = _states(name, mjm)
  before, want = _mjtpu_forward(mjm, qpos, qvel)
  m = mjtpu_torch.put_model(mjm, device="cpu")
  got = mjtpu_torch.data_to_numpy(
      mjtpu_torch.forward(m, mjtpu_torch.data_from_mjtpu(before, device="cpu")))
  for f in FIELDS:
    a, b = getattr(got, f), getattr(want, f)
    assert a.shape == b.shape, (f, a.shape, b.shape)
    if not b.size:
      continue
    scale = max(1.0, float(np.abs(b).max()))
    err = float(np.abs(a - b).max())
    assert err <= BOUND * scale, f"{name} {f}: max abs err {err:.3e} (scale {scale:.3g})"
  # the inputs exercise what they are for
  sd = want.sensordata
  if name in ("touch", "touch_capped"):
    assert (sd > 1.0).sum() >= 4 and np.abs(want.cfrc_ext).max() > 1.0
  if name == "insidesite":
    assert sd.sum() >= 5
  if name == "cutoff":
    assert np.abs(sd[:, 0]).max() <= 0.05 and np.abs(sd[:, 1]).min() > 0.05
    assert (sd[:, 2] <= 0.001).all() and (sd[:, 3] > 0.001).all()
  if name == "limits":
    assert np.abs(sd).max() > 0.0 or mjtpu_torch.count_constraints(m)[2] > 0


def test_limit_sensors_read_live_rows():
  """With the hinge inside its margin the limit sensors read its row."""
  mjm = mujoco.MjModel.from_xml_string(_limit_xml())
  qpos = np.tile(mjm.qpos0, (2, 1))
  qpos[:, 0] = (0.45, -0.3)  # within the 0.1 margin of 0.5; well inside
  qvel = np.full((2, mjm.nv), 0.2)
  before, want = _mjtpu_forward(mjm, qpos, qvel)
  m = mjtpu_torch.put_model(mjm, device="cpu")
  got = mjtpu_torch.forward(m, mjtpu_torch.data_from_mjtpu(before, device="cpu"))
  np.testing.assert_allclose(got.sensordata.numpy(), want.sensordata, rtol=0, atol=BOUND)
  assert np.all(want.sensordata[0] != 0) and np.all(want.sensordata[1] == 0)


def test_sensor_disable_flag_and_empty_model():
  """DisableBit.SENSOR leaves sensordata as it was; a model without
  sensors has an empty sensordata."""
  mjm = mujoco.MjModel.from_xml_string(TOUCH_XML)
  mjm.opt.disableflags |= mujoco.mjtDisableBit.mjDSBL_SENSOR
  m = mjtpu_torch.put_model(mjm, device="cpu")
  d = mjtpu_torch.make_data(m, batch_size=2)
  d = mjtpu_torch.replace(d, sensordata=torch.full_like(d.sensordata, 7.0))
  assert bool((mjtpu_torch.forward(m, d).sensordata == 7.0).all())
  empty = mjtpu_torch.put_model(mujoco.MjModel.from_xml_string(
      '<mujoco><worldbody><body><joint/><geom size="0.1"/></body></worldbody></mujoco>'),
      device="cpu")
  assert mjtpu_torch.forward(empty, mjtpu_torch.make_data(empty, 2)).sensordata.shape == (2, 0)


UNPORTED = {
    "E_POTENTIAL": "<framepos objtype='body' objname='b'/><e_potential/>",
    "E_KINETIC": "<e_kinetic/>",
    "GEOMDIST": "<distance geom1='g1' geom2='g2'/>",
    "CAMPROJECTION": "<camprojection site='s' camera='c'/>",
    "CONTACT": "<contact geom1='g1'/>",
    "USER": "<user dim='1' needstage='pos' objtype='body' objname='b'/>",
}


@pytest.mark.parametrize("stype", list(UNPORTED))
def test_unported_sensor_refused_by_name(stype):
  """USER sensors stay refused by name; the other five types, refused
  until the Implicit slice, build and run a forward (their values are
  held to mjtpu by tests/test_torch_query_sensors.py)."""
  xml = f"""<mujoco><worldbody>
    <camera name="c" pos="0 -2 1" xyaxes="1 0 0 0 1 2"/>
    <geom name="g1" type="plane" size="2 2 0.1"/>
    <body name="b" pos="0 0 0.5"><freejoint/><geom name="g2" type="sphere" size="0.1"/>
      <site name="s"/></body></worldbody>
    <sensor>{UNPORTED[stype]}</sensor></mujoco>"""
  mjm = mujoco.MjModel.from_xml_string(xml)
  if stype == "USER":
    with pytest.raises(NotImplementedError, match=f"{stype} sensors"):
      mjtpu_torch.put_model(mjm, device="cpu")
    return
  m = mjtpu_torch.put_model(mjm, device="cpu")
  d = mjtpu_torch.forward(m, mjtpu_torch.make_data(m, batch_size=2))
  assert d.sensordata.shape == (2, mjm.nsensordata) and bool(torch.isfinite(d.sensordata).all())
