"""The energy (EnableBit.ENERGY, smooth.energy_pos and energy_vel) and the
last seven sensor types mjtpu computes (E_POTENTIAL, E_KINETIC, GEOMDIST,
GEOMNORMAL, GEOMFROMTO, CAMPROJECTION, CONTACT) against mjtpu at float64
on the CPU, from the committed goldens.

  * the sensor scene bundle (sensor_scenes.npz, sensor_scenes_golden.npz,
    scripts/torch_port_assets.py): tests/test_energy.py's XML with the
    energy flag and its spring- and gravity-disable variants, its
    SENSOR_XML (the energy sensors without the flag and with it), tests/test_geomdist.py's
    XML with a box-box and a box-cylinder pair added, tests/test_contact_sensor.py's
    XML static and sliding, tests/test_sensor.py's CAMPROJECTION cameras
    (chip_smoke.slice14_errors, which phase 30 runs on the card): step 1's
    energy and sensors to 1e-10 of scale, CONTACT's found exact, 100
    steps of qpos and qvel to 1e-8, sensordata to 1e-8 of each sensor's
    scale and energy of its scale; a contact sensor over a box lying flat
    may pick another of the tied corners (ROADMAP C13) only where a copy
    of the state a few ULP away takes mjtpu's pick;
  * the public energy and geom_distance functions; the energy flag beside
    the energy sensors (mjtpu's lazy kinetic energy);
  * the box-cylinder distance, where mjtpu parts from MuJoCo C (its
    inscribed cylinder hull, ROADMAP C16).
"""

import mujoco
import numpy as np
import pytest
import torch

import chip_smoke
import mjtpu_torch
from mjtpu_torch._src import io
from mjtpu_torch._src.types import ObjType, SensorType
from tests.test_torch_assets import _assets_script

torch.set_num_threads(1)

SCENES = mjtpu_torch.ASSETS / "sensor_scenes.npz"
GOLDEN = mjtpu_torch.ASSETS / "sensor_scenes_golden.npz"
NAMES = ("camprojection", "contact", "energy", "energy_flag_sensors", "energy_nogravity",
         "energy_nospring", "energy_sensors", "geomdist")
# MuJoCo C's box-cylinder distance parts from mjtpu's by at least this
# (ROADMAP C16)
C16_GAP = 1e-3


@pytest.fixture(scope="module")
def golden():
  return dict(np.load(GOLDEN))


def _sensor(m, stype, g1, g2):
  """The address of the sensor of type stype between geoms g1 and g2."""
  for i in range(m.nsensor):
    if (int(m.sensor_type[i]) == stype and int(m.sensor_objid[i]) == g1
        and int(m.sensor_refid[i]) == g2):
      return int(m.sensor_adr[i])
  raise KeyError((stype, g1, g2))


def test_bundle_holds_the_scenes():
  assert tuple(io.bundle_names(SCENES)) == NAMES
  assert sorted(_assets_script().sensor_scene_xmls()) == list(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_scene_matches_mjtpu(golden, name):
  """Step 1's energy and sensors, CONTACT's found, and 100 steps against
  mjtpu's golden at the bounds of chip_smoke.slice14_errors; only the
  contact scene meets ties (ROADMAP C13), each taken by a ULP copy."""
  errs = chip_smoke.slice14_errors("sensor", name, golden, "cpu")
  bad = chip_smoke.slice14_over(errs)
  assert not bad, (name, bad)
  assert errs["ties"] == 0 or name == "contact", errs["ties"]


def test_energy_functions(golden):
  """potential_energy and kinetic_energy against mjtpu's energy at step 1,
  with the flag and without it (energy_pos and energy_vel write the two
  columns; make_data zeroes them)."""
  for name in ("energy", "energy_nospring", "energy_nogravity"):
    m, d = chip_smoke.slice14_scene("sensor", name, golden, "cpu")
    assert not d.energy.any()
    fwd = mjtpu_torch.forward(m, d)
    want = golden[f"{name}.fwd.energy"]
    got = torch.stack([mjtpu_torch.potential_energy(m, fwd),
                       mjtpu_torch.kinetic_energy(m, fwd)], dim=-1).numpy()
    assert chip_smoke._scaled_err(got, want) <= chip_smoke.SLICE14_STEP_BOUND, name
    assert np.abs(want).min() > 0.0 or name != "energy"
    blank = mjtpu_torch.replace(fwd, energy=torch.zeros_like(fwd.energy))
    e = mjtpu_torch.energy_vel(m, mjtpu_torch.energy_pos(m, blank)).energy
    np.testing.assert_array_equal(e.numpy(), got)


def test_energy_flag_beside_energy_sensors(golden):
  """With EnableBit.ENERGY on (the energy_flag_sensors scene), E_KINETIC
  reads the previous step's kinetic energy, fresh on the first call
  (energy[1] is 0 after make_data): in mjtpu's golden and the port's run
  alike (test_scene_matches_mjtpu holds them to each other)."""
  name = "energy_flag_sensors"
  m, d = chip_smoke.slice14_scene("sensor", name, golden, "cpu")
  assert m.opt.enableflags & mjtpu_torch.EnableBit.ENERGY
  ke = _sensor(m, SensorType.E_KINETIC, -1, -1)
  sd, energy = golden[f"{name}.sensordata"], golden[f"{name}.energy"]
  np.testing.assert_array_equal(sd[1:, :, ke], energy[:-1, :, 1])
  assert not np.allclose(sd[:, :, ke], energy[:, :, 1])
  fwd = mjtpu_torch.forward(m, d)
  np.testing.assert_allclose(fwd.sensordata[:, ke].numpy(), fwd.energy[:, 1].numpy(), rtol=0,
                             atol=1e-12)


def test_geom_distance(golden):
  """mjtpu_torch.geom_distance of the box-box pair (SAT, kernel B3's twin
  here) equals the scene's distance and fromto sensors at step 1; the
  geom-distance sensors take geom and body operands, and the one with
  cutoff 0 reads 0 (nothing penetrates)."""
  mjm = mujoco.MjModel.from_xml_string(_assets_script().sensor_scene_xmls()["geomdist"])
  g3, g4 = (mujoco.mj_name2id(mjm, mujoco.mjtObj.mjOBJ_GEOM, n) for n in ("box3", "box4"))
  m, d = chip_smoke.slice14_scene("sensor", "geomdist", golden, "cpu")
  fwd = mjtpu_torch.forward(m, d)
  dist, fromto = mjtpu_torch.geom_distance(m, fwd, g3, g4, 2.0)
  sd = golden["geomdist.fwd.sensordata"]
  a = _sensor(m, SensorType.GEOMDIST, g3, g4)
  b = _sensor(m, SensorType.GEOMFROMTO, g3, g4)
  np.testing.assert_allclose(dist.numpy(), sd[:, a], rtol=0, atol=1e-12)
  np.testing.assert_allclose(fromto.numpy(), sd[:, b:b + 6], rtol=0, atol=1e-12)
  assert (sd[:, a] > 0).all() and (sd[:, a] < 2.0).all()
  kinds = {(int(t), int(o)) for t, o in zip(m.sensor_type, m.sensor_objtype)}
  assert (int(SensorType.GEOMDIST), int(ObjType.BODY)) in kinds
  assert (int(SensorType.GEOMDIST), int(ObjType.GEOM)) in kinds
  zero = [i for i in range(m.nsensor) if int(m.sensor_type[i]) == SensorType.GEOMDIST
          and float(m.sensor_cutoff[i]) == 0.0]
  assert zero and not golden["geomdist.sensordata"][:, :, [int(m.sensor_adr[i]) for i in zero]].any()


def test_contact_sensor_modes():
  """The contact scene's sensors cover every criterion (none, geom, body,
  subtree, site) and every reduce mode (none, mindist, maxforce,
  netforce); test_scene_matches_mjtpu holds them."""
  mjm = mujoco.MjModel.from_xml_string(_assets_script().sensor_scene_xmls()["contact"])
  m = mjtpu_torch.put_model(mjm, device="cpu")
  contact = np.asarray(m.sensor_type) == SensorType.CONTACT
  assert contact.all()
  assert {int(x) for x in np.asarray(m.sensor_intprm)[:, 1]} == {0, 1, 2, 3}
  assert {int(x) for x in np.asarray(m.sensor_objtype)} >= {
      int(ObjType.GEOM), int(ObjType.BODY), int(ObjType.XBODY), int(ObjType.SITE)}


def test_box_cylinder_distance_follows_mjtpu(golden):
  """ROADMAP C16: mjtpu collides a cylinder as its inscribed hull, so its
  box-cylinder distance parts from MuJoCo C's (mj_geomDistance) by more
  than C16_GAP at the scene's start states; the port's is mjtpu's, to
  1e-10 (test_scene_matches_mjtpu), through the same hull."""
  mjm = mujoco.MjModel.from_xml_string(_assets_script().sensor_scene_xmls()["geomdist"])
  g3 = mujoco.mj_name2id(mjm, mujoco.mjtObj.mjOBJ_GEOM, "box3")
  g5 = mujoco.mj_name2id(mjm, mujoco.mjtObj.mjOBJ_GEOM, "cyl5")
  m = mjtpu_torch.put_model(mjm, device="cpu")
  a = _sensor(m, SensorType.GEOMDIST, g3, g5)
  want = golden["geomdist.fwd.sensordata"][:, a]
  gap = 0.0
  for e in range(want.shape[0]):
    mjd = mujoco.MjData(mjm)
    mjd.qpos[:], mjd.qvel[:] = golden["geomdist.qpos0"][e], golden["geomdist.qvel0"][e]
    mujoco.mj_forward(mjm, mjd)
    gap = max(gap, abs(float(mjd.sensordata[a]) - float(want[e])))
  assert gap > C16_GAP


@pytest.mark.parametrize("where", ["forward", "step"])
def test_nan_in_a_sensor_fails_its_bound(golden, monkeypatch, where):
  """A NaN in one sensordata column, of the port's forward or of every env
  at step 50 (and so of that step's ULP copies too), is over its bound:
  slice14_errors gives inf there, never a NaN that compares False."""
  name = "camprojection"
  m, d0 = chip_smoke.slice14_scene("sensor", name, golden, "cpu")
  col, t50 = int(m.sensor_adr[0]), d0.time + 50 * m.opt.timestep
  real = getattr(mjtpu_torch, where)

  def planted(m, d):
    out = real(m, d)
    hit = (torch.ones_like(d.time, dtype=torch.bool) if where == "forward"
           else (d.time - t50[0]).abs() < 0.5 * m.opt.timestep)
    sd = out.sensordata.clone()
    sd[:, col] = torch.where(hit, torch.nan, sd[:, col])
    return mjtpu_torch.replace(out, sensordata=sd)

  monkeypatch.setattr(mjtpu_torch, where, planted)
  errs = chip_smoke.slice14_errors("sensor", name, golden, "cpu")
  key = "fwd.sensordata" if where == "forward" else "trajectory.sensordata"
  assert errs[key] == np.inf and errs["ties"] == 0, errs
  assert set(chip_smoke.slice14_over(errs)) == {key}
