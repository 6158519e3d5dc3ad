"""The Implicit slice's data files (scripts/torch_port_assets.py), held to
their sources: the implicit and sensor scene bundles and the
humanoid_implicit snapshot against put_model of their MJCF, and fresh
mjtpu runs of one scene of each bundle and of humanoid_implicit."""

import mujoco
import numpy as np
import pytest

import mjtpu_torch
from mjtpu_torch._src import io
from tests.test_torch_assets import _assert_models_equal, _assets_script, _regenerate


def _expected_keys(mjm) -> list[str]:
  """The fields a snapshot of ``mjm`` stores: io.SNAPSHOT_FIELDS, and each
  optional group where the model has its feature."""
  extra = ((io.FRICTION_FIELDS if (mjm.dof_frictionloss > 0).any() else ())
           + (io.FLUID_FIELDS if io.has_fluid(mjm.opt) else ())
           + (io.GRAVCOMP_FIELDS if (mjm.body_gravcomp > 0).any() else ())
           + tuple(k for group, stored in io.OPTIONAL_GROUPS if stored(mjm) for k in group))
  return sorted(io.SNAPSHOT_FIELDS + extra)


@pytest.mark.parametrize("bundle", ["implicit", "sensor"])
def test_scene_snapshots_equal_put_model(bundle):
  """Each scene of the bundle, loaded, equals put_model of its MJCF; a
  scene's snapshot holds the contact sensor's, the camera intrinsics' and
  the geom-distance body fields only where it has such a sensor."""
  script = _assets_script()
  path = getattr(script, f"{bundle.upper()}_SCENES_FILE")
  xmls = getattr(script, f"{bundle}_scene_xmls")()
  seen = set()
  with np.load(path) as z:
    for name, xml in xmls.items():
      mjm = mujoco.MjModel.from_xml_string(xml)
      keys = [k for k in io._bundle_arrays(z, name) if not k.startswith(io.HULL_PREFIXES)]
      assert sorted(keys) == _expected_keys(mjm), name
      seen.update(k for k in keys if k in {**io.CONTACT_SENSOR_FIELDS, **io.CAMPROJ_FIELDS,
                                           **io.GEOMDIST_FIELDS})
      snap = mjtpu_torch.model_from_arrays(io.load_snapshot(path, name), device="cpu")
      _assert_models_equal(snap, mjtpu_torch.put_model(mjm, device="cpu"), name)
  if bundle == "sensor":
    assert seen == {*io.CONTACT_SENSOR_FIELDS, *io.CAMPROJ_FIELDS, *io.GEOMDIST_FIELDS}


def test_humanoid_implicit_snapshot_equals_put_model():
  script = _assets_script()
  mjm = script.load_humanoid_implicit_mjmodel()
  assert mjm.opt.integrator == mujoco.mjtIntegrator.mjINT_IMPLICIT
  snap = mjtpu_torch.model_from_arrays(
      mjtpu_torch.load_snapshot(script.HUMANOID_IMPLICIT_MODEL_FILE), device="cpu")
  _assert_models_equal(snap, mjtpu_torch.put_model(mjm, device="cpu"))


def _assert_fresh(new_path, old_path, prefix=""):
  """The regenerated golden's entries (one step) equal the committed ones
  (their first step where an entry has one a step)."""
  per_step = ("qpos", "qvel", "sensordata", "energy")
  with np.load(new_path) as new, np.load(old_path) as old:
    assert sorted(new.files) == sorted(k for k in old.files if k.startswith(prefix))
    for k in new.files:
      field = k[len(prefix):]
      want = old[k][:1] if field in per_step else old[k]
      np.testing.assert_allclose(new[k], want, rtol=0, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("bundle, name", [("implicit", "friction_tendon_implicit"),
                                          ("sensor", "camprojection")])
def test_scene_files_are_fresh(tmp_path, bundle, name):
  """Regenerating one small scene of each bundle (its first step)
  reproduces its snapshot in the bundle and its golden's entries."""
  script = _assets_script()
  scenes = getattr(script, f"{bundle.upper()}_SCENES_FILE")
  golden = getattr(script, f"{bundle.upper()}_GOLDEN_FILE")
  new_dir = _regenerate(tmp_path, "--model", f"{bundle}_scenes", "--scene", name, "--steps", "1")
  assert io.bundle_names(new_dir / scenes.name) == [name]
  with np.load(new_dir / scenes.name) as new, np.load(scenes) as old:
    a, b = io._bundle_arrays(new, name), io._bundle_arrays(old, name)
    assert sorted(a) == sorted(b)
    for k in a:
      np.testing.assert_array_equal(a[k], b[k], err_msg=k)
  _assert_fresh(new_dir / golden.name, golden, f"{name}.")


def test_humanoid_implicit_files_are_fresh(tmp_path):
  """Regenerating humanoid_implicit (one step) reproduces its snapshot and
  its golden's entries, qDeriv of step 1 among them."""
  script = _assets_script()
  new_dir = _regenerate(tmp_path, "--model", "humanoid_implicit", "--steps", "1")
  model = script.HUMANOID_IMPLICIT_MODEL_FILE
  with np.load(new_dir / model.name) as new, np.load(model) as old:
    assert sorted(new.files) == sorted(old.files)
    for k in new.files:
      np.testing.assert_array_equal(new[k], old[k], err_msg=k)
  _assert_fresh(new_dir / script.HUMANOID_IMPLICIT_GOLDEN_FILE.name,
                script.HUMANOID_IMPLICIT_GOLDEN_FILE)
