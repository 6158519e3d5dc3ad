"""The equality scene bundle (scripts/torch_port_assets.py), held to its
sources: put_model of each scene's MJCF, and a fresh mjtpu run of the
mocap scene."""

import mujoco
import numpy as np

import mjtpu_torch
from mjtpu_torch._src import io
from tests.test_torch_assets import _assert_models_equal, _assets_script, _regenerate


def test_equality_scene_snapshots_equal_put_model():
  """Each scene of the equality bundle, loaded, equals put_model of its
  MJCF; a scene's snapshot holds the equality fields where it has an
  equality constraint (io.EQ_FIELDS), the mocap index where it has a mocap
  body (io.MOCAP_FIELDS), the tendon, activation and friction-row fields
  where they apply, and nothing else past io.SNAPSHOT_FIELDS and the hull
  tables."""
  script = _assets_script()
  with np.load(script.EQUALITY_SCENES_FILE) as z:
    for name, xml in script.equality_scene_xmls().items():
      mjm = mujoco.MjModel.from_xml_string(xml)
      keys = [k for k in io._bundle_arrays(z, name) if not k.startswith(io.HULL_PREFIXES)]
      assert sorted(keys) == sorted(
          io.SNAPSHOT_FIELDS + (tuple(io.TENDON_FIELDS) if mjm.ntendon else ())
          + (tuple(io.ACT_FIELDS) if io.has_act_fields(mjm) else ())
          + (io.FRICTION_FIELDS if (mjm.dof_frictionloss > 0).any() else ())
          + (tuple(io.EQ_FIELDS) if mjm.neq else ())
          + (tuple(io.MOCAP_FIELDS) if mjm.nmocap else ())), name
      snap = mjtpu_torch.model_from_arrays(io.load_snapshot(script.EQUALITY_SCENES_FILE, name),
                                           device="cpu")
      _assert_models_equal(snap, mjtpu_torch.put_model(mjm, device="cpu"), name)


def test_equality_files_are_fresh(tmp_path):
  """Regenerating the mocap scene (mjtpu compiles one step and one
  rne_postconstraint; its first step) reproduces its snapshot in the
  bundle and its golden's entries: the start with the ball in contact,
  the first step's mocap targets, MuJoCo C's cfrc_ext and the row
  labels."""
  script = _assets_script()
  name = "mocap"
  new_dir = _regenerate(tmp_path, "--model", "equality_scenes", "--scene", name, "--steps", "1")
  assert io.bundle_names(new_dir / script.EQUALITY_SCENES_FILE.name) == [name]
  with np.load(new_dir / script.EQUALITY_SCENES_FILE.name) as new, \
      np.load(script.EQUALITY_SCENES_FILE) as old:
    a, b = io._bundle_arrays(new, name), io._bundle_arrays(old, name)
    assert sorted(a) == sorted(b)
    for k in a:
      np.testing.assert_array_equal(a[k], b[k], err_msg=k)
  per_step = ("qpos", "qvel", "mocap_pos", "mocap_quat")
  with np.load(new_dir / script.EQUALITY_GOLDEN_FILE.name) as new, \
      np.load(script.EQUALITY_GOLDEN_FILE) as old:
    assert sorted(new.files) == sorted(k for k in old.files if k.startswith(f"{name}."))
    assert f"{name}.c.cfrc_ext" in new.files and f"{name}.mocap_pos" in new.files
    for k in new.files:
      want = old[k][:1] if k.split(".")[1] in per_step else old[k]
      np.testing.assert_allclose(new[k], want, rtol=0, atol=1e-12, err_msg=k)
