"""The fluid scene bundle and the swimmer and satellite env golden
(scripts/torch_port_assets.py), held to their sources: put_model of each
scene's MJCF, and a fresh mjtpu run of the cheapest scene and env."""

import mujoco
import numpy as np

import mjtpu_torch
from mjtpu_torch._src import io
from tests.test_torch_assets import _assert_models_equal, _assets_script, _regenerate


def test_fluid_scene_snapshots_equal_put_model():
  """Each scene of the fluid bundle, loaded, equals put_model of its MJCF;
  a scene's snapshot holds the ellipsoid fluid coefficients where it has
  fluid forces (io.FLUID_FIELDS) and the actuator-channel flag where it
  has gravity compensation (io.GRAVCOMP_FIELDS), and nothing else past
  io.SNAPSHOT_FIELDS."""
  script = _assets_script()
  with np.load(script.FLUID_SCENES_FILE) as z:
    for name, xml in script.fluid_scene_xmls().items():
      mjm = mujoco.MjModel.from_xml_string(xml)
      fluid = io.has_fluid(mjm.opt)
      gravcomp = bool((mjm.body_gravcomp > 0).any())
      assert sorted(io._bundle_arrays(z, name)) == sorted(
          io.SNAPSHOT_FIELDS + (io.FLUID_FIELDS if fluid else ())
          + (io.GRAVCOMP_FIELDS if gravcomp else ())), name
      snap = mjtpu_torch.model_from_arrays(io.load_snapshot(script.FLUID_SCENES_FILE, name),
                                           device="cpu")
      _assert_models_equal(snap, mjtpu_torch.put_model(mjm, device="cpu"), name)
      assert snap.opt.has_fluid_params == fluid and snap.has_gravcomp == gravcomp


def test_fluid_and_env_files_are_fresh(tmp_path):
  """Regenerating the cheapest fluid scene (gravcomp_noact: mjtpu compiles
  one step) and the satellite env (one env step) reproduces their
  snapshot, the fluid golden's first step and the env golden's first
  env step."""
  script = _assets_script()
  scene, env = "gravcomp_noact", "satellite"
  new_dir = _regenerate(tmp_path, "--model", "fluid_scenes", "--scene", scene,
                        "--model", "satellite_envs", "--env", env, "--steps", "1")
  with np.load(new_dir / script.FLUID_SCENES_FILE.name) as new, \
      np.load(script.FLUID_SCENES_FILE) as old:
    a, b = io._bundle_arrays(new, scene), io._bundle_arrays(old, scene)
    assert sorted(a) == sorted(b)
    for k in a:
      np.testing.assert_array_equal(a[k], b[k], err_msg=k)
  per_step = {"fluid": ("qpos", "qvel"), "env": ("action", "obs", "reward", "done", "steps")}
  for kind, name, path in (("fluid", scene, script.FLUID_GOLDEN_FILE),
                           ("env", env, script.SATELLITE_ENV_GOLDEN_FILE)):
    with np.load(new_dir / path.name) as new, np.load(path) as old:
      assert sorted(new.files) == sorted(k for k in old.files if k.startswith(f"{name}."))
      for k in new.files:
        want = old[k][:1] if k.split(".")[1] in per_step[kind] else old[k]
        np.testing.assert_allclose(new[k], want, rtol=0, atol=1e-12, err_msg=k)
  with np.load(script.SATELLITE_ENV_GOLDEN_FILE) as old:
    assert sorted({k.split(".")[0] for k in old.files}) == sorted(script.SATELLITE_ENVS)
