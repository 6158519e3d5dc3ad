"""Slice 17's data files (scripts/torch_port_assets.py --model
render_scenes, --model pixel_envs), held to their sources: the render
scenes' snapshots against put_model of their MjModel and their starts
against the script's; one scene's golden and the pixel envs' snapshots
and one env's start regenerated by mjtpu; every physics array of
pixel_env_models.npz equal to the plain zoo snapshot's; and the snapshots
of models with a camera, which gained the render fields, equal to a fresh
snapshot of their MjModel in every field."""

import mujoco
import numpy as np
import pytest

import mjtpu_torch
from mjtpu_torch._src import io
from tests.test_torch_assets import _assert_models_equal, _assets_script, _regenerate

PER_STEP = ("obs", "reward", "done", "steps", "pixels", "depth", "seg")


def test_render_scene_snapshots_equal_put_model():
  script = _assets_script()
  path = script.RENDER_SCENES_FILE
  assert io.bundle_names(path) == sorted(script.render_scene_xmls())
  with np.load(script.RENDER_GOLDEN_FILE) as golden:
    for name in io.bundle_names(path):
      mjm = script.render_scene_mjmodel(name)
      snap = mjtpu_torch.model_from_arrays(io.load_snapshot(path, name), device="cpu")
      _assert_models_equal(snap, mjtpu_torch.put_model(mjm, device="cpu"), name)
      assert not snap.render_filled
      np.testing.assert_array_equal(golden[f"{name}.qpos"], script.render_initial_state(mjm))


@pytest.fixture(scope="module")
def regenerated(tmp_path_factory):
  """One run of the script: two views of the camera-on-a-body render scene
  (mjtpu's renders with shadows and with supersampling), the pixel env
  models and satellite_small's pixel env start."""
  return _regenerate(tmp_path_factory.mktemp("slice17"), "--model", "render_scenes", "--scene",
                     "camera_body", "--view", "shadows", "--view", "ssaa", "--model",
                     "pixel_envs", "--env", "satellite_small", "--steps", "0")


def test_render_golden_is_fresh(regenerated):
  """The regenerated camera-on-a-body scene reproduces its snapshot, its
  start and its golden entries of those views."""
  script = _assets_script()
  new_dir = regenerated
  name = "camera_body"
  with np.load(new_dir / script.RENDER_SCENES_FILE.name) as new, \
       np.load(script.RENDER_SCENES_FILE) as old:
    a, b = io._bundle_arrays(new, name), io._bundle_arrays(old, name)
    assert sorted(a) == sorted(b)
    for k in a:
      np.testing.assert_array_equal(a[k], b[k], err_msg=k)
  with np.load(new_dir / script.RENDER_GOLDEN_FILE.name) as new, \
       np.load(script.RENDER_GOLDEN_FILE) as old:
    assert sorted(k for k in new.files if k != "views") == sorted(
        k for k in old.files if k.startswith((f"{name}.qpos", f"{name}.shadows.",
                                              f"{name}.ssaa.")))
    for k in new.files:
      if k != "views":
        np.testing.assert_allclose(new[k], old[k], rtol=0, atol=1e-12, err_msg=k)


def test_pixel_env_files_are_fresh(regenerated):
  """The regenerated pixel env models and satellite_small's start
  reproduce the bundle and the golden's start (pixels, depth, seg, obs)."""
  script = _assets_script()
  new_dir = regenerated
  path = script.PIXEL_ENV_MODELS_FILE
  assert io.bundle_names(path) == sorted(script.PIXEL_MODELS)
  with np.load(new_dir / path.name) as new, np.load(path) as old:
    for name in script.PIXEL_MODELS:
      a, b = io._bundle_arrays(new, name), io._bundle_arrays(old, name)
      assert sorted(a) == sorted(b), name
      for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name} {k}")
  with np.load(new_dir / script.PIXEL_ENV_GOLDEN_FILE.name) as new, \
       np.load(script.PIXEL_ENV_GOLDEN_FILE) as old:
    for k in new.files:
      want = old[k][:1] if k.split(".")[-1] in PER_STEP else old[k]
      if k.endswith(".action"):
        continue
      np.testing.assert_allclose(new[k], want, rtol=0, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("name", _assets_script().PIXEL_MODELS)
def test_pixel_env_models_keep_physics(name):
  """A pixel model differs from the plain zoo snapshot only by the
  injected camera: its cam_* fields, ncam, the names, and the render
  fields a model with a camera keeps."""
  with np.load(mjtpu_torch.ASSETS / f"{name}_model.npz") as z:
    plain = {k: z[k] for k in z.files}
  with np.load(mjtpu_torch.ASSETS / "pixel_env_models.npz") as z:
    pix = io._bundle_arrays(z, name)
  camera = lambda k: k in ("ncam", "names") or k.startswith("cam_")
  assert set(pix) - set(plain) == set(io.RENDER_FIELDS)
  assert set(plain) <= set(pix)
  for k, v in plain.items():
    if not camera(k):
      assert pix[k].dtype == v.dtype, k
      np.testing.assert_array_equal(pix[k], v, err_msg=k)
  assert int(pix["ncam"]) == 1 and int(plain["ncam"]) == 0


@pytest.mark.parametrize("model", ["satellite_small", "satellite_large", "camprojection"])
def test_camera_snapshots_hold_render_fields(model):
  """The snapshots of the models with a camera keep the render fields
  beside every field they held, each equal to a fresh snapshot of their
  MjModel."""
  script = _assets_script()
  if model == "camprojection":
    mjm = mujoco.MjModel.from_xml_string(script.sensor_scene_xmls()[model])
    with np.load(script.SENSOR_SCENES_FILE) as z:
      arrays = io._bundle_arrays(z, model)
  else:
    mjm = script.load_zoo_mjmodel(model)
    with np.load(mjtpu_torch.ASSETS / f"{model}_model.npz") as z:
      arrays = {k: z[k] for k in z.files}
  fresh = io.snapshot_arrays(mjm)
  assert set(io.RENDER_FIELDS) <= set(arrays) and sorted(arrays) == sorted(fresh)
  for k, v in fresh.items():
    assert arrays[k].dtype == v.dtype, k
    np.testing.assert_array_equal(arrays[k], v, err_msg=k)
