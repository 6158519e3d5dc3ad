"""The zoo envs' snapshots, the ant RK4 golden and the env golden,
regenerated with mjtpu and held to the committed files
(scripts/torch_port_assets.py): one file a regeneration, so that pytest-
xdist's --dist loadfile spreads them over its workers."""

import numpy as np

import mjtpu_torch
from mjtpu_torch._src import io
from tests.test_torch_assets import ZOO_BUILT, _assets_script, _regenerate, _snapshot_keys


def test_zoo_snapshot_files_are_fresh(tmp_path):
  """The zoo envs' snapshots are what the script writes; the swimmer's,
  the one with fluid forces, also holds io.FLUID_FIELDS, those of the
  models with a camera (the satellites with CMGs) io.RENDER_FIELDS, and
  those of the models with a light io.LIGHT_FIELDS."""
  script = _assets_script()
  new_dir = _regenerate(tmp_path, "--model", "zoo")
  assert script.ZOO_MODELS == ZOO_BUILT
  for name in script.ZOO_MODELS:
    old_file = mjtpu_torch.ASSETS / f"{name}_model.npz"
    extra = io.FLUID_FIELDS if name == "swimmer" else ()
    if script.load_zoo_mjmodel(name).ncam:
      extra += tuple(io.RENDER_FIELDS)
    if script.load_zoo_mjmodel(name).nlight:
      extra += tuple(io.LIGHT_FIELDS)
    assert _snapshot_keys(old_file) == sorted(io.SNAPSHOT_FIELDS + extra)
    with np.load(new_dir / old_file.name) as new, np.load(old_file) as old:
      assert sorted(new.files) == sorted(old.files)
      for k in new.files:
        np.testing.assert_array_equal(new[k], old[k], err_msg=f"{name} {k}")


ANT_RK4_PREFIX = 2


def test_ant_rk4_golden_file_is_fresh(tmp_path):
  """Regenerating the ant RK4 golden with mjtpu reproduces the committed
  file's step-1 passes and fields and its first ANT_RK4_PREFIX steps (the
  rest of the trajectory is held by tests/test_torch_rk4.py against the
  port)."""
  script = _assets_script()
  new_dir = _regenerate(tmp_path, "--model", "ant_rk4", "--steps", str(ANT_RK4_PREFIX))
  name = script.ANT_RK4_GOLDEN_FILE.name
  with np.load(new_dir / name) as new, np.load(script.ANT_RK4_GOLDEN_FILE) as old:
    assert sorted(new.files) == sorted(old.files)
    assert old["qpos"].shape[:2] == (script.STEPS, script.BATCH)
    assert old["pass_qacc"].shape == (4, script.BATCH, 14)
    for k in new.files:
      want = old[k][:ANT_RK4_PREFIX] if k in ("qpos", "qvel") else old[k]
      np.testing.assert_allclose(new[k], want, rtol=0, atol=1e-12, err_msg=k)


def test_env_golden_file_is_fresh(tmp_path):
  """Regenerating cartpole's part of the env golden with mjtpu reproduces
  the committed file's first env step (mjtpu's compile of the other envs'
  env.step takes 40-90 s each on the CPU; their entries are held by
  tests/test_torch_zoo.py against the port)."""
  script = _assets_script()
  new_dir = _regenerate(tmp_path, "--model", "zoo_envs", "--env", "cartpole", "--steps", "1")
  name = script.ENV_GOLDEN_FILE.name
  with np.load(new_dir / name) as new, np.load(script.ENV_GOLDEN_FILE) as old:
    assert sorted(old.files) == sorted(f"{env}.{k}" for env in script.LOCOMOTION for k in (
        "qpos0", "qvel0", "steps0", "action", "obs", "reward", "done", "steps"))
    assert sorted(new.files) == sorted(k for k in old.files if k.startswith("cartpole."))
    for k in new.files:
      want = old[k][:1] if new[k].ndim and k.split(".")[1] in (
          "action", "obs", "reward", "done", "steps") else old[k]
      np.testing.assert_allclose(new[k], want, rtol=0, atol=1e-12, err_msg=k)
