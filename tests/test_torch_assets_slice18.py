"""Slice 18's data files (scripts/torch_port_assets.py --model
randomize_fields), held to their sources: each scene's snapshot against
put_model of its MjModel, the golden's rows and starts against the
script's specs, the randomized humanoid_bench's B=4096 constant rows
against mj_setConst of chip_smoke.bench_randomization's masses and body
positions, and two small scenes' goldens regenerated by mjtpu bit for
bit; and the snapshots of models with a light, which gained light_dir0,
against fresh snapshots of their MjModels."""

import numpy as np

import chip_smoke
import mjtpu_torch
from mjtpu_torch._src import io
from mjtpu_torch.parallel.randomize import _derived_constants
from tests.test_torch_assets import _assert_models_equal, _assets_script, _regenerate

# the scenes regenerated afresh (the smallest: a few seconds of mjtpu)
REGENERATED = ("elliptic", "friction")


def test_field_snapshots_equal_put_model():
  script = _assets_script()
  specs = script.randomize_field_specs()
  path = script.RANDOMIZE_FIELDS_FILE
  assert io.bundle_names(path) == sorted(specs)
  for name, spec in specs.items():
    snap = mjtpu_torch.model_from_arrays(io.load_snapshot(path, name), device="cpu")
    _assert_models_equal(snap, mjtpu_torch.put_model(spec[0], device="cpu"), name)


def test_field_rows_and_starts_are_the_specs():
  """Each scene's rows (every perturbed field in its own env), start and
  step count are the script's; every traced field is perturbed in some
  scene."""
  script = _assets_script()
  homes = set()
  with np.load(script.RANDOMIZE_FIELDS_GOLDEN_FILE) as golden:
    for name, (_, rows, start, steps, _) in script.randomize_field_specs().items():
      for k, v in rows.items():
        np.testing.assert_array_equal(golden[f"{name}.rows.{k}"], v, err_msg=f"{name} {k}")
      for k, v in start.items():
        np.testing.assert_array_equal(golden[f"{name}.{k}0"], v, err_msg=f"{name} {k}")
      assert golden[f"{name}.qpos"].shape[0] == steps
      if name in script.FIELD_HOMES:
        assert list(golden[f"{name}.fields"]) == list(script.FIELD_HOMES[name])
        homes |= set(script.FIELD_HOMES[name])
  from mjtpu_torch.parallel.randomize import _ACCEPTED

  assert homes == _ACCEPTED


def test_bench_rows_are_mj_setconst_of_the_geometry():
  """The B=4096 constants the card reads equal mj_setConst's of
  bench_randomization's masses and body positions."""
  script = _assets_script()
  mjm = script.load_mjmodel()
  rows = chip_smoke.bench_randomization(mjm, chip_smoke.BENCH_BATCH, locomotion=True)
  geometry = {k: rows[k] for k in ("body_mass", "body_pos")}
  want = {**geometry, **{k: v for k, v in _derived_constants(mjm, geometry).items()
                         if k != "dof_M0" and v.size}}
  with np.load(script.RANDOMIZE_FIELDS_GOLDEN_FILE) as golden:
    keys = [k[len("bench.rows."):] for k in golden.files if k.startswith("bench.rows.")]
    assert sorted(keys) == sorted(want)
    for k in keys:
      np.testing.assert_array_equal(golden[f"bench.rows.{k}"], want[k], err_msg=k)


def test_field_golden_is_fresh(tmp_path):
  """REGENERATED's goldens, written afresh by the script (mjtpu), equal
  the committed ones bit for bit."""
  script = _assets_script()
  args = [a for name in REGENERATED for a in ("--scene", name)]
  new_dir = _regenerate(tmp_path, "--model", "randomize_fields", *args)
  with np.load(new_dir / script.RANDOMIZE_FIELDS_GOLDEN_FILE.name) as new, \
      np.load(script.RANDOMIZE_FIELDS_GOLDEN_FILE) as old:
    assert sorted(new.files) == sorted(k for k in old.files if k.startswith(
        tuple(f"{name}." for name in REGENERATED)))
    for k in new.files:
      np.testing.assert_array_equal(new[k], old[k], err_msg=k)


def test_light_snapshots_are_fresh():
  """The snapshots of models with a light hold light_dir0 beside every
  field they held, each equal to a fresh snapshot of their MjModel."""
  script = _assets_script()
  for name in io.bundle_names(script.RENDER_SCENES_FILE):
    mjm = script.render_scene_mjmodel(name)
    with np.load(script.RENDER_SCENES_FILE) as z:
      arrays = io._bundle_arrays(z, name)
    fresh = io.snapshot_arrays(mjm)
    assert ("light_dir0" in arrays) == bool(mjm.nlight) and sorted(arrays) == sorted(fresh)
    for k, v in fresh.items():
      np.testing.assert_array_equal(arrays[k], v, err_msg=f"{name} {k}")
  for name in ("satellite_small", "satellite_large"):
    mjm = script.load_zoo_mjmodel(name)
    assert mjm.nlight
    snap = mjtpu_torch.model_from_arrays(
        mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / f"{name}_model.npz"), device="cpu")
    np.testing.assert_array_equal(snap.light_dir0.numpy(), mjm.light_dir0, err_msg=name)
    _assert_models_equal(snap, mjtpu_torch.put_model(mjm, device="cpu"), name)
