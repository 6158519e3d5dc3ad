"""Slice 19's data file (scripts/torch_port_assets.py --model
model_grad_scenes), held to its sources: each scene's steps, solver bounds,
rows and start against the script's specs (chip_smoke.MODEL_GRAD_SCENES
and randomize_fields_golden.npz, whose rows are the point), and the two
smallest scenes' goldens regenerated by mjtpu bit for bit."""

import numpy as np

import chip_smoke
from tests.test_torch_assets import _assets_script, _regenerate

# the scenes regenerated afresh (the smallest: one field each, B=2)
REGENERATED = ("elliptic", "terrain")


def test_model_grad_specs_are_the_scripts():
  """Every scene of MODEL_GRAD_SCENES and MODEL_GRAD_BASE in the golden
  with the script's steps and solver bounds; each randomize_fields
  scene's rows and start as randomize_fields_golden.npz holds them, the
  base scene's start humanoid_bench's, its gradients the unbatched
  MODEL_GRAD_BASE_FIELDS; a gradient for every row."""
  script = _assets_script()
  specs = {**chip_smoke.MODEL_GRAD_SCENES, chip_smoke.MODEL_GRAD_BASE: (
      chip_smoke.MODEL_GRAD_BASE_STEPS, chip_smoke.MODEL_GRAD_SCENES["humanoid_bench"][1])}
  with np.load(script.MODEL_GRAD_GOLDEN_FILE) as golden, \
      np.load(script.RANDOMIZE_FIELDS_GOLDEN_FILE) as fields:
    assert sorted({k.split(".")[0] for k in golden.files}) == sorted(specs)
    for name, (steps, solver) in specs.items():
      assert int(golden[f"{name}.steps"]) == steps and golden[f"{name}.qpos"].shape[0] == steps
      np.testing.assert_array_equal(golden[f"{name}.solver"], solver, err_msg=name)
      scene = "humanoid_bench" if name == chip_smoke.MODEL_GRAD_BASE else name
      for k in fields.files:
        if k.startswith(f"{scene}.") and k.count(".") == 1 and k.endswith("0"):
          np.testing.assert_array_equal(golden[f"{name}{k[len(scene):]}"], fields[k],
                                        err_msg=f"{name} {k}")
      grads = sorted(k[len(f"{name}.grad."):] for k in golden.files
                     if k.startswith(f"{name}.grad."))
      if name == chip_smoke.MODEL_GRAD_BASE:
        assert grads == sorted(chip_smoke.MODEL_GRAD_BASE_FIELDS)
        continue
      rows = sorted(k[len(f"{name}.rows."):] for k in fields.files
                    if k.startswith(f"{name}.rows."))
      assert grads == rows, name
      for k in rows:
        np.testing.assert_array_equal(golden[f"{name}.rows.{k}"], fields[f"{name}.rows.{k}"],
                                      err_msg=f"{name} {k}")
        assert golden[f"{name}.grad.{k}"].shape == fields[f"{name}.rows.{k}"].shape


def test_model_grad_golden_is_fresh(tmp_path):
  """REGENERATED's goldens, written afresh by the script (mjtpu's jax.grad
  under jit), equal the committed ones bit for bit."""
  script = _assets_script()
  args = [a for name in REGENERATED for a in ("--scene", name)]
  new_dir = _regenerate(tmp_path, "--model", "model_grad_scenes", *args)
  with np.load(new_dir / script.MODEL_GRAD_GOLDEN_FILE.name) as new, \
      np.load(script.MODEL_GRAD_GOLDEN_FILE) as old:
    assert sorted(new.files) == sorted(k for k in old.files if k.startswith(
        tuple(f"{name}." for name in REGENERATED)))
    for k in new.files:
      np.testing.assert_array_equal(new[k], old[k], err_msg=k)
