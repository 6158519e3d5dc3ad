"""Slice 16's data files (scripts/torch_port_assets.py --model diff_scenes,
--model stepped_scenes), held to their sources: each scene's snapshot
against put_model of its MjModel, the goldens' starts against the
script's specs, mjtpu's jax.grad of the pendulum scene run afresh; and
the port against the stepped scenes' golden (hopper_bench and
pendulum_implicit, which no other port test steps)."""

import jax
import numpy as np
import pytest

import chip_smoke
import mjtpu_torch
from mjtpu_torch._src import io
from tests.test_torch_assets import _assert_models_equal, _assets_script


@pytest.mark.parametrize("bundle", ["diff", "stepped"])
def test_scene_snapshots_and_starts_are_the_specs(bundle):
  script = _assets_script()
  specs = getattr(script, f"{bundle}_scene_specs")()
  path = getattr(script, f"{bundle.upper()}_SCENES_FILE")
  assert io.bundle_names(path) == sorted(specs)
  with np.load(getattr(script, f"{bundle.upper()}_GOLDEN_FILE")) as golden:
    for name, (mjm, start) in specs.items():
      snap = mjtpu_torch.model_from_arrays(io.load_snapshot(path, name), device="cpu")
      _assert_models_equal(snap, mjtpu_torch.put_model(mjm, device="cpu"), name)
      for k, v in start.items():
        np.testing.assert_array_equal(golden[f"{name}.{k}"], v, err_msg=f"{name} {k}")


def test_diff_golden_is_fresh():
  """mjtpu's values and jax.grad of the pendulum scene, run afresh, equal
  the golden's to 1e-12 of their scale."""
  jax.config.update("jax_enable_x64", True)
  _, golden = _assets_script().diff_scenes(["pendulum"])
  with np.load(mjtpu_torch.ASSETS / "diff_scenes_golden.npz") as want:
    for k, v in golden.items():
      np.testing.assert_allclose(v, want[k], rtol=0,
                                 atol=1e-12 * max(1.0, float(np.abs(want[k]).max())), err_msg=k)


@pytest.mark.parametrize("name", ["hopper_bench", "pendulum_implicit"])
def test_stepped_scene_matches_mjtpu(name):
  """50 steps at f64 from the golden's start, and the inverse after each,
  within 1e-8 of scale of mjtpu's (chip_smoke.stepped_scene_errors, which
  phase 34 runs on the card)."""
  with np.load(mjtpu_torch.ASSETS / "stepped_scenes_golden.npz") as z:
    golden = {k: z[k] for k in z.files}
  errs = chip_smoke.stepped_scene_errors(name, golden, "cpu")
  assert max(errs.values()) <= chip_smoke.STEPPED_BOUND, errs
