"""Slice 15's data files (scripts/torch_port_assets.py --model
randomize_scenes, --model inverse_scenes), held to their sources: each
scene's snapshot against put_model of its MjModel, the goldens' rows and
start states against the script's specs, the randomized
humanoid_bench's B=4096 constant rows against mj_setConst of
chip_smoke.bench_randomization's masses, and mjtpu's inverse of one scene
run afresh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
import mjtpu
import mjtpu_torch
from mjtpu_torch.parallel.randomize import _derived_constants
from mjtpu_torch._src import io
from tests.test_torch_assets import _assert_models_equal, _assets_script


@pytest.mark.parametrize("bundle", ["randomize", "inverse"])
def test_scene_snapshots_equal_put_model(bundle):
  script = _assets_script()
  specs = getattr(script, f"{bundle}_scene_specs")()
  path = getattr(script, f"{bundle.upper()}_SCENES_FILE")
  assert io.bundle_names(path) == sorted(specs)
  for name, spec in specs.items():
    snap = mjtpu_torch.model_from_arrays(io.load_snapshot(path, name), device="cpu")
    _assert_models_equal(snap, mjtpu_torch.put_model(spec[0], device="cpu"), name)


def test_randomize_rows_and_starts_are_the_specs():
  script = _assets_script()
  with np.load(script.RANDOMIZE_GOLDEN_FILE) as golden:
    for name, (_, rows, start, steps, _) in script.randomize_scene_specs().items():
      for k, v in rows.items():
        np.testing.assert_array_equal(golden[f"{name}.rows.{k}"], v, err_msg=f"{name} {k}")
      for k, v in start.items():
        np.testing.assert_array_equal(golden[f"{name}.{k}0"], v, err_msg=f"{name} {k}")
      assert golden[f"{name}.qpos"].shape[0] == steps


def test_bench_rows_are_mj_setconst_of_the_masses():
  """The B=4096 constants the card reads equal mj_setConst's of
  bench_randomization's masses, which they were written with."""
  script = _assets_script()
  mjm = script.load_mjmodel()
  mass = chip_smoke.bench_randomization(mjm, chip_smoke.BENCH_BATCH)["body_mass"]
  want = _derived_constants(mjm, {"body_mass": mass})
  with np.load(script.RANDOMIZE_GOLDEN_FILE) as golden:
    np.testing.assert_array_equal(golden["bench.rows.body_mass"], mass)
    keys = [k[len("bench.rows."):] for k in golden.files if k.startswith("bench.rows.")]
    assert sorted(keys) == sorted(["body_mass"] + [k for k, v in want.items()
                                                   if k != "dof_M0" and v.size])
    for k in keys:
      if k != "body_mass":
        np.testing.assert_array_equal(golden[f"bench.rows.{k}"], want[k], err_msg=k)


def test_inverse_golden_is_fresh():
  """The starts equal the specs' (C's states), and mjtpu's inverse of the
  pendulum scene, run afresh, equals the golden's outputs."""
  script = _assets_script()
  specs = script.inverse_scene_specs()
  with np.load(script.INVERSE_GOLDEN_FILE) as golden:
    for name, (_, start, qacc_from) in specs.items():
      for k, v in start.items():
        if qacc_from == "given" or k not in ("qpos", "qacc"):
          np.testing.assert_array_equal(golden[f"{name}.{k}0"], v, err_msg=f"{name} {k}")
    mjm, start, _ = specs["pendulum"]
    jax.config.update("jax_enable_x64", True)
    m = mjtpu.put_model(mjm, dtype=jnp.float64)
    d = jax.vmap(lambda _: mjtpu.make_data(m))(jnp.arange(script.BATCH))
    d = d.replace(**{k: jnp.asarray(v) for k, v in start.items()})
    inv = jax.jit(jax.vmap(mjtpu.inverse, in_axes=(None, 0)))(m, d)
    for k in script.INVERSE_OUT:
      np.testing.assert_allclose(np.asarray(getattr(inv, k)), golden[f"pendulum.{k}"],
                                 rtol=0, atol=1e-14, err_msg=k)
