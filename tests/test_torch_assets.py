"""The port's hard-coded enums and committed data files, held to their
sources: the ``mujoco`` bindings, a fresh MjModel, and a fresh mjtpu run.
Also: the port imports and steps the committed model with jax, mjtpu and
mujoco absent, as on the machine with the GPU."""

import dataclasses
import importlib.util
import os
import pathlib
import subprocess
import sys

import mujoco
import numpy as np
import pytest
import torch

import mjtpu_torch
from mjtpu_torch._src import io, types

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _assets_script():
  spec = importlib.util.spec_from_file_location(
      "torch_port_assets", ROOT / "scripts" / "torch_port_assets.py")
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


ENUMS = [
    (types.DisableBit, mujoco.mjtDisableBit, "mjDSBL_"),
    (types.EnableBit, mujoco.mjtEnableBit, "mjENBL_"),
    (types.JointType, mujoco.mjtJoint, "mjJNT_"),
    (types.IntegratorType, mujoco.mjtIntegrator, "mjINT_"),
    (types.GeomType, mujoco.mjtGeom, "mjGEOM_"),
    (types.ConeType, mujoco.mjtCone, "mjCONE_"),
    (types.JacobianType, mujoco.mjtJacobian, "mjJAC_"),
    (types.SolverType, mujoco.mjtSolver, "mjSOL_"),
    (types.EqType, mujoco.mjtEq, "mjEQ_"),
    (types.TrnType, mujoco.mjtTrn, "mjTRN_"),
    (types.DynType, mujoco.mjtDyn, "mjDYN_"),
    (types.GainType, mujoco.mjtGain, "mjGAIN_"),
    (types.BiasType, mujoco.mjtBias, "mjBIAS_"),
    (types.ConstraintType, mujoco.mjtConstraint, "mjCNSTR_"),
]


@pytest.mark.parametrize("port, binding, prefix", ENUMS, ids=[e[0].__name__ for e in ENUMS])
def test_enum_matches_bindings(port, binding, prefix):
  for member in port:
    if port is types.DisableBit and member.name == "PASSIVE":
      want = int(binding.mjDSBL_SPRING) | int(binding.mjDSBL_DAMPER)
    else:
      want = int(getattr(binding, prefix + member.name))
    assert int(member) == want, (port.__name__, member.name)


def test_constants_match_bindings():
  assert types.MINVAL == mujoco.mjMINVAL
  assert types.NREF == mujoco.mjNREF
  assert types.NIMP == mujoco.mjNIMP


def _assert_models_equal(a, b, path="model"):
  for f in dataclasses.fields(a):
    if not f.compare:
      continue
    x, y = getattr(a, f.name), getattr(b, f.name)
    where = f"{path}.{f.name}"
    if dataclasses.is_dataclass(x):
      _assert_models_equal(x, y, where)
    elif isinstance(x, torch.Tensor):
      assert x.dtype == y.dtype and torch.equal(x, y), where
    elif isinstance(x, np.ndarray):
      assert x.dtype == y.dtype, where
      np.testing.assert_array_equal(x, y, err_msg=where)
    else:
      assert type(x) is type(y) and x == y, where


def test_snapshot_model_equals_put_model():
  mjm = _assets_script().load_mjmodel()
  snap = mjtpu_torch.model_from_arrays(
      mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / "humanoid_bench_model.npz"))
  _assert_models_equal(snap, mjtpu_torch.put_model(mjm))


@pytest.fixture(scope="module")
def regenerated(tmp_path_factory):
  """Both data files written afresh by scripts/torch_port_assets.py (in a
  subprocess: the script pins XLA's vector ISA before jax starts)."""
  out = tmp_path_factory.mktemp("assets")
  env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
  proc = subprocess.run(
      [sys.executable, str(ROOT / "scripts" / "torch_port_assets.py"), "--out", str(out)],
      cwd=ROOT, capture_output=True, text=True, timeout=600,
      env={**env, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT)},
  )
  assert proc.returncode == 0, proc.stderr
  return out


def test_snapshot_file_is_fresh(regenerated):
  script = _assets_script()
  with np.load(regenerated / script.MODEL_FILE.name) as new, np.load(script.MODEL_FILE) as old:
    assert sorted(new.files) == sorted(old.files) == sorted(io.SNAPSHOT_FIELDS)
    for k in new.files:
      np.testing.assert_array_equal(new[k], old[k], err_msg=k)


def test_golden_file_is_fresh(regenerated):
  """Regenerating the golden trajectories with mjtpu reproduces the file."""
  script = _assets_script()
  with np.load(regenerated / script.GOLDEN_FILE.name) as new, np.load(script.GOLDEN_FILE) as old:
    assert sorted(new.files) == sorted(old.files)
    for k in new.files:
      np.testing.assert_allclose(new[k], old[k], rtol=0, atol=1e-12, err_msg=k)


_NO_JAX = r"""
import importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
  def find_spec(self, name, path=None, target=None):
    if name.split(".")[0] in ("jax", "jaxlib", "mjtpu", "mujoco"):
      raise ImportError(f"{name} is blocked")
    return None

sys.meta_path.insert(0, Block())
import torch
import mjtpu_torch
from mjtpu_torch.ops import cholesky, fused
m = mjtpu_torch.model_from_arrays(
    mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / "humanoid_bench_model.npz"))
d = mjtpu_torch.step(m, mjtpu_torch.make_data(m, batch_size=2))
assert bool(torch.isfinite(d.qpos).all())
bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "mjtpu", "mujoco"))
assert not bad, bad
print("ok")
"""


def test_port_runs_without_jax_mjtpu_mujoco():
  env = {k: os.environ[k] for k in ("PATH", "HOME", "TMPDIR") if k in os.environ}
  out = subprocess.run(
      [sys.executable, "-c", _NO_JAX], cwd=ROOT, capture_output=True, text=True,
      timeout=300, env={**env, "PYTHONPATH": str(ROOT)},
  )
  assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
