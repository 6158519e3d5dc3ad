"""The port's hard-coded enums and committed data files, held to their
sources: the ``mujoco`` bindings, a fresh MjModel, and a fresh mjtpu run.
Also: the port imports and steps the committed model with jax, mjtpu and
mujoco absent, as on the machine with the GPU.

The regenerations of the models' goldens are in test_torch_assets_*.py,
one file each (so that --dist loadfile spreads them over the workers);
they share this file's helpers."""

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
    (types.WrapType, mujoco.mjtWrap, "mjWRAP_"),
    (types.TrnType, mujoco.mjtTrn, "mjTRN_"),
    (types.DynType, mujoco.mjtDyn, "mjDYN_"),
    (types.GainType, mujoco.mjtGain, "mjGAIN_"),
    (types.BiasType, mujoco.mjtBias, "mjBIAS_"),
    (types.ConstraintType, mujoco.mjtConstraint, "mjCNSTR_"),
    (types.CamLightType, mujoco.mjtCamLight, "mjCAMLIGHT_"),
    (types.SensorType, mujoco.mjtSensor, "mjSENS_"),
    (types.ObjType, mujoco.mjtObj, "mjOBJ_"),
    (types.DataType, mujoco.mjtDataType, "mjDATATYPE_"),
    (types.Stage, mujoco.mjtStage, "mjSTAGE_"),
]


@pytest.mark.parametrize("port, binding, prefix", ENUMS, ids=[e[0].__name__ for e in ENUMS])
def test_enum_matches_bindings(port, binding, prefix):
  for member in port:
    if port is types.DisableBit and member.name == "PASSIVE":
      want = int(binding.mjDSBL_SPRING) | int(binding.mjDSBL_DAMPER)
    else:
      want = int(getattr(binding, prefix + member.name))
    assert int(member) == want, (port.__name__, member.name)
  if port is types.SensorType:  # every sensor type, so each is refused by name
    assert len(port) == len([n for n in dir(binding) if n.startswith(prefix)])


def test_constants_match_bindings():
  assert types.MINVAL == mujoco.mjMINVAL
  assert types.NREF == mujoco.mjNREF
  assert types.NIMP == mujoco.mjNIMP
  assert types.NFLUID == mujoco.mjNFLUID
  assert types.NEQDATA == mujoco.mjNEQDATA


def _assert_models_equal(a, b, path="model"):
  for f in dataclasses.fields(a):
    if not f.compare:
      continue
    x, y = getattr(a, f.name), getattr(b, f.name)
    where = f"{path}.{f.name}"
    if dataclasses.is_dataclass(x):
      _assert_models_equal(x, y, where)
    elif isinstance(x, tuple):  # mesh_convex: ConvexMesh or None per mesh
      assert len(x) == len(y), where
      for i, (u, v) in enumerate(zip(x, y)):
        assert (u is None) == (v is None), f"{where}[{i}]"
        if u is not None:
          _assert_models_equal(u, v, f"{where}[{i}]")
    elif isinstance(x, torch.Tensor):
      assert x.dtype == y.dtype and torch.equal(x, y), where
    elif isinstance(x, np.ndarray):
      assert x.dtype == y.dtype, where
      np.testing.assert_array_equal(x, y, err_msg=where)
    else:
      assert type(x) is type(y) and x == y, where


ZOO_BUILT = ("ant", "hopper", "walker2d", "halfcheetah", "cartpole", "humanoid", "swimmer",
             "satellite", "satellite_large", "satellite_small")


CONTACT_MODELS = ("cylinder_drop", "roll", "sph_cyl")


@pytest.mark.parametrize("model", ["humanoid_bench", "humanoid_terrain", "boxes", "branchy66",
                                   "ant_bench", *ZOO_BUILT, *CONTACT_MODELS,
                                   "humanoid_bench_elliptic"])
def test_snapshot_model_equals_put_model(model):
  script = _assets_script()
  load = {"humanoid_bench": script.load_mjmodel, "humanoid_terrain": script.load_terrain_mjmodel,
          "humanoid_bench_elliptic": script.load_elliptic_mjmodel,
          "boxes": lambda: mujoco.MjModel.from_xml_path(str(script.BOXES_XML)),
          "branchy66": script.load_branchy_mjmodel, "ant_bench": script.load_ant_mjmodel,
          **{name: lambda name=name: script.load_contact_mjmodel(name)
             for name in CONTACT_MODELS}}
  mjm = load[model]() if model in load else script.load_zoo_mjmodel(model)
  snap = mjtpu_torch.model_from_arrays(
      mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / f"{model}_model.npz"), device="cpu")
  _assert_models_equal(snap, mjtpu_torch.put_model(mjm, device="cpu"))


def test_scene_snapshots_equal_put_model():
  """Each collision scene of the bundle, loaded, equals put_model of the
  scene's MjModel (the hulls of its boxes, cylinders, ellipsoids and
  meshes built by the port's mesh.py, table by table)."""
  script = _assets_script()
  xmls = script.scene_xmls()
  assert io.bundle_names(script.SCENES_FILE) == sorted(xmls)
  for name, xml in xmls.items():
    snap = mjtpu_torch.model_from_arrays(io.load_snapshot(script.SCENES_FILE, name),
                                         device="cpu")
    live = mjtpu_torch.put_model(mujoco.MjModel.from_xml_string(xml), device="cpu")
    _assert_models_equal(snap, live, name)


def test_scene_files_are_fresh(tmp_path):
  """Regenerating the cheapest scene (plane-ellipsoid: mjtpu compiles one
  fwd_position) reproduces its snapshot in the bundle and its golden."""
  script = _assets_script()
  new_dir = _regenerate(tmp_path, "--model", "collision_scenes", "--scene", "plane_ellipsoid")
  assert io.bundle_names(new_dir / script.SCENES_FILE.name) == ["plane_ellipsoid"]
  with np.load(new_dir / script.SCENES_FILE.name) as new, np.load(script.SCENES_FILE) as old:
    a, b = io._bundle_arrays(new, "plane_ellipsoid"), io._bundle_arrays(old, "plane_ellipsoid")
    assert sorted(a) == sorted(b)
    assert sorted(k for k in a if not k.startswith(io.HULL_PREFIXES)) == sorted(
        io.SNAPSHOT_FIELDS)
    for k in a:
      np.testing.assert_array_equal(a[k], b[k], err_msg=k)
  with np.load(new_dir / script.SCENES_GOLDEN_FILE.name) as new, \
      np.load(script.SCENES_GOLDEN_FILE) as old:
    assert sorted(new.files) == sorted(k for k in old.files if k.startswith("plane_ellipsoid."))
    for k in new.files:
      np.testing.assert_allclose(new[k], old[k], rtol=0, atol=1e-12, err_msg=k)


def test_cone_scene_snapshots_equal_put_model():
  """Each scene of the cone bundle, loaded, equals put_model of its MJCF;
  the snapshots of scenes with dof frictionloss carry the friction rows'
  solver parameters (io.FRICTION_FIELDS), the others do not."""
  script = _assets_script()
  xmls = script.cone_scene_xmls()
  assert io.bundle_names(script.CONE_SCENES_FILE) == sorted(xmls)
  with np.load(script.CONE_SCENES_FILE) as z:
    for name, xml in xmls.items():
      mjm = mujoco.MjModel.from_xml_string(xml)
      keys = set(io._bundle_arrays(z, name))
      assert keys >= set(io.SNAPSHOT_FIELDS)
      friction = bool((mjm.dof_frictionloss > 0).any())
      assert (keys >= set(io.FRICTION_FIELDS)) == friction, name
      snap = mjtpu_torch.model_from_arrays(io.load_snapshot(script.CONE_SCENES_FILE, name),
                                           device="cpu")
      _assert_models_equal(snap, mjtpu_torch.put_model(mjm, device="cpu"), name)
      assert len(snap.friction_dofid) == int((mjm.dof_frictionloss > 0).sum())


def test_cone_scene_files_are_fresh(tmp_path):
  """Regenerating the frictionloss slide (the cheapest scene: mjtpu
  compiles one step of one dof; its first 5 steps) reproduces its snapshot
  in the cone bundle, with the friction rows' fields, and its golden's
  entries."""
  script = _assets_script()
  name = "frictionloss_slide"
  new_dir = _regenerate(tmp_path, "--model", "cone_scenes", "--scene", name, "--steps", "5")
  assert io.bundle_names(new_dir / script.CONE_SCENES_FILE.name) == [name]
  with np.load(new_dir / script.CONE_SCENES_FILE.name) as new, \
      np.load(script.CONE_SCENES_FILE) as old:
    a, b = io._bundle_arrays(new, name), io._bundle_arrays(old, name)
    assert sorted(a) == sorted(b) == sorted(io.SNAPSHOT_FIELDS + io.FRICTION_FIELDS)
    for k in a:
      np.testing.assert_array_equal(a[k], b[k], err_msg=k)
  with np.load(new_dir / script.CONE_GOLDEN_FILE.name) as new, \
      np.load(script.CONE_GOLDEN_FILE) as old:
    assert sorted(new.files) == sorted(k for k in old.files if k.startswith(f"{name}."))
    for k in new.files:
      want = old[k][:5] if k.split(".")[1] in ("qpos", "qvel", "sensordata") else old[k]
      np.testing.assert_allclose(new[k], want, rtol=0, atol=1e-12, err_msg=k)


def test_hull_tables_match_mjtpu():
  """The port's mesh.convex on a live MjModel builds mjtpu's hull tables,
  table by table."""
  from mjtpu._src import mesh as j_mesh
  from mjtpu_torch._src import mesh as t_mesh

  mjm = _assets_script().load_terrain_mjmodel()
  want, got = j_mesh.get(mjm), t_mesh.get(mjm)
  assert len(got) == len(want) == mjm.nmesh and all(h is not None for h in got)
  for a, b in zip(got, want):
    for f in io.HULL_FIELDS:
      np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def test_procedural_terrain_matches_mjtpu():
  script = _assets_script()
  want = script.load_terrain_mjmodel()
  got = mujoco.MjModel.from_xml_path(str(script.TERRAIN_XML))
  io.procedural_terrain(got)
  np.testing.assert_array_equal(got.hfield_data, want.hfield_data)
  assert np.ptp(want.hfield_data) > 0.5


def _regenerate(out, *args):
  """Runs scripts/torch_port_assets.py into ``out`` (in a subprocess: the
  script pins XLA's vector ISA before jax starts)."""
  env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
  proc = subprocess.run(
      [sys.executable, str(ROOT / "scripts" / "torch_port_assets.py"), "--out", str(out), *args],
      cwd=ROOT, capture_output=True, text=True, timeout=600,
      env={**env, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT)},
  )
  assert proc.returncode == 0, proc.stderr
  return out


def _snapshot_keys(path) -> list[str]:
  with np.load(path) as z:
    return sorted(k for k in z.files if not k.startswith(io.HULL_PREFIXES))


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
from mjtpu_torch._src import ray, sensor
from mjtpu_torch.ops import cholesky, fused, hfield, ldl, sat
for name in ("humanoid_bench", "humanoid_terrain", "scene_pile", "branchy66", "cylinder_drop",
             "humanoid_bench_elliptic", "ant_bench"):
  m = mjtpu_torch.model_from_arrays(
      mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / f"{name}_model.npz"), device="cpu")
  d = mjtpu_torch.step(m, mjtpu_torch.make_data(m, batch_size=2))
  assert bool(torch.isfinite(d.qpos).all())
d = mjtpu_torch.forward(m, mjtpu_torch.make_data(m, batch_size=2))  # ant_bench's sensors
assert d.sensordata.shape == (2, 26) and bool(torch.isfinite(d.sensordata).all())
from mjtpu_torch import zoo
env = zoo.ENVS["ant"](device="cpu")
gen = torch.Generator().manual_seed(0)
state = env.step(env.reset(2, gen), torch.zeros(2, env.action_size), gen)
assert state.obs.shape == (2, 27) and bool(torch.isfinite(state.obs).all())
for name in ("swimmer", "satellite", "satellite_small"):  # fluid forces, cmg.py, CMG rotors
  env = zoo.ENVS[name](device="cpu")
  state = env.step(env.reset(2, gen), torch.zeros(2, env.action_size), gen)
  assert bool(torch.isfinite(state.obs).all()), name
for name in ("mixed", "muscle"):  # the tendon slice's main paths, from the tendon bundle
  m = mjtpu_torch.model_from_arrays(
      mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / "tendon_scenes.npz", name), device="cpu")
  d = mjtpu_torch.make_data(m, batch_size=2)
  d = mjtpu_torch.replace(d, ctrl=torch.full((2, m.nu), 0.5, dtype=m.dtype))
  for _ in range(2):
    d = mjtpu_torch.step(m, d)
  assert bool(torch.isfinite(d.qpos).all() & torch.isfinite(d.ten_length).all()), name
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
