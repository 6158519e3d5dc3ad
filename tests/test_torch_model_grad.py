"""Gradients with respect to Model fields in mjtpu_torch (system
identification), at f64 on the CPU.

The model_grad scenes (scripts/torch_port_assets.py --model
model_grad_scenes) take each randomize_fields scene's rows as the point of
mjtpu's jax.grad under differentiable_mode(), and humanoid_bench's
unbatched body_mass, geom_friction, dof_damping, actuator_gainprm and
opt.timestep as the point of one more: the port's values and gradients
(chip_smoke.model_grad_scene_run, which side phase 38-parity runs on the
card) within the diff scenes' bounds of mjtpu's, every gradient finite, a
field mjtpu leaves at zero zero (or None) in the port, and where mjtpu's
gradient is NaN (ROADMAP C22) the port's held to central differences of
its own loss.  The two faults of the cached tables, each pinned: a second
rollout's backward on the same Model, and a rollout under no_grad before
one with its graph.  A base-Model field's gradient is the sum of the
per-env rows'; central differences of the port's own loss hold for a
contact field, a mass and the timestep; a Model with no field requiring
grad keeps each table from its first build; with every traced field
requiring grad, no kept table holds a graph.
"""

import functools

import mujoco
import numpy as np
import pytest
import torch

import chip_smoke
import mjtpu_torch
from mjtpu_torch import parallel
from mjtpu_torch._src import io, types
from mjtpu_torch._src.types import field, replace_fields
from mjtpu_torch.parallel.randomize import _ACCEPTED

torch.set_num_threads(1)

GOLDEN = mjtpu_torch.ASSETS / "model_grad_scenes_golden.npz"
SCENES = (*chip_smoke.MODEL_GRAD_SCENES, chip_smoke.MODEL_GRAD_BASE)

# a free sphere resting on a plane and a hinge with damping, stiffness,
# frictionloss and a limit row live within its impedance's width (below its
# midpoint, where the power shapes it); its Newton solve at 2 x 4 (every
# round runs in the mode)
PROBE_XML = """<mujoco><worldbody><geom type="plane" size="5 5 .1"/>
<body pos="0 0 0.099"><freejoint/><geom type="sphere" size="0.1" mass="1"/></body>
<body pos="1 0 1"><joint type="hinge" axis="0 1 0" damping="0.3" stiffness="2"
 frictionloss="0.1" limited="true" range="-0.05 1" margin="0.1"
 solimplimit="0.9 0.95 0.2 0.5 2"/><geom type="capsule" fromto="0 0 0 0 0 -0.4" size="0.03"
 mass="0.4" contype="0" conaffinity="0"/></body></worldbody></mujoco>"""
PROBE_BATCH = 2
PROBE_STEPS = 3
PROBE_FIELDS = ("jnt_stiffness", "geom_friction", "body_mass", "dof_damping", "opt.timestep")
FD_EPS = 1e-6


@functools.lru_cache(maxsize=None)
def _golden():
  with np.load(GOLDEN) as z:
    return chip_smoke._Files({k: z[k] for k in z.files})


@functools.lru_cache(maxsize=None)
def _run(name):
  """The port's run of a scene (chip_smoke.model_grad_scene_run), once."""
  return chip_smoke.model_grad_scene_run(name, _golden(), "cpu")


@pytest.mark.parametrize("name", SCENES)
def test_scene_matches_mjtpu(name):
  """Values at step 1 within 1e-10 of scale and over the run within 1e-8,
  gradients within 1e-8 of their max-abs, all finite; a gradient mjtpu
  leaves at zero zero; where mjtpu's is not finite (C22) the port's within
  MODEL_GRAD_FD_RTOL of differences of its own loss (model_grad_fd_error:
  central ones, and one-sided ones along the fields that cross a tie)."""
  errs = chip_smoke.model_grad_scene_errors(name, _golden(), "cpu", got=_run(name))
  assert chip_smoke.model_grad_ok(errs), errs
  fd = chip_smoke.model_grad_fd_error(name, _golden(), "cpu") if errs["mjtpu_nonfinite"] else {}
  assert name != chip_smoke.MODEL_GRAD_BASE or not fd, fd
  assert bool(fd) == bool(errs["mjtpu_nonfinite"]), fd
  assert all(e <= chip_smoke.MODEL_GRAD_FD_RTOL for e in fd.values()), fd


def test_every_field_has_a_gradient_or_mjtpus_is_zero():
  """Every traced field mjtpu's randomize accepts is a point of some
  scene; the port gives None only where mjtpu's gradient is zero."""
  seen = set()
  for name in SCENES:
    errs = chip_smoke.model_grad_scene_errors(name, _golden(), "cpu", got=_run(name))
    seen |= set(errs["grads"])
    none = {k[5:] for k, v in _run(name).items() if k.startswith("grad.") and v is None}
    assert none <= set(errs["zero"]), (name, none - set(errs["zero"]))
  assert seen == set(_ACCEPTED), set(_ACCEPTED) ^ seen


@functools.lru_cache(maxsize=None)
def _probe():
  mjm = mujoco.MjModel.from_xml_string(PROBE_XML)
  mjm.opt.iterations, mjm.opt.ls_iterations = 2, 4
  return mjtpu_torch.put_model(mjm, dtype=torch.float64, device="cpu")


def _leaves(m, names=PROBE_FIELDS, batch=PROBE_BATCH):
  """Each field of ``names`` as (batch, *shape) rows of its base value, a
  leaf that requires grad."""
  return {k: field(m, k).detach()[None].repeat((batch,) + (1,) * field(m, k).dim())
          .clone().requires_grad_(True) for k in names}


def _rollout(m, batch=PROBE_BATCH, **cfg):
  """The summed loss of PROBE_STEPS steps under differentiable_mode(**cfg)
  from rest with a spin and a swing (sum of qpos^2 after the last)."""
  d = mjtpu_torch.make_data(m, batch_size=batch)
  qvel = torch.tensor([0.3, 0.1, 0.0, 0.0, 0.0, 0.0, 0.5], dtype=torch.float64)
  d = mjtpu_torch.replace(d, qvel=qvel.expand(batch, -1).clone())
  with mjtpu_torch.differentiable_mode(**cfg):
    for _ in range(PROBE_STEPS):
      d = mjtpu_torch.step(m, d)
  return torch.sum(d.qpos ** 2)


def _grads(leaves):
  return {k: v.grad.clone() for k, v in leaves.items()}


def test_second_rollout_gives_the_first_gradient():
  """Fault 1: the contact parameters, built once per Model, held the first
  rollout's graph; a second backward on the same randomized Model raised
  'Trying to backward through the graph a second time'.  Now it gives the
  first's gradients bit for bit."""
  leaves = _leaves(_probe())
  mb, _ = parallel.randomize(_probe(), leaves)
  _rollout(mb).backward()
  first = _grads(leaves)
  for v in leaves.values():
    v.grad = None
  _rollout(mb).backward()
  for k, g in _grads(leaves).items():
    assert torch.equal(g, first[k]), k
  assert all(bool(g.abs().max() > 0) for g in first.values()), first


def test_no_grad_rollout_first_leaves_the_gradient():
  """Fault 2: a rollout under torch.no_grad() first (an evaluation, a
  warm-up) cached tables without a graph, and geom_friction.grad stayed
  None on the next backward.  Now every field's gradient is as without it,
  bit for bit."""
  plain = _leaves(_probe())
  _rollout(parallel.randomize(_probe(), plain)[0]).backward()
  leaves = _leaves(_probe())
  mb, _ = parallel.randomize(_probe(), leaves)
  with torch.no_grad():
    _rollout(mb)
  _rollout(mb).backward()
  for k, v in leaves.items():
    assert v.grad is not None and torch.equal(v.grad, plain[k].grad), k


def test_base_field_gradient_is_the_sum_of_the_rows():
  """A base Model's field replaced by a tensor that requires grad (shared
  by every env, jax.grad's unbatched leaf) gets the sum over the envs of
  the gradients of per-env rows of the same values."""
  m = _probe()
  rows = _leaves(m)
  _rollout(parallel.randomize(m, rows)[0]).backward()
  base = {k: field(m, k).detach().clone().requires_grad_(True) for k in PROBE_FIELDS}
  _rollout(replace_fields(m, base)).backward()
  for k, v in base.items():
    want = rows[k].grad.sum(dim=0)
    scale = float(want.abs().max())
    assert scale > 0, k
    assert float((v.grad - want).abs().max()) <= 1e-12 * scale, k


@pytest.mark.parametrize("name, entry, eps", [
    ("geom_friction", (1, 0), FD_EPS), ("body_mass", (1,), FD_EPS), ("opt.timestep", (), FD_EPS),
    # the power's slope is ~1e-6 of the loss: a wider step keeps the
    # differences above the loss's rounding
    ("jnt_solimp", (1, 4), 1e-4)])
def test_gradient_matches_finite_differences(name, entry, eps):
  """A contact field, a mass, the timestep and an impedance's power (whose
  gradient mjtpu gives NaN past the impedance width, C22): the port's
  gradient of one entry against central differences of its own loss
  (tests/test_diff.py's rtol), with contacts from distance off (their
  straight-through gradient is not the values' slope)."""
  m = _probe()
  base = field(m, name).detach().clone()

  def loss(x):
    return _rollout(replace_fields(m, {name: x}), cfd=False)

  leaf = base.clone().requires_grad_(True)
  loss(leaf).backward()
  bump = torch.zeros_like(base)
  bump[entry] = eps
  with torch.no_grad():
    fd = float((loss(base + bump) - loss(base - bump)) / (2 * eps))
  got = float(leaf.grad[entry])
  assert got != 0.0 and np.isfinite(got), got
  np.testing.assert_allclose(got, fd, rtol=1e-4)


def test_impedance_past_its_width_keeps_gradients_finite():
  """C22: a contact 1.5 mm deep, past its impedance's width (1 mm), under
  a power that is not an integer: mjtpu's upper branch takes a negative
  base to that power (NaN, and NaN in every gradient through the where);
  the port's gradients are finite and match central differences of its
  own loss, and its values keep their bits."""
  m = _probe()
  solimp = m.geom_solimp.detach().clone()
  solimp[..., 4] = 1.94
  mi = replace_fields(m, {"geom_solimp": solimp})
  qpos = mjtpu_torch.make_data(mi, batch_size=1).qpos.clone()
  qpos[:, 2] = 0.0985

  def loss(mass):
    d = mjtpu_torch.replace(mjtpu_torch.make_data(mi, batch_size=1), qpos=qpos)
    with mjtpu_torch.differentiable_mode(cfd=False):
      for _ in range(PROBE_STEPS):
        d = mjtpu_torch.step(replace_fields(mi, {"body_mass": mass}), d)
    return torch.sum(d.qpos ** 2)

  base = mi.body_mass.detach().clone()
  leaf = base.clone().requires_grad_(True)
  loss(leaf).backward()
  assert bool(torch.isfinite(leaf.grad).all()), leaf.grad
  bump = torch.zeros_like(base)
  bump[1] = FD_EPS
  with torch.no_grad():
    fd = float((loss(base + bump) - loss(base - bump)) / (2 * FD_EPS))
  np.testing.assert_allclose(float(leaf.grad[1]), fd, rtol=1e-4)


def _count_grad_builds(monkeypatch):
  """Records every grad_live answer that made cached() build a live table
  from the live fields."""
  hits = []
  real = types.grad_live

  def spy(m):
    out = real(m)
    if out:
      hits.append(id(m))
    return out

  monkeypatch.setattr(types, "grad_live", spy)
  return hits


@pytest.mark.parametrize("randomized", [False, True])
def test_plain_model_builds_each_table_once(monkeypatch, randomized):
  """With no field requiring grad (humanoid_bench, its base Model or
  rows that do not require grad), in grad mode and under
  differentiable_mode, every table is built on the first step and kept:
  the second step builds none and keeps every object."""
  hits = _count_grad_builds(monkeypatch)
  m = mjtpu_torch.model_from_arrays(
      mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / "humanoid_bench_model.npz"),
      dtype=torch.float64, device="cpu")
  if randomized:
    m, _ = parallel.randomize(m, {k: v.detach() for k, v in _leaves(
        m, ("geom_friction", "body_mass", "dof_damping", "opt.timestep")).items()})
  d = mjtpu_torch.make_data(m, batch_size=PROBE_BATCH)
  kept = None
  for _ in range(2):
    with mjtpu_torch.differentiable_mode():
      d = mjtpu_torch.step(m, d)
    d = mjtpu_torch.step(m, d)
    if kept is None:
      kept = dict(m.cache)
  assert not hits, hits
  assert m.cache.keys() == kept.keys()
  assert all(m.cache[k] is v for k, v in kept.items())
  assert "collision.group_params" in kept and "constraint.limit_rows" in kept


def _walk(x, path, out, seen):
  """Appends the path of every tensor that requires grad in ``x``."""
  if id(x) in seen or isinstance(x, types.Model):
    return
  seen.add(id(x))
  if isinstance(x, torch.Tensor):
    if x.requires_grad:
      out.append(path)
  elif isinstance(x, dict):
    for k, v in x.items():
      _walk(v, f"{path}[{k!r}]", out, seen)
  elif isinstance(x, (list, tuple)):
    for i, v in enumerate(x):
      _walk(v, f"{path}[{i}]", out, seen)
  elif isinstance(x, functools.partial):
    _walk((x.args, x.keywords), path, out, seen)
  elif hasattr(x, "__dict__"):
    _walk(vars(x), path + ".", out, seen)


@pytest.mark.parametrize("bundle, name, substeps", [
    ("randomize_fields", "fields", 1), ("randomize_fields", "sensing", 1),
    ("randomize_fields", "humanoid_terrain", 1), ("implicit_scenes", "implicit_fluid", 2)])
def test_kept_tables_hold_no_graph(bundle, name, substeps):
  """Every traced field of a scene a base tensor that requires grad: after
  two steps (with adaptive substeps, whose substep Model and the implicit
  derivative's stacked Model are rebuilt with shared tables), no table
  the Model keeps holds a tensor that requires grad, and the backward
  reaches every field it reads."""
  m = chip_smoke._bundle_model(bundle, name, "cpu")
  m = replace_fields(m, {"opt.iterations": 1, "opt.ls_iterations": 2})
  leaves = {k: field(m, k).detach().clone().requires_grad_(True) for k in sorted(_ACCEPTED)
            if isinstance(field(m, k), torch.Tensor) and field(m, k).numel()}
  mg = replace_fields(m, leaves)
  d = mjtpu_torch.make_data(mg, batch_size=PROBE_BATCH)
  cfg = {"adaptive_integration": True, "adaptive_substeps": substeps} if substeps > 1 else {}
  with mjtpu_torch.differentiable_mode(**cfg):
    for _ in range(2):
      d = mjtpu_torch.step(mg, d)
  held = []
  for k, v in mg.cache.items():
    _walk(v, repr(k), held, set())
  assert not held, held
  chip_smoke.model_grad_loss(d).sum().backward()
  assert all(bool(torch.isfinite(v.grad).all()) for v in leaves.values() if v.grad is not None)
  assert leaves["body_mass"].grad is not None and leaves["opt.timestep"].grad is not None


def test_derived_models_share_their_tables():
  """A substep Model rebuilt for grad mode keeps its tables in one dict on
  its parent: a second step builds none of the tables that are not live
  (the index tables), and keeps no live one."""
  m = _probe()
  leaf = m.opt.timestep.detach().clone().requires_grad_(True)
  mg = replace_fields(m, {"opt.timestep": leaf})
  d = mjtpu_torch.make_data(mg, batch_size=PROBE_BATCH)
  with mjtpu_torch.differentiable_mode(adaptive_integration=True, adaptive_substeps=2):
    d = mjtpu_torch.step(mg, d)
    shared = mg.cache[(("forward.substep", 2), "cache")]
    kept = dict(shared)
    d = mjtpu_torch.step(mg, d)
  assert ("forward.substep", 2) not in mg.cache
  assert "collision.schedule" in kept and "collision.group_params" not in kept
  assert shared.keys() == kept.keys() and all(shared[k] is v for k, v in kept.items())
  torch.sum(d.qpos ** 2).backward()
  assert leaf.grad is not None and bool(leaf.grad != 0)


def test_scene_specs_name_every_randomize_fields_scene():
  """The model_grad scenes are the randomize_fields scenes, each with its
  rows, start, steps and solver bounds in the golden."""
  assert set(chip_smoke.MODEL_GRAD_SCENES) == set(
      io.bundle_names(mjtpu_torch.ASSETS / "randomize_fields.npz"))
  for name in SCENES:
    steps = int(_golden()[f"{name}.steps"])
    assert _golden()[f"{name}.qpos"].shape[0] == steps
