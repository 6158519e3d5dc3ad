"""mjtpu_torch.parallel (per-env Model rows) against mjtpu.parallel.

The randomize scenes (randomize_scenes.npz: tests/test_randomize.py's
friction, mass/gain/damping/timestep, sphere-radius and
constants-from-mj_setConst cases, and humanoid_bench with the main path's
five randomized fields and their constants) step through
parallel.randomized_step at f64 on the CPU against mjtpu's batched
randomized rollout in the committed golden, and each env stepped alone
under its own unbatched Model against the batched run, beside the same
check on the base Model (a batch against batches of one, no rows).
Every field of the first randomize slice (FIELDS) moves the trajectory
of a model that reads it, and mjtpu's guards raise its errors; every
other traced field is held to mjtpu in tests/test_torch_randomize_fields.py.
"""

import copy

import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import chip_smoke
import mjtpu
import mjtpu_torch
from mjtpu import parallel as j_parallel
from mjtpu_torch import parallel
from mjtpu_torch._src import io
from mjtpu_torch._src.types import field
from tests.conftest import load_mj

BALL_XML = """<mujoco><option timestep="0.005"/><worldbody>
<geom type="plane" size="5 5 .1"/><body pos="0 0 0.28"><freejoint/>
<geom type="sphere" size="0.3" mass="1" friction="1 .005 .0001"/></body></worldbody></mujoco>"""

SCENES = io.bundle_names(mjtpu_torch.ASSETS / "randomize_scenes.npz")


@pytest.fixture(scope="module")
def golden():
  return np.load(mjtpu_torch.ASSETS / "randomize_scenes_golden.npz")


@pytest.mark.parametrize("name", SCENES)
def test_scene_matches_mjtpu(name, golden):
  """The port's batched randomized run against mjtpu's, and each env
  alone under its own Model against the batched run, within
  chip_smoke.randomize_bounds: RANDOM_BOUND and RANDOM_SELF_BOUND over the
  golden's steps; humanoid_bench, whose truncated solver turns the ULP
  differences of a batch of 4 against a batch of 1 into jumps (C1), within
  RANDOM_BENCH_BOUND through step RANDOM_BENCH_STEPS for both.  Each
  env's state at every step, stepped once under its own Model, matches
  the batch's next step within RANDOM_SELF_BOUND in every scene,
  humanoid_bench too."""
  errs = chip_smoke.randomize_scene_errors(name, golden, "cpu")
  key, bound, self_bound = chip_smoke.randomize_bounds(name)
  assert errs[key] <= bound, errs
  assert errs["self"] <= self_bound, errs
  assert errs["restart"] <= chip_smoke.RANDOM_SELF_BOUND, errs


def _run(m, updates, steps, **start):
  batch = next(iter(updates.values())).shape[0]
  d = mjtpu_torch.make_data(m, batch)
  d = mjtpu_torch.replace(d, **{k: torch.as_tensor(np.asarray(v, dtype=np.float64)).expand(
      batch, -1).clone() for k, v in start.items()})
  step, _ = parallel.randomized_step(m, updates)
  for _ in range(steps):
    d = step(d)
  return d


def test_friction_randomization_moves_the_slide():
  mjm = mujoco.MjModel.from_xml_string(BALL_XML)
  m = mjtpu_torch.put_model(mjm, device="cpu")
  fric = np.tile(np.array(mjm.geom_friction), (4, 1, 1))
  fric[:, :, 0] = np.array([[0.01, 0.05, 0.2, 0.8]]).T
  qvel = np.zeros(mjm.nv)
  qvel[0] = 4.0
  vx = _run(m, {"geom_friction": fric}, 15, qvel=qvel).qvel[:, 0].numpy()
  assert np.ptp(vx) > 1e-3, vx


def test_sphere_radius_sets_the_resting_height():
  mjm = mujoco.MjModel.from_xml_string(BALL_XML)
  m = mjtpu_torch.put_model(mjm, device="cpu")
  size = np.tile(np.array(mjm.geom_size), (3, 1, 1))
  size[:, 1, 0] = [0.25, 0.3, 0.35]
  z = _run(m, {"geom_size": size}, 40).qpos[:, 2].numpy()
  assert z[0] < z[1] < z[2], z


def test_model_axes_inference():
  m = mjtpu_torch.put_model(load_mj("cartpole.xml"), device="cpu")
  mb, axes = parallel.randomize(m, {"body_mass": m.body_mass.expand(4, -1).clone()})
  assert axes["body_mass"] == 0
  assert axes["geom_friction"] is None and axes["opt.timestep"] is None
  assert parallel.model_axes(m, mb) == axes
  assert mb.env_fields == {"body_mass"} and not m.env_fields


def test_axes_match_mjtpu():
  """The axes name the same leaves mjtpu's in_axes tree maps on 0."""
  mjm = load_mj("cartpole.xml")
  jm = mjtpu.put_model(mjm)
  _, j_axes = j_parallel.randomize(jm, {"opt.timestep": jnp.full((2,), 0.01),
                                        "dof_damping": jnp.ones((2, mjm.nv))})
  m = mjtpu_torch.put_model(mjm, device="cpu")
  _, axes = parallel.randomize(m, {"opt.timestep": np.full((2,), 0.01),
                                   "dof_damping": np.ones((2, mjm.nv))})
  assert {k for k, v in axes.items() if v == 0} == {"opt.timestep", "dof_damping"}
  assert j_axes.opt.timestep == 0 and j_axes.dof_damping == 0


def test_static_field_rejected():
  m = mjtpu_torch.put_model(load_mj("cartpole.xml"), device="cpu")
  with pytest.raises(ValueError, match="static"):
    parallel.randomize(m, {"geom_type": np.zeros((2, m.ngeom), np.int32)})
  with pytest.raises(ValueError, match="no traced field"):
    parallel.randomize(m, {"not_a_field": np.zeros((2, 3))})


def test_shape_and_batch_mismatch_rejected():
  m = mjtpu_torch.put_model(load_mj("cartpole.xml"), device="cpu")
  with pytest.raises(ValueError, match="expected shape"):
    parallel.randomize(m, {"body_mass": np.zeros(m.nbody)})
  with pytest.raises(ValueError, match="inconsistent batch"):
    parallel.randomize(m, {"body_mass": np.zeros((2, m.nbody)),
                           "dof_damping": np.ones((3, m.nv))})


def test_structural_gate_rejected():
  m = mjtpu_torch.put_model(mujoco.MjModel.from_xml_string(BALL_XML), device="cpu")
  assert not m.has_dof_damping
  with pytest.raises(ValueError, match="has_dof_damping"):
    parallel.randomize(m, {"dof_damping": np.ones((2, m.nv))})


def test_frictionloss_pattern_guard():
  m = mjtpu_torch.put_model(mujoco.MjModel.from_xml_string(BALL_XML), device="cpu")
  v = np.zeros((2, m.nv))
  v[:, 0] = 0.5
  with pytest.raises(ValueError, match="nonzero-dof set"):
    parallel.randomize(m, {"dof_frictionloss": v})


def test_limit_two_sidedness_guard():
  mjm = load_mj("cartpole.xml")
  m = mjtpu_torch.put_model(mjm, device="cpu")
  mrg = np.tile(np.array(mjm.jnt_margin), (2, 1))
  mrg[1] = 10.0
  with pytest.raises(ValueError, match="two-sided"):
    parallel.randomize(m, {"jnt_margin": mrg})
  rng = np.tile(np.array(mjm.jnt_range), (2, 1, 1))
  rng[1] = rng[1][:, ::-1]  # a negative width: narrower than 2 * margin
  with pytest.raises(ValueError, match="two-sided"):
    parallel.randomize(m, {"jnt_range": rng})


def test_geom_size_round_only():
  mjm = mujoco.MjModel.from_xml_string(BALL_XML)
  m = mjtpu_torch.put_model(mjm, device="cpu")
  size = np.tile(np.array(mjm.geom_size), (3, 1, 1))
  size[:, 1, 0] = [0.25, 0.3, 0.35]
  _, axes = parallel.randomize(m, {"geom_size": size})
  assert axes["geom_size"] == 0
  size2 = np.tile(np.array(mjm.geom_size), (3, 1, 1))
  size2[:, 0, 0] = [4.0, 5.0, 6.0]
  with pytest.raises(ValueError, match="round primitive"):
    parallel.randomize(m, {"geom_size": size2})


def test_randomize_with_consts_matches_fresh_put_model():
  """Mass rows with their constants from mj_setConst step as a fresh
  put_model of each env's modified MjModel does, within 1e-12."""
  mjm = load_mj("cartpole.xml")
  m = mjtpu_torch.put_model(mjm, device="cpu")
  mass = np.tile(np.array(mjm.body_mass), (3, 1))
  mass[:, 1] *= [0.5, 1.0, 2.0]
  mb, axes = parallel.randomize_with_consts(mjm, m, {"body_mass": mass})
  assert axes["dof_M0"] == 0 and axes["body_invweight0"] == 0 and axes["stat.meaninertia"] == 0
  assert np.ptp(mb.dof_M0.numpy(), axis=0).max() > 0
  start = {"qpos": np.tile([0.1, 0.2], (3, 1)), "ctrl": np.full((3, 1), 0.6)}
  d = mjtpu_torch.replace(mjtpu_torch.make_data(m, 3),
                          **{k: torch.as_tensor(v) for k, v in start.items()})
  batch = d
  for _ in range(10):
    batch = mjtpu_torch.step(mb, batch)
  for i in range(3):
    mjm_i = copy.copy(mjm)
    mjm_i.body_mass[:] = mass[i]
    mujoco.mj_setConst(mjm_i, mujoco.MjData(mjm_i))
    mi = mjtpu_torch.put_model(mjm_i, device="cpu")
    di = chip_smoke._env_data(d, i)
    for _ in range(10):
      di = mjtpu_torch.step(mi, di)
    assert float((batch.qpos[i] - di.qpos[0]).abs().max()) <= 1e-12
    assert float((batch.qvel[i] - di.qvel[0]).abs().max()) <= 1e-12


def test_randomize_with_consts_needs_mujoco(monkeypatch):
  """Without the mujoco bindings randomize_with_consts raises ImportError
  (no fallback)."""
  import builtins

  m = mjtpu_torch.put_model(load_mj("cartpole.xml"), device="cpu")
  real = builtins.__import__
  monkeypatch.setattr(builtins, "__import__", lambda name, *a, **k: (
      (_ for _ in ()).throw(ImportError("no mujoco")) if name == "mujoco" else real(name, *a, **k)))
  with pytest.raises(ImportError):
    parallel.randomize_with_consts(object(), m, {"body_mass": np.ones((2, m.nbody))})


# the fields of the first randomize slice, each held here on FIELDS_XML
FIELDS = (
    "opt.timestep", "opt.gravity",
    "geom_friction", "geom_solref", "geom_solimp", "geom_margin", "geom_size",
    "body_mass", "body_inertia", "body_ipos", "body_gravcomp",
    "dof_damping", "dof_armature", "dof_frictionloss", "jnt_stiffness", "jnt_range",
    "actuator_gainprm", "actuator_biasprm",
    "body_subtreemass", "body_invweight0", "dof_invweight0", "dof_M0", "tendon_invweight0",
    "tendon_length0", "actuator_acc0", "stat.meaninertia",
)

# one model that reads every field of FIELDS: a ball on the
# floor (contact parameters, its size, gravity compensation, the contact
# rows' invweight), a limited hinge arm with damping, armature,
# frictionloss and a spring (the limit and friction rows' invweight), a
# slider on it, a fixed tendon held by an equality (its length0 and
# invweight) and pulled by a muscle (acc0), a motor and a position
# actuator, and a subtree velocity sensor (subtreemass); the solver's
# loose tolerances make meaninertia's scaling decide when it stops
FIELDS_XML = """<mujoco><option timestep="0.005" tolerance="1e-3" ls_tolerance="0.3"/>
<worldbody><geom type="plane" size="5 5 .1"/>
<body name="ball" pos="0 0 0.095" gravcomp="0.2"><freejoint/>
<geom type="sphere" size="0.1" mass="1"/></body>
<body name="arm" pos="1 0 1"><joint name="hinge" type="hinge" axis="0 1 0" damping="0.1"
armature="0.01" frictionloss="0.05" stiffness="1" limited="true" range="-0.3 0.3"/>
<geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.03"/>
<body name="slider" pos="0.3 0 0"><joint name="slide" type="slide" axis="1 0 0" damping="0.1"/>
<geom type="box" size="0.05 0.05 0.05"/></body></body></worldbody>
<tendon><fixed name="t"><joint joint="hinge" coef="0.2"/><joint joint="slide" coef="1"/></fixed>
</tendon><equality><tendon tendon1="t" solref="0.05 1"/></equality>
<actuator><motor joint="hinge" gear="1"/><position joint="slide" kp="10"/>
<muscle tendon="t" lengthrange="-1 1"/></actuator>
<sensor><subtreelinvel body="arm"/></sensor></mujoco>"""


def _base(m, name):
  """Field ``name``'s base value (dof_M0, which put_model leaves out as
  it is read nowhere: zeros)."""
  x = field(m, name)
  return m.qpos0.new_zeros(m.nv) if x is None else x


def _perturbed(m, name):
  """A perturbed copy of field ``name``'s base value."""
  base = _base(m, name).clone()
  if name == "dof_M0":
    return base + 1.0
  if name == "jnt_range":
    return base * 0.8
  if name == "geom_size":
    base[1, 0] *= 1.2  # the ball's radius
    return base
  if name == "dof_frictionloss":
    return torch.where(base > 0, base * 2.0, base)
  if name == "opt.gravity":
    return base * 0.9
  if name == "stat.meaninertia":
    return base * 1e4  # the rescaled tolerance stops the solver earlier
  if name in ("geom_margin", "tendon_length0"):  # zero at the base
    return base + 0.02
  return base * 1.3


@pytest.fixture(scope="module")
def field_runs():
  """One batched run of FIELDS_XML (f64, 20 steps) in which env 0 has the
  base model and env k+1 field k of FIELDS perturbed, each env also
  stepped alone under its own Model: {field: (|env k+1 - env 0|, |env k+1
  - alone|)} over qpos, qvel and sensordata."""
  mjm = mujoco.MjModel.from_xml_string(FIELDS_XML)
  m = mjtpu_torch.put_model(mjm, device="cpu")
  names = sorted(FIELDS)
  B = len(names) + 1
  rows = {}
  for k, name in enumerate(names):
    base = _base(m, name)
    r = base.expand((B,) + tuple(base.shape)).clone()
    r[k + 1] = _perturbed(m, name)
    rows[name] = r
  rng = np.random.default_rng(0)
  qvel = torch.as_tensor(rng.uniform(-0.5, 0.5, m.nv))
  qvel[0] = 1.0  # the ball slides
  d0 = mjtpu_torch.replace(mjtpu_torch.make_data(m, B), qvel=qvel.expand(B, -1).clone(),
                           ctrl=torch.as_tensor([0.3, 0.1, 0.5]).expand(B, -1).clone())
  step, _ = parallel.randomized_step(m, rows)
  d = d0
  for _ in range(20):
    d = step(d)
  out = lambda x: torch.cat([x.qpos, x.qvel, x.sensordata], dim=-1)
  res = {}
  for k, name in enumerate(names):
    di, mi = chip_smoke._env_data(d0, k + 1), chip_smoke._env_model(m, rows, k + 1)
    for _ in range(20):
      di = mjtpu_torch.step(mi, di)
    res[name] = (float((out(d)[k + 1] - out(d)[0]).abs().max()),
                 float((out(d)[k + 1] - out(di)[0]).abs().max()))
  return res


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_field_matters(name, field_runs):
  """Each randomized field moves its env's trajectory (but dof_M0, which
  mjtpu and the port read nowhere), and the batched run equals the env
  stepped alone under its own Model within RANDOM_SELF_BOUND: no cached
  table kept the field's base value."""
  moved, alone = field_runs[name]
  assert alone <= chip_smoke.RANDOM_SELF_BOUND, (name, alone)
  if name == "dof_M0":
    assert moved == 0.0
  else:
    assert moved > 1e-9, (name, moved)
