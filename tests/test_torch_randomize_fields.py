"""mjtpu_torch.parallel.randomize over every traced field mjtpu's accepts.

The randomize_fields scenes (scripts/torch_port_assets.py --model
randomize_fields) perturb each traced field of mjtpu's Model in an env of
its own beside a base env 0, on small models that between them read every
field, and step through parallel.randomized_step at f64 on the CPU against
mjtpu's batched randomized rollout in the committed golden
(chip_smoke.field_scene_errors, which side phase 32-fields runs on the
card): each field's env within RANDOM_BOUND of scale over every step and
output, and that env's state at every step stepped once alone under its
own unbatched Model within RANDOM_SELF_BOUND of the batch.  A field that
leaves mjtpu's env where the base env goes (read nowhere: light_dir0,
dof_M0, the OVERRIDE fields, C17; read by the renderer only; gear on a
baked moment matrix, C19; or held by the scene's physics) leaves the
port's there too.  The two main paths at B=4: humanoid_bench with
bench_randomization's locomotion fields (C1's bound through step 50) and
humanoid_terrain with per-env heights and friction.  mjtpu's refusals
raise in both packages; the renderer refuses per-env colours and lights
(C21), as mjtpu's cannot draw them; mjtpu's in_axes tree fails on a model
with mesh hulls (C20).
"""

import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import chip_smoke
import mjtpu
import mjtpu_torch
from mjtpu import parallel as j_parallel
from mjtpu._src import types as j_types
from mjtpu_torch import parallel
from mjtpu_torch._src import io, render
from mjtpu_torch._src.types import field
from mjtpu_torch.parallel.randomize import _ACCEPTED
from tests.conftest import load_mj

torch.set_num_threads(1)

GOLDEN = np.load(mjtpu_torch.ASSETS / "randomize_fields_golden.npz")
SCENES = io.bundle_names(mjtpu_torch.ASSETS / "randomize_fields.npz")
MAIN_PATHS = ("humanoid_bench", "humanoid_terrain")
# field -> [(scene, its env)]
HOMES: dict[str, list[tuple[str, int]]] = {}
for _scene in SCENES:
  if f"{_scene}.fields" in GOLDEN.files:
    for _k, _name in enumerate(GOLDEN[f"{_scene}.fields"]):
      HOMES.setdefault(str(_name), []).append((_scene, _k + 1))

# MuJoCo C's cartpole qvel after 10 steps from rest at ctrl 0.7 with the
# gear x 2, and mjtpu's (which keeps the base gear, ROADMAP C19)
C19_C_QVEL = (0.67925, -1.58623)
C19_MJTPU_QVEL = (0.33964, -0.79324)

BALL_XML = """<mujoco><option timestep="0.005"/><worldbody>
<geom type="plane" size="5 5 .1"/><body pos="0 0 0.28"><freejoint/>
<geom type="sphere" size="0.3" mass="1" friction="1 .005 .0001"/></body></worldbody></mujoco>"""
TENDON_XML = """<mujoco><worldbody><body><joint name="a" type="hinge"/>
<geom type="capsule" fromto="0 0 0 0 0 -0.3" size="0.02"/></body></worldbody>
<tendon><fixed limited="true" range="-0.5 0.5" margin="0.1"><joint joint="a" coef="1"/></fixed>
</tendon></mujoco>"""


@pytest.fixture(scope="module")
def errors():
  """Each scene's chip_smoke.field_scene_errors, computed on first use."""
  cache = {}

  def get(name):
    if name not in cache:
      cache[name] = chip_smoke.field_scene_errors(name, GOLDEN, "cpu")
    return cache[name]

  return get


def _mjtpu_traced() -> set[str]:
  """The dotted paths of mjtpu's traced Model fields."""
  out = set()
  for name in j_types.Model._mjtpu_data_fields:
    sub = {"opt": j_types.Option, "stat": j_types.Statistic}.get(name)
    out |= {f"{name}.{f}" for f in sub._mjtpu_data_fields} if sub else {name}
  return out


def test_traced_fields_agree_with_mjtpu():
  """The port accepts exactly mjtpu's traced fields, and the golden
  perturbs each of them in some scene."""
  assert _ACCEPTED == _mjtpu_traced()
  assert set(HOMES) == _ACCEPTED


@pytest.mark.parametrize("name", sorted(_ACCEPTED))
def test_field_matches_mjtpu(name, errors):
  """The env that holds field ``name`` perturbed: the batched run within
  RANDOM_BOUND of mjtpu's over every step and output, its one-step
  restarts alone under its own Model within RANDOM_SELF_BOUND of the
  batch, and parted from the base env exactly where mjtpu's is."""
  for scene, env in HOMES[name]:
    errs = errors(scene)
    assert errs["mjtpu"][env] <= chip_smoke.RANDOM_BOUND, (scene, errs["mjtpu"][env])
    assert errs["self"][env] <= chip_smoke.RANDOM_SELF_BOUND, (scene, errs["self"][env])
    assert (errs["moved"][env] == 0.0) == (errs["mjtpu_moved"][env] == 0.0), (
        scene, errs["moved"][env], errs["mjtpu_moved"][env])


def test_fields_that_move_nothing():
  """The fields that leave mjtpu's env with the base env, pinned: read
  nowhere (light_dir0, dof_M0, the OVERRIDE fields), by the renderer only,
  gear on a baked moment matrix (C19), the gaps and bounding radii of
  contacts that are detected either way, a pyramidal pair's
  solreffriction, and frictionloss where it holds the scene still or
  slides at its bound."""
  still = {(scene, str(f)) for scene in SCENES if f"{scene}.fields" in GOLDEN.files
           for k, f in enumerate(GOLDEN[f"{scene}.fields"])
           if np.abs(GOLDEN[f"{scene}.qpos"][:, k + 1] - GOLDEN[f"{scene}.qpos"][:, 0]).max() == 0
           and all(np.array_equal(GOLDEN[f"{scene}.{o}"][:, k + 1], GOLDEN[f"{scene}.{o}"][:, 0])
                   for o in chip_smoke.FIELD_OUTPUTS if f"{scene}.{o}" in GOLDEN.files)}
  assert still == {
      ("fields", "opt.o_margin"), ("fields", "opt.o_solref"), ("fields", "opt.o_solimp"),
      ("fields", "dof_M0"), ("fields", "dof_solref"), ("fields", "geom_rbound"),
      ("sensing", "geom_gap"), ("sensing", "pair_gap"), ("sensing", "pair_solreffriction"),
      ("sensing", "light_dir0"), ("sensing", "geom_rgba"),
      *(("sensing", f) for f in render.RENDER_MODEL_FIELDS if f != "geom_rgba"),
      ("friction", "dof_frictionloss"), ("friction", "tendon_frictionloss"),
      ("cartpole_gear", "actuator_gear")}


@pytest.mark.parametrize("name", MAIN_PATHS)
def test_main_path_matches_mjtpu(name, errors):
  """humanoid_bench with the main path's rows and their constants within
  RANDOM_BENCH_BOUND through step RANDOM_BENCH_STEPS (C1); the per-env
  terrain within RANDOM_BOUND; each env's restarts within
  RANDOM_SELF_BOUND."""
  errs = errors(name)
  key, bound, _ = chip_smoke.field_bounds(name)
  assert errs[key].max() <= bound, errs
  assert np.nanmax(errs["self"]) <= chip_smoke.RANDOM_SELF_BOUND, errs
  assert errs["mjtpu_moved"][1:].min() > 0.0


def test_main_path_rows_are_chip_smokes():
  """The golden's main-path rows are chip_smoke's at B=4 (phase 33 takes
  the B=4096 sample of the same functions), and its B=4096 constants
  belong to the B=4096 masses and body positions."""
  bench = mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / "humanoid_bench_model.npz")
  rows = chip_smoke.bench_randomization(bench, 4, locomotion=True)
  for k, v in rows.items():
    np.testing.assert_array_equal(GOLDEN[f"humanoid_bench.rows.{k}"], v, err_msg=k)
  big = chip_smoke.bench_randomization(bench, chip_smoke.BENCH_BATCH, locomotion=True)
  for k in ("body_mass", "body_pos"):
    np.testing.assert_array_equal(GOLDEN[f"bench.rows.{k}"], big[k], err_msg=k)
  terrain = mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / "humanoid_terrain_model.npz")
  for k, v in chip_smoke.terrain_randomization(terrain, 4).items():
    np.testing.assert_array_equal(GOLDEN[f"humanoid_terrain.rows.{k}"], v, err_msg=k)


def test_bench_locomotion_fields_move_humanoid_bench():
  """Each of chip_smoke.BENCH_LOCOMOTION_FIELDS alone moves
  humanoid_bench's trajectory (the port's run: env k + 1 takes field k's
  first row, env 0 the base)."""
  ns = mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / "humanoid_bench_model.npz")
  m = mjtpu_torch.model_from_arrays(ns, device="cpu")
  sample = chip_smoke.bench_randomization(ns, 1, locomotion=True)
  names = chip_smoke.BENCH_LOCOMOTION_FIELDS
  B = len(names) + 1
  rows = {}
  for k, name in enumerate(names):
    r = np.repeat(np.asarray(getattr(ns, name), dtype=np.float64)[None], B, axis=0)
    r[k + 1] = sample[name][0]
    rows[name] = r
  qpos, qvel, ctrl = (torch.as_tensor(np.repeat(GOLDEN[f"humanoid_bench.{k}0"][:1], B, 0))
                      for k in ("qpos", "qvel", "ctrl"))
  d = mjtpu_torch.replace(mjtpu_torch.make_data(m, B), qpos=qpos, qvel=qvel, ctrl=ctrl)
  step, _ = parallel.randomized_step(m, rows)
  moved = np.zeros(B)
  for _ in range(20):
    d = step(d)
    moved = np.maximum(moved, (d.qvel - d.qvel[:1]).abs().amax(dim=1).numpy())
  assert (moved[1:] > 1e-9).all(), dict(zip(names, moved[1:]))


def _refusal_cases():
  """(label, model loader, updates builder) of each of mjtpu's refusals."""
  cart = lambda: load_mj("cartpole.xml")
  ball = lambda: mujoco.MjModel.from_xml_string(BALL_XML)
  tendon = lambda: mujoco.MjModel.from_xml_string(TENDON_XML)
  tile = lambda x, n=2: np.repeat(np.asarray(x, dtype=np.float64)[None], n, axis=0)

  def margin_flip(mjm):
    v = tile(mjm.jnt_margin)
    v[1] = 10.0
    return {"jnt_margin": v}

  def frictionloss(mjm):
    v = tile(mjm.dof_frictionloss)
    v[:, 0] = 0.5
    return {"dof_frictionloss": v}

  def tendon_flip(mjm):
    v = tile(mjm.tendon_range)
    v[1] = [-0.05, 0.05]
    return {"tendon_range": v}

  def box_size(mjm):
    v = tile(mjm.geom_size)
    v[1, 0, 0] = 6.0  # the plane
    return {"geom_size": v}

  return {
      "static": (cart, lambda mjm: {"geom_type": np.zeros((2, mjm.ngeom))}, "static"),
      "static_moment": (cart, lambda mjm: {"actuator_static_moment": np.zeros((2, 1, 2))},
                        "static"),
      "unknown": (cart, lambda mjm: {"not_a_field": np.zeros((2, 3))}, "no traced field"),
      "gate": (ball, lambda mjm: {"dof_damping": np.ones((2, mjm.nv))}, "has_dof_damping"),
      "fluid_gate": (ball, lambda mjm: {"geom_fluid": np.zeros((2, mjm.ngeom, 12))},
                     "has_fluid_params"),
      "frictionloss": (ball, frictionloss, "nonzero-dof set"),
      "joint_two_sided": (cart, margin_flip, "two-sided"),
      "tendon_two_sided": (tendon, tendon_flip, "two-sided"),
      "round_only": (ball, box_size, "round primitive"),
  }


@pytest.mark.parametrize("case", sorted(_refusal_cases()))
def test_refusal_matches_mjtpu(case):
  """Both packages refuse the same updates with a ValueError saying why
  (the static moment matrix too: mjtpu declares it static)."""
  load, updates, words = _refusal_cases()[case]
  mjm = load()
  rows = updates(mjm)
  with pytest.raises(ValueError, match=words):
    j_parallel.randomize(mjtpu.put_model(mjm), {k: jnp.asarray(v) for k, v in rows.items()})
  with pytest.raises(ValueError, match=words):
    parallel.randomize(mjtpu_torch.put_model(mjm, device="cpu"), rows)


def test_light_dir0_carried_and_accepted():
  """The Model carries light_dir0 from put_model and from a snapshot (read
  nowhere, as in mjtpu), and randomize takes rows of it."""
  mjm = load_mj("cartpole.xml")
  m = mjtpu_torch.put_model(mujoco.MjModel.from_xml_string(
      "<mujoco><worldbody><light pos='0 0 2' dir='0 0.6 -0.8'/><body><freejoint/>"
      "<geom size='.1'/></body></worldbody></mujoco>"), device="cpu")
  np.testing.assert_array_equal(m.light_dir0.numpy(), [[0.0, 0.6, -0.8]])
  snap = mjtpu_torch.model_from_arrays(mjtpu_torch.load_snapshot(
      mjtpu_torch.ASSETS / "satellite_small_model.npz"), device="cpu")
  assert snap.light_dir0.shape == (snap.nlight, 3) and snap.nlight == 1
  mb, axes = parallel.randomize(m, {"light_dir0": np.zeros((2, 1, 3))})
  assert axes["light_dir0"] == 0 and mb.env_fields == {"light_dir0"}
  assert mjtpu_torch.put_model(mjm, device="cpu").light_dir0.shape == (0, 3)


def test_c19_static_moment_keeps_base_gear():
  """ROADMAP C19: on cartpole, whose moment matrix put_model bakes, env 1
  with the gear x 2 steps as the base env in mjtpu (the golden) and in
  the port, and MuJoCo C's qvel parts from both."""
  errs = chip_smoke.field_scene_errors("cartpole_gear", GOLDEN, "cpu")
  assert errs["mjtpu_moved"][1] == 0.0 and errs["moved"][1] == 0.0
  assert errs["mjtpu"].max() <= chip_smoke.RANDOM_BOUND
  qvel = GOLDEN["cartpole_gear.qvel"][-1]
  np.testing.assert_allclose(qvel[1], C19_MJTPU_QVEL, atol=1e-5)
  mjm = load_mj("cartpole.xml")
  mjm.actuator_gear[:, 0] *= 2.0
  mjd = mujoco.MjData(mjm)
  mjd.ctrl[:] = 0.7
  for _ in range(10):
    mujoco.mj_step(mjm, mjd)
  np.testing.assert_allclose(mjd.qvel, C19_C_QVEL, atol=1e-5)
  assert np.abs(mjd.qvel - qvel[1]).max() > 0.3


def test_gear_moves_without_static_moment(errors):
  """ROADMAP C19's other half: on FIELDS_XML (a tendon and a muscle
  transmission, so no baked moment matrix) and on the slider-crank, gear
  rows move the env in both packages."""
  for scene, env in HOMES["actuator_gear"]:
    if scene != "cartpole_gear":
      errs = errors(scene)
      assert errs["mjtpu_moved"][env] > 0.0 and errs["moved"][env] > 0.0, scene


@pytest.fixture(scope="module")
def render_scene():
  """(MjModel, the port's Model and Data, mjtpu's Model and Data) of
  render_scene_xml at B=2 after a forward."""
  import jax

  mjm = mujoco.MjModel.from_xml_string(render_scene_xml())
  m = mjtpu_torch.put_model(mjm, device="cpu")
  d = mjtpu_torch.forward(m, mjtpu_torch.make_data(m, 2))
  m_j = mjtpu.put_model(mjm)
  d_j = jax.vmap(lambda _: mjtpu.make_data(m_j))(jnp.arange(2))
  d_j = jax.jit(jax.vmap(mjtpu.forward, in_axes=(None, 0)))(m_j, d_j)
  return mjm, m, d, m_j, d_j


@pytest.mark.parametrize("name", render.RENDER_MODEL_FIELDS)
def test_render_refuses_env_rows(name, render_scene):
  """ROADMAP C21: a Model with rows of the renderer's colours or lights
  is refused by name; mjtpu's render_batch fails on it, or (the light
  attenuation) draws its base env otherwise than its base Model."""
  import jax

  mjm, m, d, m_j, d_j = render_scene
  base = np.asarray(getattr(m, name), dtype=np.float64)
  rows = np.repeat(base[None], 2, axis=0)
  rows[1] *= 0.5
  mb, _ = parallel.randomize(m, {name: rows})
  with pytest.raises(NotImplementedError, match=name):
    mjtpu_torch.render_batch(mb, d, width=8, height=6)
  with pytest.raises(NotImplementedError, match=name):
    mjtpu_torch.render(mb, d, width=8, height=6, rd=mjtpu_torch.precompute_render_data(m))
  mb_j, _ = j_parallel.randomize(m_j, {name: jnp.asarray(rows)})
  draw = lambda mm: np.asarray(jax.jit(lambda dd: mjtpu.render_batch(mm, dd, width=8,
                                                                     height=6))(d_j))
  if name != "light_attenuation":
    with pytest.raises((TypeError, IndexError, ValueError)):
      draw(mb_j)
  else:
    assert np.abs(draw(mb_j)[0] - draw(m_j)[0]).max() > 1e-3


def render_scene_xml() -> str:
  """A camera, a point light whose attenuation falls off with distance,
  a spot light and a coloured sphere on a plane."""
  return """<mujoco><worldbody>
  <camera pos="0 -2 1" xyaxes="1 0 0 0 0.45 1"/>
  <light pos="0.3 -0.5 0.8" dir="0 0 -1" attenuation="1 0.8 0.4" cutoff="60" exponent="2"/>
  <light pos="-0.5 0 1.5" dir="0.3 0 -1" cutoff="40" exponent="5"/>
  <geom type="plane" size="2 2 .1" rgba=".8 .8 .8 1"/>
  <body pos="0 0 0.3"><geom type="sphere" size=".3" rgba=".9 .3 .2 1"/></body>
</worldbody></mujoco>"""


def test_mjtpu_in_axes_fail_on_mesh_models():
  """ROADMAP C20: mjtpu's randomized_step raises TypeError on a model with
  a mesh hull (its in_axes tree hashes the hull's arrays), so the terrain
  golden maps mjtpu's step over the rows itself; the port steps such a
  model through randomized_step (test_main_path_matches_mjtpu)."""
  mjm = mujoco.MjModel.from_xml_string(
      '<mujoco><asset><mesh name="t" vertex="0 0 0 1 0 0 0 1 0 0 0 1"/></asset><worldbody>'
      '<geom type="plane" size="1 1 .1"/><body pos="0 0 1"><freejoint/><geom type="mesh"'
      ' mesh="t"/></body></worldbody></mujoco>')
  m_j = mjtpu.put_model(mjm)
  import jax

  rows = np.repeat(np.asarray(m_j.geom_friction)[None], 2, axis=0)
  step, _ = j_parallel.randomized_step(m_j, {"geom_friction": jnp.asarray(rows)})
  with pytest.raises(TypeError, match="unhashable"):
    step(jax.vmap(lambda _: mjtpu.make_data(m_j))(jnp.arange(2)))
  m = mjtpu_torch.put_model(mjm, device="cpu")
  step_t, _ = parallel.randomized_step(m, {"geom_friction": rows})
  assert torch.isfinite(step_t(mjtpu_torch.make_data(m, 2)).qpos).all()


def test_model_axes_name_every_randomized_field():
  """model_axes maps every accepted path, and only the randomized ones on
  0; the static moment matrix is not among its paths, as mjtpu's tree
  holds it as a static field."""
  m = mjtpu_torch.put_model(load_mj("cartpole.xml"), device="cpu")
  keys = ("jnt_solref", "opt.wind", "actuator_gear", "geom_rbound")
  mb, axes = parallel.randomize(m, {k: torch.stack([field(m, k)] * 2) for k in keys})
  assert set(axes) == _ACCEPTED - {"dof_M0"} and "actuator_static_moment" not in axes
  assert {k for k, v in axes.items() if v == 0} == set(keys) == mb.env_fields


def test_make_data_takes_each_envs_mocap_frame():
  """make_data of a Model with body_pos and body_quat rows starts each
  env's mocap bodies at its own body frame, as mjtpu's make_data mapped
  over the Model's axes does."""
  mjm = load_mj("mocap.xml")
  m = mjtpu_torch.put_model(mjm, device="cpu")
  pos = np.repeat(m.body_pos.numpy()[None], 3, axis=0)
  pos[1] += 0.1
  quat = np.repeat(m.body_quat.numpy()[None], 3, axis=0)
  quat[2] = quat[2, :, [0, 2, 1, 3]].T
  rows = {"body_pos": pos, "body_quat": quat}
  d = mjtpu_torch.make_data(parallel.randomize(m, rows)[0], 3)
  import jax

  mb_j, axes = j_parallel.randomize(mjtpu.put_model(mjm), {k: jnp.asarray(v)
                                                         for k, v in rows.items()})
  d_j = jax.vmap(mjtpu.make_data, in_axes=(axes,))(mb_j)
  np.testing.assert_array_equal(d.mocap_pos.numpy(), np.asarray(d_j.mocap_pos))
  np.testing.assert_array_equal(d.mocap_quat.numpy(), np.asarray(d_j.mocap_quat))
  assert np.ptp(d.mocap_pos.numpy(), axis=0).max() > 0
