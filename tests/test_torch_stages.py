"""Stage-by-stage parity of mjtpu_torch against mjtpu at float64 on the CPU.

Every stage of the main path starts from mjtpu's Data before that stage
(converted with data_from_mjtpu) and is held to mjtpu's Data after it, so
a fault shows in the stage that makes it.  Models: humanoid_bench with
contacts and joint limits active, the same with warmstart disabled, and
pendulum.xml with eulerdamp disabled (no constraint rows: the solver is
skipped).  Tolerance: 1e-10 times the field's scale, max(1, max |mjtpu|).
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import mjtpu
from mjtpu._src import collision_driver as j_collision
from mjtpu._src import constraint as j_constraint
from mjtpu._src import forward as j_forward
from mjtpu._src import passive as j_passive
from mjtpu._src import smooth as j_smooth
from mjtpu._src import solver as j_solver
import mjtpu_torch
from mjtpu_torch._src import forward as t_forward
from tests.conftest import load_mj

torch.set_num_threads(1)

HB = str(pathlib.Path(mjtpu.__file__).parent / "zoo" / "assets" / "humanoid_bench.xml")
B = 3


def _vel_pre(m, d):  # fwd_velocity's first line
  return d.replace(actuator_velocity=d.actuator_moment @ d.qvel)


def _t_vel_pre(m, d):
  return mjtpu_torch.replace(
      d, actuator_velocity=torch.einsum("buv,bv->bu", d.actuator_moment, d.qvel))


# (name, mjtpu stage, port stage, fields compared)
STAGES = [
    ("check_state", j_forward._check_state, t_forward._check_state,
     ("qpos", "qvel", "nreset")),
    ("kinematics", j_smooth.kinematics, mjtpu_torch.kinematics,
     ("qpos", "xpos", "xquat", "xmat", "xipos", "ximat", "xanchor", "xaxis",
      "geom_xpos", "geom_xmat")),
    ("com_pos", j_smooth.com_pos, mjtpu_torch.com_pos, ("subtree_com", "cinert", "cdof")),
    ("crb", j_smooth.crb, mjtpu_torch.crb, ("crb", "qM")),
    ("factor_m", j_smooth.factor_m, mjtpu_torch.factor_m, ("qLD", "qLDiagInv")),
    ("collision", j_collision.collision, mjtpu_torch.collision,
     ("contact.dist", "contact.pos", "contact.frame", "contact.includemargin",
      "contact.friction", "contact.solref", "contact.solimp", "contact.geom1",
      "contact.geom2", "contact.efc_address", "contact.dim")),
    ("make_constraint", j_constraint.make_constraint, mjtpu_torch.make_constraint,
     ("efc_J", "efc_aref", "efc_D", "efc_pos", "efc_margin")),
    ("transmission", j_smooth.transmission, mjtpu_torch.transmission,
     ("actuator_length", "actuator_moment")),
    ("actuator_velocity", _vel_pre, _t_vel_pre, ("actuator_velocity",)),
    ("com_vel", j_smooth.com_vel, mjtpu_torch.com_vel, ("cvel", "cdof_dot")),
    ("passive", j_passive.passive, mjtpu_torch.passive,
     ("qfrc_passive", "qfrc_spring", "qfrc_damper")),
    ("rne", j_smooth.rne, mjtpu_torch.rne, ("qfrc_bias",)),
    ("fwd_actuation", j_forward.fwd_actuation, mjtpu_torch.fwd_actuation,
     ("actuator_force", "qfrc_actuator")),
    ("fwd_acceleration", j_forward.fwd_acceleration, mjtpu_torch.fwd_acceleration,
     ("qfrc_smooth", "qacc_smooth")),
    ("solve", j_solver.solve, mjtpu_torch.solve,
     ("qacc", "qacc_warmstart", "efc_force", "qfrc_constraint", "solver_niter")),
    ("euler", j_forward.euler, mjtpu_torch.euler, ("qpos", "qvel", "time")),
]


def _humanoid(warmstart: bool):
  mjm = mujoco.MjModel.from_xml_path(HB)
  if not warmstart:
    mjm.opt.disableflags |= mujoco.mjtDisableBit.mjDSBL_WARMSTART
  rng = np.random.default_rng(1)
  qpos = mjm.qpos0 + rng.uniform(-0.01, 0.01, (B, mjm.nq))
  mjd = mujoco.MjData(mjm)
  feet = [g for g in range(mjm.ngeom) if b"foot" in mjm.names[mjm.name_geomadr[g]:][:8]]
  for b in range(B):
    for j in range(1, mjm.njnt):
      name = mujoco.mj_id2name(mjm, mujoco.mjtObj.mjOBJ_JOINT, j)
      lo, hi = mjm.jnt_range[j]
      adr = mjm.jnt_qposadr[j]
      if name.startswith(("shoulder", "elbow")):  # arms past a stop: limit rows live
        qpos[b, adr] = lo - rng.uniform(0, 0.1) if rng.random() < 0.5 else hi + rng.uniform(0, 0.1)
      elif name.startswith("knee"):
        qpos[b, adr] = rng.uniform(0.0, 0.08)  # past the 2-degree stop
      else:
        qpos[b, adr] = rng.uniform(-0.05, 0.05)
    # lower the body until the lowest foot point is 15 mm into the floor,
    # deep enough that the tilted feet touch at both capsule ends
    mjd.qpos[:] = qpos[b]
    mujoco.mj_kinematics(mjm, mjd)
    low = min(mjd.geom_xpos[g, 2] - abs(mjd.geom_xmat[g, 8]) * mjm.geom_size[g, 1]
              - mjm.geom_size[g, 0] for g in feet)
    qpos[b, 2] -= low + 0.015
  qvel = rng.uniform(-0.5, 0.5, (B, mjm.nv))
  return mjm, qpos, qvel, rng


# a ball joint with a hinge below it (ball_free.xml's chain, without the
# second tree): the ball-joint paths of kinematics, cdof, springs, Euler
BALL_CHAIN = """
<mujoco>
  <worldbody>
    <body pos="0 0 1">
      <joint type="ball" damping="0.02" stiffness="0.5"/>
      <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.03" mass="0.4" contype="0" conaffinity="0"/>
      <body pos="0.3 0 0">
        <joint type="hinge" axis="0 0 1" springref="0.2" stiffness="2.0" damping="0.01"/>
        <geom type="sphere" size="0.05" mass="0.2" contype="0" conaffinity="0"/>
      </body>
    </body>
  </worldbody>
</mujoco>
"""


def _no_eulerdamp(load, seed):
  """A model with joint damping, eulerdamp off (the slice's Euler), from
  random states; cartpole's slider is limited, so its limit row is live."""

  def make():
    mjm = load()
    mjm.opt.disableflags |= mujoco.mjtDisableBit.mjDSBL_EULERDAMP
    rng = np.random.default_rng(seed)
    qpos = mjm.qpos0 + rng.uniform(-2.5, 2.5, (B, mjm.nq))
    qvel = rng.uniform(-1.0, 1.0, (B, mjm.nv))
    return mjm, qpos, qvel, rng

  return make


CASES = {
    "humanoid_bench": lambda: _humanoid(warmstart=True),
    "humanoid_bench_nowarmstart": lambda: _humanoid(warmstart=False),
    "pendulum_noeulerdamp": _no_eulerdamp(lambda: load_mj("pendulum.xml"), 2),
    "cartpole_noeulerdamp": _no_eulerdamp(lambda: load_mj("cartpole.xml"), 3),
    "ball_chain_noeulerdamp": _no_eulerdamp(
        lambda: mujoco.MjModel.from_xml_string(BALL_CHAIN), 4),
}


def _chain(m, d):
  """mjtpu's Data before the first stage and after each one."""
  out = [d]
  for _, j_stage, _, _ in STAGES:
    d = jax.vmap(j_stage, in_axes=(None, 0))(m, d)
    out.append(d)
  return out


@pytest.fixture(scope="module")
def chains():
  """Per case: (port Model, [mjtpu Data before stage 0, after stage 0,
  ...]) with numpy leaves.  The warmstart-disabled humanoid differs from
  the humanoid only in the solver, so it reuses the humanoid's chain up to
  the solver and recomputes the solver and what follows."""
  out = {}
  solve = [s[0] for s in STAGES].index("solve")
  for case, make in CASES.items():
    mjm, qpos, qvel, rng = make()
    m = mjtpu.put_model(mjm, dtype=jnp.float64)
    d = jax.vmap(lambda _: mjtpu.make_data(m))(jnp.arange(B))
    d = d.replace(
        qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel),
        ctrl=jnp.asarray(rng.uniform(-1.0, 1.0, (B, mjm.nu))),
        qacc_warmstart=jnp.asarray(rng.uniform(-1.0, 1.0, (B, mjm.nv))),
    )
    if case == "humanoid_bench_nowarmstart":
      ds = list(out["humanoid_bench"][1][: solve + 1])
      d = jax.tree.map(jnp.asarray, ds[-1])
      for _, j_stage, _, _ in STAGES[solve:]:
        d = jax.jit(jax.vmap(j_stage, in_axes=(None, 0)))(m, d)
        ds.append(jax.tree.map(np.asarray, d))
    else:
      ds = [jax.tree.map(np.asarray, x) for x in jax.jit(_chain)(m, d)]
    out[case] = (mjtpu_torch.put_model(mjm, device="cpu"), ds)
  return out


def _field(obj, name):
  for part in name.split("."):
    obj = getattr(obj, part)
  return np.asarray(obj)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("stage", range(len(STAGES)), ids=[s[0] for s in STAGES])
def test_stage(chains, case, stage):
  name, _, t_stage, fields = STAGES[stage]
  m, ds = chains[case]
  got = mjtpu_torch.data_to_numpy(t_stage(m, mjtpu_torch.data_from_mjtpu(ds[stage], device="cpu")))
  want = ds[stage + 1]
  for f in fields:
    a, b = _field(got, f), _field(want, f)
    assert a.shape == b.shape, (name, f, a.shape, b.shape)
    scale = max(1.0, float(np.abs(b).max())) if b.size else 1.0
    err = float(np.abs(a.astype(np.float64) - b).max()) if b.size else 0.0
    assert err <= 1e-10 * scale, f"{case} {name} {f}: max abs err {err:.3e} (scale {scale:.3g})"


def test_stages_exercise_the_slice(chains):
  """The humanoid states really have live contact and limit rows, and the
  solver really runs (a guard on the inputs above)."""
  m, ds = chains["humanoid_bench"]
  after = dict(zip([s[0] for s in STAGES], ds[1:]))
  ne, nf, nl, ncon, nefc = mjtpu_torch.constraint_sizes(m)
  assert (nl, ncon, nefc) == (21, 8, 53)
  assert (after["collision"].contact.dist < 0).sum() >= B * 4
  limit_rows = after["make_constraint"].efc_J[:, :nl]
  assert (np.abs(limit_rows).max(axis=2) > 0).sum() >= B * 3
  assert (np.abs(after["solve"].efc_force) > 0).any(axis=1).all()


def test_forward_skips_solver_without_rows(chains):
  """pendulum has no constraint rows: forward takes qacc = qacc_smooth."""
  m, ds = chains["pendulum_noeulerdamp"]
  assert mjtpu_torch.count_constraints(m)[3] == 0
  got = mjtpu_torch.forward(m, mjtpu_torch.data_from_mjtpu(ds[1], device="cpu"))
  want = ds[[s[0] for s in STAGES].index("fwd_acceleration") + 1]
  np.testing.assert_allclose(got.qacc.numpy(), want.qacc_smooth, rtol=1e-10, atol=1e-10)
  np.testing.assert_array_equal(got.qacc.numpy(), got.qacc_warmstart.numpy())


@pytest.mark.parametrize("case", list(CASES))
def test_static_layout_matches(case):
  """Row counts, contact condims/addresses and efc row labels."""
  from mjtpu._src import support as j_support
  from mjtpu_torch._src import collision_driver as t_collision
  from mjtpu_torch._src import support as t_support

  mjm = CASES[case]()[0]
  jm, tm = mjtpu.put_model(mjm, dtype=jnp.float64), mjtpu_torch.put_model(mjm, device="cpu")
  assert mjtpu_torch.constraint_sizes(tm) == j_support.constraint_sizes(jm)
  assert mjtpu_torch.count_constraints(tm) == j_support.count_constraints(jm)
  ne, nf, nl, _ = j_support.count_constraints(jm)
  np.testing.assert_array_equal(t_collision.make_condim(tm), j_collision.make_condim(jm))
  np.testing.assert_array_equal(t_collision.contact_efc_address(tm, ne, nf, nl),
                                j_collision.contact_efc_address(jm, ne, nf, nl))
  for a, b in zip(t_support.efc_row_meta(tm), j_support.efc_row_meta(jm)):
    np.testing.assert_array_equal(a, b)


def test_jac_matches(chains):
  from mjtpu._src import support as j_support

  m, ds = chains["humanoid_bench"]
  d = ds[[s[0] for s in STAGES].index("com_pos") + 1]
  jm = mjtpu.put_model(mujoco.MjModel.from_xml_path(HB), dtype=jnp.float64)
  for body in (1, 7, 16):
    point = d.xipos[:, body] + 0.1
    want = jax.vmap(lambda dd, p: j_support.jac(jm, dd, p, body))(
        jax.tree.map(jnp.asarray, d), jnp.asarray(point))
    got = mjtpu_torch.jac(m, mjtpu_torch.data_from_mjtpu(d, device="cpu"), torch.as_tensor(point), body)
    for a, b in zip(got, want):
      np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-12)


def test_model_to_float32_steps(chains):
  """dataclasses.to moves a Model's floating fields to another dtype."""
  m, ds = chains["humanoid_bench"]
  m32 = mjtpu_torch.to(m, dtype=torch.float32)
  assert m32.qpos0.dtype == torch.float32 and m32.opt.timestep.dtype == torch.float32
  assert m32.body_parentid is m.body_parentid and m32.cache == {}
  d = mjtpu_torch.make_data(m32, batch_size=2)
  d = mjtpu_torch.step(m32, d)
  assert d.qpos.dtype == torch.float32 and bool(torch.isfinite(d.qpos).all())


def test_data_round_trip(chains):
  """data_from_mjtpu / data_to_numpy carry every field unchanged."""
  _, ds = chains["humanoid_bench"]
  back = mjtpu_torch.data_to_numpy(mjtpu_torch.data_from_mjtpu(ds[-1], device="cpu"))
  for f in dataclasses.fields(mjtpu_torch.Data):
    if f.name == "contact":
      for c in dataclasses.fields(mjtpu_torch.Contact):
        np.testing.assert_array_equal(getattr(back.contact, c.name),
                                      getattr(ds[-1].contact, c.name))
    else:
      np.testing.assert_array_equal(getattr(back, f.name), getattr(ds[-1], f.name))
