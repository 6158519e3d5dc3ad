"""scene_pile and boxes.xml through mjtpu_torch against mjtpu at float64 on
the CPU.

scene_pile (mjtpu/zoo/assets): 32 free bodies (nv=192, a forest: the mass
matrix is factored in 32 blocks of 6), CG with 30 iterations, 936 contact
slots in 5 groups (plane-sphere, plane-box, sphere-sphere, sphere-box,
box-box through the SAT kernel's seam) capped at the 192 deepest, 768
pyramidal rows.  The B=4 states are the committed golden's
(scripts/torch_port_assets.py): all 5 groups have live contacts after its
first step.

CG amplifies ULP differences: over its iterations a difference in the last
bits of a dot product grows by about an order of magnitude every one or
two iterations on these states, and mjtpu differs from itself that much
(the same step-1 solve vmapped over the 4 envs and run per env differs by
up to 9e-3 in qacc; ROADMAP C3).  So every stage but the solver is held
to 1e-10; the solver is held to 1e-10 over its first CG_EXACT iterations,
with its iteration counts exact, and over all 30 to SOLVE_BOUND; the
one-step restarts and the 100-step trajectory to bounds set by
measurement on an x86 CPU (RESTART_BOUND, TRAJECTORY_BOUND; chip_smoke.py
holds the card's run to the same bounds).

boxes.xml (tests/models): Newton (through kernel B1's seam) on a blocked
mass matrix, three trees, boxes of two sizes: every stage at 1e-10 and
5 steps at 1e-8.  The port runs Newton's loops to their fixed counts
(solver.py), 100 x 50 by default, so both engines run this model with 10
iterations of 10 linesearch rounds, to which its solves converge.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import mjtpu
from mjtpu._src import collision_driver as j_collision
from mjtpu._src import smooth as j_smooth
from mjtpu._src import solver as j_solver
from mjtpu._src import support as j_support
import mjtpu_torch
from mjtpu_torch._src import collision_driver as t_collision
from mjtpu_torch._src import smooth as t_smooth
from mjtpu_torch._src import solver as t_solver
from mjtpu_torch._src import support as t_support
from mjtpu_torch.ops import cholesky, sat
from tests.conftest import load_mj
from tests.test_torch_assets import _assert_models_equal
from tests.test_torch_stages import STAGES, _field

torch.set_num_threads(1)

B = 4
STEPS = 100
PILE_XML = str(mjtpu_torch.ASSETS.parent.parent / "mjtpu" / "zoo" / "assets" / "scene_pile.xml")
GOLDEN = mjtpu_torch.ASSETS / "scene_pile_golden.npz"
SNAPSHOT = mjtpu_torch.ASSETS / "scene_pile_model.npz"
NAMES = [s[0] for s in STAGES]
# bounds relative to each field's scale, max(1, max |mjtpu|), unless noted;
# the errors measured on an x86 CPU beside each
CG_EXACT = 5            # CG iterations held to 1e-10 (measured: 6.4e-13 / 470)
SOLVE_BOUND = 1e-3      # the solve's outputs after all 30 iterations, step 1
                        # of the golden (1.1e-5, efc_force; on the H100:
                        # 3.5e-4; mjtpu against itself: 3.4e-4, efc_force)
RESTART_BOUND = 1e-5    # one step from mjtpu's state (5.0e-7, qacc)
RESTART_EVERY = 4       # restarts from every 4th golden step
TRAJECTORY_BOUND = 1e-2  # absolute, qpos and qvel over 100 steps (3.9e-4)


def _assert_close(got, want, what, tol=1e-10):
  got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
  assert got.shape == want.shape, (what, got.shape, want.shape)
  scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
  err = float(np.abs(got - want).max()) if want.size else 0.0
  assert err <= tol * scale, f"{what}: max abs err {err:.3e} (scale {scale:.3g})"


def _chain(m, d):
  out = [d]
  for _, j_stage, _, _ in STAGES:
    d = jax.vmap(j_stage, in_axes=(None, 0))(m, d)
    out.append(d)
  return out


def _port(d):
  return mjtpu_torch.data_from_mjtpu(d, device="cpu")


def _jnp(d):
  """mjtpu's Data with every leaf a (non-weak) jax array, so that every
  call of a jitted chain hits its first compile."""
  return jax.tree.map(lambda x: jnp.asarray(np.asarray(x)), d)


@pytest.fixture(scope="module")
def golden():
  return dict(np.load(GOLDEN))


@pytest.fixture(scope="module")
def pile(golden):
  """(mjm, port Model, mjtpu Model, jitted mjtpu chain, mjtpu's chain at
  the golden's initial states with numpy leaves)."""
  mjm = mujoco.MjModel.from_xml_path(PILE_XML)
  jm = mjtpu.put_model(mjm, dtype=jnp.float64)
  m = mjtpu_torch.put_model(mjm, device="cpu")
  d = jax.vmap(lambda _: mjtpu.make_data(jm))(jnp.arange(B))
  d = d.replace(qpos=jnp.asarray(golden["qpos0"]), qvel=jnp.asarray(golden["qvel0"]))
  chain = jax.jit(_chain)
  return mjm, m, jm, chain, [jax.tree.map(np.asarray, x) for x in chain(jm, _jnp(d))]


def test_snapshot_equals_put_model(pile):
  _assert_models_equal(mjtpu_torch.model_from_arrays(mjtpu_torch.load_snapshot(SNAPSHOT),
                                                     device="cpu"), pile[1])


def test_static_layout_matches(pile):
  """Candidate groups, ncon (936 slots capped at 192), condims, efc
  addresses and row labels, and the mass blocks (32 of 6) equal mjtpu's."""
  _, m, jm, _, _ = pile
  groups = t_collision.candidate_groups(m)
  assert list(groups.items()) == list(j_collision.candidate_groups(jm).items())
  assert [k[:2] for k in groups] == [(0, 2), (0, 6), (2, 2), (2, 6), (6, 6)]
  assert t_collision._raw_ncon(m) == j_collision._raw_ncon(jm) == 936
  assert mjtpu_torch.constraint_sizes(m) == j_support.constraint_sizes(jm) == (0, 0, 0, 192, 768)
  np.testing.assert_array_equal(t_collision.make_condim(m), j_collision.make_condim(jm))
  np.testing.assert_array_equal(t_collision.contact_efc_address(m, 0, 0, 0),
                                j_collision.contact_efc_address(jm, 0, 0, 0))
  for a, b in zip(t_support.efc_row_meta(m), j_support.efc_row_meta(jm)):
    np.testing.assert_array_equal(a, b)
  assert t_smooth.mass_blocks(m) == j_smooth.mass_blocks(jm) == tuple((6 * i, 6) for i in range(32))


@pytest.mark.parametrize("stage", [i for i, n in enumerate(NAMES) if n != "solve"],
                         ids=[n for n in NAMES if n != "solve"])
def test_stage(pile, stage):
  _, m, _, _, ds = pile
  name, _, t_stage, fields = STAGES[stage]
  got = mjtpu_torch.data_to_numpy(t_stage(m, _port(ds[stage])))
  for f in fields:
    _assert_close(_field(got, f), _field(ds[stage + 1], f), f"{name} {f}")


def test_stages_exercise_the_slice(pile):
  """All 5 groups have live contacts (dist < 0) in the stage states, and
  CG runs to its bound in some envs."""
  _, m, _, _, ds = pile
  con = ds[NAMES.index("collision") + 1].contact
  types = np.asarray(m.geom_type)
  t1, t2 = types[con.geom1], types[con.geom2]
  for pair in [(0, 2), (0, 6), (2, 2), (2, 6), (6, 6)]:
    assert ((t1 == pair[0]) & (t2 == pair[1]) & (con.dist < 0)).any(), pair
  niter = ds[NAMES.index("solve") + 1].solver_niter
  assert niter.min() < m.opt.iterations == niter.max()


def test_blocked_factor_and_solve(pile):
  """factor_m and solve_m take mjtpu's blocked branch (32 batched 6 x 6
  factorizations) and match it at 1e-12."""
  _, m, jm, _, ds = pile
  d = ds[NAMES.index("crb") + 1]
  got = t_smooth.factor_m(m, _port(d))
  want = jax.vmap(j_smooth.factor_m, in_axes=(None, 0))(jm, jax.tree.map(jnp.asarray, d))
  _assert_close(got.qLD.numpy(), want.qLD, "qLD", 1e-12)
  assert np.array_equal(got.qLD.numpy() != 0, np.asarray(want.qLD) != 0)  # block diagonal
  x = np.random.default_rng(2).normal(size=(B, m.nv))
  sol_t = t_smooth.solve_m(m, got, torch.as_tensor(x))
  sol_j = jax.vmap(j_smooth.solve_m, in_axes=(None, 0, 0))(jm, want, jnp.asarray(x))
  _assert_close(sol_t.numpy(), sol_j, "solve_m", 1e-12)


def test_cg_solve(pile):
  """CG over its first CG_EXACT iterations at 1e-10; all 30 at SOLVE_BOUND,
  the iteration counts exact; the loops ran only while an env did."""
  _, _, _, _, ds = pile
  mjm = mujoco.MjModel.from_xml_path(PILE_XML)
  mjm.opt.iterations = CG_EXACT
  jm, m = mjtpu.put_model(mjm, dtype=jnp.float64), mjtpu_torch.put_model(mjm, device="cpu")
  before = ds[NAMES.index("solve")]
  want = jax.jit(jax.vmap(j_solver.solve, in_axes=(None, 0)))(jm, jax.tree.map(jnp.asarray, before))
  got = mjtpu_torch.data_to_numpy(mjtpu_torch.solve(m, _port(before)))
  for f in ("qacc", "efc_force", "qfrc_constraint"):
    _assert_close(getattr(got, f), getattr(want, f), f"{CG_EXACT} iterations {f}")
  want = ds[NAMES.index("solve") + 1]
  counts = dict(t_solver.loop_counts)
  got = mjtpu_torch.data_to_numpy(mjtpu_torch.solve(pile[1], _port(ds[NAMES.index("solve")])))
  np.testing.assert_array_equal(got.solver_niter, want.solver_niter)
  assert t_solver.loop_counts["iterations"] - counts["iterations"] == want.solver_niter.max()
  assert 0 < t_solver.loop_counts["ls_rounds"] - counts["ls_rounds"] < 30 * 50
  for f in ("qacc", "efc_force", "qfrc_constraint"):
    _assert_close(getattr(got, f), getattr(want, f), f"30 iterations {f}", SOLVE_BOUND)


@pytest.fixture(scope="module")
def mjtpu_states(pile, golden):
  """mjtpu's Data (numpy leaves) before step 1 and after each of the 100
  golden steps (the chain's last Data is the stepped one)."""
  _, _, jm, chain, ds = pile
  out = [ds[0], ds[-1]]
  for _ in range(STEPS - 1):
    out.append(jax.tree.map(np.asarray, chain(jm, _jnp(out[-1]))[-1]))
  return out


def test_one_step_restarts(pile, mjtpu_states, golden):
  """From mjtpu's state before every RESTART_EVERY-th of the 100 golden
  steps (those 25 x 4 envs as one batch), one port step lands within
  RESTART_BOUND of mjtpu's next state, relative to each field's scale."""
  m = pile[1]
  stack = lambda states: jax.tree.map(lambda *x: np.concatenate(x), *states)
  starts = range(0, STEPS, RESTART_EVERY)
  before = stack([mjtpu_states[i] for i in starts])
  after = stack([mjtpu_states[i + 1] for i in starts])
  got = mjtpu_torch.step(m, _port(before))
  for f in ("qpos", "qvel", "qacc"):
    _assert_close(getattr(got, f).numpy(), getattr(after, f), f, RESTART_BOUND)
  # mjtpu's stage chain and the jit(vmap(step)) that wrote the golden are
  # two compilations of one engine: after 100 steps of CG they part too
  err = np.abs(mjtpu_states[-1].qpos - golden["qpos"][-1]).max()
  assert 0 < err < TRAJECTORY_BOUND, err


def test_trajectory_matches_golden(golden):
  m = mjtpu_torch.model_from_arrays(mjtpu_torch.load_snapshot(SNAPSHOT), device="cpu")
  d = mjtpu_torch.make_data(m, batch_size=B)
  d = mjtpu_torch.replace(d, qpos=torch.as_tensor(golden["qpos0"]),
                          qvel=torch.as_tensor(golden["qvel0"]))
  sat.launches = cholesky.launches = 0
  every = STEPS // golden["qpos"].shape[0]
  err = []
  for i in range(STEPS):
    d = mjtpu_torch.step(m, d)
    if i == 0:
      _assert_close(d.contact.dist.numpy(), golden["contact_dist"], "step 1 contact.dist", 1e-9)
      for f in ("qacc", "efc_force"):
        _assert_close(getattr(d, f).numpy(), golden[f], f"step 1 {f}", SOLVE_BOUND)
      np.testing.assert_array_equal(d.solver_niter.numpy(), golden["solver_niter"])
    if (i + 1) % every == 0:
      k = (i + 1) // every - 1
      err.append(max(np.abs(d.qpos.numpy() - golden["qpos"][k]).max(),
                     np.abs(d.qvel.numpy() - golden["qvel"][k]).max()))
  assert sat.launches == cholesky.launches == 0  # CPU tensors: the twins
  assert max(err) < TRAJECTORY_BOUND, ((int(np.argmax(err)) + 1) * every, max(err))
  assert int(d.nreset.sum()) == 0


# ---------------------------------------------------------------------------
# boxes.xml: Newton on a blocked mass matrix
# ---------------------------------------------------------------------------


def _deepest(m, qpos, g1, g2):
  """Per env, the port's smallest contact distance of geoms (g1, g2)."""
  d = mjtpu_torch.replace(mjtpu_torch.make_data(m, batch_size=B), qpos=torch.as_tensor(qpos))
  con = mjtpu_torch.collision(m, mjtpu_torch.kinematics(m, d)).contact
  sel = (con.geom1 == g1) & (con.geom2 == g2)
  return torch.where(sel, con.dist, torch.inf).amin(dim=1).numpy()


@pytest.fixture(scope="module")
def boxes():
  """(port Model, mjtpu Model, jitted mjtpu chain, mjtpu's chain with
  numpy leaves) at B=4 states where box b1 and the sphere press 2 mm into
  the floor and box b2 2 mm into b1 (geoms: floor 0, b1 1, b2 2, sphere 3)."""
  mjm = load_mj("boxes.xml")
  mjm.opt.iterations = mjm.opt.ls_iterations = 10
  m = mjtpu_torch.put_model(mjm, device="cpu")
  rng = np.random.default_rng(4)
  qpos = np.tile(mjm.qpos0, (B, 1))
  qpos[:, 0::7] += rng.uniform(-0.01, 0.01, (B, 3))
  qpos[:, 1::7] += rng.uniform(-0.01, 0.01, (B, 3))
  qpos[:, 9] = qpos[:, 2] + 0.25
  for _ in range(2):  # the distances are nearly linear in the heights
    qpos[:, 2] -= _deepest(m, qpos, 0, 1) + 0.002
    qpos[:, 16] -= _deepest(m, qpos, 0, 3) + 0.002
    qpos[:, 9] -= _deepest(m, qpos, 1, 2) + 0.002
  jm = mjtpu.put_model(mjm, dtype=jnp.float64)
  d = jax.vmap(lambda _: mjtpu.make_data(jm))(jnp.arange(B))
  d = d.replace(qpos=jnp.asarray(qpos), qvel=jnp.asarray(rng.uniform(-0.5, 0.5, (B, mjm.nv))),
                qacc_warmstart=jnp.asarray(rng.uniform(-1, 1, (B, mjm.nv))))
  chain = jax.jit(_chain)
  return m, jm, chain, [jax.tree.map(np.asarray, x) for x in chain(jm, _jnp(d))]


@pytest.mark.parametrize("stage", range(len(STAGES)), ids=NAMES)
def test_boxes_stage(boxes, stage):
  m, _, _, ds = boxes
  name, _, t_stage, fields = STAGES[stage]
  got = mjtpu_torch.data_to_numpy(t_stage(m, _port(ds[stage])))
  for f in fields:
    _assert_close(_field(got, f), _field(ds[stage + 1], f), f"boxes {name} {f}")


def test_boxes_steps(boxes):
  """The layout (two box sizes: two plane-box and two sphere-box groups),
  live box-box contacts, and 5 steps at 1e-8 with Newton through B1's
  seam (its twin on the CPU)."""
  m, jm, chain, ds = boxes
  assert t_smooth.mass_blocks(m) == ((0, 6), (6, 6), (12, 6))
  keys = [k[:2] for k in t_collision.candidate_groups(m)]
  assert keys == [k[:2] for k in j_collision.candidate_groups(jm)]
  assert keys.count((0, 6)) == keys.count((2, 6)) == 2 and (6, 6) in keys
  con = ds[NAMES.index("collision") + 1].contact
  assert ((con.geom1 == 1) & (con.geom2 == 2) & (con.dist < 0)).any(axis=1).all()
  assert ds[NAMES.index("solve") + 1].solver_niter.max() < m.opt.iterations  # converged
  d, jd = _port(ds[0]), ds[0]
  for i in range(5):
    jd = chain(jm, _jnp(jd))[-1]
    d = mjtpu_torch.step(m, d)
    for f in ("qpos", "qvel"):
      err = float(np.abs(getattr(d, f).numpy() - np.asarray(getattr(jd, f))).max())
      assert err < 1e-8, f"step {i + 1} {f}: {err:.3e}"
