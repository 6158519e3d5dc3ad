"""Single kinematic trees with nv >= 32 through mjtpu_torch against mjtpu at
float64 on the CPU: the sparse and the dense mass-matrix paths.

The 66-dof branchy tree of tests/test_sparse.py (a free trunk with 6 limbs
of 10 damped hinges, Euler, no collisions) takes mjtpu's levelwise sparse
LDL (sparse.structure): one step factors qM (ldl_factor), solves for
qacc_smooth (ldl_solve) and solves Euler's implicit damping
(qM + h * diag(damping), ldl_factor_solve), the three entry points of
kernel B2, and no Cholesky (B1).  Held to the committed golden
(scripts/torch_port_assets.py): the step-1 factor and accelerations to
1e-10 of their scale, 100 steps at B=4 to 1e-8.  The 38-dof tree (4 limbs
of 8) takes the sparse path too (mjtpu's TPU gate at nv >= 40 is not
carried over): 10 steps against mjtpu.  tests/models/chain40.xml, a serial
chain, is dense in both engines (its sparse flop count is not below half
the dense one): Newton's Hessian and Euler's damping go through B1, 5 steps
at B=2 against mjtpu.  On a CPU tensor the wrappers run their plain twins;
the seams' calls are counted here, the kernels' launches on the card
(tests_cuda/, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import mjtpu
from mjtpu._src import sparse as j_sparse
import mjtpu_torch
from mjtpu_torch._src import sparse
from mjtpu_torch.ops import fused
from tests.conftest import load_mj
from tests.test_sparse import _branchy_xml
from tests.test_torch_assets import _assets_script

torch.set_num_threads(1)

GOLDEN = mjtpu_torch.ASSETS / "branchy66_golden.npz"
SNAPSHOT = mjtpu_torch.ASSETS / "branchy66_model.npz"
STEPS = 100
TRAJECTORY_BOUND = 1e-8
SEAMS = ("ldl_factor", "ldl_solve", "ldl_factor_solve", "chol_solve")


@pytest.fixture
def seam_calls(monkeypatch):
  """Counts the calls of each kernel seam in ops.fused."""
  calls = dict.fromkeys(SEAMS, 0)
  for name in SEAMS:
    def counted(*args, _name=name, _fn=getattr(fused, name)):
      calls[_name] += 1
      return _fn(*args)
    monkeypatch.setattr(fused, name, counted)
  return calls


def _run(m, qpos, qvel, steps):
  """Steps the port from (qpos, qvel): (qpos (steps, B, nq), qvel (steps,
  B, nv), the Data after step 1)."""
  d = mjtpu_torch.make_data(m, batch_size=qpos.shape[0])
  d = mjtpu_torch.replace(d, qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel))
  qs, vs, first = [], [], None
  for i in range(steps):
    d = mjtpu_torch.step(m, d)
    qs.append(d.qpos.numpy())
    vs.append(d.qvel.numpy())
    if i == 0:
      first = d
  assert int(d.nreset.sum()) == 0
  return np.stack(qs), np.stack(vs), first


def _mjtpu_run(mjm, qpos, qvel, steps):
  """mjtpu from the same states, one env at a time through one jit of its
  step (tracing the unbatched step costs less than the vmapped one):
  (its Model, qpos (steps, B, nq), qvel (steps, B, nv))."""
  m = mjtpu.put_model(mjm, dtype=jnp.float64)
  step = jax.jit(mjtpu.step)
  qs, vs = [], []
  for env in range(qpos.shape[0]):
    d = mjtpu.make_data(m).replace(qpos=jnp.asarray(qpos[env]), qvel=jnp.asarray(qvel[env]))
    qs.append([]), vs.append([])
    for _ in range(steps):
      d = step(m, d)
      qs[-1].append(np.asarray(d.qpos))
      vs[-1].append(np.asarray(d.qvel))
  return m, np.stack(qs, axis=1), np.stack(vs, axis=1)


def _max_err(qpos, qvel, want_qpos, want_qvel) -> float:
  return max(float(np.abs(qpos - want_qpos).max()), float(np.abs(qvel - want_qvel).max()))


@pytest.fixture(scope="module")
def golden():
  return dict(np.load(GOLDEN))


@pytest.fixture(scope="module")
def branchy66():
  """The port's Model from the committed snapshot (no mujoco needed)."""
  return mjtpu_torch.model_from_arrays(mjtpu_torch.load_snapshot(SNAPSHOT), device="cpu")


def test_branchy66_takes_the_sparse_path(branchy66):
  s = sparse.structure(branchy66)
  assert s is not None and (s.nv, s.depth, len(s.rounds)) == (66, 16, 16)
  assert (s.flops_sparse, s.flops_dense) == (3905, 47916)
  assert int((s.anc < s.nv).sum()) == 711


def test_branchy66_stages_match_mjtpu(branchy66, golden, seam_calls):
  """Step 1 from the golden's states: the factor (qLD, qLDiagInv),
  qacc_smooth and the damped qacc to 1e-10 of their scale; one call of
  each B2 seam and none of B1's."""
  _, _, first = _run(branchy66, golden["qpos0"], golden["qvel0"], 1)
  assert seam_calls == {"ldl_factor": 1, "ldl_solve": 1, "ldl_factor_solve": 1, "chol_solve": 0}
  for name in ("qLD", "qLDiagInv", "qacc_smooth", "qacc"):
    got, want = getattr(first, name).numpy(), golden[name]
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= 1e-10 * scale, f"{name}: max abs err {err:.3e} (scale {scale:.3g})"
  # the damping solve changed the acceleration
  assert float(np.abs(golden["qacc"] - golden["qacc_smooth"]).max()) > 1e-3


def test_branchy66_trajectory_matches_golden(branchy66, golden):
  qpos, qvel, _ = _run(branchy66, golden["qpos0"], golden["qvel0"], STEPS)
  err = _max_err(qpos, qvel, golden["qpos"], golden["qvel"])
  print(f"branchy66, {STEPS} steps B=4 f64: max abs err {err:.3e} against the golden")
  assert err < TRAJECTORY_BOUND


def test_branchy38_matches_mjtpu(seam_calls):
  """nv=38: sparse in both engines (mjtpu's Pallas gate at nv >= 40 only
  routes its TPU kernel), 10 steps at B=4."""
  mjm = mujoco.MjModel.from_xml_string(_branchy_xml(limbs=4, links=8))
  qpos, qvel = _assets_script().branchy_initial_state(mjm)
  jm, want_q, want_v = _mjtpu_run(mjm, qpos, qvel, 10)
  m = mjtpu_torch.put_model(mjm, device="cpu")
  assert sparse.structure(m) is not None and j_sparse.structure(jm) is not None
  got_q, got_v, _ = _run(m, qpos, qvel, 10)
  assert seam_calls == {"ldl_factor": 10, "ldl_solve": 10, "ldl_factor_solve": 10,
                        "chol_solve": 0}
  assert _max_err(got_q, got_v, want_q, want_v) < TRAJECTORY_BOUND


def test_chain40_matches_mjtpu(seam_calls, monkeypatch):
  """The serial chain takes the dense path in both engines: Newton's
  Hessian (once per Newton iteration) and Euler's damping solve (once per
  step) through B1's seam at n=40.  Both engines run Newton capped at 5
  iterations and the linesearch at 10 rounds; it converges in fewer, and
  the port leaves its loops when no env runs on."""
  from mjtpu_torch._src import solver

  monkeypatch.delenv("MJTPU_SPARSE_LDL", raising=False)
  mjm = load_mj("chain40.xml")
  mjm.opt.iterations, mjm.opt.ls_iterations = 5, 10
  rng = np.random.default_rng(0)
  qpos = mjm.qpos0[None] + rng.uniform(-0.3, 0.3, (2, mjm.nq))
  qvel = rng.uniform(-0.3, 0.3, (2, mjm.nv))
  jm, want_q, want_v = _mjtpu_run(mjm, qpos, qvel, 5)
  m = mjtpu_torch.put_model(mjm, device="cpu")
  assert sparse.structure(m) is None and j_sparse.structure(jm) is None
  before = solver.loop_counts["iterations"]
  got_q, got_v, _ = _run(m, qpos, qvel, 5)
  iterations = solver.loop_counts["iterations"] - before
  assert 5 <= iterations <= 5 * mjm.opt.iterations
  assert seam_calls == {"ldl_factor": 0, "ldl_solve": 0, "ldl_factor_solve": 0,
                        "chol_solve": iterations + 5}
  assert _max_err(got_q, got_v, want_q, want_v) < TRAJECTORY_BOUND
