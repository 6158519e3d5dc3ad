"""Elliptic cones and condim 4/6 contacts through mjtpu_torch against mjtpu
at float64 on the CPU.

Models: tests/models/condim4_elliptic.xml, condim4_pyramidal.xml,
condim6_elliptic.xml, condim_cg.xml (CG, pyramidal condim 4 and 1),
elliptic.xml (a condim-6 sphere and a condim-4 capsule: two trees, n=12)
and humanoid_bench_elliptic (mjtpu/zoo/assets/humanoid_bench.xml with
opt.cone elliptic, as bench.py runs it).  Held to the committed goldens
(scripts/torch_port_assets.py: mjtpu's forward Data at each golden's
initial states, and its trajectories):

  * static layout: row counts, condims, efc addresses and row labels equal
    mjtpu's; humanoid_bench_elliptic has 45 rows (21 limits, 8 contacts
    of 3 rows) where pyramidal cones give 53;
  * stages from mjtpu's forward Data: make_constraint's efc_J, efc_D,
    efc_aref, efc_frictionloss and efc_pos, solve's qacc and efc_force,
    and the contact wrenches, to STAGE_BOUND of each field's scale;
  * the cone Hessian: the first Newton Hessian (the cone blocks folded
    in) against mjtpu's, captured live from mjtpu's solve, to STAGE_BOUND
    of scale; each middle-zone cone block against the Hessian of the cone
    cost by central differences;
  * trajectories: each scene's first SCENE_STEPS steps to
    TRAJECTORY_BOUND; for humanoid_bench_elliptic (ROADMAP C7), in the
    benchmark configuration (iterations=1, ls_iterations=4) and with the
    solver run to convergence (iterations = ls_iterations = 10), the 400
    one-step restarts from mjtpu's states and the 100-step runs.

humanoid_bench_elliptic's golden also holds mjtpu compiled for one env
(jit(step): "solo") beside its jit(vmap(step)) ("batched"): one step from
each batched state, and its own 100-step run. mjtpu parts from itself
where rounding decides: in the benchmark configuration the linesearch
takes the sign of a phi' that is zero but for rounding at a Newton
candidate (25 of the 400 restarts split, by up to 0.25); with the solver
run to convergence the solve stalls where no step lowers the cost in f64
(improvement 0 at a rescaled gradient of 1e-7), and that point moves with
the rounding (6 splits, by up to 1.2e-7). So each restart is held to
TRAJECTORY_BOUND of mjtpu's batched or solo next state, and a restart that
parts from both is a tie only if a copy of its state a few ULP away takes
mjtpu's path (chip_smoke.elliptic_restarts). The benchmark configuration's
run is held to TRAJECTORY_BOUND through step 2 (step 3's restarts are the
first that rounding decides, chip_smoke.ELLIPTIC_HEAD_STEPS) and is finite
without resets over 100 steps. The converged run is held to
TRAJECTORY_BOUND up to the first step where mjtpu's two runs part (the
stall point moves with state differences below 1e-8 too: an env parts at
step 16 although every restart through step 85 holds), and over 100 steps
to chip_smoke.ELLIPTIC_DRIFT_FACTOR times mjtpu's own spread.

Also: the cone work's launches are flat in the number of contacts.
"""

import types

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import chip_smoke
import mjtpu
from mjtpu._src import support as j_support
from mjtpu._src import collision_driver as j_collision
import mjtpu_torch
from mjtpu_torch._src import collision_driver as t_collision
from mjtpu_torch._src import io, solver, support
from tests.conftest import load_mj

torch.set_num_threads(1)

B = 4
STEPS = 100
STAGE_BOUND = 1e-10
TRAJECTORY_BOUND = 1e-8
# the scenes' steps held on the CPU (chip_smoke.py holds all 100 on the card)
SCENE_STEPS = 25
ELLIPTIC = "humanoid_bench_elliptic"
GOLDEN = mjtpu_torch.ASSETS / f"{ELLIPTIC}_golden.npz"
SCENES = mjtpu_torch.ASSETS / "cone_scenes.npz"
SCENE_GOLDEN = mjtpu_torch.ASSETS / "cone_scenes_golden.npz"
CONE_MODELS = ("condim4_elliptic", "condim4_pyramidal", "condim6_elliptic", "condim_cg",
               "elliptic")
MAKE_CONSTRAINT = ("efc_J", "efc_D", "efc_aref", "efc_frictionloss", "efc_pos", "efc_margin")


@pytest.fixture(scope="module")
def golden():
  return dict(np.load(GOLDEN))


@pytest.fixture(scope="module")
def scene_golden():
  return dict(np.load(SCENE_GOLDEN))


def _model(name, dtype=torch.float64, **opt):
  if name == ELLIPTIC:
    ns = mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / f"{ELLIPTIC}_model.npz")
  else:
    ns = io.load_snapshot(SCENES, name)
  for k, v in opt.items():
    setattr(ns.opt, k, v)
  return mjtpu_torch.model_from_arrays(ns, dtype=dtype, device="cpu")


def fwd_data(golden, prefix=""):
  """mjtpu's forward Data at the initial states from a golden's "fwd."
  fields, as data_from_mjtpu takes it, with the solver's warmstart input
  (make_data's zeros) put back."""
  head = prefix + "fwd."
  fields = {k[len(head):]: v for k, v in golden.items() if k.startswith(head)}
  ns = types.SimpleNamespace(**{k: v for k, v in fields.items() if not k.startswith("contact.")})
  ns.contact = types.SimpleNamespace(
      **{k[8:]: v for k, v in fields.items() if k.startswith("contact.")})
  ns.qacc_warmstart = np.zeros_like(ns.qacc_warmstart)
  return ns


def _err(got, want):
  """(max abs error, the field's scale: max(1, max |want|))."""
  got, want = np.asarray(got, dtype=np.float64), np.asarray(want)
  if not want.size:
    return 0.0, 1.0
  return float(np.abs(got - want).max()), max(1.0, float(np.abs(want).max()))


def assert_stages(m, fwd, what, solve_bound=STAGE_BOUND):
  """make_constraint and solve from mjtpu's forward Data ``fwd`` against
  it, to STAGE_BOUND (solve: ``solve_bound``) of scale."""
  d = mjtpu_torch.data_from_mjtpu(fwd, device="cpu")
  got = mjtpu_torch.make_constraint(m, d)
  for f in MAKE_CONSTRAINT:
    err, scale = _err(getattr(got, f).numpy(), getattr(fwd, f))
    assert err <= STAGE_BOUND * scale, f"{what} make_constraint {f}: {err:.3e} (scale {scale:.3g})"
  got = mjtpu_torch.solve(m, d)
  for f in ("qacc", "efc_force", "qfrc_constraint"):
    err, scale = _err(getattr(got, f).numpy(), getattr(fwd, f))
    assert err <= solve_bound * scale, f"{what} solve {f}: {err:.3e} (scale {scale:.3g})"
  return got


def assert_contact_forces(m, mjm, fwd, what):
  """The port's contact wrenches from mjtpu's efc_force against mjtpu's
  support.contact_forces (run eagerly, env by env)."""
  jm = mjtpu.put_model(mjm, dtype=jnp.float64)
  d = mjtpu_torch.data_from_mjtpu(fwd, device="cpu")
  got = support.contact_forces(m, d).numpy()
  for e in range(got.shape[0]):
    jd = types.SimpleNamespace(efc_force=jnp.asarray(fwd.efc_force[e]), qpos=jnp.asarray(fwd.qpos[e]),
                               contact=types.SimpleNamespace(friction=jnp.asarray(fwd.contact.friction[e])))
    want = np.asarray(j_support.contact_forces(jm, jd))
    err, scale = _err(got[e], want)
    assert err <= STAGE_BOUND * scale, f"{what} contact_forces env {e}: {err:.3e}"


def _mjm(name):
  if name == ELLIPTIC:
    mjm = mujoco.MjModel.from_xml_path(str(mjtpu_torch.ASSETS.parent.parent / "mjtpu" / "zoo" /
                                           "assets" / "humanoid_bench.xml"))
    mjm.opt.cone = mujoco.mjtCone.mjCONE_ELLIPTIC
    return mjm
  return load_mj(f"{name}.xml")


@pytest.mark.parametrize("name", [*CONE_MODELS, ELLIPTIC])
def test_static_layout_matches(name):
  """Row counts, condims, efc addresses and row labels equal mjtpu's, and
  the snapshot loads as put_model builds the model."""
  mjm = _mjm(name)
  jm, tm = mjtpu.put_model(mjm, dtype=jnp.float64), mjtpu_torch.put_model(mjm, device="cpu")
  assert mjtpu_torch.constraint_sizes(tm) == j_support.constraint_sizes(jm)
  ne, nf, nl, _ = j_support.count_constraints(jm)
  np.testing.assert_array_equal(t_collision.make_condim(tm), j_collision.make_condim(jm))
  np.testing.assert_array_equal(t_collision.contact_efc_address(tm, ne, nf, nl),
                                j_collision.contact_efc_address(jm, ne, nf, nl))
  for a, b in zip(support.efc_row_meta(tm), j_support.efc_row_meta(jm)):
    np.testing.assert_array_equal(a, b)
  snap = _model(name)
  assert snap.opt.cone == tm.opt.cone and snap.nv == tm.nv
  assert support.count_constraints(snap) == support.count_constraints(tm)
  if name == ELLIPTIC:
    assert mjtpu_torch.constraint_sizes(tm) == (0, 0, 21, 8, 45)
    mjm.opt.cone = mujoco.mjtCone.mjCONE_PYRAMIDAL
    assert mjtpu_torch.constraint_sizes(mjtpu_torch.put_model(mjm, device="cpu"))[4] == 53


@pytest.mark.parametrize("name", CONE_MODELS)
def test_scene_stages(scene_golden, name):
  fwd = fwd_data(scene_golden, f"{name}.")
  m = _model(name)
  assert (fwd.contact.dist < 0).any(axis=1).all(), "every env must have a live contact"
  assert_stages(m, fwd, name)
  assert_contact_forces(m, _mjm(name), fwd, name)


def test_bench_stages(golden):
  fwd = fwd_data(golden)
  m = _model(ELLIPTIC)
  got = assert_stages(m, fwd, ELLIPTIC)
  assert (np.abs(got.efc_force.numpy()[:, 21:]) > 0).any()
  assert_contact_forces(m, _mjm(ELLIPTIC), fwd, ELLIPTIC)


@pytest.mark.parametrize("name", ["elliptic", ELLIPTIC])
def test_cone_hessian_matches_mjtpu(monkeypatch, golden, scene_golden, name):
  """The first Newton Hessian, the cone blocks of the middle zone folded
  in, equals mjtpu's (captured from its solve, env by env) to STAGE_BOUND
  of scale; some block is in the middle zone."""
  from mjtpu._src import solver as j_solver
  from mjtpu.ops import fused as j_fused

  if name == ELLIPTIC:
    # warm-started from step 1's solution, where 4 contacts slide: the
    # middle zone (the zero warmstart starts every cone in another zone)
    fwd = fwd_data(golden)
    fwd.qacc_warmstart = golden["warm"][0]
  else:
    fwd = fwd_data(scene_golden, f"{name}.")
  m, mjm = _model(name), _mjm(name)
  jm = mjtpu.put_model(mjm, dtype=jnp.float64)
  want, seam = [], j_fused.chol_solve

  def chol_solve(h, grad):
    jax.debug.callback(lambda a: want.append(np.asarray(a)), h)
    return seam(h, grad)

  monkeypatch.setattr(j_fused, "chol_solve", chol_solve)
  solve = jax.jit(lambda d: j_solver.solve(jm, d))
  wants = []
  for e in range(B):
    d = mjtpu.make_data(jm)
    env = {k: jnp.asarray(v[e]) for k, v in vars(fwd).items() if k != "contact"}
    d = d.replace(**env, contact=d.contact.replace(
        **{k: jnp.asarray(v[e]) for k, v in vars(fwd.contact).items()}))
    want.clear()
    jax.block_until_ready(solve(d))
    wants.append(want[0])
  want = np.stack(wants)
  blocks, cone_blocks = [], solver._cone_blocks
  monkeypatch.setattr(solver, "_cone_blocks", lambda *a: blocks.append(cone_blocks(*a)) or
                      blocks[-1])
  got, _ = chip_smoke._capture_hessians(
      lambda: mjtpu_torch.solve(m, mjtpu_torch.data_from_mjtpu(fwd, device="cpu")))
  err, scale = _err(got[0][0].numpy(), want)
  assert err <= STAGE_BOUND * scale, f"{name} first Newton Hessian: {err:.3e} (scale {scale:.3g})"
  # the first Hessian has a cone block of the middle zone folded in
  assert any(bool(hcone.any()) for hcone, _ in blocks[0])


def _cone_cost(U, D, mu):
  """One contact's elliptic cost (mjtpu's _row_costs zones) in numpy."""
  d_n = D[0]
  vs = np.sqrt(D[1:] / d_n)
  N, T = U[0], np.linalg.norm(U[1:] * vs)
  mu_t = mu * np.sqrt(d_n / D[1])
  dm = d_n / (1 + mu_t * mu_t)
  if N >= mu_t * T:
    return 0.0
  if mu_t * N + T <= 0:
    return 0.5 * np.sum(D * U * U)
  return 0.5 * dm * (N - mu_t * T) ** 2


@pytest.mark.parametrize("dim", [3, 4, 6])
def test_cone_block_is_the_cost_hessian(dim):
  """Each middle-zone block of _cone_blocks is the Hessian of the cone
  cost in the block's rows (central differences, f64)."""
  rng = np.random.default_rng(dim)
  K = 64
  D = rng.uniform(0.5, 3.0, (1, K, dim))
  mu = rng.uniform(0.3, 1.2, (1, K))
  U = rng.normal(size=(1, K, dim))
  c = solver._cones(solver._EfcMeta(0, K * dim, ((dim, 0, K, 0),)),
                    torch.as_tensor(D.reshape(1, -1)),
                    torch.as_tensor(np.pad(mu[..., None], ((0, 0), (0, 0), (0, 4)))))
  J = torch.eye(K * dim, dtype=torch.float64)[None]
  (hcone, _), = solver._cone_blocks(c, J, torch.as_tensor(U.reshape(1, -1)))
  hcone, middle, eps = hcone.numpy()[0], 0, 1e-5
  for k in range(K):
    cost = lambda u: _cone_cost(u, D[0, k], mu[0, k])
    u0 = U[0, k]
    mu_t = mu[0, k] * np.sqrt(D[0, k, 0] / D[0, k, 1])
    T = np.linalg.norm(u0[1:] * np.sqrt(D[0, k, 1:] / D[0, k, 0]))
    if not (u0[0] < mu_t * T - 1e-3 and mu_t * u0[0] + T > 1e-3):
      assert not hcone[k].any()
      continue
    middle += 1
    fd = np.zeros((dim, dim))
    for i in range(dim):
      for j in range(dim):
        ei, ej = np.eye(dim)[i] * eps, np.eye(dim)[j] * eps
        fd[i, j] = (cost(u0 + ei + ej) - cost(u0 + ei - ej) - cost(u0 - ei + ej)
                    + cost(u0 - ei - ej)) / (4 * eps * eps)
    np.testing.assert_allclose(hcone[k], fd, rtol=1e-4, atol=1e-4 * np.abs(fd).max())
  assert middle >= 8


def _start(m, golden, prefix=""):
  d = mjtpu_torch.make_data(m, batch_size=B)
  state = {k: torch.as_tensor(golden[f"{prefix}{k}0"])
           for k in ("qpos", "qvel", "qfrc_applied") if f"{prefix}{k}0" in golden}
  if f"{prefix}ctrl" in golden:
    state["ctrl"] = torch.as_tensor(golden[f"{prefix}ctrl"])
  return mjtpu_torch.replace(d, **state)


def run_trajectory(m, golden, prefix="", fields=("qpos", "qvel"), steps=STEPS):
  """Steps the port from the golden's initial states: ({field: (steps, B,
  ...)}, the calls of B1's seam (fused.chol_solve), the Data after step
  1)."""
  d = _start(m, golden, prefix)
  out = {f: [] for f in fields}
  calls = 0
  for i in range(steps):
    hessians, d = chip_smoke._capture_hessians(lambda: mjtpu_torch.step(m, d))
    calls += len(hessians)
    first = d if i == 0 else first
    for f in fields:
      out[f].append(getattr(d, f).numpy())
  assert int(d.nreset.sum()) == 0 and np.isfinite(out["qpos"]).all()
  return {f: np.stack(v) for f, v in out.items()}, calls, first


@pytest.mark.parametrize("name", CONE_MODELS)
def test_scene_trajectory(scene_golden, name):
  """SCENE_STEPS steps to TRAJECTORY_BOUND; Newton calls B1 once per
  iteration."""
  m = _model(name)
  before = solver.loop_counts["iterations"]
  run, calls, _ = run_trajectory(m, scene_golden, f"{name}.", steps=SCENE_STEPS)
  iterations = solver.loop_counts["iterations"] - before
  for f in ("qpos", "qvel"):
    err = np.abs(run[f] - scene_golden[f"{name}.{f}"][:SCENE_STEPS]).max()
    assert err <= TRAJECTORY_BOUND, f"{name} {f}: {err:.3e}"
  assert calls == (iterations if m.opt.solver == mjtpu_torch.SolverType.NEWTON else 0)


def _converged(golden):
  return _model(ELLIPTIC, iterations=int(golden["converged_iterations"]),
                ls_iterations=int(golden["converged_ls_iterations"]))


CONFIGS = {"benchmark": ("", lambda golden: _model(ELLIPTIC)), "converged": ("conv_", _converged)}


@pytest.fixture(scope="module")
def restarts(golden):
  """config -> chip_smoke.elliptic_restarts' result, computed once."""
  cache = {}

  def get(config):
    if config not in cache:
      prefix, model = CONFIGS[config]
      cache[config] = chip_smoke.elliptic_restarts(model(golden), golden, prefix)
    return cache[config]

  return get


def _errors(run, golden, prefix):
  """(steps, B) max abs error of a run's qpos and qvel against a golden run."""
  return np.maximum(*(np.abs(run[f] - golden[f"{prefix}{f}"]).max(axis=2) for f in ("qpos", "qvel")))


@pytest.mark.parametrize("config", ["benchmark", "converged"])
def test_one_step_restarts(restarts, config):
  """Each of the 400 one-step restarts within TRAJECTORY_BOUND of mjtpu's
  batched or solo next state, or a tie: a copy of its state a few ULP away
  takes mjtpu's path (module docstring)."""
  err, splits, unexplained, own, _ = restarts(config)
  print(f"{config} restarts past {TRAJECTORY_BOUND}: of the batched run {int((err > TRAJECTORY_BOUND).sum())},"
        f" of both mjtpu runs {len(splits)} (ties), mjtpu's own {own}")
  assert not len(unexplained), f"restarts off mjtpu's paths: {unexplained.tolist()}"


def test_converged_trajectory(golden):
  """The solver run to convergence, 100 steps: TRAJECTORY_BOUND until
  mjtpu's two runs part, then ELLIPTIC_DRIFT_FACTOR times their spread."""
  run, _, _ = run_trajectory(_converged(golden), golden)
  own = _errors({"qpos": golden["conv_solo_run_qpos"], "qvel": golden["conv_solo_run_qvel"]},
                golden, "conv_")
  parted = (own > TRAJECTORY_BOUND).any(axis=1)
  head = int(parted.argmax()) if parted.any() else STEPS
  err = _errors(run, golden, "conv_")
  near = min(err.max(), _errors(run, golden, "conv_solo_run_").max())
  print(f"converged trajectory: {err[:head].max():.3e} through step {head}, {near:.3e} over"
        f" {STEPS} (mjtpu's own spread {own.max():.3e})")
  assert head >= 1 and err[:head].max() <= TRAJECTORY_BOUND
  assert near <= chip_smoke.ELLIPTIC_DRIFT_FACTOR * own.max()


def test_benchmark_trajectory(golden):
  """The benchmark configuration (iterations=1, ls_iterations=4): step 1's
  qacc, efc_force and contact.dist to 1e-9; the trajectory to
  TRAJECTORY_BOUND through step chip_smoke.ELLIPTIC_HEAD_STEPS, finite and
  without resets over 100; one B1 call a step."""
  run, calls, d = run_trajectory(_model(ELLIPTIC), golden)
  for f, got in (("qacc", d.qacc), ("efc_force", d.efc_force), ("contact_dist", d.contact.dist)):
    e = np.abs(got.numpy() - golden[f]).max()
    assert e <= 1e-9, f"step 1 {f}: {e:.3e}"
  err, head = _errors(run, golden, ""), chip_smoke.ELLIPTIC_HEAD_STEPS
  print(f"benchmark config: {err[:head].max():.3e} through step {head}, {err.max():.3e} over {STEPS}")
  assert err[:head].max() <= TRAJECTORY_BOUND
  assert calls == STEPS


def _ops(fn) -> int:
  """The number of torch operations ``fn()`` dispatches."""
  from torch.utils._python_dispatch import TorchDispatchMode

  class Count(TorchDispatchMode):
    n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
      Count.n += 1
      return func(*args, **(kwargs or {}))

  with Count():
    fn()
  return Count.n


def test_cone_launches_flat_in_contacts():
  """The cone zones' cost, linesearch point and Hessian fold dispatch as
  many operations for K = 2 as for K = 64 contacts of one condim (K = 1
  differs by a view that the single contact's reshape needs no copy for)."""
  counts = []
  for K in (2, 64):
    rng = np.random.default_rng(K)
    dim, nv = 4, 6
    t = lambda *shape: torch.as_tensor(rng.normal(size=shape))
    meta = solver._EfcMeta(0, K * dim, ((dim, 0, K, 0),))
    D = torch.as_tensor(rng.uniform(0.5, 2.0, (2, K * dim)))
    cones = solver._cones(meta, D, torch.as_tensor(rng.uniform(0.5, 1.0, (2, K, 5))))
    Jaref, jv, J = t(2, K * dim), t(2, K * dim), t(2, K * dim, nv)
    quad = t(2, K * dim, 3)
    ls = solver._ls_cones(cones, jv)
    counts.append((
        _ops(lambda: solver._row_costs(meta, cones, Jaref, D, torch.zeros_like(D))),
        _ops(lambda: solver._ls_point(t(2, 3), quad, Jaref, jv, t(2), None, ls)),
        _ops(lambda: solver._cone_blocks(cones, J, Jaref))))
  assert counts[0] == counts[1], counts
