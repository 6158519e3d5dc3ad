"""Differentiable mode of mjtpu_torch against mjtpu's jax.grad, at f64 on
the CPU.

Every scene of diff_scenes.npz (chip_smoke.DIFF_SCENES: tests/test_diff.py's
cases and humanoid_bench) runs through the port under its
differentiable_mode, held to the committed golden of mjtpu's values and
jax.grad gradients (scripts/torch_port_assets.py --model diff_scenes);
the port's own gradients are held to central finite differences as
tests/test_diff.py holds mjtpu's; B1's autograd.Function to gradcheck and
to autograd through its twin; B2's, B3's and B4's differentiable seams
to gradcheck and to their twins' autograd; the mode's API, its fixed
iterations without a host check and its substeps on per-env timesteps.  One run of each scene is shared by the tests that read it.
"""

import dataclasses
import functools
import threading

import numpy as np
import pytest
import torch

import chip_smoke
import mjtpu
import mjtpu_torch
from mjtpu_torch import parallel
from mjtpu_torch._src import collision_convex, mesh, solver, sparse
from mjtpu_torch.ops import _build, cholesky, fused, hfield, ldl, sat

GOLDEN = mjtpu_torch.ASSETS / "diff_scenes_golden.npz"


@functools.lru_cache(maxsize=None)
def _golden():
  with np.load(GOLDEN) as z:
    return {k: z[k] for k in z.files}


@functools.lru_cache(maxsize=None)
def _run(name):
  """The port's run of a scene (chip_smoke.diff_scene_run), once."""
  return chip_smoke.diff_scene_run(name, _golden(), "cpu")


@pytest.mark.parametrize("name", list(chip_smoke.DIFF_SCENES))
def test_scene_matches_mjtpu(name):
  """Values at step 1 within 1e-10 of scale and over the rollout within
  1e-8, gradients within 1e-8 of their max-abs, all finite."""
  errs = chip_smoke.diff_scene_errors(name, _golden(), "cpu", got=_run(name))
  assert errs["finite"], errs
  assert errs["head"] <= chip_smoke.DIFF_VALUE_HEAD_BOUND, errs
  assert errs["values"] <= chip_smoke.DIFF_VALUE_BOUND, errs
  grads = {k: v for k, v in errs.items() if k.startswith("grad_")}
  assert grads and all(v <= chip_smoke.DIFF_GRAD_BOUND for v in grads.values()), errs


def _pendulum_loss(qvel):
  """The pendulum scene's per-env loss from qvel (E, nv), no graph."""
  name = "pendulum"
  _, steps, cfg, _ = chip_smoke.DIFF_SCENES[name]
  m = chip_smoke.diff_scene_model(name, "cpu")
  d = mjtpu_torch.make_data(m, batch_size=qvel.shape[0])
  with torch.no_grad(), mjtpu_torch.differentiable_mode(**cfg):
    d = mjtpu_torch.replace(d, qvel=qvel)
    for _ in range(steps):
      d = mjtpu_torch.step(m, d)
  return torch.sum(d.qpos * d.qpos, dim=-1)


def test_pendulum_gradient_matches_finite_differences():
  """No contacts: the port's gradient matches central differences of its
  own loss (tests/test_diff.py::test_smooth_gradients' rtol), every env
  and dof in one batch."""
  qvel0 = torch.as_tensor(_golden()["pendulum.qvel0"])
  B, nv = qvel0.shape
  eps = 1e-6
  bump = eps * torch.eye(nv, dtype=qvel0.dtype)
  lanes = torch.cat([qvel0[:, None] + bump, qvel0[:, None] - bump], dim=1).reshape(-1, nv)
  loss = _pendulum_loss(lanes).reshape(B, 2, nv)
  fd = (loss[:, 0] - loss[:, 1]) / (2 * eps)
  np.testing.assert_allclose(_run("pendulum")["grad_qvel"], fd.numpy(), rtol=1e-4)


@pytest.mark.parametrize("name,rtol", [("box_corner", 1e-4), ("box_box", 1e-3)])
def test_box_gradient_matches_finite_differences(name, rtol):
  """Smooth collisions: d min(contact.dist) / d offset against central
  differences (tests/test_diff.py's rtol for each scene, atol 1e-8)."""
  g = _golden()
  _, _, cfg, (col,) = chip_smoke.DIFF_SCENES[name]
  m = chip_smoke.diff_scene_model(name, "cpu")
  eps = 1e-6
  qpos = torch.as_tensor(g[f"{name}.qpos0"])
  off = torch.as_tensor(g[f"{name}.offset0"])[:, 0]
  vals = []
  with torch.no_grad(), mjtpu_torch.differentiable_mode(**cfg):
    for sign in (1.0, -1.0):
      q = qpos.clone()
      q[:, col] += off + sign * eps
      d = mjtpu_torch.fwd_position(m, mjtpu_torch.replace(
          mjtpu_torch.make_data(m, batch_size=q.shape[0]), qpos=q))
      vals.append(torch.amin(d.contact.dist, dim=-1))
  fd = ((vals[0] - vals[1]) / (2 * eps)).numpy()
  got = _run(name)["grad_offset"][:, 0]
  assert np.isfinite(got).all()
  np.testing.assert_allclose(got, fd, rtol=rtol, atol=1e-8)


def test_bounce_smooth_gradient_approximates_plain():
  """tests/test_diff.py's long-rollout regression: both gradients finite,
  the bounce moves the loss, and the smoothed gradient of qvel[:2] has the
  plain one's sign and order (rtol 0.25)."""
  plain, smooth = _run("bounce")["grad_qvel"], _run("bounce_smooth")["grad_qvel"]
  assert np.isfinite(plain).all() and np.isfinite(smooth).all()
  assert np.abs(plain[:, :2]).max() > 1e-3
  np.testing.assert_allclose(smooth[:, :2], plain[:, :2], rtol=0.25)


def _spd(n, batch, gen):
  a = torch.randn(batch, n, n, dtype=torch.float64, generator=gen)
  return a @ a.transpose(1, 2) + n * torch.eye(n, dtype=torch.float64)


def test_chol_solve_gradcheck():
  """B1's autograd.Function (the twin on the CPU, the same formula as on
  the card) passes gradcheck at f64 on a symmetric construction of mat,
  the matrices it is defined on (it reads one triangle)."""
  gen = torch.Generator().manual_seed(0)
  p = _spd(5, 3, gen).requires_grad_(True)
  g = torch.randn(3, 5, dtype=torch.float64, generator=gen, requires_grad=True)
  fn = lambda p, g: cholesky.CholSolve.apply((0.5 * (p + p.transpose(1, 2))).contiguous(), g)
  assert torch.autograd.gradcheck(fn, (p, g))


@pytest.mark.parametrize("n", [27, 23])
def test_chol_solve_backward_matches_twin_autograd(n):
  """The analytic backward equals autodiff through the twin's factor and
  solve on symmetric matrices whose pivots are not clamped."""
  gen = torch.Generator().manual_seed(n)
  mat = _spd(n, 8, gen)
  rhs = torch.randn(8, n, dtype=torch.float64, generator=gen)
  w = torch.randn(8, n, dtype=torch.float64, generator=gen)
  grads = []
  for solve in (fused.chol_solve, cholesky.chol_solve_reference):
    p, g = mat.clone().requires_grad_(True), rhs.clone().requires_grad_(True)
    torch.sum(solve(0.5 * (p + p.transpose(1, 2)), g) * w).backward()
    grads.append((p.grad, g.grad))
  for a, b in zip(*grads):
    assert float((a - b).abs().max() / b.abs().max()) <= 1e-10


def test_diff_config_matches_mjtpu_and_is_thread_local():
  """The same fields and defaults as mjtpu's DiffConfig; the mode nests,
  restores the outer config and is seen only by its own thread."""
  got = {f.name: f.default for f in dataclasses.fields(mjtpu_torch.DiffConfig)}
  want = {f.name: f.default for f in dataclasses.fields(mjtpu.DiffConfig)}
  assert got == want
  assert mjtpu_torch.get_diff_config() is None
  with mjtpu_torch.differentiable_mode(cfd=False) as outer:
    assert mjtpu_torch.get_diff_config() is outer and not outer.cfd
    with mjtpu_torch.differentiable_mode(mjtpu_torch.DiffConfig(smooth_sharpness=5.0)) as inner:
      assert mjtpu_torch.get_diff_config() is inner
      seen = []
      t = threading.Thread(target=lambda: seen.append(mjtpu_torch.get_diff_config()))
      t.start()
      t.join()
      assert seen == [None]
    assert mjtpu_torch.get_diff_config() is outer
  assert mjtpu_torch.get_diff_config() is None


def _bench(batch=2):
  m = chip_smoke.diff_scene_model("humanoid_bench", "cpu")
  g = _golden()
  d = mjtpu_torch.replace(mjtpu_torch.make_data(m, batch_size=batch),
                          qpos=torch.as_tensor(g["humanoid_bench.qpos0"][:batch]),
                          qvel=torch.as_tensor(g["humanoid_bench.qvel0"][:batch]),
                          ctrl=torch.as_tensor(g["humanoid_bench.ctrl0"][0, :batch]))
  return m, d


def test_no_host_check_in_solver_loops_under_the_mode(monkeypatch):
  """Under the mode (and with fixed_iterations) the solver converts no
  tensor to a Python bool: its loops run to their bounds; outside it the
  early exit checks once per iteration and round.  The values agree bit
  for bit either way."""
  m, d = _bench()
  d = mjtpu_torch.fwd_acceleration(m, mjtpu_torch.fwd_actuation(m, mjtpu_torch.fwd_velocity(
      m, mjtpu_torch.fwd_position(m, d))))
  calls = []
  real = torch.Tensor.__bool__
  monkeypatch.setattr(torch.Tensor, "__bool__", lambda t: calls.append(1) or real(t))
  plain = solver.solve(m, d)
  n_plain = len(calls)
  calls.clear()
  fixed = solver.solve(m, d, fixed_iterations=True)
  n_fixed = len(calls)
  with mjtpu_torch.differentiable_mode():
    mode = solver.solve(m, d)
  n_mode = len(calls) - n_fixed
  monkeypatch.undo()
  assert n_plain > 0 and n_fixed == 0 and n_mode == 0
  for a in (fixed, mode):
    assert torch.equal(a.qacc, plain.qacc) and torch.equal(a.efc_force, plain.efc_force)


def test_step_takes_fixed_iterations():
  """step and forward take fixed_iterations, and the step equals the early
  exit's bit for bit (finished envs are frozen)."""
  m, d = _bench()
  a, b = mjtpu_torch.step(m, d), mjtpu_torch.step(m, d, fixed_iterations=True)
  assert torch.equal(a.qpos, b.qpos) and torch.equal(a.qvel, b.qvel)
  f = mjtpu_torch.forward(m, d, fixed_iterations=True)
  assert torch.equal(f.qacc, a.qacc)


def test_adaptive_substeps_on_per_env_timesteps():
  """With adaptive_integration a step is adaptive_substeps steps of each
  env's own timestep / n, on a Model with one timestep row per env."""
  m = chip_smoke.diff_scene_model("pendulum", "cpu")
  qvel = torch.as_tensor(_golden()["pendulum.qvel0"])
  h = torch.tensor([0.004, 0.005, 0.006, 0.008], dtype=torch.float64)
  mr, _ = parallel.randomize(m, {"opt.timestep": h})
  mq, _ = parallel.randomize(m, {"opt.timestep": h / 4})
  d = mjtpu_torch.replace(mjtpu_torch.make_data(m, batch_size=4), qvel=qvel)
  with mjtpu_torch.differentiable_mode(adaptive_integration=True, adaptive_substeps=4):
    got = mjtpu_torch.step(mr, d)
  want = d
  for _ in range(4):
    want = mjtpu_torch.step(mq, want, fixed_iterations=True)
  assert torch.equal(got.qpos, want.qpos) and torch.equal(got.qvel, want.qvel)
  assert torch.allclose(got.time, h.to(got.time.dtype))


def test_kernel_seams_call_the_wrappers_in_every_mode(monkeypatch):
  """Under the mode, as outside it, the engine calls B2's, B3's and B4's
  wrappers (the kernels on the card) through their differentiable seams,
  and the gradient flows through them: the box-on-box min distance, the
  terrain's manifold and the LDL factor and solves."""
  calls = []

  def counting(mod, fn):
    real = getattr(mod, fn)
    monkeypatch.setattr(mod, fn, lambda *a, **k: calls.append(fn) or real(*a, **k))

  for mod, fn in ((sat, "sat_winners_batch"), (hfield, "manifold_batch"), (ldl, "ldl_factor"),
                  (ldl, "ldl_solve"), (ldl, "ldl_factor_solve")):
    counting(mod, fn)
  m = chip_smoke.diff_scene_model("box_box", "cpu")
  q = torch.as_tensor(_golden()["box_box.qpos0"]).requires_grad_(True)
  d = mjtpu_torch.replace(mjtpu_torch.make_data(m, batch_size=q.shape[0]), qpos=q)
  with mjtpu_torch.differentiable_mode():
    dist = torch.amin(mjtpu_torch.fwd_position(m, d).contact.dist, dim=-1)
  assert calls == ["sat_winners_batch"]
  dist.sum().backward()
  assert float(q.grad[:, 2].abs().min()) > 0.5
  terrain = mjtpu_torch.model_from_arrays(
      mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / "humanoid_terrain_model.npz"), device="cpu")
  qt = mjtpu_torch.make_data(terrain, batch_size=1).qpos.clone().requires_grad_(True)
  d = mjtpu_torch.replace(mjtpu_torch.make_data(terrain, batch_size=1), qpos=qt)
  calls.clear()
  with mjtpu_torch.differentiable_mode():
    dist = mjtpu_torch.fwd_position(terrain, d).contact.dist
  assert "manifold_batch" in calls
  torch.sum(torch.where(dist < 1.0, dist, 0.0)).backward()
  assert qt.grad is not None and bool(torch.isfinite(qt.grad).all())
  t = sparse.device_tables(sparse._build(66, chip_smoke.branchy_parentid(6, 10)),
                           torch.float64, "cpu")
  mat = torch.eye(66, dtype=torch.float64)[None].repeat(2, 1, 1).requires_grad_(True)
  b = torch.ones(2, 66, dtype=torch.float64)
  calls.clear()
  with mjtpu_torch.differentiable_mode():
    x = fused.ldl_factor_solve(t, mat, b)
    S = fused.ldl_factor(t, mat)
    y = fused.ldl_solve(t, S, b)
  assert calls == ["ldl_factor_solve", "ldl_factor", "ldl_solve"]
  (x.sum() + y.sum()).backward()
  assert torch.allclose(x, b) and torch.allclose(y, b) and mat.grad is not None


def _small_tree(batch, gen):
  t = sparse.device_tables(sparse._build(14, chip_smoke.branchy_parentid(2, 4)),
                           torch.float64, "cpu")
  mc, rhs, _ = chip_smoke.chain_pattern_batch(t, batch, torch.float64, gen)
  return t, mc, rhs


@pytest.mark.parametrize("seam", ["ldl_factor_solve", "ldl_solve", "ldl_factor"])
def test_ldl_seam_gradcheck(seam):
  """B2's differentiable seams pass gradcheck at f64 on a 14-dof tree: the
  analytic backwards of the factor-solve and the solve (the kernel once
  more for rhs_bar, the pattern's outer product for Mc_bar) and the
  factor's twin backward."""
  gen = torch.Generator().manual_seed(1)
  t, mc, rhs = _small_tree(3, gen)
  fn, inputs = {
      "ldl_factor_solve": (lambda mc, b: ldl.LdlFactorSolve.apply(t, mc, b), (mc, rhs)),
      "ldl_solve": (lambda s, b: ldl.LdlSolve.apply(t, s, b),
                    (ldl.ldl_factor_reference(t, mc), rhs)),
      "ldl_factor": (lambda mc: ldl.ldl_factor_differentiable(t, mc), (mc,)),
  }[seam]
  xs = [x.detach().clone().requires_grad_(True) for x in inputs]
  assert torch.autograd.gradcheck(fn, xs)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_seams_match_twin_autograd(dtype):
  """Every differentiable seam of B2, B3 and B4 (chip_smoke.seam_grad_errors,
  phase 34's check on the card) against autograd through its twin on the
  CPU: phase 3's tolerances; the CPU launches no kernel."""
  errs = chip_smoke.seam_grad_errors("cpu", dtype, 6, torch.Generator().manual_seed(3))
  tol = 1e-10 if dtype == torch.float64 else 1e-4
  assert set(errs) == {"ldl_factor_solve", "ldl_solve", "ldl_factor", "sat_winners",
                       "hfield_manifold"}
  assert all(e <= tol and (f, b) == (0, 0) for e, f, b in errs.values()), errs


def test_refuse_grad():
  """The guard of B2's, B3's and B4's wrappers on the card: it raises on an
  input that requires grad while grad mode is on, and only then."""
  x = torch.zeros(3, requires_grad=True)
  with pytest.raises(RuntimeError, match="no backward"):
    _build.refuse_grad("sat", torch.zeros(3), x)
  with torch.no_grad():
    _build.refuse_grad("sat", x)
  _build.refuse_grad("sat", torch.zeros(3), None)


def test_sat_seps_carry_the_gradient():
  """convex_convex's SAT separations carry their gradient (the seam's
  backward is the twin's, mjtpu's _sat_winners_jnp): d seps / d z of the
  top box is +-1 on its face separations."""
  pos2 = torch.tensor([[0.03, 0.01, 0.205]], dtype=torch.float64, requires_grad=True)
  eye = torch.eye(3, dtype=torch.float64)[None]
  h1 = collision_convex.hull_consts(mesh.box(np.array([0.2, 0.2, 0.1])), torch.float64, "cpu")
  h2 = collision_convex.hull_consts(mesh.box(np.array([0.1, 0.1, 0.1])), torch.float64, "cpu")
  with mjtpu_torch.differentiable_mode():
    seps, _ = collision_convex._sat_winners(torch.zeros(1, 3, dtype=torch.float64), eye, pos2,
                                            eye, h1, h2)
  seps[0, 0].backward()
  assert float(pos2.grad[0, 2]) == pytest.approx(1.0)
