"""Constraint solver: CG (Polak-Ribiere) and Newton over the primal cost.

Port of mjtpu/_src/solver.py's dense CG and Newton paths (_row_costs,
_ls_point, _rescale, warmstart selection, precond_grad, C's 3-point
linesearch, the iteration body), batch-explicit over B envs.

mjtpu runs its data-dependent loops as ``lax.while_loop`` under
``jax.vmap``, which keeps iterating until every lane is done and freezes
the finished lanes.  Here finished envs are frozen by
``torch.where(done, old, new)``, and both solvers, CG and Newton, leave
each loop as soon as no env runs on: a host check before each solver
iteration (``done.all()``) and before each linesearch round (no running
env continues).  That is exact: an env that is done, or whose linesearch
has stopped, is frozen, so the rounds after the last env stops change
nothing, and mjtpu's vmapped while_loop stops at the same point.  It is
also needed: the bounds (CG 30 x 50 on scene_pile, Newton 100 x 50 on
ant_bench) would otherwise run ~10^5 eager launches a step where mjtpu's
loops stop after a few.  ``loop_counts`` adds up the iterations and
rounds the loops ran; ``EARLY_EXIT = False`` runs them to their bounds.

The primal problem (MuJoCo Computation docs): minimize over qacc
    0.5 (qacc - qacc_smooth)' M (qacc - qacc_smooth) + s(J qacc - aref)
where s() sums one-sided quadratic penalties for limit and pyramidal
contact rows.  Frictionloss zones and elliptic cones wait for later
slices; put_model refuses models that need them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mjtpu_torch._src import math, smooth
from mjtpu_torch._src.dataclasses import replace
from mjtpu_torch._src.types import Data, DisableBit, Model, SolverType
from mjtpu_torch.ops import fused

# solver iterations and linesearch rounds run (each counts once for the
# whole batch), since import
loop_counts = {"iterations": 0, "ls_rounds": 0}
# leave each loop once no env runs on (module docstring); False runs every
# loop to its bound, whose results are the same bits
EARLY_EXIT = True


class _Context(NamedTuple):
  """Solver iterate, one row per env."""

  qacc: torch.Tensor       # (B, nv)
  Ma: torch.Tensor         # (B, nv) M @ qacc
  Jaref: torch.Tensor      # (B, nefc) J @ qacc - aref
  efc_force: torch.Tensor  # (B, nefc)
  cost: torch.Tensor       # (B,)
  grad: torch.Tensor       # (B, nv)
  quad: torch.Tensor       # (B, nefc) bool: row cost locally quadratic
  Mgrad: torch.Tensor      # (B, nv) the previous iteration's M^-1 grad (CG beta)
  search: torch.Tensor     # (B, nv) the previous iteration's search (CG beta)
  gMg: torch.Tensor        # (B,) dot(prev grad, prev Mgrad), CG beta's denominator
  gauss: torch.Tensor      # (B,)
  niter: torch.Tensor      # (B,) int32
  done: torch.Tensor       # (B,) bool


class _LSPoint(NamedTuple):
  alpha: torch.Tensor  # (B,)
  cost: torch.Tensor   # (B,)
  d0: torch.Tensor     # (B,) phi'(alpha)
  d1: torch.Tensor     # (B,) phi''(alpha), floored positive


def _where(cond: torch.Tensor, a, b):
  """Per-env select between two NamedTuples of (B, ...) tensors."""
  pick = lambda x, y: torch.where(cond.reshape(cond.shape + (1,) * (x.dim() - 1)), x, y)
  return type(a)(*(pick(x, y) for x, y in zip(a, b)))


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  return torch.sum(a * b, dim=-1)


def _row_costs(Jaref: torch.Tensor, efc_D: torch.Tensor):
  """Per-row force / total cost / quadratic-active mask at x = Jaref.
  Every row of the slice is an inequality row (limit or pyramidal contact),
  active only where x < 0."""
  active = Jaref < 0
  force = torch.where(active, -efc_D * Jaref, 0.0)
  cost = torch.where(active, 0.5 * efc_D * Jaref * Jaref, 0.0)
  return force, torch.sum(cost, dim=-1), active


def _ls_point(quad_gauss, quad, Jaref, jv, alpha) -> _LSPoint:
  """(cost, phi', phi'') of the piecewise-quadratic total cost at alpha —
  MuJoCo C's LSPoint: per-row quadratic coefficients masked by the active
  set at x = Jaref + alpha*jv."""
  x = Jaref + alpha[:, None] * jv
  active = x < 0
  qt = quad_gauss + torch.sum(torch.where(active[..., None], quad, 0.0), dim=1)
  cost = alpha * alpha * qt[:, 2] + alpha * qt[:, 1] + qt[:, 0]
  # A Newton candidate inside one quadratic piece has phi' algebraically
  # zero.  mjtpu's compiled linesearch evaluates phi' with a fused
  # multiply-add and gets the tiny true residual, so the candidate joins
  # the bracket and ends the search; a rounded product often gives exactly
  # 0.0, which neither joins nor ends it.  The exact product follows mjtpu.
  d0 = math.fma(2.0 * alpha, qt[:, 2], qt[:, 1])
  d1 = 2.0 * qt[:, 2]
  # guard degenerate d1 over the whole |d1| < MINVAL band (see mjtpu)
  d1 = torch.where(torch.abs(d1) < math.MINVAL, math.MINVAL, d1)
  return _LSPoint(alpha=alpha, cost=cost, d0=d0, d1=d1)


def _rescale(m: Model, value):
  return value / (m.stat.meaninertia * max(1, m.nv))


def solve(m: Model, d: Data) -> Data:
  """Solves for constrained qacc (mj_fwdConstraint, CG or Newton)."""
  dtype = d.qpos.dtype
  efc_J, efc_D, efc_aref = d.efc_J, d.efc_D, d.efc_aref
  qfrc_smooth, qacc_smooth = d.qfrc_smooth, d.qacc_smooth
  efc_JT = efc_J.transpose(-1, -2)
  matvec = lambda a, x: (a @ x[..., None])[..., 0]

  def update_constraint(qacc, Ma, Jaref):
    force, cost_c, quad = _row_costs(Jaref, efc_D)
    gauss = 0.5 * _dot(Ma - qfrc_smooth, qacc - qacc_smooth)
    return force, gauss + cost_c, gauss, quad

  def gradient(Ma, force):
    return Ma - qfrc_smooth - matvec(efc_JT, force)

  # f32: regularize the Hessian so near-singular active sets stay
  # factorable (preconditioner only; the exact linesearch still minimizes
  # the true cost)
  reg = None if dtype == torch.float64 else 1e-6 * m.stat.meaninertia
  eye = torch.eye(m.nv, dtype=dtype, device=d.qpos.device)

  newton = m.opt.solver == SolverType.NEWTON

  def precond_grad(grad, quad):
    if not newton:
      return smooth.solve_m(m, d, grad)
    Dq = efc_D * quad
    h = d.qM + (efc_JT * Dq[:, None, :]) @ efc_J
    if reg is not None:
      h = h + reg * eye
    return fused.chol_solve(h, grad)

  def linesearch(Ma, Jaref, search, gauss, running):
    """MuJoCo C's exact 3-point lo/hi bracket-swap linesearch (``running``:
    the envs whose result is kept)."""
    mv = matvec(d.qM, search)
    jv = matvec(efc_J, search)

    smag = math.safe_norm(search) * m.stat.meaninertia * max(1, m.nv)
    gtol = m.opt.tolerance * m.opt.ls_tolerance * smag

    quad_gauss = torch.stack(
        [gauss, _dot(search, Ma - qfrc_smooth), 0.5 * _dot(search, mv)], dim=-1
    )
    quad = torch.stack([0.5 * Jaref * Jaref, jv * Jaref, 0.5 * jv * jv], dim=-1) * efc_D[..., None]

    point = lambda a: _ls_point(quad_gauss, quad, Jaref, jv, a)

    p0 = point(torch.zeros_like(gauss))
    p1 = point(p0.alpha - p0.d0 / p0.d1)
    # if the Newton step already meets gtol, skip the bracket search
    early = torch.abs(p1.d0) < gtol
    swap01 = p1.d0 < p0.d0
    lo = _where(swap01, p1, p0)
    hi = _where(swap01, p0, p1)
    swap = ~early

    in_bracket = lambda cur, cand: ((cur < cand) & (cand < 0)) | ((cur > cand) & (cand > 0))

    # converged lanes frozen; left once none continues (module docstring)
    for _ in range(m.opt.ls_iterations):
      cont = swap & ~((lo.d0 < 0) & (lo.d0 > -gtol)) & ~((hi.d0 > 0) & (hi.d0 < gtol))
      if EARLY_EXIT and not bool((cont & running).any()):
        break
      loop_counts["ls_rounds"] += 1
      lo_next = point(lo.alpha - lo.d0 / lo.d1)
      hi_next = point(hi.alpha - hi.d0 / hi.d1)
      mid = point(0.5 * (lo.alpha + hi.alpha))

      # accept a candidate if it narrows the bracket toward zero derivative,
      # or (no bracket yet) if it reduces |phi'| — C's one-sided Newton phase
      not_bracketed = (lo.d0 < 0) == (hi.d0 < 0)
      accept = lambda cur, cand: in_bracket(cur, cand) | (
          not_bracketed & (torch.abs(cand) < torch.abs(cur))
      )
      nlo, nhi = lo, hi
      s1 = accept(nlo.d0, lo_next.d0)
      nlo = _where(s1, lo_next, nlo)
      s2 = accept(nlo.d0, mid.d0)
      nlo = _where(s2, mid, nlo)
      s3 = accept(nlo.d0, hi_next.d0)
      nlo = _where(s3, hi_next, nlo)
      s4 = accept(nhi.d0, hi_next.d0)
      nhi = _where(s4, hi_next, nhi)
      s5 = accept(nhi.d0, mid.d0)
      nhi = _where(s5, mid, nhi)
      s6 = accept(nhi.d0, lo_next.d0)
      nhi = _where(s6, lo_next, nhi)
      lo = _where(cont, nlo, lo)
      hi = _where(cont, nhi, hi)
      swap = torch.where(cont, s1 | s2 | s3 | s4 | s5 | s6, swap)

    # move only if improved; prefer the lower-cost endpoint
    improved = (lo.cost < p0.cost) | (hi.cost < p0.cost)
    alpha = torch.where(lo.cost < hi.cost, lo.alpha, hi.alpha)
    alpha = torch.where(improved, alpha, 0.0)
    return alpha, mv, jv

  def make_state(qacc):
    Ma = matvec(d.qM, qacc)
    Jaref = matvec(efc_J, qacc) - efc_aref
    force, cost, gauss, quad = update_constraint(qacc, Ma, Jaref)
    return qacc, Ma, Jaref, force, cost, gauss, quad

  def make_ctx(state):
    qacc, Ma, Jaref, force, cost, gauss, quad = state
    B = qacc.shape[0]
    return _Context(
        qacc=qacc, Ma=Ma, Jaref=Jaref, efc_force=force, cost=cost,
        grad=gradient(Ma, force), quad=quad, Mgrad=torch.zeros_like(qacc),
        search=torch.zeros_like(qacc),
        gMg=torch.full_like(cost, torch.inf),  # beta = x / inf = 0 on iteration 0
        gauss=gauss,
        niter=torch.zeros(B, dtype=torch.int32, device=qacc.device),
        done=torch.zeros(B, dtype=torch.bool, device=qacc.device),
    )

  # warmstart: the better of qacc_warmstart and qacc_smooth by cost; the
  # winner's gradient is computed once in make_ctx
  if m.opt.disableflags & DisableBit.WARMSTART:
    ctx = make_ctx(make_state(qacc_smooth))
  else:
    st_w = make_state(d.qacc_warmstart)
    st_s = make_state(qacc_smooth)
    better = st_w[4] < st_s[4]
    ctx = make_ctx(tuple(
        torch.where(better.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
        for a, b in zip(st_w, st_s)
    ))

  for _ in range(m.opt.iterations):
    if EARLY_EXIT and bool(ctx.done.all()):
      break
    loop_counts["iterations"] += 1
    # the expensive preconditioned gradient runs once per iteration
    mgrad = precond_grad(ctx.grad, ctx.quad)
    if newton:
      search = -mgrad
    else:
      # Polak-Ribiere, floored at 0
      beta = _dot(ctx.grad, mgrad - ctx.Mgrad) / torch.clamp_min(ctx.gMg, math.MINVAL)
      search = -mgrad + torch.clamp_min(beta, 0.0)[:, None] * ctx.search
    gMg = _dot(ctx.grad, mgrad)
    alpha, mv, jv = linesearch(ctx.Ma, ctx.Jaref, search, ctx.gauss, ~ctx.done)
    qacc = ctx.qacc + alpha[:, None] * search
    Ma = ctx.Ma + alpha[:, None] * mv
    Jaref = ctx.Jaref + alpha[:, None] * jv
    force, cost, gauss, quad = update_constraint(qacc, Ma, Jaref)
    # reject non-improving steps (the iterate only: gauss and the CG
    # history take the new values, as in mjtpu)
    worse = cost > ctx.cost
    new = ctx._replace(qacc=qacc, Ma=Ma, Jaref=Jaref, efc_force=force, cost=cost, quad=quad)
    new = _where(worse, ctx, new)._replace(gauss=gauss, Mgrad=mgrad, search=search, gMg=gMg)
    grad = gradient(new.Ma, new.efc_force)
    improvement = _rescale(m, ctx.cost - new.cost)
    gradnorm = _rescale(m, math.safe_norm(grad))
    done = ctx.done | (improvement < m.opt.tolerance) | (gradnorm < m.opt.tolerance)
    new = new._replace(grad=grad, niter=ctx.niter + 1, done=done)
    # freeze finished envs (mjtpu's body does the same)
    ctx = _where(ctx.done, ctx, new)

  qfrc_constraint = matvec(efc_JT, ctx.efc_force)
  return replace(
      d, qacc=ctx.qacc, qacc_warmstart=ctx.qacc, qfrc_constraint=qfrc_constraint,
      efc_force=ctx.efc_force, solver_niter=ctx.niter,
  )
