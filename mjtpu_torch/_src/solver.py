"""Constraint solver: CG (Polak-Ribiere) and Newton over the primal cost.

Port of mjtpu/_src/solver.py's dense CG and Newton paths (_row_costs with
its equality, frictionloss and elliptic-cone zones, _ls_point, _rescale, warmstart
selection, precond_grad with the elliptic cone Hessian, C's 3-point
linesearch, the iteration body), batch-explicit over B envs.  mjtpu's
opt-in forest PCG Newton (MJTPU_NEWTON_PCG, off by default) is not
ported.

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
``fixed_iterations`` (on by itself under ``differentiable_mode``) runs
both loops to their bounds with no host check inside either, as mjtpu's
fori_loops with the finished lanes frozen: the same values, and a graph
that autograd can run backward.

The primal problem (MuJoCo Computation docs): minimize over qacc
    0.5 (qacc - qacc_smooth)' M (qacc - qacc_smooth) + s(J qacc - aref)
where s() sums per-row penalties: huber-like for frictionloss rows,
one-sided quadratic for limit and pyramidal contact rows, and
cone-projected quadratic for elliptic contacts.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mjtpu_torch._src import math, smooth, support
from mjtpu_torch._src.dataclasses import replace
from mjtpu_torch._src.diff_config import get_diff_config
from mjtpu_torch._src.types import (ConeType, Data, DisableBit, Model, SolverType, cached,
                                    rows as env_rows)
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


class _EfcMeta(NamedTuple):
  """Static row-type structure (host)."""

  nf: int     # the frictionloss rows, [ne, ne + nf)
  nefc: int
  # elliptic contacts by condim, ((dim, first row, K contacts, first
  # contact), ...).  The driver sorts contacts by condim, so a group's
  # K * dim rows are contiguous and a slice and a reshape read them as
  # (B, K, dim) blocks: each group is one batched computation, and the
  # launches stay flat in K.
  elliptic_groups: tuple
  ne: int = 0  # the equality rows come first, [0, ne): quadratic everywhere


def _efc_meta(m: Model) -> _EfcMeta:
  def build():
    from mjtpu_torch._src import collision_driver

    ne, nf, nl, nefc = support.count_constraints(m)
    groups = []
    if m.opt.cone == ConeType.ELLIPTIC:
      dims = collision_driver.make_condim(m)
      addr = collision_driver.contact_efc_address(m, ne, nf, nl)
      for dim in sorted(set(int(c) for c in dims) - {1}):
        idx = np.nonzero(dims == dim)[0]
        first, k = int(addr[idx[0]]), len(idx)
        if not (np.array_equal(idx, idx[0] + np.arange(k))
                and np.array_equal(addr[idx], first + dim * np.arange(k))):
          raise AssertionError(f"condim {dim} contacts are not contiguous: {idx}")
        groups.append((dim, first, k, int(idx[0])))
    return _EfcMeta(nf, nefc, tuple(groups), ne)

  return cached(m, "solver.efc_meta", build)


class _Cone(NamedTuple):
  """One elliptic group's quantities that depend on efc_D and the
  friction only (fixed through a solve): mjtpu's _elliptic_geometry
  transforms the anisotropic cone to a circular one in a D-weighted
  space, v_i = u_i sqrt(D_i / D_n), of slope mu_t = mu_0 sqrt(D_n / D_t1)."""

  dim: int
  rows: slice                # the group's K * dim efc rows
  D: torch.Tensor            # (B, K, dim)
  v_scale: torch.Tensor      # (B, K, dim - 1)
  mu_t: torch.Tensor         # (B, K)
  dm: torch.Tensor           # (B, K) D_n / (1 + mu_t^2)


def _cones(meta: _EfcMeta, efc_D: torch.Tensor, friction: torch.Tensor) -> list[_Cone]:
  cones = []
  for dim, first, k, c0 in meta.elliptic_groups:
    rows = slice(first, first + k * dim)
    D = efc_D[:, rows].reshape(-1, k, dim)
    d_n = D[..., 0]
    v_scale = torch.sqrt(D[..., 1:] / torch.clamp_min(d_n, math.MINVAL)[..., None])
    mu_t = friction[:, c0:c0 + k, 0] * torch.sqrt(d_n / torch.clamp_min(D[..., 1], math.MINVAL))
    dm = d_n / (1.0 + mu_t * mu_t)
    cones.append(_Cone(dim, rows, D, v_scale, mu_t, dm))
  return cones


def _block(x: torch.Tensor, c: _Cone) -> torch.Tensor:
  """(B, K, dim) view of a group's rows of x (B, nefc)."""
  return x[:, c.rows].reshape(x.shape[0], -1, c.dim)


def _splice(x: torch.Tensor, c: _Cone, blk: torch.Tensor) -> torch.Tensor:
  """x with the group's rows replaced by blk (B, K, dim)."""
  return torch.cat([x[:, :c.rows.start], blk.reshape(x.shape[0], -1), x[:, c.rows.stop:]], dim=1)


def _row_costs(meta: _EfcMeta, cones: list[_Cone], Jaref, efc_D, efc_frictionloss):
  """Per-row force / total cost / quadratic-active mask at x = Jaref:
  equality rows are quadratic everywhere, frictionloss rows linear beyond
  +-R*frictionloss, limit and contact rows active only where x < 0, and
  each elliptic contact's block is priced by its cone zone."""
  ne, nf = meta.ne, meta.nf
  x, D = Jaref[:, ne + nf:], efc_D[:, ne + nf:]
  active = x < 0
  force = torch.where(active, -D * x, 0.0)
  cost = torch.where(active, 0.5 * D * x * x, 0.0)
  quad = active
  if nf:
    fr = slice(ne, ne + nf)
    x, D, f = Jaref[:, fr], efc_D[:, fr], efc_frictionloss[:, fr]
    R = 1.0 / torch.clamp_min(D, math.MINVAL)
    lin_neg = x <= -R * f
    lin_pos = x >= R * f
    f_force = torch.where(lin_neg, f, torch.where(lin_pos, -f, -D * x))
    f_cost = torch.where(lin_neg, -f * x - 0.5 * R * f * f,
                         torch.where(lin_pos, f * x - 0.5 * R * f * f, 0.5 * D * x * x))
    force = torch.cat([f_force, force], dim=1)
    cost = torch.cat([f_cost, cost], dim=1)
    quad = torch.cat([~(lin_neg | lin_pos), quad], dim=1)
  if ne:
    x, D = Jaref[:, :ne], efc_D[:, :ne]
    force = torch.cat([-D * x, force], dim=1)
    cost = torch.cat([0.5 * D * x * x, cost], dim=1)
    quad = torch.cat([torch.ones_like(x, dtype=torch.bool), quad], dim=1)

  for c in cones:
    U = _block(Jaref, c)
    N, T = U[..., 0], math.safe_norm(U[..., 1:] * c.v_scale)
    top = N >= c.mu_t * T
    bottom = (c.mu_t * N + T) <= 0
    nmt = N - c.mu_t * T
    mid_cost = 0.5 * c.dm * nmt * nmt
    # middle-zone force: fn = -dm (N - mu T); ft_i = (D_i/D_n) dm mu nmt u_i / T
    fn_mid = -c.dm * nmt
    tsafe = torch.clamp_min(T, math.MINVAL)
    ft_mid = ((c.D[..., 1:] / c.D[..., :1]) * c.dm[..., None] * c.mu_t[..., None]
              * nmt[..., None] * U[..., 1:] / tsafe[..., None])
    f_mid = torch.cat([fn_mid[..., None], ft_mid], dim=-1)
    f_bottom = -c.D * U
    c_bottom = 0.5 * torch.sum(c.D * U * U, dim=-1)
    f_blk = torch.where(top[..., None], 0.0, torch.where(bottom[..., None], f_bottom, f_mid))
    c_blk = torch.where(top, 0.0, torch.where(bottom, c_bottom, mid_cost))
    force = _splice(force, c, f_blk)
    # the block's cost on its normal row, zero on its friction rows
    cost = _splice(cost, c, torch.cat([c_blk[..., None], torch.zeros_like(U[..., 1:])], dim=-1))
    quad = _splice(quad, c, bottom[..., None].expand(U.shape))
  return force, torch.sum(cost, dim=-1), quad


class _LSCone(NamedTuple):
  """One elliptic group's linesearch terms that do not depend on alpha."""

  cone: _Cone
  JV: torch.Tensor      # (B, K, dim) the block's J @ search
  ju: torch.Tensor      # (B, K, dim - 1) its friction part, scaled
  dd_bot: torch.Tensor  # (B, K) phi'' of the bottom zone
  juju: torch.Tensor    # (B, K) |ju|^2


def _ls_cones(cones: list[_Cone], jv: torch.Tensor) -> list[_LSCone]:
  out = []
  for c in cones:
    JV = _block(jv, c)
    ju = JV[..., 1:] * c.v_scale
    out.append(_LSCone(c, JV, ju, torch.sum(c.D * JV * JV, dim=-1), torch.sum(ju * ju, dim=-1)))
  return out


def _ls_point(quad_gauss, quad, Jaref, jv, alpha, fric=None, cones=(), ne=0) -> _LSPoint:
  """(cost, phi', phi'') of the piecewise-quadratic total cost at alpha —
  MuJoCo C's LSPoint: per-row quadratic coefficients masked by the active
  set at x = Jaref + alpha*jv (the ``ne`` equality rows always active),
  plus the frictionloss rows' linear zones (``fric``: (nf, efc_D,
  efc_frictionloss), rows [ne, ne + nf)) and each elliptic group's cone
  zones in place of its rows' one-sided quadratic."""
  x = Jaref + alpha[:, None] * jv
  active = x < 0
  if ne:
    active = torch.cat([torch.ones_like(active[:, :ne]), active[:, ne:]], dim=1)
  adjust = None
  if fric is not None:
    nf, efc_D, efc_frictionloss = fric
    fr = slice(ne, ne + nf)
    xf, f = x[:, fr], efc_frictionloss[:, fr]
    rf = 1.0 / torch.clamp_min(efc_D[:, fr], math.MINVAL) * f
    has_f = f > 0
    fl_ln = has_f & (xf <= -rf)
    fl_lp = has_f & (xf >= rf)
    ja, jvf = Jaref[:, fr], jv[:, fr]
    qf0 = (torch.sum(torch.where(fl_ln, f * (-0.5 * rf - ja), 0.0), dim=-1)
           + torch.sum(torch.where(fl_lp, f * (-0.5 * rf + ja), 0.0), dim=-1))
    qf1 = (torch.sum(torch.where(fl_ln, -f * jvf, 0.0), dim=-1)
           + torch.sum(torch.where(fl_lp, f * jvf, 0.0), dim=-1))
    adjust = torch.stack([qf0, qf1, torch.zeros_like(qf0)], dim=-1)
    # a friction row is quadratic everywhere but in its linear zones
    active = torch.cat([active[:, :ne], ~(fl_ln | fl_lp), active[:, ne + nf:]], dim=1)
  qt = quad_gauss + torch.sum(torch.where(active[..., None], quad, 0.0), dim=1)
  if adjust is not None:
    qt = qt + adjust
  cost = alpha * alpha * qt[:, 2] + alpha * qt[:, 1] + qt[:, 0]
  # A Newton candidate inside one quadratic piece has phi' algebraically
  # zero.  mjtpu's compiled linesearch evaluates phi' with a fused
  # multiply-add and gets the tiny true residual, so the candidate joins
  # the bracket and ends the search; a rounded product often gives exactly
  # 0.0, which neither joins nor ends it.  The exact product follows mjtpu.
  d0 = math.fma(2.0 * alpha, qt[:, 2], qt[:, 1])
  d1 = 2.0 * qt[:, 2]

  # elliptic groups: their rows' one-sided quadratic out, the cone zones in
  for lc in cones:
    c, JV = lc.cone, lc.JV
    X = _block(x, c)
    N, v = X[..., 0], X[..., 1:] * c.v_scale
    T = math.safe_norm(v)
    top = N >= c.mu_t * T
    bottom = (c.mu_t * N + T) <= 0
    blk_active = X < 0
    cost = cost - torch.sum(torch.where(blk_active, 0.5 * c.D * X * X, 0.0), dim=(1, 2))
    d0 = d0 - torch.sum(torch.where(blk_active, c.D * X * JV, 0.0), dim=(1, 2))
    d1 = d1 - torch.sum(torch.where(blk_active, c.D * JV * JV, 0.0), dim=(1, 2))
    # bottom: the full quadratic over the block
    c_bot = 0.5 * torch.sum(c.D * X * X, dim=-1)
    d_bot = torch.sum(c.D * X * JV, dim=-1)
    # middle: the cone cost 0.5 dm (N - mu T)^2; T -> 0 (no slip) is
    # guarded by the MINVAL floor, as in mjtpu
    tsafe = torch.clamp_min(T, math.MINVAL)
    dt = torch.sum(v * lc.ju, dim=-1) / tsafe
    ddt = (lc.juju - dt * dt) / tsafe
    nmt = N - c.mu_t * T
    dnmt = JV[..., 0] - c.mu_t * dt
    c_mid = 0.5 * c.dm * nmt * nmt
    d_mid = c.dm * nmt * dnmt
    dd_mid = c.dm * (dnmt * dnmt + nmt * (-c.mu_t) * ddt)
    zone = lambda b, mid: torch.sum(
        torch.where(top, 0.0, torch.where(bottom, b, mid)), dim=-1)
    cost = cost + zone(c_bot, c_mid)
    d0 = d0 + zone(d_bot, d_mid)
    d1 = d1 + zone(lc.dd_bot, dd_mid)

  # guard degenerate d1 over the whole |d1| < MINVAL band (see mjtpu)
  d1 = torch.where(torch.abs(d1) < math.MINVAL, math.MINVAL, d1)
  return _LSPoint(alpha=alpha, cost=cost, d0=d0, d1=d1)


def _cone_blocks(cones: list[_Cone], efc_J: torch.Tensor, Jaref: torch.Tensor) -> list:
  """Each elliptic group's exact cone Hessian in the middle zone,
    H = Dm a a' - (Dm nmt mu / T) S (I - v v') S,  a = (1, -mu S v_hat),
  zero in the others: [(hcone (B, K, dim, dim), Jblk (B, K, dim, nv))]."""
  out = []
  for c in cones:
    U = _block(Jaref, c)
    B, K = U.shape[:2]
    Jblk = efc_J[:, c.rows].reshape(B, K, c.dim, efc_J.shape[-1])
    N, T = U[..., 0], math.safe_norm(U[..., 1:] * c.v_scale)
    middle = (N < c.mu_t * T) & ((c.mu_t * N + T) > 0)
    tsafe = torch.clamp_min(T, math.MINVAL)
    v_hat = U[..., 1:] * c.v_scale / tsafe[..., None]
    a = torch.cat([torch.ones_like(N)[..., None], -c.mu_t[..., None] * c.v_scale * v_hat], dim=-1)
    hcone = c.dm[..., None, None] * a[..., :, None] * a[..., None, :]
    nmt = N - c.mu_t * T
    curv = -(c.dm * nmt * c.mu_t / tsafe)
    eye = torch.eye(c.dim - 1, dtype=U.dtype, device=U.device)
    pmat = eye - v_hat[..., :, None] * v_hat[..., None, :]
    corner = hcone[..., 1:, 1:] + curv[..., None, None] * (
        c.v_scale[..., :, None] * pmat * c.v_scale[..., None, :])
    hcone = torch.cat([hcone[..., :1, :], torch.cat([hcone[..., 1:, :1], corner], dim=-1)],
                      dim=-2)
    out.append((torch.where(middle[..., None, None], hcone, 0.0), Jblk))
  return out


def _rescale(m: Model, value):
  return value / (env_rows(m, "stat.meaninertia") * max(1, m.nv))


def solve(m: Model, d: Data, fixed_iterations: bool = False) -> Data:
  """Solves for constrained qacc (mj_fwdConstraint, CG or Newton);
  ``fixed_iterations`` (or differentiable mode) runs the loops to their
  bounds without a host check."""
  dtype = d.qpos.dtype
  early_exit = EARLY_EXIT and not (fixed_iterations or get_diff_config() is not None)
  meta = _efc_meta(m)
  efc_J, efc_D, efc_aref = d.efc_J, d.efc_D, d.efc_aref
  efc_frictionloss = d.efc_frictionloss
  qfrc_smooth, qacc_smooth = d.qfrc_smooth, d.qacc_smooth
  efc_JT = efc_J.transpose(-1, -2)
  matvec = lambda a, x: (a @ x[..., None])[..., 0]
  cones = _cones(meta, efc_D, d.contact.friction)
  fric = (meta.nf, efc_D, efc_frictionloss) if meta.nf else None

  def update_constraint(qacc, Ma, Jaref):
    force, cost_c, quad = _row_costs(meta, cones, Jaref, efc_D, efc_frictionloss)
    gauss = 0.5 * _dot(Ma - qfrc_smooth, qacc - qacc_smooth)
    return force, gauss + cost_c, gauss, quad

  def gradient(Ma, force):
    return Ma - qfrc_smooth - matvec(efc_JT, force)

  # f32: regularize the Hessian so near-singular active sets stay
  # factorable (preconditioner only; the exact linesearch still minimizes
  # the true cost)
  reg = None if dtype == torch.float64 else 1e-6 * env_rows(m, "stat.meaninertia")[:, None, None]
  eye = torch.eye(m.nv, dtype=dtype, device=d.qpos.device)

  newton = m.opt.solver == SolverType.NEWTON

  def precond_grad(grad, quad, Jaref):
    if not newton:
      return smooth.solve_m(m, d, grad)
    Dq = efc_D * quad
    h = d.qM + (efc_JT * Dq[:, None, :]) @ efc_J
    if reg is not None:
      h = h + reg * eye
    # fold each group's K cone congruences Jblk' hcone Jblk into h: two
    # batched products a group, whatever its K
    for hcone, jblk in _cone_blocks(cones, efc_J, Jaref):
      B = jblk.shape[0]
      hj = (hcone @ jblk).reshape(B, -1, m.nv)
      h = h + jblk.reshape(B, -1, m.nv).transpose(-1, -2) @ hj
    return fused.chol_solve(h, grad)

  def linesearch(Ma, Jaref, search, gauss, running):
    """MuJoCo C's exact 3-point lo/hi bracket-swap linesearch (``running``:
    the envs whose result is kept)."""
    mv = matvec(d.qM, search)
    jv = matvec(efc_J, search)

    smag = math.safe_norm(search) * env_rows(m, "stat.meaninertia") * max(1, m.nv)
    gtol = env_rows(m, "opt.tolerance") * env_rows(m, "opt.ls_tolerance") * smag

    quad_gauss = torch.stack(
        [gauss, _dot(search, Ma - qfrc_smooth), 0.5 * _dot(search, mv)], dim=-1
    )
    quad = torch.stack([0.5 * Jaref * Jaref, jv * Jaref, 0.5 * jv * jv], dim=-1) * efc_D[..., None]

    ls_cones = _ls_cones(cones, jv)
    point = lambda a: _ls_point(quad_gauss, quad, Jaref, jv, a, fric, ls_cones, meta.ne)

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
      if early_exit and not bool((cont & running).any()):
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
    if early_exit and bool(ctx.done.all()):
      break
    loop_counts["iterations"] += 1
    # the expensive preconditioned gradient runs once per iteration
    mgrad = precond_grad(ctx.grad, ctx.quad, ctx.Jaref)
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
    tol = env_rows(m, "opt.tolerance")
    done = ctx.done | (improvement < tol) | (gradnorm < tol)
    new = new._replace(grad=grad, niter=ctx.niter + 1, done=done)
    # freeze finished envs (mjtpu's body does the same)
    ctx = _where(ctx.done, ctx, new)

  qfrc_constraint = matvec(efc_JT, ctx.efc_force)
  return replace(
      d, qacc=ctx.qacc, qacc_warmstart=ctx.qacc, qfrc_constraint=qfrc_constraint,
      efc_force=ctx.efc_force, solver_niter=ctx.niter,
  )
