"""Batched tree-sparse LDLᵀ factor and solve: the Hopper kernel and its plain twins.

Port of mjtpu/ops/ldl.py (``ldl_factor``, ``ldl_solve`` and
``ldl_factor_solve``, the Pallas kernels behind mjtpu.ops.fused's LDL
seams), following mjtpu's jnp path ``sparse.factor`` / ``sparse.solve``,
which made the f64 goldens.  Matrices come in the compact (B, nv, depth)
layout of ``_src/sparse.py`` (``sparse.gather_compact``); ``t`` is the
tree's ``sparse.Tables`` (``sparse.tables(m)`` for a Model).

  * ``ldl_factor(t, Mc)`` -> compact factors S (B, nv, depth);
  * ``ldl_solve(t, S, rhs)`` -> x (B, nv) with M x = rhs;
  * ``ldl_factor_solve(t, Mc, rhs)`` -> x, the factor kept in shared
    memory between the factor and the solve: one launch.

On a CUDA tensor each launches a hand-written kernel in
``mjtpu_torch/csrc/ldl.cu``, built with nvcc for sm_90a and
``--fmad=false`` at first use and bound with ctypes (``ops._build``).
Which one is a size dispatch (``variant``): a tree whose shared block
fits the lane schedule's byte-offset fields (``sparse.lanes_fit``: at most
32 KB an env, every tree of the port) takes the ``lanes`` kernel (the
schedule dealt to a warp's lanes on the host and read lane-major, one
64-bit word an update); any other takes the ``shared`` kernel (the first
design: lanes striding over each round's targets).  Both hold one env a
warp, its compact factor in the warp's shared memory.  A build or launch
failure, a tree whose compact factor does not fit one warp's share of a
block's shared memory (the static bound, ``smem_per_warp``), or tensors of
another dtype than the tables' (``Tables.dtype``: the lane schedule's
offsets are in bytes of its entries), raises; nothing falls back.  On a
CPU tensor each runs its plain twin (``*_reference``, built on
``_src/sparse.py``), which sums in the kernels' order: all agree bit for
bit.

The wrappers have no backward: on the card they raise on an input that
requires grad while grad mode is on (``_build.refuse_grad``).  The
engine's seams (``ops.fused``) take them through autograd Functions with
the kernel forward: ``LdlFactorSolve`` (backward: the kernel once more
and the outer product on the tree's pattern), ``LdlSolve`` (backward: the
kernel once more, and the factors' gradient by the twin) and
``ldl_factor_differentiable`` (the twin's gradient, ``_build.TwinGrad``).

``launches`` counts kernel launches per entry point (never twin calls),
the backward's too, ``variant_launches`` per entry point and variant.
"""

from __future__ import annotations

import ctypes

import torch

from mjtpu_torch._src import sparse
from mjtpu_torch.ops import _build

ENTRIES = ("ldl_factor", "ldl_solve", "ldl_factor_solve")
KINDS = ("lanes", "shared")
# kernel launches since import, per entry point and per entry point and
# variant (CPU calls and twin calls do not count)
launches = dict.fromkeys(ENTRIES, 0)
variant_launches = {entry: dict.fromkeys(KINDS, 0) for entry in ENTRIES}

SOURCE = "ldl.cu"
EXTRA_FLAGS = ("--fmad=false",)
SMEM_LIMIT = _build.SMEM_LIMIT
_MAX_WARPS_PER_BLOCK = 8
_MODES = {"ldl_factor": 1, "ldl_solve": 2, "ldl_factor_solve": 3}


def smem_per_warp(nv: int, depth: int, dtype: torch.dtype, kind: str = "shared") -> int:
  """Shared memory one env takes: its compact factor and its right-hand
  side, and for the lanes kernel the factor's rows at an odd stride and
  the L solve's partial sums.  The kernels' static bound: it must fit a
  block's shared memory."""
  entries = sparse.lane_block(nv, depth) if kind == "lanes" else nv * depth + nv
  return entries * torch.empty((), dtype=dtype).element_size()


def variants(t: sparse.Tables, dtype: torch.dtype) -> tuple[str, ...]:
  """The kernels that can run the tree t at dtype: the lanes kernel where
  its schedule was built for dtype (its byte offsets fit their fields at
  that entry size), the shared one; each where one env's block fits a
  block's shared memory."""
  fits = lambda kind: smem_per_warp(t.nv, t.depth, dtype, kind) <= SMEM_LIMIT
  lanes = t.lanes is not None and dtype == t.dtype
  return tuple(kind for kind in KINDS if fits(kind) and (kind != "lanes" or lanes))


def variant(t: sparse.Tables, dtype: torch.dtype) -> str:
  """The kernel the tree t takes at dtype: the first of ``variants``."""
  kinds = variants(t, dtype)
  if not kinds:
    raise ValueError(
        f"a tree of nv={t.nv}, depth={t.depth} needs"
        f" {smem_per_warp(t.nv, t.depth, dtype)} bytes of shared memory per env, past the"
        f" kernels' static bound of {SMEM_LIMIT} a block")
  return kinds[0]


def launch_geometry(batch: int, t: sparse.Tables, dtype: torch.dtype, kind: str | None = None):
  """(variant, blocks, threads a block, envs a block) of one launch over
  ``batch`` envs, of ``kind`` or else of ``variant(t, dtype)``: one warp
  an env, as many warps a block as its shared memory allows, up to 8."""
  kind = kind or variant(t, dtype)
  per = max(1, min(_MAX_WARPS_PER_BLOCK,
                   SMEM_LIMIT // smem_per_warp(t.nv, t.depth, dtype, kind)))
  return kind, -(-batch // per), 32 * per, per


def ldl_factor_reference(t: sparse.Tables, Mc: torch.Tensor) -> torch.Tensor:
  """Plain PyTorch twin of ``ldl_factor``."""
  return sparse.factor(t, Mc)


def ldl_solve_reference(t: sparse.Tables, S: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
  """Plain PyTorch twin of ``ldl_solve``."""
  return sparse.solve(t, S, rhs)


def ldl_factor_solve_reference(t: sparse.Tables, Mc: torch.Tensor,
                               rhs: torch.Tensor) -> torch.Tensor:
  """Plain PyTorch twin of ``ldl_factor_solve``."""
  return sparse.solve(t, sparse.factor(t, Mc), rhs)


SIGNATURES = {
    f"mjtpu_ldl_{kind}_{suffix}": (
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
        ctypes.c_int)
    for kind in KINDS for suffix in ("f32", "f64")
}


def library() -> ctypes.CDLL:
  """Builds (at first use) and loads the kernel library."""
  return _build.library(SOURCE, EXTRA_FLAGS, SIGNATURES)


def _check(name: str, t: sparse.Tables, mat: torch.Tensor, rhs: torch.Tensor | None) -> None:
  if mat.dtype not in (torch.float32, torch.float64) or (
      rhs is not None and rhs.dtype != mat.dtype):
    raise TypeError(f"{name} takes float32 or float64 tensors of one dtype")
  if mat.dtype != t.dtype:
    # the lane schedule's byte offsets are in the entry size of t.dtype
    raise TypeError(f"{name} takes {t.dtype} tensors, the dtype its tables were built for,"
                    f" not {mat.dtype}")
  batch = mat.shape[0] if mat.dim() == 3 else -1
  if tuple(mat.shape) != (batch, t.nv, t.depth) or (
      rhs is not None and tuple(rhs.shape) != (batch, t.nv)):
    raise ValueError(
        f"{name} takes a compact (B, {t.nv}, {t.depth}) matrix and a (B, {t.nv}) right-hand"
        f" side, got {tuple(mat.shape)} and {None if rhs is None else tuple(rhs.shape)}")
  if (rhs is not None and rhs.device != mat.device) or t.sched.device != mat.device:
    raise ValueError(f"{name} takes tensors and tables on one device")


def _run(name: str, t: sparse.Tables, mat: torch.Tensor, rhs: torch.Tensor | None,
         reference, kernel: str | None) -> torch.Tensor:
  _check(name, t, mat, rhs)
  if kernel is not None and kernel not in variants(t, mat.dtype):
    raise ValueError(f"no {kernel!r} LDL kernel for a tree of nv={t.nv}, depth={t.depth}")
  if mat.device.type == "cpu":
    return reference()
  if mat.device.type != "cuda":
    raise ValueError(f"{name} runs on cuda or cpu, not {mat.device}")
  _build.refuse_grad(name, mat, rhs)
  if not (mat.is_contiguous() and (rhs is None or rhs.is_contiguous())):
    raise ValueError(f"{name} takes contiguous tensors")
  kind, _, _, warps = launch_geometry(mat.shape[0], t, mat.dtype, kernel)
  out = torch.empty_like(mat if name == "ldl_factor" else rhs)
  if mat.shape[0] == 0:
    return out
  lib = library()
  fn = getattr(lib, f"mjtpu_ldl_{kind}_{'f64' if mat.dtype == torch.float64 else 'f32'}")
  sched = t.lanes if kind == "lanes" else t.sched
  with torch.cuda.device(mat.device):
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(_MODES[name], mat.data_ptr(), None if rhs is None else rhs.data_ptr(),
             out.data_ptr(), sched.data_ptr(), mat.shape[0], t.nv, t.depth, warps, stream)
  _build.check_launch(lib, err, f"{name} ({kind})")
  launches[name] += 1
  variant_launches[name][kind] += 1
  return out


def ldl_factor(t: sparse.Tables, Mc: torch.Tensor, *, kernel: str | None = None) -> torch.Tensor:
  """Compact factors (B, nv, depth) of compact matrices Mc (B, nv, depth).
  ``kernel`` names the variant to launch ("lanes" or "shared"; a test's
  choice, to hold both to the twin); None takes ``variant``."""
  return _run("ldl_factor", t, Mc, None, lambda: ldl_factor_reference(t, Mc), kernel)


def ldl_solve(t: sparse.Tables, S: torch.Tensor, rhs: torch.Tensor, *,
              kernel: str | None = None) -> torch.Tensor:
  """Solves M x = rhs (B, nv) from compact factors S (B, nv, depth)."""
  return _run("ldl_solve", t, S, rhs, lambda: ldl_solve_reference(t, S, rhs), kernel)


def ldl_factor_solve(t: sparse.Tables, Mc: torch.Tensor, rhs: torch.Tensor, *,
                     kernel: str | None = None) -> torch.Tensor:
  """Factors Mc (B, nv, depth) and solves M x = rhs (B, nv) in one launch."""
  return _run("ldl_factor_solve", t, Mc, rhs, lambda: ldl_factor_solve_reference(t, Mc, rhs),
              kernel)


def _pattern_outer(t: sparse.Tables, rhs_bar: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
  """The gradient of x = M^-1 rhs with respect to the compact entries Mc
  (B, nv, depth) of a symmetric M, given rhs_bar = M^-1 x_bar: -(rhs_bar_i
  x_j + rhs_bar_j x_i) at an off-diagonal entry (i, ancestor j), which
  stands for both M[i, j] and M[j, i], -rhs_bar_i x_i on the diagonal, 0
  at the pad entries."""
  B = x.shape[0]
  rows, anc = t.gather // t.nv, t.gather % t.nv
  off = (anc != rows).to(x.dtype)
  g = rhs_bar[:, rows] * x[:, anc] + off * rhs_bar[:, anc] * x[:, rows]
  return (-g * t.mask).reshape(B, t.nv, t.depth)


class LdlFactorSolve(torch.autograd.Function):
  """x = M^-1 rhs from compact Mc (B, nv, depth) and rhs (B, nv), with the
  analytic backward: rhs_bar = M^-1 x_bar (the same kernel once more: M is
  symmetric) and Mc_bar from -rhs_bar x^T on the tree's pattern
  (``_pattern_outer``).  It equals autodiff through the twin wherever no
  pivot is floored.  On a CPU tensor both passes run the twin."""

  @staticmethod
  def forward(ctx, t, Mc, rhs):
    x = ldl_factor_solve(t, Mc, rhs)
    ctx.t = t
    ctx.save_for_backward(Mc, x)
    return x

  @staticmethod
  @torch.autograd.function.once_differentiable
  def backward(ctx, x_bar):
    Mc, x = ctx.saved_tensors
    rhs_bar = ldl_factor_solve(ctx.t, Mc, x_bar.contiguous())
    Mc_bar = _pattern_outer(ctx.t, rhs_bar, x) if ctx.needs_input_grad[1] else None
    return None, Mc_bar, rhs_bar


class LdlSolve(torch.autograd.Function):
  """x = M^-1 rhs from compact factors S (B, nv, depth) and rhs (B, nv):
  the backward's rhs_bar = M^-1 x_bar is the same kernel once more; S_bar,
  where S requires grad, is the twin's (``sparse.solve`` run again under
  grad mode).  On a CPU tensor both passes run the twin."""

  @staticmethod
  def forward(ctx, t, S, rhs):
    x = ldl_solve(t, S, rhs)
    ctx.t = t
    ctx.save_for_backward(S, rhs)
    return x

  @staticmethod
  @torch.autograd.function.once_differentiable
  def backward(ctx, x_bar):
    S, rhs = ctx.saved_tensors
    x_bar = x_bar.contiguous()
    rhs_bar = ldl_solve(ctx.t, S, x_bar)
    S_bar = None
    if ctx.needs_input_grad[1]:
      with torch.enable_grad():
        s = S.detach().requires_grad_(True)
        S_bar, = torch.autograd.grad(ldl_solve_reference(ctx.t, s, rhs), s, x_bar)
    return None, S_bar, rhs_bar


def ldl_factor_differentiable(t: sparse.Tables, Mc: torch.Tensor) -> torch.Tensor:
  """``ldl_factor`` with a backward (``_build.TwinGrad``): the kernel's
  factors forward, the twin's gradient backward."""
  return _build.TwinGrad.apply(lambda mc: ldl_factor(t, mc),
                               lambda mc: ldl_factor_reference(t, mc), Mc)
