"""Batched dense Cholesky factor + solve: the Hopper kernel and its plain twin.

Port of mjtpu/ops/cholesky.py.  ``cholesky_solve(mat, rhs)`` solves
mat[b] @ x[b] = rhs[b] for a batch of SPD matrices with a pivot-clamped
Cholesky:

  * on a CUDA tensor it launches a hand-written kernel in
    ``mjtpu_torch/csrc/cholesky.cu``, built with ``nvcc`` for sm_90a at
    first use and bound with ctypes (``ops._build``).  Which one is a size
    dispatch (``variant``): an n in ``REGISTER_WIDTHS`` takes the
    ``register`` kernel (lane i keeps row i in registers, columns by warp
    shuffles; an instance for each such n); any other n takes the
    ``shared`` kernel (the first design: the matrix in shared memory), up
    to ``max_n``, past which it raises.  Both put one warp on
    an env, factor and both substitutions in one launch, and agree bit for
    bit.  A build or launch failure raises; nothing falls back.
  * on a CPU tensor it runs the plain twin ``chol_solve_reference``, the
    port of mjtpu's ``fused._base`` (math.safe_cholesky + cho_solve).

``CholSolve`` makes the solve differentiable on autograd, in every mode:
its forward is ``cholesky_solve``, and its backward for x = mat^-1 rhs is
one more ``cholesky_solve`` on (mat, x_bar), which gives rhs_bar, and the
outer product mat_bar = -rhs_bar x^T.  On a CPU tensor both passes run the
twin, so the CPU and the card take the same formula.

``launches`` counts kernel launches (never twin calls), the backward's
too, so a run can show that its main path went through the kernel;
``variant_launches`` counts them by variant.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mjtpu_torch._src import math
from mjtpu_torch.ops import _build

# kernel launches since import (CPU calls and twin calls do not count),
# in all and by variant
launches = 0
variant_launches = {"register": 0, "shared": 0}

SMEM_LIMIT = _build.SMEM_LIMIT
_WARPS_PER_BLOCK = 4
# the n the register kernel is instantiated for (csrc/cholesky.cu's
# MJTPU_CHOL_WIDTHS): the main paths' (the tendon scene and muscle.xml 2,
# the swimmer env 5, ant_bench 8, mocap.xml 12, the Ant env 14,
# humanoid_terrain 23, humanoid_bench 27) and the other zoo envs' (cartpole
# 2, hopper and the cylinder drop 6, walker2d and halfcheetah 9)
REGISTER_WIDTHS = (2, 5, 6, 8, 9, 12, 14, 23, 27)

SOURCE = "cholesky.cu"


def chol_solve_reference(h: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
  """Plain PyTorch twin: solves h @ x = g for a batch, h (B, n, n), g (B, n)."""
  return math.cho_solve(math.safe_cholesky(h), g)


@functools.lru_cache(maxsize=None)
def max_n(dtype: torch.dtype) -> int:
  """Largest n whose (n, n) matrix and (n,) vector fit one warp's share of
  a block's shared memory: the shared kernel's static bound, above which
  ``cholesky_solve`` raises on a CUDA tensor."""
  item = torch.empty((), dtype=dtype).element_size()
  n = 1
  while ((n + 1) * (n + 1) + (n + 1)) * item <= SMEM_LIMIT:
    n += 1
  return n


def variants(n: int, dtype: torch.dtype) -> tuple[str, ...]:
  """The kernels that can run an (n, n) system at dtype: the register
  kernel for an n in REGISTER_WIDTHS, the shared one for n <= max_n."""
  return tuple(kind for kind, fits in (("register", n in REGISTER_WIDTHS),
                                       ("shared", n <= max_n(dtype))) if fits)


def variant(n: int, dtype: torch.dtype) -> str:
  """The kernel an (n, n) system at dtype takes: the first of ``variants``;
  raises past every kernel's static bound."""
  kinds = variants(n, dtype)
  if not kinds:
    raise ValueError(f"n={n} exceeds the kernels' shared-memory bound {max_n(dtype)}")
  return kinds[0]


def smem_per_warp(n: int, dtype: torch.dtype, kind: str) -> int:
  """Shared memory one env takes: the register kernel's (n, n) matrix at
  an odd row stride, the shared kernel's matrix and right-hand side."""
  item = torch.empty((), dtype=dtype).element_size()
  return (n * (n | 1) if kind == "register" else n * n + n) * item


def launch_geometry(batch: int, n: int, dtype: torch.dtype, kind: str | None = None):
  """(variant, blocks, threads a block, envs a block) of one launch over
  ``batch`` envs, of ``kind`` or else of ``variant(n, dtype)``: one warp an
  env, 4 warps a block (the shared kernel fewer where one env's matrix
  leaves less room)."""
  kind = kind or variant(n, dtype)
  per = _WARPS_PER_BLOCK
  if kind == "shared":
    per = max(1, min(per, SMEM_LIMIT // smem_per_warp(n, dtype, kind)))
  return kind, -(-batch // per), 32 * per, per


# (mat, rhs, out, batch, n[, warps a block], stream): the shared kernel
# also takes its warps a block
SIGNATURES = {
    f"mjtpu_chol_{kind}_{suffix}": ([ctypes.c_void_p] * 3 + [ctypes.c_int] * ints
                                    + [ctypes.c_void_p], ctypes.c_int)
    for kind, ints in (("register", 2), ("shared", 3)) for suffix in ("f32", "f64")
}


def library() -> ctypes.CDLL:
  """Builds (at first use) and loads the kernel library."""
  return _build.library(SOURCE, (), SIGNATURES)


def _check(mat: torch.Tensor, rhs: torch.Tensor) -> None:
  if mat.dtype not in (torch.float32, torch.float64) or rhs.dtype != mat.dtype:
    raise TypeError(f"cholesky_solve takes float32 or float64, got {mat.dtype} and {rhs.dtype}")
  if mat.dim() != 3 or rhs.dim() != 2 or mat.shape[1] != mat.shape[2] \
      or mat.shape[:2] != rhs.shape:
    raise ValueError(
        f"cholesky_solve takes mat (B, n, n) and rhs (B, n), got {tuple(mat.shape)}"
        f" and {tuple(rhs.shape)}"
    )
  if mat.device != rhs.device:
    raise ValueError(f"mat on {mat.device}, rhs on {rhs.device}")


def cholesky_solve(mat: torch.Tensor, rhs: torch.Tensor, *,
                   kernel: str | None = None) -> torch.Tensor:
  """Solves mat @ x = rhs for a batch: mat (B, n, n) SPD, rhs (B, n).
  ``kernel`` names the variant to launch ("register" or "shared"; a
  test's choice, to hold both to the twin); None takes ``variant``."""
  global launches
  _check(mat, rhs)
  n = rhs.shape[1]
  if kernel is not None and kernel not in variants(n, mat.dtype):
    raise ValueError(f"no {kernel!r} Cholesky kernel for n={n}")
  if mat.device.type == "cpu":
    return chol_solve_reference(mat, rhs)
  if mat.device.type != "cuda":
    raise ValueError(f"cholesky_solve runs on cuda or cpu, not {mat.device}")
  if not (mat.is_contiguous() and rhs.is_contiguous()):
    raise ValueError("cholesky_solve takes contiguous tensors")
  kind, _, _, warps = launch_geometry(rhs.shape[0], n, mat.dtype, kernel)
  out = torch.empty_like(rhs)
  if rhs.shape[0] == 0 or n == 0:
    return out
  lib = library()
  fn = getattr(lib, f"mjtpu_chol_{kind}_{'f64' if mat.dtype == torch.float64 else 'f32'}")
  shape = (rhs.shape[0], n) if kind == "register" else (rhs.shape[0], n, warps)
  with torch.cuda.device(mat.device):
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(mat.data_ptr(), rhs.data_ptr(), out.data_ptr(), *shape, stream)
  _build.check_launch(lib, err, f"cholesky ({kind})")
  launches += 1
  variant_launches[kind] += 1
  return out


class CholSolve(torch.autograd.Function):
  """x = mat^-1 rhs for SPD mat (B, n, n) and rhs (B, n), with the
  analytic backward: rhs_bar = mat^-1 x_bar (the same kernel once more:
  mat is symmetric) and mat_bar = -rhs_bar x^T.  The kernel reads one
  triangle of mat; the gradient is that of a symmetric mat, so it equals
  autodiff's through the plain factor wherever no pivot is clamped,
  summed over the two entries that every symmetric construction of mat
  ties together."""

  @staticmethod
  def forward(ctx, mat, rhs):
    x = cholesky_solve(mat, rhs)
    ctx.save_for_backward(mat, x)
    return x

  @staticmethod
  @torch.autograd.function.once_differentiable
  def backward(ctx, x_bar):
    mat, x = ctx.saved_tensors
    rhs_bar = cholesky_solve(mat, x_bar.contiguous())
    mat_bar = -rhs_bar[:, :, None] * x[:, None, :] if ctx.needs_input_grad[0] else None
    return mat_bar, rhs_bar
