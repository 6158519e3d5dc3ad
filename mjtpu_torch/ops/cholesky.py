"""Batched dense Cholesky factor + solve: the Hopper kernel and its plain twin.

Port of mjtpu/ops/cholesky.py.  ``cholesky_solve(mat, rhs)`` solves
mat[b] @ x[b] = rhs[b] for a batch of SPD matrices with a pivot-clamped
Cholesky:

  * on a CUDA tensor it launches the hand-written kernel in
    ``mjtpu_torch/csrc/cholesky.cu`` (one warp per env, factor and both
    substitutions in one shared-memory residency), built with ``nvcc`` for
    sm_90a at first use and bound with ctypes (``ops._build``).  A build or
    launch failure raises; nothing falls back.
  * on a CPU tensor it runs the plain twin ``chol_solve_reference``, the
    port of mjtpu's ``fused._base`` (math.safe_cholesky + cho_solve).

``launches`` counts kernel launches (never twin calls), so a run can show
that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mjtpu_torch._src import math
from mjtpu_torch.ops import _build

# kernel launches since import (CPU calls and twin calls do not count)
launches = 0

SMEM_LIMIT = _build.SMEM_LIMIT
_WARPS_PER_BLOCK = 4

SOURCE = "cholesky.cu"


def chol_solve_reference(h: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
  """Plain PyTorch twin: solves h @ x = g for a batch, h (B, n, n), g (B, n)."""
  return math.cho_solve(math.safe_cholesky(h), g)


@functools.lru_cache(maxsize=None)
def max_n(dtype: torch.dtype) -> int:
  """Largest n whose (n, n) matrix and (n,) vector fit one warp's share of
  a block's shared memory: the kernel's static bound, above which
  ``cholesky_solve`` raises on a CUDA tensor."""
  item = torch.empty((), dtype=dtype).element_size()
  n = 1
  while ((n + 1) * (n + 1) + (n + 1)) * item <= SMEM_LIMIT:
    n += 1
  return n


_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
SIGNATURES = {name: (_ARGTYPES, ctypes.c_int)
              for name in ("mjtpu_chol_solve_f32", "mjtpu_chol_solve_f64")}


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


def cholesky_solve(mat: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
  """Solves mat @ x = rhs for a batch: mat (B, n, n) SPD, rhs (B, n)."""
  global launches
  _check(mat, rhs)
  if mat.device.type == "cpu":
    return chol_solve_reference(mat, rhs)
  if mat.device.type != "cuda":
    raise ValueError(f"cholesky_solve runs on cuda or cpu, not {mat.device}")
  if not (mat.is_contiguous() and rhs.is_contiguous()):
    raise ValueError("cholesky_solve takes contiguous tensors")
  batch, n = rhs.shape
  if n > max_n(mat.dtype):
    raise ValueError(f"n={n} exceeds the kernel's shared-memory bound {max_n(mat.dtype)}")
  out = torch.empty_like(rhs)
  if batch == 0 or n == 0:
    return out
  lib = library()
  per_warp = (n * n + n) * mat.element_size()
  warps = max(1, min(_WARPS_PER_BLOCK, SMEM_LIMIT // per_warp))
  fn = lib.mjtpu_chol_solve_f64 if mat.dtype == torch.float64 else lib.mjtpu_chol_solve_f32
  with torch.cuda.device(mat.device):
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(mat.data_ptr(), rhs.data_ptr(), out.data_ptr(), batch, n, warps, stream)
  _build.check_launch(lib, err, "cholesky")
  launches += 1
  return out
