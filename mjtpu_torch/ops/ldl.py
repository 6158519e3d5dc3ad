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

On a CUDA tensor each launches the hand-written kernel in
``mjtpu_torch/csrc/ldl.cu`` (one warp per env, the compact factor in the
warp's shared memory, lanes striding over each round's targets), built
with nvcc for sm_90a and ``--fmad=false`` at first use and bound with
ctypes (``ops._build``).  A build or launch failure, or a tree whose
compact factor does not fit one warp's share of a block's shared memory
(the kernel's static bound, ``smem_per_warp``), raises; nothing falls back.  On a
CPU tensor each runs its plain twin (``*_reference``, built on
``_src/sparse.py``), which sums in the kernel's order: the two agree bit
for bit.

``launches`` counts kernel launches per entry point (never twin calls).
"""

from __future__ import annotations

import ctypes

import torch

from mjtpu_torch._src import sparse
from mjtpu_torch.ops import _build

# kernel launches since import, per entry point (CPU calls and twin calls
# do not count)
launches = {"ldl_factor": 0, "ldl_solve": 0, "ldl_factor_solve": 0}

SOURCE = "ldl.cu"
EXTRA_FLAGS = ("--fmad=false",)
SMEM_LIMIT = _build.SMEM_LIMIT
_MAX_WARPS_PER_BLOCK = 8
_MODES = {"ldl_factor": 1, "ldl_solve": 2, "ldl_factor_solve": 3}


def smem_per_warp(nv: int, depth: int, dtype: torch.dtype) -> int:
  """Shared memory one env takes: its compact factor and its right-hand
  side.  The kernel's static bound: it must fit a block's shared memory."""
  return (nv * depth + nv) * torch.empty((), dtype=dtype).element_size()


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
    name: ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
           ctypes.c_int)
    for name in ("mjtpu_ldl_f32", "mjtpu_ldl_f64")
}


def library() -> ctypes.CDLL:
  """Builds (at first use) and loads the kernel library."""
  return _build.library(SOURCE, EXTRA_FLAGS, SIGNATURES)


def _check(name: str, t: sparse.Tables, mat: torch.Tensor, rhs: torch.Tensor | None) -> None:
  if mat.dtype not in (torch.float32, torch.float64) or (
      rhs is not None and rhs.dtype != mat.dtype):
    raise TypeError(f"{name} takes float32 or float64 tensors of one dtype")
  batch = mat.shape[0] if mat.dim() == 3 else -1
  if tuple(mat.shape) != (batch, t.nv, t.depth) or (
      rhs is not None and tuple(rhs.shape) != (batch, t.nv)):
    raise ValueError(
        f"{name} takes a compact (B, {t.nv}, {t.depth}) matrix and a (B, {t.nv}) right-hand"
        f" side, got {tuple(mat.shape)} and {None if rhs is None else tuple(rhs.shape)}")
  if (rhs is not None and rhs.device != mat.device) or t.sched.device != mat.device:
    raise ValueError(f"{name} takes tensors and tables on one device")


def _run(name: str, t: sparse.Tables, mat: torch.Tensor, rhs: torch.Tensor | None,
         reference) -> torch.Tensor:
  _check(name, t, mat, rhs)
  if mat.device.type == "cpu":
    return reference()
  if mat.device.type != "cuda":
    raise ValueError(f"{name} runs on cuda or cpu, not {mat.device}")
  if not (mat.is_contiguous() and (rhs is None or rhs.is_contiguous())):
    raise ValueError(f"{name} takes contiguous tensors")
  per_warp = smem_per_warp(t.nv, t.depth, mat.dtype)
  if per_warp > SMEM_LIMIT:
    raise ValueError(
        f"a tree of nv={t.nv}, depth={t.depth} needs {per_warp} bytes of shared memory per env,"
        f" past the kernel's static bound of {SMEM_LIMIT} a block")
  batch = mat.shape[0]
  out = torch.empty_like(mat if name == "ldl_factor" else rhs)
  if batch == 0:
    return out
  lib = library()
  warps = max(1, min(_MAX_WARPS_PER_BLOCK, SMEM_LIMIT // per_warp))
  fn = lib.mjtpu_ldl_f64 if mat.dtype == torch.float64 else lib.mjtpu_ldl_f32
  with torch.cuda.device(mat.device):
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(_MODES[name], mat.data_ptr(), None if rhs is None else rhs.data_ptr(),
             out.data_ptr(), t.sched.data_ptr(), batch, t.nv, t.depth, warps, stream)
  _build.check_launch(lib, err, name)
  launches[name] += 1
  return out


def ldl_factor(t: sparse.Tables, Mc: torch.Tensor) -> torch.Tensor:
  """Compact factors (B, nv, depth) of compact matrices Mc (B, nv, depth)."""
  return _run("ldl_factor", t, Mc, None, lambda: ldl_factor_reference(t, Mc))


def ldl_solve(t: sparse.Tables, S: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
  """Solves M x = rhs (B, nv) from compact factors S (B, nv, depth)."""
  return _run("ldl_solve", t, S, rhs, lambda: ldl_solve_reference(t, S, rhs))


def ldl_factor_solve(t: sparse.Tables, Mc: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
  """Factors Mc (B, nv, depth) and solves M x = rhs (B, nv) in one launch."""
  return _run("ldl_factor_solve", t, Mc, rhs, lambda: ldl_factor_solve_reference(t, Mc, rhs))
