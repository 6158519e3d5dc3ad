"""Engine bridges to the fused Cholesky and the tree-sparse LDL kernels.

Port of mjtpu/ops/fused.py's ``chol_solve`` and ``ldl_*`` seams.  mjtpu
writes the engine per env and dispatches vmapped batches to its Pallas
kernels from ``custom_vmap`` rules; the port is batch-explicit, so each
seam is a plain function over the batch, and always calls the kernel's
wrapper (``ops.cholesky``, ``ops.ldl``), which launches the Hopper kernel
for a CUDA tensor and runs the plain twin for a CPU tensor.  Every seam
is differentiable on autograd, in every mode, with the kernel in its
forward: ``cholesky.CholSolve``, ``ldl.LdlFactorSolve`` and
``ldl.LdlSolve`` launch it once more in their backward, and the factor's
backward is its twin's (``ldl.ldl_factor_differentiable``).  The only
gates are the wrappers' static shared-memory bounds: on the card a larger
problem raises.  mjtpu's TPU gates (its nv >= 40 LDL threshold and VMEM
checks, measured on a TPU) are not carried over.
"""

from __future__ import annotations

import torch

from mjtpu_torch._src import sparse
from mjtpu_torch.ops import cholesky, ldl


def chol_solve(h: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
  """Solves h @ x = g per env: h (B, n, n) SPD, g (B, n); differentiable
  (``cholesky.CholSolve``)."""
  return cholesky.CholSolve.apply(h.contiguous(), g.contiguous())


def ldl_factor(t: sparse.Tables, M: torch.Tensor) -> torch.Tensor:
  """Compact tree-sparse LDL factors (B, nv, depth) of chain-pattern
  matrices M (B, nv, nv)."""
  return ldl.ldl_factor_differentiable(t, sparse.gather_compact(t, M).contiguous())


def ldl_solve(t: sparse.Tables, S: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Solves M x = b (B, nv) from compact factors S (B, nv, depth)."""
  return ldl.LdlSolve.apply(t, S.contiguous(), b.contiguous())


def ldl_factor_solve(t: sparse.Tables, M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Factors chain-pattern matrices M (B, nv, nv) and solves M x = b (B,
  nv) in one launch (the implicit-damping solve)."""
  return ldl.LdlFactorSolve.apply(t, sparse.gather_compact(t, M).contiguous(), b.contiguous())
