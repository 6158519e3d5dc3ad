"""Engine bridge to the fused Cholesky factor+solve kernel.

Port of mjtpu/ops/fused.py's ``chol_solve`` seam.  mjtpu writes the engine
per env and dispatches vmapped batches to its Pallas kernel from a
``custom_vmap`` rule; the port is batch-explicit, so the seam is a plain
function over (B, n, n) and (B, n).  ``ops.cholesky.cholesky_solve`` then
launches the Hopper kernel for a CUDA tensor and runs the plain twin for a
CPU tensor.  Its only gate is the static bound on n that the kernel's
shared memory sets: on the card a larger n raises.
"""

from __future__ import annotations

import torch

from mjtpu_torch.ops import cholesky


def chol_solve(h: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
  """Solves h @ x = g per env: h (B, n, n) SPD, g (B, n)."""
  return cholesky.cholesky_solve(h.contiguous(), g.contiguous())
