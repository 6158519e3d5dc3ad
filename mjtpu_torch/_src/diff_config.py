"""Differentiable-simulation configuration.

Port of mjtpu/_src/diff_config.py.  ``differentiable_mode()`` makes a
step reverse-differentiable on autograd: the solver runs its fixed
iteration counts with converged envs frozen (no host check inside its
loops), contacts activate by distance with a straight-through estimator
(``cfd``), the colliders blend their case switches with a sigmoid
(``smooth_collisions``), the step may split into equal substeps
(``adaptive_integration``).  The kernels stay on the path: their seams
are differentiable in every mode (``ops.fused``, ``ops.sat``,
``ops.hfield``).  mjtpu reads the config at trace time; the
port runs eagerly, so every function reads it at each call.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading


@dataclasses.dataclass(frozen=True)
class DiffConfig:
  """Differentiable-mode parameters (mjtpu's DiffConfig, same defaults)."""

  smooth_collisions: bool = True
  smooth_sharpness: float = 100.0   # sigmoid sharpness for case blending
  cfd: bool = True                  # contacts-from-distance
  cfd_width: float = 0.01           # activation distance
  cfd_dc: float = 0.003             # softplus curvature scale
  adaptive_integration: bool = False
  adaptive_substeps: int = 4


_local = threading.local()


def get_diff_config() -> DiffConfig | None:
  """The active DiffConfig, or None outside differentiable mode."""
  return getattr(_local, "config", None)


def smooth_k() -> float | None:
  """The sigmoid sharpness of the colliders' case blending, or None outside
  differentiable mode with smooth_collisions.  The blends keep a contact's
  dist, normal and position differentiable across a case switch (face or
  edge winner, inside or outside); the count of manifold points stays
  discrete, and contacts from distance soften their activation."""
  dc = get_diff_config()
  if dc is not None and dc.smooth_collisions:
    return dc.smooth_sharpness
  return None


@contextlib.contextmanager
def differentiable_mode(config: DiffConfig | None = None, **kwargs):
  """Enables differentiable simulation for the calls made inside the block
  (this thread only)."""
  cfg = config or DiffConfig(**kwargs)
  prev = get_diff_config()
  _local.config = cfg
  try:
    yield cfg
  finally:
    _local.config = prev
