"""Control-moment-gyroscope (CMG) math for the satellite envs, batched.

Port of mjtpu/zoo/cmg.py: Rodrigues rotation, the CMG cluster Jacobian,
the manipulability score and the 4-pyramid / 6-orthogonal cluster
geometries.  The cluster geometry is a constant (n, 3) pair of axes; the
gimbal angles carry the env axis B, so every function covers the batch in
one call.
"""

from __future__ import annotations

import numpy as np
import torch

from mjtpu_torch._src import math

# classic 4-CMG pyramid skew angle (cos(beta) = 1/sqrt(3))
PYRAMID_BETA = float(np.arccos(1.0 / np.sqrt(3.0)))


def rodrigues(v: torch.Tensor, axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
  """Rotates v (..., 3) about the unit axis (..., 3) by angle (...)
  (Rodrigues' formula)."""
  c, s = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
  return v * c + math.cross(axis, v) * s + axis * math.dot3(axis, v)[..., None] * (1.0 - c)


def _axes(g: np.ndarray, s: np.ndarray, dtype, device) -> tuple[torch.Tensor, torch.Tensor]:
  as_t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
  return as_t(g), as_t(s)


def pyramid_cluster(beta: float = PYRAMID_BETA, dtype=torch.float64, device="cpu"):
  """4-CMG pyramid geometry: (gimbal_axes (4, 3), spin_axes0 (4, 3)).

  Gimbal axes tilt by beta from the z-axis toward the four compass points;
  spin axes at zero gimbal angle are tangential."""
  phi = np.arange(4) * np.pi / 2.0
  g = np.stack([np.sin(beta) * np.cos(phi), np.sin(beta) * np.sin(phi),
                np.full(4, np.cos(beta))], axis=-1)
  s = np.stack([-np.sin(phi), np.cos(phi), np.zeros(4)], axis=-1)
  return _axes(g, s, dtype, device)


def ortho_cluster(dtype=torch.float64, device="cpu"):
  """6-CMG orthogonal cluster: gimbals along ±x/±y/±z pairs."""
  g = np.array([[1, 0, 0], [1, 0, 0], [0, 1, 0], [0, 1, 0], [0, 0, 1], [0, 0, 1]], np.float64)
  s = np.array([[0, 1, 0], [0, 0, 1], [0, 0, 1], [1, 0, 0], [1, 0, 0], [0, 1, 0]], np.float64)
  return _axes(g, s, dtype, device)


def spin_axes(gimbal_axes: torch.Tensor, spin_axes0: torch.Tensor,
              gimbal_angles: torch.Tensor) -> torch.Tensor:
  """(B, n, 3) spin axis of each CMG at the gimbal angles (B, n)."""
  return rodrigues(spin_axes0, gimbal_axes, gimbal_angles)


def cluster_jacobian(gimbal_axes: torch.Tensor, spin_axes0: torch.Tensor,
                     gimbal_angles: torch.Tensor, h0: float = 1.0) -> torch.Tensor:
  """(B, 3, n) torque Jacobian: column i = d(total angular momentum)/d(delta_i).

  h_i = h0 * spin_axis(delta_i); dh_i/ddelta_i = h0 * g_i x s_i(delta_i)."""
  s = spin_axes(gimbal_axes, spin_axes0, gimbal_angles)
  return (h0 * math.cross(gimbal_axes, s)).transpose(-1, -2)


def manipulability(jac: torch.Tensor) -> torch.Tensor:
  """(B,) singularity measure m = sqrt(det(J J^T)) of jac (B, 3, n), zero
  at gimbal lock; the 3x3 determinant written out."""
  a = jac @ jac.transpose(-1, -2)
  det = (a[..., 0, 0] * (a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1])
         - a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 0])
         + a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]))
  return torch.sqrt(torch.clamp_min(det, 0.0))


def momentum(gimbal_axes: torch.Tensor, spin_axes0: torch.Tensor,
             gimbal_angles: torch.Tensor, h0: float = 1.0) -> torch.Tensor:
  """(B, 3) total cluster angular momentum vector."""
  return h0 * torch.sum(spin_axes(gimbal_axes, spin_axes0, gimbal_angles), dim=-2)
