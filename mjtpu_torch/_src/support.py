"""Support functions: constraint counting, Jacobians, applied forces.

Port of mjtpu/_src/support.py (the slice's part).  Sizes are host functions
of the Model's static fields, cached per Model.
"""

from __future__ import annotations

import numpy as np
import torch

from mjtpu_torch._src import math
from mjtpu_torch._src.types import (
    ConeType,
    ConstraintType,
    Data,
    DisableBit,
    JointType,
    Model,
    cached,
    index,
)

# ---------------------------------------------------------------------------
# constraint sizes (host, static)
# ---------------------------------------------------------------------------


def count_constraints(m: Model) -> tuple[int, int, int, int]:
  """(ne, nf, nl, nefc): static row counts.  The slice has no equality
  constraints, no frictionloss and no tendons (put_model refuses them), so
  ne = nf = 0 and the limit rows are those of scalar joints."""

  def build():
    if m.opt.disableflags & DisableBit.CONSTRAINT:
      return 0, 0, 0, 0
    nl = 0
    if not (m.opt.disableflags & DisableBit.LIMIT):
      jt = np.asarray(m.jnt_type)
      lim = np.asarray(m.jnt_limited).astype(bool)
      scalar = lim & np.isin(jt, (int(JointType.SLIDE), int(JointType.HINGE)))
      two = np.asarray(m.jnt_limit_two_sided)
      nl = int((scalar & two).sum() * 2 + (scalar & ~two).sum())

    from mjtpu_torch._src import collision_driver

    ncon_rows = 0
    for condim, count in collision_driver.condim_counts(m).items():
      if m.opt.cone == ConeType.PYRAMIDAL:
        rows = 1 if condim == 1 else (condim - 1) * 2
      else:
        rows = condim
      ncon_rows += rows * count
    return 0, 0, nl, nl + ncon_rows

  return cached(m, "support.count_constraints", build)


def constraint_sizes(m: Model) -> tuple[int, int, int, int, int]:
  """(ne, nf, nl, ncon, nefc) — mjtpu's constraint_sizes tuple."""
  from mjtpu_torch._src import collision_driver

  ne, nf, nl, nefc = count_constraints(m)
  return ne, nf, nl, collision_driver.ncon(m), nefc


def efc_row_meta(m: Model) -> tuple[np.ndarray, np.ndarray]:
  """Static (efc_type, efc_id) labels for every row of the fixed efc layout
  (limits, then contacts), as in mjtpu's support.efc_row_meta."""

  def build():
    from mjtpu_torch._src import collision_driver

    ne, nf, nl, nefc = count_constraints(m)
    types = np.zeros(nefc, np.int32)
    ids = np.zeros(nefc, np.int32)
    r = 0
    if nl:
      jt = np.asarray(m.jnt_type)
      two = np.asarray(m.jnt_limit_two_sided).astype(bool)
      for j in np.nonzero(np.asarray(m.jnt_limited))[0]:
        scalar = jt[j] in (int(JointType.SLIDE), int(JointType.HINGE))
        n = 2 if (scalar and two[j]) else 1
        types[r : r + n] = int(ConstraintType.LIMIT_JOINT)
        ids[r : r + n] = j
        r += n
    if r != ne + nf + nl:
      raise AssertionError((r, ne, nf, nl))

    dims = collision_driver.make_condim(m)
    addr = collision_driver.contact_efc_address(m, ne, nf, nl)
    pyramidal = m.opt.cone == ConeType.PYRAMIDAL
    for c, (a, dim) in enumerate(zip(addr, dims)):
      if dim == 1:
        t, n = int(ConstraintType.CONTACT_FRICTIONLESS), 1
      elif pyramidal:
        t, n = int(ConstraintType.CONTACT_PYRAMIDAL), 2 * (dim - 1)
      else:
        t, n = int(ConstraintType.CONTACT_ELLIPTIC), dim
      types[a : a + n] = t
      ids[a : a + n] = c
    return types, ids

  return cached(m, "support.efc_row_meta", build)


# ---------------------------------------------------------------------------
# kinematic-chain masks (host, static)
# ---------------------------------------------------------------------------


def dof_ancestor_mask(m: Model) -> np.ndarray:
  """(nbody, nv) 0/1 mask: dof i moves body b's frame (b or an ancestor of
  b owns dof i)."""

  def build():
    mask = np.zeros((m.nbody, m.nv), dtype=np.float64)
    parentid = np.asarray(m.body_parentid)
    for b in range(m.nbody):
      anc = b
      while anc > 0:
        da, dn = int(m.body_dofadr[anc]), int(m.body_dofnum[anc])
        mask[b, da : da + dn] = 1.0
        anc = parentid[anc]
    return mask

  return cached(m, "support.dof_ancestor_mask", build)


def dof_ancestor_mask_t(m: Model) -> torch.Tensor:
  """dof_ancestor_mask as a tensor in the model's dtype and device."""
  return cached(
      m, "support.dof_ancestor_mask_t",
      lambda: torch.as_tensor(dof_ancestor_mask(m), dtype=m.dtype, device=m.device),
  )


# ---------------------------------------------------------------------------
# Jacobians (device)
# ---------------------------------------------------------------------------


def jac(m: Model, d: Data, point: torch.Tensor, body_id: int):
  """Jacobian of a world ``point`` (B, 3) attached to body ``body_id``.

  Returns (jacp, jacr), each (B, nv, 3).
  """
  mask = dof_ancestor_mask_t(m)[int(body_id)]
  root = int(m.body_rootid[body_id])
  offset = point - d.subtree_com[:, root]
  jacp = (d.cdof[..., 3:] + math.cross(d.cdof[..., :3], offset[:, None, :])) * mask[:, None]
  jacr = d.cdof[..., :3] * mask[:, None]
  return jacp, jacr


def xfrc_accumulate(m: Model, d: Data) -> torch.Tensor:
  """Maps d.xfrc_applied over all bodies to generalized forces (B, nv)."""
  mask = dof_ancestor_mask_t(m)                                    # (nbody, nv)
  offset = d.xipos - d.subtree_com[:, index(m, "body_rootid")]   # (B, nbody, 3)
  jacp = d.cdof[:, None, :, 3:] + math.cross(
      d.cdof[:, None, :, :3], offset[:, :, None, :]
  )  # (B, nbody, nv, 3)
  qfrc_p = torch.einsum("nv,bnvi,bni->bv", mask, jacp, d.xfrc_applied[..., :3])
  qfrc_r = torch.einsum("nv,bvi,bni->bv", mask, d.cdof[..., :3], d.xfrc_applied[..., 3:])
  return qfrc_p + qfrc_r
