"""Passive forces: joint springs and dampers.

Port of mjtpu/_src/passive.py's spring-damper part (mj_passive).  Gravity
compensation and fluid forces wait for a later slice; put_model refuses
models that use them, so their terms are exact zeros here.
"""

from __future__ import annotations

import numpy as np
import torch

from mjtpu_torch._src import math, scan
from mjtpu_torch._src.dataclasses import replace
from mjtpu_torch._src.types import Data, DisableBit, JointType, Model


def _spring_damper(m: Model, d: Data) -> tuple[torch.Tensor, torch.Tensor]:
  """Joint springs (qfrc_spring) and dampers (qfrc_damper), each (B, nv)."""
  qfrc_spring = torch.zeros_like(d.qvel)

  if m.has_jnt_spring:

    def fn(jnt_types, stiffness, qpos, qpos_spring):
      out = []
      qi = 0
      for i, jt in enumerate(jnt_types):
        jt = JointType(int(jt))
        k = stiffness[..., i, None]
        if jt == JointType.FREE:
          out.append(-k * (qpos[..., qi : qi + 3] - qpos_spring[..., qi : qi + 3]))
          out.append(-k * math.quat_sub(qpos[..., qi + 3 : qi + 7], qpos_spring[..., qi + 3 : qi + 7]))
          qi += 7
        elif jt == JointType.BALL:
          out.append(-k * math.quat_sub(qpos[..., qi : qi + 4], qpos_spring[..., qi : qi + 4]))
          qi += 4
        else:
          out.append(-k * (qpos[..., qi : qi + 1] - qpos_spring[..., qi : qi + 1]))
          qi += 1
      if not out:
        return qpos.new_zeros(qpos.shape[:-1] + (0,))
      # broadcast the leading axes only: a slide's 1 column stays 1 beside
      # a ball's 3
      lead = torch.broadcast_shapes(*(o.shape[:-1] for o in out))
      return torch.cat([o.expand(lead + o.shape[-1:]) for o in out], dim=-1)

    spring = scan.flat(
        m, fn, "jjqq", "v",
        np.asarray(m.jnt_type), m.jnt_stiffness[None], d.qpos, m.qpos_spring[None],
    )
    if spring is not None:
      qfrc_spring = spring

  qfrc_damper = -m.dof_damping * d.qvel
  return qfrc_spring, qfrc_damper


def passive(m: Model, d: Data) -> Data:
  """Passive forces (mj_passive)."""
  zero = torch.zeros_like(d.qvel)
  if (m.opt.disableflags & DisableBit.PASSIVE) == DisableBit.PASSIVE:
    return replace(d, qfrc_spring=zero, qfrc_damper=zero, qfrc_passive=zero)

  qfrc_spring, qfrc_damper = _spring_damper(m, d)
  if m.opt.disableflags & DisableBit.SPRING:
    qfrc_spring = zero
  if m.opt.disableflags & DisableBit.DAMPER:
    qfrc_damper = zero
  return replace(
      d, qfrc_spring=qfrc_spring, qfrc_damper=qfrc_damper,
      qfrc_passive=qfrc_spring + qfrc_damper,
  )
