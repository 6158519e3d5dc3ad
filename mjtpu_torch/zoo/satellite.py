"""Satellite attitude-control envs with CMG clusters, batched.

Port of mjtpu/zoo/satellite.py.  ``satellite``: gimbal hinge angles are
real joints, and the CMG reaction torque -h0 * J(delta) @ delta_dot acts
on the satellite body through xfrc_applied (momentum exchange with
rotors modelled through the cluster Jacobian of cmg.py).
``satellite_large`` and ``satellite_small``: the rotors are real spinning
bodies, so the gyroscopic bus torque comes from the Coriolis terms of the
multibody dynamics; the policy commands the gimbal-rate servos and the
rotor-speed servos hold ``rotor_speed``.
"""

from __future__ import annotations

import torch

from mjtpu_torch._src import math
from mjtpu_torch._src.dataclasses import replace
from mjtpu_torch.zoo import cmg
from mjtpu_torch.zoo.base import MjtpuEnv, register_env


@register_env("satellite")
class Satellite(MjtpuEnv):
  snapshot = "satellite_model.npz"
  frame_skip = 2
  reset_noise = 0.2
  episode_length = 500
  h0 = 5.0  # rotor momentum magnitude

  def __init__(self, dtype: torch.dtype = torch.float32, device="cuda", **kwargs):
    super().__init__(dtype=dtype, device=device, **kwargs)
    self.g_axes, self.s_axes0 = cmg.pyramid_cluster(dtype=self.model.dtype,
                                                    device=self.device)

  def _jacobian(self, data):
    return cmg.cluster_jacobian(self.g_axes, self.s_axes0, data.qpos[:, 7:11], self.h0)

  def _cmg_torque(self, data) -> torch.Tensor:
    """(B, 3) CMG reaction torque in the world frame."""
    torque_body = -(self._jacobian(data) @ data.qvel[:, 6:10, None])[..., 0]
    return math.rotate(torque_body, data.xquat[:, 1])

  def step(self, state, action, generator, model=None):
    """Writes the CMG torque on the satellite body into xfrc_applied, then
    steps as every env does."""
    xfrc = state.data.xfrc_applied.clone()
    xfrc[:, 1, 3:] = self._cmg_torque(state.data)
    state = replace(state, data=replace(state.data, xfrc_applied=xfrc))
    return super().step(state, action, generator, model)

  def _obs(self, data):
    delta = data.qpos[:, 7:11]
    manip = cmg.manipulability(self._jacobian(data))
    return torch.cat([
        data.qpos[:, 3:7],    # attitude quaternion
        data.qvel[:, 3:6],    # body angular velocity
        torch.sin(delta),
        torch.cos(delta),
        data.qvel[:, 6:10],   # gimbal rates
        manip[:, None],
    ], dim=-1)

  def _reward_done(self, prev, data, action):
    # pointing: align body z with world z; regularize spin & gimbal effort
    quat = data.qpos[:, 3:7]
    z = torch.zeros_like(quat[:, 1:])
    z[:, 2] = 1.0
    bz = math.rotate(z, quat)
    spin = torch.sum(torch.square(data.qvel[:, 3:6]), dim=-1)
    reward = bz[:, 2] - 0.1 * spin - 0.01 * torch.sum(torch.square(action), dim=-1)
    return reward, torch.zeros_like(reward, dtype=torch.bool)


class _SatelliteCMG(MjtpuEnv):
  """Satellite with explicit gimbal and rotor CMG bodies (joints
  interleaved per CMG: g1 r1 g2 r2 ...; actuators: the gimbal-rate
  servos, then the rotor-speed servos).  Reward = sun alignment (body +Z
  toward the world +Z sun) - ctrl cost - angular-velocity penalty;
  episodes never terminate, only truncate."""

  n_gimbals: int = 0
  rotor_speed: float = 100.0
  frame_skip = 10
  reset_noise = 0.001
  episode_length = 500
  ctrl_cost_weight = 0.01
  ang_vel_weight = 0.1

  @property
  def action_size(self) -> int:
    return self.n_gimbals

  def _rotor_dofs(self) -> slice:
    # rotor dof = 6 + 2i + 1 (a slice: no index copy to the device)
    return slice(7, 6 + 2 * self.n_gimbals, 2)

  def _prepare_ctrl(self, action):
    rotor = action.new_full((action.shape[0], self.n_gimbals), self.rotor_speed)
    return torch.cat([action, rotor], dim=-1)

  def _noisy_init(self, batch_size, generator):
    data = super()._noisy_init(batch_size, generator)
    # the rotors spin at speed from the start
    qvel = data.qvel.clone()
    qvel[:, self._rotor_dofs()] = self.rotor_speed
    return replace(data, qvel=qvel)

  def _obs(self, data):
    return torch.cat([
        data.qpos[:, 3:7],   # bus attitude quaternion (w, x, y, z)
        data.qvel[:, 3:6],   # bus angular velocity
        data.qpos[:, 7:],    # gimbal + rotor angles
        data.qvel[:, 6:],    # gimbal + rotor rates
    ], dim=-1)

  def _reward_done(self, prev, data, action):
    # body +Z on world +Z (the sun): z'z of the rotation matrix is
    # 1 - 2(qx^2 + qy^2)
    qx, qy = data.qpos[:, 4], data.qpos[:, 5]
    sun_alignment = 1.0 - 2.0 * (qx * qx + qy * qy)
    ctrl_cost = self._ctrl_cost(action, self.ctrl_cost_weight)
    spin = self.ang_vel_weight * torch.sum(torch.square(data.qvel[:, 3:6]), dim=-1)
    reward = sun_alignment - ctrl_cost - spin
    return reward, torch.zeros_like(reward, dtype=torch.bool)


@register_env("satellite_large")
class SatelliteLarge(_SatelliteCMG):
  """500 kg-class bus, 4-CMG pyramid (beta = arctan sqrt 2)."""

  snapshot = "satellite_large_model.npz"
  n_gimbals = 4
  rotor_speed = 100.0


@register_env("satellite_small")
class SatelliteSmall(_SatelliteCMG):
  """CubeSat bus, redundant 6-CMG cluster (one per face)."""

  snapshot = "satellite_small_model.npz"
  n_gimbals = 6
  rotor_speed = 200.0
