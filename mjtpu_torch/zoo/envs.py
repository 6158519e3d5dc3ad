"""The environment zoo (port of mjtpu/zoo/envs.py), batched.

Observations, rewards and terminations follow mjtpu's term for term (the
Gymnasium-v4 definitions): each env's frame_skip, reset_noise and
episode_length are mjtpu's.  Every function takes batched Data: a field
indexed ``[i]`` in mjtpu is ``[:, i]`` here.
"""

from __future__ import annotations

import torch

from mjtpu_torch.zoo.base import MjtpuEnv, register_env


def _forward_velocity(env: MjtpuEnv, prev, data) -> torch.Tensor:
  return (data.qpos[:, 0] - prev.qpos[:, 0]) / env.dt


@register_env("cartpole")
class Cartpole(MjtpuEnv):
  snapshot = "cartpole_model.npz"
  frame_skip = 2
  reset_noise = 0.05
  episode_length = 500

  def _obs(self, data):
    return torch.cat([data.qpos, data.qvel], dim=-1)

  def _reward_done(self, prev, data, action):
    upright = torch.cos(data.qpos[:, 1])
    reward = upright - 0.01 * torch.sum(torch.square(action), dim=-1)
    done = (torch.abs(data.qpos[:, 0]) > 1.9) | (torch.abs(data.qpos[:, 1]) > 1.0)
    return reward, done


@register_env("halfcheetah")
class HalfCheetah(MjtpuEnv):
  snapshot = "halfcheetah_model.npz"
  frame_skip = 5
  reset_noise = 0.1
  episode_length = 1000

  def _obs(self, data):
    return torch.cat([data.qpos[:, 1:], data.qvel], dim=-1)

  def _reward_done(self, prev, data, action):
    reward = _forward_velocity(self, prev, data) - self._ctrl_cost(action, 0.1)
    return reward, torch.zeros_like(reward, dtype=torch.bool)


@register_env("hopper")
class Hopper(MjtpuEnv):
  snapshot = "hopper_model.npz"
  frame_skip = 4
  reset_noise = 0.005
  episode_length = 1000

  def _obs(self, data):
    return torch.cat([data.qpos[:, 1:], torch.clamp(data.qvel, -10, 10)], dim=-1)

  def _reward_done(self, prev, data, action):
    fwd = _forward_velocity(self, prev, data)
    healthy = (
        (data.qpos[:, 1] > 0.7)
        & (torch.abs(data.qpos[:, 2]) < 0.2)
        & torch.all(torch.abs(data.qvel) < 10.0, dim=-1)
        & torch.all(torch.abs(data.qpos[:, 2:]) < 100.0, dim=-1)
    )
    reward = fwd + 1.0 * healthy - self._ctrl_cost(action, 1e-3)
    return reward, ~healthy


@register_env("walker2d")
class Walker2d(MjtpuEnv):
  snapshot = "walker2d_model.npz"
  frame_skip = 4
  reset_noise = 0.005
  episode_length = 1000

  def _obs(self, data):
    return torch.cat([data.qpos[:, 1:], torch.clamp(data.qvel, -10, 10)], dim=-1)

  def _reward_done(self, prev, data, action):
    fwd = _forward_velocity(self, prev, data)
    healthy = (
        (data.qpos[:, 1] > 0.8)
        & (data.qpos[:, 1] < 2.0)
        & (torch.abs(data.qpos[:, 2]) < 1.0)
    )
    reward = fwd + 1.0 * healthy - self._ctrl_cost(action, 1e-3)
    return reward, ~healthy


@register_env("swimmer")
class Swimmer(MjtpuEnv):
  """A three-link swimmer in a viscous medium (RK4; fluid forces by the
  inertia-box model)."""

  snapshot = "swimmer_model.npz"
  frame_skip = 4
  reset_noise = 0.1
  episode_length = 1000

  def _obs(self, data):
    return torch.cat([data.qpos[:, 2:], data.qvel], dim=-1)

  def _reward_done(self, prev, data, action):
    reward = _forward_velocity(self, prev, data) - self._ctrl_cost(action, 1e-4)
    return reward, torch.zeros_like(reward, dtype=torch.bool)


@register_env("ant")
class Ant(MjtpuEnv):
  snapshot = "ant_model.npz"
  frame_skip = 5
  reset_noise = 0.1
  episode_length = 1000

  def _obs(self, data):
    return torch.cat([data.qpos[:, 2:], data.qvel], dim=-1)

  def _reward_done(self, prev, data, action):
    fwd = _forward_velocity(self, prev, data)
    healthy = (data.qpos[:, 2] > 0.2) & (data.qpos[:, 2] < 1.0)
    reward = fwd + 1.0 * healthy - self._ctrl_cost(action, 0.5)
    return reward, ~healthy


@register_env("humanoid")
class Humanoid(MjtpuEnv):
  snapshot = "humanoid_model.npz"
  frame_skip = 5
  reset_noise = 0.01
  episode_length = 1000

  def _obs(self, data):
    batch = data.qpos.shape[0]
    return torch.cat([
        data.qpos[:, 2:],
        data.qvel,
        data.cinert[:, 1:].reshape(batch, -1),
        data.cvel[:, 1:].reshape(batch, -1),
        data.qfrc_actuator,
    ], dim=-1)

  def _reward_done(self, prev, data, action):
    fwd = 1.25 * (data.qpos[:, 0] - prev.qpos[:, 0]) / self.dt
    healthy = (data.qpos[:, 2] > 1.0) & (data.qpos[:, 2] < 2.0)
    reward = fwd + 5.0 * healthy - self._ctrl_cost(action, 0.1)
    return reward, ~healthy


@register_env("humanoid_terrain")
class HumanoidTerrain(Humanoid):
  """Humanoid on procedural height-field terrain with mesh obstacles; the
  committed snapshot holds the terrain mjtpu.procedural_terrain fills in.
  The spawn region is flat, so rewards and termination match the plane
  humanoid."""

  snapshot = "humanoid_terrain_model.npz"


@register_env("humanoid_rich")
class HumanoidRich(Humanoid):
  """Humanoid with a richer observation: constraint forces and the torso's
  subtree centre of mass."""

  def _obs(self, data):
    base = super()._obs(data)
    contact = torch.tanh(0.1 * data.qfrc_constraint)
    return torch.cat([base, contact, data.subtree_com[:, 1]], dim=-1)
