"""Batched RL environments over mjtpu_torch (port of mjtpu/zoo/base.py).

mjtpu's envs are functional JAX envs under ``jax.vmap``; here every call
steps the whole batch at once, as the rest of the port does.  An env holds
a Model loaded from its committed snapshot in ``mjtpu_torch/assets`` (the
port reads no MJCF: ``mujoco`` is not needed).  Randomness comes only from
an explicit ``torch.Generator`` on the env's device, which takes the place
of mjtpu's per-env PRNG keys; auto-reset is a ``torch.where`` over every
Data field, as mjtpu's ``jnp.where`` mask.

Usage:
    env = mjtpu_torch.zoo.ENVS["ant"]()              # float32 on cuda
    gen = torch.Generator(device=env.device).manual_seed(0)
    state = env.reset(4096, gen)
    state = env.step(state, action, gen)             # auto-resets done envs

``reset`` and ``step`` take ``model=``, a Model with one row per env
from ``mjtpu_torch.parallel.randomize`` (domain randomization): the
physics runs under it, while observations and rewards keep reading the
env's own model, as in mjtpu.

``pixel_obs=True`` renders camera 0 of every env into ``State.pixels``
(B, H, W, 3) at ``pixel_size`` (H, W) after each reset and each step's
auto-reset, as mjtpu's envs do.  Where the env's MJCF has no camera, mjtpu
injects an observer camera; the port loads that model's snapshot from
``assets/pixel_env_models.npz``.  humanoid_terrain is refused by name: its
floor is a height field, which no ray intersector draws, in mjtpu
neither.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from mjtpu_torch import ASSETS
from mjtpu_torch._src import forward as forward_mod
from mjtpu_torch._src import io
from mjtpu_torch._src import render as render_mod
from mjtpu_torch._src.dataclasses import replace
from mjtpu_torch._src.types import Data, Model

ENVS: dict[str, Callable[..., "MjtpuEnv"]] = {}
# snapshots of the zoo models whose MJCF has no camera, with the observer
# camera mjtpu's pixel envs inject (name: the plain snapshot's, less
# "_model.npz")
PIXEL_MODELS_FILE = "pixel_env_models.npz"


def register_env(name: str):
  def deco(cls):
    ENVS[name] = cls
    cls.name = name
    return cls

  return deco


@dataclasses.dataclass
class State:
  """Environment state carried between steps, batched over B envs."""

  data: Data
  obs: torch.Tensor     # (B, observation_size)
  reward: torch.Tensor  # (B,)
  done: torch.Tensor    # (B,) bool
  steps: torch.Tensor   # (B,) int32 episode step counter
  # (B, H, W, 3) with pixel observations, else (B, 0); reset and step fill it
  pixels: torch.Tensor = None


def _select(mask: torch.Tensor, a, b):
  """Field by field, ``a`` where ``mask`` (B,) else ``b``, recursing into
  the Contact struct."""
  out = {}
  for f in dataclasses.fields(a):
    x, y = getattr(a, f.name), getattr(b, f.name)
    if dataclasses.is_dataclass(x):
      out[f.name] = _select(mask, x, y)
    else:
      out[f.name] = torch.where(mask.reshape((-1,) + (1,) * (x.dim() - 1)), x, y)
  return dataclasses.replace(a, **out)


class MjtpuEnv:
  """Base class: loads the snapshot, owns the Model, defines reset/step.

  Subclasses set ``snapshot``, ``frame_skip``, ``reset_noise`` and
  ``episode_length``, and implement ``_obs`` and ``_reward_done`` over
  batched Data.
  """

  snapshot: str = ""
  frame_skip: int = 5
  reset_noise: float = 0.01
  episode_length: int = 1000

  def __init__(self, dtype: torch.dtype = torch.float32, device="cuda",
               pixel_obs: bool = False, pixel_size=(64, 64)):
    ns = io.load_snapshot(ASSETS / self.snapshot)
    if pixel_obs and not int(ns.ncam):
      name = self.snapshot.removesuffix("_model.npz")
      if name not in io.bundle_names(ASSETS / PIXEL_MODELS_FILE):
        raise NotImplementedError(
            f"mjtpu_torch.zoo renders no pixels for {self.name}: its floor is a height"
            " field, which has no ray intersector (in mjtpu neither)")
      ns = io.load_snapshot(ASSETS / PIXEL_MODELS_FILE, name)
    # mjtpu's dt reads the MjModel's float64 timestep, whatever the dtype
    self._timestep = float(ns.opt.timestep)
    self.model: Model = io.model_from_arrays(ns, dtype=dtype, device=device)
    self.pixel_obs = pixel_obs
    self.pixel_size = tuple(pixel_size)
    self._render_data = (render_mod.precompute_render_data(self.model) if pixel_obs
                         else None)

  @property
  def device(self) -> torch.device:
    return self.model.device

  @property
  def action_size(self) -> int:
    return self.model.nu

  @property
  def observation_size(self) -> int:
    return int(self._obs(io.make_data(self.model, batch_size=1)).shape[-1])

  def _prepare_ctrl(self, action: torch.Tensor) -> torch.Tensor:
    """Hook: map the policy action onto the full ctrl vector (identity)."""
    return action

  # -- episode logic ---------------------------------------------------------

  def _noisy_init(self, batch_size: int, generator: torch.Generator) -> Data:
    """qpos0 + uniform(-noise, noise) and noise * normal qvel, every other
    field as make_data leaves it."""
    m = self.model
    kw = dict(dtype=m.dtype, device=m.device)
    noise = self.reset_noise
    qpos = m.qpos0 + torch.empty((batch_size, m.nq), **kw).uniform_(
        -noise, noise, generator=generator)
    qvel = noise * torch.randn((batch_size, m.nv), generator=generator, **kw)
    return replace(io.make_data(m, batch_size=batch_size), qpos=qpos, qvel=qvel)

  def _pixels(self, data: Data) -> torch.Tensor:
    """Camera 0's image of every env, (B, H, W, 3), or (B, 0) without pixel
    observations."""
    if not self.pixel_obs:
      return data.qpos.new_zeros((data.qpos.shape[0], 0))
    h, w = self.pixel_size
    return render_mod.render(self.model, data, width=w, height=h, camera=0,
                             rd=self._render_data)

  def _init_state(self, data: Data) -> State:
    """The State of freshly reset envs at ``data`` (forward already run):
    their observation, reward 0, not done, step 0, their pixels."""
    obs = self._obs(data)
    batch = obs.shape[0]
    return State(
        data=data, obs=obs, reward=obs.new_zeros(batch),
        done=torch.zeros(batch, dtype=torch.bool, device=obs.device),
        steps=torch.zeros(batch, dtype=torch.int32, device=obs.device),
        pixels=self._pixels(data),
    )

  def reset(self, batch_size: int, generator: torch.Generator,
            model: Model | None = None) -> State:
    """``batch_size`` envs from the noisy initial state, drawn from
    ``generator``; ``model`` overrides the env's Model for the physics
    (one row per env from parallel.randomize)."""
    m = self.model if model is None else model
    data = forward_mod.forward(m, self._noisy_init(batch_size, generator))
    return self._init_state(data)

  def step(self, state: State, action: torch.Tensor, generator: torch.Generator,
           model: Model | None = None) -> State:
    """Steps every env ``frame_skip`` physics steps under ``action`` (B, nu);
    envs that end their episode start afresh from a noisy initial state
    drawn from ``generator`` (mjtpu's fused auto-reset).  ctrl takes the
    action as it is; fwd_actuation clamps it to ctrlrange, as in mjtpu.
    ``model`` overrides the env's Model for the physics (domain
    randomization: a Model from parallel.randomize, row i for env i);
    observations, rewards and pixels keep reading the env's own model."""
    m = self.model if model is None else model
    ctrl = self._prepare_ctrl(action)
    data = replace(state.data, ctrl=ctrl.to(state.data.ctrl.dtype))
    for _ in range(self.frame_skip):
      data = forward_mod.step(m, data)
    reward, done = self._reward_done(state.data, data, action)
    steps = state.steps + 1
    done = done | (steps >= self.episode_length)

    # fused auto-reset: where(done) swap in a fresh state
    fresh = forward_mod.forward(m, self._noisy_init(done.shape[0], generator))
    data = _select(done, fresh, data)
    steps = torch.where(done, 0, steps)
    obs = self._obs(data)
    return State(data=data, obs=obs, reward=reward.to(obs.dtype), done=done, steps=steps,
                 pixels=self._pixels(data))

  # -- per-env definitions ---------------------------------------------------

  def _obs(self, data: Data) -> torch.Tensor:
    raise NotImplementedError

  def _reward_done(self, prev: Data, data: Data, action: torch.Tensor):
    raise NotImplementedError

  # -- helpers ---------------------------------------------------------------

  @property
  def dt(self) -> float:
    return self._timestep * self.frame_skip

  def _ctrl_cost(self, action: torch.Tensor, weight: float) -> torch.Tensor:
    return weight * torch.sum(torch.square(action), dim=-1)
