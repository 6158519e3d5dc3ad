"""mjtpu_torch.zoo — batched RL environments over the port (mjtpu.zoo's
counterpart): ``ENVS[name](dtype=..., device=...)``, ``reset`` and
``step`` with auto-reset."""

from mjtpu_torch.zoo import cmg
from mjtpu_torch.zoo import envs as _envs  # registers the standard envs
from mjtpu_torch.zoo import satellite as _satellite  # registers the satellite envs
from mjtpu_torch.zoo.base import ENVS, MjtpuEnv, State, register_env
