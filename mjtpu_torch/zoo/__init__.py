"""mjtpu_torch.zoo — batched RL environments over the port (mjtpu.zoo's
counterpart): ``ENVS[name](dtype=..., device=...)``, ``reset`` and
``step`` with auto-reset."""

from mjtpu_torch.zoo import envs as _envs  # registers the envs
from mjtpu_torch.zoo.base import ENVS, MjtpuEnv, State, register_env
