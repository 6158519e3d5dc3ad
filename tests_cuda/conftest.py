"""CUDA tier: tests of the port's hand-written kernels, which run only on an
NVIDIA GPU (there is no CPU or interpret mode for a CUDA kernel).  Every
test here is marked ``cuda`` and skips where torch finds no CUDA device.

Run from the repo root on a machine with the card (no jax or mujoco needed):

    python -m pytest tests_cuda -q -p no:cacheprovider
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import pytest
import torch


@pytest.fixture(autouse=True)
def _require_cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device")
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
