"""The Hopper Cholesky kernel against its plain twin, and the port's step
on the card against the same step on the CPU."""

import numpy as np
import pytest
import torch

import mjtpu_torch
from mjtpu_torch.ops import cholesky, fused

pytestmark = pytest.mark.cuda


def _spd(batch, n, dtype, seed=0):
  gen = torch.Generator(device="cuda").manual_seed(seed)
  a = torch.randn(batch, n, n, dtype=dtype, device="cuda", generator=gen)
  mat = a @ a.transpose(1, 2) + n * torch.eye(n, dtype=dtype, device="cuda")
  return mat, torch.randn(batch, n, dtype=dtype, device="cuda", generator=gen)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 6, 27, 33, 64])
@pytest.mark.parametrize("batch", [1, 130, 4096])
def test_kernel_matches_twin(batch, n, dtype):
  mat, rhs = _spd(batch, n, dtype)
  x = cholesky.cholesky_solve(mat, rhs)
  ref = cholesky.chol_solve_reference(mat, rhs)
  rel = 1e-10 if dtype == torch.float64 else 1e-4
  assert float((x - ref).abs().max()) <= rel * float(ref.abs().max())


def test_launch_counter_and_refusals():
  mat, rhs = _spd(8, 6, torch.float64)
  before = cholesky.launches
  cholesky.cholesky_solve(mat, rhs)
  assert cholesky.launches == before + 1
  with pytest.raises(ValueError):
    cholesky.cholesky_solve(mat.transpose(1, 2), rhs)  # not contiguous
  with pytest.raises(ValueError):
    cholesky.cholesky_solve(mat, rhs.cpu())  # mixed devices
  big = cholesky.max_n(torch.float64) + 1
  with pytest.raises(ValueError):
    cholesky.cholesky_solve(*_spd(1, big, torch.float64))
  with pytest.raises(ValueError):  # the seam raises too: no route to the twin
    fused.chol_solve(*_spd(1, big, torch.float64))
  assert cholesky.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_nan_pivot_stays_nan(dtype):
  """A NaN pivot is not clamped to the floor: the kernel and the twin give
  NaN in the same places, so _check_state still sees the env diverge."""
  mat, rhs = _spd(64, 27, dtype)
  mat[3, 5, 5] = float("nan")
  mat[7, 0, 0] = float("nan")
  x = cholesky.cholesky_solve(mat, rhs)
  ref = cholesky.chol_solve_reference(mat, rhs)
  bad = ~torch.isfinite(ref)
  assert torch.equal(~torch.isfinite(x), bad)
  assert bad[3].all() and bad[7].all() and int(bad.any(1).sum()) == 2
  rel = 1e-10 if dtype == torch.float64 else 1e-4
  assert float((x - ref)[~bad].abs().max()) <= rel * float(ref[~bad].abs().max())


def test_step_on_cuda_matches_cpu():
  ns = mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / "humanoid_bench_model.npz")
  golden = np.load(mjtpu_torch.ASSETS / "humanoid_bench_golden.npz")
  out = {}
  for device in ("cpu", "cuda"):
    m = mjtpu_torch.model_from_arrays(ns, device=device)
    d = mjtpu_torch.make_data(m, batch_size=4)
    d = mjtpu_torch.replace(
        d, qpos=torch.as_tensor(golden["qpos0"], device=device),
        ctrl=torch.as_tensor(golden["ctrl"], device=device))
    before = cholesky.launches
    for _ in range(3):
      d = mjtpu_torch.step(m, d)
    out[device] = (d.qacc.cpu().numpy(), cholesky.launches - before)
  assert out["cpu"][1] == 0 and out["cuda"][1] == 3
  np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=0,
                             atol=1e-9 * max(1.0, np.abs(out["cpu"][0]).max()))
