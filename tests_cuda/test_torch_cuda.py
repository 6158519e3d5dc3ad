"""The Hopper kernels (Cholesky, height-field manifold) against their plain
twins, and the port's step on the card against the same step on the CPU."""

import numpy as np
import pytest
import torch

import mjtpu_torch
from mjtpu_torch.ops import cholesky, fused, hfield

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


def _windows(n, hy, hx, has_axis, dtype, flat=False, seed=0):
  """Random height windows (n, R, C) and objects over them, on the card."""
  gen = torch.Generator(device="cuda").manual_seed(seed)
  u = lambda *shape: torch.rand(*shape, generator=gen, device="cuda", dtype=dtype)
  rr, cc = 2 * hy + 2, 2 * hx + 2
  zwin = torch.full((n, rr, cc), 0.05, dtype=dtype, device="cuda") if flat else 0.15 * u(n, rr, cc)
  origin = 4.0 * u(n, 2) - 2.0
  span = torch.tensor([(cc - 1) * 0.37, (rr - 1) * 0.29], dtype=dtype, device="cuda")
  center = torch.cat([origin + u(n, 2) * span, 0.3 * u(n, 1)], dim=1)
  axis = (0.4 * u(n, 3) - 0.2) if has_axis else torch.zeros_like(center)
  return zwin, origin, center - axis, center + axis, 0.02 + 0.1 * u(n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("hy, hx", [(0, 0), (2, 2), (8, 8)])
@pytest.mark.parametrize("has_axis", [False, True], ids=["sphere", "capsule"])
@pytest.mark.parametrize("flat", [False, True], ids=["random", "flat"])
def test_hfield_kernel_matches_twin(flat, has_axis, hy, hx, dtype):
  """The kernel repeats the twin's operations in its order, without
  contracted multiply-adds: the winners and their values agree exactly."""
  args = _windows(1000, hy, hx, has_axis, dtype, flat)
  before = hfield.launches
  got = hfield.manifold_batch(*args, hy, hx, 0.37, 0.29, has_axis)
  want = hfield.manifold_reference(*args, hy, hx, 0.37, 0.29, has_axis)
  torch.cuda.synchronize()
  assert hfield.launches == before + 1
  for g, w in zip(got, want):
    assert torch.equal(g, w)


def test_hfield_refusals():
  args = _windows(4, 9, 9, True, torch.float64)
  with pytest.raises(ValueError):  # past the kernel's static bound
    hfield.manifold_batch(*args, 9, 9, 0.37, 0.29, True)
  args = _windows(4, 2, 2, True, torch.float64)
  with pytest.raises(ValueError):  # mixed devices
    hfield.manifold_batch(args[0], args[1].cpu(), *args[2:], 2, 2, 0.37, 0.29, True)


@pytest.mark.parametrize("name, chol, hf", [("humanoid_bench", 1, 0), ("humanoid_terrain", 8, 2)])
def test_step_on_cuda_matches_cpu(name, chol, hf):
  """Three steps on the card against the same three on the CPU, with the
  kernels' launch counts per step (Newton iterations for Cholesky, one per
  height-field group for the manifold)."""
  ns = mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / f"{name}_model.npz")
  golden = np.load(mjtpu_torch.ASSETS / f"{name}_golden.npz")
  out = {}
  for device in ("cpu", "cuda"):
    m = mjtpu_torch.model_from_arrays(ns, device=device)
    d = mjtpu_torch.make_data(m, batch_size=4)
    d = mjtpu_torch.replace(
        d, qpos=torch.as_tensor(golden["qpos0"], device=device),
        ctrl=torch.as_tensor(golden["ctrl"], device=device))
    before = cholesky.launches, hfield.launches
    for _ in range(3):
      d = mjtpu_torch.step(m, d)
    out[device] = (d.qacc.cpu().numpy(), cholesky.launches - before[0],
                   hfield.launches - before[1])
  assert out["cpu"][1:] == (0, 0) and out["cuda"][1:] == (3 * chol, 3 * hf)
  np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=0,
                             atol=1e-9 * max(1.0, np.abs(out["cpu"][0]).max()))
