"""mjtpu_torch.ops.cholesky on the CPU: the plain twin against mjtpu's
per-env base rule (fused._base under jax.vmap) and against mjtpu's Pallas
kernel in interpret mode (as tests/test_ops.py runs it), plus the CPU
contract of the wrapper and the seam.  The CUDA kernel itself runs only on
the card: tests_cuda/ and chip_smoke.py hold it to the twin there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mjtpu.ops import cholesky as mjtpu_cholesky
from mjtpu.ops import fused as mjtpu_fused
from mjtpu_torch.ops import _build, cholesky, fused

torch.set_num_threads(1)

B = 130  # not a multiple of the Pallas tile: exercises its padding


def _batch(n: int, clamp: bool, seed: int = 0):
  """(B, n, n) SPD matrices and (B, n) right-hand sides.  clamp zeroes a
  random ~30% of rows/columns, so those pivots are exactly 0 and hit the
  floor (a massless dof)."""
  rng = np.random.default_rng(seed + 17 * n + clamp)
  a = rng.normal(size=(B, n, n))
  mat = a @ a.transpose(0, 2, 1) + n * np.eye(n)
  if clamp:
    keep = (rng.random((B, n)) >= 0.3).astype(np.float64)
    keep[0] = 0.0  # at least one env with every pivot at the floor
    mat = mat * keep[:, :, None] * keep[:, None, :]
  return mat, rng.normal(size=(B, n))


def _assert_close(got, want, clamp):
  # well-conditioned SPD: rel 1e-10; clamped pivots give ~1/floor
  # solutions, ill-conditioned, so rel 1e-6 of the largest entry
  rel = 1e-6 if clamp else 1e-10
  np.testing.assert_allclose(got, want, rtol=rel, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("n", [1, 11, 27])
def test_twin_matches_mjtpu_base(n, clamp):
  mat, rhs = _batch(n, clamp)
  want = np.asarray(jax.vmap(mjtpu_fused._base)(jnp.asarray(mat), jnp.asarray(rhs)))
  got = cholesky.chol_solve_reference(torch.as_tensor(mat), torch.as_tensor(rhs)).numpy()
  _assert_close(got, want, clamp)


@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("n", [1, 11, 27])
def test_twin_matches_pallas_kernel(n, clamp):
  mat, rhs = _batch(n, clamp)
  with pltpu.force_tpu_interpret_mode():
    want = np.asarray(mjtpu_cholesky.cholesky_solve(jnp.asarray(mat), jnp.asarray(rhs)))
  got = cholesky.chol_solve_reference(torch.as_tensor(mat), torch.as_tensor(rhs)).numpy()
  _assert_close(got, want, clamp)


def test_twin_f32_floor_keeps_solution_finite():
  mat, rhs = _batch(11, clamp=True)
  x = cholesky.chol_solve_reference(
      torch.as_tensor(mat, dtype=torch.float32), torch.as_tensor(rhs, dtype=torch.float32))
  assert bool(torch.isfinite(x).all())
  # the f32 floor is 1e-9: a dead dof's component is rhs / 1e-9
  dead = np.nonzero(mat[0].diagonal() == 0)[0]
  np.testing.assert_allclose(x[0, dead].numpy(), rhs[0, dead] / 1e-9, rtol=1e-5)


def test_twin_nan_pivot_matches_mjtpu_base():
  """A NaN pivot is not clamped to the floor: the env's solution is NaN, as
  in mjtpu, so _check_state sees it diverge; the other envs are untouched."""
  mat, rhs = _batch(11, clamp=False)
  mat[3, 5, 5] = np.nan
  mat[7, 0, 0] = np.nan
  want = np.asarray(jax.vmap(mjtpu_fused._base)(jnp.asarray(mat), jnp.asarray(rhs)))
  got = cholesky.chol_solve_reference(torch.as_tensor(mat), torch.as_tensor(rhs)).numpy()
  bad = ~np.isfinite(want)
  np.testing.assert_array_equal(~np.isfinite(got), bad)
  assert bad[3].all() and bad[7].all() and bad.any(axis=1).sum() == 2
  _assert_close(got[~bad], want[~bad], clamp=False)


def test_seam_on_cpu_uses_twin_and_never_builds():
  mat, rhs = _batch(27, clamp=False)
  h, g = torch.as_tensor(mat), torch.as_tensor(rhs)
  before = cholesky.launches
  x = fused.chol_solve(h, g)
  np.testing.assert_array_equal(x.numpy(), cholesky.chol_solve_reference(h, g).numpy())
  y = cholesky.cholesky_solve(h, g)
  np.testing.assert_array_equal(y.numpy(), x.numpy())
  assert cholesky.launches == before == 0
  # no nvcc, no library: nothing was built
  assert cholesky.SOURCE not in _build._libs and cholesky.SOURCE not in _build.build_logs


def test_wrapper_refuses_bad_inputs():
  mat, rhs = _batch(6, clamp=False)
  h, g = torch.as_tensor(mat), torch.as_tensor(rhs)
  with pytest.raises(TypeError):
    cholesky.cholesky_solve(h.float(), g)  # mixed dtypes
  with pytest.raises(TypeError):
    cholesky.cholesky_solve(h.to(torch.int64), g.to(torch.int64))
  with pytest.raises(TypeError):
    cholesky.cholesky_solve(h.half(), g.half())
  with pytest.raises(ValueError):
    cholesky.cholesky_solve(h, g[:, :5])  # rhs width != n
  with pytest.raises(ValueError):
    cholesky.cholesky_solve(h[0], g[0])  # unbatched
  with pytest.raises(ValueError):
    cholesky.cholesky_solve(h[:, :, :5], g)  # not square


def test_shared_memory_bound():
  # one warp's (n, n) matrix and (n,) vector fit the 227 KB a block can use
  for dtype, n in ((torch.float64, cholesky.max_n(torch.float64)),
                   (torch.float32, cholesky.max_n(torch.float32))):
    item = torch.empty((), dtype=dtype).element_size()
    assert (n * n + n) * item <= cholesky.SMEM_LIMIT < ((n + 1) ** 2 + n + 1) * item
  assert cholesky.max_n(torch.float64) >= 27
