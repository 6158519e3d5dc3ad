"""mjtpu_torch.ops.cholesky on the CPU: the plain twin against mjtpu's
per-env base rule (fused._base under jax.vmap) and against mjtpu's Pallas
kernel in interpret mode (as tests/test_ops.py runs it), plus the CPU
contract of the wrapper and the seam.  The CUDA kernel itself runs only on
the card: tests_cuda/ and chip_smoke.py hold it to the twin there."""

import pathlib
import re

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_size_dispatch_and_launch_geometry(dtype):
  """The main paths' and the zoo envs' n (REGISTER_WIDTHS: 2, 5, 6, 8, 9,
  12, 14, 23, 27) take the register kernel (an instance of each n), one warp an
  env, 4 a block; every other n up to max_n the shared one; past that none
  (tests_cuda: it raises on the card).  The n are the ones csrc/cholesky.cu
  instantiates."""
  assert cholesky.REGISTER_WIDTHS == (2, 5, 6, 8, 9, 12, 14, 23, 27)
  for n in cholesky.REGISTER_WIDTHS:
    assert cholesky.variant(n, dtype) == "register"
    assert cholesky.variants(n, dtype) == ("register", "shared")
    assert cholesky.launch_geometry(4096, n, dtype) == ("register", 1024, 128, 4)
    assert cholesky.launch_geometry(130, n, dtype, "shared") == ("shared", 33, 128, 4)
  for n in (1, 4, 7, 10, 11, 13, 15, 22, 24, 26, 28, 32, 33, 40, cholesky.max_n(dtype)):
    assert cholesky.variant(n, dtype) == "shared" and cholesky.variants(n, dtype) == ("shared",)
  # the shared kernel's block shrinks to what its shared memory allows
  big = cholesky.max_n(dtype)
  per = cholesky.SMEM_LIMIT // cholesky.smem_per_warp(big, dtype, "shared")
  assert 1 <= per < 4 and cholesky.launch_geometry(130, big, dtype) == (
      "shared", -(-130 // per), 32 * per, per)
  assert cholesky.variants(big + 1, dtype) == ()
  with pytest.raises(ValueError):
    cholesky.variant(big + 1, dtype)
  # the register kernel's staging: (n, n | 1) a warp
  assert cholesky.smem_per_warp(27, dtype, "register") == 27 * 27 * torch.finfo(dtype).bits // 8
  assert cholesky.smem_per_warp(23, dtype, "register") == 23 * 23 * torch.finfo(dtype).bits // 8
  src = (pathlib.Path(cholesky.__file__).parent.parent / "csrc" / cholesky.SOURCE).read_text()
  widths = re.search(r"#define MJTPU_CHOL_WIDTHS\(X\) (.*)", src).group(1)
  assert tuple(int(w) for w in re.findall(r"X\((\d+)\)", widths)) == cholesky.REGISTER_WIDTHS
  # a variant that cannot run an n is refused before any device check;
  # what can run it, on the CPU, is the twin
  for n in (24, 33):
    mat, rhs = (torch.as_tensor(x, dtype=dtype) for x in _batch(n, clamp=False))
    with pytest.raises(ValueError):
      cholesky.cholesky_solve(mat, rhs, kernel="register")
  mat, rhs = (torch.as_tensor(x, dtype=dtype) for x in _batch(27, clamp=False))
  want = cholesky.chol_solve_reference(mat, rhs)
  for kind in ("register", "shared"):
    assert torch.equal(cholesky.cholesky_solve(mat, rhs, kernel=kind), want)
  assert cholesky.launches == 0 and cholesky.variant_launches == {"register": 0, "shared": 0}
