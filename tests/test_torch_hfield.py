"""The port's height-field manifold twin (ops.hfield.manifold_reference)
against mjtpu: its jnp path (collision_hfield._manifold_jnp, vmapped) at
float64 to 1e-12, and its Pallas kernel (ops.hfield.manifold_batch in
interpret mode, as tests/test_hfield_kernel.py runs it) at float32 to
1e-5, both relative to the largest magnitude of each output.  Inputs are
seeded numpy windows and object poses for subgrids (0, 0) (two triangles),
(2, 2) (the humanoid_terrain groups') and (8, 8) (the cap), spheres and
capsules, and a flat window.

The Pallas comparison covers (0, 0) and (2, 2): compiling the interpret
mode of the (8, 8) kernel, whose 17 row bands are unrolled, takes about
50 s on the CPU.  Its f32 objects stay at least 5 cm above the surface,
near the window's centre: mjtpu's Pallas kernel forms a triangle's second
x coordinate as (x0 + c dx) + dx and its jnp path (which the port follows)
as x0 + (c + 1) dx, and the normal normalize(p - closest) divides that
rounding difference by the object's distance to the surface.

On a CPU tensor the wrapper runs the twin and counts no kernel launch; the
kernel itself is held to the twin on the card (tests_cuda/,
chip_smoke.py)."""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjtpu._src import collision_hfield as j_hfield
from mjtpu.ops import hfield as j_kernel
from mjtpu_torch.ops import hfield

torch.set_num_threads(1)

DX, DY = 0.37, 0.29
SUBGRIDS = [(0, 0), (2, 2), (8, 8)]
CASES = [(hy, hx, axis, flat) for hy, hx in SUBGRIDS for axis in (False, True)
         for flat in (False, True) if not flat or (hy, hx) == (2, 2)]
IDS = [f"{hy}x{hx}-{'capsule' if axis else 'sphere'}{'-flat' if flat else ''}"
       for hy, hx, axis, flat in CASES]
# one interpret-mode compile per case: the (2, 2) batches carry flat rows too
PALLAS_CASES = [(hy, hx, axis) for hy, hx in SUBGRIDS[:2] for axis in (False, True)]
PALLAS_IDS = [f"{hy}x{hx}-{'capsule' if axis else 'sphere'}" for hy, hx, axis in PALLAS_CASES]


def _inputs(hy, hx, has_axis, flat, n=24, seed=0, above=-0.05):
  """Windows (n, R, C) with heights in [0, 0.15] (0.05 everywhere when
  flat) around the origin, and objects over random points of the window,
  ``above`` to 0.25 above the highest height (below it when negative)."""
  rng = np.random.default_rng(seed + 100 * hy + 10 * has_axis + flat)
  rr, cc = 2 * hy + 2, 2 * hx + 2
  zwin = np.full((n, rr, cc), 0.05) if flat else rng.uniform(0.0, 0.15, (n, rr, cc))
  origin = rng.uniform(-0.2, 0.2, (n, 2)) - 0.5 * np.array([(cc - 1) * DX, (rr - 1) * DY])
  center = np.stack([
      origin[:, 0] + rng.uniform(0.1, 0.9, n) * (cc - 1) * DX,
      origin[:, 1] + rng.uniform(0.1, 0.9, n) * (rr - 1) * DY,
      zwin.max(axis=(1, 2)) + rng.uniform(above, 0.25, n),
  ], axis=1)
  if has_axis:
    ax = rng.normal(size=(n, 3))
    ax *= rng.uniform(0.05, 0.3, (n, 1)) / np.linalg.norm(ax, axis=1, keepdims=True)
    if above > 0:  # both ends above the surface
      ax[:, 2] = np.minimum(np.abs(ax[:, 2]), center[:, 2] - zwin.max(axis=(1, 2)) - above)
    a, b = center - ax, center + ax
  else:
    a = b = center
  r = rng.uniform(0.02, 0.12, n)
  return zwin, origin, a, b, r


def _twin(args, hy, hx, has_axis, dtype):
  t = [torch.as_tensor(x, dtype=dtype) for x in args]
  return [x.numpy() for x in hfield.manifold_reference(*t, hy, hx, DX, DY, has_axis)]


def _close(got, want, tol):
  for name, g, w in zip(("dist", "pos", "nrm"), got, want):
    w = np.asarray(w, dtype=np.float64)
    assert g.shape == w.shape, name
    scale = max(1.0, float(np.abs(w).max()))
    err = float(np.abs(g - w).max())
    assert err <= tol * scale, f"{name}: max abs err {err:.3e} (scale {scale:.3g})"


@pytest.mark.parametrize("hy, hx, has_axis, flat", CASES, ids=IDS)
def test_twin_matches_mjtpu_jnp_f64(hy, hx, has_axis, flat):
  args = _inputs(hy, hx, has_axis, flat)
  want = jax.vmap(lambda zw, og, aa, bb, rr: j_hfield._manifold_jnp(
      zw, og, aa, bb, rr, DX, DY, has_axis))(*(jnp.asarray(x) for x in args))
  _close(_twin(args, hy, hx, has_axis, torch.float64), want, 1e-12)


@pytest.mark.parametrize("hy, hx, has_axis", PALLAS_CASES, ids=PALLAS_IDS)
def test_twin_matches_mjtpu_pallas_f32(hy, hx, has_axis):
  args = _inputs(hy, hx, has_axis, False, above=0.05)
  if hy == 2:
    flat = _inputs(hy, hx, has_axis, True, above=0.05)
    args = [np.concatenate([x, y]) for x, y in zip(args, flat)]
  want = j_kernel.manifold_batch(*(jnp.asarray(x, jnp.float32) for x in args), hy, hx, DX, DY,
                                 has_axis, interpret=True)
  _close(_twin(args, hy, hx, has_axis, torch.float32), want, 1e-5)


def test_wrapper_runs_twin_on_cpu():
  """A CPU tensor reaches the twin, launches nothing, and the wrapper
  checks its arguments."""
  args = [torch.as_tensor(x) for x in _inputs(2, 2, True, False, n=5)]
  before = hfield.launches
  got = hfield.manifold_batch(*args, 2, 2, DX, DY, True)
  want = hfield.manifold_reference(*args, 2, 2, DX, DY, True)
  assert hfield.launches == before
  for g, w in zip(got, want):
    assert torch.equal(g, w)
  assert got[0].shape == (5, 4) and got[1].shape == got[2].shape == (5, 4, 3)
  with pytest.raises(ValueError):  # window shape disagrees with (hy, hx)
    hfield.manifold_batch(*args, 1, 2, DX, DY, True)
  with pytest.raises(TypeError):
    hfield.manifold_batch(args[0].float(), *args[1:], 2, 2, DX, DY, True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_size_dispatch_and_launch_geometry(dtype):
  """(2, 2), humanoid_terrain's subgrid, takes the static kernel (a thread
  a triangle: 5 instances of 50 triangles a 256-thread block); every other
  subgrid up to mjtpu's cap takes the shared one (a warp an instance, up to
  8 a block, fewer where one warp's shared memory is large).  The static
  subgrids are the ones csrc/hfield.cu instantiates."""
  assert hfield.variant(2, 2) == "static" and hfield.variants(2, 2) == ("static", "shared")
  assert hfield.launch_geometry(49152, 2, 2, dtype) == ("static", 9831, 256, 5)
  assert hfield.launch_geometry(1, 2, 2, dtype) == ("static", 1, 256, 5)
  for hy, hx in ((0, 0), (1, 1), (2, 3), (8, 8)):
    assert hfield.variant(hy, hx) == "shared" and hfield.variants(hy, hx) == ("shared",)
    per = min(8, hfield.SMEM_LIMIT // hfield.smem_per_warp(hy, hx, dtype))
    assert hfield.launch_geometry(130, hy, hx, dtype) == ("shared", -(-130 // per), 32 * per, per)
  # (8, 8) at f64: 34,960 bytes a warp, so 6 warps a block
  assert hfield.launch_geometry(130, 8, 8, torch.float64)[3] == 6
  assert hfield.launch_geometry(130, 2, 2, dtype, "shared") == ("shared", 17, 256, 8)
  src = (pathlib.Path(hfield.__file__).parent.parent / "csrc" / hfield.SOURCE).read_text()
  grids = re.search(r"#define MJTPU_HFIELD_SUBGRIDS\(X\) (.*)", src).group(1)
  assert tuple(tuple(map(int, m)) for m in re.findall(r"X\((\d+), (\d+)\)", grids)) \
      == hfield.STATIC_SUBGRIDS
  # a variant that cannot run a subgrid is refused before any device check
  args = [torch.as_tensor(x, dtype=dtype) for x in _inputs(1, 1, True, False, n=3)]
  with pytest.raises(ValueError):
    hfield.manifold_batch(*args, 1, 1, DX, DY, True, kernel="static")


def test_empty_rounds_and_suppression():
  """(0, 0) gives two triangles: a sphere over a flat cell's diagonal has
  one contact point for both (suppressed as a duplicate), so rounds 2-4
  are empty: dist 1, pos 0, normal +z."""
  zwin = torch.zeros((1, 2, 2), dtype=torch.float64)
  origin = torch.zeros((1, 2), dtype=torch.float64)
  p = torch.tensor([[0.5 * DX, 0.5 * DY, 0.1]], dtype=torch.float64)
  dist, pos, nrm = hfield.manifold_batch(
      zwin, origin, p, p, torch.tensor([0.05], dtype=torch.float64), 0, 0, DX, DY, False)
  np.testing.assert_allclose(dist[0].numpy(), [0.05, 1.0, 1.0, 1.0], rtol=0, atol=1e-15)
  np.testing.assert_allclose(pos[0, 0].numpy(), [0.5 * DX, 0.5 * DY, 0.025], atol=1e-15)
  assert torch.equal(pos[0, 1:], torch.zeros(3, 3, dtype=torch.float64))
  assert torch.equal(nrm[0, :, 2], torch.ones(4, dtype=torch.float64))
