"""The port's SAT winners twin (ops.sat.sat_winners_reference) and its box
colliders against mjtpu on the CPU.

  * the twin against mjtpu's jnp path (collision_convex._sat_winners_jnp,
    vmapped) at float64: winner indices exact, separations to 1e-12, on
    random poses of box-box pairs with equal and with unequal sizes and of
    a box against one of humanoid_terrain's 6-vertex rock hulls;
  * the twin against mjtpu's Pallas kernel (ops.sat.sat_winners_batch in
    interpret mode, as tests/test_sat_kernel.py runs it) at float32 on
    random poses: indices exact, separations to 1e-6;
  * convex_convex, plane_convex and sphere_convex on box hulls against
    mjtpu at float64 to 1e-10 on aligned, stacked and edge-edge poses, and
    _manifold_points on identical candidate sets.  (On random poses the
    manifold picks among points whose areas tie exactly in exact
    arithmetic, so ULP differences may permute its slots; the SAT winners
    that decide the contact are held exactly above.)

Inputs are made with numpy from a seed.  On a CPU tensor the wrapper runs
the twin and counts no kernel launch; the kernel itself is held to the
twin on the card (tests_cuda/, chip_smoke.py).
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjtpu._src import collision_convex as j_convex
from mjtpu._src import mesh as j_mesh
from mjtpu.ops import sat as j_sat
import mjtpu_torch
from mjtpu_torch._src import collision_convex as t_convex
from mjtpu_torch._src import io
from mjtpu_torch._src import mesh as t_mesh
from mjtpu_torch.ops import sat

torch.set_num_threads(1)

SIZES = {"box": (0.08, 0.08, 0.08), "box_unequal": (0.1, 0.15, 0.2), "box_flat": (0.12, 0.1, 0.08)}


def _rock():
  """A 6-vertex rock hull of humanoid_terrain (mjtpu's tables, as the
  committed snapshot stores them)."""
  ns = mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / "humanoid_terrain_model.npz")
  return next(h for h in ns.mesh_convex if h is not None)


HULL_PAIRS = {
    "box_box_equal": lambda: (j_mesh.box(np.array(SIZES["box"])),) * 2,
    "box_box_unequal": lambda: (j_mesh.box(np.array(SIZES["box_unequal"])),
                                j_mesh.box(np.array(SIZES["box_flat"]))),
    "box_rock": lambda: (j_mesh.box(np.array(SIZES["box_unequal"])), _rock()),
}


def _rot(rng, n):
  q = rng.normal(size=(n, 4))
  q /= np.linalg.norm(q, axis=1, keepdims=True)
  w, x, y, z = q.T
  return np.stack([
      1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
      2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
      2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
  ], axis=1).reshape(n, 3, 3)


def _random_poses(seed, n, sep):
  rng = np.random.default_rng(seed)
  pos1 = rng.uniform(-0.05, 0.05, (n, 3))
  pos2 = rng.uniform(-0.05, 0.05, (n, 3)) + [sep, 0.0, 0.0]
  return pos1, _rot(rng, n), pos2, _rot(rng, n)


def _jnp_winners(poses, h1, h2):
  return [np.asarray(x) for x in jax.vmap(
      lambda a, b, c, d: j_convex._sat_winners_jnp(a, b, c, d, h1, h2))(*map(jnp.asarray, poses))]


def _sat_hulls(h1, h2, dtype):
  return sat.sat_hull(h1, dtype, "cpu"), sat.sat_hull(h2, dtype, "cpu")


def test_box_hull_matches_mjtpu():
  """mesh.box builds mjtpu's tables, table by table (their order decides
  SAT ties)."""
  for size in SIZES.values():
    want, got = j_mesh.box(np.array(size)), t_mesh.box(np.array(size))
    for f in io.HULL_FIELDS:
      np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


@pytest.mark.parametrize("sep", [0.05, 0.3], ids=["overlapping", "apart"])
@pytest.mark.parametrize("pair", list(HULL_PAIRS))
def test_twin_matches_mjtpu_jnp_f64(pair, sep):
  h1, h2 = HULL_PAIRS[pair]()
  poses = _random_poses(hash((pair, sep)) % 2**31, 200, sep)
  want_seps, want_idx = _jnp_winners(poses, h1, h2)
  seps, idx = sat.sat_winners_reference(*map(torch.as_tensor, poses),
                                        *_sat_hulls(h1, h2, torch.float64))
  np.testing.assert_array_equal(idx.numpy(), want_idx)
  np.testing.assert_allclose(seps.numpy(), want_seps, rtol=0, atol=1e-12)


@pytest.mark.parametrize("pair", list(HULL_PAIRS))
def test_twin_matches_mjtpu_pallas_f32(pair):
  """Against the Pallas kernel in interpret mode (one compile a pair; the
  batch holds overlapping and separated pairs, 130 instances: not a
  multiple of its 128-lane tile)."""
  h1, h2 = HULL_PAIRS[pair]()
  a = _random_poses(11, 65, 0.05)
  b = _random_poses(12, 65, 0.3)
  poses = [np.concatenate([x, y]).astype(np.float32) for x, y in zip(a, b)]
  want_seps, want_idx = j_sat.sat_winners_batch(*map(jnp.asarray, poses), h1, h2, interpret=True)
  seps, idx = sat.sat_winners_reference(*map(torch.as_tensor, poses),
                                        *_sat_hulls(h1, h2, torch.float32))
  np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
  np.testing.assert_allclose(seps.numpy(), np.asarray(want_seps), rtol=1e-5, atol=1e-6)


def test_wrapper_runs_twin_on_cpu():
  h1, h2 = HULL_PAIRS["box_box_unequal"]()
  poses = [torch.as_tensor(x) for x in _random_poses(3, 17, 0.05)]
  hulls = _sat_hulls(h1, h2, torch.float64)
  before = sat.launches
  got = sat.sat_winners_batch(*poses, *hulls)
  want = sat.sat_winners_reference(*poses, *hulls)
  assert sat.launches == before
  assert all(torch.equal(g, w) for g, w in zip(got, want))
  with pytest.raises(TypeError):
    sat.sat_winners_batch(*(p.float() for p in poses), *hulls)
  with pytest.raises(ValueError):
    sat.sat_winners_batch(poses[0][:3], *poses[1:], *hulls)


def _house():
  """A box with a pyramid roof: (nv, nf, ne) = (9, 9, 16), just past the
  static kernel's sizes."""
  corners = [[x, y, z] for x in (-0.1, 0.1) for y in (-0.1, 0.1) for z in (-0.1, 0.1)]
  return t_mesh.convex(np.array(corners + [[0.0, 0.0, 0.2]]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_size_dispatch_and_launch_geometry(dtype):
  """Boxes and rock hulls, in either place, take the static kernel (16
  lanes an instance, 8 instances a 128-thread block); a hull past their
  sizes takes the shared one (a warp an instance, up to 8 a block, fewer
  where one warp's shared memory is large), and one too large for a block
  still raises on the card (tests_cuda).  The static sizes are the ones
  csrc/sat.cu instantiates."""
  box = sat.sat_hull(t_mesh.box(np.array(SIZES["box_unequal"])), dtype, "cpu")
  rock = sat.sat_hull(_rock(), dtype, "cpu")
  house = sat.sat_hull(_house(), dtype, "cpu")
  assert sat.hull_sizes(box) == (8, 6, 12) and sat.hull_sizes(rock) == (6, 8, 12)
  assert sat.hull_sizes(house) == (9, 9, 16)
  for h1, h2 in ((box, box), (box, rock), (rock, box), (rock, rock)):
    assert sat.variant(h1, h2) == "static" and sat.variants(h1, h2) == ("static", "shared")
    assert sat.launch_geometry(491520, h1, h2, dtype) == ("static", 61440, 128, 8)
    assert sat.launch_geometry(130, h1, h2, dtype) == ("static", 17, 128, 8)
  for h1, h2 in ((box, house), (house, rock)):
    assert sat.variant(h1, h2) == "shared" and sat.variants(h1, h2) == ("shared",)
    assert sat.launch_geometry(130, h1, h2, dtype) == ("shared", 17, 256, 8)
  # the shared kernel's block shrinks to what its shared memory allows
  big = sat.SatHull(torch.zeros(4000, 3, dtype=dtype), *box[1:])
  per = sat.SMEM_LIMIT // sat.smem_per_warp(big, box, dtype)
  assert 1 <= per < 8
  assert sat.launch_geometry(130, big, box, dtype) == ("shared", -(-130 // per), 32 * per, per)
  assert sat.launch_geometry(130, box, box, dtype, "shared") == ("shared", 17, 256, 8)
  src = (pathlib.Path(sat.__file__).parent.parent / "csrc" / sat.SOURCE).read_text()
  hulls = re.search(r"#define MJTPU_SAT_HULLS\(X\) (.*)", src).group(1)
  assert tuple(tuple(map(int, m)) for m in re.findall(r"X\((\d+), (\d+), (\d+)\)", hulls)) \
      == sat.STATIC_HULLS
  # a variant that cannot run a pair is refused before any device check
  poses = [torch.as_tensor(x, dtype=dtype) for x in _random_poses(4, 3, 0.05)]
  with pytest.raises(ValueError):
    sat.sat_winners_batch(*poses, box, house, kernel="static")
  got = sat.sat_winners_batch(*poses, box, rock, kernel="shared")  # the twin on the CPU
  assert all(torch.equal(g, w) for g, w in zip(got, sat.sat_winners_reference(*poses, box, rock)))


def _axis_mat(axis, angle):
  axis = np.asarray(axis, dtype=np.float64) / np.linalg.norm(axis)
  k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
  return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k


def _structured_poses():
  """Box-box poses (pos1, mat1, pos2, mat2), hull 1 at the origin: aligned
  side by side and stacked, each without and with small sideways offsets
  (without them, mjtpu orients the edge axes perpendicular to the centre
  line by sign(0) = 0 and those zero axes win at separation 0: no
  contact), stacked with a yaw, and edge across edge."""
  eye = np.eye(3)
  edge1 = _axis_mat((0, 1, 0), np.pi / 4)
  edge2 = _axis_mat((0, 0, 1), np.pi / 6) @ _axis_mat((1, 0, 0), np.pi / 4)
  reach = 0.08 * np.sqrt(2.0)
  cases = [
      ((0.159, 0.0, 0.0), eye, eye),
      ((0.159, 0.01, 0.0005), eye, eye),
      ((0.0, 0.0, 0.159), eye, eye),
      ((0.01, 0.005, 0.159), eye, eye),
      ((0.02, -0.01, 0.1585), eye, _axis_mat((0, 0, 1), 0.3)),
      ((0.0, 0.0, 2 * reach - 0.001), edge1, edge2),
      ((0.003, -0.002, 2 * reach - 0.002), edge1, edge2),
  ]
  pos2 = np.array([c[0] for c in cases])
  return np.zeros_like(pos2), np.stack([c[1] for c in cases]), pos2, np.stack([c[2] for c in cases])


def _compare(got, want, what, tol=1e-10):
  for name, g, w in zip(("dist", "pos", "frame"), got, want):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=tol, err_msg=f"{what} {name}")


def test_convex_convex_structured_poses():
  size = np.array(SIZES["box"])
  hj = j_mesh.box(size)
  ht = t_convex.hull_consts(t_mesh.box(size), torch.float64, "cpu")
  poses = _structured_poses()
  want = jax.vmap(lambda a, b, c, d: j_convex.convex_convex(a, b, None, c, d, None, hj, hj))(
      *map(jnp.asarray, poses))
  got = t_convex.convex_convex(*(torch.as_tensor(x) for x in poses[:2]), None,
                               *(torch.as_tensor(x) for x in poses[2:]), None, ht, ht)
  _compare(got, want, "convex_convex")
  dist = np.asarray(want[0])
  # the centres differing along one axis only (poses 0 and 2) are mjtpu's
  # zero-axis case: no contact; every other pose touches
  np.testing.assert_array_equal((dist < 0).any(axis=1), [False, True, False, True, True, True, True])
  assert (dist[-2:, 1:] == 1.0).all() and (dist[-2:, 0] < 0).all()  # edge-edge: one slot


def test_plane_and_sphere_against_box():
  """plane_convex (the 4 deepest corners; a flat box ties them exactly)
  and sphere_convex on the box hull's quad faces."""
  size = np.array(SIZES["box_unequal"])
  hj = j_mesh.box(size)
  ht = t_convex.hull_consts(t_mesh.box(size), torch.float64, "cpu")
  rng = np.random.default_rng(5)
  n = 40
  mats = np.concatenate([np.tile(np.eye(3), (n // 2, 1, 1)), _rot(rng, n // 2)])
  box_pos = rng.uniform(-0.3, 0.3, (n, 3))
  plane = (np.zeros((n, 3)), np.tile(np.eye(3), (n, 1, 1)), box_pos, mats)
  sphere = (box_pos + rng.uniform(-0.3, 0.3, (n, 3)), np.tile(np.eye(3), (n, 1, 1)),
            box_pos, mats)
  size1 = np.full((n, 3), 0.09)
  for fn, poses, what in ((j_convex.plane_convex, plane, "plane_convex"),
                          (j_convex.sphere_convex, sphere, "sphere_convex")):
    want = jax.vmap(lambda a, b, s, c, d: fn(a, b, s, c, d, None, hj))(
        *map(jnp.asarray, poses[:2] + (size1,) + poses[2:]))
    t_fn = getattr(t_convex, what)
    t = lambda x: torch.as_tensor(x)
    got = t_fn(t(poses[0]), t(poses[1]), t(size1), t(poses[2]), t(poses[3]), None, ht)
    _compare(got, want, what)


def test_manifold_points_matches_mjtpu():
  """_manifold_points on identical candidates: 24 points on a face-like
  patch with exact duplicates and coincident pairs, random masks."""
  rng = np.random.default_rng(9)
  n, k = 50, 24
  pts = rng.uniform(-0.1, 0.1, (n, k, 3))
  pts[:, :, 2] *= 0.01
  pts[:, 5] = pts[:, 3]            # exact duplicates
  pts[:, 7] = pts[:, 2] + 1e-8     # coincident within the 1e-12 squared gap
  mask = rng.random((n, k)) < 0.7
  mask[:10] = False
  mask[:10, :2] = True             # two valid points only: slots 2, 3 are duplicates
  depth = rng.uniform(-0.01, 0.01, (n, k))
  nrm = np.tile([0.0, 0.0, 1.0], (n, 1))
  want = jax.vmap(lambda p, m, d, nn: j_convex._manifold_points(p, m, d, nn, jnp.float64))(
      *map(jnp.asarray, (pts, mask, depth, nrm)))
  got = t_convex._manifold_points(*map(torch.as_tensor, (pts, mask, depth, nrm)))
  for g, w in zip(got, want):
    np.testing.assert_array_equal(g.numpy(), np.asarray(w))
  assert np.asarray(want[1])[:10, 2:].all()
