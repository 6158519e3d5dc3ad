"""The Hopper kernels (Cholesky, height-field manifold, SAT winners, tree-
sparse LDL) against their plain twins, and the port's step on the card
against the same step on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
import mjtpu_torch
from mjtpu_torch._src import mesh, sparse
from mjtpu_torch.ops import cholesky, fused, hfield, ldl, sat

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


@pytest.mark.parametrize("clamp", [False, True], ids=["spd", "clamped"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2, 5, 6, 8, 9, 12, 14, 23, 27, 32, 33, 40])
def test_chol_variants_match_twin(n, dtype, clamp):
  """Every variant that can run an n (the register kernel at the main
  paths' and the zoo envs' n, 2, 5, 6, 8, 9, 12, 14, 23 and 27; the shared
  kernel everywhere) within phase 3's
  tolerance of the twin, the register kernel equal to the shared one bit
  for bit, launches counted by variant."""
  gen = torch.Generator(device="cuda").manual_seed(n)
  mat, rhs = chip_smoke._spd(n, 130, dtype, gen, clamp)
  ref = cholesky.chol_solve_reference(mat, rhs)
  assert cholesky.variant(n, dtype) == ("register" if n in cholesky.REGISTER_WIDTHS else "shared")
  got = {}
  for kind in cholesky.variants(n, dtype):
    before = dict(cholesky.variant_launches)
    got[kind] = x = cholesky.cholesky_solve(mat, rhs, kernel=kind)
    torch.cuda.synchronize()
    assert cholesky.variant_launches == {**before, kind: before[kind] + 1}
    assert bool(torch.isfinite(x).all())
    limit = 1e-6 if clamp and dtype == torch.float64 else (
        1e-10 if dtype == torch.float64 else 1e-4)
    assert float((x - ref).abs().max()) <= limit * float(ref.abs().max()), kind
  first = got[cholesky.variant(n, dtype)]
  for kind, x in got.items():
    assert torch.equal(_bits(x), _bits(first)), (kind, _bit_diff(x, first))


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
  for n in (24, 33):  # no register kernel for an n it is not instantiated for
    with pytest.raises(ValueError):
      cholesky.cholesky_solve(*_spd(2, n, torch.float64), kernel="register")
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


_bits = chip_smoke._bits


def _bit_diff(got, want) -> str:
  """Where got and want differ in bits: the count, whether they differ in
  value too, and the first few entries (index, got, want)."""
  diff = (_bits(got) != _bits(want)).nonzero().tolist()
  first = [(i, float(got[tuple(i)]), float(want[tuple(i)])) for i in diff[:4]]
  return (f"{len(diff)} entries differ in bits, values equal: {torch.equal(got, want)};"
          f" first (index, got, want): {first}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("hy, hx", [(1, 1), (2, 2), (2, 3)])
@pytest.mark.parametrize("has_axis", [False, True], ids=["sphere", "capsule"])
def test_hfield_variants_match_twin_bit_for_bit(has_axis, hy, hx, dtype):
  """At the size dispatch's boundary: (2, 2) takes the static kernel, its
  neighbours (1, 1) and (2, 3) the shared one; every variant that can run
  a subgrid equals the twin bit for bit, on random and flat windows."""
  assert hfield.variant(hy, hx) == ("static" if (hy, hx) == (2, 2) else "shared")
  for flat in (False, True):
    args = _windows(2000, hy, hx, has_axis, dtype, flat, seed=hy + 3 * hx)
    want = hfield.manifold_reference(*args, hy, hx, 0.37, 0.29, has_axis)
    for kind in hfield.variants(hy, hx):
      before = dict(hfield.variant_launches)
      got = hfield.manifold_batch(*args, hy, hx, 0.37, 0.29, has_axis, kernel=kind)
      torch.cuda.synchronize()
      assert hfield.variant_launches == {**before, kind: before[kind] + 1}
      for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w)), (kind, flat, _bit_diff(g, w))


def test_hfield_refusals():
  args = _windows(4, 9, 9, True, torch.float64)
  with pytest.raises(ValueError):  # past the kernel's static bound
    hfield.manifold_batch(*args, 9, 9, 0.37, 0.29, True)
  args = _windows(4, 2, 2, True, torch.float64)
  with pytest.raises(ValueError):  # mixed devices
    hfield.manifold_batch(args[0], args[1].cpu(), *args[2:], 2, 2, 0.37, 0.29, True)
  args = _windows(4, 1, 1, True, torch.float64)
  with pytest.raises(ValueError):  # no static kernel for (1, 1)
    hfield.manifold_batch(*args, 1, 1, 0.37, 0.29, True, kernel="static")


def _rot(n, dtype, gen):
  q = torch.randn(n, 4, generator=gen, device="cuda", dtype=dtype)
  w, x, y, z = (q / q.norm(dim=1, keepdim=True)).unbind(1)
  return torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                      2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                      2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                     1).reshape(n, 3, 3)


def _sat_poses(kind, n, dtype, seed=0):
  """Box (0.1, 0.15, 0.2) and box (0.12, 0.1, 0.08) poses: random; axis-
  aligned, 1 mm into each other along x, half of them with sideways
  offsets; or stacked along z with a yaw."""
  gen = torch.Generator(device="cuda").manual_seed(seed)
  u = lambda *shape: torch.rand(*shape, generator=gen, device="cuda", dtype=dtype)
  pos1 = u(n, 3) - 0.5
  eye = torch.eye(3, dtype=dtype, device="cuda").expand(n, 3, 3).contiguous()
  if kind == "random":
    return pos1, _rot(n, dtype, gen), pos1 + 0.3 * u(n, 3) - 0.15, _rot(n, dtype, gen)
  if kind == "aligned":
    step = torch.tensor([0.219, 0.0, 0.0], dtype=dtype, device="cuda")
    side = torch.where(u(n, 1) < 0.5, 0.0, 1.0) * 0.01 * u(n, 3) * torch.tensor(
        [0.0, 1.0, 1.0], dtype=dtype, device="cuda")
    return pos1, eye, pos1 + step + side, eye
  yaw = u(n)
  c, s, z, o = torch.cos(yaw), torch.sin(yaw), torch.zeros_like(yaw), torch.ones_like(yaw)
  lift = torch.stack([0.02 * u(n) - 0.01, 0.02 * u(n) - 0.01, 0.279 * o], 1)
  return pos1, eye, pos1 + lift, torch.stack([c, -s, z, s, c, z, z, z, o], 1).reshape(n, 3, 3)


def _box_hulls(dtype):
  return (sat.sat_hull(mesh.box(np.array([0.1, 0.15, 0.2])), dtype, "cuda"),
          sat.sat_hull(mesh.box(np.array([0.12, 0.1, 0.08])), dtype, "cuda"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["random", "aligned", "stacked"])
@pytest.mark.parametrize("n", [1, 130, 20000])
def test_sat_kernel_matches_twin(n, kind, dtype):
  """The kernel repeats the twin's operations in its order, without
  contracted multiply-adds: winners and separations agree exactly."""
  poses = _sat_poses(kind, n, dtype)
  hulls = _box_hulls(dtype)
  before = sat.launches
  seps, idx = sat.sat_winners_batch(*poses, *hulls)
  want_seps, want_idx = sat.sat_winners_reference(*poses, *hulls)
  torch.cuda.synchronize()
  assert sat.launches == before + 1
  assert torch.equal(idx, want_idx) and torch.equal(seps, want_seps)


def _house():
  """A box with a pyramid roof: (nv, nf, ne) = (9, 9, 16), just past the
  static kernel's sizes."""
  corners = [[x, y, z] for x in (-0.1, 0.1) for y in (-0.1, 0.1) for z in (-0.1, 0.1)]
  return mesh.convex(np.array(corners + [[0.0, 0.0, 0.2]]))


SAT_PAIRS = {
    "box-box": lambda: (mesh.box(np.array([0.1, 0.15, 0.2])),
                        mesh.box(np.array([0.12, 0.1, 0.08]))),
    "box-rock": lambda: (mesh.box(np.array([0.1, 0.15, 0.2])), chip_smoke._rock_hull()),
    "rock-box": lambda: (chip_smoke._rock_hull(), mesh.box(np.array([0.1, 0.15, 0.2]))),
    "box-house": lambda: (mesh.box(np.array([0.1, 0.15, 0.2])), _house()),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("pair", list(SAT_PAIRS))
def test_sat_variants_match_twin_bit_for_bit(pair, dtype):
  """At the size dispatch's boundary: boxes and rock hulls take the static
  kernel, a hull just past their sizes the shared one; every variant that
  can run a pair equals the twin bit for bit on random, aligned and
  stacked poses."""
  h1, h2 = SAT_PAIRS[pair]()
  hulls = (sat.sat_hull(h1, dtype, "cuda"), sat.sat_hull(h2, dtype, "cuda"))
  assert sat.variant(*hulls) == ("shared" if pair == "box-house" else "static")
  gen = torch.Generator(device="cuda").manual_seed(7)
  for poses_kind in ("random", "aligned", "stacked"):
    poses = chip_smoke._sat_poses(poses_kind, 3000, h1, h2, dtype, gen)
    want = sat.sat_winners_reference(*poses, *hulls)
    for kind in sat.variants(*hulls):
      before = dict(sat.variant_launches)
      got = sat.sat_winners_batch(*poses, *hulls, kernel=kind)
      torch.cuda.synchronize()
      assert sat.variant_launches == {**before, kind: before[kind] + 1}
      for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w)), (kind, poses_kind, _bit_diff(g, w))


def test_sat_refusals():
  poses = _sat_poses("random", 8, torch.float64)
  hulls = _box_hulls(torch.float64)
  # 10,000 vertices: past one warp's share of a block's shared memory
  big = sat.SatHull(torch.zeros(10000, 3, dtype=torch.float64, device="cuda"), *hulls[0][1:])
  assert sat.smem_per_warp(big, hulls[1], torch.float64) > sat.SMEM_LIMIT
  before = sat.launches
  with pytest.raises(ValueError):  # past the kernel's static bound: never the twin
    sat.sat_winners_batch(*poses, big, hulls[1])
  with pytest.raises(ValueError):  # mixed devices
    sat.sat_winners_batch(poses[0].cpu(), *poses[1:], *hulls)
  with pytest.raises(TypeError):  # mixed dtypes
    sat.sat_winners_batch(poses[0].float(), *poses[1:], *hulls)
  house = sat.sat_hull(_house(), torch.float64, "cuda")
  with pytest.raises(ValueError):  # no static kernel for the house's sizes
    sat.sat_winners_batch(*poses, hulls[0], house, kernel="static")
  assert sat.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("tree", ["branchy66", "branchy38", "chain40", "random100"])
@pytest.mark.parametrize("batch, massless", [(1, False), (130, False), (4096, False),
                                             (130, True)])
def test_ldl_kernel_matches_twin(batch, massless, tree, dtype):
  """Each entry point equals its twin bit for bit (--fmad=false, the same
  per-target order), massless dofs (pivots at the MINVAL floor) included."""
  parent = chip_smoke.ldl_trees()[tree]
  t = sparse.device_tables(sparse._build(len(parent), parent), dtype, "cuda")
  gen = torch.Generator(device="cuda").manual_seed(batch)
  mc, rhs, _ = chip_smoke.chain_pattern_batch(t, batch, dtype, gen, massless)
  S = ldl.ldl_factor_reference(t, mc)
  if massless:
    assert bool((S[:, :, -1] == sparse.MINVAL).any())
  before = dict(ldl.launches)
  for name, (kernel, twin) in chip_smoke.ldl_calls().items():
    got, want = kernel(t, mc, rhs, S), twin(t, mc, rhs, S)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, want), (name, float((got - want).abs().max()))
  assert ldl.launches == {k: v + 1 for k, v in before.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("tree", ["branchy66", "branchy38", "chain40", "random100"])
def test_ldl_variants_match_twin_bit_for_bit(tree, dtype):
  """Both variants (lanes and shared), each of the three entry points,
  equal to the twin bit for bit, massless dofs (pivots at the MINVAL
  floor) included; launches counted by entry point and variant."""
  parent = chip_smoke.ldl_trees()[tree]
  t = sparse.device_tables(sparse._build(len(parent), parent), dtype, "cuda")
  assert ldl.variant(t, dtype) == "lanes" and ldl.variants(t, dtype) == ("lanes", "shared")
  gen = torch.Generator(device="cuda").manual_seed(len(parent))
  for massless in (False, True):
    mc, rhs, _ = chip_smoke.chain_pattern_batch(t, 130, dtype, gen, massless)
    S = ldl.ldl_factor_reference(t, mc)
    assert bool((S[:, :, -1] == sparse.MINVAL).any()) == massless
    for name, (kernel, twin) in chip_smoke.ldl_calls().items():
      want = twin(t, mc, rhs, S)
      for kind in ("lanes", "shared"):
        before = {k: dict(v) for k, v in ldl.variant_launches.items()}
        got = kernel(t, mc, rhs, S, kind)
        torch.cuda.synchronize()
        assert ldl.variant_launches[name] == {**before[name], kind: before[name][kind] + 1}
        assert torch.equal(_bits(got), _bits(want)), (name, kind, massless,
                                                      _bit_diff(got, want))


def test_ldl_refusals():
  parent = chip_smoke.ldl_trees()["branchy66"]
  t = sparse.device_tables(sparse._build(len(parent), parent), torch.float64, "cuda")
  mc, rhs, _ = chip_smoke.chain_pattern_batch(t, 8, torch.float64,
                                              torch.Generator(device="cuda").manual_seed(0))
  before = dict(ldl.launches)
  with pytest.raises(ValueError):  # not contiguous
    ldl.ldl_solve(t, mc, rhs.t().contiguous().t())
  with pytest.raises(ValueError):  # mixed devices
    ldl.ldl_factor_solve(t, mc, rhs.cpu())
  with pytest.raises(TypeError):  # mixed dtypes
    ldl.ldl_solve(t, mc, rhs.float())
  with pytest.raises(TypeError):  # f64 tables, f32 tensors: offsets in another unit
    ldl.ldl_factor_solve(t, mc.float(), rhs.float(), kernel="lanes")
  # past the static bound (one env's factor in a block's shared memory):
  # a tree of nv = 200, depth 200 at f64; raised before any launch
  big = dataclasses.replace(t, structure=t.structure._replace(nv=200, depth=200))
  assert ldl.smem_per_warp(200, 200, torch.float64) > ldl.SMEM_LIMIT
  with pytest.raises(ValueError, match="static bound"):
    ldl.ldl_factor(big, torch.zeros(1, 200, 200, dtype=torch.float64, device="cuda"))
  # past the lane schedule's fields (no lane schedule built) only the
  # shared kernel runs a tree; forcing the lanes kernel is refused
  wide = dataclasses.replace(t, structure=t.structure._replace(nv=100, depth=100), lanes=None)
  assert ldl.variants(wide, torch.float64) == ("shared",)
  with pytest.raises(ValueError):
    ldl.ldl_factor(wide, torch.zeros(1, 100, 100, dtype=torch.float64, device="cuda"),
                   kernel="lanes")
  assert ldl.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("pair", ["cylinder-box", "cylinder-cylinder", "ellipsoid-box",
                                  "ellipsoid-ellipsoid"])
def test_sat_round_hulls_match_twin_bit_for_bit(pair, dtype):
  """The round hulls (mjtpu's inscribed cylinder and ellipsoid hulls, from
  the committed snapshots) take the shared kernel by the size dispatch,
  and it equals the twin bit for bit on random, aligned and stacked poses
  at n = 4096, the cylinder drop's batch."""
  h1, h2 = chip_smoke.round_hull_pairs()[pair]
  hulls = (sat.sat_hull(h1, dtype, "cuda"), sat.sat_hull(h2, dtype, "cuda"))
  assert sat.variant(*hulls) == "shared" and sat.variants(*hulls) == ("shared",)
  gen = torch.Generator(device="cuda").manual_seed(11)
  for poses_kind in ("random", "aligned", "stacked"):
    poses = chip_smoke._sat_poses(poses_kind, 4096, h1, h2, dtype, gen)
    want = sat.sat_winners_reference(*poses, *hulls)
    for kernel in ("shared", None):  # the variant forced, and the dispatch's
      before = dict(sat.variant_launches)
      got = sat.sat_winners_batch(*poses, *hulls, kernel=kernel)
      torch.cuda.synchronize()
      assert sat.variant_launches == {**before, "shared": before["shared"] + 1}
      for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w)), (kernel, poses_kind, _bit_diff(g, w))


def _model(name, device):
  ns = mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / f"{name}_model.npz")
  if name == "boxes":  # a cap on Newton's loops, as before they left early
    ns.opt.iterations = ns.opt.ls_iterations = 10
  return mjtpu_torch.model_from_arrays(ns, device=device)


# per step: Cholesky launches besides one per Newton iteration, height-field,
# SAT and LDL launches
@pytest.mark.parametrize("name, steps, per_step, tol", [
    ("humanoid_bench", 3, (0, 0, 0, 0), 1e-9),
    ("humanoid_terrain", 3, (0, 2, 0, 0), 1e-9),
    # CG amplifies the rounding differences of the two devices (the CPU
    # test's step-1 solve bound)
    ("scene_pile", 1, (0, 0, 1, 0), 1e-3),
    ("boxes", 3, (0, 0, 1, 0), 1e-9),
    ("branchy66", 3, (0, 0, 0, 3), 1e-9),
    # Euler's damping solve takes B1 too
    ("ant_bench", 3, (1, 0, 0, 0), 1e-9),
    # the cylinder on the box: SAT on the round hull, one launch a step
    ("cylinder_drop", 3, (0, 0, 1, 0), 1e-9),
    ("roll", 3, (0, 0, 0, 0), 1e-9),
    # one step: the truncated linesearch may take another iterate path on
    # another device within a few (ROADMAP C7)
    ("humanoid_bench_elliptic", 1, (0, 0, 0, 0), 1e-9),
])
def test_step_on_cuda_matches_cpu(name, steps, per_step, tol):
  """Steps on the card against the same steps on the CPU, with the
  kernels' launch counts per step (one Cholesky per Newton iteration, the
  solver leaving once no env runs on, and ant's damping solve; one per
  height-field group for the manifold, one per box-box group for SAT, one
  per entry point for LDL); sensordata too."""
  from mjtpu_torch._src import solver

  golden = np.load(mjtpu_torch.ASSETS / f"{name}_golden.npz") if name != "boxes" else None
  out = {}
  for device in ("cpu", "cuda"):
    m = _model(name, device)
    d = mjtpu_torch.make_data(m, batch_size=4)
    if golden is not None:
      d = mjtpu_torch.replace(d, qpos=torch.as_tensor(golden["qpos0"], device=device))
    if golden is not None and "ctrl" in golden:
      d = mjtpu_torch.replace(d, ctrl=torch.as_tensor(golden["ctrl"], device=device))
    if name == "boxes":  # dropped onto the floor and each other
      qpos = d.qpos.clone()
      qpos[:, 2] -= 0.125
      qpos[:, 9] -= 0.2
      qpos[:, 16] -= 0.335
      d = mjtpu_torch.replace(d, qpos=qpos)
    if golden is not None and "qvel0" in golden:
      d = mjtpu_torch.replace(d, qvel=torch.as_tensor(golden["qvel0"], device=device))
    before = cholesky.launches, hfield.launches, sat.launches, sum(ldl.launches.values())
    newton = solver.loop_counts["iterations"]
    for _ in range(steps):
      d = mjtpu_torch.step(m, d)
    iterations = solver.loop_counts["iterations"] - newton
    if m.opt.solver != mjtpu_torch.SolverType.NEWTON:
      iterations = 0
    counts = (cholesky.launches - before[0] - (iterations if device == "cuda" else 0),
              hfield.launches - before[1], sat.launches - before[2],
              sum(ldl.launches.values()) - before[3])
    out[device] = (d.qacc.cpu().numpy(), counts, d.sensordata.cpu().numpy())
  assert out["cpu"][1] == (0, 0, 0, 0)
  assert out["cuda"][1] == tuple(steps * k for k in per_step)
  for k in (0, 2):
    np.testing.assert_allclose(out["cuda"][k], out["cpu"][k], rtol=0,
                               atol=tol * max(1.0, np.abs(out["cpu"][k]).max(initial=0.0)))


# per step: B1 launches besides one per Newton iteration (muscle.xml's
# Euler damping solve takes one)
@pytest.mark.parametrize("name, per_step", [("mixed", 0), ("muscle", 1)])
def test_tendon_scene_step_on_cuda_matches_cpu(name, per_step):
  """The tendon slice's main paths (tendon_scenes.npz's mixed scene and
  muscle.xml) at f64 from their golden's start: 5 steps on the card
  against the same steps on the CPU, qpos, qvel, act, sensordata and the
  tendons to 1e-9 of scale; on the card the B1 launches are all register,
  n=2, one per Newton iteration (and muscle.xml's one a step)."""
  from mjtpu_torch._src import solver

  golden = np.load(mjtpu_torch.ASSETS / "tendon_scenes_golden.npz")
  out = {}
  for device in ("cpu", "cuda"):
    m, d = chip_smoke.tendon_scene(name, golden, device)
    before = dict(cholesky.variant_launches)
    newton = solver.loop_counts["iterations"]
    for _ in range(5):
      d = mjtpu_torch.step(m, d)
    iterations = solver.loop_counts["iterations"] - newton
    kinds = {k: cholesky.variant_launches[k] - before[k] for k in before}
    out[device] = d, iterations, kinds
  (cpu, _, cpu_kinds), (gpu, iterations, kinds) = out["cpu"], out["cuda"]
  assert cpu_kinds == {"register": 0, "shared": 0}
  assert kinds == {"register": iterations + 5 * per_step, "shared": 0} and iterations > 0
  for f in ("qpos", "qvel", "act", "sensordata", "ten_length", "ten_J"):
    want = getattr(cpu, f).numpy()
    np.testing.assert_allclose(getattr(gpu, f).cpu().numpy(), want, rtol=0,
                               atol=1e-9 * max(1.0, np.abs(want).max(initial=0.0)), err_msg=f)


@pytest.mark.parametrize("name", ["mocap", "mocap_implicitfast"])
def test_mocap_step_on_cuda_matches_cpu(name):
  """The equality slice's main path (equality_scenes.npz's mocap.xml, a
  free payload welded to a moving mocap box) at f64 from its golden's
  start, the golden's targets set before each step: 5 steps on the card
  against the same steps on the CPU, qpos, qvel, the frames and the efc
  forces to 1e-9 of scale; on the card the B1 launches are all register,
  n=12, one per Newton iteration (ImplicitFast's blocked LU takes none)."""
  from mjtpu_torch._src import solver

  golden = dict(np.load(mjtpu_torch.ASSETS / "equality_scenes_golden.npz"))
  out = {}
  for device in ("cpu", "cuda"):
    m, d = chip_smoke.equality_scene(name, golden, device)
    before = dict(cholesky.variant_launches)
    newton = solver.loop_counts["iterations"]
    for t in range(5):
      d = mjtpu_torch.step(m, chip_smoke._mocap_at(d, golden, name, t))
    iterations = solver.loop_counts["iterations"] - newton
    kinds = {k: cholesky.variant_launches[k] - before[k] for k in before}
    out[device] = d, iterations, kinds
  (cpu, _, cpu_kinds), (gpu, iterations, kinds) = out["cpu"], out["cuda"]
  assert cpu_kinds == {"register": 0, "shared": 0}
  assert kinds == {"register": iterations, "shared": 0} and iterations > 0
  for f in ("qpos", "qvel", "xpos", "xquat", "efc_force"):
    want = getattr(cpu, f).numpy()
    np.testing.assert_allclose(getattr(gpu, f).cpu().numpy(), want, rtol=0,
                               atol=1e-9 * max(1.0, np.abs(want).max(initial=0.0)), err_msg=f)


def test_humanoid_implicit_step_on_cuda_matches_cpu():
  """The Implicit slice's main path (humanoid_implicit: the zoo's
  humanoid.xml under the full Implicit integrator) at f64 from its
  golden's start (two envs at rest, two moving): qDeriv with the RNE term
  at the start, then 5 steps on the card against the same on the CPU,
  qDeriv, qpos and qvel to 1e-9 of scale; on the card the B1 launches are
  all register, one per Newton iteration (the LU of qM - h qDeriv takes
  none)."""
  from mjtpu_torch._src import solver

  golden = dict(np.load(mjtpu_torch.ASSETS / "humanoid_implicit_golden.npz"))
  out = {}
  for device in ("cpu", "cuda"):
    m, d = chip_smoke.slice14_scene("humanoid_implicit", None, golden, device)
    qderiv = mjtpu_torch.deriv_smooth_vel(m, mjtpu_torch.forward(m, d), rne=True)
    before = dict(cholesky.variant_launches)
    newton = solver.loop_counts["iterations"]
    for _ in range(5):
      d = mjtpu_torch.step(m, d)
    iterations = solver.loop_counts["iterations"] - newton
    kinds = {k: cholesky.variant_launches[k] - before[k] for k in before}
    out[device] = d, qderiv, iterations, kinds
  (cpu, cpu_deriv, _, cpu_kinds), (gpu, deriv, iterations, kinds) = out["cpu"], out["cuda"]
  assert cpu_kinds == {"register": 0, "shared": 0}
  assert kinds == {"register": iterations, "shared": 0} and iterations > 0
  for got, want, f in ((deriv, cpu_deriv, "qDeriv"), (gpu.qpos, cpu.qpos, "qpos"),
                       (gpu.qvel, cpu.qvel, "qvel")):
    want = want.numpy()
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=0,
                               atol=1e-9 * max(1.0, np.abs(want).max()), err_msg=f)


def _env_step_on_cuda_matches_cpu(name, golden_file):
  """One env step of ``zoo.ENVS[name]`` on the card against the same step
  on the CPU, from an env golden's states: obs and reward of the envs that
  are not done to 1e-9 of scale, done and steps equal (env 3 is done: its
  fresh state comes from each device's generator); on the card one B1
  launch, register, per Newton iteration."""
  import dataclasses

  from mjtpu_torch import zoo
  from mjtpu_torch._src import solver

  golden = np.load(mjtpu_torch.ASSETS / golden_file)
  out = {}
  for device in ("cpu", "cuda"):
    env = zoo.ENVS[name](dtype=torch.float64, device=device)
    d = mjtpu_torch.make_data(env.model, batch_size=4)
    d = mjtpu_torch.replace(d, qpos=torch.as_tensor(golden[f"{name}.qpos0"], device=device),
                            qvel=torch.as_tensor(golden[f"{name}.qvel0"], device=device))
    state = env._init_state(mjtpu_torch.forward(env.model, d))
    state = dataclasses.replace(state, steps=torch.as_tensor(golden[f"{name}.steps0"],
                                                             device=device))
    gen = torch.Generator(device=device).manual_seed(0)
    before = dict(cholesky.variant_launches)
    newton = solver.loop_counts["iterations"]
    state = env.step(state, torch.as_tensor(golden[f"{name}.action"][0], device=device), gen)
    iterations = solver.loop_counts["iterations"] - newton
    kinds = {k: cholesky.variant_launches[k] - before[k] for k in before}
    out[device] = state, iterations, kinds
  (cpu, _, cpu_kinds), (gpu, iterations, kinds) = out["cpu"], out["cuda"]
  assert cpu_kinds == {"register": 0, "shared": 0}
  assert kinds == {"register": iterations, "shared": 0} and iterations > 0
  assert gpu.done.tolist() == cpu.done.tolist() == [False, False, False, True]
  assert gpu.steps.tolist() == cpu.steps.tolist() == [1, 1, 1, 0]
  for k in ("obs", "reward"):
    want = getattr(cpu, k)[:3].numpy()
    np.testing.assert_allclose(getattr(gpu, k)[:3].cpu().numpy(), want, rtol=0,
                               atol=1e-9 * max(1.0, np.abs(want).max()))


def test_ant_env_step_on_cuda_matches_cpu():
  """The Ant env (ant.xml, RK4: 5 physics steps of 4 forward passes and
  the reset forward), B1 at n=14."""
  _env_step_on_cuda_matches_cpu("ant", "zoo_env_golden.npz")


def test_swimmer_env_step_on_cuda_matches_cpu():
  """The swimmer env (swimmer.xml, RK4, fluid forces: 4 physics steps of 4
  forward passes and the reset forward), B1 at n=5."""
  _env_step_on_cuda_matches_cpu("swimmer", "swimmer_satellite_env_golden.npz")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chol_on_elliptic_hessians(dtype):
  """B1 against its twin on the Newton Hessians of the elliptic bench (a
  step from the golden's state after step 1: cone blocks in the middle
  zone folded in; at f32 the regulariser too) and of elliptic.xml (n=12,
  two trees: the register kernel, and the shared one held beside it),
  every variant within phase 3's tolerance of the twin and equal bit for
  bit."""
  from mjtpu_torch._src import io

  golden = np.load(mjtpu_torch.ASSETS / "humanoid_bench_elliptic_golden.npz")
  m = chip_smoke._elliptic_model(dtype)
  d = mjtpu_torch.replace(
      mjtpu_torch.make_data(m, batch_size=4),
      **{k: torch.as_tensor(golden[g][0] if g != "ctrl" else golden[g], dtype=dtype,
                            device="cuda")
         for k, g in (("qpos", "qpos"), ("qvel", "qvel"), ("qacc_warmstart", "warm"),
                      ("ctrl", "ctrl"))})
  calls, _ = chip_smoke._capture_hessians(lambda: mjtpu_torch.step(m, d))
  assert len(calls) == 1 and calls[0][0].shape == (4, 27, 27)
  chip_smoke._hold_chol(*calls[0], "the elliptic bench")
  assert cholesky.variant(27, dtype) == "register"

  scenes = np.load(mjtpu_torch.ASSETS / "cone_scenes_golden.npz")
  m = mjtpu_torch.model_from_arrays(
      io.load_snapshot(mjtpu_torch.ASSETS / "cone_scenes.npz", "elliptic"), dtype=dtype,
      device="cuda")
  d = mjtpu_torch.replace(
      mjtpu_torch.make_data(m, batch_size=4),
      qpos=torch.as_tensor(scenes["elliptic.qpos0"], dtype=dtype, device="cuda"),
      qvel=torch.as_tensor(scenes["elliptic.qvel0"], dtype=dtype, device="cuda"))
  calls, _ = chip_smoke._capture_hessians(lambda: mjtpu_torch.step(m, d))
  assert calls and calls[0][0].shape == (4, 12, 12)
  assert cholesky.variant(12, dtype) == "register"
  assert cholesky.variants(12, dtype) == ("register", "shared")
  for h, grad in calls:
    chip_smoke._hold_chol(h, grad, "elliptic.xml")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_randomized_step_on_the_card(dtype):
  """The randomized humanoid_bench (chip_smoke.bench_randomization's rows
  with their committed constants) at B=8 on the card: the batched step
  launches B1 `register` at n=27 once (Newton 1 x 4), and each env stepped
  alone under its own unbatched Model matches it (f64: 1e-12 of scale;
  f32: RANDOM_CHECK_BOUND)."""
  ns = mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / "humanoid_bench_model.npz")
  m = mjtpu_torch.model_from_arrays(ns, dtype=dtype, device="cuda")
  rows = chip_smoke.bench_randomization(ns, chip_smoke.BENCH_BATCH)
  rows.update(chip_smoke._rows(np.load(mjtpu_torch.ASSETS / "randomize_scenes_golden.npz"),
                               "bench.rows.", m))
  rows = {k: v[:8] for k, v in rows.items()}
  step, _ = mjtpu_torch.parallel.randomized_step(m, rows)
  rng = np.random.default_rng(0)
  d = mjtpu_torch.replace(
      mjtpu_torch.make_data(m, 8),
      qpos=torch.as_tensor(ns.qpos0[None] + rng.uniform(-0.01, 0.01, (8, m.nq)), dtype=dtype,
                           device="cuda"),
      ctrl=torch.as_tensor(rng.uniform(-1, 1, (8, m.nu)), dtype=dtype, device="cuda"))
  before = cholesky.variant_launches["register"]
  out = step(d)
  assert cholesky.variant_launches["register"] - before == 1
  bound = 1e-12 if dtype == torch.float64 else chip_smoke.RANDOM_CHECK_BOUND
  for e in range(8):
    alone = mjtpu_torch.step(chip_smoke._env_model(m, rows, e), chip_smoke._env_data(d, e))
    for f in ("qpos", "qvel"):
      assert chip_smoke._scaled_err(getattr(alone, f)[0].cpu().numpy(),
                                    getattr(out, f)[e].cpu().numpy()) <= bound, (e, f)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_per_env_terrain_on_the_card(dtype):
  """humanoid_terrain with each env's own heights and friction
  (chip_smoke.terrain_randomization) at B=8 on the card: the batched step
  launches B4 `static` twice, on windows gathered from each env's heights,
  and each env stepped alone under its own unbatched Model matches it
  (f64: 1e-12 of scale; f32: RANDOM_CHECK_BOUND)."""
  from mjtpu_torch.ops import hfield

  ns = mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / "humanoid_terrain_model.npz")
  m = mjtpu_torch.model_from_arrays(ns, dtype=dtype, device="cuda")
  rows = chip_smoke.terrain_randomization(ns, 8)
  step, _ = mjtpu_torch.parallel.randomized_step(m, rows)
  rng = np.random.default_rng(0)
  d = mjtpu_torch.replace(
      mjtpu_torch.make_data(m, 8),
      qpos=torch.as_tensor(ns.qpos0[None] + rng.uniform(-0.01, 0.01, (8, m.nq)), dtype=dtype,
                           device="cuda"),
      ctrl=torch.as_tensor(rng.uniform(-1, 1, (8, m.nu)), dtype=dtype, device="cuda"))
  before = hfield.variant_launches["static"]
  out = step(d)
  assert hfield.variant_launches["static"] - before == 2
  bound = 1e-12 if dtype == torch.float64 else chip_smoke.RANDOM_CHECK_BOUND
  for e in range(8):
    alone = mjtpu_torch.step(chip_smoke._env_model(m, rows, e), chip_smoke._env_data(d, e))
    for f in ("qpos", "qvel"):
      assert chip_smoke._scaled_err(getattr(alone, f)[0].cpu().numpy(),
                                    getattr(out, f)[e].cpu().numpy()) <= bound, (e, f)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [27, 23])
def test_chol_backward_matches_twin_autograd(n, dtype):
  """B1's autograd.Function on the card (the kernel forward, one more
  launch of it backward) against autograd through the twin (phase 3's
  tolerances), and its launches counted: two, forward and backward."""
  gen = torch.Generator(device="cuda").manual_seed(n)
  before = cholesky.launches
  err = chip_smoke.chol_backward_error(n, dtype, 130, gen)
  assert cholesky.launches - before == 2
  assert err <= (1e-4 if dtype == torch.float32 else 1e-10)


def test_kernels_without_backward_refuse_grad():
  """B2's, B3's and B4's wrappers raise on a CUDA input that requires
  grad, and run under torch.no_grad()."""
  assert all(chip_smoke.kernel_grad_refusals().values())
  with torch.no_grad():
    assert not any(chip_smoke.kernel_grad_refusals().values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_seams_backward_on_the_card(dtype):
  """B2's, B3's and B4's differentiable seams launch their kernel forward
  (B2's solves once more backward) and match autograd through the twin to
  phase 3's tolerances."""
  errs = chip_smoke.seam_grad_errors("cuda", dtype, 130,
                                     torch.Generator(device="cuda").manual_seed(6))
  tol = 1e-4 if dtype == torch.float32 else 1e-10
  backward = {"ldl_factor_solve": 1, "ldl_solve": 1}
  for name, (err, fwd, bwd) in errs.items():
    assert err <= tol and fwd == 1 and bwd == backward.get(name, 0), (name, errs[name])


def test_diff_scene_on_the_card():
  """The box-on-box scene (B3's kernel forward, its twin's gradient) and
  the pendulum under differentiable_mode on the card, against mjtpu's
  golden."""
  golden = np.load(mjtpu_torch.ASSETS / "diff_scenes_golden.npz")
  for name in ("box_box", "pendulum"):
    errs = chip_smoke.diff_scene_errors(name, golden, "cuda")
    assert errs["finite"] and errs["values"] <= chip_smoke.DIFF_VALUE_BOUND, errs
    assert all(v <= chip_smoke.DIFF_GRAD_BOUND for k, v in errs.items()
               if k.startswith("grad_")), errs


@pytest.mark.parametrize("scene", ["textured", "lit", "mesh"])
def test_render_scene_on_the_card_matches_cpu(scene):
  """A golden render scene's every view at f64 on the card (its own
  forward, its own render) against the CPU's render of the CPU's
  forward, to the CPU tests' bounds: rgb and depth within 1e-10 where seg
  agrees, any other pixel a tie that copies of its rays a few ULP away
  resolve to the CPU's pick (chip_smoke.render_view_errors)."""
  from mjtpu_torch._src import render

  with np.load(mjtpu_torch.ASSETS / "render_scenes_golden.npz") as z:
    golden = {k: z[k] for k in z.files}
  cpu = chip_smoke.render_scene(scene, golden, "cpu")
  card = chip_smoke.render_scene(scene, golden, "cuda")
  height, width = golden[f"{scene}.shadows.cam0.seg"].shape[1:]
  for _, label, cam, options in (v for v in chip_smoke.render_views(golden) if v[0] == scene):
    want = tuple(x.numpy() for x in render.render_rgbd(
        *cpu[:2], width=width, height=height, camera=cam, rd=cpu[2], **options))
    errs = chip_smoke.render_view_errors(*card, want, cam, options)
    assert errs["rgb"] <= chip_smoke.RENDER_BOUND and errs["depth"] <= chip_smoke.RENDER_BOUND


# the f32 render of the humanoid pixel env's frames against the f64 one of
# the same frames on the card: measured 1.14e-05 of the pixels' seg and
# 3.19e-03 in rgb where seg agrees (NVIDIA H100 80GB HBM3, 700 W); the
# bounds hold 4x and 3x that
RENDER_F32_SEG_SHARE = 5e-5
RENDER_F32_RGB_ERR = 1e-2


def test_render_f32_against_f64_on_the_card():
  """The main path's renderer at f32 (the humanoid pixel env, 64 x 64,
  64 envs from a reset) against f64 on the same frames (the Data cast to
  f64): the share of seg pixels that differ, and the largest rgb error
  where seg agrees."""
  from mjtpu_torch import zoo
  from mjtpu_torch._src import render
  from mjtpu_torch._src.dataclasses import map_tensors

  env = zoo.ENVS["humanoid"](pixel_obs=True)
  env64 = zoo.ENVS["humanoid"](dtype=torch.float64, pixel_obs=True)
  gen = torch.Generator(device="cuda").manual_seed(0)
  state = env.reset(64, gen)
  state = env.step(state, 2.0 * torch.rand(64, env.action_size, generator=gen,
                                           device="cuda") - 1.0, gen)
  d64 = map_tensors(state.data, lambda x: x.double() if x.is_floating_point() else x)
  r32 = render.render_batch_rgbd(env.model, state.data, rd=env._render_data)
  r64 = render.render_batch_rgbd(env64.model, d64, rd=env64._render_data)
  assert torch.equal(r32[0], state.pixels)
  same = r32[2] == r64[2]
  share = float((~same).double().mean())
  err = float((r32[0].double() - r64[0]).abs().amax(-1)[same].max())
  print(f"f32 against f64: seg differs at {share:.3e} of pixels, rgb {err:.3e} where it agrees")
  assert share <= RENDER_F32_SEG_SHARE and err <= RENDER_F32_RGB_ERR


# f32 against mjtpu's f64 gradients of two model_grad scenes on the card,
# of each field's max-abs: about three times the worst measured on an
# NVIDIA H100 80GB HBM3, 700 W (2.03e-2, terrain's hfield_data; 2.71e-3,
# humanoid_bench's jnt_solimp)
MODEL_GRAD_F32_BOUNDS = {"terrain": 6e-2, "humanoid_bench": 1e-2}
# read at f32 only: the f32 Newton Hessian's regularisation is 1e-6 of
# it (solver.solve), so its gradient, zero at f64, is not at f32
F32_ONLY_FIELDS = ("stat.meaninertia",)


@pytest.mark.parametrize("name", sorted(MODEL_GRAD_F32_BOUNDS))
def test_model_grad_f32_on_the_card(name):
  """A model_grad scene at f32 on the card (B1, and B4 forward with its
  twin's gradient on the height field) with its rows as leaves that
  require grad: every gradient finite, each field's within the measured
  bound of mjtpu's f64 gradient's max-abs, a field mjtpu leaves at zero
  zero (but F32_ONLY_FIELDS)."""
  golden = np.load(mjtpu_torch.ASSETS / "model_grad_scenes_golden.npz")
  got = chip_smoke.model_grad_scene_run(name, golden, "cuda", dtype=torch.float32)
  errs = chip_smoke.model_grad_scene_errors(name, golden, "cuda", got=got)
  print(f"{name} f32: {errs['grads']}")
  assert errs["finite"], errs
  assert all(v == 0.0 if f in errs["zero"] else v <= MODEL_GRAD_F32_BOUNDS[name]
             for f, v in errs["grads"].items() if f not in F32_ONLY_FIELDS), errs
