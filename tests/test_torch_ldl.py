"""The port's tree-sparse LDL (mjtpu_torch/_src/sparse.py, ops/ldl.py)
against mjtpu's sparse.py and its Pallas kernel on the CPU.

  * ``_build`` equals mjtpu's field by field, and ``structure`` makes
    mjtpu's default decision (MJTPU_SPARSE_LDL unset), on the branchy trees
    of tests/test_sparse.py (nv 66 and 38), the serial chain40 and the
    zoo humanoids (plus scene_pile for the decision);
  * the plain twins (``ldl_*_reference``, what the wrappers run on a CPU
    tensor) against mjtpu's ``sparse.factor`` / ``sparse.solve`` at
    float64 to 1e-12 of scale, on branchy-66 mass matrices from
    ``mj_fullM``, with one batch whose pivots hit the MINVAL floor (dofs
    with a zero row and column: a massless dof);
  * the twins against mjtpu's Pallas kernel in interpret mode
    (``mjtpu.ops.ldl``, as tests/test_ops.py runs it) to 1e-10, once, B=3;
  * the two schedules that csrc/ldl.cu's kernels read (the shared
    kernel's packed int32 lists, the lanes kernel's lane-major words),
    each replayed here in numpy with its kernel's loops, give the twin's
    results bit for bit on chip_smoke.py's trees and matrices (the kernels
    themselves are held to the twin on the card: tests_cuda/,
    chip_smoke.py);
  * the wrapper's size dispatch between the two kernels.

Inputs are made with numpy from a seed.
"""

import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import mjtpu
from mjtpu._src import sparse as j_sparse
from mjtpu.ops import ldl as j_ldl
import mjtpu_torch
from mjtpu_torch._src import sparse
from mjtpu_torch._src.types import MINVAL
from mjtpu_torch.ops import ldl
import chip_smoke
from tests.conftest import load_mj
from tests.test_sparse import ZOO_ASSETS, _branchy_xml

torch.set_num_threads(1)

MODELS = {
    "branchy66": lambda: mujoco.MjModel.from_xml_string(_branchy_xml()),
    "branchy38": lambda: mujoco.MjModel.from_xml_string(_branchy_xml(limbs=4, links=8)),
    "chain40": lambda: load_mj("chain40.xml"),
    "humanoid": lambda: mujoco.MjModel.from_xml_path(str(ZOO_ASSETS / "humanoid.xml")),
    "humanoid_bench": lambda: mujoco.MjModel.from_xml_path(str(ZOO_ASSETS / "humanoid_bench.xml")),
    "scene_pile": lambda: mujoco.MjModel.from_xml_path(str(ZOO_ASSETS / "scene_pile.xml")),
}


def _parentid(mjm):
  return tuple(int(x) for x in mjm.dof_parentid)


@pytest.mark.parametrize("name", ["branchy66", "branchy38", "chain40", "humanoid"])
def test_build_matches_mjtpu(name):
  mjm = MODELS[name]()
  want = j_sparse._build(mjm.nv, _parentid(mjm))
  got = sparse._build(mjm.nv, _parentid(mjm))
  assert (got.nv, got.depth, got.flops_sparse, got.flops_dense) == (
      want.nv, want.depth, want.flops_sparse, want.flops_dense)
  for f in ("anc", "anc_clip", "mask"):
    np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
  assert len(got.rounds) == len(want.rounds)
  for a, b in zip(got.rounds, want.rounds):
    for f in a._fields:
      np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
  for f in ("depth_rounds", "height_rounds"):
    assert len(getattr(got, f)) == len(getattr(want, f)), f
    for a, b in zip(getattr(got, f), getattr(want, f)):
      np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("name, sparse_path", [
    ("branchy66", True), ("branchy38", True), ("chain40", False), ("humanoid", False),
    ("humanoid_bench", False), ("scene_pile", False),
])
def test_structure_decision_matches_mjtpu(name, sparse_path, monkeypatch):
  """chain40 is a serial chain (10,660 sparse against 10,666 dense flops):
  dense in both; the humanoids are below 32 dofs; scene_pile is a forest."""
  monkeypatch.delenv("MJTPU_SPARSE_LDL", raising=False)
  mjm = MODELS[name]()
  want = j_sparse.structure(mjtpu.put_model(mjm))
  got = sparse.structure(mjtpu_torch.put_model(mjm, device="cpu"))
  assert (got is not None) == (want is not None) == sparse_path
  if sparse_path:
    assert (got.nv, got.depth, got.flops_sparse) == (want.nv, want.depth, want.flops_sparse)


@pytest.fixture(scope="module")
def branchy():
  """(parentid, port tables, mass matrices (6, nv, nv) from mj_fullM at
  qpos0 +-0.3 (numpy seed 0), right-hand sides (6, nv)); matrices 3-5 have
  a zero row and column at several dofs, whose pivots hit the floor."""
  mjm = MODELS["branchy66"]()
  s = sparse._build(mjm.nv, _parentid(mjm))
  rng = np.random.default_rng(0)
  mjd = mujoco.MjData(mjm)
  Ms = []
  for _ in range(6):
    mjd.qpos[:] = mjm.qpos0 + rng.uniform(-0.3, 0.3, mjm.nq)
    mujoco.mj_forward(mjm, mjd)
    M = np.zeros((mjm.nv, mjm.nv))
    mujoco.mj_fullM(mjm, mjd, M)
    Ms.append(M)
  Ms = np.stack(Ms)
  for b in range(3, 6):
    dead = rng.choice(mjm.nv, size=8, replace=False)
    Ms[b, dead, :] = 0.0
    Ms[b, :, dead] = 0.0
  bs = rng.standard_normal((6, mjm.nv))
  return _parentid(mjm), sparse.device_tables(s, torch.float64, "cpu"), Ms, bs


def _mjtpu_ref(parentid, Ms, bs):
  """mjtpu's sparse.factor and sparse.solve, vmapped over the batch."""
  s = j_sparse._build(len(parentid), parentid)
  S = jax.jit(jax.vmap(lambda M: j_sparse.factor(s, M)))(jnp.asarray(Ms))
  x = jax.jit(jax.vmap(lambda S, b: j_sparse.solve(s, S, b)))(S, jnp.asarray(bs))
  return np.array(S), np.array(x)


def _close(got, want, tol, what):
  got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
  scale = max(1.0, float(np.abs(want).max()))
  err = float(np.abs(got - want).max())
  assert err <= tol * scale, f"{what}: max abs err {err:.3e} (scale {scale:.3g})"


@pytest.mark.parametrize("batch", ["regular", "floored"])
def test_twins_match_mjtpu_sparse(branchy, batch):
  parentid, t, Ms, bs = branchy
  s = j_sparse._build(len(parentid), parentid)
  sel = slice(0, 3) if batch == "regular" else slice(3, 6)
  S_ref, x_ref = _mjtpu_ref(parentid, Ms[sel], bs[sel])
  Mc = sparse.gather_compact(t, torch.as_tensor(Ms[sel]))
  rhs = torch.as_tensor(bs[sel])
  before = dict(ldl.launches)
  S = ldl.ldl_factor(t, Mc)
  _close(S, S_ref, 1e-12, "ldl_factor")
  _close(ldl.ldl_solve(t, S, rhs), x_ref, 1e-12, "ldl_solve")
  _close(ldl.ldl_factor_solve(t, Mc, rhs), x_ref, 1e-12, "ldl_factor_solve")
  # the dense qLD layout and back, as mjtpu spreads and gathers it
  dense = np.stack([np.asarray(j_sparse.scatter_dense(s, jnp.asarray(x))) for x in S_ref])
  np.testing.assert_array_equal(sparse.scatter_dense(t, torch.as_tensor(S_ref)).numpy(), dense)
  np.testing.assert_array_equal(
      sparse.gather_compact(t, torch.as_tensor(dense)).numpy(),
      np.stack([np.asarray(j_sparse.gather_compact(s, jnp.asarray(x))) for x in dense]))
  if batch == "floored":
    assert float(S[..., -1].min()) == MINVAL
    assert float(np.abs(x_ref).max()) > 1e12
  assert ldl.launches == before  # CPU tensors run the twins


def test_twins_match_mjtpu_pallas_interpret(branchy):
  """The Pallas kernel, run as tests/test_ops.py runs it, agrees with
  sparse.py to summation-order rounding; the twins agree with it to 1e-10."""
  parentid, t, Ms, bs = branchy
  c = j_ldl.consts_for(j_sparse._build(len(parentid), parentid))
  Mc = sparse.gather_compact(t, torch.as_tensor(Ms[:3]))
  rhs = torch.as_tensor(bs[:3])
  with pltpu.force_tpu_interpret_mode():
    S_k = np.array(j_ldl.ldl_factor(c, jnp.asarray(Mc.numpy())))
    x_k = np.array(j_ldl.ldl_solve(c, jnp.asarray(S_k), jnp.asarray(bs[:3])))
    x_f = np.array(j_ldl.ldl_factor_solve(c, jnp.asarray(Mc.numpy()), jnp.asarray(bs[:3])))
  _close(ldl.ldl_factor(t, Mc), S_k, 1e-10, "ldl_factor vs Pallas")
  _close(ldl.ldl_solve(t, torch.as_tensor(S_k), rhs), x_k, 1e-10, "ldl_solve vs Pallas")
  _close(ldl.ldl_factor_solve(t, Mc, rhs), x_f, 1e-10, "ldl_factor_solve vs Pallas")


def _replay(sched: np.ndarray, Mc: np.ndarray, rhs: np.ndarray, mode: int) -> np.ndarray:
  """csrc/ldl.cu's loops for one env, in numpy float64 scalars, reading
  the packed schedule through its header (sparse._pack)."""
  h = sched[:sparse.HEADER]
  nv, depth = int(h[0]), int(h[1])
  floor = np.float64(1e-15)
  fl = lambda v: floor if v < floor else v
  S = [np.float64(v) for v in Mc.ravel()]
  x = [np.float64(v) for v in rhs]

  def csr(n, r_off, t_off, p_off, s_off, width):
    for r in range(n):
      for t in range(sched[r_off + r], sched[r_off + r + 1]):
        yield sched[t_off + t], [sched[s_off + width * u:s_off + width * (u + 1)]
                                 for u in range(sched[p_off + t], sched[p_off + t + 1])]

  if mode & 1:
    for tgt, srcs in csr(h[2], h[3], h[4], h[5], h[6], 3):
      acc = S[tgt]
      for a, b, d in srcs:
        acc = acc - (S[a] * S[b]) / fl(S[d])
      S[tgt] = acc
    for e in range(nv * depth):
      c = e % depth
      if c != depth - 1:
        S[e] = S[e] / fl(S[e - c + depth - 1])
    for i in range(nv):
      S[i * depth + depth - 1] = fl(S[i * depth + depth - 1])
    if mode == 1:
      return np.array(S).reshape(nv, depth)
  for tgt, srcs in csr(h[7], h[8], h[9], h[10], h[11], 2):
    acc = x[tgt]
    for li, k in srcs:
      acc = acc - S[li] * x[k]
    x[tgt] = acc
  x = [x[i] / fl(S[i * depth + depth - 1]) for i in range(nv)]
  rows, dof_depth, anc = sched[h[14]:], sched[h[15]:], sched[h[16]:]
  for r in range(h[12]):
    for j in range(sched[h[13] + r], sched[h[13] + r + 1]):
      k = rows[j]
      c0 = depth - dof_depth[k]
      acc = S[k * depth + c0] * x[anc[k * depth + c0]]
      for c in range(c0 + 1, depth - 1):
        acc = acc + S[k * depth + c] * x[anc[k * depth + c]]
      x[k] = x[k] - acc
  return np.array(x)


@pytest.mark.parametrize("name", ["branchy66", "branchy38"])
def test_chip_smoke_trees_match_mujoco(name):
  """chip_smoke.py builds the branchy trees' dof_parentid without mujoco."""
  limbs, links = {"branchy66": (6, 10), "branchy38": (4, 8)}[name]
  assert chip_smoke.branchy_parentid(limbs, links) == _parentid(MODELS[name]())


@pytest.mark.parametrize("tree", ["branchy66", "branchy38", "chain40", "random100"])
def test_packed_schedule_replays_twin(tree):
  """chip_smoke.py's trees (chain40 forced sparse: nv = depth = 40) and
  matrices, one env with a massless dof: the replay of csrc/ldl.cu's loops
  equals the twin bit for bit, and the twin solves M x = rhs."""
  parent = chip_smoke.ldl_trees()[tree]
  s = sparse._build(len(parent), parent)
  if tree == "chain40":
    assert s.depth == 40
  t = sparse.device_tables(s, torch.float64, "cpu")
  Mc, rhs, M = chip_smoke.chain_pattern_batch(
      t, 2, torch.float64, torch.Generator().manual_seed(1))
  M[1, 3], M[1, :, 3] = 0.0, 0.0  # a massless dof: its pivot hits the floor
  Mc = sparse.gather_compact(t, M)
  S = sparse.factor(t, Mc).numpy()
  x = sparse.solve(t, torch.as_tensor(S), rhs).numpy()
  assert S[1, 3, -1] == MINVAL
  sched, Mc, rhs = t.sched.numpy(), Mc.numpy(), rhs.numpy()
  for b in range(2):
    np.testing.assert_array_equal(_replay(sched, Mc[b], rhs[b], 1), S[b])
    np.testing.assert_array_equal(_replay(sched, S[b], rhs[b], 2), x[b])
    np.testing.assert_array_equal(_replay(sched, Mc[b], rhs[b], 3), x[b])
  np.testing.assert_allclose(x[0], np.linalg.solve(M[0].numpy(), rhs[0]), rtol=1e-9, atol=1e-11)


def test_ldl_work_counts():
  """chip_smoke.py's bound for B2 on the branchy tree: 3,905 updates,
  711 real entries of L+D (645 off-diagonals, 66 pivots) read from the
  compact (66, 16) blocks, the whole block written by the factor."""
  s = sparse._build(66, chip_smoke.branchy_parentid(6, 10))
  assert chip_smoke._ldl_work(s, 1, 4, "ldl_factor") == ((711 + 1056) * 4, 3 * 3905 + 645)
  assert chip_smoke._ldl_work(s, 2, 8, "ldl_solve") == (2 * (711 + 132) * 8, 2 * (4 * 645 + 66))
  assert chip_smoke._ldl_work(s, 1, 4, "ldl_factor_solve") == (
      (711 + 132) * 4, 3 * 3905 + 645 + 4 * 645 + 66)


def _replay_lanes(sched: np.ndarray, Mc: np.ndarray, rhs: np.ndarray, mode: int,
                  item: int = 8) -> np.ndarray:
  """csrc/ldl.cu's lanes kernel for one env, in numpy float64 scalars: the
  env's shared block as a list addressed by byte offset / item (its compact
  factor at the header's odd row stride, then x, then the partial sums),
  each round's steps in order, each step's 32 lanes in turn, every word
  decoded from the lane-major schedule (sparse._pack_lanes)."""
  h = sched[:sparse.LANES_HEADER].astype(np.int64)
  nv, depth, ld = int(h[0]), int(h[1]), int(h[2])
  floor = np.float64(1e-15)
  fl = lambda v: floor if v < floor else v
  mem = [np.float64(0)] * sparse.lane_block(nv, depth)
  for e, v in enumerate(Mc.ravel()):
    mem[e // depth * ld + e % depth] = np.float64(v)
  for i, v in enumerate(rhs):
    mem[nv * ld + i] = np.float64(v)
  mask, flag = (1 << sparse.LANE_FIELD_BITS) - 1, 1 << sparse.LANE_FIELD_BITS
  part = nv  # the partial sums, nv entries after x

  def run(rounds, steps_at, words_at, step):
    steps = sched[steps_at:steps_at + rounds + 1]
    words = sched.view(np.uint32)[words_at:].astype(np.int64)
    for r in range(rounds):
      acc = [None] * sparse.LANES
      for s in range(steps[r], steps[r + 1]):
        for lane in range(sparse.LANES):
          lo, hi = words[2 * (s * sparse.LANES + lane)], words[2 * (s * sparse.LANES + lane) + 1]
          if hi & flag:
            acc[lane] = step(acc[lane], *((v & mask) // item for v in (lo, lo >> 16, hi)),
                             (hi >> 16) // item, bool(lo & flag), bool(lo >> 31))

  def factor_step(acc, p, q, r, t, first, last):
    acc = (mem[t] if first else acc) - (mem[p] * mem[q]) / fl(mem[r])
    if last:
      mem[t] = acc
    return acc

  def lt_step(acc, p, q, r, t, first, last):
    acc = (mem[t] if first else acc) - mem[p] * mem[q]
    if last:
      mem[t] = acc
    return acc

  def l_step(acc, p, q, r, t, first, last):
    total = mem[p] * mem[q] if first else mem[t + part] + mem[p] * mem[q]
    if last:
      mem[t] = mem[t] - total
    else:
      mem[t + part] = total

  if mode & 1:
    run(h[3], h[4], h[5], factor_step)
    for i in range(nv):
      dia = fl(mem[i * ld + depth - 1])
      for c in range(depth - 1):
        mem[i * ld + c] = mem[i * ld + c] / dia
      mem[i * ld + depth - 1] = dia
    if mode == 1:
      return np.array([mem[i * ld:i * ld + depth] for i in range(nv)])
  run(h[6], h[7], h[8], lt_step)
  for i in range(nv):
    mem[nv * ld + i] = mem[nv * ld + i] / fl(mem[i * ld + depth - 1])
  run(h[9], h[10], h[11], l_step)
  return np.array(mem[nv * ld:nv * ld + nv])


@pytest.mark.parametrize("tree", ["branchy66", "branchy38", "chain40", "random100"])
def test_lane_schedule_replays_twin(tree):
  """The lanes kernel's schedule (sparse._pack_lanes), replayed with its
  loops on chip_smoke.py's trees and matrices with a massless dof, equals
  the twin bit for bit; each warp step is one word a lane, and each
  target's updates stay in its list order in one lane."""
  parent = chip_smoke.ldl_trees()[tree]
  s = sparse._build(len(parent), parent)
  t = sparse.device_tables(s, torch.float64, "cpu")
  Mc, rhs, M = chip_smoke.chain_pattern_batch(
      t, 2, torch.float64, torch.Generator().manual_seed(2))
  M[1, 5], M[1, :, 5] = 0.0, 0.0  # a massless dof: its pivot hits the floor
  Mc = sparse.gather_compact(t, M)
  S = sparse.factor(t, Mc).numpy()
  x = sparse.solve(t, torch.as_tensor(S), rhs).numpy()
  assert S[1, 5, -1] == MINVAL
  sched, Mc, rhs = t.lanes.numpy(), Mc.numpy(), rhs.numpy()
  # the kernel loads each step's operands a step ahead: within a round no
  # target is written twice or read as a source (factor: S[p], S[q], S[r];
  # the solves: x[q])
  words = sched.view(np.uint32).astype(np.int64)
  mask, flag = (1 << sparse.LANE_FIELD_BITS) - 1, 1 << sparse.LANE_FIELD_BITS
  assert sched[2] == sparse.lane_stride(s.depth) and sched[2] % 2 == 1
  for rounds_at, factor in ((3, True), (6, False), (9, False)):
    rounds, steps_at, words_at = (int(v) for v in sched[rounds_at:rounds_at + 3])
    steps = sched[steps_at:steps_at + rounds + 1]
    for r in range(rounds):
      w = words[words_at + 2 * steps[r] * sparse.LANES:words_at + 2 * steps[r + 1] * sparse.LANES]
      lo, hi = w[0::2][(w[1::2] & flag) > 0], w[1::2][(w[1::2] & flag) > 0]
      first = (lo & flag) > 0
      targets = (hi >> 16)[first]
      assert len(set(targets.tolist())) == len(targets)
      sources = {*((lo >> 16) & mask).tolist()}
      if factor:
        sources |= {*(lo & mask).tolist(), *(hi & mask).tolist()}
      assert not sources & set(targets.tolist())
  for b in range(2):
    np.testing.assert_array_equal(_replay_lanes(sched, Mc[b], rhs[b], 1), S[b])
    np.testing.assert_array_equal(_replay_lanes(sched, S[b], rhs[b], 2), x[b])
    np.testing.assert_array_equal(_replay_lanes(sched, Mc[b], rhs[b], 3), x[b])


def test_lane_schedule_steps():
  """branchy66's lane schedule: the factor's 3,905 updates in 133 warp
  steps (131 for a perfect split of each round), the L^T solve's 645 in
  65 (the root's chain of 65 contributions), the L solve's 645 in 26 (15
  levels), against 149, 70 and 120 over the busiest lane of the shared
  kernel's striding; each pass's words 8-byte aligned and followed by a
  step of padding; the shared rows at stride 17."""
  s = sparse._build(66, chip_smoke.branchy_parentid(6, 10))
  h = sparse._pack_lanes(s, sparse._factor_lists(s), sparse._lt_lists(s), 4)
  assert tuple(h[:3]) == (66, 16, 17)
  valid = 0
  for rounds_at, want_steps in ((3, 133), (6, 65), (9, 26)):
    rounds, steps_at, words_at = (int(v) for v in h[rounds_at:rounds_at + 3])
    assert rounds == 15 and int(h[steps_at + rounds]) == want_steps
    assert words_at % 2 == 0 and words_at >= steps_at + rounds + 1
    hi = h.view(np.uint32)[words_at + 1:words_at + 2 * (want_steps + 1) * sparse.LANES:2]
    flags = (hi.astype(np.int64) >> sparse.LANE_FIELD_BITS) & 1
    assert len(flags) == (want_steps + 1) * sparse.LANES
    assert not flags[want_steps * sparse.LANES:].any()  # the padding step
    valid += int(flags.sum())
  assert valid == 3905 + 645 + 645
  # the shared kernel's lanes stride over each round's targets (lane l
  # takes targets l, l + 32, ...): its busiest lane's updates, round by
  # round, summed
  busiest = lambda rounds: sum(max(int(c[lane::sparse.LANES].sum()) for lane in range(
      sparse.LANES)) for c in rounds)
  depth = (s.anc < s.nv).sum(axis=1)
  assert busiest([np.diff(x.ptr) for x in sparse._factor_lists(s)]) == 149
  assert busiest([np.diff(x.ptr) for x in sparse._lt_lists(s)]) == 70
  assert busiest([depth[ks] - 1 for ks in s.depth_rounds]) == 120


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_size_dispatch_and_launch_geometry(dtype):
  """Every tree of the port takes the lanes kernel (its shared block fits
  the schedule's 15-bit byte offsets), one warp an env, 8 a block; a tree
  past the fields takes the shared one while its block fits, and
  none past that (tests_cuda: it raises on the card).  The field width
  and lane count are the ones csrc/ldl.cu reads."""
  item = torch.empty((), dtype=dtype).element_size()
  for tree, parent in chip_smoke.ldl_trees().items():
    t = sparse.device_tables(sparse._build(len(parent), parent), dtype, "cpu")
    assert t.lanes is not None and sparse.lanes_fit(t.nv, t.depth, item)
    assert ldl.variant(t, dtype) == "lanes" and ldl.variants(t, dtype) == ("lanes", "shared")
    assert ldl.launch_geometry(4096, t, dtype) == ("lanes", 512, 256, 8)
    assert ldl.launch_geometry(1, t, dtype) == ("lanes", 1, 256, 8)
    assert ldl.launch_geometry(130, t, dtype, "shared") == ("shared", 17, 256, 8)
  # the lanes kernel's static limit: 32 KB of shared block an env
  # (66 * 17 + 132 = 1,254 entries for branchy66)
  assert sparse.lane_block(66, 16) == 1254
  assert sparse.lanes_fit(127, 255, 1) and not sparse.lanes_fit(128, 255, 1)
  assert ldl.smem_per_warp(66, 16, dtype, "lanes") == 1254 * item
  assert ldl.smem_per_warp(66, 16, dtype) == (66 * 16 + 66) * item
  wide = dataclasses.replace(t, structure=t.structure._replace(nv=150, depth=150), lanes=None)
  assert ldl.variants(wide, dtype) == ("shared",)
  per = min(8, ldl.SMEM_LIMIT // ldl.smem_per_warp(150, 150, dtype))
  assert ldl.launch_geometry(130, wide, dtype) == ("shared", -(-130 // per), 32 * per, per)
  huge = dataclasses.replace(t, structure=t.structure._replace(nv=250, depth=250), lanes=None)
  assert ldl.variants(huge, dtype) == ()
  with pytest.raises(ValueError, match="static bound"):
    ldl.variant(huge, dtype)
  src = (pathlib.Path(ldl.__file__).parent.parent / "csrc" / ldl.SOURCE).read_text()
  macro = lambda name: int(re.search(rf"#define {name} (\d+)", src).group(1))
  assert (macro("MJTPU_LDL_LANE_FIELD_BITS"), macro("MJTPU_LDL_LANES")) == (
      sparse.LANE_FIELD_BITS, sparse.LANES)
  # a variant that cannot run a tree is refused before any device check
  mc = torch.zeros(2, 150, 150, dtype=dtype)
  with pytest.raises(ValueError):
    ldl.ldl_factor(wide, mc, kernel="lanes")
  Mc, _, _ = chip_smoke.chain_pattern_batch(t, 2, dtype, torch.Generator().manual_seed(0))
  for kind in ("lanes", "shared"):  # the twin on the CPU: no launch
    assert torch.equal(ldl.ldl_factor(t, Mc, kernel=kind), ldl.ldl_factor_reference(t, Mc))
  assert ldl.launches == dict.fromkeys(ldl.ENTRIES, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tables_refuse_another_dtype(dtype):
  """The lane schedule holds byte offsets in the entry size of the dtype
  its tables were built for: each entry point refuses tensors of the other
  dtype before any device check (on the card, offsets in the wrong units
  would read and write the wrong entries), and the lanes variant is not
  offered for it."""
  other = torch.float64 if dtype == torch.float32 else torch.float32
  parent = chip_smoke.ldl_trees()["branchy66"]
  t = sparse.device_tables(sparse._build(len(parent), parent), dtype, "cpu")
  assert t.dtype == dtype and ldl.variants(t, other) == ("shared",)
  Mc, rhs, _ = chip_smoke.chain_pattern_batch(t, 2, dtype, torch.Generator().manual_seed(3))
  S = ldl.ldl_factor(t, Mc)
  for name, (kernel, twin) in chip_smoke.ldl_calls().items():
    assert torch.equal(kernel(t, Mc, rhs, S), twin(t, Mc, rhs, S))
    for kind in (None, "lanes", "shared"):
      with pytest.raises(TypeError, match="tables were built for"):
        kernel(t, Mc.to(other), rhs.to(other), S.to(other), kind)
  assert ldl.launches == dict.fromkeys(ldl.ENTRIES, 0)
