"""Tree-structured sparse LDLᵀ factorization of the mass matrix.

Port of mjtpu/_src/sparse.py.  MuJoCo's qM has the kinematic-chain
sparsity pattern: M[i, j] != 0 only when one of i, j is an ancestor dof of
the other.  Eliminating dofs leaves first gives no fill-in, so the factor
M = Lᵀ D L lives on the same pattern (mj_factorM / mj_solveLD).  The tree
is compiled once into a static levelwise schedule (``_build``, numpy,
copied from mjtpu):

  * rows are stored right-aligned in a compact (nv, depth) layout: column
    depth-1 is the diagonal, column depth-1-p the ancestor at distance p;
  * the factor runs one round per dof-tree height; a round's updates never
    touch a row eliminated in the same round;
  * the solve runs Lᵀ rounds by height (each finished y[k] pushes into its
    ancestors), the division by D, then L rounds by depth (each x[k]
    gathers its ancestors).

``structure(m)`` makes mjtpu's default decision (mjtpu reads its
MJTPU_SPARSE_LDL knob; the port has none): None for a forest (which
``smooth.mass_blocks`` factors per tree) or for nv < 32, else the schedule
when the sparse flop count is below half the dense one.

``Tables`` holds the schedule on the device, built once per Model
(``tables(m)``): the two schedules that the variants of kernel B2
(``mjtpu_torch/csrc/ldl.cu``) read (``_pack``; ``_pack_lanes``, the lists
dealt to a warp's lanes, lane-major) and, built only when the plain batched
``factor`` / ``solve`` below first run, their index tensors
(``Tables.twin``).  All three come from the same per-target
contribution lists, in ascending update order, so the kernels and this
plain version sum every entry in the same order.  Every scatter-add is a
gather-based sum over those lists: no ``index_add_``, no atomics, so the
result is deterministic.  The pivot floor is MINVAL (1e-15) at float32 and
float64 alike, as in mjtpu.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from mjtpu_torch._src.types import MINVAL, Model, cached

_AUTO_RATIO = 0.5
# mjtpu's gate: below 32 dofs it keeps the dense Cholesky
_AUTO_MIN_NV = 32


class _Round(NamedTuple):
  """One elimination round: dofs `ks` plus flat update indices.

  For each eliminated dof k and ancestor pair (i at distance p, j at
  distance q >= p): M[i, j] -= M[k, i]·M[k, j] / D[k].  `u_k` indexes into
  `ks`; `u_si`/`u_sj` are source columns in the compact layout; `u_ti`/`u_tc`
  the target (row, column)."""

  ks: np.ndarray
  u_k: np.ndarray
  u_si: np.ndarray
  u_sj: np.ndarray
  u_ti: np.ndarray
  u_tc: np.ndarray


class Structure(NamedTuple):
  """Static levelwise schedule for one dof tree (all numpy)."""

  nv: int
  depth: int                      # maxdepth = compact row width
  anc: np.ndarray                 # (nv, depth) right-aligned, pad = nv
  anc_clip: np.ndarray            # gather-safe: pad clipped to nv - 1
  mask: np.ndarray                # (nv, depth) 1.0 where a real ancestor
  rounds: tuple[_Round, ...]      # elimination, by height ascending
  depth_rounds: tuple[np.ndarray, ...]   # forward solve, by depth ascending
  height_rounds: tuple[np.ndarray, ...]  # backward solve, by height ascending
  flops_sparse: int
  flops_dense: int


@functools.lru_cache(maxsize=64)
def _build(nv: int, parentid: tuple[int, ...]) -> Structure:
  chains = []
  for i in range(nv):
    c, j = [], i
    while j >= 0:
      c.append(j)
      j = parentid[j]
    chains.append(c[::-1])  # root .. self
  depths = np.array([len(c) for c in chains])
  D = int(depths.max())

  anc = np.full((nv, D), nv, dtype=np.int32)
  for i, c in enumerate(chains):
    anc[i, D - len(c):] = c
  mask = (anc < nv).astype(np.float64)
  anc_clip = np.minimum(anc, nv - 1)

  # height (longest path to a leaf) in the dof tree
  height = np.zeros(nv, dtype=np.int64)
  for i in range(nv - 1, -1, -1):
    p = parentid[i]
    if p >= 0:
      height[p] = max(height[p], height[i] + 1)

  rounds = []
  for h in range(int(height.max()) + 1):
    ks = np.nonzero(height == h)[0].astype(np.int32)
    u_k, u_si, u_sj, u_ti, u_tc = [], [], [], [], []
    for local, k in enumerate(ks):
      dk = int(depths[k])
      for p in range(1, dk):
        i = anc[k, D - 1 - p]
        for q in range(p, dk):
          u_k.append(local)
          u_si.append(D - 1 - p)
          u_sj.append(D - 1 - q)
          u_ti.append(i)
          u_tc.append(D - 1 - (q - p))
    rounds.append(
        _Round(
            ks,
            np.asarray(u_k, dtype=np.int32),
            np.asarray(u_si, dtype=np.int32),
            np.asarray(u_sj, dtype=np.int32),
            np.asarray(u_ti, dtype=np.int32),
            np.asarray(u_tc, dtype=np.int32),
        )
    )

  depth_rounds = tuple(
      np.nonzero(depths - 1 == t)[0].astype(np.int32)
      for t in range(1, D)
      if np.any(depths - 1 == t)
  )
  height_rounds = tuple(
      r.ks[depths[r.ks] > 1] for r in rounds if np.any(depths[r.ks] > 1)
  )

  flops_sparse = int(((depths - 1) * depths // 2).sum())
  flops_dense = nv**3 // 6
  return Structure(
      nv, D, anc, anc_clip, mask, tuple(rounds), depth_rounds,
      tuple(height_rounds), flops_sparse, flops_dense,
  )


def structure(m: Model) -> Structure | None:
  """The model's LDL schedule, or None when the dense or blocked path runs
  (mjtpu's default decision: see the module docstring)."""

  def build():
    if m.nv == 0:
      return None
    from mjtpu_torch._src import smooth

    if smooth.mass_blocks(m) is not None or m.nv < _AUTO_MIN_NV:
      return None
    s = _build(m.nv, tuple(int(x) for x in m.dof_parentid))
    return s if s.flops_sparse < _AUTO_RATIO * s.flops_dense else None

  return cached(m, "sparse.structure", build)


# ---------------------------------------------------------------------------
# the schedule as per-target contribution lists
# ---------------------------------------------------------------------------


class _Lists(NamedTuple):
  """One round's targets, each with its contributions in ascending update
  order: targets (T,), CSR pointers (T + 1,) into the sources (U, w)."""

  targets: np.ndarray
  ptr: np.ndarray
  sources: np.ndarray


def _lists(targets: np.ndarray, sources: np.ndarray) -> _Lists:
  """Groups the updates (targets[u], sources[u]) by target; a stable sort
  keeps each target's updates in ascending order of u."""
  order = np.argsort(targets, kind="stable")
  tgt, counts = np.unique(targets[order], return_counts=True)
  ptr = np.concatenate([[0], np.cumsum(counts)])
  return _Lists(tgt.astype(np.int64), ptr.astype(np.int64), sources[order].astype(np.int64))


def _factor_lists(s: Structure) -> list[_Lists]:
  """Per non-empty elimination round: targets ti*D + tc, sources (a, b, d)
  = flat compact indices of M[k, si], M[k, sj] and the pivot M[k, D-1]."""
  D = s.depth
  out = []
  for r in s.rounds:
    if not len(r.u_k):
      continue
    k = r.ks[r.u_k].astype(np.int64)
    src = np.stack([k * D + r.u_si, k * D + r.u_sj, k * D + D - 1], axis=1)
    out.append(_lists(r.u_ti.astype(np.int64) * D + r.u_tc, src))
  return out


def _lt_lists(s: Structure) -> list[_Lists]:
  """Per height round of the Lᵀ solve: targets are ancestor rows a,
  sources (k*D + c, k) for each real L[k, c] with anc[k, c] = a, in the
  round's (k, c) order."""
  D = s.depth
  out = []
  for ks in s.height_rounds:
    a = s.anc[ks, :-1]
    k, c = np.nonzero(a < s.nv)
    rows = ks[k].astype(np.int64)
    out.append(_lists(a[k, c].astype(np.int64), np.stack([rows * D + c, rows], axis=1)))
  return out


# ---------------------------------------------------------------------------
# device tables
# ---------------------------------------------------------------------------

# the packed kernel schedule starts with HEADER int32 entries (ldl.cu's
# enum Header): nv, depth, then per pass its round count and the offsets
# of its tables in the buffer
HEADER = 20


def _pack(s: Structure, flists: list[_Lists], ltlists: list[_Lists]) -> np.ndarray:
  """The int32 schedule that csrc/ldl.cu reads (layout in its header)."""
  parts: list[np.ndarray] = []
  offset = HEADER

  def add(a) -> int:
    nonlocal offset
    a = np.asarray(a, dtype=np.int64).ravel()
    parts.append(a)
    start, offset = offset, offset + a.size
    return start

  def csr(lists: list[_Lists], width: int) -> tuple[int, int, int, int]:
    tcount = np.cumsum([0] + [len(x.targets) for x in lists])
    ucount = np.cumsum([0] + [len(x.sources) for x in lists])
    rounds = add(tcount)
    tgt = add(np.concatenate([x.targets for x in lists]) if lists else [])
    ptr = add(np.concatenate([x.ptr[:-1] + u for x, u in zip(lists, ucount)] + [ucount[-1:]]))
    src = add(np.concatenate([x.sources for x in lists]).reshape(-1, width) if lists else [])
    return rounds, tgt, ptr, src

  f = csr(flists, 3)
  lt = csr(ltlists, 2)
  l_round = add(np.cumsum([0] + [len(ks) for ks in s.depth_rounds]))
  l_k = add(np.concatenate(s.depth_rounds) if s.depth_rounds else [])
  depth = add((s.anc < s.nv).sum(axis=1))
  anc = add(s.anc)
  header = [s.nv, s.depth, len(flists), *f, len(ltlists), *lt, len(s.depth_rounds), l_round,
            l_k, depth, anc]
  header += [0] * (HEADER - len(header))
  packed = np.concatenate([np.asarray(header, dtype=np.int64)] + parts)
  if packed.max(initial=0) >= 2**31:
    raise ValueError("the LDL schedule does not fit int32 indices")
  return packed.astype(np.int32)


# the lane-major schedule of csrc/ldl.cu's lanes kernel: LANES_HEADER int32
# entries (nv, depth, the shared row stride, then per pass its round count,
# the offset of its cumulative step counts and the offset of its words),
# then the tables.  Each word is one update of one lane, 64 bits: fields
# p, q, r, t of LANE_FIELD_BITS bits, byte offsets into the env's shared
# block (its compact factor at an odd row stride, then x, then the L
# solve's partial sums), with flags FIRST (the target's first update),
# LAST (its last) and VALID (clear in a padding word) in the bits above
# p, q and r (csrc/ldl.cu's MJTPU_LDL_LANE_FIELD_BITS and
# MJTPU_LDL_LANES).  Each pass's words end with one step of padding,
# which the kernel's lookahead reads past a round's last step.
LANES = 32
LANES_HEADER = 12
LANE_FIELD_BITS = 15
LANE_FIELD_LIMIT = 1 << LANE_FIELD_BITS


def lane_stride(depth: int) -> int:
  """The lanes kernel's shared row stride: odd, so rows start on
  different banks."""
  return depth | 1


def lane_block(nv: int, depth: int) -> int:
  """Entries of one env's shared block in the lanes kernel: the compact
  factor at lane_stride, x and the L solve's partial sums."""
  return nv * lane_stride(depth) + 2 * nv


def _l_push(s: Structure) -> list[tuple[_Lists, np.ndarray, np.ndarray]]:
  """The L solve by ancestor level, for the lanes kernel: in round l every
  row k deeper than l adds its term L[k, c] x[anc[k, c]] for its ancestor
  at level l (final since round l - 1), so each row still sums its terms
  in ascending c, the twin's order, while all deeper rows share a round.
  Per round: the rows as one-source lists (sources (k*D + c, anc)), and
  per row whether the term is its first (level 0) and its last (the
  parent: then x[k] -= the sum)."""
  D = s.depth
  level = (s.anc < s.nv).sum(axis=1) - 1
  out = []
  for lv in range(D - 1):
    ks = np.nonzero(level > lv)[0].astype(np.int64)
    c = D - 1 - (level[ks] - lv)
    src = np.stack([ks * D + c, s.anc[ks, c].astype(np.int64)], axis=1)
    lists = _Lists(ks, np.arange(len(ks) + 1, dtype=np.int64), src)
    out.append((lists, np.full(len(ks), lv == 0), level[ks] == lv + 1))
  return out


def _deal(lists: _Lists) -> list[list[int]]:
  """A round's targets dealt to the LANES lanes: longest list first, each to
  the least loaded lane (the lowest on a tie).  A lane sums each of its
  targets' lists whole, so the order of each sum is the twin's."""
  counts = np.diff(lists.ptr)
  load, own = np.zeros(LANES, dtype=np.int64), [[] for _ in range(LANES)]
  for i in sorted(range(len(counts)), key=lambda i: (-counts[i], i)):
    lane = int(np.argmin(load))
    own[lane].append(i)
    load[lane] += counts[i]
  return own


def _list_flags(lists: _Lists) -> tuple[_Lists, np.ndarray, np.ndarray]:
  """A round of contribution lists with its flags per update: FIRST and
  LAST mark each target's first and last update."""
  u = np.arange(len(lists.sources))
  return lists, np.isin(u, lists.ptr[:-1]), np.isin(u, lists.ptr[1:] - 1)


def _lane_words(rounds: list, offsets) -> tuple[np.ndarray, np.ndarray]:
  """(cumulative steps per round (R + 1,), words (steps + 1, LANES) uint64)
  of rounds given as (_Lists, first, last), the flags per update;
  ``offsets(column, index)`` maps a source column (0-2) or the target (3)
  to its field.  Step s of a round is one word per lane, lane-major, so a
  warp reads one step with one coalesced load; one step of padding ends
  the words."""
  steps, blocks = [0], []
  for x, first_u, last_u in rounds:
    own = _deal(x)
    lane_u = [np.concatenate([np.arange(x.ptr[i], x.ptr[i + 1]) for i in tl])
              if tl else np.zeros(0, np.int64) for tl in own]
    lane_t = [np.concatenate([np.full(x.ptr[i + 1] - x.ptr[i], i) for i in tl])
              if tl else np.zeros(0, np.int64) for tl in own]
    n = max(len(u) for u in lane_u)
    words = np.zeros((n, LANES), dtype=np.uint64)
    for lane, (u, ti) in enumerate(zip(lane_u, lane_t)):
      if not len(u):
        continue
      src = np.zeros((len(u), 3), dtype=np.uint64)
      for col in range(x.sources.shape[1]):
        src[:, col] = offsets(col, x.sources[u, col])
      first, last = first_u[u].astype(np.uint64), last_u[u].astype(np.uint64)
      b = np.uint64(LANE_FIELD_BITS)
      words[:len(u), lane] = (
          src[:, 0] | first << b | src[:, 1] << np.uint64(16) | last << (np.uint64(16) + b)
          | src[:, 2] << np.uint64(32) | np.uint64(1) << (np.uint64(32) + b)
          | offsets(3, x.targets[ti]).astype(np.uint64) << np.uint64(48))
    blocks.append(words)
    steps.append(steps[-1] + n)
  words = np.concatenate(blocks + [np.zeros((1, LANES), dtype=np.uint64)])
  return np.asarray(steps, dtype=np.int64), words


def lanes_fit(nv: int, depth: int, item: int) -> bool:
  """Whether a tree's shared block at ``item`` bytes an entry fits the
  lane words' byte-offset fields."""
  return lane_block(nv, depth) * item <= LANE_FIELD_LIMIT


def _pack_lanes(s: Structure, flists: list[_Lists], ltlists: list[_Lists],
                item: int) -> np.ndarray:
  """The int32 lane-major schedule that csrc/ldl.cu's lanes kernel reads
  (layout above LANES_HEADER) for entries of ``item`` bytes; the words
  start at even offsets, so each is 8-byte aligned on the device."""
  if not lanes_fit(s.nv, s.depth, item):
    raise ValueError(f"a tree of nv={s.nv}, depth={s.depth} does not fit the lane schedule's"
                     f" {LANE_FIELD_BITS}-bit fields at {item} bytes an entry")
  D, ld, nv = s.depth, lane_stride(s.depth), s.nv
  # byte offsets: S[k, c] at k * ld + c, x[i] at nv * ld + i, the L solve's
  # partial sums after x
  entry = lambda i: (np.asarray(i) // D * ld + np.asarray(i) % D) * item
  dof = lambda i: (nv * ld + np.asarray(i)) * item
  factor = lambda col, i: entry(i)
  solve = lambda col, i: entry(i) if col == 0 else dof(i)
  header, parts, offset = [nv, D, ld], [], LANES_HEADER
  for rounds, offsets in (([_list_flags(x) for x in flists], factor),
                          ([_list_flags(x) for x in ltlists], solve), (_l_push(s), solve)):
    steps, words = _lane_words(rounds, offsets)
    pad = (offset + len(steps)) % 2
    header += [len(rounds), offset, offset + len(steps) + pad]
    parts += [steps, np.zeros(pad, np.int64), words.ravel().view(np.uint32).astype(np.int64)]
    offset += len(steps) + pad + 2 * words.size
  header += [0] * (LANES_HEADER - len(header))
  packed = np.concatenate([np.asarray(header, dtype=np.int64)] + parts)
  return packed.astype(np.uint32).view(np.int32)


class _Twin(NamedTuple):
  """The plain ``factor`` / ``solve``'s index tensors: factor_rounds, per
  round (a, b, d, slots), the sources of its updates in list order and,
  per contribution slot j, (targets with more than j contributions, the
  position of their j-th); lt_rounds, per round (L index, x index, slots);
  l_rounds, per depth round (ks (K,), the flat compact indices (K, t) of
  their t real ancestor entries, those ancestors (K, t))."""

  factor_rounds: tuple
  lt_rounds: tuple
  l_rounds: tuple


def _slots(lists: _Lists, to_device) -> tuple:
  """Per contribution slot j: (the targets with more than j contributions,
  the position of their j-th in the round's list)."""
  counts = np.diff(lists.ptr)
  return tuple((to_device(lists.targets[counts > j]), to_device(lists.ptr[:-1][counts > j] + j))
               for j in range(int(counts.max(initial=0))))


def _ints(device):
  return lambda x: torch.as_tensor(np.asarray(x, dtype=np.int64), device=device)


@dataclasses.dataclass(frozen=True, eq=False)
class Tables:
  """One Structure's schedule on a device (see the module docstring).

  gather (nv*D,) dense flat index i*nv + anc_clip[i, c] of each compact
  entry, mask (nv*D,) 1 where the entry is a real ancestor, real_compact /
  real_dense the flat indices of the real entries in either layout, sched
  the packed int32 schedule of kernel B2's shared variant, lanes the
  lane-major schedule of its lanes variant (None for a tree whose indices
  do not fit its fields).  ``twin``, the plain version's index tensors, is
  built at its first use: a step on the card never reads it."""

  structure: Structure
  gather: torch.Tensor
  mask: torch.Tensor
  real_compact: torch.Tensor
  real_dense: torch.Tensor
  sched: torch.Tensor
  lanes: torch.Tensor | None

  @property
  def nv(self) -> int:
    return self.structure.nv

  @property
  def depth(self) -> int:
    return self.structure.depth

  @property
  def dtype(self) -> torch.dtype:
    """The dtype the tables were built for: the lane schedule's byte
    offsets are in its entries' size."""
    return self.mask.dtype

  @functools.cached_property
  def twin(self) -> _Twin:
    s, t, D = self.structure, _ints(self.sched.device), self.structure.depth
    factor_rounds = tuple((t(x.sources[:, 0]), t(x.sources[:, 1]), t(x.sources[:, 2]),
                           _slots(x, t)) for x in _factor_lists(s))
    lt_rounds = tuple((t(x.sources[:, 0]), t(x.sources[:, 1]), _slots(x, t))
                      for x in _lt_lists(s))
    l_rounds = []
    for ks in s.depth_rounds:
      cols = np.arange(D - 1 - int((s.anc[ks[0]] < s.nv).sum() - 1), D - 1)
      l_rounds.append((t(ks), t(ks[:, None].astype(np.int64) * D + cols), t(s.anc[ks][:, cols])))
    return _Twin(factor_rounds, lt_rounds, tuple(l_rounds))


def device_tables(s: Structure, dtype: torch.dtype, device) -> Tables:
  """Uploads ``s``'s schedule to ``device`` (once per Model: ``tables``)."""
  t = _ints(device)
  rows = np.arange(s.nv)[:, None]
  real = (s.anc < s.nv).ravel()
  flists, ltlists = _factor_lists(s), _lt_lists(s)
  item = torch.empty((), dtype=dtype).element_size()
  return Tables(
      structure=s,
      gather=t((rows * s.nv + s.anc_clip).ravel()),
      mask=torch.as_tensor(s.mask.ravel(), dtype=dtype, device=device),
      real_compact=t(np.nonzero(real)[0]),
      real_dense=t((rows * s.nv + s.anc).ravel()[real]),
      sched=torch.as_tensor(_pack(s, flists, ltlists), device=device),
      lanes=torch.as_tensor(_pack_lanes(s, flists, ltlists, item), device=device)
      if lanes_fit(s.nv, s.depth, item) else None,
  )


def tables(m: Model) -> Tables | None:
  """The model's schedule on its device, or None on the dense or blocked
  path; built at first use and cached on the Model, so no step copies
  from the host."""
  return cached(m, "sparse.tables", lambda: None if structure(m) is None
                else device_tables(structure(m), m.dtype, m.device))


# ---------------------------------------------------------------------------
# the plain batched factor and solve (kernel B2's twin)
# ---------------------------------------------------------------------------


def gather_compact(t: Tables, M: torch.Tensor) -> torch.Tensor:
  """The compact (B, nv, depth) layout of chain-pattern matrices M (B, nv,
  nv) (mjtpu's gather_compact): pad entries are 0."""
  B = M.shape[0]
  return (M.reshape(B, -1)[:, t.gather] * t.mask).reshape(B, t.nv, t.depth)


def scatter_dense(t: Tables, S: torch.Tensor) -> torch.Tensor:
  """Spreads compact factors S (B, nv, depth) into Data's dense (B, nv, nv)
  qLD: lower triangle L's off-diagonals, diagonal D, zero elsewhere."""
  B = S.shape[0]
  out = S.new_zeros((B, t.nv * t.nv))
  out[:, t.real_dense] = S.reshape(B, -1)[:, t.real_compact]
  return out.reshape(B, t.nv, t.nv)


def _floor(x: torch.Tensor) -> torch.Tensor:
  # clamp_min lets NaN through, as jnp.maximum and the kernel do
  return torch.clamp_min(x, MINVAL)


def factor(t: Tables, Mc: torch.Tensor) -> torch.Tensor:
  """Compact LDL factors (B, nv, depth) of compact matrices Mc (B, nv,
  depth): column depth-1 holds D (pivots floored at MINVAL, as
  mj_factorM), column depth-1-p L[k, ancestor at distance p] (unit-lower
  L, M = Lᵀ D L).  Each update is M[t] - (M[a] * M[b]) / max(M[d],
  MINVAL), applied per target in list order."""
  B = Mc.shape[0]
  S = Mc.reshape(B, -1).clone()
  for a, b, d, slots in t.twin.factor_rounds:
    vals = (S[:, a] * S[:, b]) / _floor(S[:, d])
    for tgt, u in slots:
      S[:, tgt] = S[:, tgt] - vals[:, u]
  S = S.reshape(B, t.nv, t.depth)
  dia = _floor(S[:, :, -1:])
  return torch.cat([S[:, :, :-1] / dia, dia], dim=2)


def solve(t: Tables, S: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Solves M x = b (B, nv) from compact factors S (B, nv, depth)."""
  B = S.shape[0]
  Sf = S.reshape(B, -1)
  x = b.clone()
  # Lᵀ y = b: descendants first; a finished y[k] pushes into its ancestors
  for li, xi, slots in t.twin.lt_rounds:
    vals = Sf[:, li] * x[:, xi]
    for tgt, u in slots:
      x[:, tgt] = x[:, tgt] - vals[:, u]
  x = x / _floor(S[:, :, -1])
  # L x = y: ancestors first; x[k] -= sum_c L[k, c] x[anc[k, c]], c ascending
  for ks, li, anc in t.twin.l_rounds:
    acc = Sf[:, li[:, 0]] * x[:, anc[:, 0]]
    for j in range(1, li.shape[1]):
      acc = acc + Sf[:, li[:, j]] * x[:, anc[:, j]]
    x[:, ks] = x[:, ks] - acc
  return x
