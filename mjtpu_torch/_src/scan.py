"""Iteration substrate: grouped entity scans over the kinematic structure.

Port of mjtpu/_src/scan.py.  The same two primitives, batch-explicit:
entities are grouped by static signature (plain numpy over Model fields,
computed once per Model and kept in ``Model.cache``), and ``f`` runs once
per group on tensors shaped (B, k, ...) — B envs, k entities of the group —
instead of under ``jax.vmap``.

Type characters (an arg/out's entity axis):
  'b' body   (nbody)      'j' joint (njnt)     'q' qpos (nq)   'v' dof (nv)

Every tensor argument carries a leading env axis: Data fields as they are,
Model fields as ``x[None]`` (broadcast over the envs).  Numpy arguments are
static: constant within a group (they define the group key) and passed to
``f`` as the host values of the group's first entity.  'b' arguments reach
``f`` as (B, k, ...); 'j', 'q', 'v' arguments as (B, k, w, ...) with w the
group's per-body width.

Sums are deterministic: ``segment_sum`` gathers over static child tables
and adds in a fixed order, with no ``index_add_`` (CUDA implements that
with atomics, whose order changes from run to run).
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from mjtpu_torch._src.types import JointType, Model, cached


def segment_table(segments: list[np.ndarray], n: int, device) -> torch.Tensor:
  """(len(segments), width) gather table for segment_sum: row s lists the
  indices summed into bucket s, padded with n (a zero row)."""
  width = max((len(s) for s in segments), default=0)
  table = np.full((len(segments), width), n, dtype=np.int64)
  for s, ids in enumerate(segments):
    table[s, : len(ids)] = ids
  return torch.as_tensor(table, device=device)


def segment_sum(data: torch.Tensor, table: torch.Tensor, dim: int = 1) -> torch.Tensor:
  """Sums ``data`` along ``dim`` into one bucket per row of ``table``
  (segment_table).

  Gathers instead of scattering: each bucket's members are added one
  table column at a time, left to right, so the order of every sum is
  fixed by the table (an empty bucket gives zeros).
  """
  shape = list(data.shape)
  shape[dim] = 1
  padded = torch.cat([data, data.new_zeros(shape)], dim=dim)
  shape[dim] = table.shape[0]
  out = data.new_zeros(shape)
  for c in range(table.shape[1]):
    out = out + padded.index_select(dim, table[:, c])
  return out


# ---------------------------------------------------------------------------
# host-side structure (cached per Model)
# ---------------------------------------------------------------------------


def body_levels(m: Model) -> list[np.ndarray]:
  def build():
    parentid = np.asarray(m.body_parentid)
    depth = np.zeros(m.nbody, dtype=np.int64)
    for i in range(1, m.nbody):
      depth[i] = depth[parentid[i]] + 1
    return [np.where(depth == lvl)[0] for lvl in range(depth.max() + 1)]

  return cached(m, "scan.body_levels", build)


def _body_sig(m: Model, b: int) -> tuple:
  """Joint-type signature of a body (the grouping key)."""
  ja, jn = int(m.body_jntadr[b]), int(m.body_jntnum[b])
  return tuple(int(m.jnt_type[j]) for j in range(ja, ja + jn))


def _body_indices(m: Model, b: int, typ: str) -> list[int]:
  ja, jn = int(m.body_jntadr[b]), int(m.body_jntnum[b])
  if typ == 'j':
    return list(range(ja, ja + jn))
  idx = []
  for j in range(ja, ja + jn):
    jt = JointType(int(m.jnt_type[j]))
    if typ == 'q':
      a = int(m.jnt_qposadr[j])
      idx += list(range(a, a + jt.qpos_width()))
    else:
      a = int(m.jnt_dofadr[j])
      idx += list(range(a, a + jt.dof_width()))
  return idx


def _entity_count(m: Model, typ: str) -> int:
  return {'b': m.nbody, 'j': m.njnt, 'q': m.nq, 'v': m.nv}[typ]


class _Group:
  """Static index tables of one group of bodies."""

  def __init__(self, m: Model, ids: list[int], device):
    self.ids = np.asarray(ids)
    self.np_idx = {'b': self.ids.reshape(-1, 1)}
    for t in 'jqv':
      self.np_idx[t] = np.array(
          [_body_indices(m, b, t) for b in ids], dtype=np.int64
      ).reshape(len(ids), -1)
    self.idx = {t: torch.as_tensor(v, device=device) for t, v in self.np_idx.items()}
    self.parent = torch.as_tensor(np.asarray(m.body_parentid)[self.ids], device=device)
    # reverse scans: segment_table of each body's direct children, or None
    # when no body of the group has children
    self.children: torch.Tensor | None = None


def _groups(m: Model, ids) -> list[_Group]:
  groups: dict[tuple, list[int]] = {}
  for b in ids:
    groups.setdefault(_body_sig(m, int(b)), []).append(int(b))
  return [_Group(m, g, m.device) for _, g in sorted(groups.items())]


def _tree_schedule(m: Model) -> list[list[_Group]]:
  def build():
    levels = body_levels(m)
    parentid = np.asarray(m.body_parentid)
    sched = [_groups(m, lvl) for lvl in levels]
    for li, groups in enumerate(sched[:-1]):
      nxt = levels[li + 1]
      for g in groups:
        children = [nxt[parentid[nxt] == b] for b in g.ids]
        if any(len(c) for c in children):
          g.children = segment_table(children, m.nbody, m.device)
    return sched

  return cached(m, "scan.tree_schedule", build)


def _flat_schedule(m: Model) -> list[_Group]:
  return cached(m, "scan.flat_schedule", lambda: _groups(m, range(m.nbody)))


# ---------------------------------------------------------------------------
# group calls
# ---------------------------------------------------------------------------


def _batch_size(args) -> int:
  return max((a.shape[0] for a in args if isinstance(a, torch.Tensor)), default=1)


def _take(arg: torch.Tensor, g: _Group, typ: str) -> torch.Tensor:
  if typ == 'b':
    return arg[:, g.idx['b'][:, 0]]
  return arg[:, g.idx[typ]]


def _call(g: _Group, f: Callable, carry, in_types: str, args):
  full = []
  for a, t in zip(args, in_types):
    if isinstance(a, np.ndarray):
      full.append(a[g.np_idx[t][0]] if t != 'b' else a[g.ids[0]])
    else:
      full.append(_take(a, g, t))
  return f(carry, *full)


def _scatter(out: dict, slot: int, typ: str, g: _Group, val: torch.Tensor, m: Model, batch: int):
  """Writes one group's output rows; buffers are allocated on first write.
  Indices within a group are unique, so the write is a plain assignment."""
  if typ == 'b':
    idx, val = g.idx['b'][:, 0], val
  else:
    if g.np_idx[typ].shape[1] == 0:
      return
    idx = g.idx[typ].reshape(-1)
    val = val.reshape(val.shape[:1] + (-1,) + val.shape[3:])
  val = val.expand((batch,) + val.shape[1:])
  if slot not in out:
    n = _entity_count(m, typ)
    out[slot] = torch.zeros((batch, n) + val.shape[2:], dtype=val.dtype, device=val.device)
  out[slot][:, idx] = val


def flat(m: Model, f: Callable, in_types: str, out_types: str, *args) -> Any:
  """Groups bodies by joint signature, runs f once per group, reorders.
  Returns None for an output no group wrote (e.g. a model with no joints)."""
  batch = _batch_size(args)
  out: dict[int, torch.Tensor] = {}
  for g in _flat_schedule(m):
    res = _call(g, lambda _c, *a: f(*a), None, in_types, args)
    if not isinstance(res, tuple):
      res = (res,)
    for slot, (typ, val) in enumerate(zip(out_types, res)):
      _scatter(out, slot, typ, g, val, m, batch)
  outs = tuple(out.get(i) for i in range(len(out_types)))
  return outs if len(out_types) > 1 else outs[0]


def body_tree(
    m: Model, f: Callable, in_types: str, out_types: str, *args, reverse: bool = False
) -> Any:
  """Level-wise scan over the kinematic tree.

  Forward (root->leaf): f's carry is the tuple of the parent's 'b'-typed
  outputs (None at the root level).  Reverse (leaf->root): the carry is the
  sum of the direct children's 'b'-typed outputs (None for a group none of
  whose bodies has children); f must treat a zero carry like None.
  """
  batch = _batch_size(args)
  sched = _tree_schedule(m)
  b_slots = [i for i, t in enumerate(out_types) if t == 'b']
  out: dict[int, torch.Tensor] = {}
  order = range(len(sched) - 1, -1, -1) if reverse else range(len(sched))

  for li in order:
    for g in sched[li]:
      carry = None
      if b_slots and not reverse and li > 0:
        carry = tuple(out[s][:, g.parent] for s in b_slots)
      elif b_slots and reverse and g.children is not None:
        carry = tuple(segment_sum(out[s], g.children) for s in b_slots)
      if carry is not None and len(carry) == 1:
        carry = carry[0]
      res = _call(g, f, carry, in_types, args)
      if not isinstance(res, tuple):
        res = (res,)
      for slot, (typ, val) in enumerate(zip(out_types, res)):
        _scatter(out, slot, typ, g, val, m, batch)

  outs = tuple(out.get(i) for i in range(len(out_types)))
  return outs if len(out_types) > 1 else outs[0]
