"""Domain randomization: per-env Model rows (port of mjtpu/parallel/randomize.py).

mjtpu batches a Model under ``jax.vmap(step, in_axes=(axes, 0))``.  The
port's step is batch-explicit, so a randomized field simply holds one row
per env, ``(B, *shape)``, and the Model records which paths do
(``Model.env_fields``).  Every reader of such a field takes it through
``types.rows``, which gives a leading env axis of B or 1, so one step runs
every env under its own physics, and the tables a Model caches are built
from its own rows.

``randomize`` checks mjtpu's boundary and raises ``ValueError`` with its
meaning: a static field; a field whose consuming branch put_model gated
off (``dof_damping`` on a model without damping, ...); a value pattern
that put_model baked into the row layout (the frictionloss set, a limit's
two-sidedness); a ``geom_size`` that varies on a geom that is not a round
primitive.  It accepts every traced field mjtpu's randomize accepts
(``_ACCEPTED``).  Some of them change nothing, as in mjtpu: ``light_dir0``,
``dof_M0`` and the ``opt.o_*`` overrides are read nowhere, and per-env
``actuator_gear`` rows do not reach a model whose moment matrix put_model
baked (``actuator_static_moment``: every actuator a scalar-joint
transmission; ROADMAP C19).

As in mjtpu, randomizing masses or inertias leaves MuJoCo's derived
constants (``body_invweight0``, ``dof_M0``, ``stat.meaninertia``, ...) at
their base values; ``randomize_with_consts`` recomputes them per env with
MuJoCo's ``mj_setConst`` on the host, or the caller passes rows of them.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from mjtpu_torch._src import forward
from mjtpu_torch._src.dataclasses import is_static
from mjtpu_torch._src.types import Data, GeomType, Model, Option, Statistic, field, replace_fields

# fields whose consuming branch put_model gates off where the base model
# has them all zero (mjtpu's _GATED)
_GATED = {
    "dof_damping": "has_dof_damping",
    "jnt_stiffness": "has_jnt_spring",
    "tendon_stiffness": "has_tendon_spring",
    "tendon_damping": "has_tendon_damping",
    "tendon_armature": "has_tendon_armature",
    "body_gravcomp": "has_gravcomp",
}

# geom types whose collision reads the size per env (the others collide
# through hulls built from the host copy at put_model)
_ROUND_GEOMS = (int(GeomType.SPHERE), int(GeomType.CAPSULE), int(GeomType.ELLIPSOID),
                int(GeomType.CYLINDER))

# the mjModel fields mj_setConst derives from masses, inertias and geometry
# (mjtpu's _CONST_FIELDS), recomputed per env by randomize_with_consts
_CONST_FIELDS = (
    "body_subtreemass",
    "body_invweight0",
    "dof_invweight0",
    "dof_M0",
    "tendon_invweight0",
    "tendon_length0",
    "actuator_acc0",
)

# tensor fields that mjtpu declares static: the port keeps them on the
# device for its readers, and randomize refuses them as mjtpu does
_STATIC_TENSORS = frozenset(("actuator_static_moment",))


def _traced(cls, prefix: str = "") -> list[str]:
  """The dotted paths of the traced fields of ``cls`` (Model, with its
  Option and Statistic)."""
  out = []
  for f in dataclasses.fields(cls):
    if not f.init or is_static(f) or f.name in _STATIC_TENSORS:
      continue
    sub = {"opt": Option, "stat": Statistic}.get(f.name) if cls is Model else None
    out += _traced(sub, f"{f.name}.") if sub else [prefix + f.name]
  return out


# the fields the port randomizes, every traced field mjtpu's randomize
# accepts: every reader takes them through types.rows
_ACCEPTED = frozenset(_traced(Model))


def _resolve(m: Model, key: str):
  """The base value at the dotted path ``key``, refusing static and
  unknown fields with mjtpu's errors."""
  obj = m
  parts = key.split(".")
  for i, seg in enumerate(parts):
    fields = {f.name: f for f in dataclasses.fields(obj)}
    f = fields.get(seg)
    if f is not None and (is_static(f) or (obj is m and seg in _STATIC_TENSORS)):
      raise ValueError(
          f"'{key}' is a static (trace-time) field of {type(obj).__name__}: it is baked into"
          " the step's structure and cannot vary per env. Randomize traced fields only; to"
          " change structure, load a separate Model per variant.")
    if f is None or not f.init:
      raise ValueError(f"'{key}': {type(obj).__name__} has no traced field '{seg}'")
    obj = getattr(obj, seg)
    if obj is None and i < len(parts) - 1:
      raise ValueError(f"'{key}': '{seg}' is None on this model")
  return obj


def _check_patterns(m: Model, key: str, v: np.ndarray) -> None:
  """The randomized values keep the static structure put_model derived
  from the base values (mjtpu's _check_patterns)."""
  if key == "dof_frictionloss":
    mask = np.zeros(m.nv, bool)
    mask[np.asarray(m.friction_dofid)] = True
    if not ((v > 0) == mask).all():
      raise ValueError(
          "dof_frictionloss randomization must keep the nonzero-dof set fixed (static"
          f" friction rows): baked set {np.nonzero(mask)[0]}. Vary magnitudes only; zeros"
          " must stay zero and vice versa.")
  elif key == "tendon_frictionloss":
    mask = np.zeros(m.ntendon, bool)
    mask[np.asarray(m.friction_tenid)] = True
    if not ((v > 0) == mask).all():
      raise ValueError(
          "tendon_frictionloss randomization must keep the nonzero-tendon set fixed (static"
          f" friction rows): baked set {np.nonzero(mask)[0]}.")
  elif key in ("jnt_range", "jnt_margin"):
    rng = v if key == "jnt_range" else m.jnt_range.cpu().numpy()
    mrg = v if key == "jnt_margin" else m.jnt_margin.cpu().numpy()
    two = rng[..., 1] - rng[..., 0] < 2 * mrg
    if not (two == np.asarray(m.jnt_limit_two_sided)).all():
      raise ValueError(
          f"{key} randomization flips a joint's limit two-sidedness (range width vs"
          " 2*margin), which selects the static limit-row layout. Keep ranges on the same"
          " side of the 2*margin threshold.")
  elif key in ("tendon_range", "tendon_margin"):
    rng = v if key == "tendon_range" else m.tendon_range.cpu().numpy()
    mrg = v if key == "tendon_margin" else m.tendon_margin.cpu().numpy()
    two = rng[..., 1] - rng[..., 0] < 2 * mrg
    if not (two == np.asarray(m.tendon_limit_two_sided)).all():
      raise ValueError(
          f"{key} randomization flips a tendon's limit two-sidedness; the static limit-row"
          " layout cannot vary per env.")
  elif key == "geom_size":
    varies = np.any(v != np.asarray(m.geom_size_np), axis=(0, 2))
    bad = varies & ~np.isin(np.asarray(m.geom_type), _ROUND_GEOMS)
    if bad.any():
      raise ValueError(
          f"geom_size varies across the batch for geoms {np.nonzero(bad)[0]} whose type is"
          " not a round primitive. Box and mesh collisions run on convex hulls built at"
          " put_model from the host size copy, so their sizes cannot vary per env"
          " (sphere, capsule, ellipsoid and cylinder read the size per env).")


def _numpy(v) -> np.ndarray:
  return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def model_axes(m: Model, batched: Model) -> dict[str, int | None]:
  """Each tensor field path of ``m`` mapped to 0 where ``batched`` holds
  one row per env (one more leading axis than ``m``), else None: mjtpu's
  in_axes tree, flattened to dotted paths."""
  axes = {}

  def walk(a, b, prefix):
    for f in dataclasses.fields(a):
      if not f.init or is_static(f) or f.name in _STATIC_TENSORS:
        continue
      x, y = getattr(a, f.name), getattr(b, f.name)
      if dataclasses.is_dataclass(x):
        walk(x, y, prefix + f.name + ".")
      elif isinstance(x, torch.Tensor):
        axes[prefix + f.name] = 0 if y.dim() == x.dim() + 1 else None
      elif isinstance(y, torch.Tensor):  # dof_M0: rows where the base has none
        axes[prefix + f.name] = 0

  walk(m, batched, "")
  return axes


def randomize(m: Model, updates: dict[str, Any]) -> tuple[Model, dict[str, int | None]]:
  """A Model with one row per env of each field in ``updates``, and its
  axes (model_axes).

  Args:
    m: the base Model from put_model.
    updates: dotted field paths ("geom_friction", "opt.timestep", ...)
      mapped to arrays or tensors of shape (B, *field.shape), one row per
      env.

  Returns:
    (batched_model, axes): step env i of a B-env Data under row i of every
    randomized field with ``step(batched_model, d)``.  Rows that are
    tensors requiring grad stay in the graph: under differentiable_mode()
    a loss of the step's outputs back-propagates to each env's row (the
    value-pattern checks are skipped for them, as mjtpu skips them for
    tracers).

  Raises:
    ValueError: mjtpu's refusals (see the module docstring), and shape or
      batch-size mismatches.
  """
  if not updates:
    raise ValueError("randomize() needs at least one field update")
  batch = None
  cast: dict[str, torch.Tensor] = {}
  for key, v in updates.items():
    base = _resolve(m, key)
    if base is None and key == "dof_M0":
      # read nowhere, so put_model leaves it out; rows are carried as given
      base = m.qpos0.new_zeros(m.nv)
    if base is None:
      raise ValueError(f"'{key}' is None on this model (absent subsystem)")
    base_shape, v_shape = tuple(base.shape), tuple(np.shape(v))
    if len(v_shape) != len(base_shape) + 1 or v_shape[1:] != base_shape:
      raise ValueError(f"'{key}': expected shape (B, *{base_shape}), got {v_shape}")
    if batch is None:
      batch = v_shape[0]
    elif v_shape[0] != batch:
      raise ValueError(f"inconsistent batch sizes: '{key}' has {v_shape[0]}, earlier fields"
                       f" have {batch}")
    gate = _GATED.get(key)
    if gate is not None and not getattr(m, gate):
      raise ValueError(
          f"'{key}' cannot be randomized: the base model has all-zero {key}, so put_model"
          f" set {gate}=False and the consuming branch does not run. Re-load the model with"
          " a nonzero value (e.g. a tiny epsilon in the MJCF) to enable the gate.")
    if key == "geom_fluid" and not m.opt.has_fluid_params:
      raise ValueError(
          "'geom_fluid' cannot be randomized: opt.has_fluid_params is False, so the fluid"
          " force branch does not run. Set a nonzero density, viscosity or wind in the MJCF.")
    if not (isinstance(v, torch.Tensor) and v.requires_grad):
      # rows that require grad are the point of a gradient (system
      # identification): their values are not read on the host, as mjtpu
      # skips the checks for tracers
      _check_patterns(m, key, _numpy(v))
    cast[key] = torch.as_tensor(v).to(device=base.device, dtype=base.dtype)
  mb = replace_fields(m, {**cast, "env_fields": frozenset(m.env_fields | set(cast))})
  return mb, model_axes(m, mb)


def randomize_with_consts(mjm, m: Model, updates: dict[str, Any]):
  """randomize, with each env's derived constants (body_invweight0,
  dof_M0, stat.meaninertia, ...) recomputed by MuJoCo's mj_setConst on a
  scratch copy of ``mjm`` (the MjModel ``m`` was built from), as mjtpu's
  randomize_with_consts.  Needs the ``mujoco`` bindings on the host
  (ImportError without them; _derived_constants gives the rows to commit
  where the card's machine has none)."""
  full = dict(updates)
  for name, rows in _derived_constants(mjm, updates).items():
    if name in full:
      continue  # the caller's own rows win
    base = _resolve(m, name)
    if (base is None and name != "dof_M0") or not rows[0].size:
      continue  # an absent subsystem (no tendons or actuators)
    full[name] = rows
  return randomize(m, full)


def _derived_constants(mjm, updates: dict[str, Any]) -> dict[str, np.ndarray]:
  """(B, *shape) rows of each of _CONST_FIELDS and stat.meaninertia,
  from mj_setConst after writing each env's ``updates`` into a scratch
  copy of the MjModel ``mjm``."""
  import copy

  import mujoco

  B = next(iter(updates.values())).shape[0]
  scratch = copy.copy(mjm)
  d_scratch = mujoco.MjData(scratch)
  derived: dict[str, list[np.ndarray]] = {k: [] for k in (*_CONST_FIELDS, "stat.meaninertia")}
  for i in range(B):
    for key, v in updates.items():
      *parents, leaf = key.split(".")
      tgt = scratch
      for p in parents:
        tgt = getattr(tgt, p)
      row = _numpy(v)[i]
      if np.ndim(getattr(tgt, leaf)):
        getattr(tgt, leaf)[...] = row
      else:  # a scalar field (opt.timestep) is not writable in place
        setattr(tgt, leaf, row.item())
    mujoco.mj_setConst(scratch, d_scratch)
    for name in _CONST_FIELDS:
      derived[name].append(np.array(getattr(scratch, name)))
    derived["stat.meaninertia"].append(np.float64(scratch.stat.meaninertia))
  return {name: np.stack(rows) for name, rows in derived.items()}


def randomized_step(m: Model, updates: dict[str, Any]):
  """(step_fn, batched_model): ``step_fn(d)`` steps env i of the B-env
  Data ``d`` under row i of every randomized field (mjtpu's jitted
  ``vmap(step)`` over per-env physics)."""
  mb, _ = randomize(m, updates)
  batch = field(mb, next(iter(updates))).shape[0]

  def step_fn(d: Data) -> Data:
    if d.batch_size != batch:
      raise ValueError(f"the Data has {d.batch_size} envs, the randomized model {batch}")
    return forward.step(mb, d)

  return step_fn, mb
