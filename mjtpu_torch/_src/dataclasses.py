"""Struct machinery for mjtpu_torch: plain dataclasses of tensors.

Mirrors mjtpu/_src/dataclasses.py's split without the pytree registration:

  * **tensor fields** hold ``torch.Tensor`` values (Model: unbatched; Data:
    a leading env axis ``B`` on every field).
  * **static fields** hold host structure (python ints, enum codes, numpy
    index tables).  Python control flow and index construction read them;
    they never move to the device.

PyTorch runs eagerly, so there is no trace to specialize: host-side
precomputation that mjtpu redoes at trace time (and memoizes with
``lru_cache``) is computed once per Model and kept in ``Model.cache``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, TypeVar

import torch

_T = TypeVar("_T")


def static(default: Any = dataclasses.MISSING, **kwargs) -> Any:
  """Marks a dataclass field as host structure rather than a tensor."""
  metadata = dict(kwargs.pop("metadata", ()) or {})
  metadata["static"] = True
  if default is not dataclasses.MISSING:
    kwargs["default"] = default
  return dataclasses.field(metadata=metadata, **kwargs)


def is_static(f: dataclasses.Field) -> bool:
  return bool(f.metadata.get("static"))


def replace(obj: _T, **changes) -> _T:
  """A shallow copy of ``obj`` with ``changes`` applied (no tensor copies)."""
  return dataclasses.replace(obj, **changes)


def map_tensors(obj: _T, fn: Callable[[torch.Tensor], torch.Tensor]) -> _T:
  """Applies ``fn`` to every tensor field, recursing into nested structs."""
  changes = {}
  for f in dataclasses.fields(obj):
    if not f.init or is_static(f):
      continue
    v = getattr(obj, f.name)
    if isinstance(v, torch.Tensor):
      changes[f.name] = fn(v)
    elif dataclasses.is_dataclass(v):
      changes[f.name] = map_tensors(v, fn)
  return dataclasses.replace(obj, **changes)


def to(obj: _T, device=None, dtype: torch.dtype | None = None) -> _T:
  """Moves every tensor field to ``device``; floating fields also take
  ``dtype`` when it is given (integer and bool fields keep theirs)."""

  def move(t: torch.Tensor) -> torch.Tensor:
    if dtype is not None and t.is_floating_point():
      return t.to(device=device, dtype=dtype)
    return t.to(device=device)

  return map_tensors(obj, move)
