"""Builds and loads the port's hand-written CUDA kernels.

Each source under ``mjtpu_torch/csrc`` is compiled with ``nvcc`` for
sm_90a into a shared library with a plain C interface, at first use, into
``build/mjtpu_torch/`` (keyed by a hash of the source and the flags, so an
edited source builds afresh), and loaded with ctypes.  A build failure
raises; nothing falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent.parent / "build" / "mjtpu_torch"
# dynamic shared memory one block may use on Hopper (227 KB)
SMEM_LIMIT = 232448
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# per source: what its build printed (nvcc's -Xptxas -v register/smem
# report); absent when the library was loaded from an earlier build
build_logs: dict[str, str] = {}


def _nvcc() -> str:
  cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
  for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
    if cand and os.path.exists(cand):
      return cand
  raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def flags(extra: tuple[str, ...] = ()) -> tuple[str, ...]:
  return NVCC_FLAGS + tuple(extra)


def _so_path(source: str, extra: tuple[str, ...]) -> pathlib.Path:
  key = hashlib.sha256((CSRC / source).read_bytes() + " ".join(flags(extra)).encode())
  return BUILD_DIR / f"{pathlib.Path(source).stem}_{key.hexdigest()[:16]}.so"


def build(specs: list[tuple[str, tuple[str, ...]]]) -> None:
  """Compiles each (source, extra flags) not built yet: one nvcc per
  source, all started together.  Raises if any build fails."""
  procs = []
  for source, extra in specs:
    so = _so_path(source, extra)
    if so.exists():
      continue
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *flags(extra), "-o", str(tmp), str(CSRC / source)]
    procs.append((source, so, tmp, subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
  failed = []
  for source, so, tmp, proc in procs:
    build_logs[source] = proc.communicate(timeout=600)[0]
    if proc.returncode != 0:
      failed.append(f"nvcc failed to build {CSRC / source}:\n{build_logs[source]}")
    else:
      os.replace(tmp, so)
  if failed:
    raise RuntimeError("\n".join(failed))


def library(source: str, extra_flags: tuple[str, ...] = (),
            signatures: dict[str, tuple[list, object]] | None = None) -> ctypes.CDLL:
  """The loaded library built from ``csrc/<source>`` (built at first use),
  its entry points typed from ``signatures`` (name -> (argtypes,
  restype)).  Every library exports ``mjtpu_cuda_error_string(int)``."""
  with _lock:
    if source not in _libs:
      build([(source, extra_flags)])
      lib = ctypes.CDLL(str(_so_path(source, extra_flags)))
      sigs = {"mjtpu_cuda_error_string": ([ctypes.c_int], ctypes.c_char_p), **(signatures or {})}
      for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
      _libs[source] = lib
    return _libs[source]


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
  """Raises if a kernel's C entry point returned a CUDA error."""
  if err != 0:
    raise RuntimeError(f"{what} kernel launch failed: {lib.mjtpu_cuda_error_string(err).decode()}")


def refuse_grad(what: str, *tensors) -> None:
  """Raises where a kernel's wrapper would take an input that requires
  grad while grad mode is on: the wrapper's output carries no gradient,
  and a backward through it would silently leave the gradient out.  The
  engine calls the wrapper through its differentiable seam (``TwinGrad``,
  ``ldl.LdlFactorSolve``, ``ldl.LdlSolve``), whose forward runs it with
  grad mode off."""
  if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
    raise RuntimeError(
        f"the {what} kernel's wrapper has no backward, and an input requires grad: call it"
        " through its differentiable seam, or under torch.no_grad()")


class TwinGrad(torch.autograd.Function):
  """A kernel's output with its plain twin's gradient.  ``apply(kernel,
  twin, *inputs)``: the forward is ``kernel(*inputs)`` (a wrapper: the
  kernel on a CUDA tensor, the twin on a CPU tensor); the backward runs
  ``twin`` again on the saved inputs under grad mode and back-propagates
  the output gradients through it.  Integer outputs carry no gradient.
  The kernels agree with their twins (bit for bit, or to their stated
  tolerance), so the gradient is that of the forward's values; where a
  winner could differ at a tie, it is the twin's winner's."""

  @staticmethod
  def forward(ctx, kernel, twin, *inputs):
    ctx.twin = twin
    ctx.save_for_backward(*inputs)
    out = kernel(*inputs)
    outs = out if isinstance(out, tuple) else (out,)
    ctx.mark_non_differentiable(*(o for o in outs if not o.is_floating_point()))
    return out

  @staticmethod
  @torch.autograd.function.once_differentiable
  def backward(ctx, *grads):
    need = ctx.needs_input_grad[2:]
    with torch.enable_grad():
      xs = [x.detach().requires_grad_(n) for x, n in zip(ctx.saved_tensors, need)]
      out = ctx.twin(*xs)
    outs = out if isinstance(out, tuple) else (out,)
    pairs = [(o, g) for o, g in zip(outs, grads) if g is not None and o.requires_grad]
    wrt = [x for x in xs if x.requires_grad]
    got = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                   allow_unused=True) if pairs and wrt else [None] * len(wrt))
    return (None, None, *(next(got) if x.requires_grad else None for x in xs))
