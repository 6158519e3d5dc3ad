"""Writes the committed data files of the mjtpu_torch port.

  mjtpu_torch/assets/humanoid_bench_model.npz
      every MjModel attribute mjtpu_torch.put_model reads (with opt.* and
      stat.*), so the port loads the model where ``mujoco`` is absent.
  mjtpu_torch/assets/humanoid_bench_golden.npz
      a reference trajectory from mjtpu at float64 on the CPU:
        qpos0, qvel0, ctrl     B=4 initial states (numpy seed 0: qpos0
                               +-0.01, ctrl uniform in [-1, 1], qvel 0)
        qpos, qvel             (100, 4, ...) after each of 100 steps of
                               jit(vmap(mjtpu.step))
        qacc, efc_force, contact_dist   after the first step
        conv_qpos, conv_qvel   (100, 4, ...) from the same states with the
                               solver run to convergence (opt.iterations
                               and opt.ls_iterations = CONVERGED, stored
                               as converged_iterations)

Run from the repository root, where ``mujoco`` and ``jax`` are installed:

    JAX_PLATFORMS=cpu PYTHONPATH=$(pwd) python scripts/torch_port_assets.py [--out DIR]

XLA compiles for the host's vector ISA, and the truncated solver of
humanoid_bench amplifies the ULP differences between ISAs (AVX-512 against
AVX2: 1.6e-8 in qvel over 100 steps).  The script caps XLA at AVX2
(``--xla_cpu_max_isa=AVX2``) so every x86 host with AVX2 writes the same
trajectory.  tests/test_torch_assets.py runs it into a temporary directory
and holds the result to the committed files.
"""

from __future__ import annotations

import argparse
import os
import pathlib

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
XML = ROOT / "mjtpu" / "zoo" / "assets" / "humanoid_bench.xml"
ASSETS = ROOT / "mjtpu_torch" / "assets"
MODEL_FILE = ASSETS / "humanoid_bench_model.npz"
GOLDEN_FILE = ASSETS / "humanoid_bench_golden.npz"
BATCH = 4
STEPS = 100
# solver iterations / linesearch iterations that run humanoid_bench's
# Newton solve to convergence (it stops after at most 4 iterations)
CONVERGED = 10


def load_mjmodel():
  import mujoco

  return mujoco.MjModel.from_xml_path(str(XML))


def initial_state(mjm, batch: int = BATCH, seed: int = 0):
  """(qpos, qvel, ctrl) for ``batch`` envs around qpos0."""
  rng = np.random.default_rng(seed)
  qpos = mjm.qpos0[None] + rng.uniform(-0.01, 0.01, (batch, mjm.nq))
  qvel = np.zeros((batch, mjm.nv))
  ctrl = rng.uniform(-1.0, 1.0, (batch, mjm.nu))
  return qpos, qvel, ctrl


def trajectory(mjm, steps: int = STEPS):
  """Steps mjtpu (f64, CPU) B envs from initial_state: (qpos (steps, B, nq),
  qvel (steps, B, nv), the Data after the first step)."""
  import jax

  jax.config.update("jax_enable_x64", True)
  import jax.numpy as jnp

  import mjtpu

  qpos0, qvel0, ctrl = initial_state(mjm)
  m = mjtpu.put_model(mjm, dtype=jnp.float64)
  d = jax.vmap(lambda _: mjtpu.make_data(m))(jnp.arange(BATCH))
  d = d.replace(qpos=jnp.asarray(qpos0), qvel=jnp.asarray(qvel0), ctrl=jnp.asarray(ctrl))
  step = jax.jit(jax.vmap(mjtpu.step, in_axes=(None, 0)))
  qpos, qvel = [], []
  for i in range(steps):
    d = step(m, d)
    qpos.append(np.asarray(d.qpos))
    qvel.append(np.asarray(d.qvel))
    if i == 0:
      first = jax.tree.map(np.asarray, d)
  return np.stack(qpos), np.stack(qvel), first


def golden(mjm, steps: int = STEPS) -> dict[str, np.ndarray]:
  """The golden file's arrays (module docstring)."""
  import copy

  qpos0, qvel0, ctrl = initial_state(mjm)
  qpos, qvel, first = trajectory(mjm, steps)
  conv = copy.copy(mjm)
  conv.opt.iterations = CONVERGED
  conv.opt.ls_iterations = CONVERGED
  conv_qpos, conv_qvel, _ = trajectory(conv, steps)
  return {
      "qpos0": qpos0, "qvel0": qvel0, "ctrl": ctrl, "qpos": qpos, "qvel": qvel,
      "qacc": first.qacc, "efc_force": first.efc_force,
      "contact_dist": first.contact.dist, "conv_qpos": conv_qpos,
      "conv_qvel": conv_qvel, "converged_iterations": np.array(CONVERGED),
  }


def main():
  parser = argparse.ArgumentParser(description="Writes the mjtpu_torch data files.")
  parser.add_argument("--out", type=pathlib.Path, default=ASSETS,
                      help="directory for both files (default: the package's assets)")
  out = parser.parse_args().out
  # before jax is imported: the flag is read when the CPU backend starts
  os.environ["XLA_FLAGS"] = (
      os.environ.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX2").strip()
  from mjtpu_torch._src import io

  out.mkdir(parents=True, exist_ok=True)
  mjm = load_mjmodel()
  io.save_snapshot(mjm, out / MODEL_FILE.name)
  np.savez_compressed(out / GOLDEN_FILE.name, **golden(mjm))
  for name in (MODEL_FILE.name, GOLDEN_FILE.name):
    print(f"wrote {out / name} ({(out / name).stat().st_size} bytes)")


if __name__ == "__main__":
  main()
