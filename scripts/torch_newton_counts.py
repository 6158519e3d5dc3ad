"""Newton's iteration counts per env: mjtpu against mjtpu_torch, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=$(pwd) python scripts/torch_newton_counts.py \
        [--xml mjtpu/zoo/assets/ant.xml] [--batch 1024] [--steps 40] [--dtype float32]

Steps both engines from the same numpy-seeded states (the Ant env's reset
distribution: qpos0 +-0.1, qvel 0.1 x normal, ctrl uniform in [-1, 1])
and prints, after each physics step, the last forward pass's
``solver_niter`` in each (max, mean, and the envs whose counts differ),
and the port's Newton iterations and linesearch rounds over the step
(``solver.loop_counts``, the loops of the slowest env).  Counts only: no
time here says anything about a GPU.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main() -> int:
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument("--xml", default=str(ROOT / "mjtpu" / "zoo" / "assets" / "ant.xml"))
  p.add_argument("--batch", type=int, default=1024)
  p.add_argument("--steps", type=int, default=40)
  p.add_argument("--dtype", default="float32", choices=("float32", "float64"))
  args = p.parse_args()
  sys.path.insert(0, str(ROOT))
  import jax

  jax.config.update("jax_enable_x64", True)
  import jax.numpy as jnp
  import mujoco
  import torch

  import mjtpu
  import mjtpu_torch
  from mjtpu_torch._src import solver

  mjm = mujoco.MjModel.from_xml_path(args.xml)
  rng = np.random.default_rng(0)
  b = args.batch
  qpos = mjm.qpos0[None] + rng.uniform(-0.1, 0.1, (b, mjm.nq))
  qvel = 0.1 * rng.normal(size=(b, mjm.nv))
  ctrl = rng.uniform(-1.0, 1.0, (b, mjm.nu))
  jd, td = getattr(jnp, args.dtype), getattr(torch, args.dtype)
  m = mjtpu.put_model(mjm, dtype=jd)
  d = jax.vmap(lambda _: mjtpu.make_data(m))(jnp.arange(b))
  d = d.replace(qpos=jnp.asarray(qpos, jd), qvel=jnp.asarray(qvel, jd), ctrl=jnp.asarray(ctrl, jd))
  step = jax.jit(jax.vmap(mjtpu.step, in_axes=(None, 0)))
  tm = mjtpu_torch.put_model(mjm, dtype=td, device="cpu")
  t = mjtpu_torch.replace(
      mjtpu_torch.make_data(tm, batch_size=b), qpos=torch.as_tensor(qpos, dtype=td),
      qvel=torch.as_tensor(qvel, dtype=td), ctrl=torch.as_tensor(ctrl, dtype=td))
  for i in range(args.steps):
    d = step(m, d)
    loops = dict(solver.loop_counts)
    t = mjtpu_torch.step(tm, t)
    nj, nt = np.asarray(d.solver_niter), t.solver_niter.numpy()
    print(f"step {i + 1}: last pass's iterations mjtpu max {nj.max()} mean {nj.mean():.2f},"
          f" port max {nt.max()} mean {nt.mean():.2f}, envs that differ {int((nj != nt).sum())};"
          f" port loops this step: {solver.loop_counts['iterations'] - loops['iterations']}"
          f" iterations, {solver.loop_counts['ls_rounds'] - loops['ls_rounds']} linesearch rounds",
          flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
