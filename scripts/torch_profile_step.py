"""Where a mjtpu_torch step's time goes on the GPU.

    python scripts/torch_profile_step.py
        [--model humanoid_bench|humanoid_terrain|scene_pile|branchy66|ant_bench|ant_env
                 |cylinder_drop]
        [--batch 4096] [--dtype float32] [--steps 5] [--out build/profile]

Runs the model from its committed snapshot on CUDA (from qpos0 +-0.01,
numpy seed 1, as chip_smoke.py starts it; scene_pile's bodies also
dropped 0.25 m; ant_bench's joints uniform over their ranges), warms up,
then traces ``--steps`` steps with torch.profiler (CPU and CUDA
activity).  ``--model ant_env`` runs the Ant env instead
(``mjtpu_torch.zoo.ENVS["ant"]``, reset and actions uniform in [-1, 1]
from a torch.Generator seeded 0, as chip_smoke.py runs it): its
``--warmup`` and ``--steps`` count env steps (each 5 RK4 physics steps
and the auto-reset's forward), and so do the per-step figures.
``--model cylinder_drop`` starts B cylinders turned at random just over
the box (chip_smoke.py's ``_drop_start``; B must be 4096).  Prints
the card (nvidia-smi name and power limit), host wall time per step,
device kernel time per step, the device's busy share
(kernel time / wall time), kernel launches per step, the solver's
iterations and linesearch rounds per traced step, for a model with
sensors the kernel launches of each sensor stage (each traced alone on
the last step's Data), and the kernels that take the most device time,
and writes a Chrome trace to ``--out``.
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main() -> int:
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument("--model", default="humanoid_bench",
                 choices=("humanoid_bench", "humanoid_terrain", "scene_pile", "branchy66",
                          "ant_bench", "ant_env", "cylinder_drop"))
  p.add_argument("--batch", type=int, default=4096)
  p.add_argument("--dtype", default="float32", choices=("float32", "float64"))
  p.add_argument("--steps", type=int, default=5)
  p.add_argument("--warmup", type=int, default=20)
  p.add_argument("--out", default=str(ROOT / "build" / "profile"))
  args = p.parse_args()

  sys.path.insert(0, str(ROOT))
  import numpy as np
  import torch
  from torch.profiler import ProfilerActivity, profile

  import mjtpu_torch
  from mjtpu_torch._src import sensor, solver

  if not torch.cuda.is_available():
    raise RuntimeError("needs a CUDA device")
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  card = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, timeout=60, check=True).stdout.strip()
  dtype = getattr(torch, args.dtype)
  if args.model == "ant_env":
    from mjtpu_torch import zoo

    env = zoo.ENVS["ant"](dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    act = lambda: 2.0 * torch.rand(args.batch, env.action_size, generator=gen, device="cuda",
                                   dtype=dtype) - 1.0
    m, d = env.model, env.reset(args.batch, gen)
    advance = lambda s: env.step(s, act(), gen)
  elif args.model == "cylinder_drop":
    from chip_smoke import _drop_start

    m = mjtpu_torch.model_from_arrays(
        mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / "cylinder_drop_model.npz"),
        dtype=dtype, device="cuda")
    d = _drop_start(m)
    advance = lambda d: mjtpu_torch.step(m, d)
  else:
    m = mjtpu_torch.model_from_arrays(
        mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / f"{args.model}_model.npz"),
        dtype=dtype, device="cuda")
    rng = np.random.default_rng(1)
    qpos = m.qpos0.cpu().numpy()[None] + rng.uniform(-0.01, 0.01, (args.batch, m.nq))
    if args.model == "scene_pile":
      qpos[:, 2::7] -= 0.25  # the bottom layer starts in the floor
    if args.model == "ant_bench":  # every joint uniform over its range
      rng = np.random.default_rng(1)
      rng_lo, rng_hi = (m.jnt_range[:, k].cpu().numpy() for k in (0, 1))
      qpos[:, m.jnt_qposadr] = rng.uniform(rng_lo, rng_hi, (args.batch, m.njnt))
    d = mjtpu_torch.make_data(m, batch_size=args.batch)
    d = mjtpu_torch.replace(
        d, qpos=torch.as_tensor(qpos, dtype=dtype, device="cuda"),
        ctrl=torch.as_tensor(rng.uniform(-1, 1, (args.batch, m.nu)), dtype=dtype, device="cuda"))
    advance = lambda d: mjtpu_torch.step(m, d)
  for _ in range(args.warmup):
    d = advance(d)
  torch.cuda.synchronize()

  loops = dict(solver.loop_counts)
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    for _ in range(args.steps):
      d = advance(d)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
  out = pathlib.Path(args.out)
  out.mkdir(parents=True, exist_ok=True)
  trace = out / f"{args.model}_{args.dtype}_B{args.batch}.json.gz"
  prof.export_chrome_trace(str(trace))

  kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
  dev_us = sum(e.device_time for e in kernels)  # microseconds
  wall_ms = 1e3 * wall / args.steps
  print(f"card: {card}")
  print(f"{args.model} {args.dtype} B={args.batch}: {wall_ms:.3f} ms/step wall (profiled),"
        f" {dev_us / 1e3 / args.steps:.3f} ms/step device kernel time, device busy"
        f" {100 * dev_us / 1e3 / (wall_ms * args.steps):.1f}%,"
        f" {len(kernels) / args.steps:.0f} kernel launches/step")
  print(f"{m.opt.solver.name} per step:"
        f" {(solver.loop_counts['iterations'] - loops['iterations']) / args.steps:.1f}"
        f" iterations, {(solver.loop_counts['ls_rounds'] - loops['ls_rounds']) / args.steps:.1f}"
        " linesearch rounds")
  if m.nsensor:
    launches = {}
    for stage in ("sensor_pos", "sensor_vel", "sensor_acc"):
      getattr(sensor, stage)(m, d)  # caches built outside the trace
      torch.cuda.synchronize()
      with profile(activities=[ProfilerActivity.CUDA]) as stage_prof:
        getattr(sensor, stage)(m, d)
        torch.cuda.synchronize()
      launches[stage] = sum(e.device_type == torch.autograd.DeviceType.CUDA
                            for e in stage_prof.events())
    print("kernel launches of each sensor stage: "
          + ", ".join(f"{k} {v}" for k, v in launches.items()))
  by_name: dict[str, list[float]] = {}
  for e in kernels:
    by_name.setdefault(e.name, []).append(e.device_time)
  top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:15]
  print("top kernels by device time (ms/step, launches/step, name):")
  for name, ts in top:
    print(f"  {sum(ts) / 1e3 / args.steps:8.4f} {len(ts) / args.steps:6.0f}  {name[:100]}")
  print(f"trace: {trace.relative_to(ROOT) if trace.is_relative_to(ROOT) else trace}")
  return 0


if __name__ == "__main__":
  sys.exit(main())
