#!/usr/bin/env python3
"""Smoke run of the mjtpu_torch port on one NVIDIA GPU (built for Hopper).

    python3 chip_smoke.py

Run from the root of a checkout.  It needs one CUDA device, nvcc (the
kernels are built from mjtpu_torch/csrc at first use), torch and numpy; it
needs neither jax nor mujoco.  Phases, each printing its own lines; any
failure raises and the script exits non-zero:

  1. device: the card's name and power limit; TF32 off.
  2. build: nvcc builds the four kernels for sm_90a, in parallel.
  3. Cholesky kernel (B1) vs its plain twin on the card: random SPD batches
     (n in 1, 2, 5, 6, 8, 9, 12, 14, 23, 27, 32, 33, 40; B in 1, 130, 4096;
     f32 and f64) and batches whose pivots hit the floor; every variant
     that can run an n (the register kernel at n=2, 5, 6, 8, 9, 12, 14, 23
     and 27, the shared one everywhere) within the tolerance of the twin,
     and the two equal bit for bit; times of both at n=27, 23, 14, 12, 9,
     8, 6, 5 and 2 (bench's, terrain's, the Ant env's, mocap.xml's,
     walker2d's and halfcheetah's, ant_bench's, hopper's, the swimmer
     env's and the tendon scene's and muscle.xml's shapes), B=4096, beside
     torch.cholesky_solve(torch.linalg.cholesky_ex).
  4. height-field kernel (B4) vs its plain twin on the card: subgrids
     (0, 0), (2, 2), (8, 8); spheres and capsules; n in 1, 130, 49152; f32
     and f64; random windows and a flat one; every variant that can run a
     subgrid (the static kernel at (2, 2), the shared one everywhere)
     equal to the twin bit for bit; times of both variants at (2, 2),
     capsules, n=49152, f32.
  5. humanoid_bench parity: f64, the committed B=4 mjtpu states stepped 100
     times against the committed mjtpu golden: in the benchmark
     configuration to 1e-8 through step 50 and 1e-6 over 100 steps, and
     with the solver run to convergence to 1e-8 over 100 steps; one
     Cholesky launch per Newton iteration (the solver leaves its loops
     once no env runs on).
  6. humanoid_bench throughput: f32, B=4096, 20 warm-up and 200 timed
     steps; the Cholesky kernel's share of step time.
  7. humanoid_terrain parity: f64, B=4, 100 steps from the committed
     golden's initial states; step-1 qacc, efc_force and contact.dist to
     1e-9, the trajectory to TERRAIN_BOUND (the CPU test's bound); two
     height-field launches per step and one Cholesky launch per Newton
     iteration (at most 8 a step).
  8. humanoid_terrain throughput: f32, B=4096 from qpos0 +-0.01, a few
     warm-up and timed steps; each kernel's share of step time.
  9. SAT kernel (B3) vs its plain twin on the card: box-box with equal and
     with unequal sizes and a box against a terrain rock hull (n in 1,
     130, 491520), and the round hulls of the committed snapshots,
     cylinder-box at the cylinder drop's sizes, cylinder-cylinder,
     ellipsoid-box and ellipsoid-ellipsoid (n in 1, 130, 4096; the size
     dispatch must give them the shared kernel); random, axis-aligned
     touching and stacked poses; f32 and f64; every variant that can run a
     pair equal to the twin bit for bit in winner indices and separations
     (the side phase ``9-twin``, beside phase 22, or inline with
     --kernels); times of both variants at box-box, n = 491520 (scene_pile's group at
     B=4096), and of the shared kernel at each round pair, n = 4096 (the
     cylinder drop's group at B=4096), f32, each beside its twin and its
     bound (_sat_work).
 10. scene_pile parity: f64, B=4, 100 steps from the committed golden's
     initial states; step-1 contact.dist to 1e-9, qacc and efc_force and
     the trajectory to the CPU test's bounds (PILE_SOLVE_BOUND,
     PILE_BOUND); one SAT and no Cholesky launch per step.
 11. scene_pile throughput: f32, B=4096 from qpos0 +-0.01 dropped 0.25 m,
     a few warm-up and timed steps; the SAT kernel's share of step time;
     the CG iterations and linesearch rounds per step.
 12. LDL kernel (B2) vs its plain twin on the card: its three entry points
     (factor, solve, factor + solve) on the branchy trees of 66 and 38
     dofs, a forced serial chain (nv = depth = 40) and a seeded random
     tree of 100 dofs; B in 1, 130, 4096; f32 and f64; chain-pattern
     matrices L^T D L and a batch with massless dofs, whose pivots hit the
     MINVAL floor; both variants (lanes and shared) equal to the twin bit
     for bit.  Times of both on the 66-dof tree at B=4096, f32, beside
     torch.linalg.cholesky_ex / torch.cholesky_solve
     on the dense (B, 66, 66) matrix (context only: dense, no floor; the
     kernels line gives it as context_ms, its library_ms is null).
 13. branchy66 parity: f64, B=4, 100 steps from the committed golden's
     initial states, the trajectory to 1e-8 (the CPU test's bound); three
     B2 launches (one per entry point) and no Cholesky launch per step.
 14. branchy66 throughput: f32, B=4096 from qpos0 +-0.01, a few warm-up
     and timed steps; B2's share of step time; launches per step.
 15. ant_bench parity: f64, B=4, 100 steps from the committed golden's
     initial states; qpos and qvel to 1e-8, sensordata to 1e-8 of each
     sensor's scale (the CPU test's bounds); one Cholesky launch per
     Newton iteration and one per step for Euler's damping, all n=8.
 16. ant_bench throughput: f32, B=4096, joints uniform over their ranges
     and ctrl in [-1, 1] (numpy seed 1), a few warm-up and timed steps;
     env-steps/s, nreset, B1 launches per step and its share of step
     time, Newton iterations and linesearch rounds per step, the three
     sensor stages' share of step time (CUDA events around each) and the
     touch readings that are not zero.
 17. Ant RK4 parity: mjtpu/zoo/assets/ant.xml, f64, B=4, 100 steps from the
     committed golden's initial states; step 1's four forward passes' qacc
     and its qacc_warmstart to 1e-10 of scale, qpos and qvel to 1e-8 (the
     CPU test's bounds); one Cholesky launch (register, n=14) per Newton
     iteration.
 18. zoo env parity: f64, the five locomotion envs (ant, hopper, walker2d,
     halfcheetah, cartpole) through mjtpu_torch.zoo.ENVS, 3 env steps from
     the committed env golden's states: obs and reward to 1e-10, done and
     steps exact; the env forced done at its first step: that step's
     reward, done and steps.
 19. Ant env throughput: f32, B=4096, ENVS["ant"]() on the card, reset
     from a seeded torch.Generator, a few warm-up and timed env steps with
     actions uniform in [-1, 1] from it; env steps/s, physics steps/s, ms
     per env step, Newton iterations and linesearch rounds per physics
     step, B1 launches by variant (all register, at n=14, as many as
     Newton's iterations), auto-resets, nreset 0; B1's share of the env
     step.
 20. collision parity: f64, B=4, 100 steps of the cylinder drop (a
     cylinder on a box, SAT on its inscribed hull), tests/models/roll.xml
     and tests/models/sph_cyl.xml from the committed goldens' initial
     states: step-1 contacts to 1e-10 of scale with their geoms equal,
     qpos and qvel to 1e-8 (the CPU test's bounds); one SAT launch a step
     for the drop and none for the others, one Cholesky launch per Newton
     iteration; then the contacts of the 22 collision scenes of
     collision_scenes.npz (every geom pair this slice added, a
     tetrahedron pair, the max_geom_pairs sphere pile) at B=2 against
     their goldens, to 1e-10 of scale with their geoms equal.
 21. cylinder drop throughput: f32, B=4096, cylinders turned at random
     just over the box (numpy seed 1), a few warm-up and timed steps;
     env-steps/s, ms per step, launches per step (B3 shared 1, B1
     register as many as Newton's iterations), Newton iterations and
     linesearch rounds per step, nreset 0, B3's and B1's share of the
     step (CUDA events around each seam), one more step traced by
     torch.profiler for its launches and the device's busy share.
 22. elliptic parity: humanoid_bench_elliptic (humanoid_bench with
     elliptic cones, bench.py's humanoid_bench_elliptic), f64, B=4, from
     the committed goldens, with the solver run to convergence (iterations
     = ls_iterations = 10) and in the benchmark configuration: each of the
     400 one-step restarts from mjtpu's states within 1e-8 of mjtpu's
     batched or one-env (solo) next state, or a tie that a copy of its
     state a few ULP away resolves to mjtpu's path (ROADMAP C7); the
     converged run to 1e-8 until mjtpu's two runs part, then to 10 times
     their spread; the benchmark run's step 1 (qacc, efc_force,
     contact.dist) to 1e-9, and 1e-8 through step 2 (step 3's restarts
     are the first that rounding decides); one B1 launch (register, n=27) per Newton iteration; B1's
     variants against the twin on the restarts' Newton
     Hessians; then the cone scenes of cone_scenes.npz (condim 4 and 6,
     pyramidal and elliptic, condim_cg, elliptic.xml, two frictionloss
     scenes, four elliptic fuzz scenes): step 1's efc_* fields to 1e-10
     of scale, solve's qacc and efc_force to 1e-10 (the fuzz scenes:
     1e-7), 100 steps (the fuzz scenes: 25) to 1e-7 (ROADMAP C7); B1's
     register kernel (the size dispatch's) and shared one on
     elliptic.xml's n=12 Hessians, f64 and f32.
 23. elliptic throughput: f32, B=4096 from bench.py's start (qpos0 +-0.01,
     numpy seed 1), 20 warm-up and 200 timed steps: env-steps/s and ms per
     step beside phase 6's pyramidal figure, B1 launches (register, n=27)
     and Newton iterations and linesearch rounds per step, nreset 0, B1's
     share of the step, one profiled step's launches and busy share
     beside the pyramidal bench's; B1's variants against the twin on a
     warm-up step's Hessians (f32, regulariser and cone blocks in them),
     and B1's, the twin's and torch.cholesky_solve(cholesky_ex)'s device
     times on them.
 24. fluid parity: f64, B=4 on the card, the committed goldens of
     fluid_scenes.npz (tests/test_fluid.py's mixed ellipsoid-fluid model,
     two gravcomp scenes with and without actuators, the box model with
     wind): step 1's qfrc_fluid, qfrc_gravcomp, qfrc_passive and
     qfrc_actuator to 1e-12 of scale, 100 steps to 1e-8; the swimmer and
     the three satellite envs, 3 env steps against
     swimmer_satellite_env_golden.npz as phase 18 (1e-10, done and steps
     exact); ant_bench with DisableBit.CONSTRAINT (ROADMAP C8), 20 steps,
     every touch reading 0.
 25. swimmer env throughput: f32, B=4096, ENVS["swimmer"]() on the card
     as phase 19 (1 warm-up and 3 timed env steps): env steps/s, ms per
     env step, B1 launches per env step by variant (all register, at n=5,
     one per Newton iteration), nreset 0, B1's share of an env step, and
     one profiled env step's launches and the device's busy share; then
     the three satellite envs, a few f32 B=4096 env steps each: finite,
     nreset 0, their B1 launches by variant.

 26. tendon parity: f64, B=4 on the card, every scene of tendon_scenes.npz
     (tests/test_tendon.py's mixed model, its sphere, cylinder and pulley
     wraps, friction_tendon.xml, muscle.xml, sensors.xml, the slider-crank
     and adhesion models, the tendon limit sensors) against its mjtpu
     golden at the CPU test's bounds (tendon_scene_errors): the tendons at
     40 seeded poses a wrap scene to 1e-12 of scale with equal wrap flags,
     step 1's actuation and passive forces to 1e-12 and efc rows to 1e-10
     of scale, 100 steps to 1e-8; one B1 launch per Newton iteration, and
     one a step where Euler's damping solves a dense tree.
 27. tendon throughput, the main path: the mixed tendon scene at f32
     B=4096 from its snapshot (qpos0 +-0.01, ctrl in [-1, 1], numpy seed
     1), 3 warm-up and 100 timed steps: env-steps/s, ms per step, B1
     launches per step (register only, n=2, one per Newton iteration),
     Newton iterations and linesearch rounds per step, nreset 0, B1's share
     of the step, one profiled step's launches and busy share; then
     muscle.xml the same way with 20 timed steps (B1 also once a step for
     Euler's damping).

 28. equality parity: f64, B=4 on the card, every scene of
     equality_scenes.npz (mocap.xml under Euler and ImplicitFast, weld.xml,
     equality.xml with per-env eq_active, ball_free.xml under Euler and
     ImplicitFast, two forests under ImplicitFast, the ball-limit models,
     the limit sensors with a ball joint, a tendon equality, EQ_ORDER_XML,
     two equality fuzz scenes) against its mjtpu golden at the CPU test's
     bounds (equality_scene_errors): every body's frame to 1e-14, step 1's
     efc rows, qacc and efc_force to 1e-10 of scale, rne_postconstraint's
     cfrc_ext to 1e-10 of MuJoCo C's, the world body's row of mjtpu's
     (ROADMAP C11), 100 steps to 1e-8
     with the mocap targets the golden sets; one B1 launch per Newton
     iteration.
 29. mocap throughput, the main path: mocap.xml at f32 B=4096 (qpos0
     +-0.01, numpy seed 1), every env's two mocap bodies moved before each
     step by mocap_targets on the card from the step index and the env's
     phase, 3 warm-up and 30 timed steps: env-steps/s, ms per step, B1
     launches per step (register only, n=12, one per Newton iteration),
     Newton iterations and linesearch rounds per step, nreset 0, B1's share
     of the step, one profiled step's launches and busy share.
 30. Implicit-slice parity: f64, B=4 on the card, humanoid_implicit and
     every scene of implicit_scenes.npz (implicit_full.xml, a forest: the
     blocked LU; implicit_fluid.xml under Implicit and ImplicitFast; the
     ellipsoid-fluid scene under both; the swimmer under ImplicitFast;
     friction_tendon.xml and condim4_elliptic.xml under Implicit; two
     fuzz scenes) and of sensor_scenes.npz (the energy models, the
     geom-distance, contact and camera-projection sensors) against their
     mjtpu goldens at the CPU tests' bounds (slice14_errors): step 1's
     qDeriv and its fluid term, the implicit update, forward's qacc,
     energy and sensors to 1e-10 of scale, CONTACT's found exact, 100
     steps to 1e-8 (a contact-sensor tie only where a ULP copy takes
     mjtpu's pick, ROADMAP C13); one B1 launch per Newton iteration; on
     the geom-distance scene one B3 launch per SAT collider of the
     sensors' pairs in each sensor_pos (static for box-box, shared for
     box-cylinder), and the box-box distance through B3 static equal to
     the same through its twin bit for bit.  Two processes: ``30``
     (humanoid_implicit and implicit_scenes.npz) and ``30-sensors``
     (sensor_scenes.npz).
 31. Implicit throughput, the main path: humanoid_implicit (the zoo's
     humanoid.xml under the full Implicit integrator) at f32 B=4096 from
     qpos0 +-0.01 (numpy seed 1), 3 warm-up and 30 timed steps:
     env-steps/s, ms per step, B1 launches per step (register only,
     n=23, one per Newton iteration), Newton iterations and linesearch
     rounds per step, nreset 0, the shares of B1, of deriv_smooth_vel
     (the RNE velocity derivative over B x nv copies) and of the LU
     (CUDA events around each), one profiled step's launches and busy
     share.
 32. slice-15 parity: f64, on the card, every scene of randomize_scenes.npz
     (tests/test_randomize.py's friction, mass/gain/damping/timestep,
     sphere-radius and constants cases, and humanoid_bench with the main
     path's five fields and their mj_setConst constants) through
     parallel.randomized_step against mjtpu's batched randomized rollout
     (RANDOM_BOUND; humanoid_bench RANDOM_BENCH_BOUND through step 50, as
     C1), each env alone under its own unbatched Model against the batch
     (RANDOM_SELF_BOUND; humanoid_bench as C1, beside the same run of the
     base Model, a batch against batches of one, as its witness) and each
     env stepped once alone from the batch's state at every step
     (RANDOM_SELF_BOUND for every scene); every scene of
     inverse_scenes.npz (pendulum, ball_free, spheres, the damped arm with
     INVDISCRETE under Euler, ImplicitFast and Implicit, capsules.xml
     under FWDINV, branchy66 with INVDISCRETE) through inverse against
     mjtpu's outputs (INVERSE_BOUND of scale), the caller's qacc restored.
     Its side process ``32-fields`` (slice 18): every scene of
     randomize_fields.npz (every traced field mjtpu's randomize accepts,
     each perturbed in an env of its own on small models that read them,
     and the two main paths below at B=4) through parallel.randomized_step
     against mjtpu's golden (field_scene_errors: RANDOM_BOUND of scale;
     humanoid_bench RANDOM_BENCH_BOUND through step 50), each env's
     one-step restarts alone under its own Model against the batch
     (RANDOM_SELF_BOUND, RANDOM_CHECK_ENVS envs a scene), and every env
     that mjtpu's rows leave with the base env left there.
 33. slice-15 and slice-18 throughput, the main paths, each beside its
     base Model's plain path in the same call (_randomized_path; host
     clock around the synchronized steps): the randomized humanoid_bench
     at f32 B=4096 (bench_randomization's per-env friction, masses,
     damping, gains and timestep and its locomotion fields, seed 1, with
     their constants from randomize_fields_golden.npz) through
     parallel.randomized_step from qpos0 +-0.01 (numpy seed 1), 3 warm-up
     and 30 timed steps: env-steps/s, B1 launches per step (register
     only, n=27, one per Newton iteration); the per-env terrain,
     humanoid_terrain at f32 B=4096 with each env's heights and friction
     (terrain_randomization), 3 warm-up and 20 timed steps: B4 static
     twice a step, B1 register (n=23) once per Newton iteration; each
     finite and nreset 0 over the run, its peak memory, 8 envs each
     stepped once under its own unbatched Model against the batch
     (RANDOM_CHECK_BOUND); then the branchy66 inverse with INVDISCRETE at
     f32 B=4096, 2 warm-up and 20 timed calls (CUDA events): B2 lanes
     factor and solve, one launch each a call.
 34. slice-16 parity: f64, on the card, every scene of diff_scenes.npz
     (DIFF_SCENES: tests/test_diff.py's pendulum, plain and with adaptive
     substeps, spheres and sph_cyl under contacts from distance, the
     sphere at a box corner and the box on a box, roll.xml and the
     60-step bounce, plain and smooth, and humanoid_bench, K=4) under its
     differentiable_mode against mjtpu's jax.grad golden: values at step
     1 to 1e-10 of scale, over the run to 1e-8, gradients to 1e-8 of
     their max-abs and finite; B1's backward (cholesky.CholSolve: the
     kernel on (mat, x_bar)) against autograd through the twin at n=27
     and 23, B=4096, f32 and f64, to phase 3's tolerances; B2's, B3's and
     B4's wrappers raise on an input that requires grad, and their
     differentiable seams (the kernel forward; B2's solves launch it once
     more backward, the rest take the twin's gradient) match autograd
     through the twin at B=4096, f32 and f64, to the same; hopper_bench and
     pendulum_implicit (stepped_scenes.npz) 50 steps and their inverse
     against mjtpu to 1e-8 of scale.
 35. slice-16 throughput, the differentiable main path: gradients of
     humanoid_bench rollouts at f32 B=4096 under differentiable_mode()
     (K=8 steps from qpos0 +-0.01, qvel and ctrl (8, B, 21) in [-1, 1],
     numpy seed 1; loss sum of the final qpos^2; backward to the initial
     qvel and every ctrl): forward and backward wall, env-steps/s, B1
     register launches (8 forward, 8 backward; B2-B4 none), B1 alone on
     its 8 backward launches' inputs (timed again as phase 3 times, not
     its time inside the backward), peak memory, and the envs whose
     gradient is not finite (must be 0); one warm-up rollout, then 5
     timed runs, reported as the median with the least and the most.
 36. slice-17 parity: f64 on the card, every view of the scenes of
     render_scenes.npz (tests/test_render.py's textured, lit, narrow-spot,
     point-light, inactive-light, cube-texture, 6-face and single-square
     skybox, cylinder-ellipsoid and body-camera scenes and a mesh scene,
     B=2: camera 0 under flat, phong with shadows, fog 0.2, ssaa 2, the
     fixed light and a background colour, and every camera under the
     defaults) against mjtpu's jit(render_batch_rgbd) golden
     (render_scene_errors): rgb and depth to 1e-10 where seg agrees, seg
     equal, any other pixel a tie that a copy of its rays a few ULP away
     resolves to mjtpu's pick; the humanoid and satellite_small envs with
     pixel_obs=True, the start and 3 env steps against pixel_env_golden.npz
     (pixel_env_errors): pixels to the same bounds, obs and reward to
     1e-10, done and steps exact.
 37. slice-17 throughput, the render main path: the humanoid env with
     pixel observations (ENVS["humanoid"](pixel_obs=True): f32 B=4096,
     camera 0 the observer camera mjtpu injects, 64 x 64 pixels rendered
     after every reset and auto-reset), 2 warm-up and 3 timed env steps
     (host clock): env steps/s beside the same env without pixels, B1
     register launches (n=23, one per Newton iteration), nreset 0, peak
     memory; render_batch_rgbd alone on its states: 5 timed calls, its
     launches and the device's busy share in one profiled call, its peak
     memory, its stages (rays, nearest-hit loops, the winners' normals and
     albedo) by CUDA events over one more call; the f32 render of 8 envs
     against f64 on the same frames.
 38. slice-19 throughput, the system-identification main path:
     humanoid_bench at f32 B=4096 under differentiable_mode()'s defaults
     (Newton 1 x 4), targets a K=8 rollout under seeded reference rows of
     body_mass, dof_damping, dof_armature, jnt_stiffness, geom_friction,
     jnt_solref and actuator_gainprm, 3 Adam steps on those rows from a
     seeded perturbation x U(0.8, 1.2), each one rollout forward and
     backward of the mean over the steps of ||qpos - target||^2 (after a
     warm-up rollout): forward and backward wall, env-steps/s, B1
     register launches (8 forward, 8 backward: cholesky.CholSolve's
     mat_bar reaches body_mass and dof_armature through qM), peak memory,
     the 3 losses, the envs whose gradient is not finite (must be 0), and
     the host syncs of a rollout forward and backward with the rows
     requiring grad beside the same rollout with the gradient taken to
     qvel, each on a randomized Model built before the count (may not be
     more).
 38-parity (side). every model_grad scene (model_grad_scenes_golden.npz:
     the 9 randomize_fields scenes with their rows as the point, and
     humanoid_bench's unbatched base fields) at f64 on the card through
     B1 (B4 on the height-field scenes, forward with its twin's gradient)
     against mjtpu's jax.grad: values 1e-10 at step 1 and 1e-8 over the
     run of scale, gradients 1e-8 of their max-abs, a zero of mjtpu's
     zero, all finite; where mjtpu's gradient is NaN (ROADMAP C22) the
     port's within 1e-4 of central differences of its own loss, and of
     one-sided ones along the fields that cross a tie (model_grad_fd_error).

The main paths are phases 6, 8, 11, 14, 16, 19, 21, 23, 25, 27, 29, 31,
33, 35, 37 and 38: each kernel's launch count is set to 0 just before each and
read just after, by variant too:
the main paths must run the redesigned variants only (NEW_VARIANT: B1
register, B2 lanes, B3 and B4 static), but for phase 21, whose round hulls
the size dispatch gives to B3's shared kernel.  The last two lines are the kernel
record and {"ok": true, ...}.

The parity phases 5, 7, 10, 13, 15, 17, 18, 20, 24, 26, 28, 30 (two
processes, ``30`` and ``30-sensors``), 32 (two: ``32`` and ``32-fields``),
34, 36 and 38 (``38-parity``), phase 9's twin check
(``9-twin``) and phase 22's cone scenes (``22-cones`` and ``22-cones-2``,
every other scene each), run each in a
process of its own
(``python3 chip_smoke.py --phase 24``), started just after phase 21 and
awaited after the rest of phase 22, so their host-bound steps at B=4
overlap it; no phase is timed while they run (the timed phases 23, 25,
27, 29, 31, 33, 35, 37 and 38 come after all have ended).

    python3 chip_smoke.py --kernels

runs phases 1-4, 9 and 12 only (each kernel built, held to its twin and
timed) and prints neither record: a short check of a kernel change.

Kernel times (phases 3, 4, 9, 12) are device times: CUDA events around a
window of calls enqueued back to back behind a sleep kernel that holds the
stream until the host has enqueued them all, over the number of calls
(``cuda_ms``); the wrappers' host work is outside the window.
"""

from __future__ import annotations

import collections
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
PARITY_STEPS = 100
TIGHT_STEPS = 50  # the benchmark-config trajectory holds 1e-8 this far
BENCH_BATCH = 4096
# phases 6 and 23
WARMUP_STEPS = 20
TIMED_STEPS = 200
TERRAIN_BOUND = 1e-8  # tests/test_torch_terrain.py's TRAJECTORY_BOUND
TERRAIN_WARMUP = 3
TERRAIN_TIMED = 20
HFIELD_N = 49152  # the capsule group at B=4096: 4096 envs x 12 pairs
SAT_N = 491520  # the box-box group at B=4096: 4096 envs x 120 pairs
ROUND_N = 4096  # the cylinder drop's cylinder-box group at B=4096: one pair an env
# tests/test_torch_pile.py's bounds: the step-1 solve relative to each
# field's scale, and the 100-step trajectory (absolute)
PILE_SOLVE_BOUND = 1e-3
PILE_BOUND = 1e-2
PILE_WARMUP = 3
PILE_TIMED = 10
BRANCHY_BOUND = 1e-8  # tests/test_torch_branchy.py's TRAJECTORY_BOUND
BRANCHY_WARMUP = 3
BRANCHY_TIMED = 20
ANT_BOUND = 1e-8  # tests/test_torch_ant.py's TRAJECTORY_BOUND
ANT_WARMUP = 3
ANT_TIMED = 20
SENSOR_STAGES = ("sensor_pos", "sensor_vel", "sensor_acc")
LDL_ENTRIES = ("ldl_factor", "ldl_solve", "ldl_factor_solve")
ANT_RK4_PASS_BOUND = 1e-10  # tests/test_torch_rk4.py's PASS_BOUND
# tests/test_torch_collision_round.py's bounds: contacts of each field's
# scale, and the 100-step trajectories (absolute)
CONTACT_BOUND = 1e-10
CONTACT_TRAJECTORY_BOUND = 1e-8
CONTACT_MODELS = ("cylinder_drop", "roll", "sph_cyl")
DROP_WARMUP = 5
DROP_TIMED = 20
ENV_BOUND = 1e-10  # tests/test_torch_zoo.py's STEP_BOUND
ZOO_LOCOMOTION = ("ant", "hopper", "walker2d", "halfcheetah", "cartpole")
# the swimmer (fluid forces) and the satellite envs (cmg.py, satellite.py)
SATELLITE_ENVS = ("swimmer", "satellite", "satellite_large", "satellite_small")
# tests/test_torch_fluid.py's bounds: step 1's passive and actuator forces
# of each field's scale, the 100-step trajectories, the constraint-free
# ant_bench's steps (ROADMAP C8)
FLUID_FORCES = ("qfrc_fluid", "qfrc_gravcomp", "qfrc_passive", "qfrc_actuator")
FLUID_FORCE_BOUND = 1e-12
FLUID_TRAJECTORY_BOUND = 1e-8
C8_STEPS = 20
# the satellite envs' env steps at f32 B=4096 (warm-up, timed)
SATELLITE_WARMUP = 1
SATELLITE_TIMED = 2
ENV_WARMUP = 1
ENV_TIMED = 3  # the Ant env takes ~10 s of host an env step
ELLIPTIC = "humanoid_bench_elliptic"
# tests/test_torch_elliptic.py's bounds (ROADMAP C7): the copies of a
# restart's state, a few ULP apart, that look for mjtpu's path where the
# port takes another (elliptic_restarts), and the converged run's drift
# after its first tie, as a multiple of mjtpu's own solo-vs-batched spread
# over the same 100 steps
ELLIPTIC_TIE_COPIES = 64
ELLIPTIC_DRIFT_FACTOR = 10
# the benchmark configuration's run is held to 1e-8 through step 2: step
# 3's restarts are the first that rounding decides (a split on the CPU;
# on the card copies a few ULP away move envs 0 and 1 by up to 7.5e-4)
ELLIPTIC_HEAD_STEPS = 2
CONE_BOUND = 1e-10
# tests/test_torch_frictionloss.py's FUZZ_SOLVE_BOUND, and its
# FUZZ_TRAJECTORY_BOUND for every cone scene's 100 steps: ties in elliptic
# middle zones (ROADMAP C7) part elliptic.xml's run on the card by 2.7e-8
CONE_FUZZ_SOLVE_BOUND = 1e-7
CONE_TRAJECTORY_BOUND = 1e-7
# the fuzz scenes' steps held on the card, as on the CPU (the time limit)
CONE_FUZZ_STEPS = 25
# tests/test_torch_tendon.py's bounds: the tendons at the wrap scenes'
# seeded poses and step 1's actuation and passive forces of each field's
# scale, step 1's efc rows of scale, the 100-step trajectories (absolute;
# sensordata of each sensor's scale)
TENDON_POSE_FIELDS = ("ten_length", "ten_J", "ten_wrap_xpos")
TENDON_FORCES = ("actuator_length", "actuator_moment", "act_dot", "actuator_force",
                 "qfrc_passive")
TENDON_EFC = ("efc_J", "efc_pos", "efc_margin", "efc_frictionloss", "efc_D", "efc_aref")
TENDON_POSE_BOUND = 1e-12
TENDON_FORCE_BOUND = 1e-12
TENDON_EFC_BOUND = 1e-10
TENDON_TRAJECTORY_BOUND = 1e-8
TENDON_WARMUP = 3
MUSCLE_TIMED = 20
# the mixed tendon scene's timed steps (phase 27, 200 until the Implicit
# slice's phases took its room in the time limit)
TENDON_TIMED = 100
# mocap.xml's envs each move their targets from their own phase, uniform in
# [0, MOCAP_PHASE_S) s (mocap_targets)
MOCAP_PHASE_S = 2.0
# the equality scenes' bounds (tests/test_torch_equality.py): every body's
# xpos and xquat, of max(1, scale); step 1's efc rows, qacc, efc_force and
# rne_postconstraint's cfrc_ext (against MuJoCo C's), of scale; 100 steps
EQ_POSE_BOUND = 1e-14
EQ_EFC_BOUND = 1e-10
EQ_SOLVE_BOUND = 1e-10
EQ_CFRC_BOUND = 1e-10
EQ_TRAJECTORY_BOUND = 1e-8
EQ_EFC = ("efc_J", "efc_pos", "efc_margin", "efc_frictionloss", "efc_D", "efc_aref")
# the equality main path's warm-up and timed steps
MOCAP_WARMUP = 3
MOCAP_TIMED = 30
# the Implicit slice: the bundles' and humanoid_implicit's f64 bounds
# (tests/test_torch_implicit.py, tests/test_torch_query_sensors.py): step
# 1's qDeriv, qacc, energy and sensors of scale, the trajectories' qpos
# and qvel absolute and sensordata and energy of scale
SLICE14_STEP_BOUND = 1e-10
SLICE14_TRAJECTORY_BOUND = 1e-8
SLICE14_BUNDLES = {"implicit": "implicit_scenes", "sensor": "sensor_scenes"}
IMPLICIT_WARMUP = 3
IMPLICIT_TIMED = 30
# slice 15: the randomize and inverse scenes (randomize_scenes.npz,
# inverse_scenes.npz), the randomized humanoid_bench and the branchy66
# inverse at f32 B=4096
RANDOM_BOUND = 1e-10        # a small randomize scene's batched run against mjtpu's
RANDOM_BENCH_BOUND = 1e-8   # the randomized humanoid_bench against mjtpu's (C1's bound)
RANDOM_BENCH_STEPS = 50     # ... this far
RANDOM_SELF_BOUND = 1e-12   # each env under its own Model against the batched run, f64
RANDOM_CHECK_ENVS = 8
RANDOM_CHECK_BOUND = 1e-5   # ... one f32 step, of scale (1.045e-6 on the H100)
RANDOM_WARMUP = 3
RANDOM_TIMED = 30
# what a randomize_fields scene holds against mjtpu's golden, step by
# step, where the model has it (the cameras' and lights' frames move with
# their fields only)
FIELD_OUTPUTS = ("qpos", "qvel", "act", "sensordata", "cam_xpos", "cam_xmat", "light_xpos",
                 "light_xdir")
# the fields the randomized humanoid_bench of phase 33 adds to
# bench_randomization's five, each shown to move its trajectory
# (tests/test_torch_randomize_fields.py); opt.impratio is left out, as
# this model's pyramidal cones never read it
BENCH_LOCOMOTION_FIELDS = ("body_pos", "geom_pos", "jnt_solref", "jnt_solimp", "jnt_margin",
                           "qpos_spring", "actuator_ctrlrange")
INVERSE_FIELDS = ("qfrc_inverse", "qfrc_constraint", "efc_force", "qfrc_bias", "qfrc_passive",
                  "sensordata")
INVERSE_BOUND = 1e-10       # the port's inverse against mjtpu's, of scale
INVERSE_WARMUP = 2
INVERSE_TIMED = 20
# phase 3's sizes: the register kernel's n (the main paths' 2, 5, 8, 12,
# 14, 23, 27 and the zoo envs' 6 and 9), which both variants run, and n
# that only the shared kernel runs (32 and 33 on either side of its rows'
# striding over the lanes)
CHOL_NS = (1, 2, 5, 6, 8, 9, 12, 14, 23, 27, 32, 33, 40)
# the register kernel's n, timed in phase 3: bench, terrain, the Ant env,
# mocap.xml, walker2d and halfcheetah, ant_bench, hopper, the swimmer env,
# the tendon scene and muscle.xml
CHOL_TIMED_NS = (27, 23, 14, 12, 9, 8, 6, 5, 2)
# calls per timing window: a kernel's, and a plain twin's or library call's
# (those take milliseconds each)
KERNEL_REPS = 50
PLAIN_REPS = 20
# the variant each kernel's main paths must run (the redesigned one), and
# the main paths' launches by kernel and variant
NEW_VARIANT = {"chol_solve": "register", "hfield_manifold": "static", "sat_winners": "static",
               **dict.fromkeys(LDL_ENTRIES, "lanes")}
VARIANT_LAUNCHES = {}
TIMING = f"(device time per call over {KERNEL_REPS} back-to-back calls, {PLAIN_REPS} for twins)"
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bytes/s and
# non-tensor-core FLOP/s per type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}


def log(msg: str) -> None:
  print(msg, flush=True)


def card_line() -> str:
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, timeout=60, check=True,
  )
  return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = KERNEL_REPS, windows: int = 3) -> float:
  """Device ms of one call of ``fn``: the median over ``windows`` windows of
  the CUDA-event time of ``reps`` calls enqueued back to back, over
  ``reps``.  The inputs are made once by the caller, outside the window.
  Before each window a sleep kernel holds the stream for longer than the
  host takes to enqueue the window, so that the queue runs ahead of the
  host and the window holds the calls' device time only, none of the
  wrappers' host work.  The calls read the same inputs one after another:
  whatever of them fits the 50 MB L2 stays warm there."""
  import torch

  fn()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for _ in range(reps):
    fn()
  host_s = time.perf_counter() - t0  # the host's enqueue time of one window
  torch.cuda.synchronize()
  times = []
  for _ in range(windows):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    # at most 2 GHz, so the sleep lasts at least 2 * host_s + 1 ms
    torch.cuda._sleep(int(2e9 * (2 * host_s + 1e-3)))
    start.record()
    for _ in range(reps):
      fn()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end) / reps)
  return statistics.median(times)


def bound(bytes_moved: float, flops: float, dtype) -> tuple[float, str]:
  """(least ms the card could take, what bounds it): the larger of bytes
  over HBM bandwidth and operations over the type's peak."""
  t_bytes = 1e3 * bytes_moved / HBM_BYTES_PER_S
  t_ops = 1e3 * flops / PEAK_FLOPS[str(dtype)[6:]]
  return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mocap_targets(base_pos, t):
  """mocap.xml's two mocap bodies at times t (B,), the moving-target
  schedule of tests/test_mocap.py: both moved from their frames base_pos
  (2, 3) by (0.2 sin 3t, 0, 0.1 t), the first turned by 0.8 t about z,
  the second not turned: (pos (B, 2, 3), quat (B, 2, 4)) on t's device, so
  a run on the card computes them there from the step index."""
  import torch

  zero, one = torch.zeros_like(t), torch.ones_like(t)
  pos = base_pos + torch.stack([0.2 * torch.sin(3.0 * t), zero, 0.1 * t], dim=-1)[:, None]
  half = 0.4 * t
  quat = torch.stack([torch.stack([torch.cos(half), zero, zero, torch.sin(half)], dim=-1),
                      torch.stack([one, zero, zero, zero], dim=-1)], dim=1)
  return pos, quat


def phase_device():
  import torch

  if not torch.cuda.is_available():
    raise RuntimeError("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  torch.set_float32_matmul_precision("highest")
  card = card_line()
  log(f"[device] {torch.cuda.get_device_name(0)}; count {torch.cuda.device_count()};"
      f" torch {torch.__version__}, CUDA {torch.version.cuda}; TF32 off")
  log(f"[device] nvidia-smi: {card}")
  return card


def phase_build():
  """Every library built at once (one nvcc per source, started together)."""
  from mjtpu_torch.ops import _build, cholesky, hfield, ldl, sat

  mods = (cholesky, hfield, sat, ldl)
  t0 = time.perf_counter()
  _build.build([(mod.SOURCE, getattr(mod, "EXTRA_FLAGS", ())) for mod in mods])
  for mod in mods:
    mod.library()
  log(f"[build] {len(mods)} kernels built and loaded in {time.perf_counter() - t0:.2f} s")
  for mod in mods:
    flags = _build.flags(getattr(mod, "EXTRA_FLAGS", ()))
    log(f"[build] mjtpu_torch/csrc/{mod.SOURCE} -> {_build.BUILD_DIR.relative_to(ROOT)} with"
        f" nvcc {' '.join(flags)}")
    for line in _build.build_logs.get(mod.SOURCE, "").splitlines():
      if line.strip():
        log(f"[build] {line.strip()}")


def _mismatch(what, got, want, kernel, twin, exact=None) -> str:
  """The message for a kernel/twin disagreement: the worst entry's index
  and value in each (and in ``exact()``, a float64 solve on the host, when
  given), and whether a second call of each repeats its first result, which
  tells a launch that is not repeatable from one that is wrong."""
  import numpy as np
  import torch

  k = int((got - want).abs().argmax())
  idx = tuple(int(i) for i in np.unravel_index(k, tuple(got.shape)))
  msg = f"{what}; worst at {idx}: kernel {float(got.flatten()[k]):.9e}, twin {float(want.flatten()[k]):.9e}"
  if exact is not None:
    msg += f", float64 on the host {float(exact().flatten()[k]):.9e}"
  return (f"{msg}; a second call repeats the kernel's result: {torch.equal(kernel(), got)},"
          f" the twin's: {torch.equal(twin(), want)}")


def _spd(n, batch, dtype, gen, clamp=False):
  import torch

  a = torch.randn(batch, n, n, dtype=dtype, device="cuda", generator=gen)
  mat = a @ a.transpose(1, 2) + n * torch.eye(n, dtype=dtype, device="cuda")
  if clamp:
    # zero rows/columns (a massless dof): those pivots are exactly 0 and
    # hit the floor, so the solution components there are ~1/floor
    dead = torch.rand(batch, n, device="cuda", generator=gen) < 0.3
    keep = (~dead).to(dtype)
    mat = mat * keep[:, :, None] * keep[:, None, :]
  rhs = torch.randn(batch, n, dtype=dtype, device="cuda", generator=gen)
  return mat.contiguous(), rhs


def _chol_work(n: int, batch: int, item: int) -> tuple[float, float]:
  """(bytes, operations) of one batched factor + solve: each matrix and
  right-hand side read once, the solution written once; per column the
  sqrt, the divisions and the trailing update's multiply and subtract,
  then both substitutions' divisions, multiplies and subtracts."""
  ops = sum(1 + (n - j - 1) + (n - j - 1) * (n - j) for j in range(n))
  ops += 2 * sum(1 + 2 * (n - j - 1) for j in range(n))
  return float(batch * (n * n + 2 * n) * item), float(batch * ops)


def phase_cholesky():
  import torch

  from mjtpu_torch.ops import cholesky

  gen = torch.Generator(device="cuda").manual_seed(0)
  tol = {torch.float32: 1e-4, torch.float64: 1e-10}
  worst, checked, same_bits, main_abs_err = {}, {}, 0, None
  for dtype in (torch.float32, torch.float64):
    for n in CHOL_NS:
      for batch in (1, 130, 4096):
        for clamp in (False, True):
          mat, rhs = _spd(n, batch, dtype, gen, clamp)
          ref = cholesky.chol_solve_reference(mat, rhs)
          got = {}
          for kind in cholesky.variants(n, dtype):
            run = lambda kind=kind: cholesky.cholesky_solve(mat, rhs, kernel=kind)
            got[kind] = x = run()
            torch.cuda.synchronize()
            if not bool(torch.isfinite(x).all()):
              raise AssertionError(f"{kind} kernel output not finite: n={n} B={batch} {dtype}")
            err = float((x - ref).abs().max())
            rel = err / max(float(ref.abs().max()), 1e-300)
            # floored pivots make f64 solutions ~1e15 and ill-conditioned
            limit = 1e-6 if clamp and dtype == torch.float64 else tol[dtype]
            if rel > limit:
              raise AssertionError(_mismatch(
                  f"{kind} kernel vs twin: n={n} B={batch} {dtype} clamp={clamp}: rel"
                  f" {rel:.3e} > {limit}", x, ref, run,
                  lambda: cholesky.chol_solve_reference(mat, rhs),
                  lambda: cholesky.chol_solve_reference(mat.double().cpu(), rhs.double().cpu())))
            key = (dtype, clamp)
            worst[key] = max(worst.get(key, 0.0), rel)
            checked[kind] = checked.get(kind, 0) + batch
            if (n, batch, clamp, dtype, kind) == (27, BENCH_BATCH, False, torch.float32,
                                                  "register"):
              main_abs_err = err
          if len(got) == 2:
            # the two kernels do the same operations in the same order
            if not torch.equal(_bits(got["register"]), _bits(got["shared"])):
              raise AssertionError(_mismatch(
                  f"register vs shared kernel: n={n} B={batch} {dtype} clamp={clamp}:"
                  f" {int((_bits(got['register']) != _bits(got['shared'])).sum())} entries"
                  f" differ in bits", got["register"], got["shared"],
                  lambda: cholesky.cholesky_solve(mat, rhs, kernel="register"),
                  lambda: cholesky.cholesky_solve(mat, rhs, kernel="shared")))
            same_bits += batch
  for (dtype, clamp), rel in sorted(worst.items(), key=str):
    log(f"[cholesky] max rel err vs twin, {str(dtype)[6:]}, {'clamped pivots' if clamp else 'SPD'}:"
        f" {rel:.3e}")
  log(f"[cholesky] n in {CHOL_NS} x B in 1, 130, {BENCH_BATCH} x SPD, clamped x f32, f64: envs"
      f" by variant {checked}; register == shared bit for bit in {same_bits} envs")

  times, variant_ms = {}, {}
  for n in CHOL_TIMED_NS:
    for dtype in (torch.float32, torch.float64):
      mat, rhs = _spd(n, BENCH_BATCH, dtype, gen)
      run = {kind: (lambda kind=kind: cholesky.cholesky_solve(mat, rhs, kernel=kind))
             for kind in cholesky.variants(n, dtype)}
      run_p = lambda: cholesky.chol_solve_reference(mat, rhs)
      # plain, register, shared, shared, register, plain: compare within one call
      p1, r1, s1 = cuda_ms(run_p, PLAIN_REPS), cuda_ms(run["register"]), cuda_ms(run["shared"])
      s2, r2, p2 = cuda_ms(run["shared"]), cuda_ms(run["register"]), cuda_ms(run_p, PLAIN_REPS)
      # one PyTorch call pair for the same solve (no pivot floor): context only
      lib = cuda_ms(lambda: torch.cholesky_solve(
          rhs[..., None], torch.linalg.cholesky_ex(mat).L)[..., 0], PLAIN_REPS)
      b_ms, b_by = bound(*_chol_work(n, BENCH_BATCH, mat.element_size()), dtype)
      times[n, dtype] = (min(r1, r2), min(p1, p2), lib, b_ms, b_by)
      variant_ms[n, dtype] = {"register": min(r1, r2), "shared": min(s1, s2)}
      log(f"[cholesky] n={n} B={BENCH_BATCH} {str(dtype)[6:]}: register kernel {r1:.4f} /"
          f" {r2:.4f} ms, shared kernel {s1:.4f} / {s2:.4f} ms, plain twin {p1:.4f} / {p2:.4f} ms,"
          f" torch.cholesky_solve(cholesky_ex) {lib:.4f} ms, bound {b_ms:.5f} ms ({b_by})"
          f" {TIMING}")
  f32 = torch.float32
  shapes = {f"n={n}": {"ms": times[n, f32][0], "plain_ms": times[n, f32][1],
                       "library_ms": times[n, f32][2], "bound_ms": times[n, f32][3],
                       "variant_ms": variant_ms[n, f32]} for n in CHOL_TIMED_NS}
  return main_abs_err, times[27, f32], variant_ms[27, f32], shapes


def _windows(n, hy, hx, has_axis, dtype, gen, flat=False, device="cuda"):
  """Random height windows (n, R, C), origins and objects over them."""
  import torch

  u = lambda *shape: torch.rand(*shape, generator=gen, device=device, dtype=dtype)
  rr, cc = 2 * hy + 2, 2 * hx + 2
  zwin = torch.full((n, rr, cc), 0.05, dtype=dtype, device=device) if flat else 0.3 * u(n, rr, cc)
  origin = 40.0 * u(n, 2) - 20.0
  span = torch.tensor([(cc - 1) * 1.29, (rr - 1) * 1.29], dtype=dtype, device=device)
  center = torch.cat([origin + u(n, 2) * span, 0.4 * u(n, 1) - 0.05], dim=1)
  axis = (0.6 * u(n, 3) - 0.3) if has_axis else torch.zeros_like(center)
  return zwin, origin, center - axis, center + axis, 0.03 + 0.1 * u(n)


def _hfield_work(n: int, hy: int, hx: int, has_axis: bool, item: int) -> tuple[float, float]:
  """(bytes, operations) of one manifold batch.

  Bytes: the windows, origins, segments and radii read once, the 4-point
  manifolds written once.  Operations: what the algorithm needs, each
  add, subtract, multiply, divide and square root counted once
  (comparisons and selects not counted), whatever csrc/hfield.cu repeats:
    * per instance: the window's x and y coordinates, 2(R + C); for a
      capsule its axis b - a and |b - a|^2, 8;
    * per triangle, once: the edges b-a, c-a, c-b, 9 (a-c is a negation);
      the unit normal, cross 9 + normalize 9; the three in-plane edge
      normals cross(e, n), 27; the three |e|^2, 15: 69 in all;
    * per closest point on the triangle to a point p: p-a 3, the plane
      distance 5 and projection 6; the three edge signs, 8 each; the
      three closest edge points, 12 + 15 + 15 (p-a shared); their squared
      distances to p, 8 each: 104;
    * the sphere test at its point s: one closest point 104 (whose
      projection it reuses), the inside test 8, normalize(s - closest)
      12, dist 1, pos 8: 133;
    * the capsule: closest points to both ends 2 x 104, the two segment
      points 2 x 15, closest points to those 2 x 104, their squared gaps
      16, then the sphere test at the winner without its closest point,
      which is one already made, 29: 491;
    * selection: the suppression |p - p_k|^2 after each of the first 3
      rounds (the 4th's is never read), 8 each: 24.
  So 226 operations per sphere triangle and 584 per capsule triangle."""
  rr, cc = 2 * hy + 2, 2 * hx + 2
  ntri = 2 * (2 * hy + 1) * (2 * hx + 1)
  per_inst = 2 * (rr + cc) + (8 if has_axis else 0)
  per_tri = 69 + (491 if has_axis else 133) + 24
  return float(n * (rr * cc + 9 + 28) * item), float(n * (per_inst + ntri * per_tri))


def _bits(x):
  """x's bit patterns (a -0 differs from a +0), integers as they are."""
  import torch

  ints = {torch.float32: torch.int32, torch.float64: torch.int64}
  return x.view(ints[x.dtype]) if x.dtype in ints else x


def phase_hfield():
  import torch

  from mjtpu_torch.ops import hfield

  gen = torch.Generator(device="cuda").manual_seed(1)
  checked, main_abs_err = {}, None
  for dtype in (torch.float32, torch.float64):
    for hy, hx in ((0, 0), (2, 2), (8, 8)):
      for has_axis in (False, True):
        for n in (1, 130, HFIELD_N):
          for flat in (False, True):
            args = _windows(n, hy, hx, has_axis, dtype, gen, flat)
            # the twin in chunks: its (n, T, 3) intermediates at (8, 8)
            twin = lambda: [torch.cat(c) for c in zip(*(
                hfield.manifold_reference(*(a[i:i + 8192] for a in args), hy, hx, 1.29, 1.29,
                                          has_axis) for i in range(0, n, 8192)))]
            want = twin()
            for kind in hfield.variants(hy, hx):
              kernel = lambda: hfield.manifold_batch(*args, hy, hx, 1.29, 1.29, has_axis,
                                                     kernel=kind)
              got = kernel()
              torch.cuda.synchronize()
              for o, (name, g, w) in enumerate(zip(("dist", "pos", "nrm"), got, want)):
                if not bool(torch.isfinite(g).all()):
                  raise AssertionError(f"hfield {kind} kernel {name} not finite")
                if not torch.equal(_bits(g), _bits(w)):
                  raise AssertionError(_mismatch(
                      f"hfield {kind} kernel vs twin: ({hy}, {hx}) axis={has_axis} n={n}"
                      f" {dtype} flat={flat} {name}: {int((_bits(g) != _bits(w)).sum())} entries"
                      f" differ in bits", g, w, lambda: kernel()[o], lambda: twin()[o]))
              checked[kind] = checked.get(kind, 0) + n
              if (hy, hx, has_axis, n, flat, dtype, kind) == (2, 2, True, HFIELD_N, False,
                                                              torch.float32, "static"):
                main_abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
  log(f"[hfield] kernel == twin bit for bit (dist, pos, normal) in every case: subgrids (0, 0),"
      f" (2, 2), (8, 8) x spheres, capsules x n in 1, 130, {HFIELD_N} x random, flat windows x"
      f" f32, f64; instances by variant {checked}")

  dtype = torch.float32
  args = _windows(HFIELD_N, 2, 2, True, dtype, gen)
  run = {kind: (lambda kind=kind: hfield.manifold_batch(*args, 2, 2, 1.29, 1.29, True,
                                                        kernel=kind))
         for kind in hfield.variants(2, 2)}
  run_p = lambda: hfield.manifold_reference(*args, 2, 2, 1.29, 1.29, True)
  # plain, static, shared, shared, static, plain: compare within one call
  p1, k1, s1 = cuda_ms(run_p, PLAIN_REPS), cuda_ms(run["static"]), cuda_ms(run["shared"])
  s2, k2, p2 = cuda_ms(run["shared"]), cuda_ms(run["static"]), cuda_ms(run_p, PLAIN_REPS)
  b_ms, b_by = bound(*_hfield_work(HFIELD_N, 2, 2, True, 4), dtype)
  log(f"[hfield] (2, 2) capsules n={HFIELD_N} f32: static kernel {k1:.4f} / {k2:.4f} ms, shared"
      f" kernel {s1:.4f} / {s2:.4f} ms, plain twin {p1:.4f} / {p2:.4f} ms, bound {b_ms:.5f} ms"
      f" ({b_by}) {TIMING}")
  variant_ms = {"static": min(k1, k2), "shared": min(s1, s2)}
  return main_abs_err, (min(k1, k2), min(p1, p2), None, b_ms, b_by), variant_ms


def _rock_hull():
  """One of humanoid_terrain's 6-vertex rock hulls (mjtpu's tables, from
  the committed snapshot)."""
  import mjtpu_torch

  ns = mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / "humanoid_terrain_model.npz")
  return next(h for h in ns.mesh_convex if h is not None)


def _sat_poses(kind, n, h1, h2, dtype, gen, device="cuda"):
  """(pos1, mat1, pos2, mat2) on ``device``: random rotations and offsets;
  axis-aligned hulls touching 1 mm deep along x, y or z (half of them
  with small sideways offsets); or hull 2 stacked on hull 1, 1 mm deep,
  with a yaw."""
  import math

  import torch

  u = lambda *shape: torch.rand(*shape, generator=gen, device=device, dtype=dtype)
  pos1 = 2.0 * u(n, 3) - 1.0
  eye = torch.eye(3, dtype=dtype, device=device).expand(n, 3, 3)
  if kind == "random":
    def rot():
      q = torch.randn(n, 4, generator=gen, device=device, dtype=dtype)
      w, x, y, z = (q / q.norm(dim=1, keepdim=True)).unbind(1)
      return torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                          2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                          2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                         1).reshape(n, 3, 3)
    return pos1, rot(), pos1 + 0.3 * u(n, 3) - 0.15, rot()
  ext1, ext2 = (torch.as_tensor(abs(h.vert).max(0), dtype=dtype, device=device) for h in (h1, h2))
  if kind == "aligned":
    axis = (3 * u(n)).long().clamp(max=2)
    step = torch.nn.functional.one_hot(axis, 3).to(dtype) * (ext1 + ext2 - 0.001)
    side = torch.where(u(n, 1) < 0.5, 0.0, 1.0) * (0.01 * u(n, 3))
    return pos1, eye, pos1 + step + side * (1 - torch.nn.functional.one_hot(axis, 3)), eye.clone()
  yaw = 2 * math.pi * u(n)
  c, s0, z, o = torch.cos(yaw), torch.sin(yaw), torch.zeros_like(yaw), torch.ones_like(yaw)
  mat2 = torch.stack([c, -s0, z, s0, c, z, z, z, o], 1).reshape(n, 3, 3)
  lift = torch.zeros(n, 3, dtype=dtype, device=device)
  lift[:, 2] = ext1[2] + ext2[2] - 0.001
  lift[:, :2] = 0.02 * u(n, 2) - 0.01
  return pos1, eye, pos1 + lift, mat2


def _sat_work(n: int, h1, h2, item: int) -> tuple[float, float]:
  """(bytes, operations) of one SAT batch.

  Bytes: each instance's two poses (24 numbers) read once and its 3
  separations and 4 int32 indices written once; both hulls' tables read
  once.  Operations: what the algorithm needs, each add, subtract,
  multiply, divide and square root counted once (comparisons, selects and
  the argmax reductions not counted), whatever csrc/sat.cu repeats:
    * world vertices R v + p, 18 each; world face normals R n, 15 each;
      face offsets n . v0, 5 each; edge directions b - a, 3, and midpoints
      0.5 (a + b), 6, per edge; centroids, 3 per vertex, and c2 - c1, 3;
    * face separations: n . v for each face and each vertex of the other
      hull, 5, and the offset subtracted, 1 per face;
    * per edge-cross axis: the cross product 9, |axis|^2 5, its square root
      1, the division 3, the orientation dot 5, the sign's multiply 3, the
      projections 5 per vertex of either hull, the separation 1;
    * the reselect: per axis the compatibility dot 5 and the score's
      subtraction 1; per edge its midpoint dot 5.
  Box-box (nv 8, nf 6, ne 12): 17,679 operations per instance."""
  sizes = [(len(h.vert), len(h.face_normal), len(h.edge)) for h in (h1, h2)]
  (nv1, nf1, ne1), (nv2, nf2, ne2) = sizes
  ops = 18 * (nv1 + nv2) + 20 * (nf1 + nf2) + 9 * (ne1 + ne2) + 3 * (nv1 + nv2) + 3
  ops += 5 * (nf1 * nv2 + nf2 * nv1) + nf1 + nf2
  ops += ne1 * ne2 * (33 + 5 * (nv1 + nv2)) + 5 * (ne1 + ne2)
  tables = sum((3 * nv + 3 * nf) * item + (nf + 2 * ne) * 4 for nv, nf, ne in sizes)
  return float(n * (27 * item + 16) + tables), float(n * ops)


def _geom_hulls(ns) -> list:
  """The hull tables of a snapshot's colliding boxes, cylinders and
  ellipsoids (mjtpu's, as committed), in the order of a collision group's
  pair: by geom type, then by geom id."""
  import numpy as np

  types = np.asarray(ns.geom_type)
  geoms = [g for g, h in enumerate(ns.geom_convex) if h is not None]
  return [ns.geom_convex[g] for g in sorted(geoms, key=lambda g: (int(types[g]), g))]


def round_hull_pairs() -> dict:
  """B3's round-hull pairs, name -> (hull1, hull2): the cylinder drop's
  cylinder and box, and the collision scenes' cylinder-cylinder,
  ellipsoid-box and ellipsoid-ellipsoid pairs (mjtpu's tables, from the
  committed snapshots)."""
  import mjtpu_torch

  bundle = mjtpu_torch.ASSETS / "collision_scenes.npz"
  return {
      "cylinder-box": tuple(_geom_hulls(mjtpu_torch.load_snapshot(
          mjtpu_torch.ASSETS / "cylinder_drop_model.npz"))),
      **{name.replace("_", "-"): tuple(_geom_hulls(mjtpu_torch.load_snapshot(bundle, name)))
         for name in ("cylinder_cylinder", "ellipsoid_box", "ellipsoid_ellipsoid")},
  }


def sat_check_pairs() -> dict:
  """Phase 9's hull pairs, name -> (hull 1, hull 2): the box and rock
  pairs (the static kernel's) and the round-hull pairs (the shared
  kernel's)."""
  import numpy as np

  from mjtpu_torch._src import mesh

  box = mesh.box(np.array([0.08, 0.08, 0.08]))  # scene_pile's boxes
  return {"box-box equal": (box, box),
          "box-box unequal": (mesh.box(np.array([0.1, 0.15, 0.2])),
                              mesh.box(np.array([0.12, 0.1, 0.08]))),
          "box-rock": (mesh.box(np.array([0.1, 0.15, 0.2])), _rock_hull()),
          **round_hull_pairs()}


def phase_sat_parity():
  """Phase 9's check of B3 against its twin, bit for bit (indices and
  separations), every variant the size dispatch allows, over
  sat_check_pairs() x random, axis-aligned and stacked poses x n in 1,
  130 and SAT_N (ROUND_N for the round hulls) x f32, f64.  Run as the side
  phase ``9-twin`` beside phase 22 (the twins at n = SAT_N are the card's
  work, not the host's), inline with --kernels."""
  import torch

  from mjtpu_torch.ops import sat

  gen = torch.Generator(device="cuda").manual_seed(2)
  rounds = round_hull_pairs()
  checked, edge_wins = {}, 0
  for dtype in (torch.float32, torch.float64):
    for name, (h1, h2) in sat_check_pairs().items():
      hulls = (sat.sat_hull(h1, dtype, "cuda"), sat.sat_hull(h2, dtype, "cuda"))
      if name in rounds and sat.variant(*hulls) != "shared":
        raise AssertionError(f"sat {name}: the size dispatch picks {sat.variant(*hulls)}")
      for kind_of_pose in ("random", "aligned", "stacked"):
        for n in (1, 130, ROUND_N if name in rounds else SAT_N):
          poses = _sat_poses(kind_of_pose, n, h1, h2, dtype, gen)
          twin = lambda: sat.sat_winners_reference(*poses, *hulls)
          want_seps, want_idx = twin()
          for kind in sat.variants(*hulls):
            kernel = lambda: sat.sat_winners_batch(*poses, *hulls, kernel=kind)
            seps, idx = kernel()
            torch.cuda.synchronize()
            for what, g, w, o in (("idx", idx, want_idx, 1), ("seps", seps, want_seps, 0)):
              if not torch.equal(_bits(g), _bits(w)):
                raise AssertionError(_mismatch(
                    f"sat {kind} kernel vs twin: {name} {kind_of_pose} n={n} {dtype} {what}:"
                    f" {int((_bits(g) != _bits(w)).any(1).sum())} instances differ in bits",
                    g.double(), w.double(), lambda: kernel()[o].double(),
                    lambda: twin()[o].double()))
            checked[kind] = checked.get(kind, 0) + n
          edge_wins += int((want_seps[:, 2] > want_seps[:, :2].max(1).values).sum())
  log(f"[sat] kernel == twin bit for bit (indices and separations) in every case: 3 box and"
      f" rock hull pairs x n in 1, 130, {SAT_N} and 4 round-hull pairs ({', '.join(rounds)};"
      f" the size dispatch picks shared) x n in 1, 130, {ROUND_N} x random, axis-aligned,"
      f" stacked poses x f32, f64; instances by variant {checked}; the edge axis wins in"
      f" {edge_wins}")


def phase_sat():
  """Phase 9's timings: B3's variants and its twin on the pile's box-box
  group and the round hulls at f32, and the main path's error (static
  against the twin on the timed box-box inputs); the bit-for-bit check is
  phase_sat_parity."""
  import numpy as np
  import torch

  from mjtpu_torch._src import mesh
  from mjtpu_torch.ops import sat

  gen = torch.Generator(device="cuda").manual_seed(2)
  box = mesh.box(np.array([0.08, 0.08, 0.08]))  # scene_pile's boxes
  rounds = round_hull_pairs()
  dtype = torch.float32
  hulls = (sat.sat_hull(box, dtype, "cuda"),) * 2
  poses = _sat_poses("random", SAT_N, box, box, dtype, gen)
  run = {kind: (lambda kind=kind: sat.sat_winners_batch(*poses, *hulls, kernel=kind))
         for kind in sat.variants(*hulls)}
  run_p = lambda: sat.sat_winners_reference(*poses, *hulls)
  main_err = float((run["static"]()[0] - run_p()[0]).abs().max())
  # plain, static, shared, shared, static, plain: compare within one call.  The
  # 61 MB the calls read and write (poses 47 MB) exceed the 50 MB L2: mostly
  # cold, and either way small beside the operations that bound the kernel
  p1, k1, s1 = cuda_ms(run_p, PLAIN_REPS), cuda_ms(run["static"]), cuda_ms(run["shared"])
  s2, k2, p2 = cuda_ms(run["shared"]), cuda_ms(run["static"]), cuda_ms(run_p, PLAIN_REPS)
  b_ms, b_by = bound(*_sat_work(SAT_N, box, box, 4), dtype)
  log(f"[sat] box-box n={SAT_N} f32: static kernel {k1:.4f} / {k2:.4f} ms, shared kernel"
      f" {s1:.4f} / {s2:.4f} ms, plain twin {p1:.4f} / {p2:.4f} ms, bound {b_ms:.5f} ms"
      f" ({b_by}) {TIMING}")
  variant_ms = {"static": min(k1, k2), "shared": min(s1, s2)}
  box_t = (min(k1, k2), min(p1, p2), None, b_ms, b_by)
  # the round hulls at n = ROUND_N (the cylinder drop's group at B=4096):
  # shared, the variant the size dispatch gives them
  shapes = {}
  for name, (h1, h2) in rounds.items():
    hulls = (sat.sat_hull(h1, dtype, "cuda"), sat.sat_hull(h2, dtype, "cuda"))
    poses = _sat_poses("random", ROUND_N, h1, h2, dtype, gen)
    run = lambda: sat.sat_winners_batch(*poses, *hulls)
    run_p = lambda: sat.sat_winners_reference(*poses, *hulls)
    p1, k1 = cuda_ms(run_p, PLAIN_REPS), cuda_ms(run)
    k2, p2 = cuda_ms(run), cuda_ms(run_p, PLAIN_REPS)
    seps, _ = run()
    err = float((seps - run_p()[0]).abs().max())
    b_ms, b_by = bound(*_sat_work(ROUND_N, h1, h2, 4), dtype)
    sizes = [sat.hull_sizes(h) for h in hulls]
    axes = sizes[0][2] * sizes[1][2]
    log(f"[sat] {name} n={ROUND_N} f32, (nv, nf, ne) {sizes[0]} x {sizes[1]}, {axes}"
        f" edge-cross axes: shared kernel {k1:.4f} / {k2:.4f} ms, plain twin"
        f" {p1:.4f} / {p2:.4f} ms, bound {b_ms:.5f} ms ({b_by}) {TIMING}")
    shapes[f"{name} n={ROUND_N}"] = {
        "ms": min(k1, k2), "plain_ms": min(p1, p2), "library_ms": None, "bound_ms": b_ms,
        "bound_by": b_by, "max_abs_err": err, "variant": "shared", "hull_sizes": sizes}
  return main_err, box_t, variant_ms, shapes


def branchy_parentid(limbs: int, links: int) -> tuple[int, ...]:
  """dof_parentid of tests/test_sparse.py's _branchy_xml(limbs, links): a
  free trunk (a chain of 6 dofs) with ``limbs`` chains of ``links`` hinges."""
  parent = [-1, 0, 1, 2, 3, 4]
  for _ in range(limbs):
    parent += [5] + list(range(len(parent), len(parent) + links - 1))
  return tuple(parent)


def random_parentid(nv: int, seed: int) -> tuple[int, ...]:
  """A seeded random dof tree: each dof continues its predecessor's chain
  with probability 0.6, else hangs from a random earlier dof."""
  import numpy as np

  rng = np.random.default_rng(seed)
  return (-1,) + tuple(i - 1 if rng.random() < 0.6 else int(rng.integers(0, i))
                       for i in range(1, nv))


def ldl_trees() -> dict:
  """The trees of phase 12, name -> dof_parentid."""
  return {"branchy66": branchy_parentid(6, 10), "branchy38": branchy_parentid(4, 8),
          "chain40": tuple(range(-1, 39)), "random100": random_parentid(100, 0)}


def chain_pattern_batch(t, batch, dtype, gen, massless=False):
  """(Mc, rhs, M): compact matrices Mc (batch, nv, depth) of M = L^T D L
  (batch, nv, nv) on the tree's pattern (L unit-lower, entries in
  [-0.5, 0.5], D in [0.5, 2]) and right-hand sides, on the device of the
  tables t and the generator gen.  massless: about 10% of the dofs get a
  zero row and column, so their pivots hit the MINVAL floor."""
  import torch

  from mjtpu_torch._src import sparse

  nv, dev = t.nv, t.sched.device
  u = lambda *shape: torch.rand(*shape, generator=gen, device=dev, dtype=dtype)
  L = torch.zeros(batch, nv * nv, dtype=dtype, device=dev)
  diag = torch.arange(nv, device=dev) * (nv + 1)
  off = t.real_dense[~torch.isin(t.real_dense, diag)]
  L[:, off] = u(batch, off.numel()) - 0.5
  L[:, diag] = 1.0
  L = L.reshape(batch, nv, nv)
  M = L.transpose(1, 2) @ ((0.5 + 1.5 * u(batch, nv))[:, :, None] * L)
  if massless:
    keep = (u(batch, nv) >= 0.1).to(dtype)
    M = M * keep[:, :, None] * keep[:, None, :]
  return sparse.gather_compact(t, M).contiguous(), (2 * u(batch, nv) - 1).contiguous(), M


def ldl_calls() -> dict:
  """B2's entry points: name -> (kernel, twin), each called as f(t, Mc,
  rhs, S) with the tables t, compact matrices Mc, right-hand sides rhs
  and the compact factors S of Mc; the kernel takes a fifth argument, the
  variant to launch (None: the wrapper's dispatch)."""
  from mjtpu_torch.ops import ldl

  return {
      "ldl_factor": (lambda t, mc, rhs, S, kind=None: ldl.ldl_factor(t, mc, kernel=kind),
                     lambda t, mc, rhs, S: ldl.ldl_factor_reference(t, mc)),
      "ldl_solve": (lambda t, mc, rhs, S, kind=None: ldl.ldl_solve(t, S, rhs, kernel=kind),
                    lambda t, mc, rhs, S: ldl.ldl_solve_reference(t, S, rhs)),
      "ldl_factor_solve": (lambda t, mc, rhs, S, kind=None: ldl.ldl_factor_solve(
                               t, mc, rhs, kernel=kind),
                           lambda t, mc, rhs, S: ldl.ldl_factor_solve_reference(t, mc, rhs)),
  }


def _ldl_work(s, batch: int, item: int, name: str) -> tuple[float, float]:
  """(bytes, operations) of one batched B2 call on the tree s.

  Bytes: the real entries of the compact (nv, depth) matrix or factor read
  once (its pad entries are zero by construction and need no read), the
  right-hand side read once, the output written once: the whole compact
  factor (pad entries included) or the solution.  Operations:
  what the algorithm needs, each add, subtract, multiply and divide
  counted once (comparisons not counted): the factor 3 per update (the
  product, its division by the pivot, the subtraction) and one division
  per off-diagonal of L; the solve 2 per off-diagonal in each of the Lᵀ
  and L passes and one division per dof."""
  nd, nv, real = s.nv * s.depth, s.nv, int((s.anc < s.nv).sum())
  updates = sum(len(r.u_k) for r in s.rounds)
  offdiag = real - nv
  factor_ops, solve_ops = 3 * updates + offdiag, 4 * offdiag + nv
  per = {"ldl_factor": (real + nd, factor_ops), "ldl_solve": (real + 2 * nv, solve_ops),
         "ldl_factor_solve": (real + 2 * nv, factor_ops + solve_ops)}[name]
  return float(batch * per[0] * item), float(batch * per[1])


def phase_ldl():
  import torch

  from mjtpu_torch._src import sparse
  from mjtpu_torch.ops import ldl

  gen = torch.Generator(device="cuda").manual_seed(3)
  calls = ldl_calls()
  checked, floored, main_err = {}, 0, {}
  for name, parent in ldl_trees().items():
    s = sparse._build(len(parent), parent)
    for dtype in (torch.float32, torch.float64):
      t = sparse.device_tables(s, dtype, "cuda")
      for batch, massless in ((1, False), (130, False), (4096, False), (130, True)):
        mc, rhs, _ = chain_pattern_batch(t, batch, dtype, gen, massless)
        S = ldl.ldl_factor_reference(t, mc)
        floored += int((S[:, :, -1] == sparse.MINVAL).sum())
        for entry, (kernel, twin) in calls.items():
          want = twin(t, mc, rhs, S)
          for kind in ldl.variants(t, dtype):
            run = lambda: kernel(t, mc, rhs, S, kind)
            got = run()
            torch.cuda.synchronize()
            # equal bit for bit (a -0 differs from a +0; NaN in the same places)
            if not torch.equal(_bits(got), _bits(want)):
              raise AssertionError(_mismatch(
                  f"ldl {kind} kernel vs twin: {entry} {name} B={batch} {dtype}"
                  f" massless={massless}: {int((_bits(got) != _bits(want)).sum())} entries"
                  f" differ in bits", got.double().nan_to_num(), want.double().nan_to_num(),
                  lambda: run().double().nan_to_num(),
                  lambda: twin(t, mc, rhs, S).double().nan_to_num()))
            checked[kind] = checked.get(kind, 0) + got.numel()
            if (name, batch, dtype, massless, kind) == ("branchy66", 4096, torch.float32,
                                                        False, "lanes"):
              main_err[entry] = float((got - want).abs().max())
  log(f"[ldl] kernel == twin bit for bit in every case: the three entry points x trees"
      f" branchy66, branchy38, chain40 (depth 40), random100 x B in 1, 130, 4096 and a massless"
      f" batch x f32, f64; output entries by variant {checked}; {floored} pivots at the MINVAL"
      f" floor")

  dtype = torch.float32
  s = sparse._build(66, ldl_trees()["branchy66"])
  t = sparse.device_tables(s, dtype, "cuda")
  mc, rhs, M = chain_pattern_batch(t, BENCH_BATCH, dtype, gen)
  S = ldl.ldl_factor_reference(t, mc)
  chol = torch.linalg.cholesky_ex(M).L
  # dense, with no MINVAL floor: not the function B2 computes, so its time
  # goes under context_ms and library_ms stays null (no PyTorch call
  # computes the tree-sparse floored LDL)
  dense = {
      "ldl_factor": lambda: torch.linalg.cholesky_ex(M),
      "ldl_solve": lambda: torch.cholesky_solve(rhs[..., None], chol),
      "ldl_factor_solve": lambda: torch.cholesky_solve(rhs[..., None],
                                                       torch.linalg.cholesky_ex(M).L),
  }
  times, context, variant_ms = {}, {}, {}
  for entry, (kernel, twin) in calls.items():
    run = {kind: (lambda kind=kind: kernel(t, mc, rhs, S, kind)) for kind in ldl.variants(t, dtype)}
    run_p = lambda: twin(t, mc, rhs, S)
    # plain, lanes, shared, shared, lanes, plain: compare within one call
    p1, k1, s1 = cuda_ms(run_p, PLAIN_REPS), cuda_ms(run["lanes"]), cuda_ms(run["shared"])
    s2, k2, p2 = cuda_ms(run["shared"]), cuda_ms(run["lanes"]), cuda_ms(run_p, PLAIN_REPS)
    context[entry] = lib = cuda_ms(dense[entry], PLAIN_REPS)
    b_ms, b_by = bound(*_ldl_work(s, BENCH_BATCH, 4, entry), dtype)
    times[entry] = (min(k1, k2), min(p1, p2), None, b_ms, b_by)
    variant_ms[entry] = {"lanes": min(k1, k2), "shared": min(s1, s2)}
    log(f"[ldl] {entry} branchy66 B={BENCH_BATCH} f32: lanes kernel {k1:.4f} / {k2:.4f} ms,"
        f" shared kernel {s1:.4f} / {s2:.4f} ms, plain twin {p1:.4f} / {p2:.4f} ms, dense"
        f" torch.linalg.cholesky_ex / cholesky_solve {lib:.4f} ms (context only), bound"
        f" {b_ms:.5f} ms ({b_by}) {TIMING}")
  return main_err, times, context, variant_ms


def _golden_run(m, golden, steps):
  import numpy as np
  import torch

  import mjtpu_torch

  d = mjtpu_torch.make_data(m, batch_size=golden["qpos0"].shape[0])
  dev = m.device
  d = mjtpu_torch.replace(
      d, qpos=torch.as_tensor(golden["qpos0"], device=dev),
      qvel=torch.as_tensor(golden["qvel0"], device=dev),
      ctrl=torch.as_tensor(golden["ctrl"], device=dev) if "ctrl" in golden else d.ctrl,
  )
  qpos, qvel, first = [], [], None
  for i in range(steps):
    d = mjtpu_torch.step(m, d)
    qpos.append(d.qpos.cpu().numpy())
    qvel.append(d.qvel.cpu().numpy())
    if i == 0:
      first = mjtpu_torch.data_to_numpy(d)
  return np.stack(qpos), np.stack(qvel), first, d


def _excess(qpos, qvel, gq, gv, tol):
  """(worst error, first (step, field, env, error) above tol or None)."""
  import numpy as np

  worst, first = 0.0, None
  for i in range(len(qpos)):
    for field, a, b in (("qpos", qpos[i], gq[i]), ("qvel", qvel[i], gv[i])):
      err = np.abs(a - b).max(axis=1)
      worst = max(worst, float(err.max()))
      if first is None and err.max() > tol:
        env = int(err.argmax())
        first = (i + 1, field, env, float(err[env]))
  return worst, first


def _step_one(first, golden, tag):
  import numpy as np

  for name, got in (("qacc", first.qacc), ("efc_force", first.efc_force),
                    ("contact.dist", first.contact.dist)):
    want = golden[name.replace(".", "_")]
    err = float(np.abs(got - want).max())
    log(f"[{tag}] step 1 {name}: max abs err {err:.3e} (limit 1e-9)")
    if not err <= 1e-9:
      raise AssertionError(f"{tag}: step 1 {name} differs from mjtpu by {err:.3e}")


def phase_parity():
  import numpy as np
  import torch

  import mjtpu_torch
  from mjtpu_torch._src import solver
  from mjtpu_torch.ops import cholesky

  golden = dict(np.load(mjtpu_torch.ASSETS / "humanoid_bench_golden.npz"))
  snapshot = mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / "humanoid_bench_model.npz")

  # benchmark configuration (iterations=1, ls_iterations=4)
  m = mjtpu_torch.model_from_arrays(snapshot, dtype=torch.float64, device="cuda")
  cholesky.launches = 0
  qpos, qvel, first, d = _golden_run(m, golden, PARITY_STEPS)
  launches = cholesky.launches
  if launches != PARITY_STEPS * m.opt.iterations:
    raise AssertionError(f"{launches} kernel launches in {PARITY_STEPS} steps")
  _step_one(first, golden, "parity")
  if not (np.isfinite(qpos).all() and np.isfinite(qvel).all()) or int(d.nreset.sum()):
    raise AssertionError("benchmark-config trajectory not finite or reset")
  # the CPU test's bounds: 1e-8 through step TIGHT_STEPS, 1e-6 over all
  head, _ = _excess(qpos[:TIGHT_STEPS], qvel[:TIGHT_STEPS], golden["qpos"], golden["qvel"], 1e-8)
  worst, excess = _excess(qpos, qvel, golden["qpos"], golden["qvel"], 1e-8)
  log(f"[parity] benchmark config, {PARITY_STEPS} steps B=4 f64: max abs err {head:.3e}"
      f" through step {TIGHT_STEPS} (limit 1e-8), {worst:.3e} over {PARITY_STEPS} (limit 1e-6);"
      f" kernel launches {launches} (one per step)")
  if excess:
    log(f"[parity] benchmark config exceeds 1e-8 first at step {excess[0]}, {excess[1]},"
        f" env {excess[2]}: {excess[3]:.3e} (ULP differences amplified by the truncated"
        f" solver; the converged run below holds 1e-8)")
  if not (head < 1e-8 and worst < 1e-6):
    raise AssertionError(
        f"benchmark-config trajectory differs from mjtpu: {head:.3e} through step"
        f" {TIGHT_STEPS}, {worst:.3e} over {PARITY_STEPS} steps")

  # converged solver: the iterate path no longer depends on rounding
  its = int(golden["converged_iterations"])
  snapshot.opt.iterations = its
  snapshot.opt.ls_iterations = its
  mc = mjtpu_torch.model_from_arrays(snapshot, dtype=torch.float64, device="cuda")
  cholesky.launches = 0
  before = solver.loop_counts["iterations"]
  qpos, qvel, _, _ = _golden_run(mc, golden, PARITY_STEPS)
  iterations = solver.loop_counts["iterations"] - before
  # one launch per Newton iteration; the solver leaves once every env is done
  if not cholesky.launches == iterations <= PARITY_STEPS * its:
    raise AssertionError(f"{cholesky.launches} kernel launches, {iterations} Newton iterations"
                         f" in {PARITY_STEPS} steps")
  worst, excess = _excess(qpos, qvel, golden["conv_qpos"], golden["conv_qvel"], 1e-8)
  log(f"[parity] converged solver (iterations={its}), {PARITY_STEPS} steps B=4 f64:"
      f" max abs err {worst:.3e} (limit 1e-8); {iterations / PARITY_STEPS:.2f} Newton"
      f" iterations and kernel launches per step")
  if excess:
    raise AssertionError(f"converged trajectory differs from mjtpu: {excess}")


def _f32_start(m, seed: int = 1):
  """B=4096 envs at qpos0 +-0.01 (as bench.py starts them), ctrl in [-1, 1]."""
  import numpy as np
  import torch

  import mjtpu_torch

  rng = np.random.default_rng(seed)
  qpos = m.qpos0.cpu().numpy()[None] + rng.uniform(-0.01, 0.01, (BENCH_BATCH, m.nq))
  ctrl = rng.uniform(-1.0, 1.0, (BENCH_BATCH, m.nu))
  d = mjtpu_torch.make_data(m, batch_size=BENCH_BATCH)
  return mjtpu_torch.replace(
      d, qpos=torch.as_tensor(qpos, dtype=torch.float32, device="cuda"),
      ctrl=torch.as_tensor(ctrl, dtype=torch.float32, device="cuda"),
  )


def _zero_counts() -> None:
  """Every kernel's launch count, in all and by variant, set to 0."""
  from mjtpu_torch.ops import cholesky, hfield, ldl, sat

  cholesky.launches = hfield.launches = sat.launches = 0
  ldl.launches.update(dict.fromkeys(LDL_ENTRIES, 0))
  for table in (cholesky.variant_launches, hfield.variant_launches, sat.variant_launches,
                *ldl.variant_launches.values()):
    table.update(dict.fromkeys(table, 0))


def _read_counts(expect: dict | None = None) -> dict:
  """Each kernel's launches since _zero_counts; fails unless every launch
  was of the redesigned variant (or of the variant ``expect`` names for a
  kernel, where the path's shapes take another), and adds them to
  VARIANT_LAUNCHES."""
  from mjtpu_torch.ops import cholesky, hfield, ldl, sat

  counts = {"chol_solve": cholesky.launches, "hfield_manifold": hfield.launches,
            "sat_winners": sat.launches, **ldl.launches}
  # the main path's launches by variant: the redesigned variant only
  by_variant = {"chol_solve": cholesky.variant_launches, "hfield_manifold":
                hfield.variant_launches, "sat_winners": sat.variant_launches,
                **ldl.variant_launches}
  for name, kinds in by_variant.items():
    want = (expect or {}).get(name, NEW_VARIANT[name])
    if any(k for kind, k in kinds.items() if kind != want):
      raise AssertionError(f"{name}: the main path launched {kinds}, not the {want} kernel only")
    total = VARIANT_LAUNCHES.setdefault(name, dict.fromkeys(kinds, 0))
    for kind, k in kinds.items():
      total[kind] += k
  return counts


def _timed_main_path(m, d, warmup, timed, expect=None, advance=None):
  """Warm-up steps, then the main path's run: every kernel count set to 0
  just before it and read just after (``expect``: _read_counts'; a step
  is ``advance(d)``, by default mjtpu_torch.step(m, d)).  Returns (d,
  secs, counts, the solver's iterations and linesearch rounds in the
  timed steps)."""
  import torch

  import mjtpu_torch
  from mjtpu_torch._src import solver

  advance = advance or (lambda d: mjtpu_torch.step(m, d))
  for _ in range(warmup):
    d = advance(d)
  torch.cuda.synchronize()
  _zero_counts()
  loops = dict(solver.loop_counts)
  t0 = time.perf_counter()
  for _ in range(timed):
    d = advance(d)
  torch.cuda.synchronize()
  secs = time.perf_counter() - t0
  loops = {k: solver.loop_counts[k] - loops[k] for k in loops}
  counts = _read_counts(expect)
  if not bool(torch.isfinite(d.qpos).all()) or int(d.nreset.sum()):
    raise AssertionError(f"f32 run not finite or reset: nreset {int(d.nreset.sum())}")
  return d, secs, counts, loops


def _only(**launches) -> dict:
  """The launch counts of a main path that launches only these kernels."""
  return {**dict.fromkeys(("chol_solve", "hfield_manifold", "sat_winners", *LDL_ENTRIES), 0),
          **launches}


def _seam_shares(m, d, steps, stages=False, advance=None, extra=None):
  """Per kernel (and with ``stages``, per sensor stage; with ``extra``,
  {name: (module, function)}, per such function): device ms per step
  inside its seam (CUDA events around each call), and the step's device
  ms, over ``steps`` further steps (``advance(d)``, by default
  mjtpu_torch.step(m, d)).  Also the set of n the Cholesky seam took."""
  import torch

  import mjtpu_torch
  from mjtpu_torch._src import sensor
  from mjtpu_torch.ops import fused, hfield, ldl, sat

  seams = {"chol_solve": (fused, "chol_solve"), "hfield_manifold": (hfield, "manifold_batch"),
           "sat_winners": (sat, "sat_winners_batch"),
           **{entry: (ldl, entry) for entry in LDL_ENTRIES}}
  if stages:
    seams.update({stage: (sensor, stage) for stage in SENSOR_STAGES})
  seams.update(extra or {})
  events = {k: [] for k in seams}
  originals = {k: getattr(mod, attr) for k, (mod, attr) in seams.items()}
  advance = advance or (lambda d: mjtpu_torch.step(m, d))
  chol_ns = set()

  def timed(key):
    def call(*args, **kwargs):
      if key == "chol_solve":
        chol_ns.add(int(args[1].shape[-1]))
      start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
      start.record()
      out = originals[key](*args, **kwargs)
      end.record()
      events[key].append((start, end))
      return out
    return call

  for key, (mod, attr) in seams.items():
    setattr(mod, attr, timed(key))
  try:
    step0, step1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    step0.record()
    for _ in range(steps):
      d = advance(d)
    step1.record()
    torch.cuda.synchronize()
  finally:
    for key, (mod, attr) in seams.items():
      setattr(mod, attr, originals[key])
  step_ms = step0.elapsed_time(step1) / steps
  shares = {k: sum(s.elapsed_time(e) for s, e in ev) / steps for k, ev in events.items()}
  shares["chol_ns"] = chol_ns
  return shares, step_ms


def phase_throughput(card):
  import torch

  import mjtpu_torch

  snapshot = mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / "humanoid_bench_model.npz")
  m = mjtpu_torch.model_from_arrays(snapshot, dtype=torch.float32, device="cuda")
  d, secs, counts, _ = _timed_main_path(m, _f32_start(m), WARMUP_STEPS, TIMED_STEPS)
  if counts != _only(chol_solve=TIMED_STEPS):
    raise AssertionError(f"kernel launches in {TIMED_STEPS} timed steps: {counts}")
  rate = BENCH_BATCH * TIMED_STEPS / secs
  shares, step_ms = _seam_shares(m, d, WARMUP_STEPS)
  log(f"[throughput] humanoid_bench f32 B={BENCH_BATCH}: {TIMED_STEPS} steps in {secs:.3f} s"
      f" = {rate:.0f} env-steps/s ({1e3 * secs / TIMED_STEPS:.3f} ms/step); qpos finite,"
      f" nreset 0; Cholesky kernel {shares['chol_solve']:.4f} ms/step ="
      f" {100 * shares['chol_solve'] / step_ms:.2f}% of step time; card {card}")
  return counts, (rate, 1e3 * secs / TIMED_STEPS)


def phase_terrain_parity():
  import numpy as np
  import torch

  import mjtpu_torch
  from mjtpu_torch._src import solver
  from mjtpu_torch.ops import cholesky, hfield

  golden = dict(np.load(mjtpu_torch.ASSETS / "humanoid_terrain_golden.npz"))
  snapshot = mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / "humanoid_terrain_model.npz")
  m = mjtpu_torch.model_from_arrays(snapshot, dtype=torch.float64, device="cuda")
  steps = golden["qpos"].shape[0]
  cholesky.launches = hfield.launches = 0
  before = solver.loop_counts["iterations"]
  qpos, qvel, first, d = _golden_run(m, golden, steps)
  counts = (cholesky.launches, hfield.launches)
  iterations = solver.loop_counts["iterations"] - before
  if counts != (iterations, 2 * steps) or iterations > m.opt.iterations * steps:
    raise AssertionError(f"(Cholesky, hfield) launches {counts}, {iterations} Newton iterations"
                         f" in {steps} steps")
  _step_one(first, golden, "terrain parity")
  if not (np.isfinite(qpos).all() and np.isfinite(qvel).all()) or int(d.nreset.sum()):
    raise AssertionError("terrain trajectory not finite or reset")
  worst, excess = _excess(qpos, qvel, golden["qpos"], golden["qvel"], 1e-8)
  log(f"[terrain parity] humanoid_terrain, {steps} steps B=4 f64: max abs err {worst:.3e}"
      f" (limit {TERRAIN_BOUND}); first step above 1e-8: {excess[0] if excess else 'none'};"
      f" launches: Cholesky {counts[0]} (one per Newton iteration, {counts[0] / steps:.2f} per"
      f" step, at most {m.opt.iterations}), hfield {counts[1]} (2 per step)")
  if excess:
    log(f"[terrain parity] exceeds 1e-8 first at step {excess[0]}, {excess[1]}, env {excess[2]}:"
        f" {excess[3]:.3e}")
  if not worst < TERRAIN_BOUND:
    raise AssertionError(f"terrain trajectory differs from mjtpu by {worst:.3e}")


def phase_terrain_throughput(card):
  import torch

  import mjtpu_torch

  snapshot = mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / "humanoid_terrain_model.npz")
  m = mjtpu_torch.model_from_arrays(snapshot, dtype=torch.float32, device="cuda")
  d, secs, counts, loops = _timed_main_path(m, _f32_start(m), TERRAIN_WARMUP, TERRAIN_TIMED)
  if counts != _only(chol_solve=loops["iterations"], hfield_manifold=2 * TERRAIN_TIMED) \
      or loops["iterations"] > m.opt.iterations * TERRAIN_TIMED:
    raise AssertionError(f"kernel launches in {TERRAIN_TIMED} timed steps: {counts}, Newton"
                         f" loops {loops}")
  rate = BENCH_BATCH * TERRAIN_TIMED / secs
  shares, step_ms = _seam_shares(m, d, TERRAIN_WARMUP)
  log(f"[terrain throughput] humanoid_terrain f32 B={BENCH_BATCH}: {TERRAIN_WARMUP} warm-up and"
      f" {TERRAIN_TIMED} timed steps in {secs:.3f} s = {rate:.0f} env-steps/s"
      f" ({1e3 * secs / TERRAIN_TIMED:.3f} ms/step); qpos finite, nreset 0; launches per step:"
      f" Cholesky {counts['chol_solve'] / TERRAIN_TIMED:.2f} (Newton"
      f" {loops['iterations'] / TERRAIN_TIMED:.2f} iterations,"
      f" {loops['ls_rounds'] / TERRAIN_TIMED:.2f} linesearch rounds), hfield"
      f" {counts['hfield_manifold'] // TERRAIN_TIMED}; device step {step_ms:.3f} ms, of it"
      f" Cholesky {shares['chol_solve']:.4f} ms ({100 * shares['chol_solve'] / step_ms:.2f}%),"
      f" hfield {shares['hfield_manifold']:.4f} ms"
      f" ({100 * shares['hfield_manifold'] / step_ms:.2f}%); card {card}")
  return counts


def _abs_err(got, want):
  """|got - want|, inf wherever got or want is not finite, so that a NaN
  fails every bound."""
  import numpy as np

  err = np.abs(got - want)
  return np.where(np.isfinite(err), err, np.inf)


def _scaled_err(got, want) -> float:
  """max |got - want| over max(1, max |want|); inf where either is not
  finite."""
  import numpy as np

  err = float(_abs_err(got, want).max())
  return err / max(1.0, float(np.abs(want).max())) if np.isfinite(err) else np.inf


def phase_pile_parity():
  import numpy as np
  import torch

  import mjtpu_torch
  from mjtpu_torch.ops import cholesky, sat

  golden = dict(np.load(mjtpu_torch.ASSETS / "scene_pile_golden.npz"))
  snapshot = mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / "scene_pile_model.npz")
  m = mjtpu_torch.model_from_arrays(snapshot, dtype=torch.float64, device="cuda")
  steps = PARITY_STEPS
  every = steps // golden["qpos"].shape[0]
  cholesky.launches = sat.launches = 0
  qpos, qvel, first, d = _golden_run(m, golden, steps)
  counts = (cholesky.launches, sat.launches)
  if counts != (0, steps):
    raise AssertionError(f"(Cholesky, SAT) launches {counts} in {steps} steps")
  dist_err = float(np.abs(first.contact.dist - golden["contact_dist"]).max())
  solve_err = {f: _scaled_err(getattr(first, f), golden[f]) for f in ("qacc", "efc_force")}
  log(f"[pile parity] step 1: contact.dist max abs err {dist_err:.3e} (limit 1e-9); qacc"
      f" {solve_err['qacc']:.3e}, efc_force {solve_err['efc_force']:.3e} of their scale (limit"
      f" {PILE_SOLVE_BOUND}); solver iterations {first.solver_niter.tolist()} (mjtpu"
      f" {golden['solver_niter'].tolist()})")
  if not (dist_err <= 1e-9 and max(solve_err.values()) <= PILE_SOLVE_BOUND):
    raise AssertionError(f"pile step 1 differs from mjtpu: dist {dist_err:.3e}, {solve_err}")
  if not (np.isfinite(qpos).all() and np.isfinite(qvel).all()) or int(d.nreset.sum()):
    raise AssertionError("pile trajectory not finite or reset")
  worst, excess = _excess(qpos[every - 1::every], qvel[every - 1::every], golden["qpos"],
                          golden["qvel"], 1e-8)
  log(f"[pile parity] scene_pile, {steps} steps B=4 f64: max abs err {worst:.3e} over every"
      f" {every}th step (limit {PILE_BOUND}); first above 1e-8:"
      f" {'step %d, %s, env %d: %.3e' % (excess[0] * every, *excess[1:]) if excess else 'none'};"
      f" launches: SAT {counts[1]} (1 per step), Cholesky {counts[0]}")
  if not worst < PILE_BOUND:
    raise AssertionError(f"pile trajectory differs from mjtpu by {worst:.3e}")


def phase_pile_throughput(card):
  import torch

  import mjtpu_torch
  from mjtpu_torch._src import solver

  snapshot = mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / "scene_pile_model.npz")
  m = mjtpu_torch.model_from_arrays(snapshot, dtype=torch.float32, device="cuda")
  d = _f32_start(m)
  qpos = d.qpos.clone()
  qpos[:, 2::7] -= 0.25  # the bottom layer starts in the floor
  d = mjtpu_torch.replace(d, qpos=qpos)
  before = dict(solver.loop_counts)
  d, secs, counts, _ = _timed_main_path(m, d, PILE_WARMUP, PILE_TIMED)
  if counts != _only(sat_winners=PILE_TIMED):
    raise AssertionError(f"kernel launches in {PILE_TIMED} timed steps: {counts}")
  loops = {k: (solver.loop_counts[k] - before[k]) / (PILE_WARMUP + PILE_TIMED) for k in before}
  rate = BENCH_BATCH * PILE_TIMED / secs
  shares, step_ms = _seam_shares(m, d, PILE_WARMUP)
  log(f"[pile throughput] scene_pile f32 B={BENCH_BATCH}: {PILE_WARMUP} warm-up and"
      f" {PILE_TIMED} timed steps in {secs:.3f} s = {rate:.0f} env-steps/s"
      f" ({1e3 * secs / PILE_TIMED:.3f} ms/step); qpos finite, nreset 0; per step: SAT"
      f" {counts['sat_winners'] // PILE_TIMED} launch, CG {loops['iterations']:.1f} iterations"
      f" and {loops['ls_rounds']:.1f} linesearch rounds (warm-up and timed steps); device step"
      f" {step_ms:.3f} ms, of it SAT {shares['sat_winners']:.4f} ms"
      f" ({100 * shares['sat_winners'] / step_ms:.2f}%); card {card}")
  return counts


def phase_branchy_parity():
  import numpy as np
  import torch

  import mjtpu_torch
  from mjtpu_torch.ops import cholesky, ldl

  golden = dict(np.load(mjtpu_torch.ASSETS / "branchy66_golden.npz"))
  snapshot = mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / "branchy66_model.npz")
  m = mjtpu_torch.model_from_arrays(snapshot, dtype=torch.float64, device="cuda")
  steps = golden["qpos"].shape[0]
  cholesky.launches = 0
  ldl.launches.update(dict.fromkeys(LDL_ENTRIES, 0))
  qpos, qvel, first, d = _golden_run(m, golden, steps)
  counts = {"chol_solve": cholesky.launches, **ldl.launches}
  if counts != {"chol_solve": 0, **dict.fromkeys(LDL_ENTRIES, steps)}:
    raise AssertionError(f"launches {counts} in {steps} steps")
  fields = {f: _scaled_err(getattr(first, f), golden[f])
            for f in ("qLD", "qLDiagInv", "qacc_smooth", "qacc")}
  log(f"[branchy parity] step 1, of each field's scale (limit 1e-10): "
      + ", ".join(f"{k} {v:.3e}" for k, v in fields.items()))
  if not max(fields.values()) <= 1e-10:
    raise AssertionError(f"branchy step 1 differs from mjtpu: {fields}")
  if not (np.isfinite(qpos).all() and np.isfinite(qvel).all()) or int(d.nreset.sum()):
    raise AssertionError("branchy trajectory not finite or reset")
  worst, excess = _excess(qpos, qvel, golden["qpos"], golden["qvel"], BRANCHY_BOUND)
  log(f"[branchy parity] branchy66, {steps} steps B=4 f64: max abs err {worst:.3e} (limit"
      f" {BRANCHY_BOUND}); launches: ldl_factor, ldl_solve, ldl_factor_solve"
      f" {counts['ldl_factor']}, {counts['ldl_solve']}, {counts['ldl_factor_solve']} (one each"
      f" per step), Cholesky {counts['chol_solve']}")
  if excess:
    raise AssertionError(f"branchy trajectory differs from mjtpu: {excess}")


def phase_branchy_throughput(card):
  import torch

  import mjtpu_torch

  snapshot = mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / "branchy66_model.npz")
  m = mjtpu_torch.model_from_arrays(snapshot, dtype=torch.float32, device="cuda")
  d, secs, counts, _ = _timed_main_path(m, _f32_start(m), BRANCHY_WARMUP, BRANCHY_TIMED)
  if counts != _only(**dict.fromkeys(LDL_ENTRIES, BRANCHY_TIMED)):
    raise AssertionError(f"kernel launches in {BRANCHY_TIMED} timed steps: {counts}")
  rate = BENCH_BATCH * BRANCHY_TIMED / secs
  shares, step_ms = _seam_shares(m, d, BRANCHY_WARMUP)
  b2 = sum(shares[e] for e in LDL_ENTRIES)
  log(f"[branchy throughput] branchy66 f32 B={BENCH_BATCH}: {BRANCHY_WARMUP} warm-up and"
      f" {BRANCHY_TIMED} timed steps in {secs:.3f} s = {rate:.0f} env-steps/s"
      f" ({1e3 * secs / BRANCHY_TIMED:.3f} ms/step); qpos finite, nreset 0; launches per step:"
      f" ldl_factor, ldl_solve, ldl_factor_solve 1 each, Cholesky 0; device step {step_ms:.3f}"
      f" ms, of it B2 {b2:.4f} ms ({100 * b2 / step_ms:.2f}%: "
      + ", ".join(f"{e} {shares[e]:.4f}" for e in LDL_ENTRIES) + f"); card {card}")
  return counts


def _sensor_scale(m, golden):
  """(nsensordata,) each sensor's largest |value| in the golden, at least
  1, repeated over its dimensions (tests/test_torch_ant.py's scale)."""
  import numpy as np

  top = np.abs(golden["sensordata"]).max(axis=(0, 1))
  return np.concatenate([np.full(int(m.sensor_dim[i]), max(1.0, float(
      top[m.sensor_adr[i]:m.sensor_adr[i] + m.sensor_dim[i]].max()))) for i in range(m.nsensor)])


def phase_ant_parity():
  import numpy as np
  import torch

  import mjtpu_torch
  from mjtpu_torch._src import solver
  from mjtpu_torch.ops import cholesky

  golden = dict(np.load(mjtpu_torch.ASSETS / "ant_bench_golden.npz"))
  snapshot = mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / "ant_bench_model.npz")
  m = mjtpu_torch.model_from_arrays(snapshot, dtype=torch.float64, device="cuda")
  steps = golden["qpos"].shape[0]
  scale = _sensor_scale(m, golden)
  cholesky.launches = 0
  before = dict(cholesky.variant_launches)
  loops = dict(solver.loop_counts)
  d = mjtpu_torch.make_data(m, batch_size=golden["qpos0"].shape[0])
  d = mjtpu_torch.replace(d, qpos=torch.as_tensor(golden["qpos0"], device="cuda"),
                          qvel=torch.as_tensor(golden["qvel0"], device="cuda"),
                          ctrl=torch.as_tensor(golden["ctrl"], device="cuda"))
  err = {"qpos": 0.0, "qvel": 0.0, "sensordata": 0.0}
  for i in range(steps):
    d = mjtpu_torch.step(m, d)
    for f in ("qpos", "qvel"):
      err[f] = max(err[f], float(np.abs(getattr(d, f).cpu().numpy() - golden[f][i]).max()))
    err["sensordata"] = max(err["sensordata"], float(
        (np.abs(d.sensordata.cpu().numpy() - golden["sensordata"][i]) / scale).max()))
  loops = {k: solver.loop_counts[k] - loops[k] for k in loops}
  kinds = {k: cholesky.variant_launches[k] - before[k] for k in before}
  log(f"[ant parity] ant_bench, {steps} steps B=4 f64: max abs err qpos {err['qpos']:.3e}, qvel"
      f" {err['qvel']:.3e}, sensordata {err['sensordata']:.3e} of each sensor's scale (limit"
      f" {ANT_BOUND}); Newton {loops['iterations']} iterations and {loops['ls_rounds']}"
      f" linesearch rounds in {steps} steps; Cholesky launches {cholesky.launches} by variant"
      f" {kinds} (one per Newton iteration and one per step for Euler's damping, n=8)")
  if int(d.nreset.sum()) or not max(err.values()) <= ANT_BOUND:
    raise AssertionError(f"ant trajectory differs from mjtpu: {err}, nreset {int(d.nreset.sum())}")
  if cholesky.launches != loops["iterations"] + steps or kinds["register"] != cholesky.launches:
    raise AssertionError(f"Cholesky launches {cholesky.launches} ({kinds}), Newton {loops}")


def _ant_start(m):
  """B=4096 envs with every joint uniform over its range and ctrl in
  [-1, 1] (numpy seed 1)."""
  import numpy as np
  import torch

  import mjtpu_torch

  rng = np.random.default_rng(1)
  lo, hi = (m.jnt_range[:, k].cpu().numpy() for k in (0, 1))
  qpos = np.tile(m.qpos0.cpu().numpy(), (BENCH_BATCH, 1))
  qpos[:, m.jnt_qposadr] = rng.uniform(lo, hi, (BENCH_BATCH, m.njnt))
  ctrl = rng.uniform(-1.0, 1.0, (BENCH_BATCH, m.nu))
  d = mjtpu_torch.make_data(m, batch_size=BENCH_BATCH)
  return mjtpu_torch.replace(
      d, qpos=torch.as_tensor(qpos, dtype=torch.float32, device="cuda"),
      ctrl=torch.as_tensor(ctrl, dtype=torch.float32, device="cuda"))


def phase_ant_throughput(card):
  import numpy as np
  import torch

  import mjtpu_torch

  snapshot = mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / "ant_bench_model.npz")
  m = mjtpu_torch.model_from_arrays(snapshot, dtype=torch.float32, device="cuda")
  d, secs, counts, loops = _timed_main_path(m, _ant_start(m), ANT_WARMUP, ANT_TIMED)
  if counts != _only(chol_solve=loops["iterations"] + ANT_TIMED):
    raise AssertionError(f"kernel launches in {ANT_TIMED} timed steps: {counts}, Newton {loops}")
  rate = BENCH_BATCH * ANT_TIMED / secs
  shares, step_ms = _seam_shares(m, d, ANT_WARMUP, stages=True)
  touch = np.asarray(m.sensor_type) == mjtpu_torch.SensorType.TOUCH
  cols = np.concatenate([m.sensor_adr[i] + np.arange(m.sensor_dim[i])
                         for i in np.nonzero(touch)[0]])
  nonzero = int((d.sensordata[:, torch.as_tensor(cols, device="cuda")] != 0).sum())
  stage_ms = sum(shares[k] for k in SENSOR_STAGES)
  log(f"[ant throughput] ant_bench f32 B={BENCH_BATCH}: {ANT_WARMUP} warm-up and {ANT_TIMED}"
      f" timed steps in {secs:.3f} s = {rate:.0f} env-steps/s ({1e3 * secs / ANT_TIMED:.3f}"
      f" ms/step); qpos finite, nreset 0; per step: B1 register"
      f" {counts['chol_solve'] / ANT_TIMED:.2f} launches (n=8), Newton"
      f" {loops['iterations'] / ANT_TIMED:.2f} iterations and"
      f" {loops['ls_rounds'] / ANT_TIMED:.2f} linesearch rounds; device step {step_ms:.3f} ms,"
      f" of it B1 {shares['chol_solve']:.4f} ms ({100 * shares['chol_solve'] / step_ms:.2f}%),"
      f" sensor stages {stage_ms:.4f} ms ({100 * stage_ms / step_ms:.2f}%: "
      + ", ".join(f"{k} {shares[k]:.4f}" for k in SENSOR_STAGES)
      + f"); touch readings not zero after the last step: {nonzero} of {BENCH_BATCH * len(cols)};"
      f" card {card}")
  return counts


def phase_ant_rk4_parity():
  import numpy as np
  import torch

  import mjtpu_torch
  from mjtpu_torch._src import forward as forward_mod
  from mjtpu_torch._src import solver
  from mjtpu_torch.ops import cholesky

  golden = dict(np.load(mjtpu_torch.ASSETS / "ant_rk4_golden.npz"))
  snapshot = mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / "ant_model.npz")
  m = mjtpu_torch.model_from_arrays(snapshot, dtype=torch.float64, device="cuda")
  steps = golden["qpos"].shape[0]
  d = mjtpu_torch.make_data(m, batch_size=golden["qpos0"].shape[0])
  d = mjtpu_torch.replace(d, qpos=torch.as_tensor(golden["qpos0"], device="cuda"),
                          qvel=torch.as_tensor(golden["qvel0"], device="cuda"),
                          ctrl=torch.as_tensor(golden["ctrl"], device="cuda"))
  cholesky.launches = 0
  before = dict(cholesky.variant_launches)
  loops = dict(solver.loop_counts)
  # step 1's forward passes, read through the forward seam
  passes, original = [], forward_mod.forward

  def record(m, d, **kw):
    d = original(m, d, **kw)
    passes.append(d.qacc.cpu().numpy())
    return d

  forward_mod.forward = record
  try:
    d = mjtpu_torch.step(m, d)
  finally:
    forward_mod.forward = original
  pass_err = max(_scaled_err(p, w) for p, w in zip(passes, golden["pass_qacc"]))
  warm_err = max(_scaled_err(getattr(d, f).cpu().numpy(), golden[f])
                 for f in ("qacc", "qacc_warmstart"))
  err = {"qpos": 0.0, "qvel": 0.0}
  for i in range(steps):
    d = d if i == 0 else mjtpu_torch.step(m, d)  # step 1 ran above
    for f in err:
      err[f] = max(err[f], float(np.abs(getattr(d, f).cpu().numpy() - golden[f][i]).max()))
  loops = {k: solver.loop_counts[k] - loops[k] for k in loops}
  kinds = {k: cholesky.variant_launches[k] - before[k] for k in before}
  log(f"[ant rk4 parity] ant.xml RK4, {steps} steps B=4 f64: step 1's {len(passes)} forward"
      f" passes' qacc {pass_err:.3e}, qacc and qacc_warmstart {warm_err:.3e} of scale (limit"
      f" {ANT_RK4_PASS_BOUND}); max abs err qpos {err['qpos']:.3e}, qvel {err['qvel']:.3e}"
      f" (limit {ANT_BOUND}); Newton {loops['iterations']} iterations and"
      f" {loops['ls_rounds']} linesearch rounds in {4 * steps} forward passes; Cholesky"
      f" launches {cholesky.launches} by variant {kinds} (one per Newton iteration, n=14)")
  if len(passes) != 4 or not max(pass_err, warm_err) <= ANT_RK4_PASS_BOUND:
    raise AssertionError(f"ant RK4 passes differ from mjtpu: {pass_err:.3e}, {warm_err:.3e}")
  if int(d.nreset.sum()) or not max(err.values()) <= ANT_BOUND:
    raise AssertionError(f"ant RK4 trajectory differs from mjtpu: {err}")
  if cholesky.launches != loops["iterations"] or kinds["register"] != cholesky.launches:
    raise AssertionError(f"Cholesky launches {cholesky.launches} ({kinds}), Newton {loops}")


def _env_golden_err(name, golden) -> float:
  """Steps ``zoo.ENVS[name]`` at f64 on the card from an env golden's
  states through its actions (3 env steps): the max abs error of obs and
  reward against mjtpu's env; fails unless done and steps are mjtpu's.
  Env 3 ends its episode at the first step and then restarts from mjtpu's
  PRNG: only that step's reward, done and steps compare."""
  import dataclasses

  import numpy as np
  import torch

  import mjtpu_torch
  from mjtpu_torch import zoo

  env = zoo.ENVS[name](dtype=torch.float64)
  m = env.model
  d = mjtpu_torch.make_data(m, batch_size=golden[f"{name}.qpos0"].shape[0])
  d = mjtpu_torch.replace(d, qpos=torch.as_tensor(golden[f"{name}.qpos0"], device="cuda"),
                          qvel=torch.as_tensor(golden[f"{name}.qvel0"], device="cuda"))
  state = dataclasses.replace(env._init_state(mjtpu_torch.forward(m, d)), steps=torch.as_tensor(
      golden[f"{name}.steps0"], device="cuda"))
  gen = torch.Generator(device="cuda").manual_seed(0)
  err = 0.0
  actions = golden[f"{name}.action"]
  for t in range(actions.shape[0]):
    state = env.step(state, torch.as_tensor(actions[t], device="cuda"), gen)
    live = 4 if t == 0 else 3
    for k, n in (("obs", 3), ("reward", live)):
      got = getattr(state, k)[:n].cpu().numpy()
      err = max(err, float(np.abs(got - golden[f"{name}.{k}"][t][:n]).max()))
    for k in ("done", "steps"):
      if not np.array_equal(getattr(state, k)[:live].cpu().numpy(),
                            golden[f"{name}.{k}"][t][:live]):
        raise AssertionError(f"{name} env step {t + 1} {k}: {getattr(state, k).tolist()}"
                             f" against mjtpu's {golden[f'{name}.{k}'][t].tolist()}")
  if not err <= ENV_BOUND:
    raise AssertionError(f"{name}: obs or reward differ from mjtpu's env by {err:.3e}")
  return err


def phase_env_parity():
  import numpy as np

  import mjtpu_torch

  golden = dict(np.load(mjtpu_torch.ASSETS / "zoo_env_golden.npz"))
  worst = {name: _env_golden_err(name, golden) for name in ZOO_LOCOMOTION}
  log(f"[env parity] {', '.join(ZOO_LOCOMOTION)} f64 B=4, 3 env steps through"
      f" mjtpu_torch.zoo.ENVS: max abs err of obs and reward "
      + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
      + f" (limit {ENV_BOUND}); done and steps equal to mjtpu's env, the forced-done env's"
      " first step included")


def _env_throughput(name, profile=False):
  """``zoo.ENVS[name]`` at f32 B=4096 on the card, reset from a seeded
  torch.Generator, ENV_WARMUP warm-up and ENV_TIMED timed env steps with
  actions uniform in [-1, 1]: the main path's launches (one B1 launch per
  Newton iteration, all at n = nv, register), nreset 0 (summed after every
  env step: a done env is reset), B1's share of one more env step, and
  with ``profile`` the device's busy share of one profiled env step.
  Returns (counts, the log line's figures)."""
  import torch

  from mjtpu_torch import zoo
  from mjtpu_torch._src import solver
  from mjtpu_torch.ops import cholesky

  env = zoo.ENVS[name]()  # float32, on cuda
  if env.model.dtype != torch.float32 or env.device.type != "cuda":
    raise AssertionError(f"the {name} env built at {env.model.dtype} on {env.device}")
  batch = BENCH_BATCH
  gen = torch.Generator(device="cuda").manual_seed(0)
  act = lambda: 2.0 * torch.rand(batch, env.action_size, generator=gen, device="cuda") - 1.0
  state = env.reset(batch, gen)
  for _ in range(ENV_WARMUP):
    state = env.step(state, act(), gen)
  actions = [act() for _ in range(ENV_TIMED)]
  nreset = torch.zeros((), dtype=torch.int64, device="cuda")
  resets = torch.zeros((), dtype=torch.int64, device="cuda")
  torch.cuda.synchronize()
  _zero_counts()
  loops = dict(solver.loop_counts)
  t0 = time.perf_counter()
  for a in actions:
    state = env.step(state, a, gen)
    # a NaN recovery inside the step stays in nreset until the env is done
    # and reset: read it after every env step, on the device
    nreset += state.data.nreset.sum()
    resets += state.done.sum()
  torch.cuda.synchronize()
  secs = time.perf_counter() - t0
  loops = {k: solver.loop_counts[k] - loops[k] for k in loops}
  counts = _read_counts()
  kinds = dict(cholesky.variant_launches)
  physics = ENV_TIMED * env.frame_skip
  if counts != _only(chol_solve=loops["iterations"]) or not counts["chol_solve"]:
    raise AssertionError(f"{name} env: kernel launches in {ENV_TIMED} env steps: {counts},"
                         f" Newton {loops}")
  if not bool(torch.isfinite(state.data.qpos).all()) or int(nreset):
    raise AssertionError(f"{name} env run not finite or reset: nreset {int(nreset)}")
  advance = lambda s: env.step(s, act(), gen)
  shares, step_ms = _seam_shares(env.model, state, 1, advance=advance)
  if shares["chol_ns"] != {env.model.nv}:
    raise AssertionError(f"Cholesky launches at n={shares['chol_ns']}, not {env.model.nv}")
  busy = _busy_share(advance, state) if profile else None
  fig = dict(rate=batch * ENV_TIMED / secs, physics_rate=batch * physics / secs,
             ms=1e3 * secs / ENV_TIMED, iterations=loops["iterations"] / physics,
             ls_rounds=loops["ls_rounds"] / physics, launches=counts["chol_solve"] / ENV_TIMED,
             kinds=kinds, resets=int(resets), step_ms=step_ms, b1_ms=shares["chol_solve"],
             busy=busy, frame_skip=env.frame_skip, nv=env.model.nv)
  return counts, fig


def _env_line(fig, card) -> str:
  """The throughput log line of an env's figures (_env_throughput)."""
  line = (f"{ENV_WARMUP} warm-up and {ENV_TIMED} timed env steps ="
          f" {fig['rate']:.0f} env steps/s, {fig['physics_rate']:.0f} physics steps/s,"
          f" {fig['ms']:.3f} ms per env step ({fig['frame_skip']} physics steps x 4 forward"
          f" passes + the reset forward); per physics step: Newton {fig['iterations']:.2f}"
          f" iterations, {fig['ls_rounds']:.2f} linesearch rounds; B1 launches per env step"
          f" {fig['launches']:.2f}, by variant in all {fig['kinds']} (all at n={fig['nv']},"
          f" one per Newton iteration); auto-resets {fig['resets']} of"
          f" {BENCH_BATCH * ENV_TIMED}; qpos finite, nreset 0; device env step"
          f" {fig['step_ms']:.3f} ms, of it B1 {fig['b1_ms']:.4f} ms"
          f" ({100 * fig['b1_ms'] / fig['step_ms']:.2f}%)")
  if fig["busy"] is not None:
    busy, launches = fig["busy"]
    line += (f"; one profiled env step: {launches} kernel launches, device busy"
             f" {100 * busy:.1f}% of its wall time")
  return line + f"; card {card}"


def phase_env_throughput(card):
  counts, fig = _env_throughput("ant")
  log(f"[env throughput] Ant env (ant.xml, RK4) f32 B={BENCH_BATCH} through ENVS['ant']: "
      + _env_line(fig, card))
  return counts


def _contacts_close(c, golden, prefix, tag) -> float:
  """Worst scaled error of the contacts c (dist, pos, frame) against the
  golden's, whose geoms must be equal; fails past CONTACT_BOUND."""
  import numpy as np

  for k in ("geom1", "geom2"):
    if not np.array_equal(getattr(c, k).cpu().numpy(), golden[prefix + k]):
      raise AssertionError(f"{tag}: contact {k} differs from mjtpu's")
  err = max(_scaled_err(getattr(c, k).cpu().numpy(), golden[prefix + k])
            for k in ("dist", "pos", "frame"))
  if not err <= CONTACT_BOUND:
    raise AssertionError(f"{tag}: contacts differ from mjtpu's by {err:.3e} of scale")
  return err


def phase_collision_parity():
  import numpy as np
  import torch

  import mjtpu_torch
  from mjtpu_torch._src import collision_driver, io, smooth, solver
  from mjtpu_torch.ops import cholesky, sat

  for name in CONTACT_MODELS:
    golden = dict(np.load(mjtpu_torch.ASSETS / f"{name}_golden.npz"))
    snapshot = mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / f"{name}_model.npz")
    m = mjtpu_torch.model_from_arrays(snapshot, dtype=torch.float64, device="cuda")
    steps = golden["qpos"].shape[0]
    d = mjtpu_torch.make_data(m, batch_size=golden["qpos0"].shape[0])
    d = mjtpu_torch.replace(d, qpos=torch.as_tensor(golden["qpos0"], device="cuda"),
                            qvel=torch.as_tensor(golden["qvel0"], device="cuda"))
    cholesky.launches = sat.launches = 0
    loops = dict(solver.loop_counts)
    err = {"qpos": 0.0, "qvel": 0.0}
    for i in range(steps):
      d = mjtpu_torch.step(m, d)
      if i == 0:
        contact_err = _contacts_close(d.contact, golden, "contact_", f"{name} step 1")
      for f in err:
        err[f] = max(err[f], float(np.abs(getattr(d, f).cpu().numpy() - golden[f][i]).max()))
    loops = {k: solver.loop_counts[k] - loops[k] for k in loops}
    launches = {"sat_winners": sat.launches, "chol_solve": cholesky.launches}
    want = {"sat_winners": steps if name == "cylinder_drop" else 0,
            "chol_solve": loops["iterations"]}
    log(f"[collision parity] {name}, {steps} steps B=4 f64: step-1 contacts {contact_err:.3e} of"
        f" scale (limit {CONTACT_BOUND}); max abs err qpos {err['qpos']:.3e}, qvel"
        f" {err['qvel']:.3e} (limit {CONTACT_TRAJECTORY_BOUND}); Newton {loops['iterations']}"
        f" iterations and {loops['ls_rounds']} linesearch rounds; launches {launches}")
    if int(d.nreset.sum()) or not max(err.values()) <= CONTACT_TRAJECTORY_BOUND:
      raise AssertionError(f"{name} trajectory differs from mjtpu: {err}")
    if launches != want:
      raise AssertionError(f"{name}: launches {launches}, want {want}")

  bundle = mjtpu_torch.ASSETS / "collision_scenes.npz"
  golden = dict(np.load(mjtpu_torch.ASSETS / "collision_scenes_golden.npz"))
  worst, sat.launches, groups = 0.0, 0, set()
  names = io.bundle_names(bundle)
  for name in names:
    m = mjtpu_torch.model_from_arrays(io.load_snapshot(bundle, name), dtype=torch.float64,
                                      device="cuda")
    groups |= {k[:2] for k in collision_driver.candidate_groups(m)}
    d = mjtpu_torch.make_data(m, batch_size=golden[f"{name}.qpos0"].shape[0])
    d = mjtpu_torch.replace(d, qpos=torch.as_tensor(golden[f"{name}.qpos0"], device="cuda"))
    c = collision_driver.collision(m, smooth.kinematics(m, d)).contact
    worst = max(worst, _contacts_close(c, golden, f"{name}.", name))
  log(f"[collision parity] {len(names)} scenes ({', '.join(names)}), B=2 f64: contacts within"
      f" {worst:.3e} of scale of mjtpu's (limit {CONTACT_BOUND}), geoms equal; {len(groups)}"
      f" geom-type pairs; SAT launches {sat.launches}")


def _drop_start(m):
  """B=4096 cylinders turned at random (numpy seed 1) over the box, their
  lowest point 0 to 2 cm above its top (z = 0.1) and xy in +-0.3 m, at
  rest."""
  import numpy as np
  import torch

  import mjtpu_torch

  rng = np.random.default_rng(1)
  q = rng.normal(size=(BENCH_BATCH, 4))
  q /= np.linalg.norm(q, axis=1, keepdims=True)
  w, x, y, _ = q.T
  axis_z = 1 - 2 * (x * x + y * y)  # the cylinder axis' world z
  r, h = (float(v) for v in m.geom_size[1, :2])
  low = h * np.abs(axis_z) + r * np.sqrt(np.clip(1 - axis_z ** 2, 0.0, 1.0))
  qpos = np.concatenate([rng.uniform(-0.3, 0.3, (BENCH_BATCH, 2)),
                         (0.1 + low + rng.uniform(0.0, 0.02, BENCH_BATCH))[:, None], q], axis=1)
  d = mjtpu_torch.make_data(m, batch_size=BENCH_BATCH)
  return mjtpu_torch.replace(d, qpos=torch.as_tensor(qpos, dtype=torch.float32, device="cuda"))


def _busy_share(advance, d) -> tuple[float, int]:
  """(the device's busy share, kernel launches) of one more step
  ``advance(d)`` traced by torch.profiler: the kernels' device time over
  the wall time."""
  import torch
  from torch.profiler import ProfilerActivity, profile

  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    advance(d)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
  kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
  if not kernels:
    raise AssertionError("torch.profiler traced no device kernel")
  return sum(e.device_time for e in kernels) / 1e6 / wall, len(kernels)


def phase_drop_throughput(card):
  import torch

  import mjtpu_torch

  snapshot = mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / "cylinder_drop_model.npz")
  m = mjtpu_torch.model_from_arrays(snapshot, dtype=torch.float32, device="cuda")
  d, secs, counts, loops = _timed_main_path(m, _drop_start(m), DROP_WARMUP, DROP_TIMED,
                                            expect={"sat_winners": "shared"})
  if counts != _only(sat_winners=DROP_TIMED, chol_solve=loops["iterations"]):
    raise AssertionError(f"kernel launches in {DROP_TIMED} timed steps: {counts}, Newton {loops}")
  rate = BENCH_BATCH * DROP_TIMED / secs
  live = int((d.contact.dist < 0).any(dim=1).sum())
  shares, step_ms = _seam_shares(m, d, 2)
  busy, launches = _busy_share(lambda d: mjtpu_torch.step(m, d), d)
  log(f"[drop throughput] cylinder drop f32 B={BENCH_BATCH}: {DROP_WARMUP} warm-up and"
      f" {DROP_TIMED} timed steps in {secs:.3f} s = {rate:.0f} env-steps/s"
      f" ({1e3 * secs / DROP_TIMED:.3f} ms/step); qpos finite, nreset 0; per step: B3 shared"
      f" {counts['sat_winners'] // DROP_TIMED} launch, B1 register"
      f" {counts['chol_solve'] / DROP_TIMED:.2f} launches (n=6), Newton"
      f" {loops['iterations'] / DROP_TIMED:.2f} iterations and"
      f" {loops['ls_rounds'] / DROP_TIMED:.2f} linesearch rounds; envs in contact after the"
      f" last step {live} of {BENCH_BATCH}; device step {step_ms:.3f} ms, of it B3"
      f" {shares['sat_winners']:.4f} ms ({100 * shares['sat_winners'] / step_ms:.2f}%), B1"
      f" {shares['chol_solve']:.4f} ms ({100 * shares['chol_solve'] / step_ms:.2f}%); one"
      f" profiled step: {launches} kernel launches, device busy {100 * busy:.1f}% of its wall"
      f" time; card {card}")
  return counts


def _capture_hessians(advance):
  """(h, grad) of every call of B1's seam (fused.chol_solve) in
  ``advance()``: the Newton Hessians a step factors, its f32 regulariser
  and folded cone blocks included."""
  from mjtpu_torch.ops import fused

  seam, calls = fused.chol_solve, []

  def chol_solve(h, grad):
    calls.append((h.clone(), grad.clone()))
    return seam(h, grad)

  fused.chol_solve = chol_solve
  try:
    out = advance()
  finally:
    fused.chol_solve = seam
  return calls, out


def _hold_chol(h, grad, what) -> float:
  """Every B1 variant that runs n against the twin on captured Hessians
  (phase 3's tolerances), the variants equal bit for bit; the worst abs
  error of the size dispatch's variant."""
  import torch

  from mjtpu_torch.ops import cholesky

  n, dtype = h.shape[-1], h.dtype
  ref = cholesky.chol_solve_reference(h, grad)
  got = {kind: cholesky.cholesky_solve(h, grad, kernel=kind)
         for kind in cholesky.variants(n, dtype)}
  torch.cuda.synchronize()
  limit = 1e-10 if dtype == torch.float64 else 1e-4
  for kind, x in got.items():
    rel = float((x - ref).abs().max()) / max(float(ref.abs().max()), 1e-300)
    if not (bool(torch.isfinite(x).all()) and rel <= limit):
      raise AssertionError(f"{what}: {kind} kernel vs twin rel {rel:.3e} > {limit}")
  first = got[cholesky.variant(n, dtype)]
  for kind, x in got.items():
    if not torch.equal(_bits(x), _bits(first)):
      raise AssertionError(f"{what}: {kind} and {cholesky.variant(n, dtype)} kernels differ in"
                           f" {int((_bits(x) != _bits(first)).sum())} entries' bits")
  log(f"[elliptic] B1 on {what}: n={n} B={h.shape[0]} {str(dtype)[6:]}, variants"
      f" {sorted(got)} within {limit} of the twin (worst"
      f" {max(float((x - ref).abs().max()) for x in got.values()) / float(ref.abs().max()):.3e}"
      f" rel), equal bit for bit")
  return float((first - ref).abs().max())


def _elliptic_model(dtype, **opt):
  import mjtpu_torch

  ns = mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / f"{ELLIPTIC}_model.npz")
  for k, v in opt.items():
    setattr(ns.opt, k, v)
  return mjtpu_torch.model_from_arrays(ns, dtype=dtype, device="cuda")


def _restart_states(golden, prefix):
  """mjtpu's states before each step of the humanoid_bench_elliptic
  golden (steps x B rows, env-major within a step): qpos, qvel,
  qacc_warmstart, ctrl."""
  import numpy as np

  steps, batch = golden[f"{prefix}qpos"].shape[:2]
  before = lambda first, rest: np.concatenate([first[None], rest[:-1]]).reshape(
      (steps * batch,) + rest.shape[2:])
  return {"qpos": before(golden["qpos0"], golden[f"{prefix}qpos"]),
          "qvel": before(golden["qvel0"], golden[f"{prefix}qvel"]),
          "qacc_warmstart": before(np.zeros_like(golden[f"{prefix}warm"][0]),
                                   golden[f"{prefix}warm"]),
          "ctrl": np.tile(golden["ctrl"], (steps, 1))}


def _step_states(m, state):
  """One port step from the numpy states ``state`` on m's device: (qpos, qvel)."""
  import torch

  import mjtpu_torch

  d = mjtpu_torch.make_data(m, batch_size=len(state["qpos"]))
  d = mjtpu_torch.step(m, mjtpu_torch.replace(
      d, **{k: torch.as_tensor(v, device=m.device) for k, v in state.items()}))
  return d.qpos.cpu().numpy(), d.qvel.cpu().numpy()


def _ulp_copies(state, rows):
  """ELLIPTIC_TIE_COPIES copies of each state ``rows``, qpos and qvel
  moved by 1-3 ULP (numpy seed 0)."""
  import numpy as np

  rng = np.random.default_rng(0)
  copies = {k: v[np.repeat(rows, ELLIPTIC_TIE_COPIES)] for k, v in state.items()}
  for k in ("qpos", "qvel"):
    ulps = rng.choice([-1.0, 1.0], copies[k].shape) * rng.integers(1, 4, copies[k].shape)
    copies[k] = copies[k] * (1 + ulps * 2.0 ** -52)
  return copies


def _rows_err(got, want, rows):
  """Each row's max abs error of (qpos, qvel) ``got`` against ``want[rows]``."""
  import numpy as np

  return np.maximum(*(np.abs(g - w[rows]).max(1) for g, w in zip(got, want)))


def elliptic_restarts(m, golden, prefix=""):
  """One port step from each of mjtpu's states before a step of the
  humanoid_bench_elliptic golden (100 steps x 4 envs, one batch, on m's
  device) against mjtpu's next state from its batched run (the golden's)
  and from its one-env compile (``solo_*``).  A restart that parts from
  both by more than 1e-8 is a tie (ROADMAP C7: the sign of a phi' that is
  zero but for rounding, or where the converged solve stalls) only if a
  state a few ULP away takes mjtpu's path: it is stepped again from
  ELLIPTIC_TIE_COPIES copies of its state (_ulp_copies).  Returns ((steps,
  B) errors to the batched run, the restarts past 1e-8 of both, those of
  them that no copy brings within 1e-8, mjtpu's own solo-vs-batched
  splits, B1's captures of the step)."""
  import numpy as np

  steps, batch = golden[f"{prefix}qpos"].shape[:2]
  state = _restart_states(golden, prefix)
  want = [tuple(golden[f"{prefix}{run}{f}"].reshape(steps * batch, -1) for f in ("qpos", "qvel"))
          for run in ("", "solo_")]
  calls, got = _capture_hessians(lambda: _step_states(m, state))
  rows = np.arange(steps * batch)
  batched, solo = (_rows_err(got, w, rows) for w in want)
  splits = np.flatnonzero(np.minimum(batched, solo) > 1e-8)
  unexplained = splits
  if len(splits):
    rows = np.repeat(splits, ELLIPTIC_TIE_COPIES)
    copies = _step_states(m, _ulp_copies(state, splits))
    near = np.minimum(*(_rows_err(copies, w, rows) for w in want))
    unexplained = splits[~(near <= 1e-8).reshape(len(splits), -1).any(1)]
  own = _rows_err(want[1], want[0], np.arange(steps * batch))
  return (batched.reshape(steps, batch), splits, unexplained, int((own > 1e-8).sum()), calls)


def _cone_scene_run(m, golden, name, steps):
  """The cone scene's first ``steps`` steps from its golden's initial
  states: step 1's Data, the worst scaled error of each trajectory field,
  the Hessians of step 1 and the B1 launches and Newton iterations of the
  run."""
  import numpy as np
  import torch

  import mjtpu_torch
  from mjtpu_torch._src import solver
  from mjtpu_torch.ops import cholesky

  d = mjtpu_torch.make_data(m, batch_size=golden[f"{name}.qpos0"].shape[0])
  d = mjtpu_torch.replace(d, **{k: torch.as_tensor(golden[f"{name}.{k}0"], device="cuda")
                                for k in ("qpos", "qvel", "qfrc_applied")
                                if f"{name}.{k}0" in golden})
  fields = ("qpos", "qvel") + (("sensordata",) if m.nsensordata else ())
  err = dict.fromkeys(fields, 0.0)
  cholesky.launches, iterations = 0, solver.loop_counts["iterations"]
  for i in range(steps):
    if i == 0:
      calls, d = _capture_hessians(lambda: mjtpu_torch.step(m, d))
      first = mjtpu_torch.data_to_numpy(d)
    else:
      d = mjtpu_torch.step(m, d)
    for f in fields:
      want = golden[f"{name}.{f}"][i]
      scale = np.maximum(1.0, np.abs(golden[f"{name}.{f}"]).max(axis=(0, 1))) if (
          f == "sensordata") else 1.0
      err[f] = max(err[f], float((np.abs(getattr(d, f).cpu().numpy() - want) / scale).max()))
  if int(d.nreset.sum()):
    raise AssertionError(f"{name}: nreset {int(d.nreset.sum())}")
  return first, err, calls, cholesky.launches, solver.loop_counts["iterations"] - iterations


def phase_elliptic_parity():
  import numpy as np
  import torch

  import mjtpu_torch
  from mjtpu_torch._src import solver
  from mjtpu_torch.ops import cholesky

  golden = dict(np.load(mjtpu_torch.ASSETS / f"{ELLIPTIC}_golden.npz"))
  err_of = lambda qpos, qvel, prefix: np.maximum(np.abs(qpos - golden[f"{prefix}qpos"]).max(2),
                                                 np.abs(qvel - golden[f"{prefix}qvel"]).max(2))

  def restarts(m, prefix, what):
    err, splits, unexplained, own, calls = elliptic_restarts(m, golden, prefix)
    log(f"[elliptic parity] {what}, 400 one-step restarts from mjtpu's states: past 1e-8 of its"
        f" batched run {int((err > 1e-8).sum())}, of its batched and its solo runs {len(splits)},"
        f" each a tie ({ELLIPTIC_TIE_COPIES} copies a few ULP away: a copy takes mjtpu's path),"
        f" unexplained {len(unexplained)}; mjtpu's own solo-vs-batched splits {own}")
    if len(unexplained):
      raise AssertionError(f"{what}: restarts {unexplained.tolist()} off mjtpu's paths")
    return err, calls

  # the solver run to convergence (iterations = ls_iterations = 10)
  conv = dict(iterations=int(golden["converged_iterations"]),
              ls_iterations=int(golden["converged_ls_iterations"]))
  mc = _elliptic_model(torch.float64, **conv)
  _zero_counts()
  before = solver.loop_counts["iterations"]
  qpos, qvel, _, d = _golden_run(mc, golden, PARITY_STEPS)
  iterations = solver.loop_counts["iterations"] - before
  kinds = dict(cholesky.variant_launches)
  if not cholesky.launches == iterations == kinds["register"] or int(d.nreset.sum()):
    raise AssertionError(f"converged: {kinds} B1 launches, {iterations} Newton iterations,"
                         f" nreset {int(d.nreset.sum())}")
  restarts(mc, "conv_", "converged solver")
  # held to 1e-8 until mjtpu's two runs part, then to its own spread
  own = err_of(golden["conv_solo_run_qpos"], golden["conv_solo_run_qvel"], "conv_")
  parted = (own > 1e-8).any(1)
  head = int(parted.argmax()) if parted.any() else PARITY_STEPS
  err = err_of(qpos, qvel, "conv_")
  near = min(float(err.max()), float(err_of(qpos, qvel, "conv_solo_run_").max()))
  limit = ELLIPTIC_DRIFT_FACTOR * float(own.max())
  log(f"[elliptic parity] {ELLIPTIC} converged solver ({conv}), {PARITY_STEPS} steps B=4 f64:"
      f" max abs err {err[:head].max():.3e} through step {head} (limit 1e-8: mjtpu's own runs"
      f" part at step {head + 1}), {near:.3e} over {PARITY_STEPS} to the nearer of mjtpu's two"
      f" (limit {limit:.3e}: {ELLIPTIC_DRIFT_FACTOR} x their spread); {iterations / PARITY_STEPS:.2f}"
      f" Newton iterations and B1 launches (register, n=27) per step")
  if not (head >= 1 and err[:head].max() <= 1e-8 and near <= limit):
    raise AssertionError(f"converged elliptic run differs from mjtpu: {err[:head].max():.3e}"
                         f" through step {head}, {near:.3e} over {PARITY_STEPS}")

  # the benchmark configuration (iterations=1, ls_iterations=4)
  m = _elliptic_model(torch.float64)
  _zero_counts()
  qpos, qvel, first, d = _golden_run(m, golden, PARITY_STEPS)
  kinds = dict(cholesky.variant_launches)
  if kinds != {"register": PARITY_STEPS, "shared": 0}:
    raise AssertionError(f"benchmark config: B1 launches {kinds} in {PARITY_STEPS} steps")
  _step_one(first, golden, "elliptic parity")
  if not (np.isfinite(qpos).all() and np.isfinite(qvel).all()) or int(d.nreset.sum()):
    raise AssertionError("benchmark-config elliptic trajectory not finite or reset")
  _, calls = restarts(m, "", "benchmark config")
  err = err_of(qpos, qvel, "")
  head = float(err[:ELLIPTIC_HEAD_STEPS].max())
  log(f"[elliptic parity] benchmark config, {PARITY_STEPS} steps B=4 f64: max abs err"
      f" {head:.3e} through step {ELLIPTIC_HEAD_STEPS} (limit 1e-8; step {ELLIPTIC_HEAD_STEPS + 1}'s"
      f" restarts are ties), {float(err.max()):.3e} over {PARITY_STEPS}; B1 launches {kinds}")
  if not head <= 1e-8:
    raise AssertionError(f"benchmark-config elliptic run differs from mjtpu: {head:.3e} through"
                         f" step {ELLIPTIC_HEAD_STEPS}")
  (h, grad), = calls
  return _hold_chol(h, grad, f"{ELLIPTIC}'s Newton Hessians (the 400 restarts)")


def phase_cone_parity(half: int):
  """Phase 22's cone and frictionloss scenes at f64 against their golden,
  every other scene of the bundle from ``half`` (0 or 1: two side
  processes), and B1 against its twin on elliptic.xml's Hessians in the
  half that steps it."""
  import numpy as np
  import torch

  import mjtpu_torch
  from mjtpu_torch._src import io

  bundle = mjtpu_torch.ASSETS / "cone_scenes.npz"
  scenes = dict(np.load(mjtpu_torch.ASSETS / "cone_scenes_golden.npz"))
  hessians = None
  for name in io.bundle_names(bundle)[half::2]:
    m = mjtpu_torch.model_from_arrays(io.load_snapshot(bundle, name), dtype=torch.float64,
                                      device="cuda")
    fuzz = name.startswith("fuzz_")
    steps = CONE_FUZZ_STEPS if fuzz else PARITY_STEPS
    first, err, calls, launches, iterations = _cone_scene_run(m, scenes, name, steps)
    stage = {f: _scaled_err(getattr(first, f), scenes[f"{name}.fwd.{f}"])
             for f in ("efc_J", "efc_D", "efc_aref", "efc_frictionloss", "efc_pos")}
    # the solve's qacc (Euler's damping solve changes the step's qacc)
    stage["qacc"] = _scaled_err(first.qacc_warmstart, scenes[f"{name}.fwd.qacc"])
    stage["efc_force"] = _scaled_err(first.efc_force, scenes[f"{name}.fwd.efc_force"])
    newton = m.opt.solver == mjtpu_torch.SolverType.NEWTON
    # Euler's implicit damping solves through B1 once a step (a dense tree)
    damping = (m.opt.integrator == mjtpu_torch.IntegratorType.EULER and m.has_dof_damping
               and not m.opt.disableflags & (mjtpu_torch.DisableBit.EULERDAMP
                                             | mjtpu_torch.DisableBit.DAMPER))
    want = (iterations if newton else 0) + (steps if damping else 0)
    bound = CONE_TRAJECTORY_BOUND
    log(f"[elliptic parity] {name} (cone {int(m.opt.cone)}, nefc"
        f" {mjtpu_torch.count_constraints(m)[3]}), {steps} steps B=4 f64: step 1"
        f" {', '.join(f'{k} {v:.1e}' for k, v in stage.items())} of scale; trajectory"
        f" {', '.join(f'{k} {v:.3e}' for k, v in err.items())} (limit {bound}); B1 launches"
        f" {launches} (Newton iterations {iterations if newton else 0}"
        f"{', and the damping solve once a step' if damping else ''})")
    solve_bound = CONE_FUZZ_SOLVE_BOUND if fuzz else CONE_BOUND
    if not (max(v for k, v in stage.items() if k not in ("qacc", "efc_force")) <= CONE_BOUND
            and max(stage["qacc"], stage["efc_force"]) <= solve_bound
            and max(err.values()) <= bound):
      raise AssertionError(f"{name} differs from mjtpu: step 1 {stage}, trajectory {err}")
    if launches != want:
      raise AssertionError(f"{name}: {launches} B1 launches, {iterations} Newton iterations")
    if name == "elliptic":
      hessians = calls[0]
  if hessians is not None:
    # n=12: the register kernel, and the shared one beside it
    _hold_chol(*hessians, "elliptic.xml's first Newton Hessians (two trees, dense)")
    _hold_chol(hessians[0].float(), hessians[1].float(), "elliptic.xml's Hessians cast to f32")


def phase_elliptic_throughput(card, bench):
  """The elliptic bench at f32 B=4096 (bench.py's start: qpos0 +-0.01,
  numpy seed 1), with the pyramidal bench of phase 6 (``bench``: its
  env-steps/s and ms/step) beside it."""
  import torch

  import mjtpu_torch
  from mjtpu_torch.ops import cholesky

  m = _elliptic_model(torch.float32)
  d = _f32_start(m)
  # one warm-up step's Newton Hessians (f32, regularised, cones folded)
  calls, d = _capture_hessians(lambda: mjtpu_torch.step(m, d))
  d, secs, counts, loops = _timed_main_path(m, d, WARMUP_STEPS - 1, TIMED_STEPS)
  if counts != _only(chol_solve=TIMED_STEPS) or loops["iterations"] != TIMED_STEPS:
    raise AssertionError(f"kernel launches in {TIMED_STEPS} timed steps: {counts}, {loops}")
  rate = BENCH_BATCH * TIMED_STEPS / secs
  shares, step_ms = _seam_shares(m, d, WARMUP_STEPS)
  if shares["chol_ns"] != {27}:
    raise AssertionError(f"Cholesky launches at n={shares['chol_ns']}, not 27")
  live = int((d.contact.dist < 0).sum())
  busy, launches = _busy_share(lambda d: mjtpu_torch.step(m, d), d)
  # humanoid_bench's pyramidal cones, one step past the same start
  pyr = _elliptic_model(torch.float32, cone=0)
  pyr_busy, pyr_launches = _busy_share(lambda d: mjtpu_torch.step(pyr, d),
                                       mjtpu_torch.step(pyr, _f32_start(pyr)))
  log(f"[elliptic throughput] {ELLIPTIC} f32 B={BENCH_BATCH}: {TIMED_STEPS} steps in"
      f" {secs:.3f} s = {rate:.0f} env-steps/s ({1e3 * secs / TIMED_STEPS:.3f} ms/step), beside"
      f" the pyramidal humanoid_bench of phase 6 in this call: {bench[0]:.0f} env-steps/s"
      f" ({bench[1]:.3f} ms/step); per step: B1 register {counts['chol_solve'] // TIMED_STEPS}"
      f" launch (n=27), Newton {loops['iterations'] / TIMED_STEPS:.2f} iterations and"
      f" {loops['ls_rounds'] / TIMED_STEPS:.2f} linesearch rounds; live contacts after the last"
      f" step {live}; qpos finite, nreset 0; device step {step_ms:.3f} ms, of it B1"
      f" {shares['chol_solve']:.4f} ms ({100 * shares['chol_solve'] / step_ms:.2f}%); one"
      f" profiled step: {launches} kernel launches (pyramidal: {pyr_launches}), device busy"
      f" {100 * busy:.1f}% (pyramidal: {100 * pyr_busy:.1f}%); card {card}")
  (h, grad), = calls
  err = _hold_chol(h, grad, f"{ELLIPTIC}'s f32 Newton Hessians (B={BENCH_BATCH})")
  run = lambda: cholesky.cholesky_solve(h, grad)
  run_p = lambda: cholesky.chol_solve_reference(h, grad)
  lib = lambda: torch.cholesky_solve(grad[..., None], torch.linalg.cholesky_ex(h).L)[..., 0]
  k1, p1, l1 = cuda_ms(run), cuda_ms(run_p, PLAIN_REPS), cuda_ms(lib, PLAIN_REPS)
  k2, p2 = cuda_ms(run), cuda_ms(run_p, PLAIN_REPS)
  b_ms, b_by = bound(*_chol_work(27, BENCH_BATCH, h.element_size()), h.dtype)
  log(f"[elliptic throughput] B1 register on those Hessians: {k1:.4f} / {k2:.4f} ms, plain twin"
      f" {p1:.4f} / {p2:.4f} ms, torch.cholesky_solve(cholesky_ex) {l1:.4f} ms, bound"
      f" {b_ms:.5f} ms ({b_by}) {TIMING}")
  timed = {"ms": min(k1, k2), "plain_ms": min(p1, p2), "library_ms": l1, "bound_ms": b_ms,
           "max_abs_err": err}
  return counts, timed


def phase_fluid_parity():
  """The fluid scenes, the swimmer and satellite envs and the
  constraint-free ant_bench at f64 on the card (phase 24)."""
  import numpy as np
  import torch

  import mjtpu_torch
  from mjtpu_torch._src import io
  from mjtpu_torch._src.types import DisableBit, SensorType

  scenes = mjtpu_torch.ASSETS / "fluid_scenes.npz"
  golden = dict(np.load(mjtpu_torch.ASSETS / "fluid_scenes_golden.npz"))
  forces, traj = {}, {}
  for name in io.bundle_names(scenes):
    m = mjtpu_torch.model_from_arrays(io.load_snapshot(scenes, name), device="cuda")
    d = mjtpu_torch.make_data(m, batch_size=golden[f"{name}.qpos0"].shape[0])
    d = mjtpu_torch.replace(d, **{k: torch.as_tensor(golden[f"{name}.{k}0"], device="cuda")
                                  for k in ("qpos", "qvel", "ctrl")})
    fwd = mjtpu_torch.forward(m, d)
    forces[name] = max(_scaled_err(getattr(fwd, f).cpu().numpy(), golden[f"{name}.fwd.{f}"])
                       for f in FLUID_FORCES)
    err = 0.0
    for t in range(golden[f"{name}.qpos"].shape[0]):
      d = mjtpu_torch.step(m, d)
      for f in ("qpos", "qvel"):
        err = max(err, float(np.abs(getattr(d, f).cpu().numpy() - golden[f"{name}.{f}"][t]).max()))
    traj[name] = err
    if not (forces[name] <= FLUID_FORCE_BOUND and err <= FLUID_TRAJECTORY_BOUND):
      raise AssertionError(f"fluid scene {name}: step-1 forces {forces[name]:.3e} of scale,"
                           f" trajectory {err:.3e}")
  log(f"[fluid parity] {len(forces)} fluid scenes f64 B=4: step 1's "
      f"{', '.join(FLUID_FORCES)}, max err of scale "
      + ", ".join(f"{k} {v:.3e}" for k, v in forces.items())
      + f" (limit {FLUID_FORCE_BOUND}); 100 steps max abs err "
      + ", ".join(f"{k} {v:.3e}" for k, v in traj.items())
      + f" (limit {FLUID_TRAJECTORY_BOUND})")

  env_golden = dict(np.load(mjtpu_torch.ASSETS / "swimmer_satellite_env_golden.npz"))
  worst = {name: _env_golden_err(name, env_golden) for name in SATELLITE_ENVS}
  log(f"[fluid parity] {', '.join(SATELLITE_ENVS)} f64 B=4, 3 env steps through"
      f" mjtpu_torch.zoo.ENVS: max abs err of obs and reward "
      + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
      + f" (limit {ENV_BOUND}); done and steps equal to mjtpu's env")

  # ROADMAP C8: ant_bench with the constraints disabled has no contact
  # force to read; every touch reading is 0 (MuJoCo C: no contact at all)
  ant = dict(np.load(mjtpu_torch.ASSETS / "ant_bench_golden.npz"))
  ns = mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / "ant_bench_model.npz")
  ns.opt.disableflags = int(ns.opt.disableflags) | int(DisableBit.CONSTRAINT)
  m = mjtpu_torch.model_from_arrays(ns, dtype=torch.float64, device="cuda")
  touch = [a for t, a in zip(m.sensor_type, m.sensor_adr) if t == SensorType.TOUCH]
  d = mjtpu_torch.make_data(m, batch_size=ant["qpos0"].shape[0])
  d = mjtpu_torch.replace(d, qpos=torch.as_tensor(ant["qpos0"], device="cuda"),
                          qvel=torch.as_tensor(ant["qvel0"], device="cuda"),
                          ctrl=torch.as_tensor(ant["ctrl"], device="cuda"))
  for t in range(C8_STEPS):
    d = mjtpu_torch.step(m, d)
    if d.sensordata[:, touch].any() or not bool(torch.isfinite(d.sensordata).all()):
      raise AssertionError(f"ant_bench without constraints, step {t + 1}: touch"
                           f" {d.sensordata[:, touch].tolist()}")
  log(f"[fluid parity] ant_bench with DisableBit.CONSTRAINT (ROADMAP C8) f64 B=4:"
      f" {C8_STEPS} steps, sensordata finite, all {len(touch)} touch readings 0 in every step")


def tendon_scene(name, golden, device):
  """(Model, Data) at f64 of a tendon scene (tendon_scenes.npz) at its
  golden's start, on ``device``."""
  import torch

  import mjtpu_torch
  from mjtpu_torch._src import io

  m = mjtpu_torch.model_from_arrays(
      io.load_snapshot(mjtpu_torch.ASSETS / "tendon_scenes.npz", name), device=device)
  d = mjtpu_torch.make_data(m, batch_size=golden[f"{name}.qpos0"].shape[0])
  start = {k: torch.as_tensor(golden[f"{name}.{k}0"], dtype=m.dtype, device=device)
           for k in ("qpos", "qvel", "ctrl", "act") if f"{name}.{k}0" in golden}
  return m, mjtpu_torch.replace(d, **start)


def tendon_scene_errors(name, golden, device, steps=None) -> dict:
  """A tendon scene's errors against its golden (tests/test_torch_tendon.py
  and phase 26 share it), each over its bound's scale: "pose.<field>" the
  tendons at the wrap scenes' seeded poses (fwd_position), of max(1, max
  |mjtpu's|), and "pose.flags" the wrap flags that differ (a count);
  "force.<field>" step 1's actuation and passive forces and "efc.<field>"
  its efc rows, of scale; "trajectory.<field>" qpos, qvel and act over
  ``steps`` (default all) steps, absolute, and sensordata of each
  sensor's scale."""
  import numpy as np
  import torch

  import mjtpu_torch

  m, d = tendon_scene(name, golden, device)
  out = {}
  if f"{name}.poses.qpos" in golden:
    poses = golden[f"{name}.poses.qpos"]
    dp = mjtpu_torch.make_data(m, batch_size=poses.shape[0])
    dp = mjtpu_torch.fwd_position(m, mjtpu_torch.replace(
        dp, qpos=torch.as_tensor(poses, device=device)))
    for f in TENDON_POSE_FIELDS:
      out[f"pose.{f}"] = _scaled_err(getattr(dp, f).cpu().numpy(), golden[f"{name}.poses.{f}"])
    out["pose.flags"] = int((dp.ten_wrap_active.cpu().numpy()
                             != golden[f"{name}.poses.ten_wrap_active"]).sum())
  fwd = mjtpu_torch.forward(m, d)
  for group, fields in (("force", TENDON_FORCES), ("efc", TENDON_EFC)):
    for f in fields:
      want = golden[f"{name}.fwd.{f}"]
      out[f"{group}.{f}"] = _scaled_err(getattr(fwd, f).cpu().numpy(), want) if want.size else 0.0
  fields = [f for f in ("qpos", "qvel", "act", "sensordata") if f"{name}.{f}" in golden]
  if "sensordata" in fields:
    scale = _sensor_scale(m, {"sensordata": golden[f"{name}.sensordata"]})
  err = dict.fromkeys(fields, 0.0)
  for t in range(steps or golden[f"{name}.qpos"].shape[0]):
    d = mjtpu_torch.step(m, d)
    for f in fields:
      e = np.abs(getattr(d, f).cpu().numpy() - golden[f"{name}.{f}"][t])
      err[f] = max(err[f], float((e / scale if f == "sensordata" else e).max(initial=0.0)))
  out.update({f"trajectory.{f}": v for f, v in err.items()})
  return out


def tendon_bound(key: str) -> float:
  """The bound of a tendon_scene_errors entry."""
  return {"pose": TENDON_POSE_BOUND, "force": TENDON_FORCE_BOUND, "efc": TENDON_EFC_BOUND,
          "trajectory": TENDON_TRAJECTORY_BOUND}[key.split(".")[0]] if key != "pose.flags" else 0


def _damping_solves(m) -> int:
  """B1 launches a step besides Newton's: one where Euler's implicit
  damping solves one dense tree (smooth.factor_solve through
  fused.chol_solve), else none."""
  from mjtpu_torch._src import smooth, sparse
  from mjtpu_torch._src.types import DisableBit, IntegratorType

  return int(m.has_dof_damping and m.opt.integrator == IntegratorType.EULER
             and not m.opt.disableflags & (DisableBit.EULERDAMP | DisableBit.DAMPER)
             and smooth.mass_blocks(m) is None and sparse.tables(m) is None)


def phase_tendon_parity():
  """Every scene of tendon_scenes.npz at f64 on the card against its
  mjtpu golden, at the CPU test's bounds (phase 26); one B1 launch per
  Newton iteration (and one a step for a dense tree's Euler damping)."""
  import numpy as np

  import mjtpu_torch
  from mjtpu_torch._src import io, solver
  from mjtpu_torch.ops import cholesky

  golden = dict(np.load(mjtpu_torch.ASSETS / "tendon_scenes_golden.npz"))
  names = io.bundle_names(mjtpu_torch.ASSETS / "tendon_scenes.npz")
  worst, kinds = {}, dict.fromkeys(cholesky.variant_launches, 0)
  for name in names:
    m, _ = tendon_scene(name, golden, "cpu")
    before, newton = dict(cholesky.variant_launches), solver.loop_counts["iterations"]
    errs = tendon_scene_errors(name, golden, "cuda")
    steps = golden[f"{name}.qpos"].shape[0]
    launched = {k: cholesky.variant_launches[k] - before[k] for k in before}
    # Newton's iterations in step 1's forward and in the steps, and each
    # step's damping solve (the poses' fwd_position solves nothing)
    want = solver.loop_counts["iterations"] - newton + steps * _damping_solves(m)
    if sum(launched.values()) != want:
      raise AssertionError(f"tendon scene {name}: B1 launches {launched}, want {want}")
    bad = {k: v for k, v in errs.items() if v > tendon_bound(k)}
    if bad:
      raise AssertionError(f"tendon scene {name} f64 on the card: {bad}")
    for k, v in launched.items():
      kinds[k] += v
    for k, v in errs.items():
      group = k.split(".")[0]
      worst[group] = max(worst.get(group, 0.0), v if k != "pose.flags" else 0.0)
  log(f"[tendon parity] {len(names)} tendon scenes f64 B=4 (tendon_scenes.npz): max err, pose"
      f" tendons {worst['pose']:.3e} of scale (limit {TENDON_POSE_BOUND}, wrap flags equal),"
      f" step 1's {', '.join(TENDON_FORCES)} {worst['force']:.3e} of scale (limit"
      f" {TENDON_FORCE_BOUND}), efc rows {worst['efc']:.3e} (limit {TENDON_EFC_BOUND}), 100 steps"
      f" {worst['trajectory']:.3e} (limit {TENDON_TRAJECTORY_BOUND}); B1 launches {kinds}, one per"
      " Newton iteration and one a step for a dense tree's Euler damping")


def _tendon_path(name, timed, card, profile):
  """A tendon scene at f32 B=4096 from the bundle's snapshot, qpos0
  +-0.01 and ctrl in [-1, 1] (numpy seed 1): TENDON_WARMUP warm-up and
  ``timed`` timed steps as a main path (B1 register only); its line, and
  its counts."""
  import torch

  import mjtpu_torch
  from mjtpu_torch._src import io

  m = mjtpu_torch.model_from_arrays(
      io.load_snapshot(mjtpu_torch.ASSETS / "tendon_scenes.npz", name), dtype=torch.float32,
      device="cuda")
  d, secs, counts, loops = _timed_main_path(m, _f32_start(m), TENDON_WARMUP, timed)
  damping = timed * _damping_solves(m)
  if counts != _only(chol_solve=loops["iterations"] + damping):
    raise AssertionError(f"{name}: kernel launches in {timed} timed steps: {counts}, Newton"
                         f" {loops}, damping solves {damping}")
  rate = BENCH_BATCH * timed / secs
  shares, step_ms = _seam_shares(m, d, 2)
  if shares["chol_ns"] != {m.nv}:
    raise AssertionError(f"{name}: B1 took n in {shares['chol_ns']}, not {m.nv}")
  line = (f"f32 B={BENCH_BATCH} (nv={m.nv}, ntendon={m.ntendon}, na={m.na}, nefc"
          f" {mjtpu_torch.count_constraints(m)[3]}): {TENDON_WARMUP} warm-up and {timed} timed"
          f" steps in {secs:.3f} s = {rate:.0f} env-steps/s ({1e3 * secs / timed:.3f} ms/step);"
          f" qpos finite, nreset 0; per step: B1 register {counts['chol_solve'] / timed:.2f}"
          f" launches (n={m.nv}; Newton {loops['iterations'] / timed:.2f} iterations and"
          f" {loops['ls_rounds'] / timed:.2f} linesearch rounds, Euler damping solves"
          f" {damping / timed:.0f}); device step {step_ms:.3f} ms, of it B1"
          f" {shares['chol_solve']:.4f} ms ({100 * shares['chol_solve'] / step_ms:.2f}%)")
  if profile:
    busy, launches = _busy_share(lambda d: mjtpu_torch.step(m, d), d)
    line += (f"; one profiled step: {launches} kernel launches, device busy {100 * busy:.1f}%"
             " of its wall time")
  return f"{line}; card {card}", counts


def equality_scene(name, golden, device):
  """(Model, Data) at f64 of an equality scene (equality_scenes.npz) at its
  golden's start, on ``device``."""
  import torch

  import mjtpu_torch
  from mjtpu_torch._src import io

  m = mjtpu_torch.model_from_arrays(
      io.load_snapshot(mjtpu_torch.ASSETS / "equality_scenes.npz", name), device=device)
  d = mjtpu_torch.make_data(m, batch_size=golden[f"{name}.qpos0"].shape[0])
  start = {k: torch.as_tensor(golden[f"{name}.{k}0"], device=device)
           for k in ("qpos", "qvel", "ctrl", "act", "eq_active") if f"{name}.{k}0" in golden}
  return m, mjtpu_torch.replace(d, **start)


def _mocap_at(d, golden, name, t):
  """``d`` with the golden's mocap targets of step t + 1 (a scene without
  mocap bodies: ``d``)."""
  import torch

  import mjtpu_torch

  if f"{name}.mocap_pos" not in golden:
    return d
  at = lambda k: torch.as_tensor(golden[f"{name}.{k}"][t], device=d.qpos.device)
  return mjtpu_torch.replace(d, mocap_pos=at("mocap_pos"), mocap_quat=at("mocap_quat"))


def equality_scene_errors(name, golden, device, steps=None) -> dict:
  """An equality scene's errors against its golden (tests/test_torch_equality.py
  and phase 28 share it), each over its bound's scale: "pose.<field>"
  every body's frame at step 1, of max(1, max |mjtpu's|); "efc.<field>"
  step 1's efc rows and "efc.labels" the static row labels that differ
  from mjtpu's (a count); "solve.<field>" step 1's qacc and efc_force;
  "cfrc.c" rne_postconstraint's cfrc_ext against MuJoCo C's, of scale,
  but for the world body's row, which C leaves at zero and the port gives
  mjtpu's contact wrench ("cfrc.world" against mjtpu's, ROADMAP C11);
  "trajectory.<field>" qpos, qvel and act over ``steps`` (default all)
  steps, absolute, and sensordata of each sensor's scale.  Also
  "cfrc.mjtpu", the port's cfrc_ext against mjtpu's (ROADMAP C11: not
  bounded where mjtpu parts from C)."""
  import numpy as np

  import mjtpu_torch
  from mjtpu_torch._src import smooth, support

  g = lambda f: golden[f"{name}.{f}"]
  host = lambda x: x.cpu().numpy()
  m, d = equality_scene(name, golden, device)
  fwd = mjtpu_torch.forward(m, _mocap_at(d, golden, name, 0))
  out = {f"pose.{f}": _scaled_err(host(getattr(fwd, f)), g(f"fwd.{f}")) for f in ("xpos", "xquat")}
  for f in EQ_EFC:
    want = g(f"fwd.{f}")
    out[f"efc.{f}"] = _scaled_err(host(getattr(fwd, f)), want) if want.size else 0.0
  types, ids = support.efc_row_meta(m)
  out["efc.labels"] = int((types != g("efc_type")).sum() + (ids != g("efc_id")).sum())
  out["solve.qacc"] = _scaled_err(host(fwd.qacc_warmstart), g("fwd.qacc"))
  want = g("fwd.efc_force")
  out["solve.efc_force"] = _scaled_err(host(fwd.efc_force), want) if want.size else 0.0
  cfrc = host(smooth.rne_postconstraint(m, fwd).cfrc_ext)
  out["cfrc.c"] = _scaled_err(cfrc[:, 1:], g("c.cfrc_ext")[:, 1:])
  out["cfrc.world"] = _scaled_err(cfrc[:, 0], g("rnepost.cfrc_ext")[:, 0])
  out["cfrc.mjtpu"] = _scaled_err(cfrc, g("rnepost.cfrc_ext"))
  fields = [f for f in ("qpos", "qvel", "act", "sensordata") if f"{name}.{f}" in golden]
  if "sensordata" in fields:
    scale = _sensor_scale(m, {"sensordata": g("sensordata")})
  err = dict.fromkeys(fields, 0.0)
  for t in range(g("qpos").shape[0]):
    d = mjtpu_torch.step(m, _mocap_at(d, golden, name, t))
    for f in fields:
      e = np.abs(host(getattr(d, f)) - g(f)[t])
      err[f] = max(err[f], float((e / scale if f == "sensordata" else e).max(initial=0.0)))
  out.update({f"trajectory.{f}": v for f, v in err.items()})
  return out


def equality_bound(key: str) -> float | None:
  """The bound of an equality_scene_errors entry (None: not bounded)."""
  if key in ("efc.labels", "cfrc.c", "cfrc.world", "cfrc.mjtpu"):
    return {"efc.labels": 0, "cfrc.c": EQ_CFRC_BOUND, "cfrc.world": EQ_CFRC_BOUND,
            "cfrc.mjtpu": None}[key]
  return {"pose": EQ_POSE_BOUND, "efc": EQ_EFC_BOUND, "solve": EQ_SOLVE_BOUND,
          "trajectory": EQ_TRAJECTORY_BOUND}[key.split(".")[0]]


def phase_equality_parity():
  """Every scene of equality_scenes.npz at f64 on the card against its
  mjtpu golden, at the CPU test's bounds (phase 28), and
  rne_postconstraint's cfrc_ext against MuJoCo C's; one B1 launch per
  Newton iteration (and one a step for a dense tree's Euler damping)."""
  import numpy as np

  import mjtpu_torch
  from mjtpu_torch._src import io, solver
  from mjtpu_torch.ops import cholesky

  golden = dict(np.load(mjtpu_torch.ASSETS / "equality_scenes_golden.npz"))
  names = io.bundle_names(mjtpu_torch.ASSETS / "equality_scenes.npz")
  worst, kinds = {}, dict.fromkeys(cholesky.variant_launches, 0)
  for name in names:
    m, _ = equality_scene(name, golden, "cpu")
    before, newton = dict(cholesky.variant_launches), solver.loop_counts["iterations"]
    errs = equality_scene_errors(name, golden, "cuda")
    steps = golden[f"{name}.qpos"].shape[0]
    launched = {k: cholesky.variant_launches[k] - before[k] for k in before}
    want = solver.loop_counts["iterations"] - newton + steps * _damping_solves(m)
    if sum(launched.values()) != want:
      raise AssertionError(f"equality scene {name}: B1 launches {launched}, want {want}")
    bad = {k: v for k, v in errs.items()
           if equality_bound(k) is not None and v > equality_bound(k)}
    if bad:
      raise AssertionError(f"equality scene {name} f64 on the card: {bad}")
    for k, v in launched.items():
      kinds[k] += v
    for k, v in errs.items():
      group = k if k.startswith("cfrc") else k.split(".")[0]
      worst[group] = max(worst.get(group, 0.0), v)
  log(f"[equality parity] {len(names)} equality scenes f64 B=4 (equality_scenes.npz): max err,"
      f" every body's frame {worst['pose']:.3e} of scale (limit {EQ_POSE_BOUND}), step 1's efc"
      f" rows {worst['efc']:.3e} (limit {EQ_EFC_BOUND}, row labels equal), qacc and efc_force"
      f" {worst['solve']:.3e} (limit {EQ_SOLVE_BOUND}), cfrc_ext against MuJoCo C"
      f" {worst['cfrc.c']:.3e} (limit {EQ_CFRC_BOUND}; the world body's row against mjtpu"
      f" {worst['cfrc.world']:.3e}, every row {worst['cfrc.mjtpu']:.3e}, ROADMAP C11), 100 steps {worst['trajectory']:.3e} (limit {EQ_TRAJECTORY_BOUND}); B1"
      f" launches {kinds}, one per Newton iteration and one a step for a dense tree's Euler"
      " damping")


def slice14_scene(kind, name, golden, device, dtype=None):
  """(Model, Data) at the golden's start of a scene of the Implicit slice:
  ``kind`` "implicit" or "sensor" (a scene of implicit_scenes.npz or
  sensor_scenes.npz, its golden's entries under "<name>.") or
  "humanoid_implicit" (humanoid_implicit_model.npz, its golden's entries
  unprefixed), on ``device`` at ``dtype`` (default float64)."""
  import torch

  import mjtpu_torch
  from mjtpu_torch._src import io

  if kind == "humanoid_implicit":
    ns, prefix = io.load_snapshot(mjtpu_torch.ASSETS / "humanoid_implicit_model.npz"), ""
  else:
    ns = io.load_snapshot(mjtpu_torch.ASSETS / f"{SLICE14_BUNDLES[kind]}.npz", name)
    prefix = f"{name}."
  m = mjtpu_torch.model_from_arrays(ns, dtype=dtype or torch.float64, device=device)
  d = mjtpu_torch.make_data(m, batch_size=golden[f"{prefix}qpos0"].shape[0])
  start = {k: torch.as_tensor(golden[f"{prefix}{k}0"], dtype=m.dtype, device=device)
           for k in ("qpos", "qvel", "ctrl") if f"{prefix}{k}0" in golden}
  return m, mjtpu_torch.replace(d, **start)


def golden_fwd(golden, prefix=""):
  """mjtpu's forward Data of step 1 from a golden's "fwd." fields, as
  data_from_mjtpu takes it (numpy leaves under the port's field names)."""
  import types

  head = prefix + "fwd."
  fields = {k[len(head):]: v for k, v in golden.items() if k.startswith(head)}
  ns = types.SimpleNamespace(**{k: v for k, v in fields.items() if not k.startswith("contact.")})
  ns.contact = types.SimpleNamespace(
      **{k[8:]: v for k, v in fields.items() if k.startswith("contact.")})
  return ns


def found_columns(m):
  """The sensordata columns of every CONTACT sensor's ``found`` field."""
  import numpy as np

  from mjtpu_torch._src import sensor
  from mjtpu_torch._src.types import SensorType

  cols = []
  for i in np.nonzero(np.asarray(m.sensor_type) == SensorType.CONTACT)[0]:
    dataspec, _, num = (int(x) for x in np.asarray(m.sensor_intprm)[i])
    if dataspec & 1:
      slotdim = sum(w for bit, _, w in sensor._CONTACT_FIELDS if dataspec & bit)
      cols += [int(m.sensor_adr[i]) + s * slotdim for s in range(num)]
  return np.asarray(cols, dtype=np.int64)


def slice14_errors(kind, name, golden, device) -> dict:
  """A scene's errors against its golden (the CPU tests and phase 30 share
  it), each over its bound's scale, max(1, max |mjtpu's|): "deriv" step
  1's qDeriv (deriv_smooth_vel, rne under Implicit) and "deriv.fluid" its
  fluid term alone, from mjtpu's forward Data; "update.<field>" the
  implicit integrator's qpos and qvel from mjtpu's forward Data, absolute;
  "fwd.<field>" the port's forward's qacc, energy and sensordata (of each
  sensor's scale); "trajectory.<field>" qpos and qvel over the golden's
  steps, absolute, sensordata of each sensor's scale and
  energy of scale, a step whose sensordata parts from mjtpu's in an env
  held only where one of ELLIPTIC_TIE_COPIES copies of that env's state
  a few ULP away takes mjtpu's path (a tie: "ties" counts them); "found"
  the CONTACT found entries that differ (a count, over the forward and
  every step). Every error is inf where the port's value or mjtpu's is
  not finite."""
  import numpy as np

  import mjtpu_torch
  from mjtpu_torch._src import derivative
  from mjtpu_torch._src.types import IntegratorType

  prefix = "" if kind == "humanoid_implicit" else f"{name}."
  g = lambda f: golden[f"{prefix}{f}"]
  has = lambda f: f"{prefix}{f}" in golden
  host = lambda x: x.cpu().numpy()
  m, d = slice14_scene(kind, name, golden, device)
  out = {}
  ref = mjtpu_torch.data_from_mjtpu(golden_fwd(golden, prefix), device=device)
  if has("deriv"):
    rne = m.opt.integrator == IntegratorType.IMPLICIT
    out["deriv"] = _scaled_err(host(mjtpu_torch.deriv_smooth_vel(m, ref, rne=rne)), g("deriv"))
    upd = mjtpu_torch.implicit(m, ref)
    for f in ("qpos", "qvel"):
      out[f"update.{f}"] = float(_abs_err(host(getattr(upd, f)), g(f)[0]).max())
  if has("deriv.fluid"):
    fluid, _ = derivative._velocity_jacobians(m, ref, True, False)
    out["deriv.fluid"] = _scaled_err(host(fluid), g("deriv.fluid"))
  fwd = mjtpu_torch.forward(m, d)
  out["fwd.qacc"] = _scaled_err(host(fwd.qacc), g("fwd.qacc"))
  out["fwd.energy"] = _scaled_err(host(fwd.energy), g("fwd.energy"))
  cols = found_columns(m)
  found = int((host(fwd.sensordata)[:, cols] != g("fwd.sensordata")[:, cols]).sum())
  fields = [f for f in ("qpos", "qvel", "sensordata", "energy") if has(f)]
  scale = {"energy": max(1.0, float(np.abs(g("energy")).max()))} if has("energy") else {}
  if m.nsensordata:
    scale["sensordata"] = _sensor_scale(m, {"sensordata": g("sensordata") if has("sensordata")
                                            else g("fwd.sensordata")[None]})
    out["fwd.sensordata"] = float((_abs_err(host(fwd.sensordata), g("fwd.sensordata"))
                                   / scale["sensordata"]).max())
  err = dict.fromkeys(fields, 0.0)
  ties = 0
  for t in range(g("qpos").shape[0]):
    before, d = d, mjtpu_torch.step(m, d)
    for f in fields:
      got = host(getattr(d, f))
      e = _abs_err(got, g(f)[t]) / scale.get(f, 1.0)
      if f == "sensordata":
        found += int((got[:, cols] != g(f)[t][:, cols]).sum())
        for b in np.flatnonzero(e.max(axis=1, initial=0.0) > SLICE14_TRAJECTORY_BOUND):
          # a tie (ROADMAP C13) only where a copy of the env's state a few
          # ULP away takes mjtpu's path
          copies = host(mjtpu_torch.step(m, _env_ulp_copies(before, b)).sensordata)
          if (_abs_err(copies, g(f)[t][b]) / scale[f]).max(axis=1).min() <= \
              SLICE14_TRAJECTORY_BOUND:
            ties += 1
            e[b] = 0.0
      err[f] = max(err[f], float(e.max(initial=0.0)))
  out.update({f"trajectory.{f}": v for f, v in err.items()})
  out["found"] = found
  out["ties"] = ties
  return out


def _env_ulp_copies(d, b):
  """ELLIPTIC_TIE_COPIES copies of env b of the Data ``d``, their qpos and
  qvel moved by 1-3 ULP (numpy seed 0, as _ulp_copies)."""
  import dataclasses

  import torch

  import mjtpu_torch

  rows = torch.full((ELLIPTIC_TIE_COPIES,), int(b), device=d.qpos.device)
  take = lambda obj: dataclasses.replace(obj, **{
      f.name: take(getattr(obj, f.name)) if dataclasses.is_dataclass(getattr(obj, f.name))
      else getattr(obj, f.name)[rows] for f in dataclasses.fields(obj)})
  copies = take(d)
  moved = _ulp_copies({k: getattr(copies, k)[:1].cpu().numpy() for k in ("qpos", "qvel")}, [0])
  return mjtpu_torch.replace(copies, **{k: torch.as_tensor(v, device=d.qpos.device)
                                        for k, v in moved.items()})


def slice14_bound(key: str) -> float | None:
  """The bound of a slice14_errors entry (None: not bounded)."""
  if key == "found":
    return 0
  if key == "ties":
    return None
  return SLICE14_TRAJECTORY_BOUND if key.startswith("trajectory") else SLICE14_STEP_BOUND


def slice14_over(errs: dict) -> dict:
  """The entries of a slice14_errors result over their bounds (a NaN is
  over every bound)."""
  return {k: v for k, v in errs.items()
          if slice14_bound(k) is not None and not v <= slice14_bound(k)}


def _mocap_path(card):
  """mocap.xml at f32 B=4096 (phase 29, the equality main path): every
  env's two mocap bodies moved before each step by mocap_targets, on the
  card from the step index and the env's phase; MOCAP_WARMUP warm-up and
  MOCAP_TIMED timed steps (B1 register at n=12 only, one launch per Newton
  iteration); its line and counts."""
  import numpy as np
  import torch

  import mjtpu_torch
  from mjtpu_torch._src import io

  m = mjtpu_torch.model_from_arrays(
      io.load_snapshot(mjtpu_torch.ASSETS / "equality_scenes.npz", "mocap"),
      dtype=torch.float32, device="cuda")
  d = _f32_start(m)
  mid = np.asarray(m.body_mocapid)
  bodies = np.nonzero(mid >= 0)[0]
  bodies = bodies[np.argsort(mid[bodies])]  # in mocap order
  base = m.body_pos[torch.as_tensor(bodies, device="cuda")]
  phase = torch.rand(BENCH_BATCH, generator=torch.Generator(device="cuda").manual_seed(1),
                     device="cuda") * MOCAP_PHASE_S
  clock = {"step": 0}

  def advance(d):
    pos, quat = mocap_targets(base, phase + clock["step"] * m.opt.timestep)
    clock["step"] += 1
    return mjtpu_torch.step(m, mjtpu_torch.replace(d, mocap_pos=pos, mocap_quat=quat))

  d, secs, counts, loops = _timed_main_path(m, d, MOCAP_WARMUP, MOCAP_TIMED, advance=advance)
  if counts != _only(chol_solve=loops["iterations"]):
    raise AssertionError(f"mocap.xml: kernel launches in {MOCAP_TIMED} timed steps: {counts},"
                         f" Newton {loops}")
  moved = float((d.xpos[:, int(bodies[0])] - base[0]).norm(dim=-1).max())
  rate = BENCH_BATCH * MOCAP_TIMED / secs
  shares, step_ms = _seam_shares(m, d, 2, advance=advance)
  if shares["chol_ns"] != {m.nv}:
    raise AssertionError(f"mocap.xml: B1 took n in {shares['chol_ns']}, not {m.nv}")
  busy, launches = _busy_share(advance, d)
  line = (f"f32 B={BENCH_BATCH} (nv={m.nv}, neq={m.neq} weld, nmocap={m.nmocap}, nefc"
          f" {mjtpu_torch.count_constraints(m)[3]}, contact slots"
          f" {d.contact.dist.shape[1]}): {MOCAP_WARMUP} warm-up and {MOCAP_TIMED} timed steps in"
          f" {secs:.3f} s = {rate:.0f} env-steps/s ({1e3 * secs / MOCAP_TIMED:.3f} ms/step); qpos"
          f" finite, nreset 0, the target box up to {moved:.3f} m from its model frame;"
          f" per step: B1 register {counts['chol_solve'] / MOCAP_TIMED:.2f} launches"
          f" (n={m.nv}; Newton {loops['iterations'] / MOCAP_TIMED:.2f} iterations and"
          f" {loops['ls_rounds'] / MOCAP_TIMED:.2f} linesearch rounds); device step"
          f" {step_ms:.3f} ms, of it B1 {shares['chol_solve']:.4f} ms"
          f" ({100 * shares['chol_solve'] / step_ms:.2f}%); one profiled step: {launches} kernel"
          f" launches, device busy {100 * busy:.1f}% of its wall time; card {card}")
  return line, counts


def phase_mocap_throughput(card):
  """The equality main path (phase 29)."""
  line, counts = _mocap_path(card)
  log(f"[mocap throughput] mocap.xml (a free payload welded to a moving mocap box, a free ball"
      f" on it, Euler, Newton 100 x 50) {line}")
  return counts


def phase_tendon_throughput(card):
  """The tendon main path (phase 27): the mixed tendon scene at f32
  B=4096, TENDON_TIMED timed steps, then muscle.xml, MUSCLE_TIMED."""
  line, mixed = _tendon_path("mixed", TENDON_TIMED, card, profile=True)
  log(f"[tendon throughput] mixed tendon scene (tests/test_tendon.py's _MIXED_XML: spatial"
      " tendon on a cylinder with limit and frictionloss, fixed tendon spring, tendon motor)"
      f" {line}")
  line, muscle = _tendon_path("muscle", MUSCLE_TIMED, card, profile=True)
  log(f"[tendon throughput] muscle.xml (four dyntypes, two muscles on fixed tendons) {line}")
  return mixed, muscle


def _satellite_run(name) -> str:
  """A few f32 B=4096 env steps of a satellite env: finite, nreset 0, and
  the B1 launches it takes by variant (not a main path: its n may take the
  shared kernel)."""
  import torch

  from mjtpu_torch import zoo
  from mjtpu_torch.ops import cholesky

  env = zoo.ENVS[name]()
  gen = torch.Generator(device="cuda").manual_seed(0)
  act = lambda: 2.0 * torch.rand(BENCH_BATCH, env.action_size, generator=gen,
                                 device="cuda") - 1.0
  state = env.reset(BENCH_BATCH, gen)
  for _ in range(SATELLITE_WARMUP):
    state = env.step(state, act(), gen)
  torch.cuda.synchronize()
  before = dict(cholesky.variant_launches)
  nreset = torch.zeros((), dtype=torch.int64, device="cuda")
  t0 = time.perf_counter()
  for _ in range(SATELLITE_TIMED):
    state = env.step(state, act(), gen)
    nreset += state.data.nreset.sum()
  torch.cuda.synchronize()
  secs = time.perf_counter() - t0
  kinds = {k: v - before[k] for k, v in cholesky.variant_launches.items()}
  finite = bool(torch.isfinite(state.obs).all() & torch.isfinite(state.data.qpos).all())
  if not finite or int(nreset):
    raise AssertionError(f"{name} env f32: obs or qpos not finite or reset: nreset {int(nreset)}")
  return (f"{name} (nv={env.model.nv}, frame_skip {env.frame_skip}): {SATELLITE_TIMED} env"
          f" steps after {SATELLITE_WARMUP} in {secs:.3f} s"
          f" ({BENCH_BATCH * SATELLITE_TIMED / secs:.0f} env steps/s), obs and qpos finite,"
          f" nreset 0, B1 launches {kinds}")


def phase_swimmer_throughput(card):
  """The swimmer env at f32 B=4096 (the main path, phase 25), then the
  satellite envs."""
  counts, fig = _env_throughput("swimmer", profile=True)
  log(f"[swimmer throughput] swimmer env (swimmer.xml, RK4, fluid forces) f32 B={BENCH_BATCH}"
      " through ENVS['swimmer']: " + _env_line(fig, card))
  for name in SATELLITE_ENVS[1:]:
    log(f"[satellite throughput] f32 B={BENCH_BATCH}: {_satellite_run(name)}; card {card}")
  return counts


def phase_slice14_parity(part: str):
  """The Implicit slice at f64 on the card against its mjtpu goldens, at
  the CPU tests' bounds (slice14_errors; phase 30, in two processes:
  ``part`` "implicit", humanoid_implicit and implicit_scenes.npz, or
  "sensor", sensor_scenes.npz); one B1 launch per Newton iteration (and
  one a step for a dense tree's Euler damping); on the geom-distance
  scene, sensor_pos's B3 launches (_geomdist_b3) in every forward pass,
  and the box-box distance with B3 equal bit for bit to the same with
  B3's twin."""
  import numpy as np

  import mjtpu_torch
  from mjtpu_torch._src import io, solver
  from mjtpu_torch.ops import cholesky, sat

  worst, ties, kinds = {}, 0, dict.fromkeys(cholesky.variant_launches, 0)
  runs = [("humanoid_implicit", None, dict(np.load(
      mjtpu_torch.ASSETS / "humanoid_implicit_golden.npz")))] if part == "implicit" else []
  bundle = SLICE14_BUNDLES[part]
  golden = dict(np.load(mjtpu_torch.ASSETS / f"{bundle}_golden.npz"))
  runs += [(part, name, golden) for name in io.bundle_names(mjtpu_torch.ASSETS / f"{bundle}.npz")]
  per_forward, box_bits = None, 0
  for kind, name, golden in runs:
    m, _ = slice14_scene(kind, name, golden, "cpu")
    before, newton = dict(cholesky.variant_launches), solver.loop_counts["iterations"]
    sat_before = dict(sat.variant_launches)
    errs = slice14_errors(kind, name, golden, "cuda")
    steps = golden[f"{name}.qpos" if name else "qpos"].shape[0]
    launched = {k: cholesky.variant_launches[k] - before[k] for k in before}
    want = solver.loop_counts["iterations"] - newton + (steps + errs["ties"]) * _damping_solves(m)
    if sum(launched.values()) != want:
      raise AssertionError(f"{name or kind}: B1 launches {launched}, want {want}")
    bad = slice14_over(errs)
    if bad:
      raise AssertionError(f"{name or kind} f64 on the card: {bad}")
    if name == "geomdist":
      sat_launched = {k: sat.variant_launches[k] - sat_before[k] for k in sat_before}
      per_forward, box_bits = _geomdist_b3(name, golden)
      calls = 1 + steps + errs["ties"]  # the forward, every step, every tie copy's step
      if sat_launched != {k: calls * v for k, v in per_forward.items()}:
        raise AssertionError(f"geomdist: B3 launches {sat_launched} in {calls} forward passes,"
                             f" want {per_forward} each")
    ties += errs["ties"]
    for k, v in launched.items():
      kinds[k] += v
    for k, v in errs.items():
      group = k if k in ("found", "ties") else k.split(".")[0]
      worst[group] = max(worst.get(group, 0.0), v)
  what = (f"humanoid_implicit and {len(runs) - 1} scenes of implicit_scenes.npz"
          if part == "implicit" else f"{len(runs)} scenes of sensor_scenes.npz")
  get = lambda k: f"{worst[k]:.3e}" if k in worst else "none"
  line = (f"[implicit parity] {what} f64 B=4: max err, step 1's qDeriv {get('deriv')} of scale,"
          f" the implicit update {get('update')}, forward's qacc, energy and sensors"
          f" {get('fwd')} (limit {SLICE14_STEP_BOUND}), 100 steps {get('trajectory')}"
          f" (limit {SLICE14_TRAJECTORY_BOUND}), CONTACT found entries that differ"
          f" {worst['found']}, contact-sensor ties taken by a ULP copy {ties} (ROADMAP C13); B1"
          f" launches {kinds}, one per Newton iteration")
  if per_forward is not None:
    line += (f"; geomdist: B3 per forward pass {per_forward} (sensor_pos once per SAT collider"
             f" of its pairs: static for box-box, in both orders, shared for box-cylinder), its"
             f" box-box distance with B3 static against its twin: {box_bits} entries whose bits"
             f" differ")
  log(line)
  if box_bits:
    raise AssertionError(f"geomdist: B3 static and its twin part on {box_bits} entries")
  if part == "sensor" and per_forward is None:
    raise AssertionError("sensor_scenes.npz has no geomdist scene")


def _geomdist_b3(name, golden) -> tuple[dict, int]:
  """B3 on the geom-distance scene at step 1 on the card: (its launches by
  variant in one forward pass: collision's and sensor_pos's, which must
  launch once per SAT collider of the sensors' pairs, static for the
  box-box ones, shared for box-cylinder; the entries of the box-box
  distance and fromto whose bits differ between B3 static and B3's twin
  on the same inputs)."""
  import torch

  import mjtpu_torch
  from mjtpu_torch._src import collision_convex, sensor, support
  from mjtpu_torch._src.types import GeomType, ObjType, SensorType
  from mjtpu_torch.ops import sat

  m, d = slice14_scene("sensor", name, golden, "cuda")
  before = dict(sat.variant_launches)
  fwd = mjtpu_torch.fwd_position(m, d)
  middle = dict(sat.variant_launches)
  mjtpu_torch.sensor_pos(m, fwd)
  sensors = {k: sat.variant_launches[k] - middle[k] for k in middle}
  # one launch per SAT collider of the sensors' pairs (a pair type and
  # its hulls in mjtpu's order), by the size dispatch's variant
  pairs = sensor._geomdist_tables(m)
  want = dict.fromkeys(sensors, 0)
  for fn, *_ in support._distance_tables(m, tuple(pairs["g1"]), tuple(pairs["g2"])):
    if getattr(fn, "func", None) is collision_convex.convex_convex:
      want[sat.variant(fn.keywords["hull1"].sat, fn.keywords["hull2"].sat)] += 1
  if sensors != want or not want["static"]:
    raise AssertionError(f"geomdist: sensor_pos launched B3 {sensors}, want {want}")
  per_forward = {k: sat.variant_launches[k] - before[k] for k in before}
  box = lambda g: int(m.geom_type[g]) == GeomType.BOX
  g1, g2 = next(((int(o),), (int(r),)) for t, ot, o, r in zip(
      m.sensor_type, m.sensor_objtype, m.sensor_objid, m.sensor_refid)
      if t == SensorType.GEOMDIST and ot == ObjType.GEOM and box(o) and box(r))
  cut = torch.full((1,), 2.0, dtype=m.dtype, device="cuda")
  before = sat.variant_launches["static"]
  kernel = support.geom_distances(m, fwd, g1, g2, cut)
  if sat.variant_launches["static"] != before + 1:
    raise AssertionError("geomdist: the box-box distance did not launch B3 static")
  launch = sat.sat_winners_batch
  sat.sat_winners_batch = lambda *args, kernel=None: sat.sat_winners_reference(*args)
  try:
    twin = support.geom_distances(m, fwd, g1, g2, cut)
  finally:
    sat.sat_winners_batch = launch
  return per_forward, sum(int((_bits(a) != _bits(b)).sum()) for a, b in zip(kernel, twin))


def _implicit_path(card):
  """humanoid_implicit at f32 B=4096 (phase 31, the Implicit slice's main
  path): the zoo's humanoid.xml under the full Implicit integrator from
  qpos0 +-0.01 (numpy seed 1), IMPLICIT_WARMUP warm-up and IMPLICIT_TIMED
  timed steps (B1 register at n=23 only, one launch per Newton
  iteration); its line and counts."""
  import torch

  import mjtpu_torch
  from mjtpu_torch._src import derivative, smooth

  m = mjtpu_torch.model_from_arrays(
      mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / "humanoid_implicit_model.npz"),
      dtype=torch.float32, device="cuda")
  d, secs, counts, loops = _timed_main_path(m, _f32_start(m), IMPLICIT_WARMUP, IMPLICIT_TIMED)
  if counts != _only(chol_solve=loops["iterations"]):
    raise AssertionError(f"humanoid_implicit: kernel launches in {IMPLICIT_TIMED} timed steps:"
                         f" {counts}, Newton {loops}")
  rate = BENCH_BATCH * IMPLICIT_TIMED / secs
  shares, step_ms = _seam_shares(m, d, 2, extra={
      "deriv_smooth_vel": (derivative, "deriv_smooth_vel"), "lu": (smooth, "_lu_solve")})
  if shares["chol_ns"] != {m.nv}:
    raise AssertionError(f"humanoid_implicit: B1 took n in {shares['chol_ns']}, not {m.nv}")
  busy, launches = _busy_share(lambda d: mjtpu_torch.step(m, d), d)
  live = int((d.contact.dist < 0).sum())
  share = lambda k: f"{shares[k]:.4f} ms ({100 * shares[k] / step_ms:.2f}%)"
  line = (f"f32 B={BENCH_BATCH} (nv={m.nv}, nefc {mjtpu_torch.count_constraints(m)[3]}, contact"
          f" slots {d.contact.dist.shape[1]}): {IMPLICIT_WARMUP} warm-up and {IMPLICIT_TIMED}"
          f" timed steps in {secs:.3f} s = {rate:.0f} env-steps/s"
          f" ({1e3 * secs / IMPLICIT_TIMED:.3f} ms/step); qpos finite, nreset 0, {live} live"
          f" contacts over the batch at the end; per step: B1 register"
          f" {counts['chol_solve'] / IMPLICIT_TIMED:.2f} launches (n={m.nv}; Newton"
          f" {loops['iterations'] / IMPLICIT_TIMED:.2f} iterations and"
          f" {loops['ls_rounds'] / IMPLICIT_TIMED:.2f} linesearch rounds); device step"
          f" {step_ms:.3f} ms, of it B1 {share('chol_solve')}, deriv_smooth_vel (RNE"
          f" derivative over B x nv) {share('deriv_smooth_vel')}, the LU of qM - h qDeriv"
          f" {share('lu')}; one profiled step: {launches} kernel launches, device busy"
          f" {100 * busy:.1f}% of its wall time; card {card}")
  return line, counts


def phase_implicit_throughput(card):
  """The Implicit slice's main path (phase 31)."""
  line, counts = _implicit_path(card)
  log(f"[implicit throughput] humanoid_implicit (the zoo's humanoid.xml, Implicit, Newton 8 x 8,"
      f" the RNE velocity derivative, the dense LU) {line}")
  return counts


# ---------------------------------------------------------------------------
# slice 15: per-env Model rows (parallel.randomize) and inverse dynamics
# ---------------------------------------------------------------------------


def bench_randomization(ns, batch: int, seed: int = 1, locomotion: bool = False) -> dict:
  """The randomized humanoid_bench's rows (numpy, (batch, *shape) each)
  from numpy seed ``seed``, for ``ns`` (an MjModel or a snapshot): each
  geom's sliding friction x U(0.5, 1.5), each body's mass x U(0.8, 1.2),
  each dof's damping x U(0.5, 2), each motor's gain x U(0.8, 1.2), the
  timestep x U(0.9, 1.1).  Their derived constants come from mj_setConst
  (randomize_scenes_golden.npz's "bench.rows.*", written for batch =
  BENCH_BATCH and seed 1).

  With ``locomotion``, the same draws and then, from the same generator,
  BENCH_LOCOMOTION_FIELDS: each limb's body_pos x U(0.95, 1.05), each
  geom's pos + U(-5, 5) mm, each joint's solref time constant x U(0.8,
  1.2) and solimp dmin and dmax x U(0.98, 1), a margin U(0, 0.02) on each
  limited joint (narrower than half its range, so no limit turns
  two-sided), each hinge's spring reference qpos0 + U(-0.1, 0.1), each
  motor's ctrlrange x U(0.8, 1.2).  Their derived constants (body_pos
  moves them) are randomize_fields_golden.npz's "bench.rows.*", written
  for batch = BENCH_BATCH and seed 1."""
  import numpy as np

  rng = np.random.default_rng(seed)
  tile = lambda x: np.tile(np.array(x, dtype=np.float64), (batch,) + (1,) * np.ndim(x))
  friction, mass = tile(ns.geom_friction), tile(ns.body_mass)
  friction[..., 0] *= rng.uniform(0.5, 1.5, friction.shape[:2])
  mass *= rng.uniform(0.8, 1.2, mass.shape)
  damping = tile(ns.dof_damping) * rng.uniform(0.5, 2.0, (batch, len(ns.dof_damping)))
  gain = tile(ns.actuator_gainprm)
  gain[..., 0] *= rng.uniform(0.8, 1.2, gain.shape[:2])
  timestep = float(ns.opt.timestep) * rng.uniform(0.9, 1.1, batch)
  rows = {"geom_friction": friction, "body_mass": mass, "dof_damping": damping,
          "actuator_gainprm": gain, "opt.timestep": timestep}
  if not locomotion:
    return rows
  body_pos = tile(ns.body_pos)
  body_pos[:, 2:] *= rng.uniform(0.95, 1.05, (batch, len(body_pos[0]) - 2, 1))  # the limbs
  geom_pos = tile(ns.geom_pos) + rng.uniform(-0.005, 0.005, (batch,) + np.shape(ns.geom_pos))
  solref, solimp = tile(ns.jnt_solref), tile(ns.jnt_solimp)
  solref[..., 0] *= rng.uniform(0.8, 1.2, solref.shape[:2])
  solimp[..., :2] *= rng.uniform(0.98, 1.0, solimp.shape[:2] + (2,))
  rng_width = np.diff(np.asarray(ns.jnt_range, dtype=np.float64), axis=-1)[:, 0]
  limited = np.asarray(ns.jnt_limited, dtype=bool) & (rng_width > 0.04)
  margin = tile(ns.jnt_margin) + rng.uniform(0.0, 0.02, (batch, len(limited))) * limited
  hinge = np.zeros(len(np.asarray(ns.qpos0)), dtype=bool)
  types, adr = np.asarray(ns.jnt_type), np.asarray(ns.jnt_qposadr)
  hinge[adr[types == 3]] = True  # mjJNT_HINGE
  spring = tile(ns.qpos_spring) + rng.uniform(-0.1, 0.1, (batch, len(hinge))) * hinge
  ctrlrange = tile(ns.actuator_ctrlrange) * rng.uniform(
      0.8, 1.2, (batch, len(ns.actuator_ctrlrange), 1))
  new = (body_pos, geom_pos, solref, solimp, margin, spring, ctrlrange)
  return {**rows, **dict(zip(BENCH_LOCOMOTION_FIELDS, new))}


def terrain_randomization(ns, batch: int, seed: int = 1) -> dict:
  """The per-env terrain of humanoid_terrain (numpy, (batch, *shape) each)
  from numpy seed ``seed``: each env's height field the base heights x
  U(0.5, 1.5) per cell, clipped to [0, 1], and each geom's sliding
  friction x U(0.5, 1.5)."""
  import numpy as np

  rng = np.random.default_rng(seed)
  heights = np.asarray(ns.hfield_data, dtype=np.float64)
  heights = np.clip(heights[None] * rng.uniform(0.5, 1.5, (batch,) + heights.shape), 0.0, 1.0)
  friction = np.tile(np.array(ns.geom_friction, dtype=np.float64), (batch, 1, 1))
  friction[..., 0] *= rng.uniform(0.5, 1.5, friction.shape[:2])
  return {"hfield_data": heights, "geom_friction": friction}


def _bundle_model(bundle: str, name: str, device, dtype=None):
  import torch

  import mjtpu_torch

  return mjtpu_torch.model_from_arrays(
      mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / f"{bundle}.npz", name),
      dtype=dtype or torch.float64, device=device)


def _rows(golden, prefix: str, m) -> dict:
  """The rows under ``prefix`` in ``golden`` but those of empty fields (a
  model without tendons has no tendon row)."""
  from mjtpu_torch._src.types import field

  out = {}
  for k in golden.files:
    if k.startswith(prefix):
      name = k[len(prefix):]
      base = field(m, name)
      if base is None or base.numel():
        out[name] = golden[k]
  return out


def _env_model(m, rows: dict, i: int):
  """The unbatched Model of env i: ``m`` with row i of each of ``rows``."""
  import torch

  from mjtpu_torch._src.types import replace_fields

  return replace_fields(m, {k: torch.as_tensor(v[i], dtype=m.dtype, device=m.device)
                            for k, v in rows.items()})


def _env_data(d, i: int):
  """Env i of the batched Data ``d``, as a batch of one."""
  from mjtpu_torch._src.dataclasses import map_tensors

  return map_tensors(d, lambda x: x[i:i + 1])


def _stack_env(ds, e: int):
  """Env ``e`` of each of the batched Datas ``ds``, as one Data whose
  batch is the list."""
  import torch

  from mjtpu_torch._src.dataclasses import map_tensors

  cols = []
  for d in ds:
    leaves = []
    map_tensors(d, lambda x: leaves.append(x[e]) or x)
    cols.append(leaves)
  stacked = iter([torch.stack(c) for c in zip(*cols)])
  return map_tensors(ds[0], lambda x: next(stacked))


def _randomize_scene_start(name: str, golden, device, bundle: str = "randomize_scenes"):
  """(the base Model, its rows, the start Data, the golden's steps) of
  randomize scene ``name`` of ``bundle``."""
  import numpy as np
  import torch

  import mjtpu_torch

  m = _bundle_model(bundle, name, device)
  rows = _rows(golden, f"{name}.rows.", m)
  start = {k[len(name) + 1:-1]: golden[k] for k in golden.files
           if k.startswith(f"{name}.") and k.endswith("0") and ".rows." not in k}
  steps, batch = golden[f"{name}.qpos"].shape[:2]
  t = lambda x: torch.as_tensor(np.asarray(x), dtype=m.dtype, device=device)
  d0 = mjtpu_torch.replace(mjtpu_torch.make_data(m, batch), **{k: t(v) for k, v in start.items()})
  return m, rows, d0, steps


def _qpos_qvel_err(a, b) -> float:
  """max |qpos|, |qvel| difference of two Datas of one batch (_abs_err)."""
  return max(float(_abs_err(getattr(a, f).cpu().numpy(), getattr(b, f).cpu().numpy()).max())
             for f in ("qpos", "qvel"))


def randomize_plain_split(name: str, golden, device) -> float:
  """Randomize scene ``name``'s base Model without its rows, from the
  golden's start: the batched run against each env run as a batch of
  one, the max |qpos|, |qvel| difference over the golden's steps.  What
  rounding alone splits over a run, the witness beside the "self" error
  of randomize_scene_errors."""
  import mjtpu_torch

  m, _, d0, steps = _randomize_scene_start(name, golden, device)
  plain = [d0]
  for _ in range(steps):
    plain.append(mjtpu_torch.step(m, plain[-1]))
  err = 0.0
  for e in range(d0.qpos.shape[0]):
    d = _env_data(d0, e)
    for i in range(1, steps + 1):
      d = mjtpu_torch.step(m, d)
      err = max(err, _qpos_qvel_err(d, _env_data(plain[i], e)))
  return err


def randomize_scene_errors(name: str, golden, device) -> dict:
  """The randomize scene ``name`` (randomize_scenes.npz, f64): its rows
  from the golden through parallel.randomized_step from the golden's
  start, against mjtpu's batched randomized rollout ("mjtpu": the max
  |qpos|, |qvel| difference over the golden's steps; "mjtpu_head": over
  its first RANDOM_BENCH_STEPS); each env stepped alone under its own
  unbatched Model against the batched run ("self"); each env's state at
  every step stepped once under its own unbatched Model (one batch of
  the env's states) against the batched run's next step, the worst over
  every step ("restart": one step's rounding, not amplified over a run)."""
  import mjtpu_torch
  from mjtpu_torch import parallel

  m, rows, d0, steps = _randomize_scene_start(name, golden, device)
  step, _ = parallel.randomized_step(m, rows)
  d, err, head, ds = d0, 0.0, 0.0, [d0]
  for i in range(steps):
    d = step(d)
    ds.append(d)
    e = max(float(_abs_err(d.qpos.cpu().numpy(), golden[f"{name}.qpos"][i]).max()),
            float(_abs_err(d.qvel.cpu().numpy(), golden[f"{name}.qvel"][i]).max()))
    err = max(err, e)
    if i < RANDOM_BENCH_STEPS:
      head = max(head, e)
  out = {"mjtpu": err, "mjtpu_head": head, "self": 0.0, "restart": 0.0}
  for e in range(d0.qpos.shape[0]):
    me, de = _env_model(m, rows, e), _env_data(d0, e)
    for i in range(1, steps + 1):
      de = mjtpu_torch.step(me, de)
      out["self"] = max(out["self"], _qpos_qvel_err(de, _env_data(ds[i], e)))
    out["restart"] = max(out["restart"], _qpos_qvel_err(
        mjtpu_torch.step(me, _stack_env(ds[:-1], e)), _stack_env(ds[1:], e)))
  return out


def inverse_scene_errors(name: str, golden, device) -> dict:
  """The inverse scene ``name`` (inverse_scenes.npz, f64): mjtpu_torch's
  inverse from the golden's start against mjtpu's outputs, each field's
  max |difference| over its scale (_scaled_err); "qacc_restored" whether
  the caller's qacc came back bit for bit; "c" the port's qfrc_inverse
  against MuJoCo C's, absolute."""
  import numpy as np
  import torch

  import mjtpu_torch

  m = _bundle_model("inverse_scenes", name, device)
  start = {k[len(name) + 1:-1]: golden[k] for k in golden.files
           if k.startswith(f"{name}.") and k.endswith("0")}
  batch = len(start["qacc"])
  t = lambda x: torch.as_tensor(np.asarray(x), dtype=m.dtype, device=device)
  d = mjtpu_torch.replace(mjtpu_torch.make_data(m, batch), **{k: t(v) for k, v in start.items()})
  out = mjtpu_torch.inverse(m, d)
  errs = {k: _scaled_err(getattr(out, k).cpu().numpy(), golden[f"{name}.{k}"])
          for k in INVERSE_FIELDS if golden[f"{name}.{k}"].size}
  errs["qacc_restored"] = bool(torch.equal(out.qacc, d.qacc))
  errs["c"] = float(np.abs(out.qfrc_inverse.cpu().numpy() - golden[f"{name}.c_qfrc_inverse"]).max())
  return errs


def randomize_bounds(name: str) -> tuple[str, float, float]:
  """(the error key, its bound against mjtpu, the bound of each env's run
  alone against the batch, and of the base Model's) of randomize scene
  ``name``: humanoid_bench's truncated solver amplifies ULP differences
  over a run (C1: its base Model parts a batch of 4 from batches of one
  as far as its rows do), so it is held to RANDOM_BENCH_BOUND through
  step RANDOM_BENCH_STEPS in both; its one-step restarts, like every
  scene's, to RANDOM_SELF_BOUND."""
  if name == "humanoid_bench":
    return "mjtpu_head", RANDOM_BENCH_BOUND, RANDOM_BENCH_BOUND
  return "mjtpu", RANDOM_BOUND, RANDOM_SELF_BOUND


def field_scene_errors(name: str, golden, device, envs=None) -> dict:
  """The randomize_fields scene ``name`` (f64): its rows from the golden
  through parallel.randomized_step from the golden's start, against
  mjtpu's batched randomized rollout, each (B,) over the envs: "mjtpu" the
  max difference over FIELD_OUTPUTS and the golden's steps, each output's
  over its scale (max(1, max |golden|)), "mjtpu_head" over the first
  RANDOM_BENCH_STEPS; "moved" and "mjtpu_moved" how far the port's and
  mjtpu's env parts from env 0 (the base Model's), absolute; "self" each
  env of ``envs`` (default all) alone under its own unbatched Model: its
  state at every step of the batched run (one batch of the env's states)
  stepped once, against the batched run's next step, of scale (NaN for
  the other envs)."""
  import numpy as np

  import mjtpu_torch
  from mjtpu_torch import parallel

  m, rows, d0, steps = _randomize_scene_start(name, golden, device, "randomize_fields")
  step, _ = parallel.randomized_step(m, rows)
  outs = [o for o in FIELD_OUTPUTS if f"{name}.{o}" in golden.files]
  B = d0.qpos.shape[0]
  scale = {o: max(1.0, float(np.abs(golden[f"{name}.{o}"]).max())) for o in outs}
  flat = lambda x: x.detach().cpu().numpy().reshape(x.shape[0], -1)
  out = {k: np.zeros(B) for k in ("mjtpu", "mjtpu_head", "moved", "mjtpu_moved")}
  out["self"] = np.full(B, np.nan)
  d, ds = d0, [d0]
  for i in range(steps):
    d = step(d)
    ds.append(d)
    for o in outs:
      got, want = flat(getattr(d, o)), golden[f"{name}.{o}"][i].reshape(B, -1)
      err = _abs_err(got, want).max(axis=1) / scale[o]
      out["mjtpu"] = np.maximum(out["mjtpu"], err)
      if i < RANDOM_BENCH_STEPS:
        out["mjtpu_head"] = np.maximum(out["mjtpu_head"], err)
      out["moved"] = np.maximum(out["moved"], _abs_err(got, got[:1]).max(axis=1))
      out["mjtpu_moved"] = np.maximum(out["mjtpu_moved"], _abs_err(want, want[:1]).max(axis=1))
  for e in range(B) if envs is None else envs:
    alone, batched = mjtpu_torch.step(_env_model(m, rows, e), _stack_env(ds[:-1], e)), _stack_env(
        ds[1:], e)
    out["self"][e] = max(float(_abs_err(flat(getattr(alone, o)), flat(getattr(batched, o))).max())
                         / scale[o] for o in outs)
  return out


def field_bounds(name: str) -> tuple[str, float, float]:
  """(the error key, its bound against mjtpu, the bound of each env alone
  against the batch) of randomize_fields scene ``name``: humanoid_bench's
  truncated solver amplifies ULP differences over a run (C1), so it is
  held to RANDOM_BENCH_BOUND through step RANDOM_BENCH_STEPS in both."""
  if name == "humanoid_bench":
    return "mjtpu_head", RANDOM_BENCH_BOUND, RANDOM_BENCH_BOUND
  return "mjtpu", RANDOM_BOUND, RANDOM_SELF_BOUND


def phase_slice18_parity():
  """Phase 32-fields (side): every randomize_fields scene at f64 against
  mjtpu's golden (field_bounds: RANDOM_BOUND of scale, humanoid_bench
  RANDOM_BENCH_BOUND through step RANDOM_BENCH_STEPS), each env alone
  under its own Model against the batch (RANDOM_SELF_BOUND; RANDOM_CHECK_ENVS
  envs of each scene), and every env that mjtpu's rows leave where the
  base env goes left there by the port too."""
  import numpy as np

  import mjtpu_torch
  from mjtpu_torch._src import io

  golden = np.load(mjtpu_torch.ASSETS / "randomize_fields_golden.npz")
  for name in io.bundle_names(mjtpu_torch.ASSETS / "randomize_fields.npz"):
    B = golden[f"{name}.qpos"].shape[1]
    envs = np.unique(np.linspace(0, B - 1, RANDOM_CHECK_ENVS).astype(int))
    errs = field_scene_errors(name, golden, "cuda", envs=[int(e) for e in envs])
    key, bound, self_bound = field_bounds(name)
    still = errs["mjtpu_moved"] == 0.0
    worst, alone = float(errs[key].max()), float(np.nanmax(errs["self"]))
    if not (worst <= bound and alone <= self_bound and np.all(errs["moved"][still] == 0.0)):
      raise AssertionError(f"randomize_fields {name}: {errs}")
    log(f"[slice18 parity] randomize_fields {name}: B={B}, batched against mjtpu {worst:.3e} of"
        f" scale (bound {bound:g}), {len(envs)} envs each under its own Model {alone:.3e}"
        f" (bound {self_bound:g}), {int(still[1:].sum())} of {B - 1} perturbed envs where mjtpu's"
        f" stay with the base env stay there")


def phase_slice15_parity():
  """Phase 32 (side): every randomize scene's batched run against mjtpu's
  (RANDOM_BOUND; humanoid_bench's to RANDOM_BENCH_BOUND through step
  RANDOM_BENCH_STEPS, as C1) and each env alone under its own Model
  against it (RANDOM_SELF_BOUND), beside the base Model's same run, and
  each env's one-step restarts (RANDOM_SELF_BOUND); every inverse scene against mjtpu
  (INVERSE_BOUND of scale) with the caller's qacc restored, f64."""
  import numpy as np

  import mjtpu_torch
  from mjtpu_torch._src import io

  golden = np.load(mjtpu_torch.ASSETS / "randomize_scenes_golden.npz")
  for name in io.bundle_names(mjtpu_torch.ASSETS / "randomize_scenes.npz"):
    errs = randomize_scene_errors(name, golden, "cuda")
    errs["plain_self"] = randomize_plain_split(name, golden, "cuda")
    key, bound, self_bound = randomize_bounds(name)
    if not (errs[key] <= bound and errs["self"] <= self_bound
            and errs["plain_self"] <= self_bound and errs["restart"] <= RANDOM_SELF_BOUND):
      raise AssertionError(f"randomize scene {name}: {errs}")
    log(f"[slice15 parity] randomize {name}: batched against mjtpu {errs[key]:.3e} (bound"
        f" {bound:g}{' through step %d' % RANDOM_BENCH_STEPS if key == 'mjtpu_head' else ''};"
        f" over every step {errs['mjtpu']:.3e}), each env under its own Model"
        f" {errs['self']:.3e} and the base Model's batch against batches of one"
        f" {errs['plain_self']:.3e} (bound {self_bound:g}), each env's one-step restarts"
        f" {errs['restart']:.3e} (bound {RANDOM_SELF_BOUND:g})")
  golden = np.load(mjtpu_torch.ASSETS / "inverse_scenes_golden.npz")
  for name in io.bundle_names(mjtpu_torch.ASSETS / "inverse_scenes.npz"):
    errs = inverse_scene_errors(name, golden, "cuda")
    worst = max(v for k, v in errs.items() if k in INVERSE_FIELDS)
    if worst > INVERSE_BOUND or not errs["qacc_restored"]:
      raise AssertionError(f"inverse scene {name}: {errs}")
    log(f"[slice15 parity] inverse {name}: against mjtpu {worst:.3e} of scale (bound"
        f" {INVERSE_BOUND:g}), qacc restored, qfrc_inverse against MuJoCo C {errs['c']:.3e}")


def _randomized_path(card, m, rows, warmup, timed, launches):
  """A randomized main path at f32 B=4096 through parallel.randomized_step
  (``rows``: numpy (B, *shape) each), beside the plain path of the base
  Model ``m`` in the same call: ``warmup`` warm-up and ``timed`` timed
  steps of each (_timed_main_path), the randomized run's launches
  against ``launches(newton_loops)`` and its peak memory; then
  RANDOM_CHECK_ENVS envs each stepped once under its own unbatched Model
  against the batched step from the same state.  Returns (the line's
  text, the randomized run's counts, its figures)."""
  import numpy as np
  import torch

  import mjtpu_torch
  from mjtpu_torch import parallel

  step, mb = parallel.randomized_step(m, rows)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  d, secs, counts, loops = _timed_main_path(mb, _f32_start(m), warmup, timed, advance=step)
  peak = torch.cuda.max_memory_allocated() / 2**30
  if counts != launches(loops):
    raise AssertionError(f"randomized path: launches {counts}, Newton {loops}")
  _, plain_secs, plain_counts, plain_loops = _timed_main_path(m, _f32_start(m), warmup, timed)
  envs = np.linspace(0, BENCH_BATCH - 1, RANDOM_CHECK_ENVS).astype(int)
  batched = step(d)
  worst = 0.0
  for e in envs:
    alone = mjtpu_torch.step(_env_model(m, rows, int(e)), _env_data(d, int(e)))
    for f in ("qpos", "qvel"):
      worst = max(worst, _scaled_err(getattr(alone, f)[0].cpu().numpy(),
                                     getattr(batched, f)[int(e)].cpu().numpy()))
  if worst > RANDOM_CHECK_BOUND:
    raise AssertionError(f"randomized path: env alone against the batch {worst:.3e}")
  rate, plain_rate = BENCH_BATCH * timed / secs, BENCH_BATCH * timed / plain_secs
  per = lambda c, k: c[k] / timed
  figures = {"env_steps_per_s": rate, "plain_env_steps_per_s": plain_rate,
             "peak_gib": peak, "nreset": 0, "alone_err": worst}
  line = (f"f32 B={BENCH_BATCH}: {warmup} warm-up and {timed} timed steps in {secs:.3f} s ="
          f" {rate:.0f} env-steps/s ({1e3 * secs / timed:.3f} ms/step), the base Model's plain"
          f" path in the same call {plain_rate:.0f} env-steps/s ({1e3 * plain_secs / timed:.3f}"
          f" ms/step); qpos finite, nreset 0 over both runs; per step: B1 register"
          f" {per(counts, 'chol_solve'):.2f} launches (Newton {per(loops, 'iterations'):.2f}"
          f" iterations, {per(loops, 'ls_rounds'):.2f} linesearch rounds; plain"
          f" {per(plain_counts, 'chol_solve'):.2f} and {per(plain_loops, 'iterations'):.2f}),"
          f" B4 static {per(counts, 'hfield_manifold'):.2f} launches (plain"
          f" {per(plain_counts, 'hfield_manifold'):.2f}); n={m.nv}; peak memory {peak:.2f} GiB;"
          f" {len(envs)} envs each stepped under its own Model within {worst:.3e} of scale of"
          f" the batch (bound {RANDOM_CHECK_BOUND:g}); card {card}")
  return line, counts, figures


def _random_bench_path(card):
  """Phase 33's randomized humanoid_bench: bench_randomization's five
  fields and its locomotion fields (numpy seed 1) with their derived
  constants from the committed asset, RANDOM_WARMUP warm-up and
  RANDOM_TIMED timed steps, B1 register at n=27 once per Newton
  iteration (_randomized_path)."""
  import numpy as np
  import torch

  import mjtpu_torch

  ns = mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / "humanoid_bench_model.npz")
  m = mjtpu_torch.model_from_arrays(ns, dtype=torch.float32, device="cuda")
  rows = bench_randomization(ns, BENCH_BATCH, locomotion=True)
  consts = _rows(np.load(mjtpu_torch.ASSETS / "randomize_fields_golden.npz"), "bench.rows.", m)
  for k in ("body_mass", "body_pos"):
    if not np.array_equal(consts.pop(k), rows[k]):
      raise AssertionError(f"randomize_fields_golden.npz's bench rows of {k} are not"
                           " bench_randomization's")
  rows.update(consts)
  line, counts, figures = _randomized_path(
      card, m, rows, RANDOM_WARMUP, RANDOM_TIMED,
      lambda loops: _only(chol_solve=loops["iterations"]))
  spread = float(rows["opt.timestep"].max() / rows["opt.timestep"].min())
  return f"{line}; timesteps span x{spread:.3f}", counts, figures


def _random_terrain_path(card):
  """Phase 33's per-env terrain: humanoid_terrain with each env's own
  height field and friction (terrain_randomization, numpy seed 1: 1,024
  cells an env), TERRAIN_WARMUP warm-up and TERRAIN_TIMED timed steps,
  B4 static twice a step and B1 register at n=23 once per Newton
  iteration (_randomized_path)."""
  import torch

  import mjtpu_torch

  ns = mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / "humanoid_terrain_model.npz")
  m = mjtpu_torch.model_from_arrays(ns, dtype=torch.float32, device="cuda")
  rows = terrain_randomization(ns, BENCH_BATCH)
  return _randomized_path(
      card, m, rows, TERRAIN_WARMUP, TERRAIN_TIMED,
      lambda loops: _only(chol_solve=loops["iterations"], hfield_manifold=2 * TERRAIN_TIMED))


def _branchy_inverse_path(card):
  """Phase 33's branchy66 inverse: f32 B=4096, the 66-dof tree with
  INVDISCRETE (Euler with implicit damping) at hinge angles qpos0 +-0.3
  and qvel in [-0.3, 0.3] (numpy seed 1), qacc from one step;
  INVERSE_WARMUP warm-up and INVERSE_TIMED timed inverse calls (CUDA
  events): B2 lanes factor (factor_m) and solve (discrete_acc's solve_m),
  one each a call."""
  import numpy as np
  import torch

  import mjtpu_torch
  from mjtpu_torch.ops import ldl

  m = _bundle_model("inverse_scenes", "branchy66", "cuda", torch.float32)
  rng = np.random.default_rng(1)
  qpos = m.qpos0.cpu().numpy()[None].repeat(BENCH_BATCH, 0)
  qpos[:, 7:] += rng.uniform(-0.3, 0.3, (BENCH_BATCH, m.nq - 7))
  t = lambda x: torch.as_tensor(x, dtype=torch.float32, device="cuda")
  d = mjtpu_torch.replace(mjtpu_torch.make_data(m, BENCH_BATCH), qpos=t(qpos),
                          qvel=t(rng.uniform(-0.3, 0.3, (BENCH_BATCH, m.nv))))
  d = mjtpu_torch.replace(d, qacc=mjtpu_torch.step(m, d).qacc)
  for _ in range(INVERSE_WARMUP):
    out = mjtpu_torch.inverse(m, d)
  torch.cuda.synchronize()
  _zero_counts()
  t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
  t0.record()
  for _ in range(INVERSE_TIMED):
    out = mjtpu_torch.inverse(m, d)
  t1.record()
  torch.cuda.synchronize()
  secs = t0.elapsed_time(t1) / 1e3
  by_variant = {e: dict(ldl.variant_launches[e]) for e in ("ldl_factor", "ldl_solve")}
  counts = _read_counts()
  if counts != _only(ldl_factor=INVERSE_TIMED, ldl_solve=INVERSE_TIMED):
    raise AssertionError(f"branchy66 inverse: launches {counts}")
  if not bool(torch.isfinite(out.qfrc_inverse).all()) or not torch.equal(out.qacc, d.qacc):
    raise AssertionError("branchy66 inverse: qfrc_inverse not finite or qacc not restored")
  line = (f"f32 B={BENCH_BATCH} (nv={m.nv}, INVDISCRETE, Euler with implicit damping):"
          f" {INVERSE_WARMUP} warm-up and {INVERSE_TIMED} timed calls in {secs:.3f} s (CUDA"
          f" events) = {BENCH_BATCH * INVERSE_TIMED / secs:.0f} env-inverses/s"
          f" ({1e3 * secs / INVERSE_TIMED:.3f} ms/call); qfrc_inverse finite, qacc restored;"
          f" per call: B2 lanes factor {counts['ldl_factor'] / INVERSE_TIMED:.0f} and solve"
          f" {counts['ldl_solve'] / INVERSE_TIMED:.0f} launches (by variant in all"
          f" {by_variant}); card {card}")
  return line, counts


def phase_slice15_throughput(card):
  """Phase 33: the randomized humanoid_bench, the per-env terrain and the
  branchy66 inverse: (their launch counts, the randomized paths'
  figures)."""
  line, bench, bench_fig = _random_bench_path(card)
  log(f"[slice18 throughput] randomized humanoid_bench (per-env friction, masses, damping,"
      f" gains, timestep, {', '.join(BENCH_LOCOMOTION_FIELDS)}, parallel.randomized_step)"
      f" {line}")
  line, terrain, terrain_fig = _random_terrain_path(card)
  log(f"[slice18 throughput] per-env terrain humanoid_terrain (per-env hfield_data and"
      f" geom_friction, parallel.randomized_step) {line}")
  line, inv = _branchy_inverse_path(card)
  log(f"[slice15 throughput] branchy66 inverse {line}")
  return bench, terrain, inv, {"humanoid_bench": bench_fig, "humanoid_terrain": terrain_fig}


# the differentiable scenes (diff_scenes.npz; tests/test_diff.py's cases),
# name -> (kind, steps, differentiable_mode's keywords, the qpos entries
# the loss or the offset reads):
#   "rollout": loss = sum of the final qpos[entries]^2 after `steps` steps
#              from the golden's start (each step's ctrl from its ctrl
#              sequence, where it has one), its gradient with respect to
#              the start's qvel (and the ctrl sequence)
#   "mindist": loss = min(contact.dist) of fwd_position at the start's
#              qpos with the golden's offset added to qpos[entries], its
#              gradient with respect to the offset
DIFF_SCENES = {
    "pendulum": ("rollout", 20, {}, None),
    "pendulum_adaptive": ("rollout", 20, {"adaptive_integration": True,
                                          "adaptive_substeps": 4}, None),
    "spheres": ("rollout", 10, {"cfd": True, "cfd_width": 0.01}, None),
    "box_corner": ("mindist", 0, {"smooth_collisions": True, "cfd": True}, (0,)),
    "box_box": ("mindist", 0, {"smooth_collisions": True, "cfd": True}, (2,)),
    "sph_cyl": ("rollout", 8, {"cfd": True, "cfd_width": 0.01}, None),
    "roll": ("mindist", 0, {"smooth_collisions": True}, None),
    "bounce": ("rollout", 60, {}, (0, 1)),
    "bounce_smooth": ("rollout", 60, {"smooth_collisions": True, "cfd": True,
                                      "cfd_width": 0.02}, (0, 1)),
    "humanoid_bench": ("rollout", 4, {}, None),
}
DIFF_VALUE_HEAD_BOUND = 1e-10  # the values at step 1, of their scale
DIFF_VALUE_BOUND = 1e-8        # ... over the rollout
DIFF_GRAD_BOUND = 1e-8         # the gradients, of their max-abs
# B1's backward against the twin's autograd, at the main paths' n
DIFF_CHOL_NS = (27, 23)
DIFF_K = 8  # the differentiable main path's steps
DIFF_RUNS = 5  # its timed rollouts (forward and backward) after the warm-up
STEPPED_BOUND = 1e-8  # hopper_bench and pendulum_implicit against mjtpu, of scale


def diff_scene_model(name, device, dtype=None):
  """The Model of a diff scene (diff_scenes.npz) on ``device``."""
  import mjtpu_torch
  from mjtpu_torch._src import io

  ns = io.load_snapshot(mjtpu_torch.ASSETS / "diff_scenes.npz", name)
  return mjtpu_torch.model_from_arrays(ns, device=device, **({"dtype": dtype} if dtype else {}))


def diff_scene_run(name, golden, device, m=None) -> dict:
  """One diff scene through the port under its differentiable_mode, from
  the golden's start on ``device``: the values ("qpos", "qvel" per step
  and "loss" for a rollout, "loss" for a mindist scene) and the gradients
  ("grad_qvel", "grad_ctrl", "grad_offset"), as numpy arrays."""
  import torch

  import mjtpu_torch

  kind, steps, cfg, entries = DIFF_SCENES[name]
  m = m or diff_scene_model(name, device)
  t = lambda k: torch.as_tensor(golden[f"{name}.{k}"], dtype=m.dtype, device=device)
  qpos0 = t("qpos0")
  d = mjtpu_torch.make_data(m, batch_size=qpos0.shape[0])
  out = {}
  with mjtpu_torch.differentiable_mode(**cfg):
    if kind == "rollout":
      qvel0 = t("qvel0").requires_grad_(True)
      ctrl = t("ctrl0").requires_grad_(True) if f"{name}.ctrl0" in golden else None
      d = mjtpu_torch.replace(d, qpos=qpos0, qvel=qvel0)
      qpos, qvel = [], []
      for i in range(steps):
        if ctrl is not None:
          d = mjtpu_torch.replace(d, ctrl=ctrl[i])
        d = mjtpu_torch.step(m, d)
        qpos.append(d.qpos)
        qvel.append(d.qvel)
      q = d.qpos if entries is None else d.qpos[:, list(entries)]
      loss = torch.sum(q * q, dim=-1)
      loss.sum().backward()
      out.update(qpos=torch.stack(qpos), qvel=torch.stack(qvel), grad_qvel=qvel0.grad)
      if ctrl is not None:
        out["grad_ctrl"] = ctrl.grad
    else:
      offset = t("offset0").requires_grad_(True)
      cols = list(range(m.nq)) if entries is None else list(entries)
      sel = torch.zeros((len(cols), m.nq), dtype=m.dtype, device=device)
      sel[torch.arange(len(cols)), torch.as_tensor(cols)] = 1.0
      d = mjtpu_torch.fwd_position(m, mjtpu_torch.replace(d, qpos=qpos0 + offset @ sel))
      loss = torch.amin(d.contact.dist, dim=-1)
      loss.sum().backward()
      out["grad_offset"] = offset.grad
  out["loss"] = loss
  return {k: v.detach().cpu().numpy() for k, v in out.items()}


def diff_scene_errors(name, golden, device, got=None) -> dict:
  """A diff scene's values and gradients on ``device`` (or ``got``, a run
  of diff_scene_run) against mjtpu's jax.grad golden: "head" (the values
  at step 1, of their scale), "values" (every step and the loss, of their
  scale), and per gradient its error of the golden's max-abs; "finite"
  whether every gradient is finite."""
  import numpy as np

  got = got or diff_scene_run(name, golden, device)
  scaled = _scaled_err
  errs = {"finite": all(bool(np.isfinite(v).all()) for k, v in got.items()
                        if k.startswith("grad_"))}
  if "qpos" in got:
    errs["head"] = max(scaled(got[f][0], golden[f"{name}.{f}"][0]) for f in ("qpos", "qvel"))
    errs["values"] = max(scaled(got[f], golden[f"{name}.{f}"]) for f in ("qpos", "qvel", "loss"))
  else:
    errs["head"] = errs["values"] = scaled(got["loss"], golden[f"{name}.loss"])
  for k, v in got.items():
    if k.startswith("grad_"):
      want = golden[f"{name}.{k}"]
      errs[k] = float(_abs_err(v, want).max() / max(float(np.abs(want).max()), 1e-300))
  return errs


def chol_backward_error(n: int, dtype, batch: int, gen) -> float:
  """B1's backward (cholesky.CholSolve on the card: the kernel forward and
  backward) against autograd through its plain twin, on the same random
  SPD batch mat = sym(P) = (P + P^T) / 2 and right-hand sides g, of the
  loss sum(x * w) for a random w: the larger of the gradients' (P's and
  g's) max error over their max-abs."""
  import torch

  from mjtpu_torch.ops import cholesky

  mat, rhs = _spd(n, batch, dtype, gen)
  w = torch.randn(batch, n, dtype=dtype, device="cuda", generator=gen)
  grads = []
  for solve in (cholesky.CholSolve.apply, cholesky.chol_solve_reference):
    p = mat.clone().requires_grad_(True)
    g = rhs.clone().requires_grad_(True)
    x = solve((0.5 * (p + p.transpose(1, 2))).contiguous(), g)
    torch.sum(x * w).backward()
    grads.append((p.grad, g.grad))
  return max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(*grads))


def kernel_grad_refusals() -> dict:
  """For B2, B3 and B4: whether the wrapper raised on a CUDA input that
  requires grad while grad mode is on (a wrapper has no backward; the
  engine calls it through its differentiable seam)."""
  import numpy as np
  import torch

  from mjtpu_torch._src import mesh, sparse
  from mjtpu_torch.ops import hfield, ldl, sat

  gen = torch.Generator(device="cuda").manual_seed(4)
  t = sparse.device_tables(sparse._build(66, branchy_parentid(6, 10)), torch.float64, "cuda")
  mc, rhs, _ = chain_pattern_batch(t, 4, torch.float64, gen)
  box = sat.sat_hull(mesh.box(np.array([0.08, 0.08, 0.08])), torch.float64, "cuda")
  poses = _sat_poses("random", 4, box, box, torch.float64, gen)
  zwin, origin, a, b, r = _windows(4, 2, 2, True, torch.float64, gen)
  calls = {
      "ldl_factor": lambda: ldl.ldl_factor(t, mc.requires_grad_(True)),
      "sat_winners": lambda: sat.sat_winners_batch(poses[0].requires_grad_(True), *poses[1:],
                                                   box, box),
      "hfield_manifold": lambda: hfield.manifold_batch(zwin, origin, a.requires_grad_(True), b,
                                                       r, 2, 2, 1.29, 1.29, True),
  }
  raised = {}
  for name, call in calls.items():
    try:
      call()
      raised[name] = False
    except RuntimeError as e:
      raised[name] = "no backward" in str(e)
  return raised


def seam_grad_errors(device, dtype, batch: int, gen) -> dict:
  """B2's, B3's and B4's differentiable seams (ops.ldl's LdlFactorSolve,
  LdlSolve and ldl_factor_differentiable on the branchy66 tree, ops.sat's
  sat_winners_differentiable on random box poses, ops.hfield's
  manifold_differentiable on random windows) on ``device``: per seam, the
  gradient of sum(out * w) for a random w with respect to every float
  input, against autograd through the twin on the same inputs (the larger
  max error over the max-abs), and the kernel launches the seam made in
  its forward and in its backward: name -> (error, forward, backward)."""
  import numpy as np
  import torch

  from mjtpu_torch._src import mesh, sparse
  from mjtpu_torch.ops import hfield, ldl, sat

  t = sparse.device_tables(sparse._build(66, branchy_parentid(6, 10)), dtype, device)
  mc, rhs, _ = chain_pattern_batch(t, batch, dtype, gen)
  S = ldl.ldl_factor_reference(t, mc)
  box = sat.sat_hull(mesh.box(np.array([0.08, 0.08, 0.08])), dtype, device)
  poses = _sat_poses("random", batch, box, box, dtype, gen, device=device)
  win = _windows(batch, 2, 2, True, dtype, gen, device=device)
  hf = (2, 2, 1.29, 1.29, True)
  count = lambda key: lambda: ldl.launches[key]
  seams = {
      "ldl_factor_solve": (lambda mc, b: ldl.LdlFactorSolve.apply(t, mc, b),
                           lambda mc, b: ldl.ldl_factor_solve_reference(t, mc, b), (mc, rhs),
                           count("ldl_factor_solve")),
      "ldl_solve": (lambda s, b: ldl.LdlSolve.apply(t, s, b),
                    lambda s, b: ldl.ldl_solve_reference(t, s, b), (S, rhs), count("ldl_solve")),
      "ldl_factor": (lambda mc: ldl.ldl_factor_differentiable(t, mc),
                     lambda mc: ldl.ldl_factor_reference(t, mc), (mc,), count("ldl_factor")),
      "sat_winners": (lambda *p: sat.sat_winners_differentiable(*p, box, box)[0],
                      lambda *p: sat.sat_winners_reference(*p, box, box)[0], poses,
                      lambda: sat.launches),
      "hfield_manifold": (lambda *w: hfield.manifold_differentiable(*w, *hf),
                          lambda *w: hfield.manifold_reference(*w, *hf), win,
                          lambda: hfield.launches),
  }
  out = {}
  for name, (seam, twin, inputs, launches) in seams.items():
    grads, weights, counts = [], None, []
    for fn in (seam, twin):
      xs = [x.detach().clone().requires_grad_(True) for x in inputs]
      before = launches()
      y = fn(*xs)
      ys = y if isinstance(y, tuple) else (y,)
      fwd = launches() - before
      if weights is None:
        weights = [torch.randn(o.shape, dtype=dtype, device=device, generator=gen) for o in ys]
      loss = sum(torch.sum(torch.where(torch.isfinite(o), o, 0.0) * w) for o, w in zip(ys, weights))
      loss.backward()
      counts.append((fwd, launches() - before - fwd))
      grads.append([x.grad for x in xs])
    err = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))
              for a, b in zip(*grads))
    out[name] = (err, *counts[0])
  return out


def stepped_scene_errors(name: str, golden, device) -> dict:
  """A stepped scene (stepped_scenes.npz: hopper_bench, pendulum_implicit)
  stepped STEPPED_STEPS times at f64 from its golden's start on
  ``device``: qpos and qvel against mjtpu's, of their scale, and the
  inverse of the Data after each step against mjtpu's qfrc_inverse."""
  import torch

  import mjtpu_torch
  from mjtpu_torch._src import io

  m = mjtpu_torch.model_from_arrays(
      io.load_snapshot(mjtpu_torch.ASSETS / "stepped_scenes.npz", name), device=device)
  t = lambda k: torch.as_tensor(golden[f"{name}.{k}"], dtype=m.dtype, device=device)
  d = mjtpu_torch.replace(mjtpu_torch.make_data(m, batch_size=golden[f"{name}.qpos0"].shape[0]),
                          qpos=t("qpos0"), qvel=t("qvel0"), ctrl=t("ctrl0"))
  out = {"qpos": [], "qvel": [], "qfrc_inverse": []}
  for _ in range(golden[f"{name}.qpos"].shape[0]):
    d = mjtpu_torch.step(m, d)
    out["qpos"].append(d.qpos)
    out["qvel"].append(d.qvel)
    out["qfrc_inverse"].append(mjtpu_torch.inverse(m, d).qfrc_inverse)
  return {k: _scaled_err(torch.stack(v).cpu().numpy(), golden[f"{name}.{k}"])
          for k, v in out.items()}


def phase_slice16_parity():
  """Phase 34 (side): every diff scene under its differentiable_mode at
  f64 on the card against mjtpu's jax.grad golden (the values at step 1
  to DIFF_VALUE_HEAD_BOUND of scale, over the rollout to DIFF_VALUE_BOUND,
  the gradients to DIFF_GRAD_BOUND of their max-abs, all finite); B1's
  backward against the twin's autograd at n in DIFF_CHOL_NS, B=4096, f32
  and f64, to phase 3's tolerances; B2's, B3's and B4's wrappers refuse an
  input that requires grad, and their differentiable seams (the kernel
  forward) match the twin's autograd to the same tolerances
  (seam_grad_errors); the stepped scenes (hopper_bench, pendulum_implicit) at
  f64 against mjtpu to STEPPED_BOUND."""
  import numpy as np
  import torch

  import mjtpu_torch

  golden = np.load(mjtpu_torch.ASSETS / "diff_scenes_golden.npz")
  for name in DIFF_SCENES:
    errs = diff_scene_errors(name, golden, "cuda")
    grads = {k: v for k, v in errs.items() if k.startswith("grad_")}
    if not (errs["finite"] and errs["head"] <= DIFF_VALUE_HEAD_BOUND
            and errs["values"] <= DIFF_VALUE_BOUND
            and all(v <= DIFF_GRAD_BOUND for v in grads.values())):
      raise AssertionError(f"diff scene {name}: {errs}")
    log(f"[slice16 parity] diff {name}: values at step 1 {errs['head']:.3e} (bound"
        f" {DIFF_VALUE_HEAD_BOUND:g}), over the run {errs['values']:.3e} (bound"
        f" {DIFF_VALUE_BOUND:g}), gradients "
        + ", ".join(f"{k} {v:.3e}" for k, v in grads.items())
        + f" of their max-abs (bound {DIFF_GRAD_BOUND:g}), finite")
  gen = torch.Generator(device="cuda").manual_seed(5)
  tol = {torch.float32: 1e-4, torch.float64: 1e-10}
  for n in DIFF_CHOL_NS:
    for dtype in (torch.float32, torch.float64):
      err = chol_backward_error(n, dtype, BENCH_BATCH, gen)
      if err > tol[dtype]:
        raise AssertionError(f"B1 backward n={n} {dtype}: {err:.3e} > {tol[dtype]}")
      log(f"[slice16 parity] B1 backward (kernel forward and backward) against the twin's"
          f" autograd, n={n} B={BENCH_BATCH} {str(dtype)[6:]}: {err:.3e} of the gradients'"
          f" max-abs (bound {tol[dtype]:g})")
  raised = kernel_grad_refusals()
  if not all(raised.values()):
    raise AssertionError(f"a kernel wrapper took an input that requires grad: {raised}")
  log(f"[slice16 parity] B2's, B3's and B4's wrappers raise on an input that requires grad:"
      f" {raised}")
  # the seams' launches: the kernel once forward; B2's solves once more backward
  want = {"ldl_factor_solve": (1, 1), "ldl_solve": (1, 1), "ldl_factor": (1, 0),
          "sat_winners": (1, 0), "hfield_manifold": (1, 0)}
  for dtype in (torch.float32, torch.float64):
    errs = seam_grad_errors("cuda", dtype, BENCH_BATCH, gen)
    bad = {k: v for k, v in errs.items() if v[0] > tol[dtype] or v[1:] != want[k]}
    if bad:
      raise AssertionError(f"differentiable seams {dtype}: {bad} (launches want {want})")
    log(f"[slice16 parity] B2, B3 and B4's differentiable seams B={BENCH_BATCH}"
        f" {str(dtype)[6:]} against the twin's autograd (error of the gradients' max-abs,"
        f" bound {tol[dtype]:g}; kernel launches forward, backward): "
        + ", ".join(f"{k} {e:.3e} ({f}, {b})" for k, (e, f, b) in errs.items()))
  golden = np.load(mjtpu_torch.ASSETS / "stepped_scenes_golden.npz")
  for name in ("hopper_bench", "pendulum_implicit"):
    errs = stepped_scene_errors(name, golden, "cuda")
    if max(errs.values()) > STEPPED_BOUND:
      raise AssertionError(f"stepped scene {name}: {errs}")
    log(f"[slice16 parity] {name}: {golden[f'{name}.qpos'].shape[0]} steps against mjtpu, "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" of scale (bound {STEPPED_BOUND:g})")


def _diff_path(card):
  """Phase 35's main path: gradients of humanoid_bench rollouts at f32,
  B=4096, under differentiable_mode() with its defaults: DIFF_K steps from
  qpos0 +-0.01 with qvel and a ctrl sequence (DIFF_K, B, nu) uniform in
  [-1, 1] (numpy seed 1), the loss the sum of the final qpos^2, and
  loss.backward() for its gradients with respect to the initial qvel and
  every step's ctrl.  A one-step warm-up rollout, then DIFF_RUNS timed
  rollouts, each forward and backward by the host clock (synchronized),
  reported as the median with the least and the most; the first is the
  counted run (every kernel count set to 0 before its forward; B1
  register once a step in the forward, Newton 1 x 4 at its fixed count,
  and once a step in the backward).  B1 alone on the backward's inputs:
  each of the counted run's backward launches' inputs, kept as the
  backward made them, timed again on its own by cuda_ms (phase 3's
  method: back-to-back calls, warm L2), summed; it is the kernel's time
  alone, not its time inside the backward."""
  import statistics

  import numpy as np
  import torch

  import mjtpu_torch
  from mjtpu_torch.ops import cholesky

  m = mjtpu_torch.model_from_arrays(
      mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / "humanoid_bench_model.npz"),
      dtype=torch.float32, device="cuda")
  rng = np.random.default_rng(1)
  t = lambda x: torch.as_tensor(x, dtype=torch.float32, device="cuda")
  qpos = t(m.qpos0.cpu().numpy()[None] + rng.uniform(-0.01, 0.01, (BENCH_BATCH, m.nq)))
  qvel = t(rng.uniform(-1.0, 1.0, (BENCH_BATCH, m.nv)))
  ctrl = t(rng.uniform(-1.0, 1.0, (DIFF_K, BENCH_BATCH, m.nu)))

  def rollout(steps):
    qvel0, ctrls = qvel.clone().requires_grad_(True), ctrl.clone().requires_grad_(True)
    d = mjtpu_torch.replace(mjtpu_torch.make_data(m, BENCH_BATCH), qpos=qpos, qvel=qvel0)
    with mjtpu_torch.differentiable_mode():
      for i in range(steps):
        d = mjtpu_torch.step(m, mjtpu_torch.replace(d, ctrl=ctrls[i]))
    return torch.sum(d.qpos * d.qpos), qvel0, ctrls, d

  rollout(1)[0].backward()
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  solve, backward_inputs = cholesky.cholesky_solve, []
  walls = []
  for run in range(DIFF_RUNS):
    if run == 0:
      _zero_counts()
    t0 = time.perf_counter()
    loss, qvel0, ctrls, d = rollout(DIFF_K)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    if run == 0:
      forward = cholesky.launches
      cholesky.cholesky_solve = lambda mat, rhs, **kw: backward_inputs.append(
          (mat, rhs)) or solve(mat, rhs, **kw)
    try:
      loss.backward()
      torch.cuda.synchronize()
    finally:
      cholesky.cholesky_solve = solve
    t2 = time.perf_counter()
    walls.append((t1 - t0, t2 - t1))
    if run == 0:
      counts = _read_counts()
      backward = counts["chol_solve"] - forward
    bad = int((~torch.isfinite(qvel0.grad).all(dim=1)
               | ~torch.isfinite(ctrls.grad).all(dim=2).all(dim=0)).sum())
    if bad or not bool(torch.isfinite(d.qpos).all()) or int(d.nreset.sum()):
      raise AssertionError(f"diff humanoid_bench run {run}: {bad} envs with a gradient not"
                           f" finite, nreset {int(d.nreset.sum())}")
    del loss, qvel0, ctrls, d
  peak = torch.cuda.max_memory_allocated()
  if (counts != _only(chol_solve=2 * DIFF_K) or forward != DIFF_K
      or len(backward_inputs) != DIFF_K):
    raise AssertionError(f"diff humanoid_bench: launches {counts}, {forward} in the forward")
  b1_ms = sum(cuda_ms(lambda a=a, b=b: solve(a, b)) for a, b in backward_inputs)
  med = lambda xs: statistics.median(xs)
  fwd_s, bwd_s = med([f for f, _ in walls]), med([b for _, b in walls])
  totals = [f + b for f, b in walls]
  rate = BENCH_BATCH * DIFF_K / med(totals)
  rates = sorted(BENCH_BATCH * DIFF_K / x for x in totals)
  line = (f"f32 B={BENCH_BATCH} K={DIFF_K}, {DIFF_RUNS} runs (host clock, synchronized):"
          f" forward median {fwd_s:.3f} s, backward median {bwd_s:.3f} s, together median"
          f" {med(totals):.3f} s (least {min(totals):.3f}, most {max(totals):.3f}) ="
          f" {rate:.0f} env-steps/s forward and backward together (runs {rates[0]:.0f} to"
          f" {rates[-1]:.0f}); B1 register (n={m.nv}) launches {forward} in the forward,"
          f" {backward} in the backward; B1 alone on the backward's {len(backward_inputs)}"
          f" inputs, timed again {b1_ms:.4f} ms in all ({TIMING}); peak memory"
          f" {peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated); envs with a gradient"
          f" not finite 0 in every run; card {card}")
  figures = {"launches_forward": forward, "launches_backward": backward,
             "b1_alone_on_backward_inputs_ms": b1_ms, "forward_s": fwd_s, "backward_s": bwd_s,
             "total_s_runs": totals, "env_steps_per_s": rate, "peak_memory_bytes": peak}
  return line, counts, figures


def phase_slice16_throughput(card):
  """Phase 35: gradients of humanoid_bench rollouts (the differentiable
  main path): (its launch counts, its B1 figures)."""
  line, counts, figures = _diff_path(card)
  log(f"[slice16 throughput] humanoid_bench gradients under differentiable_mode() {line}")
  return counts, figures


RENDER_BOUND = 1e-10        # rgb and depth against mjtpu's at f64, where seg agrees
RENDER_TIE_COPIES = 64     # copies of a pixel's rays that may resolve a tie ...
RENDER_TIE_ULPS = 4        # ... each component moved by up to this many ULP
PIXEL_ENVS = ("humanoid", "satellite_small")
PIXEL_WARMUP = 2
PIXEL_TIMED = 3
RENDER_TIMED = 5
# the f32 card render of the main path's envs against the f64 one of the
# same states: the share of seg pixels that differ and the largest rgb
# difference where seg agrees
RENDER_F32_ENVS = 8


def ulp_ray_copies(vec, copies: int, ulps: int, seed: int = 0):
  """``copies`` copies of the rays ``vec`` (S, 3), each component moved
  by a whole number of ULP drawn from [-ulps, ulps] (numpy seed):
  (copies, S, 3)."""
  import numpy as np
  import torch

  shift = np.random.default_rng(seed).integers(-ulps, ulps + 1, (copies,) + tuple(vec.shape))
  mag = torch.abs(vec)
  ulp = torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag
  return vec + torch.as_tensor(shift, dtype=vec.dtype, device=vec.device) * ulp


def render_view_errors(m, d, rd, want, camera: int = 0, options=None, got=None) -> dict:
  """render_rgbd of every env of ``d`` (or ``got``, its (rgb, depth,
  seg)) against mjtpu's ``want`` (rgb, depth, seg as numpy): the largest
  rgb and depth errors where seg agrees and both are within RENDER_BOUND,
  and the pixels past that (seg differs, or rgb or depth past the bound),
  each of which must be a tie: one of RENDER_TIE_COPIES copies of its rays
  a few ULP away (ulp_ray_copies) gives mjtpu's seg, rgb and depth.
  Fails on a pixel no copy resolves."""
  import numpy as np
  import torch

  from mjtpu_torch._src import render
  from mjtpu_torch._src.dataclasses import map_tensors

  options = dict(options or {})
  want_rgb, want_depth, want_seg = want
  height, width = want_seg.shape[1:]
  if got is None:
    got = render.render_rgbd(m, d, width=width, height=height, camera=camera, rd=rd, **options)
  rgb, depth, seg = (x.cpu().numpy() for x in got)
  err_rgb = np.abs(rgb - want_rgb).max(-1)
  err_depth = np.abs(depth - want_depth)
  ok = (seg == want_seg) & (err_rgb <= RENDER_BOUND) & (err_depth <= RENDER_BOUND)
  ssaa = options.pop("ssaa", 1)
  out = {"rgb": float(err_rgb[ok].max(initial=0.0)), "depth": float(err_depth[ok].max(initial=0.0)),
         "seg_diff": int((seg != want_seg).sum()), "ties": int((~ok).sum()), "pixels": ok.size}
  if ok.all():
    return out
  vec = render.camera_rays(m, d, rd, camera, width, height, ssaa)
  row = width * ssaa
  samples = ssaa * ssaa
  centre = (ssaa // 2) * ssaa + ssaa // 2
  for b, y, x in np.argwhere(~ok):
    idx = [(y * ssaa + i) * row + x * ssaa + j for i in range(ssaa) for j in range(ssaa)]
    rays = ulp_ray_copies(vec[b, idx], RENDER_TIE_COPIES, RENDER_TIE_ULPS,
                          seed=int((b * height + y) * width + x))
    one = map_tensors(d, lambda t: t[b:b + 1])
    c_rgb, c_depth, c_seg = render.shade_rays(
        m, one, rd, one.cam_xpos[:, camera], rays.reshape(1, -1, 3), **options)
    c_rgb, c_depth = c_rgb.reshape(-1, samples, 3), c_depth.reshape(-1, samples)
    if samples > 1:  # render.reduce_samples' order of the sums
      c_rgb = sum(c_rgb[:, k] for k in range(samples)) / samples
      c_depth = sum(c_depth[:, k] for k in range(samples)) / samples
    else:
      c_rgb, c_depth = c_rgb[:, 0], c_depth[:, 0]
    c_seg = c_seg.reshape(-1, samples)[:, centre]
    match = ((c_seg.cpu().numpy() == want_seg[b, y, x])
             & (np.abs(c_rgb.cpu().numpy() - want_rgb[b, y, x]).max(-1) <= RENDER_BOUND)
             & (np.abs(c_depth.cpu().numpy() - want_depth[b, y, x]) <= RENDER_BOUND))
    if not match.any():
      raise AssertionError(
          f"pixel (env {b}, row {y}, column {x}): seg {seg[b, y, x]} rgb {rgb[b, y, x]} depth"
          f" {depth[b, y, x]} against mjtpu's {want_seg[b, y, x]} {want_rgb[b, y, x]}"
          f" {want_depth[b, y, x]}, and no copy of its rays {RENDER_TIE_ULPS} ULP away gives"
          " mjtpu's")
  return out


def render_scene(name: str, golden, device, dtype=None):
  """(Model, Data after forward, RenderData) of a scene of
  render_scenes.npz at the golden's qpos; the single-square skybox's image
  put into the RenderData as mjtpu's golden put it."""
  import dataclasses

  import torch

  import mjtpu_torch

  m = _bundle_model("render_scenes", name, device, dtype)
  qpos = torch.as_tensor(golden[f"{name}.qpos"], dtype=m.dtype, device=device)
  d = mjtpu_torch.make_data(m, batch_size=qpos.shape[0])
  d = mjtpu_torch.forward(m, mjtpu_torch.replace(d, qpos=qpos))
  rd = mjtpu_torch.precompute_render_data(m)
  if f"{name}.sky_tex" in golden:
    rd = dataclasses.replace(rd, sky_tex=golden[f"{name}.sky_tex"])
  return m, d, rd


def render_views(golden) -> list:
  """The golden's views: [scene, label, camera, options] each."""
  return json.loads(golden["views"].tobytes())


def render_scene_errors(name: str, golden, device) -> dict:
  """Every view of render scene ``name`` at f64 against mjtpu's golden
  (render_view_errors): "<label>.cam<c>" -> its errors."""
  m, d, rd = render_scene(name, golden, device)
  out = {}
  for scene, label, cam, options in render_views(golden):
    if scene == name:
      key = f"{name}.{label}.cam{cam}"
      want = tuple(golden[f"{key}.{k}"] for k in ("rgb", "depth", "seg"))
      out[f"{label}.cam{cam}"] = render_view_errors(m, d, rd, want, cam, options)
  return out


def pixel_env_errors(name: str, golden, device) -> dict:
  """``zoo.ENVS[name](pixel_obs=True)`` at f64 from the pixel env golden's
  states through its actions (as _env_golden_err): the pixels of the start
  (every env) and of each env step (envs 0-2: env 3 restarts from mjtpu's
  PRNG after its first step) against mjtpu's (render_view_errors, the
  env's own pixels with the depth and seg of a render of the same Data,
  whose rgb must be the env's pixels bit for bit); obs and reward to
  ENV_BOUND, done and steps exact.  Returns {"obs_reward": err, "pixels":
  [each step's render_view_errors]}."""
  import dataclasses

  import numpy as np
  import torch

  import mjtpu_torch
  from mjtpu_torch import zoo
  from mjtpu_torch._src import render
  from mjtpu_torch._src.dataclasses import map_tensors

  size = tuple(int(x) for x in golden[f"{name}.pixels"].shape[2:4])
  env = zoo.ENVS[name](dtype=torch.float64, device=device, pixel_obs=True, pixel_size=size)
  m = env.model
  t = lambda x: torch.as_tensor(x, device=device)
  d = mjtpu_torch.make_data(m, batch_size=golden[f"{name}.qpos0"].shape[0])
  d = mjtpu_torch.replace(d, qpos=t(golden[f"{name}.qpos0"]), qvel=t(golden[f"{name}.qvel0"]))
  state = dataclasses.replace(env._init_state(mjtpu_torch.forward(m, d)),
                              steps=t(golden[f"{name}.steps0"]))
  gen = torch.Generator(device=device).manual_seed(0)
  err, pixels = 0.0, []
  actions = golden[f"{name}.action"]
  for step in range(actions.shape[0] + 1):
    if step:
      state = env.step(state, t(actions[step - 1]), gen)
      live = 4 if step == 1 else 3
      for k, n in (("obs", 3), ("reward", live)):
        got = getattr(state, k)[:n].cpu().numpy()
        err = max(err, float(np.abs(got - golden[f"{name}.{k}"][step][:n]).max()))
      for k in ("done", "steps"):
        if not np.array_equal(getattr(state, k)[:live].cpu().numpy(),
                              golden[f"{name}.{k}"][step][:live]):
          raise AssertionError(f"{name} env step {step} {k}: {getattr(state, k).tolist()}")
    n = 4 if step == 0 else 3
    data = map_tensors(state.data, lambda x: x[:n])
    rgb, depth, seg = render.render_rgbd(m, data, width=size[1], height=size[0], camera=0,
                                         rd=env._render_data)
    if not torch.equal(rgb, state.pixels[:n]):
      raise AssertionError(f"{name} env step {step}: State.pixels is not camera 0's render")
    want = tuple(golden[f"{name}.{k}"][step][:n] for k in ("pixels", "depth", "seg"))
    pixels.append(render_view_errors(m, data, env._render_data, want,
                                     got=(state.pixels[:n], depth, seg)))
  if not err <= ENV_BOUND:
    raise AssertionError(f"{name}: obs or reward differ from mjtpu's env by {err:.3e}")
  return {"obs_reward": err, "pixels": pixels}


def phase_slice17_parity():
  """Phase 36: every view of the render scenes and the pixel envs at f64
  on the card against mjtpu's goldens, to the CPU tests' bounds."""
  import numpy as np

  import mjtpu_torch
  from mjtpu_torch._src import io

  golden = dict(np.load(mjtpu_torch.ASSETS / "render_scenes_golden.npz"))
  scenes = io.bundle_names(mjtpu_torch.ASSETS / "render_scenes.npz")
  errs = {name: render_scene_errors(name, golden, "cuda") for name in scenes}
  views = [e for per in errs.values() for e in per.values()]
  log(f"[slice17 parity] {len(scenes)} render scenes, {len(views)} views, f64 B=2 on the card"
      f" against mjtpu's jit(render_batch_rgbd): max abs err where seg agrees rgb"
      f" {max(e['rgb'] for e in views):.3e}, depth {max(e['depth'] for e in views):.3e}"
      f" (limit {RENDER_BOUND}); pixels past it {sum(e['ties'] for e in views)} of"
      f" {sum(e['pixels'] for e in views)} (seg differs at"
      f" {sum(e['seg_diff'] for e in views)}), each a tie that a copy of its rays"
      f" {RENDER_TIE_ULPS} ULP away resolves to mjtpu's pick")
  pixel_golden = dict(np.load(mjtpu_torch.ASSETS / "pixel_env_golden.npz"))
  for name in PIXEL_ENVS:
    e = pixel_env_errors(name, pixel_golden, "cuda")
    px = e["pixels"]
    log(f"[slice17 parity] {name} env, pixel_obs=True, f64 B=4, the start and"
        f" {len(px) - 1} env steps against mjtpu's: obs and reward {e['obs_reward']:.3e}"
        f" (limit {ENV_BOUND}); pixels rgb {max(x['rgb'] for x in px):.3e}, depth"
        f" {max(x['depth'] for x in px):.3e} where seg agrees, ties"
        f" {sum(x['ties'] for x in px)} of {sum(x['pixels'] for x in px)}")


def _pixel_env_run(env, seed: int = 0, counted: bool = False):
  """``env`` at f32 B=4096 from its reset (a torch.Generator seeded
  ``seed``), PIXEL_WARMUP warm-up and PIXEL_TIMED timed env steps
  with actions uniform in [-1, 1] (host clock, synchronized; the peak
  memory of the timed steps); with ``counted`` every kernel count set to
  0 just before the timed steps and read just after.  Returns (state,
  secs, counts or None, Newton loops, peak bytes)."""
  import torch

  from mjtpu_torch._src import solver

  batch = BENCH_BATCH
  gen = torch.Generator(device="cuda").manual_seed(seed)
  act = lambda: 2.0 * torch.rand(batch, env.action_size, generator=gen, device="cuda") - 1.0
  state = env.reset(batch, gen)
  for _ in range(PIXEL_WARMUP):
    state = env.step(state, act(), gen)
  actions = [act() for _ in range(PIXEL_TIMED)]
  nreset = torch.zeros((), dtype=torch.int64, device="cuda")
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  if counted:
    _zero_counts()
  loops = dict(solver.loop_counts)
  t0 = time.perf_counter()
  for a in actions:
    state = env.step(state, a, gen)
    nreset += state.data.nreset.sum()
  torch.cuda.synchronize()
  secs = time.perf_counter() - t0
  counts = _read_counts() if counted else None
  loops = {k: solver.loop_counts[k] - loops[k] for k in loops}
  if not bool(torch.isfinite(state.data.qpos).all()) or int(nreset):
    raise AssertionError(f"{env.name} env run not finite or reset: nreset {int(nreset)}")
  return state, secs, counts, loops, torch.cuda.max_memory_allocated()


def _pixel_path(card):
  """Phase 37's main path: the humanoid env with pixel observations
  (ENVS["humanoid"](pixel_obs=True): f32 on the card, camera 0 the
  injected observer camera, 64 x 64) at B=4096, beside the same env
  without pixels; then render_batch_rgbd alone on its states: RENDER_TIMED
  calls (host clock, synchronized), the peak memory of a call, one call
  under torch.profiler; and the f32 render of RENDER_F32_ENVS envs against
  the f64 one of the same frames."""
  import statistics

  import numpy as np
  import torch

  from mjtpu_torch import zoo
  from mjtpu_torch._src import render
  from mjtpu_torch._src.dataclasses import map_tensors

  env = zoo.ENVS["humanoid"](pixel_obs=True)
  if env.model.dtype != torch.float32 or env.device.type != "cuda" or env.pixel_size != (64, 64):
    raise AssertionError(f"the pixel env built at {env.model.dtype} on {env.device},"
                         f" {env.pixel_size}")
  state, secs, counts, loops, step_peak = _pixel_env_run(env, counted=True)
  if counts != _only(chol_solve=loops["iterations"]) or not counts["chol_solve"]:
    raise AssertionError(f"pixel env: kernel launches in {PIXEL_TIMED} env steps: {counts},"
                         f" Newton {loops}")
  pixels = state.pixels
  if (tuple(pixels.shape) != (BENCH_BATCH, 64, 64, 3) or not bool(torch.isfinite(pixels).all())
      or float(pixels.min()) < 0.0 or float(pixels.max()) > 1.0):
    raise AssertionError(f"pixel env: pixels {tuple(pixels.shape)} not finite in [0, 1]")
  advance = lambda s: env.step(s, torch.zeros(BENCH_BATCH, env.action_size, device="cuda"),
                               torch.Generator(device="cuda").manual_seed(1))
  shares, step_ms = _seam_shares(env.model, state, 1, advance=advance)
  if shares["chol_ns"] != {env.model.nv}:
    raise AssertionError(f"Cholesky launches at n={shares['chol_ns']}, not {env.model.nv}")
  plain = zoo.ENVS["humanoid"]()
  _, plain_secs, _, plain_loops, plain_peak = _pixel_env_run(plain)
  del plain

  m, d, rd = env.model, state.data, env._render_data
  call = lambda dd: render.render_batch_rgbd(m, dd, width=64, height=64, rd=rd)
  rgb, depth, seg = call(d)
  ids = set(np.unique(seg.cpu().numpy()).tolist())
  if not ids <= {-1, *rd.geom_ids} or not bool(torch.equal(rgb, pixels)):
    raise AssertionError(f"render_batch_rgbd: seg ids {ids}, or its rgb is not the pixels")
  hit = float((seg >= 0).float().mean())
  torch.cuda.synchronize()
  base = torch.cuda.memory_allocated()
  torch.cuda.reset_peak_memory_stats()
  walls = []
  for _ in range(RENDER_TIMED):
    t0 = time.perf_counter()
    call(d)
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
  render_peak = torch.cuda.max_memory_allocated() - base
  busy, launches = _busy_share(call, d)
  # one more call with CUDA events around the renderer's stages: the rays,
  # the nearest-hit loops (camera and shadow rays), within them the
  # winners' normals and albedo
  stages = {"camera_rays": (render, "camera_rays"), "trace": (render, "_trace"),
            "shade_hit": (render, "_shade_hit")}
  stage_ms, render_ms = _seam_shares(m, d, 1, advance=call, extra=stages)
  stage_ms = {k: stage_ms[k] for k in stages}

  # the f32 renderer against f64 on the same frames (Data cast to f64)
  env64 = zoo.ENVS["humanoid"](dtype=torch.float64, pixel_obs=True)
  few = map_tensors(d, lambda x: x[:RENDER_F32_ENVS])
  few64 = map_tensors(few, lambda x: x.double() if x.is_floating_point() else x)
  r32 = render.render_batch_rgbd(m, few, width=64, height=64, rd=rd)
  r64 = render.render_batch_rgbd(env64.model, few64, width=64, height=64,
                                 rd=env64._render_data)
  same = r32[2] == r64[2]
  seg_share = float((~same).float().mean())
  rgb_err = float((r32[0].double() - r64[0]).abs().amax(-1)[same].max())
  med = statistics.median(walls)
  figures = {
      "env_steps_per_s": BENCH_BATCH * PIXEL_TIMED / secs,
      "env_steps_per_s_no_pixels": BENCH_BATCH * PIXEL_TIMED / plain_secs,
      "ms_per_env_step": 1e3 * secs / PIXEL_TIMED,
      "ms_per_env_step_no_pixels": 1e3 * plain_secs / PIXEL_TIMED,
      "render_ms": [1e3 * w for w in walls], "render_launches": launches,
      "render_device_ms": render_ms, "render_stage_ms": stage_ms,
      "render_busy": busy, "render_peak_bytes": render_peak, "step_peak_bytes": step_peak,
      "step_peak_bytes_no_pixels": plain_peak, "b1_launches_per_env_step":
      counts["chol_solve"] / PIXEL_TIMED, "f32_seg_share": seg_share,
      "f32_rgb_err": rgb_err}
  line = (f"f32 B={BENCH_BATCH} 64 x 64, {PIXEL_WARMUP} warm-up and {PIXEL_TIMED} timed env"
          f" steps (host clock, synchronized): with pixels {figures['env_steps_per_s']:.0f} env"
          f" steps/s ({figures['ms_per_env_step']:.3f} ms an env step), without"
          f" {figures['env_steps_per_s_no_pixels']:.0f} ({figures['ms_per_env_step_no_pixels']:.3f}"
          f" ms); B1 register (n={m.nv}) launches per env step"
          f" {figures['b1_launches_per_env_step']:.2f} (Newton"
          f" {loops['iterations'] / (PIXEL_TIMED * env.frame_skip):.2f} iterations a physics"
          f" step), B1 {shares['chol_solve']:.4f} ms of a {step_ms:.3f} ms device env step;"
          f" nreset 0; peak memory {step_peak / 2**30:.2f} GiB with pixels,"
          f" {plain_peak / 2**30:.2f} GiB without; render_batch_rgbd alone {RENDER_TIMED} calls:"
          f" median {1e3 * med:.3f} ms (least {1e3 * min(walls):.3f}, most"
          f" {1e3 * max(walls):.3f}), {launches} kernel launches and device busy"
          f" {100 * busy:.1f}% of one profiled call, peak {render_peak / 2**30:.2f} GiB over its"
          f" inputs, {100 * hit:.1f}% of pixels hit a geom; one call by CUDA events"
          f" {render_ms:.3f} ms: rays {stage_ms['camera_rays']:.3f}, nearest-hit loops"
          f" {stage_ms['trace']:.3f} (of it the winners' normals and albedo"
          f" {stage_ms['shade_hit']:.3f}), the rest (shading, sky, reduction)"
          f" {render_ms - stage_ms['camera_rays'] - stage_ms['trace']:.3f}; f32 against f64 on"
          f" {RENDER_F32_ENVS} envs' frames: seg differs at {100 * seg_share:.4f}% of pixels,"
          f" rgb {rgb_err:.3e} where seg agrees; card {card}")
  return line, counts, figures


def phase_slice17_throughput(card):
  """Phase 37: the humanoid env with pixel observations (the render
  slice's main path): (its launch counts, its figures)."""
  line, counts, figures = _pixel_path(card)
  log(f"[slice17 throughput] humanoid env with pixel_obs=True {line}")
  return counts, figures


# the model_grad scenes (model_grad_scenes_golden.npz): each
# randomize_fields scene with its rows as the point of the gradient, name
# -> (steps of the loss, (iterations, ls_iterations) of its solver: under
# differentiable_mode every round runs, so the scenes that default to 100
# x 50 run at DIFF_SOLVER_BOUNDS-like bounds; humanoid_bench at its own)
MODEL_GRAD_SCENES = {
    "fields": (3, (2, 4)), "sensing": (3, (2, 4)), "friction": (3, (2, 4)),
    "elliptic": (3, (2, 4)), "slidercrank": (3, (2, 4)), "terrain": (3, (2, 4)),
    "cartpole_gear": (3, (2, 4)), "humanoid_bench": (4, (1, 4)), "humanoid_terrain": (2, (2, 4)),
}
# humanoid_bench's unbatched base-Model fields (one tensor shared by the
# batch), the starts of its randomize_fields scene, MODEL_GRAD_BASE_STEPS
MODEL_GRAD_BASE = "bench_base"
MODEL_GRAD_BASE_FIELDS = ("body_mass", "geom_friction", "dof_damping", "actuator_gainprm",
                          "opt.timestep")
MODEL_GRAD_BASE_STEPS = 4
# a port gradient where mjtpu's is not finite (ROADMAP C22) against central
# differences of the port's own loss in one direction over those entries
# (model_grad_fd_error): tests/test_diff.py's rtol
MODEL_GRAD_FD_RTOL = 1e-4
# ... but for the fields that place a contact's detection: where a margin
# crosses a contact's distance the loss jumps (the contact is detected, its
# rows live), and a difference measures the jump (the sensing scene's
# ball2 rests at its pair's margin)
MODEL_GRAD_FD_SKIP = ("geom_margin", "geom_gap", "pair_margin", "pair_gap")
# ... and, held to one-sided differences, the fields that move the fields
# scene's muscle activation across its ctrl: the activation lands on its
# ctrl after one step, the next step picks its time constant by a where at
# that tie, and the loss has a kink along them
MODEL_GRAD_FD_TIE = ("actuator_dynprm", "opt.timestep")
# the system-identification path (phase 38): humanoid_bench at f32,
# BENCH_BATCH envs, SYSID_K steps a rollout, SYSID_STEPS Adam steps on
# these per-env rows from seeded perturbations of the reference rows
SYSID_FIELDS = ("body_mass", "dof_damping", "dof_armature", "jnt_stiffness", "geom_friction",
                "jnt_solref", "actuator_gainprm")
SYSID_K = 8
SYSID_STEPS = 3
SYSID_LR = 0.01  # Adam's step, of each field's largest reference magnitude


def model_grad_loss(d):
  """(B,) the model_grad scenes' loss term of one step: the sum over every
  FIELD_OUTPUTS field of each env of (x + 1)^2 (the offset keeps a
  gradient to unit vectors and frames, whose squares sum to a constant)."""
  import torch

  return sum(torch.sum((getattr(d, o).reshape(d.qpos.shape[0], -1) + 1.0) ** 2, dim=1)
             for o in FIELD_OUTPUTS)


def model_grad_scene_run(name, golden, device, dtype=None, backward=True, cfg=None) -> dict:
  """One model_grad scene through the port under differentiable_mode()
  from the golden's start: each of its fields as leaf tensors that
  require grad (a randomize_fields scene's rows through
  parallel.randomize; ``MODEL_GRAD_BASE``'s unbatched fields through
  replace_fields), its steps, the loss summed over the steps of
  model_grad_loss, and loss.sum().backward(); ``cfg`` (a dict) overrides
  the mode's defaults.  Returns numpy arrays: "loss"
  (B,), "qpos" (steps, B, nq) and "grad.<field>" (None where the port
  leaves a field without a gradient, which must then be zero in mjtpu's)."""
  import torch

  import mjtpu_torch
  from mjtpu_torch import parallel
  from mjtpu_torch._src.types import field, replace_fields

  scene = "humanoid_bench" if name == MODEL_GRAD_BASE else name
  m = _bundle_model("randomize_fields", scene, device, dtype)
  it, ls = (int(x) for x in golden[f"{name}.solver"])
  m = replace_fields(m, {"opt.iterations": it, "opt.ls_iterations": ls})
  t = lambda x: torch.as_tensor(x, dtype=m.dtype, device=device)
  if name == MODEL_GRAD_BASE:
    leaves = {k: field(m, k).detach().clone().requires_grad_(True) for k in MODEL_GRAD_BASE_FIELDS}
    mg = replace_fields(m, leaves)
  else:
    leaves = {k: t(v).requires_grad_(True) for k, v in _rows(golden, f"{name}.rows.", m).items()}
    mg, _ = parallel.randomize(m, leaves)
  start = {k[len(name) + 1:-1]: golden[k] for k in golden.files
           if k.startswith(f"{name}.") and k.count(".") == 1 and k.endswith("0")}
  batch = golden[f"{name}.loss"].shape[0]
  d = mjtpu_torch.replace(mjtpu_torch.make_data(mg, batch), **{k: t(v) for k, v in start.items()})
  loss, qpos = 0.0, []
  with mjtpu_torch.differentiable_mode(**(cfg or {})):
    for _ in range(int(golden[f"{name}.steps"])):
      d = mjtpu_torch.step(mg, d)
      loss = loss + model_grad_loss(d)
      qpos.append(d.qpos)
  if backward and loss.requires_grad:
    # (no field reaches the loss where each is one mjtpu ignores: gear on
    # a baked moment matrix, ROADMAP C19; every gradient is then None)
    loss.sum().backward()
  out = {"loss": loss, "qpos": torch.stack(qpos)}
  out = {k: v.detach().cpu().numpy() for k, v in out.items()}
  out.update({f"grad.{k}": None if v.grad is None else v.grad.cpu().numpy()
              for k, v in leaves.items()})
  return out


def model_grad_scene_errors(name, golden, device, got=None) -> dict:
  """A model_grad scene on ``device`` (or ``got``, a run of
  model_grad_scene_run) against mjtpu's golden: "head" the qpos at step 1
  and "values" every step's qpos and the loss, of their scale; "grads"
  each field's gradient error over the golden's max-abs, or, where mjtpu's
  is zero throughout, the port's max-abs (zero where the port gives none),
  both over the entries where mjtpu's gradient is finite (0 where none
  is); "mjtpu_nonfinite"
  the count of the others (ROADMAP C22: mjtpu's NaN gradients, which the
  port's model_grad_fd_error holds instead); "finite" whether every
  gradient of the port is finite; "zero" the fields whose gradient mjtpu
  leaves at zero."""
  import numpy as np

  got = got or model_grad_scene_run(name, golden, device)
  errs = {"head": _scaled_err(got["qpos"][0], golden[f"{name}.qpos"][0]),
          "values": max(_scaled_err(got[k], golden[f"{name}.{k}"]) for k in ("qpos", "loss")),
          "grads": {}, "zero": [], "finite": True, "mjtpu_nonfinite": 0}
  for k in golden.files:
    if not k.startswith(f"{name}.grad."):
      continue
    f = k[len(f"{name}.grad."):]
    want, port = golden[k], got.get(f"grad.{f}")
    if f"grad.{f}" not in got:
      raise AssertionError(f"model_grad {name}: the port took no field {f}")
    port = np.zeros_like(want) if port is None else port
    errs["finite"] &= bool(np.isfinite(port).all())
    live = np.isfinite(want)
    errs["mjtpu_nonfinite"] += int((~live).sum())
    want, port = np.where(live, want, 0.0), np.where(live, port, 0.0)
    scale = float(np.abs(want).max())
    if not live.any():
      errs["grads"][f] = 0.0  # no finite entry of mjtpu's to hold it to
    elif scale == 0.0:
      errs["zero"].append(f)
      errs["grads"][f] = float(np.abs(port).max())
    else:
      errs["grads"][f] = float(_abs_err(port, want).max()) / scale
  return errs


def model_grad_fd_error(name, golden, device, eps: float = 1e-6) -> dict:
  """Where mjtpu's gradient is not finite (ROADMAP C22), the port's held to
  its own loss L (the summed loss of model_grad_scene_run, under
  differentiable_mode(cfd=False): contacts from distance take a
  straight-through gradient, which differences of the values cannot see)
  along two directions over those entries (numpy seed 0, normal, times
  each entry's magnitude; MODEL_GRAD_FD_SKIP's fields left out):
  "smooth" over every other field but MODEL_GRAD_FD_TIE's, the error
  |grad . v - fd| over |grad . v| with fd = (L(x + eps v) - L(x - eps v))
  / (2 eps); "tie" over MODEL_GRAD_FD_TIE's fields, where the loss has a
  kink, the error of grad . v against the nearer of its one-sided
  differences (the slope of the branch the port takes).  Each must be
  within MODEL_GRAD_FD_RTOL.  The directions a scene has no entry for are
  left out: {} where mjtpu's gradient is finite throughout."""
  import numpy as np

  rows = {k[len(f"{name}.rows."):]: golden[k] for k in golden.files
          if k.startswith(f"{name}.rows.")}
  rng = np.random.default_rng(0)
  v = {f: rng.standard_normal(x.shape) * np.abs(x) * ~np.isfinite(golden[f"{name}.grad.{f}"])
       for f, x in rows.items() if f not in MODEL_GRAD_FD_SKIP}
  dirs = {kind: {f: x for f, x in v.items() if (f in MODEL_GRAD_FD_TIE) == (kind == "tie")}
          for kind in ("smooth", "tie")}
  dirs = {kind: d for kind, d in dirs.items() if any(np.any(x) for x in d.values())}
  if not dirs:
    return {}
  cfg = {"cfd": False}
  got = model_grad_scene_run(name, golden, device, cfg=cfg)
  loss0 = got["loss"]
  errs = {}
  for kind, d in dirs.items():
    # (B,) each env's slope and losses: an env's loss reads its own rows only
    slope = sum(np.sum((got[f"grad.{f}"] * d[f]).reshape(len(loss0), -1), axis=1) for f in d
                if got[f"grad.{f}"] is not None)
    loss = {0: loss0}
    for sign in (1, -1):
      moved = {k: golden[k] for k in golden.files}
      moved.update({f"{name}.rows.{f}": rows[f] + sign * eps * d[f] for f in d})
      loss[sign] = model_grad_scene_run(name, _Files(moved), device, backward=False,
                                        cfg=cfg)["loss"]
    if kind == "smooth":
      fd = np.sum(loss[1] - loss[-1]) / (2 * eps)
      errs[kind] = float(abs(np.sum(slope) - fd) / max(abs(np.sum(slope)), 1e-300))
    else:
      # each env's kink on its own side of its tie: the nearer one-sided
      # difference, env by env
      err = np.minimum(np.abs(slope - (loss[1] - loss[0]) / eps),
                       np.abs(slope - (loss[0] - loss[-1]) / eps))
      envs = sum(np.any(d[f].reshape(len(loss0), -1) != 0, axis=1) for f in d) > 0
      errs[kind] = float(np.max(err[envs] / np.maximum(np.abs(slope[envs]), 1e-300)))
  return errs


class _Files(dict):
  """A dict of arrays read as an npz file (``.files``)."""

  @property
  def files(self):
    return list(self)


def model_grad_ok(errs: dict) -> bool:
  """A model_grad scene's errors within the diff scenes' bounds: values
  at step 1 DIFF_VALUE_HEAD_BOUND, over the run DIFF_VALUE_BOUND, each
  gradient DIFF_GRAD_BOUND of its max-abs, a gradient mjtpu leaves at zero
  zero, all finite."""
  return (errs["finite"] and errs["head"] <= DIFF_VALUE_HEAD_BOUND
          and errs["values"] <= DIFF_VALUE_BOUND
          and all(v == 0.0 if f in errs["zero"] else v <= DIFF_GRAD_BOUND
                  for f, v in errs["grads"].items()))


def phase_slice19_parity():
  """Phase 38-parity (side): every model_grad scene at f64 on the card
  against mjtpu's jax.grad golden (model_grad_ok), through the kernels:
  B1 in every solve and its backward, B4 forward with the twin's gradient
  to each env's hfield_data rows on the height-field scenes, B3 where a
  scene's hulls take it; each scene's launches, and on the height-field
  scenes the hfield_data gradient nonzero where mjtpu's is."""
  import numpy as np

  import mjtpu_torch
  from mjtpu_torch.ops import cholesky, hfield, sat

  golden = np.load(mjtpu_torch.ASSETS / "model_grad_scenes_golden.npz")
  for name in (*MODEL_GRAD_SCENES, MODEL_GRAD_BASE):
    _zero_counts()
    got = model_grad_scene_run(name, golden, "cuda")
    launches = {"chol_solve": cholesky.launches, "hfield_manifold": hfield.launches,
                "sat_winners": sat.launches}
    errs = model_grad_scene_errors(name, golden, "cuda", got=got)
    fd = model_grad_fd_error(name, golden, "cuda") if errs["mjtpu_nonfinite"] else {}
    hf = got.get("grad.hfield_data")
    if not model_grad_ok(errs) or not launches["chol_solve"] or (
        errs["mjtpu_nonfinite"] and not fd) or any(
            not e <= MODEL_GRAD_FD_RTOL for e in fd.values()) or (hf is not None and not (
                launches["hfield_manifold"]
                and (np.abs(hf).max() > 0) == ("hfield_data" not in errs["zero"]))):
      raise AssertionError(f"model_grad {name}: {errs}, central differences {fd}, launches"
                           f" {launches}")
    worst = max((v for f, v in errs["grads"].items() if f not in errs["zero"]), default=0.0)
    log(f"[slice19 parity] model_grad {name}: {len(errs['grads'])} fields, gradients within"
        f" {worst:.3e} of their max-abs (bound {DIFF_GRAD_BOUND:g}), {len(errs['zero'])} zero"
        f" in mjtpu and the port, values at step 1 {errs['head']:.3e} and over the run"
        f" {errs['values']:.3e} of scale, finite; "
        + ("" if not fd else f"{errs['mjtpu_nonfinite']} entries where mjtpu's is not finite"
           f" (C22) against differences of the port's loss "
           + ", ".join(f"{kind} {e:.3e}" for kind, e in fd.items())
           + f" (bound {MODEL_GRAD_FD_RTOL:g}); ")
        + f"launches forward and backward {launches}"
        + ("" if hf is None else f"; hfield_data gradient max-abs {np.abs(hf).max():.3e}"))


def sysid_rows(ns, batch: int, seed: int = 1) -> tuple[dict, dict]:
  """(reference rows, start rows) of the system-identification path (numpy,
  (batch, *shape) each) for ``ns`` (a snapshot or a Model's fields as
  numpy): each of SYSID_FIELDS' entries x U(0.8, 1.2) for the reference,
  and the reference x U(0.8, 1.2) again for the start, numpy seed
  ``seed``."""
  import numpy as np

  rng = np.random.default_rng(seed)
  ref, start = {}, {}
  for k in SYSID_FIELDS:
    base = np.tile(np.array(getattr(ns, k), dtype=np.float64), (batch,) + (1,) * np.ndim(
        getattr(ns, k)))
    ref[k] = base * rng.uniform(0.8, 1.2, base.shape)
    start[k] = ref[k] * rng.uniform(0.8, 1.2, base.shape)
  return ref, start


def _sysid_path(card):
  """Phase 38's main path: system identification on humanoid_bench at
  f32, B=4096 under differentiable_mode()'s defaults (Newton 1 x 4, the
  model's own): targets are a rollout of SYSID_K steps (from qpos0 +-0.01,
  qvel and ctrl (SYSID_K, B, nu) uniform in [-1, 1], numpy seed 1) under
  the reference rows of sysid_rows; from its start rows, each of
  SYSID_FIELDS a leaf tensor (B, *shape) that requires grad through
  parallel.randomize, SYSID_STEPS steps of torch.optim.Adam (lr SYSID_LR
  of each field's largest reference magnitude), each one rollout forward
  and backward of the loss: per env the mean over the steps of ||qpos -
  target||^2, summed over the envs.  One warm-up rollout forward and
  backward, then the Adam steps timed, forward and backward each by the
  host clock (synchronized); the first is the counted run (every kernel
  count set to 0 before its forward: B1 register once a step forward,
  cholesky.CholSolve once a step backward, whose mat_bar reaches
  body_mass and dof_armature through qM); peak memory over the timed
  steps; the envs whose gradient of any field is not finite (must be 0);
  and the host syncs of one more rollout forward and backward
  (torch.cuda.set_sync_debug_mode) beside the same rollout with its
  gradient taken to the initial qvel and no field requiring grad: the
  tables rebuilt from the live fields add none."""
  import statistics
  import warnings
  from types import SimpleNamespace

  import numpy as np
  import torch

  import mjtpu_torch
  from mjtpu_torch import parallel
  from mjtpu_torch.ops import cholesky

  m = mjtpu_torch.model_from_arrays(
      mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / "humanoid_bench_model.npz"),
      dtype=torch.float32, device="cuda")
  B, K = BENCH_BATCH, SYSID_K
  rng = np.random.default_rng(1)
  t = lambda x: torch.as_tensor(x, dtype=torch.float32, device="cuda")
  qpos = t(m.qpos0.cpu().numpy()[None] + rng.uniform(-0.01, 0.01, (B, m.nq)))
  qvel = t(rng.uniform(-1.0, 1.0, (B, m.nv)))
  ctrl = t(rng.uniform(-1.0, 1.0, (K, B, m.nu)))
  base = SimpleNamespace(**{k: getattr(m, k).cpu().numpy() for k in SYSID_FIELDS})
  ref, start = sysid_rows(base, B)

  def rollout(rows, qvel0=qvel):
    return rollout_on(parallel.randomize(m, rows)[0], qvel0)

  def rollout_on(mb, qvel0):
    d = mjtpu_torch.replace(mjtpu_torch.make_data(mb, B), qpos=qpos, qvel=qvel0)
    out = []
    with mjtpu_torch.differentiable_mode():
      for i in range(K):
        d = mjtpu_torch.step(mb, mjtpu_torch.replace(d, ctrl=ctrl[i]))
        out.append(d.qpos)
    return torch.stack(out), d

  with torch.no_grad():
    target, _ = rollout({k: t(v) for k, v in ref.items()})
  leaves = {k: t(v).requires_grad_(True) for k, v in start.items()}
  opt = torch.optim.Adam([{"params": [leaves[k]], "lr": SYSID_LR * float(np.abs(ref[k]).max())}
                          for k in SYSID_FIELDS])

  def loss_of(qs):
    per_env = torch.mean(torch.sum((qs - target) ** 2, dim=-1), dim=0)
    return per_env.sum(), per_env

  loss, _ = loss_of(rollout(leaves)[0])
  loss.backward()
  opt.zero_grad()
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  walls, losses, bad = [], [], 0
  for step in range(SYSID_STEPS):
    if step == 0:
      _zero_counts()
    t0 = time.perf_counter()
    qs, d = rollout(leaves)
    loss, per_env = loss_of(qs)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    if step == 0:
      forward = cholesky.launches
    loss.backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if step == 0:
      counts = _read_counts()
      backward = counts["chol_solve"] - forward
    walls.append((t1 - t0, t2 - t1))
    losses.append(float(per_env.detach().mean()))
    finite = torch.ones(B, dtype=torch.bool, device="cuda")
    for v in leaves.values():
      finite &= torch.isfinite(v.grad).reshape(B, -1).all(dim=1)
    bad = max(bad, int((~finite).sum()))
    if bad or not bool(torch.isfinite(d.qpos).all()) or int(d.nreset.sum()):
      raise AssertionError(f"sysid step {step}: {bad} envs with a gradient not finite, nreset"
                           f" {int(d.nreset.sum())}")
    opt.step()
    opt.zero_grad()
    del qs, d, loss, per_env
  peak = torch.cuda.max_memory_allocated()
  if counts != _only(chol_solve=2 * K) or forward != K:
    raise AssertionError(f"sysid path: launches {counts}, {forward} in the forward")

  def syncs(rows, qvel0) -> collections.Counter:
    """The host syncs of one rollout forward and backward on the Model
    randomized with ``rows``, by the line that made each; the Model is
    built before the count (randomize reads the values of rows that do not
    require grad on the host)."""
    mb, _ = parallel.randomize(m, rows)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
      warnings.simplefilter("always")
      torch.cuda.set_sync_debug_mode("warn")
      try:
        loss_of(rollout_on(mb, qvel0)[0])[0].backward()
      finally:
        torch.cuda.set_sync_debug_mode("default")
    return collections.Counter(f"{pathlib.Path(w.filename).name}:{w.lineno}" for w in caught
                               if "synchroniz" in str(w.message))

  # the mode's first switch in a process warns once that it is a prototype
  # (a warning that names synchronizing operations): switched once here,
  # outside the counts
  with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    torch.cuda.set_sync_debug_mode("warn")
    torch.cuda.set_sync_debug_mode("default")
  # the baseline: the same rollout and backward with the gradient taken to
  # the initial qvel (phase 35's path) and no Model field requiring grad
  at_grad = syncs(leaves, qvel)
  opt.zero_grad()
  at_plain = syncs({k: v.detach() for k, v in leaves.items()}, qvel.clone().requires_grad_(True))
  sync_grad, sync_plain = sum(at_grad.values()), sum(at_plain.values())
  if not sync_plain:
    raise AssertionError("sysid path: no host sync counted without the rows requiring grad, where"
                         " the new Model's index tables are copied from the host: the count is"
                         " blind")
  if sync_grad > sync_plain:
    raise AssertionError(f"sysid path: {sync_grad} host syncs a rollout with its rows requiring"
                         f" grad, {sync_plain} without; only with the rows: {at_grad - at_plain},"
                         f" only without: {at_plain - at_grad}")
  med = statistics.median
  fwd_s, bwd_s = med([f for f, _ in walls]), med([b for _, b in walls])
  totals = [f + b for f, b in walls]
  rate = B * K / med(totals)
  figures = {"launches_forward": forward, "launches_backward": backward, "forward_s": fwd_s,
             "backward_s": bwd_s, "total_s_runs": totals, "env_steps_per_s": rate,
             "peak_memory_bytes": peak, "losses": losses, "nonfinite_envs": bad,
             "host_syncs_grad": sync_grad, "host_syncs_plain": sync_plain}
  line = (f"f32 B={B} K={K}, {len(SYSID_FIELDS)} fields per env ({', '.join(SYSID_FIELDS)}),"
          f" {SYSID_STEPS} Adam steps after one warm-up rollout (host clock, synchronized):"
          f" forward median {fwd_s:.3f} s, backward median {bwd_s:.3f} s, together median"
          f" {med(totals):.3f} s (least {min(totals):.3f}, most {max(totals):.3f}) ="
          f" {rate:.0f} env-steps/s forward and backward together; losses (mean per env) "
          + ", ".join(f"{x:.6e}" for x in losses)
          + f"; B1 register (n={m.nv}) launches {forward} in the forward, {backward} in the"
          f" backward; peak memory {peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated);"
          f" envs with a gradient not finite {bad}; host syncs of a rollout forward and"
          f" backward {sync_grad} with the rows requiring grad, {sync_plain} with the initial"
          f" qvel's instead; card {card}")
  return line, counts, figures


def phase_slice19_throughput(card):
  """Phase 38: system identification on humanoid_bench (the slice-19 main
  path): (its launch counts, its figures)."""
  line, counts, figures = _sysid_path(card)
  log(f"[slice19 throughput] humanoid_bench system identification under differentiable_mode()"
      f" {line}")
  return counts, figures


# the parity phases that run in a process of their own beside phase 22
SIDE_PHASES = ("5", "7", "9-twin", "10", "13", "15", "17", "18", "20", "22-cones",
               "22-cones-2", "24", "26", "28", "30", "30-sensors", "32", "32-fields", "34", "36",
               "38-parity")
SIDE_TIMEOUT_S = 600


def _start_side_phase(phase: str):
  """Starts ``python3 chip_smoke.py --phase <phase>`` from this checkout,
  its output to a temporary file: (the process, the file)."""
  import tempfile

  out = tempfile.TemporaryFile(mode="w+")
  proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--phase", phase],
                          cwd=ROOT, stdout=out, stderr=subprocess.STDOUT, text=True)
  return proc, out


def _finish_side_phase(phase: str, proc, out) -> None:
  """Waits for a side phase, logs its output and fails if it failed."""
  try:
    proc.wait(timeout=SIDE_TIMEOUT_S)
  finally:
    out.seek(0)
    text = out.read()
    out.close()
  for line in text.splitlines():
    log(f"[phase {phase}] {line}")
  if proc.returncode != 0:
    raise AssertionError(f"phase {phase} failed in its own process (exit {proc.returncode})")


def _side_main(phase: str) -> int:
  """One parity phase alone (``--phase``): the card set up as main() sets
  it, the kernels loaded from main()'s build."""
  if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
  t0 = time.perf_counter()
  phase_device()
  {"5": phase_parity, "7": phase_terrain_parity, "10": phase_pile_parity,
   "13": phase_branchy_parity, "15": phase_ant_parity, "17": phase_ant_rk4_parity,
   "18": phase_env_parity, "20": phase_collision_parity, "22-cones": lambda: phase_cone_parity(0),
   "22-cones-2": lambda: phase_cone_parity(1),
   "24": phase_fluid_parity, "26": phase_tendon_parity, "28": phase_equality_parity,
   "30": lambda: phase_slice14_parity("implicit"),
   "30-sensors": lambda: phase_slice14_parity("sensor"), "32": phase_slice15_parity,
   "32-fields": phase_slice18_parity,
   "34": phase_slice16_parity, "36": phase_slice17_parity, "9-twin": phase_sat_parity,
   "38-parity": phase_slice19_parity}[phase]()
  # its own wall time, beside the other side phases: which one holds the
  # group's rest after phase 22
  log(f"[time] phase {phase} in its process: {time.perf_counter() - t0:.1f} s")
  return 0


def main() -> int:
  if "--phase" in sys.argv[1:]:
    return _side_main(sys.argv[sys.argv.index("--phase") + 1])
  if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
  t0 = time.perf_counter()
  card = phase_device()
  import mjtpu_torch

  if pathlib.Path(mjtpu_torch.__file__).resolve().parent.parent != ROOT:
    raise RuntimeError(f"mjtpu_torch imported from {mjtpu_torch.__file__}, not this checkout")
  import torch

  laps = [t0]

  def lap(phases: str) -> None:
    laps.append(time.perf_counter())
    log(f"[time] phase {phases}: {laps[-1] - laps[-2]:.1f} s")

  phase_build()
  lap("1-2")
  chol_err, chol_t, chol_variant_ms, chol_shapes = phase_cholesky()
  lap("3")
  hf_err, hf_t, hf_variant_ms = phase_hfield()
  lap("4")
  sat_err, sat_t, sat_variant_ms, sat_shapes = phase_sat()
  if "--kernels" in sys.argv[1:]:
    phase_sat_parity()
  lap("9")
  ldl_err, ldl_t, ldl_context, ldl_variant_ms = phase_ldl()
  lap("12")
  if "--kernels" in sys.argv[1:]:
    log(f"[done] --kernels: phases 1-4, 9 and 12 only; {time.perf_counter() - t0:.1f} s")
    return 0
  bench_counts, bench = phase_throughput(card)
  paths = {"humanoid_bench": bench_counts}
  lap("6")
  paths["humanoid_terrain"] = phase_terrain_throughput(card)
  lap("8")
  paths["scene_pile"] = phase_pile_throughput(card)
  lap("11")
  paths["branchy66"] = phase_branchy_throughput(card)
  lap("14")
  paths["ant_bench"] = phase_ant_throughput(card)
  lap("16")
  paths["ant_env"] = phase_env_throughput(card)
  lap("19")
  paths["cylinder_drop"] = phase_drop_throughput(card)
  lap("21")
  # the parity phases (SIDE_PHASES) run in processes of their own beside
  # phase 22's: their steps are host-bound at B=4 and leave the card and
  # the other cores idle; nothing is timed until all have ended
  side = {phase: _start_side_phase(phase) for phase in SIDE_PHASES}
  try:
    elliptic_f64_err = phase_elliptic_parity()
    lap(f"22 (phases {', '.join(SIDE_PHASES)} beside it)")
    for phase, (proc, out) in side.items():
      _finish_side_phase(phase, proc, out)
  finally:
    for proc, _ in side.values():
      if proc.poll() is None:
        proc.kill()
        proc.wait()
  lap(f"{', '.join(SIDE_PHASES)} (their rest after 22)")
  paths[ELLIPTIC], elliptic_timed = phase_elliptic_throughput(card, bench)
  lap("23")
  paths["swimmer_env"] = phase_swimmer_throughput(card)
  lap("25")
  paths["tendon_mixed"], paths["muscle"] = phase_tendon_throughput(card)
  lap("27")
  paths["mocap"] = phase_mocap_throughput(card)
  lap("29")
  paths["humanoid_implicit"] = phase_implicit_throughput(card)
  lap("31")
  (paths["random_bench"], paths["random_terrain"], paths["branchy66_inverse"],
   random_figures) = phase_slice15_throughput(card)
  lap("33")
  paths["diff_humanoid_bench"], diff_figures = phase_slice16_throughput(card)
  lap("35")
  paths["humanoid_pixels"], pixel_figures = phase_slice17_throughput(card)
  lap("37")
  paths["sysid_humanoid_bench"], sysid_figures = phase_slice19_throughput(card)
  lap("38")
  # each path ran only the variant it expects (_read_counts); the
  # redesigned variant of every kernel ran on some path
  for name, kinds in VARIANT_LAUNCHES.items():
    if not kinds[NEW_VARIANT[name]]:
      raise AssertionError(f"{name}: the main paths launched {kinds}, not the"
                           f" {NEW_VARIANT[name]} kernel")
  log(f"[done] {time.perf_counter() - t0:.1f} s")
  log(card)
  variant_ms = {"chol_solve": chol_variant_ms, "hfield_manifold": hf_variant_ms,
                "sat_winners": sat_variant_ms, **ldl_variant_ms}
  record = []
  for name, source, replaces, err, (ms, plain, lib, b_ms, b_by) in (
      ("chol_solve", "mjtpu_torch/csrc/cholesky.cu", "mjtpu/ops/cholesky.py:31", chol_err, chol_t),
      ("hfield_manifold", "mjtpu_torch/csrc/hfield.cu", "mjtpu/ops/hfield.py:144", hf_err, hf_t),
      ("sat_winners", "mjtpu_torch/csrc/sat.cu", "mjtpu/ops/sat.py:67", sat_err, sat_t),
      *((entry, "mjtpu_torch/csrc/ldl.cu", f"mjtpu/ops/ldl.py:{line}", ldl_err[entry],
         ldl_t[entry])
        for entry, line in zip(LDL_ENTRIES, (208, 231, 340))),
  ):
    record.append({
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        # the sum over the main paths; each path's own count beside it
        "launches": sum(counts[name] for counts in paths.values()),
        "launches_per_path": {path: counts[name] for path, counts in paths.items()},
        "max_abs_err": err,
        "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
    })
    if name in ldl_context:
      # the dense Cholesky's time on the same matrices, beside B2 for context only
      record[-1]["context_ms"] = ldl_context[name]
    # a size dispatch: the variant the main paths ran (ms is its time), and
    # each variant's time at the main path's shape
    ran = [kind for kind, k in VARIANT_LAUNCHES[name].items() if k]
    record[-1].update(variant="+".join(ran), variant_launches=VARIANT_LAUNCHES[name],
                      variant_ms=variant_ms[name])
    if name == "chol_solve":
      # the register kernel's shapes (bench n=27, terrain n=23, the Ant env
      # n=14, mocap.xml n=12, walker2d and halfcheetah n=9, ant_bench n=8,
      # hopper n=6, the swimmer env n=5, the tendon scene and muscle.xml
      # n=2), f32
      record[-1]["shapes"] = chol_shapes
      # the elliptic bench's own Newton Hessians, f32 B=4096 (timed) and
      # the f64 restarts' (max_abs_err_f64)
      record[-1]["elliptic_hessians"] = {**elliptic_timed, "max_abs_err_f64": elliptic_f64_err}
      # the differentiable main path's forward and backward launches and
      # the backward's device time (phase 35)
      record[-1]["diff_path"] = diff_figures
      # the pixel env's main path (phase 37): its env steps with and
      # without pixels, the renderer's time, launches, busy share and
      # memory; B1 launches per env step
      record[-1]["pixel_env"] = pixel_figures
      # the system-identification path (phase 38): Adam steps on per-env
      # Model rows, each one rollout forward and backward (B1 8 + 8)
      record[-1]["sysid_path"] = sysid_figures
    if name in ("chol_solve", "hfield_manifold"):
      # the randomized main paths (phase 33): env steps/s beside the plain
      # path's in the same call, peak memory, each env alone's error
      record[-1]["randomized_paths"] = random_figures
    if name == "sat_winners":
      # the round hulls (the cylinder drop's cylinder-box and three more
      # pairs), shared, n = ROUND_N, f32
      record[-1]["shapes"] = sat_shapes
  print(json.dumps({"kernels": record}), flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count(),
  }}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
