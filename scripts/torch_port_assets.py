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

  mjtpu_torch/assets/humanoid_terrain_model.npz
      the same for humanoid_terrain.xml after mjtpu.procedural_terrain has
      filled its height field, with the hull tables mjtpu built for its
      rocks (mjtpu._src.mesh.get), so the port never rebuilds them.
  mjtpu_torch/assets/humanoid_terrain_golden.npz
      a reference trajectory from mjtpu at float64 on the CPU (ImplicitFast,
      8 Newton iterations):
        qpos0, qvel0, ctrl     B=4 initial states (terrain_initial_state:
                               env 0 lying on the flat spawn ground, envs
                               1 and 2 standing over the bumpy ring with
                               the torso raised 0.3 m, env 3 with its
                               right foot 1 mm above a rock's apex)
        qpos, qvel             (steps, 4, ...) after each step
        qacc, efc_force, contact_dist, contact_pos, contact_frame
                               after the first step

  mjtpu_torch/assets/scene_pile_model.npz
      the same for scene_pile.xml (32 free bodies, CG), with the box hull
      tables mjtpu builds (mjtpu._src.mesh.box of each box's size).
  mjtpu_torch/assets/scene_pile_golden.npz
      a reference trajectory from mjtpu at float64 on the CPU:
        qpos0, qvel0           B=4 initial states (pile_initial_state: env 0
                               every body dropped 0.25 m; env 1 the same
                               with small random rotations; env 2 bottom-
                               layer boxes in axis-aligned face contact in a
                               row, one box stacked on them, a sphere on a
                               box, two spheres touching; env 3 a box on
                               its edge and a box tilted about two axes on
                               it, edge across edge)
        qpos, qvel             (steps / 5, 4, ...) after every 5th step
        qacc, efc_force, contact_dist, contact_pos, contact_frame,
        solver_niter           after the first step

  mjtpu_torch/assets/boxes_model.npz
      the snapshot of tests/models/boxes.xml (Newton on three trees, boxes
      of two sizes), so that the card's tests step it without ``mujoco``.

  mjtpu_torch/assets/branchy66_model.npz
      the snapshot of the 66-dof branchy tree of tests/test_sparse.py
      (``_branchy_xml()``: a free trunk with 6 limbs of 10 damped hinges,
      Euler; mjtpu factors its mass matrix with the levelwise sparse LDL).
  mjtpu_torch/assets/branchy66_golden.npz
      a reference trajectory from mjtpu at float64 on the CPU:
        qpos0, qvel0           B=4 initial states (branchy_initial_state:
                               env e from numpy seed e, hinge angles qpos0
                               +-0.3, qvel uniform in [-0.3, 0.3])
        qpos, qvel             (100, 4, ...) after each step
        qLD, qLDiagInv, qacc_smooth, qacc
                               after the first step (qacc: after Euler's
                               implicit damping)

  mjtpu_torch/assets/ant_bench_model.npz
      the snapshot of mjtpu/zoo/assets/ant_bench.xml (a fixed-base ant,
      Euler, Newton 100 x 50, 60 capsule-capsule contact slots, 20 sensors:
      9 touch, velocimeter, gyro, accelerometer, 8 rangefinders).
  mjtpu_torch/assets/ant_bench_golden.npz
      a reference trajectory from mjtpu at float64 on the CPU:
        qpos0, qvel0, ctrl     B=4 initial states (ant_initial_state:
                               numpy seed 0, each joint uniform over its
                               range, qvel 0, ctrl uniform in [-1, 1])
        qpos, qvel, sensordata (steps, 4, ...) after each step
        fwd.<field>, fwd.contact.<field>
                               the Data step 1 computes before it
                               integrates (mjtpu.forward at the initial
                               states): the Data after step 1 with qpos,
                               qvel and time put back and qacc the
                               solver's (qacc_warmstart; Euler's damping
                               solve replaces qacc), every field of the
                               port's Data, for the stage tests
      The script prints the touch readings that are not zero (it fails if
      there are none) and the rangefinder readings that hit.

  mjtpu_torch/assets/<env>_model.npz for the zoo envs' models in
  mjtpu/zoo/assets (--model zoo): ant, hopper, walker2d, halfcheetah,
      cartpole, humanoid, swimmer (with io.FLUID_FIELDS: fluid forces),
      satellite, satellite_large and satellite_small.
  mjtpu_torch/assets/ant_rk4_golden.npz
      a reference trajectory of mjtpu/zoo/assets/ant.xml (RK4) from mjtpu
      at float64 on the CPU:
        qpos0, qvel0, ctrl     B=4 initial states (ant_rk4_initial_state:
                               numpy seed 0, the Ant env's reset noise:
                               qpos0 +-0.1, qvel 0.1 x normal; ctrl uniform
                               in [-1, 1])
        qpos, qvel             (steps, 4, ...) after each step
        pass_qacc              (4, 4, nv): step 1's four forward passes'
                               qacc (the stage passes replayed with mjtpu's
                               forward and _integrate_pos_only; the script
                               fails unless the last pass's solve equals
                               mjtpu.step's qacc_warmstart)
        qacc, qacc_warmstart   after step 1 (the combined qacc; the last
                               pass's solve)
  mjtpu_torch/assets/zoo_env_golden.npz
      mjtpu's env.step (jit(vmap)) at float64 on the CPU for the five
      locomotion envs (ant, hopper, walker2d, halfcheetah, cartpole), under
      "<env>." keys:
        qpos0, qvel0, steps0   B=4 initial states (env_initial_state: envs
                               0-2 the env's reset distribution from numpy
                               seed 0, none of them done within the run;
                               env 3 forced done at the first step: ant's
                               torso at z=1.2, hopper tilted 0.5 rad,
                               walker2d 1.5 rad, cartpole's pole at 1.5
                               rad, halfcheetah one step before its
                               episode_length)
        action                 (steps, 4, nu), uniform in [-1, 1]
        obs, reward, done, steps   (steps, 4, ...) after each env step
      Env 3 is reset by mjtpu's PRNG after its first step, which no other
      engine can reproduce: only its first step's reward, done and steps
      are comparable.

  mjtpu_torch/assets/cylinder_drop_model.npz, roll_model.npz, sph_cyl_model.npz
      the snapshots of the cylinder drop (CYLINDER_DROP_XML: a cylinder,
      r 0.08 and half-height 0.15, on a free joint over a 0.5 x 0.5 x 0.1
      box; dt 0.005, Newton 100 x 50; the scene of
      tests/test_collision_round.py::test_cylinder_drop_trajectory), of
      tests/models/roll.xml (a cylinder and an ellipsoid on a plane) and of
      tests/models/sph_cyl.xml (a sphere over a fixed cylinder), with the
      hulls mjtpu builds for boxes, cylinders and ellipsoids.
  mjtpu_torch/assets/cylinder_drop_golden.npz, roll_golden.npz,
  sph_cyl_golden.npz
      reference trajectories from mjtpu at float64 on the CPU:
        qpos0, qvel0           B=4 initial states (cylinder_drop_initial_state,
                               roll_initial_state, sph_cyl_initial_state)
        qpos, qvel             (steps, 4, ...) after each step
        contact_dist, contact_pos, contact_frame, contact_geom1,
        contact_geom2          the contacts of step 1
  mjtpu_torch/assets/collision_scenes.npz
      the snapshots of the small collision scenes (scene_xmls: the round
      pairs of tests/test_collision_round.py, the pairs of
      tests/test_collision.py's PAIR_SCENES that need this slice's
      colliders, a tetrahedron on a tetrahedron, and
      tests/test_broadphase.py's sphere pile with max_geom_pairs 4), in
      one bundle (io.save_snapshot_bundle).
  mjtpu_torch/assets/collision_scenes_golden.npz
      mjtpu's fwd_position at float64 on the CPU for each scene at B=2
      (scene_initial_state: qpos0 and a seeded perturbation of it):
        <scene>.qpos0          the states
        <scene>.dist, pos, frame, geom1, geom2   the contacts

  mjtpu_torch/assets/humanoid_bench_elliptic_model.npz
      the snapshot of humanoid_bench.xml with opt.cone elliptic (bench.py's
      humanoid_bench_elliptic).
  mjtpu_torch/assets/humanoid_bench_elliptic_golden.npz
      mjtpu at float64 on the CPU from humanoid_bench's initial states
      (initial_state, numpy seed 0):
        qpos, qvel, warm       (steps, 4, ...) after each step; warm is the
                               qacc_warmstart a restart from that state needs
        qacc, efc_force, contact_dist   after the first step
        fwd.<field>            the forward Data of step 1 (port_fields)
        solo_qpos, solo_qvel   (steps, 4, ...) one step of mjtpu compiled for
                               one env (jit(step)) from the batched run's
                               state before each step
        solo_run_qpos, solo_run_qvel
                               (steps, 4, ...) that compile's own run from
                               the initial states, env by env
        conv_qpos, conv_qvel, conv_warm, conv_solo_qpos, conv_solo_qvel,
        conv_solo_run_qpos, conv_solo_run_qvel
                               the same with the solver run to convergence
                               (opt.iterations and opt.ls_iterations =
                               CONVERGED, stored as converged_iterations)
  mjtpu_torch/assets/cone_scenes.npz, cone_scenes_golden.npz
      the bundle of cone_scene_xmls (the condim and elliptic test models,
      two frictionloss scenes, the elliptic fuzz scenes put_model takes)
      and, per scene from cone_initial_state, mjtpu's run at float64:
      <scene>.qpos0, .qvel0 (.qfrc_applied0), .qpos, .qvel (.sensordata)
      over the steps, and .fwd.<field> of step 1.
  mjtpu_torch/assets/fluid_scenes.npz, fluid_scenes_golden.npz
      the bundle of fluid_scene_xmls (tests/test_fluid.py's mixed
      ellipsoid-fluid model, GRAVCOMP_XML with and without its actuators,
      BOX_WIND_XML) and, per scene from fluid_initial_state, mjtpu's run at
      float64: <scene>.qpos0, .qvel0, .ctrl0, .qpos, .qvel over the steps,
      and .fwd.<field> of step 1.
  mjtpu_torch/assets/tendon_scenes.npz, tendon_scenes_golden.npz
      the bundle of tendon_scene_xmls (TENDON_MIXED_XML, the sphere,
      cylinder and pulley wrap scenes, friction_tendon.xml, muscle.xml,
      sensors.xml, the slider-crank and adhesion models, the tendon limit
      sensors) and, per scene from tendon_initial_state, mjtpu's run at
      float64: <scene>.qpos0, .qvel0, .ctrl0 (.act0), .qpos, .qvel (.act,
      .sensordata) over the steps, .fwd.<field> of step 1, and for the
      wrap scenes .poses.qpos with mjtpu's .poses.ten_length, .ten_J,
      .ten_wrap_xpos and .ten_wrap_active there (fwd_position).
  mjtpu_torch/assets/equality_scenes.npz, equality_scenes_golden.npz
      the bundle of equality_scene_xmls (mocap.xml under Euler and
      ImplicitFast, weld.xml, equality.xml, ball_free.xml under Euler and
      ImplicitFast, two forests under ImplicitFast, the ball-limit models,
      the limit sensors with a ball joint, a tendon equality, EQ_ORDER_XML,
      two equality fuzz scenes) and, per scene from equality_initial_state,
      mjtpu's run at float64: <scene>.qpos0, .qvel0, .ctrl0 (.act0,
      .eq_active0), .qpos, .qvel (.act, .sensordata) over the steps,
      .fwd.<field> of step 1 and .rnepost.cfrc_ext, mjtpu's
      rne_postconstraint of it, .efc_type and .efc_id, mjtpu's static row
      labels, and .c.cfrc_ext, MuJoCo C's mj_rnePostConstraint at the
      start states; the mocap scenes' .mocap_pos and .mocap_quat, set
      before each step (mocap_schedule).
  mjtpu_torch/assets/humanoid_implicit_model.npz, humanoid_implicit_golden.npz
      the zoo's humanoid.xml under the full Implicit integrator
      (humanoid_implicit) and, from implicit_initial_state, mjtpu's run at
      float64: qpos0, qvel0, ctrl, qpos, qvel over the steps, fwd.<field>
      of step 1 and deriv, mjtpu's deriv_smooth_vel(rne=True) of it.
  mjtpu_torch/assets/implicit_scenes.npz, implicit_scenes_golden.npz
      the bundle of implicit_scene_xmls (implicit_full.xml,
      implicit_fluid.xml under Implicit and ImplicitFast,
      tests/test_fluid.py's ellipsoid-fluid scene
      under Implicit and ImplicitFast, the swimmer under ImplicitFast,
      friction_tendon.xml and condim4_elliptic.xml under Implicit, two
      implicit fuzz scenes) and, per scene from implicit_initial_state,
      mjtpu's run at float64 as the equality bundle's, with .deriv, mjtpu's
      deriv_smooth_vel of step 1's forward Data (rne under Implicit), and
      .deriv.fluid, its fluid term alone (jacfwd of com_vel + _fluid,
      before the chain mask), where the scene has fluid forces.
  mjtpu_torch/assets/sensor_scenes.npz, sensor_scenes_golden.npz
      the bundle of sensor_scene_xmls (tests/test_energy.py's XML with the
      energy flag and its spring- and gravity-disable variants, its
      SENSOR_XML without and with the flag, geomdist_xml,
      tests/test_contact_sensor.py's XML,
      CAMPROJECTION_XML) and, per scene from sensor_initial_state, mjtpu's
      run at float64: <scene>.qpos0, .qvel0, .ctrl0, .qpos, .qvel,
      .sensordata and .energy over the steps and .fwd.<field> of step 1.
  mjtpu_torch/assets/swimmer_satellite_env_golden.npz
  mjtpu_torch/assets/diff_scenes.npz, diff_scenes_golden.npz
      tests/test_diff.py's differentiable scenes (chip_smoke.DIFF_SCENES)
      at B=4: per scene its start, mjtpu's values under
      differentiable_mode at f64 on the CPU (qpos and qvel after every
      step and the loss of a rollout; the loss of a min-distance scene)
      and the loss's gradients by jax.grad (diff_scenes)
  mjtpu_torch/assets/stepped_scenes.npz, stepped_scenes_golden.npz
      mjtpu/zoo/assets/hopper_bench.xml and tests/models/pendulum_implicit.xml
      at B=4: their start, mjtpu's qpos and qvel after each of 50 steps and
      its inverse's qfrc_inverse of the state after each step
      (stepped_scenes)
      mjtpu's env.step as zoo_env_golden.npz, for the swimmer and the three
      satellite envs (--model satellite_envs); none ends an episode early,
      so env 3 starts one step before its episode_length; the CMG envs
      start with their rotors spinning, as their reset does.
  mjtpu_torch/assets/render_scenes.npz, render_scenes_golden.npz
      the bundle of render_scene_xmls (tests/test_render.py's scenes and a
      mesh scene; the 6-face skybox painted one colour a face) and mjtpu's
      jit(render_batch_rgbd) at float64 of each at B=2 (render_scenes):
      every view (render_views: camera 0 under each RENDER_OPTIONS set,
      every camera under the defaults) at RENDER_SIZE, the starts, the
      single-square skybox put into the RenderData, and "views" (JSON).
      ``--view LABEL`` writes only those views.
  mjtpu_torch/assets/pixel_env_models.npz, pixel_env_golden.npz
      (--model pixel_envs) the snapshots of PIXEL_MODELS, the zoo models
      whose MJCF has no camera, with the observer camera mjtpu's pixel envs
      inject (pixel_env_mjmodel); and mjtpu's humanoid and satellite_small
      envs with pixel_obs=True at RENDER_SIZE as zoo_env_golden.npz steps
      them (humanoid's env 3 starts with its torso above the healthy band),
      with the pixels of the start and of each env step and the depth and
      seg of a render of the same Data (pixel_env_golden).  The zoo
      snapshots of models with a camera (satellite_small, satellite_large,
      --model zoo) keep the render fields since.
  mjtpu_torch/assets/randomize_fields.npz, randomize_fields_golden.npz
      (--model randomize_fields) the bundle of FIELD_HOMES' scenes
      (FIELDS_XML of tests/test_torch_randomize.py, FIELD_SENSING_XML,
      FIELD_FRICTION_XML, FIELD_ELLIPTIC_XML, the slider-crank of
      tests/test_transmission.py, FIELD_TERRAIN_XML, cartpole.xml) and of
      the two randomized main paths, humanoid_bench and humanoid_terrain;
      and mjtpu's batched randomized rollout of each at float64, every
      traced field perturbed in an env of its own (field_perturbation),
      the main paths at B=4 with chip_smoke's rows, and humanoid_bench's
      B=4096 mj_setConst rows (randomize_fields).  ``--scene NAME``
      writes only those scenes.  The snapshots of models with a light
      (satellite_small, satellite_large, the lit render scenes) hold
      light_dir0 since.
  mjtpu_torch/assets/model_grad_scenes_golden.npz
      (--model model_grad_scenes) mjtpu's values and jax.grad under
      differentiable_mode() at float64 of each randomize_fields scene with
      its rows (and derived constants) as the point, at the solver bounds
      and steps of chip_smoke.MODEL_GRAD_SCENES, and of humanoid_bench's
      unbatched MODEL_GRAD_BASE_FIELDS (model_grad_scenes); the scenes'
      snapshots are randomize_fields.npz's.  ``--scene NAME`` writes only
      those scenes.

Run from the repository root, where ``mujoco`` and ``jax`` are installed:

    JAX_PLATFORMS=cpu PYTHONPATH=$(pwd) python scripts/torch_port_assets.py \
        [--out DIR] [--model humanoid_bench|humanoid_terrain|scene_pile|boxes|branchy66|ant_bench
                     |zoo|ant_rk4|zoo_envs|cylinder_drop|roll|sph_cyl|collision_scenes
                     |humanoid_bench_elliptic|cone_scenes|fluid_scenes|satellite_envs
                     |tendon_scenes|equality_scenes|humanoid_implicit|implicit_scenes
                     |sensor_scenes|randomize_scenes|inverse_scenes|diff_scenes
                     |stepped_scenes|render_scenes|pixel_envs|randomize_fields
                     |model_grad_scenes]
        [--steps N] [--env NAME] [--scene NAME] [--view LABEL]

XLA compiles for the host's vector ISA, and the truncated solver of
humanoid_bench amplifies the ULP differences between ISAs (AVX-512 against
AVX2: 1.6e-8 in qvel over 100 steps).  The script caps XLA at AVX2
(``--xla_cpu_max_isa=AVX2``) so every x86 host with AVX2 writes the same
trajectory.  tests/test_torch_assets.py and tests/test_torch_assets_*.py
run it into a temporary directory and hold the result to the committed
files.
"""

from __future__ import annotations

import argparse
import os
import pathlib

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
XML = ROOT / "mjtpu" / "zoo" / "assets" / "humanoid_bench.xml"
TERRAIN_XML = ROOT / "mjtpu" / "zoo" / "assets" / "humanoid_terrain.xml"
PILE_XML = ROOT / "mjtpu" / "zoo" / "assets" / "scene_pile.xml"
BOXES_XML = ROOT / "tests" / "models" / "boxes.xml"
ASSETS = ROOT / "mjtpu_torch" / "assets"
MODEL_FILE = ASSETS / "humanoid_bench_model.npz"
GOLDEN_FILE = ASSETS / "humanoid_bench_golden.npz"
TERRAIN_MODEL_FILE = ASSETS / "humanoid_terrain_model.npz"
TERRAIN_GOLDEN_FILE = ASSETS / "humanoid_terrain_golden.npz"
PILE_MODEL_FILE = ASSETS / "scene_pile_model.npz"
PILE_GOLDEN_FILE = ASSETS / "scene_pile_golden.npz"
BOXES_MODEL_FILE = ASSETS / "boxes_model.npz"
BRANCHY_MODEL_FILE = ASSETS / "branchy66_model.npz"
BRANCHY_GOLDEN_FILE = ASSETS / "branchy66_golden.npz"
ANT_XML = ROOT / "mjtpu" / "zoo" / "assets" / "ant_bench.xml"
ANT_MODEL_FILE = ASSETS / "ant_bench_model.npz"
ANT_GOLDEN_FILE = ASSETS / "ant_bench_golden.npz"
ZOO = ROOT / "mjtpu" / "zoo" / "assets"
ZOO_MODELS = ("ant", "hopper", "walker2d", "halfcheetah", "cartpole", "humanoid", "swimmer",
              "satellite", "satellite_large", "satellite_small")
LOCOMOTION = ("ant", "hopper", "walker2d", "halfcheetah", "cartpole")
# the envs of the second env golden: the swimmer (fluid forces) and the
# satellites (cmg.py, satellite.py)
SATELLITE_ENVS = ("swimmer", "satellite", "satellite_large", "satellite_small")
SATELLITE_ENV_GOLDEN_FILE = ASSETS / "swimmer_satellite_env_golden.npz"
ANT_RK4_GOLDEN_FILE = ASSETS / "ant_rk4_golden.npz"
ENV_GOLDEN_FILE = ASSETS / "zoo_env_golden.npz"
CYLINDER_DROP_XML = """<mujoco><option timestep="0.005"/><worldbody>
  <geom type="box" size="0.5 0.5 0.1"/>
  <body pos="0 0 0.4" euler="0 80 0"><freejoint/>
    <geom type="cylinder" size="0.08 0.15"/></body>
  </worldbody></mujoco>"""
# the models of this slice with a snapshot and a trajectory golden each
CONTACT_MODELS = ("cylinder_drop", "roll", "sph_cyl")
SCENES_FILE = ASSETS / "collision_scenes.npz"
SCENES_GOLDEN_FILE = ASSETS / "collision_scenes_golden.npz"
# tests/test_collision.py's PAIR_SCENES that this slice's colliders run
PAIR_SCENES = ("plane_ellipsoid", "plane_cylinder", "plane_cylinder_flat", "plane_mesh",
               "sphere_cylinder_side", "sphere_cylinder_cap", "sphere_cylinder_rim",
               "capsule_box", "hfield_box")
SCENE_BATCH = 2
ELLIPTIC_MODEL_FILE = ASSETS / "humanoid_bench_elliptic_model.npz"
ELLIPTIC_GOLDEN_FILE = ASSETS / "humanoid_bench_elliptic_golden.npz"
CONE_SCENES_FILE = ASSETS / "cone_scenes.npz"
CONE_GOLDEN_FILE = ASSETS / "cone_scenes_golden.npz"
# the test models of the friction-row and cone slice
CONE_XMLS = ("condim4_elliptic", "condim4_pyramidal", "condim6_elliptic", "condim_cg", "elliptic")
# tests/test_solver.py::test_frictionloss_saturation's slide joint
FRICTIONLOSS_SLIDE_XML = """<mujoco><option timestep="0.002"/><worldbody><body>
  <joint name="s" type="slide" axis="1 0 0" frictionloss="3.0"/>
  <geom size="0.1" mass="1"/></body></worldbody></mujoco>"""
# hinges with frictionloss and limits beside an elliptic condim-6 sphere:
# friction rows before the limit rows, read by jointlimitfrc, and a touch
# sensor on the sphere, read from the elliptic contact forces
FRICTIONLOSS_CHAIN_XML = """<mujoco><option timestep="0.002" cone="elliptic" impratio="2"/>
  <worldbody>
    <geom type="plane" size="5 5 0.1"/>
    <body pos="0 0 0.5">
      <joint name="j1" type="hinge" axis="0 1 0" frictionloss="0.2" limited="true"
             range="-0.3 0.3"/>
      <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.04" mass="0.5"/>
      <body pos="0.3 0 0">
        <joint name="j2" type="hinge" axis="0 1 0" frictionloss="0.05" limited="true"
               range="-1 1"/>
        <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.03" mass="0.3"/>
      </body>
    </body>
    <body pos="1 0 0.3"><freejoint/>
      <geom type="sphere" size="0.1" mass="0.5" condim="6" friction="0.7 0.02 0.002"/>
      <site name="ball" size="0.11"/>
    </body>
  </worldbody>
  <sensor><jointlimitfrc joint="j1"/><jointlimitfrc joint="j2"/><touch site="ball"/></sensor>
</mujoco>"""
# tests/test_fuzz.py::test_fuzz_elliptic_cone's scenes that the cone slice's
# put_model took: seed 2 (Euler's damping on two trees, the blocked
# symmetric factor_solve, which came with the tendon slice) is left out so
# the cone bundle stays as it was
FUZZ_SEEDS = (0, 1, 3, 4)
FLUID_SCENES_FILE = ASSETS / "fluid_scenes.npz"
FLUID_GOLDEN_FILE = ASSETS / "fluid_scenes_golden.npz"
# two trees: a hinge chain whose root joint takes its gravity compensation
# through the actuators (actuatorgravcomp), under bodies at gravcomp 1 and
# 0.5, and a free body at gravcomp 1 with a slide child at 0.5 that also
# routes it through the actuators; motors on the chain's two hinges
GRAVCOMP_XML = """<mujoco><option timestep="0.002"/>
  <default><geom contype="0" conaffinity="0"/></default>
  <worldbody>
    <body pos="0 0 1" gravcomp="1">
      <joint name="j0" type="hinge" axis="0 1 0" actuatorgravcomp="true"/>
      <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.04" mass="1"/>
      <body pos="0.3 0 0" gravcomp="0.5">
        <joint name="j1" type="hinge" axis="0 1 0"/>
        <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.04" mass="0.8"/>
        <body pos="0.3 0 0">
          <joint type="ball"/>
          <geom type="box" size="0.05 0.06 0.07" mass="0.5"/>
        </body>
      </body>
    </body>
    <body pos="1 0 1" gravcomp="1">
      <freejoint/>
      <geom type="sphere" size="0.1" mass="0.3"/>
      <body pos="0 0 -0.2" gravcomp="0.5">
        <joint type="slide" axis="0 0 1" actuatorgravcomp="true"/>
        <geom type="sphere" size="0.05" mass="0.2"/>
      </body>
    </body>
  </worldbody>
  <actuator>
    <motor joint="j0" gear="1" ctrlrange="-1 1" ctrllimited="true"/>
    <motor joint="j1" gear="2"/>
  </actuator>
</mujoco>"""
# the inertia-box fluid model alone, with wind, on a free box with two
# hinged links (one at gravcomp 0.5)
BOX_WIND_XML = """<mujoco>
  <option density="1.2" viscosity="0.05" wind="1.5 -0.5 0.3"/>
  <default><geom contype="0" conaffinity="0"/></default>
  <worldbody>
    <body pos="0 0 1">
      <freejoint/>
      <geom type="box" size="0.2 0.1 0.05" mass="1"/>
      <body pos="0.2 0 0" gravcomp="0.5">
        <joint type="hinge" axis="0 0 1"/>
        <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.03" mass="0.3"/>
      </body>
      <body pos="-0.2 0 0">
        <joint type="hinge" axis="0 1 0"/>
        <geom type="ellipsoid" size="0.1 0.05 0.02" mass="0.2"/>
      </body>
    </body>
  </worldbody>
</mujoco>"""
TENDON_SCENES_FILE = ASSETS / "tendon_scenes.npz"
TENDON_GOLDEN_FILE = ASSETS / "tendon_scenes_golden.npz"
# tests/test_tendon.py's _MIXED_XML (tests/test_torch_tendon.py holds the
# two equal): a spatial tendon wrapped on a cylinder with a limit and
# frictionloss, a fixed tendon with a spring, a tendon motor, TENDONPOS and
# TENDONVEL; the main path of chip_smoke.py's phase 27
TENDON_MIXED_XML = """
<mujoco>
  <option timestep="0.005"/>
  <worldbody>
    <body name="arm" pos="0 0 0.5">
      <joint name="j0" type="hinge" axis="0 1 0"/>
      <geom type="capsule" size="0.04" fromto="0 0 0 0.5 0 0" mass="1"/>
      <site name="s0" pos="0.5 0 0"/>
      <body name="fore" pos="0.5 0 0">
        <joint name="j1" type="hinge" axis="0 1 0"/>
        <geom type="capsule" size="0.03" fromto="0 0 0 0.4 0 0" mass="0.5"/>
        <site name="s1" pos="0.4 0 0"/>
      </body>
    </body>
    <geom name="wg" type="cylinder" size="0.1 0.3" pos="0.5 0 0.5"
          euler="90 0 0" contype="0" conaffinity="0"/>
    <site name="ground" pos="0 0 0"/>
  </worldbody>
  <tendon>
    <spatial name="sp" stiffness="30" springlength="0.6" damping="1.0"
             range="0.2 1.4" limited="true" frictionloss="0.1">
      <site site="ground"/><geom geom="wg"/><site site="s1"/>
    </spatial>
    <fixed name="fx" stiffness="2">
      <joint joint="j0" coef="1.5"/><joint joint="j1" coef="-0.5"/>
    </fixed>
  </tendon>
  <actuator>
    <motor tendon="sp" gear="3"/>
  </actuator>
  <sensor>
    <tendonpos tendon="sp"/><tendonvel tendon="sp"/>
  </sensor>
</mujoco>
"""
# the wrap scenes, whose golden also holds mjtpu's tendons at POSES seeded
# poses (qpos0 +-POSE_SPREAD, as tests/test_tendon.py's _parity)
WRAP_SCENES = ("mixed", "sphere", "sphere_side_out", "sphere_side_in", "cylinder",
               "cylinder_side_out", "cylinder_side_in", "pulley")
POSES = 40
POSE_SPREAD = 0.8
EQUALITY_SCENES_FILE = ASSETS / "equality_scenes.npz"
EQUALITY_GOLDEN_FILE = ASSETS / "equality_scenes_golden.npz"
# tests/test_constraint.py::test_ball_limit_zero_rotation_margin's model:
# a ball joint's limit row live at zero rotation through its margin
BALL_LIMIT_MARGIN_XML = """<mujoco><worldbody><body pos="0 0 1">
    <joint type="ball" range="0 0.4" limited="true" margin="0.01"/>
    <geom type="capsule" size="0.05" fromto="0 0 0 0.3 0 0"/>
    </body></worldbody></mujoco>"""
# tests/test_constraint.py::test_limit_rows_batched_order's model: ball
# and hinge limits interleaved in joint order
BALL_LIMIT_ORDER_XML = """<mujoco><worldbody><body pos="0 0 1">
    <joint type="ball" range="0 30" limited="true"/>
    <geom type="capsule" size="0.05" fromto="0 0 0 0.3 0 0"/>
    <body pos="0.3 0 0">
      <joint type="hinge" axis="0 1 0" range="-20 20" limited="true"/>
      <geom type="capsule" size="0.04" fromto="0 0 0 0.2 0 0"/>
      <body pos="0.2 0 0">
        <joint type="ball" range="0 25" limited="true"/>
        <geom type="capsule" size="0.03" fromto="0 0 0 0.15 0 0"/>
      </body>
    </body>
    </body></worldbody></mujoco>"""
# a tendon equality before a connect and a weld, with a free box of each
# tree in contact with none: the rows each connect and weld force is read
# from in rne_postconstraint (ROADMAP C11)
EQ_ORDER_XML = """<mujoco><option timestep="0.002"/>
  <default><geom contype="0" conaffinity="0"/></default>
  <worldbody>
    <body name="a" pos="0 0 1"><joint name="ja" type="slide" axis="1 0 0"/>
      <geom type="sphere" size="0.1" mass="1"/></body>
    <body name="b" pos="0.5 0 1"><joint name="jb" type="slide" axis="1 0 0"/>
      <geom type="sphere" size="0.1" mass="1"/></body>
    <body name="c" pos="1 0 1"><freejoint/><geom type="box" size="0.1 0.1 0.1" mass="1"/></body>
    <body name="e" pos="1.5 0 1"><freejoint/><geom type="box" size="0.1 0.1 0.1" mass="1"/></body>
  </worldbody>
  <tendon>
    <fixed name="t1"><joint joint="ja" coef="1"/></fixed>
    <fixed name="t2"><joint joint="jb" coef="1"/></fixed>
  </tendon>
  <equality>
    <tendon tendon1="t1" tendon2="t2" polycoef="0 1 0 0 0"/>
    <connect body1="c" body2="e" anchor="0.25 0 0"/>
    <weld body1="a" body2="c"/>
  </equality>
</mujoco>"""
# tests/test_fuzz.py::test_fuzz_equality_classes's scenes: seed 2 (a weld,
# live contacts) and seed 3 (a connect), both on trees with ball joints
EQ_FUZZ_SEEDS = (2, 3)
# the adhesion scene's four envs: the box at tests/test_transmission.py's
# lifts (penetrating, in the margin, in the gap band, past margin + gap)
ADHESION_LIFTS = (0.049, 0.058, 0.075, 0.095)
HUMANOID_IMPLICIT_MODEL_FILE = ASSETS / "humanoid_implicit_model.npz"
HUMANOID_IMPLICIT_GOLDEN_FILE = ASSETS / "humanoid_implicit_golden.npz"
IMPLICIT_SCENES_FILE = ASSETS / "implicit_scenes.npz"
IMPLICIT_GOLDEN_FILE = ASSETS / "implicit_scenes_golden.npz"
# tests/test_fuzz.py::test_fuzz_implicit_integrator's seeds 0 (ImplicitFast)
# and 1 (Implicit)
IMPLICIT_FUZZ_SEEDS = (0, 1)
# tests/test_fluid.py::test_ellipsoid_fluid_implicit_integrators's scene
ELLIPSOID_FLUID_XML = """
    <mujoco>
      <option density="50" viscosity="2" timestep="0.01" integrator="{integ}"/>
      <default><geom contype="0" conaffinity="0"/></default>
      <worldbody>
        <body pos="0 0 1">
          <freejoint/>
          <geom type="ellipsoid" size="0.1 0.2 0.3" mass="1"
                fluidshape="ellipsoid" euler="20 -35 50"/>
          <body pos="0.3 0 0">
            <joint type="hinge" axis="0 1 0" damping="0.05"/>
            <geom type="capsule" size="0.04 0.15" mass="0.3"
                  fluidshape="ellipsoid"/>
          </body>
        </body>
      </worldbody>
    </mujoco>"""
SENSOR_SCENES_FILE = ASSETS / "sensor_scenes.npz"
SENSOR_GOLDEN_FILE = ASSETS / "sensor_scenes_golden.npz"
# tests/test_geomdist.py's XML with a static box (box4) and cylinder
# (cyl5) that collide with nothing (contype 2 against everything's 1),
# and the distance sensors of two hull pairs: box-box (SAT, kernel B3)
# and box-cylinder (mjtpu's inscribed cylinder hull, ROADMAP C16)
GEOMDIST_EXTRA_BODIES = """
  <geom name="box4" type="box" size="0.07 0.05 0.03" pos="0.05 0.45 0.45" euler="10 20 30"
        contype="2" conaffinity="2"/>
  <geom name="cyl5" type="cylinder" size="0.05 0.08" pos="-0.3 0.5 0.25" euler="0 40 0"
        contype="2" conaffinity="2"/>
</worldbody>"""
GEOMDIST_EXTRA_SENSORS = """
  <distance geom1="box3" geom2="box4" cutoff="2"/>
  <fromto geom1="box3" geom2="box4" cutoff="2"/>
  <normal geom1="box4" geom2="box3" cutoff="2"/>
  <distance geom1="box3" geom2="cyl5" cutoff="2"/>
  <fromto geom1="cyl5" geom2="box3" cutoff="2"/>
</sensor>"""
# tests/test_sensor.py::test_camprojection's model
CAMPROJECTION_XML = """<mujoco>
  <worldbody>
    <body pos="0 0 1">
      <joint type="hinge" axis="0 1 0"/>
      <geom type="capsule" size="0.03" fromto="0 0 0 0.3 0 0"/>
      <site name="tip" pos="0.3 0 0.1"/>
    </body>
    <camera name="fovycam" pos="1 -1.5 1.2" xyaxes="1 0.5 0 0 0.3 1"
            resolution="640 480" fovy="50"/>
    <camera name="intrcam" pos="-0.5 -1.5 1.0" xyaxes="1 0 0 0 0.3 1"
            resolution="320 240" sensorsize="0.036 0.024"
            focal="0.05 0.05" principal="0.001 -0.002"/>
  </worldbody>
  <sensor>
    <camprojection site="tip" camera="fovycam"/>
    <camprojection site="tip" camera="intrcam"/>
  </sensor>
  </mujoco>"""
# tests/test_contact_sensor.py's sliding state
CONTACT_SLIDE_QVEL = (0.5, 0, 0, 1, 0, 4, 0, 0, 0, 0, 0, 0, 0)
RANDOMIZE_SCENES_FILE = ASSETS / "randomize_scenes.npz"
RANDOMIZE_GOLDEN_FILE = ASSETS / "randomize_scenes_golden.npz"
INVERSE_SCENES_FILE = ASSETS / "inverse_scenes.npz"
INVERSE_GOLDEN_FILE = ASSETS / "inverse_scenes_golden.npz"
# tests/test_randomize.py's free ball on a plane
RANDOMIZE_BALL_XML = """<mujoco><option timestep="0.005"/><worldbody>
<geom type="plane" size="5 5 .1"/><body pos="0 0 0.28"><freejoint/>
<geom type="sphere" size="0.3" mass="1" friction="1 .005 .0001"/></body></worldbody></mujoco>"""
# tests/test_inverse.py's damped two-link arm in a medium, under each
# integrator with INVDISCRETE
INVERSE_ARM_XML = """<mujoco><option integrator="{integ}" viscosity="0.1" density="5"/>
<worldbody><body pos="0.15 0 0"><joint type="hinge" axis="0 1 0" damping="5"/>
<geom type="capsule" size="0.02" fromto="0 0 0 .1 0 0"/><body pos="0.1 0 0">
<joint type="hinge" axis="0 1 0" damping="3"/>
<geom type="capsule" size="0.015" fromto="-.1 0 0 .1 0 0"/></body></body></worldbody></mujoco>"""
INVERSE_OUT = ("qfrc_inverse", "qacc", "qfrc_constraint", "efc_force", "qfrc_bias",
               "qfrc_passive", "sensordata")
DIFF_SCENES_FILE = ASSETS / "diff_scenes.npz"
DIFF_GOLDEN_FILE = ASSETS / "diff_scenes_golden.npz"
STEPPED_SCENES_FILE = ASSETS / "stepped_scenes.npz"
STEPPED_GOLDEN_FILE = ASSETS / "stepped_scenes_golden.npz"
STEPPED_STEPS = 50
# (iterations, ls_iterations) of the diff scenes that step a solver
DIFF_SOLVER_BOUNDS = {"spheres": (4, 8), "sph_cyl": (4, 8), "bounce": (1, 4),
                      "bounce_smooth": (1, 4)}
# tests/test_diff.py's sphere near a box corner and box on a box
DIFF_BOX_CORNER_XML = """<mujoco><worldbody>
  <body pos="0 0 0"><geom type="box" size=".2 .2 .2" mass="1"/></body>
  <body pos="0.21 0.21 0.1"><freejoint/>
    <geom type="sphere" size=".05" mass="0.1"/></body>
</worldbody></mujoco>"""
DIFF_BOX_BOX_XML = """<mujoco><worldbody>
  <body pos="0 0 0"><geom type="box" size=".2 .2 .1" mass="1"/></body>
  <body pos="0.03 0.01 0.205"><freejoint/>
    <geom type="box" size=".1 .1 .1" mass="0.1"/></body>
</worldbody></mujoco>"""
# tests/test_diff.py's bouncing ball
DIFF_BOUNCE_XML = """<mujoco>
  <option timestep="0.01"/>
  <worldbody>
    <geom type="plane" size="10 10 .1"/>
    <body pos="0 0 1.0"><freejoint/>
      <geom type="sphere" size="0.1" mass="0.2"/></body>
  </worldbody>
</mujoco>"""
RENDER_SCENES_FILE = ASSETS / "render_scenes.npz"
RENDER_GOLDEN_FILE = ASSETS / "render_scenes_golden.npz"
PIXEL_ENV_MODELS_FILE = ASSETS / "pixel_env_models.npz"
PIXEL_ENV_GOLDEN_FILE = ASSETS / "pixel_env_golden.npz"
# the zoo models whose MJCF has no camera: mjtpu's pixel envs inject their
# observer camera (mjtpu/zoo/base.py), and the port loads these snapshots
# of the injected model (humanoid_terrain's height field cannot be drawn)
PIXEL_MODELS = ("ant", "cartpole", "halfcheetah", "hopper", "humanoid", "satellite", "swimmer",
                "walker2d")
PIXEL_ENVS = ("humanoid", "satellite_small")
# the renders' (height, width) and batch
RENDER_SIZE = (24, 32)
RENDER_BATCH = 2
# tests/test_render.py's option sets
RENDER_OPTIONS = {
    "flat": {"shading": "flat"}, "shadows": {"shading": "phong", "shadows": True},
    "fog": {"fog": 0.2}, "ssaa": {"ssaa": 2}, "fixed_light": {"scene_lights": False},
    "background": {"background": [0.2, 0.3, 0.4]},
}
# tests/test_render.py's single-square skybox, put into the RenderData
SQUARE_SKY = (0.2, 0.9, 0.4)
SKYBOX_FACE_COLORS = ((1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (1, 0, 1), (0, 1, 1))
CUBE_TEXTURE_XML = """<mujoco>
  <asset>
    <texture name="cb" type="cube" builtin="checker" rgb1="1 0 0"
             rgb2="0 0 1" width="32" height="32"/>
    <material name="cb" texture="cb"/>
  </asset>
  <worldbody>
    <camera name="c" pos="0 -1.5 0.5" xyaxes="1 0 0 0 0.32 0.95"/>
    <body pos="0 0 0.5"><freejoint/>
      <geom type="sphere" size="0.4" material="cb"/></body>
  </worldbody>
  </mujoco>"""
SKYBOX_FACES_XML = """<mujoco>
  <asset><texture name="sky" type="skybox" builtin="flat" rgb1="1 1 1"
                  width="8" height="48"/></asset>
  <worldbody>
    <camera name="xp" xyaxes="0 -1 0 0 0 1"/>
    <camera name="xn" xyaxes="0 1 0 0 0 1"/>
    <camera name="yp" xyaxes="1 0 0 0 0 1"/>
    <camera name="yn" xyaxes="-1 0 0 0 0 1"/>
    <camera name="zp" xyaxes="1 0 0 0 -1 0"/>
    <camera name="zn" xyaxes="1 0 0 0 1 0"/>
    <geom type="sphere" size=".01" pos="100 100 100"/>
  </worldbody>
  </mujoco>"""
SKYBOX_SQUARE_XML = """<mujoco>
  <worldbody>
    <camera name="xp" xyaxes="0 -1 0 0 0 1"/>
    <camera name="zn" xyaxes="1 0 0 0 1 0"/>
    <geom type="sphere" size=".01" pos="100 100 100"/>
  </worldbody>
  </mujoco>"""
CYLINDER_ELLIPSOID_XML = """<mujoco><worldbody>
    <camera name="c" pos="0 -3 1" xyaxes="1 0 0 0 0.32 0.95"/>
    <geom type="plane" size="4 4 .1" rgba=".6 .6 .6 1"/>
    <body pos="-0.7 0 0.6"><geom type="cylinder" size="0.3 0.5"
      rgba="1 0 0 1"/></body>
    <body pos="0.7 0 0.6"><geom type="ellipsoid" size="0.3 0.2 0.5"
      rgba="0 0 1 1"/></body>
  </worldbody></mujoco>"""
CAMERA_BODY_XML = """<mujoco><worldbody>
    <geom type="plane" size="4 4 .1"/>
    <body pos="0 0 1"><joint type="slide" axis="1 0 0"/>
      <geom type="sphere" size="0.01" rgba="0 0 0 0" contype="0"
        conaffinity="0" mass="1"/>
      <camera name="c" pos="0 0 0.3" xyaxes="1 0 0 0 0.32 0.95"/></body>
    <body pos="0 2 0.4"><geom type="box" size=".4 .4 .4" rgba="1 0 0 1"/>
    </body>
  </worldbody></mujoco>"""
# a mesh (an octahedron and a wedge) beside a capsule, under a spot light
# that casts shadows
RENDER_MESH_XML = """<mujoco>
  <asset>
    <mesh name="oct" vertex="0.3 0 0  -0.3 0 0  0 0.3 0  0 -0.3 0  0 0 0.4  0 0 -0.4"/>
    <mesh name="wedge" vertex="0 0 0  0.5 0 0  0 0.4 0  0 0 0.3  0.5 0 0.3  0 0.4 0.3"/>
  </asset>
  <worldbody>
    <camera name="c" pos="1.6 -1.8 1.4" xyaxes="0.75 0.66 0 -0.3 0.34 0.89"/>
    <light name="spot" pos="0.5 -0.5 2.5" dir="-0.2 0.2 -1" diffuse=".8 .8 .8"
           ambient=".1 .1 .1" specular=".3 .3 .3" cutoff="50" castshadow="true"/>
    <geom type="plane" size="3 3 .1" rgba=".7 .7 .7 1"/>
    <body pos="0 0 0.5"><freejoint/>
      <geom type="mesh" mesh="oct" rgba=".2 .6 .9 1"/></body>
    <body pos="-0.6 0.3 0"><geom type="mesh" mesh="wedge" rgba=".9 .5 .1 1"/></body>
    <body pos="0.7 0.2 0.3"><freejoint/>
      <geom type="capsule" size=".1 .2" rgba=".3 .8 .3 1"/></body>
  </worldbody>
</mujoco>"""
RANDOMIZE_FIELDS_FILE = ASSETS / "randomize_fields.npz"
RANDOMIZE_FIELDS_GOLDEN_FILE = ASSETS / "randomize_fields_golden.npz"
MODEL_GRAD_GOLDEN_FILE = ASSETS / "model_grad_scenes_golden.npz"
# the steps of each randomize_fields scene but the main paths'
FIELD_STEPS = 12
# the main paths' steps at B=4: humanoid_bench through C1's bound, the
# terrain as far
FIELD_BENCH_STEPS = 50
FIELD_TERRAIN_STEPS = 20
# a scene that reads the fields FIELDS_XML does not: a <pair>, sites with
# touch, magnetometer, rangefinder and frame sensors (cutoffs), fixed,
# tracking and targeting cameras and lights, a fluid (ellipsoid-model)
# geom in a medium with wind, a weld, a limited spatial tendon wrapping a
# cylinder with springs, damping and frictionloss, a fixed tendon with
# armature and frictionloss, and a filter
# actuator with ctrl, force, activation and joint-force limits
FIELD_SENSING_XML = """<mujoco>
  <option timestep="0.004" density="1.2" viscosity="0.05" wind="0.4 0 0.2" magnetic="0 -0.5 0.3"/>
  <worldbody>
    <light name="fixed" pos="0 0 3" dir="0 0.3 -1"/>
    <camera name="fixed" pos="0 -3 1" xyaxes="1 0 0 0 0.3 1"/>
    <geom name="floor" type="plane" size="3 3 .1" solmix="0.3" solref="0.03 1.1"
          solimp="0.85 0.96 0.002 0.5 2" friction="0.9 0.01 0.001"/>
    <geom name="post" type="cylinder" pos="0.6 0 1.1" size="0.05 0.2" zaxis="0 1 0"
          contype="0" conaffinity="0"/>
    <site name="anchor" pos="0.3 0 1.6" size="0.02"/>
    <body name="ball" pos="0 0 0.105">
      <freejoint/>
      <geom name="ball" type="sphere" size="0.1" mass="1" solmix="2" solref="0.01 0.8"
            solimp="0.9 0.99 0.001 0.5 2" friction="0.6 0.02 0.002" gap="0.002" margin="0.004"/>
      <site name="zone" type="sphere" size="0.09"/>
      <camera name="track" mode="track" pos="0 -1 0.5" xyaxes="1 0 0 0 0.5 1"/>
      <camera name="trackcom" mode="trackcom" pos="0 -1.5 0.5" xyaxes="1 0 0 0 0.5 1"/>
      <light name="track" mode="track" pos="0 0 1" dir="0 0 -1"/>
      <light name="trackcom" mode="trackcom" pos="0.2 0 1" dir="0 0 -1"/>
    </body>
    <body name="ball2" pos="0.5 0 0.085">
      <freejoint/>
      <geom name="ball2" type="sphere" size="0.08" mass="0.5" contype="0" conaffinity="0"/>
    </body>
    <body name="wing" pos="-0.6 0 1">
      <freejoint/>
      <geom type="ellipsoid" size="0.15 0.06 0.02" mass="0.1" fluidshape="ellipsoid"
            contype="0" conaffinity="0"/>
      <light name="target" mode="targetbody" target="ball" pos="0 0 0.5"/>
    </body>
    <body name="pend" pos="1 0 1.2">
      <joint name="swing" type="hinge" axis="0 1 0" damping="0.05" frictionloss="0.5"
             actuatorfrclimited="true" actuatorfrcrange="-0.3 0.3"/>
      <geom type="capsule" fromto="0 0 0 0 0 -0.4" size="0.03" mass="0.4" contype="0"
            conaffinity="0"/>
      <site name="tip" pos="0 0 -0.4" size="0.03" zaxis="0 0 -1"/>
    </body>
    <body name="welded" pos="1.1 0 0.7">
      <freejoint/>
      <geom type="sphere" size="0.05" mass="0.1" contype="0" conaffinity="0"/>
    </body>
  </worldbody>
  <contact>
    <pair geom1="floor" geom2="ball2" condim="3" friction="0.8 0.8 0.01 0.001 0.001"
          solref="0.03 1" solreffriction="0.04 1" solimp="0.9 0.95 0.001 0.5 2" margin="0.005"
          gap="0.001"/>
  </contact>
  <equality><weld body1="welded" body2="pend" solref="0.05 1" solimp="0.9 0.95 0.001 0.5 2"/>
  </equality>
  <tendon>
    <spatial name="rope" limited="true" range="0 0.95" margin="0.08" stiffness="3" damping="0.3"
             frictionloss="0.05" springlength="0.6 0.7" solreflimit="0.03 1"
             solimplimit="0.9 0.95 0.001 0.5 2" solreffriction="0.03 1"
             solimpfriction="0.9 0.95 0.001 0.5 2">
      <site site="anchor"/><geom geom="post"/><site site="tip"/>
    </spatial>
    <fixed name="inertia" armature="0.01" frictionloss="0.3"><joint joint="swing" coef="1"/>
    </fixed>
  </tendon>
  <actuator>
    <general name="filter" joint="swing" dyntype="filter" dynprm="0.05" gainprm="2"
             ctrllimited="true" ctrlrange="-1 1" forcelimited="true" forcerange="-0.5 0.5"
             actlimited="true" actrange="-0.7 0.7"/>
  </actuator>
  <sensor>
    <touch site="zone" cutoff="8"/>
    <magnetometer site="tip"/>
    <rangefinder site="tip"/>
    <framequat objtype="body" objname="ball"/>
    <framequat objtype="geom" objname="ball"/>
    <framequat objtype="site" objname="tip"/>
    <framepos objtype="site" objname="tip" cutoff="1.2"/>
  </sensor>
</mujoco>"""
# a pendulum at 0.3 rad held by the frictionloss of its hinge and of a
# fixed tendon (the friction rows short of their bound)
FIELD_FRICTION_XML = """<mujoco><option timestep="0.004"/><worldbody>
<body pos="0 0 1"><joint name="hinge" type="hinge" axis="0 1 0" frictionloss="0.5"/>
<geom type="capsule" fromto="0 0 0 0 0 -0.4" size="0.03" mass="0.4"/></body></worldbody>
<tendon><fixed name="t" frictionloss="0.3"><joint joint="hinge" coef="1"/></fixed></tendon>
</mujoco>"""
# a ball sliding under elliptic cones (the friction rows read impratio)
FIELD_ELLIPTIC_XML = """<mujoco><option timestep="0.005" cone="elliptic" impratio="2"/>
<worldbody><geom type="plane" size="5 5 .1"/><body pos="0 0 0.1"><freejoint/>
<geom type="sphere" size="0.1" mass="1" friction="0.5 .005 .0001"/></body></worldbody></mujoco>"""
# a sphere, a capsule and a box dropping onto a small height field
FIELD_TERRAIN_XML = """<mujoco><option timestep="0.004"/>
<asset><hfield name="terrain" nrow="12" ncol="12" size="1 1 0.2 0.1"/></asset>
<worldbody><geom name="ground" type="hfield" hfield="terrain"/>
<body pos="0.1 0.2 0.25"><freejoint/><geom type="sphere" size="0.1" mass="0.5"/></body>
<body pos="-0.3 -0.2 0.22"><freejoint/><geom type="capsule" size="0.05 0.15" mass="0.5"/></body>
<body pos="0.4 -0.3 0.25"><freejoint/><geom type="box" size="0.08 0.08 0.08" mass="0.5"/></body>
</worldbody></mujoco>"""
# each randomize_fields scene's perturbed fields (one env each), beside
# its base env 0; every traced field mjtpu's randomize accepts is in one
# at least
FIELD_HOMES = {
    "fields": (
        "opt.timestep", "opt.gravity", "opt.tolerance", "opt.ls_tolerance", "opt.o_margin",
        "opt.o_solref", "opt.o_solimp", "stat.meaninertia", "qpos0", "qpos_spring",
        "body_pos", "body_quat", "body_ipos", "body_iquat", "body_mass", "body_subtreemass",
        "body_inertia", "body_gravcomp", "body_invweight0", "jnt_solref", "jnt_solimp",
        "jnt_pos", "jnt_axis", "jnt_stiffness", "jnt_range", "jnt_margin", "dof_armature",
        "dof_damping", "dof_invweight0", "dof_M0", "dof_frictionloss", "dof_solref",
        "dof_solimp", "geom_solref", "geom_solimp", "geom_size", "geom_pos", "geom_quat",
        "geom_friction", "geom_margin", "geom_rbound", "tendon_length0", "tendon_invweight0",
        "eq_data", "eq_solref", "eq_solimp", "actuator_gainprm", "actuator_biasprm",
        "actuator_gear", "actuator_dynprm", "actuator_lengthrange", "actuator_acc0"),
    "sensing": (
        "geom_solmix", "geom_gap", "geom_fluid", "geom_rgba", "site_size", "site_pos",
        "site_quat", "cam_pos", "cam_quat", "cam_poscom0", "cam_pos0", "cam_mat0", "light_pos",
        "light_dir", "light_poscom0", "light_pos0", "light_dir0", "light_diffuse",
        "light_ambient", "light_specular", "light_attenuation", "light_cutoff",
        "light_exponent", "pair_solref", "pair_solreffriction", "pair_solimp", "pair_margin",
        "pair_gap", "pair_friction", "eq_data", "eq_solref", "eq_solimp", "tendon_solref_lim",
        "tendon_solimp_lim", "tendon_range", "tendon_margin", "tendon_stiffness",
        "tendon_damping", "tendon_armature", "tendon_frictionloss", "tendon_lengthspring",
        "actuator_ctrlrange",
        "actuator_forcerange", "actuator_actrange", "jnt_actfrcrange", "sensor_cutoff",
        "opt.wind", "opt.magnetic", "opt.density", "opt.viscosity"),
    "friction": ("dof_frictionloss", "dof_solref", "dof_solimp", "tendon_frictionloss",
                 "tendon_solref_fri", "tendon_solimp_fri"),
    "elliptic": ("opt.impratio",),
    "slidercrank": ("actuator_cranklength", "actuator_gear"),
    "terrain": ("hfield_data",),
    # ROADMAP C19: gear on a model with actuator_static_moment
    "cartpole_gear": ("actuator_gear",),
}
MODELS = ("humanoid_bench", "humanoid_terrain", "scene_pile", "boxes", "branchy66", "ant_bench",
          "zoo", "ant_rk4", "zoo_envs", *CONTACT_MODELS, "collision_scenes",
          "humanoid_bench_elliptic", "cone_scenes", "fluid_scenes", "satellite_envs",
          "tendon_scenes", "equality_scenes", "humanoid_implicit", "implicit_scenes",
          "sensor_scenes", "randomize_scenes", "inverse_scenes", "diff_scenes",
          "stepped_scenes", "render_scenes", "pixel_envs", "randomize_fields", "model_grad_scenes")
# env steps of the env golden
ENV_STEPS = 3
# the pile golden keeps the state after every PILE_EVERY-th step
PILE_EVERY = 5
BATCH = 4
STEPS = 100
# solver iterations / linesearch iterations that run humanoid_bench's
# Newton solve to convergence (it stops after at most 4 iterations; with
# elliptic cones after 3.6 on average, ROADMAP C7)
CONVERGED = 10


def load_mjmodel():
  import mujoco

  return mujoco.MjModel.from_xml_path(str(XML))


def load_terrain_mjmodel():
  """humanoid_terrain.xml with its height field filled by mjtpu."""
  import mujoco

  import mjtpu

  mjm = mujoco.MjModel.from_xml_path(str(TERRAIN_XML))
  mjtpu.procedural_terrain(mjm)
  return mjm


def _lowest_point(mjm, mjd) -> float:
  """The lowest world z over the colliding sphere and capsule geoms."""
  low = np.inf
  for g in range(mjm.ngeom):
    t = mjm.geom_type[g]
    if mjm.geom_bodyid[g] == 0 or t not in (2, 3):  # world geoms; sphere, capsule
      continue
    half = abs(mjd.geom_xmat[g, 8]) * mjm.geom_size[g, 1] if t == 3 else 0.0
    low = min(low, mjd.geom_xpos[g, 2] - half - mjm.geom_size[g, 0])
  return low


def terrain_initial_state(mjm, seed: int = 0):
  """(qpos, qvel, ctrl) for the 4 terrain envs (module docstring): qpos0
  +-0.01 and ctrl uniform in [-1, 1], then env 0 laid on its back on the
  flat spawn ground 1 cm above it, envs 1 and 2 moved over the bumpy ring
  (r = 4.0 and 4.3 m) with the torso 0.3 m higher, and env 3 moved so that
  its right foot's sole hangs 1 mm above rock1's apex."""
  import mujoco

  qpos, qvel, ctrl = initial_state(mjm, seed=seed)
  qpos[1, :3] += (4.0, 0.5, 0.3)
  qpos[2, :3] += (-2.6, 3.4, 0.3)
  mjd = mujoco.MjData(mjm)

  # env 0: rotated 90 degrees about y (lying along x), lowest geom 1 cm up
  qpos[0, 3:7] = (np.cos(np.pi / 4), 0.0, np.sin(np.pi / 4), 0.0)
  mjd.qpos[:] = qpos[0]
  mujoco.mj_kinematics(mjm, mjd)
  qpos[0, 2] += 0.01 - _lowest_point(mjm, mjd)

  mjd.qpos[:] = qpos[3]
  mujoco.mj_kinematics(mjm, mjd)
  rock = mujoco.mj_name2id(mjm, mujoco.mjtObj.mjOBJ_GEOM, "rock1")
  foot = mujoco.mj_name2id(mjm, mujoco.mjtObj.mjOBJ_GEOM, "right_foot_g")
  mesh = mjm.geom_dataid[rock]
  va, vn = mjm.mesh_vertadr[mesh], mjm.mesh_vertnum[mesh]
  verts = mjd.geom_xpos[rock] + mjm.mesh_vert[va : va + vn] @ mjd.geom_xmat[rock].reshape(3, 3).T
  apex = verts[np.argmax(verts[:, 2])]
  sole = mjd.geom_xpos[foot] - np.array([0.0, 0.0, mjm.geom_size[foot, 0]])
  qpos[3, :3] += apex - sole + np.array([0.0, 0.0, 0.001])
  return qpos, qvel, ctrl


def terrain_golden(mjm, steps: int = STEPS) -> dict[str, np.ndarray]:
  """The terrain golden file's arrays (module docstring); prints the
  active contacts (dist below the contact's margin, so the constraint row
  is live) of each collision group over the run."""
  import jax

  jax.config.update("jax_enable_x64", True)
  import jax.numpy as jnp

  import mjtpu
  from mjtpu._src import collision_driver

  qpos0, qvel0, ctrl = terrain_initial_state(mjm)
  m = mjtpu.put_model(mjm, dtype=jnp.float64)
  d = jax.vmap(lambda _: mjtpu.make_data(m))(jnp.arange(BATCH))
  d = d.replace(qpos=jnp.asarray(qpos0), qvel=jnp.asarray(qvel0), ctrl=jnp.asarray(ctrl))
  step = jax.jit(jax.vmap(mjtpu.step, in_axes=(None, 0)))
  groups = collision_driver.candidate_groups(m)
  sizes = [collision_driver._PAIR_NCON[k[:2]] * len(p) for k, p in groups.items()]
  bounds = np.cumsum([0] + sizes)
  active = np.zeros(len(sizes), int)
  out = {"qpos": [], "qvel": []}
  for i in range(steps):
    d = step(m, d)
    for k in out:
      out[k].append(np.asarray(getattr(d, k)))
    live = np.asarray(d.contact.dist) < np.asarray(d.contact.includemargin)
    active += [int(live[:, a:b].sum()) for a, b in zip(bounds[:-1], bounds[1:])]
    if i == 0:
      first = jax.tree.map(np.asarray, d)
  for key, n in zip(groups, active):
    print(f"group {key}: {n} active contact slots over {steps} steps x {BATCH} envs")
  return {
      "qpos0": qpos0, "qvel0": qvel0, "ctrl": ctrl,
      **{k: np.stack(v) for k, v in out.items()},
      "qacc": first.qacc, "efc_force": first.efc_force, "contact_dist": first.contact.dist,
      "contact_pos": first.contact.pos, "contact_frame": first.contact.frame,
  }


def load_pile_mjmodel():
  import mujoco

  return mujoco.MjModel.from_xml_path(str(PILE_XML))


def sized_geom_convex(mjm) -> tuple:
  """Per geom, mjtpu's hull of each colliding box, cylinder and ellipsoid
  (mjtpu._src.mesh.box, cylinder or ellipsoid of its grouping key, as
  mjtpu's collision_driver builds it), else None."""
  from mjtpu._src import mesh

  build = {6: mesh.box, 5: mesh.cylinder, 4: mesh.ellipsoid}  # mjGEOM_BOX, CYLINDER, ELLIPSOID
  out = []
  for g in range(mjm.ngeom):
    colliding = mjm.geom_contype[g] or mjm.geom_conaffinity[g]
    t = int(mjm.geom_type[g])
    out.append(build[t](np.array(tuple(np.round(mjm.geom_size[g], 12))))
               if t in build and colliding else None)
  return tuple(out)


def _axis_quat(axis, angle: float) -> np.ndarray:
  axis = np.asarray(axis, dtype=np.float64)
  return np.concatenate([[np.cos(angle / 2)], np.sin(angle / 2) * axis / np.linalg.norm(axis)])


def _quat_mul(u, v) -> np.ndarray:
  w1, x1, y1, z1 = u
  w2, x2, y2, z2 = v
  return np.array([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2, w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                   w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2, w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def pile_initial_state(mjm, seed: int = 0):
  """(qpos, qvel) for the 4 pile envs (module docstring), every body at
  rest.  Body b<i> is free joint i (qpos 7i..7i+6); box half-size 0.08,
  sphere radius 0.09; each contact below is 1 mm deep."""
  rng = np.random.default_rng(seed)
  qpos = np.tile(mjm.qpos0, (BATCH, 1))
  qpos[:, 2::7] -= 0.25  # env 0 and the base of the others: dropped 0.25 m
  for i in range(32):  # env 1: rotations of up to 0.1 rad about each axis
    rv = rng.uniform(-0.1, 0.1, 3)
    qpos[1, 7 * i + 3:7 * i + 7] = _axis_quat(rv, np.linalg.norm(rv))

  def place(env, body, pos, quat=(1.0, 0.0, 0.0, 0.0)):
    qpos[env, 7 * body:7 * body + 7] = np.concatenate([pos, quat])

  h, r = 0.08, 0.09
  # env 2: boxes b0, b10, b20 in a row along x and b30 beside b0 along y,
  # axis-aligned on the floor, each neighbour 1 mm into the next face; box
  # b3 stacked on b0; sphere b1 on b20; spheres b2 and b6 side by side.
  # The boxes stand 0.5 mm apart in height and 5-10 mm apart sideways:
  # where two aligned boxes' centres differ along only one axis, mjtpu's
  # SAT orients the edge axes perpendicular to it by sign(0) = 0, and those
  # zero axes win with separation 0, so the pair gets no contact
  z = h - 0.001
  for body, pos in ((0, (1.0, 1.0, z)), (10, (1.159, 1.01, z - 0.0005)),
                    (20, (1.318, 1.02, z)), (30, (1.005, 1.159, z - 0.0005))):
    place(2, body, pos)
  place(2, 3, (1.01, 1.005, z + 2 * h - 0.001))
  place(2, 1, (1.318, 1.02, z + h + r - 0.001))
  place(2, 2, (-1.0, 1.0, r - 0.001))
  place(2, 6, (-1.0 + 2 * r - 0.001, 1.0, r - 0.001))
  # env 3: box b4 on its edge (45 degrees about y, top edge along y) and
  # box b7 tilted 45 degrees about x, then 30 degrees about z, so that its
  # lowest edge crosses b4's top edge
  reach = h * np.sqrt(2.0)
  z4 = reach - 0.001
  place(3, 4, (-1.0, -1.0, z4), _axis_quat((0, 1, 0), np.pi / 4))
  tilt = _quat_mul(_axis_quat((0, 0, 1), np.pi / 6), _axis_quat((1, 0, 0), np.pi / 4))
  place(3, 7, (-1.0, -1.0, z4 + 2 * reach - 0.001), tilt)
  return qpos, np.zeros((BATCH, mjm.nv))


def pile_golden(mjm, steps: int = STEPS) -> dict[str, np.ndarray]:
  """The pile golden file's arrays (module docstring); prints the live
  contacts of each collision group after the first step."""
  import jax

  jax.config.update("jax_enable_x64", True)
  import jax.numpy as jnp

  import mjtpu

  qpos0, qvel0 = pile_initial_state(mjm)
  m = mjtpu.put_model(mjm, dtype=jnp.float64)
  d = jax.vmap(lambda _: mjtpu.make_data(m))(jnp.arange(BATCH))
  d = d.replace(qpos=jnp.asarray(qpos0), qvel=jnp.asarray(qvel0))
  step = jax.jit(jax.vmap(mjtpu.step, in_axes=(None, 0)))
  out = {"qpos": [], "qvel": []}
  for i in range(steps):
    d = step(m, d)
    if i == 0:
      first = jax.tree.map(np.asarray, d)
    if (i + 1) % PILE_EVERY == 0:
      for k in out:
        out[k].append(np.asarray(getattr(d, k)))
  g1, g2 = first.contact.geom1, first.contact.geom2
  live = first.contact.dist < 0
  types = np.asarray(mjm.geom_type)
  for t1, t2 in sorted({(int(types[a]), int(types[b])) for a, b in zip(g1.ravel(), g2.ravel())}):
    sel = (types[g1] == t1) & (types[g2] == t2)
    print(f"geom types ({t1}, {t2}): live contacts after step 1 per env"
          f" {(sel & live).sum(axis=1).tolist()}")
  print(f"solver iterations of step 1 per env: {first.solver_niter.tolist()}")
  return {
      "qpos0": qpos0, "qvel0": qvel0, **{k: np.stack(v) for k, v in out.items()},
      "qacc": first.qacc, "efc_force": first.efc_force, "contact_dist": first.contact.dist,
      "contact_pos": first.contact.pos, "contact_frame": first.contact.frame,
      "solver_niter": first.solver_niter,
  }


def load_branchy_mjmodel():
  """The 66-dof branchy tree of tests/test_sparse.py (_branchy_xml())."""
  import mujoco

  from tests.test_sparse import _branchy_xml

  return mujoco.MjModel.from_xml_string(_branchy_xml())


def branchy_initial_state(mjm, batch: int = BATCH):
  """(qpos, qvel) for the branchy envs: env e from numpy seed e, its hinge
  angles (every qpos after the trunk's free joint) qpos0 +-0.3 and qvel
  uniform in [-0.3, 0.3]."""
  qpos = np.tile(mjm.qpos0, (batch, 1))
  qvel = np.zeros((batch, mjm.nv))
  for e in range(batch):
    rng = np.random.default_rng(e)
    qpos[e, 7:] += rng.uniform(-0.3, 0.3, mjm.nq - 7)
    qvel[e] = rng.uniform(-0.3, 0.3, mjm.nv)
  return qpos, qvel


def branchy_golden(mjm, steps: int = STEPS) -> dict[str, np.ndarray]:
  """The branchy golden file's arrays (module docstring)."""
  import jax

  jax.config.update("jax_enable_x64", True)
  import jax.numpy as jnp

  import mjtpu

  qpos0, qvel0 = branchy_initial_state(mjm)
  m = mjtpu.put_model(mjm, dtype=jnp.float64)
  d = jax.vmap(lambda _: mjtpu.make_data(m))(jnp.arange(BATCH))
  d = d.replace(qpos=jnp.asarray(qpos0), qvel=jnp.asarray(qvel0))
  step = jax.jit(jax.vmap(mjtpu.step, in_axes=(None, 0)))
  out = {"qpos": [], "qvel": []}
  for i in range(steps):
    d = step(m, d)
    for k in out:
      out[k].append(np.asarray(getattr(d, k)))
    if i == 0:
      first = jax.tree.map(np.asarray, d)
  return {"qpos0": qpos0, "qvel0": qvel0, **{k: np.stack(v) for k, v in out.items()},
          **{k: getattr(first, k) for k in ("qLD", "qLDiagInv", "qacc_smooth", "qacc")}}


def load_ant_mjmodel():
  import mujoco

  return mujoco.MjModel.from_xml_path(str(ANT_XML))


def ant_initial_state(mjm, batch: int = BATCH, seed: int = 0):
  """(qpos, qvel, ctrl) for the ant envs: each joint uniform over its
  range, qvel 0, ctrl uniform in [-1, 1], from one numpy generator."""
  rng = np.random.default_rng(seed)
  lo, hi = mjm.jnt_range[:, 0], mjm.jnt_range[:, 1]
  qpos = np.tile(mjm.qpos0, (batch, 1))
  qpos[:, mjm.jnt_qposadr] = rng.uniform(lo, hi, (batch, mjm.njnt))
  ctrl = rng.uniform(-1.0, 1.0, (batch, mjm.nu))
  return qpos, np.zeros((batch, mjm.nv)), ctrl


def port_fields(d, prefix: str) -> dict[str, np.ndarray]:
  """Every field of the port's Data but qfrc_inverse (which only inverse
  writes; the goldens of forward Data leave it out), read by name from
  mjtpu's Data ``d`` (numpy leaves), under ``prefix`` (the contact fields
  under ``prefix + "contact."``)."""
  import dataclasses

  from mjtpu_torch._src import types

  out = {}
  for f in dataclasses.fields(types.Data):
    if f.name == "qfrc_inverse":
      continue
    if f.name == "contact":
      for c in dataclasses.fields(types.Contact):
        out[f"{prefix}contact.{c.name}"] = np.asarray(getattr(d.contact, c.name))
    else:
      out[prefix + f.name] = np.asarray(getattr(d, f.name))
  return out


def ant_golden(mjm, steps: int = STEPS) -> dict[str, np.ndarray]:
  """The ant golden file's arrays (module docstring); prints its touch
  and rangefinder readings."""
  import jax

  jax.config.update("jax_enable_x64", True)
  import jax.numpy as jnp

  import mjtpu

  qpos0, qvel0, ctrl = ant_initial_state(mjm)
  m = mjtpu.put_model(mjm, dtype=jnp.float64)
  d = jax.vmap(lambda _: mjtpu.make_data(m))(jnp.arange(BATCH))
  d = d.replace(qpos=jnp.asarray(qpos0), qvel=jnp.asarray(qvel0), ctrl=jnp.asarray(ctrl))
  start = d
  step = jax.jit(jax.vmap(mjtpu.step, in_axes=(None, 0)))
  out = {"qpos": [], "qvel": [], "sensordata": []}
  for i in range(steps):
    d = step(m, d)
    for k in out:
      out[k].append(np.asarray(getattr(d, k)))
    if i == 0:  # what _advance changed, put back
      fwd = jax.tree.map(np.asarray, d.replace(
          qpos=start.qpos, qvel=start.qvel, time=start.time, qacc=d.qacc_warmstart))
  out = {k: np.stack(v) for k, v in out.items()}
  stype = np.asarray(mjm.sensor_type)
  cols = lambda t: np.concatenate([mjm.sensor_adr[i] + np.arange(mjm.sensor_dim[i])
                                   for i in np.nonzero(stype == t)[0]])
  touch = out["sensordata"][..., cols(0)]  # mjSENS_TOUCH
  rays = out["sensordata"][..., cols(7)]   # mjSENS_RANGEFINDER
  print(f"touch readings not zero: {int((touch != 0).sum())} of {touch.size}"
        f" ({steps} steps x {BATCH} envs x {touch.shape[-1]} sensors)")
  print(f"rangefinder readings that hit: {int((rays >= 0).sum())} of {rays.size}")
  if not (touch != 0).any():
    raise AssertionError("the ant golden has no touch reading that is not zero")
  return {"qpos0": qpos0, "qvel0": qvel0, "ctrl": ctrl, **out, **port_fields(fwd, "fwd.")}


def load_zoo_mjmodel(name: str):
  import mujoco

  return mujoco.MjModel.from_xml_path(str(ZOO / f"{name}.xml"))


def ant_rk4_initial_state(mjm, batch: int = BATCH, seed: int = 0):
  """(qpos, qvel, ctrl): the Ant env's reset distribution (qpos0 +-0.1,
  qvel 0.1 x normal) and ctrl uniform in [-1, 1], from one numpy
  generator."""
  rng = np.random.default_rng(seed)
  qpos = mjm.qpos0[None] + rng.uniform(-0.1, 0.1, (batch, mjm.nq))
  qvel = 0.1 * rng.normal(size=(batch, mjm.nv))
  ctrl = rng.uniform(-1.0, 1.0, (batch, mjm.nu))
  return qpos, qvel, ctrl


def ant_rk4_golden(mjm, steps: int = STEPS) -> dict[str, np.ndarray]:
  """The ant RK4 golden file's arrays (module docstring)."""
  import jax

  jax.config.update("jax_enable_x64", True)
  import jax.numpy as jnp

  import mjtpu
  from mjtpu._src import forward as fwd

  qpos0, qvel0, ctrl = ant_rk4_initial_state(mjm)
  m = mjtpu.put_model(mjm, dtype=jnp.float64)
  d = jax.vmap(lambda _: mjtpu.make_data(m))(jnp.arange(BATCH))
  d = d.replace(qpos=jnp.asarray(qpos0), qvel=jnp.asarray(qvel0), ctrl=jnp.asarray(ctrl))

  # step 1's passes: mjtpu's rungekutta4 stages (forward.py:363-403),
  # replayed pass by pass so that each pass's qacc can be read
  forward = jax.jit(jax.vmap(fwd.forward, in_axes=(None, 0)))

  @jax.jit
  def stage_state(d0, dd, a):
    h = m.opt.timestep
    dd = jax.vmap(fwd._integrate_pos_only, in_axes=(None, 0, 0, 0, None))(
        m, dd, d0.qpos, dd.qvel, h * a)
    return dd.replace(qvel=d0.qvel + (h * a) * dd.qacc,
                      act=d0.act + (h * a) * dd.act_dot, time=d0.time + h * a)

  d0 = forward(m, jax.vmap(fwd._check_state, in_axes=(None, 0))(m, d))
  dd, passes = d0, [np.asarray(d0.qacc)]
  for a in jnp.asarray((0.5, 0.5, 1.0), jnp.float64):  # the tableau's A (forward.py:372)
    dd = forward(m, stage_state(d0, dd, a))
    passes.append(np.asarray(dd.qacc))

  step = jax.jit(jax.vmap(mjtpu.step, in_axes=(None, 0)))
  out = {"qpos": [], "qvel": []}
  for i in range(steps):
    d = step(m, d)
    for k in out:
      out[k].append(np.asarray(getattr(d, k)))
    if i == 0:
      qacc, warm = np.asarray(d.qacc), np.asarray(d.qacc_warmstart)
  gap = np.abs(passes[-1] - warm).max()
  print(f"ant RK4: last replayed pass vs mjtpu.step's qacc_warmstart: {gap:.3e}")
  if not gap <= 1e-10 * max(1.0, np.abs(warm).max()):
    raise AssertionError(f"the replayed RK4 passes differ from mjtpu.step by {gap:.3e}")
  return {"qpos0": qpos0, "qvel0": qvel0, "ctrl": ctrl,
          **{k: np.stack(v) for k, v in out.items()},
          "pass_qacc": np.stack(passes), "qacc": qacc, "qacc_warmstart": warm}


def env_initial_state(name: str, env, seed: int = 0):
  """(qpos, qvel, steps) of an env golden's 4 envs (module docstring)."""
  mjm = env.mj_model
  rng = np.random.default_rng(seed)
  noise = env.reset_noise
  qpos = mjm.qpos0[None] + rng.uniform(-noise, noise, (BATCH, mjm.nq))
  qvel = noise * rng.normal(size=(BATCH, mjm.nv))
  steps = np.zeros(BATCH, np.int32)
  if name == "ant":
    qpos[3, 2] = 1.2         # torso above the healthy band
  elif name in ("hopper", "walker2d"):
    qpos[3, 2] = 0.5 if name == "hopper" else 1.5  # tilted past the bound
  elif name == "cartpole":
    qpos[3, 1] = 1.5         # the pole past 1 rad
  elif name == "humanoid":
    qpos[3, 2] = 2.1         # torso above the healthy band
  elif name in ("halfcheetah",) + SATELLITE_ENVS:  # these never end early
    steps[3] = env.episode_length - 1
  if hasattr(env, "_rotor_dofs"):
    qvel[:, env._rotor_dofs()] = env.rotor_speed  # spinning, as their reset starts them
  return qpos, qvel, steps


def env_golden(names, steps: int = ENV_STEPS) -> dict[str, np.ndarray]:
  """An env golden file's arrays for ``names`` (module docstring)."""
  import jax

  jax.config.update("jax_enable_x64", True)
  import jax.numpy as jnp

  import mjtpu
  from mjtpu.zoo import ENVS
  from mjtpu.zoo.base import State

  out = {}
  for name in names:
    env = ENVS[name](dtype=jnp.float64)
    qpos0, qvel0, steps0 = env_initial_state(name, env)
    rng = np.random.default_rng(1)
    action = rng.uniform(-1.0, 1.0, (steps, BATCH, env.action_size))
    d = jax.vmap(lambda _: env._d0)(jnp.arange(BATCH))
    d = d.replace(qpos=jnp.asarray(qpos0), qvel=jnp.asarray(qvel0))
    d = jax.jit(jax.vmap(mjtpu.forward, in_axes=(None, 0)))(env.model, d)
    state = State(data=d, obs=jax.vmap(env._obs)(d), reward=jnp.zeros(BATCH),
                  done=jnp.zeros(BATCH, bool),
                  key=jax.random.split(jax.random.PRNGKey(0), BATCH),
                  steps=jnp.asarray(steps0), pixels=jnp.zeros((BATCH, 0)))
    step = jax.jit(jax.vmap(env.step))
    rec = {"obs": [], "reward": [], "done": [], "steps": []}
    for t in range(steps):
      state = step(state, jnp.asarray(action[t]))
      for k in rec:
        rec[k].append(np.asarray(getattr(state, k)))
    rec = {k: np.stack(v) for k, v in rec.items()}
    if rec["done"][:, :3].any() or not rec["done"][0, 3]:
      raise AssertionError(f"{name}: done {rec['done'].tolist()}: envs 0-2 must stay"
                           " healthy and env 3 end at the first step")
    print(f"{name}: rewards {rec['reward'].tolist()}")
    out.update({f"{name}.{k}": v for k, v in dict(
        qpos0=qpos0, qvel0=qvel0, steps0=steps0, action=action, **rec).items()})
  return out


def load_contact_mjmodel(name: str):
  """The cylinder drop, roll.xml or sph_cyl.xml."""
  import mujoco

  if name == "cylinder_drop":
    return mujoco.MjModel.from_xml_string(CYLINDER_DROP_XML)
  return mujoco.MjModel.from_xml_path(str(ROOT / "tests" / "models" / f"{name}.xml"))


def _free_joints(mjm) -> list[int]:
  return [int(mjm.jnt_qposadr[j]) for j in range(mjm.njnt) if mjm.jnt_type[j] == 0]  # mjJNT_FREE


def _perturb(mjm, qpos, rng, dpos: float, dang: float) -> None:
  """Moves every free body of the state qpos by up to dpos and turns it by
  up to dang radians about each axis, in place."""
  for adr in _free_joints(mjm):
    qpos[adr:adr + 3] += rng.uniform(-dpos, dpos, 3)
    rv = rng.uniform(-dang, dang, 3)
    qpos[adr + 3:adr + 7] = _quat_mul(qpos[adr + 3:adr + 7], _axis_quat(rv, np.linalg.norm(rv)))


def cylinder_drop_initial_state(mjm, seed: int = 0):
  """(qpos, qvel) of the 4 cylinder-drop envs: env 0 the model's drop pose
  (z 0.4, tilted 80 degrees); env 1 that pose moved by up to 5 cm, turned
  by up to 0.3 rad and thrown at up to 0.5 m/s and 2 rad/s; envs 2 and 3
  lying on one of their hull's side faces, 0.5 mm into the box's top (z =
  0.1), so that the face manifold of the hull is hit from the first step:
  env 2 at rest, env 3 turned 30 degrees about z and sliding along its
  axis at 0.3 m/s.  (None stands on its cap: the cap's 16 vertices tie
  exactly in depth and area, and rounding picks its contact slots; ROADMAP
  C6.)"""
  rng = np.random.default_rng(seed)
  qpos = np.tile(mjm.qpos0, (BATCH, 1))
  qvel = np.zeros((BATCH, mjm.nv))
  _perturb(mjm, qpos[1], rng, 0.05, 0.3)
  qvel[1] = np.concatenate([rng.uniform(-0.5, 0.5, 3), rng.uniform(-2.0, 2.0, 3)])
  r, depth = 0.08, 0.0005
  # a side face's outward normal is at 11.25 degrees from the hull's first
  # vertex (mjtpu's mesh.cylinder: 16 segments): turned onto +x about the
  # axis, then +x turned down (and the axis laid along x) about y
  lying = _quat_mul(_axis_quat((0, 1, 0), np.pi / 2), _axis_quat((0, 0, 1), -np.pi / 16))
  z = 0.1 + r * np.cos(np.pi / 16) - depth
  qpos[2, :7] = np.concatenate([[0.05, -0.03, z], lying])
  yaw = np.pi / 6
  qpos[3, :7] = np.concatenate([[-0.1, 0.08, z], _quat_mul(_axis_quat((0, 0, 1), yaw), lying)])
  qvel[3, :3] = 0.3 * np.array([np.cos(yaw), np.sin(yaw), 0.0])
  return qpos, qvel


def roll_initial_state(mjm, seed: int = 0):
  """(qpos, qvel) of the 4 roll.xml envs: env 0 qpos0 at rest; envs 1-3
  with each body lowered by up to 2.5 cm, moved and turned (1 cm, 0.2 rad)
  and thrown at up to 0.5 m/s and 3 rad/s."""
  rng = np.random.default_rng(seed)
  qpos = np.tile(mjm.qpos0, (BATCH, 1))
  qvel = np.zeros((BATCH, mjm.nv))
  for e in range(1, BATCH):
    _perturb(mjm, qpos[e], rng, 0.01, 0.2)
    qpos[e, 2::7] -= rng.uniform(0.0, 0.025, 2)
    for b in range(2):
      qvel[e, 6 * b:6 * b + 6] = np.concatenate([rng.uniform(-0.5, 0.5, 3),
                                                 rng.uniform(-3.0, 3.0, 3)])
  return qpos, qvel


def sph_cyl_initial_state(mjm, seed: int = 0):
  """(qpos, qvel) of the 4 sph_cyl.xml envs: env 0 qpos0 (the sphere 12
  cm over the cylinder) at rest; envs 1-3 the sphere moved by up to 2 cm
  sideways and lowered by 10 to 12.5 cm, onto the cylinder within the
  run, falling at up to 0.3 m/s."""
  rng = np.random.default_rng(seed)
  qpos = np.tile(mjm.qpos0, (BATCH, 1))
  qvel = np.zeros((BATCH, mjm.nv))
  for e in range(1, BATCH):
    qpos[e, :2] += rng.uniform(-0.02, 0.02, 2)
    qpos[e, 2] -= rng.uniform(0.1, 0.125)
    qvel[e, 2] = -rng.uniform(0.0, 0.3)
  return qpos, qvel


CONTACT_STATES = {"cylinder_drop": cylinder_drop_initial_state, "roll": roll_initial_state,
                  "sph_cyl": sph_cyl_initial_state}


def contact_golden(mjm, name: str, steps: int = STEPS) -> dict[str, np.ndarray]:
  """A contact model's golden arrays (module docstring); prints the live
  contacts (dist < 0) per env over the run."""
  import jax

  jax.config.update("jax_enable_x64", True)
  import jax.numpy as jnp

  import mjtpu

  qpos0, qvel0 = CONTACT_STATES[name](mjm)
  m = mjtpu.put_model(mjm, dtype=jnp.float64)
  d = jax.vmap(lambda _: mjtpu.make_data(m))(jnp.arange(BATCH))
  d = d.replace(qpos=jnp.asarray(qpos0), qvel=jnp.asarray(qvel0))
  step = jax.jit(jax.vmap(mjtpu.step, in_axes=(None, 0)))
  out = {"qpos": [], "qvel": []}
  live = np.zeros(BATCH, int)
  for i in range(steps):
    d = step(m, d)
    for k in out:
      out[k].append(np.asarray(getattr(d, k)))
    live += (np.asarray(d.contact.dist) < 0).sum(axis=1)
    if i == 0:
      first = jax.tree.map(np.asarray, d.contact)
  print(f"{name}: live contact slots per env over {steps} steps {live.tolist()}; after step 1"
        f" {(first.dist < 0).sum(axis=1).tolist()}")
  return {"qpos0": qpos0, "qvel0": qvel0, **{k: np.stack(v) for k, v in out.items()},
          **{f"contact_{k}": getattr(first, k) for k in ("dist", "pos", "frame", "geom1",
                                                         "geom2")}}


def scene_xmls() -> dict[str, str]:
  """The small collision scenes of collision_scenes.npz, name -> MJCF."""
  from tests.test_broadphase import _PILE
  from tests.test_collision import PAIR_SCENES as PAIRS
  from tests.test_collision import TETRA_ASSET
  from tests.test_collision_round import SCENES

  return {
      **SCENES, **{k: PAIRS[k] for k in PAIR_SCENES},
      # a tetrahedron upside down on another, apex into apex
      "mesh_mesh": f"""<mujoco>{TETRA_ASSET}<worldbody>
      <geom type="mesh" mesh="tetra"/>
      <body pos="0.005 0.003 0.15" euler="180 0 20"><freejoint/>
        <geom type="mesh" mesh="tetra"/></body>
      </worldbody></mujoco>""",
      "broadphase_pile": _PILE.format(
          custom='<custom><numeric name="max_geom_pairs" data="4"/></custom>'),
  }


def scene_initial_state(mjm, seed: int = 0) -> np.ndarray:
  """(SCENE_BATCH, nq): qpos0, and qpos0 with every free body moved by up
  to 2 mm and turned by up to 0.02 rad about each axis."""
  rng = np.random.default_rng(seed)
  qpos = np.tile(mjm.qpos0, (SCENE_BATCH, 1))
  _perturb(mjm, qpos[1], rng, 0.002, 0.02)
  return qpos


def scenes(names=None) -> tuple[dict, dict[str, np.ndarray]]:
  """(the scenes' snapshot arrays by name, the scene golden's arrays)."""
  import jax

  jax.config.update("jax_enable_x64", True)
  import jax.numpy as jnp
  import mujoco

  import mjtpu
  from mjtpu._src import mesh
  from mjtpu_torch._src import io

  snapshots, golden = {}, {}
  for name, xml in scene_xmls().items():
    if names and name not in names:
      continue
    mjm = mujoco.MjModel.from_xml_string(xml)
    snapshots[name] = io.snapshot_arrays(mjm, mesh_convex=mesh.get(mjm),
                                         geom_convex=sized_geom_convex(mjm))
    qpos = scene_initial_state(mjm)
    m = mjtpu.put_model(mjm, dtype=jnp.float64)
    d = jax.vmap(lambda _: mjtpu.make_data(m))(jnp.arange(SCENE_BATCH))
    d = d.replace(qpos=jnp.asarray(qpos))
    # the Model closed over: models with mesh hulls do not compare as jit
    # arguments from one scene to the next
    c = jax.jit(lambda d: jax.vmap(mjtpu.fwd_position, in_axes=(None, 0))(m, d))(d).contact
    golden[f"{name}.qpos0"] = qpos
    for k in ("dist", "pos", "frame", "geom1", "geom2"):
      golden[f"{name}.{k}"] = np.asarray(getattr(c, k))
    print(f"{name}: {np.asarray(c.dist).shape[1]} slots, live per env"
          f" {(np.asarray(c.dist) < 0).sum(axis=1).tolist()}")
    if not (np.asarray(c.dist) < 0).any(axis=1).all():
      raise AssertionError(f"scene {name} has an env without a live contact")
  return snapshots, golden


def load_elliptic_mjmodel():
  """humanoid_bench with elliptic cones: bench.py's humanoid_bench_elliptic
  (MJTPU_BENCH_CONE=elliptic)."""
  mjm = load_mjmodel()
  mjm.opt.cone = 1  # mjCONE_ELLIPTIC
  return mjm


def _mjtpu_run(mjm, start: dict, steps: int, fields=("qpos", "qvel"), schedule=None,
               rne_post=False, deriv=False):
  """Steps mjtpu (f64, CPU, jit(vmap(step))) from the state fields
  ``start`` (B envs), setting the fields of ``schedule`` ({field: (steps,
  B, ...)}) before each step: ({field: (steps, B, ...)} after each step,
  the forward Data of step 1 as port_fields under "fwd.": qpos, qvel and
  time put back, qacc the solver's; with ``rne_post`` also mjtpu's
  rne_postconstraint of it, its cfrc_ext under "rnepost.cfrc_ext"; with
  ``deriv`` mjtpu's deriv_smooth_vel of it under "deriv" (rne under the
  Implicit integrator) and, where the model has fluid forces, their
  velocity derivative alone under "deriv.fluid")."""
  import jax

  jax.config.update("jax_enable_x64", True)
  import jax.numpy as jnp

  import mjtpu

  batch = len(start["qpos"])
  m = mjtpu.put_model(mjm, dtype=jnp.float64)
  d = jax.vmap(lambda _: mjtpu.make_data(m))(jnp.arange(batch))
  d = d.replace(**{k: jnp.asarray(v) for k, v in start.items()})
  d0 = d
  step = jax.jit(jax.vmap(mjtpu.step, in_axes=(None, 0)))
  out = {k: [] for k in fields}
  post = {}
  for i in range(steps):
    if schedule:
      d = d.replace(**{k: jnp.asarray(v[i]) for k, v in schedule.items()})
    d = step(m, d)
    for k in out:
      out[k].append(np.asarray(getattr(d, k)))
    if i == 0:
      fwd = d.replace(qpos=d0.qpos, qvel=d0.qvel, time=d0.time, qacc=d.qacc_warmstart)
      if rne_post:
        from mjtpu._src import smooth

        post["rnepost.cfrc_ext"] = np.asarray(jax.jit(jax.vmap(
            smooth.rne_postconstraint, in_axes=(None, 0)))(m, fwd).cfrc_ext)
      if deriv:
        post.update(_mjtpu_deriv(m, fwd.replace(act=d0.act)))
      fwd = jax.tree.map(np.asarray, fwd)
  return {k: np.stack(v) for k, v in out.items()}, {**port_fields(fwd, "fwd."), **post}


def _mjtpu_deriv(m, fwd) -> dict[str, np.ndarray]:
  """mjtpu's deriv_smooth_vel of the batched forward Data ``fwd`` (rne
  under the Implicit integrator) and, where the model has fluid forces,
  the jacfwd of its com_vel + passive._fluid alone: {"deriv": (B, nv, nv),
  "deriv.fluid": (B, nv, nv)}."""
  import jax

  from mjtpu._src import derivative, passive, smooth
  from mjtpu._src.types import IntegratorType

  full = m.opt.integrator == IntegratorType.IMPLICIT
  out = {"deriv": np.asarray(jax.jit(jax.vmap(
      lambda dd: derivative.deriv_smooth_vel(m, dd, rne=full)))(fwd))}
  if m.opt.has_fluid_params:
    fluid = lambda dd: jax.jacfwd(
        lambda v: passive._fluid(m, smooth.com_vel(m, dd.replace(qvel=v))))(dd.qvel)
    out["deriv.fluid"] = np.asarray(jax.jit(jax.vmap(fluid))(fwd))
  return out


def _mjtpu_solo(mjm, start: dict, run: dict, steps: int) -> dict[str, np.ndarray]:
  """mjtpu compiled for one env (jit(step), f64, CPU), env by env: one
  step from the batched ``run``'s state before each of its steps
  (solo_qpos, solo_qvel) and its own run from ``start`` (solo_run_qpos,
  solo_run_qvel), each (steps, B, ...)."""
  import jax

  jax.config.update("jax_enable_x64", True)
  import jax.numpy as jnp

  import mjtpu

  m = mjtpu.put_model(mjm, dtype=jnp.float64)
  step = jax.jit(lambda d: mjtpu.step(m, d))
  d0 = mjtpu.make_data(m)
  before = lambda k, first: np.concatenate([first[None], run[k][:steps - 1]])
  prev = {"qpos": before("qpos", start["qpos"]), "qvel": before("qvel", start["qvel"]),
          "qacc_warmstart": before("qacc_warmstart", np.zeros_like(run["qacc_warmstart"][0]))}
  out = {k: np.zeros((steps,) + run[k].shape[1:]) for k in ("qpos", "qvel")}
  solo = {f"run_{k}": np.zeros_like(v) for k, v in out.items()}
  for e in range(len(start["qpos"])):
    ctrl = jnp.asarray(start["ctrl"][e])
    d = d0.replace(qpos=jnp.asarray(start["qpos"][e]), qvel=jnp.asarray(start["qvel"][e]), ctrl=ctrl)
    for i in range(steps):
      got = step(d0.replace(ctrl=ctrl, **{k: jnp.asarray(v[i, e]) for k, v in prev.items()}))
      d = step(d)
      for k in ("qpos", "qvel"):
        out[k][i, e] = np.asarray(getattr(got, k))
        solo[f"run_{k}"][i, e] = np.asarray(getattr(d, k))
  return {f"solo_{k}": v for k, v in {**out, **solo}.items()}


def elliptic_golden(mjm, steps: int = STEPS) -> dict[str, np.ndarray]:
  """The humanoid_bench_elliptic golden's arrays (module docstring)."""
  import copy

  qpos0, qvel0, ctrl = initial_state(mjm)
  start = {"qpos": qpos0, "qvel": qvel0, "ctrl": ctrl}
  fields = ("qpos", "qvel", "qacc_warmstart")
  run, fwd = _mjtpu_run(mjm, start, steps, fields)
  conv = copy.copy(mjm)
  conv.opt.iterations = conv.opt.ls_iterations = CONVERGED
  conv_run, _ = _mjtpu_run(conv, start, steps, fields)
  live = (fwd["fwd.contact.dist"] < 0).sum(axis=1)
  print(f"humanoid_bench_elliptic: live contacts per env at step 1 {live.tolist()}")
  solo = _mjtpu_solo(mjm, start, run, steps)
  conv_solo = _mjtpu_solo(conv, start, conv_run, steps)
  return {
      "qpos0": qpos0, "qvel0": qvel0, "ctrl": ctrl, "qpos": run["qpos"], "qvel": run["qvel"],
      "warm": run["qacc_warmstart"], "qacc": fwd["fwd.qacc"], "efc_force": fwd["fwd.efc_force"],
      "contact_dist": fwd["fwd.contact.dist"], "conv_qpos": conv_run["qpos"],
      "conv_qvel": conv_run["qvel"], "conv_warm": conv_run["qacc_warmstart"], **solo,
      **{f"conv_{k}": v for k, v in conv_solo.items()},
      "converged_iterations": np.array(CONVERGED),
      "converged_ls_iterations": np.array(CONVERGED), **fwd,
  }


def cone_scene_xmls() -> dict[str, str]:
  """The scenes of cone_scenes.npz, name -> MJCF: the test models, the
  two frictionloss scenes and the elliptic fuzz scenes of FUZZ_SEEDS
  that put_model takes (it prints why it refuses the others)."""
  import mujoco

  import mjtpu_torch
  from mjtpu._src.test_util import create_mjcf

  xmls = {name: (ROOT / "tests" / "models" / f"{name}.xml").read_text() for name in CONE_XMLS}
  xmls["frictionloss_slide"] = FRICTIONLOSS_SLIDE_XML
  xmls["frictionloss_chain"] = FRICTIONLOSS_CHAIN_XML
  for seed in FUZZ_SEEDS:
    xml = create_mjcf(seed + 500, geom_types=("sphere", "capsule"), cone="elliptic",
                      contact_pairs=True, frictionloss=(seed % 2 == 0))
    try:
      mjtpu_torch.put_model(mujoco.MjModel.from_xml_string(xml), device="cpu")
    except NotImplementedError as e:
      print(f"fuzz seed {seed}: refused: {e}")
      continue
    xmls[f"fuzz_{seed}"] = xml
  return xmls


def _subtree_lowest(mjm, mjd, root: int) -> float:
  """The lowest world z over the sphere and capsule geoms of ``root``'s
  tree."""
  low = np.inf
  for g in range(mjm.ngeom):
    t = mjm.geom_type[g]
    if mjm.body_rootid[mjm.geom_bodyid[g]] != root or t not in (2, 3):
      continue
    half = abs(mjd.geom_xmat[g, 8]) * mjm.geom_size[g, 1] if t == 3 else 0.0
    low = min(low, mjd.geom_xpos[g, 2] - half - mjm.geom_size[g, 0])
  return low


def cone_initial_state(mjm, name: str, seed: int = 0) -> dict[str, np.ndarray]:
  """The state fields of a cone scene's 4 envs: every free tree lowered
  until its lowest point is 0 to 2 mm into the floor (z = 0), condim_cg's
  second sphere laid on its first instead, 5 mm off the top; env 0 at rest
  (no slip: the cone's T = 0), envs 1-3 sliding at up to 0.5 m/s and
  spinning at up to 5 rad/s; hinges and slides within +-0.5 of qpos0 and
  moving at up to 1 rad/s (frictionloss_slide: pushed by 10, 1, -10 and
  0.5 N instead, its two regimes both ways)."""
  import mujoco

  rng = np.random.default_rng(seed)
  mjd = mujoco.MjData(mjm)
  qpos = np.tile(mjm.qpos0, (BATCH, 1))
  qvel = np.zeros((BATCH, mjm.nv))
  for e in range(BATCH):
    for j in range(mjm.njnt):
      q, v = mjm.jnt_qposadr[j], mjm.jnt_dofadr[j]
      if mjm.jnt_type[j] in (2, 3):  # slide, hinge
        lo, hi = (mjm.jnt_range[j] if mjm.jnt_limited[j] else (-np.inf, np.inf))
        qpos[e, q] = np.clip(mjm.qpos0[q] + rng.uniform(-0.5, 0.5), lo, hi)
        qvel[e, v] = rng.uniform(-1.0, 1.0) if e else 0.0
    mjd.qpos[:] = qpos[e]
    mujoco.mj_kinematics(mjm, mjd)
    for j in range(mjm.njnt):
      if mjm.jnt_type[j] != 0:  # mjJNT_FREE
        continue
      q, v, b = mjm.jnt_qposadr[j], mjm.jnt_dofadr[j], mjm.jnt_bodyid[j]
      qpos[e, q + 2] -= _subtree_lowest(mjm, mjd, b) + rng.uniform(0.0, 0.002)
      if e:
        qvel[e, v:v + 6] = np.concatenate([rng.uniform(-0.5, 0.5, 2), [0.0],
                                           rng.uniform(-5.0, 5.0, 3)])
    if name == "condim_cg":
      # sphere 2 (r 0.1, 0.12 m off in x) on sphere 1, 5 mm into it
      qpos[e, 9] = qpos[e, 2] + np.sqrt(0.195 ** 2 - 0.12 ** 2)
  start = {"qpos": qpos, "qvel": qvel}
  if name == "frictionloss_slide":
    start["qfrc_applied"] = np.array([[10.0], [1.0], [-10.0], [0.5]])
  return start


def cone_scenes(names=None, steps: int = STEPS) -> tuple[dict, dict[str, np.ndarray]]:
  """(the cone scenes' snapshot arrays by name, the cone golden's
  arrays)."""
  import mujoco

  from mjtpu_torch._src import io

  snapshots, golden = {}, {}
  for name, xml in cone_scene_xmls().items():
    if names and name not in names:
      continue
    mjm = mujoco.MjModel.from_xml_string(xml)
    snapshots[name] = io.snapshot_arrays(mjm)
    start = cone_initial_state(mjm, name)
    fields = ("qpos", "qvel") + (("sensordata",) if mjm.nsensordata else ())
    run, fwd = _mjtpu_run(mjm, start, steps, fields)
    golden.update({f"{name}.{k}0": v for k, v in start.items()})
    golden.update({f"{name}.{k}": v for k, v in {**run, **fwd}.items()})
    live = (run["qpos"].shape, (fwd["fwd.contact.dist"] < 0).sum(axis=1).tolist())
    print(f"{name}: nefc {fwd['fwd.efc_D'].shape[1]}, live contacts per env at step 1 {live[1]}")
  return snapshots, golden


def fluid_scene_xmls() -> dict[str, str]:
  """The scenes of fluid_scenes.npz, name -> MJCF: tests/test_fluid.py's
  mixed model (ellipsoid-model geoms of five types, a body on the box
  model, wind), GRAVCOMP_XML with and without its actuators (nu = 0:
  fwd_actuation's early return) and BOX_WIND_XML."""
  import re

  from tests.test_fluid import MIXED_XML

  return {"mixed": MIXED_XML, "gravcomp": GRAVCOMP_XML,
          "gravcomp_noact": re.sub(r"<actuator>.*</actuator>", "", GRAVCOMP_XML, flags=re.S),
          "box_wind": BOX_WIND_XML}


def fluid_initial_state(mjm, seed: int = 0) -> dict[str, np.ndarray]:
  """The state fields of a fluid scene's 4 envs: qpos0 +-0.3 with every
  quaternion normalized, qvel and ctrl uniform in [-1, 1]."""
  import mujoco

  rng = np.random.default_rng(seed)
  qpos = mjm.qpos0[None] + rng.uniform(-0.3, 0.3, (BATCH, mjm.nq))
  for q in qpos:
    mujoco.mj_normalizeQuat(mjm, q)
  return {"qpos": qpos, "qvel": rng.uniform(-1.0, 1.0, (BATCH, mjm.nv)),
          "ctrl": rng.uniform(-1.0, 1.0, (BATCH, mjm.nu))}


def fluid_scenes(names=None, steps: int = STEPS) -> tuple[dict, dict[str, np.ndarray]]:
  """(the fluid scenes' snapshot arrays by name, the fluid golden's
  arrays: per scene its start, mjtpu's qpos and qvel after each step and
  the forward Data of step 1)."""
  import mujoco

  from mjtpu_torch._src import io

  snapshots, golden = {}, {}
  for name, xml in fluid_scene_xmls().items():
    if names and name not in names:
      continue
    mjm = mujoco.MjModel.from_xml_string(xml)
    snapshots[name] = io.snapshot_arrays(mjm)
    start = fluid_initial_state(mjm)
    run, fwd = _mjtpu_run(mjm, start, steps)
    golden.update({f"{name}.{k}0": v for k, v in start.items()})
    golden.update({f"{name}.{k}": v for k, v in {**run, **fwd}.items()})
    scale = {k: float(np.abs(fwd[f"fwd.qfrc_{k}"]).max()) for k in ("fluid", "gravcomp")}
    print(f"{name}: step-1 max |qfrc_fluid| {scale['fluid']:.3e}, |qfrc_gravcomp|"
          f" {scale['gravcomp']:.3e}")
  return snapshots, golden


def limit_sensor_xml() -> str:
  """tests/test_limit_sensors.py's XML with the ball joint's limit and its
  three limit sensors dropped (the port refuses ball-joint limits): the
  hinge's and the tendon's limit sensors stay."""
  import re

  from tests.test_limit_sensors import XML

  xml = XML.replace(' range="0 0.4" margin="0.05"', "")
  return re.sub(r'<jointlimit(pos|vel|frc) joint="b"/>', "", xml)


def tendon_scene_xmls() -> dict[str, str]:
  """The scenes of tendon_scenes.npz, name -> MJCF: TENDON_MIXED_XML,
  tests/test_tendon.py's sphere, cylinder (no side site, outside, inside)
  and pulley scenes, tests/models' friction_tendon.xml, muscle.xml and
  sensors.xml, tests/test_transmission.py's slider-crank and adhesion
  models, and limit_sensor_xml."""
  from tests import test_tendon as tt
  from tests import test_transmission as tr

  cyl = lambda z, side: tt._CYL_XML.replace("SIDEZ", z).replace("SIDE", side)
  models = ROOT / "tests" / "models"
  return {
      "mixed": TENDON_MIXED_XML,
      "sphere": tt._sphere_xml(side=False),
      "sphere_side_out": tt._sphere_xml(side=True, sidepos="0 0 -1.0"),
      "sphere_side_in": tt._sphere_xml(side=True, sidepos="0.05 0 -0.25"),
      "cylinder": cyl("-1.0", ""),
      "cylinder_side_out": cyl("-1.0", ' sidesite="side"'),
      "cylinder_side_in": cyl("-0.3", ' sidesite="side"'),
      "pulley": tt._PULLEY_XML,
      **{name: (models / f"{name}.xml").read_text()
         for name in ("friction_tendon", "muscle", "sensors")},
      "slidercrank": tr.XML,
      "adhesion": tr.ADHESION_XML,
      "limit_sensors": limit_sensor_xml(),
  }


def tendon_initial_state(mjm, name: str, seed: int = 0) -> dict[str, np.ndarray]:
  """The state fields of a tendon scene's 4 envs: qpos0 +-0.3 with every
  quaternion normalized, qvel in [-0.5, 0.5], ctrl in [-1, 1] and act in
  [0, 1]; the adhesion scene's box at ADHESION_LIFTS, at rest, ctrl 1."""
  import mujoco

  rng = np.random.default_rng(seed)
  qpos = mjm.qpos0[None] + rng.uniform(-0.3, 0.3, (BATCH, mjm.nq))
  qvel = rng.uniform(-0.5, 0.5, (BATCH, mjm.nv))
  ctrl = rng.uniform(-1.0, 1.0, (BATCH, mjm.nu))
  if name == "adhesion":
    qpos = np.tile(mjm.qpos0, (BATCH, 1))
    qpos[:, 2] = ADHESION_LIFTS
    qvel, ctrl = np.zeros_like(qvel), np.ones_like(ctrl)
  for q in qpos:
    mujoco.mj_normalizeQuat(mjm, q)
  start = {"qpos": qpos, "qvel": qvel, "ctrl": ctrl}
  if mjm.na:
    start["act"] = rng.uniform(0.0, 1.0, (BATCH, mjm.na))
  return start


def _mjtpu_poses(mjm, seed: int = 0) -> dict[str, np.ndarray]:
  """mjtpu's tendons (f64, CPU, jit(vmap(fwd_position))) at POSES poses,
  qpos0 +-POSE_SPREAD: the poses and each tendon field of the port's Data."""
  import jax

  jax.config.update("jax_enable_x64", True)
  import jax.numpy as jnp

  import mjtpu

  rng = np.random.default_rng(seed)
  qpos = mjm.qpos0[None] + rng.uniform(-POSE_SPREAD, POSE_SPREAD, (POSES, mjm.nq))
  m = mjtpu.put_model(mjm, dtype=jnp.float64)
  d = jax.vmap(lambda _: mjtpu.make_data(m))(jnp.arange(POSES)).replace(qpos=jnp.asarray(qpos))
  d = jax.jit(jax.vmap(mjtpu.fwd_position, in_axes=(None, 0)))(m, d)
  fields = ("ten_length", "ten_J", "ten_wrap_xpos", "ten_wrap_active")
  return {"poses.qpos": qpos, **{f"poses.{k}": np.asarray(getattr(d, k)) for k in fields}}


def tendon_scenes(names=None, steps: int = STEPS) -> tuple[dict, dict[str, np.ndarray]]:
  """(the tendon scenes' snapshot arrays by name, the tendon golden's
  arrays: per scene its start, mjtpu's qpos, qvel, act and sensordata
  after each step, the forward Data of step 1, and for the wrap scenes
  mjtpu's tendons at the seeded poses)."""
  import mujoco

  from mjtpu_torch._src import io

  snapshots, golden = {}, {}
  for name, xml in tendon_scene_xmls().items():
    if names and name not in names:
      continue
    mjm = mujoco.MjModel.from_xml_string(xml)
    snapshots[name] = io.snapshot_arrays(mjm)
    start = tendon_initial_state(mjm, name)
    fields = ("qpos", "qvel") + (("act",) if mjm.na else ()) + (
        ("sensordata",) if mjm.nsensordata else ())
    run, fwd = _mjtpu_run(mjm, start, steps, fields)
    golden.update({f"{name}.{k}0": v for k, v in start.items()})
    golden.update({f"{name}.{k}": v for k, v in {**run, **fwd}.items()})
    if name in WRAP_SCENES:
      poses = _mjtpu_poses(mjm)
      golden.update({f"{name}.{k}": v for k, v in poses.items()})
      print(f"{name}: wraps active in {int(poses['poses.ten_wrap_active'].sum())} of"
            f" {poses['poses.ten_wrap_active'].size} pose entries")
    print(f"{name}: ntendon {mjm.ntendon}, na {mjm.na}, nefc {fwd['fwd.efc_D'].shape[1]}")
  return snapshots, golden


def equality_scene_xmls() -> dict[str, str]:
  """The scenes of equality_scenes.npz, name -> MJCF: tests/models'
  mocap.xml (Euler and ImplicitFast), weld.xml, equality.xml and
  ball_free.xml (Euler and ImplicitFast), tests/test_blocks.py's FOREST_XML
  and TENDON_COUPLED_XML under ImplicitFast, the two ball-limit models of
  tests/test_constraint.py, tests/test_limit_sensors.py's XML, the tendon
  equality of tests/test_tendon.py, EQ_ORDER_XML, and the equality fuzz
  scenes of EQ_FUZZ_SEEDS."""
  from mjtpu._src.test_util import create_mjcf
  from tests import test_blocks, test_limit_sensors, test_tendon

  models = ROOT / "tests" / "models"
  read = lambda name: (models / f"{name}.xml").read_text()
  implicitfast = lambda xml, opt: xml.replace(opt, opt[:-2] + ' integrator="implicitfast"/>', 1)
  xmls = {
      "mocap": read("mocap"),
      "mocap_implicitfast": implicitfast(read("mocap"), '<option timestep="0.005"/>'),
      "weld": read("weld"),
      "equality": read("equality"),
      "ball_free": read("ball_free"),
      "ball_free_implicitfast": implicitfast(read("ball_free"), '<option timestep="0.002"/>'),
      "forest_implicitfast": implicitfast(test_blocks.FOREST_XML, '<option timestep="0.002"/>'),
      "tendon_coupled_implicitfast": implicitfast(test_blocks.TENDON_COUPLED_XML,
                                                  '<option timestep="0.002"/>'),
      "ball_limit_margin": BALL_LIMIT_MARGIN_XML,
      "ball_limit_order": BALL_LIMIT_ORDER_XML,
      "limit_sensors": test_limit_sensors.XML,
      "tendon_equality": test_tendon._EQ_XML.replace(
          "EQ", '<tendon tendon1="ta" tendon2="tb" polycoef="0.05 1.2 0.1 0 0"/>'),
      "eq_order": EQ_ORDER_XML,
  }
  for seed in EQ_FUZZ_SEEDS:
    xmls[f"fuzz_{seed}"] = create_mjcf(
        seed + 400, geom_types=("sphere", "capsule"), tendons=True, equality=True,
        equality_types=("connect", "weld", "joint", "tendon"))
  return xmls


def equality_initial_state(mjm, name: str, seed: int = 0) -> dict[str, np.ndarray]:
  """The state fields of an equality scene's 4 envs: env 0 at qpos0 (a
  ball joint at zero rotation), envs 1-3 with hinges and slides +-0.3,
  ball quaternions +-0.3 and free quaternions +-0.1 before normalizing,
  free positions +-0.05; every env's qvel in [-0.5, 0.5], ctrl in [-1, 1];
  equality.xml with its connect off in env 2 and its joint coupling off in
  env 3 (eq_active); mocap.xml's ball in contact in envs 1-3
  (_mocap_contacts, from equality_scenes)."""
  rng = np.random.default_rng(seed)
  spread = np.full(mjm.nq, 0.3)
  for j in range(mjm.njnt):
    q = mjm.jnt_qposadr[j]
    if mjm.jnt_type[j] == 0:  # mjJNT_FREE
      spread[q:q + 7] = (0.05, 0.05, 0.05, 0.1, 0.1, 0.1, 0.1)
  qpos = mjm.qpos0[None] + rng.uniform(-1.0, 1.0, (BATCH, mjm.nq)) * spread
  qpos[0] = mjm.qpos0
  for j in range(mjm.njnt):
    q = mjm.jnt_qposadr[j]
    if mjm.jnt_type[j] in (0, 1):  # free, ball
      quat = qpos[:, q + 3:q + 7] if mjm.jnt_type[j] == 0 else qpos[:, q:q + 4]
      quat /= np.linalg.norm(quat, axis=1, keepdims=True)
  start = {"qpos": qpos, "qvel": rng.uniform(-0.5, 0.5, (BATCH, mjm.nv)),
           "ctrl": rng.uniform(-1.0, 1.0, (BATCH, mjm.nu))}
  if mjm.na:
    start["act"] = rng.uniform(0.0, 1.0, (BATCH, mjm.na))
  if name == "equality":
    start["eq_active"] = np.ones((BATCH, mjm.neq), bool)
    start["eq_active"][2, 0] = start["eq_active"][3, 1] = False
  return start


def mocap_schedule(mjm, steps: int, seed: int = 0) -> dict[str, np.ndarray]:
  """mocap.xml's targets before each step (chip_smoke.mocap_targets, the
  moving-target schedule of tests/test_mocap.py) for BATCH envs, each at
  its own phase, uniform in [0, MOCAP_PHASE_S) s (numpy seed ``seed``):
  {"mocap_pos": (steps, B, nmocap, 3), "mocap_quat": (steps, B, nmocap, 4)}."""
  import torch

  import chip_smoke

  phase = np.random.default_rng(seed).uniform(0.0, chip_smoke.MOCAP_PHASE_S, BATCH)
  bodies = np.nonzero(mjm.body_mocapid >= 0)[0]
  base = torch.as_tensor(mjm.body_pos[bodies[np.argsort(mjm.body_mocapid[bodies])]])
  out = {"mocap_pos": [], "mocap_quat": []}
  for i in range(steps):
    pos, quat = chip_smoke.mocap_targets(base, torch.as_tensor(i * mjm.opt.timestep + phase))
    out["mocap_pos"].append(pos.numpy())
    out["mocap_quat"].append(quat.numpy())
  return {k: np.stack(v) for k, v in out.items()}


def _mocap_contacts(mjm, start: dict, schedule: dict) -> None:
  """Puts mocap.xml's ball in contact at step 1: in env 1 at rest 2 mm
  into the floor (a contact with the world body, whose cfrc_ext row MuJoCo
  C leaves at zero), in env 2 at rest 2 mm into the face of the mocap box
  that faces down at the box's pose before step 1 (sphere-box against the
  moving mocap body), in env 3 at rest 2 mm into the top of the payload
  (two free bodies, two trees)."""
  import mujoco

  body = lambda name: mujoco.mj_name2id(mjm, mujoco.mjtObj.mjOBJ_BODY, name)
  size = lambda name: mjm.geom_size[mujoco.mj_name2id(mjm, mujoco.mjtObj.mjOBJ_GEOM, name)]
  free = lambda name: (mjm.jnt_qposadr[mjm.body_jntadr[body(name)]],
                       mjm.jnt_dofadr[mjm.body_jntadr[body(name)]])
  (q, v), (qp, _) = free("ball"), free("payload")
  r = size("ball_sphere")[0]
  mocap = mjm.body_mocapid[body("target")]
  mat = np.zeros(9)
  mujoco.mju_quat2Mat(mat, schedule["mocap_quat"][0, 2, mocap])
  down = -mat.reshape(3, 3)[:, 2]
  start["qpos"][2, q:q + 3] = (schedule["mocap_pos"][0, 2, mocap]
                               + (size("target_box")[2] + r - 0.002) * down)
  start["qpos"][3, q:q + 3] = start["qpos"][3, qp:qp + 3] + (0.0, 0.0,
                                                             size("payload_sphere")[0] + r - 0.002)
  start["qpos"][1, q + 2] = r - 0.002
  for env in (1, 2, 3):
    start["qpos"][env, q + 3:q + 7] = (1.0, 0.0, 0.0, 0.0)
    start["qvel"][env, v:v + 6] = 0.0


def _c_step1(mjm, start: dict, schedule: dict | None) -> dict[str, np.ndarray]:
  """MuJoCo C at an equality scene's start states (the mocap targets of
  step 1 set): mj_forward, then mj_rnePostConstraint, env by env:
  {"c.cfrc_ext": (B, nbody, 6)}; and mjtpu's static efc row labels
  (support.efc_row_meta): {"efc_type", "efc_id": (nefc,)}."""
  import mujoco

  import mjtpu
  from mjtpu._src import support

  out = []
  for e in range(BATCH):
    mjd = mujoco.MjData(mjm)
    for k, v in start.items():
      getattr(mjd, k)[:] = v[e]
    for k, v in (schedule or {}).items():
      getattr(mjd, k)[:] = v[0, e]
    mujoco.mj_forward(mjm, mjd)
    mujoco.mj_rnePostConstraint(mjm, mjd)
    out.append(np.array(mjd.cfrc_ext))
  efc_type, efc_id = support.efc_row_meta(mjtpu.put_model(mjm))
  return {"c.cfrc_ext": np.stack(out), "efc_type": np.asarray(efc_type),
          "efc_id": np.asarray(efc_id)}


def equality_scenes(names=None, steps: int = STEPS) -> tuple[dict, dict[str, np.ndarray]]:
  """(the equality scenes' snapshot arrays by name, the equality golden's
  arrays: per scene its start, mjtpu's qpos, qvel (act, sensordata) after
  each step, the forward Data of step 1 and mjtpu's rne_postconstraint
  cfrc_ext of it, its static efc row labels, MuJoCo C's cfrc_ext at the
  start; the mocap scenes' targets before each step)."""
  import mujoco

  from mjtpu_torch._src import io

  snapshots, golden = {}, {}
  for name, xml in equality_scene_xmls().items():
    if names and name not in names:
      continue
    mjm = mujoco.MjModel.from_xml_string(xml)
    snapshots[name] = io.snapshot_arrays(mjm)
    start = equality_initial_state(mjm, name)
    schedule = None
    if mjm.nmocap:
      schedule = mocap_schedule(mjm, steps)
      _mocap_contacts(mjm, start, schedule)
    fields = ("qpos", "qvel") + (("act",) if mjm.na else ()) + (
        ("sensordata",) if mjm.nsensordata else ())
    run, fwd = _mjtpu_run(mjm, start, steps, fields, schedule, rne_post=True)
    golden.update({f"{name}.{k}0": v for k, v in start.items()})
    golden.update({f"{name}.{k}": v for k, v in {**run, **fwd, **(schedule or {}),
                                                  **_c_step1(mjm, start, schedule)}.items()})
    print(f"{name}: nv {mjm.nv}, neq {mjm.neq} (types {mjm.eq_type.tolist()}), nmocap"
          f" {mjm.nmocap}, nefc {fwd['fwd.efc_D'].shape[1]}, live contacts per env at step 1"
          f" {(fwd['fwd.contact.dist'] < 0).sum(axis=1).tolist()}")
  return snapshots, golden


def _with_integrator(xml: str, integrator: str) -> str:
  """``xml`` with its <option>'s integrator set to ``integrator``."""
  import re

  option = re.search(r"<option\b[^>]*>", xml).group(0)
  if "integrator=" in option:
    new = re.sub(r'integrator="[^"]*"', f'integrator="{integrator}"', option)
  else:
    new = option.replace("<option", f'<option integrator="{integrator}"', 1)
  return xml.replace(option, new, 1)


def load_humanoid_implicit_mjmodel():
  """The zoo's humanoid.xml under the full Implicit integrator
  (humanoid_implicit)."""
  mjm = load_zoo_mjmodel("humanoid")
  mjm.opt.integrator = 2  # mjINT_IMPLICIT
  return mjm


def implicit_scene_xmls() -> dict[str, str]:
  """The scenes of implicit_scenes.npz, name -> MJCF: tests/models'
  implicit_full.xml and implicit_fluid.xml (also under ImplicitFast, where
  mjtpu parts from MuJoCo C, ROADMAP C14), ELLIPSOID_FLUID_XML under
  Implicit and ImplicitFast, the zoo's swimmer.xml (the box fluid model)
  under ImplicitFast, friction_tendon.xml and condim4_elliptic.xml under
  Implicit, and the implicit fuzz scenes of IMPLICIT_FUZZ_SEEDS."""
  from mjtpu._src.test_util import create_mjcf

  models = ROOT / "tests" / "models"
  read = lambda name: (models / f"{name}.xml").read_text()
  xmls = {
      "implicit_full": read("implicit_full"),
      "implicit_fluid": read("implicit_fluid"),
      "implicit_fluid_implicitfast": _with_integrator(read("implicit_fluid"), "implicitfast"),
      "ellipsoid_implicit": ELLIPSOID_FLUID_XML.format(integ="implicit"),
      "ellipsoid_implicitfast": ELLIPSOID_FLUID_XML.format(integ="implicitfast"),
      "swimmer_implicitfast": _with_integrator((ZOO / "swimmer.xml").read_text(), "implicitfast"),
      "friction_tendon_implicit": _with_integrator(read("friction_tendon"), "implicit"),
      "condim4_elliptic_implicit": _with_integrator(read("condim4_elliptic"), "implicit"),
  }
  for seed in IMPLICIT_FUZZ_SEEDS:
    xmls[f"fuzz_{seed}"] = create_mjcf(
        seed + 600, geom_types=("sphere", "capsule"),
        integrator="implicit" if seed % 2 else "implicitfast", tendons=True,
        frictionloss=(seed % 3 == 0))
  return xmls


def implicit_initial_state(mjm, name: str, seed: int = 0) -> dict[str, np.ndarray]:
  """The state fields of an implicit scene's 4 envs: qpos0 +-0.05 (the
  humanoid's +-0.01) with every quaternion normalized, envs 0 and 1 at
  rest and envs 2 and 3 moving at up to 0.5 (the ellipsoid-fluid scenes:
  every env at up to 2, as tests/test_fluid.py starts them: at rest their
  angular drag's derivative is NaN in mjtpu, ROADMAP C15), ctrl in [-1,
  1]; condim4_elliptic's start is cone_initial_state's."""
  import mujoco

  if name.startswith("condim4_elliptic"):
    return cone_initial_state(mjm, "condim4_elliptic", seed)
  rng = np.random.default_rng(seed)
  spread = 0.01 if name == "humanoid_implicit" else 0.05
  qpos = mjm.qpos0[None] + rng.uniform(-spread, spread, (BATCH, mjm.nq))
  for q in qpos:
    mujoco.mj_normalizeQuat(mjm, q)
  speed = 2.0 if name.startswith("ellipsoid") else 0.5
  qvel = rng.uniform(-speed, speed, (BATCH, mjm.nv))
  if not name.startswith("ellipsoid"):
    qvel[:2] = 0.0
  return {"qpos": qpos, "qvel": qvel, "ctrl": rng.uniform(-1.0, 1.0, (BATCH, mjm.nu))}


def _scene_run(mjm, start: dict, steps: int, fields, deriv: bool):
  """mjtpu's run of a bundle scene (_mjtpu_run) with its start: the
  golden's entries under the scene's prefix, without it."""
  run, fwd = _mjtpu_run(mjm, start, steps, fields, deriv=deriv)
  return {**{f"{k}0": v for k, v in start.items()}, **run, **fwd}


def humanoid_implicit_golden(mjm, steps: int = STEPS) -> dict[str, np.ndarray]:
  """The humanoid_implicit golden's arrays (module docstring)."""
  start = implicit_initial_state(mjm, "humanoid_implicit")
  golden = _scene_run(mjm, start, steps, ("qpos", "qvel"), deriv=True)
  print(f"humanoid_implicit: nefc {golden['fwd.efc_D'].shape[1]}, live contacts per env at step"
        f" 1 {(golden['fwd.contact.dist'] < 0).sum(axis=1).tolist()}, max |qDeriv|"
        f" {np.abs(golden['deriv']).max():.3e}")
  return golden


def _bundle(xmls: dict, names, steps: int, start_of, fields_of, deriv: bool):
  """(the scenes' snapshot arrays by name, their golden's arrays under
  "<scene>.")."""
  import mujoco

  from mjtpu_torch._src import io

  snapshots, golden = {}, {}
  for name, xml in xmls.items():
    if names and name not in names:
      continue
    mjm = mujoco.MjModel.from_xml_string(xml)
    snapshots[name] = io.snapshot_arrays(mjm)
    run = _scene_run(mjm, start_of(mjm, name), steps, fields_of(mjm), deriv)
    golden.update({f"{name}.{k}": v for k, v in run.items()})
    print(f"{name}: nv {mjm.nv}, integrator {int(mjm.opt.integrator)}, nsensor {mjm.nsensor},"
          f" nefc {run['fwd.efc_D'].shape[1]}, live contacts per env at step 1"
          f" {(run['fwd.contact.dist'] < 0).sum(axis=1).tolist()}")
  return snapshots, golden


def implicit_scenes(names=None, steps: int = STEPS) -> tuple[dict, dict[str, np.ndarray]]:
  """(the implicit scenes' snapshot arrays by name, the implicit golden's
  arrays: per scene its start, mjtpu's qpos and qvel (sensordata) after
  each step, the forward Data of step 1, and mjtpu's qDeriv of it)."""
  fields = lambda mjm: ("qpos", "qvel") + (("sensordata",) if mjm.nsensordata else ())
  return _bundle(implicit_scene_xmls(), names, steps, implicit_initial_state, fields, deriv=True)


def sensor_scene_xmls() -> dict[str, str]:
  """The scenes of sensor_scenes.npz, name -> MJCF: tests/test_energy.py's
  XML (the energy flag on) and its spring- and gravity-disable variants,
  its SENSOR_XML (the energy sensors without the flag, and with it:
  mjtpu's lazy kinetic energy), geomdist_xml,
  tests/test_contact_sensor.py's XML and CAMPROJECTION_XML."""
  from tests import test_contact_sensor, test_energy

  flag = '<flag energy="enable"/>'
  return {
      "energy": test_energy.XML,
      "energy_nospring": test_energy.XML.replace(flag, '<flag energy="enable" spring="disable"/>'),
      "energy_nogravity": test_energy.XML.replace(flag,
                                                  '<flag energy="enable" gravity="disable"/>'),
      "energy_sensors": test_energy.SENSOR_XML,
      "energy_flag_sensors": test_energy.SENSOR_XML.replace("<option gravity=\"0 0 -9.81\">",
                                                            "<option gravity=\"0 0 -9.81\">" + flag),
      "geomdist": geomdist_xml(),
      "contact": test_contact_sensor.XML,
      "camprojection": CAMPROJECTION_XML,
  }


def geomdist_xml() -> str:
  """tests/test_geomdist.py's XML with GEOMDIST_EXTRA_BODIES and
  GEOMDIST_EXTRA_SENSORS."""
  from tests import test_geomdist

  return (test_geomdist.XML.replace("</worldbody>", GEOMDIST_EXTRA_BODIES, 1)
          .replace("</sensor>", GEOMDIST_EXTRA_SENSORS, 1))


def sensor_initial_state(mjm, name: str, seed: int = 0) -> dict[str, np.ndarray]:
  """The state fields of a sensor scene's 4 envs: qpos0 +-0.3 (the
  geom-distance scene's +-0.05) with every quaternion normalized, qvel in
  [-1, 1], as tests/test_energy.py starts them; the contact scene's envs
  0 and 1 at rest as placed, 2 and 3 sliding (tests/test_contact_sensor.py's
  CONTACT_SLIDE_QVEL, then its mirror in x)."""
  import mujoco

  rng = np.random.default_rng(seed)
  if name == "contact":
    qvel = np.zeros((BATCH, mjm.nv))
    qvel[2] = CONTACT_SLIDE_QVEL
    qvel[3] = CONTACT_SLIDE_QVEL
    qvel[3, 0] = -qvel[3, 0]
    return {"qpos": np.tile(mjm.qpos0, (BATCH, 1)), "qvel": qvel,
            "ctrl": np.zeros((BATCH, mjm.nu))}
  spread = 0.05 if name == "geomdist" else 0.3
  qpos = mjm.qpos0[None] + rng.uniform(-spread, spread, (BATCH, mjm.nq))
  for q in qpos:
    mujoco.mj_normalizeQuat(mjm, q)
  return {"qpos": qpos, "qvel": rng.uniform(-1.0, 1.0, (BATCH, mjm.nv)),
          "ctrl": rng.uniform(-1.0, 1.0, (BATCH, mjm.nu))}


def sensor_scenes(names=None, steps: int = STEPS) -> tuple[dict, dict[str, np.ndarray]]:
  """(the sensor scenes' snapshot arrays by name, the sensor golden's
  arrays: per scene its start, mjtpu's qpos, qvel, sensordata and energy
  after each step and the forward Data of step 1)."""
  fields = lambda mjm: ("qpos", "qvel", "sensordata", "energy")
  return _bundle(sensor_scene_xmls(), names, steps, sensor_initial_state, fields, deriv=False)


def randomize_scene_specs() -> dict:
  """The scenes of randomize_scenes.npz, name -> (MjModel, rows, start
  state, steps, with the derived constants): tests/test_randomize.py's
  friction, mass/gain/damping/timestep, sphere-radius and
  constants-from-mj_setConst cases, and humanoid_bench with the main
  path's five fields (chip_smoke.bench_randomization) and their
  constants, its first BATCH envs."""
  import mujoco

  import chip_smoke

  out = {}
  ball = mujoco.MjModel.from_xml_string(RANDOMIZE_BALL_XML)
  fric = np.tile(np.array(ball.geom_friction), (4, 1, 1))
  fric[:, :, 0] = np.array([[0.01, 0.05, 0.2, 0.8]]).T
  qvel = np.zeros((4, ball.nv))
  qvel[:, 0] = 4.0
  out["ball_friction"] = (ball, {"geom_friction": fric}, {"qvel": qvel}, 15, False)
  size = np.tile(np.array(ball.geom_size), (3, 1, 1))
  size[:, 1, 0] = [0.25, 0.3, 0.35]
  out["ball_size"] = (ball, {"geom_size": size}, {}, 40, False)
  cart = mujoco.MjModel.from_xml_path(str(ROOT / "tests" / "models" / "cartpole.xml"))
  rng = np.random.default_rng(3)
  mass = np.tile(np.array(cart.body_mass), (3, 1))
  mass[:, 1] *= rng.uniform(0.5, 1.5, 3)
  gain = np.tile(np.array(cart.actuator_gainprm), (3, 1, 1))
  gain[:, 0, 0] *= rng.uniform(0.8, 1.2, 3)
  damp = np.tile(np.array(cart.dof_damping), (3, 1)) * rng.uniform(0.5, 2.0, (3, 1))
  ts = np.full((3,), 0.005) * rng.uniform(0.9, 1.1, 3)
  start = {"qpos": np.tile([0.1, 0.2], (3, 1)), "ctrl": np.full((3, 1), 0.7)}
  out["cartpole_mixed"] = (cart, {"body_mass": mass, "actuator_gainprm": gain,
                                  "dof_damping": damp, "opt.timestep": ts}, start, 15, False)
  mass = np.tile(np.array(cart.body_mass), (3, 1))
  mass[:, 1] *= [0.5, 1.0, 2.0]
  start = {"qpos": np.tile([0.1, 0.2], (3, 1)), "ctrl": np.full((3, 1), 0.6)}
  out["cartpole_consts"] = (cart, {"body_mass": mass}, start, 10, True)
  bench = load_mjmodel()
  rows = {k: v[:BATCH] for k, v in chip_smoke.bench_randomization(bench, BATCH).items()}
  qpos0, qvel0, ctrl = initial_state(bench)
  out["humanoid_bench"] = (bench, rows, {"qpos": qpos0, "qvel": qvel0, "ctrl": ctrl},
                           chip_smoke.RANDOM_BENCH_STEPS, True)
  return out


def randomize_scenes() -> tuple[dict, dict[str, np.ndarray]]:
  """(the randomize scenes' snapshot arrays by name, their golden: per
  scene "<scene>.rows.<field>" each randomized field's rows (with the
  derived constants where the scene takes them), "<scene>.<field>0" the
  start, "<scene>.qpos" and ".qvel" after each step of mjtpu's batched
  randomized step (parallel.randomized_step, or
  jit(vmap(step, in_axes=(axes, 0))) over randomize_with_consts), f64 on
  the CPU; and "bench.rows.<field>" the main path's B=4096 body_mass rows
  and their constants, which the card's machine cannot compute)."""
  import jax

  jax.config.update("jax_enable_x64", True)
  import jax.numpy as jnp

  import chip_smoke
  import mjtpu
  from mjtpu import parallel
  from mjtpu_torch._src import io
  from mjtpu_torch.parallel.randomize import _derived_constants

  snapshots, golden = {}, {}
  for name, (mjm, rows, start, steps, consts) in randomize_scene_specs().items():
    snapshots[name] = io.snapshot_arrays(mjm)
    m = mjtpu.put_model(mjm, dtype=jnp.float64)
    batch = next(iter(rows.values())).shape[0]
    if consts:
      mb, axes = parallel.randomize_with_consts(mjm, m, rows)
      step = jax.jit(jax.vmap(mjtpu.step, in_axes=(axes, 0)))
      step_fn = lambda d: step(mb, d)
      full = {k: np.asarray(v) for k, v in rows.items()}
      full.update({k: np.asarray(v) for k, v in _derived_constants(
          mjm, rows).items()})
    else:
      step_fn, mb = parallel.randomized_step(m, {k: jnp.asarray(v) for k, v in rows.items()})
      full = rows
    d = jax.vmap(lambda _: mjtpu.make_data(m))(jnp.arange(batch))
    d = d.replace(**{k: jnp.asarray(v) for k, v in start.items()})
    qpos, qvel = [], []
    for _ in range(steps):
      d = step_fn(d)
      qpos.append(np.asarray(d.qpos))
      qvel.append(np.asarray(d.qvel))
    golden.update({f"{name}.rows.{k}": np.asarray(v) for k, v in full.items()})
    golden.update({f"{name}.{k}0": np.asarray(v) for k, v in start.items()})
    golden[f"{name}.qpos"], golden[f"{name}.qvel"] = np.stack(qpos), np.stack(qvel)
    print(f"{name}: B {batch}, {steps} steps, fields {sorted(full)}, spread of the last qpos"
          f" over the envs {np.ptp(qpos[-1], axis=0).max():.3e}")
  bench = load_mjmodel()
  rows = chip_smoke.bench_randomization(bench, chip_smoke.BENCH_BATCH)
  mass = {"body_mass": rows["body_mass"]}
  consts = _derived_constants(bench, mass)
  golden.update({f"bench.rows.{k}": v for k, v in {**mass, **consts}.items()
                 if k != "dof_M0" and np.size(v)})
  return snapshots, golden


def _rotate_quats(q: np.ndarray, angle: float = 0.1) -> np.ndarray:
  """Each quaternion (..., 4) times a rotation by ``angle`` about a fixed
  oblique axis."""
  axis = np.array([0.3, 0.5, 0.8]) / np.linalg.norm([0.3, 0.5, 0.8])
  w2, (x2, y2, z2) = np.cos(angle / 2), np.sin(angle / 2) * axis
  w1, x1, y1, z1 = np.moveaxis(q, -1, 0)
  return np.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2, w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                   w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2, w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2],
                  axis=-1)


def _rotate_vecs(v: np.ndarray, angle: float = 0.1) -> np.ndarray:
  """Each vector (..., 3) rotated by ``angle`` about the axis of
  _rotate_quats (Rodrigues)."""
  k = np.array([0.3, 0.5, 0.8]) / np.linalg.norm([0.3, 0.5, 0.8])
  return (v * np.cos(angle) + np.cross(k, v) * np.sin(angle)
          + k * (v @ k)[..., None] * (1.0 - np.cos(angle)))


def field_perturbation(mjm, name: str, base: np.ndarray) -> np.ndarray:
  """A perturbed copy of field ``name``'s base value ``base`` (mjtpu's, of
  the MjModel ``mjm``) that keeps mjtpu's boundary: quaternions and axes
  turned by 0.1 rad; the frictionloss sets, the limits' two-sidedness
  and the non-round geoms' sizes kept; the ranges and cutoffs narrowed,
  the margins widened to 0.45 of a range; positions and equality data
  shifted; the solver's and its linesearch's tolerances x 100; a
  field that is zero throughout + 0.02; every other one scaled by 1.2,
  1.3, 1.4, 1.2, ... along its first axis."""
  x = np.array(base, dtype=np.float64)
  if name.endswith("quat"):
    return _rotate_quats(x)
  if name in ("jnt_axis", "light_dir", "light_dir0"):
    return _rotate_vecs(x)
  if name in ("jnt_range", "actuator_ctrlrange", "actuator_forcerange", "actuator_actrange",
              "jnt_actfrcrange", "sensor_cutoff"):
    return x * (0.8 if name == "jnt_range" else 0.5)
  if name == "tendon_range":
    return x * 0.95
  if name == "jnt_margin":  # 0.45 of each limited joint's range: one-sided still
    width = np.diff(np.array(mjm.jnt_range), axis=-1)[:, 0]
    return x + 0.45 * width * np.array(mjm.jnt_limited, dtype=bool)
  if name in ("geom_pos", "site_pos"):
    return x + np.array([0.01, -0.02, 0.015])
  if name == "eq_data":
    return x + 0.02
  if name in ("opt.tolerance", "opt.ls_tolerance"):
    return x * 100.0
  if name == "geom_size":
    x[np.isin(np.array(mjm.geom_type), (2, 3, 4, 5)), 0] *= 1.2  # the round geoms' radii
    return x
  if name == "hfield_data":
    return x * 0.7
  if name == "stat.meaninertia":
    return x * 1e4  # the rescaled tolerance stops the solver earlier
  if name in ("qpos0", "qpos_spring", "tendon_lengthspring"):
    return x + 0.05
  if "solimp" in name:
    return x * 0.97  # dmin and dmax stay below 1
  if not np.any(x):
    return x + 0.02
  if not x.ndim:
    return x * 1.3
  scale = 1.2 + 0.1 * (np.arange(len(x)) % 3)
  return x * scale.reshape((-1,) + (1,) * (x.ndim - 1))


def _field_scene(name: str):
  """(MjModel, start state of one env) of randomize_fields scene ``name``."""
  import mujoco

  from tests import test_transmission
  from tests.test_torch_randomize import FIELDS_XML

  rng = np.random.default_rng(1)
  xml = {"fields": FIELDS_XML, "sensing": FIELD_SENSING_XML, "friction": FIELD_FRICTION_XML,
         "elliptic": FIELD_ELLIPTIC_XML,
         "slidercrank": test_transmission.XML, "terrain": FIELD_TERRAIN_XML}
  if name == "cartpole_gear":
    mjm = mujoco.MjModel.from_xml_path(str(ROOT / "tests" / "models" / "cartpole.xml"))
    return mjm, {"qpos": np.zeros(mjm.nq), "ctrl": np.full(mjm.nu, 0.7)}
  mjm = mujoco.MjModel.from_xml_string(xml[name])
  start = {"qpos": np.array(mjm.qpos0), "qvel": rng.uniform(-0.5, 0.5, mjm.nv),
           "ctrl": rng.uniform(-1.0, 1.0, mjm.nu)}
  if name == "fields":
    start["qvel"][0] = 1.0  # the ball slides
    start["ctrl"] = np.array([0.3, 0.1, 0.5])
  elif name == "sensing":
    start["ctrl"] = np.array([0.9])  # past half the ctrl and activation ranges
    # the pendulum held at 0.3 rad by its frictionloss
    swing = mujoco.mj_name2id(mjm, mujoco.mjtObj.mjOBJ_JOINT, "swing")
    start["qpos"][mjm.jnt_qposadr[swing]] = 0.3
    start["qvel"][mjm.jnt_dofadr[swing]] = 0.0
  elif name == "friction":
    start["qpos"], start["qvel"] = np.array([0.3]), np.zeros(1)
  elif name == "elliptic":
    start["qvel"] = np.array([2.0, 0.0, 0.0, 0.0, 0.0, 0.0])
  elif name == "terrain":
    mjm.hfield_data[:] = 0.5 + 0.3 * rng.uniform(0.0, 1.0, mjm.hfield_data.shape)
    start["qvel"] = np.zeros(mjm.nv)
    start["qvel"][2::6] = -2.5  # every body drops onto the terrain
  return mjm, start


def randomize_field_specs(names=None) -> dict:
  """The scenes of randomize_fields.npz, name -> (MjModel, rows (B,
  *shape) each, start state (B, ...), steps, with the derived constants):
  each scene of FIELD_HOMES with its base in env 0 and field k of its
  homes perturbed (field_perturbation) in env k + 1 (cartpole_gear: the
  gear x 2 in env 1, ROADMAP C19), and the two main paths at BATCH envs:
  humanoid_bench with chip_smoke.bench_randomization(locomotion=True) and
  its constants from mj_setConst, humanoid_terrain with
  chip_smoke.terrain_randomization."""
  import jax

  jax.config.update("jax_enable_x64", True)
  import jax.numpy as jnp

  import chip_smoke
  import mjtpu

  out = {}
  for name, homes in FIELD_HOMES.items():
    if names and name not in names:
      continue
    mjm, start = _field_scene(name)
    m = mjtpu.put_model(mjm, dtype=jnp.float64)
    batch = len(homes) + 1
    rows = {}
    for k, key in enumerate(homes):
      base = np.asarray(_attr(m, key), dtype=np.float64)
      r = np.repeat(base[None], batch, axis=0)
      r[k + 1] = base * 2.0 if name == "cartpole_gear" else field_perturbation(mjm, key, base)
      rows[key] = r
    start = {k: np.repeat(np.asarray(v, dtype=np.float64)[None], batch, axis=0)
             for k, v in start.items()}
    out[name] = (mjm, rows, start, 10 if name == "cartpole_gear" else FIELD_STEPS, False)
  if not names or "humanoid_bench" in names:
    bench = load_mjmodel()
    qpos0, qvel0, ctrl = initial_state(bench)
    out["humanoid_bench"] = (bench, chip_smoke.bench_randomization(bench, BATCH, locomotion=True),
                             {"qpos": qpos0, "qvel": qvel0, "ctrl": ctrl}, FIELD_BENCH_STEPS, True)
  if not names or "humanoid_terrain" in names:
    terrain = load_terrain_mjmodel()
    qpos0, qvel0, ctrl = terrain_initial_state(terrain)
    out["humanoid_terrain"] = (terrain, chip_smoke.terrain_randomization(terrain, BATCH),
                               {"qpos": qpos0, "qvel": qvel0, "ctrl": ctrl}, FIELD_TERRAIN_STEPS,
                               False)
  return out


def _attr(obj, key: str):
  """The attribute at the dotted path ``key`` of ``obj``."""
  for part in key.split("."):
    obj = getattr(obj, part)
  return obj


def randomize_fields(names=None) -> tuple[dict, dict[str, np.ndarray]]:
  """(the randomize_fields scenes' snapshot arrays by name, their golden:
  per scene "<scene>.fields" its perturbed fields in env order (but the
  main paths'), "<scene>.rows.<field>" each randomized field's rows (with
  the derived constants where the scene takes them), "<scene>.<field>0"
  the start, and "<scene>.<output>" each of chip_smoke.FIELD_OUTPUTS the
  model has after each step of mjtpu's batched randomized step
  (parallel.randomize, then jit(vmap(step, in_axes=(axes, 0))); for a
  model with mesh hulls, which mjtpu's in_axes tree cannot hold, ROADMAP
  C20, jit(vmap(step)) over the rows with the base Model closed over),
  f64 on the CPU; and "bench.rows.<field>" the randomized humanoid_bench's
  body_mass and body_pos at B=4096 (phase 33) and their constants, which
  the card's machine cannot compute)."""
  import jax

  jax.config.update("jax_enable_x64", True)
  import jax.numpy as jnp

  import chip_smoke
  import mjtpu
  from mjtpu import parallel
  from mjtpu_torch._src import io
  from mjtpu_torch.parallel.randomize import _derived_constants

  snapshots, golden = {}, {}
  for name, (mjm, rows, start, steps, consts) in randomize_field_specs(names).items():
    snapshots[name] = io.snapshot_arrays(mjm)
    m = mjtpu.put_model(mjm, dtype=jnp.float64)
    batch = next(iter(rows.values())).shape[0]
    full = dict(rows)
    if consts:
      full.update({k: v for k, v in _derived_constants(mjm, rows).items() if np.size(v)})
    mb, axes = parallel.randomize(m, {k: jnp.asarray(v) for k, v in full.items()})
    if mjm.nmesh:
      # mjtpu's in_axes tree cannot hold a model with mesh hulls (ROADMAP
      # C20): vmap its step over the rows, the base Model closed over
      keys = list(full)
      one = lambda vals, dd: mjtpu.step(m.tree_replace(dict(zip(keys, vals))), dd)
      step, mb = jax.jit(jax.vmap(one)), [_attr(mb, k) for k in keys]
    else:
      step = jax.jit(jax.vmap(mjtpu.step, in_axes=(axes, 0)))
    d = jax.vmap(lambda _: mjtpu.make_data(m))(jnp.arange(batch))
    d = d.replace(**{k: jnp.asarray(v) for k, v in start.items()})
    fields = [f for f in chip_smoke.FIELD_OUTPUTS if np.size(getattr(d, f))]
    outs = {f: [] for f in fields}
    for _ in range(steps):
      d = step(mb, d)
      for f in fields:
        outs[f].append(np.asarray(getattr(d, f)))
    if name in FIELD_HOMES:
      golden[f"{name}.fields"] = np.array(FIELD_HOMES[name])
      last = np.concatenate([np.asarray(outs[f][-1]).reshape(batch, -1) for f in fields], 1)
      moved = np.abs(last - last[:1]).max(axis=1)[1:]
      unmoved = [k for k, v in zip(FIELD_HOMES[name], moved) if v == 0.0]
      print(f"{name}: B {batch}, {steps} steps; unmoved at the last step: {unmoved}")
    golden.update({f"{name}.rows.{k}": np.asarray(v) for k, v in full.items()})
    golden.update({f"{name}.{k}0": np.asarray(v) for k, v in start.items()})
    golden.update({f"{name}.{f}": np.stack(v) for f, v in outs.items()})
    spread = np.ptp(outs["qpos"][-1], axis=0).max()
    print(f"{name}: spread of the last qpos over the envs {spread:.3e}, finite"
          f" {all(np.isfinite(np.stack(v)).all() for v in outs.values())}")
  if not names or "humanoid_bench" in names:
    bench = load_mjmodel()
    rows = chip_smoke.bench_randomization(bench, chip_smoke.BENCH_BATCH, locomotion=True)
    geometry = {k: rows[k] for k in ("body_mass", "body_pos")}
    consts = _derived_constants(bench, geometry)
    golden.update({f"bench.rows.{k}": v for k, v in {**geometry, **consts}.items()
                   if k != "dof_M0" and np.size(v)})
  return snapshots, golden


def model_grad_scenes(names=None) -> dict[str, np.ndarray]:
  """The golden of model_grad_scenes_golden.npz: for each scene of
  chip_smoke.MODEL_GRAD_SCENES, the randomize_fields scene of that name
  (its snapshot in randomize_fields.npz, its rows, derived constants and
  start from randomize_fields_golden.npz) with its solver bounds
  "<scene>.solver" and steps "<scene>.steps", and mjtpu's values and
  jax.grad under differentiable_mode() at f64 on the CPU with the rows as
  the point: the loss, the steps' sum of chip_smoke.model_grad_loss,
  "<scene>.loss" (B,), "<scene>.qpos" (steps, B, nq) after each step, and
  "<scene>.grad.<field>" (B, *shape) of the summed loss; one jit of
  value_and_grad over a lax.scan of jax.vmap over the envs of mjtpu.step
  under each env's Model (the base Model with its rows, tree_replace: the
  semantics of randomize's in_axes, which a model with mesh hulls cannot
  take, ROADMAP C20); and for chip_smoke.MODEL_GRAD_BASE, humanoid_bench's
  unbatched MODEL_GRAD_BASE_FIELDS as the point, one Model for every env,
  from its scene's start."""
  import jax

  jax.config.update("jax_enable_x64", True)
  import jax.numpy as jnp

  import chip_smoke
  import mjtpu

  with np.load(RANDOMIZE_FIELDS_GOLDEN_FILE) as z:
    fields_golden = {k: z[k] for k in z.files}
  todo = [n for n in (*chip_smoke.MODEL_GRAD_SCENES, chip_smoke.MODEL_GRAD_BASE)
          if not names or n in names]
  specs = randomize_field_specs(
      sorted({"humanoid_bench" if n == chip_smoke.MODEL_GRAD_BASE else n for n in todo}))
  golden = {}
  for name in todo:
    base = name == chip_smoke.MODEL_GRAD_BASE
    scene = "humanoid_bench" if base else name
    steps, solver = ((chip_smoke.MODEL_GRAD_BASE_STEPS, chip_smoke.MODEL_GRAD_SCENES[scene][1])
                     if base else chip_smoke.MODEL_GRAD_SCENES[name])
    mjm = specs[scene][0]
    mjm.opt.iterations, mjm.opt.ls_iterations = solver
    m = mjtpu.put_model(mjm, dtype=jnp.float64)
    start = {k[len(scene) + 1:-1]: v for k, v in fields_golden.items()
             if k.startswith(f"{scene}.") and k.count(".") == 1 and k.endswith("0")}
    batch = next(iter(start.values())).shape[0]
    d0 = jax.vmap(lambda _: mjtpu.make_data(m))(jnp.arange(batch))
    d0 = d0.replace(**{k: jnp.asarray(v) for k, v in start.items()})

    def env_loss(d):
      return sum(jnp.sum((jnp.reshape(getattr(d, o), (batch, -1)) + 1.0) ** 2, axis=1)
                 for o in chip_smoke.FIELD_OUTPUTS)

    if base:
      keys = list(chip_smoke.MODEL_GRAD_BASE_FIELDS)
      point = {k: _attr(m, k) for k in keys}
      advance = lambda vals, d: jax.vmap(mjtpu.step, in_axes=(None, 0))(m.tree_replace(vals), d)
    else:
      keys = sorted(k[len(f"{scene}.rows."):] for k in fields_golden
                    if k.startswith(f"{scene}.rows."))
      point = {k: jnp.asarray(fields_golden[f"{scene}.rows.{k}"]) for k in keys}
      one = lambda vals, d: mjtpu.step(m.tree_replace(vals), d)
      advance = lambda vals, d: jax.vmap(one)(vals, d)

    def loss(vals):
      def body(d, _):
        d = advance(vals, d)
        return d, (env_loss(d), d.qpos)

      _, (terms, qpos) = jax.lax.scan(body, d0, None, length=steps)
      per_env = jnp.sum(terms, axis=0)
      return jnp.sum(per_env), (per_env, qpos)

    with mjtpu.differentiable_mode():
      (_, (per_env, qpos)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(point)
    golden[f"{name}.steps"] = np.array(steps)
    golden[f"{name}.solver"] = np.array(solver)
    golden.update({f"{name}.{k}0": np.asarray(v) for k, v in start.items()})
    if not base:
      golden.update({f"{name}.rows.{k}": np.asarray(point[k]) for k in keys})
    golden[f"{name}.loss"] = np.asarray(per_env)
    golden[f"{name}.qpos"] = np.asarray(qpos)
    golden.update({f"{name}.grad.{k}": np.asarray(grads[k]) for k in keys})
    zero = [k for k in keys if not np.any(np.asarray(grads[k]))]
    finite = all(np.isfinite(np.asarray(grads[k])).all() for k in keys)
    print(f"{name}: B {batch}, {steps} steps, solver {solver}, {len(keys)} fields, zero"
          f" gradients {zero}, finite {finite}, loss {np.asarray(per_env)}", flush=True)
  return golden


def inverse_scene_specs() -> dict:
  """The scenes of inverse_scenes.npz, name -> (MjModel, start state of
  BATCH envs, where its qacc comes from: "given" in the start, "forward"
  mjtpu's forward of it, "step" the qacc of mjtpu's step from it, the
  discrete one): tests/test_inverse.py's pendulum, ball_free and spheres (env
  e: numpy seed e, qpos0 +-0.2, qvel in [-0.5, 0.5], qacc from
  mj_forward), its damped arm with INVDISCRETE under Euler, ImplicitFast
  and Implicit (env e: seed e's qvel stepped 10 times by MuJoCo C, the
  last qacc), capsules.xml under FWDINV with a random qfrc_applied (qacc
  from mjtpu's forward), and the 66-dof branchy tree (slice 4's model:
  Euler with implicit damping) with INVDISCRETE from its golden's start
  states (qacc from mjtpu's step)."""
  import mujoco

  models = ROOT / "tests" / "models"
  out = {}
  for name in ("pendulum", "ball_free", "spheres"):
    mjm = mujoco.MjModel.from_xml_path(str(models / f"{name}.xml"))
    start = {k: [] for k in ("qpos", "qvel", "qacc")}
    for e in range(BATCH):
      mjd = mujoco.MjData(mjm)
      rng = np.random.default_rng(e)
      mjd.qpos[:] = mjm.qpos0 + rng.uniform(-0.2, 0.2, mjm.nq)
      mjd.qvel[:] = rng.uniform(-0.5, 0.5, mjm.nv)
      mujoco.mj_forward(mjm, mjd)
      for k in start:
        start[k].append(np.array(getattr(mjd, k)))
    out[name] = (mjm, {k: np.stack(v) for k, v in start.items()}, "given")
  for integ in ("Euler", "implicitfast", "implicit"):
    mjm = mujoco.MjModel.from_xml_string(INVERSE_ARM_XML.format(integ=integ))
    mjm.opt.enableflags |= mujoco.mjtEnableBit.mjENBL_INVDISCRETE
    start = {k: [] for k in ("qpos", "qvel", "qacc")}
    for e in range(BATCH):
      mjd = mujoco.MjData(mjm)
      mjd.qvel[:] = np.random.default_rng(e).uniform(-0.5, 0.5, mjm.nv)
      for _ in range(10):
        mujoco.mj_step(mjm, mjd)
      for k in start:
        start[k].append(np.array(getattr(mjd, k)))
    out[f"discrete_{integ.lower()}"] = (mjm, {k: np.stack(v) for k, v in start.items()}, "given")
  mjm = mujoco.MjModel.from_xml_path(str(models / "capsules.xml"))
  mjm.opt.enableflags |= mujoco.mjtEnableBit.mjENBL_FWDINV
  rng = np.random.default_rng(1)
  out["fwdinv"] = (mjm, {"qvel": rng.uniform(-0.2, 0.2, (BATCH, mjm.nv)),
                         "qfrc_applied": rng.uniform(-1, 1, (BATCH, mjm.nv))}, "forward")
  mjm = load_branchy_mjmodel()
  mjm.opt.enableflags |= mujoco.mjtEnableBit.mjENBL_INVDISCRETE
  qpos, qvel = branchy_initial_state(mjm)
  out["branchy66"] = (mjm, {"qpos": qpos, "qvel": qvel}, "step")
  return out


def inverse_scenes() -> tuple[dict, dict[str, np.ndarray]]:
  """(the inverse scenes' snapshot arrays by name, their golden: per scene
  its start "<scene>.<field>0" (qacc0 the inverse's input), mjtpu's
  jit(vmap(inverse)) outputs (INVERSE_OUT) at f64 on the CPU, and MuJoCo
  C's mj_inverse qfrc_inverse from the same inputs, "<scene>.c_qfrc_inverse")."""
  import jax

  jax.config.update("jax_enable_x64", True)
  import jax.numpy as jnp
  import mujoco

  import mjtpu
  from mjtpu_torch._src import io

  snapshots, golden = {}, {}
  for name, (mjm, start, qacc_from) in inverse_scene_specs().items():
    snapshots[name] = io.snapshot_arrays(mjm)
    m = mjtpu.put_model(mjm, dtype=jnp.float64)
    d = jax.vmap(lambda _: mjtpu.make_data(m))(jnp.arange(BATCH))
    d = d.replace(**{k: jnp.asarray(v) for k, v in start.items()})
    if qacc_from != "given":
      run = mjtpu.forward if qacc_from == "forward" else mjtpu.step
      qacc = np.asarray(jax.jit(jax.vmap(run, in_axes=(None, 0)))(m, d).qacc)
      start = {**start, "qpos": np.asarray(d.qpos), "qacc": qacc}
      d = d.replace(qacc=jnp.asarray(qacc))
    inv = jax.jit(jax.vmap(mjtpu.inverse, in_axes=(None, 0)))(m, d)
    c_inv = []
    for e in range(BATCH):
      mjd = mujoco.MjData(mjm)
      for k, v in start.items():
        getattr(mjd, k)[:] = v[e]
      mujoco.mj_inverse(mjm, mjd)
      c_inv.append(np.array(mjd.qfrc_inverse))
    golden.update({f"{name}.{k}0": np.asarray(v) for k, v in start.items()})
    golden.update({f"{name}.{k}": np.asarray(getattr(inv, k)) for k in INVERSE_OUT})
    golden[f"{name}.c_qfrc_inverse"] = np.stack(c_inv)
    print(f"{name}: nv {mjm.nv}, nefc {np.asarray(inv.efc_force).shape[1]}, mjtpu against C"
          f" {np.abs(np.asarray(inv.qfrc_inverse) - golden[f'{name}.c_qfrc_inverse']).max():.3e}")
  return snapshots, golden


def diff_scene_specs(names=None) -> dict:
  """The scenes of diff_scenes.npz (chip_smoke.DIFF_SCENES), name ->
  (MjModel, start of BATCH envs; numpy seed 0 each):
    pendulum, pendulum_adaptive   tests/models/pendulum.xml at qpos0, qvel
                                  uniform in [-0.5, 0.5]
    spheres                       tests/models/spheres.xml with the first
                                  sphere 3 mm into the floor to 8 mm over
                                  it, the second set beside it at the same
                                  heights, qvel in [-0.3, 0.3]
    box_corner, box_box           tests/test_diff.py's scenes at qpos0,
                                  offsets -1.5, -0.5, 0.5 and 1.5 mm
    sph_cyl                       tests/models/sph_cyl.xml with the sphere
                                  3 mm into the cylinder to 6 mm over it
                                  (2 cm sideways at most), falling at up
                                  to 0.3 m/s
    roll                          roll_initial_state, offsets 0
    bounce, bounce_smooth         tests/test_diff.py's ball thrown at
                                  (0.3, 0.3, -0.3) m/s, each component
                                  moved by up to 0.05
    humanoid_bench                the bench model at qpos0 +-0.01, qvel in
                                  [-1, 1] and a ctrl sequence (4, BATCH,
                                  21) in [-1, 1] (seed 1)
  The scenes that step a solver run it with the bounds of
  DIFF_SOLVER_BOUNDS in place of MuJoCo's 100 x 50: under
  differentiable_mode every iteration and linesearch round runs (mjtpu's
  fori_loops; the port's eager loops), and the default bounds, 5,000
  rounds a step, would take minutes a scene on the CPU."""
  import chip_smoke
  import mujoco

  models = ROOT / "tests" / "models"
  from_path = lambda n: mujoco.MjModel.from_xml_path(str(models / n))
  out = {}
  for name in names or chip_smoke.DIFF_SCENES:
    kind, steps = chip_smoke.DIFF_SCENES[name][:2]
    rng = np.random.default_rng(1 if name == "humanoid_bench" else 0)
    if name.startswith("pendulum"):
      mjm = from_path("pendulum.xml")
      start = {"qvel0": rng.uniform(-0.5, 0.5, (BATCH, mjm.nv))}
    elif name == "spheres":
      mjm = from_path("spheres.xml")
      qpos = np.tile(mjm.qpos0, (BATCH, 1))
      qpos[:, 2] = 0.1 + rng.uniform(-0.003, 0.008, BATCH)
      qpos[:, 7] = 0.4
      qpos[:, 9] = 0.12 + rng.uniform(-0.003, 0.008, BATCH)
      start = {"qpos0": qpos, "qvel0": rng.uniform(-0.3, 0.3, (BATCH, mjm.nv))}
    elif name in ("box_corner", "box_box"):
      mjm = mujoco.MjModel.from_xml_string(
          DIFF_BOX_CORNER_XML if name == "box_corner" else DIFF_BOX_BOX_XML)
      start = {"offset0": np.array([[-1.5e-3], [-0.5e-3], [0.5e-3], [1.5e-3]])}
    elif name == "sph_cyl":
      mjm = from_path("sph_cyl.xml")
      qpos = np.tile(mjm.qpos0, (BATCH, 1))
      qpos[:, :2] += rng.uniform(-0.02, 0.02, (BATCH, 2))
      # the cylinder's top at z 0.2, the sphere's radius 0.08
      qpos[:, 2] = 0.28 + rng.uniform(-0.003, 0.006, BATCH)
      qvel = np.zeros((BATCH, mjm.nv))
      qvel[:, 2] = -rng.uniform(0.0, 0.3, BATCH)
      start = {"qpos0": qpos, "qvel0": qvel}
    elif name == "roll":
      mjm = from_path("roll.xml")
      start = {"qpos0": roll_initial_state(mjm)[0], "offset0": np.zeros((BATCH, mjm.nq))}
    elif name.startswith("bounce"):
      mjm = mujoco.MjModel.from_xml_string(DIFF_BOUNCE_XML)
      qvel = np.zeros((BATCH, mjm.nv))
      qvel[:, :3] = np.array([0.3, 0.3, -0.3]) + rng.uniform(-0.05, 0.05, (BATCH, 3))
      start = {"qvel0": qvel}
    else:
      mjm = load_mjmodel()
      start = {"qpos0": mjm.qpos0[None] + rng.uniform(-0.01, 0.01, (BATCH, mjm.nq)),
               "qvel0": rng.uniform(-1.0, 1.0, (BATCH, mjm.nv)),
               "ctrl0": rng.uniform(-1.0, 1.0, (steps, BATCH, mjm.nu))}
    if name in DIFF_SOLVER_BOUNDS:
      mjm.opt.iterations, mjm.opt.ls_iterations = DIFF_SOLVER_BOUNDS[name]
    start.setdefault("qpos0", np.tile(mjm.qpos0, (BATCH, 1)))
    out[name] = (mjm, start)
  return out


def diff_scenes(names=None) -> tuple[dict, dict[str, np.ndarray]]:
  """(the diff scenes' snapshot arrays by name, their golden: per scene its
  start "<scene>.<field>0" and mjtpu's values and gradients under the
  scene's differentiable_mode at f64 on the CPU: a rollout's "qpos" and
  "qvel" (steps, BATCH, ...) after each step (lax.scan of mjtpu.step),
  "loss" and "grad_qvel" (and "grad_ctrl"), a min-distance scene's "loss"
  and "grad_offset"; jit(vmap(value_and_grad)) over the envs)."""
  import jax

  jax.config.update("jax_enable_x64", True)
  import jax.numpy as jnp

  import chip_smoke
  import mjtpu
  from mjtpu_torch._src import io

  snapshots, golden = {}, {}
  for name, (mjm, start) in diff_scene_specs(names).items():
    kind, steps, cfg, entries = chip_smoke.DIFF_SCENES[name]
    snapshots[name] = io.snapshot_arrays(mjm)
    m = mjtpu.put_model(mjm, dtype=jnp.float64)
    d0 = mjtpu.make_data(m)
    cols = np.arange(mjm.nq) if entries is None else np.asarray(entries)
    with mjtpu.differentiable_mode(**cfg):
      if kind == "rollout":
        def loss(qvel0, ctrl, qpos0):
          def body(d, c):
            d = mjtpu.step(m, d if c is None else d.replace(ctrl=c))
            return d, (d.qpos, d.qvel)
          d, (qs, vs) = jax.lax.scan(body, d0.replace(qpos=qpos0, qvel=qvel0), ctrl,
                                     length=steps)
          return jnp.sum(d.qpos[cols] ** 2), (qs, vs)

        ctrl = start.get("ctrl0")
        fn = jax.jit(jax.vmap(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True),
                              in_axes=(0, None if ctrl is None else 1, 0)))
        (val, (qs, vs)), (g_qvel, g_ctrl) = fn(
            jnp.asarray(start["qvel0"]), None if ctrl is None else jnp.asarray(ctrl),
            jnp.asarray(start["qpos0"]))
        res = {"loss": val, "qpos": jnp.swapaxes(qs, 0, 1), "qvel": jnp.swapaxes(vs, 0, 1),
               "grad_qvel": g_qvel}
        if ctrl is not None:
          res["grad_ctrl"] = jnp.swapaxes(g_ctrl, 0, 1)
      else:
        def mindist(offset, qpos0):
          d = mjtpu.fwd_position(m, d0.replace(qpos=qpos0.at[cols].add(offset)))
          return jnp.min(d.contact.dist)

        val, g = jax.jit(jax.vmap(jax.value_and_grad(mindist)))(
            jnp.asarray(start["offset0"]), jnp.asarray(start["qpos0"]))
        res = {"loss": val, "grad_offset": g}
    golden.update({f"{name}.{k}": np.asarray(v) for k, v in start.items()})
    golden.update({f"{name}.{k}": np.asarray(v) for k, v in res.items()})
    print(f"{name}: loss {np.asarray(res['loss'])}, grad max-abs "
          + ", ".join(f"{k} {np.abs(np.asarray(v)).max():.3e}" for k, v in res.items()
                      if k.startswith("grad_")))
  return snapshots, golden


def stepped_scene_specs() -> dict:
  """The scenes of stepped_scenes.npz, name -> (MjModel, start of BATCH
  envs, numpy seed 0): mjtpu/zoo/assets/hopper_bench.xml and
  tests/models/pendulum_implicit.xml at qpos0 +-0.01 (hinge and slide
  joints only), qvel and ctrl uniform in [-0.5, 0.5] and [-1, 1]."""
  import mujoco

  out = {}
  for name, path in (("hopper_bench", ZOO / "hopper_bench.xml"),
                     ("pendulum_implicit", ROOT / "tests" / "models" / "pendulum_implicit.xml")):
    mjm = mujoco.MjModel.from_xml_path(str(path))
    rng = np.random.default_rng(0)
    out[name] = (mjm, {"qpos0": mjm.qpos0[None] + rng.uniform(-0.01, 0.01, (BATCH, mjm.nq)),
                       "qvel0": rng.uniform(-0.5, 0.5, (BATCH, mjm.nv)),
                       "ctrl0": rng.uniform(-1.0, 1.0, (BATCH, mjm.nu))})
  return out


def stepped_scenes() -> tuple[dict, dict[str, np.ndarray]]:
  """(the stepped scenes' snapshot arrays by name, their golden: per scene
  its start "<scene>.<field>0", mjtpu's "qpos" and "qvel" (STEPPED_STEPS,
  BATCH, ...) after each step of jit(vmap(step)) at f64 on the CPU, and
  "qfrc_inverse" of jit(vmap(inverse)) of the Data after each step)."""
  import jax

  jax.config.update("jax_enable_x64", True)
  import jax.numpy as jnp

  import mjtpu
  from mjtpu_torch._src import io

  snapshots, golden = {}, {}
  for name, (mjm, start) in stepped_scene_specs().items():
    snapshots[name] = io.snapshot_arrays(mjm)
    m = mjtpu.put_model(mjm, dtype=jnp.float64)
    d = jax.vmap(lambda _: mjtpu.make_data(m))(jnp.arange(BATCH))
    d = d.replace(**{k[:-1]: jnp.asarray(v) for k, v in start.items()})
    step = jax.jit(jax.vmap(mjtpu.step, in_axes=(None, 0)))
    inverse = jax.jit(jax.vmap(mjtpu.inverse, in_axes=(None, 0)))
    out = {"qpos": [], "qvel": [], "qfrc_inverse": []}
    for _ in range(STEPPED_STEPS):
      d = step(m, d)
      out["qpos"].append(np.asarray(d.qpos))
      out["qvel"].append(np.asarray(d.qvel))
      out["qfrc_inverse"].append(np.asarray(inverse(m, d).qfrc_inverse))
    golden.update({f"{name}.{k}": np.asarray(v) for k, v in start.items()})
    golden.update({f"{name}.{k}": np.stack(v) for k, v in out.items()})
  return snapshots, golden


def render_scene_xmls() -> dict[str, str]:
  """The scenes of render_scenes.npz: tests/test_render.py's scenes (its
  textured scene, its lit scene with the narrow spot, point-light and
  inactive-light variants, the cube-textured sphere, the 6-face and the
  single-square skyboxes, the cylinder and ellipsoid, the camera on a
  body) and RENDER_MESH_XML."""
  import sys

  sys.path.insert(0, str(ROOT))
  from tests.test_render import _LIT_XML, _XML

  return {
      "textured": _XML, "lit": _LIT_XML,
      "lit_narrow": _LIT_XML.replace('cutoff="60"', 'cutoff="12"'),
      "lit_point": _LIT_XML.replace('cutoff="60"', 'cutoff="179"').replace(
          'castshadow="true"', 'castshadow="false" attenuation="1 0 0.35"'),
      "lit_inactive": _LIT_XML.replace('castshadow="true"', 'castshadow="true" active="false"'),
      "cube_texture": CUBE_TEXTURE_XML, "skybox_faces": SKYBOX_FACES_XML,
      "skybox_square": SKYBOX_SQUARE_XML, "cylinder_ellipsoid": CYLINDER_ELLIPSOID_XML,
      "camera_body": CAMERA_BODY_XML, "mesh": RENDER_MESH_XML,
  }


def render_scene_mjmodel(name: str):
  """A render scene's MjModel; the 6-face skybox gets one flat colour a
  face (SKYBOX_FACE_COLORS, in MuJoCo's face order), as
  tests/test_render.py paints it."""
  import mujoco

  mjm = mujoco.MjModel.from_xml_string(render_scene_xmls()[name])
  if name == "skybox_faces":
    tid = int(np.flatnonzero(np.atleast_1d(mjm.tex_type) == 2)[0])
    w, h, adr = int(mjm.tex_width[tid]), int(mjm.tex_height[tid]), int(mjm.tex_adr[tid])
    img = np.repeat(np.asarray(SKYBOX_FACE_COLORS, np.float64), w, axis=0)[:, None]
    img = np.broadcast_to(img, (h, w, 3))
    mjm.tex_data[adr:adr + h * w * 3] = np.round(img.reshape(-1) * 255).astype(np.uint8)
  return mjm


def render_initial_state(mjm, seed: int = 0) -> np.ndarray:
  """(RENDER_BATCH, nq) qpos: env 0 at qpos0, env 1 with its free bodies
  moved up to 5 cm and turned up to 0.3 rad and every other joint moved up
  to 0.3 (numpy seed)."""
  rng = np.random.default_rng(seed)
  qpos = np.tile(mjm.qpos0, (RENDER_BATCH, 1))
  _perturb(mjm, qpos[1], rng, 0.05, 0.3)
  free = {a + i for a in _free_joints(mjm) for i in range(7)}
  rest = [i for i in range(mjm.nq) if i not in free]
  qpos[1, rest] += rng.uniform(-0.3, 0.3, len(rest))
  return qpos


def render_views(mjm) -> list:
  """(label, camera, options) of each render of a scene: camera 0 under
  every RENDER_OPTIONS set, and every camera under the defaults."""
  return ([(label, 0, opts) for label, opts in RENDER_OPTIONS.items()]
          + [("default", cam, {}) for cam in range(mjm.ncam)])


def render_scenes(names=None, labels=None) -> tuple[dict, dict[str, np.ndarray]]:
  """(the bundle's snapshots, the golden's arrays) of render_scene_xmls:
  per scene its qpos (render_initial_state) and, per view (render_views),
  mjtpu's jit(render_batch_rgbd) at float64 on the CPU of the batch after
  jit(vmap(forward)): <scene>.<label>.cam<c>.rgb, .depth and .seg at
  RENDER_SIZE; the single-square skybox's image (<scene>.sky_tex), put
  into mjtpu's RenderData; and "views", the JSON list of [scene, label,
  camera, options].  ``labels``: only the views of these labels."""
  import dataclasses
  import json

  import jax

  jax.config.update("jax_enable_x64", True)
  import jax.numpy as jnp

  import mjtpu
  from mjtpu_torch._src import io

  height, width = RENDER_SIZE
  snapshots, out, views = {}, {}, []
  for name in names or render_scene_xmls():
    mjm = render_scene_mjmodel(name)
    snapshots[name] = io.snapshot_arrays(mjm)
    m = mjtpu.put_model(mjm, dtype=jnp.float64)
    qpos = render_initial_state(mjm)
    d = jax.vmap(lambda _: mjtpu.make_data(m))(jnp.arange(RENDER_BATCH))
    d = jax.jit(jax.vmap(mjtpu.forward, in_axes=(None, 0)))(m, d.replace(qpos=jnp.asarray(qpos)))
    rd = mjtpu.precompute_render_data(m)
    out[f"{name}.qpos"] = qpos
    if name == "skybox_square":
      sky = np.tile(np.asarray(SQUARE_SKY, np.float64), (8, 8, 1))
      rd = dataclasses.replace(rd, sky_tex=sky)
      out[f"{name}.sky_tex"] = sky
    for label, cam, opts in render_views(mjm):
      if labels and label not in labels:
        continue
      f = jax.jit(lambda dd, cam=cam, opts=opts: mjtpu.render_batch_rgbd(
          m, dd, width=width, height=height, camera=cam, rd=rd, **opts))
      for k, v in zip(("rgb", "depth", "seg"), f(d)):
        out[f"{name}.{label}.cam{cam}.{k}"] = np.asarray(v)
      views.append([name, label, cam, opts])
    segs = [v for k, v in out.items() if k.startswith(f"{name}.") and k.endswith(".seg")]
    print(f"{name}: {len(segs)} views, seg ids {sorted(set(np.unique(segs).tolist()))}")
  out["views"] = np.frombuffer(json.dumps(views).encode(), dtype=np.uint8)
  return snapshots, out


def pixel_env_mjmodel(name: str):
  """The zoo model ``name`` with the observer camera mjtpu's pixel envs
  inject where the MJCF has none (mjtpu/zoo/base.py's string edit)."""
  import mujoco

  xml = (ZOO / f"{name}.xml").read_text()
  if "<camera" not in xml:
    xml = xml.replace(
        "<worldbody>",
        '<worldbody><camera name="track" pos="2.5 -2.5 1.5"'
        ' xyaxes="0.7 0.7 0 -0.23 0.23 0.94"/>',
        1,
    )
  return mujoco.MjModel.from_xml_string(xml)


def pixel_env_golden(names=PIXEL_ENVS, steps: int = ENV_STEPS) -> dict[str, np.ndarray]:
  """The pixel env golden's arrays: mjtpu's ``names`` envs with
  pixel_obs=True at RENDER_SIZE from env_initial_state's states, as
  env_golden steps them, with the pixels of the start and of each env
  step, and the depth and segmentation of a render_batch_rgbd of the same
  Data (its rgb must be the env's pixels)."""
  import jax

  jax.config.update("jax_enable_x64", True)
  import jax.numpy as jnp

  import mjtpu
  from mjtpu.zoo import ENVS
  from mjtpu.zoo.base import State

  height, width = RENDER_SIZE
  out = {}
  for name in names:
    env = ENVS[name](dtype=jnp.float64, pixel_obs=True, pixel_size=RENDER_SIZE)
    qpos0, qvel0, steps0 = env_initial_state(name, env)
    action = np.random.default_rng(1).uniform(-1.0, 1.0, (steps, BATCH, env.action_size))
    d = jax.vmap(lambda _: env._d0)(jnp.arange(BATCH))
    d = d.replace(qpos=jnp.asarray(qpos0), qvel=jnp.asarray(qvel0))
    d = jax.jit(jax.vmap(mjtpu.forward, in_axes=(None, 0)))(env.model, d)
    rgbd = jax.jit(lambda dd: mjtpu.render_batch_rgbd(env.model, dd, width=width, height=height,
                                                       camera=0, rd=env._render_data))
    # the start's pixels: env._pixels is render with these arguments
    state = State(data=d, obs=jax.vmap(env._obs)(d), reward=jnp.zeros(BATCH),
                  done=jnp.zeros(BATCH, bool),
                  key=jax.random.split(jax.random.PRNGKey(0), BATCH),
                  steps=jnp.asarray(steps0), pixels=rgbd(d)[0])
    step = jax.jit(jax.vmap(env.step))
    rec = {k: [] for k in ("obs", "reward", "done", "steps", "pixels", "depth", "seg")}
    for t in range(steps + 1):
      if t:
        state = step(state, jnp.asarray(action[t - 1]))
      rgb, depth, seg = (np.asarray(x) for x in rgbd(state.data))
      pixels = np.asarray(state.pixels)
      gap = np.abs(rgb - pixels).max()
      if not gap <= 1e-12:
        raise AssertionError(f"{name} step {t}: render_batch_rgbd's rgb parts from the env's"
                             f" pixels by {gap:.3e}")
      for k, v in (("obs", state.obs), ("reward", state.reward), ("done", state.done),
                   ("steps", state.steps), ("pixels", pixels), ("depth", depth),
                   ("seg", seg)):
        rec[k].append(np.asarray(v))
    rec = {k: np.stack(v) for k, v in rec.items()}
    if steps and (rec["done"][1:, :3].any() or not rec["done"][1, 3]):
      raise AssertionError(f"{name}: done {rec['done'].tolist()}: envs 0-2 must stay"
                           " healthy and env 3 end at the first step")
    print(f"{name}: rewards {rec['reward'][1:].tolist()}, seg ids"
          f" {sorted(set(np.unique(rec['seg']).tolist()))}")
    out.update({f"{name}.{k}": v for k, v in dict(
        qpos0=qpos0, qvel0=qvel0, steps0=steps0, action=action, **rec).items()})
  return out


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
                      help="directory for the files (default: the package's assets)")
  parser.add_argument("--model", action="append", choices=MODELS,
                      help="the model whose files to write (repeatable; default: all)")
  parser.add_argument("--steps", type=int, default=None,
                      help="steps of the humanoid_terrain, scene_pile, branchy66, ant_bench,"
                      " ant_rk4, cylinder_drop, roll, sph_cyl, humanoid_bench_elliptic and cone"
                      f" scene golden trajectories (default {STEPS}) and env steps of the env"
                      f" golden (default {ENV_STEPS})")
  parser.add_argument("--env", action="append", choices=LOCOMOTION + SATELLITE_ENVS + ("humanoid",),
                      help="the envs of the env goldens (repeatable; default: all of each)")
  parser.add_argument("--scene", action="append",
                      help="the scenes of collision_scenes, cone_scenes, fluid_scenes,"
                      " tendon_scenes, equality_scenes, implicit_scenes, sensor_scenes,"
                      " diff_scenes, randomize_fields and model_grad_scenes (repeatable;"
                      " default: all)")
  parser.add_argument("--view", action="append", choices=(*RENDER_OPTIONS, "default"),
                      help="the views of render_scenes by label (repeatable; default: all)")
  args = parser.parse_args()
  out = args.out
  steps = args.steps or STEPS
  # before jax is imported: the flag is read when the CPU backend starts
  os.environ["XLA_FLAGS"] = (
      os.environ.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX2").strip()
  from mjtpu_torch._src import io

  out.mkdir(parents=True, exist_ok=True)
  files = []
  models = args.model or list(MODELS)
  if "humanoid_bench" in models:
    mjm = load_mjmodel()
    io.save_snapshot(mjm, out / MODEL_FILE.name)
    np.savez_compressed(out / GOLDEN_FILE.name, **golden(mjm))
    files += [MODEL_FILE.name, GOLDEN_FILE.name]
  if "humanoid_terrain" in models:
    from mjtpu._src import mesh

    mjm = load_terrain_mjmodel()
    io.save_snapshot(mjm, out / TERRAIN_MODEL_FILE.name, mesh_convex=mesh.get(mjm))
    np.savez_compressed(out / TERRAIN_GOLDEN_FILE.name, **terrain_golden(mjm, steps))
    files += [TERRAIN_MODEL_FILE.name, TERRAIN_GOLDEN_FILE.name]
  if "scene_pile" in models:
    mjm = load_pile_mjmodel()
    io.save_snapshot(mjm, out / PILE_MODEL_FILE.name, geom_convex=sized_geom_convex(mjm))
    np.savez_compressed(out / PILE_GOLDEN_FILE.name, **pile_golden(mjm, steps))
    files += [PILE_MODEL_FILE.name, PILE_GOLDEN_FILE.name]
  if "boxes" in models:
    import mujoco

    mjm = mujoco.MjModel.from_xml_path(str(BOXES_XML))
    io.save_snapshot(mjm, out / BOXES_MODEL_FILE.name, geom_convex=sized_geom_convex(mjm))
    files.append(BOXES_MODEL_FILE.name)
  if "branchy66" in models:
    mjm = load_branchy_mjmodel()
    io.save_snapshot(mjm, out / BRANCHY_MODEL_FILE.name)
    np.savez_compressed(out / BRANCHY_GOLDEN_FILE.name, **branchy_golden(mjm, steps))
    files += [BRANCHY_MODEL_FILE.name, BRANCHY_GOLDEN_FILE.name]
  if "ant_bench" in models:
    mjm = load_ant_mjmodel()
    io.save_snapshot(mjm, out / ANT_MODEL_FILE.name)
    np.savez_compressed(out / ANT_GOLDEN_FILE.name, **ant_golden(mjm, steps))
    files += [ANT_MODEL_FILE.name, ANT_GOLDEN_FILE.name]
  if "zoo" in models:
    for name in ZOO_MODELS:
      io.save_snapshot(load_zoo_mjmodel(name), out / f"{name}_model.npz")
      files.append(f"{name}_model.npz")
  if "ant_rk4" in models:
    np.savez_compressed(out / ANT_RK4_GOLDEN_FILE.name,
                        **ant_rk4_golden(load_zoo_mjmodel("ant"), steps))
    files.append(ANT_RK4_GOLDEN_FILE.name)
  for key, envs, path in (("zoo_envs", LOCOMOTION, ENV_GOLDEN_FILE),
                           ("satellite_envs", SATELLITE_ENVS, SATELLITE_ENV_GOLDEN_FILE)):
    if key in models:
      names = [e for e in args.env or envs if e in envs]
      np.savez_compressed(out / path.name, **env_golden(names, args.steps or ENV_STEPS))
      files.append(path.name)
  for name in CONTACT_MODELS:
    if name in models:
      mjm = load_contact_mjmodel(name)
      io.save_snapshot(mjm, out / f"{name}_model.npz", geom_convex=sized_geom_convex(mjm))
      np.savez_compressed(out / f"{name}_golden.npz", **contact_golden(mjm, name, steps))
      files += [f"{name}_model.npz", f"{name}_golden.npz"]
  if "collision_scenes" in models:
    snapshots, scene_golden = scenes(args.scene)
    io.save_snapshot_bundle(out / SCENES_FILE.name, snapshots)
    np.savez_compressed(out / SCENES_GOLDEN_FILE.name, **scene_golden)
    files += [SCENES_FILE.name, SCENES_GOLDEN_FILE.name]
  if "humanoid_bench_elliptic" in models:
    mjm = load_elliptic_mjmodel()
    io.save_snapshot(mjm, out / ELLIPTIC_MODEL_FILE.name)
    np.savez_compressed(out / ELLIPTIC_GOLDEN_FILE.name, **elliptic_golden(mjm, steps))
    files += [ELLIPTIC_MODEL_FILE.name, ELLIPTIC_GOLDEN_FILE.name]
  if "cone_scenes" in models:
    snapshots, cone_golden = cone_scenes(args.scene, steps)
    io.save_snapshot_bundle(out / CONE_SCENES_FILE.name, snapshots)
    np.savez_compressed(out / CONE_GOLDEN_FILE.name, **cone_golden)
    files += [CONE_SCENES_FILE.name, CONE_GOLDEN_FILE.name]
  if "fluid_scenes" in models:
    snapshots, fluid_golden = fluid_scenes(args.scene, steps)
    io.save_snapshot_bundle(out / FLUID_SCENES_FILE.name, snapshots)
    np.savez_compressed(out / FLUID_GOLDEN_FILE.name, **fluid_golden)
    files += [FLUID_SCENES_FILE.name, FLUID_GOLDEN_FILE.name]
  if "tendon_scenes" in models:
    snapshots, tendon_golden = tendon_scenes(args.scene, steps)
    io.save_snapshot_bundle(out / TENDON_SCENES_FILE.name, snapshots)
    np.savez_compressed(out / TENDON_GOLDEN_FILE.name, **tendon_golden)
    files += [TENDON_SCENES_FILE.name, TENDON_GOLDEN_FILE.name]
  if "equality_scenes" in models:
    snapshots, eq_golden = equality_scenes(args.scene, steps)
    io.save_snapshot_bundle(out / EQUALITY_SCENES_FILE.name, snapshots)
    np.savez_compressed(out / EQUALITY_GOLDEN_FILE.name, **eq_golden)
    files += [EQUALITY_SCENES_FILE.name, EQUALITY_GOLDEN_FILE.name]
  if "humanoid_implicit" in models:
    mjm = load_humanoid_implicit_mjmodel()
    io.save_snapshot(mjm, out / HUMANOID_IMPLICIT_MODEL_FILE.name)
    np.savez_compressed(out / HUMANOID_IMPLICIT_GOLDEN_FILE.name,
                        **humanoid_implicit_golden(mjm, steps))
    files += [HUMANOID_IMPLICIT_MODEL_FILE.name, HUMANOID_IMPLICIT_GOLDEN_FILE.name]
  for key, bundle, path, golden_path in (
      ("implicit_scenes", implicit_scenes, IMPLICIT_SCENES_FILE, IMPLICIT_GOLDEN_FILE),
      ("sensor_scenes", sensor_scenes, SENSOR_SCENES_FILE, SENSOR_GOLDEN_FILE)):
    if key in models:
      snapshots, scene_golden = bundle(args.scene, steps)
      io.save_snapshot_bundle(out / path.name, snapshots)
      np.savez_compressed(out / golden_path.name, **scene_golden)
      files += [path.name, golden_path.name]
  for key, bundle, path, golden_path in (
      ("randomize_scenes", randomize_scenes, RANDOMIZE_SCENES_FILE, RANDOMIZE_GOLDEN_FILE),
      ("inverse_scenes", inverse_scenes, INVERSE_SCENES_FILE, INVERSE_GOLDEN_FILE)):
    if key in models:
      snapshots, scene_golden = bundle()
      io.save_snapshot_bundle(out / path.name, snapshots)
      np.savez_compressed(out / golden_path.name, **scene_golden)
      files += [path.name, golden_path.name]
  if "diff_scenes" in models:
    snapshots, scene_golden = diff_scenes(args.scene)
    io.save_snapshot_bundle(out / DIFF_SCENES_FILE.name, snapshots)
    np.savez_compressed(out / DIFF_GOLDEN_FILE.name, **scene_golden)
    files += [DIFF_SCENES_FILE.name, DIFF_GOLDEN_FILE.name]
  if "stepped_scenes" in models:
    snapshots, scene_golden = stepped_scenes()
    io.save_snapshot_bundle(out / STEPPED_SCENES_FILE.name, snapshots)
    np.savez_compressed(out / STEPPED_GOLDEN_FILE.name, **scene_golden)
    files += [STEPPED_SCENES_FILE.name, STEPPED_GOLDEN_FILE.name]
  if "render_scenes" in models:
    snapshots, scene_golden = render_scenes(args.scene, args.view)
    io.save_snapshot_bundle(out / RENDER_SCENES_FILE.name, snapshots)
    np.savez_compressed(out / RENDER_GOLDEN_FILE.name, **scene_golden)
    files += [RENDER_SCENES_FILE.name, RENDER_GOLDEN_FILE.name]
  if "randomize_fields" in models:
    snapshots, scene_golden = randomize_fields(args.scene)
    io.save_snapshot_bundle(out / RANDOMIZE_FIELDS_FILE.name, snapshots)
    np.savez_compressed(out / RANDOMIZE_FIELDS_GOLDEN_FILE.name, **scene_golden)
    files += [RANDOMIZE_FIELDS_FILE.name, RANDOMIZE_FIELDS_GOLDEN_FILE.name]
  if "model_grad_scenes" in models:
    np.savez_compressed(out / MODEL_GRAD_GOLDEN_FILE.name, **model_grad_scenes(args.scene))
    files.append(MODEL_GRAD_GOLDEN_FILE.name)
  if "pixel_envs" in models:
    io.save_snapshot_bundle(out / PIXEL_ENV_MODELS_FILE.name, {
        name: io.snapshot_arrays(pixel_env_mjmodel(name)) for name in PIXEL_MODELS})
    names = [e for e in args.env or PIXEL_ENVS if e in PIXEL_ENVS]
    np.savez_compressed(out / PIXEL_ENV_GOLDEN_FILE.name, **pixel_env_golden(
        names, ENV_STEPS if args.steps is None else args.steps))
    files += [PIXEL_ENV_MODELS_FILE.name, PIXEL_ENV_GOLDEN_FILE.name]
  for name in files:
    print(f"wrote {out / name} ({(out / name).stat().st_size} bytes)")


if __name__ == "__main__":
  main()
