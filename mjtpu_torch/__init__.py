"""mjtpu_torch — the PyTorch + CUDA port of mjtpu.

The same public names over (Model, Data) as ``mjtpu``, batch-explicit:
``Model`` is unbatched, every ``Data`` field has a leading env axis B
(``make_data(m, batch_size=B)``), and every function steps all envs at
once.  The port imports torch and numpy only; kernels written by hand for
NVIDIA Hopper live in ``mjtpu_torch/ops`` (sources in ``csrc/``) and are
built with nvcc at first use.

The slices so far run ``humanoid_bench`` (Euler, the dense Newton solver,
joint limits, pyramidal plane-capsule contacts), ``humanoid_terrain``
(ImplicitFast; sphere/capsule self-collision at condim 1, spheres and
capsules on a height field and on convex meshes), ``scene_pile`` (32
free bodies: the CG solver, the forest-blocked mass matrix, plane, sphere
and box colliders with box-box SAT) and ``ant_bench`` (the sensor stages,
rangefinder rays, cameras and lights), all in mjtpu/zoo/assets, and the
66-dof branchy tree of tests/test_sparse.py (the levelwise sparse LDL).
The zoo's Gym locomotion envs run through ``mjtpu_torch.zoo`` (ant,
hopper, walker2d, halfcheetah, cartpole and the humanoids: ``ENVS[name]()``,
``reset``, ``step`` with auto-reset), with the RK4 integrator
(``rungekutta4``) that ant, hopper and walker2d take.  Every geom pair
mjtpu collides is collided (cylinders, ellipsoids, mesh-mesh, convex on
terrain, the ``max_geom_pairs`` broadphase); contacts take condim 1, 3, 4
and 6 with pyramidal or elliptic cones, and dofs their frictionloss rows.
Passive forces take gravity compensation (through qfrc_passive, or the
actuators for a joint with actuatorgravcomp) and fluid forces (the
per-geom ellipsoid model and the inertia-box model, with wind), so the
zoo also runs the swimmer and the three satellite envs (``zoo.cmg``,
``zoo.satellite``): every env mjtpu's zoo has.  Tendons run too, fixed and spatial (sphere and cylinder
wraps, side sites, pulleys; ``tendon``, ``tendon_armature``), with their
springs, dampers, frictionloss and limit rows and sensors, as do every
actuator transmission mjtpu has, activation dynamics with muscles, and
Euler's implicit damping on a forest.  Equality constraints run too
(connect, weld, joint and tendon couplings, each env's ``eq_active``), as
do mocap bodies (each env's ``mocap_pos`` and ``mocap_quat``), ball-joint
limits and ImplicitFast on a forest (the blocked LU of
``factor_solve``).  So do the full Implicit integrator (qDeriv with the
RNE and fluid velocity derivatives, ``deriv_smooth_vel``), the energy
flag (``potential_energy``, ``kinetic_energy``, ``energy_pos``,
``energy_vel``) and every sensor type mjtpu computes, the energy,
geom-distance (``geom_distance``), camera-projection and contact sensors
among them.  Inverse dynamics run too (``inverse``, with the
INVDISCRETE flag's undo of the discretization under Euler, ImplicitFast
and Implicit), and every enable flag: OVERRIDE and FWDINV are carried and
read nowhere, as in mjtpu.  ``parallel.randomize`` (with ``model_axes``,
``randomize_with_consts`` and ``randomized_step``) gives a Model one row
per env of its friction, masses, inertias, damping, gains, timestep,
gravity and more (``parallel/randomize.py`` lists them), and the zoo's
``reset`` and ``step`` take such a model as ``model=``.  The rest of
mjtpu's public names are here too: ``full_m``, ``mul_m``, ``apply_ft``,
``is_sparse``, ``random_unit_quat`` (from a ``torch.Generator``), the
``scan`` module, ``save_checkpoint``, ``load_checkpoint`` (which also
reads mjtpu's checkpoints of the same model), ``device_get_into`` and
``mujoco_logger``; ``get_data_into`` writes the contacts and efc rows
back too.  ``differentiable_mode()`` (with ``DiffConfig`` and
``get_diff_config``) makes ``step`` differentiable on autograd: fixed
solver iterations, contacts from distance, smooth collisions and
adaptive substeps, as in mjtpu.  ``render``, ``render_rgbd``,
``render_batch``, ``render_batch_rgbd`` and ``precompute_render_data``
ray-trace every env of a batched Data at once (the batched names are the
same functions), and the zoo's envs take ``pixel_obs=True``.  Every
public name of mjtpu has its counterpart here.  ``put_model`` refuses, with
NotImplementedError naming the feature, what mjtpu refuses (flex, PGS,
user sensors).
"""

import pathlib

from mjtpu_torch._src import scan
from mjtpu_torch._src.collision_driver import collision, ncon
from mjtpu_torch._src.constraint import make_constraint
from mjtpu_torch._src.dataclasses import replace, to
from mjtpu_torch._src.derivative import deriv_smooth_vel
from mjtpu_torch._src.diff_config import DiffConfig, differentiable_mode, get_diff_config
from mjtpu_torch._src.forward import (
    euler,
    forward,
    fwd_acceleration,
    fwd_actuation,
    fwd_position,
    fwd_velocity,
    implicit,
    rungekutta4,
    step,
)
from mjtpu_torch._src.inverse import inverse
from mjtpu_torch._src.io import (
    data_from_mjtpu,
    data_to_numpy,
    device_get_into,
    device_put,
    get_data_into,
    load_checkpoint,
    load_snapshot,
    make_data,
    model_from_arrays,
    procedural_terrain,
    put_data,
    put_model,
    save_checkpoint,
    save_snapshot,
)
from mjtpu_torch._src.log import mujoco_logger
from mjtpu_torch._src.math import random_unit_quat
from mjtpu_torch._src.passive import passive
from mjtpu_torch._src.ray import ray, ray_geom
from mjtpu_torch._src.render import (
    precompute_render_data,
    render,
    render_batch,
    render_batch_rgbd,
    render_rgbd,
)
from mjtpu_torch._src.sensor import sensor_acc, sensor_pos, sensor_vel
from mjtpu_torch._src.smooth import (
    camlight,
    com_pos,
    com_vel,
    crb,
    factor_m,
    factor_solve,
    kinematics,
    rne,
    energy_pos,
    energy_vel,
    kinetic_energy,
    potential_energy,
    rne_postconstraint,
    solve_m,
    subtree_vel,
    tendon,
    tendon_armature,
    transmission,
)
from mjtpu_torch._src.solver import solve
from mjtpu_torch._src.support import (
    apply_ft,
    constraint_sizes,
    contact_forces,
    count_constraints,
    full_m,
    geom_distance,
    is_sparse,
    jac,
    mul_m,
    xfrc_accumulate,
)
from mjtpu_torch._src.types import (
    BiasType,
    CamLightType,
    ConeType,
    ConstraintType,
    Contact,
    ConvexMesh,
    Data,
    DataType,
    DisableBit,
    DynType,
    EnableBit,
    EqType,
    GainType,
    GeomType,
    IntegratorType,
    JacobianType,
    JointType,
    Model,
    ObjType,
    Option,
    SensorType,
    SolverType,
    Statistic,
    TrnType,
    WrapType,
)

ASSETS = pathlib.Path(__file__).resolve().parent / "assets"

__version__ = "0.1.0"

from mjtpu_torch import parallel, zoo  # noqa: E402  (after ASSETS: the envs load their snapshots from it)
