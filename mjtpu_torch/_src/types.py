"""Core data model: enums + Option/Statistic/Model/Contact/Data.

Port of mjtpu/_src/types.py.  Two differences follow from where the port
runs:

  * The enum values are hard-coded from MuJoCo's C headers (mjmodel.h,
    MuJoCo 3.10) instead of read from the ``mujoco`` bindings, because the
    machine with the GPU has no ``mujoco``.  tests/test_torch_assets.py
    holds every member equal to the bindings.
  * Every ``Data`` field carries a leading env axis ``B`` (batch-explicit,
    no ``torch.vmap``); ``Model`` is unbatched.

The slices cover the fields the humanoid_bench, humanoid_terrain,
scene_pile, branchy66 and ant_bench main paths read and write (sensors,
cameras and lights since ant_bench), tendons, their wraps and the
actuators' activation states (the tendon slice), and equality constraints
and mocap bodies (the equality slice), and the energy, the camera
intrinsics and the contact sensors' parameters (the Implicit slice).
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from mjtpu_torch._src.dataclasses import static

# ---------------------------------------------------------------------------
# constants mirroring MuJoCo engine internals
# ---------------------------------------------------------------------------

MINVAL = 1e-15  # mjMINVAL
NREF = 2        # mjNREF
NIMP = 5        # mjNIMP
NFLUID = 12     # mjNFLUID
NEQDATA = 11    # mjNEQDATA
MAXVAL = 1e10


class DisableBit(enum.IntFlag):
  """Option disable flags (mjtDisableBit)."""

  CONSTRAINT = 1 << 0
  EQUALITY = 1 << 1
  FRICTIONLOSS = 1 << 2
  LIMIT = 1 << 3
  CONTACT = 1 << 4
  SPRING = 1 << 5
  DAMPER = 1 << 6
  PASSIVE = (1 << 5) | (1 << 6)
  GRAVITY = 1 << 7
  CLAMPCTRL = 1 << 8
  WARMSTART = 1 << 9
  FILTERPARENT = 1 << 10
  ACTUATION = 1 << 11
  REFSAFE = 1 << 12
  SENSOR = 1 << 13
  MIDPHASE = 1 << 14
  EULERDAMP = 1 << 15
  AUTORESET = 1 << 16
  NATIVECCD = 1 << 17


class EnableBit(enum.IntFlag):
  """Option enable flags (mjtEnableBit)."""

  OVERRIDE = 1 << 0
  ENERGY = 1 << 1
  FWDINV = 1 << 2
  INVDISCRETE = 1 << 3


class JointType(enum.IntEnum):
  """Joint types (mjtJoint)."""

  FREE = 0
  BALL = 1
  SLIDE = 2
  HINGE = 3

  def dof_width(self) -> int:
    return {0: 6, 1: 3, 2: 1, 3: 1}[self.value]

  def qpos_width(self) -> int:
    return {0: 7, 1: 4, 2: 1, 3: 1}[self.value]


class IntegratorType(enum.IntEnum):
  """Integrator types (mjtIntegrator)."""

  EULER = 0
  RK4 = 1
  IMPLICIT = 2
  IMPLICITFAST = 3


class GeomType(enum.IntEnum):
  """Geom types (mjtGeom)."""

  PLANE = 0
  HFIELD = 1
  SPHERE = 2
  CAPSULE = 3
  ELLIPSOID = 4
  CYLINDER = 5
  BOX = 6
  MESH = 7


class ConeType(enum.IntEnum):
  """Friction cone types (mjtCone)."""

  PYRAMIDAL = 0
  ELLIPTIC = 1


class JacobianType(enum.IntEnum):
  """Jacobian types (mjtJacobian)."""

  DENSE = 0
  SPARSE = 1
  AUTO = 2


class SolverType(enum.IntEnum):
  """Constraint solver types (mjtSolver).  PGS unsupported."""

  CG = 1
  NEWTON = 2


class EqType(enum.IntEnum):
  """Equality constraint types (mjtEq)."""

  CONNECT = 0
  WELD = 1
  JOINT = 2
  TENDON = 3


class WrapType(enum.IntEnum):
  """Tendon wrap types (mjtWrap)."""

  NONE = 0
  JOINT = 1
  PULLEY = 2
  SITE = 3
  SPHERE = 4
  CYLINDER = 5


class TrnType(enum.IntEnum):
  """Actuator transmission types (mjtTrn)."""

  JOINT = 0
  JOINTINPARENT = 1
  SLIDERCRANK = 2
  TENDON = 3
  SITE = 4
  BODY = 5


class DynType(enum.IntEnum):
  """Actuator dynamics types (mjtDyn)."""

  NONE = 0
  INTEGRATOR = 1
  FILTER = 2
  FILTEREXACT = 3
  MUSCLE = 4


class GainType(enum.IntEnum):
  """Actuator gain types (mjtGain)."""

  FIXED = 0
  AFFINE = 1
  MUSCLE = 2


class BiasType(enum.IntEnum):
  """Actuator bias types (mjtBias)."""

  NONE = 0
  AFFINE = 1
  MUSCLE = 2


class ConstraintType(enum.IntEnum):
  """Constraint row types (mjtConstraint)."""

  EQUALITY = 0
  FRICTION_DOF = 1
  FRICTION_TENDON = 2
  LIMIT_JOINT = 3
  LIMIT_TENDON = 4
  CONTACT_FRICTIONLESS = 5
  CONTACT_PYRAMIDAL = 6
  CONTACT_ELLIPTIC = 7


class CamLightType(enum.IntEnum):
  """Camera/light tracking modes (mjtCamLight)."""

  FIXED = 0
  TRACK = 1
  TRACKCOM = 2
  TARGETBODY = 3
  TARGETBODYCOM = 4


class SensorType(enum.IntEnum):
  """Sensor types (mjtSensor), every member of MuJoCo's enum: put_model
  refuses by name the ones the port does not compute (io.SENSORS_REFUSED)."""

  TOUCH = 0
  ACCELEROMETER = 1
  VELOCIMETER = 2
  GYRO = 3
  FORCE = 4
  TORQUE = 5
  MAGNETOMETER = 6
  RANGEFINDER = 7
  CAMPROJECTION = 8
  JOINTPOS = 9
  JOINTVEL = 10
  TENDONPOS = 11
  TENDONVEL = 12
  ACTUATORPOS = 13
  ACTUATORVEL = 14
  ACTUATORFRC = 15
  JOINTACTFRC = 16
  TENDONACTFRC = 17
  BALLQUAT = 18
  BALLANGVEL = 19
  JOINTLIMITPOS = 20
  JOINTLIMITVEL = 21
  JOINTLIMITFRC = 22
  TENDONLIMITPOS = 23
  TENDONLIMITVEL = 24
  TENDONLIMITFRC = 25
  FRAMEPOS = 26
  FRAMEQUAT = 27
  FRAMEXAXIS = 28
  FRAMEYAXIS = 29
  FRAMEZAXIS = 30
  FRAMELINVEL = 31
  FRAMEANGVEL = 32
  FRAMELINACC = 33
  FRAMEANGACC = 34
  SUBTREECOM = 35
  SUBTREELINVEL = 36
  SUBTREEANGMOM = 37
  INSIDESITE = 38
  GEOMDIST = 39
  GEOMNORMAL = 40
  GEOMFROMTO = 41
  CONTACT = 42
  E_POTENTIAL = 43
  E_KINETIC = 44
  CLOCK = 45
  TACTILE = 46
  PLUGIN = 47
  USER = 48


class ObjType(enum.IntEnum):
  """Object types (mjtObj) that sensors and cameras refer to."""

  UNKNOWN = 0
  BODY = 1
  XBODY = 2
  JOINT = 3
  GEOM = 5
  SITE = 6
  CAMERA = 7
  ACTUATOR = 19
  SENSOR = 20


class DataType(enum.IntEnum):
  """Sensor data types (mjtDataType)."""

  REAL = 0
  POSITIVE = 1
  AXIS = 2
  QUATERNION = 3


class Stage(enum.IntEnum):
  """Computation stages (mjtStage): a sensor's ``sensor_needstage``."""

  NONE = 0
  POS = 1
  VEL = 2
  ACC = 3


# ---------------------------------------------------------------------------
# structs
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ConvexMesh:
  """Host-side convex hull tables of one mesh (all static numpy), closed
  over by the convex colliders as model constants."""

  vert: np.ndarray = static()              # (nvert, 3)
  face: np.ndarray = static()              # (nface, max_face_vert) vert indices, padded by repeat
  face_normal: np.ndarray = static()       # (nface, 3)
  edge: np.ndarray = static()              # (nedge, 2) vert indices of unique edges
  edge_face_normal: np.ndarray = static()  # (nedge, 2, 3) normals of the two adjacent faces


@dataclasses.dataclass
class Option:
  """Physics options (mjOption).  Enum/flag/iteration fields are static:
  they select code paths on the host."""

  timestep: torch.Tensor
  impratio: torch.Tensor
  tolerance: torch.Tensor
  ls_tolerance: torch.Tensor
  gravity: torch.Tensor
  wind: torch.Tensor
  magnetic: torch.Tensor
  density: torch.Tensor
  viscosity: torch.Tensor
  integrator: IntegratorType = static()
  cone: ConeType = static()
  solver: SolverType = static()
  iterations: int = static()
  ls_iterations: int = static()
  disableflags: int = static()
  enableflags: int = static()
  # density, viscosity or wind set: passive adds the fluid forces
  has_fluid_params: bool = static(False)
  # the contact overrides of EnableBit.OVERRIDE: carried and read nowhere,
  # as in mjtpu (ROADMAP C17)
  o_margin: torch.Tensor = None
  o_solref: torch.Tensor = None
  o_solimp: torch.Tensor = None


@dataclasses.dataclass
class Statistic:
  """Model statistics (mjStatistic)."""

  meaninertia: torch.Tensor


@dataclasses.dataclass
class Model:
  """Static scene description (the slice's part of mjModel).

  Tensor fields live on the model's device in its float dtype; numpy/int
  fields are host structure.  Field semantics match mjModel 1:1.
  ``cache`` holds host precomputation (index tables, candidate groups,
  static efc layout) built once per Model; ``dataclasses.replace`` starts
  a fresh one, so a model with other options never reads stale tables.
  """

  # ---- sizes ----
  nq: int = static()
  nv: int = static()
  nu: int = static()
  na: int = static()
  nbody: int = static()
  njnt: int = static()
  ngeom: int = static()
  nsite: int = static()
  npair: int = static()
  nexclude: int = static()
  ntendon: int = static()
  nwrap: int = static()
  nmesh: int = static()
  nhfield: int = static()
  ncam: int = static()
  nlight: int = static()
  nsensor: int = static()
  nsensordata: int = static()
  neq: int = static()
  nmocap: int = static()
  # ---- options / statistics ----
  opt: Option = None
  stat: Statistic = None
  # ---- qpos defaults ----
  qpos0: torch.Tensor = None
  qpos_spring: torch.Tensor = None
  # ---- bodies ----
  body_parentid: np.ndarray = static(None)
  body_rootid: np.ndarray = static(None)
  body_mocapid: np.ndarray = static(None)  # (nbody,) mocap index, -1 for other bodies
  body_weldid: np.ndarray = static(None)
  body_jntnum: np.ndarray = static(None)
  body_jntadr: np.ndarray = static(None)
  body_dofnum: np.ndarray = static(None)
  body_dofadr: np.ndarray = static(None)
  # each body's first geom and geom count, read by the geom-distance
  # sensors' body operands (-1 and 0 where a snapshot leaves them out)
  body_geomadr: np.ndarray = static(None)
  body_geomnum: np.ndarray = static(None)
  body_pos: torch.Tensor = None
  body_quat: torch.Tensor = None
  body_ipos: torch.Tensor = None
  body_iquat: torch.Tensor = None
  body_mass: torch.Tensor = None
  body_subtreemass: torch.Tensor = None
  body_inertia: torch.Tensor = None
  body_gravcomp: torch.Tensor = None
  body_invweight0: torch.Tensor = None
  # ---- joints ----
  jnt_type: np.ndarray = static(None)
  jnt_qposadr: np.ndarray = static(None)
  jnt_dofadr: np.ndarray = static(None)
  jnt_bodyid: np.ndarray = static(None)
  jnt_limited: np.ndarray = static(None)
  jnt_actfrclimited: np.ndarray = static(None)
  # True where the joint's dofs take their gravity compensation through
  # qfrc_actuator, not qfrc_passive
  jnt_actgravcomp: np.ndarray = static(None)
  jnt_solref: torch.Tensor = None
  jnt_solimp: torch.Tensor = None
  jnt_pos: torch.Tensor = None
  jnt_axis: torch.Tensor = None
  jnt_stiffness: torch.Tensor = None
  jnt_range: torch.Tensor = None
  jnt_actfrcrange: torch.Tensor = None
  jnt_margin: torch.Tensor = None
  # ---- dofs ----
  dof_bodyid: np.ndarray = static(None)
  dof_jntid: np.ndarray = static(None)
  dof_parentid: np.ndarray = static(None)
  dof_armature: torch.Tensor = None
  dof_damping: torch.Tensor = None
  dof_invweight0: torch.Tensor = None
  # mj_setConst's dof_M0, read nowhere (as in mjtpu): None but where
  # parallel.randomize gives it one row per env
  dof_M0: torch.Tensor = None
  dof_frictionloss: torch.Tensor = None
  # the solver parameters of the dofs' friction rows, their only reader:
  # mjModel's values at the dofs with frictionloss > 0, zero at the others
  # (a snapshot of a model without friction dofs does not store them)
  dof_solref: torch.Tensor = None
  dof_solimp: torch.Tensor = None
  # ---- geoms ----
  geom_type: np.ndarray = static(None)
  geom_contype: np.ndarray = static(None)
  geom_conaffinity: np.ndarray = static(None)
  geom_condim: np.ndarray = static(None)
  geom_bodyid: np.ndarray = static(None)
  geom_dataid: np.ndarray = static(None)
  geom_priority: np.ndarray = static(None)
  geom_group: np.ndarray = static(None)
  geom_solmix: torch.Tensor = None
  geom_solref: torch.Tensor = None
  geom_solimp: torch.Tensor = None
  geom_size: torch.Tensor = None
  geom_pos: torch.Tensor = None
  geom_quat: torch.Tensor = None
  geom_friction: torch.Tensor = None
  geom_margin: torch.Tensor = None
  geom_gap: torch.Tensor = None
  geom_rbound: torch.Tensor = None
  # the ellipsoid fluid model's coefficients (NFLUID a geom; column 0 is
  # the compiler's fluidshape="ellipsoid" flag), zero where unused
  geom_fluid: torch.Tensor = None
  geom_fluid_np: np.ndarray = static(None)   # host copy: ellipsoid-fluid dispatch
  geom_rbound_np: np.ndarray = static(None)  # host copy: hfield subgrid sizing
  geom_size_np: np.ndarray = static(None)    # host copy: box grouping by exact size
  # per geom: the hull of a colliding box (mesh.box of its grouping key),
  # None for every other geom
  geom_convex: tuple = static(None)
  # ---- sites ----
  site_bodyid: np.ndarray = static(None)
  site_type: np.ndarray = static(None)
  site_size: torch.Tensor = None
  site_pos: torch.Tensor = None
  site_quat: torch.Tensor = None
  # ---- cameras and lights ----
  cam_mode: np.ndarray = static(None)
  cam_bodyid: np.ndarray = static(None)
  cam_targetbodyid: np.ndarray = static(None)
  cam_pos: torch.Tensor = None
  cam_quat: torch.Tensor = None
  cam_poscom0: torch.Tensor = None
  cam_pos0: torch.Tensor = None
  cam_mat0: torch.Tensor = None
  # the CAMPROJECTION sensor's camera intrinsics (host numbers: the focal
  # lengths are model constants; zeros where a snapshot leaves them out)
  cam_resolution: np.ndarray = static(None)
  cam_sensorsize: np.ndarray = static(None)
  cam_intrinsic: np.ndarray = static(None)
  cam_fovy: np.ndarray = static(None)  # degrees (the renderer; CAMPROJECTION)
  light_mode: np.ndarray = static(None)
  light_bodyid: np.ndarray = static(None)
  light_targetbodyid: np.ndarray = static(None)
  light_pos: torch.Tensor = None
  light_dir: torch.Tensor = None
  light_poscom0: torch.Tensor = None
  light_pos0: torch.Tensor = None
  light_dir0: torch.Tensor = None  # read nowhere, as in mjtpu
  # ---- what the renderer reads (mjtpu's split: index tables, texture
  # bytes and light flags on the host, colours and light terms on the
  # device); fills where a snapshot leaves them out, named in render_filled ----
  geom_rgba: torch.Tensor = None
  geom_matid: np.ndarray = static(None)
  mat_texid: np.ndarray = static(None)        # (nmat, mjNTEXROLE)
  mat_texrepeat: np.ndarray = static(None)
  mat_texuniform: np.ndarray = static(None)
  mat_rgba: np.ndarray = static(None)
  tex_type: np.ndarray = static(None)
  tex_adr: np.ndarray = static(None)
  tex_height: np.ndarray = static(None)
  tex_width: np.ndarray = static(None)
  tex_nchannel: np.ndarray = static(None)
  tex_data: np.ndarray = static(None)         # (ntexdata,) uint8
  light_type: np.ndarray = static(None)
  light_castshadow: np.ndarray = static(None)
  light_active: np.ndarray = static(None)
  light_diffuse: torch.Tensor = None
  light_ambient: torch.Tensor = None
  light_specular: torch.Tensor = None
  light_attenuation: torch.Tensor = None
  light_cutoff: torch.Tensor = None
  light_exponent: torch.Tensor = None
  render_filled: frozenset = static(frozenset())  # the render fields that hold fills
  # ---- meshes (convex hulls and the triangles rays hit) and height fields ----
  mesh_convex: tuple = static(None)        # tuple[ConvexMesh | None] per mesh
  mesh_vertadr: np.ndarray = static(None)
  mesh_faceadr: np.ndarray = static(None)
  mesh_facenum: np.ndarray = static(None)
  mesh_vert: np.ndarray = static(None)     # (nmeshvert, 3) host copy: ray triangles
  mesh_face: np.ndarray = static(None)     # (nmeshface, 3)
  hfield_adr: np.ndarray = static(None)
  hfield_nrow: np.ndarray = static(None)
  hfield_ncol: np.ndarray = static(None)
  hfield_size: np.ndarray = static(None)   # (nhfield, 4) sx, sy, ztop, zbottom
  hfield_data: torch.Tensor = None
  # ---- predefined / excluded collision pairs ----
  pair_dim: np.ndarray = static(None)
  pair_geom1: np.ndarray = static(None)
  pair_geom2: np.ndarray = static(None)
  pair_solref: torch.Tensor = None
  pair_solreffriction: torch.Tensor = None
  pair_solimp: torch.Tensor = None
  pair_margin: torch.Tensor = None
  pair_gap: torch.Tensor = None
  pair_friction: torch.Tensor = None
  exclude_signature: np.ndarray = static(None)
  # ---- equality constraints (eq_data: mjNEQDATA = 11 numbers each) ----
  eq_type: np.ndarray = static(None)
  eq_obj1id: np.ndarray = static(None)
  eq_obj2id: np.ndarray = static(None)
  eq_objtype: np.ndarray = static(None)
  eq_active0: np.ndarray = static(None)
  eq_solref: torch.Tensor = None
  eq_solimp: torch.Tensor = None
  eq_data: torch.Tensor = None
  # ---- tendons and their wraps ----
  tendon_adr: np.ndarray = static(None)
  tendon_num: np.ndarray = static(None)
  tendon_limited: np.ndarray = static(None)
  tendon_solref_lim: torch.Tensor = None
  tendon_solimp_lim: torch.Tensor = None
  tendon_solref_fri: torch.Tensor = None
  tendon_solimp_fri: torch.Tensor = None
  tendon_range: torch.Tensor = None
  tendon_margin: torch.Tensor = None
  tendon_stiffness: torch.Tensor = None
  tendon_damping: torch.Tensor = None
  tendon_armature: torch.Tensor = None
  tendon_frictionloss: torch.Tensor = None
  tendon_lengthspring: torch.Tensor = None
  tendon_length0: torch.Tensor = None
  tendon_invweight0: torch.Tensor = None
  wrap_type: np.ndarray = static(None)
  wrap_objid: np.ndarray = static(None)
  wrap_prm: np.ndarray = static(None)
  # ---- actuators ----
  actuator_trntype: np.ndarray = static(None)
  actuator_dyntype: np.ndarray = static(None)
  actuator_gaintype: np.ndarray = static(None)
  actuator_biastype: np.ndarray = static(None)
  actuator_trnid: np.ndarray = static(None)
  actuator_actadr: np.ndarray = static(None)
  actuator_actnum: np.ndarray = static(None)
  actuator_ctrllimited: np.ndarray = static(None)
  actuator_forcelimited: np.ndarray = static(None)
  actuator_actlimited: np.ndarray = static(None)
  actuator_actearly: np.ndarray = static(None)
  actuator_dynprm: torch.Tensor = None
  actuator_gainprm: torch.Tensor = None
  actuator_biasprm: torch.Tensor = None
  actuator_ctrlrange: torch.Tensor = None
  actuator_forcerange: torch.Tensor = None
  actuator_gear: torch.Tensor = None
  actuator_actrange: torch.Tensor = None
  actuator_cranklength: torch.Tensor = None
  actuator_acc0: torch.Tensor = None
  actuator_lengthrange: torch.Tensor = None
  # ---- sensors ----
  sensor_type: np.ndarray = static(None)
  sensor_datatype: np.ndarray = static(None)
  sensor_needstage: np.ndarray = static(None)
  sensor_objtype: np.ndarray = static(None)
  sensor_objid: np.ndarray = static(None)
  sensor_reftype: np.ndarray = static(None)
  sensor_refid: np.ndarray = static(None)
  sensor_dim: np.ndarray = static(None)
  sensor_adr: np.ndarray = static(None)
  # (nsensor, 3) [dataspec, reduce, num] of a CONTACT sensor (zeros where a
  # snapshot leaves them out)
  sensor_intprm: np.ndarray = static(None)
  sensor_cutoff: torch.Tensor = None
  # model-constant (nu, nv) moment matrix where every actuator is a
  # scalar-joint transmission, whose moment row is gear[0] at the joint
  # dof; None where some actuator's moment depends on the state.  A device
  # tensor that parallel.randomize treats as static, as mjtpu declares it
  actuator_static_moment: torch.Tensor = None
  # ---- custom numerics / names (max_contact_points lookup) ----
  numeric_adr: np.ndarray = static(None)
  numeric_data: np.ndarray = static(None)
  name_numericadr: np.ndarray = static(None)
  names: bytes = static(None)
  # ---- derived static structure ----
  # (njnt,) bool: range narrower than 2*margin, so C can emit both the
  # lower and the upper limit row at once (support.count_constraints)
  jnt_limit_two_sided: np.ndarray = static(None)
  tendon_limit_two_sided: np.ndarray = static(None)  # (ntendon,) the same for tendons
  friction_dofid: np.ndarray = static(None)  # dofs with frictionloss > 0
  friction_tenid: np.ndarray = static(None)  # tendons with frictionloss > 0
  has_jnt_spring: bool = static(False)
  has_dof_damping: bool = static(False)
  has_gravcomp: bool = static(False)  # any body_gravcomp > 0
  has_tendon_spring: bool = static(False)  # any tendon_stiffness > 0
  has_tendon_damping: bool = static(False)  # any tendon_damping > 0
  has_tendon_armature: bool = static(False)  # any tendon_armature > 0
  # the field paths ("body_mass", "opt.timestep", ...) that hold one row
  # per env, (B, *shape), on a model from parallel.randomize; rows() reads
  # every field randomize may batch
  env_fields: frozenset = static(frozenset())
  cache: dict = dataclasses.field(
      init=False, repr=False, compare=False, metadata={"static": True}
  )

  def __post_init__(self):
    self.cache = {}

  @property
  def device(self) -> torch.device:
    return self.qpos0.device

  @property
  def dtype(self) -> torch.dtype:
    return self.qpos0.dtype


def _holds_grad(obj) -> bool:
  """Whether a tensor field of ``obj`` (a Model, its Option or Statistic)
  requires grad."""
  for f in dataclasses.fields(obj):
    x = getattr(obj, f.name)
    if isinstance(x, torch.Tensor):
      if x.requires_grad:
        return True
    elif dataclasses.is_dataclass(x) and _holds_grad(x):
      return True
  return False


def grad_live(m: Model) -> bool:
  """Whether grad mode is on and a traced field of ``m`` requires grad:
  the tables built from traced fields must then carry this call's graph.
  The fields are read once per Model, at its first call in grad mode: give
  a field requires_grad before that, or take a new Model with it
  (parallel.randomize, replace_fields).  Host attributes only, no sync."""
  if not torch.is_grad_enabled():
    return False
  live = m.cache.get("grad_live")
  if live is None:
    live = m.cache["grad_live"] = _holds_grad(m)
  return live


def cached(m: Model, key, build, live: bool = False):
  """Returns ``m.cache[key]``, building it with ``build()`` on first use.

  ``live`` marks a table that ``build`` makes from traced fields.  Where
  grad_live(m), such a table is built from the live fields on every call
  and not kept: a kept table would hold the graph of the call that built
  it, which its backward frees, or none where it was built under no_grad.
  Otherwise it is kept as the plain path keeps it.  A live builder takes
  its indices from tables of its own (not live, kept), so that a rebuild
  copies nothing from the host."""
  if live and grad_live(m):
    return build()
  if key not in m.cache:
    m.cache[key] = build()
  return m.cache[key]


def derived(m: Model, key, build) -> Model:
  """The Model ``build()`` derives from ``m`` (a substep Model, a stacked
  one), cached under ``key`` like a live table.  Where it is rebuilt
  (grad_live(m)), every build shares one cache dict kept on ``m``: the
  builds differ only in their graph, which the live tables ``cached`` never
  keeps there, so the other tables kept there hold for each of them and are
  built once."""
  if not grad_live(m):
    return cached(m, key, build)
  out = build()
  if out is not m:
    out.cache = cached(m, (key, "cache"), dict)
  return out


def field(m, name: str):
  """The attribute at the dotted path ``name`` ("opt.timestep", "body_mass")
  of a Model, an MjModel or a snapshot's namespace."""
  obj = m
  for part in name.split("."):
    obj = getattr(obj, part)
  return obj


def rows(m: Model, name: str) -> torch.Tensor:
  """The field ``name`` with a leading env axis E: (B, *shape) where the
  model holds one row per env (parallel.randomize), else (1, *shape), a
  view that broadcasts over the batch.  Every reader of a field that
  randomize accepts goes through here, and indexes the field's own axes
  after the env axis, so one expression serves both."""
  x = field(m, name)
  return x if name in m.env_fields else x[None]


def env_expand(x: torch.Tensor, batch: int) -> torch.Tensor:
  """``x``, whose leading axis is an env axis of 1 or ``batch`` (rows, or
  a table built from them), as a (batch, ...) view."""
  return x.expand((batch,) + x.shape[1:])


def replace_fields(m: Model, updates: dict) -> Model:
  """A copy of ``m`` (with a fresh cache) whose dotted paths take the
  values of ``updates``."""
  nested: dict = {}
  for name, v in updates.items():
    head, _, rest = name.partition(".")
    if rest:
      nested.setdefault(head, {})[rest] = v
    else:
      nested[head] = v
  return dataclasses.replace(m, **{
      k: dataclasses.replace(getattr(m, k), **v) if isinstance(v, dict) else v
      for k, v in nested.items()})


def repeat_env_rows(m: Model, k: int) -> Model:
  """``m`` with each env row repeated k times in place, for a batch whose
  envs are each stacked k times (m itself where it has no env rows)."""
  if not m.env_fields:
    return m
  return replace_fields(m, {n: field(m, n).repeat_interleave(k, dim=0) for n in m.env_fields})


def index(m: Model, name: str) -> torch.Tensor:
  """The static index field ``name`` as a long tensor on the model's device.

  Indexing a CUDA tensor with a numpy array copies the array to the device
  on every call, and a copy from pageable host memory waits for the
  stream; the cached tensor keeps the step free of such copies."""
  return cached(m, ("index", name), lambda: torch.as_tensor(
      np.asarray(getattr(m, name)), dtype=torch.long, device=m.device))


@dataclasses.dataclass
class Contact:
  """Contact state (mjContact rows, structure-of-arrays over ncon), each
  field with a leading env axis B."""

  dist: torch.Tensor           # (B, ncon)
  pos: torch.Tensor            # (B, ncon, 3)
  frame: torch.Tensor          # (B, ncon, 3, 3) rows: normal, tangent1, tangent2
  includemargin: torch.Tensor  # (B, ncon)
  margin: torch.Tensor         # (B, ncon) detection margin (margin + gap)
  friction: torch.Tensor       # (B, ncon, 5)
  solref: torch.Tensor         # (B, ncon, NREF)
  solreffriction: torch.Tensor  # (B, ncon, NREF)
  solimp: torch.Tensor         # (B, ncon, NIMP)
  dim: torch.Tensor            # (B, ncon) int32
  geom1: torch.Tensor          # (B, ncon) int32
  geom2: torch.Tensor          # (B, ncon) int32
  geom: torch.Tensor           # (B, ncon, 2) int32
  efc_address: torch.Tensor    # (B, ncon) int32

  @classmethod
  def zero(cls, batch: int, ncon: int, dtype, device) -> "Contact":
    f = lambda *s: torch.zeros((batch, ncon) + s, dtype=dtype, device=device)
    i = lambda *s: torch.full((batch, ncon) + s, -1, dtype=torch.int32, device=device)
    return cls(
        dist=f(), pos=f(3), frame=f(3, 3), includemargin=f(), margin=f(),
        friction=f(5), solref=f(NREF), solreffriction=f(NREF), solimp=f(NIMP),
        dim=torch.zeros((batch, ncon), dtype=torch.int32, device=device),
        geom1=i(), geom2=i(), geom=i(2), efc_address=i(),
    )


@dataclasses.dataclass
class Data:
  """Dynamic simulation state (the slice's part of mjData), batched: every
  field has a leading env axis B.  Constraint row counts are static
  functions of Model (``support.constraint_sizes``), as in mjtpu."""

  # state
  time: torch.Tensor
  qpos: torch.Tensor
  qvel: torch.Tensor
  act: torch.Tensor
  qacc_warmstart: torch.Tensor
  # control
  ctrl: torch.Tensor
  qfrc_applied: torch.Tensor
  xfrc_applied: torch.Tensor
  eq_active: torch.Tensor   # (B, neq) bool
  # mocap bodies: user-set frames, (B, nmocap, 3) and (B, nmocap, 4), read
  # by kinematics in place of body_pos/body_quat
  mocap_pos: torch.Tensor
  mocap_quat: torch.Tensor
  # dynamics
  qacc: torch.Tensor
  act_dot: torch.Tensor
  # position-stage kinematics
  xpos: torch.Tensor
  xquat: torch.Tensor
  xmat: torch.Tensor
  xipos: torch.Tensor
  ximat: torch.Tensor
  xanchor: torch.Tensor
  xaxis: torch.Tensor
  geom_xpos: torch.Tensor
  geom_xmat: torch.Tensor
  site_xpos: torch.Tensor
  site_xmat: torch.Tensor
  cam_xpos: torch.Tensor
  cam_xmat: torch.Tensor
  light_xpos: torch.Tensor
  light_xdir: torch.Tensor
  subtree_com: torch.Tensor
  cdof: torch.Tensor
  cinert: torch.Tensor
  # tendons: lengths, Jacobians (B, ntendon, nv), velocities; one (2, 3)
  # world pair of wrap points per sphere or cylinder wrap entry
  # (tendon_wrap.build_program's order), active where it wrapped this step
  ten_length: torch.Tensor
  ten_J: torch.Tensor
  ten_velocity: torch.Tensor
  ten_wrap_xpos: torch.Tensor
  ten_wrap_active: torch.Tensor
  # actuation
  actuator_length: torch.Tensor
  actuator_moment: torch.Tensor
  actuator_velocity: torch.Tensor
  actuator_force: torch.Tensor
  # mass matrix
  crb: torch.Tensor
  qM: torch.Tensor
  qLD: torch.Tensor
  qLDiagInv: torch.Tensor
  # velocity stage
  cvel: torch.Tensor
  cdof_dot: torch.Tensor
  qfrc_bias: torch.Tensor
  qfrc_spring: torch.Tensor
  qfrc_damper: torch.Tensor
  qfrc_gravcomp: torch.Tensor
  qfrc_fluid: torch.Tensor
  qfrc_passive: torch.Tensor
  subtree_linvel: torch.Tensor
  subtree_angmom: torch.Tensor
  # constraints
  contact: Contact
  efc_J: torch.Tensor
  efc_pos: torch.Tensor
  efc_margin: torch.Tensor
  efc_frictionloss: torch.Tensor
  efc_D: torch.Tensor
  efc_aref: torch.Tensor
  efc_force: torch.Tensor
  # forces
  qfrc_actuator: torch.Tensor
  qfrc_smooth: torch.Tensor
  qacc_smooth: torch.Tensor
  qfrc_constraint: torch.Tensor
  # inverse dynamics (mj_inverse): the applied force that gives qacc
  qfrc_inverse: torch.Tensor
  # post-constraint (rne_postconstraint) and sensors
  cacc: torch.Tensor
  cfrc_int: torch.Tensor
  cfrc_ext: torch.Tensor
  sensordata: torch.Tensor
  # (B, 2) potential and kinetic energy, written under EnableBit.ENERGY or
  # by an E_POTENTIAL or E_KINETIC sensor (mj_energyPos / mj_energyVel)
  energy: torch.Tensor
  # solver iterations taken (int32, per env)
  solver_niter: torch.Tensor
  # count of _check_state resets since make_data (int32, per env)
  nreset: torch.Tensor

  @property
  def batch_size(self) -> int:
    return self.qpos.shape[0]
