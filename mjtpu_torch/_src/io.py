"""Model/Data ingestion: compiled-model arrays -> Model, Data allocation.

Port of mjtpu/_src/io.py.  ``model_from_arrays`` reads any object with
``mujoco.MjModel``'s attribute names, so ``put_model(mjm)`` works on a live
MjModel where ``mujoco`` is installed, and ``load_snapshot`` supplies the
same attributes from a committed .npz where it is not (the machine with
the GPU has neither ``mujoco`` nor ``jax``).

put_model refuses, with NotImplementedError naming the feature, what
mjtpu refuses: flex, PGS and user and plugin sensors.

``data_from_mjtpu`` and ``data_to_numpy`` map between mjtpu's Data (as
numpy) and the port's batched Data field by field by name; the parity
tests feed both engines identical inputs with them.

The entry points build on ``device="cuda"`` unless the caller names
another device; without a card they raise and ask for ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import json
import types

import numpy as np
import torch

from mjtpu_torch._src import mesh, support
from mjtpu_torch._src.types import (
    BiasType,
    ConeType,
    ConstraintType,
    Contact,
    ConvexMesh,
    Data,
    EnableBit,
    EqType,
    GainType,
    GeomType,
    IntegratorType,
    JointType,
    Model,
    NEQDATA,
    NFLUID,
    NIMP,
    NREF,
    Option,
    SensorType,
    SolverType,
    Statistic,
    TrnType,
    env_expand,
    field,
    rows as env_rows,
)

# every MjModel attribute model_from_arrays reads: the model snapshot
# (save_snapshot) stores exactly these
SIZE_FIELDS = (
    "nq", "nv", "nu", "na", "nbody", "njnt", "ngeom", "nsite", "npair",
    "nexclude", "neq", "ntendon", "nsensor", "nflex", "nmocap", "nmesh", "nhfield",
    "ncam", "nlight", "nsensordata",
)
OPTION_FIELDS = (
    "opt.timestep", "opt.impratio", "opt.tolerance", "opt.ls_tolerance",
    "opt.gravity", "opt.wind", "opt.magnetic", "opt.density", "opt.viscosity",
    "opt.integrator", "opt.cone", "opt.solver", "opt.iterations",
    "opt.ls_iterations", "opt.disableflags", "opt.enableflags",
    "stat.meaninertia",
)
STATIC_FIELDS = (
    "body_parentid", "body_rootid", "body_weldid", "body_jntnum",
    "body_jntadr", "body_dofnum", "body_dofadr",
    "jnt_type", "jnt_qposadr", "jnt_dofadr", "jnt_bodyid", "jnt_limited",
    "jnt_actfrclimited",
    "dof_bodyid", "dof_jntid", "dof_parentid",
    "geom_type", "geom_contype", "geom_conaffinity", "geom_condim",
    "geom_bodyid", "geom_dataid", "geom_priority", "geom_group",
    "site_bodyid", "site_type",
    "cam_mode", "cam_bodyid", "cam_targetbodyid",
    "light_mode", "light_bodyid", "light_targetbodyid",
    "mesh_vertadr", "mesh_faceadr", "mesh_facenum", "mesh_vert", "mesh_face",
    "hfield_adr", "hfield_nrow", "hfield_ncol", "hfield_size",
    "pair_dim", "pair_geom1", "pair_geom2", "exclude_signature",
    "actuator_trntype", "actuator_dyntype", "actuator_gaintype",
    "actuator_biastype", "actuator_trnid", "actuator_ctrllimited",
    "actuator_forcelimited",
    "sensor_type", "sensor_datatype", "sensor_needstage", "sensor_objtype",
    "sensor_objid", "sensor_reftype", "sensor_refid", "sensor_dim", "sensor_adr",
    "numeric_adr", "numeric_data", "name_numericadr",
)
FLOAT_FIELDS = (
    "qpos0", "qpos_spring",
    "body_pos", "body_quat", "body_ipos", "body_iquat", "body_mass",
    "body_subtreemass", "body_inertia", "body_gravcomp", "body_invweight0",
    "jnt_solref", "jnt_solimp", "jnt_pos", "jnt_axis", "jnt_stiffness",
    "jnt_range", "jnt_actfrcrange", "jnt_margin",
    "dof_armature", "dof_damping", "dof_invweight0", "dof_frictionloss",
    "geom_solmix", "geom_solref", "geom_solimp", "geom_size", "geom_pos",
    "geom_quat", "geom_friction", "geom_margin", "geom_gap", "geom_rbound",
    "site_size", "site_pos", "site_quat", "hfield_data",
    "cam_pos", "cam_quat", "cam_poscom0", "cam_pos0", "cam_mat0",
    "light_pos", "light_dir", "light_poscom0", "light_pos0",
    "pair_solref", "pair_solreffriction", "pair_solimp", "pair_margin",
    "pair_gap", "pair_friction",
    "actuator_gainprm", "actuator_biasprm", "actuator_ctrlrange",
    "actuator_forcerange", "actuator_gear", "sensor_cutoff",
)
# MuJoCo's defaults of the contact overrides, which a snapshot of a model
# without EnableBit.OVERRIDE leaves out
O_SOLREF = (0.02, 1.0)
O_SOLIMP = (0.9, 0.95, 0.001, 0.5, 2.0)
OVERRIDE_FIELDS = ("opt.o_margin", "opt.o_solref", "opt.o_solimp")
SNAPSHOT_FIELDS = SIZE_FIELDS + OPTION_FIELDS + STATIC_FIELDS + FLOAT_FIELDS + ("names",)
# fields a snapshot stores only where their reader runs, so the snapshots
# of models without it stay as they were (model_from_arrays reads zeros
# in their place): the friction rows' solver parameters where some dof
# has frictionloss > 0, the ellipsoid fluid coefficients where the model
# has fluid forces, the actuator-channel flag where it has gravity
# compensation
FRICTION_FIELDS = ("dof_solref", "dof_solimp")
FLUID_FIELDS = ("geom_fluid",)
GRAVCOMP_FIELDS = ("jnt_actgravcomp",)
# the tendons and their wraps, stored where the model has a tendon; the
# activation states' and the state-dependent transmissions' fields, where
# it has an activation state, a muscle gain or bias, or a slider-crank.
# Each field's value where the snapshot leaves it out: (fill, trailing
# shape, numpy dtype), with the model's ntendon (or nu) rows
TENDON_FIELDS = {
    "nwrap": (0, None, np.int64),
    "tendon_adr": (0, (), np.int32), "tendon_num": (0, (), np.int32),
    "tendon_limited": (False, (), bool),
    "tendon_solref_lim": (0.0, (NREF,), np.float64),
    "tendon_solimp_lim": (0.0, (NIMP,), np.float64),
    "tendon_solref_fri": (0.0, (NREF,), np.float64),
    "tendon_solimp_fri": (0.0, (NIMP,), np.float64),
    "tendon_range": (0.0, (2,), np.float64), "tendon_margin": (0.0, (), np.float64),
    "tendon_stiffness": (0.0, (), np.float64), "tendon_damping": (0.0, (), np.float64),
    "tendon_armature": (0.0, (), np.float64), "tendon_frictionloss": (0.0, (), np.float64),
    "tendon_lengthspring": (0.0, (2,), np.float64), "tendon_length0": (0.0, (), np.float64),
    "tendon_invweight0": (0.0, (), np.float64),
    "wrap_type": (0, (), np.int32), "wrap_objid": (0, (), np.int32),
    "wrap_prm": (0.0, (), np.float64),
}
ACT_FIELDS = {
    "actuator_actadr": (-1, (), np.int32), "actuator_actnum": (0, (), np.int32),
    "actuator_actlimited": (False, (), bool), "actuator_actearly": (False, (), bool),
    "actuator_dynprm": (0.0, (10,), np.float64), "actuator_actrange": (0.0, (2,), np.float64),
    "actuator_cranklength": (0.0, (), np.float64), "actuator_acc0": (0.0, (), np.float64),
    "actuator_lengthrange": (0.0, (2,), np.float64),
}
# the equality constraints' fields, stored where the model has one (rows:
# neq); the mocap index of each body, where the model has a mocap body
# (rows: nbody, -1 where a snapshot leaves it out)
EQ_FIELDS = {
    "eq_type": (0, (), np.int32), "eq_obj1id": (0, (), np.int32),
    "eq_obj2id": (0, (), np.int32), "eq_objtype": (0, (), np.int32),
    "eq_active0": (False, (), bool), "eq_solref": (0.0, (NREF,), np.float64),
    "eq_solimp": (0.0, (NIMP,), np.float64), "eq_data": (0.0, (NEQDATA,), np.float64),
}
MOCAP_FIELDS = {"body_mocapid": (-1, (), np.int32)}
# each light's direction at qpos0 (mj_setConst's, read nowhere, as in
# mjtpu), stored where the model has a light (rows: nlight)
LIGHT_FIELDS = {"light_dir0": (0.0, (3,), np.float64)}
# the fields only a sensor type reads, stored where the model has such a
# sensor: a CONTACT sensor's [dataspec, reduce, num] (rows: nsensor), a
# CAMPROJECTION sensor's camera intrinsics (rows: ncam), and the geoms of
# a body operand of GEOMDIST, GEOMNORMAL and GEOMFROMTO (rows: nbody)
CONTACT_SENSOR_FIELDS = {"sensor_intprm": (0, (3,), np.int32)}
CAMPROJ_FIELDS = {
    "cam_resolution": (0, (2,), np.int32), "cam_sensorsize": (0.0, (2,), np.float32),
    "cam_intrinsic": (0.0, (4,), np.float32),
}
GEOMDIST_FIELDS = {"body_geomadr": (-1, (), np.int32), "body_geomnum": (0, (), np.int32)}
# what the renderer reads (mjtpu's io.py keeps the same split between host
# and device), stored where the model has a camera: the geoms' colours and
# materials, the materials' textures, the textures' bytes, the lights'
# kinds and terms and each camera's field of view (rows: ngeom, nlight,
# ncam; none of the materials and textures where a snapshot leaves them out)
RENDER_FIELDS = {
    "geom_rgba": (0.0, (4,), np.float32), "geom_matid": (-1, (), np.int32),
    "mat_texid": (-1, (10,), np.int32), "mat_texrepeat": (0.0, (2,), np.float32),
    "mat_texuniform": (False, (), bool), "mat_rgba": (0.0, (4,), np.float32),
    "tex_type": (0, (), np.int32), "tex_adr": (0, (), np.int64), "tex_height": (0, (), np.int32),
    "tex_width": (0, (), np.int32), "tex_nchannel": (0, (), np.int32),
    "tex_data": (0, (), np.uint8),
    "light_type": (0, (), np.int32), "light_castshadow": (False, (), bool),
    "light_active": (False, (), bool),
    "light_diffuse": (0.0, (3,), np.float32), "light_ambient": (0.0, (3,), np.float32),
    "light_specular": (0.0, (3,), np.float32), "light_attenuation": (0.0, (3,), np.float32),
    "light_cutoff": (0.0, (), np.float32), "light_exponent": (0.0, (), np.float32),
    "cam_fovy": (0.0, (), np.float64),
}
# the optional fields that the port keeps on the host (index tables, the
# wraps' and the sensors' static parameters, the renderer's tables)
_HOST_FIELDS = frozenset(("nwrap", "tendon_adr", "tendon_num", "tendon_limited", "wrap_type",
                          "wrap_objid", "wrap_prm", "actuator_actadr", "actuator_actnum",
                          "actuator_actlimited", "actuator_actearly", "eq_type", "eq_obj1id",
                          "eq_obj2id", "eq_objtype", "eq_active0", "body_mocapid",
                          *CONTACT_SENSOR_FIELDS, *CAMPROJ_FIELDS, *GEOMDIST_FIELDS,
                          *(k for k in RENDER_FIELDS if k not in (
                              "geom_rgba", "light_diffuse", "light_ambient", "light_specular",
                              "light_attenuation", "light_cutoff", "light_exponent"))))
# a snapshot also stores the hull tables of each colliding mesh, under
# "hull.<mesh id>.<ConvexMesh field>", and of each colliding box, cylinder
# and ellipsoid, under "geomhull.<geom id>.<ConvexMesh field>"
HULL_FIELDS = ("vert", "face", "face_normal", "edge", "edge_face_normal")
HULL_PREFIXES = ("hull.", "geomhull.")


# the sensor types the port computes (mjtpu's sensor_pos, sensor_vel and
# sensor_acc); put_model refuses every other type by name
SENSORS_PORTED = frozenset(SensorType[n] for n in (
    "MAGNETOMETER", "RANGEFINDER", "JOINTPOS", "TENDONPOS", "ACTUATORPOS", "BALLQUAT",
    "FRAMEPOS", "FRAMEQUAT", "FRAMEXAXIS", "FRAMEYAXIS", "FRAMEZAXIS", "SUBTREECOM", "CLOCK",
    "INSIDESITE", "JOINTLIMITPOS", "TENDONLIMITPOS",
    "VELOCIMETER", "GYRO", "JOINTVEL", "TENDONVEL", "ACTUATORVEL", "BALLANGVEL",
    "SUBTREELINVEL", "SUBTREEANGMOM", "FRAMELINVEL", "FRAMEANGVEL", "JOINTLIMITVEL",
    "TENDONLIMITVEL",
    "ACCELEROMETER", "FRAMELINACC", "FRAMEANGACC", "FORCE", "TORQUE", "ACTUATORFRC",
    "JOINTACTFRC", "TENDONACTFRC", "JOINTLIMITFRC", "TENDONLIMITFRC", "TOUCH",
    "E_POTENTIAL", "E_KINETIC", "GEOMDIST", "GEOMNORMAL", "GEOMFROMTO", "CAMPROJECTION",
    "CONTACT",
))
GEOMDIST_SENSORS = frozenset((SensorType.GEOMDIST, SensorType.GEOMNORMAL, SensorType.GEOMFROMTO))


def has_fluid(o) -> bool:
  """Whether the options ``o`` (an MjOption or a snapshot's) set a medium:
  density, viscosity or wind (mjtpu's has_fluid_params)."""
  return bool(o.density > 0 or o.viscosity > 0 or np.any(np.asarray(o.wind)))


def has_tendon_fields(ns) -> bool:
  """Whether a snapshot of ``ns`` stores TENDON_FIELDS: it has a tendon."""
  return int(ns.ntendon) > 0


def has_act_fields(ns) -> bool:
  """Whether a snapshot of ``ns`` stores ACT_FIELDS: it has an activation
  state, a muscle gain or bias, or a slider-crank transmission."""
  return bool(int(ns.na) > 0
              or np.any(np.asarray(ns.actuator_gaintype) == GainType.MUSCLE)
              or np.any(np.asarray(ns.actuator_biastype) == BiasType.MUSCLE)
              or np.any(np.asarray(ns.actuator_trntype) == TrnType.SLIDERCRANK))


def has_eq_fields(ns) -> bool:
  """Whether a snapshot of ``ns`` stores EQ_FIELDS: it has an equality
  constraint."""
  return int(ns.neq) > 0


def has_mocap_fields(ns) -> bool:
  """Whether a snapshot of ``ns`` stores MOCAP_FIELDS: it has a mocap
  body."""
  return int(ns.nmocap) > 0


def has_render_fields(ns) -> bool:
  """Whether a snapshot of ``ns`` stores RENDER_FIELDS: it has a camera."""
  return int(ns.ncam) > 0


def render_field(ns, name: str):
  """``ns``'s value of a RENDER_FIELDS entry, all lights active where the
  MjModel predates light_active (mjtpu's io.py falls back the same way)."""
  if name == "light_active" and not hasattr(ns, name):
    return np.ones(int(ns.nlight), dtype=bool)
  return field(ns, name)


def _has_sensor(ns, types) -> bool:
  return bool(np.isin(np.asarray(ns.sensor_type), [int(t) for t in types]).any())


# each optional field group and whether a snapshot of ``ns`` stores it
OPTIONAL_GROUPS = (
    (TENDON_FIELDS, has_tendon_fields), (ACT_FIELDS, has_act_fields),
    (EQ_FIELDS, has_eq_fields), (MOCAP_FIELDS, has_mocap_fields),
    (LIGHT_FIELDS, lambda ns: int(ns.nlight) > 0),
    (CONTACT_SENSOR_FIELDS, lambda ns: _has_sensor(ns, (SensorType.CONTACT,))),
    (CAMPROJ_FIELDS, lambda ns: _has_sensor(ns, (SensorType.CAMPROJECTION,))),
    (GEOMDIST_FIELDS, lambda ns: _has_sensor(ns, GEOMDIST_SENSORS)),
    (RENDER_FIELDS, has_render_fields),
)


def _optional_field(ns, name: str, spec, stored: bool):
  """A field of OPTIONAL_GROUPS: ns's where a snapshot stores it, else its
  fill at the model's row count, so a live MjModel and its snapshot give
  the same Model."""
  fill, shape, dtype = spec
  if stored:
    return np.array(render_field(ns, name), dtype=dtype)
  if shape is None:
    return np.array(fill, dtype=dtype)
  # no tendon, wrap, equality, material or texture where the field is left out
  rows = {"actuator": int(ns.nu), "body": int(ns.nbody), "sensor": int(ns.nsensor),
          "cam": int(ns.ncam), "geom": int(ns.ngeom),
          "light": int(ns.nlight)}.get(name.split("_")[0], 0)
  return np.full((rows,) + shape, fill, dtype=dtype)


def snapshot_arrays(mjm, mesh_convex: tuple | None = None,
                    geom_convex: tuple | None = None) -> dict[str, np.ndarray]:
  """Every attribute model_from_arrays reads from ``mjm`` (an MjModel or
  any object with its attribute names), with the hull tables
  ``mesh_convex`` (default: mesh.get(mjm)) and ``geom_convex`` (default:
  mesh.get_geoms(mjm)), as a snapshot's arrays."""
  arrays = {}
  extra = ((FRICTION_FIELDS if np.any(np.asarray(mjm.dof_frictionloss) > 0) else ())
           + (FLUID_FIELDS if has_fluid(mjm.opt) else ())
           + (GRAVCOMP_FIELDS if np.any(np.asarray(mjm.body_gravcomp) > 0) else ())
           + (OVERRIDE_FIELDS if int(mjm.opt.enableflags) & EnableBit.OVERRIDE else ())
           + tuple(name for group, stored in OPTIONAL_GROUPS if stored(mjm) for name in group))
  for name in SNAPSHOT_FIELDS + extra:
    v = render_field(mjm, name) if name in RENDER_FIELDS else field(mjm, name)
    if name == "names":
      v = np.frombuffer(bytes(v), dtype=np.uint8)
    arrays[name] = np.array(v)
  tables = (mesh.get(mjm) if mesh_convex is None else mesh_convex,
            mesh.get_geoms(mjm) if geom_convex is None else geom_convex)
  for prefix, hulls in zip(HULL_PREFIXES, tables):
    for i, hull in enumerate(hulls):
      if hull is not None:
        for f in HULL_FIELDS:
          arrays[f"{prefix}{i}.{f}"] = np.asarray(getattr(hull, f))
  return arrays


def save_snapshot(mjm, path, mesh_convex: tuple | None = None,
                  geom_convex: tuple | None = None) -> None:
  """Writes snapshot_arrays(mjm, mesh_convex, geom_convex) to an .npz."""
  np.savez_compressed(path, **snapshot_arrays(mjm, mesh_convex, geom_convex))


def save_snapshot_bundle(path, snapshots: dict[str, dict[str, np.ndarray]]) -> None:
  """Writes several small models' snapshots (name -> snapshot_arrays) to
  one .npz: each model's arrays packed into one byte buffer, under its
  name, with an index of (field, dtype, shape, offset) under
  "<name>.index", so the file holds two entries a model, not two hundred."""
  out = {}
  for name, arrays in snapshots.items():
    index, blobs, offset = [], [], 0
    for k in sorted(arrays):
      v = np.array(arrays[k], order="C")  # (ascontiguousarray makes a 0-d array 1-d)
      index.append([k, v.dtype.str, list(v.shape), offset])
      blobs.append(v.tobytes())
      offset += v.nbytes
    out[name] = np.frombuffer(b"".join(blobs), dtype=np.uint8)
    out[f"{name}.index"] = np.frombuffer(json.dumps(index).encode(), dtype=np.uint8)
  np.savez_compressed(path, **out)


def _bundle_arrays(z, name: str) -> dict[str, np.ndarray]:
  blob = z[name].tobytes()
  out = {}
  for k, dtype, shape, offset in json.loads(z[f"{name}.index"].tobytes()):
    dt = np.dtype(dtype)
    count = int(np.prod(shape, dtype=np.int64))
    out[k] = np.frombuffer(blob, dtype=dt, count=count, offset=offset).reshape(shape).copy()
  return out


def bundle_names(path) -> list[str]:
  """The models of a snapshot bundle (save_snapshot_bundle)."""
  with np.load(path) as z:
    return sorted(k for k in z.files if not k.endswith(".index"))


def load_snapshot(path, name: str | None = None) -> types.SimpleNamespace:
  """Reads a snapshot written by save_snapshot (or, with ``name``, model
  ``name`` of a bundle written by save_snapshot_bundle) back into an
  object with MjModel's attribute names (``opt.*`` and ``stat.*``
  nested)."""
  ns = types.SimpleNamespace(opt=types.SimpleNamespace(), stat=types.SimpleNamespace())
  hulls: dict[str, dict[int, dict]] = {p: {} for p in HULL_PREFIXES}
  with np.load(path) as z:
    arrays = {k: z[k] for k in z.files} if name is None else _bundle_arrays(z, name)
  for key, v in arrays.items():
    prefix = next((p for p in HULL_PREFIXES if key.startswith(p)), None)
    if prefix is not None:
      i, f = key[len(prefix):].split(".")
      hulls[prefix].setdefault(int(i), {})[f] = v
      continue
    if key == "names":
      v = v.astype(np.uint8).tobytes()
    elif v.ndim == 0:
      v = v.item()
    *parents, leaf = key.split(".")
    setattr(field(ns, ".".join(parents)) if parents else ns, leaf, v)
  per = lambda prefix, n: tuple(
      ConvexMesh(**hulls[prefix][i]) if i in hulls[prefix] else None for i in range(n))
  ns.mesh_convex = per("hull.", ns.nmesh)
  ns.geom_convex = per("geomhull.", ns.ngeom)
  return ns


def procedural_terrain(mjm, seed: int = 0) -> None:
  """Fills every hfield of ``mjm`` with deterministic sinusoidal bumps,
  flat near the origin so models spawn on level ground (numpy copy of
  mjtpu.procedural_terrain; MJCF cannot inline elevation data, so terrain
  assets ship flat).  The seed is reserved for randomized variants."""
  del seed
  for h in range(mjm.nhfield):
    nrow, ncol = int(mjm.hfield_nrow[h]), int(mjm.hfield_ncol[h])
    adr = int(mjm.hfield_adr[h])
    rx, ry = mjm.hfield_size[h, 0], mjm.hfield_size[h, 1]
    x = np.linspace(-rx, rx, ncol)[None, :]
    y = np.linspace(-ry, ry, nrow)[:, None]
    bumps = 0.5 * (1.0 + np.sin(1.7 * x) * np.sin(1.3 * y))
    r = np.sqrt(x * x + y * y)
    ramp = np.clip((r - 2.0) / 3.0, 0.0, 1.0)
    mjm.hfield_data[adr : adr + nrow * ncol] = (bumps * ramp).reshape(-1)


def _validate(ns) -> None:
  """Refuses models outside the slice (NotImplementedError names the
  feature)."""
  o = ns.opt

  def refuse(cond, what):
    if cond:
      raise NotImplementedError(f"mjtpu_torch does not support {what} yet")

  refuse(ns.nflex, "flex objects")
  names = {int(s): s.name for s in SensorType}
  for t in sorted(set(int(t) for t in np.asarray(ns.sensor_type))):
    refuse(t not in SENSORS_PORTED, f"{names.get(t, f'type {t}')} sensors")
  eq_type = np.asarray(getattr(ns, "eq_type", ()))
  for t in sorted(set(int(t) for t in eq_type) - {int(e) for e in EqType}):
    refuse(True, f"equality constraint type {t}")
  refuse(int(o.solver) not in (SolverType.CG, SolverType.NEWTON),
         f"solver {int(o.solver)} (only CG and Newton)")
  refuse(int(o.integrator) not in (IntegratorType.EULER, IntegratorType.IMPLICITFAST,
                                   IntegratorType.IMPLICIT, IntegratorType.RK4),
         f"integrator {int(o.integrator)}")
  # every enable flag MuJoCo has runs as in mjtpu: OVERRIDE and FWDINV
  # are carried and read nowhere (OVERRIDE: ROADMAP C17)
  flags = int(o.enableflags)
  refuse(flags & ~sum(EnableBit), f"enable flags {flags & ~sum(EnableBit):#x}")


def _device(device) -> torch.device:
  """The entry points' device: cuda unless the caller names another."""
  device = torch.device(device)
  if device.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError(
        f"mjtpu_torch builds on device={str(device)!r} by default, and this machine has no"
        " CUDA device: pass device=\"cpu\" to run on the CPU")
  return device


def model_from_arrays(ns, dtype: torch.dtype = torch.float64, device="cuda") -> Model:
  """Builds the port's Model from ``ns``, any object with MjModel's
  attribute names (an MjModel, or load_snapshot's namespace), on
  ``device`` (cuda unless the caller names another)."""
  _validate(ns)
  device = _device(device)
  f = lambda x: torch.as_tensor(np.array(x, dtype=np.float64), dtype=dtype, device=device)
  o = ns.opt

  model_fields = {fl.name for fl in dataclasses.fields(Model)}
  fields: dict = {n: int(getattr(ns, n)) for n in SIZE_FIELDS if n in model_fields}
  fields["opt"] = Option(
      timestep=f(o.timestep), impratio=f(o.impratio), tolerance=f(o.tolerance),
      ls_tolerance=f(o.ls_tolerance), gravity=f(o.gravity), wind=f(o.wind),
      magnetic=f(o.magnetic),
      density=f(o.density), viscosity=f(o.viscosity),
      integrator=IntegratorType(int(o.integrator)), cone=ConeType(int(o.cone)),
      solver=SolverType(int(o.solver)), iterations=int(o.iterations),
      ls_iterations=int(o.ls_iterations), disableflags=int(o.disableflags),
      enableflags=int(o.enableflags), has_fluid_params=has_fluid(o),
      # the contact overrides of EnableBit.OVERRIDE, carried as mjtpu
      # carries them (a snapshot stores them where the flag is on)
      o_margin=f(getattr(o, "o_margin", 0.0)),
      o_solref=f(getattr(o, "o_solref", O_SOLREF)),
      o_solimp=f(getattr(o, "o_solimp", O_SOLIMP)),
  )
  fields["stat"] = Statistic(meaninertia=f(ns.stat.meaninertia))
  for name in STATIC_FIELDS:
    fields[name] = np.array(getattr(ns, name))
  for name in FLOAT_FIELDS:
    fields[name] = f(getattr(ns, name))
  names = ns.names
  fields["names"] = names.tobytes() if isinstance(names, np.ndarray) else bytes(names)

  jnt_range, jnt_margin = np.asarray(ns.jnt_range), np.asarray(ns.jnt_margin)
  fields["jnt_limit_two_sided"] = jnt_range[:, 1] - jnt_range[:, 0] < 2 * jnt_margin
  fields["has_jnt_spring"] = bool(np.any(np.asarray(ns.jnt_stiffness) > 0))
  fields["has_dof_damping"] = bool(np.any(np.asarray(ns.dof_damping) > 0))
  fields["has_gravcomp"] = bool(np.any(np.asarray(ns.body_gravcomp) > 0))
  # zeros where a snapshot does not store them (FLUID_FIELDS, GRAVCOMP_FIELDS)
  fields["jnt_actgravcomp"] = np.array(getattr(ns, "jnt_actgravcomp", np.zeros(ns.njnt)),
                                       dtype=bool)
  geom_fluid = np.array(getattr(ns, "geom_fluid", np.zeros((ns.ngeom, NFLUID))), dtype=np.float64)
  fields["geom_fluid"], fields["geom_fluid_np"] = f(geom_fluid), geom_fluid
  fields["friction_dofid"] = fid = np.nonzero(np.asarray(ns.dof_frictionloss) > 0)[0]
  for name, width in zip(FRICTION_FIELDS, (NREF, NIMP)):
    # only the friction dofs' rows are read (a snapshot stores them only then)
    vals = np.zeros((ns.nv, width))
    vals[fid] = np.asarray(getattr(ns, name))[fid] if len(fid) else 0.0
    fields[name] = f(vals)
  fields["geom_rbound_np"] = np.array(ns.geom_rbound, dtype=np.float64)
  fields["geom_size_np"] = np.array(ns.geom_size, dtype=np.float64)
  # a snapshot carries the hull tables it was written with (mesh.py)
  fields["mesh_convex"] = ns.mesh_convex if hasattr(ns, "mesh_convex") else mesh.get(ns)
  fields["geom_convex"] = ns.geom_convex if hasattr(ns, "geom_convex") else mesh.get_geoms(ns)

  # a snapshot written before it kept the render fields holds fills there
  # (render.precompute_render_data refuses such a model by their names)
  fields["render_filled"] = frozenset(
      name for name in RENDER_FIELDS if not (has_render_fields(ns) and (
          name == "light_active" or hasattr(ns, name))))
  opt_np = {name: _optional_field(ns, name, spec, stored(ns) and name not in fields[
      "render_filled"]) for group, stored in OPTIONAL_GROUPS for name, spec in group.items()}
  for name, v in opt_np.items():
    fields[name] = v if name in _HOST_FIELDS else f(v)
  fields["nwrap"] = int(opt_np["nwrap"])
  ten_range = opt_np["tendon_range"]
  fields["tendon_limit_two_sided"] = ten_range[:, 1] - ten_range[:, 0] < 2 * opt_np["tendon_margin"]
  fields["friction_tenid"] = np.nonzero(opt_np["tendon_frictionloss"] > 0)[0]
  for flag, name in (("has_tendon_spring", "tendon_stiffness"),
                     ("has_tendon_damping", "tendon_damping"),
                     ("has_tendon_armature", "tendon_armature")):
    fields[flag] = bool(np.any(opt_np[name] > 0))

  # where every transmission is a scalar joint the moment matrix is model
  # constant: the row of actuator u is gear[u, 0] at its joint's dof
  fields["actuator_static_moment"] = None
  trn = np.asarray(ns.actuator_trntype)
  jid = np.where(np.isin(trn, (TrnType.JOINT, TrnType.JOINTINPARENT)),
                 np.asarray(ns.actuator_trnid)[:, 0] if ns.nu else 0, -1)
  scalar = (jid >= 0) & np.isin(np.asarray(ns.jnt_type)[np.maximum(jid, 0)],
                                (JointType.SLIDE, JointType.HINGE))
  if scalar.all():
    sm = np.zeros((ns.nu, ns.nv))
    if ns.nu:
      sm[np.arange(ns.nu), np.asarray(ns.jnt_dofadr)[jid]] = np.asarray(ns.actuator_gear)[:, 0]
    fields["actuator_static_moment"] = f(sm)

  m = Model(**fields)
  from mjtpu_torch._src import collision_driver

  # refuse a geom pair without a collider up front (candidate_groups)
  collision_driver.make_condim(m)
  # mjtpu's ray has no height-field intersector either
  from mjtpu_torch._src import ray

  rf = np.asarray(m.sensor_type) == SensorType.RANGEFINDER
  sites = np.asarray(m.sensor_objid)[rf]
  for b in set(int(b) for b in np.asarray(m.site_bodyid)[sites]):
    if np.any(np.asarray(m.geom_type)[ray.candidate_geoms(m, None, True, b)] == GeomType.HFIELD):
      raise NotImplementedError("mjtpu_torch does not support rangefinders over height fields")
  return m


def put_model(mjm, dtype: torch.dtype = torch.float64, device="cuda") -> Model:
  """Converts an MjModel into the port's Model (cuda unless the caller
  names another device)."""
  return model_from_arrays(mjm, dtype=dtype, device=device)


device_put = put_model


def make_data(m: Model, batch_size: int = 1) -> Data:
  """Allocates a batched Data (B = batch_size) with every env at qpos0."""
  from mjtpu_torch._src import collision_driver, tendon_wrap

  B, dtype, device = batch_size, m.dtype, m.device
  nwrap = tendon_wrap.n_wrap_geoms(m)
  ne, nf, nl, ncon, nefc = support.constraint_sizes(m)
  zero = lambda *shape: torch.zeros((B,) + shape, dtype=dtype, device=device)
  eye3 = lambda n: torch.eye(3, dtype=dtype, device=device).expand(B, n, 3, 3).clone()
  nbody, njnt, nv = m.nbody, m.njnt, m.nv

  contact = Contact.zero(B, ncon, dtype, device)
  if ncon:
    contact.dim[:] = torch.as_tensor(collision_driver.make_condim(m), device=device)
    contact.efc_address[:] = torch.as_tensor(
        collision_driver.contact_efc_address(m, ne, nf, nl), device=device)
  xquat = zero(nbody, 4)
  xquat[..., 0] = 1.0
  # the mocap bodies' frames start at the model's body frames (mj_makeData)
  mid = np.asarray(m.body_mocapid)
  mocap_body = np.zeros(m.nmocap, dtype=np.int64)
  mocap_body[mid[mid >= 0]] = np.nonzero(mid >= 0)[0]
  per_env = lambda x: x[None].expand((B,) + x.shape).clone()

  return Data(
      time=zero(), qpos=m.qpos0.expand(B, m.nq).clone(), qvel=zero(nv), act=zero(m.na),
      qacc_warmstart=zero(nv), ctrl=zero(m.nu), qfrc_applied=zero(nv),
      xfrc_applied=zero(nbody, 6),
      eq_active=per_env(torch.as_tensor(np.asarray(m.eq_active0, dtype=bool), device=device)),
      # each env's own body frame where randomize gave the field rows
      mocap_pos=env_expand(env_rows(m, "body_pos")[:, mocap_body], B).clone(),
      mocap_quat=env_expand(env_rows(m, "body_quat")[:, mocap_body], B).clone(),
      qacc=zero(nv), act_dot=zero(m.na),
      xpos=zero(nbody, 3), xquat=xquat, xmat=eye3(nbody), xipos=zero(nbody, 3),
      ximat=eye3(nbody), xanchor=zero(njnt, 3), xaxis=zero(njnt, 3),
      geom_xpos=zero(m.ngeom, 3), geom_xmat=eye3(m.ngeom),
      site_xpos=zero(m.nsite, 3), site_xmat=eye3(m.nsite),
      cam_xpos=zero(m.ncam, 3), cam_xmat=eye3(m.ncam),
      light_xpos=zero(m.nlight, 3), light_xdir=zero(m.nlight, 3),
      subtree_com=zero(nbody, 3), cdof=zero(nv, 6), cinert=zero(nbody, 10),
      ten_length=zero(m.ntendon), ten_J=zero(m.ntendon, nv), ten_velocity=zero(m.ntendon),
      ten_wrap_xpos=zero(nwrap, 2, 3),
      ten_wrap_active=torch.zeros((B, nwrap), dtype=torch.bool, device=device),
      actuator_length=zero(m.nu), actuator_moment=zero(m.nu, nv),
      actuator_velocity=zero(m.nu), actuator_force=zero(m.nu),
      crb=zero(nbody, 10), qM=zero(nv, nv), qLD=zero(nv, nv), qLDiagInv=zero(nv),
      cvel=zero(nbody, 6), cdof_dot=zero(nv, 6), qfrc_bias=zero(nv),
      qfrc_spring=zero(nv), qfrc_damper=zero(nv), qfrc_gravcomp=zero(nv),
      qfrc_fluid=zero(nv), qfrc_passive=zero(nv),
      subtree_linvel=zero(nbody, 3), subtree_angmom=zero(nbody, 3),
      contact=contact, efc_J=zero(nefc, nv), efc_pos=zero(nefc),
      efc_margin=zero(nefc), efc_frictionloss=zero(nefc), efc_D=zero(nefc),
      efc_aref=zero(nefc), efc_force=zero(nefc), qfrc_actuator=zero(nv),
      qfrc_smooth=zero(nv), qacc_smooth=zero(nv), qfrc_constraint=zero(nv),
      qfrc_inverse=zero(nv), cacc=zero(nbody, 6), cfrc_int=zero(nbody, 6),
      cfrc_ext=zero(nbody, 6),
      sensordata=zero(m.nsensordata), energy=zero(2),
      solver_niter=torch.zeros(B, dtype=torch.int32, device=device),
      nreset=torch.zeros(B, dtype=torch.int32, device=device),
  )


_STATE_FIELDS = ("qpos", "qvel", "act", "qacc_warmstart", "ctrl", "qfrc_applied", "xfrc_applied",
                 "mocap_pos", "mocap_quat", "energy")


def put_data(m: Model, mjds) -> Data:
  """Copies the state of a list of MjData (one per env) into a fresh
  batched Data; derived quantities are filled by running the pipeline."""
  d = make_data(m, batch_size=len(mjds))
  changes = {"time": torch.as_tensor([float(x.time) for x in mjds], dtype=m.dtype,
                                     device=m.device)}
  for name in _STATE_FIELDS:
    val = np.stack([np.array(getattr(x, name), dtype=np.float64) for x in mjds])
    changes[name] = torch.as_tensor(val, dtype=m.dtype, device=m.device).reshape(
        getattr(d, name).shape)
  changes["eq_active"] = torch.as_tensor(
      np.stack([np.array(x.eq_active, dtype=bool) for x in mjds]), device=m.device).reshape(
          d.eq_active.shape)
  return dataclasses.replace(d, **changes)


def get_data_into(results, m: Model, d: Data, sort_contacts: bool = False) -> None:
  """Writes a batched Data into a list of MjData (one per env): state,
  kinematics, dynamics and forces, and, as mjtpu's get_data_into, the
  contacts and efc rows compacted to MuJoCo C's dynamic layout (each
  MjData's arena reallocated to the live counts).  ``sort_contacts``
  orders the contacts by (geom1, geom2) as mjtpu's does."""
  if len(results) != d.batch_size:
    raise ValueError(f"need {d.batch_size} MjData instances, got {len(results)}")
  for b, res in enumerate(results):
    for f in dataclasses.fields(Data):
      if f.name == "contact" or not hasattr(res, f.name):
        continue
      val = getattr(d, f.name)[b].detach().cpu().numpy().astype(np.float64)
      target = getattr(res, f.name)
      if not hasattr(target, "shape"):  # python scalars (time)
        setattr(res, f.name, float(val))
      elif target.size == val.size and f.name not in ("qM", "qLD"):
        target[...] = val.reshape(target.shape)
    _contacts_into(res, m, d, b, sort_contacts)


device_get_into = get_data_into


def _contacts_into(res, m: Model, d: Data, b: int, sort_contacts: bool) -> None:
  """Env b's contacts and live efc rows into the MjData ``res`` (mjtpu's
  write-back, io.py:434-543): a contact is kept where dist < margin + gap
  (exclude where dist >= includemargin), an efc row where it is live: an
  active equality's, every friction row, a limit row with a nonzero J row,
  the rows of a contact with dist < includemargin."""
  import mujoco

  np_ = lambda x: x[b].detach().cpu().numpy()
  con = d.contact
  ne_s, nf_s, nl_s, _, nefc_s = support.constraint_sizes(m)
  nc_start = ne_s + nf_s + nl_s
  dist, im, addr = np_(con.dist).astype(np.float64), np_(con.includemargin), np_(con.efc_address)
  dim, geom1, geom2 = np_(con.dim), np_(con.geom1), np_(con.geom2)
  active = np.nonzero(dist < np_(con.margin))[0]
  if sort_contacts and active.size:
    active = active[np.lexsort((dist[active], geom2[active], geom1[active]))]

  efc_J = np_(d.efc_J).astype(np.float64)
  live = np.zeros(nefc_s, bool)
  if nefc_s:
    live[:nc_start] = np.abs(efc_J[:nc_start]).max(axis=1) > 0
    if ne_s:
      live[:ne_s] = np.repeat(np_(d.eq_active).astype(bool),
                              [support.EQ_ROWS[int(t)] for t in m.eq_type])
    live[ne_s:ne_s + nf_s] = True
  pyramidal = m.opt.cone == ConeType.PYRAMIDAL
  rows_of = lambda dm: 1 if dm == 1 else (2 * (dm - 1) if pyramidal else dm)
  for i in range(len(dist)):
    if dist[i] < im[i]:
      live[addr[i]:addr[i] + rows_of(int(dim[i]))] = True
  new_index = np.cumsum(live) - 1
  nefc_live = int(live.sum())
  mujoco._functions._realloc_con_efc(res, ncon=len(active), nefc=nefc_live,
                                     nJ=nefc_live * m.nv)
  if active.size:
    c = res.contact
    c.exclude[:] = (dist[active] >= im[active]).astype(np.int32)
    c.dist[:] = dist[active]
    c.pos[:] = np_(con.pos)[active]
    c.frame[:] = np_(con.frame)[active].reshape(active.size, -1)
    c.includemargin[:] = im[active]
    c.friction[:] = np_(con.friction)[active]
    c.solref[:] = np_(con.solref)[active]
    c.solimp[:] = np_(con.solimp)[active]
    c.dim[:] = dim[active]
    c.geom1[:] = geom1[active]
    c.geom2[:] = geom2[active]
    c.geom[:] = np_(con.geom)[active]
    c.efc_address[:] = np.where(dist[active] < im[active], new_index[addr[active]], -1)
  if not nefc_live:
    return
  efc_type, efc_id = support.efc_row_meta(m)
  con_rows = efc_type >= int(ConstraintType.CONTACT_FRICTIONLESS)
  id_remap = np.full(len(dist), -1, np.int32)
  id_remap[active] = np.arange(len(active), dtype=np.int32)
  efc_id = efc_id.copy()
  efc_id[con_rows] = id_remap[efc_id[con_rows]]
  res.ne = int(live[:ne_s].sum())
  res.nf = int(live[ne_s:ne_s + nf_s].sum())
  res.nl = int(live[nc_start - nl_s:nc_start].sum())
  res.efc_type[:] = efc_type[live]
  res.efc_id[:] = efc_id[live]
  for name in ("efc_pos", "efc_margin", "efc_frictionloss", "efc_D", "efc_aref", "efc_force"):
    getattr(res, name)[:] = np_(getattr(d, name)).astype(np.float64)[live]
  res.efc_J[:] = efc_J[live].reshape(-1)
  res.efc_J_rownnz[:] = m.nv
  res.efc_J_rowadr[:] = np.arange(nefc_live) * m.nv
  res.efc_J_colind[:] = np.tile(np.arange(m.nv), nefc_live)


def _leaves(d: Data) -> list[torch.Tensor]:
  """Data's tensors in mjtpu's pytree leaf order: the fields in order,
  the Contact's in place (the two dataclasses list them alike)."""
  out = []
  for f in dataclasses.fields(d):
    v = getattr(d, f.name)
    out += _leaves(v) if dataclasses.is_dataclass(v) else [v]
  return out


def _rebuild(like, leaves) -> Data:
  changes = {}
  for f in dataclasses.fields(like):
    v = getattr(like, f.name)
    changes[f.name] = _rebuild(v, leaves) if dataclasses.is_dataclass(v) else next(leaves)
  return dataclasses.replace(like, **changes)


def save_checkpoint(path, d: Data) -> None:
  """Saves a batched Data to an .npz checkpoint, as mjtpu's
  save_checkpoint lays it out: leaf i of the Data under ``arr_i``."""
  np.savez(path, *[x.detach().cpu().numpy() for x in _leaves(d)])


def load_checkpoint(path, like: Data) -> Data:
  """Loads a checkpoint saved by save_checkpoint, or by mjtpu's for the
  same model, into the structure, dtypes and device of ``like`` (e.g.
  make_data(m, B)); an unbatched mjtpu checkpoint loads as one env."""
  leaves = _leaves(like)
  out = []
  with np.load(path) as z:
    if len(z.files) != len(leaves):
      raise ValueError(f"checkpoint holds {len(z.files)} arrays, Data has {len(leaves)}")
    for i, ref in enumerate(leaves):
      v = z[f"arr_{i}"]
      if v.ndim == ref.dim() - 1:
        v = v[None]
      if tuple(v.shape[1:]) != tuple(ref.shape[1:]):
        raise ValueError(f"checkpoint array {i} has shape {v.shape}, Data's is {tuple(ref.shape)}")
      out.append(torch.as_tensor(np.array(v), device=ref.device).to(ref.dtype))
  return _rebuild(like, iter(out))


def data_from_mjtpu(leaves, device="cuda") -> Data:
  """The port's Data from a batched mjtpu Data with numpy leaves (e.g.
  ``jax.tree.map(np.asarray, d)``), field by field by name, on ``device``
  (cuda unless the caller names another)."""
  device = _device(device)

  def conv(cls, src):
    out = {}
    for f in dataclasses.fields(cls):
      if f.name == "qfrc_inverse" and not hasattr(src, f.name):
        # goldens written before inverse dynamics came to the port
        v = np.zeros_like(np.asarray(src.qvel))
      else:
        v = getattr(src, f.name)
      out[f.name] = conv(Contact, v) if f.name == "contact" else torch.as_tensor(
          np.array(v), device=device)
    return cls(**out)

  return conv(Data, leaves)


def data_to_numpy(d: Data) -> types.SimpleNamespace:
  """Every field of ``d`` as a numpy array, under its name (the contact
  fields under ``.contact``), for comparing with mjtpu's Data."""

  def conv(obj):
    return types.SimpleNamespace(**{
        f.name: conv(getattr(obj, f.name)) if f.name == "contact"
        else getattr(obj, f.name).detach().cpu().numpy()
        for f in dataclasses.fields(obj)
    })

  return conv(d)

