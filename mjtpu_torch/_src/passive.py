"""Passive forces: joint and tendon springs and dampers, gravity
compensation, fluid.

Port of mjtpu/_src/passive.py (mj_passive): spring-dampers per joint type
and per tendon (the tendon spring's deadband);
body gravity compensation through the bodies' Jacobians; fluid forces by
the per-geom ellipsoid model for bodies with a fluidshape="ellipsoid"
geom and by the inertia-box model for every other body.  Each map runs
over all bodies or all fluid geoms at once, as (B, nbody) or (B, G)
tensors, so the launches do not grow with the model.
"""

from __future__ import annotations

import numpy as np
import torch

from mjtpu_torch._src import math, scan, support
from mjtpu_torch._src.dataclasses import replace
from mjtpu_torch._src.types import (Data, DisableBit, GeomType, JointType, Model, cached, index,
                                    rows as env_rows)


def _spring_damper(m: Model, d: Data) -> tuple[torch.Tensor, torch.Tensor]:
  """Joint springs (qfrc_spring) and dampers (qfrc_damper), each (B, nv)."""
  qfrc_spring = torch.zeros_like(d.qvel)

  if m.has_jnt_spring:

    def fn(jnt_types, stiffness, qpos, qpos_spring):
      out = []
      qi = 0
      for i, jt in enumerate(jnt_types):
        jt = JointType(int(jt))
        k = stiffness[..., i, None]
        if jt == JointType.FREE:
          out.append(-k * (qpos[..., qi : qi + 3] - qpos_spring[..., qi : qi + 3]))
          out.append(-k * math.quat_sub(qpos[..., qi + 3 : qi + 7], qpos_spring[..., qi + 3 : qi + 7]))
          qi += 7
        elif jt == JointType.BALL:
          out.append(-k * math.quat_sub(qpos[..., qi : qi + 4], qpos_spring[..., qi : qi + 4]))
          qi += 4
        else:
          out.append(-k * (qpos[..., qi : qi + 1] - qpos_spring[..., qi : qi + 1]))
          qi += 1
      if not out:
        return qpos.new_zeros(qpos.shape[:-1] + (0,))
      # broadcast the leading axes only: a slide's 1 column stays 1 beside
      # a ball's 3
      lead = torch.broadcast_shapes(*(o.shape[:-1] for o in out))
      return torch.cat([o.expand(lead + o.shape[-1:]) for o in out], dim=-1)

    spring = scan.flat(
        m, fn, "jjqq", "v",
        np.asarray(m.jnt_type), env_rows(m, "jnt_stiffness"), d.qpos, env_rows(m, "qpos_spring"),
    )
    if spring is not None:
      qfrc_spring = spring

  qfrc_damper = -env_rows(m, "dof_damping") * d.qvel

  # tendon springs (a deadband between the two spring lengths) and dampers
  if m.has_tendon_spring:
    lengthspring = env_rows(m, "tendon_lengthspring")
    lower, upper = lengthspring[..., 0], lengthspring[..., 1]
    length = d.ten_length
    displacement = torch.where(length > upper, upper - length,
                               torch.where(length < lower, lower - length, 0.0))
    qfrc_spring = qfrc_spring + _ten_force(d, env_rows(m, "tendon_stiffness") * displacement)
  if m.has_tendon_damping:
    qfrc_damper = qfrc_damper + _ten_force(d, -env_rows(m, "tendon_damping") * d.ten_velocity)
  return qfrc_spring, qfrc_damper


def _ten_force(d: Data, force: torch.Tensor) -> torch.Tensor:
  """ten_J^T force: (B, nv) generalized force of tendon forces (B, ntendon)."""
  return (d.ten_J.transpose(-1, -2) @ force[..., None])[..., 0]


def _gravcomp(m: Model, d: Data) -> torch.Tensor:
  """Gravity-compensation generalized force (B, nv): each body's
  -gravity * mass * gravcomp at its centre of mass."""
  force = (-env_rows(m, "opt.gravity")[:, None, :]
           * (env_rows(m, "body_mass") * env_rows(m, "body_gravcomp"))[..., None])  # (E, nbody, 3)
  return support.wrench_qfrc(m, d, d.xipos, force.expand(d.xipos.shape))


def _fluid_geoms(m: Model) -> np.ndarray:
  """Static ids of geoms with per-geom fluid coefficients (fluidshape=
  'ellipsoid'); geom_fluid[:, 0] is the compiler's interaction flag."""
  if m.geom_fluid_np is None or not m.ngeom:
    return np.zeros(0, dtype=int)
  return np.nonzero(m.geom_fluid_np[:, 0] != 0)[0]


def _geom_semiaxes(m: Model, gids: torch.Tensor, gtype: torch.Tensor) -> torch.Tensor:
  """(G, 3) ellipsoid semiaxes of the geoms ``gids`` of types ``gtype``
  (G, 1) (mj_geomSemiAxes): sphere (r,r,r), capsule (r,r,half_len+r),
  cylinder (r,r,half_len), ellipsoid/box = size."""
  size = env_rows(m, "geom_size")[:, gids]                  # (E, G, 3)
  r, h = size[..., 0], size[..., 1]
  out = torch.where(gtype == GeomType.SPHERE, torch.stack([r, r, r], dim=-1), size)
  out = torch.where(gtype == GeomType.CAPSULE, torch.stack([r, r, h + r], dim=-1), out)
  return torch.where(gtype == GeomType.CYLINDER, torch.stack([r, r, h], dim=-1), out)


def _cube(x: torch.Tensor) -> torch.Tensor:
  return x * (x * x)  # x**3 as XLA's integer power computes it


def _fourth(x: torch.Tensor) -> torch.Tensor:
  x2 = x * x
  return x2 * x2  # x**4 as XLA's integer power computes it


def _ellipsoid_index(m: Model) -> dict:
  """The fluid geoms' indices as device tensors: ids, types (G, 1), bodies
  and those bodies' ancestor masks and roots."""
  long = lambda x: torch.as_tensor(x, dtype=torch.long, device=m.device)
  geoms = _fluid_geoms(m)
  gbody = np.asarray(m.geom_bodyid)[geoms]
  return dict(
      gids=long(geoms), gtype=long(np.asarray(m.geom_type)[geoms])[:, None], gbody=long(gbody),
      bodies={"mask": support.dof_ancestor_mask_t(m)[long(gbody)],
              "rootid": long(np.asarray(m.body_rootid)[gbody])})


def _ellipsoid_tables(m: Model, ix: dict) -> dict:
  """_ellipsoid_index's tables with the fluid geoms' shape terms, from the
  traced sizes and coefficients, with the env axis of env_rows (E, G,
  ...)."""
  pi = torch.pi
  gids = ix["gids"]
  r = _geom_semiaxes(m, gids, ix["gtype"])
  rs = torch.sort(r, dim=-1).values
  r0, r1, r2 = r[..., 0], r[..., 1], r[..., 2]
  rmax_perp = torch.stack([torch.maximum(r1, r2), torch.maximum(r0, r2),
                           torch.maximum(r0, r1)], dim=-1)
  moi = (8.0 / 15.0) * pi * r * _fourth(rmax_perp)
  return dict(
      ix,
      d_eq=((2.0 / 3.0) * ((r0 + r1) + r2))[..., None],
      dd=torch.stack([r1 * r2, r0 * r2, r0 * r1], dim=-1),
      a_max=(pi * rs[..., 1] * rs[..., 2])[..., None],
      volume=((4.0 / 3.0) * pi * r0 * r1 * r2)[..., None],
      moi=moi,
      moi_max=((8.0 / 15.0) * pi * rs[..., 1] * _fourth(rs[..., 2]))[..., None],
      coef=env_rows(m, "geom_fluid")[:, gids],
  )


# ---------------------------------------------------------------------------
# the fluid models' tangents (the velocity derivative's fluid term, which
# mjtpu takes with jax.jacfwd) are written out, the product rule term by
# term; at ties they take jax's rules: max(x, y) at x == y splits the
# tangent in halves, a norm or a square root at 0 gives NaN, as does mjtpu's
# ---------------------------------------------------------------------------


def _max_jvp(x: torch.Tensor, floor, x_t: torch.Tensor) -> torch.Tensor:
  """The tangent of max(x, floor) (a constant floor) by jax's rule."""
  return torch.where(x > floor, x_t, torch.where(x == floor, 0.5 * x_t, 0.0))


def _sqrt_jvp(root: torch.Tensor, x_t: torch.Tensor) -> torch.Tensor:
  """The tangent of root = sqrt(x): x_t * (0.5 / root), NaN at 0 (jax's)."""
  return x_t * (0.5 / root)


def _ellipsoid_fluid_model(m: Model, d: Data, cvel_t: torch.Tensor | None = None) -> torch.Tensor:
  """Per-geom ellipsoid fluid model (mj_ellipsoidFluidModel), (B, nv):

    Kirchhoff added mass  F += p×ω,  T += p×v + h×ω
                          p = ρ·m_V∘v,  h = ρ·I_V∘ω      (virtual mass/inertia)
    Stokes (viscosity β)  F -= 3π d_eq β v,  T -= π d_eq³ β ω,  d_eq = ⅔Σrᵢ
    blunt drag            F -= C_B ρ A_proj ‖v‖ v
                          A_proj = π √(Σdᵢ⁴vᵢ² / Σdᵢ²vᵢ²),  dᵢ = rⱼrₖ
    slender drag          F -= C_S ρ (A_max − A_proj) ‖v‖ v,  A_max = π r_mid r_max
    Kutta lift            F += C_K ρ π √(Σdᵢ²vᵢ²/Σdᵢ⁴vᵢ²)/‖v‖ ((n×v)×v),
                          n = d²∘v
    Magnus lift           F += C_M ρ V (ω×v),  V = 4/3 π r₁r₂r₃
    angular drag          T -= ρ ω √(Σⱼ(Mⱼωⱼ)²),
                          Mⱼ = C_A·IIⱼ + C_S·(I_max−IIⱼ),
                          IIⱼ = 8/15 π rⱼ max(rₖ,rₗ)⁴,  I_max = 8/15 π r_mid r_max⁴

  all in the geom frame with v = linear velocity of the geom center minus
  wind, ω = angular velocity; every fluid geom of the batch at once.
  With ``cvel_t`` (B, nbody, 6), the forces' tangent along cvel_t
  instead."""
  ix = cached(m, "passive.ellipsoid_index", lambda: _ellipsoid_index(m))
  s = cached(m, "passive.ellipsoid", lambda: _ellipsoid_tables(m, ix), live=True)
  pi = torch.pi
  rho, beta = _medium(m)
  xpos, xmat = d.geom_xpos[:, s["gids"]], d.geom_xmat[:, s["gids"]]
  xmat_t = xmat.transpose(-1, -2)
  offset = xpos - d.subtree_com[:, s["bodies"]["rootid"]]
  lvel = math.transform_motion(d.cvel[:, s["gbody"]], offset, xmat_t)
  w = lvel[..., :3]
  v = lvel[..., 3:] - math.mat_vec(xmat_t, env_rows(m, "opt.wind")[:, None])
  coef = s["coef"]
  c_blunt, c_slender, c_ang, c_kutta, c_magnus = (coef[..., k, None] for k in range(1, 6))
  vmass, vinertia = coef[..., 6:9], coef[..., 9:12]

  p = rho * vmass * v  # Kirchhoff added-mass momentum coupling
  h = rho * vinertia * w
  stokes_v = 3.0 * pi * s["d_eq"] * beta  # Stokes resistance at the equivalent sphere
  stokes_w = pi * _cube(s["d_eq"]) * beta
  dd2, dd4 = s["dd"] * s["dd"], _fourth(s["dd"])
  s2 = torch.sum(dd2 * v * v, dim=-1, keepdim=True)
  s4 = torch.sum(dd4 * v * v, dim=-1, keepdim=True)
  vnorm = math.norm3(v)[..., None]
  den2, den4 = torch.clamp_min(s2, math.MINVAL), torch.clamp_min(s4, math.MINVAL)
  # the square roots through math.sqrt0: at rest (v or w zero) their
  # gradient is 0 where sqrt's is NaN (mjtpu's, ROADMAP C22); the values,
  # and the tangents _sqrt_jvp takes from them (NaN at rest, C15), keep
  # their bits
  a_proj = pi * math.sqrt0(s4 / den2)
  slender = s["a_max"] - a_proj
  drag = c_blunt * a_proj + c_slender * torch.clamp_min(slender, 0.0)
  n = dd2 * v
  root = math.sqrt0(s2 / den4)
  vn = torch.clamp_min(vnorm, math.MINVAL)
  kutta = pi * root / vn
  nxv = math.cross(n, v)
  lift = math.cross(nxv, v)
  mmix = c_ang * s["moi"] + c_slender * (s["moi_max"] - s["moi"])
  mw = mmix * w
  drag_w = math.sqrt0(torch.sum(mw * mw, dim=-1, keepdim=True))

  if cvel_t is None:
    frc = (math.cross(p, w) - stokes_v * v - rho * drag * vnorm * v
           + c_kutta * rho * kutta * lift + c_magnus * rho * s["volume"] * math.cross(w, v))
    trq = math.cross(p, v) + math.cross(h, w) - stokes_w * w - rho * w * drag_w
  else:
    lvel_t = math.transform_motion(cvel_t[:, s["gbody"]], offset, xmat_t)
    w_t, v_t = lvel_t[..., :3], lvel_t[..., 3:]
    p_t, h_t = rho * vmass * v_t, rho * vinertia * w_t
    s2_t = torch.sum(dd2 * (v_t * v + v * v_t), dim=-1, keepdim=True)
    s4_t = torch.sum(dd4 * (v_t * v + v * v_t), dim=-1, keepdim=True)
    vnorm_t = _sqrt_jvp(vnorm, math.dot3(v_t, v)[..., None] + math.dot3(v, v_t)[..., None])
    den2_t, den4_t = _max_jvp(s2, math.MINVAL, s2_t), _max_jvp(s4, math.MINVAL, s4_t)
    a_proj_t = pi * _sqrt_jvp(a_proj / pi, s4_t / den2 - s4 / den2 * den2_t / den2)
    drag_t = c_blunt * a_proj_t + c_slender * _max_jvp(slender, 0.0, -a_proj_t)
    root_t = _sqrt_jvp(root, s2_t / den4 - s2 / den4 * den4_t / den4)
    kutta_t = pi * root_t / vn - kutta / vn * _max_jvp(vnorm, math.MINVAL, vnorm_t)
    lift_t = math.cross(math.cross(dd2 * v_t, v) + math.cross(n, v_t), v) + math.cross(nxv, v_t)
    drag_w_t = _sqrt_jvp(drag_w, torch.sum(2.0 * mw * (mmix * w_t), dim=-1, keepdim=True))
    frc = (math.cross(p_t, w) + math.cross(p, w_t) - stokes_v * v_t
           - rho * (drag_t * vnorm * v + drag * vnorm_t * v + drag * vnorm * v_t)
           + c_kutta * rho * (kutta_t * lift + kutta * lift_t)
           + c_magnus * rho * s["volume"] * (math.cross(w_t, v) + math.cross(w, v_t)))
    trq = (math.cross(p_t, v) + math.cross(p, v_t) + math.cross(h_t, w) + math.cross(h, w_t)
           - stokes_w * w_t - rho * (w_t * drag_w + w * drag_w_t))
  return support.wrench_qfrc(m, d, xpos, math.mat_vec(xmat, frc), math.mat_vec(xmat, trq),
                             bodies=s["bodies"])


def _medium(m: Model) -> tuple[torch.Tensor, torch.Tensor]:
  """(density, viscosity), each (E, 1, 1): the env axis of env_rows over
  an entity axis and a vector axis."""
  return (env_rows(m, "opt.density")[:, None, None], env_rows(m, "opt.viscosity")[:, None, None])


def _box_bodies(m: Model) -> np.ndarray:
  """(nbody,) host bool: the bodies without a fluidshape="ellipsoid" geom,
  which take the inertia-box model."""
  use_box = np.ones(m.nbody, dtype=bool)
  use_box[np.asarray(m.geom_bodyid)[_fluid_geoms(m)]] = False
  return use_box


def _box_tables(m: Model, use_box: torch.Tensor) -> dict:
  """Each body's equivalent inertia box, its drag terms, and which bodies
  take the model (mass > 0 and, ``use_box`` (nbody,), no
  fluidshape="ellipsoid" geom): constants of the Model (E, nbody, ...)."""
  body_mass, inertia = env_rows(m, "body_mass"), env_rows(m, "body_inertia")  # (E, nbody, ...)
  mass = torch.clamp_min(body_mass, math.MINVAL)
  ix, iy, iz = inertia[..., 0], inertia[..., 1], inertia[..., 2]
  side = lambda a, b, c: torch.sqrt(torch.clamp_min((a + b - c) * 6.0 / mass, math.MINVAL))
  box = torch.stack([side(iy, iz, ix), side(iz, ix, iy), side(ix, iy, iz)], dim=-1)
  b0, b1, b2 = box[..., 0], box[..., 1], box[..., 2]
  keep = (body_mass > 0) & use_box
  return dict(
      diam=(((b0 + b1) + b2) / 3.0)[..., None],
      ang_scale=torch.stack([b0 * (_fourth(b1) + _fourth(b2)), b1 * (_fourth(b0) + _fourth(b2)),
                             b2 * (_fourth(b0) + _fourth(b1))], dim=-1) / 64.0,
      lin_area=torch.stack([b1 * b2, b0 * b2, b0 * b1], dim=-1),
      keep=keep[..., None].to(m.dtype),
  )


def _inertia_box_fluid_model(m: Model, d: Data,
                             cvel_t: torch.Tensor | None = None) -> torch.Tensor:
  """Fluid forces via the inertia-box approximation (mj_inertiaBoxFluidModel),
  (B, nv), over every body that has mass and no ellipsoid-model geom; with
  ``cvel_t`` (B, nbody, 6), their tangent along cvel_t instead: the
  quadratic drag c |x| x has the tangent c (sign(x) x_t x + |x| x_t),
  zero at x = 0 under torch's rule and jax's alike."""
  use_box = cached(m, "passive.box_bodies",
                   lambda: torch.as_tensor(_box_bodies(m), device=m.device))
  s = cached(m, "passive.box", lambda: _box_tables(m, use_box), live=True)
  pi = torch.pi
  ximat_t = d.ximat.transpose(-1, -2)
  # local 6D velocity at the inertial frame (rows of ximat^T = local axes),
  # wind in the local frame (linear only)
  offset = d.xipos - d.subtree_com[:, index(m, "body_rootid")]
  lvel = math.transform_motion(d.cvel, offset, ximat_t)
  lang = lvel[..., :3]
  llin = lvel[..., 3:] - math.mat_vec(ximat_t, env_rows(m, "opt.wind")[:, None])
  density, visc = _medium(m)
  diam = s["diam"]
  # viscous resistance, then quadratic drag
  visc_ang, visc_lin = -pi * _cube(diam) * visc, -3.0 * pi * diam * visc
  quad_ang, quad_lin = -density * s["ang_scale"], -0.5 * density * s["lin_area"]
  if cvel_t is None:
    ltrq = visc_ang * lang + quad_ang * torch.abs(lang) * lang
    lfrc = visc_lin * llin + quad_lin * torch.abs(llin) * llin
  else:
    lvel_t = math.transform_motion(cvel_t, offset, ximat_t)
    lang_t, llin_t = lvel_t[..., :3], lvel_t[..., 3:]
    quad = lambda c, x, x_t: c * torch.sign(x) * x_t * x + c * torch.abs(x) * x_t
    ltrq = visc_ang * lang_t + quad(quad_ang, lang, lang_t)
    lfrc = visc_lin * llin_t + quad(quad_lin, llin, llin_t)
  torque = math.mat_vec(d.ximat, ltrq) * s["keep"]
  force = math.mat_vec(d.ximat, lfrc) * s["keep"]
  return support.wrench_qfrc(m, d, d.xipos, force, torque)


def _fluid(m: Model, d: Data, cvel_t: torch.Tensor | None = None) -> torch.Tensor:
  """Fluid forces per body (mj_passive): bodies with any
  fluidshape='ellipsoid' geom take the per-geom ellipsoid model, every
  other body the inertia-box approximation; with ``cvel_t`` (B, nbody,
  6), their tangent along cvel_t."""
  if not len(_fluid_geoms(m)):
    return _inertia_box_fluid_model(m, d, cvel_t)
  qfrc = _ellipsoid_fluid_model(m, d, cvel_t)
  if _box_bodies(m)[1:].any():  # the world body never contributes
    qfrc = qfrc + _inertia_box_fluid_model(m, d, cvel_t)
  return qfrc


def actgrav_dofs(m: Model) -> torch.Tensor:
  """(nv,) bool: the dofs whose joint takes its gravity compensation
  through the actuators (jnt_actgravcomp)."""
  return cached(m, "passive.actgrav_dofs", lambda: torch.as_tensor(
      np.asarray(m.jnt_actgravcomp)[np.asarray(m.dof_jntid)], device=m.device))


def passive(m: Model, d: Data) -> Data:
  """Passive forces (mj_passive)."""
  zero = torch.zeros_like(d.qvel)
  if (m.opt.disableflags & DisableBit.PASSIVE) == DisableBit.PASSIVE:
    return replace(d, qfrc_spring=zero, qfrc_damper=zero, qfrc_gravcomp=zero,
                   qfrc_fluid=zero, qfrc_passive=zero)

  qfrc_spring, qfrc_damper = _spring_damper(m, d)
  if m.opt.disableflags & DisableBit.SPRING:
    qfrc_spring = zero
  if m.opt.disableflags & DisableBit.DAMPER:
    qfrc_damper = zero

  qfrc_gravcomp = zero
  if m.has_gravcomp and not (m.opt.disableflags & DisableBit.GRAVITY):
    qfrc_gravcomp = _gravcomp(m, d)

  qfrc_fluid = zero
  if m.opt.has_fluid_params:
    qfrc_fluid = _fluid(m, d)

  qfrc_passive = qfrc_spring + qfrc_damper + qfrc_fluid
  if m.has_gravcomp:
    # gravcomp routed through the actuators (jnt_actgravcomp) is added in
    # fwd_actuation
    qfrc_passive = qfrc_passive + torch.where(actgrav_dofs(m), 0.0, qfrc_gravcomp)
  return replace(d, qfrc_spring=qfrc_spring, qfrc_damper=qfrc_damper,
                 qfrc_gravcomp=qfrc_gravcomp, qfrc_fluid=qfrc_fluid,
                 qfrc_passive=qfrc_passive)
