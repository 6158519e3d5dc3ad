"""Ray-traced renderer (port of mjtpu/_src/render.py), batch-explicit.

One ray per pixel (ssaa^2 per pixel with supersampling), every env of a
batched Data at once: rays are (B, R) tensors with R = H W ssaa^2.  The
nearest hit runs mjtpu's static loop over the visible geoms as a running
minimum that keeps mjtpu's ``jnp.argmin`` pick (the lowest geom on a tie,
the first NaN before any number), so no (nvis, B, R) stack is held; the
winner's normal and albedo are then computed once per geom type from its
gathered pose and size, which gives the values mjtpu selects from its
stacks.  Shading follows mjtpu term for term: flat or Lambert + Phong,
the model's directional, point and spot lights with attenuation, cutoff,
exponent and per-light shadow rays, or mjtpu's fixed directional light;
fog, supersampling (seg takes the centre sample), 2d and cube textures on
planes, boxes and spheres, a cube or equirectangular skybox, and a
background colour.

``precompute_render_data`` reads the model on the host, as mjtpu's does,
and keeps the device tensors of the tables it builds (colours, mesh
triangles, texture images, the pixel grid of each image size) on the
RenderData, so a render copies nothing from the host.  Height fields have
no ray intersector, in mjtpu neither: a visible one is refused by name.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from mjtpu_torch._src import math
from mjtpu_torch._src import ray as ray_mod
from mjtpu_torch._src.dataclasses import map_tensors
from mjtpu_torch._src.types import Data, GeomType, Model, rows as env_rows

_DEFAULT_RGBA = np.array([0.5, 0.5, 0.5, 1.0])
_TEXROLE_RGB = 1  # mjtTextureRole: RGB
FOG_RGB = (0.8, 0.85, 0.9)
SKY_RGB = (0.55, 0.7, 0.9)
# the most bytes of ray temporaries one batch of envs may take; a larger
# batch renders in env chunks (a mesh's rays hold one entry per triangle)
_CHUNK_BYTES = 12 << 30


@dataclasses.dataclass(frozen=True)
class RenderData:
  """Static scene tables for the raytracer (host-side precompute), with
  their device tensors, built once per dtype and device."""

  geom_ids: tuple            # visible geom indices
  geom_types: tuple          # GeomType per visible geom
  mesh_tris: dict            # geom id -> (nface, 3, 3) local triangles (numpy)
  rgba: np.ndarray           # (nvis, 4)
  textures: dict = dataclasses.field(default_factory=dict)
  #   vis index k -> ((H, W, 3) float image, (2,) repeat, uniform flag, kind)
  sky_tex: Any = None        # (H, W, 3) float skybox image, or None
  geom_size: np.ndarray = None  # (ngeom, 3) host sizes (the box texture's)
  # (key, dtype, device) -> tensor: the device copies of the tables above
  # and of the pixel grids and constants a render uses
  tensors: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                    compare=False)

  def tensor(self, key, build, dtype, device) -> torch.Tensor:
    """The device tensor ``key`` at ``dtype``, built from the host array
    ``build()`` on first use."""
    k = (key, dtype, str(device))
    if k not in self.tensors:
      self.tensors[k] = torch.as_tensor(np.asarray(build()), device=device).to(dtype)
    return self.tensors[k]

  def const(self, values, dtype, device) -> torch.Tensor:
    return self.tensor(("const", tuple(values)), lambda: np.asarray(values, np.float64),
                       dtype, device)


def _decode_tex(m: Model, tid: int) -> np.ndarray:
  """Texture tid's pixels as (H, W, 3) float in [0, 1]."""
  h, w = int(m.tex_height[tid]), int(m.tex_width[tid])
  nc = int(m.tex_nchannel[tid])
  adr = int(m.tex_adr[tid])
  img = np.asarray(m.tex_data[adr : adr + h * w * nc], np.float32)
  img = img.reshape(h, w, nc) / 255.0
  if nc == 1:
    img = np.repeat(img, 3, axis=2)
  return img[:, :, :3]


# the renderer's own Model fields (colours and light terms): one Model
# value for every env, as mjtpu's render_batch vmaps over Data only
RENDER_MODEL_FIELDS = ("geom_rgba", "light_diffuse", "light_ambient", "light_specular",
                       "light_attenuation", "light_cutoff", "light_exponent")


def _refuse_env_rows(m: Model) -> None:
  """Raises NotImplementedError naming the RENDER_MODEL_FIELDS that ``m``
  holds one row per env of (parallel.randomize): mjtpu's renderer fails
  on such rows, or mixes the envs' light attenuations (ROADMAP C21)."""
  rows = sorted(set(RENDER_MODEL_FIELDS) & m.env_fields)
  if rows:
    raise NotImplementedError(
        f"mjtpu_torch cannot render a Model with one row per env of {', '.join(rows)}: the"
        " renderer draws every env with the Model's colours and lights, and mjtpu's"
        " render_batch, which maps over the Data only, cannot either")


def precompute_render_data(m: Model, geom_groups=None) -> RenderData:
  """Packs the visible geoms' colours, triangles and textures and the
  skybox (mjtpu's precompute_render_data), and puts their device tensors
  at the model's dtype on its device.  ``geom_groups``: six flags, the
  geom groups to draw (None: all)."""
  _refuse_env_rows(m)
  if m.render_filled:
    raise ValueError(
        "mjtpu_torch cannot render this model: its snapshot lacks the render fields "
        + ", ".join(sorted(m.render_filled))
        + " (a snapshot keeps them where the model has a camera)")
  ids, types, rgba = [], [], []
  tris, textures = {}, {}
  geom_rgba = m.geom_rgba.cpu().numpy()
  nmat = len(np.atleast_2d(m.mat_texid)) if np.size(m.mat_texid) else 0
  for g in range(m.ngeom):
    if geom_groups is not None:
      grp = min(max(int(m.geom_group[g]), 0), 5)
      if not geom_groups[grp]:
        continue
    t = int(m.geom_type[g])
    if t == GeomType.HFIELD:
      raise NotImplementedError(
          f"mjtpu_torch cannot render height fields (geom {g}): they have no ray intersector,"
          " in mjtpu neither")
    k = len(ids)
    ids.append(g)
    types.append(t)
    g_rgba = geom_rgba[g]
    mat = int(m.geom_matid[g])
    if mat >= 0 and nmat:
      if np.allclose(g_rgba, _DEFAULT_RGBA):  # material rgba unless overridden
        g_rgba = np.asarray(m.mat_rgba[mat], np.float64)
      tid = int(np.atleast_2d(m.mat_texid)[mat, _TEXROLE_RGB])
      if tid >= 0 and int(m.tex_type[tid]) in (0, 1):  # 2d + cube
        textures[k] = (
            _decode_tex(m, tid),
            np.asarray(m.mat_texrepeat[mat], np.float64),
            bool(np.atleast_1d(m.mat_texuniform)[mat]),
            "cube" if int(m.tex_type[tid]) == 1 else "2d",
        )
    rgba.append(g_rgba)
    if t == GeomType.MESH:
      mid = int(m.geom_dataid[g])
      fa, fn = int(m.mesh_faceadr[mid]), int(m.mesh_facenum[mid])
      va = int(m.mesh_vertadr[mid])
      faces = np.asarray(m.mesh_face)[fa : fa + fn]
      tris[g] = np.asarray(m.mesh_vert, np.float64)[va + faces]
  sky = None
  for tid in range(len(np.atleast_1d(m.tex_type))):
    if int(m.tex_type[tid]) == 2:  # skybox
      sky = _decode_tex(m, tid)
      break
  rd = RenderData(
      geom_ids=tuple(ids),
      geom_types=tuple(types),
      mesh_tris=tris,
      rgba=np.stack(rgba) if rgba else np.zeros((0, 4)),
      textures=textures,
      sky_tex=sky,
      geom_size=np.array(m.geom_size_np, np.float64),
  )
  _device_tables(rd, m.dtype, m.device)
  return rd


def _device_tables(rd: RenderData, dtype, device) -> dict:
  """The device tensors of rd's tables at ``dtype``: per visible geom its
  colour, per mesh geom its triangles' first vertices and unit normals
  (mjtpu's _hit_normal builds them from the same triangles), per textured
  geom its image and sampling constants, and the skybox."""
  def build():
    t = lambda x: torch.as_tensor(np.asarray(x), device=device).to(dtype)
    ints = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=device)
    tables = {"rgb": t(rd.rgba[:, :3]).reshape(-1, 3), "geom_ids": ints(rd.geom_ids),
              "types": ints(rd.geom_types),
              "mesh": {}, "tex": {}, "sky": None}
    for g, tri in rd.mesh_tris.items():
      tri = t(tri)
      a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
      n = math.cross(b - a, c - a)
      n = n / torch.clamp_min(torch.sqrt(math.dot3(n, n)), 1e-12)[:, None]
      tables["mesh"][g] = (tri, a, n)
    for k, (img, repeat, uniform, kind) in rd.textures.items():
      g = rd.geom_ids[k]
      size = rd.geom_size[g]
      if uniform:
        scale = repeat.copy()
      else:
        scale = repeat / np.where(size[:2] > 0, 2.0 * size[:2], 1.0)
      tables["tex"][k] = dict(img=t(img).reshape(-1, 3), h=img.shape[0], w=img.shape[1],
                              kind=kind, repeat=t(repeat), plane_scale=t(scale),
                              box_size=t(np.maximum(size, 1e-12)))
    if rd.sky_tex is not None:
      tables["sky"] = dict(img=t(rd.sky_tex).reshape(-1, 3), h=rd.sky_tex.shape[0],
                           w=rd.sky_tex.shape[1])
    return tables

  k = ("tables", dtype, str(device))
  if k not in rd.tensors:
    rd.tensors[k] = build()
  return rd.tensors[k]


# ---------------------------------------------------------------------------
# per-ray helpers: every argument (..., 3) or (...), broadcast over B and R
# ---------------------------------------------------------------------------


def _argmax3(a0, a1, a2) -> torch.Tensor:
  """jnp.argmax over three components: the first maximum, the first NaN
  before any number."""
  ax = torch.zeros_like(a0, dtype=torch.int64)
  best = a0
  for i, a in ((1, a1), (2, a2)):
    take = (a > best) | (torch.isnan(a) & ~torch.isnan(best))
    ax = torch.where(take, i, ax)
    best = torch.where(take, a, best)
  return ax


def _pick3(ax, a0, a1, a2):
  """stack([a0, a1, a2])[ax]."""
  return torch.where(ax == 0, a0, torch.where(ax == 1, a1, a2))


def _ipow(x: torch.Tensor, n: int) -> torch.Tensor:
  """x ** n for a Python int n by binary powering, in lax.integer_pow's
  order of products."""
  acc = None
  while n > 0:
    if n & 1:
      acc = x if acc is None else acc * x
    n >>= 1
    if n:
      x = x * x
  return acc


def nearest(best_t, best_k, t, k: int):
  """One step of the running minimum over geoms in ascending order: geom
  ``k``'s distances ``t`` replace the best where strictly nearer, or NaN
  where the best is not yet NaN, as ``jnp.argmin`` over the stack picks
  (the first minimum, the first NaN)."""
  if best_t is None:
    return t, torch.full_like(t, k, dtype=torch.int64)
  take = (t < best_t) | (torch.isnan(t) & ~torch.isnan(best_t))
  return torch.where(take, t, best_t), torch.where(take, k, best_k)


def _sample_tex(tex, u, v):
  """Nearest-neighbour wrap sample of tex's (H W, 3) image at uv in
  texture units: floor, then a positive mod."""
  h, w = tex["h"], tex["w"]
  ix = torch.remainder(torch.floor(u * w).to(torch.int64), w)
  iy = torch.remainder(torch.floor(v * h).to(torch.int64), h)
  return tex["img"][iy * w + ix]


def _sample_cube(tex, face, u, v):
  """Samples a cube texture: (6W, W, 3) stacked faces (MuJoCo order
  right/left/up/down/front/back) or one (W, W, 3) image on every face; u,
  v in [-1, 1] within the face, truncated toward zero, then clipped."""
  h, w = tex["h"], tex["w"]
  fi = torch.clamp(face, 0, h // w - 1)
  ix = torch.clamp((0.5 * (u + 1.0) * w).to(torch.int64), 0, w - 1)
  iy = torch.clamp((0.5 * (v + 1.0) * w).to(torch.int64), 0, w - 1)
  return tex["img"][(fi * w + iy) * w + ix]


def _unit(p):
  """p / max(1e-12, |p|) (mjtpu's jnp.linalg.norm guard)."""
  return p / torch.clamp_min(torch.sqrt(math.dot3(p, p)), 1e-12)[..., None]


def _cube_albedo(p, tex):
  """Cube-map albedo from the direction p (a local hit point, or a ray)."""
  d = _unit(p)
  a = torch.abs(d)
  ax = _argmax3(a[..., 0], a[..., 1], a[..., 2])
  mag = torch.clamp_min(_pick3(ax, a[..., 0], a[..., 1], a[..., 2]), 1e-12)
  # x-dom -> (y, z), faces right(0)/left(1); y-dom -> (x, z), front(4)/
  # back(5); z-dom -> (x, y), up(2)/down(3)
  u = _pick3(ax, d[..., 1], d[..., 0], d[..., 0]) / mag
  v = _pick3(ax, d[..., 2], d[..., 2], d[..., 1]) / mag
  face = _pick3(ax, torch.where(d[..., 0] > 0, 0, 1), torch.where(d[..., 1] > 0, 4, 5),
                torch.where(d[..., 2] > 0, 2, 3))
  return _sample_cube(tex, face, u, v)


def _tex_albedo(gtype: int, p, tex, base, two_pi, pi):
  """Albedo at local hit points p of a textured geom (mjtpu's
  _tex_albedo); ``base`` for the geom types without a mapping."""
  if tex["kind"] == "cube":
    return _cube_albedo(p, tex)
  if gtype == GeomType.PLANE:
    uv = p[..., :2] * tex["plane_scale"]
    return _sample_tex(tex, uv[..., 0], uv[..., 1])
  if gtype == GeomType.BOX:
    r = p / tex["box_size"]
    ax = _argmax3(*(torch.abs(r[..., i]) for i in range(3)))
    uv = torch.stack([_pick3(ax, r[..., 1], r[..., 0], r[..., 0]),
                      _pick3(ax, r[..., 2], r[..., 2], r[..., 1])], dim=-1)
    uv = uv * 0.5 * tex["repeat"]
    return _sample_tex(tex, uv[..., 0], uv[..., 1])
  if gtype == GeomType.SPHERE:
    d = _unit(p)
    u = torch.atan2(d[..., 1], d[..., 0]) / two_pi + 0.5
    v = torch.acos(torch.clamp(d[..., 2], -1.0, 1.0)) / pi
    uv = torch.stack([u, v], dim=-1) * tex["repeat"]
    return _sample_tex(tex, uv[..., 0], uv[..., 1])
  return base.expand(p.shape)


def _hit_normal(gtype: int, size, p, lv, mesh=None):
  """Surface normal (local frame) at the local hit points p."""
  if gtype == GeomType.SPHERE:
    return math.normalize(p)
  if gtype == GeomType.CAPSULE:
    z = torch.minimum(torch.maximum(p[..., 2], -size[..., 1]), size[..., 1])
    return math.normalize(torch.stack([p[..., 0], p[..., 1], p[..., 2] - z], dim=-1))
  if gtype == GeomType.ELLIPSOID:
    return math.normalize(p / (size * size))
  if gtype == GeomType.CYLINDER:
    side = math.normalize(torch.stack([p[..., 0], p[..., 1], torch.zeros_like(p[..., 2])], -1))
    zero = torch.zeros_like(p[..., 2])
    cap = torch.stack([zero, zero, torch.sign(p[..., 2])], dim=-1)
    on_cap = torch.abs(torch.abs(p[..., 2]) - size[..., 1]) < 1e-6
    return torch.where(on_cap[..., None], cap, side)
  if gtype == GeomType.BOX:
    r = p / size
    ax = _argmax3(*(torch.abs(r[..., i]) for i in range(3)))
    zero = torch.zeros_like(r[..., 0])
    return torch.stack([torch.where(ax == i, torch.sign(r[..., i]), zero) for i in range(3)], -1)
  if gtype == GeomType.MESH:
    # the triangle whose plane the hit point lies on (the nearest plane)
    _, a, n_tri = mesh
    d_plane = torch.abs(math.dot3(n_tri, p[..., None, :] - a))
    n = n_tri[torch.argmin(d_plane, dim=-1)]
    return n * torch.sign(-math.dot3(n, lv))[..., None]
  raise NotImplementedError(GeomType(gtype))


def _local(xmat, xpos, pnt, vec):
  """A ray (pnt, vec) in the frame (xpos, xmat): mat.T @ (pnt - pos) and
  mat.T @ vec."""
  return math.mat_t_vec(xmat, pnt - xpos), math.mat_t_vec(xmat, vec)


def _trace(m: Model, d: Data, rd: RenderData, pnt, vec, shade: bool = True):
  """Nearest hit along the rays (pnt, vec), pnt and vec (B, R or 1, 3):
  (t, vis index, world normal, albedo), the last two only with
  ``shade``, else None."""
  dtype, device = vec.dtype, vec.device
  size_all = env_rows(m, "geom_size")
  best_t = best_k = None
  for k, g in enumerate(rd.geom_ids):
    gtype = rd.geom_types[k]
    lp, lv = _local(d.geom_xmat[:, None, g], d.geom_xpos[:, None, g], pnt, vec)
    if gtype == GeomType.MESH:
      tri = _device_tables(rd, dtype, device)["mesh"][g][0]
      t = ray_mod._ray_triangles(tri, lp, lv)
    else:
      t = ray_mod._RAY_FUNC[GeomType(gtype)](size_all[:, None, g], lp, lv)
    best_t, best_k = nearest(best_t, best_k, t, k)
  if not shade:
    return best_t, best_k, None, None
  return best_t, best_k, *_shade_hit(m, d, rd, pnt, vec, best_t, best_k)


def _shade_hit(m: Model, d: Data, rd: RenderData, pnt, vec, t, k):
  """The winner's world normal and albedo at each ray's nearest hit (at
  t = 0 where the ray misses, as mjtpu evaluates them): the winner's pose
  and size gathered, each geom type's formula once over every ray."""
  dtype, device = vec.dtype, vec.device
  tables = _device_tables(rd, dtype, device)
  B, R = t.shape
  geom = tables["geom_ids"][k]                                    # (B, R)
  flat = lambda x: x.reshape(B, x.shape[1], -1)
  gather = lambda x: torch.gather(flat(x), 1, geom[..., None].expand(B, R, flat(x).shape[-1]))
  xmat = gather(d.geom_xmat).reshape(B, R, 3, 3)
  xpos = gather(d.geom_xpos)
  size = gather(env_rows(m, "geom_size").expand(B, -1, -1))
  lp, lv = _local(xmat, xpos, pnt, vec)
  t0 = torch.where(torch.isfinite(t), t, 0.0)
  p = lp + t0[..., None] * lv
  types = sorted(set(rd.geom_types))
  vtype = tables["types"][k] if len(types) > 1 else None
  normal = None
  for gtype in types:
    if gtype == GeomType.MESH:
      continue
    if gtype == GeomType.PLANE:
      n = xmat[..., :, 2]  # mat @ (0, 0, 1)
    else:
      n = math.mat_vec(xmat, _hit_normal(gtype, size, p, lv))
    normal = n if normal is None else torch.where((vtype == gtype)[..., None], n, normal)
  for vis, g in enumerate(rd.geom_ids):
    if rd.geom_types[vis] == GeomType.MESH:
      n = math.mat_vec(xmat, _hit_normal(GeomType.MESH, size, p, lv, tables["mesh"][g]))
      normal = n if normal is None else torch.where((k == vis)[..., None], n, normal)
  albedo = tables["rgb"][k]
  two_pi, pi = rd.const((2.0 * np.pi,), dtype, device), rd.const((np.pi,), dtype, device)
  for vis, tex in tables["tex"].items():
    a = _tex_albedo(rd.geom_types[vis], p, tex, tables["rgb"][vis], two_pi, pi)
    albedo = torch.where((k == vis)[..., None], a, albedo)
  return normal, albedo


def _shade_scene_lights(m, d, rd, n, p_hit, vec, albedo, shadows):
  """Per-light Lambert/Phong shading from the model's lights (mjtpu's
  _shade_scene_lights): directional, point and spot lights from
  d.light_xpos/light_xdir, ambient, diffuse and specular colours,
  distance attenuation, the spot's cutoff and exponent, per-light shadow
  rays (a shadowed point keeps its ambient term only)."""
  total = None
  active = np.atleast_1d(np.asarray(m.light_active)).astype(bool)
  for i in range(m.nlight):
    if not active[i]:
      continue
    ltype = int(m.light_type[i])
    att = spot = lit = None  # None: the factor 1
    if ltype == 1:  # mjLIGHT_DIRECTIONAL
      to_light = -math.normalize(d.light_xdir[:, i])[:, None]
      ldist = float("inf")
    else:  # spot / point / image
      raw = d.light_xpos[:, i, None] - p_hit
      ldist = math.norm3(raw)
      to_light = raw / torch.clamp_min(ldist, 1e-12)[..., None]
      a = m.light_attenuation[i]
      att = 1.0 / torch.clamp_min(a[0] + a[1] * ldist + a[2] * ldist * ldist, 1e-10)
    if ltype == 0:  # mjLIGHT_SPOT
      cos_cut = torch.cos(torch.deg2rad(m.light_cutoff[i]))
      sdir = math.normalize(d.light_xdir[:, i])[:, None]
      cos_ang = math.dot3(-to_light, sdir)
      spot = torch.where(cos_ang > cos_cut,
                         torch.pow(torch.clamp_min(cos_ang, 0.0), m.light_exponent[i]), 0.0)
    ndotl = torch.clamp_min(math.dot3(n, to_light), 0.0)
    diffuse = albedo * m.light_diffuse[i] * ndotl[..., None]
    reflect = math.normalize((2.0 * ndotl)[..., None] * n - to_light)
    spec = m.light_specular[i] * _ipow(torch.clamp_min(math.dot3(reflect, -vec), 0.0),
                                       50)[..., None]
    ambient = albedo * m.light_ambient[i]
    if shadows and bool(m.light_castshadow[i]):
      t_s = _trace(m, d, rd, p_hit + 1e-4 * n, to_light, shade=False)[0]
      occluded = torch.isfinite(t_s) & (t_s < ldist - 2e-4)
      lit = torch.where(occluded, torch.zeros_like(t_s), torch.ones_like(t_s))
    scale = None
    for f in (att, spot, lit):
      if f is not None:
        scale = f if scale is None else scale * f
    term = diffuse + spec if scale is None else (diffuse + spec) * scale[..., None]
    total = ambient + term if total is None else total + ambient + term
  return torch.zeros_like(albedo) if total is None else total


def _linspace(start: float, stop: float, num: int) -> np.ndarray:
  """jnp.linspace's grid on the host in float64: start (1 - step) + stop
  step, step = i / (num - 1), the last point ``stop``."""
  if num == 1:
    return np.array([start], np.float64)
  step = np.arange(num - 1, dtype=np.float64) / np.float64(num - 1)
  out = np.float64(start) * (1.0 - step) + np.float64(stop) * step
  return np.concatenate([out, [np.float64(stop)]])


def pixel_grid(fovy: float, width: int, height: int, ssaa: int) -> np.ndarray:
  """(H W ssaa^2, 3) ray directions in the camera frame (it looks along
  -z), rows of samples top to bottom, each left to right (mjtpu's grid)."""
  w, h = width * ssaa, height * ssaa
  tan_f = np.tan(np.radians(fovy) / 2.0)
  aspect = width / height
  ys = _linspace(tan_f, -tan_f, h)
  xs = _linspace(-tan_f * aspect, tan_f * aspect, w)
  px, py = np.meshgrid(xs, ys)
  return np.stack([px, py, -np.ones_like(px)], axis=-1).reshape(-1, 3)


def camera_rays(m: Model, d: Data, rd: RenderData, camera: int, width: int, height: int,
                ssaa: int) -> torch.Tensor:
  """(B, R, 3) unit world directions of every env's pixel rays from
  camera ``camera``; the grid is built on the host once per size."""
  fovy = float(m.cam_fovy[camera])
  base = rd.tensor(("grid", fovy, width, height, ssaa),
                   lambda: pixel_grid(fovy, width, height, ssaa), d.qpos.dtype, d.qpos.device)
  dirs = math.mat_vec(d.cam_xmat[:, None, camera], base)
  return dirs / torch.sqrt(math.dot3(dirs, dirs))[..., None]


def shade_rays(m: Model, d: Data, rd: RenderData, cam_pos, vec, light_dir=(0.3, -0.3, -0.9),
               shadows: bool = False, fog: float = 0.0, shading: str = "phong",
               scene_lights: bool | None = None, background: tuple | None = None):
  """rgb (B, R, 3), depth (B, R) and seg (B, R) int32 of the rays from
  cam_pos (B, 3) along vec (B, R, 3): render_rgbd's pixels before the
  supersampling's reduction."""
  dtype, device = vec.dtype, vec.device
  pnt = cam_pos[:, None]
  t, vis, n, albedo = _trace(m, d, rd, pnt, vec)
  hit = torch.isfinite(t)
  depth = torch.where(hit, t, -1.0)
  geom_ids = _device_tables(rd, dtype, device)["geom_ids"]
  seg = torch.where(hit, geom_ids[vis], -1).to(torch.int32)
  use_scene = scene_lights if scene_lights is not None else bool(m.nlight)
  if shading == "flat":
    color = albedo
  elif use_scene and m.nlight:
    p_hit = pnt + torch.where(hit, t, 0.0)[..., None] * vec
    color = _shade_scene_lights(m, d, rd, n, p_hit, vec, albedo, shadows)
  else:
    ldir = rd.tensor(("light_dir", tuple(light_dir)), lambda: np.asarray(light_dir, np.float64),
                     dtype, device)
    ldir = math.normalize(ldir)
    lambert = torch.clamp_min(math.dot3(n, -ldir), 0.0)
    refl = ldir - (2.0 * math.dot3(ldir, n))[..., None] * n
    spec = _ipow(torch.clamp_min(math.dot3(refl, -vec), 0.0), 16)
    diffuse = 0.65 * lambert
    if shadows:
      p_hit = pnt + t[..., None] * vec + 1e-4 * n
      t_s = _trace(m, d, rd, p_hit, (-ldir).expand(p_hit.shape[0], 1, 3), shade=False)[0]
      shadow = torch.where(torch.isfinite(t_s), torch.full_like(t_s, 0.4), torch.ones_like(t_s))
      diffuse, spec = diffuse * shadow, 0.3 * spec * shadow
    else:
      spec = 0.3 * spec
    color = albedo * (0.25 + diffuse)[..., None] + spec[..., None]
  if fog > 0:
    fog_w = torch.clamp(t * fog, 0.0, 1.0)[..., None]
    color = color * (1 - fog_w) + fog_w * rd.const(FOG_RGB, dtype, device)
  sky_tex = _device_tables(rd, dtype, device)["sky"]
  if background is not None:
    sky = rd.const(background, dtype, device)
  elif sky_tex is not None:
    sh, sw = sky_tex["h"], sky_tex["w"]
    if sh % sw == 0 and sh // sw in (1, 6):
      # MuJoCo cube layout: 6 stacked faces (or one square on all faces)
      sky = _cube_albedo(vec, sky_tex)
    else:
      two_pi, pi = rd.const((2.0 * np.pi,), dtype, device), rd.const((np.pi,), dtype, device)
      u = torch.atan2(vec[..., 1], vec[..., 0]) / two_pi + 0.5
      v = 0.5 - torch.asin(torch.clamp(vec[..., 2], -1.0, 1.0)) / pi
      sky = _sample_tex(sky_tex, u, v)
  else:
    sky = rd.const(SKY_RGB, dtype, device)
  rgb = torch.where(hit[..., None], torch.clamp(color, 0.0, 1.0), sky)
  return rgb, depth, seg


def _chunk(rd: RenderData, batch: int, rays: int, itemsize: int) -> int:
  """Envs a chunk of the batch renders at once: the ray temporaries of a
  chunk within _CHUNK_BYTES (about 64 numbers a ray, plus one a
  triangle of the largest mesh)."""
  tris = max((len(t) for t in rd.mesh_tris.values()), default=0)
  per_env = rays * itemsize * (64 + 8 * tris)
  return max(1, min(batch, _CHUNK_BYTES // per_env))


def render_rgbd(
    m: Model,
    d: Data,
    width: int = 64,
    height: int = 64,
    camera: int = 0,
    rd: RenderData | None = None,
    light_dir=(0.3, -0.3, -0.9),
    shadows: bool = False,
    fog: float = 0.0,
    ssaa: int = 1,
    shading: str = "phong",
    scene_lights: bool | None = None,
    background: tuple | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Renders every env of ``d`` from camera ``camera`` (mjtpu's
  render_rgbd, batched):

  * rgb: (B, H, W, 3) float in [0, 1]
  * depth: (B, H, W) float ray distance, -1 where no geom was hit
  * seg: (B, H, W) int32 geom id, -1 where no geom was hit

  shading: 'flat' (albedo only) or 'phong' (Lambert + specular).
  fog: linear fog coefficient (0 disables; never applied to misses).
  ssaa: supersampling factor (rgb and depth average the samples; seg
  takes the centre sample).  scene_lights: shade from the model's lights;
  by default on when the model has lights; False forces the fixed
  directional ``light_dir``.  background: an RGB triple in [0, 1] for the
  pixels that miss, overriding the skybox and the default sky.
  ``render_batch_rgbd`` is this function.
  """
  if not m.ncam:
    raise ValueError(
        "render() needs a <camera> in the model (indexing cam_xpos on a "
        "camera-less model would silently read garbage)"
    )
  _refuse_env_rows(m)
  rd = precompute_render_data(m) if rd is None else rd
  batch = d.qpos.shape[0]
  rays = width * height * ssaa * ssaa
  step = _chunk(rd, batch, rays, d.qpos.element_size())
  shade = dict(light_dir=light_dir, shadows=shadows, fog=fog, shading=shading,
               scene_lights=scene_lights, background=background)
  outs = []
  for b0 in range(0, batch, step):
    mc, dc = m, d
    if step < batch:  # an env chunk: the Data's rows, and the sizes' where per env
      dc = map_tensors(d, lambda x: x[b0:b0 + step])
      if "geom_size" in m.env_fields:
        mc = dataclasses.replace(m, geom_size=m.geom_size[b0:b0 + step])
    vec = camera_rays(mc, dc, rd, camera, width, height, ssaa)
    outs.append(shade_rays(mc, dc, rd, dc.cam_xpos[:, camera], vec, **shade))
  rgb, depth, seg = (torch.cat(x) if len(outs) > 1 else x[0] for x in zip(*outs))
  return reduce_samples(rgb, depth, seg, width, height, ssaa)


def reduce_samples(rgb, depth, seg, width: int, height: int, ssaa: int):
  """The (B, R) samples of render_rgbd's rays as (B, H, W) pixels: rgb and
  depth the mean of each pixel's ssaa^2 samples (summed in row-major
  order), seg its centre sample."""
  B = rgb.shape[0]
  rgb = rgb.reshape(B, height, ssaa, width, ssaa, 3)
  depth = depth.reshape(B, height, ssaa, width, ssaa)
  seg = seg.reshape(B, height, ssaa, width, ssaa)
  if ssaa > 1:
    n = ssaa * ssaa
    rgb = sum(rgb[:, :, i, :, j] for i in range(ssaa) for j in range(ssaa)) / n
    depth = sum(depth[:, :, i, :, j] for i in range(ssaa) for j in range(ssaa)) / n
  else:
    rgb, depth = rgb[:, :, 0, :, 0], depth[:, :, 0, :, 0]
  return rgb, depth, seg[:, :, ssaa // 2, :, ssaa // 2]


def render(m: Model, d: Data, **kwargs) -> torch.Tensor:
  """Renders (B, height, width, 3) RGB images (render_rgbd gives depth and
  segmentation beside them).  ``render_batch`` is this function: it
  renders every env of the batched Data already."""
  return render_rgbd(m, d, **kwargs)[0]


# mjtpu's batched names: the same functions, as the port's other batched
# names are
render_batch = render
render_batch_rgbd = render_rgbd
