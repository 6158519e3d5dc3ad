"""Spatial tendon wrap geometry (mju_wrap) and the spatial tendon pass.

Port of mjtpu/_src/tendon_wrap.py, batch-explicit: every wrap function
runs over (B, K) segments at once, K the segments of one static group.

  * ``wrap_circle2d``: the 2D circle wrap (C wrap_circle): the gate, the
    two closed-form tangent-point pairs, the score that picks one, the arc.
  * ``wrap_inside2d``: a sidesite strictly inside the object (C
    wrap_inside): Newton on f(z) = acos(c01) + asin(z r/d0) + asin(z r/d1)
    - 2 asin(z) from z0 = 0.9999999, a fixed loop of 19 masked updates per
    lane with no host check, the mid-point touch where it fails.
  * ``wrap``: mju_wrap in the geom's frame (sphere: the plane through both
    endpoints and the centre; cylinder: the xy plane, z interpolated along
    the in-plane path).
  * ``build_program`` and ``n_wrap_geoms``: the host-side decomposition of
    each spatial tendon into straight and wrap segments (numpy, cached on
    the Model).
  * ``spatial_tendon``: each segment's length and Jacobian row, summed
    into its tendon through a static gather table (scan.segment_sum; never
    a scatter-add, whose order on a CUDA device is not fixed).

Every choice between two branches is a ``torch.where``, never a multiply
by a mask, so a NaN of a degenerate branch that is not taken stays out of
the result; divisions are guarded as mjtpu guards them.
"""

from __future__ import annotations

import numpy as np
import torch

from mjtpu_torch._src import math, scan, support
from mjtpu_torch._src.types import Data, Model, WrapType, cached, rows as env_rows

_MINVAL = 1e-15
# f(z0) constant: 2*asin(0.9999999) (the C engine bakes this literal)
_TWO_ASIN_Z0 = 3.1406982263915753
_Z0 = 0.9999999
# the inside wrap's Newton steps and its tolerance on f
_NEWTON_STEPS = 19
_NEWTON_TOL = 1e-6


def _dot2(a, b):
  return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]


def _cross2(a, b):
  return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


# the wraps' square roots through math.sqrt0: a zero length (an endpoint
# on its circle, a wrap that does not wrap) has a zero gradient, where
# mjtpu's is NaN (ROADMAP C22); the values keep their bits


def _norm2(v):
  return math.sqrt0(_dot2(v, v))


def _norm3(v):
  return math.sqrt0(math.dot3(v, v))


def _safe_div(a, b):
  floor = torch.full_like(b, _MINVAL)
  return a / torch.where(torch.abs(b) < _MINVAL, torch.where(b < 0, -floor, floor), b)


def _stack2(x, y):
  return torch.stack([x, y], dim=-1)


def _segments_cross(e0, t0, e1, t1):
  """C's strict segment-intersection test between (e0,t0) and (e1,t1)."""
  d0 = t0 - e0
  d1 = t1 - e1
  det = _cross2(d0, d1)
  b = e1 - e0
  s = _safe_div(_cross2(b, d1), det)
  u = _safe_div(_cross2(b, d0), det)
  return (torch.abs(det) > _MINVAL) & (s >= 0) & (s <= 1) & (u >= 0) & (u <= 1)


def wrap_circle2d(e0, e1, r, sd, has_side: bool):
  """2D circle wrap (C wrap_circle) over any leading axes.

  e0, e1: (..., 2) endpoints; r: (...) radius; sd: (..., 2) sidesite
  direction point scaled to the circle (r * normalize(side2d)), ignored
  unless has_side.  Returns (wrapped, wlen, t0, t1); t0/t1 are zeros where
  not wrapped.
  """
  sqlen0 = _dot2(e0, e0)
  sqlen1 = _dot2(e1, e1)
  sqrad = r * r
  ok = (sqrad <= sqlen0) & (sqrad <= sqlen1) & (r >= _MINVAL)

  dif = e1 - e0
  dd = _dot2(dif, dif)
  ok = ok & (dd >= _MINVAL)
  a = torch.clamp(_safe_div(-_dot2(e0, dif), dd), 0.0, 1.0)
  pnt = e0 + a[..., None] * dif
  intersects = _dot2(pnt, pnt) <= sqrad
  if has_side:
    ok = ok & (intersects | (_dot2(sd, pnt) < 0))
  else:
    ok = ok & intersects

  sqrt0 = math.sqrt0(torch.clamp_min(sqlen0 - sqrad, 0.0))
  sqrt1 = math.sqrt0(torch.clamp_min(sqlen1 - sqrad, 0.0))
  den0 = torch.clamp_min(sqlen0, _MINVAL)
  den1 = torch.clamp_min(sqlen1, _MINVAL)

  def pair(sgn):
    t0 = _stack2((e0[..., 0] * sqrad + sgn * r * e0[..., 1] * sqrt0) / den0,
                 (e0[..., 1] * sqrad - sgn * r * e0[..., 0] * sqrt0) / den0)
    t1 = _stack2((e1[..., 0] * sqrad - sgn * r * e1[..., 1] * sqrt1) / den1,
                 (e1[..., 1] * sqrad + sgn * r * e1[..., 0] * sqrt1) / den1)
    return t0, t1

  p1t0, p1t1 = pair(1.0)
  p2t0, p2t1 = pair(-1.0)

  def score(t0, t1):
    crossed = _segments_cross(e0, t0, e1, t1)
    if has_side:
      mid = t0 + t1
      nm = _norm2(mid)
      # mju_normalize's degenerate fallback is the unit x vector
      s = torch.where(nm > _MINVAL, _dot2(mid, sd) / torch.clamp_min(nm, _MINVAL), sd[..., 0])
    else:
      dt = t0 - t1
      s = -_dot2(dt, dt)
    return torch.where(crossed, -10000.0, s)

  use2 = score(p1t0, p1t1) <= score(p2t0, p2t1)
  t0 = torch.where(use2[..., None], p2t0, p1t0)
  t1 = torch.where(use2[..., None], p2t1, p1t1)
  ok = ok & ~_segments_cross(e0, t0, e1, t1)

  u0 = t0 / torch.clamp_min(_norm2(t0), _MINVAL)[..., None]
  u1 = t1 / torch.clamp_min(_norm2(t1), _MINVAL)[..., None]
  angle = torch.arccos(torch.clamp(_dot2(u0, u1), -1.0, 1.0))
  cr = _cross2(t0, t1)
  shortflag = torch.where(use2, cr >= 0, cr <= 0)
  angle = torch.where(shortflag, angle, 2 * torch.pi - angle)
  wlen = r * angle
  okv = ok[..., None]
  return ok, torch.where(ok, wlen, 0.0), torch.where(okv, t0, 0.0), torch.where(okv, t1, 0.0)


def wrap_inside2d(e0, e1, r):
  """C wrap_inside over any leading axes: the single touch point of a
  sidesite inside the object.  Returns (touching, P): P (..., 2) is the
  touch point (both wrap points), zeros where not touching; the in-plane
  wrap length is 0 by construction."""
  d0 = _norm2(e0)
  d1 = _norm2(e1)
  ok = (d0 > r) & (d1 > r) & (r >= _MINVAL) & (d0 >= _MINVAL) & (d1 >= _MINVAL)

  dif = e1 - e0
  dd = _dot2(dif, dif)
  a = _safe_div(-_dot2(e0, dif), dd)
  interior = (dd > _MINVAL) & (a > 0) & (a < 1)
  seg_dist = _norm2(e0 + a[..., None] * dif)
  ok = ok & ~(interior & (r >= seg_dist))

  mid = 0.5 * (e0 + e1)
  nm = _norm2(mid)
  mid = torch.where((nm > _MINVAL)[..., None], mid / torch.clamp_min(nm, _MINVAL)[..., None], mid)
  pmid = r[..., None] * mid

  cos_a = _safe_div(d0 * d0 + d1 * d1 - dd, 2 * d0 * d1)
  ok = ok & (cos_a >= -0.999999999999999)
  degenerate = cos_a > 0.999999999999999

  big_a = torch.arccos(torch.clamp(cos_a, -1.0, 1.0))
  r0 = _safe_div(r, d0)
  r1 = _safe_div(r, d1)

  asin = lambda x: torch.arcsin(torch.clamp(x, -1, 1))
  f0 = big_a + asin(_Z0 * r0) + asin(_Z0 * r1) - _TWO_ASIN_Z0
  use_mid = degenerate | (f0 > 0)

  def fval(z):
    return big_a + asin(z * r0) + asin(z * r1) - 2 * asin(z)

  z = torch.full_like(f0, _Z0)
  f, fail, done = f0, use_mid, torch.abs(f0) <= _NEWTON_TOL
  for _ in range(_NEWTON_STEPS):
    zr0, zr1 = z * r0, z * r1
    c0 = math.sqrt0(torch.clamp_min(1 - zr0 * zr0, 0.0))
    c1 = math.sqrt0(torch.clamp_min(1 - zr1 * zr1, 0.0))
    cz = math.sqrt0(torch.clamp_min(1 - z * z, 0.0))
    fp = (r0 / torch.clamp_min(c0, _MINVAL) + r1 / torch.clamp_min(c1, _MINVAL)
          - 2.0 / torch.clamp_min(cz, _MINVAL))
    stepfail = fp > -_MINVAL
    znew = z - _safe_div(f, fp)
    stepfail = stepfail | (znew > z)
    fnew = fval(znew)
    stepfail = stepfail | (fnew > _NEWTON_TOL)
    conv = torch.abs(fnew) <= _NEWTON_TOL
    active = ~(fail | done)
    take = active & ~stepfail
    z = torch.where(take, znew, z)
    f = torch.where(take, fnew, f)
    fail = fail | (active & stepfail)
    done = done | (active & conv)
  # C takes the mid-touch whenever Newton fails or exhausts its steps
  use_mid = fail | ~done

  pick0 = _cross2(e0, e1) > 0
  ref = torch.where(pick0[..., None], e0, e1)
  rq = torch.where(pick0, r0, r1)
  beta = asin(z) - asin(z * rq)
  eh = ref / torch.clamp_min(_norm2(ref), _MINVAL)[..., None]
  cb = torch.cos(beta)
  sb = torch.sin(beta)
  p = r[..., None] * _stack2(cb * eh[..., 0] - sb * eh[..., 1], sb * eh[..., 0] + cb * eh[..., 1])
  p = torch.where(use_mid[..., None], pmid, p)
  return ok, torch.where(ok[..., None], p, 0.0)


def _sphere_frame(x0, x1):
  """2D wrap plane (axis0, axis1) for a sphere: contains x0, x1, centre."""
  a0 = x0 / torch.clamp_min(_norm3(x0), _MINVAL)[..., None]
  n = math.cross(x0, x1)
  nn = _norm3(n)
  # collinear fallback: ones(3) with the largest |a0| component zeroed
  imax = torch.argmax(torch.abs(a0), dim=-1)
  v = 1.0 - torch.nn.functional.one_hot(imax, 3).to(x0.dtype)
  n = torch.where((nn < _MINVAL)[..., None], math.cross(a0, v), n)
  n = n / torch.clamp_min(_norm3(n), _MINVAL)[..., None]
  a1 = math.cross(n, a0)
  na1 = _norm3(a1)
  unit_x = torch.zeros_like(a1)
  unit_x[..., 0] = 1.0
  a1 = torch.where((na1 < _MINVAL)[..., None], unit_x,
                   a1 / torch.clamp_min(na1, _MINVAL)[..., None])
  return a0, a1


def wrap(x0, x1, r, side, is_sphere: bool, has_side: bool):
  """Full mju_wrap in the geom-local frame (geom at origin, axis = +z),
  over any leading axes.

  x0, x1: (..., 3) local endpoints; r: (...) radii; side: (..., 3) local
  sidesite (ignored unless has_side).  Returns (wrapped, wlen, w0, w1)
  with w0/w1 the (..., 3) local wrap points; wlen is the in-object path
  length between them (a cylinder's includes the axial component).
  """
  if is_sphere:
    a0, a1 = _sphere_frame(x0, x1)
    e0 = _stack2(math.dot3(x0, a0), math.dot3(x0, a1))
    e1 = _stack2(math.dot3(x1, a0), math.dot3(x1, a1))
  else:
    e0 = x0[..., :2]
    e1 = x1[..., :2]

  if has_side:
    s2 = _stack2(math.dot3(side, a0), math.dot3(side, a1)) if is_sphere else side[..., :2]
    ns = _norm2(s2)
    unit_x = torch.zeros_like(s2)
    unit_x[..., 0] = 1.0
    s2 = torch.where((ns > _MINVAL)[..., None], s2 / torch.clamp_min(ns, _MINVAL)[..., None],
                     unit_x)
    inside = _norm3(side) < r
    ow, owlen, ot0, ot1 = wrap_circle2d(e0, e1, r, r[..., None] * s2, True)
    iw, ip = wrap_inside2d(e0, e1, r)
    wrapped = torch.where(inside, iw, ow)
    wlen2 = torch.where(inside, 0.0, owlen)
    t0 = torch.where(inside[..., None], ip, ot0)
    t1 = torch.where(inside[..., None], ip, ot1)
  else:
    wrapped, wlen2, t0, t1 = wrap_circle2d(e0, e1, r, None, False)

  if is_sphere:
    w0 = t0[..., :1] * a0 + t0[..., 1:] * a1
    w1 = t1[..., :1] * a0 + t1[..., 1:] * a1
    return wrapped, wlen2, w0, w1

  # cylinder: interpolate z along the in-plane path (C mju_wrap's tail)
  l0 = _norm2(e0 - t0)
  l1 = _norm2(e1 - t1)
  dz = x1[..., 2] - x0[..., 2]
  tot = torch.clamp_min(l0 + wlen2 + l1, _MINVAL)
  z0 = x0[..., 2] + dz * l0 / tot
  z1 = x0[..., 2] + dz * (l0 + wlen2) / tot
  dzw = z1 - z0
  wlen3 = math.sqrt0(wlen2 * wlen2 + dzw * dzw)
  w0 = torch.cat([t0, z0[..., None]], dim=-1)
  w1 = torch.cat([t1, z1[..., None]], dim=-1)
  return wrapped, wlen3, w0, w1


# ---------------------------------------------------------------------------
# spatial tendon program: the host-side decomposition of the wrap chains
# into straight and wrap segments (mj_tendon's spatial branch)
# ---------------------------------------------------------------------------


def build_program(m: Model):
  """Decomposes spatial tendons into straight and wrap segment arrays.

  Walks wrap_type/wrap_objid/wrap_prm exactly like mj_tendon: segments run
  between consecutive sites within a branch, a pulley resets the branch and
  sets the divisor for everything after it, and a sphere/cylinder entry
  wraps the segment between its neighbouring sites.  Returns (straight,
  wraps): straight has int arrays (ten, s0, s1) and float divisors; wraps
  has (ten, s0, s1, geom, side), divisors and bool is_sphere per entry,
  ordered by their appearance so Data.ten_wrap_* indexing is stable.
  """
  wrap_type = np.asarray(m.wrap_type)
  wrap_objid = np.asarray(m.wrap_objid)
  wrap_prm = np.asarray(m.wrap_prm)
  adr = np.asarray(m.tendon_adr)
  num = np.asarray(m.tendon_num)

  st = dict(ten=[], s0=[], s1=[], div=[])
  wr = dict(ten=[], s0=[], s1=[], geom=[], side=[], sphere=[], div=[])

  for t in range(m.ntendon):
    lo, hi = int(adr[t]), int(adr[t]) + int(num[t])
    if int(wrap_type[lo]) == int(WrapType.JOINT):
      continue  # fixed tendon: handled by the joint path
    divisor = 1.0
    j = lo
    prev = -1
    while j < hi:
      wt = int(wrap_type[j])
      if wt == int(WrapType.PULLEY):
        divisor = float(wrap_prm[j])
        prev = -1
        j += 1
        continue
      if wt in (int(WrapType.SPHERE), int(WrapType.CYLINDER)):
        # geom between the previous site and the next wrap entry (a site)
        nxt = int(wrap_objid[j + 1])
        wr["ten"].append(t)
        wr["s0"].append(prev)
        wr["s1"].append(nxt)
        wr["geom"].append(int(wrap_objid[j]))
        wr["side"].append(int(wrap_prm[j]))
        wr["sphere"].append(wt == int(WrapType.SPHERE))
        wr["div"].append(divisor)
        prev = nxt
        j += 2
        continue
      # site
      sid = int(wrap_objid[j])
      if prev >= 0:
        st["ten"].append(t)
        st["s0"].append(prev)
        st["s1"].append(sid)
        st["div"].append(divisor)
      prev = sid
      j += 1

  straight = {k: np.asarray(v) for k, v in st.items()}
  wraps = {k: np.asarray(v) for k, v in wr.items()}
  return straight, wraps


def n_wrap_geoms(m: Model) -> int:
  """Number of sphere/cylinder entries across all spatial tendons (static)."""
  if not m.nwrap:
    return 0
  wt = np.asarray(m.wrap_type)
  return int(np.sum((wt == int(WrapType.SPHERE)) | (wt == int(WrapType.CYLINDER))))


def _safe_dir(v):
  """normalize(v) with mju_normalize3's (1,0,0) degenerate fallback."""
  n = _norm3(v)[..., None]
  unit = torch.zeros_like(v)
  unit[..., 0] = 1.0
  return torch.where(n < _MINVAL, unit, v / torch.clamp_min(n, _MINVAL))


# the wrap groups in mjtpu's order: (is_sphere, has_side)
_WRAP_GROUPS = ((True, True), (True, False), (False, True), (False, False))


def _tables(m: Model) -> dict:
  """The spatial pass's static tables as device tensors: per straight
  segment and per wrap group, the sites, geoms, their bodies' ancestor
  masks and roots, the divisors; the wrap groups' places in
  Data.ten_wrap_*; and the gather table that sums every segment's
  contribution (straight segments first, then the wrap groups in
  _WRAP_GROUPS order, as mjtpu adds them) into its tendon."""
  straight, wraps = build_program(m)
  dev = m.device
  long = lambda x: torch.as_tensor(np.asarray(x, dtype=np.int64), device=dev)
  flt = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=m.dtype, device=dev)
  mask = support.dof_ancestor_mask(m)
  rootid, site_body = np.asarray(m.body_rootid), np.asarray(m.site_bodyid)
  geom_body = np.asarray(m.geom_bodyid)
  body = lambda b: {"mask": flt(mask[b]), "root": long(rootid[b])}

  out = {"straight": None, "groups": []}
  order = []
  if straight["ten"].size:
    s0, s1 = straight["s0"], straight["s1"]
    out["straight"] = dict(s0=long(s0), s1=long(s1), div=flt(straight["div"]),
                           b0=body(site_body[s0]), b1=body(site_body[s1]))
    order.append(straight["ten"])
  if wraps["ten"].size:
    for sphere, has_side in _WRAP_GROUPS:
      sel = np.nonzero((wraps["sphere"] == sphere) & ((wraps["side"] >= 0) == has_side))[0]
      if not sel.size:
        continue
      s0, s1, g = wraps["s0"][sel], wraps["s1"][sel], wraps["geom"][sel]
      out["groups"].append(dict(
          sphere=sphere, has_side=has_side, sel=long(sel), s0=long(s0), s1=long(s1), geom=long(g),
          side=long(wraps["side"][sel]) if has_side else None, div=flt(wraps["div"][sel]),
          b0=body(site_body[s0]), b1=body(site_body[s1]), bg=body(geom_body[g])))
      order.append(wraps["ten"][sel])
  tid = np.concatenate(order) if order else np.zeros(0, dtype=np.int64)
  out["table"] = scan.segment_table([np.nonzero(tid == t)[0] for t in range(m.ntendon)],
                                    len(tid), dev)
  return out


def _jrows(d: Data, points, body, dirs):
  """dir . jacp rows (B, K, nv) for world points (B, K, 3) on the bodies
  ``body`` (their ancestor masks (K, nv) and roots (K,)) along dirs."""
  offset = points - d.subtree_com[:, body["root"]]                       # (B, K, 3)
  cdof = d.cdof[:, None]                                                 # (B, 1, nv, 6)
  lin = math.dot3(cdof[..., 3:], dirs[:, :, None, :])
  ang = math.dot3(cdof[..., :3], math.cross(offset, dirs)[:, :, None, :])
  return body["mask"] * (lin + ang)


def spatial_tendon(m: Model, d: Data):
  """The spatial tendons' lengths (B, ntendon) and Jacobians (B, ntendon,
  nv), zero in the rows of fixed tendons, and the world wrap points (B,
  nwrap, 2, 3) and active flags (B, nwrap) of Data.ten_wrap_*
  (mj_tendon's spatial branch)."""
  t = cached(m, "tendon_wrap.tables", lambda: _tables(m))
  B = d.qpos.shape[0]
  nwg = n_wrap_geoms(m)
  lengths, rows = [], []
  wrap_xpos = d.qpos.new_zeros((B, nwg, 2, 3))
  wrap_active = torch.zeros((B, nwg), dtype=torch.bool, device=d.qpos.device)

  if t["straight"] is not None:
    s = t["straight"]
    p0 = d.site_xpos[:, s["s0"]]
    p1 = d.site_xpos[:, s["s1"]]
    dif = p1 - p0
    dirs = _safe_dir(dif)
    lengths.append(_norm3(dif) / s["div"])
    rows.append((_jrows(d, p1, s["b1"], dirs) - _jrows(d, p0, s["b0"], dirs))
                / s["div"][:, None])

  for g in t["groups"]:
    x0 = d.site_xpos[:, g["s0"]]
    x1 = d.site_xpos[:, g["s1"]]
    gx = d.geom_xpos[:, g["geom"]]
    gm = d.geom_xmat[:, g["geom"]]                                      # (B, K, 3, 3)
    l0, l1 = math.mat_t_vec(gm, x0 - gx), math.mat_t_vec(gm, x1 - gx)
    if g["has_side"]:
      sl = math.mat_t_vec(gm, d.site_xpos[:, g["side"]] - gx)
    else:
      sl = torch.zeros_like(l0)
    radius = env_rows(m, "geom_size")[:, g["geom"], 0].expand(l0.shape[:-1])
    wrapped, wlen, w0l, w1l = wrap(l0, l1, radius, sl, g["sphere"], g["has_side"])
    w0 = gx + math.mat_vec(gm, w0l)
    w1 = gx + math.mat_vec(gm, w1l)
    wrap_xpos[:, g["sel"]] = torch.stack([w0, w1], dim=2)
    wrap_active[:, g["sel"]] = wrapped

    length_w = _norm3(w0 - x0) + wlen + _norm3(x1 - w1)
    length_s = _norm3(x1 - x0)
    dir0, dir1, dir_s = _safe_dir(w0 - x0), _safe_dir(x1 - w1), _safe_dir(x1 - x0)
    rows_w = (_jrows(d, w0, g["bg"], dir0) - _jrows(d, x0, g["b0"], dir0)
              + _jrows(d, x1, g["b1"], dir1) - _jrows(d, w1, g["bg"], dir1))
    rows_s = _jrows(d, x1, g["b1"], dir_s) - _jrows(d, x0, g["b0"], dir_s)
    lengths.append(torch.where(wrapped, length_w, length_s) / g["div"])
    rows.append(torch.where(wrapped[..., None], rows_w, rows_s) / g["div"][:, None])

  ten_length = scan.segment_sum(torch.cat(lengths, dim=1), t["table"])
  ten_J = scan.segment_sum(torch.cat(rows, dim=1), t["table"])
  return ten_length, ten_J, wrap_xpos, wrap_active
