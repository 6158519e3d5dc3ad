"""Quaternion / spatial-algebra math substrate (port of mjtpu/_src/math.py).

MuJoCo conventions throughout: quaternions are (w, x, y, z); spatial motion
vectors are 6-vectors (angular[3], linear[3]); packed inertias are
10-vectors (xx, yy, zz, xy, xz, yz, mass*com[3], mass).

Every function works on the trailing axes and broadcasts over any leading
ones, so one call covers a whole (B, k, ...) batch of envs and entities.
Three-term dots and crosses are written out so their summation order is
the same on every device.
"""

from __future__ import annotations

import torch

# MuJoCo's mjMINVAL
MINVAL = 1e-15


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  a, b = torch.broadcast_tensors(a, b)
  return torch.stack([
      a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
      a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
      a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
  ], dim=-1)


def mat_vec(mat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """mat @ v over trailing (3, 3) and (3,) axes, a fixed summation order."""
  return torch.stack([dot3(mat[..., k, :], v) for k in range(3)], dim=-1)


def mat_t_vec(mat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """mat.T @ v over trailing (3, 3) and (3,) axes, a fixed summation order."""
  return torch.stack([dot3(mat[..., :, k], v) for k in range(3)], dim=-1)


def sqrt0(x: torch.Tensor) -> torch.Tensor:
  """sqrt of a non-negative ``x`` whose gradient at 0 is 0, not sqrt's
  infinite slope, which times a zero cotangent (a branch a where leaves,
  a length that is clamped) makes NaN; the values keep their bits.  Where
  no gradient is taken it is sqrt itself, so a plain step keeps its
  operations."""
  if not x.requires_grad:
    return torch.sqrt(x)
  live = x > 0
  return torch.where(live, torch.sqrt(torch.where(live, x, 1.0)), 0.0)


def safe_norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
  sq = torch.sum(x * x, dim=dim)
  is_zero = sq == 0.0
  sq = torch.where(is_zero, torch.ones_like(sq), sq)
  return torch.where(is_zero, torch.zeros_like(sq), torch.sqrt(sq))


def norm3(x: torch.Tensor) -> torch.Tensor:
  """safe_norm over a trailing 3-axis with a fixed summation order."""
  sq = dot3(x, x)
  is_zero = sq == 0.0
  sq = torch.where(is_zero, torch.ones_like(sq), sq)
  return torch.where(is_zero, torch.zeros_like(sq), torch.sqrt(sq))


def normalize_with_norm(x: torch.Tensor):
  """(x / |x|, |x|) over the trailing axis; a zero vector stays zero."""
  n = norm3(x) if x.shape[-1] == 3 else safe_norm(x)
  nn = torch.where(n == 0.0, torch.ones_like(n), n)
  return x / nn[..., None], n


def normalize(x: torch.Tensor) -> torch.Tensor:
  return normalize_with_norm(x)[0]


# ---------------------------------------------------------------------------
# quaternions
# ---------------------------------------------------------------------------


def quat_mul(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """Hamilton product of two (w,x,y,z) quaternions."""
  u, v = torch.broadcast_tensors(u, v)
  return torch.stack([
      u[..., 0] * v[..., 0] - u[..., 1] * v[..., 1] - u[..., 2] * v[..., 2] - u[..., 3] * v[..., 3],
      u[..., 0] * v[..., 1] + u[..., 1] * v[..., 0] + u[..., 2] * v[..., 3] - u[..., 3] * v[..., 2],
      u[..., 0] * v[..., 2] - u[..., 1] * v[..., 3] + u[..., 2] * v[..., 0] + u[..., 3] * v[..., 1],
      u[..., 0] * v[..., 3] + u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1] + u[..., 3] * v[..., 0],
  ], dim=-1)


def quat_inv(q: torch.Tensor) -> torch.Tensor:
  """Conjugate of a unit quaternion."""
  return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def rotate(vec: torch.Tensor, quat: torch.Tensor) -> torch.Tensor:
  """Rotates vec by quat (mju_rotVecQuat)."""
  s, u = quat[..., :1], quat[..., 1:]
  r = 2.0 * (dot3(u, vec)[..., None] * u) + (s * s - dot3(u, u)[..., None]) * vec
  return r + 2.0 * s * cross(u, vec)


def rotate_inv(vec: torch.Tensor, quat: torch.Tensor) -> torch.Tensor:
  """Rotates vec by the inverse of quat."""
  return rotate(vec, quat_inv(quat))


def quat_to_vel(q: torch.Tensor) -> torch.Tensor:
  """Quaternion -> angular-velocity-style 3-vector (axis * angle)."""
  axis, sin_a_2 = normalize_with_norm(q[..., 1:])
  angle = 2.0 * torch.atan2(sin_a_2, q[..., 0])
  angle = torch.where(angle > torch.pi, angle - 2.0 * torch.pi, angle)
  return axis * angle[..., None]


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
  """Unit quaternion -> 3x3 rotation matrix."""
  w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
  return torch.stack([
      torch.stack([
          1.0 - 2.0 * (y * y + z * z),
          2.0 * (x * y - w * z),
          2.0 * (x * z + w * y),
      ], dim=-1),
      torch.stack([
          2.0 * (x * y + w * z),
          1.0 - 2.0 * (x * x + z * z),
          2.0 * (y * z - w * x),
      ], dim=-1),
      torch.stack([
          2.0 * (x * z - w * y),
          2.0 * (y * z + w * x),
          1.0 - 2.0 * (x * x + y * y),
      ], dim=-1),
  ], dim=-2)


def axis_angle_to_quat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
  """Unit axis + angle -> quaternion."""
  s, c = torch.sin(angle * 0.5), torch.cos(angle * 0.5)
  axis, s = torch.broadcast_tensors(axis, s[..., None])
  return torch.cat([c.expand(axis.shape[:-1])[..., None], axis * s], dim=-1)


def quat_integrate(q: torch.Tensor, v: torch.Tensor, dt) -> torch.Tensor:
  """Integrates quaternion by angular velocity v over dt (mju_quatIntegrate)."""
  v, angle = normalize_with_norm(v)
  q = quat_mul(q, axis_angle_to_quat(v, angle * dt))
  return normalize(q)


def quat_sub(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
  """Velocity-space difference of two quaternions (mju_subQuat): 3-vector."""
  qdif = quat_mul(quat_inv(qb), qa)
  axis, sin_a_2 = normalize_with_norm(qdif[..., 1:])
  speed = 2.0 * torch.atan2(sin_a_2, qdif[..., 0])
  speed = torch.where(speed > torch.pi, speed - 2.0 * torch.pi, speed)
  return axis * speed[..., None]


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
  """3x3 rotation matrix -> unit quaternion: of the four constructions,
  the one whose pivot (trace or a diagonal entry) is largest."""
  tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
  q = torch.stack([
      torch.stack([tr + 1.0, m[..., 2, 1] - m[..., 1, 2], m[..., 0, 2] - m[..., 2, 0],
                   m[..., 1, 0] - m[..., 0, 1]], dim=-1),
      torch.stack([m[..., 2, 1] - m[..., 1, 2], 1.0 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2],
                   m[..., 0, 1] + m[..., 1, 0], m[..., 0, 2] + m[..., 2, 0]], dim=-1),
      torch.stack([m[..., 0, 2] - m[..., 2, 0], m[..., 0, 1] + m[..., 1, 0],
                   1.0 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2],
                   m[..., 1, 2] + m[..., 2, 1]], dim=-1),
      torch.stack([m[..., 1, 0] - m[..., 0, 1], m[..., 0, 2] + m[..., 2, 0],
                   m[..., 1, 2] + m[..., 2, 1],
                   1.0 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2]], dim=-1),
  ], dim=-2)
  pivots = torch.stack([tr, m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]], dim=-1)
  case = torch.argmax(pivots, dim=-1)
  pick = case[..., None, None].expand(case.shape + (1, 4))
  return normalize(torch.gather(q, -2, pick)[..., 0, :])


# ---------------------------------------------------------------------------
# spatial algebra (Featherstone 6-vectors, MuJoCo layout: [ang, lin])
# ---------------------------------------------------------------------------


def cross_skew(v: torch.Tensor) -> torch.Tensor:
  """(..., 3) -> (..., 3, 3) skew-symmetric cross-product matrix."""
  z = torch.zeros_like(v[..., 0])
  x, y, w = v[..., 0], v[..., 1], v[..., 2]
  return torch.stack([torch.stack([z, -w, y], -1), torch.stack([w, z, -x], -1),
                      torch.stack([-y, x, z], -1)], -2)


def motion_cross(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """Cross product of two motion 6-vectors (mju_crossMotion)."""
  ang = cross(u[..., :3], v[..., :3])
  lin = cross(u[..., :3], v[..., 3:]) + cross(u[..., 3:], v[..., :3])
  return torch.cat([ang, lin], dim=-1)


def motion_cross_force(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
  """Cross product of motion with force 6-vector (mju_crossForce)."""
  ang = cross(v[..., :3], f[..., :3]) + cross(v[..., 3:], f[..., 3:])
  lin = cross(v[..., :3], f[..., 3:])
  return torch.cat([ang, lin], dim=-1)


def transform_motion(vel: torch.Tensor, offset: torch.Tensor, rotmat: torch.Tensor) -> torch.Tensor:
  """A motion 6-vector in a frame ``offset`` away and rotated by ``rotmat``
  (rows are the new frame's axes): mju_transformSpatial, flg_force=0."""
  ang, lin = vel[..., :3], vel[..., 3:]
  lin = lin - cross(offset, ang)
  return torch.cat([mat_vec(rotmat, ang), mat_vec(rotmat, lin)], dim=-1)


def transform_force(frc: torch.Tensor, offset: torch.Tensor, rotmat: torch.Tensor) -> torch.Tensor:
  """A force 6-vector in a frame ``offset`` away and rotated by ``rotmat``:
  mju_transformSpatial, flg_force=1."""
  ang, lin = frc[..., :3], frc[..., 3:]
  ang = ang - cross(offset, lin)
  return torch.cat([mat_vec(rotmat, ang), mat_vec(rotmat, lin)], dim=-1)


def inert_mul(i: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """Packed 10-vector inertia times motion 6-vector -> force 6-vector
  (mju_mulInertVec)."""
  w, lv = v[..., :3], v[..., 3:]
  ang = torch.stack([
      i[..., 0] * w[..., 0] + i[..., 3] * w[..., 1] + i[..., 4] * w[..., 2],
      i[..., 3] * w[..., 0] + i[..., 1] * w[..., 1] + i[..., 5] * w[..., 2],
      i[..., 4] * w[..., 0] + i[..., 5] * w[..., 1] + i[..., 2] * w[..., 2],
  ], dim=-1)
  h = i[..., 6:9]  # mass * com offset
  ang = ang + cross(h, lv)
  lin = i[..., 9:10] * lv - cross(h, w)
  return torch.cat([ang, lin], dim=-1)


def transform_inert(i, pos, rot, mass) -> torch.Tensor:
  """Packed 10-vector inertia about a new frame origin (mj_comPos's cinert).

  i: (..., 3) diagonal inertia in the inertial frame; rot: (..., 3, 3)
  world-from-inertial; pos: (..., 3) from the new origin to the body CoM;
  mass: (...).
  """
  inert_world = (rot * i[..., None, :]) @ rot.transpose(-1, -2)
  pp = dot3(pos, pos)
  m = mass[..., None, None]
  eye = torch.eye(3, dtype=pos.dtype, device=pos.device)
  off = m * (pp[..., None, None] * eye - pos[..., :, None] * pos[..., None, :])
  full = inert_world + off
  mass = mass.expand(pos.shape[:-1])
  return torch.cat([
      torch.stack([
          full[..., 0, 0], full[..., 1, 1], full[..., 2, 2],
          full[..., 0, 1], full[..., 0, 2], full[..., 1, 2],
      ], dim=-1),
      mass[..., None] * pos,
      mass[..., None],
  ], dim=-1)


def make_frame(a: torch.Tensor) -> torch.Tensor:
  """Right-handed frame (..., 3, 3) with rows x (= a normalized), y, z."""
  a = normalize(a)
  y, z = torch.zeros_like(a), torch.zeros_like(a)  # no host-to-device copy
  y[..., 1] = 1.0
  z[..., 2] = 1.0
  near_y = ((-0.5 < a[..., 1]) & (a[..., 1] < 0.5))[..., None]
  b = torch.where(near_y, y, z)
  b = b - a * dot3(a, b)[..., None]
  b = normalize(b)
  c = cross(a, b)
  return torch.stack([a, b, c], dim=-2)


def closest_segment_point(a: torch.Tensor, b: torch.Tensor, pt: torch.Tensor) -> torch.Tensor:
  """Closest point on segment ab to point pt (the 1e-12 floor as in mjtpu)."""
  ab = b - a
  t = dot3(pt - a, ab) / torch.clamp_min(dot3(ab, ab), 1e-12)
  return a + torch.clamp(t, 0.0, 1.0)[..., None] * ab


def closest_segment_to_segment_points(a0, a1, b0, b1):
  """Closest points between the segments a0a1 and b0b1."""
  dir_a, len_a = normalize_with_norm(a1 - a0)
  dir_b, len_b = normalize_with_norm(b1 - b0)
  half_len_a = len_a * 0.5
  half_len_b = len_b * 0.5
  a_mid = a0 + dir_a * half_len_a[..., None]
  b_mid = b0 + dir_b * half_len_b[..., None]
  trans = a_mid - b_mid

  dira_dot_dirb = dot3(dir_a, dir_b)
  dira_dot_trans = dot3(dir_a, trans)
  dirb_dot_trans = dot3(dir_b, trans)
  denom = 1.0 - dira_dot_dirb * dira_dot_dirb
  orig_t_a = (-dira_dot_trans + dira_dot_dirb * dirb_dot_trans) / torch.clamp_min(denom, 1e-12)
  orig_t_b = dirb_dot_trans + orig_t_a * dira_dot_dirb
  t_a = torch.minimum(torch.maximum(orig_t_a, -half_len_a), half_len_a)
  t_b = torch.minimum(torch.maximum(orig_t_b, -half_len_b), half_len_b)
  best_a = a_mid + dir_a * t_a[..., None]
  best_b = b_mid + dir_b * t_b[..., None]

  # resolve degeneracy by one more round of projection
  new_a = closest_segment_point(a0, a1, best_b)
  new_b = closest_segment_point(b0, b1, new_a)
  d_first = best_a - best_b
  d_second = new_a - new_b
  use_second = (dot3(d_second, d_second) < dot3(d_first, d_first))[..., None]
  return torch.where(use_second, new_a, best_a), torch.where(use_second, new_b, best_b)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
  """a * b + c with the product kept exact (Dekker's two-product), as a
  fused multiply-add keeps it.

  Where a * b + c is algebraically zero, a rounded product often makes it
  exactly 0.0, while a fused multiply-add returns the tiny true residual;
  code that branches on the sign of such a value takes another branch.
  """
  split = 134217729.0 if a.dtype == torch.float64 else 4097.0  # 2^s + 1
  p = a * b
  ta, tb = a * split, b * split
  ah = ta - (ta - a)
  bh = tb - (tb - b)
  al, bl = a - ah, b - bh
  err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
  # err is the product's rounding error, whose derivative is zero: the
  # gradient is that of a * b + c, bit for bit
  return (p + c) + err.detach()


def sigmoid_blend(s, a, b, sharpness):
  """Smooth ``where(s > 0, a, b)``: sigmoid(k s) a + (1 - sigmoid) b.

  The colliders' case blending under ``differentiable_mode`` with
  ``smooth_collisions``, so a case switch stays differentiable across the
  transition.  ``a`` and ``b`` (of one shape) may carry trailing axes
  past ``s``'s.
  """
  w = torch.sigmoid(sharpness * s)
  w = w.reshape(w.shape + (1,) * (a.dim() - w.dim()))
  return w * a + (1.0 - w) * b


# ---------------------------------------------------------------------------
# dense factorization
# ---------------------------------------------------------------------------


def pivot_floor(dtype: torch.dtype) -> float:
  """Cholesky pivot floor: MINVAL keeps f64 parity with MuJoCo; f32 needs
  a larger floor or 1/sqrt(pivot) overflows downstream."""
  return MINVAL if dtype == torch.float64 else 1e-9


def safe_cholesky(a: torch.Tensor) -> torch.Tensor:
  """Lower Cholesky of a batch (..., n, n) with pivot clamping.

  Right-looking outer-product form, the same operation order as mjtpu's
  safe_cholesky: singular matrices factor to large-but-finite results
  instead of NaN.  Never ``torch.linalg.cholesky``, which fails on a
  matrix that is not positive definite.
  """
  n = a.shape[-1]
  if n == 0:
    return a
  floor = pivot_floor(a.dtype)
  idx = torch.arange(n, device=a.device)
  mat, low = a, torch.zeros_like(a)
  for j in range(n):
    d = torch.sqrt(torch.clamp_min(mat[..., j, j], floor))
    col = torch.where(idx > j, mat[..., :, j] / d[..., None], 0.0)
    col[..., j] = d
    low[..., :, j] = col
    mat = mat - col[..., :, None] * col[..., None, :]
  return low


def cho_solve(low: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Solves A x = b given the clamped lower Cholesky factor of A.
  low: (..., n, n); b: (..., n)."""
  y = torch.linalg.solve_triangular(low, b[..., None], upper=False)
  x = torch.linalg.solve_triangular(low.transpose(-1, -2), y, upper=True)
  return x[..., 0]


def quat_from_uniform(u: torch.Tensor) -> torch.Tensor:
  """(..., 4) unit quaternions from uniform samples u (..., 3) in [0, 1),
  by mjtpu's random_unit_quat arithmetic (Shoemake's method)."""
  r1 = torch.sqrt(1.0 - u[..., 0])
  r2 = torch.sqrt(u[..., 0])
  t1 = 2.0 * torch.pi * u[..., 1]
  t2 = 2.0 * torch.pi * u[..., 2]
  return torch.stack([r2 * torch.cos(t2), r1 * torch.sin(t1), r1 * torch.cos(t1),
                      r2 * torch.sin(t2)], dim=-1)


def random_unit_quat(generator: torch.Generator, shape=(), dtype=torch.float64,
                     device=None) -> torch.Tensor:
  """Uniformly distributed unit quaternions (..., 4) of ``shape``, drawn
  from ``generator`` (which takes the place of mjtpu's key), on its
  device unless ``device`` names another."""
  device = generator.device if device is None else device
  u = torch.rand(tuple(shape) + (3,), generator=generator, dtype=dtype, device=device)
  return quat_from_uniform(u)
