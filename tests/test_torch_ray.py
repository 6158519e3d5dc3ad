"""mjtpu_torch's ray casting (ray_geom, ray, the rangefinder) against
mjtpu's at float64 on the CPU, and the rangefinder against MuJoCo C.

  * ray_geom for each of the seven geom types it intersects (plane,
    sphere, capsule, ellipsoid, cylinder, box, mesh), on seeded rays of
    which some hit and some miss: the same distances to 1e-12 and the same
    misses (inf).
  * A rangefinder model with one geom of each type, a geom on the sites'
    own body (excluded), two coincident boxes (a tie: the lower geom id
    wins) and a ray that hits nothing: sensordata to 1e-12 and the hit
    geom ids exactly against mjtpu, and sensordata against MuJoCo C.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import mjtpu
from mjtpu._src import ray as j_ray
import mjtpu_torch
from mjtpu_torch._src import ray as t_ray

torch.set_num_threads(1)

N_RAYS = 256
TYPES = ("plane", "sphere", "capsule", "ellipsoid", "cylinder", "box", "mesh")
SIZES = {"plane": (1.5, 1.0, 0.1), "sphere": (0.6, 0.0, 0.0), "capsule": (0.4, 0.7, 0.0),
         "ellipsoid": (0.5, 0.8, 0.3), "cylinder": (0.5, 0.6, 0.0), "box": (0.4, 0.7, 0.5),
         "mesh": (0.0, 0.0, 0.0)}
# a tetrahedron about its centroid
TET_VERT = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.2, 0.3, 0.8]])
TET_VERT = TET_VERT - TET_VERT.mean(axis=0)
TET_FACE = np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]])


def _rays(seed):
  """A geom pose and N_RAYS rays from points 1.5-3 away, aimed at the
  geom's centre with a spread that makes some of them miss."""
  rng = np.random.default_rng(seed)
  q = rng.normal(size=4)
  q /= np.linalg.norm(q)
  mat = np.zeros(9)
  mujoco.mju_quat2Mat(mat, q)
  pos = rng.uniform(-0.5, 0.5, 3)
  d = rng.normal(size=(N_RAYS, 3))
  d /= np.linalg.norm(d, axis=1, keepdims=True)
  pnt = pos + d * rng.uniform(1.5, 3.0, (N_RAYS, 1))
  vec = (pos - pnt) + rng.normal(scale=0.6, size=(N_RAYS, 3))
  vec *= rng.uniform(0.5, 2.0, (N_RAYS, 1)) / np.linalg.norm(vec, axis=1, keepdims=True)
  return pos, mat.reshape(3, 3), pnt, vec


@pytest.mark.parametrize("name", TYPES)
def test_ray_geom_matches_mjtpu(name):
  gt = int(getattr(mjtpu_torch.GeomType, name.upper()))
  pos, mat, pnt, vec = _rays(TYPES.index(name))
  size = np.array(SIZES[name])
  tris = TET_VERT[TET_FACE] if name == "mesh" else None
  one = lambda p, v: j_ray.ray_geom(jnp.asarray(pos), jnp.asarray(mat), jnp.asarray(size), p, v,
                                    gt, None if tris is None else jnp.asarray(tris))
  want = np.asarray(jax.jit(jax.vmap(one))(jnp.asarray(pnt), jnp.asarray(vec)))
  t = lambda x: torch.as_tensor(x, dtype=torch.float64)
  got = mjtpu_torch.ray_geom(t(pos), t(mat), t(size), t(pnt), t(vec), gt,
                             None if tris is None else t(tris)).numpy()
  hit = np.isfinite(want)
  assert 0.2 * N_RAYS < hit.sum() < 0.95 * N_RAYS, hit.sum()  # both hits and misses
  np.testing.assert_array_equal(np.isfinite(got), hit)
  np.testing.assert_allclose(got[hit], want[hit], rtol=0, atol=1e-12)


RAY_XML = """<mujoco>
  <asset>
    <mesh name="tet" vertex="0 0 0  1 0 0  0 1 0  0.2 0.3 0.8"/>
  </asset>
  <worldbody>
    <geom name="floor" type="plane" size="20 20 0.1" pos="0 0 -1"/>
    <geom name="sphere" type="sphere" size="0.3" pos="3 0 0"/>
    <geom name="capsule" type="capsule" size="0.2 0.4" pos="0 3 0" euler="0.3 0.2 0"/>
    <geom name="ellipsoid" type="ellipsoid" size="0.3 0.5 0.2" pos="-3 0 0" euler="0 0.4 0.1"/>
    <geom name="cylinder" type="cylinder" size="0.3 0.4" pos="0 -3 0" euler="0.5 0 0"/>
    <geom name="box" type="box" size="0.3 0.2 0.4" pos="0 0 3" euler="0.1 0.2 0.3"/>
    <geom name="mesh" type="mesh" mesh="tet" pos="2.5 2.5 -0.2"/>
    <geom name="tie_a" type="box" size="0.3 0.3 0.3" pos="-2.5 -2.5 0"/>
    <geom name="tie_b" type="box" size="0.3 0.3 0.3" pos="-2.5 -2.5 0"/>
    <body name="rig" pos="0 0 0">
      <freejoint/>
      <geom name="own" type="sphere" size="0.5" density="100" contype="0" conaffinity="0"/>
      <site name="r_sphere" zaxis="1 0 0"/>
      <site name="r_capsule" zaxis="0 1 0"/>
      <site name="r_ellipsoid" zaxis="-1 0 0"/>
      <site name="r_cylinder" zaxis="0 -1 0"/>
      <site name="r_box" zaxis="0 0 1"/>
      <site name="r_floor" zaxis="0.3 -0.2 -1"/>
      <site name="r_mesh" zaxis="2.8 2.825 0"/>
      <site name="r_tie" zaxis="-1 -1 0"/>
      <site name="r_miss" zaxis="1 1 1"/>
    </body>
  </worldbody>
  <sensor>
    <rangefinder site="r_sphere"/>
    <rangefinder site="r_capsule"/>
    <rangefinder site="r_ellipsoid"/>
    <rangefinder site="r_cylinder"/>
    <rangefinder site="r_box"/>
    <rangefinder site="r_floor"/>
    <rangefinder site="r_mesh"/>
    <rangefinder site="r_tie"/>
    <rangefinder site="r_miss"/>
  </sensor>
</mujoco>"""
# each rangefinder's site and the geom it must hit (None: nothing)
RAYS = (("r_sphere", "sphere"), ("r_capsule", "capsule"), ("r_ellipsoid", "ellipsoid"),
        ("r_cylinder", "cylinder"), ("r_box", "box"), ("r_floor", "floor"), ("r_mesh", "mesh"),
        ("r_tie", "tie_a"), ("r_miss", None))


def _rig_states(mjm, n=3):
  """qpos of the free rig: at rest, then small seeded shifts and turns."""
  rng = np.random.default_rng(0)
  qpos = np.tile(mjm.qpos0, (n, 1))
  for b in range(1, n):
    qpos[b, :3] = rng.uniform(-0.05, 0.05, 3)
    rv = rng.uniform(-0.03, 0.03, 3)
    qpos[b, 3:7] = np.concatenate([[np.cos(np.linalg.norm(rv) / 2)],
                                   np.sin(np.linalg.norm(rv) / 2) * rv / np.linalg.norm(rv)])
  return qpos


def test_rangefinders_match_mjtpu_and_c():
  mjm = mujoco.MjModel.from_xml_string(RAY_XML)
  qpos = _rig_states(mjm)
  B = len(qpos)
  m = mjtpu.put_model(mjm, dtype=jnp.float64)
  fwd = jax.jit(mjtpu.forward)
  want, want_ids, c_data = [], [], []
  rf_sites = [mujoco.mj_name2id(mjm, mujoco.mjtObj.mjOBJ_SITE, site) for site, _ in RAYS]
  rig = mujoco.mj_name2id(mjm, mujoco.mjtObj.mjOBJ_BODY, "rig")
  for b in range(B):
    d = fwd(m, mjtpu.make_data(m).replace(qpos=jnp.asarray(qpos[b])))
    want.append(np.asarray(d.sensordata))
    want_ids.append([int(j_ray.ray(m, d, d.site_xpos[s], d.site_xmat[s][:, 2],
                                   bodyexclude=rig)[1]) for s in rf_sites])
    mjd = mujoco.MjData(mjm)
    mjd.qpos[:] = qpos[b]
    mujoco.mj_forward(mjm, mjd)
    c_data.append(np.array(mjd.sensordata))
  want, want_ids, c_data = np.stack(want), np.array(want_ids), np.stack(c_data)

  tm = mjtpu_torch.put_model(mjm, device="cpu")
  d = mjtpu_torch.make_data(tm, batch_size=B)
  d = mjtpu_torch.forward(tm, mjtpu_torch.replace(d, qpos=torch.as_tensor(qpos)))
  np.testing.assert_allclose(d.sensordata.numpy(), want, rtol=0, atol=1e-12)
  ids = np.stack([mjtpu_torch.ray(tm, d, d.site_xpos[:, s], d.site_xmat[:, s, :, 2],
                                  bodyexclude=rig)[1].numpy() for s in rf_sites], axis=1)
  np.testing.assert_array_equal(ids, want_ids)
  # every target hit, by the geom aimed at: the tie by the lower id, the
  # rig's own sphere never, the last ray nothing
  names = [None if t is None else mujoco.mj_name2id(mjm, mujoco.mjtObj.mjOBJ_GEOM, t)
           for _, t in RAYS]
  np.testing.assert_array_equal(ids, np.tile([-1 if g is None else g for g in names], (B, 1)))
  assert (want[:, -1] == -1).all() and (want[:, :-1] > 0).all()
  # MuJoCo C agrees with both engines
  np.testing.assert_allclose(c_data, want, rtol=0, atol=1e-9)


def test_cast_batches_rays_with_their_own_candidates():
  """ray.cast over S rays with per-ray candidate lists equals one ray()
  call per ray; a ray with no candidate reads -1."""
  mjm = mujoco.MjModel.from_xml_string(RAY_XML)
  tm = mjtpu_torch.put_model(mjm, device="cpu")
  d = mjtpu_torch.forward(tm, mjtpu_torch.make_data(tm, batch_size=2))
  rng = np.random.default_rng(3)
  pnt = torch.as_tensor(rng.uniform(-1, 1, (2, 4, 3)))
  vec = torch.as_tensor(rng.normal(size=(2, 4, 3)))
  groups = [None, (True, False, False, False, False, False)]
  cands = tuple(tuple(int(g) for g in t_ray.candidate_geoms(tm, grp, static, -1))
                for grp, static in ((None, True), (None, False), (groups[1], True)))
  cands = cands + ((),)
  dist, geom = t_ray.cast(tm, d, pnt, vec, cands)
  for s, (grp, static) in enumerate(((None, True), (None, False), (groups[1], True))):
    one = mjtpu_torch.ray(tm, d, pnt[:, s], vec[:, s], grp, static)
    assert torch.equal(dist[:, s], one[0]) and torch.equal(geom[:, s], one[1])
  assert (dist[:, 3] == -1).all() and (geom[:, 3] == -1).all()
