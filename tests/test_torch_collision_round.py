"""The collision slice against mjtpu at float64 on the CPU: every geom pair
mjtpu collides.

  * the hulls of cylinders and ellipsoids: mesh.cylinder and mesh.ellipsoid
    build mjtpu's tables, table by table (their order decides SAT ties);
  * the small collision scenes of mjtpu_torch/assets/collision_scenes.npz
    (the round pairs of tests/test_collision_round.py, the pairs of
    tests/test_collision.py's PAIR_SCENES that need this slice's colliders,
    a tetrahedron on a tetrahedron, tests/test_broadphase.py's sphere pile
    with max_geom_pairs 4): the port's collision at B=2 (qpos0 and a seeded
    perturbation) against mjtpu's fwd_position in the committed golden,
    contact dist, pos and frame to 1e-10 of scale, the slot count and the
    slots' geoms exactly;
  * the cylinder drop (a cylinder on a box through SAT, kernel B3's seam),
    tests/models/roll.xml and tests/models/sph_cyl.xml: 100 steps at B=4
    against mjtpu's committed trajectories to TRAJECTORY_BOUND, and the
    contacts of step 1 to 1e-10 of scale;
  * the cylinder drop's step calls the SAT seam once and the Cholesky
    seam once per Newton iteration, and its hull pair takes B3's shared
    variant.

mjtpu runs through the committed goldens (scripts/torch_port_assets.py),
which tests/test_torch_assets.py holds fresh.
"""

import numpy as np
import pytest
import torch

from mjtpu._src import mesh as j_mesh
import mjtpu_torch
from mjtpu_torch._src import collision_driver, io, smooth, solver
from mjtpu_torch._src import mesh as t_mesh
from mjtpu_torch.ops import fused, sat

torch.set_num_threads(1)

SCENES_FILE = mjtpu_torch.ASSETS / "collision_scenes.npz"
SCENES = io.bundle_names(SCENES_FILE)
CONTACT_MODELS = ("cylinder_drop", "roll", "sph_cyl")
CONTACT_BOUND = 1e-10    # of each field's scale, max(1, max |mjtpu|)
TRAJECTORY_BOUND = 1e-8  # absolute, qpos and qvel over 100 steps (measured
                         # on an x86 CPU: 1.4e-14, 6.4e-15, 2.5e-15)


def _assert_close(got, want, what, tol=CONTACT_BOUND):
  got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
  assert got.shape == want.shape, (what, got.shape, want.shape)
  scale = max(1.0, float(np.abs(want).max()))
  err = float(np.abs(got - want).max())
  assert err <= tol * scale, f"{what}: max abs err {err:.3e} (scale {scale:.3g})"


@pytest.fixture(scope="module")
def scene_golden():
  return dict(np.load(mjtpu_torch.ASSETS / "collision_scenes_golden.npz"))


@pytest.mark.parametrize("kind, size", [
    ("cylinder", (0.08, 0.15)), ("cylinder", (0.1, 0.2)),
    ("ellipsoid", (0.08, 0.1, 0.12)), ("ellipsoid", (0.1, 0.12, 0.15)),
])
def test_round_hulls_match_mjtpu(kind, size):
  want = getattr(j_mesh, kind)(np.array(size))
  got = getattr(t_mesh, kind)(np.array(size))
  for f in io.HULL_FIELDS:
    np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
  # a cylinder's caps are 16-gons, so every face is padded to 16 vertices
  assert got.face.shape[1] == (16 if kind == "cylinder" else 3)


def test_scenes_cover_the_slice():
  """The scenes reach every collider this slice added (one group each)."""
  G = mjtpu_torch.GeomType
  keys = set()
  for name in SCENES:
    m = mjtpu_torch.model_from_arrays(io.load_snapshot(SCENES_FILE, name), device="cpu")
    keys |= {k[:2] for k in collision_driver.candidate_groups(m)}
  want = {(G.PLANE, G.ELLIPSOID), (G.PLANE, G.CYLINDER), (G.PLANE, G.MESH),
          (G.HFIELD, G.BOX), (G.HFIELD, G.ELLIPSOID), (G.HFIELD, G.CYLINDER),
          (G.SPHERE, G.ELLIPSOID), (G.SPHERE, G.CYLINDER), (G.CAPSULE, G.ELLIPSOID),
          (G.CAPSULE, G.CYLINDER), (G.CAPSULE, G.BOX), (G.ELLIPSOID, G.ELLIPSOID),
          (G.ELLIPSOID, G.CYLINDER), (G.ELLIPSOID, G.BOX), (G.CYLINDER, G.CYLINDER),
          (G.CYLINDER, G.BOX), (G.CYLINDER, G.MESH), (G.MESH, G.MESH)}
  assert want <= keys, sorted(want - keys)


@pytest.mark.parametrize("name", SCENES)
def test_scene_contacts_match_mjtpu(name, scene_golden):
  m = mjtpu_torch.model_from_arrays(io.load_snapshot(SCENES_FILE, name), device="cpu")
  qpos = scene_golden[f"{name}.qpos0"]
  d = mjtpu_torch.make_data(m, batch_size=qpos.shape[0])
  d = mjtpu_torch.replace(d, qpos=torch.as_tensor(qpos))
  c = collision_driver.collision(m, smooth.kinematics(m, d)).contact
  for k in ("dist", "pos", "frame"):
    _assert_close(getattr(c, k).numpy(), scene_golden[f"{name}.{k}"], f"{name} {k}")
  for k in ("geom1", "geom2"):
    np.testing.assert_array_equal(getattr(c, k).numpy(), scene_golden[f"{name}.{k}"], err_msg=k)
  assert (c.dist.numpy() < 0).any(axis=1).all(), f"{name}: an env without a live contact"


@pytest.mark.parametrize("name", CONTACT_MODELS)
def test_trajectory_matches_mjtpu(name):
  golden = dict(np.load(mjtpu_torch.ASSETS / f"{name}_golden.npz"))
  m = mjtpu_torch.model_from_arrays(
      mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / f"{name}_model.npz"), device="cpu")
  d = mjtpu_torch.make_data(m, batch_size=golden["qpos0"].shape[0])
  d = mjtpu_torch.replace(d, qpos=torch.as_tensor(golden["qpos0"]),
                          qvel=torch.as_tensor(golden["qvel0"]))
  worst = 0.0
  for i in range(golden["qpos"].shape[0]):
    d = mjtpu_torch.step(m, d)
    if i == 0:
      for k in ("dist", "pos", "frame"):
        _assert_close(getattr(d.contact, k).numpy(), golden[f"contact_{k}"], f"step 1 {k}")
      for k in ("geom1", "geom2"):
        np.testing.assert_array_equal(getattr(d.contact, k).numpy(), golden[f"contact_{k}"])
    for f in ("qpos", "qvel"):
      err = float(np.abs(getattr(d, f).numpy() - golden[f][i]).max())
      assert err <= TRAJECTORY_BOUND, f"{name} step {i + 1} {f}: {err:.3e}"
      worst = max(worst, err)
  assert int(d.nreset.sum()) == 0 and worst <= TRAJECTORY_BOUND


def test_cylinder_drop_seams(monkeypatch):
  """One step of the cylinder drop calls the SAT seam once, on the whole
  (B x 1) batch of cylinder-box pairs, whose hulls take B3's shared
  variant, and the Cholesky seam once per Newton iteration."""
  golden = dict(np.load(mjtpu_torch.ASSETS / "cylinder_drop_golden.npz"))
  m = mjtpu_torch.model_from_arrays(
      mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / "cylinder_drop_model.npz"), device="cpu")
  calls = {"sat": [], "chol": 0}
  sat_batch, chol = sat.sat_winners_batch, fused.chol_solve

  def sat_seam(*args, **kwargs):
    calls["sat"].append((args[0].shape[0], sat.variant(*args[4:6])))
    return sat_batch(*args, **kwargs)

  def chol_seam(*args, **kwargs):
    calls["chol"] += 1
    return chol(*args, **kwargs)

  monkeypatch.setattr(sat, "sat_winners_batch", sat_seam)
  monkeypatch.setattr(fused, "chol_solve", chol_seam)
  d = mjtpu_torch.make_data(m, batch_size=4)
  d = mjtpu_torch.replace(d, qpos=torch.as_tensor(golden["qpos0"]),
                          qvel=torch.as_tensor(golden["qvel0"]))
  before = solver.loop_counts["iterations"]
  mjtpu_torch.step(m, d)
  assert calls["sat"] == [(4, "shared")]
  assert calls["chol"] == solver.loop_counts["iterations"] - before > 0
