"""The max_geom_pairs broadphase and put_model's remaining collision
refusals, against mjtpu at float64 on the CPU.

The broadphase (<numeric name="max_geom_pairs">) narrowphases only the K
pairs of each group nearest by bounding-sphere distance (a plane group: the
sphere's height above the plane), per env, the lower pair first on ties.
On tests/test_broadphase.py's sphere pile (a plane-sphere group of 6 pairs,
three of them tied far away, and a sphere-sphere group of 15) at K = 2, 4,
6: the port's static sizes equal mjtpu's, and its contacts (the chosen
pairs, ties included, with their geoms and mixed parameters) equal
mjtpu's fwd_position at B=3, qpos0 and two seeded perturbations; with K at
least the touching pairs the compacted steps track the uncompacted ones.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import mjtpu
from mjtpu._src import collision_driver as j_collision
from mjtpu._src import support as j_support
import mjtpu_torch
from mjtpu_torch._src import collision_driver as t_collision
from mjtpu_torch._src import smooth
from mjtpu_torch._src import support as t_support
from tests.conftest import load_mj
from tests.test_broadphase import _PILE

torch.set_num_threads(1)

B = 3


def _pile(k):
  custom = "" if k is None else f'<custom><numeric name="max_geom_pairs" data="{k}"/></custom>'
  return mujoco.MjModel.from_xml_string(_PILE.format(custom=custom))


def _states(mjm):
  """qpos0, and each sphere moved by up to 5 cm along x (numpy seed 0)."""
  rng = np.random.default_rng(0)
  qpos = np.tile(mjm.qpos0, (B, 1))
  qpos[1:, 0::7] += rng.uniform(-0.05, 0.05, (B - 1, 6))
  return qpos


@pytest.mark.parametrize("k", [None, 2, 4, 6, 30])
def test_static_sizes_match_mjtpu(k):
  mjm = _pile(k)
  jm = mjtpu.put_model(mjm)
  m = mjtpu_torch.put_model(mjm, device="cpu")
  assert t_collision.max_geom_pairs(m) == k
  assert t_collision.ncon(m) == j_collision.ncon(jm)
  np.testing.assert_array_equal(t_collision.make_condim(m), j_collision.make_condim(jm))
  assert t_support.constraint_sizes(m) == tuple(j_support.constraint_sizes(jm))
  # compacted slots hold different geoms in different envs
  assert (t_collision.contact_geoms(m) is None) == (k is not None and k < 15)


@pytest.mark.parametrize("k", [2, 4, 6])
def test_contacts_match_mjtpu(k):
  mjm = _pile(k)
  qpos = _states(mjm)
  jm = mjtpu.put_model(mjm)
  jd = jax.vmap(lambda _: mjtpu.make_data(jm))(jnp.arange(B)).replace(qpos=jnp.asarray(qpos))
  jc = jax.jit(lambda d: jax.vmap(mjtpu.fwd_position, in_axes=(None, 0))(jm, d))(jd).contact
  m = mjtpu_torch.put_model(mjm, device="cpu")
  d = mjtpu_torch.replace(mjtpu_torch.make_data(m, batch_size=B), qpos=torch.as_tensor(qpos))
  c = t_collision.collision(m, smooth.kinematics(m, d)).contact
  for f in ("geom1", "geom2", "dim", "efc_address"):
    np.testing.assert_array_equal(getattr(c, f).numpy(), np.asarray(getattr(jc, f)), err_msg=f)
  for f in ("dist", "pos", "frame", "includemargin", "margin", "friction", "solref",
            "solreffriction", "solimp"):
    np.testing.assert_allclose(getattr(c, f).numpy(), np.asarray(getattr(jc, f)), rtol=0,
                               atol=1e-12, err_msg=f)
  # the three far spheres tie on the plane bound: the lower pairs win
  if k == 4:
    assert c.geom.numpy()[0, :4].tolist() == [[0, 1], [0, 3], [0, 4], [0, 5]]


def test_compacted_steps_track_uncompacted():
  """With K at least the touching pairs, the compacted model's 50 steps
  equal the uncompacted model's (tests/test_broadphase.py's parity test,
  on the port)."""
  full, bp = (mjtpu_torch.put_model(_pile(k), device="cpu") for k in (None, 6))
  qpos = torch.as_tensor(_states(_pile(None)))
  d_full, d_bp = (mjtpu_torch.replace(mjtpu_torch.make_data(m, batch_size=B), qpos=qpos)
                  for m in (full, bp))
  for i in range(50):
    d_full, d_bp = mjtpu_torch.step(full, d_full), mjtpu_torch.step(bp, d_bp)
    err = float((d_full.qpos - d_bp.qpos).abs().max())
    assert err < 1e-12, f"step {i + 1}: {err:.3e}"


@pytest.mark.parametrize("condim", [4, 6])
def test_put_model_refuses_condim_by_name(condim):
  """Condim 4 and 6 contacts, refused until the cone slice, now build and
  step (the name is kept from then): the contact's efc rows are those of
  its condim."""
  mjm = load_mj("condim4_pyramidal.xml")
  mjm.geom_condim[:] = condim
  m = mjtpu_torch.put_model(mjm, device="cpu")
  assert mjtpu_torch.count_constraints(m)[3] == 2 * (condim - 1)
  d = mjtpu_torch.step(m, mjtpu_torch.make_data(m, batch_size=2))
  assert bool(torch.isfinite(d.qpos).all())
