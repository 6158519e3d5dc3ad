"""mjtpu_torch's public names, checkpoints, MjData write-back and enable
flags against mjtpu's, at f64 on the CPU.

Also pins ROADMAP C17: under EnableBit.OVERRIDE MuJoCo C mixes a
contact's solref, solimp and margin from opt.o_*, while mjtpu carries the
three fields and reads them nowhere; the port follows mjtpu.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import chip_smoke
import mjtpu
import mjtpu_torch
from mjtpu_torch._src import math as t_math
from tests.conftest import load_mj

OVERRIDE_XML = """<mujoco><option timestep="0.005"/><worldbody>
<geom type="plane" size="5 5 .1"/>
<body pos="0 0 0.1"><freejoint/><geom type="sphere" size="0.1"/></body>
<body pos="0.5 0 0.1"><freejoint/><geom type="box" size="0.1 0.1 0.1"/></body>
</worldbody></mujoco>"""
# how far MuJoCo C's qvel parts from mjtpu's over OVERRIDE_STEPS under the
# override (the probe measured 1.25), and how close the port holds mjtpu
OVERRIDE_C_SPLIT = 1e-2
OVERRIDE_STEPS = 50


def test_public_names():
  public = {n for n in dir(mjtpu) if not n.startswith("_")} - {"parallel", "zoo"}
  missing = sorted(n for n in public if not hasattr(mjtpu_torch, n))
  assert not missing, missing
  for n in ("randomize", "model_axes", "randomize_with_consts", "randomized_step"):
    assert callable(getattr(mjtpu_torch.parallel, n))
  assert mjtpu_torch.device_get_into is mjtpu_torch.get_data_into
  assert mjtpu_torch.scan.flat is not None and mjtpu_torch.scan.body_tree is not None


# a sphere and a box sunk 5 mm into the floor, and a limited hinge with
# frictionloss: contact, friction and limit rows
CONTACT_XML = """<mujoco><worldbody><geom type="plane" size="5 5 .1"/>
<body pos="0 0 0.095"><freejoint/><geom type="sphere" size="0.1"/></body>
<body pos="0.5 0 0.095"><freejoint/><geom type="box" size="0.1 0.1 0.1"/></body>
<body pos="2 0 1"><joint type="hinge" axis="0 1 0" limited="true" range="-0.01 0.01"
frictionloss="0.1"/><geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.03"/></body>
</worldbody></mujoco>"""


def _pair(name="capsules.xml", batch=3, seed=0):
  """The same forward states in mjtpu (a list of unbatched Data) and the
  port (one batched Data)."""
  mjm = mujoco.MjModel.from_xml_string(CONTACT_XML) if name == "contact" else load_mj(name)
  jm = mjtpu.put_model(mjm)
  m = mjtpu_torch.put_model(mjm, device="cpu")
  rng = np.random.default_rng(seed)
  qvel = rng.uniform(-0.3, 0.3, (batch, mjm.nv))
  fwd = jax.jit(mjtpu.forward)
  jds = [fwd(jm, mjtpu.make_data(jm).replace(qvel=jnp.asarray(qvel[b]))) for b in range(batch)]
  d = mjtpu_torch.forward(m, mjtpu_torch.replace(mjtpu_torch.make_data(m, batch),
                                                 qvel=torch.as_tensor(qvel)))
  return mjm, jm, m, jds, d


def test_mass_matrix_names_and_apply_ft():
  _, jm, m, jds, d = _pair()
  rng = np.random.default_rng(1)
  vec = rng.uniform(-1, 1, (len(jds), m.nv))
  force, torque, point = (rng.uniform(-1, 1, (len(jds), 3)) for _ in range(3))
  body = 2
  full = mjtpu_torch.full_m(m, d).numpy()
  mul = mjtpu_torch.mul_m(m, d, torch.as_tensor(vec)).numpy()
  ft = mjtpu_torch.apply_ft(m, d, *(torch.as_tensor(x) for x in (force, torque, point)),
                            body).numpy()
  for b, jd in enumerate(jds):
    np.testing.assert_allclose(full[b], np.asarray(mjtpu.full_m(jm, jd)), atol=1e-12, rtol=0)
    np.testing.assert_allclose(mul[b], np.asarray(mjtpu.mul_m(jm, jd, jnp.asarray(vec[b]))),
                               atol=1e-12, rtol=0)
    want = mjtpu.apply_ft(jm, jd, jnp.asarray(force[b]), jnp.asarray(torque[b]),
                          jnp.asarray(point[b]), body)
    np.testing.assert_allclose(ft[b], np.asarray(want), atol=1e-12, rtol=0)
  assert mjtpu_torch.is_sparse(m) == mjtpu.is_sparse(jm)


def test_random_unit_quat():
  """quat_from_uniform is mjtpu's arithmetic on the same uniform samples;
  random_unit_quat draws unit quaternions from a torch.Generator,
  the same for the same seed."""
  key = jax.random.PRNGKey(3)
  want = np.asarray(mjtpu.random_unit_quat(key, (5,)))
  u = np.asarray(jax.random.uniform(key, (5, 3)))
  np.testing.assert_allclose(t_math.quat_from_uniform(torch.as_tensor(u.copy())).numpy(), want,
                             atol=1e-15, rtol=0)
  q = [mjtpu_torch.random_unit_quat(torch.Generator().manual_seed(7), (4, 2)) for _ in range(2)]
  assert q[0].shape == (4, 2, 4) and torch.equal(q[0], q[1])
  np.testing.assert_allclose(torch.linalg.norm(q[0], dim=-1).numpy(), 1.0, atol=1e-15)


def test_logger_level_from_the_environment():
  out = subprocess.run(
      [sys.executable, "-c", "import mjtpu_torch; print(mjtpu_torch.mujoco_logger.level)"],
      env={**os.environ, "MJTPU_LOGGING_LEVEL": "debug"}, capture_output=True, text=True,
      check=True, cwd=chip_smoke.ROOT)
  assert out.stdout.strip().splitlines()[-1] == "10"
  assert mjtpu_torch.mujoco_logger.name == "mjtpu_torch"


def test_checkpoint_round_trip(tmp_path):
  _, _, m, _, d = _pair()
  path = tmp_path / "ckpt.npz"
  mjtpu_torch.save_checkpoint(path, d)
  back = mjtpu_torch.load_checkpoint(path, mjtpu_torch.make_data(m, d.batch_size))
  for a, b in zip(mjtpu_torch._src.io._leaves(back), mjtpu_torch._src.io._leaves(d)):
    assert a.dtype == b.dtype and torch.equal(a, b)


def test_load_mjtpu_checkpoint(tmp_path):
  """A checkpoint mjtpu wrote, of a batched Data (vmap) and of one env,
  loads field by field."""
  _, jm, m, jds, _ = _pair()
  batched = jax.tree.map(lambda *x: jnp.stack(x), *jds)
  for jd, batch in ((batched, len(jds)), (jds[1], 1)):
    path = tmp_path / f"mjtpu{batch}.npz"
    mjtpu.save_checkpoint(str(path), jd)
    got = mjtpu_torch.load_checkpoint(path, mjtpu_torch.make_data(m, batch))
    # one env's Data as a batch of one
    lead = (lambda x: np.asarray(x)[None]) if batch == 1 else np.asarray
    want = mjtpu_torch.data_from_mjtpu(jax.tree.map(lead, jd), device="cpu")
    for f in dataclasses.fields(mjtpu_torch.Data):
      a, b = getattr(got, f.name), getattr(want, f.name)
      if f.name == "contact":
        for c in dataclasses.fields(mjtpu_torch.Contact):
          np.testing.assert_array_equal(getattr(a, c.name).numpy(), getattr(b, c.name).numpy())
      else:
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("sort_contacts", [False, True])
def test_get_data_into_writes_contacts_and_efc_rows(sort_contacts):
  """The port's get_data_into fills each MjData's contacts and efc rows as
  mjtpu's does from the same state (CONTACT_XML), in the collider groups'
  order or sorted by geom pair."""
  mjm, jm, m, jds, d = _pair("contact", seed=2)
  got = [mujoco.MjData(mjm) for _ in jds]
  want = [mujoco.MjData(mjm) for _ in jds]
  mjtpu_torch.get_data_into(got, m, d, sort_contacts=sort_contacts)
  for w, jd in zip(want, jds):
    mjtpu.get_data_into(w, jm, jd, sort_contacts=sort_contacts)
  assert any(g.ncon for g in got)
  for g, w in zip(got, want):
    assert (g.ncon, g.nefc, g.ne, g.nf, g.nl) == (w.ncon, w.nefc, w.ne, w.nf, w.nl)
    for name in ("dist", "pos", "frame", "friction", "solref", "solimp", "includemargin"):
      np.testing.assert_allclose(getattr(g.contact, name), getattr(w.contact, name), atol=1e-12)
    for name in ("dim", "geom1", "geom2", "exclude", "efc_address"):
      np.testing.assert_array_equal(getattr(g.contact, name), getattr(w.contact, name))
    for name in ("efc_type", "efc_id"):
      np.testing.assert_array_equal(getattr(g, name), getattr(w, name))
    for name in ("efc_pos", "efc_margin", "efc_D", "efc_aref", "efc_force", "efc_J", "qacc"):
      np.testing.assert_allclose(getattr(g, name), getattr(w, name), atol=1e-10)


def _override_runs():
  """(C's, mjtpu's and the port's qvel over OVERRIDE_STEPS steps from one
  seeded state) with OVERRIDE on and o_solref and o_solimp unlike the
  geoms'."""
  mjm = mujoco.MjModel.from_xml_string(OVERRIDE_XML)
  mjm.opt.enableflags |= mujoco.mjtEnableBit.mjENBL_OVERRIDE
  mjm.opt.o_solref[:] = [0.1, 0.5]
  mjm.opt.o_solimp[:] = [0.5, 0.8, 0.01, 0.5, 2]
  mjd = mujoco.MjData(mjm)
  mjd.qvel[:] = np.random.default_rng(0).uniform(-0.5, 0.5, mjm.nv)
  jm = mjtpu.put_model(mjm)
  jd = mjtpu.put_data(jm, mjd)
  m = mjtpu_torch.put_model(mjm, device="cpu")
  d = mjtpu_torch.put_data(m, [mjd])
  step = jax.jit(mjtpu.step)
  out = {"c": [], "mjtpu": [], "port": []}
  for _ in range(OVERRIDE_STEPS):
    mujoco.mj_step(mjm, mjd)
    jd, d = step(jm, jd), mjtpu_torch.step(m, d)
    out["c"].append(mjd.qvel.copy())
    out["mjtpu"].append(np.asarray(jd.qvel))
    out["port"].append(d.qvel[0].numpy())
  return m, {k: np.stack(v) for k, v in out.items()}


def test_override_follows_mjtpu_not_mujoco_c():
  """ROADMAP C17: the port carries o_margin, o_solref and o_solimp and,
  as mjtpu, does not read them: within 1e-10 of mjtpu, while C parts from
  mjtpu by more than OVERRIDE_C_SPLIT."""
  m, runs = _override_runs()
  np.testing.assert_allclose(m.opt.o_solref.numpy(), [0.1, 0.5])
  assert float(np.abs(runs["port"] - runs["mjtpu"]).max()) <= 1e-10
  assert float(np.abs(runs["c"] - runs["mjtpu"]).max()) > OVERRIDE_C_SPLIT


def test_fwdinv_leaves_forward_as_it_is():
  """FWDINV changes no output of MuJoCo C's mj_forward that the port
  computes (qacc, qfrc_constraint), nor the port's forward."""
  mjm = load_mj("capsules.xml")
  out = []
  for flag in (0, int(mujoco.mjtEnableBit.mjENBL_FWDINV)):
    mjm.opt.enableflags = flag
    mjd = mujoco.MjData(mjm)
    mjd.qvel[:] = 0.3
    mujoco.mj_forward(mjm, mjd)
    m = mjtpu_torch.put_model(mjm, device="cpu")
    d = mjtpu_torch.forward(m, mjtpu_torch.put_data(m, [mjd]))
    out.append((mjd.qacc.copy(), mjd.qfrc_constraint.copy(), d.qacc.numpy()))
  for a, b in zip(*out):
    np.testing.assert_array_equal(a, b)
