"""mjtpu_torch.inverse against mjtpu.inverse and MuJoCo C's mj_inverse.

The inverse scenes (inverse_scenes.npz: tests/test_inverse.py's pendulum,
ball_free and spheres; its damped arm with INVDISCRETE under Euler,
ImplicitFast and Implicit; capsules.xml under FWDINV; the 66-dof branchy
tree with INVDISCRETE, whose factor_m and discrete_acc's solve_m take
kernel B2's plain twin here) run at f64 on the CPU against mjtpu's outputs
in the committed golden, within INVERSE_BOUND of each field's scale, with
the caller's qacc restored; mjtpu's own bounds against C hold too.
"""

import mujoco
import numpy as np
import pytest
import torch

import chip_smoke
import mjtpu_torch
from mjtpu_torch._src import inverse as inverse_mod
from mjtpu_torch._src import io
from tests.conftest import load_mj

SCENES = io.bundle_names(mjtpu_torch.ASSETS / "inverse_scenes.npz")
# tests/test_inverse.py's bounds against MuJoCo C: the continuous scenes
# (absolute), the discrete ones (absolute and relative)
C_BOUND = 5e-6
C_DISCRETE_BOUND = 1e-8


@pytest.fixture(scope="module")
def golden():
  return np.load(mjtpu_torch.ASSETS / "inverse_scenes_golden.npz")


@pytest.mark.parametrize("name", SCENES)
def test_scene_matches_mjtpu(name, golden):
  errs = chip_smoke.inverse_scene_errors(name, golden, "cpu")
  worst = max(v for k, v in errs.items() if k in chip_smoke.INVERSE_FIELDS)
  assert worst <= chip_smoke.INVERSE_BOUND, errs
  assert errs["qacc_restored"], errs
  c = golden[f"{name}.c_qfrc_inverse"]
  bound = C_DISCRETE_BOUND * (1 + np.abs(c).max()) if name.startswith("discrete") else C_BOUND
  assert errs["c"] <= bound, errs


def test_scenes_cover_every_integrator_and_the_flags():
  names = set(SCENES)
  assert {"discrete_euler", "discrete_implicitfast", "discrete_implicit", "fwdinv",
          "branchy66"} <= names
  m = chip_smoke._bundle_model("inverse_scenes", "branchy66", "cpu")
  assert m.opt.enableflags & mjtpu_torch.EnableBit.INVDISCRETE and m.has_dof_damping
  from mjtpu_torch._src import sparse

  # the tree takes the sparse LDL (kernel B2 on the card)
  assert sparse.tables(m) is not None


def test_rk4_discrete_inverse_raises():
  mjm = load_mj("pendulum_rk4.xml")
  mjm.opt.enableflags |= mujoco.mjtEnableBit.mjENBL_INVDISCRETE
  m = mjtpu_torch.put_model(mjm, device="cpu")
  with pytest.raises(NotImplementedError, match="RK4"):
    mjtpu_torch.inverse(m, mjtpu_torch.make_data(m, 2))


def test_forward_then_inverse_recovers_the_applied_force():
  """forward, then inverse from its qacc, gives back qfrc_applied (the
  FWDINV consistency mjtpu's test checks), on contacts."""
  mjm = load_mj("capsules.xml")
  mjm.opt.enableflags |= mujoco.mjtEnableBit.mjENBL_FWDINV
  m = mjtpu_torch.put_model(mjm, device="cpu")
  rng = np.random.default_rng(1)
  qfrc = torch.as_tensor(rng.uniform(-1, 1, (2, m.nv)))
  d = mjtpu_torch.replace(mjtpu_torch.make_data(m, 2), qfrc_applied=qfrc,
                          qvel=torch.as_tensor(rng.uniform(-0.2, 0.2, (2, m.nv))))
  d = mjtpu_torch.forward(m, d)
  out = mjtpu_torch.inverse(m, d)
  assert float((out.qfrc_inverse - qfrc).abs().max()) <= 1e-6


def test_discrete_acc_undoes_the_euler_damping():
  """discrete_acc of the damped qacc Euler takes gives back the smooth
  (undamped) acceleration of the same forces, up to rounding."""
  mjm = load_mj("pendulum.xml")
  m = mjtpu_torch.put_model(mjm, device="cpu")
  assert m.has_dof_damping
  rng = np.random.default_rng(0)
  d = mjtpu_torch.replace(mjtpu_torch.make_data(m, 2),
                          qvel=torch.as_tensor(rng.uniform(-0.5, 0.5, (2, m.nv))))
  d = mjtpu_torch.forward(m, d)
  stepped = mjtpu_torch.step(m, d)
  undone = inverse_mod.discrete_acc(m, mjtpu_torch.replace(d, qacc=stepped.qacc))
  assert float((undone - d.qacc).abs().max()) <= 1e-12
