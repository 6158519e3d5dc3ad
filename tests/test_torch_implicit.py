"""The full Implicit integrator and the fluid forces' velocity derivative
(derivative.deriv_smooth_vel with rne, forward.implicit's unsymmetrized
LU) against mjtpu at float64 on the CPU, from the committed goldens.

  * humanoid_implicit (the zoo's humanoid.xml under Implicit,
    humanoid_implicit_model.npz and _golden.npz) and the implicit scene
    bundle (implicit_scenes.npz, implicit_scenes_golden.npz,
    scripts/torch_port_assets.py): implicit_full.xml (a forest: the
    blocked LU), implicit_fluid.xml, tests/test_fluid.py's ellipsoid-fluid
    scene under Implicit and ImplicitFast, the swimmer under ImplicitFast,
    friction_tendon.xml and condim4_elliptic.xml under Implicit, two
    implicit fuzz scenes (chip_smoke.slice14_errors, which phase 30 runs on
    the card): step 1's qDeriv and its fluid term alone to 1e-10 of scale,
    the implicit update and qacc to 1e-10, 100 steps to 1e-8;
  * qDeriv from rest and from moving states apart, the RNE term nonzero;
  * where mjtpu parts from MuJoCo C: the box fluid model's ImplicitFast
    derivative (ROADMAP C14) and the ellipsoid model's at rest (C15);
  * the enable flags OVERRIDE, FWDINV and INVDISCRETE accepted, and
    flex, by name.
"""

import mujoco
import numpy as np
import pytest
import torch

import chip_smoke
import mjtpu_torch
from mjtpu_torch._src import derivative, io, smooth
from tests.test_torch_assets import _assets_script

torch.set_num_threads(1)

SCENES = mjtpu_torch.ASSETS / "implicit_scenes.npz"
GOLDEN = mjtpu_torch.ASSETS / "implicit_scenes_golden.npz"
NAMES = ("condim4_elliptic_implicit", "ellipsoid_implicit", "ellipsoid_implicitfast",
         "friction_tendon_implicit", "fuzz_0", "fuzz_1", "implicit_fluid",
         "implicit_fluid_implicitfast", "implicit_full", "swimmer_implicitfast")
# implicit_fluid.xml's qvel under ImplicitFast parts from MuJoCo C's by at
# least this over 100 steps (ROADMAP C14: C linearizes the box fluid model
# approximately, mjtpu exactly)
C14_GAP = 1e-6


@pytest.fixture(scope="module")
def golden():
  return dict(np.load(GOLDEN))


@pytest.fixture(scope="module")
def humanoid():
  return dict(np.load(mjtpu_torch.ASSETS / "humanoid_implicit_golden.npz"))


def _assert_within(errs, what):
  bad = chip_smoke.slice14_over(errs)
  assert not bad, (what, bad)


def test_bundle_holds_the_scenes():
  assert tuple(io.bundle_names(SCENES)) == NAMES
  assert sorted(_assets_script().implicit_scene_xmls()) == list(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_scene_matches_mjtpu(golden, name):
  """Step 1's qDeriv (and its fluid term), the implicit update, qacc, and
  100 steps against mjtpu's golden at the bounds of
  chip_smoke.slice14_errors."""
  errs = chip_smoke.slice14_errors("implicit", name, golden, "cpu")
  _assert_within(errs, name)
  assert "deriv" in errs and errs["ties"] == 0


def test_humanoid_implicit_matches_mjtpu(humanoid):
  """humanoid_implicit (nv 23, one tree, Newton 8 x 8): qDeriv with the
  RNE term, the update through the dense LU, and 100 steps."""
  errs = chip_smoke.slice14_errors("humanoid_implicit", None, humanoid, "cpu")
  _assert_within(errs, "humanoid_implicit")


@pytest.mark.parametrize("kind, name", [("humanoid_implicit", None),
                                        ("implicit", "implicit_fluid"),
                                        ("implicit", "implicit_full")],
                         ids=["humanoid_implicit", "implicit_fluid", "implicit_full"])
def test_qderiv_from_rest_and_moving(golden, humanoid, kind, name):
  """qDeriv (and the fluid term alone) of the envs at rest (0, 1) and of
  the moving ones (2, 3) apart, each to 1e-10 of its own scale; the RNE
  term is zero at rest and not when moving."""
  g = humanoid if kind == "humanoid_implicit" else golden
  prefix = "" if name is None else f"{name}."
  m, _ = chip_smoke.slice14_scene(kind, name, g, "cpu")
  ref = mjtpu_torch.data_from_mjtpu(chip_smoke.golden_fwd(g, prefix), device="cpu")
  assert not g[f"{prefix}qvel0"][:2].any() and g[f"{prefix}qvel0"][2:].all()
  got = mjtpu_torch.deriv_smooth_vel(m, ref, rne=True).numpy()
  fluid, bias = derivative._velocity_jacobians(m, ref, m.opt.has_fluid_params, True)
  for envs in (slice(0, 2), slice(2, 4)):
    want = g[f"{prefix}deriv"][envs]
    assert chip_smoke._scaled_err(got[envs], want) <= chip_smoke.SLICE14_STEP_BOUND
    if fluid is not None:
      assert chip_smoke._scaled_err(fluid.numpy()[envs], g[f"{prefix}deriv.fluid"][envs]) \
          <= chip_smoke.SLICE14_STEP_BOUND
  assert np.abs(bias.numpy()[:2]).max() == 0.0 and np.abs(bias.numpy()[2:]).max() > 0.0


def test_forest_takes_the_blocked_lu(golden):
  """implicit_full.xml is a forest (a double pendulum, a free box, a ball
  joint): qM - h qDeriv is solved per tree, and matches mjtpu's update."""
  m, _ = chip_smoke.slice14_scene("implicit", "implicit_full", golden, "cpu")
  assert smooth.mass_blocks(m) == ((0, 2), (2, 6), (8, 3))
  ref = mjtpu_torch.data_from_mjtpu(chip_smoke.golden_fwd(golden, "implicit_full."), device="cpu")
  got = mjtpu_torch.implicit(m, ref)
  np.testing.assert_allclose(got.qvel.numpy(), golden["implicit_full.qvel"][0], rtol=0,
                             atol=chip_smoke.SLICE14_STEP_BOUND)


@pytest.mark.parametrize("name", ["implicit_fluid_implicitfast", "swimmer_implicitfast"])
def test_box_fluid_implicitfast_follows_mjtpu(golden, name):
  """ROADMAP C14: under ImplicitFast, MuJoCo C linearizes the box fluid
  model approximately and mjtpu takes its exact Jacobian.  The port holds
  mjtpu (test_scene_matches_mjtpu); on implicit_fluid.xml (a ball joint
  and a free body in the medium) C parts from mjtpu's golden by more than
  C14_GAP over the 100 steps, while on the swimmer (a planar chain, one
  hinge a link) it does not part at all (below 1e-12)."""
  mjm = mujoco.MjModel.from_xml_string(_assets_script().implicit_scene_xmls()[name])
  gap = 0.0
  for e in range(golden[f"{name}.qpos0"].shape[0]):
    mjd = mujoco.MjData(mjm)
    for k in ("qpos", "qvel", "ctrl"):
      getattr(mjd, k)[:] = golden[f"{name}.{k}0"][e]
    for t in range(golden[f"{name}.qvel"].shape[0]):
      mujoco.mj_step(mjm, mjd)
      gap = max(gap, float(np.abs(mjd.qvel - golden[f"{name}.qvel"][t, e]).max()))
  assert gap > C14_GAP if name == "implicit_fluid_implicitfast" else gap < 1e-12


def test_ellipsoid_fluid_at_rest_is_nan_as_in_mjtpu():
  """ROADMAP C15: at rest the ellipsoid model's angular drag
  rho w |M w| has no forward-mode derivative (sqrt at 0 times 0): mjtpu's
  jacfwd qDeriv is NaN there (every entry, through the chain mask's
  products), and so is the port's, entry for entry; finite entries, where
  there are any, agree to 1e-10 of scale."""
  import jax
  import jax.numpy as jnp

  import mjtpu
  from mjtpu._src import derivative as j_derivative

  xml = _assets_script().ELLIPSOID_FLUID_XML.format(integ="implicit")
  mjm = mujoco.MjModel.from_xml_string(xml)
  jm = mjtpu.put_model(mjm, dtype=jnp.float64)
  jd = jax.jit(mjtpu.forward)(jm, mjtpu.make_data(jm))
  want = np.asarray(jax.jit(lambda d: j_derivative.deriv_smooth_vel(jm, d, rne=True))(jd))
  m = mjtpu_torch.put_model(mjm, device="cpu")
  got = mjtpu_torch.deriv_smooth_vel(m, mjtpu_torch.forward(m, mjtpu_torch.make_data(m, 1)),
                                     rne=True)[0].numpy()
  assert np.isnan(want).any()
  np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
  ok = ~np.isnan(want)
  if ok.any():
    assert chip_smoke._scaled_err(got[ok], want[ok]) <= chip_smoke.SLICE14_STEP_BOUND


@pytest.mark.parametrize("flag", ["OVERRIDE", "FWDINV", "INVDISCRETE"])
def test_remaining_enable_flags_refused_by_name(flag):
  """The enable flags that stayed refused until inverse dynamics came to
  the port now build, and a step under each equals the step without it
  bit for bit, as in mjtpu: none of them changes forward dynamics there
  (OVERRIDE is read nowhere, ROADMAP C17; FWDINV and INVDISCRETE act in
  mj_inverse only)."""
  path = str(chip_smoke.ROOT / "tests" / "models" / "pendulum.xml")
  mjm = mujoco.MjModel.from_xml_path(path)
  mjm.opt.enableflags = int(getattr(mujoco.mjtEnableBit, f"mjENBL_{flag}"))
  m = mjtpu_torch.put_model(mjm, device="cpu")
  assert m.opt.enableflags & int(getattr(mjtpu_torch.EnableBit, flag))
  m0 = mjtpu_torch.put_model(mujoco.MjModel.from_xml_path(path), device="cpu")
  qvel = torch.as_tensor(np.random.default_rng(0).uniform(-0.5, 0.5, (2, m.nv)))
  d, d0 = (mjtpu_torch.replace(mjtpu_torch.make_data(mm, 2), qvel=qvel) for mm in (m, m0))
  for _ in range(3):
    d, d0 = mjtpu_torch.step(m, d), mjtpu_torch.step(m0, d0)
  assert torch.equal(d.qpos, d0.qpos) and torch.equal(d.qvel, d0.qvel)


def test_flex_refused_by_name():
  mjm = mujoco.MjModel.from_xml_string("""<mujoco><worldbody>
    <flexcomp name="f" type="grid" count="2 2 1" spacing="0.1 0.1 0.1" dim="2"/>
    </worldbody></mujoco>""")
  assert mjm.nflex
  with pytest.raises(NotImplementedError, match="flex objects"):
    mjtpu_torch.put_model(mjm, device="cpu")
