"""Dof frictionloss rows through mjtpu_torch against mjtpu at float64 on
the CPU, and the refusals that stay.

Scenes (cone_scenes.npz, with mjtpu's golden from
scripts/torch_port_assets.py): test_solver.py's frictionloss slide joint
pushed by 10, 1, -10 and 0.5 N (its saturated and its partial regime,
both ways); two hinges with frictionloss and limits beside an elliptic
condim-6 sphere, with jointlimitfrc and touch sensors; and
tests/test_fuzz.py::test_fuzz_elliptic_cone's scenes (create_mjcf(seed +
500, cone="elliptic", contact_pairs=True, frictionloss=(seed % 2 == 0)))
that put_model takes.  Held to STAGE_BOUND of each field's scale for
make_constraint (efc_frictionloss too), solve and the contact wrenches
from mjtpu's forward Data, and to TRAJECTORY_BOUND (sensordata: of each
sensor's scale) over the first SCENE_STEPS steps (chip_smoke.py holds the
frictionloss scenes' 100 on the card, the fuzz scenes' 25).

The fuzz scenes' solves run to opt.tolerance (1e-8) through elliptic
middle zones, where the linesearch's last rounds land on Newton candidates
whose phi' is zero but for rounding: its sign, a few ULP of 1e6-sized
sums, picks the iterate (ROADMAP C7).  In fuzz_4's env 3 the port and
mjtpu take opposite signs in the first Newton iteration and end 2.0e-9 of
scale apart in qacc and 1.8e-8 in qfrc_constraint, so the fuzz scenes'
solve is held to FUZZ_SOLVE_BOUND;
the same ties part the trajectories of fuzz_3 (1.9e-8 in qvel) and of
frictionloss_chain (4.1e-8 of scale in sensordata) within SCENE_STEPS, held
to FUZZ_TRAJECTORY_BOUND (measured on an x86 CPU).
"""

import importlib.util
import pathlib

import mujoco
import numpy as np
import pytest
import torch

import mjtpu
from mjtpu._src import support as j_support
from mjtpu._src.test_util import create_mjcf
import mjtpu_torch
from mjtpu_torch._src import io, sensor, support
from mjtpu_torch._src.types import ConstraintType, DisableBit
from tests.conftest import load_mj
from tests.test_torch_elliptic import (
    SCENE_STEPS, SCENES, STAGE_BOUND, TRAJECTORY_BOUND, assert_contact_forces, assert_stages,
    fwd_data, run_trajectory)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FUZZ = [f"fuzz_{seed}" for seed in (0, 1, 3, 4)]
SCENES_HERE = ("frictionloss_slide", "frictionloss_chain", *FUZZ)
FUZZ_SOLVE_BOUND = 1e-7
FUZZ_TRAJECTORY_BOUND = 1e-7


def _script():
  spec = importlib.util.spec_from_file_location(
      "torch_port_assets", ROOT / "scripts" / "torch_port_assets.py")
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def _fuzz_xml(seed: int) -> str:
  return create_mjcf(seed + 500, geom_types=("sphere", "capsule"), cone="elliptic",
                     contact_pairs=True, frictionloss=(seed % 2 == 0))


def _xml(name: str) -> str:
  if name.startswith("fuzz_"):
    return _fuzz_xml(int(name[5:]))
  return {"frictionloss_slide": _script().FRICTIONLOSS_SLIDE_XML,
          "frictionloss_chain": _script().FRICTIONLOSS_CHAIN_XML}[name]


@pytest.fixture(scope="module")
def golden():
  return dict(np.load(mjtpu_torch.ASSETS / "cone_scenes_golden.npz"))


def _model(name):
  return mjtpu_torch.model_from_arrays(io.load_snapshot(SCENES, name), device="cpu")


def test_frictionloss_saturation(golden):
  """The slide joint pushed by 10, 1, -10 and 0.5 N: qacc and the friction
  row's force equal MuJoCo C's (1e-8, as tests/test_solver.py holds
  mjtpu), the saturated rows sit at exactly -+frictionloss, and the
  partial ones resist less."""
  mjm = mujoco.MjModel.from_xml_string(_xml("frictionloss_slide"))
  m = mjtpu_torch.put_model(mjm, device="cpu")
  push = golden["frictionloss_slide.qfrc_applied0"]
  d = mjtpu_torch.replace(mjtpu_torch.make_data(m, batch_size=len(push)),
                          qfrc_applied=torch.as_tensor(push))
  d = mjtpu_torch.forward(m, d)
  assert mjtpu_torch.count_constraints(m) == (0, 1, 0, 1)
  np.testing.assert_array_equal(d.efc_frictionloss.numpy(), 3.0)
  force = d.efc_force.numpy()[:, 0]
  for e, f in enumerate(push[:, 0]):
    mjd = mujoco.MjData(mjm)
    mjd.qfrc_applied[0] = f
    mujoco.mj_forward(mjm, mjd)
    np.testing.assert_allclose(d.qacc.numpy()[e], mjd.qacc, rtol=0, atol=1e-8)
    np.testing.assert_allclose(force[e], mjd.efc_force[0], rtol=0, atol=1e-8)
  assert force[0] == -3.0 and force[2] == 3.0
  assert 0 < -force[1] < 1.0 and 0 < -force[3] < 0.5


def test_fuzz_scenes_accepted():
  """test_fuzz_elliptic_cone's five scenes build: none is refused for a
  feature of this slice (elliptic cones, condim 4/6, dof frictionloss);
  the golden holds the four that built in this slice (seed 2, Euler's
  damping on two trees, builds since the tendon slice's blocked solve)."""
  accepted = []
  for seed in range(5):
    try:
      mjtpu_torch.put_model(mujoco.MjModel.from_xml_string(_fuzz_xml(seed)), device="cpu")
    except NotImplementedError as e:
      print(f"fuzz seed {seed}: refused: {e}")
      for feature in ("elliptic", "condim", "frictionloss"):
        assert feature not in str(e), (seed, str(e))
      continue
    accepted.append(f"fuzz_{seed}")
  assert accepted == [f"fuzz_{seed}" for seed in range(5)]
  assert set(FUZZ) == set(accepted) - {"fuzz_2"} and set(FUZZ) <= set(io.bundle_names(SCENES))


@pytest.mark.parametrize("name", SCENES_HERE)
def test_scene_stages(golden, name):
  """make_constraint (efc_frictionloss too), solve and the contact
  wrenches from mjtpu's forward Data; the layout equals mjtpu's."""
  mjm = mujoco.MjModel.from_xml_string(_xml(name))
  m = _model(name)
  jm = mjtpu.put_model(mjm)
  assert mjtpu_torch.count_constraints(m) == j_support.count_constraints(jm)
  for a, b in zip(support.efc_row_meta(m), j_support.efc_row_meta(jm)):
    np.testing.assert_array_equal(a, b)
  fwd = fwd_data(golden, f"{name}.")
  if name != "frictionloss_slide":
    assert (fwd.contact.dist < 0).any()
  assert_stages(m, fwd, name, FUZZ_SOLVE_BOUND if name.startswith("fuzz_") else STAGE_BOUND)
  if mjtpu_torch.constraint_sizes(m)[3]:
    assert_contact_forces(m, mjm, fwd, name)


@pytest.mark.parametrize("name", SCENES_HERE)
def test_scene_trajectory(golden, name):
  m = _model(name)
  fields = ("qpos", "qvel") + (("sensordata",) if m.nsensordata else ())
  run, _, _ = run_trajectory(m, golden, f"{name}.", fields, steps=SCENE_STEPS)
  for f in fields:
    want = golden[f"{name}.{f}"][:SCENE_STEPS]
    # sensordata: each sensor's column to its own scale
    scale = np.maximum(1.0, np.abs(want).max(axis=(0, 1))) if f == "sensordata" else 1.0
    err = (np.abs(run[f] - want) / scale).max()
    bound = TRAJECTORY_BOUND if name == "frictionloss_slide" else FUZZ_TRAJECTORY_BOUND
    assert err <= bound, f"{name} {f}: {err:.3e}"


def test_jointlimitfrc_reads_rows_after_friction(golden):
  """With friction rows first, a jointlimitfrc sensor reads its joint's
  limit row at nf + its place among the limit rows, and reads it live."""
  m = _model("frictionloss_chain")
  ne, nf, nl, _ = mjtpu_torch.count_constraints(m)
  assert (ne, nf, nl) == (0, 2, 2)
  types, ids = support.efc_row_meta(m)
  assert list(types[:4]) == [ConstraintType.FRICTION_DOF] * 2 + [ConstraintType.LIMIT_JOINT] * 2
  assert list(ids[:4]) == [0, 1, 0, 1]
  np.testing.assert_array_equal(sensor._limit_rows(m, np.array([0, 1])), [[2, 2], [3, 3]])
  # the golden's jointlimitfrc readings are live and the port's follow them
  assert (golden["frictionloss_chain.sensordata"][..., :2] != 0).any()


def test_disabled_frictionloss_drops_the_rows():
  """DisableBit.FRICTIONLOSS: no friction rows, the layout of mjtpu's."""
  mjm = mujoco.MjModel.from_xml_string(_xml("frictionloss_chain"))
  mjm.opt.disableflags |= mujoco.mjtDisableBit.mjDSBL_FRICTIONLOSS
  m = mjtpu_torch.put_model(mjm, device="cpu")
  assert m.opt.disableflags & DisableBit.FRICTIONLOSS
  jm = mjtpu.put_model(mjm)
  assert mjtpu_torch.count_constraints(m) == j_support.count_constraints(jm)
  assert mjtpu_torch.count_constraints(m)[1] == 0
  for a, b in zip(support.efc_row_meta(m), j_support.efc_row_meta(jm)):
    np.testing.assert_array_equal(a, b)
  d = mjtpu_torch.forward(m, mjtpu_torch.make_data(m, batch_size=2))
  assert not d.efc_frictionloss.any() and bool(torch.isfinite(d.qacc).all())


def _ball_limit():
  mjm = load_mj("ball_free.xml")
  ball = np.nonzero(mjm.jnt_type == mujoco.mjtJoint.mjJNT_BALL)[0][0]
  mjm.jnt_limited[ball] = 1
  mjm.jnt_range[ball] = (0.0, 0.5)
  return mjm


def _implicit():
  mjm = load_mj("condim4_elliptic.xml")
  mjm.opt.integrator = mujoco.mjtIntegrator.mjINT_IMPLICIT
  return mjm


def _tendon_implicit():
  mjm = load_mj("friction_tendon.xml")
  mjm.opt.integrator = mujoco.mjtIntegrator.mjINT_IMPLICIT
  return mjm


@pytest.mark.parametrize("make, what", [
    (lambda: load_mj("friction_tendon.xml"), (0, 2, 2, 4)),
    (_ball_limit, (0, 0, 1, 1)),
    (_implicit, (0, 0, 0, 4)),
    (lambda: load_mj("equality.xml"), (4, 0, 0, 4)),
    (_tendon_implicit, (0, 2, 2, 4)),
], ids=["tendon_frictionloss", "ball_limit", "implicit", "equality", "tendon_implicit"])
def test_put_model_still_refuses(make, what):
  """What a later slice took in builds and steps (what: its
  count_constraints, (ne, nf, nl, nefc)): friction_tendon.xml (dof
  frictionloss beside a limited fixed tendon, the tendon slice) with its
  two friction rows and its joint and tendon limit rows; ball_free.xml
  with a limited ball joint (one limit row) and equality.xml (a connect's
  3 rows and a joint coupling's 1), the equality slice; the full Implicit
  integrator on condim4_elliptic.xml (one condim-4 elliptic contact's 4
  rows) and on friction_tendon.xml, the Implicit slice.  A string is the
  name put_model refuses the model by."""
  if not isinstance(what, str):
    m = mjtpu_torch.put_model(make(), device="cpu")
    assert mjtpu_torch.count_constraints(m) == what
    d = mjtpu_torch.step(m, mjtpu_torch.make_data(m, batch_size=2))
    assert bool(torch.isfinite(d.qpos).all()) and int(d.nreset.sum()) == 0
    return
  with pytest.raises(NotImplementedError, match=what):
    mjtpu_torch.put_model(make(), device="cpu")


@pytest.mark.parametrize("name", ["condim4_elliptic.xml", "condim6_elliptic.xml",
                                  "frictionloss_chain"])
def test_put_model_takes_the_slice(name):
  """Elliptic cones, condim 4 and 6 and dof frictionloss build and step."""
  mjm = (mujoco.MjModel.from_xml_string(_xml(name)) if name == "frictionloss_chain"
         else load_mj(name))
  m = mjtpu_torch.put_model(mjm, device="cpu")
  d = mjtpu_torch.step(m, mjtpu_torch.make_data(m, batch_size=2))
  assert bool(torch.isfinite(d.qpos).all()) and int(d.nreset.sum()) == 0
