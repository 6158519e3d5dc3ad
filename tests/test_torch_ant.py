"""mjtpu/zoo/assets/ant_bench.xml through mjtpu_torch against mjtpu at
float64 on the CPU, and the Newton solver's early exit.

ant_bench is a fixed-base ant (torso welded to the world), Euler with
implicit joint damping, Newton with 100 iterations and 50 linesearch
rounds, 60 capsule-capsule contact slots and 20 sensors (9 touch, a
velocimeter, a gyro, an accelerometer, 8 rangefinders).  Held to the
committed golden (scripts/torch_port_assets.py), which needs no mjtpu run
here:

  * the sensor stages, subtree_vel and rne_postconstraint from mjtpu's own
    forward Data at the golden's 4 initial states, and the port's whole
    forward from those states, to 1e-10 of each field's scale;
  * the 100-step trajectory: qpos and qvel to 1e-8, sensordata to 1e-8 of
    each sensor's scale (its largest |value| in the golden, at least 1).

The four hip contacts (each leg's upper capsule against its aux capsule)
are degenerate: the two capsules' segments meet at the hinge point, so
the contact normal is the direction of a difference of rounding size and
the contact frame is arbitrary (ROADMAP C4).  The normal force and every
sensor are not; the frame, and through it cfrc_ext and cfrc_int, are
held from mjtpu's own contacts (the stage tests), not from the port's.

The Newton solver leaves its loops once no env runs on; that gives the
same bits as running them to their bounds (solver.EARLY_EXIT = False),
shown here on ant_bench and on humanoid_bench's benchmark configuration.
"""

import types

import numpy as np
import pytest
import torch

import mjtpu_torch
from mjtpu_torch._src import sensor, smooth, solver
from mjtpu_torch.ops import cholesky, fused

torch.set_num_threads(1)

GOLDEN = mjtpu_torch.ASSETS / "ant_bench_golden.npz"
SNAPSHOT = mjtpu_torch.ASSETS / "ant_bench_model.npz"
STEPS = 100
STAGE_BOUND = 1e-10
TRAJECTORY_BOUND = 1e-8
# the contact frame and what it feeds (module docstring)
FRAME_FIELDS = ("contact.frame", "cfrc_ext", "cfrc_int")


@pytest.fixture(scope="module")
def golden():
  return dict(np.load(GOLDEN))


def _model(name="ant_bench"):
  return mjtpu_torch.model_from_arrays(
      mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / f"{name}_model.npz"), device="cpu")


def _fwd(golden):
  """mjtpu's forward Data at the initial states, as data_from_mjtpu takes
  it (numpy leaves under the port's field names)."""
  fields = {k[4:]: v for k, v in golden.items() if k.startswith("fwd.")}
  contact = {k[8:]: v for k, v in fields.items() if k.startswith("contact.")}
  ns = types.SimpleNamespace(**{k: v for k, v in fields.items() if not k.startswith("contact.")})
  ns.contact = types.SimpleNamespace(**contact)
  return ns


def _field(obj, name):
  for part in name.split("."):
    obj = getattr(obj, part)
  return np.asarray(obj)


def _assert_close(got, want, names, bound, what):
  for f in names:
    a, b = _field(got, f), _field(want, f)
    assert a.shape == b.shape, (what, f, a.shape, b.shape)
    scale = max(1.0, float(np.abs(b).max())) if b.size else 1.0
    err = float(np.abs(a.astype(np.float64) - b).max()) if b.size else 0.0
    assert err <= bound * scale, f"{what} {f}: max abs err {err:.3e} (scale {scale:.3g})"


def _start(m, golden):
  d = mjtpu_torch.make_data(m, batch_size=golden["qpos0"].shape[0])
  return mjtpu_torch.replace(d, qpos=torch.as_tensor(golden["qpos0"]),
                             qvel=torch.as_tensor(golden["qvel0"]),
                             ctrl=torch.as_tensor(golden["ctrl"]))


def test_ant_model_is_the_slice():
  m = _model()
  assert (m.nv, m.nsensor, m.nsensordata) == (8, 20, 26)
  assert mjtpu_torch.constraint_sizes(m) == (0, 0, 8, 60, 248)
  assert (m.opt.solver, m.opt.iterations, m.opt.ls_iterations) == (
      mjtpu_torch.SolverType.NEWTON, 100, 50)
  # Newton's Hessian and Euler's damping solve take B1's register kernel
  assert cholesky.variant(m.nv, torch.float32) == "register"
  assert cholesky.variant(m.nv, torch.float64) == "register"


STAGES = [
    ("sensor_pos", sensor.sensor_pos, ("sensordata",)),
    ("sensor_vel", sensor.sensor_vel, ("sensordata",)),
    ("subtree_vel", smooth.subtree_vel, ("subtree_linvel", "subtree_angmom")),
    ("rne_postconstraint", smooth.rne_postconstraint, ("cacc", "cfrc_int", "cfrc_ext")),
    ("sensor_acc", sensor.sensor_acc, ("sensordata", "cacc", "cfrc_int", "cfrc_ext")),
]


@pytest.mark.parametrize("stage", range(len(STAGES)), ids=[s[0] for s in STAGES])
def test_ant_stage_from_mjtpu_state(golden, stage):
  """Each stage from mjtpu's forward Data, with sensordata cleared first
  (each stage writes its own sensors), against that Data."""
  name, fn, fields = STAGES[stage]
  want = _fwd(golden)
  d = mjtpu_torch.data_from_mjtpu(want, device="cpu")
  cleared = {f: torch.zeros_like(getattr(d, f)) for f in fields}
  got = fn(_model(), mjtpu_torch.replace(d, **cleared))
  if name.startswith("sensor_"):  # only this stage's sensors
    m = _model()
    ids = np.nonzero(np.asarray(m.sensor_needstage) == {"sensor_pos": 1, "sensor_vel": 2,
                                                       "sensor_acc": 3}[name])[0]
    cols = np.concatenate([m.sensor_adr[i] + np.arange(m.sensor_dim[i]) for i in ids])
    a, b = got.sensordata.numpy()[:, cols], want.sensordata[:, cols]
    scale = max(1.0, float(np.abs(b).max()))
    assert float(np.abs(a - b).max()) <= STAGE_BOUND * scale, name
    fields = fields[1:]
  _assert_close(mjtpu_torch.data_to_numpy(got), want, fields, STAGE_BOUND, name)


def test_ant_forward(golden):
  """The port's whole forward from the initial states: every field of the
  Data but the contact frame and what it feeds (module docstring)."""
  import dataclasses

  got = mjtpu_torch.data_to_numpy(mjtpu_torch.forward(_model(), _start(_model(), golden)))
  want = _fwd(golden)
  # qfrc_inverse is inverse's output, which forward leaves as it is
  names = [f.name for f in dataclasses.fields(mjtpu_torch.Data)
           if f.name not in ("contact", "qfrc_inverse")]
  names += [f"contact.{f.name}" for f in dataclasses.fields(mjtpu_torch.Contact)]
  _assert_close(got, want, [n for n in names if n not in FRAME_FIELDS], STAGE_BOUND, "forward")
  # the sensors read real forces: the hip contacts' touch readings
  assert (np.abs(want.sensordata[:, :9]) > 1e5).sum() == 16


def test_ant_trajectory(golden, monkeypatch):
  """100 steps from the golden's initial states; one Newton iteration a
  step at most, where opt.iterations allows 100; two B1 solves a step
  (Newton's Hessian, Euler's damping), at n = 8."""
  m = _model()
  sizes = []

  def counted(h, g, _fn=fused.chol_solve):
    sizes.append(int(g.shape[-1]))
    return _fn(h, g)

  monkeypatch.setattr(fused, "chol_solve", counted)
  before = dict(solver.loop_counts)
  d = _start(m, golden)
  err = {"qpos": 0.0, "qvel": 0.0, "sensordata": 0.0}
  per_sensor = np.maximum(1.0, np.abs(golden["sensordata"]).max(axis=(0, 1)))
  scale = np.concatenate([np.full(m.sensor_dim[i], per_sensor[
      m.sensor_adr[i]:m.sensor_adr[i] + m.sensor_dim[i]].max()) for i in range(m.nsensor)])
  for i in range(STEPS):
    d = mjtpu_torch.step(m, d)
    for f in ("qpos", "qvel"):
      err[f] = max(err[f], float(np.abs(getattr(d, f).numpy() - golden[f][i]).max()))
    err["sensordata"] = max(err["sensordata"], float(
        (np.abs(d.sensordata.numpy() - golden["sensordata"][i]) / scale).max()))
  assert max(err.values()) <= TRAJECTORY_BOUND, err
  assert int(d.nreset.sum()) == 0
  iterations = solver.loop_counts["iterations"] - before["iterations"]
  assert 0 < iterations <= STEPS < STEPS * m.opt.iterations
  assert sizes == [m.nv] * (iterations + STEPS)


def _one_step(m, d):
  out = mjtpu_torch.step(m, d)
  return out.qacc, out.efc_force


@pytest.mark.parametrize("name", ["ant_bench", "humanoid_bench"])
def test_newton_early_exit_is_exact(name, monkeypatch):
  """Two steps with the loops left early and with them run to their
  bounds give the same bits in qacc and efc_force; the early exit runs
  fewer iterations or linesearch rounds."""
  golden = dict(np.load(mjtpu_torch.ASSETS / f"{name}_golden.npz"))
  m = _model(name)
  assert m.opt.solver == mjtpu_torch.SolverType.NEWTON
  out, loops = {}, {}
  for early in (True, False):
    monkeypatch.setattr(solver, "EARLY_EXIT", early)
    before = dict(solver.loop_counts)
    d = _start(m, golden)
    results = []
    for _ in range(2):
      d = mjtpu_torch.step(m, d)
      results += [d.qacc, d.efc_force]
    out[early] = results
    loops[early] = {k: solver.loop_counts[k] - before[k] for k in before}
  for a, b in zip(out[True], out[False]):
    assert torch.equal(a, b)
  assert loops[False] == {"iterations": 2 * m.opt.iterations,
                          "ls_rounds": 2 * m.opt.iterations * m.opt.ls_iterations}
  assert sum(loops[True].values()) < sum(loops[False].values()), loops
