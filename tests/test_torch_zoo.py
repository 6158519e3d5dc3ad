"""mjtpu_torch.zoo against mjtpu.zoo at float64 on the CPU.

  * the registry, each env's constants and sizes, and its ``_obs`` and
    ``_reward_done`` on the same batched Data, live against mjtpu's
    (cheap: no mjtpu physics runs), to 1e-12;
  * ``env.step`` of the five locomotion envs (ant, hopper, walker2d,
    halfcheetah, cartpole) against mjtpu's jit(vmap(env.step)) from the
    same states, through the committed env golden
    (scripts/torch_port_assets.py, zoo_env_golden.npz): 3 env steps of
    envs 0-2, obs and reward to 1e-10, done and steps exact; env 3 is
    forced done at its first step, and only that step's reward (1e-10),
    done and steps are comparable (mjtpu's fresh state comes from its PRNG);
  * the auto-reset against mjtpu's semantics (base.py:172-179): every
    Data field of a done env is the fresh state's, every other env's the
    stepped one's, steps set to 0 where done, bit for bit;
  * reset's draws come from the explicit generator only; the swimmer
    under ImplicitFast and the model= override, refused until later
    slices ported them, run; the default device.  The swimmer's and the
    satellite envs' env.step: tests/test_torch_satellite.py;
  * pixel observations: the humanoid and satellite_small envs with
    pixel_obs=True against mjtpu's (pixel_env_golden.npz, through
    chip_smoke.pixel_env_errors, which side phase 36 runs on the card):
    the start and 3 env steps, pixels to the renderer's bounds (rgb and
    depth 1e-10 where seg agrees, the rest ties that ULP copies of their
    rays resolve), obs and reward to 1e-10; every env but humanoid_terrain
    builds with pixel_obs=True and renders finite pixels in [0, 1]
    (humanoid_terrain's refusal: tests/test_torch_render.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import mjtpu.zoo as mjtpu_zoo
import mjtpu_torch
from mjtpu_torch import zoo
from mjtpu_torch.zoo import base

torch.set_num_threads(1)

GOLDEN = mjtpu_torch.ASSETS / "zoo_env_golden.npz"
LOCOMOTION = ("ant", "hopper", "walker2d", "halfcheetah", "cartpole")
BUILT = LOCOMOTION + ("humanoid", "humanoid_terrain", "humanoid_rich", "swimmer", "satellite",
                      "satellite_large", "satellite_small")
FUNCTION_BOUND = 1e-12
STEP_BOUND = 1e-10


@pytest.fixture(scope="module")
def golden():
  return dict(np.load(GOLDEN))


def _env(name):
  return zoo.ENVS[name](dtype=torch.float64, device="cpu")


def test_registry_matches_mjtpu():
  assert sorted(zoo.ENVS) == sorted(mjtpu_zoo.ENVS)


def _mjtpu_data(env_j, d):
  """mjtpu's batched Data holding the port's Data ``d`` field by field
  (every field both have, at the same shape)."""
  batch = d.qpos.shape[0]
  dj = jax.vmap(lambda _: env_j._d0)(jnp.arange(batch))
  fields = {}
  for f in dataclasses.fields(d):
    v = getattr(d, f.name)
    if f.name != "contact" and hasattr(dj, f.name) and getattr(dj, f.name).shape == v.shape:
      fields[f.name] = jnp.asarray(v.numpy())
  return dj.replace(**fields)


@pytest.mark.parametrize("name", BUILT)
def test_obs_and_reward_done_match_mjtpu(name):
  """From a reset batch and one physics step after it: the env's
  constants, sizes, _obs and _reward_done against mjtpu's on the same
  Data and actions."""
  env = _env(name)
  env_j = mjtpu_zoo.ENVS[name](dtype=jnp.float64)
  for attr in ("frame_skip", "reset_noise", "episode_length", "dt", "action_size",
               "observation_size"):
    assert getattr(env, attr) == getattr(env_j, attr), attr
  gen = torch.Generator().manual_seed(0)
  prev = env.reset(4, gen).data
  action = torch.rand(4, env.action_size, generator=gen, dtype=torch.float64) * 2.4 - 1.2
  data = mjtpu_torch.step(env.model, mjtpu_torch.replace(prev, ctrl=env._prepare_ctrl(action)))
  prev_j, data_j = _mjtpu_data(env_j, prev), _mjtpu_data(env_j, data)
  np.testing.assert_allclose(env._obs(data).numpy(), np.asarray(jax.vmap(env_j._obs)(data_j)),
                             rtol=0, atol=FUNCTION_BOUND)
  reward, done = env._reward_done(prev, data, action)
  reward_j, done_j = jax.vmap(env_j._reward_done)(prev_j, data_j, jnp.asarray(action.numpy()))
  np.testing.assert_allclose(reward.numpy(), np.asarray(reward_j), rtol=0, atol=FUNCTION_BOUND)
  np.testing.assert_array_equal(done.numpy(), np.asarray(done_j))


def _golden_state(env, golden, name):
  """The env golden's initial states, as the golden script builds mjtpu's:
  forward at (qpos0, qvel0), the env's observation, its step counters."""
  m = env.model
  d = mjtpu_torch.make_data(m, batch_size=golden[f"{name}.qpos0"].shape[0])
  d = mjtpu_torch.replace(d, qpos=torch.as_tensor(golden[f"{name}.qpos0"]),
                          qvel=torch.as_tensor(golden[f"{name}.qvel0"]))
  state = env._init_state(mjtpu_torch.forward(m, d))
  return dataclasses.replace(state, steps=torch.as_tensor(golden[f"{name}.steps0"]))


@pytest.mark.parametrize("name", LOCOMOTION)
def test_env_step_matches_mjtpu_golden(golden, name):
  env = _env(name)
  state = _golden_state(env, golden, name)
  gen = torch.Generator().manual_seed(0)
  actions = golden[f"{name}.action"]
  for t in range(actions.shape[0]):
    state = env.step(state, torch.as_tensor(actions[t]), gen)
    want = {k: golden[f"{name}.{k}"][t] for k in ("obs", "reward", "done", "steps")}
    live = slice(0, 3)  # env 3 restarted from mjtpu's PRNG after step 1
    np.testing.assert_allclose(state.obs[live].numpy(), want["obs"][live], rtol=0,
                               atol=STEP_BOUND, err_msg=f"step {t + 1} obs")
    np.testing.assert_allclose(state.reward[live].numpy(), want["reward"][live], rtol=0,
                               atol=STEP_BOUND, err_msg=f"step {t + 1} reward")
    np.testing.assert_array_equal(state.done[live].numpy(), want["done"][live])
    np.testing.assert_array_equal(state.steps[live].numpy(), want["steps"][live])
    assert not want["done"][live].any()
    if t == 0:  # the forced-done env
      assert bool(state.done[3]) and want["done"][3]
      assert int(state.steps[3]) == want["steps"][3] == 0
      assert abs(float(state.reward[3]) - want["reward"][3]) <= STEP_BOUND
  assert state.obs.shape == (4, env.observation_size) and state.obs.dtype == torch.float64
  assert state.steps.dtype == torch.int32 and state.done.dtype == torch.bool


def test_auto_reset_replaces_done_envs_only(golden):
  """The ant from the golden's states (env 3 done at the first step): the
  step's Data is where(done, fresh, stepped) over every field, fresh being
  forward of the noisy initial state the same generator draws."""
  env = _env("ant")
  state = _golden_state(env, golden, "ant")
  action = torch.as_tensor(golden["ant.action"][0])
  gen = torch.Generator().manual_seed(7)
  replay = torch.Generator().manual_seed(7)
  out = env.step(state, action, gen)
  stepped = mjtpu_torch.replace(state.data, ctrl=action)
  for _ in range(env.frame_skip):
    stepped = mjtpu_torch.step(env.model, stepped)
  fresh = mjtpu_torch.forward(env.model, env._noisy_init(4, replay))
  done = out.done
  assert done.tolist() == [False, False, False, True]

  def check(got, a, b, path):
    for f in dataclasses.fields(got):
      x = getattr(got, f.name)
      if dataclasses.is_dataclass(x):
        check(x, getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
        continue
      assert torch.equal(x[done], getattr(a, f.name)[done]), f"{path}.{f.name} (done)"
      assert torch.equal(x[~done], getattr(b, f.name)[~done]), f"{path}.{f.name} (not done)"

  check(out.data, fresh, stepped, "data")
  assert out.steps.tolist() == [1, 1, 1, 0]
  assert torch.equal(out.obs, env._obs(out.data))
  # the reward is the step's, before the reset
  reward, _ = env._reward_done(state.data, stepped, action)
  assert torch.equal(out.reward, reward)


def test_reset_draws_from_the_generator_only():
  env = _env("ant")
  a = env.reset(6, torch.Generator().manual_seed(3))
  torch.manual_seed(12345)  # the global seed plays no part
  b = env.reset(6, torch.Generator().manual_seed(3))
  c = env.reset(6, torch.Generator().manual_seed(4))
  assert torch.equal(a.data.qpos, b.data.qpos) and torch.equal(a.obs, b.obs)
  assert not torch.equal(a.data.qpos, c.data.qpos)
  # the draws: qpos0 + uniform(-noise, noise), noise x normal qvel (forward
  # then normalizes the free joint's quaternion in qpos, as mjtpu's does)
  init = env._noisy_init(6, torch.Generator().manual_seed(3))
  assert float((init.qpos - env.model.qpos0).abs().max()) <= env.reset_noise
  assert torch.equal(init.qvel, a.data.qvel)
  assert torch.equal(mjtpu_torch.forward(env.model, init).qpos, a.data.qpos)
  assert a.steps.tolist() == [0] * 6 and not a.done.any() and not a.reward.any()
  assert a.obs.shape == (6, 27) and a.data.qvel.abs().max() > 0


def _swimmer_implicitfast():
  """The swimmer env's model with its integrator set to ImplicitFast."""
  ns = mjtpu_torch.load_snapshot(mjtpu_torch.ASSETS / zoo.ENVS["swimmer"].snapshot)
  ns.opt.integrator = int(mjtpu_torch.IntegratorType.IMPLICITFAST)
  return mjtpu_torch.model_from_arrays(ns, device="cpu")


@pytest.mark.parametrize("make, what", [
    (_swimmer_implicitfast, None),
], ids=["swimmer_implicitfast"])
def test_env_refusals(make, what):
  """The swimmer's model under ImplicitFast, refused until the Implicit
  slice brought the fluid forces' velocity derivative, builds and steps
  (what None).  (Pixel observations, refused until the render slice, are
  held by test_pixel_env_matches_mjtpu_golden.)"""
  if what is not None:
    with pytest.raises(NotImplementedError, match=what):
      make()
    return
  m = make()
  d = mjtpu_torch.make_data(m, batch_size=2)
  qvel = torch.as_tensor(np.random.default_rng(0).uniform(-0.5, 0.5, (2, m.nv)))
  d = mjtpu_torch.step(m, mjtpu_torch.replace(d, qvel=qvel))
  assert bool(torch.isfinite(d.qpos).all()) and int(d.nreset.sum()) == 0


def test_model_override_refused():
  """The model= override of reset and step, refused until the port had
  per-env Model rows, runs: the env's own model passed as model= gives
  its plain reset and step bit for bit, and a model with one mass row per
  env moves the physics of each env apart."""
  env = _env("cartpole")
  action = torch.full((2, 1), 0.5, dtype=torch.float64)
  runs = []
  for model in (None, env.model):
    gen = torch.Generator().manual_seed(0)
    state = env.reset(2, gen, model=model)
    runs.append(env.step(state, action, gen, model=model))
  assert torch.equal(runs[0].data.qpos, runs[1].data.qpos)
  assert torch.equal(runs[0].obs, runs[1].obs)
  mass = env.model.body_mass.expand(2, -1).clone()
  mass[1, 1] *= 3.0
  mb, _ = mjtpu_torch.parallel.randomize(env.model, {"body_mass": mass})
  gen = torch.Generator().manual_seed(0)
  state = env.step(env.reset(2, gen, model=mb), action, gen, model=mb)
  assert torch.equal(state.data.qpos[0], runs[0].data.qpos[0])
  assert not torch.equal(state.data.qpos[1], runs[0].data.qpos[1])


def test_env_builds_on_cuda_by_default():
  """An env's Model lives on cuda unless the caller names another device;
  without a card the env asks for device="cpu"."""
  if torch.cuda.is_available():
    assert zoo.ENVS["cartpole"]().device.type == "cuda"
  else:
    with pytest.raises(RuntimeError, match='device="cpu"'):
      zoo.ENVS["cartpole"]()
  env = zoo.ENVS["cartpole"](device="cpu")
  assert env.device.type == "cpu" and env.model.dtype == torch.float32
  assert isinstance(env.reset(2, torch.Generator().manual_seed(0)), base.State)


PIXEL_GOLDEN = mjtpu_torch.ASSETS / "pixel_env_golden.npz"


@pytest.mark.parametrize("name", chip_smoke.PIXEL_ENVS)
def test_pixel_env_matches_mjtpu_golden(name):
  """The env with pixel_obs=True from the golden's states: its pixels at
  the start and after each of 3 env steps (every env at the start, envs
  0-2 after: env 3 restarts from mjtpu's PRNG), obs and reward, against
  mjtpu's env."""
  golden = dict(np.load(PIXEL_GOLDEN))
  errs = chip_smoke.pixel_env_errors(name, golden, "cpu")
  assert errs["obs_reward"] <= STEP_BOUND
  assert len(errs["pixels"]) == golden[f"{name}.action"].shape[0] + 1
  for e in errs["pixels"]:
    assert e["rgb"] <= chip_smoke.RENDER_BOUND and e["depth"] <= chip_smoke.RENDER_BOUND
  print(f"{name}: ties {[e['ties'] for e in errs['pixels']]}")


@pytest.mark.parametrize("name", sorted(set(BUILT) - {"humanoid_terrain"}))
def test_pixel_envs_render(name):
  """Every env but humanoid_terrain builds with pixel_obs=True (the
  camera-less models from pixel_env_models.npz, with mjtpu's injected
  observer camera) and gives finite pixels in [0, 1] at reset and after a
  step; without pixel_obs, State.pixels is (B, 0)."""
  env = zoo.ENVS[name](dtype=torch.float64, device="cpu", pixel_obs=True, pixel_size=(12, 16))
  assert env.model.ncam >= 1 and env.pixel_size == (12, 16)
  gen = torch.Generator().manual_seed(0)
  state = env.reset(2, gen)
  state = env.step(state, torch.zeros(2, env.action_size, dtype=torch.float64), gen)
  for pixels in (env.reset(2, gen).pixels, state.pixels):
    assert pixels.shape == (2, 12, 16, 3) and pixels.dtype == torch.float64
    assert bool(torch.isfinite(pixels).all())
    assert float(pixels.min()) >= 0.0 and float(pixels.max()) <= 1.0
  assert state.obs.shape == (2, _env(name).observation_size)
  plain = _env(name).reset(2, torch.Generator().manual_seed(0))
  assert plain.pixels.shape == (2, 0)
