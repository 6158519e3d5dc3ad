"""The swimmer and the satellite envs (mjtpu_torch/zoo/satellite.py with
the CMG math of cmg.py) against mjtpu.zoo at float64 on the CPU.

  * cmg.py's functions against mjtpu's, batched over gimbal angles, for
    both cluster geometries, to 1e-12;
  * ``env.step`` of the swimmer (RK4, fluid forces) and of the three
    satellite envs against mjtpu's jit(vmap(env.step)) from the same
    states, through the committed golden (scripts/torch_port_assets.py,
    swimmer_satellite_env_golden.npz), as tests/test_torch_zoo.py holds
    the locomotion envs: 3 env steps of envs 0-2, obs and reward to 1e-10,
    done and steps exact; env 3 starts one step before its episode_length
    (none of these envs ends an episode early), so only its first step's
    reward, done and steps are comparable;
  * what each satellite env adds to the base env: the CMG torque in
    xfrc_applied, the rotor speeds appended to the action, the spinning
    rotors of a fresh state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mjtpu.zoo as mjtpu_zoo
import mjtpu_torch
from mjtpu.zoo import cmg as j_cmg
from mjtpu_torch import zoo
from mjtpu_torch.zoo import cmg
from tests.test_torch_zoo import _golden_state

torch.set_num_threads(1)

GOLDEN = mjtpu_torch.ASSETS / "swimmer_satellite_env_golden.npz"
ENVS = ("swimmer", "satellite", "satellite_large", "satellite_small")
FUNCTION_BOUND = 1e-12
STEP_BOUND = 1e-10


@pytest.fixture(scope="module")
def golden():
  return dict(np.load(GOLDEN))


def _env(name):
  return zoo.ENVS[name](dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("cluster", ["pyramid", "ortho"])
def test_cmg_matches_mjtpu(cluster):
  g, s0 = getattr(cmg, f"{cluster}_cluster")()
  g_j, s0_j = getattr(j_cmg, f"{cluster}_cluster")()
  np.testing.assert_array_equal(g.numpy(), np.asarray(g_j))
  np.testing.assert_array_equal(s0.numpy(), np.asarray(s0_j))
  angles = np.random.default_rng(0).uniform(-np.pi, np.pi, (5, g.shape[0]))
  a, a_j = torch.as_tensor(angles), jnp.asarray(angles)
  pairs = [
      (cmg.spin_axes(g, s0, a), jax.vmap(lambda x: j_cmg.spin_axes(g_j, s0_j, x))(a_j)),
      (cmg.cluster_jacobian(g, s0, a, 5.0),
       jax.vmap(lambda x: j_cmg.cluster_jacobian(g_j, s0_j, x, 5.0))(a_j)),
      (cmg.momentum(g, s0, a, 2.0), jax.vmap(lambda x: j_cmg.momentum(g_j, s0_j, x, 2.0))(a_j)),
      (cmg.manipulability(cmg.cluster_jacobian(g, s0, a)),
       jax.vmap(lambda x: j_cmg.manipulability(j_cmg.cluster_jacobian(g_j, s0_j, x)))(a_j)),
      (cmg.rodrigues(s0, g, a), jax.vmap(jax.vmap(j_cmg.rodrigues))(
          jnp.broadcast_to(s0_j, (5,) + s0_j.shape), jnp.broadcast_to(g_j, (5,) + g_j.shape),
          a_j)),
  ]
  for got, want in pairs:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=FUNCTION_BOUND)
  # at gimbal lock (every spin axis parallel) the measure is 0, not NaN
  lock = torch.zeros(1, 3, 4, dtype=torch.float64)
  lock[:, 0] = 1.0
  assert float(cmg.manipulability(lock)) == 0.0


@pytest.mark.parametrize("name", ENVS)
def test_env_step_matches_mjtpu_golden(golden, name):
  env = _env(name)
  state = _golden_state(env, golden, name)
  gen = torch.Generator().manual_seed(0)
  actions = golden[f"{name}.action"]
  assert actions.shape == (3, 4, env.action_size)
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
    if t == 0:  # the env at its episode's last step
      assert bool(state.done[3]) and want["done"][3]
      assert int(state.steps[3]) == want["steps"][3] == 0
      assert abs(float(state.reward[3]) - want["reward"][3]) <= STEP_BOUND
  assert state.obs.shape == (4, env.observation_size) and state.obs.dtype == torch.float64
  assert int(state.data.nreset.sum()) == 0


def test_satellite_writes_the_cmg_torque():
  """The satellite env puts -h0 J(delta) delta_dot, turned into the world
  frame, on body 1's torque before it steps, as mjtpu's env does."""
  env = _env("satellite")
  env_j = mjtpu_zoo.ENVS["satellite"](dtype=jnp.float64)
  state = env.reset(3, torch.Generator().manual_seed(1))
  got = env._cmg_torque(state.data).numpy()
  d = state.data
  want = jax.vmap(lambda qpos, qvel, xquat: env_j._cmg_torque(env_j._d0.replace(
      qpos=qpos, qvel=qvel, xquat=xquat)))(*(jnp.asarray(getattr(d, f).numpy())
                                            for f in ("qpos", "qvel", "xquat")))
  np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=FUNCTION_BOUND)
  assert np.abs(got).max() > 0


@pytest.mark.parametrize("name", ["satellite_large", "satellite_small"])
def test_satellite_cmg_ctrl_and_reset(name):
  env = _env(name)
  env_j = mjtpu_zoo.ENVS[name](dtype=jnp.float64)
  action = torch.rand(2, env.action_size, generator=torch.Generator().manual_seed(2),
                      dtype=torch.float64)
  got = env._prepare_ctrl(action)
  want = jax.vmap(env_j._prepare_ctrl)(jnp.asarray(action.numpy()))
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  assert env.action_size == env.n_gimbals and got.shape == (2, env.model.nu)
  init = env._noisy_init(2, torch.Generator().manual_seed(3))
  rotors = [6 + 2 * i + 1 for i in range(env.n_gimbals)]
  assert torch.all(init.qvel[:, rotors] == env.rotor_speed)
  others = [i for i in range(env.model.nv) if i not in rotors]
  assert float(init.qvel[:, others].abs().max()) <= 10 * env.reset_noise
