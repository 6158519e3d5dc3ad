"""The zoo's model= override with per-env Model rows, against mjtpu's
zoo under vmap(env.step, in_axes=(0, 0, axes)) on the CPU at f64 (apart
from tests/test_torch_randomize.py: mjtpu's env step takes most of a
minute to compile, and --dist loadfile gives the file a worker of its
own)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import mjtpu_torch
from mjtpu import parallel as j_parallel
from mjtpu_torch import parallel


def test_zoo_env_takes_a_randomized_model():
  """A zoo env stepped with model= a randomized cartpole matches mjtpu's
  env stepped under vmap(env.step, in_axes=(0, 0, axes)) from the same
  states: obs, reward and qpos within 1e-10."""
  from mjtpu import zoo as j_zoo

  from mjtpu_torch import zoo
  from mjtpu_torch.zoo import base

  j_env = j_zoo.ENVS["cartpole"]()
  B = 3
  states = jax.vmap(j_env.reset)(jax.random.split(jax.random.PRNGKey(0), B))
  mass = np.tile(np.asarray(j_env.model.body_mass), (B, 1))
  mass[:, 2] *= [0.5, 1.0, 2.0]
  jmb, j_axes = j_parallel.randomize(j_env.model, {"body_mass": jnp.asarray(mass)})
  action = jnp.asarray(np.random.default_rng(0).uniform(-1, 1, (B, 1)))
  j_out = jax.jit(jax.vmap(j_env.step, in_axes=(0, 0, j_axes)))(states, action, jmb)

  env = zoo.ENVS["cartpole"](dtype=torch.float64, device="cpu")
  mb, _ = parallel.randomize(env.model, {"body_mass": mass})
  data = mjtpu_torch.data_from_mjtpu(jax.tree.map(np.asarray, states.data), device="cpu")
  state = base.State(data=data, obs=torch.as_tensor(np.array(states.obs)),
                    reward=torch.zeros(B, dtype=torch.float64),
                    done=torch.zeros(B, dtype=torch.bool),
                    steps=torch.as_tensor(np.array(states.steps)))
  out = env.step(state, torch.as_tensor(np.array(action)), torch.Generator().manual_seed(0),
                 model=mb)
  assert not bool(np.asarray(j_out.done).any())
  for got, want in ((out.obs, j_out.obs), (out.reward, j_out.reward),
                    (out.data.qpos, j_out.data.qpos)):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-10, rtol=0)
  assert np.ptp(out.data.qpos[:, 1].numpy()) > 1e-9
