"""mjtpu_torch's renderer against mjtpu's at float64 on the CPU.

  * every scene and view of render_scenes_golden.npz
    (scripts/torch_port_assets.py: tests/test_render.py's scenes and a
    mesh scene at B=2, rendered by mjtpu's jit(render_batch_rgbd) under
    test_render.py's option sets) through chip_smoke.render_scene_errors,
    which side phase 36 runs on the card: rgb and depth within 1e-10 where
    seg agrees, seg equal; a pixel past that passes only as a tie that a
    copy of its rays a few ULP away resolves to mjtpu's pick, and the
    ties are counted;
  * one live comparison against mjtpu.render_rgbd on a 4-geom scene at
    12 x 16;
  * render_batch is render: a batch equals its envs rendered one by one,
    and a batch rendered in env chunks equals it whole;
  * the running minimum over geoms keeps jnp.argmin's pick on ties and
    NaN, and the per-axis pick jnp.argmax's;
  * the refusals: no camera (ValueError, as mjtpu's), a snapshot without
    the render fields, a height field (mjtpu's renderer fails on it too).
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import chip_smoke
import mjtpu
import mjtpu.zoo
import mjtpu_torch
from mjtpu_torch import zoo
from mjtpu_torch._src import io, render
from mjtpu_torch._src.dataclasses import map_tensors

torch.set_num_threads(1)

GOLDEN = mjtpu_torch.ASSETS / "render_scenes_golden.npz"
SCENES = io.bundle_names(mjtpu_torch.ASSETS / "render_scenes.npz")

LIVE_XML = """<mujoco><worldbody>
  <camera name="c" pos="1.8 -1.8 1.2" xyaxes="0.7 0.7 0 -0.3 0.3 0.9"/>
  <geom type="plane" size="3 3 .1" rgba=".8 .8 .8 1"/>
  <body pos="0 0 0.3"><freejoint/><geom type="box" size=".2 .3 .2" rgba=".9 .2 .2 1"/></body>
  <body pos="0.6 0.2 0.3"><freejoint/><geom type="sphere" size=".2" rgba=".2 .9 .2 1"/></body>
  <body pos="0.2 -0.6 0.3"><freejoint/>
    <geom type="capsule" size=".1 .25" euler="0 90 0" rgba=".2 .2 .9 1"/></body>
</worldbody></mujoco>"""


@pytest.fixture(scope="module")
def golden():
  return dict(np.load(GOLDEN))


@pytest.mark.parametrize("scene", SCENES)
def test_scene_matches_mjtpu(golden, scene):
  errs = chip_smoke.render_scene_errors(scene, golden, "cpu")
  views = [v for v in chip_smoke.render_views(golden) if v[0] == scene]
  assert len(errs) == len(views) >= 7
  for key, e in errs.items():
    assert e["rgb"] <= chip_smoke.RENDER_BOUND and e["depth"] <= chip_smoke.RENDER_BOUND, key
  print(f"{scene}: ties {sum(e['ties'] for e in errs.values())} of"
        f" {sum(e['pixels'] for e in errs.values())} pixels")


def test_unresolved_pixel_fails(golden):
  """A pixel whose golden seg names another geom is no tie: no copy of its
  rays resolves it, and the comparison fails."""
  m, d, rd = chip_smoke.render_scene("textured", golden, "cpu")
  want = [golden[f"textured.flat.cam0.{k}"].copy() for k in ("rgb", "depth", "seg")]
  y, x = np.argwhere(want[2][0] == 0)[0]
  want[2][0, y, x] = 2
  with pytest.raises(AssertionError, match=f"row {y}, column {x}"):
    chip_smoke.render_view_errors(m, d, rd, tuple(want), 0, {"shading": "flat"})


def _live_states(xml, batch=2):
  mjm = mujoco.MjModel.from_xml_string(xml)
  rng = np.random.default_rng(3)
  qpos = np.tile(mjm.qpos0, (batch, 1))
  for b in range(1, batch):
    for adr in (int(mjm.jnt_qposadr[j]) for j in range(mjm.njnt)):
      qpos[b, adr:adr + 3] += rng.uniform(-0.1, 0.1, 3)
  m = mjtpu_torch.put_model(mjm, device="cpu")
  d = mjtpu_torch.make_data(m, batch_size=batch)
  d = mjtpu_torch.forward(m, mjtpu_torch.replace(d, qpos=torch.as_tensor(qpos)))
  return mjm, m, d, qpos


def test_live_matches_mjtpu():
  """The 4-geom scene at 12 x 16, each env through mjtpu.render_rgbd
  (under jit(vmap))."""
  mjm, m, d, qpos = _live_states(LIVE_XML)
  m_j = mjtpu.put_model(mjm)
  # mjtpu's Data at the port's frames (forward's parity is held elsewhere)
  poses = {k: jnp.asarray(getattr(d, k).numpy()) for k in ("qpos", "geom_xpos", "geom_xmat",
                                                           "cam_xpos", "cam_xmat")}
  d_j = jax.vmap(lambda p: mjtpu.make_data(m_j).replace(**p))(poses)
  rgbd = jax.jit(jax.vmap(lambda dd: mjtpu.render_rgbd(m_j, dd, width=16, height=12)))
  want = tuple(np.asarray(x) for x in rgbd(d_j))
  assert set(np.unique(want[2])) == {-1, 0, 1, 2, 3}, np.unique(want[2])
  errs = chip_smoke.render_view_errors(m, d, mjtpu_torch.precompute_render_data(m), want)
  assert errs["rgb"] <= chip_smoke.RENDER_BOUND and errs["depth"] <= chip_smoke.RENDER_BOUND
  print(f"live scene: ties {errs['ties']} of {errs['pixels']} pixels")


def test_render_batch_equals_per_env(monkeypatch):
  """render_batch and render_batch_rgbd are render and render_rgbd, which
  render every env at once: each env of the batch equals it rendered
  alone, and the batch rendered in env chunks (a budget of one env)
  equals it whole, bit for bit."""
  _, m, d, _ = _live_states(LIVE_XML, batch=3)
  rd = mjtpu_torch.precompute_render_data(m)
  kw = dict(width=16, height=12, rd=rd, shadows=True, ssaa=2)
  rgb, depth, seg = mjtpu_torch.render_batch_rgbd(m, d, **kw)
  assert rgb.shape == (3, 12, 16, 3) and depth.shape == seg.shape == (3, 12, 16)
  assert seg.dtype == torch.int32
  assert mjtpu_torch.render_batch is mjtpu_torch.render
  assert mjtpu_torch.render_batch_rgbd is mjtpu_torch.render_rgbd
  assert torch.equal(mjtpu_torch.render(m, d, **kw), rgb)
  for b in range(3):
    one = mjtpu_torch.render_rgbd(m, map_tensors(d, lambda x: x[b:b + 1]), **kw)
    for x, y in zip(one, (rgb, depth, seg)):
      assert torch.equal(x[0], y[b])
  monkeypatch.setattr(render, "_CHUNK_BYTES", 1)
  for x, y in zip(mjtpu_torch.render_batch_rgbd(m, d, **kw), (rgb, depth, seg)):
    assert torch.equal(x, y)


def test_nearest_keeps_argmin_pick():
  """The running minimum over geoms picks jnp.argmin's index over the
  stack: the first minimum on a tie, the first NaN before any number;
  _argmax3 picks jnp.argmax's."""
  nan, inf = float("nan"), float("inf")
  ts = np.array([
      [2.0, 1.0, inf, nan, 3.0, inf, 1.0, nan],
      [1.0, 1.0, inf, 1.0, nan, 2.0, nan, nan],
      [1.0, 0.5, 4.0, nan, nan, inf, 0.5, 2.0],
  ])
  best_t = best_k = None
  for k, t in enumerate(torch.as_tensor(ts)):
    best_t, best_k = render.nearest(best_t, best_k, t, k)
  want = np.asarray(jnp.argmin(jnp.asarray(ts), axis=0))
  np.testing.assert_array_equal(best_k.numpy(), want)
  np.testing.assert_array_equal(best_t.numpy(), ts[want, np.arange(ts.shape[1])])
  ax = render._argmax3(*torch.as_tensor(ts))
  np.testing.assert_array_equal(ax.numpy(), np.asarray(jnp.argmax(jnp.asarray(ts), axis=0)))


NO_CAMERA_XML = """<mujoco><worldbody><geom type="plane" size="1 1 .1"/>
  <body><freejoint/><geom type="sphere" size=".1"/></body></worldbody></mujoco>"""
HFIELD_XML = """<mujoco><asset><hfield name="h" nrow="4" ncol="4" size="1 1 .2 .1"/></asset>
  <worldbody><camera name="c" pos="0 -2 1" xyaxes="1 0 0 0 .45 .9"/>
  <geom type="hfield" hfield="h"/></worldbody></mujoco>"""


def test_refusals(tmp_path):
  """No camera: ValueError, as mjtpu's.  A snapshot without the render
  fields: precompute_render_data names them.  A height field: refused by
  name, where mjtpu's renderer fails on the missing intersector; the
  humanoid_terrain env refuses pixels by name, and mjtpu's cannot render
  them."""
  mjm = mujoco.MjModel.from_xml_string(NO_CAMERA_XML)
  m = mjtpu_torch.put_model(mjm, device="cpu")
  with pytest.raises(ValueError, match="needs a <camera>"):
    mjtpu_torch.render(m, mjtpu_torch.make_data(m))
  m_j = mjtpu.put_model(mjm)
  with pytest.raises(ValueError, match="needs a <camera>"):
    mjtpu.render(m_j, mjtpu.make_data(m_j))

  path = mjtpu_torch.ASSETS / "satellite_small_model.npz"
  with np.load(path) as z:
    arrays = {k: z[k] for k in z.files if k not in io.RENDER_FIELDS}
  np.savez(tmp_path / "old.npz", **arrays)
  m = mjtpu_torch.model_from_arrays(mjtpu_torch.load_snapshot(tmp_path / "old.npz"), device="cpu")
  assert m.ncam == 1 and "geom_rgba" in m.render_filled
  with pytest.raises(ValueError, match="lacks the render fields cam_fovy, geom_matid, geom_rgba"):
    mjtpu_torch.precompute_render_data(m)

  mjm = mujoco.MjModel.from_xml_string(HFIELD_XML)
  with pytest.raises(NotImplementedError, match="height fields"):
    mjtpu_torch.precompute_render_data(mjtpu_torch.put_model(mjm, device="cpu"))
  m_j = mjtpu.put_model(mjm)
  with pytest.raises(KeyError):
    mjtpu.render(m_j, mjtpu.make_data(m_j))
  with pytest.raises(NotImplementedError, match="humanoid_terrain"):
    zoo.ENVS["humanoid_terrain"](device="cpu", pixel_obs=True)
  env_j = mjtpu.zoo.ENVS["humanoid_terrain"](pixel_obs=True)
  with pytest.raises(KeyError):
    env_j._pixels(env_j._d0)
