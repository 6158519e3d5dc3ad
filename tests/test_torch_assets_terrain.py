"""humanoid_terrain's snapshot and golden, regenerated with mjtpu and held to
the committed files (scripts/torch_port_assets.py): one file a
regeneration, so that pytest-xdist's --dist loadfile spreads them over its
workers."""

import numpy as np
import pytest

from mjtpu_torch._src import io
from tests.test_torch_assets import _assets_script, _regenerate, _snapshot_keys


TERRAIN_PREFIX = 5


@pytest.fixture(scope="module")
def regenerated_terrain(tmp_path_factory):
  """humanoid_terrain's data files written afresh, its golden over the
  first TERRAIN_PREFIX steps only (the rest of the committed trajectory is
  held by tests/test_torch_terrain.py's one-step restarts)."""
  return _regenerate(tmp_path_factory.mktemp("terrain"), "--model", "humanoid_terrain",
                     "--steps", str(TERRAIN_PREFIX))


def test_terrain_snapshot_file_is_fresh(regenerated_terrain):
  script = _assets_script()
  name = script.TERRAIN_MODEL_FILE.name
  assert _snapshot_keys(script.TERRAIN_MODEL_FILE) == sorted(io.SNAPSHOT_FIELDS)
  with np.load(regenerated_terrain / name) as new, np.load(script.TERRAIN_MODEL_FILE) as old:
    assert sorted(new.files) == sorted(old.files)
    assert sum(k.startswith("hull.") for k in new.files) == len(io.HULL_FIELDS)
    for k in new.files:
      np.testing.assert_array_equal(new[k], old[k], err_msg=k)


def test_terrain_golden_file_is_fresh(regenerated_terrain):
  """Regenerating the terrain golden with mjtpu reproduces the committed
  file's first TERRAIN_PREFIX steps and its step-1 fields."""
  script = _assets_script()
  name = script.TERRAIN_GOLDEN_FILE.name
  with np.load(regenerated_terrain / name) as new, np.load(script.TERRAIN_GOLDEN_FILE) as old:
    assert sorted(new.files) == sorted(old.files)
    assert old["qpos"].shape[0] == script.STEPS
    for k in new.files:
      want = old[k][:TERRAIN_PREFIX] if k in ("qpos", "qvel") else old[k]
      np.testing.assert_allclose(new[k], want, rtol=0, atol=1e-12, err_msg=k)
