"""ant_bench's snapshot and golden, regenerated with mjtpu and held to the
committed files (scripts/torch_port_assets.py): one file a regeneration,
so that pytest-xdist's --dist loadfile spreads them over its workers."""

import numpy as np
import pytest

from mjtpu_torch._src import io
from tests.test_torch_assets import _assets_script, _regenerate, _snapshot_keys


ANT_PREFIX = 5


@pytest.fixture(scope="module")
def regenerated_ant(tmp_path_factory):
  """ant_bench's data files written afresh, its golden over the first
  ANT_PREFIX steps only (the rest of the committed trajectory is held by
  tests/test_torch_ant.py against the port)."""
  return _regenerate(tmp_path_factory.mktemp("ant"), "--model", "ant_bench",
                     "--steps", str(ANT_PREFIX))


def test_ant_snapshot_file_is_fresh(regenerated_ant):
  script = _assets_script()
  assert _snapshot_keys(script.ANT_MODEL_FILE) == sorted(io.SNAPSHOT_FIELDS)
  with np.load(regenerated_ant / script.ANT_MODEL_FILE.name) as new, \
      np.load(script.ANT_MODEL_FILE) as old:
    assert sorted(new.files) == sorted(old.files)
    for k in new.files:
      np.testing.assert_array_equal(new[k], old[k], err_msg=k)


def test_ant_golden_file_is_fresh(regenerated_ant):
  """Regenerating the ant golden with mjtpu reproduces the committed
  file's first ANT_PREFIX steps and its forward fields; the golden has
  touch readings that are not zero."""
  script = _assets_script()
  name = script.ANT_GOLDEN_FILE.name
  with np.load(regenerated_ant / name) as new, np.load(script.ANT_GOLDEN_FILE) as old:
    assert sorted(new.files) == sorted(old.files)
    assert old["qpos"].shape[:2] == (script.STEPS, script.BATCH)
    assert (old["sensordata"][..., :9] != 0).any()  # the 9 touch sensors
    for k in new.files:
      want = old[k][:ANT_PREFIX] if k in ("qpos", "qvel", "sensordata") else old[k]
      np.testing.assert_allclose(new[k], want, rtol=0, atol=1e-12, err_msg=k)
