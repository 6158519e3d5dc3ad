"""branchy66's snapshot and golden, regenerated with mjtpu and held to the
committed files (scripts/torch_port_assets.py): one file a regeneration,
so that pytest-xdist's --dist loadfile spreads them over its workers."""

import numpy as np
import pytest

from mjtpu_torch._src import io
from tests.test_torch_assets import _assets_script, _regenerate, _snapshot_keys


@pytest.fixture(scope="module")
def regenerated_branchy(tmp_path_factory):
  """The branchy66 data files written afresh (the whole 100-step golden:
  the tree has no contacts, so its steps cost little beside the compile)."""
  return _regenerate(tmp_path_factory.mktemp("branchy"), "--model", "branchy66")


def test_branchy_snapshot_file_is_fresh(regenerated_branchy):
  script = _assets_script()
  assert _snapshot_keys(script.BRANCHY_MODEL_FILE) == sorted(io.SNAPSHOT_FIELDS)
  with np.load(regenerated_branchy / script.BRANCHY_MODEL_FILE.name) as new, \
      np.load(script.BRANCHY_MODEL_FILE) as old:
    assert sorted(new.files) == sorted(old.files)
    for k in new.files:
      np.testing.assert_array_equal(new[k], old[k], err_msg=k)


def test_branchy_golden_file_is_fresh(regenerated_branchy):
  """Regenerating the branchy golden with mjtpu reproduces the committed
  file: its 100 steps and its step-1 fields."""
  script = _assets_script()
  name = script.BRANCHY_GOLDEN_FILE.name
  with np.load(regenerated_branchy / name) as new, np.load(script.BRANCHY_GOLDEN_FILE) as old:
    assert sorted(new.files) == sorted(old.files)
    assert old["qpos"].shape[:2] == (script.STEPS, script.BATCH)
    for k in new.files:
      np.testing.assert_allclose(new[k], old[k], rtol=0, atol=1e-12, err_msg=k)
