"""humanoid_bench's snapshot and golden, regenerated with mjtpu and held to
the committed files (scripts/torch_port_assets.py): one file a
regeneration, so that pytest-xdist's --dist loadfile spreads them over its
workers."""

import numpy as np
import pytest

from mjtpu_torch._src import io
from tests.test_torch_assets import _assets_script, _regenerate, _snapshot_keys


@pytest.fixture(scope="module")
def regenerated(tmp_path_factory):
  """humanoid_bench's data files written afresh."""
  return _regenerate(tmp_path_factory.mktemp("assets"), "--model", "humanoid_bench")


def test_snapshot_file_is_fresh(regenerated):
  script = _assets_script()
  assert _snapshot_keys(script.MODEL_FILE) == sorted(io.SNAPSHOT_FIELDS)
  with np.load(regenerated / script.MODEL_FILE.name) as new, np.load(script.MODEL_FILE) as old:
    assert sorted(new.files) == sorted(old.files)
    for k in new.files:
      np.testing.assert_array_equal(new[k], old[k], err_msg=k)


def test_golden_file_is_fresh(regenerated):
  """Regenerating the golden trajectories with mjtpu reproduces the file."""
  script = _assets_script()
  with np.load(regenerated / script.GOLDEN_FILE.name) as new, np.load(script.GOLDEN_FILE) as old:
    assert sorted(new.files) == sorted(old.files)
    for k in new.files:
      np.testing.assert_allclose(new[k], old[k], rtol=0, atol=1e-12, err_msg=k)
