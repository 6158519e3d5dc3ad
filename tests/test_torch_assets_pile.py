"""scene_pile's snapshot and golden, and the boxes snapshot, regenerated with
mjtpu and held to the committed files (scripts/torch_port_assets.py): one
file a regeneration, so that pytest-xdist's --dist loadfile spreads them
over its workers."""

import numpy as np
import pytest

from mjtpu_torch._src import io
from tests.test_torch_assets import _assets_script, _regenerate, _snapshot_keys


PILE_PREFIX = 5


@pytest.fixture(scope="module")
def regenerated_pile(tmp_path_factory):
  """scene_pile's data files written afresh, its golden over the first
  PILE_PREFIX steps only (the golden keeps every 5th step: one entry)."""
  return _regenerate(tmp_path_factory.mktemp("pile"), "--model", "scene_pile",
                     "--steps", str(PILE_PREFIX))


def test_pile_snapshot_file_is_fresh(regenerated_pile):
  """The pile snapshot, with mjtpu's box hulls (one per box geom), is what
  the script writes."""
  script = _assets_script()
  name = script.PILE_MODEL_FILE.name
  assert _snapshot_keys(script.PILE_MODEL_FILE) == sorted(io.SNAPSHOT_FIELDS)
  with np.load(regenerated_pile / name) as new, np.load(script.PILE_MODEL_FILE) as old:
    assert sorted(new.files) == sorted(old.files)
    assert sum(k.startswith("geomhull.") for k in new.files) == 16 * len(io.HULL_FIELDS)
    for k in new.files:
      np.testing.assert_array_equal(new[k], old[k], err_msg=k)


def test_pile_golden_file_is_fresh(regenerated_pile):
  """Regenerating the pile golden with mjtpu reproduces the committed
  file's step-1 fields and its state after step PILE_PREFIX."""
  script = _assets_script()
  name = script.PILE_GOLDEN_FILE.name
  with np.load(regenerated_pile / name) as new, np.load(script.PILE_GOLDEN_FILE) as old:
    assert sorted(new.files) == sorted(old.files)
    assert old["qpos"].shape[0] * script.PILE_EVERY == script.STEPS
    for k in new.files:
      want = old[k][:PILE_PREFIX // script.PILE_EVERY] if k in ("qpos", "qvel") else old[k]
      np.testing.assert_allclose(new[k], want, rtol=0, atol=1e-12, err_msg=k)


def test_boxes_snapshot_file_is_fresh(tmp_path):
  script = _assets_script()
  new_dir = _regenerate(tmp_path, "--model", "boxes")
  with np.load(new_dir / script.BOXES_MODEL_FILE.name) as new, \
      np.load(script.BOXES_MODEL_FILE) as old:
    assert sorted(new.files) == sorted(old.files)
    assert sum(k.startswith("geomhull.") for k in new.files) == 2 * len(io.HULL_FIELDS)
    for k in new.files:
      np.testing.assert_array_equal(new[k], old[k], err_msg=k)
