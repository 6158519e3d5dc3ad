"""humanoid_bench_elliptic's snapshot and golden, regenerated with mjtpu and
held to the committed files (scripts/torch_port_assets.py): one file a
regeneration, so that pytest-xdist's --dist loadfile spreads them over its
workers."""

import numpy as np
import pytest

from mjtpu_torch._src import io, types
from tests.test_torch_assets import _assets_script, _regenerate, _snapshot_keys


ELLIPTIC_PREFIX = 5


@pytest.fixture(scope="module")
def regenerated_elliptic(tmp_path_factory):
  """humanoid_bench_elliptic's data files written afresh, both golden runs
  over their first ELLIPTIC_PREFIX steps (the rest is held by
  tests/test_torch_elliptic.py against the port)."""
  return _regenerate(tmp_path_factory.mktemp("elliptic"), "--model", "humanoid_bench_elliptic",
                     "--steps", str(ELLIPTIC_PREFIX))


def test_elliptic_snapshot_file_is_fresh(regenerated_elliptic):
  script = _assets_script()
  assert _snapshot_keys(script.ELLIPTIC_MODEL_FILE) == sorted(io.SNAPSHOT_FIELDS)
  with np.load(regenerated_elliptic / script.ELLIPTIC_MODEL_FILE.name) as new, \
      np.load(script.ELLIPTIC_MODEL_FILE) as old:
    assert sorted(new.files) == sorted(old.files)
    assert int(old["opt.cone"]) == types.ConeType.ELLIPTIC
    for k in new.files:
      np.testing.assert_array_equal(new[k], old[k], err_msg=k)


def test_elliptic_golden_file_is_fresh(regenerated_elliptic):
  """Regenerating the elliptic golden with mjtpu reproduces the committed
  file's forward fields and the first ELLIPTIC_PREFIX steps of both
  configurations' runs, batched and solo."""
  script = _assets_script()
  name = script.ELLIPTIC_GOLDEN_FILE.name
  runs = tuple(f"{c}{r}{f}" for c in ("", "conv_") for r in ("", "solo_", "solo_run_")
               for f in ("qpos", "qvel")) + ("warm", "conv_warm")
  with np.load(regenerated_elliptic / name) as new, np.load(script.ELLIPTIC_GOLDEN_FILE) as old:
    assert sorted(new.files) == sorted(old.files)
    assert old["qpos"].shape[:2] == (script.STEPS, script.BATCH)
    for k in new.files:
      want = old[k][:ELLIPTIC_PREFIX] if k in runs else old[k]
      np.testing.assert_allclose(new[k], want, rtol=0, atol=1e-12, err_msg=k)
