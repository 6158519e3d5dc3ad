"""The library's logger (port of mjtpu/_src/log.py): ``mujoco_logger``,
its level from the environment variable MJTPU_LOGGING_LEVEL, as mjtpu's."""

from __future__ import annotations

import logging
import os

mujoco_logger = logging.getLogger("mjtpu_torch")
_level = os.environ.get("MJTPU_LOGGING_LEVEL")
if _level:
  mujoco_logger.setLevel(_level.upper())
