"""Structured logging (the ROS_INFO/ROS_ERROR replacement)."""

from __future__ import annotations

import logging
import os
import sys

_FORMAT = "%(asctime)s [%(levelname).1s] %(name)s: %(message)s"
_configured = False


def get_logger(name: str = "i3dr_stereo_tpu_torch") -> logging.Logger:
    global _configured
    if not _configured:
        level = os.environ.get("I3DR_LOG_LEVEL", "INFO").upper()
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        root = logging.getLogger("i3dr_stereo_tpu_torch")
        root.addHandler(handler)
        root.setLevel(level)
        root.propagate = False
        _configured = True
    return logging.getLogger(name)
