"""The card a run used: its name and power limit (``nvidia-smi``), which
every rate and share is written beside."""

from __future__ import annotations

import functools
import subprocess


@functools.lru_cache(maxsize=None)
def device_line() -> str:
    """e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``; what could not be read
    says so."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, check=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "power limit not read"
