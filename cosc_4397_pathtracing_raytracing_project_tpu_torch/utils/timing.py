"""Timing utilities (currentTimeString parity, `src/preview.cpp:18-24`)."""

from __future__ import annotations

import time


def current_time_string() -> str:
    """UTC timestamp ``%Y-%m-%d_%H-%M-%Sz`` as in the reference filenames."""
    return time.strftime("%Y-%m-%d_%H-%M-%Sz", time.gmtime())
