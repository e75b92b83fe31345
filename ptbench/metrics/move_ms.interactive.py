"""Mean host milliseconds of a camera move: from ``set_camera`` until the
moved frame's step has been queued (the scene's repack included)."""

import statistics

from ptbench.devtrace import WINDOW


def read(ctx):
    moves = ctx.spans.durations("move", within=WINDOW)
    return 1e3 * statistics.fmean(moves) if moves else None
