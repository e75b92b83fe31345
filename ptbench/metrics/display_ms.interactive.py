"""Mean host milliseconds of the preview read-back, ``display_image``:
tonemapping on the device and the uint8 frame's copy to the host."""

import statistics

from ptbench.devtrace import WINDOW


def read(ctx):
    shown = ctx.spans.durations("display", within=WINDOW)
    return 1e3 * statistics.fmean(shown) if shown else None
