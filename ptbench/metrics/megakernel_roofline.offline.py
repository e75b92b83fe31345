"""The megakernel's share of its roofline over the offline window (%)."""

from ptbench.roofline import window_share


def read(ctx):
    return window_share(ctx) if ctx.cell.traffic["kind"] == "offline" else None
