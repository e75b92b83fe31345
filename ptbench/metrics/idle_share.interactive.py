"""The device's idle share of the traced interactive window (%): the window less
the union of the device's operations, over the window. A trace in which
the megakernel's kernels do not appear fails the run rather than reading
100% idle."""


def read(ctx):
    if ctx.cell.traffic["kind"] != "interactive":
        return None
    if ctx.trace.kernel_seconds() is None:
        raise RuntimeError("the profiler saw no kernel of csrc/megakernel.cu")
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
