"""The device's idle share of the traced offline window (%): the window less
the union of the device's operations, over the window. A trace in which
none of the configuration's ``kernels`` appears fails the run rather than
reading 100% idle."""

from ptbench.manifest import setting


def read(ctx):
    if ctx.cell.traffic["kind"] != "offline":
        return None
    kernels = setting(ctx.cell.config, "kernels")
    if ctx.trace.kernel_seconds(kernels) is None:
        raise RuntimeError(f"the profiler saw no kernel of the configuration's {kernels}")
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
