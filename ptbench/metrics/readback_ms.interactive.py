"""Mean host milliseconds of the program's ``engine.readback`` spans in the
interactive window: the preview frame's copy to the host."""

from ptbench import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, "engine.readback")
