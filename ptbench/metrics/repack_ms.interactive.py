"""Mean host milliseconds of the program's ``engine.repack`` spans in the
interactive window: the move's repack of the scene's tables (with the
map's texel table) inside the step after ``set_camera``."""

from ptbench import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, "engine.repack")
