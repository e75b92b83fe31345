"""Seconds of the ``Renderer``'s construction: parsing, the scene's device
tables and, under a map, its texel distribution and alias table."""


def read(ctx):
    built = ctx.spans.durations("scene_build")
    return built[0] if built else None
