"""Device-idle milliseconds a frame inside the program's top-level spans
(``viewer.camera``, ``engine.set_camera``, ``engine.step``, ``engine.sync``,
``engine.display``): the window's idle gaps intersected with the union of
those spans, over the frames (the benchmark's ``frame`` spans) of the
interactive window. The rest of the idle time is the harness's."""

from ptbench import program_spans


def read(ctx):
    recs = program_spans.records(ctx)
    frames = program_spans.frames(ctx)
    if recs is None or not frames:
        return None
    busy_host = program_spans.top_level_on_trace(ctx, recs[0])
    return 1e3 * program_spans.overlap(busy_host, ctx.trace.gaps()) / frames
