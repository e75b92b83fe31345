"""The program's ``host_syncs`` counted in the interactive window, per frame
(the benchmark's ``frame`` spans in the window): the places where the host
waited for the device, reads back, copies from pageable host memory and
``Renderer.sync``."""

from ptbench import program_spans


def read(ctx):
    recs = program_spans.records(ctx)
    frames = program_spans.frames(ctx)
    if recs is None or not frames:
        return None
    _spans, counts = recs
    return sum(c.n for c in counts if c.name == "host_syncs") / frames
