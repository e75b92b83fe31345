"""Share of the program's repacks in the interactive window that re-read
only the camera (``repack.camera``) among all of them (``repack.camera`` +
``repack.full``), in %: a drag's move that keeps the packed scene counts as
the first, a repack of every table as the second. None where the window
holds no repack, as under a program that counts neither."""

from ptbench import program_spans


def read(ctx):
    recs = program_spans.records(ctx)
    if recs is None:
        return None
    _spans, counts = recs
    camera = sum(c.n for c in counts if c.name == "repack.camera")
    full = sum(c.n for c in counts if c.name == "repack.full")
    if not camera + full:
        return None
    return 100.0 * camera / (camera + full)
