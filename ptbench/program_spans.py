"""The program's own spans and counter in a traced window, for the readers
of ``metrics/``.

The port's tracer (``render/profiling.py``) is on while the profiler
records the window. Its spans and counts carry ``time.perf_counter_ns``
times, the clock of the benchmark's own spans, so a record belongs to the
window when its start lies inside the benchmark's ``window`` span, and it
goes onto the device trace's clock, whose 0 is the window annotation's
start, as ``start_ns·1e-9 − window start`` (the two starts lie within one
annotation's cost, ~10 µs, of each other).

A checkout whose program has no such tracer gives nothing to read: the
readers return None there. A tracer that holds no record in the window, or
dropped records that may lie in it, fails the run.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .devtrace import WINDOW, merge


def window(ctx) -> Tuple[float, float]:
    """The benchmark's window span, (start, end) on ``time.perf_counter``."""
    return ctx.spans.last(WINDOW)


def _is_span(record) -> bool:
    return hasattr(record, "start_ns")


def _start_s(record) -> float:
    return (record.start_ns if _is_span(record) else record.t_ns) * 1e-9


def records(ctx) -> Optional[Tuple[list, list]]:
    """The program's spans and counts that start inside the window of an
    interactive cell; None for another cell or a program without the
    tracer."""
    if ctx.cell.traffic["kind"] != "interactive":
        return None
    from cosc_4397_pathtracing_raytracing_project_tpu_torch.render import profiling

    if not hasattr(profiling, "records"):
        return None
    w0, w1 = window(ctx)
    recs = profiling.records()
    if profiling.counters()["dropped"] and (not recs or _start_s(recs[0]) >= w0):
        raise RuntimeError("the program's tracer dropped records that may lie in the window")
    inside = [r for r in recs if w0 <= _start_s(r) < w1]
    if not inside:
        raise RuntimeError("the program's tracer holds no record in the window")
    return [r for r in inside if _is_span(r)], [r for r in inside if not _is_span(r)]


def mean_ms(ctx, name: str) -> Optional[float]:
    """Mean milliseconds of the program's ``name`` spans in the window; None
    where the program records none."""
    recs = records(ctx)
    found = [s for s in recs[0] if s.name == name] if recs is not None else []
    if not found:
        return None
    return 1e-6 * sum(s.end_ns - s.start_ns for s in found) / len(found)


def frames(ctx) -> int:
    """The benchmark's ``frame`` spans that start inside the window."""
    return len(ctx.spans.durations("frame", within=WINDOW))


def overlap(a: List[Tuple[float, float]], b: List[Tuple[float, float]]) -> float:
    """Total length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def top_level_on_trace(ctx, spans: list) -> List[Tuple[float, float]]:
    """The union of the program's top-level spans, in seconds on the device
    trace's clock."""
    w0, _ = window(ctx)
    return merge((s.start_ns * 1e-9 - w0, s.end_ns * 1e-9 - w0)
                 for s in spans if s.parent == -1)
