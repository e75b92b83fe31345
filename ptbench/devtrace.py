"""Host spans and the device's timeline over the measured window.

Spans are the benchmark's own, around its calls into the program: a name,
a start and an end on the host's clock. In a traced run each span is also a
``torch.profiler.record_function`` annotation, so the profiler's trace puts
the host spans and the device's operations on one clock; from it come the
seconds the device was busy, the operations that took most of them, and the
idle gaps by the innermost span the host was in.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

WINDOW = "window"
# the megakernel source's two kernels (csrc/megakernel.cu)
MEGAKERNEL_NAMES = ("pt_megakernel", "pt_env_rows")


class Spans:
    """(name, start, end) records on ``time.perf_counter``'s clock."""

    def __init__(self, traced: bool = False):
        self.traced = traced
        self.records: List[Tuple[str, float, float]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        annotation = None
        if self.traced:
            import torch

            annotation = torch.profiler.record_function(name)
            annotation.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            if annotation is not None:
                annotation.__exit__(None, None, None)
            self.records.append((name, t0, t1))

    def last(self, name: str) -> Tuple[float, float]:
        """(start, end) of the last span ``name``."""
        return next((t0, t1) for n, t0, t1 in reversed(self.records) if n == name)

    def durations(self, name: str, within: Optional[str] = None) -> List[float]:
        """The seconds of the spans ``name``; with ``within``, of those that
        start inside the last span of that name."""
        if within is None:
            return [t1 - t0 for n, t0, t1 in self.records if n == name]
        w0, w1 = self.last(within)
        return [t1 - t0 for n, t0, t1 in self.records if n == name and w0 <= t0 < w1]


def short_name(name: str, width: int = 96) -> str:
    """A device operation's name without ``void`` and its argument list."""
    if name.startswith("void "):
        name = name[5:]
    name = name.replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i:
            name = name[:i]
            break
    return name[:width].strip()


def merge(intervals):
    """The union of (start, end) intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class DeviceTrace:
    """The device's operations and the host's annotations of one traced
    window, in seconds from the window's start."""

    def __init__(self, ops, annotations, window_s: float):
        self.ops = ops  # [(name, start, end)] device operations inside the window
        self.annotations = annotations  # [(name, start, end)] host spans
        self.window_s = window_s
        self.busy = merge((s, e) for _n, s, e in ops)

    @classmethod
    def from_events(cls, events) -> "DeviceTrace":
        """From (name, is_device, start_ns, end_ns) events, the window being
        the annotation named ``WINDOW``."""
        events = list(events)
        windows = [(s, e) for n, dev, s, e in events if not dev and n == WINDOW]
        if not windows:
            raise RuntimeError("the trace holds no window annotation")
        w0, w1 = windows[-1]
        ops, notes = [], []
        for name, dev, s, e in events:
            s, e = max(s, w0), min(e, w1)
            if e <= s:
                continue
            rec = (name, (s - w0) * 1e-9, (e - w0) * 1e-9)
            if dev:
                ops.append(rec)
            elif name != WINDOW:
                notes.append(rec)
        return cls(ops, notes, (w1 - w0) * 1e-9)

    @classmethod
    def from_profiler(cls, prof, span_names) -> "DeviceTrace":
        names = set(span_names) | {WINDOW}
        events = []
        for e in prof.profiler.kineto_results.events():
            is_device = "CUDA" in str(e.device_type())
            name = e.name()
            # the host's annotations, whose device-side copies are no operation
            if (name in names) == is_device:
                continue
            start = e.start_ns()
            events.append((name, is_device, start, start + e.duration_ns()))
        return cls.from_events(events)

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy)

    def op_seconds(self) -> Dict[str, float]:
        total: Dict[str, float] = defaultdict(float)
        for name, s, e in self.ops:
            total[name] += e - s
        return dict(total)

    def kernel_seconds(self, names=MEGAKERNEL_NAMES) -> Optional[float]:
        """Device seconds of the operations whose name holds one of
        ``names``; None when the trace holds none of them."""
        hits = [e - s for n, s, e in self.ops if any(k in n for k in names)]
        return sum(hits) if hits else None

    def gaps(self):
        """The idle intervals of the window."""
        out, t = [], 0.0
        for s, e in self.busy:
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if t < self.window_s:
            out.append((t, self.window_s))
        return out

    def idle_by_span(self) -> Dict[str, float]:
        """Idle seconds by the innermost host span around each gap's middle
        ('other' outside every span)."""
        notes = sorted(self.annotations, key=lambda a: a[1])
        total: Dict[str, float] = defaultdict(float)
        active, i = [], 0
        for s, e in self.gaps():  # in ascending order: one sweep over the spans
            mid = 0.5 * (s + e)
            while i < len(notes) and notes[i][1] <= mid:
                active.append(notes[i])
                i += 1
            active = [a for a in active if a[2] >= mid]
            name = min(active, key=lambda a: a[2] - a[1])[0] if active else "other"
            total[name] += e - s
        return dict(total)

    def breakdown(self, top: int = 10) -> dict:
        """The operations that took most device time, by their name up to
        its argument list, and the longest idle gaps by span."""
        total: Dict[str, float] = defaultdict(float)
        for name, s in self.op_seconds().items():
            total[short_name(name)] += s
        ops = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_span().items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}
