"""Tracing and profiling: the port's spans and counters, ``torch.profiler``
traces and the pipeline's bounce timing.

The program's spans and counters (:data:`TRACER`, through the module's
:func:`span`, :func:`count`, :func:`records`, :func:`counters` and
:func:`enable`):

- ``span(name)`` is a context manager around a piece of host work. The
  tracer is on while a ``torch.profiler`` is recording or after
  ``enable(True)``. Off, a span is one flag check and a shared no-op context
  manager: it reads no clock and records nothing. On, it appends
  ``Span(name, start_ns, end_ns, parent)`` to a bounded ring
  (``time.perf_counter_ns``; ``parent`` is the index of the enclosing span
  of the same thread, -1 at the top) and enters a profiler record, so the
  span shows in any profiler trace and in :func:`trace`'s Chrome trace. The
  record is a function-scope one: a ``record_function`` annotation would
  also put a device-side copy of the span on the card's timeline, which a
  reader of that timeline would count as device work.
- ``count(name, n)`` adds ``n`` to the counter's total, always; with the
  tracer on it also appends an instant ``Count(name, t_ns, n)``, so a
  reader can count inside a window of time.
- Records are indexed from 0 in the order they were appended (a span when
  it is entered); when the ring is full each new record takes the place of
  the oldest, and ``counters()["dropped"]`` says how many were lost, which
  is also the index of the oldest record ``records()`` returns.

Spans of the interactive path: ``viewer.camera``, ``engine.set_camera``,
``engine.step`` (with ``engine.repack`` inside when the scene changed),
``engine.sync``, ``engine.display`` and ``engine.readback``. The counter
``host_syncs`` counts each place on the step, move and display path where
the host waits for the device: a read back to the host, a copy from
pageable host memory to the device, ``Renderer.sync``. Inside
``engine.repack``, ``repack.full`` counts a repack of every table and
``repack.camera`` one that re-reads only the camera.

``profile_pipeline`` times the production pipeline a configuration resolves
to, bounce by bounce; ``trace`` records a ``torch.profiler`` trace. The
JAX package's ``profile_stages`` (the readable pipeline's stages, one by
one) and ``annotate`` have no counterpart: nothing of the port called the
first, and ``span`` takes the place of the second.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from typing import Dict, List, NamedTuple, Union

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

# the records the ring holds: a 30 s interactive window appends ~200,000
RING = 1 << 20

_clock = time.perf_counter_ns
_record_function = _RecordFunctionFast


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int  # index of the enclosing span of the same thread, -1 at the top


class Count(NamedTuple):
    name: str
    t_ns: int
    n: int


_OFF = contextlib.nullcontext()  # the span of a tracer that is off


class _On:
    __slots__ = ("tracer", "name", "index", "parent", "start", "record")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        stack = self.tracer._stack()
        self.parent = stack[-1] if stack else -1
        self.index = self.tracer._append(None)  # its place, filled when it ends
        stack.append(self.index)
        self.record = _record_function(self.name)
        self.record.__enter__()
        self.start = _clock()
        return self

    def __exit__(self, *exc):
        end = _clock()
        self.record.__exit__(*exc)
        self.tracer._stack().pop()
        self.tracer._fill(self.index, Span(self.name, self.start, end, self.parent))
        return False


class Tracer:
    """Spans and counters of one process (the module's :data:`TRACER`)."""

    def __init__(self, capacity: int = RING):
        self.capacity = int(capacity)
        self.forced = False
        self.totals: Dict[str, int] = {}
        self._ring: list = [None] * self.capacity
        self._next = 0  # records appended so far: the next record's index
        self._lock = threading.Lock()
        self._local = threading.local()

    def span(self, name: str):
        """A context manager around host work named ``name`` (a no-op while
        the tracer is off)."""
        if self.forced or _autograd_profiler._is_profiler_enabled:
            return _On(self, name)
        return _OFF

    def count(self, name: str, n: int = 1) -> None:
        self.totals[name] = self.totals.get(name, 0) + n
        if self.forced or _autograd_profiler._is_profiler_enabled:
            self._append(Count(name, _clock(), n))

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _append(self, record) -> int:
        with self._lock:
            index = self._next
            self._ring[index % self.capacity] = record
            self._next = index + 1
        return index

    def _fill(self, index: int, record: Span) -> None:
        with self._lock:
            if index >= self._next - self.capacity:  # not yet overwritten
                self._ring[index % self.capacity] = record

    @property
    def dropped(self) -> int:
        return max(0, self._next - self.capacity)

    def records(self) -> List[Union[Span, Count]]:
        """The ring's records in index order from record ``dropped``, spans
        still open left out (with none open, record ``i`` is
        ``records()[i - dropped]``)."""
        with self._lock:
            first, end = self.dropped, self._next
            out = [self._ring[i % self.capacity] for i in range(first, end)]
        return [r for r in out if r is not None]

    def counters(self) -> dict:
        """The counters' totals, ``dropped``, and the megakernel binding's
        launch counts (``launches``, ``row_launches``,
        ``launches_by_variant``), read where they are kept."""
        from ..ops.cuda import megakernel

        kernel = megakernel.KERNEL
        return {**self.totals, "dropped": self.dropped, "launches": kernel.launches,
                "row_launches": kernel.row_launches,
                "launches_by_variant": dict(kernel.launches_by_variant)}


TRACER = Tracer()
span = TRACER.span
count = TRACER.count
records = TRACER.records
counters = TRACER.counters


def enable(on: bool = True) -> None:
    """Keep the tracer on (or leave it to the profiler) from now on."""
    TRACER.forced = bool(on)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time(fn, *args, device: torch.device, reps: int = 10) -> float:
    """Milliseconds a call of ``fn(*args)``, the mean of ``reps`` after one
    warm-up call."""
    fn(*args)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    _sync(device)
    return (time.perf_counter() - t0) / reps * 1e3


def profile_pipeline(scene, config, seed: int = 0, reps: int = 3) -> Dict[str, float]:
    """Bounce-granularity timing of the pipeline ``config`` resolves to
    (``"pallas"``: the megakernel, ``"fast_mesh"``: the mesh pipeline over
    the triangle kernels, ``"fast"`` or ``"reference"``), rendering one
    sample at increasing trace depths. Every bounce is the same work, so the
    depth slope separates the per-bounce cost from the fixed cost:

      fixed_ms          ≈ t(1) − per_bounce_ms
      per_bounce_ms     = (t(D) − t(2)) / (D − 2)

    Times are host clock around the calls, after a warm-up call, with the
    scene's device synchronised before and after on a CUDA device. Returns
    total/per-bounce/fixed milliseconds and the pipeline's name."""
    from ..ops import fast
    from ..ops import rng as rng_ops
    from ..ops.cuda import megakernel
    from .engine import make_mesh_intersector, trace_sample

    depth = max(int(config.trace_depth), 3)
    pipeline = config.resolve_pipeline(scene)
    dev = scene.device
    mesh_isect = make_mesh_intersector(scene) if pipeline == "fast_mesh" else None

    def runner(d: int):
        cfg = dataclasses.replace(config, trace_depth=d)
        if pipeline == "pallas":
            packed = megakernel.pack_scene(
                scene, nee=megakernel.kernel_options(cfg, scene).nee, config=cfg
            )
            return lambda: megakernel.render_samples(
                scene, cfg, rng_ops.kernel_seed(seed), 1, 1, packed=packed
            )
        if pipeline == "fast_mesh":
            return lambda: fast.trace_sample_mesh(scene, cfg, seed, 1, mesh_isect)
        if pipeline == "fast":
            return lambda: fast.trace_sample_fast(scene, cfg, seed, 1)
        return lambda: trace_sample(scene, cfg, seed, 1, pipeline=pipeline)

    t1 = _time(runner(1), device=dev, reps=reps)
    t2 = _time(runner(2), device=dev, reps=reps)
    td = _time(runner(depth), device=dev, reps=reps)
    # clamp: on a loaded host the deeper render can time faster than the
    # shallow one, which would report a negative marginal bounce cost
    per_bounce = max((td - t2) / max(depth - 2, 1), 0.0)
    return {
        "pipeline": pipeline,
        "depth": depth,
        "total_ms": round(td, 3),
        "bounce1_ms": round(t1, 3),
        "per_bounce_ms": round(per_bounce, 3),
        "fixed_ms": round(max(t1 - per_bounce, 0.0), 3),
    }


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace of the CPU and, where there is one, the CUDA
    device, written into ``log_dir`` as a Chrome trace
    (``trace.json``, for chrome://tracing or Perfetto); the program's spans
    are on it while it records."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
