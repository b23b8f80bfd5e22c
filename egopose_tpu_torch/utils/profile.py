"""The program's spans, and torch.profiler sessions of the CLIs'
``--profile-dir``.

``span(name)`` marks one layer of the step (``with span("env.step"):``).
It is on while a torch.profiler session records (the CLIs'
``--profile-dir``, a benchmark's traced slice) or between ``enable()`` and
``disable()``.  Off, it returns one shared no-op context manager: it reads
two flags and calls nothing.  On, it stamps the span's start and end with
``time.perf_counter_ns()``, keeps the span (name, start, end, parent, key)
in a bounded in-memory buffer, and enters
``torch.profiler.record_function(name)``, so the span is also a
``user_annotation`` event of the profiler's trace (and, on CUDA, a
``gpu_user_annotation`` over its kernels).  A span is kept only when the
tracer was on both when it opened and when it closed: one cut by the start
or the stop of a profiler session is dropped whole.  No span synchronises
or launches a kernel.

``timed(name)`` is a span that stamps its start and end whether the tracer
is on or off, for the few intervals the program reports in seconds
(``sample``, ``update``, ``eval.rollout``, ``setup.build_kernels``):
``.seconds`` after the block.

``spans()`` returns the kept spans with their starts and ends on the
profiler trace's clock (unix nanoseconds: the Chrome trace's ``ts +
baseTimeNanoseconds / 1e3`` microseconds), converted by one offset taken
against ``time.time_ns()`` when the tracer is made.  A root span's key (the
eval step t, the training iteration) passes to its descendants; a keyed
span below a keyed ancestor gets the pair (ancestor's key, own key): a
rollout step inside an iteration is (iteration, t).  Each thread nests
its own spans (a CLI's prefetch thread has roots of its own).

``count(name, n)`` adds ``n`` to a counter while the tracer is on, as a
span is kept; ``counts()`` returns them (the state-regression step counts
the frames its CNN runs on, padding included).

``profiled(profile_dir, device, logger, name)`` records a block under
torch.profiler into ``<profile_dir>/<name>`` (chrome://tracing or Perfetto
open it): the CLIs' ``--profile-dir`` writes the set-up, with its
``setup.*`` spans, to ``setup_trace.json`` and the loop to ``trace.json``.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Any, NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

MAX_SPANS = 1 << 16       # the buffer keeps the newest spans


class SpanRecord(NamedTuple):
    """One kept span; ``start`` and ``end`` in unix nanoseconds."""
    id: int
    name: str
    start: int
    end: int
    parent: int | None    # the id of the enclosing span open when it opened
    key: Any


class _Off:
    """The shared no-op span of the off path."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _Span:
    __slots__ = ("tracer", "name", "key", "id", "parent", "start", "end",
                 "_rf")

    def __init__(self, tracer: "Tracer", name: str, key=None):
        self.tracer, self.name, self.key = tracer, name, key
        self._rf = None

    def __enter__(self):
        tr = self.tracer
        if tr.on or _autograd_profiler._is_profiler_enabled:
            self.id = next(tr._ids)
            up = tr._open[-1] if tr._open else None
            self.parent = up.id if up is not None else None
            if up is not None and up.key is not None:
                self.key = up.key if self.key is None else (up.key, self.key)
            tr._open.append(self)
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        if self._rf is not None:
            tr = self.tracer
            self._rf.__exit__(*exc)
            self._rf = None
            tr._open.pop()
            if tr.on or _autograd_profiler._is_profiler_enabled:
                tr._kept.append((self.id, self.name, self.start, self.end,
                                 self.parent, self.key))
        return False

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9


class Tracer:
    """The process's spans: one buffer that every layer's spans share, as
    the profiler session they sit in is one per process."""

    def __init__(self):
        self.on = False
        self._kept = collections.deque(maxlen=MAX_SPANS)
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._counts = {}
        self._offset_ns = time.time_ns() - time.perf_counter_ns()

    @property
    def _open(self) -> list:
        """The spans open on the calling thread, innermost last."""
        try:
            return self._local.open
        except AttributeError:
            self._local.open = []
            return self._local.open

    def span(self, name: str, key=None):
        if self.on or _autograd_profiler._is_profiler_enabled:
            return _Span(self, name, key)
        return OFF

    def timed(self, name: str) -> _Span:
        return _Span(self, name)

    def count(self, name: str, n=1):
        if self.on or _autograd_profiler._is_profiler_enabled:
            self._counts[name] = self._counts.get(name, 0) + n

    def counts(self) -> dict:
        return dict(self._counts)

    def enable(self):
        self.on = True

    def disable(self):
        self.on = False

    def clear(self):
        self._kept.clear()
        self._counts.clear()

    def spans(self) -> list:
        off = self._offset_ns
        return [SpanRecord(i, n, s + off, e + off, p, k)
                for i, n, s, e, p, k in self._kept]


TRACER = Tracer()
span, timed, count = TRACER.span, TRACER.timed, TRACER.count
enable, disable, clear, spans, counts = TRACER.enable, TRACER.disable, \
    TRACER.clear, TRACER.spans, TRACER.counts


@contextlib.contextmanager
def profiled(profile_dir, device, logger, name="trace.json"):
    """Record the body under torch.profiler -- the host and, on a CUDA
    ``device``, the card, waited for at the end -- and write it to
    ``<profile_dir>/<name>``; with no ``profile_dir`` run the body as it
    is."""
    if not profile_dir:
        yield
        return
    os.makedirs(profile_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    path = os.path.join(profile_dir, name)
    prof.export_chrome_trace(path)
    logger.info("wrote profiler trace to %s" % path)
