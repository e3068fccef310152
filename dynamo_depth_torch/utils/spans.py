"""Named spans at the boundaries of the training step, with two sinks.

``span(name)`` marks a region of host code:

- while ``torch.profiler`` runs, it enters ``record_function(name)``, so the
  region lands in the profiler's Chrome trace as a ``user_annotation`` on
  the timeline of the runtime calls and kernels it issued;
- while a ``recording()`` is open, it also appends a :class:`Span` to the
  recording, timed on ``time.perf_counter_ns``;
- with neither on, it reads two flags and enters nothing.

The recording is kept in memory and handed back when it closes: each span
with the index of the span it nests in, and the step of its root span.
Spans are entered and left on one thread, the one that runs the step.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import List, NamedTuple, Optional

from torch.autograd import profiler as _profiler


class Span(NamedTuple):
    name: str
    parent: int  # index in the recording of the enclosing span, -1 for a root
    step: Optional[int]  # the root's ``step``, shared by the spans inside it
    start_ns: int  # time.perf_counter_ns
    end_ns: int


class _Recording:
    def __init__(self):
        self.spans: List[Optional[Span]] = []  # None until the span is left
        self.open: List[tuple] = []  # (index, step) of the spans entered and not yet left


_recording: Optional[_Recording] = None


class _Off:
    """What ``span`` returns with neither sink on."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "step", "annotation", "index", "parent", "start_ns")

    def __init__(self, name: str, step: Optional[int]):
        self.name, self.step = name, step

    def __enter__(self):
        self.annotation = None
        if _profiler._is_profiler_enabled:
            self.annotation = _profiler.record_function(self.name)
            self.annotation.__enter__()
        self.index = -1
        rec = _recording
        if rec is not None:
            self.parent, step = rec.open[-1] if rec.open else (-1, self.step)
            self.index = len(rec.spans)
            rec.spans.append(None)
            rec.open.append((self.index, step))
        self.start_ns = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        end_ns = time.perf_counter_ns()
        rec = _recording
        if rec is not None and self.index >= 0:
            _, step = rec.open.pop()
            rec.spans[self.index] = Span(self.name, self.parent, step, self.start_ns, end_ns)
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        return False


def span(name: str, step: Optional[int] = None):
    """A context manager around the region ``name``; ``step`` is given on a
    root span and is recorded on every span inside it."""
    if _recording is None and not _profiler._is_profiler_enabled:
        return _OFF
    return _On(name, step)


@contextmanager
def recording():
    """Record every span entered inside the block; yields the list of
    :class:`Span` that is complete when the block has closed."""
    global _recording
    if _recording is not None:
        raise RuntimeError("a span recording is already open")
    rec = _Recording()
    _recording = rec
    try:
        yield rec.spans
    finally:
        _recording = None
