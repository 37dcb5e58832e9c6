"""The port's spans: named host intervals around the stages of the train
step, the served call, the loader's wait and the train state's set-up.

    with tracing.span("r2l.step"):
        ...
    programs = {n: tracing.span(f"r2l.staged.{n}", fn) for n, fn in ...}

Tracing is off by default. Off, ``span`` returns one shared object whose
``with`` does nothing, after a single read of a module flag: it records
nothing, enters no profiler range and allocates nothing. On
(``enable()``), each span enters ``torch.profiler.record_function`` of
its name, so it lands in any running ``torch.profiler`` trace, and on
exit appends a ``Span(name, start_ns, end_ns)`` to an in-memory record
that ``disable()`` hands back and clears. Timestamps are
``time.time_ns()``, the Unix-epoch clock the profiler stamps its host
events with, so a span lies on a trace's time line; each interval holds
its profiler range (taken before the range opens and after it closes).
A span's children are the spans inside its interval on its thread.

Either way a span is a host interval only: it never synchronises, reads
a device value or records a CUDA event. Device time is put down to a
span by whoever reads the trace, from the host launch of each device
record. The names all start with ``r2l.``; the kernels' ``.launches``
counters (``kernels/``) are the port's other instrumentation.

``--profile`` (``training/train.py``, ``StepProfiler``) turns tracing on
for its window, so its ``trace.json`` carries the spans.
"""

import collections
import functools
import time

import torch

Span = collections.namedtuple("Span", "name start_ns end_ns")

_on = False
_record = []


class _Noop:
    """What ``span`` returns while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class _Open:
    """A span while tracing is on: a profiler range and an interval."""

    __slots__ = ("name", "start", "range")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.start = time.time_ns()
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        _record.append(Span(self.name, self.start, time.time_ns()))
        return False


def span(name, fn=None):
    """A span named ``name`` (``with span(name): ...``), or, given ``fn``,
    ``fn`` wrapped so that each call runs inside one."""
    if fn is not None:
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return spanned
    if not _on:
        return NOOP
    return _Open(name)


def enable():
    """Turn tracing on."""
    global _on
    _on = True


def disable():
    """Turn tracing off; returns the spans recorded (in the order they
    closed) and clears the record."""
    global _on, _record
    _on = False
    out, _record = _record, []
    return out
