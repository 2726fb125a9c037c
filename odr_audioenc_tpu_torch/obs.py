"""Host spans and counts at the boundaries of the port's layers.

    with obs.span("dabplus.au") as sp:
        sp.add("a", a)
        ...

A span records its name, the span open around it on the same thread (its
parent), its start and end on `time.perf_counter_ns`, and named counts.
Closed spans are kept in a bounded store (`spans()`, `dropped()`,
`clear()`); the oldest go first once it is full.

Spans are recorded only while a torch profiler session records, or inside
an `enabled()` block.  Otherwise `span` returns one shared no-op object
after a single flag check.  A recorded span also enters a profiler range
that is not a user annotation (`torch._C._profiler._RecordFunctionFast`),
so that it lands among the profiler's host events, on the device trace's
clock, and is not mirrored onto the device timeline.  A span reads no
device value: it adds no host sync and no device work, on or off.
"""
import functools
import threading
import time
from collections import deque
from contextlib import contextmanager

import torch
from torch.autograd import profiler as _profiler

LIMIT = 1 << 16          # spans the store keeps

_forced = 0              # depth of open enabled() blocks
_open = threading.local()
_lock = threading.Lock()
_store = deque(maxlen=LIMIT)
_dropped = 0


class Span:
    """One recorded span: name, parent (a Span or None), start_ns, end_ns
    and counts {name: number}."""
    __slots__ = ("name", "parent", "start_ns", "end_ns", "counts", "_range")

    def __init__(self, name):
        self.name = name
        self.parent = None
        self.start_ns = self.end_ns = 0
        self.counts = {}

    def add(self, key, n=1):
        self.counts[key] = self.counts.get(key, 0) + n

    # the span's own bookkeeping falls inside its start and end, so that
    # the stages of a parent cover it and its self time is its own code
    def __enter__(self):
        self.start_ns = time.perf_counter_ns()
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self._range = torch._C._profiler._RecordFunctionFast(self.name)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        global _dropped
        self._range.__exit__(*exc)
        self._range = None
        _open.stack.pop()
        self.end_ns = time.perf_counter_ns()
        with _lock:
            if len(_store) == _store.maxlen:
                _dropped += 1
            _store.append(self)
        return False


class _Off:
    """The span handed out while nothing records."""
    __slots__ = ()

    def add(self, key, n=1):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name):
    """A context manager that records the span `name` while recording is on."""
    if not (_forced or _profiler._is_profiler_enabled):
        return _OFF
    return Span(name)


def spanned(name):
    """Decorator: each call of the function is the span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


@contextmanager
def enabled():
    """Record spans inside the block, with no profiler on."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def spans():
    """The kept spans, in the order they closed."""
    with _lock:
        return list(_store)


def dropped():
    """Spans the store let go since the last clear(), for want of room."""
    return _dropped


def clear():
    global _dropped
    with _lock:
        _store.clear()
        _dropped = 0
