"""Spans and counters of the port's layers, kept in process on the
profiler's clock.

A span marks one step of a layer, from the library's call down to a
graph's replay::

    from saugns_tpu_torch import tracing

    with tracing.span('plan.build'):
        ...

Each span records its name, its start and end, its parent span, the
request it belongs to and whether a torch profiler was recording when
that request began (``profiled``). A span opened where the thread has
none open starts a request of its own (a new id); one opened inside
another joins its request, so ``render.generator`` inside ``render.call``
is one request. Each thread keeps its own stack of open spans.

``count(name, n)`` adds to the counters of the thread's open request,
which its root span's record holds.

Closed spans go to a ring of the last ``RING`` records (``records()``);
what falls out of it is counted (``dropped()``). ``clear()`` empties
both.

The clock: a span is timed with ``time.perf_counter_ns()`` and its
record carries its start and end on the clock of the profiler's events
(kineto's, ``time.time_ns()``'s), through one offset between the two
taken at import. While a profiler records, and only then, every span
also opens a ``torch.profiler.record_function`` of its own name inside
its own interval, so a profile shows the port's spans among its host
events by name.
"""
from __future__ import annotations

import collections
import functools
import itertools
import sys
import threading
import time

RING = 65536


def _offset_ns():
    """The profiler's clock minus ``perf_counter_ns()``: the mean of two
    ``time_ns()`` readings around one ``perf_counter_ns()``."""
    a = time.time_ns()
    p = time.perf_counter_ns()
    b = time.time_ns()
    return (a + b) // 2 - p


OFFSET_NS = _offset_ns()

_ring = collections.deque(maxlen=RING)
_lock = threading.Lock()
_span_ids = itertools.count(1)
_request_ids = itertools.count(1)
_dropped = [0]
_modules = sys.modules
_clock = time.perf_counter_ns


class _Stacks(threading.local):
    """Each thread's open spans, innermost last."""

    def __init__(self):
        self.spans = []


_stacks = _Stacks()


class Span:
    """One span: a context manager, and after it closes a record of
    ``records()``. ``start_ns`` and ``end_ns`` lie on the profiler's
    clock; ``parent`` is the parent's ``sid`` (None for a request's
    root), ``counters`` the request's counts on its root (else None).

    ``open()`` / ``close()`` are ``with``'s two halves; ``suspend()``
    and ``resume()`` take an open span off its thread's stack and put
    it back, for a span that lasts across calls (a generator's stream,
    from its first ``run()`` to its last sample)."""

    __slots__ = ('name', 'sid', 'parent', 'request', 'profiled',
                 'counters', 'start_ns', 'end_ns', 'child_ns', '_up',
                 '_root', '_mirror')

    def __init__(self, name):
        self.name = name
        self.end_ns = None

    def open(self):
        self.start_ns = _clock()
        st = _stacks.spans
        self.sid = next(_span_ids)
        self.child_ns = 0
        # torch's profiler module, where a profiler records (without
        # torch imported, none does)
        prof = _modules.get('torch.autograd.profiler')
        if prof is not None and not prof._is_profiler_enabled:
            prof = None
        if st:
            up = st[-1]
            self.parent = up.sid
            self.request = up.request
            self.profiled = up.profiled
            self.counters = None
            self._root = up._root
        else:
            up = None
            self.parent = None
            self.request = next(_request_ids)
            self.profiled = prof is not None
            self.counters = {}
            self._root = self
        self._up = up
        st.append(self)
        if prof is None:
            self._mirror = None
        else:
            self._mirror = prof.record_function(self.name)
            self._mirror.__enter__()
        return self

    def close(self):
        if self.end_ns is not None:
            return
        if self._mirror is not None:
            self._mirror.__exit__(None, None, None)
            self._mirror = None
        self.suspend()
        dur = _clock() - self.start_ns
        if self._up is not None:
            self._up.child_ns += dur
        self._up = self._root = None
        self.start_ns += OFFSET_NS
        self.end_ns = self.start_ns + dur
        with _lock:
            if len(_ring) == RING:
                _dropped[0] += 1
            _ring.append(self)

    def suspend(self):
        st = _stacks.spans
        if st and st[-1] is self:
            st.pop()
        elif self in st:
            st.remove(self)

    def resume(self):
        if self.end_ns is None:
            _stacks.spans.append(self)

    __enter__ = open

    def __exit__(self, *exc):
        self.close()

    @property
    def dur_ns(self):
        return self.end_ns - self.start_ns

    @property
    def seconds(self):
        """The closed span's duration in seconds."""
        return (self.end_ns - self.start_ns) / 1e9

    @property
    def self_ns(self):
        """The duration less the part the span's children cover."""
        return self.end_ns - self.start_ns - self.child_ns

    def __repr__(self):
        return 'Span(%r, request=%r, %s ns)' % (
            self.name, getattr(self, 'request', None),
            None if self.end_ns is None else self.dur_ns)


# ``with span(name):``
span = Span


def traced(name):
    """A decorator: each call of the function runs in a span of
    ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with Span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name, n=1):
    """Add ``n`` to counter ``name`` of the thread's open request (none
    where no span is open)."""
    st = _stacks.spans
    if st:
        c = st[-1]._root.counters
        c[name] = c.get(name, 0) + n


def records():
    """The closed spans in the ring, in the order they closed."""
    with _lock:
        return list(_ring)


def dropped():
    """Spans that fell out of the ring."""
    return _dropped[0]


def clear():
    """Empty the ring and the dropped count."""
    with _lock:
        _ring.clear()
        _dropped[0] = 0
