"""The rules by which the readers of the port's own spans and counters
(``saugns_tpu_torch.tracing``, ``metrics/<name>.py``) split a traced
run's records:

- set-up: the spans that closed before the first request the profiler
  recorded;
- the window's plain requests: the requests that began after the last
  one the profiler recorded had ended, with no profiler recording;
- the profiled requests: those the profiler recorded, the window's
  first. Where each request is a new call of the library, a call's
  uploads, store lookup and fetches are read there: set-up's call also
  pays there what the process does only once, which the window's calls
  do not.

Each function returns None without the profiler's trace, where it finds
nothing to read, and with a port that records nothing (one without a
``tracing`` module)."""


def _tracing(ctx):
    if not ctx.trace:
        return None
    try:
        from saugns_tpu_torch import tracing
    except ImportError:
        return None
    return tracing


def setup_sum(ctx, name, scale):
    """The durations of set-up's ``name`` spans, summed, in ns over
    ``scale`` (1e6: ms). None also where spans fell out of the ring,
    since set-up is then not whole."""
    tracing = _tracing(ctx)
    if tracing is None:
        return None
    recs = tracing.records()
    first = min((r.start_ns for r in recs
                 if r.parent is None and r.profiled), default=None)
    if first is None or tracing.dropped():
        return None
    ns = [r.end_ns - r.start_ns for r in recs
          if r.name == name and r.end_ns <= first]
    return sum(ns) / scale if ns else None


def _plain(recs):
    """The roots of the window's plain requests, or None where no
    request was profiled."""
    roots = [r for r in recs if r.parent is None]
    last = max((r.end_ns for r in roots if r.profiled), default=None)
    if last is None:
        return None
    return [r for r in roots if not r.profiled and r.start_ns > last]


def plain_span_mean(ctx, name, scale):
    """The durations of the ``name`` spans of the window's plain
    requests, in ns over ``scale``, the mean per request."""
    tracing = _tracing(ctx)
    if tracing is None:
        return None
    recs = tracing.records()
    plain = _plain(recs)
    if not plain:
        return None
    ids = {r.request for r in plain}
    ns = [r.end_ns - r.start_ns for r in recs
          if r.name == name and r.request in ids]
    return sum(ns) / scale / len(ids) if ns else None


def profiled_mean(ctx, name, scale):
    """The durations of the ``name`` spans of the profiled requests, in
    ns over ``scale``, the mean per request."""
    tracing = _tracing(ctx)
    if tracing is None:
        return None
    recs = tracing.records()
    ids = {r.request for r in recs if r.parent is None and r.profiled}
    ns = [r.end_ns - r.start_ns for r in recs
          if r.name == name and r.request in ids]
    return sum(ns) / scale / len(ids) if ns else None


def plain_count_mean(ctx, name):
    """Counter ``name`` of the window's plain requests, the mean per
    request; None where none counted."""
    tracing = _tracing(ctx)
    if tracing is None:
        return None
    plain = _plain(tracing.records())
    n = [r.counters.get(name, 0) for r in plain or ()]
    return sum(n) / len(n) if any(n) else None
