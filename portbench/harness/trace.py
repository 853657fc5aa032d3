"""The traced window: torch.profiler over a few requests of the
window, and what the per-layer readers take from it.

The busy seconds are the union of the device operations' intervals
(the arithmetic of ``tools/torch_render_ab.py``'s ``busy_s``), clipped
to the traced window, whose wall time comes from the same profile (a
host span around the traced requests): numerator and denominator from
one run.
"""
from __future__ import annotations

import contextlib
import heapq

WINDOW = 'portbench.window'


def merged(intervals):
    """The union of (start, end) intervals as sorted disjoint ones."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def union_seconds(intervals):
    """Seconds covered by the union of (start_us, end_us) intervals."""
    return sum(b - a for a, b in merged(intervals)) / 1e6


def innermost(spans, points):
    """The name of the innermost span of ``spans`` ((name, start, end),
    nested as one thread's calls are) over each of ``points``, or None:
    of the spans that hold a point, the one that started last. One sweep
    over the points in order, with a heap of the spans started so far
    by their start, latest on top; a span that ended before a point
    ends before every later one too, and leaves the heap."""
    order = sorted(range(len(points)), key=points.__getitem__)
    spans = sorted(spans, key=lambda s: s[1])
    out = [None] * len(points)
    heap = []
    i = 0
    for k in order:
        p = points[k]
        while i < len(spans) and spans[i][1] <= p:
            heapq.heappush(heap, (-spans[i][1], spans[i][2], spans[i][0]))
            i += 1
        while heap and heap[0][1] < p:
            heapq.heappop(heap)
        if heap:
            out[k] = heap[0][2]
    return out


class Session:
    """One profiler session around some requests of the window."""

    def __init__(self, torch, sync):
        self.torch = torch
        self.sync = sync
        self.prof = None
        self.win = None
        self.requests = 0
        self.labels = {WINDOW}

    def start(self):
        """Start the profiler (its own start-up, seconds, comes before
        the traced window's span)."""
        from torch.profiler import ProfilerActivity, profile
        self.sync()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.win = self.torch.profiler.record_function(WINDOW)
        self.win.__enter__()

    def label(self, name):
        """A host span of the request's steps, for the idle gaps."""
        if self.prof is None:
            return contextlib.nullcontext()
        self.labels.add(name)
        return self.torch.profiler.record_function(name)

    def stop(self):
        """Stop the profiler and sort its events (read straight from
        the profiler's results: a render that captures its graphs makes
        millions of host events, too many to build torch's event tree
        of)."""
        self.sync()
        self.win.__exit__(None, None, None)
        self.prof.stop()
        dev = self.torch.autograd.DeviceType.CUDA
        self.device_ops = []
        self.host_ops = []
        self.window = None
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            a = e.start_ns() / 1e3
            rng = (a, a + e.duration_ns() / 1e3)
            on_dev = e.device_type() == dev
            ua = getattr(e, 'is_user_annotation', None)
            if (ua is not None and ua()) or name in self.labels:
                # a host span's mark on the device's timeline is no
                # device operation
                if not on_dev:
                    if name == WINDOW:
                        self.window = rng
                    else:
                        self.host_ops.append((name,) + rng)
            elif on_dev:
                self.device_ops.append((name,) + rng)
            else:
                self.host_ops.append((name,) + rng)
        self.prof = None
        if self.window is None:
            # no span of the window: nothing to read
            self.device_ops = []
        return self

    def summary(self):
        """{'ops': [(name, start_us, end_us)] inside the window,
        'window_s', 'busy_s', 'requests'}."""
        lo, hi = self.window
        ops = [(n, max(a, lo), min(b, hi)) for n, a, b in self.device_ops
               if b > lo and a < hi]
        return {'ops': ops, 'window_s': (hi - lo) / 1e6,
                'busy_s': union_seconds([(a, b) for _n, a, b in ops]),
                'requests': self.requests}

    def breakdown(self, top=10, labelled=200, samples=20000):
        """The device operations that took most time, by name, and the
        idle seconds by what the host was doing: the ``labelled``
        longest gaps sampled at ``samples`` points in all, each point's
        share of the gap given to the innermost host span over it (the
        rest of the gaps summed as 'other gaps')."""
        s = self.summary()
        by_name = {}
        for n, a, b in s['ops']:
            by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e6
        device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        lo, hi = self.window
        busy = merged([(a, b) for _n, a, b in s['ops']])
        gaps = []
        pos = lo
        for a, b in busy:
            if a > pos:
                gaps.append((pos, a))
            pos = max(pos, b)
        if hi > pos:
            gaps.append((pos, hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        step = sum(b - a for a, b in gaps[:labelled]) / samples
        points, weights = [], []
        for a, b in gaps[:labelled]:
            n = max(1, int((b - a) / step)) if step > 0 else 1
            w = (b - a) / n
            points += [a + (j + 0.5) * w for j in range(n)]
            weights += [w] * n
        idle = {}
        for w, name in zip(weights, innermost(self.host_ops, points)):
            name = name or 'host outside any span'
            idle[name] = idle.get(name, 0.0) + w / 1e6
        rest = sum(b - a for a, b in gaps[labelled:]) / 1e6
        if rest:
            idle['other gaps'] = idle.get('other gaps', 0.0) + rest
        idle_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {'device_ops': [[n[:200], v] for n, v in device_ops],
                'idle_gaps': [[n[:200], v] for n, v in idle_gaps]}
