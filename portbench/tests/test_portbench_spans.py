"""The readers of the port's own spans and counters
(``saugns_tpu_torch.tracing``): their rules for set-up, for the
profiled requests and for the window's plain requests on a record list
made here, and a tiny traced run on the CPU stand-in read by each of
them."""
import json
import os
import sys
from types import SimpleNamespace

import pytest

from conftest import BASE, run_cell
from harness import cells

SETUP = ['plan.build_ms', 'plan.upload_ms', 'dispatch.capture_body_s',
         'plan.build_ms.cold', 'dispatch.capture_body_s.cold']
CALL = ['plan.upload_ms.cold', 'store.lookup_ms.cold',
        'render.fetch_ms.cold']
PLAIN = ['dispatch.replay_host_ms', 'dispatch.nodes_replayed']
NEW = SETUP + CALL + PLAIN
SPAN = {'plan.build_ms': 'plan.build', 'plan.upload_ms': 'plan.upload',
        'dispatch.capture_body_s': 'dispatch.capture.body',
        'plan.build_ms.cold': 'plan.build',
        'plan.upload_ms.cold': 'plan.upload',
        'dispatch.capture_body_s.cold': 'dispatch.capture.body',
        'store.lookup_ms.cold': 'store.lookup',
        'render.fetch_ms.cold': 'render.fetch'}
# a metric's scale: ns a unit
SCALE = {n: 1e9 if n.startswith('dispatch.capture_body_s') else 1e6
         for n in SPAN}


def read(name, ctx):
    return cells.reader(name, BASE)(ctx)


class Records:
    """A record list of the tracer's form: ``root`` and ``span`` add
    records, ``install`` puts them in the tracer's place."""

    def __init__(self):
        self.recs = []
        self.sid = 0

    def root(self, name, start, end, profiled, counters=None):
        self.sid += 1
        r = SimpleNamespace(name=name, sid=self.sid, parent=None,
                            request=self.sid, profiled=profiled,
                            start_ns=start, end_ns=end,
                            counters=dict(counters or {}))
        self.recs.append(r)
        return r

    def span(self, root, name, start, end):
        self.sid += 1
        self.recs.append(SimpleNamespace(
            name=name, sid=self.sid, parent=root.sid, request=root.request,
            profiled=root.profiled, start_ns=start, end_ns=end,
            counters=None))

    def install(self, monkeypatch, dropped=0):
        from saugns_tpu_torch import tracing
        monkeypatch.setattr(tracing, 'records', lambda: list(self.recs))
        monkeypatch.setattr(tracing, 'dropped', lambda: dropped)


TRACED = SimpleNamespace(trace={'ops': [('k', 0, 1)], 'requests': 1})


def _run():
    """Set-up's spans, two profiled requests, then two plain ones and a
    root that began while the last profiled one was open."""
    r = Records()
    # set-up: a root of its own, and spans inside a render
    s0 = r.root('plan.build', 0, 3_000_000, False)
    s1 = r.root('render.bank', 4_000_000, 10_000_000, False)
    for name in set(SPAN.values()):
        r.span(s1, name, 5_000_000, 7_000_000)
    # the window: two profiled requests, 1 ms and 3 ms in each span
    p0 = r.root('render.bank', 20_000_000, 30_000_000, True,
                {'dispatch.nodes_replayed': 100})
    r.span(p0, 'dispatch.replay', 21_000_000, 29_000_000)
    p1 = r.root('render.bank', 31_000_000, 40_000_000, True,
                {'dispatch.nodes_replayed': 100})
    for p, ns in ((p0, 1_000_000), (p1, 3_000_000)):
        for name in set(SPAN.values()):
            r.span(p, name, p.start_ns + 1, p.start_ns + 1 + ns)
    # overlaps the last profiled request: not a plain request
    o = r.root('render.bank', 39_000_000, 45_000_000, False,
               {'dispatch.nodes_replayed': 1000})
    r.span(o, 'dispatch.replay', 41_000_000, 44_000_000)
    for k, (a, ns) in enumerate(((50_000_000, 1_000_000),
                                 (60_000_000, 3_000_000))):
        q = r.root('render.bank', a, a + 5_000_000, False,
                   {'dispatch.nodes_replayed': 10 + 20 * k})
        r.span(q, 'dispatch.replay', a + 1, a + 1 + ns)
        r.span(q, 'plan.build', a + 1, a + 2)
    return r, s0, p1


def test_setup_is_what_closed_before_the_first_profiled_request(
        monkeypatch):
    r, _s0, _p1 = _run()
    r.install(monkeypatch)
    # plan.build: the set-up root (3 ms) and the one in the render (2 ms)
    for name in ('plan.build_ms', 'plan.build_ms.cold'):
        assert read(name, TRACED) == pytest.approx(5.0), name
    assert read('plan.upload_ms', TRACED) == pytest.approx(2.0)
    for name in ('dispatch.capture_body_s', 'dispatch.capture_body_s.cold'):
        assert read(name, TRACED) == pytest.approx(0.002), name


def test_a_call_is_read_in_the_profiled_requests(monkeypatch):
    """The readers of a call's uploads, lookup and fetches: a span's time
    a profiled request, not set-up's (2 ms) nor a plain request's."""
    r, _s0, _p1 = _run()
    r.install(monkeypatch)
    for name in CALL:
        assert read(name, TRACED) == pytest.approx(
            2_000_000 / SCALE[name]), name


def test_plain_requests_follow_the_last_profiled_one(monkeypatch):
    r, _s0, _p1 = _run()
    r.install(monkeypatch)
    assert read('dispatch.replay_host_ms', TRACED) == pytest.approx(2.0)
    assert read('dispatch.nodes_replayed', TRACED) == pytest.approx(20.0)


def test_what_the_readers_do_not_read(monkeypatch):
    r, _s0, _p1 = _run()
    # spans that fell out of the ring: set-up is not whole
    r.install(monkeypatch, dropped=1)
    for name in SETUP:
        assert read(name, TRACED) is None, name
    for name in CALL + ['dispatch.replay_host_ms']:
        assert read(name, TRACED) is not None, name
    # no profiled request: neither set-up nor a window
    r.install(monkeypatch)
    for x in r.recs:
        x.profiled = False
    for name in NEW:
        assert read(name, TRACED) is None, name
    # no plain request after the profiled ones; nothing counted
    r2 = Records()
    q = r2.root('render.bank', 0, 10, True, {'dispatch.nodes_replayed': 5})
    r2.span(q, 'dispatch.replay', 1, 2)
    r2.root('render.bank', 20, 30, False)
    r2.install(monkeypatch)
    for name in PLAIN:
        assert read(name, TRACED) is None, name
    # no trace of the window
    r.install(monkeypatch)
    for name in NEW:
        assert read(name, SimpleNamespace(trace=None)) is None, name


def test_a_port_without_spans_reads_nothing(monkeypatch):
    """The parent commit's port has no tracing module: None, no error."""
    import saugns_tpu_torch
    monkeypatch.setitem(sys.modules, 'saugns_tpu_torch.tracing', None)
    # an import of the module already made leaves it an attribute of
    # the package, where ``from saugns_tpu_torch import tracing`` finds it
    monkeypatch.delattr(saugns_tpu_torch, 'tracing', raising=False)
    for name in NEW:
        assert read(name, TRACED) is None, name


@pytest.mark.parametrize('cell', ['pm_voices.tiny.slab',
                                  'pm_voices.tiny.generator'])
def test_a_traced_run_reads_the_spans(tiny, capsys, monkeypatch, cell):
    """A tiny traced run on the CPU stand-in reports every new metric of
    its cell from the run's own spans (nodes: none on the CPU, where
    nothing is captured). The stand-in's profile sees no device
    operation, so its session is taken as the card's would be, and one
    request is profiled, so that plain requests follow within the
    window."""
    from harness import main as hmain
    from saugns_tpu_torch import tracing

    class Session(hmain.Session):
        def stop(self):
            super().stop()
            self.device_ops = self.device_ops or [('stand-in', 0.0, 0.0)]
            return self
    monkeypatch.setattr(hmain, 'Session', Session)
    path = os.path.join(tiny, 'portbench', 'traffic',
                        cells.cell(cells.benchmark(tiny), cell)['traffic']
                        + '.json')
    with open(path) as f:
        traf = json.load(f)
    with open(path, 'w') as f:
        json.dump(dict(traf, trace_requests=1), f)
    tracing.clear()
    rc, res = run_cell(tiny, cell, seconds=5.0, trace=1, capsys=capsys)
    tracing.clear()
    assert rc == 0 and res['correct'] is True
    mine = [m['name'] for m in cells.metrics_of(cells.benchmark(tiny), cell,
                                                 'per_layer')
            if m['name'] in NEW]
    assert len(mine) == 5
    got = {k: v['value'] for k, v in res['metrics'].items() if k in NEW}
    assert set(got) == set(mine) - {'dispatch.nodes_replayed'}
    assert all(isinstance(v, float) and v > 0 for v in got.values()), got
    if cell.endswith('slab'):
        assert got['plan.build_ms'] + got['plan.upload_ms'] \
            <= res['metrics']['plan.host_ms']['value']
    else:
        assert got['plan.build_ms.cold'] + got['plan.upload_ms.cold'] \
            <= res['metrics']['plan.host_ms.cold']['value']
