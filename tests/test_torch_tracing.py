"""The port's spans and counters (saugns_tpu_torch/tracing.py) on the
CPU: nesting, requests, threads, the ring, the profiler's flag and
clock, and the spans a render records at each layer's bound."""
import contextlib
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import saugns_tpu_torch as stt
from saugns_tpu_torch import tracing
from saugns_tpu_torch.parallel.voicebank import BankRender, make_bank_script
from saugns_tpu_torch.parallel.sharding import Mesh
from saugns_tpu_torch.parallel.timeshard import TimeShardRender
from saugns_tpu_torch.render import aotstore, engine
from saugns_tpu_torch.render.engine import TorchGenerator

SRATE = 8000
BANK = make_bank_script(4, seed=3, duration=0.3)
ONE = 'Wsin f330 t.3 p[Wsin r2 a.5]'


@pytest.fixture(autouse=True)
def fresh(tmp_path, monkeypatch):
    """An empty ring, and a store of the test's own, on."""
    monkeypatch.setenv('SAUGNS_TPU_CACHE', str(tmp_path / 'cache'))
    monkeypatch.setenv('SAUGNS_TPU_EXPORT', '1')
    monkeypatch.setattr(aotstore, '_pack_dir',
                        lambda platform: str(tmp_path / 'pack' / platform))
    tracing.clear()
    yield
    tracing.clear()


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r.name, []).append(r)
    return out


def test_nesting_parents_and_self_time():
    with tracing.span('a') as a:
        with tracing.span('b') as b:
            with tracing.span('c') as c:
                pass
        with tracing.span('d') as d:
            pass
    recs = tracing.records()
    assert [r.name for r in recs] == ['c', 'b', 'd', 'a']
    assert a.parent is None
    assert b.parent == a.sid and d.parent == a.sid and c.parent == b.sid
    assert {r.request for r in recs} == {a.request}
    assert a.self_ns == a.dur_ns - b.dur_ns - d.dur_ns
    assert b.self_ns == b.dur_ns - c.dur_ns
    assert c.self_ns == c.dur_ns >= 0
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns \
        <= d.start_ns <= d.end_ns <= a.end_ns
    assert a.counters == {} and b.counters is None
    with tracing.span('e') as e:
        pass
    assert e.parent is None and e.request != a.request


def test_counters_go_to_the_open_request():
    tracing.count('x', 2)
    with tracing.span('root') as root:
        tracing.count('x', 3)
        with tracing.span('child'):
            tracing.count('x')
            tracing.count('y', 5)
    tracing.count('x', 7)
    assert root.counters == {'x': 4, 'y': 5}
    assert [r.counters for r in tracing.records()] == [None, root.counters]


@pytest.mark.parametrize('script,render', [
    (BANK, 'render.mesh'), (ONE, 'render.generator')],
    ids=['slab_route', 'generator'])
def test_a_call_is_one_request(script, render):
    """render.call, the render inside it (the grouped slab path of the
    bank, the one-voice program's generator stream) and every span
    under them carry one request id; the render's span is render.call's
    child."""
    out = stt.render(script, srate=SRATE, device='cpu')
    assert out.shape[1] == 2
    recs = tracing.records()
    names = _by_name(recs)
    call, = names['render.call']
    gen, = names[render]
    assert call.parent is None and gen.parent == call.sid
    assert {r.request for r in recs} == {call.request}
    assert call.start_ns <= gen.start_ns <= gen.end_ns <= call.end_ns


def test_the_stream_span_is_off_the_stack_between_runs():
    """A generator's stream span lasts from its first run() to its last
    sample, but a span the caller opens between two run() calls is not
    its child."""
    g = TorchGenerator(stt.compile_script(BANK), SRATE, device='cpu')
    buf = np.zeros(2 * 256, np.int16)
    more, _n = g.run(buf, 256, True)
    assert more
    with tracing.span('between') as between:
        pass
    while more:
        more, _n = g.run(buf, 256, True)
    gen, = _by_name(tracing.records())['render.generator']
    assert between.parent is None and between.request != gen.request
    assert gen.start_ns < between.start_ns < between.end_ns < gen.end_ns
    assert gen.parent is None


def test_threads_keep_their_own_stacks():
    go = threading.Barrier(2)
    got = {}

    def work(k):
        with tracing.span('root%d' % k) as root:
            go.wait()
            with tracing.span('child%d' % k) as child:
                go.wait()
                tracing.count('n', k + 1)
        got[k] = (root, child)
    ts = [threading.Thread(target=work, args=(k,)) for k in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    (r0, c0), (r1, c1) = got[0], got[1]
    assert c0.parent == r0.sid and c1.parent == r1.sid
    assert r0.parent is None and r1.parent is None
    assert r0.request != r1.request
    assert (c0.request, c1.request) == (r0.request, r1.request)
    assert r0.counters == {'n': 1} and r1.counters == {'n': 2}


def test_the_ring_is_bounded_and_counts_what_it_drops():
    n = tracing.RING + 25
    for _ in range(n):
        with tracing.span('s'):
            pass
    recs = tracing.records()
    assert len(recs) == tracing.RING
    assert tracing.dropped() == 25
    assert recs[-1].sid - recs[0].sid == tracing.RING - 1
    tracing.clear()
    assert tracing.records() == [] and tracing.dropped() == 0


def test_profiled_flag():
    with tracing.span('before') as before:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span('root') as root:
            with tracing.span('child') as child:
                pass
    with tracing.span('after') as after:
        pass
    assert root.profiled and child.profiled
    assert not before.profiled and not after.profiled


def test_spans_hold_their_profiler_events():
    """Under a CPU profile each span opens a record_function of its name;
    its record, on the profiler's clock, holds that event."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span('probe.outer'):
            x = torch.ones(4096).cumsum(0)
            with tracing.span('probe.inner'):
                x = x * 2
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith('probe.'):
            events.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    spans = _by_name(tracing.records())
    for name in ('probe.outer', 'probe.inner'):
        (a, b), = events[name]
        s, = spans[name]
        assert s.start_ns <= a <= b <= s.end_ns, (name, s, a, b)
        # the clocks agree to far better than a span's length
        assert (a - s.start_ns) + (s.end_ns - b) < 5_000_000


def test_no_record_function_without_a_profiler(monkeypatch):
    """With no profiler recording, a span opens no record_function; with
    one, each span opens one."""
    calls = []
    real = torch.autograd.profiler.record_function

    def counting(name, *a, **k):
        calls.append(name)
        return real(name, *a, **k)
    monkeypatch.setattr(torch.autograd.profiler, 'record_function',
                        counting)
    bank = BankRender(stt.compile_script(BANK), SRATE, device='cpu')
    bank.prepare()
    bank.render_i16()
    bank.render_i16()
    assert tracing.records() and calls == []
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        bank.render_i16()
    assert sorted(calls) == sorted(r.name for r in tracing.records())
    assert 'render.bank' in calls


LAYERS = {'render.call', 'render.generator', 'render.mesh', 'render.bank',
          'lang.compile', 'store.lookup', 'plan.build', 'plan.upload',
          'dispatch.capture', 'dispatch.capture.body', 'dispatch.replay',
          'render.fetch'}
# the spans of a call at each layer's bound, whichever path renders it
CALL = {'render.call', 'lang.compile', 'store.lookup', 'plan.build',
        'plan.upload', 'dispatch.capture', 'dispatch.capture.body',
        'render.fetch'}


def test_a_render_records_every_layer():
    """A call of the library on a tiny bank (the store on; the grouped
    slab path) and on one voice (a TorchGenerator), and a tiny
    BankRender rendered twice, record a span at each layer's bound."""
    stt.render(BANK, srate=SRATE, device='cpu')
    call = {r.name for r in tracing.records()}
    assert CALL | {'render.mesh'} <= call
    tracing.clear()
    stt.render(ONE, srate=SRATE, device='cpu')
    one = {r.name for r in tracing.records()}
    assert CALL | {'render.generator'} <= one
    call |= one
    tracing.clear()
    bank = BankRender(stt.compile_script(BANK), SRATE, device='cpu')
    bank.prepare()
    for _ in range(2):
        bank.render_i16()
    recs = tracing.records()
    names = {r.name for r in recs}
    assert {'render.bank', 'lang.compile', 'plan.build', 'plan.upload',
            'dispatch.capture', 'dispatch.capture.body',
            'dispatch.replay'} <= names
    # (a process's first generator adds its one-time port.init)
    assert (call | names) - {'port.init'} == LAYERS
    by = _by_name(recs)
    # the two spans of prepare() do not nest in each other
    sids = {r.sid: r for r in recs}
    for r in by['plan.build'] + by['plan.upload']:
        p = sids.get(r.parent)
        assert p is None or not p.name.startswith('plan.')
    # the second render replays every graph the first captured
    first, second = by['render.bank']
    assert len([r for r in by['dispatch.replay']
                if r.request == second.request]) == len(
        [r for r in by['dispatch.capture']
         if r.request == first.request])


def test_the_store_lookup_spans_a_miss_and_a_load():
    g = TorchGenerator(stt.compile_script(BANK), SRATE, device='cpu')
    g.render_device()
    assert g.save_export()
    tracing.clear()
    g2 = TorchGenerator(stt.compile_script(BANK), SRATE, device='cpu')
    assert g2.source == 'disk'
    names = [r.name for r in tracing.records()]
    assert names.count('store.lookup') == 2 and 'plan.build' not in names


@pytest.mark.parametrize('entry', ['generator', 'bank'])
def test_graph_stats_are_the_spans(entry):
    """graph_stats()' capture_s and body_s are the sums of the
    dispatch.capture and dispatch.capture.body spans."""
    prg = stt.compile_script(BANK)
    if entry == 'generator':
        r = TorchGenerator(prg, SRATE, device='cpu')
        r.render_device()
        r.render_checksum()
    else:
        r = BankRender(prg, SRATE, device='cpu')
        r.render_i16()
        r.render()
    st = r.graph_stats()
    by = _by_name(tracing.records())
    assert st['captures'] == len(by['dispatch.capture']) > 0
    assert st['capture_s'] == pytest.approx(
        sum(s.seconds for s in by['dispatch.capture']), rel=1e-12)
    assert st['body_s'] == pytest.approx(
        sum(s.seconds for s in by['dispatch.capture.body']), rel=1e-12)
    assert 0 < st['body_s'] <= st['capture_s']


def test_replays_count_their_graphs_nodes(monkeypatch):
    """A captured graph's nodes, counted once at capture, are added to
    the request at each replay (dispatch.nodes_replayed)."""
    from saugns_tpu_torch.render import graphs

    class FakeGraph:
        def replay(self):
            pass

    @contextlib.contextmanager
    def fake_capture(_graph, **_kw):
        yield
    monkeypatch.setattr(torch.cuda, 'CUDAGraph', FakeGraph)
    monkeypatch.setattr(torch.cuda, 'graph', fake_capture)
    monkeypatch.setattr(graphs, '_capture_nodes', lambda: 7)
    bank = BankRender(stt.compile_script(BANK), SRATE, device='cpu')
    bank.prepare()[0].disp.capture = True
    for _ in range(3):
        bank.render_i16()
    st = bank.graph_stats()
    roots = [r for r in tracing.records() if r.name == 'render.bank']
    assert len(roots) == 3
    per = st['replays'] // 3 * 7
    assert [r.counters['dispatch.nodes_replayed'] for r in roots] == \
        [per] * 3
    assert st['nodes'] == 7 * st['captures']


def test_many_threads_lose_no_span_or_count():
    """More threads than cores, switching often: every span is kept or
    counted as dropped, each thread's spans nest in its own request, and
    no count is lost."""
    import os
    import sys
    threads, each = 2 * (os.cpu_count() or 4), 400
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for _ in range(each):
                with tracing.span('root%d' % k):
                    with tracing.span('child%d' % k):
                        tracing.count('n')
        ts = [threading.Thread(target=work, args=(k,))
              for k in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    recs = tracing.records()
    assert len(recs) + tracing.dropped() == 2 * threads * each
    sids = {r.sid: r for r in recs}
    for r in recs:
        if r.name.startswith('child'):
            p = sids[r.parent]
            assert p.name == 'root' + r.name[5:]
            assert p.request == r.request and p.counters == {'n': 1}
    roots = [r for r in recs if r.parent is None]
    assert sum(r.counters['n'] for r in roots) == len(roots) > 0


def test_warm_time_axis_renders_count_their_nodes(monkeypatch):
    """On the time axis a warm render replays its tape; it counts the
    pieces' graph nodes as the render that recorded the tape did."""
    from saugns_tpu_torch.render import graphs

    class FakeGraph:
        def capture_begin(self, *_a, **_k):
            pass

        def capture_end(self):
            pass

        def replay(self):
            pass

    @contextlib.contextmanager
    def fake_capture(_graph, **_kw):
        yield
    monkeypatch.setattr(torch.cuda, 'CUDAGraph', FakeGraph)
    monkeypatch.setattr(torch.cuda, 'graph', fake_capture)
    monkeypatch.setattr(torch.cuda, 'set_stream', lambda _s: None)
    monkeypatch.setattr(torch.cuda, 'graph_pool_handle', lambda: None)
    monkeypatch.setattr(graphs, '_capture_nodes', lambda: 3)
    ts = TimeShardRender(stt.compile_script('Wsin t.5 f200.r400[Wsin f3]'),
                         SRATE, Mesh(['cpu'] * 2, ('sp',)))
    ts.prepare()
    for d in ts.disps:
        d.capture = True
    for _ in range(3):
        ts.render_device()
    roots = [r for r in tracing.records() if r.name == 'render.timeshard']
    got = [r.counters.get('dispatch.nodes_replayed') for r in roots]
    assert len(got) == 3 and got[0] > 0 and got == [got[0]] * 3
    assert ts.graph_stats()['nodes'] == got[0]


def test_the_process_once_work_has_a_span_of_its_own(monkeypatch):
    """A process's first generator on a device does the one-time work
    (the wave tables' build, the store's hashes) in a port.init span
    before its store.lookup and plan spans, which hold none of it; a
    second generator does none."""
    monkeypatch.setattr(engine, '_INITIALISED', set())
    prg = stt.compile_script(BANK)
    TorchGenerator(prg, SRATE, device='cpu').prepare()
    recs = tracing.records()
    inits = [r for r in recs if r.name == 'port.init']
    assert len(inits) == 1 and inits[0].parent is None
    later = [r for r in recs if r.name in ('store.lookup', 'plan.build',
                                           'plan.upload')]
    assert later and all(r.start_ns >= inits[0].end_ns for r in later)
    tracing.clear()
    TorchGenerator(prg, SRATE, device='cpu').prepare()
    names = [r.name for r in tracing.records()]
    assert 'port.init' not in names and 'plan.upload' in names
