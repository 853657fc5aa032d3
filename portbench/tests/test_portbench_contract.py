"""BENCHMARK.json against the benchmark's contract, and the harness's
lookup of each cell's files by name."""
import json
import os
import re

import pytest

from conftest import BASE, ROOT
from harness import cells

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
PATH = re.compile(r'^[A-Za-z0-9_./-]{1,200}$')
KEYS = {'command', 'paths', 'run_seconds', 'configs', 'workloads',
        'end_to_end', 'per_layer'}
SOURCES = {'device_trace', 'program_span', 'program_counter',
           'host_clock'}


@pytest.fixture(scope='module')
def bench():
    return cells.benchmark(ROOT)


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and '\n' not in s \
        and '\t' not in s


def test_keys_and_command(bench):
    assert set(bench) == KEYS
    assert bench['command'] == ['python3', 'portbench/run.py']
    assert bench['paths'] == ['portbench']
    assert all(PATH.match(p) and '..' not in p for p in bench['paths'])
    assert isinstance(bench['run_seconds'], int)
    assert 1 <= bench['run_seconds'] <= 51
    assert os.path.getsize(os.path.join(ROOT, 'BENCHMARK.json')) <= 65536


def test_names_units_and_text(bench):
    names = [c['name'] for c in bench['configs']]
    names += [w['name'] for w in bench['workloads']]
    metrics = bench['end_to_end'] + bench['per_layer']
    names += [m['name'] for m in metrics]
    assert len(set(names)) == len(names)
    for n in names:
        assert NAME.match(n), n
    for w in bench['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert NAME.match(w['config']) and NAME.match(w['traffic'])
        assert w['chips'] in (1, 4) and line(w['why'])
    for c in bench['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert line(c['source']) and line(c['why'])
        assert all(NAME.match(k) for k in c['reduced'])
        assert c['file'].startswith('portbench/')
    for m in metrics:
        assert UNIT.match(m['unit']), m['unit']
        assert m['better'] in ('lower', 'higher')
        assert m['source'] in SOURCES
    for m in bench['per_layer']:
        assert line(m['layer'])


def test_metrics_wiring(bench):
    e2e = {m['name'] for m in bench['end_to_end']}
    cells_ = [w['name'] for w in bench['workloads']]
    assert 'setup_s' in e2e
    for m in bench['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    for m in bench['per_layer']:
        assert m['moves'] in e2e
        for c in m.get('workloads', []):
            assert c in cells_
            assert m['moves'] in [x['name'] for x in
                                  cells.metrics_of(bench, c, 'end_to_end')]
        assert os.path.exists(os.path.join(BASE, 'metrics',
                                           m['name'] + '.py'))
    for c in cells_:
        e = [m['name'] for m in cells.metrics_of(bench, c, 'end_to_end')]
        assert 'setup_s' in e and len(e) >= 2
        assert cells.metrics_of(bench, c, 'per_layer')


def test_each_cell_finds_its_files(bench):
    used = set()
    for w in bench['workloads']:
        conf = cells.config(w['config'])
        traf = cells.traffic(w['traffic'])
        assert cells.limits(w['config'])
        assert callable(cells.entry(traf['entry']))
        assert conf['name'] == w['config']
        used.add(w['config'])
    for c in bench['configs']:
        assert c['name'] in used
        with open(os.path.join(ROOT, c['file'])) as f:
            conf = json.load(f)
        assert conf['reduced'] == c['reduced'] == []
        assert conf['source'] and len(conf['source']) <= 200


def test_a_new_cell_is_found_without_an_edit(tmp_path, bench):
    """A configuration, a traffic mix and a per-layer metric added as
    new files, a cell and a metric as new entries: the harness finds
    them by name, and no file that was there changes."""
    from conftest import tiny_root
    root = tiny_root(str(tmp_path))
    base = os.path.join(root, 'portbench')
    before = {}
    for d, _s, fs in os.walk(base):
        for f in fs:
            p = os.path.join(d, f)
            with open(p, 'rb') as fh:
                before[p] = fh.read()
    conf = cells.config('pm_voices', base)
    conf.update(name='pm_voices_low')
    conf['params']['freq']['choice'] = [55, 110]
    with open(os.path.join(base, 'configs', 'pm_voices_low.json'),
              'w') as f:
        json.dump(conf, f)
    with open(os.path.join(base, 'limits', 'pm_voices_low.json'),
              'w') as f:
        json.dump(cells.limits('pm_voices', base), f)
    with open(os.path.join(base, 'traffic', 'bank64.slab.json'),
              'w') as f:
        json.dump(dict(cells.traffic('bank1024.slab', base), voices=64), f)
    with open(os.path.join(base, 'metrics', 'plan.voices.py'), 'w') as f:
        f.write('def read(ctx):\n    return ctx.traffic["voices"]\n')
    b = cells.benchmark(root)
    b['workloads'].append({'name': 'pm_voices_low.bank64.slab',
                           'config': 'pm_voices_low',
                           'traffic': 'bank64.slab', 'chips': 1,
                           'why': 'a test cell'})
    b['per_layer'].append({'name': 'plan.voices', 'unit': 'count',
                           'better': 'lower', 'source': 'program_counter',
                           'layer': 'planner and host bake',
                           'moves': 'setup_s',
                           'workloads': ['pm_voices_low.bank64.slab']})
    with open(os.path.join(root, 'BENCHMARK.json'), 'w') as f:
        json.dump(b, f)
    w = cells.cell(cells.benchmark(root), 'pm_voices_low.bank64.slab')
    assert cells.config(w['config'], base)['params']['freq'][
        'choice'] == [55, 110]
    assert cells.traffic(w['traffic'], base)['voices'] == 64
    per = [m['name'] for m in cells.metrics_of(cells.benchmark(root),
                                                w['name'], 'per_layer')]
    assert 'plan.voices' in per

    class C:
        traffic = {'voices': 64}
    assert cells.reader('plan.voices', base)(C) == 64
    for p, data in before.items():
        with open(p, 'rb') as fh:
            assert fh.read() == data, p
