"""Find a cell's files by the names in BENCHMARK.json."""
from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def root():
    """The checkout: the directory that holds BENCHMARK.json and
    ``portbench/``."""
    return os.path.dirname(HERE)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(base=None):
    return load_json(os.path.join(base or root(), 'BENCHMARK.json'))


def cell(bench, name):
    for w in bench['workloads']:
        if w['name'] == name:
            return w
    raise KeyError('no workload %r in BENCHMARK.json' % name)


def config(name, base=HERE):
    return load_json(os.path.join(base, 'configs', name + '.json'))


def traffic(name, base=HERE):
    return load_json(os.path.join(base, 'traffic', name + '.json'))


def limits(name, base=HERE):
    return load_json(os.path.join(base, 'limits', name + '.json'))


def _module(path, prefix):
    name = prefix + re.sub(r'\W', '_', os.path.basename(path)[:-3])
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(name, base=HERE):
    """``entries/<name>.py``: its ``Entry`` class."""
    return _module(os.path.join(base, 'entries', name + '.py'),
                   'portbench_entry_').Entry


def reader(name, base=HERE):
    """``metrics/<name>.py``: its ``read(ctx)``."""
    return _module(os.path.join(base, 'metrics', name + '.py'),
                   'portbench_metric_').read


def metrics_of(bench, cell_name, kind):
    """The metrics of ``kind`` ('end_to_end' or 'per_layer') that the
    cell reports: those without a ``workloads`` list and those whose
    list names it."""
    return [m for m in bench[kind]
            if cell_name in m.get('workloads', [cell_name])]
