"""The benchmark's own tests (``python -m pytest portbench/tests``):
the harness, its packages and the port importable; a stand-in for the
card, so that a run's set-up, window and comparison can be driven on
the CPU at a tiny size. Nothing here imports JAX or the JAX package."""
import json
import os
import shutil
import sys

import pytest

BASE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BASE)
for p in (ROOT, BASE):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import cells  # noqa: E402
from harness import main as hmain  # noqa: E402

TINY_VOICES = 8
TINY_SECONDS = 0.05


class HostCard(hmain.Card):
    """The CPU in the card's place: no kernels to load, nothing to
    synchronise, no device memory."""

    device = 'cpu'

    def available(self, n):
        return True

    def count(self):
        return 0

    def load_kernels(self):
        pass

    def sync(self):
        pass

    def reset_peak(self):
        pass

    def peak(self):
        return 0

    def empty(self):
        pass

    def name(self):
        return 'cpu stand-in'


def tiny_root(dst):
    """A checkout in ``dst``: BENCHMARK.json and portbench/ copied, and
    for each configuration and each traffic mix of the cells a tiny
    cell (``<config>.tiny.<the traffic's last part>``: TINY_VOICES
    voices of TINY_SECONDS), also where the benchmark has no cell of
    that pair, added by new files and entries only; a metric listed for
    a cell is listed for the tiny cells of its traffic."""
    shutil.copytree(BASE, os.path.join(dst, 'portbench'),
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    bench = cells.benchmark(ROOT)
    of_mix = {}
    for w in list(bench['workloads']):
        if w['traffic'] in of_mix:
            continue
        traf = cells.traffic(w['traffic'])
        traf.update(voices=TINY_VOICES, duration_s=TINY_SECONDS)
        name = 'tiny.' + w['traffic'].rsplit('.', 1)[-1]
        with open(os.path.join(dst, 'portbench', 'traffic',
                               name + '.json'), 'w') as f:
            json.dump(traf, f)
        of_mix[w['traffic']] = []
        for c in bench['configs']:
            cell = dict(w, name='%s.%s' % (c['name'], name),
                        config=c['name'], traffic=name)
            bench['workloads'].append(cell)
            of_mix[w['traffic']].append(cell['name'])
    mix = {w['name']: w['traffic'] for w in bench['workloads']}
    for m in bench['end_to_end'] + bench['per_layer']:
        if 'workloads' in m:
            m['workloads'] += sorted({t for n in m['workloads']
                                      for t in of_mix[mix[n]]})
    with open(os.path.join(dst, 'BENCHMARK.json'), 'w') as f:
        json.dump(bench, f, indent=1)
    return dst


@pytest.fixture
def tiny(tmp_path):
    return tiny_root(str(tmp_path))


def run_cell(root, cell, seed=2 ** 31 + 77, seconds=1.0, trace=0,
             capsys=None):
    """One run of ``cell`` under ``root`` on the CPU stand-in; returns
    (exit code, result dict or None)."""
    import time
    import torch
    rc = hmain.main(['--workload', cell, '--seed', str(seed),
                     '--seconds', str(seconds), '--trace', str(trace)],
                    time.perf_counter(), 0.0, root=root,
                    card=HostCard(torch))
    res = None
    if capsys is not None:
        lines = capsys.readouterr().out.strip().splitlines()
        if lines and lines[-1].startswith('{'):
            res = json.loads(lines[-1])
    return rc, res
