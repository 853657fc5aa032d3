"""The control (the reference with its interpolation chain in float32,
in the program's place) fails the limits, at a size a test run holds;
on the chip it is read at the cells' own size with portbench/control.py
(PERF.md)."""
import pytest

from conftest import TINY_SECONDS
from harness import cells
import control


@pytest.mark.parametrize('config,traffic', [('pm_voices', 'bank1024.slab'),
                                           ('selfpm_voices',
                                            'bank1024.slab')])
def test_control_fails(tmp_path, config, traffic):
    import json
    import os
    from conftest import tiny_root
    root = tiny_root(str(tmp_path))
    base = os.path.join(root, 'portbench')
    traf = dict(cells.traffic(traffic, base), voices=64,
                duration_s=TINY_SECONDS)
    with open(os.path.join(base, 'traffic', 'c64.json'), 'w') as f:
        json.dump(traf, f)
    bench = cells.benchmark(root)
    bench['workloads'].append({'name': config + '.c64', 'config': config,
                               'traffic': 'c64', 'chips': 1, 'why': 't'})
    lim = cells.limits(config, base)
    res = control.readings(bench, config + '.c64', [1, 2, 3], base=base)
    for r in res:
        assert any(r['numbers'][k] > lim[k] for k in lim), r
