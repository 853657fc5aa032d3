"""The control of the comparison that decides ``correct``: the
reference put in the program's place, its interpolation and
differentiation chain in float32 (the configurations state float64),
read by the same numbers against the float64 reference, on the programs
of the given seeds at the cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3

Prints one JSON line a seed and, last, the least reading of each number
over the seeds (the upper reading a limit has to stay under). It runs
on the host alone: the benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def readings(bench, cell_name, seeds, base=None, pool=None):
    """[{seed, numbers}] of the control on each seed's programs."""
    from harness import cells, check, scripts
    from reference import sau
    cell = cells.cell(bench, cell_name)
    kw = {} if base is None else {'base': base}
    conf = cells.config(cell['config'], **kw)
    traf = cells.traffic(cell['traffic'], **kw)
    out = []
    for seed in seeds:
        banks = [p['bank'] for p in scripts.write(conf, traf, seed)]
        ref = sau.render(banks, conf['srate'], chain=np.float64, pool=pool)
        ctl = sau.render(banks, conf['srate'], chain=np.float32, pool=pool)
        nums = check.worst(list(enumerate(ctl)), ref)
        out.append({'seed': seed, 'numbers': nums})
    return out


def main(argv):
    ap = argparse.ArgumentParser(prog='portbench/control.py')
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    args = ap.parse_args(argv)
    from harness import cells
    from harness.main import pool
    t = time.perf_counter()
    with pool() as p:
        res = readings(cells.benchmark(), args.workload, args.seeds,
                       pool=p)
        p.close()
        p.join()
    for r in res:
        print(json.dumps(r))
    least = {k: min(r['numbers'][k] for r in res)
             for k in res[0]['numbers']}
    print(json.dumps({'workload': args.workload, 'least': least,
                      'seconds': time.perf_counter() - t}))
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
