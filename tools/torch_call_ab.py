#!/usr/bin/env python3
"""Time calls of the library, ``saugns_tpu_torch.render(text)``, each in
a fresh process, for one or more checkouts on one CUDA card.

    python3 tools/torch_call_ab.py [--runs N] ROOT [ROOT ...]

Each ROOT is the root of a checkout that holds ``saugns_tpu_torch/``.
For each of N rounds (5 by default) and each script (``SCRIPTS``
below: a one-voice tone, three voices of three signatures, and a
multi-epoch program whose first two voices share a signature; 96 kHz),
every checkout runs one child process, in the order given; for an A/B
comparison of two commits give parent, change, change, parent. A
child imports the port, builds its kernel library, then makes two
calls of the script: ``first_s`` (the process's first call, which also
pays the port's one-time work on the device) and ``second_s``, each
from the call to its int16 array on the host, with the output's
sha256 and the call's ``render.slab_route`` count (0 for a call that
kept a TorchGenerator). The parent prints one JSON line a child, then
one of the medians and quartiles a checkout and script, with the
card's name and power limit. Imports neither JAX nor the JAX package.
"""
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

SCRIPTS = {
    'wsin': 'Wsin f440 t1',
    'hetero': ('Wsin f440 t0.3 a.4 p[Wsin r2 a.5]\n'
               'Nwh a0.2 t0.25\n'
               'Rlin f200 t0.2 a.3\n'),
    'multi': ("'a Wsin f440 t.6 a.3\n"
              "'b Wsin f220 t.6 a.2\n"
              "/.2 @a p.25 @b wsqr\n"
              "/.1 Nbv t.2 a.1\n"),
}


def child(root, name):
    """One fresh process's two calls of script ``name``."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import saugns_tpu_torch as stt
    from saugns_tpu_torch import kernels, tracing
    kernels.build()
    torch.cuda.synchronize()
    out = {'root': root, 'script': name}
    for k in ('first_s', 'second_s'):
        tracing.clear()
        t = time.perf_counter()
        arr = stt.render(SCRIPTS[name])
        out[k] = time.perf_counter() - t
        root_span, = [r for r in tracing.records()
                      if r.name == 'render.call']
        out[k[:-2] + '_route'] = root_span.counters.get(
            'render.slab_route', 0)
        out['sha256'] = hashlib.sha256(arr.tobytes()).hexdigest()[:16]
    print(json.dumps(out), flush=True)


def quartiles(xs):
    if len(xs) < 2:
        return [xs[0]] * 3
    return statistics.quantiles(xs, n=4)


def card():
    r = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                        '--format=csv,noheader'], capture_output=True,
                       text=True)
    return r.stdout.strip()


def main(argv):
    runs = 5
    if argv[:1] == ['--runs']:
        runs = int(argv[1])
        argv = argv[2:]
    if argv[:1] == ['--child']:
        child(argv[1], argv[2])
        return 0
    roots = argv or ['.']
    got = {}
    for _ in range(runs):
        for name in SCRIPTS:
            for root in roots:
                r = subprocess.run(
                    [sys.executable, os.path.abspath(__file__), '--child',
                     root, name], capture_output=True, text=True)
                if r.returncode != 0:
                    print(r.stderr[-4000:], file=sys.stderr)
                    return r.returncode
                line = r.stdout.strip().splitlines()[-1]
                print(line, flush=True)
                got.setdefault((root, name), []).append(json.loads(line))
    gpu = card()
    for (root, name), rows in got.items():
        summary = {'root': root, 'script': name, 'gpu': gpu,
                   'n': len(rows),
                   'sha256': sorted({x['sha256'] for x in rows}),
                   'route': sorted({x['first_route'] for x in rows})}
        for k in ('first_s', 'second_s'):
            summary[k] = quartiles([x[k] for x in rows])
        print(json.dumps(summary), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
