#!/usr/bin/env python3
"""Time the host-bound renders of one or more checkouts, each checkout
in its own process, on one CUDA card.

    python3 tools/torch_render_ab.py ROOT [ROOT ...]

Each ROOT is the root of a checkout that holds ``saugns_tpu_torch/``.
The checkouts run in the order given; for an A/B comparison of two
commits on one card, give parent, change, change, parent. Each run
prints one JSON line: its root, the card's name and power limit, and
for each script and dispatch mode the seconds of REPEATS warm renders
(``render_device`` on one generator, synchronised) after one first
render, and the device busy seconds of one more warm render (the union
of the device operations' intervals, torch.profiler). The modes are
"eager" (``graphs=False``, or a checkout without graphs) and, where
the checkout's TorchGenerator takes ``graphs``, "graphs". The scripts
are the 1024-voice PM bank, the renders of chip_smoke.py's phase 13
that launch kernel 10 (the ``pm_smoothchange`` pattern on the default
generator, and with every epoch on the sequential engine
``FLAGSHIP_SCRIPT`` and the 16-voice PM bank) and the 48-note sequence
of the golden file, at 96 kHz. Imports neither JAX nor the JAX package.
"""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPEATS = 5
SRATE = 96000


def busy_s(torch, fn):
    """Device busy seconds of one fn() call: the union of the device
    operations' intervals by torch.profiler; None if it saw none."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    iv = sorted((e.time_range.start, e.time_range.end)
                for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    if not iv:
        return None
    total = 0
    lo, hi = iv[0]
    for a, b in iv[1:]:
        if a > hi:
            total += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return (total + hi - lo) / 1e6


def one(root):
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('torch_render_ab: no CUDA device')
    sys.path.insert(0, root)
    import saugns_tpu_torch as stt
    from saugns_tpu_torch import kernels
    from saugns_tpu_torch.parallel.voicebank import make_bank_script
    from saugns_tpu_torch.render.engine import TorchGenerator
    kernels.build()
    dev = torch.device('cuda')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    repo = os.path.dirname(HERE)
    with open(os.path.join(repo, 'tests', 'golden',
                           'torch_slice2.json')) as f:
        golden = json.load(f)['entries']
    sys.path.insert(1, repo)
    from chip_smoke import FLAGSHIP_SCRIPT
    scripts = (('pm_bank_1024', golden['pm_bank_1024']['script'], True),
               ('pm_smoothchange', golden['pm_smoothchange']['script'],
                True),
               ('seq_flagship', FLAGSHIP_SCRIPT, False),
               ('seq_bank_16', make_bank_script(16, seed=0, duration=1.0),
                False),
               ('notes_seq', golden['notes_seq']['script'], True))
    import inspect
    modes = {'eager': {}}
    if 'graphs' in inspect.signature(TorchGenerator).parameters:
        modes = {'eager': {'graphs': False}, 'graphs': {'graphs': True}}
    out = {'root': root, 'card': card, 'seconds': {}, 'busy_s': {}}
    for name, script, flat in scripts:
        for mode, kw in modes.items():
            gen = TorchGenerator(stt.compile_script(script), SRATE, dev,
                                 flat=flat, **kw)
            gen.render_device()
            torch.cuda.synchronize()
            secs = []
            for _ in range(REPEATS):
                t = time.perf_counter()
                gen.render_device()
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t)
            key = '%s/%s' % (name, mode)
            out['seconds'][key] = secs
            out['busy_s'][key] = busy_s(torch, gen.render_device)
            del gen
    print(json.dumps(out), flush=True)


def main(argv):
    if len(argv) == 2 and argv[0] == '--one':
        one(os.path.abspath(argv[1]))
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for root in argv:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            '--one', os.path.abspath(root)], timeout=900)
        if r.returncode != 0:
            return r.returncode
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
