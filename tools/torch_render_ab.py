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

    python3 tools/torch_render_ab.py --split [ROOT]

splits the cold first render of one checkout (this one by default): a
child process builds the kernel library, then one cold child process
a render (``SPLIT`` below) prints one JSON line of host seconds, each
stage synchronised: ``import_torch_s`` and ``import_s`` (``import
torch``, then ``import saugns_tpu_torch``), ``build_s``
(``kernels.build()`` with the library cached), ``compile_s``
(``compile_script``), ``generator_s`` (the constructor: RenderPlan and
HostSim, or the compiled-render store's key and load), ``bake_s`` (the
renderers and their host tables), ``upload_s`` (the rest of
``prepare()``: the uploads), ``body_s`` (the bodies' Python under
capture), ``instantiate_s`` (the rest of the captures:
``capture_end`` with ``cudaGraphInstantiate``), ``replay_s`` (the rest
of the first ``render_device()``: the first replay), ``first_s`` (the
constructor through the first render) and the output's sha256, with
the store's counts and the render's source where the checkout has the
store (``saugns_tpu_torch/render/aotstore.py``). ``--split-one ROOT
NAME`` is one such child.
"""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPEATS = 5
SRATE = 96000
# the renders that --split times: (name, golden entry, generator's flat=)
SPLIT = (('pm_bank_1024', 'pm_bank_1024', True),
         ('selfmod_bank_1024', 'selfmod_bank_1024', True),
         ('seq_flagship', 'seq_flagship', False),
         ('pm_smoothchange', 'pm_smoothchange', True))


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


def split_one(root, name):
    """One cold first render of ``name`` (a SPLIT entry), split into
    its host stages; prints one JSON line (see the module docstring)."""
    t = time.perf_counter()
    import torch
    t_torch = time.perf_counter() - t
    if not torch.cuda.is_available():
        raise SystemExit('torch_render_ab: no CUDA device')
    sys.path.insert(0, root)
    t = time.perf_counter()
    import saugns_tpu_torch as stt
    t_import = time.perf_counter() - t
    import hashlib
    from saugns_tpu_torch import kernels
    from saugns_tpu_torch.render.engine import TorchGenerator
    try:
        from saugns_tpu_torch.render import aotstore
    except ImportError:     # a checkout without the store
        aotstore = None
    dev = torch.device('cuda')
    entry, flat = {n: (e, f) for n, e, f in SPLIT}[name]
    with open(os.path.join(os.path.dirname(HERE), 'tests', 'golden',
                           'torch_slice2.json')) as f:
        ent = json.load(f)['entries'][entry]
    out = {'name': name, 'import_torch_s': t_torch, 'import_s': t_import}

    def timed(key, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        out[key] = time.perf_counter() - t
        return r

    timed('build_s', kernels.build)
    prg = timed('compile_s', lambda: stt.compile_script(ent['script']))
    t0 = time.perf_counter()
    gen = timed('generator_s',
                lambda: TorchGenerator(prg, SRATE, dev, flat=flat))
    timed('bake_s', lambda: [gen._renderers(ei)
                             for ei in range(len(gen.plan.epochs))])
    timed('upload_s', gen.prepare)
    pieces = timed('render_s', gen.render_device)
    out['first_s'] = time.perf_counter() - t0
    st = gen.graph_stats()
    out['body_s'] = st.get('body_s')
    out['instantiate_s'] = None if st.get('body_s') is None \
        else st['capture_s'] - st['body_s']
    out['replay_s'] = out.pop('render_s') - st['capture_s']
    out['captures'] = st['captures']
    out['nodes'] = st['nodes']
    out['source'] = st.get('source')
    out['store'] = dict(aotstore.STATS) if aotstore is not None else None
    got = gen.assemble(pieces)
    out['sha256'] = hashlib.sha256(got.astype('<i2').tobytes()).hexdigest()
    out['equal_hash'] = out['sha256'] == ent['sha256']
    print(json.dumps(out), flush=True)


def split_child(root, name, env=None, timeout=600):
    """One cold child process's split of the SPLIT render ``name`` (its
    JSON record); raises RuntimeError if the child fails."""
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        '--split-one', root, name], timeout=timeout,
                       env=env, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError('split of %s failed (exit %d): %s'
                           % (name, r.returncode, r.stderr[-2000:]))
    return json.loads(r.stdout.strip().splitlines()[-1])


def split(root, env=None, timeout=600):
    """The kernel library built in a child, then one cold child a SPLIT
    render; returns their JSON records (raises if a child fails)."""
    subprocess.run([sys.executable, os.path.abspath(__file__), '--build',
                    root], check=True, timeout=timeout, env=env)
    return [split_child(root, name, env, timeout) for name, _e, _f in SPLIT]


def main(argv):
    if len(argv) == 2 and argv[0] == '--one':
        one(os.path.abspath(argv[1]))
        return 0
    if len(argv) == 2 and argv[0] == '--build':
        sys.path.insert(0, os.path.abspath(argv[1]))
        from saugns_tpu_torch import kernels
        kernels.build()
        return 0
    if len(argv) == 3 and argv[0] == '--split-one':
        split_one(os.path.abspath(argv[1]), argv[2])
        return 0
    if argv and argv[0] == '--split':
        root = os.path.abspath(argv[1] if len(argv) > 1
                               else os.path.dirname(HERE))
        card = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60).stdout.strip()
        print(card, flush=True)
        for rec in split(root):
            rec['card'] = card
            print(json.dumps(rec), flush=True)
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
