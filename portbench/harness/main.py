"""One run of one cell: set-up, the measured window, the comparison
with the reference, and the result line (see ``portbench/run.py``)."""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import multiprocessing
import os
import re
import subprocess
import sys
import time

from . import cells, check, scripts
from .trace import Session

BANNED = ('jax', 'jaxlib', 'flax', 'saugns_tpu')


class Spans:
    """Host spans of the benchmark's calls into the port's layers:
    name -> list of seconds."""

    def __init__(self):
        self.d = {}

    @contextlib.contextmanager
    def time(self, name):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.d.setdefault(name, []).append(time.perf_counter() - t)


class Ctx:
    """What a per-layer reader reads (metrics/<name>.py, ``read(ctx)``):
    ``trace`` (the traced window's summary: 'ops' [(name, start_us,
    end_us)], 'window_s', 'busy_s', 'requests'; None without one),
    ``spans`` (name -> [seconds]), ``stats`` (the ``graph_stats()`` of
    each program set-up prepared), ``config``, ``traffic``,
    ``samples_per_voice``, ``csrc_kernels`` (the names of the port's own
    ``__global__`` functions) and ``memory_reserved_peak`` (bytes)."""


def csrc_kernels():
    """The names of the ``__global__`` functions under the port's
    ``csrc/``."""
    import saugns_tpu_torch
    names = set()
    d = os.path.join(os.path.dirname(saugns_tpu_torch.__file__), 'csrc')
    pat = re.compile(r'__global__\s+void\s+(?:__launch_bounds__\s*'
                     r'\([^)]*\)\s*)?(\w+)\s*\(')
    for fn in sorted(os.listdir(d)):
        if fn.endswith(('.cu', '.cuh')):
            with open(os.path.join(d, fn)) as f:
                names.update(pat.findall(f.read()))
    return names


def gpu_query():
    """The card's name, power limit and clocks by nvidia-smi, or None."""
    try:
        r = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit,clocks.sm,'
             'clocks.max.sm,temperature.gpu', '--format=csv,noheader'],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if r.returncode != 0 or not r.stdout.strip():
        return None
    f = [x.strip() for x in r.stdout.strip().splitlines()[0].split(',')]
    keys = ('name', 'power_limit', 'clock_sm', 'clock_max_sm', 'temp')
    return dict(zip(keys, f))


def banned_modules():
    return sorted(m for m in sys.modules if m.split('.')[0] in BANNED)


def latencies(lat):
    """Min, median and max of the requests' times and the five slowest,
    in ms."""
    if not lat:
        return None
    s = sorted(1e3 * x for x in lat)
    return {'min': s[0], 'median': s[len(s) // 2], 'max': s[-1],
            'slowest': s[-5:][::-1]}


def p95(values):
    """Nearest-rank 95th percentile."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def info(**kw):
    print('portbench ' + json.dumps(kw, default=str), flush=True)


def parse(argv):
    ap = argparse.ArgumentParser(prog='portbench/run.py')
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


class Card:
    """The CUDA card a run measures (a test puts a stand-in on the CPU
    in its place)."""

    device = 'cuda:0'

    def __init__(self, torch):
        self.torch = torch

    def available(self, n):
        c = self.torch.cuda
        return c.is_available() and c.device_count() >= n

    def count(self):
        c = self.torch.cuda
        return c.device_count() if c.is_available() else 0

    def load_kernels(self):
        from saugns_tpu_torch import kernels
        kernels.build()

    def sync(self):
        self.torch.cuda.synchronize()

    def reset_peak(self):
        self.torch.cuda.reset_peak_memory_stats()

    def peak(self):
        return self.torch.cuda.max_memory_reserved()

    def empty(self):
        self.torch.cuda.empty_cache()

    def name(self):
        return self.torch.cuda.get_device_name(0)


def setup(card, conf, traf, progs, spans, label, base):
    """Compile, plan, bake and capture each program, and render each
    once: everything the window's requests need. An entry whose
    requests prepare their own program (``WARM_ONE``: the programs are
    of one shape) has the first program alone prepared and rendered;
    the others get no program made in set-up."""
    import saugns_tpu_torch as stt
    with spans.time('kernels.load'):
        card.load_kernels()
    Entry = cells.entry(traf['entry'], base)
    entries = []
    for k, p in enumerate(progs):
        if k and getattr(Entry, 'WARM_ONE', False):
            entries.append(Entry(None, conf['srate'], card.device, label,
                                 p['text']))
            continue
        with spans.time('frontend.compile'):
            prg = stt.compile_script(p['text'])
        with spans.time('plan.host'):
            entries.append(Entry(prg, conf['srate'], card.device, label,
                                 p['text']))
        with spans.time('warm.first_render'):
            getattr(entries[-1], 'warm', entries[-1].request)()
    card.sync()
    return entries


class Labels:
    """The host spans an entry marks its steps with: the traced
    session's while one runs, else nothing."""

    def __init__(self):
        self.sess = None

    def __call__(self, name):
        if self.sess is None:
            return contextlib.nullcontext()
        return self.sess.label(name)


def window(card, entries, seconds, trace, n_traced, labels):
    """The closed loop: one client renders the programs in turn until
    ``seconds`` have passed; a request started before then runs to its
    end. With ``trace``, the first ``n_traced`` requests are profiled
    (again with the next ones, up to three sessions, where a session
    saw no device operation; the first profiler starts before the
    window's clock). Returns (answers, latencies, failed, t0,
    t_end, traced session or None, the main thread's CPU seconds of
    each request)."""
    answers, lat, cpu = [], [], []
    failed = run_fail = 0
    sess = done = None
    tries = 0
    i = 0
    t0 = None
    while t0 is None or time.perf_counter() - t0 < seconds:
        if trace and done is None and sess is None and tries < 3:
            sess = Session(card.torch, card.sync)
            sess.start()
            labels.sess = sess
            tries += 1
        if t0 is None:
            # the window starts after the profiler's own start-up
            t0 = t_end = time.perf_counter()
        k = i % len(entries)
        c = time.thread_time()
        a = time.perf_counter()
        try:
            out = entries[k].request()
        except Exception as exc:  # a failed request counts, the run goes on
            print('request %d failed: %r' % (i, exc), file=sys.stderr)
            failed += 1
            run_fail += 1
            i += 1
            if run_fail >= 3:
                break
            continue
        t_end = time.perf_counter()
        run_fail = 0
        answers.append((k, out))
        lat.append(t_end - a)
        cpu.append(time.thread_time() - c)
        i += 1
        if sess is not None:
            sess.requests += 1
            if sess.requests >= n_traced:
                labels.sess = None
                sess.stop()
                if sess.device_ops:
                    done = sess
                sess = None
    if sess is not None:
        labels.sess = None
        sess.stop()
        if sess.device_ops:
            done = sess
    return answers, lat, failed, t0, t_end, done, cpu


def pool():
    """A pool of spawned processes for the reference's blocks of voices
    (one fewer than the host's cores, at most six)."""
    workers = max(1, min(6, (os.cpu_count() or 2) - 1))
    return multiprocessing.get_context('spawn').Pool(workers)


def references(banks, srate):
    """The reference's int16 render of each bank."""
    from reference import sau
    with pool() as p:
        out = sau.render(banks, srate, pool=p)
        p.close()
        p.join()
    return out


def main(argv, t_start, start_offset, root=None, card=None):
    """One run; returns the exit code. ``root``: the checkout (by
    default the one that holds this file); ``card``: a stand-in for the
    CUDA card (tests)."""
    args = parse(argv)
    root = root or cells.root()
    base = os.path.join(root, 'portbench')
    bench = cells.benchmark(root)
    cell = cells.cell(bench, args.workload)
    conf = cells.config(cell['config'], base)
    traf = cells.traffic(cell['traffic'], base)
    lim = cells.limits(cell['config'], base)
    if traf['loop'] != 'closed' or int(traf['clients']) != 1:
        raise ValueError('the harness drives a closed loop of one client')

    import torch
    card = card or Card(torch)
    if not card.available(int(cell['chips'])):
        print('portbench: needs %d CUDA device(s), found %d'
              % (cell['chips'], card.count()), file=sys.stderr)
        return 3
    if root not in sys.path:
        sys.path.insert(0, root)
    card.reset_peak()
    spans = Spans()
    labels = Labels()
    progs = scripts.write(conf, traf, args.seed)
    entries = setup(card, conf, traf, progs, spans, labels, base)
    stats = [st for st in (e.graph_stats() for e in entries)
             if st is not None]
    t_win = time.perf_counter()
    setup_s = t_win - t_start + start_offset
    kernels = sys.modules.get('saugns_tpu_torch.kernels')
    # the nvcc build of the port's kernels (its sources build in
    # parallel), which only a checkout's first run makes: the wall time
    # of the kernels' load, part of setup_s and reported apart
    build_s = (sum(spans.d.get('kernels.load', ()))
               if kernels and kernels.BUILD_SECONDS else 0.0)

    answers, lat, failed, t0, t_end, sess, cpu = window(
        card, entries, args.seconds, args.trace,
        int(traf['trace_requests']), labels)
    card.sync()
    mem_peak = card.peak()
    stats_after = [st for st in (e.graph_stats() for e in entries)
                   if st is not None]
    gpu = gpu_query()
    if build_s:
        print('portbench: this run built the kernels (nvcc, %.3f s, '
              'counted in setup_s)' % build_s, file=sys.stderr)
    info(cell=cell['name'], seed=args.seed, torch=torch.__version__,
         cuda=torch.version.cuda, gpu=gpu, requests=len(answers),
         failed=failed, window_s=t_end - t0, setup_s=setup_s,
         latency_ms=latencies(lat), thread_cpu_ms=latencies(cpu),
         spans=spans.d, graph_stats_setup=stats,
         graph_stats_after=stats_after,
         build_seconds=kernels and kernels.BUILD_SECONDS,
         launches=kernels and dict(kernels.LAUNCHES))
    del entries
    gc.collect()
    card.empty()

    tr = time.perf_counter()
    refs = references([p['bank'] for p in progs], conf['srate'])
    nums = check.worst(answers, refs)
    ok, checks = check.judge(nums, lim)
    correct = ok and failed == 0 and len(answers) > 0
    info(reference_s=time.perf_counter() - tr, numbers=nums)

    bad = banned_modules()
    if bad:
        print('portbench: modules of JAX or the JAX package loaded: %s'
              % ', '.join(bad), file=sys.stderr)
        return 4

    metrics = {}
    device = {'platform': 'gpu', 'kind': card.name(),
              'count': int(cell['chips']), 'memory_peak_bytes': mem_peak,
              'power_limit': gpu and gpu.get('power_limit')}
    result = {'correct': correct, 'attempted': len(answers) + failed,
              'failed': failed, 'setup_build_s': build_s}
    if not args.trace:
        units = {m['name']: m['unit']
                 for m in cells.metrics_of(bench, cell['name'],
                                           'end_to_end')}
        srate = conf['srate']
        rate = (sum(len(a) for _k, a in answers) / srate
                / (t_end - t0)) if answers else None
        # audio_rate.cold: the same rate, in the cells whose every
        # request is a new call of the library (its own bound)
        vals = {
            'audio_rate': rate,
            'audio_rate.cold': rate,
            'render_p95_ms': 1e3 * p95(lat) if lat else None,
            'setup_s': setup_s,
        }
        for name, unit in units.items():
            if vals.get(name) is not None:
                metrics[name] = {'value': vals[name], 'unit': unit}
    else:
        ctx = Ctx()
        ctx.trace = sess.summary() if sess is not None else None
        ctx.spans = spans.d
        ctx.stats = stats
        ctx.config = conf
        ctx.traffic = traf
        ctx.samples_per_voice = (int(round(float(traf['duration_s'])
                                           * 1000)) * conf['srate'] // 1000)
        ctx.csrc_kernels = csrc_kernels()
        ctx.memory_reserved_peak = mem_peak
        for m in cells.metrics_of(bench, cell['name'], 'per_layer'):
            v = cells.reader(m['name'], base)(ctx)
            if v is not None:
                metrics[m['name']] = {'value': v, 'unit': m['unit']}
        if ctx.trace is not None:
            device['busy_s'] = ctx.trace['busy_s']
            device['window_s'] = ctx.trace['window_s']
            result['breakdown'] = sess.breakdown()
    result['metrics'] = metrics
    result['device'] = device
    result['checks'] = checks
    for name, c in checks.items():
        print('check %s %r limit %r' % (name, float(c['value']),
                                         c['limit']), file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
