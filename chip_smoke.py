#!/usr/bin/env python3
"""Smoke run of saugns_tpu_torch on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``saugns_tpu_torch/csrc``, holds
each kernel against its plain PyTorch version on the card, renders the
port's main path (SAU script -> Program -> RenderPlan -> HostSim ->
flat segments -> int16) at 96 kHz through ``saugns_tpu_torch.render``
and its CLI, and checks every result. It imports neither JAX nor the
JAX package: the references are the port's plain path and the
committed golden file ``tests/golden/wav/wsin_96k.npz``.

Phases, each timed on its own line:
  1. the card's name and power limit; the kernel build;
  2. kernel 2 (wrapping u32 prefix sum) against its plain version;
  3. kernel 1 (oscillator fill) against its plain version;
  4. renders of the slice's scripts, kernel path against plain path,
     Wsin against the golden file, launch counts per script;
  5. the 1024-voice PM bank, kernel path against plain path;
  6. the CLI in a subprocess against the API;
then each kernel's time, its plain version's and the library call's,
at the largest size phases 4-5 gave it. Any failed check exits
non-zero. The line before the last holds the
per-kernel JSON record; the last line is the result JSON.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRATE = 96000
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)

FLAGSHIP_SCRIPT = (
    "Wsin t1 f500.r501[Wsin f1] p[Wsin f400.r800[Wsqr f1.r10[Wsin f50]]]"
    " a.8 c[Wsin f.5]"
)
# (script, launches kernel 2): the slice's scripts; kernel 2 runs where
# an oscillator frequency varies per sample (range modulation)
SCRIPTS = [
    ('Wsin', False),
    (FLAGSHIP_SCRIPT, True),
    ('Wsqr t.4 f80.r160[Wsin f2] a.7', True),
    ('Wsin f600 t.3 p[Wsin r1.5] ; f500 t.3', False),
    ('Wsin t.3 f200 c[Wsin f3 a.5]', False),
    ('Wsin t.4 f100 | Wtri t.3 f220', False),
]


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase(name, t0):
    print('phase %s: %.3f s' % (name, time.perf_counter() - t0),
          flush=True)


def time_ms(torch, fn, reps):
    """Mean milliseconds of fn() on the card, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bits_equal(torch, a, b):
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def main():
    if not os.path.isfile(os.path.join(ROOT, 'saugns_tpu_torch',
                                       '__init__.py')):
        print('chip_smoke: saugns_tpu_torch is not beside this script',
              file=sys.stderr)
        return 2
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import saugns_tpu_torch as stt
    from saugns_tpu_torch import kernels
    from saugns_tpu_torch.dsp import wavetables as W
    from saugns_tpu_torch.parallel.voicebank import make_bank_script
    from saugns_tpu_torch.render import tdsp
    from saugns_tpu_torch.render.engine import TorchGenerator
    from saugns_tpu_torch.render.plan import K_WPHASE, K_WRUN

    dev = torch.device('cuda')
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    t_all = time.perf_counter()

    # -- 1. card and build ------------------------------------------------
    t0 = time.perf_counter()
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, 'nvidia-smi failed: %s' % smi.stderr)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    tb = time.perf_counter()
    so = kernels.build()
    print('kernel build: %.3f s (%s)' % (time.perf_counter() - tb,
                                         os.path.basename(so)))
    print('wave tables: %s build' % W.table_source())
    phase('1 build', t0)

    rng = np.random.RandomState(1234)

    # -- 2. kernel 2 against its plain version ---------------------------
    t0 = time.perf_counter()
    M32 = 0xffffffff
    cases = [rng.randint(0, 1 << 32, size=n, dtype=np.int64)
             for n in (1, 1023, 96000, (1 << 22) + 3)]
    cases.append(np.full((1 << 22) + 3, M32, np.int64))
    err2 = 0
    for x_np in cases:
        x = torch.from_numpy(x_np).to(dev)
        got = kernels.scan_add_u32(x)
        ref = tdsp.prefix_sum_plain(x)
        torch.cuda.synchronize()
        check(bits_equal(torch, got, ref),
              'scan_add_u32 != plain at n=%d' % x.numel())
        err2 = max(err2, int((got - ref).abs().max()))
        host = np.cumsum(x_np) & M32
        check(np.array_equal(got.cpu().numpy(), host),
              'scan_add_u32 != numpy cumsum at n=%d' % x.numel())
    print('kernel 2 bit-equal to its plain version at n = %s'
          % [len(c) for c in cases])
    phase('2 scan_add_u32', t0)

    # -- 3. kernel 1 against its plain version ---------------------------
    t0 = time.perf_counter()
    SLEN = 1 << W.SLENBITS
    piluts = tdsp.wave_tables(dev)[1]

    def fill_case(V, L, wave):
        # phases advancing at audio rates, with runs of pd == 0 (one
        # longer than a 256-block look-back window), a pending reset
        # at a random row index and non-zero seeds
        inc = rng.randint(1 << 16, 1 << 26, size=(V, L)).astype(np.int64)
        for r in range(V):
            for _ in range(8):
                a = rng.randint(0, L)
                inc[r, a:a + rng.randint(1, 600)] = 0
            if L > 140000:
                a = rng.randint(0, L - 70000)
                inc[r, a:a + 70000] = 0
        inc[0, :3] = 0                    # row head holds the seed
        pp = rng.randint(0, 1 << 32, size=V).astype(np.int64)
        ph = (pp[:, None] + np.cumsum(inc, axis=1)) & M32
        fi = rng.randint(0, L, size=V).astype(np.int64)
        do_rst = np.ones(V, bool)
        do_rst[0] = False if V > 1 else True
        rph = (ph[np.arange(V), fi] - SLEN) & M32
        ps = rng.uniform(-1, 1, size=V).astype(np.float32)
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        return (piluts[wave], wave, t(ph), t(pp), t(ps), t(fi),
                t(do_rst), t(rph))

    err1 = 0.0
    for V, L, wave in ((1, 96000, W.N_sin), (4, 1 << 18, W.N_sqr),
                       (1, 1 << 20, W.N_tri)):
        args = fill_case(V, L, wave)
        got = kernels.wosc_fill(*args)
        ref = tdsp.wosc_s_filled_plain(*args)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), 'wosc_fill: non-finite')
        check(bits_equal(torch, got, ref),
              'wosc_fill != plain at V=%d L=%d: %d samples differ'
              % (V, L, int((got != ref).sum())))
        err1 = max(err1, float((got - ref).abs().max()))
    print('kernel 1 bit-equal to its plain version at 96000, 4 x 2^18 '
          'and 2^20 samples')
    phase('3 wosc_fill', t0)

    # -- 4. the slice's scripts at 96 kHz --------------------------------
    t0 = time.perf_counter()
    launches = {k: 0 for k in kernels.LAUNCHES}
    shapes = {'wosc_fill': set(), 'scan_add_u32': set()}

    def kernel_shapes(prg):
        """Record the sizes the kernels get on ``prg``'s main path;
        returns its length in frames."""
        g = TorchGenerator(prg, SRATE, dev)
        for ei in range(len(g.plan.epochs)):
            for seg in g._flat_epoch(ei):
                for si, s in enumerate(seg.ep.stages):
                    n = seg.nc * seg.B
                    if s.kind == K_WRUN:
                        shapes['wosc_fill'].add(n)
                    elif s.kind == K_WPHASE and si not in seg.scalar_freq:
                        shapes['scan_add_u32'].add(n)
        return g.plan.signal_end

    def render_both(src):
        kernels.reset_launches()
        got = stt.render(src, srate=SRATE, device=dev)
        torch.cuda.synchronize()
        n = dict(kernels.LAUNCHES)
        for k in launches:
            launches[k] += n[k]
        ref = stt.render(src, srate=SRATE, device=dev, plain=True)
        return got, ref, n

    for src, fm in SCRIPTS:
        expect = kernel_shapes(stt.compile_script(src))
        got, ref, n = render_both(src)
        check(got.shape == (expect, 2) and got.dtype == np.int16,
              '%r: output shape %s, expected (%d, 2)'
              % (src, got.shape, expect))
        check(np.any(got != 0), '%r: silent output' % src)
        check(np.array_equal(got, ref),
              '%r: kernel path != plain path (%d samples differ)'
              % (src, int((got != ref).sum())))
        check(n['wosc_fill'] > 0, '%r: kernel 1 not launched' % src)
        check((n['scan_add_u32'] > 0) == fm,
              '%r: kernel 2 launched %d times' % (src, n['scan_add_u32']))
        print('render %-40.40s %7d frames, byte-equal, launches %s'
              % (src, len(got), json.dumps(n, sort_keys=True)))
        if src == 'Wsin':
            # the golden file holds interleaved stereo frames
            gold = np.load(os.path.join(ROOT, 'tests', 'golden', 'wav',
                                        'wsin_96k.npz'))['data']
            check(got.size == gold.size, 'Wsin: golden length')
            ref64 = gold.astype(np.float64)
            err = got.reshape(-1).astype(np.float64) - ref64
            snr = 10 * np.log10((ref64 ** 2).sum()
                                / max((err ** 2).sum(), 1e-30))
            check(snr >= 90.0, 'Wsin: %.2f dB against the golden file'
                  % snr)
            print('Wsin against wsin_96k.npz: %.2f dB' % snr)
    phase('4 renders', t0)

    # -- 5. the 1024-voice PM bank -----------------------------------------
    t0 = time.perf_counter()
    n_voices, duration = 1024, 1.0
    src = make_bank_script(n_voices, seed=0, duration=duration)
    tc = time.perf_counter()
    prg = stt.compile_script(src)
    t_compile = time.perf_counter() - tc
    kernel_shapes(prg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    tr = time.perf_counter()
    gen = TorchGenerator(prg, SRATE, dev)
    t_plan = time.perf_counter() - tr
    pieces = gen.render_device()
    torch.cuda.synchronize()
    t_render = time.perf_counter() - tr
    got = gen.assemble(pieces)
    n = dict(kernels.LAUNCHES)
    for k in launches:
        launches[k] += n[k]
    peak = torch.cuda.max_memory_allocated()
    check(n['wosc_fill'] > 0, 'bank: kernel 1 not launched')
    # again on the same generator: plan, bake and table uploads done
    tw = time.perf_counter()
    gen.render_device()
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - tw
    refg = TorchGenerator(prg, SRATE, dev, plain=True)
    ref = refg.assemble(refg.render_device())
    check(got.shape == (int(round(duration * SRATE)), 2),
          'bank: output shape %s' % (got.shape,))
    check(np.any(got != 0), 'bank: silent output')
    check(np.array_equal(got, ref),
          'bank: kernel path != plain path (%d samples differ)'
          % int((got != ref).sum()))
    print('bank %d voices, %.1f s at %d Hz: compile %.3f s, plan+bake '
          '%.3f s, render (plan+bake+device) %.3f s, realtime factor '
          '%.3f, peak device memory %d bytes, launches %s; byte-equal '
          'to the plain path [%s]'
          % (n_voices, duration, SRATE, t_compile, t_plan, t_render,
             duration / t_render, peak, json.dumps(n, sort_keys=True),
             card))
    print('bank second render on the same generator: %.3f s, realtime '
          'factor %.3f' % (t_warm, duration / t_warm))
    phase('5 bank', t0)

    # -- 6. the CLI against the API -----------------------------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix='.smoke-', dir=ROOT) as tmp:
        a = os.path.join(tmp, 'cli.wav')
        b = os.path.join(tmp, 'api.wav')
        env = dict(os.environ)
        env['PYTHONPATH'] = ROOT + os.pathsep + env.get('PYTHONPATH', '')
        env.pop('SAUGNS_TPU_TORCH_DEVICE', None)
        r = subprocess.run(
            [sys.executable, '-m', 'saugns_tpu_torch.cli', '-d',
             '-r%d' % SRATE, '-m', '-o', a, '-e', 'Wsin'],
            cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=600)
        check(r.returncode == 0, 'CLI exited %d: %s'
              % (r.returncode, r.stderr))
        stt.write_wav(b, 'Wsin', srate=SRATE, device=dev)
        with open(a, 'rb') as fa, open(b, 'rb') as fb:
            check(fa.read() == fb.read(), 'CLI WAV != API WAV')
    print('CLI -d -r%d -m -o x.wav -e Wsin: byte-equal to the API' % SRATE)
    phase('6 cli', t0)

    # -- the kernels' record ---------------------------------------------
    t0 = time.perf_counter()
    n2 = max(shapes['scan_add_u32'])
    x = torch.from_numpy(rng.randint(0, 1 << 32, size=n2,
                                     dtype=np.int64)).to(dev)
    k2_ms = time_ms(torch, lambda: kernels.scan_add_u32(x), 50)
    k2_plain = time_ms(torch, lambda: tdsp.prefix_sum_plain(x), 10)
    k2_lib = time_ms(torch, lambda: torch.cumsum(x, 0) & M32, 50)
    n1 = max(shapes['wosc_fill'])
    args = fill_case(1, n1, W.N_sin)
    k1_ms = time_ms(torch, lambda: kernels.wosc_fill(*args), 50)
    k1_plain = time_ms(torch, lambda: tdsp.wosc_s_filled_plain(*args), 10)
    # bytes each function must move: inputs read once, outputs written
    # once (kernel 1: phases in, samples out, the 8 KB PILUT and the
    # per-row seeds of 4 + 4 + 8 + 1 + 4 bytes)
    k2_bytes = 8 * n2
    k1_bytes = 8 * n1 + 4 * W.LEN + 21
    kern = [
        {'name': 'wosc_fill', 'route': 'cuda',
         'source': 'saugns_tpu_torch/csrc/wosc_fill.cu',
         'replaces': 'saugns_tpu/render/jdsp.py:2247',
         'launches': launches['wosc_fill'], 'max_abs_err': err1,
         'ms': k1_ms, 'plain_ms': k1_plain,
         'bound_ms': 1e3 * k1_bytes / HBM_BYTES_PER_S, 'bound_by': 'bytes',
         'library_ms': None, 'n': n1},
        {'name': 'scan_add_u32', 'route': 'cuda',
         'source': 'saugns_tpu_torch/csrc/scan_add_u32.cu',
         'replaces': 'saugns_tpu/render/jdsp.py:2615',
         'launches': launches['scan_add_u32'], 'max_abs_err': err2,
         'ms': k2_ms, 'plain_ms': k2_plain,
         'bound_ms': 1e3 * k2_bytes / HBM_BYTES_PER_S, 'bound_by': 'bytes',
         'library_ms': k2_lib, 'n': n2},
    ]
    for k in kern:
        check(k['launches'] > 0, '%s: no launch on the main path'
              % k['name'])
        print('%s at n = %d: kernel %.4f ms, plain %.4f ms, library %s, '
              'bound %.6f ms, %d launches in phases 4-5'
              % (k['name'], k['n'], k['ms'], k['plain_ms'],
                 'none' if k['library_ms'] is None
                 else '%.4f ms' % k['library_ms'], k['bound_ms'],
                 k['launches']))
    # the same kernels at 2^22 elements, where bytes, not launches,
    # should set the time
    big = 1 << 22
    x = torch.from_numpy(rng.randint(0, 1 << 32, size=big,
                                     dtype=np.int64)).to(dev)
    args = fill_case(1, big, W.N_sin)
    print('at n = %d: scan_add_u32 %.4f ms (bound %.4f ms, torch.cumsum '
          '%.4f ms), wosc_fill %.4f ms (bound %.4f ms)'
          % (big, time_ms(torch, lambda: kernels.scan_add_u32(x), 20),
             1e3 * 8 * big / HBM_BYTES_PER_S,
             time_ms(torch, lambda: torch.cumsum(x, 0) & M32, 20),
             time_ms(torch, lambda: kernels.wosc_fill(*args), 20),
             1e3 * (8 * big + 4 * W.LEN + 21) / HBM_BYTES_PER_S))
    phase('timing', t0)
    print('total: %.3f s [%s]' % (time.perf_counter() - t_all, card))
    print(json.dumps({'kernels': kern}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind, 'count': count}}))
    return 0


if __name__ == '__main__':
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print('chip_smoke: FAILED: %s' % e, file=sys.stderr)
        sys.exit(1)
