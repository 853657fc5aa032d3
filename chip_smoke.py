#!/usr/bin/env python3
"""Smoke run of saugns_tpu_torch on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``saugns_tpu_torch/csrc``, holds
each kernel against its plain PyTorch version on the card, renders the
port's main path (SAU script -> Program -> RenderPlan -> HostSim ->
flat segments -> int16) at 96 kHz through ``saugns_tpu_torch.render``
and its CLI, and checks every result. It imports neither JAX nor the
JAX package: the references are the port's plain path, the committed
golden file ``tests/golden/wav/wsin_96k.npz`` and the committed hashes
of ``JaxGenerator``'s output in ``tests/golden/torch_slice2.json``.

Phases, each timed on its own line:
  1. the card's name and power limit; the kernel build (each source's
     nvcc seconds), and beside it the build of the latency probe
     (tools/chain_latency.cu), whose instruction latencies give the
     self-PM kernels' chain bound (tools/torch_chain_latency.py), and
     whose throughput probe checks the instruction rates of the bounds;
  2. kernel 2 (wrapping u32 prefix sum of int64, the single-pass
     look-back scan) against its plain version and numpy: the tile
     edges, 2^24 + 1, full int64 and negative inputs, an odd view,
     calls back to back and one on a side stream;
  3. kernel 1 (oscillator fill, one launch with a look-back hold)
     against its plain version: the tile edges, rows whose pd == 0 runs
     cross tile edges and a row boundary, an all-held row, resets at
     row index 0 and at a tile's first sample, int64 phases with high
     bits, an odd view, calls back to back and one on a side stream;
  4. renders of the wave slice's scripts, kernel path against plain
     path, Wsin against the golden file, launch counts per script;
  5. the 1024-voice PM bank, kernel path against plain path and
     against its reference hash;
  6. the CLI in a subprocess: with -o x.wav against the API (the
     stream, run()), and muted with no file (render_checksum); in
     process, both paths replay graphs;
  7. kernel 3 (wrapping u64 prefix sum, the single-pass look-back
     scan with a two-word status) against its plain version and
     numpy: the tile edges, 2^24 + 1, full int64 and all-ones inputs,
     an odd view, calls back to back and one on a side stream;
 7b. kernels 2, 3 and 4 over (V, L) rows in one launch (the voice
     banks' slabs) against their plain versions and the 1-D kernel row
     by row: ROW_SHAPES and the tile edges, wrapping and full-range
     inputs, a strided view and calls back to back; each row shape
     timed beside V one-row launches, the plain version and
     torch.cumsum / torch.cummax along the rows;
  8. kernel 5 (wave self-PM, 32 rows a block fed from shared memory)
     against its plain version, every wave, on SELFMOD_SHAPE (two chain
     warps, the second partly filled, over three staged tiles: the
     plain version steps through the samples in Python);
  9. kernel 6 (RasG self-PM, a row loop per function and line type)
     against its plain version, every function, line type and option
     flag, on SELFMOD_SHAPE;
 10. the noise, RasG and self-PM scripts on the kernel path against the
     reference hashes, and against the plain path (the self-PM ones
     cut shorter there, PLAIN_CUT), launch counts per script;
 11. the 16-voice self-PM bank on the kernel path against its
     reference hash, timed;
 12. kernels 7/8 (tap gather), 9 (float64 Is), 10 (forward fill) and
     4 (running max) against their plain versions, at the shapes the
     sequential engine and the flat fill give them and at 2^22; kernel
     8 also on int32 and int64 cells far outside the table, at n of 1-7
     and n not a multiple of 4, and on odd views; kernel 9 also on int64
     phases with high bits and on odd views; kernel 10 also with the
     sequential engine's per-row lengths at the tile edges, on rows of
     isolated invalid positions with NaN payloads and -0.0, and
     tdsp.forward_fill_valid on the card (one launch) against its
     plain version; kernel 4 also at the cases of phase 2 (negative
     inputs clamped to 0);
 13. the sequential-scan engine at 96 kHz: the pm_smoothchange pattern
     (an epoch HostSim cannot bake) on the default generator, and
     FLAGSHIP_SCRIPT, a 16-voice PM bank, a 16-voice self-PM bank and
     the golden file's slice-2 scripts with every epoch on the
     sequential engine, against the reference hashes and (where no
     self-PM plain version would take minutes) the plain path, timed;
 14. last, after the kernels' times below (so that its profiler
     sessions cannot touch their profile lines), the captured
     dispatch: the 1024-voice PM and self-PM banks, the
     10 s RasG self-PM script, the sequential renders of phase 13 and
     the 48-note sequence, each through CUDA graphs (the default) and op
     by op (graphs=False): byte-equal to each other and to the reference
     hash, the same launches; the first render (capture + instantiate +
     replay) and the warm one, the device busy share of a warm render
     (torch.profiler), peak and reserved memory, graph, capture, replay
     and node counts and where the prepared render came from (never
     exported: 'baked'); a warm render of the PM bank, the
     pm_smoothchange pattern and the sequential FLAGSHIP_SCRIPT under
     torch.cuda.set_sync_debug_mode('error') in both modes; and every
     kernel launched inside a graph over phases 4-14;
 15. the voice-sharded renderers (saugns_tpu_torch/parallel/) over a
     mesh of two shards on cuda:0 (and over cuda:0 + cuda:1 where there
     are two cards), each rendering voice slabs as one stage loop over
     voice rows: the 1024-voice PM and self-PM banks through BankRender
     on one device (the self-PM bank's kernel-5 launches = its slabs x
     self-PM stages x chunks) and with the ring mix against their
     reference hashes, the psum mix within one LSB of the ring's, and
     through MeshRender (the player's renderer on two or more devices),
     each with its slabs, first and warm times, graph counts, memory
     and launches beside phase 14's TorchGenerator render; the 16-voice
     self-PM bank and 13 voices on the ring against their hashes and
     TorchGenerator; the heterogeneous scripts (and one whose
     voices launch kernels 2 and 3) through MeshRender against their
     hashes, TorchGenerator (first and warm times beside MeshRender's)
     and the plain path; the multi-script queue (two worker threads,
     both capturing graphs) twice against the serial renders; a muted
     CLI run of a mesh program and a one-device program; and
     dryrun_multichip;
 16. the time axis (saugns_tpu_torch/parallel/timeshard.py,
     TimeShardRender) over two shards of cuda:0 (and cuda:0 + cuda:1
     where there are two cards): kernel 1 on a NaN hold seed against
     its plain version (the seed patch); the 1024-voice PM bank, the
     10 s RasG self-PM script, the 48-note sequence and the golden
     file's noise, RasG and self-PM scripts against their hashes and
     TorchGenerator on the card; 2 s versions (3 block rows) of the
     short scripts and the dry run's sequence at 96 kHz against
     TorchGenerator; each render with graphs (the default: a tape of
     captured pieces a segment key) and op by op (graphs=False, the PM
     bank once), the two byte-equal with the same exchanges, a warm
     render with graphs capturing nothing; the short scripts also on
     the plain path (the wave self-PM one cut to 0.02 s there); each
     render's first and warm seconds in both modes beside
     TorchGenerator's, its captures, replays and nodes, a warm render's
     host seconds answering exchanges beside replaying, its launches,
     exchanges and peak allocated memory; a warm render with graphs
     under torch.cuda.set_sync_debug_mode('error'); pm_smoothchange
     raises ValueError; and dryrun_multichip (check 4 included);
 17. the compiled-render store (saugns_tpu_torch/render/aotstore.py) in
     a temporary SAUGNS_TPU_CACHE, for the 1024-voice PM bank, the
     sequential FLAGSHIP_SCRIPT and the pm_smoothchange pattern: a cold
     child process's first render without an artifact, split into its
     host stages (tools/torch_render_ab.py --split-one), save_export()
     here, a cold child with the artifact (a disk hit), the exporting
     generator dropped and a second one here (a memory hit, no
     capture), a child with SAUGNS_TPU_EXPORT=0 (the directory
     unchanged), every output against its hash; the reserved bytes the
     memory tier holds once no generator does, for those renders and
     for the self-PM bank, the 10 s RasG script and the two 16-voice
     sequential banks;
then each kernel's time, its plain version's and the library call's
(for kernels 5 and 6 beside the latency bound of their loop-carried
chain: the probe's cycles per operation summed along the chain, at the
measured SM clock, times the active samples), and torch.profiler's
list of the device operations that one call of kernels 2, 4, 3, 8, 1,
9, 5, 6 and 10 (without and with lengths, and one
tdsp.forward_fill_valid call) at the main path's shapes issues, with
its host and device microseconds.
Any failed check exits non-zero. The line before the last holds the
per-kernel JSON record; the last line is the result JSON.
"""
import contextlib
import gc
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRATE = 96000
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
# Instruction rates per SM and clock on compute capability 9.0 (the CUDA
# C++ Programming Guide, "Arithmetic Instructions", throughput table):
# 64 float64 adds or multiplies, 128 float32 ones, 16 conversions to or
# from 64-bit types. The kernels are built with -fmad=false, so every
# DMUL, DADD, FMUL and FADD is one instruction (the data sheet's 33.5
# and 67 TFLOP/s count a fused multiply-add as two). The card's rate is
# these x its SMs x the SM clock the latency probe measures (phase 1).
FP64_OPS_PER_CLK_SM = 64
FP32_OPS_PER_CLK_SM = 128
CVT64_OPS_PER_CLK_SM = 16
GOLDEN = os.path.join(ROOT, 'tests', 'golden', 'torch_slice2.json')
# the kernel each of these golden entries must launch
KERNEL_OF = {'noise_re': 'scan_add_u32', 'rasg_fm': 'scan_add_u64',
             'wosc_selfpm': 'wosc_selfmod',
             'selfmod_bank_8': 'wosc_selfmod',
             'rasg_selfpm_short': 'rasg_selfmod'}
# operations per active sample of the self-PM kernels: kernel 5 does
# 18 float64 operations (15 in the Hermite, 3 in the sample; its ~10
# float32 ones are left out), kernel 6 about 40 float32 ones (its
# integer hashes are left out)
K5_F64_OPS = 18
K6_F32_OPS = 40
# per sample of kernels 1 and 9 (PILUT table), counted from `cuobjdump
# -sass` of their build (tools/torch_chain_latency.py --sass): float64
# adds and multiplies, and conversions to or from 64-bit types
K1_F64_OPS = 18
K1_CVT64_OPS = 10
K9_F64_OPS = 15
K9_CVT64_OPS = 8
# the loop-carried chains of kernels 5 and 6 whose latency bounds the
# kernels line gives (tools/torch_chain_latency.py CHAINS)
K5_CHAIN = 'k5'
K6_CHAIN = 'k6'

FLAGSHIP_SCRIPT = (
    "Wsin t1 f500.r501[Wsin f1] p[Wsin f400.r800[Wsqr f1.r10[Wsin f50]]]"
    " a.8 c[Wsin f.5]"
)
# phases 8 and 9: the self-PM kernels against their plain versions,
# which step through the samples in Python, on (rows, samples): two
# 32-row chain warps, the second partly filled, over three 128-sample
# staged tiles, the last partly filled
SELFMOD_SHAPE = (40, 300)
# and on (rows, samples) of earlier runs, for the sine (kernel 5) and
# the 10 s RasG script's mode (kernel 6): 4,096-sample chains over two
# full warps
SELFMOD_LONG = (64, 4096)
# phase 10: the golden entries whose plain path renders a shorter
# script (the kernel path renders the whole one against its hash);
# rasg_selfpm_short renders whole on both paths
PLAIN_CUT = {'wosc_selfpm': ('t.2', 't.02'),
             'selfmod_bank_8': ('t0.050', 't0.010')}
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


def device_ops(torch, fn, tries=3):
    """[(name, device us)] of the device operations that one fn() call
    issues, by torch.profiler (CPU and CUDA activities); None if the
    profiler saw no device activity in ``tries`` sessions (a session
    on a busy host can come back without its device events)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = [(e.name, e.time_range.end - e.time_range.start)
               for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if ops:
            return ops
    return None


def host_us(torch, fn, reps):
    """Mean host microseconds of one fn() call, enqueue only (no
    synchronise inside the loop)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t
    torch.cuda.synchronize()
    return 1e6 * t / reps


def bits_equal(torch, a, b):
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


# kernel 11 is held against its plain version and timed on the main
# path's shape, a 256-voice bank slab of the rasg_feedback voice at
# 96 kHz (256 voices x 2 rows of 65,536, the second 30,464 long: the
# clamped count of a ragged row), and on 256 full rows of 96,000; the
# uniform map and cos line, a per-row frequency of 50-200 Hz and a PM
# offset of +-12.5 cycles
RASG_FILL_SLAB = (256, 96000)
RASG_FILL_MAIN = (256, 2, 65536)


def rasg_fill_record(torch, np, kernels, tdsp, dev, launches, card,
                     flat_n):
    """Kernel 11 against its plain version (bit for bit) and its times
    at the slab shapes: the kernels line's entry, ``n`` the main path's
    shape (``flat_n``: the largest the smoke's scripts gave it on the
    flat path). Bound: 8 B a sample (the float32 PM offset in, the
    float32 sample out)."""
    rng = np.random.RandomState(11)
    coeff = float(np.float32(np.float32(4294967296.0) / np.float64(SRATE)))

    def case(rows, B, ln):
        n = int(np.prod(rows))
        f = 50.0 * 2.0 ** (rng.randint(0, 25, n) / 12.0)
        t = lambda a: torch.from_numpy(a).reshape(rows).to(dev)  # noqa
        kw = {'inc': t(np.rint(f * 2 * coeff).astype(np.int64)),
              'ln': t(np.resize(np.asarray(ln, np.int64), n)),
              'base': t(rng.randint(0, 1 << 62, n).astype(np.int64)),
              'pofs': torch.from_numpy(rng.uniform(
                  -12.5, 12.5, n * B).astype(np.float32)).reshape(
                      rows + (B,)).to(dev)}
        # the voice's R: at 2x rate, its flags the line's set bit
        return (0, 0, 27, 0x9e3779b9, 64), dict(
            B=B, pscale=float(np.float32(tdsp.P31 * 2)), **kw)

    def held(shape, mode, kw):
        got = kernels.rasg_fill(*mode, **kw)
        want = tdsp.rasg_fill_plain(*mode, **kw)
        torch.cuda.synchronize()
        check(bits_equal(torch, got, want), 'kernel 11 != plain on %s: '
              '%d differ' % (shape, int((got != want).sum())))
        return float((got - want).abs().max())

    rows, B = RASG_FILL_MAIN[:2], RASG_FILL_MAIN[2]
    mmode, mkw = case(rows, B, [B, RASG_FILL_SLAB[1] - B])
    err = held(RASG_FILL_MAIN, mmode, mkw)
    ms = time_ms(torch, lambda: kernels.rasg_fill(*mmode, **mkw), 50)
    plain_ms = time_ms(torch, lambda: tdsp.rasg_fill_plain(*mmode, **mkw),
                       3)
    mode, kw = case(RASG_FILL_SLAB[:1], RASG_FILL_SLAB[1], [96000])
    err = max(err, held(RASG_FILL_SLAB, mode, kw))
    slab_ms = time_ms(torch, lambda: kernels.rasg_fill(*mode, **kw), 50)
    slab_plain = time_ms(torch, lambda: tdsp.rasg_fill_plain(*mode, **kw),
                         3)
    n = int(np.prod(RASG_FILL_MAIN))
    n_slab = int(np.prod(RASG_FILL_SLAB))
    rec = {'name': 'rasg_fill', 'route': 'cuda',
           'source': 'saugns_tpu_torch/csrc/rasg_fill.cuh',
           'replaces': 'none (XLA fuses the K_RCYCLE and K_RRUN stages)',
           'launches': launches['rasg_fill'], 'max_abs_err': err,
           'ms': ms, 'plain_ms': plain_ms,
           'bound_ms': 1e3 * 8 * n / HBM_BYTES_PER_S, 'bound_by': 'bytes',
           'library_ms': None, 'n': n, 'shape': list(RASG_FILL_MAIN),
           'flat_n': flat_n, 'slab_shape': list(RASG_FILL_SLAB),
           'slab_ms': slab_ms, 'slab_plain_ms': slab_plain,
           'slab_bound_ms': 1e3 * 8 * n_slab / HBM_BYTES_PER_S}
    print('kernel 11 bit-equal to its plain version on %d x %d x %d '
          '(ragged rows) and %d x %d; %.4f ms (plain %.4f ms, bound %.4f '
          'ms) on the main path\'s shape, %.4f ms (plain %.4f ms, bound '
          '%.4f ms) on full rows; the flat path\'s largest %s [%s]'
          % (RASG_FILL_MAIN + RASG_FILL_SLAB
             + (ms, plain_ms, rec['bound_ms'], slab_ms, slab_plain,
                rec['slab_bound_ms'], flat_n, card)))
    return rec


# phase 7b: the (V, L) shapes kernels 2, 3 and 4 are held against their
# plain versions at (the voice banks' slabs: one voice's samples, a
# 256-voice slab of 1 s at 96 kHz, 256 voices of two block rows), and
# the tile edges
ROW_SHAPES = ((1, 96000), (4, 4097), (256, 96000), (256, 2))
ROW_EDGES = ((1, 1), (3, 4096), (5, 4097), (2, 3 * 4096 + 1), (7, 1))


def row_scans(torch, np, kernels, tdsp, dev, rng, card):
    """Kernels 2, 3 and 4 on (V, L) rows in one launch: each held bit
    for bit against its plain version (which scans each row alone) on
    wrapping inputs (every add wraps; for kernel 4, rows that fall, and
    values at 0 and 2^31 - 1) and full-range ones, and against the 1-D
    kernel row by row; then timed at ROW_SHAPES beside V one-row
    launches, the plain version and one PyTorch call
    (torch.cumsum / torch.cummax along the rows). Returns name -> the
    kernels line's records of the row shapes."""
    M32 = 0xffffffff
    tile = kernels.SCAN_TILE

    def case(name, shape, fill):
        if name == 'scan_max_i32':
            x = rng.randint(0, 1 << 31, size=shape, dtype=np.int64)
            if fill == 'wrap':
                x[..., ::3] = 0
                x[..., 1::5] = (1 << 31) - 1
                x[0] = np.arange(shape[1], 0, -1)
            return torch.from_numpy(x.astype(np.int32)).to(dev)
        if fill == 'wrap':
            x = np.full(shape, M32 if name == 'scan_add_u32' else -1,
                        np.int64)
        else:
            x = rng.randint(-(1 << 63), (1 << 63) - 1, size=shape,
                            dtype=np.int64)
        return torch.from_numpy(x).to(dev)

    kern = {'scan_add_u32': (kernels.scan_add_u32, tdsp.prefix_sum_plain,
                             lambda x: torch.cumsum(x, 1) & M32, 8),
            'scan_add_u64': (kernels.scan_add_u64,
                             tdsp.prefix_sum_u64_plain,
                             lambda x: torch.cumsum(x, 1), 16),
            'scan_max_i32': (kernels.scan_max_i32, tdsp.scan_max_i32_plain,
                             lambda x: torch.cummax(x, 1), 8)}
    recs = {}
    for name, (fn, plain, lib, nbytes) in kern.items():
        err = 0
        for shape in ROW_SHAPES + ROW_EDGES:
            for fill in ('wrap', 'random'):
                x = case(name, shape, fill)
                got = fn(x)
                ref = plain(x)
                torch.cuda.synchronize()
                check(bits_equal(torch, got, ref), '%s rows %s (%s) != '
                      'plain: %d differ' % (name, shape, fill,
                                            int((got != ref).sum())))
                err = max(err, int((got != ref).sum()))
                if shape[0] <= 8:
                    for r in range(shape[0]):
                        check(torch.equal(got[r], fn(x[r])),
                              '%s rows %s: row %d != the 1-D kernel'
                              % (name, shape, r))
        # odd rows (not 16-byte aligned) from a strided view, and row
        # calls back to back with no synchronise between them
        x = case(name, (3, 2 * tile + 3), 'random')[:, 1:]
        check(bits_equal(torch, fn(x), plain(x)),
              '%s rows: a strided view != plain' % name)
        xs = [case(name, sh, 'wrap') for sh in ((256, 96000), (4, 4097),
                                               (1, 1), (2, 3 * tile + 1))]
        torch.cuda.synchronize()
        outs = [fn(x) for x in xs]
        torch.cuda.synchronize()
        for x, got in zip(xs, outs):
            check(bits_equal(torch, got, plain(x)),
                  '%s rows %s back to back != plain'
                  % (name, tuple(x.shape)))
        recs[name] = []
        for V, L in ROW_SHAPES:
            x = case(name, (V, L), 'random')
            reps = 5 if V * L > 1 << 20 else 50
            rec = {'shape': [V, L], 'max_abs_err': err,
                   'ms': time_ms(torch, lambda: fn(x), reps),
                   'one_row_launches_ms': time_ms(
                       torch, lambda: [fn(r) for r in x], reps),
                   'plain_ms': time_ms(torch, lambda: plain(x), reps),
                   'library_ms': time_ms(torch, lambda: lib(x), reps),
                   'bound_ms': 1e3 * nbytes * V * L / HBM_BYTES_PER_S,
                   'bound_by': 'bytes'}
            recs[name].append(rec)
            print('%s rows (%d, %d): one launch %.4f ms, %d one-row '
                  'launches %.4f ms, plain %.4f ms, %s %.4f ms, bound '
                  '%.6f ms (bytes) [%s]'
                  % (name, V, L, rec['ms'], V, rec['one_row_launches_ms'],
                     rec['plain_ms'], 'torch.cummax(x, 1)'
                     if name == 'scan_max_i32' else 'torch.cumsum(x, 1)',
                     rec['library_ms'], rec['bound_ms'], card))
    print('kernels 2, 3 and 4 over rows bit-equal to their plain versions '
          'and to the 1-D kernel row by row at %s (wrapping and '
          'full-range), a strided view and 4 calls back to back'
          % (list(ROW_SHAPES + ROW_EDGES),))
    return recs


# phase 16: the golden file's renders through the time axis, and 2 s
# versions of its short scripts (3 block rows at 96 kHz); the plain path
# too for its short scripts and the 2 s ones without self-PM. A plain
# self-PM stage steps through its samples in Python (21-45 s for the
# 19,200 of wosc_selfpm on two shards), so the wave self-PM plain path
# runs on TIME_SELFPM_PLAIN, 1,920 samples
TIME_GOLDEN = ('pm_bank_1024', 'rasg_selfpm_10s', 'rasg_fm', 'noise_re',
               'noise_vi', 'noise_bv', 'wosc_selfpm', 'notes_seq')
TIME_PLAIN = ('rasg_fm', 'noise_re', 'noise_vi', 'noise_bv')
TIME_SELFPM_PLAIN = 'Wsin f110 t.02 p.a.3'
TIME_2S = ('Nre t2 a.4', 'Nvi t2 a.4', 'Nbv t2 a.4',
           'Rcos t2 f80.r160[Wsin f2] a.7', 'Wsin t2 f200.r400[Wsin f3]',
           'Wsin f100 t2 p.a.5', 'Wsin t2 f100 a.5 /.5 f0 /.3 f0 /.2 f100')
# the renders run once more under torch.cuda.set_sync_debug_mode('error')
TIME_SYNC = ('Wsin t2 f200.r400[Wsin f3]', 'Wsin f100 t2 p.a.5')
TIME_KERNELS = ('wosc_fill', 'scan_add_u32', 'scan_add_u64', 'scan_max_i32',
                'wosc_selfmod', 'rasg_selfmod')


def time_axis(torch, np, kernels, tdsp, stt, TorchGenerator, hashes, sha,
              card, dev, meshes, engine_out, dispatch, piluts):
    """Phase 16: the time axis over each of ``meshes`` ((name, devices));
    ``engine_out`` and ``dispatch``: phase 14's TorchGenerator renders
    and their records. Returns the phase's launches per kernel."""
    from saugns_tpu_torch.parallel.dryrun import SEQ, dryrun_multichip
    from saugns_tpu_torch.parallel.sharding import Mesh
    from saugns_tpu_torch.parallel.timeshard import TimeShardRender
    from saugns_tpu_torch.render.plan import K_RRUN_SELF, K_WRUN_SELF
    launches16 = {k: 0 for k in kernels.LAUNCHES}

    # kernel 1 on a NaN hold seed (each shard's provisional seed): NaN
    # exactly where the plain version holds it, the same bits elsewhere;
    # rows whose pd == 0 runs start at 0, cross tiles and cover a row
    rng = np.random.RandomState(16)
    L = 3 * kernels.FILL_TILE + 77
    steps = rng.randint(1, 1 << 24, (4, L)).astype(np.int64)
    steps[0, :kernels.FILL_TILE + 5] = 0
    steps[1, :] = 0
    steps[2, 100:2 * kernels.FILL_TILE] = 0
    ph = torch.from_numpy(np.cumsum(steps, 1) & tdsp.M32).to(dev)
    z = torch.zeros(4, dtype=torch.int64, device=dev)
    nan = torch.full((4,), float('nan'), dtype=torch.float32, device=dev)
    no = torch.zeros(4, dtype=torch.bool, device=dev)
    args = (piluts[0], 0, ph, ph[:, 0].clone(), nan, z, no, z)
    got = kernels.wosc_fill(*args)
    want = tdsp.wosc_s_filled_plain(*args)
    torch.cuda.synchronize()
    check(bits_equal(torch, got, want), 'kernel 1 on a NaN seed != its '
          'plain version')
    held = torch.isnan(got).sum(1).tolist()
    check(held[1] == L and held[0] >= kernels.FILL_TILE,
          'kernel 1 on a NaN seed: held samples %s' % held)
    print('time axis: kernel 1 on a NaN hold seed = its plain version '
          '(NaN samples a row %s of %d)' % (held, L))

    def engine_timed(src):
        g = TorchGenerator(stt.compile_script(src), SRATE, dev)
        g.prepare()
        torch.cuda.synchronize()
        tf = time.perf_counter()
        out = g.assemble(g.render_device())
        t_f = time.perf_counter() - tf
        tw = time.perf_counter()
        g.assemble(g.render_device())
        return out, t_f, time.perf_counter() - tw

    def ts_run(prg, mesh, plain=False, warm=1, graphs=True):
        """A TimeShardRender's first render (prepare included; with
        graphs the tapes' capture too) and the median of ``warm`` warm
        renders, in s, the first render's launches, exchanges, graph
        counts (the warm renders' exchange and replay host seconds) and
        peak allocated bytes above the run's start."""
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        a0 = torch.cuda.memory_allocated()
        kernels.reset_launches()
        tf = time.perf_counter()
        ts = TimeShardRender(prg, SRATE, mesh, plain=plain, graphs=graphs)
        out = ts.render_host()
        t_f = time.perf_counter() - tf
        n = dict(kernels.LAUNCHES)
        for k in n:
            launches16[k] += n[k]
        first = ts.graph_stats()
        ex = dict(ts.exchanges)
        t_w, st, spent = None, first, []
        for _ in range(warm):
            tw = time.perf_counter()
            again = ts.render_host()
            t_w = time.perf_counter() - tw
            st = ts.graph_stats()
            spent.append((t_w, st['exchange_s'], st['replay_s']))
            check(np.array_equal(again, out), 'time axis: a warm render '
                  'differs from the first')
            check(st['captures'] == first['captures'],
                  'time axis: a warm render captured')
            check(st['exchanges'] == ex, 'time axis: a warm render\'s '
                  'exchanges %s != the first\'s %s' % (st['exchanges'], ex))
        if spent:
            t_w, ex_s, rp_s = sorted(spent)[len(spent) // 2]
        else:
            ex_s = rp_s = None
        return ts, out, {'first_s': t_f, 'warm_s': t_w, 'launches': n,
                         'exchanges': ex,
                         'peak_bytes': torch.cuda.max_memory_allocated()
                         - a0,
                         'graphs': {k: st[k] for k in (
                             'tapes', 'graphs', 'captures', 'replays',
                             'nodes', 'capture_s', 'body_s')},
                         'warm_exchange_s': ex_s, 'warm_replay_s': rp_s}

    def serial_stages(ts):
        return sum(sum(s.kind in (K_WRUN_SELF, K_RRUN_SELF)
                       for s in fs.ep.stages) for _, fs in ts.segs)

    recs = {}
    for mname, devs in meshes:
        mesh = Mesh(devs, ('sp',))
        ns = len(devs)
        # (golden entry or None, script, the plain path too)
        renders = [(name, hashes['entries'][name]['script'],
                    name in TIME_PLAIN) for name in TIME_GOLDEN]
        renders += [(None, src, 'p.a' not in src) for src in TIME_2S]
        renders += [(None, SEQ, True), (None, TIME_SELFPM_PLAIN, True)]
        for name, src, with_plain in renders:
            prg = stt.compile_script(src)
            # with graphs (the default): the first render records each
            # segment key's tape, the warm ones replay it
            ts, got, rec = ts_run(prg, mesh, warm=3)
            what = name or src
            check(got.shape[0] > 0 and np.any(got != 0),
                  'time axis %s on %s: shape or silence' % (what, mname))
            if name is not None:
                check(sha(got) == hashes['entries'][name]['sha256'],
                      'time axis %s on %s: != reference hash'
                      % (what, mname))
            if name in engine_out:
                eng = engine_out[name]
                tg = dispatch[name]['graph']
                te_f, te_w = tg['first_s'], tg['warm_s']
            else:
                eng, te_f, te_w = engine_timed(src)
            check(np.array_equal(got, eng), 'time axis %s on %s: != '
                  'TorchGenerator' % (what, mname))
            # op by op (graphs=False); the PM bank (~9 s a render) once
            _, eout, erec = ts_run(prg, mesh, graphs=False,
                                   warm=0 if name == 'pm_bank_1024' else 1)
            check(np.array_equal(eout, got), 'time axis %s on %s: graphs '
                  '!= op by op' % (what, mname))
            check(erec['exchanges'] == rec['exchanges'],
                  'time axis %s: exchanges with graphs %s != op by op %s'
                  % (what, rec['exchanges'], erec['exchanges']))
            # only the self-PM recurrences are handed shard to shard:
            # one serial exchange a self-PM stage and segment
            ex = rec['exchanges']
            check(ex.get('serial', 0) == serial_stages(ts),
                  'time axis %s: serial exchanges %s' % (what, ex))
            # a segment key's pieces are captured once: a tape a key
            gs = rec['graphs']
            check(gs['tapes'] == len({fs.key for _, fs in ts.segs}),
                  'time axis %s: %d tapes' % (what, gs['tapes']))
            plain = ''
            if with_plain:
                tp = time.perf_counter()
                _, pout, _ = ts_run(prg, mesh, plain=True, warm=0)
                check(np.array_equal(pout, got), 'time axis %s on %s: != '
                      'the plain path' % (what, mname))
                plain = ' = the plain path (%.4f s)' % (
                    time.perf_counter() - tp)
            rows = sorted({(fs.nb, fs.nc) for _, fs in ts.segs})
            rec.update({'engine_first_s': te_f, 'engine_warm_s': te_w,
                        'segments': len(ts.segs), 'eager': erec})
            recs['%s, %s' % (what, mname)] = rec
            print('time axis %s, %s: %s= TorchGenerator = op by op%s; %d '
                  'segments, (rows, rows a shard) %s, %d shards; graphs: '
                  'first %.4f s (prepare and capture included), warm %.4f s '
                  '(exchanges %.4f s, replays %.4f s of host), tapes %d, '
                  'captures %d, replays %d, nodes %d, capture %.4f s; op by '
                  'op: first %.4f s, warm %s; TorchGenerator first %.4f s, '
                  'warm %.4f s; peak allocated %d bytes (op by op %d); '
                  'exchanges %s; launches %s [%s]'
                  % (what, mname, '= reference hash ' if name else '', plain,
                     len(ts.segs), rows[:4], ns, rec['first_s'],
                     rec['warm_s'], rec['warm_exchange_s'],
                     rec['warm_replay_s'], gs['tapes'], gs['captures'],
                     gs['replays'], gs['nodes'], gs['capture_s'],
                     erec['first_s'], 'not run' if erec['warm_s'] is None
                     else '%.4f s' % erec['warm_s'], te_f, te_w,
                     rec['peak_bytes'], erec['peak_bytes'],
                     json.dumps(ex, sort_keys=True),
                     json.dumps({k: v for k, v in rec['launches'].items()
                                 if v}, sort_keys=True), card), flush=True)
        # a warm render makes no host sync (one would raise here)
        for src in TIME_SYNC:
            ts = TimeShardRender(stt.compile_script(src), SRATE, mesh)
            ts.render_device()
            captures = ts.graph_stats()['captures']
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode('error')
            try:
                ts.render_device()
            finally:
                torch.cuda.set_sync_debug_mode('default')
            torch.cuda.synchronize()
            check(ts.graph_stats()['captures'] == captures > 0,
                  'time axis %s: a warm render captured' % src)
        print('time axis, %s: a warm render (graphs) of the K2 and the K5 '
              '2 s scripts makes no host sync and no capture' % mname)
        try:
            TimeShardRender(stt.compile_script(
                hashes['entries']['pm_smoothchange']['script']), SRATE, mesh)
            check(False, 'time axis: pm_smoothchange accepted')
        except ValueError as e:
            print('time axis pm_smoothchange, %s: ValueError (%s)'
                  % (mname, e))
        kernels.reset_launches()
        dryrun_multichip(devs)
        torch.cuda.synchronize()
        for k, v in kernels.LAUNCHES.items():
            launches16[k] += v
    print('phase 16 launches: %s' % json.dumps(launches16, sort_keys=True))
    for k in TIME_KERNELS:
        check(launches16[k] > 0, 'phase 16: %s not launched' % k)
    print('time axis ' + json.dumps({'card': card, 'renders': recs},
                                    sort_keys=True))
    return launches16


# phase 17: the renders the compiled-render store is timed on (names of
# tools/torch_render_ab.py's SPLIT), and (golden entry, flat=) of the
# renders whose device memory the memory tier is read holding: phase
# 14's largest in reserved bytes, and the self-PM bank
STORE_RENDERS = ('pm_bank_1024', 'seq_flagship', 'pm_smoothchange')
HELD_RENDERS = (('selfmod_bank_1024', True), ('rasg_selfpm_10s', True),
                ('seq_bank_16', False), ('seq_selfmod_bank_16', False))


def compiled_store(torch, kernels, stt, TorchGenerator, hashes, sha, card,
                   dev):
    """Phase 17, the compiled-render store (render/aotstore.py), in one
    temporary SAUGNS_TPU_CACHE: for each STORE_RENDERS render a cold
    child process without an artifact (tools/torch_render_ab.py's
    split), save_export() here, a cold child with the artifact (a disk
    hit), a second generator here (a memory hit, no capture), a child
    with SAUGNS_TPU_EXPORT=0 (the directory unchanged); every output
    against its hash. Then the reserved bytes the memory tier holds
    once no generator does: for those renders, and for HELD_RENDERS
    added one by one (each exported, rendered and dropped). Returns the
    launches of the renders here."""
    import torch_render_ab as tra
    from saugns_tpu_torch.render import aotstore
    launches17 = {k: 0 for k in kernels.LAUNCHES}
    recs = {}
    split = {n: (e, f) for n, e, f in tra.SPLIT}
    old = os.environ.get('SAUGNS_TPU_CACHE')
    with tempfile.TemporaryDirectory(prefix='.smoke-store-',
                                     dir=ROOT) as cache:
        os.environ['SAUGNS_TPU_CACHE'] = cache
        try:
            udir = aotstore._user_dir('cuda')

            def child(name, **env):
                try:
                    r = tra.split_child(ROOT, name, dict(os.environ, **env))
                except Exception as e:
                    raise SmokeFailure('store %s: %s' % (name, e))
                check(r['equal_hash'], 'store %s: child output != '
                      'reference hash (%s)' % (name, r['source']))
                return r

            def listing():
                return sorted(os.listdir(udir)) if os.path.isdir(udir) \
                    else []

            def reserved():
                """Reserved bytes once dropped generators are collected
                and the allocator's free blocks released."""
                gc.collect()
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                return torch.cuda.memory_reserved()

            aotstore.clear()
            aotstore.reset_stats()
            base = reserved()
            for name in STORE_RENDERS:
                entry, flat = split[name]
                ent = hashes['entries'][entry]
                rec = recs[name] = {}
                # 1. a cold child, no artifact
                r = rec['cold'] = child(name)
                check(r['source'] == 'baked' and r['store']['misses'] == 1,
                      'store %s: cold child %s %s'
                      % (name, r['source'], r['store']))
                # 2. the artifact, written here; this generator renders
                prg = stt.compile_script(ent['script'])
                t = time.perf_counter()
                g = TorchGenerator(prg, SRATE, dev, flat=flat)
                path = g.save_export()
                rec['export_s'] = time.perf_counter() - t
                check(path is not None and os.path.isfile(path),
                      'store %s: no artifact' % name)
                rec['artifact_bytes'] = os.path.getsize(path)
                kernels.reset_launches()
                t = time.perf_counter()
                got = g.assemble(g.render_device())
                torch.cuda.synchronize()
                rec['first_here_s'] = time.perf_counter() - t
                check(sha(got) == ent['sha256'],
                      'store %s: exporting generator != reference hash'
                      % name)
                # 3. a cold child with the artifact
                r = rec['disk'] = child(name)
                check(r['source'] == 'disk'
                      and r['store']['disk_hits'] == 1
                      and r['store']['corrupt'] == 0
                      and r['captures'] > 0,
                      'store %s: child with the artifact %s %s'
                      % (name, r['source'], r['store']))
                # 4. a second generator here takes the render that the
                # first one hands to the memory tier when it is dropped
                del g
                gc.collect()
                check(aotstore.live() == 1 + STORE_RENDERS.index(name),
                      'store %s: the dropped generator\'s render is not '
                      'in the memory tier' % name)
                hits = aotstore.STATS['mem_hits']
                torch.cuda.synchronize()
                t = time.perf_counter()
                g2 = TorchGenerator(prg, SRATE, dev, flat=flat)
                got = g2.assemble(g2.render_device())
                torch.cuda.synchronize()
                rec['second_s'] = time.perf_counter() - t
                st = rec['second_graphs'] = g2.graph_stats()
                check(sha(got) == ent['sha256'],
                      'store %s: live render != reference hash' % name)
                check(st['source'] == 'memory' and st['captures'] == 0
                      and st['replays'] > 0
                      and aotstore.STATS['mem_hits'] == hits + 1,
                      'store %s: second generator %s' % (name, st))
                for k, v in kernels.LAUNCHES.items():
                    launches17[k] += v
                # 5. the store off: nothing read or written
                before = listing()
                r = rec['off'] = child(name, SAUGNS_TPU_EXPORT='0')
                check(r['source'] == 'baked'
                      and not any(r['store'].values())
                      and listing() == before,
                      'store %s: SAUGNS_TPU_EXPORT=0 child %s %s'
                      % (name, r['source'], r['store']))
                del g2
                c, d = rec['cold'], rec['disk']
                print('store %s: = reference hash in every process; cold '
                      'child (constructor .. first replay) %.4f s without '
                      'the artifact, %.4f s with it (constructor %.4f -> '
                      '%.4f s, bake %.4f -> %.4f s, body %.4f / %.4f s, '
                      'instantiate %.4f / %.4f s); export here %.4f s, '
                      'artifact %d bytes; exporting generator\'s first '
                      'render %.4f s, second generator (memory) %.4f s, '
                      '%d captures, %d replays; store off: directory '
                      'unchanged [%s]'
                      % (name, c['first_s'], d['first_s'],
                         c['generator_s'], d['generator_s'], c['bake_s'],
                         d['bake_s'], c['body_s'], d['body_s'],
                         c['instantiate_s'], d['instantiate_s'],
                         rec['export_s'], rec['artifact_bytes'],
                         rec['first_here_s'], rec['second_s'],
                         st['captures'], st['replays'], card))
            # 6. the reserved bytes the memory tier holds once no
            # generator does: the three renders above, then
            # HELD_RENDERS added one by one
            r = reserved()
            check(aotstore.live() == len(STORE_RENDERS),
                  'store: %d renders in the memory tier, expected %d'
                  % (aotstore.live(), len(STORE_RENDERS)))
            held = {'store_renders': r - base}
            aotstore.clear()
            r = start = reserved()
            held['store_renders_freed'] = base + held['store_renders'] - r
            for name, flat in HELD_RENDERS:
                ent = hashes['entries'][name]
                kernels.reset_launches()
                g = TorchGenerator(stt.compile_script(ent['script']), SRATE,
                                   dev, flat=flat)
                check(g.save_export() is not None, 'store %s: no artifact'
                      % name)
                got = g.assemble(g.render_device())
                check(sha(got) == ent['sha256'],
                      'store %s: != reference hash' % name)
                for k, v in kernels.LAUNCHES.items():
                    launches17[k] += v
                del g
                r2 = reserved()
                held[name] = r2 - r
                r = r2
            held['all_held'] = r - start
            held['live'] = aotstore.live()
            aotstore.clear()
            held['freed'] = r - reserved()
            stats = dict(aotstore.STATS)
            print('store: the memory tier held, in reserved bytes once no '
                  'generator did: %d for the %d renders above (%d freed '
                  'by clear()); %s added one by one: %s, %d in all for %d '
                  'renders (%d freed by clear()); counts here %s (corrupt '
                  '%d) [%s]'
                  % (held['store_renders'], len(STORE_RENDERS),
                     held['store_renders_freed'],
                     ', '.join(n for n, _ in HELD_RENDERS),
                     ', '.join('%d' % held[n] for n, _ in HELD_RENDERS),
                     held['all_held'], held['live'], held['freed'],
                     json.dumps(stats, sort_keys=True), stats['corrupt'],
                     card))
            check(stats['corrupt'] == 0, 'store: corrupt artifacts')
        finally:
            if old is None:
                os.environ.pop('SAUGNS_TPU_CACHE', None)
            else:
                os.environ['SAUGNS_TPU_CACHE'] = old
    print('phase 17 launches: %s' % json.dumps(launches17, sort_keys=True))
    print('store ' + json.dumps({'card': card, 'renders': recs,
                                 'held_reserved_bytes': held,
                                 'stats': stats}, sort_keys=True))
    return launches17


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
    sys.path.insert(0, os.path.join(ROOT, 'tools'))
    import torch_chain_latency as tcl
    import saugns_tpu_torch as stt
    from saugns_tpu_torch import kernels
    from saugns_tpu_torch.dsp import wavetables as W
    from saugns_tpu_torch.lang import program as P
    from saugns_tpu_torch.parallel.voicebank import (
        make_bank_script, make_selfmod_bank_script)
    from saugns_tpu_torch.render import graphs as tgraphs
    from saugns_tpu_torch.render import tdsp
    from saugns_tpu_torch.render.engine import (TorchGenerator,
                                                _analyze_schedule,
                                                device_checksum)
    from saugns_tpu_torch.render.plan import (K_NOISE, K_RCYCLE,
                                              K_RRUN_SELF, K_WPHASE,
                                              K_WRUN, K_WRUN_SELF)

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
    wait_probe = tcl.start_build()
    so = kernels.build()
    t_build = time.perf_counter() - tb
    probe_so = wait_probe()
    slow = sorted(kernels.BUILD_SECONDS.items(), key=lambda kv: -kv[1])
    print('kernel build: %.3f s (%s); nvcc seconds of the slowest '
          'sources: %s; latency probe built by %.3f s'
          % (t_build, os.path.basename(so),
             ', '.join('%s %.3f' % kv for kv in slow[:4]) or 'cached',
             time.perf_counter() - tb))
    lat = tcl.measure(probe_so)
    chains = tcl.bounds(lat)
    print('latency probe: SM clock %.4f GHz; cycles per operation %s; '
          'chain bounds %s [%s]'
          % (lat['ghz'], json.dumps({k: round(v, 3) for k, v
                                     in lat['cycles'].items()}),
             json.dumps(chains), card))
    # the card's instruction rates at the probe's SM clock
    hz = 1e9 * lat['ghz']
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fp64_rate = FP64_OPS_PER_CLK_SM * sms * hz
    fp32_rate = FP32_OPS_PER_CLK_SM * sms * hz
    cvt64_rate = CVT64_OPS_PER_CLK_SM * sms * hz
    print('instruction rates at %d SMs and %.4f GHz: float64 add/mul '
          '%.4g/s, float32 %.4g/s, 64-bit conversions %.4g/s'
          % (sms, lat['ghz'], fp64_rate, fp32_rate, cvt64_rate))
    tput = tcl.per_clock_sm(tcl.throughput(probe_so), lat['ghz'])
    print('throughput probe, operations per clock and SM: %s (the table\'s '
          'rates: DMUL %d, conversions to or from 64-bit types %d) [%s]'
          % (json.dumps({k: round(v, 3) for k, v in tput.items()}),
             FP64_OPS_PER_CLK_SM, CVT64_OPS_PER_CLK_SM, card))
    print('wave tables: %s build' % W.table_source())
    # the reference hashes hold only for the tables they were made with
    with open(GOLDEN) as f:
        hashes = json.load(f)
    check(hashes['srate'] == SRATE, 'golden file: sample rate')
    piluts = tdsp.wave_tables(dev)[1]
    pil_sha = hashlib.sha256(
        piluts.cpu().numpy().astype('<f4').tobytes()).hexdigest()
    check(pil_sha == hashes['pilut_sha256'],
          'wave tables differ from those of the reference hashes '
          '(%s build)' % W.table_source())
    phase('1 build', t0)

    def sha(a):
        return hashlib.sha256(a.astype('<i2').tobytes()).hexdigest()

    rng = np.random.RandomState(1234)

    # -- 2. kernel 2 against its plain version ---------------------------
    t0 = time.perf_counter()
    M32 = 0xffffffff
    TILE = kernels.SCAN_TILE

    def full64(n):
        """int64 values over the whole range: high 32 bits set, and
        negative values (only the low 32 bits count)."""
        return rng.randint(-(1 << 63), (1 << 63) - 1, size=n,
                           dtype=np.int64)

    err2 = 0

    def check_k2(x, x_np, got, what):
        """``got`` = kernel 2 of ``x`` against its plain version and
        numpy's cumsum of the low 32 bits (after a synchronise)."""
        nonlocal err2
        ref = tdsp.prefix_sum_plain(x)
        check(bits_equal(torch, got, ref),
              'scan_add_u32 != plain at n=%d (%s)' % (x.numel(), what))
        err2 = max(err2, int((got - ref).abs().max()))
        host = np.cumsum(x_np & M32) & M32
        check(np.array_equal(got.cpu().numpy(), host),
              'scan_add_u32 != numpy cumsum at n=%d (%s)'
              % (x.numel(), what))

    # tile edges, many more tiles than the card holds at once (2^24 + 1:
    # 4,097 tiles), u32 values, all ones, full int64 and negative values
    sizes2 = (1, 1023, TILE - 1, TILE, TILE + 1, 3 * TILE + 1, 96000,
              (1 << 22) + 3, (1 << 24) + 1)
    cases = [('u32', rng.randint(0, 1 << 32, size=n, dtype=np.int64))
             for n in sizes2]
    cases.append(('ones', np.full((1 << 22) + 3, M32, np.int64)))
    cases += [('int64', full64(n)) for n in (TILE - 1, TILE, TILE + 1,
                                              3 * TILE + 1, (1 << 24) + 1)]
    cases.append(('negative', -rng.randint(1, 1 << 40, size=3 * TILE + 1,
                                            dtype=np.int64)))
    for what, x_np in cases:
        x = torch.from_numpy(x_np).to(dev)
        got = kernels.scan_add_u32(x)
        torch.cuda.synchronize()
        check_k2(x, x_np, got, what)
    # a view that starts at an odd element (not 16-byte aligned)
    x_np = full64(3 * TILE + 2)
    x = torch.from_numpy(x_np).to(dev)[1:]
    check(x.data_ptr() % 16 != 0, 'phase 2: the view is aligned')
    got = kernels.scan_add_u32(x)
    torch.cuda.synchronize()
    check_k2(x, x_np[1:], got, 'odd view')
    # back to back, large and small in turn, with no synchronise
    # between calls: no call may see another's status words
    seq = [full64(n) for n in ((1 << 22) + 3, 5, 3 * TILE + 1, TILE,
                               (1 << 20) + 7, 1, 2 * TILE + 1)]
    xs = [torch.from_numpy(a).to(dev) for a in seq]
    torch.cuda.synchronize()
    outs = [kernels.scan_add_u32(x) for x in xs]
    torch.cuda.synchronize()
    for x_np, x, got in zip(seq, xs, outs):
        check_k2(x, x_np, got, 'back to back')
    # one call on a side stream
    x_np = full64(3 * TILE + 1)
    x = torch.from_numpy(x_np).to(dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = kernels.scan_add_u32(x)
    torch.cuda.synchronize()
    check_k2(x, x_np, got, 'side stream')
    print('kernel 2 bit-equal to its plain version and numpy at n = %s '
          '(u32, all-ones, full int64, negative), an odd view, %d calls '
          'back to back and one on a side stream'
          % (sorted({len(c[1]) for c in cases}), len(seq)))
    phase('2 scan_add_u32', t0)

    # -- 3. kernel 1 against its plain version ---------------------------
    t0 = time.perf_counter()
    SLEN = 1 << W.SLENBITS

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

    FT = kernels.FILL_TILE

    def edge_case(L, wave):
        """Kernel 1's tile edges on 3 rows: pd == 0 runs across every
        tile edge (and one of 34 tiles, longer than a look-back window
        of 32), row 0 reset at index 0, row 1 at a tile's first sample,
        row 1's tail and row 2's head pd == 0 (a run across a row
        boundary: row 2 shows its own seed), row 2 reset at a tile's
        first sample."""
        V = 3
        inc = rng.randint(1 << 16, 1 << 26, size=(V, L)).astype(np.int64)
        for r in range(V):
            for e in range(FT, L, FT):
                inc[r, max(e - rng.randint(1, 40), 0):
                    e + rng.randint(1, 40)] = 0
        if L > 40 * FT:
            inc[0, 3 * FT - 5:37 * FT + 9] = 0
        inc[1, -min(L, 50):] = 0
        inc[2, :min(L, 70)] = 0
        pp = rng.randint(0, 1 << 32, size=V).astype(np.int64)
        ph = (pp[:, None] + np.cumsum(inc, axis=1)) & M32
        fi = np.array([0, min(FT, L - 1), min(2 * FT, L - 1)], np.int64)
        do_rst = np.array([True, True, L > 2 * FT])
        rph = (ph[np.arange(V), fi] - SLEN) & M32
        ps = rng.uniform(-1, 1, size=V).astype(np.float32)
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        return [piluts[wave], wave, t(ph), t(pp), t(ps), t(fi), t(do_rst),
                t(rph)]

    err1 = 0.0

    def check_k1(args, got, what, ref_args=None):
        """``got`` = kernel 1 of ``args`` against the plain version of
        ``ref_args`` (default ``args``), after a synchronise."""
        nonlocal err1
        ref = tdsp.wosc_s_filled_plain(*(ref_args or args))
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), 'wosc_fill: non-finite')
        check(bits_equal(torch, got, ref),
              'wosc_fill != plain at %s (%s): %d samples differ'
              % (tuple(got.shape), what, int((got != ref).sum())))
        err1 = max(err1, float((got - ref).abs().max()))

    for V, L, wave in ((1, 96000, W.N_sin), (4, 1 << 18, W.N_sqr),
                       (1, 1 << 20, W.N_tri), (1, 131072, W.N_saw)):
        args = fill_case(V, L, wave)
        check_k1(args, kernels.wosc_fill(*args), 'random')
    sizes1 = (1, 2, FT - 1, FT, FT + 1, 2 * FT, 5 * FT + 1, 41 * FT + 7)
    for L in sizes1:
        args = edge_case(L, W.N_sin)
        check_k1(args, kernels.wosc_fill(*args), 'tile edges')
    # rows that never move: the seed throughout (row 2's reset sample
    # itself is valid)
    args = edge_case(3 * FT + 1, W.N_tri)
    args[2] = args[3][:, None].expand(3, 3 * FT + 1).contiguous()
    args[6] = torch.tensor([False, False, True], device=dev)
    args[7] = (args[2][torch.arange(3, device=dev), args[5]] - SLEN) & M32
    got = kernels.wosc_fill(*args)
    check_k1(args, got, 'all held')
    check(bool((got[:2] == args[4][:2, None]).all()),
          'wosc_fill: an all-held row is not its seed')
    # int64 phases with bits above 32 set (and negative ones), against
    # the plain version of the phases & 0xffffffff
    for L in (FT - 1, 3 * FT + 1, 131072):
        args = edge_case(L, W.N_saw)
        wide = list(args)
        for i in (2, 3, 7):
            wide[i] = args[i] + (torch.from_numpy(rng.randint(
                -(1 << 30), 1 << 30, size=tuple(args[i].shape))).to(dev)
                << 32)
        check(bool((wide[2] < 0).any()), 'phase 3: no negative phase')
        check_k1(wide, kernels.wosc_fill(*wide), 'high bits', args)
    # rows that start at an odd element (not 16-byte aligned)
    for V, L in ((1, 3 * FT + 1), (3, FT + 5)):
        args = fill_case(V, L, W.N_sin)
        flat = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                          args[2].reshape(-1)])
        args = (args[0], args[1], flat[1:].view(V, L)) + args[3:]
        check(args[2].data_ptr() % 16 != 0, 'phase 3: the view is aligned')
        check_k1(args, kernels.wosc_fill(*args), 'odd view')
    # back to back, large and small in turn, with no synchronise
    # between calls: no call may see another's status words; then one
    # call on a side stream
    seq1 = [edge_case(L, W.N_sin) for L in (41 * FT + 7, 5, 3 * FT + 1,
                                            FT, 1, 2 * FT + 1)]
    torch.cuda.synchronize()
    outs = [kernels.wosc_fill(*a) for a in seq1]
    for a, got in zip(seq1, outs):
        check_k1(a, got, 'back to back')
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = kernels.wosc_fill(*seq1[2])
    torch.cuda.synchronize()
    check_k1(seq1[2], got, 'side stream')
    print('kernel 1 bit-equal to its plain version at 96000, 4 x 2^18, '
          '2^20 and 131072 samples (random); 3 rows at L = %s (pd == 0 '
          'runs across tile edges and a row boundary, resets at index 0 '
          'and at a tile\'s first sample); all-held rows; int64 phases '
          'with high bits; odd views; %d calls back to back and one on '
          'a side stream' % (list(sizes1), len(seq1)))
    phase('3 wosc_fill', t0)

    # -- 4. the slice's scripts at 96 kHz --------------------------------
    t0 = time.perf_counter()
    launches = {k: 0 for k in kernels.LAUNCHES}
    # launches made by graph replays over phases 4-14 (every render of
    # the main path replays graphs)
    tgraphs.reset_replayed()
    shapes = {k: set() for k in kernels.LAUNCHES}

    def kernel_shapes(prg):
        """Record the sizes the kernels get on ``prg``'s main path;
        returns its length in frames."""
        g = TorchGenerator(prg, SRATE, dev)
        for ei in range(len(g.plan.epochs)):
            for seg in g._flat_epoch(ei):
                for si, s in enumerate(seg.ep.stages):
                    n = seg.nc * seg.B
                    if s.kind == K_WRUN or (
                            s.kind == K_NOISE
                            and s.ntype in (P.NOISE_vi, P.NOISE_bv)):
                        shapes['scan_max_i32'].add(seg.nc)
                    if s.kind == K_WRUN:
                        shapes['wosc_fill'].add(n)
                    elif s.kind == K_WPHASE and si not in seg.scalar_freq:
                        shapes['scan_add_u32'].add(n)
                    elif s.kind == K_NOISE and s.ntype == P.NOISE_re:
                        shapes['scan_add_u32'].add(n)
                    elif s.kind == K_RCYCLE and si not in seg.scalar_freq:
                        shapes['scan_add_u64'].add(n)
                    elif s.kind == K_WRUN_SELF:
                        shapes['wosc_selfmod'].add(n)
                    elif s.kind == K_RRUN_SELF:
                        shapes['rasg_selfmod'].add(n)
                    if si in seg.rasg_pairs:
                        shapes['rasg_fill'].add(n)
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
    launches4 = dict(launches)
    check(launches4['scan_max_i32'] > 0, 'phase 4: kernel 4 not launched')
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
    ent = hashes['entries']['pm_bank_1024']
    check(ent['script'] == src and sha(got) == ent['sha256'],
          'bank: output != reference hash')
    print('bank %d voices, %.1f s at %d Hz: compile %.3f s, plan+bake '
          '%.3f s, render (plan+bake+device) %.3f s, realtime factor '
          '%.3f, peak device memory %d bytes, launches %s; byte-equal '
          'to the plain path and = reference hash [%s]'
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
        # muted, no file: the render_checksum path (one sync at finish)
        r = subprocess.run(
            [sys.executable, '-m', 'saugns_tpu_torch.cli', '-d',
             '-r%d' % SRATE, '-m', '-e', FLAGSHIP_SCRIPT], cwd=ROOT,
            env=env, capture_output=True, text=True, timeout=600)
        check(r.returncode == 0, 'CLI -m exited %d: %s'
              % (r.returncode, r.stderr))
    # in process, the two paths the CLI takes replay graphs: run() (the
    # stream, -o) and render_checksum() (-m alone)
    prg = stt.compile_script(FLAGSHIP_SCRIPT)
    g = TorchGenerator(prg, SRATE, dev)
    buf = np.zeros(8192, np.int16)
    while g.run(buf, 4096, True)[0]:
        pass
    st_run = g.graph_stats()
    g = TorchGenerator(prg, SRATE, dev)
    cks = int(g.render_checksum())
    st_cks = g.graph_stats()
    check(st_run['replays'] > 0 and st_run['nodes'] > 0
          and ('mono', True) in g.prepare().graphs
          and st_cks['replays'] == 1,
          'CLI paths: graphs %s, %s' % (st_run, st_cks))
    eg = TorchGenerator(prg, SRATE, dev, graphs=False)
    check(cks == int(device_checksum(eg.render_device())),
          'render_checksum: graph != eager')
    print('CLI -d -r%d -m -o x.wav -e Wsin: byte-equal to the API; -m '
          'alone (render_checksum) exits 0; in process, run() replayed %s '
          'and render_checksum() %s (= the eager checksum)'
          % (SRATE, json.dumps(st_run), json.dumps(st_cks)))
    phase('6 cli', t0)

    # -- 7. kernel 3 against its plain version ---------------------------
    t0 = time.perf_counter()
    err3 = 0

    def check_k3(x, x_np, got, what):
        """``got`` = kernel 3 of ``x`` against its plain version and
        numpy's wrapping u64 cumsum (after a synchronise)."""
        nonlocal err3
        ref = tdsp.prefix_sum_u64_plain(x)
        check(bits_equal(torch, got, ref),
              'scan_add_u64 != plain at n=%d (%s)' % (x.numel(), what))
        err3 = max(err3, int((got != ref).sum()))
        host = np.cumsum(x_np.view(np.uint64)).view(np.int64)
        check(np.array_equal(got.cpu().numpy(), host),
              'scan_add_u64 != numpy cumsum at n=%d (%s)'
              % (x.numel(), what))

    # tile edges, the main path's 38,912, many more tiles than the card
    # holds at once (2^24 + 1: 4,097 tiles); int64 bits over the whole
    # range and all ones (every add wraps)
    sizes3 = (1, TILE - 1, TILE, TILE + 1, 2 * TILE + 1, 38912, 131072,
              1 << 22, (1 << 24) + 1)
    for n in sizes3:
        for what, x_np in (('int64', full64(n)),
                           ('ones', np.full(n, -1, np.int64))):
            x = torch.from_numpy(x_np).to(dev)
            got = kernels.scan_add_u64(x)
            torch.cuda.synchronize()
            check_k3(x, x_np, got, what)
    # a view that starts at an odd element (not 16-byte aligned)
    x_np = full64(3 * TILE + 2)
    x = torch.from_numpy(x_np).to(dev)[1:]
    check(x.data_ptr() % 16 != 0, 'phase 7: the view is aligned')
    got = kernels.scan_add_u64(x)
    torch.cuda.synchronize()
    check_k3(x, x_np[1:], got, 'odd view')
    # back to back, large and small in turn, with no synchronise
    # between calls: no call may see another's status words
    seq = [full64(n) for n in ((1 << 22) + 3, 5, 3 * TILE + 1, TILE,
                               (1 << 20) + 7, 1, 2 * TILE + 1)]
    xs = [torch.from_numpy(a).to(dev) for a in seq]
    torch.cuda.synchronize()
    outs = [kernels.scan_add_u64(x) for x in xs]
    torch.cuda.synchronize()
    for x_np, x, got in zip(seq, xs, outs):
        check_k3(x, x_np, got, 'back to back')
    # one call on a side stream
    x_np = full64(3 * TILE + 1)
    x = torch.from_numpy(x_np).to(dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = kernels.scan_add_u64(x)
    torch.cuda.synchronize()
    check_k3(x, x_np, got, 'side stream')
    print('kernel 3 bit-equal to its plain version and numpy at n = %s '
          '(full int64, all-ones), an odd view, %d calls back to back and '
          'one on a side stream' % (sizes3, len(seq)))
    phase('7 scan_add_u64', t0)

    # -- 7b. kernels 2, 3 and 4 over (V, L) rows -------------------------
    t0 = time.perf_counter()
    rows_rec = row_scans(torch, np, kernels, tdsp, dev, rng, card)
    phase('7b row scans', t0)

    # -- 8. kernel 5 against its plain version ---------------------------
    t0 = time.perf_counter()

    def selfmod_case(V, L):
        """wosc self-PM inputs: audio-rate phase rows with pd == 0
        runs (and no feedback over the first eighth, so they stay
        pd == 0), inactive gaps, and seeds of which half pair the
        row's first sample with its phase minus SLEN (a reset)."""
        inc = rng.randint(1 << 16, 1 << 26, size=(V, L)).astype(np.int64)
        act = np.ones((V, L), bool)
        for r in range(V):
            for _ in range(4):
                a = rng.randint(0, L)
                inc[r, a:a + rng.randint(1, L // 8)] = 0
                a = rng.randint(0, L)
                act[r, a:a + rng.randint(1, L // 8)] = False
        ph = (rng.randint(0, 1 << 32, size=(V, 1))
              + np.cumsum(inc, axis=1)) & M32
        pp0 = rng.randint(0, 1 << 32, size=V).astype(np.int64)
        pp0[::2] = (ph[::2, 0] - SLEN) & M32
        am = rng.uniform(-1.5, 1.5, size=(V, L)).astype(np.float32)
        am[:, :L // 8] = 0
        ps0 = rng.uniform(-1, 1, size=V).astype(np.float32)
        fb0 = rng.uniform(-1, 1, size=V).astype(np.float32)
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        return t(ph), t(am), t(act), t(pp0), t(ps0), t(fb0)

    err5 = 0.0
    for wave, shape in [(w, SELFMOD_SHAPE) for w in range(len(W.WAVE_NAMES))
                        ] + [(0, SELFMOD_LONG)]:
        args = selfmod_case(*shape)
        got = kernels.wosc_selfmod(piluts[wave], wave, *args)
        ref = tdsp.wosc_selfmod_plain(piluts[wave], wave, *args)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got[0]).all()), 'wosc_selfmod: '
              'non-finite')
        for name, g, r in zip(('out', 'pp', 'ps', 'fb'), got, ref):
            check(bits_equal(torch, g, r),
                  'wosc_selfmod %s != plain for wave %d on %s: %d differ'
                  % (name, wave, shape, int((g != r).sum())))
        err5 = max(err5, float((got[0] - ref[0]).abs().max()))
    print('kernel 5 bit-equal to its plain version on %d x %d for all '
          '%d waves, and on %d x %d for the sine'
          % (SELFMOD_SHAPE + (len(W.WAVE_NAMES),) + SELFMOD_LONG))
    phase('8 wosc_selfmod', t0)

    # -- 9. kernel 6 against its plain version ---------------------------
    t0 = time.perf_counter()
    flag_sets = (0, P.RAS_O_PERLIN, P.RAS_O_HALFSHAPE, P.RAS_O_ZIGZAG,
                 P.RAS_O_SQUARE, P.RAS_O_VIOLET)

    def rasg_case(V, L):
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        return (t(rng.uniform(0, 1, size=(V, L)).astype(np.float32)),
                t(rng.randint(0, 1 << 32, size=(V, L)).astype(np.int64)),
                t(rng.uniform(-4, 4, size=(V, L)).astype(np.float32)),
                t(rng.uniform(0, 1, size=(V, L)) < 0.9),
                t(rng.uniform(-1, 1, size=V).astype(np.float32)),
                t(rng.uniform(-1, 1, size=V).astype(np.float32)))

    # every (function, flag set) pair, the line types 0-12 in turn, on
    # SELFMOD_SHAPE; the 10 s script's mode on SELFMOD_LONG
    combos = [(f, fl, i % 13, (0, 5, 27)[i % 3], SELFMOD_SHAPE)
              for i, (f, fl) in enumerate(
                  (f, fl) for fl in flag_sets for f in range(6))]
    combos.append((P.RAS_F_FIXED, 192, 0, 27, SELFMOD_LONG))
    err6 = 0.0
    for func, oflags, line, level, shape in combos:
        args = rasg_case(*shape)
        got = kernels.rasg_selfmod(func, line, level, 0x9e3779b9,
                                   oflags, *args)
        ref = tdsp.rasg_selfmod_plain(func, line, level, 0x9e3779b9,
                                      oflags, *args)
        torch.cuda.synchronize()
        for name, g, r in zip(('out', 'ps', 'fb'), got, ref):
            check(bits_equal(torch, g, r),
                  'rasg_selfmod %s != plain (func %d line %d flags %d, '
                  '%s): %d differ' % (name, func, line, oflags, shape,
                                      int((g != r).sum())))
        err6 = max(err6, float((got[0] - ref[0]).abs().max()))
    print('kernel 6 bit-equal to its plain version on %d x %d for every '
          'function x flag set {0, p, h, z, s, v} (%d pairs) and line '
          'types 0-12, and on %d x %d for the 10 s script\'s mode'
          % (SELFMOD_SHAPE + (len(combos) - 1,) + SELFMOD_LONG))
    phase('9 rasg_selfmod', t0)

    # -- 10. the noise, RasG and self-PM scripts ----------------------------
    t0 = time.perf_counter()
    def expect(name, src):
        """Kernel shapes of ``src``'s main path, checked against the
        golden entry; returns the entry."""
        ent = hashes['entries'][name]
        check(ent['script'] == src, '%s: script differs from the golden '
              'entry' % name)
        check(kernel_shapes(stt.compile_script(src)) == ent['frames'],
              '%s: frame count' % name)
        return ent

    for name, ent in sorted(hashes['entries'].items()):
        if not ent['plain']:
            continue
        src = ent['script']
        expect(name, src)
        tr = time.perf_counter()
        if name in PLAIN_CUT:
            # the full script on the kernel path against its hash, a
            # shorter one on both paths (a plain self-PM stage steps
            # through its samples in Python)
            old, new = PLAIN_CUT[name]
            check(old in src, '%s: no %r to cut' % (name, old))
            cut, ref, _ = render_both(src.replace(old, new))
            kernels.reset_launches()
            got = stt.render(src, srate=SRATE, device=dev)
            torch.cuda.synchronize()
            n = dict(kernels.LAUNCHES)
            for k in launches:
                launches[k] += n[k]
            what = 'cut to %s' % new
        else:
            got, ref, n = render_both(src)
            cut, what = got, 'whole'
        t_plain = time.perf_counter() - tr
        check(got.shape == (ent['frames'], 2), '%s: shape' % name)
        check(np.any(got != 0), '%s: silent output' % name)
        check(sha(got) == ent['sha256'], '%s: kernel path != reference '
              'hash' % name)
        check(np.any(cut != 0) and np.array_equal(cut, ref),
              '%s (%s): kernel path != plain path (%d samples differ)'
              % (name, what, int((cut != ref).sum())))
        check(name not in KERNEL_OF or n[KERNEL_OF[name]] > 0,
              '%s: %s not launched' % (name, KERNEL_OF.get(name)))
        print('render %-18s %7d frames, = reference hash, byte-equal to '
              'the plain path (%s, %d frames; all renders %.3f s), '
              'launches %s' % (name, len(got), what, len(cut), t_plain,
                               json.dumps(n, sort_keys=True)))
    check(all(hashes["entries"].get(k, {}).get("plain")
              for k in KERNEL_OF),
          'golden file: an entry of KERNEL_OF is missing')
    phase('10 slice-2 renders', t0)

    # -- 11. full-width self-PM renders -------------------------------------
    t0 = time.perf_counter()
    full = {}
    # the 1024-voice self-PM bank and the 10 s RasG script render in
    # phase 14, with graphs and op by op; their kernel shapes count here
    # (the kernels line times K5 and K6 at the main path's largest)
    for name in ('selfmod_bank_1024', 'rasg_selfpm_10s'):
        expect(name, hashes['entries'][name]['script'])
    for name in ('selfmod_bank_16',):
        src = hashes['entries'][name]['script']
        ent = expect(name, src)
        tc = time.perf_counter()
        prg = stt.compile_script(src)
        t_compile = time.perf_counter() - tc
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
        tw = time.perf_counter()
        gen.render_device()
        torch.cuda.synchronize()
        t_warm = time.perf_counter() - tw
        secs = ent['frames'] / SRATE
        check(sha(got) == ent['sha256'], '%s: output != reference hash'
              % name)
        full[name] = n
        print('%s, %.1f s at %d Hz: = reference hash; compile %.3f s, '
              'plan+bake %.3f s, first render (plan+bake+device) %.3f s '
              '(realtime factor %.3f), second render %.3f s (realtime '
              'factor %.3f), peak device memory %d bytes, launches %s '
              '[%s]' % (name, secs, SRATE, t_compile, t_plan, t_render,
                        secs / t_render, t_warm, secs / t_warm, peak,
                        json.dumps(n, sort_keys=True), card))
        # each self-PM stage launches its kernel once per chunk
        for kd, key in ((K_WRUN_SELF, 'wosc_selfmod'),
                        (K_RRUN_SELF, 'rasg_selfmod')):
            want = sum(seg.nch * sum(s.kind == kd for s in seg.ep.stages)
                       for ei in range(len(gen.plan.epochs))
                       for seg in gen._flat_epoch(ei))
            check(n[key] == want, '%s: %d launches of %s, expected %d'
                  % (name, n[key], key, want))
    check(full['selfmod_bank_16']['wosc_selfmod'] >= 16,
          'self-PM bank: kernel 5 not launched')
    phase('11 full-width self-PM', t0)

    # -- 12. kernels 7/8, 9, 10 and 4 against their plain versions -------
    t0 = time.perf_counter()
    seq_renders = [
        # (name, script, every epoch sequential, also on the plain path)
        ('pm_smoothchange', hashes['entries']['pm_smoothchange']['script'],
         False, True),
        ('seq_flagship', FLAGSHIP_SCRIPT, True, True),
        ('seq_bank_16', make_bank_script(16, seed=0, duration=1.0), True,
         True),
        ('seq_selfmod_bank_16',
         make_selfmod_bank_script(16, seed=0, duration=1.0), True, False)]
    seq_renders += [(name, ent['script'], True,
                     name not in KERNEL_OF or KERNEL_OF[name]
                     not in ('wosc_selfmod', 'rasg_selfmod'))
                    for name, ent in sorted(hashes['entries'].items())
                    if ent['plain']]

    def seq_shapes(prg, flat):
        """Record the sizes the sequential engine gives kernels 7/8, 9
        and 10 on ``prg``'s main path: a same-level group of n K_WRUN
        stages gathers n * B taps and fills (n, B); a lone one computes
        B Is values and fills (1, B)."""
        g = TorchGenerator(prg, SRATE, dev, flat=flat)
        for ei, ep in enumerate(g.plan.epochs):
            if not g.sequential(ei):
                continue
            for group in _analyze_schedule(ep.sig[0], ep.sig[1])[0]:
                if group[0] == 'wrun':
                    shapes['gather_taps'].add(len(group[2]) * ep.block)
                    shapes['ffill'].add((len(group[2]), ep.block))
                elif group[0] == 'stages':
                    for si in group[1]:
                        if ep.stages[si].kind == K_WRUN:
                            shapes['is64'].add(ep.block)
                            shapes['ffill'].add((1, ep.block))

    for name, src, every, _p in seq_renders:
        seq_shapes(stt.compile_script(src), not every)
    big = 1 << 22
    n8 = max(shapes['gather_taps'])
    n9 = max(shapes['is64'])
    s10 = max(shapes['ffill'], key=lambda vl: vl[0] * vl[1])
    n4 = max(shapes['scan_max_i32'])
    err8 = err9 = err10 = err4 = 0.0
    for n in (n8, big):
        for wave in range(len(W.WAVE_NAMES)):
            cells = torch.from_numpy(rng.randint(0, W.LEN, size=n)).to(dev)
            got = kernels.gather_taps(piluts[wave], cells)
            ref = tdsp.gather_taps_plain(piluts[wave], cells)
            torch.cuda.synchronize()
            check(bits_equal(torch, got, ref),
                  'gather_taps != plain at n=%d wave %d' % (n, wave))
            err8 = max(err8, float((got - ref).abs().max()))
            ph = torch.from_numpy(rng.randint(0, 1 << 32, size=n,
                                              dtype=np.int64)).to(dev)
            got9 = kernels.is64(piluts[wave], ph)
            ref9 = tdsp.is64_plain(piluts[wave], ph)
            torch.cuda.synchronize()
            check(got9.dtype == torch.float64 and torch.equal(
                got9.view(torch.int64), ref9.view(torch.int64)),
                'is64 != plain at n=%d wave %d' % (n, wave))
            err9 = max(err9, float((got9 - ref9).abs().max()))
    print('kernels 7/8 and 9 bit-equal to their plain versions at n = '
          '%d and %d for all %d waves' % (n8, big, len(W.WAVE_NAMES)))
    # kernel 9 reads the int64 phases as they come: bits above 32 and
    # negative values (only the low 32 bits count), views that start at
    # an odd element (not 16-byte aligned), odd lengths
    x9 = torch.from_numpy(full64(n9 + 9)).to(dev)
    check(x9[1:].data_ptr() % 16 != 0, 'phase 12: the view is aligned')
    cases9 = (x9, x9[1:], x9[3:-2], x9[1:8], x9[:7], x9[:1])
    for v in cases9:
        for wave in (W.N_sin, W.N_spa):
            got9 = kernels.is64(piluts[wave], v)
            ref9 = tdsp.is64_plain(piluts[wave], v & M32)
            torch.cuda.synchronize()
            check(torch.equal(got9.view(torch.int64), ref9.view(torch.int64)),
                  'is64 != plain at n=%d (high bits, offset %d B)'
                  % (v.numel(), v.data_ptr() % 16))
            err9 = max(err9, float((got9 - ref9).abs().max()))
    print('kernel 9 bit-equal to its plain version on int64 phases over '
          'the whole range at n = %s, odd views among them'
          % [v.numel() for v in cases9])

    def wide_cells(n, dtype):
        """Cells over the whole range of ``dtype``: negative ones and
        ones far above 2047."""
        info = np.iinfo(dtype)
        return rng.randint(info.min, info.max, size=n,
                           dtype=np.int64).astype(dtype)

    # kernel 8 reads int64 and int32 cells as they come: n of 1-7 and n
    # not a multiple of 4 (the tap rows 1-3 unaligned), views that
    # start at an odd element (the cells unaligned)
    cases8 = []
    for dtype in (np.int64, np.int32):
        cases8 += [torch.from_numpy(wide_cells(n, dtype)).to(dev)
                   for n in (1, 2, 3, 4, 5, 6, 7, 4097, n8 + 3)]
        c = torch.from_numpy(wide_cells(4 * TILE + 9, dtype)).to(dev)
        check(c[1:].data_ptr() % 16 != 0, 'phase 12: the view is aligned')
        cases8 += [c[1:], c[3:-2]]
    cases8.append(torch.from_numpy(rng.randint(0, W.LEN, size=n8)
                                   .astype(np.int32)).to(dev))
    for cells in cases8:
        for wave in (W.N_sin, W.N_spa):
            got = kernels.gather_taps(piluts[wave], cells)
            ref = tdsp.gather_taps_plain(piluts[wave], cells)
            torch.cuda.synchronize()
            check(bits_equal(torch, got, ref),
                  'gather_taps != plain at n=%d (%s, offset %d B)'
                  % (cells.numel(), cells.dtype, cells.data_ptr() % 16))
            err8 = max(err8, float((got - ref).abs().max()))
    print('kernel 8 bit-equal to its plain version on %d more cases: '
          'int64 and int32 cells over their whole range, n of 1-7 and '
          'not a multiple of 4, odd views' % len(cases8))

    def ffill_case(V, L):
        """Rows with long runs of invalid values (one longer than the
        256-block look-back window), an invalid head (the seed shows),
        an all-valid row and an all-invalid row."""
        sv = rng.uniform(-1, 1, size=(V, L)).astype(np.float32)
        valid = np.ones((V, L), bool)
        for r in range(V):
            for _ in range(8):
                a = rng.randint(0, L)
                valid[r, a:a + rng.randint(1, 3000)] = False
            if L > 140000:
                a = rng.randint(0, L - 70000)
                valid[r, a:a + 70000] = False
        valid[0, :7] = False
        if V > 2:
            valid[1] = True
            valid[2] = False
        seed = rng.uniform(-1, 1, size=V).astype(np.float32)
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        return t(sv), t(valid), t(seed)

    def ffill_sparse(V, L):
        """Rows whose invalid positions are isolated (one-step fill
        past length), with NaN payloads and -0.0 among the values."""
        sv, _, seed = ffill_case(V, L)
        w = sv.view(torch.int32).reshape(-1)
        w[::97] = 0x7fc01234
        w[11::101] = -(1 << 31)
        valid = torch.from_numpy(rng.rand(V, L) > 0.02).to(dev)
        valid[:, 1:] |= ~valid[:, :-1]
        return sv, valid, seed

    def ffill_lengths(V, L):
        """(V,) int64 lengths at kernel 10's edges, the longest
        look-back first: half a row, then negative, 0, 1, around a
        tile edge, L - 1, L, past L."""
        cyc = [L // 2 + 3, -1, 0, 1, FT - 1, FT, FT + 1, L - 1, L, L + 5]
        return torch.tensor([cyc[r % len(cyc)] for r in range(V)],
                            dtype=torch.int64, device=dev)

    def check_k10(args, length, what):
        nonlocal err10
        got = kernels.ffill(*args, length)
        if length is None:
            ref = tdsp.last_valid_fill(*args)
        else:
            ref = tdsp.forward_fill_valid_plain(*args, length)
        torch.cuda.synchronize()
        check(bits_equal(torch, got, ref), 'ffill != plain at %s (%s): '
              '%d differ' % (tuple(args[0].shape), what,
                             int((got.view(torch.int32)
                                  != ref.view(torch.int32)).sum())))
        fin = torch.isfinite(ref)
        err10 = max(err10, float((got[fin] - ref[fin]).abs().max()))

    for V, L in (s10, (4, big // 4)):
        for case in (ffill_case, ffill_sparse):
            args10 = case(V, L)
            check_k10(args10, None, case.__name__)
            lens10 = ffill_lengths(V, L)
            check_k10(args10, lens10, case.__name__ + ', lengths')
            check_k10(args10, torch.ones_like(lens10),
                      case.__name__ + ', every row split at 1')
            before = dict(kernels.LAUNCHES)
            got = tdsp.forward_fill_valid(*args10, lens10)
            ref = tdsp.forward_fill_valid_plain(*args10, lens10)
            torch.cuda.synchronize()
            check(bits_equal(torch, got, ref)
                  and kernels.LAUNCHES == dict(before,
                                               ffill=before['ffill'] + 1),
                  'tdsp.forward_fill_valid != plain or not one launch at '
                  '(%d, %d)' % (V, L))
    print('kernel 10 bit-equal to its plain version at %s and (4, %d), '
          'runs and isolated invalid positions (NaN payloads, -0.0), '
          'with and without lengths at the tile edges; '
          'tdsp.forward_fill_valid on the card = its plain version, one '
          'launch a call' % (s10, big // 4))

    def max_case(n):
        x = rng.randint(0, 1 << 31, size=n).astype(np.int32)
        x[::5] = 0
        x[n // 3:n // 3 + 9] = 0x7fffffff
        return torch.from_numpy(x).to(dev)

    def ramp_case(n, low):
        """A rising ramp with noise, so the running max changes in every
        tile; ``low`` < 0 gives negative inputs at the head and in runs
        (kernel 4 clamps them to 0)."""
        x = np.arange(n, dtype=np.int64) * 64 + rng.randint(low, 1000, n)
        for _ in range(8 if low < 0 else 0):
            a = rng.randint(0, n)
            x[a:a + rng.randint(1, 3 * TILE)] = -rng.randint(1, 1 << 31)
        return torch.from_numpy(np.clip(x, -(1 << 31), (1 << 31) - 1)
                                .astype(np.int32)).to(dev)

    def check_k4(x4, got, what):
        nonlocal err4
        ref = tdsp.scan_max_i32_plain(x4)
        check(torch.equal(got, ref), 'scan_max_i32 != plain at n=%d (%s)'
              % (x4.numel(), what))
        err4 = max(err4, float((got - ref).abs().max()))
        want = torch.cummax(torch.clamp(x4, min=0), 0).values
        check(torch.equal(got, want), 'scan_max_i32 != torch.cummax at '
              'n=%d (%s)' % (x4.numel(), what))

    sizes4 = (n4, 1000, TILE - 1, TILE, TILE + 1, 3 * TILE + 1, big,
              (1 << 24) + 1)
    for n in sizes4:
        x4 = max_case(n)
        got = kernels.scan_max_i32(x4)
        torch.cuda.synchronize()
        check_k4(x4, got, 'random')
    for n in (2, TILE + 1, 3 * TILE + 1, (1 << 24) + 1):
        for low in (0, -100000):
            x4 = ramp_case(n, low)
            got = kernels.scan_max_i32(x4)
            torch.cuda.synchronize()
            check_k4(x4, got, 'ramp, low %d' % low)
    x4 = torch.from_numpy(rng.randint(-(1 << 31), 1 << 31, size=3 * TILE + 1)
                          .astype(np.int32)).to(dev)
    got = kernels.scan_max_i32(x4)
    torch.cuda.synchronize()
    check_k4(x4, got, 'negative')
    seq4 = [ramp_case(n, -1000) for n in ((1 << 22) + 3, 2, 3 * TILE + 1,
                                          TILE, (1 << 20) + 7, 1)]
    torch.cuda.synchronize()
    outs = [kernels.scan_max_i32(x4) for x4 in seq4]
    torch.cuda.synchronize()
    for x4, got in zip(seq4, outs):
        check_k4(x4, got, 'back to back')
    x4 = ramp_case(3 * TILE + 1, -1000)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = kernels.scan_max_i32(x4)
    torch.cuda.synchronize()
    check_k4(x4, got, 'side stream')
    print('kernel 4 bit-equal to its plain version and torch.cummax (of '
          'the inputs clamped to 0) at n = %s (random >= 0, ramps with '
          'negative runs, negative), %d calls back to back and one on a '
          'side stream' % (sorted(set(sizes4) | {2}), len(seq4)))
    phase('12 seq kernels', t0)

    # -- 13. the sequential-scan engine at 96 kHz ---------------------------
    t0 = time.perf_counter()
    launches13 = {k: 0 for k in kernels.LAUNCHES}
    for name, src, every, with_plain in seq_renders:
        ent = hashes['entries'][name]
        check(ent['script'] == src, '%s: script differs from the golden '
              'entry' % name)
        prg = stt.compile_script(src)
        torch.cuda.synchronize()
        kernels.reset_launches()
        tr = time.perf_counter()
        gen = TorchGenerator(prg, SRATE, dev, flat=not every)
        pieces = gen.render_device()
        torch.cuda.synchronize()
        t_first = time.perf_counter() - tr
        got = gen.assemble(pieces)
        n = dict(kernels.LAUNCHES)
        for k in launches:
            launches[k] += n[k]
            launches13[k] += n[k]
        n_seq = sum(gen.sequential(ei)
                    for ei in range(len(gen.plan.epochs)))
        check(n_seq > 0 and (not every
                             or n_seq == len(gen.plan.epochs)),
              '%s: %d of %d epochs sequential'
              % (name, n_seq, len(gen.plan.epochs)))
        tw = time.perf_counter()
        gen.render_device()
        torch.cuda.synchronize()
        t_warm = time.perf_counter() - tw
        check(got.shape == (ent['frames'], 2), '%s: shape' % name)
        check(np.any(got != 0), '%s: silent output' % name)
        check(sha(got) == ent['sha256'], '%s: sequential render != '
              'reference hash' % name)
        note = ''
        if with_plain:
            refg = TorchGenerator(prg, SRATE, dev, plain=True,
                                  flat=not every)
            ref = refg.assemble(refg.render_device())
            check(np.array_equal(got, ref),
                  '%s: sequential kernel path != plain path (%d samples '
                  'differ)' % (name, int((got != ref).sum())))
            note = ', byte-equal to the plain path'
        secs = ent['frames'] / SRATE
        print('seq %-17s %7d frames, %d/%d epochs sequential, = reference '
              'hash%s; first render %.3f s (realtime factor %.3f), second '
              '%.3f s (%.3f), launches %s [%s]'
              % (name, len(got), n_seq, len(gen.plan.epochs), note,
                 t_first, secs / t_first, t_warm, secs / t_warm,
                 json.dumps({k: v for k, v in n.items() if v},
                            sort_keys=True), card))
    # self-PM on the plain path steps through samples in Python: a
    # short cut of the one-voice script
    src = 'Wsin f110 t.02 p.a.3'
    got = TorchGenerator(stt.compile_script(src), SRATE, dev, flat=False)
    got = got.assemble(got.render_device())
    refg = TorchGenerator(stt.compile_script(src), SRATE, dev, plain=True,
                          flat=False)
    ref = refg.assemble(refg.render_device())
    check(np.any(got != 0) and np.array_equal(got, ref),
          '%r: sequential kernel path != plain path' % src)
    print('seq %r: byte-equal to the plain path' % src)
    for k in ('gather_taps', 'is64', 'ffill'):
        check(launches13[k] > 0, 'phase 13: %s not launched' % k)
    print('phase 13 launches: %s' % json.dumps(launches13, sort_keys=True))
    phase('13 sequential engine', t0)

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
    # once (kernel 1: int64 phases in, float32 samples out, the 8 KB
    # PILUT and the per-row seeds of 8 + 4 + 8 + 1 + 8 bytes)
    k2_bytes = 8 * n2

    def bound(nbytes, *ops):
        """(ms, 'bytes' or 'operations'): the larger of the bytes over
        the memory rate and each (operations, rate) term."""
        b = nbytes / HBM_BYTES_PER_S
        o = max([c / r for c, r in ops] or [0.0])
        return 1e3 * max(b, o), 'bytes' if b >= o else 'operations'

    def k1_bound(n):
        return bound(12 * n + 4 * W.LEN + 29, (K1_F64_OPS * n, fp64_rate),
                     (K1_CVT64_OPS * n, cvt64_rate))

    def k9_bound(n):
        return bound(16 * n + 4 * W.LEN, (K9_F64_OPS * n, fp64_rate),
                     (K9_CVT64_OPS * n, cvt64_rate))

    k1_b = k1_bound(n1)
    # kernel 3 at the largest size the main path gave it
    n3 = max(shapes['scan_add_u64'])
    x3 = torch.from_numpy(rng.randint(-(1 << 63), (1 << 63) - 1, size=n3,
                                      dtype=np.int64)).to(dev)
    k3_ms = time_ms(torch, lambda: kernels.scan_add_u64(x3), 50)
    k3_plain = time_ms(torch, lambda: tdsp.prefix_sum_u64_plain(x3), 10)
    k3_lib = time_ms(torch, lambda: torch.cumsum(x3, 0), 50)

    # kernels 5 and 6: the plain versions step through the samples in
    # Python, so kernel and plain version are timed on one row of
    # N_SELF samples; the kernel also on one row of the main path's
    # chunk, and the dependent chain's time per sample is the slope
    # between the two kernel times
    N_SELF = 4096
    n5 = max(shapes['wosc_selfmod'])
    n6 = max(shapes['rasg_selfmod'])

    def all_active(args, i):
        """``args`` with its gate (argument ``i``) all True."""
        return args[:i] + (torch.ones_like(args[i]),) + args[i + 1:]

    # the plain versions' outputs of the timed rows are kept and held
    # bit for bit against the kernels' (a chain of N_SELF samples)
    plain = {}
    a5 = all_active(selfmod_case(1, N_SELF), 2)
    a5m = all_active(selfmod_case(1, n5), 2)
    k5_ms = time_ms(torch, lambda: kernels.wosc_selfmod(
        piluts[0], 0, *a5), 10)
    k5_plain = time_ms(torch, lambda: plain.__setitem__(
        5, tdsp.wosc_selfmod_plain(piluts[0], 0, *a5)), 1)
    k5_main = time_ms(torch, lambda: kernels.wosc_selfmod(
        piluts[0], 0, *a5m), 3)
    rs = (P.RAS_F_FIXED, 0, 27, 0x9e3779b9, 192)  # the 10 s script's mode
    a6 = all_active(rasg_case(1, N_SELF), 3)
    a6m = all_active(rasg_case(1, n6), 3)
    k6_ms = time_ms(torch, lambda: kernels.rasg_selfmod(*rs, *a6), 10)
    k6_plain = time_ms(torch, lambda: plain.__setitem__(
        6, tdsp.rasg_selfmod_plain(*rs, *a6)), 1)
    k6_main = time_ms(torch, lambda: kernels.rasg_selfmod(*rs, *a6m), 3)
    for k, got in ((5, kernels.wosc_selfmod(piluts[0], 0, *a5)),
                   (6, kernels.rasg_selfmod(*rs, *a6))):
        torch.cuda.synchronize()
        for g, r in zip(got, plain[k]):
            check(bits_equal(torch, g, r), 'kernel %d != plain on the '
                  'timed row of %d samples: %d differ'
                  % (k, N_SELF, int((g != r).sum())))
        e = float((got[0] - plain[k][0]).abs().max())
        if k == 5:
            err5 = max(err5, e)
        else:
            err6 = max(err6, e)
    print('kernels 5 and 6 bit-equal to their plain versions on the timed '
          'rows (1 x %d, all active)' % N_SELF)
    k5_chain = (k5_main - k5_ms) / (n5 - N_SELF)
    k6_chain = (k6_main - k6_ms) / (n6 - N_SELF)

    # bytes: kernel 3 reads and writes 8 B per element; kernel 5 reads
    # phase (int64), amount and gate (8 + 4 + 1 B) and writes 4 B per
    # sample, plus the 8 KB PILUT and 40 B of seeds and end states;
    # kernel 6 reads phase, cycle (int64), amount and gate (4 + 8 + 4 +
    # 1 B) and writes 4 B per sample, plus 16 B of seeds and end states.
    # These roofline bounds cannot bind a serial chain: the kernels
    # line gives kernels 5 and 6 the latency bound of their chain
    # (bound_by "chain": the probe's bound per sample x the active
    # samples of the call) and keeps the roofline beside it
    def k5_bound(n):
        return bound(17 * n + 4 * W.LEN + 40, (K5_F64_OPS * n, fp64_rate))

    def k6_bound(n):
        return bound(21 * n + 16, (K6_F32_OPS * n, fp32_rate))

    k3_bound = bound(16 * n3)
    roof_main = {'wosc_selfmod': k5_bound(n5)[0],
                 'rasg_selfmod': k6_bound(n6)[0]}
    k5_roof, k6_roof = k5_bound(N_SELF), k6_bound(N_SELF)
    # the timed rows are all active: N_SELF active samples
    c5, c6 = chains[K5_CHAIN], chains[K6_CHAIN]
    kern = [
        {'name': 'wosc_fill', 'route': 'cuda',
         'source': 'saugns_tpu_torch/csrc/wosc_fill.cu',
         'replaces': 'saugns_tpu/render/jdsp.py:2247',
         'launches': launches['wosc_fill'], 'max_abs_err': err1,
         'ms': k1_ms, 'plain_ms': k1_plain,
         'bound_ms': k1_b[0], 'bound_by': k1_b[1],
         'library_ms': None, 'n': n1},
        {'name': 'scan_add_u32', 'route': 'cuda',
         'source': 'saugns_tpu_torch/csrc/scan_add_u32.cu',
         'replaces': 'saugns_tpu/render/jdsp.py:2615',
         'launches': launches['scan_add_u32'], 'max_abs_err': err2,
         'ms': k2_ms, 'plain_ms': k2_plain,
         'bound_ms': 1e3 * k2_bytes / HBM_BYTES_PER_S, 'bound_by': 'bytes',
         'library_ms': k2_lib, 'n': n2, 'rows': rows_rec['scan_add_u32']},
        {'name': 'scan_add_u64', 'route': 'cuda',
         'source': 'saugns_tpu_torch/csrc/scan_add_u64.cu',
         'replaces': 'saugns_tpu/render/jdsp.py:2636',
         'launches': launches['scan_add_u64'], 'max_abs_err': err3,
         'ms': k3_ms, 'plain_ms': k3_plain, 'bound_ms': k3_bound[0],
         'bound_by': k3_bound[1], 'library_ms': k3_lib, 'n': n3,
         'rows': rows_rec['scan_add_u64']},
        {'name': 'wosc_selfmod', 'route': 'cuda',
         'source': 'saugns_tpu_torch/csrc/wosc_selfmod.cu',
         'replaces': 'saugns_tpu/render/jdsp.py:1054',
         'launches': launches['wosc_selfmod'], 'max_abs_err': err5,
         'ms': k5_ms, 'plain_ms': k5_plain,
         'bound_ms': 1e-6 * c5['ns_per_sample'] * N_SELF,
         'bound_by': 'chain', 'roofline_ms': k5_roof[0],
         'roofline_by': k5_roof[1], 'library_ms': None, 'n': N_SELF,
         'main_n': n5, 'main_ms': k5_main,
         'chain_ms_per_sample': k5_chain,
         'chain_bound_ns_per_sample': c5['ns_per_sample'],
         'chain_bound_cycles': c5['cycles'], 'chain_ops': c5['ops']},
        {'name': 'rasg_selfmod', 'route': 'cuda',
         'source': 'saugns_tpu_torch/csrc/rasg_selfmod.cuh',
         'replaces': 'saugns_tpu/render/jdsp.py:1432',
         'launches': launches['rasg_selfmod'], 'max_abs_err': err6,
         'ms': k6_ms, 'plain_ms': k6_plain,
         'bound_ms': 1e-6 * c6['ns_per_sample'] * N_SELF,
         'bound_by': 'chain', 'roofline_ms': k6_roof[0],
         'roofline_by': k6_roof[1], 'library_ms': None, 'n': N_SELF,
         'main_n': n6, 'main_ms': k6_main,
         'chain_ms_per_sample': k6_chain,
         'chain_bound_ns_per_sample': c6['ns_per_sample'],
         'chain_bound_cycles': c6['cycles'], 'chain_ops': c6['ops']},
        rasg_fill_record(torch, np, kernels, tdsp, dev, launches, card,
                         max(shapes['rasg_fill'], default=None)),
    ]
    # kernels 7/8, 9, 10 and 4 at the largest shape the main path gave
    # them; the library yardsticks: torch.take of the precomputed tap
    # index (4, N) for 7/8, torch.cummax for 4. Kernel 8's cells are
    # int64, as the main path gives them (8 B in and 16 B out a cell)
    off = torch.arange(-1, 3, device=dev)[:, None]
    cells = torch.from_numpy(rng.randint(0, W.LEN, size=n8)).to(dev)
    tidx = (cells[None, :] + off) & (W.LEN - 1)
    k8 = (time_ms(torch, lambda: kernels.gather_taps(piluts[0], cells), 50),
          time_ms(torch, lambda: tdsp.gather_taps_plain(piluts[0], cells),
                  20),
          time_ms(torch, lambda: torch.take(piluts[0], tidx), 50))
    ph = torch.from_numpy(rng.randint(0, 1 << 32, size=n9,
                                      dtype=np.int64)).to(dev)
    k9 = (time_ms(torch, lambda: kernels.is64(piluts[0], ph), 50),
          time_ms(torch, lambda: tdsp.is64_plain(piluts[0], ph), 20), None)
    # kernel 10 as the main path calls it: with lengths
    a10 = ffill_case(*s10)
    l10 = ffill_lengths(*s10)
    k10 = (time_ms(torch, lambda: kernels.ffill(*a10, l10), 50),
           time_ms(torch, lambda: tdsp.forward_fill_valid_plain(*a10, l10),
                   20), None)
    x4 = max_case(n4)
    k4 = (time_ms(torch, lambda: kernels.scan_max_i32(x4), 50),
          time_ms(torch, lambda: tdsp.scan_max_i32_plain(x4), 20),
          time_ms(torch, lambda: torch.cummax(x4, 0), 50))
    n10 = s10[0] * s10[1]
    for name, src_f, repl, err, t, bnd, n in (
            ('gather_taps', 'gather_taps.cu',
             'saugns_tpu/render/jdsp.py:1873, '
             'saugns_tpu/render/jdsp.py:1631', err8, k8,
             bound(24 * n8 + 4 * W.LEN), n8),
            ('is64', 'is64.cu', 'saugns_tpu/render/jdsp.py:1909', err9, k9,
             k9_bound(n9), n9),
            ('ffill', 'ffill.cu', 'saugns_tpu/render/jdsp.py:2025', err10,
             k10, bound(9 * n10 + 12 * s10[0]), n10),
            ('scan_max_i32', 'scan_max_i32.cu',
             'saugns_tpu/render/jdsp.py:2680', err4, k4,
             bound(8 * n4), n4)):
        kern.append({'name': name, 'route': 'cuda',
                     'source': 'saugns_tpu_torch/csrc/' + src_f,
                     'replaces': repl, 'launches': launches[name],
                     'max_abs_err': err, 'ms': t[0], 'plain_ms': t[1],
                     'bound_ms': bnd[0], 'bound_by': bnd[1],
                     'library_ms': t[2], 'n': n})
        if name == 'scan_max_i32':
            kern[-1]['rows'] = rows_rec[name]
    for k in kern:
        check(k['launches'] > 0, '%s: no launch on the main path'
              % k['name'])
        print('%s at n = %d: kernel %.4f ms, plain %.4f ms, library %s, '
              'bound %.6f ms (%s), %d launches on the main path'
              % (k['name'], k['n'], k['ms'], k['plain_ms'],
                 'none' if k['library_ms'] is None
                 else '%.4f ms' % k['library_ms'], k['bound_ms'],
                 k['bound_by'], k['launches']))
        if 'main_n' in k:
            print('%s at the main path\'s n = %d: kernel %.4f ms; '
                  'measured chain time %.6f us per sample (the slope '
                  'of the kernel\'s times at %d and %d samples); '
                  'latency bound %.6f us per sample (%d operations on '
                  'the loop-carried chain, %.1f cycles at %.4f GHz), '
                  'the kernel at %.2fx its bound; roofline bound %.6f ms '
                  '[%s]'
                  % (k['name'], k['main_n'], k['main_ms'],
                     1e3 * k['chain_ms_per_sample'], N_SELF, k['main_n'],
                     1e-3 * k['chain_bound_ns_per_sample'],
                     k['chain_ops'], k['chain_bound_cycles'], lat['ghz'],
                     1e6 * k['chain_ms_per_sample']
                     / k['chain_bound_ns_per_sample'],
                     roof_main[k['name']], card))
    # the same kernels at 2^22 elements, where bytes, not launches,
    # should set the time
    big = 1 << 22
    x = torch.from_numpy(rng.randint(0, 1 << 32, size=big,
                                     dtype=np.int64)).to(dev)
    args = fill_case(1, big, W.N_sin)
    x3 = torch.from_numpy(rng.randint(-(1 << 63), (1 << 63) - 1, size=big,
                                      dtype=np.int64)).to(dev)
    print('at n = %d: scan_add_u32 %.4f ms (bound %.4f ms, %.4f ms for '
          'the 16 B of the int64 contract, torch.cumsum %.4f ms), '
          'wosc_fill %.4f ms (bound %.4f ms), scan_add_u64 '
          '%.4f ms (bound %.4f ms, torch.cumsum %.4f ms)'
          % (big, time_ms(torch, lambda: kernels.scan_add_u32(x), 20),
             1e3 * 8 * big / HBM_BYTES_PER_S,
             1e3 * 16 * big / HBM_BYTES_PER_S,
             time_ms(torch, lambda: torch.cumsum(x, 0) & M32, 20),
             time_ms(torch, lambda: kernels.wosc_fill(*args), 20),
             k1_bound(big)[0],
             time_ms(torch, lambda: kernels.scan_add_u64(x3), 20),
             1e3 * 16 * big / HBM_BYTES_PER_S,
             time_ms(torch, lambda: torch.cumsum(x3, 0), 20)))
    cells = torch.from_numpy(rng.randint(0, W.LEN, size=big)).to(dev)
    tidx = (cells[None, :] + off) & (W.LEN - 1)
    ph = torch.from_numpy(rng.randint(0, 1 << 32, size=big,
                                      dtype=np.int64)).to(dev)
    # kernel 10 at (4, 2^20): without lengths, with edge lengths, and
    # with every row split at length 1, where every tile looks back
    a10b = ffill_case(4, big // 4)
    l10b = ffill_lengths(4, big // 4)
    l10w = torch.ones(4, dtype=torch.int64, device=dev)
    x4 = max_case(big)
    print('at n = %d: gather_taps %.4f ms (bound %.4f ms, torch.take '
          '%.4f ms), is64 %.4f ms (bound %.4f ms), ffill (4, %d) %.4f ms, '
          'with lengths %.4f ms, every tile looking back %.4f ms (bound '
          '%.4f ms), scan_max_i32 %.4f ms (bound %.4f ms, torch.cummax '
          '%.4f ms)'
          % (big, time_ms(torch, lambda: kernels.gather_taps(piluts[0],
                                                             cells), 20),
             1e3 * 24 * big / HBM_BYTES_PER_S,
             time_ms(torch, lambda: torch.take(piluts[0], tidx), 20),
             time_ms(torch, lambda: kernels.is64(piluts[0], ph), 20),
             k9_bound(big)[0], big // 4,
             time_ms(torch, lambda: kernels.ffill(*a10b), 20),
             time_ms(torch, lambda: kernels.ffill(*a10b, l10b), 20),
             time_ms(torch, lambda: kernels.ffill(*a10b, l10w), 20),
             bound(9 * big + 12 * 4)[0],
             time_ms(torch, lambda: kernels.scan_max_i32(x4), 20),
             1e3 * 8 * big / HBM_BYTES_PER_S,
             time_ms(torch, lambda: torch.cummax(x4, 0), 20)))
    # the device operations of one call at the main path's largest
    # shape of kernel 2, kernel 4 (over a chunk's rows), kernel 3,
    # kernel 8 (int64 cells), kernel 1 (one row, the callers' dtypes),
    # kernel 9 (int64 phases), kernels 5 and 6 (one all-active row,
    # int64 phases and cycles as the callers hold them) and kernel 10
    # (without and with lengths, and the sequential engine's
    # tdsp.forward_fill_valid): a scan, kernel 1 and kernel 10 are one
    # launch and at most one memset, the tap gather, kernel 9 and the
    # self-PM kernels one launch each, with no elementwise op; the host
    # time is the wrapper's enqueue cost.
    # Last, so that the profiler cannot touch the times above
    x = torch.from_numpy(rng.randint(0, 1 << 32, size=n2,
                                     dtype=np.int64)).to(dev)
    x4 = max_case(n4)
    x3 = torch.from_numpy(full64(n3)).to(dev)
    cells = torch.from_numpy(rng.randint(0, W.LEN, size=n8)).to(dev)
    a1 = fill_case(1, n1, W.N_sin)
    ph9 = torch.from_numpy(full64(n9)).to(dev)
    # (name, call, n, the kernel's name, memsets allowed, host reps)
    calls = (('scan_add_u32', lambda: kernels.scan_add_u32(x), n2,
              'lookback_scan', 1, 200),
             ('scan_max_i32', lambda: kernels.scan_max_i32(x4), n4,
              'lookback_scan', 1, 200),
             ('scan_add_u64', lambda: kernels.scan_add_u64(x3), n3,
              'lookback_scan', 1, 200),
             ('gather_taps', lambda: kernels.gather_taps(piluts[0], cells),
              n8, 'gather_taps', 0, 200),
             ('wosc_fill', lambda: kernels.wosc_fill(*a1), n1,
              'wosc_fill_k', 1, 200),
             ('is64', lambda: kernels.is64(piluts[0], ph9), n9, 'is64_k', 0,
              200),
             ('wosc_selfmod', lambda: kernels.wosc_selfmod(
                 piluts[0], 0, *a5m), n5, 'wosc_selfmod_rows', 0, 5),
             ('rasg_selfmod', lambda: kernels.rasg_selfmod(*rs, *a6m), n6,
              'rasg_rows', 0, 5),
             ('ffill', lambda: kernels.ffill(*a10), n10, 'ffill_k', 1, 200),
             ('ffill with lengths', lambda: kernels.ffill(*a10, l10), n10,
              'ffill_k', 1, 200),
             ('tdsp.forward_fill_valid',
              lambda: tdsp.forward_fill_valid(*a10, l10), n10, 'ffill_k', 1,
              200))
    hosts = [host_us(torch, c[1], c[5]) for c in calls]
    for (name, fn, n, kname, n_sets, _r), h in zip(calls, hosts):
        ops = device_ops(torch, fn)
        if ops is None:
            print('profile %s at n = %d: device operations not measured '
                  '(the profiler saw no device activity); host %.2f us '
                  'per call [%s]' % (name, n, h, card))
            continue
        scans = [o for o in ops if kname in o[0]]
        sets = [o for o in ops if 'emset' in o[0]]
        check(len(scans) == 1 and len(sets) <= n_sets
              and len(ops) == len(scans) + len(sets),
              '%s: one call issued %s' % (name, ops))
        print('profile %s at n = %d: %d device operations %s, device '
              '%.2f us; host %.2f us per call [%s]'
              % (name, n, len(ops), json.dumps(ops),
                 sum(o[1] for o in ops), h, card))
    phase('timing', t0)

    # -- 14. the captured dispatch: graphs against the eager A/B -----------
    t0 = time.perf_counter()

    def busy_ms(fn):
        """Device busy milliseconds of one fn() call: the union of the
        intervals of the device operations torch.profiler records (CUDA
        activity; CPU and CUDA where that saw none); None if it saw no
        device activity."""
        from torch.profiler import ProfilerActivity, profile
        for acts in ([ProfilerActivity.CUDA],
                     [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.cuda.synchronize()
            with profile(activities=acts) as prof:
                fn()
                torch.cuda.synchronize()
            iv = sorted((e.time_range.start, e.time_range.end)
                        for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA)
            if iv:
                total = 0
                lo, hi = iv[0]
                for a, b in iv[1:]:
                    if a > hi:
                        total += hi - lo
                        lo, hi = a, b
                    else:
                        hi = max(hi, b)
                return (total + hi - lo) / 1e3
        return None

    def dispatch_run(prg, flat, graphs, reps, sync_check):
        """One generator's renders: prepare, the first render (with
        graphs: capture + instantiate + replay), ``reps`` warm renders
        (their median), one profiled warm render's device busy time,
        peak and reserved memory, graph counts and launches; with
        ``sync_check`` one more warm render under
        torch.cuda.set_sync_debug_mode('error')."""
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # the generator's own: above what earlier phases still hold
        a0 = torch.cuda.memory_allocated()
        r0 = torch.cuda.memory_reserved()
        tp = time.perf_counter()
        gen = TorchGenerator(prg, SRATE, dev, flat=flat, graphs=graphs)
        gen.prepare()
        torch.cuda.synchronize()
        t_prep = time.perf_counter() - tp
        kernels.reset_launches()
        tf = time.perf_counter()
        pieces = gen.render_device()
        torch.cuda.synchronize()
        t_first = time.perf_counter() - tf
        n = dict(kernels.LAUNCHES)
        got = gen.assemble(pieces)
        del pieces
        peak = torch.cuda.max_memory_allocated() - a0
        reserved = torch.cuda.memory_reserved() - r0
        warm = []
        for _ in range(reps):
            tw = time.perf_counter()
            gen.render_device()
            torch.cuda.synchronize()
            warm.append(time.perf_counter() - tw)
        t_warm = sorted(warm)[len(warm) // 2]
        if sync_check:
            # a warm render makes no host sync (one would raise here)
            torch.cuda.set_sync_debug_mode('error')
            try:
                gen.render_device()
            finally:
                torch.cuda.set_sync_debug_mode('default')
            torch.cuda.synchronize()
        busy = busy_ms(gen.render_device)
        # on the flat path each self-PM stage launches its kernel once
        # per chunk
        want = {} if any(gen.sequential(ei)
                         for ei in range(len(gen.plan.epochs))) else {
            key: sum(seg.nch * sum(s.kind == kd for s in seg.ep.stages)
                     for ei in range(len(gen.plan.epochs))
                     for seg in gen._flat_epoch(ei))
            for kd, key in ((K_WRUN_SELF, 'wosc_selfmod'),
                            (K_RRUN_SELF, 'rasg_selfmod'))}
        rec = {'prepare_s': t_prep, 'first_s': t_first, 'warm_s': t_warm,
               'warm_runs_s': warm, 'busy_s': None if busy is None
               else busy / 1e3, 'peak_bytes': peak,
               'reserved_bytes': reserved, 'launches': n,
               'graphs': gen.graph_stats() if graphs else None}
        rec['busy_share'] = None if busy is None \
            else busy / 1e3 / t_warm
        del gen
        return got, rec, want

    # (golden entry, generator's flat=, warm renders): the renders that
    # the eager stage and block loops held host-bound, the two
    # device-bound self-PM renders, and the note sequence
    d_renders = [('pm_bank_1024', True, 3), ('selfmod_bank_1024', True, 1),
                 ('rasg_selfpm_10s', True, 3), ('pm_smoothchange', True, 5),
                 ('seq_flagship', False, 5), ('seq_bank_16', False, 5),
                 ('seq_selfmod_bank_16', False, 3), ('notes_seq', True, 5)]
    dispatch = {}
    # TorchGenerator's renders on the card, for phase 16
    engine_out = {}
    for name, flat, reps in d_renders:
        ent = hashes['entries'][name]
        prg = stt.compile_script(ent['script'])
        sync_check = name in ('pm_bank_1024', 'pm_smoothchange',
                              'seq_flagship')
        got, rg, want = dispatch_run(prg, flat, True, reps, sync_check)
        ref, re_, _ = dispatch_run(prg, flat, False, reps, sync_check)
        check(got.shape == (ent['frames'], 2) and np.any(got != 0),
              '%s: graph render shape or silence' % name)
        check(sha(got) == ent['sha256'],
              '%s: graph render != reference hash' % name)
        check(np.array_equal(got, ref),
              '%s: graph render != eager render (%d samples differ)'
              % (name, int((got != ref).sum())))
        check(rg['launches'] == re_['launches'],
              '%s: graph launches %s != eager %s'
              % (name, rg['launches'], re_['launches']))
        st = rg['graphs']
        # never exported: its own captures, not the store's
        check(st['source'] == 'baked' and st['captures'] > 0
              and st['replays'] > 0 and st['nodes'] > 0,
              '%s: graph counts %s' % (name, st))
        for key, w in want.items():
            check(rg['launches'][key] == w, '%s: %d launches of %s, '
                  'expected %d' % (name, rg['launches'][key], key, w))
        for k in launches:
            launches[k] += rg['launches'][k]
        dispatch[name] = {'graph': rg, 'eager': re_}
        engine_out[name] = got
        secs = ent['frames'] / SRATE

        def fmt(r):
            return ('first %.4f s (prepare %.4f s before it), warm %.4f s '
                    '(realtime factor %.3f), device busy %s s (share %s), '
                    'peak allocated %d bytes, reserved %d bytes (both '
                    'above the run\'s start)'
                    % (r['first_s'], r['prepare_s'], r['warm_s'],
                       secs / r['warm_s'],
                       'not measured' if r['busy_s'] is None
                       else '%.4f' % r['busy_s'],
                       'not measured' if r['busy_share'] is None
                       else '%.3f' % r['busy_share'],
                       r['peak_bytes'], r['reserved_bytes']))
        print('dispatch %s: = reference hash, graph = eager%s; graphs: %s; '
              'prepared render %s, %d graphs, %d captures (capture + '
              'instantiate %.4f s of the first render, the bodies\' '
              'Python %.4f s of it), %d replays, %d nodes; eager: %s; '
              'launches %s [%s]'
              % (name, ', a warm render of each makes no host sync'
                 if sync_check else '', fmt(rg), st['source'],
                 st['graphs'], st['captures'], st['capture_s'],
                 st['body_s'], st['replays'], st['nodes'], fmt(re_),
                 json.dumps({k: v for k, v in rg['launches'].items() if v},
                            sort_keys=True), card))
    replayed = dict(tgraphs.REPLAYED)
    print('launches made by graph replays, phases 4-14: %s'
          % json.dumps(replayed, sort_keys=True))
    for k in kernels.LAUNCHES:
        check(replayed.get(k, 0) > 0, '%s: never launched inside a graph'
              % k)
    print('dispatch ' + json.dumps({'card': card, 'renders': dispatch},
                                   sort_keys=True))
    phase('14 graphs', t0)

    # -- 15. voice-sharded rendering over a mesh --------------------------
    t0 = time.perf_counter()
    from saugns_tpu_torch import cli as tcli
    from saugns_tpu_torch.parallel.dryrun import dryrun_multichip
    from saugns_tpu_torch.parallel.meshrender import MeshRender
    from saugns_tpu_torch.parallel.scripts import ShardedRenderQueue
    from saugns_tpu_torch.parallel.sharding import Mesh
    from saugns_tpu_torch.parallel.voicebank import BankRender
    d0 = torch.device('cuda', 0)
    # (name, devices): two shards on the one card, and on two cards
    meshes = [('2 shards on cuda:0', [d0, d0])]
    if count >= 2:
        meshes.append(('cuda:0 + cuda:1', [d0, torch.device('cuda', 1)]))
    else:
        print('phase 15: one device, no two-GPU mesh')
    launches15 = {k: 0 for k in kernels.LAUNCHES}

    def mesh_run(fn):
        """fn() on the mesh path, its launches counted for the kernels
        line; returns (fn(), the launches)."""
        torch.cuda.synchronize()
        kernels.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        n = dict(kernels.LAUNCHES)
        for k in n:
            launches15[k] += n[k]
        return out, n

    def host16(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else x

    def engine16(src):
        g = TorchGenerator(stt.compile_script(src), SRATE, dev)
        return g.assemble(g.render_device())

    def engine_timed(src):
        """TorchGenerator's int16 render of ``src`` on the card, its
        first render (after prepare) and one warm render, in s."""
        g = TorchGenerator(stt.compile_script(src), SRATE, dev)
        g.prepare()
        torch.cuda.synchronize()
        tf = time.perf_counter()
        out = g.assemble(g.render_device())
        t_f = time.perf_counter() - tf
        tw = time.perf_counter()
        g.assemble(g.render_device())
        return out, t_f, time.perf_counter() - tw

    def bank_run(br, reps):
        """A BankRender's prepare, first render (captures + replays) and
        ``reps`` warm renders (their median), peak and reserved memory
        above the run's start, graph counts and launches."""
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        a0 = torch.cuda.memory_allocated()
        r0 = torch.cuda.memory_reserved()
        tp = time.perf_counter()
        br.prepare()
        torch.cuda.synchronize()
        t_prep = time.perf_counter() - tp
        tf = time.perf_counter()
        out, n = mesh_run(br.render_i16)
        t_first = time.perf_counter() - tf
        got = host16(out)
        warm = []
        for _ in range(reps):
            tw = time.perf_counter()
            br.render_i16()
            torch.cuda.synchronize()
            warm.append(time.perf_counter() - tw)
        rec = {'prepare_s': t_prep, 'first_s': t_first,
               'warm_s': sorted(warm)[len(warm) // 2], 'warm_runs_s': warm,
               'peak_bytes': torch.cuda.max_memory_allocated() - a0,
               'reserved_bytes': torch.cuda.memory_reserved() - r0,
               'graphs': br.graph_stats(), 'launches': n}
        return got, rec

    def fmt15(r):
        st = r['graphs']
        return ('prepare %.4f s, first %.4f s, warm %.4f s (realtime '
                'factor %.3f), %d captures, %d replays, %d nodes, peak '
                'allocated %d bytes, reserved %d bytes (above the run\'s '
                'start), launches %s'
                % (r['prepare_s'], r['first_s'], r['warm_s'],
                   1.0 / r['warm_s'], st['captures'], st['replays'],
                   st['nodes'], r['peak_bytes'], r['reserved_bytes'],
                   json.dumps({k: v for k, v in r['launches'].items()
                               if v}, sort_keys=True)))

    mesh15 = {}

    def slabs_of(br):
        """(slabs a shard, voices a slab) of a prepared BankRender."""
        sh = br.prepare()[0]
        return len(sh.slabs), sh.slabs[0].V

    def fmt_slabs(br):
        n_slabs, width = slabs_of(br)
        return '%d slabs of %d voices a shard' % (n_slabs, width)

    # the two 1024-voice banks through BankRender (one device; the ring
    # and psum over each mesh) and MeshRender, each against its hash,
    # beside TorchGenerator's phase-14 render of the bank
    for bname in ('pm_bank_1024', 'selfmod_bank_1024'):
        ent = hashes['entries'][bname]
        prg = stt.compile_script(ent['script'])
        tg = dispatch[bname]['graph']
        br = BankRender(prg, SRATE, device=d0)
        got, rec = bank_run(br, 3)
        check(sha(got) == ent['sha256'],
              'BankRender one device: %s != reference hash' % bname)
        rec['slabs'], rec['slab_width'] = slabs_of(br)
        if bname == 'selfmod_bank_1024':
            # kernel 5 once a slab: the slabs x the self-PM stages a
            # voice x the chunks of a segment
            seg = br.prepare()[0].slabs[0]
            want = rec['slabs'] * seg.nch * sum(
                s.kind == K_WRUN_SELF for s in seg.ep.stages)
            check(rec['launches']['wosc_selfmod'] == want,
                  'BankRender %s: %d launches of kernel 5, not %d'
                  % (bname, rec['launches']['wosc_selfmod'], want))
        mesh15[bname + ' one device'] = rec
        print('mesh BankRender %s one device: = reference hash; %s; %s; '
              'TorchGenerator (phase 14): first %.4f s, warm %.4f s, %d '
              'nodes, peak allocated %d bytes, launches %s [%s]'
              % (bname, fmt_slabs(br), fmt15(rec), tg['first_s'],
                 tg['warm_s'], tg['graphs']['nodes'], tg['peak_bytes'],
                 json.dumps({k: v for k, v in tg['launches'].items() if v},
                            sort_keys=True), card))
        del br, got
        for mname, devs in meshes:
            mesh = Mesh(devs, ('voices',))
            br = BankRender(prg, SRATE, mesh=mesh, mesh_mix='ring')
            ring, rec = bank_run(br, 3)
            check(sha(ring) == ent['sha256'], 'BankRender ring on %s: '
                  '%s != reference hash' % (mname, bname))
            rec['slabs'], rec['slab_width'] = slabs_of(br)
            mesh15['%s ring %s' % (bname, mname)] = rec
            print('mesh BankRender %s ring, %s: = reference hash; %s; %s '
                  '[%s]' % (bname, mname, fmt_slabs(br), fmt15(rec), card))
            br = BankRender(prg, SRATE, mesh=mesh)
            psum, rec = bank_run(br, 1)
            lsb = int(np.abs(psum.astype(np.int32) - ring).max())
            check(lsb <= 1, 'BankRender psum on %s: %s %d LSB from the '
                  'ring' % (mname, bname, lsb))
            rec['slabs'], rec['slab_width'] = slabs_of(br)
            mesh15['%s psum %s' % (bname, mname)] = rec
            print('mesh BankRender %s psum, %s: %d LSB at most from the '
                  'ring (%d samples differ); %s; %s [%s]'
                  % (bname, mname, lsb, int((psum != ring).sum()),
                     fmt_slabs(br), fmt15(rec), card))
            # the same bank through MeshRender: the renderer the player
            # and the CLI take for a multi-voice program on two or more
            # devices (each shard's voices one signature group, in
            # slabs)
            mr = MeshRender(prg, SRATE, mesh=mesh)
            mr_out, rec = bank_run(mr, 3)
            check(sha(mr_out) == ent['sha256'], 'MeshRender on %s: '
                  '%s != reference hash' % (mname, bname))
            rec['slab_widths'] = sorted(
                fs.V for _ep, segs in mr.epoch_segs for sg in segs
                for _d, _vs, fs in sg.slabs)
            mesh15['%s MeshRender %s' % (bname, mname)] = rec
            print('mesh MeshRender %s, %s: = reference hash; slabs of %s '
                  'voices; %s; TorchGenerator (phase 14): first %.4f s, '
                  'warm %.4f s [%s]'
                  % (bname, mname, rec['slab_widths'], fmt15(rec),
                     tg['first_s'], tg['warm_s'], card))
            del br, mr, mr_out, ring, psum
    for mname, devs in meshes:
        mesh = Mesh(devs, ('voices',))
        # the 16-voice self-PM bank and 13 voices, ring
        for name in ('selfmod_bank_16', 'bank_13'):
            e = hashes['entries'][name]
            br = BankRender(stt.compile_script(e['script']), SRATE,
                            mesh=mesh, mesh_mix='ring')
            tr = time.perf_counter()
            out, n = mesh_run(br.render_i16)
            t_r = time.perf_counter() - tr
            got = host16(out)
            check(sha(got) == e['sha256'], 'BankRender ring on %s: %s != '
                  'reference hash' % (mname, name))
            check(np.array_equal(got, engine16(e['script'])),
                  '%s on %s: != TorchGenerator' % (name, mname))
            print('mesh BankRender %s ring, %s: = reference hash = '
                  'TorchGenerator; %s; first render %.4f s, launches %s'
                  % (name, mname, fmt_slabs(br), t_r, json.dumps(
                      {k: v for k, v in n.items() if v}, sort_keys=True)))
        # heterogeneous programs through MeshRender: the golden entries,
        # and a program of varying-frequency wave, RasG and red noise
        # voices (kernels 2 and 3)
        k23 = ('Wsqr f80.r160[Wsin f2] t.2 a.3\n'
               'Rcos f80.r160[Wsin f2] t.2 a.3\n'
               'Nre t.2 a.2\n')
        for name, src in (('hetero3', None), ('hetero3_selfpm', None),
                          ('k23', k23)):
            e = hashes['entries'].get(name)
            src = e['script'] if e is not None else src
            mr = MeshRender(stt.compile_script(src), SRATE, mesh=mesh)
            mr.prepare()
            tr = time.perf_counter()
            got, n = mesh_run(mr.render_i16)
            t_r = time.perf_counter() - tr
            tw = time.perf_counter()
            mr.render_i16()
            t_w = time.perf_counter() - tw
            eng, te_f, te_w = engine_timed(src)
            tp = time.perf_counter()
            ref = MeshRender(stt.compile_script(src), SRATE, mesh=mesh,
                             plain=True).render_i16()
            t_p = time.perf_counter() - tp
            check(got.shape[0] > 0 and np.any(got != 0),
                  'MeshRender %s on %s: shape or silence' % (name, mname))
            check(e is None or sha(got) == e['sha256'],
                  'MeshRender %s on %s: != reference hash' % (name, mname))
            check(np.array_equal(got, eng),
                  'MeshRender %s on %s: != TorchGenerator' % (name, mname))
            check(np.array_equal(got, ref),
                  'MeshRender %s on %s: != the plain path' % (name, mname))
            if name == 'k23':
                check(n['scan_add_u32'] > 0 and n['scan_add_u64'] > 0,
                      'MeshRender k23: kernels 2 and 3 not launched')
            print('mesh MeshRender %s, %s: %s= TorchGenerator = the plain '
                  'path; first render %.4f s, warm %.4f s (TorchGenerator '
                  'first %.4f s, warm %.4f s), plain %.4f s, graphs %s, '
                  'launches %s [%s]'
                  % (name, mname, '= reference hash ' if e else '', t_r,
                     t_w, te_f, te_w, t_p, json.dumps(mr.graph_stats()),
                     json.dumps({k: v for k, v in n.items() if v},
                                sort_keys=True), card))
        # the multi-script queue: two programs, a worker thread a shard,
        # both capturing graphs; twice
        qsrc = [hashes['entries'][k]['script']
                for k in ('hetero3', 'bank_13')]
        serial = [engine16(s) for s in qsrc]
        for rep in range(2):
            def queued():
                q = ShardedRenderQueue([stt.compile_script(s)
                                        for s in qsrc], SRATE, True, devs)
                try:
                    return [q.generator(i).arr for i in range(len(qsrc))]
                finally:
                    q.close()
            tq = time.perf_counter()
            arrs, n = mesh_run(queued)
            t_q = time.perf_counter() - tq
            for i, (a, b) in enumerate(zip(arrs, serial)):
                check(np.array_equal(a, b), 'queue on %s: program %d != '
                      'its serial render' % (mname, i))
            print('mesh ShardedRenderQueue, %s, run %d: 2 programs = their '
                  'serial renders, %.4f s' % (mname, rep + 1, t_q))
        # a muted CLI run of a multi-voice program (the mesh generator)
        # and a one-voice program (a TorchGenerator): the player sums
        # both deferred checksums on one device
        with tempfile.TemporaryDirectory(prefix='.smoke-', dir=ROOT) as tmp:
            paths = []
            for fname, src in (('multi.sau', hashes['entries']['hetero3']
                                ['script']), ('one.sau', 'Wsin t.2\n')):
                paths.append(os.path.join(tmp, fname))
                with open(paths[-1], 'w') as f:
                    f.write(src)
            env_old = {k: os.environ.get(k) for k in
                       ('SAUGNS_TPU_TORCH_DEVICE', 'SAUGNS_TPU_MESH_DEBUG')}
            os.environ['SAUGNS_TPU_TORCH_DEVICE'] = ','.join(
                str(d) for d in devs)
            os.environ['SAUGNS_TPU_MESH_DEBUG'] = '1'
            err = io.StringIO()
            try:
                with contextlib.redirect_stderr(err):
                    rc, _ = mesh_run(lambda: tcli.main(
                        ['-m', '-r%d' % SRATE] + paths))
            finally:
                for k, v in env_old.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
            check(rc == 0, 'muted CLI on %s: exit %s (%s)'
                  % (mname, rc, err.getvalue()))
            check(err.getvalue().count('# mesh-render:') == 1,
                  'muted CLI on %s: the mesh generator not taken once: %r'
                  % (mname, err.getvalue()))
            print('mesh CLI -m, %s: a mesh and a one-device program, exit 0'
                  % mname)
        mesh_run(lambda: dryrun_multichip(devs))
    print('phase 15 launches: %s' % json.dumps(launches15, sort_keys=True))
    for k in ('wosc_fill', 'scan_add_u32', 'scan_add_u64', 'scan_max_i32',
              'wosc_selfmod', 'rasg_selfmod'):
        check(launches15[k] > 0, 'phase 15: %s not launched' % k)
    for k in launches:
        launches[k] += launches15[k]
    print('mesh ' + json.dumps({'card': card, 'renders': mesh15},
                               sort_keys=True))
    phase('15 mesh', t0)

    # -- 16. the time axis ------------------------------------------------
    t0 = time.perf_counter()
    time16 = time_axis(torch, np, kernels, tdsp, stt, TorchGenerator,
                       hashes, sha, card, dev, meshes, engine_out,
                       dispatch, piluts)
    for k in launches:
        launches[k] += time16[k]
    phase('16 time axis', t0)

    # -- 17. the compiled-render store --------------------------------------
    t0 = time.perf_counter()
    store17 = compiled_store(torch, kernels, stt, TorchGenerator, hashes,
                             sha, card, dev)
    for k in launches:
        launches[k] += store17[k]
    phase('17 store', t0)
    # the kernels line counts the launches of phases 4-17
    for k in kern:
        k['launches'] = launches[k['name']]
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
