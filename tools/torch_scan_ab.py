#!/usr/bin/env python3
"""Time the port's scan kernels (2, 3 and 4), its tap gather (kernel 8),
its self-PM kernels (5 and 6), its oscillator fill (kernel 1), its
float64 Is gather (kernel 9) and its forward fill (kernel 10) of one or
more checkouts, each checkout in its own process, on one CUDA card.

    python3 tools/torch_scan_ab.py ROOT [ROOT ...]

Each ROOT is the root of a checkout that holds ``saugns_tpu_torch/``.
The checkouts run in the order given; for an A/B comparison of two
commits on one card, give parent, change, change, parent. Each run
prints one JSON line: its root, the card's name and power limit, and
for each kernel and size three timings of the wrapper (mean
milliseconds per call by CUDA events over a back-to-back loop) beside
the library call on the same inputs (``torch.cumsum``, masked for
kernel 2; ``torch.cummax``; for kernel 8, ``torch.take`` of the
precomputed (4, N) tap index, on int64 cells as the main path gives
them; none for kernels 5 and 6). Kernels 5 and 6 run one all-active
row (int64 phases and cycles as the callers hold them; kernel 6 in the
fixed / level 27 / cos mode of the 10 s RasG self-PM script), at 4,096
samples and at the main path's largest row, so that the slope between
the two is the chain's time per sample. Kernel 1 runs one row of
audio-rate phases with pd == 0 runs and a pending reset, kernel 9 int64
phases, both in the dtypes the callers hold. Kernel 10 (the forward
fill, ``ffill``) runs rows with runs of invalid positions without
lengths, and ``forward_fill_valid`` the sequential engine's whole
pd == 0 hold on the same rows with lengths (one kernel 10 call since
it took the lengths; before, eager ops around it). No library call
computes any of these. At each kernel's first size the entry also holds
``host_us``: the wrapper's mean host microseconds a call, enqueue only
(a loop of calls with no synchronise inside), three times. Inputs come
from a fixed numpy seed.
Imports neither JAX nor the JAX package.
"""
import functools
import json
import os
import subprocess
import sys

# (kernel, sizes): the main path's largest shapes (chip_smoke.py's
# kernels line) and 2^22
SIZES = {'scan_add_u32': (131072, 1 << 22), 'scan_max_i32': (2, 1 << 22),
         'scan_add_u64': (38912, 1 << 22),
         'gather_taps': (1 << 20, 1 << 22),
         'wosc_selfmod': (4096, 131072), 'rasg_selfmod': (4096, 1 << 20),
         'wosc_fill': (131072, 1 << 22), 'is64': (65536, 1 << 22),
         'ffill': ((16, 65536), (4, 1 << 20)),
         'forward_fill_valid': ((16, 65536), (4, 1 << 20))}
REPEATS = 3


def time_ms(torch, fn, reps):
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


def host_us(torch, fn, reps):
    """Mean host microseconds of one fn() call, enqueue only."""
    import time
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t
    torch.cuda.synchronize()
    return 1e6 * t / reps


def _host(torch, fn, n, sizes):
    """host_us three times at a kernel's first size, else None."""
    if n != sizes[0]:
        return None
    return [host_us(torch, fn, 200) for _ in range(REPEATS)]


def _selfmod_call(np, torch, kernels, rng, dev, name, n):
    """(call, None): kernel 5 or 6 on one all-active row of n samples."""
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    am = t(rng.uniform(-1.5, 1.5, (1, n)).astype(np.float32))
    act = torch.ones((1, n), dtype=torch.bool, device=dev)
    ps0 = t(rng.uniform(-1, 1, 1).astype(np.float32))
    fb0 = t(rng.uniform(-1, 1, 1).astype(np.float32))
    if name == 'wosc_selfmod':
        inc = rng.randint(1 << 16, 1 << 26, (1, n)).astype(np.int64)
        ph = t((rng.randint(0, 1 << 32) + np.cumsum(inc, 1)) & 0xffffffff)
        pp0 = t(rng.randint(0, 1 << 32, 1).astype(np.int64))
        pil = t(rng.uniform(-1, 1, 2048).astype(np.float32))
        return (lambda: kernels.wosc_selfmod(pil, 0, ph, am, act, pp0,
                                             ps0, fb0)), None
    phase = t(rng.uniform(0, 1, (1, n)).astype(np.float32))
    cycle = t(rng.randint(0, 1 << 32, (1, n)).astype(np.int64))
    # the 10 s RasG self-PM script's mode: fixed function, cos line,
    # level 27 (bench.py:87)
    return (lambda: kernels.rasg_selfmod(4, 0, 27, 0x9e3779b9, 192, phase,
                                         cycle, am, act, ps0, fb0)), None


def _fill_args(np, torch, rng, dev, pilut, n):
    """Kernel 1's arguments for one row of n samples: audio-rate phase
    steps with pd == 0 runs, a pending reset at a random index."""
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    inc = rng.randint(1 << 16, 1 << 26, n).astype(np.int64)
    for _ in range(8):
        a = rng.randint(0, n)
        inc[a:a + rng.randint(1, 600)] = 0
    pp = rng.randint(0, 1 << 32, 1).astype(np.int64)
    ph = (pp + np.cumsum(inc)) & 0xffffffff
    fi = rng.randint(0, n, 1).astype(np.int64)
    rph = (ph[fi] - (1 << 21)) & 0xffffffff
    return (pilut, 0, t(ph[None]), t(pp),
            t(rng.uniform(-1, 1, 1).astype(np.float32)), t(fi),
            t(np.ones(1, bool)), t(rph))


def _ffill_args(np, torch, rng, dev, V, L):
    """Kernel 10's rows (s, valid, seed) and lengths: runs of invalid
    positions, an invalid head; every length L (a full block) but row
    1's, L // 2 + 3 (a note ending mid-block)."""
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    valid = np.ones((V, L), bool)
    for r in range(V):
        for _ in range(8):
            a = rng.randint(0, L)
            valid[r, a:a + rng.randint(1, 3000)] = False
    valid[0, :7] = False
    length = np.full(V, L, np.int64)
    length[1 % V] = L // 2 + 3
    return (t(rng.uniform(-1, 1, (V, L)).astype(np.float32)), t(valid),
            t(rng.uniform(-1, 1, V).astype(np.float32)), t(length))


def one(root):
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('torch_scan_ab: no CUDA device')
    sys.path.insert(0, root)
    from saugns_tpu_torch import kernels
    from saugns_tpu_torch.render import tdsp
    kernels.build()
    dev = torch.device('cuda')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    rng = np.random.RandomState(7)
    pilut = torch.from_numpy(rng.uniform(-1, 1, 2048).astype(np.float32)
                             ).to(dev)
    out = {'root': root, 'card': card, 'times': []}
    for name, sizes in SIZES.items():
        for n in sizes:
            if name in ('ffill', 'forward_fill_valid'):
                args = _ffill_args(np, torch, rng, dev, *n)
                f = functools.partial(kernels.ffill, *args[:3]) \
                    if name == 'ffill' \
                    else functools.partial(tdsp.forward_fill_valid, *args)
                reps = 200 if n[0] * n[1] < (1 << 20) else 50
                out['times'].append({
                    'kernel': name, 'n': n,
                    'ms': [time_ms(torch, f, reps) for _ in range(REPEATS)],
                    'library_ms': None, 'host_us': _host(torch, f, n, sizes)})
                continue
            fn = getattr(kernels, name)
            if name in ('wosc_fill', 'is64'):
                if name == 'wosc_fill':
                    args = _fill_args(np, torch, rng, dev, pilut, n)
                else:
                    args = (pilut, torch.from_numpy(rng.randint(
                        0, 1 << 32, n, dtype=np.int64)).to(dev))
                reps = 200 if n < (1 << 20) else 50
                f = functools.partial(fn, *args)
                out['times'].append({
                    'kernel': name, 'n': n,
                    'ms': [time_ms(torch, f, reps) for _ in range(REPEATS)],
                    'library_ms': None, 'host_us': _host(torch, f, n, sizes)})
                continue
            if name in ('wosc_selfmod', 'rasg_selfmod'):
                fn, lib = _selfmod_call(np, torch, kernels, rng, dev, name,
                                        n)
                x = None
            elif name == 'gather_taps':
                x = torch.from_numpy(rng.randint(0, 1 << 32, n,
                                                 dtype=np.int64)).to(dev)
                x = x >> 21          # the cells of u32 phases
                idx = (x[None, :] + torch.arange(-1, 3, device=dev)[:, None]
                       ) & 2047
                lib = lambda: torch.take(pilut, idx)  # noqa: E731
                fn = functools.partial(fn, pilut)
            elif name == 'scan_max_i32':
                x = torch.from_numpy(rng.randint(0, 1 << 31, n)
                                     .astype(np.int32)).to(dev)
                lib = lambda: torch.cummax(x, 0)  # noqa: E731
            elif name == 'scan_add_u32':
                x = torch.from_numpy(rng.randint(0, 1 << 32, n,
                                                 dtype=np.int64)).to(dev)
                lib = lambda: torch.cumsum(x, 0) & 0xffffffff  # noqa: E731
            else:
                x = torch.from_numpy(rng.randint(-(1 << 63), (1 << 63) - 1,
                                                 n, dtype=np.int64)).to(dev)
                lib = lambda: torch.cumsum(x, 0)  # noqa: E731
            reps = 200 if n < (1 << 20) else 50
            if x is None:       # kernels 5 and 6: milliseconds a call
                reps = 20 if n <= 4096 else 3
            else:
                fn = functools.partial(fn, x)
            out['times'].append({
                'kernel': name, 'n': n,
                'ms': [time_ms(torch, fn, reps) for _ in range(REPEATS)],
                'library_ms': None if lib is None else
                [time_ms(torch, lib, reps) for _ in range(REPEATS)],
                'host_us': _host(torch, fn, n, sizes)})
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
                            '--one', os.path.abspath(root)], timeout=600)
        if r.returncode != 0:
            return r.returncode
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
