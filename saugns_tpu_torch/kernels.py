"""Build, bindings and launch counts of the hand-written CUDA kernels.

The sources under ``csrc/`` are plain CUDA C++ with a C interface (no
PyTorch header). At the first launch each is compiled by its own
``nvcc``, all at once, and the objects are linked into one shared
library under ``_build/`` (listed in .gitignore), keyed by a hash of
the sources and flags, and loaded with ``ctypes``.
Nothing is built at import time.

Each wrapper takes CUDA tensors only: it checks them, launches its
kernel on PyTorch's current stream of the tensors' device with that
device current (a tensor on ``cuda:1`` launches there whatever device
the caller has current), raises if the launch fails, and counts the
launch in ``LAUNCHES``. The plain PyTorch versions live beside the
callers in ``render/tdsp.py``.

The build, the counts and the captures are safe under threads: one
lock serialises the build, one the counts, and the launches made while
a thread captures a graph go to that thread's capture (``capturing``),
not to ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

import numpy as np
import torch

from .dsp import wavetables as W
from .native import BUILD_DIR

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'csrc')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-fmad=false', '-Xcompiler', '-fPIC')

# launches of each kernel since the last reset_launches()
LAUNCHES = {'wosc_fill': 0, 'scan_add_u32': 0, 'scan_add_u64': 0,
            'wosc_selfmod': 0, 'rasg_selfmod': 0, 'gather_taps': 0,
            'is64': 0, 'ffill': 0, 'scan_max_i32': 0, 'rasg_fill': 0}

# elements per tile of the look-back scans (LB_TILE of
# csrc/scan_lookback.cuh, checked when the library loads)
SCAN_TILE = 4096
# positions per tile of kernels 1 and 10 (WF_TILE of csrc/wosc_fill.cu
# and FF_TILE of csrc/ffill.cu, checked when the library loads)
FILL_TILE = 2048

# seconds from the start of the build to the end of each source's nvcc
# (filled by the build that compiles, empty when the library was cached)
BUILD_SECONDS = {}

_lib = None
_build_lock = threading.Lock()
_count_lock = threading.Lock()


class _Local(threading.local):
    sink = None     # the calling thread's capture (see capturing)


_tls = _Local()


def reset_launches():
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def count(name, n=1):
    """Count ``n`` launches of kernel ``name``: in the calling thread's
    capture while it captures a graph (see capturing), else in
    LAUNCHES."""
    sink = _tls.sink
    if sink is not None:
        sink[name] = sink.get(name, 0) + n
        return
    with _count_lock:
        LAUNCHES[name] += n


class capturing:
    """``with capturing() as launches:`` -- the launches that the
    calling thread makes inside the block go to the dict ``launches``
    and not to LAUNCHES (a graph's launches count at its replays)."""

    def __enter__(self):
        self.prev = _tls.sink
        _tls.sink = {}
        return _tls.sink

    def __exit__(self, *exc):
        _tls.sink = self.prev


def _nvcc():
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the CUDA kernels of '
                           'saugns_tpu_torch cannot be built')
    return path


def _compile(srcs, so):
    """One nvcc per source, all started together, then one link. Each
    source's build seconds go to BUILD_SECONDS."""
    nvcc = _nvcc()
    tmp = '%s.%d.tmp' % (so, os.getpid())
    objs = ['%s.%s.o' % (tmp, os.path.basename(src)) for src in srcs]
    logs = [obj + '.log' for obj in objs]
    t0 = time.perf_counter()
    procs = []
    for src, obj, log in zip(srcs, objs, logs):
        with open(log, 'w') as f:
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, '-c', '-o', obj, src], stdout=f,
                stderr=subprocess.STDOUT))
    fails = []
    pending = list(zip(srcs, procs, logs))
    while pending:
        for item in list(pending):
            src, p, log = item
            if p.poll() is None:
                continue
            BUILD_SECONDS[os.path.basename(src)] = time.perf_counter() - t0
            pending.remove(item)
            if p.returncode != 0:
                with open(log) as f:
                    fails.append('%s (%d):\n%s' % (src, p.returncode,
                                                   f.read()))
        time.sleep(0.02)
    if not fails:
        r = subprocess.run([nvcc, '-shared', '-o', tmp, *objs],
                           stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
        if r.returncode != 0:
            fails.append('link (%d):\n%s' % (r.returncode, r.stdout))
    for path in objs + logs:
        if os.path.exists(path):
            os.remove(path)
    if fails:
        raise RuntimeError('nvcc failed: ' + '\n'.join(fails))
    os.replace(tmp, so)


def build():
    """Compile (once per source hash) and load the kernel library;
    returns its path. Threads that call it together build it once."""
    if _lib is not None:
        return _lib._name
    with _build_lock:
        return _build()


def _build():
    global _lib
    if _lib is not None:
        return _lib._name
    srcs = sorted(glob.glob(os.path.join(CSRC, '*.cu')))
    deps = srcs + sorted(glob.glob(os.path.join(CSRC, '*.cuh')))
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for p in deps:
        with open(p, 'rb') as f:
            h.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, 'kernels_%s.so' % h.hexdigest()[:16])
    if not os.path.exists(so):
        _compile(srcs, so)
    lib = ctypes.CDLL(so)
    vp, ll, ci, cf = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_float)
    lib.saugns_scan_add_u32.argtypes = [vp, vp, vp, ll, ll, vp]
    lib.saugns_scan_add_u32.restype = ci
    lib.saugns_wosc_fill_tile.argtypes = []
    lib.saugns_wosc_fill_tile.restype = ci
    lib.saugns_wosc_fill.argtypes = [vp] * 7 + [cf, cf, vp, vp, ll, ci,
                                                vp]
    lib.saugns_wosc_fill.restype = ci
    lib.saugns_scan_add_u64.argtypes = [vp, vp, vp, ll, ll, vp]
    lib.saugns_scan_add_u64.restype = ci
    lib.saugns_wosc_selfmod.argtypes = [vp] * 7 + [cf, cf] + [vp] * 4 \
        + [ll, ci, vp]
    lib.saugns_wosc_selfmod.restype = ci
    lib.saugns_rasg_selfmod.argtypes = [vp] * 6 + [ci, ci, ci,
                                                   ctypes.c_uint, ci] \
        + [vp] * 3 + [ll, ci, vp]
    lib.saugns_rasg_selfmod.restype = ci
    lib.saugns_rasg_fill.argtypes = [vp, cf] + [vp] * 5 + [
        ci, ci, ci, ctypes.c_uint, ci, vp, ll, ll, ci, vp]
    lib.saugns_rasg_fill.restype = ci
    lib.saugns_gather_taps.argtypes = [vp, ci, vp, vp, ll, vp]
    lib.saugns_gather_taps.restype = ci
    lib.saugns_is64.argtypes = [vp, vp, vp, ll, vp]
    lib.saugns_is64.restype = ci
    lib.saugns_ffill_tile.argtypes = []
    lib.saugns_ffill_tile.restype = ci
    lib.saugns_ffill.argtypes = [vp] * 6 + [ll, ci, vp]
    lib.saugns_ffill.restype = ci
    lib.saugns_scan_max_i32.argtypes = [vp, vp, vp, ll, ll, vp]
    lib.saugns_scan_max_i32.restype = ci
    lib.saugns_lookback_tile.argtypes = []
    lib.saugns_lookback_tile.restype = ci
    if lib.saugns_lookback_tile() != SCAN_TILE:
        raise RuntimeError('kernels: LB_TILE %d != SCAN_TILE %d'
                           % (lib.saugns_lookback_tile(), SCAN_TILE))
    for fn, what in ((lib.saugns_wosc_fill_tile, 'WF_TILE'),
                     (lib.saugns_ffill_tile, 'FF_TILE')):
        if fn() != FILL_TILE:
            raise RuntimeError('kernels: %s %d != FILL_TILE %d'
                               % (what, fn(), FILL_TILE))
    _lib = lib
    return so


def _check(rc, name):
    if rc != 0:
        raise RuntimeError('%s: CUDA launch failed with cudaError_t %d'
                           % (name, rc))


def _launch(name, t, fn, *args):
    """fn(*args, stream) with ``t``'s device current and the raw
    cudaStream_t of PyTorch's current stream there (the private call
    Triton's launcher also makes: it skips building a
    torch.cuda.Stream, a few microseconds a launch); raises if the
    launch failed, then counts it. The C launchers launch on the
    current device and keep their per-device attributes by it."""
    dev = t.get_device()
    prev = torch.cuda.current_device()
    if dev != prev:
        torch.cuda.set_device(dev)
    try:
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    finally:
        if dev != prev:
            torch.cuda.set_device(prev)
    _check(rc, name)
    count(name)


def _with_scratch(shape, dtype, device, words):
    """A contiguous output of ``shape`` and the address of ``words``
    64-bit scratch words behind it, from the first 8-byte word past it,
    in one allocation (None for no words). The output is the allocation
    shrunk to ``shape`` in place (``resize_``: no copy, and no view to
    build, which costs more host time)."""
    if not words:
        return torch.empty(shape, dtype=dtype, device=device), None
    n = 1
    for d in shape:
        n *= d
    es = dtype.itemsize
    w = -(-n * es // 8)
    buf = torch.empty((w + words) * 8 // es, dtype=dtype, device=device)
    return buf.resize_(shape), buf.data_ptr() + 8 * w


def _scan_out(x, pair=False):
    """Output of a look-back scan (kernels 2, 3 and 4) of the
    contiguous 1-D ``x`` or (V, L) rows ``x``, and the address of its
    scratch: none for one tile a row; above, the tile counter, then per
    tile one 64-bit status word (kernels 2 and 4), or with ``pair``
    (kernel 3, a 64-bit payload) two, cleared by the launcher (see
    _with_scratch)."""
    L = x.shape[-1]
    rows = x.numel() // L
    tpr = -(-L // SCAN_TILE)
    tiles = rows * tpr
    words = 0 if tpr == 1 else 1 + (2 * tiles if pair else tiles)
    return _with_scratch(tuple(x.shape), x.dtype, x.device, words)


def _scan(name, x, dtype, pair=False):
    """Launch look-back scan ``name`` on the 1-D ``x`` or on each row of
    the (V, L) ``x``, in one launch; returns its output, shaped as x."""
    _need_cuda(name, x)
    if x.dim() not in (1, 2) or x.dtype != dtype or x.numel() < 1:
        raise ValueError('%s: expects a non-empty 1-D %s tensor or '
                         '(V, L) rows'
                         % (name, str(dtype).replace('torch.', '')))
    build()
    if not x.is_contiguous():
        x = x.contiguous()
    y, scratch = _scan_out(x, pair)
    L = x.shape[-1]
    _launch(name, x, getattr(_lib, 'saugns_' + name), x.data_ptr(),
            y.data_ptr(), scratch, L, x.numel() // L)
    return y


def _f32(t):
    return t.to(torch.float32).contiguous()


def _pilut(name, pilut):
    """The wave's PILUT, checked: (2048,) float32, contiguous."""
    if pilut.shape != (W.LEN,) or pilut.dtype != torch.float32:
        raise ValueError('%s: pilut must be (%d,) float32' % (name, W.LEN))
    return pilut.contiguous()


def _need_cuda(name, *ts):
    for t in ts:
        if not t.is_cuda:
            raise ValueError('%s: expects CUDA tensors' % name)
    d = ts[0].get_device()
    for t in ts[1:]:
        if t.get_device() != d:
            raise ValueError('%s: tensors on different devices' % name)


def scan_add_u32(x):
    """Kernel 2: inclusive prefix sum of a 1-D int64 tensor of u32
    values, wrapping mod 2^32; returns int64 in [0, 2^32). Only the low
    32 bits of each input count (x & 0xffffffff): the kernel reads the
    int64 values and writes int64, with no conversion pass. A (V, L)
    tensor is V rows, each scanned on its own, in one launch."""
    return _scan('scan_add_u32', x, torch.int64)


def wosc_fill(pilut, wave, ph, pp, ps, first_ir, do_rst, rst_prev):
    """Kernel 1: filled oscillator output (V, L) float32 of u32 phase
    rows ``ph`` (V, L) int64, with (V,) seeds -- see
    tdsp.wosc_s_filled_plain for the semantics. The kernel reads the
    tensors as the callers hold them, with no conversion pass: ``ph``,
    ``pp`` and ``rst_prev`` int64 (only the low 32 bits count),
    ``first_ir`` int64, ``do_rst`` bool and ``ps`` float32; other dtypes
    raise ValueError. One call is one launch, and one memset where a
    row spans more than one tile."""
    name = 'wosc_fill'
    if ph.dim() != 2 or ph.dtype != torch.int64:
        raise ValueError('%s: ph must be (V, L) int64' % name)
    V, L = ph.shape
    if V < 1 or L < 1:
        raise ValueError('%s: empty phase rows' % name)
    _shape(name, (V,), pp, ps, first_ir, do_rst, rst_prev)
    for what, t, dt in (('pp', pp, torch.int64), ('ps', ps, torch.float32),
                        ('first_ir', first_ir, torch.int64),
                        ('do_rst', do_rst, torch.bool),
                        ('rst_prev', rst_prev, torch.int64)):
        if t.dtype != dt:
            raise ValueError('%s: %s must be %s, got %s'
                             % (name, what, dt, t.dtype))
    _need_cuda(name, ph, pilut, pp, ps, first_ir, do_rst, rst_prev)
    tab = _pilut(name, pilut)
    build()
    ph = ph.contiguous()
    tiles = -(-L // FILL_TILE)
    out, scratch = _with_scratch((V, L), torch.float32, ph.device,
                                 0 if tiles == 1 else 1 + V * tiles)
    args = (ph, pp.contiguous(), ps.contiguous(), first_ir.contiguous(),
            do_rst.contiguous(), rst_prev.contiguous(), tab)
    _launch(name, ph, _lib.saugns_wosc_fill,
            *(a.data_ptr() for a in args),
            float(np.float32(W.dvscale(wave))),
            float(np.float32(W.dvoffset(wave))), out.data_ptr(), scratch,
            L, V)
    return out


def scan_add_u64(x):
    """Kernel 3: inclusive prefix sum of a 1-D int64 tensor read as
    u64 bits, wrapping mod 2^64; returns int64 bits. A (V, L) tensor is
    V rows, each scanned on its own, in one launch."""
    return _scan('scan_add_u64', x, torch.int64, pair=True)


def _shape(name, shape, *ts):
    for t in ts:
        if tuple(t.shape) != shape:
            raise ValueError('%s: expects shape %s, got %s'
                             % (name, shape, tuple(t.shape)))


def wosc_selfmod(pilut, wave, ph, am, act, pp0, ps0, fb0):
    """Kernel 5: wosc self-PM over (V, L) rows -- see
    tdsp.wosc_selfmod_plain. Returns (out (V, L) float32, pp (int64, u32
    values), ps, fb). The kernel reads the int64 phases and seed phases
    as the callers hold them (only the low 32 bits count) and writes pp
    as int64: no conversion pass."""
    name = 'wosc_selfmod'
    _need_cuda(name, ph, am, act, pp0, ps0, fb0, pilut)
    if ph.dim() != 2 or ph.dtype != torch.int64 or ph.numel() < 1:
        raise ValueError('%s: ph must be non-empty (V, L) int64' % name)
    V, L = ph.shape
    _shape(name, (V, L), am, act)
    _shape(name, (V,), pp0, ps0, fb0)
    tab = _pilut(name, pilut)
    build()
    dev = ph.device
    out = torch.empty((V, L), dtype=torch.float32, device=dev)
    pp = torch.empty(V, dtype=torch.int64, device=dev)
    ps = torch.empty(V, dtype=torch.float32, device=dev)
    fb = torch.empty(V, dtype=torch.float32, device=dev)
    args = (ph.contiguous(), _f32(am), act.to(torch.bool).contiguous(),
            pp0.to(torch.int64).contiguous(), _f32(ps0), _f32(fb0), tab)
    _launch(name, ph, _lib.saugns_wosc_selfmod,
            *(a.data_ptr() for a in args),
            float(np.float32(W.dvscale(wave))),
            float(np.float32(W.dvoffset(wave))), out.data_ptr(),
            pp.data_ptr(), ps.data_ptr(), fb.data_ptr(), L, V)
    return out, pp, ps, fb


def rasg_selfmod(func, line, level, alpha, oflags, phase, cycle, am, act,
                 ps0, fb0):
    """Kernel 6: RasG self-PM over (V, L) rows -- see
    tdsp.rasg_selfmod_plain. Returns (out (V, L) float32, ps, fb). The
    kernel reads the int64 cycles as the callers hold them (only the low
    32 bits count): no conversion pass."""
    name = 'rasg_selfmod'
    _need_cuda(name, phase, cycle, am, act, ps0, fb0)
    if phase.dim() != 2 or phase.numel() < 1:
        raise ValueError('%s: phase must be non-empty (V, L)' % name)
    V, L = phase.shape
    _shape(name, (V, L), cycle, am, act)
    _shape(name, (V,), ps0, fb0)
    build()
    dev = phase.device
    out = torch.empty((V, L), dtype=torch.float32, device=dev)
    ps = torch.empty(V, dtype=torch.float32, device=dev)
    fb = torch.empty(V, dtype=torch.float32, device=dev)
    args = (_f32(phase), cycle.to(torch.int64).contiguous(), _f32(am),
            act.to(torch.bool).contiguous(), _f32(ps0), _f32(fb0))
    _launch(name, phase, _lib.saugns_rasg_selfmod,
            *(a.data_ptr() for a in args), int(func), int(line),
            int(level), int(alpha) & 0xffffffff, int(oflags),
            out.data_ptr(), ps.data_ptr(), fb.data_ptr(), L, V)
    return out, ps, fb


def rasg_fill(func, line, level, alpha, oflags, base, B, pofs=None,
              pscale=2.0 ** 31, inc=None, ln=None, csum=None, incs=None):
    """Kernel 11: the RasG cyclor and run over rows of B samples -- see
    tdsp.rasg_fill_plain. ``base`` (*rows) int64; either ``inc``, ``ln``
    (*rows) int64 or ``csum``, ``incs`` (*rows, B) int64; ``pofs``
    (*rows, B) float32 or None. Returns (*rows, B) float32. The kernel
    reads the tensors as the callers hold them: other dtypes or shapes
    raise ValueError. One call is one launch."""
    name = 'rasg_fill'
    rows = tuple(base.shape)
    full = rows + (int(B),)
    if B < 1 or base.numel() < 1:
        raise ValueError('%s: empty rows' % name)
    given = tuple(t is not None for t in (inc, ln, csum, incs))
    if given not in ((True, True, False, False), (False, False, True, True)):
        raise ValueError('%s: give inc and ln, or csum and incs' % name)
    for what, t, shape, dtype in (
            ('base', base, rows, torch.int64),
            ('inc', inc, rows, torch.int64), ('ln', ln, rows, torch.int64),
            ('csum', csum, full, torch.int64),
            ('incs', incs, full, torch.int64),
            ('pofs', pofs, full, torch.float32)):
        if t is None:
            continue
        if t.dtype != dtype:
            raise ValueError('%s: %s must be %s, got %s'
                             % (name, what, dtype, t.dtype))
        _shape(name, shape, t)
    args = [None if t is None else t.contiguous()
            for t in (pofs, csum, incs, inc, ln, base)]
    _need_cuda(name, *(t for t in args if t is not None))
    build()
    out = torch.empty(full, dtype=torch.float32, device=base.device)
    # 16-byte accesses: B a multiple of 4, the (rows, B) buffers aligned
    vec = B % 4 == 0 and all(t is None or t.data_ptr() % 16 == 0
                             for t in args[:3] + [out])
    ptrs = [None if t is None else t.data_ptr() for t in args]
    _launch(name, base, _lib.saugns_rasg_fill, ptrs[0],
            float(np.float32(pscale)), *ptrs[1:], int(func), int(line),
            int(level), int(alpha) & 0xffffffff, int(oflags),
            out.data_ptr(), int(B), base.numel(), int(vec))
    return out


def gather_taps(pilut, cells):
    """Kernels 7 and 8: Hermite taps (4, N) float32 of a 1-D tensor of
    N cell indices (any integer dtype) -- see tdsp.gather_taps_plain.
    The kernel reads int64 and int32 cells as they are; other integer
    dtypes (no caller on the main path) are widened to int32 first."""
    name = 'gather_taps'
    _need_cuda(name, cells, pilut)
    if cells.dim() != 1 or cells.numel() < 1 \
            or cells.dtype.is_floating_point:
        raise ValueError('%s: cells must be a non-empty 1-D integer '
                         'tensor' % name)
    tab = _pilut(name, pilut)
    build()
    if cells.dtype not in (torch.int64, torch.int32):
        cells = cells.to(torch.int32)
    if not cells.is_contiguous():
        cells = cells.contiguous()
    n = cells.numel()
    out = cells.new_empty((4, n), dtype=torch.float32)
    _launch(name, cells, _lib.saugns_gather_taps, cells.data_ptr(),
            cells.element_size(), tab.data_ptr(), out.data_ptr(), n)
    return out


def is64(pilut, ph):
    """Kernel 9: Is(phase) (N,) float64 of a 1-D int64 tensor of u32
    phases -- see tdsp.is64_plain. The kernel reads the int64 phases as
    the callers hold them (only the low 32 bits count): one call is one
    launch, with no conversion pass."""
    name = 'is64'
    if ph.dim() != 1 or ph.dtype != torch.int64 or ph.numel() < 1:
        raise ValueError('%s: ph must be a non-empty 1-D int64 tensor'
                         % name)
    _need_cuda(name, ph, pilut)
    tab = _pilut(name, pilut)
    build()
    if not ph.is_contiguous():
        ph = ph.contiguous()
    n = ph.numel()
    out = torch.empty(n, dtype=torch.float64, device=ph.device)
    _launch(name, ph, _lib.saugns_is64, ph.data_ptr(), tab.data_ptr(),
            out.data_ptr(), n)
    return out


def ffill(s, valid, seed, length=None):
    """Kernel 10: the forward fill (n, L) float32 of rows ``s`` by the
    bool mask ``valid`` (n, L) with (n,) float32 seeds -- see
    tdsp.last_valid_fill; with the (n,) int64 ``length`` of the
    sequential engine's rows it is the whole pd == 0 hold, see
    tdsp.forward_fill_valid_plain. The kernel reads the tensors as the
    callers hold them: other dtypes raise ValueError. One call is one
    launch, and one memset where a row spans more than one tile."""
    name = 'ffill'
    if s.dim() != 2 or s.dtype != torch.float32 or s.numel() < 1:
        raise ValueError('%s: s must be non-empty (n, L) float32' % name)
    n, L = s.shape
    if L >= 1 << 30:
        raise ValueError('%s: rows of 2^30 or more positions' % name)
    _shape(name, (n, L), valid)
    rows = (seed,) if length is None else (seed, length)
    _shape(name, (n,), *rows)
    for what, t, dt in (('valid', valid, torch.bool),
                        ('seed', seed, torch.float32),
                        ('length', length, torch.int64)):
        if t is not None and t.dtype != dt:
            raise ValueError('%s: %s must be %s, got %s'
                             % (name, what, dt, t.dtype))
    _need_cuda(name, s, valid, *rows)
    build()
    s = s.contiguous()
    tiles = -(-L // FILL_TILE)
    out, scratch = _with_scratch((n, L), torch.float32, s.device,
                                 0 if tiles == 1 else 1 + n * tiles)
    _launch(name, s, _lib.saugns_ffill, s.data_ptr(),
            valid.contiguous().data_ptr(), seed.contiguous().data_ptr(),
            None if length is None else length.contiguous().data_ptr(),
            out.data_ptr(), scratch, L, n)
    return out


def scan_max_i32(x):
    """Kernel 4: inclusive running max of a 1-D int32 tensor with
    identity 0 (max(0, x[0], ..., x[i])); returns int32. A (V, L)
    tensor is V rows, each scanned on its own, in one launch."""
    return _scan('scan_max_i32', x, torch.int32)
