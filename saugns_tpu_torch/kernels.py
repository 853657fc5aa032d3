"""Build, bindings and launch counts of the hand-written CUDA kernels.

The sources under ``csrc/`` are plain CUDA C++ with a C interface (no
PyTorch header). At the first launch they are compiled by one ``nvcc``
call into a shared library under ``_build/`` (listed in .gitignore),
keyed by a hash of the sources and flags, and loaded with ``ctypes``.
Nothing is built at import time.

Each wrapper takes CUDA tensors only: it checks them, launches its
kernel on PyTorch's current stream, raises if the launch fails, and
counts the launch in ``LAUNCHES``. The plain PyTorch versions live
beside the callers in ``render/tdsp.py``.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

import numpy as np
import torch

from .dsp import wavetables as W
from .native import BUILD_DIR
from .render.tdsp import asi32

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'csrc')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-fmad=false', '-shared', '-Xcompiler', '-fPIC')

# launches of each kernel since the last reset_launches()
LAUNCHES = {'wosc_fill': 0, 'scan_add_u32': 0}

_lib = None


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc():
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the CUDA kernels of '
                           'saugns_tpu_torch cannot be built')
    return path


def build():
    """Compile (once per source hash) and load the kernel library;
    returns its path."""
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
        tmp = '%s.%d.tmp' % (so, os.getpid())
        r = subprocess.run([_nvcc(), *NVCC_FLAGS, '-o', tmp, *srcs],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError('nvcc failed (%d):\n%s%s'
                               % (r.returncode, r.stdout, r.stderr))
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    vp, ll, ci, cf = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_float)
    lib.saugns_scan_scratch_len.argtypes = [ll]
    lib.saugns_scan_scratch_len.restype = ll
    lib.saugns_scan_add_u32.argtypes = [vp, vp, vp, ll, vp]
    lib.saugns_scan_add_u32.restype = ci
    lib.saugns_wosc_fill_blocks.argtypes = [ll]
    lib.saugns_wosc_fill_blocks.restype = ll
    lib.saugns_wosc_fill.argtypes = [vp] * 7 + [cf, cf, vp, vp, ll, ci,
                                                vp]
    lib.saugns_wosc_fill.restype = ci
    _lib = lib
    return so


def _check(rc, name):
    if rc != 0:
        raise RuntimeError('%s: CUDA launch failed with cudaError_t %d'
                           % (name, rc))


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _need_cuda(name, *ts):
    for t in ts:
        if not t.is_cuda:
            raise ValueError('%s: expects CUDA tensors' % name)
        if t.device != ts[0].device:
            raise ValueError('%s: tensors on different devices' % name)


def scan_add_u32(x):
    """Kernel 2: inclusive prefix sum of a 1-D int64 tensor of u32
    values, wrapping mod 2^32; returns int64 in [0, 2^32)."""
    _need_cuda('scan_add_u32', x)
    if x.dim() != 1 or x.dtype != torch.int64 or x.numel() < 1:
        raise ValueError('scan_add_u32: expects a non-empty 1-D int64 '
                         'tensor')
    build()
    x32 = asi32(x & 0xffffffff).to(torch.int32).contiguous()
    y = torch.empty_like(x32)
    n = x32.numel()
    scratch = torch.empty(int(_lib.saugns_scan_scratch_len(n)),
                          dtype=torch.int32, device=x.device)
    rc = _lib.saugns_scan_add_u32(x32.data_ptr(), y.data_ptr(),
                                  scratch.data_ptr(), n, _stream(x))
    _check(rc, 'scan_add_u32')
    LAUNCHES['scan_add_u32'] += 1
    return y.to(torch.int64) & 0xffffffff


def wosc_fill(pilut, wave, ph, pp, ps, first_ir, do_rst, rst_prev):
    """Kernel 1: filled oscillator output (V, L) float32 of u32 phase
    rows ``ph`` (V, L) int64, with (V,) seeds -- see
    tdsp.wosc_s_filled_plain for the semantics."""
    name = 'wosc_fill'
    _need_cuda(name, ph, pilut, pp, ps, first_ir, do_rst, rst_prev)
    if ph.dim() != 2 or ph.dtype != torch.int64:
        raise ValueError('%s: ph must be (V, L) int64' % name)
    V, L = ph.shape
    if V < 1 or L < 1:
        raise ValueError('%s: empty phase rows' % name)
    if pilut.shape != (W.LEN,) or pilut.dtype != torch.float32:
        raise ValueError('%s: pilut must be (%d,) float32' % (name, W.LEN))
    for t in (pp, ps, first_ir, do_rst, rst_prev):
        if t.shape != (V,):
            raise ValueError('%s: seeds must be (V,)' % name)
    build()

    def u32(t):
        return asi32(t & 0xffffffff).to(torch.int32).contiguous()

    ph32 = u32(ph)
    out = torch.empty((V, L), dtype=torch.float32, device=ph.device)
    nb = int(_lib.saugns_wosc_fill_blocks(L))
    scratch = torch.empty(2 * V * nb, dtype=torch.int32, device=ph.device)
    args = (u32(pp), ps.to(torch.float32).contiguous(),
            first_ir.to(torch.int64).contiguous(),
            do_rst.to(torch.bool).contiguous(), u32(rst_prev),
            pilut.contiguous())
    dvs = float(np.float32(W.dvscale(wave)))
    dvo = float(np.float32(W.dvoffset(wave)))
    rc = _lib.saugns_wosc_fill(ph32.data_ptr(),
                               *(a.data_ptr() for a in args),
                               dvs, dvo, out.data_ptr(),
                               scratch.data_ptr(), L, V, _stream(ph))
    _check(rc, name)
    LAUNCHES['wosc_fill'] += 1
    return out
