"""Native (C) fast path for host-side DSP.

Compiled on first use with the same flags as the reference build
(-O3 -ffast-math) so float contraction matches the reference binary on
this machine; falls back to the NumPy implementations when no C
compiler is available.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

# build products stay inside the checkout (listed in .gitignore)
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), '_build')

_lib = None
_tried = False


def get_lib():
    """Build (once, cached) and load the fastdsp shared library.
    Returns None when unavailable."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    src = os.path.join(os.path.dirname(__file__), 'fastdsp.c')
    cache = BUILD_DIR
    try:
        os.makedirs(cache, exist_ok=True)
        with open(src, 'rb') as f:
            # stable content digest: builtin hash() is salted per
            # process, which recompiled every start and accumulated
            # stale .so files in the cache dir
            tag = hashlib.sha256(f.read()).hexdigest()[:16]
        so = os.path.join(cache, 'fastdsp_%s.so' % tag)
        if not os.path.exists(so):
            for cc in ('cc', 'gcc', 'clang'):
                try:
                    # per-process temporary: parallel test workers
                    # build into the same directory
                    tmp = '%s.%d.tmp' % (so, os.getpid())
                    r = subprocess.run(
                        [cc, '-O3', '-ffast-math', '-shared', '-fPIC',
                         '-o', tmp, src, '-lm'],
                        capture_output=True, timeout=120)
                    if r.returncode == 0:
                        os.replace(tmp, so)
                        break
                except (OSError, subprocess.TimeoutExpired):
                    continue
            else:
                return None
        if not os.path.exists(so):
            return None
        lib = ctypes.CDLL(so)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        f32p = ctypes.POINTER(ctypes.c_float)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.wosc_run.argtypes = [f32p, u32p, ctypes.c_long, f32p,
                                 ctypes.c_float, ctypes.c_float, u32p,
                                 f64p, f32p]
        lib.wosc_run_selfmod.argtypes = [f32p, u32p, ctypes.c_long,
                                         f32p, f32p, ctypes.c_float,
                                         ctypes.c_float, u32p, f64p,
                                         f32p, f32p]
        lib.phasor_fill.argtypes = [u32p, ctypes.c_long,
                                    ctypes.c_float, u32p, f32p, f32p,
                                    f32p]
        lib.wave_tables_build.argtypes = [f32p, f32p]
        _lib = lib
    except Exception:
        _lib = None
    return _lib
