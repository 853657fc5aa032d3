"""The JAX package's native wave tables, made safe on a cold build cache.

``saugns_tpu.native.get_lib`` compiles ``fastdsp.c`` into
``<cache>/fastdsp_<tag>.so`` through the shared name
``fastdsp_<tag>.so.tmp``. Processes that start together on an empty
cache (pytest-xdist workers) compile into that one file; one of them
can then load a half-written library or fail its rename, and
``get_lib`` returns None. ``saugns_tpu.dsp.wavetables.get_tables``
then falls back to the NumPy tables, which differ from the native ones
in 6 of 12 tables by ~1 ulp, and every render of that process differs
from the committed goldens.

``ensure_native_tables()`` repairs that state from outside the package:
it builds the same source with the same flags into a file of this
process's own and renames it atomically onto the cache name, resets
the loader's and the tables' caches (and JAX's compiled functions,
which may hold the NumPy tables as constants), loads again, and raises
if the tables still do not come from the native library. Port test
modules that read the JAX package's tables or render through it call
it from an autouse module fixture before their first use.
"""
import hashlib
import os
import shutil
import subprocess

import numpy as np
import torch

# One intra-op thread in every test process. The tier-1 suite runs six
# pytest-xdist workers on an 8-core machine; each worker collects the
# whole suite and so imports this module, and torch's default OpenMP
# pool of one thread a core in each worker put ~48 threads on 8 cores,
# which ran the port's tests many times slower than one thread each.
torch.set_num_threads(1)


def _tables_match(native, W, jdsp):
    """Whether the package's cached tables are those of the native
    library ``native._lib``."""
    if native._lib is None:
        return False
    want = W._native_tables()
    if want is None:
        return False
    return all(np.array_equal(np.asarray(a), b)
               for got in (W.get_tables(), jdsp.get_tables())
               for a, b in zip(got, want))


def _build(native):
    """Compile native/fastdsp.c as native/__init__.py does, into a
    process-unique file, and rename it onto the cache name."""
    src = os.path.join(os.path.dirname(native.__file__), 'fastdsp.c')
    cache = os.environ.get('SAUGNS_TPU_CACHE',
                           os.path.expanduser('~/.cache/saugns_tpu_xla'))
    os.makedirs(cache, exist_ok=True)
    with open(src, 'rb') as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(cache, 'fastdsp_%s.so' % tag)
    tmp = '%s.%d.tmp' % (so, os.getpid())
    logs = []
    for cc in ('cc', 'gcc', 'clang'):
        if shutil.which(cc) is None:
            continue
        r = subprocess.run([cc, '-O3', '-ffast-math', '-shared', '-fPIC',
                            '-o', tmp, src, '-lm'], capture_output=True,
                           text=True, timeout=120)
        if r.returncode == 0:
            os.replace(tmp, so)
            return
        logs.append('%s: %s' % (cc, r.stderr))
    if os.path.exists(tmp):
        os.remove(tmp)
    raise RuntimeError('no C compiler built saugns_tpu/native/fastdsp.c; '
                       'the JAX package would render with its NumPy '
                       'tables, not the ones the goldens were made with:\n'
                       + '\n'.join(logs))


def _reset(native, W, jdsp):
    """Forget the loader's result, every table the package keeps
    (wavetables and jdsp, the copies derived from them), and the
    compiled functions that may hold tables as constants (the renderers
    keep their functions as jax.jit objects, which trace again)."""
    import jax
    native._lib = None
    native._tried = False
    W._cache = None
    jdsp._luts = jdsp._piluts = None
    jdsp._tap_mats = jdsp._win_tabs = jdsp._win_tabs4 = None
    jax.clear_caches()


def ensure_native_tables():
    """Make sure the JAX package in this process renders with the wave
    tables of its native library; raise if it cannot."""
    from saugns_tpu import native
    from saugns_tpu.dsp import wavetables as W
    from saugns_tpu.render import jdsp
    native.get_lib()
    if _tables_match(native, W, jdsp):
        return
    for _ in range(3):
        if native._lib is None:
            _build(native)
        _reset(native, W, jdsp)
        native.get_lib()
        if _tables_match(native, W, jdsp):
            return
    raise RuntimeError('the JAX package does not load the wave tables of '
                       'its native library (saugns_tpu.native.get_lib() is '
                       '%r)' % (native._lib,))
