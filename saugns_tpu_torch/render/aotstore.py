"""The compiled-render store of the port: a program's prepared render
kept live in the process, and its host-baked tables stored on disk.

Counterpart of ``saugns_tpu/render/aotstore.py``, which stores a
``jax.export`` artifact of the one-dispatch render. A CUDA graph cannot
leave its process (its nodes hold raw device pointers and function
handles), and a recorded tape of the bodies' aten operations replays
slower than the bodies run, so the store has two tiers:

- the memory tier: a generator of a key whose artifact exists hands
  its prepared render (its Dispatch with the graphs, its renderers and
  their uploaded tables) to the tier when it is dropped after a render
  that completed; the next generator of that key on that device takes
  it in its constructor, for itself alone, and captures nothing. A live
  generator never loses its render. At most ``LIVE_MAX`` renders wait
  there, holding their device memory after their generators are gone;
  ``clear()`` drops them;
- the disk tier: the host products a generator computes before its
  device work (the RenderPlan, which epochs HostSim bakes, and every
  flat segment's and sequential epoch's host tables, keys and static
  structure). A generator of a stored key rebuilds its renderers from
  them and then uploads as without the store. No device tensor, graph
  or tape is stored.

An artifact is one file: ``MAGIC``, a JSON header line that repeats
every field of the key (with the format version and the payload's size
and sha256), then a pickle of the port's own host objects. The loader
reads only the user and the pack directory below, and unpickles only
plain Python data, numpy arrays and the port's classes in ``_CLASSES``
(no other name, and no dotted one, resolves); the program,
the device and the wave tables are the loading generator's own
(pickle persistent ids). An artifact that cannot be read, has another
version or does not match its header is a miss, counted in
``STATS['corrupt']``: the generator then computes as without the store
and renders on the same device with the same kernels.

Keys are content hashes of: the program's serialized IR without its
name (one artifact for a script under two names), the sample rate, the
kind of render, ``code_hash()`` (every source under ``CODE_DIRS`` and
``CODE_FILES``, and the kernels' nvcc flags), the sha256 of the wave
tables the render uses (the generator's own or the caller's
``piluts=``, told apart) and of a caller's initial state, the
generator's arguments that shape its bodies, ``torch.__version__``,
the device's kind and the ``TRACE_ENVS`` knobs.

Store layout (first hit wins; <cache> is $SAUGNS_TPU_CACHE, by default
~/.cache/saugns_tpu_torch):
  <cache>/exports/torch-<platform>/<key>.render              (user)
  saugns_tpu_torch/aot/exports/<platform>/<key>.render      (a pack)

``SAUGNS_TPU_EXPORT=0`` turns both tiers off. Build a pack with
``tools/torch_export_pack.py``; the repository ships none.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import pickle
import threading

import numpy as np
import torch

from .hostsim import EpochBake, SegBake

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# sources whose content shapes the host tables or the bodies
CODE_DIRS = ('render', 'dsp', 'parallel', 'native', 'csrc')
CODE_FILES = ('kernels.py',)
CODE_EXTS = ('.py', '.c', '.cu', '.cuh')
# env knobs that change what a render computes (values folded into the
# key): HostSim's self-PM eligibility and the wave tables' build
TRACE_ENVS = ('SAUGNS_TPU_FLAT_SELFMOD', 'SAUGNS_TPU_NATIVE_TABLES')
# the artifact's format version, its first bytes and file suffix
FORMAT = 1
MAGIC = b'saugns_tpu_torch render\n'
SUFFIX = '.render'
# most prepared renders the memory tier keeps
LIVE_MAX = 4

STATS = {'mem_hits': 0, 'disk_hits': 0, 'misses': 0, 'saves': 0,
         'corrupt': 0}
_lock = threading.Lock()
# the memory tier: [(live key, prepared render)], oldest first
_live = []
_code_hash_cache = None
_own_tables = None


def _count(name):
    with _lock:
        STATS[name] += 1


def reset_stats():
    with _lock:
        for k in STATS:
            STATS[k] = 0


def code_hash(root=None):
    """sha256 (16 hex digits) of the port's sources under ``root``
    (the package by default) that shape a render, and of the kernels'
    nvcc flags."""
    global _code_hash_cache
    if root is None and _code_hash_cache is not None:
        return _code_hash_cache
    from .. import kernels
    base = _PKG if root is None else root
    h = hashlib.sha256(' '.join(kernels.NVCC_FLAGS).encode())
    paths = [os.path.join(base, f) for f in CODE_FILES]
    for d in CODE_DIRS:
        p = os.path.join(base, d)
        if os.path.isdir(p):
            paths += [os.path.join(p, fn) for fn in sorted(os.listdir(p))
                      if fn.endswith(CODE_EXTS)]
    for p in paths:
        h.update(('|' + os.path.relpath(p, base) + '|').encode())
        with open(p, 'rb') as f:
            h.update(f.read())
    out = h.hexdigest()[:16]
    if root is None:
        _code_hash_cache = out
    return out


def array_sha(a):
    """sha256 of an array's or a tensor's dtype, shape and bytes."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().contiguous().numpy()
    a = np.ascontiguousarray(a)
    h = hashlib.sha256(('%s%s' % (a.dtype.str, a.shape)).encode())
    h.update(a.tobytes())
    return h.hexdigest()


def tables_field(piluts=None):
    """The key's field of the wave tables a render uses: the sha256 of
    the port's own PILUT tables, or of the caller's ``piluts``; the two
    are told apart even where their bytes agree."""
    global _own_tables
    if piluts is not None:
        return 'given:' + array_sha(piluts)
    if _own_tables is None:
        from ..dsp import wavetables as W
        _own_tables = 'own:' + array_sha(W.get_tables()[1])
    return _own_tables


def device_kind(device):
    """'cpu', or 'cuda:' and the card's name."""
    device = torch.device(device)
    if device.type == 'cuda':
        return 'cuda:' + torch.cuda.get_device_name(device)
    return device.type


def key_fields(prg, srate, kind='mono', piluts=None, state=None,
               args=None, device='cpu'):
    """Every field of a render's key, as plain JSON data (an artifact's
    header repeats them): see the module docstring."""
    from ..lang.serialize import program_to_dict
    d = program_to_dict(prg)
    d.pop('name', None)
    prog = hashlib.sha256(json.dumps(d, sort_keys=True).encode())
    fields = {
        'program': prog.hexdigest(), 'srate': int(srate), 'kind': kind,
        'code': code_hash(), 'tables': tables_field(piluts),
        'state': None if state is None else {
            k: array_sha(v) for k, v in sorted(state.items())},
        'args': dict(args or {}), 'torch': torch.__version__,
        'device': device_kind(device),
        'envs': {e: os.environ.get(e, '') for e in TRACE_ENVS}}
    return json.loads(json.dumps(fields, sort_keys=True))


def key_of(fields):
    return hashlib.sha256(json.dumps(fields, sort_keys=True)
                          .encode()).hexdigest()[:24]


def program_key(prg, srate, kind='mono', **kw):
    """Content key of one render (``kw``: see key_fields)."""
    return key_of(key_fields(prg, srate, kind, **kw))


def _user_dir(platform):
    root = os.environ.get('SAUGNS_TPU_CACHE',
                          os.path.expanduser('~/.cache/saugns_tpu_torch'))
    return os.path.join(root, 'exports', 'torch-' + platform)


def _pack_dir(platform):
    return os.path.join(_PKG, 'aot', 'exports', platform)


def enabled():
    return os.environ.get('SAUGNS_TPU_EXPORT', '1') == '1'


# -- the disk tier ------------------------------------------------------------

class _Pickler(pickle.Pickler):
    """Pickles the port's host objects; ``persistent`` (object id ->
    name) and every torch.device stand for the loading generator's own
    objects, HostSim's bakes (which a flat segment keeps from its
    construction, and which its render does not read) for None; any
    other torch object raises."""

    def __init__(self, f, persistent):
        super().__init__(f, protocol=5)
        self._pids = persistent

    def persistent_id(self, obj):
        name = self._pids.get(id(obj))
        if name is not None:
            return name
        if isinstance(obj, torch.device):
            return 'device'
        if isinstance(obj, (EpochBake, SegBake)):
            return 'none'
        if isinstance(obj, (torch.Tensor, torch.dtype)) \
                or type(obj).__module__.startswith('torch'):
            raise pickle.PicklingError('a stored render holds no torch '
                                       'object: %r' % type(obj))
        return None


# what an artifact may name: the port's classes it holds, and numpy's
# array, scalar and dtype reconstructors (numpy 1 and 2 names); no name
# has a dot, so none resolves to an attribute of a module it names
_CLASSES = {('saugns_tpu_torch.render.' + m, n) for m, n in (
    ('engine', 'SeqEpoch'), ('flat', 'FlatSegment'), ('graphs', 'Tables'),
    ('plan', 'RenderPlan'), ('plan', 'Epoch'), ('plan', 'Stage'),
    ('plan', 'Instance'))}
_SAFE = {(m, n) for m in ('numpy', 'numpy.core.multiarray',
                          'numpy._core.multiarray', 'numpy.core.numeric',
                          'numpy._core.numeric')
         for n in ('_reconstruct', 'ndarray', 'dtype', 'scalar',
                   '_frombuffer')}


class _Unpickler(pickle.Unpickler):

    def __init__(self, f, persistent):
        super().__init__(f)
        self._objs = persistent

    def find_class(self, module, name):
        if (module, name) in _SAFE:
            return super().find_class(module, name)
        if (module, name) in _CLASSES:
            cls = super().find_class(module, name)
            if isinstance(cls, type) and cls.__module__ == module \
                    and cls.__qualname__ == name:
                return cls
        raise pickle.UnpicklingError('a stored render names %s.%s'
                                     % (module, name))

    def persistent_load(self, pid):
        if pid == 'none':
            return None
        if pid not in self._objs:
            raise pickle.UnpicklingError('unknown object %r' % (pid,))
        return self._objs[pid]


def _read(path, key, fields, persistent):
    with open(path, 'rb') as f:
        data = f.read()
    if not data.startswith(MAGIC):
        raise ValueError('not a stored render')
    nl = data.index(b'\n', len(MAGIC))
    head = json.loads(data[len(MAGIC):nl].decode())
    payload = data[nl + 1:]
    if head.get('format') != FORMAT or head.get('key') != key:
        raise ValueError('format or key differs')
    if head.get('fields') != fields:
        raise ValueError('header differs from the key')
    if head.get('bytes') != len(payload) \
            or head.get('sha256') != hashlib.sha256(payload).hexdigest():
        raise ValueError('payload damaged')
    return _Unpickler(io.BytesIO(payload), persistent).load()


def load(key, platform, fields, persistent):
    """The stored host products of ``key`` (from the user directory,
    then the pack), or None (counted as a miss; an artifact that does
    not load also counts as corrupt). ``fields`` must equal the
    artifact's header. ``persistent()`` returns the map from the names
    that save() gave to objects ('prg', 'piluts', 'device') to the
    loading generator's own; it is called only where a file exists."""
    if not enabled():
        return None
    for d in (_user_dir(platform), _pack_dir(platform)):
        p = os.path.join(d, key + SUFFIX)
        if not os.path.isfile(p):
            continue
        try:
            art = _read(p, key, fields, persistent())
        except Exception:
            _count('corrupt')
            continue
        _count('disk_hits')
        return art
    _count('misses')
    return None


def save(key, platform, artifact, fields=None, persistent=None):
    """Write ``artifact`` (host objects) as ``key``'s file in the user
    directory; ``persistent`` maps objects to names that load() gets
    back from the loading generator. Returns the path."""
    buf = io.BytesIO()
    _Pickler(buf, {id(o): n for n, o in (persistent or {}).items()}) \
        .dump(artifact)
    payload = buf.getvalue()
    head = {'format': FORMAT, 'key': key, 'fields': fields,
            'bytes': len(payload),
            'sha256': hashlib.sha256(payload).hexdigest()}
    d = _user_dir(platform)
    os.makedirs(d, exist_ok=True)
    p = os.path.join(d, key + SUFFIX)
    tmp = p + '.tmp.%d' % os.getpid()
    with open(tmp, 'wb') as f:
        f.write(MAGIC + json.dumps(head, sort_keys=True).encode() + b'\n')
        f.write(payload)
    os.replace(tmp, p)
    _count('saves')
    return p


# -- the memory tier ----------------------------------------------------------

def checkout(lkey):
    """Take the newest prepared render waiting under ``lkey`` (counted
    as a memory hit), or None."""
    with _lock:
        for i in range(len(_live) - 1, -1, -1):
            if _live[i][0] == lkey:
                STATS['mem_hits'] += 1
                return _live.pop(i)[1]
    return None


def deposit(lkey, entry):
    """Let ``entry``, a prepared render no generator holds, wait under
    ``lkey``; the oldest beyond LIVE_MAX go."""
    with _lock:
        _live.append((lkey, entry))
        del _live[:max(len(_live) - LIVE_MAX, 0)]


def live():
    """The number of prepared renders waiting in the memory tier."""
    with _lock:
        return len(_live)


def clear():
    """Drop every prepared render waiting in the memory tier."""
    with _lock:
        _live.clear()
