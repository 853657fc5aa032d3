"""Captured dispatch of the port: the render's bodies as CUDA graphs.

Counterpart of the JAX package's compiled dispatch: ``jax.jit`` of a
flat segment's init, chunk-group, fini and whole-segment functions
(saugns_tpu/render/flat.py:697-715, 1009-1050), of a run of segments
that share one template (flat.py:1052-1159) and of the whole render
(``JaxGenerator._mono``, saugns_tpu/render/engine.py:1145-1247). Here a
body is a Python function of the static structure of its key and of
tensors only: it reads no host value and uploads nothing, so one
``torch.cuda.CUDAGraph`` captured on its first call replays it for
every later call with the same key.

``Dispatch`` runs bodies in one of three ways:

- on CUDA (``capture``): the first call of a key clones the call's
  tables into static input buffers and captures the body over them
  with ``torch.cuda.graph``; every call copies its tables into those
  buffers (device to device) and replays. A capture, instantiation or
  replay that fails raises; nothing falls back to running the body.
- on the CPU (``static`` without ``capture``): the same static buffers
  and the same body, the one of the key's first call, run directly.
- eagerly (neither; ``graphs=False`` on CUDA, or the plain path): the
  body runs on the call's own tables, op by op.

``capture_call`` captures a function of no arguments once under a key
into a given memory pool and leaves its replays to the caller: the time
axis (parallel/timeshard.py) captures each piece of a shard's stage
loop between two exchanges so, thousands a render.

Tensors passed as ``bound`` are used as they are by every call of a key
(the generator's state buffers, a template's carry buffers, tables that
live as long as the generator); ``tables`` are copied in per call.

Kernel launches stay counted per replay: the launches made while a
graph is captured go to the capture (``kernels.capturing``), not to
``kernels.LAUNCHES``, and are added there at each replay of that graph;
so do a graph's nodes, counted once at capture, to the tracing counter
``dispatch.nodes_replayed``.

Spans (``tracing``): ``dispatch.capture`` around a capture and
instantiation, ``dispatch.capture.body`` inside it around the body's
Python, ``dispatch.replay`` around a replay's host side (the tables'
copies and the launch).

Dispatches of several threads (the multi-script queue's workers) may
run at once: captures take one process-wide lock, since the cyclic
garbage collector is switched off for a capture process-wide and a
collection would invalidate it; each captures in the thread-local
error mode, under its own device and on a stream of its own, so that
another thread's work cannot invalidate it or run on it; replays run
concurrently.
"""
from __future__ import annotations

import contextlib
import ctypes
import gc
import threading

import numpy as np
import torch

from .. import tracing

# kernel launches made by graph replays since the last reset_replayed()
# (also counted in kernels.LAUNCHES)
REPLAYED = {}
_replayed_lock = threading.Lock()
# one capture at a time in the process
_capture_lock = threading.Lock()


def reset_replayed():
    with _replayed_lock:
        REPLAYED.clear()


# the dtypes of packed tables, in their order in a Tables' buffers
_DTYPES = (('int64', torch.int64), ('float32', torch.float32),
           ('bool', torch.bool), ('int32', torch.int32))


class Tables:
    """Named host arrays packed into one flat buffer per dtype, so that
    a call copies a renderer's tables into a graph's static inputs with
    a few copies. ``layout`` (names, dtypes, offsets, shapes) is part
    of a key: tables with equal layouts unpack alike."""

    def __init__(self, arrays):
        parts = {name: [] for name, _ in _DTYPES}
        sizes = {name: 0 for name, _ in _DTYPES}
        layout = []
        for key in sorted(arrays):
            a = np.ascontiguousarray(arrays[key])
            dt = a.dtype.name
            if dt not in parts:
                raise TypeError('Tables: %s has dtype %s' % (key, dt))
            layout.append((key, dt, sizes[dt], a.shape))
            parts[dt].append(a.ravel())
            sizes[dt] += a.size
        self.layout = tuple(layout)
        used = {x[1] for x in layout}
        self._names = tuple(name for name, _ in _DTYPES if name in used)
        self.host = tuple(np.concatenate(parts[name])
                          for name in self._names)
        self.bufs = None

    def __getstate__(self):
        # host tables only (the compiled-render store): uploaded anew
        return dict(self.__dict__, bufs=None)

    def upload(self, device):
        """The flat buffers on ``device`` (once)."""
        if self.bufs is None:
            self.bufs = tuple(torch.from_numpy(h).to(device)
                              for h in self.host)
        return self.bufs

    def arrays(self):
        """name -> host array (a view of the packed host buffers)."""
        by = dict(zip(self._names, self.host))
        return {key: by[dt][off:off + int(np.prod(shape, dtype=np.int64))]
                .reshape(shape) for key, dt, off, shape in self.layout}

    def views(self, bufs=None):
        """name -> tensor view of ``bufs`` (the uploaded buffers by
        default, or a graph's static copies of them)."""
        return unpack(self.layout, self._names,
                      self.bufs if bufs is None else bufs)


def unpack(layout, names, bufs):
    by = dict(zip(names, bufs))
    out = {}
    for key, dt, off, shape in layout:
        n = int(np.prod(shape, dtype=np.int64))
        out[key] = by[dt][off:off + n].view(shape)
    return out


_LIBCUDA = []


def _libcuda():
    """libcuda through ctypes (None where it cannot be loaded), loaded
    once: the time axis counts the nodes of thousands of captures."""
    if not _LIBCUDA:
        try:
            _LIBCUDA.append(ctypes.CDLL('libcuda.so.1'))
        except OSError:
            _LIBCUDA.append(None)
    return _LIBCUDA[0]


def _capture_nodes():
    """Nodes of the graph being captured on the current stream, read
    through libcuda (cuStreamGetCaptureInfo, cuGraphGetNodes); None
    where it cannot be read."""
    stream = torch.cuda.current_stream().cuda_stream
    lib = _libcuda()
    if lib is None:
        return None
    status = ctypes.c_int()
    cid = ctypes.c_ulonglong()
    graph = ctypes.c_void_p()
    deps = ctypes.c_void_p()
    ndeps = ctypes.c_size_t()
    s = ctypes.c_void_p(stream)
    if hasattr(lib, 'cuStreamGetCaptureInfo_v2'):
        rc = lib.cuStreamGetCaptureInfo_v2(
            s, ctypes.byref(status), ctypes.byref(cid),
            ctypes.byref(graph), ctypes.byref(deps), ctypes.byref(ndeps))
    elif hasattr(lib, 'cuStreamGetCaptureInfo_v3'):
        edges = ctypes.c_void_p()
        rc = lib.cuStreamGetCaptureInfo_v3(
            s, ctypes.byref(status), ctypes.byref(cid),
            ctypes.byref(graph), ctypes.byref(deps), ctypes.byref(edges),
            ctypes.byref(ndeps))
    else:
        return None
    if rc != 0 or not graph.value:
        return None
    n = ctypes.c_size_t(0)
    if lib.cuGraphGetNodes(graph, None, ctypes.byref(n)) != 0:
        return None
    return int(n.value)


class _Graph:
    """One key: its body, static input buffers, outputs and, on CUDA,
    its captured graph and the kernel launches it holds."""

    def __init__(self, body, tables):
        self.body = body
        self.static = tuple(t.clone() for t in tables)
        self.bound = None
        self.graph = None
        self.out = None
        self.launches = {}
        self.nodes = None


class Dispatch:
    """Runs the render's bodies (see the module docstring) and counts
    captures, replays and graph nodes. On the CPU a "capture" is the
    first call of a key (its static buffers made, its body run on them)
    and a "replay" a run of its body on them. ``capture_s`` and
    ``body_s`` are the durations of the ``dispatch.capture`` and
    ``dispatch.capture.body`` spans, summed."""

    def __init__(self, device, static, capture, st0):
        self.device = device
        self.static = static
        self.capture = capture
        # the initial state (sf, si, vdur), the state buffers the
        # bodies render on, and the checksum accumulator
        self.st0 = st0
        self.st = tuple(t.clone() for t in st0)
        self.acc = torch.zeros((), dtype=torch.int64, device=device)
        self.graphs = {}
        self.templates = {}
        self.carries = {}
        self.captures = 0
        self.replays = 0
        self.nodes = 0
        self.capture_s = 0.0
        self.body_s = 0.0
        self._capture_stream = None

    def template(self, r):
        """The renderer whose bodies serve ``r``'s key: the first one
        run with that key (``r`` itself when running eagerly)."""
        if not self.static:
            return r
        return self.templates.setdefault(r.key, r)

    def carry(self, tmpl):
        """The carry buffers of ``tmpl``'s key (0-d tensors, or (V,) for
        a segment of V voices; made once)."""
        c = self.carries.get(tmpl.key)
        if c is None:
            c = self.carries[tmpl.key] = tuple(
                torch.zeros(tmpl.lead, dtype=dt, device=self.device)
                for _name, dt in tmpl.carry_spec())
        return c

    def accs(self, conv):
        """The checksum accumulator, as a body of conversion ``conv``
        takes it (flat.with_conv)."""
        return (self.acc,) if conv == 'cksum' else ()

    def state(self, conv):
        """The bound arguments of a body that renders on the state
        buffers: the accumulator where ``conv`` takes it, then sf, si
        and vdur."""
        return self.accs(conv) + self.st

    def stats(self):
        return {'graphs': len(self.graphs), 'captures': self.captures,
                'replays': self.replays, 'nodes': self.nodes,
                'capture_s': self.capture_s, 'body_s': self.body_s}

    def run(self, key, body, bound=(), tables=()):
        """body(*bound, *tables) through the graph of ``key``; returns
        the body's outputs (a graph's static outputs: a later call of
        the same key overwrites them)."""
        if not self.static:
            return body(*bound, *tables)
        g = self.graphs.get(key)
        first = g is None
        ptrs = tuple(t.data_ptr() for t in bound)
        if first:
            g = self.graphs[key] = _Graph(body, tables)
            g.bound = ptrs
            self.captures += 1
            tables = ()
        elif ptrs != g.bound:
            raise RuntimeError('graph %r: bound tensors moved' % (key,))
        if not self.capture:
            self.replays += 1
            if first:
                return self._first_run(lambda: g.body(*bound, *g.static))
            with tracing.span('dispatch.replay'):
                _copy_in(g.static, tables)
                return g.body(*bound, *g.static)
        if first:
            try:
                self._capture(g, lambda: g.body(*bound, *g.static))
            except BaseException:
                del self.graphs[key]
                raise
        self._replay(g, tables)
        self.replays += 1
        return g.out

    def capture_call(self, key, fn, pool=None):
        """Run ``fn()`` once and keep it under ``key``: on CUDA captured
        on this dispatch's device and capture stream into the graph
        memory pool ``pool`` (a private pool of its own by default), then
        replayed; elsewhere called. Returns the _Graph, whose ``out`` is
        fn's outputs (on CUDA the graph's static outputs, computed by
        each replay of ``graph``). Graphs that share a pool must replay
        in the order they were captured. The time axis captures the code
        between two exchanges this way (parallel/timeshard.py)."""
        if key in self.graphs:
            raise RuntimeError('graph %r: captured twice' % (key,))
        g = _Graph(None, ())
        if self.capture:
            self._capture(g, fn, pool, fresh=False)
            self._replay(g)
        else:
            g.out = self._first_run(fn)
        self.graphs[key] = g
        self.captures += 1
        self.replays += 1
        return g

    def reset_stats(self):
        """Counts and seconds <- 0 (a generator that takes this
        dispatch over from another counts its own)."""
        self.captures = self.replays = self.nodes = 0
        self.capture_s = self.body_s = 0.0

    def reset(self):
        """State buffers <- the initial state, accumulator <- 0: the
        first step of a render (a graph of its own)."""
        self.run(('reset',), _reset_body, self.st + self.st0 + (self.acc,))

    def _replay(self, g, tables=()):
        """Copy ``tables`` into ``g``'s static inputs and replay its
        graph; count its launches and nodes."""
        with tracing.span('dispatch.replay'):
            _copy_in(g.static, tables)
            g.graph.replay()
        count_replayed(g.launches)
        if g.nodes:
            tracing.count('dispatch.nodes_replayed', g.nodes)

    def _first_run(self, fn):
        """``fn()``, a key's first run where nothing is captured (the
        CPU), timed as a capture."""
        with tracing.span('dispatch.capture') as cap:
            with tracing.span('dispatch.capture.body') as body:
                out = fn()
        self.capture_s += cap.seconds
        self.body_s += body.seconds
        return out

    def _capture(self, g, fn, pool=None, fresh=True):
        """Capture ``fn()`` into ``g.graph`` (its outputs ``g.out``, its
        launches ``g.launches``, its node count ``g.nodes``). ``fresh``
        (a body): through torch.cuda.graph, which first waits for the
        device and frees the cached blocks; else (the time axis's
        pieces, thousands a render) a bare capture into ``pool``."""
        from .. import kernels
        cuda = self.device.type == 'cuda'
        guard = torch.cuda.device(self.device) if cuda \
            else contextlib.nullcontext()
        with _capture_lock, guard, tracing.span('dispatch.capture') as cap:
            graph = torch.cuda.CUDAGraph()
            # a capture stream of the dispatch's own: torch.cuda.graph's
            # default is one stream shared by every capture of the
            # process
            if cuda and self._capture_stream is None:
                self._capture_stream = torch.cuda.Stream(self.device)
            prev = torch.cuda.current_stream() if cuda else None
            # no cyclic garbage collection inside the capture:
            # collecting a dead generator there destroys its graphs, a
            # call that the capture does not permit and that invalidates
            # it
            enabled = gc.isenabled()
            gc.disable()
            try:
                # the capture launches nothing: its launches count at
                # replays
                begin = torch.cuda.graph(
                    graph, stream=self._capture_stream,
                    capture_error_mode='thread_local') if fresh \
                    else _bare_capture(graph, self._capture_stream, pool)
                with kernels.capturing() as launches, begin, \
                        tracing.span('dispatch.capture.body') as body:
                    out = fn()
                    nodes = _capture_nodes()
            finally:
                if enabled:
                    gc.enable()
                # a capture that fails leaves its stream current (its
                # capture_end raises before the stream is restored): the
                # thread's later work would run on the capture stream
                if prev is not None:
                    torch.cuda.set_stream(prev)
        g.launches = launches
        g.graph, g.out, g.nodes = graph, out, nodes
        if nodes is not None:
            self.nodes += nodes
        self.capture_s += cap.seconds
        self.body_s += body.seconds


@contextlib.contextmanager
def _bare_capture(graph, stream, pool):
    """A capture of the calling thread's work on ``stream`` into the
    memory pool ``pool``: torch.cuda.graph without the
    torch.cuda.synchronize and cache frees its __enter__ makes at every
    capture. The caller restores the current stream."""
    torch.cuda.set_stream(stream)
    graph.capture_begin(pool, capture_error_mode='thread_local')
    try:
        yield
    except BaseException:
        # end the broken capture; the caller's error is the one raised
        with contextlib.suppress(Exception):
            graph.capture_end()
        raise
    graph.capture_end()


def _copy_in(static, tables):
    for dst, src in zip(static, tables):
        dst.copy_(src)


def count_replayed(launches):
    """Count the kernel launches ``launches`` (name -> n) of replayed
    graphs: in kernels.LAUNCHES and in REPLAYED."""
    from .. import kernels
    for k, n in launches.items():
        kernels.count(k, n)
    with _replayed_lock:
        for k, n in launches.items():
            REPLAYED[k] = REPLAYED.get(k, 0) + n


def _reset_body(sf, si, vdur, sf0, si0, vdur0, acc):
    sf.copy_(sf0)
    si.copy_(si0)
    vdur.copy_(vdur0)
    acc.zero_()
