"""Time-axis ('sp') sharding of a compiled Program's render:
``TimeShardRender``.

Counterpart of ``saugns_tpu/parallel/timeshard.py``. The flat renderer
(render/flat.py) evaluates every block row of an eligible segment from
host-baked tables, so the block-row axis can be split over devices.
Each segment is cut into one chunk a shard (``FlatSegment`` with
``row_multiple`` the shard count and a chunk of the padded rows over
it): chunk j's tables are shard j's, uploaded to its device. The state
stays on the first device, where each segment's records are applied,
its carries read (``_init``) and its end carries written (``_fini``).

The JAX class leaves the cross-row work to GSPMD, which turns the
in-chunk scans into collectives. PyTorch has none, so the shards' stage
loops (``FlatSegment._chunk_steps``) run in lockstep, stage by stage,
and each carry that crosses a shard edge is an explicit exchange at the
point where the loop yields it (``flat.Exchange``):

- the wrapping u32 and u64 phase runs and red noise's sum (kernels 2
  and 3, and the scalar-frequency ramps): each shard scans from 0 and
  publishes its total; a shard's carry is the segment's plus the
  earlier shards' totals (inactive samples add 0);
- the phase a wave oscillator pairs with and the previous in-range
  noise value (kernel 4's row hold): a look-back through the earlier
  shards to the nearest one with an active sample, else the segment's
  carry; a pending reset goes to the first shard with one;
- kernel 1's pd == 0 hold: every shard runs kernel 1 at once on a NaN
  seed; the seed of a shard is the last output of the nearest earlier
  shard that has a valid sample (a non-NaN last output), else the
  segment's carry, and it replaces the shard's NaN samples, exactly
  those before its first valid one (a valid output is finite);
- the self-PM recurrences (kernels 5 and 6) cannot be split: shard j's
  launch takes shard j - 1's end carries.

Kernels 1-4 run on all shards at once; only the small tensors of an
exchange move between devices (``.to``), and nothing synchronises the
host. The segment's end carries are the last shard's, which the
exchanges have seeded through every earlier shard. The output is
bit-identical to the one-device render (``TorchGenerator``): every
cross-row carry is integer arithmetic or a selection of values, which
splitting cannot change.

On CUDA the render replays CUDA graphs (``graphs=True``, the default).
The exchanges cut each shard's stage loop into pieces. A segment key's
first render records a tape (``_Tape``): it drives the template
segment's shard loops as above, but runs each piece, from one exchange
to the next together with that exchange's ``pub()``, inside a capture
on its shard's dispatch (``graphs.Dispatch.capture_call``; one memory
pool a key and shard), hands the shards static reply buffers, and
writes down in order "replay piece k of shard j" and "answer this
exchange from these pubs into these replies". Every later render of the
key, and every later segment of the key, copies its chunk tables into
the tape's static table buffers and runs the tape alone: the replays
and, between them, the answers (``_combine`` and ``copy_`` on the static
pubs and replies). It runs no generator and no stage loop, reads no
host value and uploads nothing. The segment's ``_init`` and ``_fini``
run as the init and fini graphs of the first device's dispatch, which
holds the state buffers. On the CPU, which has no graphs, every render
drives the template's loops on the tape's static buffers.
``graphs=False`` runs op by op (the eager A/B), as does ``plain=True``.

The tensors that cross a piece boundary inside a shard's loop lie in
the key and shard's memory pool, which no later capture takes memory
from, so they keep their memory for every replay; the tape also holds
every tensor that an answer, the fini or the output reads.

The player and the CLI do not take this path (the JAX package's do not
either).

    python -m saugns_tpu_torch.parallel.dryrun cpu,cpu,cpu,cpu
"""
from __future__ import annotations

import copy
import time

import numpy as np
import torch

from .. import tracing
from ..render import tdsp
from ..render.flat import FlatSegment, padded_rows
from ..render.graphs import Dispatch, Tables, count_replayed
from ..render.hostsim import HostSim
from ..render.plan import RenderPlan
from ..render.state import _to_i16_device, make_state

M32 = tdsp.M32
F32 = torch.float32


def _axis_devices(mesh, axis):
    """The devices along ``axis`` of ``mesh`` (the first device of each
    slice where the mesh has other axes)."""
    arr = np.moveaxis(mesh.devices, mesh.axis_names.index(axis), 0)
    return list(arr.reshape(arr.shape[0], -1)[:, 0])


def _chunk_tables(fs, c):
    """Chunk ``c``'s tables of FlatSegment ``fs`` as a Tables of one
    chunk (its leading axis of length 1)."""
    t = fs.xs[c // fs.gch]
    i = c % fs.gch
    host = t.views(tuple(torch.from_numpy(h) for h in t.host))
    return Tables({k: v[i:i + 1].numpy() for k, v in host.items()})


def _advance(steps, reply):
    """(next Exchange, None), or (None, the output) once the stage loop
    has ended."""
    try:
        return steps.send(reply), None
    except StopIteration as stop:
        return None, stop.value


def _combine(kind, seed, pub):
    """The carry a chunk hands on, from its own carry ``seed`` and its
    ``pub()`` (see flat.Exchange)."""
    if kind == 'add32':
        return (seed + pub) & M32
    if kind == 'add64':
        return seed + pub
    if kind == 'hold':
        act, val = pub
        return torch.where(act, val, seed)
    if kind == 'once':
        return seed & ~pub
    if kind == 'fill':
        return torch.where(torch.isnan(pub), seed, pub)
    raise ValueError('unknown exchange %r' % kind)


class _Eager:
    """run_lockstep's drive op by op: each loop advanced directly, each
    reply made anew."""

    def __init__(self, steps, devices):
        self.steps = steps
        self.devices = devices

    def advance(self, j, reply):
        """Loop ``j`` sent ``reply``: ((kind, names) of its next exchange
        or None, that exchange's pub() (None on the last chunk, which
        hands nothing on), the loop's output once it has ended)."""
        ex, out = _advance(self.steps[j], reply)
        if ex is None:
            return None, None, out
        last = j == len(self.steps) - 1
        return ((ex.kind, ex.names),
                None if ex.pub is None or last else ex.pub(), None)

    def hand(self, j, seed):
        """The carries ``seed`` as chunk ``j``'s reply."""
        return tuple(t.to(self.devices[j]) for t in seed)

    def answer(self, kind, seed, pubs):
        """Every chunk's reply to an exchange of ``kind`` (not 'serial'),
        chunk by chunk from the segment's carries ``seed``."""
        replies = []
        for j, dev in enumerate(self.devices):
            if kind == 'provisional':
                replies.append((torch.full((), float('nan'), dtype=F32,
                                           device=dev),))
                continue
            seed = self.hand(j, seed)
            replies.append(seed)
            if j < len(self.devices) - 1:
                seed = (_combine(kind, seed[0], pubs[j]),)
        return replies


def run_lockstep(steps, carry, ends, devices, tally=None, drive=None):
    """Drive the stage loops ``steps`` (FlatSegment._chunk_steps of the
    segment's chunks, in order, chunk j on ``devices[j]``) at once,
    exchange by exchange, from the segment's carries ``carry``; chunk
    j's end carries go into ``ends[j]``, and each exchange's kind is
    counted into ``tally``. ``drive`` advances the loops and makes the
    replies (op by op by default; a tape's recording on the graph path).
    Returns the chunks' outputs."""
    drive = drive or _Eager(steps, devices)
    n = len(steps)
    state = [drive.advance(j, None) for j in range(n)]
    while state[0][0] is not None:
        kind, names = at = state[0][0]
        if any(a != at for a, _, _ in state):
            raise RuntimeError('time axis: the shards\' stage loops '
                               'left lockstep at %s %s' % at)
        if tally is not None:
            tally[kind] = tally.get(kind, 0) + 1
        seed = tuple(carry[name] for name in names)
        if kind == 'serial':
            # one shard after another: each takes the previous one's end
            # carries once it has run
            for j in range(n):
                state[j] = drive.advance(j, drive.hand(j, seed))
                seed = tuple(ends[j][name] for name in names)
            continue
        replies = drive.answer(kind, seed, [pub for _, pub, _ in state])
        state = [drive.advance(j, r) for j, r in enumerate(replies)]
    return [out for _, _, out in state]


class _Carries:
    """Carries (``spec``: (name, dtype) pairs) as 0-d views of one
    buffer a dtype on ``device``, so that a segment's carries copy as a
    few tensors."""

    def __init__(self, spec, device):
        groups = {}
        for name, dt in spec:
            groups.setdefault(dt, []).append(name)
        self.names = tuple(tuple(names) for names in groups.values())
        self.bufs = tuple(torch.zeros(len(names), dtype=dt, device=device)
                          for dt, names in groups.items())
        self.views = {name: b[i] for b, names in zip(self.bufs, self.names)
                      for i, name in enumerate(names)}
        # in spec order, as the init and fini bodies take them
        self.ordered = tuple(self.views[name] for name, _ in spec)

    def copy_(self, other):
        for b, o in zip(self.bufs, other.bufs):
            b.copy_(o)

    def write(self, carries):
        """Buffers <- the 0-d tensors ``carries`` (name -> tensor)."""
        for b, names in zip(self.bufs, self.names):
            b.copy_(torch.stack([carries[name] for name in names]))


class _Tape:
    """A segment key's recording (see the module docstring): the static
    buffers its pieces read and write and, on CUDA, its pieces' graphs
    and answers in order (``ops``: (an answer?, callable))."""

    def __init__(self, tid, fs, shards, disps):
        devs = [sh.device for sh in shards]
        spec = fs.carry_spec()
        # the key's graphs (init, fini, the pieces) are keyed by this
        # small id: a segment key holds the epoch's whole stage list,
        # too long to hash at each of thousands of captures
        self.id = tid
        # the template: the key's first segment and its shards
        self.fs = fs
        self.shards = shards
        self.disps = disps
        self.capture = disps[0].capture
        # the segment's carries, written by the init graph (shard 0's
        # and every shard's on the first device), each other shard's
        # copy, and its chunk's tables
        self.carry = _Carries(spec, devs[0])
        self.cin = [self.carry if d == devs[0] else _Carries(spec, d)
                    for d in devs]
        self.tabs = [tuple(b.clone() for b in sh.tables.bufs)
                     for sh in shards]
        # the reply to every 'provisional' exchange of a shard
        self.nan = [torch.full((), float('nan'), dtype=F32, device=d)
                    for d in devs]
        # the last shard's end carries, written by its last piece, and
        # the fini's copy of them on the first device
        self.ends = _Carries(spec, devs[-1])
        self.fin = self.ends if devs[-1] == devs[0] \
            else _Carries(spec, devs[0])
        self.pools = [torch.cuda.graph_pool_handle() if self.capture
                      else None for _ in devs]
        self.replies = []       # static reply buffers, by exchange
        self.ops = []
        self.outs = None        # each shard's int16 output
        self.launches = {}      # the pieces' kernel launches, summed
        self.nodes = 0          # and their graph nodes
        self.tally = {}         # the exchanges by kind
        self.pieces = [0] * len(devs)
        self.recorded = False


class _Recording:
    """run_lockstep's drive on a tape: the template's loops on the
    tape's static buffers, each piece run through its shard's dispatch
    (captured there on the key's first render on CUDA), each reply a
    static buffer."""

    def __init__(self, tape):
        self.tape = tape
        self.devices = [sh.device for sh in tape.shards]
        self.ends = [dict(c.views) for c in tape.cin]
        self.steps = [sh.fs._chunk_steps(sh.tables.views(t), 0, c.views, e)
                      for sh, t, c, e in zip(tape.shards, tape.tabs,
                                             tape.cin, self.ends)]
        self.n = 0      # the static reply buffers taken

    def advance(self, j, reply):
        """See _Eager.advance; the last shard's last piece also writes
        its end carries to ``tape.ends``, and each loop's output is
        its int16 conversion."""
        tape = self.tape
        steps, ends = self.steps[j], self.ends[j]
        last = j == len(self.steps) - 1

        def piece():
            ex, out = _advance(steps, reply)
            if ex is not None:
                if ex.pub is None or last:
                    return (ex.kind, ex.names), None, None
                # a pub of its own: a view (the last output of a stage,
                # a scan's total) would hold its whole base in the pool
                # for as long as the tape lives
                pub = ex.pub()
                pub = tuple(t.clone() for t in pub) \
                    if isinstance(pub, tuple) else pub.clone()
                return (ex.kind, ex.names), pub, None
            if last:
                tape.ends.write(ends)
            return None, None, _to_i16_device(out)
        disp = tape.disps[j]
        if tape.recorded:
            disp.replays += 1
            return piece()
        g = disp.capture_call(('piece', tape.id, j, tape.pieces[j]),
                              piece, tape.pools[j])
        tape.pieces[j] += 1
        if tape.capture:
            tape.ops.append((False, g.graph.replay))
            for k, v in g.launches.items():
                tape.launches[k] = tape.launches.get(k, 0) + v
            tape.nodes += g.nodes or 0
        return g.out

    def _static(self, make):
        """The next static reply buffers (made by ``make()`` on the
        key's first render)."""
        if not self.tape.recorded:
            self.tape.replies.append(make())
        self.n += 1
        return self.tape.replies[self.n - 1]

    def _op(self, op):
        """Run ``op`` now, and at every replay of the tape."""
        op()
        if self.tape.capture and not self.tape.recorded:
            self.tape.ops.append((True, op))

    def hand(self, j, seed):
        dev = self.devices[j]
        if all(t.device == dev for t in seed):
            return seed
        bufs = self._static(lambda: tuple(torch.empty_like(t, device=dev)
                                          for t in seed))

        def op():
            for b, t in zip(bufs, seed):
                b.copy_(t)
        self._op(op)
        return bufs

    def answer(self, kind, seed, pubs):
        if kind == 'provisional':
            return [(nan,) for nan in self.tape.nan]
        # shard 0 takes the segment's carry itself
        bufs = self._static(lambda: (seed[0],) + tuple(
            torch.empty((), dtype=seed[0].dtype, device=d)
            for d in self.devices[1:]))

        def op():
            s = bufs[0]
            for j in range(1, len(bufs)):
                bufs[j].copy_(_combine(kind, s, pubs[j - 1]))
                s = bufs[j]
        self._op(op)
        return [(b,) for b in bufs]


class _Shard:
    """One shard of a segment: its chunk's tables on its device, and a
    view of the segment's renderer on that device."""

    def __init__(self, fs, c, device, piluts):
        self.device = device
        self.tables = _chunk_tables(fs, c)
        self.fs = copy.copy(fs)
        self.fs.device = device
        self.fs.piluts = piluts

    def steps(self, carry, ends):
        return self.fs._chunk_steps(self.tables.views(), 0, carry, ends)


class TimeShardRender:
    """Renders one Program with each segment's block rows split over
    ``mesh``'s ``axis`` dimension (a parallel.sharding.Mesh; a device
    may repeat). ``plain=True`` runs the plain version of every kernel;
    ``graphs=False`` (or ``plain``) runs op by op, else through a tape
    of graphs a segment key (see the module docstring). Raises
    ValueError for a program with an epoch that is not
    flat-eligible."""

    def __init__(self, prg, srate, mesh, axis='sp', plain=False,
                 graphs=True):
        if axis not in mesh.axis_names:
            raise ValueError('mesh has no %r axis' % axis)
        self.mesh = mesh
        self.axis = axis
        self.plain = plain
        self.graphs = graphs
        self.plan = RenderPlan(prg, srate)
        self.sim = HostSim(self.plan)
        self.srate = srate
        for ei, bake in enumerate(self.sim.bakes):
            if not bake.eligible:
                raise ValueError('epoch %d not flat-eligible (%s)'
                                 % (ei, bake.reason or
                                    'segment-level rejection'))
        self.devices = _axis_devices(mesh, axis)
        # the exchanges of the last render, by kind (flat.Exchange), and
        # the host seconds its replayed tapes spent answering them and
        # replaying pieces
        self.exchanges = {}
        self.exchange_s = self.replay_s = 0.0
        ns = len(self.devices)
        self._piluts = {}
        dev0 = self.devices[0]
        # one chunk a shard: the padded rows (a multiple of the shard
        # count) over the shards, with no cap on a chunk's size (past
        # eight shards the chunk groups may add chunks of padding only,
        # which no shard renders)
        self.segs = []
        for ei, ep in enumerate(self.plan.epochs):
            bake = self.sim.bakes[ei]
            for seg in bake.segments:
                rows = padded_rows(seg.hi - seg.lo, ns)
                fs = FlatSegment(self.plan, ep, bake, seg, srate, dev0,
                                 self._piluts_on(dev0), plain=plain,
                                 chunk_samples=rows // ns * ep.block,
                                 row_multiple=ns)
                self.segs.append((ei, fs))
        self._shards = None
        # the graph path: a dispatch a shard (the first one's holds the
        # state buffers) and a tape a segment key
        self.disps = None
        self._tapes = {}
        self._next_tape = 0     # the next tape's id

    def _piluts_on(self, device):
        """The wave tables on ``device`` (once a device)."""
        if device not in self._piluts:
            self._piluts[device] = tdsp.wave_tables(device)[1]
        return self._piluts[device]

    def prepare(self):
        """The kernel build, every segment's tables on its devices (the
        segment's own on the first device, chunk j's on shard j's) and,
        on the graph path, the shards' dispatches."""
        if self._shards is not None:
            return
        if not self.plain and any(d.type == 'cuda' for d in self.devices):
            from .. import kernels
            kernels.build()
        self._shards = []
        for _ei, fs in self.segs:
            fs.dyn.upload(self.devices[0])
            shards = [_Shard(fs, j, dev, self._piluts_on(dev))
                      for j, dev in enumerate(self.devices)]
            for sh in shards:
                sh.tables.upload(sh.device)
            self._shards.append(shards)
        if self.graphs and not self.plain:
            capture = all(d.type == 'cuda' for d in self.devices)
            st = make_state(self.plan, self.devices[0])
            st0 = tuple(st[k].contiguous() for k in ('sf', 'si', 'vdur'))
            self.disps = [Dispatch(d, True, capture, st0 if j == 0 else ())
                          for j, d in enumerate(self.devices)]

    def graph_stats(self):
        """The shards' graph counts, summed (see TorchGenerator; a piece
        is a graph), the tapes, the last render's exchanges by kind, and
        the host seconds its replayed tapes spent answering exchanges
        (``exchange_s``) against replaying pieces (``replay_s``)."""
        self.prepare()
        tot = {'graphs': 0, 'captures': 0, 'replays': 0, 'nodes': 0,
               'capture_s': 0.0, 'body_s': 0.0}
        for d in self.disps or ():
            for k, v in d.stats().items():
                tot[k] += v
        tot.update(tapes=len(self._tapes), exchanges=dict(self.exchanges),
                   exchange_s=self.exchange_s, replay_s=self.replay_s)
        return tot

    @tracing.traced('render.timeshard')
    def render_device(self):
        """Full sharded render; returns int16 pieces on the first device,
        one (nb, B, 2) tensor per segment in timeline order (the
        contract of TorchGenerator.render_device)."""
        self.prepare()
        self.exchanges = {}
        self.exchange_s = self.replay_s = 0.0
        if self.disps is None:
            return self._render_eager()
        self.disps[0].reset()
        return [self._segment(fs, shards)
                for (_ei, fs), shards in zip(self.segs, self._shards)]

    def _render_eager(self):
        dev0 = self.devices[0]
        st = make_state(self.plan, dev0)
        pieces = []
        for (_ei, fs), shards in zip(self.segs, self._shards):
            dyn = fs.dyn.views()
            st, carry = fs._init(st, dyn)
            ends, steps = [], []
            for sh in shards:
                mine = {k: v.to(sh.device) for k, v in carry.items()}
                ends.append(dict(mine))
                steps.append(sh.steps(mine, ends[-1]))
            outs = run_lockstep(steps, carry, ends, self.devices,
                                self.exchanges)
            st = fs._fini(st, {k: v.to(dev0) for k, v in ends[-1].items()},
                          dyn)
            # the shards that hold rows of the segment (the others hold
            # padding only), each converted on its device
            used = -(-fs.nb // fs.nc)
            full = torch.cat([_to_i16_device(o).to(dev0)
                              for o in outs[:used]])
            pieces.append(full[:fs.nb])
        return pieces

    def _segment(self, fs, shards):
        """Render segment ``fs`` (its shards ``shards``) on the graph
        path: init, its key's tape, fini. Returns its (nb, B, 2) int16
        output, copied out of the tape's static outputs."""
        disp = self.disps[0]
        key = (fs.key, len(shards))
        tape = self._tapes.get(key)
        if tape is None:
            tape = self._tapes[key] = _Tape(self._next_tape, fs, shards,
                                            self.disps)
            self._next_tape += 1
        for bufs, sh in zip(tape.tabs, shards):
            for dst, src in zip(bufs, sh.tables.bufs):
                dst.copy_(src)
        disp.run(('init', tape.id), tape.fs.init_body(),
                 disp.st + tape.carry.ordered, fs.dyn.bufs)
        for c in tape.cin:
            if c is not tape.carry:
                c.copy_(tape.carry)
        if tape.recorded and tape.capture:
            self._replay(tape)
        else:
            try:
                rec = _Recording(tape)
                tally = {}
                tape.outs = run_lockstep(rec.steps, tape.carry.views,
                                         rec.ends, rec.devices, tally, rec)
            except BaseException:
                if not tape.recorded:
                    # a failed capture raises, and the next render of
                    # the key records its tape (and init and fini graphs,
                    # bound to its buffers) anew
                    del self._tapes[key]
                    for d in self.disps:
                        for k in [k for k in d.graphs
                                  if k[1:2] == (tape.id,)]:
                            del d.graphs[k]
                raise
            tape.tally = tally
            tape.recorded = True
        for k, v in tape.tally.items():
            self.exchanges[k] = self.exchanges.get(k, 0) + v
        if tape.fin is not tape.ends:
            tape.fin.copy_(tape.ends)
        disp.run(('fini', tape.id), tape.fs.fini_body(),
                 disp.st + tape.fin.ordered, fs.dyn.bufs)
        used = -(-fs.nb // fs.nc)
        return torch.cat([o.to(disp.device)
                          for o in tape.outs[:used]])[:fs.nb]

    def _replay(self, tape):
        """Run a recorded tape: its pieces' replays and its answers, in
        order; count its pieces' launches and graph nodes."""
        spent = [0.0, 0.0]
        t = time.perf_counter()
        for answer, op in tape.ops:
            op()
            now = time.perf_counter()
            spent[answer] += now - t
            t = now
        self.replay_s += spent[0]
        self.exchange_s += spent[1]
        count_replayed(tape.launches)
        if tape.nodes:
            tracing.count('dispatch.nodes_replayed', tape.nodes)
        for d, n in zip(self.disps, tape.pieces):
            d.replays += n

    def render_host(self):
        """Host (signal_end, 2) int16 timeline (assembled)."""
        return self.assemble(self.render_device())

    def assemble(self, pieces):
        """render_device's pieces as the host (signal_end, 2) int16
        timeline."""
        out = np.zeros((self.plan.signal_end, 2), np.int16)
        pos = 0
        it = iter(pieces)
        k = 0
        for ei, ep in enumerate(self.plan.epochs):
            if ep.start > pos:
                pos = int(ep.start)
            while k < len(self.segs) and self.segs[k][0] == ei:
                fs = self.segs[k][1]
                arr = next(it).cpu().numpy()
                for j in range(fs.lo, fs.lo + fs.nb):
                    blen = int(ep.blk_len[j])
                    if blen > 0:
                        out[pos:pos + blen] = arr[j - fs.lo, :blen]
                        pos += blen
                k += 1
        if pos != self.plan.signal_end:
            raise RuntimeError('rendered %d samples of %d'
                               % (pos, self.plan.signal_end))
        return out
