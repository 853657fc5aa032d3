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

The render runs op by op: the exchanges cut each shard's stage loop
into pieces, which are not captured as CUDA graphs. The player and the
CLI do not take this path (the JAX package's do not either).

    python -m saugns_tpu_torch.parallel.dryrun cpu,cpu,cpu,cpu
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from ..render import tdsp
from ..render.flat import FlatSegment, padded_rows
from ..render.graphs import Tables
from ..render.hostsim import HostSim
from ..render.plan import RenderPlan
from ..render.state import _to_i16_device, make_state

M32 = tdsp.M32


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


def run_lockstep(steps, carry, ends, devices, tally=None):
    """Drive the stage loops ``steps`` (FlatSegment._chunk_steps of the
    segment's chunks, in order, chunk j on ``devices[j]``) at once,
    exchange by exchange, from the segment's carries ``carry``; chunk
    j's end carries go into ``ends[j]``, and each exchange's kind is
    counted into ``tally``. Returns the chunks' outputs."""
    state = [_advance(s, None) for s in steps]
    while state[0][0] is not None:
        ex0 = state[0][0]
        kind, names = ex0.kind, ex0.names
        for ex, _ in state:
            if ex is None or ex.kind != kind or ex.names != names:
                raise RuntimeError('time axis: the shards\' stage loops '
                                   'left lockstep at %s %s' % (kind, names))
        if tally is not None:
            tally[kind] = tally.get(kind, 0) + 1
        seed = tuple(carry[n] for n in names)
        if kind == 'serial':
            # one shard after another: each takes the previous one's end
            # carries once it has run
            for j, s in enumerate(steps):
                state[j] = _advance(s, tuple(t.to(devices[j])
                                             for t in seed))
                seed = tuple(ends[j][n] for n in names)
            continue
        replies = []
        for j, (ex, _) in enumerate(state):
            dev = devices[j]
            if kind == 'provisional':
                replies.append((torch.full((), float('nan'),
                                           dtype=torch.float32,
                                           device=dev),))
                continue
            seed = tuple(t.to(dev) for t in seed)
            replies.append(seed)
            seed = (_combine(kind, seed[0], ex.pub()),)
        state = [_advance(s, r) for s, r in zip(steps, replies)]
    return [out for _, out in state]


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
    may repeat). ``plain=True`` runs the plain version of every kernel.
    Raises ValueError for a program with an epoch that is not
    flat-eligible."""

    def __init__(self, prg, srate, mesh, axis='sp', plain=False):
        if axis not in mesh.axis_names:
            raise ValueError('mesh has no %r axis' % axis)
        self.mesh = mesh
        self.axis = axis
        self.plain = plain
        self.plan = RenderPlan(prg, srate)
        self.sim = HostSim(self.plan)
        self.srate = srate
        for ei, bake in enumerate(self.sim.bakes):
            if not bake.eligible:
                raise ValueError('epoch %d not flat-eligible (%s)'
                                 % (ei, bake.reason or
                                    'segment-level rejection'))
        self.devices = _axis_devices(mesh, axis)
        # the exchanges of the last render, by kind (flat.Exchange)
        self.exchanges = {}
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

    def _piluts_on(self, device):
        """The wave tables on ``device`` (once a device)."""
        if device not in self._piluts:
            self._piluts[device] = tdsp.wave_tables(device)[1]
        return self._piluts[device]

    def prepare(self):
        """The kernel build, and every segment's tables on its devices:
        the segment's own on the first device, chunk j's on shard j's."""
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

    def render_device(self):
        """Full sharded render; returns int16 pieces on the first device,
        one (nb, B, 2) tensor per segment in timeline order (the
        contract of TorchGenerator.render_device)."""
        self.prepare()
        dev0 = self.devices[0]
        st = make_state(self.plan, dev0)
        pieces = []
        self.exchanges = {}
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

    def render_host(self):
        """Host (signal_end, 2) int16 timeline (assembled)."""
        out = np.zeros((self.plan.signal_end, 2), np.int16)
        pos = 0
        it = iter(self.render_device())
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
