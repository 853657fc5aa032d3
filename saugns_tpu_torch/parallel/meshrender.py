"""Voice-sharded rendering of heterogeneous SAU programs: ``MeshRender``.

Counterpart of ``saugns_tpu/parallel/meshrender.py``. ``BankRender``
(voicebank.py) shards *structurally uniform* voice banks; this module
renders any flat-eligible program -- multi-epoch timelines whose
voices differ structurally -- over a device mesh:

- Each epoch's stage schedule is sliced into per-voice runs (the
  planner emits voices contiguously in ascending id order). On each
  shard, a segment's voices of one signature (one ``FlatSegment`` key)
  render as one ``FlatSegment`` of V voices as V rows
  (``FlatSegment.stack``), as the JAX package vmaps one compile over
  each signature group (``_Group``); a group wider than the bank's slab
  rule (``voicebank.slab_width``) is cut into slabs by that rule.
  Slabs of one key share one captured graph per device
  (``graphs.Dispatch``).
- A voice renders on the same device for the whole render: voices are
  placed by global voice id (voices that share an operator across
  epochs go together), not by their slot in a segment's group, which
  changes from segment to segment.
- Each device holds a replica of the packed state: every replica
  applies every record range; a voice's init reads and its fini writes
  only its own operators' rows (no operator is shared across the
  voices of an epoch), and the segment-end tables, global and the same
  for every voice, are written on every replica. So each slab's fused
  body (init, chunk groups, fini) on its device's replica does what the
  JAX package's vmapped init/scan/writeback and ``_seg_end`` do.
- The stereo mix is the reference's only cross-voice reduction
  (sau/generator.c:749-788). Each voice's contribution is added into
  one accumulator on the mesh's first device in ascending global voice
  id -- the same left-to-right f32 chain as the engine's VMIX stage
  sequence -- so the mesh render is bit-identical to the single-device
  engine. The slabs render in the order of their first voice; a slab's
  voices are added as soon as every lower voice is, and the rest of
  its (V, nb, B, 2) contributions are kept (one copy of the slab's
  output) until their turn: a segment whose signatures or shards
  interleave in voice id holds up to its voices' contributions.

Programs the host sim can't fully bake (self-PM feedback with
SAUGNS_TPU_FLAT_SELFMOD=0, shared state cells, ratio-flip taint) are
rejected with ``Ineligible``, a ValueError: callers render them with
the single-device engine.
"""
from __future__ import annotations

import os
import sys
from typing import Dict, Optional

import numpy as np
import torch

from .. import tracing
from ..render import tdsp
from ..render.flat import (END_TABLES, FlatSegment, _write_state,
                           write_end_tables)
from ..render.graphs import Dispatch, Tables
from ..render.hostsim import HostSim
from ..render.plan import RenderPlan
from ..render.state import apply_prepared, make_state, prepare_records
from .scripts import PrerenderedGenerator
from .sharding import Mesh
from .voicebank import (_bake_view, _EpochView, _mesh_devices,
                        _voice_slices, slab_width)

# the player buffers a mesh render whole on the host; longer programs
# render on the streaming engine (same cap as multi-script sharding,
# parallel/scripts.py)
MESH_MAX_BUFFER_SAMPLES = 1 << 25


class Ineligible(ValueError):
    """The program cannot render on the mesh path (the JAX package's
    ValueError of the same cases)."""


class _Seg:
    """One segment of an epoch: its record range and end tables (per
    shard), and its slabs: (shard, global voice ids in ascending order,
    the FlatSegment of those voices as rows), in the order of their
    first voice id."""

    def __init__(self, seg, slabs, struct, recs, end):
        self.seg = seg
        self.slabs = slabs
        self.struct = struct
        self.recs = recs
        self.end = end


def _owner_components(plan):
    """voice id -> the smallest voice id it shares an operator with,
    over every epoch (voices that must render on one device)."""
    parent: Dict[int, int] = {}

    def find(v):
        parent.setdefault(v, v)
        while parent[v] != v:
            parent[v] = parent[parent[v]]
            v = parent[v]
        return v
    op_voice: Dict[int, int] = {}
    for ep in plan.epochs:
        for s in ep.stages:
            find(s.voice)
            if s.op < 0:
                continue
            w = op_voice.setdefault(s.op, s.voice)
            a, b = find(w), find(s.voice)
            if a != b:
                parent[max(a, b)] = min(a, b)
    return {v: find(v) for v in parent}


class MeshRender:
    """Renders any flat-eligible Program over a device mesh,
    bit-identically to the single-device engine.

    ``mesh``: a Mesh with a 'voices' axis (parallel.sharding.Mesh), or
    None for one device (``device``, CUDA by default) on the same
    grouped path. ``plain`` and ``graphs`` as for TorchGenerator.
    ``plan`` and ``sim``: the program's RenderPlan and HostSim where the
    caller has built them (a TorchGenerator's), else built here."""

    def __init__(self, prg, srate: int, mesh: Optional[Mesh] = None,
                 device=None, plain=False, graphs=True, plan=None,
                 sim=None):
        from ..render.engine import resolve_device
        self.prg = prg
        self.srate = srate
        self.mesh = mesh
        self.plain = plain
        self.graphs = graphs
        if plan is None:
            with tracing.span('plan.build'):
                plan = RenderPlan(prg, srate)
                sim = HostSim(plan)
        self.plan = plan
        self.sim = sim
        for ei, bake in enumerate(self.sim.bakes):
            if not bake.eligible:
                raise Ineligible(
                    'epoch %d not flat-eligible: %s' % (ei, bake.reason))
        # an op bound into several voices' graphs would make voice
        # rows non-disjoint; the per-voice write-back requires
        # ownership
        for ep in self.plan.epochs:
            owner = {}
            for s in ep.stages:
                if s.op < 0:
                    continue
                if owner.setdefault(s.op, s.voice) != s.voice:
                    raise Ineligible(
                        'operator %d shared across voices' % s.op)
        self.devices = [resolve_device(device)] if mesh is None \
            else _mesh_devices(mesh)
        # voice -> shard, by global voice id: round robin over the
        # voices (and voices sharing an operator across epochs) in
        # ascending order
        comp = _owner_components(self.plan)
        roots = sorted(set(comp.values()))
        slot = {r: k % len(self.devices) for k, r in enumerate(roots)}
        self.shard_of = {v: slot[r] for v, r in comp.items()}
        self._ready = False

    def _build(self):
        """Per shard: the state replica and its dispatch; per segment:
        each shard's signature groups in slabs, the record and end
        tables on every shard. Spans: ``plan.build`` the segments and
        their host tables, ``plan.upload`` the rest."""
        self.disps = []
        piluts = []
        for dev in self.devices:
            cuda = dev.type == 'cuda'
            if cuda and not self.plain:
                from .. import kernels
                kernels.build()
            with tracing.span('plan.upload'):
                piluts.append(tdsp.wave_tables(dev)[1])
                st = make_state(self.plan, dev)
                static = not self.plain and (self.graphs or not cuda)
                self.disps.append(Dispatch(
                    dev, static, static and cuda,
                    tuple(st[k] for k in ('sf', 'si', 'vdur'))))
        with tracing.span('plan.build'):
            self.epoch_segs = [(ep, self._segments(ep, bake, piluts))
                               for ep, bake in zip(self.plan.epochs,
                                                   self.sim.bakes)]
        with tracing.span('plan.upload'):
            for _ep, segs in self.epoch_segs:
                for s in segs:
                    for _d, _vs, fs in s.slabs:
                        fs.prepare()
                    for dev, rec, end in zip(self.devices, s.recs, s.end):
                        rec.upload(dev)
                        end.upload(dev)
        self._ready = True

    def _segments(self, ep, bake, piluts):
        """Epoch ``ep``'s segments (_Seg), their tables on the host."""
        slices = _voice_slices(ep)
        views = [_EpochView(ep, sl.v_lo, sl.v_hi, sl.i_lo, sl.i_hi)
                 for sl in slices]
        segs = []
        for seg in bake.segments:
            # (shard, key) -> [(voice id, one-voice segment)], in
            # ascending voice id
            groups = {}
            for sl, view in zip(slices, views):
                v = ep.stages[sl.v_lo].voice
                d = self.shard_of[v]
                vb = _bake_view(bake, sl, view, src_seg=seg)
                fs = FlatSegment(self.plan, view, vb, vb.segments[0],
                                 self.srate, self.devices[d],
                                 piluts[d], plain=self.plain,
                                 end_tables=False)
                groups.setdefault((d, fs.key), []).append((v, fs))
            slabs = []
            for (d, _key), members in groups.items():
                fs0 = members[0][1]
                width = slab_width(len(members), fs0.nb * fs0.B)
                for k in range(0, len(members), width):
                    part = members[k:k + width]
                    slabs.append((d, [v for v, _ in part],
                                  FlatSegment.stack([m for _, m in part])))
            slabs.sort(key=lambda x: x[1][0])
            struct, rec = prepare_records(
                int(ep.blk_rec_lo[seg.lo]), int(ep.blk_rec_hi[seg.lo]),
                self.plan.rec_arrays, device_cols_only=True)
            end = {k: getattr(seg, 'end_' + k) for k in END_TABLES}
            segs.append(_Seg(seg, slabs, struct,
                             [Tables(rec) for _ in self.devices],
                             [Tables(end) for _ in self.devices]))
        return segs

    def graph_stats(self):
        """The shards' graph counts, summed (see TorchGenerator)."""
        self.prepare()
        tot = {}
        for disp in self.disps:
            for k, v in disp.stats().items():
                tot[k] = tot.get(k, 0) + v
        return tot

    def prepare(self):
        if not self._ready:
            self._build()

    def _records(self, d, s):
        """Shard ``d``'s replica: the segment's first block's records."""
        if s.struct is None:
            return
        disp = self.disps[d]
        t = s.recs[d]
        disp.run(('recs', s.struct, t.layout), _records_body(s.struct, t),
                 disp.st, t.bufs)

    def _seg_end(self, d, s):
        """Shard ``d``'s replica: the segment-end tables (a shard that
        renders none of the segment's voices gets them too)."""
        disp = self.disps[d]
        t = s.end[d]
        disp.run(('end', t.layout), _seg_end_body(t), disp.st, t.bufs)

    @tracing.traced('render.mesh')
    def render(self) -> np.ndarray:
        """Full render -> host (signal_end, 2) f32 stereo mix."""
        self.prepare()
        plan = self.plan
        dev0 = self.devices[0]
        for disp in self.disps:
            disp.reset()
        out_parts = []  # on the first device, in timeline order
        pos = 0
        for ep, segs in self.epoch_segs:
            if ep.start > pos:
                out_parts.append(torch.zeros(
                    (int(ep.start) - pos, 2), dtype=torch.float32,
                    device=dev0))
                pos = int(ep.start)
            blk_len = np.asarray(ep.blk_len)
            for s in segs:
                lo, hi = s.seg.lo, s.seg.hi
                for d in range(len(self.devices)):
                    self._records(d, s)
                mix = self._mix(s, dev0)
                for d in range(len(self.devices)):
                    self._seg_end(d, s)
                for k in range(hi - lo):
                    blen = int(blk_len[lo + k])
                    if blen > 0:  # no active voices: silence
                        out_parts.append(
                            torch.zeros((blen, 2), dtype=torch.float32,
                                        device=dev0) if mix is None
                            else mix[k, :blen])
                        pos += blen
        if pos != plan.signal_end:
            raise RuntimeError('rendered %d samples of %d'
                               % (pos, plan.signal_end))
        if not out_parts:
            return np.zeros((0, 2), np.float32)
        out = torch.cat(out_parts)
        with tracing.span('render.fetch'):
            return out.cpu().numpy()

    def _mix(self, s, dev0):
        """Render segment ``s``'s slabs, each on its shard's replica, and
        add the voices' (nb, B, 2) contributions into one accumulator on
        ``dev0`` in ascending voice id (None where the segment has no
        voice)."""
        order = sorted(v for _, vs, _ in s.slabs for v in vs)
        held = {}
        pos = 0
        mix = None
        for d, vs, fs in s.slabs:
            disp = self.disps[d]
            out = disp.run(('fused', fs.key, fs.ng, 'f32'),
                           disp.template(fs).fused_body('f32'), disp.st,
                           fs.tables())
            out = out.reshape((fs.V,) + out.shape[-3:])[:, :fs.nb]
            # a graph's static output: the next replay of its key
            # overwrites it, so what is not added now is copied
            fresh = out.device != dev0
            if fresh:
                out = out.to(dev0)
            held.update((v, out[r]) for r, v in enumerate(vs))
            while pos < len(order) and order[pos] in held:
                c = held.pop(order[pos])
                mix = c.clone() if mix is None else mix.add_(c)
                pos += 1
            if not fresh and any(v in held for v in vs):
                out = out.clone()
                held.update((v, out[r]) for r, v in enumerate(vs)
                            if v in held)
        return mix

    def render_i16(self) -> np.ndarray:
        x = np.clip(self.render(), -1.0, 1.0)
        return np.rint(x * np.float32(32767.0)).astype(np.int16)


def _records_body(struct, t):
    """Body of a record range's graph on a replica (sf, si, vdur, the
    range's table buffers)."""
    def body(sf, si, vdur, *bufs):
        st = apply_prepared({'sf': sf, 'si': si, 'vdur': vdur}, struct,
                            t.views(bufs))
        _write_state((sf, si, vdur), st)
    return body


def _seg_end_body(t):
    """Body of the segment-end graph on a replica: the host-authoritative
    columns and the voice durations from the host simulation's end
    tables (the voices' own segments leave them out)."""
    def body(sf, si, vdur, *bufs):
        end = t.views(bufs)
        write_end_tables(sf, si, end)
        vdur.copy_(end['vdur'])
    return body


def default_mesh(devices=None) -> Optional[Mesh]:
    """A ('voices',) mesh over ``devices`` (resolve_devices: every
    visible CUDA device by default), or None for fewer than two."""
    from ..render.engine import resolve_devices
    devs = resolve_devices(devices)
    if len(devs) < 2:
        return None
    return Mesh(devs, ('voices',))


def batches(plan) -> bool:
    """Whether the grouped path renders two voices of ``plan`` on one
    device as rows of one slab: whether an epoch holds two voices of
    one stage signature. A voice's FlatSegment key starts with its
    signature, so where none repeats, every voice is a group of its
    own and renders as a slab of one. Read from the plan alone, before
    any slab table is built."""
    for ep in plan.epochs:
        seen = set()
        for sl in _voice_slices(ep):
            sig = _EpochView(ep, sl.v_lo, sl.v_hi, sl.i_lo, sl.i_hi).sig[0]
            if sig in seen:
                return True
            seen.add(sig)
    return False


class MeshGenerator:
    """sauGenerator_run-compatible generator backed by MeshRender --
    the product path the player selects for a multi-voice flat-eligible
    program: over two or more devices, and on one device where its
    voices batch (io/player.py); the engine renders everything else.
    ``mesh``: as for MeshRender; None means every visible CUDA device,
    or ``device`` alone where given. ``plan`` and ``sim`` as for
    MeshRender. Raises Ineligible (a ValueError) on rejection, like
    MeshRender, and for a program too long to buffer whole."""

    def __init__(self, prg, srate: int, mesh: Optional[Mesh] = None,
                 device=None, plan=None, sim=None):
        if mesh is None and device is None:
            mesh = default_mesh()
        self.mr = MeshRender(prg, srate, mesh=mesh, device=device,
                             plan=plan, sim=sim)
        if self.mr.plan.signal_end > MESH_MAX_BUFFER_SAMPLES:
            raise Ineligible('program too long to buffer whole '
                             '(%d samples)' % self.mr.plan.signal_end)
        self._pre = None
        if os.environ.get('SAUGNS_TPU_MESH_DEBUG'):
            print('# mesh-render: %d voices over %d devices'
                  % (prg.vo_count, len(self.mr.devices)),
                  file=sys.stderr, flush=True)

    def _i16(self, stereo):
        mix = self.mr.render()
        if stereo:
            arr = np.clip(mix, -1.0, 1.0)
            return np.rint(arr * np.float32(32767.0)).astype(np.int16)
        # mono downmix from the float mix (mix_write_mono,
        # sau/generator.c:795-805)
        m = (mix[:, 0] + mix[:, 1]) * np.float32(0.5)
        return np.rint(np.clip(m, -1.0, 1.0)
                       * np.float32(32767.0)).astype(np.int16)

    def run(self, out_i16, buf_len, stereo):
        if self._pre is None:
            self._pre = PrerenderedGenerator(self._i16(stereo), stereo)
        return self._pre.run(out_i16, buf_len, stereo)

    def render_checksum(self):
        """The muted render: the int16 output's sum as an int64 scalar
        on the mesh's first device (TorchGenerator.render_checksum's
        value, on the device where the player's other generators put
        theirs)."""
        arr = self._i16(True)
        return torch.tensor(int(arr.sum(dtype=np.int64)),
                            dtype=torch.int64, device=self.mr.devices[0])
