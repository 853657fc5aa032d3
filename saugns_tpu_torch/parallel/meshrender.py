"""The port's slab path: ``MeshRender`` renders any flat-eligible SAU
program in voice slabs, on one device or over a device mesh.

Counterpart of ``saugns_tpu/parallel/meshrender.py``; ``BankRender``
(voicebank.py) is a front over the same slab builder (``voice_slabs``)
and slab body (``slab_body``) for uniform voice banks.

- Each epoch's stage schedule is sliced into per-voice runs (the
  planner emits voices contiguously in ascending id order), each a
  one-voice view of the epoch (``_EpochView``, ``_bake_view``). A
  segment's voices of one signature (one ``FlatSegment`` key) on one
  device render as one ``FlatSegment`` of V voices as V rows
  (``FlatSegment.stack``), as the JAX package vmaps one compile over
  each signature group; a group is cut into slabs by the JAX package's
  bank rule (``slab_width``: at most 256 voices and
  ``SAUGNS_TPU_BANK_SLAB_BUDGET`` output samples, 2^25 by default,
  shrunk to a divisor of the group's voice count). Slabs of one key
  share one captured graph per device (``graphs.Dispatch``).
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
  one zeroed accumulator on the mesh's first device in ascending
  global voice id -- the same left-to-right f32 chain as the engine's
  VMIX stage sequence -- so the mesh render is bit-identical to the
  single-device engine. The slabs render in the order of their first
  voice. A slab on the first device whose voices are the next ones due
  adds them inside its graph (``slab_body``); the outputs of the
  others (one copy a slab) are held until their turn: a segment whose
  signatures or shards interleave in voice id holds up to its voices'
  contributions.

Programs the host sim can't fully bake (self-PM feedback with
SAUGNS_TPU_FLAT_SELFMOD=0, shared state cells, ratio-flip taint) are
rejected with ``Ineligible``, a ValueError: callers render them with
the single-device engine.
"""
from __future__ import annotations

import os
import sys
from dataclasses import dataclass, replace
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import tracing
from ..render.engine import device_setup, resolve_device
from ..render.flat import (END_TABLES, FlatSegment, _write_state,
                           write_end_tables)
from ..render.graphs import Tables
from ..render.hostsim import EpochBake, HostSim
from ..render.plan import Instance, RenderPlan
from ..render.state import apply_prepared, make_state, prepare_records
from .scripts import PrerenderedGenerator
from .sharding import Mesh

# the player buffers a mesh render whole on the host; longer programs
# render on the streaming engine (same cap as multi-script sharding,
# parallel/scripts.py)
MESH_MAX_BUFFER_SAMPLES = 1 << 25
# the widest voice slab, and the default budget of a slab's output
# samples (SAUGNS_TPU_BANK_SLAB_BUDGET), as in the JAX package
SLAB_MAX = 256
SLAB_BUDGET = 1 << 25


def slab_width(n_voices: int, samples_per_voice: int) -> int:
    """Voices a slab of ``n_voices`` voices of ``samples_per_voice``
    output samples each: at most SLAB_MAX and the sample budget
    ``SAUGNS_TPU_BANK_SLAB_BUDGET`` (SLAB_BUDGET by default), shrunk to
    a divisor of ``n_voices`` so that every slab has one shape (the
    JAX package's rule, voicebank.py:386-409 there)."""
    raw = os.environ.get('SAUGNS_TPU_BANK_SLAB_BUDGET', str(SLAB_BUDGET))
    try:
        budget = int(raw)
    except ValueError:
        raise ValueError('SAUGNS_TPU_BANK_SLAB_BUDGET must be an integer '
                         'sample budget, got %r' % raw) from None
    budget = max(budget, 1)
    slab = max(1, min(n_voices, SLAB_MAX,
                      budget // max(samples_per_voice, 1)))
    while n_voices % slab:
        slab -= 1
    return slab


class Ineligible(ValueError):
    """The program cannot render on the mesh path (the JAX package's
    ValueError of the same cases)."""


@dataclass
class _VoiceSlice:
    v_lo: int
    v_hi: int
    i_lo: int
    i_hi: int


def _voice_slices(ep) -> List[_VoiceSlice]:
    """Contiguous per-voice stage/instance runs of an epoch schedule
    (the planner emits voices in ascending id order)."""
    slices: List[_VoiceSlice] = []
    cur_v = None
    for si, s in enumerate(ep.stages):
        if cur_v != s.voice:
            slices.append(_VoiceSlice(si, si, s.inst, s.inst))
            cur_v = s.voice
        sl = slices[-1]
        sl.v_hi = si + 1
        if s.inst >= 0:
            sl.i_lo = min(sl.i_lo, s.inst)
            sl.i_hi = max(sl.i_hi, s.inst + 1)
    return slices


class _EpochView:
    """Single-voice view of one epoch: the stage/instance slice ``sl``
    of one voice with instance ids renumbered, presented with the
    attribute surface FlatSegment consumes. Its records are empty (the
    renderers apply them to the state beforehand)."""

    def __init__(self, ep, sl):
        v_lo, v_hi, i_lo, i_hi = sl.v_lo, sl.v_hi, sl.i_lo, sl.i_hi
        self.block = ep.block
        nb = len(ep.blk_len)
        self.blk_rec_lo = np.zeros(nb, np.int32)
        self.blk_rec_hi = np.zeros(nb, np.int32)
        self.blk_stage_op = np.asarray(ep.blk_stage_op)[:, v_lo:v_hi]
        self.stages = [replace(s, inst=s.inst - i_lo if s.inst >= 0
                               else -1, voice=0)
                       for s in ep.stages[v_lo:v_hi]]
        self.instances = [
            Instance(op=it.op, parent=it.parent - i_lo
                     if it.parent >= 0 else -1, voice=0)
            for it in ep.instances[i_lo:i_hi]]
        stage_sig, inst_src, _scatter = ep.sig
        sig_v = tuple(
            (s[0], s[1] - i_lo if s[1] >= 0 else s[1]) + s[2:11]
            + (s[11] - i_lo if s[11] >= 0 else s[11],) + s[12:]
            for s in stage_sig[v_lo:v_hi])
        src_v = tuple(x - i_lo if x >= 0 else -1
                      for x in inst_src[i_lo:i_hi])
        self.sig = (sig_v, src_v, ())


def _bake_view(bake, sl, inert=False):
    """Slice an EpochBake down to one voice's stages/instances (``sl``):
    the parts FlatSegment reads. ``inert``: every length zeroed (a
    padding voice: no sample renders, no state cell is written
    back)."""
    vb = EpochBake(eligible=True)
    vb.lens = np.asarray(bake.lens)[:, sl.i_lo:sl.i_hi]
    if inert:
        vb.lens = np.zeros_like(vb.lens)
    vb.stages = {si - sl.v_lo: bake.stages[si]
                 for si in range(sl.v_lo, sl.v_hi) if si in bake.stages}
    return vb


def voice_slabs(plan, ep, bake, seg, voices, srate, device, piluts,
                plain=False):
    """The slabs of the voices ``voices`` (ascending voice ids; an id
    past the epoch's last voice: an inert copy of that voice, which
    renders exact zeros and writes nothing back) in segment ``seg`` of
    epoch ``ep`` on ``device``: one one-voice FlatSegment a voice,
    without the segment-end tables (the callers write them once a
    segment, or not at all), each run of one key cut into slabs by
    slab_width and stacked (``FlatSegment.stack``). Returns [(voice
    ids, FlatSegment)] in the order of their first voice; their tables
    are not uploaded (``prepare()``)."""
    slices = {ep.stages[sl.v_lo].voice: sl for sl in _voice_slices(ep)}
    last = max(slices, default=-1)
    groups = {}
    for v in voices:
        sl = slices[min(v, last)]
        fs = FlatSegment(plan, _EpochView(ep, sl),
                         _bake_view(bake, sl, inert=v > last), seg, srate,
                         device, piluts, plain=plain, end_tables=False)
        groups.setdefault(fs.key, []).append((v, fs))
    slabs = []
    for members in groups.values():
        fs0 = members[0][1]
        width = slab_width(len(members), fs0.nb * fs0.B)
        for k in range(0, len(members), width):
            part = members[k:k + width]
            slabs.append(([v for v, _ in part],
                          FlatSegment.stack([m for _, m in part])))
    return sorted(slabs, key=lambda x: x[0][0])


def slab_body(tmpl, ordered):
    """Body of a slab's graph: the slab's whole segment (V voices), then
    its voices added into the accumulator ``acc`` (the padded length of
    the segment, on the slab's device): one by one in ascending voice
    id (the ordered chain), or their tree sum."""
    fused = tmpl.fused_body('f32')

    def body(acc, *args):
        out = fused(*args).reshape(tmpl.V, -1, 2)
        if not ordered:
            acc.add_(out.sum(0))
            return
        for k in range(tmpl.V):
            acc.add_(out[k])
    return body


def mesh_devices(mesh):
    """The device of each 'voices' shard of ``mesh`` (the first along
    any other axis)."""
    devs = np.asarray(mesh.devices, dtype=object)
    ax = mesh.axis_names.index('voices')
    devs = np.moveaxis(devs, ax, 0).reshape(devs.shape[ax], -1)
    return [d[0] for d in devs]


def sum_stats(disps):
    """The dispatches' graph counts, summed (see TorchGenerator)."""
    tot = {}
    for disp in disps:
        for k, v in disp.stats().items():
            tot[k] = tot.get(k, 0) + v
    return tot


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
    over every epoch (voices that must render on one device). Raises
    Ineligible for an operator of two voices of one epoch: an op bound
    into several voices' graphs would make voice rows non-disjoint, and
    the per-voice write-back requires ownership."""
    parent: Dict[int, int] = {}

    def find(v):
        parent.setdefault(v, v)
        while parent[v] != v:
            parent[v] = parent[parent[v]]
            v = parent[v]
        return v
    op_voice: Dict[int, int] = {}
    for ep in plan.epochs:
        owner = {}
        for s in ep.stages:
            find(s.voice)
            if s.op < 0:
                continue
            if owner.setdefault(s.op, s.voice) != s.voice:
                raise Ineligible('operator %d shared across voices' % s.op)
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
        self.srate = srate
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
        comp = _owner_components(self.plan)
        self.devices = [resolve_device(device)] if mesh is None \
            else mesh_devices(mesh)
        # voice -> shard, by global voice id: round robin over the
        # voices (and voices sharing an operator across epochs) in
        # ascending order
        roots = sorted(set(comp.values()))
        slot = {r: k % len(self.devices) for k, r in enumerate(roots)}
        self.shard_of = {v: slot[r] for v, r in comp.items()}
        self._accs = {}
        self._ready = False

    def _build(self):
        """Per shard: the state replica and its dispatch; per segment:
        each shard's signature groups in slabs, the record and end
        tables on every shard. Spans: ``plan.build`` the segments and
        their host tables, ``plan.upload`` the rest."""
        setups = []
        for dev in self.devices:
            with tracing.span('plan.upload'):
                st = make_state(self.plan, dev)
            setups.append(device_setup(dev, st, self.plain, self.graphs))
        piluts = [p for p, _ in setups]
        self.disps = [d for _, d in setups]
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
        ids = [ep.stages[sl.v_lo].voice for sl in _voice_slices(ep)]
        segs = []
        for seg in bake.segments:
            slabs = [(d, vs, fs) for d, dev in enumerate(self.devices)
                     for vs, fs in voice_slabs(
                         self.plan, ep, bake, seg,
                         [v for v in ids if self.shard_of[v] == d],
                         self.srate, dev, piluts[d], self.plain)]
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
        return sum_stats(self.disps)

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
                mix = self._mix(s, dev0) if s.slabs else None
                for d in range(len(self.devices)):
                    self._seg_end(d, s)
                parts = []
                for k in range(hi - lo):
                    blen = int(blk_len[lo + k])
                    if blen > 0:  # no active voices: silence
                        parts.append(
                            torch.zeros((blen, 2), dtype=torch.float32,
                                        device=dev0) if mix is None
                            else mix[k, :blen])
                        pos += blen
                if parts:
                    # a copy: a later segment may reuse the accumulator
                    out_parts.append(torch.cat(parts))
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
        add the voices' contributions into a zeroed accumulator on
        ``dev0`` in ascending voice id; returns its (nb, B, 2) rows. The
        accumulator is one a padded segment length (a graph binds it),
        so a later segment of that length reuses it."""
        fs0 = s.slabs[0][2]
        n = fs0.nch * fs0.nc * fs0.B
        acc = self._accs.get(n)
        if acc is None:
            acc = self._accs[n] = torch.empty((n, 2), dtype=torch.float32,
                                              device=dev0)
        acc.zero_()
        rows = acc.view(-1, fs0.B, 2)
        order = sorted(v for _, vs, _ in s.slabs for v in vs)
        held = {}
        pos = 0
        for d, vs, fs in s.slabs:
            disp = self.disps[d]
            tmpl = disp.template(fs)
            if self.devices[d] == dev0 and vs == order[pos:pos + len(vs)]:
                disp.run(('slab', fs.key, fs.ng, True),
                         slab_body(tmpl, True), (acc,) + disp.st,
                         fs.tables())
                pos += len(vs)
            else:
                out = disp.run(('fused', fs.key, fs.ng, 'f32'),
                               tmpl.fused_body('f32'), disp.st,
                               fs.tables())
                # a graph's static output: the next replay of its key
                # overwrites it, so it is copied
                out = out.reshape((fs.V,) + out.shape[-3:]).to(
                    dev0, copy=True)
                held.update((v, out[r]) for r, v in enumerate(vs))
            while pos < len(order) and order[pos] in held:
                rows.add_(held.pop(order[pos]))
                pos += 1
        return rows[:fs0.nb]

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
            sig = _EpochView(ep, sl).sig[0]
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
