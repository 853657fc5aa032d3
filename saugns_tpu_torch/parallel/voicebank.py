"""Voice-sharded rendering of uniform voice banks: ``BankRender``.

Counterpart of ``saugns_tpu/parallel/voicebank.py``. The reference's
only cross-voice interaction is the stereo mix (sau/generator.c:
749-788), so voices are the natural data-parallel axis. A compiled
Program -- parsed by the real frontend, planned by RenderPlan,
state-baked by HostSim -- whose voices share one schedule template
(the shape of ``make_bank_script``'s banks) renders in voice slabs:

- The plan's per-voice stage schedules are checked for structural
  uniformity (same template modulo operator/instance renumbering).
- The voices are cut into slabs (``slab_width``, the JAX package's
  rule: at most 256 voices and ``SAUGNS_TPU_BANK_SLAB_BUDGET`` output
  samples, 2^25 by default, shrunk to a divisor of the voice count),
  and a slab is one ``FlatSegment`` of V voices as V rows
  (``FlatSegment.stack``): one stage loop whose kernels run once over
  the slab's rows, as the JAX package vmaps one compile over the voice
  axis. Every slab of a device replays one captured graph with that
  slab's tables copied in (``graphs.Dispatch``).
- Over a mesh, voices are cut into contiguous ascending ranges, one per
  ``'voices'`` shard (padded with inert voices to a multiple of the
  shard count), and each shard renders its range in slabs on its own
  device; one process drives every device, each shard's work is queued
  asynchronously.

The mix, inside each slab's graph: the ordered mix continues the
engine's left-to-right VMIX chain in ascending voice id, across the
slab's rows and from slab to slab (bit-identical to the engine).
Across shards, ``mesh_mix='psum'`` sums each shard's partial in device
order on the first device (f32 adds reassociate, within an LSB), and
``'ring'`` hands the running partial from shard to shard (``copy_``, a
peer copy between cards), each continuing the chain with its own
voices: bit-identical to one device. The ring's shards therefore
render one after another; the psum's render at once.
``ordered_mix=False`` adds each slab's tree sum (``torch.sum``), as the
JAX package's unordered mix does.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .. import tracing
from ..render import tdsp
from ..render.flat import FlatSegment
from ..render.graphs import Dispatch
from ..render.hostsim import EpochBake, HostSim, SegBake
from ..render.plan import Instance, RenderPlan, Stage
from ..render.state import _to_i16_device, apply_records, make_state

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


def make_bank_script(n_voices: int, seed: int = 0,
                     duration: float = 1.0) -> str:
    """Generate a real SAU script: an n-voice PM bank (carrier with
    one phase modulator each, spread over pitch/index/pan). Parses
    through the ordinary frontend into n independent voices."""
    rng = np.random.RandomState(seed)
    lines = ['S a.m%.3f' % (1.0 / max(n_voices, 1))]
    for v in range(n_voices):
        freq = 110.0 * 2.0 ** (rng.randint(0, 36) / 12.0)
        ratio = rng.choice([0.5, 1.0, 1.5, 2.0, 3.0])
        index = rng.uniform(0.2, 1.5)
        pan = rng.uniform(-1.0, 1.0)
        lines.append(
            'Wsin f%.2f t%.3f a1 c%.3f p[Wsin r%.2f a%.3f]'
            % (freq, duration, pan, ratio, index))
    return '\n'.join(lines) + '\n'


def make_selfmod_bank_script(n_voices: int, seed: int = 0,
                             duration: float = 1.0) -> str:
    """n-voice bank where every carrier uses phase SELF-modulation
    ("feedback FM", wosc.h:273-310) with a per-voice strength --
    the structure of examples/sounds/bass-sounds.sau, uniform across
    voices."""
    rng = np.random.RandomState(seed)
    lines = ['S a.m%.3f' % (1.0 / max(n_voices, 1))]
    for v in range(n_voices):
        freq = 55.0 * 2.0 ** (rng.randint(0, 24) / 12.0)
        strength = rng.uniform(0.1, 0.6)
        pan = rng.uniform(-1.0, 1.0)
        lines.append('Wsin f%.2f t%.3f a1 c%.3f p.a%.3f'
                     % (freq, duration, pan, strength))
    return '\n'.join(lines) + '\n'


class _EpochView:
    """Single-voice view of one epoch: the stage/instance slice of one
    voice with instance ids renumbered, presented with the attribute
    surface FlatSegment consumes. Its records are empty (the renderers
    apply them to the state beforehand)."""

    def __init__(self, ep, v_lo, v_hi, i_lo, i_hi):
        self.block = ep.block
        self.blk_len = ep.blk_len
        nb = len(ep.blk_len)
        self.blk_rec_lo = np.zeros(nb, np.int32)
        self.blk_rec_hi = np.zeros(nb, np.int32)
        self.blk_stage_op = np.asarray(ep.blk_stage_op)[:, v_lo:v_hi]
        self.blk_inst_op = np.asarray(ep.blk_inst_op)[:, i_lo:i_hi]
        self.stages = []
        for s in ep.stages[v_lo:v_hi]:
            s2 = Stage(**{k: getattr(s, k) for k in
                          ('kind', 'inst', 'op', 'dst', 'a', 'b', 'c',
                           'line', 'wave_env', 'layer', 'skip_line',
                           'voice', 'freq_buf_id', 'wave', 'ntype',
                           'ltype', 'ras')})
            s2.inst = s.inst - i_lo if s.inst >= 0 else -1
            s2.voice = 0
            self.stages.append(s2)
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


def _bake_view(bake, sl, view, src_seg=None, inert=False):
    """Slice an EpochBake down to one voice's stages/instances.
    ``src_seg``: the segment to mirror (default: the single segment
    of a bank epoch); its block range and end-state tables carry
    over -- end tables are global (n_ops ...) and identical across
    voice views. ``inert``: every length zeroed (a padding voice: no
    sample renders, no state cell is written back)."""
    vb = EpochBake(eligible=True)
    vb.lens = np.asarray(bake.lens)[:, sl.i_lo:sl.i_hi]
    if inert:
        vb.lens = np.zeros_like(vb.lens)
    vb.gates = np.asarray(bake.gates)[:, sl.i_lo:sl.i_hi]
    vb.stages = {si - sl.v_lo: bake.stages[si]
                 for si in range(sl.v_lo, sl.v_hi) if si in bake.stages}
    src = bake.segments[0] if src_seg is None else src_seg
    seg = SegBake(lo=src.lo if src_seg is not None else 0,
                  hi=src.hi if src_seg is not None
                  else len(view.blk_len), eligible=True)
    for k in ('end_lv0', 'end_lvt', 'end_lpos', 'end_lend',
              'end_ltype', 'end_lflags', 'end_time', 'end_tinf',
              'end_vdur'):
        setattr(seg, k, getattr(src, k))
    vb.segments = [seg]
    return vb


class BankPlan:
    """Uniformity analysis + per-voice flat segments for a Program
    whose voices share one schedule template."""

    def __init__(self, prg, srate):
        self.prg = prg
        self.srate = srate
        self.plan = RenderPlan(prg, srate)
        self.sim = HostSim(self.plan)
        self.ok, self.why = self._analyze()

    def _analyze(self):
        plan = self.plan
        # main epoch = the last one (bank scripts: all records at t=0,
        # one rendering epoch); all earlier epochs must be empty
        self.main_ei = len(plan.epochs) - 1
        for ep in plan.epochs[:-1]:
            if ep.start != ep.end:
                return False, 'multiple rendering epochs'
        ep = plan.epochs[-1]
        bake = self.sim.bakes[-1]
        if not bake.eligible or len(bake.segments) != 1:
            return False, 'main epoch not a single flat segment: ' \
                + bake.reason
        self.slices = _voice_slices(ep)
        views = [_EpochView(ep, sl.v_lo, sl.v_hi, sl.i_lo, sl.i_hi)
                 for sl in self.slices]
        sig0 = views[0].sig
        for v in views[1:]:
            if v.sig != sig0:
                return False, 'voices are not structurally uniform'
        self.views = views
        self.n_voices = len(views)
        # every record lands at t=0: the range up to the main epoch's
        # first block
        self.rec_hi = int(ep.blk_rec_hi[0])
        return True, ''

    def segment(self, k, device, piluts, plain=False, inert=False):
        """The one-voice FlatSegment of voice ``k`` on ``device``
        (``inert``: a padding copy of it that renders nothing). The
        port's default chunking applies. It leaves out the segment-end
        tables: nothing reads the state after a bank's one segment."""
        bake = self.sim.bakes[self.main_ei]
        vb = _bake_view(bake, self.slices[k], self.views[k], inert=inert)
        return FlatSegment(self.plan, self.views[k], vb, vb.segments[0],
                           self.srate, device, piluts, plain=plain,
                           end_tables=False)

    def slab(self, ks, device, piluts, plain=False):
        """The FlatSegment of the voices ``ks`` as rows, in order (a
        voice id past the last voice: an inert copy of the last), its
        tables uploaded to ``device``."""
        last = self.n_voices - 1
        with tracing.span('plan.build'):
            seg = FlatSegment.stack([
                self.segment(min(k, last), device, piluts, plain,
                             inert=k > last) for k in ks])
        with tracing.span('plan.upload'):
            seg.prepare()
        return seg

    def samples_per_voice(self):
        ep = self.plan.epochs[self.main_ei]
        return len(ep.blk_len) * ep.block

    def n_valid(self):
        ep = self.plan.epochs[self.main_ei]
        return int(np.sum(np.asarray(ep.blk_len)))


class _Shard:
    """One 'voices' shard: its device, its voice slabs, the dispatch
    that renders them on its own copy of the state, and its partial of
    the mix."""

    def __init__(self, device, slabs, disp, length):
        self.device = device
        self.slabs = slabs
        self.disp = disp
        self.acc = torch.zeros((length, 2), dtype=torch.float32,
                               device=device)


def _mesh_devices(mesh):
    """The device of each 'voices' shard of ``mesh`` (the first along
    any other axis)."""
    devs = np.asarray(mesh.devices, dtype=object)
    ax = mesh.axis_names.index('voices')
    devs = np.moveaxis(devs, ax, 0).reshape(devs.shape[ax], -1)
    return [d[0] for d in devs]


class BankRender:
    """Renders a uniform-voice Program over a device mesh.

    ``mesh``: a Mesh with a 'voices' axis (parallel.sharding.Mesh), or
    None for one device (``device``, CUDA by default). ``ordered_mix``
    (default True) keeps the engine's left-to-right voice chain;
    ``mesh_mix``: 'psum' or 'ring' across shards (see the module
    docstring). ``plain`` renders with the plain versions of the
    kernels; ``graphs=False`` runs the same bodies op by op on CUDA
    (the eager A/B), as for TorchGenerator."""

    def __init__(self, prg, srate, mesh=None,
                 ordered_mix: Optional[bool] = None,
                 mesh_mix: str = 'psum', device=None, plain=False,
                 graphs=True):
        from ..render.engine import resolve_device
        if mesh_mix not in ('psum', 'ring'):
            raise ValueError('mesh_mix must be psum or ring, got %r'
                             % (mesh_mix,))
        with tracing.span('plan.build'):
            self.bp = BankPlan(prg, srate)
        if not self.bp.ok:
            raise ValueError('program is not a uniform voice bank: '
                             + self.bp.why)
        self.mesh = mesh
        self.mesh_mix = mesh_mix
        self.ordered_mix = True if ordered_mix is None else ordered_mix
        self.plain = plain
        self.graphs = graphs
        self.devices = [resolve_device(device)] if mesh is None \
            else _mesh_devices(mesh)
        self._shards = None

    def prepare(self):
        """Everything a render needs before its device work, once: the
        kernels, each shard's wave tables, post-record state, voice
        slabs and their tables, and mix buffer."""
        if self._shards is not None:
            return self._shards
        from ..render.engine import init_process
        bp = self.bp
        n = len(self.devices)
        per = -(-bp.n_voices // n)
        width = slab_width(per, bp.samples_per_voice())
        shards = []
        for d, dev in enumerate(self.devices):
            cuda = dev.type == 'cuda'
            if cuda and not self.plain:
                from .. import kernels
                kernels.build()
            init_process(dev)
            with tracing.span('plan.upload'):
                piluts = tdsp.wave_tables(dev)[1]
            # voices d*per .. (d+1)*per - 1; past the last voice, inert
            # copies of it (lengths zeroed: an exact zero contribution)
            slabs = [bp.slab(range(k, k + width), dev, piluts, self.plain)
                     for k in range(d * per, (d + 1) * per, width)]
            with tracing.span('plan.upload'):
                st = apply_records(make_state(bp.plan, dev), 0, bp.rec_hi,
                                   bp.plan.rec_arrays)
                static = not self.plain and (self.graphs or not cuda)
                disp = Dispatch(dev, static, static and cuda,
                                tuple(st[k].contiguous()
                                      for k in ('sf', 'si', 'vdur')))
            s0 = slabs[0]
            shards.append(_Shard(dev, slabs, disp, s0.nch * s0.nc * s0.B))
        self._shards = shards
        return shards

    def graph_stats(self):
        """The shards' graph counts, summed (see TorchGenerator)."""
        tot = {}
        for sh in self.prepare():
            for k, v in sh.disp.stats().items():
                tot[k] = tot.get(k, 0) + v
        return tot

    def _slab(self, sh, seg):
        """Render shard ``sh``'s slab ``seg`` and add its voices into
        the shard's partial: one graph, the slab's whole segment and the
        adds."""
        disp = sh.disp
        tmpl = disp.template(seg)
        disp.run(('bank', seg.key, seg.ng, self.ordered_mix),
                 _mixed(tmpl, self.ordered_mix), (sh.acc,) + disp.st,
                 seg.tables())

    @tracing.traced('render.bank')
    def render(self):
        """Full render -> (n_samples, 2) f32 stereo mix on the first
        device."""
        shards = self.prepare()
        for sh in shards:
            sh.disp.reset()
            sh.acc.zero_()
        dev0 = shards[0].device
        if len(shards) > 1 and self.mesh_mix == 'ring':
            # shard d takes the running partial from shard d - 1 and
            # continues the left-to-right chain with its own voices:
            # the single-device chain, bit for bit
            for d, sh in enumerate(shards):
                if d:
                    sh.acc.copy_(shards[d - 1].acc)
                for seg in sh.slabs:
                    self._slab(sh, seg)
            mix = shards[-1].acc.to(dev0, copy=True)
        else:
            # slab k of every shard, then k + 1: each device gets work
            # queued from the start; then the shards' partials summed
            # in device order on the first device ('psum', or one shard)
            for k in range(len(shards[0].slabs)):
                for sh in shards:
                    self._slab(sh, sh.slabs[k])
            mix = shards[0].acc.clone()
            for sh in shards[1:]:
                mix += sh.acc.to(dev0)
        return mix[:self.bp.n_valid()]

    def render_i16(self):
        """Full render -> (n_samples, 2) int16 on the first device."""
        return _to_i16_device(self.render())


def _mixed(tmpl, ordered):
    """Body of a slab's graph: the slab's whole segment (V voices), then
    its voices added into the shard's partial ``acc``: one by one in
    ascending voice id (the ordered chain), or their tree sum."""
    fused = tmpl.fused_body('f32')

    def body(acc, *args):
        out = fused(*args).reshape(tmpl.V, -1, 2)
        if not ordered:
            acc.add_(out.sum(0))
            return
        for k in range(tmpl.V):
            acc.add_(out[k])
    return body
