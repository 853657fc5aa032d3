"""Voice-sharded rendering of uniform voice banks: ``BankRender``.

Counterpart of ``saugns_tpu/parallel/voicebank.py``. The reference's
only cross-voice interaction is the stereo mix (sau/generator.c:
749-788), so voices are the natural data-parallel axis. ``BankRender``
is a front over the port's one slab path (meshrender.py: the slab
builder ``voice_slabs``, the slab rule ``slab_width``, the slab body
``slab_body``) for a compiled Program -- parsed by the real frontend,
planned by RenderPlan, state-baked by HostSim -- whose voices share
one schedule template (the shape of ``make_bank_script``'s banks).
What it adds:

- The plan's per-voice stage schedules are checked for structural
  uniformity (same template modulo operator/instance renumbering).
- Over a mesh, voices are cut into contiguous ascending ranges, one per
  ``'voices'`` shard (padded with inert voices to a multiple of the
  shard count), and each shard renders its range in slabs of one
  width on its own device; one process drives every device, each
  shard's work is queued asynchronously. Every slab of a device
  replays one captured graph with that slab's tables copied in.
- The mix across shards. Inside each slab's graph the ordered mix
  continues the engine's left-to-right VMIX chain in ascending voice
  id, across the slab's rows and from slab to slab (bit-identical to
  the engine). Across shards, ``mesh_mix='psum'`` sums each shard's
  partial in device order on the first device (f32 adds reassociate,
  within an LSB), and ``'ring'`` hands the running partial from shard
  to shard (``copy_``, a peer copy between cards), each continuing the
  chain with its own voices: bit-identical to one device. The ring's
  shards therefore render one after another; the psum's render at
  once. ``ordered_mix=False`` adds each slab's tree sum
  (``torch.sum``), as the JAX package's unordered mix does.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import tracing
from ..render.engine import device_setup, resolve_device
from ..render.hostsim import HostSim
from ..render.plan import RenderPlan
from ..render.state import _to_i16_device, apply_records, make_state
from .meshrender import (_EpochView, _voice_slices, mesh_devices,
                         slab_body, slab_width, sum_stats, voice_slabs)


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
        if mesh_mix not in ('psum', 'ring'):
            raise ValueError('mesh_mix must be psum or ring, got %r'
                             % (mesh_mix,))
        self.srate = srate
        with tracing.span('plan.build'):
            self.plan = RenderPlan(prg, srate)
            self.sim = HostSim(self.plan)
            why = self._analyze()
        if why:
            raise ValueError('program is not a uniform voice bank: ' + why)
        self.mesh_mix = mesh_mix
        self.ordered_mix = True if ordered_mix is None else ordered_mix
        self.plain = plain
        self.graphs = graphs
        self.devices = [resolve_device(device)] if mesh is None \
            else mesh_devices(mesh)
        self._shards = None

    def _analyze(self):
        """Why the program is not a uniform bank ('' where it is)."""
        plan = self.plan
        # main epoch = the last one (bank scripts: all records at t=0,
        # one rendering epoch); all earlier epochs must be empty
        for ep in plan.epochs[:-1]:
            if ep.start != ep.end:
                return 'multiple rendering epochs'
        self.ep = ep = plan.epochs[-1]
        bake = self.sim.bakes[-1]
        if not bake.eligible or len(bake.segments) != 1:
            return 'main epoch not a single flat segment: ' + bake.reason
        sigs = [_EpochView(ep, sl).sig for sl in _voice_slices(ep)]
        if any(s != sigs[0] for s in sigs):
            return 'voices are not structurally uniform'
        self.n_voices = len(sigs)
        # every record lands at t=0: the range up to the main epoch's
        # first block
        self.rec_hi = int(ep.blk_rec_hi[0])
        return ''

    def samples_per_voice(self):
        return len(self.ep.blk_len) * self.ep.block

    def n_valid(self):
        return int(np.sum(np.asarray(self.ep.blk_len)))

    def prepare(self):
        """Everything a render needs before its device work, once: the
        kernels, each shard's wave tables, post-record state, voice
        slabs and their tables, and mix buffer."""
        if self._shards is not None:
            return self._shards
        plan, bake = self.plan, self.sim.bakes[-1]
        n = len(self.devices)
        per = -(-self.n_voices // n)
        width = slab_width(per, self.samples_per_voice())
        shards = []
        for d, dev in enumerate(self.devices):
            with tracing.span('plan.upload'):
                st = apply_records(make_state(plan, dev), 0, self.rec_hi,
                                   plan.rec_arrays)
            piluts, disp = device_setup(dev, st, self.plain, self.graphs)
            # voices d*per .. (d+1)*per - 1; past the last voice, inert
            # copies of it (lengths zeroed: an exact zero contribution)
            voices = range(d * per, (d + 1) * per)
            with tracing.span('plan.build'):
                slabs = voice_slabs(plan, self.ep, bake, bake.segments[0],
                                    voices, self.srate, dev, piluts,
                                    self.plain)
            if [vs for vs, _ in slabs] != [list(voices[k:k + width])
                                           for k in range(0, per, width)]:
                raise ValueError('program is not a uniform voice bank: '
                                 'its voices render under several keys')
            slabs = [fs for _, fs in slabs]
            with tracing.span('plan.upload'):
                for fs in slabs:
                    fs.prepare()
            s0 = slabs[0]
            shards.append(_Shard(dev, slabs, disp, s0.nch * s0.nc * s0.B))
        self._shards = shards
        return shards

    def graph_stats(self):
        """The shards' graph counts, summed (see TorchGenerator)."""
        return sum_stats(sh.disp for sh in self.prepare())

    def _slab(self, sh, seg):
        """Render shard ``sh``'s slab ``seg`` and add its voices into
        the shard's partial: one graph, the slab's whole segment and the
        adds."""
        disp = sh.disp
        disp.run(('slab', seg.key, seg.ng, self.ordered_mix),
                 slab_body(disp.template(seg), self.ordered_mix),
                 (sh.acc,) + disp.st, seg.tables())

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
        return mix[:self.n_valid()]

    def render_i16(self):
        """Full render -> (n_samples, 2) int16 on the first device."""
        return _to_i16_device(self.render())
