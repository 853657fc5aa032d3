"""Render engine of the port: ``TorchGenerator``.

Counterpart of ``saugns_tpu.render.engine.JaxGenerator``: a Program is
planned (``RenderPlan``), its scalar state machine is baked on the
host (``HostSim``), and every epoch renders as flat segments on the
chosen device, then converts to int16 there. It serves the same
``run(out_i16, buf_len, stereo)`` pull contract as the reference's
generator.

Only flat-eligible programs render here: every stage kind (wave and
RasG oscillators, noise, self-PM, modulation, mixing) is ported, but a
program with an epoch that ``HostSim`` cannot bake raises
``NotImplementedError`` when the generator is made (the sequential
engine is not ported yet).
"""
from __future__ import annotations

import numpy as np
import torch

from ..lang import program as P
from . import tdsp
from .flat import FlatSegment
from .hostsim import HostSim
from .plan import BLOCK, RenderPlan
from .state import _to_i16_device, _to_i16_mono_device, make_state


def resolve_device(device=None):
    """The device to render on: ``device`` when given, else CUDA.
    Raises RuntimeError when CUDA is asked for (or defaulted to) and
    not available; the CPU is used only when asked for."""
    dev = torch.device(device if device is not None else 'cuda')
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'saugns_tpu_torch renders on CUDA, and no CUDA device is '
            'available; pass device="cpu" (CLI: '
            'SAUGNS_TPU_TORCH_DEVICE=cpu) to render on the CPU')
    return dev


class TorchGenerator:
    """Generator-compatible renderer on one torch device.

    ``plain=True`` renders with the plain PyTorch versions of the
    hand-written kernels on any device: the reference that the kernel
    path is held against. ``piluts`` (a (12, 2048) float32 tensor) and
    ``state`` (the initial packed state) replace the port's own, so a
    test can feed both renderers identical inputs (see convert.py)."""

    def __init__(self, prg: P.Program, srate: int, device=None,
                 block: int = BLOCK, plain: bool = False,
                 piluts=None, state=None):
        self.device = resolve_device(device)
        self.prg = prg
        self.srate = srate
        self.plain = plain
        self._tables = piluts
        self._state0 = state
        self.plan = RenderPlan(prg, srate, block)
        self._sim = HostSim(self.plan)
        for ei, (ep, bake) in enumerate(zip(self.plan.epochs,
                                            self._sim.bakes)):
            if not len(ep.blk_len):
                continue
            if not bake.eligible:
                raise NotImplementedError(
                    'epoch %d: not flat-renderable (%s); the sequential '
                    'engine is not ported to saugns_tpu_torch yet'
                    % (ei, bake.reason or 'segment-ineligible'))
        self._flat = [None] * len(self.plan.epochs)
        self._rendered = None

    def _flat_epoch(self, ei):
        """Flat segment renderers of epoch ``ei`` (empty for an epoch
        without blocks)."""
        if self._flat[ei] is None:
            ep = self.plan.epochs[ei]
            if not len(ep.blk_len):
                self._flat[ei] = []
                return self._flat[ei]
            if self._tables is None:
                self._tables = tdsp.wave_tables(self.device)[1]
            bake = self._sim.bakes[ei]
            self._flat[ei] = [
                FlatSegment(self.plan, ep, bake, seg, self.srate,
                            self.device, self._tables, plain=self.plain)
                for seg in bake.segments]
        return self._flat[ei]

    def _initial_state(self):
        if self._state0 is not None:
            return dict(self._state0)
        return make_state(self.plan, self.device)

    def render_device(self):
        """Run the full render; returns the per-segment int16 blocks
        (n_blocks, B, 2) as device tensors, in timeline order."""
        st = self._initial_state()
        pieces = []
        for ei in range(len(self.plan.epochs)):
            for seg in self._flat_epoch(ei):
                st, outs = seg.run(st)
                pieces.append(_to_i16_device(outs))
        return pieces

    def render_checksum(self):
        """Render and return an on-device scalar checksum of the
        output (nothing fetched): the muted (``-m``) render."""
        return sum(p.to(torch.int64).sum() for p in self.render_device())

    def assemble(self, pieces):
        """Host (signal_end, 2) int16 timeline from render_device()
        output: trims per-block padding and restores leading-gap
        silence."""
        out = np.zeros((self.plan.signal_end, 2), np.int16)
        pos = 0
        it = iter(pieces)
        for ei, ep in enumerate(self.plan.epochs):
            if ep.start > pos:
                pos = int(ep.start)  # leading gap stays silent
            for seg in self._flat_epoch(ei):
                arr = next(it).cpu().numpy()
                for k in range(seg.lo, seg.lo + seg.nb):
                    blen = int(ep.blk_len[k])
                    if blen > 0:
                        out[pos:pos + blen] = arr[k - seg.lo, :blen]
                        pos += blen
        if pos != self.plan.signal_end:
            raise RuntimeError('rendered %d samples of %d'
                               % (pos, self.plan.signal_end))
        return out

    def _stream_i16(self, stereo):
        """Yield host int16 arrays -- (n, 2) stereo or (n,) mono --
        covering the timeline in order, one chunk group at a time. The
        mono downmix happens on the device from the float stereo mix,
        as mix_write_mono does (generator.c:795-805)."""
        st = self._initial_state()
        conv = _to_i16_device if stereo else _to_i16_mono_device
        pos = 0
        for ei, ep in enumerate(self.plan.epochs):
            if ep.start > pos:
                gap = int(ep.start) - pos
                yield np.zeros((gap, 2) if stereo else gap, np.int16)
                pos = int(ep.start)
            for seg in self._flat_epoch(ei):
                bi = int(seg.lo)
                for kind, val, nv in seg.stream(st):
                    if kind == 'st':
                        st = val
                        continue
                    arr = conv(val.reshape(-1, seg.B, 2)[:nv]) \
                        .cpu().numpy()
                    for k in range(nv):
                        blen = int(ep.blk_len[bi + k])
                        if blen > 0:
                            yield arr[k, :blen]
                            pos += blen
                    bi += nv
        if pos != self.plan.signal_end:
            raise RuntimeError('rendered %d samples of %d'
                               % (pos, self.plan.signal_end))

    def run(self, out_i16, buf_len, stereo):
        """sauGenerator_run-compatible chunked delivery."""
        if self._rendered is None:
            self._stream = self._stream_i16(stereo)
            self._pending = None
            self._left = self.plan.signal_end
            self._rendered = (True, stereo)
        elif self._rendered[1] != stereo:
            raise ValueError('stereo flag changed between run() calls')
        out_i16[:] = 0
        n = 0
        while n < buf_len and self._left > 0:
            if self._pending is None or len(self._pending) == 0:
                try:
                    self._pending = next(self._stream)
                except StopIteration:
                    break
            take = min(buf_len - n, len(self._pending))
            part = self._pending[:take]
            if stereo:
                out_i16[n * 2:(n + take) * 2:2] = part[:, 0]
                out_i16[n * 2 + 1:(n + take) * 2:2] = part[:, 1]
            else:
                out_i16[n:n + take] = part
            self._pending = self._pending[take:]
            self._left -= take
            n += take
        if self._left <= 0:
            return False, n
        return True, buf_len
