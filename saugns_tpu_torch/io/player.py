"""Player: pulls generator output and fans out to WAV/AU file, raw
stdout, and (optionally) system audio. Port of saugns.c:471-665.
"""
from __future__ import annotations

import os
import sys

import numpy as np

from .. import tracing
from ..dsp import prim
from .wav import FORMAT_AU, FORMAT_WAV, SndFile

BUF_TIME_MS = 256
CH_MIN_LEN = 1

# option flags shared with cli.py (import cycle avoided by redefining)
OPT_MODE_FULL = 1 << 0
OPT_SYSAU_ENABLE = 1 << 1
OPT_SYSAU_DISABLE = 1 << 2
OPT_AUDIO_MONO = 1 << 3
OPT_AUDIO_STDOUT = 1 << 4
OPT_AUFILE_STDOUT = 1 << 5
OPT_MODE_CHECK = 1 << 6


def _make_generator(prg, srate, devices, plain=False):
    """The port's render backend on ``devices`` (a device or a list of
    them; see render.engine.resolve_devices), for the player, the CLI
    and ``api.render``. A program of more than one voice renders on
    MeshRender's grouped slab path (a MeshGenerator) unless
    SAUGNS_TPU_MESH=0 or ``plain``:

    - with two or more devices, over a ('voices',) mesh of them;
    - on one device, where the compiled-render store has no render of
      it and its voices batch (meshrender.batches), on the plan and
      host sim that the store's lookup built, and counted in the
      ``render.slab_route`` counter of the open request.

    A program it cannot render (its Ineligible error, also a program
    too long to buffer whole) and every other program render on a
    TorchGenerator on the first device. No other error is caught."""
    from ..render.engine import TorchGenerator, resolve_devices
    devs = resolve_devices(devices)
    slabs = os.environ.get('SAUGNS_TPU_MESH', '1') == '1' and not plain \
        and getattr(prg, 'vo_count', 1) > 1
    if slabs and len(devs) > 1:
        from ..parallel.meshrender import Ineligible, MeshGenerator
        from ..parallel.sharding import Mesh
        try:
            return MeshGenerator(prg, srate, Mesh(devs, ('voices',)))
        except Ineligible:
            pass
    gen = TorchGenerator(prg, srate, devs[0], plain=plain)
    if not slabs or len(devs) > 1 or gen.source != 'baked':
        return gen
    from ..parallel.meshrender import Ineligible, MeshGenerator, batches
    if not batches(gen.plan):
        return gen
    try:
        mesh_gen = MeshGenerator(prg, srate, device=gen.device,
                                 plan=gen.plan, sim=gen.sim)
    except Ineligible:
        return gen
    tracing.count('render.slab_route')
    return mesh_gen


class Player:
    def __init__(self, srate, options, wav_path, device=None):
        self.options = options
        # a device or a list of devices (see _make_generator)
        self.device = device
        self.ok = True
        self.sf = None
        self.ad = None
        self.buf = None
        self.ch_count = 1 if options & OPT_AUDIO_MONO else 2
        self.srate = srate
        if options & OPT_MODE_CHECK:
            return
        use_audiodev = ((options & OPT_SYSAU_ENABLE) != 0) if wav_path \
            else ((options & OPT_SYSAU_DISABLE) == 0)
        if use_audiodev:
            from .audiodev import open_audiodev
            self.ad = open_audiodev(self.ch_count, srate)
            if self.ad is None:
                # match reference init_Player: failed audio open
                # aborts the run (saugns.c:504-516, exit status 1)
                self.ok = False
                return
        if wav_path:
            try:
                if options & OPT_AUFILE_STDOUT:
                    self.sf = SndFile(None, FORMAT_AU, self.ch_count,
                                      srate)
                else:
                    self.sf = SndFile(wav_path, FORMAT_WAV, self.ch_count,
                                      srate)
            except OSError:
                print("error: couldn't open %s file \"%s\" for writing"
                      % ('WAV', wav_path), file=sys.stderr)
                self.ok = False
                return
        # dual-generator mode when the device negotiated a different
        # rate while file/stdout output needs the requested rate
        # (saugns.c:518-543)
        self.ad_srate = getattr(self.ad, 'srate', srate) \
            if self.ad is not None else srate
        self.split_gen = False
        if self.ad is not None and self.ad_srate != srate:
            if (options & OPT_AUDIO_STDOUT) or self.sf is not None:
                self.split_gen = True
                print("warning: generating audio twice, using "
                      "different sample rates", file=sys.stderr)
            else:
                self.srate = srate = self.ad_srate
        self.ch_len = max(prim.ms_in_samples(BUF_TIME_MS, srate),
                          CH_MIN_LEN)
        self.buf = np.zeros(self.ch_len * self.ch_count, dtype=np.int16)
        if self.split_gen:
            self.ad_ch_len = max(
                prim.ms_in_samples(BUF_TIME_MS, self.ad_srate),
                CH_MIN_LEN)
            self.ad_buf = np.zeros(self.ad_ch_len * self.ch_count,
                                   dtype=np.int16)

    def run(self, prg, gen=None):
        """Render one program into the sinks. ``gen``: optional
        pre-made run()-compatible generator for ``srate``."""
        if self.options & OPT_MODE_CHECK:
            return True
        stereo = not (self.options & OPT_AUDIO_MONO)
        use_stdout = (self.options & OPT_AUDIO_STDOUT) != 0
        if gen is None:
            gen = _make_generator(prg, self.srate, self.device)
        # muted fast path: no sink consumes samples (-m with no file/
        # stdout), so the render stays on the device and finish()
        # waits for every muted render with one sync
        if (self.ad is None and self.sf is None and not use_stdout
                and not self.split_gen and stereo):
            self._deferred = getattr(self, '_deferred', [])
            self._deferred.append(gen.render_checksum())
            return True
        ad_gen = _make_generator(prg, self.ad_srate, self.device) \
            if self.split_gen else None
        error = False
        more = True
        while more:
            more, out_len = gen.run(self.buf, self.ch_len, stereo)
            length = out_len
            if ad_gen is not None:
                ad_more, ad_len = ad_gen.run(self.ad_buf,
                                             self.ad_ch_len, stereo)
                more = more or ad_more
                if self.ad is not None and \
                        not self.ad.write(self.ad_buf, ad_len):
                    error = True
            elif self.ad is not None:
                if not self.ad.write(self.buf, length):
                    error = True
            if use_stdout:
                sys.stdout.buffer.write(
                    self.buf[:length * self.ch_count].astype('=i2')
                    .tobytes())
            if self.sf is not None:
                if not self.sf.write(self.buf, length):
                    error = True
        return not error

    def finish(self):
        ok = True
        deferred = getattr(self, '_deferred', None)
        if deferred:
            # one sync for every muted render dispatched by run()
            from ..render.engine import force_scalars
            force_scalars(deferred)
            self._deferred = []
        if self.ad is not None:
            self.ad.close()
        if self.sf is not None:
            ok = self.sf.close() == 0
        return ok
