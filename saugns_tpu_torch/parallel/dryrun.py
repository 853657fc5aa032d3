"""A dry run of the multi-device path: ``dryrun_multichip(devices)``.

Counterpart of the JAX package's ``dryrun_multichip``
(``__graft_entry__.py``), its four checks at its sizes (6 kHz, 1 s),
each against the single-device engine (``TorchGenerator`` on the first
device), bit for bit:

1. a ``2n``-voice PM bank through ``BankRender`` over the n devices
   with the ring mix;
2. the 3-voice heterogeneous program (FM wave, noise, RasG) through
   ``MeshRender``;
3. 13 voices on the n devices (padded with inert voices), ring mix;
4. the time axis: a four-note PM sequence through ``TimeShardRender``
   (with graphs, its default: on CUDA each segment key's pieces
   between exchanges captured once and replayed), each segment's block
   rows split over the n devices.

A device may repeat (virtual shards). Prints one line per check;
raises AssertionError on a mismatch.

    python -m saugns_tpu_torch.parallel.dryrun cpu,cpu,cpu,cpu
"""
from __future__ import annotations

import sys

import numpy as np

SRATE = 6000
HETERO = ("Wsin f440 t0.3 a.4 p[Wsin r2 a.5]\n"
          "Nwh a0.2 t0.25\n"
          "Rlin f200 t0.2 a.3\n")
# a multi-event PM sequence, longer than 1 s (the time-axis check)
SEQ = ("Wsin f440 a.5 p[Wsin f97 a.4] t.3 /.3 "
       "Wtri f330 a.4 t.3 /.3 "
       "Wsin f550 a.4 p[Wtri f131 a.3] t.4 /.4 "
       "Wsqr f220 a.3 t.5")


def _engine(prg, device):
    from ..render.engine import TorchGenerator
    g = TorchGenerator(prg, SRATE, device)
    return g.assemble(g.render_device())


def _same(got, ref, what):
    got = np.asarray(got).reshape(-1, 2)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    bad = int(np.sum(np.any(got != ref, axis=1)))
    assert bad == 0, '%s: %d/%d frames differ from the single-device ' \
        'engine' % (what, bad, len(ref))


def dryrun_multichip(devices) -> None:
    """Run the four checks over ``devices`` (resolve_devices)."""
    from .. import compile_script
    from ..render.engine import resolve_devices
    from .meshrender import MeshRender
    from .sharding import Mesh
    from .timeshard import TimeShardRender
    from .voicebank import BankRender, make_bank_script
    devs = resolve_devices(devices)
    n = len(devs)
    mesh = Mesh(devs, ('voices',))

    prg = compile_script(make_bank_script(2 * n, seed=1, duration=1.0))
    mix = BankRender(prg, SRATE, mesh=mesh, mesh_mix='ring').render_i16()
    _same(mix.cpu().numpy(), _engine(prg, devs[0]), 'bank')
    print('dryrun_multichip: %d-voice bank over %d devices (ring mix), '
          '1 s at %d Hz, bit-identical to the single-device engine: ok'
          % (2 * n, n, SRATE), flush=True)

    hprg = compile_script(HETERO)
    _same(MeshRender(hprg, SRATE, mesh=mesh).render_i16(),
          _engine(hprg, devs[0]), 'heterogeneous')
    print('dryrun_multichip: heterogeneous MeshRender, %d voices over %d '
          'devices, bit-identical to the single-device engine: ok'
          % (hprg.vo_count, n), flush=True)

    uv = 13 if n > 1 else 3
    uprg = compile_script(make_bank_script(uv, seed=1, duration=1.0))
    umix = BankRender(uprg, SRATE, mesh=mesh, mesh_mix='ring').render_i16()
    _same(umix.cpu().numpy(), _engine(uprg, devs[0]), 'uneven bank')
    print('dryrun_multichip: uneven %d voices on %d devices (ring mix), '
          'bit-identical to the single-device engine: ok' % (uv, n),
          flush=True)

    tprg = compile_script(SEQ)
    assert tprg.duration_ms >= 1000, tprg.duration_ms
    tmesh = Mesh(devs, ('sp',))
    ts = TimeShardRender(tprg, SRATE, tmesh)
    _same(ts.render_host(), _engine(tprg, devs[0]), 'time axis')
    print('dryrun_multichip: time-axis shard of a real program over %s '
          '(%d segments, %.1f s audio), bit-identical to the '
          'single-device engine: ok'
          % (dict(tmesh.shape), len(ts.segs), tprg.duration_ms / 1000.0),
          flush=True)


if __name__ == '__main__':
    dryrun_multichip(sys.argv[1] if len(sys.argv) > 1 else None)
