"""The port's captured dispatch on the card: renders through CUDA graphs
against the same bodies run op by op (``graphs=False``) and against the
plain path, graph and launch counts, and no host sync in a warm graph
render. Every test needs a card (marked ``cuda``; they skip without
one); run them there with
``python -m pytest --noconftest -q tests/test_torch_graphs.py``.
Tolerance: byte-equality of the int16 output."""
import numpy as np
import pytest
import torch

import saugns_tpu_torch as stt
from saugns_tpu_torch import kernels
from saugns_tpu_torch.parallel.voicebank import (make_bank_script,
                                                 make_selfmod_bank_script)
from saugns_tpu_torch.render import engine as teng
from saugns_tpu_torch.render import flat as tflat
from saugns_tpu_torch.render.engine import TorchGenerator, device_checksum
from saugns_tpu_torch.render.graphs import Dispatch

FLAGSHIP = ("Wsin t1 f500.r501[Wsin f1] p[Wsin f400.r800[Wsqr f1.r10"
            "[Wsin f50]]] a.8 c[Wsin f.5]")
NOTES = ' | '.join('Wsin f%d t.05 a.4 p[Wsin r2 a.3]' % (196 + 7 * k)
                   for k in range(48))
# (script, the generator's flat=): flat=False puts every epoch on the
# sequential engine; pm_smoothchange's epoch is on it either way
SCRIPTS = [
    ('Wsin', True),
    (FLAGSHIP, False),
    (FLAGSHIP, True),
    ('Wsin f110 t.5 p.a.3', True),
    ('Rcos mf f60 p.a.5[Rlin f7 a.4] a.6 t.2 c-.3', True),
    ('Nre t.5 a.4 c.3 ; Nvi t.2 c-.5', True),
    ('Wsin f220 t1 p[Wsin f50 /.3 r[g3 t.3]]', True),
    (make_bank_script(16, seed=0, duration=0.3), False),
    (make_bank_script(16, seed=0, duration=0.3), True),
    (make_selfmod_bank_script(4, seed=1, duration=0.2), True),
    (NOTES, True),
]
IDS = ['wsin', 'flagship_seq', 'flagship', 'wosc_selfpm', 'rasg_selfpm',
       'noise', 'pm_smoothchange', 'bank16_seq', 'bank16',
       'selfmod_bank4', 'notes']
SRATE = 48000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    kernels.build()
    return torch.device('cuda')


def _gen(script, dev, **kw):
    return TorchGenerator(stt.compile_script(script), SRATE, dev, **kw)


def _render(gen):
    kernels.reset_launches()
    out = gen.assemble(gen.render_device())
    torch.cuda.synchronize()
    return out, dict(kernels.LAUNCHES)


@pytest.mark.cuda
@pytest.mark.parametrize('script,flat', SCRIPTS, ids=IDS)
def test_graph_render_matches_eager_and_plain(cuda, script, flat):
    g = _gen(script, cuda, flat=flat)
    first, n_first = _render(g)
    warm, n_warm = _render(g)
    stats = g.graph_stats()
    eager, n_eager = _render(_gen(script, cuda, flat=flat, graphs=False))
    plain, _ = _render(_gen(script, cuda, flat=flat, plain=True))
    assert np.any(first != 0)
    assert np.array_equal(first, eager) and np.array_equal(warm, eager)
    assert np.array_equal(eager, plain)
    # the graph's launches count at each replay, as many as op by op
    assert n_first == n_eager and n_warm == n_eager
    assert sum(n_eager.values()) > 0
    assert stats['captures'] >= 1 and stats['replays'] >= 2
    assert stats['nodes'] > 0


@pytest.mark.cuda
@pytest.mark.parametrize('script,flat', [SCRIPTS[1], SCRIPTS[2],
                                         SCRIPTS[10]],
                         ids=[IDS[1], IDS[2], IDS[10]])
def test_graph_stream_and_checksum(cuda, script, flat, monkeypatch):
    for stereo in (True, False):
        a = stt.render(script, srate=SRATE, stereo=stereo, device=cuda)
        gen = _gen(script, cuda, flat=flat, graphs=False)
        b = stt.render(program=gen.prg, srate=SRATE, stereo=stereo,
                       device=cuda, plain=True)
        assert np.array_equal(a, b)
    g = _gen(script, cuda, flat=flat)
    want = int(device_checksum(_gen(script, cuda, flat=flat,
                                    graphs=False).render_device()))
    assert int(g.render_checksum()) == want
    # above the one-graph cap: the grouped graphs and their accumulator
    monkeypatch.setattr(tflat, 'GROUP_OUT_CAP', 1)
    monkeypatch.setattr(teng, 'GROUP_OUT_CAP', 1)
    g = _gen(script, cuda, flat=flat)
    assert int(g.render_checksum()) == want
    assert int(g.render_checksum()) == want
    assert ('mono', True) not in g.prepare().graphs


@pytest.mark.cuda
@pytest.mark.parametrize('script,flat', [SCRIPTS[2], SCRIPTS[6],
                                         SCRIPTS[8]],
                         ids=[IDS[2], IDS[6], IDS[8]])
def test_warm_render_makes_no_sync(cuda, script, flat):
    """After the first render, a graph render and an op-by-op render
    make no host sync (a sync would raise in this mode)."""
    for graphs in (True, False):
        g = _gen(script, cuda, flat=flat, graphs=graphs)
        g.render_device()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode('error')
        try:
            g.render_device()
            g.render_checksum()
        finally:
            torch.cuda.set_sync_debug_mode('default')
        torch.cuda.synchronize()


def _golden():
    import json
    import os
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        'golden', 'torch_slice2.json')
    with open(path) as f:
        return json.load(f)


# the golden file's short entries (each also rendered on the plain path
# by chip_smoke.py)
SHORT = ['noise_bv', 'noise_bw', 'noise_gw', 'noise_re', 'noise_tw',
         'noise_vi', 'noise_wh', 'rasg_fm', 'rasg_lin', 'rasg_ma',
         'rasg_mb', 'rasg_mf', 'rasg_mg', 'rasg_mt', 'rasg_mu',
         'rasg_selfpm_short', 'selfmod_bank_8', 'wosc_selfpm', 'notes_seq']


@pytest.mark.cuda
@pytest.mark.parametrize('flat', [True, False], ids=['flat', 'seq'])
@pytest.mark.parametrize('name', SHORT)
def test_golden_entry_through_graphs(cuda, name, flat):
    """The golden file's short scripts at its 96 kHz, on the flat path
    and with every epoch on the sequential engine: the graph render
    equals the op-by-op one and the reference hash."""
    import hashlib
    g = _golden()
    ent = g['entries'][name]
    prg = stt.compile_script(ent['script'])
    outs = []
    for graphs in (True, False):
        gen = TorchGenerator(prg, g['srate'], cuda, flat=flat,
                             graphs=graphs)
        gen.render_device()
        outs.append(gen.assemble(gen.render_device()))
    assert np.array_equal(outs[0], outs[1])
    assert hashlib.sha256(outs[0].astype('<i2').tobytes()).hexdigest() \
        == ent['sha256']


@pytest.mark.cuda
def test_capture_of_a_sync_raises(cuda):
    st0 = tuple(torch.zeros(2, device=cuda) for _ in range(3))
    d = Dispatch(cuda, True, True, st0)
    x = torch.ones(4, device=cuda)
    with pytest.raises(RuntimeError):
        d.run(('bad',), lambda t: t.sum().item(), (), (x,))
    torch.cuda.synchronize()
    assert d.stats()['replays'] == 0 and ('bad',) not in d.graphs
