"""The call's route on one device (io/player.py ``_make_generator``, which
``saugns_tpu_torch.render`` and the CLI share), on the CPU: a program of
several voices that batch renders on MeshRender's grouped slab path
(a MeshGenerator) and counts ``render.slab_route`` in the call's
request; every other program, a program the store holds and the
plain path keep a TorchGenerator. Tolerance: bit-equality of the
int16 output, stereo and mono, with TorchGenerator's."""
import gc

import numpy as np
import pytest

import saugns_tpu_torch as stt
from saugns_tpu_torch import tracing
from saugns_tpu_torch.io import player as tplayer
from saugns_tpu_torch.parallel import meshrender
from saugns_tpu_torch.parallel.meshrender import (Ineligible, MeshGenerator,
                                                  MeshRender, batches)
from saugns_tpu_torch.render import aotstore
from saugns_tpu_torch.render.engine import TorchGenerator

SRATE = 6000
# portbench's selfpm_voices line (pm_feedback_pm.sau's voice), 16 voices
SELFPM_LINE = ('Wsin f%.2f t%.3f a1 c%.3f p.a[Wsin f3.14 a0.25 '
               'a[Wsin f1 a0.5]]')


def selfpm_bank(n, seed=1, duration=0.2):
    rng = np.random.default_rng(seed)
    lines = ['S a.m%.3f' % (1.0 / n)]
    for _ in range(n):
        freq = 220.0 * 2.0 ** (int(rng.integers(0, 25)) / 12.0)
        lines.append(SELFPM_LINE % (freq, duration,
                                    rng.uniform(-1.0, 1.0)))
    return '\n'.join(lines) + '\n'


BANK16 = selfpm_bank(16)
# two voices of one signature, then a phase record and a wave change
# mid-note, and a noise voice (tests/test_torch_meshrender.py)
MULTI = ("'a Wsin f440 t.6 a.3\n"
         "'b Wsin f220 t.6 a.2\n"
         "/.2 @a p.25 @b wsqr\n"
         "/.1 Nbv t.2 a.1\n")
# three voices of three signatures: every voice a slab of one
HETERO = ("Wsin f440 t0.3 a.4 p[Wsin r2 a.5]\n"
          "Nwh a0.2 t0.25\n"
          "Rlin f200 t0.2 a.3\n")
# two voices of one signature, neither flat-eligible (an epoch HostSim
# cannot bake: pm_smoothchange.sau's pattern)
SEQ2 = ('Wsin f220 t.3 p[Wsin f50 /.1 r[g3 t.1]]\n'
        'Wsin f330 t.3 p[Wsin f50 /.1 r[g3 t.1]]\n')


@pytest.fixture(autouse=True)
def fresh(tmp_path, monkeypatch):
    """An empty ring, and a store of the test's own, on and empty."""
    monkeypatch.setenv('SAUGNS_TPU_CACHE', str(tmp_path / 'cache'))
    monkeypatch.setenv('SAUGNS_TPU_EXPORT', '1')
    monkeypatch.delenv('SAUGNS_TPU_MESH', raising=False)
    monkeypatch.setattr(aotstore, '_pack_dir',
                        lambda platform: str(tmp_path / 'pack' / platform))
    aotstore.clear()
    aotstore.reset_stats()
    tracing.clear()
    yield
    aotstore.clear()
    tracing.clear()


def _drain(gen, stereo):
    ch = 2 if stereo else 1
    buf = np.zeros(1000 * ch, np.int16)
    parts = []
    more = True
    while more:
        more, n = gen.run(buf, 1000, stereo)
        parts.append(buf[:n * ch].copy())
    return np.concatenate(parts).reshape(-1, ch)


def _generator_render(src, stereo):
    return _drain(TorchGenerator(stt.compile_script(src), SRATE, 'cpu'),
                  stereo)


def _call(src, stereo=True, **kw):
    """render() of ``src`` on the CPU: (output, the call's root span,
    the names of its spans)."""
    out = stt.render(src, srate=SRATE, stereo=stereo, device='cpu', **kw)
    recs = tracing.records()
    root, = [r for r in recs if r.name == 'render.call']
    return out, root, {r.name for r in recs}


@pytest.mark.parametrize('stereo', [True, False], ids=['stereo', 'mono'])
@pytest.mark.parametrize('src', [BANK16, MULTI], ids=['selfpm16', 'multi'])
def test_render_takes_the_slab_route(src, stereo):
    """A batching program's call renders on the grouped slab path once,
    counted, and gives TorchGenerator's bytes."""
    out, root, names = _call(src, stereo)
    assert root.counters.get('render.slab_route') == 1
    assert 'render.mesh' in names and 'render.generator' not in names
    # the plan and host sim are built once: by the store's lookup miss
    plans = [r for r in tracing.records() if r.name == 'plan.build'
             and r.parent == root.sid]
    assert len(plans) == 1
    assert np.array_equal(out, _generator_render(src, stereo))


def test_slab_route_batches_the_bank():
    """The 16-voice bank's call renders its voices as rows of one slab;
    the factory hands the plan and host sim of its lookup on."""
    prg = stt.compile_script(BANK16)
    gen = tplayer._make_generator(prg, SRATE, 'cpu')
    assert isinstance(gen, MeshGenerator)
    assert [str(d) for d in gen.mr.devices] == ['cpu']
    gen.mr.prepare()
    slabs = [sl for _ep, segs in gen.mr.epoch_segs for s in segs
             for sl in s.slabs]
    assert [len(vs) for _d, vs, _fs in slabs] == [16]


def _prepare_case(case, monkeypatch):
    """The program of ``case`` and render()'s keyword arguments; each
    case's program would take the slab route but for its own rule."""
    if case == 'one_voice':
        return 'Wsin t.1', {}
    if case == 'ineligible':
        prg = stt.compile_script(SEQ2)
        assert batches(TorchGenerator(prg, SRATE, 'cpu').plan)
        with pytest.raises(Ineligible):
            MeshRender(prg, SRATE, device='cpu')
        return SEQ2, {}
    if case == 'mesh_off':
        monkeypatch.setenv('SAUGNS_TPU_MESH', '0')
        return BANK16, {}
    if case == 'plain':
        return MULTI, {'plain': True}
    if case == 'too_long':
        monkeypatch.setattr(meshrender, 'MESH_MAX_BUFFER_SAMPLES',
                            SRATE // 10)
        return MULTI, {}
    assert case == 'no_batch'
    assert not batches(TorchGenerator(stt.compile_script(HETERO), SRATE,
                                      'cpu').plan)
    return HETERO, {}


@pytest.mark.parametrize('case', ['one_voice', 'ineligible', 'mesh_off',
                                  'plain', 'too_long', 'no_batch'])
def test_render_keeps_the_generator(case, monkeypatch):
    """One voice, a program MeshRender rejects, SAUGNS_TPU_MESH=0, the
    plain path, a program longer than MESH_MAX_BUFFER_SAMPLES and a
    program whose every voice is a group of its own render on a
    TorchGenerator, uncounted."""
    src, kw = _prepare_case(case, monkeypatch)
    tracing.clear()
    out, root, names = _call(src, **kw)
    assert 'render.slab_route' not in root.counters
    assert 'render.generator' in names and 'render.mesh' not in names
    assert np.array_equal(out, _generator_render(src, True))


def test_stored_render_is_served_from_the_store():
    """A program the store holds is served from it, on its disk tier and
    then its memory tier, not routed."""
    want = _generator_render(MULTI, True)
    g0 = TorchGenerator(stt.compile_script(MULTI), SRATE, 'cpu')
    g0.render_device()
    assert g0.save_export()
    del g0
    gc.collect()
    aotstore.reset_stats()
    tracing.clear()
    out, root, names = _call(MULTI)
    assert aotstore.STATS['disk_hits'] == 1
    assert 'render.slab_route' not in root.counters
    assert 'render.mesh' not in names
    assert np.array_equal(out, want)
    gc.collect()
    tracing.clear()
    out, root, names = _call(MULTI)
    assert aotstore.STATS['mem_hits'] == 1
    assert 'render.slab_route' not in root.counters
    assert 'render.mesh' not in names
    assert np.array_equal(out, want)
