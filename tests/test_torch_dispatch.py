"""The port's dispatch layer on the CPU: the render's bodies run
directly on the graphs' static buffers (graphs.Dispatch), the way the
card replays them, against JaxGenerator on the CPU platform; segment
templates, the grouping of segments, and the counts of graphs, replays
and kernel launches. The card's counterpart is test_torch_graphs.py.
Tolerance: byte-equality of the int16 output (bit-equality of the
float mix and of the state where noted)."""
import contextlib
import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax

jax.config.update('jax_platforms', 'cpu')

from saugns_tpu.lang.program import (ScriptArg as JArg,  # noqa: E402
                                     build_program as jbuild)
from saugns_tpu.render import engine as jeng  # noqa: E402
from saugns_tpu.render import flat as jflat  # noqa: E402
from saugns_tpu.render import jdsp  # noqa: E402
import saugns_tpu_torch as stt  # noqa: E402
from saugns_tpu_torch import convert, kernels  # noqa: E402
from saugns_tpu_torch.render import engine as teng  # noqa: E402
from saugns_tpu_torch.render import flat as tflat  # noqa: E402
from saugns_tpu_torch.render import graphs, tdsp  # noqa: E402
from saugns_tpu_torch.render.engine import TorchGenerator  # noqa: E402
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_engine import SCRIPTS, _pull  # noqa: E402
from tests.torch_jaxref import ensure_native_tables  # noqa: E402


@pytest.fixture(autouse=True, scope='module')
def _jax_native_tables():
    """The JAX package renders with its native wave tables, also on a
    cold build cache (tests/torch_jaxref.py)."""
    ensure_native_tables()


# 48 notes of one template: one epoch, 48 segments with one key
NOTES = ' | '.join('Wsin f%d t.05 a.4 p[Wsin r2 a.3]' % (196 + 7 * k)
                   for k in range(48))
# an epoch HostSim cannot bake (the pattern of pm_smoothchange.sau)
SEQ_SCRIPT = 'Wsin f220 t1 p[Wsin f50 /.3 r[g3 t.3]]'
# a flat epoch, then two on the sequential engine
MIXED = 'Wsin f300 t.2 | ' + SEQ_SCRIPT + ' | Wtri f200 t.2'
# 25 s at 6 kHz (three blocks): one block per chunk makes two chunk
# groups, and a second segment follows
LONG = 'Wsin f600 t25 p[Wsin r1.5] | Wtri f300 t1'
CASES = SCRIPTS + [NOTES, SEQ_SCRIPT, MIXED]
CASE_IDS = ['script%d' % k for k in range(len(SCRIPTS))] \
    + ['notes', 'seq', 'mixed']
SRATE = 6000


def _jprog(script):
    return jbuild(JArg(str=script, is_path=False, no_time=True, predef=[]))


def _tgen(script, srate=SRATE, **kw):
    """The port's generator on the CPU, fed the JAX package's tables and
    initial state (convert.py)."""
    jg = jeng.JaxGenerator(_jprog(script), srate)
    _, piluts = convert.tables(*jdsp.get_tables(), 'cpu')
    st0 = convert.state(jeng.make_state(jg.plan), 'cpu')
    return TorchGenerator(stt.compile_script(script), srate, 'cpu',
                          piluts=piluts, state=st0, **kw)


@functools.lru_cache(maxsize=None)
def _jax_device(script, srate=SRATE):
    """JaxGenerator's render_device output, assembled on the host."""
    jg = jeng.JaxGenerator(_jprog(script), srate)
    return jg.assemble(jg.render_device())


@contextlib.contextmanager
def _no_mono(monkeypatch):
    """Above the one-graph cap: the grouped structure."""
    with monkeypatch.context() as m:
        m.setattr(tflat, 'GROUP_OUT_CAP', 1)
        m.setattr(teng, 'GROUP_OUT_CAP', 1)
        yield


def _segs(gen):
    return [s for ei in range(len(gen.plan.epochs))
            for s in gen._flat_epoch(ei)]


# -- the port against JAX ------------------------------------------------------

@pytest.mark.parametrize('structure', ['mono', 'grouped'])
@pytest.mark.parametrize('script', CASES, ids=CASE_IDS)
def test_render_device_byte_equal(script, structure, monkeypatch):
    g = _tgen(script)
    if structure == 'grouped':
        with _no_mono(monkeypatch):
            got = g.assemble(g.render_device())
            keys = set(g.prepare().graphs)
        assert ('mono', False) not in keys
    else:
        got = g.assemble(g.render_device())
        assert set(g.prepare().graphs) == {('mono', False)}
    assert got.shape[0] > 0 and np.any(got != 0)
    assert np.array_equal(got, _jax_device(script)), \
        int(np.sum(got != _jax_device(script)))
    # a second render replays the same graphs
    n = g.graph_stats()['captures']
    if structure == 'grouped':
        with _no_mono(monkeypatch):
            again = g.assemble(g.render_device())
    else:
        again = g.assemble(g.render_device())
    assert np.array_equal(again, got)
    assert g.graph_stats()['captures'] == n


@pytest.mark.parametrize('structure', ['mono', 'grouped'])
def test_render_device_96k_byte_equal(structure, monkeypatch):
    """At the reference's 96 kHz, where the 1-LSB faults of earlier
    slices showed: four notes of one template and a sequential epoch."""
    script = ' | '.join('Wsin f%d t.05 a.4 p[Wsin r2 a.3]' % f
                        for f in (196, 247, 294, 330)) \
        + ' | Wsin f220 t.2 p[Wsin f50 /.05 r[g3 t.05]]'
    g = _tgen(script, 96000)
    assert any(g.sequential(ei) for ei in range(len(g.plan.epochs)))
    with monkeypatch.context() as m:
        if structure == 'grouped':
            m.setattr(tflat, 'GROUP_OUT_CAP', 1)
            m.setattr(teng, 'GROUP_OUT_CAP', 1)
        got = g.assemble(g.render_device())
    want = _jax_device(script, 96000)
    assert got.shape == want.shape and np.any(got != 0)
    assert np.array_equal(got, want), int(np.sum(got != want))


@pytest.mark.parametrize('stereo', [True, False], ids=['stereo', 'mono'])
@pytest.mark.parametrize('script', [NOTES, MIXED, LONG],
                         ids=['notes', 'mixed', 'long'])
def test_run_byte_equal(script, stereo, monkeypatch):
    """The stream path (api.render, write_wav, the CLI) through its
    per-segment and per-epoch graphs; the long script with one block
    per chunk and two chunks per group, through its init, chunk-group
    and fini graphs."""
    jg = jeng.JaxGenerator(_jprog(script), SRATE)
    want = _pull(jg, stereo)
    if script == LONG:
        monkeypatch.setattr(tflat, 'FLAT_CHUNK', 1)
        monkeypatch.setattr(tflat, 'STREAM_GROUP', 2)
    g = _tgen(script)
    assert np.array_equal(_pull(g, stereo), want)
    kinds = {k[0] for k in g.prepare().graphs}
    if script == LONG:
        assert max(s.ng for s in _segs(g)) >= 2
        assert {'init', 'group', 'fini'} <= kinds
    else:
        assert 'fused' in kinds and ('seq' in kinds) == (script == MIXED)


@pytest.mark.parametrize('script', [NOTES, MIXED, SCRIPTS[5]],
                         ids=['notes', 'mixed', 'flagship'])
def test_checksum_matches_jax(script, monkeypatch):
    jg = jeng.JaxGenerator(_jprog(script), SRATE)
    want = int(jeng.device_checksum(jg.render_device()))
    g = _tgen(script)
    assert int(g.render_checksum()) == want
    assert int(teng.device_checksum(g.render_device())) == want
    with _no_mono(monkeypatch):
        g = _tgen(script)
        assert int(g.render_checksum()) == want
        assert int(g.render_checksum()) == want
    assert teng.force_scalars([torch.tensor(3), torch.tensor(4)]) == 7.0


def test_golden_notes_entry_is_the_notes_script():
    """chip_smoke.py holds the card's note-sequence renders to the
    golden file's hash of this script (JaxGenerator at 96 kHz)."""
    from test_torch_goldens import entries, load
    assert entries()['notes_seq'][0] == NOTES
    assert load()['entries']['notes_seq']['script'] == NOTES


# -- segment templates ------------------------------------------------------------

def _same_bits(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and torch.equal(a, b)


def test_template_replay_byte_equal():
    """Each note's segment, rendered through the body built for the
    group's first segment (on the graph's static buffers), equals its
    own op-by-op render: output and state, bit for bit."""
    g = _tgen(NOTES)
    segs = _segs(g)
    assert len(segs) == 48 and len({s.key for s in segs}) == 1
    d = g.prepare()
    tmpl = d.template(segs[0])
    st = g._initial_state()
    for s in segs:
        assert d.template(s) is tmpl
        st_own, out_own = s.run(st)
        for buf, k in zip(d.st, ('sf', 'si', 'vdur')):
            buf.copy_(st[k])
        out = d.run(('fused', s.key, s.ng, 'f32'), tmpl.fused_body('f32'),
                    d.st, s.tables())
        assert _same_bits(out[:s.nb], out_own)
        for buf, k in zip(d.st, ('sf', 'si', 'vdur')):
            assert _same_bits(buf, st_own[k]), k
        st = st_own
    assert d.stats()['captures'] == 1 and d.stats()['replays'] == 48


@pytest.mark.parametrize('script', [NOTES, SCRIPTS[5], MIXED,
                                    'Nre t.3 a.4 | Rcos t.3 f80.r160'
                                    '[Wsin f2] a.7 | Wsin f110 t.2 p.a.3'],
                         ids=['notes', 'flagship', 'mixed', 'noise_rasg'])
def test_fini_scatter_matches_per_cell_writes(script):
    """A segment's carries go back to the state by one scatter per
    array where no cell repeats, else cell by cell in stage order (the
    JAX renderer's order): on the same segment both give the same
    state, bit for bit."""
    g = _tgen(script)
    st = g._initial_state()
    for s in _segs(g):
        assert s.fini_cells_unique
        st_a, out_a = s.run(st)
        s.fini_cells_unique = False
        st_b, out_b = s.run(st)
        s.fini_cells_unique = True
        assert _same_bits(out_a, out_b)
        for k in ('sf', 'si', 'vdur'):
            assert _same_bits(st_a[k], st_b[k]), k
        st = st_a


@pytest.mark.parametrize('script,differ', [
    # a held frequency against a glide: the constant-line analysis
    ('Wsin f200 t.1 | Wsin f[v200 g400 t.1] t.1', True),
    # notes that differ in their data alone share one key
    ('Wsin f200 t.1 a.3 | Wsin f300 t.1 a.5 | Wsin f400 t.1 a.7', False),
])
def test_host_branches_get_their_own_keys(script, differ):
    segs = _segs(_tgen(script))
    keys = [s.key for s in segs]
    assert (len(set(keys)) > 1) == differ
    for a, b in zip(segs, segs[1:]):
        if a.key == b.key:
            assert (a.const_sis, a.const_mul, a.scalar_freq,
                    a.rec_struct) == (b.const_sis, b.const_mul,
                                      b.scalar_freq, b.rec_struct)


# -- grouping against JAX --------------------------------------------------------

def _partition(groups):
    out = []
    for g in groups:
        out.append(tuple((s.seg.lo, s.seg.hi, id(s.ep)) for s in g))
    return out


@pytest.mark.parametrize('script', [NOTES, SCRIPTS[1], SCRIPTS[4],
                                    SCRIPTS[9], MIXED],
                         ids=['notes', 'script1', 'script4', 'script9',
                              'mixed'])
def test_plan_groups_refines_jax(script):
    jg = jeng.JaxGenerator(_jprog(script), SRATE)
    tg = _tgen(script)
    for ei in range(len(tg.plan.epochs)):
        jsegs = jg._flat_epoch(ei) or []
        tsegs = tg._flat_epoch(ei)
        assert [(s.seg.lo, s.seg.hi) for s in jsegs] \
            == [(s.seg.lo, s.seg.hi) for s in tsegs]
        for s in jsegs:
            s._fn  # noqa: B018 -- builds the JAX segment's key
        jgr = [[(s.seg.lo, s.seg.hi) for s in g]
               for g in jflat.plan_groups(jsegs)]
        tgr = [[(s.seg.lo, s.seg.hi) for s in g]
               for g in tflat.plan_groups(tsegs)]
        # every port group lies inside one JAX group
        where = {seg: k for k, g in enumerate(jgr) for seg in g}
        for g in tgr:
            assert len({where[seg] for seg in g}) == 1
        assert sum(map(len, tgr)) == sum(map(len, jgr))
        if script == NOTES:
            assert tgr == jgr and len(tgr) == 1 and len(tgr[0]) == 48


# -- nothing uploaded or synced ------------------------------------------------

def _raise(*_a, **_k):
    raise AssertionError('an upload or host sync during a render')


NOISE_RASG = 'Nre t.3 a.4 | Rcos t.3 f80.r160[Wsin f2] a.7'


def _no_scalar_index(getitem):
    """Tensor.__getitem__/__setitem__ that raises on a 0-d integer
    tensor in the index (PyTorch reads its value on the host) and on a
    boolean mask (its positions are counted on the host)."""
    def f(self, idx, *a):
        for x in idx if isinstance(idx, tuple) else (idx,):
            if not isinstance(x, torch.Tensor):
                continue
            if x.dtype == torch.bool:
                raise AssertionError('a boolean mask index (a host read)')
            if x.dim() == 0 and not x.dtype.is_floating_point:
                raise AssertionError('a 0-d tensor index (a host read)')
        return getitem(self, idx, *a)
    return f


@pytest.mark.parametrize('script,flat', [
    (NOTES, True), (MIXED, True), (SCRIPTS[5], True), (SCRIPTS[7], True),
    (NOISE_RASG, True), (NOISE_RASG, False),
    ('Nbv t.2 | Nvi t.2 a.3 | Wsin f300 t.2 p[Wsin r2]', False)],
    ids=['notes', 'mixed', 'flagship', 'script7', 'noise_rasg',
         'noise_rasg_seq', 'noise_wave_seq'])
def test_render_uploads_and_syncs_nothing(script, flat, monkeypatch):
    """After prepare(), no render calls torch.from_numpy, torch.tensor,
    Tensor.item, .cpu, .tolist, converts a tensor to a Python number or
    truth value, or indexes with a 0-d integer tensor: on the card each
    of them would break the capture."""
    g = _tgen(script, flat=flat)
    ref = g.assemble(g.render_device())
    ref_run = _pull(_tgen(script, flat=flat), True)
    g.prepare()
    g2 = _tgen(script, flat=flat)
    g2.prepare()
    with monkeypatch.context() as m:
        for obj, name in ((torch, 'from_numpy'), (torch, 'tensor'),
                          (torch.Tensor, 'item'), (torch.Tensor, 'cpu'),
                          (torch.Tensor, 'tolist'),
                          (torch.Tensor, '__bool__'),
                          (torch.Tensor, '__int__'),
                          (torch.Tensor, '__float__'),
                          (torch.Tensor, '__index__')):
            m.setattr(obj, name, _raise)
        for name in ('__getitem__', '__setitem__'):
            m.setattr(torch.Tensor, name,
                      _no_scalar_index(getattr(torch.Tensor, name)))
        pieces = g.render_device()
        cks = g.render_checksum()
        with _no_mono(m):
            grouped = g.render_device()
            g.render_checksum()
        got_run = _pull(g2, True)
    assert np.array_equal(g.assemble(pieces), ref)
    assert np.array_equal(g.assemble(grouped), ref)
    assert np.array_equal(got_run, ref_run)
    assert int(cks) == int(teng.device_checksum(pieces))


# -- graph and launch counts -----------------------------------------------------

def _notes(n):
    return ' | '.join('Wsin f%d t.05 a.4 p[Wsin r2 a.3]' % (196 + 7 * k)
                      for k in range(n))


def test_graph_count_is_constant_in_the_notes(monkeypatch):
    stats = {}
    for n in (8, 32):
        with _no_mono(monkeypatch):
            g = _tgen(_notes(n))
            g.render_device()
            g.render_device()
        stats[n] = g.graph_stats()
    # the reset graph and the notes' one whole-segment graph
    assert stats[8]['captures'] == stats[32]['captures'] == 2
    assert stats[8]['replays'] == 2 * (1 + 8)
    assert stats[32]['replays'] == 2 * (1 + 32)


class _FakeGraph:
    """Stands in for torch.cuda.CUDAGraph on the CPU: the capture runs
    the body once and a replay runs nothing, so only the launch counts
    of the captured body can make a replayed render's counts."""

    def replay(self):
        pass


@contextlib.contextmanager
def _fake_capture(_graph, **_kw):
    yield


def _counting(monkeypatch):
    """Route the kernel dispatchers to their plain versions, counting
    each call in kernels.LAUNCHES as the wrappers count launches."""
    def wrap(name, plain):
        def f(*a, **k):
            kernels.count(name)
            return plain(*a, **k)
        return f
    for attr, name, plain in (
            ('prefix_sum', 'scan_add_u32', tdsp.prefix_sum_plain),
            ('prefix_sum_u64', 'scan_add_u64', tdsp.prefix_sum_u64_plain),
            ('scan_max_i32', 'scan_max_i32', tdsp.scan_max_i32_plain),
            ('wosc_s_filled', 'wosc_fill', tdsp.wosc_s_filled_plain),
            ('gather_taps', 'gather_taps', tdsp.gather_taps_plain),
            ('is64', 'is64', tdsp.is64_plain)):
        monkeypatch.setattr(tdsp, attr, wrap(name, plain))


@pytest.mark.parametrize('structure', ['mono', 'grouped'])
def test_launch_counts_add_up_per_replay(structure, monkeypatch):
    """A captured body's launches are taken back after the capture and
    added at each replay: N renders through a graph count what N renders
    op by op count, though the body ran once."""
    _counting(monkeypatch)
    script = NOTES + ' | ' + 'Wsin t.3 f80.r160[Wsin f2] a.7'
    with monkeypatch.context() as m:
        if structure == 'grouped':
            m.setattr(tflat, 'GROUP_OUT_CAP', 1)
            m.setattr(teng, 'GROUP_OUT_CAP', 1)
        kernels.reset_launches()
        _tgen(script).render_device()
        want = dict(kernels.LAUNCHES)
        assert want['scan_add_u32'] > 0 and want['wosc_fill'] > 0
        m.setattr(torch.cuda, 'CUDAGraph', _FakeGraph)
        m.setattr(torch.cuda, 'graph', _fake_capture)
        m.setattr(graphs, '_capture_nodes', lambda: 7)
        g = _tgen(script)
        d = g.prepare()
        d.capture = True
        kernels.reset_launches()
        for _ in range(3):
            g.render_device()
        assert dict(kernels.LAUNCHES) == {k: 3 * v
                                          for k, v in want.items()}
        st = g.graph_stats()
        assert st['nodes'] == 7 * st['captures']
        assert st['replays'] == 3 * (st['captures'] if structure == 'mono'
                                     else 1 + len(_segs(g)))
