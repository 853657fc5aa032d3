"""The port's time axis (saugns_tpu_torch/parallel/timeshard.py) on the
CPU: ``TimeShardRender`` over S shards (``['cpu'] * S``) against the JAX
package's ``TimeShardRender`` on its 8 virtual devices
(tests/conftest.py), the port's ``TorchGenerator`` and the host renderer
(saugns_tpu/render/cpu.py, byte-identical to the reference binary).
Each script's segments hold several active rows, so that active rows
lie on both sides of a shard edge: 2 s at 96 kHz (3 rows), or mid-note
changes at 6 kHz (each starts a row). Tolerance: bit-equality of the
int16 output."""
import contextlib

import numpy as np
import pytest
import torch

import jax

jax.config.update('jax_platforms', 'cpu')

from jax.sharding import Mesh as JMesh  # noqa: E402
from saugns_tpu.lang.program import (ScriptArg as JArg,  # noqa: E402
                                     build_program as jbuild)
from saugns_tpu.parallel.timeshard import (  # noqa: E402
    TimeShardRender as JTimeShardRender)
from saugns_tpu.render import flat as jflat  # noqa: E402
from saugns_tpu.render.cpu import Generator as CpuGen  # noqa: E402
from saugns_tpu.render.hostsim import HostSim as JHostSim  # noqa: E402
from saugns_tpu.render.plan import RenderPlan as JRenderPlan  # noqa: E402
import saugns_tpu_torch as stt  # noqa: E402
from saugns_tpu_torch import kernels  # noqa: E402
from saugns_tpu_torch.parallel import timeshard  # noqa: E402
from saugns_tpu_torch.parallel.dryrun import SEQ  # noqa: E402
from saugns_tpu_torch.parallel.sharding import Mesh  # noqa: E402
from saugns_tpu_torch.parallel.timeshard import TimeShardRender  # noqa: E402
from saugns_tpu_torch.render import flat, graphs, tdsp  # noqa: E402
from saugns_tpu_torch.render.engine import TorchGenerator  # noqa: E402
from saugns_tpu_torch.render.hostsim import HostSim  # noqa: E402
from saugns_tpu_torch.render.plan import RenderPlan  # noqa: E402
from tests.test_torch_meshrender import MULTI, REUSE  # noqa: E402
from tests.torch_jaxref import ensure_native_tables  # noqa: E402


@pytest.fixture(autouse=True, scope='module')
def _jax_native_tables():
    """The JAX package renders with its native wave tables, also on a
    cold build cache (tests/torch_jaxref.py)."""
    ensure_native_tables()


HI, LO = 96000, 6000
# name -> (script, sample rate): the stage kinds whose carries cross a
# shard edge, each in segments of several rows
SCRIPTS = {
    'noise_re': ('Nre t2 a.4', HI),                        # K2
    'noise_vi': ('Nvi t2 a.4', HI),                        # K4 hold
    'noise_bv': ('Nbv t2 a.4', HI),                        # K4 hold
    'wave_k2': ('Wsin t2 f200.r400[Wsin f3]', HI),         # K2, K1
    # kernel 1's pd == 0 hold across shard edges: rows at 0 Hz hold the
    # last valid sample of an earlier shard, a whole shard of them
    # passes it on, and a shard starts held and then turns valid
    'wave_hold': ('Wsin t2 f100 a.5 /.5 f0 /.3 f0 /.2 f100', HI),
    'rasg_k3': ('Rcos t2 f80.r160[Wsin f2] a.7', HI),      # K3
    # scalar-frequency ramps (wave and RasG); the second voice ends in
    # the first row, before the segment's last shard
    'ramp_ends': ('Wsin f200 t2 a.3\nRlin f300 t.3 a.3', HI),
    'selfpm_k5': ('Wsin f100 t.5 p.a.5 /.1 a.3 /.1 a.2 /.1 a.1', LO),
    'selfpm_k6': ('Rcos mf f60 p.a.5[Rlin f7 a.4] a.6 t.5 /.2 a.3', LO),
    'multi': (MULTI, HI),
    'reuse': (REUSE, HI),
    # one or two rows a segment: fewer rows than shards
    'seq': (SEQ, LO),
}


def _jprog(src):
    return jbuild(JArg(str=src, is_path=False, no_time=True, predef=[]))


def _cpu_ref(src, srate):
    g = CpuGen(_jprog(src), srate)
    buf = np.zeros(4096 * 2, np.int16)
    chunks = []
    while True:
        more, n = g.run(buf, 4096, True)
        chunks.append(buf[:n * 2].copy())
        if not more:
            break
    return np.concatenate(chunks).reshape(-1, 2)


_REFS = {}


def _refs(name):
    """(TorchGenerator's render on the CPU, the host renderer's), once a
    script."""
    if name not in _REFS:
        src, srate = SCRIPTS[name]
        tg = TorchGenerator(stt.compile_script(src), srate, 'cpu')
        _REFS[name] = (tg.assemble(tg.render_device()),
                       _cpu_ref(src, srate))
    return _REFS[name]


def _port(src, srate, n, plain=False):
    return TimeShardRender(stt.compile_script(src), srate,
                           Mesh(['cpu'] * n, ('sp',)), plain=plain)


@pytest.mark.parametrize('n', [2, 3, 8])
@pytest.mark.parametrize('name', sorted(SCRIPTS))
def test_timeshard_bit_identical(name, n):
    """S shards = TorchGenerator = the host renderer, to the bit."""
    src, srate = SCRIPTS[name]
    ts = _port(src, srate, n)
    got = ts.render_host()
    eng, cpu = _refs(name)
    assert got.shape == eng.shape
    assert np.array_equal(got, eng)
    assert np.array_equal(got, cpu)
    assert np.any(got != 0)
    for _ei, fs in ts.segs:
        assert fs.nch == n and fs.nc * n >= fs.nb


def test_timeshard_rows_cross_shard_edges():
    """The 2 s scripts put active rows on both sides of an edge: three
    rows on three shards, one each, and on two shards two and one."""
    for name, n, nb, nc in (('wave_k2', 2, 3, 2), ('wave_k2', 3, 3, 1),
                            ('selfpm_k5', 3, 4, 2), ('selfpm_k6', 2, 2, 1)):
        ts = _port(*SCRIPTS[name], n)
        (_ei, fs), = ts.segs
        assert (fs.nb, fs.nc) == (nb, nc)
        assert np.all(np.asarray(fs.bake.lens)[fs.lo:fs.lo + nb, 0] > 0)


@pytest.mark.parametrize('name', ['seq', 'selfpm'])
def test_timeshard_equals_jax_timeshard(name):
    """The port's 8 shards = the JAX package's TimeShardRender over its
    8 virtual devices."""
    if len(jax.devices()) < 8:
        pytest.skip('needs 8 virtual devices')
    src = SEQ if name == 'seq' else 'Wsin f100 t.5 p.a.5'
    jts = JTimeShardRender(_jprog(src), LO,
                           JMesh(np.asarray(jax.devices()[:8]), ('sp',)))
    want = jts.render_host()
    ts = _port(src, LO, 8)
    assert len(ts.segs) == len(jts.segs)
    assert [fs.nc for _, fs in ts.segs] == [fs.nc // 8 for _, fs
                                             in jts.segs]
    got = ts.render_host()
    assert np.array_equal(got, want)


@pytest.mark.parametrize('name', ['noise_vi', 'rasg_k3', 'selfpm_k5'])
def test_timeshard_plain_path(name):
    """plain=True (the kernels' plain versions) renders the same bits;
    a second render starts again from the initial state."""
    src, srate = SCRIPTS[name]
    ts = _port(src, srate, 3, plain=True)
    eng, _ = _refs(name)
    assert np.array_equal(ts.render_host(), eng)
    assert np.array_equal(ts.render_host(), eng)


def test_timeshard_render_device_pieces():
    """One (nb, B, 2) int16 piece a segment on the first device, the
    padding rows dropped."""
    src, srate = SCRIPTS['multi']
    ts = _port(src, srate, 3)
    pieces = ts.render_device()
    assert len(pieces) == len(ts.segs)
    for p, (_ei, fs) in zip(pieces, ts.segs):
        assert p.dtype == torch.int16 and p.shape == (fs.nb, fs.B, 2)


def test_timeshard_rejects_ineligible(monkeypatch):
    """Self-PM epochs are rejected with SAUGNS_TPU_FLAT_SELFMOD=0, and an
    epoch HostSim cannot bake always."""
    mesh = Mesh(['cpu'] * 2, ('sp',))
    with pytest.raises(ValueError):
        TimeShardRender(stt.compile_script('Wsin f220 t1 p[Wsin f50 /.3 '
                                           'r[g3 t.3]]'), LO, mesh)
    with pytest.raises(ValueError):
        TimeShardRender(stt.compile_script(SEQ), LO, mesh, axis='voices')
    prg = stt.compile_script('Wsin f100 t.5 p.a.5')
    TimeShardRender(prg, LO, mesh)
    monkeypatch.setenv('SAUGNS_TPU_FLAT_SELFMOD', '0')
    with pytest.raises(ValueError):
        TimeShardRender(stt.compile_script('Wsin f100 t.5 p.a.5'), LO,
                        mesh)


@pytest.mark.parametrize('row_multiple', [1, 2, 3, 8])
@pytest.mark.parametrize('chunk_samples', [None, 1 << 62, 2 * 65536],
                         ids=['default', 'one_chunk', 'two_rows'])
def test_flat_segment_chunking_equals_jax(chunk_samples, row_multiple):
    """FlatSegment's chunk_samples and row_multiple cut a segment as the
    JAX renderer's do (flat.py:171-186 there)."""
    src = 'Wsin t2 f200 a.3 ; f300 t1'                # one 5-row segment
    plan = RenderPlan(stt.compile_script(src), HI)
    bake = HostSim(plan).bakes[0]
    jplan = JRenderPlan(_jprog(src), HI)
    jbake = JHostSim(jplan).bakes[0]
    seg, jseg = bake.segments[0], jbake.segments[0]
    fs = flat.FlatSegment(plan, plan.epochs[0], bake, seg, HI, 'cpu',
                          None, chunk_samples=chunk_samples,
                          row_multiple=row_multiple)
    jfs = jflat.FlatSegment(jplan, jplan.epochs[0], jbake, jseg, HI,
                            chunk_samples=chunk_samples,
                            row_multiple=row_multiple)
    got = (fs.nb, fs.nc, fs.nch, fs.gch, fs.ng)
    assert got == (jfs.nb, jfs.nc, jfs.nch, jfs.gch, jfs.ng)
    assert fs.nch * fs.nc >= flat.padded_rows(fs.nb, row_multiple)
    if chunk_samples is None and row_multiple == 1:
        # the defaults leave the key as it was
        assert fs.key == flat.FlatSegment(plan, plan.epochs[0], bake, seg,
                                          HI, 'cpu', None).key


def _fake_chunk(kind, pub, ends):
    """A stage loop of one exchange; it records the reply it gets."""
    got = yield flat.Exchange(kind, ('x',), lambda: pub)
    ends['x'] = got[0]
    return got[0]


@pytest.mark.parametrize('kind', ['add32', 'add64', 'hold', 'once',
                                  'fill'])
def test_lockstep_exchanges_fold_like_the_serial_path(kind):
    """Each chunk's carry from run_lockstep = the serial fold of the
    earlier chunks' hand-ons, through inert chunks (no active sample,
    no valid sample), with the first active one anywhere."""
    rng = np.random.RandomState(5)
    n = 7
    i64 = torch.int64
    if kind in ('add32', 'add64'):
        seed = torch.tensor(int(rng.randint(0, 1 << 32)), dtype=i64)
        hi = (1 << 32) if kind == 'add32' else (1 << 62)
        pubs = [torch.tensor(int(rng.randint(0, hi, dtype=np.int64)) * (
            j % 3 != 1), dtype=i64) for j in range(n)]
    elif kind == 'hold':
        seed = torch.tensor(11, dtype=i64)
        pubs = [(torch.tensor(j in (2, 5)), torch.tensor(100 + j))
                for j in range(n)]
    elif kind == 'once':
        seed = torch.tensor(True)
        pubs = [torch.tensor(j >= 4) for j in range(n)]
    else:
        seed = torch.tensor(0.25)
        pubs = [torch.tensor(float('nan') if j in (0, 3, 4, 6)
                             else 1.0 + j) for j in range(n)]
    ends = [{} for _ in range(n)]
    steps = [_fake_chunk(kind, p, e) for p, e in zip(pubs, ends)]
    outs = timeshard.run_lockstep(steps, {'x': seed}, ends,
                                  [torch.device('cpu')] * n)
    want = seed
    for j in range(n):
        assert torch.equal(outs[j], want) or (
            kind == 'fill' and bool(torch.isnan(want)))
        want = timeshard._combine(kind, want, pubs[j])
    if kind == 'add32':
        assert int(outs[-1]) == (int(seed) + sum(int(p) for p in pubs[:-1])
                                 ) % (1 << 32)
    if kind == 'hold':
        assert [int(o) for o in outs] == [11, 11, 11, 102, 102, 102, 105]
    if kind == 'once':
        assert [bool(o) for o in outs] == [True] * 5 + [False] * 2
    if kind == 'fill':
        assert [float(o) for o in outs] == [0.25, 0.25, 2.0, 3.0, 3.0,
                                            3.0, 6.0]


@pytest.mark.parametrize('n', [2, 3, 5])
def test_kernel1_seed_patch_equals_the_whole_row(n):
    """Kernel 1's plain version on a row cut into n pieces, each on a NaN
    seed and patched with the look-back of the pieces' last outputs (the
    time axis's 'fill' exchange), = the whole row: pd == 0 runs across
    the cuts, a piece whose every sample is held, a first valid sample
    deep inside a later piece."""
    rng = np.random.RandomState(3)
    L = 60
    steps = rng.randint(1, 1 << 24, L).astype(np.int64)
    steps[:7] = 0                       # held from the row's start
    steps[20:45] = 0                    # a run across several cuts
    ph = torch.from_numpy(np.cumsum(steps) & tdsp.M32)[None]
    pilut = tdsp.wave_tables('cpu')[1][0]
    z = torch.zeros(1, dtype=torch.int64)
    pp = torch.tensor([int(ph[0, 0])])
    ps = torch.tensor([0.375])
    no = torch.zeros(1, dtype=torch.bool)
    whole = tdsp.wosc_s_filled_plain(pilut, 0, ph, pp, ps, z, no, z)[0]
    cuts = np.linspace(0, L, n + 1).astype(int)
    seed = ps[0]
    prev = pp
    held = 0
    for a, b in zip(cuts[:-1], cuts[1:]):
        raw = tdsp.wosc_s_filled_plain(
            pilut, 0, ph[:, a:b], prev, torch.tensor([float('nan')]), z,
            no, z)[0]
        held += bool(torch.isnan(raw).all())
        part = torch.where(torch.isnan(raw), seed, raw)
        assert torch.equal(part, whole[a:b])
        seed = timeshard._combine('fill', seed, raw[-1])
        prev = ph[0, b - 1:b]
    assert held > 0 or n == 2


def test_dryrun_multichip_time_axis(capsys):
    """The dry run's check 4 on eight CPU shards."""
    from saugns_tpu_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(['cpu'] * 8)
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 4 and all(line.endswith(': ok') for line in out)
    assert "time-axis shard of a real program over {'sp': 8}" in out[3]


# -- the graph path (a tape a segment key) ------------------------------------

_JTS = {}
# the scripts whose JAX TimeShardRender render over 2 and 3 devices
# differs from the host renderer (and JaxGenerator) from a shard edge on:
# the first sample of the second or third shard (ROADMAP C); the port's
# time axis equals the host renderer on them
JAX_TIME_AXIS_DIFFERS = ('ramp_ends', 'rasg_k3', 'wave_hold', 'wave_k2')


def _jax_timeshard(name, n):
    """The JAX package's TimeShardRender of script ``name`` over ``n`` of
    its virtual devices, once."""
    if (name, n) not in _JTS:
        src, srate = SCRIPTS[name]
        jts = JTimeShardRender(_jprog(src), srate,
                               JMesh(np.asarray(jax.devices()[:n]), ('sp',)))
        _JTS[name, n] = jts.render_host()
    return _JTS[name, n]


@pytest.mark.parametrize('n', [2, 3])
@pytest.mark.parametrize('name', sorted(SCRIPTS))
def test_timeshard_graphs_equal_eager_and_jax(name, n):
    """graphs=True (on the CPU: the template's loops driven on the tape's
    static buffers) = graphs=False = TorchGenerator = the host renderer =
    the JAX package's TimeShardRender, to the bit, with the same
    exchanges by kind; a second and a third render = the first. Where
    the JAX TimeShardRender differs from the host renderer, it differs
    from the port too."""
    if len(jax.devices()) < n:
        pytest.skip('needs %d virtual devices' % n)
    src, srate = SCRIPTS[name]
    ts = _port(src, srate, n)
    got = ts.render_host()
    eager = TimeShardRender(stt.compile_script(src), srate,
                            Mesh(['cpu'] * n, ('sp',)), graphs=False)
    assert np.array_equal(got, eager.render_host())
    assert ts.exchanges == eager.exchanges and ts.exchanges
    assert eager.graph_stats()['captures'] == 0
    assert np.array_equal(got, _refs(name)[0])
    assert np.array_equal(got, _refs(name)[1])
    assert np.array_equal(got, _jax_timeshard(name, n)) \
        == (name not in JAX_TIME_AXIS_DIFFERS)
    for _ in range(2):
        assert np.array_equal(ts.render_host(), got)
        assert ts.exchanges == eager.exchanges
    st = ts.graph_stats()
    assert st['tapes'] == len({fs.key for _, fs in ts.segs})
    assert st['exchanges'] == eager.exchanges


def _notes(k):
    return ' | '.join('Wsin f%d t.05 a.4 p[Wsin r2 a.3]' % (196 + 7 * i)
                      for i in range(k))


def test_timeshard_one_key_records_one_tape():
    """Segments of one key share one tape: 2 and 9 notes of one template
    capture alike (the reset, init and fini graphs and the pieces of
    one segment); every later segment and render runs the pieces
    again."""
    stats = {}
    for k in (2, 9):
        ts = _port(_notes(k), LO, 2)
        assert len(ts.segs) == k and len({fs.key for _, fs in ts.segs}) == 1
        for _ in range(2):
            ts.render_device()
        stats[k] = st = ts.graph_stats()
        assert st['tapes'] == 1
        tape, = ts._tapes.values()
        pieces = sum(tape.pieces)
        # about five exchanges an oscillator, 2 oscillators a note
        assert pieces == 2 * (1 + sum(st['exchanges'].values()) // k)
        assert st['captures'] == 3 + pieces
        assert st['replays'] == 2 * (1 + k * (2 + pieces))
    assert stats[2]['captures'] == stats[9]['captures']
    assert stats[9]['exchanges'] == {kd: v * 9 // 2 for kd, v
                                     in stats[2]['exchanges'].items()}


def _raise(*_a, **_k):
    raise AssertionError('an upload or host sync during a render')


@pytest.mark.parametrize('name', ['multi', 'wave_hold', 'rasg_k3',
                                  'noise_vi'])
def test_timeshard_warm_render_uploads_nothing(name, monkeypatch):
    """After the first render, a render calls no torch.from_numpy,
    torch.tensor, Tensor.item, .cpu or .tolist and converts no tensor to
    a Python number or truth value: on the card each would break a
    capture or sync the host. (The self-PM kernels' plain versions,
    which the CPU runs, step through the active samples on the host.)"""
    src, srate = SCRIPTS[name]
    ts = _port(src, srate, 3)
    want = ts.render_host()
    with monkeypatch.context() as m:
        for obj, attr in ((torch, 'from_numpy'), (torch, 'tensor'),
                          (torch.Tensor, 'item'), (torch.Tensor, 'cpu'),
                          (torch.Tensor, 'tolist'),
                          (torch.Tensor, '__bool__'),
                          (torch.Tensor, '__int__'),
                          (torch.Tensor, '__float__'),
                          (torch.Tensor, '__index__')):
            m.setattr(obj, attr, _raise)
        pieces = ts.render_device()
    assert np.array_equal(ts.assemble(pieces), want)


class _FakeGraph:
    """Stands in for torch.cuda.CUDAGraph on the CPU: the capture runs
    the piece once and a replay runs nothing."""

    def capture_begin(self, *_a, **_k):
        pass

    def capture_end(self):
        pass

    def replay(self):
        pass


@contextlib.contextmanager
def _fake_graph(_graph, **_kw):
    yield


def _fake_capture(m):
    m.setattr(torch.cuda, 'CUDAGraph', _FakeGraph)
    m.setattr(torch.cuda, 'graph', _fake_graph)
    m.setattr(torch.cuda, 'set_stream', lambda _s: None)
    m.setattr(torch.cuda, 'graph_pool_handle', lambda: None)
    m.setattr(graphs, '_capture_nodes', lambda: 3)


def _counting(m):
    """Route the time axis's kernel dispatchers to their plain versions,
    counting each call in kernels.LAUNCHES as the wrappers count
    launches."""
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
            ('wosc_selfmod', 'wosc_selfmod', tdsp.wosc_selfmod_plain),
            ('rasg_selfmod', 'rasg_selfmod', tdsp.rasg_selfmod_plain)):
        m.setattr(tdsp, attr, wrap(name, plain))


@pytest.mark.parametrize('name', ['multi', 'selfpm_k5', 'seq'])
def test_timeshard_tape_replays_without_a_generator(name, monkeypatch):
    """With the capture faked (a piece runs once, a replay runs nothing),
    the first render records each key's tape and every later render
    runs the tape alone: no stage loop, no capture, and the recorded
    pieces' launches counted at each replay (N renders count what N op
    by op renders count)."""
    src, srate = SCRIPTS[name]
    with monkeypatch.context() as m:
        _counting(m)
        kernels.reset_launches()
        want = _port(src, srate, 2).render_host()
        launches = dict(kernels.LAUNCHES)
        assert sum(launches.values()) > 0
        _fake_capture(m)
        ts = _port(src, srate, 2)
        ts.prepare()
        for d in ts.disps:
            d.capture = True
        kernels.reset_launches()
        assert ts.render_host().shape == want.shape
        first = ts.graph_stats()
        assert first['nodes'] == 3 * first['captures']
        m.setattr(flat.FlatSegment, '_chunk_steps', _raise)
        for _ in range(2):
            ts.render_device()
        st = ts.graph_stats()
    assert dict(kernels.LAUNCHES) == {k: 3 * v for k, v in launches.items()}
    assert st['captures'] == first['captures']
    assert st['replays'] == 3 * first['replays']
    assert st['exchanges'] == first['exchanges']
    assert st['replay_s'] > 0


def test_timeshard_failed_capture_raises(monkeypatch):
    """A capture that fails raises out of the render (nothing runs op by
    op in its place), and the next render records the key's tape
    anew."""
    src, srate = SCRIPTS['wave_k2']
    want = _refs('wave_k2')[0]

    class Broken(_FakeGraph):
        n = 0

        def capture_end(self):
            Broken.n += 1
            if Broken.n == 5:
                raise RuntimeError('capture invalidated')
    with monkeypatch.context() as m:
        _fake_capture(m)
        m.setattr(torch.cuda, 'CUDAGraph', Broken)
        ts = _port(src, srate, 2)
        ts.prepare()
        for d in ts.disps:
            d.capture = True
        with pytest.raises(RuntimeError, match='capture invalidated'):
            ts.render_host()
        assert not ts._tapes
        assert np.array_equal(ts.render_host(), want)
