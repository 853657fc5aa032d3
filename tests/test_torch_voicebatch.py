"""The voice axis as a batch axis, on the CPU: the row forms of kernels
2, 3 and 4's plain versions, ``FlatSegment.stack`` (a slab of voices as
one stage loop over voice rows), and ``BankRender`` / ``MeshRender``
rendering in slabs and signature groups, against the JAX package on the
CPU platform (8 virtual devices, tests/conftest.py) and the port's own
one-voice segments and TorchGenerator. All renders at 96 kHz.

Tolerances: the row forms equal their 1-D plain versions row by row;
each voice's float32 output of a slab is byte-equal to its one-voice
segment's, and the state the slab writes back equal to the voices'
one by one; the ordered mix (one device, the ring) byte-equal (float32
mix and int16) to the JAX package's BankRender / MeshRender, at 1, 2
and 4 slabs; 'psum' within one int16 LSB of the JAX package's."""
import functools
import zlib

import numpy as np
import pytest
import torch

import jax

jax.config.update('jax_platforms', 'cpu')

from jax.sharding import Mesh as JMesh  # noqa: E402
from saugns_tpu.lang.program import (ScriptArg as JArg,  # noqa: E402
                                     build_program as jbuild)
from saugns_tpu.parallel import meshrender as jmesh  # noqa: E402
from saugns_tpu.parallel import voicebank as jbank  # noqa: E402
import saugns_tpu_torch as stt  # noqa: E402
from saugns_tpu_torch.parallel.meshrender import (  # noqa: E402
    MeshRender, slab_width, voice_slabs)
from saugns_tpu_torch.parallel.sharding import Mesh  # noqa: E402
from saugns_tpu_torch.parallel.voicebank import (  # noqa: E402
    BankRender, make_bank_script, make_selfmod_bank_script)
from saugns_tpu_torch.render import tdsp  # noqa: E402
from saugns_tpu_torch.render.flat import FlatSegment  # noqa: E402
from saugns_tpu_torch.render.engine import TorchGenerator  # noqa: E402
from saugns_tpu_torch.render.state import (apply_records,  # noqa: E402
                                           make_state)
from tests.torch_jaxref import ensure_native_tables  # noqa: E402


@pytest.fixture(autouse=True, scope='module')
def _jax_native_tables():
    """The JAX package renders with its native wave tables, also on a
    cold build cache (tests/torch_jaxref.py)."""
    ensure_native_tables()


SRATE = 96000
M32 = (1 << 32) - 1
BUDGET = 'SAUGNS_TPU_BANK_SLAB_BUDGET'


def _bank(kind, n, seed):
    """An n-voice uniform bank of voices of ``kind`` (KINDS), their
    parameters drawn from ``seed``."""
    rng = np.random.RandomState(seed)
    lines = ['S a.m%.3f' % (1.0 / n)]
    for _ in range(n):
        lines.append(KINDS[kind].format(
            f=rng.uniform(60, 600), g=rng.uniform(60, 600),
            r=rng.choice([0.5, 1.5, 2.0]), a=rng.uniform(0.1, 0.9),
            c=rng.uniform(-1, 1), s=rng.uniform(0.1, 0.6)))
    return '\n'.join(lines) + '\n'


# the banks the renderers are held to the JAX package on: PM, self-PM,
# and 13 voices (padded on 2 and 8 shards). A self-PM voice is short:
# its plain recurrences step through the samples in Python
BANKS = {'pm8': make_bank_script(8, seed=4, duration=0.05),
         'selfpm8': make_selfmod_bank_script(8, seed=5, duration=0.01),
         'pm13': make_bank_script(13, seed=6, duration=0.05)}
# uniform banks of every stage kind of the flat path: line goals, FM
# (kernel 2), red / violet / blue-violet noise, RasG with self-PM
# (kernels 3 and 6), range modulation
KINDS = {
    'sweep': 'Wsin f{f:.1f}[g{g:.1f} t.03 lexp] t.05 a{a:.2f} '
             'c{c:.2f} p[Wsin r{r} a[g{s:.2f} t.02]]',
    'noise_pm': 'Wsin f{f:.1f} t.05 a{a:.2f} c{c:.2f} p[Nre a{s:.2f}]',
    'violet': 'Nvi t.05 a{a:.2f} c{c:.2f}',
    'blue_violet': 'Nbv t.04 a{a:.2f}',
    'rasg_selfpm': 'Rcos mf f{f:.1f} p.a{s:.2f}[Rlin f7 a.4] a{a:.2f} '
                   't.01',
    'rangemod': 'Wsin f{f:.0f}.r{g:.0f}[Wsin f3] t.05 a{a:.2f} c{c:.2f}',
    'selfpm': 'Wsin f{f:.1f} t.01 a{a:.2f} c{c:.2f} p.a{s:.2f}',
}


def _jprog(src):
    return jbuild(JArg(str=src, is_path=False, no_time=True, predef=[]))


def _jmesh(n):
    if len(jax.devices()) < n:
        pytest.skip('needs 8 virtual devices')
    return None if n == 1 else JMesh(np.asarray(jax.devices()[:n]),
                                     ('voices',))


def _tmesh(n):
    return None if n == 1 else Mesh(['cpu'] * n, ('voices',))


@functools.lru_cache(maxsize=None)
def _jax_bank(name, n, mix):
    """(float32 mix, int16) of the JAX package's BankRender."""
    br = jbank.BankRender(_jprog(BANKS[name]), SRATE, mesh=_jmesh(n),
                          ordered_mix=True, mesh_mix=mix)
    return np.asarray(br.render()), np.asarray(br.render_i16())


@functools.lru_cache(maxsize=None)
def _engine(src):
    g = TorchGenerator(stt.compile_script(src), SRATE, 'cpu')
    return g.assemble(g.render_device())


# -- the row forms of kernels 2, 3 and 4's plain versions --------------------

def _rows_case(kind, shape, fill, seed):
    rng = np.random.RandomState(seed)
    if kind == 'max32':
        x = rng.randint(0, 1 << 31, size=shape, dtype=np.int64)
        if fill == 'wrap':
            # the domain's edges: zeros, runs of equal values, 2^31 - 1
            x[..., ::3] = 0
            x[..., 1::5] = (1 << 31) - 1
        return torch.from_numpy(x.astype(np.int32))
    if fill == 'wrap':
        # every sum wraps: u32 values near 2^32, u64 bits near 2^64
        x = rng.randint(M32 - 255, M32 + 1, size=shape, dtype=np.uint64)
        if kind == 'add64':
            x = (x << np.uint64(32)) | x
        return torch.from_numpy(x.view(np.int64))
    return torch.from_numpy(rng.randint(-(1 << 62), 1 << 62, size=shape,
                                        dtype=np.int64))


@pytest.mark.parametrize('shape', [(1, 1), (1, 4097), (3, 1), (5, 2),
                                   (4, 4097), (2, 9000)])
@pytest.mark.parametrize('fill', ['wrap', 'random'])
@pytest.mark.parametrize('kind', ['add32', 'add64', 'max32'])
def test_row_forms_plain(kind, fill, shape):
    """prefix_sum_rows_plain (bits 32 and 64) and scan_max_i32_plain on
    (V, L) rows = the 1-D plain version of each row; the 1-D results
    against numpy's cumulative sum / max."""
    x = _rows_case(kind, shape, fill,
                   zlib.crc32(repr((kind, fill, shape)).encode()))
    if kind == 'max32':
        rows, one = tdsp.scan_max_i32_plain, tdsp.scan_max_i32_plain
    else:
        bits = 32 if kind == 'add32' else 64
        rows = functools.partial(tdsp.prefix_sum_rows_plain, bits=bits)
        one = tdsp.prefix_sum_plain if bits == 32 \
            else tdsp.prefix_sum_u64_plain
    got = rows(x)
    assert got.shape == x.shape and got.dtype == x.dtype
    for r in range(shape[0]):
        want = one(x[r])
        assert torch.equal(got[r], want)
        xr = x[r].numpy()
        if kind == 'add32':
            ref = np.cumsum(xr.astype(np.uint64) & np.uint64(M32)) \
                & np.uint64(M32)
            assert np.array_equal(want.numpy().astype(np.uint64), ref)
        elif kind == 'add64':
            ref = np.cumsum(xr.view(np.uint64), dtype=np.uint64)
            assert np.array_equal(want.numpy().view(np.uint64), ref)
        else:
            ref = np.maximum.accumulate(np.maximum(xr, 0))
            assert np.array_equal(want.numpy(), ref)
    # the dispatchers take the rows on the CPU through the same plain
    # versions
    if kind == 'max32':
        assert torch.equal(tdsp.scan_max_i32(x), got)
    else:
        assert torch.equal(tdsp.prefix_sum_rows(x, bits), got)


# -- a slab of voices as one stage loop ---------------------------------------

def _state(br):
    return apply_records(make_state(br.plan, 'cpu'), 0, br.rec_hi,
                         br.plan.rec_arrays)


def _voice_slabs(br, voices):
    """The one slab builder on bank ``br``'s voices ``voices``, on the
    CPU: [(voice ids, FlatSegment)]."""
    bake = br.sim.bakes[-1]
    return voice_slabs(br.plan, br.ep, bake, bake.segments[0], voices,
                       SRATE, 'cpu', tdsp.wave_tables('cpu')[1])


@pytest.mark.parametrize('kind', sorted(KINDS) + ['pm', 'pm_inert'])
def test_stacked_segment_equals_its_voices(kind):
    """FlatSegment.stack of a bank's voices: each voice's float32 output
    byte-equal to its one-voice segment's, the state written back equal
    to the voices' one by one; an inert padding voice renders exact
    zeros and writes nothing."""
    src = make_bank_script(5, seed=9, duration=0.05) \
        if kind.startswith('pm') else _bank(kind, 5, seed=11)
    br = BankRender(stt.compile_script(src), SRATE, device='cpu')
    # voice ids past the last voice (4): inert copies of it
    ks = [0, 1, 2, 3, 4] + ([5, 6] if kind == 'pm_inert' else [])
    inert = [k >= 5 for k in ks]
    members = [fs for k in ks for _vs, fs in _voice_slabs(br, [k])]
    (vs, slab), = _voice_slabs(br, ks)
    assert vs == ks and isinstance(slab, FlatSegment)
    assert slab.V == len(ks) and slab.key == members[0].key + (len(ks),)
    st0 = _state(br)
    st_v, out_v = slab.run({k: v.clone() for k, v in st0.items()})
    assert out_v.shape == (len(ks), members[0].nb, members[0].B, 2)
    st = {k: v.clone() for k, v in st0.items()}
    for i, m in enumerate(members):
        st, out = m.run(st)
        assert out.dtype == torch.float32
        assert out.numpy().tobytes() == out_v[i].numpy().tobytes(), i
        if inert[i]:
            assert not out.any()
    for k in ('sf', 'si', 'vdur'):
        assert torch.equal(st_v[k], st[k]), k


# -- BankRender in slabs ------------------------------------------------------

def _bank_cases():
    cases = []
    for name, src in sorted(BANKS.items()):
        nv = 13 if name == 'pm13' else 8
        for n, mixes in ((1, ('one',)), (2, ('ring', 'psum')),
                         (8, ('ring', 'psum'))):
            per = -(-nv // n)
            for mix in mixes:
                for slabs in (1, 2, 4):
                    if per % slabs == 0:
                        cases.append((name, n, mix, slabs))
    return cases


@pytest.mark.parametrize('name,n,mix,slabs', _bank_cases())
def test_bank_slabs_equal_jax(monkeypatch, name, n, mix, slabs):
    """BankRender on one CPU device and on 2 and 8 CPU shards, in 1, 2
    or 4 slabs a shard (SAUGNS_TPU_BANK_SLAB_BUDGET): the ordered mix
    (one device, the ring) byte-equal to the JAX package's BankRender
    (float32 mix and int16) and to TorchGenerator (int16); 'psum'
    within one LSB of the JAX package's. A shard's slabs share one
    graph."""
    src = BANKS[name]
    prg = stt.compile_script(src)
    br = BankRender(prg, SRATE, mesh=_tmesh(n), device='cpu',
                    mesh_mix='psum' if mix == 'one' else mix)
    per = -(-br.n_voices // n)
    monkeypatch.setenv(BUDGET, str(per // slabs * br.samples_per_voice()))
    assert slab_width(per, br.samples_per_voice()) == per // slabs
    shards = br.prepare()
    assert [[seg.V for seg in sh.slabs] for sh in shards] == \
        [[per // slabs] * slabs] * n
    jmix, ji16 = _jax_bank(name, n, 'ring' if mix == 'one' else mix)
    got = br.render().numpy()
    got16 = br.render_i16().numpy()
    assert got.shape == jmix.shape
    if mix == 'psum':
        assert int(np.abs(got16.astype(np.int32) - ji16).max()) <= 1
    else:
        assert got.tobytes() == jmix.tobytes()
        assert np.array_equal(got16, ji16)
        assert np.array_equal(got16, _engine(src))
    st = br.graph_stats()
    # per shard: the reset and one slab graph; two renders
    assert st['captures'] == 2 * n
    assert st['replays'] == n * 2 * (1 + slabs)


@pytest.mark.parametrize('kind', ['sweep', 'noise_pm', 'rasg_selfpm'])
def test_bank_kinds_equal_engine(monkeypatch, kind):
    """Banks of the other stage kinds, in 2 slabs on one device and on
    the ring over 2 shards: int16 = TorchGenerator's."""
    src = _bank(kind, 8, seed=13)
    prg = stt.compile_script(src)
    spv = BankRender(prg, SRATE, device='cpu').samples_per_voice()
    monkeypatch.setenv(BUDGET, str(2 * spv))
    want = _engine(src)
    for mesh in (None, _tmesh(2)):
        br = BankRender(prg, SRATE, mesh=mesh, mesh_mix='ring',
                        device='cpu')
        assert np.array_equal(br.render_i16().numpy(), want)


def test_bank_launches_once_a_slab(monkeypatch):
    """The self-PM bank's kernels 5, 1 and 4 run once a slab, not once
    a voice: 8 voices in 2 slabs are 2 calls of each a render."""
    src = make_selfmod_bank_script(8, seed=3, duration=0.02)
    prg = stt.compile_script(src)
    br = BankRender(prg, SRATE, device='cpu')
    monkeypatch.setenv(BUDGET, str(4 * br.samples_per_voice()))
    calls = {}

    def counted(name):
        fn = getattr(tdsp, name)

        def call(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        monkeypatch.setattr(tdsp, name, call)
    for name in ('wosc_selfmod', 'wosc_s_filled', 'scan_max_i32'):
        counted(name)
    br.render()
    assert calls == {'wosc_selfmod': 2}
    pm = BankRender(stt.compile_script(make_bank_script(
        8, seed=3, duration=0.02)), SRATE, device='cpu')
    calls.clear()
    pm.render()
    # two oscillators a voice: kernel 1 and the row hold's kernel 4
    # twice a slab
    assert calls == {'wosc_s_filled': 4, 'scan_max_i32': 4}


@pytest.mark.parametrize('name', sorted(BANKS))
def test_bank_and_mesh_build_the_same_slabs(monkeypatch, name):
    """One uniform bank on one device, in slabs of at most 4 voices:
    BankRender and MeshRender build slabs of the same keys and widths,
    their rows the same voices in the same order (the same tables), and
    render byte-equal int16."""
    prg = stt.compile_script(BANKS[name])
    br = BankRender(prg, SRATE, device='cpu')
    monkeypatch.setenv(BUDGET, str(4 * br.samples_per_voice()))
    mr = MeshRender(prg, SRATE, device='cpu')
    mr.prepare()
    bank = br.prepare()[0].slabs
    mesh = [fs for _ep, segs in mr.epoch_segs for s in segs
            for _d, _vs, fs in s.slabs]
    assert len(bank) == len(mesh) > 1
    for a, b in zip(bank, mesh):
        assert a.key == b.key and a.V == b.V
        for t, u in zip([a.dyn] + a.xs, [b.dyn] + b.xs):
            ta, tb = t.arrays(), u.arrays()
            assert ta.keys() == tb.keys()
            assert all(np.array_equal(ta[k], tb[k]) for k in ta)
    assert br.render_i16().numpy().tobytes() == \
        mr.render_i16().tobytes()


def test_slab_width_rule(monkeypatch):
    """At most 256 voices and the sample budget, shrunk to a divisor of
    the voice count; the budget must be an integer."""
    monkeypatch.delenv(BUDGET, raising=False)
    assert slab_width(1024, 96000) == 256
    assert slab_width(1024, 1 << 20) == 32
    assert slab_width(13, 100) == 13
    assert slab_width(12, 1 << 25) == 1
    monkeypatch.setenv(BUDGET, str(5 * 100))
    assert slab_width(12, 100) == 4
    assert slab_width(7, 100) == 1
    monkeypatch.setenv(BUDGET, 'many')
    with pytest.raises(ValueError, match='integer'):
        slab_width(8, 100)


# -- MeshRender on signature groups -------------------------------------------

def _mixed(kinds, later=None):
    """12 voices of three signatures in turn (``kinds``): on two shards
    each shard holds two voices of each signature, interleaved in voice
    id; then three violet noise voices, each ``later`` seconds after
    the one before, each a new epoch."""
    lines = [KINDS[kinds[k % 3]].format(
        f=110.0 + 17 * k, g=300.0 - 9 * k, r=1.5, a=0.1 + 0.05 * k,
        c=0.6 - 0.1 * k, s=0.2 + 0.02 * k) for k in range(12)]
    if later:
        lines += ['/%g ' % later + KINDS['violet'].format(
            a=0.2 + 0.1 * k, c=0.3 * k - 0.3) for k in range(3)]
    return '\n'.join(lines) + '\n'


# the JAX package's MeshRender writes no self-PM carry back between
# segments (its vmapped write-back, meshrender.py:174-215 there, covers
# K_WPHASE, K_RCYCLE, K_WRUN and K_NOISE), so a self-PM voice is held to
# it within one epoch, and across epochs to TorchGenerator only
MESH_PROGRAMS = {
    'epochs': _mixed(('sweep', 'noise_pm', 'rangemod'), 0.02),
    'selfpm': _mixed(('sweep', 'selfpm', 'rasg_selfpm'))}
SELFPM_EPOCHS = _mixed(('sweep', 'noise_pm', 'selfpm'), 0.003)


@functools.lru_cache(maxsize=None)
def _jax_mesh_render(src, n):
    jm = None if n == 1 else JMesh(np.asarray(jax.devices()[:n]),
                                   ('voices',))
    mr = jmesh.MeshRender(_jprog(src), SRATE, mesh=jm)
    return mr.render(), mr.render_i16()


def _groups(monkeypatch, src, n, width):
    """MeshRender of ``src`` on n CPU shards, its slabs checked: each
    shard's voices of one signature one slab (``width`` 0) or slabs of
    one voice."""
    if width:
        monkeypatch.setenv(BUDGET, '1')
    else:
        monkeypatch.delenv(BUDGET, raising=False)
    mr = MeshRender(stt.compile_script(src), SRATE, mesh=_tmesh(n),
                    device='cpu')
    mr.prepare()
    widths = [fs.V for _ep, segs in mr.epoch_segs for s in segs
              for _d, _vs, fs in s.slabs]
    assert max(widths) == (1 if width else 4 // n)
    for _ep, segs in mr.epoch_segs:
        for s in segs:
            for d, vs, fs in s.slabs:
                assert vs == sorted(vs)
                assert all(mr.shard_of[v] == d for v in vs)
    return mr


@pytest.mark.parametrize('width', [0, 1], ids=['groups', 'slabs_of_one'])
@pytest.mark.parametrize('n', [1, 2])
@pytest.mark.parametrize('name', sorted(MESH_PROGRAMS))
def test_meshrender_groups_equal_jax(monkeypatch, name, n, width):
    """MeshRender of a program of several signatures, interleaved, on
    one CPU device and on two CPU shards: float32 mix and int16 equal
    to the JAX package's MeshRender, int16 to TorchGenerator."""
    if len(jax.devices()) < n:
        pytest.skip('needs virtual devices')
    src = MESH_PROGRAMS[name]
    mr = _groups(monkeypatch, src, n, width)
    jf32, ji16 = _jax_mesh_render(src, n)
    got = mr.render()
    assert got.tobytes() == np.asarray(jf32).tobytes()
    assert np.array_equal(mr.render_i16(), np.asarray(ji16))
    assert np.array_equal(mr.render_i16(), _engine(src))


@pytest.mark.parametrize('width', [0, 1], ids=['groups', 'slabs_of_one'])
def test_meshrender_selfpm_across_epochs(monkeypatch, width):
    """Self-PM voices that run on across four epochs, on two CPU
    shards: int16 equal to TorchGenerator's."""
    mr = _groups(monkeypatch, SELFPM_EPOCHS, 2, width)
    assert np.array_equal(mr.render_i16(), _engine(SELFPM_EPOCHS))
