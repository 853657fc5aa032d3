"""The second slice of the port -- noise, random-segment (RasG)
oscillators and self-PM -- on the CPU against the JAX package on the
CPU platform: each new DSP function against its jdsp twin on seeded
numpy inputs, and whole renders against JaxGenerator at 6 kHz.
Tolerance: bit-equality of every float (compared as bit patterns) and
byte-equality of the int16 output."""
import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax

jax.config.update('jax_platforms', 'cpu')

import jax.numpy as jnp  # noqa: E402

from saugns_tpu.render import engine as jeng  # noqa: E402 (x64 on)
from saugns_tpu.render import jdsp  # noqa: E402
from saugns_tpu.parallel.voicebank import \
    make_selfmod_bank_script as jselfbank  # noqa: E402
from saugns_tpu_torch import convert  # noqa: E402
from saugns_tpu_torch.lang import program as P  # noqa: E402
from saugns_tpu_torch.lang.program import (ScriptArg as TArg,  # noqa: E402
                                           build_program as tbuild)
from saugns_tpu_torch.parallel.voicebank import \
    make_selfmod_bank_script  # noqa: E402
from saugns_tpu_torch.render import flat as tflat  # noqa: E402
from saugns_tpu_torch.render import tdsp  # noqa: E402
from saugns_tpu_torch.render.engine import TorchGenerator  # noqa: E402
from saugns_tpu_torch.render.plan import (K_RCYCLE,  # noqa: E402
                                          K_RRUN_SELF, K_WPHASE,
                                          K_WRUN_SELF)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_engine import render_pair  # noqa: E402
from tests.torch_jaxref import ensure_native_tables  # noqa: E402


@pytest.fixture(autouse=True, scope='module')
def _jax_native_tables():
    """The JAX package renders with its native wave tables, also on a
    cold build cache (tests/torch_jaxref.py)."""
    ensure_native_tables()


M32 = 0xffffffff
SLEN = 1 << tdsp.SLENBITS


def same_bits(a, b):
    a = np.atleast_1d(np.asarray(a))
    b = np.atleast_1d(np.asarray(b))
    if a.shape != b.shape:
        return False
    if a.dtype.kind == 'f':
        return a.dtype == b.dtype and np.array_equal(a.view(np.uint8),
                                                     b.view(np.uint8))
    return np.array_equal(a.astype(np.int64), b.astype(np.int64))


def u32_inputs(seed, n=20000):
    """Random u32 values with the edges of the range in front."""
    x = np.random.RandomState(seed).randint(0, 1 << 32, n,
                                            dtype=np.int64)
    x[:10] = [0, 1, 2, 0x7fffffff, 0x80000000, 0x80000001, 0xfffffffe,
              M32, 0x20000000, 0xe0000000]
    return jnp.asarray(x.astype(np.uint32)), torch.from_numpy(x)


# -- integer and noise DSP ----------------------------------------------------

@pytest.mark.parametrize('name', ['ranfast32', 'mcg32', 'foldhd32'])
def test_u32_hashes(name):
    xj, xt = u32_inputs(1)
    assert same_bits(getattr(jdsp, name)(xj),
                     getattr(tdsp, name)(xt).numpy())


def test_franssgauss32():
    xj, xt = u32_inputs(2)
    assert same_bits(jdsp.franssgauss32(xj), tdsp.franssgauss32(xt).numpy())


def test_sinpi_d5():
    x = np.random.RandomState(3).uniform(-2, 2, 5000).astype(np.float32)
    assert same_bits(jdsp.sinpi_d5(jnp.asarray(x)),
                     tdsp.sinpi_d5(torch.from_numpy(x)).numpy())


def test_floor_i32_saturates_as_xla():
    x = np.array([0.5, -0.5, -1.0, 2.5e9, -2.5e9, 3e38, -np.inf, np.inf,
                  np.nan, 2147483520.0, -2147483648.0], np.float32)
    want = np.asarray(jnp.floor(jnp.asarray(x)).astype(jnp.int32))
    assert same_bits(want, tdsp.floor_i32(torch.from_numpy(x)).numpy())


def test_fmax_fmin_as_xla():
    a = np.array([-0.0, 0.0, np.nan, 1.0, -2.0, 3.0], np.float32)
    b = np.array([0.0, -0.0, 1.0, np.nan, -2.0, -3.0], np.float32)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    assert same_bits(jnp.maximum(a, b), tdsp.fmax(at, bt).numpy())
    assert same_bits(jnp.minimum(a, b), tdsp.fmin(at, bt).numpy())


# -- RasG maps ----------------------------------------------------------------

@pytest.mark.parametrize('violet', [False, True], ids=['plain', 'violet'])
@pytest.mark.parametrize('func', range(6))
def test_rasg_map(func, violet):
    """Against rasg_map compiled, as the JAX renderer always runs it:
    compiled, its _divi2 truncates INT32_MIN / 2 to -2^30 where the
    op-by-op evaluation gives +2^30."""
    xj, xt = u32_inputs(10 + func)
    oflags = P.RAS_O_VIOLET if violet else 0
    for level in (0, 3, 9, P.ras_level(8), P.ras_level(9), 30):
        for alpha in (0x9e3779b9, 12345):
            aj, bj = jax.jit(functools.partial(
                jdsp.rasg_map, func, level, alpha, oflags))(xj)
            at, bt = tdsp.rasg_map(func, level, alpha, oflags, xt)
            assert same_bits(aj, at.numpy()), (level, alpha)
            assert same_bits(bj, bt.numpy()), (level, alpha)


FLAG_SETS = [0, P.RAS_O_PERLIN, P.RAS_O_HALFSHAPE, P.RAS_O_ZIGZAG,
             P.RAS_O_SQUARE, P.RAS_O_VIOLET,
             P.RAS_O_PERLIN | P.RAS_O_HALFSHAPE,
             P.RAS_O_PERLIN | P.RAS_O_ZIGZAG | P.RAS_O_SQUARE, 0x1f]


@pytest.mark.parametrize('oflags', FLAG_SETS)
def test_rasg_shape(oflags):
    rng = np.random.RandomState(oflags)
    n = 5000
    ph = rng.uniform(0, 1, n).astype(np.float32)
    a = rng.uniform(-1, 1, n).astype(np.float32)
    b = rng.uniform(-1, 1, n).astype(np.float32)
    a[:4] = [0.0, -0.0, 0.5, -0.25]
    b[:4] = [-0.0, 0.0, 0.5, 0.75]
    for line in range(13):
        want = jdsp.rasg_shape(line, oflags, jnp.asarray(ph),
                               jnp.asarray(a), jnp.asarray(b))
        got = tdsp.rasg_shape(line, oflags, torch.from_numpy(ph),
                              torch.from_numpy(a), torch.from_numpy(b))
        assert same_bits(want, got.numpy()), line


# -- u64 prefix sum and the row cumsum ---------------------------------------

@pytest.mark.parametrize('n', [1, 2, 1023, 4099, 100003])
@pytest.mark.parametrize('fill', ['random', 'ones'])
def test_prefix_sum_u64_plain(n, fill):
    rng = np.random.RandomState(n)
    x = rng.randint(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64) \
        if fill == 'random' else np.full(n, -1, np.int64)
    got = tdsp.prefix_sum_u64_plain(torch.from_numpy(x)).numpy()
    want = np.asarray(jdsp.prefix_sum(jnp.asarray(x.view(np.uint64))))
    assert np.array_equal(got.view(np.uint64), want)
    assert np.array_equal(got, np.cumsum(x.view(np.uint64)).view(np.int64))


@pytest.mark.parametrize('bits', [32, 64])
def test_row_cumsum(bits):
    rng = np.random.RandomState(bits)
    if bits == 32:
        x = rng.randint(0, 1 << 32, 300, dtype=np.int64)
        want = np.asarray(jnp.cumsum(jnp.asarray(x.astype(np.uint32))))
    else:
        x = rng.randint(-(1 << 63), (1 << 63) - 1, 300, dtype=np.int64)
        want = np.asarray(jnp.cumsum(jnp.asarray(x.view(np.uint64))))
    got = tdsp.row_cumsum(torch.from_numpy(x), bits).numpy()
    assert np.array_equal(got, want.astype(np.int64) if bits == 32
                          else want.view(np.int64))


# -- self-PM recurrences -----------------------------------------------------

def _selfmod_stream(rng, L):
    """A wosc self-PM sample stream: audio-rate phases with a pd == 0
    run (no feedback over it), two inactive gaps, and seeds."""
    inc = rng.randint(1 << 18, 1 << 26, L).astype(np.int64)
    inc[L // 4:L // 4 + 40] = 0
    am = rng.uniform(-2, 2, L).astype(np.float32)
    am[L // 4 - 5:L // 4 + 45] = 0
    act = np.ones(L, bool)
    act[:7] = False
    act[L // 2:L // 2 + 60] = False
    ph = (rng.randint(0, 1 << 32) + np.cumsum(inc)) & M32
    return ph, am, act


@pytest.mark.parametrize('reset', [False, True], ids=['seed', 'reset'])
@pytest.mark.parametrize('wave', [0, 1, 3, 7, 9, 11])
def test_wosc_selfmod_plain(wave, reset):
    rng = np.random.RandomState(wave + 100 * reset)
    L = 700
    ph, am, act = _selfmod_stream(rng, L)
    # an unconsumed reset: the first active sample pairs with its own
    # phase minus SLEN, resolved into pp0 by the caller
    pp0 = (int(ph[7]) - SLEN) & M32 if reset \
        else rng.randint(0, 1 << 32)
    ps0, fb0 = np.float32(0.25), np.float32(-0.5)
    piluts = jdsp.get_tables()[1]
    oj, ppj, psj, fbj = jdsp.wosc_selfmod_masked(
        piluts[wave], wave, jnp.asarray(ph.astype(np.uint32)),
        jnp.asarray(am), jnp.asarray(act), jnp.uint32(pp0),
        jnp.float32(ps0), jnp.float32(fb0))
    _, tp = convert.tables(*jdsp.get_tables(), 'cpu')
    ot, ppt, pst, fbt = tdsp.wosc_selfmod_plain(
        tp[wave], wave, torch.from_numpy(ph)[None],
        torch.from_numpy(am)[None], torch.from_numpy(act)[None],
        torch.tensor([pp0]), torch.tensor([ps0]), torch.tensor([fb0]))
    assert same_bits(oj, ot[0].numpy())
    assert int(ppj) == int(ppt[0])
    assert same_bits(psj, pst.numpy()) and same_bits(fbj, fbt.numpy())


def test_wosc_selfmod_rows_match_single_rows():
    rng = np.random.RandomState(7)
    rows = [_selfmod_stream(rng, 300) for _ in range(3)]
    ph, am, act = (torch.from_numpy(np.stack(c)) for c in zip(*rows))
    pp0 = torch.from_numpy(rng.randint(0, 1 << 32, 3).astype(np.int64))
    ps0 = torch.tensor([0.1, -0.2, 0.3])
    fb0 = torch.tensor([0.0, 0.5, -0.5])
    pil = tdsp.wave_tables('cpu')[1][2]
    both = tdsp.wosc_selfmod_plain(pil, 2, ph, am, act, pp0, ps0, fb0)
    for r in range(3):
        one = tdsp.wosc_selfmod_plain(
            pil, 2, ph[r:r + 1], am[r:r + 1], act[r:r + 1],
            pp0[r:r + 1], ps0[r:r + 1], fb0[r:r + 1])
        for b, o in zip(both, one):
            assert torch.equal(b[r:r + 1], o)


PV = P.RAS_O_PERLIN | P.RAS_O_VIOLET


@pytest.mark.parametrize('func,line,oflags', [
    (0, 0, 0), (1, 1, P.RAS_O_PERLIN), (2, 3, P.RAS_O_VIOLET),
    (3, 8, P.RAS_O_HALFSHAPE), (4, 9, P.RAS_O_ZIGZAG),
    (5, 7, P.RAS_O_SQUARE), (0, 10, P.RAS_O_VIOLET),
    (4, 12, 0x1f),
    # a Perlin amplitude other than 1 folds into the map's scale (lines
    # 3-7 and 11), or stays apart (pa == 1: sah, uwh, half-shape)
    (0, 4, P.RAS_O_PERLIN), (2, 11, P.RAS_O_PERLIN), (5, 6, PV),
    (3, 3, P.RAS_O_PERLIN | P.RAS_O_SQUARE), (2, 5, PV),
    (2, 2, PV), (2, 12, PV), (2, 1, PV | P.RAS_O_HALFSHAPE)])
def test_rasg_selfmod_plain(func, line, oflags):
    rng = np.random.RandomState(func * 13 + line)
    L = 600
    phase = rng.uniform(0, 1, L).astype(np.float32)
    cycle = rng.randint(0, 1 << 32, L).astype(np.int64)
    am = rng.uniform(-4, 4, L).astype(np.float32)
    act = rng.uniform(0, 1, L) < 0.85
    level = P.ras_level(9) if line == 9 else 5
    oj, psj, fbj = jdsp.rasg_selfmod_masked(
        func, line, level, 0x9e3779b9, oflags, jnp.asarray(phase),
        jnp.asarray(cycle.astype(np.uint32)), jnp.asarray(am),
        jnp.asarray(act), jnp.float32(0.1), jnp.float32(-0.3))
    ot, pst, fbt = tdsp.rasg_selfmod_plain(
        func, line, level, 0x9e3779b9, oflags,
        torch.from_numpy(phase)[None], torch.from_numpy(cycle)[None],
        torch.from_numpy(am)[None], torch.from_numpy(act)[None],
        torch.tensor([0.1]), torch.tensor([-0.3]))
    assert same_bits(oj, ot[0].numpy())
    assert same_bits(psj, pst.numpy()) and same_bits(fbj, fbt.numpy())


# -- renders ------------------------------------------------------------------

RASG_SELFPM = 'Rcos mf f60 p.a.5[Rlin f7 a.4] a.6 t.3'
SCRIPTS = ['N%s t.3 a.4' % c for c in P.NOISE_NAMES] \
    + ['Rlin m%s t.3 f300 a.5' % m for m in 'ugbtfa'] \
    + ['Rlin t.4 f300 a.5',
       'Rcos t.4 f80.r160[Wsin f2] a.7',
       'Wsin f110 t.5 p.a.3',
       RASG_SELFPM,
       # violet binary at level 9 (INT32_MIN halves), Perlin shapes,
       # self-PM with a folded and with a unit Perlin amplitude
       'Rcos mbv t.3 f300 a.5', 'Rexp mbvp t.3 f300 a.5',
       'Rexp mbp f90 p.a.7 a.6 t.2', 'Rsah mbvp3 f90 p.a.9 a.6 t.2']


@pytest.mark.parametrize('stereo', [True, False], ids=['stereo', 'mono'])
@pytest.mark.parametrize('script', SCRIPTS)
def test_script_byte_equal(script, stereo):
    want, got = render_pair(script, 6000, stereo)
    assert len(got) == len(want) and len(got) > 0
    assert np.any(got != 0)
    assert np.array_equal(got, want), int(np.sum(got != want))


@pytest.mark.parametrize('stereo', [True, False], ids=['stereo', 'mono'])
def test_selfmod_bank_byte_equal(stereo):
    src = make_selfmod_bank_script(8, seed=0, duration=0.2)
    assert src == jselfbank(8, seed=0, duration=0.2)
    want, got = render_pair(src, 6000, stereo)
    assert len(got) == (1200 * 2 if stereo else 1200)
    assert np.array_equal(got, want), int(np.sum(got != want))


def _segments(script):
    tp = tbuild(TArg(str=script, is_path=False, no_time=True, predef=[]))
    g = TorchGenerator(tp, 6000, 'cpu')
    return [s for ei in range(len(g.plan.epochs))
            for s in g._flat_epoch(ei)]


@pytest.mark.parametrize('script,kind', [
    ('Wsin f220 t12 ; f330 t3', K_WPHASE),
    ('Rlin f300 t12 ; f30 t3', K_RCYCLE),
    ('Rcos mb f60.5 t12 a.6', K_RCYCLE),
])
def test_row_ramp_byte_equal(script, kind):
    """A scalar-frequency phase over many rows of a chunk takes the
    affine row ramp (row totals summed by torch.cumsum, u32 for the
    wave phase, u64 for the RasG cycle phase); the output must not
    change."""
    segs = _segments(script)
    assert any(s.ep.stages[si].kind == kind and s.nc > 1
               for s in segs for si in s.scalar_freq)
    want, got = render_pair(script, 6000, True)
    assert np.array_equal(got, want), int(np.sum(got != want))


@pytest.mark.parametrize('script', [
    'Nre t25 a.4 ; Nbv t.3',
    'Nvi t25 a.4',
    'Rcos t25 f80.r160[Wsin f2] a.7',
    'Wsin f110 t.05 p.a.3 /.05 f220 /.05 p.a.6 /.05 f330',
    'Rcos mf f60 p.a.5[Rlin f7 a.4] a.6 t.05 /.05 f90 /.05 f20',
])
def test_many_chunks_byte_equal(script, monkeypatch):
    """One block per chunk and two chunks per group: the noise counter
    and previous value, the u64 cycle phase and the self-PM state
    cross chunk and group boundaries; the output must not change."""
    monkeypatch.setattr(tflat, 'FLAT_CHUNK', 1)
    monkeypatch.setattr(tflat, 'STREAM_GROUP', 2)
    want, got = render_pair(script, 6000, True)
    assert np.array_equal(got, want), int(np.sum(got != want))
    segs = _segments(script)
    assert max(s.nch for s in segs) >= 3 and max(s.ng for s in segs) >= 2


def _mix_pair(script, srate):
    """The float stereo mix of every flat segment, from the JAX
    renderer's FlatSegment.run and the port's, on identical tables and
    initial state."""
    from saugns_tpu.lang.program import (ScriptArg as JArg,
                                         build_program as jbuild)
    jg = jeng.JaxGenerator(jbuild(JArg(str=script, is_path=False,
                                       no_time=True, predef=[])), srate)
    jg._upload()
    jst = jeng.make_state(jg.plan)
    _, piluts = convert.tables(*jdsp.get_tables(), 'cpu')
    tg = TorchGenerator(tbuild(TArg(str=script, is_path=False,
                                    no_time=True, predef=[])),
                        srate, 'cpu', piluts=piluts,
                        state=convert.state(jst, 'cpu'))
    tst = tg._initial_state()
    want, got = [], []
    for ei in range(len(jg.plan.epochs)):
        for js, ts in zip(jg._flat_epoch(ei) or [], tg._flat_epoch(ei)):
            jst, o = js.run(jst, jg._recs_dev)
            want.append(np.asarray(o))
            tst, o = ts.run(tst)
            got.append(o.numpy())
    return np.concatenate(want), np.concatenate(got)


@pytest.mark.parametrize('script', [
    # a per-row pan with an amplitude scale that is no power of two: the
    # compiled reference folds pan * scale first
    'S a.m0.062\nWsin f110 t1 a1 c0.689 p[Wsin r1.5 a.4]',
    # frequency-scaled PM at a per-row frequency (the same fold)
    'Wsin f200 t2 p.f[Wsin r2 a.5]',
    'Rcos f200 t1 p.f[Wsin r2 a.5] c[Wsin f3 a.5]',
    'Nre t.5 a.4 c.3 ; Nvi t.2 c-.5',
    'Rexp mbvp t.5 f300 a.5 c.2',
    'S a.m0.3\nWsin f110 t.3 p.a.3 c.4',
    'Rcos mf f60 p.a.5[Rlin f7 a.4] a.6 t.2 c-.3',
])
def test_mix_floats_bit_equal(script):
    """The float mix before int16 rounding, bit for bit: a rounding
    difference that int16 output hides in most samples shows here."""
    want, got = _mix_pair(script, 6000)
    assert want.shape == got.shape
    assert same_bits(want, got), int(np.sum(want != got))


def test_self_pm_plan_kinds():
    """The self-PM scripts reach the stages they are meant to test."""
    kinds = {st.kind
             for seg in _segments('Wsin f110 t.5 p.a.3')
             + _segments(RASG_SELFPM) for st in seg.ep.stages}
    assert {K_WRUN_SELF, K_RRUN_SELF, K_RCYCLE} <= kinds
