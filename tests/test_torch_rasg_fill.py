"""The fused RasG cyclor and run (kernel 11's plain version,
``tdsp.rasg_fill_plain``) against the op chain that the flat renderer's
K_RCYCLE and K_RRUN stages ran before they were fused, which is written
out here; the chooser of the pairs that fuse (``flat.rasg_pairs``); and
a bank of the benchmark's ``rasg_feedback`` voice through ``BankRender``
on the CPU against the JAX package's. Tolerance: bit-equality."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

jax.config.update('jax_platforms', 'cpu')

from saugns_tpu.lang.program import (ScriptArg as JArg,  # noqa: E402
                                     build_program as jbuild)
from saugns_tpu.parallel import voicebank as jbank  # noqa: E402
import saugns_tpu_torch as stt  # noqa: E402
from saugns_tpu_torch.parallel.voicebank import BankRender  # noqa: E402
from saugns_tpu_torch.render import flat, tdsp  # noqa: E402
from saugns_tpu_torch.render.engine import TorchGenerator  # noqa: E402
from saugns_tpu_torch.render.plan import (K_RCYCLE, K_RRUN,  # noqa: E402
                                          K_RRUN_SELF, Stage)
from tests.test_torch_rasg_bank import SRATE, rasg_bank  # noqa: E402
from tests.torch_jaxref import ensure_native_tables  # noqa: E402

I64 = torch.int64
F32 = torch.float32
M32 = tdsp.M32
V, NC, B = 3, 2, 67         # voices, rows a voice, samples a row
ALPHA = 0x9e3779b9
COEFF = float(np.float32(np.float32(4294967296.0) / np.float64(48000)))


@pytest.fixture(autouse=True, scope='module')
def _jax_native_tables():
    """The JAX package renders with its native wave tables, also on a
    cold build cache (tests/torch_jaxref.py)."""
    ensure_native_tables()


def _case(seed, pm, scan, r2x):
    """A K_RCYCLE stage's inputs over (V, NC, B): row lengths under B
    (one row empty, one full), a per-row (``scan`` False) or per-sample
    frequency, carries with high bits, and the PM buffers ``pm`` names
    ('pm', 'fpm', 'both' or 'none') with offsets of NaN, +-inf, +-2^70
    and ordinary values."""
    rng = np.random.RandomState(seed)
    ln = rng.randint(0, B + 1, (V, NC))
    ln[0, 0], ln[1, 1] = 0, B
    fv = rng.uniform(-3000.0, 20000.0, (V, NC)).astype(np.float32)
    freq = rng.uniform(-3000.0, 20000.0, (V, NC, B)).astype(np.float32)
    cp = rng.randint(-(1 << 63), (1 << 63) - 1, V, dtype=np.int64)
    p = rng.uniform(-6.0, 6.0, (V, NC, B)).astype(np.float32)
    flat_p = p.reshape(-1)
    k = rng.choice(flat_p.size, 12, replace=False)
    flat_p[k] = [np.nan, np.inf, -np.inf, 2.0 ** 70, -2.0 ** 70,
                 0.5, -0.5, 1.5, 2.0 ** 62, -2.0 ** 62, 4e18, -4e18]
    c = rng.uniform(-3.0, 3.0, (V, NC, B)).astype(np.float32)
    t = torch.from_numpy
    bufs = {1: t(freq), 4: t(p), 5: t(c)}
    sval = {} if scan else {1: t(fv)}
    stage = SimpleNamespace(a=1, b=4 if pm in ('pm', 'both') else -1,
                            c=5 if pm in ('fpm', 'both') else -1)
    cf = float(np.float32(COEFF * 2)) if r2x else COEFF
    pscale = float(np.float32(tdsp.P31 * 2)) if r2x else tdsp.P31

    def getb(bid):
        if bid in sval:
            return sval[bid][..., None].expand(V, NC, B)
        return bufs[bid]
    return SimpleNamespace(ln=t(ln), cp=t(cp), stage=stage, getb=getb,
                           sval=sval, cf=cf, pscale=pscale, scan=scan)


def _former(x, func, line, level, oflags):
    """K_RCYCLE then K_RRUN as FlatSegment._chunk_steps ran them
    before the pair was fused (the one-device stage loop on a (V,)
    voice axis)."""
    s, ln = x.stage, x.ln
    idx_b = torch.arange(B, dtype=I64)[None, :]
    mask2 = idx_b < ln[..., None]
    if not x.scan:
        inc = tdsp.ftoi(x.sval[s.a] * x.cf) & -1
        cnt = torch.minimum(idx_b + 0, ln[..., None])
        row_tot = (inc * ln) & -1
        row_base = torch.cat([torch.zeros((V, 1), dtype=I64),
                              tdsp.row_cumsum(row_tot, 64)[..., :-1]], -1)
        excl = (row_base[..., None] + inc[..., None] * cnt) & -1
    else:
        incs = torch.where(mask2, tdsp.ftoi(x.getb(s.a) * x.cf),
                           torch.zeros((), dtype=I64))
        csum = tdsp.prefix_sum_u64_plain(incs.reshape(V, NC * B))
        excl = csum.reshape(V, NC, B) - incs
    # _phase_ofs(bits=64)
    if s.c >= 0:
        if s.a in x.sval:
            fpm = x.getb(s.c) * (tdsp.HUMMID_INV * x.sval[s.a])[..., None]
        else:
            fpm = x.getb(s.c) * tdsp.HUMMID_INV * x.getb(s.a)
    if s.b >= 0 and s.c >= 0:
        ofs = tdsp.ftoi((x.getb(s.b) + fpm) * x.pscale)
    elif s.b >= 0:
        ofs = tdsp.ftoi(x.getb(s.b) * x.pscale)
    elif s.c >= 0:
        ofs = tdsp.ftoi(fpm * x.pscale)
    else:
        ofs = 0
    cph = ofs + x.cp.reshape(V, 1, 1) + excl
    cycle = (cph >> 32) & M32
    phase = ((cph & M32) >> 1).to(F32) * tdsp.SCALE31
    av, bv = tdsp.rasg_map(func, level, ALPHA, oflags, cycle)
    return tdsp.rasg_shape(line, oflags, phase, av, bv)


def _fused(x, func, line, level, oflags):
    """The fused pair's inputs as FlatSegment._chunk_steps now makes
    them, through tdsp.rasg_fill_plain."""
    s, ln = x.stage, x.ln
    pofs = flat.FlatSegment._pofs(s, x.getb, x.sval)
    cp = x.cp.reshape(V, 1)
    if not x.scan:
        inc = tdsp.ftoi(x.sval[s.a] * x.cf) & -1
        row_tot = (inc * ln) & -1
        row_base = torch.cat([torch.zeros((V, 1), dtype=I64),
                              tdsp.row_cumsum(row_tot, 64)[..., :-1]], -1)
        return tdsp.rasg_fill_plain(func, line, level, ALPHA, oflags,
                                    row_base + cp, B, pofs, x.pscale,
                                    inc=inc, ln=ln)
    mask2 = torch.arange(B, dtype=I64)[None, :] < ln[..., None]
    incs = torch.where(mask2, tdsp.ftoi(x.getb(s.a) * x.cf),
                       torch.zeros((), dtype=I64))
    csum = tdsp.prefix_sum_u64_plain(incs.reshape(V, NC * B))
    return tdsp.rasg_fill_plain(func, line, level, ALPHA, oflags,
                                cp.expand(V, NC), B, pofs, x.pscale,
                                csum=csum.reshape(V, NC, B), incs=incs)


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


# (function, level): every map function, the fixed one at level 27 too
# (its +-1 pair)
FUNC_LEVELS = [(0, 5), (1, 5), (2, 5), (3, 5), (4, 5), (4, 27), (5, 5)]
# no flag, violet, Perlin (amplitude other than 1 on most lines),
# half-shape, zigzag, square, and mixes
FLAG_SETS = [0, 16, 1, 2, 4, 8, 1 | 8 | 16, 2 | 4 | 16]


@pytest.mark.parametrize('func,level', FUNC_LEVELS)
@pytest.mark.parametrize('line', range(13))
def test_plain_equals_the_former_chain_every_mode(func, level, line):
    """Every (function, line type) pair, each under a flag set of its
    own, both count forms, PM and frequency-scaled PM."""
    k = FUNC_LEVELS.index((func, level))
    oflags = FLAG_SETS[(k + line) % len(FLAG_SETS)]
    for scan in (False, True):
        x = _case(100 * k + line + 7 * scan, 'both', scan, line % 2 == 1)
        got = _fused(x, func, line, level, oflags)
        want = _former(x, func, line, level, oflags)
        assert got.shape == (V, NC, B) and got.dtype == F32
        assert _same_bits(got, want)


@pytest.mark.parametrize('oflags', FLAG_SETS)
@pytest.mark.parametrize('pm', ['pm', 'fpm', 'both', 'none'])
@pytest.mark.parametrize('scan', [False, True])
def test_plain_equals_the_former_chain_inputs(oflags, pm, scan):
    """Each flag set, PM input form and count form, on the uniform map
    with the cos line (the benchmark voice's mode) and on the binary
    map with the line of exponential segments, at 1x and 2x rate."""
    for func, line in ((0, 0), (2, 3)):
        for r2x in (False, True):
            x = _case(oflags + 31 * scan + 7 * len(pm) + r2x, pm, scan,
                      r2x)
            got = _fused(x, func, line, 5, oflags)
            want = _former(x, func, line, 5, oflags)
            assert _same_bits(got, want)


def test_dispatcher_takes_the_plain_version_on_the_cpu():
    x = _case(5, 'pm', False, False)
    pofs = flat.FlatSegment._pofs(x.stage, x.getb, x.sval)
    args = (0, 0, 5, ALPHA, 0, torch.zeros((V, NC), dtype=I64), B, pofs,
            x.pscale)
    kw = dict(inc=torch.full((V, NC), 1 << 28, dtype=I64), ln=x.ln)
    assert _same_bits(tdsp.rasg_fill(*args, **kw),
                      tdsp.rasg_fill_plain(*args, **kw))


def _pairs(src, srate=48000):
    g = TorchGenerator(stt.compile_script(src), srate, 'cpu')
    return [(ep.stages, flat.rasg_pairs(ep.stages)) for ep in g.plan.epochs]


def test_chooser_fuses_an_r_carrier_with_pm():
    """The benchmark voice: each R cyclor is paired with the run that
    reads it."""
    for stages, pairs in _pairs('R f50 t.1 a1 p[Wsin f1.5.r0[Wsin f0.07] '
                                'a12.5.r0[Wsin f0.07]]'):
        cyc = [si for si, s in enumerate(stages) if s.kind == K_RCYCLE]
        assert cyc and sorted(pairs) == cyc
        for si, ri in pairs.items():
            r = stages[ri]
            assert r.kind == K_RRUN and r.a == stages[si].dst \
                and r.dst == stages[si].dst + 1


def test_chooser_leaves_a_self_pm_carrier():
    """An R carrier with self-PM keeps its cyclor for kernel 6; its
    plain R modulator's pair fuses."""
    for stages, pairs in _pairs('Rcos mf f60 p.a.5[Rlin f7 a.4] a.6 '
                                't.05'):
        self_cyc = {s.a for s in stages if s.kind == K_RRUN_SELF}
        assert self_cyc
        for si, s in enumerate(stages):
            if s.kind == K_RCYCLE:
                assert (si in pairs) == (s.dst not in self_cyc)
        assert pairs


def test_chooser_finds_nothing_without_r():
    for src in ('Wsin f100 t.1 p[Wsin f3]', 'Nre t.1 a.4'):
        assert all(not pairs for _, pairs in _pairs(src))


@pytest.mark.parametrize('src', [
    'Rcos t.2 f80.r160[Wsin f2] a.7',
    'R f50 t.2 p[Wsin f1.5 a12.5] p.f[Wsin f3 a.5]',
    'Rcos t.4 f80.r160[Wsin f2] a.7 | Rlin t.3 f90.r30[Wtri f3] a.5',
    'Wsin f100 t.1 p[Rlin f7 a.4]',
    'Rlin f300 t.12 ; f30 t.03'])
def test_chooser_pairs_every_run(src):
    """The planner gives every K_RRUN the cyclor it reads: each run is
    paired, and each K_RCYCLE not read by a K_RRUN_SELF."""
    for stages, pairs in _pairs(src):
        runs = [ri for ri, s in enumerate(stages) if s.kind == K_RRUN]
        assert sorted(pairs.values()) == runs
        self_cyc = {s.a for s in stages if s.kind == K_RRUN_SELF}
        assert sorted(pairs) == [si for si, s in enumerate(stages)
                                 if s.kind == K_RCYCLE
                                 and s.dst not in self_cyc]


def test_chooser_refuses_a_run_without_its_cyclor():
    run = Stage(K_RRUN, inst=0, op=0, dst=2, a=1)
    with pytest.raises(ValueError):
        flat.rasg_pairs([run])
    with pytest.raises(ValueError):
        flat.rasg_pairs([Stage(K_RCYCLE, inst=0, op=0, dst=1, a=3),
                         Stage(K_RRUN, inst=0, op=0, dst=3, a=1)])


def test_bank_of_the_benchmark_voice_equals_the_jax_voicebank(
        monkeypatch):
    """Four voices of the rasg_feedback voice, one slab of four rows,
    through the fused pair: int16 byte-equal to the JAX package's
    BankRender."""
    calls = []

    def counting(*a, **k):
        calls.append(1)
        return tdsp.rasg_fill_plain(*a, **k)
    monkeypatch.setattr(tdsp, 'rasg_fill', counting)
    src = rasg_bank(4, 11, duration=0.03)
    got = BankRender(stt.compile_script(src), SRATE,
                     device='cpu').render_i16().numpy()
    assert calls
    jb = jbank.BankRender(jbuild(JArg(str=src, is_path=False, no_time=True,
                                      predef=[])), SRATE, mesh=None,
                          ordered_mix=True)
    want = np.asarray(jb.render_i16())
    assert got.shape == want.shape == (2880, 2)
    assert got.tobytes() == want.tobytes()
