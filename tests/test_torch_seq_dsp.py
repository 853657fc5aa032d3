"""The sequential-scan engine's DSP and state functions of the port on
the CPU, each against its jitted twin in the JAX package on the CPU
platform, on seeded numpy inputs. Tolerance: none -- floats (float32
and the float64 Is) are compared as bit patterns, integers exactly."""
import functools

import numpy as np
import pytest
import torch

import jax

jax.config.update('jax_platforms', 'cpu')

import jax.numpy as jnp  # noqa: E402

from saugns_tpu.lang.program import (ScriptArg as JArg,  # noqa: E402
                                     build_program as jbuild)
from saugns_tpu.render import engine as jeng  # noqa: E402 (x64 on)
from saugns_tpu.render import jdsp  # noqa: E402
from saugns_tpu.render.plan import RenderPlan as JPlan  # noqa: E402
from saugns_tpu_torch import convert  # noqa: E402
# the look-back scans' tile (kernels 2 and 4): one tile is one block
from saugns_tpu_torch.kernels import SCAN_TILE  # noqa: E402
from saugns_tpu_torch.lang.program import (ScriptArg as TArg,  # noqa: E402
                                           build_program as tbuild)
from saugns_tpu_torch.parallel.voicebank import (  # noqa: E402
    make_bank_script, make_selfmod_bank_script)
from saugns_tpu_torch.render import engine as teng  # noqa: E402
from saugns_tpu_torch.render import state as tstate  # noqa: E402
from saugns_tpu_torch.render import tdsp  # noqa: E402
from saugns_tpu_torch.render.plan import RenderPlan as TPlan  # noqa: E402
from tests.test_torch_kernels import _ffill_edges  # noqa: E402
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


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def U(a):
    """u32 numpy values -> the port's int64 representation."""
    return torch.from_numpy(np.asarray(a).astype(np.int64) & M32)


def ju32(a):
    return jnp.asarray(np.asarray(a).astype(np.int64).astype(np.uint32))


def tpiluts():
    """The JAX package's PILUTs as the port's CPU tensors (read after
    the module fixture has made sure they are the native ones)."""
    return convert.tables(*jdsp.get_tables(), 'cpu')[1]


# -- forward fill, Is, oscillator ----------------------------------------------

def _ffill_rows(rng, B):
    """(s_raw, valid, prev_s, length) rows covering the three branches
    of forward_fill_valid: all valid in range, isolated invalids, runs
    of invalids; invalid heads; pd == 0 runs past ``length``."""
    n = 8
    s = rng.uniform(-1, 1, (n, B)).astype(np.float32)
    valid = np.ones((n, B), bool)
    length = np.full(n, B, np.int64)
    length[1] = B // 2
    valid[1, B // 2:] = False          # frozen past length: fast branch
    valid[2, [5, 40, 41 + 2, B - 1]] = False   # isolated: fill1
    valid[3, 10:30] = False            # a run: the scan
    valid[4, :3] = False               # invalid head, run: seed used
    valid[5, 0] = False                # isolated invalid head
    length[6] = B // 3
    valid[6, B // 3 + 1:B // 3 + 9] = False   # run only past length
    valid[6, 7] = False
    length[7] = 0
    valid[7, ::3] = False
    s = np.where(valid, s, np.float32(0))
    prev = rng.uniform(-1, 1, n).astype(np.float32)
    return s, valid, prev, length


def test_forward_fill_valid():
    rng = np.random.RandomState(0)
    s, valid, prev, length = _ffill_rows(rng, 1024)
    got = tdsp.forward_fill_valid(T(s), T(valid), T(prev), T(length))
    fn = jax.jit(jdsp.forward_fill_valid)
    for r in range(len(s)):
        want = fn(jnp.asarray(s[r]), jnp.asarray(valid[r]),
                  jnp.float32(prev[r]), jnp.int32(length[r]))
        assert same_bits(got[r].numpy(), np.asarray(want)), r


@pytest.mark.parametrize('B', [2047, 2048, 2049, 4097])
def test_forward_fill_valid_tile_edges(B):
    """Kernel 10's plain version with lengths against the jitted
    reference at the kernel's tile edges (tiles of FILL_TILE = 2048):
    runs across a tile edge, an isolated invalid position at a tile
    head, lengths -3, 0, 1, 2047-2049, B // 2, B and B + 5, a pair only
    past length and lone pairs at tile, warp and thread edges."""
    s, valid, prev, length = _ffill_edges(np.random.RandomState(B), B)
    got = tdsp.forward_fill_valid_plain(T(s), T(valid), T(prev),
                                        T(length))
    fn = jax.jit(jdsp.forward_fill_valid)
    for r in range(len(s)):
        want = fn(jnp.asarray(s[r]), jnp.asarray(valid[r]),
                  jnp.float32(prev[r]), jnp.int32(length[r]))
        assert same_bits(got[r].numpy(), np.asarray(want)), \
            (r, length[r])


@pytest.mark.parametrize('B', [2047, 2049, 4097])
def test_forward_fill_valid_full_length_is_the_scan(B):
    """With length = B the reference's three branches are the
    last-valid fill bit for bit (the ground for one kernel serving
    both), in the JAX package and in the port's plain versions."""
    s, valid, prev, _ = _ffill_edges(np.random.RandomState(B + 1), B)
    length = np.full(len(s), B, np.int64)
    fn = jax.jit(jdsp.forward_fill_valid)
    scan = jax.jit(jdsp.forward_fill_last_valid)
    for r in range(len(s)):
        a = fn(jnp.asarray(s[r]), jnp.asarray(valid[r]),
               jnp.float32(prev[r]), jnp.int32(B))
        b = scan(jnp.asarray(s[r]), jnp.asarray(valid[r]),
                 jnp.float32(prev[r]))
        assert same_bits(np.asarray(a), np.asarray(b)), r
    got = tdsp.forward_fill_valid_plain(T(s), T(valid), T(prev),
                                        T(length))
    want = tdsp.last_valid_fill(T(s), T(valid), T(prev))
    assert same_bits(got.numpy(), want.numpy())


def test_last_valid_fill_is_the_scan():
    """Kernel 10's plain version against jdsp.forward_fill_last_valid
    (the scan semantics at every position)."""
    rng = np.random.RandomState(1)
    s, valid, prev, _ = _ffill_rows(rng, 777)
    got = tdsp.last_valid_fill(T(s), T(valid), T(prev))
    fn = jax.jit(jdsp.forward_fill_last_valid)
    for r in range(len(s)):
        want = fn(jnp.asarray(s[r]), jnp.asarray(valid[r]),
                  jnp.float32(prev[r]))
        assert same_bits(got[r].numpy(), np.asarray(want)), r


@pytest.mark.parametrize('wave', [0, 1, 2, 5, 9, 11])
def test_is64(wave):
    ph = np.random.RandomState(wave).randint(0, 1 << 32, 30000,
                                             dtype=np.int64)
    ph[:6] = [0, 1, SLEN - 1, SLEN, M32, 2047 << tdsp.SLENBITS]
    got = tdsp.is64(tpiluts()[wave], U(ph))
    assert got.dtype == torch.float64
    taps = jax.jit(functools.partial(jdsp.gather_taps, wave=wave))(
        jdsp.wosc_cells(ju32(ph)))
    x = (ju32(ph) & np.uint32(tdsp.SLENMASK)).astype(jnp.float32) \
        * jdsp.X_SCALE
    want = jax.jit(jdsp._herp64_taps)(taps[0], taps[1], taps[2],
                                      taps[3], x)
    assert same_bits(got.numpy(), np.asarray(want))
    assert torch.equal(tdsp.gather_taps(tpiluts()[wave],
                                        tdsp.wosc_cells(U(ph))),
                       T(np.asarray(taps)))


def _osc_rows(rng, n, B):
    """Audio-rate phase rows with pd == 0 runs (one row frozen past its
    length), lengths, seeds."""
    inc = rng.randint(1 << 16, 1 << 26, (n, B)).astype(np.int64)
    length = rng.randint(1, B + 1, n).astype(np.int64)
    length[0] = B
    for r in range(n):
        a = rng.randint(0, B)
        inc[r, a:a + rng.randint(1, 40)] = 0
        inc[r, rng.randint(0, B)] = 0
    inc[1, length[1]:] = 0
    ph = (rng.randint(0, 1 << 32, (n, 1)) + np.cumsum(inc, axis=1)) & M32
    pp = rng.randint(0, 1 << 32, n).astype(np.int64)
    pp[2] = ph[2, 0]                       # head pd == 0
    ps = rng.uniform(-1, 1, n).astype(np.float32)
    return ph, pp, ps, length


@pytest.mark.parametrize('reset', [False, True], ids=['seed', 'reset'])
@pytest.mark.parametrize('given', [False, True], ids=['is64', 'taps2'])
@pytest.mark.parametrize('wave', [0, 2, 7])
def test_wosc_run_taps(wave, given, reset):
    rng = np.random.RandomState(wave * 4 + 2 * given + reset)
    n, B = 5, 1024
    ph, pp, ps, length = _osc_rows(rng, n, B)
    rst = np.full(n, reset)
    rst[3] = not reset
    taps2 = tdsp.gather_taps(tpiluts()[wave],
                             tdsp.wosc_cells(U(ph.reshape(-1)))) \
        if given else None
    out, npp, nps = tdsp.wosc_run_taps(tpiluts()[wave], wave, U(ph), U(pp),
                                       T(ps), T(rst), T(length),
                                       taps2=taps2)

    def ref(ph, pp, ps, rst, length):
        t2 = jdsp.gather_taps(jdsp.wosc_cells(ph), wave) if given \
            else None
        return jdsp.wosc_run_taps(wave, ph, pp, ps, rst, length,
                                  taps2=t2)

    fn = jax.jit(ref)
    for r in range(n):
        wo, wpp, wps = fn(ju32(ph[r]), jnp.uint32(pp[r]),
                          jnp.float32(ps[r]), jnp.bool_(rst[r]),
                          jnp.int32(length[r]))
        assert same_bits(out[r].numpy(), np.asarray(wo)), r
        assert int(npp[r]) == int(wpp)
        assert same_bits(nps[r].numpy(), np.asarray(wps))


# -- noise, scans -------------------------------------------------------------

@pytest.mark.parametrize('ntype', range(7))
def test_noise_run(ntype):
    rng = np.random.RandomState(ntype)
    B = 2048
    fn = jax.jit(lambda n0, npv, ln: jdsp.noise_run(ntype, n0, npv, ln, B))
    for length in (0, 1, 700, B):
        n0 = int(rng.randint(0, 1 << 32))
        npv = int(rng.randint(0, 1 << 32)) if ntype != 6 else \
            int(rng.choice([0, 1, M32]))
        out, nprev = tdsp.noise_run(ntype, torch.tensor(n0),
                                    torch.tensor(npv),
                                    torch.tensor(length), B)
        wo, wp = fn(jnp.uint32(n0), jnp.uint32(npv), jnp.int32(length))
        assert same_bits(out.numpy(), np.asarray(wo)), length
        assert int(nprev) == int(wp), length


@pytest.mark.parametrize('bits', [32, 64])
def test_prefix_sum_rows(bits):
    rng = np.random.RandomState(bits)
    if bits == 32:
        x = rng.randint(0, 1 << 32, (5, 3000), dtype=np.int64)
        x[1] = M32
        want = jax.jit(jdsp.prefix_sum_rows)(ju32(x))
        want = np.asarray(want).astype(np.int64)
    else:
        x = rng.randint(-(1 << 63), (1 << 63) - 1, (5, 3000),
                        dtype=np.int64)
        x[1] = -1
        want = jax.jit(jdsp.prefix_sum_rows)(jnp.asarray(
            x.view(np.uint64)))
        want = np.asarray(want).view(np.int64)
    got = tdsp.prefix_sum_rows(torch.from_numpy(x), bits)
    assert np.array_equal(got.numpy(), want)


def test_scan_max_i32_plain():
    """Kernel 4's plain version: the running max with identity 0, as
    jdsp.cummax_i32 on inputs >= 0 (its domain) and torch.cummax."""
    rng = np.random.RandomState(4)
    for n in (1, 2, 1023, 5000):
        x = rng.randint(0, 1 << 31, n).astype(np.int32)
        x[::7] = 0
        x[n // 2:n // 2 + 3] = 0x7fffffff
        got = tdsp.scan_max_i32(T(x))
        want = jax.jit(jdsp.cummax_i32)(jnp.asarray(x))
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert torch.equal(got, torch.cummax(T(x), 0).values)
    neg = T(np.array([-5, 3, -9, 2, 7], np.int32))
    assert tdsp.scan_max_i32(neg).tolist() == [0, 3, 3, 3, 7]


@pytest.mark.parametrize('n', [SCAN_TILE - 1, SCAN_TILE, SCAN_TILE + 1,
                               3 * SCAN_TILE + 1])
@pytest.mark.parametrize('fill', ['ramp', 'negative'])
def test_scan_max_i32_tile_edges(n, fill):
    """Kernel 4's contract at the look-back scan's tile edges: a rising
    ramp (the max changes in every tile) against jitted
    jdsp.cummax_i32; with negative values (clamped to 0 by the identity
    0 of the TPU kernel) against max(0, jitted jdsp.cummax_i32)."""
    rng = np.random.RandomState(n)
    x = np.arange(n, dtype=np.int64) * 64 + rng.randint(0, 1000, n)
    if fill == 'negative':
        x -= 50000
        for _ in range(4):
            a = rng.randint(0, n)
            x[a:a + rng.randint(1, 2 * SCAN_TILE)] = -rng.randint(1, 1 << 31)
    x = x.astype(np.int32)
    got = tdsp.scan_max_i32(T(x))
    want = np.asarray(jax.jit(jdsp.cummax_i32)(jnp.asarray(x)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.maximum(want, 0))
    if fill == 'ramp':
        assert np.array_equal(got.numpy(), want)


# -- line state and records ------------------------------------------------------

def _line_states(rng, n):
    return {'v0': rng.uniform(-10, 10, n).astype(np.float32),
            'vt': rng.uniform(-10, 10, n).astype(np.float32),
            'pos': rng.randint(0, 3000, n).astype(np.int32),
            'end': rng.randint(1, 3000, n).astype(np.int32),
            'type': rng.randint(0, 13, n).astype(np.int32),
            'flags': rng.randint(0, 128, n).astype(np.int32)}


def test_line_skip_vec():
    rng = np.random.RandomState(5)
    n = 300
    ls = _line_states(rng, n)
    length = rng.randint(0, 4000, n).astype(np.int32)
    fn = jax.jit(jeng.line_skip_vec)
    want = fn({k: jnp.asarray(v) for k, v in ls.items()},
              jnp.asarray(length))
    got = tstate.line_skip_vec({k: T(v).to(torch.int64)
                                if v.dtype == np.int32 else T(v)
                                for k, v in ls.items()},
                               T(length).to(torch.int64))
    for k in ('v0', 'vt', 'pos', 'end', 'type', 'flags'):
        assert same_bits(got[k].numpy(), np.asarray(want[k])), k


def _records(seed, plan, n_recs=80):
    """Random update records for ``plan``'s ops: op and voice records,
    every line slot present or not with random flags, types and
    values, times explicit and implicit."""
    rng = np.random.RandomState(seed)
    ra = {k: np.array(v[:1].repeat(n_recs), copy=True)
          for k, v in plan.rec_arrays.items()}
    ra['kind'] = (rng.uniform(0, 1, n_recs) < 0.2).astype(np.int32)
    ra['op'] = rng.randint(0, plan.n_ops, n_recs).astype(np.int32)
    ra['vo'] = rng.randint(0, plan.n_voices, n_recs).astype(np.int32)
    ra['carr'] = rng.randint(0, plan.n_ops, n_recs).astype(np.int32)
    ra['prepare'] = rng.uniform(0, 1, n_recs) < 0.1
    ra['params'] = rng.randint(0, 1 << 12, n_recs).astype(np.int32)
    ra['type'] = rng.randint(0, 4, n_recs).astype(np.int32)
    for k in ('seed', 'wadj_delta', 'phase_w', 'phase'):
        ra[k] = rng.randint(0, 1 << 32, n_recs,
                            dtype=np.int64).astype(np.uint32)
    ra['r2x_old'] = rng.uniform(0, 1, n_recs) < 0.5
    ra['r2x_new'] = rng.uniform(0, 1, n_recs) < 0.5
    ra['time_v'] = rng.randint(0, 5000, n_recs).astype(np.int32)
    ra['time_implicit'] = rng.uniform(0, 1, n_recs) < 0.3
    for sl in range(6):
        ra['l%d_present' % sl] = rng.uniform(0, 1, n_recs) < 0.6
        ra['l%d_flags' % sl] = rng.randint(0, 128, n_recs).astype(np.int32)
        ra['l%d_v0' % sl] = rng.uniform(-5, 5, n_recs).astype(np.float32)
        ra['l%d_vt' % sl] = rng.uniform(-5, 5, n_recs).astype(np.float32)
        ra['l%d_end' % sl] = rng.randint(1, 4000, n_recs).astype(np.int32)
        ra['l%d_type' % sl] = rng.choice([0, 1, 3, 9, 10, 12],
                                         n_recs).astype(np.int32)
    return ra


def _state(seed, plan, ra):
    rng = np.random.RandomState(seed + 100)
    si = rng.randint(-2 ** 31, 2 ** 31, (plan.n_ops, tstate.NI),
                     dtype=np.int64).astype(np.int32)
    c = tstate
    si[:, c.C_LPOS:c.C_LPOS + 6] = rng.randint(0, 4000, (plan.n_ops, 6))
    si[:, c.C_LEND:c.C_LEND + 6] = rng.randint(1, 4000, (plan.n_ops, 6))
    si[:, c.C_LFLAGS:c.C_LFLAGS + 6] = rng.randint(0, 128,
                                                   (plan.n_ops, 6))
    for sl in range(6):
        si[:, c.C_LTYPE + sl] = rng.choice(tstate._line_types(ra, sl),
                                           plan.n_ops)
    si[:, c.C_TIME] = rng.randint(0, 9000, plan.n_ops)
    si[:, c.C_TINF] = rng.randint(0, 2, plan.n_ops)
    return {'sf': rng.uniform(-1, 1, (plan.n_ops, tstate.NF))
            .astype(np.float32), 'si': si,
            'vdur': rng.randint(0, 9000, plan.n_voices).astype(np.int32)}


@pytest.mark.parametrize('seed', range(4))
def test_apply_records_full(seed):
    """Every column after the records: line slots, time, voice
    durations and the device columns."""
    prg = jbuild(JArg(str='Wsin p[Wsin r2] a[g.2 t.1]\nRlin t.3 f[g9]\n'
                      'Ntw t.2', is_path=False, no_time=True, predef=[]))
    plan = JPlan(prg, 6000)
    ra = _records(seed, plan)
    st = _state(seed, plan, ra)
    lo, hi = 2, len(ra['op']) - 1
    fn = jax.jit(lambda s, r: jeng.apply_records(s, lo, hi, r))
    want = fn({k: jnp.asarray(v) for k, v in st.items()},
              {k: jnp.asarray(v) for k, v in ra.items()})
    got = tstate.apply_records(convert.state(st, 'cpu'), lo, hi,
                               convert.records(ra))
    for k in ('sf', 'si', 'vdur'):
        assert same_bits(got[k].numpy(), np.asarray(want[k])), k
    assert not np.array_equal(np.asarray(want['vdur']), st['vdur'])


# -- the schedule analysis ---------------------------------------------------------

@pytest.mark.parametrize('script', [
    make_bank_script(6, seed=2, duration=0.2),
    make_selfmod_bank_script(4, seed=1, duration=0.2),
    'Wsin f220 t1 p[Wsin f50 /.3 r[g3 t.3]]',
    'Wsin t1 f500.r501[Wsin f1] p[Wsin f400.r800[Wsqr f1.r10[Wsin f50]]]'
    ' a.8 c[Wsin f.5]',
    'Rcos t.4 f80.r160[Wsin f2] a.7 | Rlin t.3 f90.r30[Wtri f3] '
    '| Nre t.2 | Wsaw t.2 f[g300 t.2] a[g.1 t.2]',
])
def test_analyze_schedule(script):
    jp = JPlan(jbuild(JArg(str=script, is_path=False, no_time=True,
                           predef=[])), 6000)
    tp = TPlan(tbuild(TArg(str=script, is_path=False, no_time=True,
                           predef=[])), 6000)
    assert len(jp.epochs) == len(tp.epochs)
    kinds = set()
    for je, te in zip(jp.epochs, tp.epochs):
        assert je.sig == te.sig
        want = jeng._analyze_schedule(je.sig[0], je.sig[1])
        got = teng._analyze_schedule(te.sig[0], te.sig[1])
        assert got == want
        kinds |= {g[0] for g in got[0]}
    assert 'stages' in kinds
