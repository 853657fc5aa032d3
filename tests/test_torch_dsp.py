"""The port's DSP primitives against their JAX twins on the CPU
platform, on seeded numpy inputs. Tolerance: none -- every comparison
is bit-equality (float results compared as bit patterns), because the
port evaluates the same float32 / float64 / integer op sequence."""
import numpy as np
import pytest
import torch

import jax

jax.config.update('jax_platforms', 'cpu')

import jax.numpy as jnp  # noqa: E402

from saugns_tpu.dsp import wavetables as JW  # noqa: E402
from saugns_tpu.lang.program import (ScriptArg as JArg,  # noqa: E402
                                     build_program as jbuild)
from saugns_tpu.render import engine as jeng  # noqa: E402 (x64 on)
from saugns_tpu.render import flat as jflat  # noqa: E402
from saugns_tpu.render import jdsp  # noqa: E402
from saugns_tpu.render.plan import RenderPlan as JPlan  # noqa: E402
from saugns_tpu_torch import convert  # noqa: E402
# the look-back scans' tile (kernels 2 and 4): one tile is one block;
# kernel 1's tile
from saugns_tpu_torch.kernels import FILL_TILE, SCAN_TILE  # noqa: E402
from saugns_tpu_torch.dsp import wavetables as TW  # noqa: E402
from saugns_tpu_torch.render import flat as tflat  # noqa: E402
from saugns_tpu_torch.render import state as tstate  # noqa: E402
from saugns_tpu_torch.render import tdsp  # noqa: E402
from tests.torch_jaxref import ensure_native_tables  # noqa: E402


@pytest.fixture(autouse=True, scope='module')
def _jax_native_tables():
    """The JAX package renders with its native wave tables, also on a
    cold build cache (tests/torch_jaxref.py)."""
    ensure_native_tables()


M32 = 0xffffffff


def same_bits(a, b):
    a = np.atleast_1d(np.asarray(a))
    b = np.atleast_1d(np.asarray(b))
    if a.shape != b.shape:
        return False
    if a.dtype.kind == 'f':
        if a.dtype != b.dtype:
            return False
        return np.array_equal(a.view(np.uint8), b.view(np.uint8))
    return np.array_equal(a.astype(np.int64), b.astype(np.int64))


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def U(a):
    """u32 numpy values -> the port's int64 representation."""
    return torch.from_numpy(np.asarray(a).astype(np.int64) & M32)


def test_tables_bit_equal():
    jl, jp = JW.get_tables()
    tl, tp = TW.get_tables()
    assert same_bits(tl, jl) and same_bits(tp, jp)
    cl, cp = convert.tables(jl, jp, 'cpu')
    assert same_bits(cl.numpy(), jl) and same_bits(cp.numpy(), jp)
    assert same_bits(tdsp.wave_tables('cpu')[1].numpy(), jp)


def test_convert_rejects_bad_tables():
    jl, jp = JW.get_tables()
    with pytest.raises(ValueError):
        convert.tables(jl[:3], jp, 'cpu')
    with pytest.raises(ValueError):
        convert.tables(jl, jp.astype(np.float64), 'cpu')


def test_ftoi():
    rng = np.random.RandomState(1)
    x = np.concatenate([
        rng.uniform(-1e9, 1e9, 5000),
        np.arange(-40, 40) + 0.5,
        rng.randint(-2 ** 24, 2 ** 24, 500) + 0.5,
    ]).astype(np.float32)
    assert same_bits(tdsp.ftoi(T(x)).numpy(),
                     np.asarray(jdsp.ftoi(jnp.asarray(x))))


def test_ftoi_saturates_as_xla():
    """Out of range and NaN (ROADMAP C1): the reference converts under
    jit on XLA:CPU with saturation -- x >= 2^63 gives INT64_MAX,
    x < -2^63 INT64_MIN, NaN 0."""
    e = np.float32(2.0 ** 63)
    x = np.array([1e19, -1e19, np.inf, -np.inf, np.nan, e, -e,
                  np.nextafter(e, np.float32(0)),
                  np.nextafter(-e, np.float32(0)),
                  np.nextafter(e, np.float32(np.inf)),
                  np.nextafter(-e, np.float32(-np.inf)), 3e38, -3e38,
                  2.0 ** 62, -2.0 ** 62, 0.0, -0.0], np.float32)
    want = np.asarray(jax.jit(jdsp.ftoi)(jnp.asarray(x)))
    assert want[0] == 2 ** 63 - 1 and want[1] == -2 ** 63 \
        and want[4] == 0
    assert same_bits(tdsp.ftoi(T(x)).numpy(), want)


def _line_inputs(seed, n=6, B=777):
    rng = np.random.RandomState(seed)
    end = rng.randint(1, 200000, n).astype(np.int32)
    pos = (rng.uniform(0, 1, n) * end).astype(np.int64)
    v0 = rng.uniform(-1000, 1000, n).astype(np.float32)
    vt = rng.uniform(-1000, 1000, n).astype(np.float32)
    i_pos = (pos[:, None] + np.arange(B)[None, :]).astype(np.uint32)
    return end, v0, vt, i_pos


@pytest.mark.parametrize('ltype', range(13))
def test_line_fill(ltype):
    end, v0, vt, i_pos = _line_inputs(ltype)
    for k in range(len(end)):
        want = jdsp.line_fill(ltype, jnp.asarray(i_pos[k]),
                              jnp.int32(end[k]), jnp.float32(v0[k]),
                              jnp.float32(vt[k]))
        got = tdsp.line_fill(ltype, U(i_pos[k]), torch.tensor(int(end[k])),
                             T(v0[k:k + 1]), T(vt[k:k + 1]))
        assert same_bits(got.numpy(), np.asarray(want)), (ltype, k)


@pytest.mark.parametrize('ltype', range(13))
def test_line_val(ltype):
    rng = np.random.RandomState(100 + ltype)
    x = rng.uniform(0, 1, 3000).astype(np.float32)
    a = rng.uniform(-500, 500, 3000).astype(np.float32)
    b = rng.uniform(-500, 500, 3000).astype(np.float32)
    want = jdsp.line_val(ltype, jnp.asarray(x), jnp.asarray(a),
                         jnp.asarray(b))
    got = tdsp.line_val(ltype, T(x), T(a), T(b))
    assert same_bits(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('ltype', [0, 1, 3, 8, 10, 12])
def test_line_val_at(ltype):
    end, v0, vt, i_pos = _line_inputs(200 + ltype)
    for k in range(len(end)):
        pos = int(i_pos[k, 0])
        want = jdsp.line_val_at(ltype, jnp.int32(pos), jnp.int32(end[k]),
                                jnp.float32(v0[k]), jnp.float32(vt[k]))
        got = tdsp.line_val_at(ltype, pos, int(end[k]), T(v0[k:k + 1])[0],
                               T(vt[k:k + 1])[0])
        assert same_bits(got.numpy(), np.asarray(want))


def test_ranfast32():
    rng = np.random.RandomState(3)
    n = np.concatenate([rng.randint(0, 1 << 32, 5000, dtype=np.int64),
                        [0, 1, M32, 0x7fffffff, 0x80000000]])
    want = jdsp.ranfast32(jnp.asarray(n.astype(np.uint32)))
    assert same_bits(tdsp.ranfast32(U(n)).numpy(),
                     np.asarray(want).astype(np.int64))


def test_herp64_taps():
    rng = np.random.RandomState(4)
    _, piluts = JW.get_tables()
    cells = rng.randint(0, 2048, 4000)
    taps = np.stack([piluts[0][(cells + d) & 2047] for d in range(-1, 3)])
    taps[:, :1000] = rng.uniform(-2, 2, (4, 1000)).astype(np.float32)
    x = rng.uniform(0, 1, 4000).astype(np.float32)
    want = jdsp._herp64_taps(*(jnp.asarray(t) for t in taps),
                             jnp.asarray(x))
    got = tdsp._herp64_taps(*(T(t) for t in taps), T(x))
    assert np.asarray(want).dtype == np.float64
    assert same_bits(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('wave', range(12))
def test_hermite_coeffs_horner(wave):
    """Kernel 5 keeps each PILUT cell's four Hermite coefficients and
    evaluates Is(phase) as their Horner: bit-equal to the jitted
    reference Hermite for every cell of every wave, at seeded random
    fractions and at the cell's ends (fractions 0 and 2^21 - 1)."""
    rng = np.random.RandomState(40 + wave)
    _, jpil = JW.get_tables()
    cells = np.repeat(np.arange(2048, dtype=np.int64), 6)
    frac = rng.randint(0, 1 << 21, cells.size).astype(np.int64)
    frac[0::6] = 0
    frac[1::6] = (1 << 21) - 1
    ph = (cells << 21) | frac
    taps = np.stack([jpil[wave][(cells + d) & 2047] for d in range(-1, 3)])
    x = ((ph & ((1 << 21) - 1)).astype(np.float32)
         * np.float32(1.0 / (1 << 21)))
    want = jax.jit(jdsp._herp64_taps)(*(jnp.asarray(t) for t in taps),
                                      jnp.asarray(x))
    pil = tdsp.wave_tables('cpu')[1][wave]
    coeffs = tdsp.hermite_coeffs(pil)
    assert coeffs.shape == (2048, 4) and coeffs.dtype == torch.float64
    got = tdsp.is64_coeffs(coeffs, T(ph))
    assert same_bits(got.numpy(), np.asarray(want))
    assert same_bits(got.numpy(), tdsp.is64_plain(pil, T(ph)).numpy())


@pytest.mark.parametrize('wave', range(12))
def test_wosc_s64(wave):
    rng = np.random.RandomState(10 + wave)
    n = 3000
    _, piluts = JW.get_tables()
    p1 = rng.randint(0, 1 << 32, n, dtype=np.int64)
    step = rng.randint(-(1 << 27), 1 << 27, n)
    step[::7] = 0
    step[::11] = rng.choice([1, -1, 2], size=len(step[::11]))
    p2 = (p1 + step) & M32
    pd = (p2 - p1) & M32
    pd = pd - ((pd & 0x80000000) << 1)
    taps1 = np.stack([piluts[wave][((p1 >> 21) + d) & 2047]
                      for d in range(-1, 3)])
    taps2 = np.stack([piluts[wave][((p2 >> 21) + d) & 2047]
                      for d in range(-1, 3)])
    x1 = ((p1 & 0x1fffff).astype(np.float32)
          * np.float32(1.0 / (1 << 21)))
    x2 = ((p2 & 0x1fffff).astype(np.float32)
          * np.float32(1.0 / (1 << 21)))
    ws, wv = jdsp._wosc_s64(wave, jnp.asarray(pd.astype(np.int32)),
                            jnp.asarray(x1), jnp.asarray(x2),
                            jnp.asarray(taps1), jnp.asarray(taps2))
    ts, tv = tdsp._wosc_s64(wave, T(pd), T(x1), T(x2), T(taps1),
                            T(taps2))
    assert same_bits(ts.numpy(), np.asarray(ws))
    assert np.array_equal(tv.numpy(), np.asarray(wv))


@pytest.mark.parametrize('n', [1, 2, 1023, 1025, 4099, 100003])
@pytest.mark.parametrize('fill', ['random', 'ones'])
def test_prefix_sum_plain(n, fill):
    rng = np.random.RandomState(n)
    x = rng.randint(0, 1 << 32, n, dtype=np.int64) if fill == 'random' \
        else np.full(n, M32, np.int64)
    got = tdsp.prefix_sum(U(x)).numpy()
    assert same_bits(got, np.cumsum(x) & M32)
    want = jdsp.prefix_sum(jnp.asarray(x.astype(np.uint32)))
    assert same_bits(got, np.asarray(want).astype(np.int64))


@pytest.mark.parametrize('n', [SCAN_TILE - 1, SCAN_TILE, SCAN_TILE + 1,
                               3 * SCAN_TILE + 1])
@pytest.mark.parametrize('fill', ['u32', 'int64', 'negative'])
def test_prefix_sum_tile_edges(n, fill):
    """The contract kernel 2 keeps: tdsp.prefix_sum of any int64 is
    the wrapping u32 prefix sum of its low 32 bits (high bits set and
    negative values too), as jitted jdsp.prefix_sum of the input
    truncated to uint32, at the look-back scan's tile edges."""
    rng = np.random.RandomState(n + len(fill))
    if fill == 'u32':
        x = rng.randint(0, 1 << 32, n, dtype=np.int64)
    elif fill == 'int64':
        x = rng.randint(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
    else:
        x = -rng.randint(1, 1 << 40, n, dtype=np.int64)
    got = tdsp.prefix_sum(T(x))
    assert got.dtype == torch.int64
    want = jax.jit(jdsp.prefix_sum)(jnp.asarray(x.astype(np.uint32)))
    assert same_bits(got.numpy(), np.asarray(want).astype(np.int64))
    assert same_bits(got.numpy(), np.cumsum(x & M32) & M32)


def _jax_filled(wave, ph, pp, ps, fi, do_rst, rst_prev, in_range):
    """The JAX renderer's composed CPU chain for one row
    (flat._wrun_stage without the fused kernel, then
    flat._last_valid_fill)."""
    u = np.uint32
    ph = jnp.asarray(ph.astype(u))
    pp = jnp.asarray(u(pp))
    rst_prev = jnp.asarray(u(rst_prev))
    p_prev = jnp.concatenate([pp.reshape(1), ph[:-1]])
    p_prev = p_prev.at[fi].set(jnp.where(do_rst, rst_prev, p_prev[fi]))
    taps2 = jdsp.gather_taps(jdsp.wosc_cells(ph), wave)
    ptaps = jdsp.taps_at(pp >> jdsp.SLENBITS, wave)
    taps1 = jnp.concatenate([ptaps.reshape(4, 1), taps2[:, :-1]], axis=1)
    rtaps = jdsp.taps_at(rst_prev >> jdsp.SLENBITS, wave)
    taps1 = taps1.at[:, fi].set(jnp.where(do_rst, rtaps, taps1[:, fi]))
    x1 = (p_prev & u(JW.SLENMASK)).astype(jnp.float32) * jdsp.X_SCALE
    x2 = (ph & u(JW.SLENMASK)).astype(jnp.float32) * jdsp.X_SCALE
    pd = jdsp.asi32(ph - p_prev)
    s_raw, valid = jdsp._wosc_s64(wave, pd, x1, x2, taps1, taps2)
    return np.asarray(jflat._last_valid_fill(
        s_raw, valid, jnp.asarray(in_range), jnp.float32(ps)))


def _phase_row(rng, L, runs, head_hold):
    inc = rng.randint(1 << 16, 1 << 26, L).astype(np.int64)
    for _ in range(runs):
        a = rng.randint(0, L)
        inc[a:a + rng.randint(1, 40)] = 0
    if head_hold:
        inc[:2] = 0
    pp = int(rng.randint(0, 1 << 32, dtype=np.int64))
    return (pp + np.cumsum(inc)) & M32, pp


@pytest.mark.parametrize('case', range(8))
def test_wosc_s_filled_plain(case):
    rng = np.random.RandomState(50 + case)
    wave = int(rng.randint(0, 12))
    L = int(rng.choice([1, 5, 1000, 4096, 9001]))
    ph, pp = _phase_row(rng, L, runs=case, head_hold=case % 2 == 0)
    fi = int(rng.randint(0, L))
    do_rst = bool(case % 3)
    rst_prev = (int(ph[fi]) - (1 << 21)) & M32
    ps = np.float32(rng.uniform(-1, 1))
    _, piluts = TW.get_tables()
    got = tdsp.wosc_s_filled(
        T(piluts[wave]), wave, U(ph)[None], U([pp]), T([ps]),
        torch.tensor([fi]), torch.tensor([do_rst]), U([rst_prev]))[0]
    want = _jax_filled(wave, ph, pp, ps, fi, do_rst, rst_prev,
                       np.ones(L, bool))
    assert same_bits(got.numpy(), want)
    # with masked samples the JAX fill may differ where no sample is
    # consumed (out of range); in range both must agree bit for bit
    in_range = np.ones(L, bool)
    in_range[L // 2:] = False
    want = _jax_filled(wave, ph, pp, ps, fi, do_rst, rst_prev, in_range)
    assert same_bits(got.numpy()[in_range], want[in_range])


def _jax_filled_core(wave, ph, pp, ps, fi, do_rst, rst_prev):
    """_jax_filled's chain on jnp inputs, every sample in range (to be
    jitted with ``wave`` static)."""
    u = jnp.uint32
    p_prev = jnp.concatenate([pp.reshape(1), ph[:-1]])
    p_prev = p_prev.at[fi].set(jnp.where(do_rst, rst_prev, p_prev[fi]))
    taps2 = jdsp.gather_taps(jdsp.wosc_cells(ph), wave)
    ptaps = jdsp.taps_at(pp >> jdsp.SLENBITS, wave)
    taps1 = jnp.concatenate([ptaps.reshape(4, 1), taps2[:, :-1]], axis=1)
    rtaps = jdsp.taps_at(rst_prev >> jdsp.SLENBITS, wave)
    taps1 = taps1.at[:, fi].set(jnp.where(do_rst, rtaps, taps1[:, fi]))
    x1 = (p_prev & u(JW.SLENMASK)).astype(jnp.float32) * jdsp.X_SCALE
    x2 = (ph & u(JW.SLENMASK)).astype(jnp.float32) * jdsp.X_SCALE
    pd = jdsp.asi32(ph - p_prev)
    s_raw, valid = jdsp._wosc_s64(wave, pd, x1, x2, taps1, taps2)
    out = jflat._last_valid_fill(s_raw, valid, jnp.ones(ph.shape, bool),
                                 ps)
    return out, valid


_jax_filled_jit = jax.jit(_jax_filled_core, static_argnums=0)


@pytest.mark.parametrize('L,fi', [(FILL_TILE - 1, 0), (FILL_TILE, 0),
                                  (FILL_TILE + 1, FILL_TILE),
                                  (3 * FILL_TILE + 1, 0),
                                  (3 * FILL_TILE + 1, 2 * FILL_TILE)])
def test_wosc_s_filled_tile_edges(L, fi):
    """wosc_s_filled_plain against the jitted JAX chain at kernel 1's
    tile edges: pd == 0 runs across every tile edge and at the row
    head, a reset at row index 0 or at a tile's first sample (after a
    run) -- the shapes at which the card holds kernel 1 against this
    plain version."""
    rng = np.random.RandomState(L + fi)
    wave = int(rng.randint(0, 12))
    inc = rng.randint(1 << 16, 1 << 26, L).astype(np.int64)
    for e in range(FILL_TILE, L, FILL_TILE):
        inc[e - rng.randint(1, 40):e + rng.randint(1, 40)] = 0
    inc[:3] = 0
    pp = int(rng.randint(0, 1 << 32, dtype=np.int64))
    ph = (pp + np.cumsum(inc)) & M32
    rst_prev = (int(ph[fi]) - (1 << 21)) & M32
    ps = np.float32(rng.uniform(-1, 1))
    _, piluts = TW.get_tables()
    got = tdsp.wosc_s_filled(
        T(piluts[wave]), wave, U(ph)[None], U([pp]), T([ps]),
        torch.tensor([fi]), torch.tensor([True]), U([rst_prev]))[0]
    want, valid = _jax_filled_jit(
        wave, jnp.asarray(ph.astype(np.uint32)), jnp.uint32(pp),
        jnp.float32(ps), jnp.int32(fi), jnp.bool_(True),
        jnp.uint32(rst_prev))
    assert not bool(np.asarray(valid)[1])      # a pd == 0 run at the head
    assert same_bits(got.numpy(), np.asarray(want))


def test_wosc_s_filled_rows_match_single_rows():
    rng = np.random.RandomState(7)
    _, piluts = TW.get_tables()
    rows = [_phase_row(rng, 3000, runs=5, head_hold=r == 0)
            for r in range(3)]
    ph = np.stack([r[0] for r in rows])
    pp = np.array([r[1] for r in rows])
    fi = np.array([0, 17, 2999])
    do_rst = np.array([True, False, True])
    rph = (ph[np.arange(3), fi] - (1 << 21)) & M32
    ps = np.array([0.5, -0.25, 0.125], np.float32)
    pil = T(piluts[3])
    both = tdsp.wosc_s_filled(pil, 3, U(ph), U(pp), T(ps), T(fi),
                              T(do_rst), U(rph))
    for r in range(3):
        one = tdsp.wosc_s_filled(pil, 3, U(ph[r:r + 1]), U(pp[r:r + 1]),
                                 T(ps[r:r + 1]), T(fi[r:r + 1]),
                                 T(do_rst[r:r + 1]), U(rph[r:r + 1]))
        assert same_bits(both[r].numpy(), one[0].numpy())


def test_taps_at():
    _, piluts = JW.get_tables()
    pil = T(piluts[5])
    for cell in (0, 1, 1000, 2046, 2047):
        want = jdsp.taps_at(jnp.int32(cell), 5)
        got = tdsp.taps_at(pil, torch.tensor(cell))
        assert same_bits(got.numpy(), np.asarray(want))


def test_row_fill():
    rng = np.random.RandomState(8)
    vals = rng.randint(0, 1 << 32, 12, dtype=np.int64)
    act = rng.uniform(0, 1, 12) < 0.5
    act[0] = False
    seed = 12345
    want = jflat._row_fill(jnp.asarray(vals.astype(np.uint32)),
                           jnp.asarray(act), jnp.uint32(seed))
    last = tflat._row_last(T(act))
    got = tflat._row_hold(U(vals), last, torch.tensor(seed))
    assert same_bits(got.numpy(), np.asarray(want).astype(np.int64))
    # what the rows hand on: the value at the last active row
    any_act, val = tflat._last_active(U(vals), last)
    assert bool(any_act) and int(val) == int(vals[np.nonzero(act)[0][-1]])


@pytest.mark.parametrize('with_mul', [False, True])
@pytest.mark.parametrize('ltype', [1, 3, 9])
def test_line_run_vec(ltype, with_mul):
    rng = np.random.RandomState(ltype * 2 + with_mul)
    n, B = 16, 512
    flags = rng.randint(0, 128, (n, 1)).astype(np.int32)
    ls = {'v0': rng.uniform(-10, 10, (n, 1)).astype(np.float32),
          'vt': rng.uniform(-10, 10, (n, 1)).astype(np.float32),
          'pos': rng.randint(0, 3000, (n, 1)).astype(np.int32),
          'end': rng.randint(1, 3000, (n, 1)).astype(np.int32),
          'type': np.zeros((n, 1), np.int32), 'flags': flags}
    length = rng.randint(0, B + 1, (n, 1)).astype(np.int32)
    mul = rng.uniform(0.5, 2, (n, B)).astype(np.float32) \
        if with_mul else None
    idx = np.arange(B, dtype=np.int32)[None, :]
    wo, wn = jeng.line_run_vec(
        {k: jnp.asarray(v) for k, v in ls.items()}, B,
        jnp.asarray(length), None if mul is None else jnp.asarray(mul),
        static_type=ltype, idx=jnp.asarray(idx))
    to, tn = tstate.line_run_vec(
        {k: T(v).to(torch.int64) if v.dtype == np.int32 else T(v)
         for k, v in ls.items()}, B, T(length).to(torch.int64),
        None if mul is None else T(mul), ltype,
        T(idx).to(torch.int64))
    assert same_bits(to.numpy(), np.asarray(wo))
    for k in ('v0', 'pos', 'flags'):
        assert same_bits(tn[k].numpy(), np.asarray(wn[k])), k


def _random_records(seed, plan, n_recs=60):
    rng = np.random.RandomState(seed)
    ra = {k: np.array(v[:1].repeat(n_recs), copy=True)
          for k, v in plan.rec_arrays.items()}
    n_ops = plan.n_ops
    ra['kind'] = (rng.uniform(0, 1, n_recs) < 0.15).astype(np.int32)
    ra['op'] = rng.randint(0, n_ops, n_recs).astype(np.int32)
    ra['prepare'] = rng.uniform(0, 1, n_recs) < 0.2
    ra['params'] = rng.randint(0, 1 << 12, n_recs).astype(np.int32)
    ra['type'] = rng.randint(0, 4, n_recs).astype(np.int32)
    for k in ('seed', 'wadj_delta', 'phase_w', 'phase'):
        ra[k] = rng.randint(0, 1 << 32, n_recs,
                            dtype=np.int64).astype(np.uint32)
    ra['r2x_old'] = rng.uniform(0, 1, n_recs) < 0.5
    ra['r2x_new'] = rng.uniform(0, 1, n_recs) < 0.5
    return ra


@pytest.mark.parametrize('seed', range(4))
def test_apply_records_device_columns(seed):
    prg = jbuild(JArg(str='Wsin p[Wsin r2]\nRlin t.3\nNtw t.2',
                      is_path=False, no_time=True, predef=[]))
    plan = JPlan(prg, 6000)
    ra = _random_records(seed, plan)
    rng = np.random.RandomState(seed + 10)
    st = {'sf': rng.uniform(-1, 1, (plan.n_ops, tstate.NF))
          .astype(np.float32),
          'si': rng.randint(-2 ** 31, 2 ** 31, (plan.n_ops, tstate.NI),
                            dtype=np.int64).astype(np.int32),
          'vdur': np.zeros(plan.n_voices, np.int32)}
    lo, hi = 3, len(ra['op']) - 2
    want = jeng.apply_records({k: jnp.asarray(v) for k, v in st.items()},
                              lo, hi,
                              {k: jnp.asarray(v) for k, v in ra.items()},
                              device_cols_only=True)
    got = tstate.apply_records(convert.state(st, 'cpu'), lo, hi,
                               convert.records(ra), device_cols_only=True)
    assert same_bits(got['sf'].numpy(), np.asarray(want['sf']))
    assert same_bits(got['si'].numpy(), np.asarray(want['si']))


def test_make_state_matches():
    prg = jbuild(JArg(str='Wsin p[Wsin r2] ; f300', is_path=False,
                      no_time=True, predef=[]))
    plan = JPlan(prg, 6000)
    want = convert.state(jeng.make_state(plan), 'cpu')
    got = tstate.make_state(plan, 'cpu')
    for k in ('sf', 'si', 'vdur'):
        assert same_bits(got[k].numpy(), want[k].numpy())


def test_convert_records_and_state_checks():
    prg = jbuild(JArg(str='Wsin', is_path=False, no_time=True, predef=[]))
    plan = JPlan(prg, 6000)
    rec = convert.records(plan.rec_arrays)
    for k, v in plan.rec_arrays.items():
        assert rec[k].dtype == v.dtype and np.array_equal(rec[k], v)
    st = {k: np.asarray(v) for k, v in jeng.make_state(plan).items()}
    st['si'] = st['si'].astype(np.int64)
    with pytest.raises(ValueError):
        convert.state(st, 'cpu')


def test_to_i16():
    rng = np.random.RandomState(9)
    x = rng.uniform(-1.5, 1.5, (64, 33, 2)).astype(np.float32)
    x[0, :4, 0] = [0.5 / 32767, 1.5 / 32767, -0.5 / 32767, 1.0]
    assert same_bits(tstate._to_i16_device(T(x)).numpy(),
                     np.asarray(jeng._to_i16_device(jnp.asarray(x))))
    assert same_bits(tstate._to_i16_mono_device(T(x)).numpy(),
                     np.asarray(jeng._to_i16_mono_device(jnp.asarray(x))))
