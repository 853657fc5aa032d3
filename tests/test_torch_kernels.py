"""The port's hand-written CUDA kernels against their plain PyTorch
versions. Tests marked ``cuda`` need a card and skip without one; run
them there with ``python -m pytest tests/test_torch_kernels.py``.
Tolerance: bit-equality (the kernels evaluate the plain versions' exact
op sequence)."""
import numpy as np
import pytest
import torch

import saugns_tpu_torch as stt
from saugns_tpu_torch import kernels
from saugns_tpu_torch.dsp import wavetables as W
from saugns_tpu_torch.parallel.voicebank import BankRender, make_bank_script
from saugns_tpu_torch.render import tdsp
from saugns_tpu_torch.render.engine import TorchGenerator

M32 = 0xffffffff


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    kernels.build()
    return torch.device('cuda')


def test_wrappers_refuse_cpu_tensors():
    x = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError, match='CUDA'):
        kernels.scan_add_u32(x)
    pil = torch.zeros(W.LEN)
    one = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match='CUDA'):
        kernels.wosc_fill(pil, 0, x[None], one, torch.zeros(1), one,
                          torch.zeros(1, dtype=torch.bool), one)


def test_new_wrappers_refuse_cpu_tensors():
    x = torch.zeros((1, 4), dtype=torch.int64)
    f = torch.zeros((1, 4))
    act = torch.ones((1, 4), dtype=torch.bool)
    one = torch.zeros(1)
    with pytest.raises(ValueError, match='CUDA'):
        kernels.scan_add_u64(x[0])
    with pytest.raises(ValueError, match='CUDA'):
        kernels.wosc_selfmod(torch.zeros(W.LEN), 0, x, f, act,
                             torch.zeros(1, dtype=torch.int64), one, one)
    with pytest.raises(ValueError, match='CUDA'):
        kernels.rasg_selfmod(0, 1, 5, 0, 0, f, x, f, act, one, one)


def test_cpu_tensors_take_the_plain_version():
    before = dict(kernels.LAUNCHES)
    x = torch.arange(10, dtype=torch.int64)
    assert torch.equal(tdsp.prefix_sum(x), tdsp.prefix_sum_plain(x))
    assert torch.equal(tdsp.prefix_sum_u64(x - 5),
                       tdsp.prefix_sum_u64_plain(x - 5))
    args = _selfmod_args(np.random.RandomState(0), 2, 50, 'cpu')
    got = tdsp.wosc_selfmod(tdsp.wave_tables('cpu')[1][0], 0, *args)
    want = tdsp.wosc_selfmod_plain(tdsp.wave_tables('cpu')[1][0], 0,
                                   *args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    rargs = _rasg_args(np.random.RandomState(1), 2, 50, 'cpu')
    got = tdsp.rasg_selfmod(4, 10, 5, 0x9e3779b9, 16, *rargs)
    want = tdsp.rasg_selfmod_plain(4, 10, 5, 0x9e3779b9, 16, *rargs)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kernels.LAUNCHES == before


TILE = kernels.SCAN_TILE


def _u32_case(n, fill):
    """Kernel 2's inputs: u32 values, all ones, int64 over the whole
    range (high bits set) or negative values."""
    rng = np.random.RandomState(n + len(fill))
    if fill == 'random':
        return rng.randint(0, 1 << 32, n, dtype=np.int64)
    if fill == 'ones':
        return np.full(n, M32, np.int64)
    if fill == 'int64':
        return rng.randint(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
    return -rng.randint(1, 1 << 40, n, dtype=np.int64)


def _check_u32(x, xt, got):
    assert torch.equal(got, tdsp.prefix_sum_plain(xt))
    assert np.array_equal(got.cpu().numpy(), np.cumsum(x & M32) & M32)


def test_scan_out_and_scratch():
    """Kernels 2, 3 and 4 take no scratch for one tile; above, a tile
    counter and the tiles' statuses ride behind the output: one status
    word per tile (kernels 2 and 4), or two for kernel 3's 64-bit
    payload (``pair``)."""
    for dtype, pair in ((torch.int64, False), (torch.int32, False),
                        (torch.int64, True)):
        y, scratch = kernels._scan_out(torch.zeros(TILE, dtype=dtype),
                                       pair)
        assert y.shape == (TILE,) and y.dtype == dtype and scratch is None
        for n in (TILE + 1, 2 * TILE + 1, 3 * TILE + 1):
            y, scratch = kernels._scan_out(torch.zeros(n, dtype=dtype),
                                           pair)
            assert y.shape == (n,) and y.dtype == dtype
            assert y.is_contiguous()
            w = -(-n * y.element_size() // 8)
            assert scratch == y.data_ptr() + 8 * w
            tiles = -(-n // TILE)
            words = 2 * tiles if pair else tiles
            assert y.untyped_storage().nbytes() == 8 * (w + 1 + words)


def test_scan_out_rows():
    """(V, L) rows: no scratch for one tile a row; above, the counter
    and V x ceil(L / TILE) statuses (two words each for ``pair``)."""
    for V, L, pair in ((5, TILE, False), (256, 2, True), (3, TILE + 1, False),
                       (4, 2 * TILE + 1, True)):
        y, scratch = kernels._scan_out(torch.zeros((V, L),
                                                   dtype=torch.int64), pair)
        assert y.shape == (V, L) and y.is_contiguous()
        tiles = V * -(-L // TILE)
        if L <= TILE:
            assert scratch is None
            continue
        assert scratch == y.data_ptr() + 8 * V * L
        words = 2 * tiles if pair else tiles
        assert y.untyped_storage().nbytes() == 8 * (V * L + 1 + words)


def _rows_case(kind, V, L, fill):
    """(V, L) inputs of kernel 2 ('u32'), 3 ('u64') or 4 ('max'):
    wrapping (every add wraps; for kernel 4, a falling first row and
    values at 0 and 2^31 - 1) or full-range."""
    rng = np.random.RandomState(V * 7 + L)
    if kind == 'max':
        x = rng.randint(0, 1 << 31, (V, L), dtype=np.int64)
        if fill == 'wrap':
            x[:, ::3] = 0
            x[:, 1::5] = 0x7fffffff
            x[0] = np.arange(L, 0, -1)
        return x.astype(np.int32)
    if fill == 'wrap':
        return np.full((V, L), M32 if kind == 'u32' else -1, np.int64)
    return rng.randint(-(1 << 63), (1 << 63) - 1, (V, L), dtype=np.int64)


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(1, 1), (1, 96000), (4, 4097),
                                   (3, TILE), (2, 3 * TILE + 1),
                                   (256, 2), (256, 96000)])
@pytest.mark.parametrize('fill', ['wrap', 'random'])
@pytest.mark.parametrize('kind', ['u32', 'u64', 'max'])
def test_scan_rows(cuda, kind, fill, shape):
    """Kernels 2, 3 and 4 on (V, L) rows: one launch, each row scanned
    on its own (no row picks up the one before), = the plain version
    and the 1-D kernel row by row."""
    fn, plain = {'u32': (kernels.scan_add_u32, tdsp.prefix_sum_plain),
                 'u64': (kernels.scan_add_u64, tdsp.prefix_sum_u64_plain),
                 'max': (kernels.scan_max_i32, tdsp.scan_max_i32_plain)}[kind]
    xt = torch.from_numpy(_rows_case(kind, *shape, fill)).to(cuda)
    name = fn.__name__
    before = kernels.LAUNCHES[name]
    got = fn(xt)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    assert got.shape == xt.shape and got.dtype == xt.dtype
    assert torch.equal(got, plain(xt))
    for r in range(min(shape[0], 4)):
        assert torch.equal(got[r], fn(xt[r]))
    if kind != 'max':
        assert torch.equal(tdsp.prefix_sum_rows(
            xt, 32 if kind == 'u32' else 64), got)


@pytest.mark.cuda
@pytest.mark.parametrize('n', [1, 1023, 2048, 2049, TILE - 1, TILE,
                               TILE + 1, 3 * TILE + 1, 96000,
                               (1 << 22) + 3])
@pytest.mark.parametrize('fill', ['random', 'ones', 'int64', 'negative'])
def test_scan_add_u32(cuda, n, fill):
    x = _u32_case(n, fill)
    xt = torch.from_numpy(x).to(cuda)
    before = kernels.LAUNCHES['scan_add_u32']
    got = kernels.scan_add_u32(xt)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['scan_add_u32'] == before + 1
    assert got.dtype == torch.int64
    _check_u32(x, xt, got)


@pytest.mark.cuda
def test_scan_add_u32_many_tiles(cuda):
    """Far more tiles than the card holds at once (4,097), and an odd
    view (not 16-byte aligned)."""
    x = _u32_case((1 << 24) + 2, 'int64')
    xt = torch.from_numpy(x).to(cuda)
    got = kernels.scan_add_u32(xt[1:])
    torch.cuda.synchronize()
    _check_u32(x[1:], xt[1:], got)
    got = kernels.scan_add_u32(xt[:-1])
    torch.cuda.synchronize()
    _check_u32(x[:-1], xt[:-1], got)


@pytest.mark.cuda
def test_scan_add_u32_back_to_back_and_side_stream(cuda):
    """Calls of alternating large and small n with no synchronise
    between them, then one on a side stream: no call sees another's
    status words."""
    xs = [_u32_case(n, 'int64') for n in ((1 << 22) + 3, 5, 3 * TILE + 1,
                                          TILE, (1 << 20) + 7, 1)]
    xts = [torch.from_numpy(x).to(cuda) for x in xs]
    torch.cuda.synchronize()
    outs = [kernels.scan_add_u32(xt) for xt in xts]
    torch.cuda.synchronize()
    for x, xt, got in zip(xs, xts, outs):
        _check_u32(x, xt, got)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = kernels.scan_add_u32(xts[2])
    torch.cuda.synchronize()
    _check_u32(xs[2], xts[2], got)


def _u64_case(n, fill='random'):
    """Kernel 3's inputs: int64 bits over the whole range, or all
    ones (-1: every add wraps)."""
    if fill == 'ones':
        return np.full(n, -1, np.int64)
    rng = np.random.RandomState(n + 3)
    return rng.randint(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)


def _check_u64(x, xt, got):
    assert got.dtype == torch.int64 and got.shape == xt.shape
    assert torch.equal(got, tdsp.prefix_sum_u64_plain(xt))
    want = np.cumsum(x.view(np.uint64)).view(np.int64)
    assert np.array_equal(got.cpu().numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize('n', [1, 2047, 2049, TILE - 1, TILE, TILE + 1,
                               2 * TILE + 1, 38912, 131072, (1 << 22) + 3,
                               (1 << 24) + 1])
@pytest.mark.parametrize('fill', ['random', 'ones'])
def test_scan_add_u64(cuda, n, fill):
    x = _u64_case(n, fill)
    xt = torch.from_numpy(x).to(cuda)
    before = kernels.LAUNCHES['scan_add_u64']
    got = kernels.scan_add_u64(xt)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['scan_add_u64'] == before + 1
    _check_u64(x, xt, got)


@pytest.mark.cuda
def test_scan_add_u64_views_back_to_back_and_side_stream(cuda):
    """Odd-offset views (not 16-byte aligned), calls of alternating
    large and small n with no synchronise between them, and one call on
    a side stream: no call sees another's status words."""
    x = _u64_case(3 * TILE + 2)
    xt = torch.from_numpy(x).to(cuda)
    for a, b in ((1, None), (1, -1), (3, 3 * TILE + 2)):
        got = kernels.scan_add_u64(xt[a:b])
        torch.cuda.synchronize()
        _check_u64(x[a:b], xt[a:b], got)
    xs = [_u64_case(n) for n in ((1 << 22) + 3, 5, 3 * TILE + 1, TILE,
                                 (1 << 20) + 7, 1, 2 * TILE + 1)]
    xts = [torch.from_numpy(x).to(cuda) for x in xs]
    torch.cuda.synchronize()
    outs = [kernels.scan_add_u64(xt) for xt in xts]
    torch.cuda.synchronize()
    for x, xt, got in zip(xs, xts, outs):
        _check_u64(x, xt, got)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = kernels.scan_add_u64(xts[2])
    torch.cuda.synchronize()
    _check_u64(xs[2], xts[2], got)


def _selfmod_args(rng, V, L, device):
    """(ph, am, act, pp0, ps0, fb0) for wosc self-PM: audio-rate phase
    rows with pd == 0 runs, inactive gaps and non-zero seeds."""
    inc = rng.randint(1 << 16, 1 << 26, (V, L)).astype(np.int64)
    act = np.ones((V, L), bool)
    for r in range(V):
        a = rng.randint(0, L)
        inc[r, a:a + rng.randint(1, 200)] = 0
        a = rng.randint(0, L)
        act[r, a:a + rng.randint(1, 300)] = False
    pp0 = rng.randint(0, 1 << 32, V).astype(np.int64)
    ph = (pp0[:, None] + np.cumsum(inc, axis=1)) & M32
    am = rng.uniform(-1.5, 1.5, (V, L)).astype(np.float32)
    am[:, :L // 8] = 0       # pd == 0 stays pd == 0 without feedback
    ps0 = rng.uniform(-1, 1, V).astype(np.float32)
    fb0 = rng.uniform(-1, 1, V).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return t(ph), t(am), t(act), t(pp0), t(ps0), t(fb0)


def _rasg_args(rng, V, L, device):
    """(phase, cycle, am, act, ps0, fb0) for RasG self-PM."""
    phase = rng.uniform(0, 1, (V, L)).astype(np.float32)
    cycle = rng.randint(0, 1 << 32, (V, L)).astype(np.int64)
    am = rng.uniform(-4, 4, (V, L)).astype(np.float32)
    act = rng.uniform(0, 1, (V, L)) < 0.9
    ps0 = rng.uniform(-1, 1, V).astype(np.float32)
    fb0 = rng.uniform(-1, 1, V).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return t(phase), t(cycle), t(am), t(act), t(ps0), t(fb0)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.cuda
@pytest.mark.parametrize('V,L', [(1, 1), (1, 3000), (64, 512)])
@pytest.mark.parametrize('wave', [W.N_sin, W.N_sqr, W.N_saw, W.N_spa])
def test_wosc_selfmod(cuda, V, L, wave):
    rng = np.random.RandomState(V * 100 + L + wave)
    pil = tdsp.wave_tables(cuda)[1][wave]
    args = _selfmod_args(rng, V, L, cuda)
    before = kernels.LAUNCHES['wosc_selfmod']
    got = kernels.wosc_selfmod(pil, wave, *args)
    want = tdsp.wosc_selfmod_plain(pil, wave, *args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['wosc_selfmod'] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))


@pytest.mark.cuda
@pytest.mark.parametrize('func', range(6))
@pytest.mark.parametrize('line,oflags', [(0, 0), (1, 1), (3, 2), (8, 4),
                                         (10, 8), (11, 16), (12, 17),
                                         (9, 31)])
def test_rasg_selfmod(cuda, func, line, oflags):
    rng = np.random.RandomState(func * 100 + line)
    args = _rasg_args(rng, 32, 256, cuda)
    level = 27 if func == 4 and line == 9 else 5
    got = kernels.rasg_selfmod(func, line, level, 0x9e3779b9, oflags,
                               *args)
    want = tdsp.rasg_selfmod_plain(func, line, level, 0x9e3779b9, oflags,
                                   *args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))


# the staging tile of kernels 5 and 6 (ST_T of csrc/selfmod_stage.cuh)
SELF_TILE = 128


def _selfmod_rows_case(rng, V, L, device):
    """Kernel 5's inputs for the staged design: lanes of one warp that
    diverge on the gate and on pd == 0 (runs per row), a whole inactive
    row, an inactive stretch across every row (whole skip groups) and
    the rest as _selfmod_args."""
    ph, am, act, pp0, ps0, fb0 = _selfmod_args(rng, V, L, 'cpu')
    act = act.clone()
    ph = ph.clone()
    for r in range(V):
        a = rng.randint(0, L)
        ph[r, a:a + rng.randint(1, 70)] = ph[r, a]   # pd == 0 run
        a = rng.randint(0, L)
        act[r, a:a + rng.randint(1, 90)] = False
    if V > 2:
        act[V // 2] = False                      # a whole inactive row
    if L > 2 * SELF_TILE:
        act[:, SELF_TILE + 3:2 * SELF_TILE + 40] = False
    return tuple(t.to(device) for t in (ph, am, act, pp0, ps0, fb0))


@pytest.mark.cuda
@pytest.mark.parametrize('V,L', [(1, 1), (1, SELF_TILE - 1), (1, SELF_TILE),
                                 (1, SELF_TILE + 1), (1, 1001),
                                 (31, 300), (32, 2 * SELF_TILE + 1),
                                 (33, 517), (65, 3 * SELF_TILE - 1)])
@pytest.mark.parametrize('wave', [W.N_sin, W.N_spa])
def test_wosc_selfmod_staged(cuda, V, L, wave):
    """Kernel 5 bit-equal to its plain version at row lengths around the
    staging tile and V around the 32 rows of a block."""
    rng = np.random.RandomState(7 * V + L + wave)
    pil = tdsp.wave_tables(cuda)[1][wave]
    args = _selfmod_rows_case(rng, V, L, cuda)
    got = kernels.wosc_selfmod(pil, wave, *args)
    want = tdsp.wosc_selfmod_plain(pil, wave, *args)
    torch.cuda.synchronize()
    assert got[1].dtype == torch.int64
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))


def _rasg_rows_case(rng, V, L, run, device):
    """Kernel 6's inputs: cycles that change every sample (``run`` 1)
    or stay for ``run`` samples with small amounts (so the feedback
    seldom moves the cycle), inactive stretches per row and across
    every row, a whole inactive row."""
    phase, cycle, am, act, ps0, fb0 = _rasg_args(rng, V, L, 'cpu')
    act = act.clone()
    if run > 1:
        base = rng.randint(0, 1 << 32, (V, L // run + 1)).astype(np.int64)
        cycle = torch.from_numpy(np.repeat(base, run, axis=1)[:, :L].copy())
        am = am * 0.01
    for r in range(V):
        a = rng.randint(0, L)
        act[r, a:a + rng.randint(1, 90)] = False
    if V > 2:
        act[V // 2] = False
    if L > 2 * SELF_TILE:
        act[:, SELF_TILE + 3:2 * SELF_TILE + 40] = False
    return tuple(t.to(device) for t in (phase, cycle, am, act, ps0, fb0))


RASG_FLAG_SETS = [0, 1, 2 | 4, 8 | 16]   # 0, p, h|z, s|v
RASG_FUNC_LEVELS = [(0, 5), (1, 5), (2, 5), (3, 5), (4, 5), (4, 27),
                    (5, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize('func,level', RASG_FUNC_LEVELS)
@pytest.mark.parametrize('line', range(13))
@pytest.mark.parametrize('oflags', RASG_FLAG_SETS)
def test_rasg_selfmod_every_mode(cuda, func, level, line, oflags):
    """Kernel 6's row loop of every (function, line type) pair (the
    fixed function at level 5 and at 27, its +-1 pair) under each flag
    set, on 33 rows whose cycle changes every sample."""
    rng = np.random.RandomState(1000 * func + 10 * line + oflags + level)
    args = _rasg_rows_case(rng, 33, 2 * SELF_TILE + 45, 1, cuda)
    got = kernels.rasg_selfmod(func, line, level, 0x9e3779b9, oflags,
                               *args)
    want = tdsp.rasg_selfmod_plain(func, line, level, 0x9e3779b9, oflags,
                                   *args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))


@pytest.mark.cuda
@pytest.mark.parametrize('func,level', RASG_FUNC_LEVELS)
def test_rasg_selfmod_slow_cycles(cuda, func, level):
    """Kernel 6 keeps the last cycle's endpoints: rows whose cycle
    stays for thousands of samples (and a row length off the tile)."""
    k = RASG_FUNC_LEVELS.index((func, level))
    line = (3 * k) % 13
    oflags = RASG_FLAG_SETS[k % len(RASG_FLAG_SETS)]
    rng = np.random.RandomState(77 + k)
    args = _rasg_rows_case(rng, 3, 4500, 3000, cuda)
    got = kernels.rasg_selfmod(func, line, level, 0x9e3779b9, oflags,
                               *args)
    want = tdsp.rasg_selfmod_plain(func, line, level, 0x9e3779b9, oflags,
                                   *args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))


@pytest.mark.cuda
def test_rasg_selfmod_bank_slab(cuda):
    """Kernel 6 at a bank slab's shape, 256 rows of 96,000 samples, in
    the mode of the self-PM voice ``Rcos mf f60 p.a.5[Rlin f7 a.4]``
    (the fixed function at level 27, the cos line): the rows' cyclor
    positions of 60-240 Hz voices at 2x rate, amounts of 0.5 +- 0.4."""
    V, L = 256, 96000
    rng = np.random.RandomState(2026)
    step = 2.0 * 60.0 * 2.0 ** (rng.randint(0, 25, V) / 12.0) / 96000
    pos = np.arange(L)[None, :] * step[:, None]
    seg = np.floor(pos)
    cycle = (rng.randint(0, 1 << 31, V)[:, None] * 2 + seg.astype(np.int64)
             ) & M32
    phase = (pos - seg).astype(np.float32)
    am = (0.5 + 0.4 * rng.uniform(-1, 1, (V, L))).astype(np.float32)
    act = np.ones((V, L), bool)
    zero = np.zeros(V, np.float32)
    t = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    args = (t(phase), t(cycle), t(am), t(act), t(zero), t(zero))
    got = kernels.rasg_selfmod(4, 0, 27, 0x9e3779b9, 0, *args)
    want = tdsp.rasg_selfmod_plain(4, 0, 27, 0x9e3779b9, 0, *args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))


def _rasg_fill_case(rng, rows, B, scan, pm, device):
    """Kernel 11's inputs over ``rows`` + (B,): row lengths under B
    (an empty and a full row), start counts and increments over the
    whole int64 range, a per-row (``scan`` False) or a per-sample count
    (kernel 3's sums of masked increments), and PM offsets (``pm``)
    with NaN, +-inf, +-2^70, values near +-2^63 and ordinary ones."""
    n = int(np.prod(rows))
    ln = rng.randint(0, B + 1, n)
    ln[0] = 0
    ln[-1] = B
    kw = {'base': rng.randint(-(1 << 63), (1 << 63) - 1, n,
                              dtype=np.int64)}
    if scan:
        incs = rng.randint(0, 1 << 40, (n, B)).astype(np.int64)
        incs[np.arange(B)[None, :] >= ln[:, None]] = 0
        kw['incs'] = incs
        kw['csum'] = np.cumsum(incs.reshape(-1, rows[-1] * B), axis=1,
                               dtype=np.uint64).view(np.int64)
    else:
        kw['inc'] = rng.randint(-(1 << 63), (1 << 63) - 1, n,
                                dtype=np.int64)
        kw['ln'] = ln.astype(np.int64)
    if pm:
        p = rng.uniform(-6.0, 6.0, n * B).astype(np.float32)
        k = rng.choice(p.size, min(p.size, 12), replace=False)
        p[k] = [np.nan, np.inf, -np.inf, 2.0 ** 70, -2.0 ** 70, 0.5,
                -0.5, 2.5, 4.61e18, -4.61e18, 2.0 ** 62,
                -2.0 ** 62][:k.size]
        kw['pofs'] = p
    out = {}
    for name, a in kw.items():
        shape = rows + (B,) if a.size == n * B else rows
        out[name] = torch.from_numpy(np.ascontiguousarray(a)).reshape(
            shape).to(device)
    return out


def _check_rasg_fill(func, line, level, oflags, B, kw, pscale=tdsp.P31):
    got = kernels.rasg_fill(func, line, level, 0x9e3779b9, oflags,
                            B=B, pscale=pscale, **kw)
    want = tdsp.rasg_fill_plain(func, line, level, 0x9e3779b9, oflags,
                                B=B, pscale=pscale, **kw)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want)), int((got != want).sum())


RASG_FILL_FLAGS = [0, 16, 1, 2, 4, 8, 1 | 8 | 16, 2 | 4 | 16]


@pytest.mark.cuda
@pytest.mark.parametrize('func,level', RASG_FUNC_LEVELS)
@pytest.mark.parametrize('line', range(13))
def test_rasg_fill_every_mode(cuda, func, level, line):
    """Kernel 11 of every (function, line type) pair, bit for bit its
    plain version on the card: a per-row and a per-sample count, rows
    of 4-sample groups (16-byte accesses) and of an odd length, each
    under a flag set and PM offsets that test ftoi's saturation."""
    k = RASG_FUNC_LEVELS.index((func, level))
    oflags = RASG_FILL_FLAGS[(k + line) % len(RASG_FILL_FLAGS)]
    rng = np.random.RandomState(500 + 13 * k + line)
    for scan in (False, True):
        for B in (1024, 1001):
            kw = _rasg_fill_case(rng, (3, 5), B, scan, True, cuda)
            _check_rasg_fill(func, line, level, oflags, B, kw,
                             pscale=tdsp.P31 * (1 + (line % 2)))


@pytest.mark.cuda
@pytest.mark.parametrize('oflags', RASG_FILL_FLAGS)
@pytest.mark.parametrize('scan', [False, True])
@pytest.mark.parametrize('pm', [False, True])
def test_rasg_fill_flags_and_inputs(cuda, oflags, scan, pm):
    """Each flag set with and without a PM input, both count forms, on
    the uniform map's cos line (the benchmark voice's mode) and the
    binary map's exponential line."""
    rng = np.random.RandomState(oflags + 64 * scan + 128 * pm)
    for func, line in ((0, 0), (2, 3)):
        kw = _rasg_fill_case(rng, (2, 3), 517, scan, pm, cuda)
        _check_rasg_fill(func, line, 5, oflags, 517, kw)


@pytest.mark.cuda
def test_rasg_fill_views_and_rows(cuda):
    """Odd views (a transposed PM offset, a count buffer that starts
    off a 16-byte boundary), a row count above one grid column
    (65,535), and the bank slab's shape, 256 voices of 2 rows of
    65,536 samples, with the benchmark voice's row lengths."""
    rng = np.random.RandomState(7)
    kw = _rasg_fill_case(rng, (4, 64), 64, False, True, cuda)
    kw['pofs'] = kw['pofs'].transpose(-1, -2).contiguous() \
        .transpose(-1, -2)
    _check_rasg_fill(0, 0, 5, 0, 64, kw)
    kw = _rasg_fill_case(rng, (3, 8), 64, True, True, cuda)
    for name in ('csum', 'incs', 'pofs'):
        t = kw[name]
        big = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        kw[name] = big[1:].view(t.shape).copy_(t)
    _check_rasg_fill(4, 12, 5, 16, 64, kw)
    kw = _rasg_fill_case(rng, (70001,), 8, False, True, cuda)
    _check_rasg_fill(1, 10, 5, 1, 8, kw)
    kw = _rasg_fill_case(rng, (256, 2), 65536, False, True, cuda)
    kw['ln'] = torch.tensor([65536, 96000 - 65536], device=cuda) \
        .repeat(256).reshape(256, 2)
    _check_rasg_fill(0, 0, 27, 0, 65536, kw)


def test_rasg_fill_refuses_what_it_does_not_take():
    one = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match='CUDA'):
        kernels.rasg_fill(0, 0, 5, 0, 0, one, 4, inc=one, ln=one)
    with pytest.raises(ValueError, match='inc and ln'):
        kernels.rasg_fill(0, 0, 5, 0, 0, one, 4, inc=one)
    with pytest.raises(ValueError, match='pofs must be'):
        kernels.rasg_fill(0, 0, 5, 0, 0, one, 4,
                          pofs=torch.zeros((2, 4), dtype=torch.float64),
                          inc=one, ln=one)


@pytest.mark.cuda
def test_rasg_fill_counts_bank_replays(cuda):
    """An R bank through BankRender: each replay of its slab graph
    counts kernel 11's launches, and its output equals the plain
    path's and the CPU's."""
    src = 'S a.m0.25\n' + ''.join(
        'R f%.2f t.3 a1 c%.1f p[Wsin f1.5.r0[Wsin f0.07] a12.5.r0'
        '[Wsin f0.07]]\n' % (50.0 * 2.0 ** (k / 12.0), k / 4.0 - 0.4)
        for k in range(4))
    prg = stt.compile_script(src)
    br = BankRender(prg, 96000, device=cuda)
    first = br.render_i16().cpu().numpy()
    per = []
    for _ in range(2):
        kernels.reset_launches()
        got = br.render_i16().cpu().numpy()
        per.append(kernels.LAUNCHES['rasg_fill'])
    pairs = sum(slab.nch * len(slab.rasg_pairs)
                for sh in br.prepare() for slab in sh.slabs)
    assert pairs > 0 and per == [pairs, pairs]
    assert br.graph_stats()['replays'] > 0
    want = BankRender(prg, 96000, device=cuda, plain=True).render_i16()
    cpu = BankRender(prg, 96000, device='cpu').render_i16()
    assert np.array_equal(first, got)
    assert np.array_equal(got, want.cpu().numpy())
    assert np.array_equal(got, cpu.numpy())


def _fill_args(rng, V, L, wave, device):
    inc = rng.randint(1 << 16, 1 << 26, (V, L)).astype(np.int64)
    for r in range(V):
        for _ in range(6):
            a = rng.randint(0, L)
            inc[r, a:a + rng.randint(1, 700)] = 0
    inc[0, :2] = 0
    pp = rng.randint(0, 1 << 32, V).astype(np.int64)
    ph = (pp[:, None] + np.cumsum(inc, axis=1)) & M32
    fi = rng.randint(0, L, V).astype(np.int64)
    do_rst = rng.uniform(0, 1, V) < 0.7
    rph = (ph[np.arange(V), fi] - (1 << W.SLENBITS)) & M32
    ps = rng.uniform(-1, 1, V).astype(np.float32)
    pil = tdsp.wave_tables(device)[1][wave]
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return (pil, wave, t(ph), t(pp), t(ps), t(fi), t(do_rst), t(rph))


FT = kernels.FILL_TILE


@pytest.mark.cuda
@pytest.mark.parametrize('V,L', [(1, 1), (1, 255), (1, 96000), (3, 70001),
                                 (2, 1 << 19), (1, FT - 1), (1, FT),
                                 (1, FT + 1), (1, 5 * FT + 1), (1, 131072),
                                 (3, 2 * FT + 3)])
@pytest.mark.parametrize('wave', [W.N_sin, W.N_sqr, W.N_saw])
def test_wosc_fill(cuda, V, L, wave):
    rng = np.random.RandomState(V * 1000 + L + wave)
    args = _fill_args(rng, V, L, wave, cuda)
    got = kernels.wosc_fill(*args)
    want = tdsp.wosc_s_filled_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _fill_edges(rng, L, wave, device):
    """Kernel 1's tile edges on V = 3 rows of L samples: pd == 0 runs
    across tile edges (one of more than a look-back window of 32
    tiles), row 0 reset at index 0, row 1 at a tile's first sample after
    a pd == 0 run, row 1's tail and row 2's head both pd == 0 (a run
    across a row boundary: row 2 shows its own seed), row 2 reset at a
    tile's first sample."""
    V = 3
    inc = rng.randint(1 << 16, 1 << 26, (V, L)).astype(np.int64)
    for r in range(V):
        for e in range(FT, L, FT):
            inc[r, max(e - rng.randint(1, 40), 0):e + rng.randint(1, 40)] = 0
    if L > 40 * FT:
        inc[0, 3 * FT - 5:37 * FT + 9] = 0
    inc[1, -min(L, 50):] = 0
    inc[2, :min(L, 70)] = 0
    pp = rng.randint(0, 1 << 32, V).astype(np.int64)
    ph = (pp[:, None] + np.cumsum(inc, axis=1)) & M32
    fi = np.array([0, min(FT, L - 1), min(2 * FT, L - 1)], np.int64)
    do_rst = np.array([True, True, L > 2 * FT])
    rph = (ph[np.arange(V), fi] - (1 << W.SLENBITS)) & M32
    ps = rng.uniform(-1, 1, V).astype(np.float32)
    pil = tdsp.wave_tables(device)[1][wave]
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return (pil, wave, t(ph), t(pp), t(ps), t(fi), t(do_rst), t(rph))


def _check_fill(args, got, masked=None):
    """``got`` = kernel 1 of ``args`` against the plain version of
    ``masked`` (the args with phases & 0xffffffff) or of ``args``."""
    torch.cuda.synchronize()
    want = tdsp.wosc_s_filled_plain(*(masked or args))
    assert torch.isfinite(got).all()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize('L', [1, 2, FT - 1, FT, FT + 1, 2 * FT,
                               3 * FT + 1, 41 * FT + 7])
def test_wosc_fill_tile_edges(cuda, L):
    args = _fill_edges(np.random.RandomState(L), L, W.N_sin, cuda)
    _check_fill(args, kernels.wosc_fill(*args))


@pytest.mark.cuda
@pytest.mark.parametrize('L', [5, FT + 1, 3 * FT + 1])
def test_wosc_fill_all_held(cuda, L):
    """A row whose phase never moves is its seed ps throughout, also
    with a reset pending (the reset sample itself is valid)."""
    rng = np.random.RandomState(L + 1)
    args = list(_fill_edges(rng, L, W.N_tri, cuda))
    ph = args[3][:, None].expand(3, L).contiguous()
    args[2] = ph
    args[6] = torch.tensor([False, False, True], device=cuda)
    args[7] = (ph[torch.arange(3, device=cuda), args[5]]
               - (1 << W.SLENBITS)) & M32
    got = kernels.wosc_fill(*args)
    _check_fill(args, got)
    assert (got[:2] == args[4][:2, None]).all()


@pytest.mark.cuda
@pytest.mark.parametrize('L', [FT - 1, 3 * FT + 1, 131072])
def test_wosc_fill_high_bits(cuda, L):
    """int64 phases and seed phases with bits above 32 set (and
    negative ones): only the low 32 bits count."""
    rng = np.random.RandomState(L + 2)
    args = _fill_edges(rng, L, W.N_saw, cuda)
    hi = lambda t: t + (torch.from_numpy(  # noqa: E731
        rng.randint(-(1 << 30), 1 << 30, tuple(t.shape))).to(cuda) << 32)
    wide = list(args)
    for i in (2, 3, 7):
        wide[i] = hi(args[i])
    assert (wide[2] < 0).any() and (wide[2] >> 32 != 0).any()
    _check_fill(wide, kernels.wosc_fill(*wide), masked=args)


@pytest.mark.cuda
@pytest.mark.parametrize('V,L', [(1, 3 * FT + 1), (3, FT + 5), (2, 999)])
def test_wosc_fill_odd_views(cuda, V, L):
    """Phase rows that start at an odd element (not 16-byte aligned)."""
    rng = np.random.RandomState(V + L)
    args = list(_fill_args(rng, V, L, W.N_sin, cuda))
    flat = torch.cat([torch.zeros(1, dtype=torch.int64, device=cuda),
                      args[2].reshape(-1)])
    view = flat[1:].view(V, L)
    assert view.data_ptr() % 16 != 0 and view.is_contiguous()
    args[2] = view
    _check_fill(args, kernels.wosc_fill(*args))


@pytest.mark.cuda
def test_wosc_fill_back_to_back_and_side_stream(cuda):
    """Calls of every size in turn with no synchronise between them:
    no call may see another's status words; and one on a side stream."""
    rng = np.random.RandomState(11)
    cases = [_fill_edges(rng, L, W.N_sin, cuda)
             for L in (41 * FT + 7, 5, 3 * FT + 1, FT, 1, 2 * FT + 1)]
    torch.cuda.synchronize()
    outs = [kernels.wosc_fill(*a) for a in cases]
    for a, got in zip(cases, outs):
        _check_fill(a, got)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = kernels.wosc_fill(*cases[2])
    _check_fill(cases[2], got)


def test_fill_and_is64_refuse_other_dtypes():
    """Kernels 1 and 9 read the callers' dtypes as they are and convert
    nothing: any other dtype raises ValueError (checked before the
    device)."""
    V, L = 2, 10
    pil = torch.zeros(W.LEN)
    good = [pil, 0, torch.zeros((V, L), dtype=torch.int64),
            torch.zeros(V, dtype=torch.int64), torch.zeros(V),
            torch.zeros(V, dtype=torch.int64),
            torch.zeros(V, dtype=torch.bool),
            torch.zeros(V, dtype=torch.int64)]
    for i, dt in ((2, torch.int32), (2, torch.float32), (3, torch.int32),
                  (4, torch.float64), (5, torch.int32), (6, torch.uint8),
                  (6, torch.int64), (7, torch.int32)):
        bad = list(good)
        bad[i] = good[i].to(dt)
        with pytest.raises(ValueError, match='must be'):
            kernels.wosc_fill(*bad)
    for dt in (torch.int32, torch.uint8, torch.float64):
        with pytest.raises(ValueError, match='int64'):
            kernels.is64(pil, torch.zeros(8, dtype=dt))


@pytest.mark.cuda
@pytest.mark.parametrize('script,launched', [
    ('Wsin', {'wosc_fill', 'scan_max_i32'}),
    ('Wsqr t.4 f80.r160[Wsin f2] a.7', {'wosc_fill', 'scan_add_u32',
                                        'scan_max_i32'}),
    ('Wsin f600 t.3 p[Wsin r1.5] ; f500 t.3', {'wosc_fill',
                                               'scan_max_i32'}),
    ('Wsin t.4 f100 | Wtri t.3 f220', {'wosc_fill', 'scan_max_i32'}),
    (make_bank_script(16, seed=1, duration=0.3), {'wosc_fill',
                                                  'scan_max_i32'}),
    ('Nre t.2 a.4 ; Ngw t.1', {'scan_add_u32'}),
    ('Rlin mb t.2 f300 a.5', {'rasg_fill'}),
    ('Rcos t.2 f80.r160[Wsin f2] a.7', {'wosc_fill', 'scan_add_u64',
                                        'scan_max_i32', 'rasg_fill'}),
    ('Wsin f110 t.05 p.a.3', {'wosc_selfmod'}),
    ('Rcos mf f60 p.a.5[Rlin f7 a.4] a.6 t.05', {'rasg_selfmod',
                                                 'rasg_fill'}),
    ('R f50 t.2 p[Wsin f1.5 a12.5] p.f[Wsin f3 a.5]', {
        'wosc_fill', 'scan_max_i32', 'rasg_fill'}),
])
def test_kernel_path_equals_plain_path(cuda, script, launched):
    kernels.reset_launches()
    got = stt.render(script, srate=48000, device=cuda)
    assert {k for k, n in kernels.LAUNCHES.items() if n} == launched
    want = stt.render(script, srate=48000, device=cuda, plain=True)
    cpu = stt.render(script, srate=48000, device='cpu')
    assert np.array_equal(got, want) and np.array_equal(got, cpu)


@pytest.mark.cuda
def test_row_ramp_runs_no_plain_scan_on_cuda(cuda, monkeypatch):
    """A scalar-frequency phase (the row ramp) on a CUDA render sums its
    row totals with torch.cumsum, never with a kernel's plain
    version."""
    def refuse(*_a, **_k):
        raise AssertionError('plain version on a CUDA render')

    for name in ('prefix_sum_plain', 'prefix_sum_u64_plain',
                 'wosc_s_filled_plain', 'wosc_selfmod_plain',
                 'rasg_selfmod_plain', 'rasg_fill_plain'):
        monkeypatch.setattr(tdsp, name, refuse)
    kernels.reset_launches()
    got = stt.render('Wsin f220 t.3 ; Rlin f300 t.2', srate=48000,
                     device=cuda)
    assert kernels.LAUNCHES['wosc_fill'] > 0 and got.shape == (28800, 2)


# -- the sequential engine's kernels (4, 7/8, 9, 10) ----------------------------

def test_seq_wrappers_refuse_cpu_tensors():
    pil = torch.zeros(W.LEN)
    x = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError, match='CUDA'):
        kernels.gather_taps(pil, x)
    with pytest.raises(ValueError, match='CUDA'):
        kernels.is64(pil, x)
    with pytest.raises(ValueError, match='CUDA'):
        kernels.ffill(torch.zeros((1, 8)), torch.ones((1, 8), dtype=bool),
                      torch.zeros(1))
    with pytest.raises(ValueError, match='CUDA'):
        kernels.scan_max_i32(x.to(torch.int32))


def test_seq_cpu_tensors_take_the_plain_version():
    before = dict(kernels.LAUNCHES)
    rng = np.random.RandomState(3)
    pil = tdsp.wave_tables('cpu')[1][4]
    ph = torch.from_numpy(rng.randint(0, 1 << 32, 300, dtype=np.int64))
    cells = tdsp.wosc_cells(ph)
    assert torch.equal(tdsp.gather_taps(pil, cells),
                       tdsp.gather_taps_plain(pil, cells))
    assert torch.equal(tdsp.is64(pil, ph), tdsp.is64_plain(pil, ph))
    s, valid, seed = _ffill_args(rng, 3, 300, 'cpu')
    assert torch.equal(tdsp.forward_fill_last_valid(s, valid, seed),
                       tdsp.last_valid_fill(s, valid, seed))
    args = [torch.from_numpy(a) for a in _ffill_edges(rng, 300)]
    assert torch.equal(tdsp.forward_fill_valid(*args),
                       tdsp.forward_fill_valid_plain(*args))
    x = torch.from_numpy(rng.randint(0, 1000, 77).astype(np.int32))
    assert torch.equal(tdsp.scan_max_i32(x), tdsp.scan_max_i32_plain(x))
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize('dtype', [np.int64, np.int32])
def test_gather_taps_cpu_wide_cells(dtype):
    """On CPU tensors the dispatcher takes the plain version, which
    reads any integer cell mod 2048: negative cells and cells far above
    2047, int64 and int32, against numpy."""
    before = dict(kernels.LAUNCHES)
    rng = np.random.RandomState(9)
    pil = tdsp.wave_tables('cpu')[1][W.N_saw]
    c = _cells(rng, 1003, dtype, 'wide')
    got = tdsp.gather_taps(pil, torch.from_numpy(c))
    p = pil.numpy()
    want = np.stack([p[(c.astype(np.int64) + t) & (W.LEN - 1)]
                     for t in (-1, 0, 1, 2)])
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    assert kernels.LAUNCHES == before


def _ffill_args(rng, V, L, device):
    """Rows of values with runs of invalid samples (one longer than a
    32-tile look-back window where L allows), an invalid head (the seed
    shows), an all-valid row and an all-invalid row."""
    s = rng.uniform(-1, 1, (V, L)).astype(np.float32)
    valid = np.ones((V, L), bool)
    for r in range(V):
        for _ in range(6):
            a = rng.randint(0, L)
            valid[r, a:a + rng.randint(1, 700)] = False
        if L > 140000:
            a = rng.randint(0, L - 70000)
            valid[r, a:a + 70000] = False
    valid[0, :5] = False
    if V > 2:
        valid[1] = True
        valid[2] = False
    seed = rng.uniform(-1, 1, V).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return t(s), t(valid), t(seed)


FF_ITEMS = FT // 256     # kernel 10's positions a thread


def _ffill_lengths(V, L):
    """(V,) int64 lengths cycling over kernel 10's edge cases: negative,
    0, 1, around a tile edge, half a row, L - 1, L and past L."""
    lens = [-1, 0, 1, FT - 1, FT, FT + 1, L // 2, L - 1, L, L + 5]
    return np.array([lens[r % len(lens)] for r in range(V)], np.int64)


def _ffill_edges(rng, L):
    """(s, valid, seed, length) numpy rows at kernel 10's edges: each
    length of -3, 0, 1, around a tile edge, L // 2, L and L + 5 with
    each mask: all valid; a run across a tile edge; isolated invalid
    positions at a tile head, the row head and the row end; a pair only
    past length, beside an isolated one in range; an invalid head run;
    10% invalid; all invalid; a lone pair at a tile, warp or thread edge
    (the tile, a warp and a thread start at multiples of FT, 32 *
    FF_ITEMS and FF_ITEMS), with a pair at the row end, past most
    lengths, that tells the branches apart there."""
    lens = [-3, 0, 1, FT - 1, FT, FT + 1, L // 2, L, L + 5]
    valid = np.ones((10 * len(lens), L), bool)
    length = np.array(lens * 10, np.int64)
    for r, (pat, ln) in enumerate((p, ln) for p in range(10)
                                  for ln in lens):
        v = valid[r]
        if pat == 1:
            v[max(0, FT - 8):FT + 8] = False
            v[3 % L] = False
        elif pat == 2:
            v[[0, min(FT, L - 1), L - 1]] = False
        elif pat == 3:
            v[max(ln, 0):max(ln, 0) + 2] = False
            if 3 < ln < L + 3:
                v[ln - 3] = False
        elif pat == 4:
            v[:3] = False
        elif pat == 5:
            v[:] = rng.rand(L) > 0.1
        elif pat == 6:
            v[:] = False
        elif pat > 6:
            e = {7: FT, 8: 32 * FF_ITEMS, 9: FF_ITEMS}[pat]
            if e < L:
                v[e - 1:e + 1] = False
            if L > 4:
                v[L - 3:L - 1] = False
    s = rng.uniform(-1, 1, valid.shape).astype(np.float32)
    seed = rng.uniform(-1, 1, len(valid)).astype(np.float32)
    return s, valid, seed, length


def _with_odd_bits(s):
    """``s`` with NaN payloads and -0.0 among its values (kernel 10
    moves values as bits)."""
    w = s.view(np.uint32).copy()
    w.reshape(-1)[::97] = 0x7fc01234
    w.reshape(-1)[5::89] = 0xff800001
    w.reshape(-1)[11::101] = 0x80000000
    return w.view(np.float32)


def _cells(rng, n, dtype, span):
    """n cells of ``dtype``: table indices (``span`` 'table'), or
    values far outside [0, 2048), negative ones included ('wide')."""
    if span == 'table':
        c = rng.randint(0, W.LEN, n)
    else:
        info = np.iinfo(dtype)
        c = rng.randint(info.min, info.max, n, dtype=np.int64)
    return c.astype(dtype)


def _check_taps(pil, cells):
    before = kernels.LAUNCHES['gather_taps']
    got = kernels.gather_taps(pil, cells)
    want = tdsp.gather_taps_plain(pil, cells)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['gather_taps'] == before + 1
    assert got.shape == (4, cells.numel()) and got.is_contiguous()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize('n', [1, 2, 3, 4, 5, 6, 7, 255, 4096, 65537,
                               1 << 20, (1 << 22) + 2])
@pytest.mark.parametrize('dtype', [np.int64, np.int32])
@pytest.mark.parametrize('span', ['table', 'wide'])
def test_gather_taps(cuda, n, dtype, span):
    """int64 (the main path's) and int32 cells, in the table and far
    outside it (negative, above 2047), at n of 1-7, n not a multiple
    of 4 and n = 2^20 (the main path's largest)."""
    rng = np.random.RandomState(n)
    for wave in (W.N_sin, W.N_saw, W.N_spa):
        pil = tdsp.wave_tables(cuda)[1][wave]
        _check_taps(pil, torch.from_numpy(_cells(rng, n, dtype, span))
                    .to(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [np.int64, np.int32])
def test_gather_taps_views(cuda, dtype):
    """Views that start at an odd element (cells not 16-byte aligned)
    and cells of other integer dtypes."""
    rng = np.random.RandomState(5)
    pil = tdsp.wave_tables(cuda)[1][W.N_sin]
    cells = torch.from_numpy(_cells(rng, 4 * 4096 + 9, dtype, 'wide'))
    cells = cells.to(cuda)
    for a, b in ((1, None), (3, -2), (1, 8), (2, 3)):
        _check_taps(pil, cells[a:b])
    _check_taps(pil, cells[::2])
    for other in (torch.int16, torch.uint8):
        _check_taps(pil, cells[:1001].to(other))


@pytest.mark.cuda
@pytest.mark.parametrize('n', [1, 2, 3, 1000, 1001, 65536, (1 << 22) + 1])
def test_is64(cuda, n):
    rng = np.random.RandomState(n + 1)
    for wave in range(len(W.WAVE_NAMES)):
        pil = tdsp.wave_tables(cuda)[1][wave]
        ph = torch.from_numpy(rng.randint(0, 1 << 32, n,
                                          dtype=np.int64)).to(cuda)
        got = kernels.is64(pil, ph)
        want = tdsp.is64_plain(pil, ph)
        torch.cuda.synchronize()
        assert got.dtype == torch.float64
        assert torch.equal(got.view(torch.int64), want.view(torch.int64))


@pytest.mark.cuda
def test_is64_views_and_high_bits(cuda):
    """int64 phases over the whole range (bits above 32, negative): only
    the low 32 bits count; views that start at an odd element (not
    16-byte aligned), odd lengths, a strided view."""
    rng = np.random.RandomState(17)
    pil = tdsp.wave_tables(cuda)[1][W.N_saw]
    x = torch.from_numpy(rng.randint(-(1 << 63), (1 << 63) - 1,
                                     65536 + 9, dtype=np.int64)).to(cuda)
    assert x[1:].data_ptr() % 16 != 0
    for v in (x, x[1:], x[3:-2], x[1:8], x[:7], x[::2]):
        got = kernels.is64(pil, v)
        want = tdsp.is64_plain(pil, v & M32)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int64), want.view(torch.int64))


def _ffill_plain(s, valid, seed, length):
    if length is None:
        return tdsp.last_valid_fill(s, valid, seed)
    return tdsp.forward_fill_valid_plain(s, valid, seed, length)


@pytest.mark.cuda
@pytest.mark.parametrize('with_length', [False, True],
                         ids=['fill', 'length'])
@pytest.mark.parametrize('V,L', [(1, 1), (3, 257), (4, 65536),
                                 (2, 1 << 18), (8, 1024), (16, 65536),
                                 (70000, 32)])
def test_ffill(cuda, V, L, with_length):
    """Kernel 10 against its plain version, with and without lengths
    (cycling over the edge cases), on values with NaN payloads and
    -0.0; (70000, 32) is more rows than a grid's y dimension holds."""
    rng = np.random.RandomState(V * 7 + L)
    s, valid, seed = _ffill_args(rng, V, L, cuda)
    s = torch.from_numpy(_with_odd_bits(s.cpu().numpy())).to(cuda)
    length = torch.from_numpy(_ffill_lengths(V, L)).to(cuda) \
        if with_length else None
    before = kernels.LAUNCHES['ffill']
    got = kernels.ffill(s, valid, seed, length)
    want = _ffill_plain(s, valid, seed, length)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['ffill'] == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize('L', [1, 5, FT - 1, FT, FT + 1, 2 * FT + 3,
                               4097, 65536])
def test_ffill_edges(cuda, L):
    """Kernel 10 at every length and mask edge of _ffill_edges, with
    and without lengths, and in a view whose rows are not 16-byte
    aligned (scalar loads and stores)."""
    s, valid, seed, length = (torch.from_numpy(a).to(cuda) for a in
                              _ffill_edges(np.random.RandomState(L), L))
    flat = torch.empty(s.numel() + 1, device=cuda)
    odd = flat[1:].view(s.shape)
    odd.copy_(s)
    assert odd.data_ptr() % 16 != 0
    for x in (s, odd):
        for ln in (None, length):
            got = kernels.ffill(x, valid, seed, ln)
            want = _ffill_plain(x, valid, seed, ln)
            torch.cuda.synchronize()
            assert torch.equal(got.view(torch.int32),
                               want.view(torch.int32)), (L, ln is None)


@pytest.mark.cuda
@pytest.mark.parametrize('L', [4097, 65536])
def test_forward_fill_valid_is_one_launch(cuda, L):
    """tdsp.forward_fill_valid on the card is one kernel 10 launch,
    equal to its plain version."""
    args = [torch.from_numpy(a).to(cuda) for a in
            _ffill_edges(np.random.RandomState(L + 1), L)]
    before = dict(kernels.LAUNCHES)
    got = tdsp.forward_fill_valid(*args)
    torch.cuda.synchronize()
    after = dict(before, ffill=before['ffill'] + 1)
    assert kernels.LAUNCHES == after
    want = tdsp.forward_fill_valid_plain(*args)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_ffill_refuses_other_dtypes():
    """Kernel 10 reads the callers' dtypes as they are and converts
    nothing: any other dtype raises ValueError (checked before the
    device)."""
    n, L = 2, 10
    good = [torch.zeros((n, L)), torch.ones((n, L), dtype=torch.bool),
            torch.zeros(n), torch.zeros(n, dtype=torch.int64)]
    for i, dt in ((0, torch.float64), (0, torch.int32), (1, torch.uint8),
                  (1, torch.int32), (2, torch.float64), (2, torch.int64),
                  (3, torch.int32), (3, torch.float32)):
        bad = list(good)
        bad[i] = good[i].to(dt)
        with pytest.raises(ValueError, match='must be'):
            kernels.ffill(*bad)
    with pytest.raises(ValueError, match='shape'):
        kernels.ffill(*good[:3], torch.zeros(n + 1, dtype=torch.int64))


@pytest.mark.cuda
@pytest.mark.parametrize('n', [1, 7, 2048, 2049, TILE - 1, TILE, TILE + 1,
                               3 * TILE + 1, 100000, (1 << 22) + 5,
                               (1 << 24) + 1])
def test_scan_max_i32(cuda, n):
    rng = np.random.RandomState(n + 2)
    x = rng.randint(0, 1 << 31, n).astype(np.int32)
    x[::3] = 0
    x[n // 2:n // 2 + 5] = 0x7fffffff
    xt = torch.from_numpy(x).to(cuda)
    got = kernels.scan_max_i32(xt)
    torch.cuda.synchronize()
    assert torch.equal(got, tdsp.scan_max_i32_plain(xt))
    assert torch.equal(got, torch.cummax(xt, 0).values)
    assert np.array_equal(got.cpu().numpy(), np.maximum.accumulate(x))


def _ramp_i32(n, low):
    """A rising ramp (the max changes in every tile); ``low`` < 0 adds
    negative values at the head and in runs."""
    rng = np.random.RandomState(n + 5)
    x = np.arange(n, dtype=np.int64) * 64 + rng.randint(low, 1000, n)
    for _ in range(6 if low < 0 else 0):
        a = rng.randint(0, n)
        x[a:a + rng.randint(1, 3 * TILE)] = -rng.randint(1, 1 << 31)
    return np.clip(x, -(1 << 31), (1 << 31) - 1).astype(np.int32)


def _check_max(x, xt, got):
    assert torch.equal(got, tdsp.scan_max_i32_plain(xt))
    assert np.array_equal(got.cpu().numpy(),
                          np.maximum.accumulate(np.maximum(x, 0)))


@pytest.mark.cuda
@pytest.mark.parametrize('n', [2, TILE - 1, TILE, TILE + 1, 3 * TILE + 1,
                               (1 << 24) + 1])
@pytest.mark.parametrize('low', [0, -100000])
def test_scan_max_i32_ramps(cuda, n, low):
    """Running maxima that change in every tile, with negative inputs
    (clamped to 0) where ``low`` < 0."""
    x = _ramp_i32(n, low)
    xt = torch.from_numpy(x).to(cuda)
    got = kernels.scan_max_i32(xt)
    torch.cuda.synchronize()
    _check_max(x, xt, got)
    if low == 0:
        assert torch.equal(got, torch.cummax(xt, 0).values)


@pytest.mark.cuda
def test_scan_max_i32_back_to_back_and_side_stream(cuda):
    xs = [_ramp_i32(n, -1000) for n in ((1 << 22) + 3, 2, 3 * TILE + 1,
                                        TILE, (1 << 20) + 7, 1)]
    xts = [torch.from_numpy(x).to(cuda) for x in xs]
    torch.cuda.synchronize()
    outs = [kernels.scan_max_i32(xt) for xt in xts]
    torch.cuda.synchronize()
    for x, xt, got in zip(xs, xts, outs):
        _check_max(x, xt, got)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = kernels.scan_max_i32(xts[2])
    torch.cuda.synchronize()
    _check_max(xs[2], xts[2], got)


@pytest.mark.cuda
def test_wosc_selfmod_saturates_as_plain(cuda):
    """Kernel 5's float -> int64 conversion of the feedback phase
    (__float2ll_rn) against the plain version's saturating ftoi on
    amounts whose product overflows int64, infinite and NaN."""
    rng = np.random.RandomState(11)
    pil = tdsp.wave_tables(cuda)[1][W.N_sin]
    ph, am, act, pp0, ps0, fb0 = _selfmod_args(rng, 8, 400, cuda)
    am = am.clone()
    specials = torch.tensor([1e19, -1e19, float('inf'), float('-inf'),
                             float('nan'), 2.0 ** 63, 3e38, -3e38],
                            device=cuda)
    am[:, ::5] = specials[:, None].expand(8, am[:, ::5].shape[1])
    fb0 = torch.full_like(fb0, 0.75)
    got = kernels.wosc_selfmod(pil, W.N_sin, ph, am, act, pp0, ps0, fb0)
    want = tdsp.wosc_selfmod_plain(pil, W.N_sin, ph, am, act, pp0, ps0,
                                   fb0)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))


def _render(script, device, plain=False, flat=True):
    g = TorchGenerator(stt.compile_script(script), 48000, device,
                       plain=plain, flat=flat)
    return g.assemble(g.render_device())


C1_SCRIPTS = ['Wsin f20000000000000 t.2',
              'Wsin t.2 f100.r20000000000000[Wsin f2]',
              'Wsin f100 t.2 p[Wsin f7 a.5] a.5 f[g20000000000000 t.2]']


@pytest.mark.cuda
@pytest.mark.parametrize('flat', [True, False], ids=['flat', 'seq'])
@pytest.mark.parametrize('script', C1_SCRIPTS)
def test_c1_kernel_path_equals_plain_path(cuda, script, flat):
    """The scripts whose frequencies overflow the int64 phase step
    (ROADMAP C1): kernel path = plain path = CPU."""
    got = _render(script, cuda, flat=flat)
    want = _render(script, cuda, plain=True, flat=flat)
    cpu = _render(script, 'cpu', flat=flat)
    assert np.array_equal(got, want) and np.array_equal(got, cpu)


@pytest.mark.cuda
@pytest.mark.parametrize('script,flat,launched', [
    ('Wsin f220 t.5 p[Wsin f50 /.3 r[g3 t.3]]', True,
     {'is64', 'ffill', 'scan_add_u32'}),
    (make_bank_script(8, seed=1, duration=0.3), False,
     {'gather_taps', 'ffill', 'scan_add_u32'}),
    ('Nre t.2 a.4 ; Ngw t.1', False, {'scan_add_u32'}),
    ('Rcos t.2 f80.r160[Wsin f2] a.7', False,
     {'is64', 'ffill', 'scan_add_u32', 'scan_add_u64'}),
    ('Wsin f110 t.05 p.a.3', False, {'wosc_selfmod', 'scan_add_u32'}),
    ('Rcos mf f60 p.a.5[Rlin f7 a.4] a.6 t.05', False,
     {'rasg_selfmod', 'scan_add_u64'}),
])
def test_seq_kernel_path_equals_plain_path(cuda, script, flat, launched):
    kernels.reset_launches()
    got = _render(script, cuda, flat=flat)
    assert {k for k, n in kernels.LAUNCHES.items() if n} >= launched
    want = _render(script, cuda, plain=True, flat=flat)
    cpu = _render(script, 'cpu', flat=flat)
    assert np.array_equal(got, want) and np.array_equal(got, cpu)


@pytest.mark.cuda
def test_row_fill_runs_kernel_4(cuda):
    kernels.reset_launches()
    stt.render('Wsin f220 t.3', srate=48000, device=cuda)
    assert kernels.LAUNCHES['scan_max_i32'] > 0


@pytest.mark.cuda
def test_seq_runs_no_plain_version_on_cuda(cuda, monkeypatch):
    """The sequential engine on the card launches its kernels and never
    calls their plain versions."""
    def refuse(*_a, **_k):
        raise AssertionError('plain version on a CUDA render')

    for name in ('prefix_sum_plain', 'prefix_sum_u64_plain',
                 'prefix_sum_rows_plain', 'gather_taps_plain',
                 'is64_plain', 'last_valid_fill',
                 'forward_fill_valid_plain', 'scan_max_i32_plain',
                 'wosc_s_filled_plain', 'wosc_selfmod_plain',
                 'rasg_selfmod_plain'):
        monkeypatch.setattr(tdsp, name, refuse)
    kernels.reset_launches()
    for script in (make_bank_script(4, seed=3, duration=0.2),
                   'Wsin f220 t.5 p[Wsin f50 /.3 r[g3 t.3]]',
                   'Nre t.1 | Rcos t.1 f80.r160[Wsin f2]'):
        _render(script, cuda, flat=False)
    assert all(kernels.LAUNCHES[k] > 0 for k in
               ('gather_taps', 'is64', 'ffill', 'scan_add_u32',
                'scan_add_u64'))
