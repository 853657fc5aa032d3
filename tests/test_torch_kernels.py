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
from saugns_tpu_torch.parallel.voicebank import make_bank_script
from saugns_tpu_torch.render import tdsp

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


@pytest.mark.cuda
@pytest.mark.parametrize('n', [1, 1023, 2048, 2049, 96000, (1 << 22) + 3])
@pytest.mark.parametrize('fill', ['random', 'ones'])
def test_scan_add_u32(cuda, n, fill):
    rng = np.random.RandomState(n)
    x = rng.randint(0, 1 << 32, n, dtype=np.int64) if fill == 'random' \
        else np.full(n, M32, np.int64)
    xt = torch.from_numpy(x).to(cuda)
    before = kernels.LAUNCHES['scan_add_u32']
    got = kernels.scan_add_u32(xt)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['scan_add_u32'] == before + 1
    assert torch.equal(got, tdsp.prefix_sum_plain(xt))
    assert np.array_equal(got.cpu().numpy(), np.cumsum(x) & M32)


@pytest.mark.cuda
@pytest.mark.parametrize('n', [1, 2047, 2049, 131072, (1 << 22) + 3])
@pytest.mark.parametrize('fill', ['random', 'ones'])
def test_scan_add_u64(cuda, n, fill):
    rng = np.random.RandomState(n)
    x = rng.randint(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64) \
        if fill == 'random' else np.full(n, -1, np.int64)
    xt = torch.from_numpy(x).to(cuda)
    before = kernels.LAUNCHES['scan_add_u64']
    got = kernels.scan_add_u64(xt)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['scan_add_u64'] == before + 1
    assert torch.equal(got, tdsp.prefix_sum_u64_plain(xt))
    want = np.cumsum(x.view(np.uint64)).view(np.int64)
    assert np.array_equal(got.cpu().numpy(), want)


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


@pytest.mark.cuda
@pytest.mark.parametrize('V,L', [(1, 1), (1, 255), (1, 96000), (3, 70001),
                                 (2, 1 << 19)])
@pytest.mark.parametrize('wave', [W.N_sin, W.N_sqr, W.N_saw])
def test_wosc_fill(cuda, V, L, wave):
    rng = np.random.RandomState(V * 1000 + L + wave)
    args = _fill_args(rng, V, L, wave, cuda)
    got = kernels.wosc_fill(*args)
    want = tdsp.wosc_s_filled_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize('script,launched', [
    ('Wsin', {'wosc_fill'}),
    ('Wsqr t.4 f80.r160[Wsin f2] a.7', {'wosc_fill', 'scan_add_u32'}),
    ('Wsin f600 t.3 p[Wsin r1.5] ; f500 t.3', {'wosc_fill'}),
    ('Wsin t.4 f100 | Wtri t.3 f220', {'wosc_fill'}),
    (make_bank_script(16, seed=1, duration=0.3), {'wosc_fill'}),
    ('Nre t.2 a.4 ; Ngw t.1', {'scan_add_u32'}),
    ('Rlin mb t.2 f300 a.5', set()),
    ('Rcos t.2 f80.r160[Wsin f2] a.7', {'wosc_fill', 'scan_add_u64'}),
    ('Wsin f110 t.05 p.a.3', {'wosc_selfmod'}),
    ('Rcos mf f60 p.a.5[Rlin f7 a.4] a.6 t.05', {'rasg_selfmod'}),
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
                 'rasg_selfmod_plain'):
        monkeypatch.setattr(tdsp, name, refuse)
    kernels.reset_launches()
    got = stt.render('Wsin f220 t.3 ; Rlin f300 t.2', srate=48000,
                     device=cuda)
    assert kernels.LAUNCHES['wosc_fill'] > 0 and got.shape == (28800, 2)
