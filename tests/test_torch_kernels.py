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


def test_cpu_tensors_take_the_plain_version():
    before = dict(kernels.LAUNCHES)
    x = torch.arange(10, dtype=torch.int64)
    assert torch.equal(tdsp.prefix_sum(x), tdsp.prefix_sum_plain(x))
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
@pytest.mark.parametrize('script', [
    'Wsin',
    'Wsqr t.4 f80.r160[Wsin f2] a.7',
    'Wsin f600 t.3 p[Wsin r1.5] ; f500 t.3',
    'Wsin t.4 f100 | Wtri t.3 f220',
    make_bank_script(16, seed=1, duration=0.3),
])
def test_kernel_path_equals_plain_path(cuda, script):
    kernels.reset_launches()
    got = stt.render(script, srate=48000, device=cuda)
    assert kernels.LAUNCHES['wosc_fill'] > 0
    want = stt.render(script, srate=48000, device=cuda, plain=True)
    cpu = stt.render(script, srate=48000, device='cpu')
    assert np.array_equal(got, want) and np.array_equal(got, cpu)
