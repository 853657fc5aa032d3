"""The plain reference against the port's CPU plain path
(``device='cpu', plain=True``) on tiny banks of each configuration, and
the comparison's numbers."""
import numpy as np
import pytest

from conftest import TINY_SECONDS
from harness import cells, check, scripts
from reference import sau


def tiny_programs(config, seed, voices=6):
    conf = cells.config(config)
    traf = dict(cells.traffic('bank1024.slab'), voices=voices,
                duration_s=TINY_SECONDS)
    return conf, scripts.write(conf, traf, seed)


@pytest.mark.parametrize('config', ['pm_voices', 'selfpm_voices'])
@pytest.mark.parametrize('seed', [1, 2, 2 ** 31 + 3])
def test_reference_agrees_with_the_plain_path(config, seed):
    import saugns_tpu_torch as stt
    from saugns_tpu_torch.render.engine import TorchGenerator
    conf, progs = tiny_programs(config, seed)
    refs = sau.render([p['bank'] for p in progs], conf['srate'])
    for p, ref in zip(progs, refs):
        gen = TorchGenerator(stt.compile_script(p['text']), conf['srate'],
                             device='cpu', plain=True)
        out = gen.assemble(gen.render_device())
        assert out.shape == ref.shape == (4800, 2)
        nums = check.numbers(out, ref)
        # the port follows the JAX package's flat path, 1 LSB off the
        # host renderer in a few values (ROADMAP C1); six voices, each
        # 1/6 of the mix, flip more values than the cells' 1,024
        assert nums['max_gap_lsb'] <= 1
        assert nums['differ_share'] < 0.5, nums


def test_hermite_tables_match_the_direct_form():
    """The coefficient tables give the C's per-sample Hermite form."""
    lut = sau.sine_table()
    coef = sau.herp_coeffs(lut)
    ph = np.random.default_rng(0).integers(0, 2 ** 32, 4096)
    ind = ph >> sau.SLENBITS
    s0, s1 = lut[(ind - 1) & sau.LENMASK], lut[ind & sau.LENMASK]
    s2, s3 = lut[(ind + 1) & sau.LENMASK], lut[(ind + 2) & sau.LENMASK]
    x = (ph & sau.SLENMASK).astype(np.float64) * np.float64(
        np.float32(1.0 / sau.SLEN))
    c0 = s1.astype(np.float64)
    c1 = 0.5 * (s2 - s0).astype(np.float64)
    c2 = (s0.astype(np.float64) - 2.5 * s1.astype(np.float64)
          + (np.float32(2.0) * s2).astype(np.float64)
          - 0.5 * s3.astype(np.float64))
    c3 = 0.5 * (s3 - s0).astype(np.float64) + 1.5 * (s1 - s2).astype(
        np.float64)
    direct = ((c3 * x + c2) * x + c1) * x + c0
    assert np.array_equal(sau.herp(coef, ph), direct)


def test_numbers():
    ref = np.zeros((100, 2), np.int16)
    a = ref.copy()
    a[3, 1] = 2
    n = check.numbers(a, ref)
    assert n['differ_share'] == pytest.approx(0.5)
    assert n['rms_lsb'] == pytest.approx(np.sqrt(4 / 200))
    assert n['max_gap_lsb'] == 2
    assert check.numbers(a[:50], ref)['rms_lsb'] == np.inf
    w = check.worst([(0, ref), (0, a), (1, ref)], [ref, ref])
    assert w['max_gap_lsb'] == 2


def test_number_reading():
    assert sau.number('123.47') == np.float32(123.0 + 47 / 100.0)
    assert sau.number('-0.395') == -np.float32(0.395)
    assert sau.time_samples('1.000', 96000) == 96000
    assert sau.time_samples('0.050', 96000) == 4800
