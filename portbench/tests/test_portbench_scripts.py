"""The seeded script writer: the same seed gives the same programs,
every seed the same sizes, and the port's front end reads them."""
import pytest

from harness import cells, scripts

SEEDS = [0, 1, 2 ** 31 + 5, 2 ** 40 + 3, -7]


@pytest.mark.parametrize('config', ['pm_voices', 'selfpm_voices'])
@pytest.mark.parametrize('seed', SEEDS)
def test_deterministic_per_seed(config, seed):
    conf = cells.config(config)
    traf = dict(cells.traffic('bank1024.slab'), voices=16)
    a = scripts.write(conf, traf, seed)
    b = scripts.write(conf, traf, seed)
    assert a == b
    assert len(a) == traf['programs']
    assert a[0]['text'] != a[1]['text']
    other = scripts.write(conf, traf, seed + 1)
    assert other[0]['text'] != a[0]['text']
    for p in a:
        lines = p['text'].splitlines()
        assert len(lines) == 1 + 16
        assert lines[0] == 'S a.m0.062'
        assert len(p['bank']['voices']) == 16
        assert all(v['time'] == '1.000' for v in p['bank']['voices'])


@pytest.mark.parametrize('config', ['pm_voices', 'selfpm_voices'])
def test_distributions(config):
    conf = cells.config(config)
    traf = dict(cells.traffic('bank1024.slab'), voices=256)
    voices = [v for p in scripts.write(conf, traf, 3) for v in
              p['bank']['voices']]
    pans = [float(v['pan']) for v in voices]
    assert -1.0 <= min(pans) < -0.5 and 0.5 < max(pans) <= 1.0
    f = sorted({float(v['freq']) for v in voices})
    if config == 'pm_voices':
        # the carrier's notes of the example's first voice
        assert set(f) == set(range(100, 601, 50))
        assert {(v['mod_freq'], v['mod_amp'], v['mod2_freq'],
                 v['mod2_amp']) for v in voices} == {('3.33', '1', '1.33',
                                                      '1')}
    else:
        freq = conf['params']['freq']['pitch']
        assert f[0] >= freq['base_hz'] - 0.01
        assert f[-1] <= freq['base_hz'] * 4 + 0.01 and len(f) > 20
        assert {(v['mod_freq'], v['mod_amp'], v['am_freq'], v['am_amp'])
                for v in voices} == {('3.14', '0.25', '1', '0.5')}


@pytest.mark.parametrize('config', ['pm_voices', 'selfpm_voices'])
def test_the_port_reads_them(config):
    import saugns_tpu_torch as stt
    conf = cells.config(config)
    traf = dict(cells.traffic('bank1024.slab'), voices=12)
    for p in scripts.write(conf, traf, 9):
        prg = stt.compile_script(p['text'])
        assert prg.vo_count == 12
