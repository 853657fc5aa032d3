"""The RasG reference of the ``rasg_feedback`` configuration
(``portbench/reference/rasg_feedback.py``, hearty_rumble.sau's voice)
against the port's CPU plain path on tiny banks, its control against
the configuration's limits, and what it imports."""
import json
import os

import numpy as np
import pytest

from conftest import BASE, TINY_SECONDS, tiny_root
from harness import cells, check, scripts
from reference import sau
import control

CONFIG = 'rasg_feedback'


def tiny_programs(seed, voices=6):
    conf = cells.config(CONFIG)
    traf = dict(cells.traffic('bank1024.slab'), voices=voices,
                duration_s=TINY_SECONDS)
    return conf, scripts.write(conf, traf, seed)


@pytest.mark.parametrize('seed', [1, 2, 2 ** 31 + 3])
def test_reference_agrees_with_the_plain_path(seed):
    import saugns_tpu_torch as stt
    from saugns_tpu_torch.render.engine import TorchGenerator
    conf, progs = tiny_programs(seed)
    refs = sau.render([p['bank'] for p in progs], conf['srate'])
    for p, ref in zip(progs, refs):
        gen = TorchGenerator(stt.compile_script(p['text']), conf['srate'],
                             device='cpu', plain=True)
        out = gen.assemble(gen.render_device())
        assert out.shape == ref.shape == (4800, 2)
        nums = check.numbers(out, ref)
        # the carriers agree (banks of one and of two voices are
        # byte-equal, below); the mix may round 1 LSB apart in a few
        # values, as in the sibling configurations: the reference scales
        # a voice by its amplitude, then by 0.5 * a.m (sau.py), where the
        # program multiplies the amplitude by a.m first (ROADMAP C1)
        assert nums['max_gap_lsb'] <= 1
        assert nums['differ_share'] < 0.5, nums


@pytest.mark.parametrize('seed', [3, 2 ** 40 + 1])
def test_one_and_two_voices_byte_equal(seed):
    import saugns_tpu_torch as stt
    from saugns_tpu_torch.render.engine import TorchGenerator
    for voices in (1, 2):
        conf, progs = tiny_programs(seed, voices)
        ref = sau.render([progs[0]['bank']], conf['srate'])[0]
        gen = TorchGenerator(stt.compile_script(progs[0]['text']),
                             conf['srate'], device='cpu', plain=True)
        assert gen.assemble(gen.render_device()).tobytes() == ref.tobytes()


def test_the_float32_control_fails_the_limits(tmp_path):
    """The control, its wave oscillators interpolating in float32 and
    each cyclor's count a float32 running sum, read on 64 voices of
    0.05 s: it fails the limits on at least one number on each seed (on
    the card it is read at the cell's size, control.py; PERF.md section
    2)."""
    root = tiny_root(str(tmp_path))
    base = os.path.join(root, 'portbench')
    traf = dict(cells.traffic('bank1024.slab', base), voices=64,
                duration_s=TINY_SECONDS)
    with open(os.path.join(base, 'traffic', 'c64.json'), 'w') as f:
        json.dump(traf, f)
    bench = cells.benchmark(root)
    bench['workloads'].append({'name': CONFIG + '.c64', 'config': CONFIG,
                               'traffic': 'c64', 'chips': 1, 'why': 't'})
    lim = cells.limits(CONFIG, base)
    res = control.readings(bench, CONFIG + '.c64', [1, 2, 3], base=base)
    for r in res:
        assert any(r['numbers'][k] > lim[k] for k in lim), r


def test_the_control_cyclor_drifts():
    """The control's counts start where the u64 counter's do and drift
    from them as its float32 sum rounds."""
    from reference import rasg_feedback as rf
    seeds = rf.default_seeds(2)
    freq = np.float32([50.0, 199.99])
    a = rf.counts(seeds, freq, 96000, 96000, False)
    b = rf.counts(seeds, freq, 96000, 96000, True)
    assert a.dtype == b.dtype == np.uint64 and a.shape == (2, 96000)
    assert np.array_equal(a[:, :2], b[:, :2])
    assert not np.array_equal(a[:, -100:], b[:, -100:])


def test_default_seeds_are_the_script_prngs():
    """The first draws of SplitMix32 from 0 (sau/math.h:329-334), as
    the C's own arithmetic gives them."""
    from reference import rasg_feedback as rf
    st, want = 0, []
    for _ in range(4):
        st = (st + 0x9e3779b9) % 2 ** 32
        z = st
        for sh, mul in ((16, 0x21f0aaad), (15, 0xf35a2d97)):
            z = ((z ^ (z >> sh)) * mul) % 2 ** 32
        want.append(z ^ (z >> 15))
    assert rf.default_seeds(4) == want
    assert len(set(rf.default_seeds(2048))) == 2048


def test_default_seeds_are_the_front_ends():
    """Voice k's R takes the draw k + 1: the front end's seeds of a
    three-voice program, in parse order."""
    import saugns_tpu_torch as stt
    from saugns_tpu_torch.lang import program as P
    from reference import rasg_feedback as rf
    conf, progs = tiny_programs(9, voices=3)
    prg = stt.compile_script(progs[0]['text'])
    got = [od.seed for ev in prg.events for od in ev.op_data
           if od.type == P.POPT_RASEG]
    assert got == rf.default_seeds(3)


def test_noise():
    from reference import rasg_feedback as rf
    for n in (0, 1, 12345, 2 ** 32 - 1):
        s = n * 0x9e3779b9 % 2 ** 32
        s ^= s >> 14
        s = (s | 1) * s % 2 ** 32
        s ^= s >> 13
        assert int(rf.ranfast32(np.uint32([n]))[0]) == s


def test_the_reference_imports_no_package_of_the_repo_nor_jax():
    """Its imports are numpy alone, beside the reference's own sau.py:
    no JAX and nothing of either package."""
    from test_portbench_imports import modules
    path = os.path.join(BASE, 'reference', 'rasg_feedback.py')
    assert set(modules(path)) == {'__future__', 'numpy'}
