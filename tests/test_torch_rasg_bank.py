"""Banks of random-segment voices with a phase-modulation chain (``R
f<f> ... p[Wsin f1.5.r0[Wsin f0.07] a12.5.r0[Wsin f0.07]]``, the voice
of saugns' hearty_rumble.sau and of the benchmark's ``rasg_feedback``
configuration) on the port's bank path, on the CPU: ``BankRender``
renders them as a uniform bank of slab rows although each voice's R
takes its own default seed, and its int16 output equals the JAX
package's ``BankRender`` (the reference) byte for byte, and the port's
plain ``TorchGenerator`` path too. At 96 kHz, six voices of 0.05 s.
Tolerance: byte-equality of the int16 output."""
import numpy as np
import pytest

import jax

jax.config.update('jax_platforms', 'cpu')

from saugns_tpu.lang.program import (ScriptArg as JArg,  # noqa: E402
                                     build_program as jbuild)
from saugns_tpu.parallel import voicebank as jbank  # noqa: E402
import saugns_tpu_torch as stt  # noqa: E402
from saugns_tpu_torch.lang import program as P  # noqa: E402
from saugns_tpu_torch.parallel.voicebank import BankRender  # noqa: E402
from saugns_tpu_torch.render.engine import TorchGenerator  # noqa: E402
from tests.torch_jaxref import ensure_native_tables  # noqa: E402


@pytest.fixture(autouse=True, scope='module')
def _jax_native_tables():
    """The JAX package renders with its native wave tables, also on a
    cold build cache (tests/torch_jaxref.py)."""
    ensure_native_tables()


SRATE = 96000
BUDGET = 'SAUGNS_TPU_BANK_SLAB_BUDGET'
SEEDS = [1, 2, 2 ** 31 + 3]


def rasg_bank(n, seed, duration=0.05):
    """An n-voice bank of the voice, pitch (50 Hz x 2^(k/12), k 0-24)
    and pan drawn from ``seed``, no R given a seed."""
    rng = np.random.default_rng(seed)
    lines = ['S a.m%.3f' % (1.0 / n)]
    for _ in range(n):
        lines.append('R f%.2f t%.3f a1 c%.3f p[Wsin f1.5.r0[Wsin f0.07] '
                     'a12.5.r0[Wsin f0.07]]'
                     % (50.0 * 2.0 ** (int(rng.integers(0, 25)) / 12.0),
                        duration, rng.uniform(-1.0, 1.0)))
    return '\n'.join(lines) + '\n'


def r_seeds(prg):
    """The seed of each R operator of ``prg``, by operator id."""
    return {od.id: od.seed for ev in prg.events for od in ev.op_data
            if od.type == P.POPT_RASEG}


def two_slabs(monkeypatch, prg):
    """A slab budget of three voices: the six voices render as two
    slabs of three rows."""
    spv = BankRender(prg, SRATE, device='cpu').samples_per_voice()
    monkeypatch.setenv(BUDGET, str(3 * spv))


@pytest.mark.parametrize('seed', SEEDS)
def test_bank_equals_the_jax_voicebank(monkeypatch, seed):
    """Two slabs of three voice rows: int16 byte-equal to the JAX
    package's BankRender of the same script (one device, ordered
    mix)."""
    src = rasg_bank(6, seed)
    prg = stt.compile_script(src)
    two_slabs(monkeypatch, prg)
    br = BankRender(prg, SRATE, device='cpu')
    assert len(br.prepare()[0].slabs) == 2
    got = br.render_i16().numpy()
    jb = jbank.BankRender(jbuild(JArg(str=src, is_path=False, no_time=True,
                                      predef=[])), SRATE, mesh=None,
                          ordered_mix=True)
    want = np.asarray(jb.render_i16())
    assert got.shape == want.shape == (4800, 2)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize('seed', SEEDS)
def test_bank_equals_the_plain_generator(monkeypatch, seed):
    """The same two slabs: int16 byte-equal to the plain
    one-voice-at-a-time path."""
    prg = stt.compile_script(rasg_bank(6, seed))
    two_slabs(monkeypatch, prg)
    got = BankRender(prg, SRATE, device='cpu').render_i16().numpy()
    gen = TorchGenerator(prg, SRATE, device='cpu', plain=True)
    want = gen.assemble(gen.render_device())
    assert got.shape == want.shape == (4800, 2)
    assert got.tobytes() == want.tobytes()


def test_default_seeds_differ_and_the_bank_is_uniform():
    """Each R takes the front end's next default seed, so no two voices
    share one; the bank's schedule is uniform all the same, and its
    six voices render as one slab of six rows."""
    prg = stt.compile_script(rasg_bank(6, 4))
    seeds = r_seeds(prg)
    assert len(seeds) == 6 and len(set(seeds.values())) == 6
    # (BankRender raises ValueError for a bank that is not uniform)
    br = BankRender(prg, SRATE, device='cpu')
    assert br.n_voices == 6
    assert [len(sh.slabs) for sh in br.prepare()] == [1]
    assert br.prepare()[0].slabs[0].V == 6
