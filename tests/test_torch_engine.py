"""The port's renderer end to end on the CPU against JaxGenerator on the
CPU platform, with the wave tables and the initial state carried across
by saugns_tpu_torch.convert. Tolerance: byte-equality of the int16
output, except the golden-file check, which holds Wsin to >= 90 dB
(the repo's fidelity gate for that file)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

jax.config.update('jax_platforms', 'cpu')

from saugns_tpu.lang.program import (ScriptArg as JArg,  # noqa: E402
                                     build_program as jbuild)
from saugns_tpu.render import engine as jeng  # noqa: E402
from saugns_tpu.render import jdsp  # noqa: E402
from saugns_tpu.parallel.voicebank import \
    make_bank_script as jbank  # noqa: E402
import saugns_tpu_torch as stt  # noqa: E402
from saugns_tpu_torch import convert  # noqa: E402
from saugns_tpu_torch.lang.program import (ScriptArg as TArg,  # noqa: E402
                                           build_program as tbuild)
from saugns_tpu_torch.parallel.voicebank import \
    make_bank_script  # noqa: E402
from saugns_tpu_torch.render.engine import TorchGenerator  # noqa: E402
from saugns_tpu_torch.render.plan import KIND_NAMES  # noqa: E402
from tests.torch_jaxref import ensure_native_tables  # noqa: E402


@pytest.fixture(autouse=True, scope='module')
def _jax_native_tables():
    """The JAX package renders with its native wave tables, also on a
    cold build cache (tests/torch_jaxref.py)."""
    ensure_native_tables()


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FLAGSHIP_SCRIPT = (
    "Wsin t1 f500.r501[Wsin f1] p[Wsin f400.r800[Wsqr f1.r10[Wsin f50]]]"
    " a.8 c[Wsin f.5]"
)

# the slice: the wave-only scripts of test_engine.SCRIPTS, the
# flagship, and sweeps over every line shape
SCRIPTS = [
    'Wsin',
    'Wsin f600 t.3 p[Wsin r1.5] ; f500 t.3',
    'Wsqr t.4 f80.r160[Wsin f2] a.7',
    'Wsin t.3 f200 c[Wsin f3 a.5]',
    'Wsin t.4 f100 | Wtri t.3 f220',
    FLAGSHIP_SCRIPT,
    'Wsin t1 f200 f[g800 t.5 lexp] a[v.1 g1 t.4 lsmo]',
    'Wtri t1 f300 f[g100 t.7 lcos] c[v-1 g1 t1 lcub]',
    'Wsaw t.6 f[v100 g900 t.3 lncl] a[g.2 t.5 lsqe]',
    'Wsqr t.5 f[v50 g400 t.5 luwh] ; f[g60 t.2 lnhl] ; '
    'f[g300 t.3 llog] a[g.1 t.3 lxpe]',
    'Wsin t.8 f220 p[Wsin r2 a[g0 t.8 llge]] a[g.3 t.2 lsah]',
    "S a.5\nWpar f100 t.3 a[Wsin f5] /0.1 Wspa f300 t.2 c.5",
]


def _pull(gen, stereo):
    ch = 2 if stereo else 1
    buf = np.zeros(4096 * ch, np.int16)
    out = []
    while True:
        more, n = gen.run(buf, 4096, stereo)
        out.append(buf[:n * ch].copy())
        if not more:
            break
    return np.concatenate(out)


def render_pair(script, srate, stereo):
    """(JaxGenerator output, port output) for ``script``, the port fed
    the JAX package's tables and initial state."""
    jp = jbuild(JArg(str=script, is_path=False, no_time=True, predef=[]))
    tp = tbuild(TArg(str=script, is_path=False, no_time=True, predef=[]))
    jg = jeng.JaxGenerator(jp, srate)
    _, piluts = convert.tables(*jdsp.get_tables(), 'cpu')
    st0 = convert.state(jeng.make_state(jg.plan), 'cpu')
    tg = TorchGenerator(tp, srate, 'cpu', piluts=piluts, state=st0)
    for k, v in jg.plan.rec_arrays.items():
        assert np.array_equal(tg.plan.rec_arrays[k],
                              convert.records(jg.plan.rec_arrays)[k]), k
    return _pull(jg, stereo), _pull(tg, stereo)


@pytest.mark.parametrize('stereo', [True, False], ids=['stereo', 'mono'])
@pytest.mark.parametrize('script', SCRIPTS)
def test_script_byte_equal(script, stereo):
    want, got = render_pair(script, 6000, stereo)
    assert len(got) == len(want) and len(got) > 0
    assert np.array_equal(got, want), int(np.sum(got != want))


@pytest.mark.parametrize('stereo', [True, False], ids=['stereo', 'mono'])
def test_voice_bank_byte_equal(stereo):
    src = make_bank_script(8, seed=0, duration=0.5)
    assert src == jbank(8, seed=0, duration=0.5)
    want, got = render_pair(src, 6000, stereo)
    assert len(got) == (3000 * 2 if stereo else 3000)
    assert np.array_equal(got, want), int(np.sum(got != want))


def test_wsin_96k_golden_and_byte_equal():
    g = np.load(os.path.join(ROOT, 'tests', 'golden', 'wav',
                             'wsin_96k.npz'))
    want, got = render_pair('Wsin', 96000, True)
    assert np.array_equal(got, want)
    ref = g['data'].astype(np.float64)
    assert len(got) == len(ref)
    err = got.astype(np.float64) - ref
    snr = 10 * np.log10((ref ** 2).sum() / max((err ** 2).sum(), 1e-30))
    assert snr >= 90.0, snr


def test_api_render_matches_generator():
    a = stt.render('Wsin t.2 f330', srate=6000, device='cpu')
    b = stt.render('Wsin t.2 f330', srate=6000, device='cpu', plain=True)
    assert a.shape == (1200, 2) and a.dtype == np.int16
    assert np.array_equal(a, b)
    want, _ = render_pair('Wsin t.2 f330', 6000, True)
    assert np.array_equal(a.reshape(-1), want)


@pytest.mark.parametrize('script,kind', [
    ('Ntw t.3 a.4', 'NOISE'),
    ('Rlin t.4 f300 a.5', 'RCYCLE'),
    ('Wsin f110 t.5 p.a.3', 'WRUN_SELF'),
    # a ratio goal on an absolute frequency against a live multiplier
    # (the pattern of pm_smoothchange.sau): HostSim cannot bake it, so
    # its epoch renders on the sequential-scan engine
    ('Wsin f220 t1 p[Wsin f50 /.3 r[g3 t.3]]', None),
])
def test_outside_slice_raises(script, kind, tmp_path):
    """The stage kinds the first slice left out (noise, RasG, self-PM)
    render byte-equal now, and so does an epoch that needs the
    sequential engine: nothing raises NotImplementedError any more.
    The last case renders stereo and mono, and through write_wav."""
    tp = tbuild(TArg(str=script, is_path=False, no_time=True, predef=[]))
    g = TorchGenerator(tp, 6000, 'cpu')
    if kind is not None:
        assert KIND_NAMES.index(kind) in {
            st.kind for ep in g.plan.epochs for st in ep.stages}
        want, got = render_pair(script, 6000, True)
        assert len(got) > 0 and np.array_equal(got, want)
        return
    assert [g.sequential(ei) for ei in range(len(g.plan.epochs))] \
        == [True]
    for stereo in (True, False):
        want, got = render_pair(script, 6000, stereo)
        assert len(got) == (6000 * 2 if stereo else 6000)
        assert np.array_equal(got, want), int(np.sum(got != want))
    out = tmp_path / 'x.wav'
    stt.write_wav(str(out), script, srate=6000, device='cpu')
    assert out.stat().st_size == 44 + 6000 * 4


# frequencies whose phase step overflows int64: the reference converts
# them with saturation (ROADMAP C1)
C1_SCRIPTS = ['Wsin f20000000000000 t.2',
              'Wsin t.2 f100.r20000000000000[Wsin f2]',
              'Wsin f100 t.2 p[Wsin f7 a.5] a.5 f[g20000000000000 t.2]']


@pytest.mark.parametrize('stereo', [True, False], ids=['stereo', 'mono'])
@pytest.mark.parametrize('script', C1_SCRIPTS)
def test_c1_overflowing_frequency_byte_equal(script, stereo):
    want, got = render_pair(script, 6000, stereo)
    assert len(got) == (1200 * 2 if stereo else 1200)
    assert np.array_equal(got, want), int(np.sum(got != want))


def test_no_cuda_raises_and_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    out = tmp_path / 'x.wav'
    with pytest.raises(RuntimeError, match='CUDA'):
        stt.write_wav(str(out), 'Wsin', srate=6000)
    with pytest.raises(RuntimeError, match='CUDA'):
        stt.render('Wsin', srate=6000)
    assert not out.exists()


def _run_cli(module, args, env_extra, cwd):
    env = dict(os.environ)
    env['PYTHONPATH'] = ROOT
    env.update(env_extra)
    return subprocess.run([sys.executable, '-m', module] + args,
                          capture_output=True, env=env, cwd=cwd,
                          timeout=300)


@pytest.mark.parametrize('flags', [['-m'], ['-m', '--mono']],
                         ids=['stereo', 'mono'])
def test_cli_wav_byte_identical(flags, tmp_path):
    a, b = tmp_path / 'port.wav', tmp_path / 'jax.wav'
    args = ['-d', '-r6000'] + flags + ['-o']
    r = _run_cli('saugns_tpu_torch.cli', args + [str(a), '-e', 'Wsin'],
                 {'SAUGNS_TPU_TORCH_DEVICE': 'cpu'}, tmp_path)
    assert r.returncode == 0, r.stderr
    r = _run_cli('saugns_tpu.cli', args + [str(b), '-e', 'Wsin'],
                 {'SAUGNS_TPU_BACKEND': 'cpu'}, tmp_path)
    assert r.returncode == 0, r.stderr
    assert a.read_bytes() == b.read_bytes()


def test_cli_stdout_byte_identical(tmp_path):
    args = ['-d', '-r6000', '-m', '--stdout', '-e', 'Wsin t.2 f300']
    r1 = _run_cli('saugns_tpu_torch.cli', args,
                  {'SAUGNS_TPU_TORCH_DEVICE': 'cpu'}, tmp_path)
    r2 = _run_cli('saugns_tpu.cli', args, {'SAUGNS_TPU_BACKEND': 'cpu'},
                  tmp_path)
    assert r1.returncode == r2.returncode == 0
    assert len(r1.stdout) == 1200 * 4 and r1.stdout == r2.stdout


def test_cli_without_cuda_fails_cleanly(tmp_path):
    out = tmp_path / 'x.wav'
    r = _run_cli('saugns_tpu_torch.cli',
                 ['-d', '-r6000', '-m', '-o', str(out), '-e', 'Wsin'],
                 {'CUDA_VISIBLE_DEVICES': ''}, tmp_path)
    assert r.returncode == 1
    assert b'CUDA' in r.stderr and b'Traceback' not in r.stderr
    assert not out.exists()


@pytest.mark.parametrize('script', [
    FLAGSHIP_SCRIPT.replace('t1 ', 't25 '),
    'Wsin f600 t12 p[Wsin r1.5] ; f500 t12',
    'Wsin t25 f200 f[g800 t20 lexp] a[v.1 g1 t14 lsmo] c[Wsin f.2]',
])
def test_many_chunks_byte_equal(script, monkeypatch):
    """One block per chunk and two chunks per group (25 s at 6 kHz is
    three 65,536-sample blocks): every carry (phase, previous phase and
    sample, pending reset) crosses chunk and group boundaries, and the
    last group is padded with an inert chunk; the output must not
    change."""
    from saugns_tpu_torch.render import flat as tflat
    monkeypatch.setattr(tflat, 'FLAT_CHUNK', 1)
    monkeypatch.setattr(tflat, 'STREAM_GROUP', 2)
    want, got = render_pair(script, 6000, True)
    assert np.array_equal(got, want), int(np.sum(got != want))
    tp = tbuild(TArg(str=script, is_path=False, no_time=True, predef=[]))
    g = TorchGenerator(tp, 6000, 'cpu')
    segs = [s for ei in range(len(g.plan.epochs))
            for s in g._flat_epoch(ei)]
    assert max(s.nch for s in segs) >= 3 and max(s.ng for s in segs) >= 2
