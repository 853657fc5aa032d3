"""The port's voice-bank renderer, closed-form mesh bank, multi-script
queue and dry run (saugns_tpu_torch/parallel/) on the CPU, against the
JAX package on the CPU platform (8 virtual devices, tests/conftest.py)
and the port's TorchGenerator. The port's mesh is shards on the CPU
(``['cpu'] * 8``).

Tolerances: BankRender's ordered mix (one device, and the ring over
shards) bit-equal (float32 mix and int16) to the JAX package's
BankRender and TorchGenerator; the 'psum' and tree-sum mixes within one
int16 LSB of the JAX package's render of the same mode and >= 90 dB
against the ordered render; render_fm_bank within 2e-5 of the JAX
package's (its sine is jnp.sin against torch.sin); the queue and the
CLI byte-equal to the serial path."""
import functools
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import jax

jax.config.update('jax_platforms', 'cpu')

from jax.sharding import Mesh as JMesh  # noqa: E402
from saugns_tpu.lang.program import (ScriptArg as JArg,  # noqa: E402
                                     build_program as jbuild)
from saugns_tpu.parallel import sharding as jshard  # noqa: E402
from saugns_tpu.parallel import voicebank as jbank  # noqa: E402
import saugns_tpu_torch as stt  # noqa: E402
from saugns_tpu_torch import kernels  # noqa: E402
from saugns_tpu_torch.parallel import sharding as tshard  # noqa: E402
from saugns_tpu_torch.parallel.dryrun import dryrun_multichip  # noqa: E402
from saugns_tpu_torch.parallel.meshrender import slab_width  # noqa: E402
from saugns_tpu_torch.parallel.scripts import (  # noqa: E402
    PrerenderedGenerator, ShardedRenderQueue)
from saugns_tpu_torch.parallel.voicebank import (  # noqa: E402
    BankRender, make_bank_script, make_selfmod_bank_script)
from saugns_tpu_torch.render.engine import (  # noqa: E402
    TorchGenerator, resolve_device, resolve_devices)
from tests.torch_jaxref import ensure_native_tables  # noqa: E402


@pytest.fixture(autouse=True, scope='module')
def _jax_native_tables():
    """The JAX package renders with its native wave tables, also on a
    cold build cache (tests/torch_jaxref.py)."""
    ensure_native_tables()


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRATE = 6000
# name -> (script, mesh shards); kept small: the JAX side compiles once
# per bank width and mesh
BANKS = {
    'bank4': (make_bank_script(4, seed=1, duration=0.25), 1),
    'bank8_ring8': (make_bank_script(8, seed=1, duration=0.25), 8),
    'bank13_ring8': (make_bank_script(13, seed=1, duration=0.25), 8),
    'selfmod8_ring8': (make_selfmod_bank_script(8, seed=2,
                                                duration=0.1), 8),
}


def _jmesh(n):
    if len(jax.devices()) < n:
        pytest.skip('needs 8 virtual devices')
    return None if n == 1 else JMesh(np.asarray(jax.devices()[:n]),
                                     ('voices',))


def _tmesh(n):
    return None if n == 1 else tshard.Mesh(['cpu'] * n, ('voices',))


@functools.lru_cache(maxsize=None)
def _jax_bank(script, n, ordered=True, mix='ring'):
    """(float32 mix, int16) of the JAX package's BankRender."""
    prg = jbuild(JArg(str=script, is_path=False, no_time=True, predef=[]))
    br = jbank.BankRender(prg, SRATE, mesh=_jmesh(n), ordered_mix=ordered,
                          mesh_mix=mix)
    return np.asarray(br.render()), np.asarray(br.render_i16())


@functools.lru_cache(maxsize=None)
def _engine(script):
    g = TorchGenerator(stt.compile_script(script), SRATE, 'cpu')
    return g.assemble(g.render_device())


@pytest.mark.parametrize('name', sorted(BANKS))
def test_bank_ordered_bit_identical(name):
    """The ordered mix on one device, and the ring over eight shards,
    = the JAX package's BankRender (float32 mix and int16) and the
    port's TorchGenerator (int16)."""
    script, n = BANKS[name]
    jmix, ji16 = _jax_bank(script, n)
    br = BankRender(stt.compile_script(script), SRATE, mesh=_tmesh(n),
                    mesh_mix='ring', device='cpu')
    mix = br.render().numpy()
    assert mix.dtype == np.float32 and mix.shape == jmix.shape
    assert mix.tobytes() == jmix.tobytes()
    got = br.render_i16().numpy()
    assert np.array_equal(got, ji16)
    assert np.array_equal(got, _engine(script))
    # padding: every shard holds ceil(V / n) voices, in slabs of the
    # slab rule's width, one FlatSegment of V rows each
    per = -(-br.n_voices // n)
    width = slab_width(per, br.samples_per_voice())
    assert width == per
    assert [[seg.V for seg in sh.slabs] for sh in br.prepare()] == \
        [[width] * (per // width)] * n


def test_bank_single_device_equals_ring():
    """One device and the ring over shards give the same bits, eager
    (the plain path) or through the graphs' bodies."""
    script = BANKS['bank13_ring8'][0]
    prg = stt.compile_script(script)
    one = BankRender(prg, SRATE, device='cpu').render().numpy()
    ring = BankRender(prg, SRATE, mesh=_tmesh(4), mesh_mix='ring',
                      plain=True).render().numpy()
    assert one.tobytes() == ring.tobytes()


def _snr(a, b):
    err = (a.astype(np.float64) - b.astype(np.float64)).ravel()
    p = float((b.astype(np.float64) ** 2).sum())
    e = float((err ** 2).sum())
    return float('inf') if e == 0 else 10 * np.log10(p / e)


@pytest.mark.parametrize('mode', ['psum', 'unordered', 'unordered_ring'])
def test_bank_reassociating_mixes(mode):
    """'psum' over eight shards, and the tree-sum mix: within one LSB of
    the JAX package's render of the same mode, >= 90 dB against the
    ordered render."""
    script = BANKS['bank13_ring8'][0]
    n, ordered, mix = {'psum': (8, True, 'psum'),
                       'unordered': (1, False, 'psum'),
                       'unordered_ring': (8, False, 'ring')}[mode]
    _, ji16 = _jax_bank(script, n, ordered, mix)
    got = BankRender(stt.compile_script(script), SRATE, mesh=_tmesh(n),
                     ordered_mix=ordered, mesh_mix=mix,
                     device='cpu').render_i16().numpy()
    assert got.shape == ji16.shape
    assert int(np.abs(got.astype(np.int32) - ji16).max()) <= 1
    assert _snr(got, _engine(script)) >= 90.0


def test_bank_rejects_nonuniform():
    src = 'Wsin f220 t.2\nWsin f330 t.2 p[Wsin r2]\n'
    with pytest.raises(ValueError) as jerr:
        jbank.BankRender(jbuild(JArg(str=src, is_path=False, no_time=True,
                                     predef=[])), SRATE)
    with pytest.raises(ValueError) as terr:
        BankRender(stt.compile_script(src), SRATE, device='cpu')
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match='mesh_mix'):
        BankRender(stt.compile_script(BANKS['bank4'][0]), SRATE,
                   device='cpu', mesh_mix='tree')


def test_bank_renders_again_and_counts_graphs():
    """A second render starts from the post-record state again; the
    slabs of a shard share one graph (one capture, a replay a slab)."""
    script = BANKS['bank13_ring8'][0]
    br = BankRender(stt.compile_script(script), SRATE, mesh=_tmesh(2),
                    device='cpu')
    a = br.render().numpy()
    b = br.render().numpy()
    assert a.tobytes() == b.tobytes()
    st = br.graph_stats()
    # per shard: the reset and the slab graph; the shard's 7 voices are
    # one slab
    assert st['captures'] == 2 * 2
    assert st['replays'] == 2 * (2 + 2)


def test_render_fm_bank_matches_jax():
    """The closed-form bank on a 4 x 2 (voices x time) mesh against the
    JAX package's on its 8 virtual devices, within 2e-5."""
    if len(jax.devices()) < 8:
        pytest.skip('needs 8 virtual devices')
    jm = jshard.make_mesh(8)
    tm = tshard.make_mesh(8, ['cpu'] * 8)
    assert tm.shape == dict(jm.shape) == {'voices': 4, 'time': 2}
    args, n = tshard.sharded_args(tm, 16, 16384, seed=3)
    jargs, jn = jshard.sharded_args(jm, 16, 16384, seed=3)
    for a, b in zip(args, jargs):
        assert np.array_equal(a, np.asarray(b))
    want = np.asarray(jshard.render_fm_bank(jm, *jargs, jn))
    got = tshard.render_fm_bank(tm, *args, n).numpy()
    assert got.shape == want.shape == (16384, 2)
    assert np.abs(got - want).max() <= 2e-5
    # the same bank on one voices shard (a 1-D mesh) agrees too
    one = tshard.render_fm_bank(tshard.Mesh(['cpu'], ('voices',)), *args,
                                n).numpy()
    assert np.abs(one - want).max() <= 2e-5


def test_resolve_devices():
    assert resolve_devices('cpu,cpu, cpu') == [torch.device('cpu')] * 3
    assert resolve_devices(['cpu', torch.device('cpu')]) == \
        [torch.device('cpu')] * 2
    assert resolve_devices(torch.device('cpu')) == [torch.device('cpu')]
    assert resolve_device('cpu,cpu') == torch.device('cpu')
    with pytest.raises(ValueError):
        resolve_devices('')


def test_resolve_devices_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for spec in (None, 'cuda', 'cpu,cuda:0', ['cuda:1']):
        with pytest.raises(RuntimeError, match='CUDA'):
            resolve_devices(spec)
    with pytest.raises(RuntimeError, match='CUDA'):
        resolve_device()


def test_dryrun_multichip(capsys):
    dryrun_multichip(['cpu'] * 8)
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 4
    assert all(line.endswith(': ok') for line in out)
    assert 'time-axis shard' in out[3] and 'bit-identical' in out[3]


def _serial(prg, stereo):
    g = TorchGenerator(prg, SRATE, 'cpu')
    return np.concatenate(list(g._stream_i16(stereo)), axis=0)


@pytest.mark.parametrize('stereo', [True, False], ids=['stereo', 'mono'])
def test_queue_equals_serial(stereo):
    """Three programs over two CPU shards, one worker thread each:
    every pre-rendered output = the serial render; a program over the
    buffer cap and a missing program are left to the serial path."""
    srcs = [make_bank_script(3, seed=5, duration=0.2), None,
            'Wsin f300 t.2 a.3\n/.1 Nre t.1 a.2\n',
            'Wsqr f80.r160[Wsin f2] t.3 a.4']
    prgs = [stt.compile_script(s) if s else None for s in srcs]
    q = ShardedRenderQueue(prgs, SRATE, stereo, ['cpu', 'cpu'],
                           max_buffer_samples=1500)
    try:
        assert sorted(q.futures) == [0, 2]
        assert q.generator(1) is None and q.generator(3) is None
        for i in (0, 2):
            g = q.generator(i)
            assert isinstance(g, PrerenderedGenerator)
            assert np.array_equal(g.arr, _serial(prgs[i], stereo))
    finally:
        q.close()


def test_queue_off(monkeypatch):
    prgs = [stt.compile_script('Wsin t.1')] * 2
    assert ShardedRenderQueue(prgs, SRATE, True, ['cpu']).futures == {}
    monkeypatch.setenv('SAUGNS_TPU_SHARD_SCRIPTS', '0')
    assert ShardedRenderQueue(prgs, SRATE, True,
                              ['cpu', 'cpu']).futures == {}


def test_queue_error_raises():
    """A render that fails raises where its output is taken."""
    prgs = [stt.compile_script('Wsin t.1')] * 2
    q = ShardedRenderQueue(prgs, SRATE, True, ['cpu', 'meta'])
    try:
        assert np.array_equal(q.generator(0).arr, _serial(prgs[0], True))
        with pytest.raises(Exception):
            q.generator(1)
    finally:
        q.close()


def test_launch_counts_under_threads():
    """kernels.count is exact under threads, and the launches of a
    thread inside kernels.capturing() go to its capture only."""
    kernels.reset_launches()
    seen = {}

    def work(k):
        if k == 0:
            with kernels.capturing() as launches:
                for _ in range(5000):
                    kernels.count('is64')
            seen.update(launches)
        else:
            for _ in range(5000):
                kernels.count('ffill')
    threads = [threading.Thread(target=work, args=(k,)) for k in range(5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert seen == {'is64': 5000}
    assert kernels.LAUNCHES['ffill'] == 4 * 5000
    assert kernels.LAUNCHES['is64'] == 0
    kernels.reset_launches()


def _run_cli(args, env_extra, cwd):
    env = dict(os.environ)
    env['PYTHONPATH'] = ROOT
    env.update(env_extra)
    return subprocess.run([sys.executable, '-m', 'saugns_tpu_torch.cli']
                          + args, capture_output=True, env=env, cwd=cwd,
                          timeout=300)


def test_cli_script_queue_output_identical(tmp_path):
    """The CLI with a two-script list on four CPU shards writes the same
    WAV bytes with the queue on and off."""
    paths = []
    for k, src in enumerate(('Wsin f440 t.3 a.4 p[Wsin r2 a.5]\n'
                             'Nwh a.2 t.25\n',
                             make_bank_script(5, seed=2, duration=0.2))):
        p = tmp_path / ('s%d.sau' % k)
        p.write_text(src)
        paths.append(str(p))
    outs = []
    for shard in ('1', '0'):
        out = tmp_path / ('q%s.wav' % shard)
        r = _run_cli(['-d', '-r6000', '-m', '-o', str(out)] + paths,
                     {'SAUGNS_TPU_TORCH_DEVICE': 'cpu,cpu,cpu,cpu',
                      'SAUGNS_TPU_SHARD_SCRIPTS': shard}, tmp_path)
        assert r.returncode == 0, r.stderr.decode()
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] and len(outs[0]) > 44
