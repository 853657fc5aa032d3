"""The port's mesh renderer of heterogeneous programs
(saugns_tpu_torch/parallel/meshrender.py), its player and CLI paths, on
the CPU, against the JAX package's MeshRender on the CPU platform (8
virtual devices, tests/conftest.py) and the host renderer
(saugns_tpu/render/cpu.py, byte-identical to the reference binary).
The port's mesh is eight shards on the CPU (``['cpu'] * 8``).
Tolerance: bit-equality of the int16 output and of the float32 mix."""
import os
import subprocess
import sys

import numpy as np
import pytest

import jax

jax.config.update('jax_platforms', 'cpu')

from jax.sharding import Mesh as JMesh  # noqa: E402
from saugns_tpu.lang.program import (ScriptArg as JArg,  # noqa: E402
                                     build_program as jbuild)
from saugns_tpu.parallel import meshrender as jmesh  # noqa: E402
from saugns_tpu.render.cpu import Generator as CpuGen  # noqa: E402
import saugns_tpu_torch as stt  # noqa: E402
from saugns_tpu_torch.io import player as tplayer  # noqa: E402
from saugns_tpu_torch.parallel.meshrender import (  # noqa: E402
    Ineligible, MeshGenerator, MeshRender, default_mesh)
from saugns_tpu_torch.parallel.sharding import Mesh  # noqa: E402
from saugns_tpu_torch.render.engine import TorchGenerator  # noqa: E402
from tests.torch_jaxref import ensure_native_tables  # noqa: E402


@pytest.fixture(autouse=True, scope='module')
def _jax_native_tables():
    """The JAX package renders with its native wave tables, also on a
    cold build cache (tests/torch_jaxref.py)."""
    ensure_native_tables()


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRATE = 6000
# three structurally different voices: FM wave, noise, RasG
HETERO = ("Wsin f440 t0.3 a.4 p[Wsin r2 a.5]\n"
          "Nwh a0.2 t0.25\n"
          "Rlin f200 t0.2 a.3\n")
# its self-PM variant (tests/test_meshrender.py)
HETERO_SELFPM = ("Wsin f440 t0.3 a.4 p.a.4\n"
                 "Nwh a0.2 t0.25\n"
                 "Rlin f200 t0.2 a.3 p.a.3\n")
# three epochs, one of two segments (a phase record and a wave change
# mid-note), voices that start and stop at different times
MULTI = ("'a Wsin f440 t.6 a.3\n"
         "'b Wsin f220 t.6 a.2\n"
         "/.2 @a p.25 @b wsqr\n"
         "/.1 Nbv t.2 a.1\n")
# four epochs: a voice id reused by a later voice, a RasG voice with a
# varying frequency and a red noise voice
REUSE = ("Wsin f440 t.4 a.3 p[Wsin r2 a.3]\n"
         "/.1 Nre t.2 a.2\n"
         "/.1 Rcos f80.r160[Wsin f2] t.3 a.3\n"
         "/.15 Wtri f330 t.2 a.2\n")
SCRIPTS = {'hetero': HETERO, 'hetero_selfpm': HETERO_SELFPM,
           'multi': MULTI, 'reuse': REUSE}


def _jprog(src):
    return jbuild(JArg(str=src, is_path=False, no_time=True, predef=[]))


def _cpu_ref(src):
    g = CpuGen(_jprog(src), SRATE)
    buf = np.zeros(4096 * 2, np.int16)
    chunks = []
    while True:
        more, n = g.run(buf, 4096, True)
        chunks.append(buf[:n * 2].copy())
        if not more:
            break
    return np.concatenate(chunks).reshape(-1, 2)


def _jax_mesh(n):
    return None if n == 1 else JMesh(np.asarray(jax.devices()[:n]),
                                     ('voices',))


def _port_mesh(n):
    return None if n == 1 else Mesh(['cpu'] * n, ('voices',))


@pytest.mark.parametrize('n', [1, 8], ids=['one', 'mesh8'])
@pytest.mark.parametrize('name', sorted(SCRIPTS))
def test_meshrender_bit_identical(name, n):
    """MeshRender of the port = the JAX package's MeshRender (float32
    mix and int16), = the host renderer and the port's TorchGenerator
    (int16), on one device and on eight shards."""
    src = SCRIPTS[name]
    if len(jax.devices()) < n:
        pytest.skip('needs 8 virtual devices')
    jmr = jmesh.MeshRender(_jprog(src), SRATE, mesh=_jax_mesh(n))
    jmix = np.asarray(jmr.render())
    mr = MeshRender(stt.compile_script(src), SRATE, mesh=_port_mesh(n),
                    device='cpu')
    mix = mr.render()
    assert mix.dtype == np.float32 and mix.shape == jmix.shape
    assert mix.tobytes() == jmix.tobytes()
    got = mr.render_i16()
    assert np.array_equal(got, _cpu_ref(src))
    tg = TorchGenerator(stt.compile_script(src), SRATE, 'cpu')
    assert np.array_equal(got, tg.assemble(tg.render_device()))
    if n == 8:
        # voices spread over the shards, each on one shard throughout
        assert len(set(mr.shard_of.values())) == min(
            len(mr.shard_of), 8)


def test_hetero_groups_and_placement():
    """Three voices of three signatures, walked in ascending voice id
    (the mix chain's order); each voice on its own shard, a slab of
    one."""
    mr = MeshRender(stt.compile_script(HETERO), SRATE,
                    mesh=_port_mesh(8))
    mr.prepare()
    ep, segs = mr.epoch_segs[-1]
    assert [vs for _d, vs, _fs in segs[0].slabs] == [[0], [1], [2]]
    assert len({fs.key for _d, _vs, fs in segs[0].slabs}) == 3
    assert mr.shard_of == {0: 0, 1: 1, 2: 2}
    for d, vs, fs in segs[0].slabs:
        assert fs.V == 1 and d == mr.shard_of[vs[0]]
        assert fs.device == mr.devices[d]


def test_meshrender_plain_and_eager_paths():
    """The plain path (plain versions of the kernels, op by op) renders
    the same bits as the default path."""
    src = HETERO_SELFPM
    a = MeshRender(stt.compile_script(src), SRATE, mesh=_port_mesh(4))
    b = MeshRender(stt.compile_script(src), SRATE, mesh=_port_mesh(4),
                   plain=True)
    assert a.render().tobytes() == b.render().tobytes()
    # a second render of the same renderer starts from the initial state
    assert a.render().tobytes() == b.render().tobytes()


def test_selfmod_flat_off_rejected(monkeypatch):
    """With SAUGNS_TPU_FLAT_SELFMOD=0 self-PM epochs are not
    flat-eligible: both packages reject the program with ValueError."""
    monkeypatch.setenv('SAUGNS_TPU_FLAT_SELFMOD', '0')
    with pytest.raises(ValueError) as jerr:
        jmesh.MeshRender(_jprog(HETERO_SELFPM), SRATE)
    with pytest.raises(Ineligible) as terr:
        MeshRender(stt.compile_script(HETERO_SELFPM), SRATE, device='cpu')
    assert isinstance(terr.value, ValueError)
    assert str(terr.value) == str(jerr.value)


def test_player_selects_mesh_generator():
    """With two or more devices the player takes the mesh renderer for
    a multi-voice flat-eligible program, and a TorchGenerator on the
    first device for a program it rejects or of one voice. On one
    device it takes the mesh renderer where the voices batch, and a
    TorchGenerator where every voice is a group of its own."""
    devs = ['cpu', 'cpu']
    gen = tplayer._make_generator(stt.compile_script(HETERO), SRATE, devs)
    assert isinstance(gen, MeshGenerator)
    assert [str(d) for d in gen.mr.devices] == devs
    one = tplayer._make_generator(stt.compile_script('Wsin t.1'), SRATE,
                                  devs)
    assert isinstance(one, TorchGenerator)
    # rejected: an epoch HostSim cannot bake (pm_smoothchange's pattern)
    seq = 'Wsin f220 t.3 p[Wsin f50 /.1 r[g3 t.1]]\nWsin f330 t.3'
    with pytest.raises(Ineligible):
        MeshRender(stt.compile_script(seq), SRATE, mesh=_port_mesh(2))
    gen2 = tplayer._make_generator(stt.compile_script(seq), SRATE, devs)
    assert isinstance(gen2, TorchGenerator)
    assert gen2.device.type == 'cpu'
    # one device: the grouped slab path where two voices share a slab
    gen3 = tplayer._make_generator(stt.compile_script(MULTI), SRATE,
                                   ['cpu'])
    assert isinstance(gen3, MeshGenerator)
    assert [str(d) for d in gen3.mr.devices] == ['cpu']
    # three signatures, three slabs of one: no batching, no mesh
    gen4 = tplayer._make_generator(stt.compile_script(HETERO), SRATE,
                                   ['cpu'])
    assert isinstance(gen4, TorchGenerator)


def test_mesh_generator_run_and_checksum():
    """MeshGenerator's run() (stereo and mono) and render_checksum()
    give TorchGenerator's bytes and sum."""
    mesh = _port_mesh(4)
    for stereo in (True, False):
        mg = MeshGenerator(stt.compile_script(MULTI), SRATE, mesh)
        tg = TorchGenerator(stt.compile_script(MULTI), SRATE, 'cpu')
        ch = 2 if stereo else 1
        outs = []
        for g in (mg, tg):
            buf = np.zeros(1000 * ch, np.int16)
            parts = []
            while True:
                more, n = g.run(buf, 1000, stereo)
                parts.append(buf[:n * ch].copy())
                if not more:
                    break
            outs.append(np.concatenate(parts))
        assert np.array_equal(outs[0], outs[1])
    mg = MeshGenerator(stt.compile_script(MULTI), SRATE, mesh)
    tg = TorchGenerator(stt.compile_script(MULTI), SRATE, 'cpu')
    ms, ts = mg.render_checksum(), tg.render_checksum()
    assert int(ms) == int(ts)
    # on the device where the player's TorchGenerator puts its own
    assert ms.device == mg.mr.devices[0] == ts.device


def test_default_mesh_and_cuda(monkeypatch):
    """default_mesh: None below two devices; CUDA asked for and absent
    raises, nothing falls back to the CPU."""
    assert default_mesh(['cpu']) is None
    m = default_mesh('cpu,cpu,cpu')
    assert m.shape == {'voices': 3}
    import torch
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        default_mesh()
    with pytest.raises(RuntimeError, match='CUDA'):
        MeshGenerator(stt.compile_script(HETERO), SRATE)


def _run_cli(args, env_extra, cwd):
    env = dict(os.environ)
    env['PYTHONPATH'] = ROOT
    env.update(env_extra)
    return subprocess.run([sys.executable, '-m', 'saugns_tpu_torch.cli']
                          + args, capture_output=True, env=env, cwd=cwd,
                          timeout=300)


def test_cli_mesh_path_output_identical(tmp_path):
    """The CLI on four CPU shards takes the mesh path (the debug marker
    shows it) and writes the WAV bytes of the mesh-disabled render."""
    script = tmp_path / 'multi.sau'
    script.write_text(MULTI)
    outs = []
    for mesh_on in ('1', '0'):
        out = tmp_path / ('mesh%s.wav' % mesh_on)
        r = _run_cli(['-d', '-r6000', '-m', '-o', str(out), str(script)],
                     {'SAUGNS_TPU_TORCH_DEVICE': 'cpu,cpu,cpu,cpu',
                      'SAUGNS_TPU_MESH': mesh_on,
                      'SAUGNS_TPU_MESH_DEBUG': '1',
                      'SAUGNS_TPU_SHARD_SCRIPTS': '0'}, tmp_path)
        assert r.returncode == 0, r.stderr.decode()
        marker = b'# mesh-render:' in r.stderr
        assert marker == (mesh_on == '1'), r.stderr.decode()
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] and len(outs[0]) > 44


def test_cli_muted_two_scripts(tmp_path):
    """A muted run (-m, no output file) of a multi-voice program, which
    takes the mesh generator, and a one-voice program, which takes a
    TorchGenerator: the player sums both deferred checksums with one
    fetch, and the run succeeds with the mesh on and off."""
    a = tmp_path / 'multi.sau'
    a.write_text(MULTI)
    b = tmp_path / 'one.sau'
    b.write_text('Wsin f330 t.2 a.3\n')
    for mesh_on in ('1', '0'):
        r = _run_cli(['-m', '-r6000', str(a), str(b)],
                     {'SAUGNS_TPU_TORCH_DEVICE': 'cpu,cpu',
                      'SAUGNS_TPU_MESH': mesh_on,
                      'SAUGNS_TPU_MESH_DEBUG': '1'}, tmp_path)
        assert r.returncode == 0, r.stderr.decode()
        marker = r.stderr.count(b'# mesh-render:')
        assert marker == (mesh_on == '1'), r.stderr.decode()
