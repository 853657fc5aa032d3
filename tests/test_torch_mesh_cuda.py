"""The port's multi-device path on the card: the kernels on a tensor of a
device other than the current one, two threads capturing graphs at once
on one card, and the voice-sharded renderers and the time axis over two
shards of one card (and of two cards, where there are two) against
TorchGenerator.
Every test needs a card (marked ``cuda``; they skip without one); run
them there with
``python -m pytest --noconftest -q tests/test_torch_mesh_cuda.py``.
Tolerance: bit-equality (int16 output, float32 mix, kernel outputs),
except the 'psum' mix: within one int16 LSB of the ring's."""
import threading

import numpy as np
import pytest
import torch

import saugns_tpu_torch as stt
from saugns_tpu_torch import kernels
from saugns_tpu_torch.parallel.meshrender import MeshRender
from saugns_tpu_torch.parallel.scripts import ShardedRenderQueue
from saugns_tpu_torch.parallel.sharding import Mesh
from saugns_tpu_torch.parallel.timeshard import TimeShardRender
from saugns_tpu_torch.parallel.voicebank import (BankRender,
                                                 make_bank_script)
from saugns_tpu_torch.render import tdsp
from saugns_tpu_torch.render.engine import TorchGenerator
from saugns_tpu_torch.render.graphs import Dispatch

SRATE = 48000
HETERO = ("Wsin f440 t0.3 a.4 p.a.4\n"
          "Nre a0.2 t0.25\n"
          "Rcos f80.r160[Wsin f2] t0.2 a.3 p.a.3\n"
          "Wsqr f80.r160[Wsin f2] t.3 a.3\n")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    kernels.build()
    return torch.device('cuda', 0)


@pytest.fixture
def cuda2(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip('needs two CUDA cards')
    return [cuda, torch.device('cuda', 1)]


def _engine(script, dev):
    g = TorchGenerator(stt.compile_script(script), SRATE, dev)
    return g.assemble(g.render_device())


@pytest.mark.cuda
def test_kernels_on_another_device(cuda2):
    """With cuda:0 current, every kernel on tensors of cuda:1 launches
    there (bit-equal to its plain version there) and leaves cuda:0
    current."""
    d1 = cuda2[1]
    g = torch.Generator().manual_seed(7)
    pil = tdsp.wave_tables(d1)[1][0]
    n = 3 * kernels.SCAN_TILE + 5

    def ints(hi, *shape):
        return torch.randint(0, hi, shape, generator=g).to(d1)
    x = ints(1 << 32, n)
    ph = ints(1 << 32, 2, n)
    seeds = (ints(1 << 32, 2), torch.rand(2, generator=g).to(d1),
             torch.tensor([0, 5], device=d1),
             torch.tensor([True, False], device=d1), ints(1 << 32, 2))
    s = torch.rand(2, n, generator=g).to(d1)
    valid = torch.rand(2, n, generator=g).to(d1) < 0.7
    am = torch.rand(2, n, generator=g).to(d1)
    fb = torch.zeros(2, device=d1)
    calls = [
        (kernels.scan_add_u32, tdsp.prefix_sum_plain, (x,)),
        (kernels.scan_add_u64, tdsp.prefix_sum_u64_plain, (x,)),
        (kernels.scan_max_i32, tdsp.scan_max_i32_plain,
         (x.to(torch.int32) >> 1,)),
        (kernels.wosc_fill, tdsp.wosc_s_filled_plain,
         (pil, 0, ph) + seeds),
        (kernels.gather_taps, tdsp.gather_taps_plain,
         (pil, ints(2048, n))),
        (kernels.is64, tdsp.is64_plain, (pil, x)),
        (kernels.ffill, tdsp.last_valid_fill, (s, valid, s[:, 0])),
        (kernels.wosc_selfmod, tdsp.wosc_selfmod_plain,
         (pil, 0, ph[:, :512], am[:, :512], valid[:, :512], seeds[0],
          seeds[1], fb)),
        (kernels.rasg_selfmod, tdsp.rasg_selfmod_plain,
         (0, 1, 27, 0x9e3779b9, 0, s[:, :512], ph[:, :512],
          am[:, :512], valid[:, :512], seeds[1], fb)),
    ]
    torch.cuda.set_device(0)
    for kern, plain, args in calls:
        got = kern(*args)
        ref = plain(*args)
        torch.cuda.synchronize(d1)
        assert torch.cuda.current_device() == 0
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        ref if isinstance(ref, tuple) else (ref,)):
            assert a.device == d1
            assert torch.equal(a, b), kern.__name__


@pytest.mark.cuda
def test_two_threads_capture_at_once(cuda):
    """Two threads render (and capture their graphs) at the same time on
    one card, twice: each output = its eager render, and the launches
    counted = those of the two renders op by op."""
    scripts = [make_bank_script(8, seed=3, duration=0.3), HETERO]
    want = []
    kernels.reset_launches()
    for s in scripts:
        g = TorchGenerator(stt.compile_script(s), SRATE, cuda,
                           graphs=False)
        want.append(g.assemble(g.render_device()))
    torch.cuda.synchronize()
    n_eager = dict(kernels.LAUNCHES)
    for _ in range(2):
        kernels.reset_launches()
        barrier = threading.Barrier(2)
        got = [None, None]
        errs = []

        def work(k):
            try:
                g = TorchGenerator(stt.compile_script(scripts[k]), SRATE,
                                   cuda)
                g.prepare()
                barrier.wait()
                got[k] = g.assemble(g.render_device())
            except BaseException as e:  # reported below
                errs.append(e)
        ts = [threading.Thread(target=work, args=(k,)) for k in (0, 1)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert not errs, errs
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert np.array_equal(a, b)
        assert dict(kernels.LAUNCHES) == n_eager


@pytest.mark.cuda
def test_failed_capture_leaves_no_capture_stream(cuda):
    """A capture that fails (a sync inside it) restores the thread's
    stream; then another thread's capture does not take this thread's
    copies as its own (its stream is the dispatch's, not one shared by
    every capture)."""
    prev = torch.cuda.current_stream()
    st0 = tuple(torch.zeros(2, device=cuda) for _ in range(3))
    d = Dispatch(cuda, True, True, st0)
    x = torch.ones(4, device=cuda)
    with pytest.raises(RuntimeError):
        d.run(('bad',), lambda t: t.sum().item(), (), (x,))
    assert torch.cuda.current_stream() == prev
    started, done = threading.Event(), threading.Event()
    errs = []

    def body(t):
        started.set()
        done.wait(10)
        return t * 2

    def work():
        try:
            d2 = Dispatch(cuda, True, True, st0)
            out = d2.run(('slow',), body, (), (x,))
            torch.cuda.synchronize()
            assert torch.equal(out, x * 2)
        except BaseException as e:  # reported below
            errs.append(e)
            started.set()
    t = threading.Thread(target=work)
    t.start()
    started.wait(10)
    try:
        y = torch.from_numpy(np.arange(8, dtype=np.float32)).to(cuda)
        assert y.cpu().numpy().tolist() == list(range(8))
    finally:
        done.set()
        t.join()
    assert not errs, errs


def _check_mesh(devs):
    mesh = Mesh(devs, ('voices',))
    bank = make_bank_script(13, seed=1, duration=0.3)
    ref = _engine(bank, devs[0])
    one = BankRender(stt.compile_script(bank), SRATE, device=devs[0])
    ring = BankRender(stt.compile_script(bank), SRATE, mesh=mesh,
                      mesh_mix='ring')
    psum = BankRender(stt.compile_script(bank), SRATE, mesh=mesh)
    a = one.render().cpu().numpy()
    b = ring.render().cpu().numpy()
    assert a.tobytes() == b.tobytes()
    rb = ring.render_i16().cpu().numpy()
    assert np.array_equal(rb, ref)
    diff = psum.render_i16().cpu().numpy().astype(np.int32) - rb
    assert int(np.abs(diff).max()) <= 1
    for kw in ({'plain': True}, {'graphs': False}):
        other = BankRender(stt.compile_script(bank), SRATE, mesh=mesh,
                           mesh_mix='ring', **kw)
        assert np.array_equal(other.render_i16().cpu().numpy(), ref)
    kernels.reset_launches()
    got = MeshRender(stt.compile_script(HETERO), SRATE,
                     mesh=mesh).render_i16()
    torch.cuda.synchronize()
    for k in ('wosc_fill', 'scan_add_u32', 'scan_add_u64', 'scan_max_i32',
              'wosc_selfmod', 'rasg_selfmod'):
        assert kernels.LAUNCHES[k] > 0, k
    assert np.array_equal(got, _engine(HETERO, devs[0]))
    eager = MeshRender(stt.compile_script(HETERO), SRATE, mesh=mesh,
                       graphs=False)
    assert np.array_equal(eager.render_i16(), got)
    assert eager.graph_stats()['captures'] == 0
    # the queue: two programs, one worker a shard
    prgs = [stt.compile_script(s) for s in (bank, HETERO)]
    q = ShardedRenderQueue(prgs, SRATE, True, devs)
    try:
        for i, s in enumerate((bank, HETERO)):
            assert np.array_equal(q.generator(i).arr, _engine(s, devs[0]))
    finally:
        q.close()


@pytest.mark.cuda
def test_mesh_two_shards_one_card(cuda):
    _check_mesh([cuda, cuda])


@pytest.mark.cuda
def test_mesh_two_cards(cuda2):
    _check_mesh(cuda2)


# the time axis: kernel 1's hold across shards (rows at 0 Hz), kernels 2
# and 3, red noise, a voice that ends early, and self-PM (kernels 5 and
# 6, handed from shard to shard); 3 to 5 block rows a segment
TIME_AXIS = ('Wsin t2 f100 a.5 /.5 f0 /.3 f0 /.2 f100',
             'Wsqr t2 f80.r160[Wsin f2] a.5\nNre t.4 a.2\n'
             'Rcos t2 f80.r160[Wsin f2] a.3',
             'Wsin f100 t1.5 p.a.5 /.5 a.3 /.5 a.2',
             'Rcos mf f60 p.a.5[Rlin f7 a.4] a.6 t1.5 /.7 a.3')


def _check_time_axis(devs):
    """Each script with graphs (the default) = op by op (graphs=False) =
    TorchGenerator, with the same exchanges; a warm render with graphs
    captures nothing and makes no host sync."""
    mesh = Mesh(devs, ('sp',))
    kernels.reset_launches()
    for src in TIME_AXIS:
        prg = stt.compile_script(src)
        ref = _engine(src, devs[0])
        ts = TimeShardRender(prg, SRATE, mesh)
        got = ts.render_host()
        assert len(ts.segs) >= 1 and np.array_equal(got, ref), src
        eager = TimeShardRender(prg, SRATE, mesh, graphs=False)
        assert np.array_equal(eager.render_host(), got), src
        assert eager.exchanges == ts.exchanges, src
        captures = ts.graph_stats()['captures']
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode('error')
        try:
            pieces = ts.render_device()
        finally:
            torch.cuda.set_sync_debug_mode('default')
        assert np.array_equal(ts.assemble(pieces), got), src
        assert ts.graph_stats()['captures'] == captures > 0, src
        if 'p.a' not in src:
            # (the plain self-PM versions step through samples in Python)
            plain = TimeShardRender(prg, SRATE, mesh, plain=True)
            assert np.array_equal(plain.render_host(), ref), src
    torch.cuda.synchronize()
    for k in ('wosc_fill', 'scan_add_u32', 'scan_add_u64', 'scan_max_i32',
              'wosc_selfmod', 'rasg_selfmod'):
        assert kernels.LAUNCHES[k] > 0, k


@pytest.mark.cuda
def test_time_axis_two_shards_one_card(cuda):
    _check_time_axis([cuda, cuda])


@pytest.mark.cuda
def test_time_axis_two_cards(cuda2):
    _check_time_axis(cuda2)


@pytest.mark.cuda
def test_cli_muted_mesh_and_engine(cuda, tmp_path, monkeypatch, capsys):
    """A muted CLI run on cuda:0 twice: the multi-voice program takes the
    mesh generator, the one-voice program a TorchGenerator, and the
    player sums both deferred checksums on one device."""
    from saugns_tpu_torch import cli
    a = tmp_path / 'hetero.sau'
    a.write_text(HETERO)
    b = tmp_path / 'one.sau'
    b.write_text('Wsin f330 t.2 a.3\n')
    monkeypatch.setenv('SAUGNS_TPU_TORCH_DEVICE', 'cuda:0,cuda:0')
    monkeypatch.setenv('SAUGNS_TPU_MESH_DEBUG', '1')
    assert cli.main(['-m', '-r48000', str(a), str(b)]) == 0
    assert capsys.readouterr().err.count('# mesh-render:') == 1
