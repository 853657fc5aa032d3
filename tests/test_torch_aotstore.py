"""The port's compiled-render store (saugns_tpu_torch/render/aotstore.py)
on the CPU: its key, the disk tier (an artifact of a generator's host
products, read back in this process and in a fresh one) and the memory
tier (the prepared render of a dropped generator handed to the next
generator of its key).
Every render served from the store is held byte for byte against the
same render without it and against JaxGenerator on the CPU platform.
Every store directory lies under the test's tmp_path
(SAUGNS_TPU_CACHE). Tolerance: byte-equality of the int16 output."""
import functools
import gc
import hashlib
import json
import os
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import jax

jax.config.update('jax_platforms', 'cpu')

from saugns_tpu.lang.program import (ScriptArg as JArg,  # noqa: E402
                                     build_program as jbuild)
from saugns_tpu.render import engine as jeng  # noqa: E402
from saugns_tpu.render import jdsp  # noqa: E402
import saugns_tpu_torch as stt  # noqa: E402
from saugns_tpu_torch import convert  # noqa: E402
from saugns_tpu_torch.parallel.voicebank import \
    make_bank_script  # noqa: E402
from saugns_tpu_torch.render import aotstore, graphs  # noqa: E402
from saugns_tpu_torch.render.engine import TorchGenerator  # noqa: E402
from saugns_tpu_torch.render.flat import FlatSegment  # noqa: E402
from tests.torch_jaxref import ensure_native_tables  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRATE = 6000
SEQ_SCRIPT = 'Wsin f220 t1 p[Wsin f50 /.3 r[g3 t.3]]'
# a multi-voice flat bank, noise and RasG (kernels 2 and 3 on the card),
# a short wave self-PM script, and an epoch HostSim cannot bake (the
# pm_smoothchange.sau pattern: the sequential engine)
ROUND_TRIP = {
    'bank8': make_bank_script(8, seed=0, duration=0.3),
    'noise_rasg': 'Nre t.3 a.4 | Rcos t.3 f80.r160[Wsin f2] a.7',
    'wosc_selfpm': 'Wsin f110 t.2 p.a.3',
    'pm_smoothchange': SEQ_SCRIPT,
}


@pytest.fixture(autouse=True, scope='module')
def _jax_native_tables():
    """The JAX package renders with its native wave tables, also on a
    cold build cache (tests/torch_jaxref.py)."""
    ensure_native_tables()


@pytest.fixture(autouse=True)
def store(tmp_path, monkeypatch):
    """A store of the test's own: the user directory and the pack
    directory under tmp_path, the tier empty, the counts at 0."""
    monkeypatch.setenv('SAUGNS_TPU_CACHE', str(tmp_path / 'cache'))
    monkeypatch.delenv('SAUGNS_TPU_EXPORT', raising=False)
    monkeypatch.setattr(aotstore, '_pack_dir',
                        lambda platform: str(tmp_path / 'pack' / platform))
    # generators of earlier tests (a stream is a reference cycle) hand
    # their renders to the tier when collected: before it is emptied
    gc.collect()
    aotstore.clear()
    aotstore.reset_stats()
    yield tmp_path
    gc.collect()
    aotstore.clear()
    aotstore.reset_stats()


def _pull(gen, stereo=True, buf_len=700):
    ch = 2 if stereo else 1
    buf = np.zeros(buf_len * ch, np.int16)
    out = []
    while True:
        more, n = gen.run(buf, buf_len, stereo)
        out.append(buf[:n * ch].copy())
        if not more:
            break
    return np.concatenate(out).reshape(-1, ch)


@functools.lru_cache(maxsize=None)
def _jax(script):
    """JaxGenerator's stereo output on the CPU platform."""
    jg = jeng.JaxGenerator(
        jbuild(JArg(str=script, is_path=False, no_time=True, predef=[])),
        SRATE)
    return _pull(jg)


def _gen(script, **kw):
    return TorchGenerator(stt.compile_script(script), SRATE, 'cpu', **kw)


def _key(script, srate=SRATE, **kw):
    return _gen(script, **kw)._key if srate == SRATE else \
        TorchGenerator(stt.compile_script(script), srate, 'cpu', **kw)._key


def _renderers(g):
    return [r for ei in range(len(g.plan.epochs)) for r in g._renderers(ei)]


# -- the key ------------------------------------------------------------------

def test_same_script_two_names_one_key(tmp_path):
    paths = []
    for name in ('a.sau', 'b.sau'):
        p = tmp_path / name
        p.write_text('Wsin f220 t.2 p[Wsin r2 a.3]\n')
        paths.append(str(p))
    prgs = [stt.compile_script(path=p) for p in paths]
    assert prgs[0].name != prgs[1].name
    keys = {TorchGenerator(p, SRATE, 'cpu')._key for p in prgs}
    assert len(keys) == 1


def _jax_tables():
    _, piluts = convert.tables(*jdsp.get_tables(), 'cpu')
    return piluts


@pytest.mark.parametrize('change', [
    'srate', 'tables', 'tables_bits', 'state', 'flat', 'plain', 'graphs',
    'block', 'trace_env'])
def test_key_changes(change, monkeypatch):
    script = 'Wsin f220 t.2 p[Wsin r2 a.3]'
    base = _key(script)
    if change == 'srate':
        other = _key(script, srate=8000)
    elif change == 'tables':
        # the JAX package's tables through convert.py against the
        # port's own (their bytes agree where both build them natively;
        # a caller's tables are told apart by design)
        other = _key(script, piluts=_jax_tables())
    elif change == 'tables_bits':
        pil = _jax_tables()
        base = _key(script, piluts=pil)
        pil2 = pil.clone()
        pil2.view(torch.int32)[3, 100] += 1
        other = _key(script, piluts=pil2)
    elif change == 'state':
        prg = stt.compile_script(script)
        jg = jeng.JaxGenerator(
            jbuild(JArg(str=script, is_path=False, no_time=True,
                        predef=[])), SRATE)
        st0 = convert.state(jeng.make_state(jg.plan), 'cpu')
        other = TorchGenerator(prg, SRATE, 'cpu', state=st0)._key
    elif change == 'trace_env':
        monkeypatch.setenv('SAUGNS_TPU_FLAT_SELFMOD', '0')
        other = _key(script)
    else:
        value = {'flat': False, 'plain': True, 'graphs': False,
                 'block': 512}[change]
        other = _key(script, **{change: value})
    assert other != base


def test_code_hash_covers_the_sources(tmp_path):
    pkg = os.path.join(ROOT, 'saugns_tpu_torch')
    copy = tmp_path / 'pkg'
    for d in aotstore.CODE_DIRS:
        shutil.copytree(os.path.join(pkg, d), copy / d,
                        ignore=shutil.ignore_patterns('__pycache__'))
    for f in aotstore.CODE_FILES:
        shutil.copyfile(os.path.join(pkg, f), copy / f)
    h0 = aotstore.code_hash()
    assert aotstore.code_hash(str(copy)) == h0
    for rel in ('csrc/ffill.cu', 'native/fastdsp.c', 'render/flat.py',
                'kernels.py'):
        p = copy / rel
        old = p.read_bytes()
        p.write_bytes(old + b'\n')
        assert aotstore.code_hash(str(copy)) != h0, rel
        p.write_bytes(old)
    assert aotstore.code_hash(str(copy)) == h0


# -- the disk tier -----------------------------------------------------------

@pytest.mark.parametrize('name', sorted(ROUND_TRIP))
def test_round_trip_from_disk(name):
    script = ROUND_TRIP[name]
    want = _jax(script)
    g0 = _gen(script)
    assert g0.source == 'baked' and aotstore.STATS['misses'] == 1
    ref = g0.assemble(g0.render_device())
    assert np.array_equal(ref, want), int(np.sum(ref != want))
    p = g0.save_export()
    assert p is not None and os.path.isfile(p)
    assert os.path.dirname(p) == aotstore._user_dir('cpu')
    assert aotstore.STATS['saves'] == 1
    aotstore.clear()
    g1 = _gen(script)
    assert g1.source == 'disk' and aotstore.STATS['disk_hits'] == 1
    assert g1.save_export() is None
    got = _pull(g1)
    assert np.array_equal(got, want), int(np.sum(got != want))
    # the same renderers: keys, carries and table layouts
    for a, b in zip(_renderers(g0), _renderers(g1), strict=True):
        assert type(a) is type(b) and a.key == b.key
        if isinstance(a, FlatSegment):
            assert a.carry_spec() == b.carry_spec()
            assert [t.layout for t in [a.dyn] + a.xs] \
                == [t.layout for t in [b.dyn] + b.xs]
        else:
            assert a.tabs.layout == b.tabs.layout


def test_fresh_process_loads_the_artifact(store):
    script = ROUND_TRIP['bank8']
    g0 = _gen(script)
    ref = g0.assemble(g0.render_device())
    g0.save_export()
    code = (
        'import hashlib, json, os, sys\n'
        'import saugns_tpu_torch as stt\n'
        'from saugns_tpu_torch.render import aotstore\n'
        'from saugns_tpu_torch.render.engine import TorchGenerator\n'
        'g = TorchGenerator(stt.compile_script(sys.argv[1]), %d, '
        'os.environ["SAUGNS_TPU_TORCH_DEVICE"])\n'
        'out = g.assemble(g.render_device())\n'
        'print(json.dumps({"source": g.source, "stats": aotstore.STATS,\n'
        '  "jax": "jax" in sys.modules,\n'
        '  "sha": hashlib.sha256(out.tobytes()).hexdigest()}))\n'
        % SRATE)
    env = dict(os.environ, SAUGNS_TPU_TORCH_DEVICE='cpu',
               PYTHONPATH=ROOT, SAUGNS_TPU_CACHE=str(store / 'cache'))
    r = subprocess.run([sys.executable, '-c', code, script], env=env,
                       capture_output=True, text=True, timeout=300,
                       cwd=str(store))
    assert r.returncode == 0, r.stderr
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got['source'] == 'disk' and not got['jax']
    assert got['stats']['disk_hits'] == 1
    assert got['stats']['corrupt'] == 0
    assert got['sha'] == hashlib.sha256(ref.tobytes()).hexdigest()


def _rewrite(path, fn):
    """Rewrite an artifact's header (a dict) through ``fn``, keeping its
    payload."""
    data = open(path, 'rb').read()
    nl = data.index(b'\n', len(aotstore.MAGIC))
    head = json.loads(data[len(aotstore.MAGIC):nl])
    fn(head)
    with open(path, 'wb') as f:
        f.write(aotstore.MAGIC + json.dumps(head).encode() + b'\n'
                + data[nl + 1:])


@pytest.mark.parametrize('damage', ['truncated', 'version', 'header',
                                    'payload'])
def test_corrupt_artifact_is_a_counted_miss(damage):
    script = ROUND_TRIP['noise_rasg']
    g0 = _gen(script)
    p = g0.save_export()
    ref = g0.assemble(g0.render_device())
    aotstore.clear()
    if damage == 'truncated':
        data = open(p, 'rb').read()
        open(p, 'wb').write(data[:len(data) // 2])
    elif damage == 'version':
        _rewrite(p, lambda h: h.update(format=aotstore.FORMAT + 1))
    elif damage == 'header':
        _rewrite(p, lambda h: h['fields'].update(srate=8000))
    else:
        data = bytearray(open(p, 'rb').read())
        data[-10] ^= 0xff
        open(p, 'wb').write(bytes(data))
    aotstore.reset_stats()
    g1 = _gen(script)
    assert g1.source == 'baked'
    assert aotstore.STATS['corrupt'] == 1
    assert aotstore.STATS['misses'] == 1
    assert aotstore.STATS['disk_hits'] == 0
    assert g1.device == torch.device('cpu') and not g1.plain
    assert np.array_equal(_pull(g1), ref)
    assert np.array_equal(ref, _jax(script))


def _unicode(text):
    b = text.encode()
    return b'\x8c' + bytes([len(b)]) + b   # SHORT_BINUNICODE


@pytest.mark.parametrize('name', [
    ('saugns_tpu_torch.render.aotstore', 'os.system'),
    ('os', 'system'),
    ('saugns_tpu_torch.render.engine', 'TorchGenerator')])
def test_planted_payload_is_a_counted_miss(name, store):
    """A payload that names a function or class outside the artifact's
    own (through a dotted name in a module of the port, another module,
    or another class of the port) under a header that matches it runs
    nothing: a counted miss that renders as without the store."""
    script = ROUND_TRIP['wosc_selfpm']
    g0 = _gen(script)
    ref = g0.assemble(g0.render_device())
    p = g0.save_export()
    marker = store / 'ran'
    # protocol 4: STACK_GLOBAL(module, name)(command), as `R`educe
    payload = (b'\x80\x04' + _unicode(name[0]) + _unicode(name[1])
               + b'\x93' + _unicode('touch ' + str(marker)) + b'\x85R.')

    def plant(head):
        head.update(bytes=len(payload),
                    sha256=hashlib.sha256(payload).hexdigest())
    _rewrite(p, plant)
    data = open(p, 'rb').read()
    nl = data.index(b'\n', len(aotstore.MAGIC))
    open(p, 'wb').write(data[:nl + 1] + payload)
    del g0
    gc.collect()
    aotstore.clear()
    aotstore.reset_stats()
    g1 = _gen(script)
    assert not marker.exists()
    assert g1.source == 'baked'
    assert aotstore.STATS['corrupt'] == 1
    assert aotstore.STATS['disk_hits'] == 0
    assert np.array_equal(g1.assemble(g1.render_device()), ref)


@pytest.mark.parametrize('which', ['user', 'pack'])
def test_user_directory_before_pack(which):
    script = ROUND_TRIP['wosc_selfpm']
    g0 = _gen(script)
    ref = g0.assemble(g0.render_device())
    p = g0.save_export()
    pack = aotstore._pack_dir('cpu')
    os.makedirs(pack)
    q = os.path.join(pack, os.path.basename(p))
    shutil.copyfile(p, q)
    # the other directory's copy is truncated: reading it would count
    bad = q if which == 'user' else p
    data = open(bad, 'rb').read()
    open(bad, 'wb').write(data[:100])
    aotstore.clear()
    aotstore.reset_stats()
    g1 = _gen(script)
    assert g1.source == 'disk' and aotstore.STATS['disk_hits'] == 1
    assert aotstore.STATS['corrupt'] == (0 if which == 'user' else 1)
    assert np.array_equal(g1.assemble(g1.render_device()), ref)


def test_export_off_touches_nothing(monkeypatch):
    monkeypatch.setenv('SAUGNS_TPU_EXPORT', '0')
    script = ROUND_TRIP['bank8']
    g0 = _gen(script)
    assert g0.save_export() is None
    ref = g0.assemble(g0.render_device())
    g1 = _gen(script)
    got = _pull(g1)
    assert np.array_equal(got, ref) and np.array_equal(got, _jax(script))
    assert g1.source == 'baked' and g1.graph_stats()['captures'] > 0
    assert not os.path.exists(aotstore._user_dir('cpu'))
    assert aotstore.live() == 0
    assert all(v == 0 for v in aotstore.STATS.values())


# -- the memory tier ---------------------------------------------------------

def _drop(*gens):
    """Drop the caller's last references to ``gens`` (their prepared
    renders go to the memory tier)."""
    del gens
    gc.collect()


def test_second_generator_takes_the_live_render():
    script = ROUND_TRIP['bank8']
    want = _jax(script)
    g0 = _gen(script)
    g0.save_export()
    assert np.array_equal(g0.assemble(g0.render_device()), want)
    st0 = g0.graph_stats()
    assert st0['source'] == 'baked' and st0['captures'] > 0
    # a live generator keeps its render
    assert aotstore.live() == 0
    del g0
    _drop()
    assert aotstore.live() == 1
    g1 = _gen(script)
    assert g1.source == 'memory' and aotstore.live() == 0
    assert aotstore.STATS['disk_hits'] == 0
    assert aotstore.STATS['mem_hits'] == 1
    got = g1.assemble(g1.render_device())
    assert np.array_equal(got, want)
    st1 = g1.graph_stats()
    assert st1['source'] == 'memory' and st1['captures'] == 0
    assert st1['replays'] == 1
    # the stream's graphs are others: captured on their first use
    assert np.array_equal(_pull(g1), want)
    # while g1 lives, another generator of the key prepares its own
    g2 = _gen(script)
    assert g2.source == 'disk' and g2.graph_stats()['captures'] == 0
    assert np.array_equal(g2.assemble(g2.render_device()), want)
    assert g2.graph_stats()['captures'] > 0
    # a never-exported program keeps nothing
    g3 = _gen('Wsin f330 t.2')
    g3.render_device()
    del g3
    _drop()
    assert aotstore.live() == 0
    del g1, g2
    _drop()
    assert aotstore.live() == 2
    assert aotstore.STATS['mem_hits'] == 1


def test_unfinished_render_stays_out_of_the_tier(monkeypatch):
    """A generator dropped before a render completed, or after one
    raised, hands nothing to the memory tier."""
    script = ROUND_TRIP['noise_rasg']
    g0 = _gen(script)
    g0.save_export()
    del g0
    _drop()
    assert aotstore.live() == 0
    g1 = _gen(script)
    assert g1.source == 'disk'
    want = g1.assemble(g1.render_device())
    run = graphs.Dispatch.run

    def failing(self, *a, **kw):
        raise RuntimeError('a failed render')

    monkeypatch.setattr(graphs.Dispatch, 'run', failing)
    with pytest.raises(RuntimeError):
        g1.render_device()
    monkeypatch.setattr(graphs.Dispatch, 'run', run)
    del g1
    _drop()
    assert aotstore.live() == 0
    g2 = _gen(script)
    assert g2.source == 'disk'
    assert np.array_equal(g2.assemble(g2.render_device()), want)
    del g2
    _drop()
    assert aotstore.live() == 1


def test_two_live_generators_interleaved():
    script = ROUND_TRIP['pm_smoothchange']
    want = _jax(script)
    g0 = _gen(script)
    g0.save_export()
    g0.render_device()
    del g0
    _drop()
    g1, g2 = _gen(script), _gen(script)
    outs = {1: [], 2: []}
    bufs = {1: np.zeros(2 * 500, np.int16), 2: np.zeros(2 * 500, np.int16)}
    more = {1: True, 2: True}
    while more[1] or more[2]:
        for k, g in ((1, g1), (2, g2)):
            if more[k]:
                more[k], n = g.run(bufs[k], 500, True)
                outs[k].append(bufs[k][:2 * n].copy())
    assert (g1.source, g2.source) == ('memory', 'disk')
    assert g1._disp is not g2._disp
    assert {t.data_ptr() for t in g1._disp.st}.isdisjoint(
        t.data_ptr() for t in g2._disp.st)
    for k in (1, 2):
        got = np.concatenate(outs[k]).reshape(-1, 2)
        assert np.array_equal(got, want), k
    assert aotstore.live() == 0
    del g, g1, g2
    _drop()
    assert aotstore.live() == 2


def test_live_tier_bound():
    for k in range(aotstore.LIVE_MAX + 2):
        g = _gen('Wsin f%d t.1' % (200 + 10 * k))
        g.save_export()
        g.render_checksum()
        del g
        _drop()
        assert aotstore.live() == min(k + 1, aotstore.LIVE_MAX)
    # the oldest went; the newest waits
    assert _gen('Wsin f200 t.1').source == 'disk'
    assert aotstore.STATS['mem_hits'] == 0
    g = _gen('Wsin f%d t.1' % (200 + 10 * (aotstore.LIVE_MAX + 1)))
    assert g.source == 'memory' and aotstore.STATS['mem_hits'] == 1
    aotstore.clear()
    assert aotstore.live() == 0


def test_threads_never_share_a_live_render(monkeypatch):
    """More threads than cores render one stored key at once: no
    dispatch runs in two threads at a time, every output is right."""
    script = ROUND_TRIP['noise_rasg']
    want = _jax(script)
    prg = stt.compile_script(script)
    g0 = TorchGenerator(prg, SRATE, 'cpu')
    g0.save_export()
    g0.render_device()
    del g0
    _drop()
    lock = threading.Lock()
    inside, clashes, errors, sources = {}, [], [], []
    run = graphs.Dispatch.run

    def watched(self, *a, **kw):
        me = threading.get_ident()
        with lock:
            if inside.get(id(self), me) != me:
                clashes.append(id(self))
            inside[id(self)] = me
        try:
            return run(self, *a, **kw)
        finally:
            with lock:
                inside.pop(id(self), None)

    monkeypatch.setattr(graphs.Dispatch, 'run', watched)

    def work():
        try:
            for _ in range(3):
                g = TorchGenerator(prg, SRATE, 'cpu')
                got = g.assemble(g.render_device())
                sources.append(g.source)
                if not np.array_equal(got, want):
                    errors.append(int(np.sum(got != want)))
        except Exception as e:   # reported below
            errors.append(repr(e))

    n = 2 * (os.cpu_count() or 4)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors and not clashes
    assert len(sources) == 3 * n and 'memory' in sources
    assert aotstore.STATS['corrupt'] == 0 and aotstore.STATS['saves'] == 1
    assert aotstore.live() <= aotstore.LIVE_MAX
