"""Reference hashes of the second slice's renders at 96 kHz.

``tests/golden/torch_slice2.json`` holds, for each entry, the SAU
script, its frame count and the sha256 of the int16 stereo output of
``saugns_tpu``'s ``JaxGenerator`` on the CPU platform, plus the sha256
of the wave tables that render used. ``chip_smoke.py`` renders the same
scripts with the port on the card and holds them against these hashes
without importing JAX.

The 1024-voice banks (the PM bank of the first slice and the self-PM
bank) are rendered by ``saugns_tpu``'s ``BankRender`` on one device
with the ordered mix, which that package documents and tests as
bit-identical to ``JaxGenerator`` (tests/test_voicebank.py).
``JaxGenerator`` compiles one function over all of a bank's stages,
which for the self-PM bank did not finish in 50 minutes on a CPU;
``BankRender`` compiles one voice and maps it over the bank (about
20 s). A test below holds ``BankRender`` against the ``JaxGenerator``
hash of the 16-voice entry.

Regenerate the file (all entries, a few minutes) with:

    python tests/test_torch_goldens.py

or only some entries, keeping the others, with their names as
arguments.

The entries of ``SEQ`` hold the sequential-scan engine's renders:
``JaxGenerator`` makes them with ``SAUGNS_TPU_FLAT=0`` (every epoch on
its sequential scan), which is what the port's sequential engine is
held against; their files record it as ``"flat": false``.

The tier-1 test below recomputes every entry except those marked
``"main_only"`` and checks them against the file (the ``SEQ`` entries
in test_torch_seq_goldens.py). Tolerance: equal hashes, i.e. byte-equal
output.
"""
import hashlib
import json
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, 'tests', 'golden', 'torch_slice2.json')
SRATE = 96000

RASG_SELFPM = 'Rcos mf f60 p.a.5[Rlin f7 a.4] a.6 t%s'
FLAGSHIP_SCRIPT = (
    "Wsin t1 f500.r501[Wsin f1] p[Wsin f400.r800[Wsqr f1.r10[Wsin f50]]]"
    " a.8 c[Wsin f.5]"
)
HETERO3 = ("Wsin f440 t0.3 a.4 p[Wsin r2 a.5]\n"
           "Nwh a0.2 t0.25\n"
           "Rlin f200 t0.2 a.3\n")
HETERO3_SELFPM = ("Wsin f440 t0.3 a.4 p.a.4\n"
                  "Nwh a0.2 t0.25\n"
                  "Rlin f200 t0.2 a.3 p.a.3\n")
# entries made by JaxGenerator with SAUGNS_TPU_FLAT=0
SEQ = ('pm_smoothchange', 'seq_flagship', 'seq_bank_16',
       'seq_selfmod_bank_16')


def entries():
    """name -> (script, main_only, plain). ``plain``: chip_smoke also
    renders the entry on the plain path (its duration keeps that
    render short); ``main_only``: only the __main__ below makes it,
    with BankRender."""
    sys.path.insert(0, ROOT)
    from saugns_tpu_torch.parallel.voicebank import (
        make_bank_script, make_selfmod_bank_script)
    e = {}
    for c in ('wh', 'gw', 'bw', 'tw', 're', 'vi', 'bv'):
        e['noise_' + c] = ('N%s t.3 a.4' % c, False, True)
    for m in 'ugbtfa':
        e['rasg_m' + m] = ('Rlin m%s t.3 f300 a.5' % m, False, True)
    e['rasg_lin'] = ('Rlin t.4 f300 a.5', False, True)
    e['rasg_fm'] = ('Rcos t.4 f80.r160[Wsin f2] a.7', False, True)
    e['wosc_selfpm'] = ('Wsin f110 t.2 p.a.3', False, True)
    e['rasg_selfpm_short'] = (RASG_SELFPM % '.2', False, True)
    e['selfmod_bank_8'] = (make_selfmod_bank_script(8, seed=0,
                                                    duration=0.05),
                           False, True)
    e['rasg_selfpm_10s'] = (RASG_SELFPM % '10', False, False)
    e['selfmod_bank_16'] = (make_selfmod_bank_script(16, seed=0,
                                                     duration=1.0),
                            False, False)
    e['selfmod_bank_1024'] = (make_selfmod_bank_script(1024, seed=0,
                                                       duration=1.0),
                              True, False)
    e['pm_bank_1024'] = (make_bank_script(1024, seed=0, duration=1.0),
                         True, False)
    # the pattern of pm_smoothchange.sau: an epoch HostSim cannot bake
    e['pm_smoothchange'] = ('Wsin f220 t1 p[Wsin f50 /.3 r[g3 t.3]]',
                            False, False)
    e['seq_flagship'] = (FLAGSHIP_SCRIPT, False, False)
    e['seq_bank_16'] = (make_bank_script(16, seed=0, duration=1.0), False,
                        False)
    # JaxGenerator's sequential scan and flat path differ on the 16-voice
    # banks at 96 kHz by 1 LSB in a few samples (ROADMAP section C), so
    # the sequential engine has its own entry of the self-PM bank
    e['seq_selfmod_bank_16'] = (e['selfmod_bank_16'][0], False, False)
    # the mesh renderers' scripts (chip_smoke.py phase 15 renders them
    # through MeshRender and BankRender on two shards, and on the plain
    # path): the heterogeneous program of the JAX package's dry run, its
    # self-PM variant (tests/test_meshrender.py) and 13 voices
    e['hetero3'] = (HETERO3, False, False)
    e['hetero3_selfpm'] = (HETERO3_SELFPM, False, False)
    e['bank_13'] = (make_bank_script(13, seed=1, duration=1.0), False,
                    False)
    # 48 notes of one template: 48 segments that share one captured
    # graph (tests/test_torch_dispatch.py)
    e['notes_seq'] = (' | '.join('Wsin f%d t.05 a.4 p[Wsin r2 a.3]'
                                 % (196 + 7 * k) for k in range(48)),
                      False, True)
    return e


def table_sha256(piluts):
    return hashlib.sha256(
        np.ascontiguousarray(piluts, np.float32).tobytes()).hexdigest()


def jax_render(script, flat=True):
    """(frames, sha256) of JaxGenerator's int16 stereo output;
    ``flat=False`` renders with SAUGNS_TPU_FLAT=0."""
    from saugns_tpu.lang.program import ScriptArg, build_program
    from saugns_tpu.render import engine as jeng
    prg = build_program(ScriptArg(str=script, is_path=False,
                                  no_time=True, predef=[]))
    old = os.environ.get('SAUGNS_TPU_FLAT')
    os.environ['SAUGNS_TPU_FLAT'] = '1' if flat else '0'
    try:
        gen = jeng.JaxGenerator(prg, SRATE)
    finally:
        if old is None:
            del os.environ['SAUGNS_TPU_FLAT']
        else:
            os.environ['SAUGNS_TPU_FLAT'] = old
    buf = np.zeros(1 << 16, np.int16)
    h = hashlib.sha256()
    frames = 0
    while True:
        more, n = gen.run(buf, len(buf) // 2, True)
        h.update(buf[:2 * n].astype('<i2').tobytes())
        frames += n
        if not more:
            break
    return frames, h.hexdigest()


def bank_render(script):
    """(frames, sha256) of BankRender's int16 stereo output (one
    device, the engine's left-to-right voice mix)."""
    from saugns_tpu.lang.program import ScriptArg, build_program
    from saugns_tpu.parallel.voicebank import BankRender
    prg = build_program(ScriptArg(str=script, is_path=False,
                                  no_time=True, predef=[]))
    mix = np.asarray(BankRender(prg, SRATE, mesh=None,
                                ordered_mix=True).render_i16())
    return len(mix), hashlib.sha256(mix.astype('<i2').tobytes()) \
        .hexdigest()


def load():
    with open(GOLDEN) as f:
        return json.load(f)


@pytest.fixture(autouse=True, scope='module')
def _jax_native_tables():
    """The JAX package renders with its native wave tables, also on a
    cold build cache (tests/torch_jaxref.py)."""
    from tests.torch_jaxref import ensure_native_tables
    ensure_native_tables()


def _recomputed():
    return [n for n, (_, main_only, _) in entries().items()
            if not main_only and n not in SEQ]


@pytest.mark.parametrize('name', _recomputed())
def test_golden_entry(name):
    from saugns_tpu.render import jdsp
    g = load()
    assert g['srate'] == SRATE
    assert g['pilut_sha256'] == table_sha256(jdsp.get_tables()[1])
    script = entries()[name][0]
    ent = g['entries'][name]
    assert ent['script'] == script
    frames, digest = jax_render(script)
    assert (frames, digest) == (ent['frames'], ent['sha256'])


def test_bank_render_matches_jax_generator_hash():
    """The maker of the 1024-voice entry gives the JaxGenerator hash
    of the 16-voice bank."""
    ent = load()['entries']['selfmod_bank_16']
    assert bank_render(ent['script']) == (ent['frames'], ent['sha256'])


def test_golden_file_lists_every_entry():
    g = load()
    e = entries()
    assert sorted(g['entries']) == sorted(e)
    for name, (script, main_only, plain) in e.items():
        ent = g['entries'][name]
        assert ent['script'] == script
        assert ent['main_only'] == main_only and ent['plain'] == plain
        assert ent['frames'] > 0 and len(ent['sha256']) == 64
        assert ent.get('flat', True) == (name not in SEQ)


def main(names):
    import jax
    jax.config.update('jax_platforms', 'cpu')
    sys.path.insert(0, ROOT)
    from saugns_tpu.render import jdsp
    from tests.torch_jaxref import ensure_native_tables
    ensure_native_tables()
    e = entries()
    out = {'srate': SRATE,
           'made_by': 'saugns_tpu JaxGenerator, CPU platform, int16 '
                      'stereo, little-endian, interleaved',
           'pilut_sha256': table_sha256(jdsp.get_tables()[1]),
           'entries': {}}
    if names:
        old = load()
        if old['pilut_sha256'] != out['pilut_sha256']:
            raise SystemExit('the wave tables changed: regenerate all')
        out['entries'] = {k: v for k, v in old['entries'].items()
                          if k in e}
    for name in names or e:
        script, main_only, plain = e[name]
        if main_only:
            frames, digest = bank_render(script)
        else:
            frames, digest = jax_render(script, flat=name not in SEQ)
        out['entries'][name] = {'script': script, 'frames': frames,
                                'sha256': digest,
                                'main_only': main_only, 'plain': plain}
        if name in SEQ:
            out['entries'][name]['flat'] = False
        print(name, frames, digest, flush=True)
    with open(GOLDEN, 'w') as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write('\n')


if __name__ == '__main__':
    main(sys.argv[1:])
