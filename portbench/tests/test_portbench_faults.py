"""Whole runs on the CPU stand-in at a tiny size, through the same
files as on the card: a sound run is correct, and each fault planted
under the timed path makes ``correct`` false."""
import pytest

from conftest import run_cell

CELLS = ['pm_voices.tiny.generator', 'selfpm_voices.tiny.slab',
         'pm_voices.tiny.slab', 'selfpm_voices.tiny.generator']


@pytest.mark.parametrize('cell', CELLS)
def test_sound_run_is_correct(tiny, capsys, cell):
    rc, res = run_cell(tiny, cell, capsys=capsys)
    assert rc == 0
    assert res['correct'] is True
    assert res['attempted'] >= 1 and res['failed'] == 0
    assert list(res)[-1] == 'checks'
    if cell.endswith('generator'):
        want = {'audio_rate.cold', 'setup_s'}
    else:
        want = {'audio_rate', 'render_p95_ms', 'setup_s'}
    assert set(res['metrics']) == want
    assert res['device']['platform'] == 'gpu'


@pytest.mark.parametrize('cell', ['pm_voices.tiny.slab',
                                  'pm_voices.tiny.generator'])
def test_trace_run_reports_per_layer(tiny, capsys, cell):
    rc, res = run_cell(tiny, cell, trace=1, capsys=capsys)
    assert rc == 0 and res['correct'] is True
    assert 'audio_rate' not in res['metrics']
    sfx = '.cold' if cell.endswith('generator') else ''
    assert {'frontend.compile_ms' + sfx, 'plan.host_ms' + sfx,
            'dispatch.capture_s' + sfx} <= set(res['metrics'])
    assert not any(m.endswith('.cold') != bool(sfx)
                   for m in res['metrics'])


def _patch_request(monkeypatch, fn):
    """Wrap every entry's ``request`` in ``fn(entry, answer)`` (the
    entries are loaded from the copy's files, so the classes are
    patched where they are made)."""
    from harness import cells
    orig = cells.entry

    def entry(name, base=None):
        cls = orig(name, base) if base else orig(name)
        inner = cls.request

        def request(self):
            return fn(self, inner(self))
        return type(cls.__name__, (cls,), {'request': request})
    monkeypatch.setattr(cells, 'entry', entry)


FAST = ['pm_voices.tiny.generator', 'pm_voices.tiny.slab']


@pytest.mark.parametrize('cell', FAST)
def test_an_answer_altered(tiny, capsys, monkeypatch, cell):
    """One value of every answer altered where it is produced."""
    def alter(self, out):
        out = out.copy()
        out[len(out) // 2, 0] += 300
        return out
    _patch_request(monkeypatch, alter)
    rc, res = run_cell(tiny, cell, capsys=capsys)
    assert rc == 0 and res['correct'] is False


@pytest.mark.parametrize('cell', FAST)
def test_a_stale_answer(tiny, capsys, monkeypatch, cell):
    """A render that hands back its previous answer (its state
    unchanged): the other program's, as the programs alternate (the
    set-up's first renders start the chain)."""
    box = {}

    def stale(self, out):
        prev = box.get('prev')
        box['prev'] = out
        return out if prev is None else prev
    _patch_request(monkeypatch, stale)
    rc, res = run_cell(tiny, cell, capsys=capsys)
    assert rc == 0 and res['correct'] is False


def test_half_the_voices_left_out(tiny, capsys, monkeypatch):
    """Every other slab of voices left out of the mix (the batch cut in
    half under BankRender)."""
    from saugns_tpu_torch.parallel import voicebank
    monkeypatch.setenv('SAUGNS_TPU_BANK_SLAB_BUDGET', str(2 * 4800))
    inner = voicebank.BankRender._slab
    seen = {'n': 0}

    def half(self, sh, seg):
        seen['n'] += 1
        if seen['n'] % 2 == 0:
            return None
        return inner(self, sh, seg)
    monkeypatch.setattr(voicebank.BankRender, '_slab', half)
    rc, res = run_cell(tiny, 'pm_voices.tiny.slab', capsys=capsys)
    assert rc == 0 and res['correct'] is False
