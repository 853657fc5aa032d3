"""The port stands alone: importing any module of saugns_tpu_torch pulls
in neither JAX nor the JAX package (the card's machine has no JAX).
Exact checks, no tolerance."""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, 'saugns_tpu_torch')


def _modules():
    mods = []
    for dirpath, _dirs, files in os.walk(PKG):
        for f in sorted(files):
            if not f.endswith('.py'):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[:-3]
            mod = rel.replace(os.sep, '.')
            if mod.endswith('.__init__'):
                mod = mod[:-len('.__init__')]
            if mod.endswith('.__main__'):
                continue  # runs the CLI when imported
            mods.append(mod)
    return sorted(mods)


def _forbidden(name):
    return (name == 'jax' or name.startswith('jax.')
            or name == 'jaxlib' or name.startswith('jaxlib.')
            or name == 'saugns_tpu' or name.startswith('saugns_tpu.'))


def test_forbidden_name_check():
    assert _forbidden('saugns_tpu') and _forbidden('saugns_tpu.api')
    assert _forbidden('jax.numpy')
    assert not _forbidden('saugns_tpu_torch')
    assert not _forbidden('saugns_tpu_torch.render.tdsp')


def test_import_every_module_in_a_fresh_process():
    mods = _modules()
    assert 'saugns_tpu_torch.render.flat' in mods
    assert 'saugns_tpu_torch.parallel.timeshard' in mods
    code = ('import sys\n'
            'sys.path.insert(0, %r)\n'
            'for m in %r:\n'
            '    __import__(m)\n'
            'print("\\n".join(sorted(sys.modules)))\n' % (ROOT, mods))
    env = dict(os.environ)
    env.pop('PYTHONPATH', None)
    r = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr
    loaded = r.stdout.split()
    assert 'saugns_tpu_torch.render.engine' in loaded
    assert [m for m in loaded if _forbidden(m)] == []


@pytest.mark.parametrize('path', sorted(
    os.path.join(dp, f) for dp, _d, fs in os.walk(PKG) for f in fs
    if f.endswith('.py')) + [os.path.join(ROOT, 'chip_smoke.py')])
def test_no_forbidden_import_statement(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ''):
                bad.append(node.module)
    assert bad == []
