"""Nothing under portbench/ imports JAX or the JAX package (top-level
names compared whole: ``saugns_tpu_torch`` is the port), the reference
imports nothing of the port, and the harness fails without a card."""
import ast
import json
import os
import subprocess
import sys

import pytest

from conftest import BASE, ROOT

BANNED = {'jax', 'jaxlib', 'flax', 'saugns_tpu'}


def modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, 'attr', getattr(node.func, 'id', '')) in (
                    'import_module', '__import__') and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            yield node.args[0].value


def sources(d):
    for dp, _d, fs in os.walk(d):
        for f in fs:
            if f.endswith('.py'):
                yield os.path.join(dp, f)


def test_no_jax_anywhere():
    found = [(p, m) for p in sources(BASE) for m in modules(p)
             if m.split('.')[0] in BANNED]
    assert not found


def test_the_reference_imports_nothing_of_the_port():
    ref = os.path.join(BASE, 'reference')
    found = [(p, m) for p in sources(ref) for m in modules(p)
             if m.split('.')[0] not in ('numpy', 'math', 'importlib',
                                        '__future__')]
    assert not found


def test_top_level_names_compared_whole():
    assert 'saugns_tpu_torch'.split('.')[0] not in BANNED
    assert 'saugns_tpu.lang'.split('.')[0] in BANNED


def test_no_card_no_result():
    """Without a CUDA card the command exits with an error and prints
    no result line (a torch without CUDA, or the cards hidden)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    r = subprocess.run([sys.executable, 'portbench/run.py', '--workload',
                        'pm_voices.bank1024.slab', '--seed', '1',
                        '--seconds', '1', '--trace', '0'], cwd=ROOT,
                       env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert not any(ln.startswith('{') for ln in r.stdout.splitlines())
    assert 'CUDA' in r.stderr


def test_without_the_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/, the
    command fails and prints no result."""
    import shutil
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), tmp_path)
    shutil.copytree(BASE, tmp_path / 'portbench')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    r = subprocess.run([sys.executable, 'portbench/run.py', '--workload',
                        'pm_voices.bank1024.slab', '--seed', '1',
                        '--seconds', '1', '--trace', '0'],
                       cwd=str(tmp_path), env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert not any(ln.startswith('{') for ln in r.stdout.splitlines())


@pytest.mark.cuda
def test_one_run_on_the_card():
    """One short run of the first cell on the card: a result line with
    correct true (run with ``python -m pytest portbench/tests -m cuda``
    on the card)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    bench = json.load(open(os.path.join(ROOT, 'BENCHMARK.json')))
    cell = bench['workloads'][0]['name']
    r = subprocess.run([sys.executable, 'portbench/run.py', '--workload',
                        cell, '--seed', '5', '--seconds', '3',
                        '--trace', '0'], cwd=ROOT, capture_output=True,
                       text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.splitlines()[-1])['correct'] is True
