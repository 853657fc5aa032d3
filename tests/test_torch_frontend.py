"""The port's copied frontend (lang/, dsp/ tables and names, the CLI's
-p/-c paths) against saugns_tpu: the serialized Program and the printed
program info must be identical (exact string equality)."""
import io

import pytest

import jax

jax.config.update('jax_platforms', 'cpu')

from saugns_tpu import cli as jcli  # noqa: E402
from saugns_tpu.lang import serialize as jser  # noqa: E402
from saugns_tpu.lang.program import (ScriptArg as JArg,  # noqa: E402
                                     build_program as jbuild)
from saugns_tpu_torch import cli as tcli  # noqa: E402
from saugns_tpu_torch.lang import serialize as tser  # noqa: E402
from saugns_tpu_torch.lang.program import (ScriptArg as TArg,  # noqa: E402
                                           build_program as tbuild)

from .test_frontend import golden_cases  # noqa: E402

FLAGSHIP_SCRIPT = (
    "Wsin t1 f500.r501[Wsin f1] p[Wsin f400.r800[Wsqr f1.r10[Wsin f50]]]"
    " a.8 c[Wsin f.5]"
)

SCRIPTS = [
    'Wsin',
    FLAGSHIP_SCRIPT,
    'Wsin f600 t.3 p[Wsin r1.5] ; f500 t.3',
    'Wsqr t.4 f80.r160[Wsin f2] a.7',
    'Wsin t.3 f200 c[Wsin f3 a.5]',
    'Wsin t.4 f100 | Wtri t.3 f220',
    'Rlin t.4 f300 a.5',
    'Ntw t.3 a.4',
    'Wsin t1 f200 f[g800 t.5 lexp] a[v.1 g1 t.4 lsmo]',
    "S a.5\nWsin f100 t.3 a[Wsin f5]\nWsaw f$x t.2 /0.1 Wpar f330 t.1",
    'Wsin p.a.4 t.2',
    "'a Wsin f220 t.3 @a f330 ; @a f440 t.2",
]


def _pair(script, predef=(('x', 123.0),)):
    jp = jbuild(JArg(str=script, is_path=False, no_time=True,
                     predef=list(predef)))
    tp = tbuild(TArg(str=script, is_path=False, no_time=True,
                     predef=list(predef)))
    return jp, tp


@pytest.mark.parametrize('script', SCRIPTS)
def test_serialized_program_equal(script):
    jp, tp = _pair(script)
    assert (jp is None) == (tp is None)
    assert tser.program_to_dict(tp) == jser.program_to_dict(jp)
    a, b = io.StringIO(), io.StringIO()
    jp.print_info(a)
    tp.print_info(b)
    assert b.getvalue() == a.getvalue()


def _cli(main, argv, capsys):
    rc = main(list(argv))
    out, err = capsys.readouterr()
    # usage text names the program; the port's CLI is saugns-tpu-torch
    return (rc, out.replace(tcli.NAME, jcli.NAME),
            err.replace(tcli.NAME, jcli.NAME))


@pytest.mark.parametrize('flags', [['-c', '-p'], ['-c'], ['-c', '-p', '-d'],
                                   ['-h'], ['-h', 'wave'], ['-c', '-v']])
def test_cli_check_and_print_equal(flags, capsys):
    argv = flags + ['-e', FLAGSHIP_SCRIPT, 'Wsin t.4 f100 | Wtri t.3 f220']
    assert _cli(tcli.main, argv, capsys) == _cli(jcli.main, argv, capsys)


def test_cli_bad_script_equal(capsys):
    argv = ['-c', '-p', '-e', 'Wsin f[g800 t.5 lzzz] q']
    assert _cli(tcli.main, argv, capsys) == _cli(jcli.main, argv, capsys)


@pytest.mark.parametrize('rel,golden', golden_cases(),
                         ids=[c[0] for c in golden_cases()])
def test_ir_golden_corpus(rel, golden, reference_dir, monkeypatch):
    """The reference corpus scripts, where that corpus is present."""
    monkeypatch.chdir(reference_dir)
    with open(golden) as fh:
        expect = fh.read()
    prg = tbuild(TArg(str=rel, is_path=True, no_time=True, predef=[]))
    out = io.StringIO()
    prg.print_info(out)
    assert out.getvalue() == expect
    jp = jbuild(JArg(str=rel, is_path=True, no_time=True, predef=[]))
    assert tser.program_to_dict(prg) == jser.program_to_dict(jp)
