"""Whole renders on the port's sequential-scan engine on the CPU
against JaxGenerator on the CPU platform with ``SAUGNS_TPU_FLAT=0``
(every epoch on its sequential scan), the port's generator made with
``flat=False``; and the epochs HostSim cannot bake on the default
generators of both. 6 kHz, stereo and mono. Tolerance: byte-equality
of the int16 output. The wave slice's scripts are split over this file
and test_torch_seq_render2.py, which keeps each file's run short."""
import os
import sys

import numpy as np
import pytest

import jax

jax.config.update('jax_platforms', 'cpu')

from saugns_tpu.lang.program import (ScriptArg as JArg,  # noqa: E402
                                     build_program as jbuild)
from saugns_tpu.render import engine as jeng  # noqa: E402
from saugns_tpu.render import jdsp  # noqa: E402
from saugns_tpu_torch import convert  # noqa: E402
from saugns_tpu_torch.lang.program import (ScriptArg as TArg,  # noqa: E402
                                           build_program as tbuild)
from saugns_tpu_torch.render.engine import TorchGenerator  # noqa: E402
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_engine import SCRIPTS, _pull  # noqa: E402
from tests.torch_jaxref import ensure_native_tables  # noqa: E402


@pytest.fixture(autouse=True, scope='module')
def _jax_native_tables():
    """The JAX package renders with its native wave tables, also on a
    cold build cache (tests/torch_jaxref.py)."""
    ensure_native_tables()


# frequencies whose phase step overflows int64 (ROADMAP C1)
C1_SCRIPTS = ['Wsin f20000000000000 t.2',
              'Wsin t.2 f100.r20000000000000[Wsin f2]',
              'Wsin f100 t.2 p[Wsin f7 a.5] a.5 f[g20000000000000 t.2]']

STEREO = pytest.mark.parametrize('stereo', [True, False],
                                 ids=['stereo', 'mono'])


def seq_pair(script, srate, stereo, monkeypatch, flat=False):
    """(JaxGenerator output, port output, the port's generator) for
    ``script``. ``flat=False``: both render every epoch sequentially;
    else both take their default paths. The port is fed the JAX
    package's tables and initial state."""
    monkeypatch.setenv('SAUGNS_TPU_FLAT', '1' if flat else '0')
    jp = jbuild(JArg(str=script, is_path=False, no_time=True, predef=[]))
    tp = tbuild(TArg(str=script, is_path=False, no_time=True, predef=[]))
    jg = jeng.JaxGenerator(jp, srate)
    assert (jg._flat is None) == (not flat)
    _, piluts = convert.tables(*jdsp.get_tables(), 'cpu')
    st0 = convert.state(jeng.make_state(jg.plan), 'cpu')
    tg = TorchGenerator(tp, srate, 'cpu', piluts=piluts, state=st0,
                        flat=flat)
    return _pull(jg, stereo), _pull(tg, stereo), tg


def check_seq(script, stereo, monkeypatch):
    want, got, tg = seq_pair(script, 6000, stereo, monkeypatch)
    assert all(tg.sequential(ei) for ei in range(len(tg.plan.epochs)))
    assert len(got) == len(want) and len(got) > 0
    assert np.any(got != 0)
    assert np.array_equal(got, want), int(np.sum(got != want))


@STEREO
@pytest.mark.parametrize('script', SCRIPTS[:6])
def test_sequential_byte_equal(script, stereo, monkeypatch):
    check_seq(script, stereo, monkeypatch)


@STEREO
@pytest.mark.parametrize('script', C1_SCRIPTS)
def test_c1_sequential_byte_equal(script, stereo, monkeypatch):
    check_seq(script, stereo, monkeypatch)
