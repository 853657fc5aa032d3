"""Whole renders on the port's sequential-scan engine against
JaxGenerator with ``SAUGNS_TPU_FLAT=0`` (the second half of the wave
slice's scripts; see test_torch_seq_render.py), and the handover from a
flat epoch to a sequential one on the default generators. 6 kHz,
stereo and mono. Tolerance: byte-equality of the int16 output."""
import os
import sys

import numpy as np
import pytest

import jax

jax.config.update('jax_platforms', 'cpu')

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_engine import SCRIPTS  # noqa: E402
from test_torch_seq_render import STEREO, check_seq, seq_pair  # noqa: E402
from tests.torch_jaxref import ensure_native_tables  # noqa: E402


@pytest.fixture(autouse=True, scope='module')
def _jax_native_tables():
    """The JAX package renders with its native wave tables, also on a
    cold build cache (tests/torch_jaxref.py)."""
    ensure_native_tables()


# a plain note, then the ratio-flip pattern of pm_smoothchange.sau:
# epoch 0 renders flat, epoch 1 (which HostSim cannot bake)
# sequentially, and reads every host-authoritative column the flat
# renderer wrote from HostSim's end tables
HANDOVER = 'Wsin f330 t.2 /.2 Wsin f220 t.5 p[Wsin f50 /.2 r[g3 t.2]]'


@STEREO
@pytest.mark.parametrize('script', SCRIPTS[6:])
def test_sequential_byte_equal(script, stereo, monkeypatch):
    check_seq(script, stereo, monkeypatch)


@STEREO
def test_flat_to_sequential_handover(stereo, monkeypatch):
    want, got, tg = seq_pair(HANDOVER, 6000, stereo, monkeypatch,
                             flat=True)
    assert [tg.sequential(ei) for ei in range(len(tg.plan.epochs))] \
        == [False, True]
    assert len(got) == (4200 * 2 if stereo else 4200)
    assert np.array_equal(got, want), int(np.sum(got != want))


@STEREO
def test_handover_all_sequential(stereo, monkeypatch):
    check_seq(HANDOVER, stereo, monkeypatch)
