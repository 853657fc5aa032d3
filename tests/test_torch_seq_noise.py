"""The second slice's noise and RasG scripts on the port's
sequential-scan engine against JaxGenerator with ``SAUGNS_TPU_FLAT=0``,
6 kHz, stereo and mono (the self-PM scripts are in
test_torch_seq_selfpm.py). Tolerance: byte-equality of the int16
output."""
import os
import sys

import pytest

import jax

jax.config.update('jax_platforms', 'cpu')

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_noise_rasg import SCRIPTS  # noqa: E402
from test_torch_seq_render import STEREO, check_seq  # noqa: E402
from tests.torch_jaxref import ensure_native_tables  # noqa: E402


@pytest.fixture(autouse=True, scope='module')
def _jax_native_tables():
    """The JAX package renders with its native wave tables, also on a
    cold build cache (tests/torch_jaxref.py)."""
    ensure_native_tables()


SELFPM = [s for s in SCRIPTS if 'p.a' in s]


@STEREO
@pytest.mark.parametrize('script', [s for s in SCRIPTS
                                    if s not in SELFPM])
def test_sequential_byte_equal(script, stereo, monkeypatch):
    check_seq(script, stereo, monkeypatch)
