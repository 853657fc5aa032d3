"""Self-PM on the port's sequential-scan engine (kernels 5 and 6 as
one-row scans over each block) against JaxGenerator with
``SAUGNS_TPU_FLAT=0``, 6 kHz, stereo and mono: the second slice's
self-PM scripts and an 8-voice self-PM bank. Tolerance: byte-equality
of the int16 output."""
import os
import sys

import pytest

import jax

jax.config.update('jax_platforms', 'cpu')

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from saugns_tpu.parallel.voicebank import \
    make_selfmod_bank_script as jselfbank  # noqa: E402
from saugns_tpu_torch.parallel.voicebank import \
    make_selfmod_bank_script  # noqa: E402
from test_torch_seq_noise import SELFPM  # noqa: E402
from test_torch_seq_render import STEREO, check_seq  # noqa: E402
from tests.torch_jaxref import ensure_native_tables  # noqa: E402


@pytest.fixture(autouse=True, scope='module')
def _jax_native_tables():
    """The JAX package renders with its native wave tables, also on a
    cold build cache (tests/torch_jaxref.py)."""
    ensure_native_tables()


@STEREO
@pytest.mark.parametrize('script', SELFPM)
def test_sequential_byte_equal(script, stereo, monkeypatch):
    check_seq(script, stereo, monkeypatch)


@STEREO
def test_selfmod_bank_sequential(stereo, monkeypatch):
    src = make_selfmod_bank_script(8, duration=0.2)
    assert src == jselfbank(8, duration=0.2)
    check_seq(src, stereo, monkeypatch)
