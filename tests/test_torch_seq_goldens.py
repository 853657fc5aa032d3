"""Recomputes the golden file's sequential-engine entries
(test_torch_goldens.SEQ: JaxGenerator with SAUGNS_TPU_FLAT=0 at 96 kHz)
and checks them against tests/golden/torch_slice2.json, which
chip_smoke.py holds the port's sequential renders on the card to.
Tolerance: equal hashes, i.e. byte-equal output."""
import os
import sys

import pytest

import jax

jax.config.update('jax_platforms', 'cpu')

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_goldens import (SEQ, entries, jax_render,  # noqa: E402
                                load)
from tests.torch_jaxref import ensure_native_tables  # noqa: E402


@pytest.fixture(autouse=True, scope='module')
def _jax_native_tables():
    """The JAX package renders with its native wave tables, also on a
    cold build cache (tests/torch_jaxref.py)."""
    ensure_native_tables()


@pytest.mark.parametrize('name', SEQ)
def test_seq_golden_entry(name):
    ent = load()['entries'][name]
    script = entries()[name][0]
    assert ent['script'] == script and ent['flat'] is False
    assert jax_render(script, flat=False) == (ent['frames'],
                                              ent['sha256'])
