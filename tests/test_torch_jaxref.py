"""tests/torch_jaxref.py repairs the state a cold build cache can leave
the JAX package in: its native loader gave up (``get_lib()`` None) and
its wave tables fell back to NumPy's, which are not the tables the
committed goldens were made with."""
import json

import jax

jax.config.update('jax_platforms', 'cpu')

from saugns_tpu import native  # noqa: E402
from saugns_tpu.dsp import wavetables as W  # noqa: E402
from saugns_tpu.render import jdsp  # noqa: E402
from tests.test_torch_goldens import GOLDEN, table_sha256  # noqa: E402
from tests.torch_jaxref import ensure_native_tables  # noqa: E402


def test_repairs_fallen_back_tables():
    with open(GOLDEN) as f:
        want = json.load(f)['pilut_sha256']
    saved = (native._lib, native._tried, W._cache, jdsp._luts,
             jdsp._piluts)
    try:
        native._lib, native._tried, W._cache = None, True, None
        jdsp._luts = jdsp._piluts = None
        assert table_sha256(jdsp.get_tables()[1]) != want
        ensure_native_tables()
        assert native._lib is not None
        assert table_sha256(W.get_tables()[1]) == want
        assert table_sha256(jdsp.get_tables()[1]) == want
    finally:
        (native._lib, native._tried, W._cache, jdsp._luts,
         jdsp._piluts) = saved


def test_keeps_native_tables():
    """With the native tables in place it changes nothing."""
    ensure_native_tables()
    state = (native._lib, W._cache, jdsp._luts, jdsp._piluts)
    ensure_native_tables()
    assert all(a is b for a, b in zip(
        state, (native._lib, W._cache, jdsp._luts, jdsp._piluts)))
