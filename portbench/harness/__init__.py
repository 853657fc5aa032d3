"""The benchmark of the PyTorch and CUDA port (``saugns_tpu_torch``).

``portbench/run.py`` is its command. Everything that belongs to one
configuration, traffic mix, entry or per-layer metric is a file of its
own that the harness finds by the name in ``BENCHMARK.json``:

- ``configs/<config>.json``: a deployment (voice line, parameter
  distributions, sample rate, precision, reference kind);
- ``traffic/<traffic>.json``: a traffic mix (entry, voices, duration,
  programs, loop, traced requests);
- ``entries/<entry>.py``: how a request drives the port;
- ``metrics/<metric>.py``: the reader of one per-layer metric;
- ``limits/<config>.json``: the limits of the comparison with the
  reference (``reference/``), which decides ``correct``.
"""
