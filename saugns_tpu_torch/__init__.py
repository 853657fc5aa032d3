"""saugns_tpu_torch: the SAU (Scriptable AUdio) language compiler and
renderer of ``saugns_tpu``, ported to PyTorch and CUDA.

- ``saugns_tpu_torch.lang``, ``dsp``, ``io``, ``utils`` and
  ``render.plan``/``hostsim``/``linestate`` are copies of the host half
  of ``saugns_tpu`` (scanner, parser, Program IR, wave tables, planner,
  host state bake, WAV writer), so the port needs neither JAX nor the
  JAX package.
- ``saugns_tpu_torch.render`` renders a program on a torch device
  (``render.engine.TorchGenerator``): flat segments (``render.flat``)
  and the sequential-scan engine for epochs the host bake cannot flatten,
  through nine hand-written CUDA kernels (``kernels``, sources in
  ``csrc/``: the oscillator fill, the u32, u64 and max look-back scans,
  the wave and RasG self-PM recurrences, the wave-table tap gathers,
  the phase-to-value Is() gather and the forward fill). On the card
  every render replays CUDA graphs (``render.graphs``);
  ``render.aotstore`` keeps a program's host products on disk and a
  dropped generator's graphs in the process for the next generator of
  its key.
- ``saugns_tpu_torch.parallel`` renders a program's voices, or a list
  of programs, across several devices (``BankRender``, ``MeshRender``,
  ``ShardedRenderQueue``), and each segment's block rows across them
  (``TimeShardRender``, the time axis, in CUDA graphs between its
  exchanges).
"""

__version__ = "0.1.0"
SAU_VERSION_COMPAT = "v0.4.7"

from .lang.program import Program, build_program  # noqa: F401,E402
# load the `render` subpackage before binding the `render` function,
# so a later `from .render.engine import ...` cannot rebind the name
from . import render as _render_pkg  # noqa: F401,E402
from .api import (SAUError, compile_script, render,  # noqa: F401,E402
                  write_wav)
