"""saugns_tpu_torch: the SAU (Scriptable AUdio) language compiler and
renderer of ``saugns_tpu``, ported to PyTorch and CUDA.

- ``saugns_tpu_torch.lang``, ``dsp``, ``io``, ``utils`` and
  ``render.plan``/``hostsim``/``linestate`` are copies of the host half
  of ``saugns_tpu`` (scanner, parser, Program IR, wave tables, planner,
  host state bake, WAV writer), so the port needs neither JAX nor the
  JAX package.
- ``saugns_tpu_torch.render`` renders flat segments eagerly on a torch
  device (``render.engine.TorchGenerator``); its oscillator fill and
  wrapping phase scan are hand-written CUDA kernels (``kernels``,
  sources in ``csrc/``).
- ``saugns_tpu_torch.parallel`` renders a program's voices, or a list
  of programs, across several devices (``BankRender``, ``MeshRender``,
  ``ShardedRenderQueue``).
"""

__version__ = "0.1.0"
SAU_VERSION_COMPAT = "v0.4.7"

from .lang.program import Program, build_program  # noqa: F401,E402
# load the `render` subpackage before binding the `render` function,
# so a later `from .render.engine import ...` cannot rebind the name
from . import render as _render_pkg  # noqa: F401,E402
from .api import (SAUError, compile_script, render,  # noqa: F401,E402
                  write_wav)
