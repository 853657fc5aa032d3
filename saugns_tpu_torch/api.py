"""Public library API of the port: compile and render SAU scripts.

The same pipeline as ``saugns_tpu.api`` -- ``compile_script``,
``render``, ``write_wav`` -- rendered on a torch device by the
generator the player and the CLI choose (``io.player._make_generator``):
a ``TorchGenerator``, or for a program whose voices batch, MeshRender's
grouped slab path on that one device:

    import saugns_tpu_torch as stt

    audio = stt.render("Wsin f440 t1")               # on CUDA
    audio = stt.render("Wsin f440 t1", device="cpu")  # asked for

Rendering runs on CUDA unless the caller passes ``device="cpu"``;
without CUDA it raises RuntimeError before any file is opened.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from . import tracing
from .lang.program import Program, ScriptArg, build_program

__all__ = ['SAUError', 'compile_script', 'render', 'write_wav']

DEFAULT_SRATE = 96000  # saugns.c:49 (DEFAULT_SRATE)


class SAUError(ValueError):
    """A script failed to compile (parse errors go to stderr, matching
    the reference's diagnostics; the exception carries the script
    name)."""


def _resolve_program(source: Optional[str], path: Optional[str],
                     program: Optional[Program],
                     predef: Sequence[Tuple[str, float]] = ()
                     ) -> Program:
    given = sum(x is not None for x in (source, path, program))
    if given != 1:
        raise TypeError('pass exactly one of source=, path=, program= '
                        '(got %d)' % given)
    if program is not None:
        return program
    sa = ScriptArg(str=source if source is not None else path,
                   is_path=path is not None,
                   no_time=True, predef=list(predef))
    with tracing.span('lang.compile'):
        prg = build_program(sa)
    # a failed parse still yields an empty program, whose name stays
    # None (sau/parser.c:2104-2113); the library API raises on it
    if prg is None or prg.name is None:
        raise SAUError('script failed to compile: %r'
                       % (path if path is not None else source))
    return prg


def compile_script(source: Optional[str] = None, *,
                   path: Optional[str] = None,
                   predef: Sequence[Tuple[str, float]] = ()) -> Program:
    """Compile SAU text (or a script file) to a ``Program`` IR.

    Raises ``SAUError`` if the script does not parse; the positioned
    warnings and errors go to stderr as the reference prints them.
    """
    return _resolve_program(source, path, None, predef)


@tracing.traced('render.call')
def render(source: Optional[str] = None, *,
           path: Optional[str] = None,
           program: Optional[Program] = None,
           srate: int = DEFAULT_SRATE,
           stereo: bool = True,
           device=None,
           predef: Sequence[Tuple[str, float]] = (),
           plain: bool = False) -> np.ndarray:
    """Render a script to a ``(samples, channels)`` int16 array.

    ``device``: a torch device; None means CUDA. ``plain=True`` uses
    the plain PyTorch versions of the CUDA kernels (the reference the
    kernels are held against) on a TorchGenerator. Raises RuntimeError
    without CUDA unless ``device="cpu"``.
    """
    from .io.player import _make_generator
    from .render.engine import resolve_device
    dev = resolve_device(device)
    prg = _resolve_program(source, path, program, predef)
    gen = _make_generator(prg, srate, dev, plain=plain)
    ch = 2 if stereo else 1
    buf_len = 4096
    buf = np.zeros(buf_len * ch, dtype=np.int16)
    chunks = []
    while True:
        more, n = gen.run(buf, buf_len, stereo)
        if n:
            chunks.append(buf[:n * ch].copy())
        if not more:
            break
    flat = (np.concatenate(chunks) if chunks
            else np.zeros(0, np.int16))
    return flat.reshape(-1, ch)


def write_wav(out_path: str, source: Optional[str] = None, *,
              path: Optional[str] = None,
              program: Optional[Program] = None,
              srate: int = DEFAULT_SRATE,
              stereo: bool = True,
              device=None,
              predef: Sequence[Tuple[str, float]] = ()) -> int:
    """Render a script and write a 16-bit PCM WAV file; returns the
    number of sample frames written. The file is opened only after
    the render succeeded."""
    from .io import wav
    audio = render(source, path=path, program=program, srate=srate,
                   stereo=stereo, device=device, predef=predef)
    sf = wav.SndFile(out_path, wav.FORMAT_WAV, audio.shape[1], srate)
    try:
        sf.write(audio.reshape(-1), audio.shape[0])
    finally:
        sf.close()
    return audio.shape[0]
