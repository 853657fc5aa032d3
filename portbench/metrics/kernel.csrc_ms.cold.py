"""kernel.csrc_ms.cold: device milliseconds a call in the port's own
kernels, by the reader of ``kernel.csrc_ms``, in the cells whose every
request is a new call of the library (entry ``render``). Moves
audio_rate.cold."""
import os

from harness import cells

read = cells.reader(
    'kernel.csrc_ms',
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
