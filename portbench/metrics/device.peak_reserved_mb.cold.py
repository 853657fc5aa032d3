"""device.peak_reserved_mb.cold: the most device memory the run held
reserved, by the reader of ``device.peak_reserved_mb``, in the cells
whose every request is a new call of the library (entry ``render``).
Moves audio_rate.cold."""
import os

from harness import cells

read = cells.reader(
    'device.peak_reserved_mb',
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
