"""dispatch.nodes_per_render.cold: device operations a call in the traced
window, by the reader of ``dispatch.nodes_per_render``, in the cells
whose every request is a new call of the library (entry ``render``).
Moves audio_rate.cold."""
import os

from harness import cells

read = cells.reader(
    'dispatch.nodes_per_render',
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
