"""kernel.wosc_selfmod_roofline.cold: K5's share (%) of its roofline in
the traced calls, by the reader of ``kernel.wosc_selfmod_roofline``,
in the cells whose every request is a new call of the library (entry
``render``). Moves audio_rate.cold."""
import os

from harness import cells

read = cells.reader(
    'kernel.wosc_selfmod_roofline',
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
