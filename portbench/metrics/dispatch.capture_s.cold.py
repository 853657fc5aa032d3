"""dispatch.capture_s.cold: the graph capture of one call (set-up
captures the first program alone, as each request captures its own),
by the reader of ``dispatch.capture_s``, in the cells whose every
request is a new call of the library (entry ``render``). Moves
audio_rate.cold."""
import os

from harness import cells

read = cells.reader(
    'dispatch.capture_s',
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
