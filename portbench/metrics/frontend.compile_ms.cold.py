"""frontend.compile_ms.cold: the front end's time for one call (set-up
compiles the first program alone, as each request compiles its own),
by the reader of ``frontend.compile_ms``, in the cells whose every
request is a new call of the library (entry ``render``). Moves
audio_rate.cold."""
import os

from harness import cells

read = cells.reader(
    'frontend.compile_ms',
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
