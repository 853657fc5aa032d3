"""plan.host_ms.cold: the plan and host bake of one call (set-up prepares
the first program alone, as each request prepares its own), by the
reader of ``plan.host_ms``, in the cells whose every request is a new
call of the library (entry ``render``). Moves audio_rate.cold."""
import os

from harness import cells

read = cells.reader(
    'plan.host_ms',
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
