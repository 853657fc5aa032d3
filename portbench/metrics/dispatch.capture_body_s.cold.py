"""dispatch.capture_body_s.cold: seconds in the port's own
``dispatch.capture.body`` spans (``saugns_tpu_torch.tracing``: the
bodies' Python under a CUDA graph capture) in set-up, summed: set-up
captures the first program alone, as each request captures its own, in
the cells whose every request is a new call (entry ``render``); set-up
as ``spans.py`` defines it, which with ``dispatch.capture_s.cold`` reads
one call, and not the profiled call, whose capture Python the profiler
slows. Moves audio_rate.cold."""
import spans


def read(ctx):
    return spans.setup_sum(ctx, 'dispatch.capture.body', 1e9)
