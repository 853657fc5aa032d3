"""dispatch.capture_body_s: seconds in the port's own
``dispatch.capture.body`` spans (``saugns_tpu_torch.tracing``: the
bodies' Python under a CUDA graph capture, inside ``dispatch.capture``,
whose self time is capture_end and instantiation) in set-up, summed
(set-up as ``spans.py`` defines it). Moves setup_s."""
import spans


def read(ctx):
    return spans.setup_sum(ctx, 'dispatch.capture.body', 1e9)
