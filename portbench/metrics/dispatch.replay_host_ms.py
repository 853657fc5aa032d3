"""dispatch.replay_host_ms: host milliseconds a request in the port's
own ``dispatch.replay`` spans (``saugns_tpu_torch.tracing``: the
copies of a graph's tables into its static inputs and its launch), the
mean over the window's plain requests (as ``spans.py`` defines them).
Moves audio_rate."""
import spans


def read(ctx):
    return spans.plain_span_mean(ctx, 'dispatch.replay', 1e6)
