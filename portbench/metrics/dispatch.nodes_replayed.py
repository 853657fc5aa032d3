"""dispatch.nodes_replayed: CUDA graph nodes a request replayed, by the
port's own counter ``dispatch.nodes_replayed``
(``saugns_tpu_torch.tracing``: each graph's nodes, counted once at its
capture, added to the request at every replay), the mean over the
window's plain requests (as ``spans.py`` defines them); None where
nothing was captured (the CPU). Moves audio_rate."""
import spans


def read(ctx):
    return spans.plain_count_mean(ctx, 'dispatch.nodes_replayed')
