"""store.lookup_ms.cold: milliseconds a call in the port's own
``store.lookup`` spans (``saugns_tpu_torch.tracing``: the
compiled-render store's key, its memory tier's checkout and its disk
load in a new ``TorchGenerator``), the mean over the profiled requests
(as ``spans.py`` defines them): one call of the library, the window's
first, in the cells whose every request is a new call (entry
``render``). Not set-up's call, which also pays what the process does
once. Moves audio_rate.cold."""
import spans


def read(ctx):
    return spans.profiled_mean(ctx, 'store.lookup', 1e6)
