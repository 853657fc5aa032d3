"""render.fetch_ms.cold: milliseconds a call in the port's own
``render.fetch`` spans (``saugns_tpu_torch.tracing``: the host waiting
on each device to host copy of ``TorchGenerator.run``'s stream, one a
chunk group), the mean over the profiled requests (as ``spans.py``
defines them): one call of the library, the window's first, in the cells
whose every request is a new call (entry ``render``). Not set-up's call,
which also pays what the process does once. Moves audio_rate.cold."""
import spans


def read(ctx):
    return spans.profiled_mean(ctx, 'render.fetch', 1e6)
