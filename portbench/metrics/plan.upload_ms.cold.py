"""plan.upload_ms.cold: milliseconds a call in the port's own
``plan.upload`` spans (``saugns_tpu_torch.tracing``: the wave tables'
upload, the initial state, the Dispatch and each renderer's
``prepare()``), the mean over the profiled requests (as ``spans.py``
defines them): one call of the library, the window's first, in the cells
whose every request is a new call (entry ``render``). Not set-up's call,
which also pays what the process does once. Moves audio_rate.cold."""
import spans


def read(ctx):
    return spans.profiled_mean(ctx, 'plan.upload', 1e6)
