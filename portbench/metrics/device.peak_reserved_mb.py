"""device.peak_reserved_mb: the most device memory the run's process
held reserved (``torch.cuda.max_memory_reserved()`` over set-up and the
window), in MiB. Moves audio_rate: the slab width trades it for rate."""


def read(ctx):
    m = ctx.memory_reserved_peak
    return m / 2 ** 20 if m else None
