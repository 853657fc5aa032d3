"""kernel.csrc_ms: device milliseconds per request in the port's own
kernels (the ``__global__`` functions of ``saugns_tpu_torch/csrc/``),
in the traced window. Moves audio_rate."""
import re


def read(ctx):
    t = ctx.trace
    if not t or not t['requests'] or not ctx.csrc_kernels:
        return None
    own = re.compile(r'\b(%s)\b' % '|'.join(sorted(ctx.csrc_kernels)))
    us = [b - a for n, a, b in t['ops'] if own.search(n)]
    return sum(us) / 1e3 / t['requests'] if us else None
