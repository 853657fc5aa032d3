"""stage.torch_ms: device milliseconds per request in operations that
are not the port's own kernels (torch's elementwise, gather, copy and
memset work of the stage loop, the mix and the conversion), in the
traced window. Moves audio_rate."""
import re


def read(ctx):
    t = ctx.trace
    if not t or not t['requests'] or not ctx.csrc_kernels:
        return None
    own = re.compile(r'\b(%s)\b' % '|'.join(sorted(ctx.csrc_kernels)))
    ms = sum(b - a for n, a, b in t['ops'] if not own.search(n)) / 1e3
    return ms / t['requests'] if t['ops'] else None
