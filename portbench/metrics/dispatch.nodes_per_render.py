"""dispatch.nodes_per_render: device operations (kernels, copies,
memsets: the nodes that a render's graphs replay, and what runs outside
them) per request in the traced window, from the profiler's trace.
Moves audio_rate."""


def read(ctx):
    t = ctx.trace
    if not t or not t['requests'] or not t['ops']:
        return None
    return len(t['ops']) / t['requests']
