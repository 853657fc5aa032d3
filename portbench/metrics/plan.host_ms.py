"""plan.host_ms: milliseconds from each entry's constructor through its
``prepare()`` (plan, host bake, tables uploaded; no capture), summed over
the programs that set-up prepares: the benchmark's span. Moves
setup_s."""


def read(ctx):
    s = ctx.spans.get('plan.host')
    return 1e3 * sum(s) if s else None
