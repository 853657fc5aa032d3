"""dispatch.capture_s: seconds the port spent capturing and
instantiating CUDA graphs in set-up, summed over the programs that
set-up prepares (``graph_stats()['capture_s']``). Moves setup_s."""


def read(ctx):
    vals = [st.get('capture_s') for st in ctx.stats]
    if not vals or any(v is None for v in vals):
        return None
    return float(sum(vals))
