"""plan.upload_ms: milliseconds in the port's own ``plan.upload`` spans
(``saugns_tpu_torch.tracing``: the wave tables' upload, the initial
state, the Dispatch and each renderer's ``prepare()``; not the
process's one-time work, which ``port.init`` holds) in set-up, summed
(set-up as ``spans.py`` defines it). Moves setup_s."""
import spans


def read(ctx):
    return spans.setup_sum(ctx, 'plan.upload', 1e6)
