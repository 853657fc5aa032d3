"""plan.build_ms: milliseconds in the port's own ``plan.build`` spans
(``saugns_tpu_torch.tracing``: RenderPlan and HostSim, or BankPlan, and
each renderer's construction with its host tables) in set-up, summed
(set-up as ``spans.py`` defines it). Moves setup_s."""
import spans


def read(ctx):
    return spans.setup_sum(ctx, 'plan.build', 1e6)
