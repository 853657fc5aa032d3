"""plan.build_ms.cold: milliseconds in the port's own ``plan.build`` spans
(``saugns_tpu_torch.tracing``: RenderPlan and HostSim and each
renderer's construction with its host tables) in set-up, summed: set-up
prepares the first program alone, as each request prepares its own, in
the cells whose every request is a new call (entry ``render``); set-up
as ``spans.py`` defines it, which with ``plan.host_ms.cold`` reads one
call. Moves audio_rate.cold."""
import spans


def read(ctx):
    return spans.setup_sum(ctx, 'plan.build', 1e6)
