"""frontend.compile_ms: milliseconds in the port's front end
(``saugns_tpu_torch.compile_script``) for the programs that set-up
prepares (each program of a run, or the first alone where the entry's
requests prepare their own), summed: the benchmark's span around each
call. Moves setup_s."""


def read(ctx):
    s = ctx.spans.get('frontend.compile')
    return 1e3 * sum(s) if s else None
