"""device.idle_share: the share (%) of the traced window in which no
operation ran on the device: 1 - busy / window, both from the same
traced run (busy: the union of the device operations' intervals).
Moves audio_rate."""


def read(ctx):
    t = ctx.trace
    if not t or t['window_s'] <= 0 or not t['ops']:
        return None
    return 100.0 * (1.0 - t['busy_s'] / t['window_s'])
