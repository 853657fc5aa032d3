"""kernel.wosc_selfmod_roofline: the share (%) of its roofline that the
port's self-PM wave kernel (K5, ``wosc_selfmod_rows``) reaches in the
traced window: the least time of the samples of the configuration's
self-PM oscillators (voices x oscillators x samples a voice x traced
requests; harness/roofline.py) over the kernel's device time. A serial
chain a voice: expect well under 1%. Moves audio_rate."""
import re

from harness import roofline

KERNEL = re.compile(r'\bwosc_selfmod_rows\b')


def read(ctx):
    t = ctx.trace
    if not t or not t['requests']:
        return None
    dev_s = sum(b - a for n, a, b in t['ops'] if KERNEL.search(n)) / 1e6
    samples = (t['requests'] * int(ctx.traffic['voices'])
               * int(ctx.config['oscillators']['selfpm'])
               * ctx.samples_per_voice)
    return roofline.share('wosc_selfmod', samples, dev_s)
