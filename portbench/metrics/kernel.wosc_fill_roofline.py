"""kernel.wosc_fill_roofline: the share (%) of its roofline that the
port's wave oscillator kernel (K1, ``wosc_fill_k``) reaches in the
traced window: the least time of the samples of the configuration's
plain oscillators (voices x oscillators x samples a voice x traced
requests; harness/roofline.py) over the kernel's device time. Moves
audio_rate."""
import re

from harness import roofline

KERNEL = re.compile(r'\bwosc_fill_k\b')


def read(ctx):
    t = ctx.trace
    if not t or not t['requests']:
        return None
    dev_s = sum(b - a for n, a, b in t['ops'] if KERNEL.search(n)) / 1e6
    samples = (t['requests'] * int(ctx.traffic['voices'])
               * int(ctx.config['oscillators']['plain'])
               * ctx.samples_per_voice)
    return roofline.share('wosc_fill', samples, dev_s)
