"""Carriers of self-PM ("feedback FM") voices, ``Wsin f<freq> ...
p.a[Wsin f<mod_freq> a<mod_amp> a[Wsin f<am_freq> a<am_amp>]]``: the
self-PM amount is the modulator's output times its amplitude, which its
own modulator raises by ``am * am_amp`` (generator.c:448-498); each
sample adds ``rint((fb * amount) * 2^31)`` to the carrier's phase,
where ``fb`` is the running mean ``(fb + s) / 2`` of the carrier's own
output (wosc.h:273-310). One serial loop over samples, the voices as a
vector."""
from __future__ import annotations

import numpy as np

from .pm_voices import modulated
from .sau import dvscale, f32, f64, herp, M32, phasor, reset_value, signed32

# voices a block: the loop's cost is per sample, whatever the width, so
# a few wide blocks (1,024 voices in six)
BLOCK = 176


def amount(coef, v, n, srate):
    """(V, n) float32 self-PM amounts of a block of voices ``v``."""
    am = modulated(coef, v['am_freq'], n, srate)
    am *= v['am_amp'][:, None]
    am += v['mod_amp'][:, None]
    mod = modulated(coef, v['mod_freq'], n, srate)
    mod *= am
    return mod


def carriers(coef, v, n, srate):
    """(V, n) float32 carrier outputs of a block of voices ``v``
    (float32 vectors of each written number)."""
    chain = coef.dtype.type
    dvs = dvscale()
    base = np.ascontiguousarray(phasor(v['freq'], n, srate).T)
    pm_a = np.ascontiguousarray(amount(coef, v, n, srate).T)
    prev_phase = base[0].copy()
    prev_s, prev_Is = reset_value(coef, prev_phase)
    fb = np.zeros(len(v['freq']), f32)
    out = np.empty((n, len(v['freq'])), f32)
    fb_scale = f64(f32(2147483648.0))
    with np.errstate(divide='ignore', invalid='ignore'):
        for i in range(n):
            adj = (fb * pm_a[i]).astype(f64)
            adj *= fb_scale
            phase = np.rint(adj).astype(np.int64)
            phase += base[i]
            phase &= M32
            d = signed32(phase - prev_phase)
            Is = herp(coef, phase)
            x = (dvs / d.astype(f32)).astype(chain)
            s = ((Is - prev_Is) * x).astype(f32)
            if not d.all():
                moved = d != 0
                s = np.where(moved, s, prev_s)
                Is = np.where(moved, Is, prev_Is)
                phase = np.where(moved, phase, prev_phase)
            prev_s, prev_Is, prev_phase = s, Is, phase
            out[i] = s
            fb += s
            fb *= f32(0.5)
    return np.ascontiguousarray(out.T)
