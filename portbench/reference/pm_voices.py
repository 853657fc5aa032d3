"""Carriers of phase-modulation voices, ``Wsin f<freq> ... p[Wsin
f<mod_freq> a<mod_amp> p[Wsin f<mod2_freq> a<mod2_amp>]]``: each
oscillator of the chain, times its amplitude, adds ``rint(pm * 2^31)``
to the phase of the oscillator it modulates (wosc.h:135-169)."""
from __future__ import annotations

from .sau import f32, ftoi, M32, osc, phasor

# voices a block: (32, n) arrays, each block vectorised over time
BLOCK = 32


def modulated(coef, freq, n, srate, pm=None):
    """(V, n) float32 outputs of oscillators at ``freq`` (V,), their
    phases offset by the modulator output ``pm`` (V, n) where given."""
    ph = phasor(freq, n, srate)
    if pm is not None:
        pm = pm * f32(2147483648.0)
        ph += ftoi(pm)
        ph &= M32
    return osc(coef, ph)


def carriers(coef, v, n, srate):
    """(V, n) float32 carrier outputs of a block of voices ``v``
    (float32 vectors of each written number)."""
    mod2 = modulated(coef, v['mod2_freq'], n, srate)
    mod2 *= v['mod2_amp'][:, None]
    mod = modulated(coef, v['mod_freq'], n, srate, mod2)
    mod *= v['mod_amp'][:, None]
    return modulated(coef, v['freq'], n, srate, mod)
