"""Carriers of random-segment voices with a phase-modulation chain, the
voice of saugns' examples/sounds/hearty_rumble.sau: ``R f<freq> ...
p[Wsin f<mod_freq>.r<mod_freq_to>[Wsin f<fm_freq>]
a<mod_amp>.r<mod_amp_to>[Wsin f<am_freq>]]``.

It follows saugns v0.4.7 (sau/generator/rasg.h, sau/generator/wosc.h,
sau/generator.c, sau/line.h, sau/math.h), in float32 operation for
operation where the C is float32:

- the three wave oscillators are ``sau.py``'s (a u32 phase, the
  differentiated pre-integrated sine), the modulator's phase summed
  from a step that its frequency gives sample by sample;
- value-range modulation (generator.c:384-477): a range modulator's
  output ``s`` at amplitude 1 becomes ``s * 0.5 + 0.5``, and the
  parameter ``p + (p_to - p) * that``, for the modulator's frequency
  and its amplitude; the modulator's output times its amplitude is the
  carrier's phase modulation ``pm``;
- the R carrier takes the script PRNG's next draw as its default seed,
  in parse order (the wave oscillators draw none): SplitMix32 from 0
  (sau/math.h:329-334), voice k the draw k + 1; the seed sets the
  cycle, its lowest bit cleared, and the phase is 0 (rasg.h:59-92);
- its cyclor is a u64 counter, the cycle in its high 32 bits and, at
  the default 2x rate, twice the phase in its low 32; the count at a
  sample is the seed's plus the steps before it, a step
  ``rint(f32(2^32 / srate) * 2 * freq)``, plus ``rint(pm * 2^32)``
  (rasg.h:29-33, 165-222); the phase read is the low 32 bits shifted
  right once, as an int32 to float32, times 2^-31;
- R's defaults, the uniform map and the cos line (rasg.h:299-683,
  692-743, line.h:35-94, 174-183): ``a = ranfast32(cycle)``, ``b =
  ranfast32(cycle + 1)``, each as an int32 times 2^-31, and ``s = a +
  (b - a) * (sinramp(phase - 0.5) + 0.5)``.

Departures from the C, none of which changes a value:

- the C renders in blocks of 1,024 samples, the reference a voice's
  samples at once: with nothing timed inside a voice, the blocks change
  nothing;
- u64 and u32 sums and products wrap in NumPy's unsigned integers, as
  in the C.

The voices of a bank are one block (``BLOCK`` is larger than any bank),
so that the k-th voice of a block is the bank's k-th, whose seed the
script's order gives.

The control (``chain`` float32, as ``control.py`` asks for it) computes
below the stated precision: the wave oscillators interpolate in float32
(``sau.py``), and each cyclor's count before its phase modulation is a
float32 running sum of its step in segments (``inc`` times 2^-32), in
place of the u64 counter.
"""
from __future__ import annotations

import numpy as np

from .sau import f32, f64, ftoi, M32, osc, SIN_PHASE_ADJ

# voices a block: every bank whole (see the module docstring)
BLOCK = 1 << 30
# voices a pass of the vectorised sums, to bound the (voices, samples)
# u64 arrays
ROWS = 32

FIBH32 = 0x9e3779b9
SCALE31 = f32(2.0 ** -31)
SCALE32 = f32(2.0 ** -32)
# sinramp's coefficients (sau/line.h:174-183), float32
S0 = f32(1.5702137061703461473139223358864)
S1 = f32(-2.568278787380814155456160152724)
S2 = f32(1.1496958507977182668618673644367)


def default_seeds(n):
    """The first ``n`` draws of the script PRNG (SplitMix32 from 0)."""
    out = []
    st = 0
    for _ in range(n):
        st = (st + FIBH32) & M32
        z = ((st ^ (st >> 16)) * 0x21f0aaad) & M32
        z = ((z ^ (z >> 15)) * 0xf35a2d97) & M32
        out.append(z ^ (z >> 15))
    return out


def ranfast32(n):
    """Random-access noise of u32 ``n`` (a uint32 array;
    sau/math.h:297-303)."""
    s = n * np.uint32(FIBH32)
    s ^= s >> np.uint32(14)
    s = (s | np.uint32(1)) * s
    return s ^ (s >> np.uint32(13))


def ranged(out):
    """A range modulator's output at amplitude 1 as the share of the
    range it selects: ``s * 0.5 + 0.5`` in float32."""
    return out * f32(0.5) + f32(0.5)


def wave(coef, freq, n, srate):
    """(V, n) float32 outputs of sine oscillators whose frequency (V, n)
    float32 changes sample by sample: the u32 phase summed from each
    sample's step, pre-incremented, from the sine's phase adjustment."""
    coeff = f32(f64(4294967296.0) / srate)
    inc = ftoi(coeff * freq)
    phase = (np.cumsum(inc, axis=1) + SIN_PHASE_ADJ) & M32
    return osc(coef, phase)


def const_wave(coef, freq, n, srate):
    """(V, n) float32 outputs of sine oscillators at the constant
    ``freq`` (V,): each distinct frequency rendered once (the bank's
    range modulators all run at one)."""
    uniq, which = np.unique(freq, return_inverse=True)
    return wave(coef, np.repeat(uniq[:, None], n, 1), n, srate)[which]


def modulation(coef, v, n, srate):
    """(V, n) float32 phase modulation of the carriers: the modulator's
    output times its amplitude, each ranged by its own sine."""
    fm = ranged(const_wave(coef, v['fm_freq'], n, srate))
    freq = v['mod_freq'][:, None] + \
        (v['mod_freq_to'] - v['mod_freq'])[:, None] * fm
    am = ranged(const_wave(coef, v['am_freq'], n, srate))
    amp = v['mod_amp'][:, None] + \
        (v['mod_amp_to'] - v['mod_amp'])[:, None] * am
    out = wave(coef, freq, n, srate)
    out *= amp
    return out


def steps(freq, srate):
    """The cyclor's u64 step a sample at 2x rate: (V,) uint64."""
    coeff = f32(f64(4294967296.0) / srate) * f32(2.0)
    return ftoi(coeff * freq).astype(np.uint64)


def counts(seeds, freq, n, srate, control):
    """(V, n) uint64 cyclor counts before phase modulation: the seed's
    count plus the steps before each sample (post-incremented), or in
    the control a float32 running sum of the step in segments."""
    start = np.array([(s & ~1 & M32) << 32 for s in seeds], np.uint64)
    inc = steps(freq, srate)
    if not control:
        before = np.arange(n, dtype=np.uint64)
        return start[:, None] + inc[:, None] * before[None, :]
    step = inc.astype(f32) * SCALE32
    pos = np.zeros((len(seeds), n), f32)
    if n > 1:
        # a sequential float32 sum (np.add.accumulate adds in order)
        pos[:, 1:] = np.add.accumulate(
            np.repeat(step[:, None], n - 1, 1), axis=1, dtype=f32)
    whole = np.rint(pos.astype(f64) * 4294967296.0).astype(np.uint64)
    return start[:, None] + whole


def rasg(count, pm):
    """R's output at the counts (V, n) uint64, phase-modulated by ``pm``
    (V, n) float32: the uniform map and the cos line."""
    ofs = np.rint((pm * f32(4294967296.0)).astype(f64)).astype(np.int64)
    cp = count + ofs.astype(np.uint64)
    cycle = (cp >> np.uint64(32)).astype(np.uint32)
    phase = ((cp & np.uint64(M32)) >> np.uint64(1)).astype(np.int32)
    phase = phase.astype(f32) * SCALE31
    a = ranfast32(cycle).view(np.int32).astype(f32) * SCALE31
    b = ranfast32(cycle + np.uint32(1)).view(np.int32).astype(f32) * SCALE31
    x = phase - f32(0.5)
    x2 = x * x
    t = x * (S0 + x2 * (S1 + x2 * S2)) + f32(0.5)
    return a + (b - a) * t


def carriers(coef, v, n, srate):
    """(V, n) float32 carrier outputs of a block of voices ``v`` (float32
    vectors of each written number). ``coef``: the Hermite table of the
    chain (float32: the control)."""
    control = coef.dtype == np.float32
    seeds = default_seeds(len(v['freq']))
    out = np.empty((len(seeds), n), f32)
    for lo in range(0, len(seeds), ROWS):
        part = {k: x[lo:lo + ROWS] for k, x in v.items()}
        pm = modulation(coef, part, n, srate)
        count = counts(seeds[lo:lo + ROWS], part['freq'], n, srate,
                       control)
        out[lo:lo + ROWS] = rasg(count, pm)
    return out
