"""Plain NumPy reference of saugns v0.4.7's wave voices and mix.

It follows the semantics of saugns v0.4.7 for the SAU lines that the
benchmark's script writer (``portbench/harness/scripts.py``) writes:

- a number is read as its integer part plus its fraction digits over a
  power of ten, in double, and kept as float32 (sau/file.c, getd); a
  time in seconds becomes ``rint(t * 1000)`` ms and ``ms * srate //
  1000`` samples (sau/math.h);
- a wave oscillator is a u32 phase accumulator (``rint(2^32 / srate *
  freq)`` a sample, pre-incremented, from the sine's phase adjustment)
  read through the pre-integrated sine table (the 2048-point sine
  itself) by 4-point Hermite interpolation in double and differentiated:
  ``(Is(p) - Is(p_prev)) * (dvscale / (p - p_prev))``, the previous
  value held where the phase does not move, the first one from a reset
  one table step back (sau/wave.h, sau/generator/wosc.h);
- each voice is scaled by ``0.5 * a.m`` and panned, ``l += s - s * c``
  and ``r += s + s * c``, voice after voice in float32; the mix is
  clipped to [-1, 1], times 32767 and rounded half to even into int16
  (sau/generator.c:734-825).

The kind of voice (``portbench/reference/<kind>.py``) supplies the
carriers' outputs. ``chain`` is the type of the interpolation and
differentiation: float64, as the configurations state it; float32 is
the control that the comparison has to fail.
"""
from __future__ import annotations

import importlib
import math

import numpy as np

f32 = np.float32
f64 = np.float64

LENBITS = 11
LEN = 1 << LENBITS
LENMASK = LEN - 1
SLENBITS = 32 - LENBITS
SLEN = 1 << SLENBITS
SLENMASK = SLEN - 1
M32 = 0xffffffff
# the sine's PILUT amplitude scale and phase adjustment, INT32_MIN / 2
# as a u32 (sau/wave.h:33-70)
SIN_AMP_SCALE = 1.27324153848
SIN_PHASE_ADJ = (-(1 << 31) // 2) & M32


def number_double(text: str) -> float:
    """A number as SAU reads it: optional sign, integer digits, then
    the fraction digits over a power of ten, in double."""
    s = text.strip()
    neg = s.startswith('-')
    if s[:1] in '+-':
        s = s[1:]
    whole, _, frac = s.partition('.')
    val = 0.0
    for ch in whole:
        val = val * 10.0 + (ord(ch) - 48)
    if frac:
        num_b = 0
        div = 1.0
        for ch in frac:
            num_b = num_b * 10 + (ord(ch) - 48)
            div *= 10.0
        val += num_b / div
    return -val if neg else val


def number(text: str) -> np.float32:
    """A written parameter as the program keeps it: float32."""
    return f32(number_double(text))


def time_samples(text: str, srate: int) -> int:
    """Samples of a time written in seconds."""
    ms = int(np.rint(f64(number_double(text)) * 1000.0)) & M32
    return ms * srate // 1000


def sine_table() -> np.ndarray:
    """The 2048-point float32 sine (sau/wave.c), by the C library's
    sine."""
    lut = np.zeros(LEN, f32)
    half = LEN >> 1
    for i in range(half):
        s = f32(math.sin(math.pi * (i * (1.0 / half))))
        lut[i] = s
        lut[i + half] = -s
    return lut


def dvscale() -> np.float32:
    """The sine's differentiation scale, rounded as the C macro."""
    return f32(f32(SIN_AMP_SCALE) * f32(0.125)) * f32(4294967295.0)


def herp_coeffs(lut, chain=f64):
    """The Hermite coefficients (c0, c1, c2, c3) of each table index,
    (4, LEN) in ``chain``: the operations the C makes at each sample,
    made once an index; the tap differences round in float32 first."""
    ind = np.arange(LEN)
    s0 = lut[(ind - 1) & LENMASK]
    s1 = lut[ind]
    s2 = lut[(ind + 1) & LENMASK]
    s3 = lut[(ind + 2) & LENMASK]
    c0 = s1.astype(chain)
    c1 = chain(0.5) * (s2 - s0).astype(chain)
    c2 = (s0.astype(chain) - chain(2.5) * s1.astype(chain)
          + (f32(2.0) * s2).astype(chain) - chain(0.5) * s3.astype(chain))
    c3 = (chain(0.5) * (s3 - s0).astype(chain)
          + chain(1.5) * (s1 - s2).astype(chain))
    return np.stack([c0, c1, c2, c3])


def herp(coef, phase):
    """4-point Hermite interpolation at u32 ``phase`` (an int64 array)
    of the table whose coefficients ``coef`` holds, in their type:
    ((c3 x + c2) x + c1) x + c0, x the phase's fraction of a table step
    (sau/wave.h:127-141)."""
    chain = coef.dtype.type
    ind = phase >> SLENBITS
    x = (phase & SLENMASK).astype(chain)
    x *= chain(f32(1.0 / SLEN))
    r = coef[3][ind]
    r *= x
    r += coef[2][ind]
    r *= x
    r += coef[1][ind]
    r *= x
    r += coef[0][ind]
    return r


def ftoi(x):
    """rint (half to even) of float32 values, wrapped to u32."""
    return np.rint(np.asarray(x, f32).astype(f64)).astype(np.int64) & M32


def phasor(freq, n, srate):
    """Pre-incremented u32 phases of constant-frequency rows: freq (V,)
    float32 -> (V, n) int64."""
    coeff = f32(f64(4294967296.0) / srate)
    inc = ftoi(coeff * freq)
    steps = np.arange(1, n + 1, dtype=np.int64)
    return (SIN_PHASE_ADJ + inc[:, None] * steps[None, :]) & M32


def signed32(d):
    """u32 differences (int64) as signed 32-bit values."""
    return (d & M32).astype(np.uint32).view(np.int32)


def reset_value(coef, phase0):
    """A reset oscillator's first output at phases ``phase0``: the
    difference from one table step back (wosc.h:215-231)."""
    chain = coef.dtype.type
    Is = herp(coef, phase0)
    prev = herp(coef, (phase0 - SLEN) & M32)
    return ((Is - prev) * chain(dvscale() / f32(SLEN))).astype(f32), Is


def osc(coef, phase):
    """The differentiated PILUT oscillator over rows of u32 phases
    (V, n) -> float32 (V, n), reset at each row's first phase."""
    chain = coef.dtype.type
    Is = herp(coef, phase)
    s0, _ = reset_value(coef, phase[:, 0])
    d = signed32(phase[:, 1:] - phase[:, :-1])
    out = np.empty(phase.shape, f32)
    out[:, 0] = s0
    with np.errstate(divide='ignore', invalid='ignore'):
        x = (dvscale() / d.astype(f32)).astype(chain)
        dIs = Is[:, 1:] - Is[:, :-1]
        dIs *= x
        out[:, 1:] = dIs
    valid = d != 0
    if not valid.all():
        # a held position takes the last moving one's value (0: the
        # reset's)
        n = phase.shape[1]
        mv = np.concatenate([np.ones((len(phase), 1), bool), valid], 1)
        idx = np.maximum.accumulate(np.where(mv, np.arange(n), 0), axis=1)
        out = np.take_along_axis(out, idx, 1)
    return out


def carrier_block(kind, chain, part, n, srate):
    """(V, n) float32 outputs of the written voices ``part`` (a list of
    dicts of number texts) of kind ``kind``, each times its amplitude:
    ``portbench/reference/<kind>.py``'s ``carriers(coef, params, n,
    srate)``. A module-level function, so that a pool can run it."""
    mod = importlib.import_module('%s.%s' % (__package__, kind))
    coef = herp_coeffs(sine_table(), chain)
    v = {k: np.array([number(vo[k]) for vo in part], f32)
         for k in part[0] if k != 'time'}
    out = mod.carriers(coef, v, n, srate)
    out *= v['amp'][:, None]
    return out


def _blocks(bank, srate):
    """The samples a voice and the bank's voices in blocks of its
    kind's ``BLOCK``."""
    voices = bank['voices']
    block = importlib.import_module(
        '%s.%s' % (__package__, bank['kind'])).BLOCK
    n = time_samples(voices[0]['time'], srate)
    if any(time_samples(vo['time'], srate) != n for vo in voices):
        raise ValueError('the reference renders voices of one length')
    return n, [voices[lo:lo + block] for lo in range(0, len(voices), block)]


def mix_i16(bank, n, outs):
    """int16 (n, 2) of the blocks ``outs`` of a bank's voices, mixed in
    voice order."""
    amp_scale = f32(0.5) * number(bank['ampmult'])
    pans = np.array([number(vo['pan']) for vo in bank['voices']], f32)
    mix_l = np.zeros(n, f32)
    mix_r = np.zeros(n, f32)
    k = 0
    for out in outs:
        for row in out:
            s = row * amp_scale
            s_r = s * pans[k]
            mix_l += s - s_r
            mix_r += s + s_r
            k += 1
    mix = np.stack([mix_l, mix_r], 1)
    mix = np.clip(mix, f32(-1.0), f32(1.0)) * f32(32767.0)
    return np.rint(mix.astype(f64)).astype(np.int16)


def render(banks, srate, chain=f64, pool=None):
    """int16 (n, 2) of each written bank of ``banks``: {'kind',
    'ampmult', 'voices': [{'time', 'amp', 'pan', ...}, ...]}, every
    number as the text written. The blocks of voices go to ``pool`` (a
    multiprocessing pool) where one is given."""
    jobs = []
    for bank in banks:
        n, parts = _blocks(bank, srate)
        jobs.append((n, [(bank['kind'], chain, p, n, srate) for p in parts]))
    flat = [a for _n, args in jobs for a in args]
    outs = pool.starmap(carrier_block, flat) if pool is not None \
        else [carrier_block(*a) for a in flat]
    res = []
    pos = 0
    for bank, (n, args) in zip(banks, jobs):
        res.append(mix_i16(bank, n, outs[pos:pos + len(args)]))
        pos += len(args)
    return res
