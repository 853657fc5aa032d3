"""PyTorch DSP primitives of the flat and sequential renderers.

Counterpart of ``saugns_tpu/render/jdsp.py``, limited to what the
flat path and the sequential-scan engine use. Every function keeps the exact float32 / float64 /
integer op sequence of its JAX twin as the JAX renderer runs it
(compiled), so that results are bit-equal on every device:

- u32 values live in int64 tensors holding [0, 2^32); wrapping
  arithmetic masks with ``M32`` after each add or multiply.
- No composite op that may contract a multiply into an add
  (``addcmul``, ``lerp``, ``alpha=``).
- Division is always tensor / tensor: ``scalar / tensor`` is computed
  by PyTorch as ``reciprocal * scalar``, and on CUDA ``tensor /
  python_scalar`` as a multiply by the reciprocal -- both round twice.

The hand-written kernels (``kernels.py``) sit behind ``prefix_sum``,
``prefix_sum_u64``, ``scan_max_i32``, ``wosc_s_filled``,
``gather_taps``, ``is64``, ``forward_fill_last_valid``,
``forward_fill_valid``, ``wosc_selfmod``, ``rasg_selfmod`` and
``rasg_fill``. Each
wrapper launches its kernel for a CUDA tensor and uses the plain
version beside it (``*_plain``, or ``last_valid_fill``) only for a
tensor on the CPU. The composite functions of the sequential engine
take ``plain=True`` to run on the plain versions on any device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..dsp import prim
from ..dsp import wavetables as W
from ..dsp.lines import PERLIN_AMP
from ..lang import program as P

M32 = 0xffffffff
F32 = torch.float32
F64 = torch.float64
I64 = torch.int64

FIBH32 = 0x9e3779b9
HUMMID_INV = float(np.float32(1.0 / prim.HUMMID))
SCALE31 = float(np.float32(2.0 ** -31))
SCALE32 = float(np.float32(2.0 ** -32))
P31 = float(np.float32(2.0 ** 31))

SLENBITS = W.SLENBITS
SLENMASK = W.SLENMASK
LENMASK = W.LENMASK
X_SCALE = float(np.float32(1.0 / W.SLEN))


def _c(x):
    """A float32 constant as the Python float of its exact value."""
    return float(np.float32(x))


def asi32(x):
    """u32 (int64 in [0, 2^32)) -> its two's-complement value."""
    return x - ((x & 0x80000000) << 1)


def asu32(x):
    """Signed 32-bit value (any int dtype) -> u32 in int64."""
    return x.to(I64) & M32


def f32_bits(x):
    """Bit pattern of float32 values as u32 in int64."""
    return asu32(x.contiguous().view(torch.int32))


def umul32(a, b):
    """u32 * u32 mod 2^32 in int64 without overflow: 16-bit halves
    of ``b`` keep every partial product below 2^49."""
    lo = a * (b & 0xffff)
    hi = (a * (b >> 16)) & 0xffff
    return (lo + (hi << 16)) & M32


def ranfast32(n):
    """sau_ranfast32 (sau/math.h:297-303); u32 in/out."""
    s = umul32(n & M32, torch.full_like(n, FIBH32))
    s = s ^ (s >> 14)
    s = umul32(s | 1, s)
    s = s ^ (s >> 13)
    return s


def mcg32(x):
    """x * 0xe47135 mod 2^32 (sau/math.h); u32 in/out. The product of a
    u32 and a 24-bit constant fits in int64."""
    return (x * 0xe47135) & M32


INT64_MAX = (1 << 63) - 1


def ftoi(x_f32):
    """llrintf: float32 -> int64, rounding half to even, saturating as
    XLA converts (jdsp.ftoi under jit): x >= 2^63 gives INT64_MAX,
    x < -2^63 gives INT64_MIN and NaN gives 0. (A plain
    ``.to(torch.int64)`` gives INT64_MIN for all of them on the CPU.)"""
    r = torch.round(x_f32)
    hi = r >= 2.0 ** 63
    r = torch.where(hi | torch.isnan(r), torch.zeros_like(r), r)
    return r.clamp(min=-2.0 ** 63).to(I64).masked_fill(hi, INT64_MAX)


def floor_i32(x_f32):
    """floorf then a saturating float -> int32 conversion (NaN -> 0),
    as XLA converts and as PTX's cvt.rmi.s32.f32 does; int64 out."""
    f = torch.floor(x_f32).to(F64).clamp(-2.0 ** 31, 2.0 ** 31 - 1)
    return torch.nan_to_num(f, nan=0.0).to(I64)


def sinpi_d5(x):
    """Degree-5 sin(pi x) approximation (sau/math.h:366-379)."""
    s0 = _c(+3.14042741234069229463)
    s1 = _c(-5.13655757476162831091)
    s2 = _c(+2.29939170159543653372)
    x2 = x * x
    return x * (s0 + x2 * (s1 + x2 * s2))


def franssgauss32(n):
    """Soft-saturated Gaussian hash noise (noise.h:61-98); u32 in,
    float32 out."""
    s0 = ranfast32(n)
    s1 = mcg32(s0)
    a = asi32(s0).to(F32) * SCALE32
    b = asi32(s1).to(F32) * SCALE32
    c0 = _c(-0.80270565422983103084)
    c1 = _c(+5.52274428214641442648)
    c2 = _c(-138.87126103150588693697)
    x2 = a * a
    x4 = x2 * x2
    c = 0.5 + a * (c0 + x4 * (c1 + x4 * c2))
    cx2 = c * c
    gx = (c + cx2) * 0.5
    c = c * (1.0 - gx * (1.0 - cx2))
    return c * sinpi_d5(b)


def foldhd32(s):
    """Wavefold (sau/math.h:112-118); u32 in/out."""
    cond = ((s + (1 << 29)) & M32) > (1 << 31)
    s = torch.where(cond, (0xc0000000 - s) & M32, s)
    return ((s - (1 << 29)) * 2) & M32


def fdiv(a, b):
    """Correctly rounded float32 ``a / b`` for a scalar ``a``."""
    return torch.full_like(b, a) / b


# -- line shapes -------------------------------------------------------------

def sinramp(x):
    s0 = _c(1.5702137061703461473139223358864)
    s1 = _c(-2.568278787380814155456160152724)
    s2 = _c(1.1496958507977182668618673644367)
    x2 = x * x
    return x * (s0 + x2 * (s1 + x2 * s2))


def expramp6(x):
    """expramp6 in the reference build's rounding order (see
    jdsp.expramp6)."""
    A = _c(629.0 / 1792.0)
    B = _c(1163.0 / 1792.0)
    x2 = x * x
    xA = x * A
    x3 = x2 * x
    p = x2 * B + xA
    return x3 + x2 * ((x3 + -1.0) * p)


def line_val(line_type: int, x, a, b):
    """sauLine_val_* (sau/line.h:152-266) for a static line type;
    x, a, b broadcastable float32 tensors."""
    one = 1.0
    half = 0.5
    if line_type == 0:    # cos
        return a + (b - a) * (sinramp(x - half) + half)
    if line_type == 1:    # lin
        return a + (b - a) * x
    if line_type == 2:    # sah
        return torch.broadcast_to(a, x.shape).to(F32)
    if line_type in (3, 4):  # exp, log
        lo = a > b if line_type == 3 else a < b
        return torch.where(lo, b + (a - b) * expramp6(one - x),
                           a + (b - a) * expramp6(x))
    if line_type == 5:    # xpe
        return b + (a - b) * expramp6(one - x)
    if line_type == 6:    # lge
        return a + (b - a) * expramp6(x)
    if line_type == 7:    # sqe
        x1 = one - x
        return b + (a - b) * (x1 * x1)
    if line_type == 8:    # cub
        x1 = half - x
        x1 = x1 + x1
        k = (a - b) * half
        return b + ((x1 * x1) * x1 + one) * k
    if line_type == 9:    # smo
        d = b - a
        x3d = (d * x) * (x * x)
        return a + x3d * ((x * 6.0 + -15.0) * x + 10.0)
    s = asi32(ranfast32(f32_bits(x))).to(F32)
    if line_type == 10:   # ncl
        q = (x + x + -3.0) * x + one
        return a + ((x + (s * q) * (x * _c(0.5 * 2.0 ** -31)))
                    * (b - a))
    if line_type == 11:   # nhl
        q = one - x
        return a + ((x + (q * s) * (x * SCALE31)) * (b - a))
    return a + (b - a) * (half + _c(0.5 * 2.0 ** -31) * s)  # uwh


# -- random segments (RasG) ---------------------------------------------------

def _sar(x, level: int):
    """Arithmetic right shift of a u32-encoded i32 by ``level``."""
    return asi32(x) >> level & M32


def _divi2(x):
    """x / 2 truncated toward zero in int32 arithmetic (u32 in/out), as
    jdsp's ``_divi2`` computes under jit (INT32_MIN gives -2^30)."""
    return torch.div(asi32(x), 2, rounding_mode='trunc') & M32


def fmax(a, b):
    """IEEE 754-2019 maximum, as XLA's max: NaN propagates and -0 < +0
    (torch.maximum keeps the first of two equal zeros)."""
    r = torch.where((a > b) | ((a == b) & ~torch.signbit(a)), a, b)
    return torch.where(torch.isnan(a), a, r)


def fmin(a, b):
    """IEEE 754-2019 minimum, as XLA's min (see fmax)."""
    r = torch.where((a < b) | ((a == b) & torch.signbit(a)), a, b)
    return torch.where(torch.isnan(a), a, r)


def _i2f(x):
    """The low 32 bits of ``x`` as an i32 -> float32."""
    return asi32(x & M32).to(F32)


def _rasg_terms(func: int, level: int, alpha: int, oflags: int, cycle):
    """The endpoint pair of rasg_map as (xa, xb, c): the pair is
    (xa * c, xb * c) for a float32 constant ``c``, or (xa, xb) where
    ``c`` is None (Gaussian values; the fixed +-1 pair)."""
    violet = (oflags & P.RAS_O_VIOLET) != 0
    c1 = (cycle + 1) & M32
    if func == P.RAS_F_GAUSS:
        return franssgauss32(cycle), franssgauss32(c1), None
    if func == P.RAS_F_ADDREC:
        return (_i2f(umul32(cycle, torch.full_like(cycle, alpha))),
                _i2f(umul32(c1, torch.full_like(c1, alpha))), SCALE31)
    r_m1 = ranfast32((cycle - 1) & M32)
    r_0 = ranfast32(cycle)
    r_p1 = ranfast32(c1)
    odd = cycle & 1
    if func == P.RAS_F_URAND:
        if not violet:
            return _i2f(r_0), _i2f(r_p1), SCALE31
        v0h, v1h, v2h = r_m1 >> 1, r_0 >> 1, r_p1 >> 1
        return _i2f(v1h - v0h), _i2f(v2h - v1h), SCALE31
    sb = odd << 31
    sb_flip = (0x80000000 - sb) & M32
    if func == P.RAS_F_BIN:
        if not violet:
            offs = (0x7fffffff + odd * 2) & M32
            return (_i2f(_sar(r_0, level) + offs),
                    _i2f(_sar(r_p1, level) - offs), SCALE31)
        sd = np.float32(1.0) - np.float32(0x7fffffff >> level) \
            * np.float32(SCALE31)
        vscale = float((np.float32(1.0) + sd * sd) * np.float32(SCALE31))
        vb0 = _divi2((_sar(r_m1, level) + sb) & M32)
        vb1 = _divi2((_sar(r_0, level) + sb_flip) & M32)
        vb2 = _divi2((_sar(r_p1, level) + sb) & M32)
        return _i2f(vb1 - vb0), _i2f(vb2 - vb1), vscale
    if func == P.RAS_F_TERN:
        return (_i2f(_sar(r_0, level) + sb_flip),
                _i2f(_sar(r_p1, level) + sb), SCALE31)
    # RAS_F_FIXED
    sign = 1 - odd * 2
    if level >= P.ras_level(9):
        a = sign.to(F32)
        return a, -a, None

    def r(x):
        return asi32(((asi32(x) >> level) - 0x7fffffff) & M32)

    if not violet:
        return _i2f(-sign * r(r_0)), _i2f(sign * r(r_p1)), SCALE31
    s0 = _divi2((sign * r(r_m1)) & M32)
    s1 = _divi2((-sign * r(r_0)) & M32)
    s2 = _divi2((sign * r(r_p1)) & M32)
    return _i2f(s1 - s0), _i2f(s2 - s1), SCALE31


def rasg_map(func: int, level: int, alpha: int, oflags: int, cycle):
    """Endpoint pair (a, b) of the segment at ``cycle`` (rasg.h:296-683)
    for static func/level/alpha/oflags, as ``s.ras`` gives them; u32
    ``cycle`` in, two float32 tensors out."""
    xa, xb, c = _rasg_terms(func, level, alpha, oflags, cycle)
    return (xa, xb) if c is None else (xa * c, xb * c)


def _perlin_amp(line: int, oflags: int):
    return 1.0 if oflags & (P.RAS_O_HALFSHAPE | P.RAS_O_ZIGZAG) \
        else float(PERLIN_AMP[line])


def rasg_shape(line: int, oflags: int, phase, a, b):
    """Mode-flag post-pass and line map (rasg.h:692-743) for static
    line type and flags: the sample at ``phase`` of the segment from a
    to b."""
    if oflags & P.RAS_O_PERLIN:
        pa = _perlin_amp(line, oflags)
        a = a * (pa * phase)
        b = b * (pa * (phase - 1.0))
    if oflags & P.RAS_O_HALFSHAPE:
        a, b = fmax(a, b), fmin(a, b)
    if oflags & P.RAS_O_ZIGZAG:
        a, b = b, a
    if oflags & P.RAS_O_SQUARE:
        a = a * torch.abs(a)
        b = b * torch.abs(b)
    return line_val(line, phase, a, b)


def rasg_selfmod_sample(func: int, line: int, level: int, alpha: int,
                        oflags: int, cycle, phase):
    """rasg_shape(rasg_map(cycle), phase) as the JAX reference's self-PM
    scan body computes it. There XLA's algebraic simplifier folds a
    Perlin amplitude pa other than 1 into the map's constant scale c:
    a * (pa * phase) becomes (xa * phase) * (c * pa), which rounds
    differently where c or pa is not a power of two."""
    xa, xb, c = _rasg_terms(func, level, alpha, oflags, cycle)
    if c is None:
        return rasg_shape(line, oflags, phase, xa, xb)
    pa = _perlin_amp(line, oflags)
    if not oflags & P.RAS_O_PERLIN or pa == 1.0:
        return rasg_shape(line, oflags, phase, xa * c, xb * c)
    k = float(np.float32(c) * np.float32(pa))
    a = (xa * phase) * k
    b = (xb * (phase - 1.0)) * k
    return rasg_shape(line, oflags & ~P.RAS_O_PERLIN, phase, a, b)


def rasg_fill_plain(func: int, line: int, level: int, alpha: int,
                    oflags: int, base, B: int, pofs=None, pscale=P31,
                    inc=None, ln=None, csum=None, incs=None):
    """Plain version of kernel 11: the flat renderer's RasG cyclor
    (K_RCYCLE) and the run (K_RRUN) that reads it, over rows of B
    samples. The u64 count of sample i of a row (int64 bits, wrapping)
    is ``ftoi(pofs * pscale) + base + count``, ``base`` (*rows) the
    row's start; ``count`` is ``inc * min(i, ln)`` for a per-row
    frequency (``inc``, ``ln`` (*rows) int64) or kernel 3's exclusive
    sum ``csum - incs`` ((*rows, B) int64) for a per-sample one. No
    ``pofs`` ((*rows, B) float32) is no PM input. Returns the (*rows,
    B) float32 samples rasg_shape(rasg_map(cycle), phase)."""
    if csum is None:
        idx = torch.arange(B, device=base.device, dtype=I64)
        excl = base[..., None] + inc[..., None] * torch.minimum(
            idx, ln[..., None])
    else:
        excl = base[..., None] + (csum - incs)
    cph = excl if pofs is None else ftoi(pofs * pscale) + excl
    cycle = (cph >> 32) & M32
    phase = ((cph & M32) >> 1).to(F32) * SCALE31
    a, b = rasg_map(func, level, alpha, oflags, cycle)
    return rasg_shape(line, oflags, phase, a, b)


def rasg_fill(func: int, line: int, level: int, alpha: int, oflags: int,
              base, B: int, pofs=None, pscale=P31, inc=None, ln=None,
              csum=None, incs=None):
    """The RasG cyclor and run (see rasg_fill_plain). On a CUDA tensor
    this launches kernel 11 (``kernels.rasg_fill``)."""
    if base.is_cuda:
        from .. import kernels
        return kernels.rasg_fill(func, line, level, alpha, oflags, base,
                                 B, pofs, pscale, inc, ln, csum, incs)
    return rasg_fill_plain(func, line, level, alpha, oflags, base, B,
                           pofs, pscale, inc, ln, csum, incs)


def line_fill(line_type: int, i_pos, end, v0, vt):
    """sauLine_fill_* (sau/line.c) for a static line type. ``i_pos``:
    u32 absolute positions; ``end``: total samples (integer tensor);
    v0, vt: float32 tensors broadcastable against ``i_pos``."""
    endf = end.to(F32)
    inv_time = torch.ones_like(endf) / endf
    adj = (i_pos - (end.to(I64) & M32) // 2) & M32
    x_mid = asi32(adj).to(F32) * inv_time
    x_pln = i_pos.to(F32) * inv_time
    vm = (v0 + vt) * 0.5
    vd = vt - v0
    half = 0.5
    if line_type == 0:    # cos (vd folded into the x factor)
        s0 = _c(1.5702137061703461473139223358864)
        s1 = _c(-2.568278787380814155456160152724)
        s2 = _c(1.1496958507977182668618673644367)
        x2 = x_mid * x_mid
        xv = x_mid * vd
        return vm + xv * (s0 + x2 * (s1 + x2 * s2))
    if line_type == 1:    # lin (hoisted vd * inv_time)
        k = vd * inv_time
        return vm + asi32(adj).to(F32) * k
    if line_type == 2:    # sah
        return torch.broadcast_to(v0, i_pos.shape).to(F32).clone()

    def f_xpe():
        return vt + (v0 - vt) * expramp6(1.0 - x_pln)

    def f_lge():
        return v0 + (vt - v0) * expramp6(x_pln)

    if line_type == 3:    # exp
        return torch.where(v0 > vt, f_xpe(), f_lge())
    if line_type == 4:    # log
        return torch.where(v0 < vt, f_xpe(), f_lge())
    if line_type == 5:
        return f_xpe()
    if line_type == 6:
        return f_lge()
    if line_type == 7:    # sqe
        x = half - x_mid
        return vt + (v0 - vt) * (x * x)
    if line_type == 8:    # cub
        scale = -2.0 * inv_time
        k = (v0 - vt) * half
        x = asi32(adj).to(F32) * scale
        return vt + ((x * x) * x + 1.0) * k
    if line_type == 9:    # smo
        x = x_pln
        xd = x * vd
        x3d = (x * x) * xd
        return v0 + x3d * ((x * 6.0 + -15.0) * x + 10.0)
    s = asi32(ranfast32(i_pos)).to(F32)
    if line_type == 12:   # uwh
        return vm + (vd * _c(0.5 / 0x7fffffff)) * s
    x = x_mid
    xb0 = x + half
    if line_type == 10:   # ncl
        q = (xb0 + xb0 + -3.0) * xb0 + 1.0
        return vm + ((x + (s * q) * (xb0 * _c(0.5 / 0x7fffffff))) * vd)
    q = 1.0 - xb0         # nhl
    return vm + ((x + (q * s) * (xb0 * _c(2 * 0.5 / 0x7fffffff))) * vd)


def line_val_at(line_type: int, pos, end, v0, vt):
    """Single value at the current position (sauLine_get of 1
    sample, as sauLine_copy uses it)."""
    i_pos = (torch.as_tensor(pos).to(I64) & M32).reshape(1)
    return line_fill(line_type, i_pos, torch.as_tensor(end), v0, vt)[0]


# -- PILUT wave oscillator ---------------------------------------------------

def wave_tables(device):
    """(luts, piluts) as float32 tensors of shape (12, 2048) on
    ``device``, from the port's own table build."""
    luts, piluts = W.get_tables()
    return (torch.from_numpy(np.ascontiguousarray(luts)).to(device),
            torch.from_numpy(np.ascontiguousarray(piluts)).to(device))


def wosc_cells(phase_buf):
    """PILUT cell index of each u32 phase."""
    return phase_buf >> SLENBITS


def taps_at(pilut, cell):
    """Hermite taps (4, ...) of cell indices of any shape: rows
    pilut[(cell - 1 .. cell + 2) & 2047] (jdsp.taps_at of one cell)."""
    off = torch.arange(-1, 3, device=cell.device, dtype=I64)
    off = off.reshape((4,) + (1,) * cell.dim())
    return pilut[(cell.to(I64)[None] + off) & LENMASK]


def gather_taps_plain(pilut, cells):
    """Plain version of kernels 7/8: Hermite taps (4, B) of (B,)
    cells."""
    return taps_at(pilut, cells)


def gather_taps(pilut, cells):
    """Hermite taps (4, B) of (B,) cells (see gather_taps_plain). On a
    CUDA tensor this launches kernel 7/8 (``kernels.gather_taps``)."""
    if cells.is_cuda:
        from .. import kernels
        return kernels.gather_taps(pilut, cells)
    return gather_taps_plain(pilut, cells)


def _herp64_coeffs(s0, s1, s2, s3):
    """The float64 coefficients (c0, c1, c2, c3) of the Hermite of
    sauWave_get_herp (sau/wave.h:127-141) from its four float32 taps:
    the tap differences round in float32, everything else in float64
    per op, left to right."""
    c0 = s1.to(F64)
    c1 = 0.5 * (s2 - s0).to(F64)
    c2 = s0.to(F64) - 2.5 * s1.to(F64)
    c2 = c2 + (2.0 * s2).to(F64)
    c2 = c2 - 0.5 * s3.to(F64)
    c3 = 0.5 * (s3 - s0).to(F64)
    c3 = c3 + 1.5 * (s1 - s2).to(F64)
    return c0, c1, c2, c3


def _horner(c0, c1, c2, c3, x_f32):
    """((c3 x + c2) x + c1) x + c0 in float64, one op at a time."""
    x = x_f32.to(F64)
    r = c3 * x
    r = r + c2
    r = r * x
    r = r + c1
    r = r * x
    return r + c0


def _herp64_taps(s0, s1, s2, s3, x_f32):
    """Hermite interpolation as sauWave_get_herp (sau/wave.h:127-141)
    evaluates it: the tap differences round in float32, everything
    else in float64 per op, left to right."""
    return _horner(*_herp64_coeffs(s0, s1, s2, s3), x_f32)


def _wosc_s64(wave: int, pd, x1, x2, taps1, taps2):
    """PILUT differentiation sample as wosc.h:247-261 computes it:
    float64 Is values, the correctly rounded float32 factor
    diff_scale / pd widened to float64, one final float32 rounding.
    ``pd``: signed phase steps (int64). Returns (s, valid)."""
    Is1 = _herp64_taps(taps1[0], taps1[1], taps1[2], taps1[3], x1)
    Is2 = _herp64_taps(taps2[0], taps2[1], taps2[2], taps2[3], x2)
    return _wosc_s_is(wave, pd, Is1, Is2)


def _wosc_s_is(wave: int, pd, Is1, Is2):
    """_wosc_s64 from the float64 Is values of both phases."""
    diff_scale = float(np.float32(W.dvscale(wave)))
    diff_offset = float(np.float32(W.dvoffset(wave)))
    valid = pd != 0
    pdf = torch.where(valid, pd, torch.ones_like(pd)).to(F32)
    xf = fdiv(diff_scale, pdf).to(F64)
    s = Is2 - Is1
    s = s * xf
    s = (s + diff_offset).to(F32)
    return torch.where(valid, s, torch.zeros_like(s)), valid


def is64_plain(pilut, ph):
    """Plain version of kernel 9: Is(phase) in float64 of (N,) u32
    phases (int64), the Hermite of _herp64_taps over the gathered
    taps -- the exact chain the JAX package's CPU platform evaluates
    (the TPU's _gather_is_window returns a df64 pair instead)."""
    taps = gather_taps_plain(pilut, wosc_cells(ph))
    x = (ph & SLENMASK).to(F32) * X_SCALE
    return _herp64_taps(taps[0], taps[1], taps[2], taps[3], x)


def is64(pilut, ph):
    """Is(phase) in float64 (see is64_plain). On a CUDA tensor this
    launches kernel 9 (``kernels.is64``)."""
    if ph.is_cuda:
        from .. import kernels
        return kernels.is64(pilut, ph)
    return is64_plain(pilut, ph)


def hermite_coeffs(pilut):
    """The Hermite coefficients of every PILUT cell, (2048, 4) float64
    with columns (c3, c2, c1, c0): _herp64_taps's polynomial at the
    cell's taps, op for op. They depend on the cell alone, so Is(phase)
    is the Horner of the phase's cell row (is64_coeffs), bit for bit;
    kernel 5 keeps this table in shared memory."""
    s0, s1, s2, s3 = taps_at(pilut, torch.arange(W.LEN,
                                                 device=pilut.device))
    c0, c1, c2, c3 = _herp64_coeffs(s0, s1, s2, s3)
    return torch.stack([c3, c2, c1, c0], 1)


def is64_coeffs(coeffs, ph):
    """Is(phase) in float64 of u32 phases (int64) from the table of
    hermite_coeffs: the Horner of _herp64_taps on the phase's cell row,
    equal to is64_plain bit for bit."""
    c = coeffs[wosc_cells(ph)]
    x = (ph & SLENMASK).to(F32) * X_SCALE
    return _horner(c[..., 3], c[..., 2], c[..., 1], c[..., 0], x)


def last_valid_fill(s_raw, valid, seed):
    """wosc's pd == 0 hold over whole rows (wosc.h:247-261), the
    counterpart of flat._last_valid_fill (flat.py:99) and kernel 1's
    plain hold: out[i] = s_raw at the last valid j <= i of its row,
    else the row's seed. (V, L) inputs, (V,) seeds."""
    L = s_raw.shape[-1]
    idx = torch.arange(L, device=s_raw.device, dtype=I64)
    last = torch.cummax(torch.where(valid, idx, -1), dim=-1).values
    got = torch.gather(s_raw, -1, last.clamp(min=0))
    return torch.where(last >= 0, got, seed[:, None])


def forward_fill_last_valid(s, valid, seed):
    """Scan-semantics forward fill of (n, L) rows with (n,) seeds (see
    last_valid_fill, its plain version). On a CUDA tensor this launches
    kernel 10 (``kernels.ffill``)."""
    if s.is_cuda:
        from .. import kernels
        return kernels.ffill(s, valid, seed)
    return last_valid_fill(s, valid, seed)


def forward_fill_valid_plain(s_raw, valid, prev_s, length):
    """Plain version of kernel 10 with a length: jdsp.forward_fill_valid
    (jdsp.py:816) over (n, B) rows, with (n,) ``prev_s`` and
    ``length``: out[i] = s_raw at the last valid j <= i, else prev_s --
    in the reference's three branches, chosen per row: no invalid
    sample in range gives s_raw as it is; isolated invalid samples the
    one-step fill; a run of two or more the scan (last_valid_fill). The
    branches differ past ``length`` (the phase is frozen there,
    pd == 0), so the choice is kept exactly."""
    idx = torch.arange(s_raw.shape[1], device=s_raw.device)[None, :]
    bad = ~valid & (idx < length[:, None])
    pair = bad[:, 1:] & bad[:, :-1]
    shift = torch.cat([prev_s.to(F32)[:, None], s_raw[:, :-1]], 1)
    fill1 = torch.where(valid, s_raw, shift)
    slow = last_valid_fill(s_raw, valid, prev_s.to(F32))
    out = torch.where(pair.any(1)[:, None], slow, fill1)
    return torch.where(bad.any(1)[:, None], out, s_raw)


def forward_fill_valid(s_raw, valid, prev_s, length, plain=False):
    """The sequential engine's pd == 0 hold (see
    forward_fill_valid_plain). On a CUDA tensor, unless ``plain``, this
    is one launch of kernel 10 (``kernels.ffill`` with the lengths)."""
    if s_raw.is_cuda and not plain:
        from .. import kernels
        return kernels.ffill(s_raw, valid, prev_s, length)
    return forward_fill_valid_plain(s_raw, valid, prev_s, length)


def wosc_run_taps(pilut, wave: int, phase_buf, prev_phase, prev_s,
                  reset, length, taps2=None, plain=False):
    """jdsp.wosc_run_taps (jdsp.py:2479) over (n, B) rows of u32
    phases with (n,) state: prev_phase, prev_s, reset (bool) and
    length. ``taps2``: the (4, n * B) taps of the rows' cells, gathered
    by the caller for a same-level group; without them Is comes from
    kernel 9. The previous sample's Is is the current one shifted by
    one (p_prev[i] == ph[i - 1] past the head), with the head's Is from
    its own taps: bit for bit the reference's shifted-taps chain, which
    evaluates the same Hermite on the same inputs. Returns (out (n, B),
    new_prev_phase, new_prev_s)."""
    n, B = phase_buf.shape
    pp = torch.where(reset, (phase_buf[:, 0] - W.SLEN) & M32, prev_phase)
    p_prev = torch.cat([pp[:, None], phase_buf[:, :-1]], 1)
    pd = asi32((phase_buf - p_prev) & M32)
    if taps2 is not None:
        x2 = (phase_buf & SLENMASK).to(F32).reshape(-1) * X_SCALE
        Is2 = _herp64_taps(taps2[0], taps2[1], taps2[2], taps2[3], x2)
    else:
        Is2 = (is64_plain if plain else is64)(pilut, phase_buf.reshape(-1))
    Is2 = Is2.reshape(n, B)
    ptaps = taps_at(pilut, wosc_cells(pp))
    xh = (pp & SLENMASK).to(F32) * X_SCALE
    Ish = _herp64_taps(ptaps[0], ptaps[1], ptaps[2], ptaps[3], xh)
    Is1 = torch.cat([Ish[:, None], Is2[:, :-1]], 1)
    s_raw, valid = _wosc_s_is(wave, pd, Is1, Is2)
    out = forward_fill_valid(s_raw, valid, prev_s, length, plain)
    has = length > 0
    li = torch.clamp(length - 1, min=0)
    rows = torch.arange(n, device=phase_buf.device)
    new_pp = torch.where(has, phase_buf[rows, li], prev_phase)
    new_ps = torch.where(has, out[rows, li], prev_s)
    return out, new_pp, new_ps


def wosc_s_filled_plain(pilut, wave: int, ph, pp, ps, first_ir,
                        do_rst, rst_prev):
    """Plain version of kernel 1: the filled oscillator output of
    (V, L) u32 phase rows. Each row's head pairs with its seed phase
    ``pp``; where ``do_rst`` holds, the sample at row index
    ``first_ir`` pairs with ``rst_prev`` instead (an unconsumed
    reset, wosc.h:215-231); pd == 0 holds the last valid sample,
    seeded with ``ps``. Seeds are (V,) tensors (phases u32 in int64,
    ``do_rst`` bool). Equals flat._wosc_s64 composed with the last
    valid fill."""
    V, L = ph.shape
    p_prev = torch.cat([pp[:, None], ph[:, :-1]], dim=1)
    rows = torch.arange(V, device=ph.device)
    fi = first_ir.to(I64)
    p_prev[rows, fi] = torch.where(do_rst, rst_prev, p_prev[rows, fi])
    taps2 = gather_taps_plain(pilut, wosc_cells(ph.reshape(-1)))
    taps1 = gather_taps_plain(pilut, wosc_cells(p_prev.reshape(-1)))
    x1 = (p_prev & SLENMASK).to(F32).reshape(-1) * X_SCALE
    x2 = (ph & SLENMASK).to(F32).reshape(-1) * X_SCALE
    pd = asi32((ph - p_prev) & M32).reshape(-1)
    s_raw, valid = _wosc_s64(wave, pd, x1, x2, taps1, taps2)
    return last_valid_fill(s_raw.reshape(V, L), valid.reshape(V, L),
                           ps.to(F32))


def wosc_s_filled(pilut, wave: int, ph, pp, ps, first_ir, do_rst,
                  rst_prev):
    """Filled oscillator output (see wosc_s_filled_plain). On a CUDA
    tensor this launches kernel 1 (``kernels.wosc_fill``)."""
    if ph.is_cuda:
        from .. import kernels
        return kernels.wosc_fill(pilut, wave, ph, pp, ps, first_ir,
                                 do_rst, rst_prev)
    return wosc_s_filled_plain(pilut, wave, ph, pp, ps, first_ir,
                               do_rst, rst_prev)


# -- wrapping prefix sum -----------------------------------------------------

def prefix_sum_plain(x):
    """Plain version of kernel 2: inclusive prefix sum of u32 values
    (int64 in [0, 2^32)) that wraps mod 2^32, along the last axis of a
    1-D tensor or of (V, L) rows, as a log-depth doubling scan (the
    counterpart of lax.associative_scan(add))."""
    y = x & M32
    n = y.shape[-1]
    k = 1
    while k < n:
        y = torch.cat([y[..., :k], (y[..., k:] + y[..., :-k]) & M32], -1)
        k *= 2
    return y


def prefix_sum(x):
    """Inclusive wrapping u32 prefix sum of a 1-D int64 tensor, or of
    each row of a (V, L) one. On a CUDA tensor this launches kernel 2
    (``kernels.scan_add_u32``) once."""
    if x.is_cuda:
        from .. import kernels
        return kernels.scan_add_u32(x)
    return prefix_sum_plain(x)


def prefix_sum_u64_plain(x):
    """Plain version of kernel 3: inclusive prefix sum of u64 values
    held as the bits of int64 (adds wrap in two's complement) along the
    last axis of a 1-D tensor or of (V, L) rows, as a log-depth
    doubling scan."""
    y = x
    n = y.shape[-1]
    k = 1
    while k < n:
        y = torch.cat([y[..., :k], y[..., k:] + y[..., :-k]], -1)
        k *= 2
    return y


def prefix_sum_u64(x):
    """Inclusive wrapping u64 prefix sum of a 1-D int64 tensor, or of
    each row of a (V, L) one. On a CUDA tensor this launches kernel 3
    (``kernels.scan_add_u64``) once."""
    if x.is_cuda:
        from .. import kernels
        return kernels.scan_add_u64(x)
    return prefix_sum_u64_plain(x)


def prefix_sum_rows_plain(x, bits: int):
    """Plain version of ``prefix_sum_rows``: a log-depth doubling scan
    along each row."""
    return prefix_sum_plain(x) if bits == 32 else prefix_sum_u64_plain(x)


def prefix_sum_rows(x, bits: int):
    """Row-wise inclusive prefix sum of (n, B) int64 rows of u32 values
    wrapping mod 2^32 (``bits`` 32) or of u64 bits wrapping mod 2^64
    (64): jdsp.prefix_sum_rows. On a CUDA tensor this is one launch of
    kernel 2 or 3 over the rows."""
    return prefix_sum(x) if bits == 32 else prefix_sum_u64(x)


def scan_max_i32_plain(x):
    """Plain version of kernel 4: max(0, x[0], ..., x[i]) along the
    last axis of a 1-D int32 tensor or of (V, L) rows, as a log-depth
    doubling scan (identity 0, as the TPU kernel has it: the running
    max on inputs >= 0)."""
    y = torch.clamp(x, min=0)
    k = 1
    while k < y.shape[-1]:
        y = torch.cat([y[..., :k], torch.maximum(y[..., k:], y[..., :-k])],
                      -1)
        k *= 2
    return y


def scan_max_i32(x):
    """Running max with identity 0 of a 1-D int32 tensor, or of each row
    of a (V, L) one (see scan_max_i32_plain). On a CUDA tensor this
    launches kernel 4 (``kernels.scan_max_i32``) once."""
    if x.is_cuda:
        from .. import kernels
        return kernels.scan_max_i32(x)
    return scan_max_i32_plain(x)


def row_cumsum(x, bits: int):
    """Inclusive prefix sum over the few rows of a chunk (the last
    axis: (nc,), or (V, nc) for a slab of voices), wrapping mod 2^32
    (u32 values in int64) or 2^64 (u64 bits in int64): the counterpart
    of the JAX renderer's ``jnp.cumsum`` of row totals."""
    y = torch.cumsum(x, -1)
    return y & M32 if bits == 32 else y


# -- self-PM recurrences ------------------------------------------------------

def _active_columns(act):
    """Sample indices where any row is active: the only steps that
    change state or write a non-zero output."""
    return torch.nonzero(act.any(0)).flatten().tolist()


def wosc_selfmod_plain(pilut, wave: int, ph, am, act, pp0, ps0, fb0):
    """Plain version of kernel 5: wosc self-PM (wosc.h:273-310) over
    (V, L) rows, step by step, as jdsp.wosc_selfmod_masked's float64
    step: phase = ph + llrintf(fb * am * 2^31) mod 2^32, s from the
    pair (pp, phase) as wosc_diff gives it (held where pd == 0),
    fb = (fb + s) / 2. ``ph`` u32 (int64), ``am`` float32, ``act``
    bool; (V,) seeds pp0 (u32, an unconsumed reset already resolved
    by the caller), ps0, fb0. Inactive samples output 0 and leave the
    state alone. Returns (out (V, L) float32, pp, ps, fb)."""
    V, L = ph.shape
    pp = pp0.to(I64)
    ps = ps0.to(F32)
    fb = fb0.to(F32)
    out = torch.zeros((V, L), dtype=F32, device=ph.device)
    for j in _active_columns(act):
        a = act[:, j]
        phase = (ph[:, j] + ftoi(fb * am[:, j] * P31)) & M32
        taps1 = gather_taps_plain(pilut, wosc_cells(pp))
        taps2 = gather_taps_plain(pilut, wosc_cells(phase))
        x1 = (pp & SLENMASK).to(F32) * X_SCALE
        x2 = (phase & SLENMASK).to(F32) * X_SCALE
        pd = asi32((phase - pp) & M32)
        s, valid = _wosc_s64(wave, pd, x1, x2, taps1, taps2)
        s = torch.where(valid, s, ps)
        pp = torch.where(a & valid, phase, pp)
        ps = torch.where(a, s, ps)
        fb = torch.where(a, (fb + s) * 0.5, fb)
        out[:, j] = torch.where(a, s, torch.zeros_like(s))
    return out, pp, ps, fb


def wosc_selfmod(pilut, wave: int, ph, am, act, pp0, ps0, fb0):
    """wosc self-PM (see wosc_selfmod_plain). On a CUDA tensor this
    launches kernel 5 (``kernels.wosc_selfmod``)."""
    if ph.is_cuda:
        from .. import kernels
        return kernels.wosc_selfmod(pilut, wave, ph, am, act, pp0, ps0,
                                    fb0)
    return wosc_selfmod_plain(pilut, wave, ph, am, act, pp0, ps0, fb0)


def rasg_selfmod_plain(func: int, line: int, level: int, alpha: int,
                       oflags: int, phase, cycle, am, act, ps0, fb0):
    """Plain version of kernel 6: RasG self-PM (rasg.h:242-294,
    764-772) over (V, L) rows, step by step, as
    jdsp.rasg_selfmod_masked: phase += fb * am / 2, the cycle moves by
    floor(phase), s = rasg_shape(rasg_map(cycle)), fb = (fb + s + ps)
    / 2. ``phase`` float32, ``cycle`` u32 (int64), ``am`` float32,
    ``act`` bool; (V,) seeds ps0, fb0. Returns (out, ps, fb)."""
    V, L = phase.shape
    ps = ps0.to(F32)
    fb = fb0.to(F32)
    out = torch.zeros((V, L), dtype=F32, device=phase.device)
    for j in _active_columns(act):
        a = act[:, j]
        ph = phase[:, j] + fb * am[:, j] * 0.5
        adj = floor_i32(ph)
        cyc = (cycle[:, j] + adj) & M32
        ph = ph - adj.to(F32)
        s = rasg_selfmod_sample(func, line, level, alpha, oflags, cyc, ph)
        fb = torch.where(a, (fb + s + ps) * 0.5, fb)
        ps = torch.where(a, s, ps)
        out[:, j] = torch.where(a, s, torch.zeros_like(s))
    return out, ps, fb


def rasg_selfmod(func: int, line: int, level: int, alpha: int,
                 oflags: int, phase, cycle, am, act, ps0, fb0):
    """RasG self-PM (see rasg_selfmod_plain). On a CUDA tensor this
    launches kernel 6 (``kernels.rasg_selfmod``)."""
    if phase.is_cuda:
        from .. import kernels
        return kernels.rasg_selfmod(func, line, level, alpha, oflags,
                                    phase, cycle, am, act, ps0, fb0)
    return rasg_selfmod_plain(func, line, level, alpha, oflags, phase,
                              cycle, am, act, ps0, fb0)


# -- the sequential engine's block forms --------------------------------------

def noise_run(ntype: int, n0, nprev, length, B: int, plain=False):
    """sauNoiseG_run (noise.h:177-185) over one block of B samples, as
    jdsp.noise_run (jdsp.py:1524): counter ``n0`` and previous value
    ``nprev`` (0-d u32 in int64), ``length`` a 0-d tensor. Red noise
    sums with kernel 2. Returns (out (B,) float32, new_prev)."""
    dev = n0.device
    idx = torch.arange(B, device=dev, dtype=I64)
    n = (n0 + idx) & M32
    has = length > 0
    # a (1,) index: a 0-d tensor index reads its value on the host
    li = torch.clamp(length - 1, min=0).reshape(1)
    if ntype == 0:    # white
        return asi32(ranfast32(n)).to(F32) * SCALE31, nprev
    if ntype == 1:    # gauss
        return franssgauss32(n), nprev

    def sbin():
        return (asi32(ranfast32(n)) >> 31) * 2 + 1

    odd = (n & 1) != 0
    if ntype == 2:    # binary
        return sbin().to(F32), nprev
    if ntype == 3:    # ternary
        return torch.where(odd, sbin().to(F32),
                           torch.zeros((), dtype=F32, device=dev)), nprev
    if ntype == 4:    # red
        inc = torch.where(idx < length, (asi32(ranfast32(n)) >> 6) & M32,
                          torch.zeros_like(n))
        scan = prefix_sum_plain if plain else prefix_sum
        sums = (nprev + scan(inc)) & M32
        out = asi32(foldhd32(sums)).to(F32) * SCALE31
        return out, torch.where(has, sums[li][0], nprev)
    if ntype == 5:    # violet
        r = ranfast32(n)
        s0v = torch.cat([nprev.reshape(1), r[:-1]])
        out = asi32(((r >> 1) - (s0v >> 1)) & M32).to(F32) * SCALE31
        return out, torch.where(has, r[li][0], nprev)
    sb1 = torch.where(odd, sbin(), torch.zeros_like(n))    # blue-violet
    sb0 = torch.cat([asi32(nprev).reshape(1), sb1[:-1]])
    out = (sb1 - sb0).to(F32)
    return out, torch.where(has, sb1[li][0] & M32, nprev)


def wosc_selfmod_scan(pilut, wave: int, phase_buf, abuf, prev_phase,
                      prev_s, fb_s, reset, length, plain=False):
    """jdsp.wosc_selfmod_scan (jdsp.py:884) over one block: kernel 5
    on one row with act = idx < length, an unconsumed ``reset``
    resolved into the seed phase (the row's first phase minus SLEN).
    The scan updates ps on active & valid samples and kernel 5 on
    active ones; the two agree, since s is ps where pd == 0. Returns
    (out (B,), pp, ps, fb)."""
    B = phase_buf.shape[0]
    pp0 = torch.where(reset, (phase_buf[0] - W.SLEN) & M32, prev_phase)
    act = torch.arange(B, device=phase_buf.device) < length
    run = wosc_selfmod_plain if plain else wosc_selfmod
    out, pp, ps, fb = run(pilut, wave, phase_buf[None], abuf[None],
                          act[None], pp0.reshape(1),
                          prev_s.reshape(1), fb_s.reshape(1))
    return out[0], pp[0], ps[0], fb[0]


def rasg_selfmod_scan(func: int, line: int, level: int, alpha: int,
                      oflags: int, phase_buf, cycle_buf, abuf, prev_s,
                      fb_s, length, plain=False):
    """jdsp.rasg_selfmod_scan (jdsp.py:1486) over one block: kernel 6
    on one row with act = idx < length. Returns (out (B,), ps, fb)."""
    B = phase_buf.shape[0]
    act = torch.arange(B, device=phase_buf.device) < length
    run = rasg_selfmod_plain if plain else rasg_selfmod
    out, ps, fb = run(func, line, level, alpha, oflags, phase_buf[None],
                      cycle_buf[None], abuf[None], act[None],
                      prev_s.reshape(1), fb_s.reshape(1))
    return out[0], ps[0], fb[0]
