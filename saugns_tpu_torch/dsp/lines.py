"""Line (sweep) shapes: fill / map / val function families.

Port of sau/line.c + sau/line.h. All 13 shapes: cos, lin, sah, exp, log,
xpe, lge, sqe, cub, smo, ncl, nhl, uwh. Fills are closed-form in sample
coordinates ((i+pos)/time) so they are block-split independent; maps take
an x-in-[0,1] buffer to a trajectory between two endpoint buffers
(used by the R oscillator); vals are the scalar forms.

NumPy implementations, float32 like the C code.
"""
from __future__ import annotations

import numpy as np

from .prim import np_ranfast32

LINE_NAMES = ('cos', 'lin', 'sah', 'exp', 'log', 'xpe', 'lge', 'sqe',
              'cub', 'smo', 'ncl', 'nhl', 'uwh')
N_cos, N_lin, N_sah, N_exp, N_log, N_xpe, N_lge, N_sqe, N_cub, N_smo, \
    N_ncl, N_nhl, N_uwh = range(13)
LINE_NAMED = 13

# Perlin amplitude coefficients (sau/line.h:18-32)
PERLIN_AMP = np.array([
    2.0, 2.0, 1.0, 1.55845810035, 1.55845810035, 1.55845810035,
    1.55845810035, 1.89339094650, 2.0, 2.0, 2.0, 1.89339094650, 1.0,
], dtype=np.float32)

f32 = np.float32
INT32_MAX = 0x7fffffff


def sinramp(x):
    """Scaled/shifted sine ramp, range -0.5..0.5 (sau/line.h:174-183)."""
    s0 = f32(1.5702137061703461473139223358864)
    s1 = f32(-2.568278787380814155456160152724)
    s2 = f32(1.1496958507977182668618673644367)
    x = np.asarray(x, dtype=np.float32)
    x2 = x * x
    return x * (s0 + x2 * (s1 + x2 * s2))


def expramp6(x):
    """2011 exponential curve approximation (sau/line.h:195-200)."""
    x = np.asarray(x, dtype=np.float32)
    x2 = x * x
    x3 = x2 * x
    return x3 + (x2 * x3 - x2) * (x * f32(629.0 / 1792.0)
                                  + x2 * f32(1163.0 / 1792.0))


def _x_f32(x):
    return np.asarray(x, dtype=np.float32)


# -- val functions (x, a, b) -> value; all vectorizable ----------------------

def val_sah(x, a, b):
    return np.broadcast_arrays(np.asarray(a, dtype=np.float32),
                               _x_f32(x))[0].copy()


def val_lin(x, a, b):
    x = _x_f32(x)
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return a + (b - a) * x


def val_cos(x, a, b):
    x = _x_f32(x)
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return a + (b - a) * (sinramp(x - f32(0.5)) + f32(0.5))


def _expramp6_ref(t):
    """expramp6 with the reference build's rounding order (gcc -O3
    -ffast-math reassociates sau/line.h:195-200 into
    t3 + t2*((t3 - 1)*(t2*B + t*A)); verified against the compiled
    sauLine_fill_xpe/map_xpe loops)."""
    t = np.asarray(t, np.float32)
    A = f32(629.0 / 1792.0)
    B = f32(1163.0 / 1792.0)
    t2 = t * t
    tA = t * A
    t3 = t2 * t
    p = t2 * B + tA
    return t3 + t2 * ((t3 + f32(-1.0)) * p)


def val_exp(x, a, b):
    x = _x_f32(x)
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    up = a + (b - a) * _expramp6_ref(x)
    down = b + (a - b) * _expramp6_ref(f32(1.0) - x)
    return np.where(a > b, down, up)


def val_log(x, a, b):
    x = _x_f32(x)
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    down = b + (a - b) * _expramp6_ref(f32(1.0) - x)
    up = a + (b - a) * _expramp6_ref(x)
    return np.where(a < b, down, up)


def val_xpe(x, a, b):
    x = _x_f32(x)
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return b + (a - b) * _expramp6_ref(f32(1.0) - x)


def val_lge(x, a, b):
    x = _x_f32(x)
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return a + (b - a) * _expramp6_ref(x)


def val_sqe(x, a, b):
    x = f32(1.0) - _x_f32(x)
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return b + (a - b) * (x * x)


def val_cub(x, a, b, tail=False):
    """map_cub body form: b + (x1^3 + 1)*k with k = (a-b)*0.5; gcc's
    scalar/2-wide epilogues (``tail``) group as b + (x1^3*k + k)."""
    x1 = f32(0.5) - _x_f32(x)
    x1 = x1 + x1
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    k = (a - b) * f32(0.5)
    x3 = (x1 * x1) * x1
    if tail:
        return b + (x3 * k + k)
    return b + (x3 + f32(1.0)) * k


def val_smo(x, a, b):
    x = _x_f32(x)
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    d = b - a
    x3d = ((d * x) * (x * x))
    return a + x3d * ((x * f32(6.0) + f32(-15.0)) * x + f32(10.0))


def _seed_from_x(x):
    """union {float f; int32_t i;} bit reinterpretation (sau/line.h:246-249)."""
    return np.asarray(x, dtype=np.float32).view(np.uint32)


def val_uwh(x, a, b):
    x = _x_f32(x)
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    s = np_ranfast32(_seed_from_x(x)).view(np.int32)
    return a + (b - a) * (f32(0.5) + f32(0.5 * (0.5 ** 31))
                          * s.astype(np.float32))


def val_ncl(x, a, b):
    x = _x_f32(x)
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    q = (x + x + f32(-3.0)) * x + f32(1.0)
    s = np_ranfast32(_seed_from_x(x)).view(np.int32)
    return a + ((x + (s.astype(np.float32) * q) * (x * f32(0.5 * 0.5 ** 31)))
                * (b - a))


def val_nhl(x, a, b):
    x = _x_f32(x)
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    q = f32(1.0) - x
    s = np_ranfast32(_seed_from_x(x)).view(np.int32)
    return a + ((x + (q * s.astype(np.float32)) * (x * f32(0.5 ** 31)))
                * (b - a))


VAL_FUNCS = (val_cos, val_lin, val_sah, val_exp, val_log, val_xpe, val_lge,
             val_sqe, val_cub, val_smo, val_ncl, val_nhl, val_uwh)


# -- fill functions -----------------------------------------------------------
# fill(len, v0, vt, pos, time, mulbuf) -> float32[len]
# Mirrors sau/line.c fill semantics, incl. the specialized midpoint forms
# (lin/cos/sqe/cub/ncl/nhl use adj_pos = pos - time/2; sau/line.c:80-212).
#
# Rounding orders replicate what gcc -O3 -ffast-math actually emits for
# the reference build (verified instruction-by-instruction against the
# compiled sauLine_fill_* loops): loop-invariant factors are hoisted
# (lin: vd*inv_time; cub: (v0-vt)*0.5) and polynomial multiplies are
# reassociated (cos/smo fold vd into the x factor; xpe/lge evaluate
# expramp6 as x3 + x2*((x3-1)*(x*A + x2*B))).  Sweep values feed phasor
# integrators, so every rounding here must match the reference binary
# bit-for-bit or FM scripts drift audibly.

def _mul(v, mulbuf):
    return v * mulbuf.astype(np.float32) if mulbuf is not None else v


def fill_sah(length, v0, vt, pos, time, mulbuf):
    v = np.full(length, f32(v0), dtype=np.float32)
    return _mul(v, mulbuf)


def fill_lin(length, v0, vt, pos, time, mulbuf):
    adj_pos = np.uint32((int(pos) - int(time) // 2) & 0xffffffff).astype(np.int32)
    inv_time = f32(1.0) / f32(time)
    vm = (f32(v0) + f32(vt)) * f32(0.5)
    k = (f32(vt) - f32(v0)) * inv_time   # hoisted: vd*inv, one rounding
    i = np.arange(length, dtype=np.int32)
    xi = (i + adj_pos).astype(np.float32)
    return _mul(vm + xi * k, mulbuf)


def fill_cos(length, v0, vt, pos, time, mulbuf):
    adj_pos = np.uint32((int(pos) - int(time) // 2) & 0xffffffff).astype(np.int32)
    inv_time = f32(1.0) / f32(time)
    vm = (f32(v0) + f32(vt)) * f32(0.5)
    vd = f32(vt) - f32(v0)
    s0 = f32(1.5702137061703461473139223358864)
    s1 = f32(-2.568278787380814155456160152724)
    s2 = f32(1.1496958507977182668618673644367)
    i = np.arange(length, dtype=np.int32)
    x = (i + adj_pos).astype(np.float32) * inv_time
    x2 = x * x
    xv = x * vd                          # vd folded into the x factor
    return _mul(vm + xv * (s0 + x2 * (s1 + x2 * s2)), mulbuf)


def _expramp6_ref(t):
    """expramp6 with the reference build's rounding order:
    t3 + t2*((t3 - 1)*(t2*B + t*A))."""
    A = f32(629.0 / 1792.0)
    B = f32(1163.0 / 1792.0)
    t2 = t * t
    tA = t * A
    t3 = t2 * t
    p = t2 * B + tA
    return t3 + t2 * ((t3 + f32(-1.0)) * p)


def fill_xpe(length, v0, vt, pos, time, mulbuf):
    inv_time = f32(1.0) / f32(time)
    i = np.arange(length, dtype=np.uint32)
    x = (i + np.uint32(pos)).astype(np.float32) * inv_time
    t = f32(1.0) - x
    return _mul(f32(vt) + (f32(v0) - f32(vt)) * _expramp6_ref(t), mulbuf)


def fill_lge(length, v0, vt, pos, time, mulbuf):
    inv_time = f32(1.0) / f32(time)
    i = np.arange(length, dtype=np.uint32)
    x = (i + np.uint32(pos)).astype(np.float32) * inv_time
    return _mul(f32(v0) + (f32(vt) - f32(v0)) * _expramp6_ref(x), mulbuf)


def fill_smo(length, v0, vt, pos, time, mulbuf):
    inv_time = f32(1.0) / f32(time)
    vd = f32(vt) - f32(v0)
    i = np.arange(length, dtype=np.uint32)
    x = (i + np.uint32(pos)).astype(np.float32) * inv_time
    xd = x * vd
    x3d = (x * x) * xd
    poly = (x * f32(6.0) + f32(-15.0)) * x + f32(10.0)
    return _mul(f32(v0) + x3d * poly, mulbuf)


def fill_exp(length, v0, vt, pos, time, mulbuf):
    return (fill_xpe if v0 > vt else fill_lge)(length, v0, vt, pos, time,
                                               mulbuf)


def fill_log(length, v0, vt, pos, time, mulbuf):
    return (fill_xpe if v0 < vt else fill_lge)(length, v0, vt, pos, time,
                                               mulbuf)


def fill_sqe(length, v0, vt, pos, time, mulbuf):
    adj_pos = np.uint32((int(pos) - int(time) // 2) & 0xffffffff).astype(np.int32)
    inv_time = f32(1.0) / f32(time)
    i = np.arange(length, dtype=np.int32)
    x = f32(0.5) - (i + adj_pos).astype(np.float32) * inv_time
    return _mul(f32(vt) + (f32(v0) - f32(vt)) * (x * x), mulbuf)


def fill_cub(length, v0, vt, pos, time, mulbuf):
    adj_pos = np.uint32((int(pos) - int(time) // 2) & 0xffffffff).astype(np.int32)
    inv_time = f32(1.0) / f32(time)
    scale = f32(-2) * inv_time
    k = (f32(v0) - f32(vt)) * f32(0.5)   # hoisted: (x3+1)*k form
    i = np.arange(length, dtype=np.int32)
    x = (i + adj_pos).astype(np.float32) * scale
    x3 = (x * x) * x
    v = f32(vt) + (x3 + f32(1.0)) * k
    if length & 1:
        # gcc's scalar epilogue (the final element of odd lengths)
        # groups as x3*k + k instead of (x3+1)*k
        v[-1] = f32(vt) + (x3[-1] * k + k)
    return _mul(v, mulbuf)


def fill_uwh(length, v0, vt, pos, time, mulbuf):
    scale = f32(0.5 / INT32_MAX)
    vm = (f32(v0) + f32(vt)) * f32(0.5)
    vd = (f32(vt) - f32(v0)) * scale
    i = np.arange(length, dtype=np.uint32)
    s = np_ranfast32(np.uint32(pos) + i).view(np.int32)
    return _mul(vm + vd * s.astype(np.float32), mulbuf)


def fill_ncl(length, v0, vt, pos, time, mulbuf):
    adj_pos = np.uint32((int(pos) - int(time) // 2) & 0xffffffff).astype(np.int32)
    inv_time = f32(1.0) / f32(time)
    scale = f32(0.5 / INT32_MAX)
    vm = (f32(v0) + f32(vt)) * f32(0.5)
    vd = f32(vt) - f32(v0)
    i = np.arange(length, dtype=np.int32)
    x = (i + adj_pos).astype(np.float32) * inv_time
    xb0 = x + f32(0.5)
    q = (xb0 + xb0 + f32(-3.0)) * xb0 + f32(1.0)
    s = np_ranfast32(np.uint32(pos) + i.astype(np.uint32)).view(np.int32)
    return _mul(vm + ((x + (s.astype(np.float32) * q) * (xb0 * scale))
                      * vd), mulbuf)


def fill_nhl(length, v0, vt, pos, time, mulbuf):
    adj_pos = np.uint32((int(pos) - int(time) // 2) & 0xffffffff).astype(np.int32)
    inv_time = f32(1.0) / f32(time)
    scale = f32(2 * 0.5 / INT32_MAX)
    vm = (f32(v0) + f32(vt)) * f32(0.5)
    vd = f32(vt) - f32(v0)
    i = np.arange(length, dtype=np.int32)
    x = (i + adj_pos).astype(np.float32) * inv_time
    xb0 = x + f32(0.5)
    s = np_ranfast32(np.uint32(pos) + i.astype(np.uint32)).view(np.int32)
    q = f32(1.0) - xb0
    return _mul(vm + ((x + (q * s.astype(np.float32)) * (xb0 * scale))
                      * vd), mulbuf)


FILL_FUNCS = (fill_cos, fill_lin, fill_sah, fill_exp, fill_log, fill_xpe,
              fill_lge, fill_sqe, fill_cub, fill_smo, fill_ncl, fill_nhl,
              fill_uwh)


def line_map(line_type, xbuf, end0, end1):
    """Map x positions through a line shape (sau/line.c:16-24).

    Rounding orders mirror the reference build's vectorized loops; for
    'cub' gcc's 2-wide/scalar epilogues use a differently-grouped form,
    so the trailing len&3 elements take val_cub(tail=True)."""
    v = np.asarray(VAL_FUNCS[line_type](xbuf, end0, end1),
                   dtype=np.float32)
    if line_type == N_cub:
        n = len(np.atleast_1d(v))
        n4 = n & ~3
        if n4 < n or n < 4:
            lo = n4 if n >= 4 else 0
            xt = np.atleast_1d(np.asarray(xbuf, np.float32))[lo:]
            at = np.atleast_1d(np.asarray(end0, np.float32))[lo:] \
                if np.ndim(end0) else np.asarray(end0, np.float32)
            bt = np.atleast_1d(np.asarray(end1, np.float32))[lo:] \
                if np.ndim(end1) else np.asarray(end1, np.float32)
            v = np.atleast_1d(v)
            v[lo:] = val_cub(xt, at, bt, tail=True)
    return v
