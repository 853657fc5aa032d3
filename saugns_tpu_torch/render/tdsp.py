"""PyTorch DSP primitives of the flat renderer.

Counterpart of ``saugns_tpu/render/jdsp.py``, limited to what the
wave-oscillator path uses. Every function keeps the exact float32 /
float64 / integer op sequence of its JAX twin, so that results are
bit-equal on every device:

- u32 values live in int64 tensors holding [0, 2^32); wrapping
  arithmetic masks with ``M32`` after each add or multiply.
- No composite op that may contract a multiply into an add
  (``addcmul``, ``lerp``, ``alpha=``).
- Division is always tensor / tensor: ``scalar / tensor`` is computed
  by PyTorch as ``reciprocal * scalar``, and on CUDA ``tensor /
  python_scalar`` as a multiply by the reciprocal -- both round twice.

The two hand-written kernels (``kernels.py``) sit behind
``prefix_sum`` and ``wosc_s_filled``. Each wrapper launches its kernel
for a CUDA tensor and uses the plain version beside it only for a
tensor on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from ..dsp import prim
from ..dsp import wavetables as W

M32 = 0xffffffff
F32 = torch.float32
F64 = torch.float64
I64 = torch.int64

FIBH32 = 0x9e3779b9
HUMMID_INV = float(np.float32(1.0 / prim.HUMMID))
SCALE31 = float(np.float32(2.0 ** -31))
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


def ftoi(x_f32):
    """llrintf: float32 -> int64, rounding half to even."""
    return torch.round(x_f32).to(I64)


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


def gather_taps(pilut, cells):
    """Hermite taps (4, B): rows pilut[(cell - 1 .. cell + 2) & 2047]."""
    off = torch.arange(-1, 3, device=cells.device, dtype=I64)
    return pilut[(cells[None, :] + off[:, None]) & LENMASK]


def taps_at(pilut, cell):
    """Taps (4,) of one cell index (a 0-d tensor)."""
    return gather_taps(pilut, cell.reshape(1))[:, 0]


def _herp64_taps(s0, s1, s2, s3, x_f32):
    """Hermite interpolation as sauWave_get_herp (sau/wave.h:127-141)
    evaluates it: the tap differences round in float32, everything
    else in float64 per op, left to right."""
    x = x_f32.to(F64)
    c0 = s1.to(F64)
    c1 = 0.5 * (s2 - s0).to(F64)
    c2 = s0.to(F64) - 2.5 * s1.to(F64)
    c2 = c2 + (2.0 * s2).to(F64)
    c2 = c2 - 0.5 * s3.to(F64)
    c3 = 0.5 * (s3 - s0).to(F64)
    c3 = c3 + 1.5 * (s1 - s2).to(F64)
    r = c3 * x
    r = r + c2
    r = r * x
    r = r + c1
    r = r * x
    return r + c0


def _wosc_s64(wave: int, pd, x1, x2, taps1, taps2):
    """PILUT differentiation sample as wosc.h:247-261 computes it:
    float64 Is values, the correctly rounded float32 factor
    diff_scale / pd widened to float64, one final float32 rounding.
    ``pd``: signed phase steps (int64). Returns (s, valid)."""
    diff_scale = float(np.float32(W.dvscale(wave)))
    diff_offset = float(np.float32(W.dvoffset(wave)))
    valid = pd != 0
    pdf = torch.where(valid, pd, torch.ones_like(pd)).to(F32)
    xf = fdiv(diff_scale, pdf).to(F64)
    Is1 = _herp64_taps(taps1[0], taps1[1], taps1[2], taps1[3], x1)
    Is2 = _herp64_taps(taps2[0], taps2[1], taps2[2], taps2[3], x2)
    s = Is2 - Is1
    s = s * xf
    s = (s + diff_offset).to(F32)
    return torch.where(valid, s, torch.zeros_like(s)), valid


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
    taps2 = gather_taps(pilut, wosc_cells(ph.reshape(-1)))
    taps1 = gather_taps(pilut, wosc_cells(p_prev.reshape(-1)))
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
    (int64 in [0, 2^32)) that wraps mod 2^32, as a log-depth doubling
    scan (the counterpart of lax.associative_scan(add))."""
    y = x & M32
    n = y.shape[0]
    k = 1
    while k < n:
        y = torch.cat([y[:k], (y[k:] + y[:-k]) & M32])
        k *= 2
    return y


def prefix_sum(x):
    """Inclusive wrapping u32 prefix sum of a 1-D int64 tensor. On a
    CUDA tensor this launches kernel 2 (``kernels.scan_add_u32``)."""
    if x.is_cuda:
        from .. import kernels
        return kernels.scan_add_u32(x)
    return prefix_sum_plain(x)
