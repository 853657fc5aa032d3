"""Wave type LUTs and pre-integrated LUTs (PILUTs).

Port of sau/wave.c table construction: 2048-sample float32 tables built
with half/quarter-wave symmetry, numerically integrated with DC removal
and peak normalization (fill_It, sau/wave.c:77-98), plus the per-type
PILUT coefficients (sau/wave.h:33-70).
"""
from __future__ import annotations

import math

import numpy as np

LENBITS = 11
LEN = 1 << LENBITS  # 2048
LENMASK = LEN - 1
SLENBITS = 32 - LENBITS
SLEN = 1 << SLENBITS
SLENMASK = SLEN - 1
MAXVAL = 1.0

HALFLEN = LEN >> 1
QUARTERLEN = LEN >> 2
DVSCALE_T = LEN * 0.125  # table-domain diff scale (sau/wave.c:20)
IVSCALE = 1.0 / DVSCALE_T

INT32_MIN = -0x80000000

WAVE_NAMES = ('sin', 'tri', 'srs', 'sqr', 'ean', 'cat', 'eto', 'par',
              'mto', 'saw', 'hsi', 'spa')
N_sin, N_tri, N_srs, N_sqr, N_ean, N_cat, N_eto, N_par, N_mto, N_saw, \
    N_hsi, N_spa = range(12)
WAVE_NAMED = 12

# amp_scale, amp_dc, phase_adj (sau/wave.h:33-70)
PICOEFFS = (
    (1.27324153848, 0.0, INT32_MIN // 2),          # sin
    (1.00097751711, 0.0, 0),                       # tri
    (1.52547437578, 0.0, 0),                       # srs
    (2.00000000000, 0.0, INT32_MIN // 2),          # sqr
    (1.20275515347, -0.24257955076, 0),            # ean
    (1.37070880305, -0.23725526633, 0),            # cat
    (-1.26113986272, 0.0, -(INT32_MIN // 2)),      # eto (sign flipped)
    (1.02639326795, -0.33333333333, 0),            # par
    (1.57268451738, -0.23724704918, 0),            # mto
    (-1.00048851979, 0.0, -(INT32_MIN // 2)),      # saw (sign flipped)
    (1.40333871035, -0.36334126990, 0),            # hsi
    (1.07213756312, 0.27322393756, 0),             # spa
)

PICOEFF_AMP_SCALE = np.array([c[0] for c in PICOEFFS], dtype=np.float32)
PICOEFF_AMP_DC = np.array([c[1] for c in PICOEFFS], dtype=np.float32)
PICOEFF_PHASE_ADJ = np.array([np.uint32(c[2] & 0xffffffff)
                              for c in PICOEFFS], dtype=np.uint32)


def _fill_It(in_lut: np.ndarray) -> np.ndarray:
    """Integrate a table (sau/wave.c:77-98), float32 accumulation in
    double like the C code (in_sum is double)."""
    ln = len(in_lut)
    in_dc = float(np.sum(in_lut.astype(np.float64))) / ln
    out = np.empty(ln, dtype=np.float32)
    in_sum = 0.0
    lb = 0.0
    ub = 0.0
    for i in range(ln):
        in_sum += float(in_lut[i]) - in_dc
        x = np.float32(in_sum * IVSCALE)
        if x < lb:
            lb = float(x)
        if x > ub:
            ub = float(x)
        out[i] = x
    out_scale = np.float32(MAXVAL / ((ub - lb) * 0.5))
    out_dc = np.float32(-(ub + lb) * 0.5)
    return ((out + out_dc) * out_scale).astype(np.float32)


def _build_tables():
    """Build all LUTs following sau/wave.c:105-215 exactly."""
    f32 = np.float32
    luts = {name: np.zeros(LEN, dtype=f32) for name in WAVE_NAMES}
    pitri = np.zeros(LEN, dtype=f32)

    sin_l = luts['sin']; sqr_l = luts['sqr']; tri_l = luts['tri']
    srs_l = luts['srs']; hsi_l = luts['hsi']; mto_l = luts['mto']
    spa_l = luts['spa']; par_l = luts['par']; saw_l = luts['saw']
    ean_l = luts['ean']; cat_l = luts['cat']; eto_l = luts['eto']

    val_scale = MAXVAL
    for i in range(HALFLEN):
        x = i * (1.0 / HALFLEN)
        sin_x = f32(math.sin(PI_ := math.pi * x))
        sin_l[i] = f32(val_scale * sin_x)
        sin_l[i + HALFLEN] = f32(-val_scale * sin_x)
        sqr_l[i] = val_scale
        srs_x = f32(math.sqrt(sin_x))
        srs_l[i] = f32(val_scale * srs_x)
        hsi_l[i] = f32(val_scale * (sin_x * 2 - 1.0))
        mto_l[i] = f32(val_scale * (srs_x * 2 - 1.0))
        spa_x = f32(math.sin(math.pi * 0.5 * (1 + x)))
        spa_l[i + QUARTERLEN] = f32(val_scale * (spa_x * 2 - 1.0))
    for i in range(HALFLEN):
        x = i * (1.0 / (HALFLEN - 1))
        x_rev = (HALFLEN - i) * (1.0 / HALFLEN)
        par_l[i + QUARTERLEN] = f32(val_scale * ((x_rev * x_rev) * 2.0 - 1.0))
        saw_l[i] = f32(val_scale * (1.0 - x))
    par_l[HALFLEN + QUARTERLEN] = -val_scale
    spa_l[HALFLEN + QUARTERLEN] = -val_scale
    for i in range(QUARTERLEN):
        x = i * (1.0 / QUARTERLEN)
        x_rev = (QUARTERLEN - i) * (1.0 / QUARTERLEN)
        pitri[i] = f32(val_scale * ((x * x) - 1.0))
        pitri[i + QUARTERLEN] = f32(val_scale * (1.0 - (x_rev * x_rev)))
        tri_l[i] = f32(val_scale * x)
        tri_l[i + QUARTERLEN] = f32(val_scale * x_rev)
        par_l[i] = par_l[HALFLEN - i]
        par_l[i + HALFLEN + QUARTERLEN] = par_l[HALFLEN + QUARTERLEN - i]
        spa_l[i] = spa_l[HALFLEN - i]
        spa_l[i + HALFLEN + QUARTERLEN] = spa_l[HALFLEN + QUARTERLEN - i]
    for i in range(HALFLEN, LEN):
        pitri[i] = -pitri[i - HALFLEN]
        tri_l[i] = -tri_l[i - HALFLEN]
        sqr_l[i] = -val_scale
        saw_l[i] = -saw_l[(LEN - 1) - i]
        hsi_l[i] = -val_scale
        mto_l[i] = -val_scale
        srs_l[i] = -srs_l[i - HALFLEN]
    ean_dc_adj = f32((1.14603185654 - 1.0) / 2.0)
    ean_scale_adj = f32(val_scale / 1.07301592827)
    eto_scale_adj = f32(val_scale / 1.21094322205)
    for i in range(LEN):
        j = (i * 2) if (i * 2) < LEN else (i * 2) - LEN
        ean_l[i] = f32((sin_l[i] + par_l[i] - tri_l[i] + ean_dc_adj)
                       * ean_scale_adj)
        cat_l[i] = f32(sin_l[i] + mto_l[i] - srs_l[i])
        eto_l[i] = f32((sin_l[i] + saw_l[j]) * eto_scale_adj)

    piean = _fill_It(ean_l)
    picat = _fill_It(cat_l)
    pipar = _fill_It(par_l)
    pisrs = _fill_It(srs_l)
    pimto = _fill_It(mto_l)
    pihsi = _fill_It(hsi_l)
    pispa = _fill_It(spa_l)

    lut_arr = np.stack([luts[n] for n in WAVE_NAMES])
    # PILUT assignment per sau/wave.c:49-62: each type's "pre-integrated"
    # table is the anti-derivative-shaped existing or computed table.
    pilut_arr = np.stack([
        sin_l,   # sin  <- sine's integral is -cos == phase-adjusted sin
        pitri,   # tri
        pisrs,   # srs
        tri_l,   # sqr  <- integral of square is triangle
        piean,   # ean
        picat,   # cat
        ean_l,   # eto  <- -It coean
        pipar,   # par
        pimto,   # mto
        par_l,   # saw  <- -It copar
        pihsi,   # hsi
        pispa,   # spa
    ])
    return lut_arr, pilut_arr


def _native_tables():
    """Tables built by the natively-compiled constructor
    (native/fastdsp.c wave_tables_build), or None. The reference
    binary builds its tables with -O3 -ffast-math, where gcc's
    vectorizer perturbs 6 of the 12 tables by ~1 ulp vs strict
    per-op rounding; compiling the same construction with the same
    flags on this machine is the only faithful way to match that
    binary's bits (it was the entire remaining byte divergence on 10
    corpus scripts). SAUGNS_TPU_NATIVE_TABLES=0 keeps the NumPy
    strict-rounding tables."""
    import os
    if os.environ.get('SAUGNS_TPU_NATIVE_TABLES', '1') != '1':
        return None
    try:
        from ..native import get_lib
        lib = get_lib()
        if lib is None:
            return None
        import ctypes
        luts = np.zeros((WAVE_NAMED, LEN), np.float32)
        piluts = np.zeros((WAVE_NAMED, LEN), np.float32)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.wave_tables_build(luts.ctypes.data_as(f32p),
                              piluts.ctypes.data_as(f32p))
        return luts, piluts
    except Exception:
        return None


_cache = None
_source = None


def get_tables():
    """Return (luts, piluts) as float32 arrays of shape (12, 2048)."""
    global _cache, _source
    if _cache is None:
        _cache = _native_tables()
        _source = 'native' if _cache is not None else 'numpy'
        if _cache is None:
            _cache = _build_tables()
        import logging
        logging.getLogger(__name__).info('wave tables: %s build',
                                         _source)
    return _cache


def table_source():
    """'native' (fastdsp.c compiled with cc) or 'numpy': which
    constructor built the tables of this process."""
    get_tables()
    return _source


def dvscale(wave: int) -> float:
    """Differentiation scale constant (sau/wave.h:144-145).
    float32 rounded like the C macro."""
    return float(np.float32(PICOEFFS[wave][0]) * np.float32(0.125)
                 * np.float32(4294967295.0))


def dvoffset(wave: int) -> float:
    return float(np.float32(PICOEFFS[wave][1]))
