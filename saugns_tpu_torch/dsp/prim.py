"""Math primitives: constants, PRNG kit, format conversions.

Port of sau/math.h + sau/math.c semantics with exact integer behavior.
Scalar versions (Python ints, for the parser and planners) plus NumPy
vector versions (for the CPU renderer); the JAX engine has its own
jnp variants in render/engine.py sharing these formulas.
"""
from __future__ import annotations

import math

import numpy as np

PI = 3.14159265358979323846
HUMMID = 632.45553203367586639978  # geometric mean of human hearing range
GLDA = 2.39996322972865332223      # golden angle
GLDA_1_2PI = 0.38196601125010515180
FIBH32 = 0x9e3779b9
FIBH64 = 0x9e3779b97f4a7c15

U32 = 1 << 32
U64 = 1 << 64
M32 = U32 - 1
M64 = U64 - 1


# -- scalar (host/parser) ---------------------------------------------------

def ms_in_samples(time_ms: int, srate: int, carry=None):
    """Convert ms to samples with optional carry (sau/math.h:35-46).
    ``carry`` is a 1-element list when used. Times are nonneg here."""
    time = time_ms * srate
    if carry is not None:
        time += carry[0]
        carry[0] = time % 1000
    return time // 1000


def rint_even(x: float) -> float:
    """C rint() with round-half-even (default FP rounding mode)."""
    r = math.floor(x)
    d = x - r
    if d > 0.5:
        r += 1
    elif d == 0.5:
        if r % 2 != 0:
            r += 1
    return float(r)


def ui32rint(x: float) -> int:
    """(uint32) lrint(x): round-half-even then wrap to u32
    (sau/math.h:49-50). lrint is 64-bit; cast truncates."""
    return int(rint_even(x)) & M32


def i64rint(x: float) -> int:
    """lrint within i64, wrap-around (sau/math.h:58-59). Returns the
    raw (possibly huge) integer; callers mask as needed."""
    return int(rint_even(x))


def cyclepos_dtoui32(x: float) -> int:
    """Cyclical 0-1 value to u32 phase (sau/math.h:70-72)."""
    return ui32rint(math.remainder(x, 1.0) * 4294967296.0)


def weylseq_dtoui32(x: float) -> int:
    """Fractional part to odd Weyl constant (sau/math.h:78-81)."""
    alpha = math.floor(x * 4294967296.0)
    return (int(alpha) | 1) & M32


def d01_from_ui64(x: int) -> float:
    return (x >> 11) * (0.5 ** 53)


def sar32(x: int, s: int) -> int:
    """Portable arithmetic right shift on u32-encoded i32
    (sau/math.h:94-96). Input/output are u32-encoded."""
    xi = x - U32 if x & 0x80000000 else x
    return (xi >> s) & M32


def foldhd32(x: int) -> int:
    """Wavefold (sau/math.h:112-118). u32-encoded in/out."""
    s = x & M32
    if ((s + (1 << 29)) & M32) > (1 << 31):
        s = ((1 << 31) + (1 << 30) - s) & M32
    s = ((s - (1 << 29)) * 2) & M32
    return s


def mcg32(seed: int) -> int:
    return (seed * 0xe47135) & M32


def ranfast32(n: int) -> int:
    """Random access noise (sau/math.h:297-303)."""
    s = (n * FIBH32) & M32
    s ^= s >> 14
    s = ((s | 1) * s) & M32
    s ^= s >> 13
    return s


def splitmix32_next(state: list) -> int:
    """Fixed-increment SplitMix32 variant (sau/math.h:329-334).
    ``state``: 1-element list holding u32."""
    state[0] = (state[0] + FIBH32) & M32
    z = state[0]
    z = ((z ^ (z >> 16)) * 0x21f0aaad) & M32
    z = ((z ^ (z >> 15)) * 0xf35a2d97) & M32
    return z ^ (z >> 15)


def splitmix64_next(state: list) -> int:
    """SplitMix64 (sau/math.h:341-346). ``state``: 1-element u64 list."""
    state[0] = (state[0] + FIBH64) & M64
    z = state[0]
    z = ((z ^ (z >> 30)) * 0xbf58476d1ce4e5b9) & M64
    z = ((z ^ (z >> 27)) * 0x94d049bb133111eb) & M64
    return z ^ (z >> 31)


def i32_of_u32(x: int) -> int:
    return x - U32 if x & 0x80000000 else x


# -- script math functions (sau/math.h:150-213, sau/math.c) ------------------

def sau_arbf(x: float) -> float:
    return math.remainder(x, 1.0) * -2


def sau_arhf(x: float) -> float:
    x = math.remainder(x, 1.0)
    x += 1.0 if x <= 0.0 else -1.0
    return x * 2


def sau_met(x: float) -> float:
    return 0.5 * (x + math.sqrt(x * x + 4.0))


def sau_sgn(x: float) -> float:
    return math.copysign(0.0 if x == 0.0 else 1.0, x)


class MathState:
    """Stateful math function state (sau/math.h:239-243)."""

    def __init__(self):
        self.seed64 = 0
        self.seed32 = 0
        self.no_time = False

    def rand(self) -> float:
        st = [self.seed64]
        v = splitmix64_next(st)
        self.seed64 = st[0]
        return d01_from_ui64(v)

    def rand32(self) -> int:
        st = [self.seed32]
        v = splitmix32_next(st)
        self.seed32 = st[0]
        return v

    def seed(self, x: float) -> float:
        """Magic variable $seed (sau/math.c:35-41)."""
        ui64 = np.float64(x).view(np.uint64)
        self.seed64 = int(ui64)
        self.seed32 = ((self.seed64 >> 32) + self.seed64) & M32
        return 0.0

    def time(self) -> float:
        if self.no_time:
            return 0.0
        import time as _t
        return float(int(_t.time()) & ((1 << 53) - 1))


# parameter type tags (sau/math.h:246-251)
MATH_VAL_F = 0
MATH_STATE_F = 1
MATH_STATEVAL_F = 2
MATH_NOARG_F = 3

# name, param type, function (sau/math.h:197-213)
MATH_FUNCS = [
    ('abs', MATH_VAL_F, math.fabs),
    ('arbf', MATH_VAL_F, sau_arbf),
    ('arhf', MATH_VAL_F, sau_arhf),
    ('cos', MATH_VAL_F, math.cos),
    ('exp', MATH_VAL_F, math.exp),
    ('log', MATH_VAL_F, lambda x: math.log(x) if x > 0 else
        (-math.inf if x == 0 else math.nan)),
    ('met', MATH_VAL_F, sau_met),
    ('mf', MATH_NOARG_F, lambda: HUMMID),
    ('pi', MATH_NOARG_F, lambda: PI),
    ('rand', MATH_STATE_F, MathState.rand),
    ('rint', MATH_VAL_F, rint_even),
    ('sgn', MATH_VAL_F, sau_sgn),
    ('sin', MATH_VAL_F, math.sin),
    ('sqrt', MATH_VAL_F, lambda x: math.sqrt(x) if x >= 0 else math.nan),
    ('time', MATH_STATE_F, MathState.time),
]
MATH_NAMES = [f[0] for f in MATH_FUNCS]
MATH_PARAMS = [f[1] for f in MATH_FUNCS]
MATH_SYMBOLS = [f[2] for f in MATH_FUNCS]

MATH_VARS_NAMES = ['seed']
MATH_VARS_SYMBOLS = [MathState.seed]


# -- NumPy vector versions (CPU renderer) ------------------------------------

def np_ranfast32(n: np.ndarray) -> np.ndarray:
    """Vector ranfast32 over uint32 array."""
    s = (n.astype(np.uint32) * np.uint32(FIBH32))
    s = s ^ (s >> np.uint32(14))
    s = (s | np.uint32(1)) * s
    s = s ^ (s >> np.uint32(13))
    return s


def np_mcg32(seed: np.ndarray) -> np.ndarray:
    return seed.astype(np.uint32) * np.uint32(0xe47135)


def np_sar32(x: np.ndarray, s) -> np.ndarray:
    """Arithmetic right shift of u32-encoded values, u32-encoded result."""
    return (x.view(np.int32) >> s).view(np.uint32) if x.dtype == np.uint32 \
        else (x.astype(np.int32) >> s).astype(np.uint32)


def np_foldhd32(x: np.ndarray) -> np.ndarray:
    """Vector wavefold on u32-encoded values (sau/math.h:112-118)."""
    s = x.astype(np.uint32)
    cond = (s + np.uint32(1 << 29)) > np.uint32(1 << 31)
    folded = np.uint32((1 << 31) + (1 << 30)) - s
    s = np.where(cond, folded, s)
    s = (s - np.uint32(1 << 29)) * np.uint32(2)
    return s


def np_sinpi_d5f(x: np.ndarray) -> np.ndarray:
    """Degree 5 sin(PI*x) approx for -0.5<=x<=0.5 (sau/math.h:366-379)."""
    x = x.astype(np.float32)
    scale0 = np.float32(+3.14042741234069229463)
    scale1 = np.float32(-5.13655757476162831091)
    scale2 = np.float32(+2.29939170159543653372)
    x2 = x * x
    return x * (scale0 + x2 * (scale1 + x2 * scale2))


def np_i64rintf(x: np.ndarray) -> np.ndarray:
    """llrintf equivalent: float32 -> int64 w/ round-half-even."""
    return np.rint(x.astype(np.float64)).astype(np.int64)
