"""Device state of the flat renderer, on tensors.

The tensor half of ``saugns_tpu/render/engine.py``: the packed per-op
state columns, the line state machine run vectorized over a chunk, the
device-authoritative part of record application, and the on-device
int16 conversion. ``si`` holds u32 values as int32 bit patterns, as
the JAX engine does; arithmetic on them goes through int64 (see
``tdsp``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..dsp import wavetables as W
from ..lang import program as P
from . import tdsp
from .plan import RenderPlan

I64 = torch.int64
F32 = torch.float32

# line flags
LF_STATE = P.LINEP_STATE
LF_SRATIO = P.LINEP_STATE_RATIO
LF_GOAL = P.LINEP_GOAL
LF_GRATIO = P.LINEP_GOAL_RATIO
LF_TYPE = P.LINEP_TYPE
LF_TIME = P.LINEP_TIME
LF_TIFNEW = P.LINEP_TIME_IF_NEW

SIN_ADJ = int(W.PICOEFFS[W.N_sin][2] & 0xffffffff)

# Packed per-op state. SF (n_ops, NF) float32 columns:
C_LV0 = 0      # ..5   line v0 per slot
C_LVT = 6      # ..11  line vt per slot
C_WPS = 12     # wosc prev_s
C_WFB = 13     # wosc feedback
C_RPS = 14     # rasg prev_s
C_RFB = 15     # rasg feedback
NF = 16
# SI (n_ops, NI) int32 columns (u32 values bitcast):
C_LPOS = 0     # ..5
C_LEND = 6     # ..11
C_LTYPE = 12   # ..17
C_LFLAGS = 18  # ..23
C_TIME = 24
C_TINF = 25
C_PHASE = 26   # u32 wosc phase
C_WRESET = 27
C_WPPH = 28    # u32 wosc prev phase
C_RCPLO = 29   # u32 rasg cycle_phase low word
C_RCPHI = 30   # u32 rasg cycle_phase high word
C_NN = 31      # u32 noise counter
C_NPREV = 32   # u32 noise prev
NI = 33


def i32(x_u32):
    """u32 (int64) -> int32 bit pattern."""
    return tdsp.asi32(x_u32).to(torch.int32)


def make_state(plan: RenderPlan, device):
    """Zeroed packed state for ``plan`` on ``device``."""
    n = plan.n_ops
    return {'sf': torch.zeros((n, NF), dtype=F32, device=device),
            'si': torch.zeros((n, NI), dtype=torch.int32, device=device),
            'vdur': torch.zeros((plan.n_voices,), dtype=torch.int32,
                                device=device)}


# -- line state machine ------------------------------------------------------

def line_run_vec(ls, B, length, mulbuf, static_type: int, idx):
    """sauLine_run vectorized: ``ls`` holds (n, 1) state tensors
    (v0, vt f32; pos, end, flags integer), ``idx`` is (1, B), ``length``
    (n, 1) and ``mulbuf`` an (n, B) multiplier or None. Runs n
    independent lines at once; returns (out (n, B), new_ls)."""
    v0 = ls['v0']
    vt = ls['vt']
    pos = ls['pos']
    end = ls['end']
    flags = ls['flags']
    goal = (flags & LF_GOAL) != 0
    gratio = (flags & LF_GRATIO) != 0
    sratio = (flags & LF_SRATIO) != 0
    has_mul = mulbuf is not None
    if has_mul:
        m0 = mulbuf[..., 0:1]
        v0 = torch.where(goal & gratio & ~sratio, v0 / m0, v0)
        v0 = torch.where(goal & ~gratio & sratio, v0 * m0, v0)
    sratio_g = torch.where(goal, gratio, sratio)
    remaining = torch.clamp(end - pos, min=0)
    lg = torch.where(goal, torch.minimum(remaining, length),
                     torch.zeros_like(remaining))
    fillv = tdsp.line_fill(static_type, (pos + idx).to(I64) & tdsp.M32,
                           end, v0, vt)
    if has_mul:
        fillv = torch.where(gratio, fillv * mulbuf, fillv)
    adv = torch.where(goal, lg, torch.minimum(remaining, length))
    pos_new = pos + adv
    reached = pos_new >= end
    v0_after = torch.where(goal & reached, vt, v0)
    sahv = torch.ones_like(fillv) * v0_after
    if has_mul:
        sahv = torch.where(sratio_g, sahv * mulbuf, sahv)
    out = torch.where(idx < lg, fillv, sahv)
    clear_goal = goal & reached
    flags_new = torch.where(
        goal, (flags & ~LF_SRATIO) | torch.where(
            gratio, LF_SRATIO, 0), flags)
    flags_new = torch.where(clear_goal,
                            flags_new & ~(LF_GOAL | LF_GRATIO | LF_TIME),
                            flags_new)
    flags_new = torch.where(~goal & reached, flags_new & ~LF_TIME,
                            flags_new)
    new = dict(ls)
    new['v0'] = v0_after
    new['pos'] = torch.where(reached, torch.zeros_like(pos_new), pos_new)
    new['flags'] = flags_new
    return out, new


# -- record application ------------------------------------------------------

def _rounds(ops):
    """Split record positions into rounds in which each op appears at
    most once, keeping each op's records in order."""
    seen = {}
    rounds = []
    for k, op in enumerate(ops):
        r = seen.get(op, 0)
        seen[op] = r + 1
        if r == len(rounds):
            rounds.append([])
        rounds[r].append(k)
    return rounds


def _shl1(x):
    """u32 x << 1 as (carry bit, low word)."""
    return x >> 31, (x << 1) & tdsp.M32


def apply_records(st, lo, hi, recs):
    """Apply update records [lo, hi) (handle_event + update_op,
    sau/generator.c:245-377) to the device-authoritative columns of
    the packed state: the prepare row, wave phase and reset, RasG
    cycle/phase and the noise counters -- the JAX engine's
    ``apply_records(..., device_cols_only=True)``. The flat renderer
    writes every host-authoritative column (line slots, time, vdur)
    from the host simulation's end tables. Records for distinct ops
    commute, so they apply in rounds of distinct ops, vectorized;
    ``recs`` are the plan's host arrays."""
    M32 = tdsp.M32
    sel = [ri for ri in range(lo, hi) if int(recs['kind'][ri]) == 0]
    if not sel:
        return st
    sel = np.asarray(sel)
    st = dict(st)
    sf = st['sf'].clone()
    si = st['si'].clone()
    dev = sf.device
    for rnd in _rounds([int(recs['op'][ri]) for ri in sel]):
        ris = sel[rnd]

        def g(key, dtype=I64):
            return torch.from_numpy(
                np.asarray(recs[key][ris]).astype(np.int64)).to(
                dev).to(dtype)

        ops = g('op')
        fr = sf[ops]
        ir = si[ops].to(I64) & M32
        prep = g('prepare', torch.bool)[:, None]
        fr = torch.where(prep, torch.zeros_like(fr), fr)
        prep_i = torch.zeros((NI,), dtype=I64, device=dev)
        prep_i[C_PHASE] = SIN_ADJ
        prep_i[C_WRESET] = 1
        ir = torch.where(prep, prep_i[None, :], ir)

        params = g('params')
        typ = g('type')
        has_mode = (params & P.POPP_MODE) != 0
        has_phase = (params & P.POPP_PHASE) != 0
        has_seed = (params & P.POPP_SEED) != 0
        is_noise = typ == P.POPT_NOISE
        is_wave = typ == P.POPT_WAVE
        is_rasg = typ == P.POPT_RASEG
        zero = torch.zeros_like(params)
        seed = g('seed')

        # noise
        ir[:, C_NPREV] = torch.where(has_mode & is_noise, zero,
                                     ir[:, C_NPREV])
        ir[:, C_NN] = torch.where(has_seed & is_noise, seed, ir[:, C_NN])

        # wave: set_wave/set_phase with plan-precomputed adjustments
        ph = ir[:, C_PHASE]
        ph = torch.where(has_mode & is_wave,
                         (ph + g('wadj_delta')) & M32, ph)
        ir[:, C_WRESET] = torch.where(has_mode & is_wave, zero + 1,
                                      ir[:, C_WRESET])
        ph = torch.where(has_phase & is_wave, g('phase_w'), ph)
        ir[:, C_PHASE] = ph

        # rasg cycle/phase state (rasg.h:59-119) as (hi, lo) u32 words
        # of the 64-bit cycle_phase
        cl = ir[:, C_RCPLO]
        ch = ir[:, C_RCPHI]
        r2x_old = g('r2x_old', torch.bool)
        r2x_new = g('r2x_new', torch.bool)

        def phase_of(ch, cl, r2x):
            # (cp >> 1) or cp, truncated to u32
            return torch.where(r2x, ((ch & 1) << 31) | (cl >> 1), cl)

        def with_phase(cyc, phs):
            # (cyc << 32) | (phs << 1 if rate2x else phs)
            c1, l1 = _shl1(phs)
            return (cyc | torch.where(r2x_new, c1, zero),
                    torch.where(r2x_new, l1, phs))

        cyc = ch & 0xfffffffe
        rh, rl = with_phase(cyc, phase_of(ch, cl, r2x_old))
        chg = has_mode & is_rasg & (r2x_new != r2x_old)
        ch = torch.where(chg, rh, ch)
        cl = torch.where(chg, rl, cl)
        # set_phase
        rh, rl = with_phase(ch & 0xfffffffe, g('phase'))
        chg = has_phase & is_rasg
        ch = torch.where(chg, rh, ch)
        cl = torch.where(chg, rl, cl)
        # set_cycle
        rh, rl = with_phase(seed & 0xfffffffe,
                            phase_of(ch, cl, r2x_new))
        chg = has_seed & is_rasg
        ch = torch.where(chg, rh, ch)
        cl = torch.where(chg, rl, cl)
        ir[:, C_RCPLO] = cl
        ir[:, C_RCPHI] = ch

        sf[ops] = fr
        si[ops] = i32(ir)
    st['sf'] = sf
    st['si'] = si
    return st


# -- int16 conversion ----------------------------------------------------------

def _to_i16_device(outs):
    """Clamp and round to int16 on the device (mix_write,
    generator.c:795-825)."""
    x = torch.clamp(outs, -1.0, 1.0)
    return torch.round(x * 32767.0).to(torch.int16)


def _to_i16_mono_device(outs):
    """Mono downmix of the float stereo mix on the device
    (mix_write_mono, generator.c:795-805)."""
    m = (outs[..., 0] + outs[..., 1]) * 0.5
    m = torch.clamp(m, -1.0, 1.0)
    return torch.round(m * 32767.0).to(torch.int16)
