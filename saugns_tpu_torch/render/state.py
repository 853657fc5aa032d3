"""Device state of the flat renderer, on tensors.

The tensor half of ``saugns_tpu/render/engine.py``: the packed per-op
state columns, the line state machine run vectorized over a chunk or a
block (and skipped), record application -- the device-authoritative
columns for the flat renderer, every column for the sequential engine
-- and the on-device int16 conversion. ``si`` holds u32 values as int32 bit patterns, as
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


def line_skip_vec(ls, length):
    """sauLine_skip (sau/line.c:456-473) on line state ``ls`` (tensors
    of any one shape; v0, vt float32, the rest signed integers)."""
    pos = ls['pos']
    flags = ls['flags']
    goal = (flags & LF_GOAL) != 0
    gratio = (flags & LF_GRATIO) != 0
    remaining = torch.clamp(ls['end'] - pos, min=0)
    pos_new = pos + torch.minimum(remaining, length)
    reached = pos_new >= ls['end']
    new = dict(ls)
    new['pos'] = torch.where(reached, torch.zeros_like(pos_new), pos_new)
    fl = torch.where(reached, flags & ~LF_TIME, flags)
    do_tr = reached & goal
    new['v0'] = torch.where(do_tr, ls['vt'], ls['v0'])
    fl = torch.where(do_tr & gratio, fl | LF_SRATIO, fl)
    fl = torch.where(do_tr & ~gratio, fl & ~LF_SRATIO, fl)
    new['flags'] = torch.where(do_tr, fl & ~(LF_GOAL | LF_GRATIO), fl)
    return new


# -- record application ------------------------------------------------------

def _line_val_at(types, typ, pos, end, v0, vt):
    """jdsp.line_val_at for a per-row line type ``typ``: the value at
    ``pos`` of each row's line, for the line types in ``types`` (the
    ones the state can hold; other rows give 0)."""
    i_pos = pos & tdsp.M32
    out = torch.zeros_like(v0)
    for t in types:
        out = torch.where(typ == t,
                          tdsp.line_fill(t, i_pos, end, v0, vt), out)
    return out


def _line_copy_scalar(cur, rflags, rv0, rvt, rend, rtype, present,
                      types=(0,), may_pick=True):
    """sauLine_copy (sau/line.c:287-332) on line state ``cur`` (per-row
    tensors, signed integers) from record fields; rows where
    ``present`` is false keep their state. ``types``: the line types
    the state can hold (see _line_val_at); ``may_pick``: False when
    the caller knows that no row sets a goal without a state, so no
    current value is picked."""
    src_state = (rflags & LF_STATE) != 0
    src_goal = (rflags & LF_GOAL) != 0
    src_type = (rflags & LF_TYPE) != 0
    src_time = (rflags & LF_TIME) != 0
    src_tifnew = (rflags & LF_TIFNEW) != 0
    cur_goal = (cur['flags'] & LF_GOAL) != 0
    cur_gratio = (cur['flags'] & LF_GRATIO) != 0
    cur_sratio = (cur['flags'] & LF_SRATIO) != 0
    zero = torch.zeros_like(rflags)

    mask = torch.where(src_state, zero + (LF_STATE | LF_SRATIO), zero)
    # "pick current point" when an unfinished goal is replaced (a get
    # of 1 sample with no multiplier; its ratio flag flips included)
    within = cur['pos'] < cur['end']
    pick = ~src_state & cur_goal & src_goal
    v0 = cur['v0']
    if may_pick:
        at_val = _line_val_at(types, cur['type'], cur['pos'], cur['end'],
                              cur['v0'], cur['vt'])
        v0 = torch.where(pick & within, at_val, v0)
    v0 = torch.where(src_state, rv0, v0)
    fl = cur['flags']
    fl = torch.where(pick & cur_gratio & ~cur_sratio, fl | LF_SRATIO, fl)
    fl = torch.where(pick & ~cur_gratio & cur_sratio, fl & ~LF_SRATIO, fl)

    vt = torch.where(src_goal, rvt, cur['vt'])
    end = torch.where(src_goal & src_tifnew, cur['end'] - cur['pos'],
                      cur['end'])
    pos = torch.where(src_goal, torch.zeros_like(cur['pos']), cur['pos'])
    mask = mask | torch.where(src_goal, zero + (LF_GOAL | LF_GRATIO), zero)
    typ = torch.where(src_type, rtype, cur['type'])
    mask = mask | torch.where(src_type, zero + LF_TYPE, zero)
    cur_time = (fl & LF_TIME) != 0
    time_override = (~cur_time | ~src_tifnew) & src_time
    end = torch.where(time_override, rend, end)
    mask = mask | torch.where(time_override, zero + LF_TIME, zero)
    fl = (fl & ~mask) | (rflags & mask)
    out = dict(cur)
    for k, v in (('v0', v0), ('vt', vt), ('pos', pos), ('end', end),
                 ('type', typ), ('flags', fl)):
        out[k] = torch.where(present, v, cur[k])
    return out


def _line_types(recs, slot):
    """Line types that slot ``slot`` of the state can hold: 0 (the
    prepared state) and every type a record of the plan sets."""
    has = (np.asarray(recs['l%d_flags' % slot]) & LF_TYPE) != 0
    return sorted({0} | {int(t) for t in
                         np.asarray(recs['l%d_type' % slot])[has]})

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


# record columns of a round, as one int64 (n_cols, n) and one float32
# table: the device-authoritative columns, and with the line slots,
# time and voice records the columns of the full application
REC_ICOLS = ('op', 'prepare', 'params', 'type', 'seed', 'wadj_delta',
             'phase_w', 'r2x_old', 'r2x_new', 'phase')
REC_ICOLS_FULL = REC_ICOLS + tuple(
    'l%d_%s' % (slot, k) for slot in range(6)
    for k in ('present', 'flags', 'end', 'type')) \
    + ('time_v', 'time_implicit')
REC_FCOLS_FULL = tuple('l%d_%s' % (slot, k) for slot in range(6)
                       for k in ('v0', 'vt'))


def prepare_records(lo, hi, recs, device_cols_only=False):
    """The host half of ``apply_records``: everything it decides from
    the plan's host arrays ``recs`` for the range [lo, hi), done once.
    Returns (struct, tables): ``struct`` the static structure the
    device half branches on (None when no record applies), ``tables``
    the host arrays it reads (name -> numpy array), for
    ``apply_prepared``."""
    kind = np.asarray(recs['kind'][lo:hi])
    sel = lo + np.nonzero(kind == 0)[0]
    vsel = lo + np.nonzero(kind == 1)[0] if not device_cols_only \
        else sel[:0]
    if not len(sel) and not len(vsel):
        return None, {}
    full = not device_cols_only
    icols = REC_ICOLS_FULL if full else REC_ICOLS
    slots = range(6) if full else ()
    tabs = {}
    rounds = []
    ris_all = []
    for r, rnd in enumerate(_rounds([int(recs['op'][ri]) for ri in sel])):
        ris = sel[rnd]
        tabs['r%d_i' % r] = np.stack([np.asarray(recs[k][ris])
                                      .astype(np.int64) for k in icols])
        if full:
            tabs['r%d_f' % r] = np.stack(
                [np.asarray(recs[k][ris]).astype(np.float32)
                 for k in REC_FCOLS_FULL])
        may_pick = []
        for slot in slots:
            rf = 'l%d_' % slot
            hf = np.asarray(recs[rf + 'flags'][ris])
            may_pick.append(bool(np.any(
                np.asarray(recs[rf + 'present'][ris])
                & ((hf & LF_GOAL) != 0) & ((hf & LF_STATE) == 0))))
        rounds.append((len(ris), tuple(may_pick)))
        ris_all.append(ris)
    voice = None
    if len(vsel):
        voice = _prepare_voice_durations(lo, vsel, recs, ris_all, tabs)
    types = tuple(tuple(_line_types(recs, slot)) for slot in slots)
    return (full, tuple(rounds), types, voice), tabs


def apply_prepared(st, struct, tabs):
    """The device half of ``apply_records`` (``struct``, ``tables`` from
    ``prepare_records``, the tables as tensors on the state's device):
    tensor operations only, no host value read and no upload, so a
    graph can capture it."""
    if struct is None:
        return st
    full, rounds, types, voice = struct
    M32 = tdsp.M32
    icol = {k: i for i, k in enumerate(REC_ICOLS_FULL if full
                                       else REC_ICOLS)}
    fcol = {k: i for i, k in enumerate(REC_FCOLS_FULL)}
    st = dict(st)
    sf = st['sf'].clone()
    si = st['si'].clone()
    si0 = st['si']
    dev = sf.device
    slots = range(6) if full else ()
    post_rows = []      # the (n, 2) time columns after each round
    for r, (_n, may_picks) in enumerate(rounds):
        ti = tabs['r%d_i' % r]
        tf = tabs.get('r%d_f' % r)

        def g(key, dtype=I64):
            if dtype == F32:
                return tf[fcol[key]]
            x = ti[icol[key]]
            return x if dtype == I64 else x.to(dtype)

        ops = g('op')
        fr = sf[ops]
        ir = si[ops].to(I64) & M32
        prep = g('prepare', torch.bool)[:, None]
        fr = torch.where(prep, torch.zeros_like(fr), fr)
        # fill_ takes the values as kernel arguments: an item assignment
        # would copy a host scalar, which a graph cannot capture
        prep_i = torch.zeros((NI,), dtype=I64, device=dev)
        prep_i[C_PHASE].fill_(SIN_ADJ)
        prep_i[C_WRESET].fill_(1)
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

        # line copies: freq/freq2/pm_a gated osc-type; amp/amp2/pan
        is_osc = is_wave | is_rasg
        for slot in slots:
            gate_l = g('l%d_present' % slot, torch.bool)
            if slot in (3, 4, 5):   # L_FREQ, L_FREQ2, L_PMA
                gate_l = gate_l & is_osc
            cur = {'v0': fr[:, C_LV0 + slot], 'vt': fr[:, C_LVT + slot],
                   'pos': tdsp.asi32(ir[:, C_LPOS + slot]),
                   'end': tdsp.asi32(ir[:, C_LEND + slot]),
                   'type': tdsp.asi32(ir[:, C_LTYPE + slot]),
                   'flags': tdsp.asi32(ir[:, C_LFLAGS + slot])}
            rf = 'l%d_' % slot
            newl = _line_copy_scalar(
                cur, g(rf + 'flags'), g(rf + 'v0', F32), g(rf + 'vt', F32),
                g(rf + 'end'), g(rf + 'type'), gate_l, types[slot],
                may_picks[slot])
            fr[:, C_LV0 + slot] = newl['v0']
            fr[:, C_LVT + slot] = newl['vt']
            for col, k in ((C_LPOS, 'pos'), (C_LEND, 'end'),
                           (C_LTYPE, 'type'), (C_LFLAGS, 'flags')):
                ir[:, col + slot] = newl[k] & M32
        if full:
            has_time = (params & P.POPP_TIME) != 0
            ir[:, C_TIME] = torch.where(has_time, g('time_v') & M32,
                                        ir[:, C_TIME])
            ir[:, C_TINF] = torch.where(has_time, g('time_implicit'),
                                        ir[:, C_TINF])
            post_rows.append(ir[:, C_TIME:C_TINF + 1])

        sf[ops] = fr
        si[ops] = i32(ir)
    st['sf'] = sf
    st['si'] = si
    if voice is not None:
        st['vdur'] = _voice_durations(st['vdur'], si0, tabs, post_rows)
    return st


def apply_records(st, lo, hi, recs, device_cols_only=False):
    """Apply update records [lo, hi) (handle_event + update_op,
    sau/generator.c:245-377) to the packed state, as the JAX engine's
    ``apply_records``. ``device_cols_only``: only the
    device-authoritative columns (the prepare row, wave phase and
    reset, RasG cycle/phase, the noise counters); the flat renderer
    writes every host-authoritative column (line slots, time, vdur)
    from the host simulation's end tables. Otherwise the line slots
    (sauLine_copy), the time and the voice durations too, as the
    sequential engine needs them.

    Op records for distinct ops commute, so they apply in rounds of
    distinct ops, vectorized. A voice record sets its voice's duration
    from its carrier's time as the records before it left it: the last
    earlier op record of the carrier in the range, else the state at
    entry. ``recs`` are the plan's host arrays. This uploads the
    range's tables on every call; the renderers prepare them once
    (``prepare_records``) and apply them with ``apply_prepared``."""
    struct, tabs = prepare_records(lo, hi, recs, device_cols_only)
    dev = st['sf'].device
    return apply_prepared(st, struct, {k: torch.from_numpy(v).to(dev)
                                       for k, v in tabs.items()})


def _prepare_voice_durations(lo, vsel, recs, ris_all, tabs):
    """Host half of set_voice_duration for the voice records ``vsel``
    (of the range from ``lo``; ``ris_all``: the op records of each
    round): which record's time columns each voice record reads, into
    ``tabs``. Returns the static structure (voice records, kept)."""
    last = {}           # op -> its last op record so far
    src = []            # per voice record: that record, or -1
    ops = recs['op']
    kinds = recs['kind']
    k = 0
    for ri in range(lo, int(vsel[-1]) + 1):
        if int(kinds[ri]) == 0:
            last[int(ops[ri])] = ri
        elif k < len(vsel) and ri == int(vsel[k]):
            src.append(last.get(int(recs['carr'][ri]), -1))
            k += 1
    tabs['v_carr'] = np.asarray(recs['carr'])[vsel].astype(np.int64)
    pos = {int(r): i for i, r in enumerate(
        np.concatenate(ris_all) if ris_all else ())}
    at = np.asarray([pos.get(r, -1) for r in src], np.int64)
    tabs['v_have'] = at >= 0
    tabs['v_at'] = np.maximum(at, 0)
    # a later record of the same voice wins
    vo = np.asarray(recs['vo'])[vsel].astype(np.int64)
    keep = np.asarray([i for i in range(len(vo))
                       if vo[i] not in vo[i + 1:]], np.int64)
    tabs['v_vo'] = vo[keep]
    tabs['v_keep'] = keep
    return len(vsel), len(keep)


def _voice_durations(vdur, si0, tabs, post_rows):
    """set_voice_duration of the prepared voice records: duration = the
    carrier's time, 0 where its time is implicit, read as the records
    before each voice record left it (``post_rows``: the time columns
    after each round of op records; ``si0``: the state at entry)."""
    cols = si0[tabs['v_carr']][:, C_TIME:C_TINF + 1].to(I64)
    if post_rows:
        vals = torch.cat(post_rows)
        got = tdsp.asi32(vals[tabs['v_at']])
        cols = torch.where(tabs['v_have'][:, None], got, cols)
    dur = torch.where(cols[:, 1] != 0, torch.zeros_like(cols[:, 0]),
                      cols[:, 0]).to(torch.int32)
    vdur = vdur.clone()
    vdur[tabs['v_vo']] = dur[tabs['v_keep']]
    return vdur


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
