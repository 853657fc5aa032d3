"""Host-side render planner for the TPU engine.

Compiles a Program (flat event IR) into a static execution plan:

- **Update records**: dense per-(event, op) parameter-update rows
  applied on device at block starts (mirrors update_op,
  sau/generator.c:283-343).
- **Epochs**: maximal event ranges over which every voice's operator
  traversal (the recursive run_block structure, sau/generator.c:675-729)
  is unchanged, so one ``lax.scan`` with a fixed stage schedule covers
  the whole range; only parameters change, as data.
- **Stage schedules**: the unrolled post-order traversal with buffer
  indices identical to the reference's buffer-pool pointer arithmetic.
- **Block tables**: event-aligned sample blocks (length <= B) so
  parameter updates land at exact sample offsets.

Everything here is plain NumPy/Python; no JAX.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..dsp import prim
from ..lang import program as P

BLOCK = 1024       # default/minimum block length
BLOCK_CAP = 1 << 16  # upper bound on per-epoch block length

def _round_block(n):
    """Round a block length up to a TPU-friendly multiple of 1024,
    clamped to [BLOCK, BLOCK_CAP]. Semantics are split-independent
    given event alignment, so longer blocks only amortize fixed
    per-scan-step cost."""
    n = max(n, BLOCK)
    n = min(n, BLOCK_CAP)
    return -(-n // 1024) * 1024

# stage kinds
K_LINE = 0        # run line state into dst (optionally * mulbuf)
K_RANGEMOD = 1    # par += (r_par - par) * mod
K_CONST1 = 2      # fill dst with 1.0 (AmpNode signal)
K_NOISE = 3       # noise generator into dst
K_WPHASE = 4      # wosc phasor fill into dst (u32 view)
K_WRUN = 5        # wosc run: dst <- osc(phase)
K_WRUN_SELF = 6   # wosc selfmod run
K_RCYCLE = 7      # rasg cyclor fill: dst_cycle (u32), dst_phase (f32)
K_RRUN = 8        # rasg run: dst <- map(phase, cycle)
K_RRUN_SELF = 9   # rasg selfmod run
K_MIX = 10        # block_mix into dst from src with amp
K_ZERO = 11       # zero-fill dst (circular-reference guard)
K_VMIX = 12       # voice mix: pan + accumulate into stereo mix

KIND_NAMES = ['LINE', 'RANGEMOD', 'CONST1', 'NOISE', 'WPHASE', 'WRUN',
              'WRUN_SELF', 'RCYCLE', 'RRUN', 'RRUN_SELF', 'MIX', 'ZERO',
              'VMIX']

# line slots (index into per-op line state arrays)
L_PAN, L_AMP, L_AMP2, L_FREQ, L_FREQ2, L_PMA = range(6)


@dataclass
class Stage:
    kind: int
    inst: int = -1         # instance index (for length chain); -1: none
    op: int = -1           # operator id (dynamic at exec; stored here)
    dst: int = -1          # buffer index
    a: int = -1            # aux buffer (mulbuf / phase / src / cycle)
    b: int = -1            # aux buffer 2 (pm / selfmod)
    c: int = -1            # aux buffer 3 (fpm)
    line: int = -1         # line slot for K_LINE
    wave_env: bool = False
    layer: bool = False
    skip_line: Tuple[int, ...] = ()  # line slots to skip-advance
    voice: int = -1
    freq_buf_id: int = 0   # for K_VMIX
    # plan-baked mode state (epoch-static; see OpModel)
    wave: int = 0          # K_WPHASE/K_WRUN*
    ntype: int = 0         # K_NOISE
    ltype: int = 1         # K_LINE fill shape
    ras: tuple = (1, 0, 27, 0x9e3779b9, 0, True)  # K_RCYCLE/K_RRUN*


@dataclass
class Instance:
    op: int
    parent: int            # parent instance index, or -1 (voice level)
    voice: int


@dataclass
class Epoch:
    """One scan-able span: [start_sample, end_sample) with fixed
    schedule; events ev_lo..ev_hi apply inside it."""
    start: int
    end: int
    ev_lo: int
    ev_hi: int
    stages: List[Stage] = field(default_factory=list)
    instances: List[Instance] = field(default_factory=list)
    n_voices_active: int = 0
    sig: tuple = ()
    # (sample_time, stage_op_list, inst_op_list) changes within epoch
    op_changes: list = field(default_factory=list)
    # block table (filled by _build_block_tables)
    blk_len: np.ndarray = None
    blk_rec_lo: np.ndarray = None
    blk_rec_hi: np.ndarray = None
    blk_stage_op: np.ndarray = None
    blk_inst_op: np.ndarray = None
    block: int = BLOCK


class OpModel:
    """Host-tracked per-op graph/mode state. All mode-ish state (wave,
    noise color, ras options, line shapes) evolves deterministically
    with events, so the planner bakes it into the stage schedule as
    compile-time constants -- dynamic per-op table/branch selection is
    expensive on TPU."""

    __slots__ = ('type', 'mods', 'maybe_selfmod', 'prepared', 'wave',
                 'ntype', 'ras_line', 'ras_func', 'ras_level',
                 'ras_alpha', 'ras_flags', 'ras_rate2x', 'ltype')

    def __init__(self):
        self.type = 0
        self.mods = [()] * 8  # use types 1..8 -> index 0..7
        self.maybe_selfmod = False
        self.prepared = False
        self.wave = 0
        self.ntype = 0
        self.ras_line = 1
        self.ras_func = 0
        self.ras_level = P.ras_level(9)
        self.ras_alpha = 0x9e3779b9
        self.ras_flags = 0
        self.ras_rate2x = True
        self.ltype = [1] * 6  # line slots default SAU_LINE_N_lin

    def apply_mode(self, od):
        """Replicate update_op's mode effects (generator.c:283-343) and
        line-type copies; returns True if any baked value changed."""
        ch = False
        params = od.params
        t = od.type
        if params & P.POPP_MODE:
            if t == P.POPT_NOISE and self.ntype != od.mode_main:
                self.ntype = od.mode_main
                ch = True
            elif t == P.POPT_WAVE and self.wave != od.mode_main:
                self.wave = od.mode_main
                ch = True
            elif t == P.POPT_RASEG:
                ras = od.mode_ras
                fl = ras.flags
                if fl & P.RAS_O_LINE_SET and self.ras_line != ras.line:
                    self.ras_line = ras.line
                    ch = True
                if fl & P.RAS_O_FUNC_SET:
                    if self.ras_func != ras.func:
                        self.ras_func = ras.func
                        ch = True
                    fl_eff = fl
                else:
                    fl_eff = fl | self.ras_flags
                if fl & P.RAS_O_LEVEL_SET and self.ras_level != ras.level:
                    self.ras_level = ras.level
                    ch = True
                if fl & P.RAS_O_ASUBVAL_SET and \
                        self.ras_alpha != ras.alpha:
                    self.ras_alpha = ras.alpha
                    ch = True
                if self.ras_flags != fl_eff:
                    self.ras_flags = fl_eff
                    ch = True
                r2x = not (fl_eff & P.RAS_O_HALFSHAPE)
                if r2x != self.ras_rate2x:
                    self.ras_rate2x = r2x
                    ch = True
        # line-shape types (sauLine_copy TYPE flag)
        for sl, line in ((0, od.pan), (1, od.amp), (2, od.amp2),
                         (3, od.freq), (4, od.freq2), (5, od.pm_a)):
            if line is not None and (line.flags & P.LINEP_TYPE) and \
                    self.ltype[sl] != line.type:
                self.ltype[sl] = line.type
                ch = True
        return ch


def ms2spl(ms, srate):
    return prim.ms_in_samples(ms, srate)


class RenderPlan:
    """Full plan for (program, srate)."""

    def __init__(self, prg: P.Program, srate: int, block: int = BLOCK):
        self.prg = prg
        self.srate = srate
        self.block = block
        self.n_ops = max(prg.op_count, 1)
        self.n_voices = max(prg.vo_count, 1)
        self.n_bufs = (1 + prg.op_nest_depth) * 7
        amp_scale = np.float32(0.5) * np.float32(prg.ampmult)
        if prg.mode & P.PMODE_AMP_DIV_VOICES:
            amp_scale = np.float32(amp_scale
                                   / np.int32(max(prg.vo_count, 1)))
        self.amp_scale = float(amp_scale)
        self._build()

    # ------------------------------------------------------------------

    def _build(self):
        prg = self.prg
        srate = self.srate
        carry = [0]
        ev_abs = []  # absolute sample time per event
        t = 0
        for e in prg.events:
            t += prim.ms_in_samples(e.wait_ms, srate, carry)
            ev_abs.append(t)
        self.ev_abs = ev_abs

        # --- update records -------------------------------------------
        self._build_records()

        # --- host graph/time simulation for epochs & signal end -------
        ops = [OpModel() for _ in range(self.n_ops)]
        vo_carr = [0] * self.n_voices
        vo_has_carr = [False] * self.n_voices
        op_time = [0] * self.n_ops       # samples, decremented
        op_time_inf = [False] * self.n_ops
        op_last_t = [0] * self.n_ops     # abs sample of last sync
        vo_end = [0] * self.n_voices
        signal_end = 0

        epochs: List[Epoch] = []
        cur: Optional[Epoch] = None
        cur_sig = None
        # graph changes are scheduled LAZILY, once per distinct event
        # time: a chord (or generated voice bank) delivers hundreds of
        # graph-changing events at one sample time, and scheduling
        # each intermediate state is O(events x voices) for epochs
        # that would all be zero-length anyway (a 1024-voice bank
        # spent ~130 s host time here). The flushed schedule reflects
        # the state after ALL events at that time -- identical to the
        # last of the intermediate schedules; the dropped zero-length
        # epochs' records land in the surviving epoch's first block
        # (record order is event order either way).
        pending = None   # (time, ev_index) of first unflushed change

        def flush_schedule():
            nonlocal cur, cur_sig, pending
            if pending is None:
                return
            p_now, p_ei = pending
            pending = None
            stages, insts, sig = self._schedule(ops, vo_carr,
                                                vo_has_carr)
            if cur is None or sig != cur_sig:
                if cur is not None:
                    cur.end = p_now
                    cur.ev_hi = p_ei
                    epochs.append(cur)
                ncur = Epoch(start=p_now, end=0, ev_lo=p_ei, ev_hi=0)
                ncur.stages = stages
                ncur.instances = insts
                ncur.sig = sig
                ncur.op_changes = [(p_now, [st.op for st in stages],
                                    [i.op for i in insts])]
                cur = ncur
                cur_sig = sig
            else:
                cur.op_changes.append((p_now,
                                       [st.op for st in stages],
                                       [i.op for i in insts]))

        def op_time_now(oid, now):
            if op_time_inf[oid]:
                return 0
            elapsed = now - op_last_t[oid]
            return max(op_time[oid] - elapsed, 0)

        for ei, e in enumerate(prg.events):
            now = ev_abs[ei]
            if pending is not None and now > pending[0]:
                flush_schedule()
            graph_changed = False
            for od in e.op_data:
                om = ops[od.id]
                if not om.prepared:
                    om.prepared = True
                    om.type = od.type
                    graph_changed = True
                if om.apply_mode(od):
                    graph_changed = True
                for mi, fname in enumerate(P.OpData.MOD_FIELDS):
                    v = getattr(od, fname)
                    if v is not None and tuple(v) != om.mods[mi]:
                        om.mods[mi] = tuple(v)
                        graph_changed = True
                if od.pm_a is not None and (
                        (od.pm_a.flags & P.LINEP_STATE and od.pm_a.v0 != 0)
                        or (od.pm_a.flags & P.LINEP_GOAL)):
                    if not om.maybe_selfmod:
                        om.maybe_selfmod = True
                        graph_changed = True
                # time state sync (for voice end computation)
                if od.params & P.POPP_TIME:
                    if od.time.flags & P.TIMEP_IMPLICIT:
                        op_time[od.id] = 0
                        op_time_inf[od.id] = True
                    else:
                        op_time[od.id] = ms2spl(od.time.v_ms, srate)
                        op_time_inf[od.id] = False
                    op_last_t[od.id] = now
            if e.vo_id != P.PVO_NO_ID:
                if e.op_list is not None and len(e.op_list) > 0:
                    if not vo_has_carr[e.vo_id] or \
                            vo_carr[e.vo_id] != e.carr_op_id:
                        graph_changed = True
                    vo_has_carr[e.vo_id] = True
                if vo_carr[e.vo_id] != e.carr_op_id:
                    graph_changed = True
                    vo_carr[e.vo_id] = e.carr_op_id
                # carrier ops decrement with elapsed voice-run time
                cid = e.carr_op_id
                dur = op_time_now(cid, now)
                op_time[cid] = dur
                op_last_t[cid] = now
                vo_end[e.vo_id] = now + dur
                if now + dur > signal_end:
                    signal_end = now + dur
            if now > signal_end:
                signal_end = now

            if (cur is None or graph_changed) and pending is None:
                pending = (now, ei)
        flush_schedule()
        if cur is None:
            cur = Epoch(start=0, end=0, ev_lo=0, ev_hi=0)
            cur.stages, cur.instances, cur.sig = self._schedule(
                ops, vo_carr, vo_has_carr)
            cur.op_changes = [(0, [st.op for st in cur.stages],
                               [i.op for i in cur.instances])]
        cur.end = max(signal_end, cur.start)
        cur.ev_hi = len(prg.events)
        epochs.append(cur)
        self.epochs = epochs
        self.signal_end = signal_end
        self._build_block_tables()

    # ------------------------------------------------------------------

    def _build_records(self):
        """Flatten events into device-ready update record arrays.
        Record kinds: 0 = op update, 1 = voice update. Values that
        depend on mode state (wave phase adjustments, ras option
        merges, line shapes) are precomputed here -- mode state evolves
        deterministically with events (see OpModel)."""
        prg = self.prg
        srate = self.srate
        recs = []
        ev_rec_lo = []
        ev_rec_hi = []
        prepared = set()
        sim = [OpModel() for _ in range(self.n_ops)]
        for e in prg.events:
            ev_rec_lo.append(len(recs))
            for od in e.op_data:
                om = sim[od.id]
                r = {}
                r['kind'] = 0
                r['op'] = od.id
                fresh = od.id not in prepared
                r['prepare'] = fresh
                prepared.add(od.id)
                if fresh:
                    om.__init__()
                    om.prepared = True
                    om.type = od.type
                r['params'] = od.params
                r['type'] = od.type
                r['use_carr'] = od.use_type == P.POP_N_carr
                wave_old = om.wave
                r2x_old = om.ras_rate2x
                om.apply_mode(od)
                from ..dsp import wavetables as W
                adj = lambda w: W.PICOEFFS[w][2] & 0xffffffff
                r['wadj_delta'] = (adj(om.wave) - adj(wave_old)) \
                    & 0xffffffff
                r['phase_w'] = (od.phase + adj(om.wave)) & 0xffffffff
                r['phase'] = od.phase
                r['r2x_old'] = r2x_old
                r['r2x_new'] = om.ras_rate2x
                for sl, line in ((L_PAN, od.pan), (L_AMP, od.amp),
                                 (L_AMP2, od.amp2), (L_FREQ, od.freq),
                                 (L_FREQ2, od.freq2), (L_PMA, od.pm_a)):
                    if line is None:
                        r['l%d_present' % sl] = False
                        r['l%d_flags' % sl] = 0
                        r['l%d_v0' % sl] = 0.0
                        r['l%d_vt' % sl] = 0.0
                        r['l%d_end' % sl] = 0
                        r['l%d_type' % sl] = 0
                    else:
                        r['l%d_present' % sl] = True
                        r['l%d_flags' % sl] = line.flags
                        r['l%d_v0' % sl] = line.v0
                        r['l%d_vt' % sl] = line.vt
                        r['l%d_end' % sl] = ms2spl(line.time_ms, srate)
                        r['l%d_type' % sl] = line.type
                r['time_v'] = (0 if od.time.flags & P.TIMEP_IMPLICIT
                               else ms2spl(od.time.v_ms, srate))
                r['time_implicit'] = bool(od.time.flags
                                          & P.TIMEP_IMPLICIT)
                r['seed'] = od.seed
                r['mode_main'] = od.mode_main
                r['vo'] = 0
                r['carr'] = 0
                recs.append(r)
            if e.vo_id != P.PVO_NO_ID:
                r = self._blank_rec()
                r['kind'] = 1
                r['vo'] = e.vo_id
                r['carr'] = e.carr_op_id
                recs.append(r)
            ev_rec_hi.append(len(recs))
        self.ev_rec_lo = ev_rec_lo
        self.ev_rec_hi = ev_rec_hi
        if not recs:
            recs = [self._blank_rec()]
        keys = recs[0].keys()
        self.rec_arrays = {}
        for k in keys:
            if k.endswith(('_v0', '_vt')):
                dt = np.float32
            elif k in ('phase', 'seed', 'phase_w', 'wadj_delta'):
                dt = np.uint32
            elif k in ('prepare', 'use_carr', 'time_implicit',
                       'r2x_old', 'r2x_new') or \
                    k.endswith('_present'):
                dt = np.bool_
            else:
                dt = np.int32
            self.rec_arrays[k] = np.array([r[k] for r in recs], dtype=dt)
        self.n_recs = len(recs)

    @staticmethod
    def _blank_rec():
        r = {'kind': 0, 'op': 0, 'prepare': False, 'params': 0,
             'type': 0, 'use_carr': False, 'time_v': 0,
             'time_implicit': False, 'phase': 0, 'seed': 0,
             'mode_main': 0, 'phase_w': 0, 'wadj_delta': 0,
             'r2x_old': True, 'r2x_new': True, 'vo': 0, 'carr': 0}
        for sl in range(6):
            r['l%d_present' % sl] = False
            r['l%d_flags' % sl] = 0
            r['l%d_v0' % sl] = 0.0
            r['l%d_vt' % sl] = 0.0
            r['l%d_end' % sl] = 0
            r['l%d_type' % sl] = 0
        return r

    # ------------------------------------------------------------------

    def _schedule(self, ops, vo_carr, vo_has_carr):
        """Emit the stage list mirroring run_block recursion
        (sau/generator.c:675-729) for all voices in id order."""
        stages: List[Stage] = []
        insts: List[Instance] = []

        def emit(st):
            stages.append(st)

        def new_inst(op, parent, voice):
            insts.append(Instance(op=op, parent=parent, voice=voice))
            return len(insts) - 1

        def plan_param_rangemod(bufs, om, op, parent_inst, voice,
                                mods, r_mods, line_par, line_rpar,
                                mulbuf, freq_alias, visited):
            """run_param_with_rangemod (generator.c:448-477).
            Returns freq buffer index used by sub-mods (or -1)."""
            par_buf = bufs + 0
            if freq_alias >= 0:
                freq = freq_alias
            elif line_par == L_FREQ:
                freq = par_buf
            else:
                freq = -1
            emit(Stage(K_LINE, inst=parent_inst, op=op, dst=par_buf,
                       a=mulbuf, line=line_par, voice=voice,
                       ltype=om.ltype[line_par]))
            if len(r_mods) > 0:
                emit(Stage(K_LINE, inst=parent_inst, op=op,
                           dst=bufs + 1, a=mulbuf, line=line_rpar,
                           voice=voice, ltype=om.ltype[line_rpar]))
                for i, mid in enumerate(r_mods):
                    plan_block(bufs + 2, mid, parent_inst, voice, freq,
                               True, i != 0, visited)
                emit(Stage(K_RANGEMOD, inst=parent_inst, op=op,
                           dst=par_buf, a=bufs + 1, b=bufs + 2,
                           voice=voice))
            else:
                # r_par line skip-advance folded into the par line stage
                stages[-1].skip_line = (line_rpar,)
            for mid in mods:
                plan_block(bufs + 0, mid, parent_inst, voice, freq,
                           False, True, visited)
            return freq

        def plan_selfmod_param(bufs, om, op, inst, voice, freq, visited):
            """run_osc_selfmod_param (generator.c:479-498). Emits the
            pm_a fill + apmods; returns True if buffer gets content."""
            apmods = om.mods[P.POP_N_apmod - 1]
            use_self = om.maybe_selfmod or len(apmods) > 0
            if not use_self:
                return False
            emit(Stage(K_LINE, inst=inst, op=op, dst=bufs, a=-1,
                       line=L_PMA, voice=voice, ltype=om.ltype[L_PMA]))
            for mid in apmods:
                plan_block(bufs, mid, inst, voice, freq, False, True,
                           visited)
            return True

        def plan_block(bufs, op, parent_inst, voice, parent_freq,
                       wave_env, layer, visited):
            om = ops[op]
            if op in visited:
                emit(Stage(K_ZERO, inst=parent_inst, op=op, dst=bufs,
                           voice=voice))
                return
            visited = visited | {op}
            inst = new_inst(op, parent_inst, voice)
            t = om.type
            mix_buf = bufs
            if t == P.POPT_AMP:
                plan_param_rangemod(bufs + 1, om, op, inst, voice,
                                    om.mods[P.POP_N_amod - 1],
                                    om.mods[P.POP_N_ramod - 1],
                                    L_AMP, L_AMP2, -1, -1, visited)
                amp = bufs + 1
                emit(Stage(K_CONST1, inst=inst, op=op, dst=bufs + 2,
                           voice=voice))
                emit(Stage(K_MIX, inst=inst, op=op, dst=mix_buf,
                           a=bufs + 2, b=amp, wave_env=wave_env,
                           layer=layer, voice=voice))
            elif t == P.POPT_NOISE:
                plan_param_rangemod(bufs + 1, om, op, inst, voice,
                                    om.mods[P.POP_N_amod - 1],
                                    om.mods[P.POP_N_ramod - 1],
                                    L_AMP, L_AMP2, -1, -1, visited)
                amp = bufs + 1
                emit(Stage(K_NOISE, inst=inst, op=op, dst=bufs + 2,
                           voice=voice, ntype=om.ntype))
                emit(Stage(K_MIX, inst=inst, op=op, dst=mix_buf,
                           a=bufs + 2, b=amp, wave_env=wave_env,
                           layer=layer, voice=voice))
            elif t == P.POPT_WAVE:
                phase_buf = bufs + 1
                freq = plan_param_rangemod(bufs + 2, om, op, inst, voice,
                                           om.mods[P.POP_N_fmod - 1],
                                           om.mods[P.POP_N_rfmod - 1],
                                           L_FREQ, L_FREQ2, parent_freq,
                                           -1, visited)
                pmods = om.mods[P.POP_N_pmod - 1]
                fpmods = om.mods[P.POP_N_fpmod - 1]
                pm_buf = -1
                fpm_buf = -1
                if pmods:
                    for i, mid in enumerate(pmods):
                        plan_block(bufs + 3, mid, inst, voice, freq,
                                   False, i != 0, visited)
                    pm_buf = bufs + 3
                if fpmods:
                    for i, mid in enumerate(fpmods):
                        plan_block(bufs + 4, mid, inst, voice, freq,
                                   False, i != 0, visited)
                    fpm_buf = bufs + 4
                emit(Stage(K_WPHASE, inst=inst, op=op, dst=phase_buf,
                           a=freq, b=pm_buf, c=fpm_buf, voice=voice,
                           wave=om.wave))
                plan_param_rangemod(bufs + 3, om, op, inst, voice,
                                    om.mods[P.POP_N_amod - 1],
                                    om.mods[P.POP_N_ramod - 1],
                                    L_AMP, L_AMP2, -1, freq, visited)
                amp = bufs + 3
                tmp = bufs + 4
                if plan_selfmod_param(bufs + 5, om, op, inst, voice,
                                      freq, visited):
                    emit(Stage(K_WRUN_SELF, inst=inst, op=op, dst=tmp,
                               a=phase_buf, b=bufs + 5, voice=voice,
                               wave=om.wave))
                else:
                    emit(Stage(K_WRUN, inst=inst, op=op, dst=tmp,
                               a=phase_buf, voice=voice,
                               skip_line=(L_PMA,), wave=om.wave))
                emit(Stage(K_MIX, inst=inst, op=op, dst=mix_buf,
                           a=tmp, b=amp, wave_env=wave_env, layer=layer,
                           voice=voice))
            elif t == P.POPT_RASEG:
                cycle_buf = bufs + 1
                rasg_buf = bufs + 2
                freq = plan_param_rangemod(bufs + 3, om, op, inst, voice,
                                           om.mods[P.POP_N_fmod - 1],
                                           om.mods[P.POP_N_rfmod - 1],
                                           L_FREQ, L_FREQ2, parent_freq,
                                           -1, visited)
                pmods = om.mods[P.POP_N_pmod - 1]
                fpmods = om.mods[P.POP_N_fpmod - 1]
                pm_buf = -1
                fpm_buf = -1
                if pmods:
                    for i, mid in enumerate(pmods):
                        plan_block(bufs + 4, mid, inst, voice, freq,
                                   False, i != 0, visited)
                    pm_buf = bufs + 4
                if fpmods:
                    for i, mid in enumerate(fpmods):
                        plan_block(bufs + 5, mid, inst, voice, freq,
                                   False, i != 0, visited)
                    fpm_buf = bufs + 5
                ras = (om.ras_line, om.ras_func, om.ras_level,
                       om.ras_alpha, om.ras_flags, om.ras_rate2x)
                # phase values written to dst+1 (== rasg_buf)
                emit(Stage(K_RCYCLE, inst=inst, op=op, dst=cycle_buf,
                           a=freq, b=pm_buf, c=fpm_buf, voice=voice,
                           ras=ras))
                plan_param_rangemod(bufs + 4, om, op, inst, voice,
                                    om.mods[P.POP_N_amod - 1],
                                    om.mods[P.POP_N_ramod - 1],
                                    L_AMP, L_AMP2, -1, freq, visited)
                amp = bufs + 4
                if plan_selfmod_param(bufs + 5, om, op, inst, voice,
                                      freq, visited):
                    emit(Stage(K_RRUN_SELF, inst=inst, op=op,
                               dst=rasg_buf, a=cycle_buf, b=bufs + 5,
                               voice=voice, ras=ras))
                else:
                    emit(Stage(K_RRUN, inst=inst, op=op, dst=rasg_buf,
                               a=cycle_buf, voice=voice,
                               skip_line=(L_PMA,), ras=ras))
                emit(Stage(K_MIX, inst=inst, op=op, dst=mix_buf,
                           a=rasg_buf, b=amp, wave_env=wave_env,
                           layer=layer, voice=voice))

        for v in range(self.n_voices):
            if not vo_has_carr[v]:
                continue
            carr = vo_carr[v]
            om = ops[carr]
            if not om.prepared:
                continue
            plan_block(0, carr, -1, v, -1, False, False, frozenset())
            carr_inst = None
            for ii in range(len(insts) - 1, -1, -1):
                if insts[ii].op == carr and insts[ii].parent == -1 \
                        and insts[ii].voice == v:
                    carr_inst = ii
                    break
            t = om.type
            freq_buf_id = {P.POPT_WAVE: 3 - 1, P.POPT_RASEG: 4 - 1}.get(
                t, 0)
            camods = om.mods[P.POP_N_camod - 1]
            pan_buf = 1 + freq_buf_id
            # pan line fill (running vs skipping a goal-less line is
            # state- and value-equivalent, so always fill)
            emit(Stage(K_LINE, inst=carr_inst, op=carr, dst=pan_buf,
                       a=-1, line=L_PAN, voice=v,
                       ltype=om.ltype[L_PAN]))
            freq_alias = freq_buf_id if freq_buf_id > 0 else -1
            for mid in camods:
                plan_block(pan_buf, mid, carr_inst, v, freq_alias,
                           False, True, frozenset())
            emit(Stage(K_VMIX, inst=carr_inst, op=carr, dst=pan_buf,
                       a=0, voice=v, freq_buf_id=freq_buf_id))

        # duplicate-instance structure: an op referenced from several
        # lists gets several instances; later ones must read the state
        # written by earlier ones, and only the last writes back
        first_inst = {}
        inst_src = []
        for ii, it in enumerate(insts):
            inst_src.append(first_inst.get(it.op, -1))
            if it.op not in first_inst:
                first_inst[it.op] = ii
        scatter_list = tuple(sorted(first_inst.values()))
        stage_sig = tuple(
            (s.kind, s.inst, s.dst, s.a, s.b, s.c, s.line, s.wave_env,
             s.layer, s.skip_line, s.freq_buf_id,
             insts[s.inst].parent if s.inst >= 0 else -2,
             s.wave, s.ntype, s.ltype, s.ras)
            for s in stages)
        sig = (stage_sig, tuple(inst_src), scatter_list)
        return stages, insts, sig

    # ------------------------------------------------------------------

    def _build_block_tables(self):
        """Split each epoch into event-aligned blocks of <= self.block
        samples, with update-record ranges applied at block starts."""
        for ep in self.epochs:
            breakpoints = []
            for ei in range(ep.ev_lo, ep.ev_hi):
                breakpoints.append((self.ev_abs[ei], ei))
            # per-epoch block size: the longest event-free segment,
            # rounded up (capped) -- fewer scan steps on sparse scripts
            seg_max = 0
            marks = sorted({t for t, _ in breakpoints}
                           | {ep.start, ep.end})
            for a, b in zip(marks, marks[1:]):
                seg_max = max(seg_max, b - a)
            B = _round_block(seg_max if seg_max else self.block)
            ep.block = B
            lens = []
            rec_lo = []
            rec_hi = []
            b_sop = []
            b_iop = []
            oc = ep.op_changes or [(ep.start,
                                    [st.op for st in ep.stages],
                                    [i.op for i in ep.instances])]
            oc_i = 0
            pos = ep.start
            bi = 0
            # events at ep.start (possibly several) apply to first block
            while pos < ep.end or bi < len(breakpoints):
                lo = hi = 0
                while bi < len(breakpoints) and \
                        breakpoints[bi][0] <= pos:
                    ei = breakpoints[bi][1]
                    if lo == hi:
                        lo = self.ev_rec_lo[ei]
                    hi = self.ev_rec_hi[ei]
                    bi += 1
                next_bp = breakpoints[bi][0] if bi < len(breakpoints) \
                    else ep.end
                seg_end = min(next_bp, ep.end)
                blen = min(seg_end - pos, B)
                if blen <= 0 and lo == hi:
                    break
                while oc_i + 1 < len(oc) and oc[oc_i + 1][0] <= pos:
                    oc_i += 1
                lens.append(max(blen, 0))
                rec_lo.append(lo)
                rec_hi.append(hi)
                b_sop.append(oc[oc_i][1])
                b_iop.append(oc[oc_i][2])
                pos += max(blen, 0)
                if blen <= 0 and pos >= ep.end and bi >= len(breakpoints):
                    break
            if not lens:
                lens = [0]
                rec_lo = [0]
                rec_hi = [0]
                b_sop = [oc[0][1]]
                b_iop = [oc[0][2]]
            ep.blk_len = np.array(lens, dtype=np.int32)
            ep.blk_rec_lo = np.array(rec_lo, dtype=np.int32)
            ep.blk_rec_hi = np.array(rec_hi, dtype=np.int32)
            ns = len(ep.stages)
            ni = len(ep.instances)
            ep.blk_stage_op = (np.array(b_sop, dtype=np.int32)
                               if ns else
                               np.zeros((len(lens), 0), np.int32))
            ep.blk_inst_op = (np.array(b_iop, dtype=np.int32)
                              if ni else
                              np.zeros((len(lens), 0), np.int32))
