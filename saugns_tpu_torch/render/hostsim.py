"""Host-side scalar state simulation for the flat (time-parallel)
render path.

Everything the per-block device scan threads through its carry --
line-sweep states, operator/voice time counters, gates -- is a
deterministic function of the update records and block lengths alone:
no audio feeds back into it (the one exception, ratio-flip value
conversion against a live multiplier buffer, is detected and routed
to the sequential path). So the planner can run the whole scalar
state machine here in NumPy, bit-exactly mirroring the device
semantics (apply_records / line_run_vec / line_skip_vec,
engine.py), and bake per-block snapshots as plan constants. The
device then renders every block of an epoch *in parallel* from the
baked states -- the lax.scan over blocks (and its ~300 kernel
launches per block) disappears from the hot path.

Audio-dependent state (oscillator phases under FM, PILUT
differentiator memory, noise integrators) is NOT simulated: the flat
renderer computes it on device with global prefix sums and held-roll
pairings, which is exact because those recurrences are linear in the
per-sample increments (see flat.py).

Mirrors: handle_event/update_op (sau/generator.c:245-377), sauLine
state machine (sau/line.c:287-473), run_for_time gating
(sau/generator.c:833-903).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..dsp import prim
from ..lang import program as P
from .plan import (K_CONST1, K_LINE, K_MIX, K_NOISE, K_RANGEMOD,
                   K_RCYCLE, K_RRUN, K_RRUN_SELF, K_VMIX, K_WPHASE,
                   K_WRUN, K_WRUN_SELF, K_ZERO, RenderPlan)

f32 = np.float32
i64 = np.int64

BIG_TIME = 0x7fffffff

LF_STATE = P.LINEP_STATE
LF_SRATIO = P.LINEP_STATE_RATIO
LF_GOAL = P.LINEP_GOAL
LF_GRATIO = P.LINEP_GOAL_RATIO
LF_TYPE = P.LINEP_TYPE
LF_TIME = P.LINEP_TIME
LF_TIFNEW = P.LINEP_TIME_IF_NEW

N_SLOTS = 6


def _line_val_at(typ, pos, end, v0, vt):
    """Scalar value of a line at position ``pos`` -- numpy mirror of
    jdsp.line_val_at / line_fill (one sample), float32 rounding
    per op. Used by the sauLine_copy 'pick current point' path."""
    from ..dsp import lines as L
    v = L.FILL_FUNCS[typ](1, f32(v0), f32(vt), int(pos), int(end), None)
    return float(v[0])


class LState:
    """Per-(op, slot) line state, device-layout scalars."""
    __slots__ = ('v0', 'vt', 'pos', 'end', 'type', 'flags')

    def __init__(self):
        self.v0 = f32(0.0)
        self.vt = f32(0.0)
        self.pos = 0
        self.end = 0
        self.type = 0
        self.flags = 0

    def snap(self):
        return (self.v0, self.vt, self.pos, self.end, self.flags)


@dataclass
class StageBake:
    """Per-stage baked block tables for one epoch (length nb each)."""
    # K_LINE: line state at this stage's execution point per block
    v0: Optional[np.ndarray] = None
    vt: Optional[np.ndarray] = None
    pos: Optional[np.ndarray] = None
    end: Optional[np.ndarray] = None
    flags: Optional[np.ndarray] = None
    # K_NOISE: counter offset from epoch-start state per block
    noff: Optional[np.ndarray] = None
    # osc/noise stages: was ever active (gate & len > 0) in the epoch
    active: bool = False
    # flat index (into the epoch's nb*B sample grid) of the last
    # in-range sample, and whether one exists -- for prev_s extraction
    last_ir: int = 0


@dataclass
class SegBake:
    """One flat-renderable block range [lo, hi) of an epoch: operator
    bindings are constant inside it and oscillator records occur only
    at its first block."""
    lo: int = 0
    hi: int = 0
    eligible: bool = False
    reason: str = ''
    # authoritative scalar state at segment end (full columns)
    end_lv0: Optional[np.ndarray] = None     # (n_ops, 6) f32
    end_lvt: Optional[np.ndarray] = None
    end_lpos: Optional[np.ndarray] = None    # (n_ops, 6) i32
    end_lend: Optional[np.ndarray] = None
    end_ltype: Optional[np.ndarray] = None
    end_lflags: Optional[np.ndarray] = None
    end_time: Optional[np.ndarray] = None    # (n_ops,) i32
    end_tinf: Optional[np.ndarray] = None
    end_vdur: Optional[np.ndarray] = None    # (n_voices,) i32


@dataclass
class EpochBake:
    eligible: bool = False    # every segment flat-renderable
    reason: str = ''
    segments: List[SegBake] = field(default_factory=list)
    lens: Optional[np.ndarray] = None    # (nb, n_insts) i32, gated
    gates: Optional[np.ndarray] = None   # (nb, n_insts) bool
    stages: Dict[int, StageBake] = field(default_factory=dict)


class HostSim:
    """Simulates the scalar state machine over the whole plan,
    producing an EpochBake per epoch. ``bakes[i].eligible`` is False
    for epochs that must run on the sequential engine (self-PM
    feedback, mid-epoch oscillator records / op rebinding, or a
    ratio-flip conversion against a live multiplier)."""

    def __init__(self, plan: RenderPlan):
        self.plan = plan
        n = plan.n_ops
        self.lines = [[LState() for _ in range(N_SLOTS)]
                      for _ in range(n)]
        self.time = np.zeros(n, np.int64)
        self.tinf = np.zeros(n, bool)
        self.vdur = np.zeros(plan.n_voices, np.int64)
        self.tainted = False   # sim diverged; no further flat epochs
        self.bakes: List[EpochBake] = []
        self._run()

    # -- record application (mirror of engine.apply_records) -------------

    def _apply_record(self, ri):
        ra = self.plan.rec_arrays
        g = lambda k: ra[k][ri]
        if g('kind') == 1:
            vo = int(g('vo'))
            carr = int(g('carr'))
            self.vdur[vo] = 0 if self.tinf[carr] else self.time[carr]
            return
        op = int(g('op'))
        if g('prepare'):
            for sl in range(N_SLOTS):
                self.lines[op][sl].__init__()
            self.time[op] = 0
            self.tinf[op] = False
        params = int(g('params'))
        typ = int(g('type'))
        is_osc = typ in (P.POPT_WAVE, P.POPT_RASEG)
        for sl in range(N_SLOTS):
            if not g('l%d_present' % sl):
                continue
            if sl in (3, 4, 5) and not is_osc:
                continue
            self._line_copy(self.lines[op][sl], int(g('l%d_flags' % sl)),
                            f32(g('l%d_v0' % sl)), f32(g('l%d_vt' % sl)),
                            int(g('l%d_end' % sl)),
                            int(g('l%d_type' % sl)))
        if params & P.POPP_TIME:
            self.time[op] = int(g('time_v'))
            self.tinf[op] = bool(g('time_implicit'))

    def _line_copy(self, cur, rflags, rv0, rvt, rend, rtype):
        """Mirror of engine._line_copy_scalar (sauLine_copy,
        sau/line.c:287-332)."""
        src_state = (rflags & LF_STATE) != 0
        src_goal = (rflags & LF_GOAL) != 0
        src_type = (rflags & LF_TYPE) != 0
        src_time = (rflags & LF_TIME) != 0
        src_tifnew = (rflags & LF_TIFNEW) != 0
        cur_goal = (cur.flags & LF_GOAL) != 0
        cur_gratio = (cur.flags & LF_GRATIO) != 0
        cur_sratio = (cur.flags & LF_SRATIO) != 0
        mask = (LF_STATE | LF_SRATIO) if src_state else 0
        if src_state:
            cur.v0 = f32(rv0)
        elif cur_goal and src_goal:
            if cur.pos < cur.end:
                cur.v0 = f32(_line_val_at(cur.type, cur.pos, cur.end,
                                          cur.v0, cur.vt))
            if cur_gratio and not cur_sratio:
                cur.flags |= LF_SRATIO
            elif not cur_gratio and cur_sratio:
                cur.flags &= ~LF_SRATIO
        if src_goal:
            cur.vt = f32(rvt)
            if src_tifnew:
                cur.end = cur.end - cur.pos
            cur.pos = 0
            mask |= LF_GOAL | LF_GRATIO
        if src_type:
            cur.type = rtype
            mask |= LF_TYPE
        cur_time = (cur.flags & LF_TIME) != 0
        if (not cur_time or not src_tifnew) and src_time:
            cur.end = rend
            mask |= LF_TIME
        cur.flags = (cur.flags & ~mask) | (rflags & mask)

    # -- line advance (mirror of line_run_vec / line_skip_vec) -----------

    def _line_run_state(self, ls, length, has_mul):
        """State transition of line_run_vec. Returns False if a
        ratio-flip conversion against a live mulbuf occurs (value
        depends on audio -> caller taints the sim)."""
        goal = (ls.flags & LF_GOAL) != 0
        gratio = (ls.flags & LF_GRATIO) != 0
        sratio = (ls.flags & LF_SRATIO) != 0
        if has_mul and goal and gratio != sratio:
            return False
        remaining = max(ls.end - ls.pos, 0)
        lg = min(remaining, length) if goal else 0
        adv = lg if goal else min(remaining, length)
        pos_new = ls.pos + adv
        reached = pos_new >= ls.end
        if goal and reached:
            ls.v0 = ls.vt
        if goal:
            ls.flags = (ls.flags & ~LF_SRATIO) | (LF_SRATIO if gratio
                                                  else 0)
        if goal and reached:
            ls.flags &= ~(LF_GOAL | LF_GRATIO | LF_TIME)
        elif not goal and reached:
            ls.flags &= ~LF_TIME
        ls.pos = 0 if reached else pos_new
        return True

    def _line_skip_state(self, ls, length):
        """Mirror of line_skip_vec (sau/line.c:456-473)."""
        goal = (ls.flags & LF_GOAL) != 0
        gratio = (ls.flags & LF_GRATIO) != 0
        remaining = max(ls.end - ls.pos, 0)
        adv = min(remaining, length)
        pos_new = ls.pos + adv
        reached = pos_new >= ls.end
        fl = ls.flags
        if reached:
            fl &= ~LF_TIME
        if reached and goal:
            ls.v0 = ls.vt
            if gratio:
                fl |= LF_SRATIO
            else:
                fl &= ~LF_SRATIO
            fl &= ~(LF_GOAL | LF_GRATIO)
        ls.flags = fl
        ls.pos = 0 if reached else pos_new

    # -- main sweep -------------------------------------------------------

    def _run(self):
        plan = self.plan
        for ep in plan.epochs:
            self.bakes.append(self._run_epoch(ep))

    def _seg_starts(self, ep):
        """Blocks that must start a new flat segment: oscillator
        records (prepare / phase / seed / mode) or operator-binding
        changes are confined to segment starts."""
        ra = self.plan.rec_arrays
        nb = len(ep.blk_len)
        starts = {0}
        for k in range(1, nb):
            for ri in range(ep.blk_rec_lo[k], ep.blk_rec_hi[k]):
                if ra['kind'][ri] != 0:
                    continue
                if ra['prepare'][ri] or (
                        ra['params'][ri] & (P.POPP_PHASE | P.POPP_SEED
                                            | P.POPP_MODE)):
                    starts.add(k)
                    break
            if not np.array_equal(ep.blk_stage_op[k],
                                  ep.blk_stage_op[k - 1]) or \
                    not np.array_equal(ep.blk_inst_op[k],
                                       ep.blk_inst_op[k - 1]):
                starts.add(k)
        return sorted(starts)

    def _seg_shared_cells(self, ep, lo):
        """Duplicate instances sharing a device state cell interleave
        their per-block advances; the flat path computes each stage
        over all blocks at once, which would diverge."""
        seen = set()
        stage_op = np.asarray(ep.blk_stage_op[lo]).ravel()
        for si, s in enumerate(ep.stages):
            if s.kind in (K_WPHASE, K_WRUN, K_RCYCLE, K_NOISE):
                cell = (int(stage_op[si]), s.kind)
                if cell in seen:
                    return True
                seen.add(cell)
        return False

    def _snap_end(self, seg):
        n = self.plan.n_ops
        seg.end_lv0 = np.zeros((n, N_SLOTS), f32)
        seg.end_lvt = np.zeros((n, N_SLOTS), f32)
        seg.end_lpos = np.zeros((n, N_SLOTS), np.int32)
        seg.end_lend = np.zeros((n, N_SLOTS), np.int32)
        seg.end_ltype = np.zeros((n, N_SLOTS), np.int32)
        seg.end_lflags = np.zeros((n, N_SLOTS), np.int32)
        for op in range(n):
            for sl in range(N_SLOTS):
                ls = self.lines[op][sl]
                seg.end_lv0[op, sl] = ls.v0
                seg.end_lvt[op, sl] = ls.vt
                seg.end_lpos[op, sl] = ls.pos
                seg.end_lend[op, sl] = ls.end
                seg.end_ltype[op, sl] = ls.type
                seg.end_lflags[op, sl] = ls.flags
        seg.end_time = np.clip(self.time, -0x80000000,
                               0x7fffffff).astype(np.int32)
        seg.end_tinf = self.tinf.astype(np.int32)
        seg.end_vdur = np.clip(self.vdur, -0x80000000,
                               0x7fffffff).astype(np.int32)

    def _run_epoch(self, ep) -> EpochBake:
        plan = self.plan
        nb = len(ep.blk_len)
        n_insts = len(ep.instances)
        hard = ''
        if self.tainted:
            hard = 'sim tainted by earlier ratio-flip conversion'
        # self-PM epochs ARE flat-eligible since the masked selfmod
        # pass (flat._wrun_self_stage/_rrun_self_stage carries the
        # feedback state like phases); SAUGNS_TPU_FLAT_SELFMOD=0
        # restores the sequential-engine routing
        import os
        if os.environ.get('SAUGNS_TPU_FLAT_SELFMOD', '1') != '1':
            for s in ep.stages:
                if s.kind in (K_WRUN_SELF, K_RRUN_SELF):
                    hard = 'self-PM feedback stage'
        bake = EpochBake(eligible=False, reason=hard)
        el = not hard
        starts = self._seg_starts(ep)
        seg_of_block = np.zeros(nb, np.int32)
        for i, lo in enumerate(starts):
            hi = starts[i + 1] if i + 1 < len(starts) else nb
            seg_of_block[lo:hi] = i
            seg = SegBake(lo=lo, hi=hi)
            if el:
                if self._seg_shared_cells(ep, lo):
                    seg.eligible = False
                    seg.reason = 'shared oscillator state cell'
                else:
                    seg.eligible = True
            else:
                seg.reason = hard
            bake.segments.append(seg)
        if el:
            bake.lens = np.zeros((nb, n_insts), np.int32)
            bake.gates = np.zeros((nb, n_insts), bool)
            for si, s in enumerate(ep.stages):
                if s.kind == K_LINE:
                    bake.stages[si] = StageBake(
                        v0=np.zeros(nb, f32), vt=np.zeros(nb, f32),
                        pos=np.zeros(nb, np.int32),
                        end=np.zeros(nb, np.int32),
                        flags=np.zeros(nb, np.int32))
                elif s.kind == K_NOISE:
                    bake.stages[si] = StageBake(
                        noff=np.zeros(nb, np.uint32))

        # last stage index per instance (for inst_end / C_TIME decr)
        last_stage = {}
        for si, s in enumerate(ep.stages):
            if s.inst >= 0:
                last_stage[s.inst] = si

        noise_n = {si: np.uint32(0) for si, s in enumerate(ep.stages)
                   if s.kind == K_NOISE}

        for k in range(nb):
            blen = int(ep.blk_len[k])
            for ri in range(ep.blk_rec_lo[k], ep.blk_rec_hi[k]):
                self._apply_record(ri)
            stage_op = np.asarray(ep.blk_stage_op[k]).ravel()
            inst_op = np.asarray(ep.blk_inst_op[k]).ravel()

            # voice gates at block start
            vlen = {}
            vgate = {}
            for s in ep.stages:
                v = s.voice
                if v >= 0 and v not in vlen:
                    vd = int(self.vdur[v])
                    vlen[v] = min(vd, blen)
                    vgate[v] = (vd > 0) and (blen > 0)

            lens = [0] * n_insts
            gates = [False] * n_insts
            inst_done = [False] * n_insts

            def inst_begin(ii, v):
                par = ep.instances[ii].parent
                op = int(inst_op[ii])
                own = BIG_TIME if self.tinf[op] else int(self.time[op])
                plen = vlen[v] if par < 0 else lens[par]
                lens[ii] = min(plen, own)
                gt = vgate[v] if par < 0 else gates[par]
                if par < 0:
                    gt = gt and ((self.time[op] > 0) or self.tinf[op])
                gates[ii] = gt

            def inst_end(ii):
                op = int(inst_op[ii])
                if gates[ii] and not self.tinf[op]:
                    self.time[op] -= lens[ii]

            for si, s in enumerate(ep.stages):
                ii = s.inst
                if ii >= 0 and not inst_done[ii]:
                    inst_begin(ii, s.voice)
                    inst_done[ii] = True
                op = int(stage_op[si])
                row = op  # shared per-op state (inst_src dedup)
                length = lens[ii] if ii >= 0 else min(
                    int(self.vdur[s.voice]), blen)
                gate = gates[ii] if ii >= 0 else vgate[s.voice]
                elen = length if gate else 0
                if el:
                    sb = bake.stages.get(si)
                    if s.kind == K_LINE:
                        ls = self.lines[row][s.line]
                        sb.v0[k] = ls.v0
                        sb.vt[k] = ls.vt
                        sb.pos[k] = ls.pos
                        sb.end[k] = ls.end
                        sb.flags[k] = ls.flags
                    elif s.kind == K_NOISE:
                        sb.noff[k] = noise_n[si]
                        noise_n[si] += np.uint32(elen)
                # state transitions (gated like the device writes)
                if s.kind == K_LINE:
                    ls = self.lines[row][s.line]
                    before = ls.snap()
                    ok = self._line_run_state(ls, length, s.a >= 0)
                    if not ok:
                        # audio-dependent ratio conversion: the new v0
                        # depends on the live multiplier buffer, which
                        # the sim cannot know -- stop trusting it
                        self._force_line_adv(ls, length)
                        if gate:
                            self.tainted = True
                            el = False
                            for seg in bake.segments:
                                if seg.hi > k:
                                    seg.eligible = False
                                    seg.reason = \
                                        'ratio-flip conversion w/ mul'
                    if not gate:
                        (ls.v0, ls.vt, ls.pos, ls.end, ls.flags) = \
                            (before[0], before[1], before[2], before[3],
                             before[4])
                for sl in s.skip_line:
                    ls = self.lines[row][sl]
                    if gate:
                        self._line_skip_state(ls, length)
                if ii >= 0 and last_stage.get(ii) == si:
                    inst_end(ii)
                if el and ii >= 0:
                    bake.lens[k, ii] = lens[ii] if gates[ii] else 0
                    bake.gates[k, ii] = gates[ii]
            for v in sorted(vgate.keys()):
                if vgate[v]:
                    self.vdur[v] -= vlen[v]
            sid = int(seg_of_block[k])
            if k + 1 >= nb or int(seg_of_block[k + 1]) != sid:
                if bake.segments[sid].eligible:
                    self._snap_end(bake.segments[sid])

        bake.eligible = bool(bake.segments) and \
            all(sg.eligible for sg in bake.segments)
        if not bake.eligible and not bake.reason:
            bake.reason = '; '.join(sorted(
                {sg.reason for sg in bake.segments if sg.reason}))
        return bake

    def _force_line_adv(self, ls, length):
        """Advance a tainted line's pos/flags (values untrusted)."""
        goal = (ls.flags & LF_GOAL) != 0
        gratio = (ls.flags & LF_GRATIO) != 0
        remaining = max(ls.end - ls.pos, 0)
        adv = min(remaining, length)
        pos_new = ls.pos + adv
        reached = pos_new >= ls.end
        if goal and reached:
            ls.v0 = ls.vt
        if goal:
            ls.flags = (ls.flags & ~LF_SRATIO) | (LF_SRATIO if gratio
                                                  else 0)
        if goal and reached:
            ls.flags &= ~(LF_GOAL | LF_GRATIO | LF_TIME)
        elif not goal and reached:
            ls.flags &= ~LF_TIME
        ls.pos = 0 if reached else pos_new
