"""Render engine of the port: ``TorchGenerator``.

Counterpart of ``saugns_tpu.render.engine.JaxGenerator``: a Program is
planned (``RenderPlan``), its scalar state machine is baked on the
host (``HostSim``), and every epoch renders on the chosen device as
flat segments, then converts to int16 there. An epoch that ``HostSim``
cannot bake (a ratio-flip line conversion against a live multiplier,
for one) renders on the sequential-scan engine below instead
(``build_epoch_fn``): a loop over the epoch's event-aligned blocks
that applies the block's update records, runs the epoch's stage
schedule over the block's samples and carries the packed per-op state
to the next block. ``flat=False`` sends every epoch down that path, as
``SAUGNS_TPU_FLAT=0`` does for the JAX generator. It serves the same
``run(out_i16, buf_len, stereo)`` pull contract as the reference's
generator.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..lang import program as P
from . import tdsp
from .flat import STREAM_GROUP, FlatSegment
from .hostsim import HostSim
from .plan import (BLOCK, K_CONST1, K_LINE, K_MIX, K_NOISE, K_RANGEMOD,
                   K_RCYCLE, K_RRUN, K_RRUN_SELF, K_VMIX, K_WPHASE,
                   K_WRUN, K_WRUN_SELF, K_ZERO, RenderPlan)
from .state import (C_LEND, C_LFLAGS, C_LPOS, C_LV0, C_LVT, C_NN,
                    C_NPREV, C_PHASE, C_RCPHI, C_RCPLO, C_RFB, C_RPS,
                    C_TIME, C_TINF, C_WFB, C_WPPH, C_WPS, C_WRESET,
                    _to_i16_device, _to_i16_mono_device, apply_records,
                    i32, line_run_vec, line_skip_vec, make_state)

F32 = torch.float32
I64 = torch.int64
M32 = tdsp.M32
BIG_TIME = 0x7fffffff


def resolve_device(device=None):
    """The device to render on: ``device`` when given, else CUDA.
    Raises RuntimeError when CUDA is asked for (or defaulted to) and
    not available; the CPU is used only when asked for."""
    dev = torch.device(device if device is not None else 'cuda')
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'saugns_tpu_torch renders on CUDA, and no CUDA device is '
            'available; pass device="cpu" (CLI: '
            'SAUGNS_TPU_TORCH_DEVICE=cpu) to render on the CPU')
    return dev


# -- the sequential-scan engine ----------------------------------------------

def _analyze_schedule(stage_sig, inst_src):
    """Host-side dependency analysis of an epoch schedule (the JAX
    engine's, engine.py:465).

    Buffers are SSA-renamed (each write creates a new version) and
    per-op state cells are sequentially chained, giving a DAG whose
    longest-path levels define a correct parallel order: stages at the
    same level are independent, so their phase scans, line runs and
    tap gathers can be batched into single calls. This is pure
    reordering -- every stage computes bit-identical values to the
    sequential schedule.

    Returns (plan, rkey, wkey): plan is a list of execution groups
    ('stages', [si..]) / ('line', [si..]) / ('wphase', [si..]) /
    ('rcycle', [si..]) / ('wrun', wave, [si..]); rkey[si]/wkey[si] map
    buffer slots to SSA (slot, version) keys."""
    n = len(stage_sig)
    deps = [set() for _ in range(n)]
    rkey = [dict() for _ in range(n)]
    wkey = [dict() for _ in range(n)]
    cur: Dict[int, tuple] = {}
    cells_last: Dict[tuple, int] = {}
    mix_last = None

    def rd(si, slot):
        if slot is None or slot < 0:
            return
        ver, prod = cur.get(slot, (0, None))
        rkey[si][slot] = (slot, ver)
        if prod is not None:
            deps[si].add(prod)

    def wr(si, slot):
        ver, _ = cur.get(slot, (0, None))
        cur[slot] = (ver + 1, si)
        wkey[si][slot] = (slot, ver + 1)

    def cell(si, key):
        prev = cells_last.get(key)
        if prev is not None and prev != si:
            deps[si].add(prev)
        cells_last[key] = si

    for si, s in enumerate(stage_sig):
        (kind, inst, dst, a, b, c, line, wave_env, layer, skip_line,
         fbid, par, wave, ntype, ltype, ras) = s
        row = inst_src[inst] if inst >= 0 and inst_src[inst] >= 0 \
            else inst
        if kind == K_LINE:
            rd(si, a)
            wr(si, dst)
            cell(si, (row, 'L', line))
        elif kind == K_RANGEMOD:
            rd(si, dst)
            rd(si, a)
            rd(si, b)
            wr(si, dst)
        elif kind in (K_CONST1, K_ZERO):
            wr(si, dst)
        elif kind == K_NOISE:
            wr(si, dst)
            cell(si, (row, 'N'))
        elif kind == K_WPHASE:
            rd(si, a)
            rd(si, b)
            rd(si, c)
            wr(si, dst)
            cell(si, (row, 'PH'))
        elif kind in (K_WRUN, K_WRUN_SELF):
            rd(si, a)
            if kind == K_WRUN_SELF:
                rd(si, b)
            wr(si, dst)
            cell(si, (row, 'W'))
        elif kind == K_RCYCLE:
            rd(si, a)
            rd(si, b)
            rd(si, c)
            wr(si, dst)
            wr(si, dst + 1)
            cell(si, (row, 'RC'))
        elif kind in (K_RRUN, K_RRUN_SELF):
            rd(si, a)
            rd(si, dst)
            if kind == K_RRUN_SELF:
                rd(si, b)
            wr(si, dst)
            if kind == K_RRUN_SELF:
                cell(si, (row, 'RS'))
        elif kind == K_MIX:
            rd(si, a)
            rd(si, b)
            if layer:
                rd(si, dst)
            wr(si, dst)
        elif kind == K_VMIX:
            rd(si, dst)
            rd(si, a)
            # stereo accumulation order is part of the bit-exact
            # contract: chain VMIX stages
            if mix_last is not None:
                deps[si].add(mix_last)
            mix_last = si
        for sl in skip_line:
            cell(si, (row, 'L', sl))

    level = [0] * n
    for si in range(n):
        level[si] = 1 + max((level[d] for d in deps[si]), default=-1)

    plan = []
    for lv in range((max(level) + 1) if n else 0):
        sis = [si for si in range(n) if level[si] == lv]
        rest = []
        wp = []
        rc = []
        wrun_by_wave: Dict[int, list] = {}
        line_by: Dict[tuple, list] = {}
        for si in sis:
            kind = stage_sig[si][0]
            if kind == K_WPHASE:
                wp.append(si)
            elif kind == K_RCYCLE:
                rc.append(si)
            elif kind == K_WRUN:
                wrun_by_wave.setdefault(stage_sig[si][12],
                                        []).append(si)
            elif kind == K_LINE:
                line_by.setdefault(
                    (stage_sig[si][14], stage_sig[si][3] >= 0),
                    []).append(si)
            else:
                rest.append(si)
        for _key, group in sorted(line_by.items()):
            if len(group) > 1:
                plan.append(('line', group))
            else:
                rest = group + rest
        if len(wp) > 1:
            plan.append(('wphase', wp))
        else:
            rest = wp + rest
        if len(rc) > 1:
            plan.append(('rcycle', rc))
        else:
            rest = rc + rest
        for wave, group in sorted(wrun_by_wave.items()):
            if len(group) > 1:
                plan.append(('wrun', wave, group))
            else:
                rest = group + rest
        if rest:
            plan.append(('stages', sorted(rest)))
    return plan, rkey, wkey


def build_epoch_fn(sig, n_insts, B, amp_scale, inst_parent, stage_voices,
                   srate, piluts, plain=False):
    """The sequential-scan epoch function of one epoch schedule (the JAX
    engine's build_epoch_fn, engine.py:625, with a Python loop over the
    blocks in place of its lax.scan). ``sig`` = (stage entries,
    inst_src, scatter_list) from the planner; ``piluts`` the (12, 2048)
    tables on the render device; ``plain`` runs the kernels' plain
    versions.

    Returns epoch_fn(st, blk_len, blk_rec_lo, blk_rec_hi, blk_inst_op,
    recs), a generator of (st, (B, 2) float32 mix) per block. Per-op
    scalar state is gathered into packed rows once per block and
    scattered back once; the block's record ranges and lengths are host
    values of the plan, while stage lengths and gates stay device
    tensors, so the loop never waits for the device."""
    stage_sig, inst_src, scatter_list = sig
    coeff = float(np.float32(np.float32(4294967296.0) / np.float64(srate)))
    amp_scale = float(np.float32(amp_scale))
    exec_plan, rkey, wkey = _analyze_schedule(stage_sig, inst_src)
    src_row = [i if inst_src[i] < 0 else inst_src[i]
               for i in range(n_insts)]
    last_stage = {}
    for si_, s in enumerate(stage_sig):
        if s[1] >= 0:
            last_stage[s[1]] = si_
    voices = sorted({v for v in stage_voices if v >= 0})
    scan32 = tdsp.prefix_sum_plain if plain else tdsp.prefix_sum
    scan64 = tdsp.prefix_sum_u64_plain if plain else tdsp.prefix_sum_u64
    scan_rows = tdsp.prefix_sum_rows_plain if plain \
        else tdsp.prefix_sum_rows
    taps_of = tdsp.gather_taps_plain if plain else tdsp.gather_taps

    def step(st, blen, inst_op, idx, cache):
        dev = idx.device
        zf = torch.zeros((), dtype=F32, device=dev)
        mixl = torch.zeros(B, dtype=F32, device=dev)
        mixr = torch.zeros(B, dtype=F32, device=dev)
        # one row gather for all per-op scalars this block
        fi = st['sf'][inst_op]
        ii = st['si'][inst_op].to(I64)
        fvals = {}
        ivals = {}

        def gf(inst, col):
            key = (src_row[inst], col)
            v = fvals.get(key)
            return fi[key] if v is None else v

        def gi(inst, col):
            key = (src_row[inst], col)
            v = ivals.get(key)
            return ii[key] if v is None else v

        def pf(inst, col, v, gate):
            fvals[(src_row[inst], col)] = torch.where(gate, v,
                                                      gf(inst, col))

        def pi(inst, col, v, gate):
            ivals[(src_row[inst], col)] = torch.where(gate, v,
                                                      gi(inst, col))

        def gu(inst, col):
            return gi(inst, col) & M32

        def pu(inst, col, v, gate):
            pi(inst, col, tdsp.asi32(v & M32), gate)

        lens = [None] * n_insts
        gates = [None] * n_insts
        vdur = st['vdur'].to(I64)
        vlen = {v: torch.clamp(vdur[v], max=blen) for v in voices}
        vgate = {v: (vdur[v] > 0) if blen > 0
                 else torch.zeros((), dtype=torch.bool, device=dev)
                 for v in voices}

        # instance begin/end bookkeeping in original order (scalar
        # only; reads and writes only C_TIME/C_TINF cells, which no
        # vector stage touches)
        inst_done = [False] * n_insts
        for si_, s in enumerate(stage_sig):
            inst = s[1]
            if inst < 0:
                continue
            if not inst_done[inst]:
                inst_done[inst] = True
                v = stage_voices[si_]
                par = inst_parent[inst]
                tinf = gi(inst, C_TINF) != 0
                own = torch.where(tinf, BIG_TIME, gi(inst, C_TIME))
                lens[inst] = torch.minimum(
                    vlen[v] if par < 0 else lens[par], own)
                if par < 0:
                    gates[inst] = vgate[v] & ((gi(inst, C_TIME) > 0)
                                              | tinf)
                else:
                    gates[inst] = gates[par]
            if last_stage.get(inst) == si_:
                tinf = gi(inst, C_TINF) != 0
                pi(inst, C_TIME, gi(inst, C_TIME) - lens[inst],
                   gates[inst] & ~tinf)

        def line_state(inst, slot):
            return {'v0': gf(inst, C_LV0 + slot),
                    'vt': gf(inst, C_LVT + slot),
                    'pos': gi(inst, C_LPOS + slot),
                    'end': gi(inst, C_LEND + slot),
                    'flags': gi(inst, C_LFLAGS + slot)}

        def put_line(inst, slot, ls, gate):
            pf(inst, C_LV0 + slot, ls['v0'], gate)
            pi(inst, C_LPOS + slot, ls['pos'], gate)
            pi(inst, C_LFLAGS + slot, ls['flags'], gate)
            pi(inst, C_LEND + slot, ls['end'], gate)

        def skip_lines(s, length, gate):
            for slot in s[9]:
                put_line(s[1], slot,
                         line_skip_vec(line_state(s[1], slot), length),
                         gate)

        def run_lines(sis, lgs):
            """K_LINE stages of one line type and multiplier use."""
            n_g = len(sis)
            lss = [line_state(stage_sig[si_][1], stage_sig[si_][6])
                   for si_ in sis]
            bls = {k: torch.stack([ls[k] for ls in lss]).reshape(n_g, 1)
                   for k in lss[0]}
            lengths = torch.stack([lg[0] for lg in lgs]).reshape(n_g, 1)
            muls = torch.stack([rdbuf(si_, stage_sig[si_][3])
                                for si_ in sis]) \
                if stage_sig[sis[0]][3] >= 0 else None
            out, nls = line_run_vec(bls, B, lengths, muls,
                                    stage_sig[sis[0]][14], idx[None, :])
            for k, si_ in enumerate(sis):
                s = stage_sig[si_]
                wrbuf(si_, s[2], out[k])
                put_line(s[1], s[6], {key: nls[key][k, 0] for key in
                                      ('v0', 'pos', 'flags', 'end')},
                         lgs[k][1])
                skip_lines(s, lgs[k][0], lgs[k][1])

        # SSA-versioned buffer values
        vals: Dict[tuple, torch.Tensor] = {}

        def rdbuf(si_, slot, default=None):
            if slot is None or slot < 0:
                return default
            return vals.get(rkey[si_].get(slot), default)

        def wrbuf(si_, slot, v):
            vals[wkey[si_][slot]] = v

        def stage_lg(si_, s):
            inst = s[1]
            if inst >= 0:
                return lens[inst], gates[inst]
            v = stage_voices[si_]
            return vlen[v], vgate[v]

        def phase_ofs(si_, s, freq, pscale, bits):
            """PM (s.b) and frequency-scaled PM (s.c) phase offset."""
            b, c = s[4], s[5]
            if b >= 0 and c >= 0:
                pofs = rdbuf(si_, b) \
                    + rdbuf(si_, c) * tdsp.HUMMID_INV * freq
            elif b >= 0:
                pofs = rdbuf(si_, b)
            elif c >= 0:
                pofs = rdbuf(si_, c) * tdsp.HUMMID_INV * freq
            else:
                return 0
            ofs = tdsp.ftoi(pofs * pscale)
            return ofs & M32 if bits == 32 else ofs

        def wphase_incs(si_, s, length):
            freq = rdbuf(si_, s[3])
            incs = tdsp.ftoi(freq * coeff) & M32
            return torch.where(idx < length, incs, 0), freq

        def wphase_finish(si_, s, run0, freq, length, gate):
            inst = s[1]
            run = (run0 + gu(inst, C_PHASE)) & M32
            ofs = phase_ofs(si_, s, freq, tdsp.P31, 32)
            wrbuf(si_, s[2], (ofs + run) & M32)
            pu(inst, C_PHASE, run[B - 1], gate & (length > 0))

        def rcycle_incs(si_, s, length):
            freq = rdbuf(si_, s[3])
            cf = float(np.float32(coeff * 2)) if s[15][5] else coeff
            incs = tdsp.ftoi(freq * cf)
            return torch.where(idx < length, incs, 0), freq

        def rcycle_finish(si_, s, csum, incs, freq, length, gate):
            inst, dst = s[1], s[2]
            pscale = float(np.float32(tdsp.P31 * 2)) if s[15][5] \
                else tdsp.P31
            cp0 = (gu(inst, C_RCPHI) << 32) | gu(inst, C_RCPLO)
            cph = phase_ofs(si_, s, freq, pscale, 64) + (cp0 + csum - incs)
            wrbuf(si_, dst, (cph >> 32) & M32)
            wrbuf(si_, dst + 1,
                  ((cph & M32) >> 1).to(F32) * tdsp.SCALE31)
            cp1 = cp0 + csum[B - 1]
            upd = gate & (length > 0)
            pu(inst, C_RCPLO, cp1, upd)
            pu(inst, C_RCPHI, cp1 >> 32, upd)

        def wrun_rows(sis, lgs, wave, taps2=None):
            """K_WRUN stages of one wave, one row each."""
            ss = [stage_sig[si_] for si_ in sis]
            st_of = lambda col, get: torch.stack(  # noqa: E731
                [get(s[1], col) for s in ss])
            length = torch.stack([lg[0] for lg in lgs])
            reset = (st_of(C_WRESET, gi) != 0) & (length > 0)
            out, npp, nps = tdsp.wosc_run_taps(
                piluts[wave], wave,
                torch.stack([rdbuf(si_, s[3]) for si_, s in zip(sis, ss)]),
                st_of(C_WPPH, gu), st_of(C_WPS, gf), reset, length,
                taps2=taps2, plain=plain)
            for k, (si_, s) in enumerate(zip(sis, ss)):
                wrbuf(si_, s[2], out[k])
                wosc_state(s[1], npp[k], nps[k], lgs[k])

        def wosc_state(inst, npp, nps, lg):
            upd = lg[1] & (lg[0] > 0)
            pu(inst, C_WPPH, npp, upd)
            pf(inst, C_WPS, nps, upd)
            pi(inst, C_WRESET, torch.zeros_like(npp), upd)

        def exec_stage(si_):
            nonlocal mixl, mixr
            s = stage_sig[si_]
            (kind, inst, dst, a, b, c, line, wave_env, layer,
             skip_line, _fbid, _par, wave, ntype, ltype, ras) = s
            length, gate = stage_lg(si_, s)
            mask = idx < length

            if kind == K_LINE:
                run_lines([si_], [(length, gate)])
                return
            if kind == K_RANGEMOD:
                par = rdbuf(si_, dst)
                wrbuf(si_, dst, torch.where(
                    mask, par + (rdbuf(si_, a) - par) * rdbuf(si_, b),
                    par))
            elif kind == K_CONST1:
                wrbuf(si_, dst, torch.ones(B, dtype=F32, device=dev))
            elif kind == K_NOISE:
                nn = gu(inst, C_NN)
                out, nprev = tdsp.noise_run(ntype, nn, gu(inst, C_NPREV),
                                            length, B, plain)
                wrbuf(si_, dst, out)
                pu(inst, C_NN, nn + length, gate)
                pu(inst, C_NPREV, nprev, gate)
            elif kind == K_WPHASE:
                incs, freq = wphase_incs(si_, s, length)
                wphase_finish(si_, s, scan32(incs), freq, length, gate)
            elif kind == K_WRUN:
                wrun_rows([si_], [(length, gate)], wave)
            elif kind == K_WRUN_SELF:
                reset = (gi(inst, C_WRESET) != 0) & (length > 0)
                out, npp, nps, nfb = tdsp.wosc_selfmod_scan(
                    piluts[wave], wave, rdbuf(si_, a), rdbuf(si_, b),
                    gu(inst, C_WPPH), gf(inst, C_WPS), gf(inst, C_WFB),
                    reset, length, plain)
                pf(inst, C_WFB, nfb, gate)
                wrbuf(si_, dst, out)
                wosc_state(inst, npp, nps, (length, gate))
            elif kind == K_RCYCLE:
                incs, freq = rcycle_incs(si_, s, length)
                rcycle_finish(si_, s, scan64(incs), incs, freq, length,
                              gate)
            elif kind == K_RRUN:
                rline, func, level, alpha, oflags, _r2x = ras
                av, bv = tdsp.rasg_map(func, level, alpha, oflags,
                                       rdbuf(si_, a))
                wrbuf(si_, dst, tdsp.rasg_shape(rline, oflags,
                                                rdbuf(si_, dst), av, bv))
            elif kind == K_RRUN_SELF:
                rline, func, level, alpha, oflags, _r2x = ras
                out, nps, nfb = tdsp.rasg_selfmod_scan(
                    func, rline, level, alpha, oflags, rdbuf(si_, dst),
                    rdbuf(si_, a), rdbuf(si_, b), gf(inst, C_RPS),
                    gf(inst, C_RFB), length, plain)
                pf(inst, C_RPS, nps, gate)
                pf(inst, C_RFB, nfb, gate)
                wrbuf(si_, dst, out)
            elif kind == K_MIX:
                src = rdbuf(si_, a)
                amp = rdbuf(si_, b)
                zero = torch.zeros(B, dtype=F32, device=dev)
                prev = rdbuf(si_, dst, zero) if layer else zero
                if wave_env:
                    s_amp = amp * 0.5
                    sv = src * s_amp + torch.abs(s_amp)
                    new = prev * sv if layer else sv
                else:
                    new = prev + src * amp if layer else src * amp
                wrbuf(si_, dst, torch.where(mask, new,
                                            prev if layer else zf))
            elif kind == K_ZERO:
                wrbuf(si_, dst, torch.zeros(B, dtype=F32, device=dev))
            elif kind == K_VMIX:
                pan = rdbuf(si_, dst)
                sv = rdbuf(si_, a) * amp_scale
                sr = sv * pan
                mgate = mask & gate
                mixl = mixl + torch.where(mgate, sv - sr, zf)
                mixr = mixr + torch.where(mgate, sv + sr, zf)
            skip_lines(s, length, gate)

        for group in exec_plan:
            kind = group[0]
            sis = group[-1]
            if kind == 'stages':
                for si_ in sis:
                    exec_stage(si_)
                continue
            lgs = [stage_lg(si_, stage_sig[si_]) for si_ in sis]
            if kind == 'line':
                run_lines(sis, lgs)
            elif kind == 'wphase':
                ifs = [wphase_incs(si_, stage_sig[si_], lg[0])
                       for si_, lg in zip(sis, lgs)]
                runs = scan_rows(torch.stack([inc for inc, _ in ifs]),
                                 32)
                for k, si_ in enumerate(sis):
                    wphase_finish(si_, stage_sig[si_], runs[k],
                                  ifs[k][1], lgs[k][0], lgs[k][1])
            elif kind == 'rcycle':
                ifs = [rcycle_incs(si_, stage_sig[si_], lg[0])
                       for si_, lg in zip(sis, lgs)]
                csums = scan_rows(torch.stack([inc for inc, _ in ifs]),
                                  64)
                for k, si_ in enumerate(sis):
                    rcycle_finish(si_, stage_sig[si_], csums[k],
                                  ifs[k][0], ifs[k][1], lgs[k][0],
                                  lgs[k][1])
            elif kind == 'wrun':
                wave = group[1]
                cells = torch.cat([tdsp.wosc_cells(
                    rdbuf(si_, stage_sig[si_][3])) for si_ in sis])
                wrun_rows(sis, lgs, wave,
                          taps2=taps_of(piluts[wave], cells))

        # write back the packed rows (only the last instance per op)
        if n_insts:
            sf, si = st['sf'].clone(), st['si'].clone()
            for ups, rows, dtype in ((fvals, fi, F32), (ivals, ii, I64)):
                if not ups:
                    continue
                keys = tuple(ups)
                ix = cache.get(keys)
                if ix is None:
                    ix = cache[keys] = tuple(
                        torch.tensor(x, dtype=I64, device=dev)
                        for x in zip(*keys))
                rows = rows.clone()
                rows.index_put_(ix, torch.stack([ups[k] for k in keys])
                                .to(dtype))
                if dtype == F32:
                    fi = rows
                else:
                    ii = rows
            sel = cache['sel']
            ops_sel = inst_op[sel]
            sf[ops_sel] = fi[sel]
            si[ops_sel] = i32(ii[sel] & M32)
            st = dict(st, sf=sf, si=si)
        if voices:
            vs = cache['voices']
            dec = torch.stack([torch.where(vgate[v], vlen[v], 0)
                               for v in voices])
            vd = st['vdur'].clone()
            vd[vs] = (vdur[vs] - dec).to(vd.dtype)
            st = dict(st, vdur=vd)
        return st, torch.stack([mixl, mixr], dim=-1)

    def epoch_fn(st, blk_len, blk_rec_lo, blk_rec_hi, blk_inst_op, recs):
        dev = st['sf'].device
        idx = torch.arange(B, device=dev, dtype=I64)
        inst_ops = torch.from_numpy(
            np.asarray(blk_inst_op, np.int64)).to(dev)
        cache = {'sel': torch.tensor(scatter_list, dtype=I64, device=dev),
                 'voices': torch.tensor(voices, dtype=I64, device=dev)}
        for k in range(len(blk_len)):
            rlo, rhi = int(blk_rec_lo[k]), int(blk_rec_hi[k])
            # most blocks carry no events; skip the record machinery
            if rhi > rlo:
                st = apply_records(st, rlo, rhi, recs)
            st, out = step(st, int(blk_len[k]), inst_ops[k], idx, cache)
            yield st, out

    return epoch_fn


class SeqEpoch:
    """One epoch on the sequential-scan engine, with the stream
    interface of a flat segment (``lo``, ``nb``, ``B``, ``stream``,
    ``run``) so the generator treats both alike."""

    def __init__(self, plan, ep, srate, piluts, plain=False):
        self.plan = plan
        self.ep = ep
        self.lo = 0
        self.nb = len(ep.blk_len)
        self.B = ep.block
        self.fn = build_epoch_fn(
            ep.sig, len(ep.instances), ep.block, plan.amp_scale,
            tuple(i.parent for i in ep.instances),
            tuple(s.voice for s in ep.stages), srate, piluts, plain)

    def stream(self, st):
        """Yield ('out', (k, B, 2) f32, k) for groups of blocks in order,
        then ('st', st', 0)."""
        ep = self.ep
        outs = []
        for st, out in self.fn(st, ep.blk_len, ep.blk_rec_lo,
                               ep.blk_rec_hi, ep.blk_inst_op,
                               self.plan.rec_arrays):
            outs.append(out)
            if len(outs) == STREAM_GROUP:
                yield 'out', torch.stack(outs), len(outs)
                outs = []
        if outs:
            yield 'out', torch.stack(outs), len(outs)
        yield 'st', st, 0

    def run(self, st):
        """Render the whole epoch; returns (st', (nb, B, 2) f32)."""
        pieces = []
        for kind, val, _nv in self.stream(st):
            if kind == 'out':
                pieces.append(val)
            else:
                st = val
        return st, torch.cat(pieces)


class TorchGenerator:
    """Generator-compatible renderer on one torch device.

    ``plain=True`` renders with the plain PyTorch versions of the
    hand-written kernels on any device: the reference that the kernel
    path is held against. ``flat=False`` renders every epoch on the
    sequential-scan engine (as ``SAUGNS_TPU_FLAT=0`` does for
    ``JaxGenerator``); by default only the epochs that ``HostSim``
    cannot bake do. ``piluts`` (a (12, 2048) float32 tensor) and
    ``state`` (the initial packed state) replace the port's own, so a
    test can feed both renderers identical inputs (see convert.py)."""

    def __init__(self, prg: P.Program, srate: int, device=None,
                 block: int = BLOCK, plain: bool = False,
                 piluts=None, state=None, flat: bool = True):
        self.device = resolve_device(device)
        self.prg = prg
        self.srate = srate
        self.plain = plain
        self._tables = piluts
        self._state0 = state
        self.plan = RenderPlan(prg, srate, block)
        self._sim = HostSim(self.plan) if flat else None
        n = len(self.plan.epochs)
        self._flat = [None] * n
        self._seq = [None] * n
        self._rendered = None

    def _piluts(self):
        if self._tables is None:
            self._tables = tdsp.wave_tables(self.device)[1]
        return self._tables

    def sequential(self, ei):
        """Whether epoch ``ei`` renders on the sequential-scan engine."""
        return self._sim is None or not self._sim.bakes[ei].eligible

    def _flat_epoch(self, ei):
        """Flat segment renderers of epoch ``ei`` (empty for an epoch on
        the sequential engine)."""
        if self._flat[ei] is None:
            if self.sequential(ei):
                self._flat[ei] = []
                return self._flat[ei]
            ep = self.plan.epochs[ei]
            bake = self._sim.bakes[ei]
            self._flat[ei] = [
                FlatSegment(self.plan, ep, bake, seg, self.srate,
                            self.device, self._piluts(), plain=self.plain)
                for seg in bake.segments]
        return self._flat[ei]

    def _renderers(self, ei):
        """Epoch ``ei``'s renderers in timeline order: its flat
        segments, or one SeqEpoch."""
        if not self.sequential(ei):
            return self._flat_epoch(ei)
        if self._seq[ei] is None:
            self._seq[ei] = [SeqEpoch(self.plan, self.plan.epochs[ei],
                                      self.srate, self._piluts(),
                                      self.plain)]
        return self._seq[ei]

    def _initial_state(self):
        if self._state0 is not None:
            return dict(self._state0)
        return make_state(self.plan, self.device)

    def render_device(self):
        """Run the full render; returns the per-segment int16 blocks
        (n_blocks, B, 2) as device tensors, in timeline order."""
        st = self._initial_state()
        pieces = []
        for ei in range(len(self.plan.epochs)):
            for seg in self._renderers(ei):
                st, outs = seg.run(st)
                pieces.append(_to_i16_device(outs))
        return pieces

    def render_checksum(self):
        """Render and return an on-device scalar checksum of the
        output (nothing fetched): the muted (``-m``) render."""
        return sum(p.to(torch.int64).sum() for p in self.render_device())

    def assemble(self, pieces):
        """Host (signal_end, 2) int16 timeline from render_device()
        output: trims per-block padding and restores leading-gap
        silence."""
        out = np.zeros((self.plan.signal_end, 2), np.int16)
        pos = 0
        it = iter(pieces)
        for ei, ep in enumerate(self.plan.epochs):
            if ep.start > pos:
                pos = int(ep.start)  # leading gap stays silent
            for seg in self._renderers(ei):
                arr = next(it).cpu().numpy()
                for k in range(seg.lo, seg.lo + seg.nb):
                    blen = int(ep.blk_len[k])
                    if blen > 0:
                        out[pos:pos + blen] = arr[k - seg.lo, :blen]
                        pos += blen
        if pos != self.plan.signal_end:
            raise RuntimeError('rendered %d samples of %d'
                               % (pos, self.plan.signal_end))
        return out

    def _stream_i16(self, stereo):
        """Yield host int16 arrays -- (n, 2) stereo or (n,) mono --
        covering the timeline in order, one chunk group at a time. The
        mono downmix happens on the device from the float stereo mix,
        as mix_write_mono does (generator.c:795-805)."""
        st = self._initial_state()
        conv = _to_i16_device if stereo else _to_i16_mono_device
        pos = 0
        for ei, ep in enumerate(self.plan.epochs):
            if ep.start > pos:
                gap = int(ep.start) - pos
                yield np.zeros((gap, 2) if stereo else gap, np.int16)
                pos = int(ep.start)
            for seg in self._renderers(ei):
                bi = int(seg.lo)
                for kind, val, nv in seg.stream(st):
                    if kind == 'st':
                        st = val
                        continue
                    arr = conv(val.reshape(-1, seg.B, 2)[:nv]) \
                        .cpu().numpy()
                    for k in range(nv):
                        blen = int(ep.blk_len[bi + k])
                        if blen > 0:
                            yield arr[k, :blen]
                            pos += blen
                    bi += nv
        if pos != self.plan.signal_end:
            raise RuntimeError('rendered %d samples of %d'
                               % (pos, self.plan.signal_end))

    def run(self, out_i16, buf_len, stereo):
        """sauGenerator_run-compatible chunked delivery."""
        if self._rendered is None:
            self._stream = self._stream_i16(stereo)
            self._pending = None
            self._left = self.plan.signal_end
            self._rendered = (True, stereo)
        elif self._rendered[1] != stereo:
            raise ValueError('stereo flag changed between run() calls')
        out_i16[:] = 0
        n = 0
        while n < buf_len and self._left > 0:
            if self._pending is None or len(self._pending) == 0:
                try:
                    self._pending = next(self._stream)
                except StopIteration:
                    break
            take = min(buf_len - n, len(self._pending))
            part = self._pending[:take]
            if stereo:
                out_i16[n * 2:(n + take) * 2:2] = part[:, 0]
                out_i16[n * 2 + 1:(n + take) * 2:2] = part[:, 1]
            else:
                out_i16[n:n + take] = part
            self._pending = self._pending[take:]
            self._left -= take
            n += take
        if self._left <= 0:
            return False, n
        return True, buf_len
