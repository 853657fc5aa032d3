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

On CUDA every render replays captured graphs (``graphs.Dispatch``): one
per flat segment template and step, one per sequential epoch, the
whole render as one graph where it fits (``_mono``); ``graphs=False``
runs the same bodies op by op, the eager A/B.
"""
from __future__ import annotations

import weakref
from typing import Dict

import numpy as np
import torch

from .. import tracing
from ..dsp.wavetables import get_tables
from ..lang import program as P
from . import aotstore, tdsp
from .flat import (GROUP_OUT_CAP, STREAM_GROUP, FlatSegment, _write_state,
                   run_segments_grouped, with_conv)
from .graphs import Dispatch, Tables
from .hostsim import HostSim
from .plan import (BLOCK, K_CONST1, K_LINE, K_MIX, K_NOISE, K_RANGEMOD,
                   K_RCYCLE, K_RRUN, K_RRUN_SELF, K_VMIX, K_WPHASE,
                   K_WRUN, K_WRUN_SELF, K_ZERO, RenderPlan)
from .state import (C_LEND, C_LFLAGS, C_LPOS, C_LV0, C_LVT, C_NN,
                    C_NPREV, C_PHASE, C_RCPHI, C_RCPLO, C_RFB, C_RPS,
                    C_TIME, C_TINF, C_WFB, C_WPPH, C_WPS, C_WRESET,
                    _to_i16_device, apply_prepared, i32, line_run_vec,
                    line_skip_vec, make_state, prepare_records)

F32 = torch.float32
I64 = torch.int64
M32 = tdsp.M32
BIG_TIME = 0x7fffffff


def resolve_devices(spec=None):
    """The devices to render on, a list of ``torch.device``: ``spec``
    as a comma-separated string (``"cpu,cpu"``, ``"cuda:0,cuda:1"``),
    a device or a list of devices; by default every visible CUDA
    device. A device may repeat: each entry is a shard of its own (the
    counterpart of the JAX package's virtual host devices). Raises
    RuntimeError when CUDA is asked for (or defaulted to) and not
    available; the CPU is used only when asked for."""
    if spec is None:
        _need_cuda()
        return [torch.device('cuda', i)
                for i in range(torch.cuda.device_count())]
    if isinstance(spec, str):
        spec = [s.strip() for s in spec.split(',') if s.strip()]
    elif isinstance(spec, torch.device):
        spec = [spec]
    devs = [torch.device(d) for d in spec]
    if not devs:
        raise ValueError('resolve_devices: no device given')
    for d in devs:
        if d.type == 'cuda':
            _need_cuda()
            if d.index is not None \
                    and d.index >= torch.cuda.device_count():
                raise RuntimeError('saugns_tpu_torch: %s is not visible '
                                   '(%d CUDA devices)'
                                   % (d, torch.cuda.device_count()))
    return devs


def _need_cuda():
    if not torch.cuda.is_available():
        raise RuntimeError(
            'saugns_tpu_torch renders on CUDA, and no CUDA device is '
            'available; pass device="cpu" (CLI: '
            'SAUGNS_TPU_TORCH_DEVICE=cpu) to render on the CPU')


def resolve_device(device=None):
    """The device to render on: ``device`` when given (the first entry
    of a list, see resolve_devices), else CUDA."""
    return resolve_devices('cuda' if device is None else device)[0]


_INITIALISED = set()


def init_process(device):
    """The process's one-time work for renders on ``device`` that the
    port knows of, at its first call, in a ``port.init`` span of its
    own, so that the first render's spans (``store.lookup``,
    ``plan.upload``) do not hold it: the wave tables' host build, the
    compiled-render store's hashes of the port's code and tables (where
    the store is on) and, on CUDA, the device's context, made by a
    first copy each way."""
    device = torch.device(device)
    if device in _INITIALISED:
        return
    with tracing.span('port.init'):
        get_tables()
        if aotstore.enabled():
            aotstore.code_hash()
            aotstore.tables_field()
        if device.type == 'cuda':
            torch.ones(1).to(device).cpu()
    _INITIALISED.add(device)


def device_setup(device, state, plain=False, graphs=True, piluts=None):
    """The set-up every renderer makes once a device: the kernel library
    (on CUDA, unless ``plain``), the process's one-time work
    (init_process), the wave tables (``piluts`` where the caller has
    them) and the Dispatch whose initial state is ``state``'s sf, si
    and vdur. The capture rule: the bodies run on static buffers
    unless ``plain``, and on CUDA they are captured as graphs unless
    ``graphs=False`` (the eager A/B). Returns (piluts, Dispatch). Span:
    ``plan.upload``, the tables and the Dispatch."""
    cuda = device.type == 'cuda'
    if cuda and not plain:
        from .. import kernels
        kernels.build()
    init_process(device)
    with tracing.span('plan.upload'):
        if piluts is None:
            piluts = tdsp.wave_tables(device)[1]
        static = not plain and (graphs or not cuda)
        disp = Dispatch(device, static, static and cuda,
                        tuple(state[k].to(device).contiguous()
                              for k in ('sf', 'si', 'vdur')))
    return piluts, disp


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
    """The sequential-scan block step of one epoch schedule (the JAX
    engine's build_epoch_fn, engine.py:625, whose lax.scan body it is;
    SeqEpoch loops it over the blocks). ``sig`` = (stage entries,
    inst_src, scatter_list) from the planner; ``piluts`` the (12, 2048)
    tables on the render device; ``plain`` runs the kernels' plain
    versions.

    Returns (step, statics): step(st, blen, inst_op, idx, cache) -> (st,
    (B, 2) float32 mix) renders one block; ``blen`` (the block's length)
    and ``inst_op`` (its instances' operators) are device tensors, and
    ``cache`` holds the device index tensors of ``statics`` (the packed
    rows written back, ``sel``, the voices, ``voices``, and the cells
    each block writes back, ``ixf`` and ``ixi``: the schedule's alone),
    so a step reads no host value and uploads nothing. Per-op scalar
    state is gathered into packed rows once per block and scattered
    back once."""
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
    wb_f, wb_i = _writeback_cells(stage_sig, exec_plan, last_stage,
                                  src_row)

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
        vlen = {v: torch.minimum(vdur[v], blen) for v in voices}
        vgate = {v: (vdur[v] > 0) & (blen > 0) for v in voices}

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
            for ups, rows, dtype, name, want in (
                    (fvals, fi, F32, 'ixf', wb_f),
                    (ivals, ii, I64, 'ixi', wb_i)):
                keys = tuple(sorted(ups))
                if keys != want:
                    raise RuntimeError(
                        'sequential engine: a block wrote back %s, the '
                        'schedule %s' % (keys, want))
                if not keys:
                    continue
                rows = rows.clone()
                rows.index_put_(cache[name],
                                torch.stack([ups[k] for k in keys])
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

    return step, {'sel': scatter_list, 'voices': tuple(voices),
                  'ixf': wb_f, 'ixi': wb_i}


def _writeback_cells(stage_sig, exec_plan, last_stage, src_row):
    """The (packed row, column) cells of the float and of the integer
    state that one block step writes back: those its pf/pi/pu calls
    name, which the schedule alone decides. Sorted, as the step keys
    its write-back."""
    fk, ik = set(), set()

    def line(inst, slot):
        r = src_row[inst]
        fk.add((r, C_LV0 + slot))
        ik.update({(r, C_LPOS + slot), (r, C_LFLAGS + slot),
                   (r, C_LEND + slot)})

    def wosc(r):
        ik.update({(r, C_WPPH), (r, C_WRESET)})
        fk.add((r, C_WPS))

    for inst in last_stage:
        ik.add((src_row[inst], C_TIME))
    for group in exec_plan:
        for si_ in group[-1]:
            s = stage_sig[si_]
            kind, inst = s[0], s[1]
            r = src_row[inst] if src_row else None
            if group[0] == 'wphase':
                ik.add((r, C_PHASE))
                continue
            if group[0] == 'rcycle':
                ik.update({(r, C_RCPLO), (r, C_RCPHI)})
                continue
            if group[0] == 'wrun':
                wosc(r)
                continue
            # one stage, or a same-level K_LINE group: the stage's own
            # cells, then the line slots it skips
            if kind == K_LINE:
                line(inst, s[6])
            elif kind == K_NOISE:
                ik.update({(r, C_NN), (r, C_NPREV)})
            elif kind == K_WPHASE:
                ik.add((r, C_PHASE))
            elif kind in (K_WRUN, K_WRUN_SELF):
                wosc(r)
                if kind == K_WRUN_SELF:
                    fk.add((r, C_WFB))
            elif kind == K_RCYCLE:
                ik.update({(r, C_RCPLO), (r, C_RCPHI)})
            elif kind == K_RRUN_SELF:
                fk.update({(r, C_RPS), (r, C_RFB)})
            for slot in s[9]:
                line(inst, slot)
    return tuple(sorted(fk)), tuple(sorted(ik))


class SeqEpoch:
    """One epoch on the sequential-scan engine, with the interface of a
    flat segment (``lo``, ``nb``, ``B``, ``key``, ``prepare``,
    ``tables``, ``stream``) so the generator treats both alike.

    Its block loop is one body over the epoch's tables: the block
    lengths and instance operators, and each block's records, prepared
    on the host once (``state.prepare_records``). ``key`` is the JAX
    engine's epoch key (``_epoch_fns``, engine.py:1130-1133 there) plus
    the blocks' record structure and the tables' layout."""

    def __init__(self, plan, ep, srate, piluts, plain=False):
        self.plan = plan
        self.ep = ep
        self.srate = srate
        self.piluts = piluts
        self.plain = plain
        self.lo = 0
        self.nb = nb = len(ep.blk_len)
        self.B = ep.block
        inst_parent = tuple(i.parent for i in ep.instances)
        stage_voices = tuple(s.voice for s in ep.stages)
        self._build_step()
        self.device = piluts.device
        tabs = {'blk_len': np.asarray(ep.blk_len, np.int64),
                'inst_op': np.asarray(ep.blk_inst_op, np.int64)}
        structs = []
        for k in range(nb):
            rlo, rhi = int(ep.blk_rec_lo[k]), int(ep.blk_rec_hi[k])
            struct = None
            # most blocks carry no events; skip the record machinery
            if rhi > rlo:
                struct, t = prepare_records(rlo, rhi, plan.rec_arrays)
                tabs.update(('b%d_%s' % (k, n), v) for n, v in t.items())
            structs.append(struct)
        self.rec_structs = tuple(structs)
        self.tabs = Tables(tabs)
        self.key = (ep.sig, len(ep.stages), len(ep.instances),
                    plan.n_bufs, ep.block, plan.amp_scale, inst_parent,
                    stage_voices, srate, nb, plan.n_ops, plan.n_voices,
                    plan.n_recs, self.rec_structs, self.tabs.layout)
        self.cache = None

    def _build_step(self):
        ep = self.ep
        self.step, self.statics = build_epoch_fn(
            ep.sig, len(ep.instances), ep.block, self.plan.amp_scale,
            tuple(i.parent for i in ep.instances),
            tuple(s.voice for s in ep.stages), self.srate, self.piluts,
            self.plain)

    def __getstate__(self):
        # what the compiled-render store keeps (render/aotstore.py): the
        # host tables, key and record structure; the block step is a
        # closure, built again on load
        return {k: v for k, v in self.__dict__.items()
                if k not in ('step', 'statics', 'cache')}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.cache = None
        self._build_step()

    def prepare(self):
        """Upload the epoch's tables and the schedule's index tensors
        (once); no block step uploads anything after this."""
        self.tabs.upload(self.device)
        if self.cache is None:
            dev = self.device

            def ix(cells):
                return tuple(torch.tensor(x, dtype=I64, device=dev)
                             for x in zip(*cells)) if cells else None
            st = self.statics
            self.cache = {
                'sel': torch.tensor(st['sel'], dtype=I64, device=dev),
                'voices': torch.tensor(st['voices'], dtype=I64,
                                       device=dev),
                'ixf': ix(st['ixf']), 'ixi': ix(st['ixi'])}

    def _run(self, st, tabs):
        """The whole epoch on tables ``tabs`` (name -> tensor): returns
        (st', (nb, B, 2) f32)."""
        recs = [{} for _ in range(self.nb)]
        for name, v in tabs.items():
            if name[0] == 'b' and name[1].isdigit():
                k, rest = name[1:].split('_', 1)
                recs[int(k)][rest] = v
        idx = torch.arange(self.B, device=st['sf'].device, dtype=I64)
        outs = []
        for k in range(self.nb):
            st = apply_prepared(st, self.rec_structs[k], recs[k])
            st, out = self.step(st, tabs['blk_len'][k],
                                tabs['inst_op'][k], idx, self.cache)
            outs.append(out)
        return st, torch.stack(outs)

    def body(self, conv):
        """Body of the epoch's graph: (sf, si, vdur, table buffers) ->
        the (nb, B, 2) output, converted (flat.with_conv); the new state
        is written into sf, si and vdur."""
        def body(sf, si, vdur, *bufs):
            st, out = self._run({'sf': sf, 'si': si, 'vdur': vdur},
                                self.tabs.views(bufs))
            _write_state((sf, si, vdur), st)
            return out
        return with_conv(body, conv)

    def tables(self):
        return tuple(self.tabs.bufs)

    def render(self, disp, conv):
        """The epoch through ``disp`` on its state buffers: the graph's
        (nb, B, ...) output (static: consume it before the next)."""
        return disp.run(('seq', self.key, conv),
                        disp.template(self).body(conv), disp.state(conv),
                        self.tables())

    def stream(self, disp, conv):
        """Yield ((k, B, ...) converted output, k) for groups of
        STREAM_GROUP blocks in order, from one replay of the epoch's
        graph."""
        out = self.render(disp, conv)
        for k in range(0, self.nb, STREAM_GROUP):
            part = out[k:k + STREAM_GROUP]
            yield part, part.shape[0]


class TorchGenerator:
    """Generator-compatible renderer on one torch device.

    ``plain=True`` renders with the plain PyTorch versions of the
    hand-written kernels on any device: the reference that the kernel
    path is held against. ``flat=False`` renders every epoch on the
    sequential-scan engine (as ``SAUGNS_TPU_FLAT=0`` does for
    ``JaxGenerator``); by default only the epochs that ``HostSim``
    cannot bake do. ``piluts`` (a (12, 2048) float32 tensor) and
    ``state`` (the initial packed state) replace the port's own, so a
    test can feed both renderers identical inputs (see convert.py).

    ``plan`` is the program's RenderPlan and ``sim`` its HostSim (None
    where the store served the render, or with ``flat=False``).

    ``graphs`` (on CUDA, without ``plain``): every render replays
    captured CUDA graphs (``graphs.Dispatch``), as ``JaxGenerator``
    runs compiled dispatches; ``graphs=False`` runs the same bodies op
    by op (the counterpart of ``SAUGNS_TPU_MONO=0``: no one-graph
    render either). On the CPU the bodies run directly on the graphs'
    static buffers whatever ``graphs`` says; ``plain=True`` runs them
    op by op."""

    def __init__(self, prg: P.Program, srate: int, device=None,
                 block: int = BLOCK, plain: bool = False,
                 piluts=None, state=None, flat: bool = True,
                 graphs: bool = True):
        self.device = resolve_device(device)
        init_process(self.device)
        self.prg = prg
        self.srate = srate
        self.block = block
        self.plain = plain
        self.graphs = graphs
        self._want_flat = flat
        self._tables = piluts
        self._state0 = state
        self._rendered = None
        self._disp = None
        self._mono_fn = None
        # the compiled-render store (render/aotstore.py): this
        # generator's key, whether an artifact of it exists, where its
        # prepared render came from ('baked', 'disk' or 'memory'), and
        # the finalizer that hands that render to the memory tier when
        # the generator is dropped after a render that completed
        self.source = 'baked'
        self._key = None
        self._stored = False
        self._fin = None
        if aotstore.enabled():
            with tracing.span('store.lookup'):
                self._fields = aotstore.key_fields(
                    prg, srate, piluts=piluts, state=state,
                    args={'flat': flat, 'plain': plain, 'graphs': graphs,
                          'block': block}, device=self.device)
                self._key = aotstore.key_of(self._fields)
                live = aotstore.checkout(self._live_key())
            if live is not None:
                self.source = 'memory'
                self._stored = True
                self.sim = None
                self.plan, self._eligible = live.plan, live.eligible
                self._flat, self._seq = live.flat, live.seq
                self._disp, self._mono_fn = live.disp, live.mono_fn
                self._disp.reset_stats()
                return
        self._host_products()

    def _live_key(self):
        """The memory tier's key: the store's key and the device (a
        graph is never handed to another device)."""
        dev = self.device
        if dev.type == 'cuda' and dev.index is None:
            dev = torch.device('cuda', torch.cuda.current_device())
        return (self._key, str(dev))

    def _persistent(self):
        """The objects a stored render names and the loading generator
        supplies: its program, wave tables and device."""
        return {'prg': self.prg, 'piluts': self._piluts(),
                'device': self.device}

    def _host_products(self):
        """The plan, which epochs render flat, and the renderers: from
        the store's artifact of this generator's key where there is
        one, else computed (RenderPlan and HostSim now, each renderer's
        tables when it is first needed)."""
        art = None
        if self._key is not None:
            with tracing.span('store.lookup'):
                art = aotstore.load(self._key, self.device.type,
                                    self._fields, self._persistent)
        if art is not None:
            self.source = 'disk'
            self._stored = True
            self.sim = None
            self.plan, self._eligible = art['plan'], art['eligible']
            self._flat, self._seq = art['flat'], art['seq']
            return
        self.source = 'baked'
        with tracing.span('plan.build'):
            self.plan = RenderPlan(self.prg, self.srate, self.block)
            self.sim = HostSim(self.plan) if self._want_flat else None
        n = len(self.plan.epochs)
        self._eligible = tuple(b.eligible for b in self.sim.bakes) \
            if self.sim is not None else (False,) * n
        self._flat = [None] * n
        self._seq = [None] * n

    def _piluts(self):
        if self._tables is None:
            self._tables = tdsp.wave_tables(self.device)[1]
        return self._tables

    def sequential(self, ei):
        """Whether epoch ``ei`` renders on the sequential-scan engine."""
        return not self._eligible[ei]

    def _flat_epoch(self, ei):
        """Flat segment renderers of epoch ``ei`` (empty for an epoch on
        the sequential engine)."""
        if self._flat[ei] is None:
            if self.sequential(ei):
                self._flat[ei] = []
                return self._flat[ei]
            ep = self.plan.epochs[ei]
            bake = self.sim.bakes[ei]
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

    def prepare(self):
        """Everything a render needs before its device work, once per
        generator (the counterpart of ``JaxGenerator._upload``): the
        kernel library, the wave tables, the initial state and the state
        buffers, and every renderer's tables and index tensors. After
        it a render uploads nothing and reads no device value on the
        host, so its bodies can be captured. Returns the Dispatch (a
        generator served from the store's memory tier has it from its
        constructor). Spans: ``plan.build`` the renderers' construction
        with their host tables, ``plan.upload`` the rest."""
        if self._disp is not None:
            return self._disp
        with tracing.span('plan.upload'):
            st0 = self._initial_state()
        self._tables, disp = device_setup(self.device, st0, self.plain,
                                          self.graphs, self._tables)
        with tracing.span('plan.build'):
            rends = [r for ei in range(len(self.plan.epochs))
                     for r in self._renderers(ei)]
        with tracing.span('plan.upload'):
            for r in rends:
                r.prepare()
        self._disp = disp
        return disp

    def _start(self):
        """prepare() for a render: until it completes, the prepared
        render does not go to the memory tier."""
        if self._fin is not None:
            self._fin.detach()
            self._fin = None
        return self.prepare()

    def _completed(self):
        """A render completed: a stored key's prepared render goes to
        the memory tier when this generator is dropped."""
        if not self._stored or self._fin is not None \
                or not aotstore.enabled():
            return
        e = _Prepared()
        e.plan, e.eligible, e.flat, e.seq = (self.plan, self._eligible,
                                             self._flat, self._seq)
        e.disp, e.mono_fn = self._disp, self._mono_fn
        self._fin = weakref.finalize(self, aotstore.deposit,
                                     self._live_key(), e)
        self._fin.atexit = False

    def save_export(self):
        """Store this generator's host products (render/aotstore.py) in
        the user directory, preparing it first if needed; returns the
        artifact's path, or None when the store is off or the generator
        was itself served from the store. The counterpart of
        ``JaxGenerator.save_export``."""
        if self._key is None or not aotstore.enabled() \
                or self.source != 'baked':
            return None
        self.prepare()
        art = {'plan': self.plan, 'eligible': self._eligible,
               'flat': self._flat, 'seq': self._seq}
        path = aotstore.save(self._key, self.device.type, art,
                             self._fields, self._persistent())
        self._stored = True
        return path

    def graph_stats(self):
        """Counts of the generator's graphs: keys, captures, replays,
        graph nodes (as libcuda counts them at capture), the seconds
        spent capturing and instantiating and, of those, in the bodies'
        Python (``body_s``), and ``source``: where its prepared render
        came from ('baked', 'disk' or 'memory', whose graphs were
        captured before it: its counts are its own). On the CPU a
        capture is a key's first use and a replay a run of its body."""
        return dict(self.prepare().stats(), source=self.source)

    def _items(self):
        """The renderers in timeline order as ('seq', SeqEpoch) and
        ('flat', [FlatSegment, ...]) items, consecutive flat epochs'
        segments in one list (the JAX generator's render_device walk)."""
        items = []
        segs = []
        for ei in range(len(self.plan.epochs)):
            if self.sequential(ei):
                if segs:
                    items.append(('flat', segs))
                    segs = []
                items.append(('seq', self._renderers(ei)[0]))
            else:
                segs = segs + self._flat_epoch(ei)
        if segs:
            items.append(('flat', segs))
        return items

    def _mono(self):
        """The whole render as one body (JAX's _mono): sequential
        epochs, flat segments and the int16 conversion; None when the
        float32 output exceeds GROUP_OUT_CAP or the generator runs op
        by op. Returns (body(cksum) maker, bound tensors)."""
        disp = self.prepare()
        if not disp.static:
            return None
        if self._mono_fn is not None:
            return self._mono_fn or None
        rends = [r for ei in range(len(self.plan.epochs))
                 for r in self._renderers(ei)]
        total = sum(r.nch * r.nc * r.B * 8 if isinstance(r, FlatSegment)
                    else r.nb * r.B * 8 for r in rends)
        if total > GROUP_OUT_CAP:
            self._mono_fn = False
            return None
        counts = [len(r.tables()) for r in rends]

        def make(cksum):
            def body(sf0, si0, vdur0, *bufs):
                st = {'sf': sf0, 'si': si0, 'vdur': vdur0}
                pieces = []
                pos = 0
                for r, n in zip(rends, counts):
                    rb = bufs[pos:pos + n]
                    pos += n
                    if isinstance(r, FlatSegment):
                        nd = len(r.dyn.host)
                        xs, p = [], nd
                        for t in r.xs:
                            xs.append(t.views(rb[p:p + len(t.host)]))
                            p += len(t.host)
                        st, out = r._fused(st, r.dyn.views(rb[:nd]), xs)
                        out = out[:r.nb]
                    else:
                        st, out = r._run(st, r.tabs.views(rb))
                    pieces.append(_to_i16_device(out))
                if cksum:
                    return device_checksum(pieces)
                return tuple(pieces)
            return body
        bound = disp.st0 + tuple(b for r in rends for b in r.tables())
        self._mono_fn = (make, bound)
        return self._mono_fn

    def _grouped(self, conv):
        """Render renderer by renderer on the state buffers, flat
        segments in groups (flat.run_segments_grouped), yielding each
        one's (nb, B, ...) output converted by ``conv``."""
        disp = self._disp
        disp.reset()
        for kind, x in self._items():
            if kind == 'seq':
                yield x.render(disp, conv)
            else:
                for _seg, out in run_segments_grouped(x, disp, conv):
                    yield out

    @tracing.traced('render.generator')
    def render_device(self):
        """Run the full render; returns the per-segment int16 blocks
        (n_blocks, B, 2) as device tensors, in timeline order: one
        graph replay where the render fits GROUP_OUT_CAP, else one per
        sequential epoch and flat segment. The pieces are the caller's
        own (clones of the graphs' outputs)."""
        disp = self._start()
        mono = self._mono()
        if mono is not None:
            make, bound = mono
            out = [p.clone() for p in disp.run(('mono', False),
                                               make(False), bound)]
        else:
            out = [p.clone() if disp.static else p
                   for p in self._grouped('i16')]
        self._completed()
        return out

    @tracing.traced('render.generator')
    def render_checksum(self):
        """Render and return an on-device scalar checksum of the
        output (nothing fetched): the muted (``-m``) render. On the
        graph path the checksum is part of the graphs."""
        disp = self._start()
        mono = self._mono()
        if mono is not None:
            make, bound = mono
            out = disp.run(('mono', True), make(True), bound).clone()
        elif not disp.static:
            out = device_checksum(self.render_device())
        else:
            for _ in self._grouped('cksum'):
                pass
            out = disp.acc.clone()
        self._completed()
        return out

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
                arr = _host(next(it))
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
        covering the timeline in order, one chunk group at a time, each
        from a graph replay whose last step is the int16 conversion.
        The mono downmix happens on the device from the float stereo
        mix, as mix_write_mono does (generator.c:795-805)."""
        disp = self._start()
        conv = 'i16' if stereo else 'mono'
        disp.reset()
        pos = 0
        for ei, ep in enumerate(self.plan.epochs):
            if ep.start > pos:
                gap = int(ep.start) - pos
                yield np.zeros((gap, 2) if stereo else gap, np.int16)
                pos = int(ep.start)
            for seg in self._renderers(ei):
                bi = int(seg.lo)
                for val, nv in seg.stream(disp, conv):
                    arr = _host(val[:nv])
                    for k in range(nv):
                        blen = int(ep.blk_len[bi + k])
                        if blen > 0:
                            yield arr[k, :blen]
                            pos += blen
                    bi += nv
        if pos != self.plan.signal_end:
            raise RuntimeError('rendered %d samples of %d'
                               % (pos, self.plan.signal_end))
        self._completed()

    def run(self, out_i16, buf_len, stereo):
        """sauGenerator_run-compatible chunked delivery. The span
        ``render.generator`` lasts from the first call to the last sample
        out, open only inside each call."""
        if self._rendered is None:
            self._stream = self._stream_i16(stereo)
            self._pending = None
            self._left = self.plan.signal_end
            self._rendered = (True, stereo)
            self._span = tracing.span('render.generator').open()
        elif self._rendered[1] != stereo:
            raise ValueError('stereo flag changed between run() calls')
        else:
            self._span.resume()
        try:
            more, n = self._deliver(out_i16, buf_len, stereo)
        except BaseException:
            self._span.close()
            raise
        if more:
            self._span.suspend()
        else:
            self._span.close()
        return more, n

    def _deliver(self, out_i16, buf_len, stereo):
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
            if n:
                # the last samples went out: the render completed
                self._completed()
            return False, n
        return True, buf_len


class _Prepared:
    """A prepared render as the compiled-render store's memory tier
    keeps it: the plan, which epochs render flat, the renderers (their
    tables uploaded), and the Dispatch with its graphs and the
    one-graph body."""

    __slots__ = ('plan', 'eligible', 'flat', 'seq', 'disp', 'mono_fn')


def _host(t):
    """The host array of a device output (the stream's one sync per
    chunk group), in a ``render.fetch`` span."""
    with tracing.span('render.fetch'):
        return (t if t.device.type == 'cpu' else t.cpu()).numpy()


def device_checksum(pieces):
    """On-device int64 scalar checksum of a list of tensors (not
    fetched): the JAX engine's device_checksum (engine.py:1446), int16
    pieces summed as integers."""
    return sum(p.sum(dtype=torch.int64) if p.dtype == torch.int16
               else p.sum() for p in pieces)


def force_scalars(scalars):
    """Force completion of a list of device scalars with ONE host fetch
    (the JAX engine's force_scalars, engine.py:1464): a muted
    multi-script render syncs once, not once per script."""
    if not scalars:
        return 0.0
    return float(torch.stack([s.to(torch.float32)
                              for s in scalars]).sum())
