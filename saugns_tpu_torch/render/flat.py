"""Flat (time-parallel) segment renderer on tensors.

Counterpart of ``saugns_tpu/render/flat.py``. A segment (a block range
of an epoch with constant operator bindings, baked by ``hostsim``)
renders chunk by chunk: each chunk is an (nc, B) sample grid, and the
epoch's stage schedule runs over it as eager tensor ops. Wave
oscillator phases come from one wrapping u32 prefix sum over the chunk
(kernel 2) or, at constant frequency, from an exact affine ramp; the
oscillator output, its pairing with the previous sample and the
pd == 0 hold come from kernel 1, the carry across a chunk's rows from
the running max of kernel 4. RasG cycle phases are the same in u64
(kernel 3 under a varying frequency); red noise sums with kernel 2.
The self-PM recurrences, the one true per-sample chain, run as
kernels 5 (wave) and 6 (RasG) over the chunk's sample stream.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import tdsp
from .plan import (K_CONST1, K_LINE, K_MIX, K_NOISE, K_RANGEMOD,
                   K_RCYCLE, K_RRUN, K_RRUN_SELF, K_VMIX, K_WPHASE,
                   K_WRUN, K_WRUN_SELF, K_ZERO)
from .state import (C_LEND, C_LFLAGS, C_LPOS, C_LTYPE, C_LV0, C_LVT,
                    C_NN, C_NPREV, C_PHASE, C_RCPHI, C_RCPLO, C_RFB,
                    C_RPS, C_TIME, C_TINF, C_WFB, C_WPPH, C_WPS,
                    C_WRESET, LF_GOAL, LF_SRATIO, apply_records, i32,
                    line_run_vec)

FLAT_CHUNK = 1 << 21   # samples per chunk
STREAM_GROUP = 8       # chunks per streamed group

F32 = torch.float32
I64 = torch.int64
M32 = tdsp.M32

# noise colour indices (P.NOISE_NAMES order)
N_WH, N_GW, N_BW, N_TW, N_RE, N_VI, N_BV = range(7)


def _row_fill(row_vals, row_active, seed, plain=False):
    """Per-row carry fill: out[r] = row_vals at the last active row
    <= r, or ``seed`` if none yet: a running max over the few rows of
    a chunk (lax.cummax in the JAX renderer), kernel 4 on the card."""
    nc = row_vals.shape[0]
    ridx = torch.arange(1, nc + 1, device=row_vals.device,
                        dtype=torch.int32)
    scan = tdsp.scan_max_i32_plain if plain else tdsp.scan_max_i32
    last = scan(torch.where(row_active, ridx, torch.zeros_like(ridx)))
    ext = torch.cat([seed.reshape(1), row_vals])
    return ext[last.to(I64)]


class FlatSegment:
    """Renderer for one eligible segment of an epoch. ``plain=True``
    runs the plain versions of the kernels on any device (the
    reference that the kernel path is held against)."""

    def __init__(self, plan, ep, bake, seg, srate, device, tables,
                 plain=False):
        self.plan = plan
        self.ep = ep
        self.bake = bake
        self.seg = seg
        self.srate = srate
        self.device = device
        self.piluts = tables
        self.plain = plain
        lo, hi = seg.lo, seg.hi
        nb = hi - lo
        B = ep.block
        cap = max(FLAT_CHUNK // B, 1)
        # padded block count, quantized as in the JAX renderer so both
        # cut a segment into the same chunks
        q = 1
        while q * 8 < nb:
            q *= 2
        nb_r = -(-nb // q) * q
        nc = min(cap, nb_r)
        nch = -(-nb_r // nc)
        gch = min(nch, STREAM_GROUP)
        ng = -(-nch // gch)
        gch = -(-nch // ng)
        nch = ng * gch
        self.lo, self.nb, self.B, self.nc, self.nch = lo, nb, B, nc, nch
        self.gch, self.ng = gch, ng
        self.stage_op = tuple(int(x) for x in
                              np.asarray(ep.blk_stage_op[lo]).ravel()) \
            if len(ep.stages) else ()
        self._bake_tables()
        self._dev = None

    # -- host-side chunk table assembly ----------------------------------

    def _bake_tables(self):
        ep, bake, seg = self.ep, self.bake, self.seg
        lo, nb, B, nc, nch = self.lo, self.nb, self.B, self.nc, self.nch
        hi = seg.hi
        pad = nch * nc - nb

        def padb(a, fill=0):
            a = np.asarray(a)[lo:hi]
            if pad == 0:
                return a
            w = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
            return np.pad(a, w, constant_values=fill)

        n_insts = max(len(ep.instances), 1)
        lens = padb(bake.lens if bake.lens is not None
                    else np.zeros((hi, n_insts), np.int32))
        self.t_lens = lens.reshape(nch, nc, -1)
        self.line_sis = [si for si, st_ in enumerate(ep.stages)
                         if st_.kind == K_LINE]
        for key in ('v0', 'vt', 'pos', 'end', 'flags'):
            tab = np.stack([padb(getattr(bake.stages[si], key))
                            for si in self.line_sis]) \
                .reshape(len(self.line_sis), nch, nc) \
                if self.line_sis else None
            setattr(self, 't_l' + key, tab)
        self.noise_sis = [si for si, st_ in enumerate(ep.stages)
                          if st_.kind == K_NOISE]
        # noise counter offsets relative to the segment start (the
        # counter is read from the state at segment entry)
        self.t_noff = np.stack(
            [padb(np.asarray(bake.stages[si].noff, np.int64)
                  - int(bake.stages[si].noff[lo])) & M32
             for si in self.noise_sis]).reshape(
                 len(self.noise_sis), nch, nc) \
            if self.noise_sis else None
        self.noise_total = {
            si: int(np.sum(lens[:, ep.stages[si].inst].astype(np.int64)))
            & M32 for si in self.noise_sis}
        # stateful stages: per-chunk first/last in-range flat index
        # and activity
        self.state_sis = [si for si, st_ in enumerate(ep.stages)
                          if st_.kind in (K_WRUN, K_NOISE, K_WRUN_SELF,
                                          K_RRUN_SELF)]
        k_state = max(len(self.state_sis), 1)
        li_tab = np.zeros((k_state, nch), np.int64)
        fi_tab = np.zeros((k_state, nch), np.int64)
        act_tab = np.zeros((k_state, nch), bool)
        for k, si in enumerate(self.state_sis):
            inst = ep.stages[si].inst
            sl = lens[:, inst].reshape(nch, nc)
            for c in range(nch):
                rows = np.nonzero(sl[c] > 0)[0]
                if len(rows):
                    r = rows[-1]
                    li_tab[k, c] = r * B + sl[c, r] - 1
                    fi_tab[k, c] = rows[0] * B
                    act_tab[k, c] = True
        self.t_last_ir = li_tab
        self.t_first_ir = fi_tab
        self.t_act = act_tab
        self.state_pos = {si: k for k, si in enumerate(self.state_sis)}
        self.line_pos = {si: k for k, si in enumerate(self.line_sis)}
        self.noise_pos = {si: k for k, si in enumerate(self.noise_sis)}
        self.stage_active = {si: bool(np.any(
            lens[:, ep.stages[si].inst] > 0))
            for si in range(len(ep.stages))}
        self._analyze_const_lines()

    def _analyze_const_lines(self):
        """A K_LINE stage whose blocks never carry an active goal holds
        v0 (times its multiplier under STATE_RATIO) for every sample,
        so its output is a per-row scalar; a phase fed by such a
        frequency is an exact affine ramp instead of a prefix sum
        (flat.py:291 of the JAX renderer; same bits)."""
        ep, bake = self.ep, self.bake
        lo, hi = self.seg.lo, self.seg.hi
        const_ids = set()
        const_sis = []
        const_mul = {}
        scalar_freq = {}
        for si, st_ in enumerate(ep.stages):
            if st_.kind == K_LINE:
                bs = bake.stages.get(si)
                flags = np.asarray(bs.flags)[lo:hi] \
                    if bs is not None else None
                needs_mul = flags is not None \
                    and bool(np.any(flags & LF_SRATIO)) and st_.a >= 0
                if flags is not None \
                        and not np.any(flags & LF_GOAL) \
                        and (not needs_mul or st_.a in const_ids):
                    const_ids.add(st_.dst)
                    const_sis.append(si)
                    const_mul[si] = needs_mul
                else:
                    const_ids.discard(st_.dst)
                continue
            if st_.kind in (K_WPHASE, K_RCYCLE):
                scalar_freq[si] = st_.a in const_ids
            # every other stage writes dst (K_RCYCLE also dst + 1)
            const_ids.discard(st_.dst)
            if st_.kind == K_RCYCLE:
                const_ids.discard(st_.dst + 1)
        self.const_sis = tuple(const_sis)
        self.const_mul = tuple(const_mul[si] for si in const_sis)
        self.scalar_freq = tuple(sorted(
            si for si, ok in scalar_freq.items() if ok))

    def _upload(self):
        """One-time device copy of the baked tables."""
        if self._dev is not None:
            return self._dev
        dev = self.device

        def t(a, dtype=None):
            x = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            return x if dtype is None else x.to(dtype)

        d = {'lens': t(self.t_lens, I64),
             'first_ir': t(self.t_first_ir, I64)}
        if self.line_sis:
            for key in ('v0', 'vt'):
                d['l' + key] = t(getattr(self, 't_l' + key), F32)
            for key in ('pos', 'end', 'flags'):
                d['l' + key] = t(getattr(self, 't_l' + key), I64)
        if self.noise_sis:
            d['noff'] = t(self.t_noff, I64)
        seg = self.seg
        d['end'] = {k: t(getattr(seg, 'end_' + k))
                    for k in ('lv0', 'lvt', 'lpos', 'lend', 'ltype',
                              'lflags', 'time', 'tinf', 'vdur')}
        self._dev = d
        return d

    # -- segment steps -----------------------------------------------------

    def _init(self, st):
        ep = self.ep
        rec_lo = int(ep.blk_rec_lo[self.lo])
        rec_hi = int(ep.blk_rec_hi[self.lo])
        if rec_hi > rec_lo:
            st = apply_records(st, rec_lo, rec_hi, self.plan.rec_arrays,
                               device_cols_only=True)
        carry = {}
        si_arr, sf = st['si'], st['sf']
        for si, s in enumerate(ep.stages):
            op = self.stage_op[si]
            if s.kind == K_WPHASE:
                carry['ph%d' % si] = tdsp.asu32(si_arr[op, C_PHASE])
            elif s.kind == K_RCYCLE:
                carry['cp%d' % si] = (tdsp.asu32(si_arr[op, C_RCPHI])
                                      << 32) \
                    | tdsp.asu32(si_arr[op, C_RCPLO])
            elif s.kind in (K_WRUN, K_WRUN_SELF):
                carry['pp%d' % si] = tdsp.asu32(si_arr[op, C_WPPH])
                carry['ps%d' % si] = sf[op, C_WPS]
                carry['rst%d' % si] = si_arr[op, C_WRESET] != 0
                if s.kind == K_WRUN_SELF:
                    carry['fb%d' % si] = sf[op, C_WFB]
            elif s.kind == K_RRUN_SELF:
                carry['ps%d' % si] = sf[op, C_RPS]
                carry['fb%d' % si] = sf[op, C_RFB]
            elif s.kind == K_NOISE:
                carry['nn%d' % si] = tdsp.asu32(si_arr[op, C_NN])
                carry['np%d' % si] = tdsp.asu32(si_arr[op, C_NPREV])
        return st, carry

    def _chunk(self, c, carry):
        """Render chunk ``c``: returns (new_carry, (nc, B, 2) f32)."""
        d = self._upload()
        ep = self.ep
        nc, B = self.nc, self.B
        dev = self.device
        coeff = float(np.float32(np.float32(4294967296.0)
                                 / np.float64(self.srate)))
        amp_scale = float(np.float32(self.plan.amp_scale))
        line_pos = self.line_pos
        const_mul = dict(zip(self.const_sis, self.const_mul))
        lens = d['lens'][c]                             # (nc, n)
        idx_b = torch.arange(B, device=dev, dtype=I64)[None, :]
        vals: Dict[int, torch.Tensor] = {}
        sval: Dict[int, torch.Tensor] = {}
        mixl = torch.zeros((nc, B), dtype=F32, device=dev)
        mixr = torch.zeros((nc, B), dtype=F32, device=dev)
        new_carry = dict(carry)

        def getb(bid):
            if bid in vals:
                return vals[bid]
            return sval[bid][:, None].expand(nc, B)

        def setb(bid, v):
            sval.pop(bid, None)
            vals[bid] = v

        def row_ramp(fv, ln, cf, bits, inclusive):
            """Exact affine phase run of a scalar-frequency row:
            inc * count + exclusive row-total prefix, mod 2^bits (u64
            as int64 bits, whose adds and multiplies wrap)."""
            mask = M32 if bits == 32 else -1
            inc = tdsp.ftoi(fv * cf) & mask                 # (nc,)
            cnt = torch.minimum(idx_b + int(inclusive), ln[:, None])
            row_tot = (inc * ln) & mask
            row_base = torch.cat([torch.zeros(1, dtype=I64, device=dev),
                                  tdsp.row_cumsum(row_tot, bits)[:-1]])
            run = (row_base[:, None] + inc[:, None] * cnt) & mask
            total = (row_base[-1] + row_tot[-1]) & mask
            return run, total

        for si, s in enumerate(ep.stages):
            kind = s.kind
            ln = lens[:, s.inst]
            mask2 = idx_b < ln[:, None]
            if kind == K_LINE:
                k = line_pos[si]
                v0r = d['lv0'][k, c]
                if si in const_mul:
                    # goal-less hold: a per-row scalar
                    if const_mul[si]:
                        v = torch.where(
                            (d['lflags'][k, c] & LF_SRATIO) != 0,
                            v0r * sval[s.a], v0r)
                    else:
                        v = v0r
                    vals.pop(s.dst, None)
                    sval[s.dst] = v
                    continue
                ls = {'v0': v0r[:, None], 'vt': d['lvt'][k, c][:, None],
                      'pos': d['lpos'][k, c][:, None],
                      'end': d['lend'][k, c][:, None],
                      'flags': d['lflags'][k, c][:, None]}
                mul = getb(s.a) if s.a >= 0 else None
                out, _ = line_run_vec(ls, B, ln[:, None], mul,
                                      s.ltype, idx_b)
                setb(s.dst, out)
            elif kind == K_RANGEMOD:
                par = getb(s.dst)
                setb(s.dst, torch.where(
                    mask2, par + (getb(s.a) - par) * getb(s.b), par))
            elif kind == K_CONST1:
                setb(s.dst, torch.ones((nc, B), dtype=F32, device=dev))
            elif kind == K_ZERO:
                setb(s.dst, torch.zeros((nc, B), dtype=F32, device=dev))
            elif kind == K_WPHASE:
                ph0 = carry['ph%d' % si]
                if si in self.scalar_freq:
                    run, total = row_ramp(sval[s.a], ln, coeff, 32, True)
                else:
                    freq = getb(s.a)
                    incs = torch.where(
                        mask2, tdsp.ftoi(freq * coeff) & M32,
                        torch.zeros((), dtype=I64, device=dev))
                    scan = tdsp.prefix_sum_plain if self.plain \
                        else tdsp.prefix_sum
                    run_flat = scan(incs.reshape(nc * B))
                    run = run_flat.reshape(nc, B)
                    total = run_flat[-1]
                ofs = self._phase_ofs(s, getb, sval, tdsp.P31)
                setb(s.dst, (ofs + ph0 + run) & M32)
                new_carry['ph%d' % si] = (ph0 + total) & M32
            elif kind == K_WRUN:
                sval.pop(s.dst, None)
                self._wrun_stage(s, si, c, carry, new_carry, vals,
                                 mask2, ln)
            elif kind == K_WRUN_SELF:
                sval.pop(s.dst, None)
                self._wrun_self_stage(s, si, c, carry, new_carry, vals,
                                      getb, mask2)
            elif kind == K_RRUN_SELF:
                sval.pop(s.dst, None)
                self._rrun_self_stage(s, si, carry, new_carry, vals,
                                      getb, mask2)
            elif kind == K_NOISE:
                sval.pop(s.dst, None)
                self._noise_stage(s, si, c, carry, new_carry, vals,
                                  mask2, idx_b)
            elif kind == K_RCYCLE:
                r2x = s.ras[5]
                cf = float(np.float32(coeff * 2)) if r2x else coeff
                pscale = float(np.float32(tdsp.P31 * 2)) if r2x \
                    else tdsp.P31
                cp = carry['cp%d' % si]
                if si in self.scalar_freq:
                    excl, total = row_ramp(sval[s.a], ln, cf, 64, False)
                else:
                    incs = torch.where(
                        mask2, tdsp.ftoi(getb(s.a) * cf),
                        torch.zeros((), dtype=I64, device=dev))
                    scan = tdsp.prefix_sum_u64_plain if self.plain \
                        else tdsp.prefix_sum_u64
                    csum_flat = scan(incs.reshape(nc * B))
                    excl = csum_flat.reshape(nc, B) - incs
                    total = csum_flat[-1]
                cph = self._phase_ofs(s, getb, sval, pscale, bits=64) \
                    + cp + excl
                setb(s.dst, (cph >> 32) & M32)
                setb(s.dst + 1,
                     ((cph & M32) >> 1).to(F32) * tdsp.SCALE31)
                new_carry['cp%d' % si] = cp + total
            elif kind == K_RRUN:
                rline, func, level, alpha, oflags, _ = s.ras
                av, bv = tdsp.rasg_map(func, level, alpha, oflags,
                                       getb(s.a))
                setb(s.dst, tdsp.rasg_shape(rline, oflags, getb(s.dst),
                                            av, bv))
            elif kind == K_MIX:
                src = getb(s.a)
                amp = getb(s.b)
                if s.layer:
                    prev = getb(s.dst) \
                        if s.dst in vals or s.dst in sval \
                        else torch.zeros((nc, B), dtype=F32, device=dev)
                if s.wave_env:
                    s_amp = amp * 0.5
                    sv = src * s_amp + torch.abs(s_amp)
                    new = prev * sv if s.layer else sv
                else:
                    new = prev + src * amp if s.layer else src * amp
                setb(s.dst, torch.where(
                    mask2, new, prev if s.layer
                    else torch.zeros((), dtype=F32, device=dev)))
            elif kind == K_VMIX:
                src = getb(s.a)
                sv = src * amp_scale
                if s.dst in sval:
                    # a per-row pan: the JAX renderer's compiled form
                    # folds the two broadcast factors first (XLA
                    # reassociates a product of broadcasts), so the
                    # pan term is src * (pan * amp_scale)
                    sr = src * (sval[s.dst] * amp_scale)[:, None]
                else:
                    sr = sv * getb(s.dst)
                zero = torch.zeros((), dtype=F32, device=dev)
                mixl = mixl + torch.where(mask2, sv - sr, zero)
                mixr = mixr + torch.where(mask2, sv + sr, zero)
        return new_carry, torch.stack([mixl, mixr], dim=-1)

    @staticmethod
    def _phase_ofs(s, getb, sval, pscale, bits=32):
        """Phase offset of PM (``s.b``) and frequency-scaled PM
        (``s.c``) inputs, as u32 (or u64 bits in int64)."""
        if s.c >= 0:
            if s.a in sval:
                # a per-row frequency: the compiled JAX form folds the
                # two broadcast factors first (see K_VMIX)
                fpm = getb(s.c) * (tdsp.HUMMID_INV * sval[s.a])[:, None]
            else:
                fpm = getb(s.c) * tdsp.HUMMID_INV * getb(s.a)
        if s.b >= 0 and s.c >= 0:
            s_pofs = getb(s.b) + fpm
        elif s.b >= 0:
            s_pofs = getb(s.b)
        elif s.c >= 0:
            s_pofs = fpm
        else:
            return 0
        ofs = tdsp.ftoi(s_pofs * pscale)
        return ofs & M32 if bits == 32 else ofs

    def _wrun_stage(self, s, si, c, carry, new_carry, vals, mask2, ln):
        nc, B = self.nc, self.B
        dev = self.device
        phase2 = vals[s.a]                              # (nc, B) u32
        li = torch.clamp(ln - 1, min=0)
        row_last = phase2[torch.arange(nc, device=dev), li]
        row_act = ln > 0
        k = self.state_pos[si]
        has_act = bool(self.t_act[k, c])
        last_ir = int(self.t_last_ir[k, c])
        pp_in = carry['pp%d' % si]
        ps_in = carry['ps%d' % si]
        row_hold = _row_fill(row_last, row_act, pp_in, self.plain)
        held = torch.where(mask2, phase2, row_hold[:, None])
        ph_flat = held.reshape(nc * B)
        # an unconsumed reset (prepare/mode record) pairs the FIRST
        # ACTIVE sample with its own phase minus SLEN (wosc.h:215-231)
        fi = self._upload()['first_ir'][k, c:c + 1]
        rst = carry['rst%d' % si]
        do_rst = rst if has_act else torch.zeros_like(rst)
        rst_prev = (ph_flat[fi] - (1 << tdsp.SLENBITS)) & M32
        fill = tdsp.wosc_s_filled_plain if self.plain \
            else tdsp.wosc_s_filled
        out = fill(self.piluts[s.wave], s.wave, ph_flat[None],
                   pp_in.reshape(1), ps_in.reshape(1), fi,
                   do_rst.reshape(1), rst_prev)[0]
        new_carry['pp%d' % si] = row_hold[-1]
        new_carry['ps%d' % si] = out[last_ir] if has_act else ps_in
        new_carry['rst%d' % si] = rst & (not has_act)
        vals[s.dst] = out.reshape(nc, B)

    def _wrun_self_stage(self, s, si, c, carry, new_carry, vals, getb,
                         mask2):
        """wosc self-PM (wosc.h:273-310) as one masked sequential pass
        over the chunk's flattened sample stream (kernel 5): inactive
        samples output 0 and leave the state alone."""
        nc, B = self.nc, self.B
        k = self.state_pos[si]
        has_act = bool(self.t_act[k, c])
        fi = int(self.t_first_ir[k, c])
        ph_flat = getb(s.a).reshape(1, nc * B)
        am_flat = getb(s.b).reshape(1, nc * B)
        # an unconsumed reset pairs the FIRST ACTIVE sample with its
        # own phase minus SLEN (wosc.h:215-231)
        rst = carry['rst%d' % si]
        rst_prev = (ph_flat[0, fi] - (1 << tdsp.SLENBITS)) & M32
        pp0 = torch.where(rst & has_act, rst_prev, carry['pp%d' % si])
        run = tdsp.wosc_selfmod_plain if self.plain else tdsp.wosc_selfmod
        out, pp, ps, fb = run(
            self.piluts[s.wave], s.wave, ph_flat, am_flat,
            mask2.reshape(1, nc * B), pp0.reshape(1),
            carry['ps%d' % si].reshape(1), carry['fb%d' % si].reshape(1))
        vals[s.dst] = out.reshape(nc, B)
        new_carry['pp%d' % si] = pp[0]
        new_carry['ps%d' % si] = ps[0]
        new_carry['fb%d' % si] = fb[0]
        new_carry['rst%d' % si] = rst & (not has_act)

    def _rrun_self_stage(self, s, si, carry, new_carry, vals, getb,
                         mask2):
        """RasG self-PM (rasg.h:242-294, 764-772): a masked sequential
        pass over the chunk's flattened sample stream (kernel 6) on
        the K_RCYCLE stage's cycle (``s.a``) and phase (``s.dst``)
        fills and the self-PM amount (``s.b``)."""
        rline, func, level, alpha, oflags, _ = s.ras
        n = self.nc * self.B
        run = tdsp.rasg_selfmod_plain if self.plain else tdsp.rasg_selfmod
        out, ps, fb = run(
            func, rline, level, alpha, oflags,
            getb(s.dst).reshape(1, n), getb(s.a).reshape(1, n),
            getb(s.b).reshape(1, n), mask2.reshape(1, n),
            carry['ps%d' % si].reshape(1), carry['fb%d' % si].reshape(1))
        vals[s.dst] = out.reshape(self.nc, self.B)
        new_carry['ps%d' % si] = ps[0]
        new_carry['fb%d' % si] = fb[0]

    def _noise_stage(self, s, si, c, carry, new_carry, vals, mask2,
                     idx_b):
        """sauNoiseG_run (noise.h:177-185) over the chunk: a counter
        hash per sample; red noise integrates (kernel 2), violet and
        blue-violet difference against the previous in-range sample."""
        nc, B = self.nc, self.B
        dev = self.device
        ntype = s.ntype
        noff = self._upload()['noff'][self.noise_pos[si], c]
        n = (carry['nn%d' % si] + noff[:, None] + idx_b) & M32
        nprev = carry['np%d' % si]
        k = self.state_pos[si]
        has_act = bool(self.t_act[k, c])
        last_ir = int(self.t_last_ir[k, c])
        rows = torch.arange(nc, device=dev)
        li = torch.clamp(mask2.sum(1) - 1, min=0)
        row_act = mask2.any(1)

        def held_flat(r, seed):
            # r held at the row's last in-range value past its length
            hold = _row_fill(r[rows, li], row_act, seed, self.plain)
            return torch.where(mask2, r, hold[:, None]).reshape(nc * B)

        def prev_of(flat, seed):
            return torch.cat([seed.reshape(1), flat[:-1]])

        def sign1(r):
            return (tdsp.asi32(r) >> 31) * 2 + 1

        if ntype == N_WH:
            out = tdsp.asi32(tdsp.ranfast32(n)).to(F32) * tdsp.SCALE31
        elif ntype == N_GW:
            out = tdsp.franssgauss32(n)
        elif ntype == N_BW:
            out = sign1(tdsp.ranfast32(n)).to(F32)
        elif ntype == N_TW:
            out = torch.where((n & 1) != 0,
                              sign1(tdsp.ranfast32(n)).to(F32),
                              torch.zeros((), dtype=F32, device=dev))
        elif ntype == N_RE:
            inc = torch.where(
                mask2, (tdsp.asi32(tdsp.ranfast32(n)) >> 6) & M32,
                torch.zeros((), dtype=I64, device=dev))
            scan = tdsp.prefix_sum_plain if self.plain \
                else tdsp.prefix_sum
            sums = (nprev + scan(inc.reshape(nc * B))) & M32
            out = (tdsp.asi32(tdsp.foldhd32(sums)).to(F32)
                   * tdsp.SCALE31).reshape(nc, B)
            new_carry['np%d' % si] = sums[-1] if has_act else nprev
        elif ntype == N_VI:
            r = held_flat(tdsp.ranfast32(n), nprev)
            d = ((r >> 1) - (prev_of(r, nprev) >> 1)) & M32
            out = (tdsp.asi32(d).to(F32) * tdsp.SCALE31).reshape(nc, B)
            new_carry['np%d' % si] = r[last_ir] if has_act else nprev
        else:  # N_BV
            sb = torch.where((n & 1) != 0, sign1(tdsp.ranfast32(n)),
                             torch.zeros((), dtype=I64, device=dev))
            seed = tdsp.asi32(nprev)
            h = held_flat(sb, seed)
            out = (h - prev_of(h, seed)).to(F32).reshape(nc, B)
            new_carry['np%d' % si] = h[last_ir] & M32 if has_act \
                else nprev
        vals[s.dst] = out

    def _fini(self, st, carry):
        """Write the carries back to the state (gated by stage
        activity) and the host-authoritative columns from the host
        simulation's end tables."""
        ep = self.ep
        end = self._upload()['end']
        sf = st['sf'].clone()
        si_arr = st['si'].clone()
        for si, s in enumerate(ep.stages):
            if not self.stage_active[si]:
                continue
            op = self.stage_op[si]
            if s.kind == K_WPHASE:
                si_arr[op, C_PHASE] = i32(carry['ph%d' % si])
            elif s.kind == K_RCYCLE:
                cp = carry['cp%d' % si]
                si_arr[op, C_RCPLO] = i32(cp & M32)
                si_arr[op, C_RCPHI] = i32((cp >> 32) & M32)
            elif s.kind in (K_WRUN, K_WRUN_SELF):
                si_arr[op, C_WPPH] = i32(carry['pp%d' % si])
                sf[op, C_WPS] = carry['ps%d' % si]
                si_arr[op, C_WRESET] = 0
                if s.kind == K_WRUN_SELF:
                    sf[op, C_WFB] = carry['fb%d' % si]
            elif s.kind == K_RRUN_SELF:
                sf[op, C_RPS] = carry['ps%d' % si]
                sf[op, C_RFB] = carry['fb%d' % si]
            elif s.kind == K_NOISE:
                # the counter carry stays at its segment-start value and
                # the offsets are segment-relative: add the total once
                si_arr[op, C_NN] = i32((carry['nn%d' % si]
                                        + self.noise_total[si]) & M32)
                si_arr[op, C_NPREV] = i32(carry['np%d' % si])
        sf[:, C_LV0:C_LV0 + 6] = end['lv0']
        sf[:, C_LVT:C_LVT + 6] = end['lvt']
        si_arr[:, C_LPOS:C_LPOS + 6] = end['lpos']
        si_arr[:, C_LEND:C_LEND + 6] = end['lend']
        si_arr[:, C_LTYPE:C_LTYPE + 6] = end['ltype']
        si_arr[:, C_LFLAGS:C_LFLAGS + 6] = end['lflags']
        si_arr[:, C_TIME] = end['time']
        si_arr[:, C_TINF] = end['tinf']
        return {'sf': sf, 'si': si_arr, 'vdur': end['vdur'].clone()}

    # -- public API ---------------------------------------------------------

    def run(self, st):
        """Render the whole segment; returns (st', (nb, B, 2) f32)."""
        pieces = []
        for kind, val, _nv in self.stream(st):
            if kind == 'out':
                pieces.append(val.reshape(-1, self.B, 2))
            else:
                st = val
        return st, torch.cat(pieces)[:self.nb]

    def stream(self, st):
        """Yield ('out', (gch, nc, B, 2) f32, n_valid_blocks) per chunk
        group in order, then ('st', st', 0). Device memory is bounded
        by one group whatever the segment's length."""
        st, carry = self._init(st)
        done = 0
        for g in range(self.ng):
            outs = []
            for c in range(g * self.gch, (g + 1) * self.gch):
                carry, o = self._chunk(c, carry)
                outs.append(o)
            n_valid = min(self.nb - done, self.gch * self.nc)
            yield 'out', torch.stack(outs), n_valid
            done += n_valid
        yield 'st', self._fini(st, carry), 0
