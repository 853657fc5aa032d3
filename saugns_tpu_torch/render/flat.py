"""Flat (time-parallel) segment renderer on tensors.

Counterpart of ``saugns_tpu/render/flat.py`` for the wave-oscillator
stages. A segment (a block range of an epoch with constant operator
bindings, baked by ``hostsim``) renders chunk by chunk: each chunk is
an (nc, B) sample grid, and the epoch's stage schedule runs over it as
eager tensor ops. Oscillator phases come from one wrapping prefix sum
over the chunk (kernel 2) or, at constant frequency, from an exact
affine ramp; the oscillator output, its pairing with the previous
sample and the pd == 0 hold come from kernel 1.

Stage kinds outside this slice (noise, RasG, self-PM) raise
``NotImplementedError`` when the segment is built.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import tdsp
from .plan import (KIND_NAMES, K_CONST1, K_LINE, K_MIX, K_RANGEMOD,
                   K_VMIX, K_WPHASE, K_WRUN, K_ZERO)
from .state import (C_PHASE, C_LEND, C_LFLAGS, C_LPOS, C_LTYPE, C_LV0,
                    C_LVT, C_TIME, C_TINF, C_WPPH, C_WPS, C_WRESET,
                    LF_GOAL, LF_SRATIO, apply_records, i32, line_run_vec)

FLAT_CHUNK = 1 << 21   # samples per chunk
STREAM_GROUP = 8       # chunks per streamed group

F32 = torch.float32
I64 = torch.int64
M32 = tdsp.M32

SUPPORTED_KINDS = frozenset((K_LINE, K_RANGEMOD, K_CONST1, K_ZERO,
                             K_WPHASE, K_WRUN, K_MIX, K_VMIX))


def check_stages(ep, where=''):
    """Raise NotImplementedError naming the first stage kind this
    slice does not render."""
    for s in ep.stages:
        if s.kind not in SUPPORTED_KINDS:
            raise NotImplementedError(
                '%sstage kind %s (op %d) is not ported to '
                'saugns_tpu_torch yet' % (where, KIND_NAMES[s.kind],
                                          s.op))


def _row_fill(row_vals, row_active, seed):
    """Per-row carry fill: out[r] = row_vals at the last active row
    <= r, or ``seed`` if none yet (a running max over the few rows,
    as lax.cummax in the JAX renderer)."""
    nc = row_vals.shape[0]
    ridx = torch.arange(1, nc + 1, device=row_vals.device)
    last = torch.cummax(torch.where(row_active, ridx,
                                    torch.zeros_like(ridx)), 0).values
    ext = torch.cat([seed.reshape(1), row_vals])
    return ext[last]


class FlatSegment:
    """Renderer for one eligible segment of an epoch. ``plain=True``
    runs the plain versions of the kernels on any device (the
    reference that the kernel path is held against)."""

    def __init__(self, plan, ep, bake, seg, srate, device, tables,
                 plain=False):
        check_stages(ep)
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
        # stateful stages: per-chunk first/last in-range flat index
        # and activity
        self.state_sis = [si for si, st_ in enumerate(ep.stages)
                          if st_.kind == K_WRUN]
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
            if st_.kind == K_WPHASE:
                scalar_freq[si] = st_.a in const_ids
            const_ids.discard(st_.dst)
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
            st = apply_records(st, rec_lo, rec_hi, self.plan.rec_arrays)
        carry = {}
        si_arr, sf = st['si'], st['sf']
        for si, s in enumerate(ep.stages):
            op = self.stage_op[si]
            if s.kind == K_WPHASE:
                carry['ph%d' % si] = tdsp.asu32(si_arr[op, C_PHASE])
            elif s.kind == K_WRUN:
                carry['pp%d' % si] = tdsp.asu32(si_arr[op, C_WPPH])
                carry['ps%d' % si] = sf[op, C_WPS]
                carry['rst%d' % si] = si_arr[op, C_WRESET] != 0
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

        def row_ramp(fv, ln, cf):
            """Exact affine phase run of a scalar-frequency row:
            inc * count + exclusive row-total prefix (mod 2^32)."""
            inc = tdsp.ftoi(fv * cf) & M32                  # (nc,)
            cnt = torch.minimum(idx_b + 1, ln[:, None])
            row_tot = (inc * ln) & M32
            # a chunk has few rows: the plain scan, as jnp.cumsum there
            row_base = torch.cat([torch.zeros(1, dtype=I64, device=dev),
                                  tdsp.prefix_sum_plain(row_tot)[:-1]])
            run = (row_base[:, None] + inc[:, None] * cnt) & M32
            total = (row_base[-1] + row_tot[-1]) & M32
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
                    run, total = row_ramp(sval[s.a], ln, coeff)
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
                ofs = self._phase_ofs(s, getb, tdsp.P31)
                setb(s.dst, (ofs + ph0 + run) & M32)
                new_carry['ph%d' % si] = (ph0 + total) & M32
            elif kind == K_WRUN:
                sval.pop(s.dst, None)
                self._wrun_stage(s, si, c, carry, new_carry, vals,
                                 mask2, ln)
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
                pan = getb(s.dst)
                sv = getb(s.a) * amp_scale
                sr = sv * pan
                zero = torch.zeros((), dtype=F32, device=dev)
                mixl = mixl + torch.where(mask2, sv - sr, zero)
                mixr = mixr + torch.where(mask2, sv + sr, zero)
        return new_carry, torch.stack([mixl, mixr], dim=-1)

    @staticmethod
    def _phase_ofs(s, getb, pscale):
        """Phase offset of PM (``s.b``) and frequency-scaled PM
        (``s.c``) inputs, as u32."""
        if s.b >= 0 and s.c >= 0:
            s_pofs = getb(s.b) + getb(s.c) * tdsp.HUMMID_INV * getb(s.a)
        elif s.b >= 0:
            s_pofs = getb(s.b)
        elif s.c >= 0:
            s_pofs = getb(s.c) * tdsp.HUMMID_INV * getb(s.a)
        else:
            return 0
        return tdsp.ftoi(s_pofs * pscale) & M32

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
        row_hold = _row_fill(row_last, row_act, pp_in)   # (nc,)
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
            elif s.kind == K_WRUN:
                si_arr[op, C_WPPH] = i32(carry['pp%d' % si])
                sf[op, C_WPS] = carry['ps%d' % si]
                si_arr[op, C_WRESET] = 0
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
