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

A chunk's stage loop (``_chunk_steps``) is a generator that yields an
``Exchange`` wherever a carry crosses chunks: driven serially, each
chunk goes on with the previous chunk's end carries; the time axis
(``parallel/timeshard.py``) drives a segment's chunks at once, one a
device, and answers each exchange from the other chunks.

A segment's steps (``_init``, ``_group``, ``_fini``) are functions of
its key's static structure and of tensors only: the host tables the
renderer bakes (per chunk group and per segment) are uploaded once by
``prepare`` and read as tensors, so the segments that share a key share
one captured graph of each step (``graphs.Dispatch``), as the JAX
renderer's segments share one compiled function (flat.py:697-715 there).
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import tdsp
from .graphs import Tables
from .plan import (K_CONST1, K_LINE, K_MIX, K_NOISE, K_RANGEMOD,
                   K_RCYCLE, K_RRUN, K_RRUN_SELF, K_VMIX, K_WPHASE,
                   K_WRUN, K_WRUN_SELF, K_ZERO)
from .state import (C_LEND, C_LFLAGS, C_LPOS, C_LTYPE, C_LV0, C_LVT,
                    C_NN, C_NPREV, C_PHASE, C_RCPHI, C_RCPLO, C_RFB,
                    C_RPS, C_TIME, C_TINF, C_WFB, C_WPPH, C_WPS,
                    C_WRESET, LF_GOAL, LF_SRATIO, _to_i16_device,
                    _to_i16_mono_device, apply_prepared, i32,
                    line_run_vec, prepare_records)

FLAT_CHUNK = 1 << 21   # samples per chunk
STREAM_GROUP = 8       # chunks per streamed group
# most float32 output bytes of one grouped run of segments, and of the
# render as one graph (flat.GROUP_OUT_CAP of the JAX renderer)
GROUP_OUT_CAP = 1 << 29    # 512 MiB

F32 = torch.float32
I64 = torch.int64
M32 = tdsp.M32

# noise colour indices (P.NOISE_NAMES order)
N_WH, N_GW, N_BW, N_TW, N_RE, N_VI, N_BV = range(7)


def _take(x, idx):
    """x at the int64 indices ``idx`` along its last axis: an index of
    the 1-D ``x``, or a gather per voice of (V, L) rows by (V, k)."""
    return x[idx] if x.dim() == 1 else torch.gather(x, -1, idx)


def _row_last(row_active, plain=False):
    """1 + the index of the last active row <= r, 0 if none yet (int32):
    a running max over the few rows of a chunk (lax.cummax in the JAX
    renderer), kernel 4 on the card, over the last axis ((nc,), or
    (V, nc) for a slab of voices, one launch)."""
    nc = row_active.shape[-1]
    ridx = torch.arange(1, nc + 1, device=row_active.device,
                        dtype=torch.int32)
    scan = tdsp.scan_max_i32_plain if plain else tdsp.scan_max_i32
    return scan(torch.where(row_active, ridx, torch.zeros_like(ridx)))


def _row_hold(row_vals, last, seed):
    """out[r] = row_vals at the last active row <= r (``last`` of
    _row_last), or ``seed`` if none yet (per voice for (V, nc) rows and
    (V,) seeds)."""
    ext = torch.cat([seed[..., None], row_vals], -1)
    return _take(ext, last.to(I64))


def _last_active(row_vals, last):
    """(any active row, row_vals at the last one) of a chunk: what it
    hands on to later chunks (``Exchange`` 'hold'). Indexed by a (1,)
    tensor: a 0-d tensor index is read on the host."""
    n = last[..., -1:].to(I64)
    return n[..., 0] > 0, _take(row_vals, torch.clamp(n - 1, min=0))[..., 0]


def padded_rows(nb, row_multiple=1):
    """The padded block-row count of an ``nb``-block segment, quantized
    as in the JAX renderer (8 steps an octave, so that segments of
    similar size share one key while padding stays under ~12%) and
    rounded up to a multiple of ``row_multiple`` (flat.py:171-186
    there; the padded rows are inert, lens 0)."""
    q = 1
    while q * 8 < nb:
        q *= 2
    nb_r = -(-nb // q) * q
    if row_multiple > 1:
        nb_r = -(-nb_r // row_multiple) * row_multiple
    return nb_r


class Exchange(NamedTuple):
    """A point of a chunk's stage loop where carries cross chunks.
    ``FlatSegment._chunk_steps`` yields one and is sent back either
    None, to go on with the carries it holds (the serial path, where
    they are the previous chunk's end carries), or a tuple of tensors,
    the carries ``names`` to use from there on. ``kind`` says how a
    driver of chunks that run at once (parallel/timeshard.py) combines
    the chunks' ``pub()``, chunk by chunk from the segment's carry:

    - 'add32', 'add64': pub() is the chunk's wrapping total; the next
      chunk's carry is this one's plus it, mod 2^32 or 2^64 (int64
      bits);
    - 'hold': pub() is (any active sample, the value at the last one);
      the next chunk's carry is that value, else this one's;
    - 'once': pub() is whether the chunk has an active sample; a
      pending reset passes to the next chunk only if it has none;
    - 'provisional': no pub; the chunk runs kernel 1 on a NaN hold seed
      (the serial path on its true seed);
    - 'fill': pub() is the chunk's last output (NaN where no sample of
      it is valid); the next chunk's seed is that output unless it is
      NaN, else this one's; a reply replaces the chunk's NaN samples;
    - 'serial': the carries are the previous chunk's end carries, once
      it has run (the self-PM recurrences, which cannot be split)."""

    kind: str
    names: Tuple[str, ...]
    pub: Optional[Callable] = None


def _exchange(cur, kind, names, pub=None):
    """Yield an Exchange of the carries ``names`` and take its reply
    into ``cur``."""
    got = yield Exchange(kind, names, pub)
    if got is not None:
        cur.update(zip(names, got))
    return got


def run_steps(steps):
    """Drive a chunk's stage loop serially (every Exchange answered
    with None); returns its output."""
    try:
        next(steps)
        while True:
            steps.send(None)
    except StopIteration as stop:
        return stop.value


def with_conv(body, conv):
    """``body`` (-> float32 stereo output) ending in the conversion
    ``conv``: 'f32' none, 'i16' the int16 stereo output, 'mono' the
    int16 mono downmix, 'cksum' the int16 output's sum added into an
    int64 accumulator that the body then takes as its first argument
    (the grouped render's device_checksum)."""
    if conv == 'f32':
        return body
    if conv == 'i16':
        return lambda *a: _to_i16_device(body(*a))
    if conv == 'mono':
        return lambda *a: _to_i16_mono_device(body(*a))

    def summed(acc, *a):
        acc.add_(_to_i16_device(body(*a)).sum(dtype=torch.int64))
    return summed


def rasg_pairs(stages):
    """{K_RCYCLE stage: the K_RRUN stage that reads it}: the pairs that
    run as one (kernel 11). The planner emits each R carrier's cyclor
    and then the run that reads its cycle buffer (``a == dst``) and
    writes its phase buffer (``dst + 1``), with only stages on other
    buffers between them; a K_RRUN_SELF run keeps its cyclor apart."""
    pairs = {}
    for ri, r in enumerate(stages):
        if r.kind != K_RRUN:
            continue
        si = next((si for si in range(ri - 1, -1, -1)
                   if stages[si].kind == K_RCYCLE
                   and stages[si].dst == r.a), None)
        if si is None or r.dst != r.a + 1:
            raise ValueError('K_RRUN stage %d reads no cyclor it can run '
                             'with' % ri)
        pairs[si] = ri
    return pairs


class FlatSegment:
    """Renderer for one eligible segment of an epoch. ``plain=True``
    runs the plain versions of the kernels on any device (the
    reference that the kernel path is held against).

    ``key`` holds the JAX renderer's key (flat.py:707-711 there) and
    every other static value the steps branch on: the record structure
    of the segment's first block and the layout of its tables. The
    host values a step once branched on per chunk (a state stage's
    activity, its first and last active index) and per segment (the
    stages' operators and activity, the noise counter totals) are
    tables.

    A segment renders one voice's stage schedule, or V of them at once
    (``FlatSegment.stack``): the one-voice segments of a voice slab, of
    one key, as V rows -- the JAX package's ``jax.vmap`` of one
    segment's functions over the voice axis (voicebank.py:329-342 and
    meshrender.py:146-165 there). Then every value of the stage loop,
    every carry and every table has a leading voice axis (``lead``,
    (V,)), and the kernels run once over the V rows; each row's
    arithmetic is the one-voice segment's, in the same order, so each
    voice's float32 output is bit for bit its one-voice render. A
    one-voice segment has no such axis (``lead`` is ())."""

    # a one-voice segment; FlatSegment.stack makes V > 1
    V = 1
    lead = ()

    def __init__(self, plan, ep, bake, seg, srate, device, tables,
                 plain=False, end_tables=True, chunk_samples=None,
                 row_multiple=1):
        # end_tables=False: the segment-end tables are the caller's to
        # write (the mesh renderers write them once a segment, not once
        # a voice). chunk_samples caps a chunk's samples (FLAT_CHUNK by
        # default); row_multiple rounds the padded row count up to a
        # multiple of it (the time axis, parallel/timeshard.py)
        self.end_tables = end_tables
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
        cap = max((chunk_samples or FLAT_CHUNK) // B, 1)
        # padded block count, as in the JAX renderer so both cut a
        # segment into the same chunks
        nb_r = padded_rows(nb, row_multiple)
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
        self.rasg_pairs = rasg_pairs(ep.stages)
        self.key = (ep.sig[0], B, nc, gch, srate,
                    float(np.float32(plan.amp_scale)), plan.n_ops,
                    plan.n_voices, plan.n_recs, self.const_sis,
                    self.const_mul, self.scalar_freq, self.rec_struct,
                    self.fini_cells_unique, self.dyn.layout,
                    self.xs[0].layout)

    # -- host-side table assembly ------------------------------------------

    def _bake_tables(self):
        ep, bake, seg = self.ep, self.bake, self.seg
        lo, nb, B, nc, nch = self.lo, self.nb, self.B, self.nc, self.nch
        hi = seg.hi
        pad = nch * nc - nb
        stages = ep.stages

        def padb(a, fill=0):
            a = np.asarray(a)[lo:hi]
            if pad == 0:
                return a
            w = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
            return np.pad(a, w, constant_values=fill)

        n_insts = max(len(ep.instances), 1)
        lens = padb(bake.lens if bake.lens is not None
                    else np.zeros((hi, n_insts), np.int32))
        # per chunk: (nch, ...) arrays, cut into chunk groups below
        xs = {'lens': lens.reshape(nch, nc, -1).astype(np.int64)}
        self.line_sis = [si for si, st_ in enumerate(stages)
                         if st_.kind == K_LINE]
        nl = len(self.line_sis)
        for key, dt in (('v0', np.float32), ('vt', np.float32),
                        ('pos', np.int64), ('end', np.int64),
                        ('flags', np.int64)):
            if nl:
                tab = np.stack([padb(getattr(bake.stages[si], key))
                                for si in self.line_sis])
                xs['l' + key] = tab.reshape(nl, nch, nc) \
                    .transpose(1, 0, 2).astype(dt)
        self.noise_sis = [si for si, st_ in enumerate(stages)
                          if st_.kind == K_NOISE]
        nn = len(self.noise_sis)
        # noise counter offsets relative to the segment start (the
        # counter is read from the state at segment entry)
        if nn:
            noff = np.stack(
                [padb(np.asarray(bake.stages[si].noff, np.int64)
                      - int(bake.stages[si].noff[lo])) & M32
                 for si in self.noise_sis])
            xs['noff'] = noff.reshape(nn, nch, nc).transpose(1, 0, 2) \
                .astype(np.int64)
        # stateful stages: per-chunk first/last in-range flat index
        # and activity
        self.state_sis = [si for si, st_ in enumerate(stages)
                          if st_.kind in (K_WRUN, K_NOISE, K_WRUN_SELF,
                                          K_RRUN_SELF)]
        k_state = max(len(self.state_sis), 1)
        li_tab = np.zeros((nch, k_state), np.int64)
        fi_tab = np.zeros((nch, k_state), np.int64)
        act_tab = np.zeros((nch, k_state), bool)
        for k, si in enumerate(self.state_sis):
            sl = lens[:, stages[si].inst].reshape(nch, nc)
            for c in range(nch):
                rows = np.nonzero(sl[c] > 0)[0]
                if len(rows):
                    r = rows[-1]
                    li_tab[c, k] = r * B + sl[c, r] - 1
                    fi_tab[c, k] = rows[0] * B
                    act_tab[c, k] = True
        xs['last_ir'], xs['first_ir'], xs['act'] = li_tab, fi_tab, act_tab
        gch = self.gch
        self.xs = [Tables({k: v[g * gch:(g + 1) * gch]
                           for k, v in xs.items()})
                   for g in range(self.ng)]
        self.state_pos = {si: k for k, si in enumerate(self.state_sis)}
        self.line_pos = {si: k for k, si in enumerate(self.line_sis)}
        self.noise_pos = {si: k for k, si in enumerate(self.noise_sis)}
        # per segment: operators, activity, counter totals, the first
        # block's records and the host simulation's end tables
        dyn = {'ops': np.asarray(self.stage_op, np.int64),
               'sact': np.asarray([bool(np.any(lens[:, s.inst] > 0))
                                   for s in stages], bool),
               'ntot': np.asarray(
                   [int(np.sum(lens[:, stages[si].inst].astype(np.int64)))
                    & M32 for si in self.noise_sis], np.int64)}
        # the carries' write-back cells: (op, column) of each, and its
        # stage's activity; one scatter per array where no cell repeats
        writes = self._fini_writes()
        self.state_cols = bool(writes)
        cells = [(self.stage_op[si], col, a) for a, col, si, _ in writes]
        self.fini_cells_unique = len(set(cells)) == len(cells)
        for name in ('sf', 'si'):
            w = [(self.stage_op[si], col, si)
                 for a, col, si, _ in writes if a == name]
            dyn['wb_%s_op' % name] = np.asarray([x[0] for x in w],
                                                np.int64)
            dyn['wb_%s_col' % name] = np.asarray([x[1] for x in w],
                                                 np.int64)
            dyn['wb_%s_act' % name] = dyn['sact'][[x[2] for x in w]] \
                if w else np.zeros(0, bool)
        self.rec_struct, recs = prepare_records(
            int(ep.blk_rec_lo[lo]), int(ep.blk_rec_hi[lo]),
            self.plan.rec_arrays, device_cols_only=True)
        dyn.update(('rec_' + k, v) for k, v in recs.items())
        if self.end_tables:
            dyn.update(('end_' + k, getattr(seg, 'end_' + k))
                       for k in END_TABLES)
        self.dyn = Tables(dyn)
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

    @classmethod
    def stack(cls, members):
        """The segment that renders the one-voice segments ``members``
        (one key, end tables left out, tables not uploaded) as V rows,
        in order: their tables stacked along a voice axis, the key
        theirs plus V. A state write-back of an inactive stage (and of
        an inert padding voice, which may repeat a real voice's
        operators) goes to a spare row past the operators, as the JAX
        package's vmapped write-back drops it (meshrender.py:183-190
        there). One member is itself."""
        m0 = members[0]
        V = len(members)
        if V == 1:
            return m0
        for m in members:
            if m.key != m0.key or m.end_tables or m.rec_struct is not None:
                raise ValueError('FlatSegment.stack: members of one key, '
                                 'without end tables or records')
        seg = copy.copy(m0)
        seg.V, seg.lead = V, (V,)
        dyns = [m.dyn.arrays() for m in members]
        dyn = {k: np.stack([d[k] for d in dyns]) for k in dyns[0]}
        n_ops = m0.plan.n_ops
        for name in ('sf', 'si'):
            dyn['wb_%s_op' % name] = np.where(
                dyn['wb_%s_act' % name], dyn['wb_%s_op' % name], n_ops)
        dyn['wb_ops'] = np.where(dyn['sact'], dyn['ops'], n_ops)
        seg.dyn = Tables(dyn)
        seg.xs = []
        for g in range(m0.ng):
            xg = [m.xs[g].arrays() for m in members]
            # (gch, V, ...): a chunk's tables are (V, ...)
            seg.xs.append(Tables({k: np.stack([x[k] for x in xg], 1)
                                  for k in xg[0]}))
        seg.key = m0.key + (V,)
        return seg

    def prepare(self):
        """Upload the segment's tables to its device (once); no render
        step uploads anything after this."""
        self.dyn.upload(self.device)
        for t in self.xs:
            t.upload(self.device)

    def carry_spec(self):
        """(name, dtype) of each carry between the steps, in order."""
        spec = []
        for si, s in enumerate(self.ep.stages):
            if s.kind == K_WPHASE:
                spec.append(('ph%d' % si, I64))
            elif s.kind == K_RCYCLE:
                spec.append(('cp%d' % si, I64))
            elif s.kind in (K_WRUN, K_WRUN_SELF):
                spec += [('pp%d' % si, I64), ('ps%d' % si, F32),
                         ('rst%d' % si, torch.bool)]
                if s.kind == K_WRUN_SELF:
                    spec.append(('fb%d' % si, F32))
            elif s.kind == K_RRUN_SELF:
                spec += [('ps%d' % si, F32), ('fb%d' % si, F32)]
            elif s.kind == K_NOISE:
                spec += [('nn%d' % si, I64), ('np%d' % si, I64)]
        return spec

    # -- segment steps -----------------------------------------------------

    def _init(self, st, dyn):
        """Apply the first block's records and read the carries from
        the state: (st', carry) of device tensors (0-d, or (V,) per
        voice)."""
        rec = {k[4:]: v for k, v in dyn.items() if k.startswith('rec_')}
        st = apply_prepared(st, self.rec_struct, rec)
        carry = {}
        if not self.state_cols:
            return st, carry
        # the stages' state rows, gathered once (u32 values in int64)
        ri = tdsp.asu32(st['si'][dyn['ops']])
        rf = st['sf'][dyn['ops']]
        for si, s in enumerate(self.ep.stages):
            if s.kind == K_WPHASE:
                carry['ph%d' % si] = ri[..., si, C_PHASE]
            elif s.kind == K_RCYCLE:
                carry['cp%d' % si] = (ri[..., si, C_RCPHI] << 32) \
                    | ri[..., si, C_RCPLO]
            elif s.kind in (K_WRUN, K_WRUN_SELF):
                carry['pp%d' % si] = ri[..., si, C_WPPH]
                carry['ps%d' % si] = rf[..., si, C_WPS]
                carry['rst%d' % si] = ri[..., si, C_WRESET] != 0
                if s.kind == K_WRUN_SELF:
                    carry['fb%d' % si] = rf[..., si, C_WFB]
            elif s.kind == K_RRUN_SELF:
                carry['ps%d' % si] = rf[..., si, C_RPS]
                carry['fb%d' % si] = rf[..., si, C_RFB]
            elif s.kind == K_NOISE:
                carry['nn%d' % si] = ri[..., si, C_NN]
                carry['np%d' % si] = ri[..., si, C_NPREV]
        return st, carry

    def _group(self, carry, xs):
        """Render one chunk group from its tables ``xs``: returns
        (new_carry, (*lead, gch, nc, B, 2) f32)."""
        outs = []
        for j in range(self.gch):
            carry, o = self._chunk(xs, j, carry)
            outs.append(o)
        return carry, torch.stack(outs, len(self.lead))

    def _chunk(self, xs, j, carry):
        """Render chunk ``j`` of a group: returns (new_carry, (*lead, nc,
        B, 2) f32)."""
        new_carry = dict(carry)
        out = run_steps(self._chunk_steps(xs, j, carry, new_carry))
        return new_carry, out

    def _bc(self, x, k):
        """A per-voice value ``x`` (0-d, or (V,)) broadcast against
        values with ``k`` more trailing axes."""
        return x.reshape(x.shape + (1,) * k) if self.lead else x

    def _unrow(self, x):
        """A kernel's per-row result, (V, ...), as the segment holds it:
        its one row for one voice."""
        return x if self.lead else x[0]

    def _chunk_steps(self, xs, j, carry, new_carry):
        """Chunk ``j``'s stage loop as a generator that yields an
        ``Exchange`` wherever a carry crosses chunks and returns the
        (*lead, nc, B, 2) f32 output; the chunk's end carries go into
        ``new_carry``. run_steps drives it serially; the time axis
        drives the chunks of a segment at once, stage by stage
        (parallel/timeshard.py)."""
        ep = self.ep
        nc, B = self.nc, self.B
        lead = self.lead
        dev = self.device
        coeff = float(np.float32(np.float32(4294967296.0)
                                 / np.float64(self.srate)))
        amp_scale = float(np.float32(self.plan.amp_scale))
        line_pos = self.line_pos
        const_mul = dict(zip(self.const_sis, self.const_mul))
        lens = xs['lens'][j]                            # (*lead, nc, n)
        idx_b = torch.arange(B, device=dev, dtype=I64)[None, :]
        vals: Dict[int, torch.Tensor] = {}
        sval: Dict[int, torch.Tensor] = {}
        mixl = torch.zeros(lead + (nc, B), dtype=F32, device=dev)
        mixr = torch.zeros(lead + (nc, B), dtype=F32, device=dev)
        cur = dict(carry)

        def getb(bid):
            if bid in vals:
                return vals[bid]
            return sval[bid][..., None].expand(lead + (nc, B))

        def setb(bid, v):
            sval.pop(bid, None)
            vals[bid] = v

        def row_terms(fv, ln, cf, bits):
            """A scalar-frequency row's increment, its exclusive
            row-total prefix and the chunk's total, mod 2^bits (u64 as
            int64 bits, whose adds and multiplies wrap)."""
            mask = M32 if bits == 32 else -1
            inc = tdsp.ftoi(fv * cf) & mask                 # (*lead, nc)
            row_tot = (inc * ln) & mask
            row_base = torch.cat([torch.zeros(lead + (1,), dtype=I64,
                                              device=dev),
                                  tdsp.row_cumsum(row_tot, bits)[..., :-1]],
                                 -1)
            total = (row_base[..., -1] + row_tot[..., -1]) & mask
            return inc, row_base, total

        def row_ramp(fv, ln, cf, bits, inclusive):
            """Exact affine phase run of a scalar-frequency row:
            inc * count + exclusive row-total prefix, mod 2^bits."""
            mask = M32 if bits == 32 else -1
            inc, row_base, total = row_terms(fv, ln, cf, bits)
            cnt = torch.minimum(idx_b + int(inclusive), ln[..., None])
            run = (row_base[..., None] + inc[..., None] * cnt) & mask
            return run, total

        for si, s in enumerate(ep.stages):
            kind = s.kind
            ln = lens[..., s.inst]
            mask2 = idx_b < ln[..., None]
            if kind == K_LINE:
                k = line_pos[si]
                v0r = xs['lv0'][j][..., k, :]
                if si in const_mul:
                    # goal-less hold: a per-row scalar
                    if const_mul[si]:
                        v = torch.where(
                            (xs['lflags'][j][..., k, :] & LF_SRATIO) != 0,
                            v0r * sval[s.a], v0r)
                    else:
                        v = v0r
                    vals.pop(s.dst, None)
                    sval[s.dst] = v
                    continue
                ls = {name: xs['l' + name][j][..., k, :, None]
                      for name in ('vt', 'pos', 'end', 'flags')}
                ls['v0'] = v0r[..., None]
                mul = getb(s.a) if s.a >= 0 else None
                out, _ = line_run_vec(ls, B, ln[..., None], mul,
                                      s.ltype, idx_b)
                setb(s.dst, out)
            elif kind == K_RANGEMOD:
                par = getb(s.dst)
                setb(s.dst, torch.where(
                    mask2, par + (getb(s.a) - par) * getb(s.b), par))
            elif kind == K_CONST1:
                setb(s.dst, torch.ones(lead + (nc, B), dtype=F32,
                                       device=dev))
            elif kind == K_ZERO:
                setb(s.dst, torch.zeros(lead + (nc, B), dtype=F32,
                                        device=dev))
            elif kind == K_WPHASE:
                if si in self.scalar_freq:
                    run, total = row_ramp(sval[s.a], ln, coeff, 32, True)
                else:
                    freq = getb(s.a)
                    incs = torch.where(
                        mask2, tdsp.ftoi(freq * coeff) & M32,
                        torch.zeros((), dtype=I64, device=dev))
                    scan = tdsp.prefix_sum_plain if self.plain \
                        else tdsp.prefix_sum
                    run_flat = scan(incs.reshape(lead + (nc * B,)))
                    run = run_flat.reshape(lead + (nc, B))
                    total = run_flat[..., -1]
                name = 'ph%d' % si
                yield from _exchange(cur, 'add32', (name,), lambda: total)
                ph0 = cur[name]
                ofs = self._phase_ofs(s, getb, sval, tdsp.P31)
                setb(s.dst, (ofs + self._bc(ph0, 2) + run) & M32)
                new_carry[name] = (ph0 + total) & M32
            elif kind == K_WRUN:
                sval.pop(s.dst, None)
                yield from self._wrun_stage(s, si, xs, j, cur, new_carry,
                                            vals, mask2, ln)
            elif kind == K_WRUN_SELF:
                sval.pop(s.dst, None)
                yield from self._wrun_self_stage(s, si, xs, j, cur,
                                                 new_carry, vals, getb,
                                                 mask2)
            elif kind == K_RRUN_SELF:
                sval.pop(s.dst, None)
                yield from self._rrun_self_stage(s, si, cur, new_carry,
                                                 vals, getb, mask2)
            elif kind == K_NOISE:
                sval.pop(s.dst, None)
                yield from self._noise_stage(s, si, xs, j, cur, new_carry,
                                             vals, mask2, idx_b)
            elif kind == K_RCYCLE:
                r2x = s.ras[5]
                cf = float(np.float32(coeff * 2)) if r2x else coeff
                pscale = float(np.float32(tdsp.P31 * 2)) if r2x \
                    else tdsp.P31
                fused = si in self.rasg_pairs
                if si in self.scalar_freq:
                    if fused:
                        inc, row_base, total = row_terms(sval[s.a], ln,
                                                         cf, 64)
                    else:
                        excl, total = row_ramp(sval[s.a], ln, cf, 64,
                                               False)
                else:
                    incs = torch.where(
                        mask2, tdsp.ftoi(getb(s.a) * cf),
                        torch.zeros((), dtype=I64, device=dev))
                    scan = tdsp.prefix_sum_u64_plain if self.plain \
                        else tdsp.prefix_sum_u64
                    csum_flat = scan(incs.reshape(lead + (nc * B,)))
                    if not fused:
                        excl = csum_flat.reshape(lead + (nc, B)) - incs
                    total = csum_flat[..., -1]
                name = 'cp%d' % si
                yield from _exchange(cur, 'add64', (name,), lambda: total)
                cp = cur[name]
                if fused:
                    # kernel 11 runs this stage and the K_RRUN that
                    # reads it, into the run's output buffer
                    rline, func, level, alpha, oflags, _ = \
                        ep.stages[self.rasg_pairs[si]].ras
                    fill = tdsp.rasg_fill_plain if self.plain \
                        else tdsp.rasg_fill
                    pofs = self._pofs(s, getb, sval)
                    if si in self.scalar_freq:
                        out = fill(func, rline, level, alpha, oflags,
                                   row_base + self._bc(cp, 1), B, pofs,
                                   pscale, inc=inc, ln=ln)
                    else:
                        out = fill(func, rline, level, alpha, oflags,
                                   self._bc(cp, 1).expand(lead + (nc,)),
                                   B, pofs, pscale,
                                   csum=csum_flat.reshape(lead + (nc, B)),
                                   incs=incs)
                    setb(s.dst + 1, out)
                else:
                    cph = self._phase_ofs(s, getb, sval, pscale,
                                          bits=64) \
                        + self._bc(cp, 2) + excl
                    setb(s.dst, (cph >> 32) & M32)
                    setb(s.dst + 1,
                         ((cph & M32) >> 1).to(F32) * tdsp.SCALE31)
                new_carry[name] = cp + total
            elif kind == K_RRUN:
                pass                # run with its K_RCYCLE (kernel 11)
            elif kind == K_MIX:
                src = getb(s.a)
                amp = getb(s.b)
                if s.layer:
                    prev = getb(s.dst) \
                        if s.dst in vals or s.dst in sval \
                        else torch.zeros(lead + (nc, B), dtype=F32,
                                         device=dev)
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
                    sr = src * (sval[s.dst] * amp_scale)[..., None]
                else:
                    sr = sv * getb(s.dst)
                zero = torch.zeros((), dtype=F32, device=dev)
                mixl = mixl + torch.where(mask2, sv - sr, zero)
                mixr = mixr + torch.where(mask2, sv + sr, zero)
        return torch.stack([mixl, mixr], dim=-1)

    @classmethod
    def _phase_ofs(cls, s, getb, sval, pscale, bits=32):
        """Phase offset of PM (``s.b``) and frequency-scaled PM
        (``s.c``) inputs, as u32 (or u64 bits in int64)."""
        s_pofs = cls._pofs(s, getb, sval)
        if s_pofs is None:
            return 0
        ofs = tdsp.ftoi(s_pofs * pscale)
        return ofs & M32 if bits == 32 else ofs

    @staticmethod
    def _pofs(s, getb, sval):
        """The float32 sum of the PM (``s.b``) and frequency-scaled PM
        (``s.c``) inputs, or None without either."""
        if s.c >= 0:
            if s.a in sval:
                # a per-row frequency: the compiled JAX form folds the
                # two broadcast factors first (see K_VMIX)
                fpm = getb(s.c) * (tdsp.HUMMID_INV * sval[s.a])[..., None]
            else:
                fpm = getb(s.c) * tdsp.HUMMID_INV * getb(s.a)
        if s.b >= 0 and s.c >= 0:
            s_pofs = getb(s.b) + fpm
        elif s.b >= 0:
            s_pofs = getb(s.b)
        elif s.c >= 0:
            s_pofs = fpm
        else:
            return None
        return s_pofs

    def _state_row(self, xs, j, si):
        """(active, first, last) of state stage ``si`` in chunk ``j``:
        a 0-d bool and two (1,) int64 flat indices, or per voice (V,)
        and (V, 1)."""
        k = self.state_pos[si]
        return (xs['act'][j][..., k], xs['first_ir'][j][..., k:k + 1],
                xs['last_ir'][j][..., k:k + 1])

    def _row_at(self, x, li, rows=None):
        """x (*lead, nc, B) at each row's index ``li`` (*lead, nc); a
        one-voice segment indexes the rows ``rows`` (arange(nc), made
        here if not given)."""
        if self.lead:
            return torch.gather(x, -1, li[..., None])[..., 0]
        if rows is None:
            rows = torch.arange(self.nc, device=self.device)
        return x[rows, li]

    def _wrun_stage(self, s, si, xs, j, cur, new_carry, vals, mask2,
                    ln):
        """Wave oscillator output (kernel 1) on the stage's phases held
        past each row's length; the phase carried in is the last active
        sample's (kernel 4 over the rows)."""
        nc, B = self.nc, self.B
        n = nc * B
        phase2 = vals[s.a]                          # (*lead, nc, B) u32
        li = torch.clamp(ln - 1, min=0)
        row_last = self._row_at(phase2, li)
        row_act = ln > 0
        has_act, fi, last_ir = self._state_row(xs, j, si)
        last = _row_last(row_act, self.plain)
        pp, ps, rst = ('%s%d' % (c, si) for c in ('pp', 'ps', 'rst'))
        yield from _exchange(cur, 'hold', (pp,),
                             lambda: _last_active(row_last, last))
        pp_in = cur[pp]
        row_hold = _row_hold(row_last, last, pp_in)
        held = torch.where(mask2, phase2, row_hold[..., None])
        ph_flat = held.reshape(self.lead + (n,))
        # an unconsumed reset (prepare/mode record) pairs the FIRST
        # ACTIVE sample with its own phase minus SLEN (wosc.h:215-231)
        yield from _exchange(cur, 'once', (rst,), lambda: has_act)
        rst_in = cur[rst]
        do_rst = rst_in & has_act
        rst_prev = (_take(ph_flat, fi) - (1 << tdsp.SLENBITS)) & M32
        fill = tdsp.wosc_s_filled_plain if self.plain \
            else tdsp.wosc_s_filled
        yield from _exchange(cur, 'provisional', (ps,))
        out = fill(self.piluts[s.wave], s.wave, ph_flat.reshape(self.V, n),
                   pp_in.reshape(self.V), cur[ps].reshape(self.V),
                   fi.reshape(self.V), do_rst.reshape(self.V),
                   rst_prev.reshape(self.V))
        out = self._unrow(out)
        # the pd == 0 hold's seed, where the chunks ran at once: the
        # samples before the first valid one hold the (NaN) seed
        if (yield from _exchange(cur, 'fill', (ps,),
                                lambda: out[..., -1])):
            out = torch.where(torch.isnan(out), cur[ps], out)
        ps_in = cur[ps]
        new_carry[pp] = row_hold[..., -1]
        new_carry[ps] = torch.where(has_act, _take(out, last_ir)[..., 0],
                                    ps_in)
        new_carry[rst] = rst_in & ~has_act
        vals[s.dst] = out.reshape(self.lead + (nc, B))

    def _wrun_self_stage(self, s, si, xs, j, cur, new_carry, vals,
                         getb, mask2):
        """wosc self-PM (wosc.h:273-310) as one masked sequential pass
        over each voice's flattened chunk (kernel 5, a row a voice):
        inactive samples output 0 and leave the state alone."""
        nc, B = self.nc, self.B
        n = nc * B
        has_act, fi, _ = self._state_row(xs, j, si)
        ph_flat = getb(s.a).reshape(self.V, n)
        am_flat = getb(s.b).reshape(self.V, n)
        rst_prev = (_take(ph_flat if self.lead else ph_flat[0], fi)[..., 0]
                    - (1 << tdsp.SLENBITS)) & M32
        yield from _exchange(cur, 'serial', tuple(
            '%s%d' % (c, si) for c in ('pp', 'ps', 'fb', 'rst')))
        # an unconsumed reset pairs the FIRST ACTIVE sample with its
        # own phase minus SLEN (wosc.h:215-231)
        rst = cur['rst%d' % si]
        pp0 = torch.where(rst & has_act, rst_prev, cur['pp%d' % si])
        run = tdsp.wosc_selfmod_plain if self.plain else tdsp.wosc_selfmod
        out, pp, ps, fb = run(
            self.piluts[s.wave], s.wave, ph_flat, am_flat,
            mask2.reshape(self.V, n), pp0.reshape(self.V),
            cur['ps%d' % si].reshape(self.V),
            cur['fb%d' % si].reshape(self.V))
        vals[s.dst] = out.reshape(self.lead + (nc, B))
        new_carry['pp%d' % si] = self._unrow(pp)
        new_carry['ps%d' % si] = self._unrow(ps)
        new_carry['fb%d' % si] = self._unrow(fb)
        new_carry['rst%d' % si] = rst & ~has_act

    def _rrun_self_stage(self, s, si, cur, new_carry, vals, getb,
                         mask2):
        """RasG self-PM (rasg.h:242-294, 764-772): a masked sequential
        pass over each voice's flattened chunk (kernel 6, a row a voice)
        on the K_RCYCLE stage's cycle (``s.a``) and phase (``s.dst``)
        fills and the self-PM amount (``s.b``)."""
        rline, func, level, alpha, oflags, _ = s.ras
        n = self.nc * self.B
        run = tdsp.rasg_selfmod_plain if self.plain else tdsp.rasg_selfmod
        yield from _exchange(cur, 'serial', ('ps%d' % si, 'fb%d' % si))
        out, ps, fb = run(
            func, rline, level, alpha, oflags,
            getb(s.dst).reshape(self.V, n), getb(s.a).reshape(self.V, n),
            getb(s.b).reshape(self.V, n), mask2.reshape(self.V, n),
            cur['ps%d' % si].reshape(self.V),
            cur['fb%d' % si].reshape(self.V))
        vals[s.dst] = out.reshape(self.lead + (self.nc, self.B))
        new_carry['ps%d' % si] = self._unrow(ps)
        new_carry['fb%d' % si] = self._unrow(fb)

    def _noise_stage(self, s, si, xs, j, cur, new_carry, vals, mask2,
                     idx_b):
        """sauNoiseG_run (noise.h:177-185) over the chunk: a counter
        hash per sample; red noise integrates (kernel 2, a row a
        voice), violet and blue-violet difference against the previous
        in-range sample."""
        nc, B = self.nc, self.B
        lead = self.lead
        dev = self.device
        ntype = s.ntype
        noff = xs['noff'][j][..., self.noise_pos[si], :]
        n = (self._bc(cur['nn%d' % si], 2) + noff[..., None] + idx_b) \
            & M32
        name = 'np%d' % si
        has_act, _, last_ir = self._state_row(xs, j, si)
        rows = None if lead else torch.arange(nc, device=dev)
        li = torch.clamp(mask2.sum(-1) - 1, min=0)
        row_act = mask2.any(-1)

        def held_flat(r, last, seed):
            # r held at the row's last in-range value past its length
            hold = _row_hold(self._row_at(r, li, rows), last, seed)
            return torch.where(mask2, r, hold[..., None]) \
                .reshape(lead + (nc * B,))

        def prev_of(flat, seed):
            return torch.cat([seed[..., None], flat[..., :-1]], -1)

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
            part = scan(inc.reshape(lead + (nc * B,)))
            yield from _exchange(cur, 'add32', (name,),
                                 lambda: part[..., -1])
            nprev = cur[name]
            sums = (self._bc(nprev, 1) + part) & M32
            out = (tdsp.asi32(tdsp.foldhd32(sums)).to(F32)
                   * tdsp.SCALE31).reshape(lead + (nc, B))
            new_carry[name] = torch.where(has_act, sums[..., -1], nprev)
        elif ntype == N_VI:
            r0 = tdsp.ranfast32(n)
            last = _row_last(row_act, self.plain)
            yield from _exchange(
                cur, 'hold', (name,),
                lambda: _last_active(self._row_at(r0, li, rows), last))
            nprev = cur[name]
            r = held_flat(r0, last, nprev)
            d = ((r >> 1) - (prev_of(r, nprev) >> 1)) & M32
            out = (tdsp.asi32(d).to(F32) * tdsp.SCALE31) \
                .reshape(lead + (nc, B))
            new_carry[name] = torch.where(
                has_act, _take(r, last_ir)[..., 0], nprev)
        else:  # N_BV
            sb = torch.where((n & 1) != 0, sign1(tdsp.ranfast32(n)),
                             torch.zeros((), dtype=I64, device=dev))
            last = _row_last(row_act, self.plain)

            def pub():
                act, v = _last_active(self._row_at(sb, li, rows), last)
                return act, v & M32
            yield from _exchange(cur, 'hold', (name,), pub)
            nprev = cur[name]
            seed = tdsp.asi32(nprev)
            h = held_flat(sb, last, seed)
            out = (h - prev_of(h, seed)).to(F32).reshape(lead + (nc, B))
            new_carry[name] = torch.where(
                has_act, _take(h, last_ir)[..., 0] & M32, nprev)
        vals[s.dst] = out

    def _fini_writes(self):
        """The state cells the carries go back to, in stage order:
        ('sf' or 'si', column, stage, value of (carry, dyn))."""
        out = []
        for si, s in enumerate(self.ep.stages):
            def c(name, si=si):
                return lambda carry, dyn: carry[name % si]
            if s.kind == K_WPHASE:
                out.append(('si', C_PHASE, si, c('ph%d')))
            elif s.kind == K_RCYCLE:
                out += [('si', C_RCPLO, si, lambda carry, dyn, si=si:
                         carry['cp%d' % si] & M32),
                        ('si', C_RCPHI, si, lambda carry, dyn, si=si:
                         (carry['cp%d' % si] >> 32) & M32)]
            elif s.kind in (K_WRUN, K_WRUN_SELF):
                out += [('si', C_WPPH, si, c('pp%d')),
                        ('sf', C_WPS, si, c('ps%d')),
                        ('si', C_WRESET, si, None)]
                if s.kind == K_WRUN_SELF:
                    out.append(('sf', C_WFB, si, c('fb%d')))
            elif s.kind == K_RRUN_SELF:
                out += [('sf', C_RPS, si, c('ps%d')),
                        ('sf', C_RFB, si, c('fb%d'))]
            elif s.kind == K_NOISE:
                # the counter carry stays at its segment-start value and
                # the offsets are segment-relative: add the total once
                k = self.noise_pos[si]
                out += [('si', C_NN, si, lambda carry, dyn, si=si, k=k:
                         (carry['nn%d' % si] + dyn['ntot'][..., k]) & M32),
                        ('si', C_NPREV, si, c('np%d'))]
        return out

    def _fini(self, st, carry, dyn):
        """Write the carries back to the state (gated by stage
        activity) and the host-authoritative columns from the host
        simulation's end tables."""
        if self.lead:
            return self._fini_voices(st, carry, dyn)
        sf = st['sf'].clone()
        si_arr = st['si'].clone()
        arrs = {'sf': sf, 'si': si_arr}
        writes = self._fini_writes()
        if self.fini_cells_unique:
            # each cell written once: one gather, select and scatter
            # per array, the cells and gates from the segment's tables
            for name in ('sf', 'si'):
                vals = [fn(carry, dyn) if fn is not None
                        else torch.zeros((), dtype=I64, device=sf.device)
                        for a, _col, _si, fn in writes if a == name]
                if not vals:
                    continue
                arr = arrs[name]
                cells = (dyn['wb_%s_op' % name], dyn['wb_%s_col' % name])
                v = torch.stack(vals)
                v = v if name == 'sf' else i32(v)
                arr.index_put_(cells, torch.where(
                    dyn['wb_%s_act' % name], v, arr[cells]))
        else:
            ops = dyn['ops']
            for name, col, si, fn in writes:
                arr = arrs[name]
                op = ops[si:si + 1]
                v = 0 if fn is None else fn(carry, dyn)
                v = v if name == 'sf' or fn is None else i32(v)
                arr[op, col] = torch.where(dyn['sact'][si], v,
                                           arr[op, col])
        if not self.end_tables:
            return {'sf': sf, 'si': si_arr, 'vdur': st['vdur']}
        write_end_tables(sf, si_arr, {k: dyn['end_' + k]
                                      for k in END_TABLES})
        return {'sf': sf, 'si': si_arr, 'vdur': dyn['end_vdur'].clone()}

    def _fini_voices(self, st, carry, dyn):
        """_fini of V voices (no end tables): each voice's carries go
        to its own operators' rows; the cells of an inactive stage are
        routed to a spare row past the operators (see stack), which is
        dropped."""
        arrs = {name: torch.cat([st[name], st[name][:1]])
                for name in ('sf', 'si')}
        zero = torch.zeros(self.lead, dtype=I64, device=self.device)
        writes = self._fini_writes()
        for name, arr in arrs.items():
            vals = [(si, col, zero if fn is None else fn(carry, dyn))
                    for a, col, si, fn in writes if a == name]
            if not vals:
                continue
            if name == 'si':
                vals = [(si, col, i32(v)) for si, col, v in vals]
            if self.fini_cells_unique:
                # each cell written once: one scatter of (V, k) cells
                arr.index_put_((dyn['wb_%s_op' % name],
                                dyn['wb_%s_col' % name]),
                               torch.stack([v for _, _, v in vals], -1))
            else:
                for si, col, v in vals:
                    arr[dyn['wb_ops'][:, si], col] = v
        return {'sf': arrs['sf'][:-1], 'si': arrs['si'][:-1],
                'vdur': st['vdur']}

    def _fused(self, st, dyn, xs_list):
        """The whole segment (JAX's fused_fn): returns (st', (*lead,
        ng * gch * nc, B, 2) f32, padding included)."""
        st, carry = self._init(st, dyn)
        outs = []
        for xs in xs_list:
            carry, o = self._group(carry, xs)
            outs.append(o.reshape(self.lead + (-1, self.B, 2)))
        return self._fini(st, carry, dyn), torch.cat(outs, len(self.lead))

    # -- bodies of the captured steps (functions of tensors only) ----------

    def fused_body(self, conv):
        """Body of the whole-segment graph: (sf, si, vdur, dyn buffers,
        every group's buffers) -> the padded output, converted (see
        with_conv); the new state is written into sf, si and vdur."""
        dyn_t, xs_t = self.dyn, self.xs

        def body(sf, si, vdur, *bufs):
            nd = len(dyn_t.host)
            dyn = dyn_t.views(bufs[:nd])
            xs_list = []
            pos = nd
            for t in xs_t:
                xs_list.append(t.views(bufs[pos:pos + len(t.host)]))
                pos += len(t.host)
            st, out = self._fused({'sf': sf, 'si': si, 'vdur': vdur},
                                  dyn, xs_list)
            _write_state((sf, si, vdur), st)
            return out
        return with_conv(body, conv)

    def init_body(self):
        """Body of the init graph: (sf, si, vdur, carry buffers..., dyn
        buffers) -> None, state and carries written in place."""
        spec = self.carry_spec()

        def body(sf, si, vdur, *bufs):
            cbufs = bufs[:len(spec)]
            st, carry = self._init({'sf': sf, 'si': si, 'vdur': vdur},
                                   self.dyn.views(bufs[len(spec):]))
            _write_state((sf, si, vdur), st)
            for (name, _dt), b in zip(spec, cbufs):
                b.copy_(carry[name])
        return body

    def group_body(self, conv):
        """Body of the chunk-group graph (JAX's scan_fn): (carry
        buffers..., group buffers) -> the (gch * nc, B, 2) output,
        converted (see with_conv), carries updated in place."""
        spec = self.carry_spec()

        def body(*bufs):
            cbufs = bufs[:len(spec)]
            carry = {name: b for (name, _dt), b in zip(spec, cbufs)}
            new, out = self._group(carry,
                                   self.xs[0].views(bufs[len(spec):]))
            for (name, _dt), b in zip(spec, cbufs):
                if new[name] is not b:
                    b.copy_(new[name])
            return out.reshape(self.lead + (-1, self.B, 2))
        return with_conv(body, conv)

    def fini_body(self):
        """Body of the fini graph: (sf, si, vdur, carry buffers..., dyn
        buffers) -> None, state written in place."""
        spec = self.carry_spec()

        def body(sf, si, vdur, *bufs):
            carry = {name: b for (name, _dt), b in zip(spec, bufs)}
            st = self._fini({'sf': sf, 'si': si, 'vdur': vdur}, carry,
                            self.dyn.views(bufs[len(spec):]))
            _write_state((sf, si, vdur), st)
        return body

    # -- public API ---------------------------------------------------------

    def run(self, st):
        """Render the whole segment op by op on its own tables; returns
        (st', (nb, B, 2) f32)."""
        self.prepare()
        st, out = self._fused(st, self.dyn.views(),
                              [t.views() for t in self.xs])
        return st, out[..., :self.nb, :, :]

    def stream(self, disp, conv):
        """Yield ((k, B, 2) or (k, B) converted output, n_valid_blocks)
        per chunk group in order, through ``disp`` (graphs.Dispatch) on
        the state buffers ``disp.st``: one graph for the whole segment
        when it is one group (JAX's fused_fn), else init, one graph per
        chunk group (scan_fn) and fini. Device memory is bounded by one
        group whatever the segment's length. A yielded output is a
        graph's static output: consume it before the next step."""
        tmpl = disp.template(self)
        st = disp.st
        if self.ng == 1:
            out = disp.run(('fused', self.key, 1, conv),
                           tmpl.fused_body(conv), disp.state(conv),
                           self.tables())
            yield out, self.nb
            return
        carry = disp.carry(tmpl)
        disp.run(('init', self.key), tmpl.init_body(), st + carry,
                 self.dyn.bufs)
        done = 0
        for g in range(self.ng):
            out = disp.run(('group', self.key, conv),
                           tmpl.group_body(conv),
                           disp.accs(conv) + carry,
                           self.xs[g].bufs)
            n_valid = min(self.nb - done, self.gch * self.nc)
            yield out, n_valid
            done += n_valid
        disp.run(('fini', self.key), tmpl.fini_body(), st + carry,
                 self.dyn.bufs)

    def tables(self):
        """Every uploaded table buffer of the segment: its own, then
        each chunk group's."""
        return tuple(self.dyn.bufs) + tuple(b for t in self.xs
                                            for b in t.bufs)


# the host simulation's segment-end tables (hostsim.SegBake.end_*)
END_TABLES = ('lv0', 'lvt', 'lpos', 'lend', 'ltype', 'lflags', 'time',
              'tinf', 'vdur')


def write_end_tables(sf, si, end):
    """Write the host-authoritative columns (line slots, time) of the
    state arrays ``sf`` and ``si`` from the end tables ``end`` (name ->
    tensor, END_TABLES); the caller sets vdur from ``end['vdur']``."""
    sf[:, C_LV0:C_LV0 + 6] = end['lv0']
    sf[:, C_LVT:C_LVT + 6] = end['lvt']
    si[:, C_LPOS:C_LPOS + 6] = end['lpos']
    si[:, C_LEND:C_LEND + 6] = end['lend']
    si[:, C_LTYPE:C_LTYPE + 6] = end['ltype']
    si[:, C_LFLAGS:C_LFLAGS + 6] = end['lflags']
    si[:, C_TIME] = end['time']
    si[:, C_TINF] = end['tinf']


def _write_state(bufs, st):
    """Write state ``st`` into the buffers (sf, si, vdur)."""
    for b, k in zip(bufs, ('sf', 'si', 'vdur')):
        if st[k] is not b:
            b.copy_(st[k])


# -- grouped segments (flat.py:1052-1159 of the JAX renderer) ----------------

def plan_groups(segs):
    """Partition a segment list into runs of consecutive segments that
    share one captured template (equal ``key`` and chunk-group count),
    bounded by GROUP_OUT_CAP of f32 output."""
    groups = []
    i = 0
    while i < len(segs):
        s0 = segs[i]
        j = i + 1
        bytes_per = s0.ng * s0.gch * s0.nc * s0.B * 8
        total = bytes_per
        while j < len(segs) and segs[j].key == s0.key \
                and segs[j].ng == s0.ng \
                and total + bytes_per <= GROUP_OUT_CAP:
            total += bytes_per
            j += 1
        groups.append(segs[i:j])
        i = j
    return groups


def group_stacked_args(group):
    """The device tables of each segment of a group, as the group's
    graph takes them: the segments' own uploaded buffers, copied into
    the graph's static inputs before each replay (device to device; no
    restacking on the host)."""
    return [s_.tables() for s_ in group]


def split_group_outs(group, outs):
    """Per-segment (nb, B, ...) views of a group's padded outputs."""
    return [o[:s_.nb] for s_, o in zip(group, outs)]


def run_segments_grouped(segs, disp, conv='i16'):
    """Render a list of FlatSegments in order through ``disp``, on its
    state buffers, yielding (seg, (nb, B, ...) converted output) per
    segment. Consecutive segments that share one template replay ONE
    captured whole-segment graph, each with its own tables copied in.
    An output is the graph's static output: consume it before the
    next."""
    for group in plan_groups(segs):
        tmpl = disp.template(group[0])
        body = tmpl.fused_body(conv)
        key = ('fused', group[0].key, group[0].ng, conv)
        for s_, args in zip(group, group_stacked_args(group)):
            out = disp.run(key, body, disp.state(conv), args)
            yield s_, None if out is None \
                else split_group_outs([s_], [out])[0]
