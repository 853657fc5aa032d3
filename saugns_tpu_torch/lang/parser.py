"""SAU script parser: recursive-descent, single-pass, producing the
flat Program IR via interleaved parse-tree conversion.

Behavioral port of sau/parser.c. Structure follows the reference's
parse levels and sub-parsers; timing resolution (time_durgroup /
time_event / flatten_events, sau/parser.c:2128-2379) ported exactly --
it is the subtlest logic in the frontend.
"""
from __future__ import annotations

import math

from . import notes
from . import program as P
from . import script as S
from .parseconv import ParseConv
from .program import Line, Program, RasOpt, ScriptArg, Time
from .scanner import (SCAN_LNBRK, SCAN_SPACE, WS_NONE, Scanner, is_alpha,
                      is_digit)
from .symtab import (DATA_ID, DATA_NONE, DATA_NUM, DATA_OBJ, SYM_LABEL,
                     SYM_LINE_ID, SYM_MATH_ID, SYM_NOISE_ID, SYM_TYPELABELS,
                     SYM_VAR, SYM_WAVE_ID, Symtab)
from ..dsp import prim
from ..dsp.lines import LINE_NAMES, N_lin as LINE_N_lin
from ..dsp.prim import MathState
from ..dsp.wavetables import WAVE_NAMES

NOISE_NAMES = P.NOISE_NAMES


def F32(x):
    """Round to C float precision (parse-tree fields are float)."""
    import numpy as _np
    return float(_np.float32(x))


class ScanLookup:
    """struct ScanLookup (sau/parser.c:68-71)."""

    def __init__(self, arg: ScriptArg, st: Symtab):
        self.sopt = S.ScriptOptions()
        self.math_state = MathState()
        st.add_stra(prim.MATH_NAMES, SYM_MATH_ID, 0)
        st.add_stra(prim.MATH_VARS_NAMES, SYM_VAR, 1)
        st.add_stra(LINE_NAMES, SYM_LINE_ID, 0)
        st.add_stra(WAVE_NAMES, SYM_WAVE_ID, 0)
        st.add_stra(NOISE_NAMES, SYM_NOISE_ID, 0)
        for key, val in arg.predef:
            sstr = st.get_symstr(key)
            item = st.find_item(sstr, SYM_VAR) or st.add_item(sstr, SYM_VAR)
            item.num = val
            item.data_use = DATA_NUM
            if item.data_id > 0:
                prim.MATH_VARS_SYMBOLS[item.data_id - 1](self.math_state,
                                                         val)
        self.math_state.no_time = arg.no_time


# -- numerical expression parsing (sau/parser.c:283-466) ----------------------

NUMEXP_SUB = 0
NUMEXP_ADT = 1
NUMEXP_MLT = 2
NUMEXP_POW = 3
NUMEXP_NUM = 4


class NumParser:
    def __init__(self, sc, numconst_f, skip_num=False):
        self.sc = sc
        self.numconst_f = numconst_f
        self.sf_start = sc.sf.copy()
        self.skip_num = skip_num
        self.has_nannum = False
        self.has_infnum = False
        self.after_rpar = False

    def scan(self, pri, level):
        sc = self.sc
        sl = sc.data
        ws_level = sc.ws_level
        if level == 1 and ws_level != WS_NONE:
            sc.ws_level = WS_NONE
        num = math.nan
        reject = False
        c = sc.getc()
        if c == '(':
            num = self.scan(NUMEXP_SUB, level + 1)
        elif c == '+' or c == '-':
            num = self.scan(NUMEXP_ADT, level)
            if math.isnan(num):
                sc.ungetc()
                if ws_level != sc.ws_level:
                    sc.ws_level = ws_level
                return num
            if c == '-':
                num = -num
        elif c == '$':
            var = scan_numvar(sc)
            if var is None:
                reject = True
            else:
                num = var.num
        else:
            sc.ungetc()
            num, read_len = sc.getd(False, self.numconst_f)
            if read_len == 0:
                func_id = None
                if is_alpha(c):
                    func_id = scan_mathfunc(sc)
                if func_id is None:
                    reject = True  # silent NaN
                else:
                    ptype = prim.MATH_PARAMS[func_id]
                    if ptype == prim.MATH_VAL_F:
                        num = self.scan(NUMEXP_SUB, level + 1)
                        if not self.skip_num:
                            try:
                                num = prim.MATH_SYMBOLS[func_id](num)
                            except (ValueError, OverflowError):
                                num = math.nan
                    elif ptype == prim.MATH_STATE_F:
                        sc.skipws()
                        if not sc.tryc(')'):
                            sc.warning(None,
                                       "math function '%s()' takes no "
                                       "arguments"
                                       % prim.MATH_NAMES[func_id])
                            reject = True
                        elif not self.skip_num:
                            num = prim.MATH_SYMBOLS[func_id](sl.math_state)
                    elif ptype == prim.MATH_NOARG_F:
                        if not self.skip_num:
                            num = prim.MATH_SYMBOLS[func_id]()
            if not reject and math.isnan(num):
                self.has_nannum = True
                reject = True
        if reject:
            num = math.nan
            if ws_level != sc.ws_level:
                sc.ws_level = ws_level
            return num
        if pri == NUMEXP_NUM:
            if ws_level != sc.ws_level:
                sc.ws_level = ws_level
            return num
        while True:
            rpar_mlt = False
            if math.isinf(num):
                self.has_infnum = True
            c = sc.getc()
            if pri < NUMEXP_MLT:
                rpar_mlt = self.after_rpar
                self.after_rpar = False
            defer = False
            if c == '(':
                if pri >= NUMEXP_MLT:
                    defer = True
                else:
                    num = _mul(num, self.scan(NUMEXP_SUB, level + 1))
            elif c == ')':
                if pri != NUMEXP_SUB or level == 0:
                    defer = True
                else:
                    self.after_rpar = True
                    break  # ACCEPT
            elif c == '^':
                if pri > NUMEXP_POW:
                    defer = True
                else:
                    num = _pow(num, self.scan(NUMEXP_POW, level))
            elif c == '*':
                if pri >= NUMEXP_MLT:
                    defer = True
                else:
                    num = _mul(num, self.scan(NUMEXP_MLT, level))
            elif c == '/':
                if pri >= NUMEXP_MLT:
                    defer = True
                else:
                    num = _div(num, self.scan(NUMEXP_MLT, level))
            elif c == '%':
                if pri >= NUMEXP_MLT:
                    defer = True
                else:
                    num = _fmod(num, self.scan(NUMEXP_MLT, level))
            elif c == '+':
                if pri >= NUMEXP_ADT:
                    defer = True
                else:
                    num = num + self.scan(NUMEXP_ADT, level)
            elif c == '-':
                if pri >= NUMEXP_ADT:
                    defer = True
                else:
                    num = num - self.scan(NUMEXP_ADT, level)
            else:
                if rpar_mlt and c != SCAN_SPACE and c != SCAN_LNBRK:
                    sc.ungetc()
                    rval = self.scan(NUMEXP_MLT, level)
                    if math.isnan(rval):
                        break  # ACCEPT
                    num = _mul(num, rval)
                else:
                    if pri == NUMEXP_SUB and level > 0:
                        sc.warning(self.sf_start,
                                   "numerical expression has '(' without "
                                   "closing ')'")
                    defer = True
            if defer:
                sc.ungetc()
                break
            if math.isnan(num):
                self.has_nannum = True
                sc.ungetc()
                break
        if ws_level != sc.ws_level:
            sc.ws_level = ws_level
        return num


def _mul(a, b):
    return a * b


def _div(a, b):
    if b == 0:
        if math.isnan(a) or math.isnan(b):
            return math.nan
        if a == 0:
            return math.nan
        return math.copysign(math.inf, a) * math.copysign(1.0, b)
    return a / b


def _fmod(a, b):
    try:
        return math.fmod(a, b)
    except ValueError:
        return math.nan


def _pow(a, b):
    try:
        return math.pow(a, b)
    except (ValueError, OverflowError):
        # C pow: pow(negative, non-integer) -> NaN; overflow -> inf
        if math.isnan(a) or math.isnan(b):
            return math.nan
        return math.nan


def scan_num(sc, numconst_f=None):
    """sau/parser.c:437-456. Returns float or None."""
    np_ = NumParser(sc, numconst_f)
    num = np_.scan(NUMEXP_SUB, 0)
    if np_.has_nannum:
        sc.warning(np_.sf_start,
                   "discarding expression containing NaN value")
        return None
    if math.isnan(num):
        return None
    if math.isinf(num):
        np_.has_infnum = True
    if np_.has_infnum:
        sc.warning(np_.sf_start,
                   "discarding expression with infinite number")
        return None
    return num


def skip_num(sc, numconst_f=None):
    """sau/parser.c:457-466. Returns True if something was read."""
    np_ = NumParser(sc, numconst_f, skip_num=True)
    num = np_.scan(NUMEXP_SUB, 0)
    if np_.has_nannum:
        return True
    if math.isnan(num):
        return False
    return True


def scan_time_val(sc):
    """sau/parser.c:468-480. Returns ms int or None."""
    sf = sc.sf.copy()
    val = scan_num(sc)
    if val is None:
        return None
    if val < 0.0:
        sc.warning(sf, "discarding negative time value")
        return None
    return prim.ui32rint(val * 1000.0)


def scan_int_in_range(sc, vmin, vmax, fallback, name):
    """sau/parser.c:482-497. Returns int or None."""
    sf = sc.sf.copy()
    num, num_len = sc.geti(False)
    if num_len == 0:
        return None
    if num < vmin or num > vmax:
        sc.warning(sf, "invalid %s, using %d (valid range %d-%d)"
                   % (name, fallback, vmin, vmax))
        num = fallback
    return num


def scan_chanmix_const(sc, val_out):
    c = sc.file_getc()
    if c == 'C':
        val_out[0] = 0.0
        return 1
    if c == 'L':
        val_out[0] = -1.0
        return 1
    if c == 'R':
        val_out[0] = 1.0
        return 1
    sc.file_decp()
    return 0


def scan_cyclepos_const(sc, val_out):
    c = sc.file_getc()
    if c == 'G':
        val_out[0] = prim.GLDA_1_2PI
        return 1
    sc.file_decp()
    return 0


def scan_sym(sc, type_id, help_stra, optional):
    """sau/parser.c:226-254."""
    type_label = SYM_TYPELABELS[type_id]
    s = sc.get_symstr()
    if s is not None:
        item = sc.symtab.find_item(s, type_id)
        if item is None:
            if type_id <= SYM_LABEL:
                item = sc.symtab.add_item(s, type_id)
                return item
        else:
            return item
    if s is None:
        if optional:
            return None
        msg = ("%s name missing; available are:" if help_stra
               else "%s name missing") % type_label
        sc.warning(None, msg)
        if help_stra:
            _print_names(help_stra)
    elif help_stra:
        sc.warning_at(0, "invalid %s name '%s'; available are:"
                      % (type_label, s.key))
        _print_names(help_stra)
    return None


def _print_names(stra):
    import sys
    from ..utils.help import print_names
    print_names(stra, '\t', sys.stderr)


def scan_mathfunc(sc):
    """sau/parser.c:256-269. Returns func id or None."""
    sym = scan_sym(sc, SYM_MATH_ID, prim.MATH_NAMES, False)
    if sym is None:
        return None
    if prim.MATH_PARAMS[sym.data_id] == prim.MATH_NOARG_F or sc.tryc('('):
        return sym.data_id
    sc.warning(None, "expected '(' following math function name '%s'"
               % prim.MATH_NAMES[sym.data_id])
    return None


def scan_numvar(sc):
    """sau/parser.c:270-281."""
    var = scan_sym(sc, SYM_VAR, None, False)
    if var is None:
        return None
    if var.data_use != DATA_NUM:
        sc.warning(None, "variable '$%s' in numerical expression doesn't "
                   "hold a number" % var.sstr.key)
        return None
    return var


def scan_sym_id(sc, type_id, help_stra):
    """sau/parser.c:754-762. Returns id or None."""
    sym = scan_sym(sc, type_id, help_stra, True)
    if sym is None:
        return None
    return sym.data_id


def scan_line_state(sc, numconst_f, line, ratio):
    """sau/parser.c:764-777."""
    v0 = scan_num(sc, numconst_f)
    if v0 is None:
        return False
    line.v0 = F32(v0)
    line.flags |= P.LINEP_STATE
    if ratio:
        line.flags |= P.LINEP_STATE_RATIO
    else:
        line.flags &= ~P.LINEP_STATE_RATIO
    return True


# -- parser -------------------------------------------------------------------

SCOPE_SAME = 0
SCOPE_GROUP = 1
SCOPE_BIND = 2
SCOPE_NEST = 3

PL_BIND_MULTIPLE = 1 << 0
PL_NEW_EVENT_FORK = 1 << 1
PL_OWN_EV = 1 << 2
PL_OWN_OP = 1 << 3
PL_WARN_NOSPACE = 1 << 4

DEF_SOPT = S.ScriptOptions()


class NestScope:
    """struct NestScope (sau/parser.c:783-791)."""
    __slots__ = ('list', 'last_mods', 'last_item', 'sopt_save', 'op_sweep',
                 'numconst_f', 'num_ratio')

    def __init__(self):
        self.list = None
        self.last_mods = None
        self.last_item = None
        self.sopt_save = None
        self.op_sweep = None
        self.numconst_f = None
        self.num_ratio = False


class ParseLevel:
    """struct ParseLevel (sau/parser.c:879-892)."""
    __slots__ = ('parent', 'sub_f', 'pl_flags', 'scope', 'close_c',
                 'use_type', 'event', 'operator', 'ev_last', 'set_label',
                 'main_ev', 'add_wait_ms', 'carry_wait_ms', 'used_ampmult')

    def __init__(self):
        self.parent = None
        self.sub_f = None
        self.pl_flags = 0
        self.scope = 0
        self.close_c = ''
        self.use_type = 0
        self.event = None
        self.operator = None
        self.ev_last = None
        self.set_label = None
        self.main_ev = None
        self.add_wait_ms = 0
        self.carry_wait_ms = 0
        self.used_ampmult = 1.0


class Parser:
    def __init__(self, arg: ScriptArg):
        self.st = Symtab()
        self.sc = Scanner(self.st)
        self.sl = ScanLookup(arg, self.st)
        self.sc.data = self.sl
        self.sc.hash_filter = True
        self.nest = []  # stack of NestScope
        self.cur_pl = None
        self.events = None
        self.last_event = None
        self.group_event = None
        self.script_fail = False
        self.root_op_obj = 0
        self.obj_arr = []  # list[S.ObjInfo]
        self.pc = ParseConv()

    # -- object/event management ------------------------------------------

    def objinfo_add(self, ref, obj_type, op_type):
        info = S.ObjInfo()
        ref.obj_id = len(self.obj_arr)
        info.obj_type = ref.obj_type = obj_type
        info.op_type = ref.op_type = op_type
        info.last_vo_id = ref.vo_id = P.PVO_NO_ID
        self.obj_arr.append(info)
        return info

    def create_line(self, mult, par_flag):
        """sau/parser.c:913-955."""
        sl = self.sl
        line = Line()
        line.type = LINE_N_lin  # default if goal enabled
        v0 = 0.0
        if par_flag == P.PSWEEP_PAN:
            v0 = sl.sopt.def_chanmix
        elif par_flag == P.PSWEEP_AMP:
            v0 = 1.0
        elif par_flag == P.PSWEEP_AMP2:
            v0 = 0.0
        elif par_flag == P.PSWEEP_FREQ:
            v0 = sl.sopt.def_relfreq if mult else sl.sopt.def_freq
        elif par_flag == P.PSWEEP_FREQ2:
            v0 = 0.0
        elif par_flag == P.PSWEEP_PMA:
            v0 = 0.0
        else:
            return None
        line.v0 = F32(v0)
        line.time_ms = sl.sopt.def_time_ms
        line.flags |= (P.LINEP_STATE | P.LINEP_TYPE | P.LINEP_TIME |
                       P.LINEP_TIME_IF_NEW)
        if mult:
            line.flags |= P.LINEP_STATE_RATIO
        return line

    def parse_waittime(self):
        pl = self.cur_pl
        wait_ms = scan_time_val(self.sc)
        if wait_ms is None:
            return False
        pl.add_wait_ms += wait_ms
        return True

    def end_operator(self):
        """sau/parser.c:970-992."""
        pl = self.cur_pl
        if not (pl.pl_flags & PL_OWN_OP):
            return
        pl.pl_flags &= ~PL_OWN_OP
        op = pl.operator
        if op.amp is not None:
            op.amp.v0 = F32(F32(op.amp.v0) * F32(pl.used_ampmult))
            op.amp.vt = F32(F32(op.amp.vt) * F32(pl.used_ampmult))
        if op.amp2 is not None:
            op.amp2.v0 = F32(F32(op.amp2.v0) * F32(pl.used_ampmult))
            op.amp2.vt = F32(F32(op.amp2.vt) * F32(pl.used_ampmult))
        if op.prev_ref is None:
            op.params = P.POP_PARAMS
        pl.operator = None

    def end_event(self):
        pl = self.cur_pl
        if not (pl.pl_flags & PL_OWN_EV):
            return
        pl.pl_flags &= ~PL_OWN_EV
        self.end_operator()
        pl.ev_last = None
        pl.event = None

    def begin_event(self, prev_data, is_compstep):
        """sau/parser.c:1004-1044."""
        pl = self.cur_pl
        self.end_event()
        e = S.EvData()
        pl.event = e
        e.wait_ms = pl.add_wait_ms + pl.carry_wait_ms
        pl.add_wait_ms = 0
        pl.carry_wait_ms = 0
        if prev_data is not None:
            pve = prev_data.event
            if prev_data.op_flags & S.SDOP_NESTED:
                e.ev_flags |= S.SDEV_IMPLICIT_TIME
            if is_compstep:
                if pl.pl_flags & PL_NEW_EVENT_FORK:
                    if pl.main_ev is None:
                        pl.main_ev = pve
                    pl.main_ev.forks = S.EvBranch(e, pl.main_ev.forks)
                    pl.pl_flags &= ~PL_NEW_EVENT_FORK
                else:
                    pve.next = e
        if not is_compstep:
            if self.events is None:
                self.events = e
            else:
                self.last_event.next = e
            self.last_event = e
            pl.main_ev = None
        if self.group_event is None:
            self.group_event = pl.main_ev if pl.main_ev is not None else e
        pl.pl_flags |= PL_OWN_EV

    def prepare_event(self, prev_obj, is_compstep):
        """sau/parser.c:1050-1058."""
        pl = self.cur_pl
        nest_tip = self.nest[-1] if self.nest else None
        if (pl.event is None or pl.add_wait_ms > 0 or
                ((prev_obj is not None or nest_tip is None)
                 and pl.event.main_obj is not None) or
                is_compstep):
            self.begin_event(prev_obj, is_compstep)

    def link_ev_obj(self, pl, nest, obj, prev):
        """sau/parser.c:1065-1092. ``obj``/``prev`` are owner objects
        (OpData/ListData); refs are their .ref members."""
        e = pl.event
        obj.ref.next = None
        if prev is not None or nest is None:
            if e.main_obj is None:
                e.main_obj = obj
            else:
                pl.ev_last.ref.next = obj
            pl.ev_last = obj
        else:
            if nest.list.first_item is None:
                nest.list.first_item = obj
            else:
                nest.last_item.ref.next = obj
            nest.last_item = obj
        if pl.set_label is not None:
            pl.set_label.data_use = DATA_OBJ
            pl.set_label.obj = obj
            pl.set_label = None

    def begin_list(self, plist, use_type):
        """sau/parser.c:1097-1125. ``plist`` always None in current code."""
        pl = self.cur_pl
        parent_pl = pl.parent
        nest = self.nest[-1]
        nest.list = S.ListData()
        nest.list.use_type = use_type
        pl.sub_f = self.parse_in_par_sweep if nest.op_sweep is not None \
            else None
        info = self.objinfo_add(nest.list.ref, P.POBJT_LIST, 0)
        if use_type == P.POP_N_carr:
            outer_nest = self.nest[-2] if len(self.nest) > 1 else None
            self.link_ev_obj(parent_pl, outer_nest, nest.list, plist)
        else:
            parent_on = parent_pl.operator
            parent_on.mods.append(nest.list)
            nest.last_mods = nest.list
            info.parent_op_obj = parent_on.ref.obj_id

    def begin_operator(self, pop, is_compstep, op_type):
        """sau/parser.c:1127-1189."""
        self.prepare_event(pop, is_compstep)
        pl = self.cur_pl
        nest = self.nest[-1] if self.nest else None
        e = pl.event
        self.end_operator()
        op = S.OpData()
        pl.operator = op
        if not is_compstep:
            pl.pl_flags |= PL_NEW_EVENT_FORK
        pl.used_ampmult = self.sl.sopt.def_ampmult
        if pop is not None:
            op.ref.obj_id = pop.ref.obj_id
            op.ref.obj_type = pop.ref.obj_type
            op.ref.op_type = pop.ref.op_type
            op.ref.vo_id = pop.ref.vo_id
            op.prev_ref = pop
            op.op_flags = pop.op_flags & (S.SDOP_NESTED | S.SDOP_MULTIPLE)
            op.time = Time(pop.time.v_ms,
                           P.TIMEP_DEFAULT |
                           (pop.time.flags & P.TIMEP_IMPLICIT))
            op.mode_main = pop.mode_main
            op.mode_ras = RasOpt(line=pop.mode_main)
            if pl.pl_flags & PL_BIND_MULTIPLE:
                mpop = pop
                max_time = 0
                while mpop is not None:
                    if max_time < mpop.time.v_ms:
                        max_time = mpop.time.v_ms
                    mpop = mpop.ref.next
                op.op_flags |= S.SDOP_MULTIPLE
                op.time.v_ms = max_time
                pl.pl_flags &= ~PL_BIND_MULTIPLE
        else:
            is_nested = pl.use_type != P.POP_N_carr
            info = self.objinfo_add(op.ref, P.POBJT_OP, op_type)
            if P.pop_has_seed(op_type):
                op.seed = info.seed = self.sl.math_state.rand32()
            op.time = Time(self.sl.sopt.def_time_ms,
                           P.TIMEP_DEFAULT |
                           (P.TIMEP_IMPLICIT if is_nested else 0))
            if not is_nested:
                self.root_op_obj = op.ref.obj_id
                op.pan = self.create_line(False, P.PSWEEP_PAN)
                op.freq = self.create_line(False, P.PSWEEP_FREQ)
            else:
                op.op_flags |= S.SDOP_NESTED
                op.freq = self.create_line(True, P.PSWEEP_FREQ)
            info.root_op_obj = self.root_op_obj
            info.parent_op_obj = (
                self.obj_arr[nest.list.ref.obj_id].parent_op_obj
                if (is_nested and nest is not None) else op.ref.obj_id)
            op.amp = self.create_line(False, P.PSWEEP_AMP)
        self.link_ev_obj(pl, nest, op, pop)
        op.event = e
        pl.pl_flags |= PL_OWN_OP

    def finish_durgroup(self):
        """sau/parser.c:1195-1202."""
        pl = self.cur_pl
        pl.add_wait_ms = 0
        if self.group_event is None:
            return
        carry = [pl.carry_wait_ms]
        self.last_event = self.time_durgroup(self.group_event, carry)
        pl.carry_wait_ms = carry[0]
        self.group_event = None

    def enter_level(self, pl, use_type, newscope, close_c):
        """sau/parser.c:1204-1241."""
        parent_pl = self.cur_pl
        pl.scope = newscope
        pl.close_c = close_c
        self.cur_pl = pl
        if parent_pl is not None:
            pl.parent = parent_pl
            pl.sub_f = parent_pl.sub_f
            if newscope == SCOPE_SAME:
                pl.scope = parent_pl.scope
            pl.event = parent_pl.event
            pl.operator = parent_pl.operator
            if newscope == SCOPE_BIND:
                nest = self.nest[-1]
                nest.list = S.ListData()
                pl.sub_f = None
            elif newscope == SCOPE_NEST:
                nest = self.nest[-1]
                self.begin_list(None, use_type)
                nest.sopt_save = self.sl.sopt.copy()
                self.sl.sopt.set = 0
                if use_type != P.POP_N_carr and use_type != P.POP_N_amod:
                    self.sl.sopt.def_ampmult = DEF_SOPT.def_ampmult
        pl.use_type = use_type

    def leave_level(self):
        """sau/parser.c:1243-1270."""
        pl = self.cur_pl
        self.end_operator()
        if pl.set_label is not None:
            self.sc.warning(None,
                            "ignoring variable assignment without object")
        if pl.parent is None:
            self.end_event()
            self.finish_durgroup()
            self.pc.end_dur_ms()
        if pl.scope == SCOPE_GROUP:
            self.end_event()
        elif pl.scope == SCOPE_NEST:
            nest = self.nest[-1]
            self.sl.sopt = nest.sopt_save
        self.cur_pl = pl.parent

    # -- sub-parsers (parse_in_*) -------------------------------------------

    def _parse_in_loop(self, guard, body, self_f):
        """PARSE_IN__HEAD/TAIL (sau/parser.c:1276-1294)."""
        pl = self.cur_pl
        sc = self.sc
        if not guard():
            pl.sub_f = None
            return
        pl.sub_f = self_f
        while True:
            c = sc.getc()
            sf_first = sc.sf.copy()
            if not body(c):
                sc.ungetc()
                return
            if pl.pl_flags & PL_WARN_NOSPACE:
                self._warn_missing_ws(sf_first, c)
            pl.pl_flags |= PL_WARN_NOSPACE

    def _warn_missing_ws(self, sf, c):
        self.sc.warning(sf, "missing whitespace before '%c'" % c)

    def parse_so_amp(self):
        """sau/parser.c:1296-1325. Returns True to DEFER."""
        nest = self.nest[-1] if self.nest else None
        pl = self.cur_pl
        sc = self.sc
        val = scan_num(sc)
        if val is not None:
            if pl.use_type == P.POP_N_amod:
                val *= nest.sopt_save.ampmult
            self.sl.sopt.def_ampmult = F32(val)
            self.sl.sopt.set |= S.SOPT_DEF_AMPMULT
        c = sc.getc_after('.')
        if c == 'm':
            if nest is not None:
                return True  # only allow in global scope
            if self.sl.sopt.set & S.SOPT_AMPMULT:
                sc.warning(None,
                           "'a.m' script-wide gain mix control already set")
            val = scan_num(sc)
            if val is not None:
                self.sl.sopt.ampmult = F32(val)
                self.sl.sopt.set |= S.SOPT_AMPMULT
            return False
        return c != '\0'

    def parse_so_freq(self, rel_freq):
        """sau/parser.c:1327-1409. Returns True to DEFER."""
        sc = self.sc
        sopt = self.sl.sopt
        if rel_freq:
            val = scan_num(sc)
            if val is not None:
                sopt.def_relfreq = F32(val)
                sopt.set |= S.SOPT_DEF_RELFREQ
            return False
        val = scan_num(sc, notes.scan_note_const)
        if val is not None:
            sopt.def_freq = F32(val)
            sopt.set |= S.SOPT_DEF_FREQ
        c = sc.getc_after('.')
        if c == 'k':
            octave = sopt.key_octave
            c = sc.getc()
            if c == '\0' or not (' ' < c <= '~'):
                return True
            if c < 'A' or c > 'G':
                if is_digit(c):
                    sc.ungetc()
                    octave2 = scan_int_in_range(sc, 0, 10, octave,
                                                "mode level")
                    if octave2 is not None:
                        sopt.key_octave = octave2
                    return False
                sc.warning(None, "invalid key; valid are 'A' through 'G',\n"
                           "\twith or without added 'b'/'d'/'v'/'w' (flat) "
                           "or 's'/'z'/'k'/'x' (sharp)")
                return False
            sufc = sc.getc()
            nm = notes.notemod_of(sufc)
            if nm == 0:
                sc.ungetc()
            ci = ord(c) - ord('C')
            if ci < 0:
                ci += 7
            sopt.note_key = notes.MUSKEY(ci, nm)
            octave2 = scan_int_in_range(sc, 0, 10, octave, "mode level")
            if octave2 is not None:
                sopt.key_octave = octave2
            return False
        if c == 'n':
            val = scan_num(sc)
            if val is not None:
                if val < 1.0:
                    sc.warning(None, "ignoring A4 tuning frequency (Hz) "
                               "below 1.0")
                    return False
                sopt.A4_freq = F32(val)
                sopt.set |= S.SOPT_A4_FREQ
            return False
        if c == 's':
            c = sc.get_suffc()
            systems = {'e': 0, 'c': 1, 'p': 2, 'j': 3}
            if c in systems:
                sopt.key_system = systems[c]
                sopt.set |= S.SOPT_NOTE_SCALE
            elif c == '\0':
                return True
            else:
                sc.warning(None, "unknown scale; valid are:\n"
                           "\t'e' (24-EDO), 'p' (Pythagorean JI), "
                           "'c' (classic 5-limit), 'j' (SAU JI)")
            return False
        return c != '\0'

    def parse_in_settings(self):
        """sau/parser.c:1411-1438."""
        sc = self.sc

        def body(c):
            if c == 'a':
                return not self.parse_so_amp()
            if c == 'c':
                val = scan_num(sc, scan_chanmix_const)
                if val is not None:
                    self.sl.sopt.def_chanmix = F32(val)
                    self.sl.sopt.set |= S.SOPT_DEF_CHANMIX
                return True
            if c == 'f':
                return not self.parse_so_freq(False)
            if c == 'r':
                return not self.parse_so_freq(True)
            if c == 't':
                t = scan_time_val(sc)
                if t is not None:
                    self.sl.sopt.def_time_ms = t
                    self.sl.sopt.set |= S.SOPT_DEF_TIME
                return True
            return False

        self._parse_in_loop(lambda: True, body, self.parse_in_settings)

    def parse_in_par_sweep(self):
        """sau/parser.c:1443-1482."""
        nest = self.nest[-1]
        line = nest.op_sweep
        sc = self.sc

        def body(c):
            if c == 'g':
                val = scan_num(sc, nest.numconst_f)
                if val is not None:
                    line.vt = F32(val)
                    line.flags |= P.LINEP_GOAL
                    if nest.num_ratio:
                        line.flags |= P.LINEP_GOAL_RATIO
                    else:
                        line.flags &= ~P.LINEP_GOAL_RATIO
                return True
            if c == 'r' or c == 'l':
                if c == 'r':
                    sc.warning(None, "sweep parameter 'r' is deprecated, "
                               "use new name 'l'")
                lid = scan_sym_id(sc, SYM_LINE_ID, LINE_NAMES)
                if lid is None:
                    return True
                line.type = lid
                line.flags |= P.LINEP_TYPE
                return True
            if c == 't':
                t = scan_time_val(sc)
                if t is not None:
                    line.time_ms = t
                    line.flags &= ~P.LINEP_TIME_IF_NEW
                return True
            if c == 'v':
                scan_line_state(sc, nest.numconst_f, line, nest.num_ratio)
                return True
            return False

        self._parse_in_loop(lambda: True, body, self.parse_in_par_sweep)

    def prepare_sweep(self, nest, numconst_f, op_sweep_get, op_sweep_set,
                      ratio, sweep_id):
        """sau/parser.c:1484-1501. op_sweep_get/set access the op field."""
        if op_sweep_get is None:
            nest.op_sweep = None
            return
        line = op_sweep_get()
        if line is None:
            line = self.create_line(ratio, sweep_id)
            line.flags &= ~(P.LINEP_STATE | P.LINEP_TYPE)
            op_sweep_set(line)
        nest.op_sweep = line
        nest.numconst_f = numconst_f
        nest.num_ratio = ratio

    def parse_par_list(self, numconst_f, op_sweep_get, op_sweep_set, ratio,
                       sweep_id, use_type):
        """sau/parser.c:1503-1519."""
        nest = NestScope()
        self.nest.append(nest)
        self.prepare_sweep(nest, numconst_f, op_sweep_get, op_sweep_set,
                           ratio, sweep_id)
        if op_sweep_get is not None:
            scan_line_state(self.sc, numconst_f, nest.op_sweep, ratio)
        clear = self.sc.tryc('-')
        while self.sc.tryc('['):
            self.parse_level(use_type, SCOPE_NEST, ']')
            nest = self.nest[-1]
            if clear:
                clear = False
            else:
                nest.list.append = True
        self.nest.pop()

    def parse_op(self, op_type, sym_type, sym_names):
        """sau/parser.c:1521-1537."""
        pl = self.cur_pl
        oid = 0
        if sym_type != 0:
            got = scan_sym_id(self.sc, sym_type, sym_names)
            if got is not None:
                oid = got
            nest = self.nest[-1] if self.nest else None
            if not pl.use_type and nest is not None and \
                    nest.op_sweep is not None:
                self.sc.warning(None, "modulators not supported here")
                return
        self.begin_operator(None, False, op_type)
        pl.operator.mode_main = oid
        pl.operator.mode_ras.line = oid
        pl.sub_f = self.parse_in_op_step

    def parse_op_main(self, op_type, sym_type, sym_names):
        """sau/parser.c:1539-1551. Returns True to DEFER."""
        pl = self.cur_pl
        op = pl.operator
        if op.ref.op_type != op_type:
            return True
        oid = scan_sym_id(self.sc, sym_type, sym_names)
        if oid is not None:
            op.mode_main = oid
            op.mode_ras.line = oid
            op.params |= P.POPP_MODE
        return False

    def parse_op_amp(self):
        """sau/parser.c:1553-1568. Returns nonzero char to DEFER."""
        op = self.cur_pl.operator
        self.parse_par_list(None, lambda: op.amp,
                            lambda v: setattr(op, 'amp', v), False,
                            P.PSWEEP_AMP, P.POP_N_amod)
        c = self.sc.getc_after('.')
        if c == 'r':
            self.parse_par_list(None, lambda: op.amp2,
                                lambda v: setattr(op, 'amp2', v), False,
                                P.PSWEEP_AMP2, P.POP_N_ramod)
            return '\0'
        return c

    def parse_op_chanmix(self):
        """sau/parser.c:1570-1578. Returns True to DEFER."""
        op = self.cur_pl.operator
        if op.op_flags & S.SDOP_NESTED:
            return True
        self.parse_par_list(scan_chanmix_const, lambda: op.pan,
                            lambda v: setattr(op, 'pan', v), False,
                            P.PSWEEP_PAN, P.POP_N_camod)
        return False

    def parse_op_freq(self, rel_freq):
        """sau/parser.c:1580-1599. Returns True to DEFER."""
        op = self.cur_pl.operator
        if not P.pop_is_osc(op.ref.op_type) or \
                (rel_freq and not (op.op_flags & S.SDOP_NESTED)):
            return True
        num_f = None if rel_freq else notes.scan_note_const
        self.parse_par_list(num_f, lambda: op.freq,
                            lambda v: setattr(op, 'freq', v), rel_freq,
                            P.PSWEEP_FREQ, P.POP_N_fmod)
        c = self.sc.getc_after('.')
        if c == 'r':
            self.parse_par_list(num_f, lambda: op.freq2,
                                lambda v: setattr(op, 'freq2', v), rel_freq,
                                P.PSWEEP_FREQ2, P.POP_N_rfmod)
            return False
        return c != '\0'

    def parse_op_mode(self):
        """sau/parser.c:1601-1679. Returns True to DEFER."""
        pl = self.cur_pl
        sc = self.sc
        op = pl.operator
        if op.ref.op_type != P.POPT_RASEG:
            return True
        func = P.RAS_FUNCTIONS
        flags = 0
        level = -1
        while True:
            matched = 0
            if not (func < P.RAS_FUNCTIONS):
                matched += 1
                c = sc.getc()
                fm = {'u': P.RAS_F_URAND, 'g': P.RAS_F_GAUSS,
                      'b': P.RAS_F_BIN, 't': P.RAS_F_TERN,
                      'f': P.RAS_F_FIXED, 'a': P.RAS_F_ADDREC}
                if c in fm:
                    func = fm[c]
                else:
                    sc.ungetc()
                    matched -= 1
            if flags != P.RAS_O_FUNC_FLAGS:
                matched += 1
                c = sc.getc()
                flm = {'h': P.RAS_O_HALFSHAPE, 'p': P.RAS_O_PERLIN,
                       's': P.RAS_O_SQUARE, 'v': P.RAS_O_VIOLET,
                       'z': P.RAS_O_ZIGZAG}
                if c in flm:
                    flags |= flm[c]
                else:
                    sc.ungetc()
                    matched -= 1
            if not (level >= 0):
                matched += 1
                c = sc.retc()
                if is_digit(c):
                    lv = scan_int_in_range(sc, 0, 9, 9, "mode level")
                    if lv is not None:
                        level = lv
                else:
                    matched -= 1
            if matched == 0:
                break
        if func < P.RAS_FUNCTIONS:
            op.mode_ras.func = func
            op.mode_ras.flags &= ~(P.RAS_O_FUNC_FLAGS | P.RAS_O_LEVEL_SET)
            op.mode_ras.flags |= P.RAS_O_FUNC_SET
            op.params |= P.POPP_MODE
        if flags:
            op.mode_ras.flags |= flags
            op.params |= P.POPP_MODE
        if level >= 0:
            op.mode_ras.level = P.ras_level(level)
            op.mode_ras.flags |= P.RAS_O_LEVEL_SET
            op.params |= P.POPP_MODE
        c = sc.getc_after('.')
        if c == 'a':
            val = scan_num(sc)
            if val is not None:
                op.mode_ras.alpha = prim.weylseq_dtoui32(val)
                op.mode_ras.flags |= P.RAS_O_ASUBVAL_SET
                op.params |= P.POPP_MODE
            return False
        return c != '\0'

    def parse_op_phase(self):
        """sau/parser.c:1681-1705. Returns True to DEFER."""
        op = self.cur_pl.operator
        sc = self.sc
        if not P.pop_is_osc(op.ref.op_type):
            return True
        val = scan_num(sc, scan_cyclepos_const)
        if val is not None:
            op.phase = prim.cyclepos_dtoui32(val)
            op.params |= P.POPP_PHASE
        self.parse_par_list(None, None, None, False, 0, P.POP_N_pmod)
        c = sc.getc_after('.')
        if c == 'a':
            self.parse_par_list(None, lambda: op.pm_a,
                                lambda v: setattr(op, 'pm_a', v), False,
                                P.PSWEEP_PMA, P.POP_N_apmod)
            return False
        if c == 'f':
            self.parse_par_list(None, None, None, False, 0, P.POP_N_fpmod)
            return False
        return c != '\0'

    def parse_op_seed(self):
        """sau/parser.c:1707-1718. Returns True to DEFER."""
        op = self.cur_pl.operator
        if not P.pop_has_seed(op.ref.op_type):
            return True
        val = scan_num(self.sc, scan_cyclepos_const)
        if val is not None:
            op.seed = prim.cyclepos_dtoui32(val)
            op.params |= P.POPP_SEED
        return False

    def parse_in_op_step(self):
        """sau/parser.c:1720-1809."""
        pl = self.cur_pl
        sc = self.sc

        def body(c):
            op = pl.operator
            if c == '/':
                if self.parse_waittime():
                    self.begin_operator(pl.operator, False, 0)
                return True
            if c == ';':
                pl.pl_flags &= ~PL_WARN_NOSPACE
                if self.parse_waittime():
                    self.begin_operator(pl.operator, True, 0)
                    pl.event.ev_flags |= S.SDEV_FROM_GAPSHIFT
                else:
                    if (op.time.flags & (P.TIMEP_SET | P.TIMEP_IMPLICIT)) \
                            == (P.TIMEP_SET | P.TIMEP_IMPLICIT):
                        sc.warning(None, "ignoring 'ti' (implicit time) "
                                   "before ';' without number")
                    self.begin_operator(pl.operator, True, 0)
                    pl.event.ev_flags |= S.SDEV_WAIT_PREV_DUR
                return True
            if c == 'a':
                return self.parse_op_amp() == '\0'
            if c == 'c':
                return not self.parse_op_chanmix()
            if c == 'f':
                return not self.parse_op_freq(False)
            if c == 'l':
                if self.parse_op_main(P.POPT_RASEG, SYM_LINE_ID,
                                      LINE_NAMES):
                    return False
                pl.operator.mode_ras.flags |= P.RAS_O_LINE_SET
                return True
            if c == 'm':
                return not self.parse_op_mode()
            if c == 'n':
                return not self.parse_op_main(P.POPT_NOISE, SYM_NOISE_ID,
                                              NOISE_NAMES)
            if c == 'p':
                return not self.parse_op_phase()
            if c == 'r':
                return not self.parse_op_freq(True)
            if c == 's':
                return not self.parse_op_seed()
            if c == 't':
                suffc = sc.get_suffc()
                if suffc == 'd':
                    op.time = Time(self.sl.sopt.def_time_ms,
                                   P.TIMEP_DEFAULT)
                elif suffc == 'i':
                    if not (op.op_flags & S.SDOP_NESTED):
                        sc.warning(None, "ignoring 'ti' (implicit time) "
                                   "for non-nested operator")
                    else:
                        op.time = Time(self.sl.sopt.def_time_ms,
                                       P.TIMEP_SET | P.TIMEP_DEFAULT |
                                       P.TIMEP_IMPLICIT)
                else:
                    if suffc != '\0':
                        sc.ungetc()
                    time_ms = scan_time_val(sc)
                    if time_ms is None:
                        op.params |= P.POPP_TIME
                        return True
                    op.time = Time(time_ms, P.TIMEP_SET)
                op.params |= P.POPP_TIME
                return True
            if c == 'w':
                return not self.parse_op_main(P.POPT_WAVE, SYM_WAVE_ID,
                                              WAVE_NAMES)
            return False

        self._parse_in_loop(lambda: pl.operator is not None, body,
                            self.parse_in_op_step)

    # -- variables ------------------------------------------------------------

    def parse_numvar_rhs(self, var, check_unset, no_override):
        """sau/parser.c:1811-1841. Returns True if rejected."""
        sc = self.sc
        sc.skipws()
        suffc = sc.get_suffc()
        numconst_f = None
        if suffc == 'c':
            numconst_f = scan_chanmix_const
        elif suffc == 'f':
            numconst_f = notes.scan_note_const
        elif suffc == 'p' or suffc == 's':
            numconst_f = scan_cyclepos_const
        elif suffc != '\0':
            sc.ungetc()
        if numconst_f is not None:
            sc.skipws()
        if var is None or (no_override and var.data_use == DATA_NUM):
            if skip_num(sc, numconst_f):
                return False
        else:
            val = scan_num(sc, numconst_f)
            if val is not None:
                var.num = val
                var.data_use = DATA_NUM
                if var.data_id > 0:
                    prim.MATH_VARS_SYMBOLS[var.data_id - 1](
                        self.sl.math_state, val)
                return False
        if var is not None:
            sc.warning(None, 'missing right-hand side value for "$%s%s%s"'
                       % ("?" if check_unset else "", var.sstr.key,
                          "?=" if (not check_unset and no_override)
                          else "="))
        return True

    def parse_numvar_lhs(self):
        """sau/parser.c:1843-1888. Returns True if a var was scanned."""
        sc = self.sc
        check_unset = sc.tryc('?')
        var = scan_sym(sc, SYM_VAR, None, False)
        was_unset = bool(check_unset and var is not None and
                         var.data_use != DATA_NUM)
        mark_fail = was_unset
        no_override = check_unset
        if var is not None:
            sc.skipws()
            if sc.tryc('?'):
                if not check_unset:
                    no_override = True
                else:
                    sc.warning(None, "'$?%s' needs no '?' after"
                               % var.sstr.key)
        if sc.tryc('='):
            if not self.parse_numvar_rhs(var, check_unset, no_override):
                mark_fail = False
        elif not check_unset:
            if var is not None:
                sc.warning(None, "variable '$%s' reference does nothing"
                           % var.sstr.key)
            if no_override:
                sc.ungetc()
        if was_unset:
            if mark_fail:
                self.script_fail = True
                sc.s_quiet = True
                sc.notice(None, "usage: variable '$%s' in script wasn't "
                          "set;\n\ttry passing it to the script as an "
                          "option, \"%s=...\""
                          % (var.sstr.key, var.sstr.key))
            else:
                # live frame here: the '=' rhs number read advanced it
                sc.notice(None, "usage: variable '$%s' in script wasn't "
                          "set;\n\tusing the fallback value of %f; to "
                          "set,\n\tpass it to the script as an option, "
                          "\"%s=...\""
                          % (var.sstr.key, var.num, var.sstr.key))
        return var is not None

    # -- main level parser ------------------------------------------------------

    def parse_level(self, use_type, newscope, close_c):
        """sau/parser.c:1890-2060. Returns True to end calling scope."""
        pl = ParseLevel()
        endscope = False
        self.enter_level(pl, use_type, newscope, close_c)
        sc = self.sc
        c = '\0'
        finish = False
        while not finish:
            if pl.sub_f is not None:
                pl.sub_f()
                pl = self.cur_pl  # may not change, but for clarity
            c = sc.getc()
            sf_first = sc.sf.copy()
            warn_ws = True
            if c == SCAN_SPACE or c == SCAN_LNBRK:
                pl.pl_flags &= ~PL_WARN_NOSPACE
                continue
            elif c == '$':
                if self.parse_numvar_lhs():
                    continue
            elif c == "'":
                if pl.set_label is not None:
                    sc.warning(None, "ignoring label assignment to label "
                               "assignment")
                else:
                    pl.set_label = scan_sym(sc, SYM_LABEL, None, False)
                    sc.skipws()
                    if sc.tryc('='):
                        item = self.st.find_item(pl.set_label.sstr,
                                                 SYM_VAR)
                        if item is None:
                            item = self.st.add_item(pl.set_label.sstr,
                                                    SYM_VAR)
                        sc.warning(None, "\"'name=value\" is deprecated, "
                                   "use new \"$name=value\"")
                        self.parse_numvar_rhs(item, False, False)
                        pl.set_label = None
                continue
            elif c == '/':
                if self.nest:
                    if not self._handle_unknown_or_eof(c):
                        finish = True
                    continue
                self.parse_waittime()
            elif c == '<':
                sc.warning(None, "opening '<' out of place")
                pl.pl_flags &= ~PL_WARN_NOSPACE
                continue
            elif c == '=':
                sc.warning(sf_first, "expected variable before '='")
            elif c == '>':
                sc.warning(None, "closing '>' without opening '<'")
            elif c == '@':
                if sc.tryc('['):
                    self.end_operator()
                    self.nest.append(NestScope())
                    if self.parse_level(pl.use_type, SCOPE_BIND, ']'):
                        self.leave_level()
                        return True
                    nest = self.nest.pop()
                    if nest is None or nest.list.first_item is None:
                        pass
                    else:
                        pl.pl_flags |= PL_BIND_MULTIPLE
                        self.begin_operator(nest.list.first_item, False, 0)
                        pl.sub_f = self.parse_in_op_step
                else:
                    pl.sub_f = None
                    label = scan_sym(sc, SYM_LABEL, None, False)
                    if label is not None:
                        if label.data_use == DATA_OBJ:
                            op = label.obj
                            if op.ref.obj_type == P.POBJT_OP:
                                self.begin_operator(op, False, 0)
                                op = pl.operator
                                pl.sub_f = self.parse_in_op_step
                            label.obj = op
                        else:
                            sc.warning(None, "label '@%s' doesn't refer to "
                                       "any object" % label.sstr.key)
            elif c == 'A':
                self.parse_op(P.POPT_AMP, 0, None)
                c2 = self.parse_op_amp()
                if c2 != '\0':
                    if not self._handle_unknown_or_eof(c2):
                        finish = True
                    continue
            elif c == 'N':
                self.parse_op(P.POPT_NOISE, SYM_NOISE_ID, NOISE_NAMES)
            elif c == 'R':
                self.parse_op(P.POPT_RASEG, SYM_LINE_ID, LINE_NAMES)
                if pl.operator is not None:
                    pl.operator.mode_ras.flags = P.RAS_O_LINE_SET
            elif c == 'S':
                pl.sub_f = self.parse_in_settings
            elif c == 'O' or c == 'W':
                if c == 'O':
                    sc.warning(None, "type 'O' is deprecated, use new "
                               "name 'W'")
                self.parse_op(P.POPT_WAVE, SYM_WAVE_ID, WAVE_NAMES)
            elif c == '[':
                self.prepare_event(None, False)
                self.nest.append(NestScope())
                self.parse_level(P.POP_N_carr, SCOPE_NEST, ']')
                self.nest.pop()
                self.end_operator()
            elif c == ']':
                if c == close_c:
                    if pl.scope == SCOPE_NEST:
                        self.end_operator()
                    endscope = True
                    break
                sc.warning(None, "closing ']' without opening '['")
            elif c == '{':
                if self.parse_level(pl.use_type, SCOPE_GROUP, '}'):
                    break
                continue
            elif c == '|':
                if self.nest:
                    if not self._handle_unknown_or_eof(c):
                        finish = True
                    continue
                if newscope == SCOPE_SAME:
                    sc.ungetc()
                    break
                pl.pl_flags &= ~PL_WARN_NOSPACE
                self.end_event()
                self.finish_durgroup()
                pl.sub_f = None
                continue
            elif c == '}':
                if c == close_c:
                    break
                sc.warning(None, "closing '}' without opening '{'")
            else:
                if not self._handle_unknown_or_eof(c):
                    finish = True
                continue
            if pl.pl_flags & PL_WARN_NOSPACE and warn_ws:
                self._warn_missing_ws(sf_first, c)
            pl.pl_flags |= PL_WARN_NOSPACE
        if finish:
            if close_c and c != close_c:
                sc.warning(None, "end of file without closing '%c'"
                           % close_c)
        self.leave_level()
        return endscope and pl.scope != newscope

    def _handle_unknown_or_eof(self, c):
        """sau/parser.c:133-145. Returns False at EOF."""
        if c == '\0':
            return False
        sc = self.sc
        if ' ' < c <= '~':
            if 'A' <= c <= 'Z':
                sc.warning(None,
                           "invalid or misplaced typename '%c'" % c)
            elif 'a' <= c <= 'z':
                sc.warning(None, "invalid or misplaced subname '%c'" % c)
            else:
                sc.warning(None, "misplaced or unrecognized '%c'" % c)
        else:
            sc.warning(None, "invalid character (value 0x%02X)" % ord(c))
        return True

    # -- timing resolution (sau/parser.c:2128-2379) ------------------------------

    def time_durgroup(self, e_from, wait_after):
        """sau/parser.c:2147-2209. wait_after: 1-elem list (in/out)."""
        e_subtract_after = e_from
        cur_longest = 0
        wait_sum = 0
        group_carry = 0
        subtract = False
        e = e_from
        while True:
            if not (e.ev_flags & S.SDEV_IMPLICIT_TIME):
                e.ev_flags |= S.SDEV_VOICE_SET_DUR
            time_event(e)
            if (e.ev_flags & S.SDEV_VOICE_SET_DUR) and \
                    cur_longest < e.dur_ms:
                cur_longest = e.dur_ms
                group_carry = cur_longest
                e_subtract_after = e
            if e.next is None:
                break
            e = e.next
            if cur_longest > e.wait_ms:
                cur_longest -= e.wait_ms
            else:
                cur_longest = 0
            wait_sum += e.wait_ms
        e = e_from
        while True:
            while e.forks is not None:
                flatten_events(e)
            obj = e.main_obj
            if obj is not None and obj.ref.obj_type == P.POBJT_OP:
                op = obj
                if (op.time.flags & (P.TIMEP_SET | P.TIMEP_DEFAULT)) \
                        != P.TIMEP_SET:
                    op.time.v_ms = cur_longest + wait_sum
                    op.time.flags |= P.TIMEP_SET
                    if e.dur_ms < op.time.v_ms:
                        e.dur_ms = op.time.v_ms
                    time_op_lines(op)
                self.pc.voalloc_update(self.obj_arr, e)
            self.pc.convert_event(self.obj_arr, e)
            self.pc.sum_dur_ms(e.wait_ms)
            if e.next is None:
                break
            if e is e_subtract_after:
                subtract = True
            e = e.next
            wait_sum -= e.wait_ms
            if subtract:
                if group_carry >= e.wait_ms:
                    group_carry -= e.wait_ms
                else:
                    group_carry = 0
        if wait_after is not None:
            wait_after[0] += group_carry
        return e


def time_line(line, default_time_ms):
    """sau/parser.c:2128-2136."""
    if line is None:
        return
    if line.flags & P.LINEP_TIME_IF_NEW:
        line.time_ms = default_time_ms
        line.flags |= P.LINEP_TIME


def time_op_lines(op):
    """sau/parser.c:2211-2219."""
    dur_ms = op.time.v_ms
    time_line(op.pan, dur_ms)
    time_line(op.amp, dur_ms)
    time_line(op.amp2, dur_ms)
    time_line(op.freq, dur_ms)
    time_line(op.freq2, dur_ms)
    time_line(op.pm_a, dur_ms)


def time_operator(op):
    """sau/parser.c:2221-2248."""
    dur_ms = op.time.v_ms
    if not (op.params & P.POPP_TIME):
        op.event.ev_flags &= ~S.SDEV_VOICE_SET_DUR
    if not (op.time.flags & P.TIMEP_SET):
        if op.time.flags & P.TIMEP_DEFAULT:
            op.time.flags |= P.TIMEP_SET
        else:
            op.time.flags |= P.TIMEP_DEFAULT
    elif not (op.op_flags & S.SDOP_NESTED):
        op.event.ev_flags |= S.SDEV_LOCK_DUR_SCOPE
    for lst in op.mods:
        obj = lst.first_item
        while obj is not None:
            if obj.ref.obj_type == P.POBJT_OP:
                sub_dur_ms = time_operator(obj)
                if dur_ms < sub_dur_ms and \
                        (op.time.flags & P.TIMEP_DEFAULT):
                    dur_ms = sub_dur_ms
            obj = obj.ref.next
    op.time.v_ms = dur_ms
    time_op_lines(op)
    return dur_ms


def time_event(e):
    """sau/parser.c:2250-2326."""
    dur_ms = 0
    if e.main_obj is not None:
        obj = e.main_obj
        if obj.ref.obj_type == P.POBJT_OP:
            dur_ms = time_operator(obj)
    fork = e.forks
    while fork is not None:
        nest_dur_ms = 0
        wait_sum_ms = 0
        ne = fork.events
        ne_prev = e
        ne_op = ne.main_obj
        ne_op_prev = ne_op.prev_ref
        e_op = ne_op_prev
        first_time_ms = e_op.time.v_ms
        def_time_ms = e_op.time.v_ms
        e.dur_ms = first_time_ms
        if not (e.ev_flags & S.SDEV_IMPLICIT_TIME):
            e.ev_flags |= S.SDEV_VOICE_SET_DUR
        while True:
            wait_sum_ms += ne.wait_ms
            if not (ne_op.time.flags & P.TIMEP_SET):
                ne_op.time.v_ms = def_time_ms
                if ne.ev_flags & S.SDEV_FROM_GAPSHIFT:
                    ne_op.time.flags |= P.TIMEP_SET
            time_event(ne)
            def_time_ms = ne_op.time.v_ms
            if ne.ev_flags & S.SDEV_FROM_GAPSHIFT:
                if (ne_op_prev.time.flags & P.TIMEP_DEFAULT) and \
                        not (ne_prev.ev_flags & S.SDEV_FROM_GAPSHIFT):
                    ne_op_prev.time = Time(0, P.TIMEP_SET)
            if ne.ev_flags & S.SDEV_WAIT_PREV_DUR:
                ne.wait_ms += ne_op_prev.time.v_ms
                ne_op_prev.time.flags &= ~P.TIMEP_IMPLICIT
            if nest_dur_ms < wait_sum_ms + ne.dur_ms:
                nest_dur_ms = wait_sum_ms + ne.dur_ms
            first_time_ms += ne.dur_ms + (ne.wait_ms - ne_prev.dur_ms)
            ne_op_prev.time.flags &= ~P.TIMEP_DEFAULT
            ne_op.time.flags |= P.TIMEP_SET
            ne_op.params |= P.POPP_TIME
            ne_op_prev = ne_op
            ne_prev = ne
            ne = ne.next
            if ne is None:
                break
            ne_op = ne.main_obj
        if not (e.ev_flags & S.SDEV_LOCK_DUR_SCOPE) or \
                not (e_op.op_flags & S.SDOP_NESTED):
            if dur_ms < first_time_ms:
                dur_ms = first_time_ms
        fork = fork.prev
    e.dur_ms = dur_ms
    return dur_ms


def flatten_events(e):
    """sau/parser.c:2335-2379."""
    fork = e.forks
    ne = fork.events
    fe = e.next
    fe_prev = e
    while ne is not None:
        if fe is None:
            fe_prev.next = ne
            break
        ne_next = ne.next
        if fe.wait_ms >= ne.wait_ms:
            fe.wait_ms -= ne.wait_ms
            fe_prev.next = ne
            ne.next = fe
        else:
            ne.wait_ms -= fe.wait_ms
            while fe.next is not None and fe.next.wait_ms <= ne.wait_ms:
                fe_prev = fe
                fe = fe.next
                ne.wait_ms -= fe.wait_ms
            fe_next = fe.next
            fe.next = ne
            ne.next = fe_next
            fe = fe_next
            if fe is not None:
                fe.wait_ms -= ne.wait_ms
        fe_prev = ne
        ne = ne_next
    e.forks = fork.prev


# -- top level -----------------------------------------------------------------

def parse_script_arg(arg: ScriptArg):
    """sau_build_Program (sau/parser.c:2092-2116). Returns Program or
    None.

    Mirrors the reference's actual control flow: a failed open or a
    '$?' requirement failure leaves ``name`` NULL but still freezes
    whatever the ParseConv accumulated into a program (printed as
    Program: \"(null)\"), and -- because on that path ``parse->sopt``
    is never assigned and stays mempool-zeroed (parse_file NULL goes
    to DONE before the sopt copy, sau/parser.c:2104-2113) -- the
    program's ampmult is 0.0, so a \"skipped\" script renders as pure
    silence for its full duration. Byte-compared against the binary:
    missing files and skipped scripts both build, exit 0, and render
    zeros."""
    pr = Parser(arg)
    sc = pr.sc
    name = None
    if sc.open(arg.str, arg.is_path):
        pr.parse_level(P.POP_N_carr, SCOPE_GROUP, '')
        name = sc.path
        sc.close()
        if pr.script_fail:
            sc.notice(None, "failed requirement, script will be skipped")
            name = None
    pr.st.print_stats()  # fini_Symtab (SAUGNS_TPU_SYMTAB_STATS=1)
    if not pr.pc.check_validity(name):
        return None
    sopt = pr.sl.sopt
    if name is None:
        # the reference's zeroed parse->sopt: ampmult 0 (silence) and
        # no SOPT_AMPMULT bit (so AMP_DIV_VOICES is set, same as the
        # reference's zeroed flags word)
        sopt = S.ScriptOptions(set=0, ampmult=0.0, A4_freq=0.0,
                               def_time_ms=0, def_ampmult=0.0,
                               def_freq=0.0, def_relfreq=0.0,
                               def_chanmix=0.0, note_key=0,
                               key_octave=0, key_system=0)
    return pr.pc.create_program(name, sopt)
