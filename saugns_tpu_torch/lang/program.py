"""Program IR: the compiled artifact consumed by the renderers.

Port of sau/program.h data model: a flat time-ordered list of events,
each carrying voice/op graph refs and per-operator parameter update
records, plus ``print_info`` byte-compatible with the reference's ``-p``
output (sau/parser/parseconv.h:603-713).
"""
from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Optional

# Time parameter flags (sau/program.h:25-29)
TIMEP_SET = 1 << 0
TIMEP_DEFAULT = 1 << 1
TIMEP_IMPLICIT = 1 << 2

# Line parameter flags (sau/line.h:99-107)
LINEP_STATE = 1 << 0
LINEP_STATE_RATIO = 1 << 1
LINEP_GOAL = 1 << 2
LINEP_GOAL_RATIO = 1 << 3
LINEP_TYPE = 1 << 4
LINEP_TIME = 1 << 5
LINEP_TIME_IF_NEW = 1 << 6

# Swept parameter ids (sau/program.h:53-60)
PSWEEP_PAN, PSWEEP_AMP, PSWEEP_AMP2, PSWEEP_FREQ, PSWEEP_FREQ2, \
    PSWEEP_PMA = range(6)

# Object types (sau/program.h:62-66)
POBJT_LIST = 0
POBJT_OP = 1

# Operator types (sau/program.h:69-80)
POPT_AMP, POPT_NOISE, POPT_WAVE, POPT_RASEG = range(4)
POPT_LABELS = {POPT_AMP: 'A', POPT_NOISE: 'N', POPT_WAVE: 'W',
               POPT_RASEG: 'R'}


def pop_is_osc(type_id: int) -> bool:
    return type_id >= POPT_WAVE


def pop_has_seed(type_id: int) -> bool:
    return type_id in (POPT_NOISE, POPT_RASEG)


# Operator parameter flags (sau/program.h:93-99)
POPP_TIME = 1 << 0
POPP_MODE = 1 << 1
POPP_PHASE = 1 << 2
POPP_SEED = 1 << 3
POP_PARAMS = (1 << 4) - 1

# Noise types (sau/program.h:102-120)
NOISE_NAMES = ('wh', 'gw', 'bw', 'tw', 're', 'vi', 'bv')
NOISE_wh, NOISE_gw, NOISE_bw, NOISE_tw, NOISE_re, NOISE_vi, NOISE_bv = \
    range(7)
NOISE_NAMED = 7

# Random segments functions (sau/program.h:135-143)
RAS_F_URAND, RAS_F_GAUSS, RAS_F_BIN, RAS_F_TERN, RAS_F_FIXED, \
    RAS_F_ADDREC = range(6)
RAS_FUNCTIONS = 6

# Random segments option flags (sau/program.h:151-163)
RAS_O_PERLIN = 1 << 0
RAS_O_HALFSHAPE = 1 << 1
RAS_O_ZIGZAG = 1 << 2
RAS_O_SQUARE = 1 << 3
RAS_O_VIOLET = 1 << 4
RAS_O_FUNC_FLAGS = (1 << 6) - 1
RAS_O_LINE_SET = 1 << 6
RAS_O_FUNC_SET = 1 << 7
RAS_O_LEVEL_SET = 1 << 8
RAS_O_ASUBVAL_SET = 1 << 9


def ras_level(digit: int) -> int:
    """Stretch digit 0-9 across 0-30 (sau/program.h:146-148)."""
    return digit if digit <= 6 else (digit - 4) * (digit - 4) + 2


# Voice/op id constants
PVO_NO_ID = 0xFFFF
PVO_MAX_ID = 0xFFFF - 1
POP_NO_ID = 0xFFFFFFFF
POP_MAX_ID = 0xFFFFFFFF - 1

# Operator use types (sau/program.h:183-204)
POP_USES = ('carr', 'camod', 'amod', 'ramod', 'fmod', 'rfmod', 'pmod',
            'apmod', 'fpmod')
POP_N_carr, POP_N_camod, POP_N_amod, POP_N_ramod, POP_N_fmod, \
    POP_N_rfmod, POP_N_pmod, POP_N_apmod, POP_N_fpmod = range(9)
POP_NAMED = 9
POP_GRAPH_LABELS = (' CA', 'cAM', ' AM', 'rAM', ' FM', 'rFM', ' PM',
                    'aPM', 'fPM')
POP_SYNTAX = (None, 'c', 'a', 'a.r', 'f', 'f.r', 'p', 'p.a', 'p.f')

# Program mode flags (sau/program.h:246-248)
PMODE_AMP_DIV_VOICES = 1 << 0


@dataclass
class Time:
    """sauTime (sau/program.h:36-39)."""
    v_ms: int = 0
    flags: int = 0


@dataclass
class Line:
    """sauLine parameter record (sau/line.h:115-121)."""
    v0: float = 0.0
    vt: float = 0.0
    pos: int = 0
    end: int = 0
    time_ms: int = 0
    type: int = 0
    flags: int = 0

    def copy(self) -> 'Line':
        return Line(self.v0, self.vt, self.pos, self.end, self.time_ms,
                    self.type, self.flags)


@dataclass
class RasOpt:
    """sauRasOpt (sau/program.h:126-132)."""
    line: int = 0
    flags: int = 0
    func: int = 0
    level: int = 0
    alpha: int = 0

    def copy(self) -> 'RasOpt':
        return RasOpt(self.line, self.flags, self.func, self.level,
                      self.alpha)


@dataclass
class OpRef:
    """sauProgramOpRef (sau/program.h:206-210)."""
    id: int
    use: int
    level: int


@dataclass
class OpData:
    """sauProgramOpData (sau/program.h:212-231)."""
    id: int = 0
    params: int = 0
    time: Time = field(default_factory=Time)
    pan: Optional[Line] = None
    amp: Optional[Line] = None
    amp2: Optional[Line] = None
    freq: Optional[Line] = None
    freq2: Optional[Line] = None
    pm_a: Optional[Line] = None
    phase: int = 0
    seed: int = 0
    use_type: int = 0
    type: int = 0
    mode_main: int = 0  # wave/noise id
    mode_ras: Optional[RasOpt] = None
    # modulator id lists; None = unchanged (sau/program.h:228-230)
    camods: Optional[tuple] = None
    amods: Optional[tuple] = None
    ramods: Optional[tuple] = None
    fmods: Optional[tuple] = None
    rfmods: Optional[tuple] = None
    pmods: Optional[tuple] = None
    apmods: Optional[tuple] = None
    fpmods: Optional[tuple] = None

    MOD_FIELDS = ('camods', 'amods', 'ramods', 'fmods', 'rfmods', 'pmods',
                  'apmods', 'fpmods')


@dataclass
class Event:
    """sauProgramEvent (sau/program.h:233-241)."""
    wait_ms: int = 0
    vo_id: int = PVO_NO_ID
    carr_op_id: int = 0
    op_list: Optional[list] = None  # list[OpRef]
    op_data: list = field(default_factory=list)  # list[OpData]


@dataclass
class Program:
    """sauProgram (sau/program.h:253-265)."""
    events: list = field(default_factory=list)
    mode: int = 0
    vo_count: int = 0
    op_count: int = 0
    op_nest_depth: int = 0
    duration_ms: int = 0
    ampmult: float = 1.0
    name: str = ''
    sopt = None  # final script options (for tooling)

    # -- -p printer, byte-compatible (parseconv.h:603-713) -----------------

    def print_info(self, out=None):
        w = (out or sys.stdout).write
        w('Program: "%s"\n'
          '\tDuration: \t%u ms\n'
          '\tEvents:   \t%u\n'
          '\tVoices:   \t%u\n'
          '\tOperators:\t%u\n'.replace('%u', '%d')
          % ('(null)' if self.name is None else self.name,
             self.duration_ms, len(self.events),
             self.vo_count, self.op_count))
        for ev_id, ev in enumerate(self.events):
            w('/%d \tEV %d \t(VO %d)' % (ev.wait_ms, ev_id, ev.vo_id))
            if ev.op_list is not None:
                w('\n\tvo %d' % ev.vo_id)
                self._print_oplist(w, ev.op_list)
            for od in ev.op_data:
                self._print_opline(w, od)
                for i, fname in enumerate(OpData.MOD_FIELDS):
                    self._print_linked(w, POP_SYNTAX[i + 1],
                                       getattr(od, fname))
            w('\n')

    @staticmethod
    def _print_oplist(w, op_list):
        if not op_list:
            return
        max_indent = 0
        w('\n\t    [')
        for i, ref in enumerate(op_list):
            indent = ref.level * 3
            if indent > max_indent:
                max_indent = indent
            w('%6d:  ' % ref.id)
            w(' ' * indent)
            w(POP_GRAPH_LABELS[ref.use])
            if i + 1 == len(op_list):
                break
            w('\n\t     ')
        w(' ' * max_indent)
        w(']')

    @staticmethod
    def _print_line(w, line, c):
        if line is None:
            return
        if line.flags & LINEP_STATE:
            if line.flags & LINEP_GOAL:
                w('\t%c=%-6.2f->%-6.2f' % (c, line.v0, line.vt))
            else:
                w('\t%c=%-6.2f\t' % (c, line.v0))
        else:
            if line.flags & LINEP_GOAL:
                w('\t%c->%-6.2f\t' % (c, line.vt))
            else:
                w('\t%c' % c)

    def _print_opline(self, w, od):
        type_c = POPT_LABELS.get(od.type, '?')
        if od.time.flags & TIMEP_IMPLICIT:
            w('\n\top %-2d %c t=IMPL  ' % (od.id, type_c))
        else:
            w('\n\top %-2d %c t=%-6d' % (od.id, type_c, od.time.v_ms))
        self._print_line(w, od.freq, 'f')
        self._print_line(w, od.amp, 'a')

    @staticmethod
    def _print_linked(w, header, ids):
        if not ids:
            return
        w('\n\t    %s[%d' % (header, ids[0]))
        for i in ids[1:]:
            w(', %d' % i)
        w(']')


def build_program(script_arg) -> Optional[Program]:
    """Build a Program from a ScriptArg (sau_build_Program,
    sau/parser.c:2092-2116)."""
    from .parser import parse_script_arg
    return parse_script_arg(script_arg)


@dataclass
class ScriptArg:
    """sauScriptArg (sau/script.h:134-141)."""
    str: str = ''
    is_path: bool = True
    no_time: bool = False
    predef: list = field(default_factory=list)  # list[(key, val)]
