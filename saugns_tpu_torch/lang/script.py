"""Parse-tree node types (port of sau/script.h)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .program import Line, RasOpt, Time

# Script data operator flags (sau/script.h:20-23)
SDOP_NESTED = 1 << 0
SDOP_MULTIPLE = 1 << 1

# Script data event flags (sau/script.h:80-87)
SDEV_ASSIGN_VOICE = 1 << 0
SDEV_VOICE_SET_DUR = 1 << 1
SDEV_IMPLICIT_TIME = 1 << 2
SDEV_WAIT_PREV_DUR = 1 << 3
SDEV_FROM_GAPSHIFT = 1 << 4
SDEV_LOCK_DUR_SCOPE = 1 << 5

# Script option flags (sau/script.h:115-125)
SOPT_DEF_AMPMULT = 1 << 0
SOPT_DEF_CHANMIX = 1 << 1
SOPT_DEF_TIME = 1 << 2
SOPT_DEF_FREQ = 1 << 3
SOPT_DEF_RELFREQ = 1 << 4
SOPT_AMPMULT = 1 << 5
SOPT_A4_FREQ = 1 << 6
SOPT_NOTE_KEY = 1 << 7
SOPT_NOTE_SCALE = 1 << 8


@dataclass
class ScriptOptions:
    """sauScriptOptions (sau/script.h:148-161); defaults from
    sau/parser.c:76-88."""
    set: int = 0
    ampmult: float = 1.0
    A4_freq: float = 440.0
    def_time_ms: int = 1000
    def_ampmult: float = 1.0
    def_freq: float = 440.0
    def_relfreq: float = 1.0
    def_chanmix: float = 0.0
    note_key: int = 4  # MUSKEY(0, 0) = 0*9+4
    key_octave: int = 4
    key_system: int = 0

    def copy(self) -> 'ScriptOptions':
        return ScriptOptions(self.set, self.ampmult, self.A4_freq,
                             self.def_time_ms, self.def_ampmult,
                             self.def_freq, self.def_relfreq,
                             self.def_chanmix, self.note_key,
                             self.key_octave, self.key_system)


@dataclass
class ObjInfo:
    """sauScriptObjInfo (sau/script.h:26-34)."""
    obj_type: int = 0
    op_type: int = 0
    last_vo_id: int = 0xFFFF
    last_op_id: int = 0
    root_op_obj: int = 0
    parent_op_obj: int = 0
    seed: int = 0


class ObjRef:
    """sauScriptObjRef common data (sau/script.h:37-43)."""
    __slots__ = ('obj_id', 'obj_type', 'op_type', 'vo_id', 'next')

    def __init__(self):
        self.obj_id = 0
        self.obj_type = 0
        self.op_type = 0
        self.vo_id = 0xFFFF
        self.next = None


class ListData:
    """sauScriptListData (sau/script.h:48-53)."""
    __slots__ = ('ref', 'first_item', 'last_item_ref', 'use_type',
                 'append', 'next_list')

    def __init__(self):
        self.ref = ObjRef()
        self.ref.obj_type = 0  # POBJT_LIST
        self.first_item = None  # ObjRef chain head (OpData.ref or ListData.ref)
        self.use_type = 0
        self.append = False
        self.next_list = None  # chain among an op's mod lists


class OpData:
    """sauScriptOpData (sau/script.h:58-75)."""
    __slots__ = ('ref', 'event', 'prev_ref', 'op_flags', 'params', 'time',
                 'pan', 'amp', 'amp2', 'freq', 'freq2', 'pm_a', 'phase',
                 'seed', 'mode_main', 'mode_ras', 'mods', 'obj')

    def __init__(self):
        self.ref = ObjRef()
        self.ref.obj_type = 1  # POBJT_OP
        self.event = None
        self.prev_ref = None
        self.op_flags = 0
        self.params = 0
        self.time = Time()
        self.pan: Optional[Line] = None
        self.amp: Optional[Line] = None
        self.amp2: Optional[Line] = None
        self.freq: Optional[Line] = None
        self.freq2: Optional[Line] = None
        self.pm_a: Optional[Line] = None
        self.phase = 0
        self.seed = 0
        self.mode_main = 0
        self.mode_ras = RasOpt()
        self.mods = []  # list[ListData] (C: linked via ref.next)
        self.obj = self  # back-ref helper


class EvData:
    """sauScriptEvData (sau/script.h:101-108)."""
    __slots__ = ('next', 'forks', 'main_obj', 'wait_ms', 'dur_ms',
                 'ev_flags')

    def __init__(self):
        self.next = None
        self.forks = None  # EvBranch chain
        self.main_obj = None  # ObjRef
        self.wait_ms = 0
        self.dur_ms = 0
        self.ev_flags = 0


class EvBranch:
    """sauScriptEvBranch (sau/parser.c:894-897)."""
    __slots__ = ('events', 'prev')

    def __init__(self, events, prev):
        self.events = events
        self.prev = prev
