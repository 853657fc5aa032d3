"""Symbol table for the SAU parser.

Port of the reference's string-interning table with typed item stacks
(sau/symtab.c; item types at sau/parser.c:48-62).
"""
from __future__ import annotations

# Symbol item types (sau/parser.c:48-62)
SYM_VAR = 0
SYM_LABEL = 1
SYM_MATH_ID = 2
SYM_LINE_ID = 3
SYM_WAVE_ID = 4
SYM_NOISE_ID = 5
SYM_TYPES = 6

SYM_TYPELABELS = (
    "variable", "label", "math symbol", "line shape", "wave type",
    "noise type",
)

# data_use values (sau/symtab.h:38-48)
DATA_NONE = 0
DATA_ID = 1
DATA_NUM = 2
DATA_OBJ = 3


class Symstr:
    __slots__ = ('key', 'items')

    def __init__(self, key: str):
        self.key = key
        self.items = []  # stack of Symitem


class Symitem:
    __slots__ = ('sym_type', 'sstr', 'data_use', 'data_id', 'num', 'obj')

    def __init__(self, sym_type, sstr):
        self.sym_type = sym_type
        self.sstr = sstr
        self.data_use = DATA_NONE
        self.data_id = 0
        self.num = 0.0
        self.obj = None


class Symtab:
    """String interning + typed item stacks. The debug counter
    (SAUGNS_TPU_SYMTAB_STATS=1 env; the reference's compile-time
    SAU_SYMTAB_STATS toggle, sau/common.h:117-118, sau/symtab.c:26,
    132, 153) counts item-stack probe steps that skip a non-matching
    entry -- the analog of the reference's hash-chain collision count
    -- and prints at destroy via ``print_stats``."""

    def __init__(self):
        import os
        self._strs = {}
        self._stats = os.environ.get('SAUGNS_TPU_SYMTAB_STATS') == '1'
        self.collision_count = 0

    def get_symstr(self, key: str) -> Symstr:
        s = self._strs.get(key)
        if s is None:
            s = Symstr(key)
            self._strs[key] = s
        return s

    def find_item(self, sstr: Symstr, sym_type: int):
        for item in reversed(sstr.items):
            if item.sym_type == sym_type:
                return item
            if self._stats:
                self.collision_count += 1
        return None

    def print_stats(self):
        """fini_Symtab's stats line (sau/symtab.c:153-156)."""
        if self._stats:
            import sys
            print('collision count: %d' % self.collision_count,
                  file=sys.stderr)

    def add_item(self, sstr: Symstr, sym_type: int) -> Symitem:
        item = Symitem(sym_type, sstr)
        sstr.items.append(item)
        return item

    def add_stra(self, names, sym_type, has_id_offset=0):
        """Register name array; each gets an item with data_id
        (sau/symtab.c:228-241). ``has_id_offset``: 1 when id 0 means
        'no id' (math magic variables, sau/parser.c:96-97)."""
        for i, name in enumerate(names):
            sstr = self.get_symstr(name)
            item = self.add_item(sstr, sym_type)
            item.data_use = DATA_ID
            item.data_id = i + has_id_offset
