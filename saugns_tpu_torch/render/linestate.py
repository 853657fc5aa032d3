"""Runtime line (sweep) state machine.

Port of the stateful half of sau/line.c: sauLine_copy / _get / _run /
_skip, with ratio-value conversion against a multiplier buffer.
"""
from __future__ import annotations

import numpy as np

from ..dsp import lines as L
from ..dsp import prim
from ..lang import program as P

f32 = np.float32


class LineState:
    __slots__ = ('v0', 'vt', 'pos', 'end', 'time_ms', 'type', 'flags')

    def __init__(self):
        self.v0 = 0.0
        self.vt = 0.0
        self.pos = 0
        self.end = 0
        self.time_ms = 0
        self.type = 0
        self.flags = 0

    def copy_from(self, src, srate):
        """sauLine_copy (sau/line.c:287-332)."""
        if src is None:
            return
        mask = 0
        if src.flags & P.LINEP_STATE:
            self.v0 = float(f32(src.v0))
            mask |= P.LINEP_STATE | P.LINEP_STATE_RATIO
        elif self.flags & P.LINEP_GOAL:
            if src.flags & P.LINEP_GOAL:
                # pick value at current position of old goal
                buf = self.get(1, None)
                if buf is not None and len(buf) > 0:
                    self.v0 = float(buf[0])
        if src.flags & P.LINEP_GOAL:
            self.vt = float(f32(src.vt))
            if src.flags & P.LINEP_TIME_IF_NEW:
                self.end -= self.pos
            self.pos = 0
            mask |= P.LINEP_GOAL | P.LINEP_GOAL_RATIO
        if src.flags & P.LINEP_TYPE:
            self.type = src.type
            mask |= P.LINEP_TYPE
        if not (self.flags & P.LINEP_TIME) or \
                not (src.flags & P.LINEP_TIME_IF_NEW):
            if src.flags & P.LINEP_TIME:
                self.end = prim.ms_in_samples(src.time_ms, srate)
                self.time_ms = src.time_ms
                mask |= P.LINEP_TIME
        self.flags &= ~mask
        self.flags |= (src.flags & mask)

    # -- get/run/skip ---------------------------------------------------------

    def get(self, buf_len, mulbuf):
        """sauLine_get (sau/line.c:349-378). Returns float32 array of
        length <= buf_len (None for 0)."""
        if not (self.flags & P.LINEP_GOAL):
            return None
        if self.flags & P.LINEP_GOAL_RATIO:
            if not (self.flags & P.LINEP_STATE_RATIO):
                if mulbuf is not None:
                    self.v0 = float(f32(f32(self.v0) / mulbuf[0]))
                self.flags |= P.LINEP_STATE_RATIO
            # allow a missing mulbuf
        else:
            if self.flags & P.LINEP_STATE_RATIO:
                if mulbuf is not None:
                    self.v0 = float(f32(f32(self.v0) * mulbuf[0]))
                self.flags &= ~P.LINEP_STATE_RATIO
            mulbuf = None
        if self.pos >= self.end:
            return None
        length = self.end - self.pos
        if length > buf_len:
            length = buf_len
        mb = mulbuf[:length] if mulbuf is not None else None
        return L.FILL_FUNCS[self.type](length, self.v0, self.vt, self.pos,
                                       self.end, mb)

    def _advance_len(self, buf_len):
        """sau/line.c:385-398."""
        if self.pos < self.end:
            length = self.end - self.pos
            if length > buf_len:
                length = buf_len
            self.pos += length
        if self.pos >= self.end:
            self.pos = 0
            self.flags &= ~P.LINEP_TIME
            return False
        return True

    def run(self, buf_len, mulbuf):
        """sauLine_run (sau/line.c:417-445). Returns float32[buf_len]."""
        if not (self.flags & P.LINEP_GOAL):
            self._advance_len(buf_len)
            return self._fill_state(0, buf_len, mulbuf)
        got = self.get(buf_len, mulbuf)
        length = len(got) if got is not None else 0
        self.pos += length
        if self.pos >= self.end:
            self.v0 = self.vt
            self.pos = 0
            self.flags &= ~(P.LINEP_GOAL | P.LINEP_GOAL_RATIO |
                            P.LINEP_TIME)
            rest = self._fill_state(length, buf_len - length, mulbuf)
            if length == 0:
                return rest
            return np.concatenate([got, rest])
        return got

    def _fill_state(self, offset, length, mulbuf):
        if not (self.flags & P.LINEP_STATE_RATIO):
            mulbuf = None
        elif mulbuf is not None:
            mulbuf = mulbuf[offset:offset + length]
        return L.fill_sah(length, self.v0, self.v0, 0, 0, mulbuf)

    def skip(self, skip_len):
        """sauLine_skip (sau/line.c:456-473)."""
        if not self._advance_len(skip_len):
            if not (self.flags & P.LINEP_GOAL):
                return False
            self.v0 = self.vt
            if self.flags & P.LINEP_GOAL_RATIO:
                self.flags |= P.LINEP_STATE_RATIO
            else:
                self.flags &= ~P.LINEP_STATE_RATIO
            self.flags &= ~(P.LINEP_GOAL | P.LINEP_GOAL_RATIO)
            return False
        return (self.flags & P.LINEP_GOAL) != 0
