"""Character scanner for the SAU language.

Behavioral port of the reference scanner (sau/scanner.c, sau/file.c):
character gets with per-character filtering (whitespace collapsing,
comment removal), one-frame ungets that restore the read position,
numeric literal reads, and identifier reads.

Key semantics preserved (citations into /root/reference):
- whitespace filtering levels WS_ALL / WS_NONE (sau/scanner.h:96-99)
- comment syntax //, /* */, plus parser-installed '#' filter for
  '#!' line comments and '#Q' quit-file (sau/parser.c:210-224)
- unget restores position to final byte of the last get, with that byte
  patched to the filtered character (sau/scanner.c:718-741 set_usedc)
- number formats: no exponents; [digits][.digits] (sau/file.c:383-447)
"""
from __future__ import annotations

import os
import sys

SCAN_SPACE = ' '
SCAN_LNBRK = '\n'
SCAN_EOF = '\0'

WS_ALL = 0
WS_NONE = 1


def is_digit(c: str) -> bool:
    return '0' <= c <= '9'


def is_alpha(c: str) -> bool:
    return ('a' <= c <= 'z') or ('A' <= c <= 'Z')


def is_symchar(c: str) -> bool:
    return is_alpha(c) or is_digit(c) or c == '_'


class ScanFrame:
    __slots__ = ('line_num', 'char_num', 'c')

    def __init__(self, line_num=1, char_num=0, c='\0'):
        self.line_num = line_num
        self.char_num = char_num
        self.c = c

    def copy(self):
        return ScanFrame(self.line_num, self.char_num, self.c)


class Scanner:
    """Scanner over in-memory script text (file contents or -e string)."""

    def __init__(self, symtab):
        self.symtab = symtab
        self.text = ''
        self.pos = 0
        self.path = None
        self.name = None
        self.closed = False
        self.ws_level = WS_ALL
        self.sf = ScanFrame()
        # unget history: list of (start_pos, end_pos, ring_frame)
        # records; ring_frame is what the C undo ring holds -- the
        # post-get frame for getc, the START-of-token frame for
        # string/number gets (advance_frame pushes after
        # char_num += prelen, sau/scanner.c:548-561)
        self._hist = []
        # undo-ring analog for positioned warnings (warning_at)
        self._warn_frames = []
        # ungotten records pending re-get (REGOT flag analog): a
        # re-get at the same position restores the original frame
        # instead of recomputing from the restored-previous frame
        self._pending_regets = []
        self._override = {}  # pos -> patched char (filtered multi-byte gets)
        self.s_quiet = False
        self.s_error = False
        self.data = None  # ScanLookup attached by parser
        self.hash_filter = False  # '#'-filter installed by parser
        # test statistics (the reference's compile-time
        # SAU_SCANNER_STATS toggle, sau/common.h:120-121,
        # sau/scanner.c:23-25,64-66 -- its hits/misses counters are
        # declared+printed but never incremented in v0.4.7; here they
        # meaningfully count unget-ring reuse vs fresh reads)
        self._stats = os.environ.get('SAUGNS_TPU_SCANNER_STATS') == '1'
        self.stat_hits = 0    # re-gets served from the unget ring
        self.stat_misses = 0  # fresh character gets

    # -- opening ---------------------------------------------------------

    def open(self, script: str, is_path: bool) -> bool:
        if is_path:
            try:
                with open(script, 'rb') as f:
                    self.text = f.read().decode('latin-1')
            except OSError as e:
                print("error: couldn't open script file \"%s\" for reading"
                      % script, file=sys.stderr)
                return False
            self.path = script
            self.name = script
        else:
            self.text = script
            self.path = '<string>'
            self.name = '<string>'
        self.pos = 0
        self.closed = False
        self.sf = ScanFrame()
        return True

    def close(self):
        if self._stats:
            # sau_destroy_Scanner's stats print (sau/scanner.c:64-66)
            print('hits: %d\nmisses: %d'
                  % (self.stat_hits, self.stat_misses),
                  file=sys.stderr)
        self.closed = True

    # -- raw byte access (sauFile level) ----------------------------------

    def _b(self, pos: int) -> str:
        ov = self._override.get(pos)
        if ov is not None:
            return ov
        if pos >= len(self.text) or self.closed:
            return SCAN_EOF
        return self.text[pos]

    def file_getc(self) -> str:
        c = self._b(self.pos)
        self.pos += 1
        return c

    def file_retc(self) -> str:
        return self._b(self.pos)

    def file_decp(self):
        self.pos -= 1

    def file_incp(self):
        self.pos += 1

    def file_ungetn(self, n: int):
        self.pos -= n

    def file_tryc(self, c: str) -> bool:
        if self._b(self.pos) == c:
            self.pos += 1
            return True
        return False

    def file_at_eof(self, pos=None) -> bool:
        if self.closed:
            return True
        p = self.pos if pos is None else pos
        return p > len(self.text)

    # -- filtering ---------------------------------------------------------

    def _filter(self, c: str):
        """Apply the default + parser filters for raw char ``c``
        (already consumed). Returns filtered char, '' to skip,
        or SCAN_EOF at end of file."""
        ws_none = self.ws_level == WS_NONE
        if c == ' ' or c == '\t':
            if ws_none:
                while self._b(self.pos) in (' ', '\t'):
                    self.pos += 1
                    self.sf.char_num += 1
                return ''
            return SCAN_SPACE
        if c == '\n' or c == '\r':
            if c == '\n':
                self.file_tryc('\r')
            self.sf.line_num += 1
            self.sf.char_num = 0
            if ws_none:
                # consume further newlines/spaces
                while True:
                    nc = self._b(self.pos)
                    if nc == '\n':
                        self.pos += 1
                        self.file_tryc('\r')
                        self.sf.line_num += 1
                        self.sf.char_num = 0
                    elif nc == '\r':
                        self.pos += 1
                        self.sf.line_num += 1
                        self.sf.char_num = 0
                    elif nc in (' ', '\t'):
                        self.pos += 1
                        self.sf.char_num += 1
                    else:
                        break
                return ''
            return SCAN_LNBRK
        if c == '/':
            nc = self._b(self.pos)
            if nc == '*':
                self.pos += 1
                # block comment: until '*/'; acts as a space
                while True:
                    cc = self.file_getc()
                    if cc == '\n':
                        self.file_tryc('\r')
                        self.sf.line_num += 1
                        self.sf.char_num = 0
                    elif cc == '\r':
                        self.sf.line_num += 1
                        self.sf.char_num = 0
                    elif cc == '*':
                        if self.file_tryc('/'):
                            break
                    elif cc == SCAN_EOF and self.file_at_eof():
                        self.error(None, "unterminated comment")
                        return SCAN_EOF
                # comment counts as a space token (sau/scanner.c:240-246)
                return self._filter(' ')
            if nc == '/':
                self.pos += 1
                self._skip_line()
                return ''
            return c
        if c == '#':
            if self.hash_filter:
                nc = self._b(self.pos)
                if nc == '!':
                    self.pos += 1
                    self.sf.char_num += 1
                    self._skip_line()
                    return ''
                if nc == 'Q':
                    self.close()
                    return SCAN_EOF
                return c
            # default: '#' opens a line comment (sau/scanner.c:366)
            self._skip_line()
            return ''
        if c == SCAN_EOF and self.file_at_eof():
            return SCAN_EOF
        o = ord(c)
        if o < 0x20 or o > 0x7e:
            self.warning(None, "invalid character (value 0x%02X)" % o)
            return ''
        return c

    def _skip_line(self):
        while True:
            c = self._b(self.pos)
            if c == '\n' or c == '\r':
                break
            if c == SCAN_EOF and self.file_at_eof(self.pos + 1):
                break
            self.pos += 1
            self.sf.char_num += 1

    # -- scanner gets -----------------------------------------------------

    def _pop_reget(self):
        """REGOT analog: returns the original record when the get
        starting at the current position re-reads an ungotten get."""
        if not self._pending_regets:
            return None
        if self._pending_regets[-1][0] != self.pos:
            del self._pending_regets[:]
            return None
        return self._pending_regets.pop()

    def getc(self) -> str:
        """Get next filtered character; SCAN_EOF ('\\0') at end of file.
        Returns '\\0' for EOF like the C scanner returns 0."""
        reget = self._pop_reget()
        if self._stats:
            if reget is not None:
                self.stat_hits += 1
            else:
                self.stat_misses += 1
        eof = False
        while True:
            start = self.pos
            c = self.file_getc()
            self.sf.char_num += 1
            fc = self._filter(c)
            if fc == '':
                continue
            if fc == SCAN_EOF:
                if self.file_at_eof() or self.closed:
                    c = '\0'
                    eof = True
                    break
                continue
            c = fc
            break
        end = self.pos
        if not eof and (end - start != 1 or self.text[start:start + 1] != c):
            self._override[end - 1] = c
        if reget is not None and reget[1] == end:
            # restore the original get's frame (a 1-byte re-read of
            # the patched byte must not recount filtered chars)
            self.sf = reget[2].copy()
        self.sf.c = c
        frame = self.sf.copy()
        self._hist.append((start, end, frame))
        if len(self._hist) > 128:
            del self._hist[0]
        self._push_warn_frame(frame)
        return c

    def _push_warn_frame(self, frame):
        self._warn_frames.append(frame)
        if len(self._warn_frames) > 64:
            del self._warn_frames[0]

    def _has_filter(self, c: str) -> bool:
        """Whether ``c`` has a scan filter installed -- the C filter
        table maps whitespace, comment openers, EOF/specials and
        non-printable bytes to filter functions; printable chars have
        NULL entries (sau/scanner.c:360-459)."""
        if c in (' ', '\t', '\n', '\r', '/', '#'):
            return True
        if c == SCAN_EOF:
            return True
        o = ord(c)
        return o < 0x20 or o > 0x7e

    def retc(self) -> str:
        """Peek the next filtered character. Unfiltered characters are
        returned without any frame/position movement (sauScanner_retc,
        sau/scanner.c:612-620: a bare sauFile_RETC when no filter)."""
        c = self.file_retc()
        if not self._has_filter(c):
            return c
        c = self.getc()
        self.ungetc()
        return c

    def ungetc(self):
        """Positional unget (sau/scanner.c:718-741): move back to the
        final byte of the last get; that byte is patched (override) so
        a re-get returns the same filtered character."""
        if not self._hist:
            return
        rec = self._hist.pop()
        self.pos = rec[1] - 1
        if self._hist:
            self.sf = self._hist[-1][2].copy()
        else:
            self.sf = ScanFrame()
        if self._warn_frames:
            self._warn_frames.pop()
        # pos after unget = final byte of the get; a re-get there
        # restores rec's frame (C REGOT, sau/scanner.c:497-510)
        self._pending_regets.append((rec[1] - 1, rec[1], rec[2]))

    def tryc(self, testc: str) -> bool:
        """Advance past the next character iff it matches. For
        unfiltered characters a mismatch moves nothing at all
        (sauScanner_tryc, sau/scanner.c:685-705: bare RETC compare);
        only filtered characters do a get + unget on mismatch."""
        c = self.file_retc()
        if not self._has_filter(c):
            if c != testc:
                return False
            self.getc()
            return True
        c = self.getc()
        if c != testc:
            self.ungetc()
            return False
        return True

    def getc_after(self, testc: str) -> str:
        """Get char after current if testc matched first, else '\\0'
        (sau/scanner.c:669-673)."""
        if not self.tryc(testc):
            return '\0'
        return self.getc()

    def get_suffc(self) -> str:
        """Get char if alphabetic and not followed by a symchar
        (sau/scanner.c:823-846)."""
        c = self.getc()
        if not is_alpha(c):
            self.ungetc()
            return '\0'
        nc = self.file_retc()
        if is_symchar(nc):
            self.ungetc()
            return '\0'
        return c

    def skipws(self) -> str:
        """Skip whitespace before the next character
        (sauScanner_skipws, sau/scanner.c:895-903). The whole
        whitespace run plus the following character is consumed as ONE
        WS_NONE-filtered get, then ungot -- so the live frame rolls
        back to the pre-whitespace frame (the undo-ring entry), which
        is where warnings fired right after a skipws point."""
        c = self.retc()
        if c == SCAN_SPACE or c == SCAN_LNBRK:
            old = self.ws_level
            self.ws_level = WS_NONE
            c = self.getc()
            self.ws_level = old
            self.ungetc()
        return c

    # -- number reads (file level; sau/file.c:330-447) ---------------------

    def _file_geti(self, allow_sign: bool):
        """Returns (value, read_len)."""
        start = self.pos
        c = self.file_getc()
        length = 1
        minus = False
        if allow_sign and (c == '+' or c == '-'):
            minus = c == '-'
            c = self.file_getc()
            length += 1
        if not is_digit(c):
            self.pos = start
            return 0, 0
        num = 0
        truncate = False
        while is_digit(c):
            num = num * 10 + (ord(c) - ord('0'))
            if num > 0x7fffffff:
                truncate = True
                num = 0x7fffffff
            c = self.file_getc()
            length += 1
        if minus:
            num = -num
            if truncate:
                num = -0x80000000
        self.file_decp()
        length -= 1
        return num, length

    def _file_getd(self):
        """C sauFile_getd with allow_sign=false. Returns (value, read_len)."""
        start = self.pos
        c = self.file_getc()
        length = 1
        num_a = 0.0
        if c != '.':
            if not is_digit(c):
                self.pos = start
                return 0.0, 0
            while is_digit(c):
                num_a = num_a * 10.0 + (ord(c) - ord('0'))
                c = self.file_getc()
                length += 1
            if c != '.':
                self.file_decp()
                return num_a, length - 1
            c = self.file_getc()
            if not is_digit(c):
                # "1." form: exclude the dot (sau/file.c:419-423)
                self.pos -= 2
                return num_a, length - 1
            length += 1
        else:
            c = self.file_getc()
            length += 1
            if not is_digit(c):
                self.pos = start
                return 0.0, 0
        num_b = 0
        pos_div = 1.0
        while is_digit(c):
            b = num_b * 10 + (ord(c) - ord('0'))
            if num_b <= b < (1 << 63):
                num_b = b
                pos_div *= 10.0
            c = self.file_getc()
            length += 1
        num_a += num_b / pos_div
        self.file_decp()
        return num_a, length - 1

    def _token_frames(self, start_pos, read_len, reget):
        """advance_frame analog for multi-char gets
        (sau/scanner.c:548-561): the undo ring entry is the
        START-of-token frame; the live frame advances to the token
        end.  With a pending re-get, the base frame restores from the
        original record (REGOT)."""
        if reget is not None:
            self.sf = reget[2].copy()
            self.sf.char_num -= 1
        self.sf.char_num += 1
        ring = self.sf.copy()
        self._push_warn_frame(ring)
        self.sf.char_num += read_len - 1
        self._hist.append((start_pos, self.pos, ring))
        if len(self._hist) > 128:
            del self._hist[0]

    def geti(self, allow_sign=False):
        """Scanner-level integer read. Returns (value, read_len)."""
        start = self.pos
        reget = self._pop_reget()
        val, rl = self._file_geti(allow_sign)
        if rl:
            self._token_frames(start, rl, reget)
            self.sf.c = self.text[self.pos - 1] if self.pos - 1 < len(self.text) else '\0'
        return val, rl

    def getd(self, allow_sign=False, numconst_f=None):
        """Scanner-level double read (sau/scanner.c:775-815).
        Returns (value, read_len)."""
        start = self.pos
        reget = self._pop_reget()
        c = self.file_retc()
        sign = False
        minus = False
        if allow_sign and (c == '+' or c == '-'):
            self.file_incp()
            minus = c == '-'
            sign = True
        val = 0.0
        read_len = 0
        if numconst_f is not None:
            val2 = [0.0]
            read_len = numconst_f(self, val2)
            val = val2[0]
        if read_len == 0:
            val, read_len = self._file_getd()
        if read_len == 0:
            if sign:
                self.file_decp()
            return 0.0, 0
        if sign:
            read_len += 1
        if minus:
            val = -val
        self._token_frames(start, read_len, reget)
        return val, read_len

    STRBUF_LEN = 256

    def get_symstr(self):
        """Read identifier string; returns interned Symstr or None.
        Identifiers cap at STRBUF_LEN-1 = 255 characters with a
        warning, skipping the rest (sauScanner_get_symstr,
        sau/scanner.c:855-883)."""
        start = self.pos
        reget = self._pop_reget()
        chars = []
        while True:
            c = self._b(self.pos)
            if not is_symchar(c):
                break
            chars.append(c)
            self.pos += 1
        if not chars:
            self.pos = start
            return None
        read_len = len(chars)
        if read_len > self.STRBUF_LEN - 1:
            chars = chars[:self.STRBUF_LEN - 1]
            self.warning(None, "limiting identifier to %d characters"
                         % (self.STRBUF_LEN - 1))
        self._token_frames(start, read_len, reget)
        return self.symtab.get_symstr(''.join(chars))

    # -- diagnostics --------------------------------------------------------

    def _print_stderr(self, label, sf, msg):
        """print_stderr (sau/scanner.c:906-922): positioned prefix
        unless printing the live current frame after EOF."""
        at_cur_after_eof = sf is None and self.file_at_eof()
        if sf is None:
            sf = self.sf
        if not at_cur_after_eof:
            pos = "%s:%d:%d: " % (self.name, sf.line_num, sf.char_num)
        else:
            pos = "%s: " % self.name
        if label is not None:
            pos += "%s: " % label
        print(pos + msg, file=sys.stderr)

    def notice(self, sf, msg):
        """sauScanner_notice: positioned message without a label
        prefix (sau/scanner.c:924-937)."""
        self._print_stderr(None, sf, msg)

    def warning(self, sf, msg):
        if self.s_quiet:
            return
        self._print_stderr("warning", sf, msg)

    def warning_at(self, got_at, msg):
        """sauScanner_warning_at: position from the undo ring at
        relative index (0 = the latest get)."""
        if self.s_quiet:
            return
        idx = -1 + got_at
        sf = self._warn_frames[idx] if self._warn_frames \
            and -len(self._warn_frames) <= idx < 0 else self.sf
        self._print_stderr("warning", sf, msg)

    def error(self, sf, msg):
        self.s_error = True
        self._print_stderr("error", sf, msg)
