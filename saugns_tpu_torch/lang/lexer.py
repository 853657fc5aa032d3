"""Token-level lexer built on the scanner.

Behavioral port of sau/lexer.{h,c}: the real parser works directly at
scanner level, so (as in the reference, where the lexer is linked only
into libsau-tests for test-scan.c) this module exists to exercise the
scanner layer from tests and tools. Token kinds mirror
sau/lexer.h:20-37: INVALID (carries the offending char), ID (interned
symbol string), INT_NUM, REAL_NUM, SPECIAL (single non-symbol,
non-numeric visible char), and an end token at EOF.
"""
from __future__ import annotations

from dataclasses import dataclass

from .scanner import Scanner, is_alpha, is_digit

TOK_NONE = 0       # end of tokens (EOF reached)
TOK_INVALID = 1
TOK_ID = 2
TOK_INT_NUM = 3
TOK_REAL_NUM = 4
TOK_SPECIAL = 5


@dataclass
class Token:
    type: int
    c: str = ''        # INVALID / SPECIAL
    sym: str = ''      # ID
    num: float = 0.0   # INT_NUM / REAL_NUM (int value for INT_NUM)


class Lexer:
    """Pull-based tokenizer over a Scanner (sau/lexer.c:159)."""

    def __init__(self, symtab):
        self.sc = Scanner(symtab)

    def open(self, script: str, is_path: bool) -> bool:
        return self.sc.open(script, is_path)

    def close(self):
        self.sc.close()

    def get(self) -> Token:
        """Next token; TOK_NONE at end of input."""
        sc = self.sc
        c = sc.getc()
        if c == '\0' and sc.file_at_eof():
            return Token(TOK_NONE)
        if c.isspace():
            # scanner ws filtering leaves at most collapsed newlines
            return self.get()
        if is_digit(c):
            sc.ungetc()
            p0 = sc.pos
            v, rl = sc.getd()
            if not rl:
                return Token(TOK_INVALID, c=c)
            text = sc.text[p0:sc.pos]
            if '.' in text:
                return Token(TOK_REAL_NUM, num=v)
            return Token(TOK_INT_NUM, num=v)
        if is_alpha(c):
            sc.ungetc()
            s = sc.get_symstr()
            if s is None:
                return Token(TOK_INVALID, c=c)
            return Token(TOK_ID, sym=s.key)
        if ' ' < c <= '~':
            return Token(TOK_SPECIAL, c=c)
        return Token(TOK_INVALID, c=c)
