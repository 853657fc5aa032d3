"""Help topics: named help lists for -h <topic> and in-parse
"available are:" suggestions (port of sau/help.c)."""
from __future__ import annotations

import sys


def get_help_names():
    from ..dsp import prim
    from ..dsp.lines import LINE_NAMES
    from ..dsp.wavetables import WAVE_NAMES
    from ..lang.program import NOISE_NAMES
    # The reference prints the *bare* name arrays for every topic
    # (sau/help.c:73-90 over sau/math.h:197-217) -- no '()' suffix on
    # functions, no '$' prefix on variables.
    return {
        'help': None,  # filled below
        'math': tuple(prim.MATH_NAMES),
        'variable': tuple(prim.MATH_VARS_NAMES),
        'line': tuple(LINE_NAMES),
        'wave': tuple(WAVE_NAMES),
        'noise': tuple(NOISE_NAMES),
    }


HELP_TOPICS = ('help', 'math', 'variable', 'line', 'wave', 'noise')


def find_help(topic):
    """sau_find_help (sau/help.c:34-48)."""
    names = get_help_names()
    names['help'] = HELP_TOPICS
    for key in HELP_TOPICS:
        if key.startswith(topic):
            return names[key]
    return None


def print_names(names, headstr='\t', out=None):
    """sau_print_names (sau/help.c:73-90): comma-separated list,
    wrapping to a new headstr-prefixed line when the running length
    reaches 56; returns True if anything was printed."""
    out = out or sys.stdout
    names = [n for n in names if n]
    if not names:
        return False
    ln = 0
    for i, name in enumerate(names):
        if ln > 0 and ln < 56:
            out.write(', %s' % name)
            ln += 2 + len(name)
        elif i > 0:
            out.write(',\n%s%s' % (headstr, name))
            ln = 2 + len(headstr) + len(name)
        else:
            out.write('%s%s' % (headstr, name))
            ln = len(headstr) + len(name)
    out.write('\n')
    return True
