"""Note frequency evaluation: 4 tuning systems, keys, microtonal
accidentals, subnote interpolation, MIDI note numbers.

Port of sau/parser.c:25-46,518-739 (get_note_freq, scan_note_const,
scan_note_midinum). Tables are float32 like the C ``static const float``
arrays; the computation runs in double precision.
"""
from __future__ import annotations

import numpy as np

f32 = np.float32

OCTAVES = 11


def MUSKEY(note, notemod):
    return note * 9 + 4 + notemod


def MUSNOTE(key):
    return key // 9


def notemod_of(c: str) -> int:
    """Accidental char to modifier (sau/parser.c:30-44)."""
    return {'d': -1, 'z': +1, 'f': -2, 'b': -2, 's': +2,
            'v': -3, 'k': +3, 'w': -4, 'x': +4}.get(c, 0)


def note12to7(n):
    return (n + 1) // 2 if n >= 5 else n // 2


def note7to12(n):
    return (n * 2) - 1 if n >= 3 else n * 2


def _f32a(vals):
    return [float(f32(v)) for v in vals]


# SAU JI tables (sau/parser.c:524-566)
NOTES_SAU_JI = [
    _f32a([24/25, 711/700, 15/14, 159/140, 6/5, 21/16, 307/224, 10/7,
           106/70, 8/5, 17/10, 9/5]),
    _f32a([1/1, 17/16, 9/8, 19/16, 5/4, 4/3, 17/12, 3/2, 19/12, 5/3,
           85/48, 15/8]),
    _f32a([25/24, 53/48, 7/6, 103/84, 9/7, 7/5, 133/90, 14/9, 119/72,
           7/4, 307/168, 40/21]),
]

# main tables (sau/parser.c:567-612): 0 = 24-EDO, 1 = 5-limit JI,
# 2 = Pythagorean JI
NOTES_MAIN = [
    _f32a([1.0, 1.0594630943592952646, 1.1224620483093729814,
           1.1892071150027210667, 1.2599210498948731648,
           1.3348398541700343648, 1.4142135623730950488,
           1.4983070768766814988, 1.5874010519681994748,
           1.6817928305074290860, 1.7817974362806786095,
           1.8877486253633869932]),
    _f32a([1/1, 17/16, 9/8, 19/16, 5/4, 4/3, 17/12, 3/2, 19/12, 5/3,
           85/48, 15/8]),
    _f32a([1/1, 17/16, 9/8, 153/128, 81/64, 4/3, 17/12, 3/2, 51/32,
           27/16, 459/256, 243/128]),
]

NOTEMODS_MAIN = [
    _f32a([1.0293022366434920288, 1.0594630943592952646,
           1.0905077326652576592, 1.1224620483093729814]),
    _f32a([36/35, 25/24, (25/24) * (36/35), (25/24) * (25/24)]),
    _f32a([36/35, 2187/2048, (2187/2048) * (36/35),
           (2187/2048) * (2187/2048)]),
]


def get_note_freq(sopt, note: int, notemod: int, subnote: int) -> float:
    """sau/parser.c:521-668. ``note`` is a 0-11 chromatic index."""
    freq = sopt.A4_freq
    system = sopt.key_system
    if system < 3:
        notes = NOTES_MAIN[system]
        notemods = NOTEMODS_MAIN[system]
        freq /= notes[9]
    else:  # SAU JI
        key_table = 1
        if notemod >= 2:
            key_table += 1
            notemod -= 2
        elif notemod <= -2:
            key_table -= 1
            notemod += 2
        notes = NOTES_SAU_JI[key_table]
        notemods = NOTEMODS_MAIN[1]
        freq /= NOTES_SAU_JI[1][9]
    key = sopt.note_key
    key_note = note7to12(MUSNOTE(key))
    note -= key_note
    if note < 0:
        note += 12
        freq *= 0.5
    # C: notes[note] * notes[key_note] is a float (f32) product
    freq *= float(f32(notes[note]) * f32(notes[key_note]))
    if notemod < 0:
        freq /= notemods[(-notemod) - 1]
    elif notemod > 0:
        freq *= notemods[notemod - 1]
    if subnote >= 0:
        lonote = notes[note]
        note7 = note12to7(note)
        hinote = notes[note7to12(note7 + 1)] if note7 < 6 else 2 * notes[0]
        # C: (notes[subnote] - 1.f) is a float (f32) subtraction
        freq *= 1.0 + (hinote / lonote - 1.0) * float(f32(notes[subnote])
                                                      - f32(1.0))
    return freq


def OCTAVE(n):
    """Standard octave multiplier (sau/parser.c:519)."""
    return (1 << (n + 1)) * (1.0 / 32)


def OCTAVE_MIDI(n):
    return (1 << n) * (1.0 / 32)


def scan_note_midinum(sc, val_out) -> int:
    """sau/parser.c:670-691. Reads from file level; returns chars read."""
    sl = sc.data
    note, length = sc._file_geti(False)
    vmin, vmax, default_note = 0, 127, 69
    if length == 0:
        sc.warning(None, "MIDI note number missing after 'M' "
                   "(valid range %d-%d)" % (vmin, vmax))
    elif note > vmax:
        sc.warning(None, "invalid MIDI note number, using %d "
                   "(valid range %d-%d)" % (default_note, vmin, vmax))
        note = default_note
    nm = notemod_of(sc.file_getc())
    if nm != 0:
        length += 1
    else:
        sc.file_decp()
    freq = get_note_freq(sl.sopt, note % 12, nm, -1)
    val_out[0] = freq * OCTAVE_MIDI(note // 12)
    return length


def scan_note_const(sc, val_out) -> int:
    """Named-note numeric constant reader (sau/parser.c:693-739)."""
    length = 0
    c = sc.file_getc()
    length += 1
    if c == 'M':
        num_len = scan_note_midinum(sc, val_out)
        if not num_len:
            sc.file_ungetn(length)
            return 0
        return length + num_len
    sl = sc.data
    key = sl.sopt.note_key
    key_note = MUSNOTE(key)
    subnote = -1
    if 'a' <= c <= 'g':
        ci = ord(c) - ord('c')
        if ci < 0:
            ci += 7
        ci -= key_note
        if ci < 0:
            ci += 7
        subnote = note7to12(ci)
        c = sc.file_getc()
        length += 1
    if c < 'A' or c > 'G':
        sc.file_ungetn(length)
        return 0
    ci = ord(c) - ord('C')
    if ci < 0:
        ci += 7
    note = ci
    default_octave = sl.sopt.key_octave
    nm = notemod_of(sc.file_getc())
    if nm != 0:
        length += 1
    else:
        sc.file_decp()
    if MUSKEY(note, nm) < key:  # wrap around below chosen key
        default_octave += 1
    octave, num_len = sc._file_geti(False)
    length += num_len
    if num_len == 0:
        octave = default_octave
    elif octave >= OCTAVES:
        sc.warning(None, "invalid note octave number, using %d "
                   "(valid range 0-10)" % default_octave)
        octave = default_octave
    freq = get_note_freq(sl.sopt, note7to12(note), nm, subnote)
    val_out[0] = freq * OCTAVE(octave)
    return length
