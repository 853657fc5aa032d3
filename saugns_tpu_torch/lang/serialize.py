"""Serialized Program IR: a stable on-disk artifact of the compile
stage (SURVEY §5 checkpoint/resume: the reference's sauProgram is an
immutable, reusable artifact -- render is a pure function of
(program, srate), proven by the dual-rate player, saugns.c:585-599 --
but exists only in memory; here it becomes an explicit file).

Format: versioned JSON. Floats are stored as C99 hex literals
(float.hex()) so every value round-trips bit-exactly -- a deserialized
program's ``-p`` dump and rendered audio are byte-identical to the
original's.
"""
from __future__ import annotations

import json

from . import program as P
from .script import ScriptOptions

MAGIC = 'saugns-tpu-ir'
VERSION = 1


def _enc_f(x):
    return float(x).hex()


def _dec_f(s):
    return float.fromhex(s) if isinstance(s, str) else float(s)


def _enc_line(ln):
    if ln is None:
        return None
    return [_enc_f(ln.v0), _enc_f(ln.vt), ln.pos, ln.end, ln.time_ms,
            ln.type, ln.flags]


def _dec_line(v):
    if v is None:
        return None
    return P.Line(_dec_f(v[0]), _dec_f(v[1]), v[2], v[3], v[4], v[5],
                  v[6])


def _enc_opdata(od):
    d = {
        'id': od.id, 'params': od.params,
        'time': [od.time.v_ms, od.time.flags],
        'phase': od.phase, 'seed': od.seed,
        'use_type': od.use_type, 'type': od.type,
        'mode_main': od.mode_main,
    }
    for f in ('pan', 'amp', 'amp2', 'freq', 'freq2', 'pm_a'):
        ln = getattr(od, f)
        if ln is not None:
            d[f] = _enc_line(ln)
    if od.mode_ras is not None:
        r = od.mode_ras
        d['mode_ras'] = [r.line, r.flags, r.func, r.level, r.alpha]
    for f in P.OpData.MOD_FIELDS:
        mods = getattr(od, f)
        if mods is not None:
            d[f] = list(mods)
    return d


def _dec_opdata(d):
    od = P.OpData(
        id=d['id'], params=d['params'],
        time=P.Time(d['time'][0], d['time'][1]),
        phase=d['phase'], seed=d['seed'],
        use_type=d['use_type'], type=d['type'],
        mode_main=d['mode_main'])
    for f in ('pan', 'amp', 'amp2', 'freq', 'freq2', 'pm_a'):
        if f in d:
            setattr(od, f, _dec_line(d[f]))
    if 'mode_ras' in d:
        v = d['mode_ras']
        od.mode_ras = P.RasOpt(v[0], v[1], v[2], v[3], v[4])
    for f in P.OpData.MOD_FIELDS:
        if f in d:
            setattr(od, f, tuple(d[f]))
    return od


def _enc_event(ev):
    d = {'wait_ms': ev.wait_ms, 'vo_id': ev.vo_id,
         'carr_op_id': ev.carr_op_id,
         'op_data': [_enc_opdata(od) for od in ev.op_data]}
    if ev.op_list is not None:
        d['op_list'] = [[r.id, r.use, r.level] for r in ev.op_list]
    return d


def _dec_event(d):
    ev = P.Event(wait_ms=d['wait_ms'], vo_id=d['vo_id'],
                 carr_op_id=d['carr_op_id'],
                 op_data=[_dec_opdata(x) for x in d['op_data']])
    if 'op_list' in d:
        ev.op_list = [P.OpRef(r[0], r[1], r[2]) for r in d['op_list']]
    return ev


def program_to_dict(prg):
    d = {
        'magic': MAGIC, 'version': VERSION,
        'name': prg.name,
        'mode': prg.mode,
        'vo_count': prg.vo_count,
        'op_count': prg.op_count,
        'op_nest_depth': prg.op_nest_depth,
        'duration_ms': prg.duration_ms,
        'ampmult': _enc_f(prg.ampmult),
        'events': [_enc_event(ev) for ev in prg.events],
    }
    if prg.sopt is not None:
        s = prg.sopt
        d['sopt'] = {
            'set': s.set, 'ampmult': _enc_f(s.ampmult),
            'A4_freq': _enc_f(s.A4_freq),
            'def_time_ms': s.def_time_ms,
            'def_ampmult': _enc_f(s.def_ampmult),
            'def_freq': _enc_f(s.def_freq),
            'def_relfreq': _enc_f(s.def_relfreq),
            'def_chanmix': _enc_f(s.def_chanmix),
            'note_key': s.note_key, 'key_octave': s.key_octave,
            'key_system': s.key_system,
        }
    return d


def program_from_dict(d):
    if d.get('magic') != MAGIC:
        raise ValueError('not a saugns-tpu IR file')
    if d.get('version') != VERSION:
        raise ValueError('unsupported IR version %r' % (d.get('version'),))
    prg = P.Program(
        events=[_dec_event(x) for x in d['events']],
        mode=d['mode'], vo_count=d['vo_count'], op_count=d['op_count'],
        op_nest_depth=d['op_nest_depth'],
        duration_ms=d['duration_ms'], ampmult=_dec_f(d['ampmult']),
        name=d['name'])
    if 'sopt' in d:
        s = d['sopt']
        prg.sopt = ScriptOptions(
            set=s['set'], ampmult=_dec_f(s['ampmult']),
            A4_freq=_dec_f(s['A4_freq']), def_time_ms=s['def_time_ms'],
            def_ampmult=_dec_f(s['def_ampmult']),
            def_freq=_dec_f(s['def_freq']),
            def_relfreq=_dec_f(s['def_relfreq']),
            def_chanmix=_dec_f(s['def_chanmix']),
            note_key=s['note_key'], key_octave=s['key_octave'],
            key_system=s['key_system'])
    return prg


def save_program(prg, path):
    """Write the program IR to ``path`` (JSON, bit-exact floats)."""
    with open(path, 'w') as f:
        json.dump(program_to_dict(prg), f, separators=(',', ':'))
        f.write('\n')


def load_program(path):
    """Read a program IR written by save_program."""
    with open(path) as f:
        return program_from_dict(json.load(f))
