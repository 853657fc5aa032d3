"""Seeded SAU script writer: the programs of one run.

A frozen copy of the logic of ``saugns_tpu_torch.parallel.voicebank``'s
``make_bank_script`` and ``make_selfmod_bank_script``, driven by data: a
configuration gives the header, the voice line with ``{name}`` fields
and each field's distribution; a traffic mix gives the voice count, the
duration and the number of programs. Every seed gives programs of the
same sizes (voices, duration); only the drawn parameters differ.

A field's spec is one of:

- ``{"value": text}``: written as is;
- ``{"pitch": {"base_hz": b, "semitones": [lo, hi]}, "format": f}``:
  ``b * 2^(k/12)`` for a whole k drawn from lo..hi;
- ``{"choice": [x, ...], "format": f}``: one of the values;
- ``{"uniform": [lo, hi], "format": f}``: drawn from [lo, hi);
- ``{"share": "voices", "format": f}``: one over the voice count (the
  header's mix gain);
- ``{"traffic": key, "format": f}``: the traffic mix's value of ``key``
  (the duration).

Fields are drawn voice after voice, in the order the configuration
lists them.
"""
from __future__ import annotations

import string

import numpy as np


def _fields(template):
    return [f for _t, f, _s, _c in string.Formatter().parse(template) if f]


def _value(spec, rng, traffic, voices):
    if 'value' in spec:
        return str(spec['value'])
    fmt = spec['format']
    if 'pitch' in spec:
        p = spec['pitch']
        lo, hi = p['semitones']
        return fmt % (p['base_hz'] * 2.0 ** (int(rng.integers(lo, hi + 1))
                                             / 12.0))
    if 'choice' in spec:
        return fmt % spec['choice'][int(rng.integers(len(spec['choice'])))]
    if 'uniform' in spec:
        lo, hi = spec['uniform']
        return fmt % rng.uniform(lo, hi)
    if 'share' in spec:
        return fmt % (1.0 / max(voices, 1))
    if 'traffic' in spec:
        return fmt % traffic[spec['traffic']]
    raise ValueError('unknown field spec %r' % (spec,))


def rng_of(seed, k):
    """The generator of program ``k`` of a run with ``seed`` (any whole
    number; negative ones and those past 64 bits wrap)."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) & ((1 << 64) - 1), int(k)]))


def write(config, traffic, seed):
    """The run's programs: a list of ``{'text': SAU text, 'bank': the
    written parameters}``, where ``bank`` = {'kind', 'ampmult',
    'voices': [{field: text}, ...]} is what the reference renders."""
    voices = int(traffic['voices'])
    params = config['params']
    head_fields = _fields(config['header'])
    line_fields = _fields(config['line'])
    progs = []
    for k in range(int(traffic['programs'])):
        rng = rng_of(seed, k)
        head = {f: _value(params[f], rng, traffic, voices)
                for f in head_fields}
        lines = [config['header'].format(**head)]
        written = []
        for _v in range(voices):
            vals = {}
            for name, spec in params.items():
                if name in line_fields:
                    vals[name] = _value(spec, rng, traffic, voices)
            lines.append(config['line'].format(**vals))
            written.append(vals)
        bank = {'kind': config['reference'],
                'ampmult': head[config['mix_gain']], 'voices': written}
        progs.append({'text': '\n'.join(lines) + '\n', 'bank': bank})
    return progs
