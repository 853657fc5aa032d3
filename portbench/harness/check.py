"""The comparison that decides ``correct``: every answer of the window
against the reference's render of its program.

Three numbers, each the worst over the window's answers:

- ``differ_share``: the share (%) of an answer's int16 values that
  differ from the reference's;
- ``rms_lsb``: the root mean square of an answer's difference from the
  reference, in int16 steps;
- ``max_gap_lsb``: its largest difference, in int16 steps.

An answer of another shape reads as infinite. Their limits are in
``limits/<config>.json`` (PERF.md gives the readings they were set
from).
"""
from __future__ import annotations

import hashlib
import math

import numpy as np

COMPARED = ('differ_share', 'rms_lsb', 'max_gap_lsb')


def numbers(answer, ref):
    """The compared numbers of one answer."""
    a = np.asarray(answer)
    if a.shape != ref.shape or a.dtype != np.int16:
        return {'differ_share': math.inf, 'rms_lsb': math.inf,
                'max_gap_lsb': math.inf}
    d = a.astype(np.int64) - ref.astype(np.int64)
    return {'differ_share': float(100.0 * np.count_nonzero(d) / d.size),
            'rms_lsb': float(np.sqrt(np.mean(d.astype(np.float64) ** 2))),
            'max_gap_lsb': float(np.abs(d).max()) if d.size else 0.0}


def worst(answers, refs):
    """The worst numbers over ``answers`` ([(program index, int16
    array)]) against ``refs`` (one int16 array a program)."""
    out = {'differ_share': 0.0, 'rms_lsb': 0.0, 'max_gap_lsb': 0.0}
    seen = {}
    for k, a in answers:
        key = (k, hashlib.sha1(a.tobytes()).digest()
               if isinstance(a, np.ndarray) else repr(a))
        if key not in seen:
            seen[key] = numbers(a, refs[k])
        for name, v in seen[key].items():
            out[name] = max(out[name], v)
    return out


def judge(nums, limits):
    """(correct, {name: {'value', 'limit'}}) for the compared numbers."""
    checks = {n: {'value': nums[n], 'limit': limits[n]} for n in COMPARED}
    ok = all(c['value'] <= c['limit'] for c in checks.values())
    return ok, checks
