"""Carry state across from the JAX package to the port.

The JAX package keeps its tables, plan records and packed state as
numpy arrays (or JAX arrays, which ``np.asarray`` turns into numpy);
these functions turn them into what the port consumes, checking shape
and type, so that both renderers can be fed identical inputs: a table
built by another compiler then can never pass for a kernel fault.
Nothing here imports JAX or the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from .dsp import wavetables as W
from .render.state import NF, NI


def tables(luts, piluts, device):
    """(luts, piluts), each (12, 2048) float32, as tensors on
    ``device``."""
    out = []
    for name, a in (('luts', luts), ('piluts', piluts)):
        a = np.asarray(a)
        if a.shape != (W.WAVE_NAMED, W.LEN) or a.dtype != np.float32:
            raise ValueError('%s: expected (%d, %d) float32, got %s %s'
                             % (name, W.WAVE_NAMED, W.LEN, a.shape,
                                a.dtype))
        out.append(torch.from_numpy(np.ascontiguousarray(a)).to(device))
    return tuple(out)


def records(rec_arrays):
    """RenderPlan.rec_arrays as the host numpy arrays the port applies
    (copied, types kept)."""
    return {k: np.array(v, copy=True) for k, v in rec_arrays.items()}


def state(st, device):
    """The packed state {'sf', 'si', 'vdur'} of engine.make_state as
    tensors on ``device``."""
    sf = np.asarray(st['sf'])
    si = np.asarray(st['si'])
    vdur = np.asarray(st['vdur'])
    if sf.ndim != 2 or sf.shape[1] != NF or sf.dtype != np.float32:
        raise ValueError('sf: expected (n, %d) float32' % NF)
    if si.shape != (sf.shape[0], NI) or si.dtype != np.int32:
        raise ValueError('si: expected (%d, %d) int32'
                         % (sf.shape[0], NI))
    if vdur.ndim != 1 or vdur.dtype != np.int32:
        raise ValueError('vdur: expected (n_voices,) int32')
    return {k: torch.from_numpy(np.array(a, copy=True)).to(device)
            for k, a in (('sf', sf), ('si', si), ('vdur', vdur))}
