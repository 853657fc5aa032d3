"""Voice-bank scripts (``saugns_tpu/parallel/voicebank.py``): the
script generators only; the mesh-parallel bank renderer is not ported
yet."""
from __future__ import annotations

import numpy as np


def make_bank_script(n_voices: int, seed: int = 0,
                     duration: float = 1.0) -> str:
    """Generate a real SAU script: an n-voice PM bank (carrier with
    one phase modulator each, spread over pitch/index/pan). Parses
    through the ordinary frontend into n independent voices."""
    rng = np.random.RandomState(seed)
    lines = ['S a.m%.3f' % (1.0 / max(n_voices, 1))]
    for v in range(n_voices):
        freq = 110.0 * 2.0 ** (rng.randint(0, 36) / 12.0)
        ratio = rng.choice([0.5, 1.0, 1.5, 2.0, 3.0])
        index = rng.uniform(0.2, 1.5)
        pan = rng.uniform(-1.0, 1.0)
        lines.append(
            'Wsin f%.2f t%.3f a1 c%.3f p[Wsin r%.2f a%.3f]'
            % (freq, duration, pan, ratio, index))
    return '\n'.join(lines) + '\n'


def make_selfmod_bank_script(n_voices: int, seed: int = 0,
                             duration: float = 1.0) -> str:
    """n-voice bank where every carrier uses phase SELF-modulation
    ("feedback FM", wosc.h:273-310) with a per-voice strength --
    the structure of examples/sounds/bass-sounds.sau, uniform across
    voices."""
    rng = np.random.RandomState(seed)
    lines = ['S a.m%.3f' % (1.0 / max(n_voices, 1))]
    for v in range(n_voices):
        freq = 55.0 * 2.0 ** (rng.randint(0, 24) / 12.0)
        strength = rng.uniform(0.1, 0.6)
        pan = rng.uniform(-1.0, 1.0)
        lines.append('Wsin f%.2f t%.3f a1 c%.3f p.a%.3f'
                     % (freq, duration, pan, strength))
    return '\n'.join(lines) + '\n'
