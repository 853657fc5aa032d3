"""Wave table inspection utility (sauWave_print, sau/wave.c:220-301).

Prints, per wave type, the plain-LUT and pre-integrated-LUT statistics
the reference's dev utility reports: min/max amplitude, DC offset, and
the PILUT scale/offset coefficients used by the differentiating
oscillator. Run as a module for the dev dump:

    python -m saugns_tpu_torch.utils.waveprint [wave ...]
"""
from __future__ import annotations

import sys

import numpy as np

from ..dsp import wavetables as W


def wave_stats(wave: int):
    """(lut_min, lut_max, lut_dc, pilut_min, pilut_max, pilut_dc)."""
    luts, piluts = W.get_tables()
    lut = np.asarray(luts[wave], dtype=np.float64)
    pil = np.asarray(piluts[wave], dtype=np.float64)
    return (lut.min(), lut.max(), lut.mean(),
            pil.min(), pil.max(), pil.mean())


def print_wave(wave: int, out=None):
    out = out or sys.stdout
    name = W.WAVE_NAMES[wave]
    lmin, lmax, ldc, pmin, pmax, pdc = wave_stats(wave)
    print("wave: %s" % name, file=out)
    print("\tLUT:   min %+.11f, max %+.11f, dc %+.11f"
          % (lmin, lmax, ldc), file=out)
    print("\tPILUT: min %+.11f, max %+.11f, dc %+.11f"
          % (pmin, pmax, pdc), file=out)
    print("\tcoeffs: amp_scale %.11f, amp_dc %+.11f, phase_adj 0x%08X"
          % (W.PICOEFF_AMP_SCALE[wave], W.PICOEFF_AMP_DC[wave],
             W.PICOEFF_PHASE_ADJ[wave]), file=out)


def main(argv):
    names = argv or list(W.WAVE_NAMES)
    for n in names:
        if n not in W.WAVE_NAMES:
            print("unknown wave '%s'; available are:" % n,
                  file=sys.stderr)
            print('\t' + ', '.join(W.WAVE_NAMES), file=sys.stderr)
            return 1
        print_wave(W.WAVE_NAMES.index(n))
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
