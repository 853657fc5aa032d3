"""The published peaks of one NVIDIA H100 SXM (data sheet, dense, at
the 700 W power limit) and the least work of the port's kernels.

Bytes and operations are those of the algorithm, per output sample, at
the least width of its inputs and outputs: a u32 phase in and a
float32 sample out (the wave table is 8 KB, read from cache). The
operations are the f64 Hermite interpolation and differentiation of
the saugns chain (sau/wave.h:127-145, wosc.h:238-310), counted from
the C: the fraction scale 1, c1 1, c2 5, c3 3, Horner 6,
``(Is - Is_prev) * x + offset`` 3; in float32 the three tap
differences, ``2 * s2`` and the division; self-PM adds the f64
``* 2^31`` and the float32 ``fb * a``, ``fb + s`` and ``* 0.5``.
Least time is the largest of bytes over the memory bandwidth and each
type's operations over its rate, so no kernel can read over 100%.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP64_PER_S = 34e12
FP32_PER_S = 67e12

# per output sample: bytes, float64 and float32 operations
KERNELS = {
    'wosc_fill': {'bytes': 8, 'fp64': 19, 'fp32': 5},
    'wosc_selfmod': {'bytes': 8, 'fp64': 20, 'fp32': 8},
}


def least_seconds(kernel, samples):
    w = KERNELS[kernel]
    return max(samples * w['bytes'] / HBM_BYTES_PER_S,
               samples * w['fp64'] / FP64_PER_S,
               samples * w['fp32'] / FP32_PER_S)


def share(kernel, samples, device_seconds):
    """Roofline share in %, or None where there is nothing to read."""
    if not samples or not device_seconds or device_seconds <= 0:
        return None
    return 100.0 * least_seconds(kernel, samples) / device_seconds
