"""Device meshes, and a closed-form voice bank rendered over one.

Counterpart of ``saugns_tpu/parallel/sharding.py``. The reference is
single-threaded (SURVEY.md §2.5); the natural scaling axes for SAU
rendering are:

- **voices** (data-parallel): independent carrier trees summed into one
  stereo mix (sau/generator.c:863-869) -- shard voices across devices
  and sum the shards' partial mixes;
- **time** (sequence-parallel): sample blocks; integer phasors are
  prefix sums, so a chunk's phases follow from its global start sample;
- **scripts** (batch): independent renders, trivially sharded.

A ``Mesh`` here is what one process drives: a numpy array of
``torch.device`` with named axes. A device may repeat (virtual shards
on one card or on the CPU). ``render_fm_bank`` below is a closed-form
FM voice bank (carrier + modulator per voice, swept freq/amp/pan) with
both mesh axes active; it runs no hand-written kernel. Rendering of
real compiled Programs over a mesh lives in ``voicebank`` and
``meshrender``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..render import tdsp

M32 = tdsp.M32


class Mesh:
    """``devices``: an array-like of torch devices (or their names),
    one axis per entry of ``axis_names``. ``shape`` maps each axis name
    to its extent."""

    def __init__(self, devices, axis_names):
        arr = np.asarray(devices, dtype=object)
        flat = np.empty(arr.size, dtype=object)
        flat[:] = [torch.device(d) for d in arr.ravel()]
        self.devices = flat.reshape(arr.shape)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError('Mesh: %d axis names for a %d-D device array'
                             % (len(self.axis_names), self.devices.ndim))
        self.shape = dict(zip(self.axis_names, self.devices.shape))


def make_mesh(n_devices: int, devices=None) -> Mesh:
    """Mesh over the first n of ``devices`` (resolve_devices: every
    visible CUDA device by default): 2D (voices x time) when there are
    enough devices for both axes, else 1D over voices."""
    from ..render.engine import resolve_devices
    devs = resolve_devices(devices)
    if len(devs) < n_devices:
        raise ValueError('make_mesh: %d devices asked for, %d given'
                         % (n_devices, len(devs)))
    devs = np.asarray(devs[:n_devices], dtype=object)
    if n_devices >= 4 and n_devices % 2 == 0:
        return Mesh(devs.reshape(n_devices // 2, 2), ('voices', 'time'))
    return Mesh(devs.reshape(n_devices), ('voices',))


def _fm_voice_chunk(phase_c, phase_m, freq, ratio, index, amp, pan,
                    n_local):
    """Render one time chunk of an FM voice bank.

    phase_c/phase_m: (V,) u32 (in int64) carrier/modulator phase at
    chunk start. freq: (V,) Hz; ratio: modulator ratio; index: PM
    index; amp, pan: (V,). Returns the mix (n_local, 2)."""
    dev = freq.device
    coeff = float(np.float32(4294967296.0 / 96000.0))
    inc_c = tdsp.ftoi(coeff * freq) & M32                     # (V,)
    inc_m = tdsp.ftoi(coeff * freq * ratio) & M32
    i = torch.arange(1, n_local + 1, dtype=torch.int64, device=dev)
    ph_m = (phase_m[:, None] + inc_m[:, None] * i[None, :]) & M32
    # sine phase-to-value directly (a sine wave is its own bandlimited
    # form; no table gather)
    two_pi_scale = float(np.float32(2.0 * np.pi / 4294967296.0))
    s_m = torch.sin(tdsp.asi32(ph_m).to(torch.float32) * two_pi_scale)
    ofs = tdsp.ftoi(s_m * index[:, None] * tdsp.P31) & M32
    ph_c = (phase_c[:, None] + inc_c[:, None] * i[None, :] + ofs) & M32
    s_c = torch.sin(tdsp.asi32(ph_c).to(torch.float32) * two_pi_scale)
    s = s_c * amp[:, None]
    s_r = s * pan[:, None]
    return torch.stack([(s - s_r).sum(0), (s + s_r).sum(0)], dim=-1)


def _shard_mix(args, t_base, n_local):
    """One (voices, time) shard: its voices' mix over its n_local
    samples from global sample t_base, in chunks of at most 8192."""
    freq, ratio, index, amp, pan = args
    coeff = float(np.float32(4294967296.0 / 96000.0))
    inc_c = tdsp.ftoi(coeff * freq) & M32
    inc_m = tdsp.ftoi(coeff * freq * ratio) & M32
    chunk = 8192
    while n_local % chunk:
        chunk //= 2
    mixes = []
    for ci in range(n_local // chunk):
        # time-parallel phasor: the phases at any chunk's start are the
        # increments times the global start sample (exact u32 wrap)
        t0 = (t_base + ci * chunk) & M32
        mixes.append(_fm_voice_chunk((inc_c * t0) & M32,
                                     (inc_m * t0) & M32, freq, ratio,
                                     index, amp, pan, chunk))
    return torch.cat(mixes)


def render_fm_bank(mesh: Mesh, freq, ratio, index, amp, pan, n_samples):
    """Mesh-parallel FM voice bank render.

    freq/ratio/index/amp/pan: (V,) float32 (numpy arrays or tensors),
    V divisible by the mesh's 'voices' axis; n_samples divisible by
    the 'time' axis (if present). Each shard renders its voices over
    its time range on its device; the voice shards' partials are summed
    in device order and the time shards concatenated. Returns the
    stereo mix (n_samples, 2) on the mesh's first device."""
    names = mesh.axis_names
    devs = mesh.devices if 'time' in names \
        else mesh.devices.reshape(-1, 1)
    if 'time' in names and names.index('time') == 0:
        devs = devs.T
    n_v, n_t = devs.shape
    n_local = n_samples // n_t
    vals = [torch.as_tensor(np.asarray(a, np.float32)) if not
            isinstance(a, torch.Tensor) else a.to(torch.float32)
            for a in (freq, ratio, index, amp, pan)]
    per = vals[0].shape[0] // n_v
    dev0 = devs[0, 0]
    parts = []
    for t in range(n_t):
        mix = None
        for v in range(n_v):
            dev = devs[v, t]
            args = [a[v * per:(v + 1) * per].to(dev) for a in vals]
            m = _shard_mix(args, t * n_local, n_local).to(dev0)
            mix = m if mix is None else mix + m
        parts.append(mix)
    return torch.cat(parts)


def sharded_args(mesh: Mesh, n_voices, n_samples, seed=0):
    """Example argument set for render_fm_bank (host float32 arrays;
    render_fm_bank places each shard's slice on its devices)."""
    rng = np.random.RandomState(seed)
    vdev = mesh.shape['voices']
    v = max(n_voices - n_voices % vdev, vdev)
    freq = (110.0 * 2.0 ** (rng.randint(0, 36, v) / 12.0)).astype(
        np.float32)
    ratio = rng.choice([0.5, 1.0, 1.5, 2.0, 3.0], v).astype(np.float32)
    index = rng.uniform(0.0, 2.0, v).astype(np.float32)
    amp = np.full(v, 1.0 / v, np.float32)
    pan = rng.uniform(-1.0, 1.0, v).astype(np.float32)
    return (freq, ratio, index, amp, pan), n_samples
