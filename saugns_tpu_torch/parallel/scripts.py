"""Multi-script sharding: render independent programs concurrently
across devices.

Counterpart of ``saugns_tpu/parallel/scripts.py``. The reference
renders a script list serially (saugns.c:648-659); the renders are
independent -- the only ordering requirement is the output order
(audio device / file / stdout writes). Here the programs go round-robin
over the devices, each device with a worker thread of its own that
renders its programs in turn (a TorchGenerator on that device, which
replays CUDA graphs there), and the results are consumed strictly in
program order, so the sink output is byte-identical to the serial path.

Host memory is bounded by ``max_buffer_samples`` per in-flight render
(pre-rendered int16); programs longer than the cap render serially
through the ordinary streaming generator instead.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np


class PrerenderedGenerator:
    """sauGenerator_run-compatible delivery from a pre-rendered host
    int16 array ((n, 2) stereo or (n,) mono)."""

    def __init__(self, arr: np.ndarray, stereo: bool):
        self.arr = arr
        self.stereo = stereo
        self.pos = 0

    def run(self, out_i16, buf_len, stereo):
        assert stereo == self.stereo
        out_i16[:] = 0
        n = len(self.arr) - self.pos
        take = min(buf_len, n)
        part = self.arr[self.pos:self.pos + take]
        if stereo:
            out_i16[:take * 2:2] = part[:, 0]
            out_i16[1:take * 2:2] = part[:, 1]
        else:
            out_i16[:take] = part
        self.pos += take
        if self.pos >= len(self.arr):
            return False, take
        return True, buf_len


def _render_on_device(prg, srate, stereo, device):
    """Full render of one program on ``device``; returns the host int16
    array."""
    from ..render.engine import TorchGenerator
    chunks = list(TorchGenerator(prg, srate, device)._stream_i16(stereo))
    if not chunks:
        return np.zeros((0, 2) if stereo else 0, np.int16)
    return np.concatenate(chunks, axis=0)


class ShardedRenderQueue:
    """Pre-renders a program list across devices; ``generator(i)``
    returns a run()-compatible generator for program i (pre-rendered
    if it was sharded, else None -- the caller uses the serial path).
    A render that failed raises there.

    Sharding applies when there are two or more devices and programs;
    SAUGNS_TPU_SHARD_SCRIPTS=0 disables it. ``devices``: a list of
    torch devices (resolve_devices; a repeated device gets a worker of
    its own)."""

    def __init__(self, prgs: List, srate: int, stereo: bool,
                 devices=None, max_buffer_samples: int = 1 << 25):
        from ..render.engine import resolve_devices
        self.prgs = prgs
        self.futures = {}
        self._workers = []
        if os.environ.get('SAUGNS_TPU_SHARD_SCRIPTS', '1') != '1':
            return
        devices = resolve_devices(devices)
        live = [i for i, p in enumerate(prgs) if p is not None]
        if len(devices) < 2 or len(live) < 2:
            return
        from ..render.plan import RenderPlan
        self._workers = [ThreadPoolExecutor(max_workers=1)
                         for _ in devices]
        for k, i in enumerate(live):
            prg = prgs[i]
            if RenderPlan(prg, srate).signal_end > max_buffer_samples:
                continue  # stream serially; don't buffer minutes of audio
            d = k % len(devices)
            self.futures[i] = self._workers[d].submit(
                _render_on_device, prg, srate, stereo, devices[d])

    def generator(self, i: int) -> Optional[PrerenderedGenerator]:
        fut = self.futures.get(i)
        if fut is None:
            return None
        arr = fut.result()
        return PrerenderedGenerator(arr, arr.ndim == 2)

    def close(self):
        """Cancel the renders not started and wait for the running
        ones: no worker outlives the queue."""
        for ex in self._workers:
            ex.shutdown(wait=True, cancel_futures=True)
