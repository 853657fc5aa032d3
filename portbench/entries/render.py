"""Entry ``render``: the call that the library's users and the CLI make,
``saugns_tpu_torch.render(text, srate=srate, device=device)``. Each
request compiles the script, builds a new ``TorchGenerator``, which
plans, bakes, uploads its tables and captures its graphs, and drains
``gen.run()`` in 4,096-frame buffers into an int16 (n, 2) array on the
host: the store of compiled renders keeps a prepared render only for a
program with a stored artifact, and neither the call nor the CLI stores
one. So every request prepares its own program, and the run's programs
are of one shape: set-up makes the same steps for the first program
alone (``WARM_ONE``), on a generator of its own, between the harness's
spans, and keeps its ``graph_stats()``."""
from __future__ import annotations

import numpy as np

FRAMES = 4096


def drain(gen):
    """int16 (n, 2) of ``gen.run()`` in FRAMES-frame buffers, the loop of
    ``saugns_tpu_torch.render``."""
    buf = np.zeros(FRAMES * 2, np.int16)
    chunks = []
    more = True
    while more:
        more, n = gen.run(buf, FRAMES, True)
        if n:
            chunks.append(buf[:n * 2].copy())
    return np.concatenate(chunks).reshape(-1, 2)


class Entry:
    WARM_ONE = True

    def __init__(self, prg, srate, device, label, text):
        """``prg``: the compiled program, prepared here for set-up's
        render, or None (a program set-up leaves alone)."""
        from saugns_tpu_torch.render.engine import TorchGenerator
        self.text = text
        self.srate = srate
        self.device = device
        self.label = label
        self.gen = None
        self.stats = None
        if prg is not None:
            self.gen = TorchGenerator(prg, srate, device=device)
            self.gen.prepare()

    def warm(self):
        """Set-up's render: the generator made above, driven as a
        request drives its own; then dropped."""
        out = drain(self.gen)
        self.stats = self.gen.graph_stats()
        self.gen = None
        return out

    def request(self):
        import saugns_tpu_torch as stt
        with self.label('entry.render'):
            return stt.render(self.text, srate=self.srate,
                              device=self.device)

    def graph_stats(self):
        return self.stats
