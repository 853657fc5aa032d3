"""Entry ``slab``: ``BankRender(prg, srate, device=device)``, the
voice axis as rows (slabs of up to 256 voices, one graph a slab shape),
prepared once a program; a request is ``render_i16()`` and its copy to
the host, an int16 (n, 2) array."""
from __future__ import annotations


class Entry:
    def __init__(self, prg, srate, device, label, text=None):
        from saugns_tpu_torch.parallel.voicebank import BankRender
        self.label = label
        self.bank = BankRender(prg, srate, device=device)
        self.bank.prepare()

    def request(self):
        with self.label('entry.render_i16'):
            out = self.bank.render_i16()
        with self.label('entry.fetch'):
            return out.cpu().numpy()

    def graph_stats(self):
        return self.bank.graph_stats()
