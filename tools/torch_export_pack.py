#!/usr/bin/env python3
"""Build, snapshot or list the port's compiled-render pack
(saugns_tpu_torch/render/aotstore.py); the counterpart of
tools/export_pack.py.

``--build``: for every inline configuration (``Wsin``,
``FLAGSHIP_SCRIPT``, the 1024-voice PM and self-PM banks, and the
scripts behind tests/golden/torch_slice2.json's entries, each with the
generator's ``flat=`` its entry was made with), prepare a
``TorchGenerator`` and store its host products in the user directory
(``save_export()``), then write ``MANIFEST.json`` there: the code
hash, the sha256 of the wave tables, ``torch.__version__``, the
device's kind and a list of ``{script, key}`` entries.

``--snapshot``: copy the artifacts the manifest names, and the
manifest, into the pack directory saugns_tpu_torch/aot/exports/<platform>/
(listed in .gitignore: a pack goes stale with every change of the code
hash, so the repository ships none).

``--status``: list both directories.

Usage (``--device cuda`` by default; a key holds the device's kind, so
build on the card that will load the pack):
  python3 tools/torch_export_pack.py --build [--device cpu]
  python3 tools/torch_export_pack.py --snapshot [--device cpu]
  python3 tools/torch_export_pack.py --status [--device cpu]

Imports neither JAX nor the JAX package.
"""
import json
import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SRATE = 96000
MANIFEST = 'MANIFEST.json'


def configs():
    """(name, script, flat) of every inline configuration."""
    from chip_smoke import FLAGSHIP_SCRIPT
    from saugns_tpu_torch.parallel.voicebank import (
        make_bank_script, make_selfmod_bank_script)
    with open(os.path.join(REPO, 'tests', 'golden',
                           'torch_slice2.json')) as f:
        golden = json.load(f)['entries']
    out = [('wsin', 'Wsin', True), ('flagship', FLAGSHIP_SCRIPT, True),
           ('pm_bank_1024', make_bank_script(1024, seed=0, duration=1.0),
            True),
           ('selfmod_bank_1024',
            make_selfmod_bank_script(1024, seed=0, duration=1.0), True)]
    seen = {(s, f) for _n, s, f in out}
    for name, ent in sorted(golden.items()):
        flat = ent.get('flat', True)
        if (ent['script'], flat) not in seen:
            seen.add((ent['script'], flat))
            out.append(('golden:' + name, ent['script'], flat))
    return out


def build(device):
    import torch
    import saugns_tpu_torch as stt
    from saugns_tpu_torch.render import aotstore
    from saugns_tpu_torch.render.engine import TorchGenerator
    dev = torch.device(device)
    udir = aotstore._user_dir(dev.type)
    print('# building into %s (code %s, %s)'
          % (udir, aotstore.code_hash(), aotstore.device_kind(dev)),
          flush=True)
    built = present = 0
    entries = []
    for name, script, flat in configs():
        t0 = time.perf_counter()
        g = TorchGenerator(stt.compile_script(script), SRATE, dev,
                           flat=flat)
        entries.append({'script': name, 'key': g._key})
        if g.source != 'baked':
            present += 1
            continue
        p = g.save_export()
        built += 1
        print('  %-28s %7.2f s %10d B' % (name, time.perf_counter() - t0,
                                          os.path.getsize(p)), flush=True)
        del g
    print('# built %d, already present %d' % (built, present), flush=True)
    man = {'platform': dev.type, 'device': aotstore.device_kind(dev),
           'code_hash': aotstore.code_hash(),
           'tables_sha256': aotstore.tables_field(),
           'torch': torch.__version__, 'srate': SRATE,
           'entries': entries}
    os.makedirs(udir, exist_ok=True)
    with open(os.path.join(udir, MANIFEST), 'w') as f:
        json.dump(man, f, indent=1)
    return 0


def snapshot(platform):
    from saugns_tpu_torch.render import aotstore
    src = aotstore._user_dir(platform)
    dst = aotstore._pack_dir(platform)
    mp = os.path.join(src, MANIFEST)
    if not os.path.isfile(mp):
        print('no %s at %s: run --build first' % (MANIFEST, src))
        return 1
    with open(mp) as f:
        man = json.load(f)
    # only what the manifest (of the current code hash) names: the user
    # directory keeps artifacts of earlier code that never load again
    keep = {e['key'] + aotstore.SUFFIX for e in man['entries']}
    os.makedirs(dst, exist_ok=True)
    for fn in os.listdir(dst):
        os.unlink(os.path.join(dst, fn))
    n = total = 0
    for fn in sorted(keep) + [MANIFEST]:
        p = os.path.join(src, fn)
        if os.path.isfile(p):
            shutil.copyfile(p, os.path.join(dst, fn))
            n += 1
            total += os.path.getsize(p)
    print('snapshotted %d files (%.1f MiB) -> %s'
          % (n, total / 2**20, dst))
    return 0


def status(platform):
    from saugns_tpu_torch.render import aotstore
    print('code %s' % aotstore.code_hash())
    for label, d in (('user', aotstore._user_dir(platform)),
                     ('pack', aotstore._pack_dir(platform))):
        if not os.path.isdir(d):
            print('%s: none at %s' % (label, d))
            continue
        fs = [f for f in os.listdir(d) if f.endswith(aotstore.SUFFIX)]
        man = os.path.join(d, MANIFEST)
        note = ''
        if os.path.isfile(man):
            with open(man) as f:
                m = json.load(f)
            note = ' (manifest: %d entries, code %s, %s, torch %s)' % (
                len(m['entries']), m['code_hash'], m['device'], m['torch'])
        print('%s: %d artifacts at %s%s' % (label, len(fs), d, note))
    return 0


def main(argv):
    device = 'cuda'
    if '--device' in argv:
        device = argv[argv.index('--device') + 1]
    platform = device.split(':')[0]
    if '--build' in argv:
        return build(device)
    if '--snapshot' in argv:
        return snapshot(platform)
    if '--status' in argv:
        return status(platform)
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
