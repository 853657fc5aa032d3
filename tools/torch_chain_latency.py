#!/usr/bin/env python3
"""Latency bound of the self-PM kernels' loop-carried chains (kernels 5
and 6 of saugns_tpu_torch) on one CUDA card.

    python3 tools/torch_chain_latency.py [--sass OUTDIR ROOT [ROOT ...]]

Builds ``tools/chain_latency.cu`` with nvcc into the port's build
directory (``saugns_tpu_torch/_build/``), times a long dependent chain
of each instruction class on the card with ``clock64()`` (one thread;
cycles per operation), measures the SM clock against the global
nanosecond timer, and prints one JSON line: the card's name and power
limit, the cycles per operation of each class, the clock in GHz, for
each chain below its critical path and its bound in cycles and in
nanoseconds per sample, and the throughput of float64 multiplies,
float32<->float64 conversions, float32<->u32 conversions and the
reciprocal unit in operations per clock and SM (a full grid of
independent chains timed by CUDA events, at the measured clock).

The chains are the loop-carried critical paths from ``fb`` to the next
sample's ``fb``, read from ``cuobjdump -sass`` of each kernel (the
parent's build and this tree's): a list is a path in order, a tuple
(``par``) the longest of its branches. The bound of a chain is the sum
of its operations' latencies: no schedule of those instructions on one
lane can be faster.

With ``--sass OUTDIR ROOT ...`` it also builds the kernels of each
checkout ROOT (in a process of its own) and writes the SASS of their
self-PM kernels and of kernels 1 and 9, each function's static count of
each opcode (``opcodes_<root>.json``), and nvcc's register and spill
report of their sources, to OUTDIR. Imports neither JAX nor the JAX package.
"""
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SRC = os.path.join(HERE, 'chain_latency.cu')
REPS = 4000


def par(*paths):
    """The longest of several paths that run side by side."""
    return ('par',) + paths


# The loop-carried chains (one sample, fb -> fb), read from the SASS of
# each build (cuobjdump -sass; --sass below writes it); the operation
# names are the probe's latency classes (IMAD.IADD, IMAD.SHL and
# IMAD.MOV are 'imad'; VIADD 'iadd3'). Branches are not priced: a chain
# through a branch is bounded by its priced operations only.
CHAINS = {
    # parent kernel 5 (one thread a row, as at commit 08c4608), one
    # sample: phase, then pd and its branch (pd == 0 skips the Hermite), the
    # cell's four taps from shared memory (the s3 and s0 loads are the
    # last, through a VIADD and a LOP3), c3 = 0.5 (s3 - s0) + 1.5
    # (s1 - s2) built per sample, the Horner, the sample and fb
    'k5_parent': [
        'fmul', 'fmul', 'f2i_s64', 'imad', 'imad', 'isetp_sel',
        'shf', 'lop3', 'iadd3', 'lop3', 'lds32', 'fadd', 'f2d', 'dmul',
        'dadd', 'dmul', 'dadd', 'dmul', 'dadd', 'dmul', 'dadd',
        'dadd', 'dmul', 'dadd', 'd2f', 'fadd', 'fmul'],
    # this tree's kernel 5: the cell's 32-byte coefficient record (two
    # LDS.128) beside x, the 6-operation Horner and Is2 - Is1, beside
    # dvs / pd (I2FP, the division, F2F), then the sample, its pd == 0
    # select, and fb (predicated on the gate)
    'k5': [
        'fmul', 'fmul', 'f2i_s64', 'imad',
        par([par(['shf', 'lop3', 'lds128'],
                 ['lop3', 'i2f_u32', 'fmul', 'f2d']),
             'dmul', 'dadd', 'dmul', 'dadd', 'dmul', 'dadd', 'dadd'],
            ['imad', 'isetp_sel', 'i2f_s32', 'fdiv', 'f2d']),
        'dmul', 'dadd', 'd2f', 'fsel', 'fadd', 'fmul'],
    # kernel 6, fixed function at level 27 (the +-1 pair), cos line, no
    # flags: the mode chip_smoke.py times and the 10 s RasG self-PM
    # script's. Parent: the phase, floor and the cos line's polynomial
    # and blend, then fb; its branches (function, flags, the line
    # type's indirect jump) and the gate's and amount's global loads
    # before the chain's first multiply are not priced
    'k6_parent': [
        'fmul', 'fmul', 'fadd', 'f2i_s32_rd', 'i2f_s32', 'fadd',
        'fadd', 'fmul', 'fmul', 'fadd', 'fmul', 'fadd', 'fmul', 'fadd',
        'fmul', 'fadd', 'fadd', 'fadd', 'fmul'],
    # this tree's kernel 6 in that mode: the same phase path beside the
    # endpoints' path (cycle, its parity, the select of the even or odd
    # pair, b - a); ISETP is priced as the probe's ISETP + SEL pair
    'k6': [
        'fmul', 'fmul', 'fadd', 'f2i_s32_rd',
        par(['i2f_s32', 'fadd', 'fadd', 'fmul', 'fmul', 'fadd', 'fmul',
             'fadd', 'fmul', 'fadd'],
            ['imad', 'lop3', 'isetp_sel', 'fsel', 'fadd']),
        'fmul', 'fadd', 'fadd', 'fadd', 'fmul'],
}


def chain_cycles(chain, lat):
    """Cycles of a chain (list: in order; par tuple: the longest
    branch) under the latencies ``lat`` (cycles per operation)."""
    if isinstance(chain, str):
        return lat[chain]
    if isinstance(chain, tuple) and chain and chain[0] == 'par':
        return max(chain_cycles(c, lat) for c in chain[1:])
    return sum(chain_cycles(c, lat) for c in chain)


def chain_ops(chain):
    """Operations along a chain's longest-count path (list: in order;
    par: the branch with the most operations)."""
    if isinstance(chain, str):
        return 1
    if isinstance(chain, tuple) and chain and chain[0] == 'par':
        return max(chain_ops(c) for c in chain[1:])
    return sum(chain_ops(c) for c in chain)


def _nvcc():
    sys.path.insert(0, ROOT)
    from saugns_tpu_torch import kernels
    return kernels._nvcc(), kernels.NVCC_FLAGS


def build():
    """Compile the probe (once per source hash); returns its path."""
    nvcc, flags = _nvcc()
    from saugns_tpu_torch.native import BUILD_DIR
    with open(SRC, 'rb') as f:
        h = hashlib.sha256(f.read() + ' '.join(flags).encode())
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, 'chain_latency_%s.so'
                      % h.hexdigest()[:16])
    if not os.path.exists(so):
        tmp = '%s.%d.tmp' % (so, os.getpid())
        r = subprocess.run([nvcc, *flags, '-shared', '-o', tmp, SRC],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
        if r.returncode != 0:
            raise RuntimeError('nvcc failed on %s:\n%s' % (SRC, r.stdout))
        os.replace(tmp, so)
    return so


def start_build():
    """Start the probe's build in the background (a thread); returns a
    function that waits for it and returns the library's path."""
    import threading
    box = {}

    def run():
        try:
            box['so'] = build()
        except Exception as e:  # noqa: BLE001 -- re-raised by the waiter
            box['err'] = e

    t = threading.Thread(target=run)
    t.start()

    def wait():
        t.join()
        if 'err' in box:
            raise box['err']
        return box['so']
    return wait


def measure(so=None, reps=REPS):
    """{'cycles': {op: cycles per operation}, 'ghz': SM clock} on the
    current CUDA device."""
    lib = ctypes.CDLL(so or build())
    lib.saugns_chain_probe_names.restype = ctypes.c_char_p
    names = lib.saugns_chain_probe_names().decode().split(',')
    cyc = (ctypes.c_longlong * len(names))()
    clk = (ctypes.c_longlong * 2)()
    n = ctypes.c_longlong()
    lib.saugns_chain_probe.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                       ctypes.c_void_p, ctypes.c_void_p]
    rc = lib.saugns_chain_probe(reps, ctypes.addressof(cyc),
                                ctypes.addressof(clk), ctypes.byref(n))
    if rc != 0:
        raise RuntimeError('chain probe failed with cudaError_t %d' % rc)
    lat = {k: cyc[i] / n.value for i, k in enumerate(names)}
    # latencies the probe gets as a difference of two chains
    lat['lop3'] = lat['xor_add'] - lat['iadd3']
    lat['d2f'] = lat['f2d_d2f'] - lat['f2d']
    return {'cycles': lat, 'ghz': clk[0] / clk[1]}


def throughput(so=None, reps=64):
    """{class: operations per clock and SM} of the throughput probes
    (a full grid of independent chains, timed by CUDA events) at the SM
    clock ``ghz`` of measure(); with 'sms', the SM count."""
    lib = ctypes.CDLL(so or build())
    lib.saugns_tput_probe_names.restype = ctypes.c_char_p
    names = lib.saugns_tput_probe_names().decode().split(',')
    out = (ctypes.c_double * len(names))()
    sms = ctypes.c_int()
    lib.saugns_tput_probe.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                      ctypes.c_void_p]
    rc = lib.saugns_tput_probe(reps, ctypes.addressof(out),
                               ctypes.byref(sms))
    if rc != 0:
        raise RuntimeError('throughput probe failed with cudaError_t %d'
                           % rc)
    return {'sms': sms.value,
            'per_ns': {k: out[i] for i, k in enumerate(names)}}


def per_clock_sm(tp, ghz):
    """{class: operations per clock and SM} of throughput()'s result at
    an SM clock of ``ghz``."""
    return {k: v / (tp['sms'] * ghz) for k, v in tp['per_ns'].items()}


def bounds(m):
    """{chain: {'cycles', 'ns_per_sample', 'ops'}} of CHAINS under the
    measurement ``m`` of measure()."""
    out = {}
    for name, ch in CHAINS.items():
        c = chain_cycles(ch, m['cycles'])
        out[name] = {'cycles': c, 'ns_per_sample': c / m['ghz'],
                     'ops': chain_ops(ch)}
    return out


def card_line():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


# the kernels whose SASS is written: K5's row kernel, K6's row kernel
# in the fixed / level 27 / cos mode (parent: one kernel for every
# mode), and kernels 1 and 9 (each Is table)
SASS_KERNELS = ('wosc_selfmod_rows', 'rasg_selfmod_rows',
                'rasg_rowsILi6ELi0E', 'wosc_fill', 'is64_k')
SASS_SOURCES = ('wosc_selfmod.cu', 'rasg_selfmod.cu',
                'rasg_selfmod_f6.cu', 'wosc_fill.cu', 'is64.cu')


def opcodes(fn):
    """{opcode (with its type suffixes): static count} of one function's
    SASS, e.g. 'DMUL', 'F2F.F64.F32', 'I2F.U32.RP'."""
    count = {}
    for line in fn.splitlines():
        m = re.match(r'\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?'
                     r'([A-Z][A-Z0-9_.]*)', line)
        if m:
            count[m.group(1)] = count.get(m.group(1), 0) + 1
    return count


def _functions(cuobjdump, so):
    """The SASS of each kernel in the shared library ``so``."""
    text = subprocess.run([cuobjdump, '-sass', so], capture_output=True,
                          text=True, timeout=600).stdout
    return ['Function : ' + p
            for p in re.split(r'\n\s*Function : ', text)[1:]]


def _sass_one(root, outdir, tag):
    """SASS of the self-PM kernels of checkout ``root`` and nvcc's
    resource report of their sources, into ``outdir``."""
    sys.path.insert(0, root)
    from saugns_tpu_torch import kernels
    so = kernels.build()
    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()),
                             'cuobjdump')
    keep = [f for f in _functions(cuobjdump, so)
            if any(k in f.splitlines()[0] for k in SASS_KERNELS)]
    with open(os.path.join(outdir, 'sass_%s.txt' % tag), 'w') as f:
        f.write('\n'.join(keep))
    with open(os.path.join(outdir, 'opcodes_%s.json' % tag), 'w') as f:
        json.dump({fn.splitlines()[0]: opcodes(fn) for fn in keep}, f,
                  indent=1, sort_keys=True)
    rep = []
    for src in SASS_SOURCES:
        path = os.path.join(kernels.CSRC, src)
        if not os.path.exists(path):
            continue
        r = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS,
                            '-Xptxas', '-v', '-c', '-o', os.devnull,
                            path], capture_output=True, text=True,
                           timeout=600)
        rep.append('== %s\n%s%s' % (src, r.stdout, r.stderr))
    with open(os.path.join(outdir, 'ptxas_%s.txt' % tag), 'w') as f:
        f.write('\n'.join(rep))
    print(json.dumps({'root': root, 'sass_functions': len(keep)}),
          flush=True)


def main(argv):
    if len(argv) == 3 and argv[0] == '--sass-one':
        _sass_one(os.path.abspath(argv[1]), argv[2],
                  os.path.basename(os.path.abspath(argv[1])) or 'root')
        return 0
    import torch
    if not torch.cuda.is_available():
        print('torch_chain_latency: no CUDA device', file=sys.stderr)
        return 2
    m = measure()
    tp = throughput()
    print(json.dumps({'card': card_line(), 'ghz': m['ghz'],
                      'cycles': m['cycles'], 'bounds': bounds(m),
                      'sms': tp['sms'],
                      'per_clock_sm': per_clock_sm(tp, m['ghz'])}),
          flush=True)
    if argv[:1] == ['--sass']:
        outdir = os.path.abspath(argv[1])
        os.makedirs(outdir, exist_ok=True)
        nvcc = _nvcc()[0]
        cuobjdump = os.path.join(os.path.dirname(nvcc), 'cuobjdump')
        with open(os.path.join(outdir, 'sass_probe.txt'), 'w') as f:
            f.write('\n'.join(_functions(cuobjdump, build())))
        for root in argv[2:]:
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                '--sass-one', os.path.abspath(root),
                                outdir], timeout=900)
            if r.returncode != 0:
                return r.returncode
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
