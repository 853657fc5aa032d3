"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

Runs on one machine with the cell's CUDA cards, from the root of a
checkout: makes the cell's programs from the seed, prepares them
(set-up), renders them in turn for ``--seconds`` (the window), compares
every answer with the plain reference, and prints one JSON line last
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, ``setup_build_s``: the seconds of
``setup_s`` that built the kernels with nvcc, which only a checkout's
first run does, and ``checks``: each compared number beside its limit,
also the last lines of standard error). Without the cards it exits with
3 and prints no result.
"""
import time

T_START = time.perf_counter()
T_BOOT = time.clock_gettime(time.CLOCK_BOOTTIME)

import os  # noqa: E402
import sys  # noqa: E402

# the store of compiled renders as the port ships it, on, with its user
# directory at a fixed place in the checkout: a call looks its program
# up there and misses (every run's programs are new from its seed, and
# neither a call nor the CLI stores one); one thread a library, so that
# the load comes from one process
os.environ['SAUGNS_TPU_EXPORT'] = '1'
os.environ['SAUGNS_TPU_CACHE'] = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    '.portbench-store')
for _v in ('OMP_NUM_THREADS', 'MKL_NUM_THREADS', 'OPENBLAS_NUM_THREADS'):
    os.environ[_v] = '1'


def _start_offset():
    """Seconds from the process's start to T_START (the interpreter's
    own start-up): the process's start time in /proc, in clock ticks
    since boot, against the boot-time clock read at T_START (both
    counted from boot, so a change of the wall clock moves neither); 0
    where it cannot be read."""
    try:
        with open('/proc/self/stat') as f:
            ticks = int(f.read().rsplit(')', 1)[1].split()[19])
        return max(0.0, T_BOOT - ticks / os.sysconf('SC_CLK_TCK'))
    except (OSError, ValueError, IndexError):
        return 0.0


if __name__ == '__main__':
    from harness.main import main
    sys.exit(main(sys.argv[1:], T_START, _start_offset()))
