"""Command-line interface of the port, mirroring the reference's flags
and behavior (port of saugns.c). Renders on every visible CUDA device
unless SAUGNS_TPU_TORCH_DEVICE names other torch devices, one or a
comma-separated list (``cpu``, ``cpu,cpu,cpu,cpu``, ``cuda:0,cuda:1``);
with two or more, a program of several voices renders over them
(SAUGNS_TPU_MESH=0: on the first) and a script list one program a
device (SAUGNS_TPU_SHARD_SCRIPTS=0: in turn).

Usage parity: [-a | -m] [-r srate] [--mono] [-o file] [--stdout]
[-c] [-d] [-p] [-e] [-h [topic]] [-v] [-V] [variable=value] scripts...
"""
from __future__ import annotations

import os
import sys

from .lang.program import Program, ScriptArg, build_program

NAME = "saugns-tpu-torch"
VERSION_STR = "v0.4.7-tpu-torch-0.1"
DEFAULT_SRATE = 96000

OPT_MODE_FULL = 1 << 0
OPT_SYSAU_ENABLE = 1 << 1
OPT_SYSAU_DISABLE = 1 << 2
OPT_AUDIO_MONO = 1 << 3
OPT_AUDIO_STDOUT = 1 << 4
OPT_AUFILE_STDOUT = 1 << 5
OPT_MODE_CHECK = 1 << 6
OPT_PRINT_INFO = 1 << 7
OPT_EVAL_STRING = 1 << 8
OPT_DETERMINISTIC = 1 << 9
OPT_PRINT_VERBOSE = 1 << 10


def print_usage(h_arg, h_type, out):
    out.write(
        "Usage: %s [-a | -m] [-r <srate>] [--mono] [-o <file>] [--stdout]\n"
        "              [-d] [-p] [variable=value] [-e] <script>...\n"
        "       %s -c [-d] [-p] [variable=value] [-e] <script>...\n"
        % (NAME, NAME))
    if not h_type:
        out.write(
            "\n"
            "Audio output options (by default, system audio output is "
            "enabled):\n"
            "  -a \tAudible; always enable system audio output.\n"
            "  -m \tMuted; always disable system audio output.\n"
            "  -r \tSample rate in Hz (default %d);\n"
            "     \tif unsupported for system audio, warns and prints rate "
            "used instead.\n"
            "  -o \tWrite a 16-bit PCM WAV file, always using the sample "
            "rate requested.\n"
            "     \tOr for AU over stdout, \"-\". Disables system audio "
            "output by default.\n"
            "  --mono \tDownmix and output audio as mono; this applies to "
            "all outputs.\n"
            "  --stdout \tSend a raw 16-bit output to stdout, -r or default "
            "sample rate.\n"
            "\n"
            "Other options:\n"
            "  -c \tCheck scripts only; parse, handle -p, but don't "
            "interpret unlike -m.\n"
            "  -d \tDeterministic mode; ensures unvarying script output "
            "from same input.\n"
            "  -p \tPrint info for scripts read.\n"
            "  -e \tEvaluate strings instead of files. Applies to scripts "
            "after.\n"
            "  -h \tPrint this and list help topics, or print help for "
            "'-h <topic>'.\n"
            "  -v \tBe verbose.\n"
            "  -V \tPrint version.\n"
            "  variable=value\tSet variable, passed on to scripts as "
            "\"$variable\".\n" % DEFAULT_SRATE)
    if h_arg:
        from .utils.help import find_help, print_names, HELP_TOPICS
        description = ("pass '-h' without topic for general usage"
                       if h_type else "pass with '-h' as topic")
        topic = h_type
        contents = find_help(topic) if topic else None
        if contents is None:
            topic = 'help'
            contents = HELP_TOPICS
        sys.stdout.write("\nList of '%s' names (%s):\n"
                         % (topic, description))
        print_names(contents, '\t', sys.stdout)


def _get_defarg(s):
    """Parse variable=value (saugns.c:144-172)."""
    if '=' not in s:
        return None
    key, _, valp = s.partition('=')
    if not key:
        return None
    for c in key:
        if not (c.isalnum() or c == '_'):
            return None
    try:
        val = float(valp)
    except ValueError:
        return None
    if valp.strip() == '' or valp != valp.strip():
        return None
    return (key, val)


def parse_args(argv):
    """Returns (flags, script_args, wav_path, srate) or None."""
    flags = 0
    script_args = []
    predef = []
    wav_path = None
    ir_path = None
    srate = DEFAULT_SRATE
    h_arg = False
    h_type = None
    i = 0
    dashdash = False
    in_options = True

    def usage():
        print_usage(h_arg, h_type, sys.stdout if h_arg else sys.stderr)

    while i < len(argv):
        arg = argv[i]
        if in_options and not dashdash and arg.startswith('-') and \
                len(arg) > 1:
            if arg == '--':
                dashdash = True
                i += 1
                continue
            if arg.startswith('--'):
                longname = arg[2:]
                if longname == 'mono':
                    if flags & OPT_MODE_CHECK:
                        usage(); return None
                    flags |= OPT_MODE_FULL | OPT_AUDIO_MONO
                elif longname == 'stdout':
                    if flags & (OPT_MODE_CHECK | OPT_AUFILE_STDOUT):
                        usage(); return None
                    flags |= OPT_MODE_FULL | OPT_AUDIO_STDOUT
                elif longname == 'save-ir' or \
                        longname.startswith('save-ir='):
                    # extension: write each built program's serialized
                    # IR artifact (lang/serialize.py); programs load
                    # back via a .sauir script argument
                    if longname.startswith('save-ir='):
                        ir_path = longname[8:]
                    else:
                        i += 1
                        if i >= len(argv):
                            usage(); return None
                        ir_path = argv[i]
                else:
                    print("%s: invalid option \"%s\"" % (NAME, arg),
                          file=sys.stderr)
                    print("Pass -h for general usage help.",
                          file=sys.stderr)
                    return None
                i += 1
                continue
            j = 1
            consumed_next = False
            abort = False
            while j < len(arg):
                c = arg[j]
                if c == 'V':
                    print("%s %s" % (NAME, VERSION_STR))
                    return None
                if c == 'a':
                    if flags & (OPT_SYSAU_DISABLE | OPT_MODE_CHECK):
                        usage(); return None
                    flags |= OPT_MODE_FULL | OPT_SYSAU_ENABLE
                elif c == 'c':
                    if flags & OPT_MODE_FULL:
                        usage(); return None
                    flags |= OPT_MODE_CHECK
                elif c == 'd':
                    flags |= OPT_DETERMINISTIC
                elif c == 'e':
                    flags |= OPT_EVAL_STRING
                elif c == 'h':
                    h_arg = True
                    h_type = arg[j + 1:] or (argv[i + 1]
                                             if i + 1 < len(argv) else None)
                    usage()
                    return None
                elif c == 'm':
                    if flags & (OPT_SYSAU_ENABLE | OPT_MODE_CHECK):
                        usage(); return None
                    flags |= OPT_MODE_FULL | OPT_SYSAU_DISABLE
                elif c == 'o':
                    if flags & OPT_MODE_CHECK:
                        usage(); return None
                    optarg = arg[j + 1:]
                    if not optarg:
                        if i + 1 >= len(argv):
                            usage(); return None
                        optarg = argv[i + 1]
                        consumed_next = True
                    if optarg == '-':
                        if flags & OPT_AUDIO_STDOUT:
                            usage(); return None
                        flags |= OPT_AUFILE_STDOUT
                    flags |= OPT_MODE_FULL
                    wav_path = optarg
                    j = len(arg)
                    break
                elif c == 'p':
                    flags |= OPT_PRINT_INFO
                elif c == 'r':
                    if flags & OPT_MODE_CHECK:
                        usage(); return None
                    flags |= OPT_MODE_FULL
                    optarg = arg[j + 1:]
                    if not optarg:
                        if i + 1 >= len(argv):
                            usage(); return None
                        optarg = argv[i + 1]
                        consumed_next = True
                    try:
                        sr = int(optarg)
                    except ValueError:
                        usage(); return None
                    if sr <= 0:
                        usage(); return None
                    srate = sr
                    j = len(arg)
                    break
                elif c == 'v':
                    flags |= OPT_PRINT_VERBOSE
                else:
                    print("%s: invalid option '%c'" % (NAME, c),
                          file=sys.stderr)
                    print("Pass -h for general usage help.",
                          file=sys.stderr)
                    return None
                j += 1
            i += 2 if consumed_next else 1
            continue
        # non-option argument
        if not dashdash and not (flags & OPT_EVAL_STRING) and '=' in arg:
            d = _get_defarg(arg)
            if d is not None:
                predef.append(d)
            else:
                print("%s: malformed \"variable=number\" string"
                      % NAME, file=sys.stderr)
            i += 1
            continue
        sa = ScriptArg(str=arg, is_path=not (flags & OPT_EVAL_STRING))
        script_args.append(sa)
        i += 1
    if not script_args:
        usage()
        return None
    for sa in script_args:
        sa.no_time = bool(flags & OPT_DETERMINISTIC)
        sa.predef = predef
    return flags, script_args, wav_path, srate, ir_path


def read_scripts(script_args):
    prgs = []
    built = 0
    for sa in script_args:
        if sa.is_path and sa.str.endswith('.sauir'):
            # serialized Program IR artifact (see lang/serialize.py):
            # skip the compile stage entirely
            from .lang.serialize import load_program
            try:
                prg = load_program(sa.str)
            except (OSError, ValueError, KeyError) as e:
                print("error: couldn't load IR file \"%s\": %s"
                      % (sa.str, e), file=sys.stderr)
                prg = None
        else:
            prg = build_program(sa)
        if prg is not None:
            built += 1
        prgs.append(prg)
    return built, prgs


def make_generators(prgs, srate, options):
    """Resolve the render devices (SAUGNS_TPU_TORCH_DEVICE, a
    comma-separated list; every visible CUDA device by default) and
    make every program's generator, before any output is opened: a
    missing CUDA device or a program outside the port's slice then
    leaves no partial file. A program of several voices gets the mesh
    generator where the player would choose it (io/player.py). Returns
    (devices, generators); check mode (-c) renders nothing."""
    if options & OPT_MODE_CHECK:
        return None, [None] * len(prgs)
    from .io.player import _make_generator
    from .render.engine import resolve_devices
    devices = resolve_devices(
        os.environ.get('SAUGNS_TPU_TORCH_DEVICE') or None)
    return devices, [_make_generator(prg, srate, devices)
                     if prg is not None else None for prg in prgs]


def play(prgs, srate, options, wav_path, device=None, gens=None):
    """Render the programs (saugns.c:634-665) on ``device`` (a device
    or the list of make_generators()) with its generators. With two or
    more devices and programs, the programs render concurrently, one
    device each (parallel/scripts.py), unless the run checks only,
    renders twice or is muted; the sinks get the programs in order."""
    from .io.player import Player
    if not prgs:
        return True
    if gens is None:
        gens = [None] * len(prgs)
    status = True
    player = Player(srate, options, wav_path, device)
    if not player.ok:
        player.finish()
        return False
    # multi-script sharding: sink writes stay in program order, so the
    # output bytes are those of the serial loop (saugns.c:648-659)
    queue = None
    muted = (player.ad is None and player.sf is None
             and not (options & OPT_AUDIO_STDOUT))
    if not (options & OPT_MODE_CHECK) and not player.split_gen \
            and not muted:
        from .parallel.scripts import ShardedRenderQueue
        queue = ShardedRenderQueue(prgs, player.srate,
                                   not (options & OPT_AUDIO_MONO), device)
    try:
        for i, (prg, gen) in enumerate(zip(prgs, gens)):
            if prg is None:
                continue
            if options & OPT_PRINT_INFO:
                prg.print_info()
            if options & OPT_PRINT_VERBOSE:
                print(("Checked \"%s\"." if options & OPT_MODE_CHECK
                       else "Playing \"%s\".") % prg.name)
            pre = queue.generator(i) if queue is not None else None
            # an audio device may have negotiated another rate
            if pre is None and player.srate != srate:
                gen = None
            if not player.run(prg, gen=pre or gen):
                status = False
    finally:
        if queue is not None:
            queue.close()
    if not player.finish():
        status = False
    return status


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    parsed = parse_args(argv)
    if parsed is None:
        return 0
    options, script_args, wav_path, srate, ir_path = parsed
    built, prgs = read_scripts(script_args)
    if built == 0:
        return 1
    if ir_path is not None:
        from .lang.serialize import save_program
        many = sum(1 for p in prgs if p is not None) > 1
        k = 0
        for prg in prgs:
            if prg is None:
                continue
            path = ir_path if not many else '%s.%d' % (ir_path, k)
            save_program(prg, path)
            k += 1
    if prgs:
        try:
            device, gens = make_generators(prgs, srate, options)
        except RuntimeError as e:
            print('%s: error: %s' % (NAME, e), file=sys.stderr)
            return 1
        if not play(prgs, srate, options, wav_path, device, gens):
            return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
