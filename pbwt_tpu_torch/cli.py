"""Command line of the port: argv is a left-to-right pipeline of
commands on one current PBWT, as ``pbwt_tpu/cli.py`` (pbwtMain.c:276-494),
for the commands this port serves. The match commands take the device
routes of :mod:`pbwt_tpu_torch.algos.match`, -llCopyModel that of
:mod:`pbwt_tpu_torch.algos.likelihood`, -referenceImpute that of
:mod:`pbwt_tpu_torch.algos.impute`, -paint that of
:mod:`pbwt_tpu_torch.algos.paint`, and the importers build on the device
engine; ``PBWT_TORCH_DEVICE`` decides (:mod:`pbwt_tpu_torch.ops`)."""

from __future__ import annotations

import os
import sys
import time

from .ops import NoDeviceError

HELP = """Program: pbwt (PyTorch/CUDA port)
Usage: python -m pbwt_tpu_torch [ -<command> [options]* ]+
Commands:
  -log <file>               log file; '-' for stderr
  -profile <dir>            trace the rest (torch.profiler) into <dir>; log
                            each command's wall time
  -check                    do various checks
  -stats                    print stats depending on commands; writes to stdout
  -read <file>              read pbwt file; '-' for stdin
  -readAll <rootname>       read .pbwt and if present .sites, .samples, .missing
  -readVcfGT <file>         read GTs from vcf or bcf file; '-' for stdin
  -readDosage <file>        read dosage file; '-' for stdin
  -write <file>             write pbwt file; '-' for stdout
  -writeDosage <file>       write dosage file; '-' for stdout
  -writeAll <rootname>      write .pbwt and present sidecars
  -haps <file>              write haplotype file; '-' for stdout
  -writeGen <file>          write impute2 gen file; '-' for stdout
  -writeVcf|-writeVcfGz|-writeBcf|-writeBcfGz <file>  write VCF/BCF
  -matchIndexed <file>      maximal match seqs in pbwt file to reference
  -matchDynamic <file>      maximal match seqs in pbwt file to reference
  -longWithin <L>           find matches within set longer than L
  -maxWithin                find maximal matches within set
  -referenceImpute <root> [nSparse=1] [fSparse=1]  impute into reference
  -imputeMissing            impute data marked as missing
  -fitAlphaBeta <model>     fit probabilistic model 1..3
  -llCopyModel <theta> <rho> log likelihood of Li-Stephens model
  -paint <fileNameRoot> [n=100] [p=2] [l=0] painting co-ancestry matrix
  -paintSparse <fileNameRoot> [n=100] [p=2] [t=0] sparse painting
Every other command of pbwt is served by: python -m pbwt_tpu
"""

# the commands of this port and the arguments each takes (-referenceImpute
# takes two optional ones more, -paint and -paintSparse three)
_NARGS = {"-check": 0, "-stats": 0, "-log": 1, "-profile": 1, "-read": 1,
          "-readAll": 1, "-readVcfGT": 1, "-readDosage": 1, "-write": 1,
          "-writeDosage": 1, "-writeAll": 1, "-haps": 1, "-writeGen": 1, "-writeVcf": 1,
          "-writeVcfGz": 1, "-writeBcf": 1, "-writeBcfGz": 1,
          "-matchIndexed": 1, "-matchDynamic": 1, "-referenceImpute": 1,
          "-fitAlphaBeta": 1, "-llCopyModel": 2, "-maxWithin": 0,
          "-longWithin": 1, "-imputeMissing": 0, "-paint": 1,
          "-paintSparse": 1}
TRACE_FILE = "pbwt_torch_trace.json"   # -profile's trace in its directory
_VCF_MODES = {"-writeVcf": "w", "-writeVcfGz": "wz", "-writeBcf": "wbu",
              "-writeBcfGz": "wb"}


def _open(name: str, mode: str):
    if name == "-":
        if "r" in mode:
            return sys.stdin.buffer if "b" in mode else sys.stdin
        return sys.stdout.buffer if "b" in mode else sys.stdout
    return open(name, mode)


def _close(fp, name: str) -> None:
    if name != "-":
        fp.close()
    else:
        fp.flush()


def main(argv: list[str] | None = None) -> int:
    """die()-style wrapper: clean one-line fatal errors like the reference."""
    try:
        return _main(argv)
    except BrokenPipeError:
        return 0
    except FileNotFoundError as e:
        sys.stderr.write(f"pbwt: failed to open file {e.filename}\n")
        return 1
    except (ValueError, NoDeviceError) as e:
        sys.stderr.write(f"pbwt: {e}\n")
        return 1
    except AttributeError as e:
        if "'NoneType'" in str(e):
            sys.stderr.write("pbwt: command requires a current PBWT - "
                             "read one first\n")
            return 1
        raise


def _main(argv: list[str] | None) -> int:
    from . import utils
    from .core import registry

    argv = list(sys.argv[1:] if argv is None else argv)
    registry.init()
    registry.command_line = " ".join(argv)
    utils.set_log_file(sys.stderr)
    if not argv:
        sys.stderr.write(HELP)
        return 0
    utils.time_update()
    profile: dict = {}
    try:
        _pipeline(argv, profile)
    finally:
        if profile:
            profile["prof"].stop()
    if profile:
        profile["prof"].export_chrome_trace(
            os.path.join(profile["dir"], TRACE_FILE))
    return 0


def _wall(t0: float) -> float:
    """Seconds since t0, the card's queued work finished first."""
    import torch
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def _start_profile(out_dir: str):
    """torch.profiler over the CPU and, with a card, CUDA, started."""
    import torch
    from torch.profiler import ProfilerActivity
    os.makedirs(out_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _pipeline(argv: list[str], profile: dict) -> None:
    """Run the commands of argv on one current PBWT. -profile puts its
    started profiler and directory into ``profile``."""
    from . import utils
    from .algos import impute, likelihood, match, paint
    from .core import registry
    from .io import pbwtfile, textformats, vcf

    p = None
    t_cmd = None
    while argv:
        cmd = argv[0]
        if not cmd.startswith("-"):
            raise SystemExit(f"not well formed command {cmd}\n"
                             "Type pbwt without arguments for help")
        if cmd not in _NARGS:
            raise SystemExit(f"pbwt_tpu_torch: command {cmd} is not in the "
                             "port; run it with python -m pbwt_tpu")
        nargs = _NARGS[cmd]
        if len(argv) <= nargs:
            raise SystemExit(f"option {cmd} requires {nargs} argument(s)")
        arg = argv[1] if nargs else None
        if cmd == "-check":
            registry.is_check = True
        elif cmd == "-stats":
            registry.is_stats = True
        elif cmd == "-log":
            utils.set_log_file(sys.stderr if arg == "-" else open(arg, "w"))
        elif cmd == "-profile":
            # the trace covers the rest of the pipeline; a wall line a
            # command (pbwt_tpu/cli.py:175-185, 556-559)
            if not profile:
                profile.update(prof=_start_profile(arg), dir=arg)
            t_cmd = time.perf_counter()
        elif cmd == "-read":
            fp = _open(arg, "rb")
            p = pbwtfile.read_pbwt(fp)
            _close(fp, arg)
        elif cmd == "-readAll":
            p = pbwtfile.read_all(arg)
        elif cmd == "-readVcfGT":
            p = vcf.read_vcf_gt(arg)
        elif cmd == "-readDosage":
            fp = _open(arg, "rb")
            pbwtfile.read_dosage(p, fp)
            _close(fp, arg)
        elif cmd == "-write":
            fp = _open(arg, "wb")
            pbwtfile.write_pbwt(p, fp)
            _close(fp, arg)
        elif cmd == "-writeDosage":
            fp = _open(arg, "wb")
            pbwtfile.write_dosage(p, fp)
            _close(fp, arg)
        elif cmd == "-writeAll":
            pbwtfile.write_all(p, arg)
        elif cmd == "-haps":
            fp = _open(arg, "w")
            textformats.write_haplotypes(fp, p)
            _close(fp, arg)
        elif cmd == "-writeGen":
            fp = _open(arg, "w")
            textformats.write_gen(p, fp)
            _close(fp, arg)
        elif cmd in _VCF_MODES:
            vcf.write_vcf(p, arg, None, _VCF_MODES[cmd])
        elif cmd == "-referenceImpute":
            # optional [nSparse] [fSparse]: the words up to the next command
            extra = []
            while (len(extra) < 2 and len(argv) > 2
                   and not argv[2].startswith("-")):
                extra.append(argv.pop(2))
            p = impute.reference_impute(
                p, arg, int(extra[0]) if extra else 1,
                float(extra[1]) if len(extra) > 1 else 1.0)
        elif cmd == "-matchIndexed":
            fp = _open(arg, "rb")
            q = pbwtfile.read_pbwt(fp)
            _close(fp, arg)
            match.match_sequences_indexed(p, q)
        elif cmd == "-maxWithin":
            match.long_matches(p, 0)
        elif cmd == "-longWithin":
            match.long_matches(p, int(arg))
        elif cmd == "-imputeMissing":
            p = impute.impute_missing(p)
        elif cmd in ("-paint", "-paintSparse"):
            # optional [chunksperregion] [ploidy] [outputlocal | cutoff]
            opts = []
            while (len(opts) < 3 and len(argv) > 2
                   and not argv[2].startswith("-")):
                opts.append(argv.pop(2))
            npr = int(opts[0]) if opts else 100
            ploidy = int(opts[1]) if len(opts) > 1 else 2
            extra = float(opts[2]) if len(opts) > 2 else 0
            if cmd == "-paint":
                paint.paint_ancestry_matrix(p, arg, npr, ploidy, int(extra))
            else:
                paint.paint_ancestry_matrix_sparse(p, arg, npr, ploidy,
                                                   extra)
        elif cmd == "-fitAlphaBeta":
            likelihood.fit_alpha_beta(p, int(arg))
        elif cmd == "-llCopyModel":
            likelihood.log_likelihood_copy_model(p, float(arg),
                                                 float(argv[2]))
        else:                                   # -matchDynamic
            fp = _open(arg, "rb")
            match.match_sequences_dynamic(p, fp)
            _close(fp, arg)
        argv = argv[1 + nargs:]
        if t_cmd is not None:
            utils.log(f"wall\t{_wall(t_cmd):.3f} s\t{cmd}")
            t_cmd = time.perf_counter()
        utils.time_update()


if __name__ == "__main__":
    sys.exit(main())
