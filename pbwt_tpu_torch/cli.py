"""Command line of the port: argv is a left-to-right pipeline of
commands on one current PBWT, as ``pbwt_tpu/cli.py`` (pbwtMain.c:276-494),
every command of pbwt. The match commands take the device routes of
:mod:`pbwt_tpu_torch.algos.match`, -llCopyModel that of
:mod:`pbwt_tpu_torch.algos.likelihood`, -referenceImpute that of
:mod:`pbwt_tpu_torch.algos.impute`, -paint that of
:mod:`pbwt_tpu_torch.algos.paint`, and -readVcfGT, -readVcfq, -readPhase
and -readPhaseChr build on the device engine; ``PBWT_TORCH_DEVICE``
decides (:mod:`pbwt_tpu_torch.ops`). Every other command runs on the host,
as in the JAX package."""

from __future__ import annotations

import os
import sys
import time

from .ops import NoDeviceError

HELP = """Program: pbwt (PyTorch/CUDA port)
Usage: python -m pbwt_tpu_torch [ -<command> [options]* ]+
Commands:
  -log <file>               log file; '-' for stderr
  -profile <dir>            trace the rest (torch.profiler) and the spans'
                            totals into <dir>; log each command's wall time
  -check                    do various checks
  -stats                    print stats depending on commands; writes to stdout
  -read <file>              read pbwt file; '-' for stdin
  -readSites <file>         read sites file; '-' for stdin
  -readSamples <file>       read samples file; '-' for stdin
  -readMissing <file>       read missing file; '-' for stdin
  -readDosage <file>        read dosage file; '-' for stdin
  -readReverse <file>       read reverse file; '-' for stdin
  -readAll <rootname>       read .pbwt and if present .sites, .samples, .missing
  -readVcfGT <file>         read GTs from vcf or bcf file; '-' for stdin
  -readVcfPL <file>         read PLs from vcf or bcf file (stub, as reference)
  -readMacs <file>          read MaCS output file; '-' for stdin
  -readVcfq <file>          read VCFQ file; '-' for stdin
  -readGen <file> <chrom>   read impute2 gen file - must set chrom
  -readHap <file> <chrom>   read impute2 hap file - must set chrom
  -readHapLegend <hap_file> <legend_file> <chrom>
  -readPhaseChr <file> <chr> read Li and Stephens phase file
  -readPhase <file>         read Li and Stephens phase file
  -checkpoint <n>           checkpoint every n sites while reading
  -merge <file> ...         merge two or more pbwt files
  -write <file>             write pbwt file; '-' for stdout
  -writeSites <file>        write sites file; '-' for stdout
  -writeSamples <file>      write samples file; '-' for stdout
  -writeMissing <file>      write missing file; '-' for stdout
  -writeDosage <file>       write dosage file; '-' for stdout
  -writeReverse <file>      write reverse file; '-' for stdout
  -writeAll <rootname>      write .pbwt and present sidecars
  -writeImputeRef <rootname> write .imputeHaps and .imputeLegend
  -writeImputeHapsG <file>  write haplotype file for IMPUTE -known_haps_g
  -writePhase <file>        write ChromoPainter/FineSTRUCTURE phase file
  -writeTransposedHaplotypes <file> one hap per row; '-' for stdout
  -haps <file>              write haplotype file; '-' for stdout
  -writeGen <file>          write impute2 gen file; '-' for stdout
  -writeVcf|-writeVcfGz|-writeBcf|-writeBcfGz <file>  write VCF/BCF
  -referenceFasta <file>    reference fasta for VCF/BCF writing
  -subsites <fmin> <frac>   subsample <frac> sites with AF > <fmin>
  -subsample <start> <n>    subsample <n> samples from index <start>
  -subrange <start> <end>   cut down to sites in [start,end)
  -corruptSites <p> <q>     randomise fraction q of positions at fraction p of sites
  -corruptSamples <p> <q>   randomise fraction q of positions for fraction p of samples
  -copySamples <M> <len>    M new mosaic samples with mean switch length len
  -selectSites <file>       select sites as in sites file
  -removeSites <file>       remove sites as in sites file
  -selectSamples <file>     select samples as in samples file
  -longWithin <L>           find matches within set longer than L
  -maxWithin                find maximal matches within set
  -matchNaive <file>        maximal match seqs in pbwt file to reference
  -matchIndexed <file>      maximal match seqs in pbwt file to reference
  -matchDynamic <file>      maximal match seqs in pbwt file to reference
  -imputeExplore <n>        n'th impute test
  -phase <n>                phase with n sparse pbwts
  -referencePhase <root>    phase current pbwt against reference
  -referenceImpute <root> [nSparse=1] [fSparse=1]  impute into reference
  -genotypeCompare <root>   compare genotypes with reference
  -imputeMissing            impute data marked as missing
  -fitAlphaBeta <model>     fit probabilistic model 1..3
  -llCopyModel <theta> <rho> log likelihood of Li-Stephens model
  -paint <fileNameRoot> [n=100] [p=2] [l=0] painting co-ancestry matrix
  -paintSparse <fileNameRoot> [n=100] [p=2] [t=0] sparse painting
  -pretty <file> <k>        pretty plot at site k
  -sfs                      print site frequency spectrum; writes sites.freq
  -play                     compare dosage-derived info to stored imputeInfo
  -refFreq <file>           read site frequency info into refFreq
  -siteInfo <file> <kmin> <kmax> export PBWT info at sites by allele count
  -buildReverse             build reverse pbwt
  -readGeneticMap <file>    read Oxford format genetic map file
  -4hapsStats               mu:rho 4 hap test stats
"""

# the arguments each command takes, as pbwt_tpu/cli.py's need(n); besides
# these, -merge takes the words up to the next command, -referenceImpute
# two optional ones more and -paint and -paintSparse three
_NARGS = {"-check": 0, "-stats": 0, "-log": 1, "-profile": 1, "-haps": 1,
          "-read": 1, "-readSites": 1, "-readSamples": 1, "-readMissing": 1,
          "-readDosage": 1, "-readReverse": 1, "-readAll": 1,
          "-readVcfGT": 1, "-readVcfPL": 1, "-readMacs": 1, "-readVcfq": 1,
          "-readGen": 2, "-readHap": 2, "-readHapLegend": 3, "-readPhase": 1,
          "-readPhaseChr": 2, "-write": 1, "-writeSites": 1,
          "-writeSamples": 1, "-writeMissing": 1, "-writeDosage": 1,
          "-writeReverse": 1, "-writeAll": 1, "-writeImputeRef": 1,
          "-writeImputeHapsG": 1, "-writeGen": 1, "-writePhase": 1,
          "-writeTransposedHaplotypes": 1, "-referenceFasta": 1,
          "-writeVcf": 1, "-writeVcfGz": 1, "-writeBcf": 1, "-writeBcfGz": 1,
          "-checkpoint": 1, "-subsample": 2, "-selectSamples": 1,
          "-subsites": 2, "-selectSites": 1, "-removeSites": 1,
          "-subrange": 2, "-corruptSites": 2, "-corruptSamples": 2,
          "-copySamples": 2, "-buildReverse": 0, "-pretty": 2,
          "-siteInfo": 3, "-sfs": 0, "-play": 0, "-refFreq": 1,
          "-maxWithin": 0, "-longWithin": 1, "-matchNaive": 1,
          "-matchIndexed": 1, "-matchDynamic": 1, "-imputeExplore": 1,
          "-phase": 1, "-referencePhase": 1, "-referenceImpute": 1,
          "-genotypeCompare": 1, "-imputeMissing": 0, "-fitAlphaBeta": 1,
          "-llCopyModel": 2, "-readGeneticMap": 1, "-4hapsStats": 0,
          "-paint": 1, "-paintSparse": 1, "-merge": 0}
TRACE_FILE = "pbwt_torch_trace.json"   # -profile's trace in its directory
SPANS_FILE = "pbwt_torch_spans.tsv"    # and the spans' and counters' totals
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
        from . import tracing
        profile["prof"].export_chrome_trace(
            os.path.join(profile["dir"], TRACE_FILE))
        tracing.write_tsv(os.path.join(profile["dir"], SPANS_FILE))
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
    """Run the commands of argv on one current PBWT, as pbwt_tpu/cli.py's
    loop does. -profile puts its started profiler and directory into
    ``profile``."""
    from . import utils
    from .algos import (analyses, geneticmap, impute, likelihood, match,
                        merge, paint, phase)
    from .core import registry
    from .io import pbwtfile, textformats, vcf

    p = None
    reference_fasta = None
    t_cmd = None
    while argv:
        cmd = argv[0]
        if not cmd.startswith("-"):
            raise SystemExit(f"not well formed command {cmd}\n"
                             "Type pbwt without arguments for help")
        if cmd not in _NARGS:
            raise SystemExit(f"unrecognised command {cmd}\n"
                             "Type pbwt without arguments for help")
        nargs = _NARGS[cmd]
        if len(argv) <= nargs:
            raise SystemExit(f"option {cmd} requires {nargs} argument(s)")
        arg = argv[1] if nargs else None
        if cmd == "-check":
            registry.is_check = True
        elif cmd == "-stats":
            registry.is_stats = True
        elif cmd == "-merge":
            # the file names up to the next command; fewer than two: no-op
            while len(argv) > nargs + 1 and not argv[nargs + 1].startswith("-"):
                nargs += 1
            if nargs > 1:
                p = merge.merge(argv[1:1 + nargs])
        elif cmd == "-log":
            utils.set_log_file(sys.stderr if arg == "-" else open(arg, "w"))
        elif cmd == "-profile":
            # the trace covers the rest of the pipeline; a wall line a
            # command (pbwt_tpu/cli.py:175-185, 556-559)
            if not profile:
                profile.update(prof=_start_profile(arg), dir=arg)
            t_cmd = time.perf_counter()
        elif cmd == "-haps":
            fp = _open(arg, "w")
            textformats.write_haplotypes(fp, p)
            _close(fp, arg)
        elif cmd == "-read":
            fp = _open(arg, "rb")
            p = pbwtfile.read_pbwt(fp)
            _close(fp, arg)
        elif cmd in ("-readSites", "-readSamples", "-readMissing",
                     "-readDosage", "-readReverse", "-refFreq"):
            fp = _open(arg, "r" if cmd in ("-readSites", "-readSamples",
                                           "-refFreq") else "rb")
            {"-readSites": pbwtfile.read_sites,
             "-readSamples": pbwtfile.read_samples,
             "-readMissing": pbwtfile.read_missing,
             "-readDosage": pbwtfile.read_dosage,
             "-readReverse": pbwtfile.read_reverse,
             "-refFreq": pbwtfile.read_ref_freq}[cmd](p, fp)
            _close(fp, arg)
        elif cmd == "-readAll":
            p = pbwtfile.read_all(arg)
        elif cmd == "-readVcfGT":
            p = vcf.read_vcf_gt(arg)
        elif cmd == "-readVcfPL":
            p = vcf.read_vcf_pl(arg)
        elif cmd == "-readMacs":
            fp = _open(arg, "rb")
            p = textformats.read_macs(fp)
            _close(fp, arg)
        elif cmd == "-readVcfq":
            fp = _open(arg, "r")
            p = textformats.read_vcfq(fp)
            _close(fp, arg)
        elif cmd in ("-readGen", "-readHap"):
            fp = _open(arg, "r")
            p = (textformats.read_gen if cmd == "-readGen"
                 else textformats.read_hap)(fp, argv[2])
            _close(fp, arg)
        elif cmd == "-readHapLegend":
            fp = _open(arg, "r")
            lp = _open(argv[2], "r")
            p = textformats.read_hap(fp, argv[3], legend_fp=lp)
            _close(fp, arg)
            _close(lp, argv[2])
        elif cmd in ("-readPhase", "-readPhaseChr"):
            fp = _open(arg, "r")
            p = textformats.read_phase(
                fp, argv[2] if cmd == "-readPhaseChr" else "0")
            _close(fp, arg)
        elif cmd in ("-write", "-writeSites", "-writeSamples",
                     "-writeMissing", "-writeDosage", "-writeReverse"):
            fp = _open(arg, "w" if cmd in ("-writeSites", "-writeSamples")
                       else "wb")
            {"-write": pbwtfile.write_pbwt,
             "-writeSites": pbwtfile.write_sites,
             "-writeSamples": pbwtfile.write_samples,
             "-writeMissing": pbwtfile.write_missing,
             "-writeDosage": pbwtfile.write_dosage,
             "-writeReverse": pbwtfile.write_reverse}[cmd](p, fp)
            _close(fp, arg)
        elif cmd == "-writeAll":
            pbwtfile.write_all(p, arg)
        elif cmd == "-writeImputeRef":
            textformats.write_impute_ref(p, arg)
        elif cmd in ("-writeImputeHapsG", "-writeGen",
                     "-writeTransposedHaplotypes"):
            fp = _open(arg, "w")
            {"-writeImputeHapsG": textformats.write_impute_haps_g,
             "-writeGen": textformats.write_gen,
             "-writeTransposedHaplotypes":
                 textformats.write_transposed_haplotypes}[cmd](p, fp)
            _close(fp, arg)
        elif cmd == "-writePhase":
            textformats.write_phase(p, arg)
        elif cmd == "-referenceFasta":
            reference_fasta = arg
        elif cmd in _VCF_MODES:
            vcf.write_vcf(p, arg, reference_fasta, _VCF_MODES[cmd])
        elif cmd == "-checkpoint":
            registry.n_checkpoint = int(arg)
        elif cmd == "-subsample":
            p = p.sub_sample_interval(int(arg), int(argv[2]))
        elif cmd == "-selectSamples":
            fp = _open(arg, "r")
            p = p.select_samples(pbwtfile.read_samples_file(fp))
            _close(fp, arg)
        elif cmd == "-subsites":
            p = p.sub_sites(float(arg), float(argv[2]))
        elif cmd in ("-selectSites", "-removeSites"):
            fp = _open(arg, "r")
            sites, chrom = pbwtfile.read_sites_file(fp, None)
            _close(fp, arg)
            if cmd == "-selectSites":
                if chrom != p.chrom:
                    raise SystemExit("chromosome mismatch in selectSites")
                p = p.select_sites(sites, keep_old=False)
            else:
                if p.chrom and chrom != p.chrom:
                    raise SystemExit("chromosome mismatch in removeSites")
                p = p.remove_sites(sites, keep_old=False)
        elif cmd == "-subrange":
            p = p.sub_range(int(arg), int(argv[2]))
        elif cmd == "-corruptSites":
            p = impute.corrupt_sites(p, float(arg), float(argv[2]))
        elif cmd == "-corruptSamples":
            p = impute.corrupt_samples(p, float(arg), float(argv[2]))
        elif cmd == "-copySamples":
            p = impute.copy_samples(p, int(arg), float(argv[2]))
        elif cmd == "-buildReverse":
            p.build_reverse()
        elif cmd == "-pretty":
            fp = _open(arg, "w")
            analyses.pretty_plot(p, fp, int(argv[2]))
            _close(fp, arg)
        elif cmd == "-siteInfo":
            fp = _open(arg, "w")
            analyses.export_site_info(p, fp, int(argv[2]), int(argv[3]))
            _close(fp, arg)
        elif cmd == "-sfs":
            analyses.site_frequency_spectrum(p)
        elif cmd == "-play":
            p = analyses.play_ground(p)
        elif cmd == "-maxWithin":
            match.long_matches(p, 0)
        elif cmd == "-longWithin":
            match.long_matches(p, int(arg))
        elif cmd in ("-matchNaive", "-matchIndexed"):
            fp = _open(arg, "rb")
            q = pbwtfile.read_pbwt(fp)
            _close(fp, arg)
            (match.match_sequences_naive if cmd == "-matchNaive"
             else match.match_sequences_indexed)(p, q)
        elif cmd == "-matchDynamic":
            fp = _open(arg, "rb")
            match.match_sequences_dynamic(p, fp)
            _close(fp, arg)
        elif cmd == "-imputeExplore":
            analyses.impute_explore(p, int(arg))
        elif cmd == "-phase":
            p = phase.phase(p, int(arg))
        elif cmd == "-referencePhase":
            p = phase.reference_phase(p, arg)
        elif cmd == "-referenceImpute":
            # optional [nSparse] [fSparse]: the words up to the next command
            extra = []
            while (len(extra) < 2 and len(argv) > 2
                   and not argv[2].startswith("-")):
                extra.append(argv.pop(2))
            p = impute.reference_impute(
                p, arg, int(extra[0]) if extra else 1,
                float(extra[1]) if len(extra) > 1 else 1.0)
        elif cmd == "-genotypeCompare":
            impute.genotype_compare(p, arg)
        elif cmd == "-imputeMissing":
            p = impute.impute_missing(p)
        elif cmd == "-fitAlphaBeta":
            likelihood.fit_alpha_beta(p, int(arg))
        elif cmd == "-llCopyModel":
            likelihood.log_likelihood_copy_model(p, float(arg),
                                                 float(argv[2]))
        elif cmd == "-readGeneticMap":
            fp = _open(arg, "r")
            geneticmap.read_genetic_map(fp)
            _close(fp, arg)
        elif cmd == "-4hapsStats":
            geneticmap.pbwt_4haps_stats(p)
        else:                                   # -paint, -paintSparse
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
        argv = argv[1 + nargs:]
        if t_cmd is not None:
            utils.log(f"wall\t{_wall(t_cmd):.3f} s\t{cmd}")
            t_cmd = time.perf_counter()
        utils.time_update()


if __name__ == "__main__":
    sys.exit(main())
