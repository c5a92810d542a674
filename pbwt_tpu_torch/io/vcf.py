"""VCF reading/writing with htslib-equivalent behaviour (pbwtHtslib.c).

The reference links htslib; the VCF text format (plus gzip/BGZF and BCF2, in
sibling modules) is implemented here natively, so that output is
byte-identical to what the reference emits through htslib for the feature
subset pbwt uses: fileformat/FILTER/contig/INFO/FORMAT headers,
GT[:ADS:DS:GP] fields, AC/AN[,RefPanelAF,DR2] INFO, missing QUAL, PASS
filter.
"""

from __future__ import annotations

import io
import sys

import numpy as np

from .. import version as _ver
from ..core import engine, native, pack3 as p3, registry
from ..core.pbwt import PBWT, Site
from ..utils import log


# --------------------------------------------------------------------------
# reading
# --------------------------------------------------------------------------

def _open_vcf_stream(filename: str):
    """Open a VCF/BCF path (or '-') and sniff the compression/format.

    Returns ("vcf"|"bcf", binary file object positioned at start).
    """
    import gzip
    if filename == "-":
        raw = sys.stdin.buffer
        data = raw.read()          # stdin is not seekable; slurp
        raw = io.BytesIO(data)
    else:
        raw = open(filename, "rb")
    magic = raw.read(4)
    raw.seek(0)
    if magic[:2] == b"\x1f\x8b":   # gzip/BGZF
        raw = io.BytesIO(gzip.open(raw).read())
        magic = raw.read(4)
        raw.seek(0)
    if magic[:3] == b"BCF":
        return "bcf", raw
    return "vcf", raw


def read_vcf_gt(filename: str) -> PBWT:
    """pbwtReadVcfGT (pbwtHtslib.c:52-172)."""
    kind, raw = _open_vcf_stream(filename)
    if kind == "bcf":
        from . import bcf
        header_lines, sample_names, records = bcf.read_bcf(raw)
    else:
        header_lines, sample_names, records = _parse_vcf_text(raw)
    return _build_from_records(filename, sample_names, records)


def _parse_vcf_text(raw):
    """Parse a text VCF; yields (header_lines, samples, record iterator).

    Each record is (chrom, pos, id, ref, alts, qual, filter, info, fmt,
    sample_fields list[str])."""
    text = io.TextIOWrapper(raw, encoding="utf-8", errors="replace")
    header_lines: list[str] = []
    sample_names: list[str] = []

    def records():
        for line in text:
            line = line.rstrip("\n")
            if not line:
                continue
            if line.startswith("##"):
                header_lines.append(line)
                continue
            if line.startswith("#CHROM"):
                parts = line.split("\t")
                sample_names.extend(parts[9:])
                continue
            # split only the 9 fixed columns; the sample blob stays one
            # string for the native GT parser (list-typed records keep the
            # portable per-sample path)
            yield line.split("\t", 9)

    it = records()
    # consume up to first data record so sample_names is populated
    first = next(it, None)

    def all_records():
        if first is not None:
            yield first
            yield from it

    return header_lines, sample_names, all_records()


# bytes of natural-order columns the device route holds on the host: a
# block of whole 32-site groups of this size is built at a time
BLOCK_BYTES = 256 << 20
GROUP = 32              # sites a group word (ops/partition.py)


def _build_from_records(filename: str, sample_names, records) -> PBWT:
    from ..ops import device_requested
    # on a device backend (and with no checkpoint cadence to honour), columns
    # are gathered into a block of BLOCK_BYTES and built on the card a block
    # at a time (ops/build.BlockBuild), the prefix array carried between
    # blocks; a panel that fits one block goes to engine.build_from_haplotypes,
    # which takes it to the device engine when it is large
    batch = device_requested() and not registry.n_checkpoint
    cols: np.ndarray | None = None
    n_cols = 0
    blocks = None                 # ops/build.BlockBuild once a block is full
    p: PBWT | None = None
    u: engine.WriteCursor | None = None
    n_missing = 0
    n_missing_sites = 0
    missing_chunks: list[bytes] = [b"\x00"]  # offset-0 marker byte
    missing_len = 1
    missing_offsets: list[int] = []

    for f in records:
        if p is None:
            nsamp = len(sample_names)
            p = PBWT(nsamp * 2, 0)   # assume diploid
            p.samples = []
            for name in sample_names:
                k = registry.sample_add(name)
                p.samples.extend([k, k])
            p.sites = []
            if batch:
                sites = max(GROUP, BLOCK_BYTES // max(p.M, 1) // GROUP * GROUP)
                cols = np.empty((sites, p.M), np.uint8)
            else:
                u = engine.WriteCursor(p.M)
        chrom = f[0]
        if p.chrom is None:
            p.chrom = chrom
        elif chrom != p.chrom:
            break
        pos = int(f[1])
        ref = f[3].upper()
        alt_field = f[4]
        fmt = f[8].split(":") if len(f) > 8 else []
        if "GT" not in fmt:
            continue
        gti = fmt.index("GT")
        parsed = None
        if len(f) == 10 and len(sample_names) > 0:
            nsamp = len(sample_names)
            blob = f[9].encode()
            av = np.empty(2 * nsamp, np.int8)
            ns = native.get_lib().vcf_parse_gt(blob, len(blob), gti, nsamp,
                                               av)
            if ns == nsamp:
                parsed = av.reshape(nsamp, 2)
        if parsed is not None:
            a0 = parsed[:, 0].astype(np.int32)
            a1 = parsed[:, 1].astype(np.int32)
            hap = parsed[:, 1] == -2           # haploid samples
            x = np.zeros(p.M, dtype=np.int32)
            xmiss = np.zeros(p.M, dtype=np.uint8)
            was_missing = n_missing
            if hap.all():                       # pbwtHtslib.c:91-106
                x[0::2] = x[1::2] = np.maximum(a0, 0)
                xmiss[0::2] = xmiss[1::2] = a0 < 0
            else:
                a1 = np.where(hap, -1, a1)      # mixed-ploidy: pad missing
                x[0::2] = np.maximum(a0, 0)
                x[1::2] = np.maximum(a1, 0)
                xmiss[0::2] = a0 < 0
                xmiss[1::2] = a1 < 0
            n_missing += int(xmiss.sum())
        else:
            sample_fields = (f[9].split("\t") if len(f) == 10 else f[9:])
            gts = [s.split(":")[gti] if s != "." else "."
                   for s in sample_fields]
            # parse allele lists; haploid samples have one allele
            alleles: list[list[int | None]] = []
            for g in gts:
                vals: list[int | None] = []
                for tok in g.replace("|", "/").split("/"):
                    vals.append(None if tok in (".", "") else int(tok))
                alleles.append(vals)
            ngt = sum(len(v) for v in alleles)
            max_ploidy = max((len(v) for v in alleles), default=0)
            if ngt != p.M and p.M != 2 * ngt and not (max_ploidy == 2):
                raise ValueError(f"{ngt} != {p.M} GT values at {chrom}:{pos}"
                                 " - not haploid or diploid?")
            x = np.zeros(p.M, dtype=np.int32)
            xmiss = np.zeros(p.M, dtype=np.uint8)
            was_missing = n_missing
            if max_ploidy == 1:   # all haploid: duplicate
                for i, v in enumerate(alleles):
                    if v[0] is None:
                        xmiss[2 * i] = xmiss[2 * i + 1] = 1
                        n_missing += 2
                    else:
                        x[2 * i] = x[2 * i + 1] = v[0]
            else:
                # htslib pads haploid GTs in mixed-ploidy records with
                # bcf_gt_missing, which pbwtReadVcfGT records as ref +
                # missing (observed on test/read.vcf)
                j = 0
                for v in alleles:
                    padded = list(v) + [None] * (2 - len(v))
                    for tok in padded[:2]:
                        if tok is None:
                            xmiss[j] = 1
                            n_missing += 1
                        else:
                            x[j] = tok
                        j += 1

        no_alt = alt_field == "." or alt_field == ""
        alts = ["."] if no_alt else [a.upper() for a in alt_field.split(",")]
        for ai, alt in enumerate(alts, start=1):
            if batch:
                if n_cols == len(cols):
                    if blocks is None:
                        from ..ops.build import BlockBuild
                        blocks = BlockBuild(p.M)
                    blocks.add(cols)
                    n_cols = 0
                cols[n_cols] = x == ai
                n_cols += 1
            else:
                u.write_natural((x == ai).astype(np.uint8))
            if n_missing > was_missing:
                missing_offsets.append(missing_len)
                chunk = p3.pack3(xmiss)
                missing_chunks.append(chunk)
                missing_len += len(chunk)
                n_missing_sites += 1
            elif n_missing:
                missing_offsets.append(0)
            p.sites.append(Site(x=pos, varD=registry.variation(ref, alt)))
            p.N += 1
            if registry.n_checkpoint and p.N % registry.n_checkpoint == 0:
                from . import pbwtfile
                p.yz = u.packed()
                if n_missing:
                    # leading sites before the first missing site take
                    # implicit zeros at the FRONT (reference Array zero-fills
                    # indices 0..N-1; pbwtHtslib.c:144 indexes by p->N)
                    p.zMissing = b"".join(missing_chunks)
                    p.missingOffset = np.array(
                        [0] * (p.N - len(missing_offsets)) + missing_offsets, np.int64)
                pbwtfile.checkpoint(u, p)

    if p is None:
        raise ValueError(f"failed to read any GT data from {filename}")
    if blocks is not None:
        blocks.add(cols[:n_cols])
        p.yz, p.aFend = blocks.finish()
    elif n_cols:
        p.yz, p.aFend = engine.build_from_haplotypes(cols[:n_cols].T)
    else:
        u = u or engine.WriteCursor(p.M)
        p.yz, p.aFend = u.packed(), u.a.copy()
    if n_missing:
        # pad offsets for leading sites before the first missing site
        missing_offsets = [0] * (p.N - len(missing_offsets)) + missing_offsets
        p.zMissing = b"".join(missing_chunks)
        p.missingOffset = np.array(missing_offsets, dtype=np.int64)
    log(f"read genotypes from {filename} with {len(p.samples) // 2} sample names "
        f"and {len(p.sites)} sites on chromosome {p.chrom}: M, N are {p.M}, {p.N}")
    if p.missingOffset is not None:
        log(f"{n_missing} missing values at {n_missing_sites} sites")
    return p


def read_vcf_pl(filename: str) -> PBWT:
    """pbwtReadVcfPL (pbwtHtslib.c:174-224): parses PL fields and prints the
    first 10 values of the first 10 biallelic records, but builds no PBWT
    (the reference returns an empty object)."""
    kind, raw = _open_vcf_stream(filename)
    if kind == "bcf":
        from . import bcf
        _, sample_names, records = bcf.read_bcf(raw)
    else:
        _, sample_names, records = _parse_vcf_text(raw)
    p = None
    k = 0
    out = sys.stdout
    for f in records:
        if p is None:
            p = PBWT(len(sample_names) * 2, 0)
            p.samples = []
            for name in sample_names:
                sid = registry.sample_add(name)
                p.samples.extend([sid, sid])
        k += 1
        if "," in f[4] or f[4] == ".":
            continue                     # not biallelic
        if k <= 10:
            out.write(f"{f[0]}:{f[1]} {f[3]} {f[4]}")
        fmt = f[8].split(":") if len(f) > 8 else []
        if "PL" in fmt:
            pli = fmt.index("PL")
            for i, s in enumerate(f[9:]):
                parts = s.split(":")
                if pli >= len(parts):
                    continue
                for j, v in enumerate(parts[pli].split(",")):
                    if v == "." or not v:
                        continue
                    if k <= 10 and i < 10:
                        out.write(f"{'.' if j else ' '}{int(v)}")
        if k <= 10:
            out.write("\n")
    if p is None:
        p = PBWT(0, 0)
    return p


# --------------------------------------------------------------------------
# writing (pbwtWriteVcf, pbwtHtslib.c:237-396)
# --------------------------------------------------------------------------

def _fmt_float(v: float) -> str:
    """htslib renders bcf floats into VCF with %g."""
    return f"{v:g}"


def vcf_header_lines(p: PBWT, reference_fasta: str | None = None,
                     with_pbwt_lines: bool = True) -> list[str]:
    is_dosage = p.dosageOffset is not None
    lines = ["##fileformat=VCFv4.2",
             '##FILTER=<ID=PASS,Description="All filters passed">']
    if reference_fasta:
        for name, length in _fasta_contigs(reference_fasta):
            lines.append(f"##contig=<ID={name},length={length}>")
    elif p.chrom:
        lines.append(f"##contig=<ID={p.chrom},length={0x7fffffff}>")
    if with_pbwt_lines:
        lines.append(f"##pbwtVersion={_ver.MAJOR_VERSION}.{_ver.MINOR_VERSION}"
                     f"+pbwt-tpu-{_ver.__version__}")
        lines.append(f"##pbwtCommand=pbwt {registry.command_line}")
    lines.append('##INFO=<ID=AC,Number=A,Type=Integer,Description='
                 '"Allele count in genotypes">')
    lines.append('##INFO=<ID=AN,Number=1,Type=Integer,Description='
                 '"Total number of alleles in called genotypes">')
    lines.append('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">')
    if is_dosage:
        lines.append('##INFO=<ID=RefPanelAF,Number=A,Type=Float,Description='
                     '"Allele frequency in imputation reference panel">')
        lines.append('##INFO=<ID=DR2,Number=A,Type=Float,Description='
                     '"Estimated haploid dosage r^2 from imputation">')
        lines.append('##FORMAT=<ID=ADS,Number=R,Type=Float,Description="Allele dosage">')
        lines.append('##FORMAT=<ID=DS,Number=1,Type=Float,Description="Genotype dosage">')
        lines.append('##FORMAT=<ID=GP,Number=G,Type=Float,Description='
                     '"Genotype posterior probabilities">')
    return lines


def _fasta_contigs(path: str):
    fai = path + ".fai"
    out = []
    try:
        with open(fai) as fp:
            for line in fp:
                parts = line.split("\t")
                out.append((parts[0], int(parts[1])))
    except OSError as e:
        raise ValueError(f"Could not load the reference {path}. Has the fasta "
                         "been indexed with 'samtools faidx'?") from e
    return out


def sample_column_names(p: PBWT) -> list[str]:
    if p.samples:
        return [registry.sample_name(p.samples[2 * i]) for i in range(p.M // 2)]
    return [f"PBWT{i}" for i in range(p.M // 2)]


def format_records(p: PBWT):
    """Yield VCF data lines for p (generator)."""
    from ..algos.impute import dosage_retrieve
    from .textformats import _iter_sites
    vd = registry.variation_dict
    is_dosage = p.dosageOffset is not None
    a = p.aFstart.copy()
    hap = np.empty(p.M, dtype=np.uint8)
    ad = np.empty(p.M, dtype=np.float64)
    for i, y, s in _iter_sites(p):
        hap[a] = y
        if is_dosage:
            ad[a] = dosage_retrieve(p, y, i)
        als = registry.variation_name(s.varD).split("\t")
        ref = als[0]
        alt = als[1] if len(als) > 1 else "."
        ac = int(np.minimum(hap, 1).sum())
        an = p.M
        sep2 = "/" if p.isUnphased else "|"
        # alleles are biallelic 0/1: build GT strings by table lookup
        lut = [f"0{sep2}0", f"0{sep2}1", f"1{sep2}0", f"1{sep2}1"]
        code = (hap[0::2].astype(np.int32) * 2 + hap[1::2]).tolist()
        gt_strs = [lut[c] for c in code]
        info_parts = []
        if p.isRefFreq:
            info_parts.append(f"RefPanelAF={_fmt_float(s.refFreq)}")
        if is_dosage:
            info_parts.append(f"DR2={_fmt_float(s.imputeInfo)}")
        info_parts.append(f"AC={ac}")
        info_parts.append(f"AN={an}")
        fmt = "GT"
        if is_dosage:
            fmt = "GT:ADS:DS:GP"
            cols = []
            for j in range(0, p.M, 2):
                d0, d1 = ad[j], ad[j + 1]
                ds = d0 + d1
                gp0 = (1 - d0) * (1 - d1)
                gp1 = d0 + d1 - 2 * d0 * d1
                gp2 = d0 * d1
                cols.append(f"{gt_strs[j // 2]}:{_fmt_float(d0)},{_fmt_float(d1)}"
                            f":{_fmt_float(ds)}"
                            f":{_fmt_float(gp0)},{_fmt_float(gp1)},{_fmt_float(gp2)}")
        else:
            cols = gt_strs
        yield (f"{p.chrom}\t{s.x}\t.\t{ref}\t{alt}\t.\tPASS\t"
               + ";".join(info_parts) + "\t" + fmt + "\t" + "\t".join(cols))
        a = engine.forwards_a(a, y)


def write_vcf(p: PBWT, filename: str, reference_fasta: str | None = None,
              mode: str = "w") -> None:
    """pbwtWriteVcf: mode w=VCF, wz=BGZF VCF, wbu=uncompressed BCF, wb=BGZF BCF."""
    if p is None:
        raise ValueError("pbwtWriteVcf called without a valid pbwt")
    if p.sites is None:
        raise ValueError("pbwtWriteVcf called without sites")
    if not p.samples:
        log("Warning: pbwtWriteVcf called without samples... using fake sample "
            "names PBWT0, PBWT1 etc...")

    if mode in ("wbu", "wb"):
        from . import bcf
        bcf.write_bcf(p, filename, reference_fasta, compressed=(mode == "wb"))
    else:
        header = vcf_header_lines(p, reference_fasta)
        body_iter = format_records(p)
        text = ("\n".join(header) + "\n"
                + "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                + "\t".join(sample_column_names(p)) + "\n")
        if mode == "wz":
            from . import bgzf
            out = bgzf.BgzfWriter(sys.stdout.buffer if filename == "-"
                                  else open(filename, "wb"))
            out.write(text.encode())
            for rec in body_iter:
                out.write((rec + "\n").encode())
            out.close()
        else:
            out = sys.stdout if filename == "-" else open(filename, "w")
            out.write(text)
            for rec in body_iter:
                out.write(rec + "\n")
            if filename != "-":
                out.close()
            else:
                out.flush()
    log(f"written vcf file: {p.N} records and {p.M // 2} samples")
