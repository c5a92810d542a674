"""Text-format importers/exporters: vcfq, MaCS, IMPUTE2 gen/hap/legend,
Li-Stephens PHASE, haplotype matrices (pbwtIO.c:424-954)."""

from __future__ import annotations

import numpy as np

from ..core import engine, registry
from ..core.pbwt import PBWT, Site
from ..utils import log


def _finish_build(p: PBWT, u: engine.WriteCursor, kind: str) -> PBWT:
    p.yz = u.packed()
    p.aFend = u.a.copy()
    chrom = f" for chromosome {p.chrom}" if p.chrom else ""
    log(f"read {kind} file{chrom}: M, N are\t{p.M}\t{p.N}; yz length is {len(p.yz)}")
    return p


def _maybe_checkpoint(u: engine.WriteCursor, p: PBWT) -> None:
    if registry.n_checkpoint and p.N % registry.n_checkpoint == 0:
        from . import pbwtfile
        prev = p.yz
        pbwtfile.checkpoint(u, p)
        p.yz = prev


# --------------------------------------------------------------------------
# vcfq (made with vcf query): chrom pos ref alt genotypes (pbwtIO.c:494-625)
# --------------------------------------------------------------------------

def read_vcfq(fp) -> PBWT:
    from ..ops import device_requested
    # on a device backend (and with no checkpoint cadence to honour), columns
    # are accumulated and the whole build runs on the device engine
    batch = device_requested() and not registry.n_checkpoint
    cols: list[np.ndarray] = []
    p: PBWT | None = None
    u: engine.WriteCursor | None = None
    for line in fp:
        line = line.rstrip("\n")
        if not line:
            continue
        # split only the 4 leading fields: a full split materialises ~2M
        # strings per 1000 samples; allele values are the digit bytes of
        # the genotype region in order (same result as the reference's
        # per-token 0/1 walk, pbwtIO.c:511-554)
        chrom, pos_s, ref_a, alt_a, gt_text = line.split("\t", 4)
        pos = int(pos_s)
        var = f"{ref_a}\t{alt_a}"
        raw = np.frombuffer(gt_text.encode(), dtype=np.uint8)
        x = raw[(raw >= ord("0")) & (raw <= ord("9"))] - ord("0")
        if p is None:
            p = PBWT(len(x), 0)
            if chrom != ".":
                p.chrom = chrom
            p.sites = []
            if not batch:
                u = engine.WriteCursor(p.M)
        else:
            if chrom != "." and p.chrom and chrom != p.chrom:
                continue     # skip other chromosomes (readMatchChrom)
            if len(x) != p.M:
                raise ValueError("length mismatch reading vcfq line")
        s = Site(x=pos, varD=registry.variation_dict.add(var))
        p.sites.append(s)
        if batch:
            cols.append(x.astype(np.uint8))
        else:
            u.write_natural(x.astype(np.uint8))
        p.N += 1
        if not batch:
            _maybe_checkpoint(u, p)
    if p is None:
        raise ValueError("empty vcfq file")
    if p.chrom is None:
        p.chrom = ""     # readMatchChrom EOF artefact (pbwtIO.c:219-230)
    if batch:
        from ..ops.build import build_pbwt_device
        X = np.ascontiguousarray(np.stack(cols, axis=1))
        p.yz, p.aFend, _ = build_pbwt_device(X)
        chrom = f" for chromosome {p.chrom}" if p.chrom else ""
        log(f"read vcfq file{chrom}: M, N are\t{p.M}\t{p.N}; "
            f"yz length is {len(p.yz)}")
        return p
    return _finish_build(p, u, "vcfq")


# --------------------------------------------------------------------------
# MaCS simulator output (pbwtIO.c:424-492)
# --------------------------------------------------------------------------

def read_macs(fp) -> PBWT:
    """Accepts a text or binary stream; binary avoids decoding the (large)
    haplotype strings and feeds np.frombuffer zero-copy."""
    first = fp.readline()
    is_bytes = isinstance(first, bytes)
    COMMAND, SEED, SITE = (
        (b"COMMAND:", b"SEED:", b"SITE:") if is_bytes
        else ("COMMAND:", "SEED:", "SITE:"))
    header = first.split()
    if not header or header[0] != COMMAND:
        raise ValueError("MaCS COMMAND line not found")
    M = int(header[2])
    L = float(header[3])
    if fp.readline().split()[0] != SEED:
        raise ValueError("SEED line not found")
    p = PBWT(M, 0)
    p.sites = []
    u = engine.WriteCursor(M)
    zero = ord("0")
    for line in fp:
        parts = line.split()
        if not parts or parts[0] != SITE:
            break
        pos = int(L * float(parts[2]))
        haps = parts[4] if is_bytes else parts[4].encode()
        x = np.frombuffer(haps, dtype=np.uint8) - zero
        # NB the reference leaves varD unset for MaCS sites (pbwtIO.c:438-456)
        p.sites.append(Site(x=pos, varD=0))
        u.write_natural(x)
        p.N += 1
        _maybe_checkpoint(u, p)
    p.yz = u.packed()
    p.aFend = u.a.copy()
    log(f"read MaCS file: M, N are\t{M}\t{p.N}")
    return p


# --------------------------------------------------------------------------
# IMPUTE2 gen / hap / hap+legend (pbwtIO.c:627-775)
# --------------------------------------------------------------------------

def read_gen(fp, chrom: str) -> PBWT:
    p: PBWT | None = None
    u = None
    n_missing = 0
    for line in fp:
        parts = line.split()
        if len(parts) < 5:
            continue
        pos = int(parts[2])
        var = f"{parts[3]}\t{parts[4]}"
        probs = np.array(parts[5:], dtype=np.float32).reshape(-1, 3)
        x = np.zeros(2 * probs.shape[0], dtype=np.uint8)
        f0, f1, f2 = probs[:, 0], probs[:, 1], probs[:, 2]
        missing = (f0 + f1 + f2) == 0
        n_missing += int(missing.sum())
        f0 = np.where(missing, 1.0, f0)
        if ((f0 + f1 + f2) < 0.98).any():
            raise ValueError(f"inconsistent genotype in gen file at line N={p.N if p else 0}")
        # genotype call: argmax with reference tie-breaking
        # f0 wins if f0>f1 and f0>f2; else f1 wins if f1>f2; else f2
        g1 = ~((f0 > f1) & (f0 > f2)) & (f1 > f2)       # het -> 0,1
        g2 = ~((f0 > f1) & (f0 > f2)) & ~(f1 > f2)      # hom alt -> 1,1
        x[0::2] = g2.astype(np.uint8)
        x[1::2] = (g1 | g2).astype(np.uint8)
        if p is None:
            p = PBWT(len(x), 0)
            p.sites = []
            u = engine.WriteCursor(p.M)
        elif len(x) != p.M:
            raise ValueError("length mismatch reading gen line")
        p.sites.append(Site(x=pos, varD=registry.variation_dict.add(var)))
        u.write_natural(x)
        p.N += 1
        _maybe_checkpoint(u, p)
    if p is None:
        raise ValueError("empty gen file")
    p = _finish_build(p, u, "gen")
    p.chrom = chrom
    if n_missing:
        log(f"{n_missing} missing genotypes set to 00")
    return p


def read_hap(fp, chrom: str, legend_fp=None) -> PBWT:
    p: PBWT | None = None
    u = None
    legend_lines = None
    if legend_fp is not None:
        legend_lines = iter(legend_fp.read().split("\n")[1:])  # skip header
    for line in fp:
        parts = line.split()
        if legend_lines is not None:
            lparts = next(legend_lines).split()
            pos = int(lparts[1])
            var = f"{lparts[2]}\t{lparts[3]}"
            vals = parts
        else:
            if len(parts) < 5:
                continue
            pos = int(parts[2])
            var = f"{parts[3]}\t{parts[4]}"
            vals = parts[5:]
        x = np.array(vals, dtype=np.float32).astype(np.uint8)
        if p is None:
            p = PBWT(len(x), 0)
            p.sites = []
            u = engine.WriteCursor(p.M)
        elif len(x) != p.M:
            raise ValueError("length mismatch reading haps line")
        p.sites.append(Site(x=pos, varD=registry.variation_dict.add(var)))
        u.write_natural(x)
        p.N += 1
        _maybe_checkpoint(u, p)
    if p is None:
        raise ValueError("empty hap file")
    p = _finish_build(p, u, "hap-legend" if legend_fp is not None else "hap")
    p.chrom = chrom
    return p


# --------------------------------------------------------------------------
# Li-Stephens PHASE (pbwtReadPhase, pbwtIO.c:777-835)
# --------------------------------------------------------------------------

def read_phase(fp, chrom: str) -> PBWT:
    l1 = int(fp.readline().split()[0])
    l2 = int(fp.readline().split()[0])
    line3 = fp.readline()
    tok = line3.split()[0]
    if tok.startswith("P"):   # version 2: nhaps nsnps P<positions>
        version = 2
        nhaps, nsnps = l1, l2
        pos_tokens = line3.split()[1:]
    else:
        version = 1
        nhaps, nsnps = 2 * l2, int(tok)
        posline = fp.readline()
        pos_tokens = posline.split()[1:]   # strip leading P
    ninds = nhaps // 2
    log(f"Reading {nsnps} SNPs {nhaps} haplotypes and {ninds} individuals "
        f"from PHASE format version {version}")
    p = PBWT(nhaps, nsnps)
    p.chrom = chrom
    p.sites = [Site(x=int(t)) for t in pos_tokens[:nsnps]]
    if version == 1:
        sline = fp.readline().rstrip("\n")
        for i, s in enumerate(p.sites):
            s.varD = registry.variation_dict.add(sline[i] if i < len(sline) else "S")
    else:
        vid = registry.variation_dict.add("S")
        for s in p.sites:
            s.varD = vid
    X = np.zeros((nhaps, nsnps), dtype=np.uint8)
    for j in range(nhaps):
        row = fp.readline().rstrip("\n")
        X[j] = np.frombuffer(row[:nsnps].encode(), dtype=np.uint8) - ord("0")
    p.yz, p.aFend = engine.build_from_haplotypes(X)
    log(f"read phase file for chromosome {p.chrom}: M, N are\t{p.M}\t{p.N}; "
        f"yz length is {len(p.yz)}")
    return p


# --------------------------------------------------------------------------
# haplotype writers (pbwtIO.c:837-954)
# --------------------------------------------------------------------------

def _iter_sites(p: PBWT):
    """Yield (i, y_sorted, site) per site, streaming columns blockwise."""
    for k0, Yb in p.stream_sorted():
        for ib in range(Yb.shape[0]):
            i = k0 + ib
            yield i, Yb[ib], p.sites[i]


def write_haplotypes(fp, p: PBWT, impute_ref: bool = False) -> None:
    """pbwtWriteHaplotypes (:839-857): one line of M 0/1 chars per site.
    Streams the packed columns blockwise (O(M) live memory)."""
    a = (p.aFstart if p.aFstart is not None else np.arange(p.M, dtype=np.int32)).copy()
    hap = np.empty(p.M, dtype=np.uint8)
    sep = " " if impute_ref else ""
    zero_one = np.array([ord("0"), ord("1")], dtype=np.uint8)
    for k0, Yb in p.stream_sorted():
        for i in range(Yb.shape[0]):
            hap[a] = Yb[i]
            row = zero_one[np.minimum(hap, 1)].tobytes().decode()
            fp.write(sep.join(row) if impute_ref else row)
            fp.write("\n")
            a = engine.forwards_a(a, Yb[i])
    log(f"written haplotype file: {p.N} rows of {p.M}")


def write_transposed_haplotypes(p: PBWT, fp) -> None:
    X = p.haplotypes()
    for j in range(p.M):
        fp.write("".join("01"[v] for v in X[j]))
        fp.write("\n")
    log(f"written transposed haplotype file: {p.M} rows of {p.N}")


def write_impute_ref(p: PBWT, root: str) -> None:
    """pbwtWriteImputeRef (:877-891): .imputeHaps + .imputeLegend."""
    from ..utils import fopen_tag
    vd = registry.variation_dict
    with fopen_tag(root, "imputeHaps", "w") as fp:
        write_haplotypes(fp, p, impute_ref=True)
    with fopen_tag(root, "imputeLegend", "w") as fp:
        fp.write("rsID\tposition\ta0\ta1\n")
        for i, s in enumerate(p.sites):
            fp.write(f"site{i + 1}\t{s.x}\t{registry.variation_name(s.varD)}\n")
        log(f"written {p.N} sites from {p.sites[0].x} to {p.sites[-1].x}")


def write_impute_haps_g(p: PBWT, fp) -> None:
    """pbwtWriteImputeHapsG (:893-913)."""
    if p.sites is None:
        raise ValueError("pbwtWriteImputeHaps called without sites")
    vd = registry.variation_dict
    a = p.aFstart.copy()
    hap = np.empty(p.M, dtype=np.uint8)
    for k0, Yb in p.stream_sorted():
        for ib in range(Yb.shape[0]):
            i = k0 + ib
            s = p.sites[i]
            hap[a] = Yb[ib]
            fp.write(f"site{i + 1}\tsite{i + 1}\t{s.x}\t{registry.variation_name(s.varD)}")
            fp.write("".join(f" {int(v) and 1}" for v in hap))
            fp.write("\n")
            a = engine.forwards_a(a, Yb[ib])


def write_gen(p: PBWT, fp) -> None:
    """pbwtWriteGen (:915-954)."""
    if p.sites is None:
        raise ValueError("pbwtWriteGen called without sites")
    from ..algos.impute import dosage_retrieve
    vd = registry.variation_dict
    a = p.aFstart.copy()
    hap = np.empty(p.M, dtype=np.uint8)
    ad = np.empty(p.M, dtype=np.float64)
    is_dosage = p.dosageOffset is not None
    for i, y, s in _iter_sites(p):
        als = registry.variation_name(s.varD)
        als_u = als.replace("\t", "_")
        fp.write(f"{p.chrom}:{s.x}_{als_u} {p.chrom}:{s.x}_{als_u} {s.x}"
                 f" {als_u.replace('_', ' ')}")
        hap[a] = y
        if is_dosage:
            d = dosage_retrieve(p, y, i)
            ad[a] = d
            for j in range(0, p.M, 2):
                fp.write(f" {(1 - ad[j]) * (1 - ad[j + 1]):f}"
                         f" {ad[j] + ad[j + 1] - 2 * ad[j] * ad[j + 1]:f}"
                         f" {ad[j] * ad[j + 1]:f}")
        else:
            for j in range(0, p.M, 2):
                g = int(hap[j]) + int(hap[j + 1])
                fp.write(" 1 0 0" if g == 0 else " 0 1 0" if g == 1 else " 0 0 1")
        fp.write("\n")
        a = engine.forwards_a(a, y)


def write_phase(p: PBWT, filename: str) -> None:
    """pbwtWritePhase (pbwtIO.c:146-156): ChromoPainter input."""
    with open(filename, "w") as fp:
        fp.write(f"{p.M}\n{p.N}\nP")
        for s in p.sites:
            fp.write(f" {s.x}")
        fp.write("\n")
        write_transposed_haplotypes(p, fp)
