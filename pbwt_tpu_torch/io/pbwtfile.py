"""Native .pbwt binary format + sites/samples/missing/dosage/reverse sidecars.

Formats follow pbwtIO.c exactly:

.pbwt (v3, pbwtWrite :33-57):
    "PBW3" | int32 M | int32 N | int32 aFstart[M] | int32 aFend[M]
    | int64 nz | 4 pad bytes "    " | uint8 yz[nz]
Readers accept GBWT/PBWT/PBW2/PBW3 (pbwtRead :172-217).

.sites (pbwtWriteSites :59-77): "chrom\\tpos\\tref\\talt\\n" per site
.samples (pbwtWriteSamples :79-95): one diploid sample name per line
.missing/.dosage (writeDataOffset :97-112):
    int32 -1 | int64 n | uint8 data[n] | int64 offset[N]
.reverse: a .pbwt of zz with aRstart/aRend (pbwtWriteReverse :120-131)
"""

from __future__ import annotations

import struct
import sys

import numpy as np

from ..core import registry
from ..core.pbwt import PBWT, Site
from ..utils import log, fopen_tag


# --------------------------------------------------------------------------
# .pbwt binary
# --------------------------------------------------------------------------

def write_pbwt(p: PBWT, fp) -> None:
    if p is None or not p.yz:
        raise ValueError("pbwtWrite called without a valid pbwt")
    if p.aFstart is None or p.aFend is None:
        raise ValueError("pbwtWrite called without start and end indexes")
    fp.write(b"PBW3")
    fp.write(struct.pack("<ii", p.M, p.N))
    fp.write(np.asarray(p.aFstart, dtype="<i4").tobytes())
    fp.write(np.asarray(p.aFend, dtype="<i4").tobytes())
    fp.write(struct.pack("<q", len(p.yz)))
    fp.write(b"    ")
    fp.write(bytes(p.yz))
    log(f"written {len(p.yz)} chars pbwt: M, N are {p.M}, {p.N}")


def read_pbwt(fp) -> PBWT:
    tag = fp.read(4)
    if tag == b"PBW3":
        version = 3
    elif tag == b"PBW2":
        version = 2
    elif tag == b"PBWT":
        version = 1
    elif tag == b"GBWT":
        version = 0
    else:
        raise ValueError(f"failed to recognise file type {tag!r} in pbwtRead")
    m, n = struct.unpack("<ii", fp.read(8))
    p = PBWT(m, n)
    if version > 1:
        p.aFstart = np.frombuffer(fp.read(4 * m), dtype="<i4").astype(np.int32)
        p.aFend = np.frombuffer(fp.read(4 * m), dtype="<i4").astype(np.int32)
    else:
        p.aFstart = np.arange(m, dtype=np.int32)
    if version <= 2:
        (nz,) = struct.unpack("<i", fp.read(4))
    else:
        (nz,) = struct.unpack("<q", fp.read(8))
        fp.read(4)  # pad
    p.yz = fp.read(nz)
    if len(p.yz) != nz:
        raise ValueError("error reading data in pbwt file")
    log(f"read pbwt {tag.decode()} file with {nz} bytes: M, N are {p.M}, {p.N}")
    return p


# --------------------------------------------------------------------------
# sites
# --------------------------------------------------------------------------

def write_sites(p: PBWT, fp) -> None:
    if p is None or p.sites is None:
        raise ValueError("pbwtWriteSites called without sites")
    vd = registry.variation_dict
    # NULL chrom prints "."; the empty string (the readMatchChrom EOF
    # artefact above) prints as itself (pbwtIO.c:69)
    chrom = p.chrom if p.chrom is not None else "."
    for s in p.sites:
        # unregistered varD prints "(null)" exactly as the reference's
        # printf of a NULL dictName does (e.g. MaCS imports)
        name = vd.name(s.varD) if s.varD < len(vd) else "(null)"
        fp.write(f"{chrom}\t{s.x}\t{name}\n")
    log(f"written {p.N} sites from {p.sites[0].x} to {p.sites[-1].x}")


def read_sites_file(fp, chrom: str | None) -> tuple[list[Site], str | None]:
    """pbwtReadSitesFile (pbwtIO.c:232-267): returns (sites, chrom)."""
    sites: list[Site] = []
    for lineno, line in enumerate(fp, 1):
        line = line.rstrip("\n")
        if not line:
            continue
        parts = line.split("\t", 2)
        if len(parts) < 2:
            raise ValueError(f"bad position line {lineno} in sites file")
        new_chrom = parts[0]
        if new_chrom != ".":
            if chrom is None:
                chrom = new_chrom
            elif new_chrom != chrom:
                raise ValueError(f"failed to match chromosome in sites file: line {lineno}")
        s = Site(x=int(parts[1]))
        if len(parts) > 2:
            s.varD = registry.variation_dict.add(parts[2])
        sites.append(s)
    if chrom is None:
        # the reference's EOF iteration runs readMatchChrom on the empty
        # word fgetword returns at end-of-file, which sets a still-unset
        # chrom to "" (pbwtIO.c:219-230, 241-242) — observable in every
        # downstream "%s" of p->chrom (sites files, log lines)
        chrom = ""
    log(f"read {len(sites)} sites on chromosome {chrom} from file")
    return sites, chrom


def read_sites(p: PBWT, fp) -> None:
    p.sites, p.chrom = read_sites_file(fp, p.chrom)
    if len(p.sites) != p.N:
        raise ValueError(f"sites file contains {len(p.sites)} sites not {p.N} as in pbwt")


def read_ref_freq(p: PBWT, fp) -> None:
    """pbwtReadRefFreq (pbwtIO.c:278-310)."""
    if p is None or p.sites is None:
        raise ValueError("pbwtReadRefFreq called without current site information")
    entries: list[Site] = []
    for line in fp:
        line = line.rstrip("\n")
        if not line:
            continue
        parts = line.split("\t", 3)
        chrom, pos, freq = parts[0], int(parts[1]), float(parts[2])
        var = parts[3] if len(parts) > 3 else ""
        if chrom != p.chrom:
            raise ValueError(f"chromosome mismatch in readRefFreq '{chrom}' is not '{p.chrom}'")
        s = Site(x=pos, refFreq=freq)
        s.varD = registry.variation_dict.add(var)
        entries.append(s)
    j = 0
    for ps in p.sites:
        while j < len(entries) and (entries[j].x < ps.x or
                                    (entries[j].x == ps.x and entries[j].varD < ps.varD)):
            j += 1
        if j < len(entries) and ps.x == entries[j].x and ps.varD == entries[j].varD:
            ps.refFreq = entries[j].refFreq


# --------------------------------------------------------------------------
# samples
# --------------------------------------------------------------------------

def write_samples(p: PBWT, fp) -> None:
    if p is None or not p.samples:
        raise ValueError("pbwtWriteSamples called without samples")
    for i in range(0, p.M, 2):  # assume diploid
        k = p.samples[i]
        s = registry.samples[k]
        fp.write(registry.sample_name(k))
        if s.popD:
            fp.write(f"\tPOP:{registry.pop_name(k)}")
        if s.mother:
            fp.write(f"\tMOTHER:{registry.sample_name(s.mother)}")
        if s.father:
            fp.write(f"\tFATHER:{registry.sample_name(s.father)}")
        fp.write("\n")
    log(f"written {p.M // 2} samples")


def read_samples_file(fp) -> list[int]:
    """pbwtReadSamplesFile (pbwtIO.c:312-342): list of registry sample ids."""
    out: list[int] = []
    lines = fp.read().split("\n")
    i = 0
    while i < len(lines):
        line = lines[i]
        i += 1
        if not line.strip():
            continue
        name = line.split()[0]
        if name == "ID_1" and not out:      # IMPUTE2 header + line of zeroes
            i += 1
            continue
        out.append(registry.sample_add(name))
    log(f"read {len(out)} sample names")
    return out


def read_samples(p: PBWT, fp) -> None:
    ids = read_samples_file(fp)
    if len(ids) != p.M // 2:
        raise ValueError(f"wrong number of diploid samples: {p.M // 2} needed")
    p.samples = []
    for k in ids:
        p.samples.extend([k, k])


# --------------------------------------------------------------------------
# missing / dosage sidecars
# --------------------------------------------------------------------------

def _write_data_offset(fp, name: str, data: bytes, offset: np.ndarray, N: int) -> None:
    if data is None or offset is None:
        raise ValueError(f"write {name} called without data")
    fp.write(struct.pack("<i", -1))       # long-format marker
    fp.write(struct.pack("<q", len(data)))
    fp.write(bytes(data))
    fp.write(np.asarray(offset[:N], dtype="<i8").tobytes())
    log(f"written {len(data)} chars compressed {name} data")


def _read_data_offset(fp, name: str, N: int) -> tuple[bytes, np.ndarray]:
    (dummy,) = struct.unpack("<i", fp.read(4))
    if dummy != -1:
        n = dummy
    else:
        (n,) = struct.unpack("<q", fp.read(8))
    data = fp.read(n)
    log(f"read {n} chars compressed {name} data")
    if dummy != -1:
        offset = np.frombuffer(fp.read(4 * N), dtype="<i4").astype(np.int64)
    else:
        offset = np.frombuffer(fp.read(8 * N), dtype="<i8").astype(np.int64)
    return data, offset


def write_missing(p: PBWT, fp) -> None:
    _write_data_offset(fp, "missing", p.zMissing, p.missingOffset, p.N)


def read_missing(p: PBWT, fp) -> None:
    p.zMissing, p.missingOffset = _read_data_offset(fp, "missing", p.N)


def write_dosage(p: PBWT, fp) -> None:
    _write_data_offset(fp, "dosage", p.zDosage, p.dosageOffset, p.N)


def read_dosage(p: PBWT, fp) -> None:
    p.zDosage, p.dosageOffset = _read_data_offset(fp, "dosage", p.N)


# --------------------------------------------------------------------------
# reverse
# --------------------------------------------------------------------------

def write_reverse(p: PBWT, fp) -> None:
    if p is None or p.zz is None:
        raise ValueError("pbwtWriteReverse called without reverse pbwt")
    q = PBWT(p.M, p.N)
    q.yz = p.zz
    q.aFstart = p.aRstart
    q.aFend = p.aRend
    sys.stderr.write("")   # reference prefixes log with "reverse: "
    write_pbwt(q, fp)


def read_reverse(p: PBWT, fp) -> None:
    q = read_pbwt(fp)
    if q.M != p.M or q.N != p.N:
        raise ValueError(f"M {q.M} or N {q.N} in reverse don't match {p.M}, {p.N}")
    p.zz = q.yz
    p.aRstart = q.aFstart
    p.aRend = q.aFend
    p._decoded_r = None


# --------------------------------------------------------------------------
# writeAll / readAll / checkpoint
# --------------------------------------------------------------------------

def write_all(p: PBWT, root: str) -> None:
    with fopen_tag(root, "pbwt", "wb") as fp:
        write_pbwt(p, fp)
    if p.sites is not None:
        with fopen_tag(root, "sites", "w") as fp:
            write_sites(p, fp)
    if p.samples:
        with fopen_tag(root, "samples", "w") as fp:
            write_samples(p, fp)
    if p.missingOffset is not None:
        with fopen_tag(root, "missing", "wb") as fp:
            write_missing(p, fp)
    if p.dosageOffset is not None:
        with fopen_tag(root, "dosage", "wb") as fp:
            write_dosage(p, fp)
    if p.zz is not None:
        with fopen_tag(root, "reverse", "wb") as fp:
            write_reverse(p, fp)


def read_all(root: str) -> PBWT:
    import os
    with fopen_tag(root, "pbwt", "rb") as fp:
        p = read_pbwt(fp)
    for tag, reader, mode in (("sites", read_sites, "r"), ("samples", read_samples, "r"),
                              ("missing", read_missing, "rb"),
                              ("dosage", read_dosage, "rb"),
                              ("reverse", read_reverse, "rb")):
        path = f"{root}.{tag}"
        if os.path.exists(path):
            with open(path, mode) as fp:
                reader(p, fp)
    return p


_checkpoint_is_a = True


def checkpoint(u, p: PBWT) -> None:
    """pbwtCheckPoint (pbwtIO.c:158-168): alternate check_A / check_B roots."""
    global _checkpoint_is_a
    p.aFend = u.a.copy()
    prev_yz, prev_n = p.yz, p.N
    p.yz = u.packed()
    write_all(p, f"check_{'A' if _checkpoint_is_a else 'B'}")
    p.yz, p.N = prev_yz, prev_n
    _checkpoint_is_a = not _checkpoint_is_a
