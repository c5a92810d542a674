"""Minimal BCF2.2 reader/writer for the feature subset pbwt emits.

BCF2 layout (hts-specs VCFv4.2 section 6):
  "BCF\\2\\2" | uint32 l_text | header text (VCF header incl #CHROM, NUL)
  records: uint32 l_shared, uint32 l_indiv, then
    int32 rid, int32 pos(0-based), int32 rlen, float qual,
    uint32 n_info|n_allele<<16, uint32 n_sample|n_fmt<<24,
    typed ID string, typed allele strings, typed FILTER int vector,
    n_info x (typed int key, typed value),
    then per FORMAT field: typed int key, typed value block for all samples.

Typed descriptors: byte = (len<<4)|type with len 15 meaning a following
typed int gives the true length.  Types: 1 int8, 2 int16, 3 int32,
5 float, 7 char.  GT values are (allele+1)<<1|phased, int8 missing 0x80,
int8 vector-end 0x81.
"""

from __future__ import annotations

import struct
import sys

import numpy as np

INT8_MISSING = -128
INT8_END = -127
INT16_MISSING = -32768
INT16_END = -32767
INT32_MISSING = -2147483648
INT32_END = -2147483647
FLOAT_MISSING = 0x7F800001


# --------------------------------------------------------------------------
# typed value encoding
# --------------------------------------------------------------------------

def _typed_descriptor(length: int, btype: int) -> bytes:
    if length < 15:
        return bytes([(length << 4) | btype])
    return bytes([(15 << 4) | btype]) + _typed_int(length)


def _typed_int(v: int) -> bytes:
    if -120 <= v <= 127:
        return bytes([(1 << 4) | 1, v & 0xFF])
    if -32000 <= v <= 32767:
        return bytes([(1 << 4) | 2]) + struct.pack("<h", v)
    return bytes([(1 << 4) | 3]) + struct.pack("<i", v)


def _typed_string(s: str) -> bytes:
    b = s.encode()
    return _typed_descriptor(len(b), 7) + b


def _typed_int_vec(vals, force_type: int | None = None) -> bytes:
    vals = list(vals)
    if not vals:
        return bytes([0x00 | 1])
    lo, hi = min(vals), max(vals)
    if force_type == 1 or (force_type is None and -120 <= lo and hi <= 127):
        return (_typed_descriptor(len(vals), 1)
                + struct.pack(f"<{len(vals)}b", *vals))
    if force_type == 2 or (force_type is None and -32000 <= lo and hi <= 32767):
        return (_typed_descriptor(len(vals), 2)
                + struct.pack(f"<{len(vals)}h", *vals))
    return _typed_descriptor(len(vals), 3) + struct.pack(f"<{len(vals)}i", *vals)


def _typed_float_vec(vals) -> bytes:
    vals = list(vals)
    return _typed_descriptor(len(vals), 5) + struct.pack(f"<{len(vals)}f", *vals)


# --------------------------------------------------------------------------
# writer
# --------------------------------------------------------------------------

def write_bcf(p, filename: str, reference_fasta: str | None = None,
              compressed: bool = True) -> None:
    from . import vcf as vcfmod
    from ..core import engine, registry

    header_lines = vcfmod.vcf_header_lines(p, reference_fasta)
    chrom_line = ("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                  + "\t".join(vcfmod.sample_column_names(p)))
    text = "\n".join(header_lines) + "\n" + chrom_line + "\n\x00"

    # dictionary of strings: order of first appearance of FILTER/INFO/FORMAT
    # IDs in the header, PASS first (htslib: bcf_hdr_parse assigns IDX in
    # header order with PASS implicitly 0)
    dict_ids: list[str] = []
    for line in header_lines:
        for kind in ("FILTER", "INFO", "FORMAT"):
            if line.startswith(f"##{kind}=<ID="):
                name = line.split("ID=")[1].split(",")[0].split(">")[0]
                if name not in dict_ids:
                    dict_ids.append(name)
    idx = {name: i for i, name in enumerate(dict_ids)}
    contigs: list[str] = []
    for line in header_lines:
        if line.startswith("##contig=<ID="):
            contigs.append(line.split("ID=")[1].split(",")[0].split(">")[0])
    rid = {name: i for i, name in enumerate(contigs)}

    out_raw = sys.stdout.buffer if filename == "-" else open(filename, "wb")
    if compressed:
        from .bgzf import BgzfWriter
        out = BgzfWriter(out_raw)
    else:
        out = out_raw

    out.write(b"BCF\x02\x02")
    tb = text.encode()
    out.write(struct.pack("<I", len(tb)))
    out.write(tb)

    from ..algos.impute import dosage_retrieve
    is_dosage = p.dosageOffset is not None
    vd = registry.variation_dict
    Y = p.decoded(True)
    a = p.aFstart.copy()
    hap = np.empty(p.M, dtype=np.uint8)
    ad = np.empty(p.M, dtype=np.float64)
    for i, s in enumerate(p.sites):
        y = Y[i]
        hap[a] = y
        if is_dosage:
            ad[a] = dosage_retrieve(p, y, i)
        als = registry.variation_name(s.varD).split("\t")
        ref = als[0]
        alt = als[1] if len(als) > 1 else "."
        alleles = [ref] + ([alt] if alt != "." else [])
        ac = int(np.minimum(hap, 1).sum())
        an = p.M

        shared = bytearray()
        shared += struct.pack("<iii", rid[p.chrom], s.x - 1, len(ref))
        shared += struct.pack("<I", FLOAT_MISSING)
        n_info = 2 + (1 if p.isRefFreq else 0) + (1 if is_dosage else 0)
        shared += struct.pack("<I", (len(alleles) << 16) | n_info)
        n_fmt = 4 if is_dosage else 1
        shared += struct.pack("<I", (n_fmt << 24) | (p.M // 2))
        shared += _typed_string("")          # ID = missing
        for al in alleles:
            shared += _typed_string(al)
        shared += _typed_int_vec([idx["PASS"]])
        # INFO in htslib emission order: RefPanelAF?, DR2?, AC, AN
        if p.isRefFreq:
            shared += _typed_int(idx["RefPanelAF"]) + _typed_float_vec([s.refFreq])
        if is_dosage:
            shared += _typed_int(idx["DR2"]) + _typed_float_vec([s.imputeInfo])
        shared += _typed_int(idx["AC"]) + _typed_int_vec([ac])
        shared += _typed_int(idx["AN"]) + _typed_int_vec([an])

        indiv = bytearray()
        gt_vals = []
        for j in range(0, p.M, 2):
            gt_vals.append((int(hap[j]) + 1) << 1)            # first: unphased
            phased = 0 if p.isUnphased else 1
            gt_vals.append(((int(hap[j + 1]) + 1) << 1) | phased)
        indiv += _typed_int(idx["GT"])
        indiv += _typed_descriptor(2, 1) + struct.pack(f"<{p.M}b", *gt_vals)
        if is_dosage:
            indiv += _typed_int(idx["ADS"])
            indiv += _typed_descriptor(2, 5) + struct.pack(f"<{p.M}f", *ad[:p.M])
            ds = [float(ad[j] + ad[j + 1]) for j in range(0, p.M, 2)]
            indiv += _typed_int(idx["DS"])
            indiv += _typed_descriptor(1, 5) + struct.pack(f"<{len(ds)}f", *ds)
            gps = []
            for j in range(0, p.M, 2):
                d0, d1 = float(ad[j]), float(ad[j + 1])
                gps += [(1 - d0) * (1 - d1), d0 + d1 - 2 * d0 * d1, d0 * d1]
            indiv += _typed_int(idx["GP"])
            indiv += _typed_descriptor(3, 5) + struct.pack(f"<{len(gps)}f", *gps)

        out.write(struct.pack("<II", len(shared), len(indiv)))
        out.write(bytes(shared))
        out.write(bytes(indiv))
        from ..core import engine as _e
        a = _e.forwards_a(a, y)

    if compressed:
        out.close()
    elif filename != "-":
        out.close()
    else:
        out.flush()


# --------------------------------------------------------------------------
# reader
# --------------------------------------------------------------------------

class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def read(self, n: int) -> bytes:
        b = self.buf[self.off:self.off + n]
        self.off += n
        return b

    def typed(self):
        """Decode one typed value; returns (type, list-of-values)."""
        d = self.buf[self.off]
        self.off += 1
        length = d >> 4
        btype = d & 0x0F
        if length == 15:
            _, lv = self.typed()
            length = int(lv[0])
        if btype == 0:
            return btype, []
        if btype == 1:
            vals = struct.unpack_from(f"<{length}b", self.buf, self.off)
            self.off += length
        elif btype == 2:
            vals = struct.unpack_from(f"<{length}h", self.buf, self.off)
            self.off += 2 * length
        elif btype == 3:
            vals = struct.unpack_from(f"<{length}i", self.buf, self.off)
            self.off += 4 * length
        elif btype == 5:
            vals = struct.unpack_from(f"<{length}f", self.buf, self.off)
            self.off += 4 * length
        elif btype == 7:
            vals = (self.read(length).decode(),)
        else:
            raise ValueError(f"bad BCF type {btype}")
        return btype, list(vals)


def read_bcf(raw) -> tuple[list[str], list[str], "iter"]:
    """Parse a (decompressed) BCF stream; returns (header_lines, samples,
    iterator of text-VCF-like field lists) compatible with
    vcf._parse_vcf_text output."""
    data = raw.read()
    if data[:5] != b"BCF\x02\x02":
        raise ValueError("not a BCF2.2 file")
    (l_text,) = struct.unpack_from("<I", data, 5)
    text = data[9:9 + l_text].rstrip(b"\x00").decode()
    header_lines = [ln for ln in text.split("\n") if ln.startswith("##")]
    chrom_line = next(ln for ln in text.split("\n") if ln.startswith("#CHROM"))
    samples = chrom_line.split("\t")[9:]

    # dictionaries
    dict_ids: list[str] = []
    contigs: list[str] = []
    for line in header_lines:
        if line.startswith("##contig=<ID="):
            name = line.split("ID=")[1].split(",")[0].split(">")[0]
            contigs.append(name)
        for kind in ("FILTER", "INFO", "FORMAT"):
            if line.startswith(f"##{kind}=<ID="):
                name = line.split("ID=")[1].split(",")[0].split(">")[0]
                if name not in dict_ids:
                    dict_ids.append(name)

    body = data[9 + l_text:]

    def records():
        off = 0
        n = len(body)
        while off + 8 <= n:
            l_shared, l_indiv = struct.unpack_from("<II", body, off)
            off += 8
            rec = body[off:off + l_shared + l_indiv]
            off += l_shared + l_indiv
            r = _Reader(rec)
            rid_, pos, _rlen = struct.unpack("<iii", r.read(12))
            r.read(4)  # qual
            (nai,) = struct.unpack("<I", r.read(4))
            n_allele, n_info = nai >> 16, nai & 0xFFFF
            (nfs,) = struct.unpack("<I", r.read(4))
            n_fmt, n_sample = nfs >> 24, nfs & 0xFFFFFF
            _, _id = r.typed()
            alleles = []
            for _ in range(n_allele):
                _, v = r.typed()
                alleles.append(v[0] if v else "")
            r.typed()  # FILTER
            for _ in range(n_info):
                r.typed()  # key
                r.typed()  # value
            # move to indiv section
            r.off = l_shared
            gt_strs = ["."] * n_sample
            fmt_names = []
            for _f in range(n_fmt):
                _, keyv = r.typed()
                key = dict_ids[int(keyv[0])]
                fmt_names.append(key)
                d = rec[r.off]
                length = d >> 4
                btype = d & 0x0F
                r.off += 1
                if length == 15:
                    _, lv = r.typed()
                    length = int(lv[0])
                size = {1: 1, 2: 2, 3: 4, 5: 4, 7: 1}[btype]
                block = rec[r.off:r.off + size * length * n_sample]
                r.off += size * length * n_sample
                if key == "GT":
                    arr = np.frombuffer(block, dtype={1: np.int8, 2: np.int16,
                                                      3: np.int32}[btype])
                    arr = arr.reshape(n_sample, length)
                    end_val = {1: INT8_END, 2: INT16_END, 3: INT32_END}[btype]
                    miss_val = {1: INT8_MISSING, 2: INT16_MISSING,
                                3: INT32_MISSING}[btype]
                    for si in range(n_sample):
                        toks = []
                        seps = []
                        for vi, v in enumerate(arr[si]):
                            if v == end_val:
                                break
                            if v == miss_val or v == 0:
                                toks.append(".")
                            else:
                                toks.append(str((int(v) >> 1) - 1))
                            seps.append("|" if (int(v) & 1) else "/")
                        g = ""
                        for vi, t in enumerate(toks):
                            if vi:
                                g += seps[vi] + t
                            else:
                                g += t
                        gt_strs[si] = g if g else "."
            ref = alleles[0] if alleles else "N"
            alt = ",".join(alleles[1:]) if len(alleles) > 1 else "."
            yield [contigs[rid_], str(pos + 1), ".", ref, alt, ".", ".",
                   ".", ":".join(fmt_names)] + gt_strs

    return header_lines, samples, records()
