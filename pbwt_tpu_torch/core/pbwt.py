"""The PBWT object and its structural views.

Mirrors the reference PBWT struct (pbwt.h:35-53) and the view operations of
pbwtCore.c (subsites/subrange/selectSites/removeSites/buildReverse/
haplotypes) and pbwtSample.c (subsample/selectSamples).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import engine, registry


@dataclass
class Site:
    """Mirrors Site (pbwt.h:57-63)."""

    x: int = 0                 # position on chromosome
    varD: int = 0              # index into registry.variation_dict
    freq: float = 0.0
    refFreq: float = 0.0
    imputeInfo: float = 0.0

    def copy(self) -> "Site":
        return Site(self.x, self.varD, self.freq, self.refFreq, self.imputeInfo)

    def alleles(self) -> str:
        return registry.variation_dict.name(self.varD)


def log(msg: str) -> None:
    """Reference logs one line per operation to logFile (default stderr)."""
    from .. import utils
    utils.log(msg)


class PBWT:
    """Run-length-compressed positional BWT of M haplotypes x N sites."""

    def __init__(self, M: int, N: int = 0):
        self.M = M
        self.N = N
        self.chrom: str | None = None
        self.sites: list[Site] | None = None
        self.samples: list[int] | None = None    # indices into registry.samples
        self.yz: bytes = b""
        self.aFstart: np.ndarray | None = np.arange(M, dtype=np.int32)
        self.aFend: np.ndarray | None = None
        self.zz: bytes | None = None
        self.aRstart: np.ndarray | None = None
        self.aRend: np.ndarray | None = None
        self.zMissing: bytes | None = None
        self.missingOffset: np.ndarray | None = None   # int64[N], 0 = none
        self.zDosage: bytes | None = None
        self.dosageOffset: np.ndarray | None = None
        self.isRefFreq = False
        self.isUnphased = False
        self._decoded_f: np.ndarray | None = None      # cache of unpacked yz
        self._decoded_r: np.ndarray | None = None      # cache of unpacked zz

    # ---- decoding ---------------------------------------------------------

    def invalidate(self):
        self._decoded_f = None
        self._decoded_r = None

    def decoded(self, forwards: bool = True) -> np.ndarray:
        """(N, M) uint8 matrix of sorted-order column values."""
        from . import native
        if forwards:
            if self._decoded_f is None:
                self._decoded_f = native.decode_cols(self.yz, self.N, self.M)
            return self._decoded_f
        else:
            if self._decoded_r is None:
                if self.zz is None:
                    raise ValueError("no reverse pbwt present")
                self._decoded_r = native.decode_cols(self.zz, self.N, self.M)
            return self._decoded_r

    def haplotypes(self) -> np.ndarray:
        """(M, N) natural-order haplotype matrix (pbwtHaplotypes)."""
        a0 = self.aFstart if self.aFstart is not None else np.arange(self.M, dtype=np.int32)
        if self.yz:
            from . import native
            # one streaming C pass straight off the pack3 bytes + a
            # C transpose (skips decoding the sorted matrix entirely)
            Xc, _, _ = native.natural_cols(self.yz, self.N, self.M, a0)
            X = np.empty((self.M, self.N), np.uint8)
            native.get_lib().transpose_u8(Xc.reshape(-1), self.N, self.M,
                                          X.reshape(-1))
            return X
        return engine.haplotypes_from_packed(self.decoded(True), a0)

    def stream_sorted(self, block: int = 1024):
        """Yield (k0, Yblock) sorted-column blocks of at most ``block``
        sites, decoding the pack3 stream incrementally - O(M*block) live
        memory, the streaming analogue of the reference's read cursor
        (pbwtCore.c:527-541).  The yielded array is a reused buffer unless
        the panel is decoded already: consume it before advancing."""
        if self._decoded_f is not None:
            for k0 in range(0, self.N, block):
                yield k0, self._decoded_f[k0:k0 + block]
            return
        from . import native
        lib = native.get_lib()
        z = np.frombuffer(self.yz, np.uint8)
        pos = 0
        buf = np.empty((block, self.M), np.uint8)
        for k0 in range(0, self.N, block):
            b = min(block, self.N - k0)
            used = lib.p3_decode_cols(z[pos:], len(z) - pos, b, self.M,
                                      buf.reshape(-1))
            if used < 0:
                raise ValueError("corrupt pack3 stream")
            pos += used
            yield k0, buf[:b]

    # ---- construction -----------------------------------------------------

    @classmethod
    def from_haplotypes(cls, X: np.ndarray, chrom: str | None = None,
                        sites: list[Site] | None = None,
                        samples: list[int] | None = None) -> "PBWT":
        X = np.ascontiguousarray(X, dtype=np.uint8)
        M, N = X.shape
        p = cls(M, N)
        p.yz, p.aFend = engine.build_from_haplotypes(X)
        p.chrom = chrom
        p.sites = sites
        p.samples = samples
        return p

    def set_from_write_cursor(self, u: "engine.WriteCursor", N: int):
        self.N = N
        self.yz = u.packed()
        self.aFend = u.a.copy()
        self.invalidate()

    # ---- reverse PBWT (pbwtBuildReverse, pbwtCore.c:151-191) --------------

    def build_reverse(self):
        from . import native
        if self.yz and self.aFend is not None:
            # one C pass: offsets skim + backward prefix-array inversion +
            # fused gather/encode/partition emit (pbwtCore.c:151-191)
            self.zz, self.aRend = native.build_reverse_core(
                self.yz, self.M, self.N, self.aFend)
            self.aRstart = self.aFend.copy()
            self._decoded_r = None
            log(f"built reverse PBWT - size {len(self.zz)}")
            return
        Y = self.decoded(True)
        a0 = self.aFstart if self.aFstart is not None else np.arange(self.M, dtype=np.int32)
        if self.aFend is None:
            # run forwards to the end to get aFend
            a = a0.copy()
            for k in range(self.N):
                a = engine.forwards_a(a, Y[k])
            self.aFend = a
        # reverse cursor starts from aFend (better performance, :166-167)
        self.aRstart = self.aFend.copy()
        u = engine.WriteCursor(self.M, self.aRstart)
        # stream the forward pbwt backwards
        uf = engine.ReadCursor(Y, self.aFend)
        uf.pos = self.N
        x = np.empty(self.M, dtype=np.uint8)
        for k in range(self.N - 1, -1, -1):
            uf.read_backwards()
            x[uf.a] = uf.y
            u.write_forwards(x[u.a])
        self.zz = u.packed()
        self.aRend = u.a.copy()   # lexicographic order of the sequences
        self._decoded_r = None
        log(f"built reverse PBWT - size {len(self.zz)}")

    # ---- site views -------------------------------------------------------

    def _rebuild_with_columns(self, cols: np.ndarray, sites: list[Site] | None
                              ) -> "PBWT":
        """Make a new PBWT from selected natural-order columns (M, N')."""
        pnew = PBWT(self.M, 0)
        pnew.yz, pnew.aFend = engine.build_from_haplotypes(cols)
        pnew.N = cols.shape[1]
        pnew.sites = sites
        return pnew

    def _rebuild_with_keep(self, keep: np.ndarray, sites: list[Site] | None
                           ) -> "PBWT":
        """Re-PBWT a site selection.  Streams the pack3 bytes through the
        C cursor pair (O(M) live memory, like the reference's
        pbwtSubSites/SelectSites loops); a PBWT without bytes is rebuilt
        from its haplotypes."""
        from . import native
        keep = np.ascontiguousarray(keep, np.uint8)
        if self.yz:
            a0 = (self.aFstart if self.aFstart is not None
                  else np.arange(self.M, dtype=np.int32))
            pnew = PBWT(self.M, int(np.count_nonzero(keep)))
            pnew.yz, pnew.aFend = native.select_repack(self.yz, self.M,
                                                       self.N, keep, a0)
            pnew.sites = sites
            return pnew
        X = self.haplotypes()
        return self._rebuild_with_columns(
            np.ascontiguousarray(X[:, np.flatnonzero(keep)]), sites)

    def sub_sites(self, fmin: float, frac: float) -> "PBWT":
        """pbwtSubSites (pbwtCore.c:71-110)."""
        if not self.yz:
            raise ValueError("subsites without an existing pbwt")
        if not (0 <= fmin < 1) or not (0 < frac <= 1):
            raise ValueError(f"fmin {fmin}, frac {frac} for subsites out of range")
        from . import native
        M = self.M
        thresh = int(M * (1 - fmin))
        c0 = native.col_counts(self.yz, M, self.N)
        keep = []
        bit = 0.0
        for i in range(self.N):
            if int(c0[i]) < thresh:
                bit += frac
                if bit > 1.0:
                    keep.append(i)
                    bit -= 1.0
        keep = np.array(keep, dtype=np.int64)
        sites = [self.sites[i].copy() for i in keep] if self.sites else None
        mask = np.zeros(self.N, np.uint8)
        mask[keep] = 1
        pnew = self._rebuild_with_keep(mask, sites)
        log(f"subsites with fmin {fmin:f}, frac {frac:f} leaves {pnew.N} sites")
        pnew.chrom = self.chrom
        pnew.samples = self.samples
        pnew.missingOffset = self.missingOffset
        pnew.zMissing = self.zMissing
        return pnew

    def sub_range(self, start: int, end: int) -> "PBWT":
        """pbwtSubRange (pbwtCore.c:112-147)."""
        if not self.yz:
            raise ValueError("subrange without an existing pbwt")
        if start < 0 or end > self.N or end <= start:
            raise ValueError(f"subrange invalid start {start}, end {end}")
        sites = [self.sites[i].copy() for i in range(start, end)] if self.sites else None
        mask = np.zeros(self.N, np.uint8)
        mask[start:end] = 1
        pnew = self._rebuild_with_keep(mask, sites)
        pnew.chrom = self.chrom
        pnew.samples = self.samples
        pnew.missingOffset = self.missingOffset
        pnew.zMissing = self.zMissing
        return pnew

    def _select_sites_local(self, sites: list[Site], keep_old: bool,
                            fill_missing: bool) -> "PBWT":
        """selectSitesLocal (pbwtCore.c:623-682): intersect this pbwt's sites
        with the given list by (pos, varD) merge walk."""
        if self.sites is None:
            raise ValueError("selectSites without sites")
        vd = registry.variation_dict
        keep_cols: list[int] = []
        new_sites: list[Site] = []
        ip = ia = 0
        while ip < self.N and ia < len(sites):
            sp, sa = self.sites[ip], sites[ia]
            if sp.x < sa.x:
                ip += 1
            elif sp.x > sa.x:
                ia += 1
            else:
                sa_als = vd.name(sa.varD)
                sp_als = vd.name(sp.varD)
                no_alt = sa_als.endswith(".") or sp_als.endswith(".")
                if not no_alt and sp.varD < sa.varD:
                    ip += 1
                elif not no_alt and sp.varD > sa.varD:
                    ia += 1
                else:
                    new_sites.append(sp.copy())
                    keep_cols.append(ip)
                    ip += 1
                    ia += 1
        mask = np.zeros(self.N, np.uint8)
        mask[np.array(keep_cols, dtype=np.int64)] = 1
        pnew = self._rebuild_with_keep(mask, new_sites)
        log(f"{pnew.N} sites selected from {self.N}, pbwt size for {pnew.M} "
            f"haplotypes is {len(pnew.yz)}")
        if keep_old:
            pnew.samples = list(self.samples) if self.samples else None
            pnew.chrom = self.chrom
        else:
            if pnew.N == self.N:
                return self
            pnew.chrom = self.chrom
            pnew.samples = self.samples
        return pnew

    def select_sites(self, sites: list[Site], keep_old: bool = False) -> "PBWT":
        return self._select_sites_local(sites, keep_old, False)

    def select_sites_fill_missing(self, sites: list[Site], keep_old: bool = False) -> "PBWT":
        return self._select_sites_local(sites, keep_old, True)

    def remove_sites(self, sites: list[Site], keep_old: bool = False) -> "PBWT":
        """pbwtRemoveSites (pbwtCore.c:690-746)."""
        if self.sites is None:
            raise ValueError("removeSites without sites")
        keep_cols: list[int] = []
        new_sites: list[Site] = []
        ip = ia = 0
        while ip < self.N and ia < len(sites):
            sp, sa = self.sites[ip], sites[ia]
            if sp.x < sa.x or (sp.x == sa.x and sp.varD < sa.varD):
                new_sites.append(sp.copy())
                keep_cols.append(ip)
                ip += 1
            elif sp.x > sa.x or sp.varD > sa.varD:
                ia += 1
            else:
                ip += 1
                ia += 1
        # NB reference stops at the end of either list; trailing sites of the
        # pbwt beyond the remove list are dropped, as in the reference loop.
        mask = np.zeros(self.N, np.uint8)
        mask[np.array(keep_cols, dtype=np.int64)] = 1
        pnew = self._rebuild_with_keep(mask, new_sites)
        log(f"{pnew.N} sites selected from {self.N}, pbwt size for {pnew.M} "
            f"haplotypes is {len(pnew.yz)}")
        if keep_old:
            pnew.samples = list(self.samples) if self.samples else None
            pnew.chrom = self.chrom
        else:
            if pnew.N == self.N:
                return self
            pnew.chrom = self.chrom
            pnew.samples = self.samples
        return pnew

    # ---- sample views (pbwtSample.c:59-135) --------------------------------

    def sub_sample_select(self, select: np.ndarray) -> "PBWT":
        """pbwtSubSample: select[i] = old haplotype index of new column i."""
        if not self.yz:
            raise ValueError("subSample called without valid pbwt")
        from . import native
        pnew = PBWT(int(len(select)), self.N)
        a0 = (self.aFstart if self.aFstart is not None
              else np.arange(self.M, dtype=np.int32))
        pnew.yz, pnew.aFend = native.subsample_repack(
            self.yz, self.M, self.N, np.asarray(select, np.int64), a0)
        if self.samples:
            pnew.samples = [self.samples[int(j)] for j in select]
        pnew.chrom = self.chrom
        pnew.sites = self.sites
        return pnew

    def sub_sample_interval(self, start: int, Mnew: int) -> "PBWT":
        if start < 0 or Mnew <= 0 or start + Mnew > self.M:
            raise ValueError(f"bad start {start}, Mnew {Mnew} in subsample")
        return self.sub_sample_select(np.arange(start, start + Mnew))

    def select_samples(self, names: list[int]) -> "PBWT":
        """pbwtSelectSamples (pbwtSample.c:110-135): names are registry ids."""
        if not self.samples:
            raise ValueError("selectSamples called without pre-existing sample names")
        if not names:
            return self
        # group old haplotype columns by sample id preserving file order
        start: dict[int, int] = {}
        count: dict[int, int] = {}
        for i, sid in enumerate(self.samples):
            if sid not in count:
                start[sid] = i
                count[sid] = 0
            count[sid] += 1
        select: list[int] = []
        for sid in names:
            for _ in range(count.get(sid, 0)):
                select.append(start[sid])
                start[sid] += 1
        return self.sub_sample_select(np.array(select, dtype=np.int64))

    # ---- stats -------------------------------------------------------------

    def allele_count1_per_site(self) -> np.ndarray:
        """Number of 1s per site (frequency numerator)."""
        Y = self.decoded(True)
        return (Y != 0).sum(axis=1).astype(np.int64)
