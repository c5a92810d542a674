"""Multi-PBWT merge (pbwtMerge.c): synced positional walk over k pbwts,
keeping only sites present in every file, concatenating haplotype columns
and re-PBWTing the union panel in one streaming C pass, which holds one
column of each input at a time, as pbwtMerge.c:78-127 does."""

from __future__ import annotations

import numpy as np

from ..core import native, registry
from ..core.pbwt import PBWT, Site
from ..io import pbwtfile
from ..utils import log


def merge(filenames: list[str]) -> PBWT:
    pbwts: list[PBWT] = []
    for fn in filenames:
        with open(fn, "rb") as fp:
            p = pbwtfile.read_pbwt(fp)
        sites_fn = fn[:-4] + "sites" if fn.endswith("pbwt") else fn + ".sites"
        with open(sites_fn) as fp:
            pbwtfile.read_sites(p, fp)
        pbwts.append(p)
    for p in pbwts[1:]:
        if p.chrom != pbwts[0].chrom:
            raise ValueError(f"Different chromosomes: {pbwts[0].chrom} vs {p.chrom}")

    vd = registry.variation_dict
    keys = [[(s.x, vd.name(s.varD)) for s in p.sites] for p in pbwts]
    n = len(pbwts)
    nhaps = sum(p.M for p in pbwts)

    out = PBWT(nhaps, 0)
    out.sites = []
    out.chrom = pbwts[0].chrom

    # key walk first (cheap, O(total sites) python), recording per file the
    # action stream over its consumed columns: 1 = column of an emitted
    # shared site, 0 = discard; the column work itself then runs as ONE
    # streaming C pass (native.merge_core) with the reference's O(M)-live
    # cursor memory model (pbwtMerge.c:129-208)
    acts: list[list[int]] = [[] for _ in range(n)]

    # transliteration of the reference's reader advance
    # (pbwt_reader_next, pbwtMerge.c:78-127): skip every site whose key is
    # <= the last-emitted (mpos, mals) — duplicate keys within a file
    # collapse, and the column streams advance one unpack per KEY, not per
    # site, exactly as the reference's cursors do
    cpos = [0] * n
    state = {"mpos": 0, "mals": None}

    def reader_next() -> int:
        min_pos = None
        min_als = None
        for i, p in enumerate(pbwts):
            j = cpos[i]
            if j >= p.N:
                continue
            x, als = keys[i][j]
            # NB the loop tests the values from the PREVIOUS iteration's
            # body, like the reference's stale `site` variable does
            while (j < p.N and x <= state["mpos"]
                   and (state["mals"] is None or als <= state["mals"])):
                x, als = keys[i][j]
                cpos[i] = j
                j += 1
            if (cpos[i] + 1 >= p.N and x == state["mpos"]
                    and (state["mals"] is None or als == state["mals"])):
                cpos[i] = p.N          # exhausted on an already-read site
                continue
            if cpos[i] < p.N and (min_pos is None or x < min_pos):
                min_pos, min_als = x, als
            if x == min_pos and (min_als is None or als < min_als):
                min_als = als
        if min_pos is None:
            state["mpos"], state["mals"] = 0, None
        else:
            state["mpos"], state["mals"] = min_pos, min_als
        return state["mpos"]

    while reader_next():
        pos, mals = state["mpos"], state["mals"]
        shared = all(cpos[i] < pbwts[i].N and keys[i][cpos[i]] == (pos, mals)
                     for i in range(n))
        for i in range(n):
            if cpos[i] < pbwts[i].N and keys[i][cpos[i]] == (pos, mals):
                acts[i].append(1 if shared else 0)
        if not shared:
            continue
        out.sites.append(Site(x=pos, varD=vd.add(mals)))
        out.N += 1

    n_emit = out.N
    a0s = [(p.aFstart if p.aFstart is not None
            else np.arange(p.M, dtype=np.int32)) for p in pbwts]
    out.yz, out.aFend = native.merge_core(
        [p.yz for p in pbwts], [p.M for p in pbwts], a0s,
        [np.asarray(a, np.uint8) for a in acts], n_emit)
    log(f"merged {len(pbwts)} pbwts: M, N are {out.M}, {out.N}")
    return out
