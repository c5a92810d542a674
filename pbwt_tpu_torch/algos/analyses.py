"""Small built-in analyses hosted in the reference's pbwtMain.c:
prettyPlot (:60-78), exportSiteInfo (:82-100), siteFrequencySpectrum
(:104-143), and imputeExplore's dosage playground."""

from __future__ import annotations

import sys

import numpy as np

from ..core import engine
from ..core.pbwt import PBWT
from ..utils import log, time_update


def pretty_plot(p: PBWT, fp, K: int) -> None:
    """prettyPlot (pbwtMain.c:60-78): rows in sort order at site K, columns
    K-100..K+20.  Streams the pack3 cursor; only the 121-column window is
    ever materialised in natural order."""
    lo, hi = K - 100, min(K + 21, p.N)
    a = p.aFstart.copy()
    aK = a
    win = np.zeros((max(hi - lo, 0), p.M), np.uint8)
    done = False
    for k0, Yc in p.stream_sorted(512):
        if done:
            break
        for s in range(Yc.shape[0]):
            k = k0 + s
            if k >= hi:
                done = True
                break
            if k >= lo:
                win[k - lo, a] = Yc[s]    # natural order: column k is in
            if k == K:                    # a_k order (yz sorted per site)
                aK = a
            a = engine.forwards_a(a, Yc[s])
    rows = win[:, aK].T                   # (M, window) in sort order at K
    for j in range(p.M):
        row = rows[j]
        fp.write("".join("01"[v] for v in row[:K - lo]))
        fp.write(f" {'01'[row[K - lo]]} ")
        fp.write("".join("01"[v] for v in row[K - lo + 1:K - lo + 20]))
        fp.write("\n")


def export_site_info(p: PBWT, fp, f1: int, f2: int) -> None:
    """Print d[] and y[] for sites with f1 <= allele-count < f2 (streaming)."""
    a = p.aFstart.copy()
    d = np.zeros(p.M + 1, dtype=np.int32)
    d[0] = 1
    d[p.M] = 1
    n = 0
    for k0, Yc in p.stream_sorted(512):
        for s in range(Yc.shape[0]):
            i = k0 + s
            y = Yc[s]
            f = int(np.count_nonzero(y))
            if f1 <= f < f2:
                fp.write(" ".join(f"{int(y[j])} {i - int(d[j])}"
                                  for j in range(p.M)))
                fp.write(" \n")
                n += 1
            a, d = engine.forwards_ad(a, d, y, i)
    log(f"{n} rows exported with allele count f, {f1} <= f < {f2}")


SFS_THRESH = [1, 2, 3, 4, 5, 6, 7, 8, 9,
              10, 20, 30, 40, 50, 60, 70, 80, 90,
              100, 200, 300, 400, 500, 600, 700, 800, 900,
              1000, 2000, 3000, 4000, 5000, 6000, 7000, 8000, 9000,
              10000, 20000, 30000, 40000, 50000, 60000, 70000, 80000, 90000,
              100000, 200000, 300000, 400000, 500000, 600000, 700000, 800000,
              900000, 1000000]


def site_frequency_spectrum(p: PBWT) -> None:
    """siteFrequencySpectrum (pbwtMain.c:104-143): log-binned SFS; also fills
    Site.freq and writes sites.freq when sites are present."""
    time_update()
    if p.yz and p._decoded_f is None:
        from ..core import native
        # O(M) live memory: counts off the RLE bytes
        counts1 = p.M - native.col_counts(p.yz, p.M, p.N)
    else:
        counts1 = (p.decoded(True) != 0).sum(axis=1)
    hist = np.bincount(counts1, minlength=p.M + 1)
    if p.sites is not None:
        from ..core import registry
        vd = registry.variation_dict
        chrom = p.chrom if p.chrom is not None else "(null)"
        with open("sites.freq", "w") as fp:
            for i, s in enumerate(p.sites):
                s.freq = 1.0 - (p.M - int(counts1[i])) / p.M
                name = vd.name(s.varD) if s.varD < len(vd) else "(null)"
                fp.write(f"{chrom}\t{s.x}\t{s.freq:.6f}\t{name}\n")
    n = 0
    j = 0
    out = sys.stdout
    for i in range(1, p.M):
        n += int(hist[i]) if i < len(hist) else 0
        if i == SFS_THRESH[j]:
            out.write(f"{SFS_THRESH[j]}\t{n}\n")
            j += 1
            n = 0
    out.write(f"{SFS_THRESH[j]}\t{n}\n")


def play_ground(p: PBWT) -> PBWT:
    """playGround (pbwtMain.c:31-56): compare per-site info computed from the
    stored dosages against Site.imputeInfo; prints the RMS difference."""
    import math
    if p.zDosage is None or p.sites is None:
        raise ValueError("-play requires dosages and sites")
    from .impute import dosage_retrieve
    Y = p.decoded(True)
    sum_diff2 = 0.0
    for k in range(p.N):
        d = dosage_retrieve(p, Y[k], k)
        psum = float(d.sum())
        nz = d != 0
        xsum = float(nz.sum())
        pxsum = float(d[nz].sum())
        psum /= p.M; xsum /= p.M; pxsum /= p.M
        var_prod = psum * (1.0 - psum) * xsum * (1.0 - xsum)
        info = (pxsum - psum * psum) / math.sqrt(var_prod) if var_prod else 1.0
        diff = info - p.sites[k].imputeInfo
        sum_diff2 += diff * diff
    sys.stdout.write("RMS info to zInfo %.4f\n" % math.sqrt(sum_diff2 / p.N))
    return p


def impute_explore(p: PBWT, test: int) -> None:
    """imputeExplore (pbwtImpute.c:35-161): neighbour-concordance statistics
    used to explore imputability; supports tests 1-4."""
    import math
    M, N = p.M, p.N
    f_bound = [0.1, 0.2, 0.3, 0.5, 0.7, 1, 2, 3, 5, 7, 10, 20, 30, 50, 70, 90, 100.01]
    stats = [dict(n00=0, n01=0, n10a=0, n10b=0, n11a=0, n11b=0, n20=0, n21=0,
                  fsum=0.0) for _ in range(17)]
    c0 = np.zeros((17, 5), dtype=np.int64)
    c1 = np.zeros((17, 5), dtype=np.int64)
    d_hist: dict[int, np.ndarray] = {}
    c_simple = np.zeros(4, dtype=np.int64)
    c_cond0 = np.zeros(4, dtype=np.int64)
    c_cond1 = np.zeros(4, dtype=np.int64)

    p.build_reverse()
    Y = p.decoded(True)
    Z = p.decoded(False)
    a = p.aFstart.copy()
    d = np.zeros(M + 1, np.int32)
    d[0] = 1
    d[M] = 1
    # reverse cursor runs backwards from the end of the reverse pbwt
    az = p.aRend.copy()
    n0 = np.zeros(M, np.int64)
    n1 = np.zeros(M, np.int64)
    x = np.zeros(M, np.uint8)
    zpos = N
    for k in range(N):
        # read reverse backwards: column zpos-1
        zpos -= 1
        yz = Z[zpos]
        cz = int(np.count_nonzero(yz == 0))
        az = engine.backwards_a(az, yz, cz)
        if 0.2 * N < k < 0.8 * N:
            y = Y[k]
            f = float(np.count_nonzero(y)) / M
            ff = 0
            while f * 100 > f_bound[ff]:
                ff += 1
            t = stats[ff]
            t["fsum"] += f
            n0[:] = 0
            n1[:] = 0
            ym = y[:-2].astype(np.int64)
            yp_ = y[2:].astype(np.int64)
            yc = y[1:-1].astype(np.int64)
            both1 = (ym == 1) & (yp_ == 1)
            both0 = (ym == 0) & (yp_ == 0)
            da = d[1:M - 1]
            db = d[2:M]
            lower0 = ((ym == 0) & (da < db)) | ((yp_ == 0) & (db < da))
            t["n21"] += int((both1 & (yc == 1)).sum())
            t["n20"] += int((both1 & (yc == 0)).sum())
            t["n01"] += int((both0 & (yc == 1)).sum())
            t["n00"] += int((both0 & (yc == 0)).sum())
            mixed = ~both1 & ~both0
            t["n11a"] += int((mixed & lower0 & (yc == 1)).sum())
            t["n10a"] += int((mixed & lower0 & (yc == 0)).sum())
            t["n11b"] += int((mixed & ~lower0 & (yc == 1)).sum())
            t["n10b"] += int((mixed & ~lower0 & (yc == 0)).sum())
            # dHist / cSimple / cCond (pbwtImpute.c:85-90): keyed by
            # y[i-1] + 2*y[i], bucketed by d[i]/100, conditioned on y[i+1]
            code = (ym + 2 * yc).astype(np.int64)
            buckets = (da // 100).astype(np.int64)
            for b in np.unique(buckets):
                row = d_hist.setdefault(int(b), np.zeros(4, np.int64))
                np.add.at(row, code[buckets == b], 1)
            np.add.at(c_simple, code, 1)
            np.add.at(c_cond1, code[yp_ == 1], 1)
            np.add.at(c_cond0, code[yp_ == 0], 1)
            idx_f = a[1:M - 1]
            np.add.at(n0, idx_f, 2 - (ym + yp_))
            np.add.at(n1, idx_f, ym + yp_)
            zm = yz[:-2].astype(np.int64)
            zp2 = yz[2:].astype(np.int64)
            idx_r = az[1:M - 1]
            np.add.at(n0, idx_r, 2 - (zm + zp2))
            np.add.at(n1, idx_r, zm + zp2)
            x[a[1:M - 1]] = y[1:M - 1]
            complete = (n0 + n1) == 4
            for i in np.flatnonzero(complete):
                if x[i]:
                    c1[ff][n1[i]] += 1
                else:
                    c0[ff][n1[i]] += 1
        a, d = engine.forwards_ad(a, d, Y[k], k)

    out = sys.stdout
    if test == 1:
        for jj in range(17):
            t = stats[jj]
            tot = (t["n00"] + t["n01"] + t["n10a"] + t["n11a"] + t["n10b"]
                   + t["n11b"] + t["n20"] + t["n21"])
            out.write(f"{f_bound[jj]:<5.1f}\t{(t['fsum'] / tot if tot else 0.0):<7.3f}"
                      f"\t00,01\t{t['n00']}\t{t['n01']}\t10a,11a\t{t['n10a']}\t"
                      f"{t['n11a']}\t10b,11b\t{t['n10b']}\t{t['n11b']}\t20,21\t"
                      f"{t['n20']}\t{t['n21']}")
            if tot:
                xbar = (t["n10b"] + t["n11b"] + t["n20"] + t["n21"]) / tot
                ybar = (t["n01"] + t["n11a"] + t["n11b"] + t["n21"]) / tot
                from ..utils import c_f
                denom = math.sqrt((xbar - xbar ** 2) * (ybar - ybar ** 2))
                r2 = (((t["n21"] + t["n11b"]) / tot - xbar * ybar) / denom
                      if denom else float("nan"))
                out.write(f"\tx,y,r2\t{xbar:.4f}\t{ybar:.4f}\t{c_f(r2)}\n")
            else:
                out.write("\n")
    elif test == 2:
        top = max(d_hist) if d_hist else -1
        for j in range(top + 1):
            c = d_hist.get(j, np.zeros(4, np.int64))
            out.write(f"{j}\t{c[0]}\t{c[1]}\t{c[2]}\t{c[3]}")
            out.write(f"\t{c[0] / (c[0] + c[2]):.3f}" if c[0] + c[2] else "\t0")
            out.write(f"\t{c[3] / (c[1] + c[3]):.3f}" if c[1] + c[3] else "\t0")
            out.write("\n")
    elif test == 3:
        out.write(f"{c_simple[0] / (c_simple[0] + c_simple[2]):.3f} "
                  f"{c_simple[3] / (c_simple[1] + c_simple[3]):.3f}\t")
        out.write(f"{c_cond0[0] / (c_cond0[0] + c_cond0[2]):.3f} "
                  f"{c_cond0[3] / (c_cond0[1] + c_cond0[3]):.3f}\t")
        out.write(f"{c_cond1[0] / (c_cond1[0] + c_cond1[2]):.3f} "
                  f"{c_cond1[3] / (c_cond1[1] + c_cond1[3]):.3f}\n")
    elif test == 4:
        for jj in range(17):
            out.write(f"{f_bound[jj]:<5.1f}")
            tot = float(c0[jj].sum() + c1[jj].sum())
            out.write(f"\t{(stats[jj]['fsum'] / tot if tot else 0.0):<7.3f}")
            xbar = 0.0
            r2 = 0.0
            for i in range(5):
                ssum = int(c0[jj][i] + c1[jj][i])
                out.write(f"\t{ssum} ")
                out.write(f" {c1[jj][i] / ssum:.3f}" if ssum else " 00000")
                xbar += float(c1[jj][i])
                if i in (3, 4):
                    r2 += float(c1[jj][i])
                if i == 2:
                    r2 += 0.5 * float(c1[jj][i])
                tot += ssum          # NB doubles tot, exactly as the reference
            ybar = float(c0[jj][4] + c1[jj][4] + c0[jj][3] + c1[jj][3]
                         + 0.5 * (c0[jj][2] + c1[jj][2]))
            if tot:
                xbar /= tot
                ybar /= tot
                from ..utils import c_f
                denom = math.sqrt((xbar - xbar * xbar) * (ybar - ybar * ybar))
                r2 = (r2 / tot - xbar * ybar) / denom if denom else float("nan")
                out.write(f"\tx,y,r2\t{xbar:.4f}\t{ybar:.4f}\t{c_f(r2)}\n")
            else:
                out.write("\n")
