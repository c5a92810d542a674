"""Genetic map: Oxford-format reader, 100bp-grid interpolation and the
doubleton 4-haplotype mutation/recombination test (pbwtGeneticMap.c)."""

from __future__ import annotations

import sys

import numpy as np

from ..core import registry
from ..core.pbwt import PBWT
from ..utils import log


class GeneticMap:
    def __init__(self):
        self.chrom: str | None = None
        self.x: np.ndarray | None = None    # bp coordinates
        self.g: np.ndarray | None = None    # genetic positions (cM)
        self.x0 = 0
        self.z: np.ndarray | None = None    # grid every 100bp


_map = GeneticMap()


def _build_map() -> None:
    """buildMap (pbwtGeneticMap.c:37-51)."""
    m = _map
    m.x0 = int(m.x[0])
    n = (int(m.x[-1]) - m.x0) // 100
    z = np.zeros(n + 1)
    j = 0
    for i in range(1, n + 1):
        xi = m.x0 + 100 * i
        while m.x[j + 1] < xi:
            j += 1
        z[i] = m.g[j] + (xi - m.x[j]) * (m.g[j + 1] - m.g[j]) / (m.x[j + 1] - m.x[j])
    m.z = z


def read_genetic_map(fp) -> None:
    """readGeneticMap (pbwtGeneticMap.c:55-92)."""
    header = fp.readline().split()
    if header[:4] != ["Chromosome", "Position(bp)", "Rate(cM/Mb)", "Map(cM)"]:
        raise ValueError("bad first line in readGeneticMap")
    xs: list[int] = []
    gs: list[float] = []
    old_rate = 0.0
    for line in fp:
        parts = line.split()
        if len(parts) < 4:
            continue
        chrom, x, rate, _y = parts[0], int(parts[1]), float(parts[2]), float(parts[3])
        if xs:
            gs.append(gs[-1] + (x - xs[-1]) * old_rate)
        else:
            gs.append(0.0)
            _map.chrom = chrom
        xs.append(x)
        old_rate = rate * 1e-6
    if len(xs) < 2:
        raise ValueError("need at least two data lines in genetic map file")
    _map.x = np.array(xs, dtype=np.int64)
    _map.g = np.array(gs)
    _build_map()
    log(f"read {len(xs)} genetic map entries from {xs[0]}, {gs[0]:f} to "
        f"{xs[-1]}, {gs[-1]:f}")


def genetic_map(x: int) -> float:
    """geneticMap (pbwtGeneticMap.c:96-104)."""
    x -= _map.x0
    if x <= 0:
        return 0.0
    xi = x // 100
    if xi >= len(_map.z) - 1:
        return float(_map.z[-1])
    xx = 0.01 * (x % 100)
    return float((1 - xx) * _map.z[xi] + xx * _map.z[xi + 1])


RATE_BOUNDARY = [0.1, 0.15, 0.2, 0.3, 0.5, 0.7, 1.0, 1.5, 2.0, 3.0, 5.0, 7.0,
                 10.0, 15.0, 20.0, 30.0, 50.0, 70.0, 100.0, 1000.0]


def pbwt_4haps_stats(p: PBWT) -> None:
    """pbwt4hapsStats (pbwtGeneticMap.c:152-205): doubleton 4-hap test."""
    if p is None or p.sites is None:
        raise ValueError("hap4stats called without a PBWT with sites")
    if _map.x is None:
        log("hap4stats called without a map - using a linear 1cM/Mb map")
        _map.chrom = p.chrom
        _map.x = np.array([p.sites[0].x, p.sites[-1].x], dtype=np.int64)
        _map.g = np.array([0.0, 1e-6 * (p.sites[-1].x - p.sites[0].x)])
        _build_map()
    elif p.chrom != _map.chrom:
        log(f"chrom mismatch in hap4stats: {p.chrom} != {_map.chrom}")

    n_var = max(len(registry.variation_dict),
                max((s.varD for s in p.sites), default=0) + 1, 1)
    quads = p.M // 4
    last_pat = np.full((n_var, p.M), -1, dtype=np.int64)
    last_pos = np.zeros((n_var, p.M), dtype=np.int64)
    last_map = np.zeros((n_var, p.M))
    n_minus = np.zeros((n_var, 20), dtype=np.int64)
    n_plus = np.zeros((n_var, 20), dtype=np.int64)
    glen = np.zeros((n_var, 20))
    tlen = np.zeros((n_var, 20), dtype=np.int64)

    X = p.haplotypes()
    for k in range(p.N):
        s = p.sites[k]
        pos = s.x
        g = genetic_map(pos)
        v = s.varD
        x = X[:, k]
        if int((x != 0).sum()) < 2:
            continue
        for i in range(0, 4 * quads, 4):
            tot = int(x[i]) + int(x[i + 1]) + int(x[i + 2]) + int(x[i + 3])
            if tot != 2:
                continue
            pat = int(x[i]) + (int(x[i + 1]) << 1) + (int(x[i + 2]) << 2) + (int(x[i + 3]) << 3)
            if last_pat[v][i] >= 0:
                rate = 1e6 * (g - last_map[v][i]) / max(pos - last_pos[v][i], 1)
                b = 0
                while RATE_BOUNDARY[b] < rate:
                    b += 1
                if pat == last_pat[v][i] or pat + last_pat[v][i] == 15:
                    n_minus[v][b] += 1
                else:
                    n_plus[v][b] += 1
                glen[v][b] += g - last_map[v][i]
                tlen[v][b] += pos - last_pos[v][i]
            last_pat[v][i] = pat
            last_pos[v][i] = pos
            last_map[v][i] = g

    out = sys.stdout
    out.write(" rate\tvar\t\tlen\tglen\tminus\t\tplus\n")
    for v in range(n_var):
        name = (registry.variation_dict.name(v)
                if v < len(registry.variation_dict) else str(v))
        for b in range(20):
            if n_minus[v][b] + n_plus[v][b]:
                out.write(f"{RATE_BOUNDARY[b]:.2f}\t{name}\t"
                          f"{tlen[v][b]:12d}\t{glen[v][b]:.4g}\t"
                          f"{n_minus[v][b]:12d}\t{n_plus[v][b]:12d}\n")
