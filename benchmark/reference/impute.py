"""Plain reference of reference imputation (pbwt's ``-referenceImpute``,
referenceImpute3 at pbwtImpute.c:1126-1261, its dosage code at :1631-1700).

A target is typed at the frame's sites alone: a subset of the reference
panel's sites. Its set-maximal matches against the panel restricted to those
sites (``reference/match.py``, all ties) are segments [s, e) in frame
coordinates. A reference site k lies at frame coordinate kold(k), the number
of frame sites at or before it. There each match (s, e) with s < kold weighs
w = (kold - s)(e - kold) where w > 0, and the target's dosage is
sum(w x) / sum(w) over its matches, x the matched haplotype's allele at k,
or the panel's share of 1 alleles at k where nothing weighs. The allele is
dosage > 0.5; the dosage code is pbwt's 6-level rule on the distance from
the nearer allele, dd: 0 where dd = 0, else int(10 (dd + 0.0999999)). A
site's info score (pbwtImpute.c:1250-1259) is taken over the targets that
some match weighs at it: with p, x and px the means of their dosages,
alleles and dosage x allele, (px - p^2) / sqrt(p (1 - p) x (1 - x)), or 1
where that product is 0.

Departures from pbwtImpute.c, none of which changes an allele or a dosage
code:
- pbwt takes its matches from matchSequencesSweep's reports ("best matches
  including alternates"); here they follow the definition of set-maximal
  matches (Durbin's Algorithm 5). The sets are the same.
- pbwt sums each target's weights in the order of its start-sorted list;
  here in any order. The weights are integers and their sums stay below
  2^53 in f64, so every order gives the same sums.
- The info scores' sums over targets run in torch's order, not pbwt's: they
  are sums of fractions, and differ in their last bits.
- pbwt's nSparse and fSparse are not taken: ``-referenceImpute`` only logs
  them.

Plain torch on any device; it imports nothing of the program.
"""

from __future__ import annotations

import torch

from .match import set_maximal_rows

# (match, site) elements of a step of the vote
BLOCK_ELEMENTS = 1 << 25


def dosage_codes(dosage: torch.Tensor) -> torch.Tensor:
    """pbwt's quantised dosage code, 0 to 5, of each dosage, in its
    precision."""
    dd = torch.where(dosage > 0.5, 1.0 - dosage, dosage)
    code = (10.0 * (dd + 0.0999999)).to(torch.int64)
    return torch.where(dd == 0.0, 0, code).to(torch.uint8)


def impute(cols: torch.Tensor, typed: torch.Tensor, Z: torch.Tensor,
           one_per_match: bool = False, dtype=torch.float64):
    """The imputed panel of the (Q, Nframe) uint8 targets Z, typed at the
    sites where the (Nref,) bool mask ``typed`` holds, against the panel
    given as its (Nref, Mref) uint8 natural-order site columns, on their
    device. one_per_match keeps one haplotype a match (the control); dtype
    is the precision of the weights, their sums and the dosage: pbwt's
    float64, or a lower one to see what it would change.

    Returns (alleles (Q, Nref) uint8, codes (Q, Nref) uint8, dosage (Q,
    Nref) of dtype, voted (Q, Nref) bool: some match weighed).
    """
    Nref, Mref = cols.shape
    Q, dev = Z.shape[0], cols.device
    rows = torch.from_numpy(set_maximal_rows(cols[typed].contiguous(), Z,
                                             one_per_match)).to(dev)
    q, j = rows[:, 0], rows[:, 1]
    s, e = rows[:, 2, None].to(dtype), rows[:, 3, None].to(dtype)
    kold = torch.cumsum(typed.long(), 0).to(dtype)
    freq = (cols.sum(1, dtype=torch.float64) / Mref).to(dtype)
    dosage = torch.empty((Q, Nref), dtype=dtype, device=dev)
    voted = torch.empty((Q, Nref), dtype=torch.bool, device=dev)
    step = max(1, BLOCK_ELEMENTS // max(len(rows), 1))
    for k0 in range(0, Nref, step):
        k = kold[None, k0:k0 + step]
        w = (k - s) * (e - k)
        w = torch.where((s < k) & (w > 0), w, 0.0)
        x = cols[k0:k0 + step].t()[j].to(dtype)              # (n, sites)
        wsum = torch.zeros((Q, k.shape[1]), dtype=dtype, device=dev)
        score = torch.zeros_like(wsum)
        wsum.index_add_(0, q, w)
        score.index_add_(0, q, w * x)
        dosage[:, k0:k0 + step] = torch.where(
            wsum > 0, score / wsum, freq[None, k0:k0 + step])
        voted[:, k0:k0 + step] = wsum > 0
    return (dosage > 0.5).to(torch.uint8), dosage_codes(dosage), dosage, voted


def info_scores(alleles: torch.Tensor, dosage: torch.Tensor,
                voted: torch.Tensor) -> torch.Tensor:
    """Each reference site's info score over the targets that voted there,
    from :func:`impute`'s results for a whole batch, in the dosage's
    precision; NaN where no target voted (pbwt leaves the site's score as
    it was)."""
    n = voted.sum(0).to(dosage.dtype)
    p = torch.where(voted, dosage, 0.0).sum(0) / n
    x = torch.where(voted, alleles.to(dosage.dtype), 0.0).sum(0) / n
    px = torch.where(voted, dosage * alleles, 0.0).sum(0) / n
    var = p * (1 - p) * x * (1 - x)
    info = torch.where(var != 0, (px - p * p) / var.sqrt(), 1.0)
    return torch.where(n > 0, info, float("nan"))
